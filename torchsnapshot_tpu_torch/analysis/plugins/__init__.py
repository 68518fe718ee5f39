"""tsalint plugin registry.

A plugin is a module exposing ``RULES`` (the rule ids it owns — the
suppression keys) and ``run_pass(project) -> List[Finding]``. Adding a
pass = writing that module and listing it in :data:`PLUGINS`; the
runner, ``--rule`` selection, suppression plumbing, and exit codes come
for free. Order here is report order for ties. The same nine plugins,
in the same order, with the same rule ids, as
``torchsnapshot_tpu/analysis/plugins/__init__.py``.
"""

from __future__ import annotations

from typing import Dict, List

from . import (
    envreg,
    legacy_event_taxonomy,
    legacy_fault_sites,
    legacy_peer_channel,
    legacy_stream_contract,
    legacy_timing,
    lifecycle,
    locks,
    restricted,
)

#: name -> plugin module, in report order. The five legacy lints keep
#: their historical semantics (see each module's docstring); the four
#: deep passes enforce the bug classes named in theirs.
PLUGINS = {
    "timing": legacy_timing,
    "fault-sites": legacy_fault_sites,
    "peer-channel": legacy_peer_channel,
    "stream-contract": legacy_stream_contract,
    "event-taxonomy": legacy_event_taxonomy,
    "locks": locks,
    "restricted": restricted,
    "lifecycle": lifecycle,
    "envreg": envreg,
}


def rule_index() -> Dict[str, str]:
    """rule id -> plugin name."""
    out: Dict[str, str] = {}
    for name, mod in PLUGINS.items():
        for rule in mod.RULES:
            out[rule] = name
    return out


def all_rules() -> List[str]:
    out: List[str] = []
    for mod in PLUGINS.values():
        out.extend(mod.RULES)
    return out
