"""Env-registry pass (rules ``env-unregistered``, ``env-undocumented``,
``env-dead``, ``env-dynamic``, ``env-ungoverned``).

The bug class: env knobs rot silently. A knob made dead by a refactor
stays set in deployments with no test noticing, and a knob read but never
documented does not exist for whoever tunes a deployment. The fix is a
closed-world registry: every ``TORCHSNAPSHOT_GPU_*`` name the package
reads MUST appear in :data:`ENV_REGISTRY` below, every registry entry
MUST have a row in ``docs/source/utilities_torch.rst``, and (when
scanning the real package) every registry entry MUST still be read
somewhere — three failure modes (``env-unregistered``,
``env-undocumented``, ``env-dead``), each caught the moment a change
introduces it.

Reads are found at ``os.environ.get/[]``, ``os.getenv``, ``pop`` and
``setdefault``; the name argument is resolved through literals,
module-level constants, and constants imported from sibling modules. A
name that flows through a module-level helper's parameter (the
``integrity._enabled(name)`` idiom) is resolved at each call site via
the call graph. A read whose name cannot be resolved statically at all
is ``env-dynamic`` — an unresolvable read is an unauditable knob.

Foreign variables (``CUDA_VISIBLE_DEVICES``, the JAX package's
``TORCHSNAPSHOT_TPU_*``) are out of scope: the registry governs only this
package's own prefix.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/envreg.py``: the
registry is the JAX package's with the prefix swapped, and the documented
names come from this package's own page.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from ..core import (
    PACKAGE_DIR,
    PACKAGE_NAME,
    REPO_DIR,
    Finding,
    FunctionInfo,
    Module,
    Project,
    dotted,
)

RULES = (
    "env-unregistered", "env-undocumented", "env-dead", "env-dynamic",
    "env-ungoverned",
)

ENV_PREFIX = "TORCHSNAPSHOT_GPU_"

#: The closed-world knob registry: the JAX package's, prefix swapped.
#: Adding an env read to the package means adding its literal here AND a
#: row to docs/source/utilities_torch.rst (the pass enforces both);
#: removing the last read of a knob means deleting it here, or
#: ``env-dead`` fires.
ENV_REGISTRY = frozenset({
    "TORCHSNAPSHOT_GPU_BARRIER_TIMEOUT",
    "TORCHSNAPSHOT_GPU_CHECKSUM",
    "TORCHSNAPSHOT_GPU_CLOUD_IO_THREADS",
    "TORCHSNAPSHOT_GPU_COMPRESSION",
    "TORCHSNAPSHOT_GPU_COOP_RESTORE",
    "TORCHSNAPSHOT_GPU_COOP_TIMEOUT",
    "TORCHSNAPSHOT_GPU_CPU_CONCURRENCY",
    "TORCHSNAPSHOT_GPU_DEVICE_DIGESTS",
    "TORCHSNAPSHOT_GPU_DISABLE_NATIVE",
    "TORCHSNAPSHOT_GPU_ENABLE_BATCHING",
    "TORCHSNAPSHOT_GPU_FAULT_PLAN",
    "TORCHSNAPSHOT_GPU_FLIGHTREC",
    "TORCHSNAPSHOT_GPU_FLIGHTREC_DIR",
    "TORCHSNAPSHOT_GPU_FLIGHTREC_RING",
    "TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM",
    "TORCHSNAPSHOT_GPU_FORENSICS",
    "TORCHSNAPSHOT_GPU_FORENSICS_DEADLINE_FRAC",
    "TORCHSNAPSHOT_GPU_FORENSICS_SAMPLE_S",
    "TORCHSNAPSHOT_GPU_FORENSICS_STALL_S",
    "TORCHSNAPSHOT_GPU_FSYNC",
    "TORCHSNAPSHOT_GPU_HEARTBEAT_S",
    "TORCHSNAPSHOT_GPU_IO_CONCURRENCY",
    "TORCHSNAPSHOT_GPU_HOT_SET",
    "TORCHSNAPSHOT_GPU_JOURNAL",
    "TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES",
    "TORCHSNAPSHOT_GPU_JOURNAL_MAX_EPOCHS",
    "TORCHSNAPSHOT_GPU_LAZY_RESTORE",
    "TORCHSNAPSHOT_GPU_LINT_BASELINE",
    "TORCHSNAPSHOT_GPU_METRICS_PORT",
    "TORCHSNAPSHOT_GPU_MMAP_READS",
    "TORCHSNAPSHOT_GPU_NATIVE_ALIGN",
    "TORCHSNAPSHOT_GPU_NATIVE_IO",
    "TORCHSNAPSHOT_GPU_NATIVE_ODIRECT",
    "TORCHSNAPSHOT_GPU_NATIVE_QUEUE_DEPTH",
    "TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH",
    "TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES",
    "TORCHSNAPSHOT_GPU_PREVERIFY",
    "TORCHSNAPSHOT_GPU_PROGRESS_S",
    "TORCHSNAPSHOT_GPU_RESHARD",
    "TORCHSNAPSHOT_GPU_RESHARD_MIN_REQUESTERS",
    "TORCHSNAPSHOT_GPU_SEED_FANOUT",
    "TORCHSNAPSHOT_GPU_SEED_RESTORE",
    "TORCHSNAPSHOT_GPU_SEED_TTL_S",
    "TORCHSNAPSHOT_GPU_ADMISSION",
    "TORCHSNAPSHOT_GPU_MANIFEST_FORMAT",
    "TORCHSNAPSHOT_GPU_QUOTA_BYTES",
    "TORCHSNAPSHOT_GPU_STAGING_POOL_BYTES",
    "TORCHSNAPSHOT_GPU_STORE_ADDR",
    "TORCHSNAPSHOT_GPU_TENANT",
    "TORCHSNAPSHOT_GPU_STORE_CONNECT_RETRIES",
    "TORCHSNAPSHOT_GPU_STORE_LEASE_S",
    "TORCHSNAPSHOT_GPU_STORE_REPLICAS",
    "TORCHSNAPSHOT_GPU_STORE_RPC_TIMEOUT",
    "TORCHSNAPSHOT_GPU_STREAM_READS",
    "TORCHSNAPSHOT_GPU_STREAM_WRITES",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_MAX_BYTES",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_MIN_BYTES",
    "TORCHSNAPSHOT_GPU_TELEMETRY",
    "TORCHSNAPSHOT_GPU_TELEMETRY_MAX_EVENTS",
    "TORCHSNAPSHOT_GPU_TREND_THRESHOLD",
    "TORCHSNAPSHOT_GPU_UPDATE_PUSH",
    "TORCHSNAPSHOT_GPU_VERIFY",
    "TORCHSNAPSHOT_GPU_AUTOTUNE",
    "TORCHSNAPSHOT_GPU_GEOREP",
    "TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S",
    "TORCHSNAPSHOT_GPU_GEOREP_BACKLOG",
    "TORCHSNAPSHOT_GPU_GEOREP_DRAIN_S",
})

#: Election-site governance (rule ``env-ungoverned``). Every knob the
#: IOGovernor's elections consult (scheduler.ELECTION_KNOBS) MUST
#: declare here how it interacts with the closed-loop autotuner
#: (autotune.py): ``override`` — a set value pins the election and the
#: tuner never perturbs that dimension; ``bound`` — constrains the
#: tuner's search range, never pins a value; ``switch`` — selects the
#: autotune mode itself. A knob added to an election site without a row
#: here has UNDEFINED precedence against learned profiles — exactly the
#: ambiguity the env-override > learned-profile > heuristic contract
#: (docs/source/utilities_torch.rst) exists to rule out.
ENV_GOVERNANCE: Dict[str, str] = {
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES": "override",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_MIN_BYTES": "bound",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_MAX_BYTES": "bound",
    "TORCHSNAPSHOT_GPU_IO_CONCURRENCY": "override",
    "TORCHSNAPSHOT_GPU_PREVERIFY": "override",
    "TORCHSNAPSHOT_GPU_STREAM_READS": "override",
    "TORCHSNAPSHOT_GPU_STREAM_WRITES": "override",
    "TORCHSNAPSHOT_GPU_NATIVE_IO": "override",
    "TORCHSNAPSHOT_GPU_COOP_RESTORE": "override",
    "TORCHSNAPSHOT_GPU_RESHARD": "override",
    "TORCHSNAPSHOT_GPU_SEED_RESTORE": "override",
    "TORCHSNAPSHOT_GPU_AUTOTUNE": "switch",
}

UTILITIES_RST = os.path.join(REPO_DIR, "docs", "source", "utilities_torch.rst")

_READ_CALLS = {
    "os.environ.get", "environ.get",
    "os.environ.pop", "environ.pop",
    "os.environ.setdefault", "environ.setdefault",
    "os.getenv", "getenv",
}


def _documented_names() -> Set[str]:
    try:
        with open(UTILITIES_RST, "r") as f:
            text = f.read()
    except OSError:
        return set()
    return set(re.findall(r"TORCHSNAPSHOT_GPU_[A-Z0-9_]*[A-Z0-9]", text))


def _env_read_arg(node: ast.AST) -> Optional[Tuple[ast.AST, int]]:
    """(name-expression, line) if this node reads an env var."""
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name in _READ_CALLS and node.args:
            return node.args[0], node.lineno
        return None
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        base = dotted(node.value)
        if base in ("os.environ", "environ"):
            return node.slice, node.lineno
    return None


def _param_index(info: FunctionInfo, name: str) -> Optional[int]:
    node = info.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    for i, arg in enumerate(node.args.args):
        if arg.arg == name:
            return i
    return None


def run_pass(project: Project) -> List[Finding]:
    reads: List[Tuple[str, str, int]] = []  # (env name, file, line)
    dynamic: List[Tuple[str, int, str]] = []  # (file, line, detail)
    #: module-level functions whose parameter carries the env name:
    #: qualname -> (info, param index, read site)
    param_flows: Dict[str, Tuple[FunctionInfo, int, Tuple[str, int]]] = {}

    def scan(mod: Module, root: ast.AST, info: Optional[FunctionInfo]) -> None:
        for node in ast.iter_child_nodes(root):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # functions are scanned with their own context
            hit = _env_read_arg(node)
            if hit is not None:
                arg, line = hit
                val = project.resolve_const(mod, arg)
                if val is not None:
                    reads.append((val, mod.rel, line))
                elif (
                    info is not None
                    and info.class_name is None
                    and isinstance(arg, ast.Name)
                    and _param_index(info, arg.id) is not None
                ):
                    idx = _param_index(info, arg.id)
                    assert idx is not None
                    param_flows.setdefault(
                        info.qualname, (info, idx, (mod.rel, line))
                    )
                else:
                    dynamic.append(
                        (mod.rel, line,
                         "env var name is not a literal, registered "
                         "constant, or resolvable parameter")
                    )
            scan(mod, node, info)

    for mod in project.modules:
        scan(mod, mod.tree, None)
    for mod, info in project.walk_functions():
        scan(mod, info.node, info)

    # second pass: resolve parameter-carried names at their call sites.
    # The walk covers each module's ENTIRE tree (module-level constant
    # initialization like ``DEFAULT = _read_env_number(VAR, 5.0)`` is the
    # dominant idiom, and it is not inside any function).
    for qualname, (target, idx, read_site) in sorted(param_flows.items()):
        resolved_any = False
        for mod in project.modules:
            info = FunctionInfo(
                module_rel=mod.rel, class_name=None, name="<module>",
                node=mod.tree,
            )
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                if not any(
                    c.qualname == qualname
                    for c in project.resolve_call(mod, info, node)
                ):
                    continue
                if len(node.args) > idx:
                    val = project.resolve_const(mod, node.args[idx])
                    if val is not None:
                        reads.append((val, mod.rel, node.lineno))
                        resolved_any = True
                        continue
                dynamic.append(
                    (mod.rel, node.lineno,
                     f"call into {qualname} does not pass a resolvable "
                     "env var name")
                )
        if not resolved_any:
            dynamic.append(
                (read_site[0], read_site[1],
                 f"no call site passes a resolvable env name into "
                 f"{qualname}")
            )

    findings: Dict[Tuple[str, str, int], Finding] = {}
    docs = _documented_names()
    is_real_package = os.path.realpath(project.package_dir) == os.path.realpath(
        PACKAGE_DIR
    )
    seen_names: Set[str] = set()
    for name, rel, line in reads:
        if not name.startswith(ENV_PREFIX):
            continue
        seen_names.add(name)
        if name not in ENV_REGISTRY:
            findings.setdefault(
                ("env-unregistered", rel, line),
                Finding(
                    rule="env-unregistered", file=rel, line=line,
                    message=(
                        f"reads {name}, which is not in ENV_REGISTRY "
                        "(analysis/plugins/envreg.py) — register it and "
                        "document it in docs/source/utilities_torch.rst"
                    ),
                ),
            )
        elif is_real_package and docs and name not in docs:
            findings.setdefault(
                ("env-undocumented", rel, line),
                Finding(
                    rule="env-undocumented", file=rel, line=line,
                    message=(
                        f"{name} is registered but has no row in "
                        "docs/source/utilities_torch.rst — undocumented knobs "
                        "don't exist for operators"
                    ),
                ),
            )
    for rel, line, detail in dynamic:
        findings.setdefault(
            ("env-dynamic", rel, line),
            Finding(
                rule="env-dynamic", file=rel, line=line,
                message=f"unauditable environ read: {detail}",
            ),
        )
    if is_real_package:
        self_mod = project.module(
            os.path.join("analysis", "plugins", "envreg.py").replace(os.sep, "/")
        )

        def _self_line(needle: str) -> int:
            if self_mod is not None:
                for i, text in enumerate(self_mod.lines, start=1):
                    if needle in text:
                        return i
            return 1

        self_rel = (
            self_mod.rel if self_mod is not None
            else f"{PACKAGE_NAME}/analysis/plugins/envreg.py"
        )
        # Governance closure against the scheduler's authoritative
        # election-knob set. A lazy import: the analysis runner also
        # lints forks/vendored copies where the import may not resolve.
        try:
            from ...scheduler import ELECTION_KNOBS
        except ImportError:
            ELECTION_KNOBS = frozenset()
        for name in sorted(ELECTION_KNOBS - set(ENV_GOVERNANCE)):
            findings.setdefault(
                ("env-ungoverned", name, 0),
                Finding(
                    rule="env-ungoverned", file=self_rel,
                    line=_self_line("ENV_GOVERNANCE"),
                    message=(
                        f"{name} feeds an IOGovernor election site "
                        "(scheduler.ELECTION_KNOBS) but declares no "
                        "override-vs-tuned status in ENV_GOVERNANCE — add "
                        "a row ('override', 'bound', or 'switch') so its "
                        "precedence against learned profiles is pinned"
                    ),
                ),
            )
        if ELECTION_KNOBS:
            for name in sorted(set(ENV_GOVERNANCE) - ELECTION_KNOBS):
                findings.setdefault(
                    ("env-ungoverned", name, 1),
                    Finding(
                        rule="env-ungoverned", file=self_rel,
                        line=_self_line(f'"{name}"'),
                        message=(
                            f"{name} declares governance but is not in "
                            "scheduler.ELECTION_KNOBS — the election site "
                            "was removed; delete the stale ENV_GOVERNANCE "
                            "row (or re-register the knob)"
                        ),
                    ),
                )
        for name in sorted(ENV_REGISTRY - seen_names):
            line = 1
            if self_mod is not None:
                for i, text in enumerate(self_mod.lines, start=1):
                    if f'"{name}"' in text:
                        line = i
                        break
            findings.setdefault(
                ("env-dead", name, line),
                Finding(
                    rule="env-dead",
                    file=(
                        self_mod.rel if self_mod is not None
                        else f"{PACKAGE_NAME}/analysis/plugins/envreg.py"
                    ),
                    line=line,
                    message=(
                        f"{name} is registered but nothing in the package "
                        "reads it — delete the knob (and its utilities_torch.rst "
                        "row) or wire it back up"
                    ),
                ),
            )
    out = list(findings.values())
    out.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return out
