"""Legacy lint: every plugin advertising streaming reads has read-stream
contract coverage (rule ``stream-contract``).

The streaming contract is behavioral, not structural: a plugin whose
``read_stream`` drops, reorders, or duplicates a byte corrupts restored
state silently — so opting a plugin in WITHOUT registering it in the
contract parametrization must fail CI, not slip through review.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/legacy_stream_contract.py``:
the same module list, ``getattr_static`` advertising probe and
``CONTRACT_PLUGINS`` regex, over this package's plugins and its own
contract tests (``tests/test_torch_streaming_read.py``).
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
from typing import List

from ..core import REPO_DIR, Finding, Project

RULES = ("stream-contract",)

TEST_REL = "tests/test_torch_streaming_read.py"
TEST_FILE = os.path.join(REPO_DIR, *TEST_REL.split("/"))

# Every module under storage_plugins/ that can define a plugin class (the
# walk is explicit so a new module is added here — and thereby linted —
# rather than silently skipped).
PLUGIN_MODULES = ("fs", "s3", "gcs", "mirror", "retry")


def advertising_plugins() -> set:
    from ...io_types import StoragePlugin

    out = set()
    for name in PLUGIN_MODULES:
        mod = importlib.import_module(f"...storage_plugins.{name}", __package__)
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if not issubclass(cls, StoragePlugin) or cls.__module__ != mod.__name__:
                continue
            # getattr_static sees a property (mirror's delegation) as
            # advertising too — composition still needs contract tests.
            flag = inspect.getattr_static(cls, "supports_streaming_reads", False)
            if flag is not False:
                out.add(cls.__name__)
    return out


def covered_plugins() -> set:
    with open(TEST_FILE, "r") as f:
        source = f.read()
    match = re.search(r"CONTRACT_PLUGINS\s*=\s*\{(.*?)\n\}", source, re.S)
    if match is None:
        return set()
    return set(re.findall(r'"(\w+)"\s*:', match.group(1)))


def run_pass(project: Project) -> List[Finding]:
    missing = sorted(advertising_plugins() - covered_plugins())
    return [
        Finding(
            rule="stream-contract",
            file=TEST_REL,
            line=1,
            message=(
                f"{name} advertises supports_streaming_reads without "
                "read-stream contract coverage — register it in "
                "CONTRACT_PLUGINS"
            ),
        )
        for name in missing
    ]
