"""Legacy lint: no ad-hoc timing outside telemetry (rule ``timing``).

The telemetry subsystem (torchsnapshot_tpu_torch/telemetry/) is the ONE
measurement mechanism for the pipeline — spans, counters, rates, and the
blessed ``telemetry.monotonic`` clock. Wall-clock DEADLINE logic (store
RPC timeouts, the test launcher's subprocess deadline) is not
measurement and stays on raw ``time.monotonic`` via the explicit
allowlist.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/legacy_timing.py``:
the same allowlist, banned attributes, covered telemetry consumers and
per-violation text, over this package. It walks no ``benchmarks/``: that
directory holds the JAX package's benchmarks, and this package has none
yet. Its benchmark directory joins the walk when it lands.
"""

from __future__ import annotations

import ast
import os
from typing import List, Tuple

from ..core import PACKAGE_DIR, PACKAGE_NAME, Finding, Project

RULES = ("timing",)

PACKAGE = PACKAGE_DIR

# Paths (relative to the package) allowed to call time.monotonic/
# perf_counter directly. Deadline/timeout bookkeeping only — add a file
# here ONLY for wall-deadline logic, never for measurement (measurement
# belongs on the telemetry bus).
ALLOWLIST = {
    "dist_store.py",  # store RPC / barrier deadline arithmetic
    "test_utils.py",  # multi-process launcher subprocess deadline
}

_BANNED_ATTRS = {"monotonic", "perf_counter", "monotonic_ns", "perf_counter_ns"}


def _violations_in(path: str) -> list:
    with open(path, "r") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:  # pragma: no cover - package must parse
        return [(e.lineno or 0, f"syntax error: {e}")]
    out = []
    # Names bound by `from time import monotonic/perf_counter [as alias]`.
    from_time_aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in _BANNED_ATTRS:
                    from_time_aliases.add(alias.asname or alias.name)
                    out.append(
                        (node.lineno, f"from time import {alias.name}")
                    )
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _BANNED_ATTRS
            and isinstance(fn.value, ast.Name)
            and fn.value.id in ("time", "_time")
        ):
            out.append((node.lineno, f"{fn.value.id}.{fn.attr}()"))
        elif isinstance(fn, ast.Name) and fn.id in from_time_aliases:
            out.append((node.lineno, f"{fn.id}()"))
    return out


# Files INSIDE telemetry/ that are clock CONSUMERS, not the clock's
# owner: they must go through core.monotonic like the rest of the
# package, so the lint covers them despite living in the exempt dir.
# (core.py/export.py own the clock; history.py records calendar time.)
# critpath.py consumes recorded span timestamps and promexp.py serves
# scrapes — neither may ever grow a private clock.
TELEMETRY_COVERED = {
    "flightrec.py",
    "health.py",
    "critpath.py",
    "promexp.py",
    "forensics.py",
}


def collect_failures() -> List[Tuple[str, int, str]]:
    """The walk: (package-relative path, line, what) triples."""
    failures: List[Tuple[str, int, str]] = []
    for dirpath, dirnames, filenames in os.walk(PACKAGE):
        rel_dir = os.path.relpath(dirpath, PACKAGE)
        if rel_dir.split(os.sep)[0] == "telemetry":
            # The telemetry package owns the raw clock — EXCEPT its
            # consumer modules (the flight recorder, the health plane),
            # which are linted like everything else.
            for name in sorted(filenames):
                if name not in TELEMETRY_COVERED:
                    continue
                rel = os.path.normpath(os.path.join(rel_dir, name))
                for lineno, what in _violations_in(os.path.join(dirpath, name)):
                    failures.append((rel, lineno, what))
            continue
        for name in filenames:
            if not name.endswith(".py"):
                continue
            rel = os.path.normpath(os.path.join(rel_dir, name))
            if rel in ALLOWLIST:
                continue
            for lineno, what in _violations_in(os.path.join(dirpath, name)):
                failures.append((rel, lineno, what))
    return failures


def run_pass(project: Project) -> List[Finding]:
    out = []
    for rel, lineno, what in sorted(collect_failures()):
        file = os.path.normpath(os.path.join(PACKAGE_NAME, rel))
        out.append(
            Finding(
                rule="timing",
                file=file.replace(os.sep, "/"),
                line=lineno,
                message=(
                    f"{what} — ad-hoc timing outside telemetry/ (use "
                    "telemetry.span()/record_rate()/telemetry.monotonic, or "
                    "register a DEADLINE-logic file in the allowlist)"
                ),
            )
        )
    return out
