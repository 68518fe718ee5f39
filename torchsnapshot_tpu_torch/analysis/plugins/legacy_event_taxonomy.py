"""Legacy lint: flight-recorder events and histogram instruments are
registered literals and fully wired (rule ``event-taxonomy``).

The flight recorder's event stream is an operator interface — the
``blackbox`` CLI merges rank dumps by matching event names, runbooks
grep for them, tests assert on them; the histogram families are merged
bucket-wise BY NAME across the fleet. A typo'd name in either registry
silently forks an interface nothing watches.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/legacy_event_taxonomy.py``:
the same shims, floors (``MIN_EVENTS``, ``MIN_HISTOGRAMS``) and messages,
against this package's ``telemetry/taxonomy.py``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from ...telemetry.taxonomy import FLIGHT_EVENTS, HISTOGRAMS
from ..core import PACKAGE_DIR, PACKAGE_NAME, Finding, Project

RULES = ("event-taxonomy",)

PACKAGE = PACKAGE_DIR

# Names a module may bind the flightrec module to. Calls are recognized
# as ``<alias>.record(...)`` or ``telemetry.flightrec.record(...)``.
_MODULE_NAME = "flightrec"

# Regression floor: the JAX package's taxonomy floor. Shrinking the
# taxonomy under it means an operator-facing event class was silently
# dropped.
MIN_EVENTS = 36
# Same floor for histogram instruments.
MIN_HISTOGRAMS = 5


def _is_flightrec_record(fn: ast.AST, aliases: set) -> bool:
    """True for ``<alias>.record`` and ``<mod>.flightrec.record``."""
    if not (isinstance(fn, ast.Attribute) and fn.attr == "record"):
        return False
    val = fn.value
    if isinstance(val, ast.Name) and val.id in aliases:
        return True
    return isinstance(val, ast.Attribute) and val.attr == _MODULE_NAME


def _is_histogram_observe(fn: ast.AST) -> bool:
    """True for ``<anything>.histogram_observe`` and a bare
    ``histogram_observe`` name (``from ... import histogram_observe``)."""
    if isinstance(fn, ast.Attribute) and fn.attr == "histogram_observe":
        return True
    return isinstance(fn, ast.Name) and fn.id == "histogram_observe"


def check_source(
    source: str, filename: str
) -> Tuple[List[Tuple[int, str]], Dict[str, List[int]], Dict[str, List[int]]]:
    """Return (violations, {event_name: [lines]}, {hist_name: [lines]})
    for one file."""
    tree = ast.parse(source, filename=filename)
    violations: List[Tuple[int, str]] = []
    uses: Dict[str, List[int]] = {}
    hist_uses: Dict[str, List[int]] = {}
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[-1] == _MODULE_NAME:
                    aliases.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == _MODULE_NAME:
                    aliases.add(alias.asname or alias.name)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _is_histogram_observe(node.func):
            if not node.args or not (
                isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                violations.append(
                    (
                        node.lineno,
                        "histogram_observe(...) — the instrument name must "
                        "be a string literal",
                    )
                )
                continue
            name = node.args[0].value
            if name not in HISTOGRAMS:
                violations.append(
                    (
                        node.lineno,
                        f"histogram_observe({name!r}) — instrument not "
                        "registered in telemetry/taxonomy.py",
                    )
                )
                continue
            hist_uses.setdefault(name, []).append(node.lineno)
            continue
        if not _is_flightrec_record(node.func, aliases):
            continue
        if not node.args or not (
            isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            violations.append(
                (
                    node.lineno,
                    "flightrec.record(...) — the event name must be a "
                    "string literal",
                )
            )
            continue
        name = node.args[0].value
        if name not in FLIGHT_EVENTS:
            violations.append(
                (
                    node.lineno,
                    f"flightrec.record({name!r}) — event not registered in "
                    "telemetry/taxonomy.py",
                )
            )
            continue
        uses.setdefault(name, []).append(node.lineno)
    return violations, uses, hist_uses


def run(package_dir: str = PACKAGE) -> List[str]:
    failures: List[str] = []
    wired: Dict[str, List[str]] = {}
    hist_wired: Dict[str, List[str]] = {}
    for dirpath, _dirnames, filenames in os.walk(package_dir):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), package_dir)
            if rel in (
                os.path.join("telemetry", "flightrec.py"),
                os.path.join("telemetry", "core.py"),
            ):
                continue  # the shims themselves
            path = os.path.join(dirpath, fname)
            with open(path, "r") as f:
                source = f.read()
            violations, uses, hist_uses = check_source(source, path)
            for lineno, what in violations:
                failures.append(f"{rel}:{lineno}: {what}")
            for name, lines in uses.items():
                for lineno in lines:
                    wired.setdefault(name, []).append(f"{rel}:{lineno}")
            for name, lines in hist_uses.items():
                for lineno in lines:
                    hist_wired.setdefault(name, []).append(f"{rel}:{lineno}")
    # flight.dump is emitted by the dump machinery itself (the header
    # record), not via record() — it is wired by construction.
    wired.setdefault("flight.dump", ["telemetry/flightrec.py:dump"])
    for name in sorted(FLIGHT_EVENTS - set(wired)):
        failures.append(
            f"event {name!r} is registered in telemetry/taxonomy.py but "
            "recorded nowhere — remove the registration or wire the event"
        )
    for name in sorted(HISTOGRAMS - set(hist_wired)):
        failures.append(
            f"histogram {name!r} is registered in telemetry/taxonomy.py but "
            "observed nowhere — remove the registration or wire the "
            "instrument"
        )
    if len(FLIGHT_EVENTS) < MIN_EVENTS:
        failures.append(
            f"event taxonomy shrank to {len(FLIGHT_EVENTS)} (< {MIN_EVENTS}): "
            "an operator-facing event class was dropped"
        )
    if len(HISTOGRAMS) < MIN_HISTOGRAMS:
        failures.append(
            f"histogram registry shrank to {len(HISTOGRAMS)} "
            f"(< {MIN_HISTOGRAMS}): an operator-facing latency family was "
            "dropped"
        )
    return failures


def _parse_failure(failure: str) -> Tuple[str, int, str]:
    head, sep, rest = failure.partition(": ")
    if sep:
        path, colon, lineno = head.rpartition(":")
        if colon and lineno.isdigit() and path:
            return (
                os.path.join(PACKAGE_NAME, path).replace(os.sep, "/"),
                int(lineno),
                rest,
            )
    # registry-level failures (floors, dead rows) anchor at the taxonomy
    return (f"{PACKAGE_NAME}/telemetry/taxonomy.py", 1, failure)


def run_pass(project: Project) -> List[Finding]:
    out = []
    for failure in sorted(run()):
        file, line, message = _parse_failure(failure)
        out.append(
            Finding(rule="event-taxonomy", file=file, line=line, message=message)
        )
    return out

