"""Legacy lint: fault-injection sites are unique, registered, and
shim-only (rule ``fault-sites``).

``torchsnapshot_tpu_torch/faultinject.py`` threads named injection points
through every I/O and coordination boundary. Three properties keep the
subsystem trustworthy: registered names only, one call site per name,
and shim-only access (``site``/``mutate``) from production modules.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/legacy_fault_sites.py``:
the same shim contract, pinned files, ``MIN_SITES`` floor and messages,
against this package's ``faultinject.SITES``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from ...faultinject import KNOWN_SITES
from ..core import PACKAGE_DIR, PACKAGE_NAME, Finding, Project

RULES = ("fault-sites",)

PACKAGE = PACKAGE_DIR

# The shim: the only attributes production code may use on the module.
ALLOWED_ATTRS = {"site", "mutate"}

# Coordination-plane sites are additionally pinned to their module: the
# replication/lease protocol's injection points only mean what
# the chaos schedules assume while they live on the dist_store
# boundaries — a site name drifting into another file would silently
# change what "kill the store host at the Nth serve" drills.
PINNED_SITE_FILES = {
    "dist_store.rpc": "dist_store.py",
    "dist_store.serve_op": "dist_store.py",
    "dist_store.replica_rpc": "dist_store.py",
    "dist_store.lease_renew": "dist_store.py",
    "peer.send_frame": "dist_store.py",
    "peer.recv_frame": "dist_store.py",
    # The native-engine sites are pinned to the fs plugin: the
    # chaos matrix's kill/transient/truncate drills through the io_uring
    # path only mean what they assume while the sites sit on the fs
    # plugin's native submit/yield boundaries.
    "fs.native_pwrite": os.path.join("storage_plugins", "fs.py"),
    "fs.native_pread": os.path.join("storage_plugins", "fs.py"),
    # The planned-reshard bundle site is pinned to the
    # planner: the chaos drills corrupt/kill "the bundle as it leaves
    # the owner", which is only that while the site sits on reshard.py's
    # forwarding boundary.
    "reshard.peer_xfer": "reshard.py",
    # The delta-journal sites are pinned to the journal: the
    # chaos drills SIGKILL "mid-append, inside one record's frame" and
    # corrupt "the payload as replay reads it back", which is only that
    # while the sites sit on journal.py's record framing boundaries.
    "journal.append": "journal.py",
    "journal.replay": "journal.py",
    # The fleet-distribution sites are pinned to distrib.py:
    # the chaos drills SIGKILL/corrupt "the chunk as it leaves the
    # seeding peer" and corrupt "the epoch blob as it leaves the
    # pusher", which is only that while the sites sit on distrib.py's
    # serve/push boundaries.
    "distrib.seed_xfer": "distrib.py",
    "distrib.epoch_push": "distrib.py",
    # The tenancy sites are pinned to the tenancy package:
    # the chaos drills kill "at the quota gate, before payload I/O"
    # (must leave no partial) and fail "the admission registration"
    # (must fail the op, not run unpaced), which is only that while the
    # sites sit on tenancy's gate boundaries.
    "tenancy.quota_check": os.path.join("tenancy", "quota.py"),
    "tenancy.admission": os.path.join("tenancy", "admission.py"),
    # The lazy page-in sites are pinned to pagein.py: the
    # chaos drills SIGKILL "mid-page-in, after restore() returned" and
    # fail "the background batch" (first access must degrade to a
    # direct read, bit-exact), which is only that while the sites sit
    # on the page-in engine's batch boundary.
    "pagein.prefetch": "pagein.py",
    "pagein.fault": "pagein.py",
    # The geo-replication sites are pinned to georep.py: the
    # chaos drills SIGKILL/corrupt "the epoch blob as it leaves the
    # shipper" and fail "the remote apply before its meta publishes"
    # (backlog bounded, foreground untouched), which is only that while
    # the sites sit on the shipper's ship/apply boundaries.
    "georep.ship": "georep.py",
    "georep.apply": "georep.py",
}

# Regression floor: the registry's size in the JAX package, which this
# package registers site for site. Shrinking it means a drill surface was
# silently unthreaded.
MIN_SITES = 31


def check_source(
    source: str, filename: str
) -> Tuple[List[Tuple[int, str]], Dict[str, List[int]]]:
    """Return (violations, {site_name: [lines]}) for one file."""
    tree = ast.parse(source, filename=filename)
    violations: List[Tuple[int, str]] = []
    uses: Dict[str, List[int]] = {}
    # Names the module binds to the faultinject module object.
    fi_aliases = set()

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[-1] == "faultinject":
                    fi_aliases.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".")[-1]
            if mod == "faultinject":
                violations.append(
                    (
                        node.lineno,
                        "from ...faultinject import ... — import the module "
                        "and call faultinject.site()/mutate() (the shim)",
                    )
                )
            elif node.module is None or not node.module:
                # `from . import faultinject [as x]`
                for alias in node.names:
                    if alias.name == "faultinject":
                        fi_aliases.add(alias.asname or alias.name)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        if not (
            isinstance(node.value, ast.Name) and node.value.id in fi_aliases
        ):
            continue
        if node.attr not in ALLOWED_ATTRS:
            violations.append(
                (
                    node.lineno,
                    f"faultinject.{node.attr} — production code may only "
                    "use the site()/mutate() shim",
                )
            )

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (
            isinstance(fn, ast.Attribute)
            and fn.attr in ALLOWED_ATTRS
            and isinstance(fn.value, ast.Name)
            and fn.value.id in fi_aliases
        ):
            continue
        if not node.args or not isinstance(node.args[0], ast.Constant) or not (
            isinstance(node.args[0].value, str)
        ):
            violations.append(
                (
                    node.lineno,
                    f"faultinject.{fn.attr}(...) — the site name must be a "
                    "string literal",
                )
            )
            continue
        name = node.args[0].value
        if name not in KNOWN_SITES:
            violations.append(
                (
                    node.lineno,
                    f"faultinject.{fn.attr}({name!r}) — site not registered "
                    "in faultinject.SITES",
                )
            )
            continue
        uses.setdefault(name, []).append(node.lineno)

    return violations, uses


def run(package_dir: str = PACKAGE) -> List[str]:
    failures: List[str] = []
    all_uses: Dict[str, List[str]] = {}
    for dirpath, _dirnames, filenames in os.walk(package_dir):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), package_dir)
            if rel == "faultinject.py":
                continue  # the shim itself
            if rel == "test_utils.py":
                # The test harness, not the pipeline: its subprocess
                # launchers arm fault plans via configure() — exactly the
                # "tests, benchmarks, and process bootstrap" audience the
                # shim contract carves out.
                continue
            if rel.split(os.sep)[0] == "analysis":
                # The analyzer itself: this module imports KNOWN_SITES to
                # lint against the registry — tooling, not pipeline, the
                # same carve-out as test_utils.py above.
                continue
            path = os.path.join(dirpath, fname)
            with open(path, "r") as f:
                source = f.read()
            violations, uses = check_source(source, path)
            for lineno, what in violations:
                failures.append(f"{rel}:{lineno}: {what}")
            for name, lines in uses.items():
                for lineno in lines:
                    all_uses.setdefault(name, []).append(f"{rel}:{lineno}")
    for name, locations in sorted(all_uses.items()):
        if len(locations) > 1:
            failures.append(
                f"site {name!r} used at {len(locations)} call sites "
                f"({', '.join(locations)}) — one call per name, or plans "
                "stop replaying deterministically"
            )
    for name in sorted(KNOWN_SITES - set(all_uses)):
        failures.append(
            f"site {name!r} is registered in faultinject.SITES but wired "
            "nowhere — remove the registration or thread the site"
        )
    for name, pinned_file in sorted(PINNED_SITE_FILES.items()):
        for location in all_uses.get(name, []):
            if not location.startswith(pinned_file + ":"):
                failures.append(
                    f"site {name!r} used at {location} but pinned to "
                    f"{pinned_file} — coordination sites must not drift "
                    "out of the store/peer plane"
                )
    if len(KNOWN_SITES) < MIN_SITES:
        failures.append(
            f"site registry shrank to {len(KNOWN_SITES)} (< {MIN_SITES}): "
            "a drill surface was unthreaded"
        )
    return failures


def _parse_failure(failure: str) -> Tuple[str, int, str]:
    """Map a legacy failure string onto (file, line, message)."""
    head, sep, rest = failure.partition(": ")
    if sep:
        path, colon, lineno = head.rpartition(":")
        if colon and lineno.isdigit() and path:
            return (
                os.path.join(PACKAGE_NAME, path).replace(os.sep, "/"),
                int(lineno),
                rest,
            )
    # registry-level failures (floors, dead/duplicated sites) anchor at
    # the registry module
    return (f"{PACKAGE_NAME}/faultinject.py", 1, failure)


def run_pass(project: Project) -> List[Finding]:
    out = []
    for failure in sorted(run()):
        file, line, message = _parse_failure(failure)
        out.append(Finding(rule="fault-sites", file=file, line=line, message=message))
    return out

