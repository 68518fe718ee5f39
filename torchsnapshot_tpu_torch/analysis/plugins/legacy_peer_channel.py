"""Legacy lint: the cooperative-restore peer plane is device-free by
construction (rule ``peer-channel``).

The peer channel runs on background restore threads, where a device call
or a ``torch.distributed`` collective would contend with (or deadlock
against) the main thread's device work. The streaming consumers that DO
touch devices (io_preparers) sit above the channel; the channel itself
moves bytes only.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/legacy_peer_channel.py``:
the same four files and AST checks. The JAX package bans its device
library, ``jax``; this package bans ``torch`` (``torch.cuda``,
``torch.distributed`` and every other submodule) and, since it imports
nothing of JAX anywhere, ``jax`` too. On a ``jax`` construct both lints
report the same lines and messages.
"""

from __future__ import annotations

import ast
import os
from typing import List

from ..core import PACKAGE_DIR, PACKAGE_NAME, Finding, Project

RULES = ("peer-channel",)

PKG = PACKAGE_DIR

# The peer plane: the fan-out protocol/session module, the transport
# sidecar it rides (dist_store also hosts the KV store — equally
# device-free by the same invariant), and the planned-reshard tier
# (reshard.py) — its consumers run on the same background restore
# threads and its planner must stay runnable device-free (CLI dry-run).
# The fleet-distribution tier (distrib.py) serves chunks and applies
# epoch pushes from listener threads — same invariant (its journal
# materialization imports are lazy, at the apply sites).
PEER_PLANE_FILES = ("fanout.py", "dist_store.py", "reshard.py", "distrib.py")

#: Top-level packages the peer plane may not import.
DEVICE_LIBRARIES = ("jax", "torch")


def check_source(source: str, filename: str) -> list:
    """Return (line, message) violations for one file's source."""
    tree = ast.parse(source, filename=filename)
    violations = []
    device_names = {}  # bound name -> the library it binds

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                if root in DEVICE_LIBRARIES:
                    violations.append(
                        (node.lineno, f"import {alias.name!r}")
                    )
                    device_names[alias.asname or root] = root
        elif isinstance(node, ast.ImportFrom):
            root = (node.module or "").split(".")[0]
            if root in DEVICE_LIBRARIES:
                names = ", ".join(a.name for a in node.names)
                violations.append(
                    (node.lineno, f"from {node.module} import {names}")
                )
                for alias in node.names:
                    device_names[alias.asname or alias.name] = root

    if device_names:
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id in device_names:
                # Attribute chains and calls both root at a Name load.
                if isinstance(node.ctx, ast.Load):
                    root = device_names[node.id]
                    violations.append(
                        (node.lineno, f"use of {root}-bound name {node.id!r}")
                    )
    return sorted(set(violations))


def run_pass(project: Project) -> List[Finding]:
    out = []
    for name in PEER_PLANE_FILES:
        path = os.path.join(PKG, name)
        with open(path, "r") as f:
            source = f.read()
        for lineno, msg in check_source(source, path):
            out.append(
                Finding(
                    rule="peer-channel",
                    file=f"{PACKAGE_NAME}/{name}",
                    line=lineno,
                    message=(
                        f"device library on the peer plane ({msg}) — the "
                        "cooperative-restore byte channel must stay "
                        "background-thread-safe by construction; move device "
                        "work into a consumer above the channel"
                    ),
                )
            )
    return out
