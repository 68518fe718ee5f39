"""Restricted-context pass (rule ``restricted-context``).

The bug class: a ``weakref.finalize`` callback
runs on whatever thread happens to trigger collection — including a
thread that is *inside* the staging pool's critical section, because the
pool's own bookkeeping allocates. A finalizer that does a blocking
``lock.acquire()`` can therefore self-deadlock; one that does I/O can
block an arbitrary victim thread; the same holds for ``__del__`` (runs
at arbitrary points, possibly at interpreter shutdown) and signal
handlers (run on the main thread between bytecodes — a blocking call
there freezes delivery, and taking a lock the interrupted frame already
holds deadlocks).

The pass collects every function reachable (over the package-local call
graph) from:

* ``weakref.finalize(obj, callback, ...)`` callbacks,
* ``__del__`` methods,
* ``signal.signal(sig, handler)`` handlers,

and flags, anywhere in that closure: blocking lock acquisition (``with
<lock>:`` or ``.acquire()`` without ``blocking=False``), blocking calls
(socket verbs, ``sleep``, ``join``/``wait`` sans timeout — see
:data:`core.BLOCKING_ATTR_CALLS`), and file/device I/O (``open``,
``os.open``). Non-blocking acquires are the blessed idiom: mutate the
pool only under ``acquire(blocking=False)`` and defer to a queue when
the lock is contended (see ``_StagingPool._put``). ``os.close`` is
deliberately NOT flagged — releasing an fd is exactly what a finalizer
is for.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/restricted.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import (
    Finding,
    FunctionInfo,
    Module,
    Project,
    acquire_is_blocking,
    blocking_call_label,
    dotted,
    is_lockish_name,
)

RULES = ("restricted-context",)

_IO_CALLS = {"open", "os.open", "io.open", "os.fdopen"}

_MAX_DEPTH = 8


def _resolve_callback(
    project: Project, mod: Module, owner: FunctionInfo, expr: ast.AST
) -> Optional[FunctionInfo]:
    """Resolve a callback expression (``self._put``, a bare name, or a
    module attr) to a project function."""
    if isinstance(expr, ast.Attribute):
        base = expr.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            if owner.class_name is not None:
                return project.lookup_function(
                    mod.rel, owner.class_name, expr.attr
                )
        elif isinstance(base, ast.Name):
            src_mod = project._resolve_module_alias(mod, base.id)
            if src_mod is not None:
                return project.lookup_function(src_mod.rel, None, expr.attr)
        return None
    if isinstance(expr, ast.Name):
        hit = project.lookup_function(mod.rel, None, expr.id)
        if hit is not None:
            return hit
        imp = mod.from_imports.get(expr.id)
        if imp is not None:
            src_mod = project._module_for_import(mod, imp[0])
            if src_mod is not None:
                return project.lookup_function(src_mod.rel, None, imp[1])
    return None


def _roots(project: Project) -> List[Tuple[FunctionInfo, str]]:
    """(function, context-description) pairs to BFS from."""
    roots: List[Tuple[FunctionInfo, str]] = []
    seen: Set[str] = set()

    def add(info: Optional[FunctionInfo], desc: str) -> None:
        if info is not None and info.qualname not in seen:
            seen.add(info.qualname)
            roots.append((info, desc))

    for mod, info in project.walk_functions():
        if info.name == "__del__" and info.class_name is not None:
            add(info, f"__del__ of {info.class_name}")
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name == "weakref.finalize" or (
                isinstance(node.func, ast.Name)
                and node.func.id == "finalize"
                and mod.from_imports.get("finalize", ("", ""))[1] == "finalize"
            ):
                if len(node.args) >= 2:
                    cb = _resolve_callback(project, mod, info, node.args[1])
                    add(cb, f"finalizer registered at {mod.rel}:{node.lineno}")
            elif name == "signal.signal" and len(node.args) >= 2:
                cb = _resolve_callback(project, mod, info, node.args[1])
                add(cb, f"signal handler installed at {mod.rel}:{node.lineno}")
    return roots


def _scan_function(
    project: Project, mod: Module, info: FunctionInfo, desc: str,
    findings: Dict[Tuple[str, int], Finding],
) -> List[ast.Call]:
    """Flag restricted operations in one function; return its calls for
    the BFS."""
    calls: List[ast.Call] = []

    def flag(line: int, what: str) -> None:
        findings.setdefault(
            (mod.rel, line),
            Finding(
                rule="restricted-context",
                file=mod.rel,
                line=line,
                message=(
                    f"{what} in code reachable from a restricted context "
                    f"({desc}) — finalizers/__del__/signal handlers run on "
                    "arbitrary threads; use acquire(blocking=False) + defer, "
                    "or move the work off this path"
                ),
            ),
        )

    for node in ast.walk(info.node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = dotted(item.context_expr)
                if name is not None and is_lockish_name(name):
                    flag(node.lineno, f"blocking acquire of {name}")
        elif isinstance(node, ast.Call):
            calls.append(node)
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "acquire"
                and acquire_is_blocking(node)
            ):
                target = dotted(fn.value)
                if target is not None and is_lockish_name(target):
                    flag(node.lineno, f"blocking acquire of {target}")
                continue
            label = blocking_call_label(node)
            if label is not None:
                flag(node.lineno, f"blocking call {label}")
                continue
            name = dotted(fn)
            if name in _IO_CALLS:
                flag(node.lineno, f"file I/O via {name}")
    return calls


def run_pass(project: Project) -> List[Finding]:
    findings: Dict[Tuple[str, int], Finding] = {}
    visited: Set[str] = set()
    queue: List[Tuple[FunctionInfo, str, int]] = [
        (info, desc, 0) for info, desc in _roots(project)
    ]
    while queue:
        info, desc, depth = queue.pop(0)
        if info.qualname in visited:
            continue
        visited.add(info.qualname)
        mod = project.module_of(info)
        calls = _scan_function(project, mod, info, desc, findings)
        if depth >= _MAX_DEPTH:
            continue
        for call in calls:
            for callee in project.resolve_call(mod, info, call):
                if callee.qualname not in visited:
                    queue.append((callee, desc, depth + 1))
    out = list(findings.values())
    out.sort(key=lambda f: (f.file, f.line, f.message))
    return out
