"""Resource-lifecycle pass (rule ``resource-lifecycle``).

The bug class: ``UringEngine.__init__`` (the native engine) could
raise after the ring fd and its three mmaps existed but before the
object was constructed — no ``__del__`` runs for a half-built object, so
every failed write attempt leaked a ring fd and three kernel mappings.
The general shape: a kernel resource is acquired into a local, and an
exception (or early return) between acquisition and release orphans it.

The pass tracks locals assigned from resource acquirers — ``os.open``,
``os.pipe``, ``socket.socket``, ``socket.create_connection``,
``mmap.mmap``, and the package's own ``open_for_write`` — and requires,
within the same function, at least one form of all-paths release
evidence:

* the name is mentioned in a ``try/finally`` finalbody,
* the name is an argument to a ``weakref.finalize`` registration,
* the name appears in a ``with`` item (context-managed, including
  ``closing(x)`` / ``fdopen(fd)`` consumption),
* ownership escapes: the name is returned/yielded, stored onto an
  attribute/subscript, or registered into a container
  (``.append``/``.add``/``.put``/``.register``/``.setdefault``) —
  lifetime is then the owner's problem, and the owner is analyzed at its
  own acquisition site.

A bare ``x.close()`` on the straight-line path is deliberately NOT
evidence — it is exactly the pattern that leaks when the line above it
raises. Acquirers used directly as ``with`` items never enter tracking.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/lifecycle.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from ..core import Finding, FunctionInfo, Module, Project, dotted

RULES = ("resource-lifecycle",)

#: Full dotted callee names that acquire a kernel resource.
ACQUIRER_DOTTED = {
    "os.open", "os.pipe", "os.dup", "os.memfd_create",
    "socket.socket", "socket.create_connection", "socket.socketpair",
    "mmap.mmap", "_mmap.mmap",
}
#: Terminal callee names that acquire regardless of qualification
#: (package-local helpers returning raw fds/handles).
ACQUIRER_TAILS = {"open_for_write"}

_STORE_METHODS = {"append", "add", "put", "register", "setdefault"}


def _acquirer_label(call: ast.Call) -> str | None:
    name = dotted(call.func)
    if name is None:
        return None
    if name in ACQUIRER_DOTTED:
        return name
    if name.rsplit(".", 1)[-1] in ACQUIRER_TAILS:
        return name
    return None


def _own_statements(root: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's own body — descend into everything except
    nested function/class defs (they are analyzed as their own
    functions), but DO enter lambdas (``lambda: os.open(...)`` passed to
    an executor still acquires on behalf of the enclosing function)."""
    for node in ast.iter_child_nodes(root):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        yield from _own_statements(node)


def _mentions(node: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


def _assign_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            if isinstance(elt, ast.Name):
                out.append(elt.id)
        return out
    return []


def _scan_function(mod: Module, info: FunctionInfo) -> List[Finding]:
    node = info.node
    #: name -> (line, acquirer label) for tracked acquisitions
    acquired: Dict[str, Tuple[int, str]] = {}
    safe: Set[str] = set()

    for stmt in _own_statements(node):
        # acquisitions: locals assigned from an acquirer call
        targets: List[ast.AST] = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is not None:
            label = None
            for sub in ast.walk(value):
                if isinstance(sub, ast.Call):
                    label = _acquirer_label(sub)
                    if label is not None:
                        break
            if label is not None:
                for tgt in targets:
                    names = _assign_names(tgt)
                    if names:
                        for n in names:
                            acquired.setdefault(n, (stmt.lineno, label))
                    else:
                        # stored straight onto self.x / d[k]: owner's job
                        pass

        # release / escape evidence
        if isinstance(stmt, ast.Try) and stmt.finalbody:
            for fin in stmt.finalbody:
                for n in ast.walk(fin):
                    if isinstance(n, ast.Name):
                        safe.add(n.id)
        elif isinstance(stmt, (ast.Return, ast.Yield, ast.YieldFrom)):
            if getattr(stmt, "value", None) is not None:
                for n in ast.walk(stmt.value):  # type: ignore[arg-type]
                    if isinstance(n, ast.Name):
                        safe.add(n.id)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                for n in ast.walk(item.context_expr):
                    if isinstance(n, ast.Name):
                        safe.add(n.id)
        elif isinstance(stmt, ast.Assign):
            if any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in stmt.targets
            ):
                for n in ast.walk(stmt.value):
                    if isinstance(n, ast.Name):
                        safe.add(n.id)
        elif isinstance(stmt, ast.Call):
            fname = dotted(stmt.func)
            if fname == "weakref.finalize" or (
                fname is not None
                and fname.rsplit(".", 1)[-1] in _STORE_METHODS
            ):
                for arg in stmt.args:
                    for n in ast.walk(arg):
                        if isinstance(n, ast.Name):
                            safe.add(n.id)

    out = []
    for name, (line, label) in sorted(acquired.items()):
        if name in safe:
            continue
        out.append(
            Finding(
                rule="resource-lifecycle",
                file=mod.rel,
                line=line,
                message=(
                    f"{name} = {label}(...) has no all-paths release: no "
                    "try/finally, context manager, registered finalizer, or "
                    "ownership escape in this function — an exception "
                    "before close() leaks the handle"
                ),
            )
        )
    return out


def run_pass(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod, info in project.walk_functions():
        out.extend(_scan_function(mod, info))
    out.sort(key=lambda f: (f.file, f.line, f.message))
    return out
