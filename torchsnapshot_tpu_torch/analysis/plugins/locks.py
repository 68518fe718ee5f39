"""Lock-discipline pass (rules ``lock-order``, ``lock-blocking``).

The bug class: a lock-order inversion between ``dist_store``'s data
condition and a replica link's lock could wedge every store op, and a
blocking socket exchange made while holding the data lock starved lease
renewals into a cascade deposition. Both were found by hand in the JAX
package's store, which this package's ``dist_store.py`` copies. This pass
derives the per-module lock-acquisition graph and makes the discipline
mechanical:

**lock-order** — an acquisition edge ``a -> b`` (lock ``b`` taken while
``a`` is held) is followed through package-local calls (the store's
inversion was interprocedural: ``dispatch`` holds the cond, two frames
later ``link.send`` takes the link lock). A module with a DOCUMENTED
order (:data:`DOCUMENTED_ORDERS`) fails on any edge that runs against
it; any module fails on an observed two-way inversion (``a -> b`` and
``b -> a`` both present). Deliberate amendments (dist_store's buffered
sync path) carry in-file ``allow[lock-order]`` justifications.

**lock-blocking** — a call that blocks the thread (socket verbs, file
I/O, ``join``/``wait`` without timeout, ``sleep``) made lexically inside
a ``with <lock>:`` body, either directly or through ONE level of
package-local call (``_send_msg(sock, ...)`` under a link lock blocks in
``sock.sendall`` — the wrapper is where the repo's real exchanges live).
Exactly one level on purpose: unbounded descent re-reports every
transitive chain and drowns the signal, while depth 0 sees only bare
socket verbs nobody writes inline. Deliberate holds (the replica link's
deadline-bounded exchange, the client's per-connection request
serialization) carry ``allow[lock-blocking]`` justifications at the
call site.

Locks are recognized by name (``*lock``, ``*cond``, ``lk``, ``mutex`` —
see :func:`core.is_lockish_name`) and identified per-module by their
terminal attribute name: ``self._cond`` is ``_cond``, ``link.lock`` is
``lock``. Name-based identity is the point, not a limitation — a lock
whose name doesn't say it's a lock defeats a reader too.

Counterpart of ``torchsnapshot_tpu/analysis/plugins/locks.py``, with the
same documented order for ``dist_store.py``.
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
    lock_key,
)

RULES = ("lock-order", "lock-blocking")

#: Documented per-module lock orders, keyed by package-relative path.
#: Earlier entries outrank later ones: a lock may be taken while holding
#: any lock to its LEFT; taking a left lock while holding a right one is
#: a violation. dist_store.py's order is the class docstring's locking
#: rules (``_StoreServer``): the data cond outranks replica link locks.
DOCUMENTED_ORDERS: Dict[str, Tuple[str, ...]] = {
    "dist_store.py": ("_cond", "lock"),
}

_MAX_DEPTH = 8


def _with_lock_names(node: ast.With) -> List[Tuple[str, str]]:
    """(dotted, key) for each lock-ish context manager in a with."""
    out = []
    for item in node.items:
        name = dotted(item.context_expr)
        if name is not None and is_lockish_name(name):
            out.append((name, lock_key(name)))
    return out


class _Walker:
    """Interprocedural held-lock propagation for edge discovery."""

    def __init__(self, project: Project) -> None:
        self.project = project
        #: (outer_key, inner_key) -> [(rel, line, outer_dotted, inner_dotted)]
        self.edges: Dict[str, Dict[Tuple[str, str], List[Tuple[str, int, str, str]]]] = {}
        self._visited: Set[Tuple[str, frozenset]] = set()

    def walk_function(self, mod: Module, info: FunctionInfo) -> None:
        self._walk_body(mod, info, info.node, held=())

    def _record_edge(
        self, mod: Module, line: int, held: Tuple[Tuple[str, str], ...],
        name: str, key: str,
    ) -> None:
        per_mod = self.edges.setdefault(mod.rel, {})
        for outer_name, outer_key in held:
            if outer_key == key:
                continue  # same terminal name: identity is ambiguous
            per_mod.setdefault((outer_key, key), []).append(
                (mod.rel, line, outer_name, name)
            )

    def _walk_body(
        self,
        mod: Module,
        info: FunctionInfo,
        root: ast.AST,
        held: Tuple[Tuple[str, str], ...],
        depth: int = 0,
    ) -> None:
        for node in ast.iter_child_nodes(root):
            self._walk_node(mod, info, node, held, depth)

    def _walk_node(
        self,
        mod: Module,
        info: FunctionInfo,
        node: ast.AST,
        held: Tuple[Tuple[str, str], ...],
        depth: int,
    ) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are walked as their own roots
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locks = _with_lock_names(node)
            new_held = held
            for name, key in locks:
                self._record_edge(mod, node.lineno, new_held, name, key)
                new_held = new_held + ((name, key),)
            # the with-items themselves evaluate under the OLD held set
            for item in node.items:
                self._walk_node(mod, info, item, held, depth)
            for child in node.body:
                self._walk_node(mod, info, child, new_held, depth)
            return
        if isinstance(node, ast.Call):
            self._handle_call(mod, info, node, held, depth)
        self._walk_body(mod, info, node, held, depth)

    def _handle_call(
        self,
        mod: Module,
        info: FunctionInfo,
        call: ast.Call,
        held: Tuple[Tuple[str, str], ...],
        depth: int,
    ) -> None:
        fn = call.func
        # explicit .acquire() on a lock-ish target: an acquisition event
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr == "acquire"
            and acquire_is_blocking(call)
        ):
            target = dotted(fn.value)
            if target is not None and is_lockish_name(target):
                self._record_edge(
                    mod, call.lineno, held, target, lock_key(target)
                )
        if not held or depth >= _MAX_DEPTH:
            return
        for callee in self.project.resolve_call(mod, info, call):
            sig = (callee.qualname, frozenset(k for _, k in held))
            if sig in self._visited:
                continue
            self._visited.add(sig)
            callee_mod = self.project.module_of(callee)
            self._walk_body(callee_mod, callee, callee.node, held, depth + 1)


def _own_nodes(root: ast.AST):
    """Descendants of a function, not entering nested defs."""
    for node in ast.iter_child_nodes(root):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        yield from _own_nodes(node)


def _direct_blocking_labels(project: Project) -> Dict[str, str]:
    """qualname -> label for functions whose OWN body makes a blocking
    call (the one-level summary the lexical scan consults)."""
    out: Dict[str, str] = {}
    for _mod, info in project.walk_functions():
        for node in _own_nodes(info.node):
            if isinstance(node, ast.Call):
                label = blocking_call_label(node)
                if label is not None:
                    out[info.qualname] = label
                    break
        else:
            continue
        continue
    return out


def _blocking_findings(project: Project) -> List[Finding]:
    """Blocking-call-under-lock scan: lexical locks, with one level of
    package-local call descent (see module docstring)."""
    out: Dict[Tuple[str, int], Finding] = {}
    summaries = _direct_blocking_labels(project)

    def call_label(mod: Module, info: FunctionInfo, node: ast.Call) -> Optional[str]:
        label = blocking_call_label(node)
        if label is not None:
            return label
        for callee in project.resolve_call(mod, info, node):
            inner = summaries.get(callee.qualname)
            if inner is not None:
                name = dotted(node.func) or callee.name
                return f"{name} (blocks in {inner})"
        return None

    def scan_node(
        mod: Module, info: FunctionInfo, node: ast.AST, held: List[str]
    ) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are scanned as their own roots
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held + [n for n, _ in _with_lock_names(node)]
            for item in node.items:
                scan_node(mod, info, item, held)
            for child in node.body:
                scan_node(mod, info, child, inner)
            return
        if isinstance(node, ast.Call) and held:
            label = call_label(mod, info, node)
            if label is not None:
                key = (mod.rel, node.lineno)
                out.setdefault(
                    key,
                    Finding(
                        rule="lock-blocking",
                        file=mod.rel,
                        line=node.lineno,
                        message=(
                            f"blocking call {label} while holding "
                            f"{held[-1]} — a stalled peer holds the lock "
                            "open-endedly; move the wait outside the "
                            "critical section or justify with "
                            "allow[lock-blocking]"
                        ),
                    ),
                )
        for child in ast.iter_child_nodes(node):
            scan_node(mod, info, child, held)

    for mod, info in project.walk_functions():
        for child in ast.iter_child_nodes(info.node):
            scan_node(mod, info, child, [])
    return list(out.values())


def run_pass(project: Project) -> List[Finding]:
    walker = _Walker(project)
    for mod, info in project.walk_functions():
        walker.walk_function(mod, info)

    findings: Dict[Tuple[str, int, str], Finding] = {}
    for mod_rel, edges in sorted(walker.edges.items()):
        sub = mod_rel.split("/", 1)[1] if "/" in mod_rel else mod_rel
        order = DOCUMENTED_ORDERS.get(sub)
        ordered_violations: Set[Tuple[str, str]] = set()
        if order:
            rank = {key: i for i, key in enumerate(order)}
            for (outer, inner), sites in sorted(edges.items()):
                if outer in rank and inner in rank and rank[outer] > rank[inner]:
                    ordered_violations.add((outer, inner))
                    for rel, line, outer_name, inner_name in sites:
                        findings.setdefault(
                            (rel, line, "lock-order"),
                            Finding(
                                rule="lock-order",
                                file=rel,
                                line=line,
                                message=(
                                    f"acquires {inner_name} ({inner}) while "
                                    f"holding {outer_name} ({outer}) — "
                                    f"documented order for {sub} is "
                                    f"{' -> '.join(order)}"
                                ),
                            ),
                        )
        for (outer, inner), sites in sorted(edges.items()):
            if (inner, outer) not in edges:
                continue
            if (outer, inner) in ordered_violations or (
                (inner, outer) in ordered_violations
            ):
                continue  # already reported against the documented order
            # report the inversion once per direction, at its first site
            rel, line, outer_name, inner_name = sites[0]
            findings.setdefault(
                (rel, line, "lock-order"),
                Finding(
                    rule="lock-order",
                    file=rel,
                    line=line,
                    message=(
                        f"lock-order inversion: {outer} -> {inner} here, but "
                        f"{inner} -> {outer} is also acquired in this module "
                        "— two threads taking them in opposite order deadlock"
                    ),
                ),
            )
    out = list(findings.values())
    out.extend(_blocking_findings(project))
    out.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return out
