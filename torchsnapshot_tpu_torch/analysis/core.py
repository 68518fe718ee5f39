"""tsalint core: one parse of the package, shared resolution helpers.

Every pass (the four deep passes plus the five legacy lints) consumes the
same :class:`Project`: the package's modules parsed once, with
module-level constant tables, import maps, and a name-based call graph
built on top. Keeping resolution here means a plugin is ~100 lines of
*rule*, not 100 lines of rule plus 200 lines of AST plumbing.

Resolution is deliberately conservative and name-based: ``self.foo()``
binds to a method ``foo`` of the lexically enclosing class, ``foo()`` to
a module-level function, ``mod.foo()`` to a package-local module bound
by an import. Anything else is unresolved and silently skipped: a
static pass that guesses produces findings nobody trusts, and the bug
classes these passes exist for all live on resolvable paths.

Counterpart of ``torchsnapshot_tpu/analysis/core.py``; the only change
is the package it scans by default, this one.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: The package this analyzer scans by default (the one it lives in), and
#: the repo root above it: findings are rooted at the package's name.
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_NAME = os.path.basename(PACKAGE_DIR)
REPO_DIR = os.path.dirname(PACKAGE_DIR)


@dataclass(frozen=True)
class Finding:
    """One analyzer finding. ``file`` is repo-relative (posix slashes) so
    findings are stable across checkouts; ``rule`` is the plugin's rule
    id (the suppression key); ``line`` is 1-based."""

    rule: str
    file: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "message": self.message,
        }


@dataclass
class Module:
    """One parsed source file."""

    rel: str  # repo-relative posix path ("torchsnapshot_tpu_torch/dist_store.py")
    path: str  # absolute path
    source: str
    tree: ast.Module
    #: raw source lines (1-based access via lines[lineno - 1])
    lines: List[str] = field(default_factory=list)
    #: module-level NAME = "literal" bindings
    consts: Dict[str, str] = field(default_factory=dict)
    #: from-import map: local name -> (module dotted path as written, original name)
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: plain-import map: local alias -> module dotted path as written
    mod_imports: Dict[str, str] = field(default_factory=dict)

    @property
    def basename(self) -> str:
        return os.path.basename(self.rel)


@dataclass(frozen=True)
class FunctionInfo:
    """One function or method definition."""

    module_rel: str
    class_name: Optional[str]  # enclosing class, or None for top-level
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda

    @property
    def qualname(self) -> str:
        if self.class_name:
            return f"{self.module_rel}::{self.class_name}.{self.name}"
        return f"{self.module_rel}::{self.name}"


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c``; None for anything
    else (calls, subscripts)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _scan_module(rel: str, path: str, source: str) -> Module:
    tree = ast.parse(source, filename=path)
    mod = Module(rel=rel, path=path, source=source, tree=tree,
                 lines=source.splitlines())
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if (
                isinstance(tgt, ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                mod.consts[tgt.id] = node.value.value
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            src = "." * node.level + (node.module or "")
            for alias in node.names:
                mod.from_imports[alias.asname or alias.name] = (src, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                mod.mod_imports[alias.asname or alias.name.split(".")[0]] = (
                    alias.name
                )
    return mod


class Project:
    """All package modules, parsed once, plus the call graph.

    ``package_dir`` defaults to the ``torchsnapshot_tpu_torch`` tree
    this module lives in; tests point it at synthetic fixture trees. ``rel_prefix`` is
    what findings' repo-relative paths are rooted with.
    """

    def __init__(
        self,
        package_dir: str = PACKAGE_DIR,
        rel_prefix: Optional[str] = None,
        skip: Sequence[str] = (),
    ) -> None:
        self.package_dir = package_dir
        if rel_prefix is None:
            rel_prefix = os.path.relpath(package_dir, REPO_DIR)
            if rel_prefix.startswith(".."):
                rel_prefix = os.path.basename(package_dir)
        self.rel_prefix = rel_prefix.replace(os.sep, "/")
        self.modules: List[Module] = []
        self._by_rel: Dict[str, Module] = {}
        skipset = set(skip)
        for dirpath, dirnames, filenames in os.walk(package_dir):
            dirnames.sort()
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                sub = os.path.relpath(path, package_dir).replace(os.sep, "/")
                if sub in skipset:
                    continue
                rel = f"{self.rel_prefix}/{sub}"
                with open(path, "r") as f:
                    source = f.read()
                mod = _scan_module(rel, path, source)
                self.modules.append(mod)
                self._by_rel[sub] = mod
        self._functions: Optional[List[FunctionInfo]] = None
        self._fn_index: Dict[Tuple[str, Optional[str], str], FunctionInfo] = {}

    # --------------------------------------------------------- lookups

    def module(self, sub: str) -> Optional[Module]:
        """Module by package-relative path ("dist_store.py")."""
        return self._by_rel.get(sub)

    def resolve_const(self, mod: Module, node: ast.AST) -> Optional[str]:
        """A string literal, a module-level string constant, or a
        constant imported from a sibling module — else None."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr  # mod.CONST: fall through on attr name
        if name is None:
            return None
        if name in mod.consts:
            return mod.consts[name]
        imp = mod.from_imports.get(name)
        if imp is not None:
            src_mod = self._module_for_import(mod, imp[0])
            if src_mod is not None:
                return src_mod.consts.get(imp[1])
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            src_mod = self._resolve_module_alias(mod, node.value.id)
            if src_mod is not None:
                return src_mod.consts.get(name)
        return None

    def _module_for_import(self, mod: Module, written: str) -> Optional[Module]:
        """Best-effort: map an import's written module path back to a
        project module (relative imports and absolute package imports)."""
        tail = written.lstrip(".").split(".")[-1] if written.strip(".") else ""
        if not tail:
            return None
        for cand, m in self._by_rel.items():
            if cand == f"{tail}.py" or cand.endswith(f"/{tail}.py"):
                return m
            if cand == f"{tail}/__init__.py":
                return m
        return None

    def _resolve_module_alias(self, mod: Module, alias: str) -> Optional[Module]:
        """Resolve a local name bound to a package-local module."""
        if alias in mod.from_imports:
            src, orig = mod.from_imports[alias]
            # `from . import native_io` / `from .telemetry import core`
            candidate = self._module_for_import(mod, src + "." + orig)
            if candidate is not None:
                return candidate
        if alias in mod.mod_imports:
            return self._module_for_import(mod, mod.mod_imports[alias])
        return None

    # ------------------------------------------------------ call graph

    def functions(self) -> List[FunctionInfo]:
        if self._functions is None:
            self._functions = []
            for mod in self.modules:
                self._collect_functions(mod)
        return self._functions

    def _collect_functions(self, mod: Module) -> None:
        def visit(node: ast.AST, class_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info = FunctionInfo(
                        module_rel=mod.rel,
                        class_name=class_name,
                        name=child.name,
                        node=child,
                    )
                    assert self._functions is not None
                    self._functions.append(info)
                    self._fn_index.setdefault(
                        (mod.rel, class_name, child.name), info
                    )
                    # nested defs: keep the class scope for methods'
                    # inner helpers (conservative)
                    visit(child, class_name)

        visit(mod.tree, None)

    def lookup_function(
        self, module_rel: str, class_name: Optional[str], name: str
    ) -> Optional[FunctionInfo]:
        self.functions()
        return self._fn_index.get((module_rel, class_name, name))

    def resolve_call(
        self, mod: Module, caller: FunctionInfo, call: ast.Call
    ) -> List[FunctionInfo]:
        """Resolve a call to project-local function(s); [] if unknown."""
        self.functions()
        fn = call.func
        out: List[FunctionInfo] = []
        if isinstance(fn, ast.Name):
            # module-level function in the same module, or a from-import
            hit = self._fn_index.get((mod.rel, None, fn.id))
            if hit is not None:
                out.append(hit)
            else:
                imp = mod.from_imports.get(fn.id)
                if imp is not None:
                    src_mod = self._module_for_import(mod, imp[0])
                    if src_mod is not None:
                        hit = self._fn_index.get((src_mod.rel, None, imp[1]))
                        if hit is not None:
                            out.append(hit)
        elif isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                if caller.class_name is not None:
                    hit = self._fn_index.get(
                        (mod.rel, caller.class_name, fn.attr)
                    )
                    if hit is not None:
                        out.append(hit)
            elif isinstance(base, ast.Name):
                src_mod = self._resolve_module_alias(mod, base.id)
                if src_mod is not None:
                    hit = self._fn_index.get((src_mod.rel, None, fn.attr))
                    if hit is not None:
                        out.append(hit)
        return out

    def module_of(self, info: FunctionInfo) -> Module:
        for mod in self.modules:
            if mod.rel == info.module_rel:
                return mod
        raise KeyError(info.module_rel)

    # ------------------------------------------------------- iteration

    def walk_functions(self) -> Iterator[Tuple[Module, FunctionInfo]]:
        for info in self.functions():
            yield self.module_of(info), info


# ------------------------------------------------------ shared matchers

#: Terminal attribute/variable names treated as locks by the concurrency
#: passes. Name-based on purpose: the codebase's locks are all named
#: like locks (``lock``, ``_lock``, ``_cond``, ``_conns_lock``, ``lk``),
#: and a lock the passes can't see is a lock a reader can't see either.
def is_lockish_name(name: str) -> bool:
    low = name.rsplit(".", 1)[-1].lower()
    if low in ("lk", "mutex", "cond"):
        return True
    return low.endswith("lock") or low.endswith("cond")


def lock_key(dotted_name: str) -> str:
    """Canonical per-module lock identity: the terminal attribute name
    (``self._cond`` -> ``_cond``; ``link.lock`` -> ``lock``)."""
    return dotted_name.rsplit(".", 1)[-1]


#: Calls that block the calling thread. Matched on the terminal
#: attribute name of the callee (plus the dotted prefixes below).
BLOCKING_ATTR_CALLS = {
    "recv", "recv_into", "recvfrom", "accept", "connect", "sendall",
    "makefile", "getevents", "fsync", "flock",
}
BLOCKING_DOTTED_CALLS = {
    "time.sleep",
    "select.select",
    "os.read", "os.write", "os.pread", "os.pwrite",
    "os.preadv", "os.pwritev", "os.fsync",
    "socket.create_connection",
    "subprocess.run", "subprocess.check_call", "subprocess.check_output",
}
#: join()/wait() block indefinitely only without a timeout.
TIMEOUT_GATED_CALLS = {"join", "wait", "wait_for", "get"}


def blocking_call_label(call: ast.Call) -> Optional[str]:
    """A human-readable label if this call blocks, else None."""
    fn = call.func
    name = dotted(fn)
    if name is not None:
        if name in BLOCKING_DOTTED_CALLS:
            return name
        tail = name.rsplit(".", 1)[-1]
        if tail in BLOCKING_ATTR_CALLS and "." in name:
            return name
        if tail in TIMEOUT_GATED_CALLS and "." in name:
            if not _has_timeout(call):
                return f"{name} (no timeout)"
            return None
    return None


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        # join(5) / wait(timeout) positional
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def acquire_is_blocking(call: ast.Call) -> bool:
    """True for ``<lock>.acquire(...)`` calls that can block: no
    ``blocking=False`` keyword and no literal-False first argument."""
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    if call.args and isinstance(call.args[0], ast.Constant):
        return bool(call.args[0].value)
    return True
