"""Reversible flattening of nested containers into slash-delimited logical paths.

The port's own copy of ``torchsnapshot_tpu/flatten.py``: dict/OrderedDict
(any Mapping), list, tuple and namedtuple containers; everything else is a
leaf. The logical path of a leaf is the '/'-joined sequence of escaped keys
from the root, with '/' and '%' percent-escaped. Restore identity depends on
these paths, so the escaping scheme is part of the on-disk format shared
with the JAX package.
"""

from __future__ import annotations

import urllib.parse
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

from .manifest import (
    DictEntry,
    Entry,
    ListEntry,
    Manifest,
    NamedTupleEntry,
    OrderedDictEntry,
    TupleEntry,
)


def _escape_key(key: str) -> str:
    # Escape '%' first, then '/'; unescape is a plain unquote.
    return urllib.parse.quote(key, safe="")


def _unescape_key(key: str) -> str:
    return urllib.parse.unquote(key)


def _is_namedtuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields") and hasattr(obj, "_asdict")


def _check_dict_keys(obj: Mapping, prefix: str) -> None:
    seen = set()
    for key in obj.keys():
        if not isinstance(key, (str, int)):
            raise RuntimeError(
                f"Can not flatten dict at {prefix!r}: unsupported key type "
                f"{type(key).__name__} (only str and int keys are supported)."
            )
        s = str(key)
        if s in seen:
            raise RuntimeError(
                f"Can not flatten dict at {prefix!r}: keys {key!r} and a "
                f"previous key collide when converted to string."
            )
        seen.add(s)


def flatten(obj: Any, prefix: str = "") -> Tuple[Manifest, Dict[str, Any]]:
    """Flatten a nested container into (container manifest, {path: leaf}).

    The manifest records the container structure (one entry per container,
    keyed by its logical path); ``flattened`` maps each leaf's logical path to
    the leaf object. ``inflate`` is the exact inverse.
    """
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    _flatten_impl(obj, prefix, manifest, flattened)
    return manifest, flattened


def _flatten_impl(
    obj: Any, prefix: str, manifest: Manifest, flattened: Dict[str, Any]
) -> None:
    if isinstance(obj, OrderedDict):
        _check_dict_keys(obj, prefix)
        manifest[prefix] = OrderedDictEntry(keys=list(obj.keys()))
        for key, val in obj.items():
            _flatten_impl(val, f"{prefix}/{_escape_key(str(key))}", manifest, flattened)
    elif isinstance(obj, Mapping):  # includes dict, flax FrozenDict, ...
        _check_dict_keys(obj, prefix)
        manifest[prefix] = DictEntry(keys=list(obj.keys()))
        for key, val in obj.items():
            _flatten_impl(val, f"{prefix}/{_escape_key(str(key))}", manifest, flattened)
    elif _is_namedtuple(obj):
        manifest[prefix] = NamedTupleEntry(
            module=type(obj).__module__,
            qualname=type(obj).__qualname__,
            fields=list(obj._fields),
        )
        for idx, val in enumerate(obj):
            _flatten_impl(val, f"{prefix}/{idx}", manifest, flattened)
    elif isinstance(obj, tuple):
        manifest[prefix] = TupleEntry()
        for idx, val in enumerate(obj):
            _flatten_impl(val, f"{prefix}/{idx}", manifest, flattened)
    elif isinstance(obj, list):
        manifest[prefix] = ListEntry()
        for idx, val in enumerate(obj):
            _flatten_impl(val, f"{prefix}/{idx}", manifest, flattened)
    else:
        flattened[prefix] = obj


def inflate(manifest: Manifest, flattened: Dict[str, Any], prefix: str = "") -> Any:
    """Reconstruct the nested container from container entries + leaves."""
    # Children of each container path, in insertion order of discovery.
    children: Dict[str, List[str]] = {}
    all_paths = list(manifest.keys()) + [p for p in flattened if p not in manifest]
    for path in all_paths:
        if path == prefix:
            continue
        if not path.startswith(prefix + "/") and prefix != "":
            continue
        parent, _, _ = path.rpartition("/")
        children.setdefault(parent, []).append(path)

    def build(path: str) -> Any:
        entry = manifest.get(path)
        if entry is None:
            if path in flattened:
                return flattened[path]
            raise KeyError(
                f"Can not inflate: no entry or value for logical path {path!r}."
            )
        kids = children.get(path, [])
        kid_by_seg = {p.rsplit("/", 1)[-1]: p for p in kids}
        if isinstance(entry, (DictEntry, OrderedDictEntry)):
            cls = OrderedDict if isinstance(entry, OrderedDictEntry) else dict
            out = cls()
            for key in entry.keys:
                seg = _escape_key(str(key))
                out[key] = build(kid_by_seg[seg]) if seg in kid_by_seg else build(f"{path}/{seg}")
            return out
        elif isinstance(entry, NamedTupleEntry):
            vals = [build(f"{path}/{i}") for i in range(len(entry.fields))]
            nt_cls = _resolve_namedtuple(entry)
            if nt_cls is not None:
                try:
                    return nt_cls(*vals)
                except TypeError:
                    pass
            return tuple(vals)
        elif isinstance(entry, TupleEntry):
            idxs = sorted(int(p.rsplit("/", 1)[-1]) for p in kids)
            return tuple(build(f"{path}/{i}") for i in idxs)
        elif isinstance(entry, ListEntry):
            idxs = sorted(int(p.rsplit("/", 1)[-1]) for p in kids)
            return [build(f"{path}/{i}") for i in idxs]
        else:
            raise RuntimeError(
                f"Unexpected non-container entry at {path!r}: {type(entry).__name__}"
            )

    return build(prefix)


def _resolve_namedtuple(entry: NamedTupleEntry):
    """Best-effort import of the original namedtuple class (e.g. optax states).

    Falls back to None (caller builds a plain tuple); pytree-compatible
    consumers that unflatten with their own treedef are unaffected.
    """
    try:
        import importlib

        mod = importlib.import_module(entry.module)
        obj = mod
        for part in entry.qualname.split("."):
            obj = getattr(obj, part)
        if isinstance(obj, type) and hasattr(obj, "_fields"):
            if list(obj._fields) == list(entry.fields):
                return obj
    except Exception:
        pass
    return None
