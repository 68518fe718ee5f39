"""Migration to and from reference-format torchsnapshot snapshots
(tricks/torchsnapshot_interop.py of the JAX package).

A user of the reference library (pytorch/torchsnapshot) has checkpoints in
its on-disk format: a ``.snapshot_metadata`` YAML manifest plus one payload
file per tensor chunk, shard or object. This module reads that format from
its documented schema and materializes the app state as nested Python
containers of torch tensors, optionally writing it again as a native
snapshot; :func:`save_as_torchsnapshot` writes the reference format.

Entry types:

- ``Tensor``: ``buffer_protocol`` payloads are raw little-endian row-major
  bytes, decoded into a CPU tensor of the entry's own torch dtype (bf16 and
  the float8 types are native in torch, so no dtype table beyond torch's
  is needed); ``torch_save`` payloads are read with ``torch.load``.
- ``ChunkedTensor``: chunks reassembled by their N-D offsets.
- ``ShardedTensor``: the shards of every rank merged into one dense tensor.
- ``object``: unpickled with ``torch.load``; tensors inside stay tensors.
- primitives (``int``/``float``/``str``/``bool``/``bytes``) from their
  inlined ``serialized_value`` (float and bytes are base64; float is a
  little-endian IEEE-754 double).
- containers (``dict``/``OrderedDict``/``list``) rebuilt in manifest
  order; ``%``-escaped path tokens are unescaped.

Quantized-tensor payloads are refused with ``ValueError``, as in the JAX
package. PyYAML is imported only when a manifest is read or written.
"""

from __future__ import annotations

import base64
import io
import os
import struct
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import unquote

import numpy as np
import torch

SNAPSHOT_METADATA_FILENAME = ".snapshot_metadata"

# The reference stamps entries with ``str(tensor.dtype)``; these are the
# names the JAX package's table accepts, each with its torch dtype.
_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "torch.float32": torch.float32,
    "torch.float": torch.float32,
    "torch.float64": torch.float64,
    "torch.double": torch.float64,
    "torch.float16": torch.float16,
    "torch.half": torch.float16,
    "torch.int8": torch.int8,
    "torch.int16": torch.int16,
    "torch.short": torch.int16,
    "torch.int32": torch.int32,
    "torch.int": torch.int32,
    "torch.int64": torch.int64,
    "torch.long": torch.int64,
    "torch.uint8": torch.uint8,
    "torch.bool": torch.bool,
    "torch.complex64": torch.complex64,
    "torch.complex128": torch.complex128,
    "torch.bfloat16": torch.bfloat16,
    "torch.float8_e4m3fn": torch.float8_e4m3fn,
    "torch.float8_e5m2": torch.float8_e5m2,
}

_QUANTIZED_SERIALIZERS = frozenset(["per_tensor_affine_qtensor", "per_channel_affine_qtensor"])


def _torch_dtype(dtype_str: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[dtype_str]
    except KeyError:
        raise ValueError(
            f"Cannot map torch dtype {dtype_str!r} to a snapshot dtype. "
            "Quantized dtypes have no counterpart in the snapshot format."
        ) from None


def read_metadata(path: str) -> Dict[str, Any]:
    """Parse a reference snapshot's ``.snapshot_metadata`` YAML.

    Returns ``{"version": str, "world_size": int, "manifest": {path: entry}}``
    with the manifest's document order kept (lists are rebuilt in it).
    """
    import yaml

    with open(os.path.join(path, SNAPSHOT_METADATA_FILENAME), "rb") as f:
        meta = yaml.safe_load(f.read())
    if not isinstance(meta, dict) or "manifest" not in meta:
        raise ValueError(f"{path} does not look like a torchsnapshot snapshot")
    return meta


def _read_file(path: str, location: str, byte_range: Optional[List[int]]) -> bytes:
    with open(os.path.join(path, location), "rb") as f:
        if byte_range is None:
            return f.read()
        f.seek(byte_range[0])
        return f.read(byte_range[1] - byte_range[0])


def _numel(shape: List[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _decode_tensor(path: str, entry: Dict[str, Any]) -> torch.Tensor:
    """Decode a reference ``Tensor`` entry into a writable CPU tensor."""
    serializer = entry["serializer"]
    if serializer == "buffer_protocol":
        dtype = _torch_dtype(entry["dtype"])
        shape = entry["shape"]
        nelem = _numel(shape)
        itemsize = dtype.itemsize
        byte_range = entry.get("byte_range")
        with open(os.path.join(path, entry["location"]), "rb") as f:
            if byte_range is not None:
                f.seek(byte_range[0])
            raw = np.fromfile(f, dtype=np.uint8, count=nelem * itemsize)
        if raw.size != nelem * itemsize:
            raise ValueError(
                f"Payload {entry['location']!r} is truncated: expected "
                f"{nelem} elements of {dtype}, got {raw.size // itemsize}"
            )
        return torch.from_numpy(raw).view(dtype).reshape(shape)
    if serializer in _QUANTIZED_SERIALIZERS:
        raise ValueError(
            f"Entry at {entry['location']!r} is a quantized tensor "
            f"({serializer}); the snapshot format has no quantized dtype. "
            "Dequantize in torch before migrating."
        )
    if serializer != "torch_save":
        raise ValueError(f"Unknown serializer {serializer!r}")
    buf = _read_file(path, entry["location"], entry.get("byte_range"))
    # The payload is a bare tensor; weights_only keeps unpickling
    # restricted (no arbitrary-object gadgets from a hostile snapshot).
    return torch.load(io.BytesIO(buf), map_location="cpu", weights_only=True)


def _fill_region(out: torch.Tensor, tensor: torch.Tensor, offsets: List[int],
                 sizes: List[int]) -> None:
    idx = tuple(slice(o, o + s) for o, s in zip(offsets, sizes))
    out[idx] = tensor.reshape(sizes)


def _check_coverage(boxes: List[Tuple[Tuple[int, ...], Tuple[int, ...]]], shape: List[int],
                    what: str) -> None:
    """Require disjoint (offsets, sizes) boxes to tile ``shape`` exactly,
    so that no region of the ``torch.empty`` output stays unwritten."""
    covered = sum(_numel(list(sz)) for _, sz in boxes)
    total = _numel(shape)
    if covered != total:
        raise ValueError(
            f"{what} cover {covered} of {total} elements of shape "
            f"{list(shape)}: the snapshot is missing or duplicating regions"
        )


def _decode_chunked(path: str, entry: Dict[str, Any]) -> torch.Tensor:
    out = torch.empty(entry["shape"], dtype=_torch_dtype(entry["dtype"]))
    _check_coverage(
        [(tuple(c["offsets"]), tuple(c["sizes"])) for c in entry["chunks"]],
        entry["shape"],
        "chunks",
    )
    for chunk in entry["chunks"]:
        _fill_region(out, _decode_tensor(path, chunk["tensor"]), chunk["offsets"],
                     chunk["sizes"])
    return out


def _decode_sharded(path: str, shards: List[Dict[str, Any]]) -> torch.Tensor:
    """Merge shards (gathered across all ranks) into one dense tensor.

    The reference's shard metadata carries no global shape, so it is the
    bounding box of the shards; the coverage check rejects interior gaps,
    and ``_merge_for_rank`` checks that every rank contributed entries.
    Identical shards saved by several ranks are deduplicated by box.
    """
    if not shards:
        raise ValueError("ShardedTensor entry with no shards")
    dedup = {(tuple(s["offsets"]), tuple(s["sizes"])): s for s in shards}
    ndim = len(shards[0]["offsets"])
    full_shape = [max(off[d] + sz[d] for off, sz in dedup) for d in range(ndim)]
    _check_coverage(list(dedup.keys()), full_shape, "shards")
    out = torch.empty(full_shape, dtype=_torch_dtype(shards[0]["tensor"]["dtype"]))
    for (offsets, sizes), shard in dedup.items():
        _fill_region(out, _decode_tensor(path, shard["tensor"]), list(offsets), list(sizes))
    return out


def _decode_primitive(entry: Dict[str, Any]) -> Any:
    typ = entry["type"]
    val = entry["serialized_value"]
    if typ == "int":
        return int(val)
    if typ == "str":
        return str(val)
    if typ == "bool":
        return val == "True"
    if typ == "float":
        # Inlined as a base64 little-endian IEEE-754 double, for exactness.
        return struct.unpack("<d", base64.b64decode(val))[0]
    if typ == "bytes":
        return base64.b64decode(val)
    raise ValueError(f"Unknown primitive type {typ!r}")


def _decode_object(path: str, entry: Dict[str, Any]) -> Any:
    buf = _read_file(path, entry["location"], entry.get("byte_range"))
    return torch.load(io.BytesIO(buf), map_location="cpu", weights_only=False)


def _merge_for_rank(
    manifest: Dict[str, Dict[str, Any]], rank: int, world_size: Optional[int] = None
) -> "OrderedDict[str, Dict[str, Any]]":
    """The logical-path view for ``rank``, by the reference's rules:
    per-rank entries from ``rank``'s prefix only, replicated entries from
    any rank (first wins), ShardedTensor shards merged across all ranks,
    containers from ``rank``'s own prefix only."""
    merged: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    sharded: Dict[str, List[Dict[str, Any]]] = {}
    seen_ranks: set = set()
    for key, entry in manifest.items():
        owner_str, _, logical = key.partition("/")
        try:
            owner = int(owner_str)
        except ValueError:
            raise ValueError(f"Manifest key {key!r} lacks a rank prefix") from None
        seen_ranks.add(owner)
        if entry["type"] == "ShardedTensor":
            sharded.setdefault(logical, []).extend(entry["shards"])
            merged.setdefault(logical, {"type": "ShardedTensor", "shards": []})
        elif entry["type"] in ("dict", "OrderedDict", "list"):
            if owner == rank:
                merged.setdefault(logical, entry)
        elif owner == rank or entry.get("replicated", False):
            merged.setdefault(logical, entry)
    if rank not in seen_ranks:
        raise ValueError(
            f"Rank {rank} did not save this snapshot (saved ranks: "
            f"{sorted(seen_ranks)}). Pass the rank whose state you want to "
            "materialize; sharded and replicated entries are identical "
            "from every saved rank's view."
        )
    if world_size is not None and seen_ranks != set(range(world_size)):
        # Else a snapshot that lost every entry of a trailing rank would
        # load with sharded tensors cut to the surviving shards' box.
        raise ValueError(
            f"Snapshot metadata says world_size={world_size} but entries "
            f"exist only for ranks {sorted(seen_ranks)}: the snapshot is "
            "incomplete (a rank's manifest entries were lost)."
        )
    for logical, shards in sharded.items():
        merged[logical]["shards"] = shards
    return merged


def load_torchsnapshot(path: str, rank: int = 0, convert_tensors: bool = True) -> Dict[str, Any]:
    """Read a reference-format snapshot into nested Python state.

    Returns ``{app_state_key: state}``, tensors as CPU torch tensors of
    their stored dtype. ``rank`` selects which rank's per-rank entries to
    materialize; replicated entries and merged sharded tensors are visible
    to every rank. ``convert_tensors`` is the JAX package's flag, which
    turns tensors inside objects into numpy arrays there; here tensors are
    the native form and stay as they are.

    .. warning:: ``object`` entries are arbitrary pickles, unpickled with
       ``torch.load(weights_only=False)`` as the reference's own restore
       does: load only snapshots from sources you trust.
    """
    del convert_tensors
    meta = read_metadata(path)
    view = _merge_for_rank(meta["manifest"], rank, meta.get("world_size"))

    # The reference escapes only '%' and '/'; the native flattener escapes
    # every URL-special byte. Re-normalize each token so the native inflate
    # rebuilds the containers.
    from ..flatten import _escape_key, inflate
    from ..manifest import DictEntry, ListEntry, OrderedDictEntry

    def normalize(logical: str) -> str:
        return "/".join(_escape_key(unquote(t)) for t in logical.split("/"))

    leaves: Dict[str, Any] = {}
    containers: Dict[str, Any] = {}
    root_keys: List[str] = []
    for logical, entry in view.items():
        typ = entry["type"]
        norm = normalize(logical)
        if "/" not in logical:
            key = unquote(logical)
            if key not in root_keys:
                root_keys.append(key)
        if typ == "dict":
            containers[norm] = DictEntry(keys=list(entry.get("keys") or []))
        elif typ == "OrderedDict":
            containers[norm] = OrderedDictEntry(keys=list(entry.get("keys") or []))
        elif typ == "list":
            containers[norm] = ListEntry()
        elif typ == "Tensor":
            leaves[norm] = _decode_tensor(path, entry)
        elif typ == "ChunkedTensor":
            leaves[norm] = _decode_chunked(path, entry)
        elif typ == "ShardedTensor":
            leaves[norm] = _decode_sharded(path, entry["shards"])
        elif typ == "object":
            leaves[norm] = _decode_object(path, entry)
        else:
            leaves[norm] = _decode_primitive(entry)

    containers[""] = DictEntry(keys=root_keys)
    return inflate(containers, leaves, prefix="")


# torch dtype -> the reference's name for it: the first name of the table.
_DTYPE_NAMES: Dict[torch.dtype, str] = {}
for _name, _dtype in _TORCH_DTYPES.items():
    _DTYPE_NAMES.setdefault(_dtype, _name)
# The reference predates fp8, so fp8 exports are written via torch_save:
# load_torchsnapshot round-trips them, but the reference refuses the dtype.
_REFERENCE_BUFFER_PROTOCOL_UNSUPPORTED = frozenset(n for n in _DTYPE_NAMES.values()
                                                   if "float8" in n)


def _export_primitive(value: Any) -> Optional[Dict[str, Any]]:
    if isinstance(value, bool):  # before int: bool is an int subclass
        return {"type": "bool", "serialized_value": str(value)}
    if isinstance(value, int):
        return {"type": "int", "serialized_value": str(value)}
    if isinstance(value, float):
        return {"type": "float",
                "serialized_value": base64.b64encode(struct.pack("<d", value)).decode()}
    if isinstance(value, str):
        return {"type": "str", "serialized_value": value}
    if isinstance(value, bytes):
        return {"type": "bytes", "serialized_value": base64.b64encode(value).decode()}
    return None


def _escape_ref_key(key: str) -> str:
    # The reference escapes only '%' then '/'.
    return key.replace("%", "%25").replace("/", "%2F")


def _as_cpu_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(value))


def save_as_torchsnapshot(state: Dict[str, Any], path: str) -> None:
    """Write ``state`` in the reference's on-disk format (world size 1).

    The inverse of :func:`load_torchsnapshot`: the directory is a snapshot
    the reference library restores. ``state`` maps app-state keys to nested
    dict/OrderedDict/list structures of tensors (CPU or CUDA; bf16 exports
    as buffer-protocol bytes as the reference writes it, fp8 via
    torch_save), numpy arrays, Python primitives and picklable objects
    (``torch.save``-serialized). Payloads are written as the state is
    walked, so peak memory is one payload.
    """
    import yaml

    manifest: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    used_locations: set = set()

    def claim_location(preferred: str) -> str:
        # Sibling entries can alias (tensor 'w' at '0/w_0' and object 'w_0'
        # at '0/w_0'); a written payload is never overwritten.
        location = preferred
        n = 0
        while location in used_locations:
            n += 1
            location = f"{preferred}~{n}"
        used_locations.add(location)
        return location

    def open_payload(location: str):
        full = os.path.join(path, location)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        return open(full, "wb")

    def visit(logical: str, value: Any) -> None:
        if isinstance(value, OrderedDict):
            manifest[logical] = {"type": "OrderedDict", "keys": list(value.keys())}
            for k, v in value.items():
                visit(f"{logical}/{_escape_ref_key(str(k))}", v)
            return
        if isinstance(value, dict):
            manifest[logical] = {"type": "dict", "keys": list(value.keys())}
            for k, v in value.items():
                visit(f"{logical}/{_escape_ref_key(str(k))}", v)
            return
        if isinstance(value, list):
            manifest[logical] = {"type": "list"}
            for i, v in enumerate(value):
                visit(f"{logical}/{i}", v)
            return
        prim = _export_primitive(value)
        if prim is not None:
            manifest[logical] = {**prim, "readable": None, "replicated": False}
            return
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            t = _as_cpu_tensor(value)
            name = _DTYPE_NAMES.get(t.dtype)
            shape = list(t.shape)
            if name is not None and name not in _REFERENCE_BUFFER_PROTOCOL_UNSUPPORTED:
                location = claim_location(f"{logical}_" + "_".join("0" for _ in shape or [0]))
                with open_payload(location) as f:
                    f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
                # A fresh list at each place: PyYAML writes a shared one
                # as an anchor and aliases.
                tensor_entry = {
                    "type": "Tensor",
                    "location": location,
                    "serializer": "buffer_protocol",
                    "dtype": name,
                    "shape": list(shape),
                    "replicated": False,
                    "byte_range": None,
                }
                # The reference's non-sharded layout: one ChunkedTensor
                # entry holding a single whole-tensor chunk.
                manifest[logical] = {
                    "type": "ChunkedTensor",
                    "dtype": name,
                    "shape": list(shape),
                    "chunks": [{"offsets": [0] * len(shape), "sizes": list(shape),
                                "tensor": tensor_entry}],
                    "replicated": False,
                }
                return
            # fp8 and dtypes outside the table: a torch_save tensor payload.
            location = claim_location(logical)
            with open_payload(location) as f:
                torch.save(t.clone(), f)
            manifest[logical] = {
                "type": "Tensor",
                "location": location,
                "serializer": "torch_save",
                "dtype": name or str(t.dtype).replace("torch.", ""),
                "shape": shape,
                "replicated": False,
                "byte_range": None,
            }
            return
        location = claim_location(logical)
        with open_payload(location) as f:
            torch.save(value, f)
        manifest[logical] = {
            "type": "object",
            "location": location,
            "serializer": "torch_save",
            "obj_type": f"{type(value).__module__}.{type(value).__qualname__}",
            "replicated": False,
        }

    os.makedirs(path, exist_ok=True)
    for app_key in state:
        visit(f"0/{_escape_ref_key(str(app_key))}", state[app_key])

    # Metadata last: a partly exported directory is never taken for a
    # complete snapshot (the reference's own commit-point rule).
    meta = {"version": "0.0.3", "world_size": 1, "manifest": dict(manifest)}
    with open(os.path.join(path, SNAPSHOT_METADATA_FILENAME), "w") as f:
        yaml.safe_dump(meta, f, sort_keys=False)


def migrate_to_torchsnapshot(src_path: str, dst_path: str, rank: int = 0) -> None:
    """Convert a native snapshot into the reference's on-disk format: read
    ``src_path`` with ``Snapshot.read_state_dict`` and write it with
    :func:`save_as_torchsnapshot`."""
    from .. import Snapshot

    save_as_torchsnapshot(Snapshot(src_path).read_state_dict(rank=rank), dst_path)


def migrate_from_torchsnapshot(src_path: str, dst_path: str,
                               rank: int = 0) -> Tuple[Any, Dict[str, Any]]:
    """Convert a reference-format snapshot into a native snapshot at
    ``dst_path`` with the same app-state keys. Returns ``(Snapshot,
    state)``."""
    from .. import Snapshot, StateDict

    state = load_torchsnapshot(src_path, rank=rank)
    app_state = {
        # StateDict(mapping), not StateDict(**mapping): loaded dicts may
        # have non-string (int) top-level keys.
        key: StateDict(val) if isinstance(val, dict) else StateDict(value=val)
        for key, val in state.items()
    }
    return Snapshot.take(dst_path, app_state), state
