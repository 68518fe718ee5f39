"""Snapshot manifest: entry types, the metadata file, elasticity rules.

The port's own copy of ``torchsnapshot_tpu/manifest.py``. The manifest is
the on-disk contract between the two packages, so every entry type, field
order and serialization rule is identical: a snapshot written by either
package parses in the other, and ``tests/data/golden_manifest.{json,yaml}``
round-trip byte-exact through both.

``SnapshotMetadata`` is written as compact JSON (valid YAML) to
``.snapshot_metadata``, last: it is the commit point of a snapshot.
Sharded entries are parsed and emitted for compatibility; this slice of the
port writes none.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, TypeVar


class CorruptSnapshotError(RuntimeError):
    """``.snapshot_metadata`` exists but cannot be decoded.

    Before this exception, a torn or zero-byte metadata file surfaced as
    whatever the decoder tripped over first — ``JSONDecodeError``,
    ``yaml.YAMLError``, ``KeyError: 'manifest'``, ``UnicodeDecodeError``
    — none of which tell an operator the one thing that matters: the
    snapshot should be treated as UNCOMMITTED. The commit protocol makes
    this state near-impossible for the library's own writers (temp-file +
    atomic rename), so a corrupt metadata file means out-of-band damage:
    a non-atomic copy (``cp``/``rsync`` mid-write), storage-layer
    truncation, or a foreign writer.
    """

    def __init__(self, path: str, detail: str) -> None:
        super().__init__(
            f"Snapshot metadata at {path!r} is unreadable ({detail}). This "
            "usually means a torn or partial commit reached the metadata "
            "file through an out-of-band channel (non-atomic copy, storage "
            "truncation) — the library's own commit is atomic. Treat the "
            "snapshot as uncommitted and restore from the previous "
            "committed snapshot."
        )
        self.path = path
        self.detail = detail


@dataclass
class Entry:
    type: str


@dataclass
class ArrayEntry(Entry):
    location: str
    serializer: str
    dtype: str
    shape: List[int]
    replicated: bool
    byte_range: Optional[List[int]] = None  # [lo, hi) within location
    checksum: Optional[str] = None  # "<algo>:<hexdigest>" of the payload
    # Incremental snapshots (dedup.py): content digest recorded at stage
    # time, and — for payloads reused from a base snapshot — the URL of the
    # snapshot that physically holds the bytes. Omitted from the YAML when
    # unset so non-incremental snapshots keep their on-disk format.
    digest: Optional[str] = None  # "sha256:<hexdigest>" of the payload
    origin: Optional[str] = None  # base snapshot URL holding the payload
    # Payload compression (compression.py): canonical codec spec of the
    # STORED bytes ("zstd:3"); checksum covers the stored bytes, digest
    # the uncompressed ones. Omitted from YAML when unset.
    codec: Optional[str] = None
    # Device-resident fingerprint (device_digest.py, "xxh4x32:<hex>"):
    # lets a future incremental take detect the payload unchanged WITHOUT
    # a DtoH transfer. Omitted when unset.
    device_digest: Optional[str] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: List[int],
        replicated: bool,
        byte_range: Optional[List[int]] = None,
        checksum: Optional[str] = None,
        digest: Optional[str] = None,
        origin: Optional[str] = None,
        codec: Optional[str] = None,
        device_digest: Optional[str] = None,
    ) -> None:
        super().__init__(type="array")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = list(shape)
        self.replicated = replicated
        self.byte_range = list(byte_range) if byte_range is not None else None
        self.checksum = checksum
        self.digest = digest
        self.origin = origin
        self.codec = codec
        self.device_digest = device_digest


@dataclass
class Shard:
    offsets: List[int]
    sizes: List[int]
    array: ArrayEntry


@dataclass
class ShardedArrayEntry(Entry):
    dtype: str
    shape: List[int]
    shards: List[Shard]

    def __init__(self, dtype: str, shape: List[int], shards: List[Shard]) -> None:
        super().__init__(type="sharded_array")
        self.dtype = dtype
        self.shape = list(shape)
        self.shards = shards


@dataclass
class ChunkedArrayEntry(Entry):
    dtype: str
    shape: List[int]
    chunks: List[Shard]
    replicated: bool

    def __init__(
        self, dtype: str, shape: List[int], chunks: List[Shard], replicated: bool
    ) -> None:
        super().__init__(type="chunked_array")
        self.dtype = dtype
        self.shape = list(shape)
        self.chunks = chunks
        self.replicated = replicated


@dataclass
class ObjectEntry(Entry):
    location: str
    serializer: str
    obj_type: str
    replicated: bool
    checksum: Optional[str] = None  # "<algo>:<hexdigest>" of the payload
    size: Optional[int] = None  # serialized bytes, recorded at stage time
    digest: Optional[str] = None  # "sha256:<hexdigest>" (see ArrayEntry)
    origin: Optional[str] = None  # base snapshot URL holding the payload
    codec: Optional[str] = None  # compression of the stored bytes

    def __init__(
        self,
        location: str,
        serializer: str,
        obj_type: str,
        replicated: bool,
        checksum: Optional[str] = None,
        size: Optional[int] = None,
        digest: Optional[str] = None,
        origin: Optional[str] = None,
        codec: Optional[str] = None,
    ) -> None:
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.obj_type = obj_type
        self.replicated = replicated
        self.checksum = checksum
        self.size = size
        self.digest = digest
        self.origin = origin
        self.codec = codec


_PRIMITIVE_TYPES = ("int", "float", "str", "bool", "bytes", "NoneType")


@dataclass
class PrimitiveEntry(Entry):
    """A primitive value inlined into the metadata — zero storage I/O.

    Floats are stored as both a human-readable repr and big-endian IEEE-754
    hex so restore is bit-exact (the reference used base64+struct,
    manifest.py:146-242); bytes are base64.
    """

    ptype: str
    readable: str
    replicated: bool

    def __init__(self, ptype: str, readable: str, replicated: bool) -> None:
        super().__init__(type="primitive")
        self.ptype = ptype
        self.readable = readable
        self.replicated = replicated

    @classmethod
    def supported_types(cls) -> Tuple[str, ...]:
        return _PRIMITIVE_TYPES

    @classmethod
    def from_object(cls, obj: Any, replicated: bool = False) -> "PrimitiveEntry":
        tname = type(obj).__name__
        if tname == "bool":  # before int: bool is a subclass of int
            return cls("bool", str(obj), replicated)
        elif tname == "int":
            return cls("int", str(obj), replicated)
        elif tname == "float":
            return cls("float", struct.pack(">d", obj).hex(), replicated)
        elif tname == "str":
            return cls("str", obj, replicated)
        elif tname == "bytes":
            return cls("bytes", base64.b64encode(obj).decode("ascii"), replicated)
        elif tname == "NoneType":
            return cls("NoneType", "", replicated)
        raise TypeError(f"Unsupported primitive type: {tname}")

    def get_value(self) -> Any:
        if self.ptype == "bool":
            return self.readable == "True"
        elif self.ptype == "int":
            return int(self.readable)
        elif self.ptype == "float":
            return struct.unpack(">d", bytes.fromhex(self.readable))[0]
        elif self.ptype == "str":
            return self.readable
        elif self.ptype == "bytes":
            return base64.b64decode(self.readable)
        elif self.ptype == "NoneType":
            return None
        raise TypeError(f"Unsupported primitive type: {self.ptype}")


@dataclass
class ListEntry(Entry):
    def __init__(self) -> None:
        super().__init__(type="list")


@dataclass
class TupleEntry(Entry):
    def __init__(self) -> None:
        super().__init__(type="tuple")


@dataclass
class NamedTupleEntry(Entry):
    module: str
    qualname: str
    fields: List[str]

    def __init__(self, module: str, qualname: str, fields: List[str]) -> None:
        super().__init__(type="namedtuple")
        self.module = module
        self.qualname = qualname
        self.fields = list(fields)


@dataclass
class DictEntry(Entry):
    keys: List[Any]  # original key objects (str | int); order matters

    def __init__(self, keys: List[Any]) -> None:
        super().__init__(type="dict")
        self.keys = list(keys)


@dataclass
class OrderedDictEntry(Entry):
    keys: List[Any]

    def __init__(self, keys: List[Any]) -> None:
        super().__init__(type="ordered_dict")
        self.keys = list(keys)


T = TypeVar("T", bound=Entry)
Manifest = Dict[str, T]

_CONTAINER_TYPES = (
    ListEntry,
    TupleEntry,
    NamedTupleEntry,
    DictEntry,
    OrderedDictEntry,
)


def is_container_entry(entry: Entry) -> bool:
    return isinstance(entry, _CONTAINER_TYPES)


def is_replicated(entry: Entry) -> bool:
    return (
        isinstance(entry, (ArrayEntry, ObjectEntry, ChunkedArrayEntry, PrimitiveEntry))
        and entry.replicated
    )


def _array_entry_from_dict(d: Dict[str, Any]) -> ArrayEntry:
    # Direct construction bypassing __init__'s defensive list() copies:
    # the dict comes from our own json.loads, whose lists are already
    # fresh. At 50k shard leaves the kwargs/copy path was most of the
    # manifest parse time.
    e = ArrayEntry.__new__(ArrayEntry)
    e.type = "array"
    e.location = d["location"]
    e.serializer = d["serializer"]
    e.dtype = d["dtype"]
    e.shape = d["shape"]
    e.replicated = d["replicated"]
    e.byte_range = d.get("byte_range")
    e.checksum = d.get("checksum")
    e.digest = d.get("digest")
    e.origin = d.get("origin")
    e.codec = d.get("codec")
    e.device_digest = d.get("device_digest")
    return e


def _shard_from_dict(d: Dict[str, Any]) -> Shard:
    return Shard(
        offsets=d["offsets"],
        sizes=d["sizes"],
        array=_array_entry_from_dict(d["array"]),
    )


def entry_from_dict(d: Dict[str, Any]) -> Entry:
    type_name = d["type"]
    if type_name == "array":
        return _array_entry_from_dict(d)
    d = dict(d)
    d.pop("type")
    if type_name == "sharded_array":
        return ShardedArrayEntry(
            dtype=d["dtype"],
            shape=d["shape"],
            shards=[_shard_from_dict(s) for s in d["shards"]],
        )
    elif type_name == "chunked_array":
        return ChunkedArrayEntry(
            dtype=d["dtype"],
            shape=d["shape"],
            chunks=[_shard_from_dict(c) for c in d["chunks"]],
            replicated=d["replicated"],
        )
    elif type_name == "object":
        return ObjectEntry(**d)
    elif type_name == "primitive":
        return PrimitiveEntry(**d)
    elif type_name == "list":
        return ListEntry()
    elif type_name == "tuple":
        return TupleEntry()
    elif type_name == "namedtuple":
        return NamedTupleEntry(**d)
    elif type_name == "dict":
        return DictEntry(**d)
    elif type_name == "ordered_dict":
        return OrderedDictEntry(**d)
    raise ValueError(f"Unknown manifest entry type: {type_name!r}")


_STRIPPED_WHEN_NONE = ("digest", "origin", "codec", "device_digest")
_FIELD_NAME_CACHE: Dict[type, List[str]] = {}


def _array_entry_to_dict(e: "ArrayEntry") -> Dict[str, Any]:
    # Field-declaration order — the serialization contract.
    out: Dict[str, Any] = {
        "type": e.type,
        "location": e.location,
        "serializer": e.serializer,
        "dtype": e.dtype,
        "shape": e.shape,
        "replicated": e.replicated,
        "byte_range": e.byte_range,
        "checksum": e.checksum,
    }
    if e.digest is not None:
        out["digest"] = e.digest
    if e.origin is not None:
        out["origin"] = e.origin
    if e.codec is not None:
        out["codec"] = e.codec
    if e.device_digest is not None:
        out["device_digest"] = e.device_digest
    return out


def _shard_to_dict(s: "Shard") -> Dict[str, Any]:
    return {
        "offsets": s.offsets,
        "sizes": s.sizes,
        "array": _array_entry_to_dict(s.array),
    }


def _entry_to_dict(obj: Any) -> Any:
    """Shallow dataclass→dict conversion in field-declaration order (the
    serialization contract asdict established), dropping the
    incremental/compression fields while None.

    The shard-carrying entry types get direct, loop-free builders: a
    70B-GSPMD manifest is ~50k Shard/ArrayEntry leaves, and the generic
    per-field walk's dispatch overhead (~16 ns × millions of leaf values)
    dominated emit time."""
    from dataclasses import fields, is_dataclass

    cls = type(obj)
    if cls is ArrayEntry:
        return _array_entry_to_dict(obj)
    if cls is ShardedArrayEntry:
        return {
            "type": obj.type,
            "dtype": obj.dtype,
            "shape": obj.shape,
            "shards": [_shard_to_dict(s) for s in obj.shards],
        }
    if cls is ChunkedArrayEntry:
        return {
            "type": obj.type,
            "dtype": obj.dtype,
            "shape": obj.shape,
            "chunks": [_shard_to_dict(s) for s in obj.chunks],
            "replicated": obj.replicated,
        }
    if is_dataclass(obj) and not isinstance(obj, type):
        names = _FIELD_NAME_CACHE.get(cls)
        if names is None:
            names = [f.name for f in fields(cls)]
            _FIELD_NAME_CACHE[cls] = names
        out: Dict[str, Any] = {}
        for name in names:
            value = getattr(obj, name)
            if value is None and name in _STRIPPED_WHEN_NONE:
                continue
            out[name] = _entry_to_dict(value)
        return out
    if isinstance(obj, list):
        return [_entry_to_dict(v) for v in obj]
    return obj


@dataclass
class SnapshotMetadata:
    version: str
    world_size: int
    manifest: Manifest
    # Two-tier + incremental composition (omitted from YAML when unset):
    # the mirror this snapshot replicated to, and — for incremental
    # snapshots — each origin snapshot's mirror, so deduplicated payloads
    # stay restorable from the durable tier after the origin's primary is
    # lost (the JAX package's storage_plugins/mirror.py).
    mirror_url: Optional[str] = None
    origin_mirrors: Optional[Dict[str, str]] = None
    # The SOURCE partition-rule layout this snapshot was taken under
    # (layout.LayoutSpec.to_dict() — mesh axes + regex rules + dtype
    # policies), when the caller declared one via Snapshot.take(...,
    # layout=...). Purely descriptive metadata: restores never require
    # it (the destination arrays' real shardings are authoritative).
    # Omitted from YAML when unset.
    layout: Optional[Dict[str, Any]] = None

    def to_yaml(self) -> str:
        """Serialize to the on-disk metadata format.

        Since round 4 this emits compact JSON — which is valid YAML, so
        builds that parse ``.snapshot_metadata`` with a YAML loader keep
        reading new snapshots. The switch is a scalability fix: a
        70B-scale GSPMD manifest is ~50k shard entries / ~18 MB, which
        libyaml emits in ~10 s and parses in ~15 s, vs ~0.3 s for JSON
        (pinned by tests/test_manifest_golden.py, with a legacy YAML
        fixture covering pre-round-4 snapshots).
        """
        # Hand-rolled conversion instead of dataclasses.asdict: asdict
        # deep-copies every leaf (~0.7 s of a 50k-shard manifest's 1.0 s
        # emit) where serialization only needs a shallow walk. Field
        # order matches asdict (declaration order, type first) — pinned
        # byte-exact by tests/test_manifest_golden.py. Optional fields
        # (digest/origin/codec) are omitted while unset so snapshots not
        # using them keep their on-disk format; absent keys read back as
        # None.
        d: Dict[str, Any] = {
            "version": self.version,
            "world_size": self.world_size,
            "manifest": {
                path: _entry_to_dict(entry)
                for path, entry in self.manifest.items()
            },
        }
        if self.mirror_url:
            d["mirror_url"] = self.mirror_url
        if self.origin_mirrors:
            d["origin_mirrors"] = self.origin_mirrors
        if self.layout:
            d["layout"] = self.layout
        # allow_nan=False: a non-finite float would silently emit
        # JSON-invalid tokens; no entry field legitimately carries one
        # (primitives serialize through reprs).
        return json.dumps(d, separators=(",", ":"), allow_nan=False) + "\n"

    @classmethod
    def from_yaml(cls, yaml_str: str) -> "SnapshotMetadata":
        """Parse metadata: JSON fast path, YAML fallback for snapshots
        written before the round-4 format switch."""
        try:
            d = json.loads(yaml_str)
        except json.JSONDecodeError:
            # Only snapshots written before the JSON switch need a YAML
            # parser, so PyYAML is imported on that path alone.
            import yaml

            loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
            d = yaml.load(yaml_str, Loader=loader)
        manifest: Manifest = {
            path: entry_from_dict(entry) for path, entry in d["manifest"].items()
        }
        return cls(
            version=d["version"],
            world_size=d["world_size"],
            manifest=manifest,
            mirror_url=d.get("mirror_url"),
            origin_mirrors=d.get("origin_mirrors"),
            layout=d.get("layout"),
        )


def get_available_entries(manifest: Manifest, rank: int) -> Manifest:
    """Local view of a global manifest for ``rank`` under the elasticity rules.

    - per-rank entries: available only to the rank that saved them;
    - replicated entries: available to all ranks (including ranks beyond the
      saving world size);
    - sharded entries: shards merged across all ranks, available to all;
    - container entries are structural only and excluded.

    Mirrors reference behavior (manifest.py:324-382) including the rule that a
    rank that saved its own copy of a replicated entry reads its own copy.
    """
    grouped: Dict[str, Dict[int, Entry]] = {}
    for path, entry in manifest.items():
        entry_rank_str, _, local_path = path.partition("/")
        grouped.setdefault(local_path, {})[int(entry_rank_str)] = entry

    local_manifest: Manifest = {}
    for local_path, group in grouped.items():
        entries = list(group.values())
        first = entries[0]
        if isinstance(first, ShardedArrayEntry):
            merged: List[Shard] = [s for e in entries for s in e.shards]
            local_manifest[local_path] = ShardedArrayEntry(
                dtype=first.dtype, shape=first.shape, shards=merged
            )
        elif isinstance(
            first, (ArrayEntry, ObjectEntry, ChunkedArrayEntry, PrimitiveEntry)
        ):
            if rank in group:
                local_manifest[local_path] = group[rank]
            elif first.replicated:
                local_manifest[local_path] = first
        elif is_container_entry(first):
            pass
        else:
            raise RuntimeError(
                f"Unknown entry type: {type(first).__name__} ({first.type})."
            )
    return local_manifest


def get_manifest_for_rank(metadata: SnapshotMetadata, rank: int) -> Manifest:
    """Rank-local manifest including container entries (used by inflate).

    For ranks beyond the saving world size, rank 0's container structure is
    used — valid because such ranks may only load replicated/sharded entries,
    whose structure is identical across ranks.
    """
    container_rank = rank if rank < metadata.world_size else 0
    available = get_available_entries(metadata.manifest, rank)
    prefix = f"{container_rank}/"
    for path, entry in metadata.manifest.items():
        if not is_container_entry(entry):
            continue
        if path.startswith(prefix):
            available[path[len(prefix):]] = entry
        elif path == str(container_rank):  # the rank-root container
            available[""] = entry
    return available
