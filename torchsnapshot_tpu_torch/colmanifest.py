"""Columnar snapshot-metadata codec (``TSCM``) and manifest diffs (``TSCD``).

Counterpart of ``torchsnapshot_tpu/colmanifest.py``, over the port's
``manifest.py`` classes. The format is the JAX package's, byte for byte:
the same metadata encodes to the same bytes in both packages, and each
decodes the other's.

The JSON metadata is per-leaf dict churn on both sides of the codec; at
million-leaf manifests that sits on the commit and the restore. TSCM is a
struct of arrays instead:

- one flat typed column per ``ArrayEntry`` field across all leaves
  (locations as a NUL-joined blob, serializer, dtype and codec as u8 ids
  into header tables, shapes, offsets and sizes as ragged i64 arrays with
  u8 arity prefixes, nullable fields behind a per-leaf presence byte);
- the entry structure as parallel columns (paths, type tags, per-entry
  shard counts), so decoding is a cursor walk over preparsed arrays;
- the few non-array entries (objects, primitives, containers) in a JSON
  side list in entry order;
- every section zlib-framed at level 1.

JSON stays the default writer; ``TORCHSNAPSHOT_GPU_MANIFEST_FORMAT=columnar``
switches the commit to TSCM, and the reader sniffs the magic, so both
formats restore. ``encode_manifest_diff``/``apply_manifest_diff`` carry
the removed paths and the added or changed entries between two steps as
an embedded TSCM sub-manifest, applied in time proportional to the change.

The columns are packed with numpy (``_i64``, ``_u32``): numpy is the
port's dependency too, and its little-endian byte layout is the format's.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np

from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Shard,
    ShardedArrayEntry,
    SnapshotMetadata,
    _entry_to_dict,
    entry_from_dict,
)

MAGIC = b"TSCM\x01"
DIFF_MAGIC = b"TSCD\x01"

# Entry type tags (the ``etype`` column).
_T_ARRAY, _T_SHARDED, _T_CHUNKED, _T_OTHER = 0, 1, 2, 3

# Presence bits (the per-leaf ``flags`` column).
_F_BYTE_RANGE = 1
_F_CHECKSUM = 2
_F_DIGEST = 4
_F_ORIGIN = 8
_F_CODEC = 16
_F_DEVICE_DIGEST = 32

_ZLEVEL = 1

# Section order is part of the format (v1). Adding a section appends to
# this list under a bumped magic version.
_SECTIONS = (
    "paths", "etype", "ent_dtype", "ent_shape_nd", "ent_shape", "ent_nsub",
    "ent_repl", "loc", "ser", "dt", "shape_nd", "shape", "repl", "flags",
    "br_nd", "br", "checksum", "digest", "origin", "codec", "devdig",
    "sub_nd", "sub_off", "sub_size", "others",
)


def _pack_section(data: bytes) -> bytes:
    comp = zlib.compress(data, _ZLEVEL)
    return struct.pack("<I", len(comp)) + comp


def _join(strings: List[str]) -> bytes:
    return "\x00".join(strings).encode("utf-8")


def _split(blob: bytes, n: int) -> List[str]:
    if n == 0:
        return []
    return blob.decode("utf-8").split("\x00")


def _i64(values: List[int]) -> bytes:
    return np.asarray(values, dtype=np.int64).tobytes()


def _u8(values: List[int]) -> bytes:
    return bytes(bytearray(values))


def _u32(values: List[int]) -> bytes:
    return np.asarray(values, dtype=np.uint32).tobytes()


class _Interner:
    """String → dense id table (serializers, dtypes, codecs, origins)."""

    def __init__(self) -> None:
        self.ids: Dict[str, int] = {}
        self.strings: List[str] = []

    def id(self, s: str) -> int:
        i = self.ids.get(s)
        if i is None:
            i = len(self.strings)
            self.ids[s] = i
            self.strings.append(s)
        return i


def encode_metadata(md: SnapshotMetadata) -> bytes:
    """Serialize ``md`` to the TSCM v1 binary columnar format."""
    sers, dts, codecs, origins = (
        _Interner(), _Interner(), _Interner(), _Interner()
    )
    paths: List[str] = []
    etype: List[int] = []
    ent_dtype: List[int] = []
    ent_shape_nd: List[int] = []
    ent_shape: List[int] = []
    ent_nsub: List[int] = []
    ent_repl: List[int] = []
    others: List[Dict[str, Any]] = []

    locs: List[str] = []
    ser_ids: List[int] = []
    dt_ids: List[int] = []
    shape_nd: List[int] = []
    shape_vals: List[int] = []
    repl: List[int] = []
    flags: List[int] = []
    br_nd: List[int] = []
    br_vals: List[int] = []
    checksums: List[str] = []
    digests: List[str] = []
    origin_ids: List[int] = []
    codec_ids: List[int] = []
    devdigs: List[str] = []
    sub_nd: List[int] = []
    sub_off: List[int] = []
    sub_size: List[int] = []

    def leaf(a: ArrayEntry) -> None:
        locs.append(a.location)
        ser_ids.append(sers.id(a.serializer))
        dt_ids.append(dts.id(a.dtype))
        shape_nd.append(len(a.shape))
        shape_vals.extend(a.shape)
        repl.append(1 if a.replicated else 0)
        f = 0
        if a.byte_range is not None:
            f |= _F_BYTE_RANGE
            br_nd.append(len(a.byte_range))
            br_vals.extend(a.byte_range)
        if a.checksum is not None:
            f |= _F_CHECKSUM
            checksums.append(a.checksum)
        if a.digest is not None:
            f |= _F_DIGEST
            digests.append(a.digest)
        if a.origin is not None:
            f |= _F_ORIGIN
            origin_ids.append(origins.id(a.origin))
        if a.codec is not None:
            f |= _F_CODEC
            codec_ids.append(codecs.id(a.codec))
        if a.device_digest is not None:
            f |= _F_DEVICE_DIGEST
            devdigs.append(a.device_digest)
        flags.append(f)

    def sub(s: Shard) -> None:
        leaf(s.array)
        sub_nd.append(len(s.offsets))
        sub_off.extend(s.offsets)
        sub_size.extend(s.sizes)

    for path, entry in md.manifest.items():
        paths.append(path)
        cls = type(entry)
        if cls is ArrayEntry:
            etype.append(_T_ARRAY)
            leaf(entry)
        elif cls is ShardedArrayEntry:
            etype.append(_T_SHARDED)
            ent_dtype.append(dts.id(entry.dtype))
            ent_shape_nd.append(len(entry.shape))
            ent_shape.extend(entry.shape)
            ent_nsub.append(len(entry.shards))
            ent_repl.append(0)
            for s in entry.shards:
                sub(s)
        elif cls is ChunkedArrayEntry:
            etype.append(_T_CHUNKED)
            ent_dtype.append(dts.id(entry.dtype))
            ent_shape_nd.append(len(entry.shape))
            ent_shape.extend(entry.shape)
            ent_nsub.append(len(entry.chunks))
            ent_repl.append(1 if entry.replicated else 0)
            for s in entry.chunks:
                sub(s)
        else:
            etype.append(_T_OTHER)
            others.append(_entry_to_dict(entry))

    header: Dict[str, Any] = {
        "version": md.version,
        "world_size": md.world_size,
        "n_entries": len(paths),
        "n_leaves": len(locs),
        "serializers": sers.strings,
        "dtypes": dts.strings,
        "codecs": codecs.strings,
        "origins": origins.strings,
    }
    if md.mirror_url:
        header["mirror_url"] = md.mirror_url
    if md.origin_mirrors:
        header["origin_mirrors"] = md.origin_mirrors
    if md.layout:
        header["layout"] = md.layout

    sections: Dict[str, bytes] = {
        "paths": _join(paths),
        "etype": _u8(etype),
        "ent_dtype": _u8(ent_dtype),
        "ent_shape_nd": _u8(ent_shape_nd),
        "ent_shape": _i64(ent_shape),
        "ent_nsub": _u32(ent_nsub),
        "ent_repl": _u8(ent_repl),
        "loc": _join(locs),
        "ser": _u8(ser_ids),
        "dt": _u8(dt_ids),
        "shape_nd": _u8(shape_nd),
        "shape": _i64(shape_vals),
        "repl": _u8(repl),
        "flags": _u8(flags),
        "br_nd": _u8(br_nd),
        "br": _i64(br_vals),
        "checksum": _join(checksums),
        "digest": _join(digests),
        "origin": _u32(origin_ids),
        "codec": _u8(codec_ids),
        "devdig": _join(devdigs),
        "sub_nd": _u8(sub_nd),
        "sub_off": _i64(sub_off),
        "sub_size": _i64(sub_size),
        "others": json.dumps(
            others, separators=(",", ":"), allow_nan=False
        ).encode("utf-8"),
    }
    out = [MAGIC, _pack_section(
        json.dumps(header, separators=(",", ":"), allow_nan=False).encode(
            "utf-8"
        )
    )]
    for name in _SECTIONS:
        out.append(_pack_section(sections[name]))
    return b"".join(out)


def _read_sections(raw: bytes, magic: bytes) -> Tuple[Dict[str, Any], Dict[str, bytes]]:
    if raw[: len(magic)] != magic:
        raise ValueError(f"bad magic {raw[:5]!r}")
    pos = len(magic)

    def take() -> bytes:
        nonlocal pos
        (clen,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        data = zlib.decompress(raw[pos:pos + clen])
        pos += clen
        return data

    header = json.loads(take().decode("utf-8"))
    sections = {name: take() for name in _SECTIONS}
    return header, sections


def decode_metadata(raw: bytes) -> SnapshotMetadata:
    """Parse a TSCM v1 blob back into a :class:`SnapshotMetadata`.

    The hot path is a cursor walk over preparsed flat arrays with
    ``ArrayEntry.__new__`` construction (the same fast path the JSON
    reader uses) — no per-leaf dict materialization.
    """
    header, sec = _read_sections(raw, MAGIC)
    n_entries = header["n_entries"]
    n_leaves = header["n_leaves"]
    sers: List[str] = header["serializers"]
    dts: List[str] = header["dtypes"]
    codecs: List[str] = header["codecs"]
    origins: List[str] = header["origins"]

    paths = _split(sec["paths"], n_entries)
    etype = sec["etype"]
    ent_dtype = sec["ent_dtype"]
    ent_shape_nd = sec["ent_shape_nd"]
    ent_shape = np.frombuffer(sec["ent_shape"], dtype=np.int64).tolist()
    ent_nsub = np.frombuffer(sec["ent_nsub"], dtype=np.uint32).tolist()
    ent_repl = sec["ent_repl"]

    locs = _split(sec["loc"], n_leaves)
    ser_ids = sec["ser"]
    dt_ids = sec["dt"]
    shape_nd = sec["shape_nd"]
    shape_vals = np.frombuffer(sec["shape"], dtype=np.int64).tolist()
    repl = sec["repl"]
    flags = sec["flags"]
    br_nd = sec["br_nd"]
    br_vals = np.frombuffer(sec["br"], dtype=np.int64).tolist()
    checksums = _split(sec["checksum"], len(sec["checksum"]))
    digests = _split(sec["digest"], len(sec["digest"]))
    origin_ids = np.frombuffer(sec["origin"], dtype=np.uint32).tolist()
    codec_ids = sec["codec"]
    devdigs = _split(sec["devdig"], len(sec["devdig"]))
    sub_nd = sec["sub_nd"]
    sub_off = np.frombuffer(sec["sub_off"], dtype=np.int64).tolist()
    sub_size = np.frombuffer(sec["sub_size"], dtype=np.int64).tolist()
    others = json.loads(sec["others"].decode("utf-8"))

    # Cursors over the flat columns.
    li = 0          # leaf index
    sh_pos = 0      # shape_vals
    br_i = 0        # present byte_range index
    br_pos = 0      # br_vals
    ck_i = dg_i = or_i = co_i = dd_i = 0
    si = 0          # sub-leaf index
    so_pos = 0      # sub_off / sub_size
    ei = 0          # sharded/chunked entry index
    esh_pos = 0     # ent_shape
    oi = 0          # others

    def next_leaf() -> ArrayEntry:
        nonlocal li, sh_pos, br_i, br_pos, ck_i, dg_i, or_i, co_i, dd_i
        e = ArrayEntry.__new__(ArrayEntry)
        e.type = "array"
        e.location = locs[li]
        e.serializer = sers[ser_ids[li]]
        e.dtype = dts[dt_ids[li]]
        nd = shape_nd[li]
        e.shape = shape_vals[sh_pos:sh_pos + nd]
        sh_pos += nd
        e.replicated = bool(repl[li])
        f = flags[li]
        if f & _F_BYTE_RANGE:
            bnd = br_nd[br_i]
            br_i += 1
            e.byte_range = br_vals[br_pos:br_pos + bnd]
            br_pos += bnd
        else:
            e.byte_range = None
        if f & _F_CHECKSUM:
            e.checksum = checksums[ck_i]
            ck_i += 1
        else:
            e.checksum = None
        if f & _F_DIGEST:
            e.digest = digests[dg_i]
            dg_i += 1
        else:
            e.digest = None
        if f & _F_ORIGIN:
            e.origin = origins[origin_ids[or_i]]
            or_i += 1
        else:
            e.origin = None
        if f & _F_CODEC:
            e.codec = codecs[codec_ids[co_i]]
            co_i += 1
        else:
            e.codec = None
        if f & _F_DEVICE_DIGEST:
            e.device_digest = devdigs[dd_i]
            dd_i += 1
        else:
            e.device_digest = None
        li += 1
        return e

    def next_sub() -> Shard:
        nonlocal si, so_pos
        nd = sub_nd[si]
        si += 1
        offs = sub_off[so_pos:so_pos + nd]
        sizes = sub_size[so_pos:so_pos + nd]
        so_pos += nd
        return Shard(offsets=offs, sizes=sizes, array=next_leaf())

    manifest: Dict[str, Entry] = {}
    for i in range(n_entries):
        t = etype[i]
        if t == _T_ARRAY:
            manifest[paths[i]] = next_leaf()
        elif t == _T_SHARDED or t == _T_CHUNKED:
            dtype = dts[ent_dtype[ei]]
            nd = ent_shape_nd[ei]
            shape = ent_shape[esh_pos:esh_pos + nd]
            esh_pos += nd
            nsub = ent_nsub[ei]
            subs = [next_sub() for _ in range(nsub)]
            if t == _T_SHARDED:
                manifest[paths[i]] = ShardedArrayEntry(
                    dtype=dtype, shape=shape, shards=subs
                )
            else:
                manifest[paths[i]] = ChunkedArrayEntry(
                    dtype=dtype,
                    shape=shape,
                    chunks=subs,
                    replicated=bool(ent_repl[ei]),
                )
            ei += 1
        else:
            manifest[paths[i]] = entry_from_dict(others[oi])
            oi += 1

    return SnapshotMetadata(
        version=header["version"],
        world_size=header["world_size"],
        manifest=manifest,
        mirror_url=header.get("mirror_url"),
        origin_mirrors=header.get("origin_mirrors"),
        layout=header.get("layout"),
    )


# ------------------------------------------------------ manifest diffs


def encode_manifest_diff(
    base: SnapshotMetadata, new: SnapshotMetadata
) -> bytes:
    """TSCD v1: paths removed since ``base`` + added/changed entries as
    an embedded TSCM sub-manifest carrying ``new``'s top-level fields.

    Change detection compares the serialized entry forms — exact, and
    O(manifest) on the WRITER only; the reader's work is O(change).
    """
    base_m, new_m = base.manifest, new.manifest
    removed = [p for p in base_m if p not in new_m]
    changed: Dict[str, Entry] = {}
    for path, entry in new_m.items():
        old = base_m.get(path)
        if old is None or _entry_to_dict(old) != _entry_to_dict(entry):
            changed[path] = entry
    sub = SnapshotMetadata(
        version=new.version,
        world_size=new.world_size,
        manifest=changed,
        mirror_url=new.mirror_url,
        origin_mirrors=new.origin_mirrors,
        layout=new.layout,
    )
    header = {"removed": removed, "n_changed": len(changed)}
    return (
        DIFF_MAGIC
        + _pack_section(
            json.dumps(header, separators=(",", ":")).encode("utf-8")
        )
        + encode_metadata(sub)
    )


def apply_manifest_diff(
    base: SnapshotMetadata, diff: bytes
) -> SnapshotMetadata:
    """Materialize the metadata a TSCD diff describes on top of ``base``.

    Unchanged entries keep ``base``'s relative order; added entries
    append in diff order (changed-in-place entries keep their slot).
    ``base`` is not mutated.
    """
    if diff[: len(DIFF_MAGIC)] != DIFF_MAGIC:
        raise ValueError(f"bad diff magic {diff[:5]!r}")
    pos = len(DIFF_MAGIC)
    (clen,) = struct.unpack_from("<I", diff, pos)
    pos += 4
    header = json.loads(zlib.decompress(diff[pos:pos + clen]).decode("utf-8"))
    pos += clen
    sub = decode_metadata(diff[pos:])
    removed = set(header["removed"])
    manifest: Dict[str, Entry] = {
        p: e for p, e in base.manifest.items() if p not in removed
    }
    manifest.update(sub.manifest)
    return SnapshotMetadata(
        version=sub.version,
        world_size=sub.world_size,
        manifest=manifest,
        mirror_url=sub.mirror_url,
        origin_mirrors=sub.origin_mirrors,
        layout=sub.layout,
    )
