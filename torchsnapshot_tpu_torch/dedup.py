"""Incremental snapshots: skip storage writes for unchanged payloads.

Counterpart of ``torchsnapshot_tpu/dedup.py`` (lines 1-230). When
``Snapshot.take(..., incremental_base=...)`` names a previous snapshot,
each payload's content digest (SHA-256 of the exact staged bytes) is
compared with the digest the base recorded for the payload at the same
storage location. On a match the write is skipped and the manifest entry
records ``origin``, the snapshot that physically holds the bytes. Origins
resolve transitively: a payload written once is referenced directly, however
many increments follow.

With ``device_digests`` the comparison happens before the device-to-host
copy, on the fingerprint of ``device_digest.py``, so an unchanged CUDA
tensor is neither copied nor written.

Matching is by storage location, a function of the logical path, the
replication class and the chunk box. Restore reads an entry with ``origin``
from that snapshot's storage, so deleting a base breaks the increments
built on it; ``retention.py`` keeps every base a survivor needs.

:func:`consolidate` (dedup.py:231-490 of the JAX package) materializes an
incremental snapshot as a self-contained one: every payload copied from
the snapshot or its origins (each read through its own mirror), the
committed delta journal folded in (:func:`_compact_journal`), origins and
mirrors cleared, the metadata written last.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from .integrity import checksums_enabled, compute_checksum
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
)

DIGEST_ALGO = "sha256"


def canonical_base_url(url: str) -> str:
    """Canonical form of a base-snapshot URL for recording as an origin:
    origins are resolved later from other working directories, so
    filesystem paths become their real absolute path; remote URLs pass
    through verbatim."""
    if url.startswith("fs://"):
        return "fs://" + os.path.realpath(url[len("fs://"):])
    if "://" in url:
        return url
    return os.path.realpath(url)


def compute_digest(buf) -> str:
    h = hashlib.sha256()
    h.update(memoryview(buf).cast("B"))
    return f"{DIGEST_ALGO}:{h.hexdigest()}"


@dataclass(frozen=True)
class PayloadRef:
    """Where a base snapshot holds a payload, and what its content was.

    ``checksum`` and ``codec`` describe the base's stored bytes: a match
    skips the write, so restore reads the base's payload and the new entry
    records the stored form's checksum."""

    digest: str
    origin: str  # snapshot URL that physically holds the bytes
    nbytes: Optional[int]
    checksum: Optional[str] = None
    codec: Optional[str] = None
    location: Optional[str] = None  # where the bytes live within the origin
    device_digest: Optional[str] = None  # the base's device fingerprint


def _iter_payload_entries(entry: Entry) -> Iterator[ArrayEntry]:
    if isinstance(entry, ArrayEntry):
        yield entry
    elif isinstance(entry, ChunkedArrayEntry):
        for chunk in entry.chunks:
            yield chunk.array
    elif isinstance(entry, ShardedArrayEntry):
        for shard in entry.shards:
            yield shard.array


class DedupContext:
    """Digest recording and (optionally) a base snapshot's payload index.

    Active during a take's planning through :func:`dedup_staging`; stagers
    capture it at construction and consult it at stage time."""

    def __init__(
        self,
        base_path: Optional[str],
        refs: Dict[str, PayloadRef],
        device_digests: bool = False,
    ):
        self.base_path = base_path
        self.refs = refs
        # Content-address fallback index: the first ref per digest wins
        # (interchangeable by construction: digest and size verified).
        self.by_digest: Dict[str, PayloadRef] = {}
        for ref in refs.values():
            self.by_digest.setdefault(ref.digest, ref)
        # When True, stagers fingerprint tensors (device_digest.py) and skip
        # the device-to-host copy on a base match; the fingerprint is also
        # recorded so later takes can match.
        self.device_digests = device_digests

    @classmethod
    def recording_only(cls, device_digests: bool = False) -> "DedupContext":
        return cls(base_path=None, refs={}, device_digests=device_digests)

    @classmethod
    def from_base(
        cls,
        base_path: str,
        metadata: SnapshotMetadata,
        device_digests: bool = False,
    ) -> "DedupContext":
        """Index every digest-carrying payload of ``metadata`` by location.
        Origins resolve transitively: a payload the base itself borrowed
        points straight at the older snapshot."""
        from .serialization import array_size_bytes

        refs: Dict[str, PayloadRef] = {}
        for entry in metadata.manifest.values():
            for p in _iter_payload_entries(entry):
                if p.digest is None or p.byte_range is not None:
                    # Slab-packed payloads live at locations a new take
                    # never produces.
                    continue
                try:
                    nbytes: Optional[int] = array_size_bytes(p.shape, p.dtype)
                except ValueError:
                    nbytes = None
                refs.setdefault(
                    p.location,
                    PayloadRef(
                        digest=p.digest,
                        origin=p.origin or base_path,
                        nbytes=nbytes,
                        checksum=p.checksum,
                        codec=p.codec,
                        device_digest=p.device_digest,
                        location=p.location,
                    ),
                )
            if isinstance(entry, ObjectEntry) and entry.digest is not None:
                refs.setdefault(
                    entry.location,
                    PayloadRef(
                        digest=entry.digest,
                        origin=entry.origin or base_path,
                        nbytes=entry.size,
                        checksum=entry.checksum,
                        codec=entry.codec,
                        location=entry.location,
                    ),
                )
        return cls(base_path=base_path, refs=refs, device_digests=device_digests)

    def reuse_staged(self, entry, buf) -> bool:
        """Record the SHA-256 digest of ``entry``'s staged bytes ``buf``;
        when the base holds the same bytes, point ``entry`` at them and
        return True: the write is skipped. The entry takes the base's stored
        checksum and codec, which restore will read; a raw base saved
        without checksums stores exactly ``buf``, so its checksum is
        computed here. Slab-batched payloads (``byte_range``) never dedup."""
        entry.digest = compute_digest(buf)
        if getattr(entry, "byte_range", None) is not None:
            return False
        ref = self.match(entry.location, entry.digest, memoryview(buf).nbytes)
        if ref is None:
            return False
        entry.origin = ref.origin
        entry.codec = ref.codec
        if ref.location is not None:
            entry.location = ref.location
        if ref.checksum is None and ref.codec is None:
            if checksums_enabled():
                entry.checksum = compute_checksum(buf)
        else:
            entry.checksum = ref.checksum
        return True

    def match(self, location: str, digest: str, nbytes: int) -> Optional[PayloadRef]:
        ref = self.refs.get(location)
        if ref is None or ref.digest != digest:
            # Content-address fallback: the same bytes under another
            # location still dedup on digest and size.
            ref = self.by_digest.get(digest)
            if ref is None:
                return None
        if ref.nbytes is not None and ref.nbytes != nbytes:
            return None  # digest collision paranoia: sizes must agree
        return ref


_dedup_context: contextvars.ContextVar[Optional[DedupContext]] = contextvars.ContextVar(
    "tsnap_gpu_dedup_context", default=None
)


def active_dedup_context() -> Optional[DedupContext]:
    return _dedup_context.get()


@contextlib.contextmanager
def dedup_staging(ctx: Optional[DedupContext]):
    """Stagers prepared inside this block capture ``ctx``."""
    token = _dedup_context.set(ctx)
    try:
        yield
    finally:
        _dedup_context.reset(token)


def consolidate(
    src_path: str,
    dst_path: str,
    storage_options=None,
    io_concurrency: int = 4,
) -> int:
    """Materialize an incremental snapshot as a self-contained one.

    Copies every payload, local ones from ``src_path`` and deduplicated
    ones from their origin snapshots, into ``dst_path``, folds the
    committed delta-journal epochs into them, clears ``origin`` on every
    entry (digests are kept, so the result can serve as a base), and
    commits the metadata last, as a take does. The bases can then be
    deleted. Peak memory is about ``io_concurrency`` times the largest
    payload. Returns the number of payload files copied."""
    import asyncio

    from .io_types import ReadIO, WriteIO
    from .snapshot import Snapshot
    from .storage_plugin import strip_mirror_options, url_to_storage_plugin_in_event_loop

    # Mirror settings name the source's mirror: they must not reach origin
    # snapshots or the destination (the result is single-tier).
    storage_options = strip_mirror_options(storage_options)
    metadata = Snapshot(src_path, storage_options=storage_options).metadata

    # One copy per distinct location; a slab shared by byte-ranged payloads
    # is copied whole so the ranges stay valid.
    locations: Dict[str, Optional[str]] = {}
    for entry in metadata.manifest.values():
        payloads = list(_iter_payload_entries(entry))
        if isinstance(entry, ObjectEntry):
            payloads.append(entry)
        for p in payloads:
            locations.setdefault(p.location, p.origin)
            if p.origin is None:
                locations[p.location] = None  # prefer the local copy

    event_loop = asyncio.new_event_loop()
    # Plugin construction drives the loop itself, so every source is
    # resolved before copy_all runs it.
    plugins = {None: url_to_storage_plugin_in_event_loop(dst_path, event_loop, storage_options)}
    origin_mirrors = metadata.origin_mirrors or {}
    for origin in {org or src_path for org in locations.values()}:
        opts = dict(storage_options or {})
        # An origin reads through its own mirror (recorded at take time),
        # so consolidation survives the loss of a base's primary.
        mirror = origin_mirrors.get(origin) or (
            metadata.mirror_url if origin == src_path else None
        )
        if mirror and canonical_base_url(mirror) != canonical_base_url(origin):
            opts["mirror_url"] = mirror
        plugins[origin] = url_to_storage_plugin_in_event_loop(origin, event_loop, opts or None)

    async def copy_all() -> None:
        sem = asyncio.Semaphore(max(1, io_concurrency))

        async def copy_one(location: str, origin: Optional[str]) -> None:
            async with sem:
                read_io = ReadIO(path=location)
                await plugins[origin or src_path].read(read_io)
                await plugins[None].write(WriteIO(path=location, buf=read_io.buf))

        await asyncio.gather(*(copy_one(loc, org) for loc, org in locations.items()))

    try:
        event_loop.run_until_complete(copy_all())
        for entry in metadata.manifest.values():
            for p in _iter_payload_entries(entry):
                p.origin = None
            if isinstance(entry, ObjectEntry):
                entry.origin = None
        # The committed journal folds into the copied payloads before the
        # metadata commit: the result equals base plus replay, with no
        # journal to carry (.journal is never among the locations).
        _compact_journal(src_path, metadata, plugins[None], event_loop)
        metadata.origin_mirrors = None
        metadata.mirror_url = None
        Snapshot._write_snapshot_metadata(metadata, plugins[None], event_loop)
    finally:
        for plugin in plugins.values():
            plugin.sync_close(event_loop)
        event_loop.close()
    return len(locations)


def _compact_journal(src_path, metadata, dst_plugin, event_loop) -> int:
    """Write the last committed journal value of every journaled leaf into
    the destination's payloads and manifest entries. The bytes are cut and
    re-encoded through torch byte views (the JAX package uses numpy, which
    has no bf16).

    Raises ValueError when a record cannot be folded faithfully (a corrupt
    journal, a leaf the base does not have, drift in dtype or shape, a
    sharded or slab-compressed destination): consolidation never drops
    committed state in silence. Returns the number of records folded."""
    import numpy as np

    from . import journal as journal_mod
    from .compression import compress
    from .io_types import ReadIO, WriteIO
    from .manifest import PrimitiveEntry
    from .serialization import (
        object_as_bytes,
        object_from_bytes,
        tensor_as_memoryview,
        tensor_from_buffer,
    )
    from .storage_plugin import local_fs_root

    local = local_fs_root(src_path)
    if local is None:
        return 0
    jdir = os.path.join(local, journal_mod.JOURNAL_DIRNAME)
    if not os.path.isdir(jdir):
        return 0
    committed = journal_mod.committed_epochs(journal_mod.read_epoch_metas(jdir))
    if not committed:
        return 0
    updates = {}  # manifest key -> (header, payload)
    for rank_str in sorted(committed[-1].get("offsets", {}), key=int):
        rank = int(rank_str)
        ups, err, _tail = journal_mod.collect_rank_updates(jdir, rank, committed)
        if err is not None:
            raise ValueError(
                f"journal of {src_path} cannot be read ({err}); fix it with fsck before "
                "consolidating"
            )
        for key, rec in ups.items():
            updates[f"{rank}/{key}"] = rec

    def write_payload(entry, buf) -> None:
        """Replace one ArrayEntry's or ObjectEntry's stored bytes and
        refresh its integrity fields; ``buf`` holds the uncompressed
        content."""
        stored = buf
        byte_range = getattr(entry, "byte_range", None)
        if entry.codec:
            if byte_range is not None:
                raise ValueError(
                    f"cannot compact journal into compressed slab payload {entry.location}"
                )
            stored = compress(entry.codec, buf)
        if byte_range is not None:
            lo, hi = byte_range
            if hi - lo != len(stored):
                raise ValueError(
                    f"journal record size {len(stored)} != slab range [{lo}, {hi}) of "
                    f"{entry.location}"
                )
            read_io = ReadIO(path=entry.location)
            event_loop.run_until_complete(dst_plugin.read(read_io))
            slab = bytearray(read_io.buf)
            slab[lo:hi] = stored
            event_loop.run_until_complete(dst_plugin.write(WriteIO(path=entry.location, buf=slab)))
        else:
            event_loop.run_until_complete(
                dst_plugin.write(WriteIO(path=entry.location, buf=bytes(stored)))
            )
        if entry.checksum is not None:
            entry.checksum = compute_checksum(stored)
        if getattr(entry, "digest", None) is not None:
            entry.digest = compute_digest(buf)
        if getattr(entry, "device_digest", None) is not None:
            entry.device_digest = None  # stale: the content was replaced

    def drift(entry, header) -> bool:
        return (
            header.get("kind") != "array"
            or entry.dtype != header.get("dtype")
            or list(entry.shape) != list(header.get("shape", []))
        )

    def drifted(mkey: str) -> ValueError:
        return ValueError(
            f"journaled array {mkey!r} drifted in dtype/shape against the base "
            "snapshot; restore and retake instead of consolidating"
        )

    def changed_type(mkey: str) -> ValueError:
        return ValueError(
            f"journaled key {mkey!r} changed type against the base snapshot; restore "
            "and retake instead of consolidating"
        )

    folded = 0
    for mkey, (header, payload) in sorted(updates.items()):
        entry = metadata.manifest.get(mkey)
        kind = header.get("kind")
        if entry is None:
            raise ValueError(
                f"journaled key {mkey!r} has no entry in the base manifest (state grew "
                "a new leaf after the base snapshot); restore and retake instead of "
                "consolidating"
            )
        if isinstance(entry, PrimitiveEntry):
            if kind != "object":
                raise changed_type(mkey)
            metadata.manifest[mkey] = PrimitiveEntry.from_object(
                object_from_bytes(payload), replicated=entry.replicated
            )
        elif isinstance(entry, ObjectEntry):
            if kind == "object":
                buf = bytes(payload)
            elif kind == "array":
                # The port pickles a numpy leaf as an object; its journal
                # records the array, which is pickled back here.
                arr = tensor_from_buffer(bytearray(payload), header["dtype"], header["shape"])
                buf = object_as_bytes(np.array(arr.numpy()))
            else:
                raise changed_type(mkey)
            write_payload(entry, buf)
            if entry.size is not None:
                entry.size = len(buf)
        elif isinstance(entry, ArrayEntry):
            if drift(entry, header):
                raise drifted(mkey)
            write_payload(entry, payload)
        elif isinstance(entry, ChunkedArrayEntry):
            if drift(entry, header):
                raise drifted(mkey)
            t = tensor_from_buffer(bytearray(payload), header["dtype"], header["shape"])
            for chunk in entry.chunks:
                box = tuple(slice(o, o + n) for o, n in zip(chunk.offsets, chunk.sizes))
                piece = t[box].contiguous() if box else t
                write_payload(chunk.array, tensor_as_memoryview(piece))
        elif isinstance(entry, ShardedArrayEntry):
            raise ValueError(
                f"journaled key {mkey!r} is a sharded array; consolidating journaled "
                "shards is not supported: restore and retake"
            )
        else:
            raise ValueError(
                f"journaled key {mkey!r} maps to unsupported entry type "
                f"{type(entry).__name__}; restore and retake"
            )
        folded += 1
    return folded
