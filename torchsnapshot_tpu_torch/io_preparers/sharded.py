"""DTensor-sharded tensor preparer: the resharding engine.

Counterpart of ``torchsnapshot_tpu/io_preparers/sharded.py`` over DTensor
``Shard(d)``/``Replicate`` placements on 1-D and 2-D meshes (FSDP2's
``Shard(0)`` on a 1-D mesh, tensor parallelism's ``Shard(1)``, HSDP's 2-D
meshes). Each piece is recorded with its N-D global offsets and sizes,
the format the JAX package writes, so snapshots are independent of world
size and layout and restore in either package.

Geometry without a collective: every rank computes every rank's box from
the mesh and the placements (:func:`shard_boxes`, DTensor's ``Shard``
tiling: ceil-division chunks with empty trailing shards, several mesh dims
on one tensor dim nesting outer first). This replaces
``sharding.devices_indices_map``. A DTensor is read through one small
function, :func:`dtensor_view`, into a :class:`ShardedView`: the global
shape, every rank's box, this rank, and the local tensor. Tests build
views directly, which simulates every rank of a mesh in one process.

Save: boxes are deduplicated (an HSDP layout replicates each shard over
the replicate dim, and without dedup every replica would write it); each
box's writer is elected among its holders by an md5 of the box
(:func:`_stable_owner`), with no communication. Each owned box is cut
along its largest dim into pieces of at most 512 MB (:func:`_subdivide`)
and staged by ``ArrayBufferStager`` (DtoH into registered slabs on the
side stream). Empty boxes write nothing.

Restore: the destination is the spec. For a sharded DTensor the only
destination box is this rank's local shard; for a plain tensor (or none)
it is the whole array. Each saved piece that overlaps a destination box
is read once, verified and decoded on the host (a sub-chunk at a time
where the scheduler streams it, the copy waiting for the checksum), and
its overlap copied into the box (:class:`_ShardScatterConsumer`): on the
CPU in place, into a CUDA shard through a registered staging slab and
``copy_`` on the side stream, which waits on the caller's stream at plan
time, the slab fenced by the copy's event (the order of
``ArrayBufferConsumer``). Host memory is one piece per read in flight,
never the whole array.

Planned reshard (``reshard.py``): with a reshard context, the pieces that
several ranks' boxes meet are read once, by an elected owner, whose
consumer sends each other requester its regions over the peer channel;
the receivers' consumers land them through the same HtoD path.

Device digests: a piece contained in the local box is verified by its
fingerprint (K4's full form); a piece cut across processes is verified by
the distributed preverify of ``snapshot.py``, each rank contributing the
partial lanes of its elected regions (:meth:`partial_digest_contributions`,
K4's partial form).

A ``Partial`` placement (unreduced values) raises by name: the JAX package
has no counterpart, and its local tensors are not pieces of the value.
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..compression import StreamingDecompressor, decompress
from ..integrity import verification_enabled, verify_checksum
from ..io_types import BufferConsumer, BufferType, ReadReq, ReadStream, WriteReq
from ..manifest import ArrayEntry, Shard, ShardedArrayEntry
from ..serialization import (
    Serializer,
    array_size_bytes,
    dtype_to_string,
    string_to_dtype,
    tensor_from_buffer,
)
from .array import (
    ArrayBufferStager,
    DeviceStreams,
    _copy_cpu,
    _device_staging_buffer,
    _IncrementalEntryDecoder,
    _ScratchSink,
    _staging_pool,
    _stored_size,
    _wait_event,
    check_restore_cast,
)

DEFAULT_MAX_SHARD_SIZE_BYTES = 512 * 1024 * 1024

Box = Tuple[Tuple[int, int], ...]  # ((start, stop) per dim)


@dataclass
class ShardedView:
    """What the sharded preparer reads of a sharded tensor: its global
    ``shape``, every rank's box (``boxes[rank]``), this process's ``rank``
    and its ``local`` shard, the data of ``boxes[rank]``."""

    shape: Tuple[int, ...]
    boxes: Dict[int, Box]
    rank: int
    local: torch.Tensor

    @property
    def local_box(self) -> Box:
        return self.boxes[self.rank]


def shard_boxes(shape: Sequence[int], mesh_ranks: torch.Tensor, placements: Sequence[Any]) -> Dict[int, Box]:
    """Every rank's box of a tensor of ``shape`` laid out by ``placements``
    over a mesh whose ranks are ``mesh_ranks`` (``DeviceMesh.mesh``): for
    each mesh dim in order, ``Shard(d)`` splits the rank's current extent
    along ``d`` into ceil-division chunks (empty at the tail when they run
    out) and ``Replicate`` leaves it whole. Any other placement raises."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import Shard as DShard

    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    for p in placements:
        if type(p) is not DShard and not isinstance(p, Replicate):
            raise NotImplementedError(
                f"DTensor placement {p!r}: only Shard and Replicate placements are "
                "snapshotted (a Partial placement holds unreduced values; redistribute "
                "it to Shard or Replicate first)."
            )
    mesh_shape = tuple(mesh_ranks.shape)
    out: Dict[int, Box] = {}
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        box = [[0, d] for d in shape]
        for m, p in enumerate(placements):
            if isinstance(p, Replicate):
                continue
            d = p.dim % ndim
            lo, hi = box[d]
            size = hi - lo
            chunk = -(-size // mesh_shape[m])
            start = min(coord[m] * chunk, size)
            box[d] = [lo + start, lo + min(start + chunk, size)]
        out[int(mesh_ranks[coord])] = tuple((a, b) for a, b in box)
    return out


def dtensor_view(dt: Any) -> ShardedView:
    """A DTensor as the preparer reads it; no collective."""
    mesh = dt.device_mesh
    return ShardedView(
        shape=tuple(dt.shape),
        boxes=shard_boxes(dt.shape, mesh.mesh, dt.placements),
        rank=mesh.get_rank(),
        local=dt.to_local(),
    )


def _volume(box: Box) -> int:
    return math.prod(hi - lo for lo, hi in box)


def _box_key(box: Box) -> str:
    return "_".join(f"{a}.{b}" for a, b in box)


def _stable_owner(box: Box, holders: List[int]) -> int:
    """Deterministic, load-spreading choice of writer among the holders."""
    digest = hashlib.md5(_box_key(box).encode()).digest()
    return sorted(holders)[int.from_bytes(digest[:4], "big") % len(holders)]


def _overlap(
    saved_off: Sequence[int], saved_sz: Sequence[int], box: Box
) -> Optional[Tuple[Tuple[slice, ...], Tuple[slice, ...]]]:
    """(view into the saved piece, view into the destination box), or None
    when they do not overlap (an empty box overlaps nothing)."""
    src_slices = []
    dst_slices = []
    for (d_lo, d_hi), s_lo, s_sz in zip(box, saved_off, saved_sz):
        lo = max(s_lo, d_lo)
        hi = min(s_lo + s_sz, d_hi)
        if lo >= hi:
            return None
        src_slices.append(slice(lo - s_lo, hi - s_lo))
        dst_slices.append(slice(lo - d_lo, hi - d_lo))
    return tuple(src_slices), tuple(dst_slices)


def _subdivide(
    offsets: List[int], sizes: List[int], itemsize: int, max_bytes: int
) -> List[Tuple[List[int], List[int]]]:
    """Split a box into pieces of at most ``max_bytes`` along its largest
    dim."""
    nbytes = math.prod(sizes) * itemsize if sizes else itemsize
    if nbytes <= max_bytes or not sizes:
        return [(list(offsets), list(sizes))]
    dim = max(range(len(sizes)), key=lambda i: (sizes[i], -i))
    other = (nbytes // max(sizes[dim], 1)) or 1  # bytes per unit along dim
    rows_per_piece = max(1, max_bytes // other)
    pieces = []
    lo = 0
    while lo < sizes[dim]:
        hi = min(lo + rows_per_piece, sizes[dim])
        p_off = list(offsets)
        p_sz = list(sizes)
        p_off[dim] = offsets[dim] + lo
        p_sz[dim] = hi - lo
        pieces.append((p_off, p_sz))
        lo = hi
    return pieces


class _Completion:
    def __init__(self, num_parts: int, finalize: Callable[[], None]) -> None:
        self._remaining = num_parts
        self._finalize = finalize
        self._lock = threading.Lock()

    def part_done(self) -> None:
        # Parts are consumed concurrently from executor threads.
        with self._lock:
            self._remaining -= 1
            remaining = self._remaining
        if remaining == 0:
            self._finalize()


class _ShardScatterConsumer(BufferConsumer):
    """Reads one saved piece and copies its overlap into every destination
    box it meets."""

    def __init__(
        self,
        shard: Shard,
        targets: List[Tuple[torch.Tensor, Tuple[slice, ...], Tuple[slice, ...]]],
        completion: _Completion,
        streams: DeviceStreams,
    ) -> None:
        self.shard = shard
        self.targets = targets  # (destination box tensor, src slices, dst slices)
        self.completion = completion
        # Planned on the caller's thread: the side stream's ordering point.
        self.streams = {
            dst.device: streams.get(dst.device) for dst, _, _ in targets if dst.is_cuda
        }

    def _decode(self, buf: BufferType) -> torch.Tensor:
        """The stored bytes verified against the piece's checksum (each
        piece is read once, whole), decompressed, viewed as the piece."""
        array = self.shard.array
        if array.checksum is not None and verification_enabled():
            verify_checksum(buf, array.checksum, array.location)
        if array.codec is not None:
            buf = decompress(
                array.codec, buf, expected_size=array_size_bytes(array.shape, array.dtype)
            )
        return tensor_from_buffer(buf, array.dtype, array.shape)

    @staticmethod
    def _stage(src: torch.Tensor) -> torch.Tensor:
        """``src`` (a host region of the piece) packed into a registered
        staging slab, as a contiguous tensor of its dtype and shape."""
        nbytes = src.numel() * src.element_size()
        host = _device_staging_buffer(nbytes)
        packed = host.view(src.dtype).view(src.shape)
        packed.copy_(src)
        return packed

    async def _copy_to_cuda(self, src: torch.Tensor, dst: torch.Tensor, executor) -> None:
        loop = asyncio.get_running_loop()
        packed = await loop.run_in_executor(executor, self._stage, src)
        stream = self.streams[dst.device]
        event = torch.cuda.Event()
        with torch.cuda.stream(stream):
            # A dtype difference is cast on the device.
            dst.copy_(packed, non_blocking=True)
            event.record(stream)
        _staging_pool.fence(packed, event)
        # The slab must outlive the copy: dropped only after the event.
        await _wait_event(event, executor)
        del packed

    async def _land(self, src: torch.Tensor, dst: torch.Tensor, executor) -> None:
        """Copy the host region ``src`` into ``dst`` (a view of a
        destination box): on the CPU in place, into CUDA through a slab."""
        if dst.is_cuda:
            await self._copy_to_cuda(src, dst, executor)
        else:
            await asyncio.get_running_loop().run_in_executor(executor, _copy_cpu, dst, src)

    async def _scatter(self, arr: torch.Tensor, executor) -> None:
        """Copy the decoded piece's overlap into every target box."""
        for dst_box, src_slices, dst_slices in self.targets:
            src = arr[src_slices] if src_slices else arr
            dst = dst_box[dst_slices] if dst_slices else dst_box
            await self._land(src, dst, executor)
        self.completion.part_done()

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        loop = asyncio.get_running_loop()
        arr = await loop.run_in_executor(executor, self._decode, buf)
        await self._scatter(arr, executor)

    def get_consuming_cost_bytes(self) -> int:
        return array_size_bytes(self.shard.array.shape, self.shard.array.dtype)

    # ----------------------------------------------------- streaming path

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        """A piece of two sub-chunks or more whose codec decodes
        incrementally streams: the chained CRC and the decompression
        advance a sub-chunk at a time while later ones are on the wire, and
        the scatter waits until the checksum holds (verify before commit).
        The whole piece is held in a host scratch, so the admission cost
        stays the default full consuming cost (sharded.py:216-228 of the
        JAX package)."""
        if _stored_size(self.shard.array) < 2 * sub_chunk_bytes:
            return False
        return StreamingDecompressor.available(self.shard.array.codec)

    async def consume_stream(self, stream: ReadStream, executor=None) -> None:
        """Verify and decode each sub-chunk into a host scratch of the
        piece's raw size, then scatter the piece as a buffered read does.
        Each call starts a fresh decoder and scratch, so a restarted stream
        never splices onto an earlier generation; a checksum mismatch
        raises before any box is written."""
        loop = asyncio.get_running_loop()
        array = self.shard.array
        sink = _ScratchSink(array_size_bytes(array.shape, array.dtype))
        decoder = _IncrementalEntryDecoder(array, sink.add)

        def finish() -> torch.Tensor:
            decoder.finish()  # a checksum mismatch raises here
            return tensor_from_buffer(sink.finish(), array.dtype, array.shape)

        try:
            async for chunk in stream.chunks:
                await loop.run_in_executor(executor, decoder.add, chunk)
            arr = await loop.run_in_executor(executor, finish)
            await self._scatter(arr, executor)
        finally:
            sink.close()


class ShardedArrayIOPreparer:
    max_shard_size_bytes: int = DEFAULT_MAX_SHARD_SIZE_BYTES

    # ------------------------------------------------------------------ save

    @staticmethod
    def _elected_local_boxes(view: ShardedView) -> Iterator[Tuple[Box, torch.Tensor]]:
        """``(box, data)`` for every distinct non-empty box this rank is
        elected to act for: the dedup and md5 election shared by the
        save-side writer partition and the restore-side distributed digest
        verification, so the two can never disagree about ownership."""
        holders: Dict[Box, List[int]] = {}
        for r, box in view.boxes.items():
            holders.setdefault(box, []).append(r)
        for box in sorted(holders):
            if _volume(box) == 0 or _stable_owner(box, holders[box]) != view.rank:
                continue
            yield box, view.local

    @classmethod
    def _owned_pieces(cls, view: ShardedView, itemsize: Optional[int] = None):
        """``(offsets, sizes, piece)`` for every piece this rank writes:
        its elected boxes, each cut to the piece size cap; ``piece`` is a
        view of the local shard. ``itemsize`` sizes the cut at another
        dtype (a ``save_dtype`` conversion)."""
        if itemsize is None:
            itemsize = view.local.element_size()
        for box, data in cls._elected_local_boxes(view):
            offsets = [lo for lo, _ in box]
            sizes = [hi - lo for lo, hi in box]
            for p_off, p_sz in _subdivide(offsets, sizes, itemsize, cls.max_shard_size_bytes):
                local_slices = tuple(
                    slice(po - o, po - o + ps) for po, o, ps in zip(p_off, offsets, p_sz)
                )
                yield p_off, p_sz, (data[local_slices] if local_slices else data)

    @classmethod
    def staged_piece_sizes(cls, view: ShardedView, dtype: Optional[str] = None) -> List[int]:
        """Byte sizes of the staging buffers this rank draws for the tensor
        (pool warmup); ``dtype`` overrides its own."""
        dtype = dtype if dtype is not None else dtype_to_string(view.local.dtype)
        itemsize = array_size_bytes((1,), dtype)
        return [array_size_bytes(p_sz, dtype) for _, p_sz, _ in cls._owned_pieces(view, itemsize)]

    @classmethod
    def prepare_write(
        cls,
        storage_path_prefix: str,
        view: ShardedView,
        streams: DeviceStreams,
        copy_cpu: bool,
    ) -> Tuple[ShardedArrayEntry, List[WriteReq]]:
        dtype_str = dtype_to_string(view.local.dtype)
        shards: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for p_off, p_sz, piece in cls._owned_pieces(view):
            location = f"{storage_path_prefix}_{'_'.join(map(str, p_off))}"
            entry = ArrayEntry(
                location=location,
                serializer=Serializer.BUFFER_PROTOCOL.value,
                dtype=dtype_str,
                shape=list(p_sz),
                replicated=False,
            )
            shards.append(Shard(offsets=list(p_off), sizes=list(p_sz), array=entry))
            write_reqs.append(
                WriteReq(path=location, buffer_stager=ArrayBufferStager(piece, entry, streams, copy_cpu))
            )
        return ShardedArrayEntry(dtype=dtype_str, shape=list(view.shape), shards=shards), write_reqs

    # --------------------------------------------------------------- restore

    @staticmethod
    def _dst_already_matches(entry: ShardedArrayEntry, dst: Any) -> bool:
        """True when the destination already holds every piece's content
        that this rank holds, proven by fingerprints. A plain tensor holds
        the whole array: every piece is sliced out and fingerprinted. A
        view holds its local box: each piece overlapping it must lie in it
        (a piece cut across processes is the distributed preverify's, and
        means False here). Conservative: a missing fingerprint or a dtype
        difference means False."""
        from ..device_digest import fingerprints_match

        local = dst.local if isinstance(dst, ShardedView) else dst
        if dtype_to_string(local.dtype) != entry.dtype or not entry.shards:
            return False
        if any(s.array.device_digest is None for s in entry.shards):
            return False
        if not isinstance(dst, ShardedView):
            return fingerprints_match(
                (
                    array_size_bytes(s.sizes, entry.dtype),
                    lambda s=s: dst[tuple(slice(o, o + n) for o, n in zip(s.offsets, s.sizes))],
                    s.array.device_digest,
                )
                for s in entry.shards
            )
        box = dst.local_box
        to_check = []
        for s in entry.shards:
            if _overlap(s.offsets, s.sizes, box) is None:
                continue  # another rank's piece
            if not all(
                o >= lo and o + n <= hi for o, n, (lo, hi) in zip(s.offsets, s.sizes, box)
            ):
                return False
            local_slices = tuple(
                slice(o - lo, o - lo + n) for o, n, (lo, _) in zip(s.offsets, s.sizes, box)
            )
            to_check.append(
                (
                    array_size_bytes(s.sizes, entry.dtype),
                    lambda ls=local_slices: local[ls],
                    s.array.device_digest,
                )
            )
        return bool(to_check) and fingerprints_match(to_check)

    @classmethod
    def partial_digest_contributions(
        cls, entry: ShardedArrayEntry, view: ShardedView
    ) -> Optional[Dict[int, List[Tuple[str, int, Tuple[int, int, int, int]]]]]:
        """This rank's share of the distributed (zero-byte) verification of
        ``entry`` against the destination: for every destination box
        elected to this rank (the save side's election), the partial
        fingerprint lanes of each saved piece's intersection with the box,
        tagged with the region's offsets in the piece. Lanes add over
        disjoint word covers (``device_digest.py``), so the ranks' 16-byte
        partials sum to each piece's fingerprint, which verifies a piece
        that no process holds whole with no payload moved.

        Returns ``{piece_index: [(box_key, n_elements, lanes), ...]}``
        (empty when this rank was elected for no box), or None when a
        region could not be fingerprinted. Dispatch is windowed (a few
        region slices are live at a time), and each window's lanes come
        back in ONE device-to-host copy (``device_digest._fetch``), where
        the JAX package fetches region by region."""
        from .. import device_digest as dd

        itemsize = array_size_bytes((1,), entry.dtype)
        work = []
        for box, data in cls._elected_local_boxes(view):
            for i, shard in enumerate(entry.shards):
                ov = _overlap(shard.offsets, shard.sizes, box)
                if ov is None:
                    continue
                src_slices, dst_slices = ov
                n_elems = math.prod(sl.stop - sl.start for sl in src_slices)
                work.append(
                    (i, _box_key(box), tuple(shard.sizes), tuple(sl.start for sl in src_slices),
                     data, dst_slices, n_elems)
                )
        out: Dict[int, List[Tuple[str, int, Tuple[int, int, int, int]]]] = {}
        pos = 0
        while pos < len(work):
            batch = []
            batch_bytes = 0
            while (pos < len(work) and len(batch) < dd.MATCH_WINDOW
                   and batch_bytes < dd.MATCH_WINDOW_BYTES):
                i, box_key, piece_shape, offs, data, dst_slices, n_elems = work[pos]
                nbytes = n_elems * itemsize
                if batch and batch_bytes + nbytes > dd.MATCH_WINDOW_BYTES:
                    break
                region = data[dst_slices] if dst_slices else data
                pending = dd.partial_dispatch(region, piece_shape, offs)
                del region
                if pending is None:
                    return None
                batch.append((i, box_key, n_elems, pending))
                batch_bytes += nbytes
                pos += 1
            lanes = dd._fetch([pending for _, _, _, pending in batch])
            for (i, box_key, n_elems, _), got in zip(batch, lanes):
                out.setdefault(i, []).append((box_key, n_elems, got))
        return out

    @classmethod
    def prepare_read(
        cls,
        entry: ShardedArrayEntry,
        obj_out: Any,
        callback: Optional[Callable[[Any], None]],
        streams: DeviceStreams,
        device_digests: bool = False,
        reshard: Optional[Any] = None,
    ) -> List[ReadReq]:
        """Reads that fill the destination: a :class:`ShardedView` (or a
        sharded DTensor, read through :func:`dtensor_view`) in its local
        shard, a plain tensor whole, in place; with neither, a new CPU
        tensor. ``callback`` gets ``obj_out`` (or the new tensor) once the
        last piece has landed.

        ``reshard`` (a ``reshard.ReshardContext``): into a sharded
        destination, the planner takes every rank's box (one a process,
        from :func:`shard_boxes`: no collective) and claims the pieces
        that several ranks want. A claimed piece is read once, by its
        elected owner, and reaches the other requesters as region bundles
        over the peer channel; the rest read directly."""
        from .prepare import is_dtensor

        shape = tuple(entry.shape)
        view = dtensor_view(obj_out) if is_dtensor(obj_out) else obj_out
        reshard_roles = None
        if isinstance(view, ShardedView):
            if tuple(view.shape) != shape:
                raise RuntimeError(
                    f"Shape mismatch restoring a sharded tensor: snapshot has {list(shape)}, "
                    f"destination has {list(view.shape)}."
                )
            if device_digests and cls._dst_already_matches(entry, view):
                return []
            check_restore_cast(entry.dtype, view.local.dtype, "a sharded tensor into a DTensor")
            box = view.local_box
            boxes = {box: view.local} if _volume(box) else {}
            value = obj_out
            if reshard is not None:
                reshard_roles = reshard.plan_entry(
                    entry, {r: [b] for r, b in sorted(view.boxes.items()) if _volume(b)}
                )
        else:
            if isinstance(obj_out, torch.Tensor):
                if tuple(obj_out.shape) != shape:
                    raise RuntimeError(
                        f"Shape mismatch restoring a sharded tensor into a tensor: snapshot "
                        f"has {list(shape)}, destination has {list(obj_out.shape)}."
                    )
                if device_digests and cls._dst_already_matches(entry, obj_out):
                    return []
                check_restore_cast(entry.dtype, obj_out.dtype, "a sharded tensor into a tensor")
                dst = obj_out
            else:
                dst = torch.empty(shape, dtype=string_to_dtype(entry.dtype))
            boxes = {tuple((0, d) for d in shape): dst} if dst.numel() else {}
            value = dst

        def finalize() -> None:
            if callback is not None:
                callback(value)

        return cls._plan_scatter_reads(entry, boxes, finalize, streams, reshard_roles)

    @staticmethod
    def _plan_scatter_reads(
        entry: ShardedArrayEntry,
        boxes: Dict[Box, torch.Tensor],
        finalize: Callable[[], None],
        streams: DeviceStreams,
        reshard_roles: Optional[Dict[int, Any]] = None,
    ) -> List[ReadReq]:
        """One read per saved piece that overlaps a destination box.
        ``reshard_roles`` (piece index -> ``reshard.OwnerUnit`` or
        ``RecvUnit``) puts single pieces on the planned peer path: an
        owner's consumer decodes and sends bundles, a receiver's takes a
        bundle, and its read request still names the piece's storage
        location, so a peer failure re-reads the same request."""
        relevant = []
        for i, shard in enumerate(entry.shards):
            targets = []
            for box, buf in boxes.items():
                ov = _overlap(shard.offsets, shard.sizes, box)
                if ov is not None:
                    targets.append((buf, ov[0], ov[1]))
            if targets:
                relevant.append((i, shard, targets))
        if not relevant:
            finalize()  # nothing overlaps (an empty local shard)
            return []
        completion = _Completion(len(relevant), finalize)
        read_reqs = []
        for i, shard, targets in relevant:
            consumer: Any = _ShardScatterConsumer(shard, targets, completion, streams)
            role = reshard_roles.get(i) if reshard_roles else None
            if role is not None:
                from .. import reshard as reshard_mod

                if isinstance(role, reshard_mod.OwnerUnit):
                    consumer = reshard_mod.PlannedOwnerConsumer(consumer, role)
                else:
                    consumer = reshard_mod.PlannedRecvConsumer(consumer, role, boxes)
            read_reqs.append(
                ReadReq(
                    path=shard.array.location,
                    buffer_consumer=consumer,
                    byte_range=(
                        tuple(shard.array.byte_range) if shard.array.byte_range is not None else None
                    ),
                    origin=shard.array.origin,
                )
            )
        return read_reqs
