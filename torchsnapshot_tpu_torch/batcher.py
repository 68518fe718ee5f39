"""Write/read batching: slab-pack small writes, merge ranged reads.

Counterpart of ``torchsnapshot_tpu/batcher.py``. Write batching is opt-in,
with ``TORCHSNAPSHOT_GPU_ENABLE_BATCHING=1``.

Write side: small buffer-protocol array writes are packed into slabs of
about 128 MB under ``batched/<uuid>``; each packed entry's location is
rewritten to the slab with a byte range, so its restore is a ranged read
of the slab. The entries of one slab stage concurrently and are packed by
one ``gather_copy``. Replicated entries are not batched: their locations
are the same on every rank, and slab names are per writer.

Read side: ranged reads of one file (in one snapshot) are merged into
spanning reads that feed several consumers. A spanning read streams: the
one sequential stream is cut at each entry's boundary (:class:`_StreamCursor`)
and each slice goes to its consumer, streamed when the consumer can take a
stream and gathered whole otherwise, so the spanning payload is never held.
"""

from __future__ import annotations

import asyncio
import os
import uuid
from typing import Dict, List, Optional, Tuple

from ._native import gather_copy
from .io_types import (
    STREAM_DEPTH,
    BufferConsumer,
    BufferStager,
    BufferType,
    ReadReq,
    ReadStream,
    WriteReq,
)
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry
from .serialization import Serializer

_SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024
_READ_MERGE_GAP_BYTES = 4 * 1024 * 1024
ENABLE_BATCHING_ENV_VAR = "TORCHSNAPSHOT_GPU_ENABLE_BATCHING"


def batching_enabled() -> bool:
    return os.environ.get(ENABLE_BATCHING_ENV_VAR, "0") not in ("0", "", "false")


def _is_batchable_entry(entry: Entry) -> bool:
    return (
        isinstance(entry, ArrayEntry)
        and entry.serializer == Serializer.BUFFER_PROTOCOL.value
        and entry.byte_range is None
    )


class BatchedBufferStager(BufferStager):
    """Stages its entries concurrently, then packs them into one slab."""

    def __init__(self, stagers: List[BufferStager], offsets: List[int], total: int) -> None:
        self.stagers = stagers
        self.offsets = offsets
        self.total = total

    async def stage_buffer(self, executor=None) -> BufferType:
        bufs = await asyncio.gather(*(s.stage_buffer(executor) for s in self.stagers))
        slab = bytearray(self.total)
        gather_copy(slab, list(zip(self.offsets, bufs)))
        return slab

    def get_staging_cost_bytes(self) -> int:
        # The entries' own staged buffers and the slab are alive together.
        return 2 * self.total


def batch_write_requests(
    entries: List[Entry], write_reqs: List[WriteReq]
) -> Tuple[List[Entry], List[WriteReq]]:
    """Pack batchable write requests into slabs, rewriting the locations and
    byte ranges of their (sub-)entries in place. ``entries`` are the
    manifest entries whose array (sub-)entries match the requests by
    location."""
    req_by_path: Dict[str, WriteReq] = {r.path: r for r in write_reqs}

    candidates: List[Tuple[ArrayEntry, WriteReq]] = []
    for entry in entries:
        if isinstance(entry, ArrayEntry):
            if entry.replicated:
                continue
            sub_entries = [entry]
        elif isinstance(entry, ChunkedArrayEntry):
            if entry.replicated:
                continue
            sub_entries = [c.array for c in entry.chunks]
        else:
            continue
        for sub in sub_entries:
            req = req_by_path.get(sub.location)
            if req is not None and _is_batchable_entry(sub):
                candidates.append((sub, req))

    if len(candidates) < 2:
        return entries, write_reqs

    # Greedy slab packing in path order.
    slabs: List[List[Tuple[ArrayEntry, WriteReq]]] = []
    current: List[Tuple[ArrayEntry, WriteReq]] = []
    current_size = 0
    for sub, req in sorted(candidates, key=lambda t: t[0].location):
        size = req.buffer_stager.get_staging_cost_bytes()
        if size >= _SLAB_SIZE_THRESHOLD_BYTES:
            continue  # large writes gain nothing from batching
        if current and current_size + size > _SLAB_SIZE_THRESHOLD_BYTES:
            slabs.append(current)
            current, current_size = [], 0
        current.append((sub, req))
        current_size += size
    if current:
        slabs.append(current)

    batched_paths = set()
    new_reqs: List[WriteReq] = []
    for slab in slabs:
        if len(slab) < 2:
            continue
        slab_path = f"batched/{uuid.uuid4().hex}"
        offsets: List[int] = []
        stagers: List[BufferStager] = []
        off = 0
        for sub, req in slab:
            size = req.buffer_stager.get_staging_cost_bytes()
            batched_paths.add(sub.location)
            sub.location = slab_path
            sub.byte_range = [off, off + size]
            offsets.append(off)
            stagers.append(req.buffer_stager)
            off += size
        new_reqs.append(
            WriteReq(path=slab_path, buffer_stager=BatchedBufferStager(stagers, offsets, off))
        )

    remaining = [r for r in write_reqs if r.path not in batched_paths]
    return entries, remaining + new_reqs


class BatchedBufferConsumer(BufferConsumer):
    """Feeds slices of one spanning read to several consumers."""

    def __init__(
        self, sub_consumers: List[BufferConsumer], sub_ranges: List[Tuple[int, int]]
    ) -> None:
        self.sub_consumers = sub_consumers
        self.sub_ranges = sub_ranges  # relative to the spanning read

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        view = memoryview(buf)
        await asyncio.gather(
            *(
                c.consume_buffer(view[lo:hi], executor)
                for c, (lo, hi) in zip(self.sub_consumers, self.sub_ranges)
            )
        )

    def get_consuming_cost_bytes(self) -> int:
        # The spanning read holds the whole merged range, gaps included.
        return max(hi for _, hi in self.sub_ranges)

    # ----------------------------------------------------- streaming path

    def _ordered(self) -> List[Tuple[BufferConsumer, Tuple[int, int]]]:
        return sorted(zip(self.sub_consumers, self.sub_ranges), key=lambda t: t[1][0])

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        """Streams when the sub-ranges are disjoint and the span covers at
        least two sub-chunks."""
        prev_hi = 0
        for _, (lo, hi) in self._ordered():
            if lo < prev_hi:
                return False
            prev_hi = hi
        return self.get_consuming_cost_bytes() >= 2 * sub_chunk_bytes

    def stream_admission_cost(self, sub_chunk_bytes: int) -> int:
        # Sub-consumers run one at a time off the sequential stream: the
        # peak is the costliest single slice (a streaming consumer's
        # window, a buffered one's whole slice) plus the chunks in flight.
        worst = 0
        for c, (lo, hi) in zip(self.sub_consumers, self.sub_ranges):
            if c.can_stream(sub_chunk_bytes):
                worst = max(worst, c.stream_admission_cost(sub_chunk_bytes))
            else:
                worst = max(worst, hi - lo)
        return min(self.get_consuming_cost_bytes(), worst + STREAM_DEPTH * sub_chunk_bytes)

    async def consume_stream(self, stream: ReadStream, executor=None) -> None:
        cursor = _StreamCursor(stream.chunks)
        for consumer, (lo, hi) in self._ordered():
            await cursor.skip(lo - cursor.pos)  # gap bytes between entries
            nbytes = hi - lo
            # The incoming chunks are the stream's sub-chunks, so probe with
            # the slice size the consumer would otherwise gather whole.
            if consumer.can_stream(max(1, min(nbytes // 2, _READ_MERGE_GAP_BYTES))):
                await consumer.consume_stream(
                    ReadStream(path=stream.path, nbytes=nbytes, chunks=cursor.slice_stream(nbytes)),
                    executor,
                )
            else:
                buf = bytearray(nbytes)
                pos = 0
                async for piece in cursor.slice_stream(nbytes):
                    buf[pos : pos + piece.nbytes] = piece
                    pos += piece.nbytes
                await consumer.consume_buffer(buf, executor)


class _StreamCursor:
    """A sequential byte cursor over an ordered chunk stream: cuts one
    spanning read into per-entry slices, holding no more than the chunk in
    flight."""

    def __init__(self, chunks) -> None:
        self._it = chunks.__aiter__()
        self._cur: Optional[memoryview] = None
        self._off = 0
        self.pos = 0  # absolute offset within the spanning stream

    async def _next_piece(self, limit: int) -> Optional[memoryview]:
        while self._cur is None or self._off >= self._cur.nbytes:
            try:
                chunk = await self._it.__anext__()
            except StopAsyncIteration:
                return None
            self._cur = memoryview(chunk).cast("B")
            self._off = 0
        take = min(limit, self._cur.nbytes - self._off)
        piece = self._cur[self._off : self._off + take]
        self._off += take
        self.pos += take
        return piece

    async def skip(self, nbytes: int) -> None:
        remaining = nbytes
        while remaining > 0:
            piece = await self._next_piece(remaining)
            if piece is None:
                raise IOError(
                    f"short coalesced read stream: ran out {remaining} bytes into a "
                    f"{nbytes}-byte gap"
                )
            remaining -= piece.nbytes

    async def slice_stream(self, nbytes: int):
        remaining = nbytes
        while remaining > 0:
            piece = await self._next_piece(remaining)
            if piece is None:
                raise IOError(
                    f"short coalesced read stream: missing {remaining} of {nbytes} bytes "
                    "for the current entry"
                )
            remaining -= piece.nbytes
            yield piece


def batch_read_requests(read_reqs: List[ReadReq]) -> List[ReadReq]:
    """Merge byte-range reads of the same file into spanning reads. Reads
    are grouped by origin too: a location of the same name in another
    snapshot is another file."""
    by_path: Dict[tuple, List[ReadReq]] = {}
    out: List[ReadReq] = []
    for req in read_reqs:
        if req.byte_range is None:
            out.append(req)
        else:
            by_path.setdefault((req.path, req.origin), []).append(req)

    for (path, origin), reqs in by_path.items():
        if len(reqs) == 1:
            out.extend(reqs)
            continue
        reqs.sort(key=lambda r: r.byte_range[0])
        group: List[ReadReq] = []
        group_hi: Optional[int] = None

        def flush() -> None:
            if not group:
                return
            if len(group) == 1:
                out.append(group[0])
                return
            lo = group[0].byte_range[0]
            hi = max(r.byte_range[1] for r in group)
            out.append(
                ReadReq(
                    path=path,
                    buffer_consumer=BatchedBufferConsumer(
                        [r.buffer_consumer for r in group],
                        [(r.byte_range[0] - lo, r.byte_range[1] - lo) for r in group],
                    ),
                    byte_range=(lo, hi),
                    origin=origin,
                )
            )

        for req in reqs:
            lo, hi = req.byte_range
            if group_hi is not None and lo - group_hi <= _READ_MERGE_GAP_BYTES:
                group.append(req)
                group_hi = max(group_hi, hi)
            else:
                flush()
                group = [req]
                group_hi = hi
        flush()
    return out
