"""Contracts between I/O preparation, the scheduler and storage.

Counterpart of ``torchsnapshot_tpu/io_types.py``: the scheduler moves bytes
and charges their host-memory cost, and stays agnostic of tensors, devices
and pickled objects. Buffer stagers cross the device->host boundary
(pinned staging of CUDA tensors); buffer consumers cross host->device
(in-place copies into destination tensors).

Streaming (io_types.py:30-312 of the JAX package): a stager may produce its
payload as ordered sub-chunks (``can_stream``/``stage_stream``) and a
consumer may take it so (``can_stream``/``consume_stream``); a storage
plugin opts in with ``supports_streaming``/``supports_streaming_reads``
and consumes or produces a :class:`WriteStream`/:class:`ReadStream`. The
scheduler then overlaps sub-chunk N's storage I/O with sub-chunk N+1's
staging or consumption, and charges the memory budget the in-flight window
instead of the whole entry.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import AsyncIterator, List, Optional, Tuple, Union

BufferType = Union[bytes, bytearray, memoryview]

# In-flight sub-chunks per streamed entry on the stager side: the one
# being written plus the one staging ahead. The scheduler charges at least
# this window for a streamed entry.
STREAM_DEPTH = 2


@dataclass
class WriteIO:
    """A single write of a buffer to a storage path."""

    path: str
    buf: BufferType


@dataclass
class WriteStream:
    """An ordered stream of sub-chunk buffers for one storage path.

    ``nbytes`` is the exact payload size, known before the first chunk;
    ``chunks`` yields buffers whose concatenation is the payload. Each
    buffer stays valid while the plugin holds a reference to it (staging
    slabs are recycled by the garbage collector, never in place)."""

    path: str
    nbytes: int
    chunks: AsyncIterator[BufferType]


@dataclass
class ReadIO:
    """A single read of a storage path, optionally a byte range [lo, hi)."""

    path: str
    buf: BufferType = b""
    byte_range: Optional[Tuple[int, int]] = None


@dataclass
class ReadStream:
    """An ordered stream of sub-chunk buffers for one storage read: the
    concatenation of ``chunks`` is what ``StoragePlugin.read`` returns for
    the same request, and ``nbytes`` its size. A yielded buffer is never
    changed by the plugin afterwards."""

    path: str
    nbytes: int
    chunks: AsyncIterator[BufferType]


class StreamRestartRequired(IOError):
    """A streamed read failed mid-stream but the payload can be read again
    from offset 0. The scheduler retries the entry through the buffered
    path; consumers leave no partial commit behind a failed
    ``consume_stream``, which makes the restart safe."""


class BufferStager(abc.ABC):
    """Produces the bytes to be written for one write request. For a CUDA
    tensor, ``stage_buffer`` is where the DtoH copy happens.

    A stager sets ``io_skipped`` during ``stage_buffer`` when the payload
    already lives in an incremental base snapshot: the scheduler then
    releases the buffer without writing it."""

    io_skipped: bool = False

    @abc.abstractmethod
    async def stage_buffer(self, executor=None) -> BufferType:
        ...

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak host memory the staged buffer will occupy."""
        ...

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        """True when this stager can produce its payload in
        ``sub_chunk_bytes`` pieces. Default: buffered staging only."""
        return False

    def stage_stream(self, executor, sub_chunk_bytes: int) -> AsyncIterator[BufferType]:
        """Ordered sub-chunk buffers whose concatenation is exactly the
        payload ``stage_buffer`` would produce, with the same recorded
        checksum. Called only when ``can_stream`` returned True for the
        same size."""
        raise NotImplementedError


class BufferConsumer(abc.ABC):
    """Consumes the bytes read for one read request."""

    @abc.abstractmethod
    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        ...

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        """Peak host memory needed while consuming the buffer."""
        ...

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        """True when this consumer can take its payload in
        ``sub_chunk_bytes`` pieces. Default: buffered consumption only."""
        return False

    def stream_admission_cost(self, sub_chunk_bytes: int) -> int:
        """Peak host memory a streamed consume holds, which the scheduler
        charges instead of ``get_consuming_cost_bytes``. The default is
        the whole payload (a consumer that assembles it in host memory
        before committing); consumers that hold only the in-flight window
        declare that."""
        return self.get_consuming_cost_bytes()

    def streams_on_fast_storage(self) -> bool:
        """Whether streaming pays for this consumer on storage that reads
        at memory speed (the page cache), where a smaller window is the
        only gain; the scheduler's ``auto`` election asks this before it
        streams such a consumer for its window alone."""
        return True

    async def consume_stream(self, stream: "ReadStream", executor=None) -> None:
        """Consume an ordered sub-chunk stream of this request's payload.
        On any mid-stream exception the destination is left as it was, so
        the scheduler may retry the entry buffered."""
        raise NotImplementedError


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[Tuple[int, int]] = None
    # Snapshot URL holding the payload when it is not this snapshot (an
    # incremental take reused it from a base); None for this snapshot.
    origin: Optional[str] = None


class StoragePlugin(abc.ABC):
    """Storage backend interface. Implementations must be safe to drive
    from an asyncio event loop."""

    # True only on plugins whose ``write_stream`` consumes chunks as they
    # come: the scheduler streams writes (and charges the budget a
    # sub-chunk window) only then, since the buffered fallback below
    # holds the whole entry.
    supports_streaming: bool = False
    # The read-side twin, for ``read_stream``.
    supports_streaming_reads: bool = False

    def stream_admission_cost(self, nbytes: int, sub_chunk_bytes: int) -> int:
        """Peak host memory one streamed entry of ``nbytes`` holds while
        this plugin consumes its stream: the chunk being written and the
        one staging ahead. A plugin that keeps consumed chunks declares
        more."""
        return min(nbytes, STREAM_DEPTH * sub_chunk_bytes)

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None:
        ...

    async def write_stream(self, stream: WriteStream) -> None:
        """Consume an ordered sub-chunk stream into one stored object. This
        default is the buffered fallback: it gathers the stream and calls
        ``write``, so every plugin works when a caller streams to it."""
        parts: List[BufferType] = []
        async for chunk in stream.chunks:
            parts.append(chunk)
        # Counted from the parts: a stream that produced fewer bytes than
        # it declared is refused however many parts it had.
        got = sum(memoryview(part).nbytes for part in parts)
        if got != stream.nbytes:
            raise IOError(
                f"short write stream for {stream.path!r}: produced {got} of "
                f"{stream.nbytes} bytes"
            )
        if len(parts) == 1:
            buf: BufferType = parts[0]
        else:
            assembled = bytearray(got)
            pos = 0
            for part in parts:
                mv = memoryview(part).cast("B")
                assembled[pos : pos + mv.nbytes] = mv
                pos += mv.nbytes
            del parts
            buf = assembled
        await self.write(WriteIO(path=stream.path, buf=buf))

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None:
        ...

    async def read_stream(self, read_io: ReadIO, sub_chunk_bytes: int) -> ReadStream:
        """Produce an ordered sub-chunk stream for one read. This default
        is the buffered fallback: the whole ``read``, then slices of it
        (the scheduler never streams reads from such a plugin)."""
        await self.read(read_io)
        mv = memoryview(read_io.buf).cast("B")

        async def chunks() -> AsyncIterator[BufferType]:
            for lo in range(0, mv.nbytes, sub_chunk_bytes):
                yield mv[lo : lo + sub_chunk_bytes]

        return ReadStream(path=read_io.path, nbytes=mv.nbytes, chunks=chunks())

    @abc.abstractmethod
    async def delete(self, path: str) -> None:
        ...

    async def drain_background(self) -> None:
        """Wait for plugin-internal background work (the mirror tier's
        replication) to finish. A take awaits it on every rank before the
        commit barrier. No-op by default."""
        return None

    @abc.abstractmethod
    async def close(self) -> None:
        ...

    def sync_close(self, event_loop) -> None:
        event_loop.run_until_complete(self.close())
