"""GCS storage plugin (the port's copy of
``torchsnapshot_tpu/storage_plugins/gcs.py``; reference:
storage_plugins/gcs.py:47-270).

Built on google-cloud-storage's sync client driven through the dedicated
bounded cloud-I/O pool (retry.cloud_io_executor): writes stream from host
memory, pinned staging slabs included, to GCS while the next step runs on
the device. A pre-built bucket can be injected via
``storage_options={"bucket": ...}`` (the fake-backed tests do).

Capabilities mirroring the reference, realized independently:

- **Chunked transfers** (reference: 100 MB chunks, gcs.py:41): downloads are
  split into ranged chunk GETs; uploads delegate to the SDK's resumable
  protocol via ``blob.chunk_size``.
- **Upload-recovery rewind** (reference: gcs.py:109-122): the streamed
  buffer is seekable (MemoryviewStream), and a retried upload rewinds it to
  zero before resending.
- **Transient-error classification** (reference: gcs.py:87-107): 429/5xx,
  connection and timeout failures retry; everything else propagates.
- **Collective retry strategy** (reference: _RetryStrategy, gcs.py:214-270):
  all concurrent transfer coroutines share one deadline that is *refreshed
  by anyone's progress* — a slow-but-advancing fleet never times out, a
  globally-stalled fleet fails together, and per-attempt waits use
  exponential backoff with jitter. The strategy is transport-agnostic and
  single-event-loop only (the reference documents the same constraint).
"""

from __future__ import annotations

import asyncio
import io
import logging
import threading
from typing import Any, Callable, Dict, List, Optional

from .. import faultinject, telemetry
from ..io_types import ReadIO, ReadStream, StoragePlugin, WriteIO, WriteStream
from .retry import (
    CollectiveRetryStrategy,
    cloud_io_executor,
    is_transient_error,
    named,
    observe_storage_op,
    ordered_window_chunks,
)

# Back-compat aliases: the retry machinery moved to .retry when it became
# shared with the S3 plugin.
_is_transient = is_transient_error

logger = logging.getLogger(__name__)

DEFAULT_CHUNK_SIZE_BYTES = 100 * 1024 * 1024
# Concurrent ranged-chunk GETs per entry: single-large-entry restores are
# otherwise bounded by one HTTP stream (cross-entry concurrency alone
# doesn't help a 10 GB single-tensor load).
_RANGED_READ_CONCURRENCY = 4


class _ChunkFeedStream(io.RawIOBase):
    """File-like bridge between the async sub-chunk producer and the
    SDK's blocking resumable upload: the event loop appends chunks as
    staging lands them; the upload thread's ``readinto`` serves retained
    bytes and BLOCKS (off the event loop, in the cloud-I/O executor)
    until the next chunk arrives. Consumed chunks are retained until the
    upload commits so ``seek(0)`` can replay the whole stream for the
    collective retry path — bounded by the entry size, which the
    upstream ≤512 MB chunk/shard split caps, and the price of keeping
    the resumable protocol's rewind contract while upload overlaps
    staging."""

    def __init__(self, nbytes: int) -> None:
        super().__init__()
        self._nbytes = nbytes
        self._chunks: List[memoryview] = []
        self._have = 0  # bytes appended so far
        self._pos = 0
        self._failed: Optional[BaseException] = None
        self._cond = threading.Condition()

    # -- producer side (event loop) --

    def feed(self, chunk) -> None:
        mv = memoryview(faultinject.mutate("gcs.resumable_feed", chunk)).cast("B")
        with self._cond:
            self._chunks.append(mv)
            self._have += mv.nbytes
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Wake a blocked reader when staging dies: without this the
        upload thread would wait forever for bytes that never come."""
        with self._cond:
            self._failed = exc
            self._cond.notify_all()

    # -- consumer side (upload thread) --

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += self._nbytes
        self._pos = max(0, pos)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        """Fill ``b`` COMPLETELY unless EOF arrives first: upload clients
        read in protocol-chunk units and treat a short read as EOF, so
        partial raw reads would truncate the object. Blocks (in the
        upload thread, never the event loop) for chunks staging hasn't
        produced yet."""
        out = memoryview(b).cast("B")
        served = 0
        while served < out.nbytes and self._pos < self._nbytes:
            with self._cond:
                while self._have <= self._pos and self._failed is None:
                    self._cond.wait(timeout=1.0)
                if self._failed is not None and self._have <= self._pos:
                    raise self._failed
            # Serve from the retained chunks at self._pos (no lock
            # needed: chunks are append-only and _pos is reader-owned).
            skip = self._pos
            for mv in self._chunks:
                if skip >= mv.nbytes:
                    skip -= mv.nbytes
                    continue
                take = min(mv.nbytes - skip, out.nbytes - served)
                out[served : served + take] = mv[skip : skip + take]
                served += take
                self._pos += take
                skip = 0
                if served == out.nbytes:
                    break
        return served


class GCSStoragePlugin(StoragePlugin):
    supports_streaming = True
    supports_streaming_reads = True

    def __init__(self, root: str, storage_options: Optional[Dict[str, Any]] = None):
        options = storage_options or {}
        bucket_name, _, self.prefix = root.partition("/")
        self.chunk_size_bytes = int(
            options.get("chunk_size_bytes", DEFAULT_CHUNK_SIZE_BYTES)
        )
        self.retry_strategy: CollectiveRetryStrategy = options.get(
            "retry_strategy"
        ) or CollectiveRetryStrategy()
        # A plugin is constructed per snapshot operation: a strategy reused
        # across operations must not inherit the previous fleet's deadline.
        self.retry_strategy.reset()
        self.bucket = options.get("bucket") or self._make_bucket(
            bucket_name, options
        )

    @staticmethod
    def _make_bucket(bucket_name: str, options: Dict[str, Any]):
        try:
            from google.cloud import storage as gcs
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "GCS support requires the google-cloud-storage package."
            ) from e
        client = gcs.Client(**options.get("client_options", {}))
        return client.bucket(bucket_name)

    def _blob_path(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    async def _retrying(self, fn: Callable[[], Any]) -> Any:
        """Run blocking ``fn`` on the dedicated cloud-I/O pool under the
        collective retry strategy; successful completion reports fleet
        progress (see retry.cloud_io_executor)."""
        loop = asyncio.get_running_loop()
        attempt = 0
        slept_s = 0.0
        op = getattr(fn, "__name__", None)
        while True:
            started = telemetry.monotonic()
            try:
                result = await loop.run_in_executor(cloud_io_executor(), fn)
                self.retry_strategy.report_progress()
                observe_storage_op(
                    type(self).__name__, op, telemetry.monotonic() - started
                )
                return result
            except BaseException as e:  # noqa: B036
                if not _is_transient(e):
                    raise
                slept_s += await self.retry_strategy.backoff_or_raise(
                    e,
                    attempt,
                    op_started_at=started,
                    op=op,
                    backoff_slept_s=slept_s,
                )
                attempt += 1

    async def write(self, write_io: WriteIO) -> None:
        from ..memoryview_stream import MemoryviewStream

        blob = self.bucket.blob(self._blob_path(write_io.path))
        mv = memoryview(write_io.buf)
        if mv.nbytes > self.chunk_size_bytes:
            # The SDK switches to the resumable protocol when chunk_size is
            # set, uploading chunk_size pieces with its own per-chunk
            # recovery — the chunked-upload path.
            blob.chunk_size = self.chunk_size_bytes
        stream = MemoryviewStream(mv)

        def upload() -> None:
            # Rewind before every attempt: a failed attempt may have
            # consumed part of the stream (upload-recovery rewind).
            stream.seek(0)
            blob.upload_from_file(stream, size=mv.nbytes)

        await self._retrying(upload)

    def stream_admission_cost(self, nbytes: int, sub_chunk_bytes: int) -> int:
        """Full size: the resumable-retry rewind contract forces
        _ChunkFeedStream to retain every consumed chunk until the upload
        commits, so a streamed entry's real memory equals a buffered
        one's — what GCS streaming buys is the transfer OVERLAPPING
        staging, not a smaller footprint. Declaring the honest cost
        keeps the scheduler's per-rank budget bounding actual memory."""
        return nbytes

    async def write_stream(self, stream: WriteStream) -> None:
        """Streaming write: sub-chunks feed the SDK's resumable protocol
        (``blob.chunk_size`` set, so the SDK sends chunk_size pieces with
        its own per-chunk recovery) WHILE later sub-chunks are still
        being staged. Consumed chunks stay retained until commit so a
        collective-retry rewind can replay the stream — same memory bound
        as the buffered path, but the network transfer overlaps staging
        instead of starting after it. Sub-resumable-chunk payloads fall
        back to the buffered single upload."""
        if stream.nbytes <= self.chunk_size_bytes:
            await super().write_stream(stream)
            return
        blob = self.bucket.blob(self._blob_path(stream.path))
        blob.chunk_size = self.chunk_size_bytes
        feed = _ChunkFeedStream(stream.nbytes)

        def upload() -> None:
            # Rewind before every attempt: retained chunks replay, then
            # the reader blocks for whatever staging hasn't produced yet.
            feed.seek(0)
            blob.upload_from_file(feed, size=stream.nbytes)

        upload_task = asyncio.ensure_future(self._retrying(upload))
        try:
            total = 0
            async for chunk in stream.chunks:
                total += memoryview(chunk).cast("B").nbytes
                feed.feed(chunk)
                if upload_task.done():
                    break  # surface the upload's failure promptly
            if total != stream.nbytes and not upload_task.done():
                exc = IOError(
                    f"short write stream for {stream.path!r}: produced "
                    f"{total} of {stream.nbytes} bytes"
                )
                feed.fail(exc)
                raise exc
        except BaseException as e:
            feed.fail(e)
            upload_task.cancel()
            await asyncio.gather(upload_task, return_exceptions=True)
            raise
        await upload_task

    async def read(self, read_io: ReadIO) -> None:
        blob = self.bucket.blob(self._blob_path(read_io.path))

        def _faulted_download(**kw) -> bytes:
            # The one registered 'gcs.get' call site (the lint pins one
            # literal per name), shared by the whole-object and ranged
            # branches and invoked INSIDE the retried closures — like
            # s3.get — so injected transient faults exercise the real
            # retry path instead of escaping after a successful fetch.
            return faultinject.mutate("gcs.get", blob.download_as_bytes(**kw))

        if read_io.byte_range is None:
            # Unknown size: a single GET (the SDK streams the body) — no
            # metadata round-trip, and cross-entry concurrency already
            # keeps the pipe full on the common many-small-files restore.
            # (Payloads are capped by the 512 MB chunk/shard split upstream,
            # so whole-GET retry granularity is acceptable; the bytes land
            # in ReadIO.buf uncopied.)
            read_io.buf = await self._retrying(_faulted_download)
            return

        lo, hi = read_io.byte_range
        if hi <= lo:
            # Empty/inverted range: GCS answers 416 for such ranges —
            # short-circuit so direct plugin users don't depend on the
            # scheduler's guard.
            read_io.buf = bytearray()
            return
        out = bytearray(hi - lo)
        ranges = []
        pos = lo
        while pos < hi:
            ranges.append((pos, min(pos + self.chunk_size_bytes, hi)))
            pos = ranges[-1][1]

        # Fetch chunks concurrently (bounded): a single large entry is no
        # longer limited to one stream's throughput.
        sem = asyncio.Semaphore(_RANGED_READ_CONCURRENCY)

        async def fetch(p: int, q: int) -> None:
            def download() -> bytes:
                # GCS byte ranges are end-inclusive.
                return _faulted_download(start=p, end=q - 1)

            async with sem:
                chunk = await self._retrying(download)
            if len(chunk) != q - p:
                # A short ranged response means the object changed or was
                # truncated mid-read; silently zero-filling the gap would
                # corrupt restored data.
                raise IOError(
                    f"short read on {read_io.path}: got {len(chunk)} bytes "
                    f"for range [{p}, {q})"
                )
            out[p - lo : p - lo + len(chunk)] = chunk

        tasks = [asyncio.ensure_future(fetch(p, q)) for p, q in ranges]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            # Cancel sibling fetches (and their retry/backoff loops) on the
            # first failure instead of letting them run unawaited.
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        read_io.buf = out

    async def read_stream(self, read_io: ReadIO, sub_chunk_bytes: int) -> ReadStream:
        """Streaming read: the ranged download loop reshaped into an
        ORDERED stream — a bounded window of ``_RANGED_READ_CONCURRENCY``
        chunk downloads stays in flight and chunks are yielded in offset
        order, so the consumer works on chunk N while N+1.. are still on
        the wire. Full-object streams learn the size from one metadata
        reload (the stream contract requires ``nbytes`` up front)."""
        blob = self.bucket.blob(self._blob_path(read_io.path))
        if read_io.byte_range is None:
            await self._retrying(named(blob.reload, "reload"))
            lo, hi = 0, int(blob.size)
        else:
            lo, hi = read_io.byte_range
        size = max(0, hi - lo)

        def fetch(p: int, q: int) -> "asyncio.Future":
            def download() -> bytes:
                # GCS byte ranges are end-inclusive.
                return blob.download_as_bytes(start=p, end=q - 1)

            return asyncio.ensure_future(
                self._retrying(named(download, "get_range"))
            )

        async def chunks():
            if size <= 0:
                return
            spans = [
                (o, min(o + sub_chunk_bytes, hi))
                for o in range(lo, hi, sub_chunk_bytes)
            ]
            async for chunk in ordered_window_chunks(
                read_io.path, spans, fetch, _RANGED_READ_CONCURRENCY
            ):
                yield chunk

        return ReadStream(path=read_io.path, nbytes=size, chunks=chunks())

    async def delete(self, path: str) -> None:
        blob = self.bucket.blob(self._blob_path(path))
        await self._retrying(blob.delete)

    async def close(self) -> None:
        pass
