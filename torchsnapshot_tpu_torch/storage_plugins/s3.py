"""S3 storage plugin (the port's copy of
``torchsnapshot_tpu/storage_plugins/s3.py``; reference:
storage_plugins/s3.py:15-70).

boto3's sync client driven through the dedicated bounded cloud-I/O pool
(retry.cloud_io_executor — transfer concurrency independent of the host's
core count and of unrelated executor work); ranged GETs
use the HTTP Range header (reference: s3.py:53-60). Staged memoryviews are
streamed via MemoryviewStream without copying (reference: s3.py:38-39).

Beyond the reference: transfers run under the same
:class:`~.retry.CollectiveRetryStrategy` as the GCS plugin — transient
errors (throttling, 5xx, connection resets) retry with fleet-shared stall
detection, a retried upload rewinds its stream before resending, and
payloads >= 512 MiB upload via the multipart protocol (bounded part
concurrency, per-part retry, abort-on-failure) instead of hitting S3's
5 GiB single-PUT ceiling mid-save.

A pre-built client can be injected via ``storage_options={"client": ...}``
(used by the fake-backed tests, mirroring the GCS plugin's ``bucket``
injection).
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, Callable, Dict, Optional

from .. import telemetry
from ..io_types import ReadIO, ReadStream, StoragePlugin, WriteIO, WriteStream
from .. import faultinject
from .retry import (
    CollectiveRetryStrategy,
    cloud_io_executor,
    is_transient_error,
    named,
    observe_storage_op,
    ordered_window_chunks,
)

# S3 hard limit for single-request PUTs is 5 GiB (and 5 TiB per object via
# multipart). Array payloads are chunk/shard-split well below this upstream,
# but ObjectEntry pickles (tokenizers, dataset state) are unbounded —
# uploads at/above the threshold switch to the multipart protocol.
MULTIPART_THRESHOLD_BYTES = 512 << 20
MULTIPART_PART_BYTES = 256 << 20  # AWS minimum is 5 MiB/part, 10k parts max
_MULTIPART_CONCURRENCY = 4
# Ranged GETs past this size split into concurrent chunk GETs so a
# single-large-entry restore is not bounded by one HTTP stream.
RANGED_READ_CHUNK_BYTES = 100 << 20
_RANGED_READ_CONCURRENCY = 4


class S3StoragePlugin(StoragePlugin):
    supports_streaming = True
    supports_streaming_reads = True

    def __init__(self, root: str, storage_options: Optional[Dict[str, Any]] = None):
        options = storage_options or {}
        self.bucket, _, self.prefix = root.partition("/")
        self.retry_strategy: CollectiveRetryStrategy = options.get(
            "retry_strategy"
        ) or CollectiveRetryStrategy()
        # A plugin is constructed per snapshot operation: a strategy reused
        # across operations must not inherit the previous fleet's deadline.
        self.retry_strategy.reset()
        self.multipart_threshold = int(
            options.get("multipart_threshold", MULTIPART_THRESHOLD_BYTES)
        )
        self.client = options.get("client") or self._make_client(options)

    @staticmethod
    def _make_client(options: Dict[str, Any]):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "S3 support requires the boto3 package (not installed in this "
                "environment). Install boto3, pass a client via "
                "storage_options={'client': ...}, or use fs:// / gs:// storage."
            ) from e
        return boto3.client("s3", **options.get("client_options", {}))

    def _key(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    async def _retrying(self, fn: Callable[[], Any]) -> Any:
        """Run blocking ``fn`` on the dedicated cloud-I/O pool under the
        collective retry strategy; successful completion reports fleet
        progress. (The default loop executor is NOT used: transfer
        concurrency must not compete with unrelated executor work or
        shrink with the host's core count.)"""
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
                if not is_transient_error(e):
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

        mv = memoryview(write_io.buf)
        key = self._key(write_io.path)
        if mv.nbytes >= self.multipart_threshold:
            await self._multipart_upload(key, mv)
            return

        def put() -> None:
            # A fresh (possibly fault-mutated) stream per attempt; the
            # injection point sits INSIDE the retried closure so injected
            # transient faults exercise the real retry path. Rewinding is
            # implicit — every attempt streams without copying from the
            # start of the staged memoryview (bytearray slabs included).
            body = MemoryviewStream(
                memoryview(faultinject.mutate("s3.put", mv))
            )
            self.client.put_object(Bucket=self.bucket, Key=key, Body=body)

        await self._retrying(put)

    async def _multipart_upload(self, key: str, mv: memoryview) -> None:
        """Multipart PUT for payloads past the single-request limit zone:
        parts upload concurrently (bounded) with per-part retry; any
        failure aborts the upload server-side so incomplete parts don't
        accrue storage."""
        from ..memoryview_stream import MemoryviewStream

        create = await self._retrying(
            lambda: self.client.create_multipart_upload(Bucket=self.bucket, Key=key)
        )
        upload_id = create["UploadId"]
        bounds = list(range(0, mv.nbytes, MULTIPART_PART_BYTES)) + [mv.nbytes]
        sem = asyncio.Semaphore(_MULTIPART_CONCURRENCY)

        async def put_part(number: int, lo: int, hi: int) -> Dict[str, Any]:
            piece = mv[lo:hi]

            def put() -> Dict[str, Any]:
                # A fresh stream over the same view each attempt: a retry
                # rewinds to the part's first byte with no copy.
                stream = MemoryviewStream(memoryview(faultinject.mutate("s3.put_part", piece)))
                return self.client.upload_part(
                    Bucket=self.bucket,
                    Key=key,
                    UploadId=upload_id,
                    PartNumber=number,
                    Body=stream,
                )

            async with sem:
                resp = await self._retrying(put)
            return {"ETag": resp["ETag"], "PartNumber": number}

        tasks = [
            asyncio.ensure_future(put_part(i + 1, lo, hi))
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))
        ]
        try:
            parts = list(await asyncio.gather(*tasks))
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await self._abort_multipart(key, upload_id)
            raise
        await self._complete_multipart(key, upload_id, parts, mv.nbytes)

    async def _abort_multipart(self, key: str, upload_id: str) -> None:
        with contextlib.suppress(Exception):
            await self._retrying(
                lambda: self.client.abort_multipart_upload(
                    Bucket=self.bucket, Key=key, UploadId=upload_id
                )
            )

    async def _complete_multipart(
        self, key: str, upload_id: str, parts: list, total_nbytes: int
    ) -> None:
        # CompleteMultipartUpload is not idempotent: a transient failure
        # AFTER the server committed (e.g. connection reset while reading
        # the response) makes the retry hit a dead upload id. Before each
        # retry, treat an existing object as success — the key was created
        # by this upload. (A lost CREATE response can still orphan an
        # upload id; S3's AbortIncompleteMultipartUpload lifecycle rule is
        # the standard backstop for that.)
        sent_once = False

        def complete() -> None:
            nonlocal sent_once
            if sent_once:
                try:
                    head = self.client.head_object(Bucket=self.bucket, Key=key)
                    # Size-check before declaring success: a STALE object
                    # at this key (snapshot re-taken to the same URL) must
                    # not be mistaken for this upload's commit.
                    if head.get("ContentLength") == total_nbytes:
                        return  # a prior attempt committed server-side
                except Exception:
                    pass
            sent_once = True
            self.client.complete_multipart_upload(
                Bucket=self.bucket,
                Key=key,
                UploadId=upload_id,
                MultipartUpload={"Parts": sorted(parts, key=lambda p: p["PartNumber"])},
            )

        await self._retrying(complete)

    def stream_admission_cost(self, nbytes: int, sub_chunk_bytes: int) -> int:
        """Real retention of a streamed entry: sub-threshold payloads
        fall back to the buffered PUT (full size held), larger ones hold
        at most the bounded in-flight part window (write_stream applies
        backpressure to enforce exactly this) plus the part being
        accumulated and the stager's lookahead chunk."""
        if nbytes < self.multipart_threshold:
            return nbytes
        window = (_MULTIPART_CONCURRENCY + 1) * MULTIPART_PART_BYTES
        return min(nbytes, window + MULTIPART_PART_BYTES + sub_chunk_bytes)

    async def write_stream(self, stream: WriteStream) -> None:
        """Streaming write: sub-chunks accumulate into multipart parts
        that upload WHILE later sub-chunks are still being staged — the
        intra-entry overlap the buffered path only gets across entries.
        Each part is retained only until its upload succeeds (per-part
        retry needs its bytes), and the producer loop applies
        BACKPRESSURE: it stops pulling sub-chunks while more than
        ``_MULTIPART_CONCURRENCY + 1`` part payloads are in flight, so
        retained memory matches ``stream_admission_cost`` instead of
        racing ahead of a slow link toward the full entry. Payloads
        under the multipart threshold fall back to the buffered single
        PUT — S3 parts below 5 MiB are rejected, and a sub-threshold
        object gains nothing from the protocol's extra round trips."""
        if stream.nbytes < self.multipart_threshold:
            await super().write_stream(stream)
            return
        from ..memoryview_stream import MemoryviewStream

        key = self._key(stream.path)
        create = await self._retrying(
            lambda: self.client.create_multipart_upload(Bucket=self.bucket, Key=key)
        )
        upload_id = create["UploadId"]
        sem = asyncio.Semaphore(_MULTIPART_CONCURRENCY)
        tasks = []

        async def put_part(number: int, payload) -> Dict[str, Any]:
            def put() -> Dict[str, Any]:
                return self.client.upload_part(
                    Bucket=self.bucket,
                    Key=key,
                    UploadId=upload_id,
                    PartNumber=number,
                    Body=MemoryviewStream(
                        memoryview(faultinject.mutate("s3.put_part", payload))
                    ),
                )

            async with sem:
                resp = await self._retrying(put)
            return {"ETag": resp["ETag"], "PartNumber": number}

        def flush(acc: list, acc_bytes: int, number: int):
            if len(acc) == 1:
                payload = acc[0]
            else:
                payload = bytearray(acc_bytes)
                pos = 0
                for piece in acc:
                    piece_mv = memoryview(piece).cast("B")
                    payload[pos : pos + piece_mv.nbytes] = piece_mv
                    pos += piece_mv.nbytes
            tasks.append(asyncio.ensure_future(put_part(number, payload)))

        try:
            acc: list = []
            acc_bytes = 0
            total = 0
            number = 1
            async for chunk in stream.chunks:
                mv = memoryview(chunk).cast("B")
                acc.append(mv)
                acc_bytes += mv.nbytes
                total += mv.nbytes
                if acc_bytes >= MULTIPART_PART_BYTES:
                    # Backpressure BEFORE buffering another part: wait
                    # until the in-flight payload window has room, so a
                    # fast stager can't pile the whole entry into queued
                    # part tasks ahead of a slow link.
                    while (
                        sum(1 for t in tasks if not t.done())
                        > _MULTIPART_CONCURRENCY
                    ):
                        await asyncio.wait(
                            [t for t in tasks if not t.done()],
                            return_when=asyncio.FIRST_COMPLETED,
                        )
                    flush(acc, acc_bytes, number)
                    number += 1
                    acc, acc_bytes = [], 0
            if acc:
                flush(acc, acc_bytes, number)
            if total != stream.nbytes:
                raise IOError(
                    f"short write stream for {stream.path!r}: produced "
                    f"{total} of {stream.nbytes} bytes"
                )
            parts = list(await asyncio.gather(*tasks))
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await self._abort_multipart(key, upload_id)
            raise
        await self._complete_multipart(key, upload_id, parts, stream.nbytes)

    async def read(self, read_io: ReadIO) -> None:
        key = self._key(read_io.path)
        if read_io.byte_range is not None:
            lo, hi = read_io.byte_range
            if hi <= lo:
                # Empty/inverted range: S3 rejects such Range headers with
                # InvalidRange — short-circuit so direct plugin users don't
                # depend on the scheduler's guard.
                read_io.buf = bytearray()
                return
            if hi - lo > RANGED_READ_CHUNK_BYTES:
                # Split a large ranged GET into concurrent chunk GETs (the
                # GCS plugin's pattern): a single-large-entry restore is
                # otherwise bounded by one HTTP stream's throughput.
                await self._chunked_ranged_read(read_io, key, lo, hi)
                return

        kwargs: Dict[str, Any] = {"Bucket": self.bucket, "Key": key}
        if read_io.byte_range is not None:
            lo, hi = read_io.byte_range
            kwargs["Range"] = f"bytes={lo}-{hi - 1}"  # inclusive; zero-length
            # ranges are short-circuited upstream (scheduler.read_and_consume)

        def get() -> bytes:
            return faultinject.mutate(
                "s3.get", self.client.get_object(**kwargs)["Body"].read()
            )

        buf = await self._retrying(get)
        if read_io.byte_range is not None:
            lo, hi = read_io.byte_range
            if len(buf) != hi - lo:
                # A short ranged response means the object changed or was
                # truncated mid-read; zero-filling would corrupt data.
                raise IOError(
                    f"short read on {read_io.path}: got {len(buf)} bytes "
                    f"for range [{lo}, {hi})"
                )
        read_io.buf = buf  # uncopied bytes

    async def read_stream(self, read_io: ReadIO, sub_chunk_bytes: int) -> ReadStream:
        """Streaming read: the existing concurrent-ranged-GET pattern,
        reshaped into an ORDERED stream — a bounded window of
        ``_RANGED_READ_CONCURRENCY`` chunk GETs is kept in flight and
        chunks are yielded in offset order, so the consumer hashes/
        decompresses chunk N while chunks N+1.. are still on the wire.
        Full-object streams learn the size from one HEAD request (the
        stream contract requires ``nbytes`` up front)."""
        key = self._key(read_io.path)
        if read_io.byte_range is None:
            head = await self._retrying(
                named(
                    lambda: self.client.head_object(Bucket=self.bucket, Key=key),
                    "head",
                )
            )
            lo, hi = 0, int(head["ContentLength"])
        else:
            lo, hi = read_io.byte_range
        size = max(0, hi - lo)

        def fetch(p: int, q: int) -> "asyncio.Future":
            def get() -> bytes:
                return self.client.get_object(
                    Bucket=self.bucket, Key=key, Range=f"bytes={p}-{q - 1}"
                )["Body"].read()

            return asyncio.ensure_future(self._retrying(named(get, "get_range")))

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

    async def _chunked_ranged_read(
        self, read_io: ReadIO, key: str, lo: int, hi: int
    ) -> None:
        out = bytearray(hi - lo)
        ranges = []
        pos = lo
        while pos < hi:
            ranges.append((pos, min(pos + RANGED_READ_CHUNK_BYTES, hi)))
            pos = ranges[-1][1]
        sem = asyncio.Semaphore(_RANGED_READ_CONCURRENCY)

        async def fetch(p: int, q: int) -> None:
            def get() -> bytes:
                return self.client.get_object(
                    Bucket=self.bucket, Key=key, Range=f"bytes={p}-{q - 1}"
                )["Body"].read()

            async with sem:
                chunk = await self._retrying(get)
            if len(chunk) != q - p:
                raise IOError(
                    f"short read on {read_io.path}: got {len(chunk)} bytes "
                    f"for range [{p}, {q})"
                )
            out[p - lo : p - lo + len(chunk)] = chunk

        tasks = [asyncio.ensure_future(fetch(p, q)) for p, q in ranges]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        read_io.buf = out

    async def delete(self, path: str) -> None:
        key = self._key(path)
        await self._retrying(
            lambda: self.client.delete_object(Bucket=self.bucket, Key=key)
        )

    async def close(self) -> None:
        pass
