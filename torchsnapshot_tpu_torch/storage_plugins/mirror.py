"""Mirrored (two-tier) storage: a fast primary and a durable mirror written
in the background.

Counterpart of ``torchsnapshot_tpu/storage_plugins/mirror.py``; a snapshot
mirrored by either package restores in the other. Checkpoints land on
fast storage (quick saves, quick restarts after a process crash) and are
replicated to a second tier that survives the machine, without the
training loop waiting on it. ``storage_options={"mirror_url": ...}`` on any
snapshot operation wraps the resolved primary (``storage_plugin.py``).

- ``write`` awaits the primary write, then schedules the mirror write as a
  task on the loop that drives the plugin. The buffer is retained until
  its mirror write completes, bounded by ``mirror_backlog_bytes`` (default
  512 MB): beyond it a write waits instead of holding more memory than
  the scheduler's budget believes is in use.
- ``.snapshot_metadata`` commits the primary at once; its mirror copy is
  written at ``close()``, after every payload's mirror write has drained,
  so a reader of the mirror never sees a committed but incomplete
  snapshot. A take awaits ``drain_background()`` on every rank before
  its commit barrier, so rank 0's mirror commit follows every rank's
  payload mirrors.
- ``read`` tries the primary and falls back to the mirror when the primary
  lost the payload (missing, an OS error, or truncated). Streamed reads
  never splice mirror bytes after primary bytes: a primary that dies
  after yielding bytes raises ``StreamRestartRequired``, and the scheduler
  re-reads the entry buffered.
- Incremental chains: the snapshot metadata records each origin's mirror
  (``origin_mirrors``, propagated at take time), and origin reads are
  wrapped with it, so a chain whose bases were mirrored restores from the
  mirrors alone.
- A failed mirror write does not fail the snapshot (the primary
  committed): the mirror metadata is not written, and ``close()`` raises
  unless ``mirror_strict`` is False.

Failovers go to the telemetry counter ``mirror_failovers`` and to
:data:`failover_counts`, which counts with the bus off too. The
fault-injection site ``mirror.primary_read`` fires before each buffered
primary read.
"""

from __future__ import annotations

import asyncio
import logging
from collections import Counter
from typing import List, Optional, Set

from .. import faultinject, telemetry
from ..io_types import ReadIO, ReadStream, StoragePlugin, StreamRestartRequired, WriteIO
from .retry import attach_fallback_history, classify_error

logger = logging.getLogger(__name__)

DEFAULT_MIRROR_BACKLOG_BYTES = 512 * 1024 * 1024

# Primary read failures the mirror covers: missing files, transport and OS
# errors, and truncation (the fs plugin signals a short object with
# EOFError, which is not an OSError).
_PRIMARY_READ_FAILURES = (FileNotFoundError, OSError, EOFError)

failover_counts: "Counter[str]" = Counter()


class MirroredStoragePlugin(StoragePlugin):
    def __init__(
        self,
        primary: StoragePlugin,
        mirror: StoragePlugin,
        metadata_filename: str,
        backlog_bytes: int = DEFAULT_MIRROR_BACKLOG_BYTES,
        strict: bool = True,
    ) -> None:
        self.primary = primary
        self.mirror = mirror
        self.metadata_filename = metadata_filename
        self.strict = strict
        self._backlog_limit = max(1, backlog_bytes)
        self._backlog_bytes = 0
        self._backlog_cv: Optional[asyncio.Condition] = None
        self._cv_loop: Optional[asyncio.AbstractEventLoop] = None
        self._mirror_tasks: Set[asyncio.Task] = set()
        self._pending_metadata: Optional[bytes] = None
        self._mirror_errors: List[BaseException] = []

    def _cv(self) -> asyncio.Condition:
        """The backlog condition, made on the loop that awaits it: a
        condition binds to the first loop that waits on it, and one plugin
        may be driven by another loop later (a new one for each blocking
        call of the same handle)."""
        loop = asyncio.get_running_loop()
        if self._backlog_cv is None or self._cv_loop is not loop:
            self._backlog_cv = asyncio.Condition()
            self._cv_loop = loop
        return self._backlog_cv

    @property
    def supports_streaming_reads(self) -> bool:
        # Streamed restores read the primary; the mirror only backs a
        # failover, so the election follows the primary's capability.
        return getattr(self.primary, "supports_streaming_reads", False)

    async def _mirror_write(self, path: str, buf) -> None:
        nbytes = memoryview(buf).nbytes
        try:
            await self.mirror.write(WriteIO(path=path, buf=buf))
        except BaseException as e:  # noqa: B036 - recorded, raised at close
            logger.warning("mirror write of %s failed: %s", path, e)
            self._mirror_errors.append(e)
        finally:
            cv = self._cv()
            async with cv:
                self._backlog_bytes -= nbytes
                cv.notify_all()

    async def write(self, write_io: WriteIO) -> None:
        if write_io.path == self.metadata_filename:
            # The primary commits now; the mirror's commit waits for its
            # payloads, in close().
            await self.primary.write(write_io)
            self._pending_metadata = bytes(write_io.buf)
            return
        await self.primary.write(write_io)
        nbytes = memoryview(write_io.buf).nbytes
        cv = self._cv()
        async with cv:
            while self._backlog_bytes > 0 and self._backlog_bytes + nbytes > self._backlog_limit:
                await cv.wait()
            self._backlog_bytes += nbytes
        task = asyncio.get_running_loop().create_task(self._mirror_write(write_io.path, write_io.buf))
        self._mirror_tasks.add(task)
        task.add_done_callback(self._mirror_tasks.discard)

    @staticmethod
    def _record_failover(primary_exc: BaseException, path: str) -> str:
        """Account a primary read failure as storage retries are accounted
        (``retry.classify_error`` kinds), one taxonomy for every fallback."""
        kind = classify_error(primary_exc)
        failover_counts["mirror_failovers"] += 1
        telemetry.counter_add("mirror_failovers", 1)
        telemetry.event("mirror_failover", cat="retry", kind=kind, path=path,
                        error=type(primary_exc).__name__)
        telemetry.flightrec.record("mirror.failover", path=path, kind=kind)
        return kind

    async def read(self, read_io: ReadIO) -> None:
        try:
            faultinject.site("mirror.primary_read")
            await self.primary.read(read_io)
        except _PRIMARY_READ_FAILURES as primary_exc:
            kind = self._record_failover(primary_exc, read_io.path)
            try:
                await self.mirror.read(read_io)
            except BaseException:
                # Both tiers failed: the primary's error propagates with the
                # history attributes a retry exhaustion carries.
                attach_fallback_history(primary_exc, kind=kind)
                raise primary_exc
            logger.info("read %s from the mirror (primary copy missing)", read_io.path)

    async def read_stream(self, read_io: ReadIO, sub_chunk_bytes: int) -> ReadStream:
        """A streamed read with restart-safe failover: a primary that is
        unreadable, or fails before yielding a byte, fails over to a mirror
        stream from offset 0; one that fails after yielding bytes raises
        ``StreamRestartRequired`` (a torn primary's prefix may be wrong and
        no checksum has seen it yet)."""
        try:
            primary_stream = await self.primary.read_stream(read_io, sub_chunk_bytes)
        except _PRIMARY_READ_FAILURES as primary_exc:
            self._record_failover(primary_exc, read_io.path)
            fallback = await self.mirror.read_stream(read_io, sub_chunk_bytes)
            logger.info("streaming %s from the mirror (primary copy missing)", read_io.path)
            return fallback

        async def chunks():
            produced = 0
            try:
                async for chunk in primary_stream.chunks:
                    yield chunk
                    produced += memoryview(chunk).nbytes
            except _PRIMARY_READ_FAILURES as primary_exc:
                kind = self._record_failover(primary_exc, read_io.path)
                if produced:
                    restart = StreamRestartRequired(
                        f"primary failed after streaming {produced} bytes of "
                        f"{read_io.path!r}; re-read the entry from offset 0 (mirror "
                        "bytes are never spliced after primary bytes)"
                    )
                    attach_fallback_history(restart, kind=kind)
                    raise restart from primary_exc
                try:
                    fallback = await self.mirror.read_stream(
                        ReadIO(path=read_io.path, byte_range=read_io.byte_range), sub_chunk_bytes
                    )
                except BaseException:
                    attach_fallback_history(primary_exc, kind=kind)
                    raise primary_exc
                logger.info("streaming %s from the mirror (primary copy missing)", read_io.path)
                async for chunk in fallback.chunks:
                    yield chunk

        return ReadStream(path=read_io.path, nbytes=primary_stream.nbytes, chunks=chunks())

    async def delete(self, path: str) -> None:
        await self.primary.delete(path)
        try:
            await self.mirror.delete(path)
        except FileNotFoundError:
            pass  # the mirror may never have received it (an aborted take)

    async def drain_background(self) -> None:
        """Wait for every scheduled mirror payload write to finish."""
        if self._mirror_tasks:
            await asyncio.gather(*self._mirror_tasks, return_exceptions=True)

    async def close(self) -> None:
        await self.drain_background()
        if self._pending_metadata is not None and not self._mirror_errors:
            try:
                await self.mirror.write(
                    WriteIO(path=self.metadata_filename, buf=self._pending_metadata)
                )
            except BaseException as e:  # noqa: B036 - raised below in strict mode
                logger.warning("mirror metadata commit failed: %s", e)
                self._mirror_errors.append(e)
        elif self._pending_metadata is not None:
            logger.warning(
                "mirror payload write(s) failed; NOT committing mirror metadata: the "
                "mirror copy stays uncommitted and invisible"
            )
        self._pending_metadata = None
        # Both backends close even if one fails, and a strict mirror error
        # (the data-loss signal) outranks a close error.
        close_exc: Optional[BaseException] = None
        for backend in (self.primary, self.mirror):
            try:
                await backend.close()
            except BaseException as e:  # noqa: B036 - raised below
                close_exc = close_exc or e
        if self._mirror_errors and self.strict:
            errors, self._mirror_errors = self._mirror_errors, []
            raise RuntimeError(
                f"{len(errors)} mirror write(s) failed (the primary tier is "
                f"unaffected): {errors[0]!r}"
            ) from errors[0]
        self._mirror_errors = []
        if close_exc is not None:
            raise close_exc
