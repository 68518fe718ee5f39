"""Local filesystem storage plugin.

Counterpart of ``torchsnapshot_tpu/storage_plugins/fs.py``. Blocking file
calls run in the event loop's thread pool, so they overlap with staging. Writes are atomic: each file lands through a temp
file and ``os.replace``, so a crash never leaves a truncated payload and
the ``.snapshot_metadata`` commit point is all-or-nothing.
``TORCHSNAPSHOT_GPU_FSYNC=1`` also fsyncs each temp file before its rename
and the parent directory after it, so a published file survives a power
loss (fs.py:37-105 of the JAX package; off by default, since every write
then waits for the drive). Reads of 1 MiB and more map the file privately
instead of copying it out of the page cache.

Streams (fs.py:125-490 of the JAX package): ``write_stream`` lands each
sub-chunk by a positional write into the same temp file and publishes it
with ``os.replace`` after the last one, under the same fsync contract;
``read_stream`` yields sub-chunk windows read by ``preadv`` into staging
slabs, one window ahead of the consumer. When the I/O governor elects the
native engine (``native_io.py``), the sub-chunk transfers are queued as
io_uring SQEs instead, ``queue_depth`` deep, and the engine's rate is
recorded under ``FSStoragePlugin.native``. Fault-injection sites
(``faultinject.py``): ``fs.write``, ``fs.pwrite``, ``fs.read``,
``fs.pread``, ``fs.native_pwrite``, ``fs.native_pread``.
"""

from __future__ import annotations

import asyncio
import itertools
import mmap
import os
import time
from typing import Set

from .. import faultinject
from ..io_types import ReadIO, ReadStream, StoragePlugin, WriteIO, WriteStream

FSYNC_ENV_VAR = "TORCHSNAPSHOT_GPU_FSYNC"
MMAP_ENV_VAR = "TORCHSNAPSHOT_GPU_MMAP_READS"
_MMAP_MIN_BYTES = 1 << 20
_tmp_counter = itertools.count()


def _fsync_enabled() -> bool:
    value = os.environ.get(FSYNC_ENV_VAR, "0").strip().lower()
    return value not in ("", "0", "false", "no", "off")


def _fsync_path(path: str) -> None:
    """fsync of a file or directory by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, buf, fsync: bool = False) -> None:
    mv = memoryview(buf).cast("B")
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
    try:
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            written = 0
            while written < mv.nbytes:
                written += os.write(fd, mv[written:])
            if fsync:
                os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        if fsync:
            # The rename reaches the disk only with its directory entry.
            _fsync_path(os.path.dirname(path) or ".")
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _mmap_enabled() -> bool:
    """Large reads map the file unless ``MMAP_ENV_VAR`` is ``0``, ``false``,
    ``no`` or ``off`` (the JAX package's ``_mmap_enabled``), for stores
    where a private map is unwanted."""
    value = os.environ.get(MMAP_ENV_VAR, "1").strip().lower()
    return value not in ("0", "false", "no", "off")


def _read_file(path: str, lo: int, size: int):
    with open(path, "rb") as f:
        fsize = os.fstat(f.fileno()).st_size
        if lo + size > fsize:
            raise EOFError(
                f"short read: {path} is {fsize} bytes; range [{lo}, {lo + size}) "
                "extends past EOF"
            )
        if size >= _MMAP_MIN_BYTES and _mmap_enabled():
            gran = mmap.ALLOCATIONGRANULARITY
            aligned = lo - lo % gran
            m = mmap.mmap(
                f.fileno(),
                size + lo - aligned,
                flags=mmap.MAP_PRIVATE,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=aligned,
            )
            return memoryview(m)[lo - aligned : lo - aligned + size]
        f.seek(lo)
        buf = bytearray(size)
        view = memoryview(buf)
        got = 0
        while got < size:
            n = f.readinto(view[got:])
            if not n:
                raise EOFError(f"short read: {path} yielded {got} of {size} bytes")
            got += n
        return buf


def _remove_quietly(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _pwrite_all(fd: int, buf, offset: int) -> int:
    """Positional write of the whole buffer at ``offset``; returns the
    bytes written. pwrite moves no shared file offset."""
    mv = memoryview(faultinject.mutate("fs.pwrite", buf)).cast("B")
    written = 0
    while written < mv.nbytes:
        written += os.pwrite(fd, mv[written:], offset + written)
    return written


def _window_buffer(size: int, sub_chunk_bytes: int):
    """A writable buffer of ``size`` bytes for one read window of a stream
    of ``sub_chunk_bytes`` windows: the start of a staging slab of the
    stream's size class (recycled by the garbage collector once every view
    of it dies, so reuse never aliases a live chunk), else a bytearray."""
    from ..io_preparers.array import pooled_buffer, stream_slab_bytes

    slab = pooled_buffer(stream_slab_bytes(sub_chunk_bytes))
    return slab.numpy()[:size] if slab is not None else bytearray(size)


def _pread_exact(fd: int, lo: int, hi: int, sub_chunk_bytes: int) -> memoryview:
    """Positional read of exactly [lo, hi) into a fresh window buffer."""
    size = hi - lo
    view = memoryview(_window_buffer(size, sub_chunk_bytes)).cast("B")
    got = 0
    while got < size:
        n = os.preadv(fd, [view[got:]], lo + got)
        if n == 0:
            raise EOFError(f"short read: fd {fd} yielded {got} of {size} bytes (offset {lo})")
        got += n
    return memoryview(faultinject.mutate("fs.pread", view))


def _spans(lo: int, size: int, sub_chunk_bytes: int):
    return [(o, min(o + sub_chunk_bytes, lo + size)) for o in range(lo, lo + size, sub_chunk_bytes)]


class FSStoragePlugin(StoragePlugin):
    supports_streaming = True
    supports_streaming_reads = True

    def __init__(self, root: str, storage_options=None) -> None:
        self.root = root
        self._dir_cache: Set[str] = set()
        self._fsync = _fsync_enabled()

    def _ensure_parent(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent and parent not in self._dir_cache:
            os.makedirs(parent, exist_ok=True)
            self._dir_cache.add(parent)

    def _tmp_path(self, path: str) -> str:
        return f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"

    async def _publish(self, tmp: str, path: str) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, os.replace, tmp, path)
        if self._fsync:
            # The rename reaches the disk only with its directory entry.
            await loop.run_in_executor(None, _fsync_path, os.path.dirname(path) or ".")

    async def write(self, write_io: WriteIO) -> None:
        path = os.path.join(self.root, write_io.path)
        self._ensure_parent(path)
        buf = faultinject.mutate("fs.write", write_io.buf)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, _write_file, path, buf, self._fsync)

    async def write_stream(self, stream: WriteStream) -> None:
        """Each sub-chunk by a positional write into one temp file,
        published by ``os.replace`` after the last: a failure mid-stream
        leaves nothing at the final path. With the native engine elected,
        the writes are queued io_uring SQEs."""
        from .. import native_io

        engine = native_io.maybe_engine("write", type(self).__name__)
        if engine is not None:
            await self._write_stream_native(stream, engine)
            return
        path = os.path.join(self.root, stream.path)
        self._ensure_parent(path)
        tmp = self._tmp_path(path)
        loop = asyncio.get_running_loop()
        fd = await loop.run_in_executor(
            None, lambda: os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        )
        try:
            offset = 0
            try:
                async for chunk in stream.chunks:
                    offset += await loop.run_in_executor(None, _pwrite_all, fd, chunk, offset)
                if offset != stream.nbytes:
                    raise IOError(
                        f"short write stream for {stream.path!r}: produced {offset} of "
                        f"{stream.nbytes} bytes"
                    )
                if self._fsync:
                    await loop.run_in_executor(None, os.fsync, fd)
            finally:
                os.close(fd)
            await self._publish(tmp, path)
        except BaseException:
            _remove_quietly(tmp)
            raise

    async def _write_stream_native(self, stream: WriteStream, engine) -> None:
        """``write_stream`` on the native engine: each sub-chunk is one
        SQE and the producer stages the next at once, so the stream runs
        ``engine.depth`` transfers deep. Completions are reaped oldest
        first once the window is full (which drops the engine's reference
        to that chunk's slab); the final drain raises any queued error
        before the short-write check. O_DIRECT (when enabled) is dropped
        at the first unaligned chunk."""
        from .. import native_io

        path = os.path.join(self.root, stream.path)
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        try:
            self._ensure_parent(path)
            tmp = self._tmp_path(path)
            fd, direct = await loop.run_in_executor(None, native_io.open_for_write, tmp)
        except BaseException:
            engine.close()
            raise
        offset = 0
        pending: list = []
        try:
            try:
                async for chunk in stream.chunks:
                    mv = memoryview(faultinject.mutate("fs.native_pwrite", chunk)).cast("B")
                    if mv.nbytes:
                        if direct and not native_io.io_aligned(mv, offset):
                            await loop.run_in_executor(None, native_io.clear_direct, fd)
                            direct = False
                        while len(pending) >= engine.depth:
                            await loop.run_in_executor(None, engine.wait, pending.pop(0), tmp)
                        pending.append(
                            await loop.run_in_executor(None, engine.submit_pwrite, fd, mv, offset)
                        )
                    offset += mv.nbytes
                await loop.run_in_executor(None, engine.drain)
                pending.clear()
                if offset != stream.nbytes:
                    raise IOError(
                        f"short write stream for {stream.path!r}: produced {offset} of "
                        f"{stream.nbytes} bytes"
                    )
                if self._fsync:
                    await loop.run_in_executor(None, os.fsync, fd)
            finally:
                # close() drains the ring before the fd closes.
                await loop.run_in_executor(None, engine.close)
                os.close(fd)
            await self._publish(tmp, path)
            from ..scheduler import _feed_governor_rates

            _feed_governor_rates(
                "write", f"{type(self).__name__}.native", offset, time.monotonic() - t0
            )
        except BaseException:
            _remove_quietly(tmp)
            raise

    async def read(self, read_io: ReadIO) -> None:
        path = os.path.join(self.root, read_io.path)
        if read_io.byte_range is None:
            lo, size = 0, os.stat(path).st_size
        else:
            lo, hi = read_io.byte_range
            size = max(0, hi - lo)
        loop = asyncio.get_running_loop()
        buf = await loop.run_in_executor(None, _read_file, path, lo, size)
        read_io.buf = faultinject.mutate("fs.read", buf)

    async def read_stream(self, read_io: ReadIO, sub_chunk_bytes: int) -> ReadStream:
        """Sub-chunk windows read by ``preadv``, each into a fresh staging
        slab, one window ahead: window N+1's read is dispatched before
        window N is yielded, so the disk fills N+1 while the consumer
        verifies and copies N. With the native engine elected, up to
        ``queue_depth`` windows are queued at once."""
        path = os.path.join(self.root, read_io.path)
        if read_io.byte_range is None:
            lo, size = 0, os.stat(path).st_size
        else:
            lo, hi = read_io.byte_range
            size = max(0, hi - lo)
        if size > 0:
            from .. import native_io

            engine = native_io.maybe_engine("read", type(self).__name__)
            if engine is not None:
                return ReadStream(
                    path=read_io.path,
                    nbytes=size,
                    chunks=self._native_read_chunks(engine, path, lo, size, sub_chunk_bytes),
                )

        async def chunks():
            if size <= 0:
                return
            loop = asyncio.get_running_loop()
            spans = _spans(lo, size, sub_chunk_bytes)
            fd = os.open(path, os.O_RDONLY)
            pending = None
            try:
                pending = loop.run_in_executor(None, _pread_exact, fd, *spans[0], sub_chunk_bytes)
                for nxt in spans[1:]:
                    chunk = await pending
                    pending = loop.run_in_executor(None, _pread_exact, fd, *nxt, sub_chunk_bytes)
                    yield chunk
                chunk = await pending
                pending = None
                yield chunk
            finally:
                if pending is not None:
                    # An abandoned read-ahead still uses the fd.
                    try:
                        await pending
                    except Exception:  # noqa: BLE001 - unwinding
                        pass
                os.close(fd)

        return ReadStream(path=read_io.path, nbytes=size, chunks=chunks())

    async def _native_read_chunks(self, engine, path: str, lo: int, size: int, sub_chunk_bytes: int):
        """io_uring reads: up to ``engine.depth`` windows queued at once,
        each into a staging slab, yielded in submission order. The engine
        holds each slab until its completion is reaped."""
        loop = asyncio.get_running_loop()
        spans = _spans(lo, size, sub_chunk_bytes)
        t0 = time.monotonic()
        fd = os.open(path, os.O_RDONLY)
        pending: list = []

        def submit(span):
            buf = _window_buffer(span[1] - span[0], sub_chunk_bytes)
            return engine.submit_pread(fd, buf, span[0]), buf

        try:
            nxt = 0
            for _ in range(min(engine.depth, len(spans))):
                pending.append(await loop.run_in_executor(None, submit, spans[nxt]))
                nxt += 1
            while pending:
                slot, buf = pending.pop(0)
                await loop.run_in_executor(None, engine.wait, slot, path)
                if nxt < len(spans):
                    pending.append(await loop.run_in_executor(None, submit, spans[nxt]))
                    nxt += 1
                yield memoryview(faultinject.mutate("fs.native_pread", buf))
            from ..scheduler import _feed_governor_rates

            _feed_governor_rates("read", f"{type(self).__name__}.native", size, time.monotonic() - t0)
        finally:
            await loop.run_in_executor(None, engine.close)
            os.close(fd)

    async def delete(self, path: str) -> None:
        os.remove(os.path.join(self.root, path))

    async def close(self) -> None:
        pass
