"""Local filesystem storage plugin.

Counterpart of ``torchsnapshot_tpu/storage_plugins/fs.py`` (buffered
paths). Blocking file calls run in the event loop's thread pool, so they
overlap with staging. Writes are atomic: each file lands through a temp
file and ``os.replace``, so a crash never leaves a truncated payload and
the ``.snapshot_metadata`` commit point is all-or-nothing.
``TORCHSNAPSHOT_GPU_FSYNC=1`` also fsyncs each temp file before its rename
and the parent directory after it, so a published file survives a power
loss (fs.py:37-105 of the JAX package; off by default, since every write
then waits for the drive). Reads of 1 MiB and more map the file privately
instead of copying it out of the page cache.
"""

from __future__ import annotations

import asyncio
import itertools
import mmap
import os
from typing import Set

from ..io_types import ReadIO, StoragePlugin, WriteIO

FSYNC_ENV_VAR = "TORCHSNAPSHOT_GPU_FSYNC"
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


def _read_file(path: str, lo: int, size: int):
    with open(path, "rb") as f:
        fsize = os.fstat(f.fileno()).st_size
        if lo + size > fsize:
            raise EOFError(
                f"short read: {path} is {fsize} bytes; range [{lo}, {lo + size}) "
                "extends past EOF"
            )
        if size >= _MMAP_MIN_BYTES:
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


class FSStoragePlugin(StoragePlugin):
    def __init__(self, root: str, storage_options=None) -> None:
        self.root = root
        self._dir_cache: Set[str] = set()
        self._fsync = _fsync_enabled()

    async def write(self, write_io: WriteIO) -> None:
        path = os.path.join(self.root, write_io.path)
        parent = os.path.dirname(path)
        if parent and parent not in self._dir_cache:
            os.makedirs(parent, exist_ok=True)
            self._dir_cache.add(parent)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, _write_file, path, write_io.buf, self._fsync)

    async def read(self, read_io: ReadIO) -> None:
        path = os.path.join(self.root, read_io.path)
        if read_io.byte_range is None:
            lo, size = 0, os.stat(path).st_size
        else:
            lo, hi = read_io.byte_range
            size = max(0, hi - lo)
        loop = asyncio.get_running_loop()
        read_io.buf = await loop.run_in_executor(None, _read_file, path, lo, size)

    async def delete(self, path: str) -> None:
        os.remove(os.path.join(self.root, path))

    async def close(self) -> None:
        pass
