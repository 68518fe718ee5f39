"""File-like read/seek/tell over a memoryview so cloud SDKs can stream staged
buffers, pinned staging slabs included, without copying (the port's copy of
``torchsnapshot_tpu/memoryview_stream.py``; reference:
memoryview_stream.py:12-81)."""

from __future__ import annotations

import io
from typing import Optional


class MemoryviewStream(io.RawIOBase):
    def __init__(self, mv: memoryview) -> None:
        self._mv = mv.cast("B")
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def read(self, size: int = -1) -> bytes:
        if self.closed:
            raise ValueError("I/O operation on closed stream.")
        if size is None or size < 0:
            end = len(self._mv)
        else:
            end = min(self._pos + size, len(self._mv))
        data = bytes(self._mv[self._pos:end])
        self._pos = end
        return data

    def readinto(self, b) -> int:
        if self.closed:
            raise ValueError("I/O operation on closed stream.")
        end = min(self._pos + len(b), len(self._mv))
        n = max(0, end - self._pos)
        if n == 0:
            return 0
        b[:n] = self._mv[self._pos:end]
        self._pos = end
        return n

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if self.closed:
            raise ValueError("I/O operation on closed stream.")
        if whence == io.SEEK_SET:
            new_pos = pos
        elif whence == io.SEEK_CUR:
            new_pos = self._pos + pos
        elif whence == io.SEEK_END:
            new_pos = len(self._mv) + pos
        else:
            raise ValueError(f"Invalid whence: {whence}")
        if new_pos < 0:
            raise ValueError(f"Negative seek position: {new_pos}")
        self._pos = new_pos
        return new_pos

    def tell(self) -> int:
        return self._pos

    def __len__(self) -> int:
        return len(self._mv)
