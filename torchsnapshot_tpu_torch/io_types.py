"""Contracts between I/O preparation, the scheduler and storage.

Counterpart of ``torchsnapshot_tpu/io_types.py``, buffered paths only: the
scheduler moves bytes and charges their host-memory cost, and stays
agnostic of tensors, devices and pickled objects. Buffer stagers cross the
device->host boundary (pinned staging of CUDA tensors); buffer consumers
cross host->device (in-place copies into destination tensors).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Tuple, Union

BufferType = Union[bytes, bytearray, memoryview]


@dataclass
class WriteIO:
    """A single write of a buffer to a storage path."""

    path: str
    buf: BufferType


@dataclass
class ReadIO:
    """A single read of a storage path, optionally a byte range [lo, hi)."""

    path: str
    buf: BufferType = b""
    byte_range: Optional[Tuple[int, int]] = None


class BufferStager(abc.ABC):
    """Produces the bytes to be written for one write request. For a CUDA
    tensor, ``stage_buffer`` is where the DtoH copy happens."""

    @abc.abstractmethod
    async def stage_buffer(self, executor=None) -> BufferType:
        ...

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak host memory the staged buffer will occupy."""
        ...


class BufferConsumer(abc.ABC):
    """Consumes the bytes read for one read request."""

    @abc.abstractmethod
    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        ...

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        """Peak host memory needed while consuming the buffer."""
        ...


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[Tuple[int, int]] = None


class StoragePlugin(abc.ABC):
    """Storage backend interface. Implementations must be safe to drive
    from an asyncio event loop."""

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None:
        ...

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None:
        ...

    @abc.abstractmethod
    async def delete(self, path: str) -> None:
        ...

    @abc.abstractmethod
    async def close(self) -> None:
        ...

    def sync_close(self, event_loop) -> None:
        event_loop.run_until_complete(self.close())
