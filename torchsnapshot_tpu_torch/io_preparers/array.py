"""Plain-tensor write/read planning: the device seam of the port.

Counterpart of ``torchsnapshot_tpu/io_preparers/array.py``. The JAX seams
it replaces are ``_is_jax_array``/``np.asarray`` staging (array.py:440-458)
and the per-sub-chunk ``device_put`` plus ``concatenate`` on restore
(array.py:1146-1190).

Take (:class:`ArrayBufferStager`). A CUDA tensor is copied into pinned host
memory with ``non_blocking=True`` on a side stream of its device, and one
CUDA event is recorded per staged entry. The side stream first waits on the
caller's current stream (captured when the operation is planned, on the
caller's thread), so writes the caller queued before the take are included.
A non-contiguous tensor is made contiguous on the side stream before the
copy. Staging returns only once the entry's event has fired, so the staged
bytes never alias device memory the caller may overwrite. A CPU tensor is
viewed without copying for a blocking take, and cloned for ``async_take``.

Restore (:class:`ArrayBufferConsumer`). The bytes read are copied into a
pinned buffer, then into the destination tensor in place with
``dst.copy_(host, non_blocking=True)`` on the side stream; that side stream
also first waits on the caller's stream, so the caller's pending writes to
the destination (e.g. its zero fill) land before the restored bytes. The
pinned buffer stays referenced until the copy's event has fired, so it is
never freed or reused under the copy. A snapshot dtype that differs from
the destination's is cast on the device, under the ``same_kind`` rule.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..integrity import checksums_enabled, compute_checksum, verification_enabled, verify_checksum
from ..io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from ..manifest import ArrayEntry
from ..serialization import (
    Serializer,
    array_size_bytes,
    dtype_to_string,
    string_to_dtype,
    tensor_as_memoryview,
    tensor_from_buffer,
)


class DeviceStreams:
    """The side streams of one take or restore, one per CUDA device.

    Each stream is created at its first use and at that moment waits on
    the caller's current stream of that device: the ordering point between
    the caller's queued work and this operation's copies."""

    def __init__(self) -> None:
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def get(self, device: torch.device) -> torch.cuda.Stream:
        stream = self._streams.get(device)
        if stream is None:
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            self._streams[device] = stream
        return stream


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (any dtype)."""
    return t.reshape(-1).view(torch.uint8)


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _copy_cpu(dst: torch.Tensor, src: torch.Tensor) -> None:
    # Byte copies where the dtypes match: torch has no copy kernel for
    # some of them (int2, uint2).
    if dst.dtype == src.dtype and dst.is_contiguous():
        _flat_bytes(dst).copy_(_flat_bytes(src))
    else:
        dst.copy_(src)


async def _wait_event(event: torch.cuda.Event, executor) -> None:
    loop = asyncio.get_running_loop()
    await loop.run_in_executor(executor, event.synchronize)


class ArrayBufferStager(BufferStager):
    """Stages one tensor into host bytes owned by the snapshot."""

    def __init__(
        self,
        tensor: torch.Tensor,
        entry: ArrayEntry,
        streams: DeviceStreams,
        copy_cpu: bool,
    ) -> None:
        self.tensor = tensor.detach()
        self.entry = entry
        self.copy_cpu = copy_cpu
        # Planned on the caller's thread: the side stream's ordering point.
        self.stream = streams.get(self.tensor.device) if self.tensor.is_cuda else None

    async def _stage_cuda(self, executor) -> torch.Tensor:
        t = self.tensor
        host = _pinned(array_size_bytes(t.shape, self.entry.dtype))
        if host.numel() == 0:
            return host
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            src = t if t.is_contiguous() else t.contiguous()
            host.copy_(_flat_bytes(src), non_blocking=True)
            event.record(self.stream)
        # src (a side-stream temporary for non-contiguous input) and t stay
        # referenced until the copy has landed.
        await _wait_event(event, executor)
        del src
        return host

    async def stage_buffer(self, executor=None) -> BufferType:
        t = self.tensor
        if t.is_cuda:
            host = await self._stage_cuda(executor)
        else:
            host = _flat_bytes(t.contiguous())
            if self.copy_cpu and host.data_ptr() == t.data_ptr():
                host = host.clone()
        buf = tensor_as_memoryview(host)
        if checksums_enabled():
            loop = asyncio.get_running_loop()
            self.entry.checksum = await loop.run_in_executor(executor, compute_checksum, buf)
        return buf

    def get_staging_cost_bytes(self) -> int:
        return array_size_bytes(self.tensor.shape, self.entry.dtype)


def check_restore_cast(entry_dtype: str, dst_dtype: torch.dtype, what: str) -> bool:
    """The destination is the spec: a snapshot saved in another dtype is
    cast to the destination's, ``same_kind`` casts only (prepare.py:254-274
    of the JAX package). Returns True when a cast is needed; raises when the
    cast is forbidden."""
    from ..serialization import can_cast_same_kind

    src = string_to_dtype(entry_dtype)
    if src == dst_dtype:
        return False
    if not can_cast_same_kind(src, dst_dtype):
        raise RuntimeError(
            f"Restoring {what}: snapshot dtype {entry_dtype} cannot be cast to "
            f"destination dtype {dst_dtype} (only same-kind casts are supported)."
        )
    return True


class ArrayBufferConsumer(BufferConsumer):
    """Copies one entry's bytes into ``dst`` in place (when given) and
    reports the value through ``callback``."""

    def __init__(
        self,
        entry: ArrayEntry,
        dst: Optional[torch.Tensor],
        callback: Optional[Callable[[torch.Tensor], None]],
        streams: DeviceStreams,
    ) -> None:
        self.entry = entry
        self.dst = dst
        self.callback = callback
        self.stream = streams.get(dst.device) if dst is not None and dst.is_cuda else None

    async def _copy_to_cuda(self, src: torch.Tensor, executor) -> None:
        dst = self.dst
        loop = asyncio.get_running_loop()
        pinned = _pinned(array_size_bytes(src.shape, self.entry.dtype))
        if pinned.numel() == 0:
            return
        await loop.run_in_executor(executor, pinned.copy_, _flat_bytes(src))
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            if dst.dtype == src.dtype and dst.is_contiguous():
                _flat_bytes(dst).copy_(pinned, non_blocking=True)
            else:
                host = pinned.view(src.dtype).reshape(src.shape)
                dst.copy_(host, non_blocking=True)
            event.record(self.stream)
        # The pinned buffer must outlive the copy: drop it only after the
        # event has fired.
        await _wait_event(event, executor)
        del pinned

    def _verify_and_view(self, buf: BufferType) -> torch.Tensor:
        if self.entry.checksum is not None and verification_enabled():
            verify_checksum(buf, self.entry.checksum, self.entry.location)
        return tensor_from_buffer(buf, self.entry.dtype, self.entry.shape)

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        loop = asyncio.get_running_loop()
        src = await loop.run_in_executor(executor, self._verify_and_view, buf)
        dst = self.dst
        if dst is None:
            value = src
        elif dst.is_cuda:
            await self._copy_to_cuda(src, executor)
            value = dst
        else:
            await loop.run_in_executor(executor, _copy_cpu, dst, src)
            value = dst
        if self.callback is not None:
            self.callback(value)

    def get_consuming_cost_bytes(self) -> int:
        return array_size_bytes(self.entry.shape, self.entry.dtype)


class ArrayIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str,
        tensor: torch.Tensor,
        streams: DeviceStreams,
        copy_cpu: bool,
        replicated: bool = False,
    ) -> Tuple[ArrayEntry, List[WriteReq]]:
        entry = ArrayEntry(
            location=storage_path,
            serializer=Serializer.BUFFER_PROTOCOL.value,
            dtype=dtype_to_string(tensor.dtype),
            shape=list(tensor.shape),
            replicated=replicated,
        )
        stager = ArrayBufferStager(tensor, entry, streams, copy_cpu)
        return entry, [WriteReq(path=storage_path, buffer_stager=stager)]

    @staticmethod
    def prepare_read(
        entry: ArrayEntry,
        dst: Optional[torch.Tensor],
        callback: Optional[Callable[[torch.Tensor], None]],
        streams: DeviceStreams,
    ) -> List[ReadReq]:
        if entry.codec is not None or entry.origin is not None:
            raise NotImplementedError(
                f"{entry.location!r} is stored compressed or in an incremental base "
                f"snapshot (codec={entry.codec}, origin={entry.origin}); neither is "
                "ported to torchsnapshot_tpu_torch yet."
            )
        consumer = ArrayBufferConsumer(entry, dst, callback, streams)
        byte_range = tuple(entry.byte_range) if entry.byte_range is not None else None
        return [ReadReq(path=entry.location, buffer_consumer=consumer, byte_range=byte_range)]
