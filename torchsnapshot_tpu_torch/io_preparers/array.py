"""Plain-tensor write/read planning: the device seam of the port.

Counterpart of ``torchsnapshot_tpu/io_preparers/array.py``. The JAX seams
it replaces are ``_is_jax_array``/``np.asarray`` staging (array.py:440-458)
and the per-sub-chunk ``device_put`` plus ``concatenate`` on restore
(array.py:1146-1190).

Staging pool (:class:`_StagingPool`, array.py:79-420 of the JAX package).
Host staging buffers are slabs from the native host library (``_native``):
page-aligned and pre-faulted at allocation, kept on exact-size free lists
up to ``TORCHSNAPSHOT_GPU_STAGING_POOL_BYTES`` (4 GiB by default) and
recycled by the garbage collector when the last reference to a slab dies,
so the take after the first one pays no page faults. A slab that a CUDA
copy reads or writes is registered with ``cudaHostRegister`` (once, when it
is first used so): the device copies it by DMA, and ``is_pinned()`` is
True. A slab is also held until the CUDA event of the copy that uses it has
fired: a later ``get`` of the slab, or its eviction, waits on that event.
:func:`warmup_staging` allocates (and registers) the slabs a take will
draw, ahead of it. Without the library there is no pool: CUDA staging uses
pinned buffers from torch's caching host allocator, and CPU copies are
clones.

Take (:class:`ArrayBufferStager`). A CUDA tensor is copied into a
registered slab with ``non_blocking=True`` on a side stream of its device,
and one CUDA event is recorded per staged entry. The side stream first
waits on the caller's current stream (captured when the operation is
planned, on the caller's thread), so writes the caller queued before the
take are included. A non-contiguous tensor is made contiguous on the side
stream before the copy. Staging returns only once the entry's event has
fired, so the staged bytes never alias device memory the caller may
overwrite. A CPU tensor is viewed without copying for a blocking take; for
``async_take`` it is copied into a slab with its CRC32C in the same pass
(``copy_crc32c``, array.py:726-751 of the JAX package) when a checksum is
all that staging computes, else cloned.

Compression (``compression.py``, array.py:773-840 of the JAX package): a
stager planned under a codec compresses its staged bytes, stores them raw
when they do not shrink, and never compresses a payload under
``MIN_COMPRESS_BYTES`` or a byte-ranged one (write-batcher slabs); the
checksum covers the stored bytes, the digest the raw ones.

Restore (:class:`ArrayBufferConsumer`). The stored bytes are verified
against their checksum, then decompressed when the entry records a codec.
For a CUDA destination they are copied into a registered slab (the copy
and the CRC32C verification in one pass when the payload is raw), then
into the destination tensor in place with ``dst.copy_(host,
non_blocking=True)`` on the side stream; that side stream also first waits
on the caller's stream, so the caller's pending writes to the destination
(e.g. its zero fill) land before the restored bytes. The slab stays
referenced until the copy's event has fired. A snapshot dtype that differs
from the destination's is cast on the device, under the ``same_kind``
rule.

Incremental takes (``dedup.py``). A stager prepared under a dedup context
records the SHA-256 ``digest`` of its staged bytes and, when the base holds
the same bytes at the same location, skips the write and inherits the
base's ``origin`` (array.py:775-830 of the JAX package). With device
digests every tensor is first fingerprinted (``device_digest.py``, kernel
K4 for a CUDA tensor) on its side stream, so the fingerprint sees the bytes
the copy would see, all of a take's tensors before one fetch
(:func:`fingerprint_stagers`); when a fingerprint equals the base's
``device_digest`` for the location, there is no staging buffer, no copy and
no write (array.py:662-720, :1029-1040). Every fingerprint is recorded for
the next take. Reads follow ``origin``: the request names the
snapshot that holds the payload.
"""

from __future__ import annotations

import asyncio
import contextlib
import ctypes
import logging
import os
import threading
import weakref
from collections import Counter, deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .. import _native, device_digest
from ..compression import MIN_COMPRESS_BYTES, active_codec, compress, decompress
from ..dedup import active_dedup_context
from ..integrity import (
    checksums_enabled,
    compute_checksum,
    copy_and_checksum,
    copy_and_verify,
    verification_enabled,
    verify_checksum,
)
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

logger = logging.getLogger(__name__)

# One warning per process when a device-digest match inherits no checksum
# from its base (a base saved with checksums off).
_warned_none_checksum = False

STAGING_POOL_ENV_VAR = "TORCHSNAPSHOT_GPU_STAGING_POOL_BYTES"
_DEFAULT_STAGING_POOL_BYTES = 4 << 30
# Below this size an mmap-backed slab costs more than it saves; such
# buffers are not pooled.
_NATIVE_SLAB_MIN_BYTES = 4096
_CUDA_HOST_REGISTER_PORTABLE = 1


def _cudart():
    """torch's bindings of the CUDA runtime (the seam tests replace)."""
    return torch.cuda.cudart()


class _Slab:
    """One native slab: its address and size, whether it is registered
    with CUDA, and the CUDA event of the last copy that used it."""

    __slots__ = ("addr", "nbytes", "registered", "fence")

    def __init__(self, addr: int, nbytes: int) -> None:
        self.addr = addr
        self.nbytes = nbytes
        self.registered = False
        self.fence: Optional[torch.cuda.Event] = None

    def wait_fence(self) -> None:
        fence, self.fence = self.fence, None
        if fence is not None:
            fence.synchronize()


class _StagingPool:
    """A bounded free list of native staging slabs, recycled by the GC.

    ``get`` returns a uint8 CPU tensor over a slab. The tensor is built on
    a ctypes holder of the slab's memory that carries a finalizer: every
    view derived from the tensor (torch views, ``.numpy()``, memoryviews of
    those) keeps the holder alive, so the slab returns to the free list
    only when the last of them dies, whoever holds it longest (scheduler,
    storage plugin, consumer). Free lists are keyed by exact size; the
    bytes on them are bounded by the pool limit, and a slab that does not
    fit is freed (unregistered first)."""

    def __init__(self, limit_bytes: int) -> None:
        self._limit = limit_bytes
        self._lock = threading.Lock()
        self._free: Dict[int, List[_Slab]] = {}
        self._free_bytes = 0
        self._outstanding: Dict[int, _Slab] = {}
        # Returns whose finalizer fired while the lock was taken: a
        # finalizer may run at any allocation point, also inside this
        # pool's critical sections, so it never blocks on the lock; the
        # next get or prewarm folds these in (deque append is atomic).
        self._deferred: "deque[_Slab]" = deque()
        self.hits = self.misses = self.registered_bytes = 0

    @staticmethod
    def available() -> bool:
        """True when the native library is built: the pool has slabs."""
        return _native.native_available()

    def get(self, nbytes: int, pinned: bool = False) -> Optional[torch.Tensor]:
        """A uint8 CPU tensor of ``nbytes`` over a pooled slab, registered
        with CUDA when ``pinned``; None when the pool cannot serve it (no
        native library, a size under the slab minimum, an allocation that
        failed). Raises when the CUDA registration fails."""
        if nbytes < _NATIVE_SLAB_MIN_BYTES or not self.available():
            return None
        self._integrate_deferred()
        with self._lock:
            slabs = self._free.get(nbytes)
            slab = slabs.pop() if slabs else None
            if slab is not None:
                self._free_bytes -= nbytes
        hit = slab is not None
        if slab is None:
            got = _native.slab_alloc(nbytes)
            if got is None:
                return None
            slab = _Slab(got[0], nbytes)
        else:
            slab.wait_fence()
        if pinned and not slab.registered:
            self._register(slab)
        with self._lock:
            self._outstanding[slab.addr] = slab
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        holder = (ctypes.c_ubyte * nbytes).from_address(slab.addr)
        weakref.finalize(holder, self._put, slab)
        return torch.frombuffer(holder, dtype=torch.uint8)

    def fence(self, buf: torch.Tensor, event: torch.cuda.Event) -> None:
        """Hold the slab under ``buf`` (a tensor from :meth:`get`) until
        ``event`` has fired: reusing or freeing it waits on the event."""
        with self._lock:
            slab = self._outstanding.get(buf.data_ptr())
            if slab is not None:
                slab.fence = event

    def _register(self, slab: _Slab) -> None:
        """Register a slab that no one else holds; on failure it is freed
        and the error raised."""
        rc = int(_cudart().cudaHostRegister(slab.addr, slab.nbytes, _CUDA_HOST_REGISTER_PORTABLE))
        if rc != 0:
            self._destroy(slab)
            raise RuntimeError(
                f"cudaHostRegister of a {slab.nbytes}-byte staging slab failed with CUDA "
                f"error {rc}; an unregistered slab would make every device copy through "
                "it synchronous"
            )
        slab.registered = True
        with self._lock:
            self.registered_bytes += slab.nbytes

    def _destroy(self, slab: _Slab) -> None:
        slab.wait_fence()
        if slab.registered:
            rc = int(_cudart().cudaHostUnregister(slab.addr))
            if rc != 0:
                # Unmapping memory CUDA still holds registered is worse
                # than leaking it.
                logger.warning(
                    "cudaHostUnregister of a %d-byte staging slab failed with CUDA error "
                    "%d; the slab is leaked", slab.nbytes, rc,
                )
                return
            slab.registered = False
            with self._lock:
                self.registered_bytes -= slab.nbytes
        _native.slab_free(slab.addr, slab.nbytes)

    def _put(self, slab: _Slab) -> None:
        # Finalizer context: never block on the lock (see _deferred).
        if not self._lock.acquire(blocking=False):
            self._deferred.append(slab)
            return
        try:
            self._outstanding.pop(slab.addr, None)
        finally:
            self._lock.release()
        self._store(slab)

    def _integrate_deferred(self) -> None:
        while True:
            try:
                slab = self._deferred.popleft()
            except IndexError:
                return
            with self._lock:
                self._outstanding.pop(slab.addr, None)
            self._store(slab)

    def _store(self, slab: _Slab) -> None:
        with self._lock:
            keep = self._free_bytes + slab.nbytes <= self._limit
            if keep:
                self._free.setdefault(slab.nbytes, []).append(slab)
                self._free_bytes += slab.nbytes
        if not keep:
            self._destroy(slab)

    def free_bytes(self) -> int:
        self._integrate_deferred()
        return self._free_bytes

    def clear(self) -> int:
        """Free every pooled slab; returns the bytes freed. Slabs still
        referenced return to the pool when their last reference dies."""
        self._integrate_deferred()
        with self._lock:
            slabs = [slab for group in self._free.values() for slab in group]
            self._free = {}
            self._free_bytes = 0
        for slab in slabs:
            self._destroy(slab)
        return sum(slab.nbytes for slab in slabs)

    def prewarm(self, sizes: Sequence[Tuple[int, bool]]) -> int:
        """Allocate (pre-faulted) the slabs a take will draw, so that it
        does not allocate them: ``sizes`` is a multiset of ``(nbytes,
        pinned)``; slabs already pooled count toward it, and one that a
        pinned size finds unregistered is registered. Bounded by the pool
        limit. Returns the bytes newly allocated or registered."""
        if not self.available():
            return 0
        self._integrate_deferred()
        want = Counter(nbytes for nbytes, _ in sizes if nbytes >= _NATIVE_SLAB_MIN_BYTES)
        pinned = {nbytes for nbytes, pin in sizes if pin}
        warmed = 0
        for nbytes, count in want.items():
            with self._lock:
                slabs = self._free.get(nbytes, [])
                pooled = len(slabs)
                # Taken off the free list while they are registered, so a
                # concurrent get cannot register them too.
                unpinned = [] if nbytes not in pinned else [
                    slab for slab in slabs[:count] if not slab.registered
                ]
                for slab in unpinned:
                    slabs.remove(slab)
                    self._free_bytes -= nbytes
                room = (self._limit - self._free_bytes) // nbytes - len(unpinned)
            for slab in unpinned:
                self._register(slab)
                self._store(slab)
                warmed += nbytes
            for _ in range(min(count - pooled, room)):
                got = _native.slab_alloc(nbytes)
                if got is None:
                    return warmed
                slab = _Slab(got[0], nbytes)
                if nbytes in pinned:
                    self._register(slab)
                self._store(slab)
                warmed += nbytes
        return warmed


def _pool_limit() -> int:
    raw = os.environ.get(STAGING_POOL_ENV_VAR, "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            logger.warning("ignoring %s=%r: not an integer", STAGING_POOL_ENV_VAR, raw)
    return _DEFAULT_STAGING_POOL_BYTES


_staging_pool = _StagingPool(_pool_limit())


def pooled_buffer(nbytes: int, pinned: bool = False) -> Optional[torch.Tensor]:
    """A writable uint8 CPU tensor of ``nbytes`` from the process staging
    pool (registered with CUDA when ``pinned``), recycled by the GC when
    every reference to it dies; None when the pool cannot serve the size
    (see :class:`_StagingPool`)."""
    return _staging_pool.get(nbytes, pinned)


def clear_staging_pool() -> int:
    """Free the slabs the staging pool holds; returns the bytes freed."""
    return _staging_pool.clear()


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


def _device_staging_buffer(nbytes: int) -> torch.Tensor:
    """Host bytes a CUDA copy reads or writes: a registered pooled slab, or
    a pinned buffer from torch's caching host allocator where the pool
    cannot serve the size (no native library, a small size)."""
    host = pooled_buffer(nbytes, pinned=True)
    if host is None:
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return host


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
        self.dedup = active_dedup_context()
        self.codec = active_codec()
        self.io_skipped = False
        # Set when staging recorded the checksum itself (fused with the copy).
        self._summed = False

    def _on_stream(self):
        """The side stream as the current stream (CUDA tensors only)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _device_dedup_candidate(self) -> bool:
        return (
            self.dedup is not None
            and self.dedup.device_digests
            and self.entry.byte_range is None
        )

    def _adopt_unchanged_base(self) -> bool:
        """With the fingerprint that :func:`fingerprint_stagers` recorded:
        when the base recorded the same fingerprint for this location, take
        the base's digest, origin and checksum and return True: nothing is
        copied or written. A base saved without checksums leaves the entry's
        checksum unset (there are no staged bytes to compute one from),
        which a one-time warning flags."""
        fp = self.entry.device_digest
        ref = self.dedup.refs.get(self.entry.location)
        if fp is None or ref is None or ref.device_digest != fp:
            return False
        nbytes = array_size_bytes(self.tensor.shape, self.entry.dtype)
        if ref.nbytes is not None and ref.nbytes != nbytes:
            return False  # same fingerprint, different size: never trust
        self.entry.digest = ref.digest
        self.entry.origin = ref.origin
        self.entry.codec = ref.codec
        self.entry.checksum = ref.checksum
        if ref.checksum is None and checksums_enabled():
            global _warned_none_checksum
            if not _warned_none_checksum:
                _warned_none_checksum = True
                logger.warning(
                    "device-digest dedup match for %s inherits no checksum (base "
                    "snapshot was saved with checksums disabled); restore-time "
                    "verification will not cover deduplicated entries until a full "
                    "(non-dedup) save records checksums again",
                    self.entry.location,
                )
        return True

    def _active_codec(self) -> Optional[str]:
        """The codec this payload is stored under, or None: byte-ranged
        payloads (write-batcher slabs) are never compressed, since the
        slab's offsets were planned from the raw sizes."""
        return None if self.entry.byte_range is not None else self.codec

    async def _stage_cuda(self, executor) -> torch.Tensor:
        t = self.tensor
        nbytes = array_size_bytes(t.shape, self.entry.dtype)
        loop = asyncio.get_running_loop()
        host = await loop.run_in_executor(executor, _device_staging_buffer, nbytes)
        if nbytes == 0:
            return host
        event = torch.cuda.Event()
        with self._on_stream():
            src = t if t.is_contiguous() else t.contiguous()
            host.copy_(_flat_bytes(src), non_blocking=True)
            event.record(self.stream)
        _staging_pool.fence(host, event)
        # src (a side-stream temporary for non-contiguous input) and t stay
        # referenced until the copy has landed.
        await _wait_event(event, executor)
        del src
        return host

    def _stage_cpu(self) -> torch.Tensor:
        t = self.tensor
        host = _flat_bytes(t.contiguous())
        if not self.copy_cpu or host.data_ptr() != t.data_ptr():
            return host  # a blocking take's view, or already a copy
        if self.dedup is None and self._active_codec() is None and checksums_enabled():
            # The consistency copy and the checksum in one pass.
            slab = pooled_buffer(host.numel())
            if slab is not None:
                checksum = copy_and_checksum(slab.numpy(), host.numpy())
                if checksum is not None:
                    self.entry.checksum = checksum
                    self._summed = True
                    return slab
        return host.clone()

    def _digest_and_sum(self, buf: memoryview) -> memoryview:
        """Host dedup under a dedup context (the write is skipped when the
        base holds these bytes), then compression under a codec (raw when
        it does not shrink), then the checksum of the stored bytes."""
        if self.dedup is not None and self.dedup.reuse_staged(self.entry, buf):
            self.io_skipped = True
            return buf
        codec = self._active_codec()
        if codec is not None and buf.nbytes >= MIN_COMPRESS_BYTES:
            packed = compress(codec, buf)
            if len(packed) < buf.nbytes:
                self.entry.codec = codec
                buf = memoryview(packed)
        if checksums_enabled():
            self.entry.checksum = compute_checksum(buf)
        return buf

    async def stage_buffer(self, executor=None) -> BufferType:
        if self._device_dedup_candidate() and self._adopt_unchanged_base():
            self.io_skipped = True
            return memoryview(b"")
        loop = asyncio.get_running_loop()
        if self.tensor.is_cuda:
            host = await self._stage_cuda(executor)
        else:
            host = await loop.run_in_executor(executor, self._stage_cpu)
        buf = tensor_as_memoryview(host)
        if self._summed or (
            self.dedup is None and self._active_codec() is None and not checksums_enabled()
        ):
            return buf
        return await loop.run_in_executor(executor, self._digest_and_sum, buf)

    def get_staging_cost_bytes(self) -> int:
        return array_size_bytes(self.tensor.shape, self.entry.dtype)


def fingerprint_stagers(stagers: Iterable[BufferStager]) -> None:
    """The device-digest pass of a take, on the caller's thread before
    staging: every tensor a device-digest context stages is fingerprinted
    (K4 on the tensor's side stream for a CUDA tensor, which orders it after
    the caller's queued work, so it sees the bytes the copy would see), and
    the lanes come back in one fetch per side stream: one device round trip
    for the whole take rather than one a tensor. Each entry records its
    fingerprint; at stage time a stager whose fingerprint equals the base's
    skips its copy and its write."""
    pendings: Dict[Optional[torch.cuda.Stream], List[Tuple[ArrayBufferStager, torch.Tensor]]] = {}
    for stager in stagers:
        if isinstance(stager, ArrayBufferStager) and stager._device_dedup_candidate():
            with stager._on_stream():
                pending = device_digest._dispatch(stager.tensor)
            if pending is not None:
                pendings.setdefault(stager.stream, []).append((stager, pending))
    for stream, items in pendings.items():
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            lanes = device_digest._fetch([pending for _, pending in items])
        for (stager, _), stager_lanes in zip(items, lanes):
            nbytes = array_size_bytes(stager.tensor.shape, stager.entry.dtype)
            stager.entry.device_digest = device_digest._fold_lanes(stager_lanes, nbytes)


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

    def _raw_nbytes(self) -> int:
        return array_size_bytes(self.entry.shape, self.entry.dtype)

    def _verify_and_decode(self, buf: BufferType) -> BufferType:
        """The raw payload: the stored bytes verified against the entry's
        checksum, then decompressed when the entry records a codec."""
        if self.entry.checksum is not None and verification_enabled():
            verify_checksum(buf, self.entry.checksum, self.entry.location)
        if self.entry.codec is not None:
            buf = decompress(self.entry.codec, buf, expected_size=self._raw_nbytes())
        return buf

    def _verify_and_view(self, buf: BufferType) -> torch.Tensor:
        return tensor_from_buffer(self._verify_and_decode(buf), self.entry.dtype, self.entry.shape)

    def _stage_for_device(self, buf: BufferType) -> torch.Tensor:
        """The raw payload in host bytes a CUDA copy reads (a registered
        slab where the pool serves the size), verified on the way: a raw
        payload of the right size is copied and checked against its
        checksum in one pass."""
        nbytes = self._raw_nbytes()
        host = _device_staging_buffer(nbytes)
        if self.entry.codec is None and memoryview(buf).nbytes == nbytes:
            copy_and_verify(host.numpy(), buf, self.entry.checksum, self.entry.location)
        else:
            host.copy_(_flat_bytes(self._verify_and_view(buf)))
        return host

    async def _copy_to_cuda(self, buf: BufferType, executor) -> None:
        dst = self.dst
        loop = asyncio.get_running_loop()
        host = await loop.run_in_executor(executor, self._stage_for_device, buf)
        if host.numel() == 0:
            return
        src_dtype = string_to_dtype(self.entry.dtype)
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            if dst.dtype == src_dtype and dst.is_contiguous():
                _flat_bytes(dst).copy_(host, non_blocking=True)
            else:
                dst.copy_(host.view(src_dtype).reshape(tuple(self.entry.shape)), non_blocking=True)
            event.record(self.stream)
        _staging_pool.fence(host, event)
        # The host buffer must outlive the copy: drop it only after the
        # event has fired.
        await _wait_event(event, executor)
        del host

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        loop = asyncio.get_running_loop()
        dst = self.dst
        if dst is not None and dst.is_cuda:
            await self._copy_to_cuda(buf, executor)
            value = dst
        else:
            value = await loop.run_in_executor(executor, self._verify_and_view, buf)
            if dst is not None:
                await loop.run_in_executor(executor, _copy_cpu, dst, value)
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
        consumer = ArrayBufferConsumer(entry, dst, callback, streams)
        byte_range = tuple(entry.byte_range) if entry.byte_range is not None else None
        return [
            ReadReq(
                path=entry.location,
                buffer_consumer=consumer,
                byte_range=byte_range,
                origin=entry.origin,
            )
        ]


def warmup_staging(
    app_state, pg=None, replicated=None, save_dtype=None, host_copies: bool = True
) -> int:
    """Allocate and register, ahead of the first ``async_take``, the
    staging slabs it will draw, so that it blocks like a warm one; returns
    the bytes newly allocated or registered (array.py:565-620 of the JAX
    package).

    Sizes follow the write plan: each tensor at its ``save_dtype`` and cut
    at the chunk boundaries of ``ChunkedArrayIOPreparer``. A CUDA tensor's
    pieces always draw a registered slab. A CPU tensor's draw one only for
    the fused copy and checksum of ``async_take``: with checksums on, and
    not under dedup or compression (``host_copies=False`` says so; the
    manager passes it), else they are skipped (array.py:602-610). Returns 0
    without the native library. ``pg`` and ``replicated`` are accepted for
    the JAX package's signature; a single process stages every piece."""
    from ..flatten import flatten
    from ..serialization import effective_save_dtype
    from .chunked import ChunkedArrayIOPreparer

    if not _staging_pool.available():
        return 0
    cpu_pieces = host_copies and checksums_enabled()
    sizes: List[Tuple[int, bool]] = []
    for key, stateful in app_state.items():
        for logical_path, leaf in flatten(stateful.state_dict(), prefix=key)[1].items():
            if not isinstance(leaf, torch.Tensor) or not (leaf.is_cuda or cpu_pieces):
                continue
            target = effective_save_dtype(logical_path, leaf.dtype, save_dtype or {})
            dtype_str = dtype_to_string(leaf.dtype if target is None else target)
            for _, piece_shape in ChunkedArrayIOPreparer.chunk_shards(tuple(leaf.shape), dtype_str):
                sizes.append((array_size_bytes(piece_shape or leaf.shape, dtype_str), leaf.is_cuda))
    return _staging_pool.prewarm(sizes)
