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

Streaming (array.py:844-1414 of the JAX package; ``scheduler.py`` elects
it). A plain payload (no dedup, codec, batch byte range or ``save_dtype``
conversion) of a contiguous tensor streams on a blocking take as byte
ranges of its flat uint8 view: for a CUDA tensor the DtoH copy of
sub-chunk N+1 is queued on the side stream into a registered slab before
sub-chunk N is checksummed and yielded, and the CRC32C chains across
sub-chunks to the buffered checksum. A streamed restore verifies the
chained checksum of the stored bytes (decompressing as they come) and
commits only after it matched: a CUDA destination through a device scratch
buffer (:class:`_DeviceScratchSink`), anything else through a host slab
(:class:`_ScratchSink`). Stream slabs come in power-of-two size classes
(:func:`stream_slab_bytes`).

Budgeted reads (``read_object(memory_budget_bytes=)``, array.py:1432-1656
of the JAX package). Under a ``buffer_size_limit_bytes`` a raw entry is
read as byte ranges of at most that many bytes (whole elements), each
filled into its flat slice of the destination by a
:class:`_SlicedArrayConsumer` as it arrives; a CUDA destination takes
each range HtoD on the side stream through a registered staging slab,
fenced by the copy's event, so the host memory in flight is one range a
read. A compressed entry is read whole, budget or not. Like the JAX
package's, a budget-split read carries no checksum and is not verified:
the entry's checksum covers the whole payload, which no range sees.

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
import math
import os
import threading
import weakref
import zlib
from collections import Counter, deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native, device_digest, telemetry
from ..compression import (
    MIN_COMPRESS_BYTES,
    StreamingDecompressor,
    active_codec,
    compress,
    decompress,
)
from ..dedup import active_dedup_context
from ..integrity import (
    IncrementalVerifier,
    checksums_enabled,
    compute_checksum,
    copy_and_checksum,
    copy_and_verify,
    verification_enabled,
    verify_checksum,
)
from ..io_types import (
    STREAM_DEPTH,
    BufferConsumer,
    BufferStager,
    BufferType,
    ReadReq,
    ReadStream,
    WriteReq,
)
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
STREAM_WRITES_ENV_VAR = "TORCHSNAPSHOT_GPU_STREAM_WRITES"
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

    __slots__ = ("addr", "nbytes", "registered", "fence", "stamp")

    def __init__(self, addr: int, nbytes: int) -> None:
        self.addr = addr
        self.nbytes = nbytes
        self.registered = False
        self.fence: Optional[torch.cuda.Event] = None
        self.stamp = 0  # when it last went on the free list

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
    bytes on them are bounded by the pool limit. A returning slab that does
    not fit makes room by freeing (unregistered first) the least recently
    returned slabs of other sizes, so the sizes in use stay pooled when an
    earlier operation's sizes fill the list; it is freed itself when only
    its own size is left."""

    def __init__(self, limit_bytes: int) -> None:
        self._limit = limit_bytes
        self._lock = threading.Lock()
        self._free: Dict[int, List[_Slab]] = {}
        self._free_bytes = 0
        self._stamp = 0
        self._outstanding: Dict[int, _Slab] = {}
        # Returns whose finalizer fired while the lock was taken: a
        # finalizer may run at any allocation point, also inside this
        # pool's critical sections, so it never blocks on the lock; the
        # next get or prewarm folds these in (deque append is atomic).
        self._deferred: "deque[_Slab]" = deque()
        self.hits = self.misses = self.registered_bytes = 0
        # Bytes of the slabs handed out and not yet returned, and their
        # peak since the last reset_peak().
        self.outstanding_bytes = self.peak_bytes = 0

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
            self.outstanding_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.outstanding_bytes)
            if hit:
                self.hits += 1
            else:
                self.misses += 1
            free_b, out_b = self._free_bytes, self.outstanding_bytes
        if telemetry.enabled():
            telemetry.counter_add("staging_pool_hits" if hit else "staging_pool_misses", 1)
            telemetry.gauge_set("staging_pool_free_bytes", free_b)
            telemetry.gauge_set("staging_pool_outstanding_bytes", out_b)
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

    def pin(self, buf: torch.Tensor) -> bool:
        """Register with CUDA the whole slab under ``buf`` (a uint8 tensor
        from the start of a slab this pool handed out, such as a read
        window), unless it is registered already; True when ``buf`` is
        such a slab. The slab goes back to the pool registered. Raises when
        the registration fails."""
        with self._lock:
            slab = self._outstanding.get(buf.data_ptr())
        if slab is None or buf.numel() > slab.nbytes:
            return False
        if not slab.registered:
            rc = int(_cudart().cudaHostRegister(slab.addr, slab.nbytes, _CUDA_HOST_REGISTER_PORTABLE))
            if rc != 0:
                raise RuntimeError(
                    f"cudaHostRegister of a {slab.nbytes}-byte read window failed with CUDA "
                    f"error {rc}"
                )
            slab.registered = True
            with self._lock:
                self.registered_bytes += slab.nbytes
        return True

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_bytes = self.outstanding_bytes

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
            # tsalint: allow[restricted-context] safe from the _put finalizer: its acquire(blocking=False) gate proved this thread does NOT hold the pool lock (a holder defers instead), and no pool path blocks while holding it (lock-blocking enforces that), so this acquire cannot self-deadlock
            with self._lock:
                self.registered_bytes -= slab.nbytes
        _native.slab_free(slab.addr, slab.nbytes)

    def _put(self, slab: _Slab) -> None:
        # Finalizer context: never block on the lock (see _deferred).
        if not self._lock.acquire(blocking=False):
            self._deferred.append(slab)
            return
        try:
            if self._outstanding.pop(slab.addr, None) is not None:
                self.outstanding_bytes -= slab.nbytes
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
                if self._outstanding.pop(slab.addr, None) is not None:
                    self.outstanding_bytes -= slab.nbytes
            self._store(slab)

    def _store(self, slab: _Slab) -> None:
        evicted: List[_Slab] = []
        # tsalint: allow[restricted-context] safe from the _put finalizer: its acquire(blocking=False) gate proved this thread does NOT hold the pool lock (a holder defers instead), and no pool path blocks while holding it (lock-blocking enforces that), so this acquire cannot self-deadlock
        with self._lock:
            while self._free_bytes + slab.nbytes > self._limit:
                others = [group for size, group in self._free.items() if group and size != slab.nbytes]
                if not others:
                    break
                victim = min(others, key=lambda group: group[0].stamp).pop(0)
                self._free_bytes -= victim.nbytes
                evicted.append(victim)
            keep = self._free_bytes + slab.nbytes <= self._limit
            if keep:
                self._stamp += 1
                slab.stamp = self._stamp
                self._free.setdefault(slab.nbytes, []).append(slab)
                self._free_bytes += slab.nbytes
        for victim in evicted:
            self._destroy(victim)
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


def streaming_enabled() -> bool:
    """``TORCHSNAPSHOT_GPU_STREAM_WRITES`` (default on): whether stagers
    may stream."""
    return os.environ.get(STREAM_WRITES_ENV_VAR, "1") not in ("0", "false", "")


def _pool_limit() -> int:
    raw = os.environ.get(STAGING_POOL_ENV_VAR, "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            logger.warning("ignoring %s=%r: not an integer", STAGING_POOL_ENV_VAR, raw)
    return _DEFAULT_STAGING_POOL_BYTES


_staging_pool = _StagingPool(_pool_limit())


def share_staging_pool(local_ranks: int) -> None:
    """Cap the pool at its default limit's share among ``local_ranks`` > 1
    processes that share this host. ``TORCHSNAPSHOT_GPU_STAGING_POOL_BYTES``,
    when set, is each process's own limit and stays."""
    if local_ranks > 1 and not os.environ.get(STAGING_POOL_ENV_VAR, "").strip():
        _staging_pool._limit = min(_staging_pool._limit, _DEFAULT_STAGING_POOL_BYTES // local_ranks)


def stream_slab_bytes(sub_chunk_bytes: int) -> int:
    """The slab size a stream of ``sub_chunk_bytes`` sub-chunks draws for
    every sub-chunk, its shorter last one too: the next power of two. The
    governor's elected size moves with the measured rate, and exact-size
    free lists would then hand no slab of an earlier stream to the next;
    a few size classes keep them recycled (and registered) for at most
    twice the bytes."""
    return 1 << max(12, (max(1, sub_chunk_bytes) - 1).bit_length())


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

    def synchronize(self) -> None:
        """Wait until every stream made so far has drained."""
        for stream in self._streams.values():
            stream.synchronize()


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
        # False for a tensor that save_dtype converted: it stages buffered.
        self.streamable = True
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

    # ----------------------------------------------------- streaming path

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        """True when the payload can be produced as sub-chunks: only the
        plain path streams (array.py:844-887 of the JAX package): no dedup
        context, no codec, no write-batcher byte range, no ``save_dtype``
        conversion (``streamable``), and a contiguous CPU or CUDA tensor
        of at least two sub-chunks whose bytes are its elements'.
        Checksums stream: the CRC chains across sub-chunks."""
        if not streaming_enabled() or not self.streamable:
            return False
        if self.dedup is not None or self._active_codec() is not None:
            return False
        if self.entry.byte_range is not None:
            return False
        t = self.tensor
        if t.device.type not in ("cpu", "cuda") or not t.is_contiguous():
            return False
        nbytes = array_size_bytes(t.shape, self.entry.dtype)
        if nbytes != t.numel() * t.element_size():
            return False  # sub-byte dtypes
        return nbytes >= 2 * sub_chunk_bytes

    def _checksum_init(self) -> Optional[Tuple[str, int]]:
        """``(algo, running value)``, or None with checksums off. The
        algorithm is ``compute_checksum``'s, so a streamed and a buffered
        take record the same checksum."""
        if not checksums_enabled():
            return None
        return ("crc32c", 0) if _native.native_available() else ("crc32", 0)

    @staticmethod
    def _checksum_update(state, chunk):
        if state is None:
            return None
        algo, value = state
        if algo == "crc32c":
            return (algo, _native.crc32c(chunk, value))
        return (algo, zlib.crc32(memoryview(chunk).cast("B"), value))

    def _checksum_finish(self, state) -> None:
        if state is not None:
            algo, value = state
            self.entry.checksum = f"{algo}:{value & 0xFFFFFFFF:08x}"

    def _host_sub_chunk(self, mv: memoryview, lo: int, hi: int, state, slab_bytes: int):
        """One sub-chunk of a CPU tensor: a zero-copy slice on a blocking
        take, else a copy into a pooled slab fused with the running CRC32C
        (array.py:921-938 of the JAX package). Returns (buffer, state)."""
        with telemetry.span("sub_chunk_stage", cat="stager", bytes=hi - lo):
            return self._host_sub_chunk_impl(mv, lo, hi, state, slab_bytes)

    def _host_sub_chunk_impl(self, mv: memoryview, lo: int, hi: int, state, slab_bytes: int):
        chunk = mv[lo:hi]
        if not self.copy_cpu:
            return chunk, self._checksum_update(state, chunk)
        slab = pooled_buffer(stream_slab_bytes(slab_bytes))
        dst = slab.numpy()[: hi - lo] if slab is not None else np.empty(hi - lo, np.uint8)
        if state is not None and state[0] == "crc32c":
            crc = _native.copy_crc32c(dst, chunk, state[1])
            if crc is not None:
                return memoryview(dst), ("crc32c", crc)
        np.copyto(dst, np.frombuffer(chunk, np.uint8))
        return memoryview(dst), self._checksum_update(state, chunk)

    def _issue_dtoh(self, flat: torch.Tensor, lo: int, hi: int, host: torch.Tensor) -> torch.cuda.Event:
        """Queue the DtoH copy of ``flat[lo:hi]`` into ``host`` on the side
        stream; the slab is fenced by the copy's event."""
        event = torch.cuda.Event()
        with self._on_stream():
            host.copy_(flat[lo:hi], non_blocking=True)
            event.record(self.stream)
        _staging_pool.fence(host, event)
        return event

    def _land(self, host: torch.Tensor, event: torch.cuda.Event, state):
        """Wait for one sub-chunk's copy, then advance the CRC over it."""
        with telemetry.span("sub_chunk_dtoh", cat="stager"):
            event.synchronize()
        buf = tensor_as_memoryview(host)
        return buf, self._checksum_update(state, buf)

    async def stage_stream(self, executor, sub_chunk_bytes: int):
        """Ordered sub-chunk buffers; their concatenation is the buffered
        payload and the entry records the same checksum. All byte work
        runs in ``executor``, never on the event loop.

        CPU tensor: sub-chunk N+1 is staged (sliced or copied, and summed)
        in the executor while the consumer writes N.

        CUDA tensor: the sub-chunks are byte ranges of the tensor's flat
        uint8 view. The DtoH copy of sub-chunk N+1 is queued on the
        tensor's side stream, into a registered slab fenced by the copy's
        event, before sub-chunk N's checksum is awaited and N is yielded;
        N+1's wait-and-checksum then runs in the executor while N is
        written. A stream holds at most ``STREAM_DEPTH`` + 1 slabs: the one
        being written, the one landing and the one just queued."""
        loop = asyncio.get_running_loop()
        state = self._checksum_init()
        t = self.tensor
        total = array_size_bytes(t.shape, self.entry.dtype)
        bounds = list(range(0, total, sub_chunk_bytes)) + [total]
        spans = list(zip(bounds[:-1], bounds[1:]))
        fut = None
        try:
            if not t.is_cuda:
                mv = tensor_as_memoryview(_flat_bytes(t))
                fut = loop.run_in_executor(
                    executor, self._host_sub_chunk, mv, *spans[0], state, sub_chunk_bytes
                )
                for nxt in spans[1:]:
                    chunk, state = await fut
                    fut = loop.run_in_executor(
                        executor, self._host_sub_chunk, mv, *nxt, state, sub_chunk_bytes
                    )
                    yield chunk
            else:
                flat = _flat_bytes(t)
                slab_bytes = stream_slab_bytes(sub_chunk_bytes)

                async def issue(lo: int, hi: int):
                    slab = await loop.run_in_executor(executor, _device_staging_buffer, slab_bytes)
                    host = slab[: hi - lo]
                    return host, self._issue_dtoh(flat, lo, hi, host)

                fut = loop.run_in_executor(executor, self._land, *(await issue(*spans[0])), state)
                for nxt in spans[1:]:
                    pending = await issue(*nxt)
                    chunk, state = await fut
                    fut = loop.run_in_executor(executor, self._land, *pending, state)
                    del pending
                    yield chunk
            chunk, state = await fut
            fut = None
            yield chunk
        finally:
            if fut is not None:
                # A stream abandoned mid-way: let the in-flight stage end
                # before its buffers are dropped.
                try:
                    await fut
                except Exception:  # noqa: BLE001 - unwinding
                    pass
        self._checksum_finish(state)


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

    # ----------------------------------------------------- streaming path

    def _byte_copy_dst(self) -> bool:
        """Whether restored bytes can land in ``dst`` as they are: no
        destination, or one of the entry's dtype, contiguous, whose bytes
        are its elements'. Casts and strided destinations stay buffered."""
        dst = self.dst
        if dst is None:
            return True
        return (
            dst.dtype == string_to_dtype(self.entry.dtype)
            and dst.is_contiguous()
            and dst.numel() * dst.element_size() == self._raw_nbytes()
        )

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        """Streams when the stored payload spans at least two sub-chunks,
        its codec (if any) decodes incrementally and the destination takes
        the bytes as they are (array.py:1356-1367 of the JAX package)."""
        if _stored_size(self.entry) < 2 * sub_chunk_bytes:
            return False
        return StreamingDecompressor.available(self.entry.codec) and self._byte_copy_dst()

    def stream_admission_cost(self, sub_chunk_bytes: int) -> int:
        cost = self.get_consuming_cost_bytes()
        if self.stream is not None:
            # The device sink holds on the host only the chunk being
            # copied and the plugin's read-ahead: the payload assembles in
            # device memory.
            return min(cost, (STREAM_DEPTH + 1) * sub_chunk_bytes)
        # The host sink holds the whole payload until it verifies.
        return cost

    def streams_on_fast_storage(self) -> bool:
        """False for a CUDA destination: the device sink reads each window
        by ``preadv`` and then hashes it, two passes over the bytes, where
        the buffered path maps the file and copies with the CRC32C fused;
        on an H100 host the streamed restore of page-cached payloads was
        the slower one (PERF.md)."""
        return self.stream is None

    async def consume_stream(self, stream: ReadStream, executor=None) -> None:
        """Verify (chained CRC32C), decode and collect each sub-chunk as it
        arrives; commit to the destination only after the whole payload
        verified. A CUDA destination assembles in a device scratch buffer
        (:class:`_DeviceScratchSink`), anything else in a host slab
        (:class:`_ScratchSink`). A mismatch raises and leaves the
        destination as it was."""
        loop = asyncio.get_running_loop()
        nbytes = self._raw_nbytes()
        if self.stream is not None:
            sink = _DeviceScratchSink(nbytes, self.dst.device, self.stream)
        else:
            sink = _ScratchSink(nbytes)
        decoder = _IncrementalEntryDecoder(self.entry, sink.add)

        def finish():
            decoder.finish()  # a checksum mismatch raises before any commit
            if self.stream is not None:
                sink.commit(_flat_bytes(self.dst))
                return self.dst
            value = tensor_from_buffer(sink.finish(), self.entry.dtype, self.entry.shape)
            if self.dst is not None:
                _copy_cpu(self.dst, value)
                return self.dst
            return value

        try:
            async for chunk in stream.chunks:
                await loop.run_in_executor(executor, decoder.add, chunk)
            value = await loop.run_in_executor(executor, finish)
        finally:
            await loop.run_in_executor(executor, sink.close)
        if self.callback is not None:
            self.callback(value)


def _stored_size(entry: ArrayEntry) -> int:
    """Bytes storage delivers for ``entry``: its byte range in a batched
    slab, else its raw size (a compressed payload's stored size is not
    recorded; the raw size stands in for it)."""
    if entry.byte_range is not None:
        lo, hi = entry.byte_range
        return max(0, hi - lo)
    return array_size_bytes(entry.shape, entry.dtype)


class _IncrementalEntryDecoder:
    """Per-sub-chunk verify and decompress of one entry's streamed payload
    (array.py:1195-1235 of the JAX package): the chained CRC advances over
    the stored bytes as ``verify_checksum`` would hash them, a codec's
    stream decoder takes the same chunk, and the raw bytes go to
    ``sink_add``. ``finish`` flushes the codec and raises on a checksum
    mismatch."""

    def __init__(self, entry: ArrayEntry, sink_add: Callable) -> None:
        self.verifier = IncrementalVerifier(entry.checksum, entry.location)
        self.decomp = (
            StreamingDecompressor(
                entry.codec, expected_size=array_size_bytes(entry.shape, entry.dtype)
            )
            if entry.codec is not None
            else None
        )
        self.sink_add = sink_add

    def add(self, chunk) -> None:
        with telemetry.span("consume_chunk", cat="consumer", bytes=memoryview(chunk).nbytes):
            self.verifier.update(chunk)
            data = self.decomp.feed(chunk) if self.decomp is not None else chunk
            if memoryview(data).nbytes:
                self.sink_add(data)

    def finish(self) -> None:
        if self.decomp is not None:
            tail = self.decomp.finish()
            if tail:
                self.sink_add(tail)
        self.verifier.finish()


class _ScratchSink:
    """Host sink of a streamed consume: the raw bytes collect in a pooled
    slab and nothing touches the destination until the checksum verified
    (array.py:1087-1123 of the JAX package)."""

    def __init__(self, nbytes: int) -> None:
        slab = pooled_buffer(nbytes)
        self.buf = slab.numpy() if slab is not None else np.empty(nbytes, np.uint8)
        self.pos = 0

    def add(self, data) -> None:
        mv = memoryview(data).cast("B")
        if self.pos + mv.nbytes > self.buf.nbytes:
            raise IOError(f"read stream produced more than the expected {self.buf.nbytes} bytes")
        np.copyto(self.buf[self.pos : self.pos + mv.nbytes], np.frombuffer(mv, np.uint8))
        self.pos += mv.nbytes

    def finish(self) -> memoryview:
        if self.pos != self.buf.nbytes:
            raise IOError(f"short read stream: produced {self.pos} of {self.buf.nbytes} bytes")
        return memoryview(self.buf)

    def close(self) -> None:
        pass


class _DeviceScratchSink:
    """Device sink of a streamed consume into a CUDA tensor, which the port
    restores in place (the JAX package assembles a new array instead,
    ``_DeviceRowSink``, array.py:1125-1170). Each sub-chunk is copied HtoD
    on the side stream into a device scratch buffer of the entry's size,
    straight from the read window it arrived in (a pooled slab, registered
    with CUDA on first use) or else through a registered staging slab; the
    slab is fenced by that copy's event. The destination is written only
    by :meth:`commit`, a device copy of the scratch buffer on the same
    stream, after the payload verified: a mismatch leaves it as it was.

    Device memory: one scratch buffer of the entry's size (at most 512 MiB
    under the chunking policy) per streamed entry in flight. Host memory:
    the chunks whose copies have not landed, at most ``STREAM_DEPTH``
    before the sink waits for the oldest."""

    def __init__(self, nbytes: int, device: torch.device, stream: torch.cuda.Stream) -> None:
        self.nbytes = nbytes
        self.device = device
        self.stream = stream
        # Allocated by the first add, in the executor: a cudaMalloc there
        # does not hold the event loop.
        self.scratch: Optional[torch.Tensor] = None
        self.pos = 0
        self._inflight: "deque[Tuple[torch.cuda.Event, object]]" = deque()

    @staticmethod
    def _pinned_host(data) -> torch.Tensor:
        """``data`` as a uint8 CPU tensor a DMA can read: the registered
        slab it lies in, or a copy into a registered staging slab."""
        mv = memoryview(data).cast("B")
        if not mv.readonly:
            host = torch.frombuffer(mv, dtype=torch.uint8)
            if _staging_pool.pin(host):
                return host
        staged = _device_staging_buffer(stream_slab_bytes(mv.nbytes))[: mv.nbytes]
        np.copyto(staged.numpy(), np.frombuffer(mv, np.uint8))
        return staged

    def add(self, data) -> None:
        with telemetry.span("sub_chunk_htod", cat="consumer", bytes=memoryview(data).nbytes):
            self._add(data)

    def _add(self, data) -> None:
        host = self._pinned_host(data)
        n = host.numel()
        if self.pos + n > self.nbytes:
            raise IOError(f"read stream produced more than the expected {self.nbytes} bytes")
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            if self.scratch is None:
                self.scratch = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
            self.scratch[self.pos : self.pos + n].copy_(host, non_blocking=True)
            event.record(self.stream)
        _staging_pool.fence(host, event)
        self.pos += n
        # The host bytes stay referenced until their copy has landed.
        self._inflight.append((event, (host, data)))
        while self._inflight and (
            len(self._inflight) > STREAM_DEPTH or self._inflight[0][0].query()
        ):
            self._inflight.popleft()[0].synchronize()

    def commit(self, dst_bytes: torch.Tensor) -> None:
        if self.pos != self.nbytes:
            raise IOError(f"short read stream: produced {self.pos} of {self.nbytes} bytes")
        if self.nbytes == 0:
            return
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            dst_bytes.copy_(self.scratch, non_blocking=True)
            event.record(self.stream)
        event.synchronize()

    def close(self) -> None:
        while self._inflight:
            self._inflight.popleft()[0].synchronize()
        # Freed on the side stream that last used it.
        self.scratch = None


class _ArrayAssembler:
    """The destination of one entry's budget-split reads: the ranges fill
    flat slices of ``dst`` (through a contiguous scratch copy when ``dst``
    is not contiguous, copied back once the last range landed), and
    ``callback`` fires with ``dst`` when the last range is done
    (array.py:1564-1617 of the JAX package)."""

    def __init__(
        self,
        dst: torch.Tensor,
        num_parts: int,
        callback: Optional[Callable[[torch.Tensor], None]],
        stream: Optional[torch.cuda.Stream],
    ) -> None:
        self.dst = dst
        self.stream = stream
        self.scratch = dst
        if not dst.is_contiguous():
            self.scratch = dst.contiguous()
            if stream is not None:
                # The scratch copy was queued on the caller's stream.
                stream.wait_stream(torch.cuda.current_stream(dst.device))
        self.flat = self.scratch.reshape(-1)
        self.callback = callback
        self._remaining = num_parts
        self._lock = threading.Lock()

    def part_done(self) -> None:
        # Parts are consumed concurrently from executor threads.
        with self._lock:
            self._remaining -= 1
            last = self._remaining == 0
        if not last:
            return
        if self.scratch is not self.dst:
            if self.stream is not None:
                with torch.cuda.stream(self.stream):
                    self.dst.copy_(self.scratch, non_blocking=True)
                self.stream.synchronize()
            else:
                self.dst.copy_(self.scratch)
        if self.callback is not None:
            self.callback(self.dst)


class _SlicedArrayConsumer(BufferConsumer):
    """Consumes one byte range of a raw entry into the matching flat slice
    ``[elem_lo, elem_hi)`` of the assembler's destination (array.py:1466-1530
    of the JAX package). The range carries no checksum: it is not verified
    (see the module docstring)."""

    def __init__(
        self, entry: ArrayEntry, assembler: _ArrayAssembler, elem_lo: int, elem_hi: int
    ) -> None:
        self.entry = entry
        self.assembler = assembler
        self.elem_lo = elem_lo
        self.elem_hi = elem_hi
        self.src_dtype = string_to_dtype(entry.dtype)

    def _slice(self) -> torch.Tensor:
        return self.assembler.flat[self.elem_lo : self.elem_hi]

    def _fill_cpu(self, buf: BufferType) -> None:
        values = tensor_from_buffer(buf, self.entry.dtype, (self.elem_hi - self.elem_lo,))
        _copy_cpu(self._slice(), values)

    def _copy_range_to_cuda(self, host: torch.Tensor, byte_lo: int) -> torch.cuda.Event:
        """Queue the HtoD copy of ``host`` (raw bytes of this range, from
        ``byte_lo`` within it) into the destination slice on the side
        stream; returns its event, which also fences ``host``'s slab. A
        dtype cast takes the whole range at once (``byte_lo`` 0)."""
        dst = self._slice()
        event = torch.cuda.Event()
        with torch.cuda.stream(self.assembler.stream):
            if dst.dtype == self.src_dtype:
                _flat_bytes(dst)[byte_lo : byte_lo + host.numel()].copy_(host, non_blocking=True)
            else:
                dst.copy_(host.view(self.src_dtype), non_blocking=True)
            event.record(self.assembler.stream)
        _staging_pool.fence(host, event)
        return event

    def _stage(self, buf: BufferType) -> torch.Tensor:
        mv = memoryview(buf).cast("B")
        host = _device_staging_buffer(mv.nbytes)
        np.copyto(host.numpy(), np.frombuffer(mv, np.uint8))
        return host

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        loop = asyncio.get_running_loop()
        if self.assembler.stream is None:
            await loop.run_in_executor(executor, self._fill_cpu, buf)
        elif self.elem_hi > self.elem_lo:
            host = await loop.run_in_executor(executor, self._stage, buf)
            event = self._copy_range_to_cuda(host, 0)
            await _wait_event(event, executor)
            del host
        self.assembler.part_done()

    def get_consuming_cost_bytes(self) -> int:
        return (self.elem_hi - self.elem_lo) * array_size_bytes((1,), self.entry.dtype)

    # ----------------------------------------------------- streaming path

    def _direct_bytes(self) -> Optional[torch.Tensor]:
        """The destination slice's raw bytes when stored bytes can land
        there as they are (no dtype cast pending)."""
        dst = self._slice()
        if dst.dtype != self.src_dtype:
            return None
        return _flat_bytes(dst)

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        # A range carries no checksum or codec, so streaming is a plain
        # incremental byte fill of the destination, with the partial-fill
        # semantics a buffered failure between ranges already has.
        if self.get_consuming_cost_bytes() < 2 * sub_chunk_bytes:
            return False
        return self._direct_bytes() is not None

    def stream_admission_cost(self, sub_chunk_bytes: int) -> int:
        # The destination exists before the read; only the chunks in
        # flight are new.
        return min(self.get_consuming_cost_bytes(), STREAM_DEPTH * sub_chunk_bytes)

    def streams_on_fast_storage(self) -> bool:
        """False for a CUDA destination, as for ``ArrayBufferConsumer``:
        on page-cache reads the buffered range is the faster one there."""
        return self.assembler.stream is None

    async def consume_stream(self, stream: ReadStream, executor=None) -> None:
        loop = asyncio.get_running_loop()
        total = self.get_consuming_cost_bytes()
        dst = self._direct_bytes()
        cuda = self.assembler.stream is not None
        inflight: "deque[Tuple[torch.cuda.Event, object]]" = deque()
        pos = 0

        def fill(chunk) -> int:
            mv = memoryview(chunk).cast("B")
            if pos + mv.nbytes > total:
                raise IOError(
                    f"read stream produced more than the expected {total} bytes for "
                    f"{self.entry.location}"
                )
            if not cuda:
                np.copyto(dst[pos : pos + mv.nbytes].numpy(), np.frombuffer(mv, np.uint8))
                return mv.nbytes
            host = _DeviceScratchSink._pinned_host(mv)
            inflight.append((self._copy_range_to_cuda(host, pos), (host, chunk)))
            while inflight and (len(inflight) > STREAM_DEPTH or inflight[0][0].query()):
                inflight.popleft()[0].synchronize()
            return mv.nbytes

        def drain() -> None:
            while inflight:
                inflight.popleft()[0].synchronize()

        try:
            async for chunk in stream.chunks:
                pos += await loop.run_in_executor(executor, fill, chunk)
        finally:
            await loop.run_in_executor(executor, drain)
        if pos != total:
            raise IOError(
                f"short read stream for {self.entry.location}: produced {pos} of {total} bytes"
            )
        self.assembler.part_done()


def _prepare_chunked_read(
    entry: ArrayEntry,
    dst: Optional[torch.Tensor],
    callback: Optional[Callable[[torch.Tensor], None]],
    streams: DeviceStreams,
    buffer_size_limit_bytes: int,
) -> List[ReadReq]:
    """Reads of ``entry`` in byte ranges of at most
    ``buffer_size_limit_bytes`` (whole elements, at least one), each into
    its flat slice of ``dst`` (a new CPU tensor when None;
    array.py:1620-1656 of the JAX package)."""
    itemsize = array_size_bytes((1,), entry.dtype)
    total_elems = math.prod(entry.shape)
    elems_per_read = max(1, buffer_size_limit_bytes // itemsize)
    if dst is None:
        dst = torch.empty(tuple(entry.shape), dtype=string_to_dtype(entry.dtype))
    ranges = [
        (lo, min(lo + elems_per_read, total_elems)) for lo in range(0, total_elems, elems_per_read)
    ] or [(0, 0)]
    stream = streams.get(dst.device) if dst.is_cuda else None
    assembler = _ArrayAssembler(dst, len(ranges), callback, stream)
    base = entry.byte_range[0] if entry.byte_range is not None else 0
    return [
        ReadReq(
            path=entry.location,
            buffer_consumer=_SlicedArrayConsumer(entry, assembler, lo, hi),
            byte_range=(base + lo * itemsize, base + hi * itemsize),
            origin=entry.origin,
        )
        for lo, hi in ranges
    ]


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
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> List[ReadReq]:
        """One read of the whole entry, or, under
        ``buffer_size_limit_bytes``, unverified byte ranges of at most that
        size (:func:`_prepare_chunked_read`). A compressed entry has no
        random access into its stream: it is read whole, budget or not
        (array.py:1441-1444 of the JAX package)."""
        if buffer_size_limit_bytes is not None and entry.codec is None:
            return _prepare_chunked_read(entry, dst, callback, streams, buffer_size_limit_bytes)
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
    the JAX package's signature: each rank warms every chunk of a
    replicated tensor, a superset of its stripe. A sharded DTensor draws
    the pieces this rank writes."""
    from ..flatten import flatten
    from ..serialization import effective_save_dtype
    from .chunked import ChunkedArrayIOPreparer
    from .prepare import is_dtensor, is_sharded_dtensor
    from .sharded import ShardedArrayIOPreparer, dtensor_view

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
            if is_sharded_dtensor(leaf):
                sizes.extend(
                    (n, leaf.is_cuda)
                    for n in ShardedArrayIOPreparer.staged_piece_sizes(dtensor_view(leaf), dtype_str)
                )
                continue
            if is_dtensor(leaf):
                leaf = leaf.to_local()
            for _, piece_shape in ChunkedArrayIOPreparer.chunk_shards(tuple(leaf.shape), dtype_str):
                sizes.append((array_size_bytes(piece_shape or leaf.shape, dtype_str), leaf.is_cuda))
    return _staging_pool.prewarm(sizes)
