"""The port's staging slab pool (``io_preparers/array.py``): recycling by
the garbage collector only when the last reference to a slab dies, the
pool limit, the CUDA registration of slabs (``cudaHostRegister`` stood in
for by a fake here; the card-only tests are in
``tests/test_torch_staging_pool_cuda.py``), the event fence of a slab, and
``warmup_staging``."""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.integrity import IntegrityError
from torchsnapshot_tpu_torch.io_preparers import array as A
from torchsnapshot_tpu_torch.io_preparers.array import (
    ArrayBufferConsumer,
    DeviceStreams,
    _StagingPool,
    warmup_staging,
)
from torchsnapshot_tpu_torch.manifest import ArrayEntry
from torch_test_env import autotune_never  # noqa: F401 - autouse

N = 1 << 16


class FakeCudart:
    """cudaHostRegister / cudaHostUnregister, recorded."""

    def __init__(self, fail: bool = False) -> None:
        self.registered, self.unregistered, self.fail = [], [], fail

    def cudaHostRegister(self, ptr, size, flags):
        if self.fail:
            return 2  # cudaErrorMemoryAllocation
        self.registered.append((ptr, size, flags))
        return 0

    def cudaHostUnregister(self, ptr):
        self.unregistered.append(ptr)
        return 0


class FakeEvent:
    def __init__(self) -> None:
        self.waits = 0

    def synchronize(self) -> None:
        self.waits += 1


@pytest.fixture()
def cudart(monkeypatch) -> FakeCudart:
    fake = FakeCudart()
    monkeypatch.setattr(A, "_cudart", lambda: fake)
    return fake


@pytest.fixture()
def pool(cudart):
    """A small pool, cleared while the fake CUDA runtime is in place."""
    p = _StagingPool(limit_bytes=4 * N)
    yield p
    gc.collect()
    p.clear()


def test_slab_recycles_only_when_the_last_reference_dies(pool) -> None:
    buf = pool.get(N)
    ptr = buf.data_ptr()
    buf[:] = 7
    views = [buf[10:20], buf.numpy()[5:9], memoryview(buf.numpy())]
    del buf
    gc.collect()
    for keep in views:
        other = pool.get(N)  # the slab is still referenced: a new one
        assert other.data_ptr() != ptr
        other[:] = 99
        assert bytes(memoryview(keep.numpy() if isinstance(keep, torch.Tensor) else keep)[:1]) == b"\x07"
        del other
    del views, keep
    gc.collect()
    pool.free_bytes()
    assert ptr in {slab.addr for slab in pool._free[N]}


def test_same_slab_comes_back_after_release(pool) -> None:
    buf = pool.get(N)
    ptr = buf.data_ptr()
    del buf
    gc.collect()
    again = pool.get(N)
    assert again.data_ptr() == ptr and pool.hits == 1


def test_free_bytes_stay_under_the_limit(pool) -> None:
    bufs = [pool.get(N) for _ in range(6)]
    del bufs
    gc.collect()
    assert pool.free_bytes() == 4 * N  # two of the six were freed, not pooled


def test_small_sizes_and_no_library_are_not_pooled(pool, monkeypatch) -> None:
    assert pool.get(A._NATIVE_SLAB_MIN_BYTES - 1) is None
    monkeypatch.setattr(_StagingPool, "available", staticmethod(lambda: False))
    assert pool.get(N) is None and pool.prewarm([(N, False)]) == 0


def test_registration_once_per_slab_matched_by_unregistration(pool, cudart) -> None:
    buf = pool.get(N, pinned=True)
    ptr = buf.data_ptr()
    assert cudart.registered == [(ptr, N, 1)]
    del buf
    gc.collect()
    again = pool.get(N, pinned=True)  # recycled: already registered
    assert again.data_ptr() == ptr and len(cudart.registered) == 1
    second = pool.get(N, pinned=True)  # a new slab: registered once
    assert len(cudart.registered) == 2 and pool.registered_bytes == 2 * N
    del again, second
    gc.collect()
    assert pool.clear() == 2 * N
    assert sorted(cudart.unregistered) == sorted(p for p, _, _ in cudart.registered)
    assert pool.registered_bytes == 0


def test_an_unpinned_slab_is_registered_when_a_device_copy_draws_it(pool, cudart) -> None:
    buf = pool.get(N)
    ptr = buf.data_ptr()
    del buf
    gc.collect()
    assert cudart.registered == []
    assert pool.get(N, pinned=True).data_ptr() == ptr
    assert cudart.registered == [(ptr, N, 1)]


def test_evicted_registered_slab_is_unregistered(cudart) -> None:
    pool = _StagingPool(limit_bytes=N)
    bufs = [pool.get(N, pinned=True) for _ in range(2)]
    del bufs
    gc.collect()
    assert len(cudart.unregistered) == 1  # the one that did not fit
    pool.clear()
    assert len(cudart.unregistered) == 2


def test_failed_registration_raises_and_frees_the_slab(pool, monkeypatch) -> None:
    fake = FakeCudart(fail=True)
    monkeypatch.setattr(A, "_cudart", lambda: fake)
    with pytest.raises(RuntimeError, match="cudaHostRegister"):
        pool.get(N, pinned=True)
    assert pool.free_bytes() == 0 and pool.registered_bytes == 0


def test_a_fenced_slab_waits_for_its_event_before_reuse(pool, cudart) -> None:
    buf = pool.get(N, pinned=True)
    event = FakeEvent()
    pool.fence(buf, event)
    del buf
    gc.collect()
    assert event.waits == 0
    pool.get(N, pinned=True)
    assert event.waits == 1
    fenced = pool.get(N, pinned=True)
    other_event = FakeEvent()
    pool.fence(fenced, other_event)
    del fenced
    gc.collect()
    pool.clear()  # eviction waits too
    assert other_event.waits == 1


def test_prewarm_counts_pooled_slabs_and_registers_pinned_ones(pool, cudart) -> None:
    assert pool.prewarm([(N, False), (N, False)]) == 2 * N
    assert pool.prewarm([(N, False)]) == 0
    assert pool.prewarm([(N, True)]) == N  # one pooled slab registered
    assert len(cudart.registered) == 1
    assert pool.prewarm([(N, True)] * 3) == 2 * N  # one more registered, one new
    assert pool.free_bytes() == 3 * N


def test_warmup_staging_sizes_follow_the_write_plan(monkeypatch) -> None:
    from torchsnapshot_tpu_torch.io_preparers import chunked

    monkeypatch.setattr(A, "_staging_pool", _StagingPool(limit_bytes=1 << 30))
    monkeypatch.setattr(chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 40_000)
    state = {"app": P.StateDict(w=torch.zeros(100, 250), b=torch.zeros(8), s=3)}
    # w: 100 000 B in chunks of 40 rows (40 000 B) and one of 20 rows;
    # b is under the slab minimum.
    assert warmup_staging(state) == 2 * 40_000 + 20_000
    assert warmup_staging(state) == 0
    half = {"app": P.StateDict(w=torch.zeros(100, 250))}
    # bf16: chunks of 80 rows (40 000 B, already pooled) and 20 rows.
    assert warmup_staging(half, save_dtype={"app/*": "bfloat16"}) == 10_000
    assert warmup_staging(state, host_copies=False) == 0  # no CUDA tensors
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_CHECKSUM", "0")
    assert warmup_staging({"app": P.StateDict(x=torch.zeros(10_000))}) == 0
    A._staging_pool.clear()


def test_async_takes_reuse_the_warmed_slabs(tmp_path, monkeypatch) -> None:
    pool = _StagingPool(limit_bytes=1 << 30)
    monkeypatch.setattr(A, "_staging_pool", pool)
    state = {"app": P.StateDict(a=torch.arange(50_000.0), b=torch.arange(30_000, dtype=torch.int64))}
    assert warmup_staging(state) == 200_000 + 240_000
    for i in range(3):
        P.Snapshot.async_take(str(tmp_path / f"s{i}"), state).wait()
        gc.collect()
    assert pool.misses == 0 and pool.hits == 6
    dst = {"app": P.StateDict(a=torch.zeros(50_000), b=torch.zeros(30_000, dtype=torch.int64))}
    P.Snapshot(str(tmp_path / "s2")).restore(dst)
    assert torch.equal(dst["app"]["a"], state["app"]["a"])
    pool.clear()


def _consumer(data: np.ndarray, checksum):
    entry = ArrayEntry(
        location="0/w", serializer="buffer_protocol", dtype="uint8", shape=[data.size], replicated=False,
        checksum=checksum,
    )
    return ArrayBufferConsumer(entry, None, None, DeviceStreams())


@pytest.fixture()
def process_pool(monkeypatch, cudart):
    """A fresh process staging pool, cleared while the fake CUDA runtime
    that registered its slabs is still in place."""
    p = _StagingPool(limit_bytes=1 << 30)
    monkeypatch.setattr(A, "_staging_pool", p)
    yield p
    gc.collect()
    p.clear()


def test_restore_staging_copies_and_verifies_in_one_pass(process_pool, cudart) -> None:
    from torchsnapshot_tpu_torch._native import crc32c

    data = np.random.default_rng(0).integers(0, 256, N, np.uint8)
    good = f"crc32c:{crc32c(data):08x}"
    host = _consumer(data, good)._stage_for_device(memoryview(data))
    assert np.array_equal(host.numpy(), data) and len(cudart.registered) >= 1
    bad = data.copy()
    bad[123] ^= 4
    with pytest.raises(IntegrityError, match="checksum mismatch"):
        _consumer(data, good)._stage_for_device(memoryview(bad))
