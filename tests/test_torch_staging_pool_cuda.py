"""The staging slab pool on the card: slabs registered with
``cudaHostRegister`` are pinned, device copies through them are right, and
a slab dropped while a device-to-host copy into it is in flight is not
handed out again before that copy has landed.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_staging_pool_cuda.py
"""

from __future__ import annotations

import gc

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.io_preparers import array as A
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture()
def pool(card, monkeypatch):
    p = A._StagingPool(limit_bytes=1 << 30)
    monkeypatch.setattr(A, "_staging_pool", p)
    yield p
    torch.cuda.synchronize()
    gc.collect()
    p.clear()


def test_registered_slabs_are_pinned(pool) -> None:
    plain = A.pooled_buffer(1 << 20)
    assert plain is not None and not plain.is_pinned()
    pinned = A.pooled_buffer(1 << 20, pinned=True)
    assert pinned.is_pinned() and pool.registered_bytes == 1 << 20
    del plain, pinned
    gc.collect()
    again = A.pooled_buffer(1 << 20, pinned=True)  # recycled, still registered
    assert again.is_pinned()


def test_device_copies_through_a_slab(pool, card) -> None:
    src = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8, device=card)
    host = A.pooled_buffer(src.numel(), pinned=True)
    host.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(host, src.cpu())
    back = torch.empty_like(src)
    back.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(back, src)


def test_slab_dropped_under_an_in_flight_copy_is_not_reused_early(pool, card) -> None:
    nbytes = 256 << 20
    src = torch.full((nbytes,), 7, dtype=torch.uint8, device=card)
    stream = torch.cuda.Stream()
    host = A.pooled_buffer(nbytes, pinned=True)
    ptr = host.data_ptr()
    event = torch.cuda.Event()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(2_000_000_000)  # about 1 s: the copy is still queued below
        host.copy_(src, non_blocking=True)
        event.record(stream)
    pool.fence(host, event)
    del host  # as a cancelled staging task would drop it
    gc.collect()
    assert not event.query()
    again = A.pooled_buffer(nbytes, pinned=True)
    assert again.data_ptr() == ptr
    assert event.query()  # get waited on the fence
    assert bool((again == 7).all())


def test_take_and_restore_stage_through_registered_slabs(pool, card, tmp_path, monkeypatch) -> None:
    staged = []
    real = A.ArrayBufferStager._stage_cuda

    async def spy(self, executor):
        host = await real(self, executor)
        staged.append(host.is_pinned())
        return host

    monkeypatch.setattr(A.ArrayBufferStager, "_stage_cuda", spy)
    state = {f"t{i}": torch.randn(1 << 20, device=card) for i in range(4)}
    assert P.warmup_staging({"m": P.StateDict(state)}) == 4 * (4 << 20)
    P.Snapshot.async_take(str(tmp_path / "s"), {"m": P.StateDict(state)}).wait()
    assert staged == [True] * 4 and pool.misses == 0
    dst = {k: torch.zeros_like(v) for k, v in state.items()}
    P.Snapshot(str(tmp_path / "s")).restore({"m": P.StateDict(dst)})
    torch.cuda.synchronize()
    assert all(torch.equal(dst[k], v) for k, v in state.items())
