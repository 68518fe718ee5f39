"""The fleet tier on the card.

- A deferred CUDA leaf of a lazy restore is resident in the caller's
  stream order: ``LeafFuture.result()`` and ``fault()`` make the caller's
  current stream wait on the page, so a kernel the caller queues next on
  its own stream reads the restored bytes.
- A rolling-update receiver applies pushed epochs onto CUDA leaves in
  place: the same tensor objects, still on the card, bit-exact.
- A seeded restore lands on the card bit-exact, every shareable chunk from
  the seeding peer.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fleet_cuda.py
"""

from __future__ import annotations

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import distrib, pagein
from torchsnapshot_tpu_torch.dist_store import TCPStore
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture()
def registry():
    server = TCPStore("127.0.0.1", is_server=True, timeout=10.0)

    def client() -> TCPStore:
        return TCPStore("127.0.0.1", server.port, is_server=False, timeout=10.0)

    distrib.configure_registry(client)
    try:
        yield client
    finally:
        distrib.reset_session()
        distrib.configure_registry(None)
        server.close()


def _state(card, seed: int) -> P.StateDict:
    g = torch.Generator().manual_seed(seed)
    return P.StateDict(
        hot=torch.randn(256, 64, generator=g).to(card),
        cold=torch.randn(1 << 20, generator=g).to(card),
        half=torch.randn(4096, generator=g).to(card).to(torch.bfloat16),
        step=torch.tensor(seed, device=card),
    )


def test_a_faulted_leaf_is_resident_in_the_callers_stream_order(card, tmp_path, monkeypatch):
    src = _state(card, 1)
    P.Snapshot.take(str(tmp_path / "s"), {"m": src})
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH", "0")
    dst = P.StateDict({k: torch.zeros_like(v) for k, v in src.items()})
    cold = dst["cold"]
    caller = torch.cuda.Stream()
    with torch.cuda.stream(caller):
        sess = P.Snapshot(str(tmp_path / "s")).restore({"m": dst}, hot=["^m/hot$"])
        assert sess is not None and torch.equal(dst["hot"], src["hot"])
        future = dst["cold"]
        assert isinstance(future, pagein.LeafFuture) and not future.done()
        # A kernel queued behind a long one on the caller's stream: it must
        # still read the paged-in bytes, ordered by the page's event.
        torch.cuda._sleep(50_000_000)
        value = future.result(timeout=120)
        doubled = value * 2
    caller.synchronize()
    assert value is cold and value.is_cuda
    assert torch.equal(doubled, src["cold"] * 2)
    sess.fault("^m/half$", timeout=120)
    with torch.cuda.stream(caller):
        half = dst["half"].result(timeout=120).float().sum()
    caller.synchronize()
    assert half.item() == src["half"].float().sum().item()
    sess.wait(timeout=120)
    assert all(torch.equal(dst[k].result() if isinstance(dst[k], pagein.LeafFuture) else dst[k],
                           src[k]) for k in src)


def test_a_receiver_applies_epochs_onto_cuda_leaves_in_place(card, registry, tmp_path,
                                                               monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    live = _state(card, 2)
    mgr.save(0, {"m": live})
    replica = P.StateDict({k: v.clone() for k, v in live.items()})
    before = {k: replica[k] for k in replica}
    rx = distrib.UpdateReceiver(registry(), {"m": replica}, base_step=0)
    try:
        live["cold"] = live["cold"] + 1.0
        live["half"] = (live["half"].float() * 3).to(torch.bfloat16)
        live["step"] = live["step"] + 1
        assert mgr.journal_step(1, {"m": live})
        out = mgr.push_update()
        assert out["replicas"] == 1 and out["epochs"] == 1 and out["nacks"] == 0
        torch.cuda.synchronize()
        for k in live:
            assert replica[k] is before[k] and replica[k].is_cuda, k
            assert torch.equal(replica[k], live[k]), k
    finally:
        rx.close()
        mgr.close()


def test_a_seeded_restore_lands_on_the_card(card, registry, tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", "always")
    src = _state(card, 3)
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"m": src}, replicated=["**"])
    first = P.StateDict({k: torch.zeros_like(v) for k, v in src.items()})
    P.Snapshot(path).restore({"m": first})  # reads storage and seeds
    seeder = distrib.session()
    assert set(seeder._registered.values()) == {0}
    # A second replica's view: a session of its own, the seeder still up.
    distrib._session = None
    try:
        dst = P.StateDict({k: torch.zeros_like(v) for k, v in src.items()})
        P.Snapshot(path).restore({"m": dst})
        assert set(distrib.session()._registered.values()) == {1}
        assert all(torch.equal(dst[k], src[k]) and dst[k].is_cuda for k in src)
    finally:
        seeder.close()
