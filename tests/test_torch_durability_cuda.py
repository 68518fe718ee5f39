"""The durability tier on the card.

- The journal's dirty detector launches K4 once a CUDA leaf, all leaves
  dispatched before one fetch, and its digests equal the plain version's.
- A CUDA leaf journaled and replayed stays on the card, replayed in place,
  bit-exact, bf16 included; an unchanged state appends 0 records.
- A mirrored snapshot restores onto the card after the loss of its
  primary; a consolidated journaled chain and a geo-replicated tree
  restore onto the card bit-exact.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_durability_cuda.py
"""

from __future__ import annotations

import os
import shutil

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import device_digest, georep, journal
from torchsnapshot_tpu_torch.dedup import consolidate
from torchsnapshot_tpu_torch.storage_plugins import mirror as mirror_mod
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(card, v: float) -> P.StateDict:
    g = torch.Generator(device="cpu").manual_seed(int(v) + 100)
    return P.StateDict(
        w=torch.randn(256, 64, generator=g).to(card),
        h=torch.randn(300, generator=g).to(card).to(torch.bfloat16),
        i=torch.arange(17, device=card, dtype=torch.int32) * int(v + 1),
        count=torch.tensor(int(v), device=card),
        step=int(v),
    )


def _equal(a: P.StateDict, b: P.StateDict) -> bool:
    return all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a
    )


def test_dirty_detector_launches_k4_once_a_leaf_and_fetches_once(card, monkeypatch) -> None:
    leaves = [torch.randn(1000 + i, device=card) for i in range(26)]
    fetches = []
    orig = device_digest._fetch
    monkeypatch.setattr(device_digest, "_fetch", lambda p: fetches.append(len(p)) or orig(p))
    n0 = device_digest.fingerprint_lanes.launches
    out = device_digest.fingerprint_all(leaves)
    assert device_digest.fingerprint_lanes.launches - n0 == 26 and fetches == [26]
    for t, (fp, kind) in zip(leaves, out):
        assert kind == "array" and fp == device_digest.device_fingerprint(t.cpu())


def test_cuda_leaves_journal_and_replay_on_the_card(card, tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(card, 0)
    mgr.save(0, {"app": st})
    n0 = device_digest.fingerprint_lanes.launches
    assert mgr.journal_step(1, {"app": st})  # unchanged: an epoch of 0 records
    assert device_digest.fingerprint_lanes.launches - n0 == 4
    meta = journal.read_epoch_metas(os.path.join(mgr.path_for(0), journal.JOURNAL_DIRNAME))[-1]
    assert meta["records"] == {"0": 0}
    live = _state(card, 2)
    for k in ("w", "h", "i", "count"):
        st[k].copy_(live[k])
    st["step"] = 2
    assert mgr.journal_step(2, {"app": st})
    records, err = journal.scan_segment(
        os.path.join(mgr.path_for(0), journal.JOURNAL_DIRNAME, journal.segment_name(0)))
    assert err is None and {h["key"]: h.get("dtype") for h, _ in records}["app/h"] == "bfloat16"
    dst = _state(card, 7)
    held = dst["w"]
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert dst["w"] is held and dst["w"].is_cuda and dst["h"].dtype == torch.bfloat16
    assert _equal(dst, st)


def test_mirror_consolidate_and_dr_restore_onto_the_card(card, tmp_path, monkeypatch) -> None:
    st = _state(card, 3)
    primary, mirror = str(tmp_path / "fast"), str(tmp_path / "durable")
    P.Snapshot.take(primary, {"app": st}, storage_options={"mirror_url": mirror})
    for r, _, fs in os.walk(primary):
        for f in fs:
            if f != ".snapshot_metadata":
                os.remove(os.path.join(r, f))
    before = mirror_mod.failover_counts["mirror_failovers"]
    dst = _state(card, 0)
    P.Snapshot(primary, storage_options={"mirror_url": mirror}).restore({"app": dst})
    assert _equal(dst, st) and mirror_mod.failover_counts["mirror_failovers"] > before

    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_GEOREP", str(tmp_path / "remote"))
    mgr = P.CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=100)
    mgr.save(0, {"app": st})
    st["w"].mul_(2)
    st["step"] = 4
    assert mgr.journal_step(1, {"app": st})
    assert mgr._georep.drain(30.0), mgr._georep.last_error
    mgr.close()
    flat = str(tmp_path / "flat")
    consolidate(mgr.path_for(0), flat)
    dst = _state(card, 0)
    P.Snapshot(flat).restore({"app": dst})
    assert _equal(dst, st)
    shutil.rmtree(tmp_path / "ckpt")
    before = georep.counts["dr_replica_restores"]
    dst = _state(card, 0)
    P.Snapshot(str(tmp_path / "remote" / "step_0000000000")).restore({"app": dst})
    assert _equal(dst, st) and georep.counts["dr_replica_restores"] == before + 1
