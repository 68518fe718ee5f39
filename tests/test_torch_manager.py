"""The port's CheckpointManager: mirrors of ``tests/test_manager.py`` at a
small size, plus the unported options that raise by name and the
retention planner held against the JAX package's on the same directory."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch.retention import _entry_payloads, plan_retention
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _state(v: float):
    return StateDict(w=torch.full((2048,), float(v)), step=int(v))


def test_cadence_and_latest(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=5)
    for step in range(12):
        assert mgr.save(step, {"app": _state(step)}) == (step % 5 == 0), step
    assert mgr.all_steps() == [0, 5, 10] and mgr.latest_step() == 10
    # Beside the steps, the root holds the checkpoint history the takes
    # appended (telemetry/history.py), as the JAX package's does.
    assert sorted(os.listdir(tmp_path)) == [
        ".telemetry_history.jsonl", "step_0000000000", "step_0000000005", "step_0000000010"]
    mgr.save(12, {"app": _state(12)}, force=True)  # off-cadence
    assert mgr.latest_step() == 12


def test_restore_latest_and_specific(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    for step in range(3):
        mgr.save(step, {"app": _state(step)})
    dst = _state(-1)
    assert mgr.restore({"app": dst}) == 2
    assert torch.equal(dst["w"], torch.full((2048,), 2.0))
    dst = _state(-1)
    assert mgr.restore({"app": dst}, step=1) == 1 and dst["step"] == 1


def test_keep_last_retention(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, keep_last=2)
    for step in range(5):
        mgr.save(step, {"app": _state(step)})
    assert mgr.all_steps() == [3, 4]


def test_keep_every_archival(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, keep_last=1, keep_every=2)
    for step in range(5):
        mgr.save(step, {"app": _state(step)})
    assert mgr.all_steps() == [0, 2, 4]


@pytest.mark.parametrize("device_digests", [False, True])
def test_incremental_chain_bases_survive_retention(tmp_path, device_digests) -> None:
    mgr = CheckpointManager(
        str(tmp_path), save_interval_steps=1, keep_last=1, incremental=True,
        device_digests=device_digests,
    )
    frozen = torch.arange(4096, dtype=torch.float32)
    for step in range(4):
        mgr.save(step, {"app": StateDict(frozen=frozen, head=torch.full((8,), float(step)))})
    assert mgr.all_steps() == [0, 3]  # the survivor and its payload holder
    dst = StateDict(frozen=torch.zeros(4096), head=torch.zeros(8))
    assert mgr.restore({"app": dst}) == 3
    assert torch.equal(dst["frozen"], frozen) and torch.equal(dst["head"], torch.full((8,), 3.0))


def test_async_save_single_inflight_and_wait(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, async_save=True, keep_last=2)
    for step in range(4):
        mgr.save(step, {"app": _state(step)})
        assert mgr._pending is not None and mgr._pending_step == step  # one in flight
    mgr.wait()
    assert mgr._pending is None and mgr.all_steps() == [2, 3]
    assert mgr.restore({"app": _state(-1)}) == 3


def test_resume_discovers_existing_snapshots(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, incremental=True)
    for step in range(2):
        mgr.save(step, {"app": _state(step)})
    mgr2 = CheckpointManager(str(tmp_path), save_interval_steps=1, incremental=True)
    assert mgr2.latest_step() == 1
    mgr2.save(2, {"app": _state(1)})  # same content as step 1: dedups
    meta = Snapshot(mgr2.path_for(2)).metadata
    origins = [o for e in meta.manifest.values() for *_, o in _entry_payloads(e)]
    assert any(o is not None for o in origins), "must chain to step 1"


def test_validation_errors(tmp_path) -> None:
    with pytest.raises(ValueError, match="save_interval_steps"):
        CheckpointManager(str(tmp_path), save_interval_steps=0)
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointManager(str(tmp_path), keep_last=0)
    with pytest.raises(ValueError, match="keep_every"):
        CheckpointManager(str(tmp_path), keep_every=0)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="step must be"):
        mgr.path_for(-1)
    with pytest.raises(RuntimeError, match="no committed snapshots"):
        mgr.restore({"app": _state(0)})


def test_unported_options_raise_by_name(tmp_path, monkeypatch) -> None:
    """What the manager refuses by name: a world without a store.
    ``tenant``, ``push_update`` and autotuning, once refused here, are
    ported (tests/test_torch_tenancy.py, test_torch_distrib.py,
    test_torch_autotune.py): an unarmed journal pushes nothing, and under
    ``TORCHSNAPSHOT_GPU_AUTOTUNE`` (``always`` reads as ``auto``) the
    constructor warm-starts the governor from the root's profiles."""
    from torchsnapshot_tpu_torch import scheduler
    from torchsnapshot_tpu_torch.telemetry import history

    class TwoRanks:
        def size(self) -> int:
            return 2

    with pytest.raises(RuntimeError, match="2 processes needs the coordination store"):
        CheckpointManager(str(tmp_path), replicated=["**"], pg=TwoRanks())
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.push_update() == {"replicas": 0, "epochs": 0, "bytes": 0, "nacks": 0}
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_AUTOTUNE", "always")
    history.append_record(str(tmp_path), {
        "type": "profile", "ts": 1.0, "plugin": "FSStoragePlugin", "world_size": 1,
        "binding": "storage_write", "settings": {"io_concurrency.write": 3},
        "score_gbps": 1.0, "takes": 2, "trials": [], "op": "write"})
    gov = scheduler.reset_io_governor()
    CheckpointManager(str(tmp_path))
    assert gov.io_concurrency("write", "FSStoragePlugin") == 3
    assert gov.elections[("io_concurrency.write", "FSStoragePlugin")] == (3, "profile")
    scheduler.reset_io_governor()


def test_failed_async_save_raises_on_next_save(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_FENCE_FNAME, SNAPSHOT_METADATA_FNAME
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    class Faulty(FSStoragePlugin):
        # The fence is planted on the caller's thread before any payload
        # write; failing it would fail save(0) itself. This test targets
        # the background payload-write failure surfacing on the next save.
        async def write(self, write_io) -> None:
            if write_io.path not in (SNAPSHOT_METADATA_FNAME, SNAPSHOT_FENCE_FNAME):
                raise RuntimeError("injected storage failure")
            await super().write(write_io)

    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, async_save=True)
    monkeypatch.setattr("torchsnapshot_tpu_torch.storage_plugins.fs.FSStoragePlugin", Faulty)
    mgr.save(0, {"app": _state(0)})
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="injected storage failure"):
        mgr.save(1, {"app": _state(1)})  # drains the failed pending first
    assert mgr.all_steps() == []


def test_resume_step_is_never_overwritten(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, incremental=True)
    mgr.save(0, {"app": _state(0)})
    mgr2 = CheckpointManager(str(tmp_path), save_interval_steps=1, incremental=True)
    assert mgr2.latest_step() == 0
    assert mgr2.save(0, {"app": _state(99)}) is False  # skipped
    dst = _state(-1)
    mgr2.restore({"app": dst})
    assert dst["step"] == 0
    assert mgr2.save(1, {"app": _state(1)}) is True


def test_foreign_snapshot_names_not_deleted(tmp_path) -> None:
    foreign = tmp_path / "step_123"  # unpadded: not manager-named
    Snapshot.take(str(foreign), {"app": _state(7)})
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, keep_last=1)
    assert mgr.all_steps() == []
    for step in range(3):
        mgr.save(step, {"app": _state(step)})
    assert mgr.all_steps() == [2]
    assert (foreign / ".snapshot_metadata").exists()


def test_gc_reclaims_orphaned_partials(tmp_path) -> None:
    partial = tmp_path / "step_0000000001"
    (partial / "0").mkdir(parents=True)
    (partial / "0" / "junk").write_bytes(b"x")
    later = tmp_path / "step_0000000009"  # above the saved step: untouched
    later.mkdir()
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(2, {"app": _state(2)})
    assert not partial.exists() and later.exists()
    assert mgr.all_steps() == [2]


def test_warmup_returns_zero_and_builds_nothing_on_cpu(tmp_path) -> None:
    from torchsnapshot_tpu_torch import _native, device_digest, warmup_staging
    from torchsnapshot_tpu_torch.io_preparers.array import _staging_pool, clear_staging_pool

    state = {"app": StateDict(w=torch.zeros(100003, dtype=torch.uint8))}
    clear_staging_pool()
    # A CPU tensor's async_take copy draws one slab of its size from the
    # pool (with the native library and checksums on).
    expected = 100003 if _native.native_available() else 0
    assert warmup_staging(state) == expected
    assert _staging_pool.free_bytes() == expected
    before = device_digest.fingerprint_lanes.launches
    assert CheckpointManager(str(tmp_path / "a"), device_digests=True).warmup(state) == 0
    assert CheckpointManager(str(tmp_path / "b")).warmup(state) == 0  # already pooled
    assert device_digest.fingerprint_lanes.launches == before  # CPU leaves: no kernel
    clear_staging_pool()


def test_manager_restore_applies_device_digests(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer

    consumed = []
    orig = ArrayBufferConsumer.consume_buffer

    async def spy(self, buf, executor=None):
        consumed.append(self.entry.location)
        return await orig(self, buf, executor)

    monkeypatch.setattr(ArrayBufferConsumer, "consume_buffer", spy)
    mgr = CheckpointManager(str(tmp_path), device_digests=True)
    w = torch.arange(512, dtype=torch.float32)
    mgr.save(0, {"app": StateDict(w=w)})
    assert mgr.restore({"app": StateDict(w=w.clone())}) == 0
    assert consumed == []


def test_retention_plan_matches_jax_planner(tmp_path) -> None:
    """The port's planner and the JAX package's, on the same directory of
    port-written incremental snapshots, plan the same deletions."""
    from torchsnapshot_tpu.retention import plan_retention as jax_plan_retention

    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1, incremental=True)
    frozen = torch.arange(1024, dtype=torch.float32)
    for step in range(5):
        mgr.save(step, {"app": StateDict(frozen=frozen, head=torch.full((4,), float(step)))})
    for keep in (1, 2, 5):
        ours, theirs = plan_retention(str(tmp_path), keep), jax_plan_retention(str(tmp_path), keep)
        assert (ours.keep, ours.spared, ours.doomed, ours.unresolved) == (
            theirs.keep, theirs.spared, theirs.doomed, theirs.unresolved
        ), keep
    # A moved tree: origins resolve by basename and payload checksums.
    moved = tmp_path.parent / (tmp_path.name + "_moved")
    shutil.copytree(tmp_path, moved)
    plan = plan_retention(str(moved), 1)
    assert [n for n, by_name in plan.spared] == ["step_0000000000"] and plan.spared[0][1]
    assert not plan.unresolved
    np.testing.assert_array_equal(sorted(plan.doomed), ["step_0000000001", "step_0000000002", "step_0000000003"])
