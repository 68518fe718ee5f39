"""The port's geo-replication (``georep.py``): counterparts of
``tests/test_georep.py`` (its status CLI and fsck aside) on torch state,
the status report, and remote trees shipped by one package restored
bit-exact by the other."""

from __future__ import annotations

import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import faultinject, georep, journal
from torchsnapshot_tpu_torch.journal import DeltaJournal
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture
def replicated(tmp_path, monkeypatch):
    """A primary root and an armed remote root, with a fast shipper."""
    remote = str(tmp_path / "remote")
    os.makedirs(remote)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_GEOREP", remote)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S", "0.05")
    yield str(tmp_path / "primary"), remote


def _state(v: float) -> P.StateDict:
    return P.StateDict(w=torch.arange(512, dtype=torch.float32) + v,
                       b=torch.full((32,), v, dtype=torch.float64), step=int(v))


def _assert_state(dst, v: float) -> None:
    assert torch.equal(dst["w"], torch.arange(512, dtype=torch.float32) + v)
    assert torch.equal(dst["b"], torch.full((32,), v, dtype=torch.float64))
    assert dst["step"] == int(v)


def _journaled_step(root: str, epochs: int = 2):
    """A committed base and ``epochs`` committed epochs, below the manager;
    returns the live journal so a test can continue the chain."""
    step_dir = os.path.join(root, "step_0000000001")
    state = {"app": _state(0)}
    P.Snapshot.take(step_dir, state)
    j = DeltaJournal(step_dir, base_step=1, rank=0)
    j.capture_baseline(state)
    for e in range(1, epochs + 1):
        w = state["app"]["w"].clone()
        w[: 16 * e] = float(100 + e)
        state["app"]["w"] = w
        state["app"]["step"] = e
        assert j.append_epoch(state) > 0
    return step_dir, state, j


def _remote_segment(remote_step: str, rank: int = 0) -> str:
    return os.path.join(remote_step, journal.JOURNAL_DIRNAME, journal.segment_name(rank))


def _ship(remote: str, step_dir: str, step: int = 1) -> None:
    rep = georep.GeoReplicator(remote, interval=0.05)
    try:
        rep.enqueue(step_dir, step)
        assert rep.drain(timeout=30.0), rep.last_error
    finally:
        rep.close(0)


def test_region_loss_restores_remote_bit_exact(replicated, monkeypatch) -> None:
    root, remote = replicated
    mgr = P.CheckpointManager(root, save_interval_steps=100)
    assert mgr._georep is not None
    st = _state(0)
    mgr.save(0, {"app": st})
    for v in (1, 2, 3):
        st["w"] = torch.arange(512, dtype=torch.float32) + v
        st["b"] = torch.full((32,), float(v), dtype=torch.float64)
        st["step"] = v
        assert mgr.journal_step(v, {"app": st})
    assert mgr._georep.drain(timeout=30.0), mgr._georep.last_error
    assert mgr._georep.lag_s() == 0.0 and mgr._georep.backlog_epochs() == 0
    mgr.close()
    shutil.rmtree(root)  # the disaster
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_GEOREP")
    before = georep.counts["dr_replica_restores"]
    dst = _state(-1)
    assert P.CheckpointManager(remote).restore({"app": dst}) == 0
    _assert_state(dst, 3)
    assert georep.counts["dr_replica_restores"] == before + 1


def test_remote_is_never_ahead_mid_epoch(replicated) -> None:
    root, remote = replicated
    step_dir, _, _j = _journaled_step(root, epochs=3)
    _ship(remote, step_dir)
    local = journal.committed_epochs(
        journal.read_epoch_metas(os.path.join(step_dir, journal.JOURNAL_DIRNAME)))
    shipped = journal.committed_epochs(journal.read_epoch_metas(
        os.path.join(remote, "step_0000000001", journal.JOURNAL_DIRNAME)))
    assert [(m["epoch"], m["gen"]) for m in shipped] == [(m["epoch"], m["gen"]) for m in local]


def test_cursor_resumes_shipping_mid_stream(replicated, monkeypatch) -> None:
    root, remote = replicated
    step_dir, state, j = _journaled_step(root, epochs=1)
    _ship(remote, step_dir)
    remote_step = os.path.join(remote, "step_0000000001")
    seg_after_e1 = os.path.getsize(_remote_segment(remote_step))
    w = state["app"]["w"].clone()
    w[:8] = -5.0
    state["app"]["w"] = w
    assert j.append_epoch(state) > 0
    appended = []
    orig = georep._RemoteTier.append

    def counting_append(self, rel, existing, region, _orig=orig):
        appended.append((rel, len(existing)))
        _orig(self, rel, existing, region)

    monkeypatch.setattr(georep._RemoteTier, "append", counting_append)
    _ship(remote, step_dir)
    assert appended == [(os.path.join(journal.JOURNAL_DIRNAME, journal.segment_name(0)),
                         seg_after_e1)]
    assert georep.read_cursor(remote_step)["epoch"] == 2


def test_death_between_remote_commit_and_cursor_is_exactly_once(replicated, monkeypatch) -> None:
    root, remote = replicated
    step_dir, _, _j = _journaled_step(root, epochs=2)
    _ship(remote, step_dir)
    remote_step = os.path.join(remote, "step_0000000001")
    cur = georep.read_cursor(remote_step)
    assert cur["epoch"] == 2
    metas = journal.committed_epochs(
        journal.read_epoch_metas(os.path.join(remote_step, journal.JOURNAL_DIRNAME)))
    with open(os.path.join(remote_step, georep.CURSOR_FNAME), "w") as f:
        json.dump({**cur, "epoch": 1, "gen": metas[0]["gen"]}, f)

    def no_writes(self, rel, *a, **k):
        raise AssertionError(f"remote write during advance-only: {rel}")

    monkeypatch.setattr(georep._RemoteTier, "append", no_writes)
    _ship(remote, step_dir)
    assert georep.read_cursor(remote_step)["epoch"] == 2


def test_diverged_generation_is_refused(replicated) -> None:
    root, remote = replicated
    step_dir, state, j = _journaled_step(root, epochs=1)
    _ship(remote, step_dir)
    remote_step = os.path.join(remote, "step_0000000001")
    meta_path = os.path.join(remote_step, journal.JOURNAL_DIRNAME, journal.epoch_meta_name(1))
    meta = json.load(open(meta_path))
    meta["gen"] = "0" * 32
    json.dump(meta, open(meta_path, "w"))
    cur = georep.read_cursor(remote_step)
    with open(os.path.join(remote_step, georep.CURSOR_FNAME), "w") as f:
        json.dump({**cur, "gen": "0" * 32}, f)
    w = state["app"]["w"].clone()
    w[:4] = 7.0
    state["app"]["w"] = w
    assert j.append_epoch(state) > 0
    seg = _remote_segment(remote_step)
    before_bytes = open(seg, "rb").read()
    refusals0 = georep.counts["georep_splice_refusals"]
    rep = georep.GeoReplicator(remote, interval=0.05)
    try:
        rep.enqueue(step_dir, 1)
        assert not rep.drain(timeout=1.0)
        assert "generation" in (rep.last_error or "")
    finally:
        rep.close(0)
    assert georep.counts["georep_splice_refusals"] > refusals0
    assert open(seg, "rb").read() == before_bytes


def test_offset_discontinuity_is_refused(replicated) -> None:
    root, remote = replicated
    step_dir, _, _j = _journaled_step(root, epochs=2)
    _ship(remote, step_dir)
    remote_step = os.path.join(remote, "step_0000000001")
    seg = _remote_segment(remote_step)
    blob = open(seg, "rb").read()
    with open(seg, "wb") as f:
        f.write(blob[: len(blob) - 3])
    os.remove(os.path.join(remote_step, georep.CURSOR_FNAME))
    jdir = os.path.join(remote_step, journal.JOURNAL_DIRNAME)
    for n in os.listdir(jdir):
        if journal._EPOCH_META_RE.match(n):
            os.remove(os.path.join(jdir, n))
    rep = georep.GeoReplicator(remote, interval=0.05)
    try:
        rep.enqueue(step_dir, 1)
        assert not rep.drain(timeout=1.0)
        assert "extend" in (rep.last_error or "") or "segment" in (rep.last_error or "")
    finally:
        rep.close(0)


def test_corrupt_frame_in_flight_is_rejected_then_reshipped(replicated) -> None:
    root, remote = replicated
    step_dir, state, _j = _journaled_step(root, epochs=1)
    faultinject.configure("georep.ship@1=corrupt")
    rejected0 = georep.counts["georep_frames_rejected"]
    try:
        _ship(remote, step_dir)  # the second cycle re-ships from the primary
    finally:
        faultinject.disable()
    assert georep.counts["georep_frames_rejected"] == rejected0 + 1
    shutil.rmtree(root)
    dst = _state(-1)
    P.Snapshot(os.path.join(remote, "step_0000000001")).restore({"app": dst})
    assert torch.equal(dst["w"], state["app"]["w"]) and dst["step"] == 1


def test_status_reports_backlog_and_cursor(replicated) -> None:
    root, remote = replicated
    step_dir, _, _j = _journaled_step(root, epochs=2)
    before = georep.status(root, remote)
    assert before["enabled"] and before["step"] == 1 and before["local_epochs"] == 2
    assert before["base_replicated"] is False and before["backlog_epochs"] == 3
    assert before["lag_s"] >= 0.0
    _ship(remote, step_dir)
    after = georep.status(root, remote)
    assert after["base_replicated"] and after["applied_epoch"] == 2
    assert after["backlog_epochs"] == 0 and after["lag_s"] == 0.0
    assert georep.latest_committed_step(root) == 1
    assert georep.latest_committed_step(str(os.path.join(root, "nowhere"))) is None


def test_disabled_by_default(tmp_path, monkeypatch) -> None:
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_GEOREP", raising=False)
    mgr = P.CheckpointManager(str(tmp_path))
    assert mgr._georep is None
    mgr.save(0, {"app": _state(0)})
    mgr.close()


def test_backlog_is_bounded_drop_oldest(replicated, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_GEOREP_BACKLOG", "2")
    rep = georep.GeoReplicator("/nonexistent/remote", interval=3600.0)
    try:
        for step in range(5):
            rep.enqueue(f"/primary/step_{step:010d}", step)
        assert sorted(rep._pending) == [3, 4] and rep.dropped_steps == 3
        assert rep.lag_s() >= 0.0
    finally:
        rep.close(0)


def test_enqueue_coalesces_keeping_oldest_timestamp(replicated) -> None:
    rep = georep.GeoReplicator("/nonexistent/remote", interval=3600.0)
    try:
        rep.enqueue("/primary/step_0000000001", 1)
        _, ts0 = rep._pending[1]
        rep.enqueue("/primary/step_0000000001", 1)
        assert rep._pending[1][1] == ts0 and len(rep._pending) == 1
    finally:
        rep.close(0)


def _hold_first_sync(rep):
    """Stop ``rep``'s first sync between its return and the retire of its
    task: the window in which a racing commit lands."""
    synced, release = threading.Event(), threading.Event()
    orig, calls = rep._sync_step, []

    def held(path, step):
        cursor = orig(path, step)
        calls.append(cursor)
        if len(calls) == 1:
            synced.set()
            assert release.wait(30.0)
        return cursor

    rep._sync_step = held
    return synced, release


def _commit_during_sync(rep, step_dir, append_epoch) -> None:
    synced, release = _hold_first_sync(rep)
    try:
        rep.enqueue(step_dir, 1)
        assert synced.wait(30.0)
        append_epoch()  # epoch 2 commits while epoch 1's sync is held
        rep.enqueue(step_dir, 1)
        release.set()
        assert rep.drain(timeout=30.0), rep.last_error
    finally:
        release.set()
        rep.close(0)


def test_commit_during_sync_is_shipped(replicated) -> None:
    root, remote = replicated
    step_dir, state, j = _journaled_step(root, epochs=1)

    def append_epoch():
        w = state["app"]["w"].clone()
        w[:8] = -7.0
        state["app"]["w"] = w
        assert j.append_epoch(state) > 0

    _commit_during_sync(georep.GeoReplicator(remote, interval=3600.0), step_dir, append_epoch)
    assert georep.read_cursor(os.path.join(remote, "step_0000000001"))["epoch"] == 2


def test_jax_shipper_loses_a_commit_made_during_its_sync(tmp_path) -> None:
    """The deliberate difference: the same interleaving through the JAX
    package retires the task on its unchanged (oldest) timestamp, so its
    remote cursor stays one epoch behind after a drain that reports
    caught up."""
    from torchsnapshot_tpu import georep as jax_georep

    remote = str(tmp_path / "remote")
    os.makedirs(remote)
    step_dir = str(tmp_path / "primary" / "step_0000000001")
    st = {"app": J.StateDict(w=jnp.arange(512, dtype=jnp.float32), step=0)}
    J.Snapshot.take(step_dir, st)
    j = J.journal.DeltaJournal(step_dir, base_step=1, rank=0)
    j.capture_baseline(st)
    st["app"]["w"] = st["app"]["w"] + 1
    assert j.append_epoch(st) > 0

    def append_epoch():
        st["app"]["w"] = st["app"]["w"] + 2
        assert j.append_epoch(st) > 0

    _commit_during_sync(jax_georep.GeoReplicator(remote, interval=3600.0), step_dir,
                        append_epoch)
    assert jax_georep.read_cursor(os.path.join(remote, "step_0000000001"))["epoch"] == 1


def test_preemption_consume_drains_the_shipper(replicated) -> None:
    root, remote = replicated
    watcher = P.PreemptionWatcher()
    try:
        mgr = P.CheckpointManager(root, save_interval_steps=100, preemption=watcher)
        assert mgr._georep.drain in watcher._consume_hooks
        st = _state(0)
        mgr.save(0, {"app": st})
        st["step"] = 4
        P.simulate_preemption_now()
        assert mgr.save(1, {"app": st}) is False  # the journal flush, then the drain
        assert watcher.consumed
        assert georep.read_cursor(os.path.join(remote, "step_0000000000"))["epoch"] == 1
        mgr.close()
    finally:
        watcher.close()


@pytest.mark.parametrize("knob,value,want", [
    ("TORCHSNAPSHOT_GPU_GEOREP", " /r/ ", "/r"),
    ("TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S", "0.001", 0.05),
    ("TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S", "bad", 2.0),
    ("TORCHSNAPSHOT_GPU_GEOREP_BACKLOG", "0", 1),
    ("TORCHSNAPSHOT_GPU_GEOREP_DRAIN_S", "-3", 0.0),
])
def test_knobs_parse_as_in_jax(monkeypatch, knob, value, want) -> None:
    from torchsnapshot_tpu import georep as jax_georep

    readers = {"": "remote_url", "_INTERVAL_S": "interval_s", "_BACKLOG": "backlog_limit",
               "_DRAIN_S": "drain_timeout_s"}
    reader = readers[knob[len("TORCHSNAPSHOT_GPU_GEOREP"):]]
    monkeypatch.setenv(knob, value)
    monkeypatch.setenv(knob.replace("_GPU_", "_TPU_"), value)
    assert getattr(georep, reader)() == getattr(jax_georep, reader)() == want


# -------------------------------------------------- across the two packages


def test_port_shipped_tree_restores_in_jax(replicated, monkeypatch) -> None:
    root, remote = replicated
    mgr = P.CheckpointManager(root, save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    for v in (1, 2):
        st["w"] = torch.arange(512, dtype=torch.float32) * v
        st["step"] = v
        assert mgr.journal_step(v, {"app": st})
    mgr.close()
    shutil.rmtree(root)
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
    dst = J.StateDict(w=jnp.zeros(512, jnp.float32), b=jnp.ones(32, jnp.float32), step=-1)
    J.Snapshot(os.path.join(remote, "step_0000000000")).restore({"app": dst})
    assert np.array_equal(np.asarray(dst["w"]), st["w"].numpy()) and dst["step"] == 2
    # The JAX package's own cursor reader agrees on what was shipped.
    from torchsnapshot_tpu import georep as jax_georep

    cur = jax_georep.read_cursor(os.path.join(remote, "step_0000000000"))
    assert cur["base_step"] == 0 and cur["epoch"] == 2


def test_jax_shipped_tree_restores_in_port(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu import georep as jax_georep

    root, remote = str(tmp_path / "primary"), str(tmp_path / "remote")
    os.makedirs(remote)
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
    step_dir = os.path.join(root, "step_0000000003")
    st = {"app": J.StateDict(w=jnp.arange(512, dtype=jnp.float32), step=0)}
    J.Snapshot.take(step_dir, st)
    j = J.journal.DeltaJournal(step_dir, base_step=3, rank=0)
    j.capture_baseline(st)
    st["app"]["w"] = st["app"]["w"] + 11
    st["app"]["step"] = 6
    assert j.append_epoch(st) > 0
    rep = jax_georep.GeoReplicator(remote, interval=0.05)
    try:
        rep.enqueue(step_dir, 3)
        assert rep.drain(timeout=30.0), rep.last_error
    finally:
        rep.close(0)
    shutil.rmtree(root)
    before = georep.counts["dr_replica_restores"]
    dst = P.StateDict(w=torch.zeros(512), step=0)
    P.Snapshot(os.path.join(remote, "step_0000000003")).restore({"app": dst})
    assert np.array_equal(dst["w"].numpy(), np.asarray(st["app"]["w"])) and dst["step"] == 6
    assert georep.counts["dr_replica_restores"] == before + 1
    assert georep.read_cursor(os.path.join(remote, "step_0000000003"))["epoch"] == 1
