"""The port's preemption watcher and emergency saves: mirrors of the
single-process tests of ``tests/test_preemption.py``. They use SIGUSR1, so
pytest itself never sees a SIGTERM, and every watcher restores the previous
handlers when it closes."""

from __future__ import annotations

import logging
import os
import signal

import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, PreemptionWatcher, Snapshot, StateDict


@pytest.fixture
def watcher():
    w = PreemptionWatcher(signals=(signal.SIGUSR1,))
    yield w
    w.close()


def _fire() -> None:
    os.kill(os.getpid(), signal.SIGUSR1)


def test_flag_and_should_save(watcher) -> None:
    assert not watcher.preempted
    assert not watcher.should_save()
    _fire()
    assert watcher.preempted and watcher.should_save()
    assert not watcher.consumed  # not consumed until a save handles it
    watcher.consume()
    assert watcher.consumed


def test_previous_handler_chained() -> None:
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        w = PreemptionWatcher(signals=(signal.SIGUSR1,))
        try:
            _fire()
            assert w.preempted
            assert hits == [signal.SIGUSR1]  # the old handler still ran
        finally:
            w.close()
        _fire()  # close() put the previous handler back
        assert hits == [signal.SIGUSR1, signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_manager_emergency_save_off_cadence(tmp_path, watcher) -> None:
    w = torch.arange(256, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), save_interval_steps=100, preemption=watcher)
    state = {"m": StateDict(w=w)}
    assert not mgr.save(1, state)  # not due, no preemption
    _fire()
    assert mgr.save(2, state)  # off-cadence emergency save
    assert watcher.consumed
    assert mgr.all_steps() == [2]
    assert not mgr.save(3, state)  # the grace window does not re-save
    dst = {"m": StateDict(w=torch.zeros_like(w))}
    Snapshot(mgr.path_for(2)).restore(dst)
    assert torch.equal(dst["m"]["w"], w)


def test_emergency_save_is_synchronous(tmp_path, watcher) -> None:
    mgr = CheckpointManager(
        str(tmp_path / "ckpts"), save_interval_steps=100, async_save=True, preemption=watcher
    )
    _fire()
    assert mgr.save(5, {"m": StateDict(w=torch.arange(256, dtype=torch.float32))})
    assert mgr._pending is None  # committed before save() returned
    assert mgr.all_steps() == [5]


def test_simulate_helper_uses_sigterm() -> None:
    from torchsnapshot_tpu_torch import simulate_preemption_now

    w = PreemptionWatcher()  # default: SIGTERM
    try:
        simulate_preemption_now()
        assert w.preempted
    finally:
        w.close()


def test_emergency_at_already_committed_step_consumes(tmp_path, watcher) -> None:
    state = {"m": StateDict(w=torch.arange(64, dtype=torch.float32))}
    mgr = CheckpointManager(str(tmp_path / "ckpts"), preemption=watcher)
    assert mgr.save(3, state)
    mgr2 = CheckpointManager(str(tmp_path / "ckpts"), preemption=watcher)
    assert mgr2.restore(state) == 3
    _fire()
    assert not mgr2.save(3, state)  # nothing re-saved ...
    assert watcher.consumed  # ... but the preemption is handled
    assert mgr2.all_steps() == [3]


def test_explicit_none_pg_is_authoritative() -> None:
    class FakeSubgroupPG:
        pass  # not a group: only the explicit pg=None lets should_save pass

    w = PreemptionWatcher(pg=FakeSubgroupPG(), signals=(signal.SIGUSR1,))
    try:
        _fire()
        assert w.should_save(pg=None) is True
    finally:
        w.close()


def test_handler_does_not_log(watcher, caplog) -> None:
    with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.preemption"):
        _fire()
        assert caplog.records == []  # nothing logged inside the handler
        assert watcher.should_save()
    assert any("flagged for emergency" in r.message for r in caplog.records)


def test_multi_process_decision_raises_by_name() -> None:
    class TwoRanks:
        def size(self) -> int:
            return 2

    w = PreemptionWatcher(signals=(signal.SIGUSR1,))
    try:
        with pytest.raises(NotImplementedError, match="collective preemption decision"):
            w.should_save(pg=TwoRanks())
    finally:
        w.close()
