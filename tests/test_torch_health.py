"""The port's heartbeats (``telemetry/health.py``) against the JAX package.

Heartbeats go under ``tsnap/health/<rank>`` in the coordination store at
``TORCHSNAPSHOT_GPU_HEARTBEAT_S``: a publisher publishes at once and then
on its cadence, carries the progress fields the pipeline feeds it, and
retracts its key on stop. The stores of both packages speak one wire
protocol, so a JAX watcher reads the port's heartbeats and the port's
reads the JAX package's. A take in a world of 2 publishes while it runs
and leaves no key behind.
"""

from __future__ import annotations

import time

import pytest

from torchsnapshot_tpu_torch import dist_store as D
from torchsnapshot_tpu_torch.telemetry import health
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses


@pytest.fixture
def store():
    server = D.TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    client = D.TCPStore("127.0.0.1", server.port, timeout=10.0)
    yield server, client
    client.close()
    server.close()


class _World2:
    """The two things ``maybe_start`` reads from a wrapper."""

    def __init__(self, store, rank):
        self.pg = type("PG", (), {"store": store})()
        self._rank = rank

    def get_rank(self):
        return self._rank

    def get_world_size(self):
        return 2


def _wait_for(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    return fn()


def test_heartbeats_publish_progress_and_retract(store, monkeypatch):
    _, client = store
    monkeypatch.setenv(health.HEARTBEAT_ENV_VAR, "0.05")
    health.clear()
    pub = health.maybe_start(_World2(client, 1), "take", "/snap")
    assert pub is not None and pub.cadence_s == 0.05
    try:
        health.update(phase="stage", written_bytes=100, total_bytes=400)
        fleet = _wait_for(lambda: {r: v for r, v in health.read_fleet(client).items()
                                   if v.get("written_bytes") == 100})
        rec = fleet[1]
        assert rec["op"] == "take" and rec["path"] == "/snap" and rec["phase"] == "stage"
        assert rec["seq"] >= 2  # the cadence ticks
    finally:
        pub.stop()
    assert _wait_for(lambda: health.read_fleet(client) == {})


@pytest.mark.parametrize("value", ["0", "-1"])
def test_a_zero_cadence_or_a_world_of_one_publishes_nothing(store, monkeypatch, value):
    _, client = store
    monkeypatch.setenv(health.HEARTBEAT_ENV_VAR, value)
    assert health.maybe_start(_World2(client, 0), "take", "/snap") is None
    monkeypatch.delenv(health.HEARTBEAT_ENV_VAR)
    one = _World2(client, 0)
    one.get_world_size = lambda: 1
    assert health.maybe_start(one, "take", "/snap") is None


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_heartbeats_cross_between_the_packages(store, monkeypatch, publisher):
    """The JAX package's watcher reads the port's heartbeats, and the
    port's reads the JAX package's, over either package's store."""
    from torchsnapshot_tpu.telemetry import health as jax_health

    _, client = store
    mod = jax_health if publisher == "jax" else health
    assert jax_health.HEARTBEAT_PREFIX == health.HEARTBEAT_PREFIX
    pub = mod.HeartbeatPublisher(client, 3, "restore", "/x", cadence_s=0.05).start()
    try:
        mod.update(phase="load", read_bytes=7)
        for reader in (health, jax_health):
            fleet = _wait_for(lambda: {r: v for r, v in reader.read_fleet(client).items()
                                       if v.get("read_bytes") == 7})
            assert fleet[3]["op"] == "restore" and fleet[3]["phase"] == "load"
    finally:
        pub.stop()
        mod.clear()


def _take_worker(rank: int, world: int, root: str):
    import os

    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.telemetry import health as H

    os.environ[H.HEARTBEAT_ENV_VAR] = "0.02"
    seen = []
    orig = H.HeartbeatPublisher._publish

    def spy(self):
        seen.append(self.prefix + str(self.rank))
        return orig(self)

    H.HeartbeatPublisher._publish = spy
    try:
        Snapshot.take(root, {"m": StateDict(w=torch.ones(1 << 16) * rank)})
    finally:
        H.HeartbeatPublisher._publish = orig
    return {"published": sorted(set(seen))}


@pytest.mark.multiprocess
def test_a_take_in_a_world_of_two_publishes_heartbeats(tmp_path):
    out = run_with_subprocesses(_take_worker, 2, str(tmp_path / "s"))
    for rank, res in out.items():
        assert res["published"] == [f"tsnap/health/{rank}"]
