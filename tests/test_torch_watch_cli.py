"""The port's live and forensic commands against the JAX package's:
``blackbox``, ``watch`` (with ``--ticks`` and ``--dump``), ``store-status``
and ``georep-status``.

- ``watch`` reads heartbeats from a port store. A static fleet renders the
  same frame in both CLIs. A port take held mid-write on an ``Event`` (its
  heartbeat publisher and hang watchdog handed the test's store, as a world
  of two hands them its own) shows its row in both CLIs, and ``--dump 0``
  brings back a remote stack dump. Every wait is bounded: ``Event.wait``
  with a timeout, ``join`` with a timeout, ``--ticks``.
- ``blackbox`` merges a failed port take's ring and stacks alike.
- ``store-status`` probes a live port store alike, and a dead address is
  exit 2 in both.
- ``georep-status`` reports a port root caught up, behind, unconfigured
  and empty alike.
"""

from __future__ import annotations

import asyncio
import os
import re
import threading

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import cli, faultinject, georep
from torchsnapshot_tpu_torch.dist_store import TCPStore
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import forensics, health
from torchsnapshot_tpu_torch.test_utils import find_free_port
from torch_cli_env import both, recorders_from_env, run_cli  # noqa: F401 - autouse
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture()
def store():
    s = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    health.clear()
    try:
        yield s
    finally:
        health.clear()
        s.close()


def test_a_static_fleet_renders_the_same_frame(store) -> None:
    health.update(phase="write", staged_bytes=3 << 20, written_bytes=1 << 20,
                  total_bytes=4 << 20, inflight_io=2, binding="storage_write", step=7)
    pub = health.HeartbeatPublisher(store, rank=0, op="take", path="/x", cadence_s=60.0).start()
    try:
        for extra in ([], ["--dump", "3"], ["--stall", "0.5"]):
            jax_res, port_res = both(["watch", store.bootstrap_addr, "--ticks", "1", *extra])
            assert port_res == jax_res, extra
        rc, out, _ = port_res
        assert rc == 0 and f"--- watch {store.bootstrap_addr} tick 1" in out
        row = next(ln for ln in out.splitlines() if ln.startswith("   0  take"))
        assert "write" in row and "storage_write" in row and "1.0MiB" in row
    finally:
        pub.stop()
    # The publisher retracted its key: no in-flight operation.
    jax_res, port_res = both(["watch", store.bootstrap_addr, "--ticks", "1"])
    assert port_res == jax_res and "no in-flight" in port_res[1]


def test_watch_of_a_dead_store_degrades_and_a_bad_addr_is_exit_2() -> None:
    addr = f"127.0.0.1:{find_free_port()}"
    jax_res, port_res = both(["watch", addr, "--ticks", "2", "--interval", "0.01"])
    assert port_res[0] == jax_res[0] == 0
    assert port_res[1].count("store unreachable") == 2 == jax_res[1].count("store unreachable")
    jax_res, port_res = both(["watch", "nohost", "--ticks", "1"])
    assert port_res == jax_res and port_res[0] == 2


def test_watch_follows_a_held_take_and_dumps_its_stacks(tmp_path, monkeypatch, store) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PROGRESS_S", "0.02")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_IO_CONCURRENCY", "1")
    monkeypatch.setenv(forensics.SAMPLE_ENV_VAR, "0.05")
    # The single-process take gets the test's store for its heartbeat and
    # its watchdog's request channel.
    monkeypatch.setattr(health, "maybe_start", lambda pgw, op, path: health.HeartbeatPublisher(
        store, 0, op, path, cadence_s=0.05).start())
    monkeypatch.setattr(forensics, "arm", lambda pgw, op, path: forensics.Watchdog(
        0, op, path, store=store).start())
    held, release = threading.Event(), threading.Event()
    write = FSStoragePlugin.write
    writes = []

    async def gated(self, write_io):
        if not write_io.path.startswith("."):
            writes.append(write_io.path)
            if len(writes) == 2:
                held.set()
                while not release.is_set():
                    await asyncio.sleep(0.01)
        return await write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", gated)
    snap = str(tmp_path / "s")
    state = {"m": P.StateDict({f"w{i}": torch.full((1 << 14,), float(i)) for i in range(3)})}
    err = []

    def take():
        try:
            P.Snapshot.take(snap, state)
        except BaseException as e:  # noqa: BLE001 - reported below
            err.append(e)

    t = threading.Thread(target=take)
    t.start()
    try:
        assert held.wait(30)
        addr = store.bootstrap_addr
        frames = {}
        for name, res in zip(("jax", "port"), both(["watch", addr, "--ticks", "1"])):
            assert res[0] == 0, res
            frames[name] = next(ln for ln in res[1].splitlines() if ln.startswith("   0  take"))
        # Live fields (phase, ages, walls, rates) move between the two
        # reads; the row's rank and op do not.
        assert frames["port"].split()[:2] == frames["jax"].split()[:2] == ["0", "take"]
        dumped = False
        for _ in range(200):  # the watchdog answers on its 0.05 s cadence
            rc, out, _ = run_cli(cli.main, ["watch", addr, "--ticks", "1", "--dump", "0"])
            assert rc == 0
            dumped = store.check(f"{forensics.FORENSIC_OUT_PREFIX}0")
            if dumped:
                break
            release.wait(0.05)
        assert dumped
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive() and not err
    triggers = [r["trigger"] for r in forensics.load_stack_dumps(snap).get(0, [])]
    assert "remote" in triggers
    jax_res, port_res = both(["blackbox", snap])
    assert port_res == jax_res and "stack dumps: 1 rank(s) (0)" in port_res[1]


def test_blackbox_of_a_failed_port_take_agrees(tmp_path) -> None:
    snap = str(tmp_path / "snap")
    faultinject.configure("fs.write@2=permanent")
    try:
        with pytest.raises(faultinject.InjectedPermanentError):
            P.Snapshot.take(snap, {"m": P.StateDict(w=torch.ones(8), b=torch.zeros(4))})
    finally:
        faultinject.disable()
    assert sorted(os.listdir(os.path.join(snap, ".flight"))) == ["rank_0.jsonl",
                                                                 "rank_0.stacks.jsonl"]
    for argv in (["blackbox", snap, "--json"], ["blackbox", snap, "-v"], ["blackbox", snap]):
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    assert "error=InjectedPermanentError" in port_res[1]
    jax_res, port_res = both(["blackbox", str(tmp_path)])
    assert port_res == jax_res and port_res[0] == 2
    assert "TORCHSNAPSHOT_GPU_FLIGHTREC=0" in port_res[2]


def test_store_status_agrees(store) -> None:
    for argv in (["store-status", store.bootstrap_addr],
                 ["store-status", store.bootstrap_addr, "--json"]):
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    assert "role=leader" in both(["store-status", store.bootstrap_addr])[1][1]
    dead = f"127.0.0.1:{find_free_port()}"
    jax_res, port_res = both(["store-status", dead, "--timeout", "1"])
    assert port_res[0] == jax_res[0] == 2
    assert port_res[2].startswith(f"error: no store node answering at {dead}")


def _mask_lag(res):
    rc, out, err = res
    return rc, re.sub(r"\d+\.\d+s old", "Ns old", re.sub(r'"lag_s": [0-9.e-]+', '"lag_s": N',
                                                         out)), err


def test_georep_status_agrees(tmp_path, monkeypatch) -> None:
    root, remote = str(tmp_path / "primary"), str(tmp_path / "remote")
    os.makedirs(remote)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    jax_res, port_res = both(["georep-status", root])
    assert port_res == jax_res and port_res[0] == 2  # not configured
    jax_res, port_res = both(["georep-status", empty, "--remote", remote])
    assert port_res == jax_res and port_res[0] == 2  # no committed step
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    mgr = P.CheckpointManager(root, save_interval_steps=100)
    st = P.StateDict(w=torch.arange(512, dtype=torch.float32), step=0)
    mgr.save(0, {"app": st})
    for v in (1, 2):
        st["w"][:4] = float(v)
        st["step"] = v
        assert mgr.journal_step(v, {"app": st})
    mgr.close()
    # Nothing shipped yet: the base and both epochs are behind.
    for argv in (["georep-status", root, "--remote", remote],
                 ["georep-status", root, "--remote", remote, "--json"]):
        jax_res, port_res = both(argv)
        assert _mask_lag(port_res) == _mask_lag(jax_res), argv
    rc, out, _ = both(["georep-status", root, "--remote", remote])[1]
    assert rc == 1 and "base: NOT replicated" in out and "BEHIND by 3 epoch(s)" in out
    step = georep.latest_committed_step(root)
    rep = georep.GeoReplicator(remote, interval=0.05)
    try:
        rep.enqueue(os.path.join(root, f"step_{step:010d}"), step)
        assert rep.drain(timeout=30.0), rep.last_error
    finally:
        rep.close(0)
    for argv in (["georep-status", root, "--remote", remote],
                 ["georep-status", root, "--remote", remote, "--json"]):
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    rc, out, _ = both(["georep-status", root, "--remote", remote])[1]
    assert rc == 0 and "cursor: epoch 2 applied" in out and "caught up" in out
