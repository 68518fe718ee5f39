"""The port's stall-forensics plane against the JAX package's.

- The four ``TORCHSNAPSHOT_GPU_FORENSICS*`` knobs parse as the JAX
  package's ``TORCHSNAPSHOT_TPU_FORENSICS*`` do.
- Counterpart stacks (the same module paths under each package) classify
  to the same critpath lane and frame; the port's own device seam
  (``device.py``, ``batcher.py``) classifies as staging.
- Each trigger fires at small cadences: an overdue collective (through
  ``PGWrapper``'s hook), a storage op past its p99, frozen progress, and a
  remote request through the port's store.
- The port's stack files are read by the JAX package's
  ``load_stack_dumps``, ``derive_wedge_findings`` and
  ``merge_stack_findings`` as the port's readers read them, and the JAX
  package's ``blackbox`` renders a port wreck.
- No watchdog thread outlives its op.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.cli import main as jax_cli
from torchsnapshot_tpu_torch.cli import main as port_cli
from torchsnapshot_tpu.telemetry import forensics as jax_forensics
from torchsnapshot_tpu_torch import faultinject
from torchsnapshot_tpu_torch.telemetry import flightrec, forensics, health
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for suffix in ("", "_SAMPLE_S", "_DEADLINE_FRAC", "_STALL_S"):
        monkeypatch.delenv(f"TORCHSNAPSHOT_GPU_FORENSICS{suffix}", raising=False)
    forensics.refresh_from_env()
    forensics._reset_registries_for_tests()
    health.clear()
    yield
    faultinject.disable()
    forensics.refresh_from_env()
    forensics._reset_registries_for_tests()
    health.clear()


@pytest.mark.parametrize("value", ["", "1", "0", "off", "OFF", "never", "no", "false", "junk",
                                   "0.01", "0.3", "2", "-1"])
def test_the_knobs_parse_as_in_jax(monkeypatch, value) -> None:
    for suffix in ("", "_SAMPLE_S", "_DEADLINE_FRAC", "_STALL_S"):
        monkeypatch.setenv(f"TORCHSNAPSHOT_GPU_FORENSICS{suffix}", value)
        monkeypatch.setenv(f"TORCHSNAPSHOT_TPU_FORENSICS{suffix}", value)
    assert forensics._env_enabled() == jax_forensics._env_enabled()
    assert forensics.sample_cadence_s() == jax_forensics.sample_cadence_s()
    assert forensics.deadline_fraction() == jax_forensics.deadline_fraction()
    assert forensics.stall_window_s() == jax_forensics.stall_window_s()


# Package-relative module paths with their function names: every row of
# the JAX category table, the storage plugins' read/write split, observer
# modules and an unmapped module.
_COUNTERPARTS = [
    ("pg_wrapper.py", "_wait"), ("dist_store.py", "wait_any"), ("native_io.py", "reap"),
    ("fanout.py", "send"), ("reshard.py", "plan"), ("serialization.py", "to_bytes"),
    ("memoryview_stream.py", "read"), ("io_preparers/array.py", "_land"),
    ("integrity.py", "crc32c"), ("device_digest.py", "_fetch"), ("compression.py", "decode"),
    ("storage_plugins/fs.py", "write"), ("storage_plugins/fs.py", "read_stream"),
    ("storage_plugins/s3.py", "put"), ("storage_plugins/gcs.py", "download"),
    ("storage_plugin.py", "url_to_storage_plugin"), ("scheduler.py", "dispatch"),
    ("snapshot.py", "take"), ("telemetry/health.py", "update"), ("faultinject.py", "fire"),
]


def _stack(package: str, rel: str, func: str):
    root = os.path.join(os.sep, "site", package)
    return [("/usr/lib/python3.12/threading.py", "run", 1000),
            (os.path.join(root, "snapshot.py"), "take", 10),
            (os.path.join(root, *rel.split("/")), func, 42),
            ("/usr/lib/python3.12/threading.py", "wait", 300)]


@pytest.mark.parametrize("rel,func", _COUNTERPARTS)
def test_counterpart_stacks_classify_the_same(rel, func) -> None:
    mine = forensics.classify_frames(_stack("torchsnapshot_tpu_torch", rel, func))
    theirs = jax_forensics.classify_frames(_stack("torchsnapshot_tpu", rel, func))
    assert mine == theirs
    # A JAX package frame is not the port's.
    assert forensics.classify_frames(_stack("torchsnapshot_tpu", rel, func))[0] is None


@pytest.mark.parametrize("rel", ["device.py", "batcher.py", "io_preparers/array.py"])
def test_the_device_seam_classifies_as_staging(rel) -> None:
    """A thread parked in a CUDA event or stream wait has torch frames
    innermost; the innermost port frame is the device seam's."""
    frames = _stack("torchsnapshot_tpu_torch", rel, "_land")
    frames.insert(3, ("/site/torch/cuda/streams.py", "synchronize", 220))
    category, frame = forensics.classify_frames(frames)
    assert category == "stage_copy" and frame == f"{rel}:_land:42"


def _wait_for(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_an_overdue_collective_through_pgwrapper_self_dumps(tmp_path) -> None:
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    class _Store:
        timeout = 0.2

    pgw = PGWrapper.__new__(PGWrapper)
    pgw.pg = type("PG", (), {"store": _Store()})()
    wd = forensics.Watchdog(1, "take", str(tmp_path), cadence_s=0.02)
    wd.start()
    try:
        with pgw._recorded("barrier", "ckpt", 9):
            assert _wait_for(lambda: forensics.load_stack_dumps(str(tmp_path)).get(1))
    finally:
        wd.stop()
    rec = forensics.load_stack_dumps(str(tmp_path))[1][0]
    assert rec["trigger"] == "collective-deadline" and "barrier #9" in rec["reason"]
    assert forensics.collectives_overdue(time.monotonic() + 100, 0.0) == []


def test_a_storage_op_past_its_p99_self_dumps(tmp_path) -> None:
    for _ in range(forensics._MIN_P99_SAMPLES):
        with forensics.storage_op("storage_write", path="quick"):
            pass
    wd = forensics.Watchdog(0, "take", str(tmp_path), cadence_s=0.05)
    wd.start()
    try:
        with forensics.storage_op("storage_write", path="0/m/w"):
            assert _wait_for(lambda: forensics.load_stack_dumps(str(tmp_path)).get(0))
    finally:
        wd.stop()
    rec = forensics.load_stack_dumps(str(tmp_path))[0][0]
    assert rec["trigger"] == "storage-p99" and "path 0/m/w" in rec["reason"]


def test_frozen_progress_self_dumps(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv(forensics.STALL_ENV_VAR, "0.2")
    health.update(op="take", phase="write", written_bytes=5)
    wd = forensics.Watchdog(0, "take", str(tmp_path), cadence_s=0.05)
    wd.start()
    try:
        assert _wait_for(lambda: forensics.load_stack_dumps(str(tmp_path)).get(0))
    finally:
        wd.stop()
    rec = forensics.load_stack_dumps(str(tmp_path))[0][0]
    assert rec["trigger"] == "frozen-progress" and "'write'" in rec["reason"]
    events = [e for e in flightrec.snapshot_ring() if e[2] == "forensic.dump"]
    assert events and events[-1][3]["trigger"] == "frozen-progress"


def test_a_remote_request_through_the_ports_store(tmp_path) -> None:
    from torchsnapshot_tpu_torch.dist_store import TCPStore

    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    wd = None
    try:
        wd = forensics.Watchdog(1, "restore", str(tmp_path), store=store, cadence_s=0.05)
        wd.start()
        store.set(f"{jax_forensics.FORENSIC_REQ_PREFIX}1", b"1")
        out_key = f"{jax_forensics.FORENSIC_OUT_PREFIX}1"
        assert _wait_for(lambda: store.check(out_key))
        payload = json.loads(store.get(out_key).decode("utf-8"))
        assert payload["rank"] == 1 and payload["op"] == "restore"
        assert payload["trigger"] == "remote"
        assert not store.check(f"{jax_forensics.FORENSIC_REQ_PREFIX}1")
        wd.stop()
        wd = None
        assert not store.check(out_key)
    finally:
        if wd is not None:
            wd.stop()
        store.close()
    assert jax_forensics.load_stack_dumps(str(tmp_path))[1][0]["trigger"] == "remote"


def _park_in(event: threading.Event, done: threading.Event) -> threading.Thread:
    """A thread waiting inside a port frame (``storage_plugins/fs.py``)."""
    import torchsnapshot_tpu_torch.storage_plugins.fs as fs

    code = compile("event.set(); done.wait(30)", fs.__file__, "exec")
    t = threading.Thread(target=exec, args=(code, {"event": event, "done": done}),
                         name="tsnap-wedged", daemon=True)
    t.start()
    return t


def test_the_ports_stack_files_are_read_by_the_jax_package(tmp_path, capsys) -> None:
    event, done = threading.Event(), threading.Event()
    t = _park_in(event, done)
    try:
        assert event.wait(10)
        for _ in range(2):
            forensics.dump_stacks(str(tmp_path), 3, "stuck", trigger="remote")
    finally:
        done.set()
        t.join(10)
    mine = forensics.load_stack_dumps(str(tmp_path))
    theirs = jax_forensics.load_stack_dumps(str(tmp_path))
    assert mine == theirs and len(mine[3]) == 2
    rec = mine[3][0]
    assert set(rec) >= {"seq", "t", "rank", "reason", "trigger", "threads", "wedge"}
    assert set(rec["threads"][0]) == {"name", "daemon", "idle", "category", "leaf", "frames"}
    wedges = jax_forensics.derive_wedge_findings(theirs)
    assert wedges == forensics.derive_wedge_findings(mine)
    ours = [w for w in wedges if w["thread"] == "tsnap-wedged"]
    assert [(w["rank"], w["category"], w["dumps"]) for w in ours] == [(3, "storage_write", 2)]
    assert ours[0]["frame"].startswith("storage_plugins/fs.py:<module>:")
    merged = {"findings": [{"class": "desertion", "kind": "barrier", "ns": "ckpt", "cseq": 4,
                            "entered": [3], "never_arrived": [0], "stuck": [3], "errored": [],
                            "errors": {}}]}
    assert (jax_forensics.merge_stack_findings(json.loads(json.dumps(merged)), theirs)
            == forensics.merge_stack_findings(json.loads(json.dumps(merged)), mine))
    # A port take's abort leaves the ring and the stacks; the JAX
    # package's blackbox merges them.
    faultinject.configure("fs.write@2=permanent")
    snap = str(tmp_path / "snap")
    with pytest.raises(faultinject.InjectedPermanentError):
        P.Snapshot.take(snap, {"m": P.StateDict(w=torch.ones(8))})
    faultinject.disable()
    assert sorted(os.listdir(os.path.join(snap, ".flight"))) == ["rank_0.jsonl",
                                                                 "rank_0.stacks.jsonl"]
    assert jax_forensics.load_stack_dumps(snap)[0][0]["trigger"] == "abort"
    capsys.readouterr()
    code = jax_cli(["blackbox", snap])
    out = capsys.readouterr().out
    assert "stack dumps: 1 rank(s) (0), 1 dump(s)" in out
    assert "error=InjectedPermanentError" in out
    # The port's CLI merges the same wreck the same way.
    assert port_cli(["blackbox", snap]) == code
    assert capsys.readouterr().out == out


def test_no_watchdog_outlives_its_op_and_off_arms_none(tmp_path, monkeypatch) -> None:
    def watchdogs():
        return [t for t in threading.enumerate() if t.name == "tsnap-forensics"]

    P.Snapshot.take(str(tmp_path / "s"), {"m": P.StateDict(w=torch.ones(8))})
    dst = {"m": P.StateDict(w=torch.zeros(8))}
    P.Snapshot(str(tmp_path / "s")).restore(dst)
    assert _wait_for(lambda: not watchdogs(), timeout=5.0)
    monkeypatch.setenv(forensics.FORENSICS_ENV_VAR, "0")
    forensics.refresh_from_env()
    assert forensics.arm(None, "take", str(tmp_path)) is None
    faultinject.configure("fs.write@2=permanent")
    with pytest.raises(faultinject.InjectedPermanentError):
        P.Snapshot.take(str(tmp_path / "off"), {"m": P.StateDict(w=torch.ones(8))})
    assert os.listdir(tmp_path / "off" / ".flight") == ["rank_0.jsonl"]
