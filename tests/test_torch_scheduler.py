"""The port's scheduler and I/O governor: mirrors of ``tests/test_scheduler.py``
(budget compliance, the starvation escape, the staging consistency point,
reads), the governor's elections held against the JAX package's on the same
recorded rates, the fault sites of the pipeline and the commit, and the
restore-side preverify gate with the device hash-rate probe."""

from __future__ import annotations

import asyncio
from typing import Dict

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import scheduler as jax_scheduler
from torchsnapshot_tpu_torch import device_digest, faultinject
from torchsnapshot_tpu_torch import scheduler as S
from torchsnapshot_tpu_torch.io_types import (
    BufferConsumer,
    BufferStager,
    ReadIO,
    ReadReq,
    StoragePlugin,
    WriteIO,
    WriteReq,
)
from torch_test_env import autotune_never  # noqa: F401 - autouse

_GPU_KNOBS = (
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES",
    "TORCHSNAPSHOT_GPU_IO_CONCURRENCY",
    "TORCHSNAPSHOT_GPU_PREVERIFY",
    "TORCHSNAPSHOT_GPU_STREAM_READS",
    "TORCHSNAPSHOT_GPU_DEVICE_DIGESTS",
    "TORCHSNAPSHOT_GPU_FAULT_PLAN",
    "TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES",
)


@pytest.fixture(autouse=True)
def _fresh_governor(monkeypatch):
    for name in _GPU_KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_AUTOTUNE", "never")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_AUTOTUNE", "never")
    S.reset_io_governor()
    jax_scheduler.reset_io_governor()
    yield
    faultinject.disable()
    S.reset_io_governor()
    jax_scheduler.reset_io_governor()


class InMemoryStoragePlugin(StoragePlugin):
    def __init__(self, delay: float = 0.0) -> None:
        self.storage: Dict[str, bytes] = {}
        self.delay = delay

    async def write(self, write_io: WriteIO) -> None:
        await asyncio.sleep(self.delay)
        self.storage[write_io.path] = bytes(write_io.buf)

    async def read(self, read_io: ReadIO) -> None:
        await asyncio.sleep(self.delay)
        data = self.storage[read_io.path]
        if read_io.byte_range is not None:
            lo, hi = read_io.byte_range
            data = data[lo:hi]
        read_io.buf = bytearray(data)

    async def delete(self, path: str) -> None:
        del self.storage[path]

    async def close(self) -> None:
        pass


class TrackingStager(BufferStager):
    live_bytes = 0
    peak_bytes = 0

    def __init__(self, payload: bytes, delay: float = 0.005) -> None:
        self.payload = payload
        self.delay = delay

    async def stage_buffer(self, executor=None):
        cls = TrackingStager
        cls.live_bytes += len(self.payload)
        cls.peak_bytes = max(cls.peak_bytes, cls.live_bytes)
        await asyncio.sleep(self.delay)
        return self.payload

    def get_staging_cost_bytes(self) -> int:
        return len(self.payload)


class ReleasingStoragePlugin(InMemoryStoragePlugin):
    async def write(self, write_io: WriteIO) -> None:
        await super().write(write_io)
        TrackingStager.live_bytes -= len(write_io.buf)


class SimpleConsumer(BufferConsumer):
    def __init__(self, sink: Dict[str, bytes], key: str, cost: int) -> None:
        self.sink = sink
        self.key = key
        self.cost = cost

    async def consume_buffer(self, buf, executor=None) -> None:
        self.sink[self.key] = bytes(buf)

    def get_consuming_cost_bytes(self) -> int:
        return self.cost


def _make_write_reqs(n: int, size: int):
    return [
        WriteReq(path=f"obj_{i}", buffer_stager=TrackingStager(bytes([i % 256]) * size))
        for i in range(n)
    ]


@pytest.fixture
def tracking():
    TrackingStager.live_bytes = TrackingStager.peak_bytes = 0


@pytest.fixture
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def test_write_all_completed(loop, tracking) -> None:
    storage = InMemoryStoragePlugin()
    S.sync_execute_write_reqs(_make_write_reqs(20, 100), storage, 10**9, 0, loop)
    assert len(storage.storage) == 20
    assert storage.storage["obj_3"] == bytes([3]) * 100


def test_budget_respected(loop, tracking) -> None:
    storage = ReleasingStoragePlugin(delay=0.002)
    S.sync_execute_write_reqs(_make_write_reqs(16, 1000), storage, 3000, 0, loop)
    assert len(storage.storage) == 16
    assert TrackingStager.peak_bytes <= 3000


def test_oversized_request_does_not_deadlock(loop, tracking) -> None:
    storage = InMemoryStoragePlugin()
    S.sync_execute_write_reqs(_make_write_reqs(3, 5000), storage, 1000, 0, loop)
    assert len(storage.storage) == 3


def test_pending_io_work_defers_storage_io(loop, tracking) -> None:
    storage = InMemoryStoragePlugin(delay=0.05)
    reqs = _make_write_reqs(4, 10)
    pending = loop.run_until_complete(S.execute_write_reqs(reqs, storage, 10**9, rank=0))
    assert len(storage.storage) < 4  # staged, not all written
    pending.sync_complete(loop)
    assert len(storage.storage) == 4
    assert S.io_governor().write_bps("InMemoryStoragePlugin") > 0


def test_read_pipeline(loop) -> None:
    storage = InMemoryStoragePlugin()
    storage.storage = {f"k{i}": bytes([i]) * 50 for i in range(10)}
    sink: Dict[str, bytes] = {}
    reqs = [ReadReq(path=f"k{i}", buffer_consumer=SimpleConsumer(sink, f"k{i}", 50)) for i in range(10)]
    S.sync_execute_read_reqs(reqs, storage, 10**9, 0, loop)
    assert sink == storage.storage
    assert S.io_governor().read_bps("InMemoryStoragePlugin") > 0


def test_read_with_byte_range(loop) -> None:
    storage = InMemoryStoragePlugin()
    storage.storage = {"blob": bytes(range(100))}
    sink: Dict[str, bytes] = {}
    reqs = [ReadReq(path="blob", buffer_consumer=SimpleConsumer(sink, "mid", 30), byte_range=(10, 40))]
    S.sync_execute_read_reqs(reqs, storage, 10**9, 0, loop)
    assert sink["mid"] == bytes(range(10, 40))


def test_read_oversized_budget_escape(loop) -> None:
    storage = InMemoryStoragePlugin()
    storage.storage = {"big": b"x" * 10000}
    sink: Dict[str, bytes] = {}
    reqs = [ReadReq(path="big", buffer_consumer=SimpleConsumer(sink, "big", 10000))]
    S.sync_execute_read_reqs(reqs, storage, 100, 0, loop)
    assert sink["big"] == b"x" * 10000


def test_memory_budget_env_override(monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES", "12345")
    assert S.get_process_memory_budget_bytes() == 12345


def test_memory_budget_default_capped() -> None:
    assert 0 < S.get_process_memory_budget_bytes() <= 32 * 1024**3


def test_write_error_propagates(loop) -> None:
    class FaultyStorage(InMemoryStoragePlugin):
        async def write(self, write_io: WriteIO) -> None:
            raise RuntimeError("injected storage failure")

    with pytest.raises(RuntimeError, match="injected storage failure"):
        S.sync_execute_write_reqs(_make_write_reqs(2, 10), FaultyStorage(), 10**9, 0, loop)


def test_stage_fault_site_aborts_the_take(tmp_path) -> None:
    faultinject.configure("scheduler.stage@2=permanent")
    with pytest.raises(faultinject.InjectedPermanentError):
        P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(a=torch.ones(4), b=torch.ones(5))})
    assert not (tmp_path / "s" / ".snapshot_metadata").exists()


def test_commit_fault_site_leaves_no_snapshot(tmp_path) -> None:
    faultinject.configure("commit.metadata@1=permanent")
    with pytest.raises(faultinject.InjectedPermanentError):
        P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(a=torch.ones(4))})
    assert not (tmp_path / "s" / ".snapshot_metadata").exists()
    faultinject.configure("commit.metadata@1=truncate:0.5")
    P.Snapshot.take(str(tmp_path / "t"), {"app": P.StateDict(a=torch.ones(4))})
    with pytest.raises(Exception):
        P.Snapshot(str(tmp_path / "t")).restore({"app": P.StateDict(a=torch.zeros(4))})


def test_fault_plan_parser_refuses_unknown_sites() -> None:
    with pytest.raises(ValueError, match="unknown site"):
        faultinject.configure("azure.put@1=transient")
    # The cloud plugins' sites, once unknown here, are registered now.
    faultinject.configure("s3.put_part@1=transient")
    assert faultinject.active_spec().startswith("s3.put_part")
    with pytest.raises(ValueError, match="unknown action"):
        faultinject.configure("fs.pread@1=explode")
    faultinject.configure("fs.pread@2+=delay:0;seed=9")
    assert faultinject.active() and faultinject.active_spec().endswith("seed=9")


# -------------------------------------------------------------- governor


_RATES = [None, 50 << 20, 200 << 20, 999_000_000, 1 << 30, 10 << 30]


@pytest.mark.parametrize("op", ["write", "read"])
@pytest.mark.parametrize("bps", _RATES)
def test_governor_elections_match_the_jax_package(op, bps) -> None:
    """On the same recorded rate both governors elect the same sub-chunk
    size and I/O concurrency."""
    gov, jgov = S.IOGovernor(), jax_scheduler.IOGovernor()
    if bps is not None:
        for g in (gov, jgov):
            (g.record_read if op == "read" else g.record_write)("FSStoragePlugin", bps, 1.0)
    assert gov.sub_chunk_bytes("FSStoragePlugin", op=op) == jgov.sub_chunk_bytes("FSStoragePlugin", op=op)
    assert gov.io_concurrency(op, "FSStoragePlugin") == jgov.io_concurrency(op, "FSStoragePlugin")


@pytest.mark.parametrize("read_bps", [None, 50 << 20, 1 << 30, 4 << 30])
@pytest.mark.parametrize("hash_bps", [None, 1 << 30, 3 << 30])
def test_preverify_gate_matches_the_jax_package(monkeypatch, read_bps, hash_bps) -> None:
    monkeypatch.delenv("TORCHSNAPSHOT_TPU_PREVERIFY", raising=False)
    gov, jgov = S.IOGovernor(), jax_scheduler.IOGovernor()
    for g in (gov, jgov):
        if read_bps is not None:
            g.record_read("FSStoragePlugin", read_bps, 1.0)
        if hash_bps is not None:
            g.record_hash(hash_bps, 1.0)
    assert gov.should_preverify("FSStoragePlugin") == jgov.should_preverify("FSStoragePlugin")


def test_preverify_mode_parser_matches_the_jax_package(monkeypatch) -> None:
    for raw in ("", "1", "always", "on", "0", "never", "off", "auto", "junk"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_PREVERIFY", raw)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_PREVERIFY", raw)
        assert S.preverify_mode() == jax_scheduler.preverify_mode(), raw


def test_preverify_knee_has_a_dead_band() -> None:
    gov = S.IOGovernor()
    gov.record_hash(1 << 30, 1.0)
    gov.record_read("X", int(1.3 * (1 << 30)), 1.0)  # above 1.25x: skip
    assert not gov.should_preverify("X")
    gov._read_bps["X"] = 1.2 * (1 << 30)  # below the knee, inside the band
    assert not gov.should_preverify("X")
    gov._read_bps["X"] = 1.0 * (1 << 30)  # clearly below: verify
    assert gov.should_preverify("X")


def test_rates_feed_the_process_governor() -> None:
    gov = S.reset_io_governor()
    assert S.io_governor() is gov
    S._feed_governor_rates("write", "A", 100, 1.0)
    S._feed_governor_rates("read", "A", 200, 1.0)
    S._feed_governor_rates("hash", None, 300, 1.0)
    S._feed_governor_rates("write", "A", 300, 1.0)  # EWMA alpha 0.5
    S._feed_governor_rates("write", "A", 0, 1.0)  # ignored
    assert gov.measured_rates() == {"write_bps": {"A": 200.0}, "read_bps": {"A": 200.0}, "hash_bps": 300.0}
    assert S.reset_io_governor() is not gov


def test_autotune_knob_raises_by_name(tmp_path, monkeypatch) -> None:
    """Every spelling of ``TORCHSNAPSHOT_GPU_AUTOTUNE``, once refused
    here, now takes: an unset knob is ``auto`` as in the JAX package, and
    a learning mode's take scores its verdict (with the bus off, an
    explicit skip) while ``never`` leaves the tuner untouched (the test
    keeps its name)."""
    from torchsnapshot_tpu_torch import autotune

    for value in ("never", "0", "", "auto", "pin", "fresh"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_AUTOTUNE", value)
        gov = S.reset_io_governor()
        P.Snapshot.take(str(tmp_path / f"s{value}"), {"app": P.StateDict(a=torch.ones(2))})
        assert autotune.autotune_mode() == ("never" if value in ("never", "0") else
                                            value or "auto")
        assert gov.profiles() == {}
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_AUTOTUNE")
    assert autotune.autotune_mode() == "auto"
    S.reset_io_governor()


# ------------------------------------------------ preverify and hash probe


@pytest.fixture
def probe(monkeypatch):
    """A fresh, small hash probe (the plain version on the CPU)."""
    monkeypatch.setattr(device_digest, "_hash_probe_done", False)
    monkeypatch.setattr(device_digest, "_HASH_PROBE_BYTES", 1 << 20)


def test_probe_hash_throughput_records_once(probe) -> None:
    rate = device_digest.probe_hash_throughput("cpu")
    assert rate is not None and rate > 0
    assert S.io_governor().hash_bps() == rate
    S.io_governor().record_hash(1, 1.0)
    assert device_digest.probe_hash_throughput("cpu") == S.io_governor().hash_bps() != rate


def test_probe_survives_an_unfingerprintable_device(probe) -> None:
    assert device_digest.probe_hash_throughput("meta") is None
    assert S.io_governor().hash_bps() is None


def _fingerprint_spy(monkeypatch) -> list:
    from torchsnapshot_tpu_torch.io_preparers import prepare

    calls = []
    real = prepare._dst_already_matches

    def spy(entry, dst):
        calls.append(entry)
        return real(entry, dst)

    monkeypatch.setattr(prepare, "_dst_already_matches", spy)
    return calls


def _digest_snapshot(tmp_path) -> tuple:
    w = torch.arange(4096, dtype=torch.float32)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)}, device_digests=True)
    return P.Snapshot(str(tmp_path / "s")), w


def test_restore_probes_the_hash_rate_once_a_read_rate_is_known(tmp_path, monkeypatch, probe) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS", "1")
    snap, w = _digest_snapshot(tmp_path)
    calls = _fingerprint_spy(monkeypatch)
    S.reset_io_governor()
    dst = torch.zeros(4096)
    snap.restore({"app": P.StateDict(w=dst)})  # no read rate: verify, no probe
    assert S.io_governor().hash_bps() is None and len(calls) == 1
    assert torch.equal(dst, w)
    snap.restore({"app": P.StateDict(w=dst)})  # a read rate now: probe once
    assert S.io_governor().hash_bps() is not None


def test_preverify_gate_skips_fingerprints_on_fast_storage(tmp_path, monkeypatch) -> None:
    """Digests from the environment: when reading beats hashing, the restore
    reads instead of fingerprinting; a caller's device_digests=True is
    obeyed, unless TORCHSNAPSHOT_GPU_PREVERIFY=never."""
    snap, w = _digest_snapshot(tmp_path)
    calls = _fingerprint_spy(monkeypatch)
    gov = S.io_governor()
    gov.record_read("FSStoragePlugin", 100 << 30, 1.0)
    gov.record_hash(1 << 20, 1.0)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS", "1")
    dst = torch.zeros(4096)
    snap.restore({"app": P.StateDict(w=dst)})
    assert calls == [] and torch.equal(dst, w)
    snap.restore({"app": P.StateDict(w=dst)}, device_digests=True)
    assert len(calls) == 1
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PREVERIFY", "never")
    snap.restore({"app": P.StateDict(w=dst)}, device_digests=True)
    assert len(calls) == 1
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PREVERIFY", "always")
    snap.restore({"app": P.StateDict(w=dst)})
    assert len(calls) == 2 and torch.equal(dst, w)


def test_preverify_gate_verifies_on_slow_storage(tmp_path, monkeypatch) -> None:
    snap, w = _digest_snapshot(tmp_path)
    calls = _fingerprint_spy(monkeypatch)
    gov = S.io_governor()
    gov.record_read("FSStoragePlugin", 10 << 20, 1.0)
    gov.record_hash(1 << 30, 1.0)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS", "1")
    dst = w.clone()
    snap.restore({"app": P.StateDict(w=dst)})
    assert len(calls) == 1 and torch.equal(dst, w)
