"""The port's io_uring engine and its election: mirrors of
``tests/test_native_io.py`` (the engine's submit/wait/drain and EOF
taxonomy, the two holders of a staging slab, the fs plugin's native
streams with their fault sites, the election and the governor's gates),
held against the JAX package's engine where both run."""

from __future__ import annotations

import asyncio
import gc
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import native_io as jax_native_io
from torchsnapshot_tpu import scheduler as jax_scheduler
from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFS
from torchsnapshot_tpu_torch import _native, faultinject, native_io
from torchsnapshot_tpu_torch import scheduler as S
from torchsnapshot_tpu_torch.io_preparers import array as array_mod
from torchsnapshot_tpu_torch.io_preparers.array import _staging_pool, pooled_buffer
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteStream
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torch_test_env import autotune_never  # noqa: F401 - autouse

uring = pytest.mark.skipif(native_io.engine_kind() != "uring", reason="io_uring unavailable")
native = pytest.mark.skipif(not _native.native_available(), reason="native library not built")
_GPU_KNOBS = (
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES",
    "TORCHSNAPSHOT_GPU_STREAM_WRITES",
    "TORCHSNAPSHOT_GPU_STREAM_READS",
    "TORCHSNAPSHOT_GPU_NATIVE_IO",
    "TORCHSNAPSHOT_GPU_NATIVE_QUEUE_DEPTH",
    "TORCHSNAPSHOT_GPU_NATIVE_ALIGN",
    "TORCHSNAPSHOT_GPU_NATIVE_ODIRECT",
    "TORCHSNAPSHOT_GPU_FAULT_PLAN",
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


@pytest.fixture
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


async def _chunks_of(payload: bytes, n: int):
    for lo in range(0, len(payload), n):
        yield payload[lo : lo + n]


async def _collect(stream) -> bytes:
    out = bytearray()
    async for chunk in stream.chunks:
        out += bytes(memoryview(chunk).cast("B"))
    return bytes(out)


def _payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------- engine


@native
def test_probe_agrees_with_the_jax_package() -> None:
    from torchsnapshot_tpu import _native as jax_native

    assert _native.uring_probe() == jax_native.uring_probe()
    assert native_io.probe_result() == _native.uring_probe()
    assert native_io.engine_kind() == jax_native_io.engine_kind()


@uring
def test_engine_write_read_roundtrip(tmp_path) -> None:
    eng = native_io.open_engine()
    assert isinstance(eng, native_io.UringEngine)
    path = str(tmp_path / "f")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        payload = np.frombuffer(_payload(1 << 18), np.uint8).copy()
        slots = [eng.submit_pwrite(fd, payload[lo : lo + (1 << 16)], lo) for lo in range(0, 1 << 18, 1 << 16)]
        assert eng.inflight == 4
        eng.drain()
        assert eng.inflight == 0
        back = np.zeros(1 << 18, np.uint8)
        eng.wait(eng.submit_pread(fd, back, 0))
        assert np.array_equal(back, payload) and len(slots) == 4
    finally:
        eng.close()
        os.close(fd)


@uring
def test_engine_short_read_is_eoferror(tmp_path) -> None:
    path = str(tmp_path / "short")
    with open(path, "wb") as f:
        f.write(b"x" * 100)
    eng = native_io.open_engine()
    fd = os.open(path, os.O_RDONLY)
    try:
        slot = eng.submit_pread(fd, np.zeros(4096, np.uint8), 0)
        with pytest.raises(EOFError):
            eng.wait(slot, path)
    finally:
        eng.close()
        os.close(fd)


@uring
def test_engine_error_propagates_from_drain(tmp_path) -> None:
    path = str(tmp_path / "ro")
    with open(path, "wb") as f:
        f.write(b"y" * 10)
    eng = native_io.open_engine()
    fd = os.open(path, os.O_RDONLY)
    try:
        eng.submit_pwrite(fd, np.zeros(64, np.uint8), 0)
        with pytest.raises(OSError):
            eng.drain()
    finally:
        eng.close()
        os.close(fd)


@uring
def test_slab_held_by_an_sqe_is_not_handed_out(tmp_path) -> None:
    """A pooled slab submitted to the engine is not handed out again while
    its SQE may be in flight, even with every Python reference dropped;
    once reaped it recycles."""
    path = str(tmp_path / "pin")
    with open(path, "wb") as f:
        f.write(_payload(1 << 20))
    eng = native_io.open_engine()
    fd = os.open(path, os.O_RDONLY)
    try:
        size = (1 << 20) - 12288  # an odd size no other test draws
        buf = pooled_buffer(size)
        ptr = buf.data_ptr()
        slot = eng.submit_pread(fd, buf, 0)
        del buf
        gc.collect()
        fresh = pooled_buffer(size)
        assert fresh.data_ptr() != ptr
        eng.wait(slot)
        gc.collect()
        recycled = pooled_buffer(size)
        assert recycled.data_ptr() == ptr
        del fresh, recycled
    finally:
        eng.close()
        os.close(fd)


class _FakeEvent:
    """Stands in for a CUDA event on the CPU: records when it is waited."""

    def __init__(self, log: list) -> None:
        self.log = log

    def synchronize(self) -> None:
        self.log.append("synchronized")


@native
def test_slab_held_by_a_cuda_event_waits_before_reuse() -> None:
    """A slab fenced by a copy's event goes back to the pool when its last
    reference dies, but the pool hands it out again only after waiting on
    that event, and never while another holder has it."""
    size = (1 << 20) - 20480
    log: list = []
    buf = pooled_buffer(size)
    ptr = buf.data_ptr()
    _staging_pool.fence(buf, _FakeEvent(log))
    other = pooled_buffer(size)
    assert other.data_ptr() != ptr and log == []  # held: not handed out
    del buf
    gc.collect()
    again = pooled_buffer(size)
    assert again.data_ptr() == ptr and log == ["synchronized"]
    del other, again


@native
def test_pool_peak_counts_outstanding_bytes() -> None:
    _staging_pool.reset_peak()
    base = _staging_pool.outstanding_bytes
    a = pooled_buffer(1 << 16)
    b = pooled_buffer(1 << 17)
    assert _staging_pool.peak_bytes >= base + (1 << 16) + (1 << 17)
    del a, b
    gc.collect()
    pooled_buffer(8192)
    assert _staging_pool.outstanding_bytes <= base + 8192


@pytest.mark.parametrize("sub,want", [(1, 4096), (4096, 4096), (4097, 8192), (64 << 20, 64 << 20),
                                      ((64 << 20) + 1, 128 << 20), (97_517_568, 128 << 20)])
def test_stream_slabs_come_in_power_of_two_classes(sub, want) -> None:
    from torchsnapshot_tpu_torch.io_preparers.array import stream_slab_bytes

    assert stream_slab_bytes(sub) == want


@native
def test_a_full_pool_frees_the_oldest_other_size_first(monkeypatch) -> None:
    from torchsnapshot_tpu_torch.io_preparers.array import _StagingPool

    pool = _StagingPool(limit_bytes=3 * 8192)
    old = [pool.get(8192) for _ in range(2)]
    del old
    gc.collect()
    pool.free_bytes()
    assert pool._free[8192] and pool.free_bytes() == 2 * 8192
    new = [pool.get(12288) for _ in range(2)]
    del new
    gc.collect()
    # Both 12 KiB slabs are kept: the older 8 KiB slabs made room.
    assert len(pool._free[12288]) == 2 and not pool._free[8192]
    more = [pool.get(12288) for _ in range(3)]
    assert pool.hits == 2
    del more
    gc.collect()
    # Only its own size is left: the third returning slab is freed.
    assert len(pool._free[12288]) == 2 and pool.free_bytes() == 2 * 12288
    pool.clear()


@native
def test_pin_registers_pool_slabs_from_their_start(monkeypatch) -> None:
    calls = []

    class _Rt:
        def cudaHostRegister(self, addr, n, flags):
            calls.append(n)
            return 0

        def cudaHostUnregister(self, addr):
            return 0

    monkeypatch.setattr(array_mod, "_cudart", lambda: _Rt())
    slab = pooled_buffer((1 << 20) - 28672)
    assert _staging_pool.pin(slab) and calls == [slab.numel()]
    assert _staging_pool.pin(slab) and len(calls) == 1  # once
    assert _staging_pool.pin(slab[:100]) and len(calls) == 1  # a read window's prefix
    assert not _staging_pool.pin(slab[100:])
    assert not _staging_pool.pin(torch.zeros(100, dtype=torch.uint8))
    del slab
    gc.collect()
    _staging_pool.clear()


# ------------------------------------------------------------ fs plugin


@uring
def test_fs_native_stream_equals_python_stream(tmp_path, loop, monkeypatch) -> None:
    payload = _payload((1 << 20) + 12345)
    plugin = FSStoragePlugin(root=str(tmp_path))
    for engine in ("never", "always"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", engine)
        loop.run_until_complete(
            plugin.write_stream(
                WriteStream(path=engine, nbytes=len(payload), chunks=_chunks_of(payload, 100_000))
            )
        )
    assert (tmp_path / "always").read_bytes() == (tmp_path / "never").read_bytes()
    rates = S.io_governor().measured_rates()["write_bps"]
    assert rates.get("FSStoragePlugin.native", 0) > 0
    for engine in ("always", "never"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", engine)
        stream = loop.run_until_complete(plugin.read_stream(ReadIO(path="always"), 100_000))
        assert loop.run_until_complete(_collect(stream)) == payload


@uring
def test_fs_native_stream_matches_the_jax_package(tmp_path, loop, monkeypatch) -> None:
    payload = _payload((1 << 20) + 777, seed=4)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_NATIVE_IO", "always")
    loop.run_until_complete(
        FSStoragePlugin(str(tmp_path)).write_stream(
            WriteStream("p", len(payload), _chunks_of(payload, 65536))
        )
    )
    from torchsnapshot_tpu.io_types import WriteStream as JWriteStream

    loop.run_until_complete(
        JaxFS(str(tmp_path)).write_stream(JWriteStream("j", len(payload), _chunks_of(payload, 65536)))
    )
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes() == payload


@uring
def test_fs_native_ranged_read_stream(tmp_path, loop, monkeypatch) -> None:
    payload = _payload(1 << 20)
    (tmp_path / "r").write_bytes(payload)
    plugin = FSStoragePlugin(root=str(tmp_path))
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    stream = loop.run_until_complete(plugin.read_stream(ReadIO(path="r", byte_range=(1000, 700_000)), 65_536))
    assert loop.run_until_complete(_collect(stream)) == payload[1000:700_000]
    assert S.io_governor().read_bps("FSStoragePlugin.native") > 0


@uring
def test_fs_native_midstream_failure_atomic(tmp_path, loop, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    plugin = FSStoragePlugin(root=str(tmp_path))
    payload = _payload(1 << 20)
    faultinject.configure("fs.native_pwrite@2=permanent")
    try:
        with pytest.raises(OSError):
            loop.run_until_complete(
                plugin.write_stream(WriteStream("obj", len(payload), _chunks_of(payload, 100_000)))
            )
    finally:
        faultinject.disable()
    assert not (tmp_path / "obj").exists()
    assert not list(tmp_path.glob("*.tmp.*"))
    assert faultinject.hits() == {}


@uring
def test_fs_native_truncate_fault_detected_as_short_write(tmp_path, loop, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    plugin = FSStoragePlugin(root=str(tmp_path))
    payload = _payload(1 << 20)
    faultinject.configure("fs.native_pwrite@3=truncate:0.5")
    with pytest.raises(IOError, match="short write stream"):
        loop.run_until_complete(
            plugin.write_stream(WriteStream("obj", len(payload), _chunks_of(payload, 100_000)))
        )
    assert not (tmp_path / "obj").exists()


@uring
def test_fs_native_pread_corrupt_flips_one_byte(tmp_path, loop, monkeypatch) -> None:
    payload = _payload(1 << 20)
    (tmp_path / "r").write_bytes(payload)
    plugin = FSStoragePlugin(root=str(tmp_path))
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    faultinject.configure("fs.native_pread@1=corrupt;seed=3")
    stream = loop.run_until_complete(plugin.read_stream(ReadIO(path="r"), 65_536))
    got = loop.run_until_complete(_collect(stream))
    assert len(got) == len(payload)
    assert sum(a != b for a, b in zip(got, payload)) == 1


@uring
def test_odirect_write_drops_direct_at_an_unaligned_tail(tmp_path, loop, monkeypatch) -> None:
    """O_DIRECT wants 4096-byte alignment of buffer, length and offset:
    aligned slabs go direct, and the stream drops the flag at the first
    unaligned chunk (or never gets it where the filesystem refuses it);
    the bytes are the same either way."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_ODIRECT", "1")
    chunks = []
    for i in range(3):
        slab = pooled_buffer(1 << 16)
        slab.fill_(i)
        chunks.append(memoryview(slab.numpy()))
    chunks.append(memoryview(np.full(1000, 9, np.uint8)))  # the unaligned tail
    assert native_io.io_aligned(chunks[0], 0) and not native_io.io_aligned(chunks[3], 3 << 16)
    assert not native_io.io_aligned(chunks[0][1:4097], 0)

    async def gen():
        for c in chunks:
            yield c

    total = sum(c.nbytes for c in chunks)
    loop.run_until_complete(FSStoragePlugin(str(tmp_path)).write_stream(WriteStream("d", total, gen())))
    assert (tmp_path / "d").read_bytes() == b"".join(bytes(c) for c in chunks)


# -------------------------------------------------------------- election


def test_native_io_mode_parser(monkeypatch) -> None:
    for raw, want in [
        ("never", "never"), ("0", "never"), ("off", "never"),
        ("always", "always"), ("1", "always"), ("force", "always"),
        ("auto", "auto"), ("", "auto"), ("garbage", "auto"),
    ]:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", raw)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_NATIVE_IO", raw)
        assert native_io.native_io_mode() == want == jax_native_io.native_io_mode(), raw


def test_knob_parsers_match_the_jax_package(monkeypatch) -> None:
    for depth in ("", "0", "3", "1000", "x"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_QUEUE_DEPTH", depth)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_NATIVE_QUEUE_DEPTH", depth)
        assert native_io.queue_depth() == jax_native_io.queue_depth(), depth
    for align in ("", "512", "1000", "x"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_ALIGN", align)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_NATIVE_ALIGN", align)
        assert native_io.alignment() == jax_native_io.alignment(), align


def test_elect_never_short_circuits(monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "never")
    assert native_io.maybe_engine("write", "FSStoragePlugin") is None


def test_elect_degrades_silently_without_engine(monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always")
    monkeypatch.setattr(native_io, "_probe_done", True)
    monkeypatch.setattr(native_io, "_probe_kind", None)
    assert native_io.elect("write", "FSStoragePlugin") is False
    assert native_io.maybe_engine("write", "FSStoragePlugin") is None


@native
def test_failed_probe_keeps_its_errno(monkeypatch) -> None:
    monkeypatch.setattr(_native, "uring_probe", lambda: -1)  # EPERM, as under seccomp
    native_io._reset_probe_for_tests()
    try:
        assert native_io.engine_kind() is None
        assert native_io.probe_result() == -1
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_ODIRECT", "1")
        native_io._reset_probe_for_tests()
        assert native_io.engine_kind() == "posix"
        assert not native_io.elect("read", "FSStoragePlugin")  # posix never reads
    finally:
        # Re-probed lazily, after monkeypatch restores the real probe.
        native_io._reset_probe_for_tests()


def test_governor_native_write_gate() -> None:
    governor = S.IOGovernor()
    assert governor.should_native_io("FSStoragePlugin", op="write")
    governor.record_write("FSStoragePlugin", 1 << 30, 1.0)
    assert governor.should_native_io("FSStoragePlugin", op="write")
    governor.record_write("FSStoragePlugin.native", 1 << 30, 2.0)
    assert not governor.should_native_io("FSStoragePlugin", op="write")
    governor.record_write("FSStoragePlugin.native", 1 << 30, 0.25)
    assert governor.should_native_io("FSStoragePlugin", op="write")


def test_governor_native_read_gate_uses_latency_knee() -> None:
    governor = S.IOGovernor()
    assert not governor.should_native_io("FSStoragePlugin", op="read")
    governor.record_read("FSStoragePlugin", 4 << 30, 1.0)
    assert not governor.should_native_io("FSStoragePlugin", op="read")
    slow = S.IOGovernor()
    slow.record_read("FSStoragePlugin", 50 << 20, 1.0)
    assert slow.should_native_io("FSStoragePlugin", op="read")
    slow.record_read("FSStoragePlugin.native", 10 << 20, 1.0)
    assert not slow.should_native_io("FSStoragePlugin", op="read")


@pytest.mark.parametrize("op", ["write", "read"])
def test_governor_gates_match_the_jax_package(op) -> None:
    """The same recorded rates give the same native election in both."""
    for base, nat in [(None, None), (50 << 20, None), (4 << 30, None), (50 << 20, 10 << 20),
                      (1 << 30, 2 << 30), (1 << 30, 1 << 29)]:
        gov, jgov = S.IOGovernor(), jax_scheduler.IOGovernor()
        for g in (gov, jgov):
            record = g.record_read if op == "read" else g.record_write
            if base is not None:
                record("FSStoragePlugin", base, 1.0)
            if nat is not None:
                record("FSStoragePlugin.native", nat, 1.0)
        assert gov.should_native_io("FSStoragePlugin", op=op) == jgov.should_native_io(
            "FSStoragePlugin", op=op
        ), (base, nat)


@uring
@pytest.mark.parametrize("engine", ["always", "never"])
def test_native_end_to_end_snapshot_roundtrip(tmp_path, monkeypatch, engine) -> None:
    """A streamed take through the engine (or without it) records the
    checksums of the Python path, restores bit-exact into both packages,
    and writes the files the JAX package writes."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", engine)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(1 << 18))
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SUB_CHUNK_BYTES", str(1 << 18))
    opened = native_io.opened["uring"]
    w = np.random.default_rng(7).standard_normal(500_000).astype(np.float32)
    P.Snapshot.take(str(tmp_path / "s"), {"m": P.StateDict(w=torch.from_numpy(w.copy()))})
    assert (native_io.opened["uring"] > opened) == (engine == "always")
    J.Snapshot.take(str(tmp_path / "j"), {"m": J.StateDict(w=w)})
    for name in ("0/m/w_0", ".snapshot_metadata"):
        assert (tmp_path / "s" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    dst = torch.zeros(500_000)
    P.Snapshot(str(tmp_path / "s")).restore({"m": P.StateDict(w=dst)})
    assert np.array_equal(dst.numpy(), w)
    holder = J.StateDict(w=np.zeros(500_000, np.float32))
    J.Snapshot(str(tmp_path / "s")).restore({"m": holder})
    assert np.array_equal(np.asarray(holder["w"]), w)
    sums = [c.array.checksum for e in P.Snapshot(str(tmp_path / "s")).metadata.manifest.values()
            for c in getattr(e, "chunks", None) or []]
    assert sums and all(c.startswith("crc32c:") for c in sums)
