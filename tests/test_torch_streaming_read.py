"""Streamed reads in the port: mirrors of ``tests/test_streaming_read.py``
(the fs read-stream contract, the consumers' verify-before-commit, the
batched slab stream, the scheduler's window accounting and election) on
torch tensors, and corrupted sub-chunks driven through ``faultinject``.

Every test starts from a fresh I/O governor with autotuning off, and pins
``TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES`` where it needs a stream."""

from __future__ import annotations

import asyncio
import os
import zlib

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import scheduler as jax_scheduler
from torchsnapshot_tpu_torch import faultinject, native_io
from torchsnapshot_tpu_torch import scheduler as S
from torchsnapshot_tpu_torch.integrity import IntegrityError, compute_checksum
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer, DeviceStreams
from torchsnapshot_tpu_torch.io_types import (
    ReadIO,
    ReadReq,
    ReadStream,
    StoragePlugin,
    StreamRestartRequired,
    WriteIO,
)
from torchsnapshot_tpu_torch.manifest import ArrayEntry
from torchsnapshot_tpu_torch.serialization import dtype_to_string
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torch_test_env import autotune_never  # noqa: F401 - autouse

SUB = 64 << 10
_GPU_KNOBS = (
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_MIN_BYTES",
    "TORCHSNAPSHOT_GPU_SUB_CHUNK_MAX_BYTES",
    "TORCHSNAPSHOT_GPU_IO_CONCURRENCY",
    "TORCHSNAPSHOT_GPU_PREVERIFY",
    "TORCHSNAPSHOT_GPU_STREAM_WRITES",
    "TORCHSNAPSHOT_GPU_STREAM_READS",
    "TORCHSNAPSHOT_GPU_NATIVE_IO",
    "TORCHSNAPSHOT_GPU_FAULT_PLAN",
)
uring = pytest.mark.skipif(native_io.engine_kind() != "uring", reason="io_uring unavailable")


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


class BufferedFallbackPlugin(StoragePlugin):
    """No read_stream override: the buffered default."""

    def __init__(self):
        self.store = {}

    async def write(self, write_io):
        self.store[write_io.path] = bytes(memoryview(write_io.buf))

    async def read(self, read_io):
        data = self.store[read_io.path]
        if read_io.byte_range is not None:
            lo, hi = read_io.byte_range
            data = data[lo:hi]
        read_io.buf = data

    async def delete(self, path):
        del self.store[path]

    async def close(self):
        pass


async def _collect(plugin, path, sub_chunk, byte_range=None):
    stream = await plugin.read_stream(ReadIO(path=path, byte_range=byte_range), sub_chunk)
    parts = []
    async for chunk in stream.chunks:
        parts.append(bytes(memoryview(chunk)))
    return stream.nbytes, parts


# --------------------------------------------------------------- contract


@pytest.mark.parametrize(
    "name", ["fs-python", pytest.param("fs-native", marks=uring), "fallback"]
)
def test_streamed_equals_buffered(name, tmp_path, loop, monkeypatch) -> None:
    if name == "fallback":
        plugin = BufferedFallbackPlugin()
    else:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always" if name == "fs-native" else "never")
        plugin = FSStoragePlugin(str(tmp_path))
    payload = np.random.default_rng(1).integers(0, 256, 700_000, dtype=np.uint8).tobytes()
    loop.run_until_complete(plugin.write(WriteIO(path="obj", buf=payload)))
    nbytes, parts = loop.run_until_complete(_collect(plugin, "obj", SUB))
    assert nbytes == len(payload) and len(parts) > 1
    assert b"".join(parts) == payload
    nbytes, parts = loop.run_until_complete(_collect(plugin, "obj", SUB, byte_range=(1000, 500_000)))
    assert nbytes == 499_000
    assert b"".join(parts) == payload[1000:500_000]


def test_zero_length_ranged_read(tmp_path, loop) -> None:
    plugin = FSStoragePlugin(str(tmp_path))
    loop.run_until_complete(plugin.write(WriteIO(path="obj", buf=b"x" * 1000)))
    read_io = ReadIO(path="obj", byte_range=(10, 10))
    loop.run_until_complete(plugin.read(read_io))
    assert bytes(read_io.buf) == b""
    nbytes, parts = loop.run_until_complete(_collect(plugin, "obj", SUB, byte_range=(10, 10)))
    assert nbytes == 0 and parts == []


# ------------------------------------------------------ consumer semantics


def _entry_for(arr: np.ndarray, location="x", checksum=True, codec=None):
    payload = arr.tobytes()
    stored = payload
    entry = ArrayEntry(
        location=location,
        serializer="buffer_protocol",
        dtype=dtype_to_string(torch.from_numpy(arr).dtype),
        shape=list(arr.shape),
        replicated=False,
    )
    if codec is not None:
        stored = zlib.compress(payload, 6)
        entry.codec = codec
    if checksum:
        entry.checksum = compute_checksum(stored)
    return entry, stored


def _consumer(entry, dst=None, out=None):
    return ArrayBufferConsumer(
        entry, dst, out.append if out is not None else None, DeviceStreams()
    )


async def _consume_streamed(consumer, stored, sub_chunk, mutate=None):
    data = bytearray(stored)
    if mutate is not None:
        mutate(data)

    async def chunks():
        for lo in range(0, len(data), sub_chunk):
            yield memoryview(data)[lo : lo + sub_chunk]

    await consumer.consume_stream(ReadStream(path="x", nbytes=len(data), chunks=chunks()))


@pytest.mark.parametrize("sub", [1000, 7777, 64 << 10])
def test_incremental_crc_equals_whole_buffer_crc(loop, sub) -> None:
    arr = np.arange(200_000, dtype=np.int32)
    entry, stored = _entry_for(arr)
    dst = torch.zeros(200_000, dtype=torch.int32)
    consumer = _consumer(entry, dst)
    assert consumer.can_stream(sub)
    loop.run_until_complete(_consume_streamed(consumer, stored, sub))
    assert np.array_equal(dst.numpy(), arr)


def test_streamed_without_destination_reports_the_value(loop) -> None:
    arr = np.arange(300_000, dtype=np.float64).reshape(300, 1000)
    entry, stored = _entry_for(arr)
    out = []
    consumer = _consumer(entry, None, out)
    loop.run_until_complete(_consume_streamed(consumer, stored, SUB))
    assert len(out) == 1 and np.array_equal(out[0].numpy(), arr)


def test_streamed_corruption_detected_and_dst_unmodified(loop) -> None:
    arr = np.arange(200_000, dtype=np.int32)
    entry, stored = _entry_for(arr)
    dst = torch.full((200_000,), -7, dtype=torch.int32)

    def flip(data):
        data[123_456] ^= 0xFF

    with pytest.raises(IntegrityError):
        loop.run_until_complete(_consume_streamed(_consumer(entry, dst), stored, 10_000, mutate=flip))
    assert bool((dst == -7).all())


def test_streamed_compressed_payload(loop) -> None:
    arr = np.zeros(300_000, dtype=np.float32)
    entry, stored = _entry_for(arr, codec="zlib:6")
    assert len(stored) < arr.nbytes
    dst = torch.ones(300_000)
    consumer = _consumer(entry, dst)
    assert consumer.can_stream(max(1, len(stored) // 4))
    loop.run_until_complete(_consume_streamed(consumer, stored, max(1, len(stored) // 4)))
    assert np.array_equal(dst.numpy(), arr)


def test_streamed_compressed_corruption_rejected(loop) -> None:
    arr = np.zeros(300_000, dtype=np.float32)
    entry, stored = _entry_for(arr, codec="zlib:6")
    dst = torch.full((300_000,), 3.0)

    def flip(data):
        data[len(data) // 2] ^= 0xFF

    with pytest.raises((IntegrityError, RuntimeError, zlib.error)):
        loop.run_until_complete(
            _consume_streamed(_consumer(entry, dst), stored, max(1, len(stored) // 4), mutate=flip)
        )
    assert bool((dst == 3.0).all())


def test_midstream_exception_leaves_destination_unmodified(loop) -> None:
    arr = np.arange(200_000, dtype=np.int32)
    entry, stored = _entry_for(arr)
    dst = torch.full((200_000,), 42, dtype=torch.int32)

    async def dying_chunks():
        yield memoryview(stored)[:50_000]
        yield memoryview(stored)[50_000:100_000]
        raise RuntimeError("injected mid-stream read failure")

    with pytest.raises(RuntimeError, match="injected"):
        loop.run_until_complete(
            _consumer(entry, dst).consume_stream(
                ReadStream(path="x", nbytes=len(stored), chunks=dying_chunks())
            )
        )
    assert bool((dst == 42).all())


@pytest.mark.parametrize("why", ["cast", "strided"])
def test_casts_and_strided_destinations_stay_buffered(why) -> None:
    arr = np.arange(200_000, dtype=np.float32)
    entry, _ = _entry_for(arr)
    dst = torch.zeros(200_000, dtype=torch.float64) if why == "cast" else torch.zeros(400_000)[::2]
    assert not _consumer(entry, dst).can_stream(SUB)
    assert _consumer(entry, torch.zeros(200_000)).can_stream(SUB)


def test_batched_slab_stream_slices_to_consumers(loop) -> None:
    """One sequential stream is cut into per-entry slices: checksums verify
    per entry, gaps are skipped, and the span is never held whole."""
    from torchsnapshot_tpu_torch.batcher import batch_read_requests

    a = np.arange(50_000, dtype=np.int32)
    b = np.arange(70_000, dtype=np.float32) * 0.5
    slab = bytearray(600_000)
    slab[0 : a.nbytes] = a.tobytes()
    b_off = a.nbytes + 4096
    slab[b_off : b_off + b.nbytes] = b.tobytes()
    entry_a, _ = _entry_for(a, location="batched/slab")
    entry_a.byte_range = [0, a.nbytes]
    entry_b, _ = _entry_for(b, location="batched/slab")
    entry_b.byte_range = [b_off, b_off + b.nbytes]
    dst_a, dst_b = torch.zeros(50_000, dtype=torch.int32), torch.zeros(70_000)
    reqs = [
        ReadReq(path="batched/slab", buffer_consumer=_consumer(entry_a, dst_a), byte_range=(0, a.nbytes)),
        ReadReq(
            path="batched/slab", buffer_consumer=_consumer(entry_b, dst_b),
            byte_range=(b_off, b_off + b.nbytes),
        ),
    ]
    merged = batch_read_requests(reqs)
    assert len(merged) == 1
    consumer = merged[0].buffer_consumer
    lo, hi = merged[0].byte_range
    assert consumer.can_stream(SUB)
    assert consumer.stream_admission_cost(SUB) < hi - lo

    async def chunks():
        for off in range(lo, hi, SUB):
            yield memoryview(slab)[off : min(off + SUB, hi)]

    loop.run_until_complete(
        consumer.consume_stream(ReadStream(path="batched/slab", nbytes=hi - lo, chunks=chunks()))
    )
    assert np.array_equal(dst_a.numpy(), a) and np.array_equal(dst_b.numpy(), b)


def test_batched_stream_short_stream_raises(loop) -> None:
    from torchsnapshot_tpu_torch.batcher import BatchedBufferConsumer

    a = np.arange(50_000, dtype=np.int32)
    entry, _ = _entry_for(a)
    consumer = BatchedBufferConsumer([_consumer(entry, torch.zeros(50_000, dtype=torch.int32))],
                                     [(1000, 1000 + a.nbytes)])

    async def chunks():
        yield memoryview(bytes(5000))

    with pytest.raises(IOError, match="short coalesced read stream"):
        loop.run_until_complete(consumer.consume_stream(ReadStream("s", 5000, chunks())))


# ---------------------------------------------------- scheduler accounting


def test_streamed_budget_charges_window_not_payload() -> None:
    """Host-sink consumers hold the whole payload until it verifies, so
    under auto they stream only when stream_all says so, and then they
    are charged the payload; with no sub-chunk size nothing streams."""
    arr = np.arange(1_000_000, dtype=np.float32).reshape(1000, 1000)
    entry, _ = _entry_for(arr)
    scratch = _consumer(entry, torch.zeros(1000, 1000))
    pipeline = S._ReadPipeline(ReadReq(path="x", buffer_consumer=scratch), sub_chunk_bytes=SUB)
    assert not pipeline.streamed
    pipeline = S._ReadPipeline(
        ReadReq(path="x", buffer_consumer=scratch), sub_chunk_bytes=SUB, stream_all=True
    )
    assert pipeline.streamed and pipeline.admission_cost_bytes == arr.nbytes
    pipeline = S._ReadPipeline(ReadReq(path="x", buffer_consumer=scratch))
    assert not pipeline.streamed and pipeline.admission_cost_bytes == arr.nbytes
    empty = S._ReadPipeline(
        ReadReq(path="x", buffer_consumer=scratch, byte_range=(5, 5)), sub_chunk_bytes=SUB,
        stream_all=True,
    )
    assert not empty.streamed


def test_window_consumers_that_do_not_pay_on_fast_storage_wait_for_latency() -> None:
    """A consumer whose window is smaller than its payload, but for which
    streaming does not pay on page-cache reads (the CUDA device sink),
    streams under auto only when storage is latency-bound or streaming is
    forced; one for which it pays streams for its window alone."""
    arr = np.arange(1_000_000, dtype=np.float32)
    entry, _ = _entry_for(arr)

    class Windowed(ArrayBufferConsumer):
        pays = False

        def stream_admission_cost(self, sub_chunk_bytes):
            return 3 * sub_chunk_bytes

        def streams_on_fast_storage(self):
            return self.pays

    consumer = Windowed(entry, torch.zeros(1_000_000), None, DeviceStreams())
    req = ReadReq(path="x", buffer_consumer=consumer)
    assert not S._ReadPipeline(req, sub_chunk_bytes=SUB).streamed
    forced = S._ReadPipeline(req, sub_chunk_bytes=SUB, stream_all=True)
    assert forced.streamed and forced.admission_cost_bytes == 3 * SUB
    consumer.pays = True
    assert S._ReadPipeline(req, sub_chunk_bytes=SUB).streamed
    cpu = _consumer(entry, torch.zeros(1_000_000))
    assert cpu.streams_on_fast_storage() and cpu.stream_admission_cost(SUB) == arr.nbytes


class _RestartingFS(FSStoragePlugin):
    """Yields one streamed chunk, then asks for a restart from offset 0."""

    async def read_stream(self, read_io, sub_chunk_bytes):
        inner = await super().read_stream(read_io, sub_chunk_bytes)

        async def chunks():
            it = inner.chunks
            yield await it.__anext__()
            await it.aclose()
            raise StreamRestartRequired("injected restart")

        return ReadStream(path=inner.path, nbytes=inner.nbytes, chunks=chunks())


def test_restart_fallback_recharges_budget(loop, tmp_path) -> None:
    """After StreamRestartRequired the entry is read buffered, the budget
    is charged the difference, and the destination holds the payload."""
    from torchsnapshot_tpu_torch.batcher import BatchedBufferConsumer

    a = np.arange(100_000, dtype=np.int32)
    b = np.arange(100_000, dtype=np.float32)
    entry_a, stored_a = _entry_for(a, location="obj")
    entry_a.byte_range = [0, len(stored_a)]
    entry_b, stored_b = _entry_for(b, location="obj")
    entry_b.byte_range = [len(stored_a), len(stored_a) + len(stored_b)]
    plugin = _RestartingFS(str(tmp_path))
    loop.run_until_complete(plugin.write(WriteIO(path="obj", buf=stored_a + stored_b)))
    dst_a, dst_b = torch.zeros(100_000, dtype=torch.int32), torch.zeros(100_000)
    consumer = BatchedBufferConsumer(
        [_consumer(entry_a, dst_a), _consumer(entry_b, dst_b)],
        [tuple(entry_a.byte_range), tuple(entry_b.byte_range)],
    )
    pipeline = S._ReadPipeline(
        ReadReq(path="obj", buffer_consumer=consumer, byte_range=(0, entry_b.byte_range[1])),
        sub_chunk_bytes=SUB,
    )
    assert pipeline.streamed
    window = pipeline.admission_cost_bytes
    assert window < pipeline.cost_bytes
    budget = S._MemoryBudget(1 << 30)
    budget.acquire(window)
    restarts = S.stream_counts["stream_read_restarts"]
    loop.run_until_complete(pipeline.read_and_consume(plugin, None, S._Throughput(), budget))
    assert S.stream_counts["stream_read_restarts"] == restarts + 1
    assert pipeline.admission_cost_bytes == pipeline.cost_bytes
    assert budget.available == (1 << 30) - pipeline.cost_bytes
    assert np.array_equal(dst_a.numpy(), a) and np.array_equal(dst_b.numpy(), b)


# ------------------------------------------------------------- end to end


def _pin_sub(monkeypatch, n: int = SUB) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(n))
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SUB_CHUNK_BYTES", str(n))


def test_restore_streams_and_is_bit_exact(tmp_path, monkeypatch) -> None:
    _pin_sub(monkeypatch, 128 << 10)
    w = torch.arange(500_000, dtype=torch.float32).reshape(500, 1000)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w, small=torch.ones(16, dtype=torch.float64))})
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    reads = S.stream_counts["entries_stream_read"]
    dst = {"w": torch.zeros(500, 1000), "small": torch.zeros(16, dtype=torch.float64)}
    P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(dst)})
    assert S.stream_counts["entries_stream_read"] == reads + 1
    assert torch.equal(dst["w"], w)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "0")
    dst2 = {"w": torch.zeros(500, 1000), "small": torch.zeros(16, dtype=torch.float64)}
    P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(dst2)})
    assert S.stream_counts["entries_stream_read"] == reads + 1
    assert torch.equal(dst2["w"], w)


def test_read_object_streams(tmp_path, monkeypatch) -> None:
    _pin_sub(monkeypatch)
    w = torch.arange(300_000, dtype=torch.int64)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    got = P.Snapshot(str(tmp_path / "s")).read_object("0/app/w")
    assert torch.equal(got, w)


def test_batched_snapshot_restores_through_coalesced_stream(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_ENABLE_BATCHING", "1")
    _pin_sub(monkeypatch)
    state = {f"w{i}": torch.arange(100_000, dtype=torch.float32) + i for i in range(4)}
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(state)})
    assert "batched" in os.listdir(tmp_path / "s")
    reads = S.stream_counts["entries_stream_read"]
    dst = {k: torch.zeros(100_000) for k in state}
    P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(dst)})
    assert S.stream_counts["entries_stream_read"] == reads + 1  # one spanning stream
    assert all(torch.equal(dst[k], state[k]) for k in state)


def test_stream_reads_mode_parsing(monkeypatch) -> None:
    assert S.stream_reads_mode() == "auto"
    for raw in ("0", "false", "off", "never"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", raw)
        assert S.stream_reads_mode() == "never"
    for raw in ("always", "force"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", raw)
        assert S.stream_reads_mode() == "always"
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "1")
    assert S.stream_reads_mode() == "auto"
    for raw in ("0", "auto", "always", "force", "off", "x"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", raw)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_STREAM_READS", raw)
        assert S.stream_reads_mode() == jax_scheduler.stream_reads_mode(), raw


def test_latency_bound_storage_streams_full_retention_consumers(loop, tmp_path, monkeypatch) -> None:
    _pin_sub(monkeypatch)
    calls = {"n": 0}

    class CountingFS(FSStoragePlugin):
        async def read_stream(self, read_io, sub_chunk_bytes):
            calls["n"] += 1
            return await super().read_stream(read_io, sub_chunk_bytes)

    arr = np.arange(300_000, dtype=np.float32)
    entry, stored = _entry_for(arr, location="obj")
    plugin = CountingFS(str(tmp_path))
    loop.run_until_complete(plugin.write(WriteIO(path="obj", buf=stored)))

    def run_restore():
        dst = torch.zeros(300_000)
        loop.run_until_complete(
            S.execute_read_reqs([ReadReq(path="obj", buffer_consumer=_consumer(entry, dst))],
                                plugin, 1 << 30, rank=0)
        )
        assert np.array_equal(dst.numpy(), arr)

    S.io_governor().record_read("CountingFS", 100 << 30, 1.0)
    run_restore()
    assert calls["n"] == 0
    for _ in range(40):
        S.io_governor().record_read("CountingFS", 10 << 20, 1.0)
    run_restore()
    assert calls["n"] == 1


@pytest.mark.parametrize("site", ["fs.pread", pytest.param("fs.native_pread", marks=uring)])
def test_corrupted_sub_chunk_raises_and_leaves_destination(tmp_path, monkeypatch, site) -> None:
    """One corrupted sub-chunk (faultinject) makes the restore raise, and the
    destination keeps its bytes."""
    _pin_sub(monkeypatch)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "always" if site == "fs.native_pread" else "never")
    w = torch.arange(500_000, dtype=torch.float32)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    faultinject.configure(f"{site}@3=corrupt")
    dst = torch.full((500_000,), 5.0)
    with pytest.raises(IntegrityError):
        P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(w=dst)})
    assert faultinject.hits()[site] >= 3
    assert bool((dst == 5.0).all())
    faultinject.disable()
    P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(w=dst)})
    assert torch.equal(dst, w)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chunked_regions_restore_streamed(tmp_path, monkeypatch, writer) -> None:
    """A tensor chunked into several pieces (by either package) restores
    through streamed region fills, bit-exact."""
    from torchsnapshot_tpu.io_preparers import chunked as jchunked
    from torchsnapshot_tpu_torch.io_preparers import chunked as pchunked

    monkeypatch.setattr(jchunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 256 << 10)
    monkeypatch.setattr(pchunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 256 << 10)
    _pin_sub(monkeypatch)
    arr = np.random.default_rng(5).standard_normal((300, 1024)).astype(np.float32)
    path = str(tmp_path / "s")
    if writer == "jax":
        J.Snapshot.take(path, {"app": J.StateDict(w=arr)})
    else:
        P.Snapshot.take(path, {"app": P.StateDict(w=torch.from_numpy(arr.copy()))})
    assert len(P.Snapshot(path).metadata.manifest["0/app/w"].chunks) == 5
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    reads = S.stream_counts["entries_stream_read"]
    dst = torch.zeros(300, 1024)
    P.Snapshot(path).restore({"app": P.StateDict(w=dst)})
    assert S.stream_counts["entries_stream_read"] - reads == 5
    assert np.array_equal(dst.numpy(), arr)


# -------------------------------------------------------------- governor


def test_governor_read_sub_chunk_adapts() -> None:
    gov = S.IOGovernor()
    assert gov.sub_chunk_bytes(op="read") == 64 << 20
    gov.record_read("FSStoragePlugin", 10 << 30, 1.0)
    assert gov.sub_chunk_bytes("FSStoragePlugin", op="read") == 256 << 20
    gov2 = S.IOGovernor()
    gov2.record_write("FSStoragePlugin", 10 << 30, 1.0)
    assert gov2.sub_chunk_bytes("FSStoragePlugin", op="read") == 64 << 20
    gov2.record_read("S3StoragePlugin", 50 << 20, 1.0)
    assert gov2.sub_chunk_bytes("S3StoragePlugin", op="read") == 8 << 20
