"""Streamed writes in the port: mirrors of ``tests/test_streaming_write.py``
(the fs contract, the scheduler's budget and election, the stager, the
governor) on torch tensors, and streamed snapshots held against the JAX
package's byte for byte.

Every test starts from a fresh I/O governor with autotuning off, and pins
``TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES`` where it needs a stream, so rates
learned by one test never change another's elections."""

from __future__ import annotations

import asyncio
import filecmp
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import scheduler as jax_scheduler
from torchsnapshot_tpu_torch import _native, faultinject, native_io
from torchsnapshot_tpu_torch import scheduler as S
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferStager, DeviceStreams
from torchsnapshot_tpu_torch.io_types import (
    STREAM_DEPTH,
    BufferStager,
    StoragePlugin,
    WriteIO,
    WriteReq,
    WriteStream,
)
from torchsnapshot_tpu_torch.manifest import ArrayEntry
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


async def _chunks_of(payload: bytes, n: int):
    for lo in range(0, len(payload), n):
        yield payload[lo : lo + n]


async def _failing_chunks(payload: bytes, n: int, fail_after: int):
    sent = 0
    for lo in range(0, len(payload), n):
        if sent == fail_after:
            raise RuntimeError("injected mid-stream staging failure")
        yield payload[lo : lo + n]
        sent += 1


def _pin_sub(monkeypatch, n: int = SUB) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(n))
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SUB_CHUNK_BYTES", str(n))


# --------------------------------------------------------------- contract


@pytest.mark.parametrize("engine", ["never", pytest.param("always", marks=uring)])
def test_fs_streamed_equals_buffered(tmp_path, loop, monkeypatch, engine) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", engine)
    plugin = FSStoragePlugin(root=str(tmp_path))
    payload = np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    loop.run_until_complete(plugin.write(WriteIO(path="buffered", buf=payload)))
    loop.run_until_complete(
        plugin.write_stream(
            WriteStream(path="a/streamed", nbytes=len(payload), chunks=_chunks_of(payload, 100_000))
        )
    )
    assert (tmp_path / "a" / "streamed").read_bytes() == (tmp_path / "buffered").read_bytes()


@pytest.mark.parametrize("engine", ["never", pytest.param("always", marks=uring)])
def test_fs_streamed_atomic_on_midstream_failure(tmp_path, loop, monkeypatch, engine) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", engine)
    plugin = FSStoragePlugin(root=str(tmp_path))
    payload = bytes(1 << 20)
    with pytest.raises(RuntimeError, match="injected"):
        loop.run_until_complete(
            plugin.write_stream(
                WriteStream(
                    path="dst", nbytes=len(payload),
                    chunks=_failing_chunks(payload, 100_000, fail_after=3),
                )
            )
        )
    assert not (tmp_path / "dst").exists()
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


@pytest.mark.parametrize("engine", ["never", pytest.param("always", marks=uring)])
def test_fs_streamed_short_stream_rejected(tmp_path, loop, monkeypatch, engine) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", engine)
    plugin = FSStoragePlugin(root=str(tmp_path))
    payload = bytes(100_000)
    with pytest.raises(IOError, match="short write stream"):
        loop.run_until_complete(
            plugin.write_stream(
                WriteStream(path="dst", nbytes=len(payload) + 1, chunks=_chunks_of(payload, 30_000))
            )
        )
    assert not (tmp_path / "dst").exists()


def test_fs_pwrite_fault_aborts_the_stream_atomically(tmp_path, loop, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_NATIVE_IO", "never")
    plugin = FSStoragePlugin(root=str(tmp_path))
    payload = bytes(1 << 20)
    faultinject.configure("fs.pwrite@2=permanent")
    with pytest.raises(faultinject.InjectedPermanentError):
        loop.run_until_complete(
            plugin.write_stream(
                WriteStream(path="obj", nbytes=len(payload), chunks=_chunks_of(payload, 100_000))
            )
        )
    assert faultinject.hits() == {"fs.pwrite": 2}
    assert os.listdir(tmp_path) == []


def test_buffered_fallback_plugin(tmp_path, loop) -> None:
    class Plain(StoragePlugin):
        def __init__(self):
            self.writes = {}

        async def write(self, write_io):
            self.writes[write_io.path] = bytes(write_io.buf)

        async def read(self, read_io):
            raise NotImplementedError

        async def delete(self, path):
            pass

        async def close(self):
            pass

    plugin = Plain()
    assert not plugin.supports_streaming and not plugin.supports_streaming_reads
    payload = bytes(range(256)) * 1000
    loop.run_until_complete(
        plugin.write_stream(
            WriteStream(path="obj", nbytes=len(payload), chunks=_chunks_of(payload, 7000))
        )
    )
    assert plugin.writes["obj"] == payload
    with pytest.raises(IOError, match="short write stream"):
        loop.run_until_complete(
            plugin.write_stream(
                WriteStream(path="x", nbytes=len(payload) + 1, chunks=_chunks_of(payload, 7000))
            )
        )


# -------------------------------------------------- scheduler accounting


class StreamingStager(BufferStager):
    """Streams a synthetic payload and tracks the live staged bytes."""

    live_bytes = 0
    peak_bytes = 0

    def __init__(self, total: int, fill: int) -> None:
        self.total = total
        self.fill = fill

    async def stage_buffer(self, executor=None):
        return bytes([self.fill]) * self.total

    def get_staging_cost_bytes(self) -> int:
        return self.total

    def can_stream(self, sub_chunk_bytes: int) -> bool:
        return self.total >= 2 * sub_chunk_bytes

    async def stage_stream(self, executor, sub_chunk_bytes: int):
        cls = StreamingStager
        for lo in range(0, self.total, sub_chunk_bytes):
            n = min(sub_chunk_bytes, self.total - lo)
            cls.live_bytes += n
            cls.peak_bytes = max(cls.peak_bytes, cls.live_bytes)
            await asyncio.sleep(0.001)
            yield bytes([self.fill]) * n
            cls.live_bytes -= n


class CountingStreamFS(FSStoragePlugin):
    stream_calls = 0
    buffered_calls = 0

    async def write_stream(self, stream):
        CountingStreamFS.stream_calls += 1
        await super().write_stream(stream)

    async def write(self, write_io):
        CountingStreamFS.buffered_calls += 1
        await super().write(write_io)


@pytest.fixture
def counters():
    StreamingStager.live_bytes = StreamingStager.peak_bytes = 0
    CountingStreamFS.stream_calls = CountingStreamFS.buffered_calls = 0


def test_streamed_budget_charges_sub_chunks(tmp_path, loop, monkeypatch, counters) -> None:
    """Entries far larger than the budget stream under it: each is charged
    min(size, STREAM_DEPTH x sub-chunk), and the data lands whole."""
    _pin_sub(monkeypatch)
    storage = CountingStreamFS(str(tmp_path))
    total = 1 << 20
    reqs = [WriteReq(path=f"obj_{i}", buffer_stager=StreamingStager(total, i)) for i in range(3)]
    pipelines = [S._WritePipeline(r, SUB, storage) for r in reqs]
    assert all(p.streamed for p in pipelines)
    assert [p.admission_cost_bytes for p in pipelines] == [min(total, STREAM_DEPTH * SUB)] * 3
    small = S._WritePipeline(
        WriteReq(path="s", buffer_stager=StreamingStager(3 * SUB // 2, 0)), SUB // 2, storage
    )
    assert small.streamed and small.admission_cost_bytes == min(3 * SUB // 2, STREAM_DEPTH * SUB // 2)
    budget = 300 << 10  # < one entry; >= one entry's window
    pending = loop.run_until_complete(
        S.execute_write_reqs(reqs, storage, budget, rank=0, allow_streaming=True)
    )
    pending.sync_complete(loop)
    assert CountingStreamFS.stream_calls == 3
    assert StreamingStager.peak_bytes <= budget
    for i in range(3):
        assert (tmp_path / f"obj_{i}").read_bytes() == bytes([i]) * total


def test_streaming_respects_plugin_opt_in(tmp_path, loop, monkeypatch, counters) -> None:
    _pin_sub(monkeypatch)

    class NoStreamFS(CountingStreamFS):
        supports_streaming = False

    storage = NoStreamFS(str(tmp_path))
    reqs = [WriteReq(path="obj", buffer_stager=StreamingStager(1 << 20, 5))]
    pending = loop.run_until_complete(
        S.execute_write_reqs(reqs, storage, 1 << 30, rank=0, allow_streaming=True)
    )
    pending.sync_complete(loop)
    assert CountingStreamFS.stream_calls == 0
    assert CountingStreamFS.buffered_calls == 1
    assert (tmp_path / "obj").read_bytes() == bytes([5]) * (1 << 20)


def test_streaming_off_for_async_path(tmp_path, loop, monkeypatch, counters) -> None:
    _pin_sub(monkeypatch)
    storage = CountingStreamFS(str(tmp_path))
    reqs = [WriteReq(path="obj", buffer_stager=StreamingStager(1 << 20, 9))]
    pending = loop.run_until_complete(
        S.execute_write_reqs(reqs, storage, 1 << 30, rank=0, allow_streaming=False)
    )
    pending.sync_complete(loop)
    assert CountingStreamFS.stream_calls == 0
    assert (tmp_path / "obj").read_bytes() == bytes([9]) * (1 << 20)


def test_streamed_failure_propagates_and_cancels(tmp_path, loop, monkeypatch, counters) -> None:
    _pin_sub(monkeypatch)

    class FailingStager(StreamingStager):
        async def stage_stream(self, executor, sub_chunk_bytes):
            yield b"x" * sub_chunk_bytes
            raise RuntimeError("injected staging failure")

    storage = CountingStreamFS(str(tmp_path))
    reqs = [
        WriteReq(path="bad", buffer_stager=FailingStager(1 << 20, 0)),
        WriteReq(path="good", buffer_stager=StreamingStager(1 << 20, 1)),
    ]
    with pytest.raises(RuntimeError, match="injected staging failure"):
        pending = loop.run_until_complete(
            S.execute_write_reqs(reqs, storage, 1 << 30, rank=0, allow_streaming=True)
        )
        pending.sync_complete(loop)
    assert not (tmp_path / "bad").exists()


def test_streams_and_buffered_writes_share_one_cap(tmp_path, loop, monkeypatch, counters) -> None:
    """With an I/O concurrency of 1, a stream and a buffered write never
    run at once."""
    _pin_sub(monkeypatch)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_IO_CONCURRENCY", "1")
    active = {"now": 0, "peak": 0}

    class Tracking(FSStoragePlugin):
        async def _track(self, coro):
            active["now"] += 1
            active["peak"] = max(active["peak"], active["now"])
            try:
                await asyncio.sleep(0.002)
                await coro
            finally:
                active["now"] -= 1

        async def write_stream(self, stream):
            await self._track(super().write_stream(stream))

        async def write(self, write_io):
            await self._track(super().write(write_io))

    class Small(StreamingStager):
        def can_stream(self, sub_chunk_bytes):
            return False

    storage = Tracking(str(tmp_path))
    reqs = [WriteReq(path=f"s{i}", buffer_stager=StreamingStager(1 << 20, i)) for i in range(2)]
    reqs += [WriteReq(path=f"b{i}", buffer_stager=Small(1000, i)) for i in range(3)]
    S.sync_execute_write_reqs(reqs, storage, 1 << 30, 0, loop)
    assert active["peak"] == 1
    assert sorted(os.listdir(tmp_path)) == ["b0", "b1", "b2", "s0", "s1"]


# ------------------------------------------------------------ end to end


def _checksums(snapshot_path: str) -> dict:
    found = {}
    for entry in P.Snapshot(snapshot_path).metadata.manifest.values():
        for chunk in getattr(entry, "chunks", None) or []:
            found[chunk.array.location] = chunk.array.checksum
    return found


def _state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((500, 1000)).astype(np.float32),
        "emb": rng.integers(-(2**40), 2**40, (300, 512), dtype=np.int64),
        "small": np.ones(16, np.float64),
    }


def _torch_state(arrays: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def test_take_streams_and_roundtrips(tmp_path, monkeypatch) -> None:
    """A blocking take streams large plain entries; their checksums equal
    a buffered take's and verify on restore."""
    _pin_sub(monkeypatch, 128 << 10)
    state = _torch_state(_state())
    before = S.stream_counts["entries_streamed"]
    P.Snapshot.take(str(tmp_path / "streamed"), {"app": P.StateDict(state)})
    assert S.stream_counts["entries_streamed"] - before == 2  # w and emb
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_WRITES", "0")
    P.Snapshot.take(str(tmp_path / "buffered"), {"app": P.StateDict(state)})
    assert S.stream_counts["entries_streamed"] - before == 2
    streamed, buffered = _checksums(str(tmp_path / "streamed")), _checksums(str(tmp_path / "buffered"))
    assert streamed and streamed == buffered
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_STREAM_WRITES")
    dst = {k: torch.zeros_like(v) for k, v in state.items()}
    P.Snapshot(str(tmp_path / "streamed")).restore({"app": P.StateDict(dst)})
    assert all(torch.equal(dst[k], state[k]) for k in state)


def test_stream_kill_switch(monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_WRITES", "0")
    entry = ArrayEntry("x", "buffer_protocol", "uint8", [1 << 20], False)
    stager = ArrayBufferStager(torch.ones(1 << 20, dtype=torch.uint8), entry, DeviceStreams(), False)
    assert not stager.can_stream(SUB)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_WRITES", "1")
    assert stager.can_stream(SUB)


def _stager(t: torch.Tensor, copy_cpu: bool = False) -> ArrayBufferStager:
    from torchsnapshot_tpu_torch.serialization import dtype_to_string

    entry = ArrayEntry("x", "buffer_protocol", dtype_to_string(t.dtype), list(t.shape), False)
    return ArrayBufferStager(t, entry, DeviceStreams(), copy_cpu)


async def _drain(stager, sub, mutate=None):
    parts = []
    with ThreadPoolExecutor(2) as pool:
        async for chunk in stager.stage_stream(pool, sub):
            parts.append(chunk)
            if mutate is not None:
                mutate()
    return parts


@pytest.mark.parametrize("native", [True, False], ids=["crc32c", "zlib-crc32"])
@pytest.mark.parametrize(
    "dtype", [torch.int32, torch.bfloat16, torch.float64, torch.uint8, torch.bool]
)
def test_stager_streamed_bytes_match_buffered(loop, monkeypatch, dtype, native) -> None:
    """The concatenated stream is the buffered payload, and the chained
    checksum equals the buffered one bit for bit (CRC32C with the native
    library, zlib CRC32 without it)."""
    if not native:
        monkeypatch.setattr(_native, "_lib", None)
        monkeypatch.setattr(_native, "_load_attempted", True)
    g = torch.Generator().manual_seed(1)
    t = (torch.randn(400, 500, generator=g) * 100).to(dtype)
    stager = _stager(t)
    assert stager.can_stream(100_000)
    parts = loop.run_until_complete(_drain(stager, 100_000))
    assert len(parts) > 1
    streamed = b"".join(bytes(memoryview(p)) for p in parts)
    buffered_stager = _stager(t)
    buffered = loop.run_until_complete(buffered_stager.stage_buffer())
    assert streamed == bytes(memoryview(buffered))
    assert stager.entry.checksum == buffered_stager.entry.checksum
    assert stager.entry.checksum.startswith("crc32c:" if native else "crc32:")


def test_stager_consistency_copy_stream(loop) -> None:
    """With copy_cpu (the async path's mode) the stream copies each
    sub-chunk: changing the source after a chunk was yielded does not
    change the yielded bytes, and the fused copy-and-CRC32C equals the
    buffered checksum."""
    t = torch.zeros(500_000, dtype=torch.uint8)
    stager = _stager(t, copy_cpu=True)

    def mutate():
        t.fill_(255)

    parts = loop.run_until_complete(_drain(stager, 100_000, mutate))
    first = bytes(memoryview(parts[0]))
    assert first == bytes(len(first))
    assert stager.entry.checksum is not None


@pytest.mark.parametrize(
    "why", ["dedup", "codec", "byte_range", "save_dtype", "small", "strided", "empty"]
)
def test_only_the_plain_path_streams(why) -> None:
    from torchsnapshot_tpu_torch.compression import compression_staging
    from torchsnapshot_tpu_torch.dedup import DedupContext, dedup_staging

    t = torch.ones(1 << 20, dtype=torch.uint8)
    if why == "dedup":
        with dedup_staging(DedupContext.recording_only(device_digests=False)):
            stager = _stager(t)
    elif why == "codec":
        with compression_staging("zlib"):
            stager = _stager(t)
    else:
        stager = _stager(
            {"strided": torch.ones(2048, 1024, dtype=torch.uint8)[:, ::2],
             "small": t[: SUB + 1], "empty": t[:0]}.get(why, t)
        )
        if why == "byte_range":
            stager.entry.byte_range = [0, 1 << 20]
        elif why == "save_dtype":
            stager.streamable = False
    assert not stager.can_stream(SUB)
    assert _stager(t).can_stream(SUB)


def test_save_dtype_take_stages_buffered(tmp_path, monkeypatch) -> None:
    _pin_sub(monkeypatch)
    w = torch.arange(500_000, dtype=torch.float32)
    before = S.stream_counts["entries_streamed"]
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w, v=w + 1)},
                    save_dtype={"app/w": "bfloat16"})
    assert S.stream_counts["entries_streamed"] - before == 1  # v only
    dst = {"w": torch.zeros(500_000), "v": torch.zeros(500_000)}
    P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(dst)})
    assert torch.equal(dst["w"], w.to(torch.bfloat16).float()) and torch.equal(dst["v"], w + 1)


def test_async_take_streams_nothing(tmp_path, monkeypatch) -> None:
    _pin_sub(monkeypatch)
    state = _torch_state(_state())
    before = dict(S.stream_counts)
    P.Snapshot.async_take(str(tmp_path / "a"), {"app": P.StateDict(state)}).wait()
    assert dict(S.stream_counts) == before
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(state)})
    assert S.stream_counts["entries_streamed"] > before.get("entries_streamed", 0)
    assert _checksums(str(tmp_path / "a")) == _checksums(str(tmp_path / "s"))


def test_chunked_tensor_streams_within_each_chunk(tmp_path, monkeypatch) -> None:
    """Each 512 MiB chunk of a large tensor (here cut at 256 KiB) streams
    within itself, and the chunks' region fills restore bit-exact."""
    from torchsnapshot_tpu_torch.io_preparers import chunked

    monkeypatch.setattr(chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 256 << 10)
    _pin_sub(monkeypatch)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((256, 1024)).astype(np.float32))
    before = S.stream_counts["entries_streamed"]
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    entry = P.Snapshot(str(tmp_path / "s")).metadata.manifest["0/app/w"]
    assert len(entry.chunks) == 4
    assert S.stream_counts["entries_streamed"] - before == 4
    for mode in ("always", "never"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", mode)
        dst = torch.zeros_like(w)
        P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(w=dst)})
        assert torch.equal(dst, w)


# ----------------------------------------------------- against the JAX package


def _tree_files(root) -> dict:
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            out[os.path.relpath(os.path.join(dp, f), root)] = os.path.join(dp, f)
    return out


@pytest.mark.parametrize("port_streams", [True, False], ids=["port-streamed", "port-buffered"])
@pytest.mark.parametrize("sub", [64 << 10, 300_000])
def test_both_packages_write_identical_streamed_snapshots(tmp_path, monkeypatch, sub, port_streams) -> None:
    """The same state taken streamed by each package with the same pinned
    sub-chunk size gives identical .snapshot_metadata and payload files;
    so does the port with TORCHSNAPSHOT_GPU_STREAM_WRITES=0."""
    _pin_sub(monkeypatch, sub)
    if not port_streams:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_WRITES", "0")
    arrays = _state(7)
    J.Snapshot.take(str(tmp_path / "j"), {"app": J.StateDict(**arrays)})
    P.Snapshot.take(str(tmp_path / "p"), {"app": P.StateDict(_torch_state(arrays))})
    jf, pf = _tree_files(tmp_path / "j"), _tree_files(tmp_path / "p")
    assert sorted(jf) == sorted(pf) and ".snapshot_metadata" in jf
    for name in jf:
        assert filecmp.cmp(jf[name], pf[name], shallow=False), name


@pytest.mark.parametrize("read_mode", ["always", "never"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_streamed_snapshots_restore_across_packages(tmp_path, monkeypatch, writer, read_mode) -> None:
    """A streamed snapshot from either package restores bit-exact into the
    other and into itself, with streamed and with buffered reads."""
    _pin_sub(monkeypatch)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", read_mode)
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_STREAM_READS", read_mode)
    arrays = _state(11)
    path = str(tmp_path / "s")
    if writer == "jax":
        J.Snapshot.take(path, {"app": J.StateDict(**arrays)})
    else:
        P.Snapshot.take(path, {"app": P.StateDict(_torch_state(arrays))})
    reads = S.stream_counts["entries_stream_read"]
    dst = {k: torch.zeros_like(torch.from_numpy(v)) for k, v in arrays.items()}
    P.Snapshot(path).restore({"app": P.StateDict(dst)})
    for k, v in arrays.items():
        assert np.array_equal(dst[k].numpy(), v), k
    assert (S.stream_counts["entries_stream_read"] > reads) == (read_mode == "always")
    jdst = {k: np.zeros_like(v) for k, v in arrays.items()}
    holder = J.StateDict(**jdst)
    J.Snapshot(path).restore({"app": holder})
    for k, v in arrays.items():
        assert np.array_equal(np.asarray(holder[k]), v), k


# -------------------------------------------------------------- governor


def test_governor_sub_chunk_adapts_within_bounds() -> None:
    gov = S.IOGovernor()
    assert gov.sub_chunk_bytes() == 64 << 20
    gov.record_write("FSStoragePlugin", 10 << 30, 1.0)
    assert gov.sub_chunk_bytes("FSStoragePlugin") == 256 << 20
    gov2 = S.IOGovernor()
    gov2.record_write("S3StoragePlugin", 50 << 20, 1.0)
    assert gov2.sub_chunk_bytes("S3StoragePlugin") == 8 << 20
    gov3 = S.IOGovernor()
    gov3.record_write("FSStoragePlugin", 1_000_000_000, 1.0)  # 1 GB/s -> 50 MB
    assert gov3.sub_chunk_bytes("FSStoragePlugin") == (50_000_000 >> 20) << 20
    assert gov3.elections[("sub_chunk.write", "FSStoragePlugin")] == (47 << 20, "heuristic")


def test_governor_bounds_follow_env(monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_MIN_BYTES", str(16 << 20))
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_MAX_BYTES", str(32 << 20))
    gov = S.IOGovernor()
    gov.record_write("A", 10 << 30, 1.0)
    gov.record_write("B", 1 << 20, 1.0)
    assert gov.sub_chunk_bytes("A") == 32 << 20 and gov.sub_chunk_bytes("B") == 16 << 20
    jgov = jax_scheduler.IOGovernor()
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SUB_CHUNK_MIN_BYTES", str(16 << 20))
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SUB_CHUNK_MAX_BYTES", str(32 << 20))
    for bps in (1 << 20, 300 << 20, 700 << 20, 10 << 30):
        gov, jgov = S.IOGovernor(), jax_scheduler.IOGovernor()
        gov.record_write("X", bps, 1.0)
        jgov.record_write("X", bps, 1.0)
        assert gov.sub_chunk_bytes("X") == jgov.sub_chunk_bytes("X")


def test_governor_env_pin_wins(monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(32 << 20))
    gov = S.IOGovernor()
    gov.record_write("FSStoragePlugin", 10 << 30, 1.0)
    assert gov.sub_chunk_bytes("FSStoragePlugin") == 32 << 20
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_IO_CONCURRENCY", "3")
    assert gov.io_concurrency() == 3


def test_governor_preverify_gate(monkeypatch) -> None:
    gov = S.IOGovernor()
    assert gov.should_preverify()
    gov.record_read("S3StoragePlugin", 50 << 20, 1.0)
    gov.record_hash(2 << 30, 1.0)
    assert gov.should_preverify()
    gov2 = S.IOGovernor()
    gov2.record_read("FSStoragePlugin", 6 << 30, 1.0)
    gov2.record_hash(1 << 30, 1.0)
    assert not gov2.should_preverify()
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PREVERIFY", "always")
    assert gov2.should_preverify()
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PREVERIFY", "never")
    assert not gov.should_preverify()


def test_scheduler_records_rates(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(100_000))})
    rates = S.io_governor().measured_rates()
    assert rates["write_bps"].get("FSStoragePlugin", 0) > 0
    assert rates["hash_bps"] is None
