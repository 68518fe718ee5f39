"""Streaming on the card: the side-stream DtoH ring of a streamed take, and
the device sink (a scratch buffer on the device, committed to the
destination only after the payload verified) of a streamed restore.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_streaming_cuda.py
"""

from __future__ import annotations

import asyncio
import gc
import os
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import scheduler as S
from torchsnapshot_tpu_torch.integrity import IntegrityError, compute_checksum
from torchsnapshot_tpu_torch.io_preparers import array as A
from torchsnapshot_tpu_torch.io_types import STREAM_DEPTH, ReadReq, ReadStream, WriteIO
from torchsnapshot_tpu_torch.manifest import ArrayEntry
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda

SUB = 1 << 20


@pytest.fixture()
def card(monkeypatch) -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("TORCHSNAPSHOT_GPU_STREAM_READS", "TORCHSNAPSHOT_GPU_STREAM_WRITES",
                 "TORCHSNAPSHOT_GPU_NATIVE_IO"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_AUTOTUNE", "never")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(SUB))
    S.reset_io_governor()
    yield torch.device("cuda")
    S.reset_io_governor()


@pytest.fixture()
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def _entry(t: torch.Tensor) -> ArrayEntry:
    from torchsnapshot_tpu_torch.serialization import dtype_to_string

    return ArrayEntry("x", "buffer_protocol", dtype_to_string(t.dtype), list(t.shape), False)


def test_side_stream_dtoh_ring(card, loop) -> None:
    """A CUDA tensor streams as byte ranges of its flat view, each landed
    in a registered slab; the bytes and the chained checksum equal the
    buffered take's, and the stream draws at most STREAM_DEPTH + 1 slabs."""
    g = torch.Generator(device=card).manual_seed(0)
    t = torch.randn(4 << 20, generator=g, device=card)  # 16 MiB
    stager = A.ArrayBufferStager(t, _entry(t), A.DeviceStreams(), False)
    assert stager.can_stream(SUB)
    gc.collect()
    A._staging_pool.reset_peak()
    base = A._staging_pool.outstanding_bytes

    async def drain():
        out = bytearray()
        pinned = []
        with ThreadPoolExecutor(2) as pool:
            async for chunk in stager.stage_stream(pool, SUB):
                out += bytes(chunk)
                pinned.append(torch.frombuffer(chunk, dtype=torch.uint8).is_pinned())
                del chunk
        return bytes(out), pinned

    streamed, pinned = loop.run_until_complete(drain())
    assert all(pinned) and len(pinned) == 16
    assert A._staging_pool.peak_bytes - base <= (STREAM_DEPTH + 1) * SUB
    buffered = A.ArrayBufferStager(t, _entry(t), A.DeviceStreams(), False)
    host = loop.run_until_complete(buffered.stage_buffer())
    assert streamed == bytes(memoryview(host))
    assert stager.entry.checksum == buffered.entry.checksum == compute_checksum(streamed)


def _stream_of(data: bytes, sub: int, corrupt_at=None):
    buf = bytearray(data)
    if corrupt_at is not None:
        buf[corrupt_at] ^= 0xFF

    async def chunks():
        for lo in range(0, len(buf), sub):
            slab = A.pooled_buffer(min(sub, len(buf) - lo))
            slab.numpy()[:] = memoryview(buf)[lo : lo + slab.numel()]
            yield memoryview(slab.numpy())

    return ReadStream(path="x", nbytes=len(buf), chunks=chunks())


@pytest.mark.parametrize("corrupt", [False, True])
def test_device_sink_verifies_before_it_commits(card, loop, corrupt) -> None:
    """The device sink copies each sub-chunk into a device scratch buffer;
    the destination changes only after the payload verified, and a
    corrupted sub-chunk raises with the destination as it was."""
    src = torch.arange(3 << 20, dtype=torch.int32)
    data = bytes(memoryview(src.numpy()))
    entry = _entry(src)
    entry.checksum = compute_checksum(data)
    dst = torch.full((3 << 20,), -1, dtype=torch.int32, device=card)
    consumer = A.ArrayBufferConsumer(entry, dst, None, A.DeviceStreams())
    assert consumer.can_stream(SUB)
    assert consumer.stream_admission_cost(SUB) == (STREAM_DEPTH + 1) * SUB
    assert not consumer.streams_on_fast_storage()
    pipeline = S._ReadPipeline(ReadReq(path="x", buffer_consumer=consumer), sub_chunk_bytes=SUB)
    assert not pipeline.streamed  # auto on unmeasured storage: buffered
    pipeline = S._ReadPipeline(
        ReadReq(path="x", buffer_consumer=consumer), sub_chunk_bytes=SUB, stream_all=True
    )
    assert pipeline.streamed and pipeline.admission_cost_bytes == (STREAM_DEPTH + 1) * SUB
    stream = _stream_of(data, SUB, corrupt_at=5_000_000 if corrupt else None)
    if corrupt:
        with pytest.raises(IntegrityError):
            loop.run_until_complete(consumer.consume_stream(stream))
        torch.cuda.synchronize()
        assert bool((dst == -1).all())
    else:
        loop.run_until_complete(consumer.consume_stream(stream))
        torch.cuda.synchronize()
        assert torch.equal(dst.cpu(), src)


def test_streamed_take_and_restore_on_the_card(card, tmp_path, monkeypatch) -> None:
    g = torch.Generator(device=card).manual_seed(1)
    state = {"w": torch.randn(1024, 2048, generator=g, device=card),
             "b": torch.randn(4096, generator=g, device=card).to(torch.bfloat16)}
    before = dict(S.stream_counts)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(state)})
    assert S.stream_counts["entries_streamed"] == before.get("entries_streamed", 0) + 1
    os.environ["TORCHSNAPSHOT_GPU_STREAM_WRITES"] = "0"
    try:
        P.Snapshot.take(str(tmp_path / "b"), {"app": P.StateDict(state)})
    finally:
        del os.environ["TORCHSNAPSHOT_GPU_STREAM_WRITES"]
    for name in (".snapshot_metadata", "0/app/w_0_0"):
        assert (tmp_path / "s" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    dst = {k: torch.zeros_like(v) for k, v in state.items()}
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(dst)})
    torch.cuda.synchronize()
    assert S.stream_counts["entries_stream_read"] == before.get("entries_stream_read", 0) + 1
    assert all(torch.equal(dst[k], state[k]) for k in state)


def test_large_entries_restore_concurrently_under_budget(card, loop, tmp_path, monkeypatch) -> None:
    """Two entries each larger than the budget stream at once: the device
    sinks are charged their windows, not the payloads."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    active = {"now": 0, "peak": 0}

    class TrackingFS(FSStoragePlugin):
        async def read_stream(self, read_io, sub_chunk_bytes):
            inner = await super().read_stream(read_io, sub_chunk_bytes)

            async def chunks():
                active["now"] += 1
                active["peak"] = max(active["peak"], active["now"])
                try:
                    async for chunk in inner.chunks:
                        await asyncio.sleep(0)
                        yield chunk
                finally:
                    active["now"] -= 1

            return ReadStream(path=inner.path, nbytes=inner.nbytes, chunks=chunks())

    plugin = TrackingFS(str(tmp_path))
    reqs, dsts, srcs = [], [], []
    for i in range(2):
        src = torch.full((2 << 20,), float(i))  # 8 MiB each
        entry = _entry(src)
        entry.location = f"obj_{i}"
        data = bytes(memoryview(src.numpy()))
        entry.checksum = compute_checksum(data)
        loop.run_until_complete(plugin.write(WriteIO(path=f"obj_{i}", buf=data)))
        dst = torch.zeros(2 << 20, device=card)
        reqs.append(ReadReq(path=f"obj_{i}",
                            buffer_consumer=A.ArrayBufferConsumer(entry, dst, None, A.DeviceStreams())))
        dsts.append(dst)
        srcs.append(src)
    budget = 7 << 20  # under one payload; two 3-sub-chunk windows fit
    loop.run_until_complete(S.execute_read_reqs(reqs, plugin, budget, rank=0))
    torch.cuda.synchronize()
    assert active["peak"] == 2
    assert all(torch.equal(d.cpu(), s) for d, s in zip(dsts, srcs))
