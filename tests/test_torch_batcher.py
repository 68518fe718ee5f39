"""Write batching and read merging in the port: mirrors of
``tests/test_batcher.py`` on torch tensors, and batched snapshots across
the two packages, bit-exact in both directions (with and without
compression)."""

from __future__ import annotations

import asyncio
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import batcher
from torchsnapshot_tpu_torch.batcher import (
    BatchedBufferConsumer,
    BatchedBufferStager,
    batch_read_requests,
    batch_write_requests,
)
from torchsnapshot_tpu_torch.io_preparers import DeviceStreams
from torchsnapshot_tpu_torch.io_preparers.chunked import ChunkedArrayIOPreparer
from torchsnapshot_tpu_torch.io_types import ReadReq
from torchsnapshot_tpu_torch.serialization import string_to_dtype
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture()
def batching(monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_ENABLE_BATCHING", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_ENABLE_BATCHING", "1")


def _prepare(tensors):
    entries, reqs = [], []
    for i, t in enumerate(tensors):
        entry, wr = ChunkedArrayIOPreparer.prepare_write(f"0/m/p{i}", t, DeviceStreams(), False)
        entries.append(entry)
        reqs.extend(wr)
    return entries, reqs


def _files(root):
    return [
        os.path.relpath(os.path.join(dp, f), root)
        for dp, _, fs in os.walk(root)
        for f in fs
        if f != ".snapshot_metadata"
    ]


def test_batch_write_packs_small_arrays() -> None:
    entries, reqs = _prepare([torch.full((10, 10), float(i)) for i in range(8)])
    entries, batched = batch_write_requests(entries, reqs)
    assert len(batched) == 1 and batched[0].path.startswith("batched/")
    assert isinstance(batched[0].buffer_stager, BatchedBufferStager)
    subs = [e.chunks[0].array for e in entries]
    assert [s.byte_range for s in subs] == [[400 * i, 400 * (i + 1)] for i in range(8)]
    assert len({s.location for s in subs}) == 1


def test_large_and_lone_writes_are_not_batched(monkeypatch) -> None:
    monkeypatch.setattr(batcher, "_SLAB_SIZE_THRESHOLD_BYTES", 1000)
    entries, reqs = _prepare([torch.zeros(300), torch.zeros(10), torch.zeros(20)])
    entries, out = batch_write_requests(entries, reqs)
    # 1200 B is over the slab size; 40 + 80 B share one slab.
    assert sorted(r.path.split("/")[0] for r in out) == ["0", "batched"]
    entries, reqs = _prepare([torch.zeros(10)])
    assert batch_write_requests(entries, reqs)[1] == reqs


def test_batched_stager_packs_with_gather_copy(monkeypatch) -> None:
    calls = []
    real = batcher.gather_copy
    monkeypatch.setattr(batcher, "gather_copy", lambda dst, srcs: (calls.append(len(srcs)), real(dst, srcs)))
    tensors = [torch.arange(16, dtype=torch.int32) + 100 * i for i in range(5)]
    entries, reqs = _prepare(tensors)
    _, (req,) = batch_write_requests(entries, reqs)
    slab = asyncio.run(req.buffer_stager.stage_buffer())
    assert calls == [5]
    assert bytes(slab) == b"".join(t.numpy().tobytes() for t in tensors)
    assert req.buffer_stager.get_staging_cost_bytes() == 2 * len(slab)


def test_batched_roundtrip_through_stack(tmp_path, batching) -> None:
    rng = np.random.default_rng(0)
    arrs = {f"p{i}": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)) for i in range(6)}
    P.Snapshot.take(str(tmp_path / "snap"), {"m": P.StateDict(**arrs)})
    files = _files(tmp_path / "snap")
    assert len(files) == 1 and files[0].startswith("batched/")
    dst = P.StateDict(**{k: torch.zeros(32, 32) for k in arrs})
    P.Snapshot(str(tmp_path / "snap")).restore({"m": dst})
    for k, v in arrs.items():
        assert torch.equal(dst[k], v)


def test_batched_restore_merges_into_one_read(tmp_path, batching, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    arrs = {f"p{i}": torch.full((8, 8), float(i)) for i in range(5)}
    P.Snapshot.take(str(tmp_path / "snap"), {"m": P.StateDict(**arrs)})
    reads = []
    real = FSStoragePlugin.read

    async def spy(self, read_io):
        reads.append((read_io.path, read_io.byte_range))
        return await real(self, read_io)

    monkeypatch.setattr(FSStoragePlugin, "read", spy)
    dst = P.StateDict(**{k: torch.zeros(8, 8) for k in arrs})
    P.Snapshot(str(tmp_path / "snap")).restore({"m": dst})
    payload_reads = [r for r in reads if r[0] != ".snapshot_metadata"]
    assert len(payload_reads) == 1 and payload_reads[0][1] == (0, 5 * 256)
    assert all(torch.equal(dst[k], v) for k, v in arrs.items())


def test_batched_read_object(tmp_path, batching) -> None:
    arrs = {f"p{i}": torch.full((4, 4), i, dtype=torch.int32) for i in range(4)}
    snap = P.Snapshot.take(str(tmp_path / "snap"), {"m": P.StateDict(**arrs)})
    assert torch.equal(snap.read_object("0/m/p2"), arrs["p2"])


def test_replicated_entries_not_batched(tmp_path, batching) -> None:
    arrs = {f"p{i}": torch.ones(8, 8) for i in range(4)}
    snap = P.Snapshot.take(str(tmp_path / "snap"), {"m": P.StateDict(**arrs)}, replicated=["m/*"])
    manifest = snap.get_manifest()
    for i in range(4):
        assert manifest[f"0/m/p{i}"].chunks[0].array.location.startswith("replicated/")


def test_batched_async_take_is_consistent_at_return(tmp_path, batching) -> None:
    arrs = {f"p{i}": torch.arange(64, dtype=torch.float32) + i for i in range(4)}
    before = {k: v.clone() for k, v in arrs.items()}
    pending = P.Snapshot.async_take(str(tmp_path / "snap"), {"m": P.StateDict(**arrs)})
    for v in arrs.values():
        v.mul_(-1)
    pending.wait()
    dst = P.StateDict(**{k: torch.zeros(64) for k in arrs})
    P.Snapshot(str(tmp_path / "snap")).restore({"m": dst})
    assert all(torch.equal(dst[k], v) for k, v in before.items())


class _Rec:
    def __init__(self, consumed, key, cost) -> None:
        self.consumed, self.key, self.cost = consumed, key, cost

    async def consume_buffer(self, buf, executor=None) -> None:
        self.consumed[self.key] = bytes(buf)

    def get_consuming_cost_bytes(self) -> int:
        return self.cost


def test_batch_read_requests_merges_adjacent() -> None:
    consumed = {}
    reqs = [
        ReadReq("f", _Rec(consumed, "a", 10), byte_range=(0, 10)),
        ReadReq("f", _Rec(consumed, "b", 10), byte_range=(10, 20)),
        ReadReq("f", _Rec(consumed, "c", 5), byte_range=(20, 25)),
        ReadReq("g", _Rec(consumed, "d", 5), byte_range=(0, 5)),
        ReadReq("h", _Rec(consumed, "e", 3)),
        ReadReq("f", _Rec(consumed, "x", 5), byte_range=(0, 5), origin="/base"),
    ]
    merged = batch_read_requests(reqs)
    (spanning,) = [r for r in merged if r.path == "f" and r.origin is None]
    assert spanning.byte_range == (0, 25)
    assert isinstance(spanning.buffer_consumer, BatchedBufferConsumer)
    assert spanning.buffer_consumer.get_consuming_cost_bytes() == 25
    assert len(merged) == 4  # g, h and the other origin's f untouched
    asyncio.run(spanning.buffer_consumer.consume_buffer(bytes(range(25))))
    assert consumed == {"a": bytes(range(10)), "b": bytes(range(10, 20)), "c": bytes(range(20, 25))}


def test_batch_read_requests_respects_gap() -> None:
    far = 100 * 1024 * 1024
    reqs = [
        ReadReq("f", _Rec({}, "a", 1), byte_range=(0, 10)),
        ReadReq("f", _Rec({}, "b", 1), byte_range=(far, far + 10)),
    ]
    assert len(batch_read_requests(reqs)) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_batching_dtype_matrix(tmp_path, batching, dtype) -> None:
    rng = np.random.default_rng(3)
    arrs = {
        f"p{i}": torch.from_numpy(rng.integers(0, 256, 16 * 4 * 4, dtype=np.uint8))
        .view(string_to_dtype(dtype))[: 16 * 4]
        .reshape(16, 4)
        .clone()
        for i in range(3)
    }
    P.Snapshot.take(str(tmp_path / "snap"), {"m": P.StateDict(**arrs)})
    dst = P.StateDict(**{k: torch.zeros_like(v) for k, v in arrs.items()})
    P.Snapshot(str(tmp_path / "snap")).restore({"m": dst})
    for k, v in arrs.items():
        assert torch.equal(dst[k].view(torch.uint8), v.view(torch.uint8))


# -------------------------------------------------------- across packages


def _arrays(rng):
    return {f"p{i}": rng.standard_normal((48, 16)).astype(np.float32) for i in range(5)} | {
        "big": np.arange(40_000, dtype=np.float32)
    }


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_jax_batched_take_restores_in_port(tmp_path, batching, codec) -> None:
    arrs = _arrays(np.random.default_rng(4))
    J.Snapshot.take(
        str(tmp_path / "s"),
        {"m": J.StateDict(**{k: jnp.asarray(v) for k, v in arrs.items()}, step=2)},
        compression=codec,
    )
    assert all(f.startswith("batched/") for f in _files(tmp_path / "s"))
    dst = P.StateDict(**{k: torch.zeros(v.shape) for k, v in arrs.items()}, step=0)
    P.Snapshot(str(tmp_path / "s")).restore({"m": dst})
    for k, v in arrs.items():
        assert np.array_equal(dst[k].numpy(), v), k
    assert dst["step"] == 2


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_port_batched_take_restores_in_jax(tmp_path, batching, codec) -> None:
    arrs = _arrays(np.random.default_rng(5))
    P.Snapshot.take(
        str(tmp_path / "s"),
        {"m": P.StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrs.items()}, step=2)},
        compression=codec,
    )
    assert all(f.startswith("batched/") for f in _files(tmp_path / "s"))
    dst = J.StateDict(**{k: np.zeros(v.shape, np.float32) for k, v in arrs.items()}, step=0)
    J.Snapshot(str(tmp_path / "s")).restore({"m": dst})
    for k, v in arrs.items():
        assert np.array_equal(dst[k], v), k
    assert dst["step"] == 2
