"""The port's budgeted read_object against the JAX package's.

``read_object(path, obj_out, memory_budget_bytes=)`` reads a tensor entry
in byte ranges of at most the budget, each into its flat slice of the
destination. Every budget from one element to more than the entry must
give the exact bytes of an unbudgeted read, and the same as the JAX
package's read of the same snapshot, written by either package: chunked
entries (each 512 MiB chunk splits again; the chunk size is shrunk here),
a compressed entry (read whole, budget or not), strided and cast
destinations, streamed ranges, and incremental snapshots whose entries
live in a base (``tests/test_incremental.py:116``). As in the JAX package
a budgeted range is not verified against the entry's checksum.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.io_preparers import array as A
from torchsnapshot_tpu_torch.io_preparers import chunked as C
from torchsnapshot_tpu_torch.scheduler import reset_io_governor
from torch_test_env import autotune_never  # noqa: F401 - autouse

SHAPE = (37, 11)  # 407 f32 elements, 1628 bytes: no budget divides it
NBYTES = 37 * 11 * 4


@pytest.fixture(autouse=True)
def _fresh_governor():
    reset_io_governor()
    yield
    reset_io_governor()


def _values(dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(SHAPE).astype(dtype)


def _take(writer: str, path: str, **kwargs) -> None:
    w = _values()
    if writer == "jax":
        J.Snapshot.take(path, {"app": J.StateDict(w=w)}, **kwargs)
    else:
        P.Snapshot.take(path, {"app": P.StateDict(w=torch.from_numpy(w))}, **kwargs)


def _count_ranges(monkeypatch) -> list:
    """Records each planned read's byte range."""
    seen = []
    real = A._SlicedArrayConsumer.__init__

    def init(self, entry, assembler, lo, hi):
        seen.append((lo, hi))
        real(self, entry, assembler, lo, hi)

    monkeypatch.setattr(A._SlicedArrayConsumer, "__init__", init)
    return seen


@pytest.mark.parametrize(
    "budget", [1, 4, 12, 100, 1024, NBYTES - 4, NBYTES, NBYTES + 1, 1 << 30]
)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_every_budget_reads_the_exact_bytes(tmp_path, monkeypatch, writer, budget) -> None:
    path = str(tmp_path / "snap")
    _take(writer, path)
    ranges = _count_ranges(monkeypatch)
    whole = P.Snapshot(path).read_object("0/app/w")
    got = P.Snapshot(path).read_object("0/app/w", memory_budget_bytes=budget)
    into = torch.zeros(SHAPE)
    out = P.Snapshot(path).read_object("0/app/w", obj_out=into, memory_budget_bytes=budget)
    want = J.Snapshot(path).read_object("0/app/w", memory_budget_bytes=budget)
    assert out is into
    for t in (whole, got, into):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), np.asarray(want))
    assert np.array_equal(np.asarray(want), _values())
    per_range = max(1, budget // 4)
    n = -(-SHAPE[0] * SHAPE[1] // per_range)
    assert len(ranges) == 2 * n and all(hi - lo <= per_range for lo, hi in ranges)


@pytest.mark.parametrize("budget", [4, 200, 1 << 20])
def test_chunked_entries_split_each_chunk_under_the_budget(tmp_path, monkeypatch, budget) -> None:
    monkeypatch.setattr(C, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 11 * 4 * 5)  # 5 rows a chunk
    path = str(tmp_path / "snap")
    _take("port", path)
    entry = P.Snapshot(path).get_manifest()["0/app/w"]
    assert len(entry.chunks) == 8
    ranges = _count_ranges(monkeypatch)
    got = P.Snapshot(path).read_object("0/app/w", memory_budget_bytes=budget)
    assert np.array_equal(got.numpy(), _values())
    assert np.array_equal(np.asarray(J.Snapshot(path).read_object(
        "0/app/w", memory_budget_bytes=budget)), _values())
    assert all((hi - lo) * 4 <= max(4, budget) for lo, hi in ranges)
    assert len(ranges) >= 8


def test_a_compressed_entry_reads_whole(tmp_path, monkeypatch) -> None:
    path = str(tmp_path / "snap")
    w = np.zeros((256, 64), np.float32)  # compressible
    P.Snapshot.take(path, {"app": P.StateDict(w=torch.from_numpy(w))}, compression="zlib")
    entry = P.Snapshot(path).get_manifest()["0/app/w"]
    assert entry.chunks[0].array.codec.startswith("zlib")
    ranges = _count_ranges(monkeypatch)
    got = P.Snapshot(path).read_object("0/app/w", memory_budget_bytes=64)
    assert ranges == [] and np.array_equal(got.numpy(), w)
    reqs = A.ArrayIOPreparer.prepare_read(entry.chunks[0].array, None, None, A.DeviceStreams(), 64)
    assert len(reqs) == 1 and isinstance(reqs[0].buffer_consumer, A.ArrayBufferConsumer)
    assert np.array_equal(np.asarray(J.Snapshot(path).read_object(
        "0/app/w", memory_budget_bytes=64)), w)


@pytest.mark.parametrize("budget", [4, 160])
def test_strided_and_cast_destinations(tmp_path, budget) -> None:
    path = str(tmp_path / "snap")
    _take("port", path)
    strided = torch.zeros((SHAPE[1], SHAPE[0])).T  # not contiguous
    P.Snapshot(path).read_object("0/app/w", obj_out=strided, memory_budget_bytes=budget)
    assert np.array_equal(strided.numpy(), _values())
    wider = torch.zeros(SHAPE, dtype=torch.float64)  # a same-kind cast
    P.Snapshot(path).read_object("0/app/w", obj_out=wider, memory_budget_bytes=budget)
    assert np.array_equal(wider.numpy(), _values().astype(np.float64))


def test_streamed_ranges_fill_in_place(tmp_path, monkeypatch) -> None:
    """With streamed reads forced and a small sub-chunk, each range larger
    than two sub-chunks is filled as its sub-chunks arrive."""
    from torchsnapshot_tpu_torch.scheduler import stream_counts

    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", "4096")
    path = str(tmp_path / "snap")
    w = np.random.default_rng(1).standard_normal((64, 1024)).astype(np.float32)  # 256 KiB
    P.Snapshot.take(path, {"app": P.StateDict(w=torch.from_numpy(w))})
    before = stream_counts["entries_stream_read"]
    got = P.Snapshot(path).read_object("0/app/w", memory_budget_bytes=64 << 10)
    assert np.array_equal(got.numpy(), w)
    assert stream_counts["entries_stream_read"] - before == 4


def test_a_budgeted_read_is_not_verified_as_in_the_jax_package(tmp_path) -> None:
    """A byte flipped in the payload: the whole-entry read raises, a
    budgeted one returns the flipped bytes in both packages (no range
    carries a checksum)."""
    path = str(tmp_path / "snap")
    _take("port", path)
    payload = os.path.join(path, "0", "app", "w_0_0")
    data = bytearray(open(payload, "rb").read())
    data[40] ^= 0xFF
    open(payload, "wb").write(bytes(data))
    with pytest.raises(Exception, match="(?i)checksum|integrity"):
        P.Snapshot(path).read_object("0/app/w")
    got = P.Snapshot(path).read_object("0/app/w", memory_budget_bytes=256)
    want = J.Snapshot(path).read_object("0/app/w", memory_budget_bytes=256)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), _values())


@pytest.mark.parametrize("budget", [None, 16])
def test_read_object_follows_origin(tmp_path, budget) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    frozen = torch.full((64, 8), 1.0)
    P.Snapshot.take(base, {"app": P.StateDict(frozen=frozen, t=torch.zeros(16, 4))},
                    record_digests=True)
    P.Snapshot.take(inc, {"app": P.StateDict(frozen=frozen, t=torch.full((16, 4), 4.0))},
                    incremental_base=base)
    v = P.Snapshot(inc).read_object("0/app/frozen", memory_budget_bytes=budget)
    assert torch.equal(v, frozen)
    assert np.array_equal(np.asarray(J.Snapshot(inc).read_object(
        "0/app/frozen", memory_budget_bytes=budget)), frozen.numpy())


def test_bf16_and_int_entries_under_a_budget(tmp_path) -> None:
    path = str(tmp_path / "snap")
    bf = torch.from_numpy(_values()).to(torch.bfloat16)
    ids = torch.arange(1000, dtype=torch.int64)
    P.Snapshot.take(path, {"app": P.StateDict(bf=bf, ids=ids)})
    got_bf = P.Snapshot(path).read_object("0/app/bf", memory_budget_bytes=6)
    got_ids = P.Snapshot(path).read_object("0/app/ids", memory_budget_bytes=24)
    assert got_bf.dtype == torch.bfloat16 and torch.equal(got_bf.view(torch.int16), bf.view(torch.int16))
    assert torch.equal(got_ids, ids)
    want = np.asarray(J.Snapshot(path).read_object("0/app/bf", memory_budget_bytes=6))
    assert want.tobytes() == got_bf.view(torch.int16).numpy().tobytes()
