"""Snapshot take/restore in the PyTorch port, on CPU tensors, and snapshot
interchange with the JAX package in both directions, bit-exact."""

from __future__ import annotations

import os
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.io_preparers import chunked as jax_chunked
from torchsnapshot_tpu_torch import serialization as port_ser
from torchsnapshot_tpu_torch.integrity import IntegrityError
from torchsnapshot_tpu_torch.io_preparers import chunked as port_chunked
from torchsnapshot_tpu_torch.snapshot import UNPORTED_ENV_KNOBS

SUBBYTE_RANGES = {"int4": (-8, 8), "uint4": (0, 16), "int2": (-2, 2), "uint2": (0, 4)}


def _raw_bytes(name: str, n: int, rng) -> np.ndarray:
    """n elements' worth of bytes valid for dtype ``name`` in both packages."""
    if name == "bool":
        return rng.integers(0, 2, n, dtype=np.uint8)
    if name in SUBBYTE_RANGES:
        lo, hi = SUBBYTE_RANGES[name]
        return rng.integers(lo, hi, n).astype(np.int8).view(np.uint8)
    itemsize = port_ser.dtype_size_bytes(name)
    return rng.integers(0, 256, n * itemsize, dtype=np.uint8)


def _as_tensor(raw: np.ndarray, name: str, shape) -> torch.Tensor:
    return torch.from_numpy(raw.copy()).view(port_ser.string_to_dtype(name)).reshape(shape)


def _as_numpy(raw: np.ndarray, name: str, shape) -> np.ndarray:
    from torchsnapshot_tpu.serialization import string_to_dtype

    return raw.copy().view(string_to_dtype(name)).reshape(shape)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


SHARED_DTYPES = sorted(port_ser.SUPPORTED_DTYPE_STRINGS & set(J.serialization.STRING_TO_DTYPE))
SHAPE = (6, 5)


@pytest.fixture()
def small_chunks(monkeypatch):
    """Scale the chunk size down so every tensor splits into several chunks."""
    monkeypatch.setattr(port_chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 40)
    monkeypatch.setattr(jax_chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 40)


def _port_state(rng):
    raw = {name: _raw_bytes(name, 30, rng) for name in SHARED_DTYPES}
    tensors = {name: _as_tensor(b, name, SHAPE) for name, b in raw.items()}
    return raw, tensors


def test_port_round_trip_every_dtype_objects_primitives_chunks(tmp_path, small_chunks) -> None:
    rng = np.random.default_rng(0)
    raw, tensors = _port_state(rng)
    extras = dict(
        step=12, lr=0.1 + 0.2, name="run/ä%", flag=True, blob=b"\x00\x01", nothing=None,
        obj={"a", "b"}, nested=[torch.arange(7), (1.5, "x")], scalar=torch.tensor(3.25),
    )
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(tensors=tensors, **extras)})
    manifest = P.Snapshot(str(tmp_path / "s")).get_manifest()
    assert len(manifest["0/app/tensors/float32"].chunks) > 1

    dst_tensors = {n: torch.zeros(SHAPE, dtype=t.dtype) for n, t in tensors.items()}
    dst = P.StateDict(
        tensors=dst_tensors, step=0, lr=0.0, name="", flag=False, blob=b"", nothing=1,
        obj=None, nested=[torch.zeros(7, dtype=torch.int64), (0.0, "")],
        scalar=torch.tensor(0.0),
    )
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    for name, t in dst["tensors"].items():
        assert t is dst_tensors[name]  # restored in place
        assert _tensor_bytes(t) == raw[name].tobytes(), name
    for key, value in extras.items():
        if key in ("nested", "scalar"):
            continue
        assert dst[key] == value, key
    assert torch.equal(dst["nested"][0], torch.arange(7))
    assert dst["nested"][1] == (1.5, "x")
    assert dst["scalar"].item() == 3.25


def test_port_take_jax_restore_bit_exact(tmp_path, small_chunks) -> None:
    rng = np.random.default_rng(1)
    raw, tensors = _port_state(rng)
    floats = torch.from_numpy(rng.standard_normal(SHAPE, dtype=np.float32))
    P.Snapshot.take(
        str(tmp_path / "s"),
        {"app": P.StateDict(tensors=tensors, w=floats, step=3, obj=frozenset({1, 2}))},
    )
    dst_np = {n: np.zeros(SHAPE, dtype=_as_numpy(raw[n], n, SHAPE).dtype) for n in raw}
    dst = J.StateDict(
        tensors=dst_np, w=jnp.zeros(SHAPE, jnp.float32), step=0, obj=None
    )
    J.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    for name, arr in dst["tensors"].items():
        assert np.ascontiguousarray(arr).view(np.uint8).tobytes() == raw[name].tobytes(), name
    assert np.array_equal(np.asarray(dst["w"]), floats.numpy())
    assert dst["step"] == 3 and dst["obj"] == frozenset({1, 2})


def test_jax_take_port_restore_bit_exact(tmp_path, small_chunks) -> None:
    rng = np.random.default_rng(2)
    raw = {name: _raw_bytes(name, 30, rng) for name in SHARED_DTYPES}
    arrays = {n: _as_numpy(b, n, SHAPE) for n, b in raw.items()}
    w = rng.standard_normal(SHAPE, dtype=np.float32)
    J.Snapshot.take(
        str(tmp_path / "s"),
        {
            "app": J.StateDict(
                arrays=arrays,
                w=jnp.asarray(w),
                wb=jnp.asarray(w).astype(jnp.bfloat16),
                step=5,
                obj={("x", 1), ("y", 2)},
            )
        },
    )
    dst = P.StateDict(
        arrays={n: torch.zeros(SHAPE, dtype=port_ser.string_to_dtype(n)) for n in raw},
        w=torch.zeros(SHAPE),
        wb=torch.zeros(SHAPE, dtype=torch.bfloat16),
        step=0,
        obj=None,
    )
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    for name, t in dst["arrays"].items():
        assert _tensor_bytes(t) == raw[name].tobytes(), name
    assert np.array_equal(dst["w"].numpy(), w)
    expected_bf16 = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)).view(np.uint16)
    assert np.array_equal(dst["wb"].view(torch.int16).numpy().view(np.uint16), expected_bf16)
    assert dst["step"] == 5 and dst["obj"] == {("x", 1), ("y", 2)}


@pytest.mark.parametrize("name", sorted(port_ser.TORCH_MISSING_DTYPE_STRINGS))
def test_jax_snapshot_of_a_dtype_torch_lacks_is_refused_by_name(tmp_path, name) -> None:
    if not hasattr(ml_dtypes, name):
        pytest.skip(f"this ml_dtypes build has no {name}")
    arr = np.zeros(4, dtype=getattr(ml_dtypes, name))
    J.Snapshot.take(str(tmp_path / "s"), {"app": J.StateDict(x=arr)})
    with pytest.raises(port_ser.UnsupportedDtypeError, match=name):
        P.Snapshot(str(tmp_path / "s")).restore(
            {"app": P.StateDict(x=torch.zeros(4, dtype=torch.uint8))}
        )


def test_async_take_is_consistent_at_return(tmp_path) -> None:
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 8), dtype=np.float32))
    before = w.clone()
    pending = P.Snapshot.async_take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    w.mul_(-1.0)  # overwrite as soon as async_take returns
    pending.wait()
    dst = P.StateDict(w=torch.zeros(64, 8))
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert torch.equal(dst["w"], before)


def test_metadata_is_written_last(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.storage_plugins import fs

    real_write = fs.FSStoragePlugin.write

    async def failing_write(self, write_io):
        if write_io.path.endswith("b_0"):
            raise OSError("disk gone")
        await real_write(self, write_io)

    monkeypatch.setattr(fs.FSStoragePlugin, "write", failing_write)
    with pytest.raises(OSError, match="disk gone"):
        P.Snapshot.take(
            str(tmp_path / "s"), {"app": P.StateDict(a=torch.ones(4), b=torch.ones(4))}
        )
    assert not os.path.exists(tmp_path / "s" / ".snapshot_metadata")


def test_corrupt_payload_is_detected(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.arange(16.0))})
    payload = tmp_path / "s" / "0" / "app" / "w_0"
    data = bytearray(payload.read_bytes())
    data[5] ^= 0xFF
    payload.write_bytes(bytes(data))
    with pytest.raises(IntegrityError, match="checksum mismatch"):
        P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(w=torch.zeros(16))})


def test_restore_casts_same_kind_only(tmp_path) -> None:
    w = torch.linspace(-2, 2, 12)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    dst = P.StateDict(w=torch.zeros(12, dtype=torch.bfloat16))
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert torch.equal(dst["w"], w.to(torch.bfloat16))
    with pytest.raises(RuntimeError, match="same-kind"):
        P.Snapshot(str(tmp_path / "s")).restore(
            {"app": P.StateDict(w=torch.zeros(12, dtype=torch.int64))}
        )


def test_rng_state_round_trips_and_take_does_not_perturb(tmp_path) -> None:
    torch.manual_seed(4)
    random.seed(4)
    np.random.seed(4)
    P.Snapshot.take(str(tmp_path / "s"), {"rng": P.RNGState()})
    expected = (torch.rand(3), random.random(), np.random.rand())
    torch.manual_seed(99)
    random.seed(99)
    np.random.seed(99)
    P.Snapshot(str(tmp_path / "s")).restore({"rng": P.RNGState()})
    got = (torch.rand(3), random.random(), np.random.rand())
    assert torch.equal(got[0], expected[0]) and got[1:] == expected[1:]


def test_read_object(tmp_path) -> None:
    w = torch.arange(10, dtype=torch.int32)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w, step=2)})
    snap = P.Snapshot(str(tmp_path / "s"))
    assert torch.equal(snap.read_object("0/app/w"), w)
    assert snap.read_object("0/app/step") == 2
    out = torch.zeros(10, dtype=torch.int32)
    assert snap.read_object("0/app/w", obj_out=out) is out and torch.equal(out, w)


@pytest.mark.parametrize("knob", UNPORTED_ENV_KNOBS)
def test_unported_env_knob_raises_by_name(tmp_path, monkeypatch, knob) -> None:
    monkeypatch.setenv(knob, "1")
    with pytest.raises(NotImplementedError, match=knob):
        P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(2))})


def test_unported_env_knob_set_off_is_accepted(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_ENABLE_BATCHING", "0")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "never")
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(2))})


def test_jax_package_knobs_do_not_configure_the_port(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_COMPRESSION", "zstd")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_CHECKSUM", "0")
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(2))})
    entry = P.Snapshot(str(tmp_path / "s")).get_manifest()["0/app/w"].chunks[0].array
    assert entry.codec is None and entry.checksum.startswith("crc32:")


@pytest.mark.parametrize(
    "kwargs",
    [
        {"via": "take", "compression": "zstd"},
        {"via": "async_take", "compression": "zstd"},
        {"via": "CheckpointManager", "compression": "zstd"},
        {"via": "CheckpointManager", "tenant": "team-a"},
        {"via": "take", "compression": "zlib:1"},
    ],
)
def test_unported_argument_raises_by_name(tmp_path, kwargs) -> None:
    kwargs = dict(kwargs)
    via = kwargs.pop("via")
    (name,) = kwargs
    state = {"app": P.StateDict(w=torch.ones(2))}
    with pytest.raises(NotImplementedError, match=name):
        if via == "CheckpointManager":
            P.CheckpointManager(str(tmp_path), **kwargs)
        else:
            getattr(P.Snapshot, via)(str(tmp_path / "s"), state, **kwargs)


def test_multi_process_group_raises(tmp_path) -> None:
    class TwoRanks:
        def size(self) -> int:
            return 2

    with pytest.raises(NotImplementedError, match="2 processes"):
        P.Snapshot.take(
            str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(2))}, pg=TwoRanks()
        )


def test_scheduler_pipelines_under_a_tiny_budget(tmp_path) -> None:
    """Every entry is over a 1-byte budget: the starvation escape must
    still admit them one at a time, on both pipelines."""
    import asyncio

    from torchsnapshot_tpu_torch.io_preparers.object import ObjectIOPreparer
    from torchsnapshot_tpu_torch.scheduler import sync_execute_read_reqs, sync_execute_write_reqs
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    values = {f"o{i}": {i, "x" * i} for i in range(6)}
    storage = FSStoragePlugin(str(tmp_path))
    loop = asyncio.new_event_loop()
    try:
        entries, reqs = {}, []
        for name, value in values.items():
            entries[name], r = ObjectIOPreparer.prepare_write(f"0/{name}", value)
            reqs += r
        sync_execute_write_reqs(reqs, storage, 1, 0, loop)
        got = {}
        reads = []
        for name, entry in entries.items():
            assert entry.checksum.startswith("crc32:") and entry.size > 0
            reads += ObjectIOPreparer.prepare_read(entry, lambda v, n=name: got.__setitem__(n, v))
        sync_execute_read_reqs(reads, storage, 1, 0, loop)
    finally:
        loop.close()
    assert got == values
