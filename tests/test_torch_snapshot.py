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
from torch_test_env import autotune_never  # noqa: F401 - autouse

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


class _FakeCudaRng:
    """torch.cuda's RNG surface as seen by RNGState, for a host with
    ``n`` devices (or none): each device's state is 16 bytes."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.states = [torch.full((16,), 10 + i, dtype=torch.uint8) for i in range(n)]
        self.set_calls = []

    def install(self, monkeypatch) -> None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: self.n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: self.n)
        monkeypatch.setattr(torch.cuda, "get_rng_state_all", lambda: list(self.states))
        monkeypatch.setattr(torch.cuda, "set_rng_state_all", self.set_calls.append)


@pytest.mark.parametrize("take_devices,restore_devices", [(0, 1), (2, 1), (1, 2)])
def test_rng_state_restores_across_cuda_device_counts(
    tmp_path, monkeypatch, take_devices, restore_devices
) -> None:
    """A snapshot from a host with another number of CUDA devices (none
    included) restores: python, numpy and torch always, and the CUDA
    generators of the devices both hosts have."""
    with monkeypatch.context() as m:
        _FakeCudaRng(take_devices).install(m)
        torch.manual_seed(5)
        random.seed(5)
        np.random.seed(5)
        P.Snapshot.take(str(tmp_path / "s"), {"rng": P.RNGState()})
    expected = (torch.rand(3), random.random(), np.random.rand())
    torch.manual_seed(99)
    random.seed(99)
    np.random.seed(99)
    host = _FakeCudaRng(restore_devices)
    with monkeypatch.context() as m:
        host.install(m)
        P.Snapshot(str(tmp_path / "s")).restore({"rng": P.RNGState()})
    got = (torch.rand(3), random.random(), np.random.rand())
    assert torch.equal(got[0], expected[0]) and got[1:] == expected[1:]
    both = min(take_devices, restore_devices)
    if both == 0:
        assert host.set_calls == []
    else:
        (states,) = host.set_calls
        assert [s.tolist() for s in states] == [[10 + i] * 16 for i in range(both)]


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


def _metrics_port_starts(promexp, value: str, monkeypatch) -> bool:
    started = []
    monkeypatch.setattr(promexp, "start_exporter", lambda port, rank=None: started.append(port))
    monkeypatch.setenv(promexp.METRICS_PORT_ENV_VAR, value)
    promexp.maybe_start()
    return bool(started)


# knob suffix -> (module, reader, values, the value a take runs under)
_PLANE_KNOBS = {
    "AUTOTUNE": ("autotune", "autotune_mode",
                 ["", "auto", "pin", "FROZEN", "fresh", "reset", "never", "0", "junk"], "fresh"),
    "METRICS_PORT": ("telemetry.promexp", None, ["", "0", "9484", " 12 ", "-1", "auto"], "0"),
    "FORENSICS": ("telemetry.forensics", "_env_enabled", ["", "1", "0", "off", "never", "junk"],
                  "0"),
    "FORENSICS_SAMPLE_S": ("telemetry.forensics", "sample_cadence_s",
                           ["", "0.2", "0.01", "-1", "junk", "3"], "0.05"),
    "FORENSICS_DEADLINE_FRAC": ("telemetry.forensics", "deadline_fraction",
                                ["", "0.9", "0.01", "junk", "2"], "0.9"),
    "FORENSICS_STALL_S": ("telemetry.forensics", "stall_window_s",
                          ["", "5", "0.01", "junk", "120"], "5"),
}


@pytest.mark.parametrize("knob", [f"TORCHSNAPSHOT_GPU_{k}" for k in _PLANE_KNOBS])
def test_unported_env_knob_raises_by_name(tmp_path, monkeypatch, knob) -> None:
    """The knobs of the autotune, /metrics and forensics planes, which
    this test once saw refused, now read as the JAX package reads them,
    value for value, and a take and restore run under each (the test
    keeps its name)."""
    import importlib

    suffix = knob[len("TORCHSNAPSHOT_GPU_"):]
    module, reader, values, run_value = _PLANE_KNOBS[suffix]
    mine = importlib.import_module(f"torchsnapshot_tpu_torch.{module}")
    theirs = importlib.import_module(f"torchsnapshot_tpu.{module}")
    for value in values:
        monkeypatch.setenv(knob, value)
        monkeypatch.setenv(f"TORCHSNAPSHOT_TPU_{suffix}", value)
        if reader is None:
            with monkeypatch.context() as m:
                assert (_metrics_port_starts(mine, value, m)
                        == _metrics_port_starts(theirs, value, m)), value
        else:
            assert getattr(mine, reader)() == getattr(theirs, reader)(), value
    from torchsnapshot_tpu_torch.telemetry import forensics, promexp

    monkeypatch.setenv(knob, run_value)
    forensics.refresh_from_env()
    try:
        w = torch.arange(6, dtype=torch.float32)
        P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
        dst = {"app": P.StateDict(w=torch.zeros(6))}
        P.Snapshot(str(tmp_path / "s")).restore(dst)
        assert torch.equal(dst["app"]["w"], w)
        assert (promexp.active_exporter() is not None) == (suffix == "METRICS_PORT")
    finally:
        promexp.stop_exporter()
        monkeypatch.delenv(knob)
        forensics.refresh_from_env()


_FLEET_VALUES = ["1", "always", "auto", "never", "junk", ""]


@pytest.mark.parametrize("knob", ["TORCHSNAPSHOT_GPU_TENANT", "TORCHSNAPSHOT_GPU_SEED_RESTORE",
                                  "TORCHSNAPSHOT_GPU_LAZY_RESTORE"])
def test_fleet_env_knob_parses_and_acts_as_in_jax(tmp_path, monkeypatch, knob) -> None:
    """The fleet knobs, once refused here, now parse as the JAX package
    parses them, and a take and restore run under them."""
    from torchsnapshot_tpu import distrib as jax_distrib
    from torchsnapshot_tpu import pagein as jax_pagein
    from torchsnapshot_tpu import tenancy as jax_tenancy
    from torchsnapshot_tpu_torch import distrib, pagein, tenancy

    readers = {"TORCHSNAPSHOT_GPU_TENANT": (tenancy.tenant_from_env,
                                            jax_tenancy.tenant_from_env),
               "TORCHSNAPSHOT_GPU_SEED_RESTORE": (distrib.seed_restore_mode,
                                                  jax_distrib.seed_restore_mode),
               "TORCHSNAPSHOT_GPU_LAZY_RESTORE": (pagein.lazy_restore_mode,
                                                  jax_pagein.lazy_restore_mode)}
    mine, theirs = readers[knob]
    for value in _FLEET_VALUES:
        monkeypatch.setenv(knob, value)
        monkeypatch.setenv(knob.replace("_GPU_", "_TPU_"), value)
        assert repr(mine()) == repr(theirs()).replace("torchsnapshot_tpu.", "torchsnapshot_tpu_torch."), value
    monkeypatch.setenv(knob, "always")
    w = torch.arange(8, dtype=torch.float32)
    mgr = P.CheckpointManager(str(tmp_path))
    mgr.save(0, {"app": P.StateDict(w=w)})
    dst = {"app": P.StateDict(w=torch.zeros(8))}
    assert mgr.restore(dst) == 0
    # Under LAZY_RESTORE=always with no hot set, every leaf pages in.
    assert (mgr.last_pagein is not None) == (knob == "TORCHSNAPSHOT_GPU_LAZY_RESTORE")
    got = dst["app"]["w"]
    if isinstance(got, pagein.LeafFuture):
        mgr.last_pagein.wait()
        got = got.result()
    assert torch.equal(got, w)
    tenant_dir = os.path.join(str(tmp_path), "tenants", "always", "step_0000000000")
    assert os.path.isdir(tenant_dir) == (knob == "TORCHSNAPSHOT_GPU_TENANT")


def test_unported_env_knob_set_off_is_accepted(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_ENABLE_BATCHING", "0")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "never")
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(2))})


def test_jax_package_knobs_do_not_configure_the_port(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_COMPRESSION", "zstd")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_CHECKSUM", "0")
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.ones(2))})
    entry = P.Snapshot(str(tmp_path / "s")).get_manifest()["0/app/w"].chunks[0].array
    assert entry.codec is None and entry.checksum.startswith(_checksum_tag())


def _checksum_tag() -> str:
    from torchsnapshot_tpu_torch._native import native_available

    return "crc32c:" if native_available() else "crc32:"


@pytest.mark.parametrize(
    "kwargs",
    [
        # A mirror on gs:// or s3://, once refused here by the option's
        # name, reaches the ported cloud plugin, which raises the JAX
        # package's error naming the SDK it lacks (neither SDK is on the
        # card's machine; google-cloud-storage is hidden here, so no
        # client ever looks for credentials).
        {"via": "take", "storage_options": {"mirror_url": "gs://bucket/elsewhere"}},
        {"via": "take", "storage_options": {"mirror_url": "s3://bucket/elsewhere"}},
        {"via": "CheckpointManager", "storage_options": {"mirror_url": "s3://bucket/elsewhere"}},
    ],
)
def test_unported_argument_raises_by_name(tmp_path, monkeypatch, kwargs) -> None:
    import sys

    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    monkeypatch.setitem(sys.modules, "boto3", None)
    google_cloud = sys.modules.get("google.cloud")
    if google_cloud is not None and hasattr(google_cloud, "storage"):
        monkeypatch.delattr(google_cloud, "storage")
    kwargs = dict(kwargs)
    via = kwargs.pop("via")
    package = "google-cloud-storage" if "gs://" in str(kwargs) else "boto3"
    state = {"app": P.StateDict(w=torch.ones(2))}
    with pytest.raises(RuntimeError, match=package):
        if via == "CheckpointManager":
            P.CheckpointManager(str(tmp_path), **kwargs).save(0, state)
        else:
            getattr(P.Snapshot, via)(str(tmp_path / "s"), state, **kwargs)


@pytest.mark.parametrize(
    "via,codec",
    [
        ("take", "zstd"),
        ("async_take", "zstd"),
        ("CheckpointManager", "zstd"),
        ("take", "zlib:1"),
    ],
)
def test_compression_argument_round_trips(tmp_path, via, codec) -> None:
    """The ``compression`` argument of take, async_take and the manager
    stores compressible payloads under the codec; restore decodes them."""
    w = torch.arange(8192, dtype=torch.float32)
    state = {"app": P.StateDict(w=w, obj=set(range(3000)))}
    if via == "CheckpointManager":
        mgr = P.CheckpointManager(str(tmp_path), compression=codec)
        mgr.save(0, state)
        path = mgr.path_for(0)
    elif via == "async_take":
        path = str(tmp_path / "s")
        P.Snapshot.async_take(path, state, compression=codec).wait()
    else:
        path = str(tmp_path / "s")
        P.Snapshot.take(path, state, compression=codec)
    manifest = P.Snapshot(path).get_manifest()
    name = {"zstd": "zstd:3"}.get(codec, codec)
    assert manifest["0/app/w"].chunks[0].array.codec == name
    assert manifest["0/app/obj"].codec == name
    dst = P.StateDict(w=torch.zeros(8192), obj=None)
    P.Snapshot(path).restore({"app": dst})
    assert torch.equal(dst["w"], w) and dst["obj"] == set(range(3000))


@pytest.mark.parametrize("fsync", ["1", "0"])
def test_write_fsync_env(tmp_path, monkeypatch, fsync) -> None:
    """TORCHSNAPSHOT_GPU_FSYNC=1: each written file is fsynced before its
    rename, and its directory after it; off by default."""
    import asyncio

    from torchsnapshot_tpu_torch.io_types import WriteIO
    from torchsnapshot_tpu_torch.storage_plugins import fs

    synced = []
    real_fsync = os.fsync

    def counting_fsync(fd):
        synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_FSYNC", fsync)
    plugin = fs.FSStoragePlugin(str(tmp_path))
    asyncio.run(plugin.write(WriteIO(path="d/f", buf=b"abc")))
    assert (tmp_path / "d" / "f").read_bytes() == b"abc"
    if fsync == "1":
        assert len(synced) == 2
        assert ".tmp." in synced[0] and synced[1] == str(tmp_path / "d")
    else:
        assert synced == []
    synced.clear()
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(a=torch.ones(4), b=torch.ones(4))})
    # Two payloads, the commit fence and the metadata, each with its
    # directory.
    assert len(synced) == (8 if fsync == "1" else 0)


def test_multi_process_group_raises(tmp_path) -> None:
    """A group of two processes with no coordination store raises by
    name: a store is the only coordination the snapshot path has."""

    class TwoRanks:
        def size(self) -> int:
            return 2

    with pytest.raises(RuntimeError, match="2 processes needs the coordination store"):
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
            assert entry.checksum.startswith(_checksum_tag()) and entry.size > 0
            reads += ObjectIOPreparer.prepare_read(entry, lambda v, n=name: got.__setitem__(n, v))
        sync_execute_read_reqs(reads, storage, 1, 0, loop)
    finally:
        loop.close()
    assert got == values
