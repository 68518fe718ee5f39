"""Incremental snapshots in the port, and their interchange with the JAX
package.

Port mirrors of ``tests/test_incremental.py`` at a small size (host
digests: SHA-256 of the staged bytes), then incremental snapshots with
device digests written by one package and restored by the other,
bit-exact, including restore skips and increments of one package chained
onto the other's base.
"""

from __future__ import annotations

import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer, ArrayBufferStager
from torchsnapshot_tpu_torch.manifest import ChunkedArrayEntry, ObjectEntry
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _state(frozen_val=1.0, trainable_val=2.0, obj=frozenset({"a", 1})):
    return P.StateDict(
        frozen=torch.full((64, 8), frozen_val),
        trainable=torch.full((16, 4), trainable_val),
        meta=obj,
        step=7,
    )


def _payload_files(root) -> set:
    out = set()
    for r, _, files in os.walk(root):
        for f in files:
            if f != ".snapshot_metadata":
                out.add(os.path.relpath(os.path.join(r, f), root))
    return out


def test_base_records_digests(tmp_path) -> None:
    base = str(tmp_path / "base")
    P.Snapshot.take(base, {"app": _state()}, record_digests=True)
    meta = P.Snapshot(base).metadata
    entry = meta.manifest["0/app/frozen"]
    assert isinstance(entry, ChunkedArrayEntry)
    for chunk in entry.chunks:
        assert chunk.array.digest.startswith("sha256:") and chunk.array.origin is None
        assert chunk.array.device_digest is None  # host digests only
    obj = meta.manifest["0/app/meta"]
    assert isinstance(obj, ObjectEntry) and obj.digest is not None


def test_incremental_skips_unchanged_and_restores(tmp_path) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    P.Snapshot.take(base, {"app": _state()}, record_digests=True)
    P.Snapshot.take(inc, {"app": _state(trainable_val=9.0)}, incremental_base=base)
    files = _payload_files(inc)
    assert not any("frozen" in f or "meta" in f for f in files), files
    assert any("trainable" in f for f in files), files
    meta = P.Snapshot(inc).metadata
    assert all(c.array.origin == os.path.realpath(base) for c in meta.manifest["0/app/frozen"].chunks)
    assert all(c.array.origin is None for c in meta.manifest["0/app/trainable"].chunks)
    assert meta.manifest["0/app/meta"].origin == os.path.realpath(base)
    dst = _state(0.0, 0.0, None)
    P.Snapshot(inc).restore({"app": dst})
    assert torch.equal(dst["frozen"], torch.full((64, 8), 1.0))
    assert torch.equal(dst["trainable"], torch.full((16, 4), 9.0))
    assert dst["meta"] == frozenset({"a", 1}) and dst["step"] == 7


def test_chained_incrementals_resolve_origin_transitively(tmp_path) -> None:
    a, b, c = (str(tmp_path / n) for n in "abc")
    P.Snapshot.take(a, {"app": _state()}, record_digests=True)
    P.Snapshot.take(b, {"app": _state(trainable_val=5.0)}, incremental_base=a)
    P.Snapshot.take(c, {"app": _state(trainable_val=6.0)}, incremental_base=b)
    meta = P.Snapshot(c).metadata
    # frozen was written once, in a; c points straight at a
    assert all(ch.array.origin == os.path.realpath(a) for ch in meta.manifest["0/app/frozen"].chunks)
    assert all(ch.array.origin is None for ch in meta.manifest["0/app/trainable"].chunks)
    dst = _state(0.0, 0.0, None)
    P.Snapshot(c).restore({"app": dst})
    assert torch.equal(dst["frozen"], torch.full((64, 8), 1.0))
    assert torch.equal(dst["trainable"], torch.full((16, 4), 6.0))


def test_async_take_incremental(tmp_path) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    P.Snapshot.take(base, {"app": _state()}, record_digests=True)
    P.Snapshot.async_take(inc, {"app": _state(trainable_val=3.5)}, incremental_base=base).wait()
    assert not any("frozen" in f for f in _payload_files(inc))
    dst = _state(0.0, 0.0, None)
    P.Snapshot(inc).restore({"app": dst})
    assert torch.equal(dst["frozen"], torch.full((64, 8), 1.0))
    assert torch.equal(dst["trainable"], torch.full((16, 4), 3.5))


def test_read_object_follows_origin(tmp_path) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    P.Snapshot.take(base, {"app": _state()}, record_digests=True)
    P.Snapshot.take(inc, {"app": _state(trainable_val=4.0)}, incremental_base=base)
    assert torch.equal(P.Snapshot(inc).read_object("0/app/frozen"), torch.full((64, 8), 1.0))
    assert P.Snapshot(inc).read_object("0/app/meta") == frozenset({"a", 1})
    out = torch.zeros(64, 8)
    P.Snapshot(inc).read_object("0/app/frozen", obj_out=out)
    assert torch.equal(out, torch.full((64, 8), 1.0))


def test_missing_base_raises_actionable_error(tmp_path) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    P.Snapshot.take(base, {"app": _state()}, record_digests=True)
    P.Snapshot.take(inc, {"app": _state(trainable_val=8.0)}, incremental_base=base)
    shutil.rmtree(base)
    with pytest.raises((RuntimeError, FileNotFoundError)):
        P.Snapshot(inc).restore({"app": _state(0.0, 0.0, None)})


def test_base_without_digests_rewrites_everything(tmp_path, caplog) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    P.Snapshot.take(base, {"app": _state()})  # no record_digests
    with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.snapshot"):
        P.Snapshot.take(inc, {"app": _state()}, incremental_base=base)
    assert any("no content digests" in r.message for r in caplog.records)
    assert any("frozen" in f for f in _payload_files(inc))
    dst = _state(0.0, 0.0, None)
    P.Snapshot(inc).restore({"app": dst})
    assert torch.equal(dst["frozen"], torch.full((64, 8), 1.0))


def test_non_incremental_format_unchanged(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"app": _state()})
    raw = (tmp_path / "s" / ".snapshot_metadata").read_text()
    for key in ("digest", "origin", "device_digest"):
        assert key not in raw


def test_chunked_origins_are_per_chunk(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.io_preparers import chunked

    monkeypatch.setattr(chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 512)  # 4 rows of 32 f32
    w = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32)
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    P.Snapshot.take(base, {"m": P.StateDict(w=w)}, record_digests=True)
    w2 = w.clone()
    w2[5, 0] = -1.0  # the second chunk only
    P.Snapshot.take(inc, {"m": P.StateDict(w=w2)}, incremental_base=base)
    chunks = P.Snapshot(inc).metadata.manifest["0/m/w"].chunks
    assert [c.array.origin is None for c in chunks] == [False, True, False, False]
    dst = {"m": P.StateDict(w=torch.zeros_like(w))}
    P.Snapshot(inc).restore(dst)
    assert torch.equal(dst["m"]["w"], w2)


# ------------------------------------------- interchange with the JAX package


def _numpy_state(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((48, 16)).astype(np.float32),
        "h": rng.standard_normal((64,)).astype(np.float32),
        "i": rng.integers(-5, 5, size=(7,)).astype(np.int32),
    }


def _mutate(state):
    out = {k: v.copy() for k, v in state.items()}
    out["h"][3] += 1.0
    return out


def _jax_state(np_state):
    return J.StateDict(**{k: jnp.asarray(v) for k, v in np_state.items()})


def _port_state(np_state):
    return P.StateDict(**{k: torch.from_numpy(v.copy()) for k, v in np_state.items()})


@pytest.fixture
def port_consumed(monkeypatch):
    consumed = []
    orig = ArrayBufferConsumer.consume_buffer

    async def spy(self, buf, executor=None):
        consumed.append(self.entry.location)
        return await orig(self, buf, executor)

    monkeypatch.setattr(ArrayBufferConsumer, "consume_buffer", spy)
    return consumed


@pytest.fixture
def port_staged(monkeypatch):
    staged = []
    orig = ArrayBufferStager._stage_cpu

    def spy(self):
        staged.append(self.entry.location)
        return orig(self)

    monkeypatch.setattr(ArrayBufferStager, "_stage_cpu", spy)
    return staged


def test_jax_written_device_digest_incremental_restores_in_port(tmp_path, port_consumed) -> None:
    s0 = _numpy_state(0)
    s1 = _mutate(s0)
    base, inc = str(tmp_path / "jbase"), str(tmp_path / "jinc")
    J.Snapshot.take(base, {"m": _jax_state(s0)}, device_digests=True)
    J.Snapshot.take(inc, {"m": _jax_state(s1)}, incremental_base=base, device_digests=True)
    manifest = P.Snapshot(inc).metadata.manifest
    origins = {k: [c.array.origin for c in manifest[f"0/m/{k}"].chunks] for k in s1}
    assert origins["w"] == [os.path.realpath(base)] and origins["i"] == [os.path.realpath(base)]
    assert origins["h"] == [None]

    dst = P.StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in s1.items()})
    P.Snapshot(inc).restore({"m": dst})
    for k, v in s1.items():
        assert np.array_equal(dst[k].numpy(), v), k

    # The port's restore skip accepts the JAX-written device_digest strings.
    port_consumed.clear()
    same = _port_state(s1)
    P.Snapshot(inc).restore({"m": same}, device_digests=True)
    assert port_consumed == []
    stale = _port_state(s0)  # h differs from the snapshot
    P.Snapshot(inc).restore({"m": stale}, device_digests=True)
    assert [os.path.basename(p) for p in port_consumed] == ["h_0"]
    assert np.array_equal(stale["h"].numpy(), s1["h"])


def test_port_written_device_digest_incremental_restores_in_jax(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu.io_preparers.array import ArrayBufferConsumer as JConsumer

    s0 = _numpy_state(1)
    s1 = _mutate(s0)
    base, inc = str(tmp_path / "pbase"), str(tmp_path / "pinc")
    P.Snapshot.take(base, {"m": _port_state(s0)}, device_digests=True)
    P.Snapshot.take(inc, {"m": _port_state(s1)}, incremental_base=base, device_digests=True)
    assert sorted(_payload_files(inc)) == ["0/m/h_0"]

    dst = J.StateDict(**{k: jnp.zeros(v.shape, v.dtype) for k, v in s1.items()})
    J.Snapshot(inc).restore({"m": dst})
    for k, v in s1.items():
        assert np.array_equal(np.asarray(dst[k]), v), k

    consumed = []
    orig = JConsumer._consume_sync

    def spy(self, buf):
        consumed.append(self.entry.location)
        return orig(self, buf)

    monkeypatch.setattr(JConsumer, "_consume_sync", spy)
    J.Snapshot(inc).restore({"m": _jax_state(s1)}, device_digests=True)
    assert consumed == []  # the JAX package's skip accepts the port's strings


def test_port_increment_on_a_jax_base_stages_nothing(tmp_path, port_staged) -> None:
    s0 = _numpy_state(2)
    base, inc = str(tmp_path / "jbase"), str(tmp_path / "pinc")
    J.Snapshot.take(base, {"m": _jax_state(s0)}, device_digests=True)
    port_staged.clear()
    P.Snapshot.take(inc, {"m": _port_state(s0)}, incremental_base=base, device_digests=True)
    assert port_staged == []
    assert _payload_files(inc) == set()
    dst = J.StateDict(**{k: jnp.zeros(v.shape, v.dtype) for k, v in s0.items()})
    J.Snapshot(inc).restore({"m": dst})
    for k, v in s0.items():
        assert np.array_equal(np.asarray(dst[k]), v), k


def test_jax_increment_on_a_port_base_skips_its_writes(tmp_path) -> None:
    s0 = _numpy_state(3)
    base, inc = str(tmp_path / "pbase"), str(tmp_path / "jinc")
    P.Snapshot.take(base, {"m": _port_state(s0)}, device_digests=True)
    J.Snapshot.take(inc, {"m": _jax_state(s0)}, incremental_base=base, device_digests=True)
    assert _payload_files(inc) == set()
    dst = P.StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in s0.items()})
    P.Snapshot(inc).restore({"m": dst})
    for k, v in s0.items():
        assert np.array_equal(dst[k].numpy(), v), k
