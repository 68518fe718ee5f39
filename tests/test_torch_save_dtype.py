"""save_dtype and cast-on-restore in the port: mirrors of
``tests/test_save_dtype.py`` and of the dense cases of
``tests/test_dtype_cast_restore.py``, and the stored bytes of a save_dtype
take held against the JAX package's on the same input."""

from __future__ import annotations

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch.manifest import get_manifest_for_rank
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _entries(path):
    return get_manifest_for_rank(Snapshot(path).metadata, 0)


def _payload_bytes(path) -> int:
    return sum(
        os.path.getsize(os.path.join(dp, f))
        for dp, _, fs in os.walk(path)
        for f in fs
        if not f.startswith(".")
    )


def _bf16_as_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def test_downcast_halves_storage_and_restores_back(tmp_path) -> None:
    src = torch.arange(4096, dtype=torch.float32) * 1.001
    state = {"m": StateDict(w=src, step=torch.tensor(7, dtype=torch.int64))}
    full, half = str(tmp_path / "full"), str(tmp_path / "half")
    Snapshot.take(full, state)
    Snapshot.take(half, state, save_dtype={"m/**": "bfloat16"})
    ents = _entries(half)
    assert ents["m/w"].dtype == "bfloat16" and ents["m/step"].dtype == "int64"
    assert _payload_bytes(half) < 0.6 * _payload_bytes(full)
    assert state["m"]["w"].dtype == torch.float32  # the caller's leaf is untouched
    dst = {"m": StateDict(w=torch.zeros(4096), step=torch.tensor(0, dtype=torch.int64))}
    Snapshot(half).restore(dst)
    assert dst["m"]["w"].dtype == torch.float32
    assert torch.equal(dst["m"]["w"], _bf16_as_f32(src))
    assert int(dst["m"]["step"]) == 7


def test_int_array_leaves_under_float_glob_stay_int(tmp_path) -> None:
    state = {
        "opt": StateDict(
            mu=torch.ones(64),
            count=torch.full((4,), 301, dtype=torch.int32),
            flag=torch.tensor([True, False]),
        )
    }
    path = str(tmp_path / "s")
    Snapshot.take(path, state, save_dtype={"opt/**": "bfloat16"})
    ents = _entries(path)
    assert (ents["opt/mu"].dtype, ents["opt/count"].dtype, ents["opt/flag"].dtype) == (
        "bfloat16", "int32", "bool"
    )
    dst = {"opt": StateDict(mu=torch.zeros(64), count=torch.zeros(4, dtype=torch.int32),
                            flag=torch.tensor([False, False]))}
    Snapshot(path).restore(dst)
    assert dst["opt"]["count"].tolist() == [301] * 4
    assert dst["opt"]["flag"].tolist() == [True, False]


def test_int_to_int_narrowing_by_explicit_glob(tmp_path) -> None:
    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": StateDict(ids=torch.arange(128, dtype=torch.int64))},
                  save_dtype={"m/ids": "int32"})
    assert _entries(path)["m/ids"].dtype == "int32"
    dst = torch.zeros(128, dtype=torch.int64)
    Snapshot(path).restore({"m": StateDict(ids=dst)})
    assert torch.equal(dst, torch.arange(128))


def test_invalid_dtype_name_fails_fast(tmp_path) -> None:
    state = {"m": StateDict(w=torch.ones(4))}
    with pytest.raises(ValueError, match="save_dtype.*bf16"):
        Snapshot.take(str(tmp_path / "s"), state, save_dtype={"m/**": "bf16"})
    assert not os.path.exists(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="save_dtype"):
        Snapshot.async_take(str(tmp_path / "s2"), state, save_dtype={"m/**": "half"})


def test_non_matching_globs_untouched(tmp_path) -> None:
    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": StateDict(w=torch.ones(64)), "opt": StateDict(mu=torch.ones(64))},
                  save_dtype={"opt/**": "bfloat16"})
    ents = _entries(path)
    assert ents["m/w"].dtype == "float32" and ents["opt/mu"].dtype == "bfloat16"


def test_first_matching_glob_wins(tmp_path) -> None:
    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": StateDict(a=torch.ones(8), b=torch.ones(8))},
                  save_dtype={"m/a": "float32", "m/**": "bfloat16"})
    ents = _entries(path)
    assert ents["m/a"].dtype == "float32"  # the explicit no-op match shields m/a
    assert ents["m/b"].dtype == "bfloat16"


def test_async_take_save_dtype(tmp_path) -> None:
    path = str(tmp_path / "s")
    w = torch.arange(1024, dtype=torch.float32)
    pending = Snapshot.async_take(path, {"m": StateDict(w=w)}, save_dtype={"m/**": "bfloat16"})
    w.add_(1.0)
    pending.wait()
    assert _entries(path)["m/w"].dtype == "bfloat16"
    dst = {"m": StateDict(w=torch.zeros(1024))}
    Snapshot(path).restore(dst)
    assert torch.equal(dst["m"]["w"], _bf16_as_f32(torch.arange(1024, dtype=torch.float32)))


def test_manager_save_dtype_end_to_end(tmp_path) -> None:
    mgr = CheckpointManager(str(tmp_path), save_dtype={"m/**": "bfloat16"})
    state = {"m": StateDict(w=torch.arange(256, dtype=torch.float32))}
    assert mgr.warmup(state) == 0
    assert mgr.save(0, state)
    assert _entries(mgr.path_for(0))["m/w"].dtype == "bfloat16"
    dst = {"m": StateDict(w=torch.zeros(256))}
    mgr.restore(dst)
    assert dst["m"]["w"].dtype == torch.float32


def test_save_dtype_upcast_also_works(tmp_path) -> None:
    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": StateDict(w=torch.arange(64).to(torch.bfloat16))},
                  save_dtype={"m/**": "float32"})
    assert _entries(path)["m/w"].dtype == "float32"


def test_fp8_quarter_size_storage(tmp_path) -> None:
    src = torch.linspace(-2, 2, 1024)
    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": StateDict(w=src)}, save_dtype={"m/**": "float8_e4m3fn"})
    assert _entries(path)["m/w"].dtype == "float8_e4m3fn"
    dst = {"m": StateDict(w=torch.zeros(1024))}
    Snapshot(path).restore(dst)
    want = src.numpy().astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    assert np.array_equal(dst["m"]["w"].numpy(), want)


def test_composes_with_incremental(tmp_path) -> None:
    """Digests cover the converted bytes: an unchanged leaf dedups across a
    save_dtype chain."""
    mgr = CheckpointManager(str(tmp_path), incremental=True, save_dtype={"m/**": "bfloat16"})
    w, frozen = torch.arange(4096, dtype=torch.float32), torch.ones(4096)
    assert mgr.save(0, {"m": StateDict(w=w, frozen=frozen)})
    assert mgr.save(1, {"m": StateDict(w=w * 2, frozen=frozen)})
    ents = _entries(mgr.path_for(1))
    assert ents["m/w"].dtype == "bfloat16"
    assert "step_0000000000" in ents["m/frozen"].chunks[0].array.origin
    dst = {"m": StateDict(w=torch.zeros(4096), frozen=torch.zeros(4096))}
    Snapshot(mgr.path_for(1)).restore(dst)
    assert torch.equal(dst["m"]["w"], _bf16_as_f32(w * 2))
    assert torch.equal(dst["m"]["frozen"], frozen)


def test_stored_bytes_equal_jax_save_dtype(tmp_path) -> None:
    """The same f32 input under the same save_dtype: the JAX package casts
    with ml_dtypes/XLA, the port with torch; the stored payloads are
    byte-identical, and each restores the other's."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((96, 8)) * 100).astype(np.float32)
    spec = {"m/**": "bfloat16"}
    J.Snapshot.take(str(tmp_path / "jax"), {"m": J.StateDict(w=jnp.asarray(a))}, save_dtype=spec)
    Snapshot.take(str(tmp_path / "port"), {"m": StateDict(w=torch.from_numpy(a.copy()))}, save_dtype=spec)
    jbytes = (tmp_path / "jax" / "0" / "m" / "w_0_0").read_bytes()
    assert jbytes == (tmp_path / "port" / "0" / "m" / "w_0_0").read_bytes()
    dst = torch.zeros(96, 8)
    Snapshot(str(tmp_path / "jax")).restore({"m": StateDict(w=dst)})
    assert np.array_equal(dst.numpy(), a.astype(ml_dtypes.bfloat16).astype(np.float32))


# ------------------------------------------------- cast on restore


def _take(tmp_path, **leaves) -> str:
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": StateDict(**leaves)})
    return path


def _restore(path, **leaves):
    dst = {"m": StateDict(**leaves)}
    Snapshot(path).restore(dst)
    return dst["m"]


def test_bf16_checkpoint_into_fp32_params(tmp_path) -> None:
    path = _take(tmp_path, w=torch.arange(256).to(torch.bfloat16))
    out = _restore(path, w=torch.zeros(256))["w"]
    assert out.dtype == torch.float32 and torch.equal(out, torch.arange(256, dtype=torch.float32))


def test_fp32_checkpoint_into_bf16_params(tmp_path) -> None:
    path = _take(tmp_path, w=torch.arange(256, dtype=torch.float32))
    out = _restore(path, w=torch.zeros(256, dtype=torch.bfloat16))["w"]
    assert out.dtype == torch.bfloat16 and torch.equal(out, torch.arange(256).to(torch.bfloat16))


def test_float_to_int_restore_refused(tmp_path) -> None:
    path = _take(tmp_path, w=torch.arange(16, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="cannot be cast"):
        _restore(path, w=torch.zeros(16, dtype=torch.int32))


def test_chunked_entry_cast(tmp_path, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.io_preparers import chunked

    monkeypatch.setattr(chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 1024)
    src = torch.arange(4 * 256, dtype=torch.float32).reshape(4, 256)
    path = _take(tmp_path, w=src)
    assert len(_entries(path)["m/w"].chunks) == 4
    out = _restore(path, w=torch.zeros((4, 256), dtype=torch.bfloat16))["w"]
    assert out.dtype == torch.bfloat16 and torch.equal(out, src.to(torch.bfloat16))


def test_matching_dtype_unaffected(tmp_path) -> None:
    src = torch.arange(256).to(torch.bfloat16)
    path = _take(tmp_path, w=src)
    out = _restore(path, w=torch.zeros(256, dtype=torch.bfloat16))["w"]
    assert torch.equal(out, src)
