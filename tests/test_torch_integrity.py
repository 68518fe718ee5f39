"""End-to-end integrity in the port: mirrors of ``tests/test_integrity.py``
on torch tensors, the fused copy-and-checksum paths, ``IncrementalVerifier``,
and checksums across the two packages (a JAX ``crc32c:`` snapshot is
verified in the port, a corrupted byte raises)."""

from __future__ import annotations

import logging
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
import torchsnapshot_tpu_torch._native as N
from torchsnapshot_tpu._native import crc32c as jax_crc32c
from torchsnapshot_tpu_torch import integrity
from torchsnapshot_tpu_torch.integrity import (
    CHECKSUM_ENV_VAR,
    VERIFY_ENV_VAR,
    IncrementalVerifier,
    IntegrityError,
)
from torchsnapshot_tpu_torch.manifest import SnapshotMetadata
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture()
def no_library(monkeypatch):
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_load_attempted", True)
    monkeypatch.setattr(integrity, "_warned_slow_crc32c", False)


def _payload_checksums(path) -> dict:
    out = {}
    for p, e in P.Snapshot(path).get_manifest().items():
        for part in getattr(e, "chunks", []) or []:
            out[part.array.location] = part.array.checksum
        if getattr(e, "checksum", None) is not None:
            out[e.location] = e.checksum
    return out


def _corrupt_one_file(root, match: str) -> str:
    for f in sorted(root.rglob("*")):
        if f.is_file() and match in str(f) and ".snapshot_metadata" not in f.name:
            data = bytearray(f.read_bytes())
            data[len(data) // 2] ^= 0xFF
            f.write_bytes(bytes(data))
            return str(f)
    raise AssertionError(f"no payload file matching {match}")


def test_checksums_recorded_on_save(tmp_path) -> None:
    state = P.StateDict(arr=torch.arange(1000, dtype=torch.float32), obj={"nested": {1, 2, 3}})
    P.Snapshot.take(str(tmp_path / "s"), {"app": state})
    checksums = _payload_checksums(str(tmp_path / "s"))
    assert len(checksums) == 2
    assert all(c.startswith("crc32c:") for c in checksums.values())
    meta = SnapshotMetadata.from_yaml((tmp_path / "s" / ".snapshot_metadata").read_text())
    assert meta.manifest["0/app/arr"].chunks[0].array.checksum == checksums["0/app/arr_0"]


def test_checksum_is_the_crc32c_of_the_stored_bytes(tmp_path) -> None:
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(777).astype(np.float32))
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    stored = (tmp_path / "s" / "0" / "app" / "w_0").read_bytes()
    assert _payload_checksums(str(tmp_path / "s"))["0/app/w_0"] == f"crc32c:{jax_crc32c(stored):08x}"


def test_corrupt_array_detected_on_restore(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.arange(500.0))})
    _corrupt_one_file(tmp_path / "s", "w")
    with pytest.raises(IntegrityError, match="checksum mismatch"):
        P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(w=torch.zeros(500))})


def test_corrupt_object_detected_on_restore(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(blob=set(range(100)))})
    _corrupt_one_file(tmp_path / "s", "blob")
    with pytest.raises(IntegrityError, match="checksum mismatch"):
        P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(blob=None)})


def test_truncation_detected_on_restore(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=torch.arange(4096, dtype=torch.float64))})
    f = tmp_path / "s" / "0" / "app" / "w_0"
    f.write_bytes(f.read_bytes()[:-512])
    with pytest.raises(IntegrityError):
        P.Snapshot(str(tmp_path / "s")).restore({"app": P.StateDict(w=torch.zeros(4096, dtype=torch.float64))})


def test_verification_can_be_disabled(tmp_path, monkeypatch) -> None:
    w = torch.arange(256, dtype=torch.float32)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    _corrupt_one_file(tmp_path / "s", "w")
    monkeypatch.setenv(VERIFY_ENV_VAR, "0")
    dst = P.StateDict(w=torch.zeros(256))
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})  # no raise
    assert not torch.equal(dst["w"], w)


def test_checksum_recording_can_be_disabled(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv(CHECKSUM_ENV_VAR, "0")
    w = torch.arange(256, dtype=torch.float32)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(w=w)})
    assert set(_payload_checksums(str(tmp_path / "s")).values()) == {None}
    dst = P.StateDict(w=torch.zeros(256))
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert torch.equal(dst["w"], w)


def test_async_take_fused_checksum_verifies_on_restore(tmp_path) -> None:
    """async_take copies CPU tensors into staging slabs with their CRC32C
    in one pass; the checksums equal the stored bytes' and verify."""
    a = torch.arange(100_000, dtype=torch.float32)
    b = torch.arange(33_333, dtype=torch.int64)
    P.Snapshot.async_take(str(tmp_path / "s"), {"app": P.StateDict(a=a, b=b)}).wait()
    sums = _payload_checksums(str(tmp_path / "s"))
    for name in ("a", "b"):
        stored = (tmp_path / "s" / "0" / "app" / f"{name}_0").read_bytes()
        assert sums[f"0/app/{name}_0"] == f"crc32c:{jax_crc32c(stored):08x}"
    dst = P.StateDict(a=torch.zeros(100_000), b=torch.zeros(33_333, dtype=torch.int64))
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert torch.equal(dst["a"], a) and torch.equal(dst["b"], b)


@pytest.mark.parametrize("kind", ["array", "object"])
def test_jax_crc32c_snapshot_verifies_and_a_flipped_byte_raises(tmp_path, kind) -> None:
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    value = jnp.asarray(w) if kind == "array" else {("x", i) for i in range(50)}
    J.Snapshot.take(str(tmp_path / "s"), {"app": J.StateDict(v=value)})
    sums = _payload_checksums(str(tmp_path / "s"))
    assert sums and all(c.startswith("crc32c:") for c in sums.values())

    def dst():
        return P.StateDict(v=torch.zeros(64, 8) if kind == "array" else None)

    ok = dst()
    P.Snapshot(str(tmp_path / "s")).restore({"app": ok})
    if kind == "array":
        assert np.array_equal(ok["v"].numpy(), w)
    else:
        assert ok["v"] == value
    _corrupt_one_file(tmp_path / "s", "v")
    with pytest.raises(IntegrityError, match="crc32c"):
        P.Snapshot(str(tmp_path / "s")).restore({"app": dst()})


def test_port_crc32c_snapshot_verifies_in_jax_and_a_flipped_byte_raises(tmp_path) -> None:
    from torchsnapshot_tpu.integrity import IntegrityError as JaxIntegrityError

    w = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    P.Snapshot.take(str(tmp_path / "s"), {"app": P.StateDict(v=torch.from_numpy(w.copy()))})
    dst = J.StateDict(v=np.zeros((64, 8), np.float32))
    J.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert np.array_equal(dst["v"], w)
    _corrupt_one_file(tmp_path / "s", "v")
    with pytest.raises(JaxIntegrityError):
        J.Snapshot(str(tmp_path / "s")).restore({"app": J.StateDict(v=np.zeros((64, 8), np.float32))})


def test_crc32c_is_skipped_once_without_the_library(no_library, caplog) -> None:
    with caplog.at_level(logging.WARNING, logger=integrity.__name__):
        integrity.verify_checksum(b"abc", "crc32c:00000000", "x")
        integrity.verify_checksum(b"abc", "crc32c:00000000", "y")
    assert len([r for r in caplog.records if "not built" in r.message]) == 1
    with pytest.raises(IntegrityError):
        integrity.verify_checksum(b"abc", "crc32:00000000", "z")


def test_unknown_algorithms_are_skipped() -> None:
    integrity.verify_checksum(b"abc", "sha999:00", "x")


@pytest.mark.parametrize("algo", ["crc32c", "crc32"])
def test_copy_and_verify(algo) -> None:
    src = np.random.default_rng(3).integers(0, 256, 100_000, np.uint8)
    digest = jax_crc32c(src) if algo == "crc32c" else zlib.crc32(src.tobytes())
    dst = np.zeros_like(src)
    integrity.copy_and_verify(dst, src, f"{algo}:{digest:08x}", "p")
    assert np.array_equal(dst, src)
    bad = src.copy()
    bad[500] ^= 1
    with pytest.raises(IntegrityError, match=f"{algo}:{digest:08x}"):
        integrity.copy_and_verify(np.zeros_like(src), bad, f"{algo}:{digest:08x}", "p")
    integrity.copy_and_verify(dst, bad, None, "p")  # no checksum: a copy
    assert np.array_equal(dst, bad)


def test_copy_and_checksum_equals_compute_checksum() -> None:
    src = np.random.default_rng(4).integers(0, 256, 70_001, np.uint8)
    dst = np.zeros_like(src)
    assert integrity.copy_and_checksum(dst, src) == integrity.compute_checksum(src)
    assert np.array_equal(dst, src)


def test_copy_and_checksum_without_the_library(no_library) -> None:
    assert integrity.copy_and_checksum(bytearray(3), b"abc") is None


@pytest.mark.parametrize("algo", ["crc32c", "crc32"])
def test_incremental_verifier_chains_like_the_whole_buffer(algo) -> None:
    data = np.random.default_rng(5).integers(0, 256, 50_000, np.uint8).tobytes()
    digest = jax_crc32c(data) if algo == "crc32c" else zlib.crc32(data)
    v = IncrementalVerifier(f"{algo}:{digest:08x}", "p")
    for lo in range(0, len(data), 7777):
        v.update(data[lo : lo + 7777])
    v.finish()
    bad = IncrementalVerifier(f"{algo}:{digest:08x}", "p")
    bad.update(data[:-1])
    with pytest.raises(IntegrityError, match="stream hashes"):
        bad.finish()


def test_incremental_verifier_skips_what_verify_checksum_skips(monkeypatch, no_library) -> None:
    for expected in (None, "sha999:00", "crc32c:00000000"):
        v = IncrementalVerifier(expected, "p")
        v.update(b"abc")
        v.finish()
    monkeypatch.setenv(VERIFY_ENV_VAR, "0")
    v = IncrementalVerifier("crc32:00000000", "p")
    v.update(b"abc")
    v.finish()
