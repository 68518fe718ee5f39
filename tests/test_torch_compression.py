"""Payload compression in the port: mirrors of ``tests/test_compression.py``
on torch tensors (without the mirror, sharded, consolidate and CLI cases,
which are not ported), the codec functions held against the JAX package's,
and compressed snapshots across the two packages: each restores the
other's bit-exact, and for one state both write identical metadata and
payload bytes."""

from __future__ import annotations

import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu.compression as JC
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.compression import (
    COMPRESSION_ENV_VAR,
    StreamingDecompressor,
    UnknownCodecError,
    compress,
    decompress,
    resolve_codec,
)
from torchsnapshot_tpu_torch.manifest import SnapshotMetadata
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _compressible_state(n=200_000, v=1.0) -> P.StateDict:
    return P.StateDict(
        w=torch.arange(n, dtype=torch.float32) * v,
        b=torch.zeros(n // 2) + v,
        step=int(v),
    )


def _payload_bytes(root) -> int:
    return sum(
        os.path.getsize(os.path.join(r, f))
        for r, _, fs in os.walk(root)
        for f in fs
        if f != ".snapshot_metadata"
    )


def _entry_codecs(path) -> dict:
    out = {}
    for e in P.Snapshot(path).get_manifest().values():
        for part in getattr(e, "chunks", []) or []:
            out[part.array.location] = part.array.codec
        if hasattr(e, "codec") and hasattr(e, "location"):
            out[e.location] = e.codec
    return out


@pytest.mark.parametrize(
    "spec", [None, "", "none", "off", "zlib", "zlib:1", "zlib:9", "zstd", "ZSTD:9", "zstd:22"]
)
def test_resolve_codec_equals_jax(spec) -> None:
    assert resolve_codec(spec) == JC.resolve_codec(spec)


@pytest.mark.parametrize("spec", ["lz77", "zlib:42", "zstd:99", "zstd:0", "zlib:x"])
def test_resolve_codec_rejects_like_jax(spec) -> None:
    with pytest.raises(ValueError):
        JC.resolve_codec(spec)
    with pytest.raises(ValueError):
        resolve_codec(spec)


@pytest.mark.parametrize("codec", ["zstd:3", "zlib:6", "zlib:1"])
def test_compress_and_decompress_equal_jax(codec) -> None:
    data = np.arange(50_000, dtype=np.float32).tobytes()
    packed = compress(codec, data)
    assert packed == JC.compress(codec, data) and len(packed) < len(data)
    assert bytes(decompress(codec, packed, expected_size=len(data))) == data
    with pytest.raises(UnknownCodecError):
        decompress("snappy:1", b"xx")


@pytest.mark.parametrize("codec", ["zstd", "zlib:1"])
def test_round_trip_and_bytes_reduction(tmp_path, codec) -> None:
    state = _compressible_state()
    raw_root, comp_root = str(tmp_path / "raw"), str(tmp_path / "comp")
    P.Snapshot.take(raw_root, {"app": state})
    P.Snapshot.take(comp_root, {"app": state}, compression=codec)
    assert _payload_bytes(comp_root) < _payload_bytes(raw_root) / 2
    recorded = [c for c in _entry_codecs(comp_root).values() if c]
    assert recorded and all(c.startswith(codec.split(":")[0]) for c in recorded)
    dst = _compressible_state(v=0.0)
    P.Snapshot(comp_root).restore({"app": dst})
    assert torch.equal(dst["w"], state["w"]) and torch.equal(dst["b"], state["b"])
    assert dst["step"] == 1


def test_incompressible_payloads_stored_raw(tmp_path) -> None:
    noise = torch.from_numpy(np.random.default_rng(0).integers(0, 2**31, 100_000).astype(np.int32))
    root = str(tmp_path / "s")
    P.Snapshot.take(root, {"app": P.StateDict(noise=noise)}, compression="zstd")
    assert not any(_entry_codecs(root).values())
    dst = P.StateDict(noise=torch.zeros(100_000, dtype=torch.int32))
    P.Snapshot(root).restore({"app": dst})
    assert torch.equal(dst["noise"], noise)


def test_small_payloads_skip_compression(tmp_path) -> None:
    root = str(tmp_path / "s")
    P.Snapshot.take(root, {"app": P.StateDict(tiny=torch.arange(16.0))}, compression="zstd")
    assert not any(_entry_codecs(root).values())


def test_env_var_enables_compression(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv(COMPRESSION_ENV_VAR, "zlib:9")
    root = str(tmp_path / "s")
    state = _compressible_state()
    P.Snapshot.take(root, {"app": state})
    assert any(c and c.startswith("zlib:9") for c in _entry_codecs(root).values())
    monkeypatch.delenv(COMPRESSION_ENV_VAR)
    dst = _compressible_state(v=0.0)
    P.Snapshot(root).restore({"app": dst})
    assert torch.equal(dst["w"], state["w"])


def test_invalid_codec_raises_before_io(tmp_path) -> None:
    with pytest.raises(ValueError, match="unknown compression codec"):
        P.Snapshot.take(str(tmp_path / "s"), {"app": _compressible_state()}, compression="rle")
    assert not os.path.exists(tmp_path / "s")
    with pytest.raises(ValueError, match="unknown compression codec"):
        P.CheckpointManager(str(tmp_path / "m"), compression="rle")


def test_unknown_codec_on_restore_is_a_clear_error(tmp_path) -> None:
    root = str(tmp_path / "s")
    P.Snapshot.take(root, {"app": _compressible_state()}, compression="zlib")
    meta_path = os.path.join(root, ".snapshot_metadata")
    doctored = open(meta_path).read().replace("zlib:6", "futurecodec:1")
    open(meta_path, "w").write(doctored)
    with pytest.raises(UnknownCodecError, match="futurecodec"):
        P.Snapshot(root).restore({"app": _compressible_state(v=0.0)})


def test_async_take_with_compression(tmp_path) -> None:
    state = _compressible_state()
    P.Snapshot.async_take(str(tmp_path / "s"), {"app": state}, compression="zstd").wait()
    dst = _compressible_state(v=0.0)
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert torch.equal(dst["w"], state["w"])


def test_incremental_chain_stable_across_codec_changes(tmp_path) -> None:
    """Digests cover the raw bytes: a raw base still elides the writes of a
    compressed incremental and the reverse; deduplicated entries carry the
    base's stored checksum and codec."""
    state = _compressible_state()
    base_raw, inc_zstd = str(tmp_path / "base_raw"), str(tmp_path / "inc_zstd")
    P.Snapshot.take(base_raw, {"app": state}, record_digests=True)
    P.Snapshot.take(inc_zstd, {"app": state}, incremental_base=base_raw, compression="zstd")
    assert _payload_bytes(inc_zstd) < _payload_bytes(base_raw) / 10
    assert not any(_entry_codecs(inc_zstd).values())
    dst = _compressible_state(v=0.0)
    P.Snapshot(inc_zstd).restore({"app": dst})
    assert torch.equal(dst["w"], state["w"])

    base_z, inc_raw = str(tmp_path / "base_z"), str(tmp_path / "inc_raw")
    P.Snapshot.take(base_z, {"app": state}, record_digests=True, compression="zstd")
    P.Snapshot.take(inc_raw, {"app": state}, incremental_base=base_z)
    assert any(_entry_codecs(inc_raw).values())
    dst = _compressible_state(v=0.0)
    P.Snapshot(inc_raw).restore({"app": dst})
    assert torch.equal(dst["w"], state["w"]) and torch.equal(dst["b"], state["b"])


def test_incremental_changed_payloads_compress(tmp_path) -> None:
    base, inc = str(tmp_path / "b"), str(tmp_path / "i")
    P.Snapshot.take(base, {"app": _compressible_state()}, record_digests=True, compression="zstd")
    state2 = _compressible_state()
    state2["w"] = state2["w"] + 1.0
    P.Snapshot.take(inc, {"app": state2}, incremental_base=base, compression="zstd")
    assert any(c and c.startswith("zstd") for c in _entry_codecs(inc).values())
    dst = _compressible_state(v=0.0)
    P.Snapshot(inc).restore({"app": dst})
    assert torch.equal(dst["w"], state2["w"])


def test_compression_with_batching_composes(tmp_path, monkeypatch) -> None:
    """Batched (byte-ranged) payloads are not compressed; the snapshot
    round-trips as a whole."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_ENABLE_BATCHING", "1")
    smalls = {f"small_{i}": torch.full((64,), float(i)) for i in range(20)}
    big = torch.arange(300_000, dtype=torch.float32)
    root = str(tmp_path / "s")
    P.Snapshot.take(root, {"app": P.StateDict(big=big, **smalls)}, compression="zstd")
    subs = [e.chunks[0].array for e in P.Snapshot(root).get_manifest().values() if hasattr(e, "chunks")]
    assert len(subs) == 21
    assert all(s.byte_range is not None and s.codec is None for s in subs)
    dst = P.StateDict(big=torch.zeros(300_000), **{k: torch.zeros(64) for k in smalls})
    P.Snapshot(root).restore({"app": dst})
    assert torch.equal(dst["big"], big)
    assert all(torch.equal(dst[k], v) for k, v in smalls.items())


def test_objects_compress(tmp_path) -> None:
    payload = frozenset(f"tok {i}" for i in range(20_000))
    root = str(tmp_path / "s")
    P.Snapshot.take(root, {"app": P.StateDict(obj=payload)}, compression="zstd")
    entry = P.Snapshot(root).get_manifest()["0/app/obj"]
    assert entry.codec == "zstd:3" and entry.size > os.path.getsize(os.path.join(root, "0/app/obj"))
    dst = P.StateDict(obj=None)
    P.Snapshot(root).restore({"app": dst})
    assert dst["obj"] == payload


def test_codec_survives_yaml_round_trip(tmp_path) -> None:
    root = str(tmp_path / "s")
    P.Snapshot.take(root, {"app": _compressible_state()}, compression="zlib:4")
    text = open(os.path.join(root, ".snapshot_metadata")).read()
    assert "zlib:4" in text
    SnapshotMetadata.from_yaml(text)
    root2 = str(tmp_path / "raw")
    P.Snapshot.take(root2, {"app": _compressible_state()})
    assert "codec" not in open(os.path.join(root2, ".snapshot_metadata")).read()


def test_zlib_decompress_honors_expected_size_bound() -> None:
    packed = zlib.compress(b"A" * 1_000_000, 6)
    with pytest.raises(RuntimeError, match="exceeds expected|expected"):
        decompress("zlib:6", packed, expected_size=1024)


def test_zlib_trailing_garbage_rejected() -> None:
    data = b"B" * 4096
    packed = zlib.compress(data, 6)
    assert decompress("zlib:6", packed, expected_size=len(data)) == data
    with pytest.raises(RuntimeError, match="trailing"):
        decompress("zlib:6", packed + b"junk", expected_size=len(data))


def test_zstd_bomb_header_rejected_before_allocation() -> None:
    payload = compress("zstd:3", b"x" * 100_000)
    with pytest.raises(RuntimeError, match="declares"):
        decompress("zstd:3", payload, expected_size=512)


def test_dedup_keeps_verify_coverage_for_checksumless_raw_base(tmp_path, monkeypatch) -> None:
    base, inc = str(tmp_path / "b"), str(tmp_path / "i")
    state = _compressible_state()
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_CHECKSUM", "0")
    P.Snapshot.take(base, {"app": state}, record_digests=True)
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_CHECKSUM")
    P.Snapshot.take(inc, {"app": state}, incremental_base=base)
    manifest = P.Snapshot(inc).get_manifest()
    subs = [c.array for e in manifest.values() for c in getattr(e, "chunks", []) or []]
    assert subs and all(s.origin is not None and s.checksum is not None for s in subs)
    dst = _compressible_state(v=0.0)
    P.Snapshot(inc).restore({"app": dst})
    assert torch.equal(dst["w"], state["w"])


def test_read_object_decompresses(tmp_path) -> None:
    root = str(tmp_path / "s")
    state = _compressible_state()
    P.Snapshot.take(root, {"app": state}, compression="zstd")
    assert torch.equal(P.Snapshot(root).read_object("0/app/w"), state["w"])


@pytest.mark.parametrize("codec", ["zlib:6", "zstd:3"])
def test_streaming_decompressor_equals_decompress(codec) -> None:
    data = np.arange(60_000, dtype=np.float32).tobytes()
    packed = compress(codec, data)
    d = StreamingDecompressor(codec, expected_size=len(data))
    out = b"".join(d.feed(packed[lo : lo + 1000]) for lo in range(0, len(packed), 1000))
    assert out + d.finish() == data
    short = StreamingDecompressor(codec, expected_size=len(data) - 1)
    with pytest.raises(RuntimeError):
        for lo in range(0, len(packed), 1000):
            short.feed(packed[lo : lo + 1000])
        short.finish()
    assert StreamingDecompressor.available(codec) and not StreamingDecompressor.available("lz4:1")


# -------------------------------------------------------- across packages


def _jax_state(w, b, codec_obj):
    return J.StateDict(w=jnp.asarray(w), b=b, step=3, obj=codec_obj)


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_jax_compressed_take_restores_in_port(tmp_path, codec) -> None:
    w = np.arange(30_000, dtype=np.float32).reshape(100, 300)
    b = np.zeros(5000, np.float32) + 2.0
    obj = frozenset(f"k{i}" for i in range(3000))
    J.Snapshot.take(str(tmp_path / "s"), {"app": _jax_state(w, b, obj)}, compression=codec)
    assert any(c and c.startswith(codec) for c in _entry_codecs(str(tmp_path / "s")).values())
    dst = P.StateDict(w=torch.zeros(100, 300), b=torch.zeros(5000), step=0, obj=None)
    P.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert np.array_equal(dst["w"].numpy(), w) and np.array_equal(dst["b"].numpy(), b)
    assert dst["step"] == 3 and dst["obj"] == obj


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_port_compressed_take_restores_in_jax(tmp_path, codec) -> None:
    w = np.arange(30_000, dtype=np.float32).reshape(100, 300)
    b = np.zeros(5000, np.float32) + 2.0
    obj = frozenset(f"k{i}" for i in range(3000))
    P.Snapshot.take(
        str(tmp_path / "s"),
        {"app": P.StateDict(w=torch.from_numpy(w.copy()), b=torch.from_numpy(b.copy()), step=3, obj=obj)},
        compression=codec,
    )
    dst = J.StateDict(w=jnp.zeros((100, 300), jnp.float32), b=np.zeros(5000, np.float32), step=0, obj=None)
    J.Snapshot(str(tmp_path / "s")).restore({"app": dst})
    assert np.array_equal(np.asarray(dst["w"]), w) and np.array_equal(dst["b"], b)
    assert dst["step"] == 3 and dst["obj"] == obj


def _files(root) -> dict:
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(r, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_both_packages_write_identical_bytes(tmp_path, codec) -> None:
    """One state taken by each package, checksums on in both: the
    metadata and every payload file are byte-identical."""
    rng = np.random.default_rng(7)
    w = np.arange(20_000, dtype=np.float32).reshape(100, 200)
    b = rng.standard_normal(3000).astype(np.float32)
    obj = frozenset(range(2000))
    J.Snapshot.take(str(tmp_path / "jax"), {"app": _jax_state(w, b, obj)}, compression=codec)
    P.Snapshot.take(
        str(tmp_path / "port"),
        {"app": P.StateDict(w=torch.from_numpy(w.copy()), b=torch.from_numpy(b.copy()), step=3, obj=obj)},
        compression=codec,
    )
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert jax_files == port_files
    assert "crc32c:" in jax_files[".snapshot_metadata"].decode()
    if codec:
        assert b"zlib:6" in jax_files[".snapshot_metadata"]
