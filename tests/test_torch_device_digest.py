"""The port's device fingerprints held against the JAX package's.

The same numpy inputs go through ``torchsnapshot_tpu.device_digest`` (jnp
under jit, on the CPU backend) and ``torchsnapshot_tpu_torch.device_digest``
(its plain version on CPU tensors; kernel K4 on the card is held against
that plain version in ``test_torch_kernels_cuda.py``). The digest strings
go into manifests both packages read, so they must be equal, character for
character. The conftest leaves ``jax_enable_x64`` off, so a 64-bit numpy
array would become 32-bit in JAX: 64-bit dtypes are compared against JAX's
``_fingerprint_jit`` on the array's uint32 view, folded with the original
byte count. Also here: the end-to-end skips of the take and restore paths,
mirrors of ``tests/test_device_digest.py``.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import device_digest as J
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch import device_digest as P
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer, ArrayBufferStager

NARROW_DTYPES = [
    "float32", "bfloat16", "float16", "int8", "uint8", "int16", "uint16", "int32",
    "uint32", "bool", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz", "float8_e8m0fnu",
]
WIDE_DTYPES = ["int64", "uint64", "float64"]


def _np_dtype(name: str):
    return np.dtype(getattr(ml_dtypes, name)) if hasattr(ml_dtypes, name) else np.dtype(name)


def _random(name: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape, dtype=np.int64))
    if name == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    dt = _np_dtype(name)
    return np.frombuffer(rng.bytes(n * dt.itemsize), dtype=dt).reshape(shape).copy()


def _torch(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bool":
        return torch.from_numpy(a.copy())
    if a.size == 0:
        return torch.empty(a.shape, dtype=getattr(torch, name))
    flat = torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8).copy())
    return flat.view(getattr(torch, name)).reshape(a.shape)


def _jax_wide_fingerprint(a: np.ndarray) -> str:
    words = np.ascontiguousarray(a).reshape(-1).view(np.uint32)
    return J._fold_lanes(np.asarray(J._get_jitted()(jnp.asarray(words))), a.nbytes)


@pytest.fixture
def staging_spy(monkeypatch):
    """Entry locations of every payload that reaches the port's staging
    copy (CPU tensors here: ``_stage_cpu``)."""
    staged = []
    orig = ArrayBufferStager._stage_cpu

    def spy(self):
        staged.append(self.entry.location)
        return orig(self)

    monkeypatch.setattr(ArrayBufferStager, "_stage_cpu", spy)
    return staged


@pytest.fixture
def consume_spy(monkeypatch):
    """Every payload the restore path consumes."""
    consumed = []
    orig = ArrayBufferConsumer.consume_buffer

    async def spy(self, buf, executor=None):
        consumed.append(self.entry.location)
        return await orig(self, buf, executor)

    monkeypatch.setattr(ArrayBufferConsumer, "consume_buffer", spy)
    return consumed


# ------------------------------------------------------ digest strings


@pytest.mark.parametrize("shape", [(1037,), (3, 5, 7), (0,), ()], ids=str)
@pytest.mark.parametrize("name", NARROW_DTYPES)
def test_digest_strings_equal_jax(name, shape) -> None:
    a = _random(name, shape, seed=len(shape))
    want = J.device_fingerprint(jnp.asarray(a))
    assert want is not None
    assert P.device_fingerprint(_torch(a, name)) == want


@pytest.mark.parametrize("shape", [(333,), (4, 9), ()], ids=str)
@pytest.mark.parametrize("name", WIDE_DTYPES)
def test_wide_digest_strings_equal_jax_on_the_word_view(name, shape) -> None:
    a = _random(name, shape, seed=7)
    assert P.device_fingerprint(_torch(a, name)) == _jax_wide_fingerprint(a)


def test_int64_word_order_is_low_word_first() -> None:
    # JAX's bitcast of int64 1 gives words [1, 0]: the port's stream too.
    assert P._words_reference(torch.tensor([1], dtype=torch.int64)).tolist() == [1, 0]
    words = np.array([1, 0], np.uint32)
    assert P.device_fingerprint(torch.tensor([1], dtype=torch.int64)) == J._fold_lanes(
        np.asarray(J._get_jitted()(jnp.asarray(words))), 8
    )


@pytest.mark.parametrize("name", ["complex64", "int4", "uint4", "int2", "uint2"])
def test_no_word_stream_gives_none_in_both(name) -> None:
    if name == "complex64":
        t, a = torch.zeros(5, dtype=torch.complex64), jnp.zeros(5, jnp.complex64)
    else:
        t = torch.zeros(5, dtype=torch.uint8).view(getattr(torch, name))
        a = jnp.zeros(5, getattr(ml_dtypes, name))
    assert J.device_fingerprint(a) is None
    assert P.device_fingerprint(t) is None


def test_non_tensors_give_none() -> None:
    assert P.device_fingerprint(np.zeros(4, np.float32)) is None
    assert P.device_fingerprint("nope") is None
    assert P._dispatch([1, 2]) is None


def test_plain_version_uint32_arithmetic() -> None:
    """The int64 emulation of uint32 multiply and mix32 against numpy's
    wrapping uint32 arithmetic, on values that overflow 32 bits."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    xt = torch.from_numpy(x.astype(np.int64))
    with np.errstate(over="ignore"):
        for m in (P._M1, P._M2, P._GOLDEN, 0xFFFFFFFF, 3):
            assert P._mul32(xt, m).numpy().tolist() == (x * np.uint32(m)).astype(np.int64).tolist()
        want = J._mix32(x)
    assert P._mix32_t(xt).numpy().tolist() == want.astype(np.int64).tolist()
    assert [P._mix32(int(v)) for v in x[:64]] == want[:64].astype(np.int64).tolist()


def test_plain_version_blocks_do_not_change_lanes(monkeypatch) -> None:
    a = _random("float32", (5000,), seed=2)
    whole = P.device_fingerprint(_torch(a, "float32"))
    monkeypatch.setattr(P, "_REFERENCE_BLOCK_WORDS", 999)
    assert P.device_fingerprint(_torch(a, "float32")) == whole == J.device_fingerprint(jnp.asarray(a))


def test_fingerprint_sensitivity() -> None:
    x = torch.zeros(4096, dtype=torch.int32)
    base = P.device_fingerprint(x)
    for pos in (0, 1, 2048, 4095):
        y = x.clone()
        y[pos] = 1
        assert P.device_fingerprint(y) != base, pos
    ar = torch.arange(512, dtype=torch.int32)
    assert P.device_fingerprint(ar) != P.device_fingerprint(ar.flip(0))
    assert P.device_fingerprint(torch.zeros(16)) != P.device_fingerprint(torch.zeros(32))
    assert P.device_fingerprint(ar) == P.device_fingerprint(ar.reshape(16, 32))
    # A non-contiguous view fingerprints its logical (row-major) content.
    m = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    assert P.device_fingerprint(m.t()) == P.device_fingerprint(m.t().contiguous())


# ----------------------------------------------------- partial lanes


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8", "bool"])
def test_partial_lanes_equal_jax_and_add_up(name) -> None:
    a = _random(name, (12, 20), seed=3)
    piece = _torch(a, name)
    full = P.device_fingerprint(piece)
    assert full == J.device_fingerprint(jnp.asarray(a))
    groups = []
    for r0, r1 in [(0, 5), (5, 12)]:
        for c0, c1 in [(0, 7), (7, 13), (13, 20)]:
            lanes = P.partial_fetch(P.partial_dispatch(piece[r0:r1, c0:c1], (12, 20), (r0, c0)))
            want = J.partial_fetch(J.partial_dispatch(jnp.asarray(a[r0:r1, c0:c1]), (12, 20), (r0, c0)))
            assert lanes == want
            groups.append(lanes)
    assert P.combine_partials(groups, a.nbytes) == full


def test_partial_lanes_scalar_single_elements_and_wide() -> None:
    sc = torch.tensor(3.25, dtype=torch.float32)
    assert P.combine_partials([P.partial_fetch(P.partial_dispatch(sc, (), ()))], 4) == (
        P.device_fingerprint(sc)
    )
    piece = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    groups = [
        P.partial_fetch(P.partial_dispatch(piece[i : i + 1, j : j + 1], (2, 3), (i, j)))
        for i in range(2)
        for j in range(3)
    ]
    assert P.combine_partials(groups, 24) == P.device_fingerprint(piece)
    mutated = piece.clone()
    mutated[1, 2] += 1
    groups_m = [
        P.partial_fetch(P.partial_dispatch(mutated[i : i + 1, j : j + 1], (2, 3), (i, j)))
        for i in range(2)
        for j in range(3)
    ]
    assert P.combine_partials(groups_m, 24) != P.device_fingerprint(piece)
    # 8-byte elements: two words each, tagged 2e and 2e + 1.
    wide = torch.arange(20, dtype=torch.int64).reshape(4, 5) * (2**40 + 3)
    parts = [P.partial_fetch(P.partial_dispatch(wide[r0:r1], (4, 5), (r0, 0))) for r0, r1 in ((0, 1), (1, 4))]
    assert P.combine_partials(parts, 160) == P.device_fingerprint(wide)


# ------------------------------------------------- windowed verification


def test_fingerprints_match_windowed_correctness() -> None:
    arrs = [torch.full((64,), float(i)) for i in range(10)]
    fps = [P.device_fingerprint(a) for a in arrs]
    calls = []

    def items(bad_at=None):
        return [
            (256, lambda i=i, a=a: (calls.append(i), a)[1], "xxh4x32:" + "0" * 32 if i == bad_at else fp)
            for i, (a, fp) in enumerate(zip(arrs, fps))
        ]

    assert P.fingerprints_match(items(), window=3)
    assert calls == list(range(10))
    calls.clear()
    assert not P.fingerprints_match(items(bad_at=1), window=3)
    assert max(calls) <= 2  # later windows never materialize
    assert not P.fingerprints_match([(16, lambda: np.zeros(4), "xxh4x32:" + "0" * 32)])
    assert P.fingerprints_match([])


def test_fingerprints_match_fetches_once_per_window(monkeypatch) -> None:
    arrs = [torch.full((64,), float(i)) for i in range(10)]
    fetches = []
    orig = P._fetch
    monkeypatch.setattr(P, "_fetch", lambda pendings: (fetches.append(len(pendings)), orig(pendings))[1])
    items = [(256, lambda a=a: a, P.device_fingerprint(a)) for a in arrs]
    fetches.clear()
    assert P.fingerprints_match(items, window=4)
    assert fetches == [4, 4, 2]


def test_fingerprints_match_byte_budget() -> None:
    arrs = [torch.full((256,), float(i)) for i in range(6)]  # 1 KiB each
    fps = [P.device_fingerprint(a) for a in arrs]
    live = []

    def items():
        return [(1024, lambda i=i, a=a: (live.append(i), a)[1], fp) for i, (a, fp) in enumerate(zip(arrs, fps))]

    assert P.fingerprints_match(items(), window=4, window_bytes=1536)
    assert live == list(range(6))  # each slice materialized exactly once
    live.clear()
    assert P.fingerprints_match(items(), window=4, window_bytes=16)
    assert live == list(range(6))
    bad = items()
    bad[5] = (bad[5][0], bad[5][1], "xxh4x32:" + "0" * 32)
    assert not P.fingerprints_match(bad, window=4, window_bytes=1536)
    with pytest.raises(ValueError):
        P.fingerprints_match(items(), window=0)
    with pytest.raises(ValueError):
        P.fingerprints_match(items(), window_bytes=0)


def test_env_var_falsy_spellings(monkeypatch) -> None:
    for off in ("", "0", "false"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS", off)
        assert not P.enabled_by_env(), off
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS")
    assert not P.enabled_by_env()
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS", "1")
    assert P.enabled_by_env()


# ------------------------------------------------------------- end to end


def test_unchanged_payloads_skip_staging(tmp_path, staging_spy) -> None:
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    b = torch.ones(128, dtype=torch.bfloat16)
    Snapshot.take(str(tmp_path / "base"), {"m": StateDict(w=w, b=b)}, device_digests=True)
    assert len(staging_spy) == 2  # the base pays staging
    staging_spy.clear()
    snap = Snapshot.take(
        str(tmp_path / "incr"),
        {"m": StateDict(w=w + 0, b=b + 0)},
        incremental_base=str(tmp_path / "base"),
        device_digests=True,
    )
    assert staging_spy == []
    assert sorted(p.name for p in (tmp_path / "incr").iterdir()) == [".snapshot_metadata"]
    dst = {"m": StateDict(w=torch.zeros_like(w), b=torch.zeros_like(b))}
    snap.restore(dst)
    assert torch.equal(dst["m"]["w"], w) and torch.equal(dst["m"]["b"], b)


def test_changed_payload_restages(tmp_path, staging_spy) -> None:
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    b = torch.ones(128, dtype=torch.bfloat16)
    Snapshot.take(str(tmp_path / "base"), {"m": StateDict(w=w, b=b)}, device_digests=True)
    staging_spy.clear()
    w2 = w.clone()
    w2[3, 3] += 1.0
    snap = Snapshot.take(
        str(tmp_path / "incr"),
        {"m": StateDict(w=w2, b=b)},
        incremental_base=str(tmp_path / "base"),
        device_digests=True,
    )
    assert len(staging_spy) == 1 and "m/w" in staging_spy[0]
    dst = {"m": StateDict(w=torch.zeros_like(w), b=torch.zeros_like(b))}
    snap.restore(dst)
    assert torch.equal(dst["m"]["w"], w2) and torch.equal(dst["m"]["b"], b)


def test_base_without_device_digests_falls_back_to_host_dedup(tmp_path, staging_spy) -> None:
    from torchsnapshot_tpu_torch.dedup import _iter_payload_entries

    w = torch.arange(256, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "base"), {"m": StateDict(w=w)}, record_digests=True)
    staging_spy.clear()
    snap = Snapshot.take(
        str(tmp_path / "incr"),
        {"m": StateDict(w=w + 0)},
        incremental_base=str(tmp_path / "base"),
        device_digests=True,
    )
    assert len(staging_spy) == 1  # no fingerprint in the base to match
    payloads = [p for e in snap.metadata.manifest.values() for p in _iter_payload_entries(e)]
    assert payloads and all(p.origin for p in payloads)  # sha256 still deduped
    assert all(p.device_digest for p in payloads)  # and the fingerprint was recorded


def test_env_var_enables(tmp_path, staging_spy, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_DEVICE_DIGESTS", "1")
    w = torch.arange(256, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "base"), {"m": StateDict(w=w)})
    staging_spy.clear()
    Snapshot.take(str(tmp_path / "incr"), {"m": StateDict(w=w + 0)}, incremental_base=str(tmp_path / "base"))
    assert staging_spy == []


def test_async_take_device_dedup(tmp_path, staging_spy) -> None:
    w = torch.arange(1024, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "base"), {"m": StateDict(w=w)}, device_digests=True)
    staging_spy.clear()
    pending = Snapshot.async_take(
        str(tmp_path / "incr"),
        {"m": StateDict(w=w)},
        incremental_base=str(tmp_path / "base"),
        device_digests=True,
    )
    w.add_(1.0)  # after async_take returns: the snapshot keeps the old bytes
    snap = pending.wait()
    assert staging_spy == []
    dst = {"m": StateDict(w=torch.zeros(1024))}
    snap.restore(dst)
    assert torch.equal(dst["m"]["w"], torch.arange(1024, dtype=torch.float32))


def test_device_dedup_none_checksum_warns_once(tmp_path, monkeypatch, caplog) -> None:
    from torchsnapshot_tpu_torch.io_preparers import array as array_mod

    w = torch.arange(1024, dtype=torch.float32)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_CHECKSUM", "0")
    Snapshot.take(str(tmp_path / "base"), {"m": StateDict(w=w)}, device_digests=True)
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_CHECKSUM")
    monkeypatch.setattr(array_mod, "_warned_none_checksum", False)
    logger = "torchsnapshot_tpu_torch.io_preparers.array"
    with caplog.at_level(logging.WARNING, logger=logger):
        Snapshot.take(
            str(tmp_path / "incr"), {"m": StateDict(w=w)}, device_digests=True,
            incremental_base=str(tmp_path / "base"), record_digests=True,
        )
    assert len([r for r in caplog.records if "checksum" in r.message.lower()]) == 1
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger):
        Snapshot.take(
            str(tmp_path / "incr2"), {"m": StateDict(w=w)}, device_digests=True,
            incremental_base=str(tmp_path / "incr"), record_digests=True,
        )
    assert not [r for r in caplog.records if "checksum" in r.message.lower()]


def test_restore_skips_matching_destination(tmp_path, consume_spy) -> None:
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    b = torch.ones(128, dtype=torch.bfloat16)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w, b=b)}, device_digests=True)
    dst = {"m": StateDict(w=w + 0, b=b + 0)}
    consume_spy.clear()
    Snapshot(str(tmp_path / "snap")).restore(dst, device_digests=True)
    assert consume_spy == []
    assert torch.equal(dst["m"]["w"], w)
    stale = w.clone()
    stale[0, 0] += 7.0
    dst2 = {"m": StateDict(w=stale, b=b + 0)}
    Snapshot(str(tmp_path / "snap")).restore(dst2, device_digests=True)
    assert len(consume_spy) == 1  # only w re-read
    assert torch.equal(dst2["m"]["w"], w)


def test_restore_skip_requires_dtype_match(tmp_path, consume_spy) -> None:
    w = torch.arange(256).to(torch.bfloat16)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)}, device_digests=True)
    dst = {"m": StateDict(w=torch.zeros(256, dtype=torch.float32))}
    consume_spy.clear()
    Snapshot(str(tmp_path / "snap")).restore(dst, device_digests=True)
    assert len(consume_spy) == 1
    assert torch.equal(dst["m"]["w"], w.float())


def test_restore_skip_off_by_default(tmp_path, consume_spy) -> None:
    w = torch.arange(256, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)}, device_digests=True)
    consume_spy.clear()
    Snapshot(str(tmp_path / "snap")).restore({"m": StateDict(w=w + 0)})
    assert len(consume_spy) == 1


def test_restore_skip_chunked_many_windows(tmp_path, consume_spy, monkeypatch) -> None:
    from torchsnapshot_tpu_torch.io_preparers import chunked

    monkeypatch.setattr(chunked, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 1024)  # 4 rows of 64 f32
    w = torch.arange(40 * 64, dtype=torch.float32).reshape(40, 64)  # 10 chunks
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)}, device_digests=True)
    entry = Snapshot(str(tmp_path / "snap")).get_manifest()["0/m/w"]
    assert len(entry.chunks) == 10 and all(c.array.device_digest for c in entry.chunks)
    consume_spy.clear()
    dst = {"m": StateDict(w=w + 0)}
    Snapshot(str(tmp_path / "snap")).restore(dst, device_digests=True)
    assert consume_spy == []
    w2 = w.clone()
    w2[39, 63] += 1.0
    dst2 = {"m": StateDict(w=w2)}
    Snapshot(str(tmp_path / "snap")).restore(dst2, device_digests=True)
    assert len(consume_spy) > 0
    assert torch.equal(dst2["m"]["w"], w)


def test_jax_and_port_record_the_same_device_digests(tmp_path) -> None:
    """The manifests the two packages write for the same bytes carry the
    same ``device_digest`` strings."""
    from torchsnapshot_tpu import Snapshot as JSnapshot
    from torchsnapshot_tpu import StateDict as JStateDict

    a = _random("float32", (32, 16), seed=11)
    h = _random("bfloat16", (64,), seed=12)
    JSnapshot.take(
        str(tmp_path / "jax"),
        {"m": JStateDict(a=jnp.asarray(a), h=jnp.asarray(h))},
        device_digests=True,
    )
    Snapshot.take(
        str(tmp_path / "port"),
        {"m": StateDict(a=_torch(a, "float32"), h=_torch(h, "bfloat16"))},
        device_digests=True,
    )

    def digests(meta):
        out = {}
        for path, e in meta.manifest.items():
            for c in getattr(e, "chunks", []):
                out[path] = c.array.device_digest
        return out

    jd = digests(JSnapshot(str(tmp_path / "jax")).metadata)
    pd = digests(Snapshot(str(tmp_path / "port")).metadata)
    assert jd == pd and len(pd) == 2 and all(v.startswith("xxh4x32:") for v in pd.values())
    assert jax.devices()[0].platform == "cpu"


def test_take_fingerprints_every_tensor_before_one_fetch(tmp_path, monkeypatch) -> None:
    """A device-digest take dispatches every tensor's fingerprint at planning
    and fetches all the lanes at once, not one round trip a tensor."""
    state = {"m": StateDict(**{f"w{i}": torch.full((64,), float(i)) for i in range(5)}, step=3)}
    Snapshot.take(str(tmp_path / "base"), state, device_digests=True)
    fetches = []
    orig = P._fetch
    monkeypatch.setattr(P, "_fetch", lambda pendings: (fetches.append(len(pendings)), orig(pendings))[1])
    snap = Snapshot.take(
        str(tmp_path / "incr"), state, incremental_base=str(tmp_path / "base"), device_digests=True
    )
    assert fetches == [5]
    entries = [snap.metadata.manifest[f"0/m/w{i}"].chunks[0].array for i in range(5)]
    assert all(e.origin and e.device_digest == P.device_fingerprint(state["m"][f"w{i}"])
               for i, e in enumerate(entries))
