"""The port's native host library (``torchsnapshot_tpu_torch/_native``)
held against the JAX package's on the same bytes, bit-exact: CRC32C (the
native path and the plain table version), the fused copy and CRC32C,
scatter and gather copies, and the slab allocator; plus the build, the
kill switch and the fallbacks."""

from __future__ import annotations

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import torchsnapshot_tpu._native as J
import torchsnapshot_tpu_torch._native as N
from torch_test_env import autotune_never  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Lengths around every boundary of the native loops: the 8-byte word loop,
# the 3-way interleave at 3 x 8 KiB, the copy loop's 256 KiB blocks (for
# copy_crc32c), and up to 70,000 bytes.
LENGTHS = (
    list(range(0, 65))
    + [255, 256, 4095, 4096, 8191, 8192, 24575, 24576, 24577, 49151, 49152, 49153, 65537, 70000]
)
OFFSETS = (0, 1, 3, 7)


@pytest.fixture(scope="module")
def data() -> bytes:
    return np.random.default_rng(0).integers(0, 256, 70_000 + 16, np.uint8).tobytes()


@pytest.fixture()
def no_library(monkeypatch):
    """The port's loader as it is when the library is not built."""
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_load_attempted", True)


def test_library_builds_into_the_package_build_dir() -> None:
    assert N.native_available()
    path = N.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "torchsnapshot_tpu_torch", "build")
    assert os.path.basename(path).startswith("_ts_native-") and os.path.isfile(path)
    # The JAX package's library is another file.
    assert os.path.realpath(path) != os.path.realpath(J._SO)


def test_known_answer_native_and_plain() -> None:
    # RFC 3720's check value.
    assert N.crc32c(b"123456789") == 0xE3069283
    assert N.crc32c_plain(b"123456789") == 0xE3069283


@pytest.mark.parametrize("offset", OFFSETS)
def test_crc32c_equals_jax_on_every_length(data, offset) -> None:
    for n in LENGTHS:
        piece = data[offset : offset + n]
        want = J.crc32c(piece)
        assert N.crc32c(piece) == want, n
        assert N.crc32c(memoryview(piece)) == want, n


@pytest.mark.parametrize("n", [0, 1, 63, 4096, 24577, 70000])
def test_plain_crc32c_equals_jax(data, n) -> None:
    piece = data[3 : 3 + n]
    assert N.crc32c_plain(piece) == J.crc32c(piece) == J._crc32c_py(piece)


@pytest.mark.parametrize("split", [0, 1, 999, 24576, 50001])
def test_crc32c_chains_like_jax(data, split) -> None:
    a, b = data[:split], data[split:70000]
    chained = N.crc32c(b, N.crc32c(a))
    assert chained == J.crc32c(b, J.crc32c(a)) == J.crc32c(data[:70000])
    assert N.crc32c_plain(b, N.crc32c_plain(a)) == chained
    assert N.crc32c(b"", 0x1234) == 0x1234


@pytest.mark.parametrize("offset", OFFSETS)
def test_copy_crc32c_equals_jax(data, offset) -> None:
    for n in (0, 1, 7, 4096, 24577, 70000):
        src = np.frombuffer(data, np.uint8)[offset : offset + n]
        dst_port = np.full(n, 0xAA, np.uint8)
        dst_jax = np.full(n, 0x55, np.uint8)
        got = N.copy_crc32c(dst_port, src)
        assert got == J.copy_crc32c(dst_jax, src) == J.crc32c(src), n
        assert np.array_equal(dst_port, src) and np.array_equal(dst_jax, src)
    # Chained, and the 256 KiB block boundary of the native loop.
    big = np.random.default_rng(1).integers(0, 256, (1 << 18) + 7, np.uint8)
    head = np.empty(1000, np.uint8)
    tail = np.empty(big.size - 1000, np.uint8)
    assert N.copy_crc32c(tail, big[1000:], N.copy_crc32c(head, big[:1000])) == J.crc32c(big)


def test_copy_crc32c_refuses_bad_buffers() -> None:
    with pytest.raises(ValueError, match="size mismatch"):
        N.copy_crc32c(bytearray(3), b"1234")
    with pytest.raises(ValueError, match="read-only"):
        N.copy_crc32c(b"1234", b"1234")


def _regions(rng, n, size):
    out, d = [], 0
    for _ in range(n):
        length = int(rng.integers(0, 200))
        out.append((d, int(rng.integers(0, size - length)), length))
        d += length + int(rng.integers(0, 9))
    return out, d


@pytest.mark.parametrize("n_regions", [1, 3, 4, 17])
def test_scatter_copy_equals_jax_and_plain(n_regions) -> None:
    rng = np.random.default_rng(n_regions)
    src = rng.integers(0, 256, 8192, np.uint8).tobytes()
    regions, total = _regions(rng, n_regions, len(src))
    outs = [bytearray(total + 1) for _ in range(3)]
    N.scatter_copy(outs[0], src, regions)
    J.scatter_copy(outs[1], src, regions)
    N.scatter_copy_plain(outs[2], src, regions)
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("n_sources", [1, 3, 4, 12])
def test_gather_copy_equals_jax_and_plain(n_sources) -> None:
    rng = np.random.default_rng(n_sources)
    srcs = [rng.integers(0, 256, int(rng.integers(0, 300)), np.uint8).tobytes() for _ in range(n_sources)]
    offsets = list(np.cumsum([0] + [len(s) + 5 for s in srcs[:-1]]).astype(int))
    total = offsets[-1] + len(srcs[-1])
    outs = [bytearray(total) for _ in range(3)]
    N.gather_copy(outs[0], list(zip(offsets, srcs)))
    J.gather_copy(outs[1], list(zip(offsets, srcs)))
    N.gather_copy_plain(outs[2], list(zip(offsets, srcs)))
    assert outs[0] == outs[1] == outs[2]


def test_copies_are_bounds_checked() -> None:
    with pytest.raises(ValueError, match="out of bounds"):
        N.gather_copy(bytearray(10), [(0, b"123")] * 4 + [(8, b"12345")])
    with pytest.raises(ValueError, match="out of bounds"):
        N.scatter_copy(bytearray(10), b"x" * 10, [(0, 0, 5)] * 4 + [(8, 0, 5)])


def test_slab_is_aligned_prefaulted_and_freed() -> None:
    nbytes = 3 << 20
    addr, caps = N.slab_alloc(nbytes)
    try:
        assert addr % 4096 == 0
        assert caps & N.SLAB_PREFAULT and N.slab_caps_seen() & N.SLAB_PREFAULT
        view = np.ctypeslib.as_array((np.ctypeslib.ctypes.c_ubyte * nbytes).from_address(addr))
        assert not view.any()  # fresh anonymous memory
        view[:] = 7
    finally:
        N.slab_free(addr, nbytes)
    assert N.slab_alloc(0) is None


def test_has_hw_crc_on_x86() -> None:
    import platform

    assert N.has_hw_crc() == (platform.machine() == "x86_64")


def test_without_the_library_everything_falls_back(no_library) -> None:
    from torchsnapshot_tpu_torch import integrity

    assert not N.native_available() and not N.has_hw_crc()
    assert N.crc32c(b"123456789") == 0xE3069283  # the plain version
    assert N.copy_crc32c(bytearray(4), b"1234") is None
    assert N.slab_alloc(1 << 20) is None
    assert integrity.compute_checksum(b"abc").startswith("crc32:")
    dst = bytearray(8)
    N.gather_copy(dst, [(i, b"x") for i in range(8)])
    assert dst == b"x" * 8


def test_failed_build_logs_a_warning(tmp_path, monkeypatch, caplog) -> None:
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(N, "GXX_FLAGS", N.GXX_FLAGS + ["-fno-such-flag-exists"])
    with caplog.at_level(logging.WARNING, logger=N.__name__):
        assert N._try_load() is None
    assert any(r.levelno == logging.WARNING and "native host library" in r.message for r in caplog.records)
    assert os.listdir(tmp_path) == []  # no temp file left behind


def test_kill_switch_writes_zlib_crc32_and_stages_without_slabs(tmp_path) -> None:
    code = (
        "import torch, torchsnapshot_tpu_torch as P\n"
        "from torchsnapshot_tpu_torch import _native, warmup_staging\n"
        "st = {'app': P.StateDict(w=torch.arange(4096.0))}\n"
        "assert not _native.native_available()\n"
        "assert warmup_staging(st) == 0\n"
        "P.Snapshot.async_take(r'%s', st).wait()\n"
        "e = P.Snapshot(r'%s').get_manifest()['0/app/w'].chunks[0].array\n"
        "print(e.checksum)\n"
    ) % (tmp_path / "s", tmp_path / "s")
    env = dict(os.environ, TORCHSNAPSHOT_GPU_DISABLE_NATIVE="1")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("crc32:")
