"""Per-entry payload checksums, recorded at stage time and verified on restore.

Counterpart of ``torchsnapshot_tpu/integrity.py``. Checksums are CRC32C
under the ``crc32c:`` tag when the native host library is built
(``_native``), else zlib CRC32 under ``crc32:``; both packages write and
verify both tags. A ``crc32c:`` checksum met where the library is not
built is skipped with a one-time warning, as in the JAX package (the
plain Python CRC32C would turn a multi-GB restore into minutes of
hashing); unknown algorithms are skipped for forward compatibility.

Env:
  TORCHSNAPSHOT_GPU_CHECKSUM=0  - don't record checksums on save
  TORCHSNAPSHOT_GPU_VERIFY=0    - don't verify checksums on restore
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Optional

import numpy as np

from ._native import copy_crc32c, crc32c, native_available

logger = logging.getLogger(__name__)

CHECKSUM_ENV_VAR = "TORCHSNAPSHOT_GPU_CHECKSUM"
VERIFY_ENV_VAR = "TORCHSNAPSHOT_GPU_VERIFY"


class IntegrityError(RuntimeError):
    """A restored buffer's checksum did not match the manifest."""


def _env_on(name: str) -> bool:
    return os.environ.get(name, "1") not in ("0", "false", "")


def checksums_enabled() -> bool:
    return _env_on(CHECKSUM_ENV_VAR)


def verification_enabled() -> bool:
    return _env_on(VERIFY_ENV_VAR)


def compute_checksum(buf) -> str:
    """``crc32c:`` from the native library when it is built, else zlib's
    ``crc32:``: always a C-speed hash, never the plain Python CRC32C."""
    if native_available():
        return f"crc32c:{crc32c(buf):08x}"
    return f"crc32:{zlib.crc32(memoryview(buf).cast('B')) & 0xFFFFFFFF:08x}"


def copy_and_checksum(dst, src) -> Optional[str]:
    """Copy ``src`` into ``dst`` and return the ``crc32c:`` checksum of the
    bytes, in one pass over the source; None (and nothing copied) when the
    native library is not built."""
    crc = copy_crc32c(dst, src)
    return None if crc is None else f"crc32c:{crc:08x}"


_warned_slow_crc32c = False


def _verifiable(algo: str) -> bool:
    """Whether this host verifies ``algo``: crc32 always, crc32c with the
    native library (one warning per process otherwise), nothing else."""
    if algo == "crc32c" and not native_available():
        global _warned_slow_crc32c
        if not _warned_slow_crc32c:
            _warned_slow_crc32c = True
            logger.warning(
                "Snapshot records crc32c checksums but the native host library is "
                "not built on this host; skipping verification (pure-Python CRC32C "
                "is too slow for checkpoint-sized data)."
            )
        return False
    return algo in ("crc32c", "crc32")


def _mismatch(path: str, algo: str, digest: str, actual: str, what: str) -> IntegrityError:
    return IntegrityError(
        f"checksum mismatch reading {path!r}: manifest records {algo}:{digest}, "
        f"{what} hashes to {algo}:{actual} — the snapshot data is corrupt "
        f"(truncated, bit-rotted, or overwritten since save)."
    )


def verify_checksum(buf, expected: str, path: str) -> None:
    """Raise IntegrityError if ``buf`` doesn't hash to ``expected``."""
    algo, _, digest = expected.partition(":")
    if not _verifiable(algo):
        return
    if algo == "crc32c":
        actual = f"{crc32c(buf):08x}"
    else:
        actual = f"{zlib.crc32(memoryview(buf).cast('B')) & 0xFFFFFFFF:08x}"
    if actual != digest:
        raise _mismatch(path, algo, digest, actual, "buffer")


def _copy(dst, src) -> None:
    # numpy copies with the GIL released (a memoryview assignment holds
    # it), so the executor's threads copy in parallel.
    np.copyto(np.frombuffer(dst, np.uint8), np.frombuffer(src, np.uint8))


def copy_and_verify(dst, src, expected: Optional[str], path: str) -> None:
    """``dst[:] = src`` and, when ``expected`` is given and verification is
    on, check the bytes against it: in one pass over the source when it is
    a ``crc32c:`` checksum and the native library is built, else a copy and
    :func:`verify_checksum`. Raises IntegrityError on a mismatch."""
    if expected is None or not verification_enabled():
        _copy(dst, src)
        return
    algo, _, digest = expected.partition(":")
    crc = copy_crc32c(dst, src) if algo == "crc32c" else None
    if crc is None:
        _copy(dst, src)
        verify_checksum(dst, expected, path)
    elif f"{crc:08x}" != digest:
        raise _mismatch(path, algo, digest, f"{crc:08x}", "buffer")


class IncrementalVerifier:
    """Chained-checksum verification of a payload that arrives in pieces.

    ``update`` advances the running CRC over each piece (the chain over
    concatenated pieces equals the hash of the whole buffer); ``finish``
    compares against the manifest and raises :class:`IntegrityError` on a
    mismatch. It skips exactly what :func:`verify_checksum` skips:
    verification off, no recorded checksum, an unknown algorithm, or
    crc32c without the native library."""

    __slots__ = ("_algo", "_value", "_digest", "_path")

    def __init__(self, expected: Optional[str], path: str) -> None:
        self._algo: Optional[str] = None
        self._value = 0
        self._digest = ""
        self._path = path
        if expected is None or not verification_enabled():
            return
        algo, _, digest = expected.partition(":")
        if _verifiable(algo):
            self._algo, self._digest = algo, digest

    def update(self, chunk) -> None:
        if self._algo == "crc32c":
            self._value = crc32c(chunk, self._value)
        elif self._algo == "crc32":
            self._value = zlib.crc32(memoryview(chunk).cast("B"), self._value)

    def finish(self) -> None:
        if self._algo is None:
            return
        actual = f"{self._value & 0xFFFFFFFF:08x}"
        if actual != self._digest:
            raise _mismatch(self._path, self._algo, self._digest, actual, "stream")
