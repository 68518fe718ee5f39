"""Per-entry payload checksums, recorded at stage time and verified on restore.

Counterpart of ``torchsnapshot_tpu/integrity.py`` without its native
extension: checksums are zlib CRC32 under the ``crc32:`` tag, which the JAX
package also writes and verifies when its extension is absent
(integrity.py:49-58). A ``crc32c:`` checksum (written by the JAX package
with its native extension) is skipped with a one-time warning; unknown
algorithms are skipped for forward compatibility.

Env:
  TORCHSNAPSHOT_GPU_CHECKSUM=0  - don't record checksums on save
  TORCHSNAPSHOT_GPU_VERIFY=0    - don't verify checksums on restore
"""

from __future__ import annotations

import logging
import os
import zlib

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


def _crc32(buf) -> str:
    return f"{zlib.crc32(memoryview(buf).cast('B')) & 0xFFFFFFFF:08x}"


def compute_checksum(buf) -> str:
    return f"crc32:{_crc32(buf)}"


_warned_crc32c = False


def verify_checksum(buf, expected: str, path: str) -> None:
    """Raise IntegrityError if ``buf`` doesn't hash to ``expected``."""
    algo, _, digest = expected.partition(":")
    if algo == "crc32c":
        global _warned_crc32c
        if not _warned_crc32c:
            _warned_crc32c = True
            logger.warning(
                "Snapshot records crc32c checksums, which this port does not "
                "compute; skipping their verification."
            )
        return
    if algo != "crc32":
        return
    actual = _crc32(buf)
    if actual != digest:
        raise IntegrityError(
            f"checksum mismatch reading {path!r}: manifest records "
            f"{algo}:{digest}, buffer hashes to {algo}:{actual} — the "
            f"snapshot data is corrupt (truncated, bit-rotted, or "
            f"overwritten since save)."
        )
