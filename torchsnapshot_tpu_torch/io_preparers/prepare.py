"""Write/read dispatch by value and entry type, and the storage layout rule.

Counterpart of ``torchsnapshot_tpu/io_preparers/prepare.py`` (its JAX seam
at prepare.py:250-280 becomes the in-place tensor restore of
``array.py``). Replicated entries live under ``replicated/``, everything
else under ``<rank>/``; sharded entries are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ..device_digest import device_fingerprint, fingerprints_match
from ..io_types import ReadReq
from ..manifest import ArrayEntry, ChunkedArrayEntry, Entry, ObjectEntry, PrimitiveEntry
from ..serialization import array_size_bytes, dtype_to_string
from .array import ArrayIOPreparer, DeviceStreams, check_restore_cast
from .chunked import ChunkedArrayIOPreparer
from .object import ObjectIOPreparer


def get_storage_path(logical_path: str, rank: int, replicated: bool = False) -> str:
    return f"replicated/{logical_path}" if replicated else f"{rank}/{logical_path}"


def _dst_already_matches(entry: Entry, dst: torch.Tensor) -> bool:
    """True when the tensor ``dst`` already holds exactly the content
    ``entry`` describes, proven by its fingerprint (``device_digest.py``:
    K4 on a CUDA tensor, on the current stream, so the caller's queued
    writes are seen; the plain version on a CPU tensor): the read and the
    host-to-device copy can be skipped. Conservative on every edge: a
    missing fingerprint, a dtype or shape difference or an
    unfingerprintable destination means False (prepare.py:105-157 of the
    JAX package)."""
    if list(dst.shape) != list(entry.shape) or dtype_to_string(dst.dtype) != entry.dtype:
        return False
    if isinstance(entry, ArrayEntry):
        if entry.device_digest is None or entry.byte_range is not None:
            return False
        return device_fingerprint(dst) == entry.device_digest
    if isinstance(entry, ChunkedArrayEntry):
        # Every chunk must match. No chunks would verify vacuously, so it
        # never skips.
        if not entry.chunks or any(c.array.device_digest is None for c in entry.chunks):
            return False
        # Windowed: a few chunk slices at a time, one fetch per window.
        return fingerprints_match(
            (
                array_size_bytes(c.sizes, entry.dtype),
                lambda c=c: dst[tuple(slice(o, o + n) for o, n in zip(c.offsets, c.sizes))],
                c.array.device_digest,
            )
            for c in entry.chunks
        )
    return False


def prepare_read(
    entry: Entry,
    obj_out: Any,
    callback: Optional[Callable[[Any], None]],
    streams: DeviceStreams,
    device_digests: bool = False,
) -> List[ReadReq]:
    """Plan reads for ``entry``. A tensor destination (CPU or CUDA) is
    filled in place, with a ``same_kind`` cast when the dtypes differ;
    anything else is replaced by a new CPU tensor or object, reported
    through ``callback``. Primitive entries need no I/O and are handled by
    the caller.

    ``device_digests``: a tensor destination that already holds the
    entry's exact content, proven by its fingerprint, plans no reads and
    keeps its bytes: the restore-side mirror of the take-side skip."""
    if isinstance(entry, PrimitiveEntry):
        return []
    if (
        device_digests
        and isinstance(obj_out, torch.Tensor)
        and isinstance(entry, (ArrayEntry, ChunkedArrayEntry))
        and _dst_already_matches(entry, obj_out)
    ):
        return []
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(entry, callback)
    if not isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
        raise NotImplementedError(
            f"{type(entry).__name__} entries (sharded state) are not ported to "
            "torchsnapshot_tpu_torch yet."
        )
    dst = obj_out if isinstance(obj_out, torch.Tensor) else None
    if dst is not None:
        if list(dst.shape) != list(entry.shape):
            raise RuntimeError(
                f"Shape mismatch restoring into a tensor: snapshot has "
                f"{list(entry.shape)}, destination has {list(dst.shape)}."
            )
        check_restore_cast(entry.dtype, dst.dtype, "into a tensor")
    if isinstance(entry, ChunkedArrayEntry):
        return ChunkedArrayIOPreparer.prepare_read(entry, dst, callback, streams)
    return ArrayIOPreparer.prepare_read(entry, dst, callback, streams)


def prepare_write(obj: Any, logical_path: str, rank: int, replicated: bool = False):
    """Plan writes for an object leaf (not a tensor, not a primitive)."""
    storage_path = get_storage_path(logical_path, rank, replicated=replicated)
    return ObjectIOPreparer.prepare_write(storage_path, obj, replicated=replicated)
