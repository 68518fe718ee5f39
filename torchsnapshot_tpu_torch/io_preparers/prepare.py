"""Write/read dispatch by value and entry type, and the storage layout rule.

Counterpart of ``torchsnapshot_tpu/io_preparers/prepare.py`` (its JAX seam
at prepare.py:250-280 becomes the in-place tensor restore of
``array.py``). Replicated entries live under ``replicated/``, everything
else under ``<rank>/``; sharded entries are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ..io_types import ReadReq
from ..manifest import ArrayEntry, ChunkedArrayEntry, Entry, ObjectEntry, PrimitiveEntry
from .array import ArrayIOPreparer, DeviceStreams, check_restore_cast
from .chunked import ChunkedArrayIOPreparer
from .object import ObjectIOPreparer


def get_storage_path(logical_path: str, rank: int, replicated: bool = False) -> str:
    return f"replicated/{logical_path}" if replicated else f"{rank}/{logical_path}"


def prepare_read(
    entry: Entry,
    obj_out: Any,
    callback: Optional[Callable[[Any], None]],
    streams: DeviceStreams,
) -> List[ReadReq]:
    """Plan reads for ``entry``. A tensor destination (CPU or CUDA) is
    filled in place, with a ``same_kind`` cast when the dtypes differ;
    anything else is replaced by a new CPU tensor or object, reported
    through ``callback``. Primitive entries need no I/O and are handled by
    the caller."""
    if isinstance(entry, PrimitiveEntry):
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
