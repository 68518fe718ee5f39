"""Write/read dispatch by value and entry type, and the storage layout rule.

Counterpart of ``torchsnapshot_tpu/io_preparers/prepare.py`` (its JAX seam
at prepare.py:250-280 becomes the in-place tensor restore of
``array.py``). Sharded entries live under ``sharded/``, replicated ones
under ``replicated/``, everything else under ``<rank>/``.

A DTensor whose mesh spans more than one rank and that is not fully
``Replicate`` is sharded (:func:`is_sharded_dtensor`, the counterpart of
``is_sharded_jax_array``, prepare.py:55-73): it is saved piece-wise and
restored into its local shard by ``sharded.py``, from a sharded entry of
any layout or from a plain one. Any other DTensor holds the whole value
locally and goes through the plain path as its local tensor.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ..device_digest import device_fingerprint, fingerprints_match
from ..io_types import ReadReq
from ..manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
)
from ..serialization import array_size_bytes, dtype_to_string
from .array import ArrayIOPreparer, DeviceStreams, check_restore_cast
from .chunked import ChunkedArrayIOPreparer
from .object import ObjectIOPreparer
from .sharded import ShardedArrayIOPreparer, ShardedView


def get_storage_path(
    logical_path: str, rank: int, replicated: bool = False, sharded: bool = False
) -> str:
    if sharded:
        return f"sharded/{logical_path}"
    return f"replicated/{logical_path}" if replicated else f"{rank}/{logical_path}"


def is_dtensor(obj: Any) -> bool:
    if not isinstance(obj, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(obj, DTensor)


def is_sharded_dtensor(obj: Any) -> bool:
    """True for a DTensor saved piece-wise: its mesh spans more than one
    rank and some placement is not ``Replicate``."""
    if not is_dtensor(obj):
        return False
    from torch.distributed.tensor import Replicate

    if obj.device_mesh.size() == 1:
        return False
    return not all(isinstance(p, Replicate) for p in obj.placements)


def is_process_replicated_dtensor(obj: Any, world_size: int) -> bool:
    """A fully ``Replicate`` DTensor over a mesh of every process of a
    world of more than one: identical data on every rank, so its path is
    replicated without a glob (``_is_process_replicated_jax_array``,
    snapshot.py:2470-2485 of the JAX package)."""
    if world_size <= 1 or not is_dtensor(obj):
        return False
    from torch.distributed.tensor import Replicate

    return obj.device_mesh.size() == world_size and all(
        isinstance(p, Replicate) for p in obj.placements
    )


def as_plain_entry_shards(entry: Entry) -> ShardedArrayEntry:
    """A plain entry as the pieces of a sharded one (a chunked entry's
    chunks, or one piece), so it restores into a sharded destination."""
    if isinstance(entry, ChunkedArrayEntry):
        return ShardedArrayEntry(dtype=entry.dtype, shape=entry.shape, shards=entry.chunks)
    return ShardedArrayEntry(
        dtype=entry.dtype,
        shape=entry.shape,
        shards=[Shard(offsets=[0] * len(entry.shape), sizes=list(entry.shape), array=entry)],
    )


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
    buffer_size_limit_bytes: Optional[int] = None,
    assume_verified: bool = False,
    reshard: Optional[Any] = None,
) -> List[ReadReq]:
    """Plan reads for ``entry``. A tensor destination (CPU or CUDA) is
    filled in place, with a ``same_kind`` cast when the dtypes differ;
    anything else is replaced by a new CPU tensor or object, reported
    through ``callback``. Primitive entries need no I/O and are handled by
    the caller.

    ``device_digests``: a tensor destination that already holds the
    entry's exact content, proven by its fingerprint, plans no reads and
    keeps its bytes: the restore-side mirror of the take-side skip.

    ``buffer_size_limit_bytes``: a tensor entry is read in unverified byte
    ranges of at most that size, a compressed one whole (``array.py``,
    budgeted reads).

    ``assume_verified``: the distributed preverify proved that the
    destination holds this entry's content; nothing is read.

    A sharded entry, or any tensor entry into a sharded DTensor (or a
    :class:`ShardedView`), goes through ``sharded.py``; a DTensor that is
    not sharded is filled through its local tensor, and ``callback`` gets
    the DTensor.

    ``reshard``: an active ``reshard.ReshardContext``; a sharded entry
    then reads the pieces that several ranks want once, on an elected
    owner, which sends each other rank its regions (``sharded.py``)."""
    if isinstance(entry, PrimitiveEntry) or assume_verified:
        return []
    if is_dtensor(obj_out) and not is_sharded_dtensor(obj_out):
        dtensor = obj_out

        def _cb(_value: Any) -> None:
            if callback is not None:
                callback(dtensor)

        return prepare_read(
            entry, dtensor.to_local(), _cb, streams, device_digests, buffer_size_limit_bytes
        )
    sharded_dst = is_sharded_dtensor(obj_out) or isinstance(obj_out, ShardedView)
    if isinstance(entry, ShardedArrayEntry) or (
        sharded_dst and isinstance(entry, (ArrayEntry, ChunkedArrayEntry))
    ):
        if not isinstance(entry, ShardedArrayEntry):
            entry = as_plain_entry_shards(entry)
            reshard = None  # only sharded entries are planned
        return ShardedArrayIOPreparer.prepare_read(
            entry, obj_out, callback, streams, device_digests, reshard
        )
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
        raise TypeError(f"Unsupported entry type for read: {type(entry).__name__}")
    dst = obj_out if isinstance(obj_out, torch.Tensor) else None
    if dst is not None:
        if list(dst.shape) != list(entry.shape):
            raise RuntimeError(
                f"Shape mismatch restoring into a tensor: snapshot has "
                f"{list(entry.shape)}, destination has {list(dst.shape)}."
            )
        check_restore_cast(entry.dtype, dst.dtype, "into a tensor")
    if isinstance(entry, ChunkedArrayEntry):
        return ChunkedArrayIOPreparer.prepare_read(
            entry, dst, callback, streams, buffer_size_limit_bytes
        )
    return ArrayIOPreparer.prepare_read(entry, dst, callback, streams, buffer_size_limit_bytes)


def prepare_write(obj: Any, logical_path: str, rank: int, replicated: bool = False):
    """Plan writes for an object leaf (not a tensor, not a primitive)."""
    storage_path = get_storage_path(logical_path, rank, replicated=replicated)
    return ObjectIOPreparer.prepare_write(storage_path, obj, replicated=replicated)
