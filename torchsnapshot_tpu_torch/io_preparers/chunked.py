"""Chunked-tensor preparer.

Counterpart of ``torchsnapshot_tpu/io_preparers/chunked.py``. Every
non-sharded tensor is saved as a ``ChunkedArrayEntry``: split along dim 0
into chunks of at most ``DEFAULT_MAX_CHUNK_SIZE_BYTES`` (one chunk below
that), each chunk one payload. The layout is recorded as N-D offsets and
sizes, with the same locations the JAX package writes (``<path>_<offsets>``),
so either package restores the other's chunked entries.

Restore fills each chunk's region of the destination in place; with no
destination, a CPU tensor is assembled and reported once every chunk has
landed.

Each chunk is its own payload to an incremental take: its stager records
the chunk's digest and device fingerprint and dedups it alone, so a chunk
may live in a base snapshot (its ``origin``) while its neighbours are
written anew, and each chunk's read goes to its own origin.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

import torch

from ..io_types import ReadReq, WriteReq
from ..manifest import ChunkedArrayEntry, Shard
from ..serialization import array_size_bytes, dtype_to_string, string_to_dtype
from .array import ArrayIOPreparer, DeviceStreams

DEFAULT_MAX_CHUNK_SIZE_BYTES = 512 * 1024 * 1024


class ChunkedArrayIOPreparer:
    @staticmethod
    def chunk_shards(
        shape: Tuple[int, ...], dtype_str: str, chunk_size_bytes: Optional[int] = None
    ) -> List[Tuple[List[int], List[int]]]:
        """(offsets, sizes) per chunk along dim 0, each at most
        ``chunk_size_bytes`` (single-row chunks if one row exceeds it); a
        scalar is one chunk with empty offsets."""
        if chunk_size_bytes is None:
            # resolved at call time so tests can shrink the module constant
            chunk_size_bytes = DEFAULT_MAX_CHUNK_SIZE_BYTES
        if len(shape) == 0:
            return [([], [])]
        if 0 in shape:
            ranges = [(0, shape[0])]
        else:
            row_bytes = array_size_bytes(shape, dtype_str) // shape[0]
            rows = max(1, chunk_size_bytes // max(row_bytes, 1))
            ranges = [(lo, min(lo + rows, shape[0])) for lo in range(0, shape[0], rows)]
        rest = list(shape[1:])
        return [([lo] + [0] * len(rest), [hi - lo] + rest) for lo, hi in ranges]

    @staticmethod
    def prepare_write(
        storage_path_prefix: str,
        tensor: torch.Tensor,
        streams: DeviceStreams,
        copy_cpu: bool,
        replicated: bool = False,
    ) -> Tuple[ChunkedArrayEntry, List[WriteReq]]:
        dtype_str = dtype_to_string(tensor.dtype)
        chunks: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for offsets, sizes in ChunkedArrayIOPreparer.chunk_shards(
            tuple(tensor.shape), dtype_str
        ):
            sub = tensor[offsets[0] : offsets[0] + sizes[0]] if offsets else tensor
            suffix = "_".join(str(o) for o in offsets)
            location = f"{storage_path_prefix}_{suffix}" if suffix else storage_path_prefix
            entry, reqs = ArrayIOPreparer.prepare_write(
                location, sub, streams, copy_cpu, replicated=replicated
            )
            chunks.append(Shard(offsets=list(offsets), sizes=list(sizes), array=entry))
            write_reqs.extend(reqs)
        entry = ChunkedArrayEntry(
            dtype=dtype_str, shape=list(tensor.shape), chunks=chunks, replicated=replicated
        )
        return entry, write_reqs

    @staticmethod
    def prepare_read(
        entry: ChunkedArrayEntry,
        dst: Optional[torch.Tensor],
        callback: Optional[Callable[[torch.Tensor], None]],
        streams: DeviceStreams,
    ) -> List[ReadReq]:
        if dst is None:
            dst = torch.empty(tuple(entry.shape), dtype=string_to_dtype(entry.dtype))
        remaining = [len(entry.chunks)]
        lock = threading.Lock()

        def part_done(_value: torch.Tensor) -> None:
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last and callback is not None:
                callback(dst)

        read_reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            region = dst[tuple(slice(o, o + s) for o, s in zip(chunk.offsets, chunk.sizes))]
            read_reqs.extend(
                ArrayIOPreparer.prepare_read(chunk.array, region, part_done, streams)
            )
        return read_reqs
