"""Tensor <-> bytes codecs with the JAX package's dtype-string table.

Counterpart of ``torchsnapshot_tpu/serialization.py``. The dtype strings
are the on-disk contract: for every dtype both packages support, the port
writes exactly the string the JAX package writes (its numpy table at
serialization.py:57-79 and the ml_dtypes table above it).

Bytes move through a ``uint8`` view of the tensor, never through
``Tensor.numpy()`` of the tensor itself: numpy has no view of ``bfloat16``
or the float8 types. Sub-byte integer types (``int4``, ``uint4``, ``int2``,
``uint2``) use one byte per element in both packages.

Six ml_dtypes have no torch dtype: ``float8_e4m3``, ``float8_e4m3b11_fnuz``,
``float8_e3m4``, ``float4_e2m1fn``, ``float6_e2m3fn`` and ``float6_e3m2fn``.
The port refuses them by name (:class:`UnsupportedDtypeError`) rather than
restoring a raw byte view. torch's ``float4_e2m1fn_x2`` packs two values per
byte, so it is not the ml_dtypes layout and is not mapped.

Arbitrary Python objects are pickled, as in the JAX package.
"""

from __future__ import annotations

import fnmatch
import io
import pickle
from enum import Enum
from typing import Any, Dict, Optional, Sequence

import torch

_TORCH_DTYPE_NAMES = [
    "float16",
    "float32",
    "float64",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "bool",
    "complex64",
    "complex128",
    "bfloat16",
    "float8_e4m3fn",
    "float8_e4m3fnuz",
    "float8_e5m2",
    "float8_e5m2fnuz",
    "float8_e8m0fnu",
    "int4",
    "uint4",
    "int2",
    "uint2",
]

# ml_dtypes names the JAX package can write that torch cannot hold.
TORCH_MISSING_DTYPE_STRINGS = frozenset(
    {
        "float8_e4m3",
        "float8_e4m3b11_fnuz",
        "float8_e3m4",
        "float4_e2m1fn",
        "float6_e2m3fn",
        "float6_e3m2fn",
    }
)

STRING_TO_DTYPE: Dict[str, torch.dtype] = {
    name: getattr(torch, name) for name in _TORCH_DTYPE_NAMES if hasattr(torch, name)
}
DTYPE_TO_STRING: Dict[torch.dtype, str] = {d: n for n, d in STRING_TO_DTYPE.items()}
SUPPORTED_DTYPE_STRINGS = frozenset(STRING_TO_DTYPE)


class UnsupportedDtypeError(ValueError):
    """A snapshot entry's dtype has no torch counterpart."""


class Serializer(Enum):
    BUFFER_PROTOCOL = "buffer_protocol"
    PICKLE = "pickle"


def dtype_to_string(dtype: torch.dtype) -> str:
    try:
        return DTYPE_TO_STRING[dtype]
    except KeyError:
        raise ValueError(f"Unsupported dtype for serialization: {dtype}") from None


def string_to_dtype(s: str) -> torch.dtype:
    try:
        return STRING_TO_DTYPE[s]
    except KeyError:
        pass
    if s in TORCH_MISSING_DTYPE_STRINGS or s in _TORCH_DTYPE_NAMES:
        raise UnsupportedDtypeError(
            f"Snapshot dtype {s!r} has no torch dtype; the PyTorch port refuses "
            f"to restore {s!r} entries into tensors."
        )
    raise ValueError(
        f"Unknown dtype string {s!r} in snapshot metadata. "
        "The snapshot may have been written by a newer version."
    )


def dtype_size_bytes(s: str) -> int:
    return string_to_dtype(s).itemsize


def array_size_bytes(shape: Sequence[int], dtype_str: str) -> int:
    n = 1
    for dim in shape:
        n *= int(dim)
    return n * dtype_size_bytes(dtype_str)


_KIND_RANK = {"bool": 0, "uint": 1, "int": 2, "float": 3, "complex": 4}


def _kind(dtype: torch.dtype) -> str:
    if dtype == torch.bool:
        return "bool"
    if dtype.is_complex:
        return "complex"
    if dtype.is_floating_point:
        return "float"
    name = DTYPE_TO_STRING.get(dtype, str(dtype))
    return "uint" if name.startswith("uint") else "int"


def can_cast_same_kind(src: torch.dtype, dst: torch.dtype) -> bool:
    """numpy's ``same_kind`` rule by kind: bool < uint < int < float <
    complex, casting only to the same or a higher kind (float->int and
    int->uint refuse). Within the float kind every cast is allowed,
    including bfloat16 and float8 both ways."""
    return _KIND_RANK[_kind(dst)] >= _KIND_RANK[_kind(src)]


def _dtype_class(dtype: torch.dtype) -> str:
    """"float" (float and complex), "int" (signed and unsigned) or "bool":
    the classes of the JAX package's ``_dtype_class`` (by numerical
    behaviour)."""
    kind = _kind(dtype)
    return {"complex": "float", "uint": "int"}.get(kind, kind)


def effective_save_dtype(
    logical_path: str, src_dtype: torch.dtype, save_dtype: Dict[str, str]
) -> Optional[torch.dtype]:
    """The dtype ``save_dtype`` stores ``logical_path`` as, or None for "as
    is" (serialization.py:132-164 of the JAX package). The first matching
    glob decides, even as a no-op. A cast applies only within one dtype
    class (float to float, int to int) and only where ``same_kind`` allows
    it: an int leaf under a float glob stays int, since a float-stored int
    could never restore into its int destination."""
    for pattern, dt in save_dtype.items():
        if not fnmatch.fnmatch(logical_path, pattern):
            continue
        target = string_to_dtype(dt)
        if (
            target != src_dtype
            and _dtype_class(src_dtype) == _dtype_class(target)
            and _dtype_class(src_dtype) in ("float", "int")
            and can_cast_same_kind(src_dtype, target)
        ):
            return target
        return None
    return None


def tensor_as_memoryview(t: torch.Tensor) -> memoryview:
    """Zero-copy byte view of a contiguous CPU tensor of any supported dtype."""
    if t.device.type != "cpu":
        raise ValueError(f"tensor_as_memoryview takes a CPU tensor, got {t.device}")
    if not t.is_contiguous():
        t = t.contiguous()
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def tensor_from_buffer(buf: Any, dtype_str: str, shape: Sequence[int]) -> torch.Tensor:
    """CPU tensor over serialized bytes (zero-copy when ``buf`` is writable)."""
    dtype = string_to_dtype(dtype_str)
    mv = memoryview(buf).cast("B")
    expected = array_size_bytes(shape, dtype_str)
    if mv.nbytes != expected:
        raise IOError(
            f"payload holds {mv.nbytes} bytes, expected {expected} for "
            f"{dtype_str}{list(shape)}"
        )
    if mv.nbytes == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    if mv.readonly:
        mv = memoryview(bytearray(mv))
    return torch.frombuffer(mv, dtype=torch.uint8).view(dtype).reshape(tuple(shape))


def object_as_bytes(obj: Any) -> bytes:
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def object_from_bytes(buf: Any) -> Any:
    return pickle.loads(bytes(buf) if isinstance(buf, memoryview) else buf)
