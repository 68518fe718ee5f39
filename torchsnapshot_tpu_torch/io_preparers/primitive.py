"""Primitive preparer: int/float/str/bool/bytes/None inlined into the
metadata, zero storage I/O (counterpart of
``torchsnapshot_tpu/io_preparers/primitive.py``)."""

from __future__ import annotations

from typing import Any

from ..manifest import PrimitiveEntry

# str/bytes above this size take the object (storage I/O) path instead.
_MAX_INLINE_BYTES = 16 * 1024


class PrimitivePreparer:
    @staticmethod
    def should_inline(obj: Any) -> bool:
        if type(obj).__name__ not in PrimitiveEntry.supported_types():
            return False
        if isinstance(obj, (str, bytes)) and len(obj) > _MAX_INLINE_BYTES:
            return False
        return True

    @staticmethod
    def prepare_write(obj: Any, replicated: bool = False) -> PrimitiveEntry:
        return PrimitiveEntry.from_object(obj, replicated=replicated)
