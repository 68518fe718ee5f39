"""Arbitrary-object preparer: pickled payloads.

Counterpart of ``torchsnapshot_tpu/io_preparers/object.py``. Objects can't
be restored in place, so the consumer reports the unpickled value through a
callback and the orchestrator puts it back into the state before inflating.
Under a dedup context (``dedup.py``) the pickled bytes' SHA-256 is recorded
and, when an incremental base holds the same bytes, the write is skipped
and the entry inherits the base's ``origin`` (object.py:98 of the JAX
package); reads follow ``origin``.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, List, Optional, Tuple

from ..dedup import active_dedup_context
from ..integrity import checksums_enabled, compute_checksum, verification_enabled, verify_checksum
from ..io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from ..manifest import ObjectEntry
from ..serialization import Serializer, object_as_bytes, object_from_bytes


class ObjectBufferStager(BufferStager):
    def __init__(self, obj: Any, entry: ObjectEntry) -> None:
        self.entry = entry
        # Pickled at planning time: the bytes are the staged copy, so
        # async_take's consistency point holds for mutable objects too, and
        # the staging cost is exact.
        self.payload = object_as_bytes(obj)
        self.dedup = active_dedup_context()
        self.io_skipped = False

    async def stage_buffer(self, executor=None) -> BufferType:
        buf, self.payload = self.payload, b""
        self.entry.size = len(buf)
        if self.dedup is not None and self.dedup.reuse_staged(self.entry, buf):
            self.io_skipped = True
        elif checksums_enabled():
            self.entry.checksum = compute_checksum(buf)
        return buf

    def get_staging_cost_bytes(self) -> int:
        return max(len(self.payload), 1024)


class ObjectBufferConsumer(BufferConsumer):
    def __init__(self, entry: ObjectEntry, callback: Optional[Callable[[Any], None]]) -> None:
        self.entry = entry
        self.callback = callback

    def _verify_and_load(self, buf: BufferType) -> Any:
        if self.entry.checksum is not None and verification_enabled():
            verify_checksum(buf, self.entry.checksum, self.entry.location)
        return object_from_bytes(buf)

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        loop = asyncio.get_running_loop()
        obj = await loop.run_in_executor(executor, self._verify_and_load, buf)
        if self.callback is not None:
            self.callback(obj)

    def get_consuming_cost_bytes(self) -> int:
        # ~2x: the unpickled object lives alongside the buffer.
        return max(2 * self.entry.size, 1024) if self.entry.size is not None else 1024


class ObjectIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str, obj: Any, replicated: bool = False
    ) -> Tuple[ObjectEntry, List[WriteReq]]:
        entry = ObjectEntry(
            location=storage_path,
            serializer=Serializer.PICKLE.value,
            obj_type=type(obj).__name__,
            replicated=replicated,
        )
        return entry, [WriteReq(path=storage_path, buffer_stager=ObjectBufferStager(obj, entry))]

    @staticmethod
    def prepare_read(
        entry: ObjectEntry, callback: Optional[Callable[[Any], None]]
    ) -> List[ReadReq]:
        if entry.codec is not None:
            raise NotImplementedError(
                f"{entry.location!r} is stored compressed (codec={entry.codec}); "
                "compression is not ported to torchsnapshot_tpu_torch yet."
            )
        return [
            ReadReq(
                path=entry.location,
                buffer_consumer=ObjectBufferConsumer(entry, callback),
                origin=entry.origin,
            )
        ]
