from .array import DeviceStreams
from .chunked import ChunkedArrayIOPreparer
from .primitive import PrimitivePreparer
from .prepare import get_storage_path, prepare_read, prepare_write

__all__ = [
    "ChunkedArrayIOPreparer",
    "DeviceStreams",
    "PrimitivePreparer",
    "get_storage_path",
    "prepare_read",
    "prepare_write",
]
