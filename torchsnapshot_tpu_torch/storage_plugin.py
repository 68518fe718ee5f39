"""URL -> storage plugin resolution.

Counterpart of ``torchsnapshot_tpu/storage_plugin.py`` for this slice:
``fs://`` paths and bare paths resolve to the local filesystem plugin. Other
schemes (``s3://``, ``gs://``, mirrors, entry-point plugins) are not ported
yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .io_types import StoragePlugin


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    if "://" in url_path:
        protocol, _, path = url_path.partition("://")
    else:
        protocol, path = "fs", url_path
    if protocol in ("fs", ""):
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path, storage_options=storage_options)
    raise NotImplementedError(
        f"storage protocol {protocol!r} (url: {url_path!r}) is not ported to "
        "torchsnapshot_tpu_torch yet; only fs:// and local paths are."
    )

