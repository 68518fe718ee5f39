"""URL -> storage plugin resolution.

Counterpart of ``torchsnapshot_tpu/storage_plugin.py`` for this slice:
``fs://`` paths and bare paths resolve to the local filesystem plugin. Other
schemes (``s3://``, ``gs://``, entry-point plugins) and a ``mirror_url`` in
``storage_options`` are not ported yet and raise an error that names them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .io_types import StoragePlugin


def check_storage_options(storage_options: Optional[Dict[str, Any]]) -> None:
    """Raise on an option of a tier that is not ported: ``mirror_url``."""
    if storage_options and storage_options.get("mirror_url"):
        raise NotImplementedError(
            f"storage_options mirror_url={storage_options['mirror_url']!r}: the "
            "mirror tier is not ported to torchsnapshot_tpu_torch yet."
        )


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    check_storage_options(storage_options)
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



def local_fs_root(url_path: str) -> Optional[str]:
    """The local directory behind ``url_path`` when it resolves to the
    filesystem plugin (``fs://`` or a bare path), else None
    (storage_plugin.py:76-84 of the JAX package)."""
    if url_path.startswith("fs://"):
        return url_path[len("fs://"):]
    return None if "://" in url_path else url_path
