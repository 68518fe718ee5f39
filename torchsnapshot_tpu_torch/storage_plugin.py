"""URL -> storage plugin resolution.

Counterpart of ``torchsnapshot_tpu/storage_plugin.py``: ``fs://`` paths and
bare paths resolve to the local filesystem plugin, ``s3://`` to the S3
plugin, ``gs://`` and ``gcs://`` to the GCS plugin, and any other scheme to
a plugin registered under the entry-point group
:data:`ENTRY_POINT_GROUP` (the JAX package's group is
``torchsnapshot_tpu.storage_plugins``). ``storage_options`` with a
``mirror_url`` wraps the resolved primary in the two-tier
:class:`~.storage_plugins.mirror.MirroredStoragePlugin`, with the mirror's
own ``mirror_options``, ``mirror_backlog_bytes`` and ``mirror_strict``.
"""

from __future__ import annotations

import asyncio
from importlib.metadata import entry_points
from typing import Any, Dict, Optional

from .io_types import StoragePlugin

#: Third-party plugins register a factory ``(root, storage_options)`` under
#: this group, named by their URL scheme.
ENTRY_POINT_GROUP = "torchsnapshot_tpu_torch.storage_plugins"


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    if storage_options and storage_options.get("mirror_url"):
        from .snapshot import SNAPSHOT_METADATA_FNAME
        from .storage_plugins.mirror import DEFAULT_MIRROR_BACKLOG_BYTES, MirroredStoragePlugin

        opts = dict(storage_options)
        mirror_url = opts.pop("mirror_url")
        mirror_opts = opts.pop("mirror_options", None)
        backlog = opts.pop("mirror_backlog_bytes", DEFAULT_MIRROR_BACKLOG_BYTES)
        strict = opts.pop("mirror_strict", True)
        return MirroredStoragePlugin(
            primary=url_to_storage_plugin(url_path, opts or None),
            mirror=url_to_storage_plugin(mirror_url, mirror_opts),
            metadata_filename=SNAPSHOT_METADATA_FNAME,
            backlog_bytes=backlog,
            strict=strict,
        )
    protocol, path = _split(url_path)
    if protocol in ("fs", ""):
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path, storage_options=storage_options)
    if protocol == "s3":
        from .storage_plugins.s3 import S3StoragePlugin

        return S3StoragePlugin(root=path, storage_options=storage_options)
    if protocol in ("gs", "gcs"):
        from .storage_plugins.gcs import GCSStoragePlugin

        return GCSStoragePlugin(root=path, storage_options=storage_options)
    for ep in entry_points().select(group=ENTRY_POINT_GROUP):
        if ep.name == protocol:
            return ep.load()(root=path, storage_options=storage_options)
    raise RuntimeError(
        f"Failed to resolve storage plugin for protocol {protocol!r} (url: {url_path!r})."
    )


def _split(url_path: str):
    if "://" in url_path:
        protocol, _, path = url_path.partition("://")
        return protocol, path
    return "fs", url_path


def url_to_storage_plugin_in_event_loop(
    url_path: str,
    event_loop: asyncio.AbstractEventLoop,
    storage_options: Optional[Dict[str, Any]] = None,
) -> StoragePlugin:
    """``url_to_storage_plugin`` constructed inside ``event_loop``."""

    async def _construct() -> StoragePlugin:
        return url_to_storage_plugin(url_path, storage_options)

    return event_loop.run_until_complete(_construct())


def local_fs_root(url_path: str) -> Optional[str]:
    """The local directory behind ``url_path`` when it resolves to the
    filesystem plugin (``fs://`` or a bare path), else None
    (storage_plugin.py:76-84 of the JAX package)."""
    if url_path.startswith("fs://"):
        return url_path[len("fs://"):]
    return None if "://" in url_path else url_path


def strip_mirror_options(
    storage_options: Optional[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """Storage options for a different snapshot than the one they were
    given for: the mirror settings name that snapshot's mirror, which would
    be a wrong fallback root for a base or origin snapshot."""
    if not storage_options:
        return storage_options
    cleaned = {k: v for k, v in storage_options.items() if not k.startswith("mirror")}
    return cleaned or None
