"""URL -> storage plugin resolution.

Counterpart of ``torchsnapshot_tpu/storage_plugin.py``: ``fs://`` paths and
bare paths resolve to the local filesystem plugin. ``storage_options``
with a ``mirror_url`` wraps the resolved primary in the two-tier
:class:`~.storage_plugins.mirror.MirroredStoragePlugin`, with the mirror's
own ``mirror_options``, ``mirror_backlog_bytes`` and ``mirror_strict``.
Other schemes (``s3://``, ``gs://``, entry-point plugins) are not ported
yet and raise an error that names them.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from .io_types import StoragePlugin


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
        check_storage_options(storage_options)
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
    raise NotImplementedError(
        f"storage protocol {protocol!r} (url: {url_path!r}) is not ported to "
        "torchsnapshot_tpu_torch yet; only fs:// and local paths are."
    )


def _split(url_path: str):
    if "://" in url_path:
        protocol, _, path = url_path.partition("://")
        return protocol, path
    return "fs", url_path


def check_storage_options(storage_options: Optional[Dict[str, Any]]) -> None:
    """Fail before any work on a ``mirror_url`` of a scheme that is not
    ported (only ``fs://`` and local paths are)."""
    mirror_url = (storage_options or {}).get("mirror_url")
    if mirror_url and _split(mirror_url)[0] not in ("fs", ""):
        raise NotImplementedError(
            f"storage_options mirror_url={mirror_url!r}: storage protocol "
            f"{_split(mirror_url)[0]!r} is not ported to torchsnapshot_tpu_torch yet; "
            "only fs:// and local paths are."
        )


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
