"""The Snapshot orchestrator: take / async_take / restore / read_object.

Counterpart of ``torchsnapshot_tpu/snapshot.py`` for one process. An app
state is a ``Dict[str, Stateful]``; wrap raw dicts of tensors and values in
``StateDict``. Tensors may live on CUDA devices or on the CPU.

Commit protocol: ``.snapshot_metadata`` is written last, after every payload
write has completed (snapshot.py:26, :137 of the JAX package). A snapshot
without metadata is invisible, so a failed take never leaves a readable but
corrupt snapshot. The on-disk format is the JAX package's: either package
restores the other's snapshots.

``async_take`` returns once every entry is staged: each CUDA tensor's DtoH
copy into pinned memory has completed (its CUDA event has fired), and CPU
tensors are cloned. After it returns the caller may overwrite its tensors;
storage writes and the commit continue on a background thread.

Incremental takes (``dedup.py``): ``incremental_base`` names a previous
snapshot, and every payload whose content equals the base's at the same
location is not written; its entry records the ``origin`` that holds the
bytes, and restore reads it from there (reads are grouped by origin).
``record_digests`` records the digests a later take matches against.
``device_digests`` (or ``TORCHSNAPSHOT_GPU_DEVICE_DIGESTS=1``) compares
fingerprints of the tensors (``device_digest.py``, kernel K4 on CUDA)
before any copy, so an unchanged CUDA tensor is neither copied to the host
nor written; on restore, a destination that already holds a payload's
content skips the read and the host-to-device copy. ``save_dtype`` maps
logical-path globs to a stored dtype: matching tensors are cast (on their
device) before staging, so fewer bytes cross to the host.

Not ported yet. Each of these raises an error that names it:

- the env knobs in :data:`UNPORTED_ENV_KNOBS` (journal, geo-replication,
  lazy page-in, fleet seeding, tenancy, resharding, the columnar manifest,
  compression, write batching and the flight recorder), when set to a
  value that turns their feature on;
- the ``compression`` argument;
- a process group, or an initialized ``torch.distributed`` world, of more
  than one process.
"""

from __future__ import annotations

import asyncio
import fnmatch
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from .dedup import DedupContext, canonical_base_url, dedup_staging
from .device_digest import enabled_by_env as device_digests_env
from .flatten import flatten, inflate
from .io_preparers import (
    ChunkedArrayIOPreparer,
    DeviceStreams,
    PrimitivePreparer,
    get_storage_path,
    prepare_read,
    prepare_write,
)
from .io_preparers.array import fingerprint_stagers
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .manifest import (
    CorruptSnapshotError,
    Manifest,
    PrimitiveEntry,
    SnapshotMetadata,
    get_available_entries,
    get_manifest_for_rank,
    is_container_entry,
)
from .rng_state import RNGState
from .serialization import effective_save_dtype, string_to_dtype
from .scheduler import (
    PendingIOWork,
    execute_write_reqs,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
)
from .stateful import AppState, Stateful
from .storage_plugin import url_to_storage_plugin
from .version import __version__

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"

# Env knobs of features of the JAX package that this port does not have
# yet, under the port's own prefix.
UNPORTED_ENV_KNOBS = (
    "TORCHSNAPSHOT_GPU_JOURNAL",
    "TORCHSNAPSHOT_GPU_GEOREP",
    "TORCHSNAPSHOT_GPU_LAZY_RESTORE",
    "TORCHSNAPSHOT_GPU_SEED_RESTORE",
    "TORCHSNAPSHOT_GPU_TENANT",
    "TORCHSNAPSHOT_GPU_RESHARD",
    "TORCHSNAPSHOT_GPU_MANIFEST_FORMAT",
    "TORCHSNAPSHOT_GPU_COMPRESSION",
    "TORCHSNAPSHOT_GPU_ENABLE_BATCHING",
    "TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM",
)
_OFF_VALUES = ("", "0", "false", "off", "no", "never", "json")


def _check_unported(pg: Any, **features: Any) -> None:
    for name in UNPORTED_ENV_KNOBS:
        value = os.environ.get(name, "").strip().lower()
        if value not in _OFF_VALUES:
            raise NotImplementedError(
                f"{name}={os.environ[name]!r}: this feature is not ported to "
                "torchsnapshot_tpu_torch yet; unset it."
            )
    for name, value in features.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r}: this feature is not ported to "
                "torchsnapshot_tpu_torch yet."
            )
    world = 1
    if pg is not None:
        world = pg.size() if hasattr(pg, "size") else pg.get_world_size()
    elif torch.distributed.is_available() and torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
    if world > 1:
        raise NotImplementedError(
            f"a world of {world} processes: multi-process snapshots are not "
            "ported to torchsnapshot_tpu_torch yet."
        )


def _validate_save_dtype(save_dtype: Optional[Dict[str, str]]) -> None:
    """Fail on a malformed ``save_dtype`` before any work: a typo such as
    "bf16" would otherwise surface mid-take."""
    for pattern, dt in (save_dtype or {}).items():
        try:
            string_to_dtype(dt)
        except ValueError:
            raise ValueError(
                f"save_dtype[{pattern!r}]: unknown dtype name {dt!r} (use numpy-style "
                'names like "bfloat16", "float32", "float8_e4m3fn", "int32").'
            ) from None


def _convert_save_dtypes(flattened: Dict[str, Any], save_dtype: Dict[str, str]) -> int:
    """Cast matching tensor leaves in ``flattened`` before write planning,
    so the device-to-host copy, the checksum and storage all move the
    converted (usually narrower) bytes. A CUDA tensor is cast on its device,
    on the caller's current stream, which the staging side stream waits on.
    The decision (first matching glob, dtype-class rules) is
    ``serialization.effective_save_dtype``. Returns the bytes elided
    (snapshot.py:2307-2400 of the JAX package). The converted copies stay on
    the device until staging drains them."""
    saved = 0
    for lp, obj in flattened.items():
        if not isinstance(obj, torch.Tensor):
            continue
        target = effective_save_dtype(lp, obj.dtype, save_dtype)
        if target is not None:
            converted = obj.detach().to(target)
            saved += obj.numel() * (obj.element_size() - converted.element_size())
            flattened[lp] = converted
    return saved


def _validate_app_state(app_state: AppState) -> None:
    for key, value in app_state.items():
        if not isinstance(value, Stateful):
            raise TypeError(
                f"App state entry {key!r} (type {type(value).__name__}) does not "
                "implement state_dict()/load_state_dict(). Wrap raw state in "
                "torchsnapshot_tpu_torch.StateDict."
            )


class Snapshot:
    """A handle to a snapshot at ``path`` (``fs://`` or a bare path)."""

    def __init__(
        self,
        path: str,
        pg: Any = None,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.path = path
        self.pg = pg
        self._storage_options = storage_options
        self._metadata: Optional[SnapshotMetadata] = None

    # ------------------------------------------------------------------ take

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        pg: Any = None,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        incremental_base: Optional[str] = None,
        record_digests: bool = False,
        compression: Optional[str] = None,
        save_dtype: Optional[Dict[str, str]] = None,
        device_digests: Optional[bool] = None,
    ) -> "Snapshot":
        """Persist ``app_state`` at ``path`` and return once committed.
        ``replicated`` globs mark logical paths as replicated (stored under
        ``replicated/``, restorable by any rank). See the module docstring
        for ``incremental_base``, ``record_digests``, ``device_digests`` and
        ``save_dtype``."""
        _validate_app_state(app_state)
        _check_unported(pg, compression=compression)
        _validate_save_dtype(save_dtype)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path, storage_options)
        try:
            # A blocking take may stage CPU tensors without copying them.
            pending_io_work, metadata = cls._take_impl(
                app_state, replicated or [], storage, event_loop, copy_cpu=False,
                incremental_base=incremental_base, record_digests=record_digests,
                device_digests=device_digests, save_dtype=save_dtype,
                storage_options=storage_options,
            )
            pending_io_work.sync_complete(event_loop)
            cls._write_snapshot_metadata(metadata, storage, event_loop)
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()
        snapshot = cls(path, pg, storage_options)
        snapshot._metadata = metadata
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        pg: Any = None,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        incremental_base: Optional[str] = None,
        record_digests: bool = False,
        compression: Optional[str] = None,
        save_dtype: Optional[Dict[str, str]] = None,
        device_digests: Optional[bool] = None,
    ) -> "PendingSnapshot":
        """Non-blocking take. Returns once every entry is staged; after
        that, mutating the app state does not affect the snapshot. Storage
        writes and the metadata commit continue on a background thread;
        ``.wait()`` on the returned handle joins them. Fingerprints and
        digests are recorded and compared before it returns, on the bytes
        the caller had at the call."""
        _validate_app_state(app_state)
        _check_unported(pg, compression=compression)
        _validate_save_dtype(save_dtype)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path, storage_options)
        try:
            pending_io_work, metadata = cls._take_impl(
                app_state, replicated or [], storage, event_loop, copy_cpu=True,
                incremental_base=incremental_base, record_digests=record_digests,
                device_digests=device_digests, save_dtype=save_dtype,
                storage_options=storage_options,
            )
        except BaseException:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()
            raise
        return PendingSnapshot(
            path, pg, storage_options, pending_io_work, metadata, storage, event_loop
        )

    @classmethod
    def _take_impl(
        cls,
        app_state: AppState,
        replicated: List[str],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        copy_cpu: bool,
        incremental_base: Optional[str] = None,
        record_digests: bool = False,
        device_digests: Optional[bool] = None,
        save_dtype: Optional[Dict[str, str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
    ):
        rank = 0
        app_state = dict(app_state)
        dedup_ctx = cls._dedup_context(
            incremental_base, record_digests, device_digests, storage_options
        )
        # RNG invariant: RNG state is captured at entry and re-applied
        # after, so taking a snapshot never perturbs the RNG streams.
        rng_captured = {
            key: stateful.state_dict()
            for key, stateful in app_state.items()
            if isinstance(stateful, RNGState)
        }
        try:
            manifest: Manifest = {}
            flattened: Dict[str, Any] = {}
            for key in sorted(app_state):
                sd = rng_captured.get(key)
                if sd is None:
                    sd = app_state[key].state_dict()
                key_manifest, key_flattened = flatten(sd, prefix=key)
                manifest.update(key_manifest)
                flattened.update(key_flattened)

            if save_dtype:
                elided = _convert_save_dtypes(flattened, save_dtype)
                if elided:
                    logger.info("save_dtype downcast elided %.1f MB before staging", elided / 1e6)

            streams = DeviceStreams()
            write_reqs: List[WriteReq] = []
            # Stagers capture the dedup context at construction.
            with dedup_staging(dedup_ctx):
                for logical_path in sorted(flattened):
                    obj = flattened[logical_path]
                    is_repl = any(fnmatch.fnmatch(logical_path, g) for g in replicated)
                    storage_path = get_storage_path(logical_path, rank, replicated=is_repl)
                    if isinstance(obj, torch.Tensor):
                        entry, reqs = ChunkedArrayIOPreparer.prepare_write(
                            storage_path, obj, streams, copy_cpu, replicated=is_repl
                        )
                    elif PrimitivePreparer.should_inline(obj):
                        entry, reqs = PrimitivePreparer.prepare_write(obj, is_repl), []
                    else:
                        entry, reqs = prepare_write(obj, logical_path, rank, is_repl)
                    manifest[logical_path] = entry
                    write_reqs.extend(reqs)
            if dedup_ctx is not None and dedup_ctx.device_digests:
                fingerprint_stagers(req.buffer_stager for req in write_reqs)

            pending_io_work = event_loop.run_until_complete(
                execute_write_reqs(
                    write_reqs, storage, get_process_memory_budget_bytes(), rank
                )
            )
            global_manifest: Manifest = {
                (f"{rank}/{lp}" if lp else str(rank)): entry
                for lp, entry in manifest.items()
            }
            metadata = SnapshotMetadata(
                version=__version__, world_size=1, manifest=global_manifest
            )
            return pending_io_work, metadata
        finally:
            for key, sd in rng_captured.items():
                app_state[key].load_state_dict(sd)

    @classmethod
    def _dedup_context(
        cls,
        incremental_base: Optional[str],
        record_digests: bool,
        device_digests: Optional[bool],
        storage_options: Optional[Dict[str, Any]],
    ) -> Optional[DedupContext]:
        """The take's dedup context (snapshot.py:518-590 of the JAX
        package): the base's payload index when ``incremental_base`` is
        given (pinned to its canonical URL, since origins are resolved from
        other working directories later), a recording-only context for
        ``record_digests`` or ``device_digests`` alone, else None."""
        if device_digests is None:
            device_digests = device_digests_env()
        if incremental_base is not None:
            incremental_base = canonical_base_url(incremental_base)
            base_meta = cls(incremental_base, storage_options=storage_options).metadata
            ctx = DedupContext.from_base(
                incremental_base, base_meta, device_digests=device_digests
            )
            if not ctx.refs:
                logger.warning(
                    "incremental_base %s has no content digests (take it with "
                    "record_digests=True); every payload will be rewritten.",
                    incremental_base,
                )
            return ctx
        if record_digests or device_digests:
            # Fingerprints must land in this snapshot's manifest for the next
            # take to match against.
            return DedupContext.recording_only(device_digests=device_digests)
        return None

    @staticmethod
    def _write_snapshot_metadata(
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        """The commit point."""
        raw = metadata.to_yaml().encode("utf-8")
        event_loop.run_until_complete(
            storage.write(WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=raw))
        )

    # --------------------------------------------------------------- restore

    def restore(self, app_state: AppState, device_digests: Optional[bool] = None) -> None:
        """Restore the app state in place. Tensors are restored into the
        shapes, dtypes and devices of the current state; a snapshot dtype
        that differs is cast to the destination's (``same_kind`` only).
        With ``device_digests`` (default: ``TORCHSNAPSHOT_GPU_DEVICE_DIGESTS``)
        a destination tensor whose fingerprint equals the entry's recorded
        one is kept as it is: no read, no copy."""
        _validate_app_state(app_state)
        _check_unported(self.pg)
        if device_digests is None:
            device_digests = device_digests_env()
        rank = 0
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path, self._storage_options)
        try:
            metadata = self._read_metadata(storage, event_loop)
            available = get_manifest_for_rank(metadata, rank)
            budget = get_process_memory_budget_bytes()
            # RNG states restore last so earlier loads can't perturb them.
            keys = sorted(app_state)
            keys = [k for k in keys if not isinstance(app_state[k], RNGState)] + [
                k for k in keys if isinstance(app_state[k], RNGState)
            ]
            for key in keys:
                dest = app_state[key].state_dict()
                flattened = flatten(dest, prefix=key)[1]
                # Fresh side streams per key: each orders after whatever the
                # caller's stream holds by then, including device work that
                # earlier keys' load_state_dict() queued.
                read_reqs = self._plan_reads(
                    flattened, available, metadata, DeviceStreams(), device_digests
                )
                self._execute_grouped(read_reqs, storage, budget, event_loop)
                container_manifest = {
                    p: e
                    for p, e in available.items()
                    if is_container_entry(e) and (p == key or p.startswith(f"{key}/"))
                }
                app_state[key].load_state_dict(
                    inflate(container_manifest, flattened, prefix=key, dest=dest)
                )
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()

    @staticmethod
    def _plan_reads(
        flattened: Dict[str, Any],
        available: Manifest,
        metadata: SnapshotMetadata,
        streams: DeviceStreams,
        device_digests: bool = False,
    ) -> List[ReadReq]:
        read_reqs: List[ReadReq] = []
        for logical_path, obj in flattened.items():
            entry = available.get(logical_path)
            if entry is None:
                raise RuntimeError(
                    f"Unable to find entry for {logical_path!r} in the snapshot "
                    f"(saved with world size {metadata.world_size})."
                )
            if is_container_entry(entry):
                raise RuntimeError(
                    f"Structure mismatch restoring {logical_path!r}: the destination "
                    f"has a leaf there, but the snapshot saved a container "
                    f"({type(entry).__name__})."
                )
            if isinstance(entry, PrimitiveEntry):
                flattened[logical_path] = entry.get_value()
                continue

            def _cb(value: Any, lp: str = logical_path) -> None:
                flattened[lp] = value

            read_reqs.extend(prepare_read(entry, obj, _cb, streams, device_digests))
        return read_reqs

    @staticmethod
    def _group_read_reqs(read_reqs: List[ReadReq]) -> List[Tuple[Optional[str], List[ReadReq]]]:
        """Reads grouped by the snapshot that holds their payload, this one
        first, then origins sorted (snapshot.py:1716-1758 of the JAX
        package, without its batching and priority classes)."""
        groups: Dict[Optional[str], List[ReadReq]] = {}
        for rr in read_reqs:
            groups.setdefault(rr.origin, []).append(rr)
        return sorted(groups.items(), key=lambda kv: (kv[0] is not None, kv[0] or ""))

    def _execute_grouped(
        self,
        read_reqs: List[ReadReq],
        storage: StoragePlugin,
        budget: int,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        """Run the reads, each group through a storage plugin opened on its
        origin (this snapshot's own plugin for the local group)."""
        for origin, reqs in self._group_read_reqs(read_reqs):
            if origin is None:
                sync_execute_read_reqs(reqs, storage, budget, 0, event_loop)
                continue
            origin_storage = url_to_storage_plugin(origin, self._storage_options)
            try:
                sync_execute_read_reqs(reqs, origin_storage, budget, 0, event_loop)
            finally:
                origin_storage.sync_close(event_loop)

    def read_object(self, path: str, obj_out: Any = None) -> Any:
        """Random-access read of one entry by manifest path
        (``"RANK/logical/path"``). A tensor ``obj_out`` is filled in place."""
        rank_str, _, logical_path = path.partition("/")
        if not rank_str.isdigit() or not logical_path:
            raise RuntimeError(
                f"read_object path must look like 'RANK/logical/path', got {path!r}."
            )
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path, self._storage_options)
        try:
            metadata = self._read_metadata(storage, event_loop)
            available = get_available_entries(metadata.manifest, int(rank_str))
            if logical_path not in available:
                raise RuntimeError(
                    f"{path!r} is not a valid entry in the snapshot "
                    f"(world size {metadata.world_size})."
                )
            entry = available[logical_path]
            if isinstance(entry, PrimitiveEntry):
                return entry.get_value()
            box: List[Any] = [obj_out]

            def _cb(value: Any) -> None:
                box[0] = value

            read_reqs = prepare_read(entry, obj_out, _cb, DeviceStreams())
            self._execute_grouped(
                read_reqs, storage, get_process_memory_budget_bytes(), event_loop
            )
            return box[0]
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()

    # -------------------------------------------------------------- metadata

    def get_manifest(self) -> Manifest:
        return dict(self.metadata.manifest)

    @property
    def metadata(self) -> SnapshotMetadata:
        if self._metadata is None:
            event_loop = asyncio.new_event_loop()
            storage = url_to_storage_plugin(self.path, self._storage_options)
            try:
                self._metadata = self._read_metadata(storage, event_loop)
            finally:
                try:
                    storage.sync_close(event_loop)
                finally:
                    event_loop.close()
        return self._metadata

    def _read_metadata(
        self, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
    ) -> SnapshotMetadata:
        read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        event_loop.run_until_complete(storage.read(read_io))
        raw = bytes(read_io.buf)
        if not raw.strip():
            raise CorruptSnapshotError(self.path, "zero-byte metadata file")
        if raw[:4] == b"TSCM":
            raise NotImplementedError(
                f"{self.path!r} has a columnar (TSCM) manifest, which is not ported "
                "to torchsnapshot_tpu_torch yet."
            )
        try:
            return SnapshotMetadata.from_yaml(raw.decode("utf-8"))
        except Exception as e:  # noqa: BLE001 - any decode failure
            raise CorruptSnapshotError(
                self.path, f"undecodable metadata: {type(e).__name__}: {e}"
            ) from e


class PendingSnapshot:
    """Handle to an in-flight ``async_take``: a background thread drains
    the storage writes, then commits the metadata."""

    def __init__(
        self,
        path: str,
        pg: Any,
        storage_options: Optional[Dict[str, Any]],
        pending_io_work: PendingIOWork,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        self.path = path
        self._exc: Optional[BaseException] = None
        self._snapshot = Snapshot(path, pg, storage_options)
        self._snapshot._metadata = metadata
        self._thread = threading.Thread(
            target=self._complete,
            args=(pending_io_work, metadata, storage, event_loop),
            name="tsnap-gpu-commit",
            daemon=True,
        )
        self._thread.start()

    def _complete(
        self,
        pending_io_work: PendingIOWork,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        try:
            pending_io_work.sync_complete(event_loop)
            Snapshot._write_snapshot_metadata(metadata, storage, event_loop)
        except BaseException as e:  # noqa: B036 - re-raised by wait()
            self._exc = e
            logger.exception("async_take failed; the snapshot was not committed.")
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()

    def wait(self) -> Snapshot:
        """Block until the snapshot is committed; re-raises any failure."""
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._snapshot

    def done(self) -> bool:
        return not self._thread.is_alive()
