"""The Snapshot orchestrator: take / async_take / restore / async_restore /
read_object / read_state_dict.

Counterpart of ``torchsnapshot_tpu/snapshot.py``. An app state is a
``Dict[str, Stateful]``; wrap raw dicts of tensors and values in
``StateDict``. Tensors may live on CUDA devices or on the CPU, and may be
DTensors.

Worlds of several processes (one process a device). Coordination runs over
the store of ``pg_wrapper`` (``pg=``, else the default group), never over a
``torch.distributed`` collective. A take gathers the app-state keys,
materializes each key's state in lockstep (a barrier a key), plans its
writes, plants the commit fence on rank 0, stages, gathers every rank's
manifest (with its staging error, so a failure on any rank aborts every
rank) and commits on rank 0 between two barriers. Paths matched by
``replicated`` globs, and DTensors that are fully ``Replicate`` over every
process (auto-detected), are replicated: verified identical across ranks,
stored once under ``replicated/``, their chunks and objects striped over
the ranks by a greedy size-balanced partition that every rank computes
alike. A sharded DTensor is stored piece-wise under ``sharded/``
(``io_preparers/sharded.py``): every distinct box written once, by an
elected holder. A restore reads the keys in lockstep, RNG states last, and
fills each destination in its own layout: a sharded entry restores into a
DTensor of any mesh and placements, into a plain tensor, or into a world
of another size, and a plain entry into a DTensor. A world of several
processes first agrees, in one all-gather, on three elections: device
digests, cooperative fan-out (``fanout.py``,
``TORCHSNAPSHOT_GPU_COOP_RESTORE``) and the planned reshard
(``reshard.py``, ``TORCHSNAPSHOT_GPU_RESHARD``). With device digests each
sharded destination is verified across processes by summing K4's partial
fingerprints of the regions each rank was elected for
(:meth:`Snapshot._distributed_preverify`): a verified destination reads no
payload byte. Under fan-out a unit that several ranks read is read once,
by an owner, and forwarded to the others over the peer channel; under the
planned reshard a saved piece that several ranks' shards meet is read
once, and each other rank receives only its regions. Any peer failure
reads that one entry from storage.

Commit protocol: ``.snapshot_metadata`` is written last, after every payload
write has completed (snapshot.py:26, :137 of the JAX package). A snapshot
without metadata is invisible, so a failed take never leaves a readable but
corrupt snapshot. The on-disk format is the JAX package's: either package
restores the other's snapshots.

Commit fence (:data:`SNAPSHOT_FENCE_FNAME`, snapshot.py:138-166 and
:1952-2052 of the JAX package): before any payload I/O, and before
``async_take`` returns, a take writes ``.snapshot_fence`` holding a fresh
generation token (JSON ``gen``, ``pid``, ``version``, as the JAX package
writes it, so a fence of either package reads in the other). The commit
point re-reads it and commits only if it still holds this take's token,
then deletes it; otherwise it raises :class:`StaleCommitError` and writes
nothing. A straggler whose partial directory was reclaimed (the manager's
GC) therefore cannot splice its metadata over a newer take of the path.

``async_restore`` runs ``restore`` on a background thread; see
:class:`PendingRestore` for its CUDA ordering and consistency point.
``read_object(memory_budget_bytes=)`` reads a tensor entry in byte ranges
under the budget (unverified, as in the JAX package); ``read_state_dict``
materializes a snapshot with no destination, tensors as CPU tensors.

``async_take`` returns once every entry is staged: each CUDA tensor's DtoH
copy into pinned memory has completed (its CUDA event has fired), and CPU
tensors are cloned. After it returns the caller may overwrite its tensors;
storage writes and the commit continue on a background thread.

Streaming (``scheduler.py``): a blocking ``take`` streams each large plain
payload (``TORCHSNAPSHOT_GPU_STREAM_WRITES``, default on) in sub-chunks
whose size the I/O governor elects, so a payload's staging and its write
overlap; ``async_take`` never streams, since its consistency point is the
end of staging. ``restore`` streams reads under
``TORCHSNAPSHOT_GPU_STREAM_READS``. A streamed snapshot is byte-identical
to a buffered one. With device digests from the environment (not asked for
by the caller), restore fingerprints its destinations only when the
governor's preverify gate says hashing is cheaper than reading
(snapshot.py:1467-1515 of the JAX package), probing the device hash rate
once a process (``device_digest.probe_hash_throughput``).

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

``compression`` (or ``TORCHSNAPSHOT_GPU_COMPRESSION``) names a codec that
payloads are stored under (``compression.py``); restore decodes whatever
codec each entry records. ``TORCHSNAPSHOT_GPU_ENABLE_BATCHING=1`` packs
small tensor payloads into shared slab files (``batcher.py``,
snapshot.py:696-704 of the JAX package); restore merges ranged reads of
one file (snapshot.py:1751-1756) whether the take batched or not.

Durability (snapshot.py:171-177, :550-582, :1212-1243, :1786-1844 and
:2029-2034 of the JAX package): ``storage_options={"mirror_url": ...}``
writes a second tier in the background (``storage_plugins/mirror.py``);
the take drains it before its commit barrier, records ``mirror_url`` and
the origins' mirrors (transitively) in the metadata, and a strict
mirror's failure surfaces from the take. Origins read through their own
mirrors. ``TORCHSNAPSHOT_GPU_MANIFEST_FORMAT=columnar`` commits the
columnar TSCM metadata (``colmanifest.py``), which the reader sniffs. A
restore replays the committed delta journal (``journal.maybe_replay``)
at one fixed point of every rank, and counts a restore from a
geo-replicated copy (``georep.py``) as ``dr_replica_restores``.

The fleet tier (snapshot.py:281, :436, :907-925 of the JAX package): a
tenant's take and restore arm its admission share
(``tenancy/admission.py``), under ``TORCHSNAPSHOT_GPU_SEED_RESTORE`` a
restore reads shareable chunks through the seeding tier (``distrib.py``),
and under ``TORCHSNAPSHOT_GPU_LAZY_RESTORE`` ``restore(hot=)`` returns a
page-in session with the hot set resident (``pagein.py``).

The planes of every take and restore (snapshot.py:264-284, :2096-2250
of the JAX package): the governor warm-starts from the root's learned
profiles (``scheduler.preload_profiles``) and, after the merge, scores the
op's critical-path verdict (``IOGovernor.observe_verdict``); the stall
watchdog (``telemetry.forensics``) is armed beside the heartbeat; the
``/metrics`` endpoint starts under ``TORCHSNAPSHOT_GPU_METRICS_PORT``; a
take writes ``.snapshot_critpath`` and its history record carries the
binding.
"""

from __future__ import annotations

import asyncio
import contextlib
import fnmatch
import json
import logging
import math
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .batcher import batch_read_requests, batch_write_requests, batching_enabled
from .compression import compression_staging, env_codec, resolve_codec
from .dedup import DedupContext, canonical_base_url, dedup_staging
from .device_digest import enabled_by_env as device_digests_env
from . import georep, journal
from . import reshard as reshard_mod
from .fanout import CoopRestoreSession, greedy_size_balanced
from . import faultinject
from .tenancy import admission as tenancy_admission
from .dist_store import DEFAULT_BARRIER_TIMEOUT_S, LinearBarrier
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
from .io_preparers.prepare import (
    is_dtensor,
    is_process_replicated_dtensor,
    is_sharded_dtensor,
)
from .io_preparers.sharded import ShardedArrayIOPreparer, dtensor_view
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .layout import resolve_layout
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    CorruptSnapshotError,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
    SnapshotMetadata,
    get_available_entries,
    get_manifest_for_rank,
    is_container_entry,
)
from .pg_wrapper import PGWrapper
from .rng_state import RNGState
from .serialization import (
    Serializer,
    array_size_bytes,
    dtype_to_string,
    effective_save_dtype,
    string_to_dtype,
)
from .scheduler import (
    PendingIOWork,
    execute_write_reqs,
    get_process_memory_budget_bytes,
    io_governor,
    preverify_mode,
    sync_execute_read_reqs,
)
from .state_dict import StateDict
from .stateful import AppState, Stateful
from .storage_plugin import local_fs_root, strip_mirror_options, url_to_storage_plugin
from .storage_plugins.retry import is_not_found_error
from . import telemetry
from .telemetry import flightrec, health
from .version import __version__

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"
# Commit fence: written BEFORE any payload I/O with this take's generation
# token, re-read at the commit point, deleted after a successful commit.
# Committed snapshots carry no fence; a fence without metadata marks an
# in-flight or abandoned take.
SNAPSHOT_FENCE_FNAME = ".snapshot_fence"


class StaleCommitError(RuntimeError):
    """The commit fence no longer carries this take's generation token: a
    newer take claimed (or garbage collection reclaimed) the snapshot path
    while this take was in flight. Nothing was committed; the newer
    snapshot, if any, is untouched."""

    def __init__(self, path: str, expected: str, found: Optional[str]) -> None:
        super().__init__(
            f"Refusing to commit snapshot metadata at {path!r}: the commit "
            f"fence holds {found!r}, not this take's generation "
            f"{expected!r}. A newer take has claimed this path (or its "
            "partial directory was garbage-collected); committing would "
            "splice this take's manifest over the newer snapshot's "
            "payloads. This take is aborted; nothing was committed."
        )
        self.path = path
        self.expected = expected
        self.found = found


def _resolve_codec(compression: Optional[str]) -> Optional[str]:
    """The take's codec, validated before any I/O: the argument when given,
    else ``TORCHSNAPSHOT_GPU_COMPRESSION``, else None."""
    return resolve_codec(compression) if compression is not None else env_codec()


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


def _convert_save_dtypes(flattened: Dict[str, Any], save_dtype: Dict[str, str]) -> List[str]:
    """Cast matching tensor leaves in ``flattened`` before write planning,
    so the device-to-host copy, the checksum and storage all move the
    converted (usually narrower) bytes. A CUDA tensor is cast on its device,
    on the caller's current stream, which the staging side stream waits on.
    The decision (first matching glob, dtype-class rules) is
    ``serialization.effective_save_dtype`` (snapshot.py:2307-2400 of the JAX
    package). Returns the converted logical paths. The converted copies stay
    on the device until staging drains them."""
    saved = 0
    converted_paths = []
    for lp, obj in flattened.items():
        if not isinstance(obj, torch.Tensor):
            continue
        target = effective_save_dtype(lp, obj.dtype, save_dtype)
        if target is not None:
            converted = obj.detach().to(target)
            saved += obj.numel() * (obj.element_size() - converted.element_size())
            flattened[lp] = converted
            converted_paths.append(lp)
    if saved:
        logger.info("save_dtype downcast elided %.1f MB before staging", saved / 1e6)
    return converted_paths


def _validate_app_state(app_state: AppState) -> None:
    for key, value in app_state.items():
        if not isinstance(value, Stateful):
            raise TypeError(
                f"App state entry {key!r} (type {type(value).__name__}) does not "
                "implement state_dict()/load_state_dict(). Wrap raw state in "
                "torchsnapshot_tpu_torch.StateDict."
            )


class _PhaseTimer:
    """Where a take's or restore's wall time went, phase by phase
    (snapshot.py:98-135 of the JAX package): each mark is a ``phase:``
    event on the bus, a ``phase`` flight event and the heartbeat's
    phase, and the phases ride the op's telemetry summary."""

    def __init__(self, op: str) -> None:
        self.op = op
        self.phases: List[Tuple[str, float]] = []
        self._t = telemetry.monotonic()

    def mark(self, name: str) -> None:
        now = telemetry.monotonic()
        self.phases.append((name, now - self._t))
        telemetry.event(f"phase:{name}", cat="phase", op=self.op, dur_s=now - self._t)
        flightrec.record("phase", name=name, op=self.op, dur_s=round(now - self._t, 6))
        health.update(phase=name)
        self._t = now

    def log(self) -> None:
        total = sum(dt for _, dt in self.phases)
        logger.info("%s phases: %s (total %.3fs)", self.op,
                    ", ".join(f"{n}={dt:.3f}s" for n, dt in self.phases), total)


class _OpTelemetry:
    """One take's or restore's telemetry: the governor's warm start from
    the root's learned profiles, its bus recorder, the flight recorder's
    ``op.begin`` (and, on an abort, ``op.abort`` and the dump of the ring
    and the thread stacks under ``<path>/.flight/``), the heartbeat, the
    stall watchdog and the ``/metrics`` endpoint."""

    def __init__(self, op: str, path: str, pg_wrapper: PGWrapper) -> None:
        from .scheduler import preload_profiles

        self.op, self.path, self.rank = op, path, pg_wrapper.get_rank()
        # Before the op's first election; once per root per process.
        preload_profiles(path, pg_wrapper.get_world_size())
        self.timer = _PhaseTimer(f"Snapshot.{op}")
        self.recorder = telemetry.begin_op(op, self.rank)
        flightrec.record("op.begin", op=op, rank=self.rank, path=path)
        self.heartbeat = health.maybe_start(pg_wrapper, op, path)
        # Self-dumps stacks on an overdue collective, a slow storage op or
        # frozen progress, and answers remote dump requests.
        self.watchdog = telemetry.forensics.arm(pg_wrapper, op, path)
        # Started once a process, at its first op; a no-op when unset.
        telemetry.promexp.maybe_start(rank=self.rank)

    def abort(self, exc: BaseException) -> None:
        """Record the abort and dump the ring before the error propagates
        (never raises); the recorder is released without a summary."""
        flightrec.record("op.abort", op=self.op, error=repr(exc), kind=type(exc).__name__)
        flightrec.dump(self.path, self.rank, f"{self.op} aborted: {type(exc).__name__}")
        self.recorder.abandon()

    def close(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None


def _publish_telemetry(tm: _OpTelemetry, pg_wrapper: PGWrapper, storage: StoragePlugin,
                       event_loop: asyncio.AbstractEventLoop, persist: bool,
                       gather: bool = True) -> None:
    """Finish this rank's summary of the op and its critical-path
    attribution, gather every rank's, merge the fleet view and the
    attribution, feed the verdict to the governor's closed loop and, for a
    take (``persist``), write each rank's Chrome trace and rank 0's
    ``.snapshot_telemetry`` and ``.snapshot_critpath`` into the snapshot,
    and rank 0 appends the take to its root's history
    (snapshot.py:2056-2250 of the JAX package). The gather runs whenever
    the world has several ranks, a rank with telemetry off sending None,
    so a skew of the knob between ranks degrades the fleet view and never
    hangs. Nothing here fails the op. ``gather=False`` (the commit thread
    of an async take, which must not share the caller's store connection)
    keeps the view to this rank's summary."""
    from .scheduler import autotune_mode, io_governor

    summary = None
    try:
        extra: Dict[str, Any] = {"phases": {n: round(dt, 6) for n, dt in tm.timer.phases},
                                 "rates": io_governor().measured_rates()}
        summary = tm.recorder.finish(extra=extra)
    except Exception:  # noqa: BLE001 - observability never fails the op
        logger.exception("telemetry summary failed; continuing without it")
    if summary is not None:
        try:
            summary["attribution"] = telemetry.critpath.build_attribution(
                tm.recorder.events(), wall_s=summary.get("wall_s"),
                rank=summary.get("rank", 0))
        except Exception:  # noqa: BLE001
            logger.exception("critical-path attribution failed; continuing without it")
    world_size = pg_wrapper.get_world_size()
    try:
        several = world_size > 1 and gather
        gathered = pg_wrapper.all_gather_object(summary) if several else [summary]
        fleet = telemetry.merge_summaries(gathered)
        telemetry.set_last_fleet(fleet)
    except Exception:  # noqa: BLE001
        logger.exception("telemetry cross-rank gather failed; continuing without the fleet view")
        return
    aggregate = (fleet or {}).get("aggregate")
    attribution = None
    try:
        attribution = telemetry.critpath.merge_attributions(
            [s.get("attribution") if isinstance(s, dict) else None for s in gathered],
            aggregate=aggregate)
        telemetry.set_last_attribution(attribution)
    except Exception:  # noqa: BLE001
        logger.exception("critical-path merge failed; continuing without it")
    root = _local_root(tm.path)
    try:
        # On every rank: the merged attribution is the same on all, so
        # the learning agrees without a collective; rank 0 persists.
        if autotune_mode() != "never":
            io_governor().observe_verdict(
                tm.op, type(storage).__name__, world_size, attribution, aggregate=aggregate,
                root=root, rank=tm.rank)
    except Exception:  # noqa: BLE001
        logger.exception("autotune verdict observation failed; continuing")
    if persist and tm.rank == 0 and root is not None:
        # With the bus off too: wall time and identity always record.
        _append_history(tm, root, world_size, fleet, summary, attribution)
    if fleet is None or not persist:
        return
    try:
        if summary is not None:
            trace = telemetry.chrome_trace_json(tm.recorder.events(), pid=tm.rank)
            event_loop.run_until_complete(storage.write(WriteIO(
                path=telemetry.trace_path_for_rank(tm.rank), buf=trace.encode("utf-8"))))
        if tm.rank == 0:
            doc = telemetry.build_summary_document(tm.op, world_size, gathered, fleet)
            event_loop.run_until_complete(storage.write(WriteIO(
                path=telemetry.TELEMETRY_SUMMARY_FNAME,
                buf=json.dumps(doc, indent=1).encode("utf-8"))))
            if attribution is not None:
                cp_doc = telemetry.critpath.build_attribution_document(
                    tm.op, world_size, attribution, rates=(summary or {}).get("rates"),
                    governor=(summary or {}).get("governor"))
                event_loop.run_until_complete(storage.write(WriteIO(
                    path=telemetry.critpath.ATTRIBUTION_FNAME,
                    buf=json.dumps(cp_doc, indent=1).encode("utf-8"))))
    except Exception:  # noqa: BLE001
        logger.exception("telemetry persistence failed; the snapshot is unaffected")


def _local_root(path: str) -> Optional[str]:
    """The directory holding ``path``'s history journal and learned
    profiles (its parent), for a local path; else None."""
    local = local_fs_root(path)
    return None if local is None else os.path.dirname(os.path.abspath(local.rstrip("/")))


def _append_history(tm: _OpTelemetry, root: str, world_size: int,
                    fleet: Optional[Dict[str, Any]], summary: Optional[Dict[str, Any]],
                    attribution: Optional[Dict[str, Any]]) -> None:
    """Append this committed take to ``<root>/.telemetry_history.jsonl``
    (never fails the committed snapshot)."""
    try:
        step = ((summary or {}).get("annotations") or {}).get("step")
        record = telemetry.history.build_record(
            op=tm.op, path=tm.path, wall_s=sum(dt for _, dt in tm.timer.phases),
            world_size=world_size, fleet=fleet, rank_summary=summary, step=step,
            attribution=attribution)
        telemetry.history.append_record(root, record)
    except Exception:  # noqa: BLE001
        logger.exception("history append failed; the snapshot is unaffected")


MANIFEST_FORMAT_ENV_VAR = "TORCHSNAPSHOT_GPU_MANIFEST_FORMAT"


def encode_metadata(metadata: SnapshotMetadata) -> bytes:
    """The bytes of ``.snapshot_metadata``: JSON, or the columnar TSCM
    codec under ``TORCHSNAPSHOT_GPU_MANIFEST_FORMAT=columnar``
    (snapshot.py:2029-2034 of the JAX package)."""
    if os.environ.get(MANIFEST_FORMAT_ENV_VAR, "") == "columnar":
        from . import colmanifest

        return colmanifest.encode_metadata(metadata)
    return metadata.to_yaml().encode("utf-8")


def _drain_background_storage(
    storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
) -> None:
    """Drain plugin-internal background work (the mirror's replication)
    before the commit barrier (``StoragePlugin.drain_background``)."""
    event_loop.run_until_complete(storage.drain_background())


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
        layout: Optional[Any] = None,
    ) -> "Snapshot":
        """Persist ``app_state`` at ``path`` and return once committed;
        collective over ``pg``'s world. ``replicated`` globs mark logical
        paths as replicated (stored once under ``replicated/``, restorable
        by any rank). ``layout`` (a ``layout.LayoutSpec`` or its dict form)
        is recorded as the snapshot's source layout, descriptive only. See
        the module docstring for ``incremental_base``, ``record_digests``,
        ``device_digests``, ``save_dtype`` and ``compression``."""
        _validate_app_state(app_state)
        _validate_save_dtype(save_dtype)
        codec = _resolve_codec(compression)
        pg_wrapper = PGWrapper(pg)
        path = cls._coalesce_path(path, pg_wrapper)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path, storage_options)
        tm = _OpTelemetry("take", path, pg_wrapper)
        # Tenancy admission: this op's bandwidth share, enforced by the
        # scheduler at I/O-slot acquisition (None without a tenant).
        admission = tenancy_admission.maybe_arm("take", storage, pg_wrapper)
        body_ok = False
        try:
            # A blocking take may stage CPU tensors without copying them,
            # and streams: it waits for the writes anyway.
            pending_io_work, metadata = cls._take_impl(
                path, app_state, replicated or [], pg_wrapper, storage, event_loop,
                copy_cpu=False, incremental_base=incremental_base,
                record_digests=record_digests, device_digests=device_digests,
                save_dtype=save_dtype, storage_options=storage_options, codec=codec,
                layout=layout, allow_streaming=True, timer=tm.timer,
            )
            # A write can still fail here, in the drain or at the commit:
            # the error channel makes every peer blocked in the barriers
            # raise at once instead of waiting out the barrier timeout.
            try:
                pending_io_work.sync_complete(event_loop)
                _drain_background_storage(storage, event_loop)
                tm.timer.mark("io_drain")
                pg_wrapper.barrier()
                if pg_wrapper.get_rank() == 0:
                    cls._write_snapshot_metadata(metadata, storage, event_loop)
                pg_wrapper.barrier()
            except BaseException as e:  # noqa: B036 - re-raised
                try:
                    pg_wrapper.report_error(e)
                except Exception:  # noqa: BLE001 - the original error wins
                    pass
                raise
            tm.timer.mark("commit")
            tm.timer.log()
            # After the commit barrier: telemetry can degrade
            # observability, never un-commit a snapshot.
            _publish_telemetry(tm, pg_wrapper, storage, event_loop, persist=True)
            body_ok = True
        except BaseException as e:  # noqa: B036 - re-raised
            tm.abort(e)
            raise
        finally:
            tm.close()
            tenancy_admission.disarm(storage, admission)
            try:
                pg_wrapper.retire()
            except Exception:  # noqa: BLE001 - store hygiene only
                pass
            try:
                storage.sync_close(event_loop)
            except Exception:
                # A close error (a strict mirror's failed replication)
                # matters, but never masks the take's own error. A flag,
                # not sys.exc_info(): a take called inside an except block
                # sees the caller's exception there.
                if body_ok:
                    raise
                logger.exception(
                    "storage close also failed while handling a take failure; the "
                    "take's error propagates."
                )
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
        layout: Optional[Any] = None,
    ) -> "PendingSnapshot":
        """Non-blocking take. Returns once every entry is staged and every
        rank's manifest gathered; after that, mutating the app state does
        not affect the snapshot. Storage writes and the commit continue on
        a background thread, which meets the other ranks on a store barrier
        before rank 0 commits: a failure on any rank commits nothing on any
        rank. ``.wait()`` on the returned handle joins it. Fingerprints and
        digests are recorded and compared before it returns, on the bytes
        the caller had at the call. The commit fence is planted before it
        returns, never by the commit thread: a fence planted later would
        let a reclaimed straggler plant its own token over a newer take and
        pass its own check (snapshot.py:707-745 of the JAX package)."""
        _validate_app_state(app_state)
        _validate_save_dtype(save_dtype)
        codec = _resolve_codec(compression)
        pg_wrapper = PGWrapper(pg)
        path = cls._coalesce_path(path, pg_wrapper)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path, storage_options)
        tm = _OpTelemetry("take", path, pg_wrapper)
        # Armed for the whole op: the commit thread disarms it.
        admission = tenancy_admission.maybe_arm("take", storage, pg_wrapper)
        try:
            pending_io_work, metadata = cls._take_impl(
                path, app_state, replicated or [], pg_wrapper, storage, event_loop,
                copy_cpu=True, incremental_base=incremental_base,
                record_digests=record_digests, device_digests=device_digests,
                save_dtype=save_dtype, storage_options=storage_options, codec=codec,
                layout=layout, timer=tm.timer,
            )
        except BaseException as e:  # noqa: B036 - re-raised
            tm.abort(e)
            tm.close()
            tenancy_admission.disarm(storage, admission)
            try:
                pg_wrapper.retire()
            except Exception:  # noqa: BLE001 - store hygiene only
                pass
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()
            raise
        return PendingSnapshot(
            path, pg, storage_options, pending_io_work, pg_wrapper, metadata, storage, event_loop,
            telemetry_op=tm, admission=admission,
        )

    @classmethod
    def _take_impl(
        cls,
        path: str,
        app_state: AppState,
        replicated: List[str],
        pg_wrapper: PGWrapper,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        copy_cpu: bool,
        incremental_base: Optional[str] = None,
        record_digests: bool = False,
        device_digests: Optional[bool] = None,
        save_dtype: Optional[Dict[str, str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        codec: Optional[str] = None,
        layout: Optional[Any] = None,
        allow_streaming: bool = False,
        timer: Optional[_PhaseTimer] = None,
    ):
        mark = timer.mark if timer is not None else (lambda name: None)
        rank = pg_wrapper.get_rank()
        world_size = pg_wrapper.get_world_size()
        # A malformed layout fails the take before any staging.
        layout_dict = resolve_layout(layout)
        app_state = dict(app_state)
        dedup_ctx, origin_mirrors = cls._dedup_context(
            incremental_base, record_digests, device_digests, storage_options
        )
        # This snapshot's own mirror, recorded so that later increments
        # read their origins through it too.
        own_mirror = None
        if storage_options and storage_options.get("mirror_url"):
            own_mirror = canonical_base_url(storage_options["mirror_url"])
        # RNG invariant: RNG state is captured at entry and re-applied
        # after, so taking a snapshot never perturbs the RNG streams.
        rng_captured = {
            key: stateful.state_dict()
            for key, stateful in app_state.items()
            if isinstance(stateful, RNGState)
        }
        try:
            keys = cls._gather_keys(pg_wrapper, sorted(app_state))
            manifest: Manifest = {}
            flattened: Dict[str, Any] = {}
            # Statefuls materialize in cross-rank lockstep, a barrier a
            # key, so collectives inside one state_dict() never interleave
            # with another's. A failing rank still calls the remaining
            # state_dict()s and still meets every barrier; its first error
            # rides the manifest gather below, so every rank aborts.
            materialize_exc: Optional[BaseException] = None
            for key in keys:
                if key in app_state:
                    try:
                        sd = rng_captured[key] if key in rng_captured else app_state[key].state_dict()
                        if materialize_exc is None:
                            key_manifest, key_flattened = flatten(sd, prefix=key)
                            manifest.update(key_manifest)
                            flattened.update(key_flattened)
                    except BaseException as e:  # noqa: B036 - rides the gather
                        if materialize_exc is None:
                            materialize_exc = e
                pg_wrapper.barrier()
            mark("materialize")

            converted = set()
            if save_dtype and materialize_exc is None:
                converted = set(_convert_save_dtypes(flattened, save_dtype))
            replicated_paths = cls._calculate_replicated_paths(flattened, replicated, pg_wrapper)
            # A DTensor that is not sharded holds the whole value locally.
            for lp, obj in flattened.items():
                if is_dtensor(obj) and not is_sharded_dtensor(obj):
                    flattened[lp] = obj.to_local()
            chunk_assignments, owned_objects = _partition_write_units(
                flattened, replicated_paths, rank, world_size
            )

            streams = DeviceStreams()
            write_reqs: List[WriteReq] = []
            # Stagers capture the dedup context and the codec at construction.
            with dedup_staging(dedup_ctx), compression_staging(codec):
                for logical_path in sorted(flattened):
                    obj = flattened[logical_path]
                    is_repl = logical_path in replicated_paths
                    if is_sharded_dtensor(obj):
                        entry, reqs = ShardedArrayIOPreparer.prepare_write(
                            get_storage_path(logical_path, rank, sharded=True),
                            dtensor_view(obj), streams, copy_cpu,
                        )
                    elif isinstance(obj, torch.Tensor):
                        entry, reqs = _prepare_chunked_array_write(
                            get_storage_path(logical_path, rank, replicated=is_repl),
                            obj, streams, copy_cpu, chunk_assignments[logical_path], is_repl,
                        )
                    elif PrimitivePreparer.should_inline(obj):
                        entry, reqs = PrimitivePreparer.prepare_write(obj, is_repl), []
                    else:
                        entry, reqs = prepare_write(obj, logical_path, rank, is_repl)
                        if is_repl and logical_path not in owned_objects:
                            reqs = []  # another rank writes it
                    if logical_path in converted:
                        # A save_dtype conversion stages buffered.
                        for req in reqs:
                            req.buffer_stager.streamable = False
                    manifest[logical_path] = entry
                    write_reqs.extend(reqs)
            if batching_enabled():
                if dedup_ctx is not None:
                    logger.warning(
                        "Write batching (TORCHSNAPSHOT_GPU_ENABLE_BATCHING) is enabled: "
                        "batched (small) payloads are not deduplicated against the "
                        "incremental base, and their digests serve no later incremental "
                        "take. Disable batching for snapshots in incremental chains."
                    )
                # Rewrites the packed entries' locations and byte ranges in
                # place, before any stager runs and before the gather.
                _, write_reqs = batch_write_requests(list(manifest.values()), write_reqs)
            memory_budget = get_process_memory_budget_bytes(
                pg_wrapper if world_size > 1 else None
            )
            mark("plan")
            # Rank 0 claims the path before any payload I/O: this take's
            # token becomes the commit fence. A failed plant is captured,
            # not raised: it rides the manifest gather like any staging
            # error, so peers are not deserted at the gather.
            commit_gen = uuid.uuid4().hex
            stage_exc: Optional[BaseException] = materialize_exc
            if rank == 0 and stage_exc is None:
                try:
                    cls._write_fence(commit_gen, storage, event_loop)
                except BaseException as e:  # noqa: B036 - rides the gather
                    stage_exc = e
            # The gather comes after staging (the consistency point), so
            # stage-time entry fields (checksums, fingerprints) are in the
            # manifests the ranks exchange; the writes go on meanwhile.
            pending_io_work = None
            if stage_exc is None:
                try:
                    if dedup_ctx is not None and dedup_ctx.device_digests:
                        fingerprint_stagers(req.buffer_stager for req in write_reqs)
                    pending_io_work = event_loop.run_until_complete(
                        execute_write_reqs(
                            write_reqs, storage, memory_budget, rank,
                            allow_streaming=allow_streaming,
                        )
                    )
                except BaseException as e:  # noqa: B036 - rides the gather
                    stage_exc = e
            mark("stage")
            global_manifest, peer_errors = cls._gather_manifest(
                manifest, pg_wrapper, local_error=repr(stage_exc) if stage_exc else None
            )
            mark("gather")
            if stage_exc is not None:
                raise stage_exc
            failed = [f"rank {i}: {e}" for i, e in enumerate(peer_errors) if e]
            if failed:
                # No local write may outlive the abort.
                pending_io_work.sync_abort(event_loop)
                raise RuntimeError(
                    "snapshot aborted: staging failed on peer rank(s): " + "; ".join(failed)
                )
            metadata = SnapshotMetadata(
                version=__version__, world_size=world_size, manifest=global_manifest,
                mirror_url=own_mirror, origin_mirrors=origin_mirrors or None,
                layout=layout_dict,
            )
            # Runtime-only commit context (to_yaml writes declared fields
            # only): the token the commit point must still find.
            metadata._commit_gen = commit_gen
            metadata._commit_path = path
            return pending_io_work, metadata
        finally:
            for key, sd in rng_captured.items():
                app_state[key].load_state_dict(sd)

    @staticmethod
    def _coalesce_path(path: str, pg_wrapper: PGWrapper) -> str:
        """Every rank takes rank 0's path (snapshot.py:2363-2366 of the JAX
        package)."""
        return pg_wrapper.broadcast_object(path, src=0)

    @staticmethod
    def _gather_keys(pg_wrapper: PGWrapper, keys: List[str]) -> List[str]:
        return sorted(set().union(*pg_wrapper.all_gather_object(keys)))

    @staticmethod
    def _calculate_replicated_paths(
        flattened: Dict[str, Any], replicated_globs: List[str], pg_wrapper: PGWrapper
    ) -> Set[str]:
        """Paths matched by a glob, and fully ``Replicate`` DTensors over
        every process, kept only where every rank claims them with the same
        shape and dtype (snapshot.py:2374-2405 of the JAX package)."""
        world_size = pg_wrapper.get_world_size()
        local: Set[str] = set()
        for logical_path, obj in flattened.items():
            if any(fnmatch.fnmatch(logical_path, g) for g in replicated_globs):
                local.add(logical_path)
            elif is_process_replicated_dtensor(obj, world_size):
                local.add(logical_path)
        if world_size == 1:
            return local

        def signature(lp: str) -> Tuple:
            obj = flattened[lp]
            if isinstance(obj, torch.Tensor):
                return (lp, tuple(obj.shape), dtype_to_string(obj.dtype))
            return (lp, None, None)

        all_claims = pg_wrapper.all_gather_object(sorted(signature(lp) for lp in local))
        verified = set(all_claims[0])
        for other in all_claims[1:]:
            verified &= set(other)
        return {lp for lp, _, _ in verified}

    @staticmethod
    def _gather_manifest(
        local_manifest: Manifest, pg_wrapper: PGWrapper, local_error: Optional[str] = None
    ) -> Tuple[Manifest, List[Optional[str]]]:
        """All-gather each rank's (manifest, staging error) into the global
        rank-prefixed manifest (snapshot.py:2407-2429 of the JAX package).
        The errors ride the collective, so a failed rank never deserts it."""
        gathered = pg_wrapper.all_gather_object((local_manifest, local_error))
        global_manifest: Manifest = {}
        for rank, (m, _) in enumerate(gathered):
            for logical_path, entry in m.items():
                global_manifest[f"{rank}/{logical_path}" if logical_path else str(rank)] = entry
        _propagate_checksums(global_manifest)
        return global_manifest, [e for _, e in gathered]

    @classmethod
    def _dedup_context(
        cls,
        incremental_base: Optional[str],
        record_digests: bool,
        device_digests: Optional[bool],
        storage_options: Optional[Dict[str, Any]],
    ) -> Tuple[Optional[DedupContext], Dict[str, str]]:
        """The take's dedup context and its origin mirrors
        (snapshot.py:518-590 of the JAX package): the base's payload index
        when ``incremental_base`` is given (pinned to its canonical URL,
        since origins are resolved from other working directories later),
        a recording-only context for ``record_digests`` or
        ``device_digests`` alone, else None. The origin mirrors map every
        ancestor that may hold a borrowed payload to its mirror: the
        base's own mapping, transitively, plus the base's mirror."""
        if device_digests is None:
            device_digests = device_digests_env()
        if incremental_base is not None:
            incremental_base = canonical_base_url(incremental_base)
            # The mirror options name this take's mirror, not the base's.
            base_meta = cls(
                incremental_base, storage_options=strip_mirror_options(storage_options)
            ).metadata
            ctx = DedupContext.from_base(
                incremental_base, base_meta, device_digests=device_digests
            )
            if not ctx.refs:
                logger.warning(
                    "incremental_base %s has no content digests (take it with "
                    "record_digests=True); every payload will be rewritten.",
                    incremental_base,
                )
            origin_mirrors = dict(base_meta.origin_mirrors or {})
            # A base that is itself a mirror tier (the rebase after losing
            # a primary) is not wrapped with itself.
            if base_meta.mirror_url and (
                canonical_base_url(base_meta.mirror_url) != incremental_base
            ):
                origin_mirrors[incremental_base] = base_meta.mirror_url
            return ctx, origin_mirrors
        if record_digests or device_digests:
            # Fingerprints must land in this snapshot's manifest for the next
            # take to match against.
            return DedupContext.recording_only(device_digests=device_digests), {}
        return None, {}

    @staticmethod
    def _write_fence(
        gen: str, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
    ) -> None:
        body = json.dumps({"gen": gen, "pid": os.getpid(), "version": __version__})
        flightrec.record("fence.plant", gen=gen)
        event_loop.run_until_complete(
            storage.write(WriteIO(path=SNAPSHOT_FENCE_FNAME, buf=body.encode("utf-8")))
        )

    @staticmethod
    def _read_fence_gen(
        storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
    ) -> Optional[str]:
        """The token fencing this path, or None when the fence is missing
        or torn (both mean: not this take's). A transport error propagates
        as itself, so a commit fails with the storage's own diagnosis."""
        read_io = ReadIO(path=SNAPSHOT_FENCE_FNAME)
        try:
            event_loop.run_until_complete(storage.read(read_io))
        except Exception as e:  # noqa: BLE001 - re-raised unless not-found
            if is_not_found_error(e):
                return None
            raise
        try:
            return json.loads(bytes(read_io.buf).decode("utf-8")).get("gen")
        except (ValueError, UnicodeDecodeError, AttributeError):
            return None  # torn fence: a foreign writer is mid-plant

    @staticmethod
    def _write_snapshot_metadata(
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        """The commit point, fenced when the metadata carries a take's
        token: commit only if the fence still holds it, then delete the
        fence. The check is check-then-act (a filesystem has no
        compare-and-swap): a straggler suspended between its passing fence
        read and its metadata write, and reclaimed in that gap, can still
        splice; the fence narrows the window from the whole drain to one
        storage round trip (snapshot.py:2000-2052 of the JAX package)."""
        gen = getattr(metadata, "_commit_gen", None)
        if gen is not None:
            found = Snapshot._read_fence_gen(storage, event_loop)
            flightrec.record("commit.decision", gen=gen, found=found, ok=found == gen)
            if found != gen:
                raise StaleCommitError(getattr(metadata, "_commit_path", "<unknown>"), gen, found)
        raw = faultinject.mutate("commit.metadata", encode_metadata(metadata))
        event_loop.run_until_complete(
            storage.write(WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=raw))
        )
        if gen is not None:
            try:
                event_loop.run_until_complete(storage.delete(SNAPSHOT_FENCE_FNAME))
            except Exception:  # noqa: BLE001 - committed; a lingering fence is harmless
                logger.warning(
                    "committed, but could not remove the commit fence %s",
                    SNAPSHOT_FENCE_FNAME, exc_info=True,
                )

    # --------------------------------------------------------------- restore

    def restore(
        self,
        app_state: AppState,
        device_digests: Optional[bool] = None,
        hot: Optional[List[Any]] = None,
    ) -> Optional[Any]:
        """Restore the app state in place; collective over the snapshot's
        ``pg``. Tensors are restored into the shapes, dtypes, devices and
        layouts of the current state (a DTensor of any mesh and placements,
        in a world of any size); a snapshot dtype that differs is cast to
        the destination's (``same_kind`` only). With ``device_digests``
        (default: ``TORCHSNAPSHOT_GPU_DEVICE_DIGESTS``) a destination whose
        fingerprint equals the entry's recorded one is kept as it is: no
        read, no copy.

        ``hot``: the lazy restore's hot set (regex strings or
        ``layout.Rule`` objects), the leaves resident when this returns.
        Consulted only under ``TORCHSNAPSHOT_GPU_LAZY_RESTORE`` (default
        ``never``: eager, returns None). When the lazy election engages,
        deferred leaves of a ``StateDict`` come back as
        ``pagein.LeafFuture`` proxies and the returned
        ``pagein.PageInSession`` pages them in; its ``wait()`` is the eager
        restore's return point (snapshot.py:793-830 of the JAX package)."""
        _validate_app_state(app_state)
        return self._restore_impl(app_state, device_digests, hot=hot)

    def async_restore(
        self, app_state: AppState, device_digests: Optional[bool] = None
    ) -> "PendingRestore":
        """``restore`` on a background thread; returns a
        :class:`PendingRestore` at once (snapshot.py:833-858 of the JAX
        package). The app state must not be read, written or checkpointed
        until ``wait()`` returns; the caller's other work (compiling,
        building kernels, device work on its own streams) overlaps the
        restore. ``device_digests``, the preverify gate and the
        stream-reads election behave as in ``restore``. In a world of
        several processes every rank meets a barrier on the calling thread
        first, which also fixes the wrapper's namespace in the calling
        thread's order; start no other snapshot operation on any rank
        before ``wait()``."""
        _validate_app_state(app_state)
        pg_wrapper = PGWrapper(self.pg)
        pg_wrapper.barrier()
        return PendingRestore(self, app_state, device_digests, pg_wrapper)

    def _restore_impl(
        self,
        app_state: AppState,
        device_digests: Optional[bool],
        new_streams=DeviceStreams,
        pg_wrapper: Optional[PGWrapper] = None,
        hot: Optional[List[Any]] = None,
    ) -> Optional[Any]:
        explicit = device_digests is not None
        if device_digests is None:
            device_digests = device_digests_env()
        if pg_wrapper is None:
            pg_wrapper = PGWrapper(self.pg)
        rank = pg_wrapper.get_rank()
        world_size = pg_wrapper.get_world_size()
        # The lazy page-in election (pagein.py): decided here, made
        # collective below as the fifth slot of the one flag gather. Off,
        # it costs one env check.
        from . import pagein as pagein_mod

        lazy_token = ""
        lazy_hot = None
        lazy_learned: List[str] = []
        lazy_mode = pagein_mod.lazy_restore_mode()
        if lazy_mode != "never":
            lazy_hot = pagein_mod.HotSet(pagein_mod.compile_hot_set(hot))
            lazy_learned = pagein_mod.learned_order(self.path)
            # `auto` engages only with something to serve early; both
            # modes stand down when committed journal epochs exist (a page
            # landing after the replay would roll a leaf back).
            engage = (
                lazy_mode == "always" or bool(lazy_hot.rules) or bool(lazy_learned)
            ) and not pagein_mod.journal_blocks_lazy(self.path)
            lazy_token = pagein_mod.vote_token(engage, lazy_hot)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path, self._storage_options)
        # The fleet seeding tier (distrib.py, TORCHSNAPSHOT_GPU_SEED_RESTORE):
        # shareable buffered reads come from peers that hold the chunk
        # before storage, and what this restore obtains keeps seeding later
        # restorers. Per replica, no collective: every miss reads direct.
        from . import distrib

        storage, seed_tier = distrib.maybe_wrap_restore(storage, self.path, pg_wrapper)
        coop_session = None
        pagein_session = None
        pagein_handoff = False
        tm = _OpTelemetry("restore", self.path, pg_wrapper)
        admission = tenancy_admission.maybe_arm("restore", storage, pg_wrapper)
        try:
            metadata = self._read_metadata(storage, event_loop)
            tm.timer.mark("metadata")
            available = get_manifest_for_rank(metadata, rank)
            budget = get_process_memory_budget_bytes(pg_wrapper if world_size > 1 else None)
            keys = self._gather_keys(pg_wrapper, sorted(app_state))
            # RNG states restore last so earlier loads cannot perturb them;
            # which keys are RNG is agreed across ranks, so every rank
            # visits the same key at each lockstep slot.
            rng_keys = set(
                self._gather_keys(
                    pg_wrapper, sorted(k for k in keys if isinstance(app_state.get(k), RNGState))
                )
            )
            ordered = [k for k in keys if k not in rng_keys] + [k for k in keys if k in rng_keys]
            # The decisions to verify and to cooperate are agreed before
            # the key loop: each rank resolves them from its own env and
            # measured rates, and a rank skipping a per-key collective
            # that its peers enter would hang them. ONE all-gather carries
            # the tuple (preverify, peer address, coop vote, reshard vote,
            # lazy token) and ANDs each: any skew degrades to plain reads
            # everywhere (snapshot.py:960-1072 of the JAX package). Lazy
            # page-in engages only on one identical non-empty token (same
            # mode and hot set) on every rank. The peer listener is a
            # transport both peer subsystems share: either vote binds it,
            # and each engages on its own unanimous vote.
            if device_digests:
                device_digests = self._preverify_worthwhile(storage, explicit)
            dist_verify = False
            use_coop = False
            reshard_min_req = 0
            if world_size > 1:
                plugin_name = type(storage).__name__
                # Reshard vote: 0 opts out, else this rank's min-requesters
                # knob (the world takes the max, so skew still yields one
                # plan).
                local_reshard = (
                    reshard_mod.reshard_min_requesters()
                    if reshard_mod.local_opt_in(plugin_name, pg_wrapper)
                    else 0
                )
                offer = CoopRestoreSession.local_offer(
                    plugin_name, pg_wrapper, extra_opt_in=local_reshard > 0
                )
                flags = pg_wrapper.all_gather_object(
                    (bool(device_digests), offer.addr, offer.coop_in, local_reshard, lazy_token)
                )
                if lazy_token and not all(f[4] == lazy_token for f in flags):
                    logger.info(
                        "lazy page-in disabled for this restore: not every rank voted the "
                        "same mode and hot set; restoring eagerly everywhere"
                    )
                    lazy_token = ""
                manifest_verifiable = any(
                    isinstance(e, ShardedArrayEntry)
                    and e.shards
                    and all(s.array.device_digest is not None for s in e.shards)
                    for e in available.values()
                )
                dist_verify = manifest_verifiable and all(f[0] for f in flags)
                if device_digests and manifest_verifiable and not dist_verify:
                    logger.info(
                        "distributed digest verification disabled for this restore: not "
                        "every rank opted in (env skew or rate-gate divergence); "
                        "reading normally"
                    )
                coop_session = offer.engage([f[1] for f in flags], rank, event_loop)
                if coop_session is not None:
                    use_coop = all(f[2] for f in flags)
                    if all(f[3] > 0 for f in flags):
                        reshard_min_req = max(f[3] for f in flags)
            if lazy_token:
                layout_spec = None
                if metadata.layout:
                    from .layout import LayoutSpec

                    try:
                        layout_spec = LayoutSpec.from_dict(metadata.layout)
                    except Exception:  # noqa: BLE001 - ordering is advisory
                        layout_spec = None
                pagein_session = pagein_mod.PageInSession(
                    self.path, rank, lazy_hot, budget, world_size=world_size,
                    layout_spec=layout_spec, learned=lazy_learned,
                    storage_options=self._storage_options,
                )
            # Keys load in cross-rank lockstep, a barrier a key. A failing
            # rank still visits every key, meets every barrier and takes
            # part in every per-key gather (preverify, coop plan), then
            # raises its first error.
            exc: Optional[BaseException] = None
            for key in ordered:
                prepared = None
                if key in app_state:
                    try:
                        prepared = self._flatten_destination(app_state[key], key, available)
                    except BaseException as e:  # noqa: B036 - raised after the loop
                        exc = exc or e
                preverified: Set[str] = set()
                if dist_verify:
                    preverified = self._distributed_preverify(
                        prepared[1] if prepared is not None else {}, available, pg_wrapper
                    )
                # The planned reshard of this key: a pure function of the
                # manifest, every rank's boxes and the world size, so every
                # rank computes the same roles with no communication. A
                # rank that never plans (a missing key, a planning error)
                # never sends; its subscribers fall back to storage.
                reshard_ctx = None
                if reshard_min_req > 0:
                    reshard_ctx = reshard_mod.ReshardContext(
                        coop_session, rank, world_size, min_requesters=reshard_min_req
                    )
                # Reads are planned before they run, so that the coop plan
                # gather sits between the two on EVERY rank, with an empty
                # request list where a rank has nothing.
                groups = None
                if prepared is not None:
                    try:
                        # Fresh side streams per key: each orders after
                        # whatever the caller's stream holds by then,
                        # including device work that earlier keys'
                        # load_state_dict() queued.
                        # RNG states stay eager (they restore last because
                        # order matters), and so does any Stateful that
                        # cannot hold a LeafFuture (pagein.py).
                        lazy_here = (
                            pagein_session
                            if key not in rng_keys and isinstance(app_state[key], StateDict)
                            else None
                        )
                        read_reqs = self._plan_reads(
                            prepared[1], available, metadata, new_streams(), device_digests,
                            preverified, rank, reshard=reshard_ctx, pagein=lazy_here, key=key,
                        )
                        groups = self._group_read_reqs(read_reqs)
                    except BaseException as e:  # noqa: B036 - raised after the loop
                        exc = exc or e
                coop_plan = None
                if use_coop:
                    # Reshard-claimed requests stay out of the coop gather:
                    # the plan gave them roles on every rank alike.
                    coop_plan = coop_session.plan_for_key(
                        [
                            rr
                            for _, reqs in (groups or [])
                            for rr in reqs
                            if not reshard_mod.is_reshard_claimed(rr)
                        ],
                        pg_wrapper,
                    )
                if reshard_ctx is not None:
                    coop_plan = reshard_mod.ComposedRestorePlan(reshard_ctx, coop_plan)
                if groups is not None:
                    try:
                        try:
                            self._execute_groups(
                                groups, storage, budget, event_loop, rank=rank, coop=coop_plan,
                                origin_mirrors=metadata.origin_mirrors,
                            )
                        finally:
                            if coop_plan is not None:
                                # Owned units never sent (an error cut this
                                # key short) must not leave subscribers
                                # waiting out the coop timeout.
                                coop_plan.abort_incomplete()
                        dest, flattened = prepared
                        container_manifest = {
                            p: e
                            for p, e in available.items()
                            if is_container_entry(e) and (p == key or p.startswith(f"{key}/"))
                        }
                        app_state[key].load_state_dict(
                            inflate(container_manifest, flattened, prefix=key, dest=dest)
                        )
                    except BaseException as e:  # noqa: B036 - raised after the loop
                        exc = exc or e
                elif coop_plan is not None:
                    coop_plan.abort_incomplete()
                pg_wrapper.barrier()
            tm.timer.mark("load")
            # The delta journal's replay, at a fixed point every rank
            # reaches (a failed key is captured, the loop completes), so its
            # cross-rank verdict gather stays symmetric; a rank whose base
            # failed votes against and every rank keeps the base. Never
            # raises.
            journal.maybe_replay(self.path, app_state, pg_wrapper=pg_wrapper,
                                 base_ok=exc is None)
            # A replication cursor in the directory: this restore read the
            # remote tier's copy, a recovery from a region loss.
            local = local_fs_root(self.path)
            if local is not None and os.path.isfile(os.path.join(local, georep.CURSOR_FNAME)):
                georep.count_dr_restore()
                logger.info("restored from a geo-replicated copy (%s present in %s)",
                            georep.CURSOR_FNAME, self.path)
            # Every rank reaches here, a failed one too: the summary's
            # gather is collective, and runs before the error is raised.
            _publish_telemetry(tm, pg_wrapper, storage, event_loop, persist=False)
            if exc is not None:
                raise exc
            # The lazy handoff: the restore returns here, the hot set
            # resident and the deferred leaves held as futures; the page-in
            # engine adopts this restore's storage, event loop and
            # heartbeat (the finally below leaves them open).
            if pagein_session is not None:
                if pagein_session.has_deferred:
                    pagein_session.handoff(storage, event_loop, tm.heartbeat)
                    tm.heartbeat = None
                    pagein_handoff = True
                else:
                    pagein_session.finish_empty()
            return pagein_session
        except BaseException as e:  # noqa: B036 - re-raised
            tm.abort(e)
            if pagein_session is not None and not pagein_handoff:
                # Every unresolved future raises PageInAborted: the partial
                # state is unreferencable.
                pagein_session.abort()
            if seed_tier is not None:
                # An aborted replica must not advertise chunks it may be
                # about to throw away.
                seed_tier.abort()
            raise
        finally:
            tm.close()
            tenancy_admission.disarm(storage, admission)
            if coop_session is not None:
                try:
                    # A clean shutdown (bye frames): peers must not take
                    # this rank's exit for a death mid-restore.
                    coop_session.close()
                except Exception:  # noqa: BLE001 - best effort
                    pass
            try:
                pg_wrapper.retire()
            except Exception:  # noqa: BLE001 - store hygiene only
                pass
            if not pagein_handoff:
                try:
                    storage.sync_close(event_loop)
                finally:
                    event_loop.close()

    @staticmethod
    def _flatten_destination(stateful: Any, key: str, available: Manifest):
        """``(dest, flattened)`` of one app-state key. An RNG state takes
        the snapshot's own generators, whatever this host has: one with
        another number of CUDA devices, or none, still restores the rest
        (RNGState.load_state_dict)."""
        if isinstance(stateful, RNGState):
            return None, {
                p: None
                for p, e in available.items()
                if (p == key or p.startswith(f"{key}/")) and not is_container_entry(e)
            }
        dest = stateful.state_dict()
        return dest, flatten(dest, prefix=key)[1]

    def _distributed_preverify(
        self, flattened: Dict[str, Any], available: Manifest, pg_wrapper: PGWrapper
    ) -> Set[str]:
        """Zero-byte verification of sharded destinations across process
        boundaries (snapshot.py:1321-1465 of the JAX package). Fingerprint
        lanes add over disjoint word covers, so each rank computes the
        16-byte partial lanes (K4's partial form on the card) of the
        destination regions it was elected for, one all-gather moves the
        partials over the store, and every rank sums them against the
        manifest's piece fingerprints: a piece that no process holds whole
        is verified without moving a payload byte.

        Returns the logical paths verified on every rank's data AND
        eligible here (a sharded DTensor of the entry's shape and dtype):
        a verdict is global, but a rank whose destination did not qualify
        reads as usual and raises its own errors. Collective: every rank
        calls it at the same key slot, with an empty ``flattened`` when it
        has nothing, and the contribution phase never raises (a failing
        entry withholds its contribution and reads normally)."""
        from .device_digest import combine_partials

        local: Dict[str, Any] = {}
        eligible: Set[str] = set()
        for lp, obj in flattened.items():
            try:
                entry = available.get(lp)
                if not isinstance(entry, ShardedArrayEntry) or not is_sharded_dtensor(obj):
                    continue
                if list(obj.shape) != list(entry.shape) or dtype_to_string(obj.dtype) != entry.dtype:
                    continue
                if not entry.shards or any(s.array.device_digest is None for s in entry.shards):
                    continue
                contribs = ShardedArrayIOPreparer.partial_digest_contributions(
                    entry, dtensor_view(obj)
                )
                # None (an unfingerprintable region) is published as it is:
                # peers must see this rank failed, not "no overlap".
                local[lp] = contribs
                if contribs is not None:
                    eligible.add(lp)
            except Exception:  # noqa: BLE001 - lockstep safety
                logger.exception(
                    "distributed digest verification: the contribution for %r failed; "
                    "it reads normally", lp,
                )
                local[lp] = None

        gathered = pg_wrapper.all_gather_object(local)

        verified: Set[str] = set()
        try:
            for lp in sorted(set().union(*(set(g) for g in gathered))):
                entry = available.get(lp)
                if not isinstance(entry, ShardedArrayEntry):
                    continue
                merged: Dict[int, Dict[str, Any]] = {}
                failed = False
                for g in gathered:
                    if lp not in g:
                        continue
                    if g[lp] is None:
                        failed = True
                        break
                    for i, regions in g[lp].items():
                        bucket = merged.setdefault(int(i), {})
                        for box_key, n_elems, lanes in regions:
                            # A replicated box is elected to ONE owner, so
                            # a duplicate (piece, box) holds equal values.
                            bucket.setdefault(box_key, (n_elems, lanes))
                if failed:
                    continue
                ok = True
                for i, shard in enumerate(entry.shards):
                    regions = merged.get(i, {})
                    if sum(n for n, _ in regions.values()) != math.prod(shard.sizes):
                        ok = False  # a rank missing, or the boxes did not cover it
                        break
                    digest = combine_partials(
                        (lanes for _, lanes in regions.values()),
                        array_size_bytes(shard.sizes, entry.dtype),
                    )
                    if digest != shard.array.device_digest:
                        ok = False
                        break
                if ok:
                    verified.add(lp)
        except Exception:  # noqa: BLE001 - lockstep safety
            # Malformed gathered data must not raise asymmetrically between
            # the gather and the key barrier.
            logger.exception("distributed digest verification: verdicts failed; reading normally")
            return set()
        applied = verified & eligible
        if applied:
            logger.info(
                "distributed digest verification: %d sharded entr%s (%.1f MB global) "
                "verified across process boundaries; no payload read",
                len(applied), "y" if len(applied) == 1 else "ies",
                sum(array_size_bytes(available[lp].shape, available[lp].dtype) for lp in applied) / 1e6,
            )
        return applied

    @staticmethod
    def _preverify_worthwhile(storage: StoragePlugin, explicit: bool) -> bool:
        """Whether this restore fingerprints its destinations to skip the
        reads of those that already hold their content (snapshot.py:1467-1515
        of the JAX package, for one process). A caller who passed
        ``device_digests=True`` is obeyed unless ``TORCHSNAPSHOT_GPU_PREVERIFY``
        says otherwise; with digests from the environment, the governor
        decides from this plugin's measured read rate against the device
        hash rate, which is probed once a process (one 16 MiB fingerprint,
        twice) as soon as a read rate is known."""
        if explicit and preverify_mode() == "auto":
            return True
        governor = io_governor()
        plugin = type(storage).__name__
        if governor.hash_bps() is None and governor.read_bps(plugin) is not None:
            from .device_digest import probe_hash_throughput

            probe_hash_throughput()
        decision = governor.should_preverify(plugin)
        if not decision:
            logger.info(
                "device-digest verification skipped: the measured read rate beats the "
                "hash rate (%s); reading is cheaper than fingerprinting",
                governor.measured_rates(),
            )
        return decision

    @staticmethod
    def _plan_reads(
        flattened: Dict[str, Any],
        available: Manifest,
        metadata: SnapshotMetadata,
        streams: DeviceStreams,
        device_digests: bool = False,
        preverified: Optional[Set[str]] = None,
        rank: int = 0,
        reshard: Optional[Any] = None,
        pagein: Optional[Any] = None,
        key: str = "",
    ) -> List[ReadReq]:
        """Plan one key's reads; primitives resolve into ``flattened`` with
        no I/O, and paths in ``preverified`` (the distributed preverify)
        plan none. ``reshard`` (a ``reshard.ReshardContext``) plans the
        sharded entries' peer roles. ``pagein`` (a
        ``pagein.PageInSession``) claims the eligible cold leaves here: their
        requests leave the eager set, a ``LeafFuture`` takes their place in
        ``flattened``, and their completions resolve the future instead."""
        preverified = preverified or set()
        read_reqs: List[ReadReq] = []
        for logical_path, obj in flattened.items():
            entry = available.get(logical_path)
            if entry is None:
                raise RuntimeError(
                    f"Unable to find entry for {logical_path!r} in the snapshot "
                    f"(saved with world size {metadata.world_size}, restoring as rank "
                    f"{rank}). Only replicated and sharded entries restore after a "
                    "world-size change; per-rank entries belong to the rank that saved them."
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
                if pagein is not None and pagein.deliver(lp, value):
                    return
                flattened[lp] = value

            reqs = prepare_read(
                entry, obj, _cb, streams, device_digests,
                assume_verified=logical_path in preverified, reshard=reshard,
            )
            if pagein is not None and reqs:
                future = pagein.claim_leaf(key, logical_path, entry, reqs, streams, obj)
                if future is not None:
                    flattened[logical_path] = future
                    continue
                pagein.note_eager_bytes(
                    sum(rr.buffer_consumer.get_consuming_cost_bytes() for rr in reqs))
            read_reqs.extend(reqs)
        return read_reqs

    @staticmethod
    def _group_read_reqs(
        read_reqs: List[ReadReq], batch: bool = True, priority=None
    ) -> List[Tuple[Optional[str], List[ReadReq]]]:
        """Reads grouped by the snapshot that holds their payload, this one
        first, then origins sorted; with ``batch``, ranged reads of one file
        within a group merge into spanning reads (snapshot.py:1711-1758 of
        the JAX package). ``priority`` maps a request to an int class (lower
        first); classes split groups and never coalesce, so a page-in's
        background page never gates a demand fault's read."""
        groups: Dict[Tuple[int, Optional[str]], List[ReadReq]] = {}
        for rr in read_reqs:
            cls = priority(rr) if priority is not None else 0
            groups.setdefault((cls, rr.origin), []).append(rr)
        ordered = sorted(groups.items(),
                         key=lambda kv: (kv[0][0], kv[0][1] is not None, kv[0][1] or ""))
        if batch:
            return [(origin, batch_read_requests(reqs)) for (_, origin), reqs in ordered]
        return [(origin, reqs) for (_, origin), reqs in ordered]

    def _execute_grouped(
        self,
        read_reqs: List[ReadReq],
        storage: StoragePlugin,
        budget: int,
        event_loop: asyncio.AbstractEventLoop,
        batch: bool = True,
        rank: int = 0,
        origin_mirrors: Optional[Dict[str, str]] = None,
    ) -> None:
        self._execute_groups(
            self._group_read_reqs(read_reqs, batch), storage, budget, event_loop, rank=rank,
            origin_mirrors=origin_mirrors,
        )

    def _execute_groups(
        self,
        groups: List[Tuple[Optional[str], List[ReadReq]]],
        storage: StoragePlugin,
        budget: int,
        event_loop: asyncio.AbstractEventLoop,
        rank: int = 0,
        coop: Optional[Any] = None,
        origin_mirrors: Optional[Dict[str, str]] = None,
    ) -> None:
        """Run grouped reads, each group through a storage plugin opened on
        its origin (this snapshot's own plugin for the local group), under
        the key's peer plan ``coop``."""
        for origin, reqs in groups:
            if origin is None:
                sync_execute_read_reqs(reqs, storage, budget, rank, event_loop, coop=coop)
                continue
            # An origin reads through its own mirror (recorded in this
            # snapshot's origin_mirrors), never through this snapshot's,
            # so a chain survives the loss of its bases' primaries
            # (snapshot.py:1786-1844 of the JAX package).
            origin_opts = strip_mirror_options(self._storage_options)
            origin_mirror = (origin_mirrors or {}).get(origin)
            if origin_mirror:
                origin_opts = {**(origin_opts or {}), "mirror_url": origin_mirror}
            origin_storage = url_to_storage_plugin(origin, origin_opts)
            try:
                sync_execute_read_reqs(reqs, origin_storage, budget, rank, event_loop, coop=coop)
            except FileNotFoundError as e:
                where = (
                    f"base snapshot {origin!r} or its mirror {origin_mirror!r}"
                    if origin_mirror else f"base snapshot {origin!r}"
                )
                raise RuntimeError(
                    f"Restoring from incremental snapshot {self.path!r}: a payload "
                    f"referenced in {where} is missing ({e}). Incremental snapshots "
                    "need their bases (or, when recorded, the bases' mirrors); "
                    "dedup.consolidate detaches a chain from its bases."
                ) from e
            finally:
                origin_storage.sync_close(event_loop)

    def read_object(
        self, path: str, obj_out: Any = None, memory_budget_bytes: Optional[int] = None
    ) -> Any:
        """Random-access read of one entry by manifest path
        (``"RANK/logical/path"``). A tensor ``obj_out`` (CPU or CUDA) is
        filled in place; with none, a CPU tensor or the object is returned.

        ``memory_budget_bytes`` bounds the host memory of the read: a
        tensor entry is read in byte ranges of at most that size, each
        filled into its flat slice of the destination as it lands (into a
        CUDA ``obj_out`` through a registered staging slab), and the
        scheduler admits ranges within the budget (snapshot.py:1852-1907
        of the JAX package). A compressed entry is read whole, and a
        sharded entry is assembled whole from its pieces, one piece a read.
        As in the JAX package, a budgeted read is not verified: the entry's
        checksum covers the whole payload, which no range sees."""
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

            read_reqs = prepare_read(
                entry, obj_out, _cb, DeviceStreams(),
                buffer_size_limit_bytes=memory_budget_bytes,
            )
            budget = memory_budget_bytes or get_process_memory_budget_bytes()
            self._execute_grouped(read_reqs, storage, budget, event_loop, batch=False,
                                  origin_mirrors=metadata.origin_mirrors)
            return box[0]
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()

    def read_state_dict(
        self,
        key: Optional[str] = None,
        rank: Optional[int] = None,
        memory_budget_bytes: Optional[int] = None,
    ) -> Any:
        """Materialize the snapshot with no destination (snapshot.py:1623-1709
        of the JAX package): containers rebuilt, primitives inlined,
        objects unpickled, and every array as a CPU ``torch.Tensor`` of its
        stored dtype (the JAX package returns numpy; bf16 stays bf16 here),
        a sharded entry assembled whole. A namedtuple comes back as its
        class only when that class is already imported, else as a plain
        tuple: no module a manifest names is imported (``flatten.inflate``).
        ``key`` selects one app-state key; None returns ``{key: state}`` for
        every key. ``rank`` (default: this process's rank) picks that
        rank's view under the elasticity rules: its own entries, the
        replicated and the sharded ones. Not collective.
        ``memory_budget_bytes`` bounds the scheduler's host memory
        (default: the process budget)."""
        r = PGWrapper(self.pg).get_rank() if rank is None else rank
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path, self._storage_options)
        try:
            metadata = self._read_metadata(storage, event_loop)
            manifest = get_manifest_for_rank(metadata, r)

            def selected(p: str) -> bool:
                return key is None or p == key or p.startswith(f"{key}/")

            flattened: Dict[str, Any] = {}
            read_reqs: List[ReadReq] = []
            streams = DeviceStreams()
            for logical_path, entry in manifest.items():
                if not selected(logical_path) or is_container_entry(entry):
                    continue
                if isinstance(entry, PrimitiveEntry):
                    flattened[logical_path] = entry.get_value()
                    continue

                def _cb(value: Any, lp: str = logical_path) -> None:
                    flattened[lp] = value

                read_reqs.extend(prepare_read(entry, None, _cb, streams))
            containers = {
                p: e for p, e in manifest.items() if is_container_entry(e) and selected(p)
            }
            if key is not None and not flattened and not read_reqs and not containers:
                raise RuntimeError(
                    f"No entries under {key!r} are visible to rank {r} in "
                    f"this snapshot (world size {metadata.world_size})."
                )
            budget = memory_budget_bytes or get_process_memory_budget_bytes()
            self._execute_grouped(read_reqs, storage, budget, event_loop, rank=r,
                                  origin_mirrors=metadata.origin_mirrors)
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()
        if key is not None:
            return inflate(containers, flattened, prefix=key)
        # One inflate per top-level key: app keys appear raw in logical
        # paths, so a synthetic root container would mis-resolve a key the
        # flattener escapes.
        out: Dict[str, Any] = {}
        for top in sorted({p.split("/", 1)[0] for p in list(containers) + list(flattened)}):
            mine = lambda p: p == top or p.startswith(f"{top}/")  # noqa: E731
            out[top] = inflate(
                {p: e for p, e in containers.items() if mine(p)},
                {p: v for p, v in flattened.items() if mine(p)},
                prefix=top,
            )
        return out

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
        try:
            if raw[:4] == b"TSCM":
                from . import colmanifest

                return colmanifest.decode_metadata(raw)
            return SnapshotMetadata.from_yaml(raw.decode("utf-8"))
        except Exception as e:  # noqa: BLE001 - any decode failure
            raise CorruptSnapshotError(
                self.path, f"undecodable metadata: {type(e).__name__}: {e}"
            ) from e


def _propagate_checksums(global_manifest: Manifest) -> None:
    """A replicated entry is recorded by every rank but staged only by the
    rank that writes each chunk: copy the stage-time fields (checksum,
    digest, origin, codec and the device fingerprint) to the other ranks'
    copies of the same location (snapshot.py:2432-2467 of the JAX package,
    which leaves the fingerprint on the writer's copy only). Every rank
    restores its own copy, so every copy must name the base for an origin
    and carry the fingerprint for a device-digest skip."""
    fields = ("checksum", "digest", "origin", "codec", "device_digest")

    def sub_entries(entry):
        if isinstance(entry, (ArrayEntry, ObjectEntry)):
            yield entry
        elif isinstance(entry, ChunkedArrayEntry):
            for part in entry.chunks:
                yield part.array
        elif isinstance(entry, ShardedArrayEntry):
            for part in entry.shards:
                yield part.array

    known: Dict[Tuple[str, str], Any] = {}
    blanks: Dict[str, List[Any]] = {f: [] for f in fields}
    for entry in global_manifest.values():
        for sub in sub_entries(entry):
            for field in fields:
                value = getattr(sub, field, None)
                if value is not None:
                    known.setdefault((field, sub.location), value)
                else:
                    blanks[field].append(sub)
    for field, subs in blanks.items():
        for sub in subs:
            value = known.get((field, sub.location))
            if value is not None:
                setattr(sub, field, value)


def _partition_write_units(
    flattened: Dict[str, Any], replicated_paths: Set[str], rank: int, world_size: int
) -> Tuple[Dict[str, List[Tuple[List[int], List[int]]]], Set[str]]:
    """Stripe the replicated write units (tensor chunks and objects) over
    the ranks: largest first, to the least-loaded rank, every tie broken
    the same way on every rank, so every rank computes the same partition
    from its verified-identical inputs with no communication
    (snapshot.py:2541-2601 of the JAX package). Returns ({logical path:
    the chunks this rank writes}, {the replicated objects this rank
    writes}); other tensors write every chunk."""
    chunk_assignments: Dict[str, List[Tuple[List[int], List[int]]]] = {}
    owned_objects: Set[str] = set()
    pool: List[Tuple[int, str, Optional[Tuple[List[int], List[int]]]]] = []
    for logical_path in sorted(flattened):
        obj = flattened[logical_path]
        if is_sharded_dtensor(obj):
            continue
        if isinstance(obj, torch.Tensor):
            dtype_str = dtype_to_string(obj.dtype)
            chunks = ChunkedArrayIOPreparer.chunk_shards(tuple(obj.shape), dtype_str)
            if logical_path in replicated_paths and world_size > 1:
                chunk_assignments[logical_path] = []
                for offsets, sizes in chunks:
                    pool.append((array_size_bytes(sizes, dtype_str), logical_path, (offsets, sizes)))
            else:
                chunk_assignments[logical_path] = chunks
        elif PrimitivePreparer.should_inline(obj):
            continue
        elif logical_path in replicated_paths and world_size > 1:
            pool.append((1024, logical_path, None))
        else:
            owned_objects.add(logical_path)
    pool.sort(key=lambda t: (-t[0], t[1], t[2] or ([], [])))
    for (_, logical_path, chunk), target in zip(
        pool, greedy_size_balanced([t[0] for t in pool], world_size)
    ):
        if target == rank:
            if chunk is None:
                owned_objects.add(logical_path)
            else:
                chunk_assignments[logical_path].append(chunk)
    return chunk_assignments, owned_objects


def _prepare_chunked_array_write(
    storage_path_prefix: str,
    tensor: torch.Tensor,
    streams: DeviceStreams,
    copy_cpu: bool,
    local_chunks: List[Tuple[List[int], List[int]]],
    replicated: bool,
) -> Tuple[ChunkedArrayEntry, List[WriteReq]]:
    """Writes of this rank's chunks; the entry of a replicated tensor
    records every chunk (their locations are deterministic), reusing the
    sub-entries of this rank's own stripe, which staging fills in
    (snapshot.py:2488-2538 of the JAX package)."""
    entry, write_reqs = ChunkedArrayIOPreparer.prepare_write(
        storage_path_prefix, tensor, streams, copy_cpu, replicated=replicated,
        local_chunks=local_chunks,
    )
    if not replicated:
        return entry, write_reqs
    dtype_str = dtype_to_string(tensor.dtype)
    local_by_loc = {c.array.location: c.array for c in entry.chunks}
    full: List[Shard] = []
    for offsets, sizes in ChunkedArrayIOPreparer.chunk_shards(tuple(tensor.shape), dtype_str):
        suffix = "_".join(str(o) for o in offsets)
        location = f"{storage_path_prefix}_{suffix}" if suffix else storage_path_prefix
        full.append(
            Shard(
                offsets=list(offsets),
                sizes=list(sizes),
                array=local_by_loc.get(location)
                or ArrayEntry(
                    location=location,
                    serializer=Serializer.BUFFER_PROTOCOL.value,
                    dtype=dtype_str,
                    shape=list(sizes),
                    replicated=True,
                ),
            )
        )
    return (
        ChunkedArrayEntry(dtype=dtype_str, shape=list(tensor.shape), chunks=full, replicated=True),
        write_reqs,
    )


class PendingSnapshot:
    """Handle to an in-flight ``async_take`` (snapshot.py:2604-2787 of the
    JAX package). A background thread drains the storage writes, meets
    the other ranks on a store :class:`~.dist_store.LinearBarrier`, and
    rank 0 commits between its two phases; a failure on any rank reaches
    the others through the barrier, and no rank commits. The thread talks
    only to the store, over a connection of its own."""

    def __init__(
        self,
        path: str,
        pg: Any,
        storage_options: Optional[Dict[str, Any]],
        pending_io_work: PendingIOWork,
        pg_wrapper: PGWrapper,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        barrier_timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S,
        telemetry_op: Optional[_OpTelemetry] = None,
        admission: Optional[Any] = None,
    ) -> None:
        self.path = path
        self._tm = telemetry_op
        self._admission = admission
        self._exc: Optional[BaseException] = None
        self._snapshot = Snapshot(path, pg, storage_options)
        self._snapshot._metadata = metadata
        # The barrier's id is agreed on the caller's thread (a store op).
        barrier_id = pg_wrapper.broadcast_object(
            f"commit-{uuid.uuid4().hex}" if pg_wrapper.get_rank() == 0 else None, src=0
        )
        self._thread = threading.Thread(
            target=self._complete,
            args=(pending_io_work, pg_wrapper, metadata, storage, event_loop, barrier_id,
                  barrier_timeout_s),
            name="tsnap-gpu-commit",
            daemon=True,
        )
        self._thread.start()

    def _complete(
        self,
        pending_io_work: PendingIOWork,
        pg_wrapper: PGWrapper,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        barrier_id: str,
        barrier_timeout_s: float,
    ) -> None:
        barrier = None
        try:
            if pg_wrapper.get_world_size() > 1:
                # Nested under the wrapper's namespace, so the barrier's
                # keys go when every rank has retired it.
                barrier = LinearBarrier(
                    prefix=f"{pg_wrapper._namespace()}/commit/{barrier_id}",
                    store=pg_wrapper.pg.store.clone(),
                    rank=pg_wrapper.get_rank(),
                    world_size=pg_wrapper.get_world_size(),
                )
            pending_io_work.sync_complete(event_loop)
            _drain_background_storage(storage, event_loop)
            tm = self._tm
            if tm is not None:
                tm.timer.mark("io_drain")
            if barrier is not None:
                barrier.arrive(timeout=barrier_timeout_s)
            if pg_wrapper.get_rank() == 0:
                Snapshot._write_snapshot_metadata(metadata, storage, event_loop)
            if barrier is not None:
                barrier.depart(timeout=barrier_timeout_s)
            if tm is not None:
                tm.timer.mark("commit")
                _publish_telemetry(tm, pg_wrapper, storage, event_loop, persist=True,
                                   gather=False)
        except BaseException as e:  # noqa: B036 - re-raised by wait()
            if barrier is not None:
                try:
                    barrier.report_error(e)
                except Exception:  # noqa: BLE001 - the original error wins
                    pass
            if self._tm is not None:
                self._tm.abort(e)
            self._exc = e
            logger.exception("async_take failed; the snapshot was not committed.")
        finally:
            if self._tm is not None:
                self._tm.close()
            tenancy_admission.disarm(storage, self._admission)
            try:
                pg_wrapper.retire()
            except Exception:  # noqa: BLE001 - store hygiene only
                pass
            if barrier is not None:
                try:
                    barrier.store.close()
                except Exception:  # noqa: BLE001 - a closed store is fine
                    pass
            try:
                storage.sync_close(event_loop)
            except Exception as e:  # noqa: BLE001 - reaches wait()
                # The mirror tier commits here: its error must reach
                # wait(), or a durable copy that does not exist is reported.
                if self._exc is None:
                    self._exc = e
                logger.exception("storage close failed after the commit.")
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


def _cuda_devices(app_state: AppState) -> List[torch.device]:
    """The CUDA devices of the tensors in ``app_state``'s state dicts."""
    devices: Dict[torch.device, None] = {}
    for stateful in app_state.values():
        for leaf in flatten(stateful.state_dict())[1].values():
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                devices[leaf.device] = None
    return list(devices)


class PendingRestore:
    """Handle over a restore running on a background thread
    (snapshot.py:2790-2832 of the JAX package). ``wait()`` joins it and
    re-raises its failure; ``done()`` says whether it has ended.

    CUDA ordering. At ``async_restore`` the caller's current stream of
    each CUDA device its state lives on records an event: the restore's
    device work (its side-stream copies, device fingerprints and
    ``load_state_dict``) orders after what the caller queued before the
    call, such as a zero fill of the destination, and not after what it
    queues later, so the caller's later kernels and the restore's copies
    can overlap. The thread selects the destination's device (a new thread
    starts on device 0) and runs its device work on a stream of its own
    that waits on that event.

    Consistency point: ``wait()``. The thread synchronizes every stream
    the restore used (each copy's event is also waited on before the copy
    is counted done) before it signals done, so when ``wait()`` returns
    the restored bytes are in device memory, and work the caller then
    queues on any stream sees them with no synchronization of its own.
    Byte work runs in the scheduler's executor through ``np.copyto`` and
    the native library, which release the GIL."""

    def __init__(
        self,
        snapshot: Snapshot,
        app_state: AppState,
        device_digests: Optional[bool] = None,
        pg_wrapper: Optional[PGWrapper] = None,
    ) -> None:
        self._exc: Optional[BaseException] = None
        self._done_event = threading.Event()
        ordering = []
        for device in _cuda_devices(app_state):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            ordering.append((device, event))
        self._thread = threading.Thread(
            target=self._run,
            args=(snapshot, app_state, device_digests, ordering, pg_wrapper),
            name="tsnap-gpu-async-restore",
            daemon=True,
        )
        self._thread.start()

    def _run(self, snapshot, app_state, device_digests, ordering, pg_wrapper) -> None:
        used: List[DeviceStreams] = []

        def new_streams() -> DeviceStreams:
            used.append(DeviceStreams())
            return used[-1]

        try:
            with contextlib.ExitStack() as stack:
                own = []
                if ordering:
                    torch.cuda.set_device(ordering[0][0])
                for device, event in ordering:
                    stream = torch.cuda.Stream(device)
                    stream.wait_event(event)
                    stack.enter_context(torch.cuda.stream(stream))
                    own.append(stream)
                try:
                    snapshot._restore_impl(app_state, device_digests, new_streams, pg_wrapper)
                finally:
                    for streams in used:
                        streams.synchronize()
                    for stream in own:
                        stream.synchronize()
        except BaseException as e:  # noqa: B036 - re-raised by wait()
            self._exc = e
        finally:
            self._done_event.set()

    def wait(self) -> None:
        """Block until the restore has ended; re-raises its failure."""
        self._thread.join()
        if self._exc is not None:
            raise self._exc

    def done(self) -> bool:
        return self._done_event.is_set()
