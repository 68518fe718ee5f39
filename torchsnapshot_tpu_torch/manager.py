"""CheckpointManager: training-loop cadence and retention over Snapshot.

Counterpart of ``torchsnapshot_tpu/manager.py``. A training
loop calls ``save(step, app_state)`` every step; the manager decides when a
snapshot is due, names it, chains it incrementally to the previous one,
enforces the retention policy and handles preemption, and exposes
``latest_step``/``restore`` for resume::

    mgr = CheckpointManager(
        "/ckpts",
        save_interval_steps=1000,
        keep_last=3,            # the newest 3 survive
        keep_every=10_000,      # plus archival keeps at these steps
        async_save=True,        # block only for staging
        incremental=True,       # dedup against the previous snapshot
        device_digests=True,    # ... deciding on the device, before any copy
        compression="zlib",     # payloads stored compressed where they shrink
    )
    for step in range(n_steps):
        ...
        mgr.save(step, app_state)     # no-op unless due
    mgr.wait()                        # drain a pending async save

    # on restart:
    if mgr.latest_step() is not None:
        mgr.restore(app_state)

Semantics:

- Snapshots live at ``<root>/step_<N:010d>`` (lexical order is numeric).
- At most one async save is in flight; a due save first drains the
  previous one (its retention pass included).
- Retention runs after each commit (``retention.plan_retention``): the
  newest ``keep_last`` and every ``keep_every`` multiple survive, plus any
  snapshot that a survivor needs, transitively, as a base. Names the
  manager did not make are never deleted. Retention and ``latest_step``
  need a local filesystem root.
- ``incremental=True`` records digests on every save and chains each
  snapshot to the previous committed one; ``device_digests=True`` makes the
  comparison on the device (kernel K4), so unchanged CUDA tensors are
  neither copied to the host nor written, and restores skip destinations
  that already hold their content.
- A committed step is never overwritten: a resumed loop that saves the
  restored step again skips it.

- ``compression`` is every save's codec (``compression.py``), validated
  when the manager is built.
- ``warmup`` allocates and registers the staging slabs the first save
  draws (``warmup_staging``), and under ``device_digests`` launches K4
  once per piece, so the kernel is built before the first save.

- Over a world of several processes (``pg``, else the default group)
  every rank calls ``save`` and ``restore`` at the same steps. Rank 0
  decides whether a step is already committed and broadcasts it, reclaims
  orphaned partial directories and releases the peers only after (a
  broadcast), and alone applies retention; the preemption decision is a
  collective (manager.py:440-462, :530-546, :600-720 of the JAX package).

- ``storage_options={"mirror_url": root}`` names the mirror ROOT: each
  step mirrors into its own subdirectory (``_options_for``), and a crashed
  save's partial mirror tree is reclaimed with its primary.
- With ``TORCHSNAPSHOT_GPU_JOURNAL=1`` every save arms a delta journal
  (``journal.py``) against the state as saved; ``journal_step`` appends
  the leaves that changed since the last durable state as one committed
  epoch (a journal bound turns it into a full save); on a preemption the
  open journal is flushed as one epoch instead of a full emergency save;
  a restore replays the committed epochs and re-arms the journal.
- With ``TORCHSNAPSHOT_GPU_GEOREP=<remote root>`` rank 0 runs a
  geo-replication shipper (``georep.py``): every committed base and
  journal epoch is shipped to the remote tier in the background, and a
  preemption drains it within ``TORCHSNAPSHOT_GPU_GEOREP_DRAIN_S``.

- With a ``tenant`` (or ``TORCHSNAPSHOT_GPU_TENANT``) the manager's steps
  live under ``<root>/tenants/<id>/`` (``tenancy/``): its registry row is
  published at the first save, a quota is enforced before any payload I/O,
  committed payloads are swept into the shared content-addressed pool, and
  every op runs with the tenant active (scoped store keys).
- ``push_update`` ships the committed journal epochs to the live replicas
  registered for the base step (``distrib.UpdateReceiver``); under
  ``TORCHSNAPSHOT_GPU_UPDATE_PUSH`` every ``journal_step`` pushes after its
  epoch commits.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from . import device_digest, journal, telemetry, tenancy
from .compression import resolve_codec
from .flatten import flatten
from .io_preparers.array import warmup_staging
from .io_preparers.chunked import ChunkedArrayIOPreparer
from .io_preparers.prepare import is_dtensor, is_sharded_dtensor
from .io_preparers.sharded import ShardedArrayIOPreparer, dtensor_view
from .pg_wrapper import PGWrapper
from .preemption import PreemptionWatcher
from .retention import apply_retention, plan_retention
from .serialization import dtype_to_string, effective_save_dtype
from .snapshot import SNAPSHOT_METADATA_FNAME, PendingSnapshot, Snapshot
from .storage_plugin import local_fs_root
from .stateful import AppState
from .telemetry import health

logger = logging.getLogger(__name__)

# Only the manager's own naming (10-digit zero-padded) is discovered:
# accepting other step_<N> spellings would make latest_step() find
# snapshots that path_for() and retention address under another name.
_STEP_RE = re.compile(r"^step_(\d{10})$")


def _step_name(step: int) -> str:
    if step < 0:
        raise ValueError(f"step must be >= 0, got {step}")
    return f"step_{step:010d}"


class CheckpointManager:
    def __init__(
        self,
        root: str,
        *,
        save_interval_steps: int = 1,
        keep_last: Optional[int] = None,
        keep_every: Optional[int] = None,
        async_save: bool = False,
        incremental: bool = False,
        device_digests: Optional[bool] = None,
        compression: Optional[str] = None,
        save_dtype: Optional[Dict[str, str]] = None,
        replicated: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        pg: Any = None,
        preemption: Optional[PreemptionWatcher] = None,
        tenant: Optional[tenancy.Tenant] = None,
    ) -> None:
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1 (or None to keep all)")
        if keep_every is not None and keep_every < 1:
            raise ValueError("keep_every must be >= 1 (or None)")
        PGWrapper(pg)  # a world of several processes needs a store: fail now
        resolve_codec(compression)  # fail on a bad spec now, not at the first save
        # Tenancy: an explicit tenant wins, else the ambient one (the
        # disabled path's one env check). The tenant's steps, retention and
        # store keys live under its namespace; ``root`` stays the shared
        # root, beside which the cross-tenant payload pool lives.
        self._tenant = tenant if tenant is not None else tenancy.tenant_from_env()
        self._shared_root = root
        if self._tenant is not None:
            root = tenancy.tenant_root(root, self._tenant)
        self.root = root
        self.save_interval_steps = save_interval_steps
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.async_save = async_save
        self.incremental = incremental
        # Resolved once, here, so warmup and the saves it warms can never
        # disagree if the env var changes between them.
        if device_digests is None:
            device_digests = device_digest.enabled_by_env()
        self.device_digests = bool(device_digests)
        self.compression = compression
        self.save_dtype = save_dtype
        self.replicated = replicated
        self.storage_options = storage_options
        self.pg = pg
        self.preemption = preemption
        self._retention_skip_warned = False
        self._pending: Optional[PendingSnapshot] = None
        self._pending_step: Optional[int] = None
        self._last_committed: Optional[int] = self.latest_step()
        # The delta journal bound to the last committed base, armed by each
        # save under TORCHSNAPSHOT_GPU_JOURNAL=1 (journal_step).
        self._journal: Optional[journal.DeltaJournal] = None
        # The rolling-update push cursor (distrib.py): per live replica,
        # the last epoch shipped, so repeat pushes are incremental.
        # Receivers dedup anyway; a new base step resets it.
        self._push_cursor: Dict[str, int] = {}
        # The page-in session of the last restore (pagein.py), None when
        # the lazy election did not engage.
        self.last_pagein: Optional[Any] = None
        # The tenant's registry row, published at the first save (the
        # store may not be reachable at construction).
        self._tenant_registered = False
        # The geo-replication shipper (georep.py), rank 0 only: committed
        # bases enqueue from _committed, committed epochs through the
        # journal's commit hook, and a preemption's consume() drains it.
        self._georep: Optional[Any] = None
        self._georep_hook: Optional[Any] = None
        from . import georep

        georep_url = georep.remote_url()
        if georep_url is not None and PGWrapper(self.pg).get_rank() == 0:
            rep = georep.GeoReplicator(georep_url, storage_options=self.storage_options)
            self._georep = rep

            def _georep_on_epoch(base_dir: str, base_step: int, _epoch: int) -> None:
                rep.enqueue(base_dir, base_step)

            self._georep_hook = _georep_on_epoch
            journal.register_commit_hook(_georep_on_epoch)
            if self.preemption is not None:
                self.preemption.add_consume_hook(rep.drain)
        # Warm-start the governor's learned profiles from this root's
        # history journal, so the first save already runs the converged
        # elections (manager.py:197-210 of the JAX package). Local roots
        # only; one env check under AUTOTUNE=never; never raises.
        try:
            from .scheduler import autotune_mode, io_governor

            if autotune_mode() != "never":
                governor = io_governor()
                governor.note_world(PGWrapper(self.pg).get_world_size())
                local = local_fs_root(self.root)
                if local is not None:
                    governor.load_profiles(os.path.abspath(local))
        except Exception:  # noqa: BLE001 - the warm start is advisory
            logger.debug("profile warm start skipped", exc_info=True)

    def _register_tenant(self) -> None:
        """Publish this tenant's registry row (rank 0, once, best effort) on
        the global store plane: arbitration readers see every tenant."""
        if self._tenant is None or self._tenant_registered:
            return
        self._tenant_registered = True
        if PGWrapper(self.pg).get_rank() != 0:
            return
        try:
            from . import distrib
            from .tenancy import registry as tenant_registry

            store = distrib._registry_store_raw(PGWrapper(self.pg))
            if store is not None:
                tenant_registry.register(store, self._tenant)
        except Exception:  # noqa: BLE001 - the registry is advisory
            logger.debug("tenant registration skipped", exc_info=True)

    def close(self) -> None:
        """Wait out a pending async save, drain the geo-replication backlog
        (bounded by ``TORCHSNAPSHOT_GPU_GEOREP_DRAIN_S``) and plant this
        tenant's registry death notice (the ghost key)."""
        self.wait()
        if self._georep is not None:
            if self._georep_hook is not None:
                journal.unregister_commit_hook(self._georep_hook)
                self._georep_hook = None
            if not self._georep.close():
                logger.warning(
                    "geo-replication drain timed out at close; remote tier %s is behind "
                    "(last error: %s)", self._georep.remote_root, self._georep.last_error,
                )
            self._georep = None
        if self._tenant is not None and self._tenant_registered:
            if PGWrapper(self.pg).get_rank() == 0:
                try:
                    from . import distrib
                    from .tenancy import registry as tenant_registry

                    store = distrib._registry_store_raw(PGWrapper(self.pg))
                    if store is not None:
                        tenant_registry.deregister(store, self._tenant.id)
                except Exception:  # noqa: BLE001
                    logger.debug("tenant deregister skipped", exc_info=True)
            self._tenant_registered = False

    # ----------------------------------------------------------- paths

    def _local_dir(self) -> Optional[str]:
        return local_fs_root(self.root)

    def _shared_dir(self) -> Optional[str]:
        """Local root of the shared (pre-tenant) root, where the payload
        pool lives; None without a tenant."""
        if self._tenant is None:
            return None
        return local_fs_root(self._shared_root)

    @staticmethod
    def _step_like(name: str) -> bool:
        """Quota retention demotes only the manager's own steps."""
        return bool(_STEP_RE.match(name))

    def _activated(self):
        """This manager's tenant made active for the calling thread, so
        key-construction sites (heartbeats, seed and update registries)
        resolve its namespace."""
        import contextlib

        if self._tenant is None:
            return contextlib.nullcontext()
        return tenancy.activated(self._tenant)

    def path_for(self, step: int) -> str:
        sep = "" if self.root.endswith("/") else "/"
        return f"{self.root}{sep}{_step_name(step)}"

    def _options_for(self, step: int) -> Optional[Dict[str, Any]]:
        """Per-step storage options: a configured ``mirror_url`` is the
        mirror root, and each step mirrors into its own subdirectory, or
        every step's replica would overwrite the last one in place."""
        if not self.storage_options or not self.storage_options.get("mirror_url"):
            return self.storage_options
        opts = dict(self.storage_options)
        opts["mirror_url"] = f"{opts['mirror_url'].rstrip('/')}/{_step_name(step)}"
        return opts

    # ------------------------------------------------------- inventory

    def all_steps(self) -> List[int]:
        """Committed steps under a local root, ascending ([] for remote)."""
        dirpath = self._local_dir()
        if dirpath is None or not os.path.isdir(dirpath):
            return []
        steps = []
        for name in os.listdir(dirpath):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(os.path.join(dirpath, name, SNAPSHOT_METADATA_FNAME)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------ save

    def warmup(self, app_state: AppState) -> int:
        """Prepare for the first ``save``. Under ``device_digests``, launch
        K4 once on every CUDA piece the save will fingerprint (at the
        ``save_dtype`` it stages and the chunk boundaries it uses), all
        dispatched before one fetch, so the kernel is built and loaded
        before the first save's blocking window. Then allocate and register
        the staging slabs the save draws (``warmup_staging``): every CUDA
        piece's, and the CPU pieces' only without ``incremental``,
        ``compression`` and ``device_digests``, whose staging copies CPU
        tensors without the pool. Returns the bytes newly allocated or
        registered."""
        if self.device_digests:
            self._warmup_fingerprints(app_state)
        return warmup_staging(
            app_state,
            replicated=self.replicated,
            save_dtype=self.save_dtype,
            host_copies=not (self.incremental or self.compression or self.device_digests),
        )

    def _warmup_fingerprints(self, app_state: AppState) -> None:
        pendings = []
        for key, stateful in app_state.items():
            for logical_path, leaf in flatten(stateful.state_dict(), prefix=key)[1].items():
                if not (isinstance(leaf, torch.Tensor) and leaf.is_cuda):
                    continue
                target = effective_save_dtype(logical_path, leaf.dtype, self.save_dtype or {})
                piece = leaf.detach() if target is None else leaf.detach().to(target)
                if is_sharded_dtensor(piece):
                    subs = [p for _, _, p in ShardedArrayIOPreparer._owned_pieces(dtensor_view(piece))]
                else:
                    if is_dtensor(piece):
                        piece = piece.to_local()
                    subs = [
                        piece[offsets[0] : offsets[0] + sizes[0]] if offsets else piece
                        for offsets, sizes in ChunkedArrayIOPreparer.chunk_shards(
                            tuple(piece.shape), dtype_to_string(piece.dtype)
                        )
                    ]
                for sub in subs:
                    pending = device_digest._dispatch(sub)
                    if pending is not None:
                        pendings.append(pending)
        if pendings:
            # The sync point: the wait on the fetch's CUDA event.
            device_digest._fetch(pendings)

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    def _already_committed(self, step: int) -> bool:
        """Whether ``step`` is committed, rank 0's answer on every rank: a
        rank-local scan could let rank 0 skip while its peers enter the
        collective take and hang."""

        def local_opinion() -> bool:
            return step == self._last_committed or (
                self._local_dir() is not None and step in self.all_steps()
            )

        pg = PGWrapper(self.pg)
        if pg.get_world_size() == 1:
            return local_opinion()
        try:
            return bool(pg.broadcast_object(local_opinion() if pg.get_rank() == 0 else None))
        finally:
            pg.retire()

    def save(self, step: int, app_state: AppState, *, force: bool = False) -> bool:
        with self._activated():
            return self._save_impl(step, app_state, force=force)

    def _save_impl(self, step: int, app_state: AppState, *, force: bool = False) -> bool:
        """Snapshot ``app_state`` if ``step`` is due (or ``force``). Returns
        True when a save was started or completed. With ``async_save`` it
        blocks only for staging, after draining a previous pending save.

        With a ``preemption`` watcher, every call also asks it whether to
        emergency-save: on a preemption the current step saves regardless
        of cadence, synchronously (the process is about to die; an async
        save's commit could be killed mid-write), and the watcher is
        consumed."""
        emergency = False
        if self.preemption is not None and not self.preemption.consumed:
            if self.preemption.should_save(pg=self.pg):
                emergency = True
                logger.warning("preemption flagged: emergency snapshot at step %d", step)
        if emergency and self._journal_emergency_flush(app_state):
            # A committed journal epoch is a recoverable state: flushing
            # the open journal replaces the full emergency save inside the
            # grace window. Every guard is rank-consistent, and
            # append_epoch raises on every rank or none.
            self.preemption.consume()
            logger.warning(
                "preemption flagged: journal epoch flushed at step %d (emergency full "
                "save skipped)", step,
            )
            return False
        if not force and not emergency and not self.should_save(step):
            return False
        self.wait()  # at most one pending; also runs its retention
        if self._already_committed(step):
            # A resumed loop re-runs the restored step: never overwrite a
            # committed snapshot (non-atomically, and under incremental with
            # itself as the base).
            if emergency:
                # The committed snapshot of this step is the resume point.
                self.preemption.consume()
                logger.warning(
                    "preemption at already-committed step %d: existing snapshot is "
                    "the resume point; nothing re-saved",
                    step,
                )
                return False
            logger.info("step %d already has a committed snapshot; skipping", step)
            return False
        self._gc_orphaned_partials(step)
        # Rank 0 releases the peers only after its reclaim pass, so no
        # peer lands payloads in a directory the pass deletes.
        pg = PGWrapper(self.pg)
        if pg.get_world_size() > 1:
            try:
                pg.broadcast_object("gc-done" if pg.get_rank() == 0 else None)
            finally:
                pg.retire()
        if self._tenant is not None:
            self._register_tenant()
            # The quota gate, before any payload I/O: an over-quota save is
            # a clean error, never a torn partial. Collective.
            from .tenancy import quota

            quota.ensure_capacity(self)
        path = self.path_for(step)
        base = (
            self.path_for(self._last_committed)
            if self.incremental and self._last_committed is not None
            else None
        )
        kwargs: Dict[str, Any] = dict(
            pg=self.pg,
            replicated=self.replicated,
            storage_options=self._options_for(step),
            incremental_base=base,
            record_digests=self.incremental,
            device_digests=self.device_digests,
            save_dtype=self.save_dtype,
            compression=self.compression,
        )
        use_async = self.async_save and not emergency
        # The take's telemetry summary carries the manager's context, and
        # the heartbeat its step (telemetry.annotate_next_op, health).
        telemetry.annotate_next_op(
            step=step, mode="emergency" if emergency else ("async" if use_async else "sync"),
            incremental_base=base,
        )
        health.update(step=step)
        if use_async:
            self._pending = Snapshot.async_take(path, app_state, **kwargs)
            self._pending_step = step
        else:
            Snapshot.take(path, app_state, **kwargs)
            self._committed(step)
        # Arm the journal against the state as saved: a capture at the
        # first journal_step would lose any change in between. After an
        # async save the journal waits for wait() to commit the base.
        self._journal_seed(step, app_state)
        if emergency:
            self.preemption.consume()
            logger.warning("emergency snapshot committed at step %d", step)
        return True

    def _gc_orphaned_partials(self, step: int) -> None:
        """Fenced GC: reclaim step directories at or below ``step`` that a
        crashed writer left without ``.snapshot_metadata`` (payloads, maybe
        a commit fence), before taking ``step`` (manager.py:605-626 of the
        JAX package). Local roots only.

        Safety comes from the commit-fence protocol, not from timing:

        - only step directories ``<= step`` are touched: under the
          ordered-save contract nothing older can still be in flight (a
          pending async save was drained by ``save`` before this runs);
        - a resurrected straggler of a reclaimed directory (an async
          commit thread of an earlier incarnation of this job) cannot
          commit into it: its fence, planted before its ``async_take``
          returned, went with the directory, so its commit aborts with
          :class:`~torchsnapshot_tpu_torch.snapshot.StaleCommitError` and
          writes nothing (``snapshot.SNAPSHOT_FENCE_FNAME``). The residual
          window is one storage round trip, a straggler suspended between
          its passing fence read and its metadata write
          (``Snapshot._write_snapshot_metadata``)."""
        if PGWrapper(self.pg).get_rank() != 0:
            return  # rank 0 reclaims for the world
        primary_dir = self._local_dir()
        roots = [primary_dir]
        mirror_root = (self.storage_options or {}).get("mirror_url")
        if mirror_root and primary_dir is not None:
            # The mirror tier holds a second partial tree of a crashed
            # mirrored save. Without a scannable primary, committed steps
            # cannot be told from rubble: the mirror is left alone.
            roots.append(local_fs_root(mirror_root.rstrip("/")))
        for dirpath in roots:
            if dirpath is None or not os.path.isdir(dirpath):
                continue
            for name in sorted(os.listdir(dirpath)):
                m = _STEP_RE.match(name)
                if not m or int(m.group(1)) > step:
                    continue
                partial = os.path.join(dirpath, name)
                if not os.path.isdir(partial):
                    continue
                if os.path.exists(os.path.join(partial, SNAPSHOT_METADATA_FNAME)):
                    continue
                if dirpath is not primary_dir and os.path.exists(
                    os.path.join(primary_dir, name, SNAPSHOT_METADATA_FNAME)
                ):
                    # A committed primary's metadata-less mirror tree is
                    # degraded failover data (its mirror commit was
                    # withheld after a failed write), not rubble.
                    continue
                logger.warning(
                    "reclaiming partial snapshot directory %s (no committed metadata; a "
                    "previous writer died mid-save)",
                    partial,
                )
                shutil.rmtree(partial, ignore_errors=True)

    def wait(self) -> None:
        """Drain a pending async save (no-op otherwise); re-raises its
        failure. Runs the retention pass for the committed snapshot."""
        if self._pending is None:
            return
        pending, step = self._pending, self._pending_step
        self._pending = None
        self._pending_step = None
        pending.wait()
        self._committed(step)

    def _committed(self, step: int) -> None:
        self._last_committed = step
        if self._georep is not None:
            self._georep.enqueue(self.path_for(step), step)
        self._pool_sweep(step)
        self._apply_retention()

    def _pool_sweep(self, step: int) -> None:
        """Post-commit cross-tenant dedup: move this step's eligible
        payloads into the shared content-addressed pool and repoint its
        manifest. Rank 0, local roots, tenants only; a failure degrades
        dedup, never the commit."""
        if self._tenant is None or PGWrapper(self.pg).get_rank() != 0:
            return
        shared, dirpath = self._shared_dir(), self._local_dir()
        if shared is None or dirpath is None:
            return
        from .tenancy import pool

        try:
            released, n = pool.sweep_step(shared, self._tenant.id,
                                          os.path.join(dirpath, _step_name(step)))
        except Exception:  # noqa: BLE001
            logger.warning("pool sweep failed for step %d", step, exc_info=True)
            return
        if n:
            telemetry.counter_add("pool_bytes_released", released)
            logger.info("pool sweep: step %d shares %d payload(s) (%d bytes released) via %s",
                        step, n, released, pool.pool_root(shared))

    # --------------------------------------------------- delta journal

    def _journal_seed(self, step: int, app_state: AppState) -> None:
        """Bind a fresh journal to the snapshot of ``step`` and fingerprint
        the state as saved (``TORCHSNAPSHOT_GPU_JOURNAL=1`` only)."""
        self._journal = None
        if not journal.enabled_by_env():
            return
        local = local_fs_root(self.path_for(step))
        if local is None:
            logger.warning(
                "delta journaling needs a shared local filesystem root; %s is remote: "
                "journaling disabled", self.root,
            )
            return
        j = journal.DeltaJournal(local, base_step=step, rank=PGWrapper(self.pg).get_rank())
        j.capture_baseline(app_state)
        self._journal = j
        self._push_cursor = {}

    def _journal_ready(self) -> bool:
        return (
            self._journal is not None
            and self._journal.armed
            and self._pending is None
            and self._journal.base_step == self._last_committed
        )

    def journal_step(self, step: int, app_state: AppState) -> bool:
        with self._activated():
            return self._journal_step_impl(step, app_state)

    def _journal_step_impl(self, step: int, app_state: AppState) -> bool:
        """Append one journal epoch of the leaves that changed since the
        last durable state (the base snapshot or the previous epoch).
        Returns True when the state became durable at this step (an epoch
        committed, or a journal bound turned the call into a forced full
        save), False when journaling is off, no base has committed yet (an
        async save in flight included) or the root is remote. Collective,
        like ``save``. Under ``TORCHSNAPSHOT_GPU_UPDATE_PUSH`` a committed
        epoch is then pushed to the live replicas (best effort)."""
        if not journal.enabled_by_env() or not self._journal_ready():
            return False
        pg = PGWrapper(self.pg)
        try:
            n = self._journal.append_epoch(app_state, pg_wrapper=pg)
        except journal.JournalLimitError as e:
            logger.info("journal bound reached (%s); taking a full snapshot at step %d instead",
                        e, step)
            return self.save(step, app_state, force=True)
        finally:
            pg.retire()
        logger.debug("journal epoch %d committed (%d record(s)) at step %d",
                     self._journal.epoch, n, step)
        from . import distrib

        if distrib.update_push_enabled():
            try:
                self.push_update()
            except Exception:  # noqa: BLE001 - the epoch commit decided durability
                logger.warning("rolling-update push failed", exc_info=True)
        return True

    def push_update(self) -> Dict[str, Any]:
        with self._activated():
            return self._push_update_impl()

    def _push_update_impl(self) -> Dict[str, Any]:
        """Ship the committed journal epochs to the live replicas registered
        as holding the current base step (``distrib.UpdateReceiver``): a
        rolling update that moves the committed dirty set, not the
        snapshot. Incremental across calls (a per-replica epoch cursor);
        receivers apply each ``(gen, epoch)`` once, so retries are safe.
        Best effort: a replica that misses a push converges at its next
        restore's replay. Returns ``{"replicas", "epochs", "bytes",
        "nacks"}``, all zero when the journal is unarmed or no registry
        store is reachable."""
        from . import distrib

        empty = {"replicas": 0, "epochs": 0, "bytes": 0, "nacks": 0}
        j = self._journal
        if j is None or not j.armed:
            return empty
        pg = PGWrapper(self.pg)
        try:
            store = distrib._registry_store(pg)
        finally:
            pg.retire()
        if store is None:
            return empty
        try:
            return distrib.push_committed_epochs(j.dir, j.base_step, store,
                                                 cursor=self._push_cursor)
        finally:
            try:
                store.close()
            except Exception:  # noqa: BLE001
                pass

    def _journal_emergency_flush(self, app_state: AppState) -> bool:
        """On a preemption, flush the open journal as one final epoch
        instead of a full save. False (the caller then takes the full
        emergency save) when the journal is not armed or the flush fails."""
        if not self._journal_ready():
            return False
        pg = PGWrapper(self.pg)
        try:
            self._journal.append_epoch(app_state, pg_wrapper=pg)
            return True
        except Exception as e:  # noqa: BLE001 - the full save follows
            logger.warning("preemption journal flush failed (%s); falling back to a full "
                           "emergency save", e)
            return False
        finally:
            pg.retire()

    # ------------------------------------------------------- retention

    def _keep_names(self, names: List[str]) -> set:
        """The keep policy, evaluated on plan_retention's own scan."""
        steps = sorted(int(m.group(1)) for m in map(_STEP_RE.match, names) if m)
        keep = set(steps[-self.keep_last:]) if self.keep_last else set(steps)
        if self.keep_every is not None:
            keep.update(s for s in steps if s % self.keep_every == 0)
        kept = {_step_name(s) for s in keep}
        # Snapshots the manager did not name are not its to delete.
        kept.update(n for n in names if not _STEP_RE.match(n))
        return kept

    def _apply_retention(self) -> None:
        # keep_every without keep_last keeps every step.
        if self.keep_last is None:
            return
        if PGWrapper(self.pg).get_rank() != 0:
            return  # the commit barriered every rank; rank 0 deletes
        dirpath = self._local_dir()
        if dirpath is None:
            if not self._retention_skip_warned:
                self._retention_skip_warned = True
                logger.warning(
                    "retention skipped: root %s is not a local filesystem; "
                    "keep_last/keep_every cannot reclaim there",
                    self.root,
                )
            telemetry.counter_add("retention_skipped", 1)
            return
        plan = plan_retention(dirpath, self._keep_names)
        if plan.unresolved:
            logger.warning(
                "retention: kept snapshot(s) under %s reference base(s) outside this "
                "directory (%s); nothing unsafe is deleted",
                dirpath,
                ", ".join(sorted(plan.unresolved)),
            )
        if plan.doomed and self._tenant is not None:
            shared = self._shared_dir()
            if shared is not None:
                from .tenancy import pool

                pool.release_steps(shared, self._tenant.id, plan.doomed)
        n = apply_retention(dirpath, plan)
        if n:
            logger.info(
                "retention: deleted %d snapshot(s) under %s (kept %d + %d required base(s))",
                n,
                dirpath,
                len(plan.keep),
                len(plan.spared),
            )

    # --------------------------------------------------------- restore

    def restore(self, app_state: AppState, step: Optional[int] = None) -> int:
        with self._activated():
            return self._restore_impl(app_state, step)

    def _restore_impl(self, app_state: AppState, step: Optional[int] = None) -> int:
        """Restore ``app_state`` from ``step`` (default: the latest) and
        return the step. The manager's ``device_digests`` applies: a
        destination that already holds a payload's content skips its read.
        The next incremental save chains to the restored step."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise RuntimeError(
                    f"no committed snapshots under {self.root} (remote roots need an "
                    "explicit step=)"
                )
        # Under lazy page-in the session keeps paging after this returns;
        # it is ``self.last_pagein`` (None when the election did not engage).
        self.last_pagein = Snapshot(
            self.path_for(step), pg=self.pg, storage_options=self._options_for(step)
        ).restore(app_state, device_digests=self.device_digests)
        # Not _committed(): restoring must not run a retention pass.
        self._last_committed = step
        # Re-arm the journal on the restored state (base plus replay): new
        # epochs chain after the committed ones.
        if journal.enabled_by_env():
            # The baseline reads every leaf: a lazy restore must be resident
            # first, or it would capture proxies instead of values.
            if self.last_pagein is not None:
                self.last_pagein.wait()
            local = local_fs_root(self.path_for(step))
            if local is not None:
                j = journal.DeltaJournal(local, base_step=step,
                                         rank=PGWrapper(self.pg).get_rank())
                j.epoch = len(journal.committed_epochs(journal.read_epoch_metas(j.dir)))
                j.capture_baseline(app_state)
                self._journal = j
        return step
