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

Not ported yet; each raises an error that names it: a ``tenant``, a
``mirror_url`` in ``storage_options``, ``journal_step`` and
``push_update`` (the delta journal and rolling updates), and
geo-replication (its env knob).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from . import device_digest, telemetry
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
from .snapshot import SNAPSHOT_METADATA_FNAME, PendingSnapshot, Snapshot, _check_unported
from .storage_plugin import check_storage_options
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


def _local_fs_root(url_path: str) -> Optional[str]:
    """The local directory behind ``url_path`` (``fs://`` or a bare path),
    else None."""
    if url_path.startswith("fs://"):
        return url_path[len("fs://"):]
    return None if "://" in url_path else url_path


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
        tenant: Any = None,
    ) -> None:
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1 (or None to keep all)")
        if keep_every is not None and keep_every < 1:
            raise ValueError("keep_every must be >= 1 (or None)")
        _check_unported(tenant=tenant)
        PGWrapper(pg)  # a world of several processes needs a store: fail now
        check_storage_options(storage_options)
        resolve_codec(compression)  # fail on a bad spec now, not at the first save
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

    def close(self) -> None:
        """Wait out a pending async save."""
        self.wait()

    # ----------------------------------------------------------- paths

    def _local_dir(self) -> Optional[str]:
        return _local_fs_root(self.root)

    def path_for(self, step: int) -> str:
        sep = "" if self.root.endswith("/") else "/"
        return f"{self.root}{sep}{_step_name(step)}"

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
        path = self.path_for(step)
        base = (
            self.path_for(self._last_committed)
            if self.incremental and self._last_committed is not None
            else None
        )
        kwargs: Dict[str, Any] = dict(
            pg=self.pg,
            replicated=self.replicated,
            storage_options=self.storage_options,
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
        dirpath = self._local_dir()
        if dirpath is None or not os.path.isdir(dirpath):
            return
        for name in sorted(os.listdir(dirpath)):
            m = _STEP_RE.match(name)
            if not m or int(m.group(1)) > step:
                continue
            partial = os.path.join(dirpath, name)
            if not os.path.isdir(partial):
                continue
            if os.path.exists(os.path.join(partial, SNAPSHOT_METADATA_FNAME)):
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
        self._apply_retention()

    # ------------------------------------------------- not ported yet

    def journal_step(self, step: int, app_state: AppState) -> bool:
        raise NotImplementedError(
            "CheckpointManager.journal_step: the delta journal is not ported to "
            "torchsnapshot_tpu_torch yet."
        )

    def push_update(self) -> Dict[str, Any]:
        raise NotImplementedError(
            "CheckpointManager.push_update: rolling updates (the delta journal and "
            "fleet seeding) are not ported to torchsnapshot_tpu_torch yet."
        )

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
        Snapshot(self.path_for(step), pg=self.pg, storage_options=self.storage_options).restore(
            app_state, device_digests=self.device_digests
        )
        # Not _committed(): restoring must not run a retention pass.
        self._last_committed = step
        return step
