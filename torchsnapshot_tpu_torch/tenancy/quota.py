"""Quota-aware retention: byte budgets enforced BEFORE payload I/O
(counterpart of the JAX package's ``tenancy/quota.py``).

A tenant's ``quota_bytes`` caps its committed bytes. Enforcement runs
at the top of every save, before any payload write:

1. rank 0 measures the tenant's committed usage (committed step
   directories only — partials are the fenced GC's problem);
2. over budget, it first tries byte-budget retention: starting from the
   manager's own keep policy, the OLDEST kept steps are demoted one at
   a time (newest always survives) and the plan re-closed — so
   base-closure rules hold: a base a surviving incremental needs is
   spared no matter its age, exactly like count-based retention;
3. still over budget after the best legal eviction → the save fails
   with :class:`QuotaExceededError` on every rank, before a byte of
   payload I/O — an over-quota save is an ERROR, never a torn partial;
4. a quota on a remote root (s3/gcs — no local scan, retention cannot
   run) fails with :class:`QuotaUnenforceableError` instead of silently
   never reclaiming.

The rank-0 decision is broadcast so the world agrees (a collective save
where one rank proceeds and the rest raise would wedge at the commit
barrier).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence, Set

from .. import faultinject, telemetry
from . import Tenant

logger = logging.getLogger(__name__)


class QuotaExceededError(RuntimeError):
    """The tenant is over ``quota_bytes`` and retention cannot legally
    free enough. Raised before payload I/O starts — nothing is torn."""

    def __init__(self, tenant_id: str, used: int, quota: int) -> None:
        super().__init__(
            f"tenant {tenant_id!r} is over quota: {used} committed bytes "
            f"vs quota_bytes={quota}, and retention cannot free enough "
            "without breaking a surviving snapshot's base closure. Raise "
            "the quota, lower keep_last/keep_every, or delete snapshots "
            "explicitly."
        )
        self.tenant_id = tenant_id
        self.used = used
        self.quota = quota


class QuotaUnenforceableError(RuntimeError):
    """``quota_bytes`` is configured but the root is remote (s3/gcs):
    usage cannot be scanned and retention cannot run, so the quota would
    silently never be enforced. Failing loudly is the contract."""

    def __init__(self, tenant_id: str, root: str) -> None:
        super().__init__(
            f"tenant {tenant_id!r} has quota_bytes configured but root "
            f"{root!r} is not a local filesystem: committed usage cannot "
            "be scanned and retention cannot reclaim there. Run the "
            "manager on a shared local root, or drop the quota and "
            "enforce it out of band."
        )
        self.tenant_id = tenant_id
        self.root = root


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _dirnames, filenames in os.walk(path):
        for name in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                pass
    return total


def committed_bytes(dirpath: str) -> int:
    """The tenant's charged usage: bytes under COMMITTED snapshot
    directories. Partials don't count (the fenced GC reclaims them);
    pooled payloads don't count (they live under the shared pool, paid
    once fleet-wide — deduplication is the discount)."""
    total = 0
    try:
        names = os.listdir(dirpath)
    except OSError:
        return 0
    for name in names:
        step_dir = os.path.join(dirpath, name)
        if os.path.isfile(os.path.join(step_dir, ".snapshot_metadata")):
            total += _dir_bytes(step_dir)
    return total


def plan_quota_retention(
    dirpath: str,
    keep: "Callable[[Sequence[str]], Set[str]]",
    byte_budget: int,
    droppable: Optional[Callable[[str], bool]] = None,
):
    """A retention plan whose survivors (keep + spared closure) fit
    ``byte_budget``, demoting the oldest droppable keeps first.

    The newest kept snapshot always survives (a quota that would evict
    the only restore point is an error the caller surfaces, not a
    silent wipe). Returns the final :class:`~torchsnapshot_tpu_torch.
    retention.RetentionPlan` — possibly still over budget when nothing
    more may legally go."""
    from ..retention import plan_retention

    if droppable is None:
        droppable = lambda name: True  # noqa: E731

    sizes = {}

    def surviving_bytes(plan) -> int:
        total = 0
        for name in list(plan.keep) + [n for n, _ in plan.spared]:
            if name not in sizes:
                sizes[name] = _dir_bytes(os.path.join(dirpath, name))
            total += sizes[name]
        return total

    plan = plan_retention(dirpath, keep)
    kept: Optional[Set[str]] = None
    while surviving_bytes(plan) > byte_budget:
        current = set(plan.keep) if kept is None else kept
        # keep is sorted; zero-padded step names sort oldest-first.
        victims = [n for n in sorted(current) if droppable(n)]
        if len(victims) <= 1 or len(current) <= 1:
            break
        kept = current - {victims[0]}
        frozen = set(kept)
        plan = plan_retention(dirpath, lambda names: frozen & set(names))
    return plan


def ensure_capacity(manager) -> None:
    """The pre-I/O quota gate ``CheckpointManager.save`` runs. Collective:
    rank 0 decides (scan → evict → re-scan), everyone raises together."""
    tenant: Optional[Tenant] = getattr(manager, "_tenant", None)
    if tenant is None or tenant.quota_bytes is None:
        return
    from ..pg_wrapper import PGWrapper

    pg = PGWrapper(manager.pg)
    try:
        err: Optional[BaseException] = None
        if pg.get_rank() == 0:
            try:
                faultinject.site("tenancy.quota_check")
                _rank0_enforce(manager, tenant)
            except (QuotaExceededError, QuotaUnenforceableError) as e:
                err = e
        if pg.get_world_size() > 1:
            err = pg.broadcast_object(err if pg.get_rank() == 0 else None, src=0)
        if err is not None:
            raise err
    finally:
        if pg.get_world_size() > 1:
            pg.retire()


def _rank0_enforce(manager, tenant: Tenant) -> None:
    quota = tenant.quota_bytes
    assert quota is not None
    dirpath = manager._local_dir()
    if dirpath is None:
        raise QuotaUnenforceableError(tenant.id, manager.root)
    if not os.path.isdir(dirpath):
        return
    used = committed_bytes(dirpath)
    if used <= quota:
        return
    from ..retention import apply_retention
    from . import pool

    plan = plan_quota_retention(
        dirpath, manager._keep_names, quota, droppable=manager._step_like
    )
    if plan.doomed:
        shared_root = manager._shared_dir()
        if shared_root is not None:
            pool.release_steps(shared_root, tenant.id, plan.doomed)
        n = apply_retention(dirpath, plan)
        telemetry.counter_add("quota_evictions", n)
        telemetry.flightrec.record(
            "tenant.evict", tenant=tenant.id, evicted=n, used=used, quota=quota
        )
        logger.warning(
            "tenant %s over quota (%d > %d bytes): evicted %d oldest "
            "step(s) under %s",
            tenant.id,
            used,
            quota,
            n,
            dirpath,
        )
        used = committed_bytes(dirpath)
    if used > quota:
        raise QuotaExceededError(tenant.id, used, quota)
