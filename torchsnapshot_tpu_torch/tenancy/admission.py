"""Admission control: priority-weighted I/O shares across tenants
(counterpart of the JAX package's ``tenancy/admission.py``; the
``tsnap/adm/`` rows are byte-compatible).

One tenant's multi-TB save must not starve another's restore. The
scheduler already owns the two levers — the I/O-slot cap
(``IOGovernor.io_concurrency``) and per-request dispatch — so admission
plugs in exactly there:

- each tenant-scoped op arms an :class:`AdmissionSession` (one
  ``faultinject`` site away from chaos drills) and registers its
  priority in the admission table: the in-process registry always, and
  ``tsnap/adm/`` rows on the coordination store when one is reachable
  (the store is the cross-process arbiter; the table is deliberately
  NOT tenant-namespaced — arbitration must see every tenant);
- the session's ``share`` is ``my_priority / Σ active priorities``,
  re-read at every enforcement point so shares rebalance the moment a
  competitor arrives or leaves;
- enforcement is two-sided at the scheduler's I/O-slot acquisition:
  the slot cap scales by the share (a half-share tenant runs half the
  concurrent streams), and each dispatched request first clears a
  token bucket filled at ``IOGovernor.measured_rates() × share`` — so
  a tenant with few huge requests is paced just like one with many
  small ones;
- a solo tenant's share is 1.0 and every enforcement point is a no-op:
  admission costs nothing until there is actual contention. With no
  tenant configured at all, ``maybe_arm`` returns None after one env
  check.

``TORCHSNAPSHOT_GPU_ADMISSION=0`` disables arming entirely.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
from typing import Any, Dict, Optional

from .. import faultinject, telemetry
from ..telemetry import monotonic
from . import Tenant, current_tenant

logger = logging.getLogger(__name__)

ADMISSION_ENV_VAR = "TORCHSNAPSHOT_GPU_ADMISSION"
ADMISSION_PREFIX = "tsnap/adm/"

# In-process registry: tenant id -> {session id -> priority}. The
# cross-process copy rides the store; single-process multi-manager
# deployments (tests, the admission drill) arbitrate here.
_ACTIVE: Dict[str, Dict[int, int]] = {}
_LOCK = threading.Lock()

# Token bucket burst window: how much a tenant may momentarily exceed
# its share before pacing kicks in (seconds of its allowed rate).
_BURST_S = 0.5
_MAX_PAUSE_S = 5.0


def _enabled() -> bool:
    return os.environ.get(ADMISSION_ENV_VAR, "").strip() != "0"


class AdmissionSession:
    """One op's registration in the admission table. Arm with
    :func:`maybe_arm`; stop() deregisters (idempotent)."""

    def __init__(self, tenant: Tenant, op: str, store: Any = None) -> None:
        self.tenant = tenant
        self.op = op
        self._store = store
        self._key = (
            f"{ADMISSION_PREFIX}{tenant.id}/{os.getpid()}_{id(self):x}"
        )
        self._stopped = False
        self._tlock = threading.Lock()
        self._tokens = 0.0
        self._last: Optional[float] = None
        self._paused_s = 0.0

    def start(self) -> "AdmissionSession":
        faultinject.site("tenancy.admission")
        with _LOCK:
            _ACTIVE.setdefault(self.tenant.id, {})[id(self)] = (
                self.tenant.priority
            )
        if self._store is not None:
            try:
                self._store.set(
                    self._key,
                    json.dumps(
                        {"priority": self.tenant.priority, "op": self.op}
                    ).encode("utf-8"),
                )
            except Exception:  # noqa: BLE001 - degrade to in-process
                logger.debug("admission row publish failed", exc_info=True)
                self._store = None
        telemetry.flightrec.record(
            "tenant.admit",
            tenant=self.tenant.id,
            op=self.op,
            priority=self.tenant.priority,
            share=round(self.share(), 3),
        )
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        with _LOCK:
            sessions = _ACTIVE.get(self.tenant.id)
            if sessions is not None:
                sessions.pop(id(self), None)
                if not sessions:
                    _ACTIVE.pop(self.tenant.id, None)
        if self._store is not None:
            try:
                self._store.delete(self._key)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------ arbitration

    def _peer_priorities(self) -> Dict[str, int]:
        """Max priority per active tenant, merged across both planes."""
        peers: Dict[str, int] = {}
        with _LOCK:
            for tid, sessions in _ACTIVE.items():
                if sessions:
                    peers[tid] = max(sessions.values())
        if self._store is not None:
            try:
                _, rows = self._store.collect(ADMISSION_PREFIX, 0, timeout=5.0)
                for key, raw in rows.items():
                    tid = key[len(ADMISSION_PREFIX):].split("/", 1)[0]
                    try:
                        prio = int(
                            json.loads(bytes(raw).decode("utf-8"))["priority"]
                        )
                    except (ValueError, KeyError, TypeError):
                        continue
                    peers[tid] = max(peers.get(tid, 0), prio)
            except Exception:  # noqa: BLE001
                pass
        peers.setdefault(self.tenant.id, self.tenant.priority)
        return peers

    def share(self) -> float:
        peers = self._peer_priorities()
        total = sum(peers.values())
        if total <= 0:
            return 1.0
        return peers[self.tenant.id] / total

    def scale_concurrency(self, base: int) -> int:
        """The I/O-slot cap under the current share (never below 1 —
        starving a tenant to zero slots would wedge, not pace)."""
        share = self.share()
        if share >= 1.0:
            return base
        return max(1, int(round(base * share)))

    async def admit(self, nbytes: int, op: str, plugin: str) -> None:
        """Clear ``nbytes`` through the token bucket before the request
        dispatches. No pacing while solo (share 1.0) or before the
        governor has a measured rate for this plugin+op (the first save
        is the measurement)."""
        share = self.share()
        if share >= 1.0:
            return
        from ..scheduler import io_governor

        gov = io_governor()
        bps = gov.read_bps(plugin) if op == "read" else gov.write_bps(plugin)
        if not bps:
            return
        allowed = bps * share
        pause = 0.0
        with self._tlock:
            now = monotonic()
            if self._last is None:
                self._tokens = allowed * _BURST_S
            else:
                self._tokens = min(
                    self._tokens + (now - self._last) * allowed,
                    allowed * _BURST_S,
                )
            self._last = now
            self._tokens -= nbytes
            if self._tokens < 0:
                pause = min(-self._tokens / allowed, _MAX_PAUSE_S)
        if pause > 0:
            self._paused_s += pause
            await asyncio.sleep(pause)

    @property
    def paused_s(self) -> float:
        """Total pacing stall this session injected (telemetry)."""
        return self._paused_s


def maybe_arm(
    op: str,
    storage: Any = None,
    pg_wrapper: Any = None,
    tenant: Optional[Tenant] = None,
) -> Optional[AdmissionSession]:
    """Arm admission for a tenant-scoped op, or None (no tenant — one
    env check — or ``TORCHSNAPSHOT_GPU_ADMISSION=0``). When ``storage``
    is given, the session rides it to the scheduler
    (``storage._tsnap_admission``) so slot scaling and pacing apply to
    exactly this op's I/O."""
    if tenant is None:
        tenant = current_tenant()
    if tenant is None or not _enabled():
        return None
    store = None
    if pg_wrapper is not None:
        pg = getattr(pg_wrapper, "pg", None)
        store = getattr(pg, "store", None)
    session = AdmissionSession(tenant, op, store=store).start()
    if storage is not None:
        try:
            storage._tsnap_admission = session
        except AttributeError:  # __slots__ plugins: scheduler sees None
            pass
    return session


def disarm(storage: Any, session: Optional[AdmissionSession]) -> None:
    """Stop ``session`` and detach it from ``storage`` (both optional)."""
    if session is not None:
        session.stop()
    if storage is not None and getattr(storage, "_tsnap_admission", None):
        try:
            storage._tsnap_admission = None
        except AttributeError:
            pass
