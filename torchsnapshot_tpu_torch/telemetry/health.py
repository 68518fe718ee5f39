"""Live fleet health plane: per-rank heartbeats over the coordination
store (the port's copy of ``torchsnapshot_tpu/telemetry/health.py``; the
JAX package's ``watch`` CLI renders them).

The flight recorder (flightrec.py) explains an abort AFTER it happened;
this module is the view BEFORE — a rank stalling toward the barrier
timeout shows up here minutes before ``TORCHSNAPSHOT_GPU_BARRIER_TIMEOUT``
turns it into a fleet abort. Each rank of an in-flight take/restore
publishes a small progress record to the existing replicated KV store
(the same plane every collective already rides — no new ports, and the
leased-leader failover tier makes the heartbeats themselves survive a
store-host death) on a low cadence; :func:`read_fleet` polls the keys
for a watcher: per-rank phase, bytes staged/written, queue depths, ETA,
and — the point — which ranks have stopped moving.

Mechanics:

- **Publisher.** ``maybe_start`` arms a daemon thread per operation
  (world > 1, store present, cadence > 0). The thread owns a CLONED
  store connection: the primary connection blocks for whole collectives
  under the client lock, and a heartbeat that queues behind a 1800 s
  barrier wait would defeat its purpose. Publishing is ``store.set`` on
  ``tsnap/health/<rank>`` — failover-transparent like every client op;
  a failed tick is skipped, never raised (the op outranks its
  telemetry).
- **Progress state.** Pipeline layers push fields into a module-level
  dict (``update(phase=..., written_bytes=...)``) — the scheduler's
  progress reporter and the snapshot phase timer both feed it; the
  publisher snapshots it each tick. Writers never touch the store.
- **Staleness is watcher-side.** Rank clocks are incomparable, so a
  heartbeat carries a monotone ``seq`` and the WATCHER flags a rank
  stalled when its seq stops advancing for ``--stall`` seconds of
  watcher time — no clock agreement needed, and a mid-poll store
  failover (one poll erroring) degrades to a "store unreachable" line,
  never a crash.

Cadence: ``TORCHSNAPSHOT_GPU_HEARTBEAT_S`` (seconds, default 1.0;
``0`` disables publishing). One small set per rank per cadence is noise
against the store's collective traffic.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional

from .core import monotonic

logger = logging.getLogger(__name__)

HEARTBEAT_ENV_VAR = "TORCHSNAPSHOT_GPU_HEARTBEAT_S"
_DEFAULT_CADENCE_S = 1.0

#: Store key namespace. Fixed (not per-op-namespace) so a watcher needs
#: no handshake — it reads whatever the fleet currently publishes.
HEARTBEAT_PREFIX = "tsnap/health/"


def _scoped_prefix() -> str:
    """The heartbeat prefix under the active tenant's namespace
    (``tsnap/t/<tenant>/health/``), else the default one."""
    from ..tenancy import current_tenant, scope_key

    tenant = current_tenant()
    return scope_key(HEARTBEAT_PREFIX, tenant.id) if tenant is not None else HEARTBEAT_PREFIX


def heartbeat_cadence_s() -> float:
    raw = os.environ.get(HEARTBEAT_ENV_VAR, "").strip()
    try:
        return float(raw) if raw else _DEFAULT_CADENCE_S
    except ValueError:
        return _DEFAULT_CADENCE_S


# ------------------------------------------------------- progress state

_state_lock = threading.Lock()
_state: Dict[str, Any] = {}


def update(**fields: Any) -> None:
    """Merge progress fields for the NEXT heartbeat tick (phase, bytes,
    queue depths...). Called by the scheduler reporter and the snapshot
    phase timer; cheap (one small dict update under a lock, no I/O)."""
    with _state_lock:
        _state.update(fields)


def clear() -> None:
    with _state_lock:
        _state.clear()


def current_state() -> Dict[str, Any]:
    with _state_lock:
        return dict(_state)


# ------------------------------------------------------------ publisher


class HeartbeatPublisher:
    """Publishes this rank's progress record on a cadence until stopped.

    Owns a cloned store connection so heartbeats never queue behind the
    primary connection's blocking collective waits."""

    def __init__(self, store: Any, rank: int, op: str, path: str,
                 cadence_s: Optional[float] = None) -> None:
        self.rank = rank
        self.op = op
        self.path = path
        # Tenant-scoped key prefix, resolved now on the calling thread
        # (the publisher thread would not see the caller's activation).
        self.prefix = _scoped_prefix()
        self.cadence_s = (
            cadence_s if cadence_s is not None else heartbeat_cadence_s()
        )
        self._store = store.clone()
        self._stop = threading.Event()
        self._delete_on_stop = True
        self._seq = 0
        self._t0 = monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="tsnap-heartbeat", daemon=True
        )

    def start(self) -> "HeartbeatPublisher":
        self._publish()  # first beat immediately: the watcher sees the
        self._thread.start()  # op the moment it begins, not a tick later
        return self

    def _payload(self) -> bytes:
        self._seq += 1
        rec = {
            "rank": self.rank,
            "op": self.op,
            "path": self.path,
            "seq": self._seq,
            "wall_s": round(monotonic() - self._t0, 3),
        }
        rec.update(current_state())
        # ETA from the monotone byte counters when both sides are known.
        done = rec.get("written_bytes") or rec.get("read_bytes") or 0
        total = rec.get("total_bytes") or 0
        wall = rec["wall_s"]
        if done and total and wall > 0 and total >= done:
            rate = done / wall
            if rate > 0:
                rec["eta_s"] = round((total - done) / rate, 1)
        return json.dumps(rec, default=repr).encode("utf-8")

    def _publish(self) -> None:
        try:
            self._store.set(f"{self.prefix}{self.rank}", self._payload())
        except Exception:  # noqa: BLE001 - heartbeats must never fail the op
            logger.debug("heartbeat publish skipped", exc_info=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence_s):
            self._publish()
        # Retraction + close happen ON THIS THREAD, strictly after the
        # last publish: if stop()'s bounded join gave up on a publish
        # blocked in a slow store.set, a caller-side delete could land
        # BEFORE that set completes server-side — resurrecting the key
        # as a permanent ghost rank that `watch` flags STALLED forever.
        if self._delete_on_stop:
            try:
                self._store.delete(f"{self.prefix}{self.rank}")
            except Exception:  # noqa: BLE001
                pass
        try:
            self._store.close()
        except Exception:  # noqa: BLE001
            pass

    def stop(self, delete: bool = True) -> None:
        """Stop the cadence; ``delete`` retracts the key so a finished
        rank doesn't linger as a false stall on the watch display. The
        retraction runs on the publisher thread (ordered after its final
        publish); the join is bounded, so a thread wedged in a dead
        store's set doesn't block the op's exit — it retracts whenever
        it unblocks."""
        self._delete_on_stop = delete
        self._stop.set()
        try:
            self._thread.join(timeout=self.cadence_s + 5.0)
        except Exception:  # noqa: BLE001
            pass


def maybe_start(pg_wrapper: Any, op: str, path: str) -> Optional[HeartbeatPublisher]:
    """Arm a publisher for this operation, or None when there is nothing
    to publish to (single process / no store) or the cadence is 0.
    Resets the shared progress state so a new op never inherits the
    previous one's bytes."""
    cadence = heartbeat_cadence_s()
    if cadence <= 0:
        return None
    pg = getattr(pg_wrapper, "pg", None)
    store = getattr(pg, "store", None)
    if store is None or pg_wrapper.get_world_size() <= 1:
        return None
    # ``step`` is annotated by the layer ABOVE the op (CheckpointManager,
    # before Snapshot.take starts this publisher) — it survives the
    # per-op reset the way telemetry.annotate_next_op survives begin_op.
    sticky = {k: v for k, v in current_state().items() if k == "step"}
    clear()
    update(phase="begin", **sticky)
    try:
        return HeartbeatPublisher(
            store, pg_wrapper.get_rank(), op, path, cadence_s=cadence
        ).start()
    except Exception:  # noqa: BLE001 - observability never fails the op
        logger.debug("heartbeat publisher failed to start", exc_info=True)
        return None


# -------------------------------------------------------------- watcher


def read_fleet(
    store: Any, prefix: Optional[str] = None
) -> Dict[int, Dict[str, Any]]:
    """One non-blocking snapshot of every published heartbeat.

    Uses the store's ``collect`` with count=0 — an immediate
    prefix scan, no waiting. Raises whatever the store client raises on
    a dead tier (the CLI degrades, this function does not). ``prefix``
    defaults to the active/ambient tenant's scoped keyspace (watching a
    tenant's fleet needs TORCHSNAPSHOT_GPU_TENANT set to match)."""
    if prefix is None:
        prefix = _scoped_prefix()
    _, items = store.collect(prefix, 0, timeout=5.0)
    fleet: Dict[int, Dict[str, Any]] = {}
    for key, raw in items.items():
        try:
            rank = int(key[len(prefix):])
            rec = json.loads(bytes(raw).decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(rec, dict):
            fleet[rank] = rec
    return fleet


#: Heartbeat fields whose change means the rank is actually MOVING.
#: ``seq``/``wall_s`` advance on every beat even when the pipeline is
#: wedged, so staleness keys on the progress fingerprint instead — a
#: rank heartbeating dutifully while its bytes stand still is exactly
#: the straggler the watcher exists to flag.
_PROGRESS_FIELDS = (
    "op", "phase", "staged_bytes", "written_bytes", "read_bytes",
    "seed_bytes", "done_entries", "resident_frac",
)


def _progress_fingerprint(rec: Dict[str, Any]) -> tuple:
    return tuple(rec.get(k) for k in _PROGRESS_FIELDS)


class FleetTracker:
    """Watcher-side staleness bookkeeping across polls: a rank is STALLED
    when its progress fingerprint (phase/bytes/entries — NOT the
    heartbeat seq) has not changed for ``stall_s`` seconds of the
    watcher's own clock. No cross-host clock agreement is needed, and a
    rank whose heartbeats stop entirely goes stale the same way."""

    def __init__(self, stall_s: float = 5.0) -> None:
        self.stall_s = stall_s
        self._last_fp: Dict[int, tuple] = {}
        self._last_change: Dict[int, float] = {}

    def observe(self, fleet: Dict[int, Dict[str, Any]]) -> Dict[int, float]:
        """Update from one poll; returns {rank: seconds_since_progress}."""
        now = monotonic()
        ages: Dict[int, float] = {}
        for rank, rec in fleet.items():
            fp = _progress_fingerprint(rec)
            if self._last_fp.get(rank) != fp or rank not in self._last_change:
                self._last_fp[rank] = fp
                self._last_change[rank] = now
            ages[rank] = now - self._last_change[rank]
        # Ranks that vanished (finished, key deleted) drop out of the view.
        for rank in list(self._last_fp):
            if rank not in fleet:
                self._last_fp.pop(rank, None)
                self._last_change.pop(rank, None)
        return ages

    def stalled(self, ages: Dict[int, float]) -> Dict[int, bool]:
        return {r: age >= self.stall_s for r, age in ages.items()}


def render_fleet(
    fleet: Dict[int, Dict[str, Any]],
    ages: Dict[int, float],
    stall_s: float,
    wedged: Optional[Dict[int, str]] = None,
) -> str:
    """One watch frame: a per-rank table plus skew/straggler summary."""
    from .export import fmt_bytes

    if not fleet:
        return "no in-flight operation (no heartbeat keys published)"
    lines = []
    # The ``seed`` column is the seed-vs-storage byte mix of a fleet
    # restore (distrib.py): ``read`` counts what came from storage,
    # ``seed`` what arrived from seeding peers — a healthy seeded fleet
    # shows one replica with a big ``read`` and the rest mostly ``seed``.
    # The ``resid`` column is a lazy restore's resident fraction
    # (pagein.py): a replica serving before fully restored climbs from
    # its hot-set fraction to 100% as the tail pages in; eager ops show
    # ``-``.
    # The ``profile`` column is the autotuner's active profile key
    # (scheduler.begin_io_op -> autotune.profile_key); a trailing ``*``
    # marks a rank currently running a perturbation trial on that op.
    # The ``repl`` column is the geo-replication lag (georep.py,
    # rank-0-only): the age of the oldest committed-but-unshipped state
    # — the remote tier's live RPO exposure; ranks without a shipper
    # show ``-``. None of these fields is in _PROGRESS_FIELDS — a
    # background tier toggling must never mask (or fake) byte-level
    # progress in the stall fingerprint.
    lines.append(
        f"{'rank':>4}  {'op':<8} {'phase':<14} {'staged':>10} {'written':>10} "
        f"{'read':>10} {'seed':>10} {'total':>10} {'resid':>6} {'io':>3} "
        f"{'eta':>7} {'wall':>8}  {'bound on':<15} {'profile':<28} "
        f"{'repl':>7} status"
    )
    walls = []
    for rank in sorted(fleet):
        rec = fleet[rank]
        age = ages.get(rank, 0.0)
        stalled = age >= stall_s
        status = f"STALLED {age:.0f}s" if stalled else "ok"
        # The forensic wedge frame (watch --dump, telemetry/forensics.py)
        # rides inline on the row: a STALLED rank that also says
        # "wedged storage_write @ fs.py:write:99" needs no second tool.
        if wedged and rank in wedged:
            status += f"  wedged {wedged[rank]}"
        eta = rec.get("eta_s")
        walls.append((rec.get("wall_s") or 0.0, rank))
        # The binding-resource hint (scheduler reporter -> critpath
        # live estimate): a STALLED row that also says "storage_write"
        # tells the on-call WHAT the straggler is stuck on.
        binding = rec.get("binding") or "-"
        resid = rec.get("resident_frac")
        resid_txt = f"{resid * 100:.0f}%" if resid is not None else "-"
        profile = str(rec.get("profile") or "-")
        if rec.get("trial"):
            profile += "*"
        repl_lag = rec.get("georep_lag_s")
        repl_txt = f"{repl_lag:.1f}s" if repl_lag is not None else "-"
        lines.append(
            f"{rank:>4}  {str(rec.get('op', '?')):<8} "
            f"{str(rec.get('phase', '?')):<14} "
            f"{fmt_bytes(rec.get('staged_bytes')):>10} "
            f"{fmt_bytes(rec.get('written_bytes')):>10} "
            f"{fmt_bytes(rec.get('read_bytes')):>10} "
            f"{fmt_bytes(rec.get('seed_bytes')):>10} "
            f"{fmt_bytes(rec.get('total_bytes')):>10} "
            f"{resid_txt:>6} "
            f"{rec.get('inflight_io', 0):>3} "
            f"{(str(eta) + 's') if eta is not None else '?':>7} "
            f"{rec.get('wall_s', 0):>7.1f}s  {str(binding):<15} "
            f"{profile:<28} {repl_txt:>7} {status}"
        )
    if len(walls) > 1:
        wall_max, slowest = max(walls)
        wall_min, _fastest = min(walls)
        lines.append(
            f"skew: {wall_max - wall_min:.1f}s (slowest rank {slowest})"
        )
    stalled_ranks = [r for r in sorted(fleet) if ages.get(r, 0.0) >= stall_s]
    if stalled_ranks:
        lines.append(
            "stalled rank(s): "
            + ", ".join(map(str, stalled_ranks))
            + f" (no heartbeat progress for >= {stall_s:.1f}s)"
        )
    return "\n".join(lines)
