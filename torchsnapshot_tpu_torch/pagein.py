"""Lazy page-in restore: serve before the last byte has landed
(counterpart of the JAX package's ``pagein.py``; its ``op=pagein``
history records are byte-compatible).

``Snapshot.restore`` normally returns when every leaf is resident, so a
cold replica's time-to-first-inference (TTFI) equals the full restore
wall even when the model's *hot set* (embedding rows actually hit,
first-layer weights, KV warmup state) is a small fraction of total
bytes. This module composes machinery that already exists — per-entry
streaming-read consumers, the layout compiler's device-free box geometry
(``layout.LayoutSpec.boxes_for``: boxes are exactly the demand-paging
unit), and the fleet seeding tier (``distrib.SeedingStoragePlugin``) —
into a demand-paged restore:

- ``restore()`` returns once the metadata and a declared **hot set** are
  resident. Every deferred leaf comes back as a :class:`LeafFuture`
  proxy in the loaded state; the destination arrays it will fill stay
  untouched until their page lands.
- The remaining leaves materialize two ways: a **background prefetch**
  walks them in box-geometry order (learned first-touch order first when
  a previous run recorded one), and **demand faults**
  (``LeafFuture.result()`` / ``PageInSession.fault``) jump the prefetch
  queue. Faults serviced by the page-in engine read through the same
  (possibly seed-wrapped) storage the restore used — peers first, then
  storage — while faults racing a busy prefetch batch read directly on
  the calling thread so they never wait out a batch.
- A failed background read degrades to a blocking **direct** read on
  first access (``distrib.unwrap_seed`` bypasses the seeding tier for
  the retry), so a fault mid-page-in can delay a leaf but never tear it:
  the CRC/content-address verification on every read path still decides
  what reaches the destination. ``abort()`` leaves the partial state
  unreferencable — every unresolved future raises
  :class:`PageInAborted`.

Mode is ``TORCHSNAPSHOT_GPU_LAZY_RESTORE`` = ``never`` (default; the
restore hot path pays one env check) / ``always`` / ``auto`` (engage
only when a hot set is declared or a learned first-touch order exists).
Hot sets are declared via ``Snapshot.restore(..., hot=[...])`` or
``TORCHSNAPSHOT_GPU_HOT_SET`` (``;``-separated), reusing the
``layout.Rule`` regex grammar (``re.search``; anchor with ``^...$`` for
exact matches). ``TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH=0`` disables the
speculative background walk (demand-only paging).

Torch specifics. A deferred CUDA leaf lands by an HtoD copy on the
restore's side stream; ``LeafFuture.result()``, ``fault()`` and
``wait()`` make the caller's current stream wait on the page's event
before they return, so "resident" means resident in the caller's stream
order. The side stream of each claimed device is made on the restoring
thread (ordered after the caller's stream, as an eager restore's is),
and the engine thread runs under an explicit device guard. Only leaves
of a :class:`~torchsnapshot_tpu_torch.state_dict.StateDict` defer: a
``LeafFuture`` takes the leaf's place there, as in JAX; a Stateful that
cannot hold a proxy (an ``nn.Module``'s ``load_state_dict`` copies every
value at once) restores its leaves eagerly, so a deferred parameter is
never read stale.

Engagement is collective: each rank's vote (mode + hot-set signature)
rides the restore prologue's ONE existing election all-gather
(snapshot.py), so env skew — one rank lazy, one not, or divergent hot
sets — degrades to the eager restore everywhere, never a half-lazy
fleet. Lazy mode also stands down when committed delta-journal epochs
exist: journal replay folds newer values onto restored leaves, and a
page landing after replay would silently roll a leaf back.

TTFI and the first-touch order ride the history journal
(``.telemetry_history.jsonl``, op ``pagein``), so ``stats --trend`` can
gate TTFI regressions and the next restore replays the learned order as
its prefetch order.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import faultinject, telemetry
from .io_types import ReadReq
from .layout import LayoutSpec, Rule, box_linear_start

logger = logging.getLogger(__name__)

LAZY_RESTORE_ENV_VAR = "TORCHSNAPSHOT_GPU_LAZY_RESTORE"
HOT_SET_ENV_VAR = "TORCHSNAPSHOT_GPU_HOT_SET"
PREFETCH_ENV_VAR = "TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH"

#: History-journal op name for page-in records (TTFI + first-touch).
PAGEIN_HISTORY_OP = "pagein"

# Units per speculative background batch: small enough that a demand
# fault waits out at most a couple of leaf reads before the engine
# services it, large enough to keep read coalescing worthwhile.
_PREFETCH_BATCH_UNITS = 2


def lazy_restore_mode() -> str:
    """THE parser for ``TORCHSNAPSHOT_GPU_LAZY_RESTORE``: ``never``
    (default — lazy off, one env check), ``always``, ``auto`` (engage
    only when a hot set or learned order exists). Unknown values mean
    ``never`` — an operator typo must not change restore semantics."""
    raw = os.environ.get(LAZY_RESTORE_ENV_VAR, "never").strip().lower()
    if raw in ("never", "always", "auto"):
        return raw
    return "never"


def prefetch_enabled() -> bool:
    """``TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH``: default on; ``0``/``off``/
    ``false`` means demand-only paging (faults still work)."""
    raw = os.environ.get(PREFETCH_ENV_VAR, "1").strip().lower()
    return raw not in ("0", "off", "false", "no")


def compile_hot_set(
    hot: Optional[Sequence[Any]] = None, include_env: bool = True
) -> Tuple[Rule, ...]:
    """Normalize a ``hot=`` declaration into ``layout.Rule`` tuples.

    Accepts plain regex strings or ``Rule`` objects (only the pattern is
    consulted; a layout rule can be reused verbatim). Env patterns
    (``TORCHSNAPSHOT_GPU_HOT_SET``, ``;``-separated — regexes may
    contain commas) append after the explicit list. Duplicates keep
    first position."""
    rules: List[Rule] = []
    seen = set()
    items: List[Any] = list(hot or [])
    if include_env:
        raw = os.environ.get(HOT_SET_ENV_VAR, "")
        items.extend(p for p in (s.strip() for s in raw.split(";")) if p)
    for item in items:
        rule = item if isinstance(item, Rule) else Rule.of(str(item), ())
        if rule.pattern in seen:
            continue
        seen.add(rule.pattern)
        re.compile(rule.pattern)  # invalid patterns fail loudly, up front
        rules.append(rule)
    return tuple(rules)


class HotSet:
    """The declared hot set: first matching rule wins (``re.search``,
    the ``layout.Rule`` convention). An empty rule list matches nothing
    — ``always`` mode with no rules is metadata-only TTFI."""

    def __init__(self, rules: Sequence[Rule] = ()) -> None:
        self.rules: Tuple[Rule, ...] = tuple(rules)
        self._compiled = [re.compile(r.pattern) for r in self.rules]

    def matches(self, path: str) -> bool:
        return any(rx.search(path) for rx in self._compiled)

    def signature(self) -> str:
        """Stable digest of the rule set, for the engagement vote: ranks
        engage only on identical hot sets (divergent sets would defer
        different leaves and skew the cooperative plan gather)."""
        blob = "|".join(r.pattern for r in self.rules)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def vote_token(engage: bool, hot: HotSet) -> str:
    """This rank's element of the restore election all-gather: empty
    string when not engaging, else ``lazy:<hot-set digest>``. Engagement
    requires every rank to gather the same non-empty token."""
    return f"lazy:{hot.signature()}" if engage else ""


def _history_root(path: str) -> Optional[str]:
    from .storage_plugin import local_fs_root

    local = local_fs_root(path)
    if local is None:
        return None
    return os.path.dirname(os.path.abspath(local.rstrip("/")))


def learned_order(path: str) -> List[str]:
    """The previous run's recorded first-touch order for this root, or
    ``[]``. Read from the newest ``op=pagein`` history record — the
    access pattern of a serving replica is a property of the MODEL, so
    it replays across steps of the same root."""
    root = _history_root(path)
    if root is None:
        return []
    try:
        records = telemetry.history.load_history(root)
    except Exception:  # noqa: BLE001 - history is advisory, never load-bearing
        return []
    for rec in reversed(records):
        if rec.get("op") == PAGEIN_HISTORY_OP and rec.get("first_touch"):
            touched = rec["first_touch"]
            if isinstance(touched, list):
                return [str(p) for p in touched]
    return []


def journal_blocks_lazy(path: str) -> bool:
    """True when committed delta-journal epochs exist for this snapshot:
    replay folds NEWER values onto restored leaves, and a background
    page landing after replay would silently roll the leaf back to the
    base — the exact stale-leaf class lazy mode must never create."""
    from . import journal

    root = _history_root(path)
    if root is None:
        return False
    local = os.path.abspath(path.rstrip("/"))
    jdir = os.path.join(local, journal.JOURNAL_DIRNAME)
    try:
        if not os.path.isdir(jdir):
            return False
        return bool(journal.committed_epochs(journal.read_epoch_metas(jdir)))
    except Exception:  # noqa: BLE001 - unreadable journal: be conservative
        return True


class PageInError(RuntimeError):
    """A deferred leaf could not be materialized (background read and
    the blocking direct retry both failed)."""


class PageInAborted(PageInError):
    """The page-in session was aborted while this leaf was in flight;
    the partially-restored state must not be referenced."""


# _Unit states. PENDING -> (ACTIVE | ACTIVE_DIRECT) -> RESIDENT,
# or -> FAILED -> ACTIVE_DIRECT -> RESIDENT | ERROR. ABORT is terminal.
_PENDING = "pending"
_ACTIVE = "active"          # in a background batch (engine thread)
_ACTIVE_DIRECT = "direct"   # being read on a faulting caller's thread
_RESIDENT = "resident"
_FAILED = "failed"          # background read failed; direct retry on touch
_ERROR = "error"            # direct retry failed too — future raises
_ABORTED = "aborted"

_TERMINAL = (_RESIDENT, _ERROR, _ABORTED)


class LeafFuture:
    """Per-leaf handle under lazy restore: appears in the loaded state in
    place of each deferred leaf. ``result()`` demand-faults the leaf
    (jumping the prefetch queue) and returns the restored value —
    bit-exact with what an eager restore would have produced — or raises
    :class:`PageInError`/:class:`PageInAborted`."""

    def __init__(self, session: "PageInSession", path: str, streams: Any = None) -> None:
        self._session = session
        self.path = path
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        #: The restore's side streams this leaf's pages land on, and the
        #: CUDA events recorded on them once the page is resident.
        self._streams = streams
        self._cuda_events: List[Any] = []

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait for the page WITHOUT faulting it (prefetch-order
        arrival). Returns ``done()``."""
        self._event.wait(timeout)
        return self.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.is_set():
            self._session.fault(self.path, timeout=timeout)
        if not self._event.is_set():
            raise TimeoutError(
                f"page-in of {self.path!r} did not complete in {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        self._order_after_page()
        return self._value

    def exception(self) -> Optional[BaseException]:
        return self._exc if self._event.is_set() else None

    def _order_after_page(self) -> None:
        """Make the caller's current stream of each device wait on the
        page's event: the tensor is resident in the caller's stream order."""
        for event, device in self._cuda_events:
            torch.cuda.current_stream(device).wait_event(event)

    def _resolve(self, value: Any) -> None:
        if self._event.is_set():
            return
        streams = getattr(self._streams, "_streams", None) or {}
        events = []
        for device, stream in streams.items():
            event = torch.cuda.Event()
            event.record(stream)
            events.append((event, device))
        self._cuda_events = events
        self._value = value
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def __repr__(self) -> str:
        state = "resident" if self.done() else "pending"
        return f"<LeafFuture {self.path!r} {state}>"


class _Unit:
    """One demand-paging unit: a deferred leaf and its read requests.
    The granularity is the leaf's box set — ``layout.boxes_for`` is what
    carved sharded leaves into per-device boxes at save time, so paging
    a unit in restores exactly one leaf's resident footprint."""

    __slots__ = (
        "key", "path", "reqs", "future", "state", "cost_bytes",
        "order_key", "is_fault", "error",
    )

    def __init__(
        self,
        key: str,
        path: str,
        reqs: List[ReadReq],
        future: LeafFuture,
        cost_bytes: int,
    ) -> None:
        self.key = key
        self.path = path
        self.reqs = reqs
        self.future = future
        self.state = _PENDING
        self.cost_bytes = cost_bytes
        self.order_key: Tuple[Any, ...] = ()
        self.is_fault = False
        self.error: Optional[BaseException] = None


class PageInSession:
    """The live page-in engine behind one lazy restore.

    Built by ``Snapshot._restore_impl`` when the lazy election is
    unanimous. During the restore's key loop it *claims* deferrable
    leaves (``claim_leaf``); after the hot set is resident the restore
    hands over its storage plugin and event loop (``handoff``) and
    returns this session to the caller. A single engine thread then
    drains the deferred units — fault queue first, then prefetch order —
    through the scheduler's preemptible read pipeline.

    Thread-safety: the public API may be called from any thread;
    ``_cond`` guards the unit table. The engine thread owns the restore
    storage/loop; faulting callers that cannot wait for the engine use
    private direct-read handles.
    """

    def __init__(
        self,
        path: str,
        rank: int,
        hot: HotSet,
        memory_budget: int,
        world_size: int = 1,
        layout_spec: Optional[LayoutSpec] = None,
        learned: Optional[List[str]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        prefetch: Optional[bool] = None,
    ) -> None:
        self.path = path
        self.rank = rank
        self.hot = hot
        self.world_size = world_size
        self._memory_budget = memory_budget
        self._layout = layout_spec
        self._learned = {p: i for i, p in enumerate(learned or [])}
        self._storage_options = storage_options
        self._prefetch = (
            prefetch_enabled() if prefetch is None else bool(prefetch)
        )
        self._units: Dict[str, _Unit] = {}
        self._order: List[_Unit] = []
        self._fault_queue: List[_Unit] = []
        self._cond = threading.Condition()
        self._eager_bytes = 0
        self._resident_bytes = 0
        self._first_touch: List[str] = []
        self._t_begin = telemetry.monotonic()
        self.ttfi_s: Optional[float] = None
        self._storage: Any = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._heartbeat: Any = None
        self._tenant: Any = None
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._aborted = False
        self._completed = False
        self._faults_active = 0  # caller-thread direct faults in flight
        #: CUDA devices of the claimed destinations: the engine thread
        #: runs under an explicit device guard for the first.
        self._devices: Dict[Any, None] = {}

    # ------------------------------------------------------------ planning

    def claim_leaf(
        self,
        key: str,
        logical_path: str,
        entry: Any,
        reqs: List[ReadReq],
        streams: Any = None,
        dest: Any = None,
    ) -> Optional[LeafFuture]:
        """Decide whether one planned leaf defers; called from
        ``Snapshot._plan_reads`` (the plan half, before any execution —
        residency is tracked from planning time on). ``streams`` are the
        key's side streams and ``dest`` the destination leaf: a CUDA
        destination's side stream is made here, on the restoring thread,
        so it orders after the caller's stream as an eager restore's does.

        Returns the leaf's future when claimed (the caller installs it
        in the flattened state and drops the reqs from the eager set),
        or None to keep the leaf on the eager path. Ineligible leaves —
        hot-set matches, origin-borrowed payloads (incremental bases
        open per-origin plugins the engine does not hold), and
        reshard-claimed requests (their peer roles are time-coupled to
        the restore's plan collective) — stay eager."""
        if not reqs or self._started:
            return None
        if self.hot.matches(logical_path):
            return None
        if any(rr.origin is not None for rr in reqs):
            return None
        from . import reshard

        if any(reshard.is_reshard_claimed(rr) for rr in reqs):
            return None
        if isinstance(dest, torch.Tensor) and dest.is_cuda:
            streams.get(dest.device)
            self._devices.setdefault(dest.device, None)
        future = LeafFuture(self, logical_path, streams)
        cost = sum(
            rr.buffer_consumer.get_consuming_cost_bytes() for rr in reqs
        )
        unit = _Unit(key, logical_path, reqs, future, cost)
        unit.order_key = self._order_key(logical_path, entry)
        with self._cond:
            self._units[logical_path] = unit
        return future

    def _order_key(self, path: str, entry: Any) -> Tuple[Any, ...]:
        """Prefetch priority for one unit: learned first-touch order
        first (a previous run's measured access pattern), then the
        layout compiler's box geometry — this rank's box start offset in
        row-major order, so pages stream in the order the mesh placement
        will touch them — then size (big leaves first, the budget-
        packing heuristic the scheduler already uses), then path."""
        learned_idx = self._learned.get(path, len(self._learned))
        geom = 0
        spec = self._layout
        shape = list(getattr(entry, "shape", None) or [])
        if spec is not None and shape:
            try:
                rule = spec.match(path)
                if rule is not None:
                    boxes = spec.boxes_for(
                        shape, spec.spec_for(path, len(shape))
                    )
                    n = len(boxes)
                    device = 0
                    if self.world_size > 1 and n % self.world_size == 0:
                        device = (n // self.world_size) * self.rank
                    geom = box_linear_start(boxes[device], shape)
            except Exception:  # noqa: BLE001 - ordering is advisory
                geom = 0
        return (learned_idx, geom, -len(shape or []), path)

    def note_eager_bytes(self, nbytes: int) -> None:
        """Hot-set/eager bytes executed by the restore itself; makes
        ``resident_fraction`` mean 'fraction of the whole restore
        resident', the number the ``watch`` column renders."""
        with self._cond:
            self._eager_bytes += int(nbytes)

    def deliver(self, logical_path: str, value: Any) -> bool:
        """Read-completion callback router: a claimed leaf's restored
        value resolves its future (True); unclaimed leaves return False
        and flow to the eager ``flattened`` dict as before."""
        unit = self._units.get(logical_path)
        if unit is None:
            return False
        unit.future._resolve(value)
        return True

    @property
    def has_deferred(self) -> bool:
        return bool(self._units)

    # ------------------------------------------------------------- handoff

    def handoff(
        self,
        storage: Any,
        event_loop: asyncio.AbstractEventLoop,
        heartbeat: Any = None,
    ) -> None:
        """Adopt the restore's storage plugin and event loop (the
        restore skips closing them) and start the engine. The storage
        handle may be the seeding tier's wrapper — background pages and
        engine-serviced faults then source from peers first, exactly
        like the restore's own reads did."""
        from . import tenancy

        self._storage = storage
        self._loop = event_loop
        self._heartbeat = heartbeat
        self._tenant = tenancy.current_tenant()
        self.ttfi_s = round(telemetry.monotonic() - self._t_begin, 6)
        with self._cond:
            self._order = sorted(
                self._units.values(), key=lambda u: u.order_key
            )
            total = sum(u.cost_bytes for u in self._order)
        telemetry.flightrec.record(
            "pagein.begin",
            path=self.path,
            rank=self.rank,
            units=len(self._order),
            bytes=total,
            hot_rules=len(self.hot.rules),
            prefetch=self._prefetch,
            ttfi_s=self.ttfi_s,
        )
        self._publish_health()
        self._started = True
        self._thread = threading.Thread(
            target=self._run, name="tsnap-pagein", daemon=True
        )
        self._thread.start()

    def finish_empty(self) -> None:
        """Nothing deferred (the hot set covered everything): the
        session completes inline and the restore keeps ownership of its
        storage/loop."""
        self.ttfi_s = round(telemetry.monotonic() - self._t_begin, 6)
        self._started = True
        self._completed = True

    # ------------------------------------------------------------- queries

    def done(self) -> bool:
        with self._cond:
            return self._completed or not any(
                u.state not in _TERMINAL for u in self._units.values()
            )

    def resident_fraction(self) -> float:
        """Resident bytes over total restore bytes (eager + deferred);
        1.0 once every page landed."""
        with self._cond:
            total = self._eager_bytes + sum(
                u.cost_bytes for u in self._units.values()
            )
            if total <= 0:
                return 1.0
            return (self._eager_bytes + self._resident_bytes) / total

    def pending_paths(self) -> List[str]:
        with self._cond:
            return sorted(
                u.path
                for u in self._units.values()
                if u.state not in _TERMINAL
            )

    def leaf(self, logical_path: str) -> LeafFuture:
        unit = self._units.get(logical_path)
        if unit is None:
            raise KeyError(
                f"{logical_path!r} is not a deferred leaf of this restore "
                f"(deferred: {len(self._units)})"
            )
        return unit.future

    def prefetch_order(self) -> List[str]:
        """The engine's planned background order (diagnostics/tests)."""
        with self._cond:
            order = self._order or sorted(
                self._units.values(), key=lambda u: u.order_key
            )
            return [u.path for u in order]

    # -------------------------------------------------------------- faults

    def fault(
        self, path_or_pattern: str, timeout: Optional[float] = None
    ) -> None:
        """Demand-fault leaves matching ``path_or_pattern`` (exact path
        first, else the hot-set regex grammar) and block until they are
        resident. Jumps the prefetch queue; a unit whose background read
        already failed is re-read with a blocking DIRECT storage read —
        degraded, never torn or stale."""
        units = self._match_units(path_or_pattern)
        deadline = None if timeout is None else telemetry.monotonic() + timeout
        for unit in units:
            self._fault_unit(unit, deadline)
        for unit in units:
            if unit.future.done():
                unit.future._order_after_page()

    def _match_units(self, path_or_pattern: str) -> List[_Unit]:
        with self._cond:
            unit = self._units.get(path_or_pattern)
            if unit is not None:
                return [unit]
            rx = re.compile(path_or_pattern)
            return [
                u
                for u in sorted(self._units.values(), key=lambda u: u.path)
                if rx.search(u.path)
            ]

    def _fault_unit(self, unit: _Unit, deadline: Optional[float]) -> None:
        direct = False
        with self._cond:
            if unit.state in _TERMINAL:
                pass
            elif unit.path not in self._first_touch:
                self._first_touch.append(unit.path)
            if unit.state == _PENDING and self._engine_busy():
                # The engine is mid-batch: reading directly on THIS
                # thread both jumps the queue for real and (via the
                # scheduler's preempt hook) shrinks the batch's I/O
                # concurrency to a trickle while we do.
                unit.state = _ACTIVE_DIRECT
                self._faults_active += 1
                direct = True
            elif unit.state in (_PENDING, _FAILED):
                # Engine idle (or the unit needs its degraded retry):
                # queue it at the front; the engine services faults
                # before any prefetch — seed peers first for first
                # touches, direct for failed ones.
                if not unit.is_fault:
                    unit.is_fault = True
                    self._fault_queue.append(unit)
                    self._cond.notify_all()
        telemetry.flightrec.record(
            "pagein.fault",
            path=unit.path,
            rank=self.rank,
            state=unit.state,
            direct=direct,
        )
        if direct:
            try:
                self._read_direct(unit)
            finally:
                with self._cond:
                    self._faults_active -= 1
                    self._cond.notify_all()
            return
        timeout = None
        if deadline is not None:
            timeout = max(0.0, deadline - telemetry.monotonic())
        unit.future.wait(timeout)

    def _engine_busy(self) -> bool:
        # Caller must hold _cond.
        return any(u.state == _ACTIVE for u in self._units.values())

    def _preempt(self) -> bool:
        """Scheduler hook: while a caller-thread demand fault is in
        flight, the background batch trickles at one request so its I/O
        slots go to the fault (and, transitively, the admission share
        the fault's tenant holds)."""
        return self._faults_active > 0

    # ------------------------------------------------------------ the engine

    def _run(self) -> None:
        import contextlib

        from .tenancy import admission as tenancy_admission

        admission = None
        guard = (
            torch.cuda.device(next(iter(self._devices)))
            if self._devices
            else contextlib.nullcontext()
        )
        try:
            guard.__enter__()
            admission = tenancy_admission.maybe_arm(
                "restore", self._storage, None, tenant=self._tenant
            )
            while True:
                batch, is_fault = self._next_batch()
                if batch is None:
                    break
                self._execute_batch(batch, is_fault)
        except BaseException as e:  # noqa: B036 - engine must not die silently
            logger.exception("page-in engine failed; deferred leaves degrade")
            self._fail_all(e)
        finally:
            tenancy_admission.disarm(self._storage, admission)
            self._shutdown_io()
            self._finalize()
            guard.__exit__(None, None, None)

    def _next_batch(self) -> Tuple[Optional[List[_Unit]], bool]:
        with self._cond:
            while True:
                if self._aborted:
                    return None, False
                if self._fault_queue:
                    batch = self._fault_queue
                    self._fault_queue = []
                    for u in batch:
                        if u.state in (_PENDING, _FAILED):
                            u.state = _ACTIVE
                    batch = [u for u in batch if u.state == _ACTIVE]
                    if batch:
                        return batch, True
                    continue
                pending = [u for u in self._order if u.state == _PENDING]
                if self._prefetch and pending and self._faults_active == 0:
                    batch = pending[:_PREFETCH_BATCH_UNITS]
                    for u in batch:
                        u.state = _ACTIVE
                    return batch, False
                live = [
                    u
                    for u in self._units.values()
                    if u.state not in _TERMINAL
                ]
                if not live:
                    return None, False
                # Parked FAILED units (waiting for first access), a
                # disabled prefetch, or an in-flight caller fault: idle
                # until something changes.
                self._cond.wait(timeout=0.5)

    def _execute_batch(self, batch: List[_Unit], is_fault: bool) -> None:
        from .snapshot import Snapshot

        failed_retry = [u for u in batch if u.error is not None]
        first_read = [u for u in batch if u.error is None]
        try:
            # Inside the try: an injected control fault at the batch
            # boundary degrades exactly like a failed batch read (park /
            # direct retry below), never the whole engine.
            if is_fault:
                faultinject.site("pagein.fault")
            else:
                faultinject.site("pagein.prefetch")
            if first_read:
                reqs = [rr for u in first_read for rr in u.reqs]
                pri = {id(rr): 0 if is_fault else 1 for rr in reqs}
                groups = Snapshot._group_read_reqs(
                    reqs, priority=lambda rr: pri[id(rr)]
                )
                for _origin, greqs in groups:
                    self._sync_execute(greqs, self._storage, self._loop)
            for u in first_read:
                self._mark_resident(u, is_fault)
        except BaseException as e:  # noqa: B036
            # Failed background read. Prefetch units park as FAILED —
            # first access degrades each to a blocking direct read.
            # Fault units retry direct NOW: their first access already
            # happened and the accessor is blocked on the future. Never
            # resolve a future from here — a torn/partial destination
            # must stay unreferencable until a retry overwrites it
            # whole.
            logger.warning(
                "page-in batch failed (%s); %d leaf/leaves degrade to "
                "direct reads",
                type(e).__name__,
                len(first_read),
            )
            retry_now: List[_Unit] = []
            with self._cond:
                for u in first_read:
                    if u.future.done():
                        # The value landed before the failure (another
                        # unit in the batch raised): it is whole.
                        self._mark_resident_locked(u, is_fault)
                    elif is_fault:
                        u.error = e
                        retry_now.append(u)
                    else:
                        u.state = _FAILED
                        u.error = e
                        u.is_fault = False
                self._cond.notify_all()
            for u in retry_now:
                self._read_direct(u, on_engine=True)
        # Degraded retries always run one unit at a time, direct.
        for u in failed_retry:
            self._read_direct(u, on_engine=True)

    def _sync_execute(
        self,
        reqs: List[ReadReq],
        storage: Any,
        loop: asyncio.AbstractEventLoop,
    ) -> None:
        from .scheduler import sync_execute_read_reqs

        sync_execute_read_reqs(
            reqs,
            storage,
            self._memory_budget,
            self.rank,
            loop,
            preempt=self._preempt,
        )

    def _read_direct(self, unit: _Unit, on_engine: bool = False) -> None:
        """Blocking direct read of one unit on the calling thread, with
        a private plugin/loop: the seeding tier is bypassed
        (``distrib.unwrap_seed`` semantics — a fresh plugin on the
        snapshot URL) so a degraded or queue-jumping fault depends on
        nothing but storage."""
        from .storage_plugin import url_to_storage_plugin_in_event_loop

        loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin_in_event_loop(
                self.path, loop, self._storage_options
            )
            try:
                self._sync_execute(unit.reqs, storage, loop)
                self._mark_resident(unit, is_fault=True)
            finally:
                storage.sync_close(loop)
        except BaseException as e:  # noqa: B036
            with self._cond:
                unit.state = _ERROR
                unit.error = e
                self._cond.notify_all()
            unit.future._reject(
                PageInError(
                    f"page-in of {unit.path!r} failed: background read "
                    f"and direct retry both raised ({e!r})"
                )
            )
            if not on_engine:
                raise unit.future._exc  # noqa: B904 - chained above
        finally:
            loop.close()

    def _mark_resident(self, unit: _Unit, is_fault: bool) -> None:
        with self._cond:
            self._mark_resident_locked(unit, is_fault)
            self._cond.notify_all()
        self._publish_health()
        if self.done():
            # All pages landed while a caller-thread fault finished the
            # tail: wake the engine so it can finalize.
            with self._cond:
                self._cond.notify_all()

    def _mark_resident_locked(self, unit: _Unit, is_fault: bool) -> None:
        if unit.state in _TERMINAL:
            return
        unit.state = _RESIDENT
        unit.error = None
        self._resident_bytes += unit.cost_bytes
        telemetry.counter_add(
            "pages_faulted" if is_fault else "pages_prefetched", 1
        )
        telemetry.counter_add("pagein_bytes", unit.cost_bytes)
        if not unit.future.done():
            # The preparer's completion callback normally resolved the
            # future via ``deliver``; in-place destinations that skip
            # the callback resolve to the (now fully written) object the
            # requests were prepared against.
            unit.future._resolve(None)

    def _publish_health(self) -> None:
        try:
            telemetry.health.update(
                resident_frac=round(self.resident_fraction(), 4)
            )
        except Exception:  # noqa: BLE001 - health is advisory
            pass

    def _fail_all(self, exc: BaseException) -> None:
        with self._cond:
            for u in self._units.values():
                if u.state not in _TERMINAL:
                    u.state = _ERROR
                    u.error = exc
                    u.future._reject(
                        PageInError(
                            f"page-in engine failed before {u.path!r} "
                            f"landed: {exc!r}"
                        )
                    )
            self._cond.notify_all()

    # ------------------------------------------------------------ lifecycle

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every deferred leaf is resident — equivalent to
        the eager restore's return point. Units whose background read
        failed are re-read directly (first access is now). Raises the
        first leaf error; after ``wait()`` returns the restored state is
        bit-exact with an eager restore."""
        deadline = None if timeout is None else telemetry.monotonic() + timeout
        for path in self.pending_paths():
            unit = self._units[path]
            self._fault_unit(unit, deadline)
        first_err: Optional[BaseException] = None
        for unit in self._units.values():
            t = None
            if deadline is not None:
                t = max(0.0, deadline - telemetry.monotonic())
            if not unit.future.wait(t):
                raise TimeoutError(
                    f"page-in did not complete in {timeout}s "
                    f"({len(self.pending_paths())} leaf/leaves pending)"
                )
            if first_err is None and unit.future._exc is not None:
                first_err = unit.future._exc
        if first_err is not None:
            raise first_err
        for unit in self._units.values():
            unit.future._order_after_page()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def abort(self) -> None:
        """Stop paging; every unresolved future raises
        :class:`PageInAborted`. The partial state is unreferencable
        through the API — destinations of in-flight pages must be
        treated as garbage, exactly like an aborted eager restore's."""
        with self._cond:
            if self._aborted:
                return
            self._aborted = True
            for u in self._units.values():
                if u.state not in _TERMINAL:
                    u.state = _ABORTED
                    u.future._reject(
                        PageInAborted(
                            f"page-in aborted while {u.path!r} was in flight"
                        )
                    )
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        elif self._storage is not None:
            # Abort before the engine started (restore failed between
            # claim and handoff): the restore still owns storage/loop.
            pass

    def _shutdown_io(self) -> None:
        try:
            if self._storage is not None and self._loop is not None:
                self._storage.sync_close(self._loop)
        except Exception:  # noqa: BLE001
            logger.debug("page-in storage close failed", exc_info=True)
        try:
            if self._loop is not None:
                self._loop.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            if self._heartbeat is not None:
                self._heartbeat.stop()
        except Exception:  # noqa: BLE001
            pass

    def _finalize(self) -> None:
        with self._cond:
            aborted = self._aborted
            resident = [
                u for u in self._units.values() if u.state == _RESIDENT
            ]
            errors = [u for u in self._units.values() if u.state == _ERROR]
            self._completed = True
            self._cond.notify_all()
        wall = round(telemetry.monotonic() - self._t_begin, 6)
        if aborted:
            return
        telemetry.flightrec.record(
            "pagein.complete",
            path=self.path,
            rank=self.rank,
            units=len(self._units),
            resident=len(resident),
            errors=len(errors),
            faulted=len(self._first_touch),
            wall_s=wall,
            ttfi_s=self.ttfi_s,
        )
        self._append_history(wall)

    def _append_history(self, wall: float) -> None:
        """TTFI and the first-touch order ride the history journal (rank
        0, local roots): ``stats --trend --trend-metric ttfi_s`` gates
        TTFI regressions, and the next lazy restore replays
        ``first_touch`` as its prefetch order."""
        if self.rank != 0:
            return
        root = _history_root(self.path)
        if root is None:
            return
        try:
            counters = telemetry.counters()
            fleet = {
                "aggregate": {
                    k: counters[k]
                    for k in (
                        "pages_faulted", "pages_prefetched", "pagein_bytes"
                    )
                    if counters.get(k)
                }
            }
            rec = telemetry.history.build_record(
                op=PAGEIN_HISTORY_OP,
                path=self.path,
                wall_s=wall,
                world_size=self.world_size,
                fleet=fleet,
            )
            if self.ttfi_s is not None:
                rec["ttfi_s"] = self.ttfi_s
            if self._first_touch:
                rec["first_touch"] = list(self._first_touch)
            rec["units"] = len(self._units)
            telemetry.history.append_record(root, rec)
        except Exception:  # noqa: BLE001 - history must never fail paging
            logger.debug("page-in history append failed", exc_info=True)
