"""Process-local telemetry event bus: spans, counters, gauges, rates.

The port's copy of ``torchsnapshot_tpu/telemetry/core.py``: the one
measurement mechanism of the save/restore pipeline. The pipeline reports
into this bus; exporters (export.py) turn the recorded events into a
Chrome/Perfetto trace, a compact per-op summary persisted next to
``.snapshot_metadata``, or a plain dict. The port's I/O governor takes
its rates directly (``scheduler._feed_governor_rates``), which also
records them here; :func:`register_rate_listener` stays for other
listeners.

Design constraints, in priority order:

1. **Near-zero overhead when disabled.** The pipeline calls ``span()`` /
   ``counter_add()`` on per-sub-chunk hot paths; with telemetry off
   (the default) each call is one module-global flag check returning a
   shared no-op singleton — no allocation, no lock, no clock read.
   Enablement: ``TORCHSNAPSHOT_GPU_TELEMETRY=1`` (read once at import;
   :func:`set_enabled` flips it programmatically for tests/benchmarks).
2. **Thread-safety.** One snapshot op spans the caller thread, the
   asyncio event-loop thread, executor worker threads, and (async takes)
   a background commit thread. Event appends take one lock; span
   parenting is thread-local (a span started on an executor thread is a
   root of that thread's lane — exactly how Chrome traces model tids).
3. **Monotonic time only.** :data:`monotonic` is THE blessed clock for
   pipeline timing, so measurements never fork off the bus.
4. **Bounded memory.** Events are capped (``TORCHSNAPSHOT_GPU_TELEMETRY_
   MAX_EVENTS``, default 200k); overflow drops-and-counts rather than
   growing without bound on a pathological op.
"""

from __future__ import annotations

import contextvars
import math
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

TELEMETRY_ENV_VAR = "TORCHSNAPSHOT_GPU_TELEMETRY"
MAX_EVENTS_ENV_VAR = "TORCHSNAPSHOT_GPU_TELEMETRY_MAX_EVENTS"
_DEFAULT_MAX_EVENTS = 200_000

# The blessed monotonic clock for ALL pipeline timing (spans, rates,
# throughput meters). Deadline/timeout bookkeeping (dist_store, the test
# launcher) may keep raw time.monotonic; measurement may not.
monotonic = time.monotonic


def _env_enabled() -> bool:
    raw = os.environ.get(TELEMETRY_ENV_VAR, "").strip().lower()
    return raw in ("1", "on", "true", "yes", "always")


_enabled: bool = _env_enabled()


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic override of the env gate (tests, bench trials)."""
    global _enabled
    _enabled = bool(value)


def refresh_from_env() -> bool:
    """Re-read ``TORCHSNAPSHOT_GPU_TELEMETRY`` and the event cap
    (subprocess workers that mutate os.environ after import call this)."""
    global _max_events
    _max_events = _read_max_events()
    set_enabled(_env_enabled())
    return _enabled


# ------------------------------------------------------------------ events

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_dropped = 0
_next_id = 0
# Per-context (per-thread AND per-asyncio-task: create_task snapshots the
# context) stack of open span ids. An immutable tuple + token reset keeps
# LIFO correct even when concurrent coroutines interleave span enter/exit
# on one event-loop thread — a plain thread-local list would leak there.
_span_stack: "contextvars.ContextVar[Tuple[int, ...]]" = contextvars.ContextVar(
    "tsnap_telemetry_spans", default=()
)


def _read_max_events() -> int:
    raw = os.environ.get(MAX_EVENTS_ENV_VAR, "").strip()
    try:
        return max(1, int(raw)) if raw else _DEFAULT_MAX_EVENTS
    except ValueError:
        return _DEFAULT_MAX_EVENTS


# Resolved ONCE (and on refresh_from_env): the cap is consulted on every
# event append under the global lock — re-parsing the env var there would
# serialize all producer threads behind redundant string work.
_max_events = _read_max_events()


def _append(ev: Dict[str, Any]) -> None:
    global _dropped, _next_id
    with _lock:
        if len(_events) >= _max_events:
            _dropped += 1
            return
        _next_id += 1
        ev["id"] = _next_id
        _events.append(ev)


class _NullSpan:
    """Shared no-op span: what ``span()`` returns when telemetry is off.
    A singleton so the disabled hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set(self, **args: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Span:
    """A timed region. Use as a context manager::

        with telemetry.span("stage", bytes=n):
            ...

    Nesting is thread-local: spans entered on the same thread while this
    one is open become its children (``parent`` in the event record).
    The event is appended at exit with monotonic ``ts``/``dur`` seconds.
    """

    __slots__ = ("name", "cat", "args", "_ts", "_parent", "_tid", "_id", "_tok")

    def __init__(self, name: str, cat: str, args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args: Any) -> None:
        """Attach/overwrite args after entry (e.g. bytes known at exit)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self) -> "Span":
        global _next_id
        stack = _span_stack.get()
        self._parent = stack[-1] if stack else None
        self._tid = threading.get_ident()
        # The span's event id is allocated at ENTRY so children opened
        # while this span is live can record their real parent id (the
        # event itself is appended at exit, carrying this id; the events
        # list is ordered by completion, ids by start).
        with _lock:
            _next_id += 1
            self._id = _next_id
        self._tok = _span_stack.set(stack + (self._id,))
        self._ts = monotonic()
        return self

    def __exit__(self, *exc: object) -> None:
        dur = monotonic() - self._ts
        try:
            _span_stack.reset(self._tok)
        except ValueError:  # pragma: no cover - exit in a foreign context
            pass
        ev = {
            "ph": "span",
            "id": self._id,
            "name": self.name,
            "cat": self.cat,
            "ts": self._ts,
            "dur": dur,
            "tid": self._tid,
            "parent": self._parent,
        }
        if self.args:
            ev["args"] = self.args
        global _dropped
        with _lock:
            if len(_events) >= _max_events:
                _dropped += 1
                return
            _events.append(ev)


def span(name: str, cat: str = "pipeline", **args: Any):
    """A timed nested region, or the shared no-op when disabled."""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, cat, args or None)


def event(name: str, cat: str = "event", **args: Any) -> None:
    """An instant (zero-duration) event."""
    if not _enabled:
        return
    _append(
        {
            "ph": "instant",
            "name": name,
            "cat": cat,
            "ts": monotonic(),
            "tid": threading.get_ident(),
            "args": args or None,
        }
    )


def _sample_locked(name: str, cat: str, value: float) -> None:
    """Append a counter/gauge sample. CALLER HOLDS _lock: the sample must
    land in the same critical section as the value mutation, or two
    concurrent adders can record totals out of order and a monotone
    Perfetto counter track would dip backwards."""
    global _dropped, _next_id
    if len(_events) >= _max_events:
        _dropped += 1
        return
    _next_id += 1
    _events.append(
        {
            "ph": "counter",
            "id": _next_id,
            "name": name,
            "cat": cat,
            "ts": monotonic(),
            "tid": threading.get_ident(),
            "value": value,
        }
    )


def counter_add(name: str, value: float = 1) -> None:
    """Accumulate a monotone counter (bytes written, retry attempts...).

    A trace sample event is recorded in the same critical section so
    Perfetto can render the counter track over time, in order."""
    if not _enabled:
        return
    with _lock:
        total = _counters.get(name, 0) + value
        _counters[name] = total
        _sample_locked(name, "counter", total)


def gauge_set(name: str, value: float) -> None:
    """Set a point-in-time gauge (queue depth, RSS delta, budget free)."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value
        _sample_locked(name, "gauge", value)


# -------------------------------------------------------------- histograms

# Fixed log2 bucket ladder for every latency histogram: upper bounds
# 2^-20 s (~1 µs) .. 2^7 s (128 s), one bucket per power of two, plus the
# implicit +Inf overflow. Fixed (not per-instrument) so fleet merges,
# the OpenMetrics exposition, and cross-take comparisons are always
# bucket-compatible — adaptive buckets cannot be summed across ranks.
_HIST_LOW_EXP = -20
_HIST_HIGH_EXP = 7
HISTOGRAM_BOUNDS: Tuple[float, ...] = tuple(
    2.0 ** k for k in range(_HIST_LOW_EXP, _HIST_HIGH_EXP + 1)
)
_N_BUCKETS = len(HISTOGRAM_BOUNDS) + 1  # + the +Inf overflow bucket


def _bucket_index(seconds: float) -> int:
    """Index of the smallest bound >= ``seconds`` (log2 ladder), or the
    overflow slot. ``math.frexp`` gives seconds = m * 2^e with m in
    [0.5, 1): seconds <= 2^e always, and seconds <= 2^(e-1) exactly when
    m == 0.5 — two float ops, no log() call on the hot path."""
    if seconds <= HISTOGRAM_BOUNDS[0]:
        return 0
    m, e = math.frexp(seconds)
    idx = e - _HIST_LOW_EXP - (1 if m == 0.5 else 0)
    return idx if idx < _N_BUCKETS else _N_BUCKETS - 1


class _Histogram:
    __slots__ = ("counts", "count", "sum")

    def __init__(self) -> None:
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.sum = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "counts": list(self.counts),
            "count": self.count,
            "sum": round(self.sum, 6),
        }


# {name: {key or "": _Histogram}} — ``name`` must be registered in
# taxonomy.HISTOGRAM_NAMES (lint-pinned, like the flight-event registry);
# ``key`` is the free-form label (storage plugin class, collective verb).
_histograms: Dict[str, Dict[str, _Histogram]] = {}


def histogram_observe(name: str, seconds: float, key: Optional[str] = None) -> None:
    """Record one latency observation into the fixed log2-bucket
    histogram ``name`` (labeled by ``key``). One flag check when
    telemetry is disabled; enabled cost is the bucket math plus one
    uncontended lock round — cheap enough for per-sub-chunk call sites,
    and unlike counters it records NO per-observation trace event.

    ``name`` must be a literal registered in
    ``taxonomy.HISTOGRAM_NAMES``."""
    if not _enabled:
        return
    idx = _bucket_index(seconds)
    with _lock:
        by_key = _histograms.get(name)
        if by_key is None:
            by_key = _histograms[name] = {}
        hist = by_key.get(key or "")
        if hist is None:
            hist = by_key[key or ""] = _Histogram()
        hist.counts[idx] += 1
        hist.count += 1
        hist.sum += seconds


def histograms() -> Dict[str, Dict[str, Dict[str, Any]]]:
    """A JSON-able snapshot of every histogram:
    ``{name: {key: {"counts": [...], "count": n, "sum": s}}}`` with
    counts parallel to :data:`HISTOGRAM_BOUNDS` plus a final +Inf slot."""
    with _lock:
        return {
            name: {key: h.as_dict() for key, h in by_key.items()}
            for name, by_key in _histograms.items()
        }


def histogram_quantile(hist: Dict[str, Any], q: float) -> Optional[float]:
    """Approximate quantile from a histogram dict (bucket upper bound at
    rank ceil(q*count)); None when empty. Good to a factor of 2 by
    construction — the resolution the log2 ladder buys."""
    count = hist.get("count") or 0
    if count <= 0:
        return None
    target = max(1, math.ceil(q * count))
    running = 0
    for i, n in enumerate(hist.get("counts") or []):
        running += n
        if running >= target:
            return (
                HISTOGRAM_BOUNDS[i]
                if i < len(HISTOGRAM_BOUNDS)
                else HISTOGRAM_BOUNDS[-1] * 2
            )
    return HISTOGRAM_BOUNDS[-1] * 2


def _histograms_delta(
    since: Dict[str, Dict[str, Dict[str, Any]]]
) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Histograms accumulated since a prior :func:`histograms` snapshot
    (bucket-wise subtraction; empty deltas elided) — what an OpRecorder
    reports so one op's summary never inherits the previous op's tail."""
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for name, by_key in histograms().items():
        for key, hist in by_key.items():
            base = (since.get(name) or {}).get(key)
            if base is not None:
                delta_count = hist["count"] - base["count"]
                if delta_count <= 0:
                    continue
                counts = [
                    n - b for n, b in zip(hist["counts"], base["counts"])
                ]
                hist = {
                    "counts": counts,
                    "count": delta_count,
                    "sum": round(hist["sum"] - base["sum"], 6),
                }
            elif hist["count"] <= 0:
                continue
            out.setdefault(name, {})[key] = hist
    return out


# ------------------------------------------------------------------- rates

# Rate observations (achieved storage/hash bandwidth) flow THROUGH the bus
# to registered listeners — the I/O governor registers itself at
# scheduler import, keeping its EWMA tables (and measured_rates() view)
# fed without the bus importing the scheduler. Listeners run regardless
# of the enabled flag: adaptive tuning must keep working with telemetry
# off; only the recorded event is gated.
_rate_listeners: List[Callable[[str, Optional[str], int, float], None]] = []


def register_rate_listener(
    fn: Callable[[str, Optional[str], int, float], None]
) -> None:
    if fn not in _rate_listeners:
        _rate_listeners.append(fn)


def record_rate(kind: str, key: Optional[str], nbytes: int, seconds: float) -> None:
    """Publish an achieved rate: ``kind`` in {"write","read","hash"},
    ``key`` the storage-plugin class name (None for hash)."""
    for fn in _rate_listeners:
        try:
            fn(kind, key, nbytes, seconds)
        except Exception:  # pragma: no cover - listeners must not break I/O
            pass
    if not _enabled:
        return
    _append(
        {
            "ph": "instant",
            "name": f"rate:{kind}",
            "cat": "rate",
            "ts": monotonic(),
            "tid": threading.get_ident(),
            "args": {
                "kind": kind,
                "key": key,
                "nbytes": nbytes,
                "seconds": seconds,
                "bps": (nbytes / seconds) if seconds > 0 else None,
            },
        }
    )


# ---------------------------------------------------------------- scraping


def events(since_id: int = 0) -> List[Dict[str, Any]]:
    """A snapshot (shallow copies) of recorded events with id > since_id."""
    with _lock:
        return [dict(e) for e in _events if e.get("id", 0) > since_id]


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def gauges() -> Dict[str, float]:
    with _lock:
        return dict(_gauges)


def dropped_events() -> int:
    return _dropped


def reset() -> None:
    """Drop all recorded state (tests; long-lived processes between ops)."""
    global _dropped
    with _lock:
        _events.clear()
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _dropped = 0


# --------------------------------------------------------------- op scopes


# Recorders that have begun but not finished. begin_op trims the event
# buffer down to what the oldest still-live recorder can reference, so a
# long-lived training process saving every N steps never fills the event
# cap and goes dark — the fate of every unbounded-buffer profiler. A
# WeakSet so a recorder abandoned by a failed async take (finish never
# called) stops pinning history once collected.
_live_recorders: "weakref.WeakSet" = weakref.WeakSet()


class OpRecorder:
    """Brackets one logical operation (a take, a restore) so its summary
    covers only events/counter deltas recorded while it was open.

    Created by :func:`begin_op` (always — even disabled, so callers don't
    branch); ``finish()`` returns the per-op summary dict, or None when
    telemetry was disabled for the whole op."""

    def __init__(self, op: str, rank: int) -> None:
        self.op = op
        self.rank = rank
        self._enabled_at_start = _enabled
        self._t0 = monotonic()
        self._final_events: Optional[List[Dict[str, Any]]] = None
        with _lock:
            # Trim events no live op can still export: keeps the buffer
            # bounded by ops, not by process lifetime.
            marks = [r._event_mark for r in _live_recorders]
            cutoff = min(marks, default=_next_id)
            if _events and cutoff > 0:
                _events[:] = [e for e in _events if e["id"] > cutoff]
            self._event_mark = _next_id
            self._counters0 = dict(_counters)
            self._hist0 = {
                name: {key: h.as_dict() for key, h in by_key.items()}
                for name, by_key in _histograms.items()
            }
            self._dropped0 = _dropped
            self._annotations = dict(_pending_annotations)
            _pending_annotations.clear()
        _live_recorders.add(self)

    def finish(
        self, extra: Optional[Dict[str, Any]] = None
    ) -> Optional[Dict[str, Any]]:
        # Capture the op's events BEFORE leaving _live_recorders: the
        # moment this recorder stops being live, a concurrent begin_op
        # (next take starting while the async commit thread exports) may
        # trim them from the buffer. The cached list also serves the
        # trace export that runs after finish().
        evs = self.events()
        self._final_events = evs
        _live_recorders.discard(self)
        if not (self._enabled_at_start or _enabled):
            return None
        wall = monotonic() - self._t0
        spans: Dict[str, Dict[str, float]] = {}
        op_gauges: Dict[str, float] = {}
        elections: List[Dict[str, Any]] = []
        for ev in evs:
            if ev["ph"] == "counter" and ev.get("cat") == "gauge":
                # Only gauges SET during this op: a restore must not
                # inherit the previous take's final queue depths.
                op_gauges[ev["name"]] = ev.get("value", 0)
            if ev["ph"] == "instant" and ev.get("cat") == "governor":
                # IOGovernor elections recorded during this op ride the
                # persisted summary, so `explain` can show what the
                # governor chose and why (the flight recorder carries the
                # always-on copy for abort dumps).
                elections.append(dict(ev.get("args") or {}))
            if ev["ph"] != "span":
                continue
            agg = spans.setdefault(
                ev["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            agg["count"] += 1
            agg["total_s"] += ev["dur"]
            agg["max_s"] = max(agg["max_s"], ev["dur"])
        for agg in spans.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["max_s"] = round(agg["max_s"], 6)
        now = counters()
        deltas = {
            k: v - self._counters0.get(k, 0)
            for k, v in now.items()
            if v != self._counters0.get(k, 0)
        }
        summary: Dict[str, Any] = {
            "op": self.op,
            "rank": self.rank,
            "wall_s": round(wall, 6),
            "spans": spans,
            "counters": deltas,
            "gauges": op_gauges,
            "dropped_events": _dropped - self._dropped0,
        }
        hist = _histograms_delta(self._hist0)
        if hist:
            summary["histograms"] = hist
        if elections:
            summary["governor"] = elections
        if self._annotations:
            summary["annotations"] = self._annotations
        if extra:
            summary.update(extra)
        _set_last_summary(summary)
        return summary

    def abandon(self) -> None:
        """Release this recorder WITHOUT producing a summary (abort
        paths). A recorder abandoned merely by dropping the reference
        stops pinning the event buffer only when the cyclic GC collects
        it — and an abort's exception/traceback cycle can keep the frame
        (and so the recorder) alive arbitrarily long, during which every
        later op's begin_op trims nothing and the buffer runs into the
        cap. Explicit release closes that window; idempotent, and safe
        to call after finish()."""
        _live_recorders.discard(self)

    def events(self) -> List[Dict[str, Any]]:
        """Events recorded since this op began (for per-op trace export).

        Counter samples are rebased to the op's start so an exported
        trace's counter tracks read 0 -> bytes-this-op, not the
        process-cumulative totals of every previous op. After finish()
        the capture is served from the recorder's own cache (the live
        buffer may have been trimmed by the next op by then)."""
        if self._final_events is not None:
            return [dict(e) for e in self._final_events]
        evs = events(since_id=self._event_mark)
        for ev in evs:
            if ev.get("ph") == "counter" and ev.get("cat") == "counter":
                base = self._counters0.get(ev["name"], 0)
                if base:
                    ev["value"] = ev["value"] - base
        return evs


def begin_op(op: str, rank: int = 0) -> OpRecorder:
    return OpRecorder(op, rank)


# Annotations queued for the NEXT op to begin: layers that sit ABOVE the
# operation call (CheckpointManager knows the step/mode before invoking
# Snapshot.take, which creates the recorder) attach context here and the
# recorder folds it into the persisted summary.
_pending_annotations: Dict[str, Any] = {}


def annotate_next_op(**args: Any) -> None:
    """Attach key/values to the summary of the next take/restore to
    begin (e.g. ``step=1000, mode="async"`` from the manager)."""
    with _lock:
        _pending_annotations.update(args)


# Last finished per-op summary / fleet view / critical-path attribution,
# for programmatic scraping (bench.py embeds these; user code can poll
# after a take).
_last_summary: Optional[Dict[str, Any]] = None
_last_fleet: Optional[Dict[str, Any]] = None
_last_attribution: Optional[Dict[str, Any]] = None


def _set_last_summary(summary: Dict[str, Any]) -> None:
    global _last_summary
    _last_summary = summary


def set_last_fleet(view: Optional[Dict[str, Any]]) -> None:
    global _last_fleet
    _last_fleet = view


def set_last_attribution(view: Optional[Dict[str, Any]]) -> None:
    global _last_attribution
    _last_attribution = view


def last_summary() -> Optional[Dict[str, Any]]:
    """The most recent per-op summary finished in this process."""
    return _last_summary


def last_fleet() -> Optional[Dict[str, Any]]:
    """The most recent cross-rank merged view (distributed ops only)."""
    return _last_fleet


def last_attribution() -> Optional[Dict[str, Any]]:
    """The most recent merged critical-path attribution (critpath.py)."""
    return _last_attribution
