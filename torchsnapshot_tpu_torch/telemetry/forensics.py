"""Stall forensics: an always-on hang watchdog that answers the one
question the health plane cannot — *what is that rank executing right
now?* The port's copy of ``torchsnapshot_tpu/telemetry/forensics.py``:
the knobs, triggers, store keys and stack-file records are the JAX
package's, so either package's readers load the other's dumps. Frames are
matched under this package (``_PKG_FRAGMENT``), and the category table
adds the port's own modules (``device.py``, ``batcher.py``).

The flight recorder (flightrec.py) explains an abort after it happened;
the health plane (health.py) flags a rank whose progress fingerprint
froze. Neither can see INSIDE the wedge: a rank blocked in a collective,
a storage op stuck behind a throttled device, a lock ordering bug — on a
real fleet these stall everything until the 1800 s barrier deadline
turns a hang into an abort, and the post-mortem holds event *names* but
no stacks. This module closes that gap with a per-op watchdog thread
(armed alongside the heartbeat publisher, default on like the flight
recorder; ``TORCHSNAPSHOT_GPU_FORENSICS=0`` disables) that samples
``sys._current_frames()`` on a low cadence, folds the samples into a
collapsed-stack (flame-format) profile, and maps each thread's innermost
package frame onto the pinned critpath taxonomy
(:data:`..telemetry.critpath.CATEGORIES`) — so a dump says "wedged in
``collective_wait`` at ``pg_wrapper.py:wait``", not just a raw
traceback.

Three trigger classes:

1. **Self-triggered.** A collective past a fraction of its bounded
   deadline (``TORCHSNAPSHOT_GPU_FORENSICS_DEADLINE_FRAC``, default
   0.5 — the hook is ``collective_begin``/``collective_end`` from
   ``PGWrapper._recorded``), a storage op exceeding ``k×`` its own
   recent p99 (the watchdog keeps its own duration ring per op kind —
   the telemetry histograms are off by default, so it cannot lean on
   them), or a frozen local progress fingerprint (the health plane's
   staleness rule, applied to this rank's own ``health.current_state``;
   ``TORCHSNAPSHOT_GPU_FORENSICS_STALL_S``, default 30). A trigger
   records a ``forensic.dump`` flight event and appends one stack dump
   to ``<snapshot>/.flight/rank_<r>.stacks.jsonl`` (same spool-dir
   resolution as the flight ring for remote snapshot paths).
2. **Remote-requested.** A watcher (the JAX package's ``watch --dump
   <rank>`` reads the port's keys too) sets
   ``tsnap/forensic/<rank>`` through the replicated store; the watchdog
   polls the key on its CLONED store connection (the primary blocks for
   whole collectives — exactly the thing being diagnosed), dumps, and
   publishes a compact summary under ``tsnap/forensic_out/<rank>`` that
   ``watch`` renders inline on the rank's row.
3. **On-abort.** Every path that dumps the flight ring also dumps
   stacks (the hook lives in ``flightrec.dump``), so a blackbox wreck
   always carries both the event timeline and the final stacks.

``blackbox`` merges the stack dumps into its causal timeline: DESERTION
findings name who never arrived *and* what the waiters were executing,
and a WEDGE finding fires when >= 2 consecutive dumps from one rank
share an identical non-idle leaf frame — the signature of a true hang
rather than slow progress.

Design rules (the flightrec lineage): strictly stdlib, never raises
into the op, one flag check when disabled, and all measurement on the
blessed ``core.monotonic`` clock.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import sys
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from . import flightrec
from .core import monotonic

logger = logging.getLogger(__name__)

FORENSICS_ENV_VAR = "TORCHSNAPSHOT_GPU_FORENSICS"
SAMPLE_ENV_VAR = "TORCHSNAPSHOT_GPU_FORENSICS_SAMPLE_S"
DEADLINE_FRAC_ENV_VAR = "TORCHSNAPSHOT_GPU_FORENSICS_DEADLINE_FRAC"
STALL_ENV_VAR = "TORCHSNAPSHOT_GPU_FORENSICS_STALL_S"

_DEFAULT_SAMPLE_S = 0.5
_DEFAULT_DEADLINE_FRAC = 0.5
_DEFAULT_STALL_S = 30.0

#: Storage-op trigger: in-flight duration must exceed k x the op kind's
#: own recent p99 (with an absolute floor) before the watchdog calls it
#: wedged. Fixed, not an env knob: the p99 baseline already adapts to
#: the deployment's real latency distribution.
P99_MULTIPLIER = 4.0
P99_FLOOR_S = 1.0
#: Before the duration ring holds enough history for a meaningful p99,
#: only a grossly-overdue op (past this many seconds) triggers.
NO_HISTORY_FLOOR_S = 30.0
_MIN_P99_SAMPLES = 16
_DURATION_RING = 256

#: Remote-request store keys. Fixed namespace, like the heartbeat
#: prefix: the watcher needs no handshake.
FORENSIC_REQ_PREFIX = "tsnap/forensic/"
FORENSIC_OUT_PREFIX = "tsnap/forensic_out/"

#: Per-watchdog bound on self-triggered dumps: a rank wedged for an hour
#: must not grow an unbounded stacks file (remote requests and abort
#: dumps are operator-paced and do not count against it).
MAX_SELF_DUMPS = 32
#: Per-thread stack depth kept in a dump record.
MAX_FRAMES = 40
#: Distinct folded stacks kept in the collapsed profile.
MAX_PROFILE_STACKS = 512


def _env_enabled() -> bool:
    # Always-on is the point: anything but an explicit off-value enables.
    raw = os.environ.get(FORENSICS_ENV_VAR, "").strip().lower()
    return raw not in ("0", "off", "false", "no", "never")


def _env_float(var: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(var, "").strip()
    try:
        return max(minimum, float(raw)) if raw else default
    except ValueError:
        return default


def sample_cadence_s() -> float:
    return _env_float(SAMPLE_ENV_VAR, _DEFAULT_SAMPLE_S, minimum=0.05)


def deadline_fraction() -> float:
    return _env_float(DEADLINE_FRAC_ENV_VAR, _DEFAULT_DEADLINE_FRAC,
                      minimum=0.05)


def stall_window_s() -> float:
    return _env_float(STALL_ENV_VAR, _DEFAULT_STALL_S, minimum=0.1)


_enabled: bool = _env_enabled()


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic override of the env gate (tests, bench trials)."""
    global _enabled
    _enabled = bool(value)


def refresh_from_env() -> bool:
    """Re-read the enable flag (subprocess workers that mutate
    os.environ after import call this, flightrec-style)."""
    global _enabled
    _enabled = _env_enabled()
    return _enabled


# ------------------------------------------------------ stack sampling

_PKG_FRAGMENT = os.sep + "torchsnapshot_tpu_torch" + os.sep

#: Package modules that OBSERVE the pipeline rather than being it: a
#: thread whose only package frames are here is idle plumbing, and a
#: wedged thread's innermost attribution frame must never land on them.
#: faultinject.py is listed because an injected delay executes inside
#: the injector while SIMULATING a slow call at the wired site — the
#: site's frame (one above the injector) is the honest attribution.
_OBSERVER_FRAGMENTS = (
    os.path.join("telemetry", ""),
    "faultinject.py",
    "test_utils.py",
)

#: Module -> critpath category, matched on the package-relative path.
#: Targets the PINNED taxonomy (critpath.CATEGORIES) so forensics,
#: `explain`, and the fleet merges all speak the same nine words.
_CATEGORY_TABLE: Tuple[Tuple[str, str], ...] = (
    ("pg_wrapper.py", "collective_wait"),
    ("dist_store.py", "collective_wait"),
    ("native_io.py", "native_io"),
    ("fanout.py", "peer_transfer"),
    ("reshard.py", "peer_transfer"),
    ("serialization.py", "stage_copy"),
    ("memoryview_stream.py", "stage_copy"),
    # The port's device seam: a thread parked in a CUDA event or stream
    # wait (torch frames above) sits innermost in one of these, so a
    # copy to or from the card reads as staging, not idle.
    (os.path.join("io_preparers", ""), "stage_copy"),
    ("device.py", "stage_copy"),
    ("batcher.py", "stage_copy"),
    ("integrity.py", "hash"),
    ("device_digest.py", "hash"),
    ("compression.py", "decode"),
    ("partial_reader.py", "storage_read"),
)

#: Function-name hints that split storage_plugins/* frames into the
#: read vs write lanes of the taxonomy.
_READ_HINTS = ("read", "get", "download", "recv")


def _rel_frame(filename: str) -> Optional[str]:
    """Package-relative path for a package frame, else None."""
    idx = filename.rfind(_PKG_FRAGMENT)
    if idx < 0:
        return None
    return filename[idx + len(_PKG_FRAGMENT):]


def format_frame(filename: str, func: str, lineno: int) -> str:
    rel = _rel_frame(filename)
    return f"{rel or os.path.basename(filename)}:{func}:{lineno}"


def classify_frames(
    frames: List[Tuple[str, str, int]],
) -> Tuple[Optional[str], Optional[str]]:
    """Map one thread's stack (root -> leaf ``(filename, func, lineno)``
    triples) onto the critpath taxonomy.

    Returns ``(category, frame)`` where ``frame`` is the innermost
    NON-OBSERVER package frame formatted ``relpath:func:lineno`` and
    ``category`` is its critpath lane — or ``(None, None)`` for an idle
    thread (no package frame outside the observer modules)."""
    for filename, func, lineno in reversed(frames):
        rel = _rel_frame(filename)
        if rel is None:
            continue
        if any(frag in rel for frag in _OBSERVER_FRAGMENTS):
            continue
        fmt = f"{rel}:{func}:{lineno}"
        if rel.startswith("storage_plugins" + os.sep) or rel == "storage_plugin.py":
            lowered = func.lower()
            if any(h in lowered for h in _READ_HINTS):
                return "storage_read", fmt
            return "storage_write", fmt
        for fragment, category in _CATEGORY_TABLE:
            if rel.startswith(fragment) or rel == fragment:
                return category, fmt
        # A package frame with no mapping: real work the taxonomy does
        # not itemize — attribute like critpath does (uncovered wall).
        return "sched_idle", fmt
    return None, None


def sample_stacks() -> List[Dict[str, Any]]:
    """One sample of every thread's stack: name, daemon flag, frames
    (root -> leaf), the categorized innermost package frame, and the
    idle verdict. The sampler's own thread is included but classifies
    idle (its package frames are all observer modules), so it can never
    be blamed as the wedge."""
    frames_by_ident = sys._current_frames()
    meta = {t.ident: t for t in threading.enumerate()}
    out: List[Dict[str, Any]] = []
    for ident, frame in frames_by_ident.items():
        raw: List[Tuple[str, str, int]] = []
        f = frame
        while f is not None:
            code = f.f_code
            raw.append((code.co_filename, code.co_name, f.f_lineno))
            f = f.f_back
        raw.reverse()
        category, leaf = classify_frames(raw)
        thread = meta.get(ident)
        out.append({
            "name": thread.name if thread is not None else f"ident-{ident}",
            "daemon": bool(thread.daemon) if thread is not None else True,
            "idle": category is None,
            "category": category,
            "leaf": leaf,
            "frames": [format_frame(*t) for t in raw[-MAX_FRAMES:]],
        })
    out.sort(key=lambda t: (t["idle"], t["name"]))
    return out


def fold_into(profile: Dict[str, int], threads: List[Dict[str, Any]]) -> None:
    """Fold one sample into a collapsed-stack (flame-format) profile:
    ``thread;frame;frame;...`` (root -> leaf) -> sample count. Bounded:
    past :data:`MAX_PROFILE_STACKS` distinct stacks the rarest are
    evicted (the wedge, by definition, is the commonest stack)."""
    for t in threads:
        key = ";".join([t["name"], *t["frames"]])
        profile[key] = profile.get(key, 0) + 1
    if len(profile) > MAX_PROFILE_STACKS:
        keep = sorted(profile.items(), key=lambda kv: -kv[1])
        profile.clear()
        profile.update(keep[:MAX_PROFILE_STACKS // 2])


def pick_wedge(
    threads: List[Dict[str, Any]], prefer: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """The thread a dump blames: prefer the trigger's category, then any
    non-idle thread with a real (non-sched_idle) lane, then any non-idle
    thread at all."""
    candidates = [t for t in threads if not t["idle"]]
    if not candidates:
        return None
    if prefer is not None:
        for t in candidates:
            if t["category"] == prefer or (
                prefer == "storage" and str(t["category"]).startswith("storage")
            ):
                return t
    for t in candidates:
        if t["category"] != "sched_idle":
            return t
    return candidates[0]


# --------------------------------------------------- trigger registries
#
# Shared module state, flightrec-style: the pipeline layers notify cheap
# facts (a collective began, a storage op finished in N seconds) and the
# watchdog evaluates them on its own thread. All writers take one short
# lock; the disabled path is a single flag check.

_reg_lock = threading.Lock()
_collectives: Dict[Tuple[Any, Any], Dict[str, Any]] = {}
_storage_inflight: Dict[int, Dict[str, Any]] = {}
_storage_durations: Dict[str, "collections.deque"] = {}
_storage_token = itertools.count(1)


def collective_begin(
    kind: str, ns: Any, cseq: Any, deadline_s: Optional[float]
) -> None:
    """A collective entered on this rank (PGWrapper._recorded). The
    deadline is the EFFECTIVE one — the collective's own bound or the
    store's barrier timeout — so the watchdog's fraction rule always has
    a denominator."""
    if not _enabled:
        return
    with _reg_lock:
        _collectives[(ns, cseq)] = {
            "kind": kind, "t0": monotonic(), "deadline_s": deadline_s,
        }


def collective_end(ns: Any, cseq: Any) -> None:
    if not _enabled:
        return
    with _reg_lock:
        _collectives.pop((ns, cseq), None)


@contextmanager
def storage_op(kind: str, path: Optional[str] = None):
    """Always-on guard around one storage operation (scheduler write /
    read sites): registers the op in flight and, on exit, feeds its
    duration into the per-kind ring the p99 trigger baselines on. One
    dict insert + remove; no I/O."""
    if not _enabled:
        yield
        return
    token = next(_storage_token)
    t0 = monotonic()
    with _reg_lock:
        _storage_inflight[token] = {"kind": kind, "t0": t0, "path": path}
    try:
        yield
    finally:
        dur = monotonic() - t0
        with _reg_lock:
            _storage_inflight.pop(token, None)
            ring = _storage_durations.get(kind)
            if ring is None:
                ring = _storage_durations[kind] = collections.deque(
                    maxlen=_DURATION_RING
                )
            ring.append(dur)


def _p99(kind: str) -> Optional[float]:
    ring = _storage_durations.get(kind)
    if ring is None or len(ring) < _MIN_P99_SAMPLES:
        return None
    ordered = sorted(ring)
    return ordered[int(0.99 * (len(ordered) - 1))]


def collectives_overdue(now: float, fraction: float) -> List[Dict[str, Any]]:
    """Collectives past ``fraction`` of their effective deadline."""
    out = []
    with _reg_lock:
        items = list(_collectives.items())
    for (ns, cseq), rec in items:
        deadline = rec.get("deadline_s")
        if not deadline or deadline <= 0:
            continue
        waited = now - rec["t0"]
        if waited >= fraction * deadline:
            out.append({
                "kind": rec["kind"], "ns": ns, "cseq": cseq,
                "waited_s": round(waited, 3), "deadline_s": deadline,
            })
    return out


def storage_overdue(now: float) -> List[Dict[str, Any]]:
    """In-flight storage ops past ``max(k x own p99, floor)`` — or past
    the no-history floor when the ring is still warming up."""
    out = []
    with _reg_lock:
        items = list(_storage_inflight.values())
    for rec in items:
        p99 = _p99(rec["kind"])
        threshold = (
            max(P99_MULTIPLIER * p99, P99_FLOOR_S)
            if p99 is not None else NO_HISTORY_FLOOR_S
        )
        waited = now - rec["t0"]
        if waited >= threshold:
            out.append({
                "kind": rec["kind"], "path": rec.get("path"),
                "waited_s": round(waited, 3),
                "threshold_s": round(threshold, 3),
            })
    return out


def _reset_registries_for_tests() -> None:
    with _reg_lock:
        _collectives.clear()
        _storage_inflight.clear()
        _storage_durations.clear()


# ---------------------------------------------------------------- dumps

STACKS_SUFFIX = ".stacks.jsonl"

_dump_lock = threading.Lock()
_dump_seq = itertools.count(1)


def stacks_path_for_rank(rank: int) -> str:
    return f"{flightrec.FLIGHT_DIR}/rank_{rank}{STACKS_SUFFIX}"


def build_dump_record(
    rank: int,
    reason: str,
    trigger: str,
    threads: Optional[List[Dict[str, Any]]] = None,
    profile: Optional[Dict[str, int]] = None,
    prefer: Optional[str] = None,
) -> Dict[str, Any]:
    """One stack-dump record: the sampled threads, the collapsed profile
    accumulated so far, and the blamed wedge frame."""
    if threads is None:
        threads = sample_stacks()
    wedge = pick_wedge(threads, prefer=prefer)
    rec: Dict[str, Any] = {
        "seq": next(_dump_seq),
        "t": round(monotonic(), 6),
        "rank": rank,
        "reason": reason,
        "trigger": trigger,
        "threads": threads,
    }
    if profile:
        top = sorted(profile.items(), key=lambda kv: -kv[1])[:40]
        rec["profile"] = dict(top)
    if wedge is not None:
        rec["wedge"] = {
            "thread": wedge["name"],
            "frame": wedge["leaf"],
            "category": wedge["category"],
        }
    return rec


def dump_stacks(
    path: Optional[str],
    rank: int,
    reason: str,
    trigger: str = "abort",
    threads: Optional[List[Dict[str, Any]]] = None,
    profile: Optional[Dict[str, int]] = None,
    prefer: Optional[str] = None,
) -> Optional[str]:
    """Append one stack dump to ``<path>/.flight/rank_<rank>.stacks.jsonl``.

    NEVER raises (abort paths call this mid-unwind); returns the file
    written or None. Appending (unlike the flight ring's overwrite) is
    the point: the WEDGE finding needs CONSECUTIVE dumps to compare."""
    if not _enabled:
        return None
    try:
        base = flightrec._resolve_dump_dir(path)
        if base is None:
            return None
        rec = build_dump_record(
            rank, reason, trigger, threads=threads, profile=profile,
            prefer=prefer,
        )
        out = os.path.join(
            base, flightrec.FLIGHT_DIR, f"rank_{rank}{STACKS_SUFFIX}"
        )
        with _dump_lock:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "a") as f:
                f.write(json.dumps(rec, default=repr) + "\n")
        logger.warning(
            "stall forensics: dumped %d thread stack(s) to %s (%s: %s)",
            len(rec["threads"]), out, trigger, reason,
        )
        return out
    except Exception:  # noqa: BLE001 - a dump must never mask the abort
        logger.exception("forensic stack dump failed (continuing)")
        return None


# ------------------------------------------------------------- watchdog


class Watchdog:
    """Per-op watchdog: samples stacks on a cadence, folds the collapsed
    profile, evaluates the self-triggers, and answers remote dump
    requests on a cloned store connection. Armed by :func:`arm`
    alongside the heartbeat publisher; stopped in the op's finally."""

    def __init__(
        self,
        rank: int,
        op: str,
        path: Optional[str],
        store: Any = None,
        cadence_s: Optional[float] = None,
    ) -> None:
        self.rank = rank
        self.op = op
        self.path = path
        self.cadence_s = cadence_s if cadence_s is not None else sample_cadence_s()
        self._fraction = deadline_fraction()
        self._stall_s = stall_window_s()
        self._store = None
        if store is not None:
            try:
                # A cloned connection, like the heartbeat publisher: the
                # primary blocks under the client lock for whole
                # collectives — the very hang being diagnosed.
                self._store = store.clone()
            except Exception:  # noqa: BLE001 - store is optional
                self._store = None
        self._stop = threading.Event()
        self._profile: Dict[str, int] = {}
        self._fp: Optional[tuple] = None
        self._fp_changed_t = monotonic()
        self._last_dump_t: Optional[float] = None
        self._self_dumps = 0
        self._published = False
        self._thread = threading.Thread(
            target=self._loop, name="tsnap-forensics", daemon=True
        )

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Bounded, like the heartbeat's: a watchdog wedged in a dead
        store's RPC must not block the op's exit."""
        self._stop.set()
        try:
            self._thread.join(timeout=self.cadence_s + 5.0)
        except Exception:  # noqa: BLE001
            pass

    # -- the sampling loop -------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - observability never raises
                logger.debug("forensics tick failed", exc_info=True)
        # Retraction on the watchdog's own thread, strictly after its
        # last publish (the heartbeat's ghost-key rule).
        if self._store is not None:
            if self._published:
                try:
                    self._store.delete(f"{FORENSIC_OUT_PREFIX}{self.rank}")
                except Exception:  # noqa: BLE001
                    pass
            try:
                self._store.close()
            except Exception:  # noqa: BLE001
                pass

    def _tick(self) -> None:
        now = monotonic()
        threads = sample_stacks()
        fold_into(self._profile, threads)
        self._poll_remote(threads)
        trigger = self._evaluate(now)
        if trigger is None:
            return
        name, reason, prefer = trigger
        if self._self_dumps >= MAX_SELF_DUMPS:
            return
        # Cooldown: keep dumping while the condition persists (WEDGE
        # needs consecutive dumps) but never more than ~1/cooldown Hz.
        cooldown = max(2.0 * self.cadence_s, 1.0)
        if self._last_dump_t is not None and now - self._last_dump_t < cooldown:
            return
        self._last_dump_t = now
        self._self_dumps += 1
        flightrec.record(
            "forensic.dump", rank=self.rank, trigger=name, reason=reason
        )
        dumped = dump_stacks(
            self.path, self.rank, reason, trigger=name, threads=threads,
            profile=self._profile, prefer=prefer,
        )
        if dumped is not None:
            self._publish(threads, name, reason, prefer)

    # -- triggers ----------------------------------------------------

    def _evaluate(self, now: float) -> Optional[Tuple[str, str, Optional[str]]]:
        overdue = collectives_overdue(now, self._fraction)
        if overdue:
            c = max(overdue, key=lambda r: r["waited_s"])
            return (
                "collective-deadline",
                f"{c['kind']} #{c['cseq']} [{c['ns']}] waited "
                f"{c['waited_s']:.1f}s of a {c['deadline_s']:.0f}s deadline",
                "collective_wait",
            )
        slow = storage_overdue(now)
        if slow:
            s = max(slow, key=lambda r: r["waited_s"])
            return (
                "storage-p99",
                f"{s['kind']} in flight {s['waited_s']:.1f}s "
                f"(threshold {s['threshold_s']:.1f}s"
                + (f", path {s['path']}" if s.get("path") else "")
                + ")",
                "storage",
            )
        # Frozen progress fingerprint: the health plane's staleness rule
        # applied to this rank's OWN state — no watcher needed.
        from . import health

        state = health.current_state()
        fp = health._progress_fingerprint(state) if state else None
        if fp != self._fp:
            self._fp = fp
            self._fp_changed_t = now
            return None
        if fp is not None and now - self._fp_changed_t >= self._stall_s:
            frozen_for = now - self._fp_changed_t
            return (
                "frozen-progress",
                f"progress fingerprint frozen {frozen_for:.1f}s "
                f"(phase {state.get('phase')!r})",
                None,
            )
        return None

    # -- remote requests ---------------------------------------------

    def _poll_remote(self, threads: List[Dict[str, Any]]) -> None:
        if self._store is None:
            return
        req_key = f"{FORENSIC_REQ_PREFIX}{self.rank}"
        try:
            if not self._store.check(req_key):
                return
            self._store.delete(req_key)
        except Exception:  # noqa: BLE001 - the op outranks its telemetry
            logger.debug("forensic request poll skipped", exc_info=True)
            return
        reason = "remote dump request"
        flightrec.record(
            "forensic.dump", rank=self.rank, trigger="remote", reason=reason
        )
        dump_stacks(
            self.path, self.rank, reason, trigger="remote", threads=threads,
            profile=self._profile,
        )
        self._publish(threads, "remote", reason, None)

    def _publish(
        self,
        threads: List[Dict[str, Any]],
        trigger: str,
        reason: str,
        prefer: Optional[str],
    ) -> None:
        """Publish a compact summary under ``tsnap/forensic_out/<rank>``
        so ``watch`` can render the wedged frame inline."""
        if self._store is None:
            return
        wedge = pick_wedge(threads, prefer=prefer)
        payload = {
            "rank": self.rank,
            "op": self.op,
            "trigger": trigger,
            "reason": reason,
            "threads": len(threads),
        }
        if wedge is not None:
            payload["wedge"] = f"{wedge['category']} @ {wedge['leaf']}"
            payload["thread"] = wedge["name"]
        try:
            self._store.set(
                f"{FORENSIC_OUT_PREFIX}{self.rank}",
                json.dumps(payload, default=repr).encode("utf-8"),
            )
            self._published = True
        except Exception:  # noqa: BLE001
            logger.debug("forensic publish skipped", exc_info=True)


def arm(pg_wrapper: Any, op: str, path: Optional[str]) -> Optional[Watchdog]:
    """Arm the watchdog for one operation (called next to
    ``health.maybe_start``), or None when forensics is disabled. Unlike
    the heartbeat, single-process ops still arm — the self-triggers and
    abort dumps are rank-local; only the remote-request channel needs
    the store."""
    if not _enabled:
        return None
    try:
        rank = pg_wrapper.get_rank()
        store = None
        if pg_wrapper.get_world_size() > 1:
            pg = getattr(pg_wrapper, "pg", None)
            store = getattr(pg, "store", None)
        return Watchdog(rank, op, path, store=store).start()
    except Exception:  # noqa: BLE001 - observability never fails the op
        logger.debug("forensic watchdog failed to arm", exc_info=True)
        return None


# ------------------------------------------------ blackbox integration


def load_stack_dumps(path: str) -> Dict[int, List[Dict[str, Any]]]:
    """Parse ``<path>/.flight/rank_*.stacks.jsonl`` into
    ``{rank: [records]}``, oldest dump first. Torn trailing lines are
    skipped, exactly like the flight-ring loader."""
    flight_dir = os.path.join(path, flightrec.FLIGHT_DIR)
    out: Dict[int, List[Dict[str, Any]]] = {}
    if not os.path.isdir(flight_dir):
        return out
    for fname in sorted(os.listdir(flight_dir)):
        if not (fname.startswith("rank_") and fname.endswith(STACKS_SUFFIX)):
            continue
        try:
            rank = int(fname[len("rank_"):-len(STACKS_SUFFIX)])
        except ValueError:
            continue
        records: List[Dict[str, Any]] = []
        with open(os.path.join(flight_dir, fname)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "threads" in rec:
                    records.append(rec)
        if records:
            out[rank] = records
    return out


def _nonidle_leaves(rec: Dict[str, Any]) -> Dict[str, Tuple[str, str]]:
    """{thread name: (leaf frame, category)} for one dump's non-idle
    threads."""
    out: Dict[str, Tuple[str, str]] = {}
    for t in rec.get("threads") or []:
        if t.get("idle") or not t.get("leaf"):
            continue
        out[str(t.get("name"))] = (str(t["leaf"]), str(t.get("category")))
    return out


def derive_wedge_findings(
    stacks: Dict[int, List[Dict[str, Any]]],
) -> List[Dict[str, Any]]:
    """WEDGE: >= 2 CONSECUTIVE dumps from one rank share an identical
    non-idle leaf frame — slow progress moves its leaf between dumps; a
    true hang does not. One finding per (rank, thread, frame) streak,
    counting the dumps that agreed."""
    findings: List[Dict[str, Any]] = []
    for rank in sorted(stacks):
        records = stacks[rank]
        prev: Dict[str, Tuple[str, str]] = {}
        run: Dict[str, int] = {}
        best: Dict[Tuple[str, str], Tuple[int, str]] = {}
        for rec in records:
            leaves = _nonidle_leaves(rec)
            new_run: Dict[str, int] = {}
            for name, (leaf, category) in leaves.items():
                same = prev.get(name, (None, None))[0] == leaf
                new_run[name] = run.get(name, 1) + 1 if same else 1
                if new_run[name] >= 2:
                    key = (name, leaf)
                    cur = best.get(key)
                    if cur is None or new_run[name] > cur[0]:
                        best[key] = (new_run[name], category)
            prev, run = leaves, new_run
        for (name, leaf), (count, category) in sorted(best.items()):
            findings.append({
                "class": "wedge",
                "rank": rank,
                "thread": name,
                "frame": leaf,
                "category": category,
                "dumps": count,
            })
    return findings


def latest_wedge(stacks: Dict[int, List[Dict[str, Any]]], rank: int) -> Optional[str]:
    """``category @ frame`` from the rank's most recent dump, if any."""
    records = stacks.get(rank) or []
    for rec in reversed(records):
        wedge = rec.get("wedge")
        if isinstance(wedge, dict) and wedge.get("frame"):
            return f"{wedge.get('category')} @ {wedge['frame']}"
        leaves = _nonidle_leaves(rec)
        if leaves:
            name = sorted(leaves)[0]
            leaf, category = leaves[name]
            return f"{category} @ {leaf}"
    return None


def merge_stack_findings(
    merged: Dict[str, Any], stacks: Dict[int, List[Dict[str, Any]]]
) -> Dict[str, Any]:
    """Fold stack dumps into a ``merge_timeline`` result: append WEDGE
    findings and annotate DESERTION findings with what the waiting /
    stuck ranks were executing (``frames``: {rank: "category @ frame"}).
    Mutates and returns ``merged``; a no-op without stack dumps."""
    if not stacks:
        return merged
    merged["stack_ranks"] = sorted(stacks)
    merged["stack_dumps"] = {r: len(v) for r, v in stacks.items()}
    findings = merged.setdefault("findings", [])
    for f in findings:
        if f.get("class") not in ("desertion", "collective-error"):
            continue
        frames: Dict[int, str] = {}
        for rank in itertools.chain(f.get("stuck") or [], f.get("entered") or []):
            if rank in frames:
                continue
            wedge = latest_wedge(stacks, rank)
            if wedge is not None:
                frames[rank] = wedge
        if frames:
            f["frames"] = frames
    findings.extend(derive_wedge_findings(stacks))
    return merged
