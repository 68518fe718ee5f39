"""Always-on flight recorder: a bounded ring of structured events, dumped
per rank on abort and merged across ranks (the port's copy of
``torchsnapshot_tpu/telemetry/flightrec.py``; the dumps interchange).

The telemetry bus (core.py) answers "why was this take slow?" — but only
when ``TORCHSNAPSHOT_GPU_TELEMETRY=1`` was set before the incident, which
on a real fleet it never was. The flight recorder is the complement:
**on by default**, bounded, and cheap enough to stay on, recording only
the low-frequency events that matter for a post-mortem (phase
transitions, collective enter/exit, store failovers, retries, fence
decisions — the taxonomy in taxonomy.py), never per-sub-chunk samples.
When a rank aborts, its ring is written to
``<snapshot>/.flight/rank_<r>.jsonl``; :func:`load_dumps`,
:func:`merge_timeline` and :func:`render_timeline` merge the rank dumps
into one causal timeline (the JAX package's ``blackbox`` CLI, not ported
yet, reads the same dumps), so "who deserted whom at which barrier" is
one call instead of an N-way log grep.

Design rules (the telemetry/faultinject lineage):

1. **Lock-cheap when enabled, one flag check when disabled.** The ring
   is a ``collections.deque(maxlen=N)`` — append is atomic under the
   GIL, so the hot path takes no lock; the sequence counter is an
   ``itertools.count`` (also GIL-atomic). Disable with
   ``TORCHSNAPSHOT_GPU_FLIGHTREC=0``; size the ring with
   ``TORCHSNAPSHOT_GPU_FLIGHTREC_RING`` (default 4096 events).
2. **Strictly stdlib.** Imported by ``dist_store``/``pg_wrapper`` (the
   coordination plane, which must never import jax).
3. **The blessed clock.** Timestamps come from ``core.monotonic``.
4. **Dumps never raise.** A dump happens while an operation is already
   unwinding; masking the original error with a telemetry IOError would
   be the one unforgivable failure mode.

Cross-rank causality: monotonic clocks are not comparable across hosts,
so events carry coordination identity instead — the PGWrapper
``(ns, cseq)`` collective key (identical on every rank of one
collective), the store leadership ``epoch``, and the commit-fence
``gen``. ``merge_timeline`` aligns rank clocks on a shared collective
anchor and derives findings (desertions, failovers, stale commits) from
the keys, not the clocks.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .core import monotonic
from .taxonomy import FLIGHT_EVENTS

logger = logging.getLogger(__name__)

FLIGHTREC_ENV_VAR = "TORCHSNAPSHOT_GPU_FLIGHTREC"
RING_ENV_VAR = "TORCHSNAPSHOT_GPU_FLIGHTREC_RING"
DUMP_DIR_ENV_VAR = "TORCHSNAPSHOT_GPU_FLIGHTREC_DIR"
_DEFAULT_RING = 4096

#: Dump directory inside a snapshot path (sibling of .telemetry/).
FLIGHT_DIR = ".flight"


def _env_enabled() -> bool:
    # Always-on is the point: anything but an explicit off-value enables.
    raw = os.environ.get(FLIGHTREC_ENV_VAR, "").strip().lower()
    return raw not in ("0", "off", "false", "no", "never")


def _read_ring_size() -> int:
    raw = os.environ.get(RING_ENV_VAR, "").strip()
    try:
        return max(16, int(raw)) if raw else _DEFAULT_RING
    except ValueError:
        return _DEFAULT_RING


_enabled: bool = _env_enabled()
_ring: "collections.deque" = collections.deque(maxlen=_read_ring_size())
_seq = itertools.count(1)
# Dumps are serialized (two layers of one unwinding abort may both ask);
# the RECORD path never touches this lock.
_dump_lock = threading.Lock()


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic override of the env gate (tests, bench trials)."""
    global _enabled
    _enabled = bool(value)


def refresh_from_env() -> bool:
    """Re-read the enable flag and ring size (subprocess workers that
    mutate os.environ after import call this, telemetry-style)."""
    global _enabled, _ring
    _enabled = _env_enabled()
    size = _read_ring_size()
    if size != _ring.maxlen:
        _ring = collections.deque(_ring, maxlen=size)
    return _enabled


def ring_size() -> int:
    return _ring.maxlen or _DEFAULT_RING


def record(event: str, **args: Any) -> None:
    """Record one event. ``event`` must be a registered literal from
    taxonomy.FLIGHT_EVENTS (tests/test_torch_flightrec.py checks it);
    ``args`` may use any keys EXCEPT the record envelope's own
    (``seq``/``t``/``ev``/``rank``/``rel_t``).

    Hot path: one module-global flag check when disabled; one atomic
    deque append when enabled — no lock, no I/O, no string formatting."""
    if not _enabled:
        return
    _ring.append((next(_seq), monotonic(), event, args or None))


def snapshot_ring() -> List[Tuple[int, float, str, Optional[Dict[str, Any]]]]:
    """A stable copy of the current ring contents (oldest first)."""
    return list(_ring)


def recorded_total() -> int:
    """Highest sequence recorded so far (>= len(ring) once the ring has
    wrapped and begun dropping oldest-first)."""
    return _ring[-1][0] if _ring else 0


def reset() -> None:
    """Drop the ring (tests; between unrelated ops in one process)."""
    global _seq
    _ring.clear()
    _seq = itertools.count(1)


# ------------------------------------------------------------------- dumps


def dump_path_for_rank(rank: int) -> str:
    return f"{FLIGHT_DIR}/rank_{rank}.jsonl"


def _resolve_dump_dir(path: Optional[str]) -> Optional[str]:
    """The local directory to dump under: the snapshot path when it is a
    local filesystem target, else the DUMP_DIR env override, else None
    (dump skipped — a remote-only abort still has the rank's log)."""
    if path is not None:
        from ..storage_plugin import local_fs_root

        local = local_fs_root(path)
        if local is not None:
            return local
    env_dir = os.environ.get(DUMP_DIR_ENV_VAR, "").strip()
    return env_dir or None


def dump(path: Optional[str], rank: int, reason: str) -> Optional[str]:
    """Write the ring to ``<path>/.flight/rank_<rank>.jsonl``.

    Called on the abort path (unhandled exception, StaleCommitError,
    barrier timeout, SIGTERM) — NEVER raises, returns the file written
    or None. Local filesystem targets only; for remote snapshot paths
    set ``TORCHSNAPSHOT_GPU_FLIGHTREC_DIR`` to a local spool directory.
    Repeated dumps of one incident overwrite (the last writer holds the
    superset of events)."""
    if not _enabled:
        return None
    try:
        base = _resolve_dump_dir(path)
        if base is None:
            return None
        events = snapshot_ring()
        out = os.path.join(base, FLIGHT_DIR, f"rank_{rank}.jsonl")
        with _dump_lock:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            total = events[-1][0] if events else 0
            header = {
                "seq": 0,
                "t": round(monotonic(), 6),
                "ev": "flight.dump",
                "rank": rank,
                "reason": reason,
                "events": len(events),
                "dropped": max(0, total - len(events)),
                "ring": ring_size(),
            }
            with open(out, "w") as f:
                f.write(json.dumps(header, default=repr) + "\n")
                for seq, ts, name, args in events:
                    rec = {"seq": seq, "t": round(ts, 6), "ev": name}
                    if args:
                        rec.update(args)
                    f.write(json.dumps(rec, default=repr) + "\n")
        logger.warning(
            "flight recorder: dumped %d event(s) to %s (%s)",
            len(events),
            out,
            reason,
        )
        # Every path that dumps the flight ring also dumps stacks: the
        # hook lives here, not at each abort site. Imported lazily:
        # forensics imports this module for the spool-dir resolution.
        try:
            from . import forensics

            forensics.dump_stacks(path, rank, reason, trigger="abort")
        except Exception:  # noqa: BLE001 - same rule as the ring dump
            logger.debug("abort stack dump failed (continuing)", exc_info=True)
        return out
    except Exception:  # noqa: BLE001 - a dump must never mask the abort
        logger.exception("flight-recorder dump failed (continuing)")
        return None


# --------------------------------------------------- cross-rank timeline


def load_dumps(path: str) -> Dict[int, List[Dict[str, Any]]]:
    """Parse ``<path>/.flight/rank_*.jsonl`` into ``{rank: [records]}``.

    Torn trailing lines (a writer died mid-dump) are skipped, not fatal
    — the blackbox must work on exactly the wrecks it exists for."""
    flight_dir = os.path.join(path, FLIGHT_DIR)
    out: Dict[int, List[Dict[str, Any]]] = {}
    if not os.path.isdir(flight_dir):
        return out
    for fname in sorted(os.listdir(flight_dir)):
        if not (fname.startswith("rank_") and fname.endswith(".jsonl")):
            continue
        try:
            rank = int(fname[len("rank_"):-len(".jsonl")])
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
                    continue  # torn line: the dumping writer died here
                if isinstance(rec, dict) and "ev" in rec:
                    records.append(rec)
        out[rank] = records
    return out


def _collective_key(rec: Dict[str, Any]) -> Optional[Tuple[str, int, str]]:
    if rec.get("ev") not in ("collective.enter", "collective.exit"):
        return None
    ns, cseq = rec.get("ns"), rec.get("cseq")
    if ns is None or cseq is None:
        return None
    return (str(ns), int(cseq), str(rec.get("kind", "?")))


def merge_timeline(dumps: Dict[int, List[Dict[str, Any]]]) -> Dict[str, Any]:
    """Merge per-rank dumps into one causal view.

    Clock alignment: per-rank monotonic clocks are incomparable, so each
    rank's timeline is rebased on the earliest collective ``(ns, cseq)``
    key that EVERY dumped rank entered (all ranks of one collective enter
    it within the coordination round trip — microseconds to milliseconds
    of true skew, good enough to read a timeline). With no shared anchor
    (single rank, or totally divergent rings) ranks render on their own
    zero-based axes, flagged ``aligned: False``.

    Findings are derived from the causal keys, never the clocks:

    - ``desertion`` — a collective some ranks entered and either never
      left or left with an error, while other ranks never arrived (or
      also never left): names the collective, who waited, who never came.
    - ``store-failover`` — every adopted leader change, with the epoch.
    - ``stale-commit`` — a fenced commit decision that refused (gen vs
      found).
    - ``abort`` — each rank's recorded op.abort, with the error.
    - ``fault-trip`` — injected faults that fired (drills name their
      own causes).
    """
    ranks = sorted(dumps)
    by_key_enter: Dict[Tuple, Dict[int, Dict[str, Any]]] = {}
    by_key_exit: Dict[Tuple, Dict[int, Dict[str, Any]]] = {}
    for rank in ranks:
        for rec in dumps[rank]:
            key = _collective_key(rec)
            if key is None:
                continue
            table = by_key_enter if rec["ev"] == "collective.enter" else by_key_exit
            table.setdefault(key, {})[rank] = rec

    # -- clock alignment on the earliest fully-shared enter key
    offsets: Dict[int, float] = {r: 0.0 for r in ranks}
    aligned = False
    shared = [
        k for k, entries in by_key_enter.items() if set(entries) == set(ranks)
    ]
    if shared and len(ranks) > 1:
        anchor = min(
            shared, key=lambda k: by_key_enter[k][ranks[0]].get("t", 0.0)
        )
        t0 = by_key_enter[anchor][ranks[0]].get("t", 0.0)
        for r in ranks:
            offsets[r] = by_key_enter[anchor][r].get("t", 0.0) - t0
        aligned = True
    elif ranks:
        # Zero-base each rank on its own first event.
        for r in ranks:
            ts = [rec.get("t", 0.0) for rec in dumps[r] if rec.get("seq", 0) > 0]
            offsets[r] = min(ts) if ts else 0.0
        aligned = len(ranks) == 1

    merged: List[Dict[str, Any]] = []
    for r in ranks:
        for rec in dumps[r]:
            if rec.get("seq", 0) <= 0:  # the dump header
                continue
            out = dict(rec)
            out["rank"] = r
            out["rel_t"] = rec.get("t", 0.0) - offsets[r]
            merged.append(out)
    merged.sort(key=lambda e: (e["rel_t"], e["rank"], e.get("seq", 0)))
    # Rebase the whole timeline to its earliest event: the offsets above
    # only RECONCILE rank clocks (aligned case: onto rank 0's raw
    # monotonic axis, which is seconds-since-boot) — without this the
    # typical aligned timeline would print absolute +90000s stamps.
    if merged:
        base = merged[0]["rel_t"]
        for out in merged:
            out["rel_t"] = round(out["rel_t"] - base, 6)

    findings: List[Dict[str, Any]] = []
    for key in sorted(by_key_enter, key=lambda k: (k[0], k[1])):
        entered = by_key_enter.get(key, {})
        exited = by_key_exit.get(key, {})
        errored = {
            r for r, rec in exited.items() if rec.get("ok") is False
        }
        stuck = set(entered) - set(exited)
        missing = set(ranks) - set(entered)
        if not (errored or stuck) and not missing:
            continue
        if not entered:
            continue
        if missing or errored or stuck:
            ns, cseq, kind = key
            findings.append(
                {
                    "class": "desertion" if (missing or stuck) else "collective-error",
                    "kind": kind,
                    "ns": ns,
                    "cseq": cseq,
                    "entered": sorted(entered),
                    "never_arrived": sorted(missing),
                    "stuck": sorted(stuck),
                    "errored": sorted(errored),
                    "errors": {
                        r: exited[r].get("error") for r in sorted(errored)
                    },
                }
            )
    for rank in ranks:
        for rec in dumps[rank]:
            ev = rec.get("ev")
            if ev == "store.failover":
                findings.append(
                    {
                        "class": "store-failover",
                        "rank": rank,
                        "epoch": rec.get("epoch"),
                        "leader": rec.get("leader"),
                        "cause": rec.get("cause"),
                    }
                )
            elif ev == "commit.decision" and rec.get("ok") is False:
                findings.append(
                    {
                        "class": "stale-commit",
                        "rank": rank,
                        "gen": rec.get("gen"),
                        "found": rec.get("found"),
                    }
                )
            elif ev == "op.abort":
                findings.append(
                    {
                        "class": "abort",
                        "rank": rank,
                        "op": rec.get("op"),
                        "error": rec.get("error"),
                        "gen": rec.get("gen"),
                    }
                )
            elif ev == "fault.trip":
                findings.append(
                    {
                        "class": "fault-trip",
                        "rank": rank,
                        "site": rec.get("site"),
                        "hit": rec.get("hit"),
                        "action": rec.get("action"),
                    }
                )
    # Replication lag collapses to the LATEST sample per (rank, tier):
    # the shipper records georep.lag every failed cycle, and a hundred
    # copies of the same aging backlog is one finding, not a hundred.
    lagging: Dict[Any, Dict[str, Any]] = {}
    for rank in ranks:
        for rec in dumps[rank]:
            if rec.get("ev") != "georep.lag":
                continue
            lagging[(rank, rec.get("tier"))] = {
                "class": "replication-lag",
                "rank": rank,
                "tier": rec.get("tier"),
                "backlog_epochs": rec.get("backlog_epochs"),
                "lag_s": rec.get("lag_s"),
                "error": rec.get("error"),
            }
    findings.extend(lagging[k] for k in sorted(lagging, key=str))
    return {
        "ranks": ranks,
        "aligned": aligned,
        "events": merged,
        "findings": findings,
    }


def render_timeline(merged: Dict[str, Any], verbose: bool = False) -> str:
    """Human-readable blackbox report: findings first (the diagnosis),
    then the merged timeline (the evidence)."""
    lines: List[str] = []
    ranks = merged.get("ranks") or []
    events = merged.get("events") or []
    lines.append(
        f"flight dumps: {len(ranks)} rank(s) ({', '.join(map(str, ranks))}), "
        f"{len(events)} event(s)"
        + ("" if merged.get("aligned") else " [clocks not aligned: no shared anchor]")
    )
    stack_ranks = merged.get("stack_ranks") or []
    if stack_ranks:
        n_dumps = sum((merged.get("stack_dumps") or {}).values())
        lines.append(
            f"stack dumps: {len(stack_ranks)} rank(s) "
            f"({', '.join(map(str, stack_ranks))}), {n_dumps} dump(s)"
        )
    findings = merged.get("findings") or []
    if findings:
        lines.append("")
        lines.append("findings:")
    for f in findings:
        cls = f.get("class")
        if cls in ("desertion", "collective-error"):
            what = []
            if f["never_arrived"]:
                what.append(
                    "rank(s) "
                    + ", ".join(map(str, f["never_arrived"]))
                    + " never arrived"
                )
            if f["stuck"]:
                what.append(
                    "rank(s) " + ", ".join(map(str, f["stuck"])) + " still waiting"
                )
            for r in f.get("errored", []):
                what.append(f"rank {r} raised ({f['errors'].get(r)})")
            line = (
                f"  DESERTION      collective {f['kind']} #{f['cseq']} "
                f"[{f['ns']}]: " + "; ".join(what)
            )
            # Stack-dump annotation (telemetry/forensics.py): WHERE each
            # waiter actually sat when it last dumped — the difference
            # between "rank 1 still waiting" and "rank 1 still waiting,
            # wedged under storage_write @ fs.py:write".
            frames = f.get("frames") or {}
            if frames:
                line += "; executing: " + ", ".join(
                    f"r{r} {frames[r]}" for r in sorted(frames)
                )
            lines.append(line)
        elif cls == "store-failover":
            lines.append(
                f"  STORE-FAILOVER rank {f['rank']} adopted leader "
                f"{f.get('leader')} at epoch {f.get('epoch')} "
                f"(cause: {f.get('cause')})"
            )
        elif cls == "stale-commit":
            lines.append(
                f"  STALE-COMMIT   rank {f['rank']} refused to commit: fence "
                f"held {f.get('found')!r}, expected generation {f.get('gen')!r}"
            )
        elif cls == "abort":
            gen = f" [generation {f['gen']}]" if f.get("gen") else ""
            lines.append(
                f"  ABORT          rank {f['rank']} {f.get('op')}{gen}: "
                f"{f.get('error')}"
            )
        elif cls == "fault-trip":
            lines.append(
                f"  FAULT-TRIP     rank {f['rank']} site {f.get('site')} "
                f"hit #{f.get('hit')} -> {f.get('action')}"
            )
        elif cls == "wedge":
            lines.append(
                f"  WEDGE          rank {f['rank']} wedged in "
                f"{f.get('category')} at {f.get('frame')} "
                f"({f.get('dumps')} consecutive dump(s), "
                f"thread {f.get('thread')})"
            )
        elif cls == "replication-lag":
            lines.append(
                f"  REPLICATION-LAG rank {f['rank']} tier {f.get('tier')} "
                f"is {f.get('backlog_epochs')} epoch(s) behind, oldest "
                f"unshipped state {f.get('lag_s')}s old "
                f"(last error: {f.get('error')})"
            )
    lines.append("")
    lines.append("timeline (relative seconds):")
    shown = events if verbose else events[-200:]
    if len(shown) < len(events):
        lines.append(f"  ... {len(events) - len(shown)} earlier event(s) elided "
                     "(-v shows all)")
    for ev in shown:
        extras = {
            k: v
            for k, v in ev.items()
            if k not in ("rank", "rel_t", "seq", "t", "ev")
        }
        detail = " ".join(f"{k}={v}" for k, v in extras.items())
        lines.append(
            f"  [{ev['rel_t']:+10.3f}s] r{ev['rank']} {ev['ev']}"
            + (f"  {detail}" if detail else "")
        )
    return "\n".join(lines)


# Registered-name self-check (import-time, cheap): a record() call with a
# typo'd name would silently vanish from every runbook grep; the AST lint
# catches package call sites, this catches dynamic callers in tests.
def check_name(name: str) -> bool:
    return name in FLIGHT_EVENTS
