"""Checkpoint history: a crash-safe per-root journal of committed takes,
with p50 regression detection (counterpart of the JAX package's
``telemetry/history.py``; the records are byte-compatible, so a journal
written by either package loads in the other).

Every committed take appends one compact JSON line to
``<root>/.telemetry_history.jsonl`` (``<root>`` = the directory holding
the snapshot, i.e. the CheckpointManager root for managed saves):
duration, fleet GB/s, bytes moved (storage vs peers), retries,
failovers, overlap, and the critical path's binding category. Page-in
sessions append their time to first inference and first-touch order (op
``pagein``); the autotuner appends ``type="profile"`` records, which
:func:`load_profiles` reads. :func:`detect_regression` and
:func:`render_trend` are the ``stats --trend`` gate and view.

Crash safety of the append: the record is ONE ``os.write`` on an
``O_APPEND`` descriptor (atomic for sane record sizes on POSIX), fenced
by an exclusive ``flock`` so two managers sharing a root interleave
whole lines. A torn line from a mid-write SIGKILL is skipped by the
reader — the journal is advisory history, never restore-critical state.

Wall-clock note: records carry ``time.time()`` (calendar time — this is
history ACROSS processes, where the in-process monotonic clock means
nothing). Durations still come from the telemetry bus clock upstream.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

HISTORY_FNAME = ".telemetry_history.jsonl"
TREND_THRESHOLD_ENV_VAR = "TORCHSNAPSHOT_GPU_TREND_THRESHOLD"
_DEFAULT_THRESHOLD = 0.25  # recent p50 >25% slower than baseline p50

#: Counters copied from the fleet aggregate into each history record.
_RECORD_COUNTERS = (
    "bytes_written",
    "bytes_read",
    "bytes_to_peers",
    "bytes_deduped",
    "retry_attempts",
    "store_failovers",
    "lease_renewals",
    "fanout_fallbacks",
    "mirror_failovers",
    "journal_appends",
    "journal_bytes",
    "journal_replays",
    "journal_truncations",
    "bytes_from_seeders",
    "seed_cache_hits",
    "epoch_push_bytes",
    "pages_faulted",
    "pages_prefetched",
    "pagein_bytes",
    "profile_skips",
    "georep_bases_shipped",
    "georep_epochs_shipped",
    "georep_bytes_shipped",
    "georep_ship_errors",
    "georep_frames_rejected",
    "georep_splice_refusals",
    "georep_steps_dropped",
)


def trend_threshold() -> float:
    raw = os.environ.get(TREND_THRESHOLD_ENV_VAR, "").strip()
    try:
        return float(raw) if raw else _DEFAULT_THRESHOLD
    except ValueError:
        return _DEFAULT_THRESHOLD


def history_path(root: str) -> str:
    return os.path.join(root, HISTORY_FNAME)


def build_record(
    op: str,
    path: str,
    wall_s: float,
    world_size: int,
    fleet: Optional[Dict[str, Any]],
    rank_summary: Optional[Dict[str, Any]] = None,
    step: Optional[int] = None,
    attribution: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One compact history line from whatever the take measured.

    Works with the telemetry bus OFF: wall time and identity always
    record; counters/rates appear when the bus contributed a fleet view."""
    rec: Dict[str, Any] = {
        "ts": round(time.time(), 3),
        "op": op,
        "snapshot": os.path.basename(path.rstrip("/")),
        "world_size": world_size,
        "wall_s": round(wall_s, 6),
    }
    if step is not None:
        rec["step"] = step
    agg = (fleet or {}).get("aggregate") or {}
    for key in _RECORD_COUNTERS:
        val = agg.get(key)
        if val:
            rec[key] = val
    for key in ("write_gbps", "read_gbps"):
        if agg.get(key):
            rec[key] = round(agg[key], 4)
    # The remote tier's RPO exposure at commit time. A gauge, not a
    # summed counter: the shipper is rank-0-only, so the local gauge IS
    # the fleet value — recorded so ``stats --trend`` can gate RPO.
    from . import core

    lag = (core.gauges() or {}).get("replication_lag_s")
    if lag is not None:
        rec["replication_lag_s"] = round(float(lag), 3)
    if fleet:
        rec["skew_s"] = fleet.get("skew_s")
        rec["slowest_rank"] = fleet.get("slowest_rank")
    # Critical-path verdict (critpath.merge_attributions): the binding
    # category per take, so the trend view can answer "when did saves
    # become storage-bound?" without re-opening every snapshot.
    binding = (attribution or {}).get("binding") or {}
    if binding.get("category"):
        rec["binding"] = binding["category"]
        if binding.get("gbps") is not None:
            rec["binding_gbps"] = binding["gbps"]
    # Overlap ratio: time the pipeline spent inside storage I/O spans
    # over the op wall — >1 means I/O genuinely overlapped with staging/
    # verify (the streaming pipelines working), <<1 means the op was
    # bound elsewhere. From the local (rank-0) summary; absent with the
    # bus off.
    spans = (rank_summary or {}).get("spans") or {}
    io_s = sum(
        (spans.get(name) or {}).get("total_s", 0.0)
        for name in ("storage_write", "stream_write", "storage_read", "read_stream")
    )
    if io_s and wall_s > 0:
        rec["overlap_ratio"] = round(io_s / wall_s, 3)
    return rec


def append_record(root: str, record: Dict[str, Any]) -> bool:
    """Fenced, crash-safe append of one record; returns False (never
    raises) when the root is not an appendable local directory."""
    try:
        if not os.path.isdir(root):
            return False
        line = (json.dumps(record, default=repr) + "\n").encode("utf-8")
        fd = os.open(
            history_path(root), os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644
        )
        try:
            try:
                import fcntl

                fcntl.flock(fd, fcntl.LOCK_EX)
            except (ImportError, OSError):  # non-POSIX / NFS without locks
                pass
            os.write(fd, line)  # one write: whole-line atomicity
        finally:
            os.close(fd)
        return True
    except OSError:
        logger.debug("history append skipped", exc_info=True)
        return False


def load_history(path_or_root: str) -> List[Dict[str, Any]]:
    """Parse a history journal (given the journal file or its root
    directory). Torn/malformed lines are skipped."""
    path = path_or_root
    if os.path.isdir(path):
        path = history_path(path)
    records: List[Dict[str, Any]] = []
    if not os.path.isfile(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn append from a killed writer
            if isinstance(rec, dict) and "wall_s" in rec:
                records.append(rec)
    return records


def load_profiles(path_or_root: str) -> List[Dict[str, Any]]:
    """Parse the journal's learned-profile records (``type="profile"``,
    appended by either package's IOGovernor closed loop,
    ``scheduler.IOGovernor.observe_verdict``), newest last.

    Profile records deliberately carry no ``wall_s``, so they are
    invisible to :func:`load_history` and the trend math; this is their
    reader. Records with no binding category are skipped here too — the
    same bus-off-take rule the learner applies (a ``None`` category must
    not poison a profile key)."""
    path = path_or_root
    if os.path.isdir(path):
        path = history_path(path)
    records: List[Dict[str, Any]] = []
    if not os.path.isfile(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn append from a killed writer
            if (
                isinstance(rec, dict)
                and rec.get("type") == "profile"
                and isinstance(rec.get("binding"), str)
                and rec.get("binding")
            ):
                records.append(rec)
    return records


def render_profiles(records: List[Dict[str, Any]]) -> str:
    """The ``explain --profiles`` rendering: per profile key, the
    converged settings, the smoothed verdict score, and the recent
    perturbation trail (dim, from -> to, kept/reverted/neutral) — the
    governor's full decision story for a root."""
    latest: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        key = (
            f"{rec.get('plugin', '?')}|w{rec.get('world_size', '?')}|"
            f"{rec.get('binding', '?')}"
        )
        latest[key] = rec  # newest last wins
    lines = [
        f"learned profiles: {len(latest)} key(s) "
        f"({len(records)} journal record(s))"
    ]
    for key in sorted(latest):
        rec = latest[key]
        when = time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(rec.get("ts", 0))
        )
        score = rec.get("score_gbps")
        lines.append(
            f"\n{key}  [{rec.get('op', '?')}]  "
            f"score {score:.2f} GB/s" if isinstance(score, (int, float))
            else f"\n{key}  [{rec.get('op', '?')}]  score ?"
        )
        lines.append(
            f"  takes {rec.get('takes', 0)}, last updated {when}"
        )
        settings = rec.get("settings") or {}
        if settings:
            for dim in sorted(settings):
                val = settings[dim]
                if dim.startswith("sub_chunk") and isinstance(val, int):
                    shown = f"{val >> 20} MB"
                else:
                    shown = str(val)
                lines.append(f"  {dim:<22} {shown}")
        else:
            lines.append("  (no converged settings yet — heuristics hold)")
        trials = rec.get("trials") or []
        for t in trials[-MAX_RENDERED_TRIALS:]:
            if not isinstance(t, dict):
                continue
            lines.append(
                f"  trial {t.get('dim', '?'):<18} "
                f"{t.get('from', '?')} -> {t.get('to', '?')}  "
                f"{t.get('verdict', '?'):<8} "
                f"({t.get('gbps', '?')} vs incumbent "
                f"{t.get('incumbent_gbps', '?')} GB/s)"
            )
    return "\n".join(lines)


MAX_RENDERED_TRIALS = 8


def _p50(values: List[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def detect_regression(
    records: List[Dict[str, Any]],
    metric: str = "wall_s",
    threshold: Optional[float] = None,
    recent_n: int = 5,
) -> Dict[str, Any]:
    """Compare the recent window's p50 against the baseline p50.

    ``metric``: ``wall_s`` (higher is worse) or a throughput metric
    ending in ``_gbps`` (lower is worse). The last ``recent_n`` records
    form the recent window; everything before is baseline. Needs at
    least 3 baseline and 2 recent points — fewer returns
    ``{"regressed": False, "reason": "insufficient history"}`` (a young
    deployment must not fail CI on noise)."""
    if threshold is None:
        threshold = trend_threshold()
    vals = [
        (r.get(metric), r) for r in records if isinstance(r.get(metric), (int, float))
    ]
    series = [float(v) for v, _ in vals]
    recent_n = max(1, min(recent_n, len(series) // 2))
    baseline, recent = series[:-recent_n], series[-recent_n:]
    if len(baseline) < 3 or len(recent) < 2:
        return {
            "metric": metric,
            "regressed": False,
            "reason": "insufficient history",
            "n": len(series),
        }
    base_p50, recent_p50 = _p50(baseline), _p50(recent)
    higher_is_worse = not metric.endswith("_gbps")
    if higher_is_worse:
        ratio = recent_p50 / base_p50 if base_p50 > 0 else 1.0
        regressed = ratio > 1.0 + threshold
    else:
        ratio = recent_p50 / base_p50 if base_p50 > 0 else 1.0
        regressed = ratio < 1.0 - threshold
    return {
        "metric": metric,
        "baseline_p50": round(base_p50, 6),
        "recent_p50": round(recent_p50, 6),
        "ratio": round(ratio, 4),
        "threshold": threshold,
        "baseline_n": len(baseline),
        "recent_n": len(recent),
        "regressed": regressed,
    }


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[float]) -> str:
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK_CHARS[0] * len(values)
    return "".join(
        _SPARK_CHARS[
            min(
                len(_SPARK_CHARS) - 1,
                int((v - lo) / (hi - lo) * (len(_SPARK_CHARS) - 1)),
            )
        ]
        for v in values
    )


def render_trend(
    records: List[Dict[str, Any]], verdicts: List[Dict[str, Any]]
) -> str:
    """The ``stats --trend`` rendering: per-metric trajectory sparklines,
    the last few takes in detail, and each regression verdict."""
    from .export import fmt_bytes

    lines = [f"history: {len(records)} committed take(s)"]
    for metric, label in (
        ("wall_s", "wall"),
        ("write_gbps", "write GB/s"),
        ("replication_lag_s", "repl lag"),
    ):
        series = [
            float(r[metric])
            for r in records
            if isinstance(r.get(metric), (int, float))
        ]
        if series:
            lines.append(
                f"  {label:<11} {_sparkline(series[-60:])}  "
                f"last={series[-1]:.3f} min={min(series):.3f} "
                f"max={max(series):.3f}"
            )
    lines.append("")
    for rec in records[-8:]:
        when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(rec.get("ts", 0)))
        extras = []
        if rec.get("write_gbps"):
            extras.append(f"{rec['write_gbps']:.2f} GB/s")
        if rec.get("bytes_written"):
            extras.append(fmt_bytes(rec["bytes_written"]))
        if rec.get("retry_attempts"):
            extras.append(f"{rec['retry_attempts']:.0f} retries")
        if rec.get("store_failovers"):
            extras.append(f"{rec['store_failovers']:.0f} store failover(s)")
        if rec.get("fanout_fallbacks"):
            extras.append(f"{rec['fanout_fallbacks']:.0f} fanout fallback(s)")
        if rec.get("bytes_from_seeders"):
            extras.append(f"{fmt_bytes(rec['bytes_from_seeders'])} from seeders")
        if rec.get("epoch_push_bytes"):
            extras.append(f"{fmt_bytes(rec['epoch_push_bytes'])} pushed")
        if rec.get("mirror_failovers"):
            extras.append(f"{rec['mirror_failovers']:.0f} mirror failover(s)")
        if rec.get("journal_replays"):
            extras.append(f"{rec['journal_replays']:.0f} journal replay(s)")
        if rec.get("journal_truncations"):
            extras.append(
                f"{rec['journal_truncations']:.0f} torn journal tail(s)"
            )
        if rec.get("binding"):
            extras.append(f"bound: {rec['binding']}")
        lines.append(
            f"  {when}  {rec.get('snapshot', '?'):<16} "
            f"{rec.get('op', '?'):<5} {rec.get('wall_s', 0):>9.3f}s"
            + ("  " + ", ".join(extras) if extras else "")
        )
    lines.append("")
    for v in verdicts:
        if v.get("reason"):
            lines.append(f"trend[{v['metric']}]: {v['reason']} (n={v.get('n', 0)})")
            continue
        word = "REGRESSED" if v["regressed"] else "ok"
        lines.append(
            f"trend[{v['metric']}]: {word} — recent p50 {v['recent_p50']:.3f} "
            f"vs baseline p50 {v['baseline_p50']:.3f} "
            f"(ratio {v['ratio']:.2f}, threshold ±{v['threshold']:.0%}, "
            f"{v['baseline_n']}+{v['recent_n']} takes)"
        )
    return "\n".join(lines)
