"""Telemetry exporters: Chrome/Perfetto trace JSON and the persisted
per-take summary.

Three consumers, three formats:

- :func:`chrome_trace` — the raw event list as Chrome's Trace Event
  format (``{"traceEvents": [...]}``), loadable in Perfetto /
  ``chrome://tracing``. Spans become ``ph: "X"`` complete events on the
  thread (tid) that ran them — executor lanes, the event loop, and the
  background commit thread render as separate tracks; counters/gauges
  become ``ph: "C"`` counter tracks.
- the persisted summary — ``Snapshot.take`` writes the cross-rank
  gathered per-op summaries plus the merged fleet view (aggregate.py)
  to :data:`TELEMETRY_SUMMARY_FNAME` next to ``.snapshot_metadata``, so
  :func:`render_summary_document` (and the JAX package's ``stats`` CLI,
  which reads the port's documents too) can answer "why was this take
  slow?" long after the process is gone.
- the plain-dict API — ``telemetry.last_summary()`` /
  ``telemetry.last_fleet()`` (core.py) for programmatic scraping
  (bench.py embeds them into its artifact).

Timestamps: events carry raw ``time.monotonic()`` seconds; the trace
exporter rebases to the earliest event and converts to the microseconds
Chrome expects, so ``ts`` is always >= 0 and mutually consistent within
one process's trace. Cross-rank traces are per-rank files — monotonic
clocks are not comparable across hosts, and Perfetto renders each file's
pid lane independently.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from . import core

# Persisted next to .snapshot_metadata by rank 0 after the commit.
TELEMETRY_SUMMARY_FNAME = ".snapshot_telemetry"
# Per-rank Chrome traces, written by each telemetry-enabled rank.
TRACE_DIR = ".telemetry"


def trace_path_for_rank(rank: int) -> str:
    return f"{TRACE_DIR}/rank_{rank}.trace.json"


def chrome_trace(
    events: Optional[List[Dict[str, Any]]] = None,
    pid: int = 0,
    process_name: str = "torchsnapshot_tpu_torch",
) -> Dict[str, Any]:
    """Convert recorded events to Chrome Trace Event format.

    ``events`` defaults to everything recorded in this process;
    ``pid`` labels the process lane (use the rank on distributed ops).
    """
    if events is None:
        events = core.events()
    trace: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"{process_name} (rank {pid})"},
        }
    ]
    if not events:
        return {"traceEvents": trace, "displayTimeUnit": "ms"}
    t0 = min(e["ts"] for e in events)

    def us(seconds: float) -> int:
        return int(round((seconds - t0) * 1e6))

    for ev in sorted(events, key=lambda e: e["ts"]):
        ph = ev.get("ph")
        # tids are Python thread idents (large); compact them for the UI.
        tid = ev.get("tid", 0) % 100_000
        if ph == "span":
            out = {
                "ph": "X",
                "name": ev["name"],
                "cat": ev.get("cat", "pipeline"),
                "pid": pid,
                "tid": tid,
                "ts": us(ev["ts"]),
                "dur": max(0, int(round(ev["dur"] * 1e6))),
            }
            args = dict(ev.get("args") or {})
            if ev.get("parent") is not None:
                args["parent"] = ev["parent"]
            if args:
                out["args"] = args
            trace.append(out)
        elif ph == "counter":
            trace.append(
                {
                    "ph": "C",
                    "name": ev["name"],
                    "cat": ev.get("cat", "counter"),
                    "pid": pid,
                    "tid": 0,
                    "ts": us(ev["ts"]),
                    "args": {ev["name"]: ev.get("value", 0)},
                }
            )
        else:  # instant
            trace.append(
                {
                    "ph": "i",
                    "s": "t",
                    "name": ev["name"],
                    "cat": ev.get("cat", "event"),
                    "pid": pid,
                    "tid": tid,
                    "ts": us(ev["ts"]),
                    "args": ev.get("args") or {},
                }
            )
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def chrome_trace_json(
    events: Optional[List[Dict[str, Any]]] = None, pid: int = 0
) -> str:
    return json.dumps(chrome_trace(events, pid=pid))


def write_chrome_trace(
    path: str, events: Optional[List[Dict[str, Any]]] = None, pid: int = 0
) -> None:
    """Write a Chrome trace of ``events`` to a local file."""
    with open(path, "w") as f:
        f.write(chrome_trace_json(events, pid=pid))


# ------------------------------------------------------------ summary file


def build_summary_document(
    op: str,
    world_size: int,
    rank_summaries: List[Optional[Dict[str, Any]]],
    fleet: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    return {
        "version": 1,
        "op": op,
        "world_size": world_size,
        "ranks": rank_summaries,
        "fleet": fleet,
    }


def fmt_bytes(n: Optional[float]) -> str:
    """THE byte formatter for operator-facing output (cli.py info/ls and
    the stats rendering below share it, so sizes read identically across
    commands)."""
    if n is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:g}B"
        n /= 1024
    return f"{n}B"


_fmt_bytes = fmt_bytes


def render_summary_document(doc: Dict[str, Any], verbose: bool = False) -> str:
    """Human-readable rendering of a persisted summary document (the
    ``stats`` CLI command's output)."""
    lines: List[str] = []
    lines.append(f"op:          {doc.get('op')}")
    lines.append(f"world_size:  {doc.get('world_size')}")
    fleet = doc.get("fleet")
    ranks = [r for r in (doc.get("ranks") or []) if r]
    if fleet:
        lines.append(f"fleet wall:  {fleet.get('wall_s_max', 0):.3f}s "
                     f"(slowest rank {fleet.get('slowest_rank')}, "
                     f"skew {fleet.get('skew_s', 0):.3f}s)")
        agg = fleet.get("aggregate") or {}
        if agg.get("bytes_written"):
            lines.append(
                f"written:     {_fmt_bytes(agg['bytes_written'])} aggregate"
                + (
                    f" ({agg['write_gbps']:.2f} GB/s fleet)"
                    if agg.get("write_gbps")
                    else ""
                )
            )
        if agg.get("bytes_read"):
            lines.append(f"read:        {_fmt_bytes(agg['bytes_read'])} aggregate")
        if agg.get("bytes_deduped"):
            lines.append(f"deduped:     {_fmt_bytes(agg['bytes_deduped'])} skipped")
        if agg.get("bytes_to_peers"):
            lines.append(
                f"peer bytes:  {_fmt_bytes(agg['bytes_to_peers'])} redistributed"
            )
        # Fleet seeding tier (distrib.py): the seed-vs-storage byte mix
        # of a fleet restore — ``read`` above is what actually hit
        # storage, this is what arrived from peers instead.
        if agg.get("bytes_from_seeders"):
            lines.append(
                f"seeded:      {_fmt_bytes(agg['bytes_from_seeders'])} "
                "from peers"
                + (
                    f" ({agg['seed_cache_hits']:.0f} cache hit(s))"
                    if agg.get("seed_cache_hits")
                    else ""
                )
            )
        if agg.get("retry_attempts"):
            lines.append(f"retries:     {agg['retry_attempts']:.0f} attempts")
        # Degradation counters: zero is the healthy (and silent) case;
        # any non-zero value is the headline of a post-mortem.
        degraded = [
            f"{label}={agg[key]:.0f}"
            for key, label in (
                ("store_failovers", "store"),
                ("mirror_failovers", "mirror"),
                ("fanout_fallbacks", "fanout"),
            )
            if agg.get(key)
        ]
        if degraded:
            lines.append(f"failovers:   {', '.join(degraded)}")
        if agg.get("lease_renewals"):
            lines.append(
                f"lease:       {agg['lease_renewals']:.0f} renewal round(s)"
            )
        # Delta-journal column: appended epochs on the write side, replays
        # and torn-tail truncations on the restore side (journal.py).
        journal_bits = []
        if agg.get("journal_appends"):
            journal_bits.append(
                f"{agg['journal_appends']:.0f} append(s) "
                f"({_fmt_bytes(agg.get('journal_bytes', 0))})"
            )
        if agg.get("journal_replays"):
            journal_bits.append(f"{agg['journal_replays']:.0f} replay(s)")
        if agg.get("journal_truncations"):
            journal_bits.append(
                f"{agg['journal_truncations']:.0f} torn tail(s) truncated"
            )
        if agg.get("epoch_push_bytes"):
            journal_bits.append(
                f"{_fmt_bytes(agg['epoch_push_bytes'])} pushed to replicas"
            )
        if journal_bits:
            lines.append(f"journal:     {', '.join(journal_bits)}")
    for summary in ranks:
        lines.append("")
        lines.append(
            f"rank {summary.get('rank')}: {summary.get('op')} "
            f"{summary.get('wall_s', 0):.3f}s"
        )
        phases = summary.get("phases") or {}
        if phases:
            lines.append(
                "  phases:   "
                + ", ".join(f"{n}={dt:.3f}s" for n, dt in phases.items())
            )
        counters = summary.get("counters") or {}
        for key in sorted(counters):
            val = counters[key]
            shown = _fmt_bytes(val) if key.startswith("bytes_") else f"{val:g}"
            lines.append(f"  {key}: {shown}")
        spans = summary.get("spans") or {}
        order = sorted(
            spans.items(), key=lambda kv: kv[1].get("total_s", 0), reverse=True
        )
        if not verbose:
            order = order[:8]
        for name, agg in order:
            lines.append(
                f"  span {name}: x{agg['count']} total {agg['total_s']:.3f}s "
                f"max {agg['max_s']:.3f}s"
            )
        if verbose and summary.get("rates"):
            lines.append(f"  rates: {summary['rates']}")
        if verbose:
            for row in summary.get("governor") or []:
                args = ", ".join(
                    f"{k}={v}" for k, v in row.items() if k != "site"
                )
                lines.append(f"  governor[{row.get('site', '?')}]: {args}")
        if summary.get("dropped_events"):
            lines.append(f"  dropped_events: {summary['dropped_events']}")
    hist = (fleet or {}).get("histograms") or {}
    if hist:
        lines.append("")
        lines.append("latency histograms (fleet, bucket-wise sums):")
        lines.extend(render_histogram_lines(hist))
    return "\n".join(lines)


def render_histogram_lines(
    histograms: Dict[str, Dict[str, Dict[str, Any]]]
) -> List[str]:
    """Human-readable one-liners for a histogram table (shared by the
    ``stats`` fleet rendering and the ``explain`` CLI): approximate
    p50/p95/max from the log2 buckets, labeled by family and key."""
    from .core import HISTOGRAM_BOUNDS, histogram_quantile

    lines: List[str] = []
    for name in sorted(histograms):
        for key in sorted(histograms[name]):
            hist = histograms[name][key]
            count = hist.get("count") or 0
            if not count:
                continue
            p50 = histogram_quantile(hist, 0.5)
            p95 = histogram_quantile(hist, 0.95)
            counts = hist.get("counts") or []
            top = None
            for i in range(len(counts) - 1, -1, -1):
                if counts[i]:
                    top = (
                        HISTOGRAM_BOUNDS[i]
                        if i < len(HISTOGRAM_BOUNDS)
                        else float("inf")
                    )
                    break
            label = f"{name}[{key}]" if key else name
            lines.append(
                f"  {label}: n={count} p50<={_fmt_s(p50)} "
                f"p95<={_fmt_s(p95)} max<={_fmt_s(top)} "
                f"sum={_fmt_s(hist.get('sum'))}"
            )
    return lines


def _fmt_s(seconds: Optional[float]) -> str:
    if seconds is None:
        return "?"
    if seconds == float("inf"):
        return "inf"
    if seconds >= 1.0:
        return f"{seconds:.3g}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.3g}ms"
    return f"{seconds * 1e6:.3g}us"


# -------------------------------------------------------------- openmetrics

_METRIC_PREFIX = "torchsnapshot_tpu"


def _om_escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def om_family_name(name: str) -> str:
    """Prefixed, spec-legal metric family name: every character outside
    ``[a-zA-Z0-9_:]`` becomes ``_`` (histogram names like
    ``write.sub_chunk_s`` carry dots)."""
    safe = "".join(
        c if (c.isascii() and (c.isalnum() or c in "_:")) else "_"
        for c in name
    )
    return f"{_METRIC_PREFIX}_{safe}"


def _om_label_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_om_escape(v)}"' for k, v in labels.items() if v is not None
    )
    return "{" + inner + "}" if inner else ""


def om_histogram_lines(
    name: str,
    by_key: Dict[str, Dict[str, Any]],
    extra_labels: Optional[Dict[str, Any]] = None,
    help_text: Optional[str] = None,
) -> List[str]:
    """One OpenMetrics histogram family from a bus histogram snapshot
    (``{key: {"counts": [...], "count": n, "sum": s}}``): cumulative
    ``_bucket`` samples over the fixed log2 ladder, ``+Inf`` equal to
    ``_count``, plus ``_count``/``_sum`` — the shape strict parsers
    (prometheus_client) demand. Shared by ``stats --openmetrics`` and
    the live /metrics exporter so the two can never drift."""
    from .core import HISTOGRAM_BOUNDS

    family = om_family_name(name)
    lines = [f"# TYPE {family} histogram"]
    if help_text:
        lines.append(f"# HELP {family} {_om_escape(help_text)}")
    for key in sorted(by_key):
        hist = by_key[key]
        labels = dict(extra_labels or {})
        if key:
            labels["key"] = key
        cumulative = 0
        counts = hist.get("counts") or []
        for i, bound in enumerate(HISTOGRAM_BOUNDS):
            cumulative += counts[i] if i < len(counts) else 0
            bl = dict(labels)
            bl["le"] = repr(bound)
            lines.append(f"{family}_bucket{_om_label_str(bl)} {cumulative}")
        bl = dict(labels)
        bl["le"] = "+Inf"
        total = hist.get("count") or 0
        lines.append(f"{family}_bucket{_om_label_str(bl)} {total}")
        lines.append(f"{family}_count{_om_label_str(labels)} {total}")
        lines.append(
            f"{family}_sum{_om_label_str(labels)} {hist.get('sum') or 0:g}"
        )
    return lines


def render_openmetrics(doc: Dict[str, Any]) -> str:
    """Render a persisted summary document in OpenMetrics text format
    (``stats --openmetrics``), so a scrape sidecar can lift a take's
    counters into Prometheus without parsing our JSON.

    Counter families end in ``_total`` per the spec; per-rank samples
    carry a ``rank`` label; the exposition ends with ``# EOF``."""
    lines: List[str] = []
    op = doc.get("op") or "unknown"
    fleet = doc.get("fleet") or {}
    agg = fleet.get("aggregate") or {}
    ranks = [r for r in (doc.get("ranks") or []) if isinstance(r, dict)]

    counter_keys = sorted(
        k for k, v in agg.items()
        if isinstance(v, (int, float)) and not k.endswith("_gbps")
    )
    for key in counter_keys:
        # Per the OpenMetrics spec the TYPE/HELP lines name the metric
        # FAMILY (no suffix); only the sample carries ``_total``. Strict
        # parsers (prometheus_client) reject a _total-suffixed family as
        # a name clash with its own sample.
        family = f"{_METRIC_PREFIX}_{key}"
        lines.append(f"# TYPE {family} counter")
        lines.append(f"# HELP {family} fleet-summed {key} for the last {op}")
        lines.append(f'{family}_total{{op="{_om_escape(op)}"}} {agg[key]:g}')
    gauge_rows = [
        ("fleet_wall_seconds", fleet.get("wall_s_max")),
        ("fleet_skew_seconds", fleet.get("skew_s")),
        ("fleet_write_gbps", agg.get("write_gbps")),
        ("fleet_read_gbps", agg.get("read_gbps")),
        ("world_size", doc.get("world_size")),
        ("reporting_ranks", fleet.get("reporting")),
    ]
    for key, value in gauge_rows:
        if value is None:
            continue
        name = f"{_METRIC_PREFIX}_{key}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f'{name}{{op="{_om_escape(op)}"}} {value:g}')
    if ranks:
        name = f"{_METRIC_PREFIX}_rank_wall_seconds"
        lines.append(f"# TYPE {name} gauge")
        for summary in ranks:
            lines.append(
                f'{name}{{op="{_om_escape(op)}",'
                f'rank="{summary.get("rank", 0)}"}} '
                f"{summary.get('wall_s', 0):g}"
            )
    # Fleet latency histograms (bucket-wise sums across ranks) as real
    # OpenMetrics histogram families — the distribution view the scalar
    # counters above cannot carry.
    for hname, by_key in sorted((fleet.get("histograms") or {}).items()):
        lines.extend(
            om_histogram_lines(hname, by_key, extra_labels={"op": op})
        )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
