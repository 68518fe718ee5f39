"""Cross-rank telemetry aggregation: per-rank summaries -> fleet view.

On distributed takes/restores the per-rank summary dicts (core.OpRecorder
.finish) are gathered over the existing KV-store collective plane
(pg_wrapper.all_gather_object — the same channel the manifest gather
uses; telemetry never touches device collectives) and merged here into
one fleet view: who was slowest, how skewed the ranks were, and the
aggregate byte counters. The merge is pure dict math so it can run
anywhere — rank 0 at commit time, the ``stats`` CLI re-deriving a view
from a persisted document, or a test constructing synthetic summaries.

A rank whose telemetry was disabled contributes ``None`` (the gather is
unconditional so env skew can never desync the collective order); the
merge simply reports how many ranks contributed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# Counters that sum meaningfully across ranks. Everything else (gauges,
# span stats) stays per-rank in the persisted document.
_SUMMED_COUNTERS = (
    "bytes_written",
    "bytes_read",
    "bytes_staged",
    "bytes_deduped",
    "bytes_to_peers",
    "entries_written",
    "entries_streamed",
    "entries_read",
    "retry_attempts",
    "retry_backoff_s",
    "budget_defers",
    # Degradation counters (PR 4/6 machinery): a fleet that failed over
    # mid-take must SAY so in the persisted summary — these existed on
    # the bus but vanished post-hoc until the observability PR.
    "store_failovers",
    "lease_renewals",
    "fanout_fallbacks",
    "mirror_failovers",
    # Delta journal (journal.py): epoch appends and restore-side replay,
    # plus torn-tail truncations — the RPO story in one summary row.
    "journal_appends",
    "journal_bytes",
    "journal_replays",
    "journal_truncations",
    # Fleet distribution tier (distrib.py): bytes sourced from seeding
    # peers instead of storage, local chunk-cache hits, and rolling-
    # update epoch bytes pushed — the seed-vs-storage mix in one row.
    "bytes_from_seeders",
    "seed_cache_hits",
    "epoch_push_bytes",
    # Multi-tenant plane (tenancy/): quota evictions and pooled-payload
    # reclaim, plus remote roots where retention could not run — the
    # per-tenant capacity story in one row.
    "retention_skipped",
    "quota_evictions",
    "pool_bytes_released",
    # Lazy page-in restore (pagein.py): demand faults vs speculative
    # prefetch and the bytes paged after restore() returned — the
    # serve-before-restored story in one row.
    "pages_faulted",
    "pages_prefetched",
    "pagein_bytes",
    # Closed-loop autotune (scheduler.IOGovernor / autotune.py): ops
    # whose verdict carried no binding category and were therefore
    # skipped by profile learning — a high count means the tuner is
    # flying blind (telemetry bus off / attribution failing).
    "profile_skips",
    # Cross-region geo-replication (georep.py): what the rank-0 shipper
    # moved, what it refused (CRC rejects, splice refusals), and what it
    # shed under backlog pressure — the DR-tier health in one row.
    "georep_bases_shipped",
    "georep_epochs_shipped",
    "georep_bytes_shipped",
    "georep_ship_errors",
    "georep_frames_rejected",
    "georep_splice_refusals",
    "georep_steps_dropped",
)


def merge_histograms(
    rank_summaries: List[Optional[Dict[str, Any]]]
) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Bucket-wise sum of every rank's latency histograms.

    Histograms share the fixed log2 ladder (core.HISTOGRAM_BOUNDS), so
    the merge is element-wise addition per ``(name, key)`` family —
    short/long counts lists (version skew) are padded, never dropped."""
    merged: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for summary in rank_summaries:
        if not isinstance(summary, dict):
            continue
        for name, by_key in (summary.get("histograms") or {}).items():
            for key, hist in by_key.items():
                counts = list(hist.get("counts") or [])
                tgt = merged.setdefault(name, {}).setdefault(
                    key, {"counts": [], "count": 0, "sum": 0.0}
                )
                if len(tgt["counts"]) < len(counts):
                    tgt["counts"].extend(
                        [0] * (len(counts) - len(tgt["counts"]))
                    )
                for i, n in enumerate(counts):
                    tgt["counts"][i] += n
                tgt["count"] += hist.get("count") or 0
                tgt["sum"] = round(tgt["sum"] + (hist.get("sum") or 0.0), 6)
    return merged


def merge_summaries(
    rank_summaries: List[Optional[Dict[str, Any]]]
) -> Optional[Dict[str, Any]]:
    """Merge gathered per-rank summaries into the fleet view.

    Returns None when no rank contributed (telemetry off everywhere).
    """
    present = [
        (i, s) for i, s in enumerate(rank_summaries) if isinstance(s, dict)
    ]
    if not present:
        return None
    walls = [(s.get("wall_s", 0.0), i) for i, s in present]
    wall_max, slowest = max(walls)
    wall_min, fastest = min(walls)
    aggregate: Dict[str, float] = {}
    for _, s in present:
        for key in _SUMMED_COUNTERS:
            val = (s.get("counters") or {}).get(key)
            if val:
                aggregate[key] = aggregate.get(key, 0) + val
    if aggregate.get("bytes_written") and wall_max > 0:
        # Fleet bandwidth over the op's critical path: everyone's bytes
        # over the slowest rank's wall (the time the TRAINING LOOP paid).
        # Unrounded: tiny test payloads would round to 0.
        aggregate["write_gbps"] = aggregate["bytes_written"] / wall_max / 1e9
    if aggregate.get("bytes_read") and wall_max > 0:
        aggregate["read_gbps"] = aggregate["bytes_read"] / wall_max / 1e9
    histograms = merge_histograms([s for _, s in present])
    return {
        "world_size": len(rank_summaries),
        "reporting": len(present),
        "op": present[0][1].get("op"),
        "wall_s_max": round(wall_max, 6),
        "wall_s_min": round(wall_min, 6),
        "skew_s": round(wall_max - wall_min, 6),
        "slowest_rank": slowest,
        "fastest_rank": fastest,
        "aggregate": aggregate,
        **({"histograms": histograms} if histograms else {}),
    }
