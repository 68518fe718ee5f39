"""Critical-path attribution: which resource bound the wall clock of a
take/restore, and on which rank (the port's copy of
``torchsnapshot_tpu/telemetry/critpath.py``; the documents interchange).

The telemetry bus records WHAT happened (spans, counters, rates); this
module answers the operator's actual question — "why was this take
slow?" — with a defensible attribution instead of a span dump. Three
steps:

1. **Per-rank attribution** (:func:`build_attribution`): the rank's span
   events are mapped onto a FIXED category taxonomy (:data:`CATEGORIES`
   — staging copy, hash, storage write/read, decode/verify, peer
   transfer, collective wait) and each category's busy time is the
   UNION of its span intervals, so concurrent sub-chunk writes count
   once. Wall time no category covers is scheduler idle (budget defers,
   event-loop gaps). The op is also cut into *segments* at collective
   boundaries — pg_wrapper's ``collective_wait`` spans carry the
   ``(ns, cseq)`` causal key every rank of one collective shares — with
   per-segment category breakdowns.
2. **Cross-rank critical path** (:func:`merge_attributions`): collective
   keys align segments across ranks (the same stitching idea the flight
   recorder's blackbox merge uses — causal keys, never clocks). Within
   each segment, the rank that took longest to reach the next collective
   is the one that gated the fleet; the critical path is that chain, and
   fleet attribution sums the gating rank's categories per segment. The
   waiting peers' ``collective_wait`` time is deliberately EXCLUDED —
   waiting is a symptom; the binding resource lives on the rank being
   waited for.
3. **The verdict**: the binding category (largest share of the critical
   path), its class (``storage`` / ``pipeline`` / ``coordination``), the
   achieved rate over the binding window cross-checked against the
   governor's measured rates, the straggler delta, and a concrete tuning
   hint. :func:`render_attribution` renders it (the JAX package's
   ``explain`` CLI reads the port's documents too), and
   :func:`binding_exit_code` tells storage-bound (1) from pipeline-bound
   (0).

Persistence: rank 0 writes the merged record to
``.snapshot_critpath`` next to ``.snapshot_telemetry`` (compact — the
full per-rank attributions ride the telemetry document's rank
summaries), and the binding category rides the checkpoint-history
journal so trend queries can ask "when did we become storage-bound?".
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: Persisted next to .snapshot_telemetry by rank 0 after the commit.
ATTRIBUTION_FNAME = ".snapshot_critpath"

#: The fixed attribution taxonomy. Pinned: fleet merges, the history
#: journal, and the explain rendering all key on these names.
CATEGORIES: Tuple[str, ...] = (
    "stage_copy",       # DtoH copy + serialization (staging)
    "hash",             # fingerprint/digest passes
    "storage_write",    # bytes moving to the storage tier
    "storage_read",     # bytes moving from the storage tier
    "decode",           # verify/decompress/HtoD on the restore side
    "peer_transfer",    # cooperative fan-out byte redistribution
    "native_io",        # blocked on the native engine (io_uring reap/drain)
    "collective_wait",  # blocked inside a KV-store collective
    "sched_idle",       # wall no instrumented work covered (budget
                        # defers, event-loop gaps, un-spanned work)
)

#: Span name -> category, for spans whose WHOLE duration is one
#: resource. Spans not listed here or in :data:`FUSED_SPANS` (io_drain
#: and other containers) attribute through their children, never
#: themselves.
SPAN_CATEGORIES: Dict[str, str] = {
    "stage_hash": "hash",
    "sub_chunk_stage": "stage_copy",
    "sub_chunk_dtoh": "stage_copy",
    "storage_write": "storage_write",
    "storage_read": "storage_read",
    "consume": "decode",
    "consume_chunk": "decode",
    "sub_chunk_htod": "decode",
    "coop_read": "peer_transfer",
    "peer_send": "peer_transfer",
    "peer_recv": "peer_transfer",
    # Planned-reshard tier (reshard.py): plan computation and owner-side
    # region-bundle forwarding ride the peer_transfer lane — both exist
    # only to replace storage reads with peer traffic, so attribution
    # groups them with the coop fan-out they extend.
    "reshard_plan": "peer_transfer",
    "peer_reshard": "peer_transfer",
    # Native-engine waits (fs plugin, io_uring reap/drain): time the
    # pipeline spent blocked on queued kernel I/O — submissions are
    # non-blocking, so these spans ARE the engine's storage wait.
    "native_write": "native_io",
    "native_read": "native_io",
    "collective_wait": "collective_wait",
}

#: Fused/container spans: name -> (residual category, covering
#: categories). A fused span interleaves two resources (PR 1/3
#: streaming: stage of sub-chunk N+1 under the write of N), so charging
#: its whole window to one category would call every streamed tmpfs
#: save "storage-bound". Instead, the window NOT covered by the inner
#: covering-category spans — the time the pipeline sat in the fused
#: span with no instrumented pipeline work running, i.e. waiting on the
#: residual resource — attributes to the residual category.
FUSED_SPANS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "stream_write": ("storage_write", ("stage_copy", "hash", "native_io")),
    "stream_read": ("storage_read", ("decode", "peer_transfer", "native_io")),
    "stage": ("stage_copy", ("hash", "stage_copy")),
}

_CATEGORY_CLASS: Dict[str, str] = {
    "storage_write": "storage",
    "storage_read": "storage",
    "native_io": "storage",
    "collective_wait": "coordination",
}

#: Tuning hint per binding category — the "what do I turn" line the
#: explain CLI prints. {rate}/{ranks}/{defers} are filled at render time.
_HINTS: Dict[str, str] = {
    "storage_write": (
        "storage-write-bound at {rate} on rank(s) {ranks} — raise "
        "TORCHSNAPSHOT_GPU_IO_CONCURRENCY, keep streaming writes "
        "elected (TORCHSNAPSHOT_GPU_STREAM_WRITES), or move the tier "
        "(mirror to faster storage)"
    ),
    "storage_read": (
        "storage-read-bound at {rate} on rank(s) {ranks} — raise "
        "TORCHSNAPSHOT_GPU_IO_CONCURRENCY, keep streamed reads on "
        "(TORCHSNAPSHOT_GPU_STREAM_READS), or let cooperative restore "
        "fan out (TORCHSNAPSHOT_GPU_COOP_RESTORE)"
    ),
    "stage_copy": (
        "staging-bound (DtoH copy/serialization) on rank(s) {ranks} — "
        "pipeline-bound: the native pinned-staging fast path is the "
        "lever, not storage tuning"
    ),
    "hash": (
        "hash-bound on rank(s) {ranks} — skip the preverify pass "
        "(TORCHSNAPSHOT_GPU_PREVERIFY=never) or record device digests "
        "so unchanged payloads skip hashing"
    ),
    "decode": (
        "verify/decompress-bound on rank(s) {ranks} — lower the "
        "compression level or codec (TORCHSNAPSHOT_GPU_COMPRESSION); "
        "pipeline-bound"
    ),
    "peer_transfer": (
        "peer-transfer-bound on rank(s) {ranks} — the host network is "
        "the bottleneck; shrink the cooperative fan-out "
        "(TORCHSNAPSHOT_GPU_COOP_RESTORE=never) or widen the NIC"
    ),
    "native_io": (
        "native-engine-bound at {rate} on rank(s) {ranks} — the "
        "io_uring queue is the bottleneck: raise "
        "TORCHSNAPSHOT_GPU_NATIVE_QUEUE_DEPTH, or move the tier to "
        "faster storage (the Python pipeline is already off the path)"
    ),
    "collective_wait": (
        "coordination-bound — rank(s) {ranks} spent the critical path "
        "blocked in collectives; inspect the straggler with `watch` "
        "(live) or `blackbox` (post-abort)"
    ),
    "sched_idle": (
        "scheduler-idle-bound on rank(s) {ranks} — {defers} budget "
        "defer(s); raise TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES "
        "or reduce concurrent per-host ranks"
    ),
}


#: A resource "binds" the op only when it gated the majority of the
#: critical path; below this share the verdict stays pipeline-bound.
_BOUND_SHARE = 0.5


def classify_category(category: Optional[str]) -> str:
    """``storage`` / ``coordination`` / ``pipeline`` for a category."""
    if category is None:
        return "pipeline"
    return _CATEGORY_CLASS.get(category, "pipeline")


# ---------------------------------------------------------- interval math


def _union_seconds(
    intervals: List[Tuple[float, float]],
    lo: Optional[float] = None,
    hi: Optional[float] = None,
) -> float:
    """Total length of the union of ``intervals``, optionally clipped to
    ``[lo, hi]`` — the anti-double-count primitive: sixteen concurrent
    sub-chunk writes are one wall-clock lane, not sixteen."""
    clipped = []
    for a, b in intervals:
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            clipped.append((a, b))
    if not clipped:
        return 0.0
    clipped.sort()
    total = 0.0
    cur_a, cur_b = clipped[0]
    for a, b in clipped[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    total += cur_b - cur_a
    return total


def _merge_intervals(
    intervals: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _subtract_intervals(
    intervals: List[Tuple[float, float]],
    cover: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    """``intervals`` minus ``cover`` — the residual-attribution primitive
    for fused spans."""
    out: List[Tuple[float, float]] = []
    cover = _merge_intervals(cover)
    for a, b in _merge_intervals(intervals):
        cur = a
        for ca, cb in cover:
            if cb <= cur:
                continue
            if ca >= b:
                break
            if ca > cur:
                out.append((cur, min(ca, b)))
            cur = max(cur, cb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


# ------------------------------------------------------ per-rank records


def _span_intervals(
    events: List[Dict[str, Any]]
) -> Dict[str, List[Tuple[float, float]]]:
    per_cat: Dict[str, List[Tuple[float, float]]] = {}
    fused: Dict[str, List[Tuple[float, float]]] = {}
    for ev in events:
        if ev.get("ph") != "span":
            continue
        name = ev.get("name", "")
        ts = ev.get("ts")
        dur = ev.get("dur")
        if ts is None or dur is None or dur < 0:
            continue
        cat = SPAN_CATEGORIES.get(name)
        if cat is not None:
            per_cat.setdefault(cat, []).append((ts, ts + dur))
        elif name in FUSED_SPANS:
            fused.setdefault(name, []).append((ts, ts + dur))
    # Fused spans: attribute the window their covering categories did
    # not occupy to the residual resource (see FUSED_SPANS). Sorted so
    # "stage" folds its residual into stage_copy BEFORE stream_write
    # computes its cover from it — deterministic, and staging time
    # inside a fused write never leaks into the storage residual.
    for name in sorted(fused):
        intervals = fused[name]
        residual_cat, cover_cats = FUSED_SPANS[name]
        cover: List[Tuple[float, float]] = []
        for c in cover_cats:
            cover.extend(per_cat.get(c, []))
        per_cat.setdefault(residual_cat, []).extend(
            _subtract_intervals(intervals, cover)
        )
    return per_cat


def build_attribution(
    events: List[Dict[str, Any]],
    wall_s: Optional[float] = None,
    rank: int = 0,
) -> Dict[str, Any]:
    """One rank's attribution record from its op-scoped bus events.

    ``categories`` maps each taxonomy category to its busy seconds (span
    union); ``sched_idle`` is the wall no category covered. ``segments``
    cuts the op at collective boundaries (``collective_wait`` spans,
    keyed by the shared ``ns#cseq``) with a per-segment breakdown —
    compact by construction: a take has a handful of collectives, never
    one per sub-chunk."""
    spans = [
        ev
        for ev in events
        if ev.get("ph") == "span"
        and ev.get("ts") is not None
        and ev.get("dur") is not None
    ]
    per_cat = _span_intervals(spans)
    if spans:
        t_begin = min(ev["ts"] for ev in spans)
        t_end = max(ev["ts"] + ev["dur"] for ev in spans)
    else:
        t_begin = t_end = 0.0
    wall = wall_s if wall_s is not None else (t_end - t_begin)
    categories: Dict[str, float] = {}
    all_intervals: List[Tuple[float, float]] = []
    for cat, intervals in per_cat.items():
        busy = _union_seconds(intervals)
        if busy > 0:
            categories[cat] = round(busy, 6)
        all_intervals.extend(intervals)
    covered = _union_seconds(all_intervals)
    idle = max(0.0, (wall or 0.0) - covered)
    if idle > 0:
        categories["sched_idle"] = round(idle, 6)

    colls = sorted(
        (ev for ev in spans if ev.get("name") == "collective_wait"),
        key=lambda ev: ev["ts"],
    )
    segments: List[Dict[str, Any]] = []
    prev = t_begin
    for coll in colls:
        args = coll.get("args") or {}
        key = f"{args.get('ns')}#{args.get('cseq')}"
        seg = _segment(per_cat, prev, coll["ts"])
        seg.update(
            key=key,
            kind=args.get("kind"),
            wait_s=round(coll["dur"], 6),
        )
        segments.append(seg)
        prev = coll["ts"] + coll["dur"]
    if spans:
        tail = _segment(per_cat, prev, t_end)
        tail.update(key="tail", kind=None, wait_s=0.0)
        segments.append(tail)
    return {
        "rank": rank,
        "wall_s": round(wall or 0.0, 6),
        "categories": categories,
        "segments": segments,
    }


def _segment(
    per_cat: Dict[str, List[Tuple[float, float]]], lo: float, hi: float
) -> Dict[str, Any]:
    cats: Dict[str, float] = {}
    all_iv: List[Tuple[float, float]] = []
    for cat, intervals in per_cat.items():
        if cat == "collective_wait":
            continue  # the segment's own wait is reported separately
        busy = _union_seconds(intervals, lo, hi)
        if busy > 0:
            cats[cat] = round(busy, 6)
        all_iv.extend(intervals)
    busy_all = _union_seconds(all_iv, lo, hi)
    dur = max(0.0, hi - lo)
    idle = max(0.0, dur - busy_all)
    if idle > 0:
        cats["sched_idle"] = round(idle, 6)
    return {"dur_s": round(dur, 6), "categories": cats}


# --------------------------------------------------------- fleet stitching


def merge_attributions(
    rank_attrs: List[Optional[Dict[str, Any]]],
    aggregate: Optional[Dict[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Stitch per-rank attributions into the fleet's critical path.

    Segments are aligned by collective key (identical on every rank of
    one collective); within each, the gating rank is the one with the
    longest segment, and its categories — not the waiters'
    ``collective_wait`` — enter the fleet attribution. Ranks whose
    telemetry was off contribute None; with no shared segments (single
    rank, skew) the slowest rank's whole-op attribution stands in.
    ``aggregate`` (the fleet counter sums) turns the binding window into
    an achieved rate for the storage/staging categories."""
    present = [
        (i, a) for i, a in enumerate(rank_attrs) if isinstance(a, dict)
    ]
    if not present:
        return None
    walls = [(a.get("wall_s", 0.0), i) for i, a in present]
    wall_max, slowest = max(walls)
    wall_min, fastest = min(walls)

    seg_by_rank: Dict[int, Dict[str, Dict[str, Any]]] = {}
    for i, a in present:
        table: Dict[str, Dict[str, Any]] = {}
        for seg in a.get("segments") or []:
            table.setdefault(seg.get("key", "?"), seg)
        seg_by_rank[i] = table
    ordered_keys = [
        seg.get("key", "?") for seg in (present[0][1].get("segments") or [])
    ]
    shared = [
        k
        for k in ordered_keys
        if all(k in seg_by_rank[i] for i, _ in present)
    ]

    fleet_cats: Dict[str, float] = {}
    critical_path: List[Dict[str, Any]] = []
    if len(present) > 1 and shared:
        crit_wall = 0.0
        for key in shared:
            dur, owner = max(
                (seg_by_rank[i][key].get("dur_s", 0.0), i)
                for i, _ in present
            )
            seg = seg_by_rank[owner][key]
            crit_wall += dur
            top = None
            for cat, busy in (seg.get("categories") or {}).items():
                fleet_cats[cat] = round(fleet_cats.get(cat, 0.0) + busy, 6)
                if top is None or busy > seg["categories"][top]:
                    top = cat
            critical_path.append(
                {
                    "key": key,
                    "kind": seg.get("kind"),
                    "rank": owner,
                    "dur_s": round(dur, 6),
                    "top": top,
                }
            )
    else:
        slowest_attr = dict(present[0][1])
        for i, a in present:
            if i == slowest:
                slowest_attr = a
        fleet_cats = dict(slowest_attr.get("categories") or {})
        crit_wall = slowest_attr.get("wall_s", wall_max)

    binding_cat = (
        max(fleet_cats.items(), key=lambda kv: kv[1])[0]
        if fleet_cats
        else "sched_idle"
    )
    binding_ranks = sorted(
        i
        for i, a in present
        if (a.get("categories") or {})
        and max(a["categories"].items(), key=lambda kv: kv[1])[0]
        == binding_cat
    )
    busy = fleet_cats.get(binding_cat, 0.0)
    binding: Dict[str, Any] = {
        "category": binding_cat,
        "class": classify_category(binding_cat),
        "busy_s": round(busy, 6),
        "share": round(busy / crit_wall, 4) if crit_wall > 0 else None,
        "ranks": binding_ranks,
    }
    bytes_moved = _binding_bytes(binding_cat, aggregate)
    if bytes_moved and busy > 0:
        binding["gbps"] = round(bytes_moved / busy / 1e9, 4)
    # The verdict: "X-bound" is a stronger claim than "X was the largest
    # category" — it means X gated the MAJORITY of the critical path. A
    # fast local save whose pwrite is its biggest instrumented slice at
    # 20% of the wall is still pipeline-bound (the other 80% is pipeline
    # machinery); calling it storage-bound would tell the operator to
    # buy faster disks that would not help.
    share = binding.get("share") or 0.0
    cls = binding.get("class")
    if cls == "storage" and share > _BOUND_SHARE:
        verdict = "storage-bound"
    elif cls == "coordination" and share > _BOUND_SHARE:
        verdict = "coordination-bound"
    else:
        verdict = "pipeline-bound"
    return {
        "verdict": verdict,
        "reporting": len(present),
        "wall_s_max": round(wall_max, 6),
        "critical_wall_s": round(crit_wall, 6),
        "slowest_rank": slowest,
        "fastest_rank": fastest,
        "straggler_delta_s": round(wall_max - wall_min, 6),
        "categories": fleet_cats,
        "critical_path": critical_path,
        "binding": binding,
    }


def _binding_bytes(
    category: str, aggregate: Optional[Dict[str, Any]]
) -> Optional[float]:
    if not aggregate:
        return None
    return {
        "storage_write": aggregate.get("bytes_written"),
        "storage_read": aggregate.get("bytes_read"),
        "stage_copy": aggregate.get("bytes_staged"),
        "peer_transfer": aggregate.get("bytes_to_peers"),
        # The native engine moves whichever direction the op ran; saves
        # dominate in practice and a restore-bound native path reports
        # bytes_read through storage_read's row anyway.
        "native_io": aggregate.get("bytes_written") or aggregate.get("bytes_read"),
    }.get(category)


def live_binding(events: List[Dict[str, Any]]) -> Optional[str]:
    """Cheap in-flight binding hint from a recent window of bus events
    (the heartbeat's ``binding`` field): the category with the largest
    summed span time. Summed, not unioned — a 1 Hz hint does not earn
    the union sweep."""
    busy: Dict[str, float] = {}
    for ev in events:
        if ev.get("ph") != "span":
            continue
        cat = SPAN_CATEGORIES.get(ev.get("name", ""))
        if cat is not None and ev.get("dur"):
            busy[cat] = busy.get(cat, 0.0) + ev["dur"]
    if not busy:
        return None
    return max(busy.items(), key=lambda kv: kv[1])[0]


# ------------------------------------------------------------ persistence


def build_attribution_document(
    op: str,
    world_size: int,
    fleet: Optional[Dict[str, Any]],
    rates: Optional[Dict[str, Any]] = None,
    governor: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The compact ``.snapshot_critpath`` record (per-rank attributions
    stay inside the telemetry document's rank summaries)."""
    return {
        "version": 1,
        "op": op,
        "world_size": world_size,
        "fleet": fleet,
        "rates": rates,
        "governor": governor,
    }


def derive_document_from_telemetry(
    telemetry_doc: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """Re-derive an attribution document from a persisted telemetry
    summary document (rank summaries carry ``attribution`` blobs) — the
    ``explain`` fallback for snapshots that predate ``.snapshot_critpath``
    or whose rank 0 failed to persist it."""
    ranks = telemetry_doc.get("ranks") or []
    attrs = [
        (r or {}).get("attribution") if isinstance(r, dict) else None
        for r in ranks
    ]
    aggregate = (telemetry_doc.get("fleet") or {}).get("aggregate")
    fleet = merge_attributions(attrs, aggregate=aggregate)
    if fleet is None:
        return None
    rank0 = next((r for r in ranks if isinstance(r, dict)), {}) or {}
    return build_attribution_document(
        telemetry_doc.get("op") or "unknown",
        telemetry_doc.get("world_size") or len(ranks),
        fleet,
        rates=rank0.get("rates"),
        governor=rank0.get("governor"),
    )


# -------------------------------------------------------------- rendering


def _fmt_rate(gbps: Optional[float]) -> str:
    return f"{gbps:.2f} GB/s" if gbps is not None else "unmeasured"


def render_attribution(doc: Dict[str, Any], verbose: bool = False) -> str:
    """The ``explain`` CLI rendering: critical path, binding resource
    with its measured rate (cross-checked against the governor's
    measured rates recorded at decision time), straggler delta, and the
    tuning hint."""
    fleet = doc.get("fleet") or {}
    binding = fleet.get("binding") or {}
    lines: List[str] = []
    lines.append(f"op:          {doc.get('op')}")
    lines.append(f"world_size:  {doc.get('world_size')}")
    lines.append(
        f"wall:        {fleet.get('wall_s_max', 0):.3f}s (slowest rank "
        f"{fleet.get('slowest_rank')}, straggler "
        f"+{fleet.get('straggler_delta_s', 0):.3f}s over fastest)"
    )
    path = fleet.get("critical_path") or []
    if path:
        lines.append(
            f"critical path ({len(path)} segment(s), "
            f"{fleet.get('critical_wall_s', 0):.3f}s):"
        )
        for n, seg in enumerate(path, 1):
            kind = f" -> {seg['kind']}" if seg.get("kind") else ""
            lines.append(
                f"  [{n}] rank {seg.get('rank')}  "
                f"{seg.get('dur_s', 0):>8.3f}s  "
                f"top {seg.get('top') or 'none'}{kind}"
            )
    cats = fleet.get("categories") or {}
    if cats:
        lines.append("attribution (critical-path busy seconds):")
        total = sum(cats.values()) or 1.0
        for cat, busy in sorted(cats.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"  {cat:<16} {busy:>9.3f}s  ({busy / total:>5.1%})"
            )
    cat = binding.get("category")
    if cat:
        share = binding.get("share")
        lines.append(
            f"binding:     {cat} [{binding.get('class')}] — "
            f"{binding.get('busy_s', 0):.3f}s busy"
            + (f", {share:.0%} of the critical path" if share else "")
        )
        if fleet.get("verdict"):
            lines.append(f"verdict:     {fleet['verdict']}")
        if binding.get("gbps") is not None:
            lines.append(
                f"rate:        {_fmt_rate(binding.get('gbps'))} achieved "
                "over the binding window"
            )
        rates = doc.get("rates") or {}
        table = {
            "storage_write": rates.get("write_bps"),
            "storage_read": rates.get("read_bps"),
            "hash": {"hash": rates.get("hash_bps")},
        }.get(cat)
        if isinstance(table, dict) and any(
            v for v in table.values() if v is not None
        ):
            measured = ", ".join(
                f"{k or 'all'}={v / 1e9:.2f} GB/s"
                for k, v in table.items()
                if isinstance(v, (int, float))
            )
            lines.append(f"governor:    measured {measured} at decision time")
        hint = _HINTS.get(cat)
        if hint:
            ranks = binding.get("ranks") or []
            lines.append(
                "hint:        "
                + hint.format(
                    rate=_fmt_rate(binding.get("gbps")),
                    ranks=",".join(map(str, ranks)) if ranks else "all",
                    defers="some",
                )
            )
    if verbose and doc.get("governor"):
        lines.append("elections:")
        for row in doc["governor"]:
            args = ", ".join(
                f"{k}={v}" for k, v in row.items() if k != "site"
            )
            lines.append(f"  {row.get('site', '?')}: {args}")
    return "\n".join(lines)


def binding_exit_code(doc: Dict[str, Any]) -> int:
    """``explain``'s verdict as an exit code: 1 when the take was
    storage-bound (the storage class gated the majority of the critical
    path), 0 otherwise (pipeline- or coordination-bound) — so a bench
    can assert the ROADMAP claim with one subprocess call."""
    return 1 if (doc.get("fleet") or {}).get("verdict") == "storage-bound" else 0
