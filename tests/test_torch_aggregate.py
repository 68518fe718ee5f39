"""The port's cross-rank merge against the JAX package's.

The tests of ``tests/test_aggregate.py`` on the port's
``telemetry/aggregate.py``, then the same summaries through both
packages' ``merge_summaries`` and ``merge_histograms``: equal results.
"""


from __future__ import annotations

import pytest

from torchsnapshot_tpu_torch.telemetry.aggregate import merge_summaries


def _summary(rank, wall_s, counters=None):
    return {
        "op": "take",
        "rank": rank,
        "wall_s": wall_s,
        "counters": counters or {},
    }


def test_single_rank_fleet():
    fleet = merge_summaries([_summary(0, 1.5, {"bytes_written": 1000})])
    assert fleet["world_size"] == 1
    assert fleet["reporting"] == 1
    assert fleet["slowest_rank"] == 0
    assert fleet["fastest_rank"] == 0
    assert fleet["skew_s"] == 0.0
    assert fleet["aggregate"]["bytes_written"] == 1000
    # Fleet bandwidth over the critical path (the one rank's wall).
    assert abs(fleet["aggregate"]["write_gbps"] - 1000 / 1.5 / 1e9) < 1e-12


def test_none_contributions_are_counted_not_crashed():
    """A rank with telemetry disabled contributes None: the merge must
    report world_size from the GATHER length and how many ranks actually
    reported — never divide by the missing rank or misattribute its
    slot."""
    fleet = merge_summaries(
        [None, _summary(1, 2.0, {"bytes_written": 500}), None]
    )
    assert fleet["world_size"] == 3
    assert fleet["reporting"] == 1
    # Rank identity comes from the gather SLOT, not the reporting order.
    assert fleet["slowest_rank"] == 1
    assert fleet["aggregate"]["bytes_written"] == 500


def test_all_none_returns_none():
    assert merge_summaries([None, None]) is None
    assert merge_summaries([]) is None


def test_skewed_walls_name_slowest_and_fastest():
    """Rank walls are per-rank monotonic intervals (never cross-rank
    clock comparisons): a heavily skewed fleet reports the skew and the
    offenders by rank index."""
    fleet = merge_summaries(
        [
            _summary(0, 1.0, {"bytes_written": 100}),
            _summary(1, 61.0, {"bytes_written": 100}),
            _summary(2, 2.0, {"bytes_written": 100}),
        ]
    )
    assert fleet["slowest_rank"] == 1
    assert fleet["fastest_rank"] == 0
    assert fleet["skew_s"] == 60.0
    assert fleet["wall_s_max"] == 61.0
    # Fleet bandwidth is everyone's bytes over the SLOWEST wall — the
    # time the training loop actually paid.
    assert abs(fleet["aggregate"]["write_gbps"] - 300 / 61.0 / 1e9) < 1e-15


def test_degradation_counters_sum_across_ranks():
    """store_failovers / lease_renewals / fanout_fallbacks /
    mirror_failovers aggregate like byte counters (the PR 6 counters the
    persisted summary used to drop)."""
    fleet = merge_summaries(
        [
            _summary(0, 1.0, {"store_failovers": 1, "fanout_fallbacks": 2}),
            _summary(1, 1.1, {"store_failovers": 1, "mirror_failovers": 3,
                              "lease_renewals": 40}),
        ]
    )
    agg = fleet["aggregate"]
    assert agg["store_failovers"] == 2
    assert agg["fanout_fallbacks"] == 2
    assert agg["mirror_failovers"] == 3
    assert agg["lease_renewals"] == 40


def test_zero_valued_counters_are_elided():
    fleet = merge_summaries(
        [_summary(0, 1.0, {"bytes_written": 0, "retry_attempts": 0})]
    )
    assert fleet["aggregate"] == {}


def test_missing_wall_defaults_to_zero_not_crash():
    fleet = merge_summaries([{"op": "take", "rank": 0, "counters": {}}])
    assert fleet["wall_s_max"] == 0.0
    assert fleet["skew_s"] == 0.0


def test_render_includes_failover_lines():
    """The stats rendering surfaces non-zero degradation counters."""
    from torchsnapshot_tpu_torch.telemetry.export import render_summary_document

    doc = {
        "op": "take",
        "world_size": 2,
        "ranks": [
            _summary(0, 1.0, {"store_failovers": 1}),
            _summary(1, 1.2, {"store_failovers": 1, "fanout_fallbacks": 2}),
        ],
    }
    doc["fleet"] = merge_summaries(doc["ranks"])
    text = render_summary_document(doc)
    assert "failovers:" in text
    assert "store=2" in text
    assert "fanout=2" in text


# ------------------------------------------------------------- histograms


def _hist(counts, total=None, s=0.0):
    return {"counts": counts, "count": total if total is not None
            else sum(counts), "sum": s}


def test_merge_histograms_bucketwise_sum():
    from torchsnapshot_tpu_torch.telemetry.aggregate import merge_histograms

    a = _summary(0, 1.0)
    a["histograms"] = {
        "write.entry_s": {"FS": _hist([1, 0, 2], s=0.5)},
        "collective.wait_s": {"barrier": _hist([1], s=0.1)},
    }
    b = _summary(1, 1.0)
    b["histograms"] = {"write.entry_s": {"FS": _hist([0, 3, 1], s=0.25)}}
    merged = merge_histograms([a, b, None])
    fs = merged["write.entry_s"]["FS"]
    assert fs["counts"] == [1, 3, 3]
    assert fs["count"] == 7
    assert fs["sum"] == 0.75
    # A family only one rank contributed survives untouched.
    assert merged["collective.wait_s"]["barrier"]["counts"] == [1]


def test_merge_histograms_pads_short_counts():
    from torchsnapshot_tpu_torch.telemetry.aggregate import merge_histograms

    a = _summary(0, 1.0)
    a["histograms"] = {"write.entry_s": {"": _hist([1])}}
    b = _summary(1, 1.0)
    b["histograms"] = {"write.entry_s": {"": _hist([0, 0, 5])}}
    merged = merge_histograms([a, b])
    assert merged["write.entry_s"][""]["counts"] == [1, 0, 5]


def test_fleet_view_carries_histograms():
    a = _summary(0, 1.0, {"bytes_written": 10})
    a["histograms"] = {"write.entry_s": {"FS": _hist([2])}}
    fleet = merge_summaries([a, _summary(1, 2.0)])
    assert fleet["histograms"]["write.entry_s"]["FS"]["count"] == 2
    # No histograms anywhere -> the key is absent, not an empty dict.
    fleet = merge_summaries([_summary(0, 1.0)])
    assert "histograms" not in fleet


# --------------------------------------------------------- cross-package


@pytest.mark.parametrize("walls", [(1.0,), (1.0, 9.0, 1.5), (0.0, 0.0), (3.0, None, 2.0)])
def test_merges_equal_the_jax_packages(walls):
    from torchsnapshot_tpu.telemetry import aggregate as jax_aggregate
    from torchsnapshot_tpu_torch.telemetry.aggregate import merge_histograms

    summaries = []
    for r, w in enumerate(walls):
        if w is None:
            summaries.append(None)
            continue
        hist = [r, 1, 0, 2 * r]
        summaries.append({"op": "take", "rank": r, "wall_s": w, "spans": {},
                          "counters": {"bytes_written": 100 * (r + 1), "retry_attempts": r,
                                       "store_failovers": r % 2},
                          "histograms": {"write.entry_s": {"FS": {"counts": hist,
                                                                  "count": sum(hist),
                                                                  "sum": 0.5 * r}}}})
    assert merge_summaries(summaries) == jax_aggregate.merge_summaries(summaries)
    hists = [s["histograms"] for s in summaries if s]
    assert merge_histograms(hists) == jax_aggregate.merge_histograms(hists)
