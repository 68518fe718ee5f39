"""The port's telemetry core against the JAX package's.

The tests of ``tests/test_telemetry.py`` on the port's bus (spans and
their parenting, the disabled mode's shared no-op, histograms, op
recorders, the Chrome trace, the fleet merge, a take's persisted summary
and trace, a restore's fleet view, the manager's annotations, and a
telemetry-on take across 2 processes), without the JAX tests of modules
the port does not have yet (the ``stats`` CLI, the retry strategy). Then
cross-package checks: the event registries are equal, the same
histogram observations bucket alike, and a snapshot carrying
``.snapshot_telemetry`` taken by either package restores in the other
and its summary document renders in both.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, telemetry
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture(autouse=True)
def _clean_bus():
    """Each test starts with an empty, disabled bus and leaves it so
    (refresh re-resolves the cached event cap after monkeypatched env)."""
    telemetry.refresh_from_env()
    telemetry.set_enabled(False)
    telemetry.reset()
    yield
    telemetry.refresh_from_env()
    telemetry.set_enabled(False)
    telemetry.reset()


# ------------------------------------------------------------------- spans


def test_span_nesting_and_parenting():
    telemetry.set_enabled(True)
    with telemetry.span("outer"):
        with telemetry.span("mid"):
            with telemetry.span("inner"):
                pass
        with telemetry.span("sibling"):
            pass
    events = {e["name"]: e for e in telemetry.events() if e["ph"] == "span"}
    assert set(events) == {"outer", "mid", "inner", "sibling"}
    assert events["outer"]["parent"] is None
    assert events["mid"]["parent"] == events["outer"]["id"]
    assert events["inner"]["parent"] == events["mid"]["id"]
    assert events["sibling"]["parent"] == events["outer"]["id"]
    # Temporal containment: child windows sit inside the parent's.
    for child, parent in (("mid", "outer"), ("inner", "mid"), ("sibling", "outer")):
        c, p = events[child], events[parent]
        assert c["ts"] >= p["ts"]
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-9


def test_span_parenting_isolated_across_interleaved_tasks():
    """Two coroutines interleaving spans on ONE event-loop thread must not
    corrupt each other's parent stacks (contextvars isolation)."""
    telemetry.set_enabled(True)

    async def worker(name):
        with telemetry.span(f"root_{name}"):
            await asyncio.sleep(0.01)
            with telemetry.span(f"child_{name}"):
                await asyncio.sleep(0.01)

    async def main():
        await asyncio.gather(worker("a"), worker("b"))

    asyncio.run(main())
    events = {e["name"]: e for e in telemetry.events() if e["ph"] == "span"}
    assert events["child_a"]["parent"] == events["root_a"]["id"]
    assert events["child_b"]["parent"] == events["root_b"]["id"]
    assert events["root_a"]["parent"] is None
    assert events["root_b"]["parent"] is None


def test_span_set_args():
    telemetry.set_enabled(True)
    with telemetry.span("s", bytes=1) as sp:
        sp.set(bytes=42, extra="x")
    (ev,) = [e for e in telemetry.events() if e["ph"] == "span"]
    assert ev["args"] == {"bytes": 42, "extra": "x"}


# ----------------------------------------------------------- disabled mode


def test_disabled_mode_is_noop():
    assert not telemetry.enabled()
    # Hot path returns THE shared singleton: no per-call allocation
    # beyond the flag check.
    s1 = telemetry.span("a", bytes=123)
    s2 = telemetry.span("b")
    assert s1 is s2
    with s1:
        pass
    telemetry.event("x", k=1)
    telemetry.counter_add("c", 5)
    telemetry.gauge_set("g", 7)
    telemetry.histogram_observe("write.entry_s", 0.1)
    assert telemetry.events() == []
    assert telemetry.counters() == {}
    assert telemetry.gauges() == {}
    assert telemetry.histograms() == {}
    # An op bracketing a fully-disabled window summarizes to None.
    rec = telemetry.begin_op("take", rank=0)
    assert rec.finish() is None


def test_disabled_rates_still_feed_governor():
    """Adaptive tuning keeps working with telemetry off: the measured
    rates reach the governor with the bus off, and the bus records
    nothing. (The JAX package routes them through the bus's rate
    listeners; the port feeds the governor directly.)"""
    from torchsnapshot_tpu_torch.scheduler import _feed_governor_rates, io_governor

    _feed_governor_rates("write", "LintTestPlugin", 10_000_000, 0.01)
    assert io_governor().write_bps("LintTestPlugin") == pytest.approx(1e9)
    assert telemetry.events() == []  # but nothing was recorded


# -------------------------------------------------------------- histograms


def test_histogram_log2_bucketing():
    """Observations land in the smallest power-of-two upper bound >=
    the value; sub-1µs values collapse into bucket 0 and huge values
    into the +Inf overflow slot."""
    from torchsnapshot_tpu_torch.telemetry.core import HISTOGRAM_BOUNDS

    telemetry.set_enabled(True)
    telemetry.histogram_observe("write.entry_s", 0.0)        # floor
    telemetry.histogram_observe("write.entry_s", 1e-9)       # floor
    telemetry.histogram_observe("write.entry_s", 0.05)       # le=0.0625
    telemetry.histogram_observe("write.entry_s", 0.0625)     # le=0.0625 (==)
    telemetry.histogram_observe("write.entry_s", 0.07)       # le=0.125
    telemetry.histogram_observe("write.entry_s", 1e9)        # +Inf overflow
    hist = telemetry.histograms()["write.entry_s"][""]
    counts = hist["counts"]
    assert hist["count"] == 6
    assert counts[0] == 2
    assert counts[HISTOGRAM_BOUNDS.index(0.0625)] == 2
    assert counts[HISTOGRAM_BOUNDS.index(0.125)] == 1
    assert counts[len(HISTOGRAM_BOUNDS)] == 1  # the overflow slot
    assert hist["sum"] == pytest.approx(0.0625 + 0.05 + 0.07 + 1e9)


def test_histogram_keys_are_separate_series():
    telemetry.set_enabled(True)
    telemetry.histogram_observe("storage.op_s", 0.01, key="S3.put")
    telemetry.histogram_observe("storage.op_s", 0.02, key="S3.get_range")
    by_key = telemetry.histograms()["storage.op_s"]
    assert set(by_key) == {"S3.put", "S3.get_range"}
    assert by_key["S3.put"]["count"] == 1


def test_histogram_quantile_approximation():
    telemetry.set_enabled(True)
    for _ in range(9):
        telemetry.histogram_observe("write.entry_s", 0.01)
    telemetry.histogram_observe("write.entry_s", 1.5)
    hist = telemetry.histograms()["write.entry_s"][""]
    # p50 lands in 0.01's bucket (le=0.015625); p99 in the tail's.
    assert telemetry.histogram_quantile(hist, 0.5) == pytest.approx(0.015625)
    assert telemetry.histogram_quantile(hist, 0.99) == pytest.approx(2.0)
    assert telemetry.histogram_quantile({"count": 0, "counts": []}, 0.5) is None


def test_op_recorder_histogram_deltas():
    """A summary reports only the histograms observed DURING the op —
    the previous op's tail must not leak in — while the process-level
    view keeps accumulating."""
    telemetry.set_enabled(True)
    telemetry.histogram_observe("write.entry_s", 0.01, key="FS")
    rec = telemetry.begin_op("take", rank=0)
    telemetry.histogram_observe("write.entry_s", 0.02, key="FS")
    telemetry.histogram_observe("read.entry_s", 0.03, key="FS")
    summary = rec.finish()
    hist = summary["histograms"]
    assert hist["write.entry_s"]["FS"]["count"] == 1  # not 2
    assert hist["read.entry_s"]["FS"]["count"] == 1
    assert telemetry.histograms()["write.entry_s"]["FS"]["count"] == 2
    # An op with no observations elides the key entirely.
    rec = telemetry.begin_op("take", rank=0)
    assert "histograms" not in rec.finish()


def test_histogram_thread_safety_no_lost_updates():
    import threading

    telemetry.set_enabled(True)
    n, threads = 2000, 8

    def pound():
        for i in range(n):
            telemetry.histogram_observe(
                "collective.wait_s", 1e-6 * (i % 7 + 1), key="barrier"
            )

    ts = [threading.Thread(target=pound) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    hist = telemetry.histograms()["collective.wait_s"]["barrier"]
    assert hist["count"] == n * threads
    assert sum(hist["counts"]) == n * threads


# ------------------------------------------------------------ counters/ops


def test_counters_and_op_recorder_deltas():
    telemetry.set_enabled(True)
    telemetry.counter_add("bytes_written", 100)
    rec = telemetry.begin_op("take", rank=3)
    telemetry.counter_add("bytes_written", 50)
    telemetry.counter_add("retry_attempts", 2)
    with telemetry.span("stage"):
        pass
    summary = rec.finish(extra={"phases": {"plan": 0.1}})
    # Deltas, not absolutes: the 100 pre-op bytes are excluded.
    assert summary["counters"] == {"bytes_written": 50, "retry_attempts": 2}
    assert summary["rank"] == 3
    assert summary["op"] == "take"
    assert summary["spans"]["stage"]["count"] == 1
    assert summary["phases"] == {"plan": 0.1}
    assert telemetry.last_summary() is summary


def test_event_buffer_trimmed_between_ops(monkeypatch):
    """A long-lived process saving every N steps must never fill the
    event cap and go dark: each begin_op trims events no live recorder
    can still export."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_TELEMETRY_MAX_EVENTS", "10")
    telemetry.refresh_from_env()  # the cap is cached, not read per append
    telemetry.set_enabled(True)
    for op_i in range(5):
        rec = telemetry.begin_op("take", rank=0)
        for _ in range(8):
            with telemetry.span("stage"):
                pass
        summary = rec.finish()
        # Every op keeps full span coverage — op 5 as much as op 1.
        assert summary["spans"]["stage"]["count"] == 8, f"op {op_i} went dark"
        assert summary["dropped_events"] == 0


def test_per_op_trace_counters_rebased():
    """Take #2's exported counter track must read 0 -> bytes-this-op,
    not carry take #1's cumulative total."""
    telemetry.set_enabled(True)
    rec1 = telemetry.begin_op("take")
    telemetry.counter_add("bytes_written", 1000)
    rec1.finish()
    rec2 = telemetry.begin_op("take")
    telemetry.counter_add("bytes_written", 500)
    rec2.finish()
    vals = [
        e["value"]
        for e in rec2.events()
        if e["ph"] == "counter" and e["name"] == "bytes_written"
    ]
    assert vals == [500]


def test_per_op_gauges_and_dropped_are_op_scoped(monkeypatch):
    telemetry.set_enabled(True)
    rec1 = telemetry.begin_op("take")
    telemetry.gauge_set("write_inflight_io", 9)
    s1 = rec1.finish()
    assert s1["gauges"] == {"write_inflight_io": 9}
    # A later restore sets no gauges: it must not inherit the take's.
    rec2 = telemetry.begin_op("restore")
    s2 = rec2.finish()
    assert s2["gauges"] == {}
    assert s2["dropped_events"] == 0


def test_finished_op_exports_survive_next_ops_trim():
    """Async commits export AFTER finish(): a new op beginning in that
    window trims the live buffer, so the export must be served from the
    finished recorder's own capture."""
    telemetry.set_enabled(True)
    rec1 = telemetry.begin_op("take")
    with telemetry.span("stage"):
        pass
    summary = rec1.finish()
    telemetry.begin_op("take")  # trims everything rec1 referenced
    evs = rec1.events()
    assert [e["name"] for e in evs if e["ph"] == "span"] == ["stage"]
    assert summary["spans"]["stage"]["count"] == 1


def test_annotate_next_op_lands_in_summary():
    telemetry.set_enabled(True)
    telemetry.annotate_next_op(step=1000, mode="async")
    rec = telemetry.begin_op("take")
    summary = rec.finish()
    assert summary["annotations"] == {"step": 1000, "mode": "async"}
    # Consumed: the following op carries none.
    assert telemetry.begin_op("take").finish().get("annotations") is None


def test_manager_save_annotates_take_summary(tmp_path):
    from torchsnapshot_tpu_torch import CheckpointManager

    telemetry.set_enabled(True)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), save_interval_steps=1)
    mgr.save(0, {"app": StateDict(w=torch.ones(256))})
    summary = telemetry.last_summary()
    assert summary["annotations"]["step"] == 0
    assert summary["annotations"]["mode"] == "sync"


# ------------------------------------------------------------ chrome trace


def test_chrome_trace_valid_and_consistent():
    telemetry.set_enabled(True)
    with telemetry.span("outer"):
        with telemetry.span("inner"):
            pass
    telemetry.counter_add("bytes_written", 10)
    telemetry.event("phase:commit", cat="phase")
    blob = telemetry.chrome_trace_json(pid=7)
    doc = json.loads(blob)  # valid JSON
    events = doc["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(xs) == {"outer", "inner"}
    for e in events:
        if "ts" in e:
            assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
            assert e["pid"] == 7
    # Monotonic consistency: the child's [ts, ts+dur] window sits inside
    # the parent's in exported (µs) time too.
    assert xs["inner"]["ts"] >= xs["outer"]["ts"]
    assert (
        xs["inner"]["ts"] + xs["inner"]["dur"]
        <= xs["outer"]["ts"] + xs["outer"]["dur"]
    )
    assert any(e["ph"] == "C" and e["name"] == "bytes_written" for e in events)
    assert any(e["ph"] == "i" and e["name"] == "phase:commit" for e in events)


def test_chrome_trace_file_roundtrip(tmp_path):
    telemetry.set_enabled(True)
    with telemetry.span("s"):
        pass
    path = str(tmp_path / "trace.json")
    telemetry.write_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    assert any(e.get("name") == "s" for e in doc["traceEvents"])


# ----------------------------------------------------------- fleet merge


def _mk_summary(rank, wall_s, written=0, read=0, deduped=0, retries=0):
    counters = {}
    if written:
        counters["bytes_written"] = written
    if read:
        counters["bytes_read"] = read
    if deduped:
        counters["bytes_deduped"] = deduped
    if retries:
        counters["retry_attempts"] = retries
    return {
        "op": "take",
        "rank": rank,
        "wall_s": wall_s,
        "spans": {},
        "counters": counters,
    }


def test_merge_with_skewed_slow_rank():
    summaries = [
        _mk_summary(0, 1.0, written=100),
        _mk_summary(1, 9.0, written=300, retries=4),  # the straggler
        _mk_summary(2, 1.5, written=200, deduped=50),
    ]
    fleet = telemetry.merge_summaries(summaries)
    assert fleet["slowest_rank"] == 1
    assert fleet["fastest_rank"] == 0
    assert fleet["wall_s_max"] == 9.0
    assert fleet["skew_s"] == pytest.approx(8.0)
    agg = fleet["aggregate"]
    # Aggregate write bytes are exactly the per-rank sum.
    assert agg["bytes_written"] == 600
    assert agg["bytes_deduped"] == 50
    assert agg["retry_attempts"] == 4
    # Fleet bandwidth is bytes over the CRITICAL PATH (slowest rank).
    assert agg["write_gbps"] == pytest.approx(600 / 9.0 / 1e9, rel=1e-3)


def test_merge_handles_disabled_ranks_and_all_none():
    fleet = telemetry.merge_summaries([None, _mk_summary(1, 2.0, written=10), None])
    assert fleet["reporting"] == 1
    assert fleet["world_size"] == 3
    assert fleet["slowest_rank"] == 1
    assert telemetry.merge_summaries([None, None]) is None


# ------------------------------------------------- end-to-end single rank


def test_take_persists_summary_and_trace(tmp_path):
    telemetry.set_enabled(True)
    w = torch.arange(32768, dtype=torch.float32)
    nbytes = w.numel() * w.element_size()
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": StateDict(w=w, step=7)})
    doc = json.loads((tmp_path / "snap" / ".snapshot_telemetry").read_text())
    assert doc["op"] == "take"
    assert doc["world_size"] == 1
    summary = doc["ranks"][0]
    assert summary["counters"]["bytes_written"] == nbytes
    assert doc["fleet"]["aggregate"]["bytes_written"] == nbytes
    assert "phases" in summary and "commit" in summary["phases"]
    trace = json.loads(
        (tmp_path / "snap" / ".telemetry" / "rank_0.trace.json").read_text()
    )
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "stage" in names and "storage_write" in names
    # Programmatic scraping surface.
    assert telemetry.last_summary()["op"] == "take"
    assert telemetry.last_fleet()["aggregate"]["bytes_written"] == nbytes


def test_restore_merges_fleet_without_writing(tmp_path):
    path = str(tmp_path / "snap")
    w = torch.arange(4096, dtype=torch.float32)
    Snapshot.take(path, {"app": StateDict(w=w)})  # telemetry off: no residue
    assert not (tmp_path / "snap" / ".snapshot_telemetry").exists()
    telemetry.set_enabled(True)
    dst = StateDict(w=torch.zeros_like(w))
    before = set(os.listdir(path))
    Snapshot(path).restore({"app": dst})
    assert torch.equal(dst["w"], w)
    assert set(os.listdir(path)) == before  # restores never write
    fleet = telemetry.last_fleet()
    assert fleet["op"] == "restore"
    assert fleet["aggregate"]["bytes_read"] == w.numel() * w.element_size()


def test_disabled_take_leaves_zero_residue(tmp_path):
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": StateDict(w=torch.ones(64))})
    assert sorted(os.listdir(path)) == [".snapshot_metadata", "0"]


def _telemetry_take_worker(rank: int, world_size: int, snap_path: str):
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict, telemetry

    telemetry.set_enabled(True)
    app_state = {
        "local": StateDict(data=torch.full((4096,), float(rank))),  # 16 KiB each
        "model": StateDict(w=torch.arange(8192, dtype=torch.float32)),  # 32 KiB, striped
    }
    Snapshot.take(snap_path, app_state, replicated=["model/*"])
    summary = telemetry.last_summary()
    return {"bytes_written": summary["counters"].get("bytes_written", 0),
            "fleet": telemetry.last_fleet()}


@pytest.mark.multiprocess
def test_distributed_take_fleet_view_and_artifacts(tmp_path):
    """A telemetry-on take in 2 processes: a Chrome trace per rank that
    parses, a persisted summary, and a fleet view whose aggregate write
    bytes are the sum of the ranks' bytes, the same on every rank."""
    snap_path = str(tmp_path / "snap")
    results = run_with_subprocesses(_telemetry_take_worker, 2, snap_path)
    total = sum(results[r]["bytes_written"] for r in results)
    assert total > 0
    for r in results:
        fleet = results[r]["fleet"]
        assert fleet["world_size"] == 2 and fleet["reporting"] == 2
        assert fleet["aggregate"]["bytes_written"] == total
        assert fleet["slowest_rank"] in (0, 1) and fleet["skew_s"] >= 0
    doc = json.loads((tmp_path / "snap" / ".snapshot_telemetry").read_text())
    assert doc["world_size"] == 2
    assert doc["fleet"]["aggregate"]["bytes_written"] == total
    assert [s["rank"] for s in doc["ranks"]] == [0, 1]
    for rank in (0, 1):
        trace = json.loads(
            (tmp_path / "snap" / ".telemetry" / f"rank_{rank}.trace.json").read_text())
        assert trace["traceEvents"], f"rank {rank} trace is empty"
        assert all(e["ts"] >= 0 for e in trace["traceEvents"] if "ts" in e)
    assert "slowest rank" in telemetry.render_summary_document(doc)


# --------------------------------------------------------- cross-package


def test_event_registries_equal_the_jax_packages():
    from torchsnapshot_tpu.telemetry import taxonomy as jax_taxonomy

    assert telemetry.taxonomy.EVENTS == jax_taxonomy.EVENTS
    assert telemetry.taxonomy.FLIGHT_EVENTS == jax_taxonomy.FLIGHT_EVENTS


def test_histograms_bucket_as_in_jax():
    from torchsnapshot_tpu import telemetry as jax_telemetry

    values = [0.0, 1e-9, 3e-7, 0.05, 0.0625, 0.07, 1.5, 200.0, 1e9]
    assert telemetry.HISTOGRAM_BOUNDS == jax_telemetry.HISTOGRAM_BOUNDS
    jax_was = jax_telemetry.enabled()
    jax_telemetry.set_enabled(True)
    telemetry.set_enabled(True)
    try:
        jax_telemetry.reset()
        for v in values:
            telemetry.histogram_observe("write.entry_s", v, key="FS")
            jax_telemetry.histogram_observe("write.entry_s", v, key="FS")
        got = telemetry.histograms()["write.entry_s"]["FS"]
        want = jax_telemetry.histograms()["write.entry_s"]["FS"]
        assert got == want
        for q in (0.1, 0.5, 0.9, 0.99):
            assert telemetry.histogram_quantile(got, q) == jax_telemetry.histogram_quantile(want, q)
    finally:
        jax_telemetry.reset()
        jax_telemetry.set_enabled(jax_was)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_snapshot_with_telemetry_restores_in_both_packages(tmp_path, writer):
    """A take with the bus on (``.snapshot_telemetry`` and the per-rank
    traces in the snapshot) by either package restores bit-exact in both,
    and both render its summary document."""
    import torchsnapshot_tpu as J
    from torchsnapshot_tpu import telemetry as jax_telemetry

    w = np.arange(8192, dtype=np.float32) * 0.5
    path = str(tmp_path / "snap")
    if writer == "jax":
        jax_was = jax_telemetry.enabled()
        jax_telemetry.set_enabled(True)
        try:
            J.Snapshot.take(path, {"app": J.StateDict(w=w, step=3)})
        finally:
            jax_telemetry.set_enabled(jax_was)
    else:
        telemetry.set_enabled(True)
        Snapshot.take(path, {"app": StateDict(w=torch.from_numpy(w.copy()), step=3)})
        telemetry.set_enabled(False)
    doc = json.loads((tmp_path / "snap" / ".snapshot_telemetry").read_text())
    assert doc["fleet"]["aggregate"]["bytes_written"] == w.nbytes
    assert telemetry.render_summary_document(doc) == jax_telemetry.render_summary_document(doc)
    dst = StateDict(w=torch.zeros(8192), step=0)
    Snapshot(path).restore({"app": dst})
    assert np.array_equal(dst["w"].numpy(), w) and dst["step"] == 3
    jdst = J.StateDict(w=np.zeros(8192, np.float32), step=0)
    J.Snapshot(path).restore({"app": jdst})
    assert np.array_equal(np.asarray(jdst["w"]), w) and jdst["step"] == 3


def test_disabled_spans_are_the_shared_no_op(tmp_path):
    """With the bus off (the default), every span is one shared no-op
    object, as in the JAX package, and a take records nothing on it."""
    from torchsnapshot_tpu.telemetry import core as jax_core
    from torchsnapshot_tpu_torch.telemetry import core

    assert not telemetry.enabled()
    assert telemetry.span("stage", bytes=1) is telemetry.span("consume") is core._NULL_SPAN
    assert type(core._NULL_SPAN).__name__ == type(jax_core._NULL_SPAN).__name__
    Snapshot.take(str(tmp_path / "s"), {"app": StateDict(w=torch.ones(4096))})
    assert telemetry.events() == [] and telemetry.counters() == {}
    assert telemetry.histograms() == {}


def test_async_take_persists_its_summary_from_the_commit_thread(tmp_path):
    """An async take finishes its telemetry on the commit thread, after the
    commit: the snapshot gets its summary document and trace, with the
    drain and commit phases, and the take's bytes."""
    telemetry.set_enabled(True)
    w = torch.arange(16384, dtype=torch.float32)
    path = str(tmp_path / "snap")
    Snapshot.async_take(path, {"app": StateDict(w=w)}).wait()
    doc = json.loads((tmp_path / "snap" / ".snapshot_telemetry").read_text())
    summary = doc["ranks"][0]
    assert summary["counters"]["bytes_written"] == w.numel() * w.element_size()
    assert {"stage", "io_drain", "commit"} <= set(summary["phases"])
    assert (tmp_path / "snap" / ".telemetry" / "rank_0.trace.json").is_file()
