"""The port's telemetry exports against the JAX package's.

The tests of ``tests/test_export.py`` on the port's ``telemetry/export.py``
(the Chrome trace of an empty bus, of an abandoned recorder, of nested
interleaved tasks, counter events, the summary document's rendering, the
OpenMetrics helpers), then the same inputs through both packages: the
rendered summary document and the OpenMetrics text are equal, and the
Chrome trace of the same recorded events has the same events.
"""


import asyncio
import json

import pytest

from torchsnapshot_tpu_torch import telemetry
from torchsnapshot_tpu_torch.telemetry import export
from torchsnapshot_tpu_torch.telemetry.core import HISTOGRAM_BOUNDS
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture(autouse=True)
def _clean_bus():
    telemetry.set_enabled(False)
    telemetry.reset()
    yield
    telemetry.set_enabled(False)
    telemetry.reset()


# ------------------------------------------------------------ chrome trace


def test_chrome_trace_empty_bus():
    """An empty bus must still export a loadable trace (metadata lane
    only) — the disabled-telemetry / brand-new-process case."""
    trace = export.chrome_trace([])
    assert trace["traceEvents"][0]["ph"] == "M"
    assert json.loads(export.chrome_trace_json([]))


def test_chrome_trace_abandoned_recorder_mid_span():
    """A recorder abandoned while a span is still OPEN (the abort path:
    the exception unwound through the span's body) must export whatever
    completed without the torn span, and the next op's begin must trim
    the abandoned events instead of letting them pin the buffer."""
    telemetry.set_enabled(True)
    recorder = telemetry.begin_op("take", rank=0)
    with telemetry.span("completed"):
        pass
    torn = telemetry.span("never-exits")
    torn.__enter__()  # deliberately not exited yet: abort unwound past it
    try:
        events = recorder.events()
        recorder.abandon()
        names = [e["name"] for e in events if e.get("ph") == "span"]
        assert names == ["completed"]  # the torn span never appended
        trace = export.chrome_trace(events, pid=7)
        spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        assert [s["name"] for s in spans] == ["completed"]
        assert all(s["ts"] >= 0 and s["dur"] >= 0 for s in spans)
        # The next op starts clean: the abandoned recorder no longer
        # pins the abandoned events in the live buffer.
        nxt = telemetry.begin_op("take", rank=0)
        assert nxt.events() == []
        nxt.abandon()
    finally:
        # Unwind the torn span so this test's context stack (a
        # contextvar shared with later tests on this thread) is clean.
        torn.__exit__(None, None, None)


def test_chrome_trace_nested_interleaved_tasks():
    """Spans opened by interleaved asyncio tasks export with their own
    parent chains — task A's child must never parent onto task B's open
    span even though they interleave on one thread."""
    telemetry.set_enabled(True)

    async def worker(tag):
        with telemetry.span(f"outer-{tag}"):
            await asyncio.sleep(0.01)
            with telemetry.span(f"inner-{tag}"):
                await asyncio.sleep(0.01)

    async def main():
        await asyncio.gather(worker("a"), worker("b"))

    asyncio.run(main())
    events = {e["name"]: e for e in telemetry.events() if e["ph"] == "span"}
    trace = export.chrome_trace(list(events.values()))
    by_name = {
        e["name"]: e for e in trace["traceEvents"] if e.get("ph") == "X"
    }
    for tag in ("a", "b"):
        assert (
            by_name[f"inner-{tag}"]["args"]["parent"]
            == events[f"outer-{tag}"]["id"]
        )
    # Monotonic, rebased timestamps.
    assert all(e["ts"] >= 0 for e in trace["traceEvents"] if "ts" in e)


def test_chrome_trace_counter_events():
    telemetry.set_enabled(True)
    telemetry.counter_add("bytes_written", 10)
    telemetry.counter_add("bytes_written", 5)
    trace = export.chrome_trace()
    tracks = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert [t["args"]["bytes_written"] for t in tracks] == [10, 15]


# --------------------------------------------------------------- summaries


def test_render_summary_document_minimal():
    """Documents from foreign/older producers may omit nearly
    everything; rendering must not crash on missing fields."""
    out = export.render_summary_document({"op": "take"})
    assert "op:          take" in out
    out = export.render_summary_document(
        {"op": "take", "world_size": 1, "ranks": [None], "fleet": None}
    )
    assert "world_size" in out


def test_render_summary_document_histograms():
    doc = {
        "op": "take",
        "world_size": 1,
        "ranks": [],
        "fleet": {
            "wall_s_max": 1.0,
            "slowest_rank": 0,
            "skew_s": 0.0,
            "aggregate": {},
            "histograms": {
                "write.entry_s": {
                    "FSStoragePlugin": {
                        "counts": [0] * 14 + [3] + [0] * 14,
                        "count": 3,
                        "sum": 0.03,
                    }
                }
            },
        },
    }
    out = export.render_summary_document(doc)
    assert "latency histograms" in out
    assert "write.entry_s[FSStoragePlugin]: n=3" in out


def test_fmt_bytes():
    assert export.fmt_bytes(None) == "?"
    assert export.fmt_bytes(0) == "0B"
    assert export.fmt_bytes(1536) == "1.5KiB"
    assert export.fmt_bytes(3 * 1024**4) == "3.0TiB"


# ------------------------------------------------------------- openmetrics


def test_om_family_name_sanitizes():
    assert (
        export.om_family_name("write.sub_chunk_s")
        == "torchsnapshot_tpu_write_sub_chunk_s"
    )
    assert "-" not in export.om_family_name("a-b c.d")


def test_om_histogram_lines_cumulative_and_inf():
    hist = {"": {"counts": [1, 2] + [0] * 27, "count": 3, "sum": 0.5}}
    lines = export.om_histogram_lines("collective.wait_s", hist)
    assert lines[0] == "# TYPE torchsnapshot_tpu_collective_wait_s histogram"
    buckets = [ln for ln in lines if "_bucket" in ln]
    # Cumulative over the fixed ladder + the +Inf slot == count.
    assert len(buckets) == len(HISTOGRAM_BOUNDS) + 1
    assert buckets[0].endswith(" 1")
    assert buckets[1].endswith(" 3")
    assert buckets[-1] == (
        'torchsnapshot_tpu_collective_wait_s_bucket{le="+Inf"} 3'
    )
    assert any(
        ln == "torchsnapshot_tpu_collective_wait_s_count 3" for ln in lines
    )


def test_render_openmetrics_includes_fleet_histograms():
    doc = {
        "op": "take",
        "world_size": 1,
        "ranks": [
            {
                "op": "take",
                "rank": 0,
                "wall_s": 1.0,
                "counters": {"bytes_written": 10},
                "histograms": {
                    "write.entry_s": {
                        "FS": {"counts": [5] + [0] * 28, "count": 5,
                               "sum": 0.001}
                    }
                },
            }
        ],
    }
    from torchsnapshot_tpu_torch.telemetry.aggregate import merge_summaries

    doc["fleet"] = merge_summaries(doc["ranks"])
    out = export.render_openmetrics(doc)
    assert "torchsnapshot_tpu_write_entry_s_bucket" in out
    assert out.endswith("# EOF\n")
    try:
        from prometheus_client.openmetrics import parser
    except ImportError:
        return
    families = {
        f.name: f for f in parser.text_string_to_metric_families(out)
    }
    assert families["torchsnapshot_tpu_write_entry_s"].type == "histogram"


# --------------------------------------------------------- cross-package


def _doc():
    hist = [0] * (len(HISTOGRAM_BOUNDS) + 1)
    hist[3], hist[10], hist[-1] = 4, 2, 1
    summary = {"op": "take", "rank": 0, "wall_s": 1.25, "spans": {"stage": {
        "count": 3, "total_s": 0.5, "max_s": 0.25}}, "counters": {"bytes_written": 1 << 20,
        "bytes_deduped": 4096}, "gauges": {}, "dropped_events": 0, "phases": {"plan": 0.1,
        "commit": 0.2}, "histograms": {"write.entry_s": {"FS": {"counts": hist, "count": 7,
        "sum": 3.5}}}}
    from torchsnapshot_tpu_torch.telemetry.aggregate import merge_summaries

    fleet = merge_summaries([summary, dict(summary, rank=1, wall_s=2.5)])
    return export.build_summary_document("take", 2, [summary, dict(summary, rank=1)], fleet)


def test_summary_document_and_openmetrics_render_as_in_jax():
    from torchsnapshot_tpu.telemetry import export as jax_export

    doc = _doc()
    jax_doc = jax_export.build_summary_document("take", 2, doc["ranks"], doc["fleet"])
    assert json.loads(json.dumps(doc)) == json.loads(json.dumps(jax_doc))
    assert export.render_summary_document(doc) == jax_export.render_summary_document(doc)
    assert export.fmt_bytes(123456789) == jax_export.fmt_bytes(123456789)
    assert export.TELEMETRY_SUMMARY_FNAME == jax_export.TELEMETRY_SUMMARY_FNAME
    assert export.trace_path_for_rank(3) == jax_export.trace_path_for_rank(3)


def test_chrome_trace_of_the_same_events_matches_jax():
    from torchsnapshot_tpu import telemetry as jax_telemetry

    jax_was = jax_telemetry.enabled()
    for t in (telemetry, jax_telemetry):
        t.set_enabled(True)
        t.reset()
    try:
        for t in (telemetry, jax_telemetry):
            with t.span("outer", bytes=8):
                with t.span("inner"):
                    pass
            t.counter_add("bytes_written", 10)
            t.event("phase:commit", cat="phase")
        port = json.loads(telemetry.chrome_trace_json(pid=2))["traceEvents"]
        jax = json.loads(jax_telemetry.chrome_trace_json(pid=2))["traceEvents"]

        def shape(evs, bus):
            # Event ids count from each bus's own start: a parent is
            # compared by its span's name.
            names = {e["id"]: e["name"] for e in bus.events() if e["ph"] == "span"}
            out = []
            for e in evs:
                if e["ph"] == "M":
                    continue
                args = dict(e.get("args") or {})
                if "parent" in args:
                    args["parent"] = names[args["parent"]]
                out.append((e["ph"], e.get("name"), e.get("cat"), e.get("pid"),
                            json.dumps(args, sort_keys=True)))
            return sorted(out)

        assert shape(port, telemetry) == shape(jax, jax_telemetry)
        assert ("X", "inner", "pipeline", 2, '{"parent": "outer"}') in shape(port, telemetry)
    finally:
        jax_telemetry.reset()
        jax_telemetry.set_enabled(jax_was)
