"""The port's checkpoint history (``telemetry/history.py``): counterparts
of ``tests/test_history.py`` case for case, on torch state. The port has
no CLI yet, so the ``stats --trend`` cases run the JAX package's CLI on
journals the port wrote and hold the port's verdicts and rendering
against it; every record loads in both packages."""

from __future__ import annotations

import json
import os
import re
import time

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.cli import main as port_cli
from torchsnapshot_tpu_torch import faultinject, telemetry
from torchsnapshot_tpu_torch.telemetry import history
from torchsnapshot_tpu_torch.telemetry.export import render_openmetrics
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _seed(root, walls, gbps=None):
    for i, w in enumerate(walls):
        rec = {"ts": time.time(), "op": "take", "snapshot": f"step_{i:010d}",
               "world_size": 2, "wall_s": w}
        if gbps is not None:
            rec["write_gbps"] = gbps[i]
        assert history.append_record(str(root), rec)


def _state(n: int = 10_000):
    return {"model": P.StateDict(w=torch.arange(n, dtype=torch.float32))}


@pytest.fixture
def bus_on():
    telemetry.set_enabled(True)
    try:
        yield
    finally:
        telemetry.set_enabled(False)
        telemetry.reset()


# ----------------------------------------------------------- journal


def test_append_is_one_line_and_reader_skips_torn_lines(tmp_path):
    _seed(tmp_path, [1.0, 1.1])
    path = history.history_path(str(tmp_path))
    with open(path, "a") as f:
        f.write('{"ts": 1, "op": "take", "wall_s": 1.2')  # torn: no newline
    records = history.load_history(str(tmp_path))
    assert [r["wall_s"] for r in records] == [1.0, 1.1]
    assert history.append_record(str(tmp_path), {"ts": 2, "op": "take", "wall_s": 1.3})
    records = history.load_history(str(tmp_path))
    assert records[0]["wall_s"] == 1.0


def test_append_refuses_missing_root(tmp_path):
    assert not history.append_record(str(tmp_path / "nope"), {"wall_s": 1})


def test_committed_take_appends_history(tmp_path):
    state = _state()
    P.Snapshot.take(str(tmp_path / "step_0000000001"), state)
    P.Snapshot.take(str(tmp_path / "step_0000000002"), state)
    records = history.load_history(str(tmp_path))
    assert [r["snapshot"] for r in records] == ["step_0000000001", "step_0000000002"]
    assert all(r["wall_s"] > 0 for r in records)
    assert all(r["op"] == "take" for r in records)


def test_aborted_take_appends_nothing(tmp_path):
    faultinject.configure("fs.write@1=permanent")
    try:
        with pytest.raises(OSError):
            P.Snapshot.take(str(tmp_path / "step_0000000001"), _state())
    finally:
        faultinject.disable()
    assert history.load_history(str(tmp_path)) == []


def test_manager_history_carries_step(tmp_path, bus_on):
    state = _state(1000)
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(0, state)
    mgr.save(1, state)
    mgr.close()
    records = history.load_history(str(tmp_path))
    assert [r.get("step") for r in records] == [0, 1]
    assert records[-1].get("bytes_written", 0) > 0


# ---------------------------------------------------------- regression


def test_detect_regression_flags_slowdown():
    records = [{"wall_s": 1.0 + 0.01 * i} for i in range(10)]
    records += [{"wall_s": 1.6} for _ in range(5)]
    v = history.detect_regression(records, threshold=0.25)
    assert v["regressed"] is True
    assert v["recent_p50"] == 1.6
    assert v["ratio"] > 1.5


def test_detect_regression_ok_within_threshold():
    records = [{"wall_s": 1.0} for _ in range(10)] + [{"wall_s": 1.1}] * 5
    assert history.detect_regression(records, threshold=0.25)["regressed"] is False


def test_detect_regression_throughput_metric_lower_is_worse():
    records = [{"write_gbps": 2.3} for _ in range(8)] + [{"write_gbps": 1.0} for _ in range(4)]
    v = history.detect_regression(records, metric="write_gbps", threshold=0.25)
    assert v["regressed"] is True


def test_detect_regression_insufficient_history_never_fails_ci():
    v = history.detect_regression([{"wall_s": 1.0}, {"wall_s": 9.0}])
    assert v["regressed"] is False
    assert v["reason"] == "insufficient history"


def test_threshold_env(monkeypatch):
    assert history.TREND_THRESHOLD_ENV_VAR == "TORCHSNAPSHOT_GPU_TREND_THRESHOLD"
    monkeypatch.setenv(history.TREND_THRESHOLD_ENV_VAR, "0.5")
    assert history.trend_threshold() == 0.5
    monkeypatch.setenv(history.TREND_THRESHOLD_ENV_VAR, "junk")
    assert history.trend_threshold() == 0.25


# ------------------------------------------- the trend gate, held against JAX


def _both_verdicts(root, threshold=None):
    from torchsnapshot_tpu.telemetry import history as jh

    mine = history.load_history(str(root))
    theirs = jh.load_history(str(root))
    assert mine == theirs
    out = []
    for metric in ("wall_s", "write_gbps"):
        v = history.detect_regression(mine, metric=metric, threshold=threshold)
        assert v == jh.detect_regression(theirs, metric=metric, threshold=threshold)
        out.append(v)
    assert history.render_trend(mine, out) == jh.render_trend(theirs, out)
    return out


def test_stats_trend_detects_injected_regression_and_exits_1(tmp_path, capsys):
    from torchsnapshot_tpu.cli import main

    _seed(tmp_path, [1.0] * 8 + [1.8] * 5, gbps=[2.3] * 8 + [1.2] * 5)
    verdicts = _both_verdicts(tmp_path)
    assert any(v["regressed"] for v in verdicts)
    assert "history: 13 committed take(s)" in history.render_trend(
        history.load_history(str(tmp_path)), verdicts)
    assert main(["stats", str(tmp_path), "--trend"]) == 1
    out = capsys.readouterr().out
    assert "REGRESSED" in out
    assert port_cli(["stats", str(tmp_path), "--trend"]) == 1
    assert capsys.readouterr().out == out


def test_stats_trend_ok_exits_0(tmp_path, capsys):
    from torchsnapshot_tpu.cli import main

    _seed(tmp_path, [1.0] * 10)
    verdicts = _both_verdicts(tmp_path)
    assert "trend[wall_s]: ok" in history.render_trend(history.load_history(str(tmp_path)),
                                                       verdicts)
    assert main(["stats", str(tmp_path), "--trend"]) == 0
    out = capsys.readouterr().out
    assert port_cli(["stats", str(tmp_path), "--trend"]) == 0
    assert capsys.readouterr().out == out


def test_stats_trend_threshold_flag(tmp_path):
    _seed(tmp_path, [1.0] * 8 + [1.2] * 4)  # +20%
    assert not _both_verdicts(tmp_path)[0]["regressed"]  # default 25%
    assert _both_verdicts(tmp_path, threshold=0.1)[0]["regressed"]


def test_stats_trend_no_history_exits_2(tmp_path, capsys):
    from torchsnapshot_tpu.cli import main

    assert history.load_history(str(tmp_path)) == []
    P.Snapshot.take(str(tmp_path / "s" / "step_0000000001"), _state(100))
    # A take's record lands in the parent of the snapshot, never inside it.
    assert history.load_history(str(tmp_path / "s" / "step_0000000001")) == []
    assert main(["stats", str(tmp_path), "--trend"]) == 2
    err = capsys.readouterr().err
    assert "no usable checkpoint history" in err
    assert port_cli(["stats", str(tmp_path), "--trend"]) == 2
    assert capsys.readouterr().err == err


# -------------------------------------------------------- openmetrics


_METRIC_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.eE+-]+$")
_META_LINE = re.compile(r"^# (TYPE|HELP|EOF)")


def test_openmetrics_format_sanity(tmp_path, bus_on):
    cur = str(tmp_path / "cur")
    P.Snapshot.take(cur, _state())
    with open(os.path.join(cur, ".snapshot_telemetry")) as f:
        out = render_openmetrics(json.loads(f.read()))
    lines = out.splitlines()
    assert lines[-1] == "# EOF"
    for line in lines:
        if line.startswith("#"):
            assert _META_LINE.match(line) or line.startswith("# HELP"), line
        else:
            assert _METRIC_LINE.match(line), line
    assert "_bytes_written counter" in out and "_bytes_written_total{" in out
    assert 'op="take"' in out and 'rank="0"' in out
    try:
        from prometheus_client.openmetrics import parser
    except ImportError:
        return
    names = {f.name for f in parser.text_string_to_metric_families(out)}
    assert any(n.endswith("_bytes_written") for n in names)


def test_openmetrics_escapes_label_values():
    from torchsnapshot_tpu_torch.telemetry.aggregate import merge_summaries

    doc = {"op": 'ta"ke\n', "world_size": 1,
           "ranks": [{"op": "take", "rank": 0, "wall_s": 1.0,
                      "counters": {"bytes_written": 10}}]}
    doc["fleet"] = merge_summaries(doc["ranks"])
    out = render_openmetrics(doc)
    assert '\\"' in out and "\\n" in out and out.endswith("# EOF\n")


def test_openmetrics_json_roundtrip_document(tmp_path, bus_on):
    cur = str(tmp_path / "cur")
    P.Snapshot.take(cur, _state(1000))
    with open(os.path.join(cur, ".snapshot_telemetry")) as f:
        doc = json.loads(f.read())
    assert render_openmetrics(doc).splitlines()[-1] == "# EOF"


# ------------------------------------------------------ across the packages


def test_records_are_byte_equal_between_the_packages(tmp_path, monkeypatch):
    """``build_record`` of the same inputs gives the same line in both
    packages (wall clock pinned), and lines of each load in the other:
    take, pagein and profile records alike."""
    from torchsnapshot_tpu.telemetry import history as jh
    from torchsnapshot_tpu.telemetry import core as jcore

    monkeypatch.setattr(time, "time", lambda: 1700000000.123456)
    fleet = {"aggregate": {"bytes_written": 4096, "bytes_read": 0, "bytes_from_seeders": 7,
                           "pages_faulted": 3, "write_gbps": 1.234567},
             "skew_s": 0.25, "slowest_rank": 1}
    summary = {"spans": {"storage_write": {"total_s": 0.5}}}
    kw = dict(op="pagein", path="/r/step_0000000004/", wall_s=2.0, world_size=4, fleet=fleet,
              rank_summary=summary, step=4)
    telemetry.reset()
    jcore.reset()
    mine, theirs = history.build_record(**kw), jh.build_record(**kw)
    assert json.dumps(mine) == json.dumps(theirs)
    profile = {"ts": 1.0, "type": "profile", "op": "take", "plugin": "FSStoragePlugin",
               "world_size": 1, "binding": "storage_write", "settings": {"sub_chunk.take": 8 << 20},
               "trials": [{"dim": "sub_chunk.take", "from": 1, "to": 2, "verdict": "kept"}],
               "score_gbps": 1.5, "takes": 3}
    root = tmp_path / "port"
    root.mkdir()
    assert history.append_record(str(root), mine) and history.append_record(str(root), profile)
    jroot = tmp_path / "jax"
    jroot.mkdir()
    assert jh.append_record(str(jroot), theirs) and jh.append_record(str(jroot), profile)
    assert (root / history.HISTORY_FNAME).read_bytes() == (jroot / jh.HISTORY_FNAME).read_bytes()
    assert jh.load_history(str(root)) == history.load_history(str(jroot)) == [mine]
    assert jh.load_profiles(str(root)) == history.load_profiles(str(jroot)) == [profile]
    assert history.render_profiles([profile]) == jh.render_profiles([profile])
