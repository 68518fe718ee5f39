"""Configurations, traffic mixes, limits and metric readers are found by
the names BENCHMARK.json gives, and every cell reports what the contract
asks of it."""

import os

import pytest

from portbench import harness

CELLS = ("gpt2m.ckpt", "gptj6b.train", "gpt2m.train")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(bench, name):
    cell = harness.resolve(bench, name)
    assert cell["config"]["name"] == cell["config_name"]
    for part in ("make_params", "named_leaves", "model_flops_per_step", "follow"):
        assert callable(getattr(cell["reference"], part))
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    # A traffic file holds what users' traffic varies, and nothing else.
    assert set(cell["traffic"]) == {"batch", "seq_len", "take_every_steps", "resumes",
                                    "trace_steps", "reference_rows"}
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_unknown_workload_is_refused(bench):
    with pytest.raises(KeyError):
        harness.resolve(bench, "no.such.cell")


def test_a_new_metric_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "steps_done.train.py").write_text(
        "def read(run):\n    return run['window']['steps']\n")
    monkeypatch.setattr(harness, "PKG_DIR", str(tmp_path))
    assert harness.metric_reader("steps_done.train")({"window": {"steps": 7}}) == 7


def test_benchmark_json_is_consistent(bench):
    cells = {w["name"] for w in bench["workloads"]}
    assert cells == set(CELLS)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(harness.PKG_DIR, "traffic", w["traffic"] + ".json"))
        assert w["chips"] == 1
