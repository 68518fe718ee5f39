"""The port's flight recorder against the JAX package's.

The tests of ``tests/test_flightrec.py`` on the port (the bounded ring,
its switch, the abort dump next to a snapshot, the spool directory, the
cross-rank merge and its clock alignment, torn lines, the 2-process
desertion drill and the SIGTERM dump), without the JAX tests of its CLI
and lint scripts, which the port does not have yet (in their place: every
flight event the port's sources record is registered). Then the
interchange: a ``.flight/`` dump written by either package is loaded and
merged by the other, with the same findings.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject
from torchsnapshot_tpu_torch.telemetry import flightrec
from torchsnapshot_tpu_torch.telemetry.taxonomy import FLIGHT_EVENTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_ring():
    flightrec.set_enabled(True)
    flightrec.reset()
    yield
    flightrec.set_enabled(True)
    flightrec.reset()


# ------------------------------------------------------------------ ring


def test_ring_is_bounded_and_ordered(monkeypatch):
    monkeypatch.setenv(flightrec.RING_ENV_VAR, "32")
    flightrec.refresh_from_env()
    try:
        for i in range(100):
            flightrec.record("progress", op="take", done=i)
        ring = flightrec.snapshot_ring()
        assert len(ring) == 32
        seqs = [r[0] for r in ring]
        assert seqs == sorted(seqs)
        assert seqs[-1] == 100  # newest survives; oldest dropped
        assert flightrec.recorded_total() == 100
    finally:
        monkeypatch.delenv(flightrec.RING_ENV_VAR)
        flightrec.refresh_from_env()
    assert flightrec.ring_size() == 4096


def test_disabled_records_nothing():
    flightrec.set_enabled(False)
    flightrec.record("phase", name="stage", op="take")
    assert flightrec.snapshot_ring() == []
    assert flightrec.dump(None, 0, "disabled") is None


def test_enabled_by_default_env_gate(monkeypatch):
    monkeypatch.setenv(flightrec.FLIGHTREC_ENV_VAR, "")
    assert flightrec.refresh_from_env() is True  # always-on default
    monkeypatch.setenv(flightrec.FLIGHTREC_ENV_VAR, "0")
    assert flightrec.refresh_from_env() is False
    monkeypatch.setenv(flightrec.FLIGHTREC_ENV_VAR, "1")
    assert flightrec.refresh_from_env() is True


# ----------------------------------------------------------------- dumps


def test_abort_dump_written_next_to_snapshot(tmp_path):
    """A faulted take leaves a parseable dump with the op's lifecycle,
    the fault trip and the abort; a dump inside a committed snapshot does
    not disturb its restore."""
    state = {"model": StateDict(w=torch.arange(50_000, dtype=torch.float32))}
    cur = str(tmp_path / "cur")
    faultinject.configure("fs.write@1=permanent")
    try:
        with pytest.raises(OSError):
            Snapshot.take(cur, state)
    finally:
        faultinject.disable()
    dump_file = os.path.join(cur, ".flight", "rank_0.jsonl")
    assert os.path.isfile(dump_file)
    events = [json.loads(line) for line in open(dump_file)]
    names = [e["ev"] for e in events]
    assert names[0] == "flight.dump"
    assert "op.begin" in names and "fault.trip" in names and "op.abort" in names
    assert all(e["ev"] in FLIGHT_EVENTS for e in events)
    good = str(tmp_path / "good")
    Snapshot.take(good, state)
    flightrec.dump(good, 0, "manual")
    dst = {"model": StateDict(w=torch.zeros(50_000))}
    Snapshot(good).restore(dst)
    assert torch.equal(dst["model"]["w"], state["model"]["w"])


def test_dump_skips_remote_paths_without_spool(monkeypatch):
    monkeypatch.delenv(flightrec.DUMP_DIR_ENV_VAR, raising=False)
    flightrec.record("phase", name="x", op="take")
    assert flightrec.dump("s3://bucket/snap", 0, "abort") is None


def test_dump_spool_dir_env(tmp_path, monkeypatch):
    monkeypatch.setenv(flightrec.DUMP_DIR_ENV_VAR, str(tmp_path))
    flightrec.record("phase", name="x", op="take")
    out = flightrec.dump("s3://bucket/snap", 3, "abort")
    assert out == str(tmp_path / ".flight" / "rank_3.jsonl")
    assert os.path.isfile(out)


# ------------------------------------------------------- merge machinery


def _mk_dump(tmp_path, rank, records):
    d = tmp_path / ".flight"
    d.mkdir(exist_ok=True)
    with open(d / f"rank_{rank}.jsonl", "w") as f:
        f.write(json.dumps({"seq": 0, "t": 0.0, "ev": "flight.dump",
                            "rank": rank, "reason": "test"}) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")


_NS = "pgw/ns/1-abc"
_DESERTION = {
    0: [
        {"seq": 1, "t": 1000.0, "ev": "collective.enter", "kind": "barrier", "ns": _NS, "cseq": 1},
        {"seq": 2, "t": 1000.1, "ev": "collective.exit", "kind": "barrier", "ns": _NS, "cseq": 1,
         "ok": True},
        {"seq": 3, "t": 1005.0, "ev": "collective.enter", "kind": "barrier", "ns": _NS, "cseq": 2},
        {"seq": 4, "t": 1012.0, "ev": "collective.exit", "kind": "barrier", "ns": _NS, "cseq": 2,
         "ok": False, "error": "TimeoutError('8s')"},
        {"seq": 5, "t": 1012.1, "ev": "op.abort", "op": "take",
         "error": "RuntimeError('peer died')"},
    ],
    1: [
        {"seq": 1, "t": 50.0, "ev": "collective.enter", "kind": "barrier", "ns": _NS, "cseq": 1},
        {"seq": 2, "t": 50.1, "ev": "collective.exit", "kind": "barrier", "ns": _NS, "cseq": 1,
         "ok": True},
        # rank 1 never reaches barrier #2: it is the deserter
        {"seq": 3, "t": 50.2, "ev": "op.abort", "op": "take",
         "error": "InjectedTransientError('boom')"},
    ],
}


def test_merge_aligns_clocks_on_shared_collective(tmp_path):
    """Rank clocks with different epochs align on the shared (ns, cseq)
    anchor; the deserter is named from the causal keys."""
    for rank, records in _DESERTION.items():
        _mk_dump(tmp_path, rank, records)
    merged = flightrec.merge_timeline(flightrec.load_dumps(str(tmp_path)))
    assert merged["aligned"] is True
    desertions = [f for f in merged["findings"] if f["class"] in
                  ("desertion", "collective-error")]
    assert desertions, merged["findings"]
    d = desertions[0]
    assert d["cseq"] == 2 and d["never_arrived"] == [1] and d["errored"] == [0]
    text = flightrec.render_timeline(merged)
    assert "DESERTION" in text
    assert "rank(s) 1 never arrived" in text
    assert "InjectedTransientError" in text


def test_merge_tolerates_torn_lines_and_single_rank(tmp_path):
    d = tmp_path / ".flight"
    d.mkdir()
    with open(d / "rank_0.jsonl", "w") as f:
        f.write(json.dumps({"seq": 1, "t": 1.0, "ev": "op.begin", "op": "take"}) + "\n")
        f.write('{"seq": 2, "t": 1.5, "ev": "pha')  # torn mid-write
    merged = flightrec.merge_timeline(flightrec.load_dumps(str(tmp_path)))
    assert merged["ranks"] == [0]
    assert len(merged["events"]) == 1


# ------------------------------------------------- w2 desertion drill


def _desertion_worker(rank: int, world_size: int, root: str):
    import numpy as np
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch import faultinject as fi
    from torchsnapshot_tpu_torch.telemetry import flightrec as fr

    fr.set_enabled(True)
    fr.reset()
    rng = np.random.default_rng(1000 * rank)
    state = {"model": StateDict(w=torch.from_numpy(rng.standard_normal(8_000).astype(np.float32)))}
    if rank == 0:
        # The delay parks rank 0's write past the manifest gather; the
        # transient fires in its drain, deserting rank 1 at the commit
        # barrier (bounded by the wrapper's error channel).
        fi.configure("fs.write@2=delay:0.3;fs.write@2=transient")
    err = None
    try:
        Snapshot.take(os.path.join(root, "cur"), state)
    except BaseException as e:  # noqa: B036
        err = repr(e)
    finally:
        fi.disable()
    return {"err": err}


@pytest.mark.multiprocess
def test_w2_desertion_drill_dumps_and_blackbox_names_the_deserter(tmp_path):
    """The commit-barrier desertion at w2 ends with both ranks' dumps on
    disk, and the merged timeline names the failing rank, the desertion,
    the commit generation and the fault's site."""
    from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses

    results = run_with_subprocesses(_desertion_worker, 2, str(tmp_path), timeout=180.0)
    for rank, out in results.items():
        assert out["err"] is not None, rank
    cur = str(tmp_path / "cur")
    for rank in (0, 1):
        assert os.path.isfile(os.path.join(cur, ".flight", f"rank_{rank}.jsonl")), rank
    merged = flightrec.merge_timeline(flightrec.load_dumps(cur))
    text = flightrec.render_timeline(merged, verbose=True)
    aborts = [f for f in merged["findings"] if f["class"] == "abort"]
    assert any(f["rank"] == 0 and "InjectedTransientError" in str(f["error"])
               for f in aborts), aborts
    assert "DESERTION" in text or any(
        f["class"] in ("desertion", "collective-error") for f in merged["findings"]), text
    assert "gen=" in text
    assert "fs.write" in text


# ----------------------------------------------------------- preemption


def test_sigterm_records_event_and_optionally_dumps(tmp_path, monkeypatch):
    """The watcher records ``preempt.signal`` from the handler and, with
    TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM=1, spools the ring to the
    FLIGHTREC_DIR on the next call."""
    from torchsnapshot_tpu_torch.preemption import PreemptionWatcher, simulate_preemption_now

    monkeypatch.setenv("TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM", "1")
    monkeypatch.setenv(flightrec.DUMP_DIR_ENV_VAR, str(tmp_path))
    watcher = PreemptionWatcher()
    try:
        simulate_preemption_now()
        assert watcher.preempted
        assert "preempt.signal" in [r[2] for r in flightrec.snapshot_ring()]
        assert watcher.should_save() is True  # triggers the deferred dump
        dumped = tmp_path / ".flight" / "rank_0.jsonl"
        recs = [json.loads(line) for line in open(dumped)]
        assert recs[0]["reason"] == "sigterm"
        assert any(r["ev"] == "preempt.signal" for r in recs)
    finally:
        watcher.close()


# ------------------------------------------------------------- taxonomy


def test_every_recorded_flight_event_is_registered():
    """Each literal name the port's sources pass to ``flightrec.record``
    is in ``FLIGHT_EVENTS`` (the JAX package's taxonomy lint, reduced to
    the names)."""
    pattern = re.compile(r"flightrec\.record\(\s*\"([^\"]+)\"")
    found = set()
    for root, _, names in os.walk(os.path.join(REPO, "torchsnapshot_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(root, n)) as f:
                    found.update(pattern.findall(f.read()))
    assert {"op.begin", "op.abort", "phase", "fence.plant", "commit.decision",
            "collective.enter", "collective.exit", "fault.trip", "progress",
            "preempt.signal", "store.epoch"} <= found
    assert sorted(found - set(FLIGHT_EVENTS)) == []


# --------------------------------------------------------- interchange


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dumps_interchange_between_the_packages(tmp_path, writer):
    """Dumps written by either package's ``dump`` (a desertion across two
    ranks) load and merge in both, with the same findings and the same
    rendered timeline."""
    from torchsnapshot_tpu.telemetry import flightrec as jax_fr

    fr = jax_fr if writer == "jax" else flightrec
    was = fr.enabled()
    fr.set_enabled(True)
    try:
        for rank, records in _DESERTION.items():
            fr.reset()
            for rec in records:
                fields = {k: v for k, v in rec.items() if k not in ("seq", "t", "ev")}
                fr.record(rec["ev"], **fields)
            assert fr.dump(str(tmp_path), rank, "interchange") is not None
    finally:
        fr.reset()
        fr.set_enabled(was)
    port_merged = flightrec.merge_timeline(flightrec.load_dumps(str(tmp_path)))
    jax_merged = jax_fr.merge_timeline(jax_fr.load_dumps(str(tmp_path)))
    assert port_merged["ranks"] == jax_merged["ranks"] == [0, 1]
    assert port_merged["findings"] == jax_merged["findings"]
    assert any(f["class"] == "abort" for f in port_merged["findings"])
    assert flightrec.render_timeline(port_merged) == jax_fr.render_timeline(jax_merged)


def test_a_port_abort_dump_merges_in_the_jax_package(tmp_path):
    """A real port take aborted by a fault: the JAX package's blackbox
    merge reads its dump and names the abort and the fault trip."""
    from torchsnapshot_tpu.telemetry import flightrec as jax_fr

    cur = str(tmp_path / "cur")
    faultinject.configure("fs.write@1=permanent")
    try:
        with pytest.raises(OSError):
            Snapshot.take(cur, {"m": StateDict(w=torch.ones(1024))})
    finally:
        faultinject.disable()
    merged = jax_fr.merge_timeline(jax_fr.load_dumps(cur))
    assert merged["ranks"] == [0]
    assert any(f["class"] == "abort" and "InjectedPermanentError" in str(f["error"])
               for f in merged["findings"]), merged["findings"]
    assert "fs.write" in jax_fr.render_timeline(merged, verbose=True)
