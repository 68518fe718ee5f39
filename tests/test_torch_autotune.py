"""The port's closed-loop autotuner and governor against the JAX package's.

- ``TORCHSNAPSHOT_GPU_AUTOTUNE`` parses as ``TORCHSNAPSHOT_TPU_AUTOTUNE``
  does, ``auto`` when unset.
- The same verdict sequences drive both packages' ``AutoTuner`` to the same
  trials, decisions, settings and profile records.
- Both governors resolve every election site with the same precedence
  (env, then a learned profile or the armed trial, then the measured-rate
  heuristic) to the same value and source, and record one
  ``governor.elect`` flight event per change.
- A ``type="profile"`` record learned by either package's governor loads in
  the other's and decides its next election.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import autotune as jax_autotune
from torchsnapshot_tpu import scheduler as jax_scheduler
from torchsnapshot_tpu import telemetry as jax_telemetry
from torchsnapshot_tpu.telemetry import flightrec as jax_flightrec
from torchsnapshot_tpu.telemetry import history as jax_history
from torchsnapshot_tpu_torch import autotune, scheduler, telemetry
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import flightrec, history

MB = 1 << 20
_KNOBS = ("AUTOTUNE", "SUB_CHUNK_BYTES", "SUB_CHUNK_MIN_BYTES", "SUB_CHUNK_MAX_BYTES",
          "IO_CONCURRENCY", "PREVERIFY")


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """Both packages' election knobs unset; ``env.set(suffix, value)``
    sets one under both prefixes."""
    for suffix in _KNOBS:
        monkeypatch.delenv(f"TORCHSNAPSHOT_TPU_{suffix}", raising=False)
        monkeypatch.delenv(f"TORCHSNAPSHOT_GPU_{suffix}", raising=False)

    def both(suffix: str, value: str) -> None:
        monkeypatch.setenv(f"TORCHSNAPSHOT_TPU_{suffix}", value)
        monkeypatch.setenv(f"TORCHSNAPSHOT_GPU_{suffix}", value)

    monkeypatch.set = both
    scheduler.reset_io_governor()
    yield monkeypatch
    for tel in (telemetry, jax_telemetry):
        tel.set_enabled(False)
        tel.reset()
    scheduler.reset_io_governor()
    jax_scheduler.reset_io_governor()


@pytest.mark.parametrize("value", [None, "", "auto", "AUTO", "pin", "pinned", "freeze", "frozen",
                                   "fresh", "reset", "relearn", "never", "0", "off", "no",
                                   "false", "bogus"])
def test_the_mode_parses_as_in_jax(env, value) -> None:
    if value is not None:
        env.set("AUTOTUNE", value)
    assert autotune.autotune_mode() == jax_autotune.autotune_mode()
    assert scheduler.autotune_mode() == jax_scheduler.autotune_mode()
    if value is None:
        assert autotune.autotune_mode() == "auto"


_DIMS = {"io_concurrency.write": {"value": 16, "kind": "geom", "lo": 1, "hi": 32, "quantum": 1},
         "sub_chunk.write": {"value": 64 * MB, "kind": "geom", "lo": 8 * MB, "hi": 256 * MB,
                             "quantum": MB},
         "native.write": {"value": True, "kind": "toggle"}}


def _drive(tuner, seq):
    """Apply one verdict sequence; returns every return value."""
    out = []
    for kind, args in seq:
        if kind == "arm":
            out.append(tuner.maybe_arm(*args))
        elif kind == "observe":
            out.append(tuner.observe(*args[:4], learn=args[4], arm=args[5]))
        elif kind == "abort":
            out.append(tuner.abort_trial(*args))
        elif kind == "world":
            out.append(tuner.note_world(args))
        out.append(tuner.active_trial())
        out.append(tuner.resolve("io_concurrency.write", "fs", "write"))
        out.append(tuner.resolve("sub_chunk.write", "fs", "write"))
    return out


def _sequence(seed: int):
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(60):
        r = rng.random()
        if r < 0.4:
            dims = {k: dict(v) for k, v in _DIMS.items() if rng.random() < 0.8}
            seq.append(("arm", ("write", "fs", dims)))
        elif r < 0.9:
            binding = ["storage_write", "storage_write", "stage_copy"][rng.integers(3)]
            seq.append(("observe", ("write", "fs", binding, float(rng.uniform(0.5, 3.0)),
                                    bool(rng.random() < 0.9), bool(rng.random() < 0.8))))
        elif r < 0.95:
            seq.append(("abort", ("write", "fs")))
        else:
            seq.append(("world", int(rng.integers(1, 4))))
    return seq


def _no_ts(record):
    return None if record is None else {k: v for k, v in record.items() if k != "ts"}


@pytest.mark.parametrize("seed", range(6))
def test_the_same_verdicts_give_the_same_decisions_and_profiles(seed) -> None:
    mine, theirs = autotune.AutoTuner(), jax_autotune.AutoTuner()
    seq = _sequence(seed)
    assert _drive(mine, seq) == _drive(theirs, seq)
    assert mine.profiles() == theirs.profiles()
    for key in mine.profiles():
        assert _no_ts(mine.profile_record(key)) == _no_ts(theirs.profile_record(key))
    records = [mine.profile_record(k) for k in mine.profiles()]
    loaded_mine, loaded_theirs = autotune.AutoTuner(), jax_autotune.AutoTuner()
    assert loaded_mine.load(records) == loaded_theirs.load(records) == len(records)
    assert loaded_mine.profiles() == loaded_theirs.profiles()


def test_an_election_record_has_the_jax_packages_fields() -> None:
    args = ("sub_chunk", "sub_chunk.write", "fs", 8 * MB, "trial")
    kw = {"profile": "fs|w1|storage_write", "inputs": {"bps": 3}}
    assert autotune.Election(*args, **kw).as_fields() == jax_autotune.Election(
        *args, **kw).as_fields()
    assert autotune.profile_key("fs", 2, "decode") == jax_autotune.profile_key("fs", 2, "decode")


def _profile(settings, binding="storage_write", op="write"):
    return [{"type": "profile", "plugin": "fs", "world_size": 1, "binding": binding,
             "settings": settings, "score_gbps": 1.0, "takes": 5, "op": op}]


def _elect_all(gov):
    return [
        gov.sub_chunk_bytes("fs", op="write"), gov.sub_chunk_bytes("fs", op="read"),
        gov.io_concurrency("write", "fs"), gov.io_concurrency("read", "fs"),
        gov.should_preverify("fs"), gov.should_native_io("fs", op="write"),
        gov.should_native_io("fs", op="read"), gov.should_coop_restore("fs"),
        gov.should_planned_reshard("fs"), gov.should_seed_restore("fs"),
    ]


def _sources(gov):
    return {k: (e.value, e.source) for k, e in gov._elections.items()}


_CASES = {
    "cold": ({}, None, {}),
    "rates": ({}, None, {"write": 2e9, "read": 5e7, "hash": 1e9, "native_write": 1e9}),
    "profile": ({}, {"sub_chunk.write": 16 * MB, "io_concurrency.write": 64,
                     "native.write": False}, {"write": 2e9}),
    "read profile": ({}, {"io_concurrency.read": 5, "preverify": False, "coop_restore": True,
                          "sub_chunk.read": MB}, {"read": 5e7}),
    "env pins": ({"SUB_CHUNK_BYTES": "12345", "IO_CONCURRENCY": "64", "PREVERIFY": "never"},
                 {"sub_chunk.write": 16 * MB, "io_concurrency.write": 3}, {"write": 1e8}),
    "never": ({"AUTOTUNE": "never"}, {"sub_chunk.write": 16 * MB}, {"write": 2e9}),
    "bounds": ({"SUB_CHUNK_MIN_BYTES": str(MB), "SUB_CHUNK_MAX_BYTES": str(4 * MB)},
               {"sub_chunk.write": 64 * MB}, {"read": 3e8}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_both_governors_elect_the_same_value_from_the_same_source(env, case) -> None:
    knobs, settings, rates = _CASES[case]
    for suffix, value in knobs.items():
        env.set(suffix, value)
    govs = (scheduler.IOGovernor(), jax_scheduler.IOGovernor())
    for gov in govs:
        if settings is not None:
            binding = "storage_read" if any(k.endswith("read") or "." not in k
                                            for k in settings) else "storage_write"
            op = "read" if binding == "storage_read" else "write"
            assert gov._tuner.load(_profile(settings, binding, op)) == 1
        if "write" in rates:
            gov.record_write("fs", int(rates["write"]), 1.0)
        if "native_write" in rates:
            gov.record_write("fs.native", int(rates["native_write"]), 1.0)
        if "read" in rates:
            gov.record_read("fs", int(rates["read"]), 1.0)
        if "hash" in rates:
            gov.record_hash(int(rates["hash"]), 1.0)
    assert _elect_all(govs[0]) == _elect_all(govs[1])
    assert _sources(govs[0]) == _sources(govs[1])


def _elect_events(ring, seen):
    return [e[3] for e in ring() if e[0] > seen and e[2] == "governor.elect"]


def test_the_flight_ring_shows_one_election_per_change(env) -> None:
    """The sites re-elect inside the dispatch loops; a flight event is
    recorded only when a decision's value or source changes, as in JAX."""
    calls = [("io_concurrency", ("write", "fs"), "io_concurrency.write"),
             ("sub_chunk_bytes", ("fs",), "sub_chunk.write"),
             ("should_preverify", ("fs",), "preverify")]
    got = []
    for gov, fr in ((scheduler.IOGovernor(), flightrec),
                    (jax_scheduler.IOGovernor(), jax_flightrec)):
        seen = fr.recorded_total()
        expected, last = [], {}

        def elect(n: int) -> None:
            for _ in range(n):
                for name, args, dim in calls:
                    getattr(gov, name)(*args)
                    e = gov._elections[(dim, "fs")]
                    if last.get(dim) != (e.value, e.source):
                        last[dim] = (e.value, e.source)
                        expected.append((dim, e.value, e.source))

        elect(5)
        gov.record_write("fs", int(5e7), 1.0)  # latency-bound storage
        elect(3)
        gov._tuner.load(_profile({"io_concurrency.write": 7, "sub_chunk.write": 9 * MB}))
        elect(2)
        events = _elect_events(fr.snapshot_ring, seen)
        assert [(e["dim"], e["value"], e["source"]) for e in events] == expected
        got.append(events)
    mine, theirs = got
    assert mine == theirs
    assert ("io_concurrency.write", 7, "profile") in [(e["dim"], e["value"], e["source"])
                                                       for e in mine]
    assert mine[-1]["profile"] == "fs|w1|storage_write"
    assert len(mine) < 3 * (5 + 3 + 2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_profile_learned_by_either_package_loads_in_the_other(env, tmp_path, writer) -> None:
    """One governor scores a baseline, arms a trial and keeps it; the
    record it appends to the history journal is byte-compatible, and the
    other package's fresh governor elects the learned value from it."""
    learner = scheduler.IOGovernor() if writer == "port" else jax_scheduler.IOGovernor()
    reader = jax_scheduler.IOGovernor() if writer == "port" else scheduler.IOGovernor()
    root = str(tmp_path)
    verdict = {"binding": {"category": "storage_write", "gbps": 1.0}}
    learner.observe_verdict("take", "fs", 1, verdict, root=root, rank=0)
    learner.begin_io_op("write", "fs")
    trial = learner._tuner.active_trial()
    assert trial is not None and trial["dim"] == "io_concurrency.write"
    better = {"binding": {"category": "storage_write", "gbps": 2.0}}
    learner.observe_verdict("take", "fs", 1, better, root=root, rank=0)
    learned = learner._tuner.profiles()["fs|w1|storage_write"]["settings"]
    assert learned == {"io_concurrency.write": trial["value"]}
    mine, theirs = history.load_profiles(root), jax_history.load_profiles(root)
    assert mine == theirs and len(mine) == 2
    assert set(mine[-1]) == {"type", "ts", "plugin", "world_size", "binding", "settings",
                             "score_gbps", "takes", "trials", "op"}
    assert reader.load_profiles(root) == 2
    assert reader.io_concurrency("write", "fs") == trial["value"]
    assert _sources(reader)[("io_concurrency.write", "fs")] == (trial["value"], "profile")


def test_never_leaves_the_tuner_untouched_and_unattributed_ops_are_skipped(env) -> None:
    env.set("AUTOTUNE", "never")
    gov = scheduler.IOGovernor()
    gov.observe_verdict("take", "fs", 1, {"binding": {"category": "storage_write", "gbps": 1}})
    gov.begin_io_op("write", "fs")
    assert gov.profiles() == {} and gov.load_profiles("/nonexistent") == 0
    env.set("AUTOTUNE", "auto")
    telemetry.set_enabled(True)
    gov.observe_verdict("take", "fs", 1, attribution=None)
    gov.observe_verdict("take", "fs", 1, attribution={"binding": {"category": "storage_write"}})
    assert telemetry.counters().get("profile_skips") == 2 and gov.profiles() == {}


def test_only_storage_bound_verdicts_unlock_a_trial_and_pin_never_learns(env) -> None:
    gov = scheduler.IOGovernor()
    gov.observe_verdict("take", "fs", 1, {"binding": {"category": "stage_copy", "gbps": 1.0}})
    assert gov._tuner._states["fs|w1|stage_copy"].fresh is False
    gov.observe_verdict("take", "fs", 1, {"binding": {"category": "storage_write", "gbps": 1.0}},
                        aggregate={"write_gbps": 2.5})
    state = gov._tuner._states["fs|w1|storage_write"]
    assert state.fresh is True and state.score == pytest.approx(2.5)
    env.set("AUTOTUNE", "pin")
    gov.begin_io_op("write", "fs")
    assert gov._tuner.active_trial() is None
    gov.observe_verdict("take", "fs", 1, {"binding": {"category": "storage_write", "gbps": 9.0}})
    assert state.takes == 1


def test_begin_io_op_publishes_the_profile_key_to_the_heartbeat(env) -> None:
    from torchsnapshot_tpu_torch.telemetry import health

    gov = scheduler.IOGovernor()
    gov.begin_io_op("write", "fs")
    assert health.current_state()["profile"] == "-"
    gov.observe_verdict("take", "fs", 1, {"binding": {"category": "storage_write", "gbps": 1.0}})
    gov.begin_io_op("write", "fs")
    state = health.current_state()
    assert state["profile"] == "fs|w1|storage_write"
    assert state["trial"] == gov._tuner.active_trial()["dim"]


def _throttle(monkeypatch, seconds: float) -> None:
    write = FSStoragePlugin.write

    async def slow(self, write_io):
        if not write_io.path.split("/", 1)[0].startswith("."):
            await asyncio.sleep(seconds)
        return await write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", slow)


def test_manager_saves_learn_a_profile_that_a_fresh_process_warm_starts_from(env, tmp_path):
    """Storage-bound manager saves (payload writes held 0.15 s, bus on)
    score, arm and keep a trial; the journal's profile warm-starts a
    fresh governor at the manager's constructor, and the JAX package's
    governor elects the same from the port's journal."""
    env.set("IO_CONCURRENCY", "")
    _throttle(env, 0.15)
    env.setenv("TORCHSNAPSHOT_GPU_TELEMETRY", "1")
    telemetry.refresh_from_env()
    state = {f"w{i}": torch.full((1024,), float(i)) for i in range(24)}
    # A first take in a process is slow for reasons of its own; the
    # journal's first profile record names the binding a fresh process
    # starts from, as in the JAX package, so the saves below run warm.
    P.Snapshot.take(str(tmp_path / "warm" / "s"), {"m": P.StateDict(state)})
    gov = scheduler.reset_io_governor()
    mgr = P.CheckpointManager(str(tmp_path / "mgr"))
    for step in range(3):
        state["w0"].add_(1)
        mgr.save(step, {"m": P.StateDict(state)}, force=True)
        trials = [k for k, e in gov._elections.items() if e.source == "trial"]
        assert len(trials) <= 1
    dst = {k: torch.zeros(1024) for k in state}
    assert mgr.restore({"m": P.StateDict(dst)}) == 2
    assert all(torch.equal(dst[k], state[k]) for k in state)
    learned = gov.profiles()["FSStoragePlugin|w1|storage_write"]["settings"]
    assert learned.get("io_concurrency.write") == 32
    fresh = scheduler.reset_io_governor()
    P.CheckpointManager(str(tmp_path / "mgr"))
    assert fresh.io_concurrency("write", "FSStoragePlugin") == 32
    assert _sources(fresh)[("io_concurrency.write", "FSStoragePlugin")] == (32, "profile")
    theirs = jax_scheduler.IOGovernor()
    assert theirs.load_profiles(str(tmp_path / "mgr")) >= 1
    assert theirs.io_concurrency("write", "FSStoragePlugin") == 32
    with open(tmp_path / "mgr" / history.HISTORY_FNAME) as f:
        lines = [json.loads(line) for line in f if '"profile"' in line]
    assert lines and all(rec["plugin"] == "FSStoragePlugin" for rec in lines)
