"""The port's critical-path attribution against the JAX package's.

The same synthetic span events go through both packages'
``build_attribution``, ``merge_attributions``, ``live_binding`` and the
document builders, which must agree field for field. Every span name the
port emits is one that the taxonomy maps, fuses or leaves out on purpose.
A port take's ``.snapshot_critpath`` is read by the JAX package's
``explain`` command in-process, with the exit class the port's verdict
gives, and the history record carries the same binding.
"""

from __future__ import annotations

import asyncio
import json
import os
import re

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.cli import main as jax_cli
from torchsnapshot_tpu_torch.cli import main as port_cli
from torchsnapshot_tpu.telemetry import critpath as jax_critpath
from torchsnapshot_tpu_torch import scheduler, telemetry
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import critpath, history
from torch_test_env import autotune_never  # noqa: F401 - autouse

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "torchsnapshot_tpu_torch")


@pytest.fixture(autouse=True)
def _clean():
    telemetry.set_enabled(False)
    telemetry.reset()
    scheduler.reset_io_governor()
    yield
    telemetry.set_enabled(False)
    telemetry.reset()
    scheduler.reset_io_governor()


def test_the_taxonomy_is_the_jax_packages() -> None:
    assert critpath.CATEGORIES == jax_critpath.CATEGORIES
    assert critpath.SPAN_CATEGORIES == jax_critpath.SPAN_CATEGORIES
    assert critpath.FUSED_SPANS == jax_critpath.FUSED_SPANS
    assert critpath.ATTRIBUTION_FNAME == jax_critpath.ATTRIBUTION_FNAME == ".snapshot_critpath"
    for cat in critpath.CATEGORIES:
        assert critpath.classify_category(cat) == jax_critpath.classify_category(cat)


# Spans the JAX package deliberately leaves out of the taxonomy: they are
# containers that attribute through their children (critpath.py:66).
_CONTAINERS = {"io_drain"}


def test_every_span_the_port_emits_is_mapped_fused_or_a_container() -> None:
    emitted = set()
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    emitted |= set(re.findall(r"telemetry\.span\(\s*\"([a-z_]+)\"", fh.read()))
    assert {"stage", "stream_write", "stream_read", "storage_write", "storage_read",
            "sub_chunk_dtoh", "sub_chunk_htod", "collective_wait"} <= emitted
    known = set(jax_critpath.SPAN_CATEGORIES) | set(jax_critpath.FUSED_SPANS) | _CONTAINERS
    assert sorted(emitted - known) == []
    # The card's copies: DtoH into a pinned slab is staging, HtoD decode.
    assert critpath.SPAN_CATEGORIES["sub_chunk_dtoh"] == "stage_copy"
    assert critpath.SPAN_CATEGORIES["sub_chunk_htod"] == "decode"


def _gpu(text: str) -> str:
    return text.replace("TORCHSNAPSHOT_TPU_", "TORCHSNAPSHOT_GPU_")


_NAMES = sorted(jax_critpath.SPAN_CATEGORIES) + sorted(jax_critpath.FUSED_SPANS) + ["io_drain"]


def _events(rng: np.random.Generator, n: int, keys) -> list:
    """Random spans over [0, 10) s, with collective waits at ``keys``."""
    events = []
    for _ in range(n):
        name = _NAMES[rng.integers(len(_NAMES))]
        if name == "collective_wait":
            continue
        ts = float(rng.uniform(0, 9))
        events.append({"ph": "span", "name": name, "ts": ts,
                       "dur": float(rng.uniform(0, 10 - ts)), "cat": "pipeline"})
    for i, key in enumerate(keys):
        ts = float(2.5 * (i + 1) + rng.uniform(0, 0.5))
        events.append({"ph": "span", "name": "collective_wait", "ts": ts,
                       "dur": float(rng.uniform(0.01, 0.4)), "cat": "collective",
                       "args": {"ns": "pgw/ns", "cseq": key, "kind": "all_gather"}})
    events.append({"ph": "instant", "name": "governor_elect", "ts": 1.0})
    return events


@pytest.mark.parametrize("seed", range(8))
def test_synthetic_events_give_equal_attributions_merges_and_documents(seed) -> None:
    rng = np.random.default_rng(seed)
    world = 1 + seed % 3
    keys = list(range(seed % 4))
    per_rank = [_events(rng, int(rng.integers(0, 40)), keys) for _ in range(world)]
    walls = [float(rng.uniform(8, 12)) if seed % 2 else None for _ in range(world)]
    mine = [critpath.build_attribution(ev, wall_s=w, rank=r)
            for r, (ev, w) in enumerate(zip(per_rank, walls))]
    theirs = [jax_critpath.build_attribution(ev, wall_s=w, rank=r)
              for r, (ev, w) in enumerate(zip(per_rank, walls))]
    assert mine == theirs
    aggregate = {"bytes_written": int(rng.integers(1, 1 << 30)),
                 "bytes_read": int(rng.integers(1, 1 << 30)),
                 "bytes_staged": int(rng.integers(1, 1 << 30))}
    if seed == 5:
        mine[0] = theirs[0] = None  # a rank with telemetry off
    fleet = critpath.merge_attributions(mine, aggregate=aggregate)
    assert fleet == jax_critpath.merge_attributions(theirs, aggregate=aggregate)
    doc = critpath.build_attribution_document("take", world, fleet, rates={"hash_bps": 1e9},
                                              governor=[{"site": "sub_chunk", "value": 1}])
    assert doc == jax_critpath.build_attribution_document(
        "take", world, fleet, rates={"hash_bps": 1e9},
        governor=[{"site": "sub_chunk", "value": 1}])
    # The hints name each package's own knobs.
    assert critpath.render_attribution(doc, verbose=True) == _gpu(
        jax_critpath.render_attribution(doc, verbose=True))
    assert critpath.binding_exit_code(doc) == jax_critpath.binding_exit_code(doc)
    flat = [e for ev in per_rank for e in ev]
    assert critpath.live_binding(flat) == jax_critpath.live_binding(flat)
    tdoc = {"op": "take", "world_size": world, "fleet": {"aggregate": aggregate},
            "ranks": [{"attribution": a, "rates": {}} for a in mine]}
    assert (critpath.derive_document_from_telemetry(tdoc)
            == jax_critpath.derive_document_from_telemetry(tdoc))


def _throttled(monkeypatch, seconds: float) -> None:
    """Every payload write of the fs plugin waits ``seconds`` first."""
    write = FSStoragePlugin.write

    async def slow(self, write_io):
        if not write_io.path.startswith("."):
            await asyncio.sleep(seconds)
        return await write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", slow)


@pytest.mark.parametrize("storage", ["page cache", "throttled"])
def test_a_port_takes_critpath_is_read_by_jax_explain(tmp_path, monkeypatch, capsys,
                                                      storage) -> None:
    telemetry.set_enabled(True)
    if storage == "throttled":
        _throttled(monkeypatch, 0.3)
    g = torch.Generator().manual_seed(0)
    state = {"m": P.StateDict(**{f"w{i}": torch.randn(1 << 16, generator=g)
                                 for i in range(4)})}
    snap = str(tmp_path / "snap")
    P.Snapshot.take(snap, state, compression="zlib:1" if storage == "page cache" else None)
    attr = telemetry.last_attribution()
    with open(os.path.join(snap, critpath.ATTRIBUTION_FNAME)) as f:
        doc = json.load(f)
    assert doc["op"] == "take" and doc["fleet"] == attr
    assert attr["verdict"] == ("storage-bound" if storage == "throttled" else "pipeline-bound")
    capsys.readouterr()
    assert jax_cli(["explain", snap]) == critpath.binding_exit_code(doc)
    out = capsys.readouterr().out
    assert f"binding:     {attr['binding']['category']}" in out
    # The port's CLI reads the same record the same way.
    assert port_cli(["explain", snap]) == critpath.binding_exit_code(doc)
    assert capsys.readouterr().out == _gpu(out)
    assert _gpu(jax_critpath.render_attribution(doc)) == critpath.render_attribution(doc)
    rec = [r for r in history.load_history(str(tmp_path)) if r.get("op") == "take"][-1]
    assert rec["binding"] == attr["binding"]["category"]
    # The restore's attribution charges the consume to decode.
    dst = {"m": P.StateDict(**{f"w{i}": torch.zeros(1 << 16) for i in range(4)})}
    P.Snapshot(snap).restore(dst)
    restored = telemetry.last_attribution()
    assert restored["categories"].get("decode", 0) > 0
    assert all(torch.equal(dst["m"][k], state["m"][k]) for k in state["m"])


def test_no_critpath_document_with_the_bus_off(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"m": P.StateDict(w=torch.ones(4))})
    assert not os.path.exists(tmp_path / "s" / critpath.ATTRIBUTION_FNAME)
    rec = history.load_history(str(tmp_path))[-1]
    assert "binding" not in rec


def test_the_reporters_live_binding_reads_the_bus(monkeypatch) -> None:
    telemetry.set_enabled(True)
    reporter = scheduler._ProgressReporter("write", 0, 1, scheduler._MemoryBudget(1 << 20))
    with telemetry.span("storage_write", path="a"):
        pass
    with telemetry.span("stage", path="a"):
        pass
    evs = telemetry.events()
    assert reporter._live_binding(False) == critpath.live_binding(evs)
    # Nothing new on the bus since: the queue shape answers.
    reporter.inflight_io, reporter.inflight_staging = 1, 0
    assert reporter._live_binding(False) == "storage_write"
    telemetry.set_enabled(False)
    reporter.inflight_io, reporter.inflight_staging = 0, 2
    assert reporter._live_binding(False) == "stage_copy"
