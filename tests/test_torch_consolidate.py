"""The port's ``dedup.consolidate`` and journal compaction: counterparts of
``tests/test_dedup_consolidate.py`` on torch state, with the JAX package's
fsck as the integrity check of the port's output, and consolidated
snapshots and journaled chains crossing between the two packages."""

from __future__ import annotations

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.cli import run_fsck
from torchsnapshot_tpu_torch import journal
from torchsnapshot_tpu_torch.dedup import consolidate
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture
def journaling(monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")


def _journaled_base(root, epochs=2, **mgr_kwargs):
    """A committed base plus ``epochs`` journal epochs touching a tensor,
    a scalar and a string. Returns (snapshot path, live state)."""
    mgr = P.CheckpointManager(str(root), save_interval_steps=100, **mgr_kwargs)
    st = P.StateDict(
        w=torch.arange(1024, dtype=torch.float32),
        b=torch.zeros(32, dtype=torch.float64),
        h=torch.zeros(16, dtype=torch.bfloat16),
        step=0,
        name="run-0",
    )
    mgr.save(0, {"app": st})
    for epoch in range(1, epochs + 1):
        st["w"] = torch.arange(1024, dtype=torch.float32) + epoch
        st["h"] = torch.full((16,), epoch / 3).to(torch.bfloat16)
        st["step"] = epoch
        st["name"] = f"run-{epoch}"
        assert mgr.journal_step(epoch, {"app": st})
    return mgr.path_for(0), st


def _restore(path):
    dst = P.StateDict(w=torch.zeros(1024), b=torch.ones(32, dtype=torch.float64),
                      h=torch.ones(16, dtype=torch.bfloat16), step=-1, name="")
    P.Snapshot(str(path)).restore({"app": dst})
    return dst


def test_consolidate_folds_journal_epochs(tmp_path, journaling) -> None:
    src, live = _journaled_base(tmp_path / "root", epochs=3)
    dst = str(tmp_path / "flat")
    consolidate(src, dst)
    assert not os.path.isdir(os.path.join(dst, ".journal"))
    code, report = run_fsck(dst)
    assert code == 0, report.findings
    out = _restore(dst)
    for k in ("w", "b", "h"):
        assert torch.equal(out[k], live[k]), k
    assert out["step"] == 3 and out["name"] == "run-3"
    srcout = _restore(src)
    assert torch.equal(srcout["w"], out["w"]) and srcout["step"] == out["step"]


def test_consolidate_without_journal_unchanged(tmp_path) -> None:
    src = str(tmp_path / "snap")
    P.Snapshot.take(src, {"app": P.StateDict(w=torch.arange(64, dtype=torch.float32))})
    dst = str(tmp_path / "flat")
    assert consolidate(src, dst) == 1
    assert run_fsck(dst)[0] == 0
    out = P.StateDict(w=torch.zeros(64))
    P.Snapshot(dst).restore({"app": out})
    assert torch.equal(out["w"], torch.arange(64, dtype=torch.float32))


def test_consolidate_incremental_chain_with_journal(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path / "root"), save_interval_steps=1, incremental=True)
    frozen = torch.arange(4096, dtype=torch.float32)
    st = P.StateDict(frozen=frozen.clone(), head=torch.zeros(64), step=0)
    mgr.save(0, {"app": st})
    st["head"] = torch.full((64,), 1.0)
    st["step"] = 1
    mgr.save(1, {"app": st})  # frozen dedups against step 0
    st["head"] = torch.full((64,), 2.0)
    st["step"] = 2
    assert mgr.journal_step(2, {"app": st})
    dst = str(tmp_path / "flat")
    consolidate(mgr.path_for(1), dst)
    assert run_fsck(dst)[0] == 0
    shutil.rmtree(mgr.path_for(0))
    out = P.StateDict(frozen=torch.zeros(4096), head=torch.zeros(64), step=-1)
    P.Snapshot(dst).restore({"app": out})
    assert torch.equal(out["frozen"], frozen)
    assert torch.equal(out["head"], torch.full((64,), 2.0)) and out["step"] == 2


def test_consolidate_reads_origin_through_mirror(tmp_path, journaling) -> None:
    base = str(tmp_path / "base")
    frozen = torch.arange(4096, dtype=torch.float32)
    P.Snapshot.take(base, {"app": P.StateDict(frozen=frozen, head=torch.zeros(8))},
                    storage_options={"mirror_url": str(tmp_path / "mirror")},
                    record_digests=True)
    inc = str(tmp_path / "inc")
    P.Snapshot.take(inc, {"app": P.StateDict(frozen=frozen, head=torch.ones(8))},
                    incremental_base=base, record_digests=True)
    j = journal.DeltaJournal(inc, base_step=0, rank=0)
    j.capture_baseline({"app": P.StateDict(frozen=frozen, head=torch.ones(8))})
    assert j.append_epoch({"app": P.StateDict(frozen=frozen, head=torch.full((8,), 5.0))}) == 1
    lost = [os.path.join(dp, f) for dp, _, fs in os.walk(os.path.join(base, "0"))
            for f in fs if "frozen" in f]
    assert lost
    os.remove(lost[0])
    dst = str(tmp_path / "flat")
    consolidate(inc, dst)
    assert run_fsck(dst)[0] == 0
    out = P.StateDict(frozen=torch.zeros(4096), head=torch.zeros(8))
    P.Snapshot(dst).restore({"app": out})
    assert torch.equal(out["frozen"], frozen) and torch.equal(out["head"], torch.full((8,), 5.0))


def test_consolidate_refuses_corrupt_journal(tmp_path, journaling) -> None:
    src, _ = _journaled_base(tmp_path / "root")
    seg = os.path.join(src, ".journal", "rank_0.seg")
    with open(seg, "r+b") as f:
        f.seek(16)
        byte = f.read(1)
        f.seek(16)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="fsck"):
        consolidate(src, str(tmp_path / "flat"))


def _forge(src: str, key: str, value, kind: str) -> None:
    """Append a record of ``key`` under the last committed generation and
    extend the committed offset over it."""
    jdir = os.path.join(src, ".journal")
    committed = journal.committed_epochs(journal.read_epoch_metas(jdir))
    fields, payload = journal._serialize_leaf(value, kind)
    header = {"v": 1, "gen": committed[-1]["gen"], "epoch": 1, "key": key, **fields}
    seg = os.path.join(jdir, journal.segment_name(0))
    with open(seg, "ab") as f:
        f.write(journal.encode_record(header, payload))
    meta_path = os.path.join(jdir, journal.epoch_meta_name(1))
    meta = json.load(open(meta_path))
    meta["offsets"]["0"] = os.path.getsize(seg)
    json.dump(meta, open(meta_path, "w"))


@pytest.mark.parametrize(
    "key,value,kind",
    [
        ("app/brand_new", 123, "object"),  # a leaf the base never had
        ("app/w", torch.zeros(7), "array"),  # shape drift
        ("app/w", torch.zeros(1024, dtype=torch.float64), "array"),  # dtype drift
        ("app/step", torch.zeros(2), "array"),  # a primitive turned array
    ],
)
def test_consolidate_refuses_unfoldable_records(tmp_path, journaling, key, value, kind) -> None:
    src, _ = _journaled_base(tmp_path / "root", epochs=1)
    _forge(src, key, value, kind)
    with pytest.raises(ValueError, match="restore and retake"):
        consolidate(src, str(tmp_path / "flat"))


def test_consolidated_journal_snapshot_serves_as_base(tmp_path, journaling) -> None:
    src, live = _journaled_base(tmp_path / "root", epochs=2, incremental=True)
    dst = str(tmp_path / "flat")
    consolidate(src, dst)
    nxt = str(tmp_path / "next")
    P.Snapshot.take(nxt, {"app": P.StateDict(w=live["w"].clone(), b=live["b"].clone(),
                                             h=live["h"].clone(), step=live["step"],
                                             name=live["name"])},
                    incremental_base=dst, record_digests=True)
    # The folded payloads' digests match the live state: nothing rewritten.
    manifest = P.Snapshot(nxt).metadata.manifest
    assert all(c.array.origin == os.path.realpath(dst) for c in manifest["0/app/w"].chunks)
    out = _restore(nxt)
    assert torch.equal(out["w"], live["w"]) and out["step"] == live["step"]
    assert run_fsck(nxt)[0] == 0


def test_port_consolidated_snapshot_restores_in_jax(tmp_path, journaling) -> None:
    src, live = _journaled_base(tmp_path / "root", epochs=2)
    dst = str(tmp_path / "flat")
    consolidate(src, dst)
    out = J.StateDict(w=jnp.zeros(1024, jnp.float32), b=jnp.ones(32, jnp.float32),
                      h=jnp.zeros(16, jnp.bfloat16), step=-1, name="")
    J.Snapshot(dst).restore({"app": out})
    assert np.array_equal(np.asarray(out["w"]), live["w"].numpy())
    assert np.array_equal(np.asarray(out["h"]).astype(np.float32), live["h"].float().numpy())
    assert out["step"] == 2 and out["name"] == "run-2"


def test_jax_journaled_chain_consolidates_in_port(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
    mgr = J.CheckpointManager(str(tmp_path / "root"), save_interval_steps=100)
    st = J.StateDict(w=jnp.arange(256, dtype=jnp.float32), step=0)
    mgr.save(0, {"app": st})
    st["w"] = st["w"] * 4
    st["step"] = 7
    assert mgr.journal_step(1, {"app": st})
    dst = str(tmp_path / "flat")
    consolidate(mgr.path_for(0), dst)
    assert run_fsck(dst)[0] == 0
    out = P.StateDict(w=torch.zeros(256), step=0)
    P.Snapshot(dst).restore({"app": out})
    assert np.array_equal(out["w"].numpy(), np.asarray(st["w"])) and out["step"] == 7
    # The JAX package's consolidate of the same chain restores alike.
    from torchsnapshot_tpu.dedup import consolidate as jax_consolidate

    jdst = str(tmp_path / "jflat")
    jax_consolidate(mgr.path_for(0), jdst)
    again = P.StateDict(w=torch.zeros(256), step=0)
    P.Snapshot(jdst).restore({"app": again})
    assert torch.equal(again["w"], out["w"]) and again["step"] == 7


def test_consolidate_folds_a_journaled_numpy_leaf(tmp_path, journaling) -> None:
    """The port pickles a numpy leaf as an object; its journal records the
    array, which consolidate pickles back into the object payload."""
    mgr = P.CheckpointManager(str(tmp_path / "root"), save_interval_steps=100)
    st = P.StateDict(a=np.arange(6, dtype=np.float32), t=torch.ones(3))
    mgr.save(0, {"app": st})
    st["a"] = np.arange(6, dtype=np.float32) * 5
    assert mgr.journal_step(1, {"app": st})
    dst = str(tmp_path / "flat")
    consolidate(mgr.path_for(0), dst)
    out = P.StateDict(a=np.zeros(6, np.float32), t=torch.zeros(3))
    P.Snapshot(dst).restore({"app": out})
    assert np.array_equal(out["a"], st["a"]) and torch.equal(out["t"], torch.ones(3))
