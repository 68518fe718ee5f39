"""The port's ``fsck`` against the JAX package's.

- Every finding class, seeded once into a snapshot written by each
  package: both CLIs give the same exit code and text, and ``--repair``
  (each CLI on its own copy) quarantines what it may, converges to a clean
  second run, and never touches payload damage.
- The journal classes on each package's journaled manager step.
- A port take with every plane on (telemetry, journal, mirror, georep,
  flight recorder, stack dumps) fscks clean in both CLIs, and ``--repair``
  moves nothing: each artifact the port writes is in ``INTERNAL_ARTIFACTS``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import cli as jax_cli
from torchsnapshot_tpu_torch import cli, telemetry
from torchsnapshot_tpu_torch.telemetry import flightrec, forensics
from torch_cli_env import both, jax_state, port_state, recorders_from_env  # noqa: F401
from torch_cli_env import run_cli, to_port_text
from torch_test_env import autotune_never  # noqa: F401 - autouse

WRITERS = ["port", "jax"]


def _arrays() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(5)
    return {"w": rng.standard_normal(4096).astype(np.float32),
            "b": rng.standard_normal(256)}


def _take(pkg: str, path: str, **kw) -> None:
    if pkg == "port":
        P.Snapshot.take(path, port_state(_arrays()), **kw)
    else:
        J.Snapshot.take(path, jax_state(_arrays()), **kw)


def _payload(snap: str, leaf: str) -> str:
    entry = P.Snapshot(snap).metadata.manifest[f"0/m/{leaf}"]
    return os.path.join(snap, entry.chunks[0].array.location)


def _flip(path: str, at: int = 100) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def _write(path: str, data: str = "x") -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(data)


def _dangling(snap: str, pkg: str) -> None:
    """Replace the snapshot by an incremental take whose base is gone."""
    base = snap + "_base"
    shutil.move(snap, base)
    _take(pkg, snap, incremental_base=base)
    shutil.rmtree(base)


# name -> (damage(snap, pkg), the finding class, whether --repair clears it)
_DAMAGE: Dict[str, tuple] = {
    "clean": (lambda s, p: None, None, True),
    "truncated-payload": (lambda s, p: os.truncate(_payload(s, "w"), 100),
                          "truncated-payload", False),
    "checksum-mismatch": (lambda s, p: _flip(_payload(s, "w")), "checksum-mismatch", False),
    "missing-payload": (lambda s, p: os.remove(_payload(s, "b")), "missing-payload", False),
    "orphan": (lambda s, p: _write(os.path.join(s, "0", "m", "stray")), "orphan", True),
    "empty-dir": (lambda s, p: os.makedirs(os.path.join(s, "0", "gone")), "orphan", True),
    "temp-file": (lambda s, p: _write(os.path.join(s, "0", "m", "w.tmp.123")), "temp-file",
                  True),
    "stale-fence": (lambda s, p: _write(os.path.join(s, ".snapshot_fence"), "{}"),
                    "stale-fence", True),
    "georep-stale-cursor": (lambda s, p: _write(os.path.join(s, ".georep_cursor.json"), "{"),
                            "georep-stale-cursor", True),
    "corrupt-metadata": (lambda s, p: _write(os.path.join(s, ".snapshot_metadata"), "garbage"),
                         "corrupt-metadata", False),
    "partial-commit": (lambda s, p: os.remove(os.path.join(s, ".snapshot_metadata")),
                       "partial-commit", False),
    "dangling-dep": (_dangling, "dangling-dep", False),
}


# How a finding that fsck reports before reading the manifest is shown.
_MARKERS = {"corrupt-metadata": "CORRUPT  .snapshot_metadata", "partial-commit": "PARTIAL  SNAP"}


def _fsck_both(snap: str, tmp: str, repair: bool):
    """Both CLIs' (code, text) on their own copies of ``snap``, the copy's
    path put back to ``SNAP``; then a second plain fsck of each copy."""
    results = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        copy = os.path.join(tmp, f"{name}_{os.path.basename(snap)}")
        shutil.copytree(snap, copy)
        argv = ["fsck", copy] + (["--repair"] if repair else [])
        rc, out, err = run_cli(main, argv)
        again = run_cli(main, ["fsck", copy])[0]
        norm = to_port_text if name == "jax" else (lambda t: t)
        results.append((rc, norm(out).replace(copy, "SNAP"), norm(err).replace(copy, "SNAP"),
                        again))
    return results


@pytest.mark.parametrize("repair", [False, True], ids=["check", "repair"])
@pytest.mark.parametrize("damage", list(_DAMAGE))
@pytest.mark.parametrize("writer", WRITERS)
def test_each_finding_class_alike(tmp_path, writer, damage, repair) -> None:
    snap = str(tmp_path / "snap")
    _take(writer, snap, record_digests=True)
    hurt, cls, repairable = _DAMAGE[damage]
    hurt(snap, writer)
    (jax_rc, jax_out, jax_err, jax_again), port = _fsck_both(snap, str(tmp_path), repair)
    assert port == (jax_rc, jax_out, jax_err, jax_again)
    rc, out, _, again = port
    if cls is None:
        assert rc == again == 0 and ", 0 finding(s)" in out
        return
    if repair and repairable:
        assert rc == again == 0 and "QUARANTINED" in out
    else:
        assert rc == again == 1 and _MARKERS.get(cls, cls.upper()) in out
        assert "QUARANTINED" not in out  # damage is never quarantined away
    code, report = cli.run_fsck(snap, echo=lambda _: None)
    assert code == 1 and cls in report.classes()


def test_a_missing_directory_is_cannot_check(tmp_path) -> None:
    jax_res, port_res = both(["fsck", str(tmp_path / "absent")])
    assert port_res == jax_res and port_res[0] == 2


def _journaled(pkg: str, root: str, monkeypatch) -> str:
    """A manager step with two committed journal epochs; its directory."""
    if pkg == "port":
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
        mgr = P.CheckpointManager(root, save_interval_steps=100)
        state = P.StateDict(w=torch.arange(512, dtype=torch.float32), step=0)
    else:
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
        mgr = J.CheckpointManager(root, save_interval_steps=100)
        state = J.StateDict(w=np.arange(512, dtype=np.float32), step=0)
    mgr.save(0, {"app": state})
    for epoch in (1, 2):
        state["step"] = epoch
        assert mgr.journal_step(epoch, {"app": state})
    mgr.close()
    return os.path.join(root, sorted(n for n in os.listdir(root)
                                     if os.path.isdir(os.path.join(root, n)))[0])


def _torn(jdir: str) -> None:
    with open(os.path.join(jdir, "rank_0.seg"), "ab") as f:
        f.write(b"TSJR\x20\x00\x00\x00torn")


_JOURNAL_DAMAGE: Dict[str, tuple] = {
    "journal-torn-tail": (_torn, True),
    "journal-orphan-epoch": (lambda j: os.remove(os.path.join(j, "epoch_000001.json")), True),
    "journal-corrupt-record": (lambda j: _flip(os.path.join(j, "rank_0.seg"), 20), False),
    "stale-fence": (lambda j: _write(os.path.join(j, ".fence"), '{"gen": "dead", "epoch": 3}'),
                    True),
    "orphan": (lambda j: _write(os.path.join(j, "stray")), True),
}


@pytest.mark.parametrize("repair", [False, True], ids=["check", "repair"])
@pytest.mark.parametrize("damage", list(_JOURNAL_DAMAGE))
@pytest.mark.parametrize("writer", WRITERS)
def test_each_journal_class_alike(tmp_path, monkeypatch, writer, damage, repair) -> None:
    snap = _journaled(writer, str(tmp_path / "root"), monkeypatch)
    jdir = os.path.join(snap, ".journal")
    committed = os.path.getsize(os.path.join(jdir, "rank_0.seg"))
    hurt, repairable = _JOURNAL_DAMAGE[damage]
    hurt(jdir)
    (jax_rc, jax_out, jax_err, jax_again), port = _fsck_both(snap, str(tmp_path), repair)
    assert port == (jax_rc, jax_out, jax_err, jax_again)
    rc, out, _, again = port
    assert (rc, again) == ((0, 0) if repair and repairable else (1, 1))
    assert damage.upper() in out if rc else ("QUARANTINED" in out or "TRUNCATED" in out)
    if repair and damage == "journal-torn-tail":
        copy = os.path.join(str(tmp_path), f"port_{os.path.basename(snap)}")
        assert os.path.getsize(os.path.join(copy, ".journal", "rank_0.seg")) == committed
        tail = os.path.join(copy, ".fsck_quarantine", ".journal", "rank_0.seg.tail")
        assert os.path.getsize(tail) == 12


def test_the_registry_matches_the_jax_packages() -> None:
    mine = [(a.name, a.files, a.prefixes) for a in cli.INTERNAL_ARTIFACTS]
    theirs = [(a.name, a.files, a.prefixes) for a in jax_cli.INTERNAL_ARTIFACTS]
    assert mine == theirs
    assert cli.FsckReport.REPAIRABLE == jax_cli.FsckReport.REPAIRABLE
    for art in cli.INTERNAL_ARTIFACTS:
        for f in art.files:
            assert cli.internal_artifact_class(f) == art.name
        for p in art.prefixes:
            assert cli.internal_artifact_class(os.path.join(p, "x")) == art.name
    assert cli.internal_artifact_class("0/m/w_0") is None


def _tree(root: str):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_a_take_with_every_plane_on_fscks_clean(tmp_path, monkeypatch) -> None:
    """Telemetry (summary, critpath, Chrome trace), the journal, a strict
    mirror, georep to a remote root and the flight recorder's ring and
    stack dumps: every file the port leaves beside a committed step is an
    internal artifact, in the primary, the mirror and the remote."""
    root, mirror, remote = (str(tmp_path / n) for n in ("primary", "mirror", "remote"))
    os.makedirs(remote)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_TELEMETRY", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_GEOREP", remote)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S", "0.05")
    telemetry.refresh_from_env()
    try:
        mgr = P.CheckpointManager(root, save_interval_steps=100,
                                  storage_options={"mirror_url": mirror})
        state = P.StateDict(w=torch.arange(4096, dtype=torch.float32), step=0)
        mgr.save(0, {"app": state})
        for epoch in (1, 2):
            state["w"][:8] = float(epoch)
            state["step"] = epoch
            assert mgr.journal_step(epoch, {"app": state})
        assert mgr._georep.drain(timeout=30.0), mgr._georep.last_error
        mgr.close()
    finally:
        monkeypatch.delenv("TORCHSNAPSHOT_GPU_TELEMETRY")
        telemetry.refresh_from_env()
        telemetry.reset()
    step = sorted(n for n in os.listdir(root) if n.startswith("step_"))[0]
    snap = os.path.join(root, step)
    # The flight recorder's ring and the watchdog's stacks, as an abort
    # and a hang leave them beside a snapshot.
    flightrec.record("progress", op="take")
    assert flightrec.dump(snap, 0, "drill")
    forensics.dump_stacks(snap, 0, "drill", trigger="remote")
    with open(os.path.join(snap, telemetry.TELEMETRY_SUMMARY_FNAME)) as f:
        assert json.load(f)["op"] == "take"
    remote_step = os.path.join(remote, step)
    assert os.path.isfile(os.path.join(remote_step, ".georep_cursor.json"))
    mirror_step = os.path.join(mirror, step)
    for d in (snap, mirror_step, remote_step):
        names = set(_tree(d))
        if d == snap:
            assert {".snapshot_critpath", ".snapshot_telemetry", ".journal/rank_0.seg",
                    ".flight/rank_0.jsonl", ".flight/rank_0.stacks.jsonl"} <= names
            assert any(n.startswith(".telemetry/") for n in names)
        before = _tree(d)
        for argv in (["fsck", d], ["fsck", d, "--repair"]):
            jax_res, port_res = both(argv)
            assert port_res == jax_res, (d, port_res)
            assert port_res[0] == 0, port_res[1]
        assert _tree(d) == before
