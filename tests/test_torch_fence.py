"""The port's commit fence, against the JAX package's.

Mirrors the single-process fence cases of ``tests/test_crash_consistency.py``
(:506, :528, :562). Where the JAX tests race a background commit against a
check (a delay on every write), these hold the commit back with a gate on
``Snapshot._write_snapshot_metadata``, so no check depends on timing. Every
test joins the threads it starts. Fences cross between the packages: each
reads the other's ``.snapshot_fence``, and each manager's GC reclaims the
other's partial step directory.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import faultinject as jax_faultinject
from torchsnapshot_tpu.snapshot import Snapshot as JSnapshot
from torchsnapshot_tpu_torch import faultinject
from torchsnapshot_tpu_torch.snapshot import (
    SNAPSHOT_FENCE_FNAME,
    SNAPSHOT_METADATA_FNAME,
    Snapshot,
    StaleCommitError,
)
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture(autouse=True)
def _no_faults():
    faultinject.disable()
    jax_faultinject.disable()
    yield
    faultinject.disable()
    jax_faultinject.disable()


def _state(v: float = 1.0):
    return {
        "model": P.StateDict(
            w=torch.arange(4096, dtype=torch.float32) * v,
            b=torch.arange(256, dtype=torch.float64) + v,
        )
    }


def _files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


class _CommitGate:
    """Holds every port commit at the commit point's entry until
    ``release``; ``reached`` is set when a commit is waiting."""

    def __init__(self, monkeypatch) -> None:
        self.reached = threading.Event()
        self._go = threading.Event()
        real = Snapshot._write_snapshot_metadata

        def gated(metadata, storage, event_loop):
            self.reached.set()
            assert self._go.wait(60), "the test never released the commit"
            return real(metadata, storage, event_loop)

        monkeypatch.setattr(Snapshot, "_write_snapshot_metadata", staticmethod(gated))

    def release(self) -> None:
        self._go.set()


def test_async_take_plants_fence_before_returning(tmp_path, monkeypatch) -> None:
    gate = _CommitGate(monkeypatch)
    snap = tmp_path / "snap"
    pending = Snapshot.async_take(str(snap), _state())
    try:
        planted_on_return = os.path.exists(snap / SNAPSHOT_FENCE_FNAME)
        assert gate.reached.wait(60)
        # The commit is held: the fence is this take's, not yet consumed.
        with open(snap / SNAPSHOT_FENCE_FNAME) as f:
            fence = json.load(f)
        assert sorted(fence) == ["gen", "pid", "version"] and fence["pid"] == os.getpid()
    finally:
        gate.release()
        pending.wait()
    assert planted_on_return, "async_take returned without planting the commit fence"
    assert os.path.exists(snap / SNAPSHOT_METADATA_FNAME)
    assert not os.path.exists(snap / SNAPSHOT_FENCE_FNAME)


def test_straggler_with_reclaimed_fence_cannot_commit(tmp_path, monkeypatch) -> None:
    gate = _CommitGate(monkeypatch)
    snap = tmp_path / "snap"
    pending = Snapshot.async_take(str(snap), _state())
    try:
        assert gate.reached.wait(60)
        os.remove(snap / SNAPSHOT_FENCE_FNAME)  # the fenced GC reclaiming this take
    finally:
        gate.release()
    with pytest.raises(StaleCommitError):
        pending.wait()
    assert not os.path.exists(snap / SNAPSHOT_METADATA_FNAME)
    # The straggler did not re-plant its fence either.
    assert not os.path.exists(snap / SNAPSHOT_FENCE_FNAME)


def test_commit_check_does_not_replant_missing_fence(tmp_path) -> None:
    meta = P.SnapshotMetadata(version=P.__version__, world_size=1, manifest={})
    meta._commit_gen = "deadbeef"
    meta._commit_path = str(tmp_path)
    loop = asyncio.new_event_loop()
    storage = url_to_storage_plugin(str(tmp_path))
    try:
        with pytest.raises(StaleCommitError) as info:
            Snapshot._write_snapshot_metadata(meta, storage, loop)
    finally:
        storage.sync_close(loop)
        loop.close()
    assert info.value.expected == "deadbeef" and info.value.found is None
    assert not os.path.exists(tmp_path / SNAPSHOT_METADATA_FNAME)
    assert not os.path.exists(tmp_path / SNAPSHOT_FENCE_FNAME)


def test_stale_commit_error_is_exported_like_the_jax_package() -> None:
    assert P.StaleCommitError is StaleCommitError
    assert issubclass(StaleCommitError, RuntimeError)
    assert SNAPSHOT_FENCE_FNAME == J.snapshot.SNAPSHOT_FENCE_FNAME == ".snapshot_fence"
    assert str(StaleCommitError("p", "a", "b")) == str(J.StaleCommitError("p", "a", "b"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_fence_planted_by_either_package_reads_in_the_other(tmp_path, writer) -> None:
    """``_write_fence`` of one package and ``_read_fence_gen`` of the other
    agree on the token; a torn fence and a missing one read as None in
    both."""
    from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin_in_event_loop

    loop = asyncio.new_event_loop()
    port_storage = url_to_storage_plugin(str(tmp_path))
    jax_storage = url_to_storage_plugin_in_event_loop(str(tmp_path), loop, None)
    try:
        write, read, storage_w, storage_r = (
            (JSnapshot._write_fence, Snapshot._read_fence_gen, jax_storage, port_storage)
            if writer == "jax"
            else (Snapshot._write_fence, JSnapshot._read_fence_gen, port_storage, jax_storage)
        )
        write("0123abcd", storage_w, loop)
        assert read(storage_r, loop) == "0123abcd"
        (tmp_path / SNAPSHOT_FENCE_FNAME).write_bytes(b'{"gen": "01')  # torn
        assert Snapshot._read_fence_gen(port_storage, loop) is None
        assert JSnapshot._read_fence_gen(jax_storage, loop) is None
        os.remove(tmp_path / SNAPSHOT_FENCE_FNAME)
        assert Snapshot._read_fence_gen(port_storage, loop) is None
        assert JSnapshot._read_fence_gen(jax_storage, loop) is None
    finally:
        port_storage.sync_close(loop)
        jax_storage.sync_close(loop)
        loop.close()


def test_a_transport_error_reading_the_fence_propagates(tmp_path) -> None:
    """Only a missing file is "not ours": any other read failure fails
    the commit with the storage's own error, not a StaleCommitError."""
    loop = asyncio.new_event_loop()
    storage = url_to_storage_plugin(str(tmp_path))
    os.makedirs(tmp_path / SNAPSHOT_FENCE_FNAME)  # reading a directory: IsADirectoryError
    try:
        with pytest.raises(IsADirectoryError):
            Snapshot._read_fence_gen(storage, loop)
    finally:
        storage.sync_close(loop)
        loop.close()


@pytest.mark.parametrize("newer", ["jax", "port"])
def test_a_straggler_leaves_the_newer_take_byte_identical(tmp_path, monkeypatch, newer) -> None:
    """A port async take is held at its commit while its directory is
    reclaimed and a newer take (by either package) commits there; the
    straggler then raises StaleCommitError and every file of the newer
    snapshot is byte-identical to what that take left."""
    gate = _CommitGate(monkeypatch)
    snap = str(tmp_path / "snap")
    pending = Snapshot.async_take(snap, _state(1.0))
    try:
        assert gate.reached.wait(60)
        shutil.rmtree(snap)  # the GC reclaiming the partial directory
        if newer == "jax":
            J.Snapshot.take(snap, {"model": J.StateDict(
                w=np.arange(4096, dtype=np.float32) * 2.0,
                b=np.arange(256, dtype=np.float64) + 2.0,
            )})
        else:
            # The newer port take commits through the real commit point.
            monkeypatch.undo()
            Snapshot.take(snap, _state(2.0))
        newer_files = _files(snap)
        assert SNAPSHOT_METADATA_FNAME in newer_files and SNAPSHOT_FENCE_FNAME not in newer_files
    finally:
        gate.release()
    with pytest.raises(StaleCommitError):
        pending.wait()
    # The straggler's abort dumps its flight ring and its thread stacks
    # under .flight/ (as the JAX package's does); every file of the newer
    # snapshot is unchanged.
    after = _files(snap)
    dumps = {k: v for k, v in after.items() if k.startswith(".flight/")}
    assert sorted(dumps) == [".flight/rank_0.jsonl", ".flight/rank_0.stacks.jsonl"]
    assert b"take aborted: StaleCommitError" in dumps[".flight/rank_0.jsonl"]
    assert {k: v for k, v in after.items() if k not in dumps} == newer_files
    dst = _state(0.0)
    Snapshot(snap).restore(dst)
    assert torch.equal(dst["model"]["w"], torch.arange(4096, dtype=torch.float32) * 2.0)


def test_a_failed_fence_plant_aborts_the_take(tmp_path) -> None:
    """The fence is the take's first write: when it fails, no payload is
    written and the take raises."""
    faultinject.configure("fs.write@1=permanent")
    with pytest.raises(faultinject.InjectedPermanentError):
        Snapshot.take(str(tmp_path / "snap"), _state())
    faultinject.disable()
    # No payload: the only files are the abort's flight dump, which shows
    # the fence plant that failed, and its stack dump (as in the JAX
    # package).
    files = _files(tmp_path / "snap")
    assert sorted(files) == [".flight/rank_0.jsonl", ".flight/rank_0.stacks.jsonl"]
    dump = files[".flight/rank_0.jsonl"]
    assert b"take aborted: InjectedPermanentError" in dump and b'"fence.plant"' in dump


def _partial(writer: str, path: str) -> None:
    """A take whose commit failed: payloads and its fence, no metadata."""
    if writer == "jax":
        jax_faultinject.configure("commit.metadata@1=permanent")
        with pytest.raises(Exception):
            J.Snapshot.take(path, {"app": J.StateDict(w=np.full(1024, 7.0, np.float32))})
        jax_faultinject.disable()
    else:
        faultinject.configure("commit.metadata@1=permanent")
        with pytest.raises(Exception):
            P.Snapshot.take(path, {"app": P.StateDict(w=torch.full((1024,), 7.0))})
        faultinject.disable()
    files = _files(path)
    assert SNAPSHOT_FENCE_FNAME in files and SNAPSHOT_METADATA_FNAME not in files
    assert len(files) >= 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_managers_gc_reclaims_the_other_packages_partial(tmp_path, writer) -> None:
    root = str(tmp_path / "ckpt")
    step_dir = os.path.join(root, f"step_{3:010d}")
    _partial(writer, step_dir)
    if writer == "jax":
        mgr = P.CheckpointManager(root, save_interval_steps=1)
        assert mgr.save(3, {"app": P.StateDict(w=torch.full((1024,), 3.0))}, force=True)
        dst = {"app": P.StateDict(w=torch.zeros(1024))}
        mgr.restore(dst)
        assert torch.equal(dst["app"]["w"], torch.full((1024,), 3.0))
    else:
        mgr = J.CheckpointManager(root, save_interval_steps=1)
        assert mgr.save(3, {"app": J.StateDict(w=np.full(1024, 3.0, np.float32))}, force=True)
        dst = {"app": J.StateDict(w=np.zeros(1024, np.float32))}
        mgr.restore(dst)
        np.testing.assert_array_equal(dst["app"]["w"], np.full(1024, 3.0, np.float32))
    assert mgr.all_steps() == [3]
    files = _files(step_dir)
    assert SNAPSHOT_FENCE_FNAME not in files and SNAPSHOT_METADATA_FNAME in files
