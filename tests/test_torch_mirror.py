"""The port's two-tier mirror (``storage_plugins/mirror.py``): counterparts
of ``tests/test_mirror_storage.py`` (its CLI test aside), the manager's
per-step mirror roots, the streamed-read failover, and mirrored snapshots
restored after the loss of the primary in the other package.

JAX is imported inside the tests that use it: the multi-process worker is
imported by spawned processes, which must not load JAX."""

from __future__ import annotations

import asyncio
import os
import shutil

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.storage_plugins import mirror as mirror_mod
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.mirror import MirroredStoragePlugin
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _state(v: float = 1.0) -> P.StateDict:
    return P.StateDict(
        w=torch.full((64, 32), v),
        nested={"b": torch.full((16,), v)},
        step=int(v),
    )


def _opts(mirror_dir, **extra):
    return {"mirror_url": str(mirror_dir), **extra}


def _payloads(root, needle: str = "") -> list:
    return [
        os.path.join(r, f)
        for r, _, fs in os.walk(root)
        for f in fs
        if f != SNAPSHOT_METADATA_FNAME and needle in os.path.join(r, f)
    ]


def test_take_commits_both_tiers(tmp_path) -> None:
    primary, mirror = tmp_path / "fast", tmp_path / "durable"
    P.Snapshot.take(str(primary), {"app": _state(3.0)}, storage_options=_opts(mirror))
    for root in (primary, mirror):
        dst = _state(0.0)
        P.Snapshot(str(root)).restore({"app": dst})
        assert torch.equal(dst["w"], torch.full((64, 32), 3.0))
        assert (root / SNAPSHOT_METADATA_FNAME).exists()
    meta = P.Snapshot(str(primary)).metadata
    assert meta.mirror_url == os.path.realpath(mirror) and meta.origin_mirrors is None


@pytest.mark.parametrize("streamed", [False, True])
def test_read_falls_back_to_mirror(tmp_path, monkeypatch, streamed) -> None:
    if streamed:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", "1024")
    primary, mirror = tmp_path / "fast", tmp_path / "durable"
    P.Snapshot.take(str(primary), {"app": _state(2.0)}, storage_options=_opts(mirror))
    victims = _payloads(primary, "w")
    assert victims
    for v in victims:
        os.remove(v)
    before = mirror_mod.failover_counts["mirror_failovers"]
    dst = _state(0.0)
    P.Snapshot(str(primary), storage_options=_opts(mirror)).restore({"app": dst})
    assert torch.equal(dst["w"], torch.full((64, 32), 2.0))
    assert mirror_mod.failover_counts["mirror_failovers"] - before == len(victims)


class _FaultyMirror(FSStoragePlugin):
    async def write(self, write_io: WriteIO) -> None:
        if write_io.path != SNAPSHOT_METADATA_FNAME:
            raise RuntimeError("mirror down")
        await super().write(write_io)


def test_mirror_failure_keeps_primary_and_never_commits_mirror(tmp_path) -> None:
    primary, mirror = tmp_path / "fast", tmp_path / "durable"
    plugin = MirroredStoragePlugin(
        primary=FSStoragePlugin(str(primary)), mirror=_FaultyMirror(str(mirror)),
        metadata_filename=SNAPSHOT_METADATA_FNAME,
    )
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(plugin.write(WriteIO(path="0/app/w", buf=b"abcd")))
        loop.run_until_complete(plugin.write(WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=b"meta")))
        with pytest.raises(RuntimeError, match="mirror write"):
            loop.run_until_complete(plugin.close())
    finally:
        loop.close()
    assert (primary / "0/app/w").read_bytes() == b"abcd"
    assert (primary / SNAPSHOT_METADATA_FNAME).read_bytes() == b"meta"
    assert not (mirror / SNAPSHOT_METADATA_FNAME).exists()


def test_strict_mirror_failure_raises_from_sync_take(tmp_path) -> None:
    primary = tmp_path / "fast"
    bad_mirror = tmp_path / "durable"
    bad_mirror.write_bytes(b"not a directory")  # every mirror write fails
    with pytest.raises(RuntimeError, match="mirror write"):
        P.Snapshot.take(str(primary), {"app": _state(7.0)}, storage_options=_opts(bad_mirror))
    dst = _state(0.0)
    P.Snapshot(str(primary)).restore({"app": dst})
    assert torch.equal(dst["w"], torch.full((64, 32), 7.0))

    P.Snapshot.take(str(tmp_path / "fast2"), {"app": _state(8.0)},
                    storage_options=_opts(bad_mirror, mirror_strict=False))
    # A take called inside an except block still raises the mirror error.
    try:
        raise ValueError("ambient caller exception")
    except ValueError:
        with pytest.raises(RuntimeError, match="mirror write"):
            P.Snapshot.take(str(tmp_path / "fast3"), {"app": _state(9.0)},
                            storage_options=_opts(bad_mirror))


def test_strict_mirror_failure_reaches_async_wait(tmp_path) -> None:
    bad_mirror = tmp_path / "durable"
    bad_mirror.write_bytes(b"not a directory")
    pending = P.Snapshot.async_take(str(tmp_path / "fast"), {"app": _state(4.0)},
                                    storage_options=_opts(bad_mirror))
    with pytest.raises(RuntimeError, match="mirror write"):
        pending.wait()


def test_mirror_failure_nonstrict_warns_only(tmp_path) -> None:
    plugin = MirroredStoragePlugin(
        primary=FSStoragePlugin(str(tmp_path / "fast")), mirror=_FaultyMirror(str(tmp_path / "d")),
        metadata_filename=SNAPSHOT_METADATA_FNAME, strict=False,
    )
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(plugin.write(WriteIO(path="x", buf=b"1")))
        loop.run_until_complete(plugin.close())  # no raise
    finally:
        loop.close()


class _SlowMirror(FSStoragePlugin):
    async def write(self, write_io: WriteIO) -> None:
        await asyncio.sleep(0.02)
        await super().write(write_io)


def test_backlog_backpressure_bounds_retained_bytes(tmp_path) -> None:
    mirror = tmp_path / "durable"
    plugin = MirroredStoragePlugin(
        primary=FSStoragePlugin(str(tmp_path / "fast")), mirror=_SlowMirror(str(mirror)),
        metadata_filename=SNAPSHOT_METADATA_FNAME, backlog_bytes=3000,
    )
    peak = 0

    async def run():
        nonlocal peak

        async def one(i):
            nonlocal peak
            await plugin.write(WriteIO(path=f"p{i}", buf=b"x" * 1000))
            peak = max(peak, plugin._backlog_bytes)

        await asyncio.gather(*(one(i) for i in range(12)))
        await plugin.close()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(run())
    finally:
        loop.close()
    assert peak <= 3000
    for i in range(12):
        assert (mirror / f"p{i}").read_bytes() == b"x" * 1000


def test_backlog_condition_follows_the_driving_loop(tmp_path) -> None:
    """One plugin driven by two event loops in turn (a handle reused by
    blocking calls): the backlog condition is made on each."""
    plugin = MirroredStoragePlugin(
        primary=FSStoragePlugin(str(tmp_path / "fast")), mirror=_SlowMirror(str(tmp_path / "d")),
        metadata_filename=SNAPSHOT_METADATA_FNAME, backlog_bytes=1,
    )
    for i in range(2):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(plugin.write(WriteIO(path=f"a{i}", buf=b"y" * 10)))
            loop.run_until_complete(plugin.write(WriteIO(path=f"b{i}", buf=b"y" * 10)))
            loop.run_until_complete(plugin.drain_background())
        finally:
            loop.close()
    assert plugin._backlog_bytes == 0
    assert sorted(os.listdir(tmp_path / "d")) == ["a0", "a1", "b0", "b1"]


def test_async_take_with_mirror(tmp_path) -> None:
    primary, mirror = tmp_path / "fast", tmp_path / "durable"
    P.Snapshot.async_take(str(primary), {"app": _state(5.0)},
                          storage_options=_opts(mirror)).wait()
    for root in (primary, mirror):
        dst = _state(0.0)
        P.Snapshot(str(root)).restore({"app": dst})
        assert torch.equal(dst["w"], torch.full((64, 32), 5.0))


def test_incremental_take_with_mirror_strips_mirror_for_base(tmp_path) -> None:
    base_p, base_m = str(tmp_path / "b_fast"), str(tmp_path / "b_durable")
    inc_p, inc_m = str(tmp_path / "i_fast"), str(tmp_path / "i_durable")
    P.Snapshot.take(base_p, {"app": _state(1.0)}, storage_options={"mirror_url": base_m},
                    record_digests=True)
    P.Snapshot.take(inc_p, {"app": _state(1.0)}, storage_options={"mirror_url": inc_m},
                    incremental_base=base_p)
    for root in (inc_p, inc_m):
        assert not _payloads(root, "/w"), root
    dst = _state(0.0)
    P.Snapshot(inc_m).restore({"app": dst})
    assert torch.equal(dst["w"], torch.full((64, 32), 1.0))


def test_incremental_mirror_survives_total_primary_loss(tmp_path) -> None:
    from torchsnapshot_tpu_torch.dedup import canonical_base_url

    base_p, base_m = str(tmp_path / "b_fast"), str(tmp_path / "b_durable")
    inc_p, inc_m = str(tmp_path / "i_fast"), str(tmp_path / "i_durable")
    P.Snapshot.take(base_p, {"app": _state(1.0)}, storage_options={"mirror_url": base_m},
                    record_digests=True)
    P.Snapshot.take(inc_p, {"app": _state(1.0)}, storage_options={"mirror_url": inc_m},
                    incremental_base=base_p)
    meta = P.Snapshot(inc_m).metadata
    assert meta.origin_mirrors.get(canonical_base_url(base_p)) == canonical_base_url(base_m)
    shutil.rmtree(base_p)
    shutil.rmtree(inc_p)
    dst = _state(0.0)
    P.Snapshot(inc_m).restore({"app": dst})
    assert torch.equal(dst["w"], torch.full((64, 32), 1.0))
    assert torch.equal(dst["nested"]["b"], torch.full((16,), 1.0))


def test_chained_origin_mirrors_propagate(tmp_path) -> None:
    from torchsnapshot_tpu_torch.dedup import canonical_base_url

    paths = {n: (str(tmp_path / f"{n}_fast"), str(tmp_path / f"{n}_dur")) for n in "abc"}

    def chain_state(head):
        return P.StateDict(frozen=torch.arange(512, dtype=torch.float32).reshape(32, 16),
                           head=torch.full((8,), float(head)), step=int(head))

    P.Snapshot.take(paths["a"][0], {"app": chain_state(1)},
                    storage_options={"mirror_url": paths["a"][1]}, record_digests=True)
    P.Snapshot.take(paths["b"][0], {"app": chain_state(2)},
                    storage_options={"mirror_url": paths["b"][1]}, incremental_base=paths["a"][0])
    P.Snapshot.take(paths["c"][0], {"app": chain_state(3)},
                    storage_options={"mirror_url": paths["c"][1]}, incremental_base=paths["b"][0])
    assert canonical_base_url(paths["a"][0]) in (P.Snapshot(paths["c"][1]).metadata.origin_mirrors)
    for n in "abc":
        shutil.rmtree(paths[n][0])
    dst = P.StateDict(frozen=torch.zeros(32, 16), head=torch.zeros(8), step=0)
    P.Snapshot(paths["c"][1]).restore({"app": dst})
    assert torch.equal(dst["frozen"], torch.arange(512, dtype=torch.float32).reshape(32, 16))
    assert torch.equal(dst["head"], torch.full((8,), 3.0)) and dst["step"] == 3


def test_missing_origin_names_base_and_mirror(tmp_path) -> None:
    base_p, base_m = str(tmp_path / "b_fast"), str(tmp_path / "b_dur")
    inc = str(tmp_path / "inc")
    P.Snapshot.take(base_p, {"app": _state(1.0)}, storage_options={"mirror_url": base_m},
                    record_digests=True)
    P.Snapshot.take(inc, {"app": _state(1.0)}, incremental_base=base_p)
    shutil.rmtree(base_p)
    shutil.rmtree(base_m)
    with pytest.raises(RuntimeError, match="or its mirror"):
        P.Snapshot(inc).restore({"app": _state(0.0)})


def _mirror_worker(rank: int, world_size: int, primary: str, mirror: str) -> str:
    import torch

    import torchsnapshot_tpu_torch as P

    state = {
        "model": P.StateDict(w=torch.arange(128, dtype=torch.float32)),
        "local": P.StateDict(r=torch.full((4,), rank, dtype=torch.int32)),
    }
    P.Snapshot.take(primary, state, replicated=["model/*"], storage_options={"mirror_url": mirror})
    return "ok"


def test_multiprocess_mirror_commit_is_complete(tmp_path) -> None:
    """Every rank's payload mirrors drain before the commit barrier, so the
    mirror's metadata never names a payload it lacks."""
    primary, mirror = str(tmp_path / "fast"), str(tmp_path / "durable")
    results = run_with_subprocesses(_mirror_worker, 2, primary, mirror)
    assert set(results.values()) == {"ok"}
    for rank in range(2):
        state = P.Snapshot(mirror).read_state_dict(rank=rank)
        assert torch.equal(state["model"]["w"], torch.arange(128, dtype=torch.float32))
        assert torch.equal(state["local"]["r"], torch.full((4,), rank, dtype=torch.int32))


def test_consolidate_after_primary_loss(tmp_path) -> None:
    from torchsnapshot_tpu_torch.dedup import consolidate

    base_p, base_m = str(tmp_path / "b_fast"), str(tmp_path / "b_dur")
    inc_p, inc_m = str(tmp_path / "i_fast"), str(tmp_path / "i_dur")
    P.Snapshot.take(base_p, {"app": _state(1.0)}, storage_options={"mirror_url": base_m},
                    record_digests=True)
    P.Snapshot.take(inc_p, {"app": _state(1.0)}, storage_options={"mirror_url": inc_m},
                    incremental_base=base_p)
    shutil.rmtree(base_p)
    shutil.rmtree(inc_p)
    flat = str(tmp_path / "flat")
    consolidate(inc_m, flat)
    meta = P.Snapshot(flat).metadata
    assert meta.origin_mirrors is None and meta.mirror_url is None
    shutil.rmtree(base_m)
    dst = _state(0.0)
    P.Snapshot(flat).restore({"app": dst})
    assert torch.equal(dst["w"], torch.full((64, 32), 1.0))


def test_primary_read_fault_site_drives_the_failover(tmp_path) -> None:
    from torchsnapshot_tpu_torch import faultinject

    primary, mirror = tmp_path / "fast", tmp_path / "durable"
    P.Snapshot.take(str(primary), {"app": _state(6.0)}, storage_options=_opts(mirror))
    assert faultinject.SITES["mirror.primary_read"] == "control"
    faultinject.configure("mirror.primary_read@1+=permanent")
    try:
        dst = _state(0.0)
        P.Snapshot(str(primary), storage_options=_opts(mirror)).restore({"app": dst})
    finally:
        faultinject.disable()
    assert torch.equal(dst["w"], torch.full((64, 32), 6.0))


def test_both_tiers_failing_raises_with_fallback_history(tmp_path) -> None:
    plugin = MirroredStoragePlugin(
        primary=FSStoragePlugin(str(tmp_path / "a")), mirror=FSStoragePlugin(str(tmp_path / "b")),
        metadata_filename=SNAPSHOT_METADATA_FNAME,
    )
    with pytest.raises(FileNotFoundError) as info:
        asyncio.run(plugin.read(ReadIO(path="nowhere")))
    assert info.value.retry_attempts == 1 and info.value.retry_error_kind == "other"


def test_manager_mirrors_each_step_into_its_own_root(tmp_path) -> None:
    root, mroot = tmp_path / "ckpt", tmp_path / "mirror"
    mgr = P.CheckpointManager(str(root), storage_options=_opts(mroot))
    mgr.save(0, {"app": _state(1.0)})
    mgr.save(1, {"app": _state(2.0)})
    assert sorted(os.listdir(mroot)) == ["step_0000000000", "step_0000000001"]
    shutil.rmtree(root / "step_0000000001" / "0")
    dst = _state(0.0)
    assert mgr.restore({"app": dst}) == 1
    assert torch.equal(dst["w"], torch.full((64, 32), 2.0))
    # A crashed mirrored save's partial trees go on both tiers.
    for r in (root, mroot):
        os.makedirs(r / "step_0000000002" / "0")
    mgr.save(2, {"app": _state(3.0)})
    assert (mroot / "step_0000000002" / SNAPSHOT_METADATA_FNAME).exists()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mirrored_snapshot_restores_in_the_other_package_after_primary_loss(tmp_path, writer):
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    primary, mirror = str(tmp_path / "fast"), str(tmp_path / "durable")
    if writer == "port":
        P.Snapshot.take(primary, {"app": P.StateDict(w=torch.from_numpy(w.copy()), step=3)},
                        storage_options=_opts(mirror))
    else:
        J.Snapshot.take(primary, {"app": J.StateDict(w=jnp.asarray(w), step=3)},
                        storage_options=_opts(mirror))
    shutil.rmtree(primary)
    os.makedirs(primary)
    shutil.copy(os.path.join(mirror, SNAPSHOT_METADATA_FNAME), primary)  # payloads lost
    if writer == "port":
        dst = J.StateDict(w=jnp.zeros((64, 32), jnp.float32), step=0)
        J.Snapshot(primary, storage_options=_opts(mirror)).restore({"app": dst})
        got = np.asarray(dst["w"])
    else:
        dst = P.StateDict(w=torch.zeros(64, 32), step=0)
        P.Snapshot(primary, storage_options=_opts(mirror)).restore({"app": dst})
        got = dst["w"].numpy()
    assert np.array_equal(got, w) and dst["step"] == 3
