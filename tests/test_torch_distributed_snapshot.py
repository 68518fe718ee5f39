"""Snapshots across processes, in real worlds, against the JAX package.

Three spawned worlds share this module (gloo on the CPU, the port's store
for every coordination): a world of 2 takes DTensor state (``Shard(0)``
and ``Shard(1)``, a fully ``Replicate`` leaf that is auto-detected as
replicated, striped replicated chunks and objects, per-rank leaves), then
checks async_take, the replication glob negotiation, a failing
``state_dict`` and a failing async write (nothing committed on any
rank), the zero-byte distributed preverify (partial-digest dispatches
counted, payload bytes read counted), a multi-rank CheckpointManager (GC
and retention on rank 0) with the collective preemption decision, and
restores a snapshot the JAX package wrote sharded over 8 virtual devices.
A world of 4 restores the world of 2's snapshot on a 2 x 2 mesh (2 -> 4)
and the JAX snapshot, and takes its own, which a second world of 2
restores (4 -> 2). In this process the JAX package restores the port
worlds' snapshots under 8-device NamedShardings and into numpy, and
``read_object``/``read_state_dict`` of both packages agree.
"""

from __future__ import annotations

import os
import signal

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]


def _arrays(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((16, 24)).astype(np.float32),
        "e": rng.standard_normal((4, 7)).astype(np.float32),  # Shard(1): 4, 3 columns
        "b": rng.standard_normal((6,)).astype(np.float32),  # Replicate: auto-detected
        "h": rng.standard_normal((8, 8)).astype(np.float32),  # kept as bf16
        "big": rng.standard_normal((64, 16)).astype(np.float32),  # replicated glob, chunked
    }


def _full(name: str) -> torch.Tensor:
    t = torch.from_numpy(_arrays()[name])
    return t.to(torch.bfloat16) if name == "h" else t


def _dt(full: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch.io_preparers.sharded import shard_boxes

    box = shard_boxes(full.shape, mesh.mesh, placements)[mesh.get_rank()]
    local = full[tuple(slice(lo, hi) for lo, hi in box)].clone()
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride()
    )


def _local_expected(dt, full: torch.Tensor) -> bool:
    from torchsnapshot_tpu_torch.io_preparers.sharded import dtensor_view

    view = dtensor_view(dt)
    want = full[tuple(slice(lo, hi) for lo, hi in view.local_box)]
    return view.local.dtype == want.dtype and torch.equal(view.local, want)


LAYOUT_2 = {"w": "S0", "e": "S1", "b": "R", "h": "S0", "big": "R"}


def _placements(code: str, ndim_mesh: int):
    from torch.distributed.tensor import Replicate, Shard

    one = {"S0": Shard(0), "S1": Shard(1), "R": Replicate()}
    if ndim_mesh == 1:
        return [one[code]]
    # 2 x 2: a second dim split over the second axis where the tensor has one
    return {"S0": [Shard(0), Shard(1)], "S1": [Shard(1), Shard(0)], "R": [Replicate(), Shard(0)]}[
        code
    ]


def _app(mesh, ndim_mesh: int, fill=None, layout=LAYOUT_2):
    from torchsnapshot_tpu_torch import StateDict

    out = {}
    for name, code in layout.items():
        full = _full(name)
        if fill is not None:
            full = torch.full_like(full, fill)
        out[name] = _dt(full, mesh, _placements(code, ndim_mesh))
    return StateDict(out)


class _Spy:
    """Counts payload bytes read and the paths written through the fs
    plugin, and K4 partial-form dispatches."""

    def __init__(self, monkeypatch_like) -> None:
        from torchsnapshot_tpu_torch import device_digest
        from torchsnapshot_tpu_torch.storage_plugins import fs

        self.read_bytes = 0
        self.written = []
        self.partials = 0
        orig_read, orig_write = fs.FSStoragePlugin.read, fs.FSStoragePlugin.write
        orig_partial = device_digest.partial_dispatch
        spy = self

        async def read(plugin, read_io):
            await orig_read(plugin, read_io)
            if not os.path.basename(read_io.path).startswith("."):
                spy.read_bytes += memoryview(read_io.buf).nbytes

        async def write(plugin, write_io):
            spy.written.append(write_io.path)
            await orig_write(plugin, write_io)

        def partial(*args, **kwargs):
            spy.partials += 1
            return orig_partial(*args, **kwargs)

        monkeypatch_like(fs.FSStoragePlugin, "read", read)
        monkeypatch_like(fs.FSStoragePlugin, "write", write)
        monkeypatch_like(device_digest, "partial_dispatch", partial)


def _world2_worker(rank: int, world: int, root: str, jax_root: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import CheckpointManager, PreemptionWatcher, Snapshot, StateDict
    from torchsnapshot_tpu_torch import faultinject
    from torchsnapshot_tpu_torch.io_preparers import chunked

    chunked.DEFAULT_MAX_CHUNK_SIZE_BYTES = 1024  # "big" is 4 chunks of 16 rows
    mesh = init_device_mesh("cpu", (world,))
    out = {}
    spy = _Spy(setattr)

    # (a) take: DTensors, an auto-detected Replicate leaf, striped
    # replicated chunks and objects, a per-rank leaf and a primitive.
    app = _app(mesh, 1)
    meta = StateDict(r=torch.full((3,), float(rank)), step=7)
    shared = StateDict(o={1, 2}, o2={"object"})
    state = {"app": app, "meta": meta, "shared": shared}
    spy.written.clear()
    Snapshot.take(f"{root}/sync", state, replicated=["app/big", "shared/*"], device_digests=True)
    out["written"] = sorted(spy.written)
    # (b) async_take
    Snapshot.async_take(f"{root}/async", state, replicated=["app/big", "shared/*"]).wait()
    # (c) the replication glob negotiation: only what every rank claims
    globs = ["shared/o", "shared/o2"] if rank == 0 else ["shared/o"]
    Snapshot.take(f"{root}/glob", {"shared": shared}, replicated=globs)
    manifest = Snapshot(f"{root}/glob").get_manifest()
    out["glob"] = {lp: bool(manifest[f"{rank}/{lp}"].replicated) for lp in ("shared/o", "shared/o2")}

    # (d) a failing state_dict on rank 1 aborts every rank
    class Failing:
        def state_dict(self):
            if rank == 1:
                raise ValueError("state_dict failed on rank 1")
            return {"x": torch.ones(2)}

        def load_state_dict(self, sd):
            pass

    try:
        Snapshot.take(f"{root}/abort", {"app": app, "bad": Failing()})
        out["abort"] = "committed"
    except BaseException as e:  # noqa: B036 - the outcome under test
        out["abort"] = type(e).__name__
    out["abort_committed"] = os.path.exists(f"{root}/abort/.snapshot_metadata")
    # (e) an async write failing on rank 1 commits nothing on any rank
    if rank == 1:
        faultinject.configure("fs.write@1=permanent")
    try:
        Snapshot.async_take(f"{root}/async_fail", {"app": app}).wait()
        out["async_fail"] = "committed"
    except BaseException as e:  # noqa: B036 - the outcome under test
        out["async_fail"] = type(e).__name__
    finally:
        faultinject.disable()
    dist.barrier()
    out["async_fail_committed"] = os.path.exists(f"{root}/async_fail/.snapshot_metadata")

    # (f) the zero-byte preverify: destinations that hold the bytes in
    # another layout (pieces cut across the ranks) read nothing.
    flipped = {"w": "S1", "e": "S0", "b": "R", "h": "S1", "big": "R"}
    dst = _app(mesh, 1, layout=flipped)
    spy.read_bytes, spy.partials = 0, 0
    Snapshot(f"{root}/sync").restore({"app": dst}, device_digests=True)
    out["zero_read_bytes"] = spy.read_bytes
    out["zero_partials"] = spy.partials
    out["zero_exact"] = all(_local_expected(dst[n], _full(n)) for n in flipped)
    zeros = _app(mesh, 1, fill=0.0, layout=flipped)
    spy.read_bytes = 0
    Snapshot(f"{root}/sync").restore({"app": zeros}, device_digests=True)
    out["changed_read_bytes"] = spy.read_bytes
    out["changed_exact"] = all(_local_expected(zeros[n], _full(n)) for n in flipped)
    zeros = _app(mesh, 1, fill=0.0, layout=flipped)
    Snapshot(f"{root}/sync").async_restore({"app": zeros}).wait()
    out["async_restore"] = all(_local_expected(zeros[n], _full(n)) for n in flipped)
    # read_object (gathered whole) and read_state_dict of another rank
    out["read_object_w"] = torch.equal(Snapshot(f"{root}/sync").read_object("0/app/w"), _full("w"))
    sd = Snapshot(f"{root}/sync").read_state_dict(rank=1 - rank)
    out["read_state_dict"] = all(
        torch.equal(sd["app"][n], _full(n)) for n in LAYOUT_2
    ) and torch.equal(sd["meta"]["r"], torch.full((3,), float(1 - rank))) and sd["meta"]["step"] == 7

    # (g) a multi-rank manager: rank 0 reclaims and retains
    mgr = CheckpointManager(f"{root}/mgr", keep_last=1)
    for step in range(3):
        mgr.save(step, {"app": app})
    if rank == 0:
        os.makedirs(f"{root}/mgr/step_0000000003")
        open(f"{root}/mgr/step_0000000003/junk", "wb").close()
    dist.barrier()
    mgr.save(4, {"app": app})
    dist.barrier()
    # The root also holds the takes' history (.telemetry_history.jsonl).
    out["mgr_steps"] = sorted(n for n in os.listdir(f"{root}/mgr") if n.startswith("step_"))
    out["mgr_latest"] = mgr.latest_step()
    # (h) the collective preemption decision
    watcher = PreemptionWatcher(signals=(signal.SIGUSR1,))
    try:
        out["preempt_before"] = watcher.should_save()
        if rank == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        dist.barrier()
        out["preempt_after"] = watcher.should_save()
    finally:
        watcher.close()

    # (i) the JAX package's snapshot, sharded over 8 devices, into DTensors
    dst = _app(mesh, 1, fill=0.0, layout={"w": "S0", "e": "S1", "h": "S1"})
    Snapshot(jax_root).restore({"app": dst})
    out["from_jax"] = all(_local_expected(dst[n], _full(n)) for n in ("w", "e", "h"))
    return out


def _world4_worker(rank: int, world: int, root: str, jax_root: str):
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    mesh = init_device_mesh("cpu", (2, 2))
    out = {}
    # 2 -> 4: the world of 2's snapshot on a 2 x 2 mesh, the replicated
    # and per-rank leaves of rank 0 and 1 visible as the elasticity rules say
    dst = _app(mesh, 2, fill=0.0)
    shared = StateDict(o=None, o2=None)
    Snapshot(f"{root}/sync").restore({"app": dst, "shared": shared})
    out["elastic_2_to_4"] = all(_local_expected(dst[n], _full(n)) for n in LAYOUT_2)
    out["shared"] = (shared["o"], shared["o2"])
    try:  # a per-rank leaf of a rank the old world did not have
        Snapshot(f"{root}/sync").restore({"meta": StateDict(r=torch.ones(3), step=0)})
        out["per_rank"] = "restored"
    except RuntimeError as e:
        out["per_rank"] = str(e)
    dst = _app(mesh, 2, fill=0.0, layout={"w": "S0", "e": "S1", "h": "S1"})
    Snapshot(jax_root).restore({"app": dst})
    out["from_jax"] = all(_local_expected(dst[n], _full(n)) for n in ("w", "e", "h"))
    # A torch group over the whole world gives the identity. Two disjoint
    # subgroups (HSDP's replicate groups) taking at once raise by name,
    # and so does a rank outside a group: none consumes a handshake, so
    # the whole-world take below still meets every rank.
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    whole = PGWrapper(dist.group.WORLD)
    out["torch_world_group"] = (
        whole.get_rank(), whole.get_world_size(), whole.all_gather_object(rank)
    )
    whole.retire()
    subgroups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    for name, group in (("subgroup_take", subgroups[rank // 2]),
                        ("outside_group_take", subgroups[1 - rank // 2])):
        try:
            Snapshot.take(f"{root}/sub{rank // 2}", {"app": StateDict(w=torch.ones(2))}, pg=group)
            out[name] = "taken"
        except ValueError as e:
            out[name] = str(e)
    Snapshot.take(f"{root}/w4", {"app": _app(mesh, 2)})
    return out


def _world2b_worker(rank: int, world: int, root: str):
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import Snapshot

    mesh = init_device_mesh("cpu", (world,))
    dst = _app(mesh, 1, fill=0.0)
    Snapshot(f"{root}/w4").restore({"app": dst})
    return {"elastic_4_to_2": all(_local_expected(dst[n], _full(n)) for n in LAYOUT_2)}


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """The JAX package's snapshot, sharded over its 8 virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import torchsnapshot_tpu as J

    root = str(tmp_path_factory.mktemp("jax") / "snap")
    devs = np.array(jax.devices()[:8])
    a = _arrays()
    state = {
        "w": jax.device_put(jnp.asarray(a["w"]), NamedSharding(Mesh(devs, ("x",)), PartitionSpec("x"))),
        "e": jax.device_put(
            jnp.asarray(a["e"]).astype(jnp.float32),
            NamedSharding(Mesh(devs.reshape(4, 2), ("x", "y")), PartitionSpec("x", None)),
        ),
        "h": jax.device_put(
            jnp.asarray(a["h"]).astype(jnp.bfloat16),
            NamedSharding(Mesh(devs.reshape(2, 4), ("x", "y")), PartitionSpec("x", "y")),
        ),
    }
    J.Snapshot.take(root, {"app": J.StateDict(state)})
    return root


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_root):
    root = str(tmp_path_factory.mktemp("worlds"))
    w2 = run_with_subprocesses(_world2_worker, 2, root, jax_root, backend="gloo", timeout=240)
    w4 = run_with_subprocesses(_world4_worker, 4, root, jax_root, backend="gloo", timeout=240)
    w2b = run_with_subprocesses(_world2b_worker, 2, root, backend="gloo", timeout=240)
    return root, w2, w4, w2b


RANKS2 = [0, 1]


def test_replicated_units_are_striped_and_written_once(worlds) -> None:
    root, w2, _, _ = worlds
    written = [set(w2[r]["written"]) for r in RANKS2]
    assert not written[0] & written[1] - {".snapshot_fence"}
    repl = [
        {p for p in written[r] if p.startswith("replicated/")} for r in RANKS2
    ]
    assert repl[0] and repl[1]  # both ranks write replicated units
    on_disk = set()
    for dirpath, _, names in os.walk(os.path.join(root, "sync", "replicated")):
        on_disk |= {os.path.relpath(os.path.join(dirpath, n), os.path.join(root, "sync")) for n in names}
    assert on_disk == repl[0] | repl[1]
    assert {p for p in on_disk if p.startswith("replicated/app/big")} == {
        f"replicated/app/big_{o}_0" for o in (0, 16, 32, 48)
    }
    # The Replicate DTensor was auto-detected, sharded pieces went to sharded/.
    assert "replicated/app/b_0" in on_disk
    assert all(p.startswith(("sharded/", "replicated/", f"{r}/")) for r in RANKS2
               for p in written[r] - {".snapshot_fence", ".snapshot_metadata"})


@pytest.mark.parametrize("path", ["sync", "async"])
def test_world_of_two_restores_into_one_process(worlds, path) -> None:
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    root = worlds[0]
    dst = StateDict({n: torch.zeros_like(_full(n)) for n in LAYOUT_2})
    meta = StateDict(r=torch.ones(3), step=0)
    shared = StateDict(o=None, o2=None)
    Snapshot(f"{root}/{path}").restore({"app": dst, "meta": meta, "shared": shared})
    for n in LAYOUT_2:
        assert torch.equal(dst[n], _full(n)), n
    assert torch.equal(meta["r"], torch.zeros(3)) and meta["step"] == 7
    assert shared["o"] == {1, 2} and shared["o2"] == {"object"}


def test_replication_is_what_every_rank_claims(worlds) -> None:
    _, w2, _, _ = worlds
    for r in RANKS2:
        assert w2[r]["glob"] == {"shared/o": True, "shared/o2": False}


@pytest.mark.parametrize("case", ["abort", "async_fail"])
def test_a_failure_on_one_rank_commits_nothing(worlds, case) -> None:
    _, w2, _, _ = worlds
    for r in RANKS2:
        assert w2[r][case] != "committed"
        assert w2[r][f"{case}_committed"] is False


def test_zero_byte_distributed_preverify(worlds) -> None:
    _, w2, _, _ = worlds
    for r in RANKS2:
        assert w2[r]["zero_read_bytes"] == 0
        assert w2[r]["zero_partials"] >= 1
        assert w2[r]["zero_exact"]
        assert w2[r]["changed_read_bytes"] > 0 and w2[r]["changed_exact"]


@pytest.mark.parametrize("rank", RANKS2)
@pytest.mark.parametrize("read", ["read_object_w", "read_state_dict", "from_jax", "async_restore"])
def test_reads_in_a_world(worlds, rank, read) -> None:
    assert worlds[1][rank][read] is True


def test_manager_gc_and_retention_on_rank_zero(worlds) -> None:
    _, w2, _, _ = worlds
    for r in RANKS2:
        assert w2[r]["mgr_steps"] == ["step_0000000004"]
        assert w2[r]["mgr_latest"] == 4


def test_collective_preemption_decision(worlds) -> None:
    _, w2, _, _ = worlds
    assert [w2[r]["preempt_before"] for r in RANKS2] == [False, False]
    assert [w2[r]["preempt_after"] for r in RANKS2] == [True, True]


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", ["elastic_2_to_4", "from_jax"])
def test_world_of_four(worlds, rank, case) -> None:
    assert worlds[2][rank][case] is True


def test_world_of_four_follows_the_elasticity_rules(worlds) -> None:
    """Replicated leaves restore on every rank of the larger world; a
    per-rank leaf only on the ranks that saved one."""
    for rank in range(4):
        assert worlds[2][rank]["shared"] == ({1, 2}, {"object"})
        if rank < 2:
            assert worlds[2][rank]["per_rank"] == "restored"
        else:
            assert "Unable to find entry for 'meta/r'" in worlds[2][rank]["per_rank"]


@pytest.mark.parametrize("rank", range(4))
def test_disjoint_torch_subgroups_raise_by_name(worlds, rank) -> None:
    w4 = worlds[2]
    assert w4[rank]["torch_world_group"] == (rank, 4, [0, 1, 2, 3])
    mine = [0, 1] if rank < 2 else [2, 3]
    assert f"subgroup of global ranks {mine}" in w4[rank]["subgroup_take"]
    assert "outside a torch.distributed subgroup" in w4[rank]["outside_group_take"]


@pytest.mark.parametrize("rank", RANKS2)
def test_elasticity_four_to_two(worlds, rank) -> None:
    assert worlds[3][rank]["elastic_4_to_2"] is True


def test_jax_snapshot_restores_into_one_process(jax_root) -> None:
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    dst = StateDict({n: torch.zeros_like(_full(n)) for n in ("w", "e", "h")})
    Snapshot(jax_root).restore({"app": dst})
    for n in ("w", "e", "h"):
        assert torch.equal(dst[n], _full(n)), n


@pytest.mark.parametrize("path", ["sync", "w4"])
def test_jax_restores_port_worlds_snapshots(worlds, path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import torchsnapshot_tpu as J
    from torchsnapshot_tpu_torch import Snapshot

    root = worlds[0]
    devs = np.array(jax.devices()[:8])
    a = _arrays()
    sharding = NamedSharding(Mesh(devs.reshape(4, 2), ("x", "y")), PartitionSpec("y", "x"))
    dst = {
        "w": jax.device_put(jnp.zeros((16, 24), jnp.float32), sharding),
        "e": np.zeros((4, 7), np.float32),
        "b": np.zeros((6,), np.float32),
        "h": jax.device_put(jnp.zeros((8, 8), jnp.bfloat16), sharding),
        "big": np.zeros((64, 16), np.float32),
    }
    holder = J.StateDict(dst)
    J.Snapshot(f"{root}/{path}").restore({"app": holder})
    for n in ("w", "e", "b", "big"):
        assert np.asarray(holder[n]).tobytes() == a[n].tobytes(), n
    assert np.asarray(holder["h"]).tobytes() == _full("h").view(torch.int16).numpy().tobytes()
    # read_object and read_state_dict agree between the packages.
    jsd = J.Snapshot(f"{root}/{path}").read_state_dict("app")
    psd = Snapshot(f"{root}/{path}").read_state_dict("app")
    for n in LAYOUT_2:
        assert np.asarray(jsd[n]).tobytes() == psd[n].contiguous().view(torch.uint8).numpy().tobytes()
        got = Snapshot(f"{root}/{path}").read_object(f"0/app/{n}")
        assert np.asarray(J.Snapshot(f"{root}/{path}").read_object(f"0/app/{n}")).tobytes() == (
            got.contiguous().view(torch.uint8).numpy().tobytes()
        )
