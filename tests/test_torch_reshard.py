"""The planned reshard (``reshard.py``) and its restore wiring, against the
JAX package.

Pure: for layouts where DTensor's tiling (``sharded.shard_boxes``, one box
a rank) and GSPMD's (``jax.sharding.NamedSharding.devices_indices_map``,
one device a rank) cut alike (tp2 -> tp4, rows -> columns, 2 -> 1, a 2-D
mesh), the two packages compute the same boxes, the same plan, the same
byte accounting and the same per-rank roles, and their owners send
byte-identical bundles (bf16 included: torch byte views against
ml_dtypes). A simulation moves every byte of a plan through the port's
roles: each destination byte lands exactly once, bit-exact.

Worlds (gloo on the CPU, the port's store for all coordination): a world of
2 saves a ``Shard(0)`` tensor and restores it as ``Shard(1)`` under every
peer fault the JAX package drills (a corrupt, truncated or delayed bundle,
the owner's channel dying, env skew) and counts the restore's flag
all-gathers; a world of 4 restores it tp2 -> tp4 planned and direct, and
restores a snapshot the JAX package wrote under ``RESHARD=always`` and
``COOP_RESTORE=always``; a last world of 2 SIGKILLs an owner at its
forwarding boundary.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchsnapshot_tpu.reshard as JR
from torchsnapshot_tpu import layout as JL
from torchsnapshot_tpu import manifest as JM
from torchsnapshot_tpu_torch import fanout as F
from torchsnapshot_tpu_torch import layout as PL
from torchsnapshot_tpu_torch import manifest as PM
from torchsnapshot_tpu_torch import reshard as R
from torchsnapshot_tpu_torch.io_preparers.sharded import _overlap, shard_boxes
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

# (shape, source mesh, source spec, destination mesh, destination spec)
LAYOUTS = {
    "tp2_to_tp4": ((16, 8), [("x", 2)], [("x",)], [("x", 4)], [(), ("x",)]),
    "rows_to_cols": ((16, 8), [("x", 2)], [("x",)], [("x", 2)], [(), ("x",)]),
    "two_to_one": ((16, 8), [("x", 2)], [("x",)], [("x", 1)], [(), ()]),
    "tp4_to_tp2": ((16, 8), [("x", 4)], [(), ("x",)], [("x", 2)], [("x",)]),
    "2d_transposed": ((24, 12), [("x", 2), ("y", 2)], [("x",), ("y",)],
                      [("x", 2), ("y", 2)], [("y",), ("x",)]),
    "2d_to_cols": ((24, 12), [("x", 2), ("y", 2)], [("x",), ("y",)], [("x", 4)], [(), ("x",)]),
    "1d_refine": ((32,), [("x", 2)], [("x",)], [("x", 8)], [("x",)]),
    "to_replicated": ((16, 8), [("x", 2)], [("x",)], [("x", 4)], []),
}


def _entries(shape, src_mesh, src_spec, dtype="float32"):
    """The same saved pieces (one per distinct source box) as an entry of
    each package."""
    boxes = sorted(
        {b for bs in JL.LayoutSpec(src_mesh).boxes_by_rank(shape, src_spec, 1).values() for b in bs}
    )
    out = []
    for M in (PM, JM):
        shards = [
            M.Shard(
                offsets=[lo for lo, _ in box],
                sizes=[hi - lo for lo, hi in box],
                array=M.ArrayEntry(
                    location=f"sharded/model/w_{'_'.join(str(lo) for lo, _ in box)}",
                    serializer="buffer_protocol", dtype=dtype,
                    shape=[hi - lo for lo, hi in box], replicated=False,
                ),
            )
            for box in boxes
        ]
        out.append(M.ShardedArrayEntry(dtype=dtype, shape=list(shape), shards=shards))
    return out


def _port_boxes(shape, mesh, spec):
    """DTensor's tiling: every rank's box from the mesh and placements."""
    layout = PL.LayoutSpec(mesh)
    ranks = torch.arange(layout.n_devices).reshape([n for _, n in mesh])
    spec = list(spec) + [()] * (len(shape) - len(spec))
    boxes = shard_boxes(shape, ranks, layout.placements_for(spec))
    return {r: [b] for r, b in sorted(boxes.items())}


def _jax_boxes(shape, mesh, spec):
    """GSPMD's tiling: devices_indices_map, one device a rank."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from torchsnapshot_tpu.io_preparers.sharded import _normalize_index

    sizes = [n for _, n in mesh]
    devs = np.array(jax.devices()[: int(np.prod(sizes))]).reshape(sizes)
    pspec = PartitionSpec(*[tuple(d) if len(d) > 1 else (d[0] if d else None) for d in spec])
    sharding = NamedSharding(Mesh(devs, tuple(n for n, _ in mesh)), pspec)
    rank_of = {d.id: r for r, d in enumerate(devs.flat)}
    return {
        rank_of[d.id]: [_normalize_index(index, tuple(shape))]
        for d, index in sorted(sharding.devices_indices_map(tuple(shape)).items(), key=lambda kv: rank_of[kv[0].id])
    }


def _unit_tuples(units):
    return [(u.shard_index, u.owner, u.requesters, u.nbytes) for u in units]


def _role_tuples(roles):
    out = {}
    for i, role in (roles or {}).items():
        if hasattr(role, "bundles"):
            out[i] = ("owner", role.shard_index, role.bundles)
        else:
            out[i] = ("recv", role.key, role.owner, role.shard_index, role.regions)
    return out


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plans_match_the_jax_package(name) -> None:
    shape, src_mesh, src_spec, dst_mesh, dst_spec = LAYOUTS[name]
    pentry, jentry = _entries(shape, src_mesh, src_spec)
    boxes = _port_boxes(shape, dst_mesh, dst_spec)
    # The tilings agree for these layouts, and so do the layout specs.
    assert boxes == _jax_boxes(shape, dst_mesh, dst_spec)
    assert boxes == PL.LayoutSpec(dst_mesh).boxes_by_rank(shape, dst_spec, len(boxes))
    for min_req in (2, 3):
        assert _unit_tuples(R.plan_entry_transfers(pentry, boxes, min_req)) == _unit_tuples(
            JR.plan_entry_transfers(jentry, boxes, min_req)
        )
        assert R.plan_summary(pentry, boxes, min_req) == JR.plan_summary(jentry, boxes, min_req)
    for rank in boxes:
        got = R.ReshardContext(None, rank, len(boxes)).plan_entry(pentry, boxes)
        want = JR.ReshardContext(None, rank, len(boxes)).plan_entry(jentry, boxes)
        assert _role_tuples(got) == _role_tuples(want)


def test_plan_summary_accounting() -> None:
    """w2 rows -> w4 columns of a (16, 8) f32: 2 pieces of 256 B that all
    4 ranks want. Direct reads 2 * 4 * 256; planned one owner read a
    piece; peers 3 non-owners x 64 B a piece."""
    shape, src_mesh, src_spec, dst_mesh, dst_spec = LAYOUTS["tp2_to_tp4"]
    entry = _entries(shape, src_mesh, src_spec)[0]
    assert R.plan_summary(entry, _port_boxes(shape, dst_mesh, dst_spec)) == {
        "shards": 2, "planned_units": 2, "direct_bytes_from_storage": 2048,
        "planned_bytes_from_storage": 512, "planned_peer_bytes": 384,
    }
    same = R.plan_summary(entry, _port_boxes(shape, src_mesh, src_spec))
    assert same["planned_units"] == 0
    assert same["planned_bytes_from_storage"] == same["direct_bytes_from_storage"]


def test_plan_is_deterministic_and_owners_are_requesters() -> None:
    shape = (32, 8)
    entry = _entries(shape, [("x", 4)], [("x",)])[0]
    boxes = _port_boxes(shape, [("x", 4)], [(), ("x",)])
    units = R.plan_entry_transfers(entry, boxes)
    assert units == R.plan_entry_transfers(entry, {r: boxes[r] for r in sorted(boxes, reverse=True)})
    assert len(units) == 4 and sorted(u.owner for u in units) == [0, 1, 2, 3]
    assert all(u.owner in u.requesters and u.requesters == tuple(sorted(u.requesters)) for u in units)
    assert R.plan_entry_transfers(entry, boxes, min_requesters=5) == []
    assert R.ReshardContext(None, 0, 4, min_requesters=5).plan_entry(entry, boxes) is None


def _simulate(entry, boxes_by_rank, full: torch.Tensor):
    """Move every byte of the plan through the port's roles (bundles built
    by ``encode_bundle`` and parsed by the receiver's consumer) and the
    direct overlaps; per rank, (assembled box, write counts)."""
    world = len(boxes_by_rank)
    roles = {r: R.ReshardContext(None, r, world).plan_entry(entry, boxes_by_rank) or {} for r in range(world)}
    units = {u.shard_index: u for u in R.plan_entry_transfers(entry, boxes_by_rank)}
    out = {r: (torch.zeros(*[hi - lo for lo, hi in boxes_by_rank[r][0]]),
               torch.zeros(*[hi - lo for lo, hi in boxes_by_rank[r][0]], dtype=torch.int32))
           for r in range(world)}
    for i, shard in enumerate(entry.shards):
        stored = full[tuple(slice(o, o + s) for o, s in zip(shard.offsets, shard.sizes))]
        for rank in range(world):
            box = boxes_by_rank[rank][0]
            buf, count = out[rank]
            role = roles[rank].get(i)
            if isinstance(role, R.RecvUnit):
                srcs = next(s for sub, _, s in roles[role.owner][i].bundles if sub == rank)
                data = R.encode_bundle([stored[s].contiguous().view(-1).view(torch.uint8).numpy() for s in srcs])
                consumer = R.PlannedRecvConsumer(SimpleNamespace(shard=shard), role, {box: buf})
                for (_, dst, _), region in zip(consumer._regions, consumer._verified_regions(data)):
                    buf[dst] = region
                    count[dst] += 1
                continue
            ov = _overlap(shard.offsets, shard.sizes, box)
            if ov is None or (i in units and units[i].owner != rank):
                continue
            buf[ov[1]] = stored[ov[0]]
            count[ov[1]] += 1
    return out


@pytest.mark.parametrize("name", ["tp2_to_tp4", "rows_to_cols", "tp4_to_tp2", "2d_transposed", "2d_to_cols", "1d_refine", "to_replicated"])
def test_every_destination_byte_lands_exactly_once(name) -> None:
    shape, src_mesh, src_spec, dst_mesh, dst_spec = LAYOUTS[name]
    entry = _entries(shape, src_mesh, src_spec)[0]
    boxes = _port_boxes(shape, dst_mesh, dst_spec)
    full = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32))
    for rank, (buf, count) in _simulate(entry, boxes, full).items():
        assert bool((count == 1).all()), (name, rank)
        assert torch.equal(buf, full[tuple(slice(lo, hi) for lo, hi in boxes[rank][0])])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundles_are_byte_identical_to_the_jax_package(dtype) -> None:
    """Each owner's bundles (header line, regions in sorted-box order, the
    stored dtype) for the same piece bytes are the JAX package's."""
    import ml_dtypes

    shape, src_mesh, src_spec, dst_mesh, dst_spec = LAYOUTS["2d_to_cols"]
    pentry, jentry = _entries(shape, src_mesh, src_spec, dtype)
    boxes = _port_boxes(shape, dst_mesh, dst_spec)
    bits = np.random.default_rng(3).integers(0, 1 << 16, size=shape, dtype=np.uint16)
    if dtype == "bfloat16":
        full_np, full_t = bits.view(ml_dtypes.bfloat16), torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    else:
        f = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
        full_np, full_t = f, torch.from_numpy(f)

    def capture():
        sent = []
        return SimpleNamespace(_forward_sync=lambda subs, h, p: sent.append((subs, h, None if p is None else bytes(p)))), sent

    n_bundles = 0
    for rank in boxes:
        psess, psent = capture()
        jsess, jsent = capture()
        proles = R.ReshardContext(psess, rank, 4).plan_entry(pentry, boxes) or {}
        jroles = JR.ReshardContext(jsess, rank, 4).plan_entry(jentry, boxes) or {}
        for i, role in proles.items():
            if not isinstance(role, R.OwnerUnit):
                continue
            s = pentry.shards[i]
            sl = tuple(slice(o, o + n) for o, n in zip(s.offsets, s.sizes))
            R._forward_bundles(role, full_t[sl].contiguous())
            JR._forward_bundles(jroles[i], jentry.shards[i], np.ascontiguousarray(full_np[sl]))
            n_bundles += len(role.bundles)
        assert psent == jsent
    assert n_bundles > 0


def test_mode_parsers(monkeypatch) -> None:
    for raw, want in [("never", "never"), ("off", "never"), ("always", "always"), ("1", "always"),
                      ("", "auto"), ("bogus", "auto")]:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_RESHARD", raw)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_RESHARD", raw)
        assert R.reshard_mode() == want == JR.reshard_mode()
    for raw, want in [("", 2), ("1", 2), ("3", 3), ("x", 2)]:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_RESHARD_MIN_REQUESTERS", raw)
        assert R.reshard_min_requesters() == want
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_RESHARD", "always")
    assert not R.local_opt_in("FSStoragePlugin", SimpleNamespace(get_world_size=lambda: 1))
    assert R.local_opt_in("FSStoragePlugin", SimpleNamespace(get_world_size=lambda: 2))


def test_corrupt_and_short_bundles_raise_before_any_write() -> None:
    from torchsnapshot_tpu_torch.integrity import IntegrityError

    shape, src_mesh, src_spec, dst_mesh, dst_spec = LAYOUTS["rows_to_cols"]
    entry = _entries(shape, src_mesh, src_spec)[0]
    boxes = _port_boxes(shape, dst_mesh, dst_spec)
    roles = R.ReshardContext(None, 1, 2).plan_entry(entry, boxes)
    (i, role), = [(i, r) for i, r in roles.items() if isinstance(r, R.RecvUnit)]
    consumer = R.PlannedRecvConsumer(SimpleNamespace(shard=entry.shards[i]), role, {boxes[1][0]: None})
    regions = [np.arange(n, dtype=np.float32) for n in (np.prod(s) for _, _, s in role.regions)]
    good = R.encode_bundle(regions)
    assert len(consumer._verified_regions(good)) == len(regions)
    bad = bytearray(good)
    bad[-1] ^= 0xFF
    with pytest.raises(IntegrityError):
        consumer._verified_regions(bytes(bad))
    with pytest.raises(IOError):
        consumer._verified_regions(good[:-4])
    with pytest.raises(IOError):
        consumer._verified_regions(b"no header at all")


# ------------------------------------------------------------------- worlds

ROWS, COLS = 64, 48


def _vals() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(3).standard_normal((ROWS, COLS)).astype(np.float32))


PAYLOAD = ROWS * COLS * 4


def _dt(full, mesh, placements):
    from torch.distributed.tensor import DTensor

    box = shard_boxes(full.shape, mesh.mesh, placements)[mesh.get_rank()]
    local = full[tuple(slice(lo, hi) for lo, hi in box)].clone()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


def _exact(dt, full) -> bool:
    from torchsnapshot_tpu_torch.io_preparers.sharded import dtensor_view

    view = dtensor_view(dt)
    return torch.equal(view.local, full[tuple(slice(lo, hi) for lo, hi in view.local_box)])


def _restore_cols(root, mesh, mode, coop="never", plan=None, full=None):
    """Restore ``root``'s ``model/w`` as ``Shard(1)``; the fs bytes served,
    bit-exactness, peer counter deltas, flag gathers and seconds."""
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject, pg_wrapper
    from torchsnapshot_tpu_torch.storage_plugins import fs

    os.environ["TORCHSNAPSHOT_GPU_RESHARD"] = mode
    os.environ["TORCHSNAPSHOT_GPU_COOP_RESTORE"] = coop
    full = _vals() if full is None else full
    counted = {"n": 0}
    orig_read, orig_gather = fs.FSStoragePlugin.read, pg_wrapper.PGWrapper.all_gather_object
    gathers = []

    async def read(self, read_io):
        await orig_read(self, read_io)
        if read_io.path.startswith(("sharded/", "replicated/")):
            counted["n"] += memoryview(read_io.buf).nbytes

    def gather(self, obj, *args, **kwargs):
        gathers.append(obj)
        return orig_gather(self, obj, *args, **kwargs)

    fs.FSStoragePlugin.read, pg_wrapper.PGWrapper.all_gather_object = read, gather
    before = F.peer_counts.copy()
    dst = _dt(torch.zeros(full.shape), mesh, [Shard(1)])
    faultinject.configure(plan)
    t0 = time.monotonic()
    try:
        Snapshot(root).restore({"model": StateDict(w=dst)})
    finally:
        faultinject.disable()
        fs.FSStoragePlugin.read, pg_wrapper.PGWrapper.all_gather_object = orig_read, orig_gather
    return {
        "read": counted["n"],
        "exact": _exact(dst, full),
        "from_peers": F.peer_counts["bytes_resharded_from_peers"] - before["bytes_resharded_from_peers"],
        "to_peers": F.peer_counts["bytes_to_peers"] - before["bytes_to_peers"],
        "fallbacks": F.peer_counts["fanout_fallbacks"] - before["fanout_fallbacks"],
        "flag_gathers": sum(isinstance(o, tuple) and len(o) == 5 for o in gathers),  # (preverify, addr, coop, reshard, lazy)
        "seconds": time.monotonic() - t0,
    }


def _world2_worker(rank, world, root):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    os.environ["TORCHSNAPSHOT_GPU_COOP_TIMEOUT"] = "30"
    mesh = init_device_mesh("cpu", (world,))
    Snapshot.take(root, {"model": StateDict(w=_dt(_vals(), mesh, [Shard(0)]))})
    out = {
        "planned": _restore_cols(root, mesh, "always"),
        "corrupt": _restore_cols(root, mesh, "always", plan=f"reshard.peer_xfer@1=corrupt;seed={5 + rank}"),
        "truncate": _restore_cols(root, mesh, "always", plan="reshard.peer_xfer@1=truncate:0.3" if rank == 0 else None),
        "delay": _restore_cols(root, mesh, "always", plan="reshard.peer_xfer@1=delay:1.5" if rank == 0 else None),
        "skew": _restore_cols(root, mesh, "always" if rank == 0 else "never"),
        "both_elections": _restore_cols(root, mesh, "always", coop="always"),
    }
    # The owner's data plane dies at its first reshard frame while its
    # restore and the collectives go on.
    if rank == 0:
        orig = F.CoopRestoreSession._send_one

        def dying_send(self, r, header, payload):
            if str(header.get("key", "")).startswith("reshard|"):
                for sock, _ in self._out.values():
                    sock.close()
            orig(self, r, header, payload)

        F.CoopRestoreSession._send_one = dying_send
    out["owner_death"] = _restore_cols(root, mesh, "always")
    return out


def _world4_worker(rank, world, root, jax_root):
    from torch.distributed.device_mesh import init_device_mesh

    os.environ["TORCHSNAPSHOT_GPU_COOP_TIMEOUT"] = "30"
    mesh = init_device_mesh("cpu", (world,))
    return {
        "planned": _restore_cols(root, mesh, "always"),
        "direct": _restore_cols(root, mesh, "never"),
        "from_jax": _restore_cols(jax_root, mesh, "always", coop="always"),
        "from_jax_direct": _restore_cols(jax_root, mesh, "never"),
    }


def _sigkill_worker(rank, world, root):
    """Rank 1 (not the store host) dies at its forwarding boundary. The
    survivor's entry falls back to storage, bit-exact, and its restore
    ends within the barrier timeout."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject
    from torchsnapshot_tpu_torch.pg_wrapper import get_default_pg

    os.environ["TORCHSNAPSHOT_GPU_COOP_TIMEOUT"] = "20"
    mesh = init_device_mesh("cpu", (world,))
    Snapshot.take(root, {"model": StateDict(w=_dt(_vals(), mesh, [Shard(0)]))})
    os.environ["TORCHSNAPSHOT_GPU_RESHARD"] = "always"
    if rank == 1:
        faultinject.configure("reshard.peer_xfer@1=kill")
    dst = _dt(torch.zeros(ROWS, COLS), mesh, [Shard(1)])
    before = F.peer_counts["fanout_fallbacks"]
    t0 = time.monotonic()
    try:
        Snapshot(root).restore({"model": StateDict(w=dst)})
        status = "completed"
    except BaseException as e:  # noqa: B036 - the torn world's abort
        status = f"aborted:{type(e).__name__}"
    # Rank 1 can never reach the launcher's exit barrier: release it.
    get_default_pg().store.set("__exit__/done", b"1")
    return {
        "status": status,
        "seconds": time.monotonic() - t0,
        "exact": _exact(dst, _vals()),
        "fallbacks": F.peer_counts["fanout_fallbacks"] - before,
    }


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """The JAX package's snapshot of the same tensor, rows over 8 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import torchsnapshot_tpu as J

    root = str(tmp_path_factory.mktemp("jax") / "snap")
    sharding = NamedSharding(Mesh(np.array(jax.devices()[:8]), ("x",)), PartitionSpec("x", None))
    w = jax.device_put(jnp.asarray(_vals().numpy()), sharding)
    J.Snapshot.take(root, {"model": J.StateDict(w=w)})
    return root


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_root):
    root = str(tmp_path_factory.mktemp("reshard") / "snap")
    w2 = run_with_subprocesses(_world2_worker, 2, root, backend="gloo", timeout=240.0)
    w4 = run_with_subprocesses(_world4_worker, 4, root, jax_root, backend="gloo", timeout=240.0)
    return w2, w4


W2_CASES = ["planned", "corrupt", "truncate", "delay", "skew", "both_elections", "owner_death"]


@pytest.mark.parametrize("case", W2_CASES)
def test_rows_to_cols_is_bit_exact_with_one_flag_gather(worlds, case) -> None:
    for rank in (0, 1):
        r = worlds[0][rank][case]
        assert r["exact"] and r["flag_gathers"] == 1, (rank, case, r)


def test_rows_to_cols_planned_reads_each_piece_once(worlds) -> None:
    w2 = worlds[0]
    assert sum(w2[r]["planned"]["read"] for r in (0, 1)) == PAYLOAD
    for r in (0, 1):
        assert w2[r]["planned"]["from_peers"] > 0 and w2[r]["planned"]["fallbacks"] == 0
        # Both elections on: the reshard claims the pieces, coop gets none.
        assert w2[r]["both_elections"]["from_peers"] > 0
    assert sum(w2[r]["both_elections"]["read"] for r in (0, 1)) == PAYLOAD


def test_corrupt_bundle_falls_back_for_that_unit(worlds) -> None:
    """Both owners corrupt their bundle: each receiver rejects it at the
    checksum, before any write, and re-reads that one piece."""
    w2 = worlds[0]
    for r in (0, 1):
        assert w2[r]["corrupt"]["fallbacks"] == 1 and w2[r]["corrupt"]["from_peers"] == 0
    assert sum(w2[r]["corrupt"]["read"] for r in (0, 1)) >= 1.8 * PAYLOAD


def test_truncated_bundle_falls_back_one_sided(worlds) -> None:
    w2 = worlds[0]
    assert w2[1]["truncate"]["fallbacks"] == 1
    assert w2[0]["truncate"]["fallbacks"] == 0 and w2[0]["truncate"]["from_peers"] > 0


def test_delayed_bundle_completes_planned(worlds) -> None:
    for r in (0, 1):
        assert worlds[0][r]["delay"]["fallbacks"] == 0 and worlds[0][r]["delay"]["from_peers"] > 0


def test_env_skew_reads_directly(worlds) -> None:
    for r in (0, 1):
        assert worlds[0][r]["skew"]["from_peers"] == 0 and worlds[0][r]["skew"]["to_peers"] == 0


def test_owner_channel_death_falls_back(worlds) -> None:
    r1 = worlds[0][1]["owner_death"]
    assert r1["fallbacks"] >= 1 and r1["read"] > 0 and r1["seconds"] < 20


@pytest.mark.parametrize("case", ["planned", "direct", "from_jax", "from_jax_direct"])
def test_tp2_to_tp4_is_bit_exact_with_one_flag_gather(worlds, case) -> None:
    for rank in range(4):
        r = worlds[1][rank][case]
        assert r["exact"] and r["flag_gathers"] == 1, (rank, case, r)


def test_tp2_to_tp4_planned_cuts_storage_reads_3x(worlds) -> None:
    w4 = worlds[1]
    planned = sum(w4[r]["planned"]["read"] for r in range(4))
    direct = sum(w4[r]["direct"]["read"] for r in range(4))
    assert direct >= 3.5 * PAYLOAD and planned <= 1.3 * PAYLOAD and direct >= 3 * planned
    assert sum(w4[r]["planned"]["from_peers"] for r in range(4)) > 0
    assert all(w4[r]["planned"]["fallbacks"] == 0 for r in range(4))
    assert all(w4[r]["direct"]["from_peers"] == 0 for r in range(4))


def test_jax_written_snapshot_restores_planned(worlds) -> None:
    w4 = worlds[1]
    planned = sum(w4[r]["from_jax"]["read"] for r in range(4))
    direct = sum(w4[r]["from_jax_direct"]["read"] for r in range(4))
    assert planned <= 1.3 * PAYLOAD and direct >= 3 * planned


def test_sigkill_owner_mid_transfer(tmp_path) -> None:
    os.environ["TORCHSNAPSHOT_GPU_BARRIER_TIMEOUT"] = "20"
    try:
        results = run_with_subprocesses(
            _sigkill_worker, 2, str(tmp_path / "snap"), backend="gloo", timeout=180.0, expect_dead=(1,)
        )
    finally:
        del os.environ["TORCHSNAPSHOT_GPU_BARRIER_TIMEOUT"]
    assert set(results) == {0}, results
    r = results[0]
    assert r["exact"] and r["fallbacks"] >= 1 and r["seconds"] < 120, r
