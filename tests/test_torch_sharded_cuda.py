"""Sharded (DTensor) snapshots on the card.

- A world of 2 processes on one card (both on ``cuda:0``, gloo for the
  DeviceMesh, the port's store for the snapshot's coordination) takes
  ``Shard(0)`` DTensors and a ``Replicate`` one, and restores them into
  another layout by the scatter into the CUDA shards; a second restore
  into destinations that hold the bytes, with device digests, reads no
  payload byte and launches K4's partial form.
- K4's partial form over the regions each simulated rank of a 4-rank
  mesh is elected for, against its plain version: the same lanes, and one
  launch a region.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sharded_cuda.py
"""

from __future__ import annotations

import math
import os

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _full(name: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed({"w": 0, "e": 1, "b": 2}[name])
    shape = {"w": (64, 96), "e": (16, 37), "b": (40,)}[name]
    return torch.randn(shape, generator=gen)


def _dt(full, mesh, placements, fill=None):
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch.io_preparers.sharded import shard_boxes

    box = shard_boxes(full.shape, mesh.mesh, placements)[mesh.get_rank()]
    local = full[tuple(slice(lo, hi) for lo, hi in box)].clone()
    if fill is not None:
        local.fill_(fill)
    return DTensor.from_local(
        local.cuda(), mesh, placements, run_check=False, shape=full.shape, stride=full.stride()
    )


def _exact(dt, full) -> bool:
    from torchsnapshot_tpu_torch.io_preparers.sharded import dtensor_view

    view = dtensor_view(dt)
    return torch.equal(view.local.cpu(), full[tuple(slice(lo, hi) for lo, hi in view.local_box)])


def _world_worker(rank: int, world: int, root: str):
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.storage_plugins import fs

    torch.cuda.set_device(0)
    mesh = init_device_mesh("cuda", (world,))
    src = {"w": [Shard(0)], "e": [Shard(1)], "b": [Replicate()]}
    flip = {"w": [Shard(1)], "e": [Shard(0)], "b": [Replicate()]}
    app = StateDict({n: _dt(_full(n), mesh, p) for n, p in src.items()})
    Snapshot.take(f"{root}/s", {"app": app}, device_digests=True)
    dst = StateDict({n: _dt(_full(n), mesh, p, fill=0.0) for n, p in flip.items()})
    Snapshot(f"{root}/s").restore({"app": dst})
    out = {"restored": all(_exact(dst[n], _full(n)) for n in flip),
           "on_card": all(dst[n].to_local().is_cuda for n in flip)}
    read_bytes = [0]
    orig = fs.FSStoragePlugin.read

    async def read(plugin, read_io):
        await orig(plugin, read_io)
        if not os.path.basename(read_io.path).startswith("."):
            read_bytes[0] += memoryview(read_io.buf).nbytes

    fs.FSStoragePlugin.read = read
    try:
        held = StateDict({n: _dt(_full(n), mesh, p) for n, p in flip.items()})
        dd.fingerprint_lanes.partial_launches = 0
        Snapshot(f"{root}/s").restore({"app": held}, device_digests=True)
        out["partial_launches"] = dd.fingerprint_lanes.partial_launches
    finally:
        fs.FSStoragePlugin.read = orig
    out["read_bytes"] = read_bytes[0]
    out["held_exact"] = all(_exact(held[n], _full(n)) for n in flip)
    return out


def test_world_of_two_on_one_card(tmp_path, card) -> None:
    results = run_with_subprocesses(_world_worker, 2, str(tmp_path), backend="gloo", timeout=300)
    for rank, out in results.items():
        assert out["restored"] and out["on_card"], rank
        assert out["read_bytes"] == 0 and out["held_exact"], rank
        assert out["partial_launches"] >= 1, rank


LAYOUTS = {
    "1d_row": ((4,), [Shard(0)]),
    "1d_col": ((4,), [Shard(1)]),
    "2d": ((2, 2), [Shard(0), Shard(1)]),
    "partial_repl": ((2, 2), [Shard(0), Replicate()]),
    "combined": ((2, 2), [Shard(0), Shard(0)]),
}


def _views(full, layout, device):
    from torchsnapshot_tpu_torch.io_preparers import sharded as S

    mesh_shape, placements = LAYOUTS[layout]
    ranks = torch.arange(math.prod(mesh_shape)).reshape(mesh_shape)
    boxes = S.shard_boxes(full.shape, ranks, placements)
    return [
        S.ShardedView(tuple(full.shape), boxes, r,
                      full[tuple(slice(lo, hi) for lo, hi in boxes[r])].clone().to(device))
        for r in range(ranks.numel())
    ]


@pytest.mark.parametrize("src,dst", [("1d_row", "1d_col"), ("2d", "combined"),
                                     ("partial_repl", "1d_col"), ("1d_col", "2d")])
def test_partial_kernel_matches_plain_over_elected_regions(card, src, dst) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.io_preparers import sharded as S
    from torchsnapshot_tpu_torch.manifest import ArrayEntry, Shard, ShardedArrayEntry

    full = torch.randn((64, 96), generator=torch.Generator().manual_seed(3))
    shards = []
    for view in _views(full, src, "cpu"):
        for p_off, p_sz, piece in S.ShardedArrayIOPreparer._owned_pieces(view):
            entry = ArrayEntry(location="x", serializer="buffer_protocol", dtype="float32",
                               shape=list(p_sz), replicated=False)
            entry.device_digest = dd.device_fingerprint(piece.contiguous())
            shards.append(Shard(offsets=p_off, sizes=p_sz, array=entry))
    entry = ShardedArrayEntry(dtype="float32", shape=list(full.shape), shards=shards)
    cpu = [S.ShardedArrayIOPreparer.partial_digest_contributions(entry, v)
           for v in _views(full, dst, "cpu")]
    dd.fingerprint_lanes.partial_launches = 0
    gpu = [S.ShardedArrayIOPreparer.partial_digest_contributions(entry, v)
           for v in _views(full, dst, card)]
    regions = sum(len(rs) for contribs in cpu for rs in contribs.values())
    assert dd.fingerprint_lanes.partial_launches == regions > 0
    assert gpu == cpu
