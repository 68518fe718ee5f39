"""Planned reshard and cooperative fan-out into CUDA destinations.

A world of 2 processes on one card (both on ``cuda:0``, gloo for the
DeviceMesh, the port's store for the snapshot's coordination):

- a ``Shard(0)`` DTensor saved by the world restores as ``Shard(1)`` under
  ``TORCHSNAPSHOT_GPU_RESHARD=always``: each rank reads one piece and
  receives the other's regions as a bundle, landed in its CUDA local
  shard through a registered staging slab on the restore's side stream;
- replicated CUDA tensors restore under
  ``TORCHSNAPSHOT_GPU_COOP_RESTORE=always``: the receiver's frames arrive
  in pooled slabs, which its device sink registers with CUDA and copies
  from directly (no pageable host-to-device copy).

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_reshard_cuda.py
"""

from __future__ import annotations

import os

import pytest
import torch
from torch.distributed.tensor import Shard

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _full(seed: int, shape=(256, 192)) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


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


def _worker(rank: int, world: int, root: str):
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import Snapshot, StateDict, fanout
    from torchsnapshot_tpu_torch.io_preparers import array
    from torchsnapshot_tpu_torch.io_preparers.sharded import dtensor_view

    torch.cuda.set_device(0)
    os.environ["TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES"] = str(64 << 10)
    os.environ["TORCHSNAPSHOT_GPU_COOP_TIMEOUT"] = "60"
    mesh = init_device_mesh("cuda", (world,))
    out = {}

    # Planned reshard: rows -> columns.
    Snapshot.take(f"{root}/rows", {"m": StateDict(w=_dt(_full(0), mesh, [Shard(0)]))})
    os.environ["TORCHSNAPSHOT_GPU_RESHARD"] = "always"
    os.environ["TORCHSNAPSHOT_GPU_COOP_RESTORE"] = "never"
    dst = _dt(_full(0), mesh, [Shard(1)], fill=0.0)
    before = fanout.peer_counts.copy()
    Snapshot(f"{root}/rows").restore({"m": StateDict(w=dst)})
    view = dtensor_view(dst)
    out["planned_exact"] = view.local.is_cuda and torch.equal(
        view.local.cpu(), _full(0)[tuple(slice(lo, hi) for lo, hi in view.local_box)]
    )
    out["planned_peer"] = fanout.peer_counts["bytes_resharded_from_peers"] - before["bytes_resharded_from_peers"]
    out["planned_fallbacks"] = fanout.peer_counts["fanout_fallbacks"] - before["fanout_fallbacks"]

    # Cooperative fan-out of replicated CUDA tensors.
    state = {f"r{i}": _full(10 + i, (512, 256)).cuda() for i in range(4)}
    Snapshot.take(f"{root}/repl", {"m": StateDict(state)}, replicated=["m/**"])
    os.environ["TORCHSNAPSHOT_GPU_RESHARD"] = "never"
    os.environ["TORCHSNAPSHOT_GPU_COOP_RESTORE"] = "always"
    pinned = {"n": 0}
    orig_pin = array._staging_pool.pin

    def pin(buf):
        got = orig_pin(buf)
        pinned["n"] += bool(got)
        return got

    array._staging_pool.pin = pin
    dst = StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    before = fanout.peer_counts.copy()
    Snapshot(f"{root}/repl").restore({"m": dst})
    array._staging_pool.pin = orig_pin
    out["coop_exact"] = all(dst[k].is_cuda and torch.equal(dst[k], v) for k, v in state.items())
    out["coop_peer"] = fanout.peer_counts["bytes_from_peers"] - before["bytes_from_peers"]
    out["coop_fallbacks"] = fanout.peer_counts["fanout_fallbacks"] - before["fanout_fallbacks"]
    out["pinned_receive_slabs"] = pinned["n"]
    return out


def test_planned_and_coop_restores_land_in_cuda_shards(card, tmp_path) -> None:
    results = run_with_subprocesses(_worker, 2, str(tmp_path), backend="gloo", timeout=300.0)
    for rank, out in results.items():
        assert out["planned_exact"] and out["coop_exact"], (rank, out)
        assert out["planned_peer"] > 0 and out["planned_fallbacks"] == 0, (rank, out)
        assert out["coop_peer"] > 0 and out["coop_fallbacks"] == 0, (rank, out)
    # The native library builds on the card's host: peer frames land in
    # pooled slabs that the device sink registers and copies from.
    assert sum(out["pinned_receive_slabs"] for out in results.values()) > 0, results
