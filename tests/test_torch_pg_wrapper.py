"""The port's PGWrapper: object collectives over the store in real worlds.

One spawned world of 3 processes runs every collective once (the module's
fixture) and the cases check what each rank saw: broadcast, all-gather,
scatter and barrier, two wrappers in one operation, the lazy namespace
handshake and its garbage collection once every rank retired, and the
error channel that makes blocked peers raise. Identity without a world
comes from ``RANK``/``WORLD_SIZE``; a world without a store raises.
"""

from __future__ import annotations

import os
import re

import pytest

from torchsnapshot_tpu_torch import pg_wrapper as PW
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]

WORLD = 3


def _collectives_worker(rank: int, world_size: int):
    from torchsnapshot_tpu_torch.io_preparers import array

    out = {}
    # init_process_group (in the launcher) served no store op: the
    # processes of this host are counted at the first take or restore,
    # once, and the staging pool is split among them then.
    uncounted = PW.get_default_pg().local_world_size
    pg = PW.PGWrapper()
    out["local_world_size"] = (uncounted, PW.count_local_processes(pg),
                               PW.get_default_pg().local_world_size)
    out["pool_limit"] = array._staging_pool._limit
    out["identity"] = (pg.get_rank(), pg.get_world_size())
    out["broadcast"] = pg.broadcast_object(f"from-rank-{rank}", src=0)
    out["all_gather"] = pg.all_gather_object({"rank": rank, "data": [rank] * 3})
    out["big_all_gather"] = len(pg.all_gather_object(b"x" * (64 << 10))[world_size - 1])
    objs = [f"item-{r}" for r in range(world_size)] if rank == 1 else None
    out["scatter"] = pg.scatter_object(objs, src=1)
    pg.barrier()
    pg2 = PW.PGWrapper()
    out["second_wrapper"] = pg2.all_gather_object(rank * 10)
    out["namespaces_differ"] = pg._namespace() != pg2._namespace()
    store = pg.pg.store
    # Retire both; rank 0 reclaims their keys at the next handshake.
    pg.retire()
    pg2.retire()
    PW.PGWrapper().barrier()  # every rank has acked by the time it ends
    pg3 = PW.PGWrapper()
    pg3.barrier()  # rank 0's handshake ran the GC
    out["reclaimed"] = not store.check(f"{pg._namespace()}/retired/0") and not store.check(
        f"{pg2._namespace()}/bcast/1"
    )
    # The error channel: rank 2 fails; ranks 0 and 1, blocked in a
    # gather, raise instead of waiting out the store timeout.
    pg4 = PW.PGWrapper()
    pg4.barrier()
    if rank == 2:
        pg4.report_error(ValueError("rank 2 failed"))
        out["error_channel"] = "reported"
    else:
        try:
            pg4.all_gather_object(rank, timeout=30.0)
            out["error_channel"] = "returned"
        except RuntimeError as e:
            out["error_channel"] = f"raised: {e.__cause__}"
    return out


@pytest.fixture(scope="module")
def world():
    return run_with_subprocesses(_collectives_worker, WORLD, timeout=120)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize(
    "collective",
    ["identity", "broadcast", "all_gather", "big_all_gather", "scatter", "second_wrapper",
     "namespaces_differ", "reclaimed", "local_world_size", "pool_limit"],
)
def test_collective(world, rank, collective) -> None:
    from torchsnapshot_tpu_torch.io_preparers import array

    want = {
        "local_world_size": (None, WORLD, WORLD),
        "pool_limit": array._pool_limit() if os.environ.get(array.STAGING_POOL_ENV_VAR)
        else array._DEFAULT_STAGING_POOL_BYTES // WORLD,
        "identity": (rank, WORLD),
        "broadcast": "from-rank-0",
        "all_gather": [{"rank": r, "data": [r] * 3} for r in range(WORLD)],
        "big_all_gather": 64 << 10,
        "scatter": f"item-{rank}",
        "second_wrapper": [r * 10 for r in range(WORLD)],
        "namespaces_differ": True,
        "reclaimed": True,
    }[collective]
    assert world[rank][collective] == want


def test_error_channel_makes_blocked_peers_raise(world) -> None:
    assert world[2]["error_channel"] == "reported"
    for rank in (0, 1):
        assert world[rank]["error_channel"] == "raised: rank 2 failed"


def test_identity_from_the_environment(monkeypatch) -> None:
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert PW.process_identity() == (3, 4)
    monkeypatch.delenv(PW.STORE_ADDR_ENV_VAR, raising=False)
    with pytest.raises(RuntimeError, match="4 processes needs the coordination store"):
        PW.ensure_default_pg()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert PW.ensure_default_pg() is None
    assert PW.PGWrapper().get_world_size() == 1


class _TorchGroup:
    """A torch.distributed group as `_as_process_group` reads it: size,
    rank and, through `get_process_group_ranks`, its global ranks."""

    def __init__(self, ranks, rank) -> None:
        self.ranks, self._rank = ranks, rank

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        return self._rank


def test_a_torch_group_gives_identity_over_the_default_store(monkeypatch) -> None:
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.dist_store import TCPStore

    server = TCPStore("127.0.0.1", is_server=True, timeout=5.0)
    monkeypatch.setattr(PW, "_default_pg", PW.ProcessGroup(server, 0, 2))
    monkeypatch.setattr(dist, "get_process_group_ranks", lambda group: group.ranks)
    try:
        pg = PW.PGWrapper(_TorchGroup([0, 1], 1))
        assert (pg.get_rank(), pg.get_world_size()) == (1, 2)
        assert pg.pg.store is server
    finally:
        server.close()


@pytest.mark.parametrize("ranks", [[2, 3], [1, 0, 2, 3], [0, 1, 2]])
def test_a_torch_subgroup_raises_by_name(monkeypatch, ranks) -> None:
    """The store's handshake counter and cursors are per world: a group
    that is not the whole default world in rank order is refused before
    any handshake, and a process outside a group (torch hands it a
    sentinel with no size) is refused too."""
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.dist_store import TCPStore

    server = TCPStore("127.0.0.1", is_server=True, timeout=5.0)
    monkeypatch.setattr(PW, "_default_pg", PW.ProcessGroup(server, 2, 4))
    monkeypatch.setattr(dist, "get_process_group_ranks", lambda group: group.ranks)
    try:
        with pytest.raises(ValueError, match=re.escape(f"subgroup of global ranks {ranks}")):
            PW.PGWrapper(_TorchGroup(ranks, 0))
        with pytest.raises(ValueError, match="outside a torch.distributed subgroup"):
            PW.PGWrapper(dist.GroupMember.NON_GROUP_MEMBER)
        assert not server.check("pgw/seq")
    finally:
        server.close()


def test_budget_and_staging_pool_split_among_local_ranks(monkeypatch) -> None:
    """Three processes of a world of four share this host: each gets a
    third of the memory budget, and getting the budget changes nothing
    else. The staging pool's default limit is split the same way by
    `share_staging_pool` (which `count_local_processes` calls once; the
    world of three above checks that), and an explicit pool size stays."""
    import socket

    from torchsnapshot_tpu_torch import scheduler
    from torchsnapshot_tpu_torch.io_preparers import array

    class FourRanks:
        def get_world_size(self) -> int:
            return 4

        def all_gather_object(self, obj):
            return [socket.gethostname()] * 3 + ["another-host"]

    monkeypatch.delenv(scheduler.MEMORY_BUDGET_ENV_VAR, raising=False)
    monkeypatch.delenv(array.STAGING_POOL_ENV_VAR, raising=False)
    monkeypatch.setattr(scheduler, "_available_memory_bytes", lambda: 30 << 30)
    monkeypatch.setattr(array._staging_pool, "_limit", array._DEFAULT_STAGING_POOL_BYTES)
    assert scheduler.get_local_world_size(FourRanks()) == 3
    one = scheduler.get_process_memory_budget_bytes()
    three = scheduler.get_process_memory_budget_bytes(FourRanks())
    assert three == min(int((30 << 30) * scheduler._AVAILABLE_MEMORY_MULTIPLIER) // 3,
                        scheduler._MAX_PER_RANK_MEMORY_BUDGET_BYTES)
    assert three <= one
    assert array._staging_pool._limit == array._DEFAULT_STAGING_POOL_BYTES
    # A group whose local size count_local_processes counted is not asked again.
    counted = PW.PGWrapper(PW.ProcessGroup(object(), 0, 4, local_world_size=2))
    assert scheduler.get_local_world_size(counted) == 2
    array.share_staging_pool(3)
    assert array._staging_pool._limit == array._DEFAULT_STAGING_POOL_BYTES // 3
    monkeypatch.setenv(array.STAGING_POOL_ENV_VAR, str(1 << 30))
    monkeypatch.setattr(array._staging_pool, "_limit", 1 << 30)
    array.share_staging_pool(3)
    assert array._staging_pool._limit == 1 << 30
