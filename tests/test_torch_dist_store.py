"""The port's coordination store against the JAX package's.

The port keeps its own copy of ``dist_store``; the wire protocol is the
same, so every op is run three ways: the port's client on the port's
server, and each package's client on the other's server. Also blocking
``get``, the liveness death key, ``create_store``'s rendezvous, the fault
injection sites and ``LinearBarrier``'s all-or-nothing commit.
"""

from __future__ import annotations

import threading
import time

import pytest

import torchsnapshot_tpu.dist_store as J
import torchsnapshot_tpu_torch.dist_store as D
from torchsnapshot_tpu_torch import faultinject
from torch_test_env import autotune_never  # noqa: F401 - autouse

PAIRS = {"port-port": (D, D), "port-server-jax-client": (D, J), "jax-server-port-client": (J, D)}


@pytest.fixture(params=list(PAIRS))
def store(request):
    server_mod, client_mod = PAIRS[request.param]
    server = server_mod.TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    client = client_mod.TCPStore("127.0.0.1", server.port, timeout=10.0)
    yield client
    client.close()
    server.close()


def test_set_get_check(store) -> None:
    store.set("k", b"v")
    assert store.get("k") == b"v"
    assert store.check("k") and not store.check("nope")


def test_blocking_get(store) -> None:
    def setter():
        time.sleep(0.2)
        other = store.clone()
        other.set("later", b"done")
        other.close()

    t = threading.Thread(target=setter)
    t.start()
    assert store.get("later", timeout=5.0) == b"done"
    t.join(timeout=10)
    assert not t.is_alive()


def test_get_timeout(store) -> None:
    with pytest.raises(TimeoutError):
        store.get("never", timeout=0.3)


def test_add_wait_any_delete(store) -> None:
    assert store.add("ctr", 1) == 1
    assert store.add("ctr", 5) == 6
    assert store.get("ctr") == b"6"
    store.set("b", b"2")
    assert store.wait_any(["a", "b"], timeout=2.0) == ("b", b"2")
    store.set("p/1", b"x")
    store.set("p/2", b"y")
    store.set("q/1", b"z")
    assert store.delete("p/1") and not store.delete("p/1")
    assert store.delete_prefix("p/") == 1
    assert not store.check("p/2") and store.check("q/1")


def test_mset_and_collect(store) -> None:
    store.mset({"c/0": b"a", "c/1": b"b"})
    stopped, items = store.collect("c/", 2, timeout=2.0)
    assert stopped is None and items == {"c/0": b"a", "c/1": b"b"}
    store.set("stop", b"why")
    stopped, items = store.collect("c/", 5, stop_keys=["stop"], timeout=2.0)
    assert stopped == "stop" and items["stop"] == b"why"


def test_liveness_publishes_on_connection_drop(store) -> None:
    dirty = store.clone()
    dirty.register_liveness("death/dirty", b"rank-x-died")
    clean = store.clone()
    clean.register_liveness("death/clean", b"rank-y-died")
    clean.deregister_liveness("death/clean")
    dirty.close()
    clean.close()
    assert store.get("death/dirty", timeout=5.0) == b"rank-x-died"
    time.sleep(0.1)
    assert not store.check("death/clean")


def test_create_store_rendezvous() -> None:
    server = D.create_store(rank=0, addr="127.0.0.1:0")
    client = D.create_store(rank=1, addr=f"127.0.0.1:{server.port}")
    client.set("x", b"1")
    assert server.get("x") == b"1"
    client.close()
    server.close()


def test_store_fault_sites_are_registered() -> None:
    """The store's injection sites parse in a fault plan and count hits."""
    faultinject.configure("dist_store.rpc@1000=delay:0;dist_store.serve_op@1000=delay:0")
    try:
        server = D.TCPStore("127.0.0.1", is_server=True, timeout=5.0)
        client = D.TCPStore("127.0.0.1", server.port, timeout=5.0)
        client.set("k", b"v")
        assert client.get("k") == b"v"
        hits = faultinject.hits()
        assert hits["dist_store.rpc"] >= 2 and hits["dist_store.serve_op"] >= 2
        client.close()
        server.close()
    finally:
        faultinject.disable()


@pytest.mark.parametrize("fail_rank", [None, 0, 1, 2])
def test_linear_barrier_is_all_or_nothing(fail_rank) -> None:
    """Three ranks on threads: the leader acts between the phases only when
    every rank arrived; a rank that reports an error instead makes every
    other rank raise, and the leader never acts."""
    server = D.TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    prefix = f"bar/{fail_rank}"
    acted, outcome = [], {}

    def run(rank: int) -> None:
        s = server.clone()
        b = D.LinearBarrier(prefix, s, rank, 3)
        try:
            if rank == fail_rank:
                b.report_error(ValueError(f"rank {rank} failed"))
                outcome[rank] = "reported"
                return
            b.arrive(timeout=10.0)
            if rank == 0:
                acted.append(True)
            b.depart(timeout=10.0)
            outcome[rank] = "committed"
        except RuntimeError as e:
            outcome[rank] = f"raised: {e.__cause__}"
        finally:
            s.close()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    server.close()
    if fail_rank is None:
        assert acted == [True] and set(outcome.values()) == {"committed"}
    else:
        assert acted == []
        for rank in range(3):
            if rank != fail_rank:
                assert outcome[rank].startswith("raised") and "failed" in outcome[rank]


# The replication tier, in-process: a leader, one standby from
# `host_standby`, and a client, with short leases so a failover completes
# in well under a second. Closing the leader's server stands in for the
# death of its host.
LEASE = 0.4


@pytest.fixture
def replicated():
    """(leader, standby, client), the client's replica cache primed."""
    leader = D.TCPStore("127.0.0.1", is_server=True, timeout=15.0, lease_s=LEASE,
                        expected_replicas=1)
    standby = D.host_standby(leader.addr, lease_s=LEASE)
    client = D.TCPStore("127.0.0.1", leader.port, timeout=15.0)
    client.set("__prime__", b"1")
    deadline = time.monotonic() + 5
    while not client.replica_addrs and time.monotonic() < deadline:
        client.check("__prime__")
        time.sleep(0.02)
    assert client.replica_addrs, "the client never learned the replica set"
    yield leader, standby, client
    client.close()
    standby.close()
    leader.close()


def _wait_promoted(standby, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if standby._role == "leader":
            return
        time.sleep(0.02)
    raise AssertionError("the standby never took over")


def test_standby_takes_over_with_the_data(replicated) -> None:
    """Every op after the leader's loss fails over once, to the promoted
    standby, which holds what the leader had acknowledged; a counter is
    not applied twice."""
    leader, standby, client = replicated
    client.set("pre", b"1")
    assert client.add("ctr", 7) == 7
    leader._server.close()
    assert client.get("pre", timeout=30.0) == b"1"
    assert client.add("ctr", 1) == 8
    client.mset({"post/1": b"a"})
    assert client.delete("post/1") is True
    assert client.failovers == 1
    st = client.status()
    assert st["role"] == "leader" and st["epoch"] == 2
    assert D.probe_store_status(f"127.0.0.1:{standby.port}")["role"] == "leader"


@pytest.mark.parametrize("via", ["blocked_wait", "clone"])
def test_a_client_reaches_the_promoted_standby(replicated, via) -> None:
    """A wait blocked on the server when the leader dies re-arms on the
    promoted standby; a clone (the async commit thread's connection) made
    after the loss reaches it too."""
    leader, standby, client = replicated
    if via == "clone":
        leader._server.close()
        _wait_promoted(standby)
        other = client.clone()
        other.set("via-clone", b"1")
        assert other.get("via-clone", timeout=5.0) == b"1"
        other.close()
        return
    got = {}
    t = threading.Thread(target=lambda: got.update(res=client.wait_any(["late"], timeout=60.0)))
    t.start()
    time.sleep(0.3)
    leader._server.close()
    _wait_promoted(standby)
    writer = D.TCPStore("127.0.0.1", standby.port, timeout=10.0)
    writer.set("late", b"arrived")
    t.join(timeout=30)
    writer.close()
    assert not t.is_alive(), "the wait never re-armed after the failover"
    assert got["res"] == ("late", b"arrived") and client.failovers == 1


def test_without_replicas_a_lost_leader_latches_fast() -> None:
    leader = D.TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    client = D.TCPStore("127.0.0.1", leader.port, timeout=10.0)
    client.set("warm", b"1")
    leader._server.close()
    t0 = time.monotonic()
    with pytest.raises(D.StoreConnectionLostError, match="rank 0"):
        client.get("warm", timeout=30.0)
    assert time.monotonic() - t0 < 8.0
    with pytest.raises(D.StoreConnectionLostError):
        client.set("more", b"1")
    client.close()


def test_create_store_bootstraps_a_standby_on_rank_one() -> None:
    """`create_store(replicas=1)`: rank 1 hosts the standby, both ranks
    wait for the replica set, and a client fails over to it once rank 0's
    server is gone."""
    from torchsnapshot_tpu_torch.test_utils import find_free_port

    addr = f"127.0.0.1:{find_free_port()}"
    stores = {}
    threads = [
        threading.Thread(target=lambda r=r: stores.update(
            {r: D.create_store(r, addr, timeout=30.0, replicas=1, lease_s=LEASE)}))
        for r in (0, 1)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    s0, s1 = stores[0], stores[1]
    try:
        assert s0.check(D.REPLICAS_READY_KEY) and s1._standby is not None
        s1.set("before", b"1")
        deadline = time.monotonic() + 5
        while not s1.replica_addrs and time.monotonic() < deadline:
            s1.check("before")
            time.sleep(0.02)
        s0._server.close()
        assert s1.get("before", timeout=30.0) == b"1" and s1.failovers == 1
    finally:
        s1.close()
        s0.close()
