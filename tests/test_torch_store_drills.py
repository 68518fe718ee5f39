"""The port's coordination store under failure: the replicated tier's
in-process drills and the store-host kill drills across processes.

Counterpart of ``tests/test_store_replication.py`` (leased-leader failover,
idempotent replay, epoch fencing, connect retries, the store-status probe:
in-process, threads and real TCP clients, short leases) and of
``tests/test_store_spof.py`` and the store-host schedules of
``tests/test_chaos_matrix.py`` (spawned worlds through
``torchsnapshot_tpu_torch.test_utils.run_with_subprocesses`` with
``expect_dead`` and an external store host). The JAX package's telemetry
counters and CLI have no counterpart in the port; those assertions are not
carried over. Tests that ``tests/test_torch_dist_store.py`` already holds
(a standby taking over with the data, a lost leader latching fast, the
rank-one standby bootstrap) are not repeated.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time

import pytest
import torch

from torchsnapshot_tpu_torch import faultinject
from torchsnapshot_tpu_torch.dist_store import (
    LinearBarrier,
    StoreConnectionLostError,
    TCPStore,
    _DeposedError,
    _recv_msg,
    _send_msg,
    host_standby,
    probe_store_status,
)
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

LEASE = 0.4


@pytest.fixture
def replicated():
    """(leader_store, standby_server, client): one standby joined, the
    client's replica cache primed."""
    leader = TCPStore(
        "127.0.0.1", is_server=True, timeout=15.0, lease_s=LEASE,
        expected_replicas=1,
    )
    standby = host_standby(leader.addr, lease_s=LEASE)
    client = TCPStore("127.0.0.1", leader.port, timeout=15.0)
    # Prime the replica cache (the rsv piggyback needs one response).
    client.set("__prime__", b"1")
    deadline = time.monotonic() + 5
    while not client.replica_addrs and time.monotonic() < deadline:
        client.check("__prime__")
        time.sleep(0.02)
    assert client.replica_addrs, "client never learned the replica set"
    yield leader, standby, client
    client.close()
    standby.close()
    leader.close()


def _kill_leader(leader: TCPStore) -> None:
    """SIGKILL-equivalent for an in-process leader: close every socket."""
    leader._server.close()


def _wait_promoted(standby, timeout=10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if standby._role == "leader":
            return
        time.sleep(0.02)
    raise AssertionError("standby never assumed leadership")


# ----------------------------------------------------------- idempotency


def _raw_client(store: TCPStore) -> socket.socket:
    sock = socket.create_connection(("127.0.0.1", store.port), timeout=5.0)
    sock.settimeout(5.0)
    return sock


def _roundtrip(sock, req):
    _send_msg(sock, req)
    return _recv_msg(sock)


def test_duplicate_mutating_ops_apply_exactly_once():
    """Every mutating op replayed with the same (client_id, seq) — the
    post-failover replay shape — applies exactly once and answers the
    CACHED response."""
    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    sock = _raw_client(store)
    try:
        # add: the op whose double-apply is visible arithmetically.
        r1 = _roundtrip(sock, {"op": "add", "key": "ctr", "amount": 5,
                               "cid": "c1", "cseq": 1})
        r2 = _roundtrip(sock, {"op": "add", "key": "ctr", "amount": 5,
                               "cid": "c1", "cseq": 1})
        assert r1["value"] == 5 and r2["value"] == 5
        assert store.get("ctr") == b"5"

        # set replay is a no-op (idempotent by value) but must still
        # answer from the cache, not re-apply over a later write.
        _roundtrip(sock, {"op": "set", "key": "k", "value": b"first",
                          "cid": "c1", "cseq": 2})
        store.set("k", b"second")  # a later op from another client
        r = _roundtrip(sock, {"op": "set", "key": "k", "value": b"first",
                              "cid": "c1", "cseq": 2})
        assert r["ok"]
        assert store.get("k") == b"second", "replay re-applied over a later write"

        # mset (multi_set)
        _roundtrip(sock, {"op": "mset", "items": {"m/1": b"a", "m/2": b"b"},
                          "cid": "c1", "cseq": 3})
        store.set("m/1", b"z")
        r = _roundtrip(sock, {"op": "mset", "items": {"m/1": b"a", "m/2": b"b"},
                              "cid": "c1", "cseq": 3})
        assert r["ok"] and store.get("m/1") == b"z"

        # delete: the first application returns True; the replay must
        # echo it (a fresh apply would return False — key already gone).
        r1 = _roundtrip(sock, {"op": "delete", "key": "m/2",
                               "cid": "c1", "cseq": 4})
        r2 = _roundtrip(sock, {"op": "delete", "key": "m/2",
                               "cid": "c1", "cseq": 4})
        assert r1["value"] is True and r2["value"] is True

        # delete_prefix: same cached-count contract.
        store.mset({"p/1": b"x", "p/2": b"y"})
        r1 = _roundtrip(sock, {"op": "delete_prefix", "prefix": "p/",
                               "cid": "c1", "cseq": 5})
        r2 = _roundtrip(sock, {"op": "delete_prefix", "prefix": "p/",
                               "cid": "c1", "cseq": 5})
        assert r1["value"] == 2 and r2["value"] == 2
    finally:
        sock.close()
        store.close()


@pytest.mark.parametrize(
    "op_fn,verify",
    [
        (lambda s: s.set("ik", b"v"), lambda s: s.get("ik") == b"v"),
        (lambda s: s.add("ictr", 3), lambda s: s.get("ictr") == b"3"),
        (lambda s: s.mset({"im/1": b"a"}), lambda s: s.get("im/1") == b"a"),
    ],
)
def test_injected_rpc_transient_is_retried_exactly_once(op_fn, verify):
    """An injected ``dist_store.rpc`` transient models a blip that failed
    one request: the client resends with the same (client_id, seq) and
    the op applies exactly once — the connection is NOT latched dead."""
    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    try:
        faultinject.configure("dist_store.rpc@1=transient")
        op_fn(store)
        assert verify(store)
        store.set("still-alive", b"1")  # not latched dead
    finally:
        faultinject.disable()
        store.close()


def test_injected_rpc_transient_barrier_arrive_depart():
    """Barrier arrive + depart under an rpc blip: the arrive-side set and
    the depart write each survive one injected transient, the barrier
    completes, and the arrive keys show exactly one write per rank."""
    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    errs = []

    def run(rank: int) -> None:
        try:
            s = store.clone()
            b = LinearBarrier("ibar", s, rank, 2)
            b.arrive(timeout=10.0)
            b.depart(timeout=10.0)
            s.close()
        except BaseException as e:  # noqa: B036
            errs.append((rank, e))

    try:
        # Probabilistic plan: each rpc independently blips 30% of the
        # time, seeded — every request retries through it idempotently.
        faultinject.configure("dist_store.rpc@p0.3=transient;seed=9")
        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
    finally:
        faultinject.disable()
    assert store.get("ibar/arrive/0") == b"1"
    assert store.get("ibar/arrive/1") == b"1"
    assert store.get("ibar/depart") == b"1"
    store.close()


def test_exhausted_rpc_blips_propagate_without_latching():
    """A plan that blips every attempt exhausts the bounded resend budget
    and propagates the transient — but the connection stays usable once
    the plan clears (a blip is not a torn store)."""
    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    try:
        faultinject.configure("dist_store.rpc@1+=transient")
        with pytest.raises(faultinject.InjectedTransientError):
            store.set("never", b"1")
        faultinject.disable()
        store.set("after", b"1")
        assert store.get("after") == b"1"
    finally:
        faultinject.disable()
        store.close()


# -------------------------------------------------------------- failover


def test_failover_mid_blocked_wait_any(replicated):
    """A client blocked in wait_any when the leader dies re-arms against
    the promoted replica and completes when the key appears there."""
    leader, standby, client = replicated
    got = {}

    def blocked():
        got["res"] = client.wait_any(["late-key"], timeout=60.0)

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.3)  # let the wait block server-side
    _kill_leader(leader)
    _wait_promoted(standby)
    writer = TCPStore("127.0.0.1", standby.port, timeout=10.0)
    writer.set("late-key", b"arrived")
    t.join(timeout=30)
    assert not t.is_alive(), "wait_any never re-armed after failover"
    assert got["res"] == ("late-key", b"arrived")
    assert client.failovers == 1
    writer.close()


def test_failover_preserves_data_dedup_and_blocking_ops(replicated):
    """The full client surface across a leader kill: reads see the
    replicated data, mutations keep flowing, exactly one failover is
    counted."""
    leader, standby, client = replicated
    client.set("pre", b"1")
    assert client.add("ctr", 7) == 7
    _kill_leader(leader)
    # Every op after the kill fails over transparently.
    assert client.get("pre", timeout=30.0) == b"1"
    assert client.add("ctr", 1) == 8
    assert client.check("__prime__")
    client.mset({"post/1": b"a"})
    assert client.delete("post/1") is True
    assert client.failovers == 1
    st = client.status()
    assert st["role"] == "leader" and st["epoch"] == 2


def test_clone_fails_over_to_promoted_replica(replicated):
    """clone() (the async-commit thread's bootstrap) targets the dead
    leader first, then the replica set."""
    leader, standby, client = replicated
    _kill_leader(leader)
    _wait_promoted(standby)
    c2 = client.clone()
    c2.set("via-clone", b"1")
    assert c2.get("via-clone", timeout=5.0) == b"1"
    c2.close()


def test_surviving_client_retracts_its_false_death_key(replicated):
    """Review regression: a client whose CONNECTION dropped but whose
    process survived (failover over a blip, leader still alive) must
    retract the death key the server flushed for it — otherwise every
    collective watches a sticky false death forever. A different rank's
    genuine death record in the same key is preserved (value-conditional
    delete)."""
    import socket as socket_mod

    leader, standby, client = replicated
    observer = TCPStore("127.0.0.1", leader.port, timeout=10.0)
    client.register_liveness("pgw/death", b"rank-3-died")
    # Tear the CONNECTION only (the process lives): the server's handler
    # flushes the death key.
    client._sock.shutdown(socket_mod.SHUT_RDWR)
    deadline = time.monotonic() + 10
    while not observer.check("pgw/death") and time.monotonic() < deadline:
        time.sleep(0.02)
    assert observer.check("pgw/death"), "server never flushed the death key"
    # The client's next op fails over (re-adopting the live leader) and
    # retracts its own false death.
    client.set("recovered", b"1")
    assert client.failovers == 1
    assert not observer.check("pgw/death"), "false death key not retracted"
    # A DIFFERENT rank's genuine death is not erased by the retraction:
    observer.set("pgw/death", b"rank-7-died")  # first-death-wins record
    client._sock.shutdown(socket_mod.SHUT_RDWR)
    client.set("recovered2", b"1")
    assert client.failovers == 2
    assert observer.get("pgw/death", timeout=5.0) == b"rank-7-died"
    observer.close()


def test_late_flush_of_superseded_connection_does_not_publish_death():
    """Review regression: when the same client has RE-registered its
    liveness over a newer connection (failover over a blip), a late
    drop of the OLD connection must not publish the death key — only
    the connection currently holding the registration may."""
    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    old = _raw_client(store)
    new = _raw_client(store)
    try:
        for sock in (old, new):  # `new` supersedes `old` for (cidZ, key)
            assert _roundtrip(
                sock,
                {"op": "register_liveness", "key": "death/z",
                 "value": b"z-died", "cid": "cidZ"},
            )["ok"]
        old.close()  # late FIN of the superseded connection
        time.sleep(0.5)
        assert not store.check("death/z"), "superseded drop published death"
        new.close()  # the CURRENT registration dropping IS a death
        deadline = time.monotonic() + 10
        while not store.check("death/z") and time.monotonic() < deadline:
            time.sleep(0.02)
        assert store.get("death/z", timeout=5.0) == b"z-died"
    finally:
        store.close()


def test_lease_renewals_flow(replicated):
    leader, standby, client = replicated
    time.sleep(LEASE * 3)
    st = client.status()
    (rep,) = st["replicas"]
    assert rep["lease_age_s"] < LEASE * 2
    assert rep["lag"] == 0


# --------------------------------------------------------- epoch fencing


def test_stalled_leader_is_rejoined_not_deposed(replicated):
    """Review regression: a leader that stalls past one lease (GC pause,
    GIL-held checkpoint serialization) but recovers must be REJOINED by
    its standby — index-0 standbys previously assumed with zero probes,
    silently forking the tier."""
    leader, standby, client = replicated
    srv = leader._server
    # Simulate the stall: hold the server's data lock, which freezes
    # dispatch AND the lease loop's renewal snapshot (whois is served
    # lock-free, exactly like a real stalled-then-recovered process
    # whose kernel keeps answering).
    srv._cond.acquire()
    try:
        time.sleep(LEASE * 3)
    finally:
        srv._cond.release()
    deadline = time.monotonic() + 15
    rejoined = False
    while time.monotonic() < deadline:
        with srv._cond:
            active = [l for l in srv._replicas if not l.syncing]
        if (
            standby._role == "standby"
            and standby._epoch == 1
            and len(active) == 1
        ):
            rejoined = True
            break
        time.sleep(0.05)
    assert rejoined, (
        standby._role,
        standby._epoch,
        srv._role,
        srv._epoch,
    )
    assert srv._role == "leader" and srv._epoch == 1
    # The tier still works end to end, with no client failover needed.
    client.set("post-stall", b"1")
    assert client.get("post-stall", timeout=5.0) == b"1"
    assert client.failovers == 0


def test_client_dedup_table_is_bounded():
    """Review regression: the idempotency table evicts
    least-recently-writing clients past CLIENT_SEQ_CAP instead of
    leaking one entry per client forever."""
    from torchsnapshot_tpu_torch.dist_store import CLIENT_SEQ_CAP

    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    sock = _raw_client(store)
    try:
        for i in range(CLIENT_SEQ_CAP + 50):
            r = _roundtrip(
                sock,
                {"op": "set", "key": "k", "value": b"v",
                 "cid": f"c{i}", "cseq": 1},
            )
            assert r["ok"]
        table = store._server._client_seqs
        assert len(table) == CLIENT_SEQ_CAP
        assert "c0" not in table  # oldest evicted
        assert f"c{CLIENT_SEQ_CAP + 49}" in table  # newest kept
    finally:
        sock.close()
        store.close()


def test_replica_rejects_stale_epoch_stream(replicated):
    """Epoch fencing at the protocol level: a replicate stamped with a
    lower epoch than the replica's is refused (``stale_epoch``), raises
    the deposition marker on the sender, and is NOT applied."""
    leader, standby, client = replicated
    link = leader._server._replicas[0]
    with pytest.raises(_DeposedError):
        link.send(
            {
                "op": "replicate",
                "epoch": 0,  # below the replica's epoch (1)
                "seq": 999,
                "req": {"op": "set", "key": "stale", "value": b"poison"},
            },
            timeout=5.0,
        )
    assert "stale" not in standby._data


def test_deposed_mid_replicate_write_is_not_acked(replicated):
    """Review regression: a leader that learns it was deposed DURING the
    synchronous replicate of a write must answer ``not_leader``, not
    ``ok`` — the write lives only on the dead lineage and the client
    must replay it against the promoted leader."""
    leader, standby, client = replicated
    # Simulate a promotion that happened elsewhere: the standby moves to
    # a higher epoch, so the leader's next replicate draws stale_epoch.
    with standby._cond:
        standby._epoch += 1
    sock = _raw_client(leader)
    try:
        resp = _roundtrip(
            sock,
            {"op": "set", "key": "doomed", "value": b"x", "cid": "cX", "cseq": 1},
        )
        assert resp.get("not_leader"), resp
        assert not resp.get("ok"), resp
        info = _roundtrip(sock, {"op": "whois"})
        assert info["role"] == "deposed"
    finally:
        sock.close()


def test_failover_budget_scales_with_probed_lease(replicated):
    """Review regression: the client's failover budget must follow the
    LARGEST lease any probed candidate reports (a server built with a
    long lease parameter keeps its standby in a fencing wait far past
    the env default)."""
    leader, standby, client = replicated
    assert client._failover_budget_s(0.0) == pytest.approx(
        max(4.0 * 5.0, 10.0)
    )
    assert client._failover_budget_s(30.0) == pytest.approx(120.0)
    # whois advertises the lease the budget learns from.
    from torchsnapshot_tpu_torch.dist_store import _try_whois

    info = _try_whois(leader.addr)
    assert info["lease_s"] == pytest.approx(LEASE)


def test_rs_update_stale_epoch_deposes_leader(replicated):
    """Review regression: fencing evidence arriving on an rs_update
    answer (not just replicate/lease) must depose the old leader, not
    merely drop the fenced replica."""
    leader, standby, client = replicated
    with standby._cond:
        standby._epoch += 1
    leader._server._broadcast_rs_update()
    assert leader._server._role == "deposed"


def test_promoted_join_connection_not_tracked_as_client_conn(replicated):
    """Review regression: a replica-join connection's accept-time
    tracking entry is released once the link owns the socket (standbys
    blip and rejoin for months; each cycle must not leak a ref)."""
    leader, standby, client = replicated
    srv = leader._server
    (link,) = srv._replicas
    with srv._conns_lock:
        assert link.sock not in srv._conns


def test_deposed_leader_answers_not_leader(replicated):
    """A leader that received fencing evidence stops serving: clients get
    ``not_leader`` and fail over instead of writing into a dead epoch."""
    leader, standby, client = replicated
    with leader._server._cond:
        leader._server._depose_locked()
    # The standby's upstream link died with the deposition; it promotes.
    _wait_promoted(standby)
    client.set("after-depose", b"1")
    assert client.get("after-depose", timeout=10.0) == b"1"
    assert client.failovers == 1
    assert client.status()["epoch"] == 2


# ------------------------------------------------------- connect retries


def test_connect_retries_outwait_slow_server_start():
    """TCPStore's bounded, jittered connect-retry: a server that binds
    late is reached; retries=0 preserves the instant-refusal behavior."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()

    with pytest.raises(ConnectionRefusedError):
        TCPStore("127.0.0.1", port, connect_retries=0)

    started = {}

    def late_server():
        time.sleep(0.8)
        started["server"] = TCPStore("127.0.0.1", port, is_server=True)

    t = threading.Thread(target=late_server)
    t.start()
    try:
        client = TCPStore("127.0.0.1", port, connect_retries=6, timeout=10.0)
        client.set("late", b"ok")
        assert client.get("late") == b"ok"
        client.close()
    finally:
        t.join(timeout=10)
        if "server" in started:
            started["server"].close()


def test_connection_lost_error_role_parametrized():
    err = StoreConnectionLostError("1.2.3.4:5", "get", OSError("boom"))
    assert "rank 0, the snapshot leader" in str(err)
    err = StoreConnectionLostError(
        "1.2.3.4:5", "get", OSError("boom"),
        role="the store leader at epoch 3; failover exhausted",
    )
    assert "epoch 3" in str(err) and "rank 0" not in str(err)
    assert err.role.startswith("the store leader")


# ----------------------------------------------------------- bootstrap


# ---------------------------------------------------------- store-status


def test_probe_store_status(replicated):
    leader, standby, client = replicated
    info = probe_store_status(leader.addr)
    assert info["role"] == "leader" and info["epoch"] == 1
    (rep,) = info["replicas"]
    assert rep["addr"].endswith(str(standby.port))

    standby_info = probe_store_status(f"127.0.0.1:{standby.port}")
    assert standby_info["role"] == "standby"
    assert standby_info["leader"] == leader.addr


def test_serve_op_site_counts_hits():
    """The server-side fault site: every dispatched client op counts one
    ``dist_store.serve_op`` hit — the hook the SIGKILL-the-store-host
    chaos schedules are pinned to."""
    store = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    try:
        faultinject.configure("dist_store.serve_op@999=delay:0")
        before = faultinject.hits().get("dist_store.serve_op", 0)
        store.set("a", b"1")
        store.get("a")
        store.check("a")
        after = faultinject.hits().get("dist_store.serve_op", 0)
        assert after - before == 3
    finally:
        faultinject.disable()
        store.close()


# ------------------------------------------------ store-host kill drills
#
# The store leader lives in rank 0's process by default: its death must
# fail every survivor within seconds, naming the coordination store, and
# commit nothing; a fresh world restores the last committed snapshot. With
# the leader in a dedicated host process and one standby (rank 1), killing
# the host mid-take fails over and the take commits bit-exact.

SHAPE = (6, 8)
STORE_KILL_PLAN = "dist_store.serve_op@14=kill;seed=601"


def _data(rank: int = 0) -> torch.Tensor:
    return torch.arange(48, dtype=torch.float32).reshape(SHAPE) + rank


def _chain(e: BaseException):
    chain, cur, seen = [], e, set()
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        chain.append(cur)
        cur = cur.__cause__ or cur.__context__
    return chain


def _names_the_store(e: BaseException) -> bool:
    chain = _chain(e)
    return any(isinstance(c, StoreConnectionLostError) for c in chain) and any(
        "coordination store" in str(c) for c in chain
    )


def _spof_worker(rank, world_size, committed_root, doomed_root):
    """Commit a snapshot; then take again while rank 0 (the store host)
    SIGKILLs itself mid-staging: the survivors must abort fast."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferStager

    Snapshot.take(
        committed_root, {"m": StateDict(emb=_data(rank), host=_data())}, replicated=["m/host"]
    )
    if rank == 0:

        async def die_mid_staging(self, executor=None):
            # Peers finish their own staging and block in the manifest
            # gather first; the store server dies with this process.
            time.sleep(2.0)
            os.kill(os.getpid(), signal.SIGKILL)

        ArrayBufferStager.stage_buffer = die_mid_staging
    t0 = time.monotonic()
    try:
        Snapshot.take(
            doomed_root, {"m": StateDict(emb=_data(rank) + 1, host=_data())}, replicated=["m/host"]
        )
    except BaseException as e:  # noqa: B036 - the outcome under test
        return ("aborted" if _names_the_store(e) else repr(e), time.monotonic() - t0)
    return ("NOT-ABORTED", time.monotonic() - t0)


def _recovery_worker(rank, world_size, committed_root):
    """A fresh, smaller world restores the committed snapshot: replicated
    entries on every rank, per-rank entries on the rank that saved them."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    dst = StateDict(emb=torch.zeros(SHAPE), host=torch.zeros(SHAPE))
    Snapshot(committed_root).restore({"m": dst})
    return torch.equal(dst["host"], _data()) and torch.equal(dst["emb"], _data(rank))


def test_store_host_death_aborts_fast_and_world_recovers(tmp_path) -> None:
    committed, doomed = str(tmp_path / "committed"), str(tmp_path / "doomed")
    results = run_with_subprocesses(
        _spof_worker, 3, committed, doomed, timeout=120.0, expect_dead=(0,)
    )
    assert set(results) == {1, 2}, results
    for rank, (status, elapsed) in results.items():
        assert status == "aborted", results
        assert elapsed < 60.0, f"rank {rank} took {elapsed:.1f}s to abort"
    assert not os.path.exists(os.path.join(doomed, ".snapshot_metadata"))
    assert os.path.isfile(os.path.join(committed, ".snapshot_metadata"))
    assert run_with_subprocesses(_recovery_worker, 2, committed, timeout=120.0) == {0: True, 1: True}


def _wait_any_worker(rank, world_size):
    """Rank 0 (the store host) SIGKILLs itself while its peers block in a
    long wait_any: they must raise within seconds."""
    from torchsnapshot_tpu_torch.pg_wrapper import get_default_pg

    store = get_default_pg().store
    store.add("armed", 1)
    store.get("armed")
    if rank == 0:
        time.sleep(1.5)  # the peers block in wait_any on the server
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.monotonic()
    try:
        store.wait_any(["never-set"], timeout=600.0)
    except StoreConnectionLostError:
        return ("aborted", time.monotonic() - t0)
    return ("NOT-ABORTED", time.monotonic() - t0)


def test_leader_death_mid_wait_any_no_replicas_bounded() -> None:
    results = run_with_subprocesses(_wait_any_worker, 3, timeout=120.0, expect_dead=(0,))
    assert set(results) == {1, 2}, results
    for rank, (status, elapsed) in results.items():
        assert status == "aborted", results
        assert elapsed < 60.0, f"rank {rank} took {elapsed:.1f}s"


def _commit_barrier_worker(rank, world_size, root):
    """Commit ``prev``; then rank 0, the store host, is SIGKILLed at the
    metadata commit point, its peer parked in the commit barrier."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    Snapshot.take(os.path.join(root, "prev"), {"m": StateDict(emb=_data(rank))})
    if rank == 0:
        faultinject.configure("commit.metadata@1=kill")
    t0 = time.monotonic()
    try:
        Snapshot.take(os.path.join(root, "doomed"), {"m": StateDict(emb=_data(rank) + 1)})
    except BaseException as e:  # noqa: B036 - the outcome under test
        named = any(isinstance(c, StoreConnectionLostError) for c in _chain(e))
        return ("aborted" if named else repr(e), time.monotonic() - t0)
    return ("NOT-ABORTED", time.monotonic() - t0)


def test_leader_death_mid_commit_barrier_no_replicas_bounded(tmp_path) -> None:
    """The kill at the commit point, no replicas: the survivor aborts in
    bounded time, the doomed take commits nothing and ``prev`` restores."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    results = run_with_subprocesses(
        _commit_barrier_worker, 2, str(tmp_path), timeout=120.0, expect_dead=(0,)
    )
    assert set(results) == {1}, results
    status, elapsed = results[1]
    assert status == "aborted", results
    assert elapsed < 60.0, f"survivor took {elapsed:.1f}s to abort"
    assert not os.path.exists(tmp_path / "doomed" / ".snapshot_metadata")
    dst = {"m": StateDict(emb=torch.zeros(SHAPE))}
    Snapshot(str(tmp_path / "prev")).restore(dst)
    assert torch.equal(dst["m"]["emb"], _data(0))


def _store_kill_worker(rank, world_size, root):
    """Take and restore while the external store host is SIGKILLed at its
    14th served op (mid-take)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.pg_wrapper import get_default_pg

    g = torch.Generator().manual_seed(100 + rank)
    state = {"model": StateDict(w=torch.randn(20_000, generator=g), step=torch.tensor([rank]))}
    t0 = time.monotonic()
    try:
        Snapshot.take(os.path.join(root, "cur"), state)
        dst = {"model": StateDict(w=torch.zeros(20_000), step=torch.zeros(1, dtype=torch.int64))}
        Snapshot(os.path.join(root, "cur")).restore(dst)
    except BaseException as e:  # noqa: B036 - the no-replica schedule
        return {
            "aborted": True,
            "named": any(isinstance(c, StoreConnectionLostError) for c in _chain(e)),
            "elapsed": time.monotonic() - t0,
        }
    return {
        "aborted": False,
        "failovers": get_default_pg().store.failovers,
        "bit_exact": all(torch.equal(dst["model"][k], state["model"][k]) for k in ("w", "step")),
    }


def test_store_host_kill_mid_take_fails_over_and_commits(tmp_path) -> None:
    """The store leader in a dedicated host, one standby on rank 1: the
    host's SIGKILL mid-take fails every client over once, and the take
    commits and restores bit-exact."""
    results = run_with_subprocesses(
        _store_kill_worker, 2, str(tmp_path), timeout=120.0, store_replicas=1,
        store_lease_s=0.5, external_store=True, store_host_plan=STORE_KILL_PLAN,
    )
    assert set(results) == {0, 1}, results
    for rank, out in results.items():
        assert not out["aborted"] and out["bit_exact"], (rank, out)
        assert out["failovers"] == 1, (rank, out)
    assert os.path.exists(tmp_path / "cur" / ".snapshot_metadata")


def test_store_host_kill_no_replicas_fails_bounded(tmp_path, monkeypatch) -> None:
    """The same schedule with no standby: every rank fails within the
    bounded barrier deadline, naming the store, and nothing commits."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_BARRIER_TIMEOUT", "15")
    t0 = time.monotonic()
    results = run_with_subprocesses(
        _store_kill_worker, 2, str(tmp_path), timeout=120.0, external_store=True,
        store_host_plan=STORE_KILL_PLAN,
    )
    for rank, out in results.items():
        assert out["aborted"] and out["named"], (rank, out)
    assert not os.path.exists(tmp_path / "cur" / ".snapshot_metadata")
    assert time.monotonic() - t0 < 100
