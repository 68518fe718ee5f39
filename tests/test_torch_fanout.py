"""Cooperative restore fan-out (``fanout.py``), the peer channel of
``dist_store.py`` and the scheduler's peer read path, against the JAX
package.

Pure functions run through both packages on the same inputs (built from a
numpy seed): the partitioner, unit keys and content ids, the peer frame
bytes, and the governor's election with its dead band. Session pairs in
this process drive the scheduler's owner and receiver ends: a bit-exact
forward into an empty storage directory, an owner's stream restart that
must never splice, and an abort, a silent owner and a dead owner, each
degrading to one direct read. One spawned world of 2 (the port's store,
no ``torch.distributed``) restores replicated state under
``TORCHSNAPSHOT_GPU_COOP_RESTORE`` always / never / skewed, through a
3-deep incremental chain, with the owner's channel dying mid-entry, under a
budget that only the dispatch escape gets through, and from a snapshot the
JAX package wrote; it counts the bytes the fs plugin served and the flag
all-gathers of a restore.
"""

from __future__ import annotations

import asyncio
import os
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchsnapshot_tpu.dist_store as JD
import torchsnapshot_tpu.fanout as JF
import torchsnapshot_tpu_torch.dist_store as PD
from torchsnapshot_tpu_torch import fanout as F
from torchsnapshot_tpu_torch.dist_store import PeerListener, peer_connect, recv_peer_frame, send_peer_frame
from torchsnapshot_tpu_torch.fanout import CoopKeyPlan, CoopRestoreSession, unit_key
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer, DeviceStreams
from torchsnapshot_tpu_torch.io_types import ReadReq, ReadStream, StreamRestartRequired, WriteIO
from torchsnapshot_tpu_torch.manifest import ArrayEntry
from torchsnapshot_tpu_torch.scheduler import IOGovernor, execute_read_reqs
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

SUB = 64 << 10


# ------------------------------------------------------------ pure functions


@pytest.mark.parametrize("world_size", [1, 2, 3, 8])
def test_greedy_partition_matches_the_jax_package(world_size) -> None:
    rng = np.random.default_rng(world_size)
    sizes = [int(s) for s in rng.integers(1, 1 << 20, size=200)]
    assert F.greedy_size_balanced(sizes, world_size) == JF.greedy_size_balanced(sizes, world_size)
    candidates = [
        sorted(int(r) for r in rng.choice(world_size, size=rng.integers(1, world_size + 1), replace=False))
        for _ in sizes
    ]
    owners = F.greedy_size_balanced(sizes, world_size, candidates)
    assert owners == JF.greedy_size_balanced(sizes, world_size, candidates)
    assert all(o in c for o, c in zip(owners, candidates))


def test_take_partition_is_the_fanout_partitioner() -> None:
    from torchsnapshot_tpu_torch import snapshot

    assert snapshot.greedy_size_balanced is F.greedy_size_balanced


def test_unit_keys_and_content_ids_match_the_jax_package() -> None:
    reqs = [
        ("replicated/model/w", None, None),
        ("sharded/model/w_0_0", (0, 10), None),
        ("sharded/model/w_0_0", (10, 20), None),
        ("replicated/x", None, "/base/snap"),
        ("replicated/x", (5, 5), None),  # empty: never shared
        ("0/model/w", None, None),  # per-rank
        ("batched/abc123", (0, 8), None),  # slab
    ]
    for path, br, origin in reqs:
        rr = SimpleNamespace(path=path, byte_range=br, origin=origin)
        assert F.unit_key(rr) == JF.unit_key(rr)
        assert F.content_unit_id("/snap", path, br) == JF.content_unit_id("/snap", path, br)
    keys = [F.unit_key(SimpleNamespace(path=p, byte_range=b, origin=o)) for p, b, o in reqs]
    assert keys[4:] == [None, None, None]
    assert len(set(keys[:4])) == 4
    buf = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8)
    assert F.content_address(buf) == JF.content_address(buf)


def test_coop_mode_parser(monkeypatch) -> None:
    for raw, want in [("never", "never"), ("0", "never"), ("always", "always"), ("1", "always"),
                      ("auto", "auto"), ("", "auto"), ("bogus", "auto")]:
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_COOP_RESTORE", raw)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_COOP_RESTORE", raw)
        assert F.coop_restore_mode() == want == JF.coop_restore_mode()
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_COOP_TIMEOUT", "0.2")
    assert F.coop_timeout_s() == 1.0


def test_elections_match_the_jax_package_with_the_dead_band(monkeypatch) -> None:
    """The same recorded rates give the same coop and reshard decisions in
    both governors, crossings of the 1 GB/s knee and its dead band
    included."""
    from torchsnapshot_tpu.scheduler import IOGovernor as JGovernor

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_AUTOTUNE", "never")
    rates = [None, 5e8, 1.05e9, 1.2e9, 0.95e9, 0.85e9, 1e10, 2e8]
    for gate in ("should_coop_restore", "should_planned_reshard"):
        port, jax_gov = IOGovernor(), JGovernor()
        got, want = [], []
        for bps in rates:
            for gov in (port, jax_gov):
                if bps is not None:
                    # Overwrite the smoothed rate: the knee sees exactly bps.
                    gov._read_bps["S3StoragePlugin"] = bps
            got.append(getattr(port, gate)("S3StoragePlugin"))
            want.append(getattr(jax_gov, gate)("S3StoragePlugin"))
        assert got == want == [False, True, True, False, False, True, False, True]


def test_world_size_1_never_offers() -> None:
    offer = CoopRestoreSession.local_offer("FSStoragePlugin", SimpleNamespace(get_world_size=lambda: 1))
    assert offer.addr is None and not offer.coop_in
    assert offer.engage([None], 0, None) is None


# ------------------------------------------------------------- peer frames


def _frame_bytes(mod, header, payload) -> bytes:
    a, b = socket.socketpair()

    def send():
        mod.send_peer_frame(a, header, payload)
        a.shutdown(socket.SHUT_WR)

    sender = threading.Thread(target=send)
    sender.start()
    try:
        out = b""
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                return out
            out += chunk
    finally:
        sender.join(timeout=10)
        a.close()
        b.close()


@pytest.mark.parametrize("nbytes", [0, 1, 257_123])
def test_peer_frames_are_byte_identical_to_the_jax_package(nbytes) -> None:
    payload = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    header = {"op": "chunk", "key": "|replicated/x|-1|-1", "gen": 2, "seq": 7}
    raw = _frame_bytes(PD, header, payload or None)
    assert raw == _frame_bytes(JD, header, payload or None)
    # Each package decodes the other's frame.
    for mod in (PD, JD):
        a, b = socket.socketpair()
        sender = threading.Thread(target=a.sendall, args=(raw,))
        sender.start()
        try:
            got_header, got = mod.recv_peer_frame(b)
        finally:
            sender.join(timeout=10)
            a.close()
            b.close()
        assert got_header == header
        assert (bytes(got) if got is not None else b"") == payload


def test_peer_listener_roundtrip() -> None:
    got = []
    received = threading.Event()

    def handler(conn):
        try:
            while True:
                header, payload = recv_peer_frame(conn)
                got.append((header, bytes(payload) if payload is not None else None))
                if header.get("op") == "bye":
                    return
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            received.set()

    listener = PeerListener()
    listener.start(handler)
    try:
        sock = peer_connect(f"127.0.0.1:{listener.port}")
        payload = os.urandom(257_123)
        send_peer_frame(sock, {"op": "hello", "rank": 3})
        send_peer_frame(sock, {"op": "chunk", "key": "k", "gen": 1, "seq": 0}, payload)
        send_peer_frame(sock, {"op": "bye"})
        assert received.wait(10.0)
        sock.close()
    finally:
        listener.close()
    assert got == [({"op": "hello", "rank": 3}, None),
                   ({"op": "chunk", "key": "k", "gen": 1, "seq": 0}, payload), ({"op": "bye"}, None)]


def test_peer_fault_sites_are_registered() -> None:
    from torchsnapshot_tpu_torch import faultinject

    assert faultinject.SITES["peer.send_frame"] == "data"
    assert faultinject.SITES["peer.recv_frame"] == "control"
    assert faultinject.SITES["reshard.peer_xfer"] == "data"


# ------------------------------------------------- session pairs, one process


@pytest.fixture
def loops():
    loop0, loop1 = asyncio.new_event_loop(), asyncio.new_event_loop()
    yield loop0, loop1
    loop0.close()
    loop1.close()


def _session_pair(loop0, loop1):
    l0, l1 = PeerListener(), PeerListener()
    addrs = [f"127.0.0.1:{l0.port}", f"127.0.0.1:{l1.port}"]
    s0 = CoopRestoreSession(0, addrs, l0, loop0)
    s1 = CoopRestoreSession(1, addrs, l1, loop1)
    s0._connect_peers()
    s1._connect_peers()
    return s0, s1


def _entry_for(arr: np.ndarray, location: str) -> ArrayEntry:
    from torchsnapshot_tpu_torch.integrity import compute_checksum

    entry = ArrayEntry(location=location, serializer="buffer_protocol", dtype="uint8",
                       shape=[arr.size], replicated=True)
    entry.checksum = compute_checksum(arr.tobytes())
    return entry


def _req(entry: ArrayEntry, out: list) -> ReadReq:
    return ReadReq(path=entry.location,
                   buffer_consumer=ArrayBufferConsumer(entry, None, out.append, DeviceStreams()))


def _write(loop, plugin, path, payload) -> None:
    loop.run_until_complete(plugin.write(WriteIO(path=path, buf=payload)))


def _bytes(t) -> bytes:
    return t.numpy().tobytes()


@pytest.mark.parametrize("stream", ["always", "never"])
def test_owner_forwards_receiver_consumes_bit_exact(tmp_path, loops, monkeypatch, stream) -> None:
    """The owner reads (streamed or buffered) and forwards; the receiver's
    storage directory is empty, so its bit-exact result came over the peer
    channel, verified by its own checksum."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(SUB))
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", stream)
    loop0, loop1 = loops
    arr = np.frombuffer(os.urandom(400_000), np.uint8).copy()
    owner_fs = FSStoragePlugin(str(tmp_path / "full"))
    empty_fs = FSStoragePlugin(str(tmp_path / "empty"))
    _write(loop0, owner_fs, "replicated/x", arr.tobytes())
    s0, s1 = _session_pair(loop0, loop1)
    before = F.peer_counts.copy()
    try:
        entry = _entry_for(arr, "replicated/x")
        out0, out1 = [], []
        req0, req1 = _req(entry, out0), _req(entry, out1)
        key = unit_key(req0)
        # The owner runs first: its frames wait in the receiver's staged
        # inboxes until the receiver's loop takes them.
        loop0.run_until_complete(execute_read_reqs([req0], owner_fs, 1 << 30, 0, coop=CoopKeyPlan(s0, {key: [1]}, {})))
        loop1.run_until_complete(execute_read_reqs([req1], empty_fs, 1 << 30, 1, coop=CoopKeyPlan(s1, {}, {key: 0})))
        assert _bytes(out0[0]) == arr.tobytes() and _bytes(out1[0]) == arr.tobytes()
    finally:
        s0.close()
        s1.close()
    assert F.peer_counts["bytes_from_peers"] - before["bytes_from_peers"] == arr.nbytes
    assert F.peer_counts["bytes_to_peers"] - before["bytes_to_peers"] == arr.nbytes
    assert F.peer_counts["fanout_fallbacks"] == before["fanout_fallbacks"]


@pytest.mark.parametrize("receiver", ["streamed", "buffered"])
def test_owner_restart_never_splices_on_peer_path(tmp_path, loops, monkeypatch, receiver) -> None:
    """The owner's stream yields one wrong sub-chunk and then asks for a
    restart; the owner re-reads buffered as a new generation. The receiver
    (consuming the frames streamed, or buffered whole) reads from an empty
    directory, so a splice of the first generation's bytes would fail its
    checksum and its fallback both."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(SUB))
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    loop0, loop1 = loops
    arr = np.frombuffer(os.urandom(400_000), np.uint8).copy()

    class RestartingFS(FSStoragePlugin):
        async def read_stream(self, read_io, sub_chunk_bytes):
            inner = await super().read_stream(read_io, sub_chunk_bytes)

            async def chunks():
                first = await inner.chunks.__anext__()
                await inner.chunks.aclose()
                yield bytes(memoryview(first).nbytes)  # not the stored bytes
                raise StreamRestartRequired("injected restart after one sub-chunk")

            return ReadStream(path=inner.path, nbytes=inner.nbytes, chunks=chunks())

    owner_fs = RestartingFS(str(tmp_path / "full"))
    _write(loop0, owner_fs, "replicated/x", arr.tobytes())
    empty_fs = FSStoragePlugin(str(tmp_path / "empty"))
    s0, s1 = _session_pair(loop0, loop1)
    try:
        entry = _entry_for(arr, "replicated/x")
        out0, out1 = [], []
        req0, req1 = _req(entry, out0), _req(entry, out1)
        if receiver == "buffered":
            req1.buffer_consumer.can_stream = lambda sub_chunk_bytes: False
        key = unit_key(req0)
        loop0.run_until_complete(execute_read_reqs([req0], owner_fs, 1 << 30, 0, coop=CoopKeyPlan(s0, {key: [1]}, {})))
        loop1.run_until_complete(execute_read_reqs([req1], empty_fs, 1 << 30, 1, coop=CoopKeyPlan(s1, {}, {key: 0})))
        assert _bytes(out0[0]) == arr.tobytes() and _bytes(out1[0]) == arr.tobytes()
    finally:
        s0.close()
        s1.close()


@pytest.mark.parametrize("failure", ["abort", "timeout", "death"])
def test_peer_failure_degrades_to_one_direct_read(tmp_path, loops, monkeypatch, failure) -> None:
    """An owner that aborts, one that stays silent past the coop timeout,
    and one whose connection drops mid-unit: the receiver reads the entry
    from storage, bit-exact, counted, without waiting out a long timeout."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_COOP_TIMEOUT", "1" if failure == "timeout" else "30")
    loop0, loop1 = loops
    arr = np.frombuffer(os.urandom(200_000), np.uint8).copy()
    fs = FSStoragePlugin(str(tmp_path / "real"))
    _write(loop1, fs, "replicated/x", arr.tobytes())
    s0, s1 = _session_pair(loop0, loop1)
    before = F.peer_counts["fanout_fallbacks"]
    try:
        entry = _entry_for(arr, "replicated/x")
        out1 = []
        req1 = _req(entry, out1)
        key = unit_key(req1)
        if failure == "abort":
            CoopKeyPlan(s0, {key: [1]}, {}).abort_incomplete()  # gave up before reading
        elif failure == "death":
            sock, lock = s0._out[1]
            with lock:  # one chunk, then an unclean drop (no bye)
                send_peer_frame(sock, {"op": "chunk", "key": key, "gen": 1, "seq": 0}, arr.tobytes()[:1000])
                sock.close()
        t0 = time.perf_counter()
        loop1.run_until_complete(execute_read_reqs([req1], fs, 1 << 30, 1, coop=CoopKeyPlan(s1, {}, {key: 0})))
        assert time.perf_counter() - t0 < 10.0
        assert _bytes(out1[0]) == arr.tobytes()
    finally:
        s0.close()
        s1.close()
    assert F.peer_counts["fanout_fallbacks"] == before + 1


def test_known_dead_owner_is_read_directly_at_dispatch(tmp_path, loops) -> None:
    loop0, loop1 = loops
    s0, s1 = _session_pair(loop0, loop1)
    try:
        s1._dead.add(0)
        rr = SimpleNamespace(path="replicated/x", byte_range=None, origin=None)
        assert CoopKeyPlan(s1, {}, {F.unit_key(rr): 0}).take_role(rr) is None
    finally:
        s0.close()
        s1.close()


# ----------------------------------------------------------- a world of 2


def _state(seed: int, n: int = 4, kb_each: int = 384):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(kb_each * 256).astype(np.float32) for i in range(n)}


def _payload(state) -> int:
    return sum(v.nbytes for v in state.values())


def _install_read_counter():
    """Payload bytes the fs plugin served under ``replicated/`` and
    ``sharded/``, keyed by plugin root (buffered reads and streamed
    windows)."""
    counts: dict = {}

    def add(root, path, n):
        if path.startswith(("replicated/", "sharded/")):
            counts[root] = counts.get(root, 0) + n

    orig_read, orig_stream = FSStoragePlugin.read, FSStoragePlugin.read_stream

    async def read(self, read_io):
        await orig_read(self, read_io)
        add(self.root, read_io.path, memoryview(read_io.buf).nbytes)

    async def read_stream(self, read_io, sub_chunk):
        inner = await orig_stream(self, read_io, sub_chunk)
        root = self.root

        async def chunks():
            async for c in inner.chunks:
                add(root, read_io.path, memoryview(c).nbytes)
                yield c

        return ReadStream(path=inner.path, nbytes=inner.nbytes, chunks=chunks())

    FSStoragePlugin.read, FSStoragePlugin.read_stream = read, read_stream
    return counts


def _torch_state(state):
    from torchsnapshot_tpu_torch import StateDict

    return StateDict({k: torch.from_numpy(v.copy()) for k, v in state.items()})


def _restore_counted(root, state, counts, mode):
    """Restore ``root`` into zeros under ``mode``; (fs bytes, exact, peer
    counter deltas, flag gathers, seconds)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, pg_wrapper

    os.environ["TORCHSNAPSHOT_GPU_COOP_RESTORE"] = mode
    gathers = []
    orig = pg_wrapper.PGWrapper.all_gather_object

    def counting(self, obj, *args, **kwargs):
        gathers.append(obj)
        return orig(self, obj, *args, **kwargs)

    pg_wrapper.PGWrapper.all_gather_object = counting
    counts.clear()
    before = F.peer_counts.copy()
    dst = StateDict({k: torch.zeros(v.shape, dtype=torch.float32) for k, v in state.items()})
    t0 = time.monotonic()
    try:
        Snapshot(root).restore({"model": dst})
    finally:
        pg_wrapper.PGWrapper.all_gather_object = orig
    return {
        "read": sum(counts.values()),
        "by_root": {os.path.basename(r): n for r, n in counts.items()},
        "exact": all(dst[k].numpy().tobytes() == v.tobytes() for k, v in state.items()),
        "peer": {k: F.peer_counts[k] - before.get(k, 0) for k in F.peer_counts},
        "flag_gathers": sum(isinstance(o, tuple) and len(o) == 5 for o in gathers),  # (preverify, addr, coop, reshard, lazy)
        "seconds": time.monotonic() - t0,
    }


def _chain_states():
    v0 = _state(11, n=3, kb_each=256)
    v1 = dict(v0, w1=_state(12, n=3, kb_each=256)["w1"])
    v2 = dict(v1, w2=_state(13, n=3, kb_each=256)["w2"])
    return v0, v1, v2


def _take_chain(base):
    from torchsnapshot_tpu_torch import Snapshot

    roots = [os.path.join(base, f"snap{i}") for i in range(3)]
    for i, v in enumerate(_chain_states()):
        Snapshot.take(
            roots[i], {"model": _torch_state(v)}, replicated=["model/**"],
            record_digests=i == 0, incremental_base=roots[i - 1] if i else None,
        )
    return roots


def _world_worker(rank, world, root, jax_root):
    from torchsnapshot_tpu_torch import Snapshot, pg_wrapper

    os.environ["TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES"] = str(SUB)
    os.environ["TORCHSNAPSHOT_GPU_COOP_TIMEOUT"] = "30"
    state = _state(7)
    snap = os.path.join(root, "snap")
    Snapshot.take(snap, {"model": _torch_state(state)}, replicated=["model/**"])
    counts = _install_read_counter()
    out = {
        "always": _restore_counted(snap, state, counts, "always"),
        "never": _restore_counted(snap, state, counts, "never"),
        "skew": _restore_counted(snap, state, counts, "always" if rank == 0 else "never"),
    }
    # Only the dispatch escape gets a restore through a 1-byte budget: the
    # peer-fed entries, first in line, would hold it while they wait on
    # forwards that the owned entries behind them must send.
    os.environ["TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES"] = "1"
    out["tight_budget"] = _restore_counted(snap, state, counts, "always")
    del os.environ["TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES"]
    # The owner's data plane dies after its second forwarded chunk while
    # its restore and the collectives go on.
    if rank == 0:
        orig = F.CoopRestoreSession._send_one
        sent = {"n": 0}

        def dying_send(self, r, header, payload):
            if header.get("op") == "chunk":
                sent["n"] += 1
                if sent["n"] == 2:
                    for sock, _ in self._out.values():
                        sock.close()
            orig(self, r, header, payload)

        F.CoopRestoreSession._send_one = dying_send
    out["owner_death"] = _restore_counted(snap, state, counts, "always")
    if rank == 0:
        F.CoopRestoreSession._send_one = orig
    v2 = _chain_states()[2]
    roots = _take_chain(os.path.join(root, "chain"))
    out["chain"] = _restore_counted(roots[2], v2, counts, "always")
    out["from_jax"] = _restore_counted(jax_root, _state(5), counts, "always")
    out["rank"] = pg_wrapper.PGWrapper().get_rank()
    return out


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """A replicated snapshot the JAX package wrote."""
    import torchsnapshot_tpu as J

    root = str(tmp_path_factory.mktemp("jax") / "snap")
    J.Snapshot.take(root, {"model": J.StateDict(**_state(5))}, replicated=["**"])
    return root


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_root):
    root = str(tmp_path_factory.mktemp("coop"))
    return run_with_subprocesses(_world_worker, 2, root, jax_root, timeout=240.0)


CASES = ["always", "never", "skew", "tight_budget", "owner_death", "chain", "from_jax"]


@pytest.mark.parametrize("case", CASES)
def test_world_restores_bit_exact_with_one_flag_gather(world, case) -> None:
    for rank in (0, 1):
        assert world[rank][case]["exact"], (rank, case)
        assert world[rank][case]["flag_gathers"] == 1, (rank, case)


def test_coop_reads_each_replicated_byte_once(world) -> None:
    payload = _payload(_state(7))
    fleet = sum(world[r]["always"]["read"] for r in (0, 1))
    assert payload <= fleet <= 1.2 * payload, fleet / payload
    assert all(world[r]["always"]["peer"].get("bytes_from_peers", 0) > 0 for r in (0, 1))
    assert all(world[r]["always"]["peer"].get("fanout_fallbacks", 0) == 0 for r in (0, 1))


@pytest.mark.parametrize("case", ["never", "skew"])
def test_direct_and_skewed_restores_read_every_byte_twice(world, case) -> None:
    """``never`` reads each byte once a rank; env skew (one rank
    ``never``) disables cooperation everywhere and completes: no peer
    bytes, no hang."""
    payload = _payload(_state(7))
    assert sum(world[r][case]["read"] for r in (0, 1)) >= 1.8 * payload
    assert all(not world[r][case]["peer"].get("bytes_from_peers") for r in (0, 1))


def test_budget_blocked_head_escape(world) -> None:
    payload = _payload(_state(7))
    assert sum(world[r]["tight_budget"]["read"] for r in (0, 1)) <= 1.2 * payload
    assert all(world[r]["tight_budget"]["seconds"] < 20 for r in (0, 1))


def test_owner_channel_death_falls_back(world) -> None:
    """Rank 1 re-reads rank 0's units directly after the drop, at once
    (death-driven, not after the 30 s coop timeout)."""
    r1 = world[1]["owner_death"]
    assert r1["read"] > 0 and r1["peer"].get("fanout_fallbacks", 0) >= 1
    assert r1["seconds"] < 20
    assert sum(world[r]["owner_death"]["read"] for r in (0, 1)) >= _payload(_state(7))


def test_incremental_chain_reads_origins_once(world) -> None:
    """Entries of a 3-deep incremental chain come from the base snapshots'
    storage, on whichever rank owns them, about once in all."""
    v0, v1, v2 = _chain_states()
    by_root: dict = {}
    for r in (0, 1):
        for root, n in world[r]["chain"]["by_root"].items():
            by_root[root] = by_root.get(root, 0) + n
    assert sum(by_root.values()) <= 1.2 * _payload(v2), by_root
    assert by_root.get("snap0", 0) >= v0["w0"].nbytes
    assert by_root.get("snap1", 0) >= v1["w1"].nbytes


def test_jax_written_snapshot_restores_cooperatively(world) -> None:
    payload = _payload(_state(5))
    assert sum(world[r]["from_jax"]["read"] for r in (0, 1)) <= 1.2 * payload


def test_incremental_chain_world_of_one(tmp_path, monkeypatch) -> None:
    """``always`` in a world of 1: nothing to share, the direct path."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    monkeypatch.setenv("TORCHSNAPSHOT_GPU_COOP_RESTORE", "always")
    roots = _take_chain(str(tmp_path))
    v2 = _chain_states()[2]
    dst = StateDict({k: torch.zeros(v.shape) for k, v in v2.items()})
    Snapshot(roots[2]).restore({"model": dst})
    assert all(dst[k].numpy().tobytes() == v.tobytes() for k, v in v2.items())
