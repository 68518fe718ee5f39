"""Streamed restore of sharded pieces (``_ShardScatterConsumer.can_stream``
and ``consume_stream``) against the JAX package's, in one process.

The JAX package writes one state sharded over 4 of its 8 virtual CPU
devices in each layout of ``tests/test_torch_sharded.py`` (pieces cut to
at most ``CAP`` bytes, so that every layout has pieces on both sides of
the two-sub-chunk threshold), plain or zlib-compressed. Both packages
restore it under ``STREAM_READS`` always and never, and the port's
streamed pieces are counted against the JAX package's. The port then
restores it into the simulated ranks' DTensor boxes, with every piece
corrupted, as a peer-fed receiver of a cooperative restore (two event
loops, as in ``tests/test_torch_fanout.py``), across an owner's stream
restart, a peer that dies mid-unit and a mirror whose primary tears
mid-stream; a planned reshard keeps its buffered wrappers; and the
device-digest restore into destinations that hold the content consumes
nothing.
"""

from __future__ import annotations

import asyncio
import math
import os
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

import torchsnapshot_tpu as J
import torchsnapshot_tpu.io_preparers.sharded as JS
import torchsnapshot_tpu.reshard as JR
from torchsnapshot_tpu.integrity import IntegrityError as JIntegrityError
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import fanout as F
from torchsnapshot_tpu_torch import reshard as R
from torchsnapshot_tpu_torch import scheduler as SCH
from torchsnapshot_tpu_torch.dist_store import PeerListener, send_peer_frame
from torchsnapshot_tpu_torch.fanout import CoopKeyPlan, CoopRestoreSession, unit_key
from torchsnapshot_tpu_torch.integrity import IntegrityError
from torchsnapshot_tpu_torch.io_preparers import sharded as S
from torchsnapshot_tpu_torch.io_preparers.array import DeviceStreams
from torchsnapshot_tpu_torch.io_preparers.prepare import prepare_read
from torchsnapshot_tpu_torch.io_types import ReadStream, StreamRestartRequired
from torchsnapshot_tpu_torch.scheduler import execute_read_reqs, sync_execute_read_reqs
from torchsnapshot_tpu_torch.storage_plugins import mirror as mirror_mod
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.mirror import MirroredStoragePlugin
from torch_test_env import autotune_never  # noqa: F401 - autouse
from test_torch_sharded import LAYOUTS

SHAPE = (64, 96)  # 24,576 B of f32
# Pieces of at most CAP bytes: 4,992 B (compressed under zlib; streams),
# and tails of 1,152 B or 2,304 B (stored raw, under two sub-chunks).
CAP = 5000
SUB = 1200
CODECS = [None, "zlib"]
FILL = -3.0


@pytest.fixture(autouse=True)
def _small_pieces(monkeypatch):
    """Both packages cut pieces at CAP and stream in SUB-byte sub-chunks."""
    monkeypatch.setattr(S.ShardedArrayIOPreparer, "max_shard_size_bytes", CAP)
    monkeypatch.setattr(JS.ShardedArrayIOPreparer, "max_shard_size_bytes", CAP)
    for prefix in ("TORCHSNAPSHOT_GPU", "TORCHSNAPSHOT_TPU"):
        monkeypatch.setenv(f"{prefix}_SUB_CHUNK_BYTES", str(SUB))


def _stream_reads(monkeypatch, mode: str) -> None:
    for prefix in ("TORCHSNAPSHOT_GPU", "TORCHSNAPSHOT_TPU"):
        monkeypatch.setenv(f"{prefix}_STREAM_READS", mode)


def _full() -> np.ndarray:
    return np.random.default_rng(29).standard_normal(SHAPE).astype(np.float32)


def _sharding(layout: str) -> NamedSharding:
    mesh_shape, _, pspec = LAYOUTS[layout]
    names = ("x", "y")[: len(mesh_shape)]
    devices = np.array(jax.devices()[: math.prod(mesh_shape)]).reshape(mesh_shape)
    return NamedSharding(Mesh(devices, names), pspec)


def _take(root: str, layout: str, codec) -> S.ShardedArrayEntry:
    """The JAX package's sharded snapshot of ``_full()`` in ``layout``;
    its entry as the port parses it."""
    arr = jax.device_put(jnp.asarray(_full()), _sharding(layout))
    J.Snapshot.take(root, {"m": J.StateDict(w=arr)}, compression=codec)
    entry = P.Snapshot(root).get_manifest()["0/m/w"]
    assert isinstance(entry, S.ShardedArrayEntry)
    if codec is not None:
        assert any(s.array.codec for s in entry.shards)
    return entry


def _eligible(shard) -> bool:
    return math.prod(shard.sizes) * 4 >= 2 * SUB


def _views(layout: str, fill: float = FILL):
    mesh_shape, placements, _ = LAYOUTS[layout]
    ranks = torch.arange(math.prod(mesh_shape)).reshape(mesh_shape)
    boxes = S.shard_boxes(SHAPE, ranks, placements)
    return [
        S.ShardedView(SHAPE, boxes, r, torch.full([hi - lo for lo, hi in boxes[r]], fill))
        for r in range(len(boxes))
    ]


def _box_of(full: np.ndarray, view) -> torch.Tensor:
    return torch.from_numpy(full[tuple(slice(lo, hi) for lo, hi in view.local_box)])


def _run_reads(reqs, storage, rank: int = 0) -> None:
    loop = asyncio.new_event_loop()
    try:
        sync_execute_read_reqs(reqs, storage, 1 << 30, rank, loop)
    finally:
        loop.close()


def _overlaps(shard, box) -> bool:
    return S._overlap(shard.offsets, shard.sizes, box) is not None


@pytest.fixture
def jax_streams(monkeypatch):
    """The pieces the JAX package's scatter consumer took streamed."""
    seen = []
    orig = JS._ShardScatterConsumer.consume_stream

    async def spy(self, stream, executor=None):
        seen.append(self.shard.array.location)
        return await orig(self, stream, executor)

    monkeypatch.setattr(JS._ShardScatterConsumer, "consume_stream", spy)
    return seen


def _port_stream_reads() -> int:
    return SCH.stream_counts["entries_stream_read"]


# ------------------------------------------- storage-fed, both packages


@pytest.mark.parametrize("mode", ["always", "never"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streamed_restore_matches_the_jax_package(
        tmp_path, monkeypatch, jax_streams, layout, codec, mode) -> None:
    """Into a whole destination each package reads every piece once:
    under ``always`` both stream exactly the pieces of two sub-chunks or
    more, under ``never`` neither streams; both bit-exact."""
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    _stream_reads(monkeypatch, mode)
    full = _full()
    sd = J.StateDict(w=np.zeros(SHAPE, np.float32))
    J.Snapshot(root).restore({"m": sd})
    assert np.array_equal(np.asarray(sd["w"]), full)
    before = _port_stream_reads()
    dst = torch.zeros(SHAPE)
    P.Snapshot(root).restore({"m": P.StateDict(w=dst)})
    assert np.array_equal(dst.numpy(), full)
    eligible = sum(_eligible(s) for s in entry.shards)
    assert 0 < eligible < len(entry.shards)
    want = eligible if mode == "always" else 0
    assert len(jax_streams) == want
    assert _port_stream_reads() - before == want


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streamed_restore_into_sharded_destinations(
        tmp_path, monkeypatch, jax_streams, layout, codec) -> None:
    """Into the layout's own boxes: the JAX package (one process, all 4
    devices) streams each eligible piece once, the port's simulated ranks
    each stream the eligible pieces that meet their box; every box
    bit-exact in both."""
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    _stream_reads(monkeypatch, "always")
    full = _full()
    sd = J.StateDict(w=jax.device_put(jnp.zeros(SHAPE, jnp.float32), _sharding(layout)))
    J.Snapshot(root).restore({"m": sd})
    assert np.array_equal(np.asarray(sd["w"]), full)
    assert len(jax_streams) == sum(_eligible(s) for s in entry.shards)
    views = _views(layout)
    before = _port_stream_reads()
    for view in views:
        _run_reads(prepare_read(entry, view, None, DeviceStreams()), FSStoragePlugin(root), view.rank)
        assert torch.equal(view.local, _box_of(full, view)), view.rank
    assert _port_stream_reads() - before == sum(
        _eligible(s) and _overlaps(s, v.local_box) for v in views for s in entry.shards
    )


def _corrupt_every_piece(root: str, entry, sub: int) -> None:
    """Flip one stored byte of every piece, in its second ``sub``-byte
    sub-chunk where it has one."""
    for shard in entry.shards:
        path = os.path.join(root, shard.array.location)
        data = bytearray(open(path, "rb").read())
        at = sub + 7 if len(data) > sub + 7 else len(data) // 2
        data[at] ^= 0xFF
        with open(path, "wb") as f:
            f.write(data)


def _failures(codec, integrity_error=IntegrityError):
    """What a corrupt stored byte raises in a streamed consume: the chained
    CRC's mismatch, or, for zlib, first the codec's own error (both
    packages feed the decompressor before the CRC is complete)."""
    if codec is None:
        return (integrity_error, IOError)
    return (integrity_error, IOError, RuntimeError, zlib.error)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_corrupted_sub_chunk_raises_and_every_box_keeps_its_fill(
        tmp_path, monkeypatch, layout, codec) -> None:
    """Sub-chunks small enough that every piece streams, and one byte of
    each corrupted: each rank's restore raises and no box was written."""
    sub = 500
    for prefix in ("TORCHSNAPSHOT_GPU", "TORCHSNAPSHOT_TPU"):
        monkeypatch.setenv(f"{prefix}_SUB_CHUNK_BYTES", str(sub))
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    assert all(math.prod(s.sizes) * 4 >= 2 * sub for s in entry.shards)
    _corrupt_every_piece(root, entry, sub)
    _stream_reads(monkeypatch, "always")
    for view in _views(layout):
        with pytest.raises(_failures(codec)):
            _run_reads(prepare_read(entry, view, None, DeviceStreams()), FSStoragePlugin(root),
                       view.rank)
        assert bool((view.local == FILL).all()), view.rank
    with pytest.raises(_failures(codec, JIntegrityError)):
        J.Snapshot(root).restore({"m": J.StateDict(w=np.zeros(SHAPE, np.float32))})


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_corrupt_stream_raises_the_jax_packages_error_and_commits_nothing(
        tmp_path, layout, codec) -> None:
    """One eligible piece fed to each package's consumer in SUB-byte
    chunks, one byte flipped in the second: the same error class in both,
    no target written and no part completed."""
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    jentry = J.Snapshot(root).get_manifest()["0/m/w"]
    i = next(i for i, s in enumerate(entry.shards) if _eligible(s))
    stored = bytearray(open(os.path.join(root, entry.shards[i].array.location), "rb").read())
    stored[SUB + 7] ^= 0xFF

    async def chunks():
        for lo in range(0, len(stored), SUB):
            yield memoryview(stored)[lo : lo + SUB]

    sizes = entry.shards[i].sizes
    done = []
    port_dst = torch.full(sizes, FILL)
    port = S._ShardScatterConsumer(entry.shards[i], [(port_dst, (), ())],
                                   S._Completion(1, lambda: done.append("port")), DeviceStreams())
    jax_dst = np.full(sizes, FILL, np.float32)
    jax_consumer = JS._ShardScatterConsumer(jentry.shards[i], [(jax_dst, (), ())],
                                            JS._Completion(1, lambda: done.append("jax")))
    assert port.can_stream(SUB) and jax_consumer.can_stream(SUB)
    errors = []
    for consumer, integrity_error in ((port, IntegrityError), (jax_consumer, JIntegrityError)):
        loop = asyncio.new_event_loop()
        try:
            with pytest.raises(_failures(codec, integrity_error)) as e:
                loop.run_until_complete(
                    consumer.consume_stream(ReadStream(path="p", nbytes=len(stored), chunks=chunks()))
                )
        finally:
            loop.close()
        errors.append(type(e.value).__name__)
    assert errors[0] == errors[1]
    assert done == []
    assert bool((port_dst == FILL).all()) and bool((jax_dst == FILL).all())


def test_the_election_is_the_jax_packages_at_every_size(tmp_path) -> None:
    """``can_stream`` against the JAX consumer's over sub-chunk sizes
    around each piece's threshold; the admission cost stays the piece's
    raw size in both."""
    root = str(tmp_path / "s")
    entry = _take(root, "partial_repl", "zlib")
    jentry = J.Snapshot(root).get_manifest()["0/m/w"]
    for shard, jshard in zip(entry.shards, jentry.shards):
        port = S._ShardScatterConsumer(shard, [], None, DeviceStreams())
        ref = JS._ShardScatterConsumer(jshard, [], None)
        raw = math.prod(shard.sizes) * 4
        for sub in (1, raw // 2 - 1, raw // 2, raw // 2 + 1, raw, 1 << 20):
            assert port.can_stream(sub) == ref.can_stream(sub), (shard.offsets, sub)
            assert port.stream_admission_cost(sub) == ref.stream_admission_cost(sub) == raw


# ---------------------------------------------------------- peer-fed


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


@pytest.fixture
def part_done_calls(monkeypatch):
    """Every ``_Completion.part_done`` call of the port, by completion."""
    calls = {}
    orig = S._Completion.part_done

    def counted(self):
        calls[id(self)] = calls.get(id(self), 0) + 1
        orig(self)

    monkeypatch.setattr(S._Completion, "part_done", counted)
    return calls


def _whole_restore(entry):
    """A whole-tensor destination's read requests, its tensor and the
    finalize calls."""
    dst = torch.full(SHAPE, FILL)
    finalized = []
    return prepare_read(entry, dst, finalized.append, DeviceStreams()), dst, finalized


def _coop(loop0, loop1, owner_fs, receiver_fs, entry, receiver_streams: bool = True):
    """The owner (rank 0, ``owner_fs``) reads every piece and forwards it;
    then the receiver (rank 1, ``receiver_fs``) consumes. Both restore
    the whole tensor. Returns both destinations and finalize lists."""
    s0, s1 = _session_pair(loop0, loop1)
    try:
        reqs0, dst0, fin0 = _whole_restore(entry)
        reqs1, dst1, fin1 = _whole_restore(entry)
        if not receiver_streams:
            for r in reqs1:
                r.buffer_consumer.can_stream = lambda sub_chunk_bytes: False
        keys = [unit_key(r) for r in reqs0]
        assert all(keys)
        loop0.run_until_complete(execute_read_reqs(
            reqs0, owner_fs, 1 << 30, 0, coop=CoopKeyPlan(s0, {k: [1] for k in keys}, {})))
        loop1.run_until_complete(execute_read_reqs(
            reqs1, receiver_fs, 1 << 30, 1, coop=CoopKeyPlan(s1, {}, {k: 0 for k in keys})))
    finally:
        s0.close()
        s1.close()
    return (dst0, fin0), (dst1, fin1)


def _jax_peer_streamed(root: str, sub: int) -> int:
    """The pieces whose JAX consumer accepts a peer stream of ``sub``-byte
    frames (the JAX scheduler's peer-fed election, ``scheduler.py:1615``)."""
    jentry = J.Snapshot(root).get_manifest()["0/m/w"]
    return sum(JS._ShardScatterConsumer(s, [], None).can_stream(sub) for s in jentry.shards)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_peer_fed_receiver_streams_the_pieces_the_jax_package_would(
        tmp_path, loops, monkeypatch, part_done_calls, layout, codec) -> None:
    """The receiver's storage directory is empty, so its bit-exact tensor
    came over the peer channel, each eligible piece consumed streamed and
    verified by the receiver itself; every part completes once."""
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    _stream_reads(monkeypatch, "always")
    before_peer = F.peer_counts.copy()
    before = SCH.stream_counts.copy()
    (dst0, fin0), (dst1, fin1) = _coop(*loops, FSStoragePlugin(root),
                                       FSStoragePlugin(str(tmp_path / "empty")), entry)
    full = torch.from_numpy(_full())
    assert torch.equal(dst0, full) and torch.equal(dst1, full)
    assert len(fin0) == len(fin1) == 1
    assert sorted(part_done_calls.values()) == [len(entry.shards)] * 2
    eligible = _jax_peer_streamed(root, SUB)
    assert 0 < eligible < len(entry.shards)
    assert SCH.stream_counts["entries_peer_stream_read"] - before["entries_peer_stream_read"] == eligible
    # The owner's storage streams.
    assert SCH.stream_counts["entries_stream_read"] - before["entries_stream_read"] == eligible
    stored = sum(os.path.getsize(os.path.join(root, s.array.location)) for s in entry.shards)
    assert F.peer_counts["bytes_from_peers"] - before_peer["bytes_from_peers"] == stored
    assert F.peer_counts["fanout_fallbacks"] == before_peer["fanout_fallbacks"]


class _RestartingFS(FSStoragePlugin):
    """Every stream yields one sub-chunk, then asks for a restart. The
    sub-chunk is zeros, not the stored bytes, where ``wrong`` (a zlib
    decoder would raise on them before the restart arrived): a splice of
    either would fail the checksum or overrun the piece."""

    def __init__(self, root: str, wrong: bool) -> None:
        super().__init__(root)
        self.wrong = wrong

    async def read_stream(self, read_io, sub_chunk_bytes):
        inner = await super().read_stream(read_io, sub_chunk_bytes)

        async def chunks():
            first = await inner.chunks.__anext__()
            await inner.chunks.aclose()
            yield bytes(memoryview(first).nbytes) if self.wrong else first
            raise StreamRestartRequired("injected restart after one sub-chunk")

        return ReadStream(path=inner.path, nbytes=inner.nbytes, chunks=chunks())


@pytest.mark.parametrize("receiver", ["streamed", "buffered"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_owner_restart_never_splices(
        tmp_path, loops, monkeypatch, part_done_calls, layout, codec, receiver) -> None:
    """The owner's every stream restarts after one sub-chunk (zeros where
    the piece is stored raw) and is re-read buffered as a new generation. A receiver that spliced the
    first generation would fail its checksum and then its fallback (its
    directory is empty); each side completes every part once."""
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    _stream_reads(monkeypatch, "always")
    restarts = SCH.stream_counts["stream_read_restarts"]
    fallbacks = F.peer_counts["fanout_fallbacks"]
    (dst0, fin0), (dst1, fin1) = _coop(*loops, _RestartingFS(root, wrong=codec is None),
                                       FSStoragePlugin(str(tmp_path / "empty")),
                                       entry, receiver_streams=receiver == "streamed")
    full = torch.from_numpy(_full())
    assert torch.equal(dst0, full) and torch.equal(dst1, full)
    assert len(fin0) == len(fin1) == 1
    assert sorted(part_done_calls.values()) == [len(entry.shards)] * 2
    eligible = sum(_eligible(s) for s in entry.shards)
    # The owner's streams, and the streamed receiver's, each restarted.
    per_side = 2 if receiver == "streamed" else 1
    assert SCH.stream_counts["stream_read_restarts"] - restarts == per_side * eligible
    assert F.peer_counts["fanout_fallbacks"] == fallbacks


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_peer_dying_mid_stream_falls_back_to_one_direct_read(
        tmp_path, loops, monkeypatch, part_done_calls, layout, codec) -> None:
    """The owner sends the first frame of the receiver's first eligible
    piece and drops its connection: that streamed consume stops, and the
    receiver reads every piece from storage, bit-exact, each part
    completed once."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_COOP_TIMEOUT", "30")
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    _stream_reads(monkeypatch, "always")
    loop0, loop1 = loops
    s0, s1 = _session_pair(loop0, loop1)
    fallbacks = F.peer_counts["fanout_fallbacks"]
    try:
        reqs, dst, fin = _whole_restore(entry)
        keys = [unit_key(r) for r in reqs]
        first = next(k for k, s in zip(keys, entry.shards) if _eligible(s))
        stored = open(os.path.join(root, entry.shards[keys.index(first)].array.location), "rb").read()
        sock, lock = s0._out[1]
        with lock:  # one frame, then an unclean drop (no bye)
            send_peer_frame(sock, {"op": "chunk", "key": first, "gen": 1, "seq": 0}, stored[:SUB])
            sock.close()
        loop1.run_until_complete(execute_read_reqs(
            reqs, FSStoragePlugin(root), 1 << 30, 1, coop=CoopKeyPlan(s1, {}, {k: 0 for k in keys})))
    finally:
        s0.close()
        s1.close()
    assert torch.equal(dst, torch.from_numpy(_full()))
    assert len(fin) == 1
    assert list(part_done_calls.values()) == [len(entry.shards)]
    assert F.peer_counts["fanout_fallbacks"] - fallbacks == len(entry.shards)


class _TornFS(FSStoragePlugin):
    """A primary whose streams fail after their first sub-chunk."""

    async def read_stream(self, read_io, sub_chunk_bytes):
        inner = await super().read_stream(read_io, sub_chunk_bytes)

        async def chunks():
            yield await inner.chunks.__anext__()
            await inner.chunks.aclose()
            raise OSError("injected primary failure mid-stream")

        return ReadStream(path=inner.path, nbytes=inner.nbytes, chunks=chunks())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mirror_failover_mid_stream_restarts_without_a_splice(
        tmp_path, monkeypatch, part_done_calls, layout, codec) -> None:
    """Each streamed piece's primary tears after one sub-chunk: the
    mirror plugin asks for a restart, the scheduler re-reads the piece
    buffered, and the boxes are bit-exact with every part completed once."""
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    _stream_reads(monkeypatch, "always")
    storage = MirroredStoragePlugin(primary=_TornFS(root), mirror=FSStoragePlugin(root),
                                    metadata_filename=".snapshot_metadata")
    restarts = SCH.stream_counts["stream_read_restarts"]
    failovers = mirror_mod.failover_counts["mirror_failovers"]
    views = _views(layout)
    for view in views:
        _run_reads(prepare_read(entry, view, None, DeviceStreams()), storage, view.rank)
        assert torch.equal(view.local, _box_of(_full(), view)), view.rank
    torn = sum(_eligible(s) and _overlaps(s, v.local_box) for v in views for s in entry.shards)
    assert torn > 0
    assert SCH.stream_counts["stream_read_restarts"] - restarts == torn
    assert mirror_mod.failover_counts["mirror_failovers"] - failovers == torn
    assert sum(part_done_calls.values()) == sum(
        _overlaps(s, v.local_box) for v in views for s in entry.shards)


# ---------------------------------------------------------- planned reshard


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("src,dst_placement", [("1d_row", 1), ("1d_col", 0)])
def test_planned_reshard_keeps_its_buffered_wrappers(
        tmp_path, loops, monkeypatch, src, dst_placement, codec) -> None:
    """A planned 4 -> 2 reshard across the cut (rows to columns, columns to
    rows), both ranks' loops at once: the owner's and the receiver's
    wrappers stay buffered in both packages while the scatter consumer
    they wrap can stream; only the pieces one rank wants alone stream;
    both boxes bit-exact."""
    from torch.distributed.tensor import Shard

    for klass in ("PlannedOwnerConsumer", "PlannedRecvConsumer"):
        for module in (R, JR):
            assert "can_stream" not in vars(getattr(module, klass))
    root = str(tmp_path / "s")
    entry = _take(root, src, codec)
    _stream_reads(monkeypatch, "always")
    boxes = S.shard_boxes(SHAPE, torch.arange(2), [Shard(dst_placement)])
    views = [S.ShardedView(SHAPE, boxes, r, torch.full([hi - lo for lo, hi in boxes[r]], FILL))
             for r in (0, 1)]
    s0, s1 = _session_pair(*loops)
    streamed = _port_stream_reads()
    before = F.peer_counts["bytes_resharded_from_peers"]
    errors = []
    try:
        ctxs = [R.ReshardContext(s, r, 2) for r, s in ((0, s0), (1, s1))]
        reqs = [prepare_read(entry, v, None, DeviceStreams(), reshard=c) for v, c in zip(views, ctxs)]
        consumers = [r.buffer_consumer for rs in reqs for r in rs]
        wrappers = (R.PlannedOwnerConsumer, R.PlannedRecvConsumer)
        planned = [c for c in consumers if isinstance(c, wrappers)]
        direct = [c for c in consumers if isinstance(c, S._ShardScatterConsumer)]
        assert planned and len(planned) + len(direct) == len(consumers)
        assert not any(c.can_stream(SUB) for c in planned)
        assert any(c.direct.can_stream(SUB) for c in planned)

        def run(rank):
            try:
                loops[rank].run_until_complete(execute_read_reqs(
                    reqs[rank], FSStoragePlugin(root), 1 << 30, rank,
                    coop=R.ComposedRestorePlan(ctxs[rank], None)))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(rank,)) for rank in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        s0.close()
        s1.close()
    assert not errors and not any(t.is_alive() for t in threads)
    for view in views:
        assert torch.equal(view.local, _box_of(_full(), view)), view.rank
    assert _port_stream_reads() - streamed == sum(c.can_stream(SUB) for c in direct)
    assert F.peer_counts["bytes_resharded_from_peers"] > before


# ------------------------------------------------------------ device digests


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_digest_restore_into_the_same_content_consumes_nothing(
        tmp_path, monkeypatch, layout, codec) -> None:
    """The dryrun's spies (``entry.py:_device_digest_round_trip``) on both
    consume methods of the scatter consumer: a device-digest restore into
    boxes that hold the content consumes nothing under ``always``; into
    filled boxes the same spies see the streamed consumes."""
    from torchsnapshot_tpu_torch import device_digest

    assert "consume_stream" in vars(S._ShardScatterConsumer)
    root = str(tmp_path / "s")
    entry = _take(root, layout, codec)
    full = _full()
    for shard in entry.shards:
        box = tuple(slice(o, o + n) for o, n in zip(shard.offsets, shard.sizes))
        piece = torch.from_numpy(full[box].copy())
        shard.array.device_digest = device_digest.device_fingerprint(piece)
    _stream_reads(monkeypatch, "always")
    consumed = []
    for name in ("consume_buffer", "consume_stream"):
        orig = getattr(S._ShardScatterConsumer, name)

        def spy(self, *args, _orig=orig, _name=name, **kwargs):
            consumed.append(_name)
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(S._ShardScatterConsumer, name, spy)
    holding = _views(layout)
    for view in holding:
        view.local.copy_(_box_of(full, view))
        _run_reads(prepare_read(entry, view, None, DeviceStreams(), device_digests=True),
                   FSStoragePlugin(root), view.rank)
    assert consumed == []
    for view in _views(layout):
        _run_reads(prepare_read(entry, view, None, DeviceStreams(), device_digests=True),
                   FSStoragePlugin(root), view.rank)
        assert torch.equal(view.local, _box_of(full, view))
    assert "consume_stream" in consumed
