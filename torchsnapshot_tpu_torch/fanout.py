"""Cooperative restore fan-out: rank-partitioned reads and peer
redistribution.

Counterpart of ``torchsnapshot_tpu/fanout.py``. The take writes every
replicated byte once (``_partition_write_units`` in ``snapshot.py`` stripes
replicated units over the ranks); without this module a restore reads each
replicated byte once a rank, an N-fold read amplification. Here:

- the take's own partitioner (:func:`greedy_size_balanced`, which
  ``snapshot.py`` imports from this module so the two sides can never skew)
  elects one OWNER rank per read unit that several ranks request;
- the owner reads the unit from storage through the scheduler's usual
  pipeline and FORWARDS each sub-chunk to the other requesters over the
  peer channel (``dist_store.PeerListener``: host sockets and threads,
  never a device call or a ``torch.distributed`` collective);
- a receiver consumes the forwarded sub-chunks through the same consumers
  a storage read feeds and verifies them itself (chained CRC32C,
  decompression): an owner is never trusted with integrity.

A read unit is one exact ``(origin, location, byte_range)`` request under
``replicated/`` or ``sharded/``, the locations that hold the same bytes for
every rank. The plan of a key comes from one all-gather of every rank's
request set, so it is a pure function of data every rank has.

Failure: any peer failure degrades THAT ENTRY to one direct storage read,
never to a hang. An owner whose storage stream restarts sends a
``restart`` frame and forwards the whole payload again as a new
generation; receivers drop the earlier generation whole. An owner that
dies drops its connections and its pending units fall back at once; a
receiver that sees nothing for ``TORCHSNAPSHOT_GPU_COOP_TIMEOUT`` seconds
falls back too.

Election: ``TORCHSNAPSHOT_GPU_COOP_RESTORE`` = never / always / auto (the
I/O governor's ``should_coop_restore``: storage measured below the 1 GB/s
knee). The vote rides the restore's one flag all-gather and must be
unanimous.

What the peer plane moves goes to the telemetry counters of the JAX
package's names (:func:`count_peer`), and also to :data:`peer_counts`,
which counts with the bus off too.

This module names neither ``torch.cuda`` nor ``torch.distributed``
(``tests/test_torch_isolation.py`` checks it): it runs on background
restore threads, and the peer plane stays device-free by construction.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import telemetry
from .dist_store import PeerListener, peer_connect, recv_peer_frame, send_peer_frame
from .io_types import StreamRestartRequired

logger = logging.getLogger(__name__)

COOP_RESTORE_ENV_VAR = "TORCHSNAPSHOT_GPU_COOP_RESTORE"
COOP_TIMEOUT_ENV_VAR = "TORCHSNAPSHOT_GPU_COOP_TIMEOUT"
# A receiver that sees no frame for this long falls back to a direct
# read (an alive owner keeps frames flowing; a dead one drops the
# connection, which shows in seconds). Generous: a first frame can trail
# the owner's whole partition read on slow storage.
_DEFAULT_COOP_TIMEOUT_S = 600.0

# Receiver-side inbox buffering past this logs one warning: owners are
# forwarding far ahead of this rank's consumption.
_INBOX_WARN_BYTES = 1 << 30

# Storage locations that hold the same bytes for every rank.
_SHARED_PREFIXES = ("replicated/", "sharded/")

# What the peer plane moved in this process: "bytes_to_peers",
# "bytes_from_peers", "entries_from_peers", "bytes_resharded_from_peers",
# "fanout_fallbacks". The telemetry counters of the same names count only
# while the bus is on; this tally counts always (tests and chip_smoke.py
# read it with the bus off).
peer_counts: "Counter[str]" = Counter()


def count_peer(name: str, n: int = 1) -> None:
    """Add ``n`` to the peer counter ``name``: the telemetry counter and
    :data:`peer_counts`."""
    peer_counts[name] += n
    telemetry.counter_add(name, n)


def coop_restore_mode() -> str:
    """The parser for ``TORCHSNAPSHOT_GPU_COOP_RESTORE``: ``never`` turns
    cooperative restores off, ``always`` opts this rank in (engaging still
    needs every rank), and the default ``auto`` opts in when the I/O
    governor's measured read rate of the restore's storage says fan-out
    beats N direct reads."""
    raw = os.environ.get(COOP_RESTORE_ENV_VAR, "auto").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "never"
    if raw in ("1", "true", "on", "yes", "always", "force"):
        return "always"
    return "auto"


def coop_timeout_s() -> float:
    raw = os.environ.get(COOP_TIMEOUT_ENV_VAR, "").strip()
    if raw:
        try:
            return max(1.0, float(raw))
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r", COOP_TIMEOUT_ENV_VAR, raw)
    return _DEFAULT_COOP_TIMEOUT_S


# ------------------------------------------------------------- partitioner


def greedy_size_balanced(
    sizes: Sequence[int],
    world_size: int,
    candidates: Optional[Sequence[Sequence[int]]] = None,
) -> List[int]:
    """Deterministic greedy size-balanced assignment: an owner rank for
    each unit, in the caller's (already sorted) order; each unit goes to
    the least-loaded rank, ties to the lowest. The take's write partition
    and the restore's fan-out share it. ``candidates[i]`` restricts unit
    ``i`` to a non-empty sorted subset of ranks (on restore: the ranks
    that requested it)."""
    loads = [0] * world_size
    owners: List[int] = []
    for i, nbytes in enumerate(sizes):
        pool = range(world_size) if candidates is None else candidates[i]
        target = min(pool, key=lambda r: (loads[r], r))
        loads[target] += nbytes
        owners.append(target)
    return owners


def unit_key(read_req: Any) -> Optional[str]:
    """The cooperative unit key of a read request, or None when it can
    never be shared: origin snapshot, storage location and byte range. Two
    ranks with the same key receive the same bytes from storage."""
    path = read_req.path
    if not path.startswith(_SHARED_PREFIXES):
        return None
    br = read_req.byte_range
    if br is not None and br[1] <= br[0]:
        return None  # zero-length: nothing to move
    lo, hi = (br[0], br[1]) if br is not None else (-1, -1)
    return f"{read_req.origin or ''}|{path}|{lo}|{hi}"


def content_address(buf: Any) -> str:
    """A chunk's content address: ``sha256:<hex>`` over its bytes (the
    transfer key and end-to-end check of fleet seeding)."""
    return "sha256:" + hashlib.sha256(memoryview(buf).cast("B")).hexdigest()


def content_unit_id(
    scope: str, path: str, byte_range: Optional[Tuple[int, int]]
) -> Optional[str]:
    """Content-addressed id of a shareable read unit, or None where
    :func:`unit_key` would say None. Hashes ``scope|path|lo|hi`` (``scope``
    is the snapshot's path, so equal requests against different snapshots
    never collide) into the ``sha256:`` namespace the chunk bytes use."""
    if not path.startswith(_SHARED_PREFIXES):
        return None
    if byte_range is not None and byte_range[1] <= byte_range[0]:
        return None
    lo, hi = byte_range if byte_range is not None else (-1, -1)
    raw = f"{scope}|{path}|{lo}|{hi}".encode("utf-8")
    return "sha256:" + hashlib.sha256(raw).hexdigest()


def _unit_nbytes(read_req: Any) -> int:
    br = read_req.byte_range
    if br is not None:
        return max(0, br[1] - br[0])
    return max(1, read_req.buffer_consumer.get_consuming_cost_bytes())


def _receive_buffer(nbytes: int):
    """A frame's receive buffer: the start of a pooled staging slab of the
    stream size class (a CUDA copy registers it on first use and DMAs
    from it; recycled registered), else a bytearray."""
    from .io_preparers.array import pooled_buffer, stream_slab_bytes

    slab = pooled_buffer(stream_slab_bytes(nbytes))
    return slab.numpy()[:nbytes] if slab is not None else bytearray(nbytes)


# ---------------------------------------------------------------- protocol
#
# Frame ops (header dicts over dist_store.send_peer_frame):
#   hello    {rank}                      first frame on every connection
#   chunk    {key, gen, seq} + payload   one forwarded sub-chunk
#   end      {key, gen, nbytes, nchunks} the generation is complete
#   restart  {key, gen}                  drop earlier generations
#   abort    {key}                       the owner gave up on this unit
#   bye      {}                          clean connection shutdown


class PeerTransferError(IOError):
    """A peer-fed unit cannot be delivered (the owner died, aborted or
    went silent past the coop timeout). The scheduler degrades the entry
    to a direct storage read: a routing signal, never fatal."""


class _Inbox:
    """A unit's event mailbox between receiver threads and the restore's
    event loop. Events are staged under the session lock until the first
    consumer attaches (creating the asyncio.Queue on the loop thread);
    later posts hop over ``call_soon_threadsafe``, so no thread ever waits
    and inbound routing cannot deadlock against TCP backpressure."""

    __slots__ = ("staged", "aq")

    def __init__(self) -> None:
        self.staged: List[Tuple] = []
        self.aq: Optional[asyncio.Queue] = None


@dataclass
class SendRole:
    """This rank owns the unit: it reads it from storage and forwards every
    sub-chunk to ``subs`` while its own consumer takes it."""

    session: "CoopRestoreSession"
    plan: "CoopKeyPlan"
    key: str
    subs: List[int]

    is_send = True
    is_recv = False

    async def chunk(self, gen: int, seq: int, buf) -> None:
        await self.session._forward(
            self.subs, {"op": "chunk", "key": self.key, "gen": gen, "seq": seq}, buf
        )

    async def end(self, gen: int, nbytes: int, nchunks: int) -> None:
        await self.session._forward(
            self.subs,
            {"op": "end", "key": self.key, "gen": gen, "nbytes": nbytes, "nchunks": nchunks},
            None,
        )
        self.plan.mark_done(self.key)

    async def restart(self, gen: int) -> None:
        await self.session._forward(self.subs, {"op": "restart", "key": self.key, "gen": gen}, None)


@dataclass
class RecvRole:
    """Another rank owns the unit: this rank consumes its forwarded
    sub-chunks."""

    session: "CoopRestoreSession"
    key: str
    owner: int

    is_send = False
    is_recv = True

    def stream(self):
        """The current generation's sub-chunks, in order. Raises
        ``StreamRestartRequired`` when the owner restarts mid-generation
        and :class:`PeerTransferError` when the unit cannot arrive."""
        return self.session._open_stream(self.key, self.owner)

    async def buffered(self) -> memoryview:
        """The unit's whole payload of its final generation (restart frames
        reset the accumulation: bytes of two generations never splice)."""
        return await self.session._receive_buffered(self.key, self.owner)


class CoopKeyPlan:
    """One app-state key's cooperative plan on this rank: which of its
    read requests it owns (and for whom), and which arrive from a peer.
    Made by :meth:`CoopRestoreSession.plan_for_key`, the same on every
    rank."""

    def __init__(
        self, session: "CoopRestoreSession", send: Dict[str, List[int]], recv: Dict[str, int]
    ) -> None:
        self._session = session
        self._send = send
        self._recv = recv
        self._taken: set = set()
        self._done: set = set()

    def take_role(self, read_req: Any):
        """The role of one read request, or None (a direct read). Of two
        requests for one unit within a rank only the first takes the role
        (the owner forwards once; the duplicate reads directly)."""
        key = unit_key(read_req)
        if key is None or key in self._taken:
            return None
        if key in self._send:
            self._taken.add(key)
            return SendRole(self._session, self, key, self._send[key])
        owner = self._recv.get(key)
        if owner is not None:
            self._taken.add(key)
            if owner in self._session._dead:
                # An owner known dead at dispatch: read directly at once.
                count_peer("fanout_fallbacks", 1)
                telemetry.flightrec.record("fanout.fallback", key=key, owner=owner)
                return None
            return RecvRole(self._session, key, owner)
        return None

    def mark_done(self, key: str) -> None:
        self._done.add(key)

    def abort_incomplete(self) -> None:
        """Abort every owned unit this rank never finished forwarding (the
        key's execution raised or left units unscheduled), so subscribers
        fall back at once rather than after the coop timeout."""
        for key, subs in self._send.items():
            if key not in self._done:
                self._session._forward_sync(subs, {"op": "abort", "key": key}, None)
                self._done.add(key)


class _Offer:
    """One rank's election-time offer: the peer-channel address it will
    serve on (None: not opting in). Made before the election all-gather so
    the address can ride it; :meth:`engage` finishes it, or closes the
    listener when not every rank offered one.

    The listener and session are a transport that coop dedup and the
    planned reshard (``reshard.py``) share: ``coop_in`` says whether coop
    dedup itself opted in. An address offered for the reshard alone
    engages a session that carries reshard bundles, and the caller does
    not plan coop units on it unless every ``coop_in`` is true."""

    def __init__(
        self, addr: Optional[str], listener: Optional[PeerListener], coop_in: Optional[bool] = None
    ) -> None:
        self.addr = addr
        self._listener = listener
        self.coop_in = coop_in if coop_in is not None else addr is not None

    def engage(
        self, addrs: List[Optional[str]], rank: int, event_loop: asyncio.AbstractEventLoop
    ) -> Optional["CoopRestoreSession"]:
        if self.addr is None or any(a is None for a in addrs):
            if self._listener is not None:
                self._listener.close()
                if any(a is not None for a in addrs):
                    logger.info(
                        "cooperative restore disabled for this restore: not every rank "
                        "opted in (env skew or rate-gate divergence); reading directly"
                    )
            return None
        session = CoopRestoreSession(rank, addrs, self._listener, event_loop)  # type: ignore[arg-type]
        session._connect_peers()
        return session


class CoopRestoreSession:
    """One restore's peer data plane: the inbound receiver (routing
    forwarded sub-chunks into per-unit inboxes), the outbound full mesh,
    the per-key plan collective, and the failure state."""

    @classmethod
    def local_offer(cls, plugin_name: str, pg_wrapper: Any, extra_opt_in: bool = False) -> _Offer:
        """This rank's opt-in. Opting in binds the listener (cheap) so its
        address can ride the election all-gather. ``extra_opt_in``: the
        planned reshard wants the transport even where coop dedup
        declines; ``_Offer.coop_in`` still says only coop's vote."""
        if pg_wrapper.get_world_size() <= 1:
            return _Offer(None, None, False)
        mode = coop_restore_mode()
        if mode == "always":
            opt_in = True
        elif mode == "auto":
            from .scheduler import io_governor

            opt_in = io_governor().should_coop_restore(plugin_name)
        else:
            opt_in = False
        telemetry.record_election(site="coop_restore", plugin=plugin_name, mode=mode,
                                  opt_in=opt_in)
        if not (opt_in or extra_opt_in):
            return _Offer(None, None, False)
        ip = cls._local_ip(pg_wrapper)
        if ip is None:
            # Advertising a guess (loopback in a multi-host world) would
            # engage cooperation and stall subscribers into the timeout.
            logger.warning(
                "cannot determine this rank's peer-reachable address; opting out of "
                "cooperative restore"
            )
            return _Offer(None, None, False)
        try:
            listener = PeerListener()
        except OSError:
            logger.exception("peer listener bind failed; opting out")
            return _Offer(None, None, False)
        return _Offer(f"{ip}:{listener.port}", listener, opt_in)

    @staticmethod
    def _local_ip(pg_wrapper: Any) -> Optional[str]:
        """The address peers reach this rank on: the local end of the
        store connection (the interface that reaches the coordination
        plane reaches the peer plane too). None when unknown: the caller
        opts out and never guesses."""
        try:
            return pg_wrapper.pg.store.local_ip()
        except Exception:  # noqa: BLE001 - another store type
            return None

    def __init__(
        self,
        rank: int,
        addrs: List[str],
        listener: PeerListener,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        self._rank = rank
        self._world = len(addrs)
        self._addrs = addrs
        self._listener = listener
        self._loop = event_loop
        self._timeout = coop_timeout_s()
        self._lock = threading.Lock()
        self._inboxes: Dict[str, _Inbox] = {}
        self._key_owner: Dict[str, int] = {}
        # Ranks whose inbound connection dropped uncleanly (their units
        # will never arrive) / ranks this rank can no longer send to.
        self._dead: set = set()
        self._send_dead: set = set()
        self._out: Dict[int, Tuple[Any, threading.Lock]] = {}
        self._closed = False
        # Inbox buffering is unbounded on purpose (blocking inbound
        # routing could deadlock the mesh over TCP) and lies outside the
        # scheduler's memory budget; in practice the owners' read rate and
        # the dispatch-first priority of peer-fed entries bound it.
        self._buffered_bytes = 0
        self._warned_buffered = False
        listener.start(self._handle_conn)

    # ------------------------------------------------------------- mesh

    def _connect_peers(self) -> None:
        for r, addr in enumerate(self._addrs):
            if r == self._rank:
                continue
            try:
                sock = peer_connect(addr)
                send_peer_frame(sock, {"op": "hello", "rank": self._rank})
                self._out[r] = (sock, threading.Lock())
            except OSError:
                logger.warning(
                    "peer channel to rank %d (%s) unavailable; its units are read "
                    "directly on that side", r, addr,
                )
                self._send_dead.add(r)

    def _handle_conn(self, conn) -> None:
        """Inbound routing loop, one thread per connected owner. Never
        waits on an inbox (they are unbounded), so TCP always drains."""
        src: Optional[int] = None
        clean = False
        try:
            while True:
                header, payload = recv_peer_frame(conn, alloc=_receive_buffer)
                op = header.get("op")
                if op == "hello":
                    src = int(header["rank"])
                    continue
                if op == "bye":
                    clean = True
                    return
                key = header["key"]
                if op == "chunk":
                    self._post(key, ("chunk", header["gen"], payload))
                elif op == "end":
                    self._post(key, ("end", header["gen"], header["nbytes"], header["nchunks"]))
                elif op == "restart":
                    self._post(key, ("restart", header["gen"]))
                elif op == "abort":
                    self._post(key, ("abort",))
        except (ConnectionError, EOFError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if not clean and src is not None and not self._closed:
                self._mark_source_dead(src)

    def _mark_source_dead(self, rank: int) -> None:
        with self._lock:
            self._dead.add(rank)
            doomed = [key for key, owner in self._key_owner.items() if owner == rank]
        logger.warning(
            "peer rank %d's channel dropped mid-restore; %d pending unit(s) fall back "
            "to direct storage reads", rank, len(doomed),
        )
        for key in doomed:
            self._post(key, ("abort",))

    # ---------------------------------------------------------- receiving

    def _post(self, key: str, event: Tuple) -> None:
        warn = False
        with self._lock:
            inbox = self._inboxes.get(key)
            if inbox is None:
                inbox = self._inboxes[key] = _Inbox()
            if event[0] == "chunk":
                self._buffered_bytes += event[2].nbytes
                if self._buffered_bytes > _INBOX_WARN_BYTES and not self._warned_buffered:
                    self._warned_buffered = warn = True
            if inbox.aq is None:
                inbox.staged.append(event)
            else:
                self._loop.call_soon_threadsafe(inbox.aq.put_nowait, event)
        if warn:
            logger.warning(
                "peer inbox buffering exceeded %.1f GB on rank %d: owners are forwarding "
                "far ahead of this rank's consumption; frames are kept until consumed",
                _INBOX_WARN_BYTES / 1e9, self._rank,
            )

    def _attach(self, key: str) -> _Inbox:
        """Bind a unit's inbox to the event loop (on the loop's thread)."""
        with self._lock:
            inbox = self._inboxes.get(key)
            if inbox is None:
                inbox = self._inboxes[key] = _Inbox()
            if inbox.aq is None:
                inbox.aq = asyncio.Queue()
                for ev in inbox.staged:
                    inbox.aq.put_nowait(ev)
                inbox.staged = []
            return inbox

    async def _next_event(self, inbox: _Inbox, key: str) -> Tuple:
        try:
            ev = await asyncio.wait_for(inbox.aq.get(), self._timeout)
        except asyncio.TimeoutError:
            raise PeerTransferError(
                f"no peer frame for unit {key!r} within {self._timeout:.0f}s"
            ) from None
        if ev[0] == "chunk":
            with self._lock:
                self._buffered_bytes -= ev[2].nbytes
        return ev

    def _register(self, key: str, owner: int) -> None:
        """The dead check and the ownership registration in one step: a
        death between the two would leave the unit waiting out the
        timeout instead of failing fast."""
        with self._lock:
            if owner in self._dead:
                raise PeerTransferError(f"owner rank {owner} is dead")
            self._key_owner[key] = owner

    async def _open_stream(self, key: str, owner: int):
        """Async generator over one generation's sub-chunks, in order."""
        self._register(key, owner)
        inbox = self._attach(key)
        gen: Optional[int] = None
        count = nbytes = 0
        while True:
            ev = await self._next_event(inbox, key)
            kind = ev[0]
            if kind == "chunk":
                if gen is None:
                    gen = ev[1]
                elif ev[1] != gen:
                    raise StreamRestartRequired(
                        f"peer stream for {key!r} restarted (generation {ev[1]} "
                        f"superseded {gen})"
                    )
                count += 1
                nbytes += ev[2].nbytes
                yield ev[2]
            elif kind == "end":
                if gen is not None and ev[1] != gen:
                    raise StreamRestartRequired(
                        f"peer stream for {key!r} ended a superseded generation"
                    )
                if ev[2] != nbytes or ev[3] != count:
                    raise IOError(
                        f"peer stream for {key!r} delivered {nbytes} bytes/{count} chunks, "
                        f"owner sent {ev[2]}/{ev[3]}"
                    )
                return
            elif kind == "restart":
                raise StreamRestartRequired(f"peer stream for {key!r} restarted by its owner")
            elif kind == "abort":
                raise PeerTransferError(f"owner aborted unit {key!r}")

    async def _receive_buffered(self, key: str, owner: int) -> memoryview:
        """The unit's final generation in one buffer; a restart frame
        drops what came before it whole."""
        self._register(key, owner)
        inbox = self._attach(key)
        gen: Optional[int] = None
        parts: List[memoryview] = []
        while True:
            ev = await self._next_event(inbox, key)
            kind = ev[0]
            if kind == "chunk":
                if gen is None or ev[1] > gen:
                    gen, parts = ev[1], []
                if ev[1] == gen:
                    parts.append(ev[2])
                # ev[1] < gen: a stale pre-restart chunk, dropped.
            elif kind == "restart":
                if gen is None or ev[1] > gen:
                    gen, parts = ev[1], []
            elif kind == "end":
                if gen is not None and ev[1] < gen:
                    continue  # a superseded generation's tail
                total = sum(p.nbytes for p in parts)
                if ev[2] != total or ev[3] != len(parts):
                    raise IOError(
                        f"peer transfer for {key!r} delivered {total} bytes/{len(parts)} "
                        f"chunks, owner sent {ev[2]}/{ev[3]}"
                    )
                if len(parts) == 1:
                    return parts[0]
                out = bytearray(total)
                pos = 0
                for p in parts:
                    out[pos : pos + p.nbytes] = p
                    pos += p.nbytes
                return memoryview(out)
            elif kind == "abort":
                raise PeerTransferError(f"owner aborted unit {key!r}")

    # ---------------------------------------------------------- forwarding

    def _send_one(self, rank: int, header: Dict[str, Any], payload) -> None:
        entry = self._out.get(rank)
        if entry is None or rank in self._send_dead:
            return
        sock, lock = entry
        try:
            with lock:
                # tsalint: allow[lock-blocking] the per-peer lock exists to
                # serialize frames onto this one socket; a wedged subscriber
                # surfaces as ConnectionError/OSError below and is dropped
                # to _send_dead, never retried
                send_peer_frame(sock, header, payload)
        except (ConnectionError, OSError):
            # The subscriber is gone and reads directly; skip it from now
            # on without failing this rank's restore.
            self._send_dead.add(rank)
            logger.warning("peer channel to rank %d dropped; it falls back to direct reads", rank)

    def _forward_sync(self, subs: List[int], header: Dict[str, Any], payload) -> None:
        for r in subs:
            self._send_one(r, header, payload)

    async def _forward(self, subs: List[int], header: Dict[str, Any], payload) -> None:
        """Forward one frame to every subscriber off the event loop
        (``sendall`` can block on TCP backpressure and must never stall
        the read pipeline's loop)."""
        nbytes = memoryview(payload).nbytes if payload is not None else 0
        with telemetry.span("peer_send", cat="fanout", key=header.get("key"), bytes=nbytes,
                            subs=len(subs)):
            await asyncio.get_running_loop().run_in_executor(
                None, self._forward_sync, subs, header, payload
            )
        if nbytes:
            count_peer("bytes_to_peers", nbytes * len(subs))

    # ------------------------------------------------------------ planning

    def plan_for_key(self, read_reqs: List[Any], pg_wrapper: Any) -> CoopKeyPlan:
        """COLLECTIVE (one all-gather): agree on this key's cooperative
        units and their owners. Every rank calls it at the same key slot,
        with an empty list when it has nothing to read.

        Ownership is a pure function of the gathered request sets: units
        that two or more ranks request, sorted (size descending, key),
        assigned by the take's greedy partitioner among their
        requesters."""
        local: Dict[str, int] = {}
        for rr in read_reqs:
            key = unit_key(rr)
            if key is not None and key not in local:
                local[key] = _unit_nbytes(rr)
        # Bounded by the coop timeout, not the barrier default: a rank
        # dying mid-plan fails every rank fast.
        gathered = pg_wrapper.all_gather_object(sorted(local.items()), timeout=self._timeout)
        requesters: Dict[str, List[int]] = {}
        sizes: Dict[str, int] = {}
        for r, items in enumerate(gathered):
            for key, nbytes in items:
                requesters.setdefault(key, []).append(r)
                sizes[key] = max(sizes.get(key, 0), int(nbytes))
        pool = sorted(
            (key for key, ranks in requesters.items() if len(ranks) > 1),
            key=lambda k: (-sizes[k], k),
        )
        owners = greedy_size_balanced(
            [sizes[k] for k in pool], self._world, [requesters[k] for k in pool]
        )
        send: Dict[str, List[int]] = {}
        recv: Dict[str, int] = {}
        for key, owner in zip(pool, owners):
            if owner == self._rank:
                send[key] = [r for r in requesters[key] if r != self._rank]
            elif self._rank in requesters[key]:
                recv[key] = owner
        if send or recv:
            logger.debug(
                "[rank %d] cooperative plan: own %d unit(s), receive %d from peers, "
                "%d shared in all", self._rank, len(send), len(recv), len(pool),
            )
        return CoopKeyPlan(self, send, recv)

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        """Clean shutdown: bye every peer (so the drop is not taken for a
        death), then close the mesh and the listener."""
        if self._closed:
            return
        self._closed = True
        for r, (sock, lock) in list(self._out.items()):
            try:
                if r not in self._send_dead:
                    with lock:
                        # tsalint: allow[lock-blocking] best-effort goodbye
                        # on shutdown: a tiny frame to a socket we close on
                        # the next line either way; errors are swallowed
                        send_peer_frame(sock, {"op": "bye"})
            except (ConnectionError, OSError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._out.clear()
        self._listener.close()
