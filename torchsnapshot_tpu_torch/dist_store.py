"""Out-of-band TCP KV store and two-phase barrier for snapshot coordination.

Counterpart of ``torchsnapshot_tpu/dist_store.py`` (the KV store, its
liveness channel, the leased-leader replication tier, ``create_store``,
``host_standby``, ``probe_store_status`` and ``LinearBarrier``); the port
keeps its own copy, under the ``TORCHSNAPSHOT_GPU_*`` env prefix. The store
carries all snapshot metadata traffic (see ``pg_wrapper``) over the host
network, independent of ``torch.distributed`` and of the device collective
stack, and is safe to use from background threads: the async commit
protocol needs that.

Protocol: length-prefixed pickled request/response dicts over a persistent
connection. Server-side blocking waits use a condition variable, so ``get``
blocks without client polling. One handler thread per connection.

Replication tier: with ``TORCHSNAPSHOT_GPU_STORE_REPLICAS=N`` ranks 1..N
host standby replicas. The leader applies every op, stamps it with a log
sequence number and streams it synchronously to each joined standby before
acknowledging; it renews an epoch-stamped lease to each standby every
``lease_s / 3`` seconds. A standby that loses the leader waits out the
lease plus an index-staggered delay, probes its peers for a promoted
leader, and otherwise assumes the lease at epoch + 1; a replica at a higher
epoch rejects the old leader's stream, which deposes it. Clients fail over
transparently: mutating ops carry a ``(client_id, seq)`` pair so a replay
is idempotent, blocking ops re-arm against the new leader with their
remaining timeout, and liveness registrations are re-established. With no
replicas a lost connection latches the client dead and raises
:class:`StoreConnectionLostError`. This is not quorum consensus: a network
partition can dual-lead the tier until fencing evidence reaches the old
leader.

The store records the JAX package's counters (``lease_renewals``,
``store_failovers``) and flight events (``store.epoch``, ...).

Peer channel: :func:`send_peer_frame`, :func:`recv_peer_frame`,
:func:`peer_connect` and :class:`PeerListener` are the rank-to-rank byte
channel that cooperative fan-out (``fanout.py``) and the planned reshard
(``reshard.py``) move restore payload over; host sockets and threads only,
never a device or ``torch.distributed`` call. The seed catalog of the JAX
module (its ``seed_*`` key codecs) serves only fleet seeding
(``distrib.py``), which the port does not have yet.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
import socket
import struct
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from . import faultinject, telemetry
from .telemetry import flightrec

logger = logging.getLogger(__name__)

BARRIER_TIMEOUT_ENV_VAR = "TORCHSNAPSHOT_GPU_BARRIER_TIMEOUT"
STORE_REPLICAS_ENV_VAR = "TORCHSNAPSHOT_GPU_STORE_REPLICAS"
STORE_LEASE_ENV_VAR = "TORCHSNAPSHOT_GPU_STORE_LEASE_S"
STORE_CONNECT_RETRIES_ENV_VAR = "TORCHSNAPSHOT_GPU_STORE_CONNECT_RETRIES"


def _read_barrier_timeout() -> float:
    """Collective/barrier deadline (seconds). Env-configurable because
    the 1800 s default is sized for pod-scale takes on slow durable
    storage — a test rig or a latency-sensitive serving job wants rank
    death during planning to fail EVERY rank fast, not half an hour
    late. Read once at import (subprocess workers inherit the env)."""
    raw = os.environ.get(BARRIER_TIMEOUT_ENV_VAR, "").strip()
    if raw:
        try:
            value = float(raw)
            if value > 0:
                return value
            logger.warning(
                "ignoring non-positive %s=%r", BARRIER_TIMEOUT_ENV_VAR, raw
            )
        except ValueError:
            logger.warning(
                "ignoring non-numeric %s=%r", BARRIER_TIMEOUT_ENV_VAR, raw
            )
    return 1800.0


def _read_env_number(var: str, default: float, *, integer: bool = False):
    """Positive-number env parser with the warn-don't-crash idiom of
    ``_read_barrier_timeout`` (a typo'd knob must degrade to the
    default, never make the coordination plane unimportable)."""
    raw = os.environ.get(var, "").strip()
    if raw:
        try:
            value = int(raw) if integer else float(raw)
            if value >= 0:
                return value
            logger.warning("ignoring negative %s=%r", var, raw)
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r", var, raw)
    return default


DEFAULT_BARRIER_TIMEOUT_S = _read_barrier_timeout()
# Leader-lease duration. The leader renews every lease_s / 3; a standby
# must observe silence for a full lease before it may assume the next
# epoch, so failover completes in ~1-2 leases after a leader kill.
DEFAULT_STORE_LEASE_S = _read_env_number(STORE_LEASE_ENV_VAR, 5.0) or 5.0
# How many non-zero ranks host standby replicas in create_store (0 = the
# pre-replication single-host store).
DEFAULT_STORE_REPLICAS = int(
    _read_env_number(STORE_REPLICAS_ENV_VAR, 0, integer=True)
)
# Bounded, jittered connect retries on ConnectionRefusedError — a
# slow-starting server or a failover target still standing up refuses
# the first attempt; a wedged or garbage endpoint is NOT retried (its
# failure mode cannot improve).
DEFAULT_CONNECT_RETRIES = int(
    _read_env_number(STORE_CONNECT_RETRIES_ENV_VAR, 3, integer=True)
)
# Client-side response deadlines: the store SERVER is itself a peer that
# can die (it lives in rank 0's process — the same SPOF the reference's
# rank-0-hosted TCPStore has, dist_store.py:53-88). A killed server
# process RSTs its sockets and clients fail instantly; a SILENTLY dead
# host (power loss, network partition) sends nothing, so without a
# deadline a blocked recv would hang forever. Every request therefore
# bounds the wait for the server's response:
#   - ops that carry their own timeout (get/wait_any/collect) wait
#     op_timeout + RPC_GRACE_S (the server answers "timeout" at
#     op_timeout; the grace covers scheduling + network),
#   - quick ops (set/add/mset/...) wait STORE_RPC_TIMEOUT_S (in-memory
#     ops that normally answer in microseconds).
# TCP keepalive (~20 s of silence) and TCP_USER_TIMEOUT (~20 s unacked
# data) additionally tear down the connection under long-deadline
# blocking ops, so silent server death surfaces in tens of seconds, not
# at the 1800 s barrier timeout.
#
# The quick-op deadline is deliberately GENEROUS (10 min): the server
# thread shares rank 0's GIL, and a host in swap thrash or a long
# GIL-held stretch can stall it for minutes while the kernel keeps
# ACKing (so keepalive/USER_TIMEOUT never fire). A premature deadline
# here is worse than a slow one — the client latches dead and its
# liveness-registered connection's drop publishes a death key for a
# LIVE rank. The kernel-dead cases (the common ones) are still caught
# in ~20 s by the TCP-layer settings above; this deadline only backstops
# the ACKing-but-silent pathology, where 10 min still beats 30.
RPC_GRACE_S = 30.0
STORE_RPC_TIMEOUT_S = float(
    os.environ.get("TORCHSNAPSHOT_GPU_STORE_RPC_TIMEOUT", "600")
)
CONNECT_TIMEOUT_S = 30.0
# Injected dist_store.rpc transients model a blip that failed ONE
# request over a healthy connection; the client resends (idempotently)
# a bounded number of times before propagating.
RPC_BLIP_RETRIES = 2
# Failure-detection channel shared with pg_wrapper: the server publishes
# this key when a liveness-registered connection (one per rank) drops
# without a clean deregister. Collective waits watch it.
DEATH_KEY = "pgw/death"
# Set by the leader once the expected replica count has joined;
# create_store gates every rank on it so no coordination op can race the
# replica bootstrap (the failover window would silently shrink to zero).
REPLICAS_READY_KEY = "__store/replicas_ready__"
_LEN = struct.Struct(">Q")

# Bound on the per-client idempotency (dedup) table: clients past the
# cap are evicted least-recently-written first. Each snapshot take's
# clones mint fresh client ids, so without a bound a months-long job
# would leak the table on the leader and every standby. 4096 distinct
# recently-writing clients is far beyond checkpoint scale; an evicted
# client's in-flight replay re-applying requires 4096 other clients to
# have written since its stamp — accepted and documented.
CLIENT_SEQ_CAP = 4096

# Ops that change server state: these carry the client-assigned
# (client_id, seq) stamp and are streamed to replicas. Blocking reads
# re-arm after failover instead (their effect is idempotent by nature).
_MUTATING_OPS = frozenset(
    {
        "set",
        "add",
        "mset",
        "mset_default",
        "delete",
        "delete_if_value",
        "delete_prefix",
    }
)


def _connect_backoff_s(attempt: int, base: float = 0.25, cap: float = 2.0) -> float:
    """Jittered exponential backoff for connect/failover retries — the
    storage retry tier's formula (``storage_plugins/retry.py:27-40`` of the
    JAX package): ``base * 2^attempt * (1 + rand)`` capped at ``cap``, the
    exponent capped before exponentiating."""
    raw = base * (2 ** min(attempt, 16)) * (1.0 + random.random())
    return min(raw, cap)


class StoreConnectionLostError(ConnectionError):
    """The coordination KV store is unreachable — its hosting process
    has likely died (and, if replicas were configured, failover found no
    live leader either).

    Raised by every blocked or subsequent store operation on this client
    within seconds of the loss (RST from a killed process, TCP keepalive
    or the per-request response deadline for a silent host). Nothing was
    committed: the metadata-last protocol means an in-flight snapshot
    whose coordination plane died is simply absent. Recovery: restart
    the world — a fresh store is bootstrapped by the new rank 0 — and
    restore from the last committed snapshot (docs: elasticity.rst,
    "Coordination-plane failure").

    ``role`` names who actually died so post-failover diagnostics don't
    blame the wrong host: the default describes the classic rank-0-hosted
    single store; the failover path substitutes the observed leader
    epoch and the candidate set it exhausted.
    """

    DEFAULT_ROLE = "rank 0, the snapshot leader"

    def __init__(
        self,
        addr: str,
        op: str,
        cause: BaseException,
        role: str = DEFAULT_ROLE,
    ) -> None:
        super().__init__(
            f"Lost connection to the coordination store at {addr} during "
            f"{op!r} ({type(cause).__name__}: {cause}). The store-hosting "
            f"process ({role}) has likely died; "
            "in-flight snapshot coordination on this rank is aborted and "
            "nothing was committed. Restart the world and restore from "
            "the last committed snapshot."
        )
        self.addr = addr
        self.op = op
        self.role = role


class _DeposedError(ConnectionError):
    """A replica (or promoted ex-replica) rejected this leader's stream:
    a higher epoch exists. The leader must stop serving."""


def _send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("Store connection closed.")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, length))


def _try_whois(addr: str, timeout: float = 2.0) -> Optional[Dict[str, Any]]:
    """One-shot leader probe: connect, ask ``whois``, close. Returns the
    response dict or None (unreachable / not a store / self-connect)."""
    host, _, port = addr.rpartition(":")
    try:
        sock = socket.create_connection((host, int(port)), timeout=timeout)
    except (OSError, ValueError):
        return None
    try:
        sock.settimeout(timeout)
        if sock.getsockname() == sock.getpeername():
            return None  # loopback ephemeral self-connect trap
        _send_msg(sock, {"op": "whois"})
        resp = _recv_msg(sock)
        if isinstance(resp, dict) and "ok" in resp:
            return resp
        return None
    except Exception:  # noqa: BLE001 - any garbage means "not a store"
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass


class _ReplicaLink:
    """Leader-side handle to one joined standby: the (promoted) join
    connection, a lock serializing every message on it, and the
    replication bookkeeping the ``store-status`` CLI reports."""

    def __init__(self, sock: socket.socket, addr: str) -> None:
        self.sock = sock
        self.addr = addr
        # RLock: _accept_replica holds it across the full-sync send while
        # calling send() for the sync frame itself.
        self.lock = threading.RLock()
        self.index = -1
        self.acked_seq = 0
        self.last_renew = time.monotonic()
        # While the full sync is in flight, replicated ops are BUFFERED
        # into ``pending`` (guarded by the server cond) instead of
        # blocking the dispatcher on this link's lock — a slow joiner
        # must never stall the store (or starve lease renewals to the
        # other standbys) for the duration of its sync.
        self.syncing = True
        self.pending: List[Dict[str, Any]] = []

    def send(self, msg: Dict[str, Any], timeout: float) -> Dict[str, Any]:
        faultinject.site("dist_store.replica_rpc")
        with self.lock:
            self.sock.settimeout(timeout)
            # tsalint: allow[lock-blocking] deadline-bounded: settimeout on
            # the line above caps both the send and the recv; the link lock
            # only serializes this link's exchanges (the dispatcher never
            # waits on it — see the SYNCING protocol in __init__)
            _send_msg(self.sock, msg)
            resp = _recv_msg(self.sock)
        if not isinstance(resp, dict):
            raise ConnectionError(f"replica {self.addr} answered garbage")
        if resp.get("stale_epoch") or resp.get("deposed"):
            raise _DeposedError(
                f"replica {self.addr} fenced this leader off at epoch "
                f"{resp.get('epoch')}"
            )
        if not resp.get("ok"):
            raise ConnectionError(f"replica {self.addr} rejected: {resp}")
        return resp

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _StoreServer:
    """In-process KV server: a replicating leader, or a standby replica.

    Rank 0 (or a dedicated store-host process) hosts the leader; ranks
    1..N host standbys via :func:`host_standby`. All coordination state
    — the KV data, the op-log position, and the per-client idempotency
    table — is streamed synchronously to every joined standby, so any
    standby with an intact stream can assume leadership.

    Locking rules (deadlock-free by construction):
    - ``self._cond`` (the data lock) may be held while taking an ACTIVE
      replica link's lock (the synchronous-replication path);
    - while a link is SYNCING (its lock held across the full-sync
      exchange), nothing that holds the cond ever waits on that lock —
      replicate/lease/rs_update all buffer-or-skip syncing links — which
      is what makes the one amendment safe: the joiner's flush loop may
      take the cond briefly (to swap pending batches) while holding the
      syncing link's lock, and no cycle can form;
    - otherwise a link's lock is never held while acquiring the cond
      (failure handling re-acquires the cond only after ``send``
      returned).
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        standby: bool = False,
        lease_s: Optional[float] = None,
        expected_replicas: int = 0,
    ) -> None:
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        self._role = "standby" if standby else "leader"
        self._epoch = 0 if standby else 1
        self._log_seq = 0
        # client_id -> (last applied seq, its response): the replay-dedup
        # table. Replicated with the data so idempotency survives failover.
        self._client_seqs: Dict[str, Tuple[int, Dict[str, Any]]] = {}
        self._lease_s = float(lease_s) if lease_s else DEFAULT_STORE_LEASE_S
        self._expected_replicas = int(expected_replicas)
        self._replicas: List[_ReplicaLink] = []  # guarded by _cond
        self._rs_version = 0
        self._joined_total = 0
        self._lease_thread: Optional[threading.Thread] = None
        # Standby-side state.
        self._leader_addr: Optional[str] = None
        self._standby_index: int = 0
        self._peers: List[Tuple[int, str]] = []  # (index, addr) of siblings
        self._last_leader_msg = time.monotonic()
        self._upstream: Optional[socket.socket] = None
        self._advertise: Optional[str] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # (client_id, key) -> the connection currently holding that
        # liveness registration. A dropped connection's death-key flush
        # is skipped when the same client has since re-registered over a
        # NEWER connection (failover over a blip): the old FIN can
        # arrive arbitrarily late (server-side sockets have no
        # keepalive), and publishing then would poison a live rank.
        self._liveness_reg: Dict[Tuple[str, str], Any] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        # Every rank of a pod (plus async-commit clones) connects at
        # startup near-simultaneously; a short accept backlog would
        # refuse some of that storm. The kernel caps this at
        # net.core.somaxconn — listen() just must not be the limiter.
        self._sock.listen(1024)
        self.port = self._sock.getsockname()[1]
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name="tsnap-gpu-store", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ accept

    def _serve(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        liveness: Dict[str, bytes] = {}
        conn_cid: Optional[str] = None
        promoted = False
        try:
            while True:
                req = _recv_msg(conn)
                op = req.get("op")
                if op == "register_liveness":
                    # Failure detection: if this connection drops without a
                    # deregister, publish the registered key so peers
                    # blocked in collectives raise instead of timing out.
                    liveness[req["key"]] = req["value"]
                    cid = req.get("cid")
                    if cid is not None:
                        conn_cid = cid
                        with self._conns_lock:
                            self._liveness_reg[(cid, req["key"])] = conn
                    _send_msg(conn, {"ok": True})
                    continue
                if op == "deregister_liveness":
                    liveness.pop(req["key"], None)
                    if conn_cid is not None:
                        with self._conns_lock:
                            self._liveness_reg.pop(
                                (conn_cid, req["key"]), None
                            )
                    _send_msg(conn, {"ok": True})
                    continue
                if op == "replica_join":
                    # The connection becomes the leader->replica stream;
                    # its lifecycle now belongs to the _ReplicaLink.
                    promoted = self._accept_replica(conn, req)
                    return
                _send_msg(conn, self._dispatch(req))
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            # A promoted (replica-join) connection's lifecycle belongs to
            # its _ReplicaLink from here on, but the accept-time tracking
            # entry must still go — standbys blip and rejoin for months,
            # and each cycle would otherwise leak a dead socket ref.
            with self._conns_lock:
                self._conns.discard(conn)
            if not promoted:
                conn.close()
            if liveness:
                # Publish (and replicate) the death keys: a rank dying an
                # instant before a leader failover must still be visible
                # to peers on the promoted replica. SKIP any key the same
                # client has since re-registered over a newer connection
                # — then this drop is a superseded old connection (a
                # survived blip), not a death.
                if conn_cid is not None:
                    with self._conns_lock:
                        liveness = {
                            k: v
                            for k, v in liveness.items()
                            if self._liveness_reg.get((conn_cid, k), conn)
                            is conn
                        }
                        for k in liveness:
                            self._liveness_reg.pop((conn_cid, k), None)
                with self._cond:
                    items = {
                        k: v for k, v in liveness.items() if k not in self._data
                    }
                    if items:
                        self._apply_locked({"op": "mset_default", "items": items})
                        if self._role == "leader":
                            self._log_seq += 1
                            self._replicate_locked(
                                {"op": "mset_default", "items": items}
                            )

    # ---------------------------------------------------------- dispatch

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        faultinject.site("dist_store.serve_op")
        op = req["op"]
        if op == "whois":
            return {
                "ok": True,
                "leader": self._role == "leader",
                "role": self._role,
                "epoch": self._epoch,
                # Lets failing-over clients size their probe budget to
                # the tier's ACTUAL lease (a standby answers whois while
                # it is still inside its fencing wait).
                "lease_s": self._lease_s,
            }
        if op == "status":
            return self._status()
        if op == "replicas":
            with self._cond:
                return {
                    "ok": True,
                    "addrs": [link.addr for link in self._replicas],
                    "rsv": self._rs_version,
                    "epoch": self._epoch,
                }
        if self._role != "leader":
            return {
                "ok": False,
                "not_leader": True,
                "role": self._role,
                "epoch": self._epoch,
            }
        cid = req.get("cid")
        cseq = req.get("cseq")
        with self._cond:
            if (
                op in _MUTATING_OPS
                and cid is not None
                and cseq is not None
            ):
                last = self._client_seqs.get(cid)
                if last is not None and cseq <= last[0]:
                    # Replay of an op this lineage already applied (the
                    # ack was lost in a failover): answer the cached
                    # response — exactly-once application.
                    return last[1]
            resp = self._apply_locked(req)
            if op in _MUTATING_OPS and resp.get("ok"):
                self._log_seq += 1
                if cid is not None and cseq is not None:
                    self._remember_client_op(cid, cseq, resp)
                self._replicate_locked(req)
                if self._role != "leader":
                    # Deposed by fencing evidence DURING the replicate:
                    # this write lives only on a dead lineage and must
                    # not be acked — not_leader makes the client replay
                    # it (idempotently) against the promoted leader.
                    return {
                        "ok": False,
                        "not_leader": True,
                        "role": self._role,
                        "epoch": self._epoch,
                    }
            if resp.get("ok"):
                # Replica-set version piggybacks on every response (one
                # small int) so clients learn about newly joined
                # replicas without polling.
                resp["rsv"] = self._rs_version
        return resp

    def _remember_client_op(self, cid: str, cseq: int, resp: Dict[str, Any]) -> None:
        """Record a client's last applied (seq, response) in the bounded
        dedup table. Recency = dict insertion order (refreshed on every
        write), evicting least-recently-writing clients past
        CLIENT_SEQ_CAP. Deterministic: leader and replicas apply the
        same ops in the same order (and sync_full copies preserve
        insertion order), so every lineage evicts identically and a
        replay after failover sees the same table. Caller holds the
        cond."""
        if cid in self._client_seqs:
            del self._client_seqs[cid]
        self._client_seqs[cid] = (cseq, resp)
        while len(self._client_seqs) > CLIENT_SEQ_CAP:
            del self._client_seqs[next(iter(self._client_seqs))]

    def _apply_locked(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one op. Caller holds ``self._cond``. Deterministic given
        the data state — a replica applying the same op computes the same
        response, which keeps the replicated dedup cache consistent."""
        op = req["op"]
        key = req.get("key")
        if op == "set":
            self._data[key] = req["value"]
            self._cond.notify_all()
            return {"ok": True}
        elif op == "add":
            cur = int(self._data.get(key, b"0"))
            cur += req["amount"]
            self._data[key] = str(cur).encode()
            self._cond.notify_all()
            return {"ok": True, "value": cur}
        elif op == "get":
            deadline = time.monotonic() + req["timeout"]
            while key not in self._data:
                if self._role != "leader":
                    return {"ok": False, "not_leader": True, "epoch": self._epoch}
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=min(remaining, 1.0)):
                    if time.monotonic() >= deadline:
                        return {"ok": False, "timeout": True}
            return {"ok": True, "value": self._data[key]}
        elif op == "wait_any":
            keys = req["keys"]
            deadline = time.monotonic() + req["timeout"]
            while True:
                for k in keys:
                    if k in self._data:
                        return {"ok": True, "key": k, "value": self._data[k]}
                if self._role != "leader":
                    return {"ok": False, "not_leader": True, "epoch": self._epoch}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"ok": False, "timeout": True}
                self._cond.wait(timeout=min(remaining, 1.0))
        elif op == "mset":
            self._data.update(req["items"])
            self._cond.notify_all()
            return {"ok": True}
        elif op == "mset_default":
            # setdefault semantics (the liveness flush: first death wins).
            for k, v in req["items"].items():
                self._data.setdefault(k, v)
            self._cond.notify_all()
            return {"ok": True}
        elif op == "collect":
            # Block until `count` keys with `prefix` exist, then return
            # them all in one response — the server-side half of a
            # scalable all-gather (one RTT per rank instead of one per
            # peer). A stop key (error channel) short-circuits.
            prefix = req["prefix"]
            count = req["count"]
            stop_keys = req.get("stop_keys") or []
            deadline = time.monotonic() + req["timeout"]
            while True:
                # Data completeness BEFORE stop keys (mirrors
                # wait_any's list ordering): a completable collective
                # must complete even if a peer's death landed after
                # its contribution — e.g. a rank posting its piece for
                # the job's final collective and exiting while the
                # leader is still collecting.
                found = {
                    k: v for k, v in self._data.items() if k.startswith(prefix)
                }
                if len(found) >= count:
                    return {"ok": True, "items": found}
                for sk in stop_keys:
                    if sk in self._data:
                        return {
                            "ok": True,
                            "stopped": sk,
                            "value": self._data[sk],
                        }
                if self._role != "leader":
                    return {"ok": False, "not_leader": True, "epoch": self._epoch}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"ok": False, "timeout": True}
                self._cond.wait(timeout=min(remaining, 1.0))
        elif op == "check":
            return {"ok": True, "value": key in self._data}
        elif op == "num_keys":
            return {"ok": True, "value": len(self._data)}
        elif op == "delete":
            existed = self._data.pop(key, None) is not None
            return {"ok": True, "value": existed}
        elif op == "delete_if_value":
            # Conditional delete (the retraction primitive): removes the
            # key only while it still holds the caller's value. A client
            # whose liveness-registered connection dropped but whose
            # PROCESS survived (failover over a network blip) retracts
            # its own false death key with this — without ever erasing a
            # different rank's genuine death record in the same key
            # (first-death-wins setdefault keeps that value, which won't
            # match).
            matched = self._data.get(key) == req["value"]
            if matched:
                del self._data[key]
            return {"ok": True, "value": matched}
        elif op == "delete_prefix":
            keep = req.get("except_keys") or []
            doomed = [
                k
                for k in self._data
                if k.startswith(req["prefix"]) and k not in keep
            ]
            for k in doomed:
                del self._data[k]
            return {"ok": True, "value": len(doomed)}
        else:
            return {"ok": False, "error": f"unknown op {op!r}"}

    # ------------------------------------------------------- replication

    def _replica_timeout(self) -> float:
        return max(self._lease_s, 1.0)

    def _replicate_locked(self, req: Dict[str, Any]) -> None:
        """Stream one applied op to every standby, synchronously (the
        client's ack waits for the replicas' acks). Caller holds the
        cond. A failing link is DROPPED and the leader serves on,
        degraded — synchronous replication cannot skip an op for a live
        replica, so any stream error means that replica is gone."""
        if not self._replicas:
            return
        msg = {
            "op": "replicate",
            "epoch": self._epoch,
            "seq": self._log_seq,
            "req": req,
        }
        for link in list(self._replicas):
            if link.syncing:
                # Mid-sync joiner: buffer in log order (flushed by
                # _accept_replica before the link goes active). Blocking
                # here would hold the cond for the whole sync.
                link.pending.append(msg)
                continue
            try:
                link.send(msg, timeout=self._replica_timeout())
                link.acked_seq = self._log_seq
            except _DeposedError as e:
                logger.error("store leader deposed: %s", e)
                self._depose_locked()
                return
            except Exception as e:  # noqa: BLE001 - any stream failure
                logger.warning(
                    "dropping store replica %s (replication failed: %s)",
                    link.addr,
                    e,
                )
                self._drop_replica_locked(link)

    def _drop_replica_locked(self, link: _ReplicaLink) -> None:
        link.close()
        if link in self._replicas:
            self._replicas.remove(link)
            self._rs_version += 1

    def _depose_locked(self) -> None:
        """Fencing evidence arrived (a replica moved to a higher epoch):
        stop serving. Blocked waits return ``not_leader`` on their next
        wakeup so clients re-arm against the promoted leader."""
        self._role = "deposed"
        for link in self._replicas:
            link.close()
        self._replicas = []
        self._cond.notify_all()
        flightrec.record("store.epoch", epoch=self._epoch, role="deposed")

    def _accept_replica(self, conn: socket.socket, req: Dict[str, Any]) -> bool:
        """A standby joined: full-sync it under the link lock (so no
        replicate can interleave before the snapshot lands), then
        register it. Returns True when the conn was promoted to a link."""
        addr = req["addr"]
        link = _ReplicaLink(conn, addr)
        sync_err: Optional[BaseException] = None
        with link.lock:
            # tsalint: allow[lock-order] safe against the documented
            # _cond -> lock order: this link was constructed two lines up
            # and is not yet registered in _replicas, so no other thread
            # can hold (or wait on) link.lock — the inverted edge cannot
            # close a cycle until after the lock is released
            with self._cond:
                if self._role != "leader":
                    try:
                        # tsalint: allow[lock-blocking] best-effort one-shot
                        # rejection to a conn nobody else shares: the frame
                        # fits the kernel send buffer, and OSError (incl.
                        # timeout) is swallowed — a wedged joiner cannot
                        # hold this
                        _send_msg(
                            conn,
                            {"ok": False, "not_leader": True, "epoch": self._epoch},
                        )
                    except OSError:
                        pass
                    return False
                link.index = self._joined_total
                self._joined_total += 1
                sync = {
                    "op": "sync_full",
                    "epoch": self._epoch,
                    "seq": self._log_seq,
                    "data": dict(self._data),
                    "client_seqs": dict(self._client_seqs),
                    "index": link.index,
                    "lease_s": self._lease_s,
                    "peers": [(l.index, l.addr) for l in self._replicas]
                    + [(link.index, addr)],
                }
                self._replicas.append(link)
                self._rs_version += 1
                ready = (
                    self._expected_replicas > 0
                    and len(self._replicas) >= self._expected_replicas
                )
            # cond released, link lock still held: the sync frame is
            # guaranteed to precede any replicate on this link. The
            # exchange is deadline-bounded — a hung (non-dead) joiner
            # holding this lock open-endedly would stall every mutating
            # dispatch blocked in link.send behind it. And per the class
            # locking rules, NOTHING below may acquire the cond while
            # the link lock is held: a failure is only recorded here and
            # cleaned up after the lock is released ( _replicate_locked
            # holds the cond while waiting on this lock — re-acquiring
            # the cond here would deadlock the whole store).
            deposed = False
            try:
                conn.settimeout(max(self._replica_timeout(), 30.0))
                # tsalint: allow[lock-blocking] deadline-bounded by the
                # settimeout above, and holding ONLY link.lock here is the
                # design: the cond was dropped before the sync precisely so
                # a slow joiner stalls nothing but its own link
                _send_msg(conn, sync)
                ack = _recv_msg(conn)
                conn.settimeout(None)
                if not (isinstance(ack, dict) and ack.get("ok")):
                    raise ConnectionError(f"standby {addr} rejected sync: {ack}")
                # The full sync carried the state at this log position.
                link.acked_seq = sync["seq"]
            except Exception as e:  # noqa: BLE001
                sync_err = e
            # Drain ops that applied while the sync was in flight: they
            # were buffered (dispatchers holding the cond never block on
            # a syncing link), and must land in log order before the
            # link goes active. Locking amendment: this path holds
            # link.lock and takes the cond BRIEFLY to swap batches —
            # safe because no thread ever holds the cond while waiting
            # on a SYNCING link's lock (replicate/lease/rs_update all
            # skip syncing links), so no cycle can form.
            while sync_err is None and not deposed:
                # tsalint: allow[lock-order] documented amendment (comment above): this path holds link.lock and takes the cond briefly to swap batches; no thread holds the cond while waiting on a SYNCING link's lock, so no cycle can form
                with self._cond:
                    batch = link.pending
                    link.pending = []
                    if not batch:
                        link.syncing = False
                        break
                for msg in batch:
                    try:
                        link.send(msg, timeout=self._replica_timeout())
                        link.acked_seq = msg.get("seq", link.acked_seq)
                    except _DeposedError as e:
                        logger.error("store leader deposed: %s", e)
                        deposed = True
                        break
                    except Exception as e:  # noqa: BLE001
                        sync_err = e
                        break
        if deposed:
            with self._cond:
                self._depose_locked()
            return True
        if sync_err is not None:
            logger.warning("standby %s failed to sync: %s", addr, sync_err)
            with self._cond:
                self._drop_replica_locked(link)
            return False
        logger.info(
            "store replica %s joined (index %d, epoch %d, seq %d)",
            addr,
            link.index,
            self._epoch,
            self._log_seq,
        )
        self._ensure_lease_thread()
        self._broadcast_rs_update()
        if ready:
            self._set_internal(REPLICAS_READY_KEY, b"1")
        return True

    def _set_internal(self, key: str, value: bytes) -> None:
        """A leader-originated (no client) replicated KV write."""
        with self._cond:
            if self._role != "leader":
                return
            self._apply_locked({"op": "set", "key": key, "value": value})
            self._log_seq += 1
            self._replicate_locked({"op": "set", "key": key, "value": value})

    def _broadcast_rs_update(self) -> None:
        with self._cond:
            peers = [(l.index, l.addr) for l in self._replicas]
            msg = {"op": "rs_update", "epoch": self._epoch, "peers": peers}
            # Syncing joiners must not be blocked on (their lock is
            # sync-held) — they get this update via their flush queue,
            # in order with the op stream.
            links = []
            for l in self._replicas:
                if l.syncing:
                    l.pending.append(msg)
                else:
                    links.append(l)
        for link in links:
            try:
                link.send(msg, timeout=self._replica_timeout())
            except _DeposedError as e:
                # Fencing evidence counts no matter which message drew
                # it: a replica on a higher epoch ends this leadership.
                logger.error("store leader deposed: %s", e)
                with self._cond:
                    self._depose_locked()
                return
            except Exception as e:  # noqa: BLE001
                logger.warning("dropping store replica %s (%s)", link.addr, e)
                with self._cond:
                    self._drop_replica_locked(link)

    def _ensure_lease_thread(self) -> None:
        with self._cond:
            if self._lease_thread is not None and self._lease_thread.is_alive():
                return
            self._lease_thread = threading.Thread(
                target=self._lease_loop, name="tsnap-gpu-store-lease", daemon=True
            )
            self._lease_thread.start()

    def _lease_loop(self) -> None:
        while not self._shutdown.is_set():
            time.sleep(self._lease_s / 3.0)
            if self._role != "leader" or self._shutdown.is_set():
                return
            try:
                faultinject.site("dist_store.lease_renew")
            except Exception as e:  # noqa: BLE001 - injected renewal failure
                logger.warning("lease renewal round skipped: %s", e)
                continue
            with self._cond:
                # Syncing joiners are skipped (their lock is held for
                # the whole sync; they get the stream once flushed).
                links = [l for l in self._replicas if not l.syncing]
                msg = {"op": "lease_renew", "epoch": self._epoch}
            if links:
                flightrec.record(
                    "store.lease", epoch=self._epoch, replicas=len(links)
                )
            for link in links:
                try:
                    link.send(msg, timeout=self._replica_timeout())
                    link.last_renew = time.monotonic()
                    telemetry.counter_add("lease_renewals", 1)
                except _DeposedError as e:
                    logger.error("store leader deposed: %s", e)
                    with self._cond:
                        self._depose_locked()
                    return
                except Exception as e:  # noqa: BLE001
                    logger.warning(
                        "dropping store replica %s (lease renewal failed: %s)",
                        link.addr,
                        e,
                    )
                    with self._cond:
                        self._drop_replica_locked(link)

    # ---------------------------------------------------- standby / join

    def _join_leader(self, leader_addr: str) -> None:
        """Join ``leader_addr`` as a standby: full sync, then follow the
        op-log/lease stream on a background thread."""
        host, _, port = leader_addr.rpartition(":")
        sock = socket.create_connection(
            (host, int(port)), timeout=CONNECT_TIMEOUT_S
        )
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            advert = f"{sock.getsockname()[0]}:{self.port}"
            sock.settimeout(CONNECT_TIMEOUT_S)
            _send_msg(sock, {"op": "replica_join", "addr": advert})
            sync = _recv_msg(sock)
            if not (isinstance(sync, dict) and sync.get("op") == "sync_full"):
                raise ConnectionError(
                    f"replica join to {leader_addr} refused: {sync!r}"
                )
            with self._cond:
                self._data = dict(sync["data"])
                self._client_seqs = dict(sync["client_seqs"])
                self._epoch = sync["epoch"]
                self._log_seq = sync["seq"]
                self._standby_index = sync["index"]
                self._peers = [
                    (int(i), a)
                    for i, a in sync.get("peers", [])
                    if a != advert
                ]
                self._lease_s = float(sync.get("lease_s", self._lease_s))
                self._leader_addr = leader_addr
                self._role = "standby"
                self._cond.notify_all()
            _send_msg(sock, {"ok": True})
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._upstream = sock
        self._advertise = advert
        self._last_leader_msg = time.monotonic()
        threading.Thread(
            target=self._follow, name="tsnap-gpu-store-follow", daemon=True
        ).start()

    def _follow(self) -> None:
        sock = self._upstream
        sock.settimeout(max(self._lease_s, 0.2))
        while not self._shutdown.is_set() and self._role == "standby":
            try:
                msg = _recv_msg(sock)
            except socket.timeout:
                if time.monotonic() - self._last_leader_msg > self._lease_s:
                    logger.warning(
                        "store leader %s silent past the lease (%.1fs)",
                        self._leader_addr,
                        self._lease_s,
                    )
                    break
                continue
            except (ConnectionError, OSError, EOFError):
                break
            self._last_leader_msg = time.monotonic()
            op = msg.get("op")
            try:
                if msg.get("epoch", self._epoch) < self._epoch:
                    # Epoch fencing: ANY stream message declaring a
                    # lower epoch (op log, lease, rs_update) is a
                    # deposed leader's late write — refuse it so the
                    # sender learns and steps down.
                    _send_msg(
                        sock,
                        {
                            "ok": False,
                            "stale_epoch": True,
                            "epoch": self._epoch,
                        },
                    )
                    continue
                if op in ("replicate", "lease_renew"):
                    if op == "replicate":
                        req = msg["req"]
                        with self._cond:
                            resp = self._apply_locked(req)
                            self._log_seq = msg["seq"]
                            cid, cseq = req.get("cid"), req.get("cseq")
                            if cid is not None and cseq is not None:
                                self._remember_client_op(cid, cseq, resp)
                    _send_msg(sock, {"ok": True})
                elif op == "rs_update":
                    with self._cond:
                        self._peers = [
                            (int(i), a)
                            for i, a in msg.get("peers", [])
                            if a != self._advertise
                        ]
                    _send_msg(sock, {"ok": True})
                else:
                    _send_msg(sock, {"ok": True})
            except (ConnectionError, OSError, EOFError):
                break
        try:
            sock.close()
        except OSError:
            pass
        if not self._shutdown.is_set() and self._role == "standby":
            self._takeover_or_rejoin()

    def _find_live_leader(self) -> Optional[Tuple[str, int]]:
        """Probe the old leader and every known sibling; return the
        reachable leader claim with the highest epoch (addr, epoch)."""
        best: Optional[Tuple[str, int]] = None
        candidates = []
        if self._leader_addr:
            candidates.append(self._leader_addr)
        candidates.extend(a for _i, a in sorted(self._peers))
        for cand in candidates:
            info = _try_whois(cand, timeout=max(self._lease_s / 4, 0.25))
            if info and info.get("leader"):
                epoch = int(info.get("epoch", 0))
                if best is None or epoch > best[1]:
                    best = (cand, epoch)
        return best

    def _rejoin(self, leader_addr: str) -> bool:
        try:
            self._join_leader(leader_addr)
            logger.warning(
                "store standby %s rejoined leader %s (epoch %d)",
                self._advertise,
                leader_addr,
                self._epoch,
            )
            return True
        except Exception as e:  # noqa: BLE001
            logger.warning("rejoin to %s failed: %s", leader_addr, e)
            return False

    def _takeover_or_rejoin(self) -> None:
        """The upstream stream is gone. Fencing wait: the old leader's
        lease must lapse before this standby may assume. Lower join
        indices get the first shot (stagger); while waiting, probe for a
        sibling that already assumed (or the old leader, if our link
        merely broke) and rejoin it instead."""
        probe_gap = max(self._lease_s / 10.0, 0.05)
        while not self._shutdown.is_set() and self._role == "standby":
            assume_at = (
                self._last_leader_msg
                + self._lease_s
                + 0.5 * max(self._standby_index, 0)
            )
            # Guarantee a real probe window even when the lease expired
            # BEFORE we got here (the silence-detection path: by the time
            # _follow breaks, _last_leader_msg is already a full lease
            # old, making assume_at instantly past — index-0 standbys
            # would otherwise assume with ZERO probes and depose a
            # leader that merely stalled over one lease).
            assume_at = max(assume_at, time.monotonic() + 2 * probe_gap)
            while time.monotonic() < assume_at and not self._shutdown.is_set():
                found = self._find_live_leader()
                if found is not None and (
                    found[1] > self._epoch or found[0] == self._leader_addr
                ):
                    if self._rejoin(found[0]):
                        return
                time.sleep(probe_gap)
            found = self._find_live_leader()
            if found is not None and (
                # Same acceptance rule as the probe loop: a RECOVERED
                # same-epoch leader is rejoined, never deposed.
                found[1] > self._epoch
                or found[0] == self._leader_addr
            ):
                if self._rejoin(found[0]):
                    return
                continue
            with self._cond:
                if self._role != "standby":
                    return
                self._epoch += 1
                self._role = "leader"
                self._rs_version += 1
                self._replicas = []
                self._leader_addr = None
                self._cond.notify_all()
            logger.warning(
                "store standby %s assumed leadership at epoch %d "
                "(log seq %d, %d keys)",
                self._advertise,
                self._epoch,
                self._log_seq,
                len(self._data),
            )
            flightrec.record(
                "store.epoch", epoch=self._epoch, role="leader",
                log_seq=self._log_seq,
            )
            self._ensure_lease_thread()
            return

    # ------------------------------------------------------------ status

    def _status(self) -> Dict[str, Any]:
        with self._cond:
            now = time.monotonic()
            info: Dict[str, Any] = {
                "ok": True,
                "role": self._role,
                "epoch": self._epoch,
                "log_seq": self._log_seq,
                "lease_s": self._lease_s,
                "n_keys": len(self._data),
                "rsv": self._rs_version,
            }
            if self._role == "leader":
                info["replicas"] = [
                    {
                        "addr": link.addr,
                        "index": link.index,
                        "acked_seq": link.acked_seq,
                        "lag": self._log_seq - link.acked_seq,
                        "lease_age_s": round(now - link.last_renew, 3),
                    }
                    for link in self._replicas
                ]
            elif self._role == "standby":
                info["leader"] = self._leader_addr
                info["leader_silence_s"] = round(now - self._last_leader_msg, 3)
            # deposed/closed: an ex-leader has no upstream to report —
            # "following leader None" here would mislead the on-call.
            return info

    def close(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._cond:
            self._role = "closed"
            for link in self._replicas:
                link.close()
            self._replicas = []
            self._cond.notify_all()
        if self._upstream is not None:
            try:
                self._upstream.close()
            except OSError:
                pass
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


def host_standby(
    leader_addr: str,
    lease_s: Optional[float] = None,
    host: str = "0.0.0.0",
    port: int = 0,
) -> _StoreServer:
    """Host a standby replica of the store at ``leader_addr`` in this
    process: binds a listener, full-syncs from the leader, and follows
    its op-log/lease stream. On leader loss the standby assumes
    leadership per the lease protocol (module docstring). Returns the
    server handle; ``close()`` it on clean shutdown."""
    server = _StoreServer(host=host, port=port, standby=True, lease_s=lease_s)
    try:
        server._join_leader(leader_addr)
    except BaseException:
        server.close()
        raise
    return server


def probe_store_status(addr: str, timeout: float = 5.0) -> Dict[str, Any]:
    """One-shot status snapshot of the store node at ``addr`` (leader or
    standby), for the ``store-status`` CLI. Raises ConnectionError when
    nothing answering the store protocol lives there."""
    host, _, port = addr.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.settimeout(timeout)
        _send_msg(sock, {"op": "status"})
        resp = _recv_msg(sock)
        if not (isinstance(resp, dict) and resp.get("ok")):
            raise ConnectionError(f"{addr} did not answer the status probe: {resp!r}")
        resp["addr"] = addr
        return resp
    finally:
        try:
            sock.close()
        except OSError:
            pass


class TCPStore:
    """Client handle to a store server (optionally hosting it in-process).

    Thread-safe: calls are serialized over one connection with a lock; use
    separate TCPStore instances for genuinely concurrent use (e.g. the async
    commit thread creates its own connection).

    When the server side is replicated, failover is transparent: a lost
    connection (or a ``not_leader`` answer from a deposed leader) probes
    the known replica set, adopts the live leader with the highest epoch,
    re-registers liveness keys, and replays the in-flight op — mutating
    ops idempotently via their ``(client_id, seq)`` stamp, blocking ops
    re-armed with their remaining timeout. ``failovers`` counts adopted
    failovers on this client.
    """

    def __init__(
        self,
        host: str,
        port: Optional[int] = None,
        is_server: bool = False,
        timeout: float = DEFAULT_BARRIER_TIMEOUT_S,
        lease_s: Optional[float] = None,
        expected_replicas: int = 0,
        connect_retries: Optional[int] = None,
        _replica_addrs: Optional[List[str]] = None,
        _bootstrap_addr: Optional[str] = None,
    ) -> None:
        self._server: Optional[_StoreServer] = None
        if is_server:
            self._server = _StoreServer(
                port=port or 0,
                lease_s=lease_s,
                expected_replicas=expected_replicas,
            )
            port = self._server.port
            host = "127.0.0.1" if host in ("0.0.0.0", "") else host
        assert port is not None
        self.host = host
        self.port = port
        self.timeout = timeout
        self._lock = threading.Lock()
        self._dead: Optional[StoreConnectionLostError] = None
        # Failover state: a stable client identity for idempotent replay,
        # the liveness keys to re-register on a new connection, the known
        # replica set, and the highest leader epoch observed.
        self._client_id = uuid.uuid4().hex
        self._mut_seq = 0
        self._liveness: Dict[str, bytes] = {}
        self._replica_addrs: List[str] = list(_replica_addrs or [])
        self._rsv = 0
        self._epoch_seen = 0
        self.failovers = 0
        # The address this client was BOOTSTRAPPED with: stable across
        # failovers (``addr`` tracks the current leader), so per-process
        # bookkeeping keyed by store identity (pg_wrapper's handshake
        # cursors) survives a mid-job leader change.
        self.bootstrap_addr = _bootstrap_addr or f"{host}:{port}"
        self._standby: Optional[_StoreServer] = None  # create_store attaches
        retries = (
            DEFAULT_CONNECT_RETRIES if connect_retries is None else connect_retries
        )
        attempt = 0
        while True:
            try:
                self._sock = self._connect_probed(host, port)
                break
            except ConnectionRefusedError as e:
                # Refused means nothing is listening YET — the one
                # connect failure a bounded, jittered retry can outwait
                # (slow server start, a failover target still binding).
                # Timeouts/garbage are not retried: they cannot improve.
                if attempt >= retries:
                    raise
                delay = _connect_backoff_s(attempt)
                attempt += 1
                logger.info(
                    "store connect to %s:%s refused (%s); retrying in "
                    "%.2fs (attempt %d/%d)",
                    host,
                    port,
                    e,
                    delay,
                    attempt,
                    retries,
                )
                time.sleep(delay)

    @staticmethod
    def _connect_probed(host: str, port: int) -> socket.socket:
        """Connect and validate that a real store server answers: the
        self-connect check, one probe round trip, and the keepalive /
        user-timeout socket configuration. Runs on EVERY connect attempt
        — initial, retried, and failover adoption alike."""
        sock = socket.create_connection((host, port), timeout=CONNECT_TIMEOUT_S)
        # A TCP connect alone does not prove a STORE is on the other end:
        # on loopback, connecting to a freed ephemeral port (a dead store
        # host's port is the classic case) can simultaneous-open onto
        # itself or yield a phantom connection that dies on first use.
        # Validate with one probe round-trip: only a real server answers
        # it correctly (a self-connect echoes our own request back, which
        # fails the response check).
        try:
            if sock.getsockname() == sock.getpeername():
                raise ConnectionRefusedError(
                    f"self-connect to {host}:{port} (no server listening)"
                )
            _send_msg(sock, {"op": "check", "key": "__conn_probe__"})
            resp = _recv_msg(sock)
            if not isinstance(resp, dict) or "ok" not in resp:
                raise ConnectionRefusedError(
                    f"{host}:{port} did not answer the store probe "
                    "(not a store server)"
                )
        except ConnectionRefusedError:
            try:
                sock.close()
            except OSError:
                pass
            raise
        except (ConnectionError, EOFError, OSError):
            try:
                sock.close()
            except OSError:
                pass
            raise
        except Exception as e:
            # A non-store service on the port can answer with bytes that
            # explode anywhere inside unpickling (UnpicklingError,
            # ValueError, AttributeError, ...): that is still "not a
            # store server", and the socket must not leak.
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionRefusedError(
                f"{host}:{port} answered the store probe with garbage "
                f"({type(e).__name__}: {e}) — not a store server"
            ) from e
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Silent-death detection at the TCP layer (a killed process
            # RSTs and needs none of this; these cover power loss /
            # partitions):
            # - keepalive (idle 5 s + 3 probes x 5 s = ~20 s) tears down
            #   connections idle in a blocked recv;
            # - TCP_USER_TIMEOUT (~20 s) covers the case keepalive cannot:
            #   request bytes sent but never ACKed (keepalive probes are
            #   suppressed while data is outstanding — without this, that
            #   path would ride retransmission backoff for ~15 minutes).
            # Both land long before the 1800 s barrier timeout.
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            for opt, val in (
                ("TCP_KEEPIDLE", 5),
                ("TCP_KEEPINTVL", 5),
                ("TCP_KEEPCNT", 3),
                ("TCP_USER_TIMEOUT", 20_000),  # milliseconds
            ):
                if hasattr(socket, opt):  # Linux; harmless to skip elsewhere
                    sock.setsockopt(
                        socket.IPPROTO_TCP, getattr(socket, opt), val
                    )
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def replica_addrs(self) -> List[str]:
        """The standby replica addresses this client would fail over to.
        Lock-free snapshot read: the client lock is held for the full
        duration of a blocked collective, and observability reads must
        not wait behind it."""
        return list(self._replica_addrs)

    def local_ip(self) -> Optional[str]:
        """The local IP of the current store connection — the interface
        that reaches the coordination plane (fanout's peer-listener
        address discovery). None when it cannot be determined. Lock-free
        (see ``replica_addrs``): reads one reference atomically."""
        sock = self._sock
        try:
            return sock.getsockname()[0]
        except (OSError, AttributeError):
            return None

    # ----------------------------------------------------------- request

    def _request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req["op"]
        op_timeout = req.get("timeout")
        op_deadline = (
            time.monotonic() + op_timeout if op_timeout is not None else None
        )
        blips = 0
        while True:
            if op_deadline is not None:
                remaining = op_deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"Store operation {op!r} on "
                        f"{req.get('key') or req.get('keys')} timed out "
                        f"after {op_timeout}s."
                    )
                # Re-armed blocking ops carry only their REMAINING budget
                # to the (possibly new) leader.
                req["timeout"] = remaining
                response_deadline = remaining + RPC_GRACE_S
            else:
                # How long the CLIENT waits for the server's response: a
                # deadline expiring here means the SERVER went silent,
                # not that the op timed out.
                response_deadline = STORE_RPC_TIMEOUT_S
            # OUTSIDE the lock/try: an injected transient store fault
            # models a blip that failed one request over a HEALTHY
            # connection — the client resends (idempotently) instead of
            # latching dead (a permanent/kill plan models a torn store).
            try:
                faultinject.site("dist_store.rpc")
            except ConnectionError:
                if blips >= RPC_BLIP_RETRIES:
                    raise
                blips += 1
                time.sleep(0.05 * blips * (1.0 + random.random()))
                continue
            with self._lock:
                if self._dead is not None:
                    # The connection is gone (and mid-message state would
                    # be corrupt anyway): every subsequent op fails fast.
                    raise self._dead
                # Stamp mutating ops ONCE, inside the lock (the stamp
                # order must match the send order for the server's
                # per-client dedup window); replays reuse the stamp.
                # Only stamped when a failover target exists: without
                # replicas a lost connection latches this client dead and
                # no replay can ever happen, so the stamp (and the
                # server's dedup bookkeeping it triggers) would be pure
                # overhead on the disabled path. The replica cache is
                # primed by the bootstrap's replicas-ready gate before
                # any coordination op, so replicated deployments stamp
                # from the first op.
                if (
                    self._replica_addrs
                    and "cid" not in req
                    and op in _MUTATING_OPS
                ):
                    self._mut_seq += 1
                    req["cid"] = self._client_id
                    req["cseq"] = self._mut_seq
                try:
                    self._sock.settimeout(response_deadline)
                    # tsalint: allow[lock-blocking] deadline-bounded by the
                    # settimeout above; self._lock IS the client's
                    # per-connection request serialization — concurrent
                    # callers must queue behind the in-flight RPC by design
                    _send_msg(self._sock, req)
                    resp = _recv_msg(self._sock)
                    self._sock.settimeout(None)
                except (ConnectionError, EOFError, OSError) as e:
                    # socket.timeout is an OSError subclass, so a silent
                    # server (deadline) and a dead one (RST/FIN) both
                    # land here; keepalive converts long silences too.
                    # tsalint: allow[lock-blocking] failover's bounded
                    # connect-retry sleeps run under self._lock on purpose:
                    # every other request MUST queue until the new leader is
                    # adopted — releasing the lock would just let them race
                    # the same dead socket
                    self._failover_locked(e, op)
                    continue
            if resp.get("not_leader"):
                # A deposed leader (or a standby we adopted optimistically)
                # answered: find the real leader and re-issue.
                with self._lock:
                    if self._dead is not None:
                        raise self._dead
                    # tsalint: allow[lock-blocking] same deliberate hold as
                    # the exception path above: requests queue behind the
                    # bounded failover rather than racing a deposed leader
                    self._failover_locked(
                        ConnectionError(
                            f"{self.addr} is no longer the store leader "
                            f"(role {resp.get('role')!r}, epoch "
                            f"{resp.get('epoch')})"
                        ),
                        op,
                    )
                continue
            break
        self._maybe_refresh_replicas(resp)
        if resp.get("timeout"):
            raise TimeoutError(
                f"Store operation {req['op']!r} on {req.get('key') or req.get('keys')} "
                f"timed out after {op_timeout}s."
            )
        if not resp.get("ok"):
            raise RuntimeError(f"Store error: {resp.get('error')}")
        return resp

    # ---------------------------------------------------------- failover

    def _failover_budget_s(self, lease_hint_s: float) -> float:
        # A takeover needs ~lease + stagger + probe rounds; give it a few
        # leases with an absolute floor. ``lease_hint_s`` is the largest
        # lease any probed candidate reported — the env default alone
        # would abandon a failover whose server was built with a longer
        # lease passed as a parameter (the standby is REQUIRED to sit
        # out that full lease before it may assume).
        return max(4.0 * max(lease_hint_s, DEFAULT_STORE_LEASE_S), 10.0)

    def _failover_locked(self, cause: BaseException, op: str) -> None:
        """The connection failed. With replicas known: probe the
        candidate set until a live leader (at >= the highest epoch seen)
        answers, adopt it, and return — the caller replays the request.
        Without replicas: latch dead and raise (the pre-replication
        behavior — fast, loud, bounded). Caller holds ``self._lock``."""
        try:
            self._sock.close()
        except OSError:
            pass
        if not self._replica_addrs:
            self._dead = StoreConnectionLostError(self.addr, op, cause)
            raise self._dead from cause
        candidates = list(
            dict.fromkeys([self.addr, *self._replica_addrs, self.bootstrap_addr])
        )
        started = time.monotonic()
        lease_hint = 0.0
        attempt = 0
        logger.warning(
            "coordination store connection lost during %r (%s); probing "
            "failover candidates %s",
            op,
            cause,
            candidates,
        )
        while time.monotonic() < started + self._failover_budget_s(lease_hint):
            best: Optional[Tuple[int, str]] = None
            for cand in candidates:
                info = _try_whois(cand, timeout=2.0)
                if not info:
                    continue
                # Any reachable node (a standby still in its fencing
                # wait included) teaches us the tier's real lease.
                lease_hint = max(lease_hint, float(info.get("lease_s", 0.0)))
                if not info.get("leader"):
                    continue
                epoch = int(info.get("epoch", 0))
                if best is None or epoch > best[0]:
                    best = (epoch, cand)
            if best is not None and best[0] >= self._epoch_seen:
                if self._adopt_locked(best[1], best[0], cause):
                    return
            attempt += 1
            time.sleep(_connect_backoff_s(attempt, base=0.1, cap=1.0))
        self._dead = StoreConnectionLostError(
            self.addr,
            op,
            cause,
            role=(
                f"the store leader at epoch {max(self._epoch_seen, 1)}; "
                f"failover exhausted after probing {', '.join(candidates)}"
            ),
        )
        raise self._dead from cause

    def _adopt_locked(self, cand: str, epoch: int, cause: BaseException) -> bool:
        """Connect to the probed leader and re-establish this client's
        connection-scoped state (liveness registrations, replica cache).
        Returns False (to keep probing) on any failure."""
        host, _, port = cand.rpartition(":")
        try:
            sock = self._connect_probed(host, int(port))
        except (OSError, ValueError):
            return False
        try:
            # The whole adoption handshake is deadline-bounded: a
            # candidate that answered whois and then wedged (alive
            # kernel, stuck process) must cost one bounded probe, not an
            # indefinite hang with the client lock held.
            sock.settimeout(CONNECT_TIMEOUT_S)
            for key, value in self._liveness.items():
                # This PROCESS is alive — the old connection's drop may
                # already have flushed a false death record for it.
                # Retract it (conditionally: a different rank's genuine
                # death in the same key holds a different value and is
                # preserved), then re-register on the new connection.
                # Residual race: a peer blocked in a collective during
                # the gap between the flush and this retraction can
                # still observe the key — bounded by this client's next
                # op, vs. permanent poisoning without the retraction.
                _send_msg(
                    sock,
                    {"op": "delete_if_value", "key": key, "value": value},
                )
                ack = _recv_msg(sock)
                if not (isinstance(ack, dict) and ack.get("ok")):
                    raise ConnectionError(f"death-key retraction refused: {ack}")
                _send_msg(
                    sock,
                    {
                        "op": "register_liveness",
                        "key": key,
                        "value": value,
                        "cid": self._client_id,
                    },
                )
                ack = _recv_msg(sock)
                if not (isinstance(ack, dict) and ack.get("ok")):
                    raise ConnectionError(f"liveness re-register refused: {ack}")
            _send_msg(sock, {"op": "replicas"})
            rs = _recv_msg(sock)
        except Exception as e:  # noqa: BLE001 - candidate died mid-adopt
            logger.warning("failover candidate %s failed mid-adopt: %s", cand, e)
            try:
                sock.close()
            except OSError:
                pass
            return False
        sock.settimeout(None)
        self.host, self.port = host, int(port)
        self._sock = sock
        self._epoch_seen = max(self._epoch_seen, epoch)
        if isinstance(rs, dict) and rs.get("ok"):
            self._replica_addrs = [
                a for a in rs.get("addrs", []) if a != self.addr
            ]
            self._rsv = rs.get("rsv", self._rsv)
        self.failovers += 1
        telemetry.counter_add("store_failovers", 1)
        flightrec.record(
            "store.failover", epoch=epoch, leader=cand, cause=repr(cause)
        )
        logger.warning(
            "coordination store failover #%d: adopted leader %s (epoch %d) "
            "after %s",
            self.failovers,
            cand,
            epoch,
            cause,
        )
        return True

    def _maybe_refresh_replicas(self, resp: Dict[str, Any]) -> None:
        """Track the server's replica-set version (piggybacked on every
        response) and re-fetch the addresses when it moves — so the
        failover candidate set is warm BEFORE the leader dies."""
        rsv = resp.get("rsv")
        if rsv is None or rsv == self._rsv:
            return
        with self._lock:
            if self._dead is not None or rsv == self._rsv:
                return
            try:
                self._sock.settimeout(STORE_RPC_TIMEOUT_S)
                # tsalint: allow[lock-blocking] deadline-bounded by the
                # settimeout above, and best-effort: any socket failure just
                # returns and the next response retriggers the refresh
                _send_msg(self._sock, {"op": "replicas"})
                rs = _recv_msg(self._sock)
                self._sock.settimeout(None)
            except (ConnectionError, EOFError, OSError):
                return  # best-effort; the next response retriggers
            if isinstance(rs, dict) and rs.get("ok"):
                self._replica_addrs = [
                    a for a in rs.get("addrs", []) if a != self.addr
                ]
                self._rsv = rs.get("rsv", rsv)
                self._epoch_seen = max(
                    self._epoch_seen, int(rs.get("epoch", 0))
                )

    # --------------------------------------------------------------- api

    def set(self, key: str, value: bytes) -> None:
        self._request({"op": "set", "key": key, "value": bytes(value)})

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        return self._request(
            {"op": "get", "key": key, "timeout": timeout or self.timeout}
        )["value"]

    def wait_any(
        self, keys: List[str], timeout: Optional[float] = None
    ) -> Tuple[str, bytes]:
        resp = self._request(
            {"op": "wait_any", "keys": keys, "timeout": timeout or self.timeout}
        )
        return resp["key"], resp["value"]

    def add(self, key: str, amount: int) -> int:
        return self._request({"op": "add", "key": key, "amount": amount})["value"]

    def mset(self, items: Dict[str, bytes]) -> None:
        """Set many keys in one round trip (scatter's leader-side write)."""
        self._request({"op": "mset", "items": {k: bytes(v) for k, v in items.items()}})

    def collect(
        self,
        prefix: str,
        count: int,
        stop_keys: Optional[List[str]] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[Optional[str], Dict[str, bytes]]:
        """Block until ``count`` keys under ``prefix`` exist; return them all
        in ONE round trip. Returns ``(stopped_key, items)``: if a stop key
        (e.g. an error channel) appears first, ``stopped_key`` is set and
        ``items`` maps it to its value."""
        resp = self._request(
            {
                "op": "collect",
                "prefix": prefix,
                "count": count,
                "stop_keys": stop_keys or [],
                "timeout": timeout or self.timeout,
            }
        )
        if "stopped" in resp:
            return resp["stopped"], {resp["stopped"]: resp["value"]}
        return None, resp["items"]

    def check(self, key: str) -> bool:
        return self._request({"op": "check", "key": key})["value"]

    def num_keys(self) -> int:
        """Total number of keys currently held by the server (observability /
        store-hygiene tests)."""
        return self._request({"op": "num_keys"})["value"]

    def delete(self, key: str) -> bool:
        return self._request({"op": "delete", "key": key})["value"]

    def delete_prefix(self, prefix: str, except_keys: Optional[List[str]] = None) -> int:
        return self._request(
            {"op": "delete_prefix", "prefix": prefix, "except_keys": except_keys}
        )["value"]

    def status(self) -> Dict[str, Any]:
        """The server's replication status (role, epoch, replica lag)."""
        return self._request({"op": "status"})

    def register_liveness(self, key: str, value: bytes) -> None:
        """Publish ``key``=``value`` if THIS connection ever drops without
        ``deregister_liveness`` — the failure-detection hook: a process
        dying mid-collective makes its death visible to peers through a
        key they already watch, instead of leaving them blocked until the
        store timeout. Clones do NOT inherit registration (a background
        thread closing its connection is not a process death). The
        registration is re-established automatically on failover — it is
        scoped to the connection, and the failed-over client has a new
        one."""
        value = bytes(value)
        self._request(
            {
                "op": "register_liveness",
                "key": key,
                "value": value,
                # Client identity lets the server tell "this connection
                # was superseded by a failover re-registration" apart
                # from "this client died" when the old FIN arrives late.
                "cid": self._client_id,
            }
        )
        self._liveness[key] = value

    def deregister_liveness(self, key: str) -> None:
        self._request({"op": "deregister_liveness", "key": key})
        self._liveness.pop(key, None)

    def clone(self) -> "TCPStore":
        """A new connection to the same store (for use from another
        thread). Targets the CURRENT leader; if it just died, tries the
        known replica set before giving up."""
        # Lock-free candidate snapshot: clone() must work while another
        # thread of THIS client is blocked in a long collective (which
        # holds the client lock) — the async-commit bootstrap pattern.
        last_err: Optional[BaseException] = None
        candidates = list(
            dict.fromkeys(
                [self.addr, *list(self._replica_addrs), self.bootstrap_addr]
            )
        )
        many = len(candidates) > 1
        for cand in candidates:
            host, _, port = cand.rpartition(":")
            try:
                return TCPStore(
                    host,
                    int(port),
                    is_server=False,
                    timeout=self.timeout,
                    # With failover candidates available, don't burn the
                    # connect-retry backoff on each dead one.
                    connect_retries=0 if many else None,
                    _replica_addrs=[a for a in candidates if a != cand],
                    _bootstrap_addr=self.bootstrap_addr,
                )
            except OSError as e:
                last_err = e
        # The server is already gone (refused / connect deadline):
        # name the store host instead of a bare socket error.
        raise StoreConnectionLostError(
            self.addr, "clone", last_err or ConnectionError("unreachable")
        ) from last_err

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        if self._standby is not None:
            self._standby.close()
        if self._server is not None:
            self._server.close()


def create_store(
    rank: int,
    addr: Optional[str] = None,
    timeout: float = DEFAULT_BARRIER_TIMEOUT_S,
    replicas: Optional[int] = None,
    host_server: Optional[bool] = None,
    lease_s: Optional[float] = None,
) -> TCPStore:
    """Bootstrap a store: rank 0 hosts (unless ``host_server=False`` —
    the dedicated-store-host deployment), everyone connects to ``addr``.

    ``addr`` ("host:port") must be agreed out of band — from the
    TORCHSNAPSHOT_GPU_STORE_ADDR env var, torchrun's MASTER_ADDR, or
    the test launcher (reference analogue: dist_store.py:53-88, where rank 0
    binds a free port and broadcasts it over the default store).

    ``replicas`` (default: the ``TORCHSNAPSHOT_GPU_STORE_REPLICAS`` env
    var) arms the replication tier: ranks ``1..replicas`` each host a
    standby replica of the store in-process, and EVERY rank then blocks
    until the full replica set has joined (so no coordination op can
    race the bootstrap and silently lose its failover window). The
    bootstrap therefore carries the replica set to every client — the
    leader streams the standby addresses, and clients cache them for
    transparent failover.
    """
    if replicas is None:
        replicas = DEFAULT_STORE_REPLICAS
    auto_host = host_server is None
    if host_server is None:
        host_server = rank == 0
    if host_server and auto_host and addr is not None and ":" in addr:
        # Defaulted hosting duty only: a store already serving at the
        # agreed address (a dedicated store-host deployment, or a
        # restarted rank 0 rejoining a world whose store survived) means
        # rank 0 must join as a CLIENT, not fight for the bind.
        if _try_whois(addr, timeout=2.0) is not None:
            logger.info(
                "a coordination store already serves at %s; rank %d "
                "joins as a client instead of hosting",
                addr,
                rank,
            )
            host_server = False
    if host_server:
        if addr is not None and ":" in addr:
            host, _, port = addr.rpartition(":")
            store = TCPStore(
                host or "127.0.0.1",
                int(port),
                is_server=True,
                timeout=timeout,
                lease_s=lease_s,
                expected_replicas=replicas,
            )
        else:
            store = TCPStore(
                "127.0.0.1",
                None,
                is_server=True,
                timeout=timeout,
                lease_s=lease_s,
                expected_replicas=replicas,
            )
    else:
        assert addr is not None, "Non-hosting ranks must be given the store address."
        host, _, port = addr.rpartition(":")
        deadline = time.monotonic() + timeout
        while True:
            try:
                store = TCPStore(host, int(port), timeout=timeout)
                break
            except (ConnectionRefusedError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
    if replicas > 0:
        if not host_server and 1 <= rank <= replicas:
            store._standby = host_standby(
                f"{store.host}:{store.port}", lease_s=lease_s
            )
        try:
            store.get(REPLICAS_READY_KEY, timeout=min(timeout, 120.0))
        except Exception as e:  # noqa: BLE001 - degraded, never fatal
            logger.warning(
                "store replica set incomplete after bootstrap wait "
                "(continuing WITHOUT full failover coverage): %s",
                e,
            )
    return store


# --------------------------------------------------------- peer transport
#
# Length-prefixed byte channel between RANKS — the data-plane sidecar to
# the KV store above. The store moves metadata through rank 0; the peer
# channel moves restore payload sub-chunks directly between the ranks
# that have them and the ranks that need them (fanout.py), so cooperative
# restores never funnel payload bytes through the coordination server.
# Strictly host-network + threads: safe from background threads and never
# touching device collectives, the same invariant the store itself keeps.
#
# Frame format (one frame = one protocol message):
#
#     u64 header_len | header (pickled dict) | u64 payload_len | payload
#
# The header is a tiny routing dict (op/key/gen/seq); the payload rides
# raw — payload bytes are never pickled, so multi-MB sub-chunks move with
# one copy into the receive buffer.

PEER_CONNECT_TIMEOUT_S = 30.0


def send_peer_frame(sock: socket.socket, header: Dict[str, Any], payload=None) -> None:
    """Send one frame. ``payload`` is any buffer-protocol object (or
    None). Callers serialize concurrent senders on one socket themselves
    (a lock per connection): interleaved sendalls would corrupt the
    framing."""
    h = pickle.dumps(header)
    payload = faultinject.mutate("peer.send_frame", payload)
    mv = memoryview(payload).cast("B") if payload is not None else None
    sock.sendall(_LEN.pack(len(h)) + h + _LEN.pack(mv.nbytes if mv is not None else 0))
    if mv is not None and mv.nbytes:
        sock.sendall(mv)


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    while got < view.nbytes:
        n = sock.recv_into(view[got:])
        if not n:
            raise ConnectionError("Peer connection closed mid-frame.")
        got += n


def recv_peer_frame(
    sock: socket.socket, alloc: Optional[Any] = None
) -> Tuple[Dict[str, Any], Optional[memoryview]]:
    """Receive one frame: ``(header, payload_view_or_None)``.

    ``alloc(nbytes)`` supplies the payload buffer (a pooled staging slab,
    so repeated sub-chunk receives skip first-touch page faults and a CUDA
    copy can read the slab once it is registered); the default allocates
    a fresh bytearray. The returned view stays valid for as long as the
    caller holds it."""
    faultinject.site("peer.recv_frame")
    (hlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    header = pickle.loads(_recv_exact(sock, hlen))
    (plen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if plen == 0:
        return header, None
    buf = alloc(plen) if alloc is not None else bytearray(plen)
    view = memoryview(buf).cast("B")
    _recv_exact_into(sock, view)
    return header, view


def peer_connect(addr: str, timeout: float = PEER_CONNECT_TIMEOUT_S) -> socket.socket:
    """Connect to a peer listener at ``"host:port"``. TCP_NODELAY so the
    small end/abort control frames are not Nagle-delayed behind payload."""
    host, _, port = addr.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except BaseException:
        try:
            sock.close()
        except OSError:
            pass
        raise
    return sock


class PeerListener:
    """Accepts inbound peer-channel connections, one handler thread per
    connection (world - 1 inbound connections carrying payload frames:
    the threading shape of the store server). ``handler`` receives the
    connected socket and owns its lifecycle."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._handler: Optional[Any] = None
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, handler) -> None:
        self._handler = handler
        self._thread = threading.Thread(
            target=self._serve, name="torchsnapshot-peer-listener", daemon=True
        )
        self._thread.start()

    def _serve(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._handler,
                args=(conn,),
                name="torchsnapshot-peer-conn",
                daemon=True,
            ).start()

    def close(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass


class LinearBarrier:
    """Two-phase (arrive/depart) store barrier with leader action in between
    and cross-rank error propagation (reference: dist_store.py:91-196).

    Usable from any thread — it only talks to the store. The async-commit
    protocol relies on this: every rank arrives after its storage I/O
    completes; the leader (rank 0) writes the snapshot metadata between the
    phases; depart releases everyone. If any rank reports an error, all other
    ranks raise instead of committing.
    """

    def __init__(
        self,
        prefix: str,
        store: TCPStore,
        rank: int,
        world_size: int,
        leader_rank: int = 0,
    ) -> None:
        self.prefix = prefix
        self.store = store
        self.rank = rank
        self.world_size = world_size
        self.leader_rank = leader_rank

    def _key(self, *parts: str) -> str:
        return "/".join((self.prefix,) + parts)

    def _err_key(self) -> str:
        return self._key("error")

    def report_error(self, err: BaseException) -> None:
        try:
            payload = pickle.dumps(err)
        except Exception:
            payload = pickle.dumps(RuntimeError(repr(err)))
        self.store.set(self._err_key(), payload)

    def _raise_if_error(self, key: str, value: bytes) -> None:
        if key == DEATH_KEY:
            raise RuntimeError(
                f"A peer rank died at barrier {self.prefix!r}."
            ) from pickle.loads(value)
        if key == self._err_key():
            err = pickle.loads(value)
            raise RuntimeError(
                f"A peer rank reported an error at barrier {self.prefix!r}."
            ) from err

    def arrive(self, timeout: Optional[float] = None) -> None:
        self.store.set(self._key("arrive", str(self.rank)), b"1")
        if self.rank == self.leader_rank:
            # One server-side collect instead of world sequential waits:
            # the leader's arrival phase is on the commit critical path.
            stopped, items = self.store.collect(
                self._key("arrive") + "/",
                self.world_size,
                stop_keys=[self._err_key(), DEATH_KEY],
                timeout=timeout,
            )
            if stopped is not None:
                self._raise_if_error(stopped, items[stopped])

    def depart(self, timeout: Optional[float] = None) -> None:
        if self.rank == self.leader_rank:
            self.store.set(self._key("depart"), b"1")
            # Reclaiming barrier keys here would race stragglers still
            # waiting on depart; when the prefix is nested under a PGWrapper
            # namespace, the retire/GC protocol reclaims them once every
            # rank has acked (pg_wrapper.PGWrapper.retire).
        else:
            key, value = self.store.wait_any(
                [self._key("depart"), self._err_key(), DEATH_KEY], timeout
            )
            self._raise_if_error(key, value)
