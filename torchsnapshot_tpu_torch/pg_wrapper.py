"""Process-group facade: object collectives for checkpoint coordination.

Counterpart of ``torchsnapshot_tpu/pg_wrapper.py``. Checkpoint
coordination payloads are small (key lists, manifests, partition plans, 16-
byte digest partials), so they never touch the device collective stack:
every object collective runs over the out-of-band TCP KV store of
``dist_store``. The data plane (storage I/O) and the compute plane (NCCL or
gloo collectives of the training program) carry no checkpoint traffic, and
every collective is usable from a background thread, which the async
commit protocol needs.

Process identity comes from ``torch.distributed`` when it is initialized
(``get_rank``/``get_world_size``), else from the ``RANK`` and
``WORLD_SIZE`` environment variables that ``torchrun`` sets, in place of
``jax.process_index``/``process_count`` (pg_wrapper.py:109-175 of the JAX
package). ``TORCHSNAPSHOT_GPU_STORE_ADDR`` ("host:port") bootstraps the
store, ``TORCHSNAPSHOT_GPU_STORE_REPLICAS`` its replication tier
(:func:`ensure_default_pg`). One process runs on one device: there is no
counterpart of JAX's several local devices per process.

``pg=`` of the snapshot API accepts this module's :class:`ProcessGroup`, or
a ``torch.distributed`` process group that spans the whole default world,
which supplies the identity only: its coordination runs over the default
group's store. A torch subgroup raises by name. A world of more than one
process without a store raises (the JAX package would run it as a world
of one, with every process writing rank 0's files).

Namespace protocol: the collectives of one wrapper must not collide with
another's store keys, and all ranks of one operation must agree on the
namespace. Agreement is a lazy handshake at the wrapper's first collective:
rank 0 allocates a sequence number with an atomic store counter and
publishes a fresh namespace under ``pgw/handshake/<seq>``; the other ranks
consume handshakes in order (a per-process, per-store cursor). A wrapper
built on one rank only and never used consumes nothing. ``retire()`` marks
the operation complete on the calling rank (a write, never a read); rank 0
deletes a retired namespace's keys at a later handshake, once every rank
has acked, so a job that snapshots every N steps keeps the store bounded.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import threading
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry
from .dist_store import DEATH_KEY, TCPStore, create_store
from .telemetry import flightrec, forensics

STORE_ADDR_ENV_VAR = "TORCHSNAPSHOT_GPU_STORE_ADDR"
_HANDSHAKE_SEQ_KEY = "pgw/seq"
_HANDSHAKE_PREFIX = "pgw/handshake"
# DEATH_KEY (dist_store): init_process_group registers each rank's store
# connection so the server publishes that key if the connection drops
# without a clean deregister. Every collective wait watches it: a peer
# dying mid-collective surfaces in seconds instead of at the store timeout.

# Collective payloads above this compress before they reach the store: the
# manifest all-gather moves world x payload bytes through one server, and
# manifest pickles deflate several-fold even at level 1.
_COMPRESS_THRESHOLD = 16 << 10


def _dumps(obj: Any) -> bytes:
    raw = pickle.dumps(obj)
    if len(raw) >= _COMPRESS_THRESHOLD:
        packed = zlib.compress(raw, 1)
        if len(packed) < len(raw):
            return b"\x01" + packed
    return b"\x00" + raw


def _loads(buf: bytes) -> Any:
    if buf[:1] == b"\x01":
        return pickle.loads(zlib.decompress(buf[1:]))
    return pickle.loads(buf[1:])


class ProcessGroup:
    """An explicit process group: (store, rank, world_size). The store is
    contacted only when ``world_size > 1``. ``local_world_size``, the
    processes of the group on this host, is known once
    :func:`count_local_processes` has counted them; None until then."""

    def __init__(
        self,
        store: Optional[TCPStore],
        rank: int,
        world_size: int,
        local_world_size: Optional[int] = None,
    ) -> None:
        if world_size > 1 and store is None:
            raise ValueError("A store is required when world_size > 1.")
        self.store = store
        self.rank = rank
        self.world_size = world_size
        self.local_world_size = 1 if world_size == 1 else local_world_size


_default_pg: Optional[ProcessGroup] = None


def process_identity() -> Tuple[int, int]:
    """``(rank, world_size)`` of this process: ``torch.distributed``'s when
    it is initialized, else ``RANK``/``WORLD_SIZE`` (default 0 and 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def init_process_group(
    store: Optional[TCPStore] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> ProcessGroup:
    """Initialize the default process group. A missing ``rank`` or
    ``world_size`` comes from :func:`process_identity`. Registers this
    process's store connection on the death channel: if the process dies
    mid-collective, peers raise within seconds instead of blocking until
    the store timeout. No op of the store is served: the processes of the
    host are counted at the group's first take or restore
    (:func:`count_local_processes`)."""
    global _default_pg
    if rank is None or world_size is None:
        env_rank, env_world = process_identity()
        rank = env_rank if rank is None else rank
        world_size = env_world if world_size is None else world_size
    pg = ProcessGroup(store, rank, world_size)
    if store is not None and world_size > 1:
        store.register_liveness(
            DEATH_KEY,
            pickle.dumps(
                RuntimeError(f"rank {rank} died (store connection lost without a clean shutdown)")
            ),
        )
    _default_pg = pg
    return pg


def count_local_processes(wrapper: "PGWrapper") -> int:
    """The processes of ``wrapper``'s group on this host, counted once, by a
    hostname all-gather at the group's first take or restore, where the JAX
    package counts them at every one (snapshot.py:704,934 there); the
    staging pool's default limit is split among them then. A collective on
    the first call: every rank of the group makes it at the same point."""
    pg = wrapper.pg
    if pg is None or pg.local_world_size is not None:
        return 1 if pg is None else pg.local_world_size
    from .io_preparers.array import share_staging_pool
    from .scheduler import get_local_world_size

    pg.local_world_size = get_local_world_size(wrapper)
    share_staging_pool(pg.local_world_size)
    default = _default_pg
    if default is not None and default.store is pg.store and default.local_world_size is None:
        # A torch.distributed group's identity over the default store
        # (see _as_process_group) counts for the default group too.
        default.local_world_size = pg.local_world_size
    return pg.local_world_size


def destroy_process_group() -> None:
    """Clean shutdown: deregister this rank from the death channel and
    drop the default group. Call when a rank finishes on purpose while
    peers may still run (otherwise its exit reads as a death)."""
    global _default_pg
    pg = _default_pg
    _default_pg = None
    if pg is not None and pg.store is not None and pg.world_size > 1:
        try:
            pg.store.deregister_liveness(DEATH_KEY)
        except Exception:  # noqa: BLE001 - best effort on shutdown
            pass


def get_default_pg() -> Optional[ProcessGroup]:
    return _default_pg


def ensure_default_pg() -> Optional[ProcessGroup]:
    """The default process group, bootstrapped from the environment at
    first use when none was initialized: identity from
    :func:`process_identity`, the store at ``TORCHSNAPSHOT_GPU_STORE_ADDR``
    through :func:`dist_store.create_store` (rank 0 hosts it; with
    ``TORCHSNAPSHOT_GPU_STORE_REPLICAS=N`` ranks 1..N host standbys).
    Returns None for a world of one process. A world of more than one
    without the address raises: a store is the only coordination the
    snapshot path has."""
    global _default_pg
    if _default_pg is not None:
        return _default_pg
    rank, world_size = process_identity()
    if world_size <= 1:
        return None
    addr = os.environ.get(STORE_ADDR_ENV_VAR, "").strip()
    if not addr:
        raise RuntimeError(
            f"a world of {world_size} processes needs the coordination store: set "
            f"{STORE_ADDR_ENV_VAR}=host:port (rank 0 hosts it) or call "
            "torchsnapshot_tpu_torch.pg_wrapper.init_process_group(store, rank, world_size)."
        )
    store = create_store(rank=rank, addr=addr)
    return init_process_group(store=store, rank=rank, world_size=world_size)


def _as_process_group(pg: Any) -> Optional[ProcessGroup]:
    """Resolve ``pg=``: this module's group as it is; None as the default
    group; a ``torch.distributed`` group as its identity over the default
    group's store. The store's namespace handshake has one counter and one
    cursor per process for the whole world, so a torch group is taken only
    when it spans the whole default world in rank order (a group of one
    process runs as a world of one). A subgroup raises by name: two
    disjoint subgroups taking at once would consume each other's
    handshakes."""
    if isinstance(pg, ProcessGroup):
        return pg
    if pg is None:
        return ensure_default_pg()
    if not hasattr(pg, "size"):
        raise ValueError(
            f"pg={pg!r} is neither a torch.distributed process group nor a "
            "torchsnapshot_tpu_torch.pg_wrapper.ProcessGroup (a process outside a "
            "torch.distributed subgroup holds no group)."
        )
    world_size = pg.size()
    if world_size <= 1:
        return None
    default = get_default_pg() or ensure_default_pg()
    if default is None or default.store is None:
        raise RuntimeError(
            f"a process group of {world_size} processes needs the coordination store: "
            f"set {STORE_ADDR_ENV_VAR}=host:port or call "
            "torchsnapshot_tpu_torch.pg_wrapper.init_process_group(store, rank, world_size)."
        )
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(pg)
    if ranks != list(range(default.world_size)):
        raise ValueError(
            f"pg= a torch.distributed subgroup of global ranks {ranks}: checkpoint "
            f"coordination runs over the whole default world of {default.world_size} "
            "processes. Pass pg=None, or a pg_wrapper.ProcessGroup with a store of its own "
            "for the subgroup."
        )
    return ProcessGroup(default.store, pg.rank(), world_size, default.local_world_size)


def _store_identity(store: TCPStore) -> str:
    """Per-process bookkeeping key for a store: the bootstrap address,
    stable across leader failovers (``store.addr`` tracks the leader)."""
    return getattr(store, "bootstrap_addr", None) or store.addr


# Per-process handshake cursors, keyed by store: how many handshakes this
# process has consumed against that store.
_handshake_cursor: Dict[str, int] = {}
# Rank-0 bookkeeping: (namespace, handshake_seq, world_size) triples this
# process allocated, retired locally, awaiting every rank's ack.
_retired_namespaces: Dict[str, List[tuple]] = {}
_handshake_lock = threading.Lock()


class PGWrapper:
    """The collective surface of the snapshot orchestrator: rank, world,
    barrier, broadcast, all-gather and scatter of objects, plus an error
    channel: ``report_error`` makes every peer blocked in a collective of
    this wrapper raise instead of timing out."""

    def __init__(self, pg: Any = None, namespace: Optional[str] = None) -> None:
        self.pg = _as_process_group(pg)
        self._seq = 0
        # An explicitly agreed namespace skips the handshake.
        self._ns: Optional[str] = namespace
        self._handshake_seq: Optional[int] = None
        self._retired = False

    def get_rank(self) -> int:
        return self.pg.rank if self.pg is not None else 0

    def get_world_size(self) -> int:
        return self.pg.world_size if self.pg is not None else 1

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -- namespace handshake ----------------------------------------------

    def _namespace(self) -> str:
        if self._ns is not None:
            return self._ns
        store = self.pg.store
        with _handshake_lock:
            if self._ns is not None:
                return self._ns
            cursor_key = _store_identity(store)
            if self.get_rank() == 0:
                self._gc_retired(store)
                seq = store.add(_HANDSHAKE_SEQ_KEY, 1)
                ns = f"pgw/ns/{seq}-{uuid.uuid4().hex[:8]}"
                store.set(f"{_HANDSHAKE_PREFIX}/{seq}", ns.encode())
            else:
                seq = _handshake_cursor.get(cursor_key, 0) + 1
                ns = store.get(f"{_HANDSHAKE_PREFIX}/{seq}").decode()
            _handshake_cursor[cursor_key] = seq
            self._handshake_seq = seq
            self._ns = ns
        return self._ns

    @staticmethod
    def _gc_retired(store: TCPStore) -> None:
        """Rank 0 only: delete the namespaces every rank has acked as
        retired. Runs at handshake time; acks are each rank's final write,
        so it never races an op of the namespace it deletes."""
        remaining: List[tuple] = []
        for item in _retired_namespaces.get(_store_identity(store), []):
            ns, seq, world_size = item
            if all(store.check(f"{ns}/retired/{r}") for r in range(world_size)):
                store.delete(f"{_HANDSHAKE_PREFIX}/{seq}")
                store.delete_prefix(ns)
            else:
                remaining.append(item)
        _retired_namespaces[_store_identity(store)] = remaining

    def retire(self) -> None:
        """Mark this wrapper's operation complete on this rank: a write
        that never blocks on peers, safe as an operation's final act."""
        if self._retired or self.get_world_size() == 1 or self._ns is None:
            return
        self._retired = True
        store = self.pg.store
        store.set(f"{self._ns}/retired/{self.get_rank()}", b"1")
        if self.get_rank() == 0:
            # May run on a commit thread while the main thread collects
            # garbage under the handshake lock.
            with _handshake_lock:
                _retired_namespaces.setdefault(_store_identity(store), []).append(
                    (self._ns, self._handshake_seq, self.get_world_size())
                )

    # -- error channel -----------------------------------------------------

    def _error_key(self) -> str:
        return f"{self._namespace()}/error"

    def report_error(self, err: BaseException) -> None:
        """Publish an error so peers blocked in this wrapper's collectives
        raise at once. A no-op before the wrapper's first collective (no
        peer can be waiting on it)."""
        if self.get_world_size() == 1 or self._ns is None:
            return
        try:
            payload = pickle.dumps(err)
        except Exception:  # noqa: BLE001 - unpicklable error
            payload = pickle.dumps(RuntimeError(repr(err)))
        self.pg.store.set(self._error_key(), payload)

    def _wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        """Wait for ``key``, racing it against the error and death
        channels."""
        got_key, value = self.pg.store.wait_any([key, self._error_key(), DEATH_KEY], timeout)
        if got_key != key:
            raise RuntimeError(
                "A peer rank died during a collective."
                if got_key == DEATH_KEY
                else "A peer rank reported an error during a collective."
            ) from pickle.loads(value)
        return value

    # -- object collectives over the KV store ------------------------------

    @contextlib.contextmanager
    def _recorded(self, kind: str, ns: str, seq: int, timeout: Optional[float] = None):
        """Flight-record one collective's enter and exit around its body
        (pg_wrapper.py:321-368 of the JAX package). ``(ns, cseq)`` is the
        key every rank of one collective records alike, so the blackbox
        merge can name who deserted whom without comparable clocks. With
        the bus on, also a ``collective_wait`` span and a wait-time
        histogram sample per verb. The stall watchdog learns of it with its
        effective deadline (its own bound, else the store's barrier
        timeout) and self-dumps stacks once it waits past a fraction."""
        flightrec.record("collective.enter", kind=kind, ns=ns, cseq=seq, deadline_s=timeout)
        effective_deadline = timeout
        if effective_deadline is None:
            effective_deadline = getattr(self.pg.store, "timeout", None)
        forensics.collective_begin(kind, ns, seq, effective_deadline)
        t0 = telemetry.monotonic() if telemetry.enabled() else None
        span = telemetry.span("collective_wait", cat="collective", kind=kind, ns=ns, cseq=seq)
        span.__enter__()
        try:
            yield
        except BaseException as e:  # noqa: B036 - re-raised
            forensics.collective_end(ns, seq)
            span.__exit__(None, None, None)
            flightrec.record("collective.exit", kind=kind, ns=ns, cseq=seq, ok=False,
                             error=repr(e))
            raise
        forensics.collective_end(ns, seq)
        span.__exit__(None, None, None)
        if t0 is not None:
            telemetry.histogram_observe("collective.wait_s", telemetry.monotonic() - t0, key=kind)
        flightrec.record("collective.exit", kind=kind, ns=ns, cseq=seq, ok=True)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        if self.get_world_size() == 1:
            return obj
        ns = self._namespace()
        seq = self._next_seq()
        key = f"{ns}/bcast/{seq}"
        with self._recorded("broadcast", ns, seq):
            if self.get_rank() == src:
                self.pg.store.set(key, _dumps(obj))
                return obj
            return _loads(self._wait(key))

    def all_gather_object(self, obj: Any, timeout: Optional[float] = None) -> List[Any]:
        """Every rank contributes; every rank receives all contributions,
        in rank order. Leader-assembled: peers post their pieces, rank 0
        collects them in one server round trip and republishes the list as
        one blob, which peers fetch. ``timeout`` bounds this collective's
        wait instead of the store's barrier timeout."""
        if self.get_world_size() == 1:
            return [obj]
        ns = self._namespace()
        seq = self._next_seq()
        with self._recorded("all_gather", ns, seq, timeout):
            return self._all_gather(obj, ns, seq, timeout)

    def _all_gather(self, obj: Any, ns: str, seq: int, timeout: Optional[float]) -> List[Any]:
        prefix = f"{ns}/gather/{seq}/"
        all_key = f"{ns}/gather/{seq}-all"
        store = self.pg.store
        if self.get_rank() == 0:
            stopped, items = store.collect(
                prefix,
                self.get_world_size() - 1,
                stop_keys=[self._error_key(), DEATH_KEY],
                timeout=timeout,
            )
            if stopped is not None:
                raise RuntimeError(
                    "A peer rank died during a collective."
                    if stopped == DEATH_KEY
                    else "A peer rank reported an error during a collective."
                ) from pickle.loads(items[stopped])
            assembled = [obj] + [
                _loads(items[f"{prefix}{r}"]) for r in range(1, self.get_world_size())
            ]
            store.set(all_key, _dumps(assembled))
            return assembled
        store.set(f"{prefix}{self.get_rank()}", _dumps(obj))
        return _loads(self._wait(all_key, timeout))

    def scatter_object(self, objs: Optional[List[Any]], src: int = 0) -> Any:
        if self.get_world_size() == 1:
            if objs is None or len(objs) != 1:
                raise ValueError("scatter_object in a world of 1 takes a list of one object")
            return objs[0]
        ns = self._namespace()
        seq = self._next_seq()
        rank = self.get_rank()
        with self._recorded("scatter", ns, seq):
            if rank == src:
                if objs is None or len(objs) != self.get_world_size():
                    raise ValueError(
                        f"scatter_object: the source needs {self.get_world_size()} objects"
                    )
                self.pg.store.mset(
                    {f"{ns}/scatter/{seq}/{r}": _dumps(o) for r, o in enumerate(objs)})
                return objs[src]
            return _loads(self._wait(f"{ns}/scatter/{seq}/{rank}"))

    def barrier(self) -> None:
        if self.get_world_size() == 1:
            return
        ns = self._namespace()
        seq = self._next_seq()
        store = self.pg.store
        with self._recorded("barrier", ns, seq):
            arrived = store.add(f"{ns}/barrier/{seq}/count", 1)
            if arrived == self.get_world_size():
                store.set(f"{ns}/barrier/{seq}/done", b"1")
            self._wait(f"{ns}/barrier/{seq}/done")
