"""Fleet-scale checkpoint distribution: a persistent, content-addressed
peer-seeding layer with tree fan-out, plus journal-delta rolling updates
(counterpart of the JAX package's ``distrib.py``; the seed registry rows,
the peer frames and the pushed epochs are byte-compatible, so a JAX
seeder serves a port replica and the other way round).

The cooperative restore (fanout.py) removed the N× read amplification
WITHIN one collective restore: ranks that are restoring together
partition the shared reads and redistribute sub-chunks. This module
generalizes that one-shot plan into fleet infrastructure: a serving
fleet of independent replicas — separate processes, separate restores,
overlapping in time but never in a collective — picks up a new model
version with ≈ ONE aggregate storage read, because every replica that
has a chunk seeds it to the replicas that still need it.

Mechanics:

- **Content addressing.** A restore's shareable read units (the same
  ``replicated/``/``sharded/`` scope rule the coop fan-out uses —
  :func:`fanout.content_unit_id` is the shared key scheme) map to a
  digest in ``device_digest``'s ``sha256:<hex>`` namespace, computed
  over the unit's actual bytes. The digest is the transfer key AND the
  end-to-end integrity check: a receiver re-hashes what it got and a
  mismatch (bit rot, a corrupting peer, a torn transfer) rejects the
  chunk exactly like a CRC failure — re-parent, ultimately re-read
  direct. No peer is trusted.
- **Seed registry.** Availability lives under the replicated
  coordination store (``tsnap/seed/`` — dist_store.py's seed-registry
  ops), so it survives a store-leader failover with the rest of the
  keyspace: a unit catalog (unit id -> digest) and, per digest, one row
  per live holder carrying its peer address, its depth in the seeding
  tree, its registration sequence, and its measured serve rate. Holder
  death is detected through the store's liveness plane: every session
  registers a death-notice key the store publishes if the connection
  drops without a deregister — fetchers skip (and lazily retract) any
  holder whose notice is up, so a SIGKILLed seeder becomes a ghost, not
  a hang.
- **Tree fan-out.** There is no owner rank. A fetcher elects a parent
  from the live holders by registration order + measured rate, and a
  holder already serving ``TORCHSNAPSHOT_GPU_SEED_FANOUT`` transfers
  answers ``busy`` — so the fleet self-organizes into a bounded-degree
  tree (depth O(log_fanout N)); each fetched chunk registers at
  ``parent depth + 1`` and a storage read registers at depth 0. Any
  candidate failing (dead, busy, miss, digest mismatch) re-parents to
  the next; when no peer delivers, the chunk degrades to a direct
  storage read — budget re-charged by the caller, ``fanout_fallbacks``
  counted — never a hang, never silent corruption.
- **Rolling updates.** ``CheckpointManager.push_update()`` ships only
  committed journal epochs (journal.py records: already TSJR-framed,
  CRC32C'd, generation-fenced) to live replicas that registered as
  holders of the base step, so a new-version rollout moves ≈ the dirty
  set instead of the full snapshot. Receivers verify every record CRC
  before touching state and apply each ``(gen, epoch)`` exactly once —
  a duplicated or replayed push is acknowledged and dropped.

Restore integration is a storage TIER, not scheduler surgery:
:func:`maybe_wrap_restore` wraps the restore's storage plugin so every
shareable buffered read first consults the local chunk cache
(``seed_cache_hits``), then the peer mesh (``bytes_from_seeders``), then
storage — and every chunk this process obtains (either way) is cached,
registered, and served to later restorers for
``TORCHSNAPSHOT_GPU_SEED_TTL_S`` seconds. The session is process-
persistent by design: a replica that finished (or only partially
finished — registrations happen per chunk, retraction on abort) its
restore keeps seeding while it serves traffic.

Election mirrors the coop-restore knob exactly:
``TORCHSNAPSHOT_GPU_SEED_RESTORE`` never (default) / always / auto,
``auto`` consulting ``IOGovernor.should_seed_restore`` — on memcpy-speed
local storage the socket hop loses to the page cache; on
throttled/network storage seeding wins by ~N×. Unlike the coop fan-out
the election is NOT collective: seeding is per-replica and every miss
falls back to a direct read, so env skew can never hang anything.

THIS MODULE NEVER TOUCHES A DEVICE OR A COLLECTIVE: sessions serve from
background threads and the peer plane stays device-free by construction
(``tests/test_torch_isolation.py`` checks this file with fanout.py and
dist_store.py). The journal's decode and apply — which copy into CUDA
leaves in place — are imported lazily at the apply site.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import faultinject, telemetry
from .dist_store import (
    PeerListener,
    SEED_CATALOG_PREFIX,
    SEED_DEAD_PREFIX,
    SEED_HOLDER_PREFIX,
    SEED_SEQ_KEY,
    SEED_UPDATE_PREFIX,
    peer_connect,
    recv_peer_frame,
    seed_catalog_get,
    seed_catalog_put,
    seed_holder_key,
    seed_holder_rows,
    send_peer_frame,
)
from .fanout import content_address, content_unit_id
from .telemetry import flightrec, health

logger = logging.getLogger(__name__)

SEED_RESTORE_ENV_VAR = "TORCHSNAPSHOT_GPU_SEED_RESTORE"
SEED_FANOUT_ENV_VAR = "TORCHSNAPSHOT_GPU_SEED_FANOUT"
SEED_TTL_S_ENV_VAR = "TORCHSNAPSHOT_GPU_SEED_TTL_S"
UPDATE_PUSH_ENV_VAR = "TORCHSNAPSHOT_GPU_UPDATE_PUSH"

#: Children a holder serves concurrently before answering ``busy`` — the
#: tree's branching factor. 3 keeps depth ~log3(N) while bounding any
#: one replica's upload to 3 concurrent transfers.
_DEFAULT_SEED_FANOUT = 3

#: How long a cached chunk stays served after its last touch. Rollouts
#: complete in minutes; a stale fleet re-reading storage is correct,
#: just slower, so the TTL errs short rather than pinning memory.
_DEFAULT_SEED_TTL_S = 900.0

#: In-memory chunk-cache ceiling. Eviction retracts the registration so
#: the registry never advertises bytes this process can no longer serve.
_CACHE_CAP_BYTES = 1 << 30

#: Peer dial/handshake budget per candidate. Short on purpose: the whole
#: point of re-parenting is that a dead candidate costs seconds, and the
#: direct-read fallback is always behind it.
_FETCH_CONNECT_TIMEOUT_S = 10.0


def seed_restore_mode() -> str:
    """THE parser for ``TORCHSNAPSHOT_GPU_SEED_RESTORE``: ``never``
    (default — fleets opt in) disables the seeding tier, ``always``
    engages it unconditionally, ``auto`` engages only when the I/O
    governor's measured read bandwidth says peer hops beat direct
    storage reads (``IOGovernor.should_seed_restore``)."""
    raw = os.environ.get(SEED_RESTORE_ENV_VAR, "never").strip().lower()
    if raw in ("1", "true", "on", "yes", "always", "force"):
        return "always"
    if raw in ("auto", "governor"):
        return "auto"
    return "never"


def seed_fanout() -> int:
    raw = os.environ.get(SEED_FANOUT_ENV_VAR, "").strip()
    try:
        return max(1, int(raw)) if raw else _DEFAULT_SEED_FANOUT
    except ValueError:
        return _DEFAULT_SEED_FANOUT


def seed_ttl_s() -> float:
    raw = os.environ.get(SEED_TTL_S_ENV_VAR, "").strip()
    try:
        return max(1.0, float(raw)) if raw else _DEFAULT_SEED_TTL_S
    except ValueError:
        return _DEFAULT_SEED_TTL_S


def update_push_enabled() -> bool:
    """``TORCHSNAPSHOT_GPU_UPDATE_PUSH=1`` makes ``journal_step`` push
    each committed epoch to registered live replicas automatically;
    ``CheckpointManager.push_update()`` works regardless."""
    return os.environ.get(UPDATE_PUSH_ENV_VAR, "0").strip().lower() not in (
        "", "0", "false", "no", "off",
    )


class SeedUnavailable(IOError):
    """No live peer delivered this chunk (all candidates dead, busy,
    missing, or corrupt). The caller re-charges its budget and reads the
    chunk direct from storage — a routing signal, never fatal."""


# --------------------------------------------------------------- chunk cache


class ChunkCache:
    """Digest-keyed in-memory chunk bytes with TTL + byte-cap eviction.

    Semantics pinned by tests/test_torch_distrib.py: a hit refreshes the TTL
    (serving a chunk proves it is still hot), expiry and cap eviction
    report the evicted digests so the session can retract their registry
    rows — the cache must never diverge from what the registry
    advertises in the direction of advertising bytes it cannot serve."""

    def __init__(
        self, ttl_s: Optional[float] = None, cap_bytes: int = _CACHE_CAP_BYTES
    ) -> None:
        self.ttl_s = ttl_s if ttl_s is not None else seed_ttl_s()
        self.cap_bytes = cap_bytes
        self._lock = threading.Lock()
        #: digest -> (bytes, last_touch). Insertion order doubles as LRU
        #: order because every touch re-inserts.
        self._chunks: Dict[str, Tuple[bytes, float]] = {}
        self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._chunks)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, digest: str) -> Optional[bytes]:
        now = telemetry.monotonic()
        with self._lock:
            hit = self._chunks.get(digest)
            if hit is None:
                return None
            buf, touched = hit
            if now - touched > self.ttl_s:
                del self._chunks[digest]
                self._bytes -= len(buf)
                return None
            del self._chunks[digest]  # re-insert: LRU refresh
            self._chunks[digest] = (buf, now)
            return buf

    def put(self, digest: str, buf: bytes) -> List[str]:
        """Insert; returns digests evicted to make room (TTL-expired or
        LRU past the byte cap) so the caller can retract them."""
        buf = bytes(buf)
        now = telemetry.monotonic()
        evicted: List[str] = []
        with self._lock:
            old = self._chunks.pop(digest, None)
            if old is not None:
                self._bytes -= len(old[0])
            for d, (b, touched) in list(self._chunks.items()):
                if now - touched > self.ttl_s:
                    del self._chunks[d]
                    self._bytes -= len(b)
                    evicted.append(d)
            while self._bytes + len(buf) > self.cap_bytes and self._chunks:
                d, (b, _) = next(iter(self._chunks.items()))
                del self._chunks[d]
                self._bytes -= len(b)
                evicted.append(d)
            if len(buf) <= self.cap_bytes:
                self._chunks[digest] = (buf, now)
                self._bytes += len(buf)
        return evicted

    def drop(self, digest: str) -> None:
        with self._lock:
            hit = self._chunks.pop(digest, None)
            if hit is not None:
                self._bytes -= len(hit[0])


# --------------------------------------------------------------- the session


class SeedSession:
    """One process's membership in the seeding mesh: a chunk cache, a
    peer listener serving it, and this holder's registry rows.

    The session OWNS the store client handed to it (closes it on
    ``close``). It is long-lived by design — module-level
    :func:`session` keeps one per process so chunks a restore obtained
    keep seeding later restorers; tests construct sessions directly for
    isolated meshes."""

    def __init__(self, store: Any, holder_id: Optional[str] = None) -> None:
        self.store = store
        self.holder_id = holder_id or f"{os.getpid()}-{os.urandom(4).hex()}"
        self.cache = ChunkCache()
        self._lock = threading.Lock()
        self._serving = 0
        self._closed = False
        #: digest -> registered depth; the session's own registry rows.
        self._registered: Dict[str, int] = {}
        self._seed_bytes = 0  # cumulative, feeds the watch heartbeat
        #: serve-rate EWMA (bytes/s) advertised in this holder's rows so
        #: fetchers can prefer fast parents; None until measured.
        self._rate_bps: Optional[float] = None
        self._listener = PeerListener()
        self._listener.start(self._handle_conn)
        try:
            ip = store.local_ip() or "127.0.0.1"
        except Exception:  # noqa: BLE001 - loopback store in tests
            ip = "127.0.0.1"
        self.addr = f"{ip}:{self._listener.port}"
        # Death notice: if this process dies without deregistering,
        # the store publishes the key and every fetcher skips (and
        # lazily retracts) this holder's rows — the ghost-key rule.
        try:
            store.register_liveness(
                f"{SEED_DEAD_PREFIX}{self.holder_id}", b"1"
            )
        except Exception:  # noqa: BLE001 - registry without liveness ops
            logger.debug("seed liveness registration skipped", exc_info=True)

    # ------------------------------------------------------------- serving

    def _handle_conn(self, conn: Any) -> None:
        try:
            while True:
                header, _payload = recv_peer_frame(conn)
                op = header.get("op")
                if op == "fetch":
                    self._serve_fetch(conn, str(header.get("digest")))
                elif op == "bye":
                    return
                else:
                    send_peer_frame(conn, {"op": "error", "got": op})
                    return
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_fetch(self, conn: Any, digest: str) -> None:
        with self._lock:
            busy = self._serving >= seed_fanout()
            if not busy:
                self._serving += 1
        if busy:
            send_peer_frame(conn, {"op": "busy"})
            return
        t0 = telemetry.monotonic()
        try:
            buf = self.cache.get(digest)
            if buf is None:
                send_peer_frame(conn, {"op": "miss"})
                return
            # THE seed-transfer fault site: the chunk payload as it
            # leaves the seeding peer. A ``corrupt`` rule here is caught
            # by the receiver's digest re-hash; a ``kill`` rule dies
            # mid-transfer.
            out = faultinject.mutate("distrib.seed_xfer", buf)
            send_peer_frame(
                conn,
                {"op": "chunk", "digest": digest, "nbytes": len(buf)},
                out,
            )
            dt = telemetry.monotonic() - t0
            if dt > 0:
                sample = len(buf) / dt
                self._rate_bps = (
                    sample
                    if self._rate_bps is None
                    else 0.5 * self._rate_bps + 0.5 * sample
                )
        finally:
            with self._lock:
                self._serving -= 1

    # ------------------------------------------------------------ registry

    def lookup(self, unit_id: str) -> Optional[Tuple[str, int]]:
        """Catalog lookup: ``(digest, nbytes)`` for a unit another
        replica already published, else None."""
        return seed_catalog_get(self.store, unit_id)

    def publish(
        self, unit_id: str, buf: bytes, depth: int
    ) -> str:
        """Cache a chunk this process now holds and register its
        availability: catalog row (unit -> digest) plus this holder's
        digest row. Returns the digest. ``depth`` 0 = read direct from
        storage; a peer-fetched chunk registers at parent depth + 1."""
        digest = content_address(buf)
        for evicted in self.cache.put(digest, buf):
            self._retract_digest(evicted)
        try:
            seed_catalog_put(self.store, unit_id, digest, len(buf))
            seq = self.store.add(SEED_SEQ_KEY, 1)
            row = {
                "addr": self.addr,
                "depth": depth,
                "seq": seq,
                "rate": self._rate_bps,
            }
            self.store.set(
                seed_holder_key(digest, self.holder_id),
                json.dumps(row).encode("utf-8"),
            )
        except Exception:  # noqa: BLE001 - registry down: keep restoring
            logger.debug("seed registration skipped", exc_info=True)
            return digest
        with self._lock:
            self._registered[digest] = depth
        flightrec.record(
            "distrib.register",
            digest=digest,
            nbytes=len(buf),
            depth=depth,
            holder=self.holder_id,
        )
        return digest

    def _retract_digest(self, digest: str) -> None:
        with self._lock:
            self._registered.pop(digest, None)
        try:
            self.store.delete(seed_holder_key(digest, self.holder_id))
        except Exception:  # noqa: BLE001
            logger.debug("seed retraction skipped", exc_info=True)

    def retract(self, digests: Optional[List[str]] = None) -> None:
        """Retract this holder's registry rows (all of them by default).
        Restore abort calls this with the digests that restore
        registered: a partially-restored replica must not advertise
        chunks it may be about to throw away."""
        if digests is None:
            with self._lock:
                digests = list(self._registered)
        for digest in digests:
            self.cache.drop(digest)
            self._retract_digest(digest)

    # ------------------------------------------------------------- fetching

    def _live_holders(self, digest: str) -> List[Dict[str, Any]]:
        """This digest's holder rows, dead peers skipped AND lazily
        retracted (their death notice is up — the ghost-key rule), own
        rows skipped, ordered by the parent election: registration
        order, faster measured rate breaking ties at the same depth."""
        rows = seed_holder_rows(self.store, digest)
        try:
            _, dead = self.store.collect(SEED_DEAD_PREFIX, 0, timeout=5.0)
        except Exception:  # noqa: BLE001
            dead = {}
        dead_ids = {k[len(SEED_DEAD_PREFIX):] for k in dead}
        live = []
        for holder_id, row in rows.items():
            if holder_id == self.holder_id:
                continue
            if holder_id in dead_ids:
                try:
                    self.store.delete(seed_holder_key(digest, holder_id))
                except Exception:  # noqa: BLE001
                    pass
                continue
            live.append(row)
        live.sort(
            key=lambda r: (
                r.get("depth", 0),
                -(r.get("rate") or 0.0),
                r.get("seq", 0),
            )
        )
        return live

    def fetch(self, unit_id: str, digest: str, nbytes: int) -> bytes:
        """Fetch one chunk from the mesh: local cache, then peers with
        re-parenting. Verifies the content address end to end. Raises
        :class:`SeedUnavailable` when no peer delivers — the caller
        reads direct and publishes at depth 0."""
        cached = self.cache.get(digest)
        if cached is not None:
            telemetry.counter_add("seed_cache_hits", 1)
            return cached
        for row in self._live_holders(digest):
            addr = row.get("addr")
            if not addr:
                continue
            try:
                buf = self._fetch_from(str(addr), digest)
            except (ConnectionError, OSError, EOFError) as e:
                logger.debug("seed peer %s failed: %s; re-parenting", addr, e)
                continue
            if buf is None:
                continue  # busy or miss: re-parent
            if content_address(buf) != digest or len(buf) != nbytes:
                # A corrupting or torn peer: reject like a CRC failure
                # and re-parent. Never retried from the same parent.
                logger.warning(
                    "seeded chunk from %s failed its content address; "
                    "re-parenting",
                    addr,
                )
                continue
            telemetry.counter_add("bytes_from_seeders", len(buf))
            self._seed_bytes += len(buf)
            health.update(seed_bytes=self._seed_bytes)
            flightrec.record(
                "distrib.fetch",
                digest=digest,
                nbytes=len(buf),
                parent=addr,
                depth=int(row.get("depth", 0)) + 1,
            )
            self.publish(unit_id, buf, depth=int(row.get("depth", 0)) + 1)
            return buf
        raise SeedUnavailable(f"no live seeder delivered {digest}")

    def _fetch_from(self, addr: str, digest: str) -> Optional[bytes]:
        sock = peer_connect(addr, timeout=_FETCH_CONNECT_TIMEOUT_S)
        try:
            send_peer_frame(sock, {"op": "fetch", "digest": digest})
            header, payload = recv_peer_frame(sock)
            try:
                send_peer_frame(sock, {"op": "bye"})
            except OSError:
                pass
            if header.get("op") != "chunk" or payload is None:
                return None  # busy / miss / error: re-parent
            return bytes(payload)
        finally:
            try:
                sock.close()
            except OSError:
                pass

    @property
    def max_registered_depth(self) -> int:
        with self._lock:
            return max(self._registered.values(), default=0)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.retract()
        try:
            self.store.deregister_liveness(
                f"{SEED_DEAD_PREFIX}{self.holder_id}"
            )
        except Exception:  # noqa: BLE001
            pass
        self._listener.close()
        try:
            self.store.close()
        except Exception:  # noqa: BLE001
            pass


# ------------------------------------------------- process-persistent session

_session_lock = threading.Lock()
_session: Optional[SeedSession] = None
_registry_factory: Optional[Callable[[], Any]] = None


def configure_registry(factory: Optional[Callable[[], Any]]) -> None:
    """Install a factory producing an OWNED store client for the seed
    registry — how fleets whose replicas restore without a process group
    (and tests/benchmarks) point sessions at a shared store. ``None``
    restores the default resolution (process group store, then
    ``TORCHSNAPSHOT_GPU_STORE_ADDR``)."""
    global _registry_factory
    _registry_factory = factory


def _registry_store(pg_wrapper: Any = None) -> Optional[Any]:
    from .tenancy import maybe_scope_store

    return maybe_scope_store(_registry_store_raw(pg_wrapper))


def _registry_store_raw(pg_wrapper: Any = None) -> Optional[Any]:
    if _registry_factory is not None:
        try:
            return _registry_factory()
        except Exception:  # noqa: BLE001 - registry down: run unseeded
            logger.debug("configured seed registry unavailable", exc_info=True)
            return None
    store = getattr(getattr(pg_wrapper, "pg", None), "store", None)
    if store is not None:
        try:
            return store.clone()
        except Exception:  # noqa: BLE001
            logger.debug("seed registry clone failed", exc_info=True)
            return None
    from .pg_wrapper import STORE_ADDR_ENV_VAR

    addr = os.environ.get(STORE_ADDR_ENV_VAR, "").strip()
    if addr:
        from .dist_store import TCPStore

        host, _, port = addr.rpartition(":")
        try:
            return TCPStore(host, int(port), is_server=False, timeout=30.0)
        except (OSError, ValueError, ConnectionError):
            logger.debug("seed registry addr unreachable", exc_info=True)
    return None


def session(pg_wrapper: Any = None) -> Optional[SeedSession]:
    """The process-persistent session, created on first use (None when
    no registry store is reachable). Persistence is the point: chunks
    this process obtained keep seeding the fleet after its restore
    returns, until TTL expiry or process exit."""
    global _session
    with _session_lock:
        if _session is not None and not _session._closed:
            return _session
        store = _registry_store(pg_wrapper)
        if store is None:
            return None
        try:
            _session = SeedSession(store)
        except Exception:  # noqa: BLE001 - no listener port etc.
            logger.debug("seed session unavailable", exc_info=True)
            try:
                store.close()
            except Exception:  # noqa: BLE001
                pass
            return None
        return _session


def reset_session() -> None:
    """Close and forget the process session (tests)."""
    global _session
    with _session_lock:
        if _session is not None:
            try:
                _session.close()
            except Exception:  # noqa: BLE001
                pass
            _session = None


# --------------------------------------------------------- the storage tier


class SeedingStoragePlugin:
    """A storage tier sourcing shareable buffered reads from the seeding
    mesh before the wrapped plugin (restore consumers see storage
    semantics, bytes just arrive from peers when peers have them).

    Streamed reads are declined (``supports_streaming_reads`` False) so
    every shareable read takes the buffered path where the whole chunk
    can be digest-verified before a consumer sees it; the tier is
    elected on slow storage, where the buffered window is not the
    bottleneck. Writes and deletes delegate untouched.

    ``abort()`` retracts exactly the registrations THIS restore made
    (the session may be seeding chunks from earlier restores that
    remain valid)."""

    supports_streaming = False
    supports_streaming_reads = False

    def __init__(self, inner: Any, sess: SeedSession, scope: str) -> None:
        self.inner = inner
        self.session = sess
        self.scope = scope
        self._published: List[str] = []
        self._lock = threading.Lock()

    async def read(self, read_io: Any) -> None:
        unit_id = content_unit_id(
            self.scope, read_io.path, read_io.byte_range
        )
        if unit_id is None:
            await self.inner.read(read_io)
            return
        hit = self.session.lookup(unit_id)
        if hit is not None:
            digest, nbytes = hit
            try:
                read_io.buf = self.session.fetch(unit_id, digest, nbytes)
                return
            except SeedUnavailable:
                telemetry.counter_add("fanout_fallbacks", 1)
                flightrec.record(
                    "fanout.fallback", key=unit_id, owner="seed"
                )
        await self.inner.read(read_io)
        digest = self.session.publish(
            unit_id, bytes(memoryview(read_io.buf).cast("B")), depth=0
        )
        with self._lock:
            self._published.append(digest)

    async def write(self, write_io: Any) -> None:
        await self.inner.write(write_io)

    async def write_stream(self, stream: Any) -> None:
        await self.inner.write_stream(stream)

    async def delete(self, path: str) -> None:
        await self.inner.delete(path)

    async def drain_background(self) -> None:
        drain = getattr(self.inner, "drain_background", None)
        if drain is not None:
            await drain()

    async def close(self) -> None:
        # The session persists past the restore by design; only the
        # wrapped plugin closes with the operation.
        await self.inner.close()

    def sync_close(self, event_loop: Any) -> None:
        self.inner.sync_close(event_loop)

    def abort(self) -> None:
        """Restore aborted: retract what THIS restore registered. A
        partially-restored replica keeps seeding only chunks whose
        bytes it verifiably obtained before the failure — which these
        were — but conservative retraction is cheaper to reason about
        than proving the cache outlives the abort path, so the rows go."""
        with self._lock:
            published, self._published = self._published, []
        self.session.retract(published)


def unwrap_seed(storage: Any) -> Any:
    """The plugin under the seeding tier (or ``storage`` itself when
    unwrapped): degraded page-in retries and queue-jumping demand
    faults read through this so they depend on nothing but storage."""
    if isinstance(storage, SeedingStoragePlugin):
        return storage.inner
    return storage


def maybe_wrap_restore(
    storage: Any, path: str, pg_wrapper: Any = None
) -> Tuple[Any, Optional[SeedingStoragePlugin]]:
    """The restore-path hook (snapshot.py): wrap ``storage`` in the
    seeding tier when elected. Returns ``(storage, tier-or-None)``; the
    default-off path is one env check. Never raises — a restore must
    work exactly as before when the registry is unreachable."""
    mode = seed_restore_mode()
    if mode == "never":
        return storage, None
    plugin_name = type(storage).__name__
    if mode == "auto":
        from .scheduler import io_governor

        gov = io_governor()
        engage = gov.should_seed_restore(plugin_name)
        telemetry.record_election(
            site="seed_restore",
            mode=mode,
            engage=engage,
            plugin=plugin_name,
            rates=gov.measured_rates(),
        )
        if not engage:
            return storage, None
    sess = session(pg_wrapper)
    if sess is None:
        return storage, None
    tier = SeedingStoragePlugin(storage, sess, scope=path)
    return tier, tier


# ----------------------------------------------------------- rolling updates


class UpdateReceiver:
    """A live replica's intake for journal-delta rolling updates.

    Registers this process under the base step it currently serves
    (``tsnap/seed/upd/<step>/``) with the same death-notice liveness key
    the seeding rows use, listens for epoch pushes, CRC-verifies every
    TSJR record BEFORE touching state (verify-then-apply, the journal
    replay contract), and applies each ``(gen, epoch)`` EXACTLY ONCE —
    a duplicated push is acked as a duplicate and dropped, so pushers
    may retry blindly.

    Application runs on the receiver thread and materializes leaves to
    match the live state's types; fleets with device-backed state should
    pause the step loop around pushes the way they would around any
    in-place restore."""

    def __init__(self, store: Any, app_state: Any, base_step: int) -> None:
        self.store = store
        self.app_state = app_state
        self.base_step = int(base_step)
        self.holder_id = f"{os.getpid()}-{os.urandom(4).hex()}"
        self._lock = threading.Lock()
        self._applied: set = set()  # (gen, epoch) exactly-once ledger
        self.epochs_applied = 0
        self.records_applied = 0
        self._listener = PeerListener()
        self._listener.start(self._handle_conn)
        try:
            ip = store.local_ip() or "127.0.0.1"
        except Exception:  # noqa: BLE001
            ip = "127.0.0.1"
        self.addr = f"{ip}:{self._listener.port}"
        self._key = f"{SEED_UPDATE_PREFIX}{self.base_step}/{self.holder_id}"
        store.set(
            self._key, json.dumps({"addr": self.addr}).encode("utf-8")
        )
        try:
            store.register_liveness(
                f"{SEED_DEAD_PREFIX}{self.holder_id}", b"1"
            )
        except Exception:  # noqa: BLE001
            logger.debug("update liveness registration skipped", exc_info=True)

    def _handle_conn(self, conn: Any) -> None:
        try:
            while True:
                header, payload = recv_peer_frame(conn)
                op = header.get("op")
                if op == "push":
                    send_peer_frame(conn, self._apply_push(header, payload))
                elif op == "bye":
                    return
                else:
                    send_peer_frame(conn, {"op": "error", "got": op})
                    return
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _apply_push(
        self, header: Dict[str, Any], payload: Optional[memoryview]
    ) -> Dict[str, Any]:
        from . import journal

        gen = header.get("gen")
        epoch = header.get("epoch")
        if header.get("base_step") != self.base_step:
            return {"op": "nack", "err": "base-step mismatch"}
        with self._lock:
            if (gen, epoch) in self._applied:
                return {"op": "ack", "dup": True}
        records, error = journal.decode_records(
            memoryview(payload) if payload is not None else memoryview(b"")
        )
        if error is not None:
            # The CRC caught a corrupt push (real bit rot or the
            # distrib.epoch_push fault site) before any state mutated.
            return {"op": "nack", "err": error}
        updates = {
            h["key"]: (h, p) for h, p in records if h.get("gen") == gen
        }
        with self._lock:
            if (gen, epoch) in self._applied:  # raced duplicate
                return {"op": "ack", "dup": True}
            if updates:
                journal._apply_updates(self.app_state, updates)
            self._applied.add((gen, epoch))
            self.epochs_applied += 1
            self.records_applied += len(updates)
        return {"op": "ack", "dup": False, "records": len(updates)}

    def close(self) -> None:
        try:
            self.store.delete(self._key)
        except Exception:  # noqa: BLE001
            pass
        try:
            self.store.deregister_liveness(
                f"{SEED_DEAD_PREFIX}{self.holder_id}"
            )
        except Exception:  # noqa: BLE001
            pass
        self._listener.close()


def live_update_targets(store: Any, base_step: int) -> Dict[str, str]:
    """Registered receivers for ``base_step`` (holder id -> addr), dead
    replicas skipped by their death notice."""
    prefix = f"{SEED_UPDATE_PREFIX}{int(base_step)}/"
    try:
        _, items = store.collect(prefix, 0, timeout=5.0)
        _, dead = store.collect(SEED_DEAD_PREFIX, 0, timeout=5.0)
    except Exception:  # noqa: BLE001
        return {}
    dead_ids = {k[len(SEED_DEAD_PREFIX):] for k in dead}
    out: Dict[str, str] = {}
    for key, raw in items.items():
        holder_id = key[len(prefix):]
        if holder_id in dead_ids:
            continue
        try:
            row = json.loads(bytes(raw).decode("utf-8"))
        except ValueError:
            continue
        if isinstance(row, dict) and row.get("addr"):
            out[holder_id] = str(row["addr"])
    return out


def push_committed_epochs(
    jdir: str,
    base_step: int,
    store: Any,
    cursor: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Ship committed journal epochs to every live registered replica of
    ``base_step`` — the rolling-update data plane behind
    ``CheckpointManager.push_update()``.

    ``cursor`` (holder id -> last epoch already pushed, mutated in
    place) keeps repeat pushes incremental; receivers dedup regardless,
    so a lost cursor only costs bytes, never correctness. Bytes moved ≈
    the committed dirty set: each epoch's payload is its ranks' TSJR
    record regions, read verbatim from the segments — no re-encode, the
    receiver verifies the same CRCs the journal wrote.

    Returns ``{"replicas", "epochs", "bytes", "nacks"}``. Per-replica
    failures (died mid-push, nacked a corrupt frame) are counted and
    skipped — the push is best-effort by design; a replica that missed
    it converges through its next restore's replay."""
    from . import journal

    summary = {"replicas": 0, "epochs": 0, "bytes": 0, "nacks": 0}
    metas = journal.read_epoch_metas(jdir)
    committed = journal.committed_epochs(metas)
    if not committed:
        return summary
    targets = live_update_targets(store, base_step)
    cursor = cursor if cursor is not None else {}
    for holder_id, addr in sorted(targets.items()):
        start = cursor.get(holder_id, 0)
        epochs = [m for m in committed if m.get("epoch", 0) > start]
        if not epochs:
            continue
        summary["replicas"] += 1
        try:
            sock = peer_connect(addr, timeout=_FETCH_CONNECT_TIMEOUT_S)
        except (ConnectionError, OSError):
            summary["nacks"] += 1
            continue
        try:
            for meta in epochs:
                blob = journal.read_epoch_blob(jdir, committed, meta["epoch"])
                # THE epoch-push fault site: the framed records as they
                # leave the pusher. CRCs were computed at append time,
                # so an injected corruption is receiver-detectable.
                out = faultinject.mutate("distrib.epoch_push", blob)
                send_peer_frame(
                    sock,
                    {
                        "op": "push",
                        "base_step": int(base_step),
                        "gen": meta.get("gen"),
                        "epoch": meta.get("epoch"),
                        "nbytes": len(blob),
                    },
                    out,
                )
                reply, _ = recv_peer_frame(sock)
                if reply.get("op") != "ack":
                    summary["nacks"] += 1
                    break
                summary["epochs"] += 1
                summary["bytes"] += len(blob)
                telemetry.counter_add("epoch_push_bytes", len(blob))
                flightrec.record(
                    "distrib.push",
                    gen=meta.get("gen"),
                    epoch=meta.get("epoch"),
                    nbytes=len(blob),
                    target=addr,
                    dup=bool(reply.get("dup")),
                )
                cursor[holder_id] = meta["epoch"]
            try:
                send_peer_frame(sock, {"op": "bye"})
            except OSError:
                pass
        except (ConnectionError, OSError, EOFError):
            summary["nacks"] += 1
        finally:
            try:
                sock.close()
            except OSError:
                pass
    return summary
