"""Cross-region disaster recovery: asynchronous geo-replication of
committed snapshots and journal epochs.

Counterpart of ``torchsnapshot_tpu/georep.py``; the remote tree and its
cursor (``.georep_cursor.json``) are the JAX package's, so a tree shipped
by either package restores in the other. The mirror tier
(``storage_plugins/mirror.py``) covers the loss of a machine and makes
every save wait for its second tier's writes to drain; this tier covers
the loss of the region, off the save path: a rank-0 background daemon
ships the same committed bytes to a remote root, with a measured lag
instead of a foreground cost.

- The unit of replication. A committed base snapshot ships as a
  consolidate-style copy (``dedup.consolidate``'s idiom): every payload,
  local or borrowed from an origin, lands under the remote step
  directory, origins are cleared, the metadata commits last. A committed
  journal epoch ships as its verbatim record blob
  (``journal.read_epoch_blob``) plus its epoch metadata; the remote apply
  re-verifies every record CRC (``journal.decode_records``) and extends
  each rank's remote segment, metadata last. The remote step directory is
  a real snapshot and journal tree: a recovery is a plain
  ``Snapshot(remote_step).restore``, whose replay folds the epochs.
- Exactly once. The cursor in the remote step directory records what the
  remote holds (base step, last applied epoch and its generation). A
  restarted shipper resumes from it; one killed between an epoch's remote
  metadata and the cursor update finds the metadata and advances.
- Never splice. Three fences: record CRCs (a frame corrupted in flight is
  refused before any remote byte changes, and re-shipped from the intact
  primary); offset continuity (an epoch's region extends a remote segment
  from exactly its previous committed offset, or matches bytes already
  there); generation chaining (epoch k applies only when the remote chain
  carries the generation the local chain names for epoch k-1).
- The foreground only enqueues (a dict insert and an event). Pending work
  coalesces per step and is bounded by ``TORCHSNAPSHOT_GPU_GEOREP_BACKLOG``
  (the oldest step drops: a newer committed base supersedes it).

``lag_s`` is the age of the oldest committed but unshipped state: what a
region loss at that instant would cost beyond a local crash.

Knobs: ``TORCHSNAPSHOT_GPU_GEOREP`` (the remote root, a local path or
``fs://``; unset turns the tier off), ``TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S``
(the daemon's cycle, default 2.0), ``TORCHSNAPSHOT_GPU_GEOREP_BACKLOG``
(pending steps, default 8), ``TORCHSNAPSHOT_GPU_GEOREP_DRAIN_S`` (the
close and preemption drain bound, default 30). Fault-injection sites:
``georep.ship`` and ``georep.apply``. What it ships and restores goes to
the telemetry counters of the JAX package's names and to
:data:`counts`, which counts with the bus off too.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import uuid
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from . import faultinject, telemetry
from .telemetry import flightrec

logger = logging.getLogger(__name__)

GEOREP_ENV_VAR = "TORCHSNAPSHOT_GPU_GEOREP"
INTERVAL_ENV_VAR = "TORCHSNAPSHOT_GPU_GEOREP_INTERVAL_S"
BACKLOG_ENV_VAR = "TORCHSNAPSHOT_GPU_GEOREP_BACKLOG"
DRAIN_ENV_VAR = "TORCHSNAPSHOT_GPU_GEOREP_DRAIN_S"

_DEFAULT_INTERVAL_S = 2.0
_DEFAULT_BACKLOG = 8
_DEFAULT_DRAIN_S = 30.0

#: The durable replication cursor, in the REMOTE step directory.
CURSOR_FNAME = ".georep_cursor.json"

_STEP_RE = re.compile(r"^step_(\d+)$")

counts: "Counter[str]" = Counter()


def _count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``: the telemetry counter and
    :data:`counts`."""
    counts[name] += n
    telemetry.counter_add(name, n)


def count_dr_restore() -> None:
    """Count a restore from a geo-replicated copy (``snapshot.py``)."""
    _count("dr_replica_restores", 1)


def remote_url() -> Optional[str]:
    """The configured remote tier root, or None when the tier is off.
    THE one env check on the disabled path."""
    raw = os.environ.get(GEOREP_ENV_VAR, "").strip()
    return raw.rstrip("/") or None


def interval_s() -> float:
    raw = os.environ.get(INTERVAL_ENV_VAR, "").strip()
    try:
        return max(0.05, float(raw)) if raw else _DEFAULT_INTERVAL_S
    except ValueError:
        return _DEFAULT_INTERVAL_S


def backlog_limit() -> int:
    raw = os.environ.get(BACKLOG_ENV_VAR, "").strip()
    try:
        return max(1, int(raw)) if raw else _DEFAULT_BACKLOG
    except ValueError:
        return _DEFAULT_BACKLOG


def drain_timeout_s() -> float:
    raw = os.environ.get(DRAIN_ENV_VAR, "").strip()
    try:
        return max(0.0, float(raw)) if raw else _DEFAULT_DRAIN_S
    except ValueError:
        return _DEFAULT_DRAIN_S


class GeoRepError(RuntimeError):
    """A replication step that must not be retried blindly (unsupported
    layout, splice refusal). Transient I/O errors stay their own types
    and are retried by the daemon."""


class SpliceRefused(GeoRepError):
    """The remote tier's committed state disagrees with what this
    shipper believes it is extending — a stale generation or a
    non-contiguous offset. The remote is NEVER modified on this path."""


# ------------------------------------------------------ remote tier I/O


class _RemoteTier:
    """One remote step directory. Local filesystem roots get atomic
    writes (temp file, fsync, rename, with journal.py's ``.tmp.``
    naming); plugin-backed roots ride each object write's own atomicity.
    Reads return None for a missing object, the probe the cursor and
    metadata checks are built on."""

    def __init__(self, url: str, storage_options: Optional[Dict[str, Any]] = None):
        from .storage_plugin import local_fs_root, strip_mirror_options

        self.url = url
        opts = dict(strip_mirror_options(storage_options) or {})
        opts.pop("georep_url", None)
        self.storage_options = opts or None
        self.local = local_fs_root(url)
        self._loop = None
        self._plugin = None

    def _ensure_plugin(self):
        if self._plugin is None:
            import asyncio

            from .storage_plugin import url_to_storage_plugin_in_event_loop

            self._loop = asyncio.new_event_loop()
            self._plugin = url_to_storage_plugin_in_event_loop(
                self.url, self._loop, self.storage_options
            )
        return self._plugin, self._loop

    def read(self, rel: str) -> Optional[bytes]:
        if self.local is not None:
            try:
                with open(os.path.join(self.local, rel), "rb") as f:
                    return f.read()
            except OSError:
                return None
        from .io_types import ReadIO

        plugin, loop = self._ensure_plugin()
        read_io = ReadIO(path=rel)
        try:
            loop.run_until_complete(plugin.read(read_io))
            return bytes(read_io.buf)
        except Exception:  # noqa: BLE001 - missing object, backend-specific
            return None

    def write(self, rel: str, buf: bytes) -> None:
        if self.local is not None:
            path = os.path.join(self.local, rel)
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
            with open(tmp, "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return
        from .io_types import WriteIO

        plugin, loop = self._ensure_plugin()
        loop.run_until_complete(plugin.write(WriteIO(path=rel, buf=buf)))

    def append(self, rel: str, existing: bytes, region: bytes) -> None:
        """Extend ``rel`` (verified to currently hold ``existing``) with
        ``region``. Local filesystem roots extend IN PLACE past the
        committed offset: the commit point is the epoch metadata, not
        the segment bytes, so a torn tail here is one that replay
        ignores, and the in-place write
        ships O(epoch) bytes where the atomic-rename dance would re-pay
        the whole segment over the WAN every epoch. Object stores have
        no append, so plugin-backed roots rewrite the object."""
        if self.local is not None:
            path = os.path.join(self.local, rel)
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "r+b" if os.path.exists(path) else "wb") as f:
                f.seek(len(existing))
                f.write(region)
                f.flush()
                os.fsync(f.fileno())
            return
        self.write(rel, existing + region)

    def write_json(self, rel: str, obj: Dict[str, Any]) -> None:
        self.write(rel, json.dumps(obj).encode("utf-8"))

    def read_json(self, rel: str) -> Optional[Dict[str, Any]]:
        raw = self.read(rel)
        if raw is None:
            return None
        try:
            out = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        return out if isinstance(out, dict) else None

    def close(self) -> None:
        if self._plugin is not None:
            try:
                self._plugin.sync_close(self._loop)
            except Exception:  # noqa: BLE001
                pass
            try:
                self._loop.close()
            except Exception:  # noqa: BLE001
                pass
            self._plugin = None
            self._loop = None


# ------------------------------------------------------------- shipping


def _read_cursor(tier: _RemoteTier) -> Optional[Dict[str, Any]]:
    cur = tier.read_json(CURSOR_FNAME)
    if cur is None or "base_step" not in cur or "epoch" not in cur:
        return None
    return cur


def _write_cursor(
    tier: _RemoteTier, base_step: int, epoch: int, gen: Optional[str]
) -> Dict[str, Any]:
    cur = {
        "v": 1,
        "base_step": int(base_step),
        "epoch": int(epoch),
        "gen": gen,
        "wall": round(time.time(), 3),
    }
    tier.write_json(CURSOR_FNAME, cur)
    return cur


def _ship_base(
    primary_path: str,
    tier: _RemoteTier,
    step: int,
    storage_options: Optional[Dict[str, Any]],
) -> int:
    """Consolidate-style copy of one committed snapshot to the remote
    step directory: every payload (origin payloads included — the DR
    copy must not reference snapshots in the region being protected
    against), origins cleared, cursor reset, metadata LAST. Returns
    bytes shipped. Idempotent: payload re-writes carry identical
    content, and the metadata commit point decides."""
    from .dedup import _iter_payload_entries
    from .manifest import ObjectEntry
    from .snapshot import SNAPSHOT_METADATA_FNAME, Snapshot, encode_metadata
    from .storage_plugin import local_fs_root, strip_mirror_options

    opts = dict(strip_mirror_options(storage_options) or {})
    opts.pop("georep_url", None)
    metadata = Snapshot(primary_path, storage_options=opts or None).metadata

    locations: Dict[str, Optional[str]] = {}
    for entry in metadata.manifest.values():
        payloads = list(_iter_payload_entries(entry))
        if isinstance(entry, ObjectEntry):
            payloads.append(entry)
        for p in payloads:
            locations.setdefault(p.location, p.origin)
            if p.origin is None:
                locations[p.location] = None  # prefer the local copy

    shipped = 0
    for location, origin in sorted(locations.items()):
        src_root = local_fs_root(origin or primary_path)
        if src_root is None:
            raise GeoRepError(
                f"geo-replication needs local-filesystem sources; "
                f"{origin or primary_path} is remote"
            )
        with open(os.path.join(src_root, location), "rb") as f:
            buf = f.read()
        tier.write(location, buf)
        shipped += len(buf)

    # The remote copy is self-contained and single-tier: no origins (they
    # name the region being protected against), no mirror, no chained
    # georep settings.
    for entry in metadata.manifest.values():
        for p in _iter_payload_entries(entry):
            p.origin = None
        if isinstance(entry, ObjectEntry):
            entry.origin = None
    metadata.origin_mirrors = None
    metadata.mirror_url = None

    raw = encode_metadata(metadata)
    # Cursor BEFORE metadata: a kill between the two leaves a
    # metadata-less partial the next cycle re-ships; metadata is the
    # remote commit point, same as a take.
    _write_cursor(tier, step, epoch=0, gen=None)
    tier.write(SNAPSHOT_METADATA_FNAME, raw)
    shipped += len(raw)
    return shipped


def _split_epoch_blob(
    blob: bytes, meta: Dict[str, Any], prev: Dict[str, Any]
) -> List[Tuple[int, int, int, bytes]]:
    """Split one epoch blob back into (rank, start, end, region) rows —
    the inverse of ``journal.read_epoch_blob``'s rank-ordered
    concatenation. Raises SpliceRefused when the blob's length does not
    match the metadata's offsets (a truncated or padded frame)."""
    offsets = meta.get("offsets", {})
    prev_offsets = prev.get("offsets", {}) if prev else {}
    rows: List[Tuple[int, int, int, bytes]] = []
    pos = 0
    for rank_key in sorted(offsets, key=int):
        end = int(offsets[rank_key])
        start = int(prev_offsets.get(rank_key, 0))
        if end <= start:
            continue
        region = blob[pos : pos + (end - start)]
        if len(region) != end - start:
            raise SpliceRefused(
                f"epoch {meta.get('epoch')} blob shorter than its "
                f"metadata claims (rank {rank_key})"
            )
        rows.append((int(rank_key), start, end, region))
        pos += end - start
    if pos != len(blob):
        raise SpliceRefused(
            f"epoch {meta.get('epoch')} blob longer than its metadata "
            f"claims ({len(blob) - pos} trailing byte(s))"
        )
    return rows


def _apply_epoch(
    tier: _RemoteTier,
    meta: Dict[str, Any],
    prev_meta: Optional[Dict[str, Any]],
    blob: bytes,
    cursor: Dict[str, Any],
) -> Dict[str, Any]:
    """Verify-then-apply one shipped epoch on the remote tier.

    Order: CRC-verify every record region → extend each rank's segment
    from exactly its previous committed offset (idempotent when the
    bytes already landed) → commit the epoch metadata → advance the
    cursor. Raises SpliceRefused before ANY remote write when the blob,
    the generation chain, or the offsets disagree with the remote's
    committed state."""
    from . import journal

    epoch = int(meta.get("epoch", 0))
    gen = meta.get("gen")

    # Generation chaining: epoch k extends the chain the cursor (or the
    # remote k-1 metadata) names — a diverged primary journal (re-armed,
    # truncated, resurrected) is refused here, before any byte moves.
    if epoch > 1:
        want_prev_gen = (prev_meta or {}).get("gen")
        have_prev_gen = cursor.get("gen")
        if have_prev_gen is None:
            remote_prev = tier.read_json(
                os.path.join(
                    journal.JOURNAL_DIRNAME, journal.epoch_meta_name(epoch - 1)
                )
            )
            have_prev_gen = (remote_prev or {}).get("gen")
        if have_prev_gen != want_prev_gen:
            raise SpliceRefused(
                f"epoch {epoch}: remote chain carries generation "
                f"{have_prev_gen!r} for epoch {epoch - 1}, shipper "
                f"expected {want_prev_gen!r}"
            )

    rows = _split_epoch_blob(blob, meta, prev_meta or {})
    for rank, _start, _end, region in rows:
        records, error = journal.decode_records(memoryview(region))
        if error is not None:
            raise _CrcRejected(
                f"epoch {epoch} rank {rank} region rejected: {error}"
            )
        for header, _payload in records:
            if header.get("gen") != gen:
                raise SpliceRefused(
                    f"epoch {epoch} rank {rank}: record stamped "
                    f"{header.get('gen')!r}, metadata says {gen!r}"
                )

    jdir = journal.JOURNAL_DIRNAME
    for rank, start, end, region in rows:
        seg_rel = os.path.join(jdir, journal.segment_name(rank))
        cur = tier.read(seg_rel) or b""
        if len(cur) == end and cur[start:end] == region:
            continue  # a previous attempt already landed these bytes
        if len(cur) != start:
            raise SpliceRefused(
                f"epoch {epoch} rank {rank}: remote segment holds "
                f"{len(cur)} byte(s), epoch expects to extend from "
                f"{start}"
            )
        tier.append(seg_rel, cur, region)
    # The apply-side fault site: after the segment bytes, BEFORE the
    # metadata commit — kill here leaves bytes past the last committed
    # epoch (a torn tail; replay ignores it), transient/
    # permanent model a remote-tier outage at the commit boundary.
    faultinject.site("georep.apply")
    tier.write_json(os.path.join(jdir, journal.epoch_meta_name(epoch)), meta)
    return _write_cursor(tier, int(cursor["base_step"]), epoch, gen)


class _CrcRejected(GeoRepError):
    """A shipped frame failed record CRC verification remotely. The
    remote was not touched; the next cycle re-reads the blob from the
    intact primary journal and re-ships."""


# ------------------------------------------------------------ the daemon


class GeoReplicator:
    """The rank-0 background shipper: a queue of per-step sync tasks, a
    daemon thread, and the lag/backlog instrumentation. Foreground code
    only ever calls :meth:`enqueue` (cheap, never blocks, never
    raises); the daemon owns all remote I/O."""

    def __init__(
        self,
        remote_root: str,
        *,
        storage_options: Optional[Dict[str, Any]] = None,
        interval: Optional[float] = None,
        backlog: Optional[int] = None,
    ) -> None:
        self.remote_root = remote_root.rstrip("/")
        self.storage_options = storage_options
        self.interval = interval if interval is not None else interval_s()
        self.backlog_limit = backlog if backlog is not None else backlog_limit()
        self._lock = threading.Lock()
        #: step -> (primary_path, oldest un-shipped commit, monotonic)
        self._pending: Dict[int, Tuple[str, float]] = {}
        #: step -> commits enqueued so far. The shipper retires a task
        #: only if no commit arrived while it synced: the timestamp
        #: cannot tell, since coalescing keeps the oldest one.
        self._seq: Dict[int, int] = {}
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = threading.Event()
        self._failures = 0
        self.last_error: Optional[str] = None
        #: step -> cursor dict after the last successful sync
        self._synced: Dict[int, Dict[str, Any]] = {}
        self.dropped_steps = 0
        self._thread = threading.Thread(
            target=self._run, name="tsnap-gpu-georep", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------- foreground edge

    def enqueue(self, primary_path: str, step: int) -> None:
        """Note that ``step`` has new committed state (a base snapshot
        or a journal epoch) and wake the shipper. Coalescing: repeat
        commits to one step fold into one pending task keeping the
        OLDEST timestamp (lag measures the oldest unshipped state).
        Bounded: beyond the backlog limit the oldest steps drop — a
        newer committed base supersedes them as a recovery point."""
        now = telemetry.monotonic()
        with self._lock:
            prev = self._pending.get(step)
            self._pending[step] = (primary_path, prev[1] if prev else now)
            self._seq[step] = self._seq.get(step, 0) + 1
            while len(self._pending) > self.backlog_limit:
                victim = min(self._pending)
                if victim == step and len(self._pending) == 1:
                    break
                self._pending.pop(victim, None)
                self.dropped_steps += 1
                _count("georep_steps_dropped", 1)
            self._idle.clear()
        self._wake.set()

    def lag_s(self) -> float:
        """Age of the oldest committed-but-unreplicated state — the
        remote tier's incremental RPO exposure right now. 0 when the
        remote is caught up."""
        with self._lock:
            if not self._pending:
                return 0.0
            oldest = min(ts for _, ts in self._pending.values())
        return max(0.0, telemetry.monotonic() - oldest)

    def backlog_epochs(self) -> int:
        """Committed-locally-but-unapplied-remotely epochs across the
        pending steps (a pending un-shipped base counts as 1)."""
        from . import journal

        from .storage_plugin import local_fs_root

        with self._lock:
            pending = dict(self._pending)
            synced = {s: dict(c) for s, c in self._synced.items()}
        total = 0
        for step, (path, _ts) in pending.items():
            cur = synced.get(step)
            local = local_fs_root(path)
            committed = 0
            if local is not None:
                jdir = os.path.join(local, journal.JOURNAL_DIRNAME)
                committed = len(
                    journal.committed_epochs(journal.read_epoch_metas(jdir))
                )
            if cur is None:
                total += 1 + committed
            else:
                total += max(0, committed - int(cur.get("epoch", 0)))
        return total

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the backlog is empty (or ``timeout``); returns
        whether the remote is caught up. Close path and preemption's
        grace window both come through here."""
        self._wake.set()
        return self._idle.wait(
            timeout if timeout is not None else drain_timeout_s()
        )

    def close(self, drain_timeout: Optional[float] = None) -> bool:
        drained = self.drain(drain_timeout)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
        self._publish_gauges()
        return drained

    # ---------------------------------------------------- daemon side

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._cycle()
            except Exception:  # noqa: BLE001 - the daemon must survive
                logger.warning("georep cycle failed", exc_info=True)

    def _cycle(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._idle.set()
                    break
                step = min(self._pending)
                path, _ = self._pending[step]
                seq = self._seq.get(step)
            try:
                cursor = self._sync_step(path, step)
            except Exception as e:  # noqa: BLE001
                self._failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                _count("georep_ship_errors", 1)
                logger.warning(
                    "georep: step %d sync failed (attempt %d): %s",
                    step,
                    self._failures,
                    self.last_error,
                )
                flightrec.record(
                    "georep.lag",
                    tier=self.remote_root,
                    backlog_epochs=self.backlog_epochs(),
                    lag_s=round(self.lag_s(), 3),
                    error=self.last_error,
                )
                break  # retry after the next interval tick
            self._failures = 0
            self.last_error = None
            with self._lock:
                self._synced[step] = cursor
                # A commit that raced the sync bumped the step's
                # sequence; only retire the task if nothing new arrived.
                if self._seq.get(step) == seq:
                    self._pending.pop(step, None)
                    self._seq.pop(step, None)
            self._publish_gauges()
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        lag = round(self.lag_s(), 3)
        backlog = self.backlog_epochs()
        telemetry.gauge_set("replication_lag_s", lag)
        telemetry.gauge_set("georep_backlog_epochs", float(backlog))
        # The live health plane: the heartbeat carries the lag.
        telemetry.health.update(georep_lag_s=lag, georep_backlog=backlog)

    def _sync_step(self, primary_path: str, step: int) -> Dict[str, Any]:
        """Bring the remote step directory up to the primary's committed
        state: base if missing, then every committed epoch past the
        cursor. Returns the advanced cursor."""
        from . import journal
        from .snapshot import SNAPSHOT_METADATA_FNAME
        from .storage_plugin import local_fs_root

        local = local_fs_root(primary_path)
        if local is None:
            raise GeoRepError(
                f"geo-replication needs a local-filesystem primary; "
                f"{primary_path} is remote"
            )
        sep = "" if self.remote_root.endswith("/") else "/"
        tier = _RemoteTier(
            f"{self.remote_root}{sep}{os.path.basename(local.rstrip('/'))}",
            self.storage_options,
        )
        try:
            cursor = _read_cursor(tier)
            base_ok = (
                cursor is not None
                and int(cursor.get("base_step", -1)) == step
                and tier.read(SNAPSHOT_METADATA_FNAME) is not None
            )
            if not base_ok:
                t0 = telemetry.monotonic()
                shipped = _ship_base(
                    primary_path, tier, step, self.storage_options
                )
                cursor = {"v": 1, "base_step": step, "epoch": 0, "gen": None}
                _count("georep_bases_shipped", 1)
                _count("georep_bytes_shipped", shipped)
                flightrec.record(
                    "georep.ship",
                    kind="base",
                    step=step,
                    nbytes=shipped,
                    tier=self.remote_root,
                    dur_s=round(telemetry.monotonic() - t0, 3),
                )

            jdir = os.path.join(local, journal.JOURNAL_DIRNAME)
            committed = journal.committed_epochs(journal.read_epoch_metas(jdir))
            assert cursor is not None
            applied = int(cursor.get("epoch", 0))
            for idx, meta in enumerate(committed):
                epoch = int(meta.get("epoch", 0))
                if epoch <= applied:
                    continue
                prev_meta = committed[idx - 1] if idx else None
                # Exactly-once across shipper deaths: a previous
                # incarnation may have committed this epoch remotely and
                # died before the cursor write — probe and advance.
                remote_meta = tier.read_json(
                    os.path.join(
                        journal.JOURNAL_DIRNAME, journal.epoch_meta_name(epoch)
                    )
                )
                if remote_meta is not None and remote_meta.get("gen") == meta.get("gen"):
                    cursor = _write_cursor(
                        tier, step, epoch, meta.get("gen")
                    )
                    continue
                blob = journal.read_epoch_blob(jdir, committed, epoch)
                # THE ship-side fault site: the framed records as they
                # leave the primary region. CRCs were computed at append
                # time, so injected corruption is applier-detectable;
                # kill is the shipper-death-mid-ship drill.
                out = bytes(faultinject.mutate("georep.ship", bytearray(blob)))
                try:
                    cursor = _apply_epoch(tier, meta, prev_meta, out, cursor)
                except _CrcRejected as e:
                    _count("georep_frames_rejected", 1)
                    flightrec.record(
                        "georep.apply",
                        epoch=epoch,
                        ok=False,
                        tier=self.remote_root,
                        error=str(e),
                    )
                    raise
                except SpliceRefused:
                    _count("georep_splice_refusals", 1)
                    raise
                _count("georep_epochs_shipped", 1)
                _count("georep_bytes_shipped", len(blob))
                flightrec.record(
                    "georep.apply",
                    epoch=epoch,
                    ok=True,
                    gen=meta.get("gen"),
                    nbytes=len(blob),
                    tier=self.remote_root,
                )
            return cursor
        finally:
            tier.close()


# --------------------------------------------------------------- status


def latest_committed_step(root: str) -> Optional[int]:
    """Newest committed step directory under a local root, else None."""
    from .snapshot import SNAPSHOT_METADATA_FNAME
    from .storage_plugin import local_fs_root

    local = local_fs_root(root)
    if local is None or not os.path.isdir(local):
        return None
    steps = []
    for name in os.listdir(local):
        m = _STEP_RE.match(name)
        if m and os.path.isfile(
            os.path.join(local, name, SNAPSHOT_METADATA_FNAME)
        ):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def read_cursor(
    remote_step_url: str, storage_options: Optional[Dict[str, Any]] = None
) -> Optional[Dict[str, Any]]:
    """The durable replication cursor of one remote step directory."""
    tier = _RemoteTier(remote_step_url, storage_options)
    try:
        return _read_cursor(tier)
    finally:
        tier.close()


def status(
    root: str,
    remote_root: Optional[str] = None,
    storage_options: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One replication-plane report: the primary's
    committed state vs the remote cursor, backlog in epochs, and the
    measured lag (age of the oldest unreplicated commit — the RPO
    exposure a region loss right now would add)."""
    from . import journal
    from .storage_plugin import local_fs_root

    remote = remote_root.rstrip("/") if remote_root else remote_url()
    out: Dict[str, Any] = {
        "root": root,
        "remote": remote,
        "enabled": remote is not None,
    }
    step = latest_committed_step(root)
    out["step"] = step
    if step is None or remote is None:
        out["backlog_epochs"] = None
        out["lag_s"] = None
        return out
    local = local_fs_root(root)
    assert local is not None
    step_name = f"step_{step:010d}"
    step_dir = os.path.join(local, step_name)
    jdir = os.path.join(step_dir, journal.JOURNAL_DIRNAME)
    committed = journal.committed_epochs(journal.read_epoch_metas(jdir))
    out["local_epochs"] = len(committed)
    out["local_gen"] = committed[-1].get("gen") if committed else None

    sep = "" if remote.endswith("/") else "/"
    cursor = read_cursor(f"{remote}{sep}{step_name}", storage_options)
    out["cursor"] = cursor
    if cursor is None or int(cursor.get("base_step", -1)) != step:
        out["base_replicated"] = False
        out["backlog_epochs"] = 1 + len(committed)
        commit_walls = [os.path.getmtime(os.path.join(step_dir, ".snapshot_metadata"))]
    else:
        out["base_replicated"] = True
        applied = int(cursor.get("epoch", 0))
        out["applied_epoch"] = applied
        out["applied_gen"] = cursor.get("gen")
        out["backlog_epochs"] = max(0, len(committed) - applied)
        commit_walls = [
            os.path.getmtime(
                os.path.join(jdir, journal.epoch_meta_name(int(m["epoch"])))
            )
            for m in committed
            if int(m.get("epoch", 0)) > applied
            and os.path.exists(
                os.path.join(jdir, journal.epoch_meta_name(int(m["epoch"])))
            )
        ]
    out["lag_s"] = (
        round(max(0.0, time.time() - min(commit_walls)), 3)
        if out["backlog_epochs"] and commit_walls
        else 0.0
    )
    return out
