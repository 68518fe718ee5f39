"""Crash-consistent delta journaling between full snapshots.

Counterpart of ``torchsnapshot_tpu/journal.py``; its record, its segment
layout and its epoch metadata are the JAX package's, byte for byte, so a
journal written by either package replays in the other.

Between the manager's full snapshots, ``CheckpointManager.journal_step``
finds the state leaves that changed since the last durable state by their
fingerprints (``device_digest.fingerprint_all``: K4 for every CUDA leaf,
all dispatched before one fetch) and appends them as fenced, CRC32C'd,
generation-stamped records to a per-rank O_APPEND segment under the
committed base snapshot (``<base>/.journal/rank_<r>.seg``). A restore is
the base plus a bounded replay: :func:`maybe_replay` folds the committed
epochs onto the restored state, so a crash loses at most one journal epoch
instead of a whole save cadence.

Crash consistency:

- A record is ``TSJR | u32 header_len | header JSON | u32 header_crc |
  payload | u32 payload_crc`` with the CRC32C of ``integrity.py``; a torn
  tail or a flipped bit is detected, never replayed.
- An epoch commits under a fence, metadata last: rank 0 plants
  ``.journal/.fence`` with a fresh generation, every rank appends records
  stamped with it and fsyncs, and after a gather of every rank's end
  offset rank 0 re-checks the fence and publishes ``epoch_<n>.json``
  (temp file and rename). A resurrected straggler's records carry a
  generation no epoch names, and replay skips them.
- Replay verifies, then applies: every record of the committed region is
  parsed and CRC-checked first, the ranks agree on one verdict, and the
  state changes only if every rank's chain checks out; otherwise the base
  stands. Bytes past the last committed offset are truncated, counted and
  never replayed.

A record holds a whole leaf. A tensor's payload is its bytes in the
snapshot format's dtype names (``bfloat16`` for bf16, written from the
tensor's bytes, as the JAX package writes an ml_dtypes array); a CUDA leaf
is copied to the host for its record and replayed onto its device, in
place when shape and dtype agree. A numpy leaf journals as an array too.
A DTensor leaf raises (the JAX package gathers a sharded array whole,
which a process-sharded DTensor cannot do). The journal needs a shared
local filesystem root; on remote roots journaling is off.

Env: ``TORCHSNAPSHOT_GPU_JOURNAL=1`` turns journaling on;
``TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES`` (default 1 GiB) and
``TORCHSNAPSHOT_GPU_JOURNAL_MAX_EPOCHS`` (default 64) bound an epoch's
payload and the chain's length: past either, ``JournalLimitError``, which
the manager turns into a full save. Fault-injection sites:
``journal.append`` and ``journal.replay``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faultinject, telemetry
from ._native import crc32c
from .device_digest import fingerprint_all
from .flatten import flatten, inflate
from .serialization import (
    dtype_to_string,
    object_as_bytes,
    object_from_bytes,
    tensor_as_memoryview,
    tensor_from_buffer,
)
from .stateful import AppState
from .storage_plugin import local_fs_root
from .telemetry import flightrec

logger = logging.getLogger(__name__)

JOURNAL_ENV_VAR = "TORCHSNAPSHOT_GPU_JOURNAL"
EPOCH_BYTES_ENV_VAR = "TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES"
MAX_EPOCHS_ENV_VAR = "TORCHSNAPSHOT_GPU_JOURNAL_MAX_EPOCHS"

JOURNAL_DIRNAME = ".journal"
FENCE_FNAME = ".fence"

_MAGIC = b"TSJR"
_U32 = struct.Struct("<I")
_SEGMENT_RE = re.compile(r"^rank_(\d+)\.seg$")
_EPOCH_META_RE = re.compile(r"^epoch_(\d{6})\.json$")

DEFAULT_EPOCH_BYTES = 1 << 30
DEFAULT_MAX_EPOCHS = 64


class JournalError(RuntimeError):
    """A journal epoch failed to append or commit."""


class JournalLimitError(JournalError):
    """An epoch would exceed the configured bounds; the caller should take
    a full snapshot instead (CheckpointManager does)."""


def enabled_by_env() -> bool:
    return os.environ.get(JOURNAL_ENV_VAR, "0") not in ("0", "", "false")


def epoch_bytes_cap() -> int:
    try:
        return int(os.environ.get(EPOCH_BYTES_ENV_VAR, DEFAULT_EPOCH_BYTES))
    except ValueError:
        return DEFAULT_EPOCH_BYTES


def max_epochs() -> int:
    try:
        return int(os.environ.get(MAX_EPOCHS_ENV_VAR, DEFAULT_MAX_EPOCHS))
    except ValueError:
        return DEFAULT_MAX_EPOCHS


def segment_name(rank: int) -> str:
    return f"rank_{rank}.seg"


def epoch_meta_name(epoch: int) -> str:
    return f"epoch_{epoch:06d}.json"


# --------------------------------------------------------------- record layer


def encode_record(header: Dict[str, Any], payload: memoryview) -> bytes:
    """Frame one record. Both CRCs cover the true bytes, computed before
    any fault-injection mutation downstream, so an injected corruption is
    detected as bit rot would be."""
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    return b"".join(
        (_MAGIC, _U32.pack(len(hdr)), hdr, _U32.pack(crc32c(hdr)), payload,
         _U32.pack(crc32c(payload)))
    )


def _decode_one(buf: memoryview, off: int) -> Tuple[Dict[str, Any], memoryview, int]:
    """Decode the record at ``off``: (header, payload, next offset).
    ValueError on a malformed or corrupt frame, EOFError when the buffer
    ends mid-record."""
    end = len(buf)
    if off + 12 > end:
        raise EOFError("torn record header")
    if bytes(buf[off : off + 4]) != _MAGIC:
        raise ValueError(f"bad record magic at offset {off}")
    (hlen,) = _U32.unpack(buf[off + 4 : off + 8])
    hdr_start = off + 8
    hdr_end = hdr_start + hlen
    if hdr_end + 4 > end:
        raise EOFError("torn record header")
    hdr_bytes = bytes(buf[hdr_start:hdr_end])
    (hcrc,) = _U32.unpack(buf[hdr_end : hdr_end + 4])
    if crc32c(hdr_bytes) != hcrc:
        raise ValueError(f"record header CRC mismatch at offset {off}")
    try:
        header = json.loads(hdr_bytes.decode("utf-8"))
        nbytes = int(header["nbytes"])
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise ValueError(f"undecodable record header at offset {off}: {e}")
    p_start = hdr_end + 4
    p_end = p_start + nbytes
    if p_end + 4 > end:
        raise EOFError("torn record payload")
    payload = buf[p_start:p_end]
    (pcrc,) = _U32.unpack(buf[p_end : p_end + 4])
    # The replay-side injection site sits between the read and the check,
    # so an injected mutation meets the CRC that catches real corruption.
    payload = memoryview(bytes(faultinject.mutate("journal.replay", payload)))
    if len(payload) != nbytes or crc32c(payload) != pcrc:
        raise ValueError(f"record payload CRC mismatch at offset {off}")
    return header, payload, p_end + 4


def scan_segment(
    path: str, limit: Optional[int] = None
) -> Tuple[List[Tuple[Dict[str, Any], memoryview]], Optional[str]]:
    """Parse a segment's records up to ``limit`` bytes (the committed
    offset): (records, error), error None on a clean parse. Bytes past
    ``limit`` are never read."""
    try:
        with open(path, "rb") as f:
            data = f.read() if limit is None else f.read(limit)
    except OSError as e:
        return [], f"unreadable segment: {e}"
    if limit is not None and len(data) < limit:
        return [], f"segment shorter than committed offset ({len(data)} < {limit})"
    return decode_records(memoryview(data))


def decode_records(
    buf: memoryview,
) -> Tuple[List[Tuple[Dict[str, Any], memoryview]], Optional[str]]:
    """Parse TSJR records from a buffer: the segment scan and the
    geo-replication apply, which receives epoch regions verbatim. On a
    non-None error the caller applies nothing."""
    records: List[Tuple[Dict[str, Any], memoryview]] = []
    off = 0
    while off < len(buf):
        try:
            header, payload, off = _decode_one(buf, off)
        except EOFError:
            return records, f"torn record at offset {off}"
        except ValueError as e:
            return records, str(e)
        records.append((header, payload))
    return records, None


# ---------------------------------------------------------------- epoch layer


def read_epoch_metas(jdir: str) -> List[Dict[str, Any]]:
    """Every parseable epoch metadata file, by epoch number."""
    metas = []
    try:
        names = os.listdir(jdir)
    except OSError:
        return []
    for name in sorted(names):
        if not _EPOCH_META_RE.match(name):
            continue
        try:
            with open(os.path.join(jdir, name), "r") as f:
                metas.append(json.load(f))
        except (OSError, ValueError):
            continue
    metas.sort(key=lambda m: m.get("epoch", 0))
    return metas


def committed_epochs(metas: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The contiguous committed prefix (epochs 1..k): epochs past a gap
    never committed on the surviving chain and are never replayed."""
    out = []
    want = 1
    for meta in metas:
        if meta.get("epoch") != want:
            break
        out.append(meta)
        want += 1
    return out


def collect_rank_updates(
    jdir: str, rank: int, committed: List[Dict[str, Any]]
) -> Tuple[Dict[str, Tuple[Dict[str, Any], memoryview]], Optional[str], int]:
    """The last committed value of each key in one rank's segment:
    (updates, error, tail_bytes). ``error`` is non-None when the committed
    region does not parse or verify (the caller keeps the base);
    ``tail_bytes`` counts bytes past the last committed offset. Records of
    a generation no committed epoch names are skipped."""
    seg = os.path.join(jdir, segment_name(rank))
    if not committed:
        return {}, None, 0
    offsets = committed[-1].get("offsets", {})
    if str(rank) not in offsets:
        return {}, f"no committed offset for rank {rank}", 0
    limit = int(offsets[str(rank)])
    if not os.path.exists(seg):
        if limit == 0:
            return {}, None, 0
        return {}, f"missing segment {segment_name(rank)}", 0
    records, error = scan_segment(seg, limit)
    if error is not None:
        return {}, error, 0
    gens = {m.get("gen") for m in committed}
    updates: Dict[str, Tuple[Dict[str, Any], memoryview]] = {}
    for header, payload in records:
        if header.get("gen") not in gens:
            continue  # a fenced-off straggler's record
        updates[header["key"]] = (header, payload)
    try:
        tail = max(0, os.path.getsize(seg) - limit)
    except OSError:
        tail = 0
    return updates, None, tail


def read_epoch_blob(jdir: str, committed: List[Dict[str, Any]], epoch: int) -> bytes:
    """One committed epoch's record bytes across all ranks, read verbatim
    from the segments in rank order: rank r's region is
    ``segment[prev.offsets[r] : meta.offsets[r]]``. ValueError when the
    epoch is not committed or a segment is short."""
    idx = next((i for i, m in enumerate(committed) if m.get("epoch") == epoch), None)
    if idx is None:
        raise ValueError(f"epoch {epoch} is not committed")
    offsets = committed[idx].get("offsets", {})
    prev_offsets = committed[idx - 1].get("offsets", {}) if idx else {}
    parts: List[bytes] = []
    for rank_key in sorted(offsets, key=int):
        end = int(offsets[rank_key])
        start = int(prev_offsets.get(rank_key, 0))
        if end <= start:
            continue
        seg = os.path.join(jdir, segment_name(int(rank_key)))
        try:
            with open(seg, "rb") as f:
                f.seek(start)
                part = f.read(end - start)
        except OSError as e:
            raise ValueError(f"unreadable segment for rank {rank_key}: {e}")
        if len(part) != end - start:
            raise ValueError(f"segment for rank {rank_key} shorter than committed offset")
        parts.append(part)
    return b"".join(parts)


def _write_json_atomic(path: str, obj: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _serialize_leaf(value: Any, kind: str) -> Tuple[Dict[str, Any], memoryview]:
    """(header fields, payload) of one dirty leaf. A tensor's payload is
    its bytes on the host (a CUDA leaf is copied down) under the snapshot
    format's dtype name; a numpy array goes through torch for the same
    names."""
    if kind == "array":
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        t = value.detach().cpu().contiguous()
        payload = tensor_as_memoryview(t)
        return (
            {"kind": "array", "dtype": dtype_to_string(t.dtype), "shape": list(t.shape),
             "nbytes": len(payload)},
            payload,
        )
    buf = object_as_bytes(value)
    return {"kind": "object", "nbytes": len(buf)}, memoryview(buf)


def _materialize_leaf(header: Dict[str, Any], payload: memoryview, like: Any) -> Any:
    """A leaf value from a committed record, of the kind of the leaf it
    replaces: a tensor replays onto ``like``'s device, in place when shape
    and dtype agree (a CUDA leaf stays on its card, a CPU run never touches
    CUDA); numpy in, numpy out; otherwise a CPU tensor."""
    if header.get("kind") == "object":
        return object_from_bytes(payload)
    t = tensor_from_buffer(bytearray(payload), header["dtype"], header["shape"])
    if isinstance(like, torch.Tensor):
        if like.shape == t.shape and like.dtype == t.dtype and like.is_contiguous():
            with torch.no_grad():
                like.copy_(t)
            return like
        return t.to(like.device)
    if isinstance(like, np.ndarray) and t.dtype != torch.bfloat16:
        return t.numpy()
    return t


# -------------------------------------------------------------- commit hooks
#
# Observers (the geo-replication shipper) register to be woken when an
# epoch commits. Hooks run on rank 0 after the commit broadcast, and are
# exception-isolated: a broken observer never fails a committed save.

_COMMIT_HOOKS: List[Callable[[str, int, int], None]] = []


def register_commit_hook(hook: Callable[[str, int, int], None]) -> None:
    """Run ``hook(base_dir, base_step, epoch)`` on rank 0 after every
    committed epoch. Idempotent per hook object."""
    if hook not in _COMMIT_HOOKS:
        _COMMIT_HOOKS.append(hook)


def unregister_commit_hook(hook: Callable[[str, int, int], None]) -> None:
    if hook in _COMMIT_HOOKS:
        _COMMIT_HOOKS.remove(hook)


def _fire_commit_hooks(base_dir: str, base_step: int, epoch: int) -> None:
    for hook in list(_COMMIT_HOOKS):
        try:
            hook(base_dir, base_step, epoch)
        except Exception as e:  # noqa: BLE001 - observers never fail a commit
            logger.warning("journal commit hook %r failed: %s", hook, e)


def _leaves(app_state: AppState) -> Dict[str, Any]:
    """{logical path: leaf} of every key of ``app_state``."""
    leaves: Dict[str, Any] = {}
    for key, stateful in app_state.items():
        leaves.update(flatten(stateful.state_dict(), prefix=key)[1])
    return leaves


# -------------------------------------------------------------- DeltaJournal


class DeltaJournal:
    """The writer: the fingerprint baseline and the fenced epoch append,
    bound to one committed base snapshot directory."""

    def __init__(self, base_dir: str, *, base_step: int = -1, rank: int = 0) -> None:
        self.base_dir = base_dir
        self.base_step = base_step
        self.rank = rank
        self.dir = os.path.join(base_dir, JOURNAL_DIRNAME)
        self.epoch = 0  # last committed epoch
        self.last_bytes = 0  # payload bytes this rank appended in that epoch
        self._baseline: Dict[str, str] = {}
        self._armed = False

    @property
    def armed(self) -> bool:
        return self._armed

    def capture_baseline(self, app_state: AppState) -> None:
        """Fingerprint every leaf as of the base snapshot. Runs at save
        time on the state as saved: a capture at the first journal_step
        would lose any change in between."""
        leaves = _leaves(app_state)
        fps = fingerprint_all(list(leaves.values()))
        self._baseline = {path: fp for path, (fp, _kind) in zip(leaves, fps)}
        self._armed = True

    # -- the fenced epoch append -------------------------------------------

    def _pending_deltas(
        self, app_state: AppState
    ) -> List[Tuple[str, Dict[str, Any], memoryview, str]]:
        """(key, header fields, payload, fingerprint) of each dirty leaf."""
        leaves = _leaves(app_state)
        pending = []
        for (path, leaf), (fp, kind) in zip(leaves.items(), fingerprint_all(list(leaves.values()))):
            if self._baseline.get(path) == fp:
                continue
            fields, payload = _serialize_leaf(leaf, kind)
            pending.append((path, fields, payload, fp))
        return pending

    def append_epoch(self, app_state: AppState, *, pg_wrapper: Any = None) -> int:
        """Append the dirty leaves as one fenced, committed epoch; collective
        when ``pg_wrapper`` spans ranks. Returns this rank's record count.
        Raises JournalLimitError on every rank or none when the epoch would
        exceed the bounds, and JournalError when a rank fails to append or
        the fence was usurped."""
        if not self._armed:
            raise JournalError("journal has no captured baseline")
        world = pg_wrapper.get_world_size() if pg_wrapper is not None else 1
        pending = self._pending_deltas(app_state)
        local_bytes = sum(len(p) for _, _, p, _ in pending)
        epoch = self.epoch + 1

        if world > 1:
            gen0 = uuid.uuid4().hex if self.rank == 0 else None
            gathered = pg_wrapper.all_gather_object((gen0, local_bytes))
            gen = gathered[0][0]
            total_bytes = sum(b for _, b in gathered)
        else:
            gen = uuid.uuid4().hex
            total_bytes = local_bytes

        # Cross-rank totals and the agreed epoch: every rank raises, or none.
        if total_bytes > epoch_bytes_cap():
            raise JournalLimitError(
                f"epoch {epoch} would append {total_bytes} bytes "
                f"(> {epoch_bytes_cap()}); take a full snapshot"
            )
        if epoch > max_epochs():
            raise JournalLimitError(
                f"journal chain reached {max_epochs()} epochs; take a full snapshot"
            )

        recorder = telemetry.begin_op("journal", self.rank)
        try:
            n = self._append_epoch_fenced(epoch, gen, pending, pg_wrapper, world)
        except BaseException:
            recorder.abandon()
            raise
        recorder.finish(extra={"journal_epoch": epoch})

        self.epoch = epoch
        self.last_bytes = local_bytes
        for path, _fields, _payload, fp in pending:
            self._baseline[path] = fp
        if self.rank == 0:
            _fire_commit_hooks(self.base_dir, self.base_step, epoch)
        return n

    def _append_epoch_fenced(
        self,
        epoch: int,
        gen: str,
        pending: List[Tuple[str, Dict[str, Any], memoryview, str]],
        pg_wrapper: Any,
        world: int,
    ) -> int:
        # Phase 1: rank 0 plants the epoch fence; the broadcast is the
        # barrier.
        fence_path = os.path.join(self.dir, FENCE_FNAME)
        fence_err: Optional[str] = None
        if self.rank == 0:
            try:
                os.makedirs(self.dir, exist_ok=True)
                _write_json_atomic(fence_path, {"gen": gen, "epoch": epoch})
                flightrec.record("journal.open", gen=gen, epoch=epoch)
            except OSError as e:
                fence_err = str(e)
        if world > 1:
            fence_err = pg_wrapper.broadcast_object(fence_err)
        if fence_err is not None:
            raise JournalError(f"journal fence plant failed: {fence_err}")

        # Phase 2: every rank appends and fsyncs; a failure rides the
        # offset gather, so no rank deserts the collective.
        append_err: Optional[str] = None
        end_offset = 0
        n_records = 0
        try:
            end_offset, n_records = self._append_records(epoch, gen, pending)
        except OSError as e:
            # Injected faults too: the injector raises OSError subclasses.
            append_err = str(e)

        if world > 1:
            ends = pg_wrapper.all_gather_object((self.rank, append_err, end_offset, n_records))
        else:
            ends = [(self.rank, append_err, end_offset, n_records)]
        failed = [(r, e) for r, e, _, _ in ends if e is not None]
        if failed:
            if self.rank == 0:
                try:
                    os.unlink(fence_path)
                except OSError:
                    pass
            raise JournalError(f"journal append failed on rank(s) {failed}")

        # Phase 3: rank 0 re-checks the fence (a resurrected straggler
        # that re-planted it means these records must not commit), then
        # publishes the epoch metadata, last.
        commit_err: Optional[str] = None
        if self.rank == 0:
            try:
                with open(fence_path, "r") as f:
                    found = json.load(f).get("gen")
                if found != gen:
                    raise JournalError(
                        f"journal fence usurped (planted {gen}, found {found}); "
                        "stale epoch abandoned"
                    )
                meta = {
                    "epoch": epoch,
                    "gen": gen,
                    "world_size": world,
                    "offsets": {str(r): o for r, _, o, _ in ends},
                    "records": {str(r): c for r, _, _, c in ends},
                }
                _write_json_atomic(os.path.join(self.dir, epoch_meta_name(epoch)), meta)
                _fsync_dir(self.dir)
                os.unlink(fence_path)
                flightrec.record("journal.commit", gen=gen, epoch=epoch,
                                 records=sum(c for _, _, _, c in ends))
            except (OSError, ValueError, JournalError) as e:
                commit_err = str(e)
        if world > 1:
            commit_err = pg_wrapper.broadcast_object(commit_err)
        if commit_err is not None:
            raise JournalError(f"journal epoch commit failed: {commit_err}")
        return n_records

    def _append_records(
        self,
        epoch: int,
        gen: str,
        pending: List[Tuple[str, Dict[str, Any], memoryview, str]],
    ) -> Tuple[int, int]:
        seg = os.path.join(self.dir, segment_name(self.rank))
        fd = os.open(seg, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            for key, fields, payload, _fp in pending:
                header = {"v": 1, "gen": gen, "epoch": epoch, "key": key}
                header.update(fields)
                encoded = encode_record(header, payload)
                # The injection site splits the write: a kill leaves the
                # frame's prefix on disk, a torn record.
                os.write(fd, encoded[:8])
                os.write(fd, faultinject.mutate("journal.append", encoded[8:]))
                telemetry.counter_add("journal_appends", 1)
                telemetry.counter_add("journal_bytes", len(payload))
            os.fsync(fd)
            end = os.lseek(fd, 0, os.SEEK_END)
        finally:
            os.close(fd)
        return end, len(pending)


# -------------------------------------------------------------------- replay


def maybe_replay(
    path: str,
    app_state: AppState,
    *,
    pg_wrapper: Any = None,
    base_ok: bool = True,
) -> Dict[str, Any]:
    """Fold the committed epochs onto a just-restored ``app_state``.

    Called at one fixed point of every rank's restore. Never raises: any
    inconsistency (a corrupt record, a missing segment, a peer's failed
    base restore) logs a warning and leaves the base state. All records
    are verified before any state changes, and one cross-rank verdict
    gather makes every rank replay or none.

    Returns {"applied", "epochs", "records", "truncated_bytes"}."""
    out = {"applied": False, "epochs": 0, "records": 0, "truncated_bytes": 0}
    local_dir = local_fs_root(path)
    if local_dir is None:
        return out
    jdir = os.path.join(local_dir, JOURNAL_DIRNAME)
    # Shared filesystem: the directory and its metadata look the same on
    # every rank, so these early returns need no gather.
    if not os.path.isdir(jdir):
        return out
    committed = committed_epochs(read_epoch_metas(jdir))
    if not committed:
        return out
    rank = pg_wrapper.get_rank() if pg_wrapper is not None else 0
    world = pg_wrapper.get_world_size() if pg_wrapper is not None else 1
    meta_world = committed[-1].get("world_size")
    if meta_world != world:
        logger.warning(
            "journal at %s was written by world size %s; restoring with %s: skipping replay",
            jdir, meta_world, world,
        )
        return out

    updates, error, tail = collect_rank_updates(jdir, rank, committed)
    ok = base_ok and error is None
    all_ok = all(pg_wrapper.all_gather_object(ok)) if world > 1 else ok

    # Bytes past the committed offset are uncommitted by definition:
    # truncate them, but only when this rank's committed region parsed
    # clean (a corrupt segment stays as evidence).
    if error is None and tail > 0:
        seg = os.path.join(jdir, segment_name(rank))
        try:
            os.truncate(seg, int(committed[-1]["offsets"][str(rank)]))
            telemetry.counter_add("journal_truncations", 1)
            out["truncated_bytes"] = tail
            logger.warning("journal: truncated %d torn/uncommitted tail byte(s) from %s",
                           tail, seg)
        except OSError:
            pass

    if not all_ok:
        logger.warning(
            "journal replay skipped at %s (local: %s); state falls back to the base snapshot",
            jdir, error or ("base restore failed" if not base_ok else "peer rank failed"),
        )
        return out

    if updates:
        _apply_updates(app_state, updates)
    out["applied"] = True
    out["epochs"] = len(committed)
    out["records"] = len(updates)
    telemetry.counter_add("journal_replays", 1)
    flightrec.record("journal.replay", gen=committed[-1].get("gen"), epochs=len(committed),
                     records=len(updates), truncated=out["truncated_bytes"])
    return out


def _apply_updates(
    app_state: AppState, updates: Dict[str, Tuple[Dict[str, Any], memoryview]]
) -> None:
    for key, stateful in app_state.items():
        prefix = key + "/"
        mine = {k: v for k, v in updates.items() if k == key or k.startswith(prefix)}
        if not mine:
            continue
        dest = stateful.state_dict()
        manifest, flattened = flatten(dest, prefix=key)
        for flat_key, (header, payload) in mine.items():
            flattened[flat_key] = _materialize_leaf(header, payload, flattened.get(flat_key))
        stateful.load_state_dict(inflate(manifest, flattened, prefix=key, dest=dest))
