"""Command-line snapshot inspection and maintenance (cli.py of the JAX
package).

``python -m torchsnapshot_tpu_torch <command> <path> [...]``

Every command reads files or a store and touches no device, so ``fsck``
runs on a storage host with no card. The commands, their flags, their
text and their exit codes are the JAX package's; the env names in the
hints carry the port's prefix (``TORCHSNAPSHOT_GPU_``):

- ``info``     — version, world size, entry counts, payload bytes.
- ``ls``       — one line per logical entry: type, dtype/shape, size.
- ``cat``      — print one entry via ``Snapshot.read_object``.
- ``verify``   — re-hash every payload against its recorded checksum
  (end-to-end CRC32C integrity, see integrity.py).
- ``fsck``     — full consistency check: manifest<->payload existence/
  size/CRC agreement, incremental-chain (deps) integrity, orphan and
  partial-commit detection, and delta-journal integrity (torn tails,
  orphan epochs, corrupt committed records; internal artifact dirs are
  recognized via ``INTERNAL_ARTIFACTS``, one registry); ``--repair``
  quarantines orphans and truncates torn journal tails under
  ``.fsck_quarantine/``. Exit codes: 0 clean, 1 findings, 2 cannot-check
  (see docs/source/fault_tolerance.rst).
- ``migrate``  — convert a reference-format (pytorch/torchsnapshot)
  snapshot to native format (tricks/torchsnapshot_interop.py).
- ``consolidate`` — materialize an incremental snapshot as a
  self-contained one so its base snapshots can be deleted (dedup.py).
- ``diff``     — compare two snapshots leaf by leaf (added/removed/
  changed/unchanged) using recorded content digests where available,
  falling back to checksum then shape/dtype.
- ``deps``     — scan a directory of snapshots and print the incremental
  origin graph: which snapshots reference which bases, and which are
  safe to delete (referenced by no other snapshot in the directory).
- ``prune``    — retention: keep the newest N snapshots in a directory,
  delete the rest EXCEPT bases that kept snapshots still reference.
  Prints the plan; ``--yes`` executes it (local filesystem only).
- ``stats``    — render the telemetry summary a take persisted next to
  ``.snapshot_metadata`` (phase walls, per-rank counters, fleet skew;
  see telemetry/ and docs/source/telemetry.rst). Answers "why was this
  take slow?" after the process is gone. ``--trend`` renders the
  checkpoint history journal of a ROOT directory and exits non-zero on
  a p50 regression; ``--openmetrics`` emits the summary in OpenMetrics
  text format for scrape pipelines.
- ``explain``  — critical-path attribution of a take/restore
  (telemetry/critpath.py): which resource (staging copy, hash, storage
  write/read, decode, collective wait) bound the wall clock, on which
  rank, at what measured rate, and what to tune. Exit code 1 means
  storage-bound, 0 pipeline-bound — benches assert the ROADMAP claim
  with it.
- ``plan``     — dry-run the minimal-movement reshard plan (reshard.py)
  for restoring under a different layout at a different world size:
  per-entry and total storage bytes (planned vs direct) and
  peer-channel bundle bytes, from manifest geometry alone.
- ``blackbox`` — merge the per-rank flight-recorder dumps an aborted
  operation left under ``<snapshot>/.flight/`` into one causal
  cross-rank timeline: who deserted whom at which barrier, store
  failovers with epochs, refused (stale) commits with generations
  (telemetry/flightrec.py; always on by default).
- ``watch``    — live fleet view of an in-flight take/restore from the
  heartbeat keys every rank publishes through the coordination store:
  per-rank phase/bytes/ETA, stalled-rank flags, and skew — visible
  BEFORE the barrier timeout turns a stall into an abort.
- ``store-status`` — probe a live coordination-store node (leader or
  standby): role, epoch, op-log position, per-replica lag and lease age
  (dist_store replication tier; docs/source/fault_tolerance.rst).

- ``georep-status`` — the geo-replication plane of a snapshot ROOT:
  remote cursor position, last applied generation, backlog epochs and
  measured lag (georep.py; docs/source/fault_tolerance.rst,
  "Cross-region disaster recovery").
- ``lint``     — the tsalint static analyzer (``analysis/``) over this
  package: exit 0 clean, 1 findings, 2 usage; see
  docs/source/utilities_torch.rst.

The inspection commands (``info``/``ls``/``cat``/``verify``) and
``consolidate`` work over any registered storage backend (fs://, s3://,
gs://) because they reuse the plugin layer; plain paths mean fs.
``migrate`` reads the reference format from the local filesystem only.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .analysis import runner as analysis_runner
from .integrity import IntegrityError, verify_checksum
from .io_types import ReadIO
from .journal import JOURNAL_DIRNAME
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    is_container_entry,
)
from .serialization import array_size_bytes


def _array_nbytes(entry: ArrayEntry) -> Optional[int]:
    if entry.byte_range is not None:
        return entry.byte_range[1] - entry.byte_range[0]
    try:
        return array_size_bytes(entry.shape, entry.dtype)
    except ValueError:
        return None


def _entry_payloads_ex(
    entry: Entry,
) -> List[
    Tuple[
        str,
        Optional[List[int]],
        Optional[str],
        Optional[int],
        Optional[str],
        Optional[str],
    ]
]:
    """(location, byte_range, checksum, nbytes, origin, codec) per payload
    the entry owns. ``origin`` is the base snapshot holding the bytes when
    the entry was deduplicated by an incremental take; ``codec`` the
    compression codec (stored size != ``nbytes`` when set)."""
    if isinstance(entry, ArrayEntry):
        return [
            (entry.location, entry.byte_range, entry.checksum,
             _array_nbytes(entry), entry.origin, entry.codec)
        ]
    if isinstance(entry, ChunkedArrayEntry):
        return [
            (c.array.location, c.array.byte_range, c.array.checksum,
             _array_nbytes(c.array), c.array.origin, c.array.codec)
            for c in entry.chunks
        ]
    if isinstance(entry, ShardedArrayEntry):
        return [
            (s.array.location, s.array.byte_range, s.array.checksum,
             _array_nbytes(s.array), s.array.origin, s.array.codec)
            for s in entry.shards
        ]
    if isinstance(entry, ObjectEntry):
        return [
            (entry.location, None, entry.checksum, entry.size, entry.origin,
             getattr(entry, "codec", None))
        ]
    return []


def _entry_payloads(
    entry: Entry,
) -> List[Tuple[str, Optional[List[int]], Optional[str], Optional[int], Optional[str]]]:
    """(location, byte_range, checksum, nbytes, origin) — the historical
    5-tuple view (tests and external tooling unpack it); fsck uses the
    codec-aware ``_entry_payloads_ex``."""
    return [p[:5] for p in _entry_payloads_ex(entry)]


def _entry_nbytes(entry: Entry) -> Optional[int]:
    try:
        if isinstance(entry, ArrayEntry):
            if entry.byte_range is not None:
                return entry.byte_range[1] - entry.byte_range[0]
            return array_size_bytes(entry.shape, entry.dtype)
        if isinstance(entry, (ChunkedArrayEntry, ShardedArrayEntry)):
            return array_size_bytes(entry.shape, entry.dtype)
        if isinstance(entry, ObjectEntry):
            return entry.size
        if isinstance(entry, PrimitiveEntry):
            return 0  # inlined in the metadata; no storage payload
    except ValueError:
        return None
    return None


def _entry_desc(entry: Entry) -> str:
    if isinstance(entry, (ArrayEntry, ChunkedArrayEntry, ShardedArrayEntry)):
        extra = ""
        if isinstance(entry, ChunkedArrayEntry):
            extra = f" ({len(entry.chunks)} chunks)"
        elif isinstance(entry, ShardedArrayEntry):
            extra = f" ({len(entry.shards)} shards)"
        return f"{entry.dtype}{list(entry.shape)}{extra}"
    if isinstance(entry, ObjectEntry):
        return entry.obj_type
    if isinstance(entry, PrimitiveEntry):
        val = entry.readable
        return f"{entry.ptype}={val[:40]}{'…' if len(val) > 40 else ''}"
    return ""


# Shared with the telemetry stats rendering so sizes read identically
# across info/ls/stats.
from .telemetry.export import fmt_bytes as _fmt_bytes  # noqa: E402


def _load_metadata(path: str) -> SnapshotMetadata:
    from .snapshot import Snapshot

    return Snapshot(path).metadata


def cmd_info(args: argparse.Namespace) -> int:
    meta = _load_metadata(args.path)
    counts: Dict[str, int] = {}
    # Replicated entries repeat under every rank prefix but share storage;
    # dedup payloads by (location, byte_range) so sizes reflect bytes on
    # disk, not bytes times world_size (same rule cmd_verify applies).
    payloads: Dict[Tuple[str, Optional[Tuple[int, int]]], Tuple[Optional[str], Optional[int], Optional[str]]] = {}
    for entry in meta.manifest.values():
        counts[entry.type] = counts.get(entry.type, 0) + 1
        for location, byte_range, checksum, nbytes, origin in _entry_payloads(entry):
            key = (location, tuple(byte_range) if byte_range else None)
            payloads.setdefault(key, (checksum, nbytes, origin))
    local = {k: v for k, v in payloads.items() if v[2] is None}
    external = {k: v for k, v in payloads.items() if v[2] is not None}
    total = sum(n for _, n, _ in local.values() if n is not None)
    unsized = sum(1 for _, n, _ in local.values() if n is None)
    checksummed = sum(1 for c, _, _ in payloads.values() if c is not None)
    print(f"path:        {args.path}")
    print(f"version:     {meta.version}")
    print(f"world_size:  {meta.world_size}")
    print(f"entries:     {len(meta.manifest)}")
    for typ in sorted(counts):
        print(f"  {typ}: {counts[typ]}")
    print(f"payload:     {_fmt_bytes(total)}"
          + (f" (+{unsized} payloads of unknown size)" if unsized else ""))
    if external:
        ext_total = sum(n for _, n, _ in external.values() if n is not None)
        origins = sorted({o for _, _, o in external.values()})
        print(f"external:    {len(external)} payloads ({_fmt_bytes(ext_total)}) "
              f"referenced from base snapshot(s): {', '.join(origins)}")
        mirrored = meta.origin_mirrors or {}
        if all(o in mirrored for o in origins):
            print("             (every base's mirror is recorded: restore "
                  "survives loss of the bases' primary tiers)")
        else:
            print("             (bases must remain intact for restore)")
    print(f"checksums:   {checksummed}/{len(payloads)} payloads")
    # Per distinct payload like the stats above — replicated entries
    # repeat under every rank prefix but share storage.
    codec_of: Dict[Tuple[str, Optional[Tuple[int, int]]], str] = {}
    for entry in meta.manifest.values():
        subs = [entry]
        for attr in ("chunks", "shards"):
            subs.extend(s.array for s in getattr(entry, attr, []) or [])
        for sub in subs:
            codec = getattr(sub, "codec", None)
            if codec is not None:
                br = getattr(sub, "byte_range", None)
                codec_of[(sub.location, tuple(br) if br else None)] = codec
    if codec_of:
        codecs: Dict[str, int] = {}
        for codec in codec_of.values():
            codecs[codec] = codecs.get(codec, 0) + 1
        summary = ", ".join(f"{c} x{n}" for c, n in sorted(codecs.items()))
        print(f"compression: {summary}")
    return 0


def cmd_ls(args: argparse.Namespace) -> int:
    meta = _load_metadata(args.path)
    for path, entry in meta.manifest.items():
        if args.rank is not None and not path.startswith(f"{args.rank}/"):
            continue
        if is_container_entry(entry) and not args.all:
            continue
        if is_container_entry(entry) or isinstance(entry, PrimitiveEntry):
            size = ""
        else:
            size = _fmt_bytes(_entry_nbytes(entry))
        print(f"{path:60s} {entry.type:14s} {_entry_desc(entry):40s} {size}")
    return 0


# Dtypes numpy lacks: the JAX package prints them as ml_dtypes arrays,
# whose elements print as C++ ``ostream << float`` does (``%g``).
_ML_DTYPE_NAMES = frozenset({"bfloat16", "float8_e4m3fn", "float8_e4m3fnuz", "float8_e5m2",
                             "float8_e5m2fnuz", "float8_e8m0fnu"})


def _ml_float_str(x: Any) -> str:
    return "%g" % abs(x) if x != x else "%g" % x


def cmd_cat(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from .serialization import dtype_to_string
    from .snapshot import Snapshot

    value = Snapshot(args.path).read_object(args.entry)
    formatter = None
    if isinstance(value, torch.Tensor):
        name = dtype_to_string(value.dtype)
        if name in _ML_DTYPE_NAMES:
            arr = value.detach().cpu().float().numpy()
            formatter = {"float_kind": _ml_float_str}
        else:
            arr = value.detach().cpu().numpy()
    elif isinstance(value, np.ndarray) or hasattr(value, "shape"):
        arr = np.asarray(value)
        name = str(arr.dtype)
    else:
        print(repr(value))
        return 0
    print(f"{name}{list(arr.shape)}")
    with np.printoptions(threshold=args.limit, edgeitems=4, formatter=formatter):
        print(arr)
    return 0


def _payloads_by_origin(
    meta: SnapshotMetadata,
) -> Dict[Optional[str], List[Tuple]]:
    """Distinct stored payloads grouped by origin, in deterministic order:
    ``{origin: [(location, byte_range, checksum, nbytes, codec), ...]}``.

    Replicated entries appear under every rank prefix and slab-batched
    sub-entries share a location under different byte ranges — each
    distinct ``(origin, location, byte_range)`` is listed exactly once.
    Payloads an incremental take left in a base snapshot group under that
    base's URL so its plugin opens once. Shared by ``verify`` and
    ``fsck`` — the two must never disagree on what "every payload" means.
    """
    seen: Dict[Tuple[Optional[str], str, Optional[Tuple[int, int]]], Tuple] = {}
    for entry in meta.manifest.values():
        for location, byte_range, checksum, nbytes, origin, codec in (
            _entry_payloads_ex(entry)
        ):
            key = (origin, location, tuple(byte_range) if byte_range else None)
            seen.setdefault(key, (checksum, nbytes, codec))
    by_origin: Dict[Optional[str], List[Tuple]] = {}
    for (origin, location, byte_range), info in sorted(
        seen.items(), key=lambda kv: (kv[0][0] or "", kv[0][1])
    ):
        by_origin.setdefault(origin, []).append((location, byte_range) + info)
    return by_origin


def _origin_storage_options(
    origin: Optional[str],
    meta: SnapshotMetadata,
    storage_options: Optional[Dict[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Plugin options for reading payloads at ``origin`` (None = the
    snapshot itself), restore-equivalent: an origin reads through ITS
    recorded mirror fallback — never through this snapshot's mirror
    settings — so verify/fsck agree with what restore can actually read
    (including after a base's primary loss). The snapshot's OWN tier
    likewise defaults to its recorded ``mirror_url`` when the caller
    supplied none: a mirrored snapshot whose primary payloads were lost
    restores fine through the failover, and fsck must say so instead of
    raising a false missing-payload alarm on a degraded-but-healthy
    deployment."""
    if origin is None:
        # An explicitly-present mirror_url key (even None) is the
        # caller's word — e.g. {"mirror_url": None} audits the primary
        # tier alone.
        if meta.mirror_url and "mirror_url" not in (storage_options or {}):
            return {**(storage_options or {}), "mirror_url": meta.mirror_url}
        return storage_options
    from .storage_plugin import strip_mirror_options

    opts = strip_mirror_options(storage_options)
    mirror = (meta.origin_mirrors or {}).get(origin)
    if mirror:
        opts = {**(opts or {}), "mirror_url": mirror}
    return opts


def cmd_verify(args: argparse.Namespace) -> int:
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    meta = _load_metadata(args.path)
    by_origin = _payloads_by_origin(meta)

    event_loop = asyncio.new_event_loop()
    ok = skipped = failed = 0
    try:
        for origin, payloads in by_origin.items():
            storage = url_to_storage_plugin_in_event_loop(
                origin if origin is not None else args.path,
                event_loop,
                _origin_storage_options(origin, meta),
            )
            where = f" [{origin}]" if origin is not None else ""
            try:
                for location, byte_range, checksum, _nbytes, _codec in payloads:
                    if checksum is None:
                        skipped += 1
                        if args.verbose:
                            print(f"SKIP  {location}{where} (no checksum recorded)")
                        continue
                    read_io = ReadIO(path=location, byte_range=byte_range)
                    try:
                        event_loop.run_until_complete(storage.read(read_io))
                        verify_checksum(read_io.buf, checksum, location)
                    except (IntegrityError, OSError) as e:
                        failed += 1
                        print(f"FAIL  {location}{where}: {e}")
                        continue
                    ok += 1
                    if args.verbose:
                        print(f"OK    {location}{where}")
            finally:
                storage.sync_close(event_loop)
    finally:
        event_loop.close()
    print(f"verified {ok} payloads, {skipped} without checksums, {failed} failed")
    return 1 if failed else 0


# ------------------------------------------------------------------- fsck
#
# ``verify`` answers "do the payload bytes match their checksums"; fsck
# answers the on-call's bigger question — "is this snapshot DIRECTORY in
# a state the restore path will accept, and if not, what exactly is
# wrong". It layers manifest<->payload existence/size agreement, chained
# CRC verification, incremental-chain (deps) integrity, orphan/partial-
# commit detection, and an optional quarantine repair, with CI-friendly
# exit codes: 0 clean, 1 findings, 2 cannot-check.


@dataclass(frozen=True)
class InternalArtifact:
    """One class of internal (non-payload) artifact a COMMITTED snapshot
    may legitimately carry alongside its manifest-referenced payloads."""

    name: str
    files: Tuple[str, ...] = ()  # exact snapshot-relative paths
    prefixes: Tuple[str, ...] = ()  # top-level directory names


#: The single registry of internal artifacts fsck must not flag as
#: orphans. Grown ad hoc across PRs (telemetry, critpath, quarantine,
#: flight recorder) as scattered literals inside the orphan scan; any new
#: artifact class registers HERE, in one place, or fsck will quarantine
#: it. ``.snapshot_metadata`` is a literal (not imported from .snapshot)
#: to keep this module's top-level imports light.
INTERNAL_ARTIFACTS: Tuple[InternalArtifact, ...] = (
    InternalArtifact("metadata", files=(".snapshot_metadata",)),
    InternalArtifact(
        "telemetry", files=(".snapshot_telemetry",), prefixes=(".telemetry",)
    ),
    InternalArtifact("critpath", files=(".snapshot_critpath",)),
    InternalArtifact("quarantine", prefixes=(".fsck_quarantine",)),
    InternalArtifact("flight", prefixes=(".flight",)),
    # Delta journal (journal.py): fenced epoch segments between full
    # snapshots. Exempt from the orphan scan, but NOT unchecked — it has
    # its own fsck pass (_fsck_journal) with dedicated finding classes.
    InternalArtifact("journal", prefixes=(JOURNAL_DIRNAME,)),
    # Geo-replication (georep.py): the durable cursor a remote-tier step
    # directory carries. Exempt from the orphan scan, but NOT unchecked —
    # _fsck_georep cross-checks it against the directory's own journal
    # state (finding class georep-stale-cursor). In-flight ship temps use
    # the shared ``.tmp.`` naming, so the temp-file class already covers
    # them.
    InternalArtifact("georep", files=(".georep_cursor.json",)),
)


def internal_artifact_class(rel: str) -> Optional[str]:
    """The registered internal-artifact class owning the snapshot-relative
    path ``rel``, or None for payload/user data."""
    import os

    top = rel.split(os.sep, 1)[0].split("/", 1)[0]
    for art in INTERNAL_ARTIFACTS:
        if rel in art.files or top in art.prefixes:
            return art.name
    return None


class FsckReport:
    """Findings grouped by class. ``findings`` holds what is wrong NOW
    (after any repair); ``repaired`` what --repair quarantined."""

    #: finding classes --repair may quarantine (never payload data).
    #: journal-torn-tail is special-cased in _fsck_repair: only the bytes
    #: PAST the committed offset are quarantined, then the segment is
    #: truncated back to its committed length.
    REPAIRABLE = (
        "orphan",
        "temp-file",
        "stale-fence",
        "journal-torn-tail",
        "journal-orphan-epoch",
        "georep-stale-cursor",
    )

    def __init__(self) -> None:
        self.findings: List[Tuple[str, str, str]] = []  # (class, where, what)
        self.repaired: List[Tuple[str, str]] = []  # (class, where)
        self.payloads_ok = 0
        self.payloads_skipped = 0
        #: rel segment path -> committed offset, for torn-tail repair
        self.journal_tails: Dict[str, int] = {}

    def add(self, cls: str, where: str, what: str) -> None:
        self.findings.append((cls, where, what))

    def classes(self) -> set:
        return {c for c, _, _ in self.findings}

    @property
    def clean(self) -> bool:
        return not self.findings


def _fsck_local_dir(path: str) -> Optional[str]:
    """The local directory behind ``path`` (orphan scan / repair surface),
    or None for remote backends."""
    from .storage_plugin import local_fs_root

    return local_fs_root(path)


def _is_not_found_error(exc: BaseException) -> bool:
    from .storage_plugins.retry import is_not_found_error

    return is_not_found_error(exc)


def _classify_read_failure(exc: BaseException, dep_cls: Optional[str]) -> str:
    """Map a payload-read exception to a finding class. fsck's job is to
    diagnose, so NO read failure may escape as a crash: unknown backend
    errors degrade to io-error (dangling-dep inside an origin chain)."""
    if _is_not_found_error(exc):
        return dep_cls or "missing-payload"
    if isinstance(exc, EOFError):
        return "truncated-payload"
    return dep_cls or "io-error"


def _fsck_payload_checks(
    path: str,
    meta: SnapshotMetadata,
    storage_options: Optional[Dict[str, Any]],
    report: FsckReport,
    echo,
    verbose: bool,
) -> None:
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    by_origin = _payloads_by_origin(meta)
    event_loop = asyncio.new_event_loop()
    try:
        for origin, payloads in by_origin.items():
            dep_cls = "dangling-dep" if origin is not None else None
            where_tag = f" [{origin}]" if origin is not None else ""
            opts = _origin_storage_options(origin, meta, storage_options)
            if origin is not None:
                # Deps integrity: the base snapshot itself must still be a
                # committed, readable snapshot — a payload read succeeding
                # against an uncommitted rubble directory proves little.
                from .snapshot import Snapshot

                try:
                    Snapshot(origin, storage_options=opts).metadata
                except Exception as e:  # noqa: BLE001
                    report.add(
                        "dangling-dep",
                        origin,
                        f"base snapshot unreadable ({type(e).__name__}: {e})",
                    )
            try:
                storage = url_to_storage_plugin_in_event_loop(
                    origin if origin is not None else path, event_loop, opts
                )
            except Exception as e:  # noqa: BLE001
                report.add(
                    dep_cls or "io-error",
                    origin or path,
                    f"cannot open storage ({type(e).__name__}: {e})",
                )
                continue
            origin_dir = _fsck_local_dir(origin if origin is not None else path)
            if (opts or {}).get("mirror_url"):
                # A mirror fallback is in play: the primary's stat proves
                # nothing (restore reads through the failover), so every
                # check must go through the plugin like restore does.
                origin_dir = None
            try:
                for location, byte_range, checksum, nbytes, codec in payloads:
                    where = f"{location}{where_tag}"
                    # Existence/size agreement first, via stat where the
                    # backend is a local filesystem with no mirror tier:
                    # catches truncation without reading (and without
                    # tripping SIGBUS on an mmap of a range past EOF).
                    if origin_dir is not None:
                        import os

                        fpath = os.path.join(origin_dir, location)
                        if not os.path.exists(fpath):
                            report.add(
                                dep_cls or "missing-payload", where,
                                "payload file missing",
                            )
                            continue
                        fsize = os.path.getsize(fpath)
                        need = None
                        if byte_range is not None:
                            need = byte_range[1]
                        elif codec is None and nbytes is not None:
                            need = nbytes
                        if need is not None and fsize < need:
                            report.add(
                                "truncated-payload", where,
                                f"file is {fsize} bytes; manifest needs "
                                f"{need}",
                            )
                            continue
                    read_io = ReadIO(
                        path=location,
                        byte_range=tuple(byte_range) if byte_range else None,
                    )
                    try:
                        event_loop.run_until_complete(storage.read(read_io))
                    except Exception as e:  # noqa: BLE001
                        report.add(
                            _classify_read_failure(e, dep_cls),
                            where,
                            f"{type(e).__name__}: {e}",
                        )
                        continue
                    buf = read_io.buf
                    if (
                        codec is None
                        and byte_range is None
                        and nbytes is not None
                        and len(buf) != nbytes
                    ):
                        report.add(
                            "size-mismatch", where,
                            f"stored {len(buf)} bytes; manifest says {nbytes}",
                        )
                        continue
                    if checksum is None:
                        report.payloads_skipped += 1
                        if verbose:
                            echo(f"SKIP  {where} (no checksum recorded)")
                        continue
                    try:
                        verify_checksum(buf, checksum, location)
                    except IntegrityError as e:
                        report.add("checksum-mismatch", where, str(e))
                        continue
                    report.payloads_ok += 1
                    if verbose:
                        echo(f"OK    {where}")
            finally:
                storage.sync_close(event_loop)
    finally:
        event_loop.close()


def _fsck_orphan_scan(
    local_dir: str, meta: SnapshotMetadata, report: FsckReport
) -> None:
    import os

    from .snapshot import SNAPSHOT_FENCE_FNAME

    referenced = set()
    for entry in meta.manifest.values():
        for location, _, _, _, origin, _ in _entry_payloads_ex(entry):
            if origin is None:
                referenced.add(os.path.normpath(location))

    internal_prefixes = tuple(
        p for art in INTERNAL_ARTIFACTS for p in art.prefixes
    )
    for dirpath, dirnames, filenames in os.walk(local_dir):
        rel_dir = os.path.relpath(dirpath, local_dir)
        top = (rel_dir.split(os.sep, 1)[0] if rel_dir != "." else "")
        if top in internal_prefixes:
            dirnames[:] = []
            continue
        for fname in sorted(filenames):
            rel = os.path.normpath(
                os.path.join(rel_dir, fname) if rel_dir != "." else fname
            )
            if rel in referenced or internal_artifact_class(rel) is not None:
                continue
            if rel == SNAPSHOT_FENCE_FNAME:
                report.add(
                    "stale-fence", rel,
                    "commit fence outlived a committed snapshot (interrupted "
                    "fence cleanup, or a foreign in-flight take)",
                )
                continue
            if ".tmp." in rel:
                report.add(
                    "temp-file", rel,
                    "write temp file left behind by a dead writer",
                )
            else:
                report.add("orphan", rel, "not referenced by the manifest")
        if rel_dir != "." and not filenames and not dirnames:
            report.add("orphan", rel_dir, "empty directory")


def _fsck_journal(local_dir: str, report: FsckReport) -> None:
    """The journal artifact class (journal.py): epoch-chain contiguity,
    committed-region CRC verification, torn-tail detection, and orphan
    epoch metas. Finding classes:

    - ``journal-torn-tail``    (repairable): bytes past the last committed
      offset — a writer died mid-append. Replay already ignores them; the
      repair quarantines the tail bytes and truncates the segment.
    - ``journal-orphan-epoch`` (repairable): an epoch meta past a gap in
      the chain, or unparseable — it never committed on the surviving
      chain and must never be replayed.
    - ``journal-corrupt-record`` (NOT repairable): the committed region of
      a segment fails CRC/parse, or a committed segment is missing/short.
      The journal is unreplayable past the damage; restore falls back to
      the base snapshot. Retake a full snapshot.
    - a leftover ``.journal/.fence`` reuses the ``stale-fence`` class: the
      epoch writer died between planting the fence and committing.
    """
    import os

    from . import journal as journal_mod

    jdir = os.path.join(local_dir, JOURNAL_DIRNAME)
    if not os.path.isdir(jdir):
        return

    def rel(name: str) -> str:
        return os.path.join(JOURNAL_DIRNAME, name)

    metas = journal_mod.read_epoch_metas(jdir)
    committed = journal_mod.committed_epochs(metas)
    committed_ids = {m.get("epoch") for m in committed}

    try:
        names = sorted(os.listdir(jdir))
    except OSError as e:
        report.add("io-error", JOURNAL_DIRNAME, f"cannot list journal: {e}")
        return

    seg_ranks = set()
    for name in names:
        if name == journal_mod.FENCE_FNAME:
            report.add(
                "stale-fence", rel(name),
                "journal epoch fence outlived its epoch (writer died "
                "mid-epoch; the uncommitted epoch is already ignored)",
            )
            continue
        seg_m = journal_mod._SEGMENT_RE.match(name)
        if seg_m is not None:
            seg_ranks.add(int(seg_m.group(1)))
            continue
        meta_m = journal_mod._EPOCH_META_RE.match(name)
        if meta_m is not None:
            epoch = int(meta_m.group(1))
            if epoch not in committed_ids:
                parsed = any(m.get("epoch") == epoch for m in metas)
                report.add(
                    "journal-orphan-epoch", rel(name),
                    f"epoch {epoch} past a gap in the committed chain "
                    "(never replayed)" if parsed
                    else "unparseable epoch metadata (never replayed)",
                )
            continue
        if ".tmp." in name:
            report.add(
                "temp-file", rel(name),
                "write temp file left behind by a dead writer",
            )
        else:
            report.add("orphan", rel(name), "not a journal artifact")

    # Committed-region integrity + torn tails, against the LAST committed
    # epoch's offsets (they are monotonic across the chain by protocol).
    offsets = committed[-1].get("offsets", {}) if committed else {}
    for rank in sorted(seg_ranks | {int(r) for r in offsets}):
        seg_rel = rel(journal_mod.segment_name(rank))
        seg_path = os.path.join(local_dir, seg_rel)
        limit = int(offsets.get(str(rank), 0))
        if not os.path.exists(seg_path):
            if limit > 0:
                report.add(
                    "journal-corrupt-record", seg_rel,
                    f"committed segment missing ({limit} byte(s) recorded)",
                )
            continue
        if limit > 0:
            _, error = journal_mod.scan_segment(seg_path, limit)
            if error is not None:
                report.add(
                    "journal-corrupt-record", seg_rel,
                    f"committed region unreplayable: {error} — restore "
                    "falls back to the base snapshot; retake a full "
                    "snapshot",
                )
                continue  # size vs limit is meaningless past corruption
        try:
            size = os.path.getsize(seg_path)
        except OSError:
            continue
        if size > limit:
            report.add(
                "journal-torn-tail", seg_rel,
                f"{size - limit} uncommitted byte(s) past the committed "
                f"offset {limit} (writer died mid-append; never replayed)",
            )
            report.journal_tails[seg_rel] = limit


def _fsck_georep(local_dir: str, report: FsckReport) -> None:
    """The geo-replication artifact class (georep.py): the durable
    replication cursor a remote-tier step directory carries. Finding
    class:

    - ``georep-stale-cursor`` (repairable): the cursor is unparseable or
      disagrees with the directory's OWN committed state — it names a
      base step other than the directory's, claims more epochs than the
      committed chain holds, or carries a generation the committed
      metadata does not. The shipper never trusts the cursor blindly (it
      re-probes the remote metadata and re-derives it), so the repair
      simply quarantines the file.
    """
    import json as json_mod
    import os

    from . import georep as georep_mod
    from . import journal as journal_mod

    cpath = os.path.join(local_dir, georep_mod.CURSOR_FNAME)
    if not os.path.isfile(cpath):
        return
    rel = georep_mod.CURSOR_FNAME
    try:
        with open(cpath, "r") as f:
            cur = json_mod.load(f)
        if not isinstance(cur, dict):
            raise ValueError("not a JSON object")
        epoch = int(cur["epoch"])
        base_step = int(cur["base_step"])
        gen = cur.get("gen")
    except (OSError, ValueError, KeyError, TypeError) as e:
        report.add(
            "georep-stale-cursor", rel,
            f"unparseable replication cursor ({type(e).__name__}: {e}) — "
            "the shipper re-derives it; safe to quarantine",
        )
        return
    dir_m = georep_mod._STEP_RE.match(os.path.basename(local_dir.rstrip(os.sep)))
    if dir_m is not None and int(dir_m.group(1)) != base_step:
        report.add(
            "georep-stale-cursor", rel,
            f"cursor names base step {base_step}, directory is "
            f"step {int(dir_m.group(1))}",
        )
        return
    jdir = os.path.join(local_dir, JOURNAL_DIRNAME)
    committed = journal_mod.committed_epochs(journal_mod.read_epoch_metas(jdir))
    if epoch > len(committed):
        report.add(
            "georep-stale-cursor", rel,
            f"cursor claims epoch {epoch} applied; the committed chain "
            f"here holds {len(committed)} epoch(s)",
        )
        return
    if epoch >= 1 and committed[epoch - 1].get("gen") != gen:
        report.add(
            "georep-stale-cursor", rel,
            f"cursor carries generation {gen!r} for epoch {epoch}; the "
            f"committed metadata says {committed[epoch - 1].get('gen')!r}",
        )


def _fsck_repair(local_dir: str, report: FsckReport, echo) -> None:
    """Quarantine repairable findings under ``.fsck_quarantine/``
    (preserving relative paths) — never deletes, never touches payload
    data, so a mistaken repair is always reversible by moving back."""
    import os
    import shutil

    quarantine = os.path.join(local_dir, ".fsck_quarantine")
    remaining: List[Tuple[str, str, str]] = []
    for cls, where, what in report.findings:
        if cls not in FsckReport.REPAIRABLE:
            remaining.append((cls, where, what))
            continue
        if cls == "journal-torn-tail":
            # Repair in place: quarantine only the bytes PAST the
            # committed offset, then truncate the segment back to its
            # committed length — the committed records stay replayable.
            seg = os.path.join(local_dir, where)
            limit = report.journal_tails.get(where, 0)
            dst = os.path.join(quarantine, where + ".tail")
            try:
                with open(seg, "rb") as f:
                    f.seek(limit)
                    tail = f.read()
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(dst, "wb") as f:
                    f.write(tail)
                os.truncate(seg, limit)
            except OSError as e:
                remaining.append((cls, where, f"{what} (repair failed: {e})"))
                continue
            report.repaired.append((cls, where))
            echo(
                f"TRUNCATED    {where} -> committed offset {limit} "
                f"(tail in .fsck_quarantine/{where}.tail)"
            )
            continue
        src = os.path.join(local_dir, where)
        dst = os.path.join(quarantine, where)
        try:
            os.makedirs(os.path.dirname(dst) or quarantine, exist_ok=True)
            shutil.move(src, dst)
            # Prune directories the move emptied — a leftover empty
            # temp dir would re-surface as an orphan on the next fsck.
            parent = os.path.dirname(src)
            while (
                os.path.realpath(parent) != os.path.realpath(local_dir)
                and os.path.isdir(parent)
                and not os.listdir(parent)
            ):
                os.rmdir(parent)
                parent = os.path.dirname(parent)
        except OSError as e:
            remaining.append((cls, where, f"{what} (repair failed: {e})"))
            continue
        report.repaired.append((cls, where))
        echo(f"QUARANTINED  {where} -> .fsck_quarantine/{where}")
    report.findings = remaining


def run_fsck(
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
    repair: bool = False,
    verbose: bool = False,
    echo=print,
) -> Tuple[int, FsckReport]:
    """Full snapshot consistency check. Returns (exit_code, report):
    0 clean, 1 findings survived (corruption, orphans not repaired,
    partial commit), 2 cannot-check (no snapshot there at all)."""
    import os

    from .manifest import CorruptSnapshotError
    from .snapshot import (
        SNAPSHOT_FENCE_FNAME,
        SNAPSHOT_METADATA_FNAME,
        Snapshot,
    )

    report = FsckReport()
    local_dir = _fsck_local_dir(path)
    try:
        meta = Snapshot(path, storage_options=storage_options).metadata
    except CorruptSnapshotError as e:
        report.add("corrupt-metadata", SNAPSHOT_METADATA_FNAME, e.detail)
        echo(f"CORRUPT  {SNAPSHOT_METADATA_FNAME}: {e.detail}")
        echo(
            "fsck: metadata unreadable — treat the snapshot as uncommitted "
            "(payloads not checked)"
        )
        return 1, report
    except Exception as e:  # noqa: BLE001
        if not _is_not_found_error(e):
            # Transport/auth/backend failure: we cannot tell anything
            # about the snapshot — that's cannot-check (2), reported as
            # a diagnosis through the caller's echo, never a traceback.
            echo(
                f"error: cannot read snapshot metadata at {path} "
                f"({type(e).__name__}: {e})"
            )
            return 2, report
        # No commit point. Distinguish "a dead writer's partial directory"
        # (a finding) from "nothing resembling a snapshot" (cannot-check).
        if local_dir is not None and not os.path.isdir(local_dir):
            echo(f"error: {path} does not exist")
            return 2, report
        residue: List[str] = []
        if local_dir is not None:
            for dirpath, _, filenames in os.walk(local_dir):
                for fname in filenames:
                    residue.append(
                        os.path.relpath(os.path.join(dirpath, fname), local_dir)
                    )
        if residue:
            fence = SNAPSHOT_FENCE_FNAME in residue
            report.add(
                "partial-commit",
                path,
                f"{len(residue)} file(s) but no {SNAPSHOT_METADATA_FNAME}"
                + (" (commit fence present: writer died mid-take)" if fence
                   else ""),
            )
            echo(
                f"PARTIAL  {path}: {len(residue)} file(s), no "
                f"{SNAPSHOT_METADATA_FNAME} — an uncommitted take; the "
                "snapshot never existed. Safe to delete (the manager "
                "reclaims it on the next save)."
            )
            return 1, report
        echo(f"error: no snapshot at {path}")
        return 2, report

    _fsck_payload_checks(path, meta, storage_options, report, echo, verbose)
    if local_dir is not None:
        _fsck_orphan_scan(local_dir, meta, report)
        _fsck_journal(local_dir, report)
        _fsck_georep(local_dir, report)
    else:
        echo("note: remote backend — orphan scan skipped (payload and "
             "chain checks only)")

    if repair and local_dir is not None and report.findings:
        _fsck_repair(local_dir, report, echo)

    for cls, where, what in report.findings:
        echo(f"{cls.upper():18s} {where}: {what}")
    echo(
        f"fsck {path}: {report.payloads_ok} payload(s) verified, "
        f"{report.payloads_skipped} without checksums, "
        f"{len(report.findings)} finding(s)"
        + (f", {len(report.repaired)} quarantined" if report.repaired else "")
    )
    return (1 if report.findings else 0), report


def cmd_fsck(args: argparse.Namespace) -> int:
    code, _ = run_fsck(
        args.path,
        repair=args.repair,
        verbose=args.verbose,
    )
    return code


def cmd_migrate(args: argparse.Namespace) -> int:
    from .tricks.torchsnapshot_interop import (
        migrate_from_torchsnapshot,
        read_metadata,
    )

    raw = read_metadata(args.src)  # ValueError on malformed metadata
    if _looks_native(raw["manifest"]):
        print(f"{args.src} is already a native snapshot; nothing to migrate.")
        return 1
    _, state = migrate_from_torchsnapshot(args.src, args.dst, rank=args.rank)
    from .flatten import flatten

    n = len(flatten(state)[1])
    print(f"migrated {n} leaves from {args.src} -> {args.dst}")
    return 0


def _looks_native(raw_manifest: Dict[str, Any]) -> bool:
    """Distinguish a native manifest from a reference-format one.

    Container and object type names collide between the formats, so a
    bare type-set subset test misfires on tensor-free reference snapshots.
    Reference-only markers: capitalized tensor types, primitive entries
    carrying ``serialized_value``, and ``torch_save``-serialized objects.
    """
    for entry in raw_manifest.values():
        if not isinstance(entry, dict):
            raise ValueError("Malformed manifest: entries must be mappings")
        if entry.get("type") in ("Tensor", "ChunkedTensor", "ShardedTensor"):
            return False
        if "serialized_value" in entry:
            return False
        if entry.get("serializer") == "torch_save":
            return False
    return True


def _sub_payload_entries(entry: Entry) -> List[Tuple[Optional[Tuple[int, ...]], Any]]:
    """(chunk/shard box, payload-entry) pairs — the per-payload alignment
    unit for content comparison. Plain arrays/objects have one boxless
    payload; chunked/sharded entries align by their N-D (offsets, sizes)
    so each sub-entry's own digest/checksum is compared (slab-batched
    payloads share a location, so location is NOT a safe key)."""
    if isinstance(entry, (ArrayEntry, ObjectEntry)):
        return [(None, entry)]
    if isinstance(entry, ChunkedArrayEntry):
        return [
            ((*c.offsets, *c.sizes), c.array) for c in entry.chunks
        ]
    if isinstance(entry, ShardedArrayEntry):
        return [
            ((*s.offsets, *s.sizes), s.array) for s in entry.shards
        ]
    return []


def _leaf_compare(ea: Entry, eb: Entry) -> str:
    """'same' | 'changed' | 'unknown' for two leaf entries.

    Exactness degrades to the strongest evidence available on BOTH sides:
    content digests, else same-algorithm integrity checksums, else only
    structure — in which case equality is 'unknown', never claimed.
    Comparison is chunk/shard-layout-sensitive by construction: identical
    content striped differently (e.g. saved at different world sizes)
    reports as changed.
    """
    if ea.type != eb.type:
        return "changed"
    if isinstance(ea, PrimitiveEntry):
        return (
            "same"
            if (ea.ptype, ea.readable) == (eb.ptype, eb.readable)
            else "changed"
        )
    if str(getattr(ea, "dtype", None)) != str(getattr(eb, "dtype", None)):
        return "changed"
    if list(getattr(ea, "shape", []) or []) != list(getattr(eb, "shape", []) or []):
        return "changed"
    if (
        isinstance(ea, ObjectEntry)
        and ea.size is not None
        and eb.size is not None
        and ea.size != eb.size
    ):
        return "changed"
    pa = dict(_sub_payload_entries(ea))
    pb = dict(_sub_payload_entries(eb))
    if set(pa) != set(pb):
        return "changed"  # different chunk/shard layout
    unknown = False
    for box, sub_a in pa.items():
        sub_b = pb[box]
        if sub_a.digest is not None and sub_b.digest is not None:
            # Digests cover the uncompressed content — codec-independent.
            if sub_a.digest != sub_b.digest:
                return "changed"
        elif (
            sub_a.checksum is not None
            and sub_b.checksum is not None
            and sub_a.checksum.partition(":")[0] == sub_b.checksum.partition(":")[0]
            # Checksums cover the STORED bytes: only comparable when both
            # sides stored the same form (same codec, or both raw) —
            # identical content saved raw vs compressed hashes differently.
            and getattr(sub_a, "codec", None) == getattr(sub_b, "codec", None)
        ):
            if sub_a.checksum != sub_b.checksum:
                return "changed"
        else:
            unknown = True
    return "unknown" if unknown else "same"


def cmd_diff(args: argparse.Namespace) -> int:
    meta_a = _load_metadata(args.a)
    meta_b = _load_metadata(args.b)

    def leaves(meta):
        return {
            p: e for p, e in meta.manifest.items() if not is_container_entry(e)
        }

    a, b = leaves(meta_a), leaves(meta_b)
    added = sorted(set(b) - set(a))
    removed = sorted(set(a) - set(b))
    changed, unchanged, uncertain = [], [], []
    for p in sorted(set(a) & set(b)):
        status = _leaf_compare(a[p], b[p])
        if status == "changed":
            changed.append(p)
        elif status == "same":
            unchanged.append(p)
        else:
            uncertain.append(p)
    for p in added:
        print(f"+ {p}")
    for p in removed:
        print(f"- {p}")
    for p in changed:
        print(f"~ {p}  ({_entry_desc(b[p])})")
    if args.verbose:
        for p in unchanged:
            print(f"= {p}")
        for p in uncertain:
            print(f"? {p}  (structure equal; no digest/checksum common to "
                  "both snapshots)")
    print(
        f"{len(added)} added, {len(removed)} removed, {len(changed)} changed, "
        f"{len(unchanged)} unchanged"
        + (f", {len(uncertain)} indeterminate" if uncertain else "")
    )
    return 1 if (added or removed or changed) else 0


def _canon_snapshot_url(url: str) -> str:
    """Canonical comparable form of a snapshot path/URL (fs:// == bare).

    Matches the canonicalization applied to origins at record time
    (dedup.canonical_base_url), plus fs://-vs-bare equivalence; realpath
    (not abspath) so symlinked checkpoint directories compare equal.
    """
    import os

    if url.startswith("fs://"):
        url = url[len("fs://"):]
    if "://" in url:
        return url  # remote URL: compare verbatim
    return os.path.realpath(url)


def cmd_deps(args: argparse.Namespace) -> int:
    import os

    dirpath = args.dir
    names, origins_of, _, _ = _scan_snapshot_dir(dirpath)
    snapshots = sorted(names)
    if not snapshots:
        print(f"no snapshots found under {dirpath}")
        return 2

    # origin URL -> set of snapshot names (in this dir) referencing it
    referenced: Dict[str, set] = {}
    for name, origins in origins_of.items():
        for origin in origins:
            referenced.setdefault(_canon_snapshot_url(origin), set()).add(name)

    canon_of = {
        name: _canon_snapshot_url(os.path.join(dirpath, name))
        for name in snapshots
    }
    safe = []
    for name in snapshots:
        dependents = referenced.get(canon_of[name], set())
        origins = origins_of[name]
        tag = ""
        if origins:
            tag += " <- bases: " + ", ".join(
                os.path.basename(o) for o in sorted(origins)
            )
        if dependents:
            tag += " [REQUIRED by " + ", ".join(sorted(dependents)) + "]"
        else:
            safe.append(name)
        print(f"{name}{tag}")
    local_canon = set(canon_of.values())
    external = {
        o
        for origins in origins_of.values()
        for o in origins
        if _canon_snapshot_url(o) not in local_canon
    }
    for o in sorted(external):
        print(f"(external base outside this directory: {o})")
    print(
        "safe to delete (no dependents here): "
        + (", ".join(safe) if safe else "none")
    )
    return 0


def _scan_snapshot_dir(dirpath: str):
    """(snapshots sorted by mtime asc, {name: origin set},
    {name: {origin: locations referenced in it}}) for a directory."""
    import os

    names = sorted(
        (
            name
            for name in os.listdir(dirpath)
            if os.path.isfile(os.path.join(dirpath, name, ".snapshot_metadata"))
        ),
        # Name tiebreaker: mtime granularity can collide (1s filesystems,
        # rsync-flattened trees); retention decisions must be deterministic.
        key=lambda n: (
            os.path.getmtime(os.path.join(dirpath, n, ".snapshot_metadata")),
            n,
        ),
    )
    origins_of = {}
    origin_locations_of = {}
    payloads_of = {}
    for name in names:
        meta = _load_metadata(os.path.join(dirpath, name))
        origins = set()
        locations = {}
        own = {}
        for entry in meta.manifest.values():
            for location, _, checksum, nbytes, origin in _entry_payloads(entry):
                if origin is not None:
                    origins.add(origin)
                    locations.setdefault(origin, {})[location] = (checksum, nbytes)
                else:
                    own[location] = (checksum, nbytes)
        origins_of[name] = origins
        origin_locations_of[name] = locations
        payloads_of[name] = own
    return names, origins_of, origin_locations_of, payloads_of


def cmd_prune(args: argparse.Namespace) -> int:
    import os

    from .retention import apply_retention, plan_retention

    if "://" in args.dir and not args.dir.startswith("fs://"):
        print("error: prune operates on local filesystem directories only",
              file=sys.stderr)
        return 2
    dirpath = args.dir[len("fs://"):] if args.dir.startswith("fs://") else args.dir
    if args.keep < 1:
        print("error: --keep must be >= 1", file=sys.stderr)
        return 2
    # One scan for both discovery and the plan: the keep-N policy is
    # evaluated inside plan_retention on its own scan, so a snapshot
    # committing concurrently can never be discovered-but-unprotected.
    plan = plan_retention(dirpath, args.keep)
    if not (plan.keep or plan.spared or plan.doomed):
        print(f"no snapshots found under {dirpath}")
        return 2
    unresolved, doomed = plan.unresolved, plan.doomed
    for name in plan.keep:
        print(f"keep    {name}")
    for name, by_name in plan.spared:
        suffix = ", matched by name" if by_name else ""
        print(f"keep    {name}  (base of a kept snapshot{suffix})")
    for name in doomed:
        print(f"delete  {name}")
    if unresolved:
        print(
            "warning: kept snapshot(s) depend on base(s) that resolve to no "
            "snapshot in this directory (moved tree, different mount path, "
            "or a base stored elsewhere):",
            file=sys.stderr,
        )
        for canon in sorted(unresolved):
            print(f"warning:   {canon}", file=sys.stderr)
    if not doomed:
        print("nothing to prune")
        return 0
    if not args.yes:
        print(f"dry run: would delete {len(doomed)} snapshot(s); "
              "re-run with --yes to execute")
        return 0
    if unresolved and not args.ignore_missing_bases:
        print(
            "refusing --yes: cannot prove the snapshots marked for deletion "
            "are not the unresolved base(s) above under a different name. "
            "Verify the bases exist (python -m torchsnapshot_tpu_torch deps), then "
            "re-run with --ignore-missing-bases to delete anyway.",
            file=sys.stderr,
        )
        return 2
    n = apply_retention(dirpath, plan)
    print(f"deleted {n} snapshot(s)")
    return 0


def cmd_trend(args: argparse.Namespace) -> int:
    """``stats --trend``: render the checkpoint-history trajectory for a
    ROOT directory (the parent of the step snapshots) and exit non-zero
    on a p50 regression — CI-pluggable perf-regression detection from
    the journal every committed take appends."""
    from .telemetry import history

    records = history.load_history(args.path)
    if not records:
        print(
            f"error: no usable checkpoint history at {args.path} (expected "
            f"{history.HISTORY_FNAME} in the snapshot ROOT directory — it "
            "is appended by every committed take)",
            file=sys.stderr,
        )
        return 2
    threshold = args.trend_threshold
    verdicts = [
        history.detect_regression(
            records, metric=args.trend_metric, threshold=threshold
        )
    ]
    print(history.render_trend(records, verdicts))
    return 1 if any(v.get("regressed") for v in verdicts) else 0


def cmd_stats(args: argparse.Namespace) -> int:
    """Render the telemetry summary a take persisted next to its
    metadata (telemetry/export.py) — "why was this take slow?" answered
    after the fact, from any registered storage backend. ``--trend``
    switches to the checkpoint-history view (see cmd_trend);
    ``--openmetrics`` emits the summary as an OpenMetrics exposition."""
    import json

    from .storage_plugin import url_to_storage_plugin_in_event_loop
    from .telemetry import (
        TELEMETRY_SUMMARY_FNAME,
        merge_summaries,
        render_openmetrics,
        render_summary_document,
    )

    if args.trend:
        return cmd_trend(args)

    event_loop = asyncio.new_event_loop()
    storage = url_to_storage_plugin_in_event_loop(args.path, event_loop, None)
    try:
        read_io = ReadIO(path=TELEMETRY_SUMMARY_FNAME)
        try:
            event_loop.run_until_complete(storage.read(read_io))
        except Exception as e:  # noqa: BLE001
            # Broad on purpose: a missing object surfaces as OSError on
            # fs but as botocore ClientError (NoSuchKey) / google-api
            # NotFound on the cloud plugins — the friendly hint must work
            # on every registered backend. The original error is included
            # so genuine transport problems stay diagnosable.
            print(
                f"error: could not read {TELEMETRY_SUMMARY_FNAME} from "
                f"{args.path} ({type(e).__name__}: {e}). If the snapshot "
                "exists, it was likely taken without telemetry — save "
                "with TORCHSNAPSHOT_GPU_TELEMETRY=1 to record a summary.",
                file=sys.stderr,
            )
            return 2
    finally:
        storage.sync_close(event_loop)
        event_loop.close()
    try:
        doc = json.loads(bytes(read_io.buf).decode("utf-8"))
    except ValueError as e:
        print(f"error: malformed telemetry summary: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc, indent=1))
        return 0
    if not doc.get("fleet"):
        # Documents written by future/foreign producers may omit the
        # merged view; re-derive it so the rendering stays complete.
        doc["fleet"] = merge_summaries(doc.get("ranks") or [])
    if args.openmetrics:
        sys.stdout.write(render_openmetrics(doc))
        return 0
    print(render_summary_document(doc, verbose=args.verbose))
    return 0


def _read_snapshot_json(
    path: str, fname: str
) -> Tuple[Optional[Dict[str, Any]], Optional[BaseException]]:
    """Load one JSON control file from a snapshot over its storage
    plugin (any backend). Returns ``(doc, None)`` on success,
    ``(None, None)`` when the file simply is not there (or is not a
    JSON object), and ``(None, error)`` on a TRANSPORT/auth/parse
    failure — callers must surface the latter instead of folding it
    into "not recorded" (the cmd_stats lesson: a genuine backend error
    disguised as a telemetry hint sends the on-call the wrong way)."""
    import json

    from .storage_plugins.retry import is_not_found_error
    from .storage_plugin import url_to_storage_plugin_in_event_loop

    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin_in_event_loop(path, event_loop, None)
        try:
            read_io = ReadIO(path=fname)
            event_loop.run_until_complete(storage.read(read_io))
            doc = json.loads(bytes(read_io.buf).decode("utf-8"))
            return (doc, None) if isinstance(doc, dict) else (None, None)
        finally:
            storage.sync_close(event_loop)
    except Exception as e:  # noqa: BLE001
        if is_not_found_error(e):
            return None, None
        return None, e
    finally:
        event_loop.close()


def cmd_explain(args: argparse.Namespace) -> int:
    """Render a take/restore's critical-path attribution: the chain of
    per-rank segments that gated commit, the binding resource with its
    achieved rate (cross-checked against the governor's measured rates),
    the straggler delta, and a tuning hint (telemetry/critpath.py).

    Exit codes: 0 pipeline/coordination-bound, 1 STORAGE-bound, 2 no
    attribution available — so a bench can assert the ROADMAP
    "pipeline-bound" claim with one subprocess call."""
    import json

    from .telemetry import TELEMETRY_SUMMARY_FNAME, critpath

    if getattr(args, "profiles", False):
        # The governor's learned-profile story for this root: per
        # profile key the converged settings, smoothed score, and the
        # recent perturbation trail — the full closed-loop decision
        # trail (autotune.py; persisted by scheduler.observe_verdict
        # into the history journal).
        from .telemetry import history

        target = args.path.rstrip("/")
        records = history.load_profiles(target)
        if not records:
            # ``explain --profiles <snapshot>`` should work too: the
            # journal lives in the PARENT directory (the manager root).
            records = history.load_profiles(
                os.path.dirname(os.path.abspath(target))
            )
        if not records:
            print(
                f"error: no learned profiles at {args.path} (expected "
                "profile records in .telemetry_history.jsonl — recorded "
                "when takes/restores run with TORCHSNAPSHOT_GPU_AUTOTUNE "
                "unset or 'auto').",
                file=sys.stderr,
            )
            return 2
        if args.json:
            print(json.dumps(records, indent=1))
        else:
            print(history.render_profiles(records))
        return 0
    doc, err = _read_snapshot_json(args.path, critpath.ATTRIBUTION_FNAME)
    if doc is None or not doc.get("fleet"):
        # Fallback: re-derive from the telemetry summary document's
        # per-rank attribution blobs (older takes, or a rank-0 persist
        # failure that still landed the summary).
        tel, tel_err = _read_snapshot_json(args.path, TELEMETRY_SUMMARY_FNAME)
        err = err or tel_err
        doc = critpath.derive_document_from_telemetry(tel) if tel else None
    if doc is None or not doc.get("fleet"):
        if err is not None:
            # A transport/auth/corruption failure is NOT "telemetry was
            # off" — surface the real error so the on-call fixes the
            # backend instead of re-running a save.
            print(
                f"error: cannot read attribution records at {args.path} "
                f"({type(err).__name__}: {err})",
                file=sys.stderr,
            )
            return 2
        print(
            f"error: no critical-path attribution at {args.path} (expected "
            f"{critpath.ATTRIBUTION_FNAME} next to .snapshot_metadata). "
            "Attribution is recorded when the take/restore ran with "
            "TORCHSNAPSHOT_GPU_TELEMETRY=1.",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(critpath.render_attribution(doc, verbose=args.verbose))
    return critpath.binding_exit_code(doc)


def cmd_plan(args: argparse.Namespace) -> int:
    """Dry-run the minimal-movement reshard plan (reshard.py) for
    restoring this snapshot under a DIFFERENT layout at a DIFFERENT
    world size — the byte accounting an on-call wants BEFORE committing
    a topology change: what the existing direct path would read from
    storage fleet-wide, what the planner would read instead, and how
    many bytes ride the peer channel.

    The destination layout is a LayoutSpec dict (the same
    ``{version, mesh, rules}`` shape ``Snapshot.take(..., layout=)``
    records in the metadata), loaded from a JSON file. The plan is pure
    geometry on the manifest: no storage payload is touched.

    Exit codes: 0 plan computed, 2 the layout file or an entry's
    geometry is unusable."""
    import json

    from .layout import LayoutSpec
    from .manifest import ShardedArrayEntry
    from .reshard import plan_summary

    meta = _load_metadata(args.path)
    try:
        with open(args.layout) as f:
            dst = LayoutSpec.from_dict(json.load(f))
    except (OSError, ValueError, TypeError, KeyError) as e:
        print(
            f"error: cannot load destination layout {args.layout}: "
            f"{type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 2
    rows = []
    totals = {
        "shards": 0,
        "planned_units": 0,
        "direct_bytes_from_storage": 0,
        "planned_bytes_from_storage": 0,
        "planned_peer_bytes": 0,
    }
    seen = set()
    bad = 0
    # Sharded entries repeat under every rank prefix but describe the
    # same global array; plan each logical entry once.
    for path, entry in meta.manifest.items():
        if not isinstance(entry, ShardedArrayEntry):
            continue
        logical = path.split("/", 1)[1] if "/" in path else path
        if logical in seen:
            continue
        seen.add(logical)
        try:
            spec = dst.spec_for(logical, len(entry.shape))
            boxes = dst.boxes_by_rank(entry.shape, spec, args.world)
        except ValueError as e:
            rows.append({"path": logical, "error": str(e)})
            bad += 1
            continue
        s = plan_summary(entry, boxes, args.min_requesters)
        s["path"] = logical
        s["spec"] = [list(dims) for dims in spec]
        rows.append(s)
        for k in totals:
            totals[k] += s[k]
    if args.json:
        print(
            json.dumps(
                {"world": args.world, "entries": rows, "totals": totals},
                indent=1,
            )
        )
        return 2 if bad else 0
    print(f"plan: {args.path} -> world {args.world} under {args.layout}")
    for s in rows:
        if "error" in s:
            print(f"  {s['path']:50s} UNPLANNABLE: {s['error']}")
            continue
        print(
            f"  {s['path']:50s} {s['shards']:4d} shard(s) "
            f"{s['planned_units']:4d} unit(s)  storage "
            f"{_fmt_bytes(s['planned_bytes_from_storage']):>10s} "
            f"(direct {_fmt_bytes(s['direct_bytes_from_storage'])})  "
            f"peer {_fmt_bytes(s['planned_peer_bytes'])}"
        )
    if not rows:
        print("  (no sharded entries: a pure layout change moves nothing)")
        return 0
    direct = totals["direct_bytes_from_storage"]
    planned = totals["planned_bytes_from_storage"]
    reduction = direct / planned if planned else float("inf")
    print(
        f"totals: storage {_fmt_bytes(planned)} planned vs "
        f"{_fmt_bytes(direct)} direct ({reduction:.1f}x reduction), "
        f"peer {_fmt_bytes(totals['planned_peer_bytes'])}, "
        f"{totals['planned_units']}/{totals['shards']} unit(s) claimed"
    )
    return 2 if bad else 0


def cmd_consolidate(args: argparse.Namespace) -> int:
    from .dedup import consolidate

    n = consolidate(args.src, args.dst)
    print(f"consolidated {args.src} -> {args.dst} ({n} payloads copied; "
          "no base snapshots required)")
    return 0


def cmd_blackbox(args: argparse.Namespace) -> int:
    """Merge the per-rank flight-recorder dumps of an aborted operation
    into one causal cross-rank timeline: who deserted whom at which
    barrier, which rank adopted which store epoch, which commit was
    refused at which generation (telemetry/flightrec.py;
    docs/source/telemetry.rst, "Flight recorder"). Stack dumps from the
    hang watchdog (telemetry/forensics.py) merge into the same report:
    DESERTION findings name where each waiter actually sat, and a rank
    whose consecutive dumps share one non-idle leaf frame earns a WEDGE
    finding. Exit codes: 0 dumps found with no findings, 1 findings,
    2 neither flight dumps nor stack dumps."""
    import json

    from .telemetry import flightrec, forensics

    dumps = flightrec.load_dumps(args.path)
    stacks = forensics.load_stack_dumps(args.path)
    # A hang that resolved on its own leaves stack dumps but no ring
    # dumps (the op never aborted) — that wreck is still readable.
    if not dumps and not stacks:
        print(
            f"error: no flight dumps under {args.path}/{flightrec.FLIGHT_DIR}/ "
            "— ring dumps are written per rank when an operation aborts, "
            "stack dumps when the hang watchdog fires (both on by default; "
            "TORCHSNAPSHOT_GPU_FLIGHTREC=0 / TORCHSNAPSHOT_GPU_FORENSICS=0 "
            "disable them)",
            file=sys.stderr,
        )
        return 2
    merged = flightrec.merge_timeline(dumps)
    forensics.merge_stack_findings(merged, stacks)
    if args.json:
        print(json.dumps(merged, indent=1, default=repr))
    else:
        print(flightrec.render_timeline(merged, verbose=args.verbose))
    return 1 if merged.get("findings") else 0


def cmd_watch(args: argparse.Namespace) -> int:
    """Render the in-flight fleet from the heartbeat keys ranks publish
    through the coordination store (telemetry/health.py): per-rank
    phase/bytes/ETA, stalled-rank flags, and skew — BEFORE the barrier
    timeout turns a stall into an abort. Survives a store-leader
    failover the same way every client does (transparent adoption);
    with the whole tier down it degrades to a retry line, never a
    crash. ``--dump RANK`` posts a forensic request key the target
    rank's hang watchdog polls (telemetry/forensics.py); the returned
    wedge frame renders inline on that rank's row."""
    import json as _json
    import time as _time  # frame pacing, not measurement

    from .dist_store import TCPStore
    from .telemetry import forensics, health

    host, _, port_str = args.addr.rpartition(":")
    if not host or not port_str.isdigit():
        print(f'error: --addr must be "host:port", got {args.addr!r}',
              file=sys.stderr)
        return 2
    tracker = health.FleetTracker(stall_s=args.stall)
    store = None
    ticks = 0
    dump_sent = False
    wedged: dict = {}
    while True:
        try:
            if store is None:
                store = TCPStore(
                    host,
                    int(port_str),
                    is_server=False,
                    timeout=max(args.interval * 2, 5.0),
                    connect_retries=0,
                )
            # The request key survives a leader failover with the rest
            # of the keyspace; re-sent only until one set() succeeds.
            if getattr(args, "dump", None) is not None and not dump_sent:
                store.set(
                    f"{forensics.FORENSIC_REQ_PREFIX}{args.dump}", b"1"
                )
                dump_sent = True
            fleet = health.read_fleet(store)
            ages = tracker.observe(fleet)
            # Poll ONLY the requested rank's answer, and stop once it
            # lands: every extra round trip is load on the same store
            # the hung job depends on.
            if (
                getattr(args, "dump", None) is not None
                and args.dump not in wedged
            ):
                out_key = f"{forensics.FORENSIC_OUT_PREFIX}{args.dump}"
                try:
                    if store.check(out_key):
                        payload = _json.loads(
                            store.get(out_key).decode("utf-8")
                        )
                        if payload.get("wedge"):
                            wedged[args.dump] = str(payload["wedge"])
                except Exception:  # noqa: BLE001 - annotation, not data
                    pass
            frame = health.render_fleet(
                fleet, ages, args.stall, wedged=wedged or None
            )
        except Exception as e:  # noqa: BLE001 - degrade, keep watching
            # Keep the store object when we have one: its cached replica
            # set is what makes the NEXT poll fail over transparently. A
            # dead bootstrap connection is rebuilt from scratch.
            if store is not None and getattr(store, "_dead", None) is not None:
                try:
                    store.close()
                except Exception:  # noqa: BLE001
                    pass
                store = None
            frame = (
                f"store unreachable at {args.addr} "
                f"({type(e).__name__}: {e}); retrying"
            )
        ticks += 1
        print(f"--- watch {args.addr} tick {ticks}")
        print(frame, flush=True)
        if args.ticks and ticks >= args.ticks:
            if store is not None:
                try:
                    store.close()
                except Exception:  # noqa: BLE001
                    pass
            return 0
        _time.sleep(args.interval)


def cmd_store_status(args: argparse.Namespace) -> int:
    """Probe a coordination-store node (leader or standby) and print its
    replication status: role, epoch, op-log position, per-replica lag and
    lease age — the drill-debugging view of the failover tier
    (docs/source/fault_tolerance.rst, "Coordination tier")."""
    import json

    from .dist_store import probe_store_status

    try:
        info = probe_store_status(args.addr, timeout=args.timeout)
    except (ConnectionError, OSError, ValueError) as e:
        print(
            f"error: no store node answering at {args.addr} "
            f"({type(e).__name__}: {e})",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps(info, indent=1, sort_keys=True))
        return 0
    role = info.get("role")
    print(
        f"{info.get('addr')}: role={role} epoch={info.get('epoch')} "
        f"log_seq={info.get('log_seq')} keys={info.get('n_keys')} "
        f"lease={info.get('lease_s')}s"
    )
    if role == "leader":
        replicas = info.get("replicas") or []
        if not replicas:
            print(
                "  no replicas joined — the store is a single point of "
                "failure (set TORCHSNAPSHOT_GPU_STORE_REPLICAS to arm "
                "failover)"
            )
        for rep in replicas:
            print(
                f"  replica[{rep.get('index')}] {rep.get('addr')}  "
                f"acked_seq={rep.get('acked_seq')} lag={rep.get('lag')} "
                f"lease_age={rep.get('lease_age_s')}s"
            )
    elif role == "standby":
        print(
            f"  following leader {info.get('leader')} "
            f"(last leader message {info.get('leader_silence_s')}s ago)"
        )
    elif role == "deposed":
        print(
            "  DEPOSED ex-leader: a higher epoch exists; clients have "
            "failed over to it"
        )
    return 0


def cmd_georep_status(args: argparse.Namespace) -> int:
    """Report the geo-replication plane of a snapshot ROOT: the latest
    committed step vs the remote tier's durable cursor — base shipped or
    not, last applied epoch + generation, backlog in epochs, and the
    measured lag (the RPO exposure a region loss right now would add).
    Exit 0 caught up, 1 behind, 2 cannot-check (no committed step, or no
    remote tier configured and none given with --remote)."""
    import json

    from . import georep

    info = georep.status(args.path, remote_root=args.remote)
    if args.json:
        print(json.dumps(info, indent=1, sort_keys=True))
    else:
        if not info.get("enabled"):
            print(
                f"{args.path}: geo-replication not configured (set "
                f"{georep.GEOREP_ENV_VAR} or pass --remote)"
            )
            return 2
        if info.get("step") is None:
            print(f"{args.path}: no committed step to replicate")
            return 2
        print(
            f"{args.path}: step {info['step']} -> {info['remote']}  "
            f"({info.get('local_epochs', 0)} committed epoch(s), "
            f"generation {info.get('local_gen')})"
        )
        if not info.get("base_replicated"):
            print("  base: NOT replicated (no remote cursor/metadata)")
        else:
            print(
                f"  cursor: epoch {info.get('applied_epoch')} applied, "
                f"generation {info.get('applied_gen')}"
            )
        backlog = info.get("backlog_epochs") or 0
        lag = info.get("lag_s")
        if backlog:
            print(
                f"  BEHIND by {backlog} epoch(s); oldest unreplicated "
                f"state is {lag}s old"
            )
        else:
            print("  caught up (replication lag 0.0s)")
    if not info.get("enabled") or info.get("step") is None:
        return 2
    return 1 if (info.get("backlog_epochs") or 0) else 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch",
        description="Inspect, verify, and migrate snapshots.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="summarize a snapshot")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("ls", help="list entries")
    p.add_argument("path")
    p.add_argument("--rank", type=int, default=None, help="only this rank's entries")
    p.add_argument("--all", action="store_true", help="include container entries")
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("cat", help="print one entry (RANK/logical/path)")
    p.add_argument("path")
    p.add_argument("entry")
    p.add_argument("--limit", type=int, default=64, help="max array elements printed")
    p.set_defaults(fn=cmd_cat)

    p = sub.add_parser("verify", help="re-hash payloads against recorded checksums")
    p.add_argument("path")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser(
        "fsck",
        help="full consistency check: payload existence/size/CRC, "
             "incremental deps, orphans, partial commits "
             "(exit 0 clean / 1 findings / 2 cannot-check)",
    )
    p.add_argument("path")
    p.add_argument("--repair", action="store_true",
                   help="quarantine orphans/temp files under "
                        ".fsck_quarantine/ (never deletes payload data)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_fsck)

    p = sub.add_parser(
        "stats",
        help="render the persisted telemetry summary of a take "
             "(requires TORCHSNAPSHOT_GPU_TELEMETRY=1 at save time); "
             "--trend renders the checkpoint history of a ROOT directory "
             "and exits 1 on a p50 regression; --openmetrics emits the "
             "summary as an OpenMetrics exposition",
    )
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="dump the raw document")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="include all spans and measured rates")
    p.add_argument("--trend", action="store_true",
                   help="render .telemetry_history.jsonl of a snapshot ROOT "
                        "and gate on p50 regression (exit 1)")
    p.add_argument("--trend-metric", default="wall_s",
                   choices=["wall_s", "write_gbps", "read_gbps",
                            "replication_lag_s"],
                   help="history metric to gate on (default wall_s). "
                        "Constrained: a typo'd metric would match no "
                        "records and silently disarm the CI gate")
    p.add_argument("--trend-threshold", type=float, default=None,
                   help="p50 regression threshold as a fraction (default "
                        "TORCHSNAPSHOT_GPU_TREND_THRESHOLD or 0.25)")
    p.add_argument("--openmetrics", action="store_true",
                   help="emit the summary in OpenMetrics text format")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser(
        "explain",
        help="critical-path attribution of a take/restore: binding "
             "resource + measured rate, per-segment critical path, "
             "straggler delta, tuning hint (exit 0 pipeline-bound / "
             "1 storage-bound / 2 no attribution)",
    )
    p.add_argument("path")
    p.add_argument("--json", action="store_true",
                   help="dump the raw attribution document")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="include the governor's recorded elections")
    p.add_argument("--profiles", action="store_true",
                   help="render the autotuner's learned I/O profiles for "
                        "this root instead: per profile key the converged "
                        "settings, score, and recent perturbation trail")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser(
        "plan",
        help="dry-run the minimal-movement reshard plan for restoring "
             "under a different layout/world: per-entry and total "
             "storage bytes (planned vs direct) and peer-channel bytes",
    )
    p.add_argument("path")
    p.add_argument("layout", help="destination LayoutSpec JSON file "
                                  "({version, mesh, rules})")
    p.add_argument("--world", type=int, required=True,
                   help="destination world size")
    p.add_argument("--min-requesters", type=int, default=2,
                   help="claim threshold: shards with fewer overlapping "
                        "ranks stay on direct reads (default 2)")
    p.add_argument("--json", action="store_true",
                   help="dump the per-entry plan accounting as JSON")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser(
        "blackbox",
        help="merge per-rank flight-recorder dumps (<snapshot>/.flight/) "
             "into one causal cross-rank timeline with findings "
             "(exit 0 clean / 1 findings / 2 no dumps)",
    )
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="dump the merged view")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="show the full timeline (default: last 200 events)")
    p.set_defaults(fn=cmd_blackbox)

    p = sub.add_parser(
        "watch",
        help="live fleet view of an in-flight take/restore from the "
             "coordination store's heartbeat keys: per-rank phase/bytes/"
             "ETA, stalled ranks, skew",
    )
    p.add_argument("addr", help='coordination store address, "host:port"')
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between frames (default 1.0)")
    p.add_argument("--stall", type=float, default=5.0,
                   help="flag a rank STALLED after this many seconds "
                        "without heartbeat progress (default 5.0)")
    p.add_argument("--ticks", type=int, default=0,
                   help="render N frames then exit (0 = forever)")
    p.add_argument("--dump", type=int, default=None, metavar="RANK",
                   help="request a live thread-stack dump from RANK's "
                        "hang watchdog; the wedged frame renders inline "
                        "on that rank's row")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser(
        "migrate", help="convert a reference-format snapshot to native format"
    )
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--rank", type=int, default=0)
    p.set_defaults(fn=cmd_migrate)

    p = sub.add_parser(
        "consolidate",
        help="materialize an incremental snapshot as a self-contained one",
    )
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_consolidate)

    p = sub.add_parser("diff", help="compare two snapshots leaf by leaf")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also list unchanged/indeterminate leaves")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser(
        "deps", help="origin graph of a directory of snapshots"
    )
    p.add_argument("dir")
    p.set_defaults(fn=cmd_deps)

    p = sub.add_parser(
        "prune",
        help="keep the newest N snapshots (and bases they require); "
             "delete the rest",
    )
    p.add_argument("dir")
    p.add_argument("--keep", type=int, required=True,
                   help="number of newest snapshots to keep")
    p.add_argument("--yes", action="store_true",
                   help="actually delete (default: print the plan)")
    p.add_argument("--ignore-missing-bases", action="store_true",
                   help="delete even when kept snapshots reference bases "
                        "that resolve to nothing in this directory")
    p.set_defaults(fn=cmd_prune)

    p = sub.add_parser(
        "store-status",
        help="probe a coordination-store node: leader addr/epoch, "
             "replica lag, lease age",
    )
    p.add_argument("addr", help='store node address, "host:port"')
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_store_status)

    p = sub.add_parser(
        "georep-status",
        help="report the geo-replication plane of a snapshot ROOT: "
             "remote cursor position, last applied generation, backlog "
             "epochs, measured lag (exit 0 caught up / 1 behind / "
             "2 cannot-check)",
    )
    p.add_argument("path", help="snapshot ROOT directory (the primary)")
    p.add_argument("--remote", default=None,
                   help="remote tier root URL (default "
                        "TORCHSNAPSHOT_GPU_GEOREP)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_georep_status)

    p = sub.add_parser(
        "lint",
        help="run the tsalint static analyzer over the package "
             "(concurrency, finalizer-context, resource-lifecycle, "
             "env-registry, and the five legacy invariant lints)",
    )
    analysis_runner.add_lint_arguments(p)
    p.set_defaults(fn=analysis_runner.cli_main)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
