"""Retention planning for snapshot directories.

Counterpart of ``torchsnapshot_tpu/retention.py``. Given the snapshots the
caller wants to keep, compute which others must be spared anyway (the
transitive bases of kept incremental snapshots: deleting one would break
restore) and which are safe to delete. Base matching compares the payload
checksums the manifests recorded, not paths or names: an unrelated
snapshot that now occupies a base's old path is never spared in its place.
A base that cannot be resolved is reported, and nothing that depends on it
is deleted.

A directory "snapshot" is a subdirectory holding a committed
``.snapshot_metadata``; ordering is by metadata mtime, name-tiebroken.

The scan helpers are the port's own copies of the JAX package's
``cli.py`` helpers (``_canon_snapshot_url`` :1175, ``_scan_snapshot_dir``
:1241, ``_load_metadata`` :199, ``_entry_payloads`` :152); the CLI itself
is not ported yet. Origins in the cross-tenant payload pool
(``tenancy/pool.py``) are protected by the pool's refcounts, not by sparing
snapshots.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ObjectEntry, SnapshotMetadata
from .serialization import array_size_bytes

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"

# The shared content-addressed payload pool's directory name (mirrored
# from tenancy.pool to avoid a package cycle).
POOL_DIRNAME = ".tsnap_pool"


def _canon_snapshot_url(url: str) -> str:
    """Canonical comparable form of a snapshot path or URL (``fs://`` and
    bare paths alike; realpath, so symlinked directories compare equal)."""
    if url.startswith("fs://"):
        url = url[len("fs://"):]
    if "://" in url:
        return url  # remote URL: compare verbatim
    return os.path.realpath(url)


def _load_metadata(path: str) -> SnapshotMetadata:
    from .snapshot import Snapshot

    return Snapshot(path).metadata


def _array_nbytes(entry: ArrayEntry) -> Optional[int]:
    if entry.byte_range is not None:
        return entry.byte_range[1] - entry.byte_range[0]
    try:
        return array_size_bytes(entry.shape, entry.dtype)
    except ValueError:
        return None


def _entry_payloads(
    entry: Entry,
) -> List[Tuple[str, Optional[List[int]], Optional[str], Optional[int], Optional[str]]]:
    """``(location, byte_range, checksum, nbytes, origin)`` per payload the
    entry owns; ``origin`` is the base snapshot holding the bytes when an
    incremental take reused them."""
    if isinstance(entry, ArrayEntry):
        arrays = [entry]
    elif isinstance(entry, ChunkedArrayEntry):
        arrays = [c.array for c in entry.chunks]
    elif isinstance(entry, ObjectEntry):
        return [(entry.location, None, entry.checksum, entry.size, entry.origin)]
    else:
        return []
    return [(a.location, a.byte_range, a.checksum, _array_nbytes(a), a.origin) for a in arrays]


def _scan_snapshot_dir(dirpath: str):
    """``(names sorted by metadata mtime, {name: origin set}, {name: {origin:
    {location: (checksum, nbytes)}}}, {name: {own location: (checksum,
    nbytes)}})`` for the committed snapshots directly under ``dirpath``."""
    names = sorted(
        (
            name
            for name in os.listdir(dirpath)
            if os.path.isfile(os.path.join(dirpath, name, SNAPSHOT_METADATA_FNAME))
        ),
        # Name tiebreaker: mtimes can collide; decisions must be deterministic.
        key=lambda n: (os.path.getmtime(os.path.join(dirpath, n, SNAPSHOT_METADATA_FNAME)), n),
    )
    origins_of: Dict[str, Set[str]] = {}
    origin_locations_of: Dict[str, Dict[str, Dict[str, Tuple]]] = {}
    payloads_of: Dict[str, Dict[str, Tuple]] = {}
    for name in names:
        meta = _load_metadata(os.path.join(dirpath, name))
        origins: Set[str] = set()
        locations: Dict[str, Dict[str, Tuple]] = {}
        own: Dict[str, Tuple] = {}
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


@dataclass
class RetentionPlan:
    """What survives and what may be deleted under a retention policy."""

    keep: List[str]  # caller-requested survivors
    spared: List[Tuple[str, bool]]  # (name, matched_by_basename)
    doomed: List[str]  # deletable, oldest first
    # Origins of kept snapshots that resolve to no verified snapshot in the
    # directory: deletion cannot be proven safe while these exist.
    unresolved: Set[str] = field(default_factory=set)


KeepPolicy = Union[int, Callable[[Sequence[str]], Set[str]]]


def plan_retention(dirpath: str, keep: KeepPolicy) -> RetentionPlan:
    """Plan deletion of the snapshots under ``dirpath`` that ``keep`` does
    not keep and that no kept snapshot needs, transitively, as a base.

    ``keep`` is the number of newest snapshots to keep, or a callable that
    receives the scanned names (mtime-ascending) and returns the set to
    keep. The policy runs on the same scan the plan is built from, so a
    snapshot committing concurrently is in both or in neither."""
    names, origins_of, origin_locations_of, payloads_of = _scan_snapshot_dir(dirpath)
    if callable(keep):
        keep = set(keep(names)) & set(names)
    else:
        keep = set(names[-int(keep):]) if keep else set()
    canon_of = {name: _canon_snapshot_url(os.path.join(dirpath, name)) for name in names}
    name_of_canon = {c: n for n, c in canon_of.items()}

    # A spared base's own payloads may reference yet another snapshot: the
    # required set is a transitive closure, walked with a worklist.
    required: Set[str] = set()
    by_name_matches: Set[str] = set()
    unresolved: Set[str] = set()
    frontier = list(keep)
    visited: Set[str] = set()
    while frontier:
        name = frontier.pop()
        if name in visited:
            continue
        visited.add(name)
        for origin in origins_of.get(name, ()):
            canon = _canon_snapshot_url(origin)
            if os.path.basename(canon.rstrip("/")) == POOL_DIRNAME:
                # Pooled payloads are protected by their own refcounts (the
                # manager releases a doomed step's refs before deletion);
                # the pool is not a snapshot, and resolving it here would
                # flag every swept chain unresolved and freeze retention.
                continue
            locations = origin_locations_of.get(name, {}).get(origin, {})

            def holds_payloads(candidate: str) -> bool:
                # Identity by the content checksums the kept snapshot's
                # reused entries recorded, checked against the candidate's
                # own manifest; checksum-less snapshots fall back to size
                # and the file's existence.
                cand = payloads_of.get(candidate, {})
                if not locations:
                    return False
                for loc, (csum, nbytes) in locations.items():
                    have = cand.get(loc)
                    if have is None:
                        return False
                    have_csum, have_nbytes = have
                    if csum is not None and have_csum is not None:
                        if csum != have_csum:
                            return False
                    elif nbytes is not None and have_nbytes is not None and nbytes != have_nbytes:
                        return False
                    if not os.path.isfile(os.path.join(dirpath, candidate, loc)):
                        return False
                return True

            base = name_of_canon.get(canon)
            if base is not None and not holds_payloads(base):
                base = None
            if base is None:
                # Origins record absolute realpaths at take time: after a
                # tree move they resolve to nothing here, and a
                # same-basename snapshot holding the payloads is the base.
                tail = os.path.basename(canon.rstrip("/"))
                if tail in origins_of and holds_payloads(tail):
                    base = tail
                    by_name_matches.add(tail)
            if base is None:
                unresolved.add(canon)
                continue
            required.add(base)
            if base not in visited:
                frontier.append(base)

    spared: List[Tuple[str, bool]] = []
    doomed: List[str] = []
    for name in names:
        if name in keep:
            continue
        if name in required:
            spared.append((name, name in by_name_matches))
        else:
            doomed.append(name)
    return RetentionPlan(keep=sorted(keep), spared=spared, doomed=doomed, unresolved=unresolved)


def apply_retention(dirpath: str, plan: RetentionPlan) -> int:
    """Delete the plan's doomed snapshots; returns how many. The caller
    decides what to do about ``plan.unresolved``."""
    for name in plan.doomed:
        shutil.rmtree(os.path.join(dirpath, name))
    return len(plan.doomed)
