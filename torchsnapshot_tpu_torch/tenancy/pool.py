"""Cross-tenant content-addressed payload pool with per-tenant refcounts
(counterpart of the JAX package's ``tenancy/pool.py``: the same pool
layout, refcount marker files and ``tsnap/pool/refs/`` rows).

Two tenants checkpointing the same base model (the dominant service
workload: N fine-tunes of one foundation checkpoint) store byte-identical
base payloads. The dedup machinery (dedup.py) already content-addresses
every payload at stage time (``digest``); this module turns that
transfer key into a STORAGE key:

- after a tenant's snapshot commits, rank 0 sweeps its eligible payloads
  (digest recorded, no origin, whole-file, uncompressed) into
  ``<shared_root>/.tsnap_pool/po/<hexdigest>`` — hardlink where the
  filesystem allows, copy otherwise, idempotent under concurrent
  sweepers (tmp + rename; first writer wins, the bytes are identical by
  construction);
- each referencing (tenant, step) leaves a marker file under
  ``.tsnap_pool/refs/<hexdigest>/<tenant>__<step>`` — the refcount is
  the marker count, durable next to the payload it protects (and
  mirrored to the store under ``tsnap/pool/refs/`` when one is
  reachable, for service dashboards);
- the swept snapshot's manifest is atomically rewritten to point each
  entry at the pool (``origin`` = pool root, ``location`` =
  ``po/<hex>``) — the standard incremental-restore origin read path,
  no new restore machinery;
- retention releases a step's markers BEFORE deleting it; the payload
  itself is unlinked only at refcount zero.

Crash safety: the sweep orders pool-link → ref-marker → metadata
rewrite → original unlink. A crash at any point leaves a restorable
snapshot (both copies may temporarily exist; the orphan is reclaimed by
the next sweep or fsck's orphan finding, never load-bearing).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Iterable, List, Optional, Tuple

from ..manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
)

logger = logging.getLogger(__name__)

POOL_DIRNAME = ".tsnap_pool"
POOL_STORE_PREFIX = "tsnap/pool/refs/"

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


def pool_root(shared_root: str) -> str:
    return os.path.join(shared_root, POOL_DIRNAME)


def _ref_key(tenant_id: str, step_name: str) -> str:
    return f"{tenant_id}__{step_name}"


def _load_metadata(step_dir: str) -> Tuple[SnapshotMetadata, bool]:
    """(metadata, is_columnar) from a committed local step directory."""
    with open(os.path.join(step_dir, SNAPSHOT_METADATA_FNAME), "rb") as f:
        raw = f.read()
    if raw[:4] == b"TSCM":
        from .. import colmanifest

        return colmanifest.decode_metadata(raw), True
    return SnapshotMetadata.from_yaml(raw.decode("utf-8")), False


def _store_metadata(step_dir: str, md: SnapshotMetadata, columnar: bool) -> None:
    """Atomic in-place metadata rewrite (tmp + rename), preserving the
    snapshot's on-disk format."""
    if columnar:
        from .. import colmanifest

        raw = colmanifest.encode_metadata(md)
    else:
        raw = md.to_yaml().encode("utf-8")
    tmp = os.path.join(step_dir, f".{SNAPSHOT_METADATA_FNAME}.pool.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(step_dir, SNAPSHOT_METADATA_FNAME))


def _iter_leaves(md: SnapshotMetadata) -> Iterable[ArrayEntry]:
    for entry in md.manifest.values():
        if isinstance(entry, ArrayEntry):
            yield entry
        elif isinstance(entry, ShardedArrayEntry):
            for s in entry.shards:
                yield s.array
        elif isinstance(entry, ChunkedArrayEntry):
            for s in entry.chunks:
                yield s.array


def _eligible(leaf: ArrayEntry) -> bool:
    # Whole-file, uncompressed, locally-held payloads only: the digest
    # must be the content address of the STORED bytes for the pool key
    # to be collision-meaningful (codec'd files store transformed bytes;
    # byte-ranged entries share a slab file; origin'd entries hold no
    # bytes here at all).
    return (
        leaf.digest is not None
        and leaf.origin is None
        and leaf.byte_range is None
        and leaf.codec is None
    )


def _digest_hex(digest: str) -> Optional[str]:
    algo, sep, hexd = digest.partition(":")
    if not sep or not hexd or not all(c in "0123456789abcdef" for c in hexd):
        return None
    return f"{algo}_{hexd}"


def _link_or_copy(src: str, dst: str) -> None:
    tmp = f"{dst}.tmp.{os.getpid()}"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copy2(src, tmp)
    try:
        os.replace(tmp, dst)
    except OSError:
        # A concurrent sweeper won the rename race; identical content.
        try:
            os.unlink(tmp)
        except OSError:
            pass


def add_ref(
    shared_root: str,
    tenant_id: str,
    step_name: str,
    hexd: str,
    store: Any = None,
) -> None:
    refs_dir = os.path.join(pool_root(shared_root), "refs", hexd)
    os.makedirs(refs_dir, exist_ok=True)
    marker = os.path.join(refs_dir, _ref_key(tenant_id, step_name))
    with open(marker, "w"):
        pass
    if store is not None:
        try:
            store.set(
                f"{POOL_STORE_PREFIX}{hexd}/{_ref_key(tenant_id, step_name)}",
                b"1",
            )
        except Exception:  # noqa: BLE001 - the fs marker is the truth
            pass


def sweep_step(
    shared_root: str,
    tenant_id: str,
    step_dir: str,
    store: Any = None,
) -> Tuple[int, int]:
    """Deduplicate one committed step's eligible payloads into the pool.

    Returns ``(bytes_released, payloads_pooled)`` — bytes_released is
    the size of original payload files replaced by pool references
    (shared bytes a second tenant no longer pays for).
    """
    step_name = os.path.basename(step_dir.rstrip("/"))
    md, columnar = _load_metadata(step_dir)
    proot = pool_root(shared_root)
    payload_dir = os.path.join(proot, "po")
    pooled: List[Tuple[str, str]] = []  # (original payload path, hexd)
    abs_proot = os.path.abspath(proot)
    for leaf in _iter_leaves(md):
        # A leaf that dedup'd against a pool-swept base already points at
        # the pool (origin = pool root, location = po/<hex>). It holds no
        # bytes to move, but THIS step now depends on the pooled payload:
        # without its own ref marker, evicting the step that originally
        # pooled the bytes would reclaim them out from under this one.
        if (
            leaf.origin is not None
            and os.path.abspath(leaf.origin) == abs_proot
            and leaf.location.startswith("po/")
        ):
            add_ref(
                shared_root,
                tenant_id,
                step_name,
                leaf.location[len("po/"):],
                store=store,
            )
            continue
        if not _eligible(leaf):
            continue
        hexd = _digest_hex(leaf.digest)
        if hexd is None:
            continue
        src = os.path.join(step_dir, leaf.location)
        if not os.path.isfile(src):
            continue
        os.makedirs(payload_dir, exist_ok=True)
        dst = os.path.join(payload_dir, hexd)
        if os.path.exists(dst):
            if os.path.getsize(dst) != os.path.getsize(src):
                # Digest collision or out-of-band damage: never alias.
                logger.warning(
                    "pool payload %s size mismatch vs %s; not pooling",
                    dst,
                    src,
                )
                continue
        else:
            _link_or_copy(src, dst)
        add_ref(shared_root, tenant_id, step_name, hexd, store=store)
        leaf.origin = os.path.abspath(proot)
        leaf.location = f"po/{hexd}"
        pooled.append((src, hexd))
    if not pooled:
        return 0, 0
    # Commit the rewrite BEFORE dropping originals: a crash between the
    # two leaves both copies (restorable), never neither.
    _store_metadata(step_dir, md, columnar)
    released = 0
    for src, _ in pooled:
        try:
            released += os.path.getsize(src)
            os.unlink(src)
        except OSError:
            pass
    return released, len(pooled)


def release_steps(
    shared_root: str,
    tenant_id: str,
    step_names: Iterable[str],
    store: Any = None,
) -> int:
    """Drop ``(tenant, step)`` refs; unlink payloads that hit refcount
    zero. Returns bytes freed from the pool."""
    refs_root = os.path.join(pool_root(shared_root), "refs")
    if not os.path.isdir(refs_root):
        return 0
    names = list(step_names)
    freed = 0
    for hexd in os.listdir(refs_root):
        refs_dir = os.path.join(refs_root, hexd)
        if not os.path.isdir(refs_dir):
            continue
        for step_name in names:
            marker = os.path.join(refs_dir, _ref_key(tenant_id, step_name))
            try:
                os.unlink(marker)
            except OSError:
                continue
            if store is not None:
                try:
                    store.delete(
                        f"{POOL_STORE_PREFIX}{hexd}/"
                        f"{_ref_key(tenant_id, step_name)}"
                    )
                except Exception:  # noqa: BLE001
                    pass
        if not os.listdir(refs_dir):
            payload = os.path.join(pool_root(shared_root), "po", hexd)
            try:
                freed += os.path.getsize(payload)
                os.unlink(payload)
            except OSError:
                pass
            try:
                os.rmdir(refs_dir)
            except OSError:
                pass
    return freed


def ref_count(shared_root: str, hexd: str) -> int:
    refs_dir = os.path.join(pool_root(shared_root), "refs", hexd)
    try:
        return len(os.listdir(refs_dir))
    except OSError:
        return 0


def pool_bytes(shared_root: str) -> int:
    """Total payload bytes currently held by the pool."""
    payload_dir = os.path.join(pool_root(shared_root), "po")
    try:
        return sum(
            os.path.getsize(os.path.join(payload_dir, n))
            for n in os.listdir(payload_dir)
        )
    except OSError:
        return 0
