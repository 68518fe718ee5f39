"""Incremental snapshots: skip storage writes for unchanged payloads.

Counterpart of ``torchsnapshot_tpu/dedup.py`` (lines 1-230). When
``Snapshot.take(..., incremental_base=...)`` names a previous snapshot,
each payload's content digest (SHA-256 of the exact staged bytes) is
compared with the digest the base recorded for the payload at the same
storage location. On a match the write is skipped and the manifest entry
records ``origin``, the snapshot that physically holds the bytes. Origins
resolve transitively: a payload written once is referenced directly, however
many increments follow.

With ``device_digests`` the comparison happens before the device-to-host
copy, on the fingerprint of ``device_digest.py``, so an unchanged CUDA
tensor is neither copied nor written.

Matching is by storage location, a function of the logical path, the
replication class and the chunk box. Restore reads an entry with ``origin``
from that snapshot's storage, so deleting a base breaks the increments
built on it; ``retention.py`` keeps every base a survivor needs.

Not ported yet: ``consolidate`` and the journal compaction (they wait for
the journal).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from .integrity import checksums_enabled, compute_checksum
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ObjectEntry, SnapshotMetadata

DIGEST_ALGO = "sha256"


def canonical_base_url(url: str) -> str:
    """Canonical form of a base-snapshot URL for recording as an origin:
    origins are resolved later from other working directories, so
    filesystem paths become their real absolute path; remote URLs pass
    through verbatim."""
    if url.startswith("fs://"):
        return "fs://" + os.path.realpath(url[len("fs://"):])
    if "://" in url:
        return url
    return os.path.realpath(url)


def compute_digest(buf) -> str:
    h = hashlib.sha256()
    h.update(memoryview(buf).cast("B"))
    return f"{DIGEST_ALGO}:{h.hexdigest()}"


@dataclass(frozen=True)
class PayloadRef:
    """Where a base snapshot holds a payload, and what its content was.

    ``checksum`` and ``codec`` describe the base's stored bytes: a match
    skips the write, so restore reads the base's payload and the new entry
    records the stored form's checksum."""

    digest: str
    origin: str  # snapshot URL that physically holds the bytes
    nbytes: Optional[int]
    checksum: Optional[str] = None
    codec: Optional[str] = None
    location: Optional[str] = None  # where the bytes live within the origin
    device_digest: Optional[str] = None  # the base's device fingerprint


def _iter_payload_entries(entry: Entry) -> Iterator[ArrayEntry]:
    if isinstance(entry, ArrayEntry):
        yield entry
    elif isinstance(entry, ChunkedArrayEntry):
        for chunk in entry.chunks:
            yield chunk.array


class DedupContext:
    """Digest recording and (optionally) a base snapshot's payload index.

    Active during a take's planning through :func:`dedup_staging`; stagers
    capture it at construction and consult it at stage time."""

    def __init__(
        self,
        base_path: Optional[str],
        refs: Dict[str, PayloadRef],
        device_digests: bool = False,
    ):
        self.base_path = base_path
        self.refs = refs
        # Content-address fallback index: the first ref per digest wins
        # (interchangeable by construction: digest and size verified).
        self.by_digest: Dict[str, PayloadRef] = {}
        for ref in refs.values():
            self.by_digest.setdefault(ref.digest, ref)
        # When True, stagers fingerprint tensors (device_digest.py) and skip
        # the device-to-host copy on a base match; the fingerprint is also
        # recorded so later takes can match.
        self.device_digests = device_digests

    @classmethod
    def recording_only(cls, device_digests: bool = False) -> "DedupContext":
        return cls(base_path=None, refs={}, device_digests=device_digests)

    @classmethod
    def from_base(
        cls,
        base_path: str,
        metadata: SnapshotMetadata,
        device_digests: bool = False,
    ) -> "DedupContext":
        """Index every digest-carrying payload of ``metadata`` by location.
        Origins resolve transitively: a payload the base itself borrowed
        points straight at the older snapshot."""
        from .serialization import array_size_bytes

        refs: Dict[str, PayloadRef] = {}
        for entry in metadata.manifest.values():
            for p in _iter_payload_entries(entry):
                if p.digest is None or p.byte_range is not None:
                    # Slab-packed payloads live at locations a new take
                    # never produces.
                    continue
                try:
                    nbytes: Optional[int] = array_size_bytes(p.shape, p.dtype)
                except ValueError:
                    nbytes = None
                refs.setdefault(
                    p.location,
                    PayloadRef(
                        digest=p.digest,
                        origin=p.origin or base_path,
                        nbytes=nbytes,
                        checksum=p.checksum,
                        codec=p.codec,
                        device_digest=p.device_digest,
                        location=p.location,
                    ),
                )
            if isinstance(entry, ObjectEntry) and entry.digest is not None:
                refs.setdefault(
                    entry.location,
                    PayloadRef(
                        digest=entry.digest,
                        origin=entry.origin or base_path,
                        nbytes=entry.size,
                        checksum=entry.checksum,
                        codec=entry.codec,
                        location=entry.location,
                    ),
                )
        return cls(base_path=base_path, refs=refs, device_digests=device_digests)

    def reuse_staged(self, entry, buf) -> bool:
        """Record the SHA-256 digest of ``entry``'s staged bytes ``buf``;
        when the base holds the same bytes, point ``entry`` at them and
        return True: the write is skipped. The entry takes the base's stored
        checksum and codec, which restore will read; a raw base saved
        without checksums stores exactly ``buf``, so its checksum is
        computed here. Slab-batched payloads (``byte_range``) never dedup."""
        entry.digest = compute_digest(buf)
        if getattr(entry, "byte_range", None) is not None:
            return False
        ref = self.match(entry.location, entry.digest, memoryview(buf).nbytes)
        if ref is None:
            return False
        entry.origin = ref.origin
        entry.codec = ref.codec
        if ref.location is not None:
            entry.location = ref.location
        if ref.checksum is None and ref.codec is None:
            if checksums_enabled():
                entry.checksum = compute_checksum(buf)
        else:
            entry.checksum = ref.checksum
        return True

    def match(self, location: str, digest: str, nbytes: int) -> Optional[PayloadRef]:
        ref = self.refs.get(location)
        if ref is None or ref.digest != digest:
            # Content-address fallback: the same bytes under another
            # location still dedup on digest and size.
            ref = self.by_digest.get(digest)
            if ref is None:
                return None
        if ref.nbytes is not None and ref.nbytes != nbytes:
            return None  # digest collision paranoia: sizes must agree
        return ref


_dedup_context: contextvars.ContextVar[Optional[DedupContext]] = contextvars.ContextVar(
    "tsnap_gpu_dedup_context", default=None
)


def active_dedup_context() -> Optional[DedupContext]:
    return _dedup_context.get()


@contextlib.contextmanager
def dedup_staging(ctx: Optional[DedupContext]):
    """Stagers prepared inside this block capture ``ctx``."""
    token = _dedup_context.set(ctx)
    try:
        yield
    finally:
        _dedup_context.reset(token)
