"""Multi-tenant checkpoint service layer (counterpart of the JAX
package's ``tenancy/``; tenant rows, pool refcount files and the
``tsnap/t/<tenant>/`` key scoping are byte-compatible with it).

The library's primitives (``Snapshot.take/restore``, the replicated
coordination store, the seeding tier) assume ONE job per bucket + store.
A checkpoint *service* multiplexes many: two jobs sharing a bucket must
not collide on step names, starve each other's I/O, or pay twice for
identical base payloads. This package is the isolation layer between
``CheckpointManager``/``Snapshot`` and the storage plugins +
coordination store:

- :class:`Tenant` — the namespace handle: id, per-tenant storage root
  prefix, byte quota, admission priority.
- key scoping — every ``tsnap/...`` coordination key a tenant-scoped op
  touches (health heartbeats, seed catalog/holders, journal update
  rows) moves under ``tsnap/t/<tenant>/...`` via
  :class:`NamespacedStore`, so two tenants' fleets on one store never
  read each other's rows. Cross-tenant planes (the tenant registry,
  the admission table, pool refcounts) stay deliberately global.
- :mod:`~torchsnapshot_tpu_torch.tenancy.registry` — leased tenant rows on
  the replicated store (ghost-key death rule, like the seed registry).
- :mod:`~torchsnapshot_tpu_torch.tenancy.quota` — byte-budget retention +
  pre-I/O admission of saves (``QuotaExceededError`` before payload
  I/O, never a torn partial).
- :mod:`~torchsnapshot_tpu_torch.tenancy.pool` — the cross-tenant
  content-addressed payload pool with per-tenant refcounts.
- :mod:`~torchsnapshot_tpu_torch.tenancy.admission` — priority-weighted
  bandwidth shares enforced at the scheduler's I/O-slot acquisition.

A tenant is threaded explicitly (``CheckpointManager(tenant=...)``) or
ambiently (``TORCHSNAPSHOT_GPU_TENANT``). The no-tenant path costs one
env check and changes nothing — single-job deployments keep the exact
pre-tenancy behavior.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

TENANT_ENV_VAR = "TORCHSNAPSHOT_GPU_TENANT"
QUOTA_ENV_VAR = "TORCHSNAPSHOT_GPU_QUOTA_BYTES"

# Tenant ids appear in storage paths AND store keys: path-safe charset,
# no separators that could escape the namespace.
_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

# Coordination keys live under this root (health.py, dist_store.py,
# forensics.py all prefix "tsnap/"); tenant-scoped copies move to
# "tsnap/t/<id>/...".
_STORE_ROOT = "tsnap/"
_SCOPED_ROOT_FMT = "tsnap/t/{tid}/"


@dataclass(frozen=True)
class Tenant:
    """One tenant's namespace handle.

    ``root_prefix`` is the storage subtree (relative to the shared
    bucket root) all of this tenant's steps live under — defaults to
    ``tenants/<id>``. ``quota_bytes`` caps the tenant's committed bytes
    (None = unlimited); ``priority`` weights its admission share
    against concurrently active tenants (higher = larger share).
    """

    id: str
    root_prefix: str = ""
    quota_bytes: Optional[int] = None
    priority: int = 1

    def __post_init__(self) -> None:
        if not _TENANT_ID_RE.match(self.id):
            raise ValueError(
                f"tenant id {self.id!r} must match {_TENANT_ID_RE.pattern}"
                " (it names storage directories and store keys)"
            )
        if not self.root_prefix:
            object.__setattr__(self, "root_prefix", f"tenants/{self.id}")
        if self.root_prefix.startswith(("/", "../")) or "/../" in self.root_prefix:
            raise ValueError(
                f"tenant root_prefix {self.root_prefix!r} must stay under "
                "the shared root"
            )
        if self.quota_bytes is not None and self.quota_bytes <= 0:
            raise ValueError("quota_bytes must be positive (or None)")
        if self.priority < 1:
            raise ValueError("priority must be >= 1")


def tenant_from_env() -> Optional[Tenant]:
    """The ambient tenant (``TORCHSNAPSHOT_GPU_TENANT``), else None.

    ``TORCHSNAPSHOT_GPU_QUOTA_BYTES`` supplies the quota for env-derived
    tenants. This is the ONE check the disabled path pays: unset env →
    None → every tenancy hook is a no-op.
    """
    tid = os.environ.get(TENANT_ENV_VAR, "").strip()
    if not tid:
        return None
    quota_raw = os.environ.get(QUOTA_ENV_VAR, "").strip()
    quota = None
    if quota_raw:
        try:
            quota = int(quota_raw)
        except ValueError:
            quota = None
    return Tenant(id=tid, quota_bytes=quota)


# Active tenant for THIS thread/context: set by CheckpointManager around
# each op so key-construction sites (heartbeat prefixes, seed-registry
# store acquisition) resolve the right namespace on the calling thread.
# Deliberately NOT inherited by worker threads — scoped objects capture
# their prefix at construction instead (contextvars don't propagate to
# new threads).
_ACTIVE: "contextvars.ContextVar[Optional[Tenant]]" = contextvars.ContextVar(
    "tsnap_tenant", default=None
)


def current_tenant() -> Optional[Tenant]:
    """The activated tenant, else the env-derived one, else None."""
    t = _ACTIVE.get()
    return t if t is not None else tenant_from_env()


@contextlib.contextmanager
def activated(tenant: Optional[Tenant]) -> Iterator[None]:
    """Make ``tenant`` the active one for the calling thread's scope."""
    token = _ACTIVE.set(tenant)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def tenant_root(shared_root: str, tenant: Tenant) -> str:
    """The tenant's storage root under ``shared_root`` (URL-safe join)."""
    sep = "" if shared_root.endswith("/") else "/"
    return f"{shared_root}{sep}{tenant.root_prefix}"


def scope_key(key: str, tenant_id: str) -> str:
    """Move a ``tsnap/...`` coordination key under the tenant namespace;
    non-tsnap keys (path-derived barrier prefixes are already disjoint
    across tenant roots) pass through untouched."""
    if key.startswith(_STORE_ROOT):
        return _SCOPED_ROOT_FMT.format(tid=tenant_id) + key[len(_STORE_ROOT):]
    return key


class NamespacedStore:
    """Store wrapper prefixing every ``tsnap/...`` key with the tenant
    namespace — the single chokepoint that scopes the health, seed, and
    journal keyspaces without touching their key codecs.

    ``collect`` translates in BOTH directions (scoped prefix out,
    unscoped keys back) so callers that slice ``key[len(prefix):]``
    keep working. ``clone`` preserves the wrapper (heartbeat publishers
    clone their connection onto a background thread)."""

    def __init__(self, store: Any, tenant_id: str) -> None:
        self._store = store
        self._tenant_id = tenant_id

    def _k(self, key: str) -> str:
        return scope_key(key, self._tenant_id)

    def set(self, key: str, value: Any) -> None:
        self._store.set(self._k(key), value)

    def get(self, key: str) -> Any:
        return self._store.get(self._k(key))

    def add(self, key: str, amount: int) -> int:
        return self._store.add(self._k(key), amount)

    def check(self, key: str) -> bool:
        return self._store.check(self._k(key))

    def delete(self, key: str) -> Any:
        return self._store.delete(self._k(key))

    def collect(
        self, prefix: str, count: int, timeout: Optional[float] = None, **kw: Any
    ) -> Tuple[int, Dict[str, Any]]:
        scoped = self._k(prefix)
        n, items = self._store.collect(scoped, count, timeout=timeout, **kw)
        if scoped == prefix:
            return n, items
        return n, {prefix + k[len(scoped):]: v for k, v in items.items()}

    def clone(self) -> "NamespacedStore":
        return NamespacedStore(self._store.clone(), self._tenant_id)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._store, name)


def maybe_scope_store(store: Any) -> Any:
    """Wrap ``store`` in the active tenant's namespace (no-op without a
    tenant, or when ``store`` is already scoped). Resolve ON THE CALLING
    THREAD — worker threads do not inherit the activation."""
    if store is None:
        return None
    tenant = current_tenant()
    if tenant is None or isinstance(store, NamespacedStore):
        return store
    return NamespacedStore(store, tenant.id)
