"""Tenant registry: leased rows on the replicated coordination store.

Counterpart of the JAX package's ``tenancy/registry.py`` (the rows are
byte-compatible). Mirrors the seed-registry schema (dist_store.py): ``tsnap/tenants/r/
<id>`` is one tenant's row (priority, quota, root prefix, registering
pid, registration seq); ``tsnap/tenants/dead/<id>`` is the ghost-key
death notice — published when a tenant's last session deregisters (or
by the store's liveness machinery when its connection drops), so
readers can tell "row from a live tenant" from "row a dead job left
behind" without a lease clock. The registry is deliberately GLOBAL
(never namespaced): arbitration planes — admission shares, pool
refcounts — need to see every tenant.

Works against anything with the store verbs (``set``/``get``/
``check``/``delete``/``collect``) — the replicated TCPStore in
production, a dict-backed fake in tests.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

from . import Tenant

logger = logging.getLogger(__name__)

TENANT_PREFIX = "tsnap/tenants/"
TENANT_ROW_PREFIX = TENANT_PREFIX + "r/"
TENANT_DEAD_PREFIX = TENANT_PREFIX + "dead/"
TENANT_SEQ_KEY = TENANT_PREFIX + "seq"


def register(store: Any, tenant: Tenant) -> None:
    """Publish (idempotently — re-registration refreshes the row and
    clears any death notice) ``tenant``'s row."""
    try:
        seq = store.add(TENANT_SEQ_KEY, 1)
    except Exception:  # noqa: BLE001 - fakes without add()
        seq = 0
    row = json.dumps(
        {
            "priority": tenant.priority,
            "quota_bytes": tenant.quota_bytes,
            "root_prefix": tenant.root_prefix,
            "pid": os.getpid(),
            "seq": seq,
        }
    )
    store.set(TENANT_ROW_PREFIX + tenant.id, row.encode("utf-8"))
    try:
        if store.check(TENANT_DEAD_PREFIX + tenant.id):
            store.delete(TENANT_DEAD_PREFIX + tenant.id)
    except Exception:  # noqa: BLE001
        pass


def deregister(store: Any, tenant_id: str) -> None:
    """Plant the ghost key. The row itself stays (cheap, and a reader
    may still need the quota/priority of a recently dead tenant) —
    liveness is the dead-key's absence, exactly the seed-holder rule."""
    try:
        store.set(TENANT_DEAD_PREFIX + tenant_id, b"1")
    except Exception:  # noqa: BLE001
        logger.debug("tenant deregister skipped", exc_info=True)


def lookup(store: Any, tenant_id: str) -> Optional[Dict[str, Any]]:
    key = TENANT_ROW_PREFIX + tenant_id
    try:
        if not store.check(key):
            return None
        row = json.loads(bytes(store.get(key)).decode("utf-8"))
    except Exception:  # noqa: BLE001
        return None
    return row if isinstance(row, dict) else None


def live_tenants(store: Any) -> Dict[str, Dict[str, Any]]:
    """All registered tenants minus the ghost-marked dead ones."""
    try:
        _, rows = store.collect(TENANT_ROW_PREFIX, 0, timeout=5.0)
        _, dead = store.collect(TENANT_DEAD_PREFIX, 0, timeout=5.0)
    except Exception:  # noqa: BLE001
        return {}
    dead_ids = {k[len(TENANT_DEAD_PREFIX):] for k in dead}
    out: Dict[str, Dict[str, Any]] = {}
    for key, raw in rows.items():
        tid = key[len(TENANT_ROW_PREFIX):]
        if tid in dead_ids:
            continue
        try:
            row = json.loads(bytes(raw).decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(row, dict):
            out[tid] = row
    return out
