"""The port's multi-tenant checkpoint service (``tenancy/``): the
counterparts of ``tests/test_tenancy.py`` case for case, on torch state,
and the tenant rows, admission rows, key scoping and pool layout held
byte-equal against the JAX package.

The isolation contract under test: two CheckpointManagers with different
tenants sharing ONE bucket root and ONE coordination store must be fully
isolated — disjoint storage trees (``tenants/<id>/...``), disjoint
``tsnap/t/<id>/...`` store keyspaces — while the deliberately-global
planes (tenant registry, admission table, payload pool) arbitrate across
them. Quota raises BEFORE payload I/O; the pool stores identical base
payloads once with per-tenant refcounts; a SIGKILLed tenant never
corrupts its neighbor.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import StateDict, telemetry
from torchsnapshot_tpu_torch.manager import CheckpointManager
from torchsnapshot_tpu_torch.tenancy import (
    NamespacedStore,
    Tenant,
    activated,
    current_tenant,
    maybe_scope_store,
    pool,
    quota,
    registry,
    scope_key,
    tenant_root,
)
from torchsnapshot_tpu_torch.tenancy.admission import AdmissionSession, maybe_arm
from torchsnapshot_tpu_torch.tenancy.quota import (
    QuotaExceededError,
    QuotaUnenforceableError,
)
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _state(n: int = 1024, mult: float = 1.0) -> dict:
    return {"model": StateDict(w=torch.arange(n, dtype=torch.float32) * mult)}


def _steps(root: str, tid: str) -> list:
    d = os.path.join(root, "tenants", tid)
    if not os.path.isdir(d):
        return []
    return sorted(x for x in os.listdir(d) if x.startswith("step_"))


class FakeStore:
    """Dict-backed store honoring the verbs registry/scoping rely on."""

    def __init__(self, data=None):
        self.data = {} if data is None else data

    def set(self, key, value):
        self.data[key] = bytes(value)

    def get(self, key):
        return self.data[key]

    def add(self, key, amount):
        cur = int(self.data.get(key, b"0")) + amount
        self.data[key] = str(cur).encode()
        return cur

    def check(self, key):
        return key in self.data

    def delete(self, key):
        return self.data.pop(key, None)

    def collect(self, prefix, count, timeout=None, **kw):
        items = {k: v for k, v in self.data.items() if k.startswith(prefix)}
        return len(items), items

    def clone(self):
        return FakeStore(self.data)


# ------------------------------------------------------------- Tenant


class TestTenant:
    def test_default_root_prefix(self):
        t = Tenant(id="alpha")
        assert t.root_prefix == "tenants/alpha"
        assert tenant_root("/data/ckpt", t) == "/data/ckpt/tenants/alpha"

    @pytest.mark.parametrize(
        "bad", ["", "a/b", "../x", ".hidden", "-lead", "x" * 65]
    )
    def test_bad_ids_rejected(self, bad):
        with pytest.raises(ValueError):
            Tenant(id=bad)

    def test_escaping_root_prefix_rejected(self):
        with pytest.raises(ValueError):
            Tenant(id="a", root_prefix="../outside")
        with pytest.raises(ValueError):
            Tenant(id="a", root_prefix="/abs")
        with pytest.raises(ValueError):
            Tenant(id="a", root_prefix="x/../../y")

    def test_quota_and_priority_validated(self):
        with pytest.raises(ValueError):
            Tenant(id="a", quota_bytes=0)
        with pytest.raises(ValueError):
            Tenant(id="a", priority=0)

    def test_env_tenant(self, monkeypatch):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_TENANT", "envt")
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_QUOTA_BYTES", "12345")
        t = current_tenant()
        assert t is not None and t.id == "envt" and t.quota_bytes == 12345

    def test_activation_wins_over_env(self, monkeypatch):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_TENANT", "envt")
        with activated(Tenant(id="explicit")):
            assert current_tenant().id == "explicit"
        assert current_tenant().id == "envt"


# ---------------------------------------------------------- key scoping


class TestStoreScoping:
    def test_scope_key(self):
        assert scope_key("tsnap/health/0", "a") == "tsnap/t/a/health/0"
        assert scope_key("other/key", "a") == "other/key"

    def test_namespaced_store_verbs(self):
        raw = FakeStore()
        ns = NamespacedStore(raw, "alpha")
        ns.set("tsnap/health/0", b"beat")
        assert "tsnap/t/alpha/health/0" in raw.data
        assert ns.get("tsnap/health/0") == b"beat"
        assert ns.check("tsnap/health/0")
        assert ns.add("tsnap/seq", 2) == 2
        ns.delete("tsnap/health/0")
        assert not ns.check("tsnap/health/0")

    def test_collect_translates_back(self):
        raw = FakeStore()
        ns = NamespacedStore(raw, "alpha")
        ns.set("tsnap/health/0", b"x")
        ns.set("tsnap/health/1", b"y")
        NamespacedStore(raw, "beta").set("tsnap/health/0", b"z")
        n, items = ns.collect("tsnap/health/", 0)
        assert n == 2
        # callers slice key[len(prefix):] — they must see UNSCOPED keys
        assert sorted(items) == ["tsnap/health/0", "tsnap/health/1"]

    def test_maybe_scope_store(self):
        raw = FakeStore()
        assert maybe_scope_store(raw) is raw  # no tenant -> untouched
        with activated(Tenant(id="a")):
            ns = maybe_scope_store(raw)
            assert isinstance(ns, NamespacedStore)
            assert maybe_scope_store(ns) is ns  # never double-wraps

    def test_clone_preserves_namespace(self):
        ns = NamespacedStore(FakeStore(), "a").clone()
        assert isinstance(ns, NamespacedStore)

    def test_heartbeat_keys_tenant_scoped(self):
        from torchsnapshot_tpu_torch.telemetry.health import HeartbeatPublisher

        raw = FakeStore()
        with activated(Tenant(id="alpha")):
            pub = HeartbeatPublisher(raw, rank=0, op="take", path="/x")
        assert pub.prefix == "tsnap/t/alpha/health/"


# ------------------------------------------------------------ registry


class TestRegistry:
    def test_register_lookup_live(self):
        store = FakeStore()
        registry.register(store, Tenant(id="a", quota_bytes=9, priority=3))
        row = registry.lookup(store, "a")
        assert row["quota_bytes"] == 9 and row["priority"] == 3
        assert "a" in registry.live_tenants(store)

    def test_ghost_key_death_rule(self):
        store = FakeStore()
        registry.register(store, Tenant(id="a"))
        registry.deregister(store, "a")
        # row survives for post-mortem reads; liveness is gone
        assert registry.lookup(store, "a") is not None
        assert "a" not in registry.live_tenants(store)
        # re-registration resurrects (clears the ghost)
        registry.register(store, Tenant(id="a"))
        assert "a" in registry.live_tenants(store)

    def test_manager_registers_and_close_deregisters(self, tmp_path):
        from torchsnapshot_tpu_torch import distrib

        store = FakeStore()
        distrib.configure_registry(lambda: store)
        try:
            m = CheckpointManager(
                str(tmp_path), tenant=Tenant(id="alpha"), keep_last=2
            )
            m.save(0, _state())
            assert "alpha" in registry.live_tenants(store)
            m.close()
            assert "alpha" not in registry.live_tenants(store)
        finally:
            distrib.configure_registry(None)


# ----------------------------------------------- two-tenant isolation


class TestTwoTenantIsolation:
    def test_interleaved_ops_fully_isolated(self, tmp_path):
        """Interleaved saves/restores/retention across two tenants on
        one bucket: disjoint trees, independent retention, both always
        restorable, fsck-clean."""
        from torchsnapshot_tpu.cli import run_fsck

        root = str(tmp_path)
        ma = CheckpointManager(root, tenant=Tenant(id="alpha"), keep_last=2)
        mb = CheckpointManager(root, tenant=Tenant(id="beta"), keep_last=1)
        ma.save(0, _state(mult=1.0))
        mb.save(0, _state(mult=2.0))
        ma.save(1, _state(mult=1.5))
        mb.save(1, _state(mult=2.5))
        ma.save(2, _state(mult=1.75))  # alpha retention evicts step 0

        # retention ran per-tenant: alpha keeps 2, beta keeps 1
        assert _steps(root, "alpha") == ["step_0000000001", "step_0000000002"]
        assert _steps(root, "beta") == ["step_0000000001"]

        got_a = _state()
        ma.restore(got_a)
        np.testing.assert_array_equal(
            got_a["model"]["w"], torch.arange(1024, dtype=torch.float32) * 1.75
        )
        got_b = _state()
        mb.restore(got_b)
        np.testing.assert_array_equal(
            got_b["model"]["w"], torch.arange(1024, dtype=torch.float32) * 2.5
        )

        # every committed step fscks clean
        for tid in ("alpha", "beta"):
            for step in _steps(root, tid):
                code, report = run_fsck(
                    os.path.join(root, "tenants", tid, step)
                )
                assert code == 0, report.findings

        # storage-tree audit: nothing outside the tenant trees and the
        # shared pool
        for name in os.listdir(root):
            assert name in ("tenants", pool.POOL_DIRNAME), name
        assert sorted(os.listdir(os.path.join(root, "tenants"))) == [
            "alpha",
            "beta",
        ]

    def test_store_keyspace_disjoint(self):
        """The same ``tsnap/`` key written under two activations lands in
        two disjoint namespaces — and reads back per-tenant."""
        raw = FakeStore()
        with activated(Tenant(id="alpha")):
            maybe_scope_store(raw).set("tsnap/journal/seed", b"a-seed")
        with activated(Tenant(id="beta")):
            maybe_scope_store(raw).set("tsnap/journal/seed", b"b-seed")
        keys = sorted(raw.data)
        assert keys == [
            "tsnap/t/alpha/journal/seed",
            "tsnap/t/beta/journal/seed",
        ]
        with activated(Tenant(id="alpha")):
            assert maybe_scope_store(raw).get("tsnap/journal/seed") == b"a-seed"

    def test_same_step_numbers_do_not_collide(self, tmp_path):
        root = str(tmp_path)
        ma = CheckpointManager(root, tenant=Tenant(id="alpha"))
        mb = CheckpointManager(root, tenant=Tenant(id="beta"))
        ma.save(7, _state(mult=1.0))
        mb.save(7, _state(mult=9.0))
        got = _state()
        ma.restore(got)
        np.testing.assert_array_equal(
            got["model"]["w"], torch.arange(1024, dtype=torch.float32)
        )


# --------------------------------------------------------------- quota


class TestQuota:
    def test_eviction_makes_room(self, tmp_path):
        t = Tenant(id="q", quota_bytes=12_000)  # ~2.5 steps of ~4.4 KiB
        m = CheckpointManager(str(tmp_path), tenant=t, keep_last=10)
        for s in range(4):
            m.save(s, _state())
        # the gate runs BEFORE each save's payload I/O: at save 3 the
        # three committed steps exceeded the budget, so the oldest was
        # evicted first; newest always survive
        steps = _steps(str(tmp_path), "q")
        assert steps == [
            "step_0000000001",
            "step_0000000002",
            "step_0000000003",
        ]
        # pre-I/O usage (committed minus the step just written) fit
        step3 = os.path.join(str(tmp_path), "tenants", "q", steps[-1])
        step3_bytes = sum(
            os.path.getsize(os.path.join(dp, f))
            for dp, _, fs in os.walk(step3)
            for f in fs
        )
        used = quota.committed_bytes(
            os.path.join(str(tmp_path), "tenants", "q")
        )
        assert used - step3_bytes <= 12_000

    def test_raises_before_payload_io(self, tmp_path):
        t = Tenant(id="q2", quota_bytes=100)
        m = CheckpointManager(str(tmp_path), tenant=t, keep_last=10)
        m.save(0, _state())  # empty dir: gate passes at 0 used bytes
        with pytest.raises(QuotaExceededError) as ei:
            m.save(1, _state())
        assert ei.value.tenant_id == "q2"
        # no torn partial: step_1's directory was never created
        assert _steps(str(tmp_path), "q2") == ["step_0000000000"]

    def test_remote_root_quota_unenforceable(self):
        t = Tenant(id="r", quota_bytes=1000)
        m = CheckpointManager("s3://bucket/ckpt", tenant=t)
        with pytest.raises(QuotaUnenforceableError):
            quota.ensure_capacity(m)

    def test_remote_retention_skip_is_loud(self, caplog):
        import logging

        m = CheckpointManager("s3://bucket/ckpt", keep_last=2)
        telemetry.set_enabled(True)
        try:
            before = telemetry.counters().get("retention_skipped", 0)
            with caplog.at_level(logging.WARNING):
                m._apply_retention()
                m._apply_retention()
            after = telemetry.counters().get("retention_skipped", 0)
        finally:
            telemetry.set_enabled(False)
        assert after == before + 2  # counter every skip...
        warnings = [
            r for r in caplog.records if "retention skipped" in r.getMessage()
        ]
        assert len(warnings) == 1  # ...but ONE warning per manager

    def test_committed_bytes_ignores_partials(self, tmp_path):
        d = tmp_path / "t"
        (d / "step_0000000000").mkdir(parents=True)
        (d / "step_0000000000" / ".snapshot_metadata").write_bytes(b"{}")
        (d / "step_0000000000" / "payload").write_bytes(b"x" * 100)
        (d / "step_0000000001").mkdir()  # partial: no metadata
        (d / "step_0000000001" / "payload").write_bytes(b"x" * 900)
        counted = quota.committed_bytes(str(d))
        assert 100 <= counted < 1000


# ----------------------------------------------------- cross-tenant pool


class TestPool:
    def test_identical_bases_stored_once(self, tmp_path):
        """Byte accounting: two tenants' identical base payloads share
        ONE pool slot; each tenant's swept step drops to metadata-size."""
        root = str(tmp_path)
        w = torch.arange(4096, dtype=torch.float32)
        ma = CheckpointManager(
            root, tenant=Tenant(id="alpha"), keep_last=5, incremental=True
        )
        mb = CheckpointManager(
            root, tenant=Tenant(id="beta"), keep_last=5, incremental=True
        )
        ma.save(0, {"model": StateDict(w=w)})
        mb.save(0, {"model": StateDict(w=w)})
        assert pool.pool_bytes(root) == w.nbytes
        po_dir = os.path.join(pool.pool_root(root), "po")
        assert len(os.listdir(po_dir)) == 1  # stored exactly once
        # refcounts: one marker per (tenant, step)
        refs_dir = os.path.join(pool.pool_root(root), "refs")
        (digest_dir,) = os.listdir(refs_dir)
        assert sorted(os.listdir(os.path.join(refs_dir, digest_dir))) == [
            "alpha__step_0000000000",
            "beta__step_0000000000",
        ]
        # the swept step dirs hold no payload bytes anymore
        for tid in ("alpha", "beta"):
            d = os.path.join(root, "tenants", tid, "step_0000000000")
            on_disk = sum(
                os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(d)
                for f in fs
            )
            assert on_disk < w.nbytes / 4

    def test_restore_and_incremental_after_sweep(self, tmp_path):
        root = str(tmp_path)
        w = torch.arange(4096, dtype=torch.float32)
        ma = CheckpointManager(
            root, tenant=Tenant(id="alpha"), keep_last=5, incremental=True
        )
        ma.save(0, {"model": StateDict(w=w)})
        got = {"model": StateDict(w=torch.zeros_like(w))}
        ma.restore(got)
        np.testing.assert_array_equal(got["model"]["w"], w)
        # a second save still dedups against the POOLED base (digest
        # fallback in dedup.py): no second full payload anywhere
        ma.save(1, {"model": StateDict(w=w)})
        d1 = os.path.join(root, "tenants", "alpha", "step_0000000001")
        on_disk = sum(
            os.path.getsize(os.path.join(dp, f))
            for dp, _, fs in os.walk(d1)
            for f in fs
        )
        assert on_disk < w.nbytes / 4
        got = {"model": StateDict(w=torch.zeros_like(w))}
        ma.restore(got)
        np.testing.assert_array_equal(got["model"]["w"], w)

    def test_refcounted_reclaim(self, tmp_path):
        """The pooled payload survives while ANY tenant references it
        and is unlinked exactly at refcount zero — proven by bytes."""
        root = str(tmp_path)
        w0 = torch.arange(4096, dtype=torch.float32)
        w1 = w0 * 3
        ma = CheckpointManager(
            root, tenant=Tenant(id="alpha"), keep_last=1, incremental=True
        )
        mb = CheckpointManager(
            root, tenant=Tenant(id="beta"), keep_last=1, incremental=True
        )
        ma.save(0, {"model": StateDict(w=w0)})
        mb.save(0, {"model": StateDict(w=w0)})
        assert pool.pool_bytes(root) == w0.nbytes
        ma.save(1, {"model": StateDict(w=w1)})  # alpha evicts step 0
        # w0 retained (beta still refs) + w1 pooled
        assert pool.pool_bytes(root) == w0.nbytes + w1.nbytes
        mb.save(1, {"model": StateDict(w=w1)})  # beta evicts step 0
        # w0's last ref released -> reclaimed; w1 shared by both
        assert pool.pool_bytes(root) == w1.nbytes
        for m, want in ((ma, w1), (mb, w1)):
            got = {"model": StateDict(w=torch.zeros_like(want))}
            m.restore(got)
            np.testing.assert_array_equal(got["model"]["w"], want)

    def test_retention_does_not_freeze_on_pool_origins(self, tmp_path):
        """plan_retention must not flag pool origins unresolved (the
        pool is refcounted, not a snapshot)."""
        from torchsnapshot_tpu_torch.retention import plan_retention

        root = str(tmp_path)
        w = torch.arange(4096, dtype=torch.float32)
        ma = CheckpointManager(
            root, tenant=Tenant(id="alpha"), keep_last=5, incremental=True
        )
        ma.save(0, {"model": StateDict(w=w)})
        ma.save(1, {"model": StateDict(w=w * 2)})
        plan = plan_retention(
            os.path.join(root, "tenants", "alpha"), 1
        )
        assert not plan.unresolved
        assert plan.doomed == ["step_0000000000"]


# ----------------------------------------------------------- admission


class TestAdmission:
    def test_no_tenant_is_none(self):
        assert maybe_arm("take") is None

    def test_env_kill_switch(self, monkeypatch):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_ADMISSION", "0")
        assert maybe_arm("take", tenant=Tenant(id="a")) is None

    def test_share_is_priority_weighted(self):
        a = AdmissionSession(Tenant(id="a", priority=1), "take").start()
        b = AdmissionSession(Tenant(id="b", priority=4), "restore").start()
        try:
            assert a.share() == pytest.approx(0.2)
            assert b.share() == pytest.approx(0.8)
            assert a.scale_concurrency(10) == 2
            assert b.scale_concurrency(10) == 8
            assert a.scale_concurrency(1) == 1  # never starved to zero
        finally:
            a.stop()
            b.stop()

    def test_solo_share_is_full(self):
        a = AdmissionSession(Tenant(id="a", priority=1), "take").start()
        try:
            assert a.share() == 1.0
            assert a.scale_concurrency(10) == 10
        finally:
            a.stop()

    def test_stop_is_idempotent_and_rebalances(self):
        a = AdmissionSession(Tenant(id="a", priority=1), "take").start()
        b = AdmissionSession(Tenant(id="b", priority=1), "take").start()
        assert a.share() == pytest.approx(0.5)
        b.stop()
        b.stop()
        assert a.share() == 1.0
        a.stop()

    def test_admit_paces_against_measured_rate(self):
        """With a measured rate and a competing tenant, a large request
        clears the token bucket only after a proportional pause."""
        import asyncio

        from torchsnapshot_tpu_torch.scheduler import io_governor

        a = AdmissionSession(Tenant(id="a", priority=1), "take").start()
        b = AdmissionSession(Tenant(id="b", priority=1), "take").start()
        # The port feeds its governor directly, not through the bus.
        from torchsnapshot_tpu_torch.scheduler import _feed_governor_rates

        _feed_governor_rates("write", "PaceTestPlugin", 100_000_000, 1.0)
        try:
            assert io_governor().write_bps("PaceTestPlugin")
            t0 = time.perf_counter()
            asyncio.run(a.admit(60_000_000, "write", "PaceTestPlugin"))
            wall = time.perf_counter() - t0
            # share 0.5 -> 50 MB/s allowed; 60 MB less the 0.5 s burst
            # (25 MB) paces ~0.7 s
            assert 0.3 < wall < 3.0
            assert a.paused_s > 0
        finally:
            a.stop()
            b.stop()

    def test_admit_free_when_solo(self):
        import asyncio

        a = AdmissionSession(Tenant(id="a", priority=1), "take").start()
        try:
            t0 = time.perf_counter()
            asyncio.run(a.admit(1 << 30, "write", "PaceTestPlugin"))
            assert time.perf_counter() - t0 < 0.1
        finally:
            a.stop()

    def test_admission_rows_on_store(self):
        store = FakeStore()
        a = AdmissionSession(
            Tenant(id="a", priority=2), "take", store=store
        ).start()
        rows = [k for k in store.data if k.startswith("tsnap/adm/a/")]
        assert len(rows) == 1
        a.stop()
        assert not [k for k in store.data if k.startswith("tsnap/adm/")]


# ------------------------------------------------------- SIGKILL drill


_KILLED_SAVER = r"""
import asyncio, os, sys

import torch
from torchsnapshot_tpu_torch import StateDict
from torchsnapshot_tpu_torch.manager import CheckpointManager
from torchsnapshot_tpu_torch.tenancy import Tenant
from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod

root, gate = sys.argv[1], sys.argv[2]

orig_write = fs_mod.FSStoragePlugin.write

async def gated_write(self, write_io):
    if not write_io.path.endswith((".snapshot_metadata", ".snapshot_fence")):
        await orig_write(self, write_io)
        with open(gate, "w") as f:
            f.write("stalled")
        await asyncio.sleep(600)
    await orig_write(self, write_io)

fs_mod.FSStoragePlugin.write = gated_write

m = CheckpointManager(root, tenant=Tenant(id="alpha"), keep_last=3)
m.save(1, {"model": StateDict(w=torch.arange(4096, dtype=torch.float32))})
"""


class TestSigkillIsolation:
    def test_killed_tenant_does_not_affect_neighbor(self, tmp_path):
        """Tenant alpha's rank is SIGKILLed mid-save: beta's restore on
        the same bucket is unaffected, and alpha's partial is detectable
        (uncommitted — no metadata) and GC'd by alpha's next save."""
        root = str(tmp_path)
        w_b = torch.arange(4096, dtype=torch.float32) * 7
        mb = CheckpointManager(root, tenant=Tenant(id="beta"), keep_last=3)
        mb.save(0, {"model": StateDict(w=w_b)})

        gate = os.path.join(root, "gate")
        err_path = gate + ".stderr"
        with open(err_path, "wb") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", _KILLED_SAVER, root, gate],
                stdout=subprocess.DEVNULL,
                stderr=err,
            )
            deadline = time.monotonic() + 120
            while not os.path.exists(gate):
                if proc.poll() is not None:
                    with open(err_path) as f:
                        raise AssertionError(
                            "saver exited before the gate:\n" + f.read()
                        )
                if time.monotonic() > deadline:
                    proc.kill()
                    raise AssertionError("saver never reached the gate")
                time.sleep(0.01)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL

        # beta restores, oblivious
        got = {"model": StateDict(w=torch.zeros_like(w_b))}
        mb.restore(got)
        np.testing.assert_array_equal(got["model"]["w"], w_b)

        # alpha's partial is detectable: step dir exists, uncommitted
        partial = os.path.join(root, "tenants", "alpha", "step_0000000001")
        assert os.path.isdir(partial)
        assert not os.path.exists(
            os.path.join(partial, ".snapshot_metadata")
        )
        from torchsnapshot_tpu.cli import run_fsck

        code, _report = run_fsck(partial)
        assert code != 0  # fsck refuses to call a torn partial clean

        # alpha's next manager GCs the rubble and saves cleanly
        ma = CheckpointManager(root, tenant=Tenant(id="alpha"), keep_last=3)
        w_a = torch.arange(4096, dtype=torch.float32) * 2
        ma.save(1, {"model": StateDict(w=w_a)})
        got = {"model": StateDict(w=torch.zeros_like(w_a))}
        ma.restore(got)
        np.testing.assert_array_equal(got["model"]["w"], w_a)
        code, report = run_fsck(partial)
        assert code == 0, report.findings
        # beta remains untouched throughout
        got = {"model": StateDict(w=torch.zeros_like(w_b))}
        mb.restore(got)
        np.testing.assert_array_equal(got["model"]["w"], w_b)


# ------------------------------------------------- quota retention unit


class TestPlanQuotaRetention:
    def _mk_step(self, d, name, nbytes):
        sd = os.path.join(d, name)
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, "payload"), "wb") as f:
            f.write(b"x" * nbytes)
        import json

        with open(os.path.join(sd, ".snapshot_metadata"), "w") as f:
            f.write(
                json.dumps(
                    {"version": "0.1.0", "world_size": 1, "manifest": {}}
                )
                + "\n"
            )

    def test_drops_oldest_until_under_budget(self, tmp_path):
        d = str(tmp_path)
        for i in range(4):
            self._mk_step(d, f"step_{i:010d}", 1000)
            time.sleep(0.01)  # distinct mtimes: retention orders by them
        plan = quota.plan_quota_retention(
            d, keep=lambda names: set(names), byte_budget=2500
        )
        assert plan.doomed == ["step_0000000000", "step_0000000001"]

    def test_newest_always_survives(self, tmp_path):
        d = str(tmp_path)
        for i in range(2):
            self._mk_step(d, f"step_{i:010d}", 1000)
            time.sleep(0.01)
        plan = quota.plan_quota_retention(
            d, keep=lambda names: set(names), byte_budget=1
        )
        assert "step_0000000001" not in plan.doomed

    def test_droppable_filter_respected(self, tmp_path):
        d = str(tmp_path)
        for i in range(3):
            self._mk_step(d, f"step_{i:010d}", 1000)
            time.sleep(0.01)
        self._mk_step(d, "foreign_dir", 1000)
        plan = quota.plan_quota_retention(
            d,
            keep=lambda names: set(names),
            byte_budget=100,
            droppable=CheckpointManager._step_like,
        )
        assert "foreign_dir" not in plan.doomed


# ------------------------------------------------------ across the packages


class TestAgainstTheJaxPackage:
    def test_tenant_rows_are_byte_equal(self):
        from torchsnapshot_tpu.tenancy import Tenant as JTenant
        from torchsnapshot_tpu.tenancy import registry as jregistry

        mine, theirs = FakeStore(), FakeStore()
        for tid, quota_bytes, prio in (("a", 9, 3), ("b.x-1", None, 1)):
            registry.register(mine, Tenant(id=tid, quota_bytes=quota_bytes, priority=prio))
            jregistry.register(theirs, JTenant(id=tid, quota_bytes=quota_bytes, priority=prio))
        registry.deregister(mine, "a")
        jregistry.deregister(theirs, "a")
        assert mine.data == theirs.data
        assert registry.live_tenants(theirs) == jregistry.live_tenants(mine)

    def test_key_scoping_and_admission_rows_agree(self):
        from torchsnapshot_tpu import tenancy as jt
        from torchsnapshot_tpu.tenancy.admission import AdmissionSession as JSession
        from torchsnapshot_tpu.telemetry.health import HeartbeatPublisher as JPublisher
        from torchsnapshot_tpu_torch.telemetry.health import HeartbeatPublisher

        for key in ("tsnap/health/3", "tsnap/seed/u/x", "tsnap/journal/seed", "pgw/death"):
            assert scope_key(key, "alpha") == jt.scope_key(key, "alpha")
        with activated(Tenant(id="alpha")), jt.activated(jt.Tenant(id="alpha")):
            assert (HeartbeatPublisher(FakeStore(), 0, "take", "/x").prefix
                    == JPublisher(FakeStore(), 0, "take", "/x").prefix)
        mine, theirs = FakeStore(), FakeStore()
        a = AdmissionSession(Tenant(id="a", priority=2), "take", store=mine).start()
        b = JSession(jt.Tenant(id="a", priority=2), "take", store=theirs).start()
        try:
            [(mk, mv)], [(tk, tv)] = list(mine.data.items()), list(theirs.data.items())
            assert mv == tv
            assert mk.rsplit("_", 1)[0] == tk.rsplit("_", 1)[0] == f"tsnap/adm/a/{os.getpid()}"
            # One arbitration plane: each package's session sees the other's row.
            both = FakeStore({**mine.data, "tsnap/adm/b/1_0": b'{"priority": 6, "op": "take"}'})
            assert AdmissionSession(Tenant(id="a", priority=2), "take", store=both).share() \
                == JSession(jt.Tenant(id="a", priority=2), "take", store=both).share() == 0.25
        finally:
            a.stop()
            b.stop()

    def test_one_pool_shared_by_a_jax_tenant_and_a_port_tenant(self, tmp_path):
        """A JAX tenant and a port tenant save the same base into one root:
        the pool stores it once with one marker per (tenant, step), each
        package restores its own step and the other's bit-exact."""
        import jax.numpy as jnp

        import torchsnapshot_tpu as J
        from torchsnapshot_tpu.manager import CheckpointManager as JManager
        from torchsnapshot_tpu_torch import Snapshot
        from torchsnapshot_tpu.tenancy import Tenant as JTenant
        from torchsnapshot_tpu.tenancy import pool as jpool

        root = str(tmp_path)
        w = torch.arange(4096, dtype=torch.float32) * 0.5
        jm = JManager(root, tenant=JTenant(id="jax"), incremental=True)
        jm.save(0, {"model": J.StateDict(w=jnp.asarray(w.numpy()))})
        pm = CheckpointManager(root, tenant=Tenant(id="port"), incremental=True)
        pm.save(0, {"model": StateDict(w=w)})
        assert pool.pool_bytes(root) == jpool.pool_bytes(root) == w.nbytes
        refs = os.path.join(pool.pool_root(root), "refs")
        (hexd,) = os.listdir(refs)
        assert sorted(os.listdir(os.path.join(refs, hexd))) == [
            "jax__step_0000000000", "port__step_0000000000"]
        assert pool.ref_count(root, hexd) == jpool.ref_count(root, hexd) == 2
        port_step = os.path.join(root, "tenants", "port", "step_0000000000")
        jax_step = os.path.join(root, "tenants", "jax", "step_0000000000")
        # The two swept manifests point at the same pooled payload.
        def located(md):
            return [c.array.location for c in md.manifest["0/model/w"].chunks]

        assert (located(Snapshot(port_step).metadata) == located(J.Snapshot(jax_step).metadata)
                == [f"po/{hexd}"])
        got = {"model": StateDict(w=torch.zeros_like(w))}
        pm.restore(got)
        assert torch.equal(got["model"]["w"], w)
        jgot = {"model": J.StateDict(w=jnp.zeros(4096, jnp.float32))}
        J.Snapshot(port_step).restore(jgot)
        assert np.array_equal(np.asarray(jgot["model"]["w"]), w.numpy())
        got = {"model": StateDict(w=torch.zeros_like(w))}
        Snapshot(jax_step).restore(got)
        assert torch.equal(got["model"]["w"], w)
