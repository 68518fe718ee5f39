"""The port's fleet distribution tier (``distrib.py``): the counterparts
of ``tests/test_distrib.py`` case for case, on torch state, and a mixed
fleet on one store: seed rows byte-equal between the packages, a JAX
seeder serving a port replica and a port seeder serving a JAX replica,
and a JAX trainer's push converging a port receiver.

The contracts under test:

- The chunk cache never diverges from the registry in the direction of
  advertising bytes it cannot serve: TTL expiry and byte-cap eviction
  report the evicted digests so the session retracts their rows.
- A restore that aborts retracts exactly the registrations it made
  (a partially-restored replica must not advertise chunks it may throw
  away), while earlier restores' registrations survive.
- A holder whose process dies without deregistering becomes a ghost:
  its death-notice key is up, fetchers skip it and lazily delete its
  rows — never a hang.
- A fetched chunk failing its content address (a corrupting peer) is
  rejected like a CRC failure and the fetcher re-parents; with no clean
  parent left, the chunk degrades to a direct storage read.
- An epoch push is applied exactly once per (gen, epoch): duplicated
  pushes (lost cursor, blind retry, overlapping pushers) are dup-acked
  and dropped; a corrupt push is nacked before any state mutates.
"""

import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, distrib, faultinject
from torchsnapshot_tpu_torch.dist_store import (
    SEED_DEAD_PREFIX,
    TCPStore,
    seed_holder_rows,
)
from torchsnapshot_tpu_torch.fanout import content_address, content_unit_id
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture
def registry():
    """One in-process store server + a client factory; the seed-session
    global is reset around each test so sessions never leak across."""
    server = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    port = server.port

    def client() -> TCPStore:
        return TCPStore("127.0.0.1", port, is_server=False, timeout=10.0)

    distrib.configure_registry(client)
    try:
        yield client
    finally:
        distrib.reset_session()
        distrib.configure_registry(None)
        faultinject.disable()
        server.close()


# ------------------------------------------------------------- chunk cache


def test_chunk_cache_ttl_expiry():
    cache = distrib.ChunkCache(ttl_s=0.05, cap_bytes=1 << 20)
    cache.put("sha256:a", b"x" * 64)
    assert cache.get("sha256:a") == b"x" * 64
    time.sleep(0.08)
    assert cache.get("sha256:a") is None
    assert cache.nbytes == 0


def test_chunk_cache_cap_eviction_reports_digests():
    cache = distrib.ChunkCache(ttl_s=60.0, cap_bytes=100)
    assert cache.put("sha256:a", b"a" * 40) == []
    assert cache.put("sha256:b", b"b" * 40) == []
    # Inserting c exceeds the cap: the LRU chunk (a) must be reported so
    # the session can retract its registry row.
    assert cache.put("sha256:c", b"c" * 40) == ["sha256:a"]
    assert cache.get("sha256:a") is None
    assert cache.get("sha256:b") is not None


def test_chunk_cache_hit_refreshes_lru_order():
    cache = distrib.ChunkCache(ttl_s=60.0, cap_bytes=100)
    cache.put("sha256:a", b"a" * 40)
    cache.put("sha256:b", b"b" * 40)
    cache.get("sha256:a")  # touch: b is now least-recent
    assert cache.put("sha256:c", b"c" * 40) == ["sha256:b"]
    assert cache.get("sha256:a") is not None


def test_chunk_cache_oversized_chunk_never_cached():
    cache = distrib.ChunkCache(ttl_s=60.0, cap_bytes=100)
    cache.put("sha256:big", b"x" * 200)
    assert cache.get("sha256:big") is None
    assert cache.nbytes == 0


# -------------------------------------------------------- content addressing


def test_content_address_is_device_digest_namespace():
    d = content_address(b"some chunk bytes")
    assert d.startswith("sha256:") and len(d) == 7 + 64
    assert d == content_address(bytearray(b"some chunk bytes"))
    assert d != content_address(b"other chunk bytes")


def test_content_unit_id_scope_rules():
    uid = content_unit_id("/snaps/step_5", "replicated/0/model.w", (0, 100))
    assert uid is not None and uid.startswith("sha256:")
    # Snapshot identity is part of the key: byte-identical requests
    # against different snapshots must never collide in the catalog.
    other = content_unit_id("/snaps/step_6", "replicated/0/model.w", (0, 100))
    assert other != uid
    assert content_unit_id("/s", "sharded/0/emb.0", (0, 10)) is not None
    # Per-rank and slab payloads are never shareable; zero-length moves
    # nothing.
    assert content_unit_id("/s", "0/model.w", (0, 100)) is None
    assert content_unit_id("/s", "batched/slab_0", (0, 100)) is None
    assert content_unit_id("/s", "replicated/0/model.w", (5, 5)) is None


# ----------------------------------------------------- registry + fetching


def test_publish_lookup_fetch_roundtrip(registry):
    payload = b"replicated-bytes" * 500
    uid = content_unit_id("/snap", "replicated/0/w", (0, len(payload)))
    s1 = distrib.SeedSession(registry(), holder_id="h1")
    s2 = distrib.SeedSession(registry(), holder_id="h2")
    try:
        digest = s1.publish(uid, payload, depth=0)
        assert s1.lookup(uid) == (digest, len(payload))
        got = s2.fetch(uid, digest, len(payload))
        assert got == payload
        # The fetcher registered itself one level below its parent.
        rows = seed_holder_rows(s2.store, digest)
        assert rows["h1"]["depth"] == 0
        assert rows["h2"]["depth"] == 1
    finally:
        s1.close()
        s2.close()


def test_fetch_with_no_holder_raises_seed_unavailable(registry):
    s = distrib.SeedSession(registry(), holder_id="lone")
    try:
        assert s.lookup("sha256:" + "0" * 64) is None
        with pytest.raises(distrib.SeedUnavailable):
            s.fetch("unit", "sha256:" + "0" * 64, 10)
    finally:
        s.close()


def test_fetch_rejects_corrupt_chunk_and_reparents(registry):
    """A corrupting seeder is caught by the receiver's content-address
    re-hash (the distrib.seed_xfer fault site corrupts the payload as it
    leaves the FIRST serving peer); the fetcher re-parents to the next
    holder and still delivers verified bytes."""
    payload = b"seeded-chunk" * 1000
    uid = content_unit_id("/snap", "replicated/0/w", (0, len(payload)))
    s1 = distrib.SeedSession(registry(), holder_id="h1")
    s2 = distrib.SeedSession(registry(), holder_id="h2")
    s3 = distrib.SeedSession(registry(), holder_id="h3")
    try:
        digest = s1.publish(uid, payload, depth=0)
        s2.publish(uid, payload, depth=0)
        # h1 is elected parent first (same depth, lower registration
        # seq); its one serve is corrupted.
        faultinject.configure("distrib.seed_xfer@1=corrupt")
        got = s3.fetch(uid, digest, len(payload))
        assert got == payload
        assert content_address(got) == digest
    finally:
        faultinject.disable()
        s1.close()
        s2.close()
        s3.close()


def test_ghost_key_rule_on_holder_death(registry):
    """A holder that dies without deregistering (store connection drops
    → its liveness death notice publishes) is skipped by fetchers and
    its rows are lazily retracted."""
    payload = b"ghost-chunk" * 800
    uid = content_unit_id("/snap", "replicated/0/w", (0, len(payload)))
    s1 = distrib.SeedSession(registry(), holder_id="alive")
    s2 = distrib.SeedSession(registry(), holder_id="doomed")
    try:
        digest = s1.publish(uid, payload, depth=0)
        s2.publish(uid, payload, depth=0)
        # Simulate death: the store connection drops WITHOUT a
        # deregister, publishing the death-notice key; the listener
        # socket stays up, so only liveness distinguishes dead from slow.
        s2.store.close()
        deadline = time.monotonic() + 10.0
        probe = registry()
        try:
            while time.monotonic() < deadline:
                if probe.check(f"{SEED_DEAD_PREFIX}doomed"):
                    break
                time.sleep(0.05)
            assert probe.check(f"{SEED_DEAD_PREFIX}doomed")
        finally:
            probe.close()
        s3 = distrib.SeedSession(registry(), holder_id="fresh")
        try:
            got = s3.fetch(uid, digest, len(payload))
            assert got == payload
            rows = seed_holder_rows(s3.store, digest)
            assert "doomed" not in rows  # lazily retracted
            assert "alive" in rows and "fresh" in rows
        finally:
            s3.close()
    finally:
        s1.close()
        s2._listener.close()  # the store is already gone; just the socket


def test_eviction_retracts_registry_row(registry):
    """Cap eviction must retract the evicted digest's holder row — the
    registry never advertises bytes the cache can no longer serve."""
    s = distrib.SeedSession(registry(), holder_id="tiny")
    s.cache = distrib.ChunkCache(ttl_s=60.0, cap_bytes=100)
    try:
        uid_a = content_unit_id("/snap", "replicated/0/a", (0, 40))
        uid_b = content_unit_id("/snap", "replicated/0/b", (0, 40))
        uid_c = content_unit_id("/snap", "replicated/0/c", (0, 40))
        da = s.publish(uid_a, b"a" * 40, depth=0)
        s.publish(uid_b, b"b" * 40, depth=0)
        s.publish(uid_c, b"c" * 40, depth=0)  # evicts a
        assert seed_holder_rows(s.store, da) == {}
        assert s.cache.get(da) is None
    finally:
        s.close()


# ------------------------------------------- restore-path registration


class _BoomStateful:
    """state_dict works (take succeeds); load_state_dict raises (restore
    aborts after its payloads were read — and seeded)."""

    def __init__(self, arr):
        self.arr = arr

    def state_dict(self):
        return {"w": self.arr}

    def load_state_dict(self, sd):
        raise RuntimeError("injected load failure")


def test_restore_abort_retracts_this_restores_registrations(
    registry, tmp_path, monkeypatch
):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", "always")
    arr = torch.arange(1 << 14, dtype=torch.float32)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": _BoomStateful(arr)}, replicated=["**"])
    with pytest.raises(RuntimeError, match="injected load failure"):
        Snapshot(path).restore({"app": _BoomStateful(arr.clone())})
    sess = distrib.session()
    assert sess is not None
    # Every row this (aborted) restore registered is gone again: a
    # partially-restored replica must not advertise chunks it may be
    # about to throw away.
    assert sess._registered == {}
    assert sess.cache.nbytes == 0


def test_seeded_restore_roundtrip_and_second_restore_hits_cache(
    registry, tmp_path, monkeypatch
):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", "always")
    st = StateDict(w=torch.arange(1 << 14, dtype=torch.float32), step=7)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"app": st}, replicated=["**"])
    dst = StateDict(w=torch.zeros(1 << 14), step=0)
    Snapshot(path).restore({"app": dst})
    np.testing.assert_array_equal(dst["w"], st["w"])
    sess = distrib.session()
    assert sess is not None and len(sess._registered) > 0
    # The session persists past the restore: a second restore sources
    # its shareable chunks from the local cache, not storage.
    hits_before = sess.cache.nbytes
    dst2 = StateDict(w=torch.zeros(1 << 14), step=0)
    Snapshot(path).restore({"app": dst2})
    np.testing.assert_array_equal(dst2["w"], st["w"])
    assert sess.cache.nbytes == hits_before


def test_seed_restore_defaults_off(monkeypatch):
    """Unset, the seeding tier is one env check: maybe_wrap_restore
    returns the storage untouched and no session is created."""
    distrib.reset_session()
    monkeypatch.delenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", raising=False)
    sentinel = object()
    wrapped, tier = distrib.maybe_wrap_restore(sentinel, "/p", None)
    assert wrapped is sentinel and tier is None


def test_seed_restore_mode_parser(monkeypatch):
    assert distrib.seed_restore_mode() == "never"
    for raw, want in (
        ("always", "always"), ("1", "always"), ("force", "always"),
        ("auto", "auto"), ("governor", "auto"),
        ("never", "never"), ("0", "never"), ("junk", "never"),
    ):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", raw)
        assert distrib.seed_restore_mode() == want, raw


# ------------------------------------------------------- rolling updates


def _state(v: float) -> StateDict:
    return StateDict(
        w=torch.arange(512, dtype=torch.float32) + v,
        b=torch.full((32,), v, dtype=torch.float64),
        step=int(v),
    )


@pytest.fixture
def journaling(monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")


def test_exactly_once_epoch_apply_under_duplicated_push(
    registry, tmp_path, journaling
):
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0.0)
    mgr.save(0, {"app": st})
    mgr.wait()
    replica = {"app": _state(0.0)}
    rx = distrib.UpdateReceiver(registry(), replica, base_step=0)
    try:
        st["w"] = st["w"] + 1.0
        st["step"] = 1
        assert mgr.journal_step(1, {"app": st})
        out = mgr.push_update()
        assert out == {"replicas": 1, "epochs": 1, "bytes": out["bytes"],
                       "nacks": 0}
        assert out["bytes"] > 0
        st["b"] = st["b"] + 2.0
        st["step"] = 2
        assert mgr.journal_step(2, {"app": st})
        assert mgr.push_update()["epochs"] == 1  # cursor: only the new epoch
        np.testing.assert_array_equal(replica["app"]["w"], st["w"])
        np.testing.assert_array_equal(replica["app"]["b"], st["b"])
        assert replica["app"]["step"] == 2
        assert rx.epochs_applied == 2
        # A lost cursor replays everything; the receiver dup-acks and
        # applies nothing twice.
        mgr._push_cursor.clear()
        replay = mgr.push_update()
        assert replay["epochs"] == 2 and replay["nacks"] == 0
        assert rx.epochs_applied == 2  # exactly once
    finally:
        rx.close()


def test_corrupt_epoch_push_is_nacked_before_apply(
    registry, tmp_path, journaling
):
    """A corrupted push frame (the distrib.epoch_push fault site) fails
    the receiver's record CRCs and is nacked; no state mutates. With the
    fault cleared, the push converges (the nacked epoch's cursor never
    advanced)."""
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0.0)
    mgr.save(0, {"app": st})
    mgr.wait()
    replica = {"app": _state(0.0)}
    rx = distrib.UpdateReceiver(registry(), replica, base_step=0)
    try:
        st["w"] = st["w"] + 5.0
        assert mgr.journal_step(1, {"app": st})
        faultinject.configure("distrib.epoch_push@1=corrupt")
        try:
            out = mgr.push_update()
        finally:
            faultinject.disable()
        assert out["nacks"] == 1 and out["epochs"] == 0
        np.testing.assert_array_equal(
            replica["app"]["w"], _state(0.0)["w"]
        )  # nothing applied
        out2 = mgr.push_update()
        assert out2["epochs"] == 1 and out2["nacks"] == 0
        np.testing.assert_array_equal(replica["app"]["w"], st["w"])
        assert rx.epochs_applied == 1
    finally:
        rx.close()


def test_push_update_without_receivers_is_empty(registry, tmp_path, journaling):
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0.0)
    mgr.save(0, {"app": st})
    mgr.wait()
    st["w"] = st["w"] + 1.0
    assert mgr.journal_step(1, {"app": st})
    assert mgr.push_update() == {
        "replicas": 0, "epochs": 0, "bytes": 0, "nacks": 0,
    }


def test_push_update_unarmed_journal_is_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.push_update() == {
        "replicas": 0, "epochs": 0, "bytes": 0, "nacks": 0,
    }


def test_dead_receiver_is_skipped_by_death_notice(
    registry, tmp_path, journaling
):
    """A registered update receiver whose process died (ghost-key rule)
    is skipped entirely — the push neither hangs nor counts it."""
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0.0)
    mgr.save(0, {"app": st})
    mgr.wait()
    rx = distrib.UpdateReceiver(registry(), {"app": _state(0.0)}, base_step=0)
    rx.store.close()  # dies without deregistering → death notice
    deadline = time.monotonic() + 10.0
    probe = registry()
    try:
        while time.monotonic() < deadline:
            if probe.check(f"{SEED_DEAD_PREFIX}{rx.holder_id}"):
                break
            time.sleep(0.05)
        assert distrib.live_update_targets(probe, 0) == {}
    finally:
        probe.close()
        rx._listener.close()
    st["w"] = st["w"] + 1.0
    assert mgr.journal_step(1, {"app": st})
    assert mgr.push_update()["replicas"] == 0


# --------------------------------------------------- a mixed fleet, one store


@pytest.fixture
def mixed():
    """One store server with a client factory per package, both seed
    registries pointed at it (the wire protocol is shared)."""
    from torchsnapshot_tpu import distrib as jdistrib
    from torchsnapshot_tpu import faultinject as jfaultinject
    from torchsnapshot_tpu.dist_store import TCPStore as JStore

    server = TCPStore("127.0.0.1", is_server=True, timeout=10.0)
    port = server.port

    def port_client():
        return TCPStore("127.0.0.1", port, is_server=False, timeout=10.0)

    def jax_client():
        return JStore("127.0.0.1", port, is_server=False, timeout=10.0)

    distrib.configure_registry(port_client)
    jdistrib.configure_registry(jax_client)
    try:
        yield port_client, jax_client
    finally:
        distrib.reset_session()
        jdistrib.reset_session()
        distrib.configure_registry(None)
        jdistrib.configure_registry(None)
        faultinject.disable()
        jfaultinject.disable()
        server.close()


def test_seed_rows_are_byte_equal_between_the_packages():
    from torchsnapshot_tpu import dist_store as jds

    from torchsnapshot_tpu_torch import dist_store as pds

    class Dict:
        def __init__(self):
            self.data = {}

        def set(self, key, value):
            self.data[key] = bytes(value)

    for name in ("SEED_PREFIX", "SEED_CATALOG_PREFIX", "SEED_HOLDER_PREFIX", "SEED_DEAD_PREFIX",
                 "SEED_UPDATE_PREFIX", "SEED_SEQ_KEY"):
        assert getattr(pds, name) == getattr(jds, name), name
    mine, theirs = Dict(), Dict()
    uid = content_unit_id("/snap", "replicated/0/w", (0, 100))
    from torchsnapshot_tpu.fanout import content_unit_id as j_unit_id

    assert uid == j_unit_id("/snap", "replicated/0/w", (0, 100))
    pds.seed_catalog_put(mine, uid, content_address(b"x" * 100), 100)
    jds.seed_catalog_put(theirs, uid, content_address(b"x" * 100), 100)
    assert mine.data == theirs.data
    assert pds.seed_holder_key("sha256:ab", "h1") == jds.seed_holder_key("sha256:ab", "h1")


def _take_replicated(path, w):
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    J.Snapshot.take(path, {"app": J.StateDict(w=jnp.asarray(w.numpy()), step=3)},
                    replicated=["**"])


def test_a_jax_seeder_serves_a_port_replica(mixed, tmp_path, monkeypatch):
    import jax.numpy as jnp

    import torchsnapshot_tpu as J
    from torchsnapshot_tpu import distrib as jdistrib

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SEED_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", "always")
    w = torch.arange(1 << 14, dtype=torch.float32) * 0.25
    path = str(tmp_path / "snap")
    _take_replicated(path, w)
    jdst = J.StateDict(w=jnp.zeros(1 << 14, jnp.float32), step=0)
    J.Snapshot(path).restore({"app": jdst})  # the JAX replica reads storage, seeds
    assert jdistrib.session()._registered
    dst = StateDict(w=torch.zeros(1 << 14), step=0)
    Snapshot(path).restore({"app": dst})
    assert torch.equal(dst["w"], w) and dst["step"] == 3
    sess = distrib.session()
    # Every shareable chunk came from the JAX seeder, one level below it.
    assert sess._registered and set(sess._registered.values()) == {1}
    assert sess._seed_bytes == w.nbytes


def test_a_port_seeder_serves_a_jax_replica(mixed, tmp_path, monkeypatch):
    import jax.numpy as jnp

    import torchsnapshot_tpu as J
    from torchsnapshot_tpu import distrib as jdistrib

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_SEED_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", "always")
    w = torch.arange(1 << 14, dtype=torch.float32) - 7.0
    path = str(tmp_path / "snap")
    P_snap = StateDict(w=w, step=3)
    Snapshot.take(path, {"app": P_snap}, replicated=["**"])
    dst = StateDict(w=torch.zeros(1 << 14), step=0)
    Snapshot(path).restore({"app": dst})  # the port replica reads storage, seeds
    assert set(distrib.session()._registered.values()) == {0}
    jdst = J.StateDict(w=jnp.zeros(1 << 14, jnp.float32), step=0)
    J.Snapshot(path).restore({"app": jdst})
    assert np.array_equal(np.asarray(jdst["w"]), w.numpy()) and jdst["step"] == 3
    jsess = jdistrib.session()
    assert jsess._registered and set(jsess._registered.values()) == {1}


def test_a_jax_trainers_push_converges_a_port_receiver(mixed, tmp_path, monkeypatch):
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    port_client, _ = mixed
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
    mgr = J.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = J.StateDict(w=jnp.arange(512, dtype=jnp.float32), b=jnp.zeros(32, jnp.float64), step=0)
    mgr.save(0, {"app": st})
    replica = {"app": StateDict(w=torch.arange(512, dtype=torch.float32),
                                b=torch.zeros(32, dtype=torch.float64), step=0)}
    w_before = replica["app"]["w"]
    rx = distrib.UpdateReceiver(port_client(), replica, base_step=0)
    try:
        st["w"] = st["w"] * 3.0
        st["step"] = 1
        assert mgr.journal_step(1, {"app": st})
        st["b"] = st["b"] + 2.0
        st["step"] = 2
        assert mgr.journal_step(2, {"app": st})
        out = mgr.push_update()
        assert out["replicas"] == 1 and out["epochs"] == 2 and out["nacks"] == 0
        assert np.array_equal(replica["app"]["w"].numpy(), np.asarray(st["w"]))
        assert np.array_equal(replica["app"]["b"].numpy(), np.asarray(st["b"]))
        assert replica["app"]["step"] == 2 and rx.epochs_applied == 2
        assert replica["app"]["w"] is w_before  # applied in place
        mgr._push_cursor.clear()
        assert mgr.push_update()["epochs"] == 2 and rx.epochs_applied == 2  # dup-acked
    finally:
        rx.close()
        mgr.close()


@pytest.mark.parametrize("read_bps", [100e6, 20e9])
def test_auto_elects_seeding_as_the_jax_governor_does(registry, monkeypatch, read_bps):
    """Under ``SEED_RESTORE=auto`` the port's governor decides on the
    measured read rate at the knee the JAX package's uses: slow storage
    seeds, page-cache speeds read direct."""
    from torchsnapshot_tpu import scheduler as jsched
    from torchsnapshot_tpu import telemetry as jtelemetry
    from torchsnapshot_tpu_torch import scheduler as psched

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_AUTOTUNE", "never")
    psched.reset_io_governor()
    jsched.reset_io_governor()
    try:
        psched._feed_governor_rates("read", "FSStoragePlugin", int(read_bps), 1.0)
        jgov = jsched.io_governor()
        jgov.record_read("FSStoragePlugin", int(read_bps), 1.0)
        want = jgov.should_seed_restore("FSStoragePlugin")
        assert psched.io_governor().should_seed_restore("FSStoragePlugin") == want
        assert want == (read_bps < 1e9)
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_SEED_RESTORE", "auto")
        sentinel = type("FSStoragePlugin", (), {})()
        _, tier = distrib.maybe_wrap_restore(sentinel, "/p", None)
        assert (tier is not None) == want
    finally:
        psched.reset_io_governor()
        jsched.reset_io_governor()
        jtelemetry.reset()
        distrib.reset_session()
