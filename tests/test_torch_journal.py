"""The port's delta journal (``journal.py``): counterparts of
``tests/test_journal.py`` on torch state, leaves of every kind, the
dirty detector against the JAX package's, records byte-equal to the JAX
package's, journals replayed across the two packages, and a world of two
processes.

JAX is imported inside the tests that use it: the multi-process worker is
imported by spawned processes, which must not load JAX."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import device_digest, journal
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture
def journaling(monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")


def _state(v: float) -> P.StateDict:
    return P.StateDict(
        w=torch.arange(512, dtype=torch.float32) + v,
        b=torch.full((32,), v, dtype=torch.float64),
        step=int(v),
        name=f"run-{int(v)}",
    )


def _set(st: P.StateDict, v: float) -> None:
    st["w"] = torch.arange(512, dtype=torch.float32) + v
    st["b"] = torch.full((32,), float(v), dtype=torch.float64)
    st["step"] = int(v)
    st["name"] = f"run-{int(v)}"


def _assert_state(dst: P.StateDict, v: float) -> None:
    assert torch.equal(dst["w"], torch.arange(512, dtype=torch.float32) + v)
    assert torch.equal(dst["b"], torch.full((32,), v, dtype=torch.float64))
    assert dst["step"] == int(v) and dst["name"] == f"run-{int(v)}"


def _segment(mgr: P.CheckpointManager, step: int, rank: int = 0) -> str:
    return os.path.join(mgr.path_for(step), journal.JOURNAL_DIRNAME, journal.segment_name(rank))


def test_disabled_by_default(tmp_path) -> None:
    mgr = P.CheckpointManager(str(tmp_path))
    mgr.save(0, {"app": _state(0)})
    assert not mgr.journal_step(1, {"app": _state(1)})
    assert not os.path.exists(os.path.join(mgr.path_for(0), journal.JOURNAL_DIRNAME))


def test_journal_step_needs_a_committed_base(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=5)
    assert not mgr.journal_step(0, {"app": _state(0)})


def test_roundtrip_replay_bit_exact(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    for v in (1, 2, 3):
        _set(st, v)
        assert mgr.journal_step(v, {"app": st})
    jdir = os.path.join(mgr.path_for(0), journal.JOURNAL_DIRNAME)
    metas = journal.read_epoch_metas(jdir)
    assert [m["epoch"] for m in journal.committed_epochs(metas)] == [1, 2, 3]
    assert not os.path.exists(os.path.join(jdir, journal.FENCE_FNAME))
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    _assert_state(dst, 3)


def test_only_dirty_leaves_are_appended(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["step"] = 1
    assert mgr.journal_step(1, {"app": st})
    records, err = journal.scan_segment(_segment(mgr, 0))
    assert err is None and [h["key"] for h, _ in records] == ["app/step"]
    assert mgr.journal_step(2, {"app": st})  # nothing dirty: an epoch of 0 records
    metas = journal.read_epoch_metas(os.path.dirname(_segment(mgr, 0)))
    assert len(metas) == 2 and metas[1]["records"] == {"0": 0}


def test_torn_tail_truncated_on_replay(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["step"] = 1
    assert mgr.journal_step(1, {"app": st})
    seg = _segment(mgr, 0)
    committed = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(b'TSJR\x40\x00\x00\x00{"v": 1, "gen"')
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert torch.equal(dst["w"], torch.arange(512, dtype=torch.float32))
    assert dst["step"] == 1
    assert os.path.getsize(seg) == committed


def test_corrupt_committed_record_falls_back_to_base(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["w"] = st["w"] + 5
    st["step"] = 5
    assert mgr.journal_step(1, {"app": st})
    seg = _segment(mgr, 0)
    with open(seg, "r+b") as f:
        f.seek(os.path.getsize(seg) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    _assert_state(dst, 0)
    assert os.path.getsize(seg) > 0


def test_fenced_off_straggler_records_never_spliced(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["step"] = 1
    assert mgr.journal_step(1, {"app": st})
    seg = _segment(mgr, 0)
    fields, payload = journal._serialize_leaf(99, "object")
    header = {"v": 1, "gen": "deadbeef" * 4, "epoch": 2, "key": "app/step", **fields}
    with open(seg, "ab") as f:
        f.write(journal.encode_record(header, payload))
    meta_path = os.path.join(os.path.dirname(seg), journal.epoch_meta_name(1))
    meta = json.load(open(meta_path))
    meta["offsets"]["0"] = os.path.getsize(seg)
    json.dump(meta, open(meta_path, "w"))
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert dst["step"] == 1


def test_epoch_gap_stops_replay(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    for v in (1, 2):
        st["step"] = v
        assert mgr.journal_step(v, {"app": st})
    os.remove(os.path.join(os.path.dirname(_segment(mgr, 0)), journal.epoch_meta_name(1)))
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    _assert_state(dst, 0)


def test_epoch_bytes_cap_forces_full_save(tmp_path, journaling, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL_EPOCH_BYTES", "64")
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["w"] = st["w"] + 1  # 2 KiB dirty > the 64-byte cap
    assert mgr.journal_step(1, {"app": st})
    assert mgr.latest_step() == 1
    st["step"] = 2
    assert mgr.journal_step(2, {"app": st})
    assert mgr.latest_step() == 1


def test_max_epochs_bounds_the_replay_chain(tmp_path, journaling, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL_MAX_EPOCHS", "2")
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    for v in (1, 2):
        st["step"] = v
        assert mgr.journal_step(v, {"app": st})
    assert mgr.latest_step() == 0
    st["step"] = 3
    assert mgr.journal_step(3, {"app": st})
    assert mgr.latest_step() == 3


def test_preemption_flushes_journal_not_full_save(tmp_path, journaling) -> None:
    watcher = P.PreemptionWatcher()
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100, preemption=watcher)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["step"] = 1
    assert mgr.journal_step(1, {"app": st})
    st["w"] = st["w"] + 7
    st["step"] = 2
    P.simulate_preemption_now()
    try:
        assert mgr.save(2, {"app": st}) is False
        assert watcher.consumed and mgr.all_steps() == [0]
    finally:
        watcher.close()
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert torch.equal(dst["w"], torch.arange(512, dtype=torch.float32) + 7)
    assert dst["step"] == 2


def test_restore_rearms_and_continues_the_chain(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["step"] = 1
    assert mgr.journal_step(1, {"app": st})
    mgr2 = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st2 = _state(-1)
    assert mgr2.restore({"app": st2}) == 0 and st2["step"] == 1
    st2["step"] = 2
    assert mgr2.journal_step(2, {"app": st2})
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert dst["step"] == 2


def test_journal_flight_events(tmp_path, journaling) -> None:
    from torchsnapshot_tpu_torch.telemetry import flightrec

    flightrec.reset()
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    st["step"] = 1
    assert mgr.journal_step(1, {"app": st})
    assert {"journal.open", "journal.commit"} <= {ev for _, _, ev, _ in flightrec.snapshot_ring()}
    assert P.CheckpointManager(str(tmp_path)).restore({"app": _state(-1)}) == 0
    assert "journal.replay" in {ev for _, _, ev, _ in flightrec.snapshot_ring()}


def test_record_framing_roundtrip_torn_and_corrupt() -> None:
    payload = memoryview(b"\x01\x02\x03\x04" * 8)
    rec = journal.encode_record(
        {"v": 1, "gen": "g", "epoch": 1, "key": "k", "kind": "object", "nbytes": len(payload)},
        payload,
    )
    header, out, off = journal._decode_one(memoryview(rec), 0)
    assert header["key"] == "k" and bytes(out) == bytes(payload) and off == len(rec)
    for cut in (2, 10, len(rec) - 1):
        with pytest.raises(EOFError):
            journal._decode_one(memoryview(rec[:cut]), 0)
    flipped = bytearray(rec)
    flipped[-6] ^= 0xFF
    with pytest.raises(ValueError):
        journal._decode_one(memoryview(bytes(flipped)), 0)


def test_committed_epochs_is_the_contiguous_prefix() -> None:
    metas = [{"epoch": 1}, {"epoch": 2}, {"epoch": 4}]
    assert [m["epoch"] for m in journal.committed_epochs(metas)] == [1, 2]
    assert journal.committed_epochs([{"epoch": 2}]) == []


def test_injected_append_corruption_is_caught_on_replay(tmp_path, journaling) -> None:
    from torchsnapshot_tpu_torch import faultinject

    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = _state(0)
    mgr.save(0, {"app": st})
    _set(st, 4)
    faultinject.configure("journal.append@1=corrupt")
    try:
        assert mgr.journal_step(1, {"app": st})
    finally:
        faultinject.disable()
    dst = _state(-1)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    _assert_state(dst, 0)  # the whole journal refused, the base intact


def test_dtensor_leaf_raises_by_name() -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from torchsnapshot_tpu_torch.test_utils import find_free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{find_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,))
        leaf = distribute_tensor(torch.ones(4), mesh, [Replicate()])
        with pytest.raises(NotImplementedError, match="DTensor"):
            device_digest.fingerprint_any(leaf)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- leaves of every kind


LEAVES = {
    "f32": lambda v: torch.arange(300, dtype=torch.float32) * 0.5 + v,
    "bf16": lambda v: (torch.arange(64, dtype=torch.float32) / 7 + v).to(torch.bfloat16),
    "i64": lambda v: torch.arange(-8, 8, dtype=torch.int64).reshape(4, 4) * int(v + 1),
    "u8": lambda v: torch.full((5, 3), int(v) % 255, dtype=torch.uint8),
    "bool": lambda v: torch.arange(6) % 3 == int(v) % 3,
    "scalar": lambda v: torch.tensor(v, dtype=torch.float32),
    "object": lambda v: frozenset({int(v), 100}),
    "int": lambda v: int(v) * 3,
    "numpy": lambda v: np.full((3, 2), v, np.float32),
}


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", sorted(LEAVES))
def test_every_leaf_kind_replays_bit_exact(tmp_path, journaling, kind) -> None:
    make = LEAVES[kind]
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = P.StateDict(x=make(0), keep=torch.ones(3))
    mgr.save(0, {"app": st})
    st["x"] = make(2)
    assert mgr.journal_step(1, {"app": st})
    records, err = journal.scan_segment(_segment(mgr, 0))
    assert err is None and [h["key"] for h, _ in records] == ["app/x"]
    want_kind = "object" if kind in ("object", "int") else "array"
    assert records[0][0]["kind"] == want_kind
    if kind == "bf16":
        assert records[0][0]["dtype"] == "bfloat16"
    dst = P.StateDict(x=make(-5), keep=torch.zeros(3))
    held = dst["x"]
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert _equal(dst["x"], make(2)) and torch.equal(dst["keep"], torch.ones(3))
    if isinstance(held, torch.Tensor):
        assert dst["x"] is held  # replayed in place


def test_replay_into_another_shape_makes_a_new_tensor(tmp_path, journaling) -> None:
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = P.StateDict(x=torch.ones(4))
    mgr.save(0, {"app": st})
    st["x"] = torch.arange(6, dtype=torch.float32)
    assert mgr.journal_step(1, {"app": st})
    # The base restore needs the base's shape; the replay then replaces it.
    dst = P.StateDict(x=torch.zeros(4))
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert torch.equal(dst["x"], torch.arange(6, dtype=torch.float32))


# ---------------------------------------------------- the dirty detector


def test_fingerprint_any_matches_jax_for_host_values() -> None:
    from torchsnapshot_tpu import device_digest as jax_dd

    a = np.arange(77, dtype=np.float32) / 3
    assert device_digest.fingerprint_any(a) == jax_dd.fingerprint_any(a)
    for obj in (5, "run", {"a": (1, 2.5)}, None):
        assert device_digest.fingerprint_any(obj) == jax_dd.fingerprint_any(obj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.uint8,
                                   torch.bool])
def test_fingerprint_any_of_a_cpu_tensor_is_the_plain_device_digest(dtype) -> None:
    """A CPU tensor goes through K4's plain version, and the digest equals
    the JAX package's device digest of the same array (int64 aside: the
    JAX tests run without x64)."""
    import jax.numpy as jnp

    from torchsnapshot_tpu import device_digest as jax_dd

    t = (torch.arange(1000) % 7).to(dtype)
    fp, kind = device_digest.fingerprint_any(t)
    assert kind == "array" and fp == device_digest.device_fingerprint(t)
    if dtype == torch.bfloat16:
        jax_arr = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    else:
        jax_arr = jnp.asarray(t.numpy())
    assert jax_dd.fingerprint_any(jax_arr) == (fp, "array")


def test_fingerprint_all_fetches_once_for_many_tensors(monkeypatch) -> None:
    fetches = []
    orig = device_digest._fetch
    monkeypatch.setattr(device_digest, "_fetch", lambda p: fetches.append(len(p)) or orig(p))
    leaves = [torch.full((10,), float(i)) for i in range(26)] + [3, np.ones(2)]
    out = device_digest.fingerprint_all(leaves)
    assert fetches == [26]
    assert [fp for fp, _ in out[:26]] == [device_digest.device_fingerprint(t) for t in leaves[:26]]
    assert [k for _, k in out] == ["array"] * 26 + ["object", "array"]


# ------------------------------------------------- across the two packages


def _jax_leaves():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((40, 6)).astype(np.float32),
        "bf": (np.arange(32, dtype=np.float32) / 9).astype(jnp.bfloat16),
        "i": rng.integers(-100, 100, (7,)).astype(np.int32),
    }


def _to_torch(v):
    if str(v.dtype) == "bfloat16":
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(v))


def test_record_bytes_equal_jax_once_gen_is_fixed() -> None:
    import jax.numpy as jnp

    from torchsnapshot_tpu import journal as jax_journal

    for name, v in _jax_leaves().items():
        jf, jp = jax_journal._serialize_leaf(jnp.asarray(v), "array")
        pf, pp = journal._serialize_leaf(_to_torch(v), "array")
        assert jf == pf, name
        header = {"v": 1, "gen": "0" * 32, "epoch": 3, "key": f"app/{name}"}
        assert journal.encode_record({**header, **pf}, pp) == jax_journal.encode_record(
            {**header, **jf}, jp
        )
    jf, jp = jax_journal._serialize_leaf(7, "object")
    pf, pp = journal._serialize_leaf(7, "object")
    assert jf == pf and bytes(jp) == bytes(pp)


def test_port_journal_replays_in_jax(tmp_path, journaling, monkeypatch) -> None:
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    leaves = _jax_leaves()
    mgr = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = P.StateDict(**{k: _to_torch(v) for k, v in leaves.items()}, step=0)
    mgr.save(0, {"app": st})
    st["w"] = st["w"] * 2
    st["bf"] = st["bf"] + 1
    st["step"] = 5
    assert mgr.journal_step(1, {"app": st})
    st["i"] = st["i"] - 1
    assert mgr.journal_step(2, {"app": st})

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
    dst = J.StateDict(**{k: jnp.zeros(v.shape, v.dtype) for k, v in leaves.items()}, step=0)
    assert J.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert np.array_equal(np.asarray(dst["w"]), st["w"].numpy())
    assert np.array_equal(np.asarray(dst["bf"]).astype(np.float32), st["bf"].float().numpy())
    assert np.array_equal(np.asarray(dst["i"]), st["i"].numpy())
    assert dst["step"] == 5


def test_jax_journal_replays_in_port(tmp_path, journaling, monkeypatch) -> None:
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_JOURNAL", "1")
    leaves = _jax_leaves()
    mgr = J.CheckpointManager(str(tmp_path), save_interval_steps=100)
    st = J.StateDict(**{k: jnp.asarray(v) for k, v in leaves.items()}, step=0)
    mgr.save(0, {"app": st})
    st["w"] = st["w"] * 3
    st["bf"] = st["bf"] - 2
    st["step"] = 9
    assert mgr.journal_step(1, {"app": st})

    dst = P.StateDict(**{k: torch.zeros(v.shape, dtype=_to_torch(v).dtype)
                         for k, v in leaves.items()}, step=0)
    assert P.CheckpointManager(str(tmp_path)).restore({"app": dst}) == 0
    assert np.array_equal(dst["w"].numpy(), np.asarray(st["w"]))
    assert np.array_equal(dst["bf"].float().numpy(), np.asarray(st["bf"]).astype(np.float32))
    assert np.array_equal(dst["i"].numpy(), leaves["i"]) and dst["step"] == 9
    # And the port continues the JAX package's chain.
    dst["step"] = 10
    pm = P.CheckpointManager(str(tmp_path), save_interval_steps=100)
    assert pm.restore({"app": dst}) == 0
    dst["step"] = 11
    assert pm.journal_step(2, {"app": dst})
    again = J.StateDict(**{k: jnp.zeros(v.shape, v.dtype) for k, v in leaves.items()}, step=0)
    assert J.CheckpointManager(str(tmp_path)).restore({"app": again}) == 0
    assert again["step"] == 11


# ----------------------------------------------------------- two processes


def _world_worker(rank: int, world_size: int, root: str, phase: str) -> dict:
    import os

    import torch

    import torchsnapshot_tpu_torch as P
    from torchsnapshot_tpu_torch import journal

    os.environ["TORCHSNAPSHOT_GPU_JOURNAL"] = "1"
    st = P.StateDict(w=torch.full((16,), float(rank)), step=0)
    mgr = P.CheckpointManager(root, save_interval_steps=100)
    if phase == "write":
        mgr.save(0, {"app": st})
        for e in (1, 2):
            st["w"] = torch.full((16,), float(10 * e + rank))
            st["step"] = e
            assert mgr.journal_step(e, {"app": st})
        return {"epoch": mgr._journal.epoch}
    step = mgr.restore({"app": st})
    jdir = os.path.join(mgr.path_for(0), journal.JOURNAL_DIRNAME)
    meta = journal.committed_epochs(journal.read_epoch_metas(jdir))[-1]
    return {"step": step, "w": st["w"].tolist(), "s": st["step"], "world": meta["world_size"],
            "segments": sorted(n for n in os.listdir(jdir) if n.endswith(".seg"))}


def test_world_of_two_processes_journals_and_replays(tmp_path) -> None:
    root = str(tmp_path / "ckpt")
    wrote = run_with_subprocesses(_world_worker, 2, root, "write")
    assert {r["epoch"] for r in wrote.values()} == {2}
    read = run_with_subprocesses(_world_worker, 2, root, "read")
    for rank, res in read.items():
        assert res["step"] == 0 and res["s"] == 2 and res["world"] == 2
        assert res["w"] == [float(20 + rank)] * 16
        assert res["segments"] == ["rank_0.seg", "rank_1.seg"]
    # One process cannot replay a world of two's journal: the base stands.
    dst = P.StateDict(w=torch.zeros(16), step=-1)
    P.Snapshot(os.path.join(root, "step_0000000000")).restore({"app": dst})
    assert torch.equal(dst["w"], torch.zeros(16)) and dst["step"] == 0
