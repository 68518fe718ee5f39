"""The port's reference-format (pytorch/torchsnapshot) interop against the
JAX package's.

- The committed fixture (``tests/data/reference_snapshot``) loads to the
  same state in both packages: the port's tensors carry the stored dtype
  (bf16 natively), the JAX package's arrays the ml_dtypes one; the bytes
  are equal.
- Hand-written multi-rank manifests (sharded, replicated, per-rank,
  interleaved lists) load alike, and both packages refuse the same broken
  ones with the same ``ValueError``.
- ``migrate`` both ways, through the library and through both CLIs: the
  native snapshot either package migrates restores bit-exact in the other,
  and a migrated-back reference snapshot loads identically in both.

PyYAML reads and writes the manifest in both packages, and the port's
GPU hosts have it too, so the port carries no YAML reader of its own.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.tricks import torchsnapshot_interop as jax_tsi
from torchsnapshot_tpu_torch.tricks import torchsnapshot_interop as tsi
from torch_cli_env import both, to_torch
from torch_test_env import autotune_never  # noqa: F401 - autouse

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "reference_snapshot")


def _as_numpy(v):
    """A port tensor as the JAX package's numpy array (ml_dtypes for the
    dtypes numpy lacks)."""
    import ml_dtypes

    if v.dtype == torch.bfloat16:
        return v.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    for name in ("float8_e4m3fn", "float8_e5m2"):
        if v.dtype == getattr(torch, name):
            return v.view(torch.uint8).numpy().view(getattr(ml_dtypes, name))
    return v.numpy()


def assert_same_tree(mine, theirs) -> None:
    """Port state == JAX state, leaf by leaf, bit-exact with dtypes."""
    if isinstance(mine, torch.Tensor):
        arr = _as_numpy(mine)
        assert isinstance(theirs, np.ndarray)
        assert arr.dtype == theirs.dtype and arr.shape == theirs.shape
        assert arr.tobytes() == theirs.tobytes()
        return
    assert type(mine) is type(theirs), (mine, theirs)
    if isinstance(mine, dict):
        assert list(mine) == list(theirs)
        for k in mine:
            assert_same_tree(mine[k], theirs[k])
    elif isinstance(mine, (list, tuple)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert_same_tree(a, b)
    else:
        assert mine == theirs


def test_the_fixture_loads_alike() -> None:
    mine, theirs = tsi.load_torchsnapshot(FIXTURE), jax_tsi.load_torchsnapshot(FIXTURE)
    assert_same_tree(mine, theirs)
    app = mine["app"]
    assert torch.equal(app["weights"], torch.arange(48, dtype=torch.float32).reshape(6, 8))
    assert app["bf"].dtype == torch.bfloat16
    assert torch.equal(app["bf"].float(), torch.arange(6, dtype=torch.float32))
    assert (app["step"], app["lr"], app["done"], app["name"], app["blob"]) == (
        7, 0.125, False, "run/alpha", b"\x00\x01\xff")
    assert torch.equal(app["nested"]["esc/key"], torch.ones(2, dtype=torch.int8))
    assert app["opt"]["momenta"] == (0.9, 0.999)
    assert tsi.read_metadata(FIXTURE) == jax_tsi.read_metadata(FIXTURE)
    assert len(tsi.read_metadata(FIXTURE)["manifest"]["0/app/weights"]["chunks"]) >= 3
    # Loaded tensors are writable.
    app["weights"] += 1
    app["nested"]["b"]["c"] += 1


def _buffer_entry(location, arr):
    return {"type": "Tensor", "location": location, "serializer": "buffer_protocol",
            "dtype": f"torch.{arr.dtype.name}", "shape": list(arr.shape),
            "replicated": False, "byte_range": None}


def _write_snapshot(root, files, manifest, world_size):
    for loc, arr in files.items():
        p = os.path.join(root, loc)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())
    with open(os.path.join(root, ".snapshot_metadata"), "w") as f:
        yaml.safe_dump({"version": "0.0.3", "world_size": world_size, "manifest": manifest}, f,
                       sort_keys=False)


def _multirank(root):
    """World 2: sharded rows merged across ranks, a replicated entry, a
    per-rank entry, and a list of 12 with a container inside."""
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    files = {"sharded/model/emb_r0": full[:4], "sharded/model/emb_r1": full[4:],
             "replicated/model/scale": np.ones(3, np.int32),
             "0/model/local": np.zeros(2, np.float32)}
    manifest = {}
    for rank in (0, 1):
        manifest[f"{rank}/model"] = {
            "type": "dict", "keys": ["emb", "scale", "l"] + (["local"] if rank == 0 else [])}
        lo = rank * 4
        manifest[f"{rank}/model/emb"] = {"type": "ShardedTensor", "shards": [
            {"offsets": [lo, 0], "sizes": [4, 4],
             "tensor": _buffer_entry(f"sharded/model/emb_r{rank}", full[lo:lo + 4])}]}
        scale = _buffer_entry("replicated/model/scale", files["replicated/model/scale"])
        scale["replicated"] = True
        manifest[f"{rank}/model/scale"] = scale
        manifest[f"{rank}/model/l"] = {"type": "list"}
        for i in range(12):
            loc = f"{rank}/model/l/{i}_leaf"
            if i == 1:
                continue
            files[loc] = np.full((2,), i + 10 * rank, np.float32)
            manifest[f"{rank}/model/l/{i}"] = _buffer_entry(loc, files[loc])
        manifest[f"{rank}/model/l/1"] = {"type": "dict", "keys": ["x"]}
        files[f"{rank}/model/l/1/x"] = np.array([99.0 + rank], np.float32)
        manifest[f"{rank}/model/l/1/x"] = _buffer_entry(f"{rank}/model/l/1/x",
                                                        files[f"{rank}/model/l/1/x"])
    manifest["0/model/local"] = _buffer_entry("0/model/local", files["0/model/local"])
    _write_snapshot(root, files, manifest, 2)


@pytest.mark.parametrize("rank", [0, 1])
def test_a_multirank_manifest_loads_alike(tmp_path, rank) -> None:
    root = str(tmp_path / "snap")
    _multirank(root)
    mine = tsi.load_torchsnapshot(root, rank=rank)
    assert_same_tree(mine, jax_tsi.load_torchsnapshot(root, rank=rank))
    assert torch.equal(mine["model"]["emb"], torch.arange(32, dtype=torch.float32).reshape(8, 4))
    assert ("local" in mine["model"]) == (rank == 0)
    assert len(mine["model"]["l"]) == 12


def _lost_rank(root):
    top = np.arange(32, dtype=np.float32).reshape(8, 4)[:4]
    _write_snapshot(root, {"sharded/model/emb_r0": top}, {
        "0/model": {"type": "dict", "keys": ["emb"]},
        "0/model/emb": {"type": "ShardedTensor", "shards": [
            {"offsets": [0, 0], "sizes": [4, 4],
             "tensor": _buffer_entry("sharded/model/emb_r0", top)}]}}, 2)


def _quantized(root):
    entry = _buffer_entry("0/q", np.zeros(4, np.int8))
    entry["serializer"] = "per_tensor_affine_qtensor"
    _write_snapshot(root, {"0/q": np.zeros(4, np.int8)},
                    {"0/app": {"type": "dict", "keys": ["q"]}, "0/app/q": entry}, 1)


def _truncated(root):
    entry = _buffer_entry("0/t", np.zeros(8, np.float32))
    _write_snapshot(root, {"0/t": np.zeros(3, np.float32)},
                    {"0/app": {"type": "dict", "keys": ["t"]}, "0/app/t": entry}, 1)


def _gap(root):
    full = np.zeros((4, 4), np.float32)
    _write_snapshot(root, {"c0": full[:2]}, {
        "0/app": {"type": "dict", "keys": ["w"]},
        "0/app/w": {"type": "ChunkedTensor", "dtype": "torch.float32", "shape": [4, 4],
                    "chunks": [{"offsets": [0, 0], "sizes": [2, 4],
                                "tensor": _buffer_entry("c0", full[:2])}]}}, 1)


def _bad_dtype(root):
    entry = _buffer_entry("0/t", np.zeros(2, np.float32))
    entry["dtype"] = "torch.qint8"
    _write_snapshot(root, {"0/t": np.zeros(2, np.float32)},
                    {"0/app": {"type": "dict", "keys": ["t"]}, "0/app/t": entry}, 1)


@pytest.mark.parametrize("broken,match", [
    (_lost_rank, "incomplete"), (_quantized, "quantized tensor"), (_truncated, "truncated"),
    (_gap, "missing or duplicating"), (_bad_dtype, "Cannot map torch dtype"),
    (None, "did not save this snapshot")])
def test_broken_snapshots_are_refused_alike(tmp_path, broken, match) -> None:
    root, rank = str(tmp_path / "snap"), 0
    if broken is None:
        root, rank = FIXTURE, 3
    else:
        broken(root)
    with pytest.raises(ValueError, match=match):
        tsi.load_torchsnapshot(root, rank=rank)
    with pytest.raises(ValueError, match=match.replace("quantized tensor", "quantized")):
        jax_tsi.load_torchsnapshot(root, rank=rank)


def _zeros_like(tree, pkg):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree) if pkg == "port" else np.zeros_like(_as_numpy(tree))
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree) if pkg == "jax" else torch.zeros_like(to_torch(tree))
    if isinstance(tree, dict):
        return {k: _zeros_like(v, pkg) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v, pkg) for v in tree)
    return tree


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_migrated_snapshot_restores_bit_exact_in_both(tmp_path, writer) -> None:
    dst = str(tmp_path / "native")
    if writer == "port":
        _, state = tsi.migrate_from_torchsnapshot(FIXTURE, dst)
    else:
        _, state = jax_tsi.migrate_from_torchsnapshot(FIXTURE, dst)
    expect = tsi.load_torchsnapshot(FIXTURE)["app"]
    port_dst = P.StateDict(_zeros_like(expect, "port"))
    P.Snapshot(dst).restore({"app": port_dst})
    assert_same_tree(dict(port_dst), jax_tsi.load_torchsnapshot(FIXTURE)["app"])
    jax_dst = J.StateDict(_zeros_like(expect, "jax"))
    J.Snapshot(dst).restore({"app": jax_dst})
    assert_same_tree(expect, dict(jax_dst))
    # Both packages' migrations of the fixture describe the same manifest.
    other = str(tmp_path / "other")
    (jax_tsi if writer == "port" else tsi).migrate_from_torchsnapshot(FIXTURE, other)
    for argv in (["ls", "--all"], ["info"]):
        a = both([argv[0], dst, *argv[1:]])[1]
        b = both([argv[0], other, *argv[1:]])[1]
        assert (a[0], a[1].replace(dst, "X")) == (b[0], b[1].replace(other, "X"))


def test_migrate_through_both_clis(tmp_path) -> None:
    results = []
    for name in ("jax", "port"):
        dst = str(tmp_path / name)
        res = both(["migrate", FIXTURE, dst])[0 if name == "jax" else 1]
        results.append((res[0], res[1].replace(dst, "DST"), res[2]))
        assert both(["fsck", dst])[1][0] == 0
    assert results[0] == results[1]
    assert results[1][0] == 0 and results[1][1].startswith("migrated ")
    # A native snapshot is not migrated again.
    jax_res, port_res = both(["migrate", str(tmp_path / "port"), str(tmp_path / "again")])
    assert port_res == jax_res and port_res[0] == 1 and "already a native snapshot" in port_res[1]


def test_migrate_back_writes_what_the_jax_package_writes(tmp_path) -> None:
    """A native snapshot migrated back to the reference format: the port's
    manifest and buffer payloads equal the JAX package's byte for byte,
    torch_save payloads load equal, and each package's reader loads both."""
    native = str(tmp_path / "native")
    tsi.migrate_from_torchsnapshot(FIXTURE, native)
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    tsi.migrate_to_torchsnapshot(native, mine)
    jax_tsi.migrate_to_torchsnapshot(native, theirs)
    with open(os.path.join(mine, ".snapshot_metadata")) as f, \
            open(os.path.join(theirs, ".snapshot_metadata")) as g:
        assert f.read() == g.read()
    meta = tsi.read_metadata(mine)
    for entry in meta["manifest"].values():
        tensors = [c["tensor"] for c in entry.get("chunks", [])]
        if entry.get("type") == "Tensor":
            tensors.append(entry)
        for t in tensors:
            a = open(os.path.join(mine, t["location"]), "rb").read()
            b = open(os.path.join(theirs, t["location"]), "rb").read()
            if t["serializer"] == "buffer_protocol":
                assert a == b
    for root in (mine, theirs):
        assert_same_tree(tsi.load_torchsnapshot(root), jax_tsi.load_torchsnapshot(root))
    assert_same_tree(tsi.load_torchsnapshot(mine)["app"], jax_tsi.load_torchsnapshot(FIXTURE)["app"])


def test_save_as_round_trips_every_dtype(tmp_path) -> None:
    """bf16 exports as buffer-protocol bytes, fp8 through torch_save (the
    reference predates fp8); CUDA-free here, CPU tensors either way."""
    state = {"app": {
        "f32": torch.linspace(-1, 1, 6), "bf": torch.arange(4, dtype=torch.float32).bfloat16(),
        "f8": torch.ones(3).to(torch.float8_e4m3fn), "i64": torch.arange(3),
        "b": torch.tensor([True, False]), "c": torch.ones(2, dtype=torch.complex64),
        "np": np.arange(4, dtype=np.int16), "s": torch.tensor(1.5),
        "prims": [1, 2.5, "x", b"\x01", True], "obj": {"betas": (0.9, 0.99)}}}
    root = str(tmp_path / "ref")
    tsi.save_as_torchsnapshot(state, root)
    manifest = tsi.read_metadata(root)["manifest"]
    assert manifest["0/app/bf"]["type"] == "ChunkedTensor"
    assert manifest["0/app/f8"]["serializer"] == "torch_save"
    back = tsi.load_torchsnapshot(root)["app"]
    for k in ("f32", "bf", "f8", "i64", "b", "c", "s"):
        assert back[k].dtype == state["app"][k].dtype
        assert torch.equal(back[k].view(torch.uint8) if back[k].dim() else back[k],
                           state["app"][k].view(torch.uint8) if back[k].dim() else state["app"][k])
    assert torch.equal(back["np"], torch.arange(4, dtype=torch.int16))
    assert back["prims"] == [1, 2.5, "x", b"\x01", True] and back["obj"] == {"betas": (0.9, 0.99)}
    assert_same_tree(back, jax_tsi.load_torchsnapshot(root)["app"])


def test_save_as_never_overwrites_an_aliased_location(tmp_path) -> None:
    """Tensor ``w`` lands at ``0/app/w_0`` and an object named ``w_0``
    would too: the second gets a suffixed location, as in JAX."""
    state = {"app": {"w": torch.ones(4), "w_0": {1, 2}}}
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    tsi.save_as_torchsnapshot(state, mine)
    jax_tsi.save_as_torchsnapshot({"app": {"w": np.ones(4, np.float32), "w_0": {1, 2}}}, theirs)
    assert tsi.read_metadata(mine) == tsi.read_metadata(theirs)
    back = tsi.load_torchsnapshot(mine)["app"]
    assert torch.equal(back["w"], torch.ones(4)) and back["w_0"] == {1, 2}
    shutil.rmtree(theirs)
