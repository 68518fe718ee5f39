"""The port's adapters (``tricks/``) against the JAX package's.

- ``PytreeAdapter`` keys every leaf by the path string
  ``jax.tree_util.keystr`` gives (``None`` an empty subtree), so a tree
  snapshotted by either package's adapter restores bit-exact in the other.
- ``TrainStateAdapter`` stores the port's train state under the layout
  that flax's ``to_state_dict`` gives the JAX package's
  ``FlaxTrainStateAdapter``, so the two cross-restore; ``adapter.state``
  is replaced on load.
- ``dcp_interop`` migrates to and from ``torch.distributed.checkpoint``
  in one process with no process group; a snapshot it writes restores in
  the JAX package, as one the JAX package's orbax migration writes
  restores in the port.
- Importing ``tricks`` pulls in nothing third-party.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.tricks import FlaxTrainStateAdapter as JaxTrainStateAdapter
from torchsnapshot_tpu.tricks import PytreeAdapter as JaxPytreeAdapter
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.tricks import PytreeAdapter, TrainStateAdapter
from torch_cli_env import to_torch
from torch_test_env import autotune_never  # noqa: F401 - autouse

NT = collections.namedtuple("NT", "x y")


def _np_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"b": {"c": rng.standard_normal((2, 3)).astype(np.float32)},
            "a": [rng.standard_normal(4).astype(np.float32),
                  (rng.integers(0, 9, 3).astype(np.int32), 3)],
            "t": NT(rng.standard_normal(2).astype(np.float32), np.full(1, 2.0, np.float32)),
            "n": None}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, NT):
        return NT(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, np.ndarray) else tree


def _to_jax(tree):
    import jax.numpy as jnp

    return _map(tree, jnp.asarray)


def test_pytree_keys_equal_jax_keystr() -> None:
    tree = _np_tree(0)
    mine = PytreeAdapter(_map(tree, to_torch)).state_dict()
    theirs = JaxPytreeAdapter(_to_jax(tree)).state_dict()
    assert set(mine) == set(theirs)
    assert "['a'][1][0]" in mine and "['t'].x" in mine and "['a'][1][1]" in mine
    for k, v in mine.items():
        assert np.array_equal(np.asarray(v), np.asarray(theirs[k])), k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pytree_snapshots_cross_restore(tmp_path, writer) -> None:
    tree = _np_tree(1)
    snap = str(tmp_path / "snap")
    if writer == "port":
        P.Snapshot.take(snap, {"t": PytreeAdapter(_map(tree, to_torch))})
    else:
        J.Snapshot.take(snap, {"t": JaxPytreeAdapter(_to_jax(tree))})
    zero = _map(tree, np.zeros_like)
    zero["a"][1] = (zero["a"][1][0], 0)
    mine = PytreeAdapter(_map(zero, to_torch))
    P.Snapshot(snap).restore({"t": mine})
    theirs = JaxPytreeAdapter(_to_jax(zero))
    J.Snapshot(snap).restore({"t": theirs})
    assert mine.tree["a"][1][1] == 3 and mine.tree["n"] is None
    assert isinstance(mine.tree["t"], NT)
    want = PytreeAdapter(_map(tree, to_torch)).state_dict()
    got = PytreeAdapter(mine.tree).state_dict()
    got_jax = JaxPytreeAdapter(theirs.tree).state_dict()
    for k, v in want.items():
        assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes(), k
        assert np.asarray(got_jax[k]).tobytes() == np.asarray(v).tobytes(), k


def test_a_pytree_of_another_structure_is_refused(tmp_path) -> None:
    P.Snapshot.take(str(tmp_path / "s"), {"t": PytreeAdapter({"x": torch.ones(3)})})
    with pytest.raises(Exception):
        P.Snapshot(str(tmp_path / "s")).restore({"t": PytreeAdapter({"y": torch.ones(3)})})


_CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq_len=16)


def _port_train_state(seed: int, steps: int):
    cfg = T.TransformerConfig(**_CFG)
    opt = T.make_optimizer(1e-3)
    state = T.init_state(torch.Generator().manual_seed(seed), cfg, opt, device="cpu")
    step = T.make_train_step(cfg, opt)
    g = torch.Generator().manual_seed(100 + seed)
    for _ in range(steps):
        tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
        step(state, {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})
    return state


def _flat(state):
    return TrainStateAdapter(state).state_dict()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_train_state_round_trip_replaces_the_state(tmp_path) -> None:
    src = _port_train_state(0, 2)
    snap = str(tmp_path / "snap")
    P.Snapshot.take(snap, {"train": TrainStateAdapter(src)})
    dst = TrainStateAdapter(_port_train_state(1, 0))
    before = dst.state
    P.Snapshot(snap).restore({"train": dst})
    assert dst.state is not before and set(dst.state) == {"params", "opt_state", "step"}
    assert isinstance(dst.state["opt_state"][0], type(src["opt_state"][0]))
    assert int(dst.state["step"]) == 2
    for (pa, a), (pb, b) in zip(_leaves(_flat(dst.state)), _leaves(_flat(src))):
        assert pa == pb and torch.equal(a, b), pa
    # The restored state still steps.
    cfg, opt = T.TransformerConfig(**_CFG), T.make_optimizer(1e-3)
    zeros = torch.zeros((2, 8), dtype=torch.long)
    T.make_train_step(cfg, opt)(dst.state, {"tokens": zeros, "targets": zeros})
    assert int(dst.state["step"]) == 3


def _flax_train_state(port_state):
    """The JAX package's flax ``TrainState`` of the same tree: the port's
    params, optax.adamw's state with the port's moments and count."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.training import train_state

    def j(t):
        return jnp.asarray(t.numpy())

    params = jax.tree_util.tree_map(j, port_state["params"],
                                    is_leaf=lambda x: isinstance(x, torch.Tensor))
    ts = train_state.TrainState.create(apply_fn=None, params=params,
                                       tx=optax.adamw(1e-3, weight_decay=0.1))
    adam = port_state["opt_state"][0]
    mu = jax.tree_util.tree_map(j, adam.mu, is_leaf=lambda x: isinstance(x, torch.Tensor))
    nu = jax.tree_util.tree_map(j, adam.nu, is_leaf=lambda x: isinstance(x, torch.Tensor))
    opt_state = (ts.opt_state[0]._replace(count=j(adam.count), mu=mu, nu=nu),
                 *ts.opt_state[1:])
    return ts.replace(step=j(port_state["step"]), opt_state=opt_state)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_train_state_adapters_cross_restore(tmp_path, writer) -> None:
    src = _port_train_state(2, 2)
    snap = str(tmp_path / "snap")
    if writer == "port":
        P.Snapshot.take(snap, {"train": TrainStateAdapter(src)})
    else:
        J.Snapshot.take(snap, {"train": JaxTrainStateAdapter(_flax_train_state(src))})
    mine = TrainStateAdapter(_port_train_state(3, 0))
    P.Snapshot(snap).restore({"train": mine})
    for (pa, a), (pb, b) in zip(_leaves(_flat(mine.state)), _leaves(_flat(src))):
        assert pa == pb and torch.equal(a, b), pa
    theirs = JaxTrainStateAdapter(_flax_train_state(_port_train_state(3, 0)))
    J.Snapshot(snap).restore({"train": theirs})
    from flax import serialization

    jax_flat = dict(_leaves(serialization.to_state_dict(theirs.state)))
    port_flat = dict(_leaves(_flat(src)))
    assert set(jax_flat) == set(port_flat)
    for k, v in port_flat.items():
        assert np.asarray(jax_flat[k]).tobytes() == v.numpy().tobytes(), k


def _dcp_tree():
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "step": np.full((), 5, np.int32),
            "nested": {"b": rng.standard_normal(4).astype(np.float32)}}


def test_dcp_round_trip(tmp_path) -> None:
    import torch.distributed.checkpoint as dcp

    from torchsnapshot_tpu_torch.tricks import dcp_interop

    tree = _map(_dcp_tree(), to_torch)
    tree["nested"]["bf"] = torch.arange(3, dtype=torch.float32).bfloat16()
    tree["nested"]["n"] = 7
    src, back = str(tmp_path / "dcp_src"), str(tmp_path / "dcp_back")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcp.save(tree, checkpoint_id=src, no_dist=True)
        snap = dcp_interop.migrate_from_dcp(src, str(tmp_path / "snap"))
        assert torch.equal(snap.read_object("0/app/nested/bf"), tree["nested"]["bf"])
        assert snap.read_object("0/app/nested/n") == 7
        target = {"w": torch.zeros(2, 3), "step": torch.zeros((), dtype=torch.int32),
                  "nested": {"b": torch.zeros(4), "bf": torch.zeros(3, dtype=torch.bfloat16),
                             "n": 0}}
        dcp_interop.migrate_to_dcp(str(tmp_path / "snap"), back, target)
        out = dcp_interop.load_dcp_state_dict(back)
    for k in ("w", "step"):
        assert torch.equal(out[k], tree[k])
    assert torch.equal(out["nested"]["bf"], tree["nested"]["bf"]) and out["nested"]["n"] == 7
    assert not torch.distributed.is_initialized()


def test_dcp_and_orbax_migrations_restore_in_each_other(tmp_path) -> None:
    """The same tree through DCP into a port snapshot and through orbax
    into a JAX snapshot: each snapshot restores bit-exact in the other
    package."""
    import torch.distributed.checkpoint as dcp

    from torchsnapshot_tpu.tricks.orbax_interop import migrate_from_orbax
    from torchsnapshot_tpu_torch.tricks.dcp_interop import migrate_from_dcp

    ocp = pytest.importorskip("orbax.checkpoint")
    tree = _dcp_tree()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcp.save(_map(tree, to_torch), checkpoint_id=str(tmp_path / "dcp"), no_dist=True)
        migrate_from_dcp(str(tmp_path / "dcp"), str(tmp_path / "port"))
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "orbax"), tree)
    migrate_from_orbax(str(tmp_path / "orbax"), str(tmp_path / "jax"))
    for snap in ("port", "jax"):
        mine = P.StateDict(_map(_map(tree, np.zeros_like), to_torch))
        P.Snapshot(str(tmp_path / snap)).restore({"app": mine})
        theirs = J.StateDict(_map(tree, np.zeros_like))
        J.Snapshot(str(tmp_path / snap)).restore({"app": theirs})
        for k in ("w", "step"):
            assert mine[k].numpy().tobytes() == tree[k].tobytes(), (snap, k)
            assert np.asarray(theirs[k]).tobytes() == tree[k].tobytes(), (snap, k)
        assert mine["nested"]["b"].numpy().tobytes() == tree["nested"]["b"].tobytes()


def test_importing_tricks_pulls_in_nothing_third_party() -> None:
    code = ("import sys, torchsnapshot_tpu_torch.tricks as t\n"
            "bad = [m for m in ('yaml', 'flax', 'jax', 'torch.distributed.checkpoint')"
            " if m in sys.modules]\n"
            "assert not bad, bad\n"
            "assert t.PytreeAdapter.__name__ == 'PytreeAdapter'\n"
            "assert 'yaml' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
