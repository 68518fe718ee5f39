"""The embedding model's mesh path: the port against the JAX package.

One spawned gloo world of 4 processes (on the CPU) runs each case on the
same params and batch (made from a seed with numpy): the tables
row-sharded over ``('data', 'model')`` as DTensors, one train step of
``make_train_step(mesh=)`` and one of a single process. In this process
the JAX package runs its GSPMD step on a mesh of the same shape over its
virtual CPU devices (its params placed by ``param_specs``). Bars: loss 1e-5
relative; gradients (Adam's first moment after one step, ``mu = (1 - b1)
* g``) 1e-4 against JAX and 1e-5 against one process; the updated params
1e-5 against JAX (AdamW as in ``tests/test_torch_embedding_model.py``).

The world also takes its row-sharded train state, which the JAX package
restores bit-exact into its own mesh state.
"""

from __future__ import annotations

import numpy as np
import pytest

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]

SMALL = dict(n_tables=3, rows_per_table=64, dim=8, mlp_hidden=(16,))
BATCH = 16
LR = 1e-2
CASES = {"dp2_tp2": {"data": 2, "model": 2}, "dp1_tp4": {"data": 1, "model": 4}}


def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    c = SMALL
    tables = {f"table_{i}": (rng.standard_normal((c["rows_per_table"], c["dim"]))
                             * c["dim"]**-0.5).astype(np.float32) for i in range(c["n_tables"])}
    widths = (13 + c["n_tables"] * c["dim"],) + c["mlp_hidden"] + (1,)
    mlp = {}
    for j, (a, b) in enumerate(zip(widths, widths[1:])):
        mlp[f"w{j}"] = (rng.standard_normal((a, b)) * a**-0.5).astype(np.float32)
        mlp[f"b{j}"] = (rng.standard_normal((b,)) * 0.1).astype(np.float32)
    return {"tables": tables, "mlp": mlp}


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed + 100)
    return {"dense": rng.standard_normal((BATCH, 13)).astype(np.float32),
            "sparse_ids": rng.integers(0, SMALL["rows_per_table"], (BATCH, 3)).astype(np.int32),
            "labels": rng.integers(0, 2, (BATCH,)).astype(np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _case(name: str, seed: int, root: str) -> dict:
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.models import embedding as PE
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import gather_tree

    mesh = make_mesh(CASES[name], device="cpu")
    cfg = PE.EmbeddingConfig(**SMALL)
    opt = T.make_optimizer(LR)
    params = T.params_from_numpy(_np_params(seed), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed).items()}
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    dstate = shard_pytree(state, PE.state_specs(cfg, state), mesh)
    dstate, loss = PE.make_train_step(cfg, opt, mesh=mesh)(dstate, batch)
    global_loss = PE.loss_fn(params, batch, cfg, mesh=mesh)
    state, single_loss = PE.make_train_step(cfg, opt)(state, batch)
    Snapshot.take(f"{root}/{name}", {"train": StateDict(dstate)})
    full = gather_tree(dstate, PE.state_specs(cfg, dstate), mesh)
    return {
        "loss": float(loss), "global_loss": float(global_loss), "step": int(full["step"]),
        "params": {k: v.numpy() for k, v in _flat(full["params"]).items()},
        "mu": {k: v.numpy() for k, v in _flat(full["opt_state"][0].mu).items()},
        "single_loss": float(single_loss),
        "single_mu": {k: v.numpy() for k, v in _flat(state["opt_state"][0].mu).items()},
        "local_rows": int(dstate["params"]["tables"]["table_0"].to_local().shape[0]),
    }


def _worker(rank: int, world: int, root: str) -> dict:
    import torch

    torch.set_num_threads(1)
    return {name: _case(name, seed, root) for seed, name in enumerate(sorted(CASES))}


@pytest.fixture(scope="module")
def world(tmp_path_factory) -> tuple:
    root = str(tmp_path_factory.mktemp("embedding_mesh"))
    return run_with_subprocesses(_worker, 4, root, backend="gloo", timeout=300), root


def _jax_state(name: str, seed: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from torchsnapshot_tpu.models import embedding as JE
    from torchsnapshot_tpu.models.transformer import make_optimizer
    from torchsnapshot_tpu.parallel.mesh import shard_pytree

    shape = CASES[name]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(tuple(shape.values())), tuple(shape))
    cfg = JE.EmbeddingConfig(**SMALL)
    tx = make_optimizer(LR)
    state = JE.init_state(jax.random.PRNGKey(seed), cfg, tx, mesh=mesh)
    params = shard_pytree(jax.tree_util.tree_map(jnp.asarray, _np_params(seed)),
                          JE.param_specs(cfg), mesh)
    state = {"params": params, "opt_state": tx.init(params), "step": state["step"]}
    state = shard_pytree(state, JE.state_specs(cfg, state), mesh)
    return cfg, tx, mesh, state


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_train_step_matches_jax_gspmd_and_one_process(world, name) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import embedding as JE

    ranks, _ = world
    seed = sorted(CASES).index(name)
    cfg, tx, mesh, state = _jax_state(name, seed)
    batch = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
    _, grads = jax.value_and_grad(JE.loss_fn)(state["params"], batch, cfg)
    new, loss = jax.jit(JE.make_train_step(cfg, tx, mesh=mesh))(state, batch)
    grads = _flat(jax.tree_util.tree_map(np.asarray, grads))
    params = _flat(jax.tree_util.tree_map(np.asarray, new["params"]))
    rows = SMALL["rows_per_table"] // 4
    for rank, res in ranks.items():
        r = res[name]
        assert r["step"] == 1 and r["local_rows"] == rows
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        assert abs(r["global_loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        assert abs(r["loss"] - r["single_loss"]) <= 1e-5 * abs(r["single_loss"])
        for k, g in grads.items():
            np.testing.assert_allclose(r["mu"][k] / 0.1, g, atol=1e-4, rtol=0, err_msg=k)
            np.testing.assert_allclose(r["mu"][k], r["single_mu"][k], atol=1e-5, rtol=0,
                                       err_msg=k)
            np.testing.assert_allclose(r["params"][k], params[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_row_sharded_snapshot_restores_bit_exact_in_jax(world, name) -> None:
    import jax

    import torchsnapshot_tpu as J

    ranks, root = world
    seed = sorted(CASES).index(name)
    _, _, _, dst = _jax_state(name, seed + 7)
    holder = J.StateDict(**dst)
    J.Snapshot(f"{root}/{name}").restore({"train": holder})
    got = _flat(jax.tree_util.tree_map(np.asarray, dict(holder)["params"]))
    mu = _flat(jax.tree_util.tree_map(np.asarray, dict(holder)["opt_state"][0].mu))
    want = ranks[0][name]
    assert got.keys() == want["params"].keys()
    for k in got:
        assert np.array_equal(got[k], want["params"][k]), k
        assert np.array_equal(mu[k], want["mu"][k]), k
    assert int(dict(holder)["step"]) == 1
