"""The port's embedding model against the JAX package's.

The single-device cases of ``tests/test_embedding_model.py`` at its size
(3 tables of 64 x 8, 13 dense features, MLP (16,), batch 16). Inputs are
drawn with numpy from a seed; the JAX package initializes the parameters
and ``params_from_numpy`` carries them into the port.

The JAX tests train with ``optax.adagrad``; the port's ``init_state`` and
``make_train_step`` take the port's own optimizer (AdamW in optax's state
layout, a deliberate difference), so the JAX side here runs
``optax.adamw`` with the same hyperparameters (lr 1e-2, b1 0.9, b2 0.95,
weight decay 0.01).

Bars: logits and loss within 1e-6, gradients within 1e-6 (f32, the
frameworks sum in other orders); two optimizer steps' params and moments
within rtol 1e-5 plus atol 1e-7. Unlike ``tests/test_torch_train.py``,
whose optimizer test feeds both frameworks the same gradients, here each
computes its own, and Adam's scale-free update ``mu / sqrt(nu)`` turns a
rounding difference of a small gradient entry (a few 1e-7 relative) into
the same relative difference of a full-size step: at lr 1e-2 up to about
2e-8 absolute after two steps.
Train states cross between the packages bit-exact, and a step after a
restore is bit-identical to one without it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.flatten import flatten as jax_flatten
from torchsnapshot_tpu.models import embedding as JE
from torchsnapshot_tpu.models.transformer import make_optimizer as jax_make_optimizer
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import embedding as PE
from torchsnapshot_tpu_torch.models import transformer as T

SMALL = dict(n_tables=3, rows_per_table=64, dim=8, mlp_hidden=(16,))
LR = 1e-2


def _batch(seed: int, n: int = 16):
    rng = np.random.default_rng(seed)
    arrays = {
        "dense": rng.standard_normal((n, 13)).astype(np.float32),
        "sparse_ids": rng.integers(0, 64, (n, 3)).astype(np.int32),
        "labels": rng.integers(0, 2, (n,)).astype(np.float32),
    }
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _to_port(tree):
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _leaves(tree, flatten) -> dict:
    return {
        p: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
        for p, x in flatten(tree)[1].items()
    }


def test_config_and_param_layout_match_jax() -> None:
    for kw in ({}, SMALL):
        assert PE.EmbeddingConfig(**kw).param_count == JE.EmbeddingConfig(**kw).param_count
    assert PE.EmbeddingConfig().param_count == 51_351_169
    jp = JE.init_params(jax.random.PRNGKey(0), JE.EmbeddingConfig(**SMALL))
    pp = PE.init_params(PE.EmbeddingConfig(**SMALL), torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree, fl: {p: tuple(x.shape) for p, x in fl(tree)[1].items()}  # noqa: E731
    assert shapes(pp, port_flatten) == shapes(jp, jax_flatten)
    assert all(not pp["mlp"][f"b{j}"].any() for j in range(2))


def test_forward_loss_and_gradients_match_jax() -> None:
    jcfg, pcfg = JE.EmbeddingConfig(**SMALL), PE.EmbeddingConfig(**SMALL)
    jparams = JE.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    jbatch, pbatch = _batch(1)
    logits = PE.forward(params, pbatch["dense"], pbatch["sparse_ids"], pcfg)
    jlogits = JE.forward(jparams, jbatch["dense"], jbatch["sparse_ids"], jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-6, rtol=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(JE.loss_fn), static_argnums=2)(jparams, jbatch, jcfg)
    loss, grads = T.value_and_grad(PE.loss_fn, params, pbatch, pcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-6
    want, got = _leaves(jgrads, jax_flatten), _leaves(grads, port_flatten)
    assert got.keys() == want.keys() and len(got) == 7
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6, rtol=0, err_msg=path)


def test_sigmoid_binary_cross_entropy_is_optaxs() -> None:
    import optax

    x = np.linspace(-30, 30, 121).astype(np.float32)
    labels = (np.arange(121) % 3 == 0).astype(np.float32)
    want = optax.sigmoid_binary_cross_entropy(jnp.asarray(x), jnp.asarray(labels))
    got = PE.sigmoid_binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_two_train_steps_match_optax_adamw() -> None:
    jcfg, pcfg = JE.EmbeddingConfig(**SMALL), PE.EmbeddingConfig(**SMALL)
    tx = jax_make_optimizer(LR)
    jstate = JE.init_state(jax.random.PRNGKey(0), jcfg, tx)
    opt = T.make_optimizer(LR)
    state = PE.init_state(torch.Generator(), pcfg, opt, device="cpu")
    with torch.no_grad():
        for path, t in port_flatten(state["params"])[1].items():
            t.copy_(torch.from_numpy(np.array(jax_flatten(jstate["params"])[1][path])))
    jstep = jax.jit(JE.make_train_step(jcfg, tx))
    step = PE.make_train_step(pcfg, opt)
    for seed in (2, 3):
        jbatch, pbatch = _batch(seed)
        jstate, jloss = jstep(jstate, jbatch)
        _, loss = step(state, pbatch)
        assert abs(loss.item() - float(jloss)) <= 1e-6
    assert int(state["step"]) == 2 and int(state["opt_state"][0].count) == 2
    want, got = _leaves(jstate, jax_flatten), _leaves(state, port_flatten)
    assert got.keys() == want.keys() and len(got) == 23
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5, atol=1e-7, err_msg=path)


def _port_state(seed: int):
    opt = T.make_optimizer(LR)
    cfg = PE.EmbeddingConfig(**SMALL)
    return PE.make_train_step(cfg, opt), PE.init_state(
        torch.Generator().manual_seed(seed), cfg, opt, device="cpu")


def test_jax_written_train_state_restores_bit_exact_into_the_port(tmp_path) -> None:
    jcfg = JE.EmbeddingConfig(**SMALL)
    tx = jax_make_optimizer(LR)
    jstate = JE.init_state(jax.random.PRNGKey(0), jcfg, tx)
    jstate, _ = jax.jit(JE.make_train_step(jcfg, tx))(jstate, _batch(3)[0])
    J.Snapshot.take(str(tmp_path / "s"), {"train": J.StateDict(**jstate)})
    _, dst = _port_state(5)
    holder = P.StateDict(dst)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want, got = _leaves(jstate, jax_flatten), _leaves(dict(holder), port_flatten)
    assert got.keys() == want.keys() and len(got) == 23
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


def test_port_written_train_state_restores_bit_exact_into_jax(tmp_path) -> None:
    step, state = _port_state(0)
    step(state, _batch(3)[1])
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state)})
    jcfg = JE.EmbeddingConfig(**SMALL)
    holder = J.StateDict(**JE.init_state(jax.random.PRNGKey(1), jcfg, jax_make_optimizer(LR)))
    J.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want, got = _leaves(state, port_flatten), _leaves(dict(holder), jax_flatten)
    assert got.keys() == want.keys() and len(got) == 23
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


def test_a_step_after_restore_is_bit_identical(tmp_path) -> None:
    step, state = _port_state(0)
    _, batch = _batch(4)
    _, loss1 = step(state, batch)
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state)})
    _, loss2 = step(state, batch)
    after = {p: t.clone() for p, t in port_flatten(state)[1].items()}
    _, fresh = _port_state(1)
    holder = P.StateDict(fresh)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    _, loss2_again = step(dict(holder), batch)
    assert torch.equal(loss2_again, loss2) and loss2.item() < loss1.item()
    for path, t in port_flatten(dict(holder))[1].items():
        assert torch.equal(t, after[path]), path


def test_a_mesh_raises_by_name() -> None:
    cfg = PE.EmbeddingConfig(**SMALL)
    # The mesh path exists (tests/test_torch_embedding_mesh.py); only a
    # DeviceMesh is a mesh.
    with pytest.raises(TypeError, match="DeviceMesh"):
        PE.make_train_step(cfg, T.make_optimizer(), mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        PE.init_state(torch.Generator(), cfg, T.make_optimizer(), "cpu", mesh=object())
