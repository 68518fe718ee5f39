"""The port's training path on the CPU against the JAX package's.

Config: 2 layers, d_model 64, 4 heads, vocab 256, S = 64, attention blocks
of 16. The JAX package initializes the parameters; ``params_from_numpy``
carries them into the port. The JAX loss runs its Pallas flash kernels in
interpret mode, the port the kernels' plain versions.

Bars: the f32 loss and every gradient leaf at 1e-6 absolute (the largest
gradient entries are about 0.1; the two frameworks sum in other orders,
which moved them by at most 4e-8 when this file was written); the
optimizer's f32 moments and parameters after two steps at 1e-6 relative
plus 1e-9 absolute (a few f32 steps; XLA may fuse multiply-adds that torch
rounds twice), its count exactly. Train states cross between the packages
bit-exact.
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
from torchsnapshot_tpu.models import transformer as JT
from torchsnapshot_tpu_torch.entry import train_entry
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import transformer as T

SMALL = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64)


def _configs(attn_impl: str = "flash"):
    jcfg = JT.TransformerConfig(**SMALL, dtype=jnp.float32, attn_impl=attn_impl, attn_block_size=16)
    pcfg = T.TransformerConfig(**SMALL, dtype=torch.float32, attn_impl=attn_impl, attn_block_size=16)
    return jcfg, pcfg


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    tokens, targets = (rng.integers(0, SMALL["vocab_size"], (2, 64), dtype=np.int32) for _ in range(2))
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    pbatch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    return jbatch, pbatch


def _port_train(seed: int):
    """The port's train step and a fresh train state at the small config."""
    _, pcfg = _configs()
    opt = T.make_optimizer()
    state = T.init_state(torch.Generator().manual_seed(seed), pcfg, opt, device="cpu")
    return T.make_train_step(pcfg, opt), state


def _leaves(tree, flatten) -> dict:
    """{logical path: numpy array} of a JAX or port state."""
    return {
        p: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
        for p, x in flatten(tree)[1].items()
    }


def test_loss_and_gradients_match_jax_flash() -> None:
    jcfg, pcfg = _configs("flash")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jbatch, pbatch = _batch(1)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jparams, jbatch, jcfg)
    loss, grads = T.loss_and_grads(params, pbatch, pcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-6
    want = _leaves(jgrads, jax_flatten)
    got = _leaves(grads, port_flatten)
    assert got.keys() == want.keys() and len(got) == 8
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6, rtol=0, err_msg=path)
    assert not any(p.requires_grad for p in T._leaves(params))


def test_optimizer_two_steps_match_optax() -> None:
    jcfg, pcfg = _configs()
    tx = JT.make_optimizer()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    opt = T.make_optimizer()
    jstate, state = tx.init(jparams), opt.init(params)
    rng = np.random.default_rng(2)
    for _ in range(2):
        grads_np = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, jparams
        )
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads_np), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.update(T.params_from_numpy(grads_np, device="cpu"), state, params)
    assert isinstance(state[0], T.ScaleByAdamState)
    assert state[0].count.dtype == torch.int32 and int(state[0].count) == int(jstate[0].count) == 2
    want = _leaves({"params": jparams, "opt_state": jstate}, jax_flatten)
    got = _leaves({"params": params, "opt_state": state}, port_flatten)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6, atol=1e-9, err_msg=path)


def _jax_trained_state(steps: int):
    jcfg, _ = _configs()
    tx = JT.make_optimizer()
    state = JT.init_state(jax.random.PRNGKey(0), jcfg, tx)
    step = jax.jit(JT.make_train_step(jcfg, tx))
    jbatch, _ = _batch(3)
    for _ in range(steps):
        state, _ = step(state, jbatch)
    return state


def test_jax_written_train_state_restores_bit_exact_into_the_port(tmp_path) -> None:
    jstate = _jax_trained_state(2)
    J.Snapshot.take(str(tmp_path / "s"), {"train": J.StateDict(**jstate)})
    _, pcfg = _configs()
    dst = T.init_state(torch.Generator().manual_seed(5), pcfg, T.make_optimizer(), device="cpu")
    holder = P.StateDict(dst)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    restored = dict(holder)
    want = _leaves(jstate, jax_flatten)
    got = _leaves(restored, port_flatten)
    assert got.keys() == want.keys() and len(got) == 26
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path
    assert int(restored["step"]) == 2 and int(restored["opt_state"][0].count) == 2
    # Built from the destination's classes, not optax's.
    assert type(restored["opt_state"][0]) is T.ScaleByAdamState
    assert type(restored["opt_state"][1]) is T.EmptyState
    # Restored in place: the destination's own tensors hold the values.
    assert restored["params"]["embed"] is dst["params"]["embed"]


def test_port_written_train_state_restores_bit_exact_into_jax(tmp_path) -> None:
    train_step, state = _port_train(0)
    _, batch = _batch(3)
    for _ in range(2):
        train_step(state, batch)
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state)})
    jcfg, _ = _configs()
    jdst = JT.init_state(jax.random.PRNGKey(1), jcfg, JT.make_optimizer())
    holder = J.StateDict(**jdst)
    J.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want = _leaves(state, port_flatten)
    got = _leaves(dict(holder), jax_flatten)
    assert got.keys() == want.keys() and len(got) == 26
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


def test_port_resumes_bit_identically_on_cpu(tmp_path) -> None:
    train_step, state = _port_train(0)
    _, batch = _batch(4)
    losses = [train_step(state, batch)[1] for _ in range(2)]
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state), "rng": P.RNGState()})
    saved = {p: t.clone() for p, t in port_flatten(state)[1].items()}
    _, loss3 = train_step(state, batch)
    after3 = {p: t.clone() for p, t in port_flatten(state)[1].items()}

    _, fresh = _port_train(1)
    holder = P.StateDict(fresh)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder, "rng": P.RNGState()})
    restored = dict(holder)
    for path, t in port_flatten(restored)[1].items():
        assert torch.equal(t, saved[path]), path
    _, loss3_again = train_step(restored, batch)
    assert torch.equal(loss3_again, loss3)
    for path, t in port_flatten(restored)[1].items():
        assert torch.equal(t, after3[path]), path
    assert loss3.item() < losses[0].item()


def test_train_entry_steps_in_place() -> None:
    """At the entry config, on a slice of its batch to keep the CPU step short."""
    train_step, (state, batch) = train_entry(device="cpu", seed=0)
    assert batch["tokens"].shape == batch["targets"].shape == (4, 256)
    assert state["params"]["embed"].shape == (8192, 512)
    embed = state["params"]["embed"]
    before = embed.clone()
    out, loss = train_step(state, {k: v[:1, :32] for k, v in batch.items()})
    assert out is state and out["params"]["embed"] is embed
    assert not torch.equal(embed, before) and torch.isfinite(loss)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1


def test_make_train_step_refuses_a_mesh() -> None:
    _, pcfg = _configs()
    with pytest.raises(NotImplementedError, match="mesh"):
        T.make_train_step(pcfg, T.make_optimizer(), mesh=object())
