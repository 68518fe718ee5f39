"""The port's MoE FFN and MoE transformer against the JAX package's.

The single-device cases of ``tests/test_moe.py`` at its sizes. The JAX
package initializes the parameters and the inputs are drawn with numpy
from a seed; ``params_from_numpy`` carries them into the port.
from torch_test_env import autotune_never  # noqa: F401 - autouse

Bars (``tests/test_moe.py``'s): in f32 the routing (e1, e2) is identical
and outputs agree within 1e-5, aux losses within 1e-6, gradients within
1e-5; sort equals einsum within 1e-5. In bf16 a near-tie between two
experts can route a token differently in each framework; only tokens whose
routing agrees are compared (within 2e-2, a few bf16 ulps of outputs of
order 1), and the flips are counted and printed. Train states cross
between the packages bit-exact, and a step after a restore is
bit-identical to one without it.
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
from torchsnapshot_tpu.ops import moe as JM
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import moe as PM


def _to_port(tree):
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _moe(seed: int, d_model: int, d_ff: int, n_experts: int, tokens: int):
    params = JM.init_moe_params(jax.random.PRNGKey(seed), d_model, d_ff, n_experts)
    x = np.random.default_rng(seed).standard_normal((tokens, d_model)).astype(np.float32)
    return params, _to_port(params), x


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_ffn_matches_jax(dispatch: str, capacity_factor: float) -> None:
    jp, pp, x = _moe(8, 16, 32, 4, 96)
    yj, auxj = JM.moe_ffn(jp, jnp.asarray(x), capacity_factor=capacity_factor, dispatch=dispatch)
    yp, auxp = PM.moe_ffn(pp, torch.from_numpy(x), capacity_factor=capacity_factor, dispatch=dispatch)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    assert abs(auxp.item() - float(auxj)) <= 1e-6 and auxp.dtype == torch.float32
    ej = JM._top2_route(jnp.asarray(x), jp["router"])
    ep = PM._top2_route(torch.from_numpy(x), pp["router"])
    for a, b in zip(ej[:2], ep[:2]):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(ej[2:], ep[2:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_sort_dispatch_matches_einsum(capacity_factor: float) -> None:
    _, pp, x = _moe(8, 16, 32, 4, 96)
    xt = torch.from_numpy(x)
    y_e, aux_e = PM.moe_ffn(pp, xt, capacity_factor=capacity_factor, dispatch="einsum")
    y_s, aux_s = PM.moe_ffn(pp, xt, capacity_factor=capacity_factor, dispatch="sort")
    np.testing.assert_allclose(y_s.numpy(), y_e.numpy(), atol=1e-5, rtol=0)
    assert abs(aux_s.item() - aux_e.item()) <= 1e-6


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_gradients_match_jax(dispatch: str) -> None:
    jp, pp, x = _moe(10, 8, 16, 4, 32)

    def jloss(params):
        y, aux = JM.moe_ffn(params, jnp.asarray(x), dispatch=dispatch)
        return jnp.sum(y**2) + 0.01 * aux

    def ploss(params):
        y, aux = PM.moe_ffn(params, torch.from_numpy(x), dispatch=dispatch)
        return (y**2).sum() + 0.01 * aux

    gj = jax.jit(jax.grad(jloss))(jp)
    _, gp = T.value_and_grad(ploss, pp)
    for k in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(gj[k]), atol=1e-5, rtol=0, err_msg=k)
        assert np.abs(gp[k].numpy()).sum() > 0


def test_moe_capacity_drops_bounded() -> None:
    jp, pp, x = _moe(4, 8, 16, 2, 64)
    for dispatch in ("einsum", "sort"):
        y, _ = PM.moe_ffn(pp, torch.from_numpy(x), capacity_factor=0.05, dispatch=dispatch)
        assert torch.isfinite(y).all() and int((y.abs().sum(-1) == 0).sum()) > 0


def test_moe_bf16_agrees_with_jax_on_tokens_routed_alike() -> None:
    jp, pp, x = _moe(8, 16, 32, 4, 96)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ej1, ej2 = (np.asarray(e) for e in JM._top2_route(xb, jp["router"])[:2])
    ep1, ep2 = (e.numpy() for e in PM._top2_route(xt, pp["router"])[:2])
    agree = (ej1 == ep1) & (ej2 == ep2)
    print(f"bf16 routing flips: {int((~agree).sum())} of {len(agree)} tokens")
    # Ample capacity: a flipped token cannot displace an agreeing one.
    yj, _ = JM.moe_ffn(jp, xb, capacity_factor=8.0)
    yp, _ = PM.moe_ffn(pp, xt, capacity_factor=8.0)
    assert yp.dtype == torch.bfloat16 and agree.sum() >= 0.9 * len(agree)
    np.testing.assert_allclose(
        yp.float().numpy()[agree], np.asarray(yj, np.float32)[agree], atol=2e-2, rtol=0
    )


def test_auto_dispatch_switches_at_the_element_limit(monkeypatch) -> None:
    _, pp, x = _moe(8, 16, 32, 4, 96)  # T*E*cap = 96*4*60 = 23,040
    used = []
    for name in ("_einsum_dispatch", "_sort_dispatch"):
        real = getattr(PM, name)
        monkeypatch.setattr(PM, name, lambda *a, _r=real, _n=name: used.append(_n) or _r(*a))
    PM.moe_ffn(pp, torch.from_numpy(x))
    monkeypatch.setattr(PM, "_EINSUM_DISPATCH_MAX_ELEMENTS", 96 * 4 * 60 - 1)
    PM.moe_ffn(pp, torch.from_numpy(x))
    assert used == ["_einsum_dispatch", "_sort_dispatch"]
    assert JM._EINSUM_DISPATCH_MAX_ELEMENTS == (1 << 22)
    with pytest.raises(ValueError, match="unknown dispatch"):
        PM.moe_ffn(pp, torch.from_numpy(x), dispatch="scatter")
    with pytest.raises(TypeError, match="moe_ffn_sharded.*DeviceMesh"):
        PM.moe_ffn_sharded(pp, torch.from_numpy(x), mesh=object())


SMALL = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=16)


def _configs(n_experts: int = 4):
    jcfg = JT.TransformerConfig(**SMALL, dtype=jnp.float32, attn_impl="dense", n_experts=n_experts)
    pcfg = T.TransformerConfig(**SMALL, dtype=torch.float32, attn_impl="dense", n_experts=n_experts)
    return jcfg, pcfg


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    tokens, targets = (rng.integers(0, 64, (4, 16), dtype=np.int32) for _ in range(2))
    return ({"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)})


def _leaves(tree, flatten) -> dict:
    return {
        p: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
        for p, x in flatten(tree)[1].items()
    }


def test_moe_transformer_loss_and_gradients_match_jax() -> None:
    jcfg, pcfg = _configs()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    assert sorted(params["layers"]) == sorted(jparams["layers"])
    assert "ff_in" not in params["layers"] and params["layers"]["moe_w_in"].shape == (2, 4, 16, 32)
    jbatch, pbatch = _batch(1)
    jloss, jgrads = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=2)(jparams, jbatch, jcfg)
    loss, grads = T.loss_and_grads(params, pbatch, pcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want, got = _leaves(jgrads, jax_flatten), _leaves(grads, port_flatten)
    assert got.keys() == want.keys() and len(got) == 9
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5, rtol=0, err_msg=path)
    _, aux = T.forward(params, pbatch["tokens"], pcfg, with_aux=True)
    _, jaux = JT.forward(jparams, jbatch["tokens"], jcfg, with_aux=True)
    assert abs(aux.item() - float(jaux)) <= 1e-6 and aux.item() > 0


def test_dense_transformer_unchanged() -> None:
    """n_experts=0 keeps the dense-FFN param tree and every result."""
    _, pcfg = _configs(0)
    params = T.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert "ff_in" in params["layers"] and "moe_router" not in params["layers"]
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    logits, aux = T.forward(params, tokens, pcfg, with_aux=True)
    assert logits.shape == (2, 16, 64) and aux.item() == 0.0
    assert torch.equal(logits, T.forward(params, tokens, pcfg))
    batch = {"tokens": tokens, "targets": tokens}
    assert torch.equal(T.loss_fn(params, batch, pcfg), T._token_nll(logits, tokens))


def _port_state(seed: int):
    _, pcfg = _configs()
    opt = T.make_optimizer()
    return T.make_train_step(pcfg, opt), T.init_state(
        torch.Generator().manual_seed(seed), pcfg, opt, device="cpu")


def test_jax_written_moe_train_state_restores_bit_exact_into_the_port(tmp_path) -> None:
    jcfg, _ = _configs()
    tx = JT.make_optimizer()
    jstate = JT.init_state(jax.random.PRNGKey(0), jcfg, tx)
    jstate, _ = jax.jit(JT.make_train_step(jcfg, tx))(jstate, _batch(3)[0])
    J.Snapshot.take(str(tmp_path / "s"), {"train": J.StateDict(**jstate)})
    _, dst = _port_state(5)
    holder = P.StateDict(dst)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want, got = _leaves(jstate, jax_flatten), _leaves(dict(holder), port_flatten)
    assert got.keys() == want.keys() and len(got) == 29
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


def test_port_written_moe_train_state_restores_bit_exact_into_jax(tmp_path) -> None:
    step, state = _port_state(0)
    step(state, _batch(3)[1])
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state)})
    jcfg, _ = _configs()
    holder = J.StateDict(**JT.init_state(jax.random.PRNGKey(1), jcfg, JT.make_optimizer()))
    J.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want, got = _leaves(state, port_flatten), _leaves(dict(holder), jax_flatten)
    assert got.keys() == want.keys() and len(got) == 29
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_a_step_after_restore_is_bit_identical(tmp_path, monkeypatch, dispatch) -> None:
    if dispatch == "sort":
        monkeypatch.setattr(PM, "_EINSUM_DISPATCH_MAX_ELEMENTS", 0)
    step, state = _port_state(0)
    _, batch = _batch(4)
    step(state, batch)
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state)})
    _, loss2 = step(state, batch)
    after = {p: t.clone() for p, t in port_flatten(state)[1].items()}
    _, fresh = _port_state(1)
    holder = P.StateDict(fresh)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    _, loss2_again = step(dict(holder), batch)
    assert torch.equal(loss2_again, loss2)
    for path, t in port_flatten(dict(holder))[1].items():
        assert torch.equal(t, after[path]), path
