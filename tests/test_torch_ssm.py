"""The port's SSM scan, SSM mix and SSM LM against the JAX package's.

The single-device cases of ``tests/test_ssm.py`` at its sizes (B=2, S=16,
D=8, N=4; the LM at vocab 64, d_model 16, d_state 4, 2 layers, d_ff 32).
Inputs are drawn with numpy from a seed; the JAX package initializes the
parameters and ``params_from_numpy`` carries them into the port.

Bars (``tests/test_ssm.py``'s): the scan against the naive float64
recurrence within 1e-4; the port against the JAX package's
``associative_scan`` and a chunked scan carried through ``h0`` against the
whole within 1e-5 (the doubling scan orders its operations otherwise, so
results agree within rounding, not bit for bit); gradients within rtol
1e-5 plus atol 1e-4 (the file's bar for gradients across scan orders); LM
logits and loss within 1e-5. Train states cross between the packages
bit-exact, and a step after a restore is bit-identical to one without it.
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
from torchsnapshot_tpu.models import ssm_lm as JL
from torchsnapshot_tpu.models.transformer import make_optimizer as jax_make_optimizer
from torchsnapshot_tpu.ops import ssm as JS
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import ssm_lm as PL
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import ssm as PS
from torch_test_env import autotune_never  # noqa: F401 - autouse

B, S, D, N = 2, 16, 8, 4


def naive_scan(a, b, h0=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    h = np.zeros(np.broadcast_shapes(a.shape, b.shape))
    prev = np.zeros(h[:, 0].shape) if h0 is None else np.asarray(h0, np.float64)
    for t in range(h.shape[1]):
        prev = a[:, t] * prev + b[:, t]
        h[:, t] = prev
    return h


def _ab(seed: int, a_shape=(B, S, D, N)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.99, a_shape).astype(np.float32)
    b = rng.standard_normal((B, S, D, N)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    return a, b, h0


def _to_port(tree):
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("a_shape", [(B, S, D, N), (B, S, 1, N)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_naive_recurrence_and_jax(a_shape, with_h0) -> None:
    a, b, h0 = _ab(0, a_shape)
    h0 = h0 if with_h0 else None
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    h = PS.ssm_scan(t(a), t(b), t(h0)).numpy()
    np.testing.assert_allclose(h, naive_scan(a, b, h0), atol=1e-4, rtol=0)
    hj = JS.ssm_scan(jnp.asarray(a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(h, np.asarray(hj), atol=1e-5, rtol=0)


def test_scan_is_log_depth_and_keeps_the_decay_narrow(monkeypatch) -> None:
    """ceil(log2 S) doubling rounds, two concatenations each, and the
    cumulative decay stays (B, S, 1, N)."""
    a, b, _ = _ab(1, (B, S, 1, N))
    calls = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda ts, dim=0: calls.append(dim) or real_cat(ts, dim=dim))
    a_cum, h = PS._scan(torch.from_numpy(a), torch.from_numpy(b))
    assert len(calls) == 2 * 4  # S = 16
    assert a_cum.shape == (B, S, 1, N) and h.shape == (B, S, D, N)
    np.testing.assert_allclose(a_cum.numpy(), np.cumprod(a.astype(np.float64), axis=1), rtol=1e-5)


def test_chunked_scan_resumes_exactly() -> None:
    """Two halves with the carried state equal the whole: the final state
    is a checkpointable cursor."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    params = _to_port(JS.init_ssm_params(jax.random.PRNGKey(0), D, N))
    y_full, h_full = PS.ssm_mix(params, x)
    y1, h1 = PS.ssm_mix(params, x[:, : S // 2])
    y2, h2 = PS.ssm_mix(params, x[:, S // 2 :], h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5, rtol=0)


def test_ssm_mix_and_gradients_match_jax() -> None:
    jp = JS.init_ssm_params(jax.random.PRNGKey(2), D, N)
    pp = _to_port(jp)
    x = np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32)
    yj, hj = JS.ssm_mix(jp, jnp.asarray(x))
    yp, hp = PS.ssm_mix(pp, torch.from_numpy(x))
    assert hp.shape == (B, D, N) and hp.dtype == torch.float32
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=1e-5, rtol=0)
    gj = jax.jit(jax.grad(lambda p: jnp.sum(JS.ssm_mix(p, jnp.asarray(x))[0] ** 2)))(jp)
    _, gp = T.value_and_grad(lambda p: (PS.ssm_mix(p, torch.from_numpy(x))[0] ** 2).sum(), pp)
    for k in jp:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(gj[k]), rtol=1e-5, atol=1e-4, err_msg=k)
        assert np.isfinite(gp[k].numpy()).all() and np.abs(gp[k].numpy()).sum() > 0


def test_init_ssm_params_layout_matches_jax() -> None:
    jp = JS.init_ssm_params(jax.random.PRNGKey(0), D, N)
    pp = PS.init_ssm_params(torch.Generator().manual_seed(0), D, N)
    assert {k: tuple(v.shape) for k, v in pp.items()} == {k: v.shape for k, v in jp.items()}
    np.testing.assert_allclose(pp["log_a"].numpy(), np.asarray(jp["log_a"]), rtol=1e-6)
    # The sequence-parallel paths exist (tests/test_torch_ssm_sharded.py):
    # on a group of one the sharded scan is the scan, and the mix takes
    # only a DeviceMesh.
    a, b = (torch.from_numpy(t) for t in _ab(3)[:2])
    h, h_final = PS.ssm_scan_sharded(a, b, group=None)
    torch.testing.assert_close(h, PS.ssm_scan(a, b), rtol=0, atol=0)
    torch.testing.assert_close(h_final, h[:, -1], rtol=0, atol=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        PS.ssm_mix_sharded(pp, torch.zeros(B, S, D), object())


def test_ssm_state_snapshot_roundtrip(tmp_path) -> None:
    """Snapshot the recurrent state mid-sequence, restore, resume: equal
    to the uninterrupted run."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    params = _to_port(JS.init_ssm_params(jax.random.PRNGKey(4), D, N))
    y_full, _ = PS.ssm_mix(params, x)
    _, h_mid = PS.ssm_mix(params, x[:, : S // 2])
    P.Snapshot.take(str(tmp_path / "s"), {"cursor": P.StateDict(h=h_mid, params=params)})
    dst = P.StateDict(h=torch.zeros_like(h_mid),
                      params={k: torch.zeros_like(v) for k, v in params.items()})
    P.Snapshot(str(tmp_path / "s")).restore({"cursor": dst})
    y2, _ = PS.ssm_mix(dst["params"], x[:, S // 2 :], h0=dst["h"])
    np.testing.assert_allclose(y2.numpy(), y_full[:, S // 2 :].numpy(), atol=1e-5, rtol=0)


CFG = dict(vocab_size=64, d_model=16, d_state=4, n_layers=2, d_ff=32)


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


def test_ssm_lm_forward_loss_and_gradients_match_jax() -> None:
    jcfg, pcfg = JL.SSMConfig(**CFG), PL.SSMConfig(**CFG)
    jparams = JL.init_params(jax.random.PRNGKey(0), jcfg)
    params = _to_port(jparams)
    jbatch, pbatch = _batch(1)
    logits = PL.forward(params, pbatch["tokens"], pcfg)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(JL.forward(jparams, jbatch["tokens"], jcfg)), atol=1e-5, rtol=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(JL.loss_fn), static_argnums=2)(jparams, jbatch, jcfg)
    loss, grads = T.value_and_grad(PL.loss_fn, params, pbatch, pcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want, got = _leaves(jgrads, jax_flatten), _leaves(grads, port_flatten)
    assert got.keys() == want.keys() and len(got) == 11
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5, atol=1e-4, err_msg=path)


def _port_state(seed: int):
    opt = T.make_optimizer()
    cfg = PL.SSMConfig(**CFG)
    return PL.make_train_step(cfg, opt), PL.init_state(
        torch.Generator().manual_seed(seed), cfg, opt, device="cpu")


def test_jax_written_ssm_train_state_restores_bit_exact_into_the_port(tmp_path) -> None:
    jcfg = JL.SSMConfig(**CFG)
    tx = jax_make_optimizer()
    jstate = JL.init_state(jax.random.PRNGKey(0), jcfg, tx)
    jstate, _ = jax.jit(JL.make_train_step(jcfg, tx))(jstate, _batch(3)[0])
    J.Snapshot.take(str(tmp_path / "s"), {"train": J.StateDict(**jstate)})
    _, dst = _port_state(5)
    holder = P.StateDict(dst)
    P.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want, got = _leaves(jstate, jax_flatten), _leaves(dict(holder), port_flatten)
    assert got.keys() == want.keys() and len(got) == 35
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path


def test_port_written_ssm_train_state_restores_bit_exact_into_jax(tmp_path) -> None:
    step, state = _port_state(0)
    step(state, _batch(3)[1])
    P.Snapshot.take(str(tmp_path / "s"), {"train": P.StateDict(state)})
    jcfg = JL.SSMConfig(**CFG)
    holder = J.StateDict(**JL.init_state(jax.random.PRNGKey(1), jcfg, jax_make_optimizer()))
    J.Snapshot(str(tmp_path / "s")).restore({"train": holder})
    want, got = _leaves(state, port_flatten), _leaves(dict(holder), jax_flatten)
    assert got.keys() == want.keys() and len(got) == 35
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
    # The mesh path exists (tests/test_torch_ssm_sharded.py); only a
    # DeviceMesh is a mesh.
    cfg = PL.SSMConfig(**CFG)
    with pytest.raises(TypeError, match="DeviceMesh"):
        PL.make_train_step(cfg, T.make_optimizer(), mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        PL.init_state(torch.Generator(), cfg, T.make_optimizer(), "cpu", mesh=object())
