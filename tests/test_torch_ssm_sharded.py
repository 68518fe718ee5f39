"""The sequence-parallel SSM and the SSM LM's mesh path: the port against
the JAX package.

One spawned gloo world of 4 processes (on the CPU) runs every case on the
same inputs (made from a seed with numpy): ``ssm_mix_sharded`` on rings
of 4 (``{seq 4}``) and 2 (``{data 2, seq 2}``), with and without an
incoming state, forward and the gradients of ``sum(y * w) + sum(h * v)``;
a bf16 input, whose carried state stays f32; and the SSM LM's mesh
forward and train step on ``{data 1, seq 2, model 2}`` and ``{data 2, seq
2, model 1}``. In this process the JAX package runs the same ops on
meshes of the same shapes over its virtual CPU devices. Bars: the mix
1e-5 absolute plus 1e-5 relative (f32, forward and gradients: the
gradients of ``w_bc`` reach 30, where f32 sums in another order differ
by 1e-5); the LM's logits 2e-4 against JAX's mesh
forward and against one process (JAX's bar, ``tests/test_ssm.py:230``),
its loss 1e-5 relative and its gradients (Adam's first moment after one
step, ``mu = (1 - b1) * g``) 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]

B, S, D, N = 2, 16, 8, 4
MIX_CASES = {
    "ring4": {"seq": 4},
    "ring4_h0": {"seq": 4},
    "ring2_data2": {"data": 2, "seq": 2},
    "ring2_data2_h0": {"data": 2, "seq": 2},
}
LM = dict(vocab_size=64, d_model=16, d_state=4, n_layers=2, d_ff=32)
LM_TOKENS = (4, 16)
LM_CASES = {
    "dp1_sp2_tp2": {"data": 1, "seq": 2, "model": 2},
    "dp2_sp2_tp1": {"data": 2, "seq": 2, "model": 1},
}


def _mix_inputs(name: str) -> dict:
    rng = np.random.default_rng(sorted(MIX_CASES).index(name))
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    params = {"log_a": np.log(np.linspace(1.0, N, N, dtype=np.float32)),
              "w_bc": f(D, 2 * N, s=D**-0.5), "w_dt": f(D, 1, s=D**-0.5),
              "dt_bias": f(1, s=0.1), "d_skip": f(D)}
    return {"params": params, "x": f(B, S, D), "h0": f(B, D, N), "w": f(B, S, D),
            "v": f(B, D, N)}


def _lm_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    L, Dm, Fd, V, Ns = LM["n_layers"], LM["d_model"], LM["d_ff"], LM["vocab_size"], LM["d_state"]
    norm = lambda shape, fan: (rng.standard_normal(shape) * fan**-0.5).astype(np.float32)  # noqa
    ssm = {"log_a": np.tile(np.log(np.linspace(1.0, Ns, Ns, dtype=np.float32)), (L, 1)),
           "w_bc": norm((L, Dm, 2 * Ns), Dm), "w_dt": norm((L, Dm, 1), Dm),
           "dt_bias": np.zeros((L, 1), np.float32), "d_skip": np.ones((L, Dm), np.float32)}
    return {"embed": norm((V, Dm), Dm),
            "layers": {"ssm": ssm, "ln1_scale": np.ones((L, Dm), np.float32),
                       "ln2_scale": np.ones((L, Dm), np.float32), "ff_in": norm((L, Dm, Fd), Dm),
                       "ff_out": norm((L, Fd, Dm), Fd)},
            "ln_f_scale": np.ones((Dm,), np.float32)}


def _lm_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, LM["vocab_size"], LM_TOKENS).astype(np.int32)
            for k in ("tokens", "targets")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _mix_case(name: str) -> dict:
    import torch

    from torchsnapshot_tpu_torch.ops import ssm as PS
    from torchsnapshot_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MIX_CASES[name], device="cpu")
    inp = _mix_inputs(name)
    params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inp["params"].items()}
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    h0 = torch.from_numpy(inp["h0"]).requires_grad_(True) if name.endswith("h0") else None
    y, h = PS.ssm_mix_sharded(params, x, mesh, h0=h0)
    ((y * torch.from_numpy(inp["w"])).sum() + (h * torch.from_numpy(inp["v"])).sum()).backward()
    out = {"y": y.detach().numpy(), "h": h.detach().numpy(), "gx": x.grad.numpy(),
           **{f"g_{k}": p.grad.numpy() for k, p in params.items()}}
    if h0 is not None:
        out["gh0"] = h0.grad.numpy()
    return out


def _bf16_case() -> dict:
    import torch

    from torchsnapshot_tpu_torch.ops import ssm as PS
    from torchsnapshot_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"seq": 4}, device="cpu")
    inp = _mix_inputs("ring4")
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    y, h = PS.ssm_mix_sharded(params, torch.from_numpy(inp["x"]).bfloat16(), mesh)
    return {"y_dtype": str(y.dtype), "h_dtype": str(h.dtype), "h": h.numpy()}


def _lm_case(name: str, seed: int) -> dict:
    import torch

    from torchsnapshot_tpu_torch.models import ssm_lm as PL
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import gather_tree

    mesh = make_mesh(LM_CASES[name], device="cpu")
    cfg = PL.SSMConfig(**LM)
    opt = T.make_optimizer()
    params = T.params_from_numpy(_lm_params(seed), device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _lm_batch(seed).items()}
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    dstate = shard_pytree(state, PL.state_specs(cfg, state), mesh)
    logits = PL.forward(dstate["params"], batch["tokens"], cfg, mesh=mesh)
    dstate, loss = PL.make_train_step(cfg, opt, mesh=mesh)(dstate, batch)
    single_logits = PL.forward(state["params"], batch["tokens"], cfg)
    state, single_loss = PL.make_train_step(cfg, opt)(state, batch)
    full = gather_tree(dstate, PL.state_specs(cfg, dstate), mesh)
    return {
        "loss": float(loss), "logits": logits.numpy(), "step": int(full["step"]),
        "mu": {k: v.numpy() for k, v in _flat(full["opt"][0].mu).items()},
        "single_loss": float(single_loss), "single_logits": single_logits.numpy(),
        "single_mu": {k: v.numpy() for k, v in _flat(state["opt"][0].mu).items()},
    }


def _worker(rank: int, world: int) -> dict:
    import torch

    # One thread a rank: the ranks share the test host with other test
    # processes, and their tensors are tiny.
    torch.set_num_threads(1)
    out = {name: _mix_case(name) for name in MIX_CASES}
    out["bf16"] = _bf16_case()
    out.update({name: _lm_case(name, seed) for seed, name in enumerate(sorted(LM_CASES))})
    return out


@pytest.fixture(scope="module")
def world() -> dict:
    return run_with_subprocesses(_worker, 4, backend="gloo", timeout=300)


def _jax_mesh(shape: dict):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[: int(np.prod(list(shape.values())))]).reshape(
        tuple(shape.values())), tuple(shape))


@pytest.mark.parametrize("name", sorted(MIX_CASES))
def test_ssm_mix_sharded_matches_jax(world, name) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import ssm as JS

    inp = _mix_inputs(name)
    mesh = _jax_mesh(MIX_CASES[name])
    with_h0 = name.endswith("h0")

    def run(params, x, h0):
        return JS.ssm_mix_sharded(params, x, mesh, h0=h0 if with_h0 else None)

    def loss(params, x, h0):
        y, h = run(params, x, h0)
        return jnp.sum(y * inp["w"]) + jnp.sum(h * inp["v"])

    y, h = jax.jit(run)(inp["params"], inp["x"], inp["h0"])
    gp, gx, gh0 = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(inp["params"], inp["x"], inp["h0"])
    want = {"y": y, "h": h, "gx": gx, **{f"g_{k}": v for k, v in gp.items()}}
    if with_h0:
        want["gh0"] = gh0
    for rank, res in world.items():
        assert set(res[name]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(res[name][k], np.asarray(v), atol=1e-5, rtol=1e-5,
                                       err_msg=f"rank {rank} {k}")


def test_ssm_mix_sharded_resumes_from_h0_as_one_sequence(world) -> None:
    """The second half of the sequence from the first half's final state
    is the whole sequence's second half (one process's ``ssm_mix``)."""
    import torch

    from torchsnapshot_tpu_torch.ops import ssm as PS

    inp = _mix_inputs("ring4")
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    x = torch.from_numpy(inp["x"])
    y_full, h_full = PS.ssm_mix(params, torch.cat([x, x], dim=1))
    _, h_mid = PS.ssm_mix(params, x)
    # The world's ring4_h0 case ran from h0 = inputs' h0; here a second
    # check from one process's h_mid through a group of one.
    y2, h2 = PS.ssm_mix_local(params, x, h_mid, None)
    np.testing.assert_allclose(y2.numpy(), y_full[:, S:].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5, rtol=0)
    res = world[0]["ring4"]
    y1, h1 = PS.ssm_mix(params, x)
    np.testing.assert_allclose(res["y"], y1.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(res["h"], h1.numpy(), atol=1e-5, rtol=0)


def test_the_carried_state_stays_f32(world) -> None:
    for res in world.values():
        assert res["bf16"]["y_dtype"] == "torch.bfloat16"
        assert res["bf16"]["h_dtype"] == "torch.float32"
        assert np.isfinite(res["bf16"]["h"]).all()


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_ssm_lm_mesh_forward_and_step_match_jax_and_one_process(world, name) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from torchsnapshot_tpu.models import ssm_lm as JL

    seed = sorted(LM_CASES).index(name)
    cfg = JL.SSMConfig(**LM)
    params = jax.tree_util.tree_map(jnp.asarray, _lm_params(seed))
    batch = _lm_batch(seed)
    mesh = _jax_mesh(LM_CASES[name])
    tokens = jax.device_put(jnp.asarray(batch["tokens"]), NamedSharding(mesh, JP("data", "seq")))
    logits = jax.jit(lambda p, t: JL.forward(p, t, cfg, mesh=mesh))(params, tokens)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: JL.loss_fn(p, jbatch, cfg, mesh=mesh)))(params)
    grads = _flat(jax.tree_util.tree_map(np.asarray, grads))
    for rank, res in world.items():
        r = res[name]
        assert r["step"] == 1
        np.testing.assert_allclose(r["logits"], np.asarray(logits), atol=2e-4, rtol=0)
        np.testing.assert_allclose(r["logits"], r["single_logits"], atol=2e-4, rtol=0)
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        assert abs(r["loss"] - r["single_loss"]) <= 1e-5 * abs(r["single_loss"])
        for k, g in grads.items():
            np.testing.assert_allclose(r["mu"][k] / 0.1, g, atol=1e-4, rtol=0, err_msg=k)
            np.testing.assert_allclose(r["mu"][k], r["single_mu"][k], atol=1e-5, rtol=0,
                                       err_msg=k)
