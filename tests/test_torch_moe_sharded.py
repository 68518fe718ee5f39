"""The port's expert-parallel MoE FFN against the JAX package.

Two spawned gloo worlds (2 and 4 processes, on the CPU) share this module:
each rank runs ``moe_ffn_sharded`` on the same global tokens and params
(made from a seed with numpy), forward and backward of ``sum(y * w) +
0.01 * aux``, and returns ``y``, ``aux`` and the gradients. In this
process the JAX package runs its ``moe_ffn_sharded`` on a mesh of the same
shape. Bars, f32: forward 1e-5, gradients 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]

# name: (world, mesh shape, T, D, F, E, capacity factor)
CASES = {
    "model2_ample": (2, {"model": 2}, 32, 8, 16, 4, 8.0),
    "model2_drops": (2, {"model": 2}, 32, 8, 16, 4, 1.0),
    "model4_ample": (4, {"model": 4}, 64, 16, 32, 8, 8.0),
    "data2_model2_drops": (4, {"data": 2, "model": 2}, 32, 8, 16, 4, 1.25),
}


def _inputs(name: str):
    _, _, T, Dm, Fd, E, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 40)
    params = {
        "router": rng.standard_normal((Dm, E)).astype(np.float32) * Dm**-0.5,
        "w_in": rng.standard_normal((E, Dm, Fd)).astype(np.float32) * Dm**-0.5,
        "w_out": rng.standard_normal((E, Fd, Dm)).astype(np.float32) * Fd**-0.5,
    }
    x = rng.standard_normal((T, Dm)).astype(np.float32)
    w = rng.standard_normal((T, Dm)).astype(np.float32)
    return params, x, w


def _worker(rank: int, world: int) -> dict:
    import torch

    # One thread a rank: the ranks share the test host with other test
    # processes, and their tensors are tiny.
    torch.set_num_threads(1)

    from torchsnapshot_tpu_torch.ops import moe
    from torchsnapshot_tpu_torch.parallel import make_mesh

    out = {}
    for name, (n, shape, *_, cf) in CASES.items():
        if n != world:
            continue
        mesh = make_mesh(shape, device="cpu")
        params, x, w = _inputs(name)
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
        x = torch.from_numpy(x).requires_grad_(True)
        y, aux = moe.moe_ffn_sharded(params, x, mesh, capacity_factor=cf)
        ((y * torch.from_numpy(w)).sum() + 0.01 * aux).backward()
        out[name] = {
            "y": y.detach().numpy(), "aux": float(aux), "dx": x.grad.numpy(),
            **{f"d{k}": p.grad.numpy() for k, p in params.items()},
        }
    if world == 2:
        mesh = make_mesh({"model": 2}, device="cpu")
        params, x, _ = _inputs("model2_ample")
        params = {k: torch.from_numpy(v) for k, v in params.items()}
        errors = {}
        for what, args in (
            ("tokens", (params, torch.zeros(31, 8), mesh)),
            ("experts", ({**params, "router": torch.zeros(8, 3)}, torch.zeros(32, 8), mesh)),
            ("axis", (params, torch.zeros(32, 8), mesh)),
        ):
            try:
                moe.moe_ffn_sharded(*args, expert_axis="experts" if what == "axis" else "model")
                errors[what] = "no error"
            except ValueError as exc:
                errors[what] = str(exc)
        out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def worlds():
    return {n: run_with_subprocesses(_worker, n, backend="gloo", timeout=300) for n in (2, 4)}


def _jax_case(name: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from torchsnapshot_tpu.ops import moe_ffn_sharded

    world, shape, *_, cf = CASES[name]
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(tuple(shape.values())), tuple(shape))
    params, x, w = _inputs(name)

    @jax.jit
    def run(params, x):
        def loss(params, x):
            y, aux = moe_ffn_sharded(params, x, mesh, capacity_factor=cf)
            return jnp.sum(y * w) + 0.01 * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, aux, gp, gx

    y, aux, gp, gx = run(params, x)
    return {"y": np.asarray(y), "aux": float(aux), "dx": np.asarray(gx),
            **{f"d{k}": np.asarray(v) for k, v in gp.items()}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_sharded_matches_the_jax_package(worlds, name: str) -> None:
    want = _jax_case(name)
    for rank, res in worlds[CASES[name][0]].items():
        got = res[name]
        np.testing.assert_allclose(got["y"], want["y"], atol=1e-5, rtol=0, err_msg=f"rank {rank}")
        assert abs(got["aux"] - want["aux"]) <= 1e-5, (rank, got["aux"], want["aux"])
        for key in ("dx", "drouter", "dw_in", "dw_out"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0,
                                       err_msg=f"rank {rank} {key}")


def test_moe_ffn_sharded_with_ample_capacity_is_moe_ffn(worlds) -> None:
    """Per-rank capacity differs from the global capacity only when tokens
    drop: with ample capacity the sharded result is ``moe_ffn``'s."""
    import torch

    from torchsnapshot_tpu_torch.ops import moe

    for name in ("model2_ample", "model4_ample"):
        params, x, _ = _inputs(name)
        y, aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(x), capacity_factor=CASES[name][-1])
        for res in worlds[CASES[name][0]].values():
            np.testing.assert_allclose(res[name]["y"], y.numpy(), atol=1e-5, rtol=0)
            assert abs(res[name]["aux"] - float(aux)) <= 1e-6


@pytest.mark.parametrize(
    "what, pattern",
    [
        ("tokens", "token count 31 not divisible by mesh axis 2"),
        ("experts", "n_experts 3 not divisible by mesh axis 2"),
        ("axis", "lacks expert axis 'experts'"),
    ],
)
def test_moe_ffn_sharded_raises_by_name(worlds, what: str, pattern: str) -> None:
    for res in worlds[2].values():
        assert pattern in res["errors"][what], res["errors"][what]
