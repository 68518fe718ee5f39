"""GPipe and 1F1B pipelines of the port against a sequential oracle and the
JAX package.

The eight tests of ``tests/test_pipeline.py`` at its sizes (8 layers of
16, batch 8, the tanh layer), in spawned gloo worlds of 2, 4 and 8
processes on the CPU (a mesh spans its whole world, so each stage count
runs in a world of its size): sequential equality, dp x pp, gradients,
the validation messages, the params snapshot round trip from 4 stages to
2, 1F1B against the dense oracle, 1F1B x dp, and 1F1B training on 4
stages resumed on 2 from a snapshot. Inputs are made from seeds with
numpy; the JAX package's ``pipelined_apply`` and
``pipelined_value_and_grad`` run on the same inputs over its virtual CPU
devices. Bars (f32): forward 1e-5, gradients 1e-4, losses 1e-5; the
training trajectory 1e-4 (JAX's bar).
"""

from __future__ import annotations

import numpy as np
import pytest

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]

L, B, D = 8, 8, 16
LR = 0.05
# name: (world, mesh shape, n_micro)
APPLY = {
    "stages2_micro4": (2, {"pipe": 2}, 4),
    "stages4_micro4": (4, {"pipe": 4}, 4),
    "stages4_micro8": (4, {"pipe": 4}, 8),
    "stages8_micro8": (8, {"pipe": 8}, 8),
    "data2_stages4": (8, {"data": 2, "pipe": 4}, 4),
}
ONE_F_ONE_B = {
    "stages2_micro4": (2, {"pipe": 2}, 4),
    "stages4_micro8": (4, {"pipe": 4}, 8),
    "stages8_micro8": (8, {"pipe": 8}, 8),
    "data2_stages4": (8, {"data": 2, "pipe": 4}, 4),
}


def _params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, D, D)) * D**-0.5).astype(np.float32),
            "b": (rng.standard_normal((L, D)) * 0.01).astype(np.float32)}


def _x(seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 1000).standard_normal((B, D)).astype(np.float32)


def layer_fn(layer, x):
    import torch

    return torch.tanh(x @ layer["w"] + layer["b"])


def mse(y, t):
    return ((y - t) ** 2).mean()


def _torch(tree):
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _apply_case(name: str) -> dict:
    import torch

    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import to_local
    from torchsnapshot_tpu_torch.parallel.pipeline import pipeline_param_sharding, pipelined_apply

    _, shape, n_micro = APPLY[name]
    seed = sorted(APPLY).index(name)
    mesh = make_mesh(shape, device="cpu")
    params = {k: v.requires_grad_(True) for k, v in _torch(_params(seed)).items()}
    x = torch.from_numpy(_x(seed)).requires_grad_(True)
    out = pipelined_apply(params, x, mesh, layer_fn=layer_fn, n_micro=n_micro)
    (out**2).sum().backward()
    res = {"out": out.detach().numpy(), "gx": x.grad.numpy(),
           **{f"g_{k}": p.grad.numpy() for k, p in params.items()}}
    # The same through DTensor params placed by pipeline_param_sharding.
    plain = _torch(_params(seed))
    dparams = shard_pytree(plain, pipeline_param_sharding(plain, mesh), mesh)
    for p in dparams.values():
        p.requires_grad_(True)
    out = pipelined_apply(dparams, torch.from_numpy(_x(seed)), mesh, layer_fn=layer_fn,
                          n_micro=n_micro)
    (out**2).sum().backward()
    res["dtensor_out"] = out.detach().numpy()
    res.update({f"dtensor_g_{k}": to_local(p.grad).numpy() for k, p in dparams.items()})
    return res


def _1f1b_case(name: str) -> dict:
    import torch

    from torchsnapshot_tpu_torch.parallel import make_mesh
    from torchsnapshot_tpu_torch.parallel.pipeline import pipelined_value_and_grad

    _, shape, n_micro = ONE_F_ONE_B[name]
    seed = sorted(ONE_F_ONE_B).index(name)
    mesh = make_mesh(shape, device="cpu")
    targets = torch.from_numpy(_x(seed + 50))
    loss, grads = pipelined_value_and_grad(_torch(_params(seed)), torch.from_numpy(_x(seed)),
                                           targets, mesh, layer_fn=layer_fn, loss_fn=mse,
                                           n_micro=n_micro)
    return {"loss": float(loss), **{f"g_{k}": g.numpy() for k, g in grads.items()}}


def _errors() -> dict:
    import torch

    from torchsnapshot_tpu_torch.parallel import make_mesh
    from torchsnapshot_tpu_torch.parallel.pipeline import pipelined_apply

    out = {}
    params, x = _torch(_params(0)), torch.zeros(B, D)
    three = {k: v[:6] for k, v in params.items()}  # 6 layers over 4 stages
    for what, mesh, p, n_micro in (
        ("micro", make_mesh({"pipe": 4}, device="cpu"), params, 3),
        ("layers", make_mesh({"pipe": 4}, device="cpu"), three, 4),
        ("no_pipe", make_mesh({"data": 4}, device="cpu"), params, 4),
        ("per_micro", make_mesh({"data": 4, "pipe": 1}, device="cpu"), params, 4),
    ):
        try:
            pipelined_apply(p, x, mesh, layer_fn=layer_fn, n_micro=n_micro)
            out[what] = "no error"
        except ValueError as exc:
            out[what] = str(exc)
    return out


def _take_stages(root: str, seed: int) -> None:
    """The 4-stage half of the snapshot tests: params placed on 4 stages
    taken; then 2 SGD steps of 1F1B on 4 stages, taken."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import to_local
    from torchsnapshot_tpu_torch.parallel.pipeline import (
        pipeline_param_sharding,
        pipelined_value_and_grad,
    )

    mesh = make_mesh({"pipe": 4}, device="cpu")
    plain = _torch(_params(seed))
    params = shard_pytree(plain, pipeline_param_sharding(plain, mesh), mesh)
    Snapshot.take(f"{root}/params", {"m": StateDict(params=params)})
    train = shard_pytree(_torch(_params(seed + 3)), pipeline_param_sharding(plain, mesh), mesh)
    losses = []
    for _ in range(2):
        loss, grads = pipelined_value_and_grad(
            train, torch.from_numpy(_x(seed)), torch.from_numpy(_x(seed + 50)), mesh,
            layer_fn=layer_fn, loss_fn=mse, n_micro=4)
        with torch.no_grad():
            for k in train:
                to_local(train[k]).sub_(LR * to_local(grads[k]))
        losses.append(float(loss))
    Snapshot.take(f"{root}/train", {"m": StateDict(params=train)})
    return losses


def _restore_stages(root: str, seed: int) -> dict:
    """The 2-stage half: both snapshots restored onto 2 stages; the
    params run the pipeline, the training goes on 2 more steps."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree
    from torchsnapshot_tpu_torch.parallel.mesh import gather, to_local
    from torchsnapshot_tpu_torch.parallel.pipeline import (
        pipeline_param_sharding,
        pipelined_apply,
        pipelined_value_and_grad,
    )

    mesh = make_mesh({"pipe": 2}, device="cpu")
    zeros = {k: torch.zeros_like(v) for k, v in _torch(_params(seed)).items()}
    specs = pipeline_param_sharding(zeros, mesh)
    dst = StateDict(params=shard_pytree(zeros, specs, mesh))
    Snapshot(f"{root}/params").restore({"m": dst})
    params = dst["params"]
    restored = {k: gather(to_local(v), mesh, specs[k]).numpy() for k, v in params.items()}
    out = pipelined_apply(params, torch.from_numpy(_x(seed + 7)), mesh, layer_fn=layer_fn,
                          n_micro=4)
    dst = StateDict(params=shard_pytree(zeros, specs, mesh))
    Snapshot(f"{root}/train").restore({"m": dst})
    train, losses = dst["params"], []
    for _ in range(2):
        loss, grads = pipelined_value_and_grad(
            train, torch.from_numpy(_x(seed)), torch.from_numpy(_x(seed + 50)), mesh,
            layer_fn=layer_fn, loss_fn=mse, n_micro=4)
        with torch.no_grad():
            for k in train:
                to_local(train[k]).sub_(LR * to_local(grads[k]))
        losses.append(float(loss))
    return {"restored": restored, "out": out.detach().numpy(), "losses": losses}


def _worker(rank: int, world: int, root: str) -> dict:
    import torch

    torch.set_num_threads(1)
    out = {"apply": {n: _apply_case(n) for n, c in APPLY.items() if c[0] == world},
           "1f1b": {n: _1f1b_case(n) for n, c in ONE_F_ONE_B.items() if c[0] == world}}
    if world == 4:
        out["errors"] = _errors()
        out["losses_4_stages"] = _take_stages(root, 6)
    if world == 8:
        from torchsnapshot_tpu_torch.parallel import make_mesh

        mesh = make_mesh({"data": 2, "pipe": 4}, device="cpu")
        out["mesh"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("pipeline"))
    out = {w: run_with_subprocesses(_worker, w, root, backend="gloo", timeout=300)
           for w in (4, 8)}
    out[2] = run_with_subprocesses(_worker2, 2, root, backend="gloo", timeout=300)
    return out


def _worker2(rank: int, world: int, root: str) -> dict:
    out = _worker(rank, world, root)
    out["restore"] = _restore_stages(root, 6)
    return out


# ------------------------------------------------------------ oracles


def _sequential(params: dict, x: np.ndarray) -> np.ndarray:
    import torch

    h = torch.from_numpy(x).double()
    for i in range(L):
        h = torch.tanh(h @ torch.from_numpy(params["w"][i]).double()
                       + torch.from_numpy(params["b"][i]).double())
    return h.numpy()


def _oracle_value_and_grad(params: dict, x: np.ndarray, t: np.ndarray, n_micro: int):
    """Mean over microbatches of each microbatch's MSE, and its gradients
    (torch autograd, f32, one process)."""
    import torch

    p = {k: v.requires_grad_(True) for k, v in _torch(params).items()}
    xs, ts = torch.from_numpy(x).reshape(n_micro, -1, D), torch.from_numpy(t).reshape(n_micro, -1, D)
    losses = []
    for i in range(n_micro):
        h = xs[i]
        for j in range(L):
            h = layer_fn({"w": p["w"][j], "b": p["b"][j]}, h)
        losses.append(mse(h, ts[i]))
    loss = torch.stack(losses).mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in p.items()}


def _jax_mesh(shape: dict):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _jax_layer(layer, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ layer["w"] + layer["b"])


def _results(worlds, kind: str, name: str, table: dict) -> list:
    return [r[kind][name] for r in worlds[table[name][0]].values()]


# ------------------------------------------------------------ tests


@pytest.mark.parametrize("name", [n for n in sorted(APPLY) if n.startswith("stages")])
def test_pipeline_matches_sequential_and_jax(worlds, name) -> None:
    import jax

    from torchsnapshot_tpu.parallel import pipelined_apply as jax_apply

    _, shape, n_micro = APPLY[name]
    seed = sorted(APPLY).index(name)
    params, x = _params(seed), _x(seed)
    ref = _sequential(params, x)
    jout = jax.jit(lambda p, x: jax_apply(p, x, _jax_mesh(shape), layer_fn=_jax_layer,
                                          n_micro=n_micro))(params, x)
    for res in _results(worlds, "apply", name, APPLY):
        np.testing.assert_allclose(res["out"], ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(res["out"], np.asarray(jout), atol=1e-5, rtol=0)
        np.testing.assert_allclose(res["dtensor_out"], res["out"], atol=0, rtol=0)


def test_pipeline_composes_with_data_parallel(worlds) -> None:
    import jax

    from torchsnapshot_tpu.parallel import pipelined_apply as jax_apply

    name = "data2_stages4"
    seed = sorted(APPLY).index(name)
    params, x = _params(seed), _x(seed)
    jout = jax.jit(lambda p, x: jax_apply(p, x, _jax_mesh(APPLY[name][1]), layer_fn=_jax_layer,
                                          n_micro=4))(params, x)
    for res in _results(worlds, "apply", name, APPLY):
        np.testing.assert_allclose(res["out"], _sequential(params, x), atol=1e-5, rtol=0)
        np.testing.assert_allclose(res["out"], np.asarray(jout), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["stages4_micro4", "data2_stages4"])
def test_pipeline_gradients_match_sequential_and_jax(worlds, name) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.parallel import pipelined_apply as jax_apply

    _, shape, n_micro = APPLY[name]
    seed = sorted(APPLY).index(name)
    params, x = _params(seed), _x(seed)
    mesh = _jax_mesh(shape)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jax_apply(p, x, mesh, layer_fn=_jax_layer,
                                                         n_micro=n_micro) ** 2),
                          argnums=(0, 1)))(params, x)
    # sum(out ** 2) is B * D times the MSE against zero targets.
    _, ref = _oracle_value_and_grad(params, x, np.zeros_like(x), 1)
    for res in _results(worlds, "apply", name, APPLY):
        np.testing.assert_allclose(res["gx"], np.asarray(jg[1]), atol=1e-4, rtol=0)
        for k in ("w", "b"):
            np.testing.assert_allclose(res[f"g_{k}"], np.asarray(jg[0][k]), atol=1e-4, rtol=0)
            np.testing.assert_allclose(res[f"g_{k}"], ref[k] * B * D, atol=1e-4, rtol=0)
    # The DTensor params' gradients are each stage's block of the same.
    n_pipe = shape["pipe"]
    for rank, res in worlds[APPLY[name][0]].items():
        r = res["apply"][name]
        stage = rank % n_pipe
        for k in ("w", "b"):
            block = r[f"g_{k}"][stage * (L // n_pipe):(stage + 1) * (L // n_pipe)]
            np.testing.assert_allclose(r[f"dtensor_g_{k}"], block, atol=1e-5, rtol=0)


def test_pipeline_validation_errors(worlds) -> None:
    """The port raises the JAX package's messages (pipeline.py:126-158)."""
    errors = worlds[4][0]["errors"]
    assert errors["micro"] == "batch 8 not divisible by n_micro 3"
    assert errors["layers"] == "6 layers not divisible by 4 stages"
    assert errors["no_pipe"] == "mesh ('data',) lacks pipe axis 'pipe'"
    assert errors["per_micro"] == (
        "per-microbatch size 2 not divisible by the 'data' axis size 4 (batch 8, n_micro 4)")


def test_pipeline_params_snapshot_roundtrip(worlds) -> None:
    """Params placed on 4 stages, taken, restored onto 2 stages bit-exact;
    the restored params run the pipeline."""
    want = _params(6)
    for res in worlds[2].values():
        r = res["restore"]
        for k in want:
            assert np.array_equal(r["restored"][k], want[k]), k
        np.testing.assert_allclose(r["out"], _sequential(want, _x(13)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", [n for n in sorted(ONE_F_ONE_B) if n.startswith("stages")])
def test_1f1b_matches_dense_oracle_and_jax(worlds, name) -> None:
    _check_1f1b(worlds, name)


def test_1f1b_composes_with_data_parallel(worlds) -> None:
    _check_1f1b(worlds, "data2_stages4")


def _check_1f1b(worlds, name: str) -> None:
    import jax

    from torchsnapshot_tpu.parallel import pipelined_value_and_grad as jax_vg

    _, shape, n_micro = ONE_F_ONE_B[name]
    seed = sorted(ONE_F_ONE_B).index(name)
    params, x, t = _params(seed), _x(seed), _x(seed + 50)
    ref_loss, ref = _oracle_value_and_grad(params, x, t, n_micro)
    mesh = _jax_mesh(shape)
    jloss, jgrads = jax.jit(lambda p, x, t: jax_vg(
        p, x, t, mesh, layer_fn=_jax_layer, loss_fn=lambda y, tt: ((y - tt) ** 2).mean(),
        n_micro=n_micro))(params, x, t)
    for res in _results(worlds, "1f1b", name, ONE_F_ONE_B):
        assert abs(res["loss"] - ref_loss) <= 1e-5
        assert abs(res["loss"] - float(jloss)) <= 1e-5
        for k in ("w", "b"):
            np.testing.assert_allclose(res[f"g_{k}"], ref[k], atol=1e-4, rtol=0)
            np.testing.assert_allclose(res[f"g_{k}"], np.asarray(jgrads[k]), atol=1e-4, rtol=0)


def test_1f1b_training_snapshot_reshard_4_to_2_stages(worlds) -> None:
    """2 SGD steps of 1F1B on 4 stages, a snapshot, 2 more steps on 2
    stages: the losses follow the dense oracle's 4 steps."""
    p = _params(9)
    x, t = _x(6), _x(56)
    losses = []
    for _ in range(4):
        loss, grads = _oracle_value_and_grad(p, x, t, 4)
        p = {k: (p[k] - LR * grads[k]).astype(np.float32) for k in p}
        losses.append(loss)
    for res4 in worlds[4].values():
        for res2 in worlds[2].values():
            got = res4["losses_4_stages"] + res2["restore"]["losses"]
            np.testing.assert_allclose(got, losses, atol=1e-4, rtol=0)


def test_make_mesh_takes_a_pipe_axis(worlds) -> None:
    """``make_mesh`` with a ``pipe`` axis: the default ``axis_names``
    ("data", "model") do not get in the way."""
    for res in worlds[8].values():
        assert res["mesh"] == (("data", "pipe"), (2, 4))
