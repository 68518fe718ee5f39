"""The flagship transformer's mesh path: the port against the JAX package.

One spawned gloo world of 4 processes (on the CPU) runs every case: the
same params (made from a seed with numpy) as DTensors on a ``('data',
'seq', 'model')`` mesh, the global logits, and one train step of
``make_train_step(mesh=)``. Each case is held against the JAX package's
mesh step on its virtual CPU devices (same mesh shape) and against the
port's single-process step: loss within 1e-5 relative, gradients (read
from Adam's first moment, ``mu = (1 - b1) * g`` after one step) within
from torch_test_env import autotune_never  # noqa: F401 - autouse
1e-4, logits within 1e-5.

The world also restores a train state that the JAX package took on its
2 x 2 x 2 mesh into ``init_state(mesh=)``'s DTensors (bit-exact), and
takes its own, which the JAX package restores in this process.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses

pytestmark = [pytest.mark.multiprocess]

SMALL = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=16)
TOKENS = (4, 16)
MESH_A = {"data": 1, "seq": 2, "model": 2}
MESH_B = {"data": 2, "seq": 2, "model": 1}

# name: (mesh shape, config overrides)
CASES = {
    "ring_dp1_cp2_tp2": (MESH_A, dict(attn_impl="ring")),
    "zigzag_dp1_cp2_tp2": (MESH_A, dict(attn_impl="zigzag")),
    "ulysses_dp1_cp2_tp2": (MESH_A, dict(attn_impl="ulysses", n_heads=4)),
    "zigzag_moe_dp1_cp2_tp2": (MESH_A, dict(attn_impl="zigzag", n_experts=2)),
    "ring_dp2_cp2": (MESH_B, dict(attn_impl="ring")),
    "auto_dp2_tp2": ({"data": 2, "model": 2}, dict(attn_impl="auto")),
}


def _overrides(name: str) -> dict:
    return {**SMALL, **CASES[name][1]}


def _np_params(kw: dict, seed: int) -> dict:
    """``init_params``' tree and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    L, D, Fd, V = kw["n_layers"], kw["d_model"], kw["d_ff"], kw["vocab_size"]

    def norm(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in**-0.5).astype(np.float32)

    layers = {"attn_qkv": norm((L, D, 3 * D), D), "attn_out": norm((L, D, D), D),
              "ln1_scale": np.ones((L, D), np.float32), "ln2_scale": np.ones((L, D), np.float32)}
    E = kw.get("n_experts", 0)
    if E:
        layers.update(moe_router=norm((L, D, E), D), moe_w_in=norm((L, E, D, Fd), D),
                      moe_w_out=norm((L, E, Fd, D), Fd))
    else:
        layers.update(ff_in=norm((L, D, Fd), D), ff_out=norm((L, Fd, D), Fd))
    return {"embed": norm((V, D), D), "layers": layers, "ln_f_scale": np.ones((D,), np.float32)}


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, SMALL["vocab_size"], TOKENS).astype(np.int32)
            for k in ("tokens", "targets")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _port_state(np_params: dict, cfg, opt):
    import torch

    from torchsnapshot_tpu_torch.models import transformer as T

    params = T.params_from_numpy(np_params, device="cpu")
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _run_case(name: str, seed: int) -> dict:
    import torch

    from torchsnapshot_tpu_torch.entry import _global_state
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh, shard_pytree

    shape, _ = CASES[name]
    mesh = make_mesh(shape, device="cpu")
    cfg = T.TransformerConfig(**_overrides(name), dtype=torch.float32)
    opt = T.make_optimizer()
    np_params = _np_params(_overrides(name), seed)
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(seed).items()}
    state = _port_state(np_params, cfg, opt)
    dstate = shard_pytree(state, T.state_specs(cfg, state), mesh)
    logits = T.forward(dstate["params"], batch["tokens"], cfg, mesh=mesh)
    dstate, loss = T.make_train_step(cfg, opt, mesh=mesh)(dstate, batch)
    single_logits = T.forward(state["params"], batch["tokens"], cfg)
    state, single_loss = T.make_train_step(cfg, opt)(state, batch)
    full = _global_state(dstate, cfg, mesh)
    return {
        "loss": float(loss), "logits": logits.numpy(), "mu": {k: v.numpy() for k, v in
                                                             _flat(full["opt_state"][0].mu).items()},
        "step": int(full["step"]), "single_loss": float(single_loss),
        "single_logits": single_logits.numpy(),
        "single_mu": {k: v.numpy() for k, v in _flat(state["opt_state"][0].mu).items()},
    }


def _interchange(rank: int, jax_root: str, port_root: str) -> dict:
    """Restore the JAX package's mesh train state into ``init_state(mesh=)``,
    then take the state after a port step."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.entry import _global_state
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MESH_A, device="cpu")
    cfg = T.TransformerConfig(**_overrides("ring_dp1_cp2_tp2"), dtype=torch.float32)
    opt = T.make_optimizer()
    dst = StateDict(T.init_state(torch.Generator().manual_seed(5), cfg, opt, mesh=mesh))
    Snapshot(jax_root).restore({"train": dst})
    restored = _global_state(dict(dst), cfg, mesh)
    state = dict(dst)
    state, _ = T.make_train_step(cfg, opt, mesh=mesh)(
        state, {k: torch.from_numpy(v).long() for k, v in _batch(9).items()})
    Snapshot.take(port_root, {"train": StateDict(state)})
    taken = _global_state(state, cfg, mesh)

    def arrays(s):
        adam = s["opt_state"][0]
        return {**_flat({"params": s["params"], "mu": adam.mu, "nu": adam.nu}),
                "count": adam.count, "step": s["step"]}

    return {"restored": {k: v.numpy() for k, v in arrays(restored).items()},
            "taken": {k: v.numpy() for k, v in arrays(taken).items()}}


def _global_grads(name: str, seed: int) -> dict:
    """Gradients of ``loss_fn(mesh=)`` through global (plain) params that
    every rank holds whole: every rank gets the whole gradient."""
    import torch

    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh

    mesh = make_mesh(CASES[name][0], device="cpu")
    cfg = T.TransformerConfig(**_overrides(name), dtype=torch.float32)
    params = T.params_from_numpy(_np_params(_overrides(name), seed), device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(seed).items()}
    loss, grads = T.value_and_grad(lambda p: T.loss_fn(p, batch, cfg, mesh=mesh), params)
    return {"loss": float(loss), "grads": {k: v.numpy() for k, v in _flat(grads).items()}}


def _meshes() -> dict:
    """``make_mesh``'s defaults and placements on this world of 4."""
    from torchsnapshot_tpu_torch.parallel import P, make_mesh
    from torchsnapshot_tpu_torch.parallel.mesh import placements

    out = {"default": dict(zip(make_mesh(device="cpu").mesh_dim_names,
                               make_mesh(device="cpu").mesh.shape))}
    m = make_mesh({"data": -1, "seq": 1, "model": 2}, device="cpu")
    out["rest"] = dict(zip(m.mesh_dim_names, m.mesh.shape))
    out["placements"] = [repr(p) for p in placements(P(None, None, "model"), m, 3)]
    for what, fn in (("size", lambda: make_mesh({"data": 3, "model": 2}, device="cpu")),
                     ("names", lambda: make_mesh({"x": 4}, device="cpu",
                                                 axis_names=("data", "seq", "model")))):
        try:
            fn()
            out[what] = "no error"
        except ValueError as exc:
            out[what] = str(exc)
    return out


def _worker(rank: int, world: int, jax_root: str, port_root: str) -> dict:
    import torch

    # One thread a rank: the ranks share the test host with other test
    # processes, and their tensors are tiny.
    torch.set_num_threads(1)

    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh

    out = {name: _run_case(name, seed) for seed, name in enumerate(sorted(CASES))}
    out["global_grads"] = _global_grads("zigzag_moe_dp1_cp2_tp2", 91)
    out["meshes"] = _meshes()
    out["interchange"] = _interchange(rank, jax_root, port_root)
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    cfg = T.TransformerConfig(**SMALL, dtype=torch.float32, attn_impl="ring")
    try:
        T.make_train_step(cfg, T.make_optimizer(), mesh=mesh)(
            T.init_state(torch.Generator().manual_seed(0), cfg, T.make_optimizer(), mesh=mesh),
            {k: torch.zeros(TOKENS, dtype=torch.long) for k in ("tokens", "targets")})
        out["seqless"] = "no error"
    except ValueError as exc:
        out["seqless"] = str(exc)
    return out


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _jax_state(np_params, cfg, tx, mesh):
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import transformer as JT
    from torchsnapshot_tpu.parallel.mesh import shard_pytree

    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    return shard_pytree(state, JT.state_specs(cfg, state), mesh)


def _jax_take(root: str) -> dict:
    """The JAX package's mesh train state after a step, taken on a 2 x 2 x 2
    mesh of its virtual devices."""
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu import Snapshot, StateDict
    from torchsnapshot_tpu.models import transformer as JT

    mesh = _jax_mesh({"data": 2, "seq": 2, "model": 2})
    cfg = JT.TransformerConfig(**_overrides("ring_dp1_cp2_tp2"), dtype=jnp.float32)
    tx = JT.make_optimizer()
    state = _jax_state(_np_params(_overrides("ring_dp1_cp2_tp2"), 77), cfg, tx, mesh)
    state, _ = jax.jit(JT.make_train_step(cfg, tx, mesh=mesh))(
        state, jax.tree_util.tree_map(jnp.asarray, _batch(78)))
    Snapshot.take(root, {"train": StateDict(**state)}, replicated=["**"])
    return state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_transformer")
    jax_state = _jax_take(str(root / "jax"))
    out = run_with_subprocesses(_worker, 4, str(root / "jax"), str(root / "port"),
                                backend="gloo", timeout=300)
    return out, jax_state, root


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_train_step_matches_the_jax_package_and_one_process(world, name: str) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import transformer as JT

    results, _, _ = world
    shape, _ = CASES[name]
    mesh = _jax_mesh(shape)
    cfg = JT.TransformerConfig(**_overrides(name), dtype=jnp.float32)
    tx = JT.make_optimizer()
    seed = sorted(CASES).index(name)
    state = _jax_state(_np_params(_overrides(name), seed), cfg, tx, mesh)
    batch = jax.tree_util.tree_map(jnp.asarray, _batch(seed))
    state, loss = jax.jit(JT.make_train_step(cfg, tx, mesh=mesh))(state, batch)
    jax_mu = {k: np.asarray(v) for k, v in _flat(state["opt_state"][0].mu).items()}
    for rank, res in results.items():
        got = res[name]
        assert got["step"] == 1
        for want in (float(loss), got["single_loss"]):
            assert abs(got["loss"] - want) <= 1e-5 * abs(want), (rank, got["loss"], want)
        np.testing.assert_allclose(got["logits"], got["single_logits"], atol=1e-5, rtol=0)
        for path, mu in got["mu"].items():
            # mu = (1 - b1) * grad after the first step.
            for want in (jax_mu[path], got["single_mu"][path]):
                np.testing.assert_allclose(mu / 0.1, want / 0.1, atol=1e-4, rtol=0,
                                           err_msg=f"rank {rank} grad of {path}")


def test_mesh_logits_match_the_jax_package(world) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import transformer as JT

    results, _, _ = world
    for name in ("zigzag_moe_dp1_cp2_tp2", "ulysses_dp1_cp2_tp2"):
        shape, _ = CASES[name]
        mesh = _jax_mesh(shape)
        cfg = JT.TransformerConfig(**_overrides(name), dtype=jnp.float32)
        params = jax.tree_util.tree_map(jnp.asarray, _np_params(_overrides(name),
                                                                sorted(CASES).index(name)))
        tokens = jnp.asarray(_batch(sorted(CASES).index(name))["tokens"])
        want = np.asarray(jax.jit(lambda p, t: JT.forward(p, t, cfg, mesh=mesh))(params, tokens))
        for res in results.values():
            np.testing.assert_allclose(res[name]["logits"], want, atol=1e-5, rtol=0)


def test_a_jax_mesh_state_restores_into_the_port_world(world) -> None:
    results, jax_state, _ = world
    adam = jax_state["opt_state"][0]
    want = {**_flat({"params": jax_state["params"], "mu": adam.mu, "nu": adam.nu}),
            "count": adam.count, "step": jax_state["step"]}
    for res in results.values():
        got = res["interchange"]["restored"]
        assert set(got) == set(want)
        for path, arr in want.items():
            np.testing.assert_array_equal(got[path], np.asarray(arr), err_msg=path)


def test_the_port_world_state_restores_into_the_jax_package(world) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu import Snapshot, StateDict
    from torchsnapshot_tpu.models import transformer as JT

    results, _, root = world
    mesh = _jax_mesh({"data": 2, "seq": 2, "model": 2})
    cfg = JT.TransformerConfig(**_overrides("ring_dp1_cp2_tp2"), dtype=jnp.float32)
    tx = JT.make_optimizer()
    dst = StateDict(**JT.init_state(jax.random.PRNGKey(3), cfg, tx, mesh=mesh))
    Snapshot(str(root / "port")).restore({"train": dst})
    adam = dst["opt_state"][0]
    got = {**_flat({"params": dst["params"], "mu": adam.mu, "nu": adam.nu}),
           "count": adam.count, "step": dst["step"]}
    want = results[0]["interchange"]["taken"]
    assert int(got["step"]) == 2
    for path, arr in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), arr, err_msg=path)


def test_a_context_parallel_impl_needs_a_seq_axis(world) -> None:
    results, _, _ = world
    for res in results.values():
        assert re.search("attn_impl='ring' needs a mesh with a 'seq' axis; got \\('data', "
                         "'model'\\)", res["seqless"]), res["seqless"]


def test_make_train_step_takes_only_a_device_mesh() -> None:
    import torch

    from torchsnapshot_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**SMALL, dtype=torch.float32)
    for fn in (lambda: T.make_train_step(cfg, T.make_optimizer(), mesh=object()),
               lambda: T.init_state(torch.Generator(), cfg, T.make_optimizer(), mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn()


def test_loss_fn_of_global_params_gives_every_rank_the_whole_gradient(world) -> None:
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import transformer as JT

    results, _, _ = world
    name = "zigzag_moe_dp1_cp2_tp2"
    mesh = _jax_mesh(CASES[name][0])
    cfg = JT.TransformerConfig(**_overrides(name), dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, _np_params(_overrides(name), 91))
    batch = jax.tree_util.tree_map(jnp.asarray, _batch(91))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, cfg, mesh=mesh)))(params)
    want = {k: np.asarray(v) for k, v in _flat(grads).items()}
    for rank, res in results.items():
        got = res["global_grads"]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for path, g in got["grads"].items():
            np.testing.assert_allclose(g, want[path], atol=1e-4, rtol=0,
                                       err_msg=f"rank {rank} {path}")


def test_specs_match_the_jax_package() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from torchsnapshot_tpu.models import transformer as JT
    from torchsnapshot_tpu_torch.models import transformer as T

    for n_experts in (0, 4):
        jcfg = JT.TransformerConfig(**SMALL, dtype=jnp.float32, n_experts=n_experts)
        pcfg = T.TransformerConfig(**SMALL, dtype=torch.float32, n_experts=n_experts)
        jstate = JT.init_state(jax.random.PRNGKey(0), jcfg, JT.make_optimizer())
        pstate = T.init_state(torch.Generator().manual_seed(0), pcfg, T.make_optimizer(), "cpu")
        jspecs = jax.tree_util.tree_leaves_with_path(
            JT.state_specs(jcfg, jstate), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        pspecs = T.state_specs(pcfg, pstate)
        flat_p = {}

        def walk(tree, prefix):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, prefix + (k,))
            elif hasattr(tree, "_fields"):
                for k in tree._fields:
                    walk(getattr(tree, k), prefix + (k,))
            elif isinstance(tree, tuple) and type(tree).__name__ != "PartitionSpec":
                for i, v in enumerate(tree):
                    walk(v, prefix + (i,))
            else:
                flat_p[prefix] = tuple(tree)

        walk(pspecs, ())
        flat_j = {}
        for path, spec in jspecs:
            key = tuple(getattr(p, "key", getattr(p, "idx", getattr(p, "name", None)))
                        for p in path)
            flat_j[key] = tuple(spec)
        assert len(flat_p) > 10 and flat_p == flat_j


def test_make_mesh_keeps_the_jax_defaults(world) -> None:
    import jax

    from torchsnapshot_tpu.parallel import make_mesh as jax_make_mesh

    results, _, _ = world
    want = dict(jax_make_mesh(devices=jax.devices()[:4]).shape)
    for res in results.values():
        m = res["meshes"]
        assert m["default"] == want == {"data": 2, "model": 2}
        assert m["rest"] == {"data": 2, "seq": 1, "model": 2}
        assert m["placements"] == ["Replicate()", "Replicate()", "Shard(dim=2)"]
        assert "!= 4 devices" in m["size"]
        assert "conflicts with axis_sizes keys" in m["names"]
