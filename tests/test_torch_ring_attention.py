"""Context-parallel attention of the port against the JAX package.

Two spawned gloo worlds (4 and 2 processes, on the CPU) share this module:
each rank runs every case's sharded op of the port on the same global
inputs (made from a seed with numpy), forward and backward, and returns
the output and the gradients of ``sum(out * w)``. In this process the JAX
package runs the same op on a mesh of the same shape over its virtual CPU
devices (ring-flash and zigzag-flash through Pallas interpret mode, as
its own tests run them). Bars, f32: forward 1e-5, gradients 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = [pytest.mark.multiprocess]

B, S, H, D = 2, 32, 4, 8

# name: (world, mesh shape, op, keyword arguments)
CASES = {
    "ring_seq4": (4, {"seq": 4}, "ring", {"causal": True}),
    "ring_full_data2_seq2": (4, {"data": 2, "seq": 2}, "ring", {"causal": False}),
    "ring_with_model_axis": (4, {"seq": 2, "model": 2}, "ring", {"causal": True}),
    "zigzag_seq4": (4, {"seq": 4}, "zigzag", {}),
    "zigzag_with_model_axis": (4, {"seq": 2, "model": 2}, "zigzag", {}),
    "ring_flash_seq4": (4, {"seq": 4}, "ring_flash", {"causal": True}),
    "ring_flash_full_data2_seq2": (4, {"data": 2, "seq": 2}, "ring_flash", {"causal": False}),
    "zigzag_flash_seq4": (4, {"seq": 4}, "zigzag_flash", {}),
    "zigzag_flash_in_layout_with_model_axis": (4, {"seq": 2, "model": 2}, "zigzag_flash",
                                               {"in_layout": True}),
    "ulysses_seq4": (4, {"seq": 4}, "ulysses", {}),
    "ulysses_flash_with_model_axis": (4, {"seq": 2, "model": 2}, "ulysses", {"inner": "flash"}),
    "flash_sharded_data2_model2": (4, {"data": 2, "model": 2}, "flash_sharded", {}),
    "ring_seq2": (2, {"seq": 2}, "ring", {"causal": True}),
    "zigzag_seq2": (2, {"seq": 2}, "zigzag", {}),
    "ring_flash_seq2": (2, {"seq": 2}, "ring_flash", {"causal": True}),
    "zigzag_flash_seq2": (2, {"seq": 2}, "zigzag_flash", {}),
    "ulysses_seq2": (2, {"seq": 2}, "ulysses", {}),
    "flash_sharded_model2": (2, {"model": 2}, "flash_sharded", {}),
}


def _inputs(name: str):
    """q, k, v and the cotangent weights w, (B, S, H, D) f32, from a seed."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4)]


def _port_op(op: str):
    from torchsnapshot_tpu_torch.ops import flash_attention, ring_attention, ring_flash, ulysses

    return {
        "ring": ring_attention.ring_attention_sharded,
        "zigzag": ring_attention.zigzag_ring_attention_sharded,
        "ring_flash": ring_flash.ring_flash_attention_sharded,
        "zigzag_flash": ring_flash.zigzag_ring_flash_attention_sharded,
        "ulysses": ulysses.ulysses_attention_sharded,
        "flash_sharded": flash_attention.flash_attention_sharded,
    }[op]


def _error(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return "no error"


def _errors(world: int) -> dict:
    """The ValueErrors of the sharded ops, on meshes of this world."""
    import torch

    from torchsnapshot_tpu_torch.parallel import make_mesh

    if world != 4:
        return {}
    seq4 = make_mesh({"seq": 4}, device="cpu")
    dm = make_mesh({"data": 2, "model": 2}, device="cpu")
    x = torch.zeros(B, S, 2, D)
    odd = torch.zeros(B, 36, H, D)
    return {
        "head_starved": _error(lambda: _port_op("ulysses")(x, x, x, seq4)),
        "zigzag_indivisible": _error(lambda: _port_op("zigzag")(odd, odd, odd, seq4)),
        "zigzag_flash_indivisible": _error(lambda: _port_op("zigzag_flash")(odd, odd, odd, seq4)),
        "ring_without_seq": _error(lambda: _port_op("ring")(x, x, x, dm)),
        "ulysses_without_seq": _error(lambda: _port_op("ulysses")(x, x, x, dm)),
        "flash_heads": _error(lambda: _port_op("flash_sharded")(*(torch.zeros(B, S, 3, D),) * 3, dm)),
        "flash_batch": _error(lambda: _port_op("flash_sharded")(*(torch.zeros(3, S, H, D),) * 3, dm)),
    }


def _worker(rank: int, world: int) -> dict:
    import torch

    # One thread a rank: the ranks share the test host with other test
    # processes, and their tensors are tiny.
    torch.set_num_threads(1)

    from torchsnapshot_tpu_torch.parallel import make_mesh

    out = {}
    for name, (w, shape, op, kwargs) in CASES.items():
        if w != world:
            continue
        mesh = make_mesh(shape, device="cpu")
        q, k, v, wt = (torch.from_numpy(a) for a in _inputs(name))
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = _port_op(op)(q, k, v, mesh, **kwargs)
        (o * wt).sum().backward()
        out[name] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    out["errors"] = _errors(world)
    return out


@pytest.fixture(scope="module")
def worlds():
    return {
        n: run_with_subprocesses(_worker, n, backend="gloo", timeout=300) for n in (4, 2)
    }


def _jax_case(name: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from torchsnapshot_tpu.ops import (
        ring_attention_sharded,
        ulysses_attention_sharded,
        zigzag_ring_attention_sharded,
    )
    from torchsnapshot_tpu.ops.pallas_attention import flash_attention_sharded
    from torchsnapshot_tpu.ops.ring_flash import (
        ring_flash_attention_sharded,
        zigzag_ring_flash_attention_sharded,
    )

    world, shape, op, kwargs = CASES[name]
    fn = {
        "ring": ring_attention_sharded,
        "zigzag": zigzag_ring_attention_sharded,
        "ring_flash": ring_flash_attention_sharded,
        "zigzag_flash": zigzag_ring_flash_attention_sharded,
        "ulysses": ulysses_attention_sharded,
        "flash_sharded": flash_attention_sharded,
    }[op]
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(tuple(shape.values())), tuple(shape))
    q, k, v, w = (jnp.asarray(a) for a in _inputs(name))

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, **kwargs), q, k, v)
        return (out, *vjp(w))

    return [np.asarray(a) for a in run(q, k, v, w)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_attention_matches_the_jax_package(worlds, name: str) -> None:
    world = CASES[name][0]
    want = _jax_case(name)
    for rank, res in worlds[world].items():
        got = res[name]
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0, err_msg=f"rank {rank} out")
        for g, wg, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, wg, atol=1e-4, rtol=0, err_msg=f"rank {rank} {what}")


@pytest.mark.parametrize(
    "name, pattern",
    [
        ("head_starved", "Ulysses needs heads per shard .* head-starved"),
        ("zigzag_indivisible", "not divisible by 2\\*ring=8"),
        ("zigzag_flash_indivisible", "not divisible by 2\\*ring=8"),
        ("ring_without_seq", "lacks seq axis 'seq'"),
        ("ulysses_without_seq", "lacks seq axis 'seq'"),
        ("flash_heads", "needs heads \\(3\\) divisible by the 'model' axis size \\(2\\)"),
        ("flash_batch", "needs batch \\(3\\) divisible by the 'data' axis size \\(2\\)"),
    ],
)
def test_sharded_attention_raises_as_the_jax_package(worlds, name: str, pattern: str) -> None:
    import re

    for rank, res in worlds[4].items():
        assert re.search(pattern, res["errors"][name]), (rank, res["errors"][name])


def test_zigzag_layout_round_trip_matches_the_jax_package() -> None:
    import torch

    from torchsnapshot_tpu.ops.ring_attention import zigzag_layout_indices as jax_indices
    from torchsnapshot_tpu_torch.ops.ring_attention import zigzag_layout_indices

    for seq, ring in ((32, 2), (32, 4), (48, 3), (8, 1)):
        idx = zigzag_layout_indices(seq, ring)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_indices(seq, ring)))
        x = torch.arange(seq * 3).reshape(1, seq, 3)
        assert torch.equal(x.index_select(1, idx).index_select(1, torch.argsort(idx)), x)
    with pytest.raises(ValueError, match="not divisible by 2\\*ring=4"):
        zigzag_layout_indices(30, 2)
