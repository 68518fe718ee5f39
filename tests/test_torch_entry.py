"""The port's first slice end to end on the CPU, at a small config:
JAX parameters carried across, forward, take, restore into zeros (bit-exact,
identical logits), and the JAX package restoring the port's snapshot."""

from __future__ import annotations

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.models import transformer as JT
from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, ENTRY_TOKENS_SHAPE, entry
from torchsnapshot_tpu_torch.models import transformer as T
from torch_test_env import autotune_never  # noqa: F401 - autouse

SMALL = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64)


def _zeros(params):
    return {
        "embed": torch.zeros_like(params["embed"]),
        "layers": {k: torch.zeros_like(v) for k, v in params["layers"].items()},
        "ln_f_scale": torch.zeros_like(params["ln_f_scale"]),
    }


def test_serve_checkpoint_restore_round_trip(tmp_path) -> None:
    jcfg = JT.TransformerConfig(**SMALL, dtype=jnp.float32, attn_impl="dense")
    pcfg = T.TransformerConfig(**SMALL, dtype=torch.float32, attn_impl="flash", attn_block_size=16)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, SMALL["vocab_size"], (2, 64), dtype=np.int32)
    logits = T.forward(params, torch.from_numpy(tokens).long(), pcfg)

    P.Snapshot.take(
        str(tmp_path / "s"),
        {"model": P.StateDict(params=params), "progress": P.StateDict(step=3)},
    )
    fresh, progress = _zeros(params), P.StateDict(step=0)
    P.Snapshot(str(tmp_path / "s")).restore(
        {"model": P.StateDict(params=fresh), "progress": progress}
    )
    assert progress["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(T.params_to_numpy(fresh)),
                    jax.tree_util.tree_leaves(T.params_to_numpy(params))):
        assert np.array_equal(a, b)
    assert torch.equal(T.forward(fresh, torch.from_numpy(tokens).long(), pcfg), logits)

    # The JAX package restores the port's snapshot; its forward matches the
    # port's at the f32 bar of test_pallas_attention.py (2e-4).
    jdst = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    holder = J.StateDict(params=jdst)
    J.Snapshot(str(tmp_path / "s")).restore({"model": holder})
    for a, b in zip(jax.tree_util.tree_leaves(holder["params"]), jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jlogits = JT.forward(holder["params"], jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)


def test_entry_on_cpu_matches_the_jax_entry_config() -> None:
    fn, (params, tokens) = entry(device="cpu", seed=0, cfg=T.TransformerConfig(**SMALL))
    assert tokens.shape == ENTRY_TOKENS_SHAPE and tokens.device.type == "cpu"
    out = fn(params, tokens[:, :64])
    assert out.shape == (4, 64, SMALL["vocab_size"]) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert (ENTRY_CONFIG.vocab_size, ENTRY_CONFIG.d_model, ENTRY_CONFIG.n_heads,
            ENTRY_CONFIG.n_layers, ENTRY_CONFIG.d_ff) == (8192, 512, 8, 4, 2048)
    assert ENTRY_CONFIG.dtype == torch.bfloat16 and ENTRY_CONFIG.param_dtype == torch.float32


def test_dryrun_layouts_match_the_jax_dryrun() -> None:
    """The meshes of ``dryrun_multichip`` (``__graft_entry__.py:80-89``,
    ``:156-180``): the first mesh and impl, and the restore's mesh."""
    from torchsnapshot_tpu.parallel import make_mesh
    from torchsnapshot_tpu_torch.entry import dryrun_config, dryrun_layouts

    for n in (1, 2, 3, 4, 6, 8):
        sizes, impl, sizes2 = dryrun_layouts(n)
        devices = jax.devices()[:n]
        if n % 4 == 0:
            want = make_mesh({"data": n // 4, "seq": 2, "model": 2}, devices=devices)
            want2 = make_mesh({"data": n // 2, "seq": 1, "model": 2}, devices=devices)
        else:
            want = make_mesh(devices=devices)
            swapped = {"data": want.shape["model"], "model": want.shape["data"]}
            jcfg = JT.TransformerConfig(n_heads=2, d_ff=16 * max(2, n))
            ok = jcfg.n_heads % swapped["model"] == 0 and jcfg.d_ff % swapped["model"] == 0
            want2 = make_mesh(swapped, devices=devices) if ok else want
        assert sizes == dict(want.shape) and sizes2 == dict(want2.shape), n
        assert impl == ("ring" if n % 4 == 0 else "dense")
        cfg = dryrun_config(n, impl)
        assert (cfg.d_model, cfg.d_ff, cfg.n_experts) == (8 * max(2, n), 16 * max(2, n),
                                                          2 if impl == "ring" else 0)


def _pipeline_oracle(world: int, seed: int = 0) -> dict:
    """``dryrun_pipeline``'s two losses in one process: the same params
    (L 4, D 8, from ``seed``), the GPipe loss ``mean(out ** 2)`` and its SGD
    step, then the 1F1B loss (mean over 4 microbatches of the MSE against
    zeros) at the stepped params."""
    import torch

    L, D, rows = 4, 8, 4 * (world // 2)
    gen = torch.Generator().manual_seed(seed)
    w = (torch.randn(L, D, D, generator=gen) * D**-0.5).requires_grad_(True)
    b = torch.zeros(L, D, requires_grad=True)

    def run(x):
        for i in range(L):
            x = torch.tanh(x @ w[i] + b[i])
        return x

    x = torch.ones(rows, D)
    gpipe = (run(x) ** 2).mean()
    gw, gb = torch.autograd.grad(gpipe, (w, b))
    with torch.no_grad():
        w -= 0.01 * gw
        b -= 0.01 * gb
        one = torch.stack([(run(m) ** 2).mean() for m in x.reshape(4, -1, D)]).mean()
    return {"gpipe_loss": float(gpipe.detach()), "1f1b_loss": float(one)}


def test_dryrun_multichip_on_cpu() -> None:
    """A world of 4 on the CPU: the dp x cp x tp x ep step (ring attention,
    the MoE FFN), the round trip of the DTensor state into {data 2, seq 1,
    model 2}, bit-exact, and a second step; the device-digest incremental
    take stages nothing and the restore into the same content consumes
    nothing; the GPipe and 1F1B steps on {data 2, pipe 2} give the
    losses of one process (1e-5)."""
    from torchsnapshot_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", timeout=300)
    assert sorted(out) == [0, 1, 2, 3]
    want = _pipeline_oracle(4)
    for res in out.values():
        assert res["mesh"] == {"data": 1, "seq": 2, "model": 2} and res["attn_impl"] == "ring"
        assert res["restore_mesh"] == {"data": 2, "seq": 1, "model": 2}
        assert np.isfinite(res["loss"]) and np.isfinite(res["loss_after_restore"])
        assert res["loss"] == out[0]["loss"]
        assert res["dd_staged"] == 0 and res["dd_consumed"] == 0
        assert "pod" not in res
        for k, v in want.items():
            assert abs(res["pipeline"][k] - v) <= 1e-5, (k, res["pipeline"][k], v)


def test_pod_drill_of_8_processes() -> None:
    """``dryrun_multichip``'s pod drill (JAX ``_dryrun_pod_topology``) in a
    gloo world of 8 CPU processes standing in for 2 hosts of 4 local ranks:
    an (8, 8) array on ("proc", "local") (2, 4) plus ``step=3``, restored
    into (4, 2), every local shard bit-exact."""
    from torchsnapshot_tpu_torch.entry import _pod_rank
    from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses

    with tempfile.TemporaryDirectory() as root:
        out = run_with_subprocesses(_pod_rank, 8, f"{root}/pod", backend="gloo", timeout=120)
    assert out == {r: "ok" for r in range(8)}
