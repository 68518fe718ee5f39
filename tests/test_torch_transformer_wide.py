"""The port's transformer at head_dim 256 against the JAX package's.

Head dim 256 is the width K1-K3 take at tile width 256 (the JAX package's
``benchmarks/async_stall.py`` reaches it at 2,500 MB of state, with 8
heads). Config: vocab 256, d_model 512, 2 heads (head_dim 256), 2 layers,
d_ff 128, S = 64, attention blocks of 16, ``attn_impl="flash"`` on both
sides: the JAX side runs its Pallas flash kernels in interpret mode, the
port the kernels' plain versions (on the card these shapes reach the
kernels; ``tests/test_torch_kernels_cuda.py``). The JAX package draws the
parameters; ``params_from_numpy`` carries them into the port.

Bars: f32 logits 2e-4 and bf16 logits 0.0625 on the maximum and 0.01 on
the mean, as ``tests/test_torch_transformer.py`` holds them; the f32 loss
and every gradient leaf at 1e-6 absolute, as ``tests/test_torch_train.py``
holds them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torchsnapshot_tpu.flatten import flatten as jax_flatten
from torchsnapshot_tpu.models import transformer as JT
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import flash_attention as fa
from torch_test_env import autotune_never  # noqa: F401 - autouse

WIDE = dict(vocab_size=256, d_model=512, n_heads=2, n_layers=2, d_ff=128, max_seq_len=64)


def _setup(dtype: str):
    kw = dict(WIDE, attn_impl="flash", attn_block_size=16)
    jcfg = JT.TransformerConfig(**kw, dtype=getattr(jnp, dtype))
    pcfg = T.TransformerConfig(**kw, dtype=getattr(torch, dtype))
    assert pcfg.head_dim == 256 and fa.kernel_width(pcfg.head_dim, pcfg.dtype) == 256
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    tokens, targets = (rng.integers(0, WIDE["vocab_size"], (2, 64), dtype=np.int32)
                       for _ in range(2))
    return jcfg, pcfg, jparams, params, tokens, targets


def _logits(jcfg, pcfg, jparams, params, tokens):
    port = T.forward(params, torch.from_numpy(tokens).long(), pcfg).float().numpy()
    ref = np.asarray(JT.forward(jparams, jnp.asarray(tokens), jcfg).astype(jnp.float32))
    return port, ref


def test_wide_f32_logits_match_jax() -> None:
    jcfg, pcfg, jparams, params, tokens, _ = _setup("float32")
    port, ref = _logits(jcfg, pcfg, jparams, params, tokens)
    assert port.shape == (2, 64, WIDE["vocab_size"])
    np.testing.assert_allclose(port, ref, atol=2e-4)


def test_wide_bf16_logits_match_jax() -> None:
    jcfg, pcfg, jparams, params, tokens, _ = _setup("bfloat16")
    port, ref = _logits(jcfg, pcfg, jparams, params, tokens)
    diff = np.abs(port - ref)
    assert diff.max() <= 0.0625, diff.max()
    assert diff.mean() <= 0.01, diff.mean()


def test_wide_f32_loss_and_gradients_match_jax() -> None:
    jcfg, pcfg, jparams, params, tokens, targets = _setup("float32")
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    pbatch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jparams, jbatch, jcfg)
    loss, grads = T.loss_and_grads(params, pbatch, pcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-6
    want = {p: np.asarray(x) for p, x in jax_flatten(jgrads)[1].items()}
    got = {p: x.numpy() for p, x in port_flatten(grads)[1].items()}
    assert got.keys() == want.keys() and len(got) == 8
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6, rtol=0, err_msg=path)
