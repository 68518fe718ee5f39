"""The port's transformer forward against the JAX forward, same parameters.

The JAX package initializes the parameters; ``params_from_numpy`` carries
them into the port. Config: 2 layers, d_model 64, 4 heads, vocab 256,
S = 64.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.models import transformer as JT
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import flash_attention as fa

SMALL = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64)


def _setup(dtype: str, attn_impl: str):
    jcfg = JT.TransformerConfig(**SMALL, dtype=getattr(jnp, dtype), attn_impl=attn_impl, attn_block_size=16)
    pcfg = T.TransformerConfig(**SMALL, dtype=getattr(torch, dtype), attn_impl=attn_impl, attn_block_size=16)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, SMALL["vocab_size"], (2, 64), dtype=np.int32)
    return jcfg, pcfg, jparams, params, tokens


def _jax_logits(jparams, tokens, jcfg) -> np.ndarray:
    return np.asarray(JT.forward(jparams, jnp.asarray(tokens), jcfg).astype(jnp.float32))


def _port_logits(params, tokens, pcfg) -> np.ndarray:
    return T.forward(params, torch.from_numpy(tokens).long(), pcfg).float().numpy()


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_f32_logits_match_jax(attn_impl: str) -> None:
    # atol 2e-4: the bar of test_pallas_attention.py's transformer check.
    jcfg, pcfg, jparams, params, tokens = _setup("float32", attn_impl)
    np.testing.assert_allclose(
        _port_logits(params, tokens, pcfg), _jax_logits(jparams, tokens, jcfg), atol=2e-4
    )


def test_bf16_logits_match_jax() -> None:
    # bf16 rounds after every matmul and norm, at places XLA and torch's CPU
    # kernels choose differently (fused vs unfused casts); at logits of
    # |x| ~ 2-4 one bf16 step is 1/64-1/32, so allow two steps on the
    # maximum and hold the mean to a third of one.
    jcfg, pcfg, jparams, params, tokens = _setup("bfloat16", "dense")
    port = _port_logits(params, tokens, pcfg)
    ref = _jax_logits(jparams, tokens, jcfg)
    diff = np.abs(port - ref)
    assert diff.max() <= 0.0625, diff.max()
    assert diff.mean() <= 0.01, diff.mean()


def test_auto_resolves_to_the_plain_path_on_cpu() -> None:
    """Off the card "auto" resolves as the JAX package does off the TPU:
    blockwise once S (64) outgrows a block (16), dense otherwise."""
    _, pcfg, _, params, tokens = _setup("float32", "auto")
    before = fa.flash_fwd.launches
    auto = _port_logits(params, tokens, pcfg)
    blockwise = _port_logits(params, tokens, dataclasses.replace(pcfg, attn_impl="blockwise"))
    np.testing.assert_array_equal(auto, blockwise)
    one_block = dataclasses.replace(pcfg, attn_block_size=64)
    dense = _port_logits(params, tokens, dataclasses.replace(one_block, attn_impl="dense"))
    np.testing.assert_array_equal(_port_logits(params, tokens, one_block), dense)
    assert fa.flash_fwd.launches == before


def test_blockwise_logits_match_jax() -> None:
    jcfg, pcfg, jparams, params, tokens = _setup("float32", "blockwise")
    np.testing.assert_allclose(
        _port_logits(params, tokens, pcfg), _jax_logits(jparams, tokens, jcfg), atol=2e-4
    )


def test_params_round_trip_through_numpy() -> None:
    _, _, jparams, params, _ = _setup("float32", "dense")
    back = T.params_to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))


def test_unknown_attn_impl_raises() -> None:
    _, pcfg, _, params, tokens = _setup("float32", "dense")
    with pytest.raises(ValueError, match="attn_impl"):
        _port_logits(params, tokens, dataclasses.replace(pcfg, attn_impl="ring"))


def test_cuda_default_without_a_card_raises(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.init_params(T.TransformerConfig(**SMALL), torch.Generator().manual_seed(0))
