"""The port's flash-attention forward on the CPU against the JAX package's.

On CPU tensors the port computes its kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_pallas_attention.py
does. Bars are that file's: 1e-5 for f32 and 3e-2 for bf16. The kernel
itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts
from torchsnapshot_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from torchsnapshot_tpu_torch.ops import flash_attention as fa

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(shape, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    jax_in = [jnp.asarray(a).astype(dtype) for a in arrays]
    port_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_in, port_in


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_raw_forward_matches_jax_fwd_impl(causal: bool, dtype: str) -> None:
    (jq, jk, jv), (q, k, v) = _inputs((4, 64, 16), seed=0, dtype=dtype)
    fwd_impl, _ = _make_flash_parts(causal, None, 16, 32, True)
    jo, jlse = fwd_impl(jq, jk, jv)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    assert o.dtype == q.dtype and lse.dtype == torch.float32 and lse.shape == (4, 64)
    np.testing.assert_allclose(_np(o), _np(jo), atol=ATOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-5)


@pytest.mark.parametrize(
    "blocks,causal",
    [((16, 16), True), ((16, 32), True), ((32, 16), False), ((64, 64), False)],
)
def test_flash_attention_matches_jax(blocks, causal) -> None:
    (jq, jk, jv), (q, k, v) = _inputs((2, 64, 2, 16), seed=1)
    bq, bk = blocks
    ref = jax_flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    out = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


def test_flash_attention_bf16_matches_jax() -> None:
    (jq, jk, jv), (q, k, v) = _inputs((2, 64, 2, 16), seed=2, dtype="bfloat16")
    ref = jax_flash_attention(jq, jk, jv, causal=True, block_q=16, block_k=16)
    out = fa.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(_np(out), _np(ref), atol=3e-2)


def test_default_blocks_snap_to_a_divisor() -> None:
    (jq, jk, jv), (q, k, v) = _inputs((1, 160, 2, 16), seed=3)
    ref = jax_flash_attention(jq, jk, jv, causal=True)
    out = fa.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


def test_plain_version_matches_dense_attention() -> None:
    from torchsnapshot_tpu_torch.ops.attention import dense_attention

    _, (q, k, v) = _inputs((2, 48, 2, 16), seed=4)
    for causal in (True, False):
        out = fa.flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)
        np.testing.assert_allclose(
            _np(out), _np(dense_attention(q, k, v, causal=causal)), atol=1e-5
        )


def test_indivisible_blocks_raise() -> None:
    _, (q, k, v) = _inputs((2, 64, 2, 16), seed=5)
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention(q, k, v, block_q=48, block_k=48)


def test_requires_grad_gives_dense_gradients() -> None:
    """Inputs that require grad get the gradients of the dense reference at
    the f32 gradient bar (1e-4)."""
    from torchsnapshot_tpu_torch.ops.attention import dense_attention

    _, (q, k, v) = _inputs((2, 64, 2, 16), seed=6)
    q.requires_grad_(True)
    (g_flash,) = torch.autograd.grad(fa.flash_attention(q, k, v).square().sum(), q)
    (g_dense,) = torch.autograd.grad(dense_attention(q, k, v).square().sum(), q)
    np.testing.assert_allclose(_np(g_flash), _np(g_dense), atol=1e-4)


def test_cpu_tensors_never_count_a_launch() -> None:
    _, (q, k, v) = _inputs((2, 64, 2, 16), seed=7)
    before = fa.flash_fwd.launches
    fa.flash_attention(q, k, v)
    fa.flash_fwd(*(t.transpose(1, 2).reshape(4, 64, 16) for t in (q, k, v)))
    assert fa.flash_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors() -> None:
    _, (q, k, v) = _inputs((4, 64, 64), seed=8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, k, v)


def test_alignment_check_names_the_tma_alignment() -> None:
    """The bf16 forward kernel loads through TMA, which reads only from
    16-byte-aligned addresses: a contiguous view two bytes into its storage
    is refused by name, a fresh tensor passes."""
    storage = torch.zeros(4 * 64 * 64 + 8, dtype=torch.bfloat16)
    aligned = storage[:-8].view(4, 64, 64)
    shifted = storage[1 : 1 + 4 * 64 * 64].view(4, 64, 64)
    assert shifted.is_contiguous()
    fa._check_aligned("flash_fwd", ("q", aligned))
    with pytest.raises(ValueError, match=r"aligned to 16 bytes \(TMA\); k starts at data_ptr\(\) % 16 = 2"):
        fa._check_aligned("flash_fwd", ("q", aligned), ("k", shifted))
