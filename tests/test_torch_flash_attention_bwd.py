"""The port's flash-attention backward and plain attention ops on the CPU
against the JAX package's.

On CPU tensors the port computes its kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas_attention.py
does. Bars are that file's: 1e-5 for the f32 raw functions and blockwise
attention, 1e-4 for f32 gradients through the wrapper, 3e-2 for the bf16
raw functions (one bf16 step at |x| ~ 4-8) and 0.1 for bf16 gradients. The
kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py; the bf16 ones through
``flash_bwd_emul``, whose CPU test is here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.ops import attention as jax_attention
from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts
from torchsnapshot_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from torchsnapshot_tpu_torch.ops import attention as port_attention
from torchsnapshot_tpu_torch.ops import flash_attention as fa
from test_torch_kernels_cuda import flash_bwd_emul
from torch_test_env import autotune_never  # noqa: F401 - autouse

RAW_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_ATOL = {"float32": 1e-4, "bfloat16": 0.1}


def _arrays(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_raw_backward_matches_jax_bwd_impl(causal: bool, dtype: str) -> None:
    arrays = _arrays((4, 64, 16), seed=0, n=4)
    jq, jk, jv, jg = (jnp.asarray(a).astype(dtype) for a in arrays)
    fwd_impl, bwd_impl = _make_flash_parts(causal, None, 16, 32, True)
    jo, jlse = fwd_impl(jq, jk, jv)
    jdelta = jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1, keepdims=True)
    want = bwd_impl(jq, jk, jv, jg, jlse, jdelta)

    q, k, v, g = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    delta = torch.from_numpy(np.asarray(jdelta)[..., 0].copy())
    got = fa.flash_bwd(q, k, v, g, lse, delta, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == q.dtype and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=RAW_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(16, 16), (16, 32), (32, 16)])
def test_flash_gradients_match_jax_grad(causal: bool, blocks) -> None:
    # The block pairs of test_pallas_attention.py::test_flash_gradients_match_dense.
    bq, bk = blocks
    arrays = _arrays((2, 64, 2, 16), seed=1, n=3)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    out = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL["float32"], rtol=0)


def test_flash_gradients_bf16_match_jax_grad() -> None:
    arrays = _arrays((2, 64, 2, 16), seed=2, n=3)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, block_q=16, block_k=16)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    )
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in arrays)
    out = fa.flash_attention(q, k, v, block_q=16, block_k=16)
    got = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL["bfloat16"], rtol=0)


def test_raw_split_over_key_halves_matches_the_whole() -> None:
    """One ring hop: q against half the keys, with lse and delta over all
    of them. dq sums over the halves; each half's dk and dv are the
    matching slices of the whole; the JAX raw backward agrees per half."""
    S = 32
    qa, ga = _arrays((4, S, 16), seed=3, n=2)
    ka, va = _arrays((4, 2 * S, 16), seed=4, n=2)
    q, g = torch.from_numpy(qa), torch.from_numpy(ga)
    k, v = (torch.from_numpy(a).requires_grad_(True) for a in (ka, va))
    qg = q.clone().requires_grad_(True)
    scale = 16**-0.5
    s = scale * qg @ k.transpose(1, 2)
    o = torch.softmax(s, dim=-1) @ v
    dq, dk, dv = torch.autograd.grad(o, (qg, k, v), g)
    lse = torch.logsumexp(s, dim=-1).detach()
    delta = (g * o).sum(-1).detach()

    _, bwd_impl = _make_flash_parts(False, None, 16, 16, True)
    halves = []
    for h in (slice(0, S), slice(S, 2 * S)):
        kh, vh = k[:, h].detach().contiguous(), v[:, h].detach().contiguous()
        got = fa.flash_bwd(q, kh, vh, g, lse, delta, causal=False)
        want = bwd_impl(*(jnp.asarray(t.numpy()) for t in (q, kh, vh, g)),
                        jnp.asarray(lse.numpy())[..., None], jnp.asarray(delta.numpy())[..., None])
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), atol=RAW_ATOL["float32"], rtol=0)
        halves.append(got)
    np.testing.assert_allclose(_np(halves[0][0] + halves[1][0]), _np(dq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(torch.cat([halves[0][1], halves[1][1]], 1)), _np(dk), atol=1e-5)
    np.testing.assert_allclose(_np(torch.cat([halves[0][2], halves[1][2]], 1)), _np(dv), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_blockwise_attention_matches_jax(causal: bool, block: int) -> None:
    arrays = _arrays((2, 64, 2, 16), seed=5, n=3)
    want = jax_attention.blockwise_attention(
        *(jnp.asarray(a) for a in arrays), block_size=block, causal=causal
    )
    got = port_attention.blockwise_attention(
        *(torch.from_numpy(a) for a in arrays), block_size=block, causal=causal
    )
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_blockwise_attention_refuses_an_indivisible_block() -> None:
    q = torch.zeros((1, 48, 1, 16))
    with pytest.raises(ValueError, match="divisible"):
        port_attention.blockwise_attention(q, q, q, block_size=32)


@pytest.mark.parametrize("offsets", [(0, 0), (32, 0), (0, 16), (8, 40)])
def test_dense_attention_with_offsets_matches_jax(offsets) -> None:
    # (0, 16) and (8, 40) leave query rows with no valid key: they attend to
    # nothing (zeros), not uniformly to every key.
    q_off, k_off = offsets
    arrays = _arrays((2, 32, 2, 16), seed=6, n=3)
    want = jax_attention.dense_attention(
        *(jnp.asarray(a) for a in arrays), causal=True, q_offset=q_off, k_offset=k_off
    )
    got = port_attention.dense_attention(
        *(torch.from_numpy(a) for a in arrays), causal=True, q_offset=q_off, k_offset=k_off
    )
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    if k_off > q_off:
        assert not got[:, : k_off - q_off].any()


def test_attention_block_update_matches_jax() -> None:
    """Two updates of one accumulator, the second block partly masked, at
    global positions past 0."""
    qa, ka, va = _arrays((2, 16, 2, 16), seed=7, n=3)
    k2a, v2a = _arrays((2, 16, 2, 16), seed=8, n=2)
    scale = 0.25
    q_pos = np.arange(16, 32)
    jacc = (jnp.zeros((2, 16, 2, 16)), jnp.full((2, 2, 16), -1e30), jnp.zeros((2, 2, 16)))
    pacc = (torch.zeros((2, 16, 2, 16)), torch.full((2, 2, 16), -1e30), torch.zeros((2, 2, 16)))
    for k_pos, kk, vv in ((np.arange(0, 16), ka, va), (np.arange(16, 32), k2a, v2a)):
        jacc = jax_attention.attention_block_update(
            jnp.asarray(qa), jnp.asarray(kk), jnp.asarray(vv),
            jnp.asarray(q_pos), jnp.asarray(k_pos), scale, True, jacc,
        )
        pacc = port_attention.attention_block_update(
            torch.from_numpy(qa), torch.from_numpy(kk), torch.from_numpy(vv),
            torch.from_numpy(q_pos), torch.from_numpy(k_pos), scale, True, pacc,
        )
    for a, b in zip(pacc, jacc):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(port_attention._finalize(pacc, torch.float32)),
        _np(jax_attention._finalize(jacc, jnp.float32)), atol=1e-6, rtol=0,
    )


def test_cpu_backward_never_counts_a_launch() -> None:
    arrays = _arrays((1, 64, 2, 16), seed=9, n=3)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    fa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


def test_backward_kernel_wrappers_refuse_cpu_tensors() -> None:
    q, k, v, g = (torch.from_numpy(a) for a in _arrays((2, 64, 64), seed=10, n=4))
    lse = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq(q, k, v, g, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(q, k, v, g, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_cuda(q, k, v, g, lse, lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(3, 100, 64), (2, 64, 128)])
def test_flash_bwd_emul_is_the_plain_version_up_to_its_rounding(shape, causal) -> None:
    """The recompute that holds the bf16 backward kernels: with P and dS
    left in f32 it equals the plain version bit for bit; rounding them to
    bf16 moves the gradients, by no more than the JAX bf16 gradient bar."""
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(shape, seed=11, n=4))
    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (g.float() * o.float()).sum(-1)
    plain = fa.flash_bwd_reference(q, k, v, g, lse, delta, causal=causal)
    exact = flash_bwd_emul(q, k, v, g, lse, delta, causal=causal, round_to=torch.float32)
    rounded = flash_bwd_emul(q, k, v, g, lse, delta, causal=causal)
    for p, e, r in zip(plain, exact, rounded):
        assert e.dtype == r.dtype == p.dtype == torch.bfloat16
        assert torch.equal(e, p)
        err = (r.float() - p.float()).abs().max().item()
        assert 0 < err <= GRAD_ATOL["bfloat16"]


@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_bf16_backward_alignment_check_names_the_tma_alignment(kernel, monkeypatch) -> None:
    """The backward kernels load q, k, v and dO through TMA, which reads
    only from 16-byte-aligned addresses (the bf16 kernels, and since the f32
    ones run on the tensor cores, those too): the wrapper refuses a
    contiguous dO view one element into its storage, naming the kernel and
    the alignment. Aligned operands pass its checks. The device check is
    stubbed: these are CPU tensors."""
    monkeypatch.setattr(fa, "_check_kernel_args", lambda *args: None)
    lse = torch.zeros((2, 64))
    for dtype in (torch.bfloat16, torch.float32):
        storage = torch.zeros(2 * 64 * 64 + 8, dtype=dtype)
        aligned = storage[:-8].view(2, 64, 64)
        shifted = storage[1 : 1 + 2 * 64 * 64].view(2, 64, 64)
        assert shifted.is_contiguous()
        with pytest.raises(
            ValueError,
            match=rf"{kernel} kernel takes operands aligned to 16 bytes \(TMA\); "
            rf"dO starts at data_ptr\(\) % 16 = {shifted.element_size()}",
        ):
            getattr(fa, kernel)(aligned, aligned, aligned, shifted, lse, lse)
        assert fa._bwd_args(kernel, aligned, aligned, aligned, aligned, lse, lse, None) == 0.125
