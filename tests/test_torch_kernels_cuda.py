"""The port's CUDA kernels held against their plain versions on the card.

These tests need an NVIDIA GPU with ``nvcc``; elsewhere they skip. They
import torch only, so on a machine without JAX run them without the
suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# Bars of tests/test_pallas_attention.py: 1e-5 for f32, 3e-2 for bf16
# (forward); 1e-4 for f32 (gradients). The f32 backward kernels do the plain
# version's f32 arithmetic and differ only in summation order.
ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
F32_GRAD_TOL = dict(atol=1e-4, rtol=0)

# The bf16 backward kernels run on the tensor cores and round P and dS to
# bf16 to be the A operands of their last products (dV = P^T dO,
# dK = scale dS^T Q, dQ = scale dS K); the plain version keeps them in f32.
# flash_bwd_emul is the plain version with that rounding. Each bf16 gradient
# may differ from the plain one by at most twice what the rounding alone
# moves it (the kernel also sums in another order and rounds its own f32
# results to bf16), plus 1e-5 for entries near zero; the bf16 gradient bar
# of tests/test_pallas_attention.py, 0.1, stays a ceiling on top.
BF16_GRAD_SLACK = 1e-5
BF16_GRAD_CEILING = 0.1


def flash_bwd_emul(q, k, v, dO, lse, delta, *, causal=True, scale=None, round_to=torch.bfloat16):
    """A plain recompute of ``(dq, dk, dv)`` that rounds P and dS to
    ``round_to`` before the three products that take them, as the bf16
    tensor-core kernels do. With ``round_to=torch.float32`` it is the plain
    version, operation for operation."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    s = scale * torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, fa.NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dO.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    p, ds = p.to(round_to).float(), ds.to(round_to).float()
    dq = scale * torch.matmul(ds, k.float())
    dk = scale * torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), dO.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_grad_errors(got, plain, emul):
    """For each gradient: (max|got - plain|, its bar), the bar being
    ``2 * max|emul - plain| + BF16_GRAD_SLACK`` capped at the ceiling."""
    out = []
    for g, p, e in zip(got, plain, emul):
        rounding = (e.float() - p.float()).abs().max().item()
        bar = min(2 * rounding + BF16_GRAD_SLACK, BF16_GRAD_CEILING)
        out.append(((g.float() - p.float()).abs().max().item(), bar))
    return out


def _assert_bf16_grads_close(got, q, k, v, dO, lse, delta, causal) -> None:
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
    emul = flash_bwd_emul(q, k, v, dO, lse, delta, causal=causal)
    for name, g, (err, bar) in zip(("dq", "dk", "dv"), got, bf16_grad_errors(got, plain, emul)):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert err <= bar, f"{name}: max|kernel - plain| = {err:.3g} > bar {bar:.3g}"


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        for _ in range(n)
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 256, 64), (4, 192, 128), (3, 100, 64)])
def test_flash_fwd_kernel_matches_plain(card, causal, dtype, shape) -> None:
    q, k, v = _qkv(shape, dtype, card)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    assert o.dtype == dtype and lse.shape == shape[:2]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=ATOL[dtype], rtol=0)


# The bf16 forward kernel runs on the tensor cores: scores are f32 sums of
# exact bf16 products, so its lse is held at 1e-4 (summation order, the
# scale applied after the dot, exp2 against exp); it rounds P to bf16 for
# the second product, so o keeps the JAX tests' bf16 bar of 3e-2.
BF16_LSE_ATOL = 1e-4


@pytest.mark.parametrize("BH", [1, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 16, 100, 200, 256, 512])
def test_flash_fwd_bf16_kernel_matches_plain(card, S, D, causal, BH) -> None:
    q, k, v = _qkv((BH, S, D), torch.bfloat16, card, seed=S + D + BH)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.shape == (BH, S)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=BF16_LSE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_is_deterministic(card, dtype) -> None:
    q, k, v = _qkv((32, 256, 64), dtype, card, seed=3)
    first, second = fa.flash_fwd(q, k, v), fa.flash_fwd(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_fwd_kernel_refuses_misaligned_bf16(card) -> None:
    storage = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    q = storage[1:].view(2, 64, 64)  # contiguous, 2 bytes past a 16-byte boundary
    k, v = _qkv((2, 64, 64), torch.bfloat16, card, n=2)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa.flash_fwd(q, k, v)


def test_flash_fwd_kernel_refuses_unsupported(card) -> None:
    q, k, v = _qkv((2, 64, 32), torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, v)
    q, k, v = _qkv((2, 64, 64), torch.float16, card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 256, 64), (4, 192, 128), (3, 100, 64)])
def test_flash_bwd_kernels_match_plain(card, causal, dtype, shape) -> None:
    q, k, v, dO = _qkv(shape, dtype, card, seed=1, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO.float() * o.float()).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, dO, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    if dtype == torch.bfloat16:
        _assert_bf16_grads_close(got, q, k, v, dO, lse, delta, causal)
        return
    want = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == shape
        torch.testing.assert_close(g.float(), w.float(), **F32_GRAD_TOL)


@pytest.mark.parametrize("BH", [1, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 16, 100, 200, 256, 512])
def test_flash_bwd_bf16_kernels_match_plain(card, S, D, causal, BH) -> None:
    """The wgmma backward kernels over the sequence lengths their 64-row
    tiles must handle (one row, part of a tile, ragged, whole tiles), under
    the bf16 gradient bar above."""
    q, k, v, dO = _qkv((BH, S, D), torch.bfloat16, card, seed=S + D + BH, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO.float() * o.float()).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, dO, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    _assert_bf16_grads_close(got, q, k, v, dO, lse, delta, causal)


def test_flash_bwd_kernels_are_deterministic(card) -> None:
    q, k, v, dO = _qkv((32, 256, 64), torch.bfloat16, card, seed=2, n=4)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (dO.float() * o.float()).sum(-1)
    first = fa.flash_bwd(q, k, v, dO, lse, delta)
    second = fa.flash_bwd(q, k, v, dO, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_bwd_kernel_refuses_misaligned_bf16(card) -> None:
    storage = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    dO = storage[1:].view(2, 64, 64)  # contiguous, 2 bytes past a 16-byte boundary
    q, k, v = _qkv((2, 64, 64), torch.bfloat16, card)
    lse = torch.zeros((2, 64), device=card)
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        with pytest.raises(ValueError, match=f"{kernel} kernel takes operands aligned to 16 bytes"):
            getattr(fa, kernel)(q, k, v, dO, lse, lse)


def test_flash_bwd_kernel_refuses_unsupported(card) -> None:
    q, k, v, dO = _qkv((2, 64, 64), torch.float32, card, n=4)
    lse = torch.zeros((2, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_bwd(q, k, v, dO.transpose(1, 2).contiguous().transpose(1, 2), lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd(q, k, v, dO, lse[:, :32], lse)


# ------------------------------------------------------------------ K4

# Every dtype the train state holds (f32, int32) plus the word-stream cases:
# 1- and 2-byte elements zero-extended, 8-byte elements as two words. The
# digest strings must be identical: the kernel does the plain version's
# integer arithmetic, and wrapping sums do not depend on their order.
DIGEST_DTYPES = [
    torch.float32, torch.int32, torch.bfloat16, torch.float16, torch.int64, torch.float64,
    torch.uint8, torch.int8, torch.bool, torch.float8_e4m3fn, torch.float8_e5m2,
]


def _digest_input(dtype, nbytes, seed, device):
    rng = np.random.default_rng(seed)
    raw = torch.from_numpy(rng.integers(0, 256, size=max(nbytes, 8), dtype=np.uint8))[:nbytes]
    if dtype == torch.bool:
        t = (raw % 2).bool()
    else:
        t = raw[: nbytes // dtype.itemsize * dtype.itemsize].view(dtype)
    return t.to(device)


@pytest.mark.parametrize("nbytes", [0, 1, 3, 4097, 1 << 20])
@pytest.mark.parametrize("dtype", DIGEST_DTYPES, ids=str)
def test_digest_kernel_matches_plain(card, dtype, nbytes) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd

    t = _digest_input(dtype, nbytes, seed=nbytes, device=card)
    before = dd.fingerprint_lanes.launches
    got = dd.device_fingerprint(t)
    assert dd.fingerprint_lanes.launches == before + 1
    assert got == dd.device_fingerprint(t.cpu())
    # Unaligned start: the word-by-word path.
    if t.numel() > 1:
        assert dd.device_fingerprint(t[1:]) == dd.device_fingerprint(t[1:].cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.int64, torch.bool], ids=str)
def test_digest_kernel_partial_lanes_add_up(card, dtype) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd

    piece = _digest_input(dtype, 6 * 10 * 7 * 8, seed=3, device=card)[: 6 * 10 * 7].reshape(6, 10, 7)
    full = dd.device_fingerprint(piece)
    groups = []
    for r0, r1 in ((0, 2), (2, 6)):
        for c0, c1 in ((0, 3), (3, 10)):
            region = piece[r0:r1, c0:c1]
            lanes = dd.partial_fetch(dd.partial_dispatch(region, piece.shape, (r0, c0, 0)))
            assert lanes == dd.lanes_reference(region.cpu(), (r0, c0, 0), piece.shape)
            groups.append(lanes)
    assert dd.combine_partials(groups, piece.numel() * piece.element_size()) == full


def test_digest_kernel_is_deterministic(card) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd

    t = _digest_input(torch.float32, 1 << 24, seed=5, device=card)
    first, second = dd.fingerprint_lanes(t), dd.fingerprint_lanes(t)
    assert torch.equal(first, second)


def test_digest_kernel_refuses_unsupported(card) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd

    with pytest.raises(TypeError, match="word stream"):
        dd.fingerprint_lanes(torch.zeros(4, dtype=torch.complex64, device=card))
    assert dd.device_fingerprint(torch.zeros(4, dtype=torch.complex64, device=card)) is None
