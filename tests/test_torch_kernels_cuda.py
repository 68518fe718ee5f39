"""The port's CUDA kernels held against their plain versions on the card.

These tests need an NVIDIA GPU with ``nvcc``; elsewhere they skip. They
import torch only, so on a machine without JAX run them without the
from torch_test_env import autotune_never  # noqa: F401 - autouse
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
# (forward); 1e-4 for f32 (gradients). The f32 kernels, forward and
# backward, run each product as the three TF32 products of the split, which
# keeps about 21 of f32's 24 bits (the emulations are held to the JAX
# package's f32 flash at these bars in test_torch_flash_tf32.py).
ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}
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

# Head dims of the sweeps: the three tile widths the kernels are built for
# (64, 128, 256), and head dims under them that run at those widths with
# zeros in the columns past d (fa.kernel_width): the narrowest row TMA
# takes (16 bytes: bf16 8, f32 4), the dryrun's 16 and 32, 48 and 96; at
# width 256 the least head dim it takes (bf16 136, f32 132), 192 and bf16
# 200.
BF16_HEAD_DIMS = [8, 16, 32, 48, 64, 96, 128, 136, 192, 200, 256]
F32_HEAD_DIMS = [4, 16, 32, 48, 64, 96, 128, 132, 192, 256]
HEAD_DIM_CASES = ([(torch.float32, d) for d in F32_HEAD_DIMS]
                  + [(torch.bfloat16, d) for d in BF16_HEAD_DIMS])


def flash_bwd_emul(q, k, v, dO, lse, delta, *, causal=True, scale=None, round_to=None):
    """A plain recompute of ``(dq, dk, dv)`` that rounds P and dS to
    ``round_to`` (by default q's dtype where it is bf16 or f16, else bf16)
    before the three products that take them, as the 16-bit tensor-core
    kernels do; for f16 it rounds scale dS, as those kernels fold the scale
    in before the rounding. With ``round_to=torch.float32`` it is the plain
    version, operation for operation."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    if round_to is None:
        round_to = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.bfloat16
    s = scale * torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, fa.NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dO.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    fold = round_to == torch.float16
    p = p.to(round_to).float()
    ds = (scale * ds).to(round_to).float() if fold else ds.to(round_to).float()
    ds_scale = 1.0 if fold else scale
    dq = ds_scale * torch.matmul(ds, k.float())
    dk = ds_scale * torch.matmul(ds.transpose(1, 2), q.float())
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
    """The 16-bit gradient bar (bf16 or f16, q's dtype)."""
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
    emul = flash_bwd_emul(q, k, v, dO, lse, delta, causal=causal)
    for name, g, (err, bar) in zip(("dq", "dk", "dv"), got, bf16_grad_errors(got, plain, emul)):
        assert g.dtype == q.dtype and g.shape == q.shape
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
@pytest.mark.parametrize("D", BF16_HEAD_DIMS)
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


@pytest.mark.parametrize("dtype,D", HEAD_DIM_CASES)
def test_flash_fwd_kernel_is_deterministic(card, dtype, D) -> None:
    q, k, v = _qkv((32, 256, D), dtype, card, seed=3)
    first, second = fa.flash_fwd(q, k, v), fa.flash_fwd(q, k, v)
    assert first[0].shape == (32, 256, D)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_fwd_kernel_refuses_misaligned_bf16(card) -> None:
    storage = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    q = storage[1:].view(2, 64, 64)  # contiguous, 2 bytes past a 16-byte boundary
    k, v = _qkv((2, 64, 64), torch.bfloat16, card, n=2)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa.flash_fwd(q, k, v)


def test_flash_fwd_kernel_refuses_misaligned_f32(card) -> None:
    """The f32 forward loads q, k and v through TMA since it runs on the
    tensor cores: a contiguous view one f32 past a 16-byte boundary is
    refused by name, whichever operand it is."""
    storage = torch.zeros(2 * 64 * 64 + 1, dtype=torch.float32, device=card)
    shifted = storage[1:].view(2, 64, 64)  # contiguous, 4 bytes past a 16-byte boundary
    q, k, v = _qkv((2, 64, 64), torch.float32, card)
    for args, name in (((shifted, k, v), "q"), ((q, shifted, v), "k"), ((q, k, shifted), "v")):
        with pytest.raises(ValueError, match=f"aligned to 16 bytes \\(TMA\\); {name} starts"):
            fa.flash_fwd(*args)


def test_flash_fwd_f32_kernel_takes_aligned_row_views(card) -> None:
    """What the rings hand the forward: the zigzag halves of one head are
    contiguous views at a row offset, which keeps them 16-byte aligned (a
    row is D * 4 bytes). The kernel reads them in place and gives what it
    gives on copies, bit for bit."""
    q, k, v = _qkv((1, 256, 64), torch.float32, card, seed=4)
    halves = [t[:, 128:] for t in (q, k, v)]
    assert all(h.is_contiguous() and h.data_ptr() % 16 == 0 and h.storage_offset() for h in halves)
    got = fa.flash_fwd(*halves, causal=True)
    want = fa.flash_fwd(*(h.clone() for h in halves), causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# fa.kernel_width's message: the rule by name.
WIDTH_RULE = r"flash kernels take every head_dim d >= 1, got d = 0"


def test_flash_fwd_kernel_refuses_unsupported(card) -> None:
    """The new rule: d = 32, 136 and 256 run and match the plain version;
    bf16 d = 12 (a 24-byte row, run padded to 16), 264 and 272 (the deep
    form), which the kernels refused before, run and match it too, one
    launch each; float16 runs; d = 0 raises ValueError naming the rule and
    float64 TypeError naming the dtypes the kernels take, with no launch
    and no fallback."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (32, 136, 256):
            q, k, v = _qkv((2, 64, D), dtype, card)
            o, lse = fa.flash_fwd(q, k, v)
            o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
            torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[dtype], rtol=0)
    for D in (12, 264, 272):
        q, k, v = _qkv((2, 64, D), torch.bfloat16, card)
        before = fa.flash_fwd.launches
        o, lse = fa.flash_fwd(q, k, v)
        assert fa.flash_fwd.launches == before + 1 and o.shape == q.shape
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[torch.bfloat16], rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=BF16_LSE_ATOL, rtol=0)
    before = fa.flash_fwd.launches
    q, k, v = _qkv((2, 64, 0), torch.bfloat16, card)
    with pytest.raises(ValueError, match=WIDTH_RULE):
        fa.flash_fwd(q, k, v)
    q, k, v = _qkv((2, 64, 64), torch.float64, card)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa.flash_fwd(q, k, v)
    assert fa.flash_fwd.launches == before


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 12), (torch.float32, 6),
                                     (torch.bfloat16, 264), (torch.float32, 260),
                                     (torch.bfloat16, 272)])
def test_flash_bwd_kernels_refuse_head_dims_they_do_not_take(card, dtype, D) -> None:
    """The new rule: head dims the backward kernels refused before (a row
    that is not a multiple of 16 bytes, d > 256) run, one launch each, and
    match the plain version; d = 0 is refused by name."""
    q, k, v, dO = _qkv((2, 64, D), dtype, card, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v)
    delta = (dO.float() * o.float()).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = (fa.flash_bwd_dq(q, k, v, dO, lse, delta), *fa.flash_bwd_dkv(q, k, v, dO, lse, delta))
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    if dtype == torch.float32:
        for g, w in zip(got, fa.flash_bwd_reference(q, k, v, dO, lse, delta)):
            assert g.shape == q.shape
            torch.testing.assert_close(g, w, **F32_GRAD_TOL)
    else:
        _assert_bf16_grads_close(got, q, k, v, dO, lse, delta, True)
    empty = torch.zeros((2, 64, 0), dtype=dtype, device=card)
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        with pytest.raises(ValueError, match=WIDTH_RULE):
            getattr(fa, kernel)(empty, empty, empty, empty, lse, delta)


def test_wide_configuration_forward_runs_the_kernels(card, monkeypatch) -> None:
    """The JAX package's benchmarks/async_stall.py configuration at 2,500 MB
    (d_model 2048, 8 heads of 256, 4 layers, tokens (8, 128), bf16): its
    forward makes one flash_fwd launch a layer and never calls dense
    attention, and its logits are finite."""
    from torchsnapshot_tpu_torch.models import transformer as T

    def no_dense(*args, **kwargs):
        raise AssertionError("dense attention called on the card")

    monkeypatch.setattr(T, "dense_attention", no_dense)
    cfg = T.TransformerConfig(vocab_size=4096, d_model=2048, n_heads=8, n_layers=4, d_ff=8192,
                              max_seq_len=128)
    assert cfg.head_dim == 256
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), device=card)
    before = fa.flash_fwd.launches
    with torch.inference_mode():
        logits = T.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + cfg.n_layers
    assert logits.shape == (8, 128, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all())


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
@pytest.mark.parametrize("D", BF16_HEAD_DIMS)
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


# The wide bf16 kernels (tile width 256: flash_fwd_wgmma_wide_kernel and
# flash_bwd_dkv_wgmma_wide_kernel) against the emulations of their
# arithmetic (fa.flash_fwd_bf16_wide_emulated, fa.flash_bwd_bf16_wide_emulated:
# the kernels' tiles and order, P and dS rounded to bf16 at their places). What is left between the two is the order of the
# sums inside wgmma, exp2 against exp, and the bf16 rounding of the outputs
# and of P and dS, which can fall one bf16 ulp apart where their f32 values
# differ in the last bits: so each output within one bf16 ulp of its value
# (2**-7 relative) plus 5e-3 for such flips on entries near zero, and lse
# within the bf16 lse bar.
BF16_WIDE_EMUL_TOL = dict(atol=5e-3, rtol=2**-7)


@pytest.mark.parametrize("BH", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [136, 192, 256])
@pytest.mark.parametrize("S", [1, 16, 100, 200, 256, 512])
def test_flash_bf16_wide_kernels_at_tile_edges(card, S, D, causal, BH) -> None:
    """The wide bf16 K1 and K3 at the edges of their 64-row tiles: o, lse,
    dk and dv against dense attention (the plain versions, at the bars
    above) and against the emulations of the kernels' arithmetic, and a
    second launch of each giving the same bits."""
    q, k, v, dO = _qkv((BH, S, D), torch.bfloat16, card, seed=S + D + BH + 7, n=4)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO.float() * o_ref.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dO, lse_ref, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=BF16_LSE_ATOL, rtol=0)
    plain = fa.flash_bwd_reference(q, k, v, dO, lse_ref, delta, causal=causal)[1:]
    emul = fa.flash_bwd_bf16_wide_emulated(q, k, v, dO, lse_ref, delta, causal=causal)[1:]
    for name, g, (err, bar) in zip(("dk", "dv"), (dk, dv), bf16_grad_errors((dk, dv), plain, emul)):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert err <= bar, f"{name}: max|kernel - plain| = {err:.3g} > bar {bar:.3g}"
    o_em, lse_em = fa.flash_fwd_bf16_wide_emulated(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), o_em.float(), **BF16_WIDE_EMUL_TOL)
    torch.testing.assert_close(lse, lse_em, atol=BF16_LSE_ATOL, rtol=0)
    for g, e in zip((dk, dv), emul):
        torch.testing.assert_close(g.float(), e.float(), **BF16_WIDE_EMUL_TOL)
    o2, lse2 = fa.flash_fwd(q, k, v, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dO, lse_ref, delta, causal=causal)
    assert all(torch.equal(a, b) for a, b in ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2)))


# The f32 kernels against the emulations of their arithmetic
# (fa.flash_fwd_tf32_emulated, fa.flash_bwd_tf32_emulated: the same split,
# products exact in f32): the two differ in the order and the rounding of
# their f32 sums (and exp2 against exp). Two round-to-nearest orders of these sums differ by up to
# 4e-6 at S = 512 on the CPU; wgmma's adds inside a tile do not round to
# nearest, and the kernels read up to 8.6e-6 from the emulation at S = 512,
# D = 128, causal, on the card. The bar, 2e-5, is a fifth of the 1e-4 bar
# against the plain version; one TF32 product instead of three misses it by
# 50-100x.
F32_EMUL_TOL = dict(atol=2e-5, rtol=0)


@pytest.mark.parametrize("BH", [1, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", F32_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 16, 100, 200, 256, 512])
def test_flash_fwd_f32_kernel_matches_plain_and_emulation(card, S, D, causal, BH) -> None:
    """The 3xTF32 forward kernel over the sequence lengths its tiles must
    handle: o and lse within 1e-5 of the plain version, and within the
    summation order's bar of the emulation of its arithmetic (the same
    key tiles, online softmax and per-tile sums)."""
    q, k, v = _qkv((BH, S, D), torch.float32, card, seed=S + D + BH)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == (BH, S, D) and lse.shape == (BH, S)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_ref, atol=ATOL[torch.float32], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=ATOL[torch.float32], rtol=0)
    o_em, lse_em = fa.flash_fwd_tf32_emulated(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_em, **F32_EMUL_TOL)
    torch.testing.assert_close(lse, lse_em, **F32_EMUL_TOL)


# The wide f32 forward kernel (tile width 256) streams 64-key tiles
# (fa.fwd_tf32_rows) and v in halves of 32 keys: lengths one below and one
# above multiples of 32 and of 64, and 1.
WIDE_FWD_LENGTHS = [1, 31, 33, 63, 65, 95, 97, 127, 129]


@pytest.mark.parametrize("BH", [1, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [132, 192, 256])
@pytest.mark.parametrize("S", WIDE_FWD_LENGTHS)
def test_flash_fwd_f32_wide_kernel_at_tile_edges(card, S, D, causal, BH) -> None:
    """The wide 3xTF32 forward kernel at the edges of its key tiles: o and
    lse within 1e-5 of the plain version and within the summation order's
    bar of the emulation of its arithmetic (chunked score sums, P V by
    halves of a tile)."""
    assert fa.fwd_tf32_rows(D) == 64
    q, k, v = _qkv((BH, S, D), torch.float32, card, seed=S + D + BH)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    assert o.shape == (BH, S, D) and lse.shape == (BH, S)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_ref, atol=ATOL[torch.float32], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=ATOL[torch.float32], rtol=0)
    o_em, lse_em = fa.flash_fwd_tf32_emulated(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_em, **F32_EMUL_TOL)
    torch.testing.assert_close(lse, lse_em, **F32_EMUL_TOL)


def _dense_fwd_f64(q, k, v, causal):
    """o of ``softmax(q k^T / sqrt(d)) v`` in float64."""
    q, k, v = (t.double() for t in (q, k, v))
    s = (q * q.shape[2] ** -0.5) @ k.transpose(1, 2)
    if causal:
        mask = torch.ones(s.shape[1:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("D", [256, 320, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_f32_wide_kernel_sums_each_chunk_fresh(card, causal, D) -> None:
    """At S 512 and d 256, o from the wide kernel is no further from a
    float64 dense forward than twice the plain f32 version's distance: each
    32-column chunk of a score product sums fresh and is added in f32, and
    so does each half tile's P V (one chain of large terms over d = 256
    failed the backward's bar of this kind). The deep f32 kernel (d 320 and
    512) sums the same way and is held to the same bar."""
    q, k, v = _qkv((4, 512, D), torch.float32, card, seed=12)
    o, _ = fa.flash_fwd(q, k, v, causal=causal)
    plain, _ = fa.flash_fwd_reference(q, k, v, causal=causal)
    want = _dense_fwd_f64(q, k, v, causal)
    err = (o.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    assert err <= 2 * plain_err, f"o: {err:.3g} from f64, plain f32 {plain_err:.3g}"


@pytest.mark.parametrize("BH", [1, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", F32_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 16, 100, 200, 256, 512])
def test_flash_bwd_f32_kernels_match_plain_and_emulation(card, S, D, causal, BH) -> None:
    """The 3xTF32 backward kernels over the sequence lengths their tiles
    must handle: within 1e-4 of the plain version, and within the summation
    order's bar of the emulated split."""
    _check_f32_bwd(card, S, D, causal, BH)


# The wide f32 backward kernels (tile width 256) stream 64 key rows a dq
# tile and 32 q rows a dk/dv tile (fa.bwd_tf32_rows): lengths one below and
# one above multiples of those and of 64, and 1.
WIDE_BWD_LENGTHS = [1, 31, 33, 63, 65, 95, 97, 127, 129]


@pytest.mark.parametrize("BH", [1, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [132, 192, 256])
@pytest.mark.parametrize("S", WIDE_BWD_LENGTHS)
def test_flash_bwd_f32_wide_kernels_at_tile_edges(card, S, D, causal, BH) -> None:
    """The wide 3xTF32 backward kernels at the edges of their streamed
    tiles, at the bars of the test above."""
    assert fa.bwd_tf32_rows(D) == (64, 32)
    _check_f32_bwd(card, S, D, causal, BH)


def _dense_bwd_f64(q, k, v, dO, causal):
    """(dq, dk, dv) of ``sum(softmax(q k^T / sqrt(d)) v * dO)`` in float64,
    from float64 statistics."""
    q, k, v, dO = (t.double() for t in (q, k, v, dO))
    scale = q.shape[2] ** -0.5
    s = scale * q @ k.transpose(1, 2)
    if causal:
        mask = torch.ones(s.shape[1:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    delta = (dO * (p @ v)).sum(-1, keepdim=True)
    ds = p * (dO @ v.transpose(1, 2) - delta)
    return scale * ds @ k, scale * ds.transpose(1, 2) @ q, p.transpose(1, 2) @ dO


@pytest.mark.parametrize("D", [256, 320, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_f32_wide_kernels_sum_each_tile_fresh(card, causal, D) -> None:
    """At S 512 and d 256, dq, dk and dv from the wide kernels are no
    further from a float64 dense backward than twice the plain f32
    version's distance: each tile's product sums in a fresh accumulator,
    added in f32 (one accumulator over every tile once left dk and dv 4-7x
    further out than the plain version). Past 256 (d 320 and 512) the deep
    f32 dq and dk/dv kernels sum each chunk's and each item's products the
    same way and are held to the same bar."""
    q, k, v, dO = _qkv((4, 512, D), torch.float32, card, seed=11, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO * o).sum(-1)
    got = fa.flash_bwd(q, k, v, dO, lse, delta, causal=causal)
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
    want = _dense_bwd_f64(q, k, v, dO, causal)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        err = (g.double() - w).abs().max().item()
        plain_err = (p.double() - w).abs().max().item()
        assert err <= 2 * plain_err, f"{name}: {err:.3g} from f64, plain f32 {plain_err:.3g}"


def _check_f32_bwd(card, S, D, causal, BH) -> None:
    q, k, v, dO = _qkv((BH, S, D), torch.float32, card, seed=S + D + BH, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO.float() * o.float()).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, dO, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
    emul = fa.flash_bwd_tf32_emulated(q, k, v, dO, lse, delta, causal=causal)
    for g, p, e in zip(got, plain, emul):
        assert g.dtype == torch.float32 and g.shape == (BH, S, D)
        torch.testing.assert_close(g, p, **F32_GRAD_TOL)
        torch.testing.assert_close(g, e, **F32_EMUL_TOL)


@pytest.mark.parametrize("dtype,D", HEAD_DIM_CASES)
def test_flash_bwd_kernels_are_deterministic(card, dtype, D) -> None:
    q, k, v, dO = _qkv((32, 256, D), dtype, card, seed=2, n=4)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (dO.float() * o.float()).sum(-1)
    first = fa.flash_bwd(q, k, v, dO, lse, delta)
    second = fa.flash_bwd(q, k, v, dO, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_tf32_split_on_the_card_is_the_model(card) -> None:
    """cvt.rna.tf32.f32 as the kernels run it, against fa.split_tf32 (whose
    CPU test holds it bit for bit to a numpy model), bit for bit: ties,
    subnormals, the largest finite values, infinities, NaNs (one whose
    payload is all in the dropped bits) and random patterns."""
    rng = np.random.default_rng(5)
    patterns = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        (rng.integers(0, 2**19, 1024, dtype=np.uint64).astype(np.uint32) << 13) | 0x1000,
        rng.integers(1, 0x800000, 1024, dtype=np.uint64).astype(np.uint32),
        np.array([0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
                  0x7FC00000, 0x7F800001, 0, 0x80000000, 0x00001000, 0x80001000], dtype=np.uint32),
    ])
    x = torch.from_numpy(patterns.view(np.int32).copy()).view(torch.float32)
    hi, lo = fa.tf32_split_cuda(x.to(card))
    want = fa.split_tf32(x)
    for got, ref in zip((hi.cpu(), lo.cpu()), want):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("N", [64, 128])
def test_tf32_fragment_relayout_alone(card, N) -> None:
    """The re-layout of an accumulator fragment into 3xTF32 A fragments and
    the permuted transposed copy of the B operand, alone: x @ y through that
    path against the f64 product. The split keeps about 21 bits of each
    operand and the 64 f32 sums of an output are of terms under about 16,
    holds it to 5e-5 (f32 products of these operands are off the f64 one by
    up to 1.4e-5, one TF32 product by 1.2e-2); a wrong pairing of columns
    misses by O(1)."""
    rng = np.random.default_rng(N)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    y = rng.standard_normal((64, N)).astype(np.float32)
    got = fa.tf32_relayout_cuda(torch.from_numpy(x).to(card), torch.from_numpy(y).to(card))
    want = torch.from_numpy(x.astype(np.float64) @ y.astype(np.float64))
    torch.testing.assert_close(got.cpu().double(), want, atol=5e-5, rtol=0)


def test_flash_bwd_kernel_refuses_misaligned_bf16(card) -> None:
    storage = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    dO = storage[1:].view(2, 64, 64)  # contiguous, 2 bytes past a 16-byte boundary
    q, k, v = _qkv((2, 64, 64), torch.bfloat16, card)
    lse = torch.zeros((2, 64), device=card)
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        with pytest.raises(ValueError, match=f"{kernel} kernel takes operands aligned to 16 bytes"):
            getattr(fa, kernel)(q, k, v, dO, lse, lse)


def test_flash_bwd_kernel_refuses_misaligned_f32(card) -> None:
    storage = torch.zeros(2 * 64 * 64 + 1, dtype=torch.float32, device=card)
    dO = storage[1:].view(2, 64, 64)  # contiguous, 4 bytes past a 16-byte boundary
    q, k, v = _qkv((2, 64, 64), torch.float32, card)
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


# ----------------------------------- float16, padded rows, head dims over 256

# float16 through the 16-bit wgmma kernels at each tile width (12 runs
# padded to 16), and the deep forms past 256 in every dtype: 264 (the
# least, five chunks of 64 columns), 320, 384 (where the f32 forward's
# block takes six groups of O, its most) and 512 (two blocks along z in
# f32, one in 16 bits).
F16_HEAD_DIMS = [12, 64, 128, 200, 256]
DEEP_HEAD_DIMS = [264, 320, 384, 512]
LSE_ATOL = {torch.float32: 1e-5, torch.bfloat16: BF16_LSE_ATOL, torch.float16: BF16_LSE_ATOL}


def _check_fwd_bwd(q, k, v, dO, causal) -> None:
    """K1, then K2 and K3 from the plain version's statistics, against the
    plain versions (f32 at 1e-5 and 1e-4, 16-bit o at 3e-2, lse at 1e-4
    and the gradients at the emul bar), one launch of each; a second
    launch of each gives the same bits."""
    dtype = q.dtype
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO.float() * o_ref.float()).sum(-1)
    got = fa.flash_bwd(q, k, v, dO, lse_ref, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
        n + 1 for n in before)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == q.shape[:2]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL[dtype], rtol=0)
    if dtype == torch.float32:
        for g, w in zip(got, fa.flash_bwd_reference(q, k, v, dO, lse_ref, delta, causal=causal)):
            assert g.dtype == dtype and g.shape == q.shape
            torch.testing.assert_close(g, w, **F32_GRAD_TOL)
    else:
        _assert_bf16_grads_close(got, q, k, v, dO, lse_ref, delta, causal)
    again = (*fa.flash_fwd(q, k, v, causal=causal),
             *fa.flash_bwd(q, k, v, dO, lse_ref, delta, causal=causal))
    assert all(torch.equal(a, b) for a, b in zip((o, lse, *got), again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", F16_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 100, 200, 256])
def test_flash_f16_kernels_match_plain(card, S, D, causal) -> None:
    """The f16 forms of K1-K3 (the bf16 kernels' template at __half: a bf16
    wgmma on f16 bits would give wrong values with no error)."""
    q, k, v, dO = _qkv((3, S, D), torch.float16, card, seed=S + D, n=4)
    _check_fwd_bwd(q, k, v, dO, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", DEEP_HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 100, 200])
def test_flash_deep_kernels_match_plain(card, S, D, dtype, causal) -> None:
    """The deep forms of K1-K3 (d > 256, every one on the tensor cores: the
    16-bit kernels round P and dS as the W <= 256 ones do, under the emul
    bar): ragged lengths, both masks, every split of O's and dq's groups
    and of the score chunks between the warpgroups, one block or two along
    z; a second run of each gives the same bits."""
    q, k, v, dO = _qkv((3, S, D), dtype, card, seed=S + D + 1, n=4)
    _check_fwd_bwd(q, k, v, dO, causal)


# The deep tensor-core forms stream 64-key tiles (K1, K2) and 64-row (K3
# in 16 bits) or 32-row (K3 f32) q tiles: lengths one below and one above
# multiples of 32 and 64, and 1.
DEEP_EDGE_LENGTHS = [1, 31, 33, 63, 65, 127, 129]


@pytest.mark.parametrize("BH", [1, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [264, 320, 512])
@pytest.mark.parametrize("S", DEEP_EDGE_LENGTHS)
def test_flash_f32_deep_kernels_at_tile_edges(card, S, D, causal, BH) -> None:
    """The deep f32 K1 and K3 at the edges of their tiles: o and lse within
    1e-5 of the plain version, dk and dv within 1e-4, and each within the
    summation order's bar of the emulation of its arithmetic
    (fa.flash_fwd_tf32_emulated: chunked score sums parted as
    fa.deep_score_chunks, P V by halves of a tile; fa.flash_bwd_tf32_emulated)."""
    assert fa.kernel_width(D, torch.float32) == fa.DEEP and fa.fwd_tf32_rows(D) == 64
    q, k, v, dO = _qkv((BH, S, D), torch.float32, card, seed=S + D + BH, n=4)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO * o_ref).sum(-1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dO, lse_ref, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(o, o_ref, atol=ATOL[torch.float32], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=ATOL[torch.float32], rtol=0)
    o_em, lse_em = fa.flash_fwd_tf32_emulated(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_em, **F32_EMUL_TOL)
    torch.testing.assert_close(lse, lse_em, **F32_EMUL_TOL)
    plain = fa.flash_bwd_dkv_reference(q, k, v, dO, lse_ref, delta, causal=causal)
    emul = fa.flash_bwd_tf32_emulated(q, k, v, dO, lse_ref, delta, causal=causal)[1:]
    for g, p, e in zip((dk, dv), plain, emul):
        torch.testing.assert_close(g, p, **F32_GRAD_TOL)
        torch.testing.assert_close(g, e, **F32_EMUL_TOL)


@pytest.mark.parametrize("BH", [1, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [264, 320, 512, 576, 640])
@pytest.mark.parametrize("S", DEEP_EDGE_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_deep_backward_kernels_at_tile_edges(card, dtype, S, D, causal, BH) -> None:
    """The deep K2 in every dtype and K3 in 16 bits at the edges of their
    tiles, from the plain forward's lse: f32 dq within 1e-4 of the plain
    version and within the summation order's bar of the emulation of its
    3xTF32 arithmetic (fa.flash_bwd_tf32_emulated); 16-bit dq, dk and dv
    within the emul bar of flash_bwd_emul (P and dS rounded to the dtype,
    f16 rounding scale dS); a second launch gives the same bits. d 264
    and 320 run the f32 dq kernel at three items a warpgroup, 512 and up
    at four; at 576 and 640 every dq kernel takes a second block along z,
    which at 576 leaves its warpgroup 1 no columns of dq."""
    assert fa.kernel_width(D, dtype) == fa.DEEP and fa.bwd_tf32_rows(D) == (64, 32)
    q, k, v, dO = _qkv((BH, S, D), dtype, card, seed=S + D + BH + 5, n=4)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    delta = (dO.float() * o_ref.float()).sum(-1)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    if dtype == torch.float32:
        got = (fa.flash_bwd_dq(q, k, v, dO, lse_ref, delta, causal=causal),)
        again = (fa.flash_bwd_dq(q, k, v, dO, lse_ref, delta, causal=causal),)
        torch.cuda.synchronize()
        assert fa.flash_bwd_dq.launches == before[0] + 2
        plain = fa.flash_bwd_dq_reference(q, k, v, dO, lse_ref, delta, causal=causal)
        emul = fa.flash_bwd_tf32_emulated(q, k, v, dO, lse_ref, delta, causal=causal)[0]
        torch.testing.assert_close(got[0], plain, **F32_GRAD_TOL)
        torch.testing.assert_close(got[0], emul, **F32_EMUL_TOL)
    else:
        got = fa.flash_bwd(q, k, v, dO, lse_ref, delta, causal=causal)
        again = fa.flash_bwd(q, k, v, dO, lse_ref, delta, causal=causal)
        torch.cuda.synchronize()
        assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 2,
                                                                         before[1] + 2)
        _assert_bf16_grads_close(got, q, k, v, dO, lse_ref, delta, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [264, 320, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_fwd_16bit_deep_kernel_matches_its_emulation(card, dtype, D, causal) -> None:
    """The deep 16-bit K1 (wgmma on 16-bit operands, P rounded to the
    input dtype for P V) at BH 64, S 129: o within 3e-2 of the plain
    version and within the emulation of its arithmetic
    (fa.flash_fwd_bf16_wide_emulated) by one step of the dtype at o's
    size (the kernel sums in another order and rounds o once); lse within
    1e-4 of both."""
    q, k, v = _qkv((64, 129, D), dtype, card, seed=D + 7)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    o_em, lse_em = fa.flash_fwd_bf16_wide_emulated(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[dtype], rtol=0)
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    torch.testing.assert_close(o.float(), o_em.float(), atol=2 * step, rtol=2 * step)
    torch.testing.assert_close(lse, lse_ref, atol=BF16_LSE_ATOL, rtol=0)
    torch.testing.assert_close(lse, lse_em, atol=BF16_LSE_ATOL, rtol=0)


@pytest.mark.parametrize("D", [64, 256, 320])
def test_flash_f16_backward_under_loss_scaling(card, D) -> None:
    """dO scaled by 2^12, as a loss-scaled gradient is: the f16 backward
    kernels (which round scale dS, not dS, to f16) give finite gradients
    where the plain version does, and scaled back by 2^-12 they are held
    to the plain version at the emul bar."""
    q, k, v, dO = _qkv((16, 256, D), torch.float16, card, seed=D, n=4)
    dO = (dO.float() * 2.0**12).to(torch.float16)
    o, lse = fa.flash_fwd_reference(q, k, v)
    delta = (dO.float() * o.float()).sum(-1)
    got = fa.flash_bwd(q, k, v, dO, lse, delta)
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta)
    emul = flash_bwd_emul(q, k, v, dO, lse, delta)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(g).all())
    back = [[t.float() * 2.0**-12 for t in ts] for ts in (got, plain, emul)]
    for err, bar in bf16_grad_errors(*back):
        assert err <= bar


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.bfloat16, 12),
                                     (torch.float16, 12)])
def test_ring_flash_hop_takes_f16_and_padded_rows(card, dtype, D) -> None:
    """One ring hop as ops/ring_flash.py drives the raw split (FLASH), with
    no code of its own for these operands: q against two shards of the
    keys, the forward's two partial results merged by their lse, the
    backward of each shard from the global lse and delta; against the
    plain version over all the keys."""
    from torchsnapshot_tpu_torch.ops.ring_flash import FLASH

    BH, S = 8, 128
    q, dO = _qkv((BH, S, D), dtype, card, seed=D, n=2)
    k, v = _qkv((BH, 2 * S, D), dtype, card, seed=D + 1, n=2)
    shards = [(k[:, h].contiguous(), v[:, h].contiguous()) for h in (slice(0, S), slice(S, None))]
    (o0, l0), (o1, l1) = (FLASH.fwd(q, kh, vh, causal=False) for kh, vh in shards)
    lse = torch.logaddexp(l0, l1)
    o = o0.float() * torch.exp(l0 - lse)[..., None] + o1.float() * torch.exp(l1 - lse)[..., None]
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=False)
    torch.testing.assert_close(o, o_ref.float(), atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=BF16_LSE_ATOL, rtol=0)
    delta = (dO.float() * o_ref.float()).sum(-1)
    parts = [FLASH.bwd(q, kh, vh, dO, lse_ref, delta, causal=False) for kh, vh in shards]
    emuls = [flash_bwd_emul(q, kh, vh, dO, lse_ref, delta, causal=False) for kh, vh in shards]
    torch.cuda.synchronize()

    def whole(halves):
        return (halves[0][0].float() + halves[1][0].float(),
                torch.cat([halves[0][1], halves[1][1]], 1), torch.cat([halves[0][2], halves[1][2]], 1))

    plain = fa.flash_bwd_reference(q, k, v, dO, lse_ref, delta, causal=False)
    for err, bar in bf16_grad_errors(whole(parts), plain, whole(emuls)):
        assert err <= bar


# The model through attn_impl="auto" on the card at the head dims that
# reached no kernel before: bf16 and f16 12 (padded), f32 6 (padded), 320
# (deep) in each dtype. Logits against dense attention: f32 at 5e-5 (TF32
# off), 16-bit at chip_smoke's bars (0.125 max, 0.01 mean); step-1
# gradients by relative L2, f32 1e-5 and 16-bit 5e-2.
AUTO_CASES = [(torch.bfloat16, 12), (torch.float16, 12), (torch.float32, 6),
              (torch.float32, 320), (torch.bfloat16, 320), (torch.float16, 320)]


@pytest.mark.parametrize("dtype,head_dim", AUTO_CASES, ids=str)
def test_model_auto_runs_the_kernels_at_every_head_dim(card, dtype, head_dim) -> None:
    import dataclasses

    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=512, d_model=2 * head_dim, n_heads=2, n_layers=2,
                              d_ff=128, max_seq_len=128, dtype=dtype)
    dense = dataclasses.replace(cfg, attn_impl="dense")
    assert cfg.head_dim == head_dim and T._resolve_attn_impl(cfg, card, 128) == "flash"
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {n: torch.randint(0, cfg.vocab_size, (2, 128), generator=g, device=card)
             for n in ("tokens", "targets")}
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    with torch.no_grad():
        logits = T.forward(params, batch["tokens"], cfg)
    _, grads = T.loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    after = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    with torch.no_grad():
        ref = T.forward(params, batch["tokens"], dense)
    _, ref_grads = T.loss_and_grads(params, batch, dense)
    diff = (logits.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 5e-5
    else:
        assert diff.max().item() <= 0.125 and diff.mean().item() <= 0.01
    want = flatten(ref_grads)[1]
    for path, t in flatten(grads)[1].items():
        rel = ((t.float() - want[path].float()).norm() / want[path].float().norm()).item()
        assert rel <= (1e-5 if dtype == torch.float32 else 5e-2), (path, rel)


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


# K4's partial form reads a region in place as runs (csrc/digest.cu,
# "Partial form"): each region below is a view of a piece on the card, and
# its lanes must equal the plain version's on a CPU copy, bit for bit.
PARTIAL_BYTES = [torch.uint8, torch.bfloat16, torch.float32, torch.int64]
PARTIAL_REGIONS = {
    # name: (piece shape, region slices); runs in the comments
    "contiguous": ((4, 8, 96), (slice(0, 4), slice(2, 6), slice(0, 96))),  # 4 runs of 384
    "last_dim_sliced": ((4, 8, 96), (slice(1, 3), slice(0, 8), slice(5, 38))),  # runs of 33
    "middle_dim_sliced": ((4, 8, 96), (slice(0, 4), slice(2, 6), slice(0, 96))),  # 4 runs of 384
    "unaligned_starts": ((4, 8, 96), (slice(0, 4), slice(0, 8), slice(1, 96))),  # runs of 95
    "runs_of_1": ((4, 8, 96), (slice(0, 4), slice(1, 7), slice(7, 8))),
    "runs_of_3": ((4, 8, 96), (slice(0, 3), slice(1, 7), slice(4, 7))),
    "runs_of_1m": ((3, 2, 1 << 20), (slice(1, 3), slice(1, 2), slice(0, 1 << 20))),  # 2 runs of 1,048,576
    "long_unaligned": ((2, 3, 70001), (slice(0, 2), slice(0, 3), slice(3, 70001))),
    "empty": ((4, 8, 96), (slice(0, 4), slice(3, 3), slice(0, 96))),
    "eight_dims": ((2, 3, 2, 3, 2, 3, 2, 5), tuple(slice(1, n) for n in (2, 3, 2, 3, 2, 3, 2, 5))),
}


def _partial_region(name, dtype, device):
    shape, slices = PARTIAL_REGIONS[name]
    n = int(np.prod(shape))
    piece = _digest_input(dtype, n * dtype.itemsize, seed=n, device=device).reshape(shape)
    region = piece[slices]
    if name == "contiguous":
        region = region.contiguous()
    return piece, region, tuple(sl.start for sl in slices)


@pytest.mark.parametrize("name", list(PARTIAL_REGIONS))
@pytest.mark.parametrize("dtype", PARTIAL_BYTES, ids=str)
def test_digest_partial_kernel_matches_plain(card, dtype, name) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd

    piece, region, offsets = _partial_region(name, dtype, card)
    before = dd.fingerprint_lanes.partial_launches
    lanes = dd.partial_fetch(dd.partial_dispatch(region, piece.shape, offsets))
    assert dd.fingerprint_lanes.partial_launches == before + 1
    assert lanes == dd.lanes_reference(region.cpu(), offsets, piece.shape)


@pytest.mark.parametrize("dtype", PARTIAL_BYTES, ids=str)
def test_digest_partial_kernel_innermost_stride_scalar_and_wrap(card, dtype) -> None:
    from torchsnapshot_tpu_torch import device_digest as dd

    piece = _digest_input(dtype, 6 * 10 * 7 * dtype.itemsize, seed=9, device=card).reshape(6, 10, 7)
    # The same logical region held with its innermost stride 10, not 1.
    region = piece[1:5, 2:9].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert region.stride()[-1] != 1
    got = dd.partial_fetch(dd.partial_dispatch(region, piece.shape, (1, 2, 0)))
    assert got == dd.lanes_reference(region.cpu(), (1, 2, 0), piece.shape)
    scalar = piece[2, 3, 4]
    got = dd.partial_fetch(dd.partial_dispatch(scalar, (), ()))
    assert got == dd.lanes_reference(scalar.cpu(), (), ())
    # Word indices past 2^32: a (3, 5) region at (69000, 12) of a (70000,
    # 70000) piece given by its shape only.
    small = piece[0, :3, :5]
    got = dd.partial_fetch(dd.partial_dispatch(small, (70000, 70000), (69000, 12)))
    assert got == dd.lanes_reference(small.cpu(), (69000, 12), (70000, 70000))


@pytest.mark.parametrize("dtype", PARTIAL_BYTES, ids=str)
def test_digest_partial_kernel_cover_adds_up(card, dtype) -> None:
    """Views cut at unaligned rows and columns, runs short and long: their
    partial lanes add up to the piece's fingerprint."""
    from torchsnapshot_tpu_torch import device_digest as dd

    piece = _digest_input(dtype, 5 * 12 * 300 * dtype.itemsize, seed=4, device=card).reshape(5, 12, 300)
    groups = []
    for r0, r1 in ((0, 1), (1, 5)):
        for c0, c1 in ((0, 5), (5, 12)):
            for k0, k1 in ((0, 1), (1, 34), (34, 300)):
                region = piece[r0:r1, c0:c1, k0:k1]
                groups.append(dd.partial_fetch(dd.partial_dispatch(region, piece.shape, (r0, c0, k0))))
    assert dd.combine_partials(groups, piece.numel() * piece.element_size()) == dd.device_fingerprint(piece)


def test_digest_partial_kernel_is_deterministic_and_reads_in_place(card) -> None:
    """Phase 15's largest region as the view ``piece[:, 4:8]``: two
    launches give bit-identical lanes, and the launch allocates no copy of
    the region (the peak grows by less than its bytes)."""
    from torchsnapshot_tpu_torch import device_digest as dd

    piece = _digest_input(torch.float32, 2 * 8 * 512 * 2048 * 4, seed=15, device=card).reshape(2, 8, 512, 2048)
    region = piece[:, 4:8]
    assert not region.is_contiguous()
    first = dd.partial_dispatch(region, piece.shape, (0, 4, 0, 0))
    second = dd.partial_dispatch(region, piece.shape, (0, 4, 0, 0))
    assert torch.equal(first, second)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dd.partial_dispatch(region, piece.shape, (0, 4, 0, 0))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < region.numel() * region.element_size()
    assert dd.partial_fetch(first) == dd.lanes_reference(region.cpu(), (0, 4, 0, 0), piece.shape)


# ------------------------------------------------- the dryrun on the card


def test_dryrun_multichip_default_config_on_the_card(card) -> None:
    """``entry.dryrun_multichip(4)`` at its own configuration
    (``dryrun_config(4, "ring")``: d_model 32 over 2 heads, head_dim 16;
    ring attention over {data 1, seq 2, model 2}; a top-2 MoE; bf16), which
    the kernels refused before they took head dims under 64: a world of 4
    processes on the card against the same world on the CPU
    (``tests/test_torch_entry.py::test_dryrun_multichip_on_cpu``). Every
    rank's loss within chip_smoke's bar of 1/32 of the CPU's; the round trip
    bit-exact (the dryrun raises otherwise) with an unchanged device-digest
    take that stages nothing; K1-K3 launched on every rank as the ring
    implies: one hop a layer on seq rank 0, two on seq rank 1."""
    import chip_smoke
    from torchsnapshot_tpu_torch.entry import dryrun_config, dryrun_multichip

    cfg = dryrun_config(4, "ring")
    assert cfg.d_model // cfg.n_heads == 16
    gpu = dryrun_multichip(4, device="cuda", timeout=600)
    cpu = dryrun_multichip(4, device="cpu", timeout=600)
    assert sorted(gpu) == sorted(cpu) == [0, 1, 2, 3]
    for r, res in gpu.items():
        assert res["mesh"] == {"data": 1, "seq": 2, "model": 2} and res["attn_impl"] == "ring"
        assert res["restore_mesh"] == {"data": 2, "seq": 1, "model": 2}
        assert abs(res["loss"] - cpu[r]["loss"]) <= chip_smoke.TRAIN_LOSS_ATOL
        assert abs(res["loss_after_restore"] - cpu[r]["loss_after_restore"]) <= chip_smoke.TRAIN_LOSS_ATOL
        assert res["dd_staged"] == 0 and res["dd_consumed"] == 0 and res["dd_launches"] > 0
        want = chip_smoke._expected_kernel_calls("ring", (r // 2) % 2, 2, cfg.n_layers)
        assert want > 0
        assert res["launches"] == {"flash_fwd": want, "flash_bwd_dq": want, "flash_bwd_dkv": want}
