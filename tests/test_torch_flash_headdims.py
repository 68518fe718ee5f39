"""Head dims under the kernels' tile widths, on the CPU.

K1-K3 take every head dim ``d >= 1`` in float32, bfloat16 and float16
(``fa.kernel_width``). The tensor-core kernels are built for three tile
widths, 64, 128 and 256: a ``d`` up to 256 runs at ``fa.padded_dim``, the
least row of a multiple of 16 bytes (the wrappers zero-pad the operands
and slice the results back), TMA lands zeros in a tile's columns past it
and the stores write the columns below it alone; past 256 the deep forms
run at ``fa.padded_dim`` too. Three things are held here, where no card is:

- the rule itself, for the three dtypes, with the head dims it refuses
  (``d < 1``);
- the identity the kernels rely on: inputs zero-padded to the tile width
  give, sliced back to ``d``, what the unpadded inputs give, through the
  plain versions and through the emulations of the f32 kernels' 3xTF32
  arithmetic, and zeros in the padded columns;
- the port's ``flash_attention`` at such head dims against the JAX
  package's, which runs its Pallas kernels in interpret mode as
  ``tests/test_pallas_attention.py`` does, forward and gradients, at that
  file's bars (1e-5 / 1e-4 for f32, 3e-2 / 0.1 for bf16).

The kernels themselves are held to their plain versions at these head dims
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts
from torchsnapshot_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from torchsnapshot_tpu_torch.ops import flash_attention as fa
from torch_test_env import autotune_never  # noqa: F401 - autouse

# The rule as a table, written out rather than computed: head dim -> tile
# width of the padded head dim, DEEP (fa.DEEP) past 256, or None where no
# kernel takes it (d < 1). A row that is not a multiple of 16 bytes runs
# padded: bf16 and f16 to a multiple of 8, f32 of 4.
DEEP = fa.DEEP
WIDTHS = {
    torch.bfloat16: {
        8: 64, 16: 64, 24: 64, 32: 64, 40: 64, 48: 64, 56: 64, 64: 64,
        72: 128, 80: 128, 96: 128, 120: 128, 128: 128,
        136: 256, 144: 256, 192: 256, 200: 256, 248: 256, 256: 256,
        -8: None, 0: None, 4: 64, 6: 64, 12: 64, 20: 64, 60: 64, 100: 128,
        129: 256, 130: 256, 252: 256, 264: DEEP, 512: DEEP,
    },
    torch.float32: {
        4: 64, 8: 64, 12: 64, 16: 64, 20: 64, 24: 64, 32: 64, 60: 64, 64: 64,
        68: 128, 96: 128, 100: 128, 124: 128, 128: 128,
        132: 256, 136: 256, 192: 256, 252: 256, 256: 256,
        -4: None, 0: None, 2: 64, 6: 64, 10: 64, 66: 128, 126: 128,
        129: 256, 130: 256, 258: DEEP, 260: DEEP, 512: DEEP,
    },
    torch.float16: {
        1: 64, 12: 64, 64: 64, 65: 128, 128: 128, 129: 256, 256: 256, 257: DEEP, 320: DEEP,
        0: None,
    },
}
# The padded head dim, written out: bf16 and f16 rows of a multiple of 8
# elements, f32 of 4, at every d (past 256 too: the deep forms load through
# TMA).
PADDED = {
    torch.bfloat16: {1: 8, 4: 8, 6: 8, 8: 8, 12: 16, 20: 24, 100: 104, 129: 136, 252: 256,
                     256: 256, 257: 264, 264: 264, 300: 304, 320: 320, 513: 520},
    torch.float16: {12: 16, 63: 64, 250: 256, 301: 304, 384: 384},
    torch.float32: {1: 4, 2: 4, 6: 8, 10: 12, 66: 68, 126: 128, 129: 132, 255: 256, 258: 260,
                    260: 260, 321: 324},
}
RULE = r"flash kernels take every head_dim d >= 1, got d = -?\d+$"


@pytest.mark.parametrize(
    "dtype,d", [(dtype, d) for dtype, table in WIDTHS.items() for d in table],
    ids=lambda x: str(x)[6:] if isinstance(x, torch.dtype) else str(x),
)
def test_kernel_width_rule(dtype, d) -> None:
    want = WIDTHS[dtype][d]
    if want is None:
        with pytest.raises(ValueError, match=RULE):
            fa.kernel_width(d, dtype)
    else:
        assert fa.kernel_width(d, dtype) == want


@pytest.mark.parametrize(
    "dtype,d", [(dtype, d) for dtype, table in PADDED.items() for d in table],
    ids=lambda x: str(x)[6:] if isinstance(x, torch.dtype) else str(x),
)
def test_padded_dim_rule(dtype, d) -> None:
    assert fa.padded_dim(d, dtype) == PADDED[dtype][d]
    assert fa.kernel_width(d, dtype) == (DEEP if d > 256 else fa.kernel_width(
        PADDED[dtype][d], dtype))


def test_kernel_width_names_the_head_dim_and_dtype() -> None:
    """The new rule by name: a row that is not a multiple of 16 bytes runs
    padded at its tile width, d > 256 runs the deep form, d < 1 raises
    naming d, and a dtype no kernel takes raises naming it."""
    assert (fa.padded_dim(12, torch.bfloat16), fa.kernel_width(12, torch.bfloat16)) == (16, 64)
    assert (fa.padded_dim(260, torch.float32), fa.kernel_width(260, torch.float32)) == (260, DEEP)
    with pytest.raises(ValueError, match=r"got d = 0$"):
        fa.kernel_width(0, torch.bfloat16)
    with pytest.raises(TypeError, match=r"float32, bfloat16 or float16, got torch\.float64$"):
        fa.check_kernel_dtype(torch.float64)


# ----------------------------------------------- the zero-padding identity

PAD_DIMS = [8, 16, 24, 32, 48, 96, 136, 200]
PAD_TOL = dict(atol=1e-6, rtol=0)


def _operands(d: int, seed: int, n: int = 4, shape=(3, 100)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((*shape, d), dtype=np.float32))
            for _ in range(n)]


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    return F.pad(t, (0, width - t.shape[-1]))


def _assert_padded_matches(padded, unpadded, d) -> None:
    for p, u in zip(padded, unpadded):
        torch.testing.assert_close(p[..., :d], u, **PAD_TOL)
        assert torch.count_nonzero(p[..., d:]) == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", PAD_DIMS)
def test_zero_padding_to_the_tile_width_keeps_the_forward(d, causal) -> None:
    width = fa.kernel_width(d, torch.float32)
    assert fa.fwd_tf32_rows(width) == fa.fwd_tf32_rows(d)  # the same key tiles
    q, k, v = _operands(d, seed=d, n=3)
    qp, kp, vp = (_pad(t, width) for t in (q, k, v))
    scale = d**-0.5
    for fwd in (fa.flash_fwd_reference, fa.flash_fwd_tf32_emulated):
        o, lse = fwd(q, k, v, causal=causal, scale=scale)
        op, lsep = fwd(qp, kp, vp, causal=causal, scale=scale)
        _assert_padded_matches([op], [o], d)
        torch.testing.assert_close(lsep, lse, **PAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", PAD_DIMS)
def test_zero_padding_to_the_tile_width_keeps_the_gradients(d, causal) -> None:
    width = fa.kernel_width(d, torch.float32)
    q, k, v, dO = _operands(d, seed=100 + d)
    scale = d**-0.5
    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal, scale=scale)
    delta = (dO * o).sum(-1)
    padded = [_pad(t, width) for t in (q, k, v, dO)]
    for bwd in (fa.flash_bwd_reference, fa.flash_bwd_tf32_emulated):
        got = bwd(*padded, lse, delta, causal=causal, scale=scale)
        want = bwd(q, k, v, dO, lse, delta, causal=causal, scale=scale)
        _assert_padded_matches(got, want, d)


# ---------------------------------------------------- against the JAX package

JAX_DIMS = [8, 24, 32, 48, 96, 136, 192, 256]
# float16 at bfloat16's bars (its 10 mantissa bits round less than bf16's 7).
FWD_ATOL = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 3e-2}
GRAD_ATOL = {"float32": 1e-4, "bfloat16": 0.1, "float16": 0.1}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", JAX_DIMS)
def test_flash_attention_matches_jax_at_head_dim(d, causal, dtype) -> None:
    """Forward and the gradients of ``sum(o * dO)`` through
    ``flash_attention`` (B 2, S 64, H 2, blocks 16 and 32), the JAX side's
    Pallas kernels in interpret mode."""
    _check_against_jax(d, causal, dtype)


def _check_against_jax(d, causal, dtype, blocks=(16, 32)) -> None:
    """The port's ``flash_attention`` against the JAX package's at head dim
    ``d`` (B 2, S 64, H 2, blocks ``blocks``): o at FWD_ATOL and the
    gradients of ``sum(o * dO)`` at GRAD_ATOL."""
    rng = np.random.default_rng(d)
    arrays = [rng.standard_normal((2, 64, 2, d), dtype=np.float32) for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a).astype(dtype) for a in arrays)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=blocks[0], block_k=blocks[1])
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32)), o

    (_, jo), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)

    q, k, v, g = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = fa.flash_attention(q, k, v, causal=causal, block_q=blocks[0], block_k=blocks[1])
    grads = torch.autograd.grad((o.float() * g.float()).sum(), (q, k, v))
    assert o.shape == (2, 64, 2, d) and o.dtype == q.dtype
    np.testing.assert_allclose(_np(o), _np(jo), atol=FWD_ATOL[dtype], rtol=0)
    for a, b in zip(grads, jgrads):
        assert a.dtype == q.dtype and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL[dtype], rtol=0)
    if dtype == "float16":  # the errors the bars leave room for (pytest -s shows them)
        print(f"float16 d={d} causal={causal}: max|o - jax| {np.abs(_np(o) - _np(jo)).max():.3g}, "
              "max|grad - jax| " + ", ".join(f"{np.abs(_np(a) - _np(b)).max():.3g}"
                                             for a, b in zip(grads, jgrads)))


# Rows a tile of the f32 backward kernels streams, (dq's key rows, dk/dv's
# q rows), by tile width, written out (Tf32Tiles<W>, WIDE_DQ_KEYS and
# WIDE_DKV_ROWS in csrc/flash_bwd.cu); the deep kernels stream W = 256's.
BWD_ROWS = {64: (64, 64), 128: (32, 16), 256: (64, 32), DEEP: (64, 32)}


@pytest.mark.parametrize("d", [d for d, w in WIDTHS[torch.float32].items() if w])
def test_bwd_tf32_rows_follow_the_tile_width(d) -> None:
    assert fa.bwd_tf32_rows(d) == BWD_ROWS[WIDTHS[torch.float32][d]]


def test_bwd_tf32_rows_refuse_what_no_kernel_takes() -> None:
    """The rule: d = 130 runs padded to 132 at tile width 256; d = 258 and
    512 run the deep f32 forms, which stream W = 256's tiles (64 keys for
    dq, 32 q rows for dk/dv); d = 0 no kernel takes."""
    assert fa.bwd_tf32_rows(130) == BWD_ROWS[256]
    assert fa.bwd_tf32_rows(258) == fa.bwd_tf32_rows(512) == BWD_ROWS[DEEP] == (64, 32)
    with pytest.raises(ValueError, match=RULE):
        fa.bwd_tf32_rows(0)


# Key rows a tile of the f32 forward kernel streams, by tile width, written
# out (Tf32Fwd<W>::BK and WIDE_BK in csrc/flash_fwd.cu).
FWD_ROWS = {64: 64, 128: 32, 256: 64}


@pytest.mark.parametrize("d", [d for d, w in WIDTHS[torch.float32].items() if w])
def test_fwd_tf32_rows_follow_the_tile_width(d) -> None:
    assert fa.fwd_tf32_rows(d) == FWD_ROWS[WIDTHS[torch.float32][d]]


def test_fwd_tf32_rows_refuse_what_no_kernel_takes() -> None:
    """The new rule: d = 130 runs padded to 132 at tile width 256; d = 258
    runs the deep f32 forward (padded to 260), which streams 64-key tiles
    as the W = 256 kernel does; d = 0 no kernel takes."""
    assert fa.fwd_tf32_rows(130) == FWD_ROWS[256]
    assert fa.fwd_tf32_rows(258) == 64
    with pytest.raises(ValueError, match=RULE):
        fa.fwd_tf32_rows(0)


# Sequence lengths that no streamed tile of the wide f32 backward divides
# (neither its 64 key rows nor its 32 q rows), with blocks that divide them.
WIDE_BWD_LENGTHS = [(48, 16), (80, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,block", WIDE_BWD_LENGTHS)
@pytest.mark.parametrize("d", [132, 192, 256])
def test_wide_f32_backward_matches_jax_at_ragged_lengths(d, S, block, causal) -> None:
    """The f32 gradients of ``sum(o * dO)`` at the wide head dims (B 1, H
    2) and lengths that end inside a streamed tile of the wide backward
    kernels, against the JAX package's Pallas kernels in interpret mode, at
    the f32 bars."""
    assert all(S % rows for rows in fa.bwd_tf32_rows(d))
    rng = np.random.default_rng(S + d)
    arrays = [rng.standard_normal((1, S, 2, d), dtype=np.float32) for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=block, block_k=block)
        return jnp.sum(o * jg), o

    (_, jo), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)

    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = fa.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block)
    grads = torch.autograd.grad((o * g).sum(), (q, k, v))
    np.testing.assert_allclose(_np(o), _np(jo), atol=FWD_ATOL["float32"], rtol=0)
    for a, b in zip(grads, jgrads):
        assert a.dtype == torch.float32 and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL["float32"], rtol=0)


# Sequence lengths that end inside a 64-key tile of the wide f32 forward
# and inside a half of it, with blocks that divide them.
WIDE_FWD_LENGTHS = [(48, 16), (80, 16), (112, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,block", WIDE_FWD_LENGTHS)
@pytest.mark.parametrize("d", [132, 192, 256])
def test_wide_f32_forward_matches_jax_at_ragged_lengths(d, S, block, causal) -> None:
    """o and lse at the wide head dims (BH 2) and lengths that end inside a
    key tile of the wide forward kernel: the port's plain path and the
    emulation of the kernel's arithmetic (fa.flash_fwd_tf32_emulated:
    chunked score sums, P V by halves of a tile) against the JAX package's
    Pallas kernel in interpret mode, at the f32 bar."""
    assert S % fa.fwd_tf32_rows(d)
    rng = np.random.default_rng(S + d + 1)
    arrays = [rng.standard_normal((2, S, d), dtype=np.float32) for _ in range(3)]
    fwd_impl, _ = _make_flash_parts(causal, None, block, block, True)
    jo, jlse = fwd_impl(*(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a) for a in arrays)
    for fwd in (fa.flash_fwd, fa.flash_fwd_tf32_emulated):
        o, lse = fwd(q, k, v, causal=causal)
        assert o.shape == (2, S, d) and lse.shape == (2, S)
        np.testing.assert_allclose(_np(o), _np(jo), atol=FWD_ATOL["float32"], rtol=0)
        np.testing.assert_allclose(_np(lse), _np(jlse)[..., 0], atol=FWD_ATOL["float32"], rtol=0)


# The wide bf16 kernels (tile width 256) stream 64-key (K1) and 64-row q
# (K3) tiles: lengths that end inside one, with blocks that divide them.
WIDE_BF16_LENGTHS = [(48, 16), (80, 16), (112, 16)]


def _bf16_arrays(n: int, S: int, d: int, seed: int):
    """``n`` (2, S, d) arrays, rounded to bf16, as numpy f32 and as torch
    bf16 (the same values on both sides)."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal((2, S, d), dtype=np.float32)).to(torch.bfloat16)
          for _ in range(n)]
    return [t.float().numpy() for t in ts], ts


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,block", WIDE_BF16_LENGTHS)
@pytest.mark.parametrize("d", [136, 192, 256])
def test_wide_bf16_forward_matches_jax_at_ragged_lengths(d, S, block, causal) -> None:
    """o and lse at the wide head dims (BH 2, bf16) and lengths that end
    inside a key tile of the wide bf16 forward kernel: the port's plain path
    and the emulation of the kernel's arithmetic
    (fa.flash_fwd_bf16_wide_emulated: 64-key tiles, the scores scaled after
    the dot, P rounded to bf16 for P V, O times 1 / l) against the JAX package's Pallas kernel
    in interpret mode, at the JAX tests' bf16 forward bar (3e-2, o and
    lse)."""
    assert S % fa.BF16_KEYS and fa.kernel_width(d, torch.bfloat16) == 256
    arrays, (q, k, v) = _bf16_arrays(3, S, d, seed=S + d + 2)
    fwd_impl, _ = _make_flash_parts(causal, None, block, block, True)
    jo, jlse = fwd_impl(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays))
    for fwd in (fa.flash_fwd, fa.flash_fwd_bf16_wide_emulated):
        o, lse = fwd(q, k, v, causal=causal)
        assert o.shape == (2, S, d) and o.dtype == torch.bfloat16 and lse.shape == (2, S)
        np.testing.assert_allclose(_np(o), _np(jo), atol=FWD_ATOL["bfloat16"], rtol=0)
        np.testing.assert_allclose(_np(lse), _np(jlse)[..., 0], atol=FWD_ATOL["bfloat16"], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,block", WIDE_BF16_LENGTHS)
@pytest.mark.parametrize("d", [136, 192, 256])
def test_wide_bf16_backward_matches_jax_at_ragged_lengths(d, S, block, causal) -> None:
    """dq, dk and dv at the wide head dims (BH 2, bf16) and lengths that
    end inside a q tile of the wide bf16 dk/dv kernel, from the JAX
    forward's lse and delta = rowsum(dO o): the port's plain path and the
    emulation of the kernels' arithmetic (fa.flash_bwd_bf16_wide_emulated:
    P and dS rounded to bf16 for the products that take them) against the
    JAX package's Pallas kernels in interpret mode, at the JAX tests' bf16
    gradient bar (0.1)."""
    assert S % fa.BF16_KEYS and fa.kernel_width(d, torch.bfloat16) == 256
    arrays, (q, k, v, g) = _bf16_arrays(4, S, d, seed=S + d + 3)
    fwd_impl, bwd_impl = _make_flash_parts(causal, None, block, block, True)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    jo, jlse = fwd_impl(jq, jk, jv)
    jdelta = jnp.sum(jo.astype(jnp.float32) * jg.astype(jnp.float32), axis=-1, keepdims=True)
    jgrads = bwd_impl(jq, jk, jv, jg, jlse, jdelta)
    lse, delta = (torch.from_numpy(np.asarray(x)[..., 0].copy()) for x in (jlse, jdelta))
    for bwd in (fa.flash_bwd, fa.flash_bwd_bf16_wide_emulated):
        grads = bwd(q, k, v, g, lse, delta, causal=causal)
        for a, b in zip(grads, jgrads):
            assert a.dtype == torch.bfloat16 and a.shape == q.shape
            np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL["bfloat16"], rtol=0)
