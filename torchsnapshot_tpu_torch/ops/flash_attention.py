"""Flash attention: hand-written Hopper kernels and their plain versions.

Counterpart of ``torchsnapshot_tpu/ops/pallas_attention.py``. Each TPU
kernel becomes CUDA C++ for ``sm_90a`` bound through ``ctypes``:

- ``_kernel`` (pallas_attention.py:44-91, launched by ``fwd_impl`` at :237)
  becomes ``csrc/flash_fwd.cu``;
- ``_bwd_dq_kernel`` (:94-143, called at :263) and ``_bwd_dkv_kernel``
  (:146-200, called at :278) become the dq and dk/dv kernels of
  ``csrc/flash_bwd.cu``.

Each launcher picks its kernel by dtype and head dim. The kernels take
float32, bfloat16 and float16 (:data:`KERNEL_DTYPES`); any other dtype
raises ``TypeError`` (float64 among them: the JAX package runs with x64
off, so its model never holds f64 activations). Up to ``d = 256`` every
kernel is a tensor-core kernel (wgmma fed by TMA, the Hopper pieces in
``csrc/hopper.cuh``). For bf16 and f16 the products run on 16-bit
operands (one kernel template for both, the element type its parameter).
For f32 every product of the forward and of both backward kernels runs as
three TF32 products (the error-compensated split of :func:`split_tf32`,
which holds the f32 bars, 1e-5 forward and 1e-4 gradients, where one TF32
product does not). Every tensor-core kernel loads through TMA, so each
takes operands that start on 16-byte boundaries.

Head dims (:func:`kernel_width`): every ``d >= 1``, with no upper bound.
The kernels take a row, ``d`` times the element size, that is a multiple
of 16 bytes, the global stride TMA takes; the wrappers run any other
``d`` on operands zero-padded to :func:`padded_dim` (bf16 and f16 to a
multiple of 8, f32 of 4) and slice the results back. Zero columns of q
and k add exactly zero to the scores; zero columns of v and dO leave
zeros in o, dq, dk and dv, which are cut off. The scale is the caller's, ``d ** -0.5`` of the unpadded ``d`` by
default, resolved before the pad. The kernels are built for three tile
widths, 64 (padded ``d <= 64``), 128 (``<= 128``) and 256, and take the
padded ``d`` at run time: TMA lands zeros in a tile's columns past it, and
the stores write the columns below it alone. At width 256 a block runs
two warpgroups, and the f32 kernels stream their operands in 32-column
chunks of ``d`` (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``). Past 256
(``kernel_width`` returns :data:`DEEP`) the deep forms run, a block for
each 64 rows and up to 320-512 columns of an output, computing the scores
over the whole of ``d`` in chunks: all three kernels in every dtype, on
the tensor cores (TMA, wgmma; 16-bit operands, f32 as three TF32
products).

The split of ``_make_flash_parts`` is kept: :func:`flash_fwd` is the raw
``(q, k, v) -> (o, lse)`` and :func:`flash_bwd` the raw
``(q, k, v, dO, lse, delta) -> (dq, dk, dv)`` on ``(BH, S, D)`` operands,
with global lse and delta, so ring attention can drive both per hop.
:func:`flash_attention` is the ``(B, S, H, D)`` wrapper with the JAX block
contract, differentiable through a ``torch.autograd.Function`` (the
counterpart of ``_make_flash``'s ``custom_vjp``), and
:func:`flash_attention_sharded` runs it on each rank's block under a mesh.

On CPU tensors the raw functions compute their plain versions
(:func:`flash_fwd_reference`, :func:`flash_bwd_reference`), dense f32 with
the same masking. On CUDA tensors they launch the kernels or raise; they
never fall back. Each launch adds one to its kernel's count:
``flash_fwd.launches``, ``flash_bwd_dq.launches``,
``flash_bwd_dkv.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import NEG_INF, pick_block_size

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPE_CODES)
# The tile widths the tensor-core kernels are built for (hopper::tile_width).
TILE_WIDTHS = (64, 128, 256)
# kernel_width's answer past the widest tile: the deep forms
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu, "head dims over 256").
DEEP = 0
TMA_ALIGN = 16  # bytes: TMA reads only from 16-byte-aligned global addresses


def padded_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim the kernels run ``d`` at: the least ``d' >= d`` whose
    row of ``d'`` elements is a multiple of 16 bytes (TMA's global stride:
    bf16 and f16 a multiple of 8, f32 of 4), at every ``d``."""
    per = TMA_ALIGN // dtype.itemsize
    return -(-d // per) * per


def kernel_width(d: int, dtype: torch.dtype) -> int:
    """The tile width (64, 128 or 256) of the kernels that run head dim
    ``d`` in ``dtype``: the least of :data:`TILE_WIDTHS` that holds
    :func:`padded_dim`; :data:`DEEP` for ``d > 256``, which the deep forms
    run at :func:`padded_dim` too. Raises ``ValueError`` for ``d < 1``."""
    if d < 1:
        raise ValueError(f"flash kernels take every head_dim d >= 1, got d = {d}")
    if d > TILE_WIDTHS[-1]:
        return DEEP
    width = padded_dim(d, dtype)
    return next(w for w in TILE_WIDTHS if width <= w)


def _mask_causal(s: torch.Tensor) -> torch.Tensor:
    """Scores ``(BH, Sq, Sk)`` with NEG_INF where a key is in the query's
    future (a tie attends)."""
    q_pos = torch.arange(s.shape[1], device=s.device)
    k_pos = torch.arange(s.shape[2], device=s.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, NEG_INF))


def _causal_scores(
    q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float, prescale: bool
) -> torch.Tensor:
    """f32 scores ``(BH, Sq, Sk)`` with NEG_INF where masked (a tie attends).
    The forward kernel pre-scales q, the backward kernels scale the dot."""
    if prescale:
        s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    else:
        s = scale * torch.matmul(q.float(), k.float().transpose(1, 2))
    return _mask_causal(s) if causal else s


def flash_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel on ``(BH, S, D)``: ``o`` in the
    input dtype and ``lse`` (BH, S) in f32, from a dense f32 softmax of the
    pre-scaled scores with NEG_INF masking (a tie attends)."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    s = _causal_scores(q, k, causal, scale, prescale=True)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _bwd_p_ds(q, k, v, dO, lse, delta, causal, scale):
    s = _causal_scores(q, k, causal, scale, prescale=False)
    p = torch.exp(s - lse[..., None])  # masked entries underflow to 0
    dp = torch.matmul(dO.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """Plain version of the dq kernel: ``scale * ds @ k`` in q's dtype."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    _, ds = _bwd_p_ds(q, k, v, dO, lse, delta, causal, scale)
    return (scale * torch.matmul(ds, k.float())).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """Plain version of the dk/dv kernel: ``(scale * ds^T @ q, p^T @ dO)``
    in the dtypes of k and v."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    p, ds = _bwd_p_ds(q, k, v, dO, lse, delta, causal, scale)
    dk = scale * torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), dO.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dO: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels on ``(BH, S, D)`` operands and
    ``(BH, S)`` f32 lse and delta: a dense f32 recompute of
    ``p = exp(scale * q k^T - lse)`` with the forward's masking, then
    ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    dq = flash_bwd_dq_reference(q, k, v, dO, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dO, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


TF32_DROP = 0x1FFF  # the 13 low mantissa bits a tf32 value does not keep
# The NaN the card's f32 arithmetic returns (x86 returns a payload or
# 0xFFC00000 instead).
CANONICAL_NAN = 0x7FFFFFFF


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    does on the card: a finite value to nearest, ties away from zero,
    subnormals kept, past the largest tf32 to infinity; then every pattern,
    infinities and NaNs too, drops its 13 low bits (a NaN keeps its sign
    and the top of its payload, and one whose payload is all in those bits
    becomes an infinity)."""
    bits = x.float().contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    # The sign is its own bit, so adding half of the dropped part to the
    # pattern rounds the magnitude half away from zero.
    half = torch.where(finite, (TF32_DROP + 1) // 2, 0).to(torch.int32)
    return ((bits + half) & ~TF32_DROP).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error-compensated split of the f32 backward kernels: ``hi =
    tf32(x)`` and ``lo = tf32(x - hi)``, so that ``hi + lo`` keeps about 21
    of x's 24 significant bits. Where ``x - hi`` is NaN (x an infinity or a
    NaN) it is the card's canonical NaN, as the kernels compute it."""
    hi = round_tf32(x)
    rem = x.float() - hi
    rem = torch.where(torch.isnan(rem), torch.tensor(CANONICAL_NAN, dtype=torch.int32)
                      .view(torch.float32), rem)
    return hi, round_tf32(rem)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the f32 backward kernels compute it: ``a_lo b_hi + a_hi
    b_lo + a_hi b_hi`` summed in f32, small terms first (each product of two
    tf32 values is exact in f32). A plain emulation for the tests and the
    card's checks; nothing on the main path calls it."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    out = torch.matmul(a_lo, b_hi)
    out = out + torch.matmul(a_hi, b_lo)
    return out + torch.matmul(a_hi, b_hi)


def fwd_tf32_rows(head_dim: int) -> int:
    """Key rows a tile of the f32 forward kernel streams: 64 at tile width
    64, 32 at 128, 64 at 256 and past it (``Tf32Fwd<W>::BK``, ``WIDE_BK``
    and ``DEEP_BK`` in ``csrc/flash_fwd.cu``), the width of
    :func:`padded_dim`. Raises ``ValueError`` for ``d < 1``."""
    return {64: 64, 128: 32, 256: 64, DEEP: 64}[kernel_width(head_dim, torch.float32)]


def bwd_tf32_rows(head_dim: int) -> Tuple[int, int]:
    """Rows a tile of the f32 backward kernels streams, as (dq's key rows,
    dk/dv's q rows): (64, 64) at tile width 64, (32, 16) at 128, and (64,
    32) at 256 and past it, where the deep kernels stream the W = 256
    kernels' tiles (``Tf32Tiles<W>``, ``WIDE_DQ_KEYS`` and
    ``WIDE_DKV_ROWS`` in ``csrc/flash_bwd.cu``). Raises ``ValueError`` for
    ``d < 1``."""
    width = kernel_width(head_dim, torch.float32)
    return {64: (64, 64), 128: (32, 16), 256: (64, 32), DEEP: (64, 32)}[width]


# Columns of d a score product of the wide f32 forward sums fresh (a TMA box
# of 32 f32 columns).
WIDE_CHUNK = 32
# 64-column groups of O a warpgroup of the deep forward kernels owns
# (DEEP16_GROUPS and DEEP32_GROUPS in csrc/flash_fwd.cu).
DEEP_GROUPS = {torch.bfloat16: 4, torch.float16: 4, torch.float32: 3}


def deep_score_chunks(d: int, dtype: torch.dtype) -> int:
    """Score chunks (128-byte boxes of q and k: 64 columns in 16 bits, 32
    in f32) that warpgroup 0 of a deep forward block takes at padded head
    dim ``d > 256``, warpgroup 1 the rest (``deep_part`` in
    ``csrc/flash_fwd.cu``, for the block that owns O's first columns):
    warpgroup 0 owns the first half of the block's 64-column groups of O,
    rounded up, and the chunks part so that both issue about the same
    products (a chunk one unit, a group one in 16 bits and two in f32)."""
    groups, chunk = DEEP_GROUPS[dtype], TMA_ALIGN * 8 // dtype.itemsize
    unit = 2 if dtype == torch.float32 else 1
    ng = min(2 * groups, -(-d // 64))
    nc = -(-d // chunk)
    return max(0, min(nc, (nc + unit * (ng - 2 * ((ng + 1) // 2))) // 2))


def _scores_3xtf32_chunked(a: torch.Tensor, b: torch.Tensor, first: Optional[int] = None
                           ) -> torch.Tensor:
    """``a @ b`` (``b`` ``(D, N)``) as the wide f32 forward sums it: each
    :data:`WIDE_CHUNK` columns of D as :func:`matmul_3xtf32`, fresh, added
    in f32 chunk after chunk in two parts (its two warpgroups: the first
    ``first`` of the n chunks, ``ceil(n / 2)`` by default, then the rest),
    and the parts added."""
    chunks = range(0, a.shape[-1], WIDE_CHUNK)
    first = (len(chunks) + 1) // 2 if first is None else first
    halves = []
    for part in (chunks[:first], chunks[first:]):
        acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32, device=a.device)
        for c in part:
            acc = acc + matmul_3xtf32(a[..., c:c + WIDE_CHUNK], b[..., c:c + WIDE_CHUNK, :])
        halves.append(acc)
    return halves[0] + halves[1]


def flash_fwd_tf32_emulated(q, k, v, *, causal=True, scale=None):
    """The f32 forward kernel's arithmetic in its own order, in f32: q
    pre-scaled; key tiles of :func:`fwd_tf32_rows` rows with the online
    softmax; each tile's scores as :func:`matmul_3xtf32`; P = exp(s - m)
    from the running max, split as the operand of the tile's P V, which
    sums fresh and is added to the running output in f32; ``o / l`` and
    ``m + log(l)`` at the end. At tile width 256 and past it (the deep
    kernel) the kernels' own order: the scores as
    :func:`_scores_3xtf32_chunked` (past 256 parted as
    :func:`deep_score_chunks`), and P V by halves of the tile's keys, the
    first half's product added with the rescale, the second's after it.
    For the tests and the card's checks only."""
    BH, S, D = q.shape
    if scale is None:
        scale = D**-0.5
    qs, k, v = q.float() * scale, k.float(), v.float()
    bk = fwd_tf32_rows(D)
    width = kernel_width(D, torch.float32)
    wide = width in (TILE_WIDTHS[-1], DEEP)
    first = deep_score_chunks(D, torch.float32) if width == DEEP else None
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((BH, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((BH, S, 1), device=q.device)
    o = torch.zeros((BH, S, D), device=q.device)
    for k0 in range(0, S, bk):
        kt, vt = k[:, k0:k0 + bk].transpose(1, 2), v[:, k0:k0 + bk]
        s = _scores_3xtf32_chunked(qs, kt, first) if wide else matmul_3xtf32(qs, kt)
        if causal:
            k_pos = torch.arange(k0, k0 + s.shape[2], device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        h = bk // 2 if wide else bk
        o = o * alpha + matmul_3xtf32(p[..., :h], vt[:, :h])
        if p.shape[-1] > h:
            o = o + matmul_3xtf32(p[..., h:], vt[:, h:])
        m = m_new
    return o / l, (m + torch.log(l)).squeeze(-1)


def flash_bwd_tf32_emulated(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """The plain backward with all five products as :func:`matmul_3xtf32`,
    in f32: what the f32 backward kernels compute at every head dim, past
    d = 256 too, up to their summation order. For the tests and the card's
    checks only."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    q, k, v, dO = (t.float() for t in (q, k, v, dO))
    s = scale * matmul_3xtf32(q, k.transpose(1, 2))
    if causal:
        s = _mask_causal(s)
    p = torch.exp(s - lse[..., None])
    ds = p * (matmul_3xtf32(dO, v.transpose(1, 2)) - delta[..., None])
    dq = scale * matmul_3xtf32(ds, k)
    dk = scale * matmul_3xtf32(ds.transpose(1, 2), q)
    dv = matmul_3xtf32(p.transpose(1, 2), dO)
    return dq, dk, dv


# Keys a tile of the bf16 forward kernels streams.
BF16_KEYS = 64


def flash_fwd_bf16_wide_emulated(q, k, v, *, causal=True, scale=None):
    """The 16-bit forward kernels' arithmetic at tile width 256 and past it
    (the deep kernel) in their own order, in f32 on the inputs: key tiles
    of :data:`BF16_KEYS` with the online softmax; each tile's scores over
    the whole of d, scaled after the dot; P = exp(s - m) from the running
    max, rounded to the input's 16-bit dtype (bf16 for any other) as the
    operand of the tile's P V, its f32 values in the row sums; o = O times
    1 / l in the input dtype, lse = m + log(l). For the tests and the
    card's checks only."""
    BH, S, D = q.shape
    if scale is None:
        scale = D**-0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    p_dtype = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.bfloat16
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((BH, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((BH, S, 1), device=q.device)
    o = torch.zeros((BH, S, D), device=q.device)
    for k0 in range(0, S, BF16_KEYS):
        kt, vt = kf[:, k0:k0 + BF16_KEYS].transpose(1, 2), vf[:, k0:k0 + BF16_KEYS]
        s = torch.matmul(qf, kt) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + s.shape[2], device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(p_dtype).float(), vt)
        m = m_new
    return (o * (1.0 / l)).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_bf16_wide_emulated(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """The 16-bit backward kernels' arithmetic at tile width 256 and past
    it (the deep kernels), in f32 on the inputs: the scores and dO V^T over
    the whole of d (the dk/dv kernels run S^T = K Q^T in one warpgroup and
    dP^T = V dO^T in the other), P = exp(scale s - lse) in f32, dS = P (dP
    - delta) from the f32 P, and P and dS rounded to the input's 16-bit
    dtype (bf16 for any other) as the operands of dV = P^T dO, dK = scale
    dS^T Q and dQ = scale dS K; f16 rounds scale dS, the scale folded in
    before the rounding (the kernels' ``ds_scales``), bf16 dS as it is.
    ``(dq, dk, dv)`` in the dtypes of q, k and v. For the tests and the
    card's checks only."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    round_to = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.bfloat16
    fold = round_to == torch.float16
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dO))
    s = scale * torch.matmul(qf, kf.transpose(1, 2))
    if causal:
        s = _mask_causal(s)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(gf, vf.transpose(1, 2)) - delta[..., None])
    p, ds = p.to(round_to).float(), ((scale if fold else 1.0) * ds).to(round_to).float()
    ds_scale = 1.0 if fold else scale
    dq = ds_scale * torch.matmul(ds, kf)
    dk = ds_scale * torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.transpose(1, 2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_kernel_dtype(dtype: torch.dtype, what: str = "flash") -> None:
    """Raise ``TypeError`` naming ``dtype`` unless the kernels take it
    (:data:`KERNEL_DTYPES`)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernels take float32, bfloat16 or float16, got {dtype}")


def _check_kernel_args(kernel: str, q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> None:
    """What every kernel wrapper checks: CUDA ``(BH, S, D)`` operands of q's
    shape, dtype and device, a dtype the kernels are built for, ``D >= 1``,
    contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"{kernel} takes (BH, S, D) operands, got shape {tuple(q.shape)}")
    for name, t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{kernel}: {name} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                f"match q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    check_kernel_dtype(q.dtype, kernel)
    kernel_width(q.shape[2], q.dtype)
    for name, t in (("q", q), *others):
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes contiguous operands; {name} is not")


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended to its last dim up to ``width``: a
    new contiguous tensor (``t`` itself where it is that wide)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def fwd_on_padded(fwd, q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """``fwd(q, k, v)`` (a forward on ``(BH, S, D)``) run at
    :func:`padded_dim`: the scale resolved from the caller's ``D`` first,
    the operands zero-padded, ``o`` sliced back to ``D``."""
    D = q.shape[-1]
    scale = D**-0.5 if scale is None else scale
    width = padded_dim(D, q.dtype)
    if width == D:
        return fwd(q, k, v, causal=causal, scale=scale)
    o, lse = fwd(*(pad_head_dim(t, width) for t in (q, k, v)), causal=causal, scale=scale)
    return o[..., :D].contiguous(), lse


def bwd_on_padded(bwd, q, k, v, dO, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None):
    """``bwd(q, k, v, dO, lse, delta)`` (a backward returning gradients of
    the four operands' shape) run at :func:`padded_dim`, as
    :func:`fwd_on_padded` runs a forward; each gradient sliced back to
    ``D``."""
    D = q.shape[-1]
    scale = D**-0.5 if scale is None else scale
    width = padded_dim(D, q.dtype)
    if width == D:
        return bwd(q, k, v, dO, lse, delta, causal=causal, scale=scale)
    padded = [pad_head_dim(t, width) for t in (q, k, v, dO)]
    grads = bwd(*padded, lse, delta, causal=causal, scale=scale)
    grads = grads if isinstance(grads, tuple) else (grads,)
    out = tuple(g[..., :D].contiguous() for g in grads)
    return out if len(out) > 1 else out[0]


def _check_aligned(kernel: str, *named: Tuple[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless every tensor starts on a 16-byte
    boundary, as the TMA loads of the kernels need (a contiguous view at an
    odd offset into its storage may not)."""
    for name, t in named:
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(
                f"{kernel} kernel takes operands aligned to {TMA_ALIGN} bytes (TMA); {name} "
                f"starts at data_ptr() % {TMA_ALIGN} = {t.data_ptr() % TMA_ALIGN}"
            )


def _check_stats(kernel: str, q: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"{kernel}: {name} must be float32 {tuple(q.shape[:2])} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes contiguous operands; {name} is not")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C launchers of each source: pointers and the stream as c_void_p (a plain
# int would cut a pointer to 32 bits), then BH, S, D, dtype, causal, scale.
_SIGNATURES: Dict[str, Dict[str, List[Any]]] = {
    "flash_fwd": {"flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _P]},
    "flash_bwd": {
        "flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _P],
        "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _P],
        "tf32_split_probe": [_P] * 3 + [_I, _P],
        "tf32_relayout_probe": [_P] * 3 + [_I, _P],
    },
}


def _lib(source: str) -> ctypes.CDLL:
    """``csrc/<source>.cu``'s library, built at first use, typed."""
    from . import _build

    lib = _build.load(source)
    if not getattr(lib, "_typed", False):
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(source: str, fn: str, q: torch.Tensor, causal: bool, scale: float, *ptrs) -> None:
    """Call the C launcher ``fn`` of ``source`` on q's current stream with
    the data pointers ``ptrs``; raise on the error it returns."""
    lib = _lib(source)
    BH, S, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn)(
            *ptrs, BH, S, D, _DTYPE_CODES[q.dtype], int(bool(causal)), float(scale), stream
        )
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(
            f"{fn} kernel launch failed: {msg} (BH={BH}, S={S}, D={D}, dtype={q.dtype})"
        )


def _fwd_launch(q, k, v, *, causal: bool, scale: float):
    _check_aligned("flash_fwd", ("q", q), ("k", k), ("v", v))
    BH, S, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd", q, causal, scale,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    flash_fwd.launches += 1
    return o, lse


def flash_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA ``(BH, S, D)`` operands, on the
    current stream: the bf16 or f16 wgmma kernel, for f32 the 3xTF32 wgmma
    kernel, past D = 256 the deep form; at :func:`padded_dim` (see
    :func:`fwd_on_padded`). Raises on anything the kernels do not take."""
    _check_kernel_args("flash_fwd", q, ("k", k), ("v", v))
    return fwd_on_padded(_fwd_launch, q, k, v, causal=causal, scale=scale)


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw forward on ``(BH, S, D)``: ``(o normalized, lse)``. The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return flash_fwd_reference(q, k, v, causal=causal, scale=scale)


flash_fwd.launches = 0


def _bwd_args(kernel, q, k, v, dO, lse, delta, scale) -> float:
    """Check the backward's operands; the scale, ``D ** -0.5`` of the
    caller's ``D`` unless given."""
    _check_kernel_args(kernel, q, ("k", k), ("v", v), ("dO", dO))
    _check_stats(kernel, q, lse, delta)
    return q.shape[2] ** -0.5 if scale is None else scale


def _dq_launch(q, k, v, dO, lse, delta, *, causal: bool, scale: float) -> torch.Tensor:
    _check_aligned("flash_bwd_dq", ("q", q), ("k", k), ("v", v), ("dO", dO))
    dq = torch.empty_like(q)
    _launch("flash_bwd", "flash_bwd_dq", q, causal, scale,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    flash_bwd_dq.launches += 1
    return dq


def _dkv_launch(q, k, v, dO, lse, delta, *, causal: bool, scale: float):
    _check_aligned("flash_bwd_dkv", ("q", q), ("k", k), ("v", v), ("dO", dO))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", "flash_bwd_dkv", q, causal, scale,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    flash_bwd_dkv.launches += 1
    return dk, dv


def _bwd_launch(*args, causal: bool, scale: float):
    dq = _dq_launch(*args, causal=causal, scale=scale)
    return (dq, *_dkv_launch(*args, causal=causal, scale=scale))


def flash_bwd_dq(q, k, v, dO, lse, delta, *, causal=True, scale=None) -> torch.Tensor:
    """Launch the dq kernel (K2) on CUDA operands: dq in q's dtype. The
    bf16 or f16 wgmma kernel, for f32 the 3xTF32 wgmma kernel, past D = 256
    the deep form; at :func:`padded_dim` (see :func:`bwd_on_padded`)."""
    scale = _bwd_args("flash_bwd_dq", q, k, v, dO, lse, delta, scale)
    return bwd_on_padded(_dq_launch, q, k, v, dO, lse, delta, causal=causal, scale=scale)


def flash_bwd_dkv(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """Launch the dk/dv kernel (K3) on CUDA operands: ``(dk, dv)`` in the
    dtypes of k and v, by the forms of :func:`flash_bwd_dq`."""
    scale = _bwd_args("flash_bwd_dkv", q, k, v, dO, lse, delta, scale)
    return bwd_on_padded(_dkv_launch, q, k, v, dO, lse, delta, causal=causal, scale=scale)


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _probe(fn: str, ref: torch.Tensor, *ptrs) -> None:
    lib = _lib("flash_bwd")
    with torch.cuda.device(ref.device):
        err = getattr(lib, fn)(*ptrs, torch.cuda.current_stream(ref.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.flash_bwd_error_string(err).decode()}")


def tf32_split_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 backward kernels' split of a CUDA f32 tensor, on the card:
    ``(hi, lo)`` as the kernels leave them (a check of :func:`split_tf32`)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError("tf32_split_cuda takes a non-empty CUDA float32 tensor")
    x = x.contiguous()
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    _probe("tf32_split_probe", x, x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel())
    return hi, lo


def tf32_relayout_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` (x 64 x 64, y 64 x N, N 64 or 128, CUDA f32) by the path
    of the f32 backward kernels' last products alone: x through an
    accumulator fragment into 3xTF32 A fragments, y through the split
    pass's permuted transposed copy (a check of the fragment re-layout)."""
    n = y.shape[1] if y.dim() == 2 else 0
    if (x.shape != (64, 64) or y.dim() != 2 or y.shape[0] != 64 or n not in (64, 128)
            or x.dtype != torch.float32 or y.dtype != torch.float32
            or x.device.type != "cuda" or y.device != x.device):
        raise ValueError("tf32_relayout_cuda takes CUDA float32 x (64, 64) and y (64, 64 or 128)")
    x, y = x.contiguous(), y.contiguous()
    c = torch.empty((64, n), dtype=torch.float32, device=x.device)
    _probe("tf32_relayout_probe", x, x.data_ptr(), y.data_ptr(), c.data_ptr(), n)
    return c


def flash_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dO: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch both backward kernels on CUDA operands, on the current
    stream, the operands padded once for both. Raises on anything the
    kernels do not take."""
    scale = _bwd_args("flash_bwd", q, k, v, dO, lse, delta, scale)
    return bwd_on_padded(_bwd_launch, q, k, v, dO, lse, delta, causal=causal, scale=scale)


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dO: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw backward on ``(BH, S, D)`` with the global ``(BH, S)`` f32 lse
    and ``delta = rowsum(dO * o)``: ``(dq, dk, dv)``. Exact also when lse
    and delta cover more keys than the k and v given (one ring hop). The
    kernels on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cuda":
        return flash_bwd_cuda(q, k, v, dO, lse, delta, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    return flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_make_flash``'s ``custom_vjp`` (pallas_attention.py
    :304-328) on ``(BH, S, D)`` operands: the forward kernel, and a
    backward through the two backward kernels with ``delta = rowsum(dO *
    o)`` taken in f32 outside them, as the JAX package takes it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dO):
        q, k, v, o, lse = ctx.saved_tensors
        # Autograd hands in a view transposed from (B, S, H, D): the
        # kernels take contiguous (BH, S, D).
        dO = dO.contiguous()
        delta = (dO.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_bwd(
            q, k, v, dO.to(q.dtype), lse, delta, causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def check_blocks(n: int, block_q: Optional[int], block_k: Optional[int],
                 what: str = "seq len") -> None:
    """The block contract of the JAX wrappers (pallas_attention.py:354-368,
    ring_flash.py:178-189): default blocks snap to the largest divisor of
    ``n`` up to 512, and explicit blocks that do not divide ``n`` raise
    ``ValueError``. The kernels' own tiles are independent of the blocks,
    which only gate the call."""
    if block_q is None:
        block_q = pick_block_size(n, 512) or min(512, n)
    if block_k is None:
        block_k = pick_block_size(n, 512) or min(512, n)
    block_q, block_k = min(block_q, n), min(block_k, n)
    if n % block_q or n % block_k:
        raise ValueError(
            f"{what} {n} must be divisible by block_q={block_q} and block_k={block_k}"
        )


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
          scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on ``(B, S, H, D)``, differentiable, with no block
    contract: the kernels tile any S themselves. The model's routes call
    it, so that a CUDA tensor reaches the kernels whatever its length. A
    head dim whose row the tensor-core kernels do not take is zero-padded
    to :func:`padded_dim` in the layout copy the kernels need anyway, and
    ``o`` sliced back; the scale is resolved from ``D`` first."""
    B, S, H, D = q.shape
    scale = D**-0.5 if scale is None else scale
    width = padded_dim(D, q.dtype)

    def bh(t: torch.Tensor) -> torch.Tensor:
        # One copy into the kernels' layout, padded where the width is not D.
        return pad_head_dim(t.transpose(1, 2), width).reshape(B * H, S, width).contiguous()

    o = _FlashAttention.apply(bh(q), bh(k), bh(v), causal, scale)
    return o.reshape(B, H, S, width).transpose(1, 2)[..., :D]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention on ``(B, S, H, D)``, differentiable, under the block
    contract of :func:`check_blocks`."""
    check_blocks(q.shape[1], block_q, block_k)
    return flash(q, k, v, causal=causal, scale=scale)


def flash_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    batch_axis: Optional[str] = "data",
    head_axis: Optional[str] = "model",
) -> torch.Tensor:
    """Flash attention on global ``(B, S, H, D)`` tensors under a mesh
    (pallas_attention.py:381-428): each rank runs the kernels on its
    ``(B_l, S, H_l, D)`` block, batch over ``batch_axis`` and heads over
    ``head_axis`` where the mesh has them, with no communication inside.
    Heads and batch must divide their axes."""
    from ..parallel.mesh import P, axis_size, shard_map

    names = mesh.mesh_dim_names
    b = batch_axis if batch_axis in names else None
    h = head_axis if head_axis in names else None
    if h is not None and q.shape[2] % axis_size(mesh, h):
        raise ValueError(
            f"flash_attention_sharded needs heads ({q.shape[2]}) divisible by the "
            f"{h!r} axis size ({axis_size(mesh, h)})"
        )
    if b is not None and q.shape[0] % axis_size(mesh, b):
        raise ValueError(
            f"flash_attention_sharded needs batch ({q.shape[0]}) divisible by the "
            f"{b!r} axis size ({axis_size(mesh, b)})"
        )
    spec = P(b, None, h, None)

    check_blocks(q.shape[1], None, None)
    body = functools.partial(flash, causal=causal, scale=scale)
    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)
