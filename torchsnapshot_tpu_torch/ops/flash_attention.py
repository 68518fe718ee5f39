"""Flash attention: hand-written Hopper kernels and their plain versions.

Counterpart of ``torchsnapshot_tpu/ops/pallas_attention.py``. Each TPU
kernel becomes CUDA C++ for ``sm_90a`` bound through ``ctypes``:

- ``_kernel`` (pallas_attention.py:44-91, launched by ``fwd_impl`` at :237)
  becomes ``csrc/flash_fwd.cu``;
- ``_bwd_dq_kernel`` (:94-143, called at :263) and ``_bwd_dkv_kernel``
  (:146-200, called at :278) become the dq and dk/dv kernels of
  ``csrc/flash_bwd.cu``.

Each launcher picks its kernel by dtype alone: for bf16 a tensor-core
kernel (wgmma fed by TMA, the Hopper pieces in ``csrc/hopper.cuh``), for
f32 an FFMA kernel (the f32 bars, 1e-5 forward and 1e-4 gradients, forbid
TF32). The bf16 kernels load through TMA, so their operands must start on
16-byte boundaries.

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

from .attention import NEG_INF, pick_block_size

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _causal_scores(
    q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float, prescale: bool
) -> torch.Tensor:
    """f32 scores ``(BH, Sq, Sk)`` with NEG_INF where masked (a tie attends).
    The forward kernel pre-scales q, the backward kernels scale the dot."""
    if prescale:
        s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    else:
        s = scale * torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, NEG_INF))
    return s


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


def _check_kernel_args(kernel: str, q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> None:
    """What every kernel wrapper checks: CUDA ``(BH, S, D)`` operands of q's
    shape, dtype and device, a dtype and head_dim the kernels are built
    for, contiguous."""
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
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head_dim in {_HEAD_DIMS}, got {q.shape[2]}")
    for name, t in (("q", q), *others):
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes contiguous operands; {name} is not")


TMA_ALIGN = 16  # bytes: TMA reads only from 16-byte-aligned global addresses


def _check_aligned(kernel: str, *named: Tuple[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless every tensor starts on a 16-byte
    boundary, as the TMA loads of the bf16 kernels need (a contiguous view
    at an odd offset into its storage may not)."""
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


def flash_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA ``(BH, S, D)`` operands, on the
    current stream: the wgmma kernel for bf16, the FFMA kernel for f32.
    Raises on anything the kernel does not take."""
    _check_kernel_args("flash_fwd", q, ("k", k), ("v", v))
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_fwd", ("q", q), ("k", k), ("v", v))
    BH, S, D = q.shape
    if scale is None:
        scale = D**-0.5
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd", q, causal, scale,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    flash_fwd.launches += 1
    return o, lse


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
    _check_kernel_args(kernel, q, ("k", k), ("v", v), ("dO", dO))
    _check_stats(kernel, q, lse, delta)
    if q.dtype == torch.bfloat16:
        _check_aligned(kernel, ("q", q), ("k", k), ("v", v), ("dO", dO))
    return q.shape[2] ** -0.5 if scale is None else scale


def flash_bwd_dq(q, k, v, dO, lse, delta, *, causal=True, scale=None) -> torch.Tensor:
    """Launch the dq kernel (K2) on CUDA operands: dq in q's dtype. The
    wgmma kernel for bf16, the FFMA kernel for f32."""
    scale = _bwd_args("flash_bwd_dq", q, k, v, dO, lse, delta, scale)
    dq = torch.empty_like(q)
    _launch("flash_bwd", "flash_bwd_dq", q, causal, scale,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """Launch the dk/dv kernel (K3) on CUDA operands: ``(dk, dv)`` in the
    dtypes of k and v. The wgmma kernel for bf16, the FFMA kernel for f32."""
    scale = _bwd_args("flash_bwd_dkv", q, k, v, dO, lse, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", "flash_bwd_dkv", q, causal, scale,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


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
    stream. Raises on anything the kernels do not take."""
    dq = flash_bwd_dq(q, k, v, dO, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv(q, k, v, dO, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


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
    it, so that a CUDA tensor reaches the kernels whatever its length."""
    B, S, H, D = q.shape

    def bh(t: torch.Tensor) -> torch.Tensor:
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()

    o = _FlashAttention.apply(bh(q), bh(k), bh(v), causal, scale)
    return o.reshape(B, H, S, D).transpose(1, 2)


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
