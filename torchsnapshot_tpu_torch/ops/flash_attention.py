"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Counterpart of ``torchsnapshot_tpu/ops/pallas_attention.py``. The TPU
kernel ``_kernel`` (pallas_attention.py:44-91, launched by ``fwd_impl`` at
:237) becomes ``csrc/flash_fwd.cu``, CUDA C++ for ``sm_90a`` bound through
``ctypes``. The split of ``_make_flash_parts`` is kept: :func:`flash_fwd`
is the raw ``(q, k, v) -> (o, lse)`` on ``(BH, S, D)`` operands, and
:func:`flash_attention` is the ``(B, S, H, D)`` wrapper with the JAX block
contract. Ring attention drives the raw function per hop, so it stays
public.

On a CPU tensor :func:`flash_fwd` computes :func:`flash_fwd_reference`, a
dense f32 softmax with the same masking and the same lse. On a CUDA tensor
it launches the kernel or raises; it never falls back. Each launch adds one
to ``flash_fwd.launches``.

Only the forward is ported here. The backward kernels (``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``) belong to the training slice, so an input that
requires grad raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .attention import NEG_INF, pick_block_size

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on ``(BH, S, D)``: ``o`` in the input
    dtype and ``lse`` (BH, S) in f32, from a dense f32 softmax of the
    pre-scaled scores with NEG_INF masking (a tie attends)."""
    S, D = q.shape[1], q.shape[2]
    if scale is None:
        scale = D**-0.5
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    if causal:
        pos = torch.arange(S, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3:
        raise ValueError(f"flash_fwd takes (BH, S, D) operands, got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_fwd: {name} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                f"match q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head_dim in {_HEAD_DIMS}, got {q.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd kernel takes contiguous operands; {name} is not")


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("flash_fwd")
    if not getattr(lib, "_typed", False):
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on CUDA ``(BH, S, D)`` operands, on the
    current stream. Raises on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_cuda takes CUDA tensors, got {q.device}")
    _check_kernel_args(q, k, v)
    BH, S, D = q.shape
    if scale is None:
        scale = D**-0.5
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            BH, S, D, _DTYPE_CODES[q.dtype], int(bool(causal)), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: {lib.flash_fwd_error_string(err).decode()} "
            f"(BH={BH}, S={S}, D={D}, dtype={q.dtype})"
        )
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
    """Flash attention on ``(B, S, H, D)``.

    The block contract of the JAX wrapper (pallas_attention.py:354-368):
    default blocks snap to the largest divisor of S up to 512, and explicit
    blocks that do not divide S raise ``ValueError``. The kernel's own
    tiles are independent of the blocks, which only gate the call.
    """
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the dq and dk/dv kernels come "
            "with the training slice of the port. Call it under torch.no_grad()."
        )
    B, S, H, D = q.shape
    if block_q is None:
        block_q = pick_block_size(S, 512) or min(512, S)
    if block_k is None:
        block_k = pick_block_size(S, 512) or min(512, S)
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(
            f"seq len {S} must be divisible by block_q={block_q} and block_k={block_k}"
        )

    def bh(t: torch.Tensor) -> torch.Tensor:
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()

    o, _ = flash_fwd(bh(q), bh(k), bh(v), causal=causal, scale=scale)
    return o.reshape(B, H, S, D).transpose(1, 2)
