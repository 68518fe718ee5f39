"""Ulysses-style all-to-all sequence parallelism.

Counterpart of ``torchsnapshot_tpu/ops/ulysses.py``: activations arrive
sequence-sharded over a process group; one all-to-all re-shards them to
head-sharded with the whole sequence on each rank, attention runs locally
per head group, and a second all-to-all restores the sequence sharding.
Both all-to-alls are ``parallel.comm.all_to_all`` (``all_to_all_single``
over the group, differentiable: the backward is the inverse exchange).

``inner="auto"`` takes the flash kernels on a CUDA tensor and the
blockwise scan on a CPU tensor, as the JAX package takes flash on the TPU
and blockwise elsewhere. Flash on a CUDA tensor always launches the
kernels, whatever the sequence length.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..parallel import comm
from .attention import blockwise_attention, dense_attention, pick_block_size
from .ring_attention import _seq_spec, _sharded


def _resolve_inner(inner: str, device: torch.device) -> str:
    if inner != "auto":
        return inner
    return "flash" if device.type == "cuda" else "blockwise"


def ulysses_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: comm.Group,
    causal: bool = True,
    scale: Optional[float] = None,
    inner: str = "auto",
    inner_block_size: int = 512,
) -> torch.Tensor:
    """Per-shard Ulysses on ``(B, S_local, H_local, D)`` with ``H_local``
    divisible by the group's size; returns the same layout."""
    inner = _resolve_inner(inner, q.device)
    p = comm.size(group)
    if q.shape[2] % p != 0:
        raise ValueError(
            f"Ulysses needs heads per shard ({q.shape[2]}) divisible by the "
            f"sequence-parallel axis size ({p}); use ring attention for "
            f"head-starved configurations."
        )

    def to_head_sharded(t):  # (B, S/p, H, D) -> (B, S, H/p, D)
        return comm.all_to_all(t, group, split_dim=2, concat_dim=1)

    qh, kh, vh = to_head_sharded(q), to_head_sharded(k), to_head_sharded(v)
    S = qh.shape[1]
    bs = pick_block_size(S, inner_block_size)
    # On a CUDA tensor flash is the kernels, which tile any S; on a CPU
    # tensor it is gated on the kernels' 512-target pick, as the JAX
    # package gates it.
    if inner == "flash" and (qh.is_cuda or pick_block_size(S, 512) is not None):
        from .flash_attention import flash

        out = flash(qh, kh, vh, causal=causal, scale=scale)
    elif inner == "blockwise" and bs is not None and S > inner_block_size:
        out = blockwise_attention(qh, kh, vh, block_size=bs, causal=causal, scale=scale)
    else:
        out = dense_attention(qh, kh, vh, causal=causal, scale=scale)
    return comm.all_to_all(out, group, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "data",
    head_axis: Optional[str] = "model",
    causal: bool = True,
    scale: Optional[float] = None,
    inner: str = "auto",
    inner_block_size: int = 512,
) -> torch.Tensor:
    """Ulysses attention on global ``(B, S, H, D)`` tensors, with the specs
    of ``ring_attention_sharded`` (the all-to-all further splits the heads
    a ``head_axis`` leaves on each rank)."""
    spec = _seq_spec(mesh, seq_axis, batch_axis, head_axis)
    body = functools.partial(
        ulysses_self_attention,
        group=mesh.get_group(seq_axis),
        causal=causal,
        scale=scale,
        inner=inner,
        inner_block_size=inner_block_size,
    )
    return _sharded(body, q, k, v, mesh, spec)
