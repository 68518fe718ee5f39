"""Attention helpers on ``(batch, seq, heads, head_dim)`` tensors.

Counterpart of ``torchsnapshot_tpu/ops/attention.py``: the block-size rule
the tiled kernels share, and the dense O(S^2) reference attention. The
dense version is the plain path, never a stand-in for the flash kernel on
the card (see ``ops/flash_attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

# Effectively -inf for masking without producing NaNs in exp()/max() chains.
NEG_INF = -1e30


def pick_block_size(seq_len: int, configured: int) -> Optional[int]:
    """Largest divisor of ``seq_len`` within ``configured``. Returns None
    when only tiny divisors exist (below a quarter of the configured size),
    where callers should fall back to dense attention."""
    bs = min(configured, seq_len)
    while seq_len % bs:
        bs -= 1
    if bs < max(1, min(configured, seq_len) // 4):
        return None
    return bs


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention, ``q, k, v: (B, S, H, D)``. Scores are taken in
    the input dtype, then softmaxed in f32, as the JAX reference does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
