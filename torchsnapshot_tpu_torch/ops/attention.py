"""Attention helpers on ``(batch, seq, heads, head_dim)`` tensors.

Counterpart of ``torchsnapshot_tpu/ops/attention.py:24-160``: the
block-size rule the tiled kernels share, the dense O(S^2) reference
attention, and the blockwise online-softmax scan (plain torch, as the JAX
package leaves it to XLA). Neither is a stand-in for the flash kernel on
the card (see ``ops/flash_attention.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Reference attention, ``q, k, v: (B, S, H, D)``. Scores are taken in
    the input dtype, then softmaxed in f32, as the JAX reference does.

    ``q_offset``/``k_offset`` are the global positions of the first query
    and key, for q and k that are shards of a longer sequence. A query row
    with no valid key attends to nothing (its output is 0), not uniformly
    to every key as the softmax of an all-NEG_INF row would.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if causal:
        row_valid = mask.any(dim=-1)
        p = torch.where(row_valid[:, None], p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


Acc = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def attention_block_update(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    scale: float,
    causal: bool,
    acc: Acc,
) -> Acc:
    """One online-softmax update of ``acc = (o, m, l)`` with a (q-block,
    kv-block) pair: o (B, Sq, H, D) f32 unnormalized, m and l (B, H, Sq)
    f32. ``q_pos``/``k_pos`` are the global positions of the block's rows.
    A block whose scores are all NEG_INF is inert as long as an earlier
    block gave every row a valid key (the diagonal block, in causal
    self-attention)."""
    o, m, l = acc
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def _finalize(acc: Acc, dtype: torch.dtype) -> torch.Tensor:
    o, _, l = acc
    return (o / l.transpose(1, 2)[..., None]).to(dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_size: int = 512,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention as a scan over K/V blocks with an online softmax,
    ``q, k, v: (B, S, H, D)`` with S divisible by ``block_size``; memory
    O(S * block) instead of O(S^2)."""
    B, S, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    block_size = min(block_size, S)
    if S % block_size != 0:
        raise ValueError(f"seq len {S} not divisible by block_size {block_size}")
    q_pos = torch.arange(S, device=q.device)
    acc = (
        torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device),
        torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device),
        torch.zeros((B, H, S), dtype=torch.float32, device=q.device),
    )
    # From block 0, so the diagonal block is folded in before any block
    # that is wholly masked for some row.
    for j in range(0, S, block_size):
        acc = attention_block_update(
            q, k[:, j : j + block_size], v[:, j : j + block_size],
            q_pos, q_pos[j : j + block_size], scale, causal, acc,
        )
    return _finalize(acc, q.dtype)
