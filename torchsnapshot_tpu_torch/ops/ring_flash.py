"""Ring attention with the flash kernels as the inner compute.

Counterpart of ``torchsnapshot_tpu/ops/ring_flash.py``: the ring loops of
``ops/ring_attention.py`` (:class:`~.ring_attention._Ring`, the counterpart
of ``_RingFlash`` at ring_flash.py:62-159, and
:class:`~.ring_attention._Zigzag`, of ``_make_zigzag_flash`` at :204-391),
driven per hop by the raw split of ``ops/flash_attention.py``:
``flash_fwd`` and ``flash_bwd``, which launch K1 and K2 + K3 on CUDA
tensors and run their plain versions on CPU tensors. Hop 0 runs the
causal kernel on the home shard and every later hop the full kernel;
zigzag runs q_hi x kv_lo full plus two causal calls on the diagonal, or
one full call below or above.

Per attention call with a ring of n, the rank of seq index i launches K1
``i + 1`` times and K2 and K3 ``i + 1`` times each in the backward, since
the hops wholly in the future are skipped (see ``ops/ring_attention.py``);
zigzag launches ``2n + 1`` of each on every rank.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..parallel import comm
from .flash_attention import check_blocks, flash_bwd, flash_fwd
from .ring_attention import Split, _ring, _seq_spec, _sharded, _zigzag, _zigzag_sharded

FLASH = Split(flash_fwd, flash_bwd)


def ring_flash_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: comm.Group,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Per-shard ring-flash on ``(B, S_local, H, D)``: the layout and
    contract of ``ring_self_attention``, the flash kernels per hop."""
    check_blocks(q.shape[1], block_q, block_k, "local seq len")
    return _ring(q, k, v, group, causal, scale, FLASH)


def zigzag_ring_flash_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: comm.Group,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Per-shard zigzag-flash on ``(B, S_local, H, D)`` in zigzag layout
    (the contract of ``zigzag_ring_self_attention``)."""
    S_loc = q.shape[1]
    if S_loc % 2:
        raise ValueError(f"zigzag needs an even local seq length, got {S_loc}")
    check_blocks(S_loc // 2, block_q, block_k, "half-shard length")
    return _zigzag(q, k, v, group, scale, FLASH)


def zigzag_ring_flash_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = "data",
    head_axis: Optional[str] = "model",
    scale: Optional[float] = None,
    in_layout: bool = False,
) -> torch.Tensor:
    """Zigzag-flash on global ``(B, S, H, D)`` tensors: a drop-in for
    ``zigzag_ring_attention_sharded`` with the flash kernels."""
    body = functools.partial(zigzag_ring_flash_self_attention, scale=scale)
    return _zigzag_sharded(body, q, k, v, mesh, seq_axis, batch_axis, head_axis, in_layout)


def ring_flash_attention_sharded(
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
) -> torch.Tensor:
    """Ring-flash on global ``(B, S, H, D)`` tensors: a drop-in for
    ``ring_attention_sharded`` with the flash kernels."""
    spec = _seq_spec(mesh, seq_axis, batch_axis, head_axis)
    body = functools.partial(
        ring_flash_self_attention, group=mesh.get_group(seq_axis), causal=causal, scale=scale
    )
    return _sharded(body, q, k, v, mesh, spec)
