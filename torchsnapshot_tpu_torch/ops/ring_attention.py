"""Ring attention: context parallelism over a mesh axis.

Counterpart of ``torchsnapshot_tpu/ops/ring_attention.py`` (the plain
rings) and of the ring loops of ``ops/ring_flash.py``. The sequence is
sharded over a process group (the ring). Each rank keeps its Q shard and
its K/V shard moves one hop a step (``parallel.comm``); no (S, S) matrix
and no full-sequence gather is ever made.

Every hop runs one call of the raw split of ``ops/flash_attention.py``:
``fwd(q, k, v) -> (o normalized, lse)`` on ``(BH, S, D)`` operands, and in
the backward ``bwd(q, k, v, dO, lse, delta) -> (dq, dk, dv)`` with the
*global* lse and ``delta = rowsum(dO * O)``. Hops merge by their
log-sum-exp statistics in f32 (:func:`_merge`), the exact combine of
normalized partials. The plain rings of this module run the split's plain
versions (dense f32, on any device); ``ops/ring_flash.py`` runs the
kernels K1-K3 through the same loops.

:class:`_Ring`: hop 0 is the rank's own shard, the causal diagonal; every
later hop is full. The backward takes ``delta`` in f32 from the
full-precision cotangent before casting it to the input dtype, and
accumulates dK/dV in f32 tensors that rotate with their shard and arrive
home after a full cycle. :class:`_Zigzag` is the zigzag layout's: per hop
q_hi x kv_lo full, plus the diagonal (two causal calls), q_lo x kv_lo
(below) or q_hi x kv_hi (above).

A hop wholly in the future of its queries (ring, causal: the shard of a
higher rank) is skipped. JAX computes it and masks it to ``(0, NEG_INF)``,
whose merge is exactly the identity (``w2 = exp(-1e30 - m) = 0``), so
skipping it changes no bit; the rotation still runs on every rank. So per
call with a ring of n, the rank of seq index i makes ``i + 1`` forward
calls and ``i + 1`` backward calls; zigzag makes ``2n + 1`` of each on
every rank.

Each ring is one ``torch.autograd.Function``: its forward and backward
call the collectives in the same order on every rank. Differentiating
through per-hop collectives instead would give each rank a graph of its
own (a skipped hop, a zigzag branch), and the autograd engine could then
order the collectives differently on different ranks and hang the world.

The per-shard bodies (:func:`ring_self_attention`,
:func:`zigzag_ring_self_attention`) take local ``(B, S_local, H, D)``
tensors and the group. The ``*_sharded`` wrappers take a ``DeviceMesh``
and global tensors that every rank holds whole, and run the body on each
rank's block (``parallel.mesh.shard_map``): sequence over ``seq_axis``,
batch over ``batch_axis`` and heads over ``head_axis`` where the mesh has
those axes.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..parallel import comm
from ..parallel.mesh import P, shard_map
from .flash_attention import flash_bwd_reference, flash_fwd_reference


class Split(NamedTuple):
    """The raw forward and backward that a ring runs per hop."""

    fwd: Callable
    bwd: Callable


PLAIN = Split(flash_fwd_reference, flash_bwd_reference)


def _merge(o, lse, o_s, lse_s):
    """Combine of normalized attention partials: ``o`` f32 (BH, S, D),
    ``lse`` f32 (BH, S)."""
    m = torch.maximum(lse, lse_s)
    w1 = torch.exp(lse - m)
    w2 = torch.exp(lse_s - m)
    denom = w1 + w2
    o_new = (w1[..., None] * o + w2[..., None] * o_s.float()) / denom[..., None]
    return o_new, m + torch.log(denom)


def _c(x: torch.Tensor) -> torch.Tensor:
    # The kernels take contiguous (BH, S, D) operands.
    return x.contiguous()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, split):
        ring, me = comm.size(group), comm.rank(group)
        o, lse = split.fwd(q, k, v, causal=causal, scale=scale)  # hop 0: the diagonal
        o = o.float()
        k_cur, v_cur = k, v
        for s in range(1, ring):
            k_cur, v_cur = comm._rotate((k_cur, v_cur), group)
            # After s hops this rank holds the shard of (me - s) mod ring;
            # a higher owner is wholly in the future.
            if causal and (me - s) % ring > me:
                continue
            o_s, lse_s = split.fwd(q, k_cur, v_cur, causal=False, scale=scale)
            o, lse = _merge(o, lse, o_s, lse_s)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = group, causal, scale, split
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, split = ctx.args
        ring, me = comm.size(group), comm.rank(group)
        delta = (g.float() * o.float()).sum(dim=-1)
        g = _c(g.to(q.dtype))
        dq, dk, dv = split.bwd(q, k, v, g, lse, delta, causal=causal, scale=scale)
        dq = dq.float()
        # dK/dV travel with their shard: after `ring` rotations in all,
        # each is home with every rank's contribution.
        dk_cur, dv_cur = comm._rotate((dk.float(), dv.float()), group)
        k_cur, v_cur = k, v
        for s in range(1, ring):
            k_cur, v_cur = comm._rotate((k_cur, v_cur), group)
            if not (causal and (me - s) % ring > me):
                dq_s, dk_s, dv_s = split.bwd(q, k_cur, v_cur, g, lse, delta, causal=False, scale=scale)
                dq = dq + dq_s.float()
                dk_cur = dk_cur + dk_s.float()
                dv_cur = dv_cur + dv_s.float()
            dk_cur, dv_cur = comm._rotate((dk_cur, dv_cur), group)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None, None, None


class _Zigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, split):
        ring, me = comm.size(group), comm.rank(group)
        half = q.shape[1] // 2
        q_lo, q_hi = _c(q[:, :half]), _c(q[:, half:])
        acc = {"lo": None, "hi": None}

        def fold(which, o_s, lse_s):
            # The first partial is its own merge with (0, NEG_INF), exactly.
            acc[which] = (o_s.float(), lse_s) if acc[which] is None else _merge(*acc[which], o_s, lse_s)

        k_cur, v_cur = k, v
        for s in range(ring):
            if s:
                k_cur, v_cur = comm._rotate((k_cur, v_cur), group)
            j = (me - s) % ring  # owner of the shard held
            k_lo, v_lo = _c(k_cur[:, :half]), _c(v_cur[:, :half])
            k_hi, v_hi = _c(k_cur[:, half:]), _c(v_cur[:, half:])
            # q_hi x kv_lo: chunk 2n-1-me is after every lo chunk.
            fold("hi", *split.fwd(q_hi, k_lo, v_lo, causal=False, scale=scale))
            if j == me:
                a = split.fwd(q_lo, k_lo, v_lo, causal=True, scale=scale)
                b = split.fwd(q_hi, k_hi, v_hi, causal=True, scale=scale)
                fold("lo", *a)
                fold("hi", *b)
            elif j < me:
                fold("lo", *split.fwd(q_lo, k_lo, v_lo, causal=False, scale=scale))
            else:
                fold("hi", *split.fwd(q_hi, k_hi, v_hi, causal=False, scale=scale))
        o = torch.cat([acc["lo"][0], acc["hi"][0]], dim=1).to(q.dtype)
        lse = torch.cat([acc["lo"][1], acc["hi"][1]], dim=1)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = group, scale, split
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale, split = ctx.args
        ring, me = comm.size(group), comm.rank(group)
        half = q.shape[1] // 2
        delta = (g.float() * o.float()).sum(dim=-1)
        g = g.to(q.dtype)
        q_lo, q_hi = _c(q[:, :half]), _c(q[:, half:])
        g_lo, g_hi = _c(g[:, :half]), _c(g[:, half:])
        lse_lo, lse_hi = _c(lse[:, :half]), _c(lse[:, half:])
        d_lo, d_hi = _c(delta[:, :half]), _c(delta[:, half:])
        dq_lo = torch.zeros(q_lo.shape, dtype=torch.float32, device=q.device)
        dq_hi = torch.zeros_like(dq_lo)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros_like(dk_cur)
        k_cur, v_cur = k, v
        for s in range(ring):
            if s:
                k_cur, v_cur = comm._rotate((k_cur, v_cur), group)
            j = (me - s) % ring
            k_lo, v_lo = _c(k_cur[:, :half]), _c(v_cur[:, :half])
            k_hi, v_hi = _c(k_cur[:, half:]), _c(v_cur[:, half:])
            a_dq, a_dk, a_dv = split.bwd(q_hi, k_lo, v_lo, g_hi, lse_hi, d_hi, causal=False, scale=scale)
            lo = hi = None
            if j == me:
                lo = split.bwd(q_lo, k_lo, v_lo, g_lo, lse_lo, d_lo, causal=True, scale=scale)
                hi = split.bwd(q_hi, k_hi, v_hi, g_hi, lse_hi, d_hi, causal=True, scale=scale)
            elif j < me:
                lo = split.bwd(q_lo, k_lo, v_lo, g_lo, lse_lo, d_lo, causal=False, scale=scale)
            else:
                hi = split.bwd(q_hi, k_hi, v_hi, g_hi, lse_hi, d_hi, causal=False, scale=scale)
            dk_lo, dv_lo = dk_cur[:, :half], dv_cur[:, :half]
            dk_hi, dv_hi = dk_cur[:, half:], dv_cur[:, half:]
            if lo is not None:
                dq_lo = dq_lo + lo[0].float()
                dk_lo, dv_lo = dk_lo + lo[1].float(), dv_lo + lo[2].float()
            if hi is not None:
                dq_hi = dq_hi + hi[0].float()
                dk_hi, dv_hi = dk_hi + hi[1].float(), dv_hi + hi[2].float()
            dq_hi = dq_hi + a_dq.float()
            dk_cur = torch.cat([dk_lo + a_dk.float(), dk_hi], dim=1)
            dv_cur = torch.cat([dv_lo + a_dv.float(), dv_hi], dim=1)
            dk_cur, dv_cur = comm._rotate((dk_cur, dv_cur), group)
        dq = torch.cat([dq_lo, dq_hi], dim=1)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None, None


def _bh(x: torch.Tensor) -> torch.Tensor:
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def _unbh(o: torch.Tensor, B: int, H: int) -> torch.Tensor:
    _, S, D = o.shape
    return o.reshape(B, H, S, D).transpose(1, 2)


def _ring(q, k, v, group, causal, scale, split) -> torch.Tensor:
    B, _, H, D = q.shape
    scale = D**-0.5 if scale is None else scale
    return _unbh(_Ring.apply(_bh(q), _bh(k), _bh(v), group, causal, scale, split), B, H)


def _zigzag(q, k, v, group, scale, split) -> torch.Tensor:
    B, S_loc, H, D = q.shape
    if S_loc % 2:
        raise ValueError(f"zigzag needs an even local seq length, got {S_loc}")
    scale = D**-0.5 if scale is None else scale
    return _unbh(_Zigzag.apply(_bh(q), _bh(k), _bh(v), group, scale, split), B, H)


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: comm.Group,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-shard ring attention on ``(B, S_local, H, D)``: rank i of
    ``group`` owns global positions ``[i * S_local, (i + 1) * S_local)``."""
    return _ring(q, k, v, group, causal, scale, PLAIN)


def zigzag_ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: comm.Group,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causally load-balanced ring attention on ``(B, S_local, H, D)`` in
    zigzag layout: with a ring of n, rank i holds chunks i ("lo") and
    2n-1-i ("hi") of the 2n chunks of the sequence, concatenated. On each
    hop q_hi x kv_lo is below the diagonal (full), and the rest is the
    diagonal (two causal blocks) for this rank's own shard, q_lo x kv_lo
    from a lower rank and q_hi x kv_hi from a higher one: the same work on
    every rank."""
    return _zigzag(q, k, v, group, scale, PLAIN)


def zigzag_layout_indices(seq_len: int, ring: int, device=None) -> torch.Tensor:
    """The permutation from global order to zigzag layout: indexing the
    sequence with it and sharding over the ring gives rank i chunks
    ``(i, 2n-1-i)``. ``torch.argsort`` of it inverts it."""
    if seq_len % (2 * ring):
        raise ValueError(f"seq {seq_len} not divisible by 2*ring={2 * ring}")
    chunk = seq_len // (2 * ring)
    order = []
    for i in range(ring):
        order.extend([i, 2 * ring - 1 - i])
    return torch.cat([torch.arange(c * chunk, (c + 1) * chunk, device=device) for c in order])


def _seq_spec(mesh, seq_axis: str, batch_axis: Optional[str], head_axis: Optional[str]) -> P:
    names = mesh.mesh_dim_names
    if seq_axis not in names:
        raise ValueError(f"mesh {names} lacks seq axis {seq_axis!r}")
    b = batch_axis if batch_axis in names else None
    h = head_axis if head_axis in names else None
    return P(b, seq_axis, h, None)


def _sharded(body: Callable, q, k, v, mesh, spec: P) -> torch.Tensor:
    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)


def _zigzag_sharded(body: Callable, q, k, v, mesh, seq_axis, batch_axis, head_axis,
                    in_layout: bool) -> torch.Tensor:
    """The zigzag wrapper shared by the plain and flash bodies: the layout
    permute lives here once. ``body(q, k, v, group=)`` runs per rank."""
    spec = _seq_spec(mesh, seq_axis, batch_axis, head_axis)
    body = functools.partial(body, group=mesh.get_group(seq_axis))
    if not in_layout:
        idx = zigzag_layout_indices(q.shape[1], mesh.size(mesh.mesh_dim_names.index(seq_axis)),
                                    q.device)
        q, k, v = (x.index_select(1, idx) for x in (q, k, v))
    out = _sharded(body, q, k, v, mesh, spec)
    if not in_layout:
        out = out.index_select(1, torch.argsort(idx))
    return out


def zigzag_ring_attention_sharded(
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
    """Zigzag ring attention on global ``(B, S, H, D)`` tensors. With
    ``in_layout=False`` the wrapper permutes the sequence into zigzag
    layout and back; ``in_layout=True`` takes and returns it in layout."""
    body = functools.partial(zigzag_ring_self_attention, scale=scale)
    return _zigzag_sharded(body, q, k, v, mesh, seq_axis, batch_axis, head_axis, in_layout)


def ring_attention_sharded(
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
    """Ring attention on global ``(B, S, H, D)`` tensors: sequence over
    ``seq_axis``, batch over ``batch_axis`` and heads over ``head_axis``
    where the mesh has them (heads are independent, so tensor parallelism
    composes with the ring at no extra communication)."""
    spec = _seq_spec(mesh, seq_axis, batch_axis, head_axis)
    body = functools.partial(
        ring_self_attention, group=mesh.get_group(seq_axis), causal=causal, scale=scale
    )
    return _sharded(body, q, k, v, mesh, spec)
