"""The collectives of the parallel ops, with autograd.

JAX's ``shard_map`` bodies call ``ppermute``, ``all_to_all``, ``psum`` and
``all_gather`` and differentiate through them; ``torch.distributed`` has
no autograd-aware ``ppermute``. Each collective here is a raw function
(``_rotate``, ``_all_reduce``, ``_all_gather``, ``_all_to_all``), and the
last three are also a ``torch.autograd.Function`` whose backward is the
collective's exact adjoint across the world: ``all_reduce`` sums the
gradients, ``all_gather`` reduce-scatters them, ``all_to_all`` runs the
inverse exchange. (The rings of ``ops/ring_attention.py`` call
``_rotate`` inside their own autograd functions.)

With these adjoints a backward computes the gradient of the sum, over
ranks, of what each rank's loss adds up to; callers scale each rank's
loss so that the sum is the global one (see ``models/transformer.py``).

A group is a ``torch.distributed`` process group, or ``None`` for a group
of one (every collective is then the identity).

**Transport.** The NCCL backend moves CUDA tensors itself. gloo's
point-to-point calls hand a tensor's raw pointer to a host buffer with no
device check, so a CUDA tensor over a gloo group is staged on purpose: it
is copied into pinned host memory, exchanged there, and copied back to
the card. ``staged`` counts what crossed the host that way (``calls``,
``bytes`` sent by this rank, ``ms`` of host time around the exchange).
The kernels still run on the card; only the hop goes through the host.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import telemetry

Group = Optional["dist.ProcessGroup"]

# What went through pinned host memory: calls, bytes this rank sent, ms.
staged: Counter = Counter()


def size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _peer(group: Group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group``."""
    return dist.get_global_rank(group, group_rank)


def _needs_staging(t: torch.Tensor, group: Group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) != "nccl"


_HALF = (torch.bfloat16, torch.float16)


class _Transport:
    """Host staging for one collective: ``out`` moves a tensor onto the
    wire (pinned host memory when staged), ``back`` returns a received
    wire tensor to the caller's device, ``done`` records the call."""

    def __init__(self, like: torch.Tensor, group: Group) -> None:
        self.device = like.device
        self.staging = _needs_staging(like, group)
        self.sent = 0
        self.t0 = telemetry.monotonic()

    def out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.staging:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.sent += host.numel() * host.element_size()
        return host

    def empty_like(self, wire: torch.Tensor) -> torch.Tensor:
        if self.staging:
            return torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
        return torch.empty(wire.shape, dtype=wire.dtype, device=self.device)

    def back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self.staging else t

    def done(self) -> None:
        if self.staging:
            staged["calls"] += 1
            staged["bytes"] += self.sent
            staged["ms"] += (telemetry.monotonic() - self.t0) * 1e3


def _rotate(tensors: Sequence[torch.Tensor], group: Group, shift: int = 1) -> List[torch.Tensor]:
    """Each tensor moves ``shift`` ranks up the group's ring (rank i's
    arrives at rank i+shift): every send and receive is posted at once
    through ``batch_isend_irecv``, so the ring cannot deadlock."""
    n = size(group)
    if n == 1 or shift % n == 0:
        return list(tensors)
    me = rank(group)
    dst, src = _peer(group, (me + shift) % n), _peer(group, (me - shift) % n)
    wires = [_Transport(t, group) for t in tensors]
    outs = [w.out(t) for w, t in zip(wires, tensors)]
    ins = [w.empty_like(o) for w, o in zip(wires, outs)]
    ops = []
    for tag, (o, i) in enumerate(zip(outs, ins)):
        ops.append(dist.P2POp(dist.isend, o, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, i, src, group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for w in wires:
        w.done()
    return [w.back(i) for w, i in zip(wires, ins)]


def _all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group, out of place (half types summed in f32,
    then rounded once)."""
    if size(group) == 1:
        return t
    dtype = t.dtype
    if dtype in _HALF:
        t = t.float()
    wire = _Transport(t, group)
    buf = wire.out(t)
    if not wire.staging:
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    wire.done()
    return wire.back(buf).to(dtype)


def _all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in rank order."""
    n = size(group)
    if n == 1:
        return t
    wire = _Transport(t, group)
    buf = wire.out(t)
    parts = [wire.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    wire.done()
    return torch.cat([wire.back(p) for p in parts], dim=dim)


def _own_block(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return t.chunk(size(group), dim=dim)[rank(group)].contiguous()


def _reduce_scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The sum over the group, this rank's block along ``dim`` (gloo has
    no reduce_scatter: an all_reduce, then the block)."""
    if size(group) == 1:
        return t
    return _own_block(_all_reduce(t, group), group, dim)


def _all_to_all(t: torch.Tensor, group: Group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``t`` cut into ``n`` blocks along
    ``split_dim``, block j sent to rank j, the blocks received
    concatenated along ``concat_dim`` in rank order."""
    n = size(group)
    if n == 1:
        return t
    wire = _Transport(t, group)
    send = wire.out(torch.stack(t.chunk(n, dim=split_dim)))
    recv = wire.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    wire.done()
    return torch.cat(wire.back(recv).unbind(0), dim=concat_dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``psum``: the sum over the group; the backward sums the gradients."""
    return t if size(group) == 1 else _AllReduce.apply(t, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """``all_gather(tiled=True)`` along ``dim``; the backward
    reduce-scatters."""
    return t if size(group) == 1 else _AllGather.apply(t, group, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(t, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat_dim, ctx.split_dim), None, None, None


def all_to_all(t: torch.Tensor, group: Group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``; the backward is the inverse
    exchange."""
    return t if size(group) == 1 else _AllToAll.apply(t, group, split_dim, concat_dim)
