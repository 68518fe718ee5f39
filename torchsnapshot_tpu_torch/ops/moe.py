"""Mixture-of-experts FFN, top-2 routing with static capacity.

Counterpart of ``torchsnapshot_tpu/ops/moe.py`` (:51-322) in plain torch:
``init_moe_params``, ``_top2_route``, ``_aux_loss``, ``_einsum_dispatch``,
``_sort_dispatch``, ``_sort_combine``, ``_expert_ffn`` and ``moe_ffn``.
GShard-style top-2 routing: capacity per expert is ``ceil(2 * T *
capacity_factor / E)``; a token past its expert's capacity is dropped
(its FFN output is zero and the residual carries it). Every top-1 claim
fills capacity before any top-2 claim, in token order.

Two dispatches, which route identically:

- ``einsum``: the (T, E, cap) one-hot dispatch and combine tensors of the
  GShard paper, O(T * E * cap) memory. The dispatch and combine products
  multiply by a 0/1 mask and a gated mask: they are permutations, not
  arithmetic, and the JAX package forces ``Precision.HIGHEST`` on them. In
  torch an f32 matmul is exact here only with TF32 off
  (``torch.backends.cuda.matmul.allow_tf32 = False``, torch's default; a
  ``torch.set_float32_matmul_precision`` other than ``"highest"`` breaks
  it).
- ``sort``: the (token, choice) slots stably sorted by expert id, each
  slot's position in its expert read off the sorted order, and the
  dispatch a scatter-add of rows into an (E * cap + 1, D) buffer whose
  last row takes every overflowing slot and is sliced off (JAX drops such
  rows with ``mode="drop"``; torch would raise on the out-of-range index).
  The combine gathers each slot's row from the buffer with a zero row
  appended.

``dispatch="auto"`` takes ``einsum`` while T * E * cap stays at most
``_EINSUM_DISPATCH_MAX_ELEMENTS``, else ``sort``.

Every op here is one that ``torch.use_deterministic_algorithms(True)``
accepts on CUDA: the scatter is ``index_put_`` with ``accumulate=True``
(sort-based there), the gathers are ``index_select`` (whose backward is
deterministic in that mode), expert counts are a one-hot sum, and the
inverse permutation is an argsort; a resume is bit-identical.

``moe_ffn_sharded`` is the expert-parallel path (tokens and experts split
over a mesh axis, two all-to-alls), with ``moe_param_specs``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# Above this many elements in the (T, E, cap) dispatch tensor, "auto"
# switches to the sort-based dispatch (2**22 f32 elements = 16 MB).
_EINSUM_DISPATCH_MAX_ELEMENTS = 1 << 22


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_moe_params(
    generator: torch.Generator,
    d_model: int,
    d_ff: int,
    n_experts: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """``router`` (D, E), ``w_in`` (E, D, F) and ``w_out`` (E, F, D), drawn
    from ``generator`` on the CPU with the JAX package's scales."""

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * fan_in**-0.5
        return t.to(device=device, dtype=dtype)

    return {
        "router": normal((d_model, n_experts), d_model),
        "w_in": normal((n_experts, d_model, d_ff), d_model),
        "w_out": normal((n_experts, d_ff, d_model), d_ff),
    }


def _top2_route(x2: torch.Tensor, router: torch.Tensor):
    """Top-2 routing of ``x2`` (T, D): ``(e1, e2, g1, g2, probs)``, the
    expert ids (T,), the renormalized gates (T,) in f32 and the router
    probabilities (T, E) in f32. The logits are computed in ``x2``'s dtype;
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    E = router.shape[1]
    logits = (x2 @ router.to(x2.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    g1 = probs.amax(dim=-1)
    e1 = probs.argmax(dim=-1)
    probs_wo1 = probs - F.one_hot(e1, E).to(probs.dtype) * probs
    g2 = probs_wo1.amax(dim=-1)
    e2 = probs_wo1.argmax(dim=-1)
    denom = g1 + g2 + 1e-9
    return e1, e2, g1 / denom, g2 / denom, probs


def _aux_loss(e1: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss from the top-1 assignments."""
    E = probs.shape[-1]
    frac_tokens = F.one_hot(e1, E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return (frac_tokens * frac_probs).sum() * E


def _einsum_dispatch(x2, e1, e2, g1, g2, E: int, cap: int):
    """GShard one-hot dispatch: the (E, cap, D) expert buffers and the
    (T, E, cap) f32 combine tensor."""

    def dispatch(e, g, prior_load):
        onehot = F.one_hot(e, E)  # (T, E) int64
        pos = torch.cumsum(onehot, dim=0) - 1 + prior_load[None, :]
        pos = (pos * onehot).sum(dim=-1)  # (T,)
        keep = pos < cap
        disp = (
            onehot.float()[:, :, None]
            * F.one_hot(pos.clamp(0, cap - 1), cap).float()[:, None, :]
            * keep[:, None, None]
        )
        return disp, g * keep, prior_load + onehot.sum(dim=0)

    load0 = torch.zeros((E,), dtype=torch.int64, device=x2.device)
    disp1, g1k, load1 = dispatch(e1, g1, load0)
    disp2, g2k, _ = dispatch(e2, g2, load1)
    combine = disp1 * g1k[:, None, None] + disp2 * g2k[:, None, None]
    dispatch_mask = (combine > 0).to(x2.dtype)
    xe = torch.einsum("td,tec->ecd", x2, dispatch_mask)
    return xe, combine


def _sort_dispatch(x2, e1, e2, E: int, cap: int):
    """Sort-based dispatch: ``(xe, dest)`` with ``xe`` the (E, cap, D)
    expert buffers and ``dest`` (T, 2) each (token, choice) slot's row in
    the flattened (E * cap) buffer, or E * cap (a zero pad row) when the
    slot overflowed. Slots sort slot-major (every top-1 claim by token id,
    then every top-2 claim), so a slot's position in its expert is its
    sorted index minus the expert's start: the einsum path's priority."""
    T, D = x2.shape
    flat_e = torch.cat([e1, e2])  # (2T,) slot-major
    flat_t = torch.arange(T, device=x2.device).repeat(2)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = flat_t[order]
    counts = F.one_hot(flat_e, E).sum(dim=0)  # (E,)
    start = torch.cumsum(counts, dim=0) - counts  # exclusive prefix sum
    pos = torch.arange(2 * T, device=x2.device) - start[se]
    dest_sorted = torch.where(pos < cap, se * cap + pos, torch.full_like(pos, E * cap))
    # Overflowing slots land on the pad row E * cap, which is sliced off.
    xe = torch.zeros((E * cap + 1, D), dtype=x2.dtype, device=x2.device).index_put(
        (dest_sorted,), x2.index_select(0, st), accumulate=True
    )
    xe = xe[: E * cap].reshape(E, cap, D)
    # Invert the sort so each original slot knows its buffer row.
    dest = dest_sorted[torch.argsort(order)]
    return xe, dest.reshape(2, T).T


def _sort_combine(ye, dest, g1, g2, dtype):
    """Each token's (up to) two expert outputs, gate-weighted and summed."""
    E_cap, D = ye.shape[0] * ye.shape[1], ye.shape[2]
    ye_pad = torch.cat([ye.reshape(E_cap, D), ye.new_zeros((1, D))], dim=0)
    return ye_pad.index_select(0, dest[:, 0]) * g1[:, None].to(dtype) + ye_pad.index_select(
        0, dest[:, 1]
    ) * g2[:, None].to(dtype)


def _expert_ffn(params, xe, activation, dtype):
    """(E, cap, D) -> (E, cap, D) through the per-expert FFNs."""
    h = activation(torch.einsum("ecd,edf->ecf", xe, params["w_in"].to(dtype)))
    return torch.einsum("ecf,efd->ecd", h, params["w_out"].to(dtype))


def resolve_dispatch(dispatch: str, T: int, E: int, cap: int) -> str:
    if dispatch == "auto":
        dispatch = "einsum" if T * E * cap <= _EINSUM_DISPATCH_MAX_ELEMENTS else "sort"
    if dispatch not in ("einsum", "sort"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    return dispatch


def moe_experts(params, x2, *, E: int, cap: int, e0: int, dispatch: str,
                activation=gelu) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route every token of ``x2`` (T, D) over all ``E`` experts with
    capacity ``cap``, and run the experts ``e0 .. e0 + E_l`` whose weights
    ``params["w_in"]`` and ``params["w_out"]`` hold (``E_l`` of them):
    ``(each token's gated outputs from those experts, the f32 aux loss)``.
    With all ``E`` experts that is the whole FFN; a rank holding a slice of
    them gives a partial sum over experts."""
    E_l = params["w_in"].shape[0]
    e1, e2, g1, g2, probs = _top2_route(x2, params["router"])
    if dispatch == "einsum":
        xe, combine = _einsum_dispatch(x2, e1, e2, g1, g2, E, cap)
        ye = _expert_ffn(params, xe[e0 : e0 + E_l], activation, x2.dtype)
        y = torch.einsum("ecd,tec->td", ye, combine[:, e0 : e0 + E_l].to(x2.dtype))
    else:
        xe, dest = _sort_dispatch(x2, e1, e2, E, cap)
        ye = _expert_ffn(params, xe[e0 : e0 + E_l], activation, x2.dtype)
        if E_l < E:
            ye = torch.cat([ye.new_zeros((e0,) + ye.shape[1:]), ye,
                            ye.new_zeros((E - e0 - E_l,) + ye.shape[1:])])
        y = _sort_combine(ye, dest, g1, g2, x2.dtype)
    return y, _aux_loss(e1, probs)


def moe_ffn(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    activation: Callable[[torch.Tensor], torch.Tensor] = gelu,
    dispatch: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-2 MoE FFN: ``x`` (..., T, D) -> (y of ``x``'s shape and dtype,
    the f32 aux loss). Leading dims flatten into one token axis."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    T = x2.shape[0]
    E = params["router"].shape[1]
    cap = int(max(1, math.ceil(2 * T * capacity_factor / E)))
    dispatch = resolve_dispatch(dispatch, T, E, cap)
    y, aux = moe_experts(params, x2, E=E, cap=cap, e0=0, dispatch=dispatch,
                         activation=activation)
    return y.reshape(x.shape), aux


def moe_param_specs(expert_axis: Optional[str] = "model") -> Dict[str, Any]:
    """Specs of ``init_moe_params``' tree (moe.py:68-77): the experts
    sharded over ``expert_axis``, the router replicated."""
    from ..parallel.mesh import P

    return {
        "router": P(None, None),
        "w_in": P(expert_axis, None, None),
        "w_out": P(expert_axis, None, None),
    }


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    from ..parallel import comm

    return comm.all_reduce(x, group) / comm.size(group)


def _expert_parallel_block(params, x_l, *, group, E: int, cap_l: int, activation):
    """One rank of ``moe_ffn_sharded`` (moe.py:286-313): route the local
    tokens, sort-dispatch them into (E, cap_l, D) buffers, swap buffers so
    this rank holds its E/n experts' tokens from every rank, run its
    experts, swap back, combine."""
    from ..parallel import comm

    e1, e2, g1, g2, probs = _top2_route(x_l, params["router"])
    xe, dest = _sort_dispatch(x_l, e1, e2, E, cap_l)
    xe = comm.all_to_all(xe, group, split_dim=0, concat_dim=1)  # (E_l, n * cap_l, D)
    ye = _expert_ffn(params, xe, activation, x_l.dtype)
    ye = comm.all_to_all(ye, group, split_dim=1, concat_dim=0)  # (E, cap_l, D), this rank's
    y_l = _sort_combine(ye, dest, g1, g2, x_l.dtype)
    # The aux loss is over the global batch: each factor is a mean over
    # ALL tokens, so each is averaged over the ranks before the product.
    frac_tokens = _pmean(F.one_hot(e1, E).float().mean(dim=0), group)
    frac_probs = _pmean(probs.mean(dim=0), group)
    return y_l, (frac_tokens * frac_probs).sum() * E


def moe_ffn_sharded(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh: Any,
    *,
    expert_axis: str = "model",
    capacity_factor: float = 1.25,
    activation: Callable[[torch.Tensor], torch.Tensor] = gelu,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel top-2 MoE FFN with all-to-all dispatch
    (moe.py:235-322). ``x`` (T, D) and ``params`` are global tensors every
    rank holds whole; tokens and experts are split over ``expert_axis``
    (``moe_param_specs``), and each rank runs
    :func:`_expert_parallel_block` on its block (``parallel.mesh.
    shard_map``). Capacity is per sending rank, ``cap_l = ceil(2 * T_l *
    capacity_factor / E)``, so buffer shapes are fixed whatever the
    routing; with ample capacity the result is ``moe_ffn``'s. Returns
    ``(y (T, D), aux)`` on every rank."""
    from ..parallel.mesh import P, axis_group, axis_size, check_mesh, shard_map

    check_mesh(mesh, "moe_ffn_sharded")
    if expert_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} lacks expert axis {expert_axis!r}")
    n_dev = axis_size(mesh, expert_axis)
    E = params["router"].shape[1]
    if E % n_dev:
        raise ValueError(f"n_experts {E} not divisible by mesh axis {n_dev}")
    T = x.shape[0]
    if T % n_dev:
        raise ValueError(f"token count {T} not divisible by mesh axis {n_dev}")
    cap_l = int(max(1, math.ceil(2 * (T // n_dev) * capacity_factor / E)))
    body = functools.partial(
        _expert_parallel_block,
        group=axis_group(mesh, expert_axis),
        E=E,
        cap_l=cap_l,
        activation=activation,
    )
    tokens = P(expert_axis, None)
    return shard_map(body, mesh, (moe_param_specs(expert_axis), tokens), (tokens, P()))(params, x)
