"""Selective state-space (SSM) sequence mixing by a log-depth scan, one device.

Counterpart of ``torchsnapshot_tpu/ops/ssm.py`` (:44-62, :111-163) in plain
torch: ``ssm_scan``, ``init_ssm_params``, ``_discretize``, ``_readout`` and
``ssm_mix``. The recurrence ``h_t = a_t * h_{t-1} + b_t`` is a first-order
linear recurrence whose combine ``(a, b) o (a', b') = (a * a', a' * b +
b')`` is associative. The JAX package solves it with
``jax.lax.associative_scan``; here it is a Hillis-Steele doubling over the
sequence axis with the same combine: ceil(log2 S) rounds of whole-tensor
ops, not a loop over S (which would be S kernel launches a layer on the
card). The order of operations differs from ``associative_scan``'s
odd/even recursion, so results agree within rounding, not bit for bit.

The decay stays at ``(B, S, 1, N)`` through the scan and broadcasts
against the ``(B, S, D, N)`` state: materializing it per channel would
grow the scan d_model-fold for nothing (the JAX docstring's rule).

The sequence-parallel paths (``ssm_scan_sharded``, ``ssm_mix_sharded``)
need the multi-process layer and raise by name.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def ssm_scan(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Solve ``h_t = a_t * h_{t-1} + b_t`` along axis 1.

    ``a, b: (B, S, ...)`` broadcastable against each other; returns ``h``
    with ``b``'s shape. ``h0`` (``(B, ...)``, optional) is the incoming
    state. Differentiable in every input."""
    a_cum, h = _scan(a, b)
    if h0 is not None:
        # h_t = (prod a_1..t) * h0 + h_t with a zero initial state.
        h = a_cum * h0[:, None] + h
    return h


def _scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of ``(a, b)`` under the combine: round k folds
    each position with the one 2**k before it, so after ceil(log2 S)
    rounds position t holds the fold of positions 0..t. ``a`` keeps its
    own (broadcast) shape throughout."""
    S = b.shape[1]
    offset = 1
    while offset < S:
        a_head, a_tail, a_prev = a[:, :offset], a[:, offset:], a[:, :-offset]
        b = torch.cat([b[:, :offset], a_tail * b[:, :-offset] + b[:, offset:]], dim=1)
        a = torch.cat([a_head, a_tail * a_prev], dim=1)
        offset *= 2
    return a, b


def ssm_scan_sharded(*args: Any, **kwargs: Any):
    """The sequence-parallel scan: not ported yet."""
    raise NotImplementedError(
        "ssm_scan_sharded: the sequence-parallel scan is not ported to "
        "torchsnapshot_tpu_torch yet; use ssm_scan on one device."
    )


def init_ssm_params(
    generator: torch.Generator,
    d_model: int,
    d_state: int = 16,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """``log_a`` (N,) log-spaced stable decay rates (the S4/Mamba init),
    ``w_bc`` (D, 2N), ``w_dt`` (D, 1), ``dt_bias`` (1,) and ``d_skip``
    (D,), with the JAX package's scales; random ones drawn from
    ``generator`` on the CPU."""

    def normal(shape):
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * d_model**-0.5
        return t.to(device=device, dtype=dtype)

    log_a = torch.log(torch.linspace(1.0, float(d_state), d_state, dtype=torch.float32))
    return {
        "log_a": log_a.to(device=device, dtype=dtype),
        "w_bc": normal((d_model, 2 * d_state)),
        "w_dt": normal((d_model, 1)),
        "dt_bias": torch.zeros((1,), dtype=dtype, device=device),
        "d_skip": torch.ones((d_model,), dtype=dtype, device=device),
    }


def _discretize(params: Dict[str, torch.Tensor], xf: torch.Tensor):
    """Position-wise projections: x (B, S, D) in the compute dtype ->
    (decay a (B, S, 1, N), input b (B, S, D, N), readout c (B, S, N))."""
    dt = xf.dtype
    bc = xf @ params["w_bc"].to(dt)  # (B, S, 2N)
    b_in, c_out = bc.chunk(2, dim=-1)
    delta = F.softplus(xf @ params["w_dt"].to(dt) + params["dt_bias"].to(dt))  # (B, S, 1)
    a_rate = torch.exp(params["log_a"].to(dt))  # (N,)
    a = torch.exp(-delta[..., None] * a_rate)  # (B, S, 1, N), broadcasts
    b = (delta * xf)[..., None] * b_in[:, :, None, :]  # (B, S, D, N)
    return a, b, c_out


def _readout(params: Dict[str, torch.Tensor], xf: torch.Tensor, h: torch.Tensor, c_out):
    return torch.einsum("bsdn,bsn->bsd", h, c_out) + xf * params["d_skip"].to(xf.dtype)


def ssm_mix(
    params: Dict[str, torch.Tensor], x: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal selective SSM over ``x: (B, S, D)``: ``(y, h_last)`` with
    ``y`` (B, S, D) in ``x``'s dtype and ``h_last`` (B, D, N), the final
    state, which a sequence-chunked run carries as ``h0``. It computes in
    f32 (the JAX package's ``astype(float32)``), and in f64 for an f64
    ``x``, which the JAX package has no counterpart of: a float64
    reference run of the same code."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    a, b, c_out = _discretize(params, xf)
    h = ssm_scan(a, b, h0)  # (B, S, D, N)
    y = _readout(params, xf, h, c_out)
    return y.to(x.dtype), h[:, -1]


def ssm_mix_sharded(*args: Any, **kwargs: Any):
    """The sequence-parallel SSM mix: not ported yet."""
    raise NotImplementedError(
        "ssm_mix_sharded: the sequence-parallel SSM is not ported to "
        "torchsnapshot_tpu_torch yet; use ssm_mix on one device."
    )
