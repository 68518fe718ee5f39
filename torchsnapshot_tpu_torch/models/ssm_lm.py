"""SSM language model, one device: linear-time sequence mixing instead of
attention.

Counterpart of ``torchsnapshot_tpu/models/ssm_lm.py`` (:36-222) without a
mesh: ``SSMConfig``, ``init_params``, ``forward``, ``loss_fn``,
``init_state`` and ``make_train_step``. A decoder-only LM whose blocks mix
the sequence with the diagonal selective SSM of ``ops/ssm.py``: token
embedding in ``dtype`` (no position encoding), then per layer RMSNorm, the
SSM mix, RMSNorm and a tanh-GELU FFN, each added to the residual; a final
RMSNorm and the tied projection ``x @ embed.T``. ``lax.scan`` over the
stacked layers becomes a loop over layer index.

Parameters keep the JAX pytree's names and stacked shapes (``embed``,
``layers/ssm/{log_a,w_bc,w_dt,dt_bias,d_skip}``,
``layers/{ln1_scale,ln2_scale,ff_in,ff_out}``, ``ln_f_scale``) and the
train state is ``{"params", "opt", "step"}`` as in the JAX package, so
train-state logical paths are identical in both packages. The optimizer
is the port's AdamW (``transformer.make_optimizer``, optax's state
layout); the JAX package takes any optax transformation. Weights carry
across as numpy with ``params_from_numpy``/``params_to_numpy`` (the
transformer's, re-exported here).

Training is in place, as for the transformer. A ``mesh`` (sequence and
tensor parallelism) is not ported yet and raises by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.ssm import init_ssm_params, ssm_mix
from .transformer import (  # noqa: F401 - params_*_numpy re-exported
    Optimizer,
    _rmsnorm,
    _token_nll,
    apply_step,
    params_from_numpy,
    params_to_numpy,
    value_and_grad,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    vocab_size: int = 32768
    d_model: int = 512
    d_state: int = 16
    n_layers: int = 4
    d_ff: int = 2048
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


def _refuse_mesh(what: str, mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...): the sharded SSM LM (sequence and tensor parallelism) "
            "is not ported yet; the port runs it on one device"
        )


def init_params(
    cfg: SSMConfig, generator: torch.Generator, device: Optional[str] = None
) -> Params:
    """Random parameters in the JAX layout, drawn from ``generator`` on the
    CPU and moved to ``device``."""
    c = cfg
    dev = resolve_device(device)
    per_layer = [
        init_ssm_params(generator, c.d_model, c.d_state, c.param_dtype) for _ in range(c.n_layers)
    ]

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * fan_in**-0.5
        return t.to(dev, c.param_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=c.param_dtype, device=dev)

    return {
        "embed": normal((c.vocab_size, c.d_model), c.d_model),
        "layers": {
            "ssm": {k: torch.stack([p[k] for p in per_layer]).to(dev) for k in per_layer[0]},
            "ln1_scale": ones((c.n_layers, c.d_model)),
            "ln2_scale": ones((c.n_layers, c.d_model)),
            "ff_in": normal((c.n_layers, c.d_model, c.d_ff), c.d_model),
            "ff_out": normal((c.n_layers, c.d_ff, c.d_model), c.d_ff),
        },
        "ln_f_scale": ones((c.d_model,)),
    }


def forward(
    params: Params, tokens: torch.Tensor, cfg: SSMConfig, *, mesh: Any = None
) -> torch.Tensor:
    """Causal LM forward: (B, S) int tokens -> (B, S, vocab) logits in
    ``cfg.dtype``. Differentiable in ``params``."""
    _refuse_mesh("forward", mesh)
    c = cfg
    B, S = tokens.shape
    # index_select: deterministic backward on CUDA (see transformer.forward).
    x = params["embed"].to(c.dtype).index_select(0, tokens.reshape(-1).long())
    x = x.reshape(B, S, c.d_model)
    layers = params["layers"]
    for l in range(c.n_layers):
        h = _rmsnorm(x, layers["ln1_scale"][l])
        y, _ = ssm_mix({k: v[l] for k, v in layers["ssm"].items()}, h)
        x = x + y
        h = _rmsnorm(x, layers["ln2_scale"][l])
        h = F.gelu(h @ layers["ff_in"][l].to(c.dtype), approximate="tanh")
        x = x + h @ layers["ff_out"][l].to(c.dtype)
    x = _rmsnorm(x, params["ln_f_scale"])
    return x @ params["embed"].to(c.dtype).T


def loss_fn(
    params: Params, batch: Dict[str, torch.Tensor], cfg: SSMConfig, *, mesh: Any = None
) -> torch.Tensor:
    """Mean next-token NLL of ``log_softmax(logits.float())`` at
    ``batch["targets"]``."""
    return _token_nll(forward(params, batch["tokens"], cfg, mesh=mesh), batch["targets"])


def init_state(
    generator: torch.Generator,
    cfg: SSMConfig,
    opt: Optimizer,
    device: Optional[str] = None,
    *,
    mesh: Any = None,
) -> Dict[str, Any]:
    """``{params, opt, step}``: parameters from ``generator``, the
    optimizer's zero state, step an int32 0-d tensor. On CUDA unless
    ``device="cpu"`` is passed."""
    _refuse_mesh("init_state", mesh)
    params = init_params(cfg, generator, device)
    return {
        "params": params,
        "opt": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=params["embed"].device),
    }


def make_train_step(
    cfg: SSMConfig, opt: Optimizer, *, mesh: Any = None
) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]], Tuple[Dict[str, Any], torch.Tensor]]:
    """``train_step(state, batch) -> (state, loss)``: one optimizer step of
    ``state`` in place."""
    _refuse_mesh("make_train_step", mesh)

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return apply_step(state, "opt", opt, value_and_grad(loss_fn, state["params"], batch, cfg))

    return step
