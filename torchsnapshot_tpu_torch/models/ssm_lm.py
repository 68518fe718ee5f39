"""SSM language model, one device: linear-time sequence mixing instead of
attention.

Counterpart of ``torchsnapshot_tpu/models/ssm_lm.py`` (:36-222):
``SSMConfig``, ``init_params``, ``param_specs``, ``state_specs``,
``forward``, ``loss_fn``, ``init_state`` and ``make_train_step``. A decoder-only LM whose blocks mix
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

Training is in place, as for the transformer.

**Under a mesh** (``mesh=``, a ``DeviceMesh`` over ``data``, ``model`` and
optionally ``seq``): GSPMD inserts the collectives in the JAX package;
here each rank runs the layers on its blocks and the collectives are
explicit, as in ``models/transformer_mesh.py``. The batch splits over
``data``; with a ``seq`` axis the residual stream stays split over the
sequence end to end and each layer's scan carries its state across the
chunks with one all-gather (``ops/ssm.ssm_mix_local``). Tensor
parallelism over ``model``: ``ff_in`` is column-parallel, ``ff_out``
row-parallel followed by an all-reduce; the tied ``embed`` is split on D
(``P(None, "model")``) and all-gathered over ``model`` once a call, for the
token lookup and for the logits. Each rank's loss is its tokens' NLL sum
over the global token count and the ``model`` ranks that compute the
same tokens, so the parts add up to the global loss; a gradient is then
summed over the axes its parameter is replicated on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.ssm import init_ssm_params, ssm_mix, ssm_mix_local
from ..parallel import comm
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


def param_specs(cfg: SSMConfig) -> Params:
    """Specs for a ``('data', 'model'[, 'seq'])`` mesh (ssm_lm.py:75-96):
    the FFN tensor-parallel, ``embed`` split on D, the SSM params (they
    are tiny, O(d_model * d_state)) and the norm scales replicated."""
    from ..parallel.mesh import P

    none2 = P(None, None)
    return {
        "embed": P(None, "model"),
        "layers": {
            "ssm": {
                "log_a": none2,
                "w_bc": P(None, None, None),
                "w_dt": P(None, None, None),
                "dt_bias": none2,
                "d_skip": none2,
            },
            "ln1_scale": none2,
            "ln2_scale": none2,
            "ff_in": P(None, None, "model"),
            "ff_out": P(None, "model", None),
        },
        "ln_f_scale": P(None),
    }


def state_specs(cfg: SSMConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of ``init_state``'s tree (ssm_lm.py:166-180): Adam's moments
    take their param's spec, the scalars are replicated on the mesh."""
    from ..parallel.mesh import P, optax_state_specs

    p_specs = param_specs(cfg)
    return {"params": p_specs, "opt": optax_state_specs(p_specs, state["opt"]), "step": P()}


def _layers(params: Params, tokens: torch.Tensor, cfg: SSMConfig, embed: torch.Tensor,
            mix: Callable, ff_sum: Callable) -> torch.Tensor:
    """The model on ``tokens`` with the whole ``embed`` (V, D): ``mix`` is
    the SSM mix of one layer, ``ff_sum`` sums the FFN's row-parallel
    partial outputs (the identity on one device)."""
    c = cfg
    B, S = tokens.shape
    # index_select: deterministic backward on CUDA (see transformer.forward).
    x = embed.index_select(0, tokens.reshape(-1).long()).reshape(B, S, c.d_model)
    layers = params["layers"]
    for l in range(c.n_layers):
        h = _rmsnorm(x, layers["ln1_scale"][l])
        x = x + mix({k: v[l] for k, v in layers["ssm"].items()}, h)
        h = _rmsnorm(x, layers["ln2_scale"][l])
        h = F.gelu(h @ layers["ff_in"][l].to(c.dtype), approximate="tanh")
        x = x + ff_sum(h @ layers["ff_out"][l].to(c.dtype))
    x = _rmsnorm(x, params["ln_f_scale"])
    return x @ embed.T


def forward(
    params: Params, tokens: torch.Tensor, cfg: SSMConfig, *, mesh: Any = None
) -> torch.Tensor:
    """Causal LM forward: (B, S) int tokens -> (B, S, vocab) logits in
    ``cfg.dtype``. Differentiable in ``params``. With ``mesh``, the logits
    of the global batch on every rank (``params`` DTensors from
    ``init_state(mesh=)`` or global tensors)."""
    if mesh is not None:
        run = _MeshRun(cfg, mesh, *tokens.shape)
        logits = run.body(run.local_params(params), run.local(tokens))
        return run.leave(logits)
    embed = params["embed"].to(cfg.dtype)
    return _layers(params, tokens, cfg, embed, lambda p, h: ssm_mix(p, h)[0], lambda t: t)


def loss_fn(
    params: Params, batch: Dict[str, torch.Tensor], cfg: SSMConfig, *, mesh: Any = None
) -> torch.Tensor:
    """Mean next-token NLL of ``log_softmax(logits.float())`` at
    ``batch["targets"]``; with ``mesh``, the global loss on every rank."""
    if mesh is not None:
        from ..parallel.mesh import sum_over_mesh

        run = _MeshRun(cfg, mesh, *batch["tokens"].shape)
        part = run.local_loss(run.local_params(params), run.local(batch["tokens"]),
                              run.local(batch["targets"]))
        return sum_over_mesh(part, mesh)
    return _token_nll(forward(params, batch["tokens"], cfg), batch["targets"])


class _MeshRun:
    """One call's plan on this rank under a mesh (see the module
    docstring): the groups, this rank's tokens, and the layer body."""

    AXES = ("data", "seq", "model")

    def __init__(self, cfg: SSMConfig, mesh, B: int, S: int):
        from ..parallel.mesh import axis_group, axis_rank, axis_size, check_mesh

        check_mesh(mesh, "ssm_lm")
        self.cfg, self.mesh = cfg, mesh
        n = {a: axis_size(mesh, a) for a in self.AXES}
        r = {a: axis_rank(mesh, a) for a in self.AXES}
        self.g = {a: axis_group(mesh, a) for a in self.AXES}
        for what, value, over in (("batch", B, n["data"]), ("seq len", S, n["seq"]),
                                  ("d_model", cfg.d_model, n["model"]),
                                  ("d_ff", cfg.d_ff, n["model"])):
            if value % over:
                raise ValueError(f"{what} {value} does not divide over {over} ranks of {mesh}")
        B_l, S_l = B // n["data"], S // n["seq"]
        self.B, self.S, self.replicas = B, S, n["model"]
        self.batch = slice(r["data"] * B_l, (r["data"] + 1) * B_l)
        self.seq = slice(r["seq"] * S_l, (r["seq"] + 1) * S_l)
        self.names = mesh.mesh_dim_names

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global (B, S) tensor."""
        return t[self.batch, self.seq]

    def local_params(self, params: Params) -> Params:
        from .transformer_mesh import local_params

        return local_params(params, param_specs(self.cfg), self.mesh)

    def body(self, lp: Params, tokens_l: torch.Tensor) -> torch.Tensor:
        c, seq = self.cfg, self.g["seq"]
        embed = comm.all_gather(lp["embed"].to(c.dtype), self.g["model"], dim=1)

        def mix(p, h):
            h0 = h.new_zeros((h.shape[0], h.shape[2], p["log_a"].shape[0]))
            return ssm_mix_local(p, h, h0, seq)[0]

        return _layers(lp, tokens_l, c, embed, mix, lambda t: comm.all_reduce(t, self.g["model"]))

    def local_loss(self, lp: Params, tokens_l: torch.Tensor, targets_l: torch.Tensor):
        logp = torch.log_softmax(self.body(lp, tokens_l).float(), dim=-1)
        nll = -torch.gather(logp, -1, targets_l.long()[..., None]).sum()
        return nll / (self.B * self.S * self.replicas)

    def leave(self, logits: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import P, leave

        spec = P("data" if "data" in self.names else None, "seq" if "seq" in self.names else None)
        return leave(logits, self.mesh, spec)


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
    ``device="cpu"`` is passed. With ``mesh``, every rank draws the whole
    state on the CPU and keeps its blocks, each leaf a DTensor placed by
    :func:`state_specs`."""
    if mesh is not None:
        from ..parallel.mesh import check_mesh, shard_pytree

        check_mesh(mesh, "init_state")
        state = init_state(generator, cfg, opt, "cpu")
        return shard_pytree(state, state_specs(cfg, state), mesh)
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
    ``state`` in place. With ``mesh``, on ``init_state(mesh=)``'s DTensor
    state and a global batch: every rank steps its own blocks and returns
    the global loss."""
    if mesh is not None:
        return _mesh_train_step(cfg, opt, mesh)

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return apply_step(state, "opt", opt, value_and_grad(loss_fn, state["params"], batch, cfg))

    return step


def _mesh_train_step(cfg: SSMConfig, opt: Optimizer, mesh):
    from ..parallel.mesh import check_mesh, local_tree, sum_over_mesh
    from .transformer_mesh import sum_replicated_grads

    check_mesh(mesh, "make_train_step")

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        run = _MeshRun(cfg, mesh, *batch["tokens"].shape)
        lp = local_tree(state["params"])
        part, grads = value_and_grad(
            lambda p: run.local_loss(p, run.local(batch["tokens"]), run.local(batch["targets"])),
            lp,
        )
        grads = sum_replicated_grads(grads, param_specs(cfg), mesh)
        opt.update(grads, local_tree(state["opt"]), lp)
        with torch.no_grad():
            local_tree(state["step"]).add_(1)
            loss = sum_over_mesh(part, mesh)
        return state, loss

    return step
