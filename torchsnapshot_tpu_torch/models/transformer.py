"""The flagship decoder-only transformer, single device: serving and training.

Counterpart of ``torchsnapshot_tpu/models/transformer.py`` for one device:
``TransformerConfig``, ``init_params``, ``forward``, ``loss_fn``,
``make_optimizer``, ``make_train_step`` and ``init_state``
(transformer.py:186-454). Every step matches the JAX forward:

- the embedding gather in ``dtype``;
- the sinusoidal position encoding computed in f32, then cast;
- RMSNorm with the variance in f32, then cast;
- ``jax.nn.gelu``'s default, the tanh approximation;
- ``lax.scan`` over the stacked layers becomes a loop over layer index;
- the tied output projection ``x @ embed.T``;
- with ``n_experts > 0`` the FFN is the top-2 MoE of ``ops/moe.py``
  (transformer.py:56-60, :95-103, :345-360): params ``moe_router`` (L, D,
  E), ``moe_w_in`` (L, E, D, F) and ``moe_w_out`` (L, E, F, D) replace
  ``ff_in``/``ff_out``, each layer's aux loss is summed over the layers,
  and ``loss_fn`` adds ``moe_aux_weight`` times it (transformer.py:390).
  With ``n_experts=0`` the param tree and every result are the dense
  model's.

Parameters keep the JAX pytree's names and stacked shapes (``embed``,
``layers/{attn_qkv,attn_out,ln1_scale,ln2_scale,ff_in,ff_out}``,
``ln_f_scale``), and the optimizer state keeps optax's layout, so the
flattened logical paths of a train state are identical in both packages
and a snapshot written by either restores into the other.
:func:`params_from_numpy` and :func:`params_to_numpy` carry parameters
across as numpy arrays. :func:`value_and_grad`, :func:`make_optimizer`
and :func:`apply_step` serve the other models of ``models/`` too.

``attn_impl``: ``"auto"`` resolves to the flash kernels on a CUDA tensor
and, on a CPU tensor, to ``"blockwise"`` when S exceeds
``attn_block_size`` and to ``"dense"`` otherwise, as the JAX package
resolves it off the TPU; ``"flash"`` calls ``ops.flash_attention`` (the
kernels on CUDA whatever S, their plain versions on CPU); ``"blockwise"``
is the online-softmax scan and ``"dense"`` the reference attention. The
layer body (:func:`_body`) is the same on one device and under a mesh:
a plan says which groups, positions, attention and experts it runs.

Training is in place: :func:`make_optimizer`'s ``update`` and the train
step write the new params, moments, ``count`` and ``step`` into the
tensors they were given. A resume is bit-identical on CUDA only under
``torch.use_deterministic_algorithms(True)`` (the embedding gather's and
the target gather's backward are scatter-adds); the flash kernels have no
atomics and need nothing more.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import blockwise_attention, dense_attention, pick_block_size
from ..ops.flash_attention import flash
from ..ops.moe import moe_ffn
from ..parallel import comm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"  # "auto" | "dense" | "blockwise" | "flash"
    attn_block_size: int = 512
    # n_experts > 0 swaps the dense FFN for a top-2 MoE (ops/moe.py).
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: Optional[str] = None
) -> Params:
    """Random parameters in the JAX layout (stacked layers), drawn from
    ``generator`` on the CPU and moved to ``device``. torch and JAX draw
    different numbers from one seed; tests carry JAX's parameters across
    with :func:`params_from_numpy` instead."""
    c = cfg
    dev = resolve_device(device)
    L, D, Fd = c.n_layers, c.d_model, c.d_ff

    def norm(shape, fan_in):
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * fan_in**-0.5
        return t.to(dev, c.param_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=c.param_dtype, device=dev)

    layers = {
        "attn_qkv": norm((L, D, 3 * D), D),
        "attn_out": norm((L, D, D), D),
        "ln1_scale": ones((L, D)),
        "ln2_scale": ones((L, D)),
    }
    if c.n_experts > 0:
        E = c.n_experts
        layers["moe_router"] = norm((L, D, E), D)
        layers["moe_w_in"] = norm((L, E, D, Fd), D)
        layers["moe_w_out"] = norm((L, E, Fd, D), Fd)
    else:
        layers["ff_in"] = norm((L, D, Fd), D)
        layers["ff_out"] = norm((L, Fd, D), Fd)
    return {"embed": norm((c.vocab_size, D), D), "layers": layers, "ln_f_scale": ones((D,))}


def params_from_numpy(tree: Dict[str, Any], device: Optional[str] = None) -> Params:
    """A JAX parameter tree (nested dicts of arrays, any model of
    ``models/``), as numpy arrays, as port tensors on ``device``: same
    names, shapes and dtypes."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The port's parameters as numpy arrays in the JAX tree layout."""

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().cpu().numpy()

    return conv(params)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # The variance in f32 (f64 for an f64 x: a float64 reference run).
    var = x.to(torch.promote_types(x.dtype, torch.float32)).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def _position_encoding(S: int, d_model: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(S, device=device, dtype=torch.float32)[None, :, None]
    dims = torch.arange(d_model // 2, device=device, dtype=torch.float32)[None, None, :]
    inv_freq = 10000.0 ** (-2.0 * dims / d_model)
    angles = pos * inv_freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


_CP_IMPLS = ("ring", "zigzag", "ulysses")
_IMPLS = ("auto", "dense", "blockwise", "flash") + _CP_IMPLS


def _resolve_attn_impl(cfg: TransformerConfig, device: torch.device, S: int) -> str:
    if cfg.attn_impl not in _IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.attn_impl in _CP_IMPLS:
        # One device, no axis to communicate over: the same math, dense
        # (transformer.py:214-215).
        return "dense"
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if device.type == "cuda":
        return "flash"
    return "blockwise" if S > cfg.attn_block_size else "dense"


def attend(impl: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    """Causal attention on ``(B, S, H, hd)`` by the route ``impl``
    (``flash``, ``blockwise`` or ``dense``). On a CUDA tensor ``flash`` is
    the kernels whatever S (they tile it themselves); on a CPU tensor
    ``flash`` and ``blockwise`` need a block that divides S, as in the JAX
    package, and are dense otherwise."""
    bs = pick_block_size(q.shape[1], cfg.attn_block_size)
    if impl == "flash" and (q.is_cuda or bs is not None):
        return flash(q, k, v, causal=True)
    if impl == "blockwise" and bs is not None:
        return blockwise_attention(q, k, v, block_size=bs, causal=True)
    return dense_attention(q, k, v, causal=True)


class _Plan:
    """Where the layer body of :func:`_body` runs. This is one device's
    plan: groups of one (every collective of ``parallel.comm`` is then the
    identity), tokens at positions ``0 .. S-1``, the attention route of
    ``attn_impl`` and the whole MoE. ``models/transformer_mesh.py``'s plan
    gives a rank its groups, positions, routes and experts."""

    g_model, r_model, n_model = None, 0, 1

    def __init__(self, cfg: TransformerConfig, S: int, device: torch.device) -> None:
        self.cfg, self.S = cfg, S
        self.positions = torch.arange(S, device=device)
        self.impl = _resolve_attn_impl(cfg, device, S)

    def attention(self, q, k, v):
        return attend(self.impl, q, k, v, self.cfg)

    def moe(self, layers: Params, l: int, h: torch.Tensor):
        moe = {
            "router": layers["moe_router"][l],
            "w_in": layers["moe_w_in"][l],
            "w_out": layers["moe_w_out"][l],
        }
        return moe_ffn(moe, h, capacity_factor=self.cfg.moe_capacity_factor)


def _body(params: Params, tokens: torch.Tensor, plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model on ``plan``'s blocks: ``params`` this rank's blocks of
    :func:`param_specs` (the whole tree on one device), ``tokens`` (B, S)
    the tokens it computes. Returns their logits in ``dtype`` and the
    summed MoE aux loss. Under tensor parallelism ``embed`` and
    ``attn_qkv`` are split on their last dim: their bf16 weights are
    all-gathered over ``model``, and this rank takes its heads' columns of
    ``attn_qkv``; ``attn_out`` and ``ff_out`` are row-parallel, so their
    products are summed over ``model``."""
    c = plan.cfg
    dt = c.dtype
    g_model, r_model, n_model = plan.g_model, plan.r_model, plan.n_model
    B, S = tokens.shape
    D, D_l, H_l = c.d_model, c.d_model // n_model, c.n_heads // n_model
    # index_select, not x[tokens]: its CUDA backward is deterministic under
    # torch.use_deterministic_algorithms, which a bit-identical resume needs.
    emb = comm.all_gather(params["embed"].to(dt), g_model, dim=1)  # (V, D)
    x = emb.index_select(0, tokens.reshape(-1).long()).reshape(B, S, D)
    pe = _position_encoding(plan.S, D, tokens.device)
    x = x + pe.index_select(1, plan.positions).to(dt)
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l in range(c.n_layers):
        h = _rmsnorm(x, layers["ln1_scale"][l])
        w = comm.all_gather(layers["attn_qkv"][l].to(dt), g_model, dim=1)  # (D, 3D)
        w = w.reshape(D, 3, n_model, D_l)[:, :, r_model].reshape(D, 3 * D_l)
        q, k, v = (t.reshape(B, S, H_l, c.head_dim) for t in (h @ w).chunk(3, dim=-1))
        attn = plan.attention(q, k, v).reshape(B, S, D_l)
        x = x + comm.all_reduce(attn @ layers["attn_out"][l].to(dt), g_model)
        h = _rmsnorm(x, layers["ln2_scale"][l])
        if c.n_experts > 0:
            y, l_aux = plan.moe(layers, l, h)
            x = x + y
            aux = aux + l_aux
        else:
            h = F.gelu(h @ layers["ff_in"][l].to(dt), approximate="tanh")
            x = x + comm.all_reduce(h @ layers["ff_out"][l].to(dt), g_model)
    x = _rmsnorm(x, params["ln_f_scale"])
    return x @ emb.T, aux


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    mesh: Any = None,
    with_aux: bool = False,
):
    """Causal LM forward: (batch, seq) int tokens -> (batch, seq, vocab)
    logits in ``cfg.dtype``, and with ``with_aux`` the f32 MoE aux loss
    summed over the layers (0 for a dense FFN). Differentiable in
    ``params``. With ``mesh`` (a ``DeviceMesh``), the mesh path of
    ``models/transformer_mesh.py``: ``tokens`` is the global batch and the
    logits come back global on every rank."""
    if mesh is not None:
        from . import transformer_mesh

        return transformer_mesh.forward(params, tokens, cfg, mesh, with_aux=with_aux)
    logits, aux = _body(params, tokens, _Plan(cfg, tokens.shape[1], tokens.device))
    return (logits, aux) if with_aux else logits


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``log_softmax(logits.float())`` at ``targets``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    # gather, not nll_loss: nll_loss refuses deterministic mode on CUDA.
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def loss_fn(
    params: Params, batch: Dict[str, torch.Tensor], cfg: TransformerConfig, *, mesh: Any = None
) -> torch.Tensor:
    """Mean next-token NLL at ``batch["targets"]``, plus ``moe_aux_weight``
    times the aux loss with an MoE FFN (transformer.py:379-390). With
    ``mesh``, the global loss on every rank (``models/transformer_mesh.py``)."""
    if mesh is not None:
        from . import transformer_mesh

        return transformer_mesh.loss_fn(params, batch, cfg, mesh)
    logits, aux = forward(params, batch["tokens"], cfg, with_aux=True)
    loss = _token_nll(logits, batch["targets"])
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    """Tensor leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def value_and_grad(fn: Callable[..., torch.Tensor], params: Params, *args: Any):
    """``jax.value_and_grad(fn)(params, *args)``: the value and a gradient
    tree shaped like ``params``. ``params`` themselves are left without
    grad."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    with torch.enable_grad():
        value = fn(_rebuild(params, iter(leaves)), *args)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), _rebuild(params, iter(grads))


def loss_and_grads(
    params: Params, batch: Dict[str, torch.Tensor], cfg: TransformerConfig
) -> Tuple[torch.Tensor, Params]:
    """``jax.value_and_grad(loss_fn)``: the loss and a gradient tree shaped
    like ``params``."""
    return value_and_grad(loss_fn, params, batch, cfg)


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: same name, fields and leaf dtypes
    (count int32 0-d; mu and nu shaped like the params)."""

    count: torch.Tensor
    mu: Params
    nu: Params


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: the state of a stateless transformation."""


class Optimizer(NamedTuple):
    """``optax.GradientTransformation``'s two functions, except that
    ``update(grads, opt_state, params)`` applies the step in place to the
    params and the state's tensors and returns the state."""

    init: Callable[[Params], Tuple[ScaleByAdamState, EmptyState, EmptyState]]
    update: Callable[..., Tuple[ScaleByAdamState, EmptyState, EmptyState]]


_INT32_MAX = 2**31 - 1
_B1, _B2, _EPS, _WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.01


def make_optimizer(lr: float = 1e-3) -> Optimizer:
    """``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01)``
    (transformer.py:393-394) on every leaf, in optax's state layout
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())`` and
    optax's order of arithmetic: count + 1 first (held at the int32
    maximum), the moment updates, bias correction by ``1 - b**count``,
    ``mu_hat / (sqrt(nu_hat) + eps)``, ``+ weight_decay * p``, ``* -lr``,
    then ``p + update``."""

    def init(params: Params):
        zeros = lambda: _rebuild(params, (torch.zeros_like(p) for p in _leaves(params)))
        count = torch.zeros((), dtype=torch.int32, device=next(_leaves(params)).device)
        return ScaleByAdamState(count=count, mu=zeros(), nu=zeros()), EmptyState(), EmptyState()

    @torch.no_grad()
    def update(grads: Params, opt_state, params: Params):
        adam = opt_state[0]
        adam.count.copy_(torch.where(adam.count < _INT32_MAX, adam.count + 1, adam.count))
        bc1 = 1 - _B1**adam.count
        bc2 = 1 - _B2**adam.count
        for g, mu, nu, p in zip(
            _leaves(grads), _leaves(adam.mu), _leaves(adam.nu), _leaves(params)
        ):
            mu.mul_(_B1).add_(g * (1 - _B1))
            nu.mul_(_B2).add_(g * g * (1 - _B2))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            u = (u + _WEIGHT_DECAY * p) * -lr
            p.add_(u)
        return opt_state

    return Optimizer(init, update)


def make_train_step(
    cfg: TransformerConfig, opt: Optimizer, *, mesh: Any = None
) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]], Tuple[Dict[str, Any], torch.Tensor]]:
    """``train_step(state, batch) -> (state, loss)`` with ``state =
    {"params", "opt_state", "step"}`` (transformer.py:397-420). The step
    updates the state's tensors in place and returns the same dict. With
    ``mesh`` (a ``DeviceMesh``), the state is ``init_state(mesh=)``'s
    DTensors and the batch global (``models/transformer_mesh.py``)."""
    if mesh is not None:
        from . import transformer_mesh

        return transformer_mesh.make_train_step(cfg, opt, mesh)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return apply_step(state, "opt_state", opt, loss_and_grads(state["params"], batch, cfg))

    return train_step


def apply_step(state: Dict[str, Any], opt_key: str, opt: Optimizer, loss_and_grads_):
    """The in-place tail of a train step: the optimizer update of
    ``state["params"]`` and ``state[opt_key]`` by the gradients, then
    ``step + 1``; returns ``(state, loss)``."""
    loss, grads = loss_and_grads_
    opt.update(grads, state[opt_key], state["params"])
    with torch.no_grad():
        state["step"].add_(1)
    return state, loss


def init_state(
    generator: torch.Generator,
    cfg: TransformerConfig,
    opt: Optimizer,
    device: Optional[str] = None,
    *,
    mesh: Any = None,
) -> Dict[str, Any]:
    """``{params, opt_state, step}`` (transformer.py:423-454): parameters
    from ``generator``, the optimizer's zero state, step an int32 0-d
    tensor. On CUDA unless ``device="cpu"`` is passed. With ``mesh``,
    every leaf is a DTensor on it, placed by :func:`state_specs` (the
    scalars replicated): every rank draws the whole state from
    ``generator`` and keeps its blocks."""
    if mesh is not None:
        from . import transformer_mesh

        return transformer_mesh.init_state(generator, cfg, opt, mesh, device)
    params = init_params(cfg, generator, device)
    return {
        "params": params,
        "opt_state": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=params["embed"].device),
    }


def param_specs(cfg: TransformerConfig) -> Params:
    """Specs of each param on a ``('data', 'seq', 'model')`` mesh
    (transformer.py:111-136): column-parallel (output dim on ``model``)
    ``attn_qkv`` and ``ff_in``, row-parallel (input dim on ``model``)
    ``attn_out`` and ``ff_out``, ``embed`` on D, the experts of an MoE
    FFN on ``model`` with the router replicated, norm scales replicated."""
    from ..parallel.mesh import P

    layers = {
        "attn_qkv": P(None, None, "model"),
        "attn_out": P(None, "model", None),
        "ln1_scale": P(None, None),
        "ln2_scale": P(None, None),
    }
    if cfg.n_experts > 0:
        layers["moe_router"] = P(None, None, None)
        layers["moe_w_in"] = P(None, "model", None, None)
        layers["moe_w_out"] = P(None, "model", None, None)
    else:
        layers["ff_in"] = P(None, None, "model")
        layers["ff_out"] = P(None, "model", None)
    return {"embed": P(None, "model"), "layers": layers, "ln_f_scale": P(None)}


def state_specs(cfg: TransformerConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of ``init_state``'s tree (transformer.py:457-466): Adam's
    moments take their param's spec, the scalars are replicated."""
    from ..parallel.mesh import P, optax_state_specs

    p_specs = param_specs(cfg)
    return {
        "params": p_specs,
        "opt_state": optax_state_specs(p_specs, state["opt_state"]),
        "step": P(),
    }
