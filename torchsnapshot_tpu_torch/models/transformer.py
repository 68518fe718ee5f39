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
kernels on CUDA, their plain versions on CPU); ``"blockwise"`` is the
online-softmax scan and ``"dense"`` the reference attention.

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

from ..ops.attention import blockwise_attention, dense_attention, pick_block_size
from ..ops.flash_attention import flash_attention
from ..ops.moe import moe_ffn

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


def _resolve_device(device: Optional[str]) -> torch.device:
    """Entry points run on CUDA unless the caller asks for the CPU; with no
    CUDA and no CPU request they raise rather than fall back."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torchsnapshot_tpu_torch runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU.'
        )
    return dev


def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: Optional[str] = None
) -> Params:
    """Random parameters in the JAX layout (stacked layers), drawn from
    ``generator`` on the CPU and moved to ``device``. torch and JAX draw
    different numbers from one seed; tests carry JAX's parameters across
    with :func:`params_from_numpy` instead."""
    c = cfg
    dev = _resolve_device(device)
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
    dev = _resolve_device(device)

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


def _resolve_attn_impl(cfg: TransformerConfig, device: torch.device, S: int) -> str:
    if cfg.attn_impl not in ("auto", "dense", "blockwise", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if device.type == "cuda":
        return "flash"
    return "blockwise" if S > cfg.attn_block_size else "dense"


def forward(
    params: Params, tokens: torch.Tensor, cfg: TransformerConfig, *, with_aux: bool = False
):
    """Causal LM forward: (batch, seq) int tokens -> (batch, seq, vocab)
    logits in ``cfg.dtype``, and with ``with_aux`` the f32 MoE aux loss
    summed over the layers (0 for a dense FFN). Differentiable in
    ``params``."""
    c = cfg
    B, S = tokens.shape
    impl = _resolve_attn_impl(c, tokens.device, S)

    def attention(q, k, v):
        bs = pick_block_size(S, c.attn_block_size)
        if impl == "flash" and bs is not None:
            return flash_attention(q, k, v, causal=True, block_q=bs, block_k=bs)
        if impl == "blockwise" and bs is not None:
            return blockwise_attention(q, k, v, block_size=bs, causal=True)
        return dense_attention(q, k, v, causal=True)

    # index_select, not x[tokens]: its CUDA backward is deterministic under
    # torch.use_deterministic_algorithms, which a bit-identical resume needs.
    emb = params["embed"].to(c.dtype)
    x = emb.index_select(0, tokens.reshape(-1).long()).reshape(B, S, c.d_model)
    x = x + _position_encoding(S, c.d_model, tokens.device).to(c.dtype)
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l in range(c.n_layers):
        h = _rmsnorm(x, layers["ln1_scale"][l])
        qkv = h @ layers["attn_qkv"][l].to(c.dtype)
        q, k, v = (t.reshape(B, S, c.n_heads, c.head_dim) for t in qkv.chunk(3, dim=-1))
        attn = attention(q, k, v).reshape(B, S, c.d_model)
        x = x + attn @ layers["attn_out"][l].to(c.dtype)
        h = _rmsnorm(x, layers["ln2_scale"][l])
        if c.n_experts > 0:
            moe = {
                "router": layers["moe_router"][l],
                "w_in": layers["moe_w_in"][l],
                "w_out": layers["moe_w_out"][l],
            }
            y, l_aux = moe_ffn(moe, h, capacity_factor=c.moe_capacity_factor)
            x = x + y
            aux = aux + l_aux
        else:
            h = F.gelu(h @ layers["ff_in"][l].to(c.dtype), approximate="tanh")
            x = x + h @ layers["ff_out"][l].to(c.dtype)
    x = _rmsnorm(x, params["ln_f_scale"])
    logits = x @ params["embed"].to(c.dtype).T
    return (logits, aux) if with_aux else logits


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``log_softmax(logits.float())`` at ``targets``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    # gather, not nll_loss: nll_loss refuses deterministic mode on CUDA.
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token NLL at ``batch["targets"]``, plus ``moe_aux_weight``
    times the aux loss with an MoE FFN (transformer.py:379-390)."""
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
    updates the state's tensors in place and returns the same dict."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): sharded training is not ported yet; "
            "the port trains on one device"
        )

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
) -> Dict[str, Any]:
    """``{params, opt_state, step}`` (transformer.py:423-454): parameters
    from ``generator``, the optimizer's zero state, step an int32 0-d
    tensor. On CUDA unless ``device="cpu"`` is passed."""
    params = init_params(cfg, generator, device)
    return {
        "params": params,
        "opt_state": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=params["embed"].device),
    }
