"""The flagship decoder-only transformer, single device, serving path.

Counterpart of ``torchsnapshot_tpu/models/transformer.py`` for one device
and a dense FFN: ``TransformerConfig``, ``init_params`` and ``forward``
(transformer.py:186-370). Every step matches the JAX forward:

- the embedding gather in ``dtype``;
- the sinusoidal position encoding computed in f32, then cast;
- RMSNorm with the variance in f32, then cast;
- ``jax.nn.gelu``'s default, the tanh approximation;
- ``lax.scan`` over the stacked layers becomes a loop over layer index;
- the tied output projection ``x @ embed.T``.

Parameters keep the JAX pytree's names and stacked shapes (``embed``,
``layers/{attn_qkv,attn_out,ln1_scale,ln2_scale,ff_in,ff_out}``,
``ln_f_scale``), so their flattened logical paths are identical and a
snapshot written by either package restores into the other.
:func:`params_from_numpy` and :func:`params_to_numpy` carry parameters
across as numpy arrays.

``attn_impl``: ``"auto"`` resolves to the flash kernel on a CUDA tensor and
to the plain dense attention on a CPU tensor; ``"flash"`` calls
``ops.flash_attention`` (kernel on CUDA, its plain version on CPU);
``"dense"`` is the reference attention. Training (``loss_fn``,
``make_train_step``, the optimizer) is the next slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import dense_attention, pick_block_size
from ..ops.flash_attention import flash_attention

Params = Dict[str, Any]

_LAYER_KEYS = ("attn_qkv", "attn_out", "ln1_scale", "ln2_scale", "ff_in", "ff_out")


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
    attn_impl: str = "auto"  # "auto" | "dense" | "flash"
    attn_block_size: int = 512

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

    return {
        "embed": norm((c.vocab_size, D), D),
        "layers": {
            "attn_qkv": norm((L, D, 3 * D), D),
            "attn_out": norm((L, D, D), D),
            "ln1_scale": ones((L, D)),
            "ln2_scale": ones((L, D)),
            "ff_in": norm((L, D, Fd), D),
            "ff_out": norm((L, Fd, D), Fd),
        },
        "ln_f_scale": ones((D,)),
    }


def params_from_numpy(tree: Dict[str, Any], device: Optional[str] = None) -> Params:
    """The JAX package's parameter tree, as numpy arrays, as port tensors
    on ``device`` (same names, shapes and dtypes)."""
    dev = _resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return {
        "embed": conv(tree["embed"]),
        "layers": {k: conv(tree["layers"][k]) for k in _LAYER_KEYS},
        "ln_f_scale": conv(tree["ln_f_scale"]),
    }


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The port's parameters as numpy arrays in the JAX tree layout."""

    def conv(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    return {
        "embed": conv(params["embed"]),
        "layers": {k: conv(params["layers"][k]) for k in _LAYER_KEYS},
        "ln_f_scale": conv(params["ln_f_scale"]),
    }


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def _position_encoding(S: int, d_model: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(S, device=device, dtype=torch.float32)[None, :, None]
    dims = torch.arange(d_model // 2, device=device, dtype=torch.float32)[None, None, :]
    inv_freq = 10000.0 ** (-2.0 * dims / d_model)
    angles = pos * inv_freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _resolve_attn_impl(cfg: TransformerConfig, device: torch.device) -> str:
    if cfg.attn_impl not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.attn_impl == "auto":
        return "flash" if device.type == "cuda" else "dense"
    return cfg.attn_impl


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Causal LM forward: (batch, seq) int tokens -> (batch, seq, vocab)
    logits in ``cfg.dtype``."""
    c = cfg
    B, S = tokens.shape
    impl = _resolve_attn_impl(c, tokens.device)

    def attention(q, k, v):
        if impl == "flash":
            bs = pick_block_size(S, c.attn_block_size)
            if bs is not None:
                return flash_attention(q, k, v, causal=True, block_q=bs, block_k=bs)
        return dense_attention(q, k, v, causal=True)

    x = params["embed"].to(c.dtype)[tokens]  # (B, S, D)
    x = x + _position_encoding(S, c.d_model, tokens.device).to(c.dtype)
    layers = params["layers"]
    for l in range(c.n_layers):
        h = _rmsnorm(x, layers["ln1_scale"][l])
        qkv = h @ layers["attn_qkv"][l].to(c.dtype)
        q, k, v = (t.reshape(B, S, c.n_heads, c.head_dim) for t in qkv.chunk(3, dim=-1))
        attn = attention(q, k, v).reshape(B, S, c.d_model)
        x = x + attn @ layers["attn_out"][l].to(c.dtype)
        h = _rmsnorm(x, layers["ln2_scale"][l])
        h = F.gelu(h @ layers["ff_in"][l].to(c.dtype), approximate="tanh")
        x = x + h @ layers["ff_out"][l].to(c.dtype)
    x = _rmsnorm(x, params["ln_f_scale"])
    return x @ params["embed"].to(c.dtype).T
