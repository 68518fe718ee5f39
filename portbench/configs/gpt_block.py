"""The dense GPT-family block both configurations run: its initial
parameters, the names of its leaves, its FLOPs per step, and its plain
float32 reference.

A configuration file names this module under ``reference``; the harness,
the judge and ``train_mfu`` take from it what belongs to the block, so a
configuration with another block brings a module of its own:

- :func:`make_params`: the initial parameter tree in the port's layout
  (layers stacked), drawn on the device from the benchmark's generator;
- :func:`named_leaves`: the tree's leaves by the published model's names,
  one layer's slice of a stacked tensor each (``layers.<name>.<l>``);
- :func:`model_flops_per_step`: the published model's matrix work;
- :func:`follow`: the reference's first steps.

The reference is written from the published description of a pre-norm
decoder and the configuration file's ``block`` and ``optimizer`` entries,
in plain ``torch`` operations, with TF32 off. It imports nothing of the
port or of JAX and takes only what the benchmark made: the initial
parameter tree (copied) and the token batches.

Per layer: ``x += W_o attn(q, k, v)`` with ``q, k, v`` the three column
blocks of ``RMSNorm(x) @ W_qkv`` split into heads, causal softmax at
``d_head ** -0.5``; then ``x += gelu_tanh(RMSNorm(x) @ W_in) @ W_out``.
The input is the embedding plus a sinusoidal encoding (``sin`` of
``pos * 10000 ** (-2 i / D)`` over the first half of the dims, ``cos``
over the second); the logits are ``RMSNorm(x) @ embed.T``; the loss is
the mean next-token negative log-likelihood. AdamW as optax computes it:
moments, bias correction, ``mu_hat / (sqrt(nu_hat) + eps)``, plus weight
decay times the parameter, times ``-lr``.

:func:`follow` runs the first steps over blocks of batch rows, summing
the gradient of each block's share of the mean loss, so that it fits
beside nothing else on the card. ``precision="fp8"`` is the control: each
product's operands are rounded to float8 e4m3 with a per-tensor scale,
and the gradient entering each product's backward to e5m2, the usual
recipe for float8 training.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.judge import norm

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

LAYER_LEAVES = ("attn_qkv", "attn_out", "ln1_scale", "ln2_scale", "ff_in", "ff_out")


def make_params(port: Dict, g: torch.Generator, device: torch.device) -> Dict:
    """The initial parameters in the port's layout (layers stacked), f32,
    drawn on ``device`` from ``g``: each matrix N(0, 1/fan_in) in one
    call, each norm scale 1."""
    V, D, F_, L = port["vocab_size"], port["d_model"], port["d_ff"], port["n_layers"]

    def normal(shape, fan_in):
        return torch.randn(shape, generator=g, device=device).mul_(fan_in**-0.5)

    def ones(shape):
        return torch.ones(shape, device=device)

    layers = {
        "attn_qkv": normal((L, D, 3 * D), D),
        "attn_out": normal((L, D, D), D),
        "ln1_scale": ones((L, D)),
        "ln2_scale": ones((L, D)),
        "ff_in": normal((L, D, F_), D),
        "ff_out": normal((L, F_, D), F_),
    }
    return {"embed": normal((V, D), D), "layers": layers, "ln_f_scale": ones((D,))}


def named_leaves(params: Dict) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every leaf of ``params``, layer slices as
    views of the stacked tensors."""
    yield "embed", params["embed"]
    for name in LAYER_LEAVES:
        stacked = params["layers"][name]
        for l in range(stacked.shape[0]):
            yield f"layers.{name}.{l}", stacked[l]
    yield "ln_f_scale", params["ln_f_scale"]


def model_flops_per_step(port: Dict, batch: int, seq_len: int) -> int:
    """The published model's FLOPs in one train step, counted as MFU
    counts them (no recomputation): 6 per matmul parameter per token
    (forward 2, backward 4), the tied head's product included, and causal
    attention's two dots forward and four backward, 2 * d_head FLOPs per
    attended (query, key) pair each."""
    D, F_, L, V, H = (port[k] for k in ("d_model", "d_ff", "n_layers", "vocab_size", "n_heads"))
    matmul_params = L * (3 * D * D + D * D + 2 * D * F_) + V * D
    pairs = batch * H * seq_len * (seq_len + 1) // 2
    return 6 * matmul_params * batch * seq_len + L * 6 * 2 * (D // H) * pairs


def _fp8_round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    fmax = torch.finfo(dtype).max
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = fmax / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8_round(a, torch.float8_e4m3fn), _fp8_round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8_round(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


MATMULS: Dict[str, Matmul] = {"f32": torch.matmul, "fp8": _Fp8Matmul.apply}


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def _positions(S: int, D: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(S, device=device, dtype=torch.float32)[:, None]
    inv_freq = 10000.0 ** (-2.0 * torch.arange(D // 2, device=device, dtype=torch.float32) / D)
    return torch.cat([torch.sin(pos * inv_freq), torch.cos(pos * inv_freq)], dim=-1)


def nll_sum(p: Dict[str, torch.Tensor], tokens: torch.Tensor, targets: torch.Tensor,
            cfg: Dict, mm: Matmul) -> torch.Tensor:
    """The summed next-token NLL of ``tokens`` (B, S) at ``targets``."""
    port = cfg["port"]
    L, D, H = port["n_layers"], port["d_model"], port["n_heads"]
    eps = cfg["block"]["norm_eps"]
    B, S = tokens.shape
    hd = D // H
    x = p["embed"][tokens] + _positions(S, D, tokens.device)
    causal = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    for l in range(L):
        h = _rmsnorm(x, p[f"layers.ln1_scale.{l}"], eps)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
                   for t in mm(h, p[f"layers.attn_qkv.{l}"]).chunk(3, dim=-1))
        s = mm(q, k.transpose(-1, -2)) * hd**-0.5
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = mm(a, v).transpose(1, 2).reshape(B, S, D)
        x = x + mm(o, p[f"layers.attn_out.{l}"])
        h = _rmsnorm(x, p[f"layers.ln2_scale.{l}"], eps)
        h = F.gelu(mm(h, p[f"layers.ff_in.{l}"]), approximate="tanh")
        x = x + mm(h, p[f"layers.ff_out.{l}"])
    logits = mm(_rmsnorm(x, p["ln_f_scale"], eps), p["embed"].transpose(0, 1))
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).sum()


def follow(params0: Dict, batches: Sequence[Dict[str, torch.Tensor]], cfg: Dict,
           rows_per_block: int, precision: str = "f32") -> Dict:
    """Train a float32 copy of ``params0`` over ``batches`` (one step
    each). Returns each step's mean loss, each leaf's gradient norm at the
    first step and each leaf's change after the last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = MATMULS[precision]
    opt = cfg["optimizer"]
    b1, b2, eps, wd, lr = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["lr"]
    start = {name: t.detach().float().clone() for name, t in named_leaves(params0)}
    p = {name: t.clone().requires_grad_(True) for name, t in start.items()}
    mu = {name: torch.zeros_like(t) for name, t in start.items()}
    nu = {name: torch.zeros_like(t) for name, t in start.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches, start=1):
        tokens, targets = batch["tokens"], batch["targets"]
        n_tokens = tokens.numel()
        total = 0.0
        for lo in range(0, tokens.shape[0], rows_per_block):
            rows = slice(lo, lo + rows_per_block)
            block = nll_sum(p, tokens[rows].long(), targets[rows].long(), cfg, mm) / n_tokens
            block.backward()
            total += float(block.detach())
        losses.append(total)
        with torch.no_grad():
            if step == 1:
                grad_norms = {name: norm(t.grad) for name, t in p.items()}
            for name, t in p.items():
                g = t.grad
                mu[name].mul_(b1).add_(g, alpha=1 - b1)
                nu[name].mul_(b2).add_(g * g, alpha=1 - b2)
                u = (mu[name] / (1 - b1**step)) / (torch.sqrt(nu[name] / (1 - b2**step)) + eps)
                t.add_((u + wd * t) * -lr)
                t.grad = None
    with torch.no_grad():
        change = {name: norm(p[name] - start[name]) for name in p}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

