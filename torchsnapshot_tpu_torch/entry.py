"""The port's counterparts of ``__graft_entry__.entry()`` and of its train
state.

Both use the configuration the JAX entry point uses (vocab 8192, d_model
512, 8 heads, 4 layers, d_ff 2048, tokens (4, 256), bf16 compute, f32
params), with random parameters drawn from ``seed``, and run on CUDA
unless ``device="cpu"`` is passed:

- ``entry()`` returns ``(fn, (params, tokens))``: the serving forward,
  graph-free under ``torch.inference_mode``;
- ``train_entry()`` returns ``(train_step, (state, batch))``: one AdamW
  step of the train state ``{params, opt_state, step}`` on a batch of
  tokens and targets drawn from the seed, in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .models import transformer as T

ENTRY_CONFIG = T.TransformerConfig(
    vocab_size=8192,
    d_model=512,
    n_heads=8,
    n_layers=4,
    d_ff=2048,
    max_seq_len=256,
)
ENTRY_TOKENS_SHAPE = (4, 256)


def entry(
    device: Optional[str] = None, seed: int = 0, cfg: T.TransformerConfig = ENTRY_CONFIG
) -> Tuple[Callable[..., torch.Tensor], Tuple[Any, ...]]:
    params = T.init_params(cfg, torch.Generator().manual_seed(seed), device)
    tokens = torch.zeros(ENTRY_TOKENS_SHAPE, dtype=torch.int64, device=params["embed"].device)

    def fn(params: T.Params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return T.forward(params, tokens, cfg)

    return fn, (params, tokens)


def train_entry(
    device: Optional[str] = None, seed: int = 0
) -> Tuple[Callable[..., Any], Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    opt = T.make_optimizer()
    gen = torch.Generator().manual_seed(seed)
    state = T.init_state(gen, ENTRY_CONFIG, opt, device)
    dev = state["params"]["embed"].device
    batch = {
        name: torch.randint(0, ENTRY_CONFIG.vocab_size, ENTRY_TOKENS_SHAPE, generator=gen).to(dev)
        for name in ("tokens", "targets")
    }
    return T.make_train_step(ENTRY_CONFIG, opt), (state, batch)
