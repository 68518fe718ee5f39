"""The port's counterpart of ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, example_args)``: the flagship transformer's
serving forward at the configuration the JAX entry point uses (vocab 8192,
d_model 512, 8 heads, 4 layers, d_ff 2048, tokens (4, 256), bf16 compute,
f32 params), with random parameters drawn from ``seed``. It runs on CUDA
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

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
        return T.forward(params, tokens, cfg)

    return fn, (params, tokens)
