"""Embedding model (the DLRM checkpointing workload), one device.

Counterpart of ``torchsnapshot_tpu/models/embedding.py`` (:31-165) without
a mesh: ``EmbeddingConfig`` with ``param_count``, ``init_params``,
``forward``, ``loss_fn``, ``init_state`` and ``make_train_step``.
``n_tables`` tables of ``(rows_per_table, dim)``, one id per table and
example; the looked-up rows and the dense features are concatenated and
go through an MLP (ReLU between layers) to one logit. The loss is the mean
sigmoid binary cross-entropy, written out to optax's formula
(``-labels * log_sigmoid(logits) - (1 - labels) * log_sigmoid(-logits)``).

Parameters keep the JAX pytree's names and shapes (``tables/table_<i>``,
``mlp/{w<j>,b<j>}``) and the train state is ``{"params", "opt_state",
"step"}``, so train-state logical paths are identical in both packages.
The JAX package's ``init_state``/``make_train_step`` take any optax
transformation; the port's take its own optimizer
(``transformer.make_optimizer``: AdamW in optax's state layout). Weights
carry across as numpy with ``params_from_numpy``/``params_to_numpy`` (the
transformer's, re-exported here).

Lookups are ``index_select``, whose backward on CUDA is deterministic
under ``torch.use_deterministic_algorithms(True)``. A ``mesh`` (row-wise
sharded tables) is not ported yet and raises by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .transformer import (  # noqa: F401 - params_*_numpy re-exported
    Optimizer,
    apply_step,
    params_from_numpy,
    params_to_numpy,
    value_and_grad,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    n_tables: int = 8
    rows_per_table: int = 100_000
    dim: int = 64
    n_dense_features: int = 13
    mlp_hidden: Tuple[int, ...] = (256, 64)
    param_dtype: torch.dtype = torch.float32

    @property
    def param_count(self) -> int:
        n = self.n_tables * self.rows_per_table * self.dim
        widths = (self.n_dense_features + self.n_tables * self.dim,) + self.mlp_hidden
        for a, b in zip(widths, widths[1:] + (1,)):
            n += a * b + b
        return n


def _refuse_mesh(what: str, mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...): row-wise sharded embedding tables are not ported "
            "yet; the port runs the embedding model on one device"
        )


def init_params(
    cfg: EmbeddingConfig, generator: torch.Generator, device: Optional[str] = None
) -> Params:
    """Random parameters in the JAX layout, drawn from ``generator`` on the
    CPU and moved to ``device``: tables at scale dim**-0.5, MLP weights at
    fan_in**-0.5, biases zero."""
    dev = resolve_device(device)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
        return t.to(dev, cfg.param_dtype)

    tables = {
        f"table_{i}": normal((cfg.rows_per_table, cfg.dim), cfg.dim**-0.5)
        for i in range(cfg.n_tables)
    }
    widths = (cfg.n_dense_features + cfg.n_tables * cfg.dim,) + tuple(cfg.mlp_hidden) + (1,)
    mlp = {}
    for j, (fan_in, fan_out) in enumerate(zip(widths, widths[1:])):
        mlp[f"w{j}"] = normal((fan_in, fan_out), fan_in**-0.5)
        mlp[f"b{j}"] = torch.zeros((fan_out,), dtype=cfg.param_dtype, device=dev)
    return {"tables": tables, "mlp": mlp}


def forward(
    params: Params, dense: torch.Tensor, sparse_ids: torch.Tensor, cfg: EmbeddingConfig
) -> torch.Tensor:
    """``dense`` (B, n_dense_features), ``sparse_ids`` (B, n_tables) ->
    logits (B,)."""
    looked_up = [
        params["tables"][f"table_{i}"].index_select(0, sparse_ids[:, i].long())
        for i in range(cfg.n_tables)
    ]
    x = torch.cat([dense] + looked_up, dim=-1)
    n_layers = len(cfg.mlp_hidden) + 1
    for j in range(n_layers):
        x = x @ params["mlp"][f"w{j}"] + params["mlp"][f"b{j}"]
        if j < n_layers - 1:
            x = torch.relu(x)
    return x[:, 0]


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, element-wise."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: EmbeddingConfig) -> torch.Tensor:
    logits = forward(params, batch["dense"], batch["sparse_ids"], cfg)
    return sigmoid_binary_cross_entropy(logits, batch["labels"]).mean()


def init_state(
    generator: torch.Generator,
    cfg: EmbeddingConfig,
    opt: Optimizer,
    device: Optional[str] = None,
    *,
    mesh: Any = None,
) -> Dict[str, Any]:
    """``{params, opt_state, step}``: parameters from ``generator``, the
    optimizer's zero state, step an int32 0-d tensor. On CUDA unless
    ``device="cpu"`` is passed."""
    _refuse_mesh("init_state", mesh)
    params = init_params(cfg, generator, device)
    first = params["tables"]["table_0"] if cfg.n_tables else params["mlp"]["w0"]
    return {
        "params": params,
        "opt_state": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def make_train_step(
    cfg: EmbeddingConfig, opt: Optimizer, *, mesh: Any = None
) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]], Tuple[Dict[str, Any], torch.Tensor]]:
    """``train_step(state, batch) -> (state, loss)``: one optimizer step of
    ``state`` in place."""
    _refuse_mesh("make_train_step", mesh)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return apply_step(
            state, "opt_state", opt, value_and_grad(loss_fn, state["params"], batch, cfg)
        )

    return train_step
