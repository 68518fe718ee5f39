"""Embedding model (the DLRM checkpointing workload), one device.

Counterpart of ``torchsnapshot_tpu/models/embedding.py`` (:31-165):
``EmbeddingConfig`` with ``param_count``, ``init_params``, ``param_specs``,
``state_specs``, ``forward``, ``loss_fn``, ``init_state`` and
``make_train_step``.
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
under ``torch.use_deterministic_algorithms(True)``.

**Under a mesh** (``mesh=``, a ``DeviceMesh`` over ``data`` and ``model``):
the tables are row-wise sharded, ``P(("data", "model"), None)``, their rows
split over every rank (DTensor ``Shard(0)`` on both mesh dims, ``data``
major); the MLP is replicated and the batch splits over ``data``. GSPMD
gathers the rows for the JAX package; here the lookup is explicit. Every
rank holds the global ids, looks up only the rows it owns (the others
masked to zero), and the partial rows are summed over the mesh, of which
each rank keeps its batch block. The sum's backward all-reduces the rows'
gradients, so a table's gradient lands on the rows this rank owns. Each
rank's loss is its examples' sum over the global batch and the ``model``
ranks that compute the same examples; the MLP's gradients are summed over
the mesh. Adam's moments follow their table's spec (JAX :128-139).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel import comm
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


def param_specs(cfg: EmbeddingConfig) -> Params:
    """Row-wise layout (embedding.py:68-81): table rows split over every
    mesh axis, the MLP replicated."""
    from ..parallel.mesh import P

    mlp = {}
    for j in range(len(cfg.mlp_hidden) + 1):
        mlp[f"w{j}"] = P()
        mlp[f"b{j}"] = P()
    return {
        "tables": {f"table_{i}": P(("data", "model"), None) for i in range(cfg.n_tables)},
        "mlp": mlp,
    }


def state_specs(cfg: EmbeddingConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of ``init_state``'s tree (embedding.py:128-139): Adam's
    moments take their param's spec, the scalars are replicated."""
    from ..parallel.mesh import P, optax_state_specs

    p_specs = param_specs(cfg)
    return {"params": p_specs, "opt_state": optax_state_specs(p_specs, state["opt_state"]),
            "step": P()}


def forward(
    params: Params, dense: torch.Tensor, sparse_ids: torch.Tensor, cfg: EmbeddingConfig
) -> torch.Tensor:
    """``dense`` (B, n_dense_features), ``sparse_ids`` (B, n_tables) ->
    logits (B,)."""
    looked_up = [
        params["tables"][f"table_{i}"].index_select(0, sparse_ids[:, i].long())
        for i in range(cfg.n_tables)
    ]
    return _mlp(params, torch.cat([dense] + looked_up, dim=-1), cfg)


def _mlp(params: Params, x: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
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


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: EmbeddingConfig,
            *, mesh: Any = None) -> torch.Tensor:
    """The mean loss; with ``mesh``, the global loss on every rank."""
    if mesh is not None:
        from ..parallel.mesh import sum_over_mesh

        run = _MeshRun(cfg, mesh, batch["dense"].shape[0])
        return sum_over_mesh(run.local_loss(run.local_params(params), batch), mesh)
    logits = forward(params, batch["dense"], batch["sparse_ids"], cfg)
    return sigmoid_binary_cross_entropy(logits, batch["labels"]).mean()


class _MeshRun:
    """One call's plan on this rank under a mesh (see the module
    docstring)."""

    def __init__(self, cfg: EmbeddingConfig, mesh, B: int):
        from ..parallel.mesh import axis_group, axis_rank, axis_size, check_mesh

        check_mesh(mesh, "embedding")
        self.cfg, self.mesh = cfg, mesh
        n_data, n_model = axis_size(mesh, "data"), axis_size(mesh, "model")
        world = n_data * n_model
        if math.prod(mesh.size(i) for i in range(mesh.ndim)) != world:
            raise ValueError(f"the embedding model's mesh has axes 'data' and 'model' only: {mesh}")
        for what, value, over in (("batch", B, n_data), ("rows_per_table", cfg.rows_per_table,
                                                          world)):
            if value % over:
                raise ValueError(f"{what} {value} does not divide over {over} ranks of {mesh}")
        self.B, self.replicas = B, n_model
        B_l = B // n_data
        self.batch = slice(axis_rank(mesh, "data") * B_l, (axis_rank(mesh, "data") + 1) * B_l)
        self.rows = cfg.rows_per_table // world
        self.lo = (axis_rank(mesh, "data") * n_model + axis_rank(mesh, "model")) * self.rows
        self.groups = [axis_group(mesh, a) for a in ("data", "model")]

    def local_params(self, params: Params) -> Params:
        from .transformer_mesh import local_params

        return local_params(params, param_specs(self.cfg), self.mesh)

    def lookup(self, table_l: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The rows of the global ``ids`` (B,) from the row-sharded table,
        this rank's batch block of them."""
        local = ids.long() - self.lo
        owned = (local >= 0) & (local < self.rows)
        rows = table_l.index_select(0, local.clamp(0, self.rows - 1))
        rows = rows * owned[:, None].to(rows.dtype)
        for g in self.groups:
            rows = comm.all_reduce(rows, g)
        return rows[self.batch]

    def local_loss(self, lp: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = batch["sparse_ids"]
        looked_up = [self.lookup(lp["tables"][f"table_{i}"], ids[:, i])
                     for i in range(self.cfg.n_tables)]
        x = torch.cat([batch["dense"][self.batch]] + looked_up, dim=-1)
        logits = _mlp(lp, x, self.cfg)
        bce = sigmoid_binary_cross_entropy(logits, batch["labels"][self.batch])
        return bce.sum() / (self.B * self.replicas)


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
    ``device="cpu"`` is passed. With ``mesh``, every rank draws the whole
    state on the CPU and keeps its blocks, each leaf a DTensor placed by
    :func:`state_specs`."""
    if mesh is not None:
        from ..parallel.mesh import check_mesh, shard_pytree

        check_mesh(mesh, "init_state")
        state = init_state(generator, cfg, opt, "cpu")
        return shard_pytree(state, state_specs(cfg, state), mesh)
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
    ``state`` in place. With ``mesh``, on ``init_state(mesh=)``'s DTensor
    state and a global batch: every rank steps its own blocks and returns
    the global loss."""
    if mesh is not None:
        return _mesh_train_step(cfg, opt, mesh)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return apply_step(
            state, "opt_state", opt, value_and_grad(loss_fn, state["params"], batch, cfg)
        )

    return train_step


def _mesh_train_step(cfg: EmbeddingConfig, opt: Optimizer, mesh):
    from ..parallel.mesh import check_mesh, local_tree, sum_over_mesh
    from .transformer_mesh import sum_replicated_grads

    check_mesh(mesh, "make_train_step")

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        run = _MeshRun(cfg, mesh, batch["dense"].shape[0])
        lp = local_tree(state["params"])
        part, grads = value_and_grad(run.local_loss, lp, batch)
        grads = sum_replicated_grads(grads, param_specs(cfg), mesh)
        opt.update(grads, local_tree(state["opt_state"]), lp)
        with torch.no_grad():
            local_tree(state["step"]).add_(1)
            loss = sum_over_mesh(part, mesh)
        return state, loss

    return train_step
