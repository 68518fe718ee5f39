"""The flagship transformer under a ``('data', 'seq', 'model')`` mesh.

Counterpart of the mesh path of ``torchsnapshot_tpu/models/transformer.py``
(:111-157, :160-376, :397-466). GSPMD inserts the collectives there; here
every rank runs the one layer body of ``transformer._body`` on its own
blocks, with this module's plan (:class:`_Run`) in place of one device's,
and the collectives are explicit, through ``parallel/comm.py`` (each a
``torch.autograd.Function`` whose backward is its exact adjoint):

- **dp**: the batch splits over ``data``.
- **cp** (``attn_impl`` ``ring``, ``zigzag`` or ``ulysses``): the sequence
  splits over ``seq``, each rank's tokens carry the position encoding of
  their global positions, and attention is the ring, zigzag or Ulysses
  body over the ``seq`` group. Zigzag holds its tokens in zigzag layout
  from the embedding to the logits (rank i holds chunks i and 2n-1-i), so
  no permute runs inside the model. Other impls keep the whole sequence on
  every ``seq`` rank.
- **tp** (Megatron) over ``model``, on the blocks ``param_specs`` gives
  each rank: ``ff_in`` is column-parallel and ``ff_out`` row-parallel,
  then an all-reduce; ``attn_out`` is row-parallel on this rank's heads,
  then an all-reduce. The stored block of ``attn_qkv`` (a third of its
  columns on 2 ranks) is not this rank's heads, so the bf16 weight is
  all-gathered over ``model`` and the heads' columns taken; ``embed`` is
  split on D, so its bf16 weight is all-gathered too, for the gather of
  the tokens and for the tied logits. The residual stream is whole on
  every ``model`` rank (JAX also splits it over ``model`` between blocks,
  a layout that changes no value).
- **MoE** keeps the JAX numerics, where ``moe_ffn`` routes the *global*
  batch in token order: the normed activations are all-gathered over
  ``seq`` and ``data`` (in global order), every rank routes every token,
  runs its ``E/model`` experts, the partial outputs are summed over
  ``model``, and each rank keeps its tokens.

Gradients: each rank's loss is its tokens' NLL sum over the global token
count and over the number of ranks that compute those same tokens (the
``model`` ranks, and the ``seq`` ranks outside cp), plus the aux loss over
the world, so the losses of all ranks add up to the global loss; a
parameter's gradient is then summed over the mesh axes on which it is
replicated.

Attention on CUDA tensors: ``auto`` and ``flash`` run K1-K3 on each
rank's batch and heads, and ``ring``, ``zigzag`` and ``ulysses`` run them
per hop or per head group, whatever the local length (the kernels tile
any S). On CPU tensors the same routes run the kernels' plain versions,
and ``auto`` and ``flash`` resolve as the JAX package resolves them off
the TPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..ops import moe as M
from ..ops.attention import pick_block_size
from ..parallel import comm
from ..parallel.mesh import (
    P,
    axis_group,
    axis_rank,
    axis_size,
    check_mesh,
    enter,
    leave,
    local_tree,
    map_tree,
    shard_pytree,
    sum_over_mesh,
)
from . import transformer as T

AXES = ("data", "seq", "model")


def _flash_mesh_ok(cfg: T.TransformerConfig, mesh, B: int, S: int) -> bool:
    """Preconditions of the Pallas flash kernels under a mesh
    (transformer.py:144-157): heads divide the ``model`` axis, batch
    divides the ``data`` axis, and S has a tile divisor by the kernels'
    own 512-target pick. The port applies it on CPU tensors only, where it
    decides between the flash split's plain version and the blockwise
    scan as the JAX package decides off the TPU; the CUDA kernels tile any
    S."""
    if cfg.n_heads % axis_size(mesh, "model"):
        return False
    if B % axis_size(mesh, "data"):
        return False
    return S > 0 and pick_block_size(S, 512) is not None


class _Run:
    """One call's plan on this rank (the plan of ``transformer._body``):
    the resolved attention, the groups, this rank's tokens and how many
    ranks compute each of them."""

    def __init__(self, cfg: T.TransformerConfig, mesh, B: int, S: int, device: torch.device):
        from ..ops.ring_attention import zigzag_layout_indices

        check_mesh(mesh, "transformer")
        c = cfg
        if c.attn_impl not in T._IMPLS:
            raise ValueError(f"unknown attn_impl {c.attn_impl!r}")
        cuda = device.type == "cuda"
        impl = c.attn_impl
        if impl == "auto":
            # transformer.py:186-203, with the card in place of the TPU.
            impl = "flash" if cuda else ("blockwise" if S > c.attn_block_size else "dense")
        if impl in T._CP_IMPLS and "seq" not in mesh.mesh_dim_names:
            raise ValueError(
                f"attn_impl={c.attn_impl!r} needs a mesh with a 'seq' axis; got "
                f"{mesh.mesh_dim_names}. Build one via make_mesh({{'data': ..., "
                f"'seq': ..., 'model': ...}})."
            )
        if impl == "flash" and not cuda and not _flash_mesh_ok(c, mesh, B, S):
            impl = "blockwise"  # transformer.py:300-312, off the TPU
        self.cfg, self.mesh, self.impl = c, mesh, impl
        self.cp = impl in T._CP_IMPLS
        self.n = {a: axis_size(mesh, a) for a in AXES}
        self.r = {a: axis_rank(mesh, a) for a in AXES}
        self.g = {a: axis_group(mesh, a) for a in AXES}
        self.g_model, self.r_model, self.n_model = self.g["model"], self.r["model"], self.n["model"]
        self.world = math.prod(mesh.size(i) for i in range(mesh.ndim))
        n_seq, n_model = self.n["seq"], self.n["model"]
        for what, value, over in (
            ("batch", B, self.n["data"]),
            ("seq len", S, (2 * n_seq if impl == "zigzag" else n_seq) if self.cp else 1),
            ("n_heads", c.n_heads, n_model),
            ("d_model", c.d_model, n_model),
            ("d_ff", c.d_ff, n_model),
            ("n_experts", c.n_experts, n_model if c.n_experts else 1),
        ):
            if value % over:
                raise ValueError(f"{what} {value} does not divide over {over} ranks of {mesh}")
        self.B, self.S = B, S
        self.B_l = B // self.n["data"]
        self.S_l = S // n_seq if self.cp else S
        self.batch = slice(self.r["data"] * self.B_l, (self.r["data"] + 1) * self.B_l)
        # The global positions along the seq ranks, in rank order, and this
        # rank's part of them.
        if impl == "zigzag":
            self.layout = zigzag_layout_indices(S, n_seq, device)
        else:
            self.layout = torch.arange(S, device=device)
        lo = self.r["seq"] * self.S_l if self.cp else 0
        self.positions = self.layout[lo : lo + self.S_l]
        # Ranks that compute each of this rank's tokens.
        self.replicas = n_model * (1 if self.cp else n_seq)

    def attention(self, q, k, v):
        """The rings and Ulysses run the flash split per hop: K1-K3 on a
        CUDA tensor whatever the shard's length, the plain versions on a
        CPU tensor (the same numbers as the plain rings)."""
        from ..ops.ring_attention import _ring, _zigzag
        from ..ops.ring_flash import FLASH
        from ..ops.ulysses import ulysses_self_attention

        seq = self.g["seq"]
        if self.impl == "ring":
            return _ring(q, k, v, seq, True, None, FLASH)
        if self.impl == "zigzag":
            return _zigzag(q, k, v, seq, None, FLASH)
        if self.impl == "ulysses":
            return ulysses_self_attention(
                q, k, v, group=seq, causal=True, inner_block_size=self.cfg.attn_block_size
            )
        return T.attend(self.impl, q, k, v, self.cfg)

    def moe(self, layers, l: int, h: torch.Tensor):
        """The MoE FFN of layer ``l`` on the global batch (see the module
        docstring): ``(y for this rank's tokens, aux)``."""
        hg = h
        if self.cp:
            hg = comm.all_gather(hg, self.g["seq"], dim=1)
            hg = hg.index_select(1, torch.argsort(self.layout))  # global order
        hg = comm.all_gather(hg, self.g["data"], dim=0)
        B, S, D = hg.shape
        x2 = hg.reshape(-1, D)
        E = layers["moe_router"][l].shape[1]
        cap = int(max(1, math.ceil(2 * x2.shape[0] * self.cfg.moe_capacity_factor / E)))
        params = {"router": layers["moe_router"][l], "w_in": layers["moe_w_in"][l],
                  "w_out": layers["moe_w_out"][l]}
        y, aux = M.moe_experts(params, x2, E=E, cap=cap, e0=self.r_model * (E // self.n_model),
                               dispatch=M.resolve_dispatch("auto", x2.shape[0], E, cap))
        y = comm.all_reduce(y, self.g_model).reshape(B, S, D)
        return self.local(y), aux

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global (B, S, ...) tensor."""
        return t[self.batch].index_select(1, self.positions)

    def logits_spec(self) -> P:
        return P("data" if "data" in self.mesh.mesh_dim_names else None,
                 "seq" if self.cp else None, None)


def _local_params(params: T.Params, cfg: T.TransformerConfig, mesh) -> T.Params:
    """This rank's blocks: a DTensor's local shard, or a plain tensor's
    block by ``param_specs`` (a global tensor every rank holds whole)."""
    from torch.distributed.tensor import DTensor

    from ..parallel.mesh import placements

    def block(t, spec):
        if isinstance(t, DTensor):
            if list(t.placements) != placements(spec, mesh, t.dim()):
                raise ValueError(
                    f"a param's placements {t.placements} are not its spec {spec!r}'s"
                )
            return t.to_local()
        return enter(t, mesh, spec)

    return map_tree(block, params, T.param_specs(cfg))


def _local_loss(lp: T.Params, tokens_l, targets_l, run: _Run) -> torch.Tensor:
    """This rank's part of the global loss: the parts of all ranks add up
    to it (see the module docstring)."""
    logits, aux = T._body(lp, tokens_l, run)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets_l.long()[..., None]).sum()
    loss = nll / (run.B * run.S * run.replicas)
    if run.cfg.n_experts > 0:
        loss = loss + run.cfg.moe_aux_weight * aux / run.world
    return loss


def forward(params: T.Params, tokens: torch.Tensor, cfg: T.TransformerConfig, mesh,
            *, with_aux: bool = False):
    """The logits of the global batch ``tokens`` on every rank; ``params``
    are DTensors (``init_state(mesh=)``) or global tensors."""
    run = _Run(cfg, mesh, *tokens.shape, tokens.device)
    logits, aux = T._body(_local_params(params, cfg, mesh), run.local(tokens), run)
    logits = leave(logits, mesh, run.logits_spec())
    if run.cp:
        logits = logits.index_select(1, torch.argsort(run.layout))
    if with_aux:
        return logits, leave(aux, mesh, P())
    return logits


def loss_fn(params: T.Params, batch: Dict[str, torch.Tensor], cfg: T.TransformerConfig, mesh):
    """The global loss on every rank."""
    run = _Run(cfg, mesh, *batch["tokens"].shape, batch["tokens"].device)
    lp = _local_params(params, cfg, mesh)
    part = _local_loss(lp, run.local(batch["tokens"]), run.local(batch["targets"]), run)
    return sum_over_mesh(part, mesh)


def _replicated_axes(t_spec: P, ndim: int, mesh):
    used = {a for d in range(ndim) for a in t_spec.names(d)}
    return tuple(a for a in mesh.mesh_dim_names if a not in used and axis_size(mesh, a) > 1)


def _sum_replicated_grads(grads: T.Params, cfg: T.TransformerConfig, mesh) -> T.Params:
    """Each gradient summed over the mesh axes its param is replicated on,
    one flat all-reduce per set of axes."""
    specs = T.param_specs(cfg)
    leaves = list(T._leaves(grads))
    axes = [
        _replicated_axes(s, g.dim(), mesh)
        for g, s in zip(leaves, T._leaves(map_tree(lambda _, sp: sp, grads, specs)))
    ]
    out = list(leaves)
    for key in dict.fromkeys(axes):
        if not key:
            continue
        idx = [i for i, a in enumerate(axes) if a == key]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        for a in key:
            flat = comm._all_reduce(flat, axis_group(mesh, a))
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return T._rebuild(grads, iter(out))


def make_train_step(cfg: T.TransformerConfig, opt: T.Optimizer, mesh):
    """``train_step(state, batch) -> (state, loss)`` on ``init_state(mesh=)``'s
    DTensor state and a global batch: every rank steps its own blocks in
    place and returns the global loss."""
    check_mesh(mesh, "make_train_step")

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        run = _Run(cfg, mesh, *batch["tokens"].shape, batch["tokens"].device)
        lp = local_tree(state["params"])
        part, grads = T.value_and_grad(
            _local_loss, lp, run.local(batch["tokens"]), run.local(batch["targets"]), run
        )
        grads = _sum_replicated_grads(grads, cfg, mesh)
        opt.update(grads, local_tree(state["opt_state"]), lp)
        with torch.no_grad():
            local_tree(state["step"]).add_(1)
            loss = sum_over_mesh(part, mesh)
        return state, loss

    return train_step


def init_state(generator: torch.Generator, cfg: T.TransformerConfig, opt: T.Optimizer, mesh,
               device: Optional[str] = None) -> Dict[str, Any]:
    """``init_state(mesh=)``: the whole state drawn on the CPU (the same on
    every rank), each leaf a DTensor on ``mesh`` by :func:`T.state_specs`."""
    check_mesh(mesh, "init_state")
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device={device!r} is not the mesh's device type {mesh.device_type!r}")
    state = T.init_state(generator, cfg, opt, "cpu")
    return shard_pytree(state, T.state_specs(cfg, state), mesh)
