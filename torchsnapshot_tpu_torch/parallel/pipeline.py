"""GPipe and 1F1B pipeline parallelism over a mesh axis.

Counterpart of ``torchsnapshot_tpu/parallel/pipeline.py`` (:1-384):
``pipeline_spmd``, ``pipelined_apply``, ``pipeline_1f1b_spmd``,
``pipelined_value_and_grad`` and ``pipeline_param_sharding``.
Layer-stacked parameters (leading dim = layers) split over the ``pipe``
axis, so each rank owns a stage of ``L/P`` consecutive layers. The batch
splits into ``n_micro`` microbatches: at tick ``t`` stage ``s`` runs
microbatch ``t - s`` and hands its activation to stage ``s + 1``.

Every rank runs the same ticks: bubble ticks (fill and drain) run the
stage on data whose result is masked away, as in the JAX package, so
each rank issues the same collectives in the same order, forward and
backward. The neighbour hand-off is ``comm._rotate`` over the ``pipe``
group, which wraps around where JAX's ``ppermute`` has no edge (stage 0
there receives zeros): stage 0 ignores what it receives, and on the way
back the last stage drops the gradient that wraps round to it.

GPipe's backward is one ``torch.autograd.Function`` over the whole tick
loop (:class:`_GPipe`): its backward replays the ticks in reverse, each
stage re-running its forward from the stashed input of that tick
(``torch.autograd.grad``) and passing the activation's gradient to the
stage before it. The 1F1B schedule is explicit in the JAX package and
stays explicit here (:func:`pipeline_1f1b_spmd`).

Under ``data`` x ``pipe``, the JAX package's gradients arrive summed over
``data`` by its varying-axes autodiff and are then divided by the axis
size (:355-365); here the sum is an all-reduce over ``data``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from . import comm
from .mesh import P, _block, axis_group, axis_size, check_mesh, gather, map_tree, shard_map

LayerFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    map_tree(lambda t: out.append(t), tree)
    return out


def _rebuild(tree: Any, leaves: List[torch.Tensor]) -> Any:
    it = iter(leaves)
    return map_tree(lambda _: next(it), tree)


def _stage_apply(stage_params: Any, x: torch.Tensor, layer_fn: LayerFn) -> torch.Tensor:
    """This stage's layers (leading dim = local layers), in order."""
    n = _leaves(stage_params)[0].shape[0]
    for i in range(n):
        x = layer_fn(map_tree(lambda t: t[i], stage_params), x)
    return x


def _stage_vjp(stage_params: Any, act: torch.Tensor, g_out: torch.Tensor, layer_fn: LayerFn):
    """One linearization of the stage at ``act``: the cotangents of the
    params and of the input for the output cotangent ``g_out``."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(stage_params)]
    a = act.detach().requires_grad_(True)
    with torch.enable_grad():
        y = _stage_apply(_rebuild(stage_params, leaves), a, layer_fn)
        grads = torch.autograd.grad(y, leaves + [a], g_out, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves + [a], grads)]
    return grads[:-1], grads[-1]


class _GPipe(torch.autograd.Function):
    """The GPipe tick loop of one stage (see the module docstring)."""

    @staticmethod
    def forward(ctx, x_micro, group, layer_fn, tree, *leaves):
        n_stages, stage = comm.size(group), comm.rank(group)
        n_micro = x_micro.shape[0]
        params = _rebuild(tree, list(leaves))
        outs = torch.zeros_like(x_micro)
        act = x_micro[0] if stage == 0 else torch.zeros_like(x_micro[0])
        acts = []
        for t in range(n_micro + n_stages - 1):
            acts.append(act)
            y = _stage_apply(params, act, layer_fn)
            mb = t - stage
            if stage == n_stages - 1 and 0 <= mb < n_micro:
                outs[mb] = y
            (recv,) = comm._rotate([y], group)
            act = x_micro[min(t + 1, n_micro - 1)] if stage == 0 else recv
        if stage != n_stages - 1:
            outs.zero_()
        ctx.group, ctx.layer_fn, ctx.tree, ctx.n_micro = group, layer_fn, tree, n_micro
        ctx.save_for_backward(*leaves, *acts)
        ctx.n_leaves = len(leaves)
        return comm._all_reduce(outs, group)

    @staticmethod
    def backward(ctx, g_outs):
        group, n_micro = ctx.group, ctx.n_micro
        n_stages, stage = comm.size(group), comm.rank(group)
        last = n_stages - 1
        saved = ctx.saved_tensors
        leaves, acts = list(saved[: ctx.n_leaves]), list(saved[ctx.n_leaves:])
        params = _rebuild(ctx.tree, leaves)
        # The adjoint of the sum over stages, then the last stage's banked
        # outputs are the only ones that reached it.
        g_banked = comm._all_reduce(g_outs, group)
        g_params = [torch.zeros_like(t) for t in leaves]
        g_x = torch.zeros_like(g_banked)
        g_act_next = torch.zeros_like(acts[0])
        for t in reversed(range(len(acts))):
            # act_{t+1} was stage 0's input slice, or what the stage before
            # sent at tick t: its gradient goes back on the reverse edge.
            (g_y,) = comm._rotate([g_act_next], group, shift=-1)
            if stage == 0:
                g_x[min(t + 1, n_micro - 1)] += g_act_next
            if stage == last:
                g_y = torch.zeros_like(g_y)  # wrapped round from stage 0
                mb = t - stage
                if 0 <= mb < n_micro:
                    g_y = g_y + g_banked[mb]
            g_p, g_act_next = _stage_vjp(params, acts[t], g_y, ctx.layer_fn)
            for acc, g in zip(g_params, g_p):
                acc += g
        if stage == 0:
            g_x[0] += g_act_next
        return (g_x, None, None, None, *g_params)


def pipeline_spmd(
    stage_params: Any,
    x_micro: torch.Tensor,
    *,
    group: comm.Group,
    layer_fn: LayerFn,
) -> torch.Tensor:
    """The GPipe body on one stage of ``group`` (JAX :68-123).

    ``stage_params``: tree whose leaves have leading dim ``L_local`` (this
    stage's layers). ``x_micro: (M, Bm, ...)``, the microbatched input
    (every stage receives it; only stage 0 reads it). Returns the
    pipelined output ``(M, Bm, ...)``, the same on every stage.
    Differentiable in both."""
    leaves = _leaves(stage_params)
    return _GPipe.apply(x_micro, group, layer_fn, stage_params, *leaves)


def _param_specs(params: Any, pipe_axis: str) -> Any:
    return map_tree(lambda leaf: P(pipe_axis, *([None] * (leaf.dim() - 1))), params)


def _prep_pipeline(params: Any, x: torch.Tensor, mesh, n_micro: int, pipe_axis: str,
                   batch_axis: Optional[str]):
    """Validation and microbatching shared by the entry points, with the
    JAX package's messages (:126-158). Returns ``(batch axis or None,
    x_micro, param specs)``."""
    check_mesh(mesh, "pipeline")
    names = mesh.mesh_dim_names
    if pipe_axis not in names:
        raise ValueError(f"mesh {names} lacks pipe axis {pipe_axis!r}")
    n_stages = axis_size(mesh, pipe_axis)
    L = _leaves(params)[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages")
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    b = batch_axis if batch_axis in names else None
    if b is not None and (B // n_micro) % axis_size(mesh, b):
        raise ValueError(
            f"per-microbatch size {B // n_micro} not divisible by the "
            f"{b!r} axis size {axis_size(mesh, b)} (batch {B}, n_micro {n_micro})"
        )
    x_micro = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    return b, x_micro, _param_specs(params, pipe_axis)


def pipelined_apply(
    params: Any,
    x: torch.Tensor,
    mesh,
    *,
    layer_fn: LayerFn,
    n_micro: int,
    pipe_axis: str = "pipe",
    batch_axis: Optional[str] = "data",
) -> torch.Tensor:
    """Layer-stacked ``params`` applied to the global ``x: (B, ...)``
    through a pipeline, on every rank (JAX :161-192).

    ``params`` are global tensors every rank holds whole, or DTensors
    placed by :func:`pipeline_param_sharding`; their leading dim L splits
    over ``pipe_axis``. The batch splits into ``n_micro`` microbatches (B
    divisible by ``n_micro`` and each microbatch by the ``batch_axis``
    size where the mesh has it: dp composes with pp). Differentiable in
    ``params`` and ``x``."""
    b, x_micro, specs = _prep_pipeline(params, x, mesh, n_micro, pipe_axis, batch_axis)
    group = axis_group(mesh, pipe_axis)

    def body(p, xm):
        return pipeline_spmd(p, xm, group=group, layer_fn=layer_fn)

    out = shard_map(body, mesh, (specs, P(None, b)), P(None, b))(params, x_micro)
    return out.reshape(x.shape[0], *out.shape[2:])


def pipeline_1f1b_spmd(
    stage_params: Any,
    x_micro: torch.Tensor,
    t_micro: torch.Tensor,
    *,
    group: comm.Group,
    layer_fn: LayerFn,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The 1F1B train ticks on one stage of ``group`` (JAX :195-321).

    Every tick each stage runs one microbatch forward and one backward
    (masked in fill and drain), so the activation stash is bounded by the
    pipeline's depth (2 x stages slots, indexed ``% stash_size``), not by
    ``n_micro``. At tick ``t`` stage ``s`` forwards microbatch ``t - s``
    and backwards microbatch ``t - (2S - 2 - s)``; the last stage's
    backward of a microbatch runs in the tick of its forward, seeded by
    the loss's gradient. Each backward re-runs the stage's forward from
    the stashed input (``torch.autograd.grad``), which gives the param and
    activation cotangents at once. Returns ``(loss_sum, grads)``: the
    summed microbatch losses (the same on every stage) and this stage's
    param gradients as a tree like ``stage_params``."""
    n_stages, stage = comm.size(group), comm.rank(group)
    n_micro = x_micro.shape[0]
    stash_size = 2 * n_stages
    last = n_stages - 1
    leaves = _leaves(stage_params)
    stash = x_micro.new_zeros((stash_size,) + tuple(x_micro.shape[1:]))
    grads = [torch.zeros_like(t) for t in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    act = x_micro[0] if stage == 0 else torch.zeros_like(x_micro[0])
    g_in = torch.zeros_like(x_micro[0])
    with torch.no_grad():
        for t in range(n_micro + 2 * n_stages - 2):
            fm, bm = t - stage, t - (2 * n_stages - 2 - stage)
            fwd_valid, bwd_valid = 0 <= fm < n_micro, 0 <= bm < n_micro
            # Forward.
            y = _stage_apply(stage_params, act, layer_fn)
            if fwd_valid:
                stash[fm % stash_size] = act
            # The per-microbatch loss and its seed gradient, on every stage
            # (the same program everywhere); only the last stage keeps them.
            yl = y.detach().requires_grad_(True)
            with torch.enable_grad():
                mb_loss = loss_fn(yl, t_micro[min(max(fm, 0), n_micro - 1)])
                (g_seed,) = torch.autograd.grad(mb_loss, yl)
            if fwd_valid and stage == last:
                loss_sum = loss_sum + mb_loss.detach().float()
            # Backward of microbatch bm from its stashed input.
            g_out = g_seed if stage == last else g_in
            act_bwd = stash[min(max(bm, 0), n_micro - 1) % stash_size]
            g_p, g_act = _stage_vjp(stage_params, act_bwd, g_out, layer_fn)
            if bwd_valid:
                for acc, g in zip(grads, g_p):
                    acc += g
            else:
                g_act = torch.zeros_like(g_act)
            # The hand-offs: activations up, their gradients down.
            (recv,) = comm._rotate([y], group)
            act = x_micro[min(t + 1, n_micro - 1)] if stage == 0 else recv
            (g_in,) = comm._rotate([g_act], group, shift=-1)
            if stage == last:
                g_in = torch.zeros_like(g_in)  # wrapped round from stage 0
    loss_sum = comm._all_reduce(loss_sum if stage == last else torch.zeros_like(loss_sum), group)
    return loss_sum, _rebuild(stage_params, grads)


def _local_stage(t: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t[_block(t.shape, mesh, spec)]


def pipelined_value_and_grad(
    params: Any,
    x: torch.Tensor,
    targets: torch.Tensor,
    mesh,
    *,
    layer_fn: LayerFn,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    n_micro: int,
    pipe_axis: str = "pipe",
    batch_axis: Optional[str] = "data",
):
    """``(mean microbatch loss, param grads)`` by the 1F1B schedule (JAX
    :324-372), on every rank. ``loss_fn(y_micro, t_micro)`` is the mean
    loss of one microbatch. The gradients are averaged over microbatches
    and, when ``batch_axis`` is on the mesh, over its ranks; they come
    back as DTensors of the params' placements for DTensor params, else
    as global tensors."""
    from torch.distributed.tensor import DTensor

    b, x_micro, specs = _prep_pipeline(params, x, mesh, n_micro, pipe_axis, batch_axis)
    B = x.shape[0]
    t_micro = targets.reshape(n_micro, B // n_micro, *targets.shape[1:])
    xb, tb = (m[(slice(None),) + _block(m.shape[1:2], mesh, P(b))] for m in (x_micro, t_micro))
    stage_params = map_tree(lambda t, s: _local_stage(t, mesh, s), params, specs)
    loss_sum, grads = pipeline_1f1b_spmd(
        stage_params, xb, tb, group=axis_group(mesh, pipe_axis), layer_fn=layer_fn,
        loss_fn=loss_fn,
    )
    loss = loss_sum / n_micro
    n_b = axis_size(mesh, b) if b is not None else 1
    if b is not None:
        loss = comm._all_reduce(loss, axis_group(mesh, b)) / n_b
    scale = n_micro * n_b

    def out(g, t, spec):
        if b is not None:
            g = comm._all_reduce(g, axis_group(mesh, b))
        g = g / scale
        if isinstance(t, DTensor):
            return DTensor.from_local(g, mesh, t.placements, run_check=False)
        return gather(g, mesh, spec)

    return loss, map_tree(out, grads, params, specs)


def pipeline_param_sharding(params: Any, mesh, pipe_axis: str = "pipe") -> Any:
    """The specs that place layer-stacked params on their stages (JAX
    :375-384 returns the ``NamedSharding`` of each):
    ``P(pipe_axis, None, ...)`` per leaf, which
    ``parallel.shard_pytree(params, specs, mesh)`` turns into DTensors
    (``Shard(0)`` over ``pipe``) and the snapshot layer sees as sharded
    entries."""
    check_mesh(mesh, "pipeline_param_sharding")
    if pipe_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} lacks pipe axis {pipe_axis!r}")
    return _param_specs(params, pipe_axis)
