"""Device meshes, partition specs and the ``shard_map`` of the port.

Counterpart of ``torchsnapshot_tpu/parallel/mesh.py`` (:21-96) on
``torch.distributed``: a mesh is a ``DeviceMesh`` over the current world
with named axes, a spec is :class:`PartitionSpec` (a tuple with one entry
per tensor dim: an axis name, a tuple of names, or ``None``), and sharded
state is ``DTensor``s, which the sharded preparer checkpoints.

:func:`shard_map` plays the role of ``jax.shard_map`` for global tensors
that every rank holds whole: each input is cut to this rank's block of
its spec, the body runs on the blocks, and each output is gathered back
to the whole. Differentiating through it gives every rank the gradient of
the global inputs, as JAX does:

- an input's backward sums, over the mesh, the gradients of the blocks
  (the block's own rank and the ranks that replicate it);
- an output's backward hands the body this rank's block of the gradient,
  divided by the number of ranks that hold that block (the axes the
  output's spec leaves out), because the body's collectives sum over
  ranks (``parallel/comm.py``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from . import comm


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim, an axis
    name, a tuple of axis names (major first) or ``None``; missing
    trailing dims are replicated."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def names(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split tensor dim ``dim``, major first."""
        entry = self[dim] if dim < len(self) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


P = PartitionSpec


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    *,
    device: Optional[str] = None,
    axis_names: Tuple[str, ...] = ("data", "model"),
):
    """A ``DeviceMesh`` over the current ``torch.distributed`` world, with
    the axis names as ``mesh_dim_names``, on CUDA unless ``device="cpu"``.

    ``axis_sizes`` maps axis name to size, and one size may be -1 to take
    the rest. Without it, the last of ``axis_names`` gets the largest
    power of two that divides the world and is at most its square root,
    the first axis takes the rest, and the axes between get 1.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device).type
    n = dist.get_world_size()
    if axis_sizes is None:
        model = 1
        while model * 2 <= math.isqrt(n) and n % (model * 2) == 0:
            model *= 2
        axis_sizes = {name: 1 for name in axis_names}
        axis_sizes[axis_names[-1]] = model
        axis_sizes[axis_names[0]] = (n // model) * axis_sizes[axis_names[0]]
    else:
        if axis_names != ("data", "model") and tuple(axis_sizes) != axis_names:
            raise ValueError(
                f"axis_names {axis_names} conflicts with axis_sizes keys "
                f"{tuple(axis_sizes)}; pass one or the other."
            )
        sizes = list(axis_sizes.values())
        if -1 in sizes:
            known = math.prod(s for s in sizes if s != -1)
            sizes[sizes.index(-1)] = n // known
        axis_sizes = dict(zip(axis_sizes, sizes))
    shape = tuple(axis_sizes.values())
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {axis_sizes} != {n} devices")
    return init_device_mesh(device, shape, mesh_dim_names=tuple(axis_sizes))


def check_mesh(mesh: Any, what: str) -> None:
    """Raise ``TypeError`` naming ``what`` unless ``mesh`` is a
    ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"{what}(mesh=...) takes a torch.distributed DeviceMesh (parallel.make_mesh), "
            f"got {type(mesh).__name__}"
        )


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def axis_group(mesh, name: str) -> comm.Group:
    """The process group of axis ``name``, or ``None`` (a group of one)
    when the mesh has no such axis or it has size 1."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def _check_spec(spec: PartitionSpec, mesh, ndim: int) -> None:
    names = mesh.mesh_dim_names
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more entries than the tensor's {ndim} dims")
    seen: List[str] = []
    for d in range(ndim):
        for name in spec.names(d):
            if name not in names:
                raise ValueError(f"spec {spec!r} names axis {name!r}, not in mesh {names}")
            seen.append(name)
        order = [names.index(a) for a in spec.names(d)]
        if order != sorted(order):
            raise ValueError(
                f"spec {spec!r}: axes of one dim must follow the mesh's order {names}"
            )
    if len(seen) != len(set(seen)):
        raise ValueError(f"spec {spec!r} uses an axis twice")


def placements(spec: Optional[PartitionSpec], mesh, ndim: int):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` for each
    axis that splits dim d, ``Replicate()`` for the others. For example
    ``P(None, None, "model")`` on ``('data', 'seq', 'model')`` is
    ``[Replicate(), Replicate(), Shard(2)]``."""
    from torch.distributed.tensor import Replicate, Shard

    spec = spec if spec is not None else P()
    _check_spec(spec, mesh, ndim)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d in range(ndim) if name in spec.names(d)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples), with the matching leaves of the trees in ``rest``; a
    leaf of ``rest`` may be a spec or ``None`` where ``tree`` holds a
    tensor."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        items = [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree


def shard_pytree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` (whole on every rank) as a DTensor on
    ``mesh`` with the placements of its spec (``None`` replicates):
    ``distribute_tensor`` cuts each rank's block locally, with no
    communication, and moves it to the mesh's device. The DTensors share
    no storage with ``tree`` (a replicated block would otherwise be the
    caller's tensor itself)."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, spec):
        return distribute_tensor(
            t.detach().clone(), mesh, placements(spec, mesh, t.dim()), src_data_rank=None
        )

    return map_tree(put, tree, specs)


def optax_state_specs(p_specs: Any, opt_state: Any) -> Tuple[Any, ...]:
    """Specs of an optax-layout optimizer state: Adam's moments (the
    ``mu`` and ``nu`` fields of an entry such as ``ScaleByAdamState``)
    take their param's spec, and everything else (``count``, empty
    states) is replicated. Scalars go on the mesh too: a restored scalar
    comes back on its destination's mesh, and a plain tensor beside
    DTensors would not match it."""

    def entry(e):
        fields = getattr(e, "_fields", ())
        if "mu" in fields and "nu" in fields:
            return type(e)(*(p_specs if f in ("mu", "nu") else map_tree(lambda _: P(), v)
                             for f, v in zip(fields, e)))
        return map_tree(lambda _: P(), e)

    return tuple(entry(e) for e in opt_state)


def to_local(t: Any) -> Any:
    """A DTensor's local shard (a view of it), any other value as is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_tree(tree: Any) -> Any:
    return map_tree(to_local, tree)


def _block(shape: Sequence[int], mesh, spec: PartitionSpec) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        count, index = 1, 0
        for name in spec.names(d):
            count *= axis_size(mesh, name)
            index = index * axis_size(mesh, name) + axis_rank(mesh, name)
        if n % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {count} ranks ({spec!r})")
        out.append(slice(index * (n // count), (index + 1) * (n // count)))
    return tuple(out)


def gather(t: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (no
    autograd), on every rank; ``t`` itself when ``spec`` splits nothing."""
    for d in range(t.dim()):
        for name in reversed(spec.names(d)):
            t = comm._all_gather(t, axis_group(mesh, name), d)
    return t


def _sum_over_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    for name in mesh.mesh_dim_names:
        t = comm._all_reduce(t, axis_group(mesh, name))
    return t


class _EnterMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.shape, ctx.block = mesh, x.shape, _block(x.shape, mesh, spec)
        return x[ctx.block].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.block] = g
        return _sum_over_mesh(full, ctx.mesh), None, None


class _LeaveMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        used = {a for d in range(y.dim()) for a in spec.names(d)}
        ctx.holders = math.prod(
            axis_size(mesh, a) for a in mesh.mesh_dim_names if a not in used
        )
        return gather(y, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        return g[_block(g.shape, ctx.mesh, ctx.spec)] / ctx.holders, None, None


class _SumOverMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return _sum_over_mesh(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's ``t``, on every rank. Its backward is the
    identity: each rank's part of a global loss that every rank then
    holds whole takes that loss's gradient once."""
    return _SumOverMesh.apply(t, mesh)


def enter(x: torch.Tensor, mesh, spec: Optional[PartitionSpec]) -> torch.Tensor:
    """This rank's block of a global tensor (see the module docstring)."""
    spec = spec if spec is not None else P()
    _check_spec(spec, mesh, x.dim())
    return _EnterMesh.apply(x, mesh, spec)


def leave(y: torch.Tensor, mesh, spec: Optional[PartitionSpec]) -> torch.Tensor:
    """The global tensor from every rank's block (see the module
    docstring)."""
    spec = spec if spec is not None else P()
    _check_spec(spec, mesh, y.dim())
    return _LeaveMesh.apply(y, mesh, spec)


def shard_map(fn: Callable, mesh, in_specs: Sequence[Any], out_specs: Any) -> Callable:
    """``jax.shard_map(fn, mesh, in_specs, out_specs)`` for global tensors
    held whole by every rank (see the module docstring). Specs are trees
    matching the arguments and the result, with :class:`PartitionSpec`
    (or ``None``, replicated) leaves."""

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        blocks = [map_tree(lambda x, s: enter(x, mesh, s), a, s) for a, s in zip(args, in_specs)]
        return map_tree(lambda y, s: leave(y, mesh, s), fn(*blocks), out_specs)

    return run
