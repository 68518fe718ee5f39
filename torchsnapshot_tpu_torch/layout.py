"""Partition-rule layout compiler: regex rules over tree paths.

Counterpart of ``torchsnapshot_tpu/layout.py`` (its device-free rule
compiler, lines 1-300 and 357-370; the port keeps its own copy). An ordered
list of regex rules over '/'-joined tree paths, each mapping to a per-dim
partition spec over a named mesh, declares a model's layout:

- :class:`LayoutSpec` compiles the rules into per-path specs with optional
  dtype policies; :meth:`LayoutSpec.to_dict` is the form
  ``Snapshot.take(..., layout=...)`` records in ``SnapshotMetadata.layout``.
- The device-free box compiler (:meth:`LayoutSpec.boxes_for`,
  :meth:`LayoutSpec.boxes_by_rank`) reproduces jax's named-sharding tiling
  (row-major device placement, ceil-division blocks along each partitioned
  dim), so either package's tooling computes every rank's boxes from the
  rules alone.
- The torch helpers at the bottom (in place of the JAX package's
  ``build_mesh``/``named_sharding``/``shardings_for``, layout.py:301-344)
  build a ``DeviceMesh`` and the DTensor placements of a spec.

Tiling: jax's ``NamedSharding`` requires each partitioned dim to divide
evenly, and there DTensor's ``Shard`` boxes equal jax's and
:meth:`LayoutSpec.boxes_for`'s, a dim over several axes (jax's
``P(("x", "y"))``, DTensor's nested ``[Shard(0), Shard(0)]``) included.
DTensor also tiles dims that do not divide: ceil-division blocks with
empty trailing shards (6 rows over 4 ranks give 2, 2, 2, 0).
:meth:`LayoutSpec.boxes_for` agrees where no shard is empty and refuses
the rest. A dim over several axes that does not divide evenly is one split
over the product here and nested splits in DTensor (10 rows over 2 x 2:
3, 3, 3, 1 here, 3, 2, 3, 2 there); ``io_preparers/sharded.py`` computes
DTensor's own boxes, so restores are exact either way.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

Box = Tuple[Tuple[int, int], ...]  # ((start, stop) per dim)

LAYOUT_FORMAT_VERSION = 1

# A per-dim spec entry: the mesh axes the dim is partitioned over, in
# order; empty = replicated along every mesh axis (the dim is whole).
DimSpec = Tuple[str, ...]


def _normalize_dim(dim: Any) -> DimSpec:
    if dim is None:
        return ()
    if isinstance(dim, str):
        return (dim,)
    return tuple(str(a) for a in dim)


@dataclass(frozen=True)
class Rule:
    """One partition rule: paths matching ``pattern`` (``re.search``,
    the fmengine convention — anchor with ``^...$`` for exact matches)
    shard per ``spec``; ``dtype`` optionally names the storage dtype
    policy for matching leaves (consumed by save tooling / the CLI
    dry-run's byte estimates, never silently applied)."""

    pattern: str
    spec: Tuple[DimSpec, ...]
    dtype: Optional[str] = None

    @classmethod
    def of(
        cls, pattern: str, spec: Sequence[Any], dtype: Optional[str] = None
    ) -> "Rule":
        return cls(pattern, tuple(_normalize_dim(d) for d in spec), dtype)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "pattern": self.pattern,
            "spec": [list(dim) for dim in self.spec],
        }
        if self.dtype is not None:
            d["dtype"] = self.dtype
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Rule":
        return cls.of(d["pattern"], d["spec"], d.get("dtype"))


class LayoutSpec:
    """An ordered rule set over a named mesh. First matching rule wins;
    a path no rule matches is replicated (every dim whole) — scalars
    and odd leaves never need an explicit rule."""

    def __init__(
        self,
        mesh_axes: Sequence[Tuple[str, int]],
        rules: Sequence[Rule] = (),
    ) -> None:
        self.mesh_axes: Tuple[Tuple[str, int], ...] = tuple(
            (str(name), int(size)) for name, size in mesh_axes
        )
        if not self.mesh_axes:
            raise ValueError("layout needs at least one mesh axis")
        seen = set()
        for name, size in self.mesh_axes:
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")
            if name in seen:
                raise ValueError(f"duplicate mesh axis {name!r}")
            seen.add(name)
        self.rules: Tuple[Rule, ...] = tuple(rules)
        self._axis_size = dict(self.mesh_axes)
        self._compiled = [
            (re.compile(rule.pattern), rule) for rule in self.rules
        ]
        for rule in self.rules:
            used: set = set()
            for dim in rule.spec:
                for axis in dim:
                    if axis not in self._axis_size:
                        raise ValueError(
                            f"rule {rule.pattern!r} references unknown mesh "
                            f"axis {axis!r} (mesh: {list(self._axis_size)})"
                        )
                    if axis in used:
                        # jax's PartitionSpec invariant: reusing an axis
                        # would tile the SAME device coordinate into two
                        # dims and leave off-diagonal holes.
                        raise ValueError(
                            f"rule {rule.pattern!r} uses mesh axis "
                            f"{axis!r} more than once"
                        )
                    used.add(axis)

    # ------------------------------------------------------------- matching

    @property
    def n_devices(self) -> int:
        n = 1
        for _, size in self.mesh_axes:
            n *= size
        return n

    def match(self, path: str) -> Optional[Rule]:
        """First rule whose pattern matches ``path`` (``re.search``), or
        None (replicated)."""
        for regex, rule in self._compiled:
            if regex.search(path):
                return rule
        return None

    def spec_for(self, path: str, ndim: int) -> Tuple[DimSpec, ...]:
        """The path's per-dim spec, padded with replicated dims to
        ``ndim``. A matched spec longer than ``ndim`` is an error —
        silently dropping a partitioned dim would change the layout."""
        rule = self.match(path)
        spec: Tuple[DimSpec, ...] = rule.spec if rule is not None else ()
        if len(spec) > ndim:
            if any(spec[ndim:]):
                raise ValueError(
                    f"rule {rule.pattern!r} has {len(spec)} spec dims but "
                    f"{path!r} has only {ndim}"
                )
            spec = spec[:ndim]
        return spec + ((),) * (ndim - len(spec))

    def dtype_for(self, path: str) -> Optional[str]:
        rule = self.match(path)
        return rule.dtype if rule is not None else None

    def match_partition_rules(
        self, paths_ndim: Dict[str, int]
    ) -> Dict[str, Tuple[DimSpec, ...]]:
        """The fmengine idiom over a flattened tree: '/'-joined path ->
        compiled per-dim spec, for every leaf at once."""
        return {
            path: self.spec_for(path, ndim)
            for path, ndim in paths_ndim.items()
        }

    # --------------------------------------------------- device-free boxes

    def _shards_per_dim(self, spec: Sequence[DimSpec], ndim: int) -> List[int]:
        counts = []
        for i in range(ndim):
            n = 1
            for axis in (spec[i] if i < len(spec) else ()):
                n *= self._axis_size[axis]
            counts.append(n)
        return counts

    def boxes_for(
        self, shape: Sequence[int], spec: Sequence[DimSpec]
    ) -> List[Box]:
        """One destination box per device, indexed by device id (row-major
        placement over the mesh axes, jax's default ``Mesh`` order).
        Blocks use ceil division per partitioned dim — the named-sharding
        tiling — and every shard must be non-empty."""
        shape = tuple(int(s) for s in shape)
        spec = tuple(_normalize_dim(d) for d in spec)
        ndim = len(shape)
        if len(spec) > ndim and any(spec[ndim:]):
            raise ValueError(
                f"spec has {len(spec)} dims for a rank-{ndim} array"
            )
        used: set = set()
        for dim_axes in spec:
            for axis in dim_axes:
                if axis in used:
                    raise ValueError(
                        f"spec uses mesh axis {axis!r} more than once"
                    )
                used.add(axis)
        counts = self._shards_per_dim(spec, ndim)
        for dim, n in zip(shape, counts):
            if n > 1 and math.ceil(dim / n) * (n - 1) >= dim:
                raise ValueError(
                    f"dim of size {dim} cannot be tiled into {n} non-empty "
                    f"shards"
                )
        mesh_names = [name for name, _ in self.mesh_axes]
        mesh_sizes = [size for _, size in self.mesh_axes]
        boxes: List[Box] = []
        for device in range(self.n_devices):
            # Row-major unravel of the device id over the mesh axes.
            coords: Dict[str, int] = {}
            rem = device
            for name, size in zip(reversed(mesh_names), reversed(mesh_sizes)):
                coords[name] = rem % size
                rem //= size
            box: List[Tuple[int, int]] = []
            for i, dim in enumerate(shape):
                axes = spec[i] if i < len(spec) else ()
                idx = 0
                for axis in axes:  # row-major over the listed axes
                    idx = idx * self._axis_size[axis] + coords[axis]
                block = math.ceil(dim / counts[i]) if counts[i] > 1 else dim
                lo = min(idx * block, dim)
                hi = min(lo + block, dim)
                box.append((lo, hi))
            boxes.append(tuple(box))
        return boxes

    def rank_of_device(self, device: int, world_size: int) -> int:
        """Emulated device->rank mapping: contiguous equal blocks in
        device order (jax's ordering for one-device-per-process CPU
        fleets and the common pod topology)."""
        n = self.n_devices
        if world_size < 1 or n % world_size:
            raise ValueError(
                f"{n} devices do not divide into {world_size} rank(s)"
            )
        return device // (n // world_size)

    def boxes_by_rank(
        self, shape: Sequence[int], spec: Sequence[DimSpec], world_size: int
    ) -> Dict[int, List[Box]]:
        """Each rank's DISTINCT destination boxes, sorted — the planner's
        input shape (reshard.plan_transfers). Replication across mesh
        axes collapses: a rank holding the same box on two devices needs
        its bytes once."""
        per_rank: Dict[int, set] = {r: set() for r in range(world_size)}
        for device, box in enumerate(self.boxes_for(shape, spec)):
            per_rank[self.rank_of_device(device, world_size)].add(box)
        return {r: sorted(boxes) for r, boxes in per_rank.items()}

    # --------------------------------------------------------- serialization

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": LAYOUT_FORMAT_VERSION,
            "mesh": [[name, size] for name, size in self.mesh_axes],
            "rules": [rule.to_dict() for rule in self.rules],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LayoutSpec":
        version = d.get("version", 1)
        if version > LAYOUT_FORMAT_VERSION:
            raise ValueError(
                f"layout format version {version} is newer than this "
                f"build understands ({LAYOUT_FORMAT_VERSION})"
            )
        return cls(
            [(name, size) for name, size in d["mesh"]],
            [Rule.from_dict(r) for r in d.get("rules", [])],
        )

    def __repr__(self) -> str:
        mesh = ", ".join(f"{n}={s}" for n, s in self.mesh_axes)
        return f"LayoutSpec(mesh=({mesh}), rules={len(self.rules)})"


    # -------------------------------------------------------- torch helpers
    #
    # Everything below may import torch.distributed; nothing above does.

    def build_mesh(self, device_type: str = "cuda"):
        """A ``DeviceMesh`` over this layout's axes (row-major over the
        ranks of the initialized ``torch.distributed`` world, matching the
        box compiler's device order)."""
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(
            device_type,
            tuple(size for _, size in self.mesh_axes),
            mesh_dim_names=tuple(name for name, _ in self.mesh_axes),
        )

    def placements_for(self, spec: Sequence[Any]) -> List[Any]:
        """The DTensor placements of one per-dim spec, one per mesh axis:
        ``Shard(d)`` on each axis that partitions dim ``d``, ``Replicate()``
        on the others. A dim over several axes must list them in mesh order
        (DTensor nests its splits outer axis first); another order raises."""
        from torch.distributed.tensor import Replicate, Shard

        names = [name for name, _ in self.mesh_axes]
        placements: List[Any] = [Replicate() for _ in names]
        for d, dim in enumerate(_normalize_dim(x) for x in spec):
            order = [names.index(axis) for axis in dim]
            if order != sorted(order):
                raise ValueError(
                    f"spec dim {d} lists mesh axes {list(dim)} out of mesh order "
                    f"{names}: DTensor cannot express that tiling"
                )
            for i in order:
                placements[i] = Shard(d)
        return placements

    def placements_by_path(self, paths_ndim: Dict[str, int]) -> Dict[str, List[Any]]:
        """'/'-joined path -> DTensor placements for a flattened tree (the
        ``shardings_for`` use case: build every destination under the
        rule set, then restore into it)."""
        return {
            path: self.placements_for(spec)
            for path, spec in self.match_partition_rules(paths_ndim).items()
        }


def box_linear_start(box: Box, shape: Sequence[int]) -> int:
    """Row-major linearized offset of a box's start corner within its
    array: where this box's bytes begin if the array were stored
    contiguously. The page-in engine orders background prefetch by it."""
    offset = 0
    for (lo, _hi), dim in zip(box, shape):
        offset = offset * int(dim) + int(lo)
    return offset


def resolve_layout(layout: Any) -> Optional[Dict[str, Any]]:
    """Coerce a user-supplied layout (LayoutSpec or an already-plain
    dict) into the serializable metadata form; None passes through."""
    if layout is None:
        return None
    if isinstance(layout, LayoutSpec):
        return layout.to_dict()
    if isinstance(layout, dict):
        # Validate eagerly: a malformed rule set must fail the take, not
        # a later plan/restore that reads it back.
        return LayoutSpec.from_dict(layout).to_dict()
    raise TypeError(
        f"layout must be a LayoutSpec or dict, not {type(layout).__name__}"
    )
