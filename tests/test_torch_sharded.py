"""The port's sharded preparer against the JAX package's, in one process.

Every rank of a 4-rank mesh is simulated through the preparer's seam, a
``ShardedView`` per rank (the JAX package's tests use 8 virtual devices the
same way): the box geometry of DTensor placements against torch's own
geometry, jax's NamedSharding boxes and ``layout.boxes_for``, uneven and
empty tails included; the resharding matrix of
``tests/test_sharded_array_resharding.py`` (six layouts, source x
destination); the piece subdivision, the writer election, bf16, plain
entries into sharded destinations and sharded entries into plain ones, and
the partial digests that sum to each piece's fingerprint.
"""

from __future__ import annotations

import asyncio
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

import torchsnapshot_tpu as J
import torchsnapshot_tpu.io_preparers.sharded as JS
import torchsnapshot_tpu_torch as P
import torchsnapshot_tpu_torch.layout  # noqa: F401 - P.layout
from torchsnapshot_tpu.layout import LayoutSpec as JLayoutSpec
from torchsnapshot_tpu_torch import device_digest
from torchsnapshot_tpu_torch.io_preparers import sharded as S
from torchsnapshot_tpu_torch.io_preparers.array import DeviceStreams
from torchsnapshot_tpu_torch.io_preparers.prepare import prepare_read
from torchsnapshot_tpu_torch.layout import LayoutSpec
from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry
from torchsnapshot_tpu_torch.scheduler import sync_execute_read_reqs, sync_execute_write_reqs
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torch_test_env import autotune_never  # noqa: F401 - autouse
from torch_cli_env import recorders_from_env  # noqa: F401 - autouse (recorder gates from the env)

SHAPE = (16, 24)

# The six layouts of tests/test_sharded_array_resharding.py on 4-rank
# meshes: (mesh shape, DTensor placements, jax PartitionSpec over ("x", "y")).
LAYOUTS = {
    "1d_row": ((4,), [Shard(0)], PartitionSpec("x", None)),
    "1d_col": ((4,), [Shard(1)], PartitionSpec(None, "x")),
    "2d": ((2, 2), [Shard(0), Shard(1)], PartitionSpec("x", "y")),
    "2d_flip": ((2, 2), [Shard(1), Shard(0)], PartitionSpec("y", "x")),
    "partial_repl": ((2, 2), [Shard(0), Replicate()], PartitionSpec("x", None)),
    "combined": ((2, 2), [Shard(0), Shard(0)], PartitionSpec(("x", "y"), None)),
}


def _ranks(mesh_shape) -> torch.Tensor:
    return torch.arange(math.prod(mesh_shape)).reshape(mesh_shape)


def _slices(box):
    return tuple(slice(lo, hi) for lo, hi in box)


def _views(full: torch.Tensor, layout: str, fill=None):
    """One view per simulated rank; ``fill`` replaces each local shard by
    a tensor of that value (a restore destination)."""
    mesh_shape, placements, _ = LAYOUTS[layout]
    boxes = S.shard_boxes(full.shape, _ranks(mesh_shape), placements)
    views = []
    for rank in range(math.prod(mesh_shape)):
        local = full[_slices(boxes[rank])].clone()
        if fill is not None:
            local.fill_(fill)
        views.append(S.ShardedView(tuple(full.shape), boxes, rank, local))
    return views


def _run(coro_fn, *args):
    loop = asyncio.new_event_loop()
    try:
        return coro_fn(*args, loop)
    finally:
        loop.close()


def _simulated_take(root: str, views, name: str = "sharded/m/w") -> ShardedArrayEntry:
    """Every simulated rank writes its elected pieces; the entries merge
    as the manifest gather merges them."""
    storage = FSStoragePlugin(root)
    shards, reqs = [], []
    for view in views:
        entry, rank_reqs = S.ShardedArrayIOPreparer.prepare_write(
            name, view, DeviceStreams(), copy_cpu=False
        )
        shards += entry.shards
        reqs += rank_reqs
    _run(lambda r, loop: sync_execute_write_reqs(r, storage, 1 << 30, 0, loop), reqs)
    return ShardedArrayEntry(dtype=entry.dtype, shape=list(views[0].shape), shards=shards)


def _simulated_restore(root: str, entry, views) -> None:
    storage = FSStoragePlugin(root)
    for view in views:
        reqs = prepare_read(entry, view, None, DeviceStreams())
        _run(lambda r, loop: sync_execute_read_reqs(r, storage, 1 << 30, view.rank, loop), reqs)


def _full(dtype=torch.float32, seed: int = 0, shape=SHAPE) -> torch.Tensor:
    data = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(data).to(dtype)


# ------------------------------------------------------------ box geometry

GEOMETRY = [
    # (shape, mesh shape, placements)
    ((16, 24), (4,), [Shard(0)]),
    ((16, 24), (4,), [Shard(1)]),
    ((16, 24), (2, 2), [Shard(0), Shard(1)]),
    ((16, 24), (2, 2), [Shard(1), Shard(0)]),
    ((16, 24), (2, 2), [Shard(0), Replicate()]),
    ((16, 24), (2, 2), [Replicate(), Shard(1)]),
    ((16, 24), (2, 2), [Shard(0), Shard(0)]),
    ((6, 3), (4,), [Shard(0)]),  # 2, 2, 2, 0: an empty tail
    ((5, 3), (4,), [Shard(0)]),  # 2, 2, 1, 0
    ((7, 3), (4,), [Shard(0)]),  # 2, 2, 2, 1
    ((3, 5), (4,), [Shard(1)]),
    ((10,), (2, 2), [Shard(0), Shard(0)]),  # nested, uneven
    ((2, 9), (2, 2), [Shard(1), Shard(0)]),
    ((1, 1), (2, 2), [Shard(0), Shard(1)]),
]


@pytest.mark.parametrize("shape,mesh_shape,placements", GEOMETRY)
def test_boxes_match_torch_geometry(shape, mesh_shape, placements) -> None:
    boxes = S.shard_boxes(shape, _ranks(mesh_shape), placements)
    for rank, coord in enumerate(np.ndindex(*mesh_shape)):
        local, offset = _compute_local_shape_and_global_offset(
            shape, mesh_shape, list(coord), placements
        )
        assert tuple(hi - lo for lo, hi in boxes[rank]) == tuple(local), rank
        for (lo, hi), off, n in zip(boxes[rank], offset, local):
            if n:  # an empty shard's offset is not a position
                assert lo == off


def _jax_spec(mesh_shape, placements):
    names = ("x", "y")[: len(mesh_shape)]
    dims = {}
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(names[m])
    return names, dims


@pytest.mark.parametrize("shape,mesh_shape,placements", GEOMETRY)
def test_boxes_match_jax_and_boxes_for_where_they_tile(shape, mesh_shape, placements) -> None:
    """Where jax's NamedSharding tiles (every partitioned dim divides
    evenly), its boxes and both packages' ``boxes_for`` equal DTensor's,
    device i being rank i. Where a dim does not divide, jax refuses, and
    ``boxes_for`` agrees exactly when no shard is empty and every split
    dim is split over one axis (the nested uneven case is the documented
    difference, ROADMAP queue 3)."""
    boxes = S.shard_boxes(shape, _ranks(mesh_shape), placements)
    names, dims = _jax_spec(mesh_shape, placements)
    spec = [tuple(dims.get(d, ())) for d in range(len(shape))]
    layout = LayoutSpec(list(zip(names, mesh_shape)))
    counts = [math.prod(mesh_shape[names.index(a)] for a in axes) for axes in spec]
    even = all(s % c == 0 for s, c in zip(shape, counts))
    if even:
        mesh = Mesh(np.array(jax.devices()[: math.prod(mesh_shape)]).reshape(mesh_shape), names)
        pspec = PartitionSpec(*[(a[0] if len(a) == 1 else a) if a else None for a in spec])
        index_map = NamedSharding(mesh, pspec).devices_indices_map(shape)
        for device, index in index_map.items():
            assert JS._normalize_index(index, shape) == boxes[device.id]
    nonempty = all(hi > lo for box in boxes.values() for lo, hi in box)
    nested = any(len(axes) > 1 for axes in spec)
    if nonempty and (even or not nested):
        want = [boxes[r] for r in range(len(boxes))]
        assert layout.boxes_for(shape, spec) == want
        assert JLayoutSpec(list(zip(names, mesh_shape))).boxes_for(shape, spec) == want
    elif not nonempty:
        with pytest.raises(ValueError, match="non-empty"):
            layout.boxes_for(shape, spec)
    else:
        # Nested and uneven: one split over the product here, nested
        # splits in DTensor.
        assert layout.boxes_for(shape, spec) != [boxes[r] for r in range(len(boxes))]


def test_layout_placements_round_trip_the_specs() -> None:
    layout = LayoutSpec([("x", 2), ("y", 2)])
    for name, (mesh_shape, placements, pspec) in LAYOUTS.items():
        if len(mesh_shape) == 2:
            assert layout.placements_for(list(pspec)) == placements, name
    with pytest.raises(ValueError, match="mesh order"):
        layout.placements_for([("y", "x"), None])


def test_partial_placement_raises_by_name() -> None:
    with pytest.raises(NotImplementedError, match="Partial"):
        S.shard_boxes((4, 4), _ranks((2,)), [Partial()])


def test_empty_boxes_overlap_nothing() -> None:
    assert S._overlap([0, 0], [4, 4], ((2, 2), (0, 4))) is None
    assert S._overlap([0, 0], [4, 4], ((4, 6), (0, 4))) is None
    assert S._overlap([2, 0], [2, 4], ((0, 4), (0, 4))) == (
        (slice(0, 2), slice(0, 4)), (slice(2, 4), slice(0, 4))
    )


# ------------------------------------------------------ the resharding matrix


@pytest.mark.parametrize("src", list(LAYOUTS))
@pytest.mark.parametrize("dst", list(LAYOUTS))
def test_resharding_matrix(tmp_path, src, dst) -> None:
    full = _full()
    entry = _simulated_take(str(tmp_path), _views(full, src))
    views = _views(full, dst, fill=0.0)
    _simulated_restore(str(tmp_path), entry, views)
    for view in views:
        assert torch.equal(view.local, full[_slices(view.local_box)]), view.rank


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pieces_equal_the_jax_packages(tmp_path, layout) -> None:
    """The port writes each distinct box once, as the JAX package does for
    the same layout on 4 devices: the same pieces, byte-identical."""
    full = _full()
    entry = _simulated_take(str(tmp_path / "port"), _views(full, layout))
    mesh_shape, _, pspec = LAYOUTS[layout]
    names = ("x", "y")[: len(mesh_shape)]
    mesh = Mesh(np.array(jax.devices()[: math.prod(mesh_shape)]).reshape(mesh_shape), names)
    arr = jax.device_put(jnp.asarray(full.numpy()), NamedSharding(mesh, pspec))
    J.Snapshot.take(str(tmp_path / "jax"), {"m": J.StateDict(w=arr)})
    jentry = J.Snapshot(str(tmp_path / "jax")).get_manifest()["0/m/w"]
    port = sorted((tuple(s.offsets), tuple(s.sizes)) for s in entry.shards)
    assert port == sorted((tuple(s.offsets), tuple(s.sizes)) for s in jentry.shards)
    for s in entry.shards:
        assert (tmp_path / "port" / s.array.location).read_bytes() == (
            tmp_path / "jax" / s.array.location
        ).read_bytes()


# -------------------------------------- subdivision, election, dtypes, paths


def test_subdivision_matches_the_jax_package() -> None:
    rng = random.Random(0)
    for _ in range(200):
        ndim = rng.randint(1, 3)
        sizes = [rng.randint(1, 40) for _ in range(ndim)]
        offsets = [rng.randint(0, 100) for _ in range(ndim)]
        itemsize = rng.choice([1, 2, 4, 8])
        cap = rng.randint(1, 4000)
        assert S._subdivide(offsets, sizes, itemsize, cap) == JS._subdivide(
            offsets, sizes, itemsize, cap
        )


def test_subdivided_pieces_restore(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(S.ShardedArrayIOPreparer, "max_shard_size_bytes", 200)
    full = _full()
    entry = _simulated_take(str(tmp_path), _views(full, "1d_row"))
    assert len(entry.shards) == 4 * math.ceil(4 * 24 * 4 / 200)
    assert all(math.prod(s.sizes) * 4 <= 200 for s in entry.shards)
    views = _views(full, "2d", fill=0.0)
    _simulated_restore(str(tmp_path), entry, views)
    for view in views:
        assert torch.equal(view.local, full[_slices(view.local_box)])


def test_writer_election_matches_and_writes_each_box_once() -> None:
    rng = random.Random(1)
    for _ in range(200):
        box = tuple((a, a + rng.randint(1, 9)) for a in (rng.randint(0, 50) for _ in range(2)))
        holders = rng.sample(range(8), rng.randint(1, 8))
        assert S._stable_owner(box, holders) == JS._stable_owner(box, holders)
    views = _views(_full(), "partial_repl")
    written = [
        [(tuple(s.offsets), tuple(s.sizes)) for s in S.ShardedArrayIOPreparer.prepare_write(
            "sharded/w", v, DeviceStreams(), copy_cpu=False)[0].shards]
        for v in views
    ]
    boxes = [b for rank_boxes in written for b in rank_boxes]
    assert len(boxes) == len(set(boxes)) == 2  # two distinct boxes over 4 ranks


def test_bf16_round_trips_and_equals_the_jax_packages_bytes(tmp_path) -> None:
    """bf16 pieces round-trip through another layout, and each holds the
    bytes the JAX package writes for the same bf16 array and layout."""
    full = _full(torch.bfloat16)
    entry = _simulated_take(str(tmp_path / "port"), _views(full, "2d"))
    assert entry.dtype == "bfloat16"
    views = _views(full, "combined", fill=0.0)
    _simulated_restore(str(tmp_path / "port"), entry, views)
    for view in views:
        assert torch.equal(view.local, full[_slices(view.local_box)])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    arr = jax.device_put(
        jnp.asarray(full.float().numpy()).astype(jnp.bfloat16),
        NamedSharding(mesh, PartitionSpec("x", "y")),
    )
    J.Snapshot.take(str(tmp_path / "jax"), {"m": J.StateDict(w=arr)})
    for s in entry.shards:
        assert (tmp_path / "port" / s.array.location).read_bytes() == (
            tmp_path / "jax" / s.array.location
        ).read_bytes()


def test_plain_entry_into_sharded_views_and_sharded_into_plain(tmp_path) -> None:
    full = _full()
    P.Snapshot.take(str(tmp_path / "plain"), {"m": P.StateDict(w=full)})
    plain = P.Snapshot(str(tmp_path / "plain")).get_manifest()["0/m/w"]
    views = _views(full, "2d_flip", fill=0.0)
    _simulated_restore(str(tmp_path / "plain"), plain, views)
    for view in views:
        assert torch.equal(view.local, full[_slices(view.local_box)])
    entry = _simulated_take(str(tmp_path / "sh"), _views(full, "combined"))
    dst = torch.zeros(SHAPE)
    reqs = prepare_read(entry, dst, None, DeviceStreams())
    _run(lambda r, loop: sync_execute_read_reqs(r, FSStoragePlugin(str(tmp_path / "sh")),
                                                 1 << 30, 0, loop), reqs)
    assert torch.equal(dst, full)
    got = []
    reqs = prepare_read(entry, None, got.append, DeviceStreams())
    _run(lambda r, loop: sync_execute_read_reqs(r, FSStoragePlugin(str(tmp_path / "sh")),
                                                 1 << 30, 0, loop), reqs)
    assert torch.equal(got[0], full)


def test_shape_mismatch_raises(tmp_path) -> None:
    full = _full()
    entry = _simulated_take(str(tmp_path), _views(full, "1d_row"))
    other = _views(_full(shape=(16, 25)), "1d_row", fill=0.0)
    with pytest.raises(RuntimeError, match="Shape mismatch"):
        prepare_read(entry, other[0], None, DeviceStreams())


# ---------------------------------------------------------- device digests


def _with_digests(entry: ShardedArrayEntry, full: torch.Tensor) -> None:
    for s in entry.shards:
        s.array.device_digest = device_digest.device_fingerprint(
            full[_slices([(o, o + n) for o, n in zip(s.offsets, s.sizes)])].contiguous()
        )


@pytest.mark.parametrize("src,dst", [("1d_row", "1d_col"), ("2d", "2d_flip"),
                                     ("partial_repl", "combined"), ("1d_col", "partial_repl")])
def test_partial_digests_sum_to_each_piece(tmp_path, src, dst) -> None:
    """Every rank's partial lanes over its elected regions of the
    destination, summed over ranks, give each saved piece's fingerprint,
    including pieces that no destination rank holds whole; a changed
    destination changes the sum."""
    full = _full()
    entry = _simulated_take(str(tmp_path), _views(full, src))
    _with_digests(entry, full)
    views = _views(full, dst)

    def verdicts(views):
        merged = {}
        for view in views:
            for i, regions in S.ShardedArrayIOPreparer.partial_digest_contributions(
                entry, view
            ).items():
                for box_key, n, lanes in regions:
                    merged.setdefault(i, {}).setdefault(box_key, (n, lanes))
        out = []
        for i, s in enumerate(entry.shards):
            regions = merged.get(i, {})
            assert sum(n for n, _ in regions.values()) == math.prod(s.sizes)
            out.append(device_digest.combine_partials(
                (lanes for _, lanes in regions.values()), math.prod(s.sizes) * 4
            ) == s.array.device_digest)
        return out

    assert all(verdicts(views))
    for view in views:  # every replica of the changed box
        if view.local_box == views[0].local_box:
            view.local.view(-1)[0] += 1.0
    assert not all(verdicts(views))


@pytest.mark.parametrize("src,dst", [("1d_row", "1d_col"), ("2d", "2d_flip"),
                                     ("combined", "2d"), ("1d_col", "partial_repl")])
def test_partial_digests_fetch_once_per_window_and_equal_jax(tmp_path, monkeypatch, src, dst) -> None:
    """Each window of regions comes back in ONE ``_fetch`` (the JAX package
    fetches region by region), and the contributions of the 4 simulated
    ranks, merged, equal the JAX package's from one process over the same
    layouts (it is elected for every box)."""
    full = _full()
    entry = _simulated_take(str(tmp_path / "port"), _views(full, src))
    fetches, windows = [], []
    orig = device_digest._fetch
    monkeypatch.setattr(device_digest, "_fetch",
                        lambda pendings: (fetches.append(len(pendings)), orig(pendings))[1])
    monkeypatch.setattr(device_digest, "MATCH_WINDOW", 3)  # a rank's 4 regions: 2 windows
    port = {}
    for view in _views(full, dst):
        fetches.clear()
        got = S.ShardedArrayIOPreparer.partial_digest_contributions(entry, view)
        n = sum(len(regions) for regions in got.values())
        assert fetches == [3] * (n // 3) + ([n % 3] if n % 3 else [])
        windows += fetches
        for i, regions in got.items():
            for box_key, n_elems, lanes in regions:
                port[(tuple(entry.shards[i].offsets), box_key)] = (n_elems, lanes)

    names = {1: ("x",), 2: ("x", "y")}
    mesh_shape, _, pspec = LAYOUTS[src]
    mesh = Mesh(np.array(jax.devices()[: math.prod(mesh_shape)]).reshape(mesh_shape), names[len(mesh_shape)])
    J.Snapshot.take(str(tmp_path / "jax"), {"m": J.StateDict(
        w=jax.device_put(jnp.asarray(full.numpy()), NamedSharding(mesh, pspec)))})
    jentry = J.Snapshot(str(tmp_path / "jax")).get_manifest()["0/m/w"]
    mesh_shape, _, pspec = LAYOUTS[dst]
    mesh = Mesh(np.array(jax.devices()[: math.prod(mesh_shape)]).reshape(mesh_shape), names[len(mesh_shape)])
    arr = jax.device_put(jnp.asarray(full.numpy()), NamedSharding(mesh, pspec))
    want = {}
    for i, regions in JS.ShardedArrayIOPreparer.partial_digest_contributions(jentry, arr).items():
        for box_key, n_elems, lanes in regions:
            want[(tuple(jentry.shards[i].offsets), box_key)] = (n_elems, tuple(int(v) for v in lanes))
    assert port == want and port
    assert sum(windows) == len(port)  # each region once, by its box's elected rank


def test_local_digest_check_needs_the_piece_whole(tmp_path) -> None:
    full = _full()
    entry = _simulated_take(str(tmp_path), _views(full, "1d_row"))
    _with_digests(entry, full)
    same = _views(full, "1d_row")
    assert all(S.ShardedArrayIOPreparer._dst_already_matches(entry, v) for v in same)
    cut = _views(full, "1d_col")  # every piece crosses the ranks
    assert not any(S.ShardedArrayIOPreparer._dst_already_matches(entry, v) for v in cut)
    assert S.ShardedArrayIOPreparer._dst_already_matches(entry, full.clone())
    assert not S.ShardedArrayIOPreparer._dst_already_matches(entry, torch.zeros(SHAPE))


# ------------------------------------------------------------------ layout


def test_take_records_the_layout_for_both_packages(tmp_path) -> None:
    spec = LayoutSpec([("x", 2), ("y", 2)], [P.layout.Rule.of(r"m/w$", ["x", "y"], "bfloat16")])
    P.Snapshot.take(str(tmp_path / "s"), {"m": P.StateDict(w=_full())}, layout=spec)
    assert P.Snapshot(str(tmp_path / "s")).metadata.layout == spec.to_dict()
    jax_meta = J.Snapshot(str(tmp_path / "s")).metadata
    assert JLayoutSpec.from_dict(jax_meta.layout).to_dict() == spec.to_dict()
    assert LayoutSpec.from_dict(spec.to_dict()).boxes_for(SHAPE, spec.spec_for("m/w", 2)) == (
        JLayoutSpec.from_dict(spec.to_dict()).boxes_for(SHAPE, spec.spec_for("m/w", 2))
    )


def test_a_malformed_layout_fails_before_any_write(tmp_path) -> None:
    bad = {"version": 1, "mesh": [["x", 2]], "rules": [{"pattern": "w", "spec": [["z"]]}]}
    with pytest.raises(ValueError, match="unknown mesh axis"):
        P.Snapshot.take(str(tmp_path / "s"), {"m": P.StateDict(w=_full())}, layout=bad)
    # No write but the abort's flight and stack dumps (as in the JAX
    # package).
    written = sorted(str(p.relative_to(tmp_path / "s")) for p in (tmp_path / "s").rglob("*")
                     if p.is_file())
    assert written == [".flight/rank_0.jsonl", ".flight/rank_0.stacks.jsonl"]

