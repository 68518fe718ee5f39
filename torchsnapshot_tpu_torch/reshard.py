"""The planned reshard: a layout change on restore without the N-fold
storage read.

Counterpart of ``torchsnapshot_tpu/reshard.py``. A layout change (tp2 ->
tp4, rows -> columns, a world resize) restores through the overlap scatter
of ``io_preparers/sharded.py``: every rank reads from storage every saved
piece that meets its local shard, so a piece that R ranks want is read R
times. Cooperative fan-out (``fanout.py``) cannot help: it dedups
identical requests, while resharding ranks each need another slice.

The plan is a pure function of (manifest entry, every rank's destination
box, world size). Every rank computes every rank's box from the mesh and
the placements (``sharded.shard_boxes``, with one box a process: a rank's
local shard), so all ranks compute the same plan with no communication.
For each saved piece the planner intersects its box with every rank's; a
piece that at least ``min_requesters`` ranks want becomes a planned unit:
one owner, elected among the requesters by ``fanout.greedy_size_balanced``,
reads it once, decodes it (checksum, decompression) and sends each other
requester exactly the regions its box needs: a bundle of one JSON header
line (the payload's checksum and size) and the regions in the plan's
sorted-box order, each the byte view of a contiguous torch tensor in the
stored dtype. The receiver verifies the bundle before anything lands and
scatters it into its local shard, a CUDA one through the HtoD path of
``sharded._ShardScatterConsumer``.

Failure falls back and never fails: a receiver's read request still names
the piece's storage location, so any peer failure (owner death, abort, a
short or corrupt bundle) makes the scheduler read that one entry from
storage (``on_peer_fallback``), bit-exact either way.

Election: ``TORCHSNAPSHOT_GPU_RESHARD`` = never / always / auto (the I/O
governor's ``should_planned_reshard``); unanimous, on the restore's one
flag all-gather.

This module names neither ``torch.cuda`` nor ``torch.distributed``
(``tests/test_torch_isolation.py`` checks it); device copies stay in
``io_preparers``.
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import faultinject, telemetry
from .fanout import RecvRole, count_peer, greedy_size_balanced
from .io_types import BufferConsumer, BufferType
from .manifest import Shard, ShardedArrayEntry

Box = Tuple[Tuple[int, int], ...]

RESHARD_ENV_VAR = "TORCHSNAPSHOT_GPU_RESHARD"
RESHARD_MIN_REQUESTERS_ENV_VAR = "TORCHSNAPSHOT_GPU_RESHARD_MIN_REQUESTERS"

# A bundle is one chunk frame of one generation: at most the decoded piece
# (<= the 512 MB piece cap), which the receiver holds anyway before its
# verify-then-scatter commit. Its JSON header line fits in this many bytes.
_HEADER_SNIFF_BYTES = 256


def reshard_mode() -> str:
    """``TORCHSNAPSHOT_GPU_RESHARD``: "never", "always", or "auto"
    (default: the I/O governor decides per storage plugin)."""
    raw = os.environ.get(RESHARD_ENV_VAR, "auto").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "never"
    if raw in ("1", "true", "on", "yes", "always", "force"):
        return "always"
    return "auto"


def reshard_min_requesters() -> int:
    """``TORCHSNAPSHOT_GPU_RESHARD_MIN_REQUESTERS``: how many ranks must
    want a saved piece before the planner claims it (default and floor
    2: below that there is nothing to dedup)."""
    raw = os.environ.get(RESHARD_MIN_REQUESTERS_ENV_VAR, "")
    try:
        return max(2, int(raw))
    except ValueError:
        return 2


def local_opt_in(plugin_name: str, pg_wrapper: Any) -> bool:
    """This rank's vote. The caller requires every rank's yes and
    supplies the transport; the vote rides the restore's flag
    all-gather."""
    if pg_wrapper.get_world_size() <= 1:
        return False
    mode = reshard_mode()
    if mode != "auto":
        opt_in = mode == "always"
    else:
        from .scheduler import io_governor

        opt_in = io_governor().should_planned_reshard(plugin_name)
    telemetry.record_election(site="reshard", plugin=plugin_name, mode=mode, opt_in=opt_in)
    return opt_in


# --------------------------------------------------------------------------
# The planner: device-free, communication-free, the same on every rank.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PlannedUnit:
    """A saved piece the planner claimed: ``owner`` reads it once and
    sends the other ``requesters`` their regions."""

    shard_index: int
    owner: int
    requesters: Tuple[int, ...]  # sorted; the owner is one of them
    nbytes: int  # decoded piece bytes (the balancing weight)


def plan_entry_transfers(
    entry: ShardedArrayEntry,
    boxes_by_rank: Dict[int, List[Box]],
    min_requesters: int = 2,
) -> List[PlannedUnit]:
    """The box-intersection plan of one sharded entry. ``boxes_by_rank``
    maps every rank to its sorted distinct destination boxes. Ranks go in
    sorted order, boxes in the caller's order, the election pool in
    (-nbytes, location, index) order: the same on every rank."""
    from .io_preparers.sharded import _overlap
    from .serialization import array_size_bytes

    min_requesters = max(2, int(min_requesters))
    ranks = sorted(boxes_by_rank)
    world_size = (ranks[-1] + 1) if ranks else 0
    claimed: List[Tuple[int, Tuple[int, ...], int, str]] = []
    for i, shard in enumerate(entry.shards):
        requesters = [
            rank
            for rank in ranks
            if any(_overlap(shard.offsets, shard.sizes, box) is not None for box in boxes_by_rank[rank])
        ]
        if len(requesters) >= min_requesters:
            claimed.append(
                (
                    i,
                    tuple(requesters),
                    array_size_bytes(shard.array.shape, shard.array.dtype),
                    shard.array.location,
                )
            )
    if not claimed:
        return []
    # Biggest units first so the greedy balance is tight.
    order = sorted(range(len(claimed)), key=lambda j: (-claimed[j][2], claimed[j][3], claimed[j][0]))
    owners = greedy_size_balanced(
        [claimed[j][2] for j in order], world_size, candidates=[list(claimed[j][1]) for j in order]
    )
    units = [
        PlannedUnit(
            shard_index=claimed[j][0], owner=owners[k], requesters=claimed[j][1], nbytes=claimed[j][2]
        )
        for k, j in enumerate(order)
    ]
    units.sort(key=lambda u: u.shard_index)
    return units


def plan_summary(
    entry: ShardedArrayEntry,
    boxes_by_rank: Dict[int, List[Box]],
    min_requesters: int = 2,
) -> Dict[str, int]:
    """The byte accounting of one entry's plan: what direct reads take
    from storage in all (every requester reads the whole piece), what the
    plan takes (one owner a claimed piece), and the peer bytes (the
    minimal region intersections)."""
    from .io_preparers.sharded import _overlap
    from .serialization import array_size_bytes

    units = plan_entry_transfers(entry, boxes_by_rank, min_requesters)
    by_index = {u.shard_index: u for u in units}
    direct = planned = peer = 0
    for i, shard in enumerate(entry.shards):
        nbytes = array_size_bytes(shard.array.shape, shard.array.dtype)
        n_elems = 1
        for s in shard.sizes:
            n_elems *= int(s)
        itemsize = nbytes // max(1, n_elems)
        requesters = []
        for rank in sorted(boxes_by_rank):
            hit = False
            for box in boxes_by_rank[rank]:
                ov = _overlap(shard.offsets, shard.sizes, box)
                if ov is None:
                    continue
                hit = True
                if i in by_index and rank != by_index[i].owner:
                    vol = 1
                    for sl in ov[0]:
                        vol *= sl.stop - sl.start
                    peer += vol * itemsize
            if hit:
                requesters.append(rank)
        direct += nbytes * len(requesters)
        planned += nbytes if i in by_index else nbytes * len(requesters)
    return {
        "shards": len(entry.shards),
        "planned_units": len(units),
        "direct_bytes_from_storage": direct,
        "planned_bytes_from_storage": planned,
        "planned_peer_bytes": peer,
    }


# --------------------------------------------------------------------------
# This rank's roles in one entry's plan.
# --------------------------------------------------------------------------


@dataclass
class OwnerUnit:
    """This rank owns a planned unit: after decoding the piece it sends
    each subscriber its bundle (``bundles``: (rank, peer key, the source
    slices into the piece in the subscriber's sorted-box order), by
    rank)."""

    ctx: "ReshardContext"
    shard_index: int
    bundles: List[Tuple[int, str, List[Tuple[slice, ...]]]]


@dataclass
class RecvUnit:
    """This rank receives a planned unit: ``regions`` lists, in the order
    the owner serializes them, the destination box, the slices into it
    and the region's shape."""

    key: str
    owner: int
    shard_index: int
    regions: List[Tuple[Box, Tuple[slice, ...], Tuple[int, ...]]]


def _unit_peer_key(shard: Shard, dst_rank: int) -> str:
    """The peer-channel key of (saved piece, receiver): receivers need
    different regions, so there is a key a subscriber; the ``reshard|``
    prefix keeps them apart from coop unit keys."""
    br = shard.array.byte_range
    lo, hi = (int(br[0]), int(br[1])) if br is not None else (0, -1)
    return f"reshard|{shard.array.origin or ''}|{shard.array.location}|{lo}|{hi}|{dst_rank}"


class ReshardContext:
    """One app-state key's planned-reshard bookkeeping on one rank, made
    after every rank voted yes. ``plan_entry`` runs the planner and
    projects out this rank's roles; owned keys are tracked so that
    ``abort_incomplete`` can release the subscribers of whatever an
    erroring key never sent."""

    def __init__(
        self, session: Any, rank: int, world_size: int, min_requesters: Optional[int] = None
    ) -> None:
        self.session = session  # fanout.CoopRestoreSession: the transport
        self.rank = rank
        self.world_size = world_size
        self.min_requesters = (
            min_requesters if min_requesters is not None else reshard_min_requesters()
        )
        self._owned: Dict[str, List[int]] = {}
        self._done: set = set()

    def plan_entry(
        self, entry: ShardedArrayEntry, boxes_by_rank: Dict[int, List[Box]]
    ) -> Optional[Dict[int, Any]]:
        """shard index -> OwnerUnit | RecvUnit of this rank, or None when
        the planner claims nothing."""
        from .io_preparers.sharded import _overlap

        with telemetry.span("reshard_plan", cat="fanout", shards=len(entry.shards),
                            ranks=len(boxes_by_rank)):
            units = plan_entry_transfers(entry, boxes_by_rank, self.min_requesters)
        if not units:
            return None

        def regions_for(shard: Shard, dst_rank: int):
            out = []
            for box in boxes_by_rank[dst_rank]:
                ov = _overlap(shard.offsets, shard.sizes, box)
                if ov is not None:
                    src, dst = ov
                    out.append((box, src, dst, tuple(sl.stop - sl.start for sl in src)))
            return out

        roles: Dict[int, Any] = {}
        for unit in units:
            shard = entry.shards[unit.shard_index]
            if unit.owner == self.rank:
                bundles = []
                for sub in unit.requesters:
                    if sub == self.rank:
                        continue
                    key = _unit_peer_key(shard, sub)
                    bundles.append((sub, key, [src for _, src, _, _ in regions_for(shard, sub)]))
                    self._owned[key] = [sub]
                roles[unit.shard_index] = OwnerUnit(self, unit.shard_index, bundles)
            elif self.rank in unit.requesters:
                roles[unit.shard_index] = RecvUnit(
                    key=_unit_peer_key(shard, self.rank),
                    owner=unit.owner,
                    shard_index=unit.shard_index,
                    regions=[(box, dst, shape) for box, _, dst, shape in regions_for(shard, self.rank)],
                )
        telemetry.flightrec.record(
            "reshard.plan", shards=len(entry.shards), planned=len(units),
            owned=sum(isinstance(r, OwnerUnit) for r in roles.values()),
            recv=sum(isinstance(r, RecvUnit) for r in roles.values()),
        )
        return roles or None

    def mark_done(self, key: str) -> None:
        self._done.add(key)

    def abort_incomplete(self) -> None:
        """Abort every owned bundle never sent (the key raised or was
        cancelled), so subscribers read storage at once."""
        for key, subs in self._owned.items():
            if key not in self._done:
                self.session._forward_sync(subs, {"op": "abort", "key": key}, None)
                self._done.add(key)


# --------------------------------------------------------------------------
# The consumers at the two ends of a planned unit.
# --------------------------------------------------------------------------


def encode_bundle(regions: List[Any]) -> bytes:
    """A bundle's bytes: the JSON header line (payload checksum and size)
    and then ``regions`` (buffer-protocol objects) back to back."""
    from .integrity import compute_checksum

    payload = b"".join(regions)
    header = json.dumps(
        {"crc": compute_checksum(payload), "n": len(payload)}, separators=(",", ":")
    ).encode()
    return header + b"\n" + payload


def _forward_bundles(unit: OwnerUnit, arr: Any) -> None:
    """Send each subscriber its regions of the decoded piece ``arr`` (a CPU
    tensor in the stored dtype), each as the bytes of a contiguous copy."""
    from .io_preparers.array import _flat_bytes

    for dst_rank, key, src_slices_list in unit.bundles:
        data = encode_bundle(
            [_flat_bytes(arr[src].contiguous()).numpy() for src in src_slices_list]
        )
        data = faultinject.mutate("reshard.peer_xfer", data)
        session = unit.ctx.session
        with telemetry.span("peer_reshard", cat="fanout", key=key, bytes=len(data)):
            session._forward_sync([dst_rank], {"op": "chunk", "key": key, "gen": 1, "seq": 0},
                                  data)
            session._forward_sync(
                [dst_rank],
                {"op": "end", "key": key, "gen": 1, "nbytes": len(data), "nchunks": 1},
                None,
            )
        count_peer("bytes_to_peers", len(data))
        unit.ctx.mark_done(key)


class PlannedOwnerConsumer(BufferConsumer):
    """The owner's side of one planned piece: decodes the stored payload as
    the direct scatter consumer does, sends each subscriber its bundle
    first (they wait on the wire; the local scatter overlaps), then
    scatters locally.

    The scheduler gives this request no peer role: a coop owner forwards
    the raw stored payload, while a bundle is the decoded minimal regions,
    so sending happens here, after decoding, through the session's
    thread-safe frame writer (a failed send marks the peer dead and never
    raises into the restore)."""

    def __init__(self, direct: Any, unit: OwnerUnit) -> None:
        self.direct = direct  # sharded._ShardScatterConsumer
        self.unit = unit

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        loop = asyncio.get_running_loop()
        arr = await loop.run_in_executor(executor, self.direct._decode, buf)
        await loop.run_in_executor(executor, _forward_bundles, self.unit, arr)
        await self.direct._scatter(arr, executor)

    def get_consuming_cost_bytes(self) -> int:
        return self.direct.get_consuming_cost_bytes()


class PlannedRecvConsumer(BufferConsumer):
    """The receiver's side of a planned piece, in two modes.

    Peer mode (the default): the scheduler's RecvRole delivers the owner's
    bundle; its checksum is verified before anything lands, then each
    region is copied into the local shard in the plan's order.

    Direct mode (after ``on_peer_fallback``): the buffer is the stored
    piece, handed to the wrapped direct consumer. The read request names
    the piece's storage location, so the fallback needs no other plan."""

    def __init__(self, direct: Any, unit: RecvUnit, boxes: Dict[Box, Any]) -> None:
        self.direct = direct  # sharded._ShardScatterConsumer over the same targets
        self.unit = unit
        self.key = unit.key
        self.owner = unit.owner
        self._peer_mode = True
        self._regions = [(boxes[box], dst, shape) for box, dst, shape in unit.regions]

    def on_peer_fallback(self) -> None:
        """Scheduler hook: the peer attempt failed (or the owner was dead
        at dispatch); the next buffer is the stored piece."""
        self._peer_mode = False

    def _verified_regions(self, buf: BufferType) -> List[Any]:
        """The bundle's regions as CPU tensors of the stored dtype, after
        its header parsed and its checksum verified."""
        from .integrity import verify_checksum
        from .serialization import array_size_bytes, tensor_from_buffer

        mv = memoryview(buf).cast("B")
        head = bytes(mv[:_HEADER_SNIFF_BYTES])
        idx = head.find(b"\n")
        if idx < 0:
            raise IOError(f"planned reshard bundle {self.key!r} has no header line")
        try:
            header = json.loads(head[:idx])
            crc, nbytes = header["crc"], int(header["n"])
        except (ValueError, KeyError, TypeError) as e:
            raise IOError(f"planned reshard bundle {self.key!r} header unparseable: {e}") from e
        payload = mv[idx + 1 :]
        if payload.nbytes != nbytes:
            raise IOError(
                f"planned reshard bundle {self.key!r} is {payload.nbytes} byte(s), "
                f"header says {nbytes}"
            )
        # Verify before commit: a mismatch raises IntegrityError, which the
        # scheduler turns into a counted storage fallback.
        verify_checksum(payload, crc, f"peer:{self.key}")
        dtype = self.direct.shard.array.dtype
        out = []
        pos = 0
        for _, _, shape in self._regions:
            n = array_size_bytes(shape, dtype)
            out.append(tensor_from_buffer(payload[pos : pos + n], dtype, shape))
            pos += n
        if pos != payload.nbytes:
            raise IOError(
                f"planned reshard bundle {self.key!r} has {payload.nbytes - pos} trailing "
                f"byte(s) after {len(self._regions)} region(s)"
            )
        return out

    async def consume_buffer(self, buf: BufferType, executor=None) -> None:
        if not self._peer_mode:
            await self.direct.consume_buffer(buf, executor)
            return
        loop = asyncio.get_running_loop()
        regions = await loop.run_in_executor(executor, self._verified_regions, buf)
        nbytes = 0
        for (dst_box, dst_slices, _), region in zip(self._regions, regions):
            await self.direct._land(region, dst_box[dst_slices] if dst_slices else dst_box, executor)
            nbytes += region.numel() * region.element_size()
        count_peer("bytes_resharded_from_peers", nbytes)
        self.direct.completion.part_done()

    def get_consuming_cost_bytes(self) -> int:
        # The fallback decodes the whole stored piece; budget for it.
        return self.direct.get_consuming_cost_bytes()


# --------------------------------------------------------------------------
# The composed plan: reshard roles first, coop dedup second.
# --------------------------------------------------------------------------


class ComposedRestorePlan:
    """``take_role`` over (planned reshard, coop dedup) for one key.
    Requests the reshard claimed never enter the coop gather
    (``snapshot.py`` filters them on every rank alike), so the two can
    never give one request two roles."""

    def __init__(self, ctx: ReshardContext, coop_plan: Optional[Any]) -> None:
        self._ctx = ctx
        self._coop = coop_plan

    def take_role(self, read_req: Any):
        consumer = getattr(read_req, "buffer_consumer", None)
        if isinstance(consumer, PlannedRecvConsumer):
            if consumer.owner in self._ctx.session._dead:
                # An owner known dead at dispatch: skip the doomed wait.
                count_peer("fanout_fallbacks", 1)
                telemetry.flightrec.record("fanout.fallback", key=consumer.key,
                                           owner=consumer.owner)
                consumer.on_peer_fallback()
                return None
            return RecvRole(self._ctx.session, consumer.key, consumer.owner)
        if isinstance(consumer, PlannedOwnerConsumer):
            # Owners read storage like a plain request and send from the
            # consumer, after decoding.
            return None
        if self._coop is not None:
            return self._coop.take_role(read_req)
        return None

    def abort_incomplete(self) -> None:
        self._ctx.abort_incomplete()
        if self._coop is not None:
            self._coop.abort_incomplete()


def is_reshard_claimed(read_req: Any) -> bool:
    """True when a read request carries a planned-reshard role:
    ``snapshot.py`` keeps these out of the coop unit gather."""
    consumer = getattr(read_req, "buffer_consumer", None)
    return isinstance(consumer, (PlannedRecvConsumer, PlannedOwnerConsumer))
