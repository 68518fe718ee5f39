"""The port's counterparts of ``__graft_entry__.entry()`` and of its train
state.

Both use the configuration the JAX entry point uses (vocab 8192, d_model
512, 8 heads, 4 layers, d_ff 2048, tokens (4, 256), bf16 compute, f32
params), or the ``cfg`` passed (the f32 path passes it with
``dtype=torch.float32``), with random parameters drawn from ``seed``, and
run on CUDA unless ``device="cpu"`` is passed:

- ``entry()`` returns ``(fn, (params, tokens))``: the serving forward,
  graph-free under ``torch.inference_mode``;
- ``train_entry()`` returns ``(train_step, (state, batch))``: one AdamW
  step of the train state ``{params, opt_state, step}`` on a batch of
  tokens and targets drawn from the seed, in place.

``dryrun_multichip(n)`` is the counterpart of the JAX entry point of the
same name: a world of ``n`` processes runs one sharded train step, the
snapshot round trip of its state with the device-digest take and restore,
the GPipe and 1F1B pipelined steps, and, for ``n >= 8``, the pod drill.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import telemetry
from .device import resolve_device
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
    device: Optional[str] = None, seed: int = 0, cfg: T.TransformerConfig = ENTRY_CONFIG
) -> Tuple[Callable[..., Any], Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    opt = T.make_optimizer()
    gen = torch.Generator().manual_seed(seed)
    state = T.init_state(gen, cfg, opt, device)
    dev = state["params"]["embed"].device
    batch = {
        name: torch.randint(0, cfg.vocab_size, ENTRY_TOKENS_SHAPE, generator=gen).to(dev)
        for name in ("tokens", "targets")
    }
    return T.make_train_step(cfg, opt), (state, batch)


def dryrun_config(n_devices: int, attn_impl: str) -> T.TransformerConfig:
    """The JAX dryrun's tiny configuration (``__graft_entry__.py:91-102``):
    d_model and d_ff scale with the world, and the ring layout runs a
    top-2 MoE FFN with its experts over ``model``."""
    return T.TransformerConfig(
        vocab_size=256,
        d_model=8 * max(2, n_devices),
        n_heads=2,
        n_layers=2,
        d_ff=16 * max(2, n_devices),
        max_seq_len=32,
        attn_impl=attn_impl,
        n_experts=2 if attn_impl == "ring" else 0,
    )


def dryrun_layouts(n_devices: int, cfg: Optional[T.TransformerConfig] = None):
    """``(mesh sizes, attn_impl, mesh sizes of the restore)``, as the JAX
    dryrun picks them (``__graft_entry__.py:80-89``, ``:156-180``): for a
    world divisible by 4, ``{"data": n // 4, "seq": 2, "model": 2}`` with
    ring attention, restored into ``{"data": n // 2, "seq": 1, "model":
    2}``; otherwise ``make_mesh``'s default data x model layout with dense
    attention, restored into its transpose where the heads and d_ff
    divide it."""
    if n_devices % 4 == 0:
        return ({"data": n_devices // 4, "seq": 2, "model": 2}, "ring",
                {"data": n_devices // 2, "seq": 1, "model": 2})
    model = 1
    while model * 2 <= int(n_devices**0.5) and n_devices % (model * 2) == 0:
        model *= 2
    default = {"data": n_devices // model, "model": model}
    swapped = {"data": model, "model": n_devices // model}
    cfg = cfg or dryrun_config(n_devices, "dense")
    ok = cfg.n_heads % swapped["model"] == 0 and cfg.d_ff % swapped["model"] == 0
    return default, "dense", swapped if ok else default


def _global_state(state: Dict[str, Any], cfg: T.TransformerConfig, mesh) -> Dict[str, Any]:
    """Every leaf of a mesh train state whole, on the CPU (no autograd), in
    tensors of its own."""
    from .parallel.mesh import gather_tree

    return gather_tree(state, T.state_specs(cfg, state), mesh)


def _launches() -> Dict[str, int]:
    from .ops import flash_attention as FA

    return {k.__name__: k.launches for k in (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv)}


def _dryrun_rank(rank: int, world: int, device: str, cfg, tokens_shape, root: str, seed: int):
    from . import Snapshot, StateDict
    from .parallel import make_mesh

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    sizes, impl, sizes2 = dryrun_layouts(world, cfg)
    cfg = dataclasses.replace(cfg, attn_impl=impl) if cfg else dryrun_config(world, impl)
    mesh, mesh2 = make_mesh(sizes, device=device), make_mesh(sizes2, device=device)
    opt = T.make_optimizer()

    def batch(data: int):
        shape = tokens_shape or (data * 2, 32)
        gen = torch.Generator().manual_seed(seed)
        return {k: torch.randint(0, cfg.vocab_size, shape, generator=gen).to(device)
                for k in ("tokens", "targets")}

    state = T.init_state(torch.Generator().manual_seed(seed), cfg, opt, mesh=mesh)
    before = _launches()
    state, loss = T.make_train_step(cfg, opt, mesh=mesh)(state, batch(sizes["data"]))
    launches = {k: v - before[k] for k, v in _launches().items()}
    step = int(state["step"].to_local())
    if step != 1:
        raise AssertionError(f"rank {rank}: step {step} after one train step")

    # The snapshot round trip, into the other layout.
    t0 = telemetry.monotonic()
    Snapshot.take(f"{root}/ckpt", {"train": StateDict(state)})
    take_s = telemetry.monotonic() - t0
    dst = StateDict(T.init_state(torch.Generator().manual_seed(seed + 1), cfg, opt, mesh=mesh2))
    t0 = telemetry.monotonic()
    Snapshot(f"{root}/ckpt").restore({"train": dst})
    restore_s = telemetry.monotonic() - t0
    restored = dict(dst)
    want, got = _global_state(state, cfg, mesh), _global_state(restored, cfg, mesh2)
    from .parallel.mesh import map_tree

    mismatched = []
    map_tree(lambda a, b: mismatched.append(1) if not torch.equal(a, b) else None, want, got)
    if mismatched:
        raise AssertionError(f"rank {rank}: {len(mismatched)} leaves differ after the restore")
    restored, loss2 = T.make_train_step(cfg, opt, mesh=mesh2)(restored, batch(sizes2["data"]))
    step2 = int(restored["step"].to_local())
    if step2 != 2:
        raise AssertionError(f"rank {rank}: step {step2} after the step from the restore")
    out = {
        "mesh": sizes, "attn_impl": impl, "restore_mesh": sizes2, "loss": float(loss),
        "loss_after_restore": float(loss2), "launches": launches, "take_s": take_s,
        "restore_s": restore_s,
    }
    out.update(_device_digest_round_trip(rank, f"{root}/dd", restored))
    if world % 2 == 0:
        out["pipeline"] = dryrun_pipeline(world, device, seed=seed)
    return out


def _device_digest_round_trip(rank: int, root: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """The device-digest half of the JAX round trip (``__graft_entry__.py``
    :207-256): the mesh state is fingerprinted per owned piece (K4's full
    form on a CUDA tensor); an unchanged incremental take must stage
    nothing, and a restore into a destination that already holds the
    content must consume nothing. Spies on the stager and the consumers
    count both, as the JAX dryrun's do."""
    from . import Snapshot, StateDict
    from .device_digest import fingerprint_lanes
    from .io_preparers.array import ArrayBufferConsumer, ArrayBufferStager
    from .io_preparers.sharded import _ShardScatterConsumer

    Snapshot.take(f"{root}/base", {"train": StateDict(state)}, device_digests=True)
    staged, consumed, spies = [], [], []

    def spy(klass, name, record):
        orig = getattr(klass, name)

        def wrapper(self, *args, **kwargs):
            record.append(getattr(getattr(self, "entry", None), "location", type(self).__name__))
            return orig(self, *args, **kwargs)

        spies.append((klass, name, orig))
        setattr(klass, name, wrapper)

    launches0 = fingerprint_lanes.launches
    try:
        for name in ("_stage_cuda", "_stage_cpu", "stage_stream"):
            spy(ArrayBufferStager, name, staged)
        Snapshot.take(f"{root}/incremental", {"train": StateDict(state)},
                      incremental_base=f"{root}/base", device_digests=True)
        for klass in (ArrayBufferConsumer, _ShardScatterConsumer):
            for name in ("consume_buffer", "consume_stream"):
                if hasattr(klass, name):
                    spy(klass, name, consumed)
        Snapshot(f"{root}/base").restore({"train": StateDict(state)}, device_digests=True)
    finally:
        for klass, name, orig in reversed(spies):
            setattr(klass, name, orig)
    if staged:
        raise AssertionError(f"rank {rank}: the device-digest take staged {staged}")
    if consumed:
        raise AssertionError(f"rank {rank}: the device-digest restore consumed {consumed}")
    return {"dd_staged": len(staged), "dd_consumed": len(consumed),
            "dd_launches": fingerprint_lanes.launches - launches0}


def dryrun_pipeline(world: int, device: str, *, layers: int = 4, width: int = 8,
                    rows: Optional[int] = None, n_micro: int = 4, seed: int = 0) -> Dict[str, Any]:
    """``_dryrun_pipeline`` (``__graft_entry__.py:323-391``) on this rank of
    a world already joined: on ``{data world/2, pipe 2}``, layer-stacked
    tanh layers (``layers`` x ``width``) placed by
    ``pipeline_param_sharding``, one GPipe step through
    ``pipelined_apply`` with autograd, then one 1F1B step through
    ``pipelined_value_and_grad``, each an SGD update of lr 0.01 (``rows``
    defaults to JAX's ``4 x data``). Returns the two losses."""
    from .parallel import make_mesh, shard_pytree
    from .parallel.mesh import to_local
    from .parallel.pipeline import (
        pipeline_param_sharding,
        pipelined_apply,
        pipelined_value_and_grad,
    )

    n_pipe = 2
    mesh = make_mesh({"data": world // n_pipe, "pipe": n_pipe}, device=device)
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(layers, width, width, generator=gen) * width**-0.5,
              "b": torch.zeros(layers, width)}
    params = shard_pytree(params, pipeline_param_sharding(params, mesh), mesh)
    rows = rows or n_micro * (world // n_pipe)
    x = torch.ones(rows, width, device=mesh.device_type)
    targets = torch.zeros(rows, width, device=mesh.device_type)

    def layer_fn(layer, h):
        return torch.tanh(h @ layer["w"] + layer["b"])

    def sgd(grads):
        with torch.no_grad():
            for k, g in grads.items():
                to_local(params[k]).sub_(0.01 * to_local(g))

    for p in params.values():
        p.requires_grad_(True)
    gpipe_loss = (pipelined_apply(params, x, mesh, layer_fn=layer_fn, n_micro=n_micro) ** 2).mean()
    grads = torch.autograd.grad(gpipe_loss, list(params.values()))
    for p in params.values():
        p.requires_grad_(False)
    sgd(dict(zip(params, grads)))
    loss_1f1b, grads = pipelined_value_and_grad(
        params, x, targets, mesh, layer_fn=layer_fn,
        loss_fn=lambda y, t: ((y - t) ** 2).mean(), n_micro=n_micro,
    )
    sgd(grads)
    losses = {"gpipe_loss": float(gpipe_loss), "1f1b_loss": float(loss_1f1b)}
    if not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"a pipelined loss is not finite: {losses}")
    return losses


POD_LOCAL_WORLD_SIZE = 4


def _pod_rank(rank: int, world: int, root: str) -> str:
    """The pod drill (``__graft_entry__.py:259-320``) on one rank: a
    ``("proc", "local")`` mesh of (world / 4, 4) over a CPU gloo world
    standing in for hosts of 4 local ranks, an (8, 8) f32 array sharded
    ``P("proc", "local")`` plus ``step=3`` taken, then restored into the
    (4, world / 4) mesh; every local shard must come back bit-exact."""
    from torch.distributed.tensor import distribute_tensor

    from . import Snapshot, StateDict
    from .parallel import make_mesh
    from .parallel.mesh import P, placements

    os.environ["LOCAL_WORLD_SIZE"] = str(POD_LOCAL_WORLD_SIZE)
    hosts = world // POD_LOCAL_WORLD_SIZE
    data = torch.arange(64, dtype=torch.float32).reshape(8, 8)

    def make(shape, fill):
        mesh = make_mesh(dict(zip(("proc", "local"), shape)), device="cpu")
        return distribute_tensor(fill.clone(), mesh, placements(P("proc", "local"), mesh, 2),
                                 src_data_rank=None)

    arr = make((hosts, POD_LOCAL_WORLD_SIZE), data)
    Snapshot.take(root, {"m": StateDict(emb=arr, step=3)})
    out = StateDict(emb=make((POD_LOCAL_WORLD_SIZE, hosts), torch.zeros(8, 8)), step=-1)
    Snapshot(root).restore({"m": out})
    if out["step"] != 3:
        raise AssertionError(f"rank {rank}: step {out['step']} restored, not 3")
    dst = out["emb"]
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(dst.shape, dst.device_mesh,
                                                          dst.placements)
    want = data[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if not torch.equal(dst.to_local(), want):
        raise AssertionError(f"rank {rank}: the restored shard differs")
    return "ok"


def dryrun_multichip(
    n_devices: int,
    *,
    device: Optional[str] = None,
    cfg: Optional[T.TransformerConfig] = None,
    tokens_shape: Optional[Tuple[int, int]] = None,
    seed: int = 0,
    timeout: float = 600.0,
) -> Dict[int, Dict[str, Any]]:
    """The counterpart of ``__graft_entry__.dryrun_multichip`` (:74-118)
    and of the multi-device half of its ``_dryrun_snapshot_roundtrip``
    (:138-200): a gloo world of ``n_devices`` processes
    (``test_utils.run_with_subprocesses``), every process on the card
    (several share one card when the host has fewer), or on the CPU with
    ``device="cpu"``. Each rank builds the mesh of :func:`dryrun_layouts`,
    runs one train step of the sharded state (``cfg`` at its own widths
    with the layout's attn_impl, else :func:`dryrun_config`; ``tokens_shape``
    else (2 x data, 32) tokens from ``seed``), takes the state with
    ``Snapshot.take``, restores it into the other layout (bit-exact against
    the state it took) and runs a second step there. Returns each rank's
    losses, K1-K3 launches of the first step, and take and restore times.

    Not run yet: the pipelined step (``_dryrun_pipeline``, GPipe and 1F1B
    of ``parallel/pipeline.py``), the pod-topology drill
    (``_dryrun_pod_topology``) and the device-digest incremental take and
    restore of the round trip."""
    from .test_utils import run_with_subprocesses

    device = device or "cuda"
    resolve_device(device)
    root = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        ranks = run_with_subprocesses(
            _dryrun_rank, n_devices, device, cfg, tokens_shape, root, seed,
            backend="gloo", timeout=timeout,
        )
        if n_devices >= 8:
            pod = run_with_subprocesses(_pod_rank, n_devices, f"{root}/pod", backend="gloo",
                                        timeout=timeout)
            for r in ranks:
                ranks[r]["pod"] = pod[r]
        return ranks
    finally:
        shutil.rmtree(root, ignore_errors=True)
