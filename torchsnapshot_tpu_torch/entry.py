"""The port's counterparts of ``__graft_entry__.entry()`` and of its train
state.

Both use the configuration the JAX entry point uses (vocab 8192, d_model
512, 8 heads, 4 layers, d_ff 2048, tokens (4, 256), bf16 compute, f32
params), with random parameters drawn from ``seed``, and run on CUDA
unless ``device="cpu"`` is passed:

- ``entry()`` returns ``(fn, (params, tokens))``: the serving forward,
  graph-free under ``torch.inference_mode``;
- ``train_entry()`` returns ``(train_step, (state, batch))``: one AdamW
  step of the train state ``{params, opt_state, step}`` on a batch of
  tokens and targets drawn from the seed, in place.

``dryrun_multichip(n)`` is the counterpart of the JAX entry point of the
same name: a world of ``n`` processes runs one sharded train step and the
snapshot round trip of its state.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

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
    device: Optional[str] = None, seed: int = 0
) -> Tuple[Callable[..., Any], Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    opt = T.make_optimizer()
    gen = torch.Generator().manual_seed(seed)
    state = T.init_state(gen, ENTRY_CONFIG, opt, device)
    dev = state["params"]["embed"].device
    batch = {
        name: torch.randint(0, ENTRY_CONFIG.vocab_size, ENTRY_TOKENS_SHAPE, generator=gen).to(dev)
        for name in ("tokens", "targets")
    }
    return T.make_train_step(ENTRY_CONFIG, opt), (state, batch)


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
    from .parallel.mesh import gather, map_tree, to_local

    specs = T.state_specs(cfg, state)
    return map_tree(
        lambda t, spec: gather(to_local(t), mesh, spec).to("cpu", copy=True), state, specs
    )


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
    t0 = time.perf_counter()
    Snapshot.take(f"{root}/ckpt", {"train": StateDict(state)})
    take_s = time.perf_counter() - t0
    dst = StateDict(T.init_state(torch.Generator().manual_seed(seed + 1), cfg, opt, mesh=mesh2))
    t0 = time.perf_counter()
    Snapshot(f"{root}/ckpt").restore({"train": dst})
    restore_s = time.perf_counter() - t0
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
    return {
        "mesh": sizes, "attn_impl": impl, "restore_mesh": sizes2, "loss": float(loss),
        "loss_after_restore": float(loss2), "launches": launches, "take_s": take_s,
        "restore_s": restore_s,
    }


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
        return run_with_subprocesses(
            _dryrun_rank, n_devices, device, cfg, tokens_shape, root, seed,
            backend="gloo", timeout=timeout,
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
