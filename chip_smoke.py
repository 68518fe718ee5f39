#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Imports torch and ``torchsnapshot_tpu_torch`` only (no JAX, nothing of the
JAX package). Phases, in order; any failure exits non-zero and prints no
result line:

1. build   - compile every CUDA kernel of the path from ``csrc/`` (nvcc,
             sm_90a), all sources at once.
2. kernels - hold each kernel against its plain PyTorch version on the
             card: flash_fwd (o and lse), causal and not, f32 and bf16,
             D=64 and D=128, the serving shape and a sequence length that
             is not a multiple of the kernel's 64-row tile.
3. serve   - the ``entry()`` configuration (vocab 8192, d_model 512, 8
             heads, 4 layers, tokens (4, 256), bf16) answers a few
             requests with ``attn_impl="auto"``; launch counts are read
             across this phase alone; logits are held against
             ``attn_impl="dense"``.
4. checkpoint - Snapshot.take of the params, a progress StateDict and
             RNGState; restore into a zeroed model must be bit-exact and
             answer with bit-identical logits; async_take, overwrite the
             params at once, restore: the pre-overwrite values come back.
5. state   - take and restore about 2 GiB of CUDA tensors (100 MiB f32
             tensors plus bf16), bit-exact; prints the save and restore
             GB/s, and how long an async_take of that state holds the
             caller.
6. timing  - each kernel at the serving shape against its plain version
             and one library call, with its bound from the bytes and
             operations of this run's inputs.
7. profile - steady-state serving latency with flash and with dense
             attention, and the device time of one traced forward by
             kernel.

Prints the kernels' JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Bars of tests/test_pallas_attention.py: 1e-5 for f32, 3e-2 for bf16 (o).
# For bf16 inputs the lse is f32 arithmetic on exactly upcast values, so it
# is held at 1e-4 (summation order only).
O_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
LSE_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# bf16 logits, flash vs dense: the dense reference rounds its scores to
# bf16 before the softmax, the kernel keeps them in f32. At logits of
# |x| ~ 5 one bf16 step is 1/32, so the bar is four steps on the maximum
# and a tenth of a step on the mean.
LOGITS_MAX_ATOL = 0.125
LOGITS_MEAN_ATOL = 0.01

DEVICE = "cuda"
STATE_F32_TENSORS, F32_TENSOR_BYTES = 19, 100 << 20
STATE_BF16_TENSORS, BF16_TENSOR_BYTES = 2, 50 << 20
N_REQUESTS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns, iters: int, rounds: int = 5):
    """Median ms per call of each function, timed in alternating turns
    (a b c, c b a, ...) so clock drift favours none of them; also returns
    each function's (min, max) over the rounds."""
    samples = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(reversed(list(fns)))
        for name in order:
            samples[name].append(cuda_time_ms(fns[name], iters=iters))
    medians = {name: statistics.median(v) for name, v in samples.items()}
    spreads = {name: (min(v), max(v)) for name, v in samples.items()}
    return medians, spreads


def phase_build() -> None:
    from torchsnapshot_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(["flash_fwd"])
    log(f"[build] flash_fwd built in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("flash_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def _qkv(shape, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=DEVICE).to(dtype) for _ in range(3))


def phase_kernels() -> float:
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    worst = 0.0
    shapes = [(32, 256, 64), (16, 256, 128), (8, 200, 64)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = _qkv(shape, dtype, seed=len(shape) + shape[1])
                o, lse = fa.flash_fwd_cuda(q, k, v, causal=causal)
                o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err_o = (o.float() - o_ref.float()).abs().max().item()
                err_l = (lse - lse_ref).abs().max().item()
                ok = err_o <= O_ATOL[dtype] and err_l <= LSE_ATOL[dtype]
                log(
                    f"[kernels] flash_fwd BH,S,D={shape} {str(dtype)[6:]} causal={causal}: "
                    f"max|o-ref|={err_o:.3g} max|lse-ref|={err_l:.3g} "
                    f"{'ok' if ok else 'FAIL'}"
                )
                if not ok:
                    raise AssertionError(f"flash_fwd disagrees with its plain version at {shape}")
                worst = max(worst, err_o, err_l)
    return worst


def phase_serve(fn, params, cfg):
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEVICE).manual_seed(1)
    requests = [
        torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device=DEVICE)
        for _ in range(N_REQUESTS)
    ]
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    answers = [fn(params, tokens) for tokens in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
    log(f"[serve] {N_REQUESTS} requests of (4, 256) tokens in {wall * 1e3:.1f} ms; "
        f"flash_fwd launches {launches}")
    if launches != N_REQUESTS * cfg.n_layers:
        raise AssertionError(
            f"expected {N_REQUESTS * cfg.n_layers} flash_fwd launches, got {launches}"
        )
    # A reload can only answer bit-identically if the forward itself is
    # deterministic: answer the first request again and require equality.
    again = fn(params, requests[0])
    if not torch.equal(again, answers[0]):
        q, k, v = _qkv((32, 256, 64), torch.bfloat16, seed=4)
        x, w = _qkv((1024, 512), torch.bfloat16, seed=5)[:2]
        log(
            f"[serve] forward not deterministic: max diff "
            f"{(again.float() - answers[0].float()).abs().max().item()}; "
            f"flash_fwd repeat equal {torch.equal(fa.flash_fwd(q, k, v)[0], fa.flash_fwd(q, k, v)[0])}; "
            f"matmul repeat equal {torch.equal(x @ w.T, x @ w.T)}"
        )
        raise AssertionError("the same request answered twice gave different logits")
    log("[serve] the same request answered twice: bit-identical logits")
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    for tokens, logits in zip(requests, answers):
        if logits.shape != (4, 256, cfg.vocab_size) or not torch.isfinite(logits.float()).all():
            raise AssertionError("serving logits are malformed or not finite")
        ref = T.forward(params, tokens, dense_cfg).float()
        diff = (logits.float() - ref).abs()
        log(f"[serve] logits vs dense: max {diff.max().item():.4f} mean {diff.mean().item():.5f}")
        if diff.max().item() > LOGITS_MAX_ATOL or diff.mean().item() > LOGITS_MEAN_ATOL:
            raise AssertionError("flash logits disagree with dense logits")
    return launches, requests[0], answers[0]


def _zeros_like_params(params):
    return {
        "embed": torch.zeros_like(params["embed"]),
        "layers": {k: torch.zeros_like(v) for k, v in params["layers"].items()},
        "ln_f_scale": torch.zeros_like(params["ln_f_scale"]),
    }


def _leaves(params):
    yield "embed", params["embed"]
    for k, v in params["layers"].items():
        yield f"layers/{k}", v
    yield "ln_f_scale", params["ln_f_scale"]


def phase_checkpoint(fn, params, tokens, logits, root: str) -> None:
    from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict

    progress = {"step": 7, "requests_served": N_REQUESTS}
    Snapshot.take(
        f"{root}/ckpt",
        {"model": StateDict(params=params), "progress": StateDict(progress), "rng": RNGState()},
    )
    fresh = _zeros_like_params(params)
    fresh_progress = StateDict(step=0, requests_served=0)
    Snapshot(f"{root}/ckpt").restore(
        {"model": StateDict(params=fresh), "progress": fresh_progress, "rng": RNGState()}
    )
    for name, t in _leaves(params):
        got = dict(_leaves(fresh))[name]
        if got.device != t.device or not torch.equal(got, t):
            raise AssertionError(f"restored param {name} differs from the saved one")
    if dict(fresh_progress) != progress:
        raise AssertionError(f"restored progress {dict(fresh_progress)} != {progress}")
    again = fn(fresh, tokens)
    if not torch.equal(again, logits):
        raise AssertionError("restored model's logits are not bit-identical")
    log("[checkpoint] take -> restore into zeros: params bit-exact, logits bit-identical")

    before = {name: t.clone() for name, t in _leaves(params)}
    pending = Snapshot.async_take(f"{root}/async", {"model": StateDict(params=params)})
    for _, t in _leaves(params):
        t.add_(1.0)  # overwrite as soon as async_take returns
    pending.wait()
    fresh = _zeros_like_params(params)
    Snapshot(f"{root}/async").restore({"model": StateDict(params=fresh)})
    for name, t in _leaves(fresh):
        if not torch.equal(t, before[name]):
            raise AssertionError(f"async_take captured a value of {name} written after it returned")
    for _, t in _leaves(params):
        t.sub_(1.0)
    log("[checkpoint] async_take, overwrite at return, restore: pre-overwrite values back")


def phase_state(root: str, card: str):
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    g = torch.Generator(device=DEVICE).manual_seed(2)
    state = {}
    for i in range(STATE_F32_TENSORS):
        state[f"f32_{i}"] = torch.randn(F32_TENSOR_BYTES // 4, generator=g, device=DEVICE)
    for i in range(STATE_BF16_TENSORS):
        state[f"bf16_{i}"] = torch.randn(
            BF16_TENSOR_BYTES // 2, generator=g, device=DEVICE
        ).to(torch.bfloat16).reshape(-1, 1024)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot.take(f"{root}/state", {"model": StateDict(state)})
    save_s = time.perf_counter() - t0
    dst = {k: torch.zeros_like(t) for k, t in state.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Snapshot(f"{root}/state").restore({"model": StateDict(dst)})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for k, t in state.items():
        if not torch.equal(dst[k], t):
            raise AssertionError(f"2 GiB state: {k} restored wrong")
    log(
        f"[state] {nbytes / 2**30:.3f} GiB in {len(state)} CUDA tensors, bit-exact; "
        f"save {nbytes / save_s / 1e9:.3f} GB/s ({save_s:.3f} s), "
        f"restore {nbytes / restore_s / 1e9:.3f} GB/s ({restore_s:.3f} s) on {card}"
    )
    # The training stall of an async take: the caller is held until every
    # entry is staged in pinned memory; writes finish in the background.
    t0 = time.perf_counter()
    pending = Snapshot.async_take(f"{root}/state_async", {"model": StateDict(state)})
    stall_s = time.perf_counter() - t0
    pending.wait()
    total_s = time.perf_counter() - t0
    log(f"[state] async_take of the same state: returned after {stall_s:.3f} s, "
        f"committed after {total_s:.3f} s on {card}")


def phase_timing(launches: int, max_err: float) -> dict:
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    B, H, S, D = 4, 8, 256, 64
    q, k, v = _qkv((B * H, S, D), torch.bfloat16, seed=3)
    q4, k4, v4 = (t.reshape(B, H, S, D) for t in (q, k, v))
    ms, spread = time_in_turns(
        {
            "kernel": lambda: fa.flash_fwd_cuda(q, k, v, causal=True),
            "plain": lambda: fa.flash_fwd_reference(q, k, v, causal=True),
            "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        },
        iters=100,
    )
    kernel_ms, plain_ms, library_ms = ms["kernel"], ms["plain"], ms["sdpa"]
    # Least work: q, k, v read once, o and lse written once; the causal
    # dots need q.k and p.v over the S(S+1)/2 attended pairs of each head.
    nbytes = 4 * B * H * S * D * q.element_size() + B * H * S * 4
    flops = 4 * B * H * (S * (S + 1) // 2) * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    log(
        f"[timing] flash_fwd (BH={B * H}, S={S}, D={D}, bf16, causal), median of 5 rounds "
        f"x 100 (range): kernel {kernel_ms * 1e3:.2f} us ({spread['kernel'][0] * 1e3:.2f}-"
        f"{spread['kernel'][1] * 1e3:.2f}), plain {plain_ms * 1e3:.2f} us "
        f"({spread['plain'][0] * 1e3:.2f}-{spread['plain'][1] * 1e3:.2f}), sdpa "
        f"{library_ms * 1e3:.2f} us ({spread['sdpa'][0] * 1e3:.2f}-{spread['sdpa'][1] * 1e3:.2f}), "
        f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us ({nbytes} B, {flops} flop)"
    )
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "torchsnapshot_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "torchsnapshot_tpu/ops/pallas_attention.py:44",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def phase_profile(fn, params, tokens, cfg) -> None:
    """Steady-state serving latency (flash and dense attention) and where
    one traced forward's device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchsnapshot_tpu_torch.models import transformer as T

    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    ms, spread = time_in_turns(
        {"flash": lambda: fn(params, tokens), "dense": lambda: T.forward(params, tokens, dense_cfg)},
        iters=10,
    )
    log(f"[profile] serving forward, (4, 256) tokens, median of 5 rounds x 10: "
        f"{ms['flash']:.3f} ms with flash_fwd (range {spread['flash'][0]:.3f}-{spread['flash'][1]:.3f}), "
        f"{ms['dense']:.3f} ms with dense attention "
        f"(range {spread['dense'][0]:.3f}-{spread['dense'][1]:.3f})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(params, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        (e.key, getattr(e, "self_device_time_total", 0.0), e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us <= 0:
        log("[profile] device time: not measured (the profiler recorded no device time)")
        return
    log(f"[profile] traced forward: wall {wall_us:.0f} us, device busy {busy_us:.0f} us, "
        f"idle share {1 - busy_us / wall_us:.3f}")
    for name, t, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"[profile]   {t:9.1f} us  x{count:<3d} {name[:90]}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from torchsnapshot_tpu_torch.entry import ENTRY_CONFIG, entry

    # Reproducible cuBLAS GEMMs (set before the first cuBLAS handle): the
    # checkpoint phase requires a restored model to answer bit-identically.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    max_err = phase_kernels()
    fn, (params, _) = entry(device=DEVICE, seed=0)
    launches, tokens, logits = phase_serve(fn, params, ENTRY_CONFIG)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_checkpoint(fn, params, tokens, logits, root)
        phase_state(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernel = phase_timing(launches, max_err)
    phase_profile(fn, params, tokens, ENTRY_CONFIG)

    print(json.dumps({"kernels": [kernel]}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
