#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Imports torch and ``torchsnapshot_tpu_torch`` only (no JAX, nothing of the
JAX package). Phases, in order; any failure exits non-zero and prints no
result line:

1. build   - compile every CUDA kernel of the path from ``csrc/`` (nvcc,
             sm_90a), all sources at once (flash_fwd, flash_bwd, digest);
             print each instance's ptxas registers, spills and shared
             memory, and K4's integer instructions from its SASS.
2. kernels - hold each kernel against its plain PyTorch version on the
             card: flash_fwd (o and lse), flash_bwd_dq (dq) and
             flash_bwd_dkv (dk, dv), causal and not, f32 and bf16, D=64
             and D=128, the serving shape and a sequence length that is
             not a multiple of the kernels' 64-row tile; the bf16 forward
             and the bf16 backward also at S = 1, 16, 100, 200, 256 and 512
             with 1 and 32 heads, and twice on the same inputs
             (bit-identical); and the raw backward split with global lse
             and delta over twice the keys, in f32 and in bf16.
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
6. train   - ``train_entry()`` at the same configuration takes 5 AdamW
             steps on one batch with ``attn_impl="auto"``; each flash
             kernel must launch 4 times a step; the loss is finite and
             falls; step 1's loss and gradients are held against
             ``attn_impl="dense"``.
7. train checkpoint - under ``torch.use_deterministic_algorithms``: take
             the train state after step 2 with RNGState, run step 3,
             restore into a state from another seed (bit-exact, step and
             count included), run step 3 again: bit-identical loss and
             state. Then async_take, an in-place step at once, restore: the
             values from before that step come back.
8. timing  - each kernel at the shape of the path (BH=32, S=256, D=64,
             bf16, causal) against its plain version and one library call,
             with its bound from the bytes and operations of this run's
             inputs: the device time of one call (``torch.profiler``: the
             device activities the calls launched, over their number) and
             the per-call time with the host included (CUDA events around
             back-to-back calls).
9. profile - steady-state serving latency and train-step time, each with
             flash and with dense attention, and the device time of one
             traced forward and one traced train step by kernel.
10. digest - (runs after phase 7) K4 (``csrc/digest.cu``, the device
             fingerprint) against its plain version on the card: every
             dtype of the train state plus bf16, f16, int64, f64, uint8,
             int8, bool and torch's float8 types, at 0, 1, 3 and 4,097
             elements and 16,777,216 bytes, aligned and not; the partial
             form on a 3-D piece cut into 4 regions; two launches
             bit-identical; device times of one 16 MiB leaf and of the 26
             state leaves dispatched before one fetch, against the plain
             version and the bound.
11. manager - (runs after phase 10) the production loop at the entry
             configuration: a CheckpointManager (cadence 2, keep_last 2,
             async, incremental, device digests, a preemption watcher) over
             train steps 0-4; a forced save of the unchanged state stages
             and writes nothing and launches K4 once a leaf; a simulated
             SIGTERM makes an emergency save at step 6; retention leaves
             steps 4, 5 and 6; the latest step restores bit-exact through
             its origins in step 4; a restore with device digests into a
             state that holds it reads and copies nothing; three
             async_takes of the unchanged state in turns (device digests,
             host digests, full): caller-blocked time, bytes staged and
             written; one more train step on the restored state is
             bit-identical.

Prints the kernels' JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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

# Bars of tests/test_pallas_attention.py: 1e-5 for f32, 3e-2 for bf16 (o;
# the bf16 kernel also rounds P to bf16 for its second product). For bf16
# inputs the scores are f32 sums of exact bf16 products, so the lse is held
# at 1e-4 (summation order, where the scale is applied, exp2 against exp).
O_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
LSE_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# bf16 logits, flash vs dense: the dense reference rounds its scores to
# bf16 before the softmax, the kernel keeps them in f32. At logits of
# |x| ~ 5 one bf16 step is 1/32, so the bar is four steps on the maximum
# and a tenth of a step on the mean.
LOGITS_MAX_ATOL = 0.125
LOGITS_MEAN_ATOL = 0.01
# f32 dq, dk, dv against the plain version: 1e-4 absolute, the bar of
# tests/test_pallas_attention.py (the f32 kernels do the plain version's
# f32 arithmetic in another summation order).
F32_GRAD_ATOL = 1e-4
# The bf16 backward kernels run on the tensor cores and round P and dS to
# bf16 to be the A operands of their last products (dV = P^T dO,
# dK = scale dS^T Q, dQ = scale dS K); the plain version keeps them in f32.
# _flash_bwd_emul is the plain version with that rounding. Each bf16
# gradient may differ from the plain one by at most twice what the rounding
# alone moves it (the kernel also sums in another order and rounds its own
# f32 results to bf16), plus 1e-5 for entries near zero; the bf16 gradient
# bar of tests/test_pallas_attention.py, 0.1, stays a ceiling on top.
BF16_GRAD_SLACK = 1e-5
BF16_GRAD_CEILING = 0.1
# Train step 1, flash vs dense in bf16. Every matmul and norm output rounds
# to bf16 (a relative step of 2^-8 = 0.0039) and the dense reference also
# rounds its scores to bf16 before the softmax, the kernels do not. Over 4
# layers forward and back that compounds to several steps: each gradient
# leaf is held to a relative L2 error of 5e-2 (about 13 steps), and the
# f32 loss to 1/32, one bf16 step of the logits at |x| ~ 5.
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_LOSS_ATOL = 1 / 32
TRAIN_STEPS = 5

DEVICE = "cuda"
STATE_F32_TENSORS, F32_TENSOR_BYTES = 19, 100 << 20
STATE_BF16_TENSORS, BF16_TENSOR_BYTES = 2, 50 << 20
N_REQUESTS = 3
# K4 (csrc/digest.cu) does integer work, not memory work: about 72 SASS
# instructions a 4-byte word (phase 1 counts them in this run's build), most
# of them shifts, XORs and multiplies. Its bound is those instructions at the
# most an H100 SXM dispatches: 132 SMs x 4 schedulers x 32 lanes a clock,
# which takes both integer pipes (ALU for shifts and logic, FMA for IMAD)
# busy at once; the clock is the card's maximum SM clock, from nvidia-smi.
DISPATCH_LANES_PER_CLOCK = 132 * 4 * 32
# The dtypes K4 is held on: the train state's (f32, int32) and every word
# stream the kernel has (2-byte, 8-byte, 1-byte, bool, the float8 types).
DIGEST_DTYPES = ("float32", "int32", "bfloat16", "float16", "int64", "float64", "uint8",
                 "int8", "bool", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                 "float8_e5m2fnuz", "float8_e8m0fnu")
DIGEST_SIZES = (0, 1, 3, 4097)  # elements; and a 16,777,216-byte tensor
DIGEST_LEAF_BYTES = 16 << 20
MANAGER_TAKE_ROUNDS = 3


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


def _device_events(prof) -> list:
    """(name, device us, count) of every device activity (kernels, memsets,
    copies) that a ``torch.profiler`` session recorded."""
    from torch.autograd import DeviceType

    return [
        (e.key, getattr(e, "self_device_time_total", 0.0), e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]


def device_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the time of every device activity
    that ``iters`` calls launched, as ``torch.profiler`` records it, over
    ``iters``. Host time is not in it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(t for _, t, _ in _device_events(prof))
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / iters / 1e3


def time_in_turns(fns, iters: int, rounds: int = 5, timer=cuda_time_ms):
    """Median ms per call of each function by ``timer``, timed in
    alternating turns (a b c, c b a, ...) so clock drift favours none of
    them; also returns each function's (min, max) over the rounds."""
    samples = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(reversed(list(fns)))
        for name in order:
            samples[name].append(timer(fns[name], iters=iters))
    medians = {name: statistics.median(v) for name, v in samples.items()}
    spreads = {name: (min(v), max(v)) for name, v in samples.items()}
    return medians, spreads


# Dynamic shared memory of the wgmma kernels by head dim: 64-row bf16
# tiles (5 in the forward, 6 in each backward kernel) and 1024 bytes of
# slack to align them; ptxas reports only the static part.
def _wgmma_dynamic_smem(n_tiles: int, D: int) -> int:
    return n_tiles * 64 * D * 2 + 1024


def _demangle(name: str) -> str:
    filt = shutil.which("c++filt")
    if filt is None:
        return name
    out = subprocess.run([filt, name], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or name


def phase_build() -> float:
    """Build every source; print each kernel instance's ptxas registers,
    spills and static shared memory, and the wgmma kernels' dynamic.
    Returns K4's SASS instructions per word."""
    from torchsnapshot_tpu_torch.ops import _build

    sources = ["flash_fwd", "flash_bwd", "digest"]
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"[build] {', '.join(sources)} built together in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line:
                mangled = line.split("'")[1] if "'" in line else line
                log(f"[build] {name}: {_demangle(mangled).replace('(anonymous namespace)::', '')}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}:   {line.strip()}")
    for kernel, n_tiles in (("flash_fwd_wgmma_kernel", 5), ("flash_bwd_dq_wgmma_kernel", 6),
                            ("flash_bwd_dkv_wgmma_kernel", 6)):
        log(f"[build] {kernel}: dynamic shared memory " + ", ".join(
            f"{_wgmma_dynamic_smem(n_tiles, D)} B at D={D}" for D in (64, 128)))
    return _digest_sass()


def _digest_sass() -> float:
    """K4's instructions per 4-byte word, from the SASS of its f32 kernel:
    the 16-byte loop body (from the backward branch's target to the branch)
    over the 4 words it consumes. Prints the body's opcodes by count."""
    from torchsnapshot_tpu_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", _build._target("digest")], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    func = next(f for f in re.split(r"Function : ", out)[1:]
                if f.split(None, 1)[0].endswith("digest_full_kernelILi4EEEvPKhyyPj"))
    code = [(int(a, 16), ins.strip()) for a, ins in re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", func)]
    load = next(i for i, (_, ins) in enumerate(code) if "LDG.E.128" in ins)
    branch, target = next((i, int(m.group(1), 16)) for i, (a, ins) in enumerate(code)
                          if i > load and (m := re.search(r"BRA 0x([0-9a-f]+)", ins))
                          and int(m.group(1), 16) <= code[load][0])
    body = [ins for a, ins in code[: branch + 1] if a >= target]
    counts = {}
    for ins in body:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    per_word = len(body) / 4
    log(f"[build] digest_full_kernel<4> 16-byte loop: {len(body)} SASS instructions for 4 words, "
        f"{per_word:.2f} a word ("
        + ", ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1])) + ")")
    return per_word


def _qkv(shape, dtype, seed, n=3):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=DEVICE).to(dtype) for _ in range(n))


def _max_err(got, want) -> float:
    return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))


def _flash_bwd_emul(q, k, v, dO, lse, delta, *, causal=True, scale=None):
    """A plain recompute of ``(dq, dk, dv)`` that rounds P and dS to bf16
    before the three products that take them, as the bf16 tensor-core
    kernels do (tests/test_torch_kernels_cuda.py::flash_bwd_emul)."""
    if scale is None:
        scale = q.shape[2] ** -0.5
    s = scale * torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dO.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = scale * torch.matmul(ds, k.float())
    dk = scale * torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), dO.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bf16_grad_errors(got, plain, emul) -> list:
    """For each gradient: (max|got - plain|, its bar), the bar being
    ``2 * max|emul - plain| + BF16_GRAD_SLACK`` capped at the ceiling."""
    out = []
    for g, p, e in zip(got, plain, emul):
        rounding = (e.float() - p.float()).abs().max().item()
        bar = min(2 * rounding + BF16_GRAD_SLACK, BF16_GRAD_CEILING)
        out.append((_max_err([g], [p]), bar))
    return out


def _grads_close(got, plain, emul, dtype) -> bool:
    """f32: every gradient within F32_GRAD_ATOL of the plain one; bf16:
    within the bar that ``emul`` (the rounding recompute) sets."""
    if dtype == torch.float32:
        return _max_err(got, plain) <= F32_GRAD_ATOL
    return all(err <= bar for err, bar in _bf16_grad_errors(got, plain, emul))


def phase_kernels() -> dict:
    """Every kernel against its plain version on the card; returns the
    worst error of each."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    shapes = [(32, 256, 64), (16, 256, 128), (8, 200, 64)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v, dO = _qkv(shape, dtype, seed=len(shape) + shape[1], n=4)
                o, lse = fa.flash_fwd_cuda(q, k, v, causal=causal)
                o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
                # The backward from the reference's statistics, as autograd
                # hands them over (delta in f32).
                delta = (dO.float() * o_ref.float()).sum(-1)
                dq = fa.flash_bwd_dq(q, k, v, dO, lse_ref, delta, causal=causal)
                dk, dv = fa.flash_bwd_dkv(q, k, v, dO, lse_ref, delta, causal=causal)
                plain = fa.flash_bwd_reference(q, k, v, dO, lse_ref, delta, causal=causal)
                emul = _flash_bwd_emul(q, k, v, dO, lse_ref, delta, causal=causal)
                torch.cuda.synchronize()
                err_o = _max_err([o], [o_ref])
                err_l = (lse - lse_ref).abs().max().item()
                err_dq = _max_err([dq], plain[:1])
                err_dkv = _max_err([dk, dv], plain[1:])
                ok = (err_o <= O_ATOL[dtype] and err_l <= LSE_ATOL[dtype]
                      and _grads_close([dq, dk, dv], plain, emul, dtype))
                log(
                    f"[kernels] BH,S,D={shape} {str(dtype)[6:]} causal={causal}: "
                    f"flash_fwd max|o-ref|={err_o:.3g} max|lse-ref|={err_l:.3g}; "
                    f"flash_bwd_dq max|dq-ref|={err_dq:.3g}; "
                    f"flash_bwd_dkv max|dk,dv-ref|={err_dkv:.3g} {'ok' if ok else 'FAIL'}"
                )
                if not ok:
                    raise AssertionError(f"a kernel disagrees with its plain version at {shape}")
                worst["flash_fwd"] = max(worst["flash_fwd"], err_o, err_l)
                worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err_dq)
                worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err_dkv)

    worst["flash_fwd"] = max(worst["flash_fwd"], _fwd_bf16_sweep())
    err_dq, err_dkv = _bwd_bf16_sweep()
    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err_dq)
    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err_dkv)
    for dtype in (torch.float32, torch.bfloat16):
        err_dq, err_dkv = _raw_split(dtype)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err_dq)
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err_dkv)
    return worst


def _combine(halves):
    """dq summed over the two halves (in f32), dk and dv concatenated."""
    return (
        halves[0][0].float() + halves[1][0].float(),
        torch.cat([halves[0][1], halves[1][1]], 1),
        torch.cat([halves[0][2], halves[1][2]], 1),
    )


def _raw_split(dtype):
    """The raw split, as a ring hop drives it: q against two halves of twice
    the keys, each half given the GLOBAL lse and delta over all of them. dq
    sums over the halves; each half's dk, dv are slices of the whole. f32
    is held to F32_GRAD_ATOL; bf16 to the bar of the same split through
    ``_flash_bwd_emul``. Returns the worst dq and dk/dv errors."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    BH, S, D = 32, 256, 64
    q, dO = _qkv((BH, S, D), dtype, seed=11, n=2)
    k, v = _qkv((BH, 2 * S, D), dtype, seed=12, n=2)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=False)
    delta = (dO.float() * o.float()).sum(-1)
    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=False)
    parts = [(k[:, h].contiguous(), v[:, h].contiguous()) for h in (slice(0, S), slice(S, 2 * S))]
    got = _combine([fa.flash_bwd_cuda(q, kh, vh, dO, lse, delta, causal=False) for kh, vh in parts])
    emul = _combine([_flash_bwd_emul(q, kh, vh, dO, lse, delta, causal=False) for kh, vh in parts])
    torch.cuda.synchronize()
    err_dq = _max_err(got[:1], plain[:1])
    err_dkv = _max_err(got[1:], plain[1:])
    ok = _grads_close(got, plain, emul, dtype)
    log(f"[kernels] raw split, q (BH={BH}, S={S}, D={D}) {str(dtype)[6:]} against 2 x {S} keys "
        f"with global lse and delta: max|sum dq-ref|={err_dq:.3g} max|dk,dv-ref|={err_dkv:.3g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {dtype} raw backward split disagrees with the whole")
    return err_dq, err_dkv


def _bwd_bf16_sweep():
    """The bf16 backward kernels against their plain version, under the bar
    of ``_flash_bwd_emul``, over the sequence lengths their 64-row tiles
    must handle, both head dims, both masks and one or 32 heads; then two
    launches on the same inputs must be bit-identical. Returns the worst
    dq and dk/dv errors."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    dtype, worst_dq, worst_dkv = torch.bfloat16, 0.0, 0.0
    for S in (1, 16, 100, 200, 256, 512):
        for D in (64, 128):
            errs = []
            for causal in (True, False):
                for BH in (1, 32):
                    q, k, v, dO = _qkv((BH, S, D), dtype, seed=S + D + BH, n=4)
                    o, lse = fa.flash_fwd_reference(q, k, v, causal=causal)
                    delta = (dO.float() * o.float()).sum(-1)
                    got = fa.flash_bwd_cuda(q, k, v, dO, lse, delta, causal=causal)
                    plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta, causal=causal)
                    emul = _flash_bwd_emul(q, k, v, dO, lse, delta, causal=causal)
                    torch.cuda.synchronize()
                    case = _bf16_grad_errors(got, plain, emul)
                    if not all(err <= bar for err, bar in case):
                        raise AssertionError(
                            f"flash_bwd bf16 disagrees with its plain version at BH={BH}, S={S}, "
                            f"D={D}, causal={causal}: (max|kernel-plain|, bar) of dq, dk, dv "
                            + ", ".join(f"({e:.3g}, {b:.3g})" for e, b in case)
                        )
                    errs.append(case)
            worst_dq = max(worst_dq, *(c[0][0] for c in errs))
            worst_dkv = max(worst_dkv, *(max(c[1][0], c[2][0]) for c in errs))
            log(f"[kernels] flash_bwd bf16 S={S} D={D}, causal and not, BH 1 and 32: "
                + ", ".join(
                    f"{name} max|err|={max(c[i][0] for c in errs):.3g} "
                    f"(worst err/bar {max(c[i][0] / c[i][1] for c in errs):.2f})"
                    for i, name in enumerate(("dq", "dk", "dv"))
                ) + " ok")
    q, k, v, dO = _qkv((32, 256, 64), dtype, seed=10, n=4)
    o, lse = fa.flash_fwd_cuda(q, k, v)
    delta = (dO.float() * o.float()).sum(-1)
    first = fa.flash_bwd_cuda(q, k, v, dO, lse, delta)
    second = fa.flash_bwd_cuda(q, k, v, dO, lse, delta)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two launches of flash_bwd bf16 on the same inputs differ")
    log("[kernels] flash_bwd bf16: two launches on the same inputs are bit-identical")
    return worst_dq, worst_dkv


def _fwd_bf16_sweep() -> float:
    """The bf16 forward kernel against its plain version over the sequence
    lengths its 64-row tiles must handle (one row, part of a tile, ragged,
    whole tiles), both head dims, both masks and one or 32 heads; then two
    launches on the same inputs must be bit-identical. Returns the worst
    error."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    dtype, worst = torch.bfloat16, 0.0
    for S in (1, 16, 100, 200, 256, 512):
        for D in (64, 128):
            errs = []
            for causal in (True, False):
                for BH in (1, 32):
                    q, k, v = _qkv((BH, S, D), dtype, seed=S + D + BH)
                    o, lse = fa.flash_fwd_cuda(q, k, v, causal=causal)
                    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    err_o = _max_err([o], [o_ref])
                    err_l = (lse - lse_ref).abs().max().item()
                    if not (err_o <= O_ATOL[dtype] and err_l <= LSE_ATOL[dtype]):
                        raise AssertionError(
                            f"flash_fwd bf16 disagrees with its plain version at BH={BH}, S={S}, "
                            f"D={D}, causal={causal}: max|o-ref|={err_o:.3g} max|lse-ref|={err_l:.3g}"
                        )
                    errs.append((err_o, err_l))
            worst = max(worst, *(max(e) for e in errs))
            log(f"[kernels] flash_fwd bf16 S={S} D={D}, causal and not, BH 1 and 32: "
                f"max|o-ref|={max(e[0] for e in errs):.3g} "
                f"max|lse-ref|={max(e[1] for e in errs):.3g} ok")
    q, k, v = _qkv((32, 256, 64), dtype, seed=9)
    first, second = fa.flash_fwd_cuda(q, k, v), fa.flash_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two launches of flash_fwd bf16 on the same inputs differ")
    log("[kernels] flash_fwd bf16: two launches on the same inputs are bit-identical")
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


def _flat(state) -> dict:
    """{logical path: tensor} of a train state, as a snapshot names it."""
    from torchsnapshot_tpu_torch.flatten import flatten

    return flatten(state)[1]


def _launch_counts() -> dict:
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    return {f.__name__: f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}


def _reset_launch_counts() -> None:
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def phase_train(cfg) -> dict:
    """TRAIN_STEPS steps of ``train_entry()``; returns each kernel's
    launches over them."""
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.models import transformer as T

    train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
    # Step 1's loss and gradients, flash (auto) against dense attention.
    loss_f, grads_f = T.loss_and_grads(state["params"], batch, cfg)
    loss_d, grads_d = T.loss_and_grads(
        state["params"], batch, dataclasses.replace(cfg, attn_impl="dense")
    )
    dl = abs(loss_f.item() - loss_d.item())
    refs = _flat(grads_d)
    rel = {p: ((g - refs[p]).norm() / refs[p].norm()).item() for p, g in _flat(grads_f).items()}
    worst_path = max(rel, key=lambda p: rel[p] if math.isfinite(rel[p]) else math.inf)
    worst = rel[worst_path]
    log(f"[train] step 1 flash vs dense: loss {loss_f.item():.6f} vs {loss_d.item():.6f} "
        f"(|diff| {dl:.3g}, bar {TRAIN_LOSS_ATOL:.4g}); worst gradient rel L2 {worst:.3g} "
        f"at {worst_path} (bar {TRAIN_GRAD_REL_L2})")
    if not (dl <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_REL_L2):
        raise AssertionError("flash and dense attention disagree on step 1's loss or gradients")

    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, batch)[1] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    losses = [x.item() for x in losses]
    with torch.no_grad():
        final = T.loss_fn(state["params"], batch, cfg).item()
    log(f"[train] {TRAIN_STEPS} steps of (4, 256) tokens in {wall * 1e3:.1f} ms; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; after step {TRAIN_STEPS}: {final:.4f}; "
        f"launches {launches}")
    want = TRAIN_STEPS * cfg.n_layers
    if any(n != want for n in launches.values()):
        raise AssertionError(f"expected {want} launches of each flash kernel, got {launches}")
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError("the training loss is not finite or did not fall")
    if int(state["step"]) != TRAIN_STEPS or int(state["opt_state"][0].count) != TRAIN_STEPS:
        raise AssertionError("step or optimizer count did not advance once per step")
    return launches


def phase_train_checkpoint(root: str) -> None:
    """A resume from a train-state snapshot is bit-identical; async_take
    holds the values from before an in-place step that follows at once."""
    from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict
    from torchsnapshot_tpu_torch.entry import train_entry
    from torchsnapshot_tpu_torch.models import transformer as T

    def clone(state) -> dict:
        return {p: t.clone() for p, t in _flat(state).items()}

    def same(state, want: dict) -> bool:
        got = _flat(state)
        return got.keys() == want.keys() and all(torch.equal(got[p], want[p]) for p in want)

    torch.use_deterministic_algorithms(True)
    try:
        train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
        for _ in range(2):
            train_step(state, batch)
        Snapshot.take(f"{root}/train", {"train": StateDict(state), "rng": RNGState()})
        saved = clone(state)
        _, loss3 = train_step(state, batch)
        after3 = clone(state)

        _, (fresh, _) = train_entry(device=DEVICE, seed=1)
        holder = StateDict(fresh)
        Snapshot(f"{root}/train").restore({"train": holder, "rng": RNGState()})
        restored = dict(holder)
        if not same(restored, saved):
            raise AssertionError("the restored train state is not bit-exact")
        if not isinstance(restored["opt_state"][0], T.ScaleByAdamState):
            raise AssertionError("the restored optimizer state lost its namedtuple class")
        if int(restored["step"]) != 2 or int(restored["opt_state"][0].count) != 2:
            raise AssertionError("restored step or count is not 2")
        _, loss3_again = train_step(restored, batch)
        if not torch.equal(loss3_again, loss3) or not same(restored, after3):
            raise AssertionError("step 3 after the restore is not bit-identical to step 3")
        log(f"[train checkpoint] take after step 2, restore into seed 1's state: "
            f"{len(saved)} leaves bit-exact (step 2, count 2); step 3 again: loss "
            f"{loss3.item():.6f} and every leaf bit-identical")

        before = clone(state)
        pending = Snapshot.async_take(f"{root}/train_async", {"train": StateDict(state)})
        train_step(state, batch)  # in place, as soon as async_take returns
        pending.wait()
        if same(state, before):
            raise AssertionError("the step after async_take changed nothing")
        _, (fresh, _) = train_entry(device=DEVICE, seed=1)
        holder = StateDict(fresh)
        Snapshot(f"{root}/train_async").restore({"train": holder})
        if not same(dict(holder), before):
            raise AssertionError("async_take captured a value written by the step after it")
        log("[train checkpoint] async_take, an in-place step at once, restore: the "
            "values from before that step are back")
    finally:
        torch.use_deterministic_algorithms(False)


def _bound(nbytes: int, flops: int):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_timing(launches: dict, max_err: dict, card: str) -> list:
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    B, H, S, D = 4, 8, 256, 64
    q, k, v, dO = _qkv((B * H, S, D), torch.bfloat16, seed=3, n=4)
    q4, k4, v4, dO4 = (t.reshape(B, H, S, D) for t in (q, k, v, dO))
    o, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
    delta = (dO.float() * o.float()).sum(-1)
    bwd_args = (q, k, v, dO, lse, delta)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, causal=True),
        "flash_fwd_plain": lambda: fa.flash_fwd_reference(q, k, v, causal=True),
        "flash_fwd_library": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd_args, causal=True),
        "flash_bwd_dq_plain": lambda: fa.flash_bwd_dq_reference(*bwd_args, causal=True),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd_args, causal=True),
        "flash_bwd_dkv_plain": lambda: fa.flash_bwd_dkv_reference(*bwd_args, causal=True),
        # SDPA's backward alone, dq, dk and dv in one call: the library
        # yardstick of both backward kernels.
        "flash_bwd_library": lambda: torch.autograd.grad(
            o_sdpa, (qg, kg, vg), dO4, retain_graph=True
        ),
    }
    # Per-call time with the host included (CUDA events around 100 calls
    # back to back: a call whose host path outlasts its kernel reads as
    # host time), and the device time of one call from the profiler.
    ms, spread = time_in_turns(calls, iters=100)
    dev, dev_spread = time_in_turns(calls, iters=20, rounds=3, timer=device_time_ms)
    # Least work: each input read once, each output written once; the
    # causal dots over the S(S+1)/2 attended pairs of each head, 2*D flop
    # per pair each: 2 (q.k, p.v) forward, 3 (q.k, dO.v, ds.k) for dq and
    # 4 (q.k, dO.v, p.dO, ds.q) for dk/dv.
    elt = q.element_size()
    operand = B * H * S * D * elt
    row = B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2)
    work = {
        "flash_fwd": (4 * operand + row, 2 * 2 * D * pairs),
        "flash_bwd_dq": (5 * operand + 2 * row, 3 * 2 * D * pairs),
        "flash_bwd_dkv": (6 * operand + 2 * row, 4 * 2 * D * pairs),
    }
    library = {"flash_fwd": "flash_fwd_library", "flash_bwd_dq": "flash_bwd_library",
               "flash_bwd_dkv": "flash_bwd_library"}
    sources = {"flash_fwd": ("flash_fwd.cu", 44), "flash_bwd_dq": ("flash_bwd.cu", 94),
               "flash_bwd_dkv": ("flash_bwd.cu", 146)}
    out = []
    for name, (nbytes, flops) in work.items():
        bound_ms, bound_by = _bound(nbytes, flops)
        lib = library[name]

        def us(key, t=ms, r=spread):
            return f"{t[key] * 1e3:.2f} us ({r[key][0] * 1e3:.2f}-{r[key][1] * 1e3:.2f})"

        def dus(key):
            return us(key, dev, dev_spread)

        log(f"[timing] {name} (BH={B * H}, S={S}, D={D}, bf16, causal), bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B, {flops} flop); device time "
            f"of one call, median of 3 profiled rounds x 20 (range): kernel {dus(name)}, "
            f"plain {dus(name + '_plain')}, library {dus(lib)}; per-call time with the host, "
            f"median of 5 rounds x 100 (range): kernel {us(name)}, plain "
            f"{us(name + '_plain')}, library {us(lib)}; on {card}")
        src, line = sources[name]
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"torchsnapshot_tpu_torch/csrc/{src}",
            "replaces": f"torchsnapshot_tpu/ops/pallas_attention.py:{line}",
            "launches": sum(counts[name] for counts in launches.values()),
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
            "max_abs_err": max_err[name],
            "ms": ms[name],
            "plain_ms": ms[name + "_plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": ms[lib],
            "device_ms": dev[name],
            "plain_device_ms": dev[name + "_plain"],
            "library_device_ms": dev[lib],
        })
        if lib == "flash_bwd_library":
            # One SDPA backward does the work of both backward kernels:
            # compare library_ms with the sum of their ms.
            out[-1]["library_covers"] = ["flash_bwd_dq", "flash_bwd_dkv"]
    return out


def _trace(label: str, fn) -> None:
    """Wall time, device busy time and idle share of one traced call of
    ``fn``, and its largest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_events(prof)
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us <= 0:
        log(f"[profile] traced {label}: device time not measured (the profiler recorded none)")
        return
    log(f"[profile] traced {label}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us, "
        f"idle share {1 - busy_us / wall_us:.3f}, {sum(c for _, _, c in kernels)} kernels")
    for name, t, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"[profile]   {t:9.1f} us  x{count:<3d} {name[:90]}")
    for name, t, count in kernels:
        kernel = re.search(r"flash_(fwd|bwd)_\w*kernel", name)
        if kernel:
            log(f"[profile]   the port's {kernel.group(0)}: {t:.1f} us over {count} launches, "
                f"{t / busy_us:.3f} of device busy time")


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _digest_input(name: str, numel: int, gen) -> torch.Tensor:
    dtype = getattr(torch, name)
    raw = torch.randint(0, 256, (numel * dtype.itemsize,), generator=gen, device=DEVICE,
                        dtype=torch.uint8)
    return (raw[:numel] % 2).bool() if dtype == torch.bool else raw.view(dtype)


def phase_digest(instructions_per_word: float, clock_mhz: float, card: str):
    """K4 against its plain version on the card, and its times. Returns the
    worst lane difference and the kernels-line numbers."""
    from torchsnapshot_tpu_torch import device_digest as dd
    from torchsnapshot_tpu_torch.entry import train_entry

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    worst, cases = 0, 0
    names = [n for n in DIGEST_DTYPES if hasattr(torch, n)]
    for name in names:
        itemsize = getattr(torch, name).itemsize
        for numel in DIGEST_SIZES + (DIGEST_LEAF_BYTES // itemsize,):
            t = _digest_input(name, numel, gen)
            views = [t, t[1:]] if numel > 1 else [t]  # t[1:]: an unaligned start
            for v in views:
                kernel = dd._fetch([dd.fingerprint_lanes(v)])[0]
                plain = dd.lanes_reference(v)
                worst = max(worst, *(abs(a - b) for a, b in zip(kernel, plain)))
                nbytes = v.numel() * v.element_size()
                if dd._fold_lanes(kernel, nbytes) != dd._fold_lanes(plain, nbytes):
                    raise AssertionError(
                        f"K4 disagrees with its plain version: {name} x {v.numel()} "
                        f"(kernel lanes {kernel}, plain {plain})")
                cases += 1
    log(f"[digest] K4 vs plain, {len(names)} dtypes ({', '.join(names)}) x {DIGEST_SIZES} "
        f"elements and {DIGEST_LEAF_BYTES} B, aligned and unaligned: {cases} cases, digest "
        f"strings identical (max lane difference {worst})")
    for name in ("float32", "bfloat16", "int64", "bool"):
        piece = _digest_input(name, 24 * 40 * 33, gen).reshape(24, 40, 33)
        full = dd.device_fingerprint(piece)
        groups = []
        for r0, r1 in ((0, 9), (9, 24)):
            for c0, c1 in ((0, 17), (17, 40)):
                region = piece[r0:r1, c0:c1]
                lanes = dd.partial_fetch(dd.partial_dispatch(region, piece.shape, (r0, c0, 0)))
                if lanes != dd.lanes_reference(region.contiguous(), (r0, c0, 0), piece.shape):
                    raise AssertionError(f"K4's partial lanes disagree with the plain version ({name})")
                groups.append(lanes)
        if dd.combine_partials(groups, piece.numel() * piece.element_size()) != full:
            raise AssertionError(f"K4's partial lanes over 4 regions do not add up ({name})")
    log("[digest] partial form: a (24, 40, 33) piece cut into 4 regions, f32, bf16, int64 "
        "and bool: each region's lanes equal the plain version's, their wrapping sum is "
        "the full fingerprint")
    leaf = _digest_input("float32", DIGEST_LEAF_BYTES // 4, gen)
    first, second = dd.fingerprint_lanes(leaf), dd.fingerprint_lanes(leaf)
    _sync()
    if not torch.equal(first, second):
        raise AssertionError("two launches of K4 on the same 16 MiB give different lanes")
    log("[digest] two launches on the same 16 MiB leaf: bit-identical lanes")

    _, (state, _) = train_entry(device=DEVICE, seed=0)
    leaves = list(_flat(state).values())
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    calls = {
        "digest": lambda: dd.fingerprint_lanes(leaf),
        "digest_plain": lambda: dd.lanes_reference(leaf),
        "digest_state": lambda: dd._fetch([dd._dispatch(t) for t in leaves]),
    }
    ms, spread = time_in_turns(calls, iters=20)
    dev, dev_spread = time_in_turns(calls, iters=10, rounds=3, timer=device_time_ms)
    int_ops_per_s = DISPATCH_LANES_PER_CLOCK * clock_mhz * 1e6

    def bound(nbytes: int):
        words = nbytes // 4  # every leaf here is 4-byte: one word an element
        ops_ms = words * instructions_per_word / int_ops_per_s * 1e3
        bytes_ms = (nbytes + 16) / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", words

    leaf_bound, leaf_by, leaf_words = bound(DIGEST_LEAF_BYTES)
    state_bound, state_by, state_words = bound(state_bytes)

    def us(key, t, r):
        return f"{t[key] * 1e3:.2f} us ({r[key][0] * 1e3:.2f}-{r[key][1] * 1e3:.2f})"

    log(f"[digest] one 16,777,216-byte f32 leaf: bound {leaf_bound * 1e3:.3f} us by {leaf_by} "
        f"({leaf_words} words x {instructions_per_word:.2f} instructions at "
        f"{int_ops_per_s / 1e12:.2f} T/s, {clock_mhz:.0f} MHz; bytes alone "
        f"{(DIGEST_LEAF_BYTES + 16) / HBM_BYTES_PER_S * 1e6:.3f} us); device time of one call, "
        f"median of 3 profiled rounds x 10 (range): K4 {us('digest', dev, dev_spread)}, plain "
        f"{us('digest_plain', dev, dev_spread)}; per-call time with the host, median of 5 "
        f"rounds x 20: K4 {us('digest', ms, spread)}, plain {us('digest_plain', ms, spread)}; "
        f"on {card}")
    log(f"[digest] the train state, {len(leaves)} leaves, {state_bytes} B, dispatched then one "
        f"fetch: bound {state_bound * 1e3:.3f} us by {state_by}; device time "
        f"{us('digest_state', dev, dev_spread)}, with the host {us('digest_state', ms, spread)} "
        f"on {card}")
    return worst, {
        "ms": ms["digest"], "plain_ms": ms["digest_plain"], "bound_ms": leaf_bound,
        "bound_by": leaf_by, "device_ms": dev["digest"], "plain_device_ms": dev["digest_plain"],
        "state_ms": ms["digest_state"], "state_device_ms": dev["digest_state"],
        "state_bound_ms": state_bound,
    }


class _CheckpointSpies:
    """Counts what the checkpoint path does to the card and the disk: the
    tensors and bytes the CUDA staging copy stages, the host-to-device copies
    of restores, the payload bytes written and the payload reads (with the
    snapshot directory each read went to). Patches the port's classes while
    active; the counts are read and reset by the caller."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.staged = self.staged_bytes = self.copied_in = self.written_bytes = 0
        self.reads = []

    def __enter__(self):
        from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferConsumer, ArrayBufferStager
        from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

        spies = self
        stage_name = "_stage_cuda" if DEVICE == "cuda" else "_stage_cpu"
        stage = getattr(ArrayBufferStager, stage_name)
        copy_in, write, read = (ArrayBufferConsumer._copy_to_cuda, FSStoragePlugin.write,
                                FSStoragePlugin.read)

        async def stage_cuda(self, executor):
            host = await stage(self, executor)
            spies.staged += 1
            spies.staged_bytes += host.numel()
            return host

        def stage_cpu(self):
            host = stage(self)
            spies.staged += 1
            spies.staged_bytes += host.numel()
            return host

        async def copy_to_cuda(self, src, executor):
            spies.copied_in += 1
            return await copy_in(self, src, executor)

        async def fs_write(self, write_io):
            if write_io.path != ".snapshot_metadata":
                spies.written_bytes += memoryview(write_io.buf).nbytes
            return await write(self, write_io)

        async def fs_read(self, read_io):
            if read_io.path != ".snapshot_metadata":
                spies.reads.append((os.path.realpath(self.root), read_io.path))
            return await read(self, read_io)

        self._saved = [(ArrayBufferStager, stage_name, stage),
                       (ArrayBufferConsumer, "_copy_to_cuda", copy_in),
                       (FSStoragePlugin, "write", write), (FSStoragePlugin, "read", read)]
        setattr(ArrayBufferStager, stage_name, stage_cuda if DEVICE == "cuda" else stage_cpu)
        ArrayBufferConsumer._copy_to_cuda = copy_to_cuda
        FSStoragePlugin.write, FSStoragePlugin.read = fs_write, fs_read
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _digest_launches() -> int:
    from torchsnapshot_tpu_torch import device_digest as dd

    return dd.fingerprint_lanes.launches


def _origins(path: str) -> set:
    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.retention import _entry_payloads

    return {o for e in Snapshot(path).metadata.manifest.values() for *_, o in _entry_payloads(e)}


def phase_manager(root: str, card: str) -> dict:
    """The production loop at the entry configuration: a CheckpointManager
    with cadence 2, keep_last 2, async, incremental saves with device
    digests and a preemption watcher drives train steps 0-4; an unchanged
    forced save stages and writes nothing; a simulated preemption makes an
    emergency save; retention leaves steps 4-6; the latest step restores
    bit-exact through its origins and trains on; a restore into a state that
    already holds it reads and copies nothing. Returns K4's launches by
    step of the path."""
    from torchsnapshot_tpu_torch import (CheckpointManager, PreemptionWatcher, Snapshot, StateDict,
                                         simulate_preemption_now)
    from torchsnapshot_tpu_torch.entry import train_entry

    on_card = DEVICE == "cuda"
    torch.use_deterministic_algorithms(True)
    watcher = PreemptionWatcher()
    try:
        train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
        n_leaves = len(_flat(state))
        state_bytes = sum(t.numel() * t.element_size() for t in _flat(state).values())
        app = {"train": StateDict(state)}
        mgr = CheckpointManager(root, save_interval_steps=2, keep_last=2, async_save=True,
                                incremental=True, device_digests=True, preemption=watcher)
        mgr.warmup(app)  # builds K4 and launches it once per leaf, outside the count
        _sync()
        launches = {}
        with _CheckpointSpies() as spies:
            n0 = _digest_launches()
            t0 = time.perf_counter()
            for step in range(5):
                train_step(state, batch)
                mgr.save(step, app)
            mgr.wait()
            launches["steps 0-4 (saves at 0, 2, 4)"] = _digest_launches() - n0
            log(f"[manager] train steps 0-4, saves at 0, 2, 4 ({n_leaves} leaves, {state_bytes} B): "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms; committed {mgr.all_steps()}; staged "
                f"{spies.staged} tensors ({spies.staged_bytes} B), wrote {spies.written_bytes} B")

            spies.reset()
            n0 = _digest_launches()
            t0 = time.perf_counter()
            mgr.save(5, app, force=True)  # the state is unchanged since step 4's save
            blocked = time.perf_counter() - t0
            mgr.wait()
            launches["unchanged save (step 5)"] = n = _digest_launches() - n0
            step4 = os.path.realpath(mgr.path_for(4))
            log(f"[manager] forced save of the unchanged state at step 5: caller blocked "
                f"{blocked * 1e3:.1f} ms; staged {spies.staged} tensors ({spies.staged_bytes} B), "
                f"wrote {spies.written_bytes} B, K4 launches {n}; origins {sorted(_origins(mgr.path_for(5)))}")
            if spies.staged or spies.staged_bytes or spies.written_bytes:
                raise AssertionError("the save of an unchanged state staged or wrote payload")
            if _origins(mgr.path_for(5)) != {step4}:
                raise AssertionError("step 5's entries do not all point at step 4")
            if on_card and n != n_leaves:
                raise AssertionError(f"expected {n_leaves} K4 launches for the unchanged save, got {n}")

            spies.reset()
            n0 = _digest_launches()
            simulate_preemption_now()
            if not mgr.save(6, app) or not watcher.consumed or mgr._pending is not None:
                raise AssertionError("the emergency save at step 6 did not commit synchronously")
            launches["emergency save (step 6)"] = _digest_launches() - n0
            names = sorted(os.listdir(root))
            want = ["step_0000000004", "step_0000000005", "step_0000000006"]
            log(f"[manager] SIGTERM, then save(6): emergency save committed synchronously "
                f"(staged {spies.staged} tensors); retention with keep_last=2 leaves {names}")
            if names != want or mgr.latest_step() != 6:
                raise AssertionError(f"retention left {names}, expected {want}")

            spies.reset()
            saved = {p: t.clone() for p, t in _flat(state).items()}
            _, (fresh, _) = train_entry(device=DEVICE, seed=1)
            holder = StateDict(fresh)
            n0 = _digest_launches()
            if mgr.restore({"train": holder}) != 6:
                raise AssertionError("the manager did not restore the latest step")
            launches["restore of step 6"] = _digest_launches() - n0
            _sync()
            restored = dict(holder)
            if any(not torch.equal(_flat(restored)[p], t) for p, t in saved.items()):
                raise AssertionError("the restore of step 6 is not bit-exact")
            read_roots = {r for r, _ in spies.reads}
            log(f"[manager] restore of step 6 into seed 1's state: {n_leaves} leaves bit-exact; "
                f"{len(spies.reads)} payload reads, all from {sorted(read_roots)}; "
                f"{spies.copied_in} HtoD copies")
            if read_roots != {step4} or len(spies.reads) != n_leaves:
                raise AssertionError("the restore did not read every payload through step 4")

            spies.reset()
            n0 = _digest_launches()
            Snapshot(mgr.path_for(6)).restore({"train": StateDict(restored)}, device_digests=True)
            launches["restore into a matching state"] = n = _digest_launches() - n0
            log(f"[manager] Snapshot(step 6).restore(device_digests=True) into the state that holds "
                f"it: {len(spies.reads)} payload reads, {spies.copied_in} HtoD copies, K4 launches {n}")
            if spies.reads or spies.copied_in:
                raise AssertionError("a restore into a matching destination read or copied payload")
            if on_card and n != n_leaves:
                raise AssertionError(f"expected {n_leaves} K4 launches for the restore, got {n}")
        # The state is still the one step 6 holds: time the three takes on it.
        _time_incremental_takes(root, app, mgr.path_for(6), card)

        _, loss_a = train_step(state, batch)
        _, loss_b = train_step(restored, batch)
        _sync()
        if not torch.equal(loss_a, loss_b) or any(
            not torch.equal(_flat(restored)[p], t) for p, t in _flat(state).items()
        ):
            raise AssertionError("step 7 after the restore is not bit-identical to step 7")
        log(f"[manager] one more step on the restored state: loss {loss_b.item():.6f}, every "
            f"leaf bit-identical to the run that never stopped")
        return launches
    finally:
        watcher.close()
        torch.use_deterministic_algorithms(False)


def _time_incremental_takes(root: str, app: dict, base: str, card: str) -> None:
    """Three takes of an unchanged state, in turns: incremental with device
    digests, incremental with host digests (SHA-256 after the DtoH copy),
    and a full take. For each: the time async_take holds the caller, the
    time to commit, the bytes staged and the bytes written."""
    from torchsnapshot_tpu_torch import Snapshot

    kinds = {
        "device digests": dict(incremental_base=base, device_digests=True),
        "host digests": dict(incremental_base=base, record_digests=True, device_digests=False),
        "full take": dict(device_digests=False),
    }
    samples = {k: [] for k in kinds}
    with _CheckpointSpies() as spies:
        for r in range(MANAGER_TAKE_ROUNDS):
            order = list(kinds) if r % 2 == 0 else list(reversed(list(kinds)))
            for kind in order:
                path = f"{root}/takes/{kind.replace(' ', '_')}_{r}"
                _sync()
                spies.reset()
                t0 = time.perf_counter()
                pending = Snapshot.async_take(path, app, **kinds[kind])
                blocked = time.perf_counter() - t0
                pending.wait()
                total = time.perf_counter() - t0
                samples[kind].append((blocked, total, spies.staged_bytes, spies.written_bytes))
                shutil.rmtree(path, ignore_errors=True)
    for kind, rows in samples.items():
        blocked = [b for b, *_ in rows]
        total = [t for _, t, *_ in rows]
        log(f"[manager] async_take of the unchanged state, {kind}, median of {len(rows)} rounds in "
            f"turns (range): caller blocked {statistics.median(blocked) * 1e3:.1f} ms "
            f"({min(blocked) * 1e3:.1f}-{max(blocked) * 1e3:.1f}), committed "
            f"{statistics.median(total) * 1e3:.1f} ms ({min(total) * 1e3:.1f}-{max(total) * 1e3:.1f}); "
            f"staged {rows[0][2]} B, wrote {rows[0][3]} B; on {card}")


def phase_profile(fn, params, tokens, cfg) -> None:
    """Steady-state serving latency and train-step time (flash and dense
    attention) and where one traced forward's and one traced train step's
    device time goes."""
    from torchsnapshot_tpu_torch.entry import train_entry
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
    _trace("forward", lambda: fn(params, tokens))

    train_step, (state, batch) = train_entry(device=DEVICE, seed=0)
    dense_step = T.make_train_step(dense_cfg, T.make_optimizer())
    ms, spread = time_in_turns(
        {"flash": lambda: train_step(state, batch), "dense": lambda: dense_step(state, batch)},
        iters=5,
    )
    log(f"[profile] train step, (4, 256) tokens, median of 5 rounds x 5: "
        f"{ms['flash']:.3f} ms with the flash kernels (range {spread['flash'][0]:.3f}-"
        f"{spread['flash'][1]:.3f}), {ms['dense']:.3f} ms with dense attention "
        f"(range {spread['dense'][0]:.3f}-{spread['dense'][1]:.3f})")
    _trace("train step", lambda: train_step(state, batch))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


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

    digest_instructions = phase_build()
    max_err = phase_kernels()
    fn, (params, _) = entry(device=DEVICE, seed=0)
    serve_launches, tokens, logits = phase_serve(fn, params, ENTRY_CONFIG)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_checkpoint(fn, params, tokens, logits, root)
        phase_state(root, card)
        train_launches = phase_train(ENTRY_CONFIG)
        phase_train_checkpoint(root)
        digest_err, digest_times = phase_digest(digest_instructions, max_sm_clock_mhz(), card)
        digest_launches = phase_manager(f"{root}/manager", card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels = phase_timing(
        {"serve": {"flash_fwd": serve_launches, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
         "train": train_launches},
        max_err,
        card,
    )
    kernels.append({
        "name": "device_digest",
        "route": "cuda",
        "source": "torchsnapshot_tpu_torch/csrc/digest.cu",
        "replaces": "torchsnapshot_tpu/device_digest.py:73",
        "launches": sum(digest_launches.values()),
        "launches_by_path": digest_launches,
        "max_abs_err": float(digest_err),
        "library_ms": None,
        **digest_times,
    })
    phase_profile(fn, params, tokens, ENTRY_CONFIG)

    print(json.dumps({"kernels": kernels}))
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
