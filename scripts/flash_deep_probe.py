#!/usr/bin/env python3
"""Where the deep tensor-core kernels' time goes (head dims over 256), on the card.

    python3 scripts/flash_deep_probe.py [TREE]

Needs an NVIDIA Hopper GPU and nvcc; imports torch, the port and
``chip_smoke`` (for its timers), nothing of JAX. TREE is a checkout of the
repository (this one by default). The script builds
``TREE/torchsnapshot_tpu_torch/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` as
they are and with ``-DHOPPER_PROBE``, which turns on the kernels'
``PROBE_MARK`` calls (``csrc/hopper.cuh``: thread 0 of each warpgroup of
block (0, 0, 0) records ``clock64()`` at each step of each item of its
stream), into the gitignored ``build/deep_probe/``, loads them through
ctypes and, at phase 8's deep shape (BH 64, S 128, d 320, causal), for the
bf16 and f32 K1, K2 and K3 deep forms:

- times both builds by the CUDA-graph timer, in turns (what the marks
  cost);
- for the heaviest block (head 0; K1's and K2's last q tile, K3's k
  tile 0) and each warpgroup, prints the cycles from its first mark to
  its last and each step's share of them: waiting for an item's TMA, splitting it
  into hi and lo (f32), waiting for the last item's products (and
  adding them), the warpgroup's barrier (16 bits: the barrier and the
  refill's TMA issue), issuing the products, issuing the refill's TMA,
  the exchange, softmax and P (or P^T, or dS) at the end of the score
  chunks, and the loop between items.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from torchsnapshot_tpu_torch.ops import _build  # noqa: E402
from torchsnapshot_tpu_torch.ops import flash_attention as fa  # noqa: E402

OUT = os.path.join(_build.BUILD_DIR, "deep_probe")
SHAPE = (64, 128, 320)
ROWS = 96  # hopper::PROBE_ROWS
# What the interval that ends at each mark holds (csrc/hopper.cuh,
# PROBE_MARK); 16-bit items have no split, and their mark 4 follows the
# refill's TMA issue too.
STEPS = {0: "loop between items", 1: "wait for TMA", 2: "split into hi and lo",
         3: "wait for the last products, add", 4: "barrier of the warpgroup",
         5: "wgmma issue", 6: "TMA issue", 7: "exchange, softmax, P"}
STEPS16 = {**STEPS, 3: "wait for the last products", 4: "barrier, TMA issue"}
# (label, source, kernel, dtype)
CASES = tuple((f"{kernel} {str(dtype)[6:]}", "flash_fwd" if kernel == "K1" else "flash_bwd", kernel,
               dtype)
              for kernel in ("K1", "K2", "K3") for dtype in (torch.bfloat16, torch.float32))


def build(tree: str) -> dict:
    """{(source, probed): typed library}, all built at once."""
    csrc = os.path.join(tree, "torchsnapshot_tpu_torch", "csrc")
    procs = {}
    for name in ("flash_fwd", "flash_bwd"):
        for probed in (False, True):
            where = os.path.join(OUT, "probe" if probed else "plain")
            os.makedirs(where, exist_ok=True)
            so = os.path.join(where, f"{name}.so")
            flags = [*_build.NVCC_FLAGS, *(["-DHOPPER_PROBE"] if probed else [])]
            procs[(name, probed)] = (so, subprocess.Popen(
                [_build.find_nvcc(), *flags, "-o", so, os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, probed), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_deep_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in fa._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[(name, probed)] = lib
    return libs


def call(lib, kernel: str, args) -> callable:
    """K1, K2 or K3 (``kernel``) of ``lib`` on ``args`` as a call."""
    q, k, v, dO, lse, delta = args
    BH, S, D = q.shape
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    o, lse_o, dk, dv = torch.empty_like(q), torch.empty_like(lse), torch.empty_like(k), torch.empty_like(v)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "K1":
            err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                lse_o.data_ptr(), BH, S, D, code, 1, D**-0.5, stream)
        elif kernel == "K2":
            err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), o.data_ptr(), BH, S, D, code,
                                   1, D**-0.5, stream)
        else:
            err = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                    BH, S, D, code, 1, D**-0.5, stream)
        if err:
            raise RuntimeError(f"flash_deep_probe: launch returned {err}")
    return run


def marks_of(lib, run) -> np.ndarray:
    """(2, ROWS, 8) clock64() marks of one probed launch."""
    lib.probe_clear()
    run()
    torch.cuda.synchronize()
    out = np.zeros((2, ROWS, 8), dtype=np.int64)
    err = lib.probe_read(out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    if err:
        raise RuntimeError(f"flash_deep_probe: probe_read returned {err}")
    return out


def shares(marks: np.ndarray, steps: dict) -> dict:
    """Each warpgroup's cycles and the share of each step: every interval
    between two consecutive marks (in time) goes to the step of the mark
    that ends it."""
    out = {}
    for wg in range(2):
        t = [(int(c), k) for r in range(ROWS) for k, c in enumerate(marks[wg, r]) if c]
        t.sort()
        if len(t) < 2:
            continue
        total = t[-1][0] - t[0][0]
        acc = {name: 0 for name in steps.values()}
        for (a, _), (b, k) in zip(t, t[1:]):
            acc[steps[k]] += b - a
        items = len({r for r in range(ROWS) if marks[wg, r, 0]})
        out[f"wg{wg}"] = {"cycles": total, "items": items,
                          "shares": {n: round(c / total, 3) for n, c in acc.items() if c}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_deep_probe: no CUDA device", file=sys.stderr)
        return 2
    tree = sys.argv[1] if len(sys.argv) > 1 else ROOT
    libs = build(tree)
    mhz = cs.max_sm_clock_mhz()
    for label, source, kernel, dtype in CASES:
        q, k, v, dO = cs._qkv(SHAPE, dtype, seed=3, n=4)
        o, lse = fa.flash_fwd_reference(q, k, v, causal=True)
        args = (q, k, v, dO, lse, (dO.float() * o.float()).sum(-1))
        runs = {p: call(libs[(source, p)], kernel, args) for p in (False, True)}
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        calls = {"plain": runs[False], "probed": runs[True]}
        first = cs.graph_times(calls, stream=stream)
        second = cs.graph_times(dict(reversed(calls.items())), stream=stream)
        marks = marks_of(libs[(source, True)], runs[True])
        steps = STEPS if dtype == torch.float32 else STEPS16
        print(json.dumps({"kernel": label, "shape": list(SHAPE), "us": {
            key: [round(first[key] * 1e3, 2), round(second[key] * 1e3, 2)] for key in calls},
            "heaviest block": shares(marks, steps), "max SM MHz": mhz}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
