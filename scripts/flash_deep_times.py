#!/usr/bin/env python3
"""K1-K3's deep forms (head dims over 256) of source trees, timed in turns.

    python3 scripts/flash_deep_times.py CSRC [CSRC ...]

Needs an NVIDIA Hopper GPU and nvcc; imports torch, the port and
``chip_smoke`` (for its timer), nothing of JAX. Each ``CSRC`` is a
directory holding ``flash_fwd.cu``, ``flash_bwd.cu`` and ``hopper.cuh``:
this checkout's ``torchsnapshot_tpu_torch/csrc``, or a variant copied
under ``build/``. Each is built by nvcc as the package builds it (all at
once) into ``build/deep_times/<i>/`` and loaded through ctypes. For each
shape (BH 64, S 128, d 320, the phase-8 rows; BH 32, S 256, d 320, the
model of ``chip_smoke.py`` phase 25; BH 64, S 128, d 512) and dtype it
checks every tree's K1-K3 against the plain versions (f32 at 1e-5 and
1e-4, the 16-bit forms at 3e-2 and 0.1) and prints one JSON line: each
tree's microseconds a causal call by the CUDA-graph timer, in two rounds
of opposite order. Then each tree's deep kernel instances with their
ptxas registers and spills, and the card's name and power limit.

Run the trees in one call, on one card: two calls may land on two cards.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from torchsnapshot_tpu_torch.ops import _build  # noqa: E402
from torchsnapshot_tpu_torch.ops import flash_attention as fa  # noqa: E402

OUT = os.path.join(_build.BUILD_DIR, "deep_times")
SHAPES = ((64, 128, 320), (32, 256, 320), (64, 128, 512))
ATOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (3e-2, 0.1), torch.float16: (3e-2, 0.1)}
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def build(trees) -> tuple:
    """{(tree index, source): typed library} and {tree index: ptxas lines of
    its deep kernels}."""
    procs = {}
    for i, csrc in enumerate(trees):
        os.makedirs(os.path.join(OUT, str(i)), exist_ok=True)
        for name in ("flash_fwd", "flash_bwd"):
            so = os.path.join(OUT, str(i), f"{name}.so")
            procs[(i, name)] = (so, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for (i, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_deep_times: nvcc failed for tree {i} {name}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"\d+(flash_\w+?deep_kernel)I(\w+?)EEv", line)
            if "Compiling entry" in line:
                kernel = f"{m.group(1)}<{m.group(2)}>" if m else None
            elif kernel and "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif kernel and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                ptxas.setdefault(i, {})[kernel] = f"{regs} regs, {spill} B spilled"
                kernel = None
        lib = ctypes.CDLL(so)
        for fn, argtypes in fa._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[(i, name)] = lib
    return libs, ptxas


def calls_of(libs, i, q, k, v, dO, lse, delta) -> tuple:
    """Tree i's K1, K2 and K3 as calls on fixed outputs, and the outputs."""
    BH, S, D = q.shape
    code, scale = CODES[q.dtype], D**-0.5
    o, lse_o = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fwd, bwd = libs[(i, "flash_fwd")], libs[(i, "flash_bwd")]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"tree {i}: launch returned {err}")

    def k1():
        check(fwd.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            lse_o.data_ptr(), BH, S, D, code, 1, scale, stream()))

    def k2():
        check(bwd.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, S, D, code, 1,
                               scale, stream()))

    def k3():
        check(bwd.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                BH, S, D, code, 1, scale, stream()))

    return (k1, k2, k3), (o, dq, dk, dv)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_deep_times: no CUDA device", file=sys.stderr)
        return 2
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, ptxas = build(trees)
    for BH, S, D in SHAPES:
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            q, k, v, dO = cs._qkv((BH, S, D), dtype, seed=3, n=4)
            o_ref, lse = fa.flash_fwd_reference(q, k, v)
            delta = (dO.float() * o_ref.float()).sum(-1)
            plain = fa.flash_bwd_reference(q, k, v, dO, lse, delta)
            calls = {}
            for i in range(len(trees)):
                (k1, k2, k3), (o, dq, dk, dv) = calls_of(libs, i, q, k, v, dO, lse, delta)
                k1(), k2(), k3()
                torch.cuda.synchronize()
                if (cs._max_err([o], [o_ref]) > ATOL[dtype][0]
                        or cs._max_err([dq, dk, dv], plain) > ATOL[dtype][1]):
                    raise SystemExit(f"flash_deep_times: tree {i} disagrees with the plain "
                                     f"version at {BH, S, D} {dtype}")
                calls.update({f"fwd@{i}": k1, f"dq@{i}": k2, f"dkv@{i}": k3})
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            first = cs.graph_times(calls, stream=stream)
            second = cs.graph_times(dict(reversed(calls.items())), stream=stream)
            print(json.dumps({"shape": [BH, S, D], "dtype": str(dtype)[6:], "us": {
                key: [round(first[key] * 1e3, 2), round(second[key] * 1e3, 2)] for key in calls}}),
                flush=True)
    for i, tree in enumerate(trees):
        print(json.dumps({"tree": i, "csrc": tree, "ptxas": ptxas.get(i, {})}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
