#!/usr/bin/env python3
"""K1-K3 of one source tree by the CUDA-graph timer, for comparing trees.

    python3 scripts/flash_tree_times.py <tree> <label>

Needs an NVIDIA Hopper GPU and nvcc; imports torch, nothing of JAX.
``<tree>`` is a checkout of the repository (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists);
its ``torchsnapshot_tpu_torch`` is imported and its kernels are built into
its own ``build/``. The timer is this checkout's
``chip_smoke.graph_times``. Prints one JSON object: ``label``, each
kernel's microseconds a call at BH 32, S 256, causal, in bf16 and f32 at D
= 64 and 128 (``flash_fwd@64``, ``flash_bwd_dq_f32@128``, ...) and, where
the tree's kernels take it, at D = 256 at BH 64, S 128 (``...@256``), the SM
clock, its maximum and the power draw after, and, where this run built the
kernels, each instance's ptxas registers and spill stores (``ptxas``).

Run the trees in turns in one call, on one card (A, B, B, A): two calls
may land on two cards.
"""

import importlib.util
import json
import os
import re
import sys

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, tree)

import torch  # noqa: E402

spec = importlib.util.spec_from_file_location("cs_timer", os.path.join(here, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from torchsnapshot_tpu_torch.ops import _build, flash_attention as fa  # noqa: E402

assert fa.__file__.startswith(tree), fa.__file__
_build.build(["flash_fwd", "flash_bwd"])
torch.backends.cuda.matmul.allow_tf32 = False
out = {"label": label, "ptxas": {}}
for name in ("flash_fwd", "flash_bwd"):
    kernel = None
    for line in _build.build_logs.get(name, "").splitlines():
        m = re.search(r"\d+(flash_[a-z0-9_]+?_kernel)I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif kernel and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif kernel and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out["ptxas"][kernel] = f"{regs} regs, {spill} B spilled"
            kernel = None
widths = (64, 128, 256) if 256 in getattr(fa, "TILE_WIDTHS", ()) else (64, 128)
for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_f32")):
    for D in widths:
        BH, S = (64, 128) if D == 256 else (32, 256)
        q, k, v, dO = cs._qkv((BH, S, D), dtype, seed=3, n=4)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
        delta = (dO.float() * o.float()).sum(-1)
        args = (q, k, v, dO, lse, delta)
        calls = {f"flash_fwd{tag}@{D}": lambda: fa.flash_fwd_cuda(q, k, v, causal=True),
                 f"flash_bwd_dq{tag}@{D}": lambda: fa.flash_bwd_dq(*args, causal=True),
                 f"flash_bwd_dkv{tag}@{D}": lambda: fa.flash_bwd_dkv(*args, causal=True)}
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        g = cs.graph_times(calls, stream=stream)
        out.update({k: round(v * 1e3, 3) for k, v in g.items()})
out["clock"] = cs.sm_clocks()
print(json.dumps(out), flush=True)
