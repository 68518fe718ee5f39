#!/usr/bin/env python3
"""Where the f32 forward kernel's time goes, on the card.

    python3 scripts/flash_fwd_f32_probe.py

Needs an NVIDIA Hopper GPU and nvcc; imports torch, the port and
``chip_smoke`` (for its timers), nothing of JAX. It builds
``csrc/flash_fwd.cu`` and copies of it with one change each into
``torchsnapshot_tpu_torch/build/probe/``, loads them through ctypes, and
at the entry shape (BH=32, S=256, D=64, f32, causal) prints:

- each build's device time by the CUDA-graph timer, in turns with SDPA's
  efficient f32 forward, with the SM clock before and after;
  ``no_split`` drops the producer's split passes and ``no_products`` the
  consumer's two 3xTF32 products (their outputs are wrong; they bound
  what each part costs);
- the kernel's time over S = 64 to 1024, causal and not (a fixed part
  and a part per key tile);
- a timeline of the heaviest block (head 0, the last q tile) from the
  ``timeline`` build, which records ``clock64()`` at each step of both
  warpgroups: when q is split, and for each key tile when its raw stage
  landed, when its split buffer was free and split, and when the consumer
  had the buffer, the scores, P and the output product.

The copies are made by replacing lines of the source; a line that is not
found once stops the script, naming it.
"""

from __future__ import annotations

import ctypes
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

SOURCE = os.path.join(_build.CSRC_DIR, "flash_fwd.cu")
OUT = os.path.join(_build.BUILD_DIR, "probe")
SHAPE = (32, 256, 64)

SPLITS = (
    "      split_rows<BK * W>(raw + 2 * st * KT, kb, kb + KT, 1.f, ptid);\n",
    "      split_tile_transposed<BK, W>(raw + (2 * st + 1) * KT, kb + 2 * KT, kb + 2 * KT + VTT, "
    "ptid);\n",
)
PRODUCTS = (
    "    wgmma_3xtf32_ss<BK, W, Q_BOX, K_BOX>(sacc, qh, ql, kh, kl);\n",
    "    wgmma_3xtf32_rs<W, BK, VT_BOX>(part, ph, pl, vth, vtl);\n",
)
# (the line after which a mark goes, its slot, its name): the consumer's
# marks in slots 0-63 (4 a tile), the producer's in 64-127 (3 a tile).
MARKS = (
    ("    const int ptid = tid - NT;\n", "64", "producer: start"),
    ("    mbar_wait(&bar_q, 0);\n", "65", "producer: q landed"),
    ("    mbar_arrive(&q_split);\n", "66", "producer: q split"),
    ("      mbar_wait(&raw_full[st], (t / STAGES) & 1);\n", "67 + 3 * t", "producer: t{t} landed"),
    ("      if (t >= 2) mbar_wait(&split_free[b], ((t >> 1) - 1) & 1);\n", "68 + 3 * t",
     "producer: t{t} buffer free"),
    ("      mbar_arrive(&split_full[b]);\n", "69 + 3 * t", "producer: t{t} split"),
    ("  const uint32_t qh = smem_u32(Qh), ql = smem_u32(Ql);\n", "0", "consumer: start"),
    ("  mbar_wait(&q_split, 0);\n", "1", "consumer: has q"),
    ("    mbar_wait(&split_full[b], (t >> 1) & 1);\n", "2 + 4 * t", "consumer: t{t} has the buffer"),
    # The product's own lines (its template arguments are this kernel's):
    # the softmax's comment is in the W = 256 and deep kernels too.
    ("    wgmma_3xtf32_ss<BK, W, Q_BOX, K_BOX>(sacc, qh, ql, kh, kl);\n    wgmma_commit();\n"
     "    wgmma_wait<0>();\n    fence_operands(sacc);\n", "3 + 4 * t", "consumer: t{t} S done"),
    ("    accum_to_tf32_a<BK>(sacc, ph, pl);\n", "4 + 4 * t", "consumer: t{t} softmax, P split"),
    ("    mbar_arrive(&split_free[b]);  // the buffer may take tile t + 2\n", "5 + 4 * t",
     "consumer: t{t} P V done"),
    ("make_float2(oacc[4 * j + 2 * h] / l, oacc[4 * j + 2 * h + 1] / l);\n    };\n"
     "    if (d == W)\n      store(W);\n    else\n      store(d);\n"
     "    if (lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);\n  }\n", "60",
     "consumer: o and lse stored"),
)
TIMELINE_HEAD = (
    "namespace {\n"
    "__device__ long long g_tl[128];\n"
    "#define TL(i) do { if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0) "
    "g_tl[(i)] = clock64(); } while (0)\n"
)
TIMELINE_IO = (
    '\nextern "C" int read_timeline(long long* out) {\n'
    "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n"
    'extern "C" int clear_timeline() {\n'
    "  static const long long zeros[128] = {};\n"
    "  return (int)cudaMemcpyToSymbol(g_tl, zeros, sizeof(g_tl));\n}\n"
)


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"flash_fwd_f32_probe: {src.count(old)} matches in {SOURCE} for "
                         f"{old.strip()!r}, want 1")
    return src.replace(old, new)


def variants() -> dict:
    src = open(SOURCE).read()
    no_split, no_products = src, src
    for line in SPLITS:
        no_split = _replace(no_split, line, "")
    for line in PRODUCTS:
        no_products = _replace(no_products, line, "")
    timeline = _replace(src, "namespace {\n", TIMELINE_HEAD)
    for anchor, slot, _ in MARKS:
        indent = " " * (len(anchor.splitlines()[-1]) - len(anchor.splitlines()[-1].lstrip()))
        timeline = _replace(timeline, anchor, f"{anchor}{indent}TL({slot});\n")
    return {"kernel": src, "no_split": no_split, "no_products": no_products,
            "timeline": timeline + TIMELINE_IO}


def build(sources: dict) -> dict:
    """Each source built by nvcc as the package builds it (all at once),
    loaded and typed."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, text in sources.items():
        cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_fwd_f32_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.flash_fwd.argtypes = fa._SIGNATURES["flash_fwd"]["flash_fwd"]
        lib.flash_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def runner(lib, q, k, v, causal=True):
    """A call of ``lib``'s f32 forward on q, k, v into outputs made once."""
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], device=q.device)

    def call():
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                            *q.shape, 0, int(causal), q.shape[2] ** -0.5,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_fwd returned {err}")
        return o, lse
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    libs = build(variants())
    q, k, v = cs._qkv(SHAPE, torch.float32, seed=3)
    o, lse = runner(libs["kernel"], q, k, v)()
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=True)
    err = max(cs._max_err([o], [o_ref]), (lse - lse_ref).abs().max().item())
    if err > cs.O_ATOL[torch.float32]:
        raise SystemExit(f"flash_fwd_f32_probe: the kernel is {err:.3g} from the plain version")

    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    q4, k4, v4 = (t.reshape(4, 8, *SHAPE[1:]) for t in (q, k, v))

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    calls = {name: runner(lib, q, k, v) for name, lib in libs.items()}
    calls["sdpa_efficient"] = sdpa
    stream = torch.cuda.Stream()
    order = list(calls) + list(reversed(list(calls)))
    times = {name: [] for name in calls}
    before = cs.sm_clocks()
    for _ in range(3):
        for name in order:
            times[name].append(cs.graph_times({name: calls[name]}, stream=stream)[name] * 1e3)
    after = cs.sm_clocks()
    print(f"[probe] BH,S,D={SHAPE} f32 causal, CUDA graph of {cs.GRAPH_CALLS} calls, us a call, "
          f"6 readings in turns; SM clock, max, power before {before}, after {after}; on {card}")
    for name, t in times.items():
        print(f"[probe] {name}: median {float(np.median(t)):.2f} us ("
              + ", ".join(f"{x:.2f}" for x in t) + ")")

    for causal in (False, True):
        for S in (64, 128, 256, 512, 1024):
            qs, ks, vs = cs._qkv((32, S, 64), torch.float32, seed=5)
            t = cs.graph_times({"k": runner(libs["kernel"], qs, ks, vs, causal)}, stream=stream)["k"]
            print(f"[probe] scaling BH=32 S={S} D=64 causal={causal}: {t * 1e3:.2f} us")

    lib = libs["timeline"]
    lib.read_timeline.argtypes = [ctypes.c_void_p]
    for S in (256, 512):
        qs, ks, vs = cs._qkv((32, S, 64), torch.float32, seed=3)
        call = runner(lib, qs, ks, vs)
        call()
        torch.cuda.synchronize()
        if lib.clear_timeline():
            raise RuntimeError("clear_timeline failed")
        call()
        torch.cuda.synchronize()
        marks = np.zeros(128, dtype=np.int64)
        if lib.read_timeline(marks.ctypes.data):
            raise RuntimeError("read_timeline failed")
        names = {}
        for _, slot, name in MARKS:
            for t in range(S // 64 if "t{t}" in name else 1):
                names[eval(slot, {"t": t})] = name.format(t=t)
        t0 = min(marks[i] for i in names if marks[i])
        print(f"[probe] timeline of block (0, last q tile), BH=32 S={S} D=64 f32 causal, "
              f"clock64 cycles from its first mark (at {cs.max_sm_clock_mhz():.0f} MHz max):")
        for cycles, name in sorted((int(marks[i] - t0), n) for i, n in names.items() if marks[i]):
            print(f"[probe]   {cycles:6d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
