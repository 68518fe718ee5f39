#!/usr/bin/env python3
"""Where the bf16 K1 and K3 kernels' time goes at tile width 256, on the card.

    python3 scripts/flash_bf16_wide_probe.py [TREE]

Needs an NVIDIA Hopper GPU and nvcc; imports torch, the port and
``chip_smoke`` (for its timers), nothing of JAX. TREE is a checkout of the
repository (this one by default; an older commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists probes that commit's
kernels). The script builds ``TREE/torchsnapshot_tpu_torch/csrc/
flash_fwd.cu`` and ``flash_bwd.cu`` as they are and copies with
``clock64()`` marks (read back through an ``extern "C"``
``cudaMemcpyFromSymbol``) into the gitignored ``build/probe_bf16/``, loads
them through ctypes and, at phase 8's wide shape (BH 64, S 128, D 256,
bf16, causal), prints:

- each build's K1 (forward) and K3 (dk/dv) time by the CUDA-graph timer,
  in turns with SDPA's forward and backward and with the tree's K2, with
  the SM clock;
- for the heaviest block of each kernel (head 0; K1's last q tile, K3's k
  tile 0) and each of its warpgroups, the cycles of the block from its
  first instruction to its last store, and each segment's cycles (summed
  over the block's tiles, with the mean a tile) and share of the block
  (``[probe] bf16 <kernel> wg<w> ...``, one line each).

``chip_smoke.py`` phase 8 logs the shares on one line through
``start_shares`` (the marked copies' builds, begun beside the kernels')
and ``shares``. The marks are placed by replacing exact lines of the
sources, one set for each design the kernels have had (``DESIGNS``, the
newest first): the first set whose lines are all found is used; a tree
that matches none stops the script.
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

OUT = os.path.join(_build.BUILD_DIR, "probe_bf16")
SHAPE = (64, 128, 256)
ROWS, MARKS, ONCE = 64, 12, 8  # tiles, marks a tile, and one-off marks, per warpgroup

TIMELINE_HEAD = (
    "namespace {\n"
    f"__device__ long long g_tl[2][{ROWS}][{MARKS}];\n"
    f"__device__ long long g_once[2][{ONCE}];\n"
    "#define TL_ON (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0 && "
    "blockDim.x == 256)\n"
    f"#define TL(k) do {{ if (TL_ON && tl_n >= 0 && tl_n < {ROWS}) "
    "g_tl[threadIdx.x / 128][tl_n][(k)] = clock64(); } while (0)\n"
    "#define TLE(k) do { if (TL_ON) g_once[threadIdx.x / 128][(k)] = clock64(); } while (0)\n"
)
TIMELINE_IO = (
    '\nextern "C" int read_timeline(long long* tl, long long* once) {\n'
    "  int e = (int)cudaMemcpyFromSymbol(tl, g_tl, sizeof(g_tl));\n"
    "  return e ? e : (int)cudaMemcpyFromSymbol(once, g_once, sizeof(g_once));\n}\n"
    'extern "C" int clear_timeline() {\n'
    f"  static const long long zeros[2 * {ROWS} * {MARKS}] = {{}};\n"
    "  int e = (int)cudaMemcpyToSymbol(g_tl, zeros, sizeof(g_tl));\n"
    "  return e ? e : (int)cudaMemcpyToSymbol(g_once, zeros, sizeof(g_once));\n}\n"
)

# Each kernel's designs, the newest first: "edits" of its source (old
# text, new text, and how many times the old text occurs where that is
# not once) that add the marks: TL(k) marks mark k of the current tile
# (the row counter tl_n, declared by an edit and advanced at the top of
# the loop), TLE(k) the one-off mark k (E0 the first instruction, E1 after
# the first TMA issue, E2 when the resident tiles have landed, E3 the end
# of the loop, E4 the last store); "segments", (name, first mark, last
# mark): ints are a tile's marks, "E<k>" the one-off marks, "next" the
# next tile's mark 0 (E3 after the last tile).
DESIGNS = {
    "K1": {
        # The second design: a kernel of its own, both warpgroups over the
        # whole score tile; every warp issues its own boxes; O staged and
        # stored by TMA.
        "spread_issue": {
            "edits": [
                ("  // q, and k and v by stage; a stage is freed by every warp.\n",
                 "  TLE(0);\n  // q, and k and v by stage; a stage is freed by every warp.\n"),
                ("    load(0);\n    if (n_tiles > 1) load(1);\n  }\n",
                 "    load(0);\n    if (n_tiles > 1) load(1);\n  }\n  TLE(1);\n"),
                ("  const uint32_t v_base = smem_u32(Vs) + half * BOX;\n  mbar_wait(&bar_q, 0);\n\n"
                 "  for (int t = 0; t < n_tiles; ++t) {\n",
                 "  const uint32_t v_base = smem_u32(Vs) + half * BOX;\n  mbar_wait(&bar_q, 0);\n"
                 "  TLE(2);\n  int tl_n = -1;\n\n  for (int t = 0; t < n_tiles; ++t) {\n"
                 "    ++tl_n; TL(0);\n"),
                ("      load(t + 1);\n    }\n    __syncwarp();\n",
                 "      load(t + 1);\n    }\n    __syncwarp();\n    TL(1);\n"),
                ("    mbar_wait(&bar_k[s], parity);\n    fence_operands(sacc);\n    wgmma_fence();\n"
                 "    wgmma_ss_tiles<T, 256>(",
                 "    mbar_wait(&bar_k[s], parity);\n    TL(2);\n    fence_operands(sacc);\n"
                 "    wgmma_fence();\n    wgmma_ss_tiles<T, 256>("),
                ("    wgmma_ss_tiles<T, 256>(sacc, q_base, k_base + s * TILE);\n    wgmma_commit();\n"
                 "    wgmma_wait<0>();\n    fence_operands(sacc);\n",
                 "    wgmma_ss_tiles<T, 256>(sacc, q_base, k_base + s * TILE);\n    wgmma_commit();\n"
                 "    wgmma_wait<0>();\n    fence_operands(sacc);\n    TL(3);\n"),
                ("    // O_w += P V_w over the tile's keys, V read MN-major.\n"
                 "    mbar_wait(&bar_v[s], parity);\n",
                 "    // O_w += P V_w over the tile's keys, V read MN-major.\n    TL(4);\n"
                 "    mbar_wait(&bar_v[s], parity);\n    TL(5);\n"),
                ("    if (lane == 0) mbar_arrive(&bar_free[s]);\n  }\n\n  // O / l in bf16",
                 "    if (lane == 0) mbar_arrive(&bar_free[s]);\n    TL(6);\n  }\n  TLE(3);\n\n"
                 "  // O / l in bf16"),
                ("    tma_store_wait();\n", "    tma_store_wait();\n    TLE(4);\n"),
            ],
            "segments": [
                ("prologue: barriers, each warp issues its 2-3 boxes", "E0", "E1"),
                ("wait for q", "E1", "E2"),
                ("TMA refill issue", 0, 1),
                ("wait for k", 1, 2),
                ("score products S = Q K^T (16 k16 steps)", 2, 3),
                ("mask, online softmax, P", 3, 4),
                ("wait for v", 4, 5),
                ("P V products", 5, 6),
                ("loop", 6, "next"),
                ("epilogue: O staged, TMA store issued and read", "E3", "E4"),
            ],
        },
        # The first design: both warpgroups compute the whole score tile; thread 0
        # issues every TMA box; O stored from registers.
        "two_wg_whole_scores": {
            "edits": [
                ("  extern __shared__ uint8_t smem_raw[];\n"
                 "  __shared__ __align__(8) uint64_t bar_q, bar_k[2], bar_v[2], bar_free[2];\n",
                 "  TLE(0);\n  extern __shared__ uint8_t smem_raw[];\n"
                 "  __shared__ __align__(8) uint64_t bar_q, bar_k[2], bar_v[2], bar_free[2];\n"),
                ("    load_kv(0);\n    if (n_tiles > 1) load_kv(1);\n  }\n",
                 "    load_kv(0);\n    if (n_tiles > 1) load_kv(1);\n  }\n  TLE(1);\n"),
                ("  mbar_wait(&bar_q, 0);\n\n  for (int t = 0; t < n_tiles; ++t) {\n",
                 "  mbar_wait(&bar_q, 0);\n  TLE(2);\n  int tl_n = -1;\n\n"
                 "  for (int t = 0; t < n_tiles; ++t) {\n    ++tl_n; TL(0);\n"),
                ("    __syncwarp();\n\n    // S = Q K^T over W in k16 steps.\n",
                 "    __syncwarp();\n    TL(1);\n\n    // S = Q K^T over W in k16 steps.\n"),
                ("    mbar_wait(&bar_k[s], parity);\n", "    mbar_wait(&bar_k[s], parity);\n    TL(2);\n"),
                ("    wgmma_ss_tiles<W>(sacc, q_base, k_base + s * TILE);\n    wgmma_commit();\n"
                 "    wgmma_wait<0>();\n    fence_operands(sacc);\n",
                 "    wgmma_ss_tiles<W>(sacc, q_base, k_base + s * TILE);\n    wgmma_commit();\n"
                 "    wgmma_wait<0>();\n    fence_operands(sacc);\n    TL(3);\n"),
                ("    mbar_wait(&bar_v[s], parity);\n",
                 "    TL(4);\n    mbar_wait(&bar_v[s], parity);\n    TL(5);\n"),
                ("    if (lane == 0) mbar_arrive(&bar_free[s]);\n  }\n\n  const size_t row0",
                 "    if (lane == 0) mbar_arrive(&bar_free[s]);\n    TL(6);\n  }\n  TLE(3);\n\n"
                 "  const size_t row0"),
                ("    if (wg == 0 && lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);\n  }\n}\n",
                 "    if (wg == 0 && lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);\n  }\n"
                 "  TLE(4);\n}\n", 2),
            ],
            "segments": [
                ("prologue: barriers, thread 0 issues q, k and v (20 boxes)", "E0", "E1"),
                ("wait for q", "E1", "E2"),
                ("TMA refill issue", 0, 1),
                ("wait for k", 1, 2),
                ("score products S = Q K^T (16 k16 steps)", 2, 3),
                ("mask, online softmax, P", 3, 4),
                ("wait for v", 4, 5),
                ("P V products", 5, 6),
                ("loop", 6, "next"),
                ("epilogue: O and lse from registers", "E3", "E4"),
            ],
        },
    },
    "K3": {
        # The second design: S^T in warpgroup 0, dP^T in warpgroup 1, P^T handed over;
        # every warp issues its own boxes; dV and dK staged and stored by
        # TMA. Marks 2-4 are the hand-over: warpgroup 0 forms and hands P^T,
        # warpgroup 1 waits for it and forms dS^T.
        "split_products": {
            "edits": [
                ("  __shared__ __align__(8) uint64_t bar_k, bar_v, bar_q[2], bar_g[2], bar_p[2], "
                 "bar_free[2];\n",
                 "  TLE(0);\n"
                 "  __shared__ __align__(8) uint64_t bar_k, bar_v, bar_q[2], bar_g[2], bar_p[2], "
                 "bar_free[2];\n"),
                ("    for (int t = 0; t < 2 && t < n_tiles; ++t) load_q(t, wg == 0, wg == 1);\n  }\n",
                 "    for (int t = 0; t < 2 && t < n_tiles; ++t) load_q(t, wg == 0, wg == 1);\n  }\n"
                 "  TLE(1);\n"),
                ("  mbar_wait(wg == 0 ? &bar_k : &bar_v, 0);\n\n  for (int t = 0; t < n_tiles; ++t) {\n",
                 "  mbar_wait(wg == 0 ? &bar_k : &bar_v, 0);\n  TLE(2);\n  int tl_n = -1;\n\n"
                 "  for (int t = 0; t < n_tiles; ++t) {\n    ++tl_n; TL(0);\n"),
                ("    mbar_wait(wg == 0 ? &bar_q[s] : &bar_g[s], parity);\n",
                 "    mbar_wait(wg == 0 ? &bar_q[s] : &bar_g[s], parity);\n    TL(1);\n"),
                ("    wgmma_ss_tiles<T, 256>(sacc, a_base, (wg == 0 ? q_base : g_base) + s * TILE);\n"
                 "    wgmma_commit();\n    wgmma_wait<0>();\n    fence_operands(sacc);\n",
                 "    wgmma_ss_tiles<T, 256>(sacc, a_base, (wg == 0 ? q_base : g_base) + s * TILE);\n"
                 "    wgmma_commit();\n    wgmma_wait<0>();\n    fence_operands(sacc);\n    TL(2);\n"),
                ("      mbar_arrive(&bar_p[s]);\n", "      mbar_arrive(&bar_p[s]);\n      TL(3);\n"),
                ("      mbar_wait(&bar_p[s], parity);\n", "      mbar_wait(&bar_p[s], parity);\n      TL(3);\n"),
                ("    accum_to_a<T>(sacc, fa);\n", "    accum_to_a<T>(sacc, fa);\n    TL(4);\n"),
                ("    mbar_wait(wg == 0 ? &bar_g[s] : &bar_q[s], parity);\n",
                 "    mbar_wait(wg == 0 ? &bar_g[s] : &bar_q[s], parity);\n    TL(5);\n"),
                ("    wgmma_rs_tile<T, 256>(acc, fa, (wg == 0 ? g_base : q_base) + s * TILE);\n"
                 "    wgmma_commit();\n    wgmma_wait<0>();\n",
                 "    wgmma_rs_tile<T, 256>(acc, fa, (wg == 0 ? g_base : q_base) + s * TILE);\n"
                 "    wgmma_commit();\n    wgmma_wait<0>();\n    TL(6);\n"),
                ("      if (lane == 0) load_q(t + 2, true, true);\n    }\n  }\n",
                 "      if (lane == 0) load_q(t + 2, true, true);\n    }\n    TL(7);\n  }\n"
                 "  TLE(3);\n"),
                ("    tma_store_wait();\n", "    tma_store_wait();\n    TLE(4);\n"),
            ],
            "segments": [
                ("prologue: barriers, each warp issues its 2-3 boxes", "E0", "E1"),
                ("wait for K (wg0) or V (wg1)", "E1", "E2"),
                ("wait for Q (wg0) or dO (wg1)", 0, 1),
                ("score products S^T (wg0) or dP^T (wg1), 16 k16 steps", 1, 2),
                ("P^T and its hand-over (wg0); wait for P^T (wg1)", 2, 3),
                ("A fragments (wg0); dS^T and A fragments (wg1)", 3, 4),
                ("wait for dO (wg0) or Q (wg1)", 4, 5),
                ("output products dV (wg0) or dK (wg1), m64n256k16", 5, 6),
                ("stage release and refill", 6, 7),
                ("loop", 7, "next"),
                ("epilogue: dV or dK staged, TMA store issued and read", "E3", "E4"),
            ],
        },
        # The first design: both warpgroups compute S^T and dP^T whole; lane 0 of
        # warp 0 issues every TMA box; dk and dv stored from registers.
        "two_wg_whole_scores": {
            "edits": [
                ("  __shared__ __align__(8) uint64_t bar_kv, bar_full[2], bar_free[2];\n",
                 "  TLE(0);\n  __shared__ __align__(8) uint64_t bar_kv, bar_full[2], bar_free[2];\n"),
                ("    load_q(0);\n    if (n_tiles > 1) load_q(1);\n  }\n",
                 "    load_q(0);\n    if (n_tiles > 1) load_q(1);\n  }\n  TLE(1);\n"),
                ("  mbar_wait(&bar_kv, 0);\n\n  for (int t = 0; t < n_tiles; ++t) {\n",
                 "  mbar_wait(&bar_kv, 0);\n  TLE(2);\n  int tl_n = -1;\n\n"
                 "  for (int t = 0; t < n_tiles; ++t) {\n    ++tl_n; TL(0);\n"),
                ("      load_q(t + 1);\n    }\n    __syncwarp();\n",
                 "      load_q(t + 1);\n    }\n    __syncwarp();\n    TL(1);\n"),
                ("    mbar_wait(&bar_full[s], parity);\n",
                 "    mbar_wait(&bar_full[s], parity);\n    TL(2);\n"),
                ("    wgmma_ss_tiles<W>(pacc, v_base, g_base + s * TILE);\n    wgmma_commit();\n"
                 "    wgmma_wait<1>();\n    fence_operands(sacc);\n",
                 "    wgmma_ss_tiles<W>(pacc, v_base, g_base + s * TILE);\n    wgmma_commit();\n"
                 "    wgmma_wait<1>();\n    fence_operands(sacc);\n    TL(3);\n"),
                ("    wgmma_wait<0>();\n    fence_operands(pacc);\n    // dS^T = P^T (dP^T - delta);",
                 "    TL(4);\n    wgmma_wait<0>();\n    fence_operands(pacc);\n    TL(5);\n"
                 "    // dS^T = P^T (dP^T - delta);"),
                ("    accum_to_a(sacc, pa);\n    accum_to_a(pacc, da);\n",
                 "    accum_to_a(sacc, pa);\n    accum_to_a(pacc, da);\n    TL(6);\n"),
                ("    if (lane == 0) mbar_arrive(&bar_free[s]);\n  }\n\n"
                 "  const size_t base = (size_t)bh * S * d;\n",
                 "    if (lane == 0) mbar_arrive(&bar_free[s]);\n    TL(7);\n  }\n  TLE(3);\n\n"
                 "  const size_t base = (size_t)bh * S * d;\n"),
                ("  store_rows<OW>(dv + base, dv_acc, 1.f, n0, r_lo, c2, S, d, wg * OW);\n}\n",
                 "  store_rows<OW>(dv + base, dv_acc, 1.f, n0, r_lo, c2, S, d, wg * OW);\n"
                 "  TLE(4);\n}\n"),
            ],
            "segments": [
                ("prologue: barriers, warp 0 issues K, V, Q and dO (24 boxes), lse, delta",
                 "E0", "E1"),
                ("wait for K and V", "E1", "E2"),
                ("TMA refill issue", 0, 1),
                ("wait for Q and dO", 1, 2),
                ("score products S^T, dP^T (32 k16 steps) to S^T", 2, 3),
                ("P^T", 3, 4),
                ("wait for dP^T", 4, 5),
                ("dS^T, A fragments", 5, 6),
                ("output products dV, dK", 6, 7),
                ("loop", 7, "next"),
                ("epilogue: dk and dv from registers", "E3", "E4"),
            ],
        },
    },
}
FILES = {"K1": "flash_fwd", "K3": "flash_bwd"}
# The kernel each one's edits mark.
KERNELS = {"K1": ("flash_fwd_wgmma_wide_kernel",) * 2,
           "K3": ("flash_bwd_dkv_wgmma_wide_kernel",) * 2}


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"flash_bf16_wide_probe: {src.count(old)} matches for {old.strip()!r}, "
                         f"want {count}")
    return src.replace(old, new)


def _count(edit) -> int:
    """How many times an edit's old text occurs (1 unless it says)."""
    return edit[2] if len(edit) > 2 else 1


def _scope(src: str, first: str, last: str) -> tuple:
    """(start, end) of the text from kernel ``first``'s template line to the
    end of kernel ``last``'s body, where this probe's edits apply (other
    kernels of the file repeat some of their lines); the whole text where
    ``first`` is not defined."""
    at = src.find(f"\n{first}(const")
    if at < 0:
        return 0, len(src)
    start = src.rfind("\ntemplate", 0, at) + 1
    end = src.find("\n}\n", src.find(f"\n{last}(const", at)) + 3
    return start, end


def _replace_in(src: str, old: str, new: str, count: int, scope: tuple) -> str:
    """_replace inside ``scope`` (a pair of kernel names) of ``src``."""
    lo, hi = _scope(src, *scope)
    return src[:lo] + _replace(src[lo:hi], old, new, count) + src[hi:]


def design_of(kernel: str, src: str) -> str:
    lo, hi = _scope(src, *KERNELS[kernel])
    for name, design in DESIGNS[kernel].items():
        if all(src[lo:hi].count(e[0]) == _count(e) for e in design["edits"]):
            return name
    raise SystemExit(f"flash_bf16_wide_probe: the {kernel} source matches no design in DESIGNS")


def timeline_source(kernel: str, src: str, design: str) -> str:
    out = _replace(src, "namespace {\n", TIMELINE_HEAD)
    for e in DESIGNS[kernel][design]["edits"]:
        out = _replace_in(out, e[0], e[1], _count(e), KERNELS[kernel])
    return out + TIMELINE_IO


def _sources(tree: str) -> dict:
    """{kernel: (csrc, source text, design)} of ``tree``."""
    csrc = os.path.join(tree, "torchsnapshot_tpu_torch", "csrc")
    out = {}
    for kernel, name in FILES.items():
        src = open(os.path.join(csrc, f"{name}.cu")).read()
        out[kernel] = (csrc, src, design_of(kernel, src))
    return out


def start_build(sources: dict) -> dict:
    """Start nvcc, as the package builds, on each source ({build: (csrc,
    file name, text)}), all at once, each in a directory of its own;
    finish_build takes the result."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (csrc, file, text) in sources.items():
        where = os.path.join(OUT, name)
        os.makedirs(where, exist_ok=True)
        cu, so = os.path.join(where, f"{file}.cu"), os.path.join(where, f"{file}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, file, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_build(procs: dict) -> dict:
    """Wait for start_build's compilers; each library loaded and typed."""
    libs = {}
    for name, (so, file, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bf16_wide_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in fa._SIGNATURES[file].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "read_timeline"):
            lib.read_timeline.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        libs[name] = lib
    return libs


def runner(lib, kernel: str, args, fn: str = ""):
    """A call of ``lib``'s bf16 K1 (``args`` q, k, v) or backward kernel
    ``fn`` (K3 by default; ``args`` q, k, v, dO, lse, delta) into outputs
    made once."""
    q = args[0]
    if kernel == "K1":
        fn, outs = "flash_fwd", [torch.empty_like(q), torch.empty(q.shape[:2], device=q.device)]
    else:
        fn = fn or "flash_bwd_dkv"
        outs = [torch.empty_like(q) for _ in range(1 if fn == "flash_bwd_dq" else 2)]

    def call():
        err = getattr(lib, fn)(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
                               *q.shape, 1, 1, q.shape[2] ** -0.5,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn} returned {err}")
        return outs
    return call


def inputs() -> dict:
    """{"K1": (q, k, v), "K3": (q, k, v, dO, lse, delta)} at SHAPE, bf16,
    on the card."""
    q, k, v, dO = cs._qkv(SHAPE, torch.bfloat16, seed=3, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=True)
    return {"K1": (q, k, v), "K3": (q, k, v, dO, lse, (dO.float() * o.float()).sum(-1))}


def block_segments(tl: np.ndarray, once: np.ndarray, segments) -> tuple:
    """({segment: (cycles summed over the tiles, tiles)}, block cycles)
    from one warpgroup's marks."""
    rows = [r for r in range(ROWS) if tl[r, 0]]

    def at(mark, n):
        if isinstance(mark, str) and mark.startswith("E"):
            return once[int(mark[1:])]
        if mark == "next":
            return tl[rows[n + 1], 0] if n + 1 < len(rows) else once[3]
        return tl[rows[n], mark]

    out = {}
    for name, first, last in segments:
        tiles = [None] if isinstance(first, str) else range(len(rows))
        total, n = 0, 0
        for r in tiles:
            start, end = at(first, r), at(last, r)
            if start and end:
                total, n = total + int(end - start), n + 1
        out[name] = (total, n)
    return out, int(once[4] - once[0]) if once[4] and once[0] else 0


def timelines(libs: dict, designs: dict, args: dict) -> dict:
    """{kernel: [(segments, block cycles) of warpgroup 0, 1]} from one
    marked call of each kernel (after a first, unmarked one)."""
    out = {}
    for kernel, lib in libs.items():
        call = runner(lib, kernel, args[kernel])
        call()
        torch.cuda.synchronize()
        if lib.clear_timeline():
            raise RuntimeError("clear_timeline failed")
        call()
        torch.cuda.synchronize()
        tl = np.zeros((2, ROWS, MARKS), dtype=np.int64)
        once = np.zeros((2, ONCE), dtype=np.int64)
        if lib.read_timeline(tl.ctypes.data, once.ctypes.data):
            raise RuntimeError("read_timeline failed")
        segs = DESIGNS[kernel][designs[kernel]]["segments"]
        out[kernel] = [block_segments(tl[wg], once[wg], segs) for wg in (0, 1)]
    return out


def _shares(per_wg) -> dict:
    out = {}
    for wg, (segs, block) in enumerate(per_wg):
        if block:
            out[f"wg{wg}"] = {name: total / block for name, (total, _) in segs.items()}
            out[f"wg{wg}_cycles"] = block
    return out


def start_shares(tree: str = ROOT) -> dict:
    """Start building ``tree``'s marked copies (nvcc in the background);
    ``shares`` takes the handle."""
    srcs = _sources(tree)
    return {"designs": {k: d for k, (_, _, d) in srcs.items()},
            "procs": start_build({k: (csrc, FILES[k], timeline_source(k, src, d))
                                  for k, (csrc, src, d) in srcs.items()})}


def shares(handle: dict) -> dict:
    """Each kernel's and warpgroup's share of its heaviest block by segment
    ({"K1": {"wg0": {...}, "wg0_cycles": c, ...}, "K3": ...}) from the
    marked copies that ``start_shares`` began to build."""
    libs = finish_build(handle["procs"])
    return {k: _shares(v) for k, v in timelines(libs, handle["designs"], inputs()).items()}


def probe(tree: str) -> dict:
    """Build and run the probe on ``tree``'s sources; log its lines and
    return {"designs", "us", kernel: {"wg<w>": {segment: share}}}."""
    srcs = _sources(tree)
    designs = {k: d for k, (_, _, d) in srcs.items()}
    builds = {}
    for k, (csrc, src, d) in srcs.items():
        builds[f"{k}_kernel"] = (csrc, FILES[k], src)
        builds[f"{k}_timeline"] = (csrc, FILES[k], timeline_source(k, src, d))
    libs = finish_build(start_build(builds))
    args = inputs()
    q, k, v, dO, lse, delta = args["K3"]
    want = {"K1": fa.flash_fwd_reference(q, k, v, causal=True),
            "K3": cs._flash_bwd_emul(*args["K3"], causal=True)[1:]}
    for name, lib in libs.items():
        kernel = name.split("_")[0]
        err = cs._max_err(runner(lib, kernel, args[kernel])(), want[kernel])
        # o at the bf16 forward's bar; dk and dv at 3e-2 of their largest
        # value, against the plain recompute that rounds P and dS as the
        # kernel does.
        bar = 3e-2 if kernel == "K1" else 3e-2 * max(t.abs().max().item() for t in want["K3"])
        if err > bar:
            raise SystemExit(f"flash_bf16_wide_probe: {name} is {err:.3g} from the plain version")
    card = cs.card_line()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    calls = {name: runner(lib, name.split("_")[0], args[name.split("_")[0]])
             for name, lib in libs.items()}
    calls["K2_kernel"] = runner(libs["K3_kernel"], "K3", args["K3"], fn="flash_bwd_dq")
    import torch.nn.functional as F

    q4, k4, v4, dO4 = (t.reshape(8, 8, *SHAPE[1:]) for t in (q, k, v, dO))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    with torch.cuda.stream(stream):
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    torch.cuda.current_stream().wait_stream(stream)
    calls["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    calls["sdpa_bwd"] = lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), dO4, retain_graph=True)
    before = cs.sm_clocks()
    times = {name: [] for name in calls}
    for _ in range(2):
        for name in list(calls) + list(reversed(list(calls))):
            times[name].append(cs.graph_times({name: calls[name]}, stream=stream)[name] * 1e3)
    after = cs.sm_clocks()
    us = {name: float(np.median(t)) for name, t in times.items()}
    out = {"designs": designs, "us": us}
    cs.log(f"[probe] bf16 designs {designs} of {tree}; BH,S,D={SHAPE} bf16 causal, CUDA graph "
           f"of {cs.GRAPH_CALLS} calls, median of 4 readings in turns, us a call: "
           + ", ".join(f"{n} {t:.2f}" for n, t in us.items())
           + f"; SDPA's backward is {o_sdpa.grad_fn.name()}; SM clock, max, power before "
           f"{before}, after {after}; on {card}")
    mhz = cs.max_sm_clock_mhz()
    marked = {k: libs[f"{k}_timeline"] for k in FILES}
    for kernel, per_wg in timelines(marked, designs, args).items():
        out[kernel] = _shares(per_wg)
        for wg, (segs, block) in enumerate(per_wg):
            if not block:
                continue
            cs.log(f"[probe] bf16 {kernel} wg{wg}, heaviest block {block} cycles = "
                   f"{block / mhz:.3f} us at {mhz:.0f} MHz; segment: cycles (tiles, mean a tile, "
                   "share of the block): " + "; ".join(
                       f"{name} {total} ({n}, {total / max(n, 1):.0f}, {100 * total / block:.1f}%)"
                       for name, (total, n) in segs.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bf16_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
    probe(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
