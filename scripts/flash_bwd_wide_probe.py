#!/usr/bin/env python3
"""Where the f32 backward kernels' time goes at tile width 256, on the card.

    python3 scripts/flash_bwd_wide_probe.py [TREE]

Needs an NVIDIA Hopper GPU and nvcc; imports torch, the port and
``chip_smoke`` (for its timers), nothing of JAX. TREE is a checkout of the
repository (this one by default; an older commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists probes that commit's
kernels). The script builds ``TREE/torchsnapshot_tpu_torch/csrc/
flash_bwd.cu`` as it is, a copy with ``clock64()`` marks (read back
through an ``extern "C"`` ``cudaMemcpyFromSymbol``) and a knock-out copy
(the marked copy without the score products' work on their A operand:
the 8-row design's fragment reads and splits, the chunked design's split
of the A chunk; its results are wrong) into the gitignored ``build/probe_bwd/``, loads them
through ctypes and, at phase 8's wide shape (BH 64, S 128, D 256, f32,
causal), prints:

- each build's dq and dk/dv time by the CUDA-graph timer, in turns with
  SDPA's efficient f32 backward, with the SM clock;
- for the heaviest block of each kernel (head 0; dq's last q tile, dk/dv's
  k tile 0) and each of its warpgroups, the mean cycles of one streamed
  tile in each segment between two marks, and each segment's share of
  the tile (``[probe] <kernel> wg<w> shares ...``, one line each).

``chip_smoke.py`` phase 8 logs the shares on one line through
``start_shares`` (the marked copy's build, begun beside the kernels') and
``shares``. The marks are placed by replacing exact lines of the source,
one set for each design the kernels have had (``DESIGNS``): the set whose
lines are all found is used; a tree that matches none stops the script.
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

OUT = os.path.join(_build.BUILD_DIR, "probe_bwd")
SHAPE = (64, 128, 256)
TILES, MARKS = 64, 12  # the timeline's tiles and marks a tile, per warpgroup

TIMELINE_HEAD = (
    "namespace {\n"
    f"__device__ long long g_tl[2][{TILES}][{MARKS}];\n"
    "#define TL_ON (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0)\n"
    f"#define TL(k) do {{ if (TL_ON && tl_n >= 0 && tl_n < {TILES}) "
    "g_tl[threadIdx.x / 128][tl_n][(k)] = clock64(); } while (0)\n"
)
TIMELINE_IO = (
    '\nextern "C" int read_timeline(long long* out) {\n'
    "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n"
    'extern "C" int clear_timeline() {\n'
    f"  static const long long zeros[2 * {TILES} * {MARKS}] = {{}};\n"
    "  return (int)cudaMemcpyToSymbol(g_tl, zeros, sizeof(g_tl));\n}\n"
)

# Each design: "edits", replacements (old text, new text or None to declare
# the tile counter after the old text, and how many times the old text
# occurs where that is not once) that add the marks; "knockout",
# replacements (file, old, new, count) that drop the score products' work
# on their A operand (the build is wrong; it times the products without
# it); "segments", (name, first mark, last mark or "next" for the next
# row's mark 0, "A" or "B" for rows of the score or the output chunks
# only, or None), each summed over the rows (a row: one streamed tile, or
# one chunk) and divided by the streamed tiles, which are the rows with
# mark "tile_mark"; "parted", the segment that the knock-out parts into
# its fragment work and its wgmma chains, or None.
SEGMENTS_ROWS8 = ["wait for TMA", "streamed split + barrier",
                  "score products (fragment reads, splits, wgmma chains)",
                  "exchange of the halves (2 barriers)", "P, dS and their split",
                  "output product + add", "end-of-tile barrier", "next TMA issue, loop"]
DESIGNS = {
    # Streamed tiles of 8 rows, one stage, split in place by both
    # warpgroups; each warpgroup contracts half of d for the scores, its A
    # operand resident and split fragment by fragment.
    "rows8": {
        "edits": [
            ("  // This warpgroup's rows of k's transposed copy (its dq columns).\n", None, 1),
            ("    mbar_wait(&bar_kv, t & 1);\n    split_tile<BK, W, true, 2 * NT>(",
             "    ++tl_n; TL(0);\n    mbar_wait(&bar_kv, t & 1);\n    TL(1);\n"
             "    split_tile<BK, W, true, 2 * NT>("),
            ("    __syncthreads();\n\n    // S = Q K^T and dP = dO V^T, Q and dO split",
             "    __syncthreads();\n    TL(2);\n\n    // S = Q K^T and dP = dO V^T, Q and dO split"),
            ("(pacc, Gr + a_off, 1.f, vh + b_off, vl + b_off, wt);\n",
             "(pacc, Gr + a_off, 1.f, vh + b_off, vl + b_off, wt);\n    TL(3);\n"),
            ("    xch_add<BK>(pacc, xch + BK * 128, wg, wt);\n",
             "    xch_add<BK>(pacc, xch + BK * 128, wg, wt);\n    TL(4);\n"),
            ("    accum_to_tf32_a<BK>(pacc, dh, dl);\n\n    // dQ += dS K over this warpgroup",
             "    accum_to_tf32_a<BK>(pacc, dh, dl);\n    TL(5);\n\n"
             "    // dQ += dS K over this warpgroup"),
            ("    for (int i = 0; i < OW / 2; ++i) acc[i] += part[i];\n"
             "    __syncthreads();  // both warpgroups are done with the split tiles\n",
             "    for (int i = 0; i < OW / 2; ++i) acc[i] += part[i];\n    TL(6);\n"
             "    __syncthreads();  // both warpgroups are done with the split tiles\n"
             "    TL(7);\n"),
            ("  // Pass 0 sums dV += P^T dO, pass 1 dK += dS^T Q; the q stream runs\n", None, 1),
            ("      mbar_wait(&bar_q, (pass * n_tiles + t) & 1);\n",
             "      ++tl_n; TL(0);\n      mbar_wait(&bar_q, (pass * n_tiles + t) & 1);\n"
             "      TL(1);\n", 1),
            ("      __syncthreads();\n\n      // S^T = K Q^T and (pass 1)",
             "      __syncthreads();\n      TL(2);\n\n      // S^T = K Q^T and (pass 1)", 1),
            ("      __syncthreads();  // both warpgroups are done with q's lo tile\n",
             "      TL(3);\n      __syncthreads();  // both warpgroups are done with q's lo tile\n", 1),
            ("      if (pass == 1) xch_add<BQ>(pacc, xch + BQ * 128, wg, wt);\n",
             "      if (pass == 1) xch_add<BQ>(pacc, xch + BQ * 128, wg, wt);\n      TL(4);\n", 1),
            ("      accum_to_tf32_a<BQ>(sacc, ah, al);\n      float part[OW / 2] = {};\n",
             "      accum_to_tf32_a<BQ>(sacc, ah, al);\n      TL(5);\n"
             "      float part[OW / 2] = {};\n", 1),
            ("      for (int i = 0; i < OW / 2; ++i) acc[i] += part[i];\n"
             "      __syncthreads();  // both warpgroups are done with the split tiles and the "
             "stats\n",
             "      for (int i = 0; i < OW / 2; ++i) acc[i] += part[i];\n      TL(6);\n"
             "      __syncthreads();  // both warpgroups are done with the split tiles and the "
             "stats\n      TL(7);\n", 1),
        ],
        "knockout": [("hopper.cuh",
            "        const float x[4] = {*reinterpret_cast<const float*>(a_raw + sw_off(r, c, 64)),\n"
            "                            *reinterpret_cast<const float*>(a_raw + sw_off(r + 8, c, 64)),\n"
            "                            *reinterpret_cast<const float*>(a_raw + sw_off(r, c + 4, 64)),\n"
            "                            *reinterpret_cast<const float*>(a_raw + sw_off(r + 8, c + 4, 64))};\n"
            "#pragma unroll\n"
            "        for (int e = 0; e < 4; ++e) {\n"
            "          uint32_t hi, lo;\n"
            "          split_tf32(x[e] * mul, hi, lo);\n"
            "          fr[j][e] = pass == 0 ? lo : hi;\n"
            "        }\n",
            "#pragma unroll\n"
            "        for (int e = 0; e < 4; ++e) fr[j][e] = 0x3f800000u + e;\n", 1)],
        "segments": [(name, k, k + 1 if k + 1 < len(SEGMENTS_ROWS8) else "next", None)
                     for k, name in enumerate(SEGMENTS_ROWS8)],
        "tile_mark": 7,
        "parted": 2,
    },
    # 32-column chunks of d through a ring of landing slots for each
    # warpgroup; a row is a chunk, or a pair of output chunks (mark 9).
    "ring": {
        "edits": [
            ("  int i = 0;  // this warpgroup's item\n", None, 2),
            ("      mbar_wait(&full[wg][s], (i / STAGES) & 1);\n      split_box<",
             "      ++tl_n; TL(0);\n      mbar_wait(&full[wg][s], (i / STAGES) & 1);\n"
             "      TL(1);\n      split_box<", 2),
            ("      wgmma_wait<0>();  // the last chunk's products, which read the other split slot\n",
             "      TL(2);\n"
             "      wgmma_wait<0>();  // the last chunk's products, which read the other split slot\n"
             "      TL(3);\n", 2),
            ("      named_barrier(1 + wg, NT);\n      const uint32_t a = smem_u32(sp);\n",
             "      named_barrier(1 + wg, NT);\n      TL(4);\n      const uint32_t a = smem_u32(sp);\n", 2),
            ("      wgmma_commit();\n      issue_ahead(i, t, c);\n    }\n",
             "      wgmma_commit();\n      TL(6);\n      issue_ahead(i, t, c);\n      TL(5);\n    }\n", 2),
            ("    add_to(large, big);\n\n    // P", "    add_to(large, big);\n    TL(7);\n\n    // P", 2),
            ("    accum_to_tf32_a<BK>(ds, dh, dl);\n",
             "    accum_to_tf32_a<BK>(ds, dh, dl);\n    TL(8);\n", 1),
            ("    accum_to_tf32_a<BQ>(pt, ph, pl);\n",
             "    accum_to_tf32_a<BQ>(pt, ph, pl);\n    TL(8);\n", 1),
            ("        mbar_wait(&full[wg][s], (i / STAGES) & 1);\n        split_tile_transposed<",
             "        ++tl_n; TL(0); TL(9);\n        mbar_wait(&full[wg][s], (i / STAGES) & 1);\n"
             "        TL(1);\n        split_tile_transposed<", 2),
            ("        wgmma_wait<0>();\n        fence_operands(part);\n",
             "        TL(2);\n        wgmma_wait<0>();\n        TL(3);\n        fence_operands(part);\n",
             2),
            ("        fence_proxy_async();\n        named_barrier(1 + wg, NT);\n",
             "        TL(10);\n        fence_proxy_async();\n        named_barrier(1 + wg, NT);\n"
             "        TL(4);\n", 2),
            ("        wgmma_commit();\n        issue_ahead(i, t, nc + j);\n",
             "        wgmma_commit();\n        TL(6);\n        issue_ahead(i, t, nc + j);\n        TL(5);\n",
             2),
        ],
        # The score products without the split of their A chunk (the
        # products read stale hi and lo).
        "knockout": [
            ("flash_bwd.cu", "      split_box<BOX>(ld, sp, sp + BOX, wt);                   // A: q or dO\n",
             "", 1),
            ("flash_bwd.cu", "      split_box<ABOX>(ld, sp, sp + ABOX, wt);                          // A: k or v\n",
             "", 1),
        ],
        "segments": [
            ("scores: wait for TMA", 0, 1, "A"),
            ("scores: split of the A and B chunks", 1, 2, "A"),
            ("scores: wait for the last chunk's products", 2, 3, "A"),
            ("scores: large-term sum, barrier of the warpgroup", 3, 4, "A"),
            ("scores: wgmma issue", 4, 6, "A"),
            ("scores: TMA issue (one thread)", 6, 5, "A"),
            ("scores: drain of the last chunk", 5, 7, "A"),
            ("exchange (P, dS) and the output's A split", 7, 8, "A"),
            ("output: wait for TMA", 0, 1, "B"),
            ("output: transposed split", 1, 2, "B"),
            ("output: wait for the last product", 2, 3, "B"),
            ("output: add", 3, 10, "B"),
            ("output: barrier of the warpgroup", 10, 4, "B"),
            ("output: wgmma issue", 4, 6, "B"),
            ("output: TMA issue (one thread)", 6, 5, "B"),
            ("to the next item (the last: drain and add)", "last", "next", None),
        ],
        "tile_mark": 7,
        "parted": None,
    },
}


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"flash_bwd_wide_probe: {src.count(old)} matches for {old.strip()!r}, "
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


# The kernels the edits of flash_bwd.cu mark, first to last in the file.
KERNELS = ("flash_bwd_dq_tf32_wide_kernel", "flash_bwd_dkv_tf32_wide_kernel")


def design_of(src: str) -> str:
    lo, hi = _scope(src, *KERNELS)
    for name, design in DESIGNS.items():
        if all(src[lo:hi].count(e[0]) == _count(e) for e in design["edits"]):
            return name
    raise SystemExit("flash_bwd_wide_probe: the source matches no design in DESIGNS")


def timeline_source(src: str, design: str) -> str:
    out = _replace(src, "namespace {\n", TIMELINE_HEAD)
    for e in DESIGNS[design]["edits"]:
        old, new = e[:2]
        out = _replace_in(out, old, old + "  int tl_n = -1;\n" if new is None else new, _count(e),
                          KERNELS)
    return out + TIMELINE_IO


def start_build(sources: dict, csrc: str) -> dict:
    """Start nvcc, as the package builds, on each source ({name:
    (flash_bwd.cu text, hopper.cuh text or None for the tree's own)}), all
    at once, each in a directory of its own; finish_build takes the
    result."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (text, header) in sources.items():
        where = os.path.join(OUT, name)
        os.makedirs(where, exist_ok=True)
        cu, so = os.path.join(where, "flash_bwd.cu"), os.path.join(where, "flash_bwd.so")
        with open(cu, "w") as f:
            f.write(text)
        hdr = os.path.join(where, "hopper.cuh")
        if header is not None:
            with open(hdr, "w") as f:
                f.write(header)
        elif os.path.exists(hdr):
            os.remove(hdr)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_build(procs: dict) -> dict:
    """Wait for start_build's compilers; each library loaded and typed."""
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_wide_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn in ("flash_bwd_dq", "flash_bwd_dkv"):
            getattr(lib, fn).argtypes = fa._SIGNATURES["flash_bwd"][fn]
            getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "read_timeline"):
            lib.read_timeline.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def build(sources: dict, csrc: str) -> dict:
    return finish_build(start_build(sources, csrc))


def runner(lib, fn: str, args, causal=True):
    """A call of ``lib``'s f32 ``fn`` on (q, k, v, dO, lse, delta) into
    outputs made once."""
    q = args[0]
    outs = [torch.empty_like(q) for _ in range(1 if fn == "flash_bwd_dq" else 2)]

    def call():
        err = getattr(lib, fn)(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
                               *q.shape, 0, int(causal), q.shape[2] ** -0.5,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn} returned {err}")
        return outs
    return call


def tile_shares(marks: np.ndarray, design: str):
    """{segment: mean cycles a streamed tile}, and the streamed tiles, from
    one warpgroup's marks (rows x marks) under ``design``'s segments."""
    spec = DESIGNS[design]
    rows = [r for r in range(TILES) if marks[r, 0]]
    totals = {name: 0 for name, *_ in spec["segments"]}
    tiles_of = {name: set() for name in totals}
    seen = 0  # rows before this one that hold the tile mark
    for n, r in enumerate(rows):
        phase = "B" if marks[r, 9] else "A"
        tile = seen - (phase == "B")
        for name, first, last, only in spec["segments"]:
            if only not in (None, phase):
                continue
            if first == "last":
                first = 5 if marks[r, 5] and not marks[r, 8] else max(
                    i for i in range(9) if marks[r, i])  # 9 is a flag, 10 inside; 5 is last
            start = marks[r, first]
            end = (marks[rows[n + 1], 0] if n + 1 < len(rows) else 0) if last == "next" \
                else marks[r, last]
            if start and end:
                totals[name] += int(end - start)
                tiles_of[name].add(tile)
        seen += bool(marks[r, spec["tile_mark"]])
    return {name: totals[name] / len(tiles_of[name]) if tiles_of[name] else 0.0
            for name in totals}, seen


def inputs():
    """(q, k, v, dO, lse, delta) at SHAPE, f32, on the card."""
    q, k, v, dO = cs._qkv(SHAPE, torch.float32, seed=3, n=4)
    o, lse = fa.flash_fwd_reference(q, k, v, causal=True)
    return q, k, v, dO, lse, (dO * o).sum(-1)


def timeline_means(lib, design: str, args) -> dict:
    """{"dq"/"dkv": [(segment means, streamed tiles) of warpgroup 0, 1]}
    from one marked call of each kernel (after a first, unmarked one)."""
    out = {}
    for fn, kernel in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
        call = runner(lib, fn, args)
        call()
        torch.cuda.synchronize()
        if lib.clear_timeline():
            raise RuntimeError("clear_timeline failed")
        call()
        torch.cuda.synchronize()
        marks = np.zeros((2, TILES, MARKS), dtype=np.int64)
        if lib.read_timeline(marks.ctypes.data):
            raise RuntimeError("read_timeline failed")
        out[kernel] = [tile_shares(marks[wg], design) for wg in (0, 1)]
    return out


def start_shares(tree: str = ROOT) -> dict:
    """Start building ``tree``'s timeline copy (nvcc in the background);
    ``shares`` takes the handle."""
    csrc = os.path.join(tree, "torchsnapshot_tpu_torch", "csrc")
    design = design_of(open(os.path.join(csrc, "flash_bwd.cu")).read())
    src = open(os.path.join(csrc, "flash_bwd.cu")).read()
    return {"design": design,
            "procs": start_build({"timeline": (timeline_source(src, design), None)}, csrc)}


def shares(handle: dict) -> dict:
    """Each kernel's and warpgroup's share of a streamed tile by segment
    ({"dq": {"wg0": {...}, "wg0_cycles": c, ...}, ...}) from the timeline
    copy that ``start_shares`` began to build."""
    lib = finish_build(handle["procs"])["timeline"]
    means = timeline_means(lib, handle["design"], inputs())
    out = {}
    for kernel, per_wg in means.items():
        out[kernel] = {}
        for wg, (seg, n) in enumerate(per_wg):
            tile = sum(seg.values())
            if n and tile:
                out[kernel][f"wg{wg}"] = {k: v / tile for k, v in seg.items()}
                out[kernel][f"wg{wg}_cycles"] = tile
    return out


def probe(tree: str) -> dict:
    """Build and run the probe on ``tree``'s source; log its lines and
    return {"design", "us", kernel: {"wg<w>": {segment: share}}}."""
    csrc = os.path.join(tree, "torchsnapshot_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "flash_bwd.cu")).read()
    design = design_of(src)
    header = open(os.path.join(csrc, "hopper.cuh")).read()
    timeline = timeline_source(src, design)
    knocked = {"flash_bwd.cu": timeline, "hopper.cuh": header}
    for file, old, new, count in DESIGNS[design]["knockout"]:
        knocked[file] = (_replace(knocked[file], old, new, count) if file == "hopper.cuh"
                         else _replace_in(knocked[file], old, new, count, KERNELS))
    libs = build({"kernel": (src, None), "timeline": (timeline, None),
                  "knockout": (knocked["flash_bwd.cu"], knocked["hopper.cuh"])}, csrc)
    args = inputs()
    q, k, v, dO = args[:4]
    want = fa.flash_bwd_dq_reference(*args, causal=True), *fa.flash_bwd_dkv_reference(
        *args, causal=True)
    for name in ("kernel", "timeline"):
        got = runner(libs[name], "flash_bwd_dq", args)() + runner(
            libs[name], "flash_bwd_dkv", args)()
        err = cs._max_err(got, want)
        if err > 1e-4:
            raise SystemExit(f"flash_bwd_wide_probe: {name} is {err:.3g} from the plain version")
    card = cs.card_line()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    calls = {f"{fn}@{name}": runner(lib, fn, args)
             for name, lib in libs.items() for fn in ("flash_bwd_dq", "flash_bwd_dkv")}
    # SDPA's efficient f32 backward (dq, dk and dv in one call), its
    # forward run on the stream the graphs capture on.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    q4, k4, v4, dO4 = (t.reshape(8, 8, *SHAPE[1:]) for t in (q, k, v, dO))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    with torch.cuda.stream(stream), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    torch.cuda.current_stream().wait_stream(stream)
    calls["sdpa_efficient_bwd"] = lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), dO4,
                                                              retain_graph=True)
    before = cs.sm_clocks()
    times = {name: [] for name in calls}
    for _ in range(2):
        for name in list(calls) + list(reversed(list(calls))):
            times[name].append(cs.graph_times({name: calls[name]}, stream=stream)[name] * 1e3)
    after = cs.sm_clocks()
    us = {name: float(np.median(t)) for name, t in times.items()}
    out = {"design": design, "us": us}
    cs.log(f"[probe] design {design!r} of {csrc}; BH,S,D={SHAPE} f32 causal, CUDA graph of "
           f"{cs.GRAPH_CALLS} calls, median of 4 readings in turns, us a call: "
           + ", ".join(f"{n} {t:.2f}" for n, t in us.items())
           + f"; SM clock, max, power before {before}, after {after}; on {card}")
    mhz = cs.max_sm_clock_mhz()
    parted = DESIGNS[design]["parted"]
    means = {name: timeline_means(libs[name], design, args)
             for name in ("timeline", "knockout")}
    for kernel in ("dq", "dkv"):
        out[kernel] = {}
        for wg in (0, 1):
            seg, n = means["timeline"][kernel][wg]
            if not n:
                continue
            if parted is not None:
                # The score products' segment, parted by the knock-out: its
                # cycles without fragment work are the wgmma chains'.
                name = DESIGNS[design]["segments"][parted][0]
                chains = min(means["knockout"][kernel][wg][0][name], seg[name])
                seg = {**{k: v for k, v in seg.items() if k != name},
                       "score fragment reads and splits": seg[name] - chains,
                       "score wgmma chains": chains}
            tile = sum(seg.values())
            out[kernel][f"wg{wg}"] = {k: v / tile for k, v in seg.items()}
            out[kernel][f"wg{wg}_cycles"] = tile
            cs.log(f"[probe] {kernel} wg{wg} shares of a streamed tile ({n} tiles, mean "
                   f"{tile:.0f} cycles = {tile / mhz:.3f} us at {mhz:.0f} MHz): "
                   + "; ".join(f"{k} {v:.0f} ({100 * v / tile:.1f}%)" for k, v in seg.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
    probe(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
