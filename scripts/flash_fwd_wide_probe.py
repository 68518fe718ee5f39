#!/usr/bin/env python3
"""Where the f32 forward kernel's time goes at tile width 256, on the card.

    python3 scripts/flash_fwd_wide_probe.py [TREE]

Needs an NVIDIA Hopper GPU and nvcc; imports torch, the port and
``chip_smoke`` (for its timers), nothing of JAX. TREE is a checkout of the
repository (this one by default; an older commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists probes that commit's
kernel). The script builds ``TREE/torchsnapshot_tpu_torch/csrc/
flash_fwd.cu`` as it is, a copy with ``clock64()`` marks (read back
through an ``extern "C"`` ``cudaMemcpyFromSymbol``) and a knock-out copy
(the marked copy without the score products' work on q: the raw-q
design's fragment reads and splits, the split-q design's split of the k
chunks; its results are wrong) into the gitignored ``build/probe_fwd/``,
loads them through ctypes and, at phase 8's wide shape (BH 64, S 128, D
256, f32, causal), prints:

- each build's time by the CUDA-graph timer, in turns with SDPA's
  efficient f32 forward, with the SM clock;
- for the heaviest block (head 0, the last q tile) and each of its
  warpgroups, the mean cycles of one key tile in each segment between two
  marks, and each segment's share of the tile (``[probe] K1 f32 wg<w>
  shares ...``, one line each). The raw-q design also marks each of the
  three passes of its score product, which the knock-out parts into their
  fragment work and their wgmma chains.

``chip_smoke.py`` phase 8 logs the shares on one line through
``start_shares`` (the marked copy's build, begun beside the kernels') and
``shares``. The marks are placed by replacing exact lines of the source,
one set for each design the kernel has had (``DESIGNS``): the set whose
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

OUT = os.path.join(_build.BUILD_DIR, "probe_fwd")
SHAPE = (64, 128, 256)
ROWS, MARKS = 64, 12  # the timeline's rows and marks a row, per warpgroup

TIMELINE_HEAD = (
    "namespace {\n"
    f"__device__ long long g_tl[2][{ROWS}][{MARKS}];\n"
    "#define TL_ON (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0)\n"
    f"#define TL(k) do {{ if (TL_ON && tl_n >= 0 && tl_n < {ROWS}) "
    "g_tl[threadIdx.x / 128][tl_n][(k)] = clock64(); } while (0)\n"
)
TIMELINE_IO = (
    '\nextern "C" int read_timeline(long long* out) {\n'
    "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n"
    'extern "C" int clear_timeline() {\n'
    f"  static const long long zeros[2 * {ROWS} * {MARKS}] = {{}};\n"
    "  return (int)cudaMemcpyToSymbol(g_tl, zeros, sizeof(g_tl));\n}\n"
)
# The raw-q design's score product (hopper::wgmma_3xtf32_raw_rs) marks the
# start of each pass and its end, one row a call.
PASS_HEAD = (
    "__device__ long long g_pass[2][64][4];\n"
    "__device__ int g_pass_n[2];\n"
    "#define PASS_ON (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0)\n"
    "#define PASS_MARK(k) do { if (PASS_ON && g_pass_n[threadIdx.x / 128] < 64) "
    "g_pass[threadIdx.x / 128][g_pass_n[threadIdx.x / 128]][(k)] = clock64(); } while (0)\n"
    "#define PASS_NEXT() do { if (PASS_ON) ++g_pass_n[threadIdx.x / 128]; } while (0)\n"
)
PASS_IO = (
    '\nextern "C" int read_passes(long long* out) {\n'
    "  return (int)cudaMemcpyFromSymbol(out, hopper::g_pass, sizeof(hopper::g_pass));\n}\n"
    'extern "C" int clear_passes() {\n'
    "  static const long long zeros[2 * 64 * 4] = {};\n"
    "  static const int n[2] = {};\n"
    "  int e = (int)cudaMemcpyToSymbol(hopper::g_pass, zeros, sizeof(hopper::g_pass));\n"
    "  return e ? e : (int)cudaMemcpyToSymbol(hopper::g_pass_n, n, sizeof(n));\n}\n"
)
RAW_RS = ("template <int N, int KD, int B_BOX, int G>\n"
          "__device__ __forceinline__ void wgmma_3xtf32_raw_rs(")

# Each design: "edits" of flash_fwd.cu (old text, new text or None to
# declare the row counter after the old text, and how many times the old
# text occurs where that is not once) that add the marks; "header_edits",
# the same for hopper.cuh; "knockout", replacements (file, old, new,
# count) that drop the score products' work on their operands (the build
# is wrong; it times the products without it); "segments", (name, first
# mark, last mark or "next" for the next row's mark 0, "A" or "B" for the
# rows of score or output items only, or None), each summed over the
# rows and divided by the key tiles, which are the rows with mark
# "tile_mark"; "passes", whether the score product marks its passes.
DESIGNS = {
    # The first design: one 32-key tile a row, one stage, q resident raw and
    # split fragment by fragment in each pass; each warpgroup contracts
    # half of d, the halves exchanged through shared memory.
    "raw_q": {
        "edits": [
            ("  // This warpgroup's rows of v's transposed copy (its output columns).\n", None),
            ("    mbar_wait(&bar_kv, t & 1);\n    split_tile<BK, W, false, 2 * NT>(",
             "    ++tl_n; TL(0);\n    mbar_wait(&bar_kv, t & 1);\n    TL(1);\n"
             "    split_tile<BK, W, false, 2 * NT>("),
            ("    __syncthreads();\n\n    // S = (scale Q) K^T, q pre-scaled in f32 and split",
             "    __syncthreads();\n    TL(2);\n\n"
             "    // S = (scale Q) K^T, q pre-scaled in f32 and split"),
            ("kh + wg * HALF * K_BOX, kl + wg * HALF * K_BOX, wt);\n",
             "kh + wg * HALF * K_BOX, kl + wg * HALF * K_BOX, wt);\n    TL(3);\n"),
            ("    xch_add<BK>(sacc, reinterpret_cast<const float*>(Vr), wg, wt);\n",
             "    xch_add<BK>(sacc, reinterpret_cast<const float*>(Vr), wg, wt);\n    TL(4);\n"),
            ("    accum_to_tf32_a<BK>(sacc, ph, pl);\n\n    // O = O alpha + P V over this",
             "    accum_to_tf32_a<BK>(sacc, ph, pl);\n    TL(5);\n\n    // O = O alpha + P V over this"),
            ("oacc[i] = fmaf(oacc[i], alpha[(i >> 1) & 1], part[i]);\n"
             "    __syncthreads();  // both warpgroups are done with the split tiles and raw v\n",
             "oacc[i] = fmaf(oacc[i], alpha[(i >> 1) & 1], part[i]);\n    TL(6);\n"
             "    __syncthreads();  // both warpgroups are done with the split tiles and raw v\n"
             "    TL(7);\n"),
        ],
        "header_edits": [
            (RAW_RS, PASS_HEAD + RAW_RS),
            ("  for (int pass = 0; pass < 3; ++pass) {\n    const uint32_t b = pass == 1 ? b_lo : b_hi;\n",
             "  for (int pass = 0; pass < 3; ++pass) {\n    PASS_MARK(pass);\n"
             "    const uint32_t b = pass == 1 ? b_lo : b_hi;\n"),
            ("      fence_fragments(fr);\n    }\n  }\n}\n",
             "      fence_fragments(fr);\n    }\n  }\n  PASS_MARK(3);\n  PASS_NEXT();\n}\n"),
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
        "segments": [
            ("wait for TMA", 0, 1, None),
            ("k split, v's transposed split, barrier", 1, 2, None),
            ("score products", 2, 3, None),
            ("exchange of the halves (2 barriers)", 3, 4, None),
            ("mask, online softmax, P split", 4, 5, None),
            ("P V product, add", 5, 6, None),
            ("end-of-tile barrier", 6, 7, None),
            ("next TMA issue, loop", 7, "next", None),
        ],
        "tile_mark": 7,
        "passes": True,
    },
    # Everything streamed in 32-column chunks of d: each warpgroup its half
    # of d for the scores (an item: a chunk of q and of k), the halves
    # exchanged once a tile, then its two output items (32 keys of its 128
    # columns of v, mark 9). A row: one item.
    "stream": {
        "edits": [
            ("  int i = 0;  // this warpgroup's item\n", None),
            ("      mbar_wait(&full[wg][s], (i / STAGES) & 1);\n      split_rows<BM * 32>(",
             "      ++tl_n; TL(0);\n      mbar_wait(&full[wg][s], (i / STAGES) & 1);\n"
             "      TL(1);\n      split_rows<BM * 32>("),
            ("      wgmma_wait<0>();  // the last item's products, which read the other split slot\n",
             "      TL(2);\n"
             "      wgmma_wait<0>();  // the last item's products, which read the other split slot\n"
             "      TL(3);\n"),
            ("      named_barrier(1 + wg, NT);\n      const uint32_t a = smem_u32(sp);\n",
             "      named_barrier(1 + wg, NT);\n      TL(4);\n      const uint32_t a = smem_u32(sp);\n"),
            ("      wgmma_commit();\n      issue_ahead(i, t, c);\n",
             "      wgmma_commit();\n      TL(6);\n      issue_ahead(i, t, c);\n      TL(5);\n"),
            ("    add_to(sacc, fresh);\n\n    // The whole S",
             "    add_to(sacc, fresh);\n    TL(7);\n\n    // The whole S"),
            ("    if (t + 1 < n_tiles) named_arrive(5 - wg, 2 * NT);\n",
             "    if (t + 1 < n_tiles) named_arrive(5 - wg, 2 * NT);\n    TL(11);\n"),
            ("    p_half(0);\n", "    p_half(0);\n    TL(8);\n"),
            ("      mbar_wait(&full[wg][s], (i / STAGES) & 1);\n      // Two of its four steps",
             "      ++tl_n; TL(0); TL(9);\n      mbar_wait(&full[wg][s], (i / STAGES) & 1);\n"
             "      TL(1);\n      // Two of its four steps"),
            ("      if (h == 1) {\n        wgmma_wait<0>();  // the first half's product\n",
             "      TL(2);\n      if (h == 1) {\n        wgmma_wait<0>();  // the first half's product\n"
             "        TL(3);\n"),
            ("      fence_proxy_async();\n      named_barrier(1 + wg, NT);\n      wgmma_fence();\n"
             "      wgmma_3xtf32_rs<128",
             "      TL(10);\n      fence_proxy_async();\n      named_barrier(1 + wg, NT);\n"
             "      TL(4);\n      wgmma_fence();\n      wgmma_3xtf32_rs<128"),
            ("      wgmma_commit();\n      issue_ahead(i, t, ncw + h);\n",
             "      wgmma_commit();\n      TL(6);\n      issue_ahead(i, t, ncw + h);\n      TL(5);\n"),
        ],
        # The score products without the split of their chunks of q and k
        # (they read stale hi and lo).
        "knockout": [
            ("flash_fwd.cu", "      split_rows<BM * 32>(ld, sp, sp + BOX, scale, wt);           // q, pre-scaled\n",
             "", 1),
            ("flash_fwd.cu", "      split_box<BOX>(ld + BOX, sp + 2 * BOX, sp + 3 * BOX, wt);  // k\n", "", 1),
        ],
        "segments": [
            ("scores: wait for TMA", 0, 1, "A"),
            ("scores: split of the q and k chunks", 1, 2, "A"),
            ("scores: wait for the last item's products", 2, 3, "A"),
            ("scores: f32 sum, barrier of the warpgroup", 3, 4, "A"),
            ("scores: wgmma issue", 4, 6, "A"),
            ("scores: TMA issue (warp 0's box)", 6, 5, "A"),
            ("scores: drain of the last item", 5, 7, "A"),
            ("exchange of the score halves", 7, 11, "A"),
            ("mask, online softmax, P split", 11, 8, "A"),
            ("output: wait for TMA", 0, 1, "B"),
            ("output: transposed split of v", 1, 2, "B"),
            ("output: wait for the first half's product", 2, 3, "B"),
            ("output: rescale and add, P's second half", 3, 10, "B"),
            ("output: barrier of the warpgroup", 10, 4, "B"),
            ("output: wgmma issue", 4, 6, "B"),
            ("output: TMA issue (warp 0's box)", 6, 5, "B"),
            ("to the next item (the last: drain and add)", "last", "next", None),
        ],
        "tile_mark": 7,
        "passes": False,
    },
}


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"flash_fwd_wide_probe: {src.count(old)} matches for {old.strip()!r}, "
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


# The kernel the edits of flash_fwd.cu mark.
KERNEL = ("flash_fwd_tf32_wide_kernel", "flash_fwd_tf32_wide_kernel")


def design_of(src: str) -> str:
    lo, hi = _scope(src, *KERNEL)
    for name, design in DESIGNS.items():
        if all(src[lo:hi].count(e[0]) == _count(e) for e in design["edits"]):
            return name
    raise SystemExit("flash_fwd_wide_probe: the source matches no design in DESIGNS")


def marked_sources(src: str, header: str, design: str) -> tuple:
    """(flash_fwd.cu, hopper.cuh) with ``design``'s marks."""
    spec = DESIGNS[design]
    out = _replace(src, "namespace {\n", TIMELINE_HEAD)
    for e in spec["edits"]:
        old, new = e[:2]
        out = _replace_in(out, old, old + "  int tl_n = -1;\n" if new is None else new, _count(e),
                          KERNEL)
    for e in spec.get("header_edits", []):
        header = _replace(header, e[0], e[1], _count(e))
    return out + TIMELINE_IO + (PASS_IO if spec["passes"] else ""), header


def start_build(sources: dict, csrc: str) -> dict:
    """Start nvcc, as the package builds, on each source ({name:
    (flash_fwd.cu text, hopper.cuh text)}), all at once, each in a
    directory of its own; finish_build takes the result."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (text, header) in sources.items():
        where = os.path.join(OUT, name)
        os.makedirs(where, exist_ok=True)
        cu, so = os.path.join(where, "flash_fwd.cu"), os.path.join(where, "flash_fwd.so")
        for path, body in ((cu, text), (os.path.join(where, "hopper.cuh"), header)):
            with open(path, "w") as f:
                f.write(body)
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
            raise SystemExit(f"flash_fwd_wide_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.flash_fwd.argtypes = fa._SIGNATURES["flash_fwd"]["flash_fwd"]
        lib.flash_fwd.restype = ctypes.c_int
        for fn in ("read_timeline", "read_passes"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
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


def tile_shares(marks: np.ndarray, passes, design: str):
    """{segment: mean cycles a key tile}, and the key tiles, from one
    warpgroup's marks (rows x marks) under ``design``'s segments; with the
    pass marks (rows x 4), the score products' segment is given by pass
    (and whatever of it lies outside the passes)."""
    spec = DESIGNS[design]
    rows = [r for r in range(ROWS) if marks[r, 0]]
    totals = {name: 0 for name, *_ in spec["segments"]}
    tiles_of = {name: set() for name in totals}
    seen = 0  # rows before this one that hold the tile mark
    for n, r in enumerate(rows):
        phase = "B" if marks[r, 9] else "A"
        tile = seen - (phase == "B")  # an output row follows its tile's mark
        for name, first, last, only in spec["segments"]:
            if only not in (None, phase):
                continue
            if first == "last":  # the row's last mark: after the softmax, or the TMA issue
                first = 8 if marks[r, 8] else 5
            start = marks[r, first]
            end = (marks[rows[n + 1], 0] if n + 1 < len(rows) else 0) if last == "next" \
                else marks[r, last]
            if start and end:
                totals[name] += int(end - start)
                tiles_of[name].add(tile)
        seen += bool(marks[r, spec["tile_mark"]])
    out = {}
    for name in totals:
        mean = totals[name] / len(tiles_of[name]) if tiles_of[name] else 0.0
        if passes is None or name != "score products":
            out[name] = mean
            continue
        n = int(np.count_nonzero(passes[:, 3]))
        for k in range(3):
            out[f"pass {k}"] = float(np.mean(passes[:n, k + 1] - passes[:n, k])) if n else 0.0
        out["score products outside the passes"] = mean - sum(out[f"pass {k}"] for k in range(3))
    return out, seen


def inputs():
    """(q, k, v) at SHAPE, f32, on the card."""
    return cs._qkv(SHAPE, torch.float32, seed=3)


def timeline_means(lib, design: str, args) -> tuple:
    """[(segment means, key tiles) of warpgroup 0, 1] from one marked call
    (after a first, unmarked one), and where warpgroup 1 stands against
    warpgroup 0: its first mark of each of the first 8 rows less warpgroup
    0's (the same SM's clock)."""
    call = runner(lib, *args)
    call()
    torch.cuda.synchronize()
    passes = DESIGNS[design]["passes"]
    if lib.clear_timeline() or (passes and lib.clear_passes()):
        raise RuntimeError("clearing the marks failed")
    call()
    torch.cuda.synchronize()
    marks = np.zeros((2, ROWS, MARKS), dtype=np.int64)
    if lib.read_timeline(marks.ctypes.data):
        raise RuntimeError("read_timeline failed")
    pass_marks = np.zeros((2, 64, 4), dtype=np.int64)
    if passes and lib.read_passes(pass_marks.ctypes.data):
        raise RuntimeError("read_passes failed")
    offsets = [int(marks[1, r, 0] - marks[0, r, 0]) for r in range(8)
               if marks[0, r, 0] and marks[1, r, 0]]
    return ([tile_shares(marks[wg], pass_marks[wg] if passes else None, design) for wg in (0, 1)],
            offsets)


def _sources(tree: str) -> tuple:
    csrc = os.path.join(tree, "torchsnapshot_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "flash_fwd.cu")).read()
    header = open(os.path.join(csrc, "hopper.cuh")).read()
    return csrc, src, header, design_of(src)


def start_shares(tree: str = ROOT) -> dict:
    """Start building ``tree``'s marked copy (nvcc in the background);
    ``shares`` takes the handle."""
    csrc, src, header, design = _sources(tree)
    return {"design": design,
            "procs": start_build({"timeline": marked_sources(src, header, design)}, csrc)}


def shares(handle: dict) -> dict:
    """Each warpgroup's share of a key tile by segment ({"fwd": {"wg0":
    {...}, "wg0_cycles": c, ...}}, as flash_bwd_wide_probe.shares gives
    each kernel's) from the marked copy that ``start_shares`` began to
    build."""
    lib = finish_build(handle["procs"])["timeline"]
    out = {}
    for wg, (seg, n) in enumerate(timeline_means(lib, handle["design"], inputs())[0]):
        tile = sum(seg.values())
        if n and tile:
            out[f"wg{wg}"] = {k: v / tile for k, v in seg.items()}
            out[f"wg{wg}_cycles"] = tile
    return {"fwd": out}


def probe(tree: str) -> dict:
    """Build and run the probe on ``tree``'s source; log its lines and
    return {"design", "us", "wg<w>": {segment: share}}."""
    csrc, src, header, design = _sources(tree)
    timeline, marked_header = marked_sources(src, header, design)
    knocked = {"flash_fwd.cu": timeline, "hopper.cuh": marked_header}
    for file, old, new, count in DESIGNS[design]["knockout"]:
        knocked[file] = (_replace(knocked[file], old, new, count) if file == "hopper.cuh"
                         else _replace_in(knocked[file], old, new, count, KERNEL))
    libs = finish_build(start_build({
        "kernel": (src, header), "timeline": (timeline, marked_header),
        "knockout": (knocked["flash_fwd.cu"], knocked["hopper.cuh"])}, csrc))
    args = inputs()
    want = fa.flash_fwd_reference(*args, causal=True)
    for name in ("kernel", "timeline"):
        err = cs._max_err(runner(libs[name], *args)(), want)
        if err > 1e-5:
            raise SystemExit(f"flash_fwd_wide_probe: {name} is {err:.3g} from the plain version")
    card = cs.card_line()
    stream = torch.cuda.Stream()
    calls = {name: runner(lib, *args) for name, lib in libs.items()}
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    q4, k4, v4 = (t.reshape(8, 8, *SHAPE[1:]) for t in args)

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    calls["sdpa_efficient_fwd"] = sdpa
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
    means = {}
    for name in ("knockout", "timeline"):
        means[name], offsets = timeline_means(libs[name], design, args)
    cs.log("[probe] warpgroup 1's first mark of a row less warpgroup 0's, cycles, rows 0-7: "
           f"{offsets}")
    for wg in (0, 1):
        seg, n = means["timeline"][wg]
        if not n:
            continue
        if DESIGNS[design]["passes"]:
            # Each pass parted by the knock-out: its cycles without the
            # fragment work are the wgmma chains'.
            knocked_seg = means["knockout"][wg][0]
            parted = {}
            for name, cycles in seg.items():
                if name.startswith("pass "):
                    chains = min(knocked_seg[name], cycles)
                    parted[f"{name}: q fragment reads and splits"] = cycles - chains
                    parted[f"{name}: wgmma chains"] = chains
                else:
                    parted[name] = cycles
            seg = parted
        tile = sum(seg.values())
        out[f"wg{wg}"] = {k: v / tile for k, v in seg.items()}
        out[f"wg{wg}_cycles"] = tile
        cs.log(f"[probe] K1 f32 wg{wg} shares of a key tile ({n} tiles, mean {tile:.0f} cycles = "
               f"{tile / mhz:.3f} us at {mhz:.0f} MHz): "
               + "; ".join(f"{k} {v:.0f} ({100 * v / tile:.1f}%)" for k, v in seg.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
    probe(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
