#!/usr/bin/env python3
"""Does TMA take the boxes that K1-K3 issue at head dims under their tile width?

    python3 scripts/tma_oob_probe.py

Needs an NVIDIA Hopper GPU and nvcc; imports torch and the port's build
module, nothing of JAX. The kernels land 64-row tiles whose boxes are 128
bytes wide (64 bf16 or 32 f32 columns) through 3-D tensor maps over
``(d, S, BH)``. At a head dim ``d`` under the tile width, a box reaches
past column ``d`` (bf16 ``d = 16``: one box of 64 columns), and for f32 a
box can lie wholly past it (``d = 16``: the box at column 32). The kernels
rely on three things, which this script checks one box at a time:

- ``cuTensorMapEncodeTiled`` accepts a box wider than the tensor's rows;
- the copy fills every byte of the box past ``d`` (and past ``S``) with
  zeros, a box wholly out of bounds included;
- the copy completes the whole box's bytes on the mbarrier, so a wait on
  the transaction count of full boxes returns (the wait here is bounded:
  a box whose bytes are not counted reads as "timeout", not as a hang).

It builds a small probe (``hopper.cuh``'s ``encode_map`` and
``tma_load_3d``) into ``torchsnapshot_tpu_torch/build/probe/`` with nvcc,
fills shared memory with a sentinel, issues the boxes, and compares what
landed with the swizzled tile made on the host from the same tensor.
Prints one line a case and, last, one JSON object ``{"ok": ..., "cases":
[...]}``; exits 1 if any case fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from torchsnapshot_tpu_torch.ops import _build  # noqa: E402

OUT = os.path.join(_build.BUILD_DIR, "probe")
ROWS, BOX_BYTES = 64, 64 * 128
SENTINEL = 0xAB
MAX_SPINS = 1 << 20

SOURCE = r"""
#include "hopper.cuh"

// One warp: fill the boxes' shared memory with a sentinel, issue n boxes
// of 64 rows x 128 bytes at columns box * col_step from col0, row row0 of
// head bh, wait (bounded) for n * 8192 bytes, copy the boxes out.
__global__ void tma_oob_probe_kernel(const __grid_constant__ CUtensorMap map, int n, int col_step,
                                     int row0, int bh, uint8_t* out, int* status,
                                     long long max_spins) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < n * 8192; i += blockDim.x) tiles[i] = 0xAB;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, n * 8192);
    for (int b = 0; b < n; ++b) tma_load_3d(tiles + b * 8192, &map, &bar, b * col_step, row0, bh);
  }
  const uint32_t addr = smem_u32(&bar);
  uint32_t done = 0;
  long long spins = 0;
  while (!done && spins < max_spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(0u)
        : "memory");
    ++spins;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * 8192; i += blockDim.x) out[i] = tiles[i];
  if (threadIdx.x == 0) status[0] = done ? 1 : 2;
}

extern "C" {

// Returns 0, a cudaError_t, or hopper.cuh's ERR_* code of the encode.
int tma_oob_probe(const void* src, int BH, int S, int d, int f32, int n, int row0, int bh,
                  void* out, int* status) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  CUtensorMap map;
  const CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = hopper::encode_map(encode, &map, src, BH, S, d, type, 64);
  if (err) return err;
  const int smem = n * 8192 + 1024;
  cudaError_t e = cudaFuncSetAttribute(tma_oob_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tma_oob_probe_kernel<<<1, 32, smem>>>(map, n, f32 ? 32 : 64, row0, bh, (uint8_t*)out, status,
                                        (long long)1 << 20);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

const char* tma_oob_probe_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
"""

# (dtype, d, boxes, row0, S): the tile widths the kernels use at d (64
# for d <= 64, 128 above), rows inside S and one tile that runs past it.
CASES = [
    (torch.bfloat16, 16, 1, 0, 100),
    (torch.bfloat16, 8, 1, 64, 100),
    (torch.bfloat16, 72, 2, 0, 100),
    (torch.float32, 16, 2, 0, 100),  # the box at column 32 lies wholly past d
    (torch.float32, 4, 2, 64, 100),
    (torch.float32, 72, 4, 0, 100),  # the box at column 96 lies wholly past d
    (torch.bfloat16, 64, 1, 0, 100),  # the widths that ran before, as a control
    (torch.float32, 128, 4, 0, 100),
]


def build() -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "tma_oob_probe.cu")
    lib = os.path.join(OUT, "tma_oob_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        sys.exit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.tma_oob_probe.argtypes = [P, I, I, I, I, I, I, I, P, P]
    dll.tma_oob_probe.restype = I
    dll.tma_oob_probe_error_string.argtypes = [I]
    dll.tma_oob_probe_error_string.restype = ctypes.c_char_p
    return dll


def expected_boxes(x: torch.Tensor, n: int, row0: int, bh: int) -> torch.Tensor:
    """The bytes the boxes should land: rows row0.. of head bh, 128 bytes a
    row a box, zero past d and S, each 16-byte chunk c of row r at chunk
    position c ^ (r % 8) (128-byte swizzle)."""
    _, S, d = x.shape
    elt = x.element_size()
    cols = 128 // elt
    tile = torch.zeros((ROWS, n * cols), dtype=x.dtype)
    rows = x[bh, row0: row0 + ROWS].cpu()
    tile[: rows.shape[0], :d] = rows
    raw = tile.view(torch.uint8).reshape(ROWS, n, 8, 16).permute(1, 0, 2, 3)
    out = torch.empty_like(raw)
    for r in range(ROWS):
        for c in range(8):
            out[:, r, c ^ (r % 8)] = raw[:, r, c]
    return out.reshape(-1)


def main() -> int:
    if not torch.cuda.is_available():
        print("tma_oob_probe: no CUDA device", file=sys.stderr)
        return 2
    dll = build()
    results, ok = [], True
    for dtype, d, n, row0, S in CASES:
        BH, bh = 2, 1
        gen = torch.Generator().manual_seed(d + n)
        x = (torch.rand((BH, S, d), generator=gen) + 0.5).to(dtype).cuda()  # no zero, no sentinel
        out = torch.empty(n * BOX_BYTES, dtype=torch.uint8, device="cuda")
        status = torch.zeros(1, dtype=torch.int32, device="cuda")
        err = dll.tma_oob_probe(x.data_ptr(), BH, S, d, int(dtype == torch.float32), n, row0, bh,
                                out.data_ptr(), status.data_ptr())
        case = {"dtype": str(dtype)[6:], "d": d, "boxes": n, "row0": row0, "S": S}
        if err:
            case.update(result="refused", error=dll.tma_oob_probe_error_string(err).decode())
        elif int(status.item()) != 1:
            case.update(result="timeout")
        else:
            got = out.cpu()
            want = expected_boxes(x, n, row0, bh)
            bad = int((got != want).sum())
            sentinel = int((got == SENTINEL).sum())
            case.update(result="ok" if bad == 0 else "wrong", bad_bytes=bad,
                        sentinel_bytes=sentinel,
                        zero_bytes=int((want == 0).sum()))
        ok = ok and case["result"] == "ok"
        results.append(case)
        print(f"[tma_oob_probe] {json.dumps(case)}", flush=True)
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0), "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
