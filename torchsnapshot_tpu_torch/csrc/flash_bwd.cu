// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bf16 and f16 on the tensor cores (wgmma fed by TMA; one template,
// the 16-bit element type its parameter), and f32 on the tensor cores too,
// each f32 product as three TF32 products (wgmma fed by TMA, an
// error-compensated split). Past head dim 256 every dtype runs deep forms
// that stream d in chunks, on the tensor cores too: "f32 (3xTF32) past
// head dim 256" and "16-bit (bf16, f16) past head dim 256" below.
//
// Replaces the Pallas TPU kernels of torchsnapshot_tpu/ops/pallas_attention.py:
//   - `_bwd_dq_kernel` (lines 94-143, called at line 263) by
//     flash_bwd_dq_wgmma_kernel (bf16) and flash_bwd_dq_tf32_kernel (f32),
//     past 256 flash_bwd_dq_wgmma_deep_kernel and flash_bwd_dq_tf32_deep_kernel;
//   - `_bwd_dkv_kernel` (lines 146-200, called at line 278) by
//     flash_bwd_dkv_wgmma_kernel (bf16) and flash_bwd_dkv_tf32_kernel (f32),
//     past 256 flash_bwd_dkv_wgmma_deep_kernel and flash_bwd_dkv_tf32_deep_kernel.
// Same function, from the forward's GLOBAL per-row statistics (lse from the
// forward, delta = rowsum(dO * o) from the caller):
//   s  = scale * (q . k^T)          (scaled after the dot, as the TPU kernels
//                                    do; the forward pre-scales q instead)
//   s  = NEG_INF where masked       (causal: q_pos >= k_pos attends, a tie
//                                    attends; keys past S never attend)
//   p  = exp(s - lse)               (masked entries underflow to 0)
//   ds = p * (dO . v^T - delta)
//   dq = scale * sum_k ds . k,  dk = scale * sum_q ds^T . q,  dv = sum_q p^T . dO
// Because p comes from the global lse, the gradients are exact for any
// subset of the keys that made lse: ring attention drives these kernels per
// hop on the k/v it holds.
// Layout: q, k, v, dO, dq, dk, dv contiguous (BH, S, D) in one dtype; lse
// and delta contiguous (BH, S) f32.
// Head dims: as the forward (flash_fwd.cu, "Head dims"): the kernels take
// every d whose row is a multiple of 16 bytes (the wrapper pads any other
// d), up to 256 at tile width W = 64 (d <= 64),
// 128 (d <= 128) or 256 with d a runtime argument. TMA lands zeros in
// columns d..W-1 of every tile, which add exactly zero to Q K^T and dO
// V^T; the columns past d of dS K, P^T dO and dS^T Q come out zero and are
// not stored (dq, dk and dv are written with row stride d, columns below d
// only). At W = 256 the bf16 kernels run two warpgroups: the dq kernel's
// each compute the whole S and dP tiles and own 128 columns of dq; the
// dk/dv kernel is one of its own (flash_bwd_dkv_wgmma_wide_kernel), its
// warpgroups parting the products (S^T and dV in one, dP^T and dK in the
// other): at BH 64, S 128, d 256, causal (bound 7.532 us by bytes) it
// takes 10.5-11.3 us by the CUDA-graph timer, where the first form, both
// warpgroups over the whole S^T and dP^T tiles, took 15.2-15.7; with dq's
// 11.5-11.8 under cuDNN's backward, 33.1-34.6 (scripts/flash_tree_times.py,
// scripts/flash_bf16_wide_probe.py, NVIDIA H100 80GB HBM3, 700.00 W). The
// f32 forms there are kernels of their own ("f32 (3xTF32) at tile width
// 256").
//
// The TPU split is kept: dq is gridded over q tiles and streams K/V; dk/dv
// is gridded over k tiles and streams Q/dO. Each output tile is owned by one
// block and its products are summed in a fixed order, so there are no
// atomics and a run is bit-reproducible (a resumed training step repeats
// bit for bit). Output tiles are the kernels' own, 64 rows: S need not be a
// multiple of 64; rows past S load as zeros (dO, lse and delta too) and are
// masked, and the causal loop bounds are computed on these tiles, not on
// the caller's blocks.
//
// Bound at the training shape (BH=32, S=256, D=64, bf16, causal): dq reads
// q, k, v, dO (4.19 MB) and lse, delta (65.5 KB) and writes dq (1.05 MB),
// about 1.58 us at 3.35 TB/s; dk/dv writes two outputs, about 1.90 us. The
// causal dots are 3 (dq) and 4 (dk/dv) products of 2*D flop over 1,052,672
// attended pairs, 0.40 and 0.54 GFLOP, under 0.6 us at the 989 TFLOP/s bf16
// tensor-core peak. Both are bound by bytes and, at this size, by latency.
// The first design (FFMA for both dtypes) took 53.0-53.3 us (dq) and
// 59.7-60.2 us (dk/dv) of device time there; this design takes 5.75 us and
// 8.60 us (chip_smoke phase 8, H100 80GB HBM3, 700.00 W).
//
// bf16 design: one warpgroup (128 threads) per (bh, 64-row output tile),
// built from hopper.cuh as the forward is. Every product is a wgmma
// m64nNk16 with f32 accumulators; no operand is transposed in shared memory.
//   - Loads: TMA copies 64-row boxes (3-D tensor maps over (D, S, BH),
//     128-byte swizzle, zero fill past S). The block's own tiles land once;
//     the streamed tiles go through a two-stage ring: one thread issues
//     tile t+1 while the warpgroup computes tile t, mbarriers with
//     transaction counts say when a stage has landed, and per-stage "free"
//     mbarriers (one arrival per warp) when every warp is done with it. No
//     block-wide barrier runs in the loop.
//   - dq (flash_bwd_dq_wgmma_kernel): Q and dO land once, K and V stream.
//     S = Q K^T and dP = dO V^T are SS products (both operands K-major);
//     P and dS are computed on the accumulator fragment with each thread's
//     two rows' lse and delta in registers; dQ += dS K is an RS product,
//     dS repacked in registers to bf16 A fragments and K read MN-major (as
//     the forward reads V). Causal programs stop after the diagonal K tile,
//     and the q tiles that walk the most K tiles launch first.
//   - dk/dv (flash_bwd_dkv_wgmma_kernel): K and V land once, Q and dO
//     stream. The scores are computed transposed: S^T = K Q^T and
//     dP^T = V dO^T (SS, the resident tile as A), so P^T and dS^T are
//     accumulator fragments that repack to the A fragments of
//     dV += P^T dO and dK += dS^T Q (RS, dO and Q read MN-major). lse and
//     delta are indexed by the fragment's column here, so warp 0 copies each
//     q tile's 64 values of both into shared memory beside the tile (plain
//     loads: a (BH, S) f32 row is 4 S bytes, not the multiple of 16 a TMA
//     stride needs). Causal programs start at the q tile that holds the k
//     tile's diagonal; k tile 0, the heaviest, launches first.
// Rounding: the products run on the unscaled bf16 or f16 inputs (their
// products are exact in f32) and the f32 scores are scaled after. P and dS
// are rounded to the 16-bit type to be the A operands of the last products,
// which the TPU kernels and the f32 design do not do; the tests hold these
// kernels to a plain recompute that rounds P and dS the same way. f16
// rounds scale dS in place of dS (ds_scales): under a loss-scaled dO (2^12)
// dS alone comes within reach of f16's 65,504 (chip_smoke phase 2 logs its
// maximum at d = 64 and 256), scale dS d^0.5 times under it.
//
// f32 design (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel), the
// redesign of the FFMA kernels of the first design, which took 52.23 us
// (dq) and 60.28 us (dk/dv) by the CUDA-graph timer at the training shape
// in f32, 6.0% and 6.3% of their bounds (chip_smoke phase 8, NVIDIA H100
// 80GB HBM3, 700.00 W, 1980 MHz).
//   - Bound (BH=32, S=256, D=64, f32, causal): dq moves 10,551,296 B, 3.150
//     us at 3.35 TB/s, dk/dv 12,648,448 B, 3.776 us; their 0.40 and 0.54
//     GFLOP as three TF32 products take 2.449 and 3.267 us at 495 TFLOP/s.
//     Bound by bytes. No FFMA kernel can go under 6.03 and 8.04 us, the
//     flops at the 67 TFLOP/s of the f32 pipe.
//   - Precision: each A B is A_lo B_hi + A_hi B_lo + A_hi B_hi into one f32
//     accumulator, small terms first, with hi = cvt.rna.tf32(x) and lo =
//     cvt.rna.tf32(x - hi): every product of two tf32 values is exact in
//     f32 and the dropped A_lo B_lo is 2^-22 of the product. A CPU
//     emulation at BH=8, S=256, D=64, causal, unit inputs, against f64 gave
//     max errors o 7.3e-7, lse 5.2e-7, dq 9.0e-7, dk 1.9e-6 and dv 4.7e-6,
//     as f32 itself does (8.4e-7 to 2.8e-6), where one TF32 product gives
//     5.5e-4 to 1.8e-3: the f32 bars (1e-5 forward, 1e-4 gradients) hold
//     6-40x over. tests/test_torch_flash_tf32.py holds the split to
//     cvt.rna bit for bit and its emulated backward to the JAX package's.
//   - Layout: wgmma takes tf32 only with both operands K-major. S = Q K^T
//     and dP = dO V^T (dq), S^T = K Q^T and dP^T = V dO^T (dk/dv) read both
//     operands as they land. The products over rows, dQ += dS K, dV += P^T
//     dO and dK += dS^T Q, read K, dO and Q from transposed copies that the
//     split pass writes, and take their A operand from registers.
//   - The split: TMA lands f32 tiles (32-column boxes of 128 bytes, 128-byte
//     swizzle, zero fill past S); one pass of the block's 128 threads, 16
//     bytes a step, rounds each tile into hi and lo tiles of the same
//     layout (and the transposed copies), then fence.proxy.async and a
//     block barrier hand them to wgmma. P, dS (dq) and P^T, dS^T (dk/dv)
//     split in registers into A fragments. An accumulator gives a thread
//     columns 2c and 2c + 1 of each 8-column chunk where a tf32 A fragment
//     wants c and c + 4; instead of moving values between threads, the
//     transposed copies store their columns in that order (perm8), so the
//     sums pair the right terms (accum_to_tf32_a; the card tests check the
//     path alone).
//   - Shared memory (227 KB a block): at W = 64 a streamed 64-row tile lands
//     in a raw stage while the split tiles of the one before are in use
//     (the TMA of tile t+1 runs under the products of tile t): dq 197,632
//     B, dk/dv 230,400 B. At W = 128 that does not fit: one stage, each
//     streamed tile split in place, of 32 rows for dq and 16 for dk/dv
//     (230,400 B each).
//   - Sums: each tile's product goes to a fresh accumulator, added to the
//     running output in f32 (wgmma's own adds are not rounded to nearest:
//     adding each tile into one accumulator left dk and dv 4-7x further
//     from f64 than the f32 plain version at S = 512, causal).
//   - Grid: one warpgroup per (bh, 64-row output tile), the heaviest causal
//     tile first as in bf16; at 197-230 KB an SM holds one block, so the
//     training shape's 128 blocks take 128 of the 132 SMs, one wave.
//   This design takes 17.25-17.46 us (dq) and 23.48-23.62 us (dk/dv) by the
//   graph timer there, 18% and 16% of the bounds, the pair 0.53-0.54 of
//   SDPA's f32 backward (efficient backend, 3xTF32 on mma.sync) (chip_smoke
//   phase 8, NVIDIA H100 80GB HBM3, 700.00 W).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // k rows per tile
constexpr int NT = 128;  // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16

template <int W>
constexpr int wgmma_smem_bytes() {
  // Two resident tiles, two stages of two streamed tiles, and slack to
  // align the base to 1024.
  return 6 * 64 * W * 2 + 1024;
}

// Rows r_lo and r_lo + 8 of a 64 x W f32 accumulator fragment, times
// `mul`, as T (bf16 or f16) into rows row0 + r_lo (+ 8), columns col0.. of
// a (S, d) tensor, columns below d (d even, so a column pair is stored
// whole or not at all); rows past S are not stored.
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[W / 2],
                                           float mul, int row0, int r_lo, int c2, int S, int d,
                                           int col0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_lo + 8 * h;
    if (row >= S) continue;
    T* orow = out + (size_t)row * d + col0;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (col0 + 8 * j + c2 < d)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + c2) =
            hopper::pack16<T>(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// Where the softmax scale multiplies dS in the 16-bit kernels: bf16 rounds
// dS as it is and scales dQ and dK in f32 at the end; f16 rounds scale dS
// (the scale folded in first), so that a loss-scaled gradient keeps
// 1 / scale = d^0.5 more headroom under f16's largest value, 65,504 (bf16
// has f32's range). Returns (the factor on dS, the factor on dQ and dK).
template <typename T>
__device__ __forceinline__ float2 ds_scales(float scale) {
  return hopper::Elem16<T>::F16 ? make_float2(scale, 1.f) : make_float2(1.f, scale);
}

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(NT * hopper::warpgroups<W>())
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int S, int d, float scale) {
  using namespace hopper;
  constexpr int TILE = 64 * W * 2;  // bytes of one 64-row tile
  constexpr int NWG = hopper::warpgroups<W>();
  constexpr int OW = W / NWG;  // dq columns of a warpgroup

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg, bar_kv[2], bar_free[2];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Gs = Qs + TILE;      // dO
  uint8_t* Ks = Qs + 2 * TILE;  // two stages
  uint8_t* Vs = Qs + 4 * TILE;  // two stages

  // The warp's place in its warpgroup, and the warpgroup: at W = 256 both
  // compute the whole S and dP tiles (the same values, in the same order)
  // and each the dS K product of its 128 dq columns.
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = NWG == 1 ? tid / 32 : (tid / 32) % 4;
  const int wg = NWG == 1 ? 0 : tid / NT;
  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BN - 1) / BN;
  if (CAUSAL) {
    // K tiles wholly above the diagonal are skipped (pallas_attention.py:113-117).
    n_tiles = min((min(m0 + BM, S) + BN - 1) / BN, n_tiles);
  }

  auto load_kv = [&](int t) {
    const int s = t & 1;
    mbar_arrive_expect_tx(&bar_kv[s], 2 * TILE);
    tma_tile<W>(Ks + s * TILE, &tk, &bar_kv[s], t * BN, bh);
    tma_tile<W>(Vs + s * TILE, &tv, &bar_kv[s], t * BN, bh);
  };

  if (tid == 0) {
    mbar_init(&bar_qg, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_kv[s], 1);
      mbar_init(&bar_free[s], NWG * NT / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar_qg, 2 * TILE);
    tma_tile<W>(Qs, &tq, &bar_qg, m0, bh);
    tma_tile<W>(Gs, &tg, &bar_qg, m0, bh);
    load_kv(0);
    if (n_tiles > 1) load_kv(1);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator; its rows' lse (in
  // log2 units) and delta, 0 past S (those rows are not stored).
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r_lo + 8 * h;
    lse2[h] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
    dlt[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  const float2 mul = ds_scales<T>(scale);
  float acc[OW / 2];
#pragma unroll
  for (int i = 0; i < OW / 2; ++i) acc[i] = 0.f;
  const uint32_t q_base = smem_u32(Qs), g_base = smem_u32(Gs);
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  // This warpgroup's columns of K, the B operand of dS K.
  const uint32_t kc_base = k_base + wg * (OW / 64) * 64 * 128;
  mbar_wait(&bar_qg, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    if (tid == 0 && t >= 1 && t + 1 < n_tiles) {
      // Stage s^1 held tile t-1: once every warp is done with it, load t+1.
      mbar_wait(&bar_free[s ^ 1], ((t - 1) >> 1) & 1);
      load_kv(t + 1);
    }
    __syncwarp();

    // S = Q K^T and dP = dO V^T, two groups so P starts while dP runs.
    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    mbar_wait(&bar_kv[s], parity);
    fence_operands(sacc);
    fence_operands(pacc);
    wgmma_fence();
    wgmma_ss_tiles<T, W>(sacc, q_base, k_base + s * TILE);
    wgmma_commit();
    wgmma_ss_tiles<T, W>(pacc, g_base, v_base + s * TILE);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sacc);

    // P = exp(scale * S - lse) on the fragment, 0 where masked.
    const int k0 = t * BN;
    const bool edge = k0 + BN > S || (CAUSAL && k0 + BN > m0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(sacc[i], scale2, -lse2[h]));
      if (edge) {
        const int q_pos = m0 + r_lo + 8 * h;
        const int k_pos = k0 + 8 * (i >> 2) + c2 + (i & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) p = 0.f;
      }
      sacc[i] = p;
    }
    wgmma_wait<0>();
    fence_operands(pacc);
    // dS = P (dP - delta) (times mul.x), as the A fragments of four k16
    // steps over this tile's 64 keys.
#pragma unroll
    for (int i = 0; i < 32; ++i) pacc[i] = sacc[i] * (pacc[i] - dlt[(i >> 1) & 1]) * mul.x;
    uint32_t da[4][4];
    accum_to_a<T>(pacc, da);

    // dQ += dS K over the tile's keys.
    fence_operands(acc);
    wgmma_fence();
    wgmma_rs_tile<T, OW>(acc, da, kc_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_fragments(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[s]);
  }

  store_rows<T, OW>(dq + (size_t)bh * S * d, acc, mul.y, m0, r_lo, c2, S, d, wg * OW);
}

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           int S, int d, float scale) {
  using namespace hopper;
  constexpr int TILE = 64 * W * 2;  // bytes of one 64-row tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[2], bar_free[2];
  // Each stage's q tile: lse (in log2 units) and delta by column, 0 past S.
  __shared__ __align__(8) float lse2_s[2][BM], dlt_s[2][BM];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Ks + 2 * TILE;  // two stages
  uint8_t* Gs = Ks + 4 * TILE;  // dO, two stages

  // Warp 0 loads the stages.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // k tile 0 walks the most causal q tiles and launches first.
  const int n0 = blockIdx.y * BN;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt0 = CAUSAL ? n0 / BM : 0;
  const int n_tiles = (S + BM - 1) / BM - qt0;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* dlt_bh = delta + (size_t)bh * S;

  // Run by every lane of warp 0: lane 0 issues the Q and dO tiles of step
  // t; the lanes copy the tile's lse and delta, then each arrives on the
  // stage's barrier (count 1 + 32), which releases their stores to the
  // warps that wait on it.
  auto load_q = [&](int t) {
    const int s = t & 1, m = (qt0 + t) * BM;
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar_full[s], 2 * TILE);
      tma_tile<W>(Qs + s * TILE, &tq, &bar_full[s], m, bh);
      tma_tile<W>(Gs + s * TILE, &tg, &bar_full[s], m, bh);
    }
    for (int i = lane; i < BM; i += 32) {
      const int row = m + i;
      lse2_s[s][i] = row < S ? lse_bh[row] * LOG2E : 0.f;
      dlt_s[s][i] = row < S ? dlt_bh[row] : 0.f;
    }
    mbar_arrive(&bar_full[s]);
  };

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_full[s], 1 + 32);
      mbar_init(&bar_free[s], NT / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar_kv, 2 * TILE);
      tma_tile<W>(Ks, &tk, &bar_kv, n0, bh);
      tma_tile<W>(Vs, &tv, &bar_kv, n0, bh);
    }
    load_q(0);
    if (n_tiles > 1) load_q(1);
  }

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  const float2 mul = ds_scales<T>(scale);
  float dk_acc[W / 2], dv_acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  const uint32_t q_base = smem_u32(Qs), g_base = smem_u32(Gs);
  mbar_wait(&bar_kv, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    if (tid < 32 && t >= 1 && t + 1 < n_tiles) {
      // Stage s^1 held step t-1: once every warp is done with it, load t+1.
      mbar_wait(&bar_free[s ^ 1], ((t - 1) >> 1) & 1);
      load_q(t + 1);
    }
    __syncwarp();

    // S^T = K Q^T and dP^T = V dO^T, two groups so P^T starts while dP^T runs.
    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    mbar_wait(&bar_full[s], parity);
    fence_operands(sacc);
    fence_operands(pacc);
    wgmma_fence();
    wgmma_ss_tiles<T, W>(sacc, k_base, q_base + s * TILE);
    wgmma_commit();
    wgmma_ss_tiles<T, W>(pacc, v_base, g_base + s * TILE);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sacc);

    // P^T = exp(scale * S^T - lse) on the fragment, lse by column, 0 where
    // masked.
    const int m0 = (qt0 + t) * BM;
    const bool edge = m0 + BM > S || n0 + BN > S || (CAUSAL && m0 < n0 + BN);
    const float* lse2_t = lse2_s[s];
    const float* dlt_t = dlt_s[s];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + c2 + (i & 1);
      float p = exp2f(fmaf(sacc[i], scale2, -lse2_t[col]));
      if (edge) {
        const int k_pos = n0 + r_lo + 8 * ((i >> 1) & 1);
        const int q_pos = m0 + col;
        bool keep = q_pos < S && k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) p = 0.f;
      }
      sacc[i] = p;
    }
    wgmma_wait<0>();
    fence_operands(pacc);
    // dS^T = P^T (dP^T - delta) (times mul.x); both as the A fragments of
    // four k16 steps over this step's 64 q rows.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + c2 + (i & 1);
      pacc[i] = sacc[i] * (pacc[i] - dlt_t[col]) * mul.x;
    }
    uint32_t pa[4][4], da[4][4];
    accum_to_a<T>(sacc, pa);
    accum_to_a<T>(pacc, da);

    // dV += P^T dO and dK += dS^T Q over the step's q rows.
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    wgmma_fence();
    wgmma_rs_tile<T, W>(dv_acc, pa, g_base + s * TILE);
    wgmma_rs_tile<T, W>(dk_acc, da, q_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    fence_fragments(pa);
    fence_fragments(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[s]);
  }

  const size_t base = (size_t)bh * S * d;
  store_rows<T, W>(dk + base, dk_acc, mul.y, n0, r_lo, c2, S, d, 0);
  store_rows<T, W>(dv + base, dv_acc, 1.f, n0, r_lo, c2, S, d, 0);
}

// ------------------------------------------------------------ f32 (3xTF32)

constexpr int TF32_NT = 128;  // one warpgroup

// Rows r_lo and r_lo + 8 of a 64 x W f32 accumulator fragment, times `mul`,
// into rows row0 + r_lo (+ 8), columns col0.. of a (S, d) f32 tensor,
// columns below d (d even); rows past S are not stored.
template <int W>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out, const float (&acc)[W / 2],
                                               float mul, int row0, int r_lo, int c2, int S, int d,
                                               int col0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_lo + 8 * h;
    if (row >= S) continue;
    float* orow = out + (size_t)row * d + col0;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (col0 + 8 * j + c2 < d)
        *reinterpret_cast<float2*>(orow + 8 * j + c2) =
            make_float2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// Shared memory of the tf32 kernels: the block's own 64-row tiles (hi and
// lo of two operands), the streamed tiles of ROWS rows (hi and lo of two
// operands, the hi and lo transposed copies of N_T of them and, with RING,
// two raw landing tiles), and slack to align the base to 1024.
template <int W, int ROWS, int N_T, bool RING>
constexpr int tf32_smem_bytes() {
  return 4 * 64 * W * 4 + (RING ? 6 : 4) * ROWS * W * 4 +
         2 * N_T * hopper::transposed_bytes<ROWS, W>() + 1024;
}

// Streamed rows per tile and the landing stage by tile width: at W = 64 a
// 64-row tile lands in a raw stage while the split tiles of the one before
// are in use; at W = 128 that does not fit in 227 KB, so one stage is split
// in place and the streamed tiles shrink (32 rows for dq, 16 for dk/dv).
template <int W>
struct Tf32Tiles {
  static constexpr bool RING = W == 64;
  static constexpr int DQ_ROWS = W == 64 ? 64 : 32;
  static constexpr int DKV_ROWS = W == 64 ? 64 : 16;
};

template <int W, int BK, bool RING, bool CAUSAL>
__global__ void __launch_bounds__(TF32_NT)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int S, int d, float scale) {
  using namespace hopper;
  constexpr int QT = 64 * W * 4;                      // bytes of a q or dO tile
  constexpr int KT = BK * W * 4;                      // bytes of a k or v tile
  constexpr int KTT = transposed_bytes<BK, W>();       // bytes of k's transposed copy
  constexpr int Q_BOX = 64 * 128, K_BOX = BK * 128, KT_BOX = W * 128;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg, bar_kv;
  uint8_t* Qh = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ql = Qh + QT;
  uint8_t* Gh = Ql + QT;  // dO
  uint8_t* Gl = Gh + QT;
  uint8_t* Kh = Gl + QT;
  uint8_t* Kl = Kh + KT;
  uint8_t* Vh = Kl + KT;
  uint8_t* Vl = Vh + KT;
  uint8_t* KTh = Vl + KT;  // k transposed: W rows x BK columns
  uint8_t* KTl = KTh + KTT;
  // Where TMA lands k and v: a raw stage of their own, or their hi tiles.
  uint8_t* Kr = RING ? KTl + KTT : Kh;
  uint8_t* Vr = RING ? Kr + KT : Vh;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * 64;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // K tiles wholly above the diagonal are skipped (pallas_attention.py:113-117).
    n_tiles = min((min(m0 + 64, S) + BK - 1) / BK, n_tiles);
  }
  auto load_kv = [&](int t) {
    mbar_arrive_expect_tx(&bar_kv, 2 * KT);
    tma_tile_f32<W, BK>(Kr, &tk, &bar_kv, t * BK, bh);
    tma_tile_f32<W, BK>(Vr, &tv, &bar_kv, t * BK, bh);
  };

  if (tid == 0) {
    mbar_init(&bar_qg, 1);
    mbar_init(&bar_kv, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar_qg, 2 * QT);
    tma_tile_f32<W, 64>(Qh, &tq, &bar_qg, m0, bh);
    tma_tile_f32<W, 64>(Gh, &tg, &bar_qg, m0, bh);
    load_kv(0);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator; its rows' lse (in
  // log2 units) and delta, 0 past S (those rows are not stored).
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r_lo + 8 * h;
    lse2[h] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
    dlt[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  mbar_wait(&bar_qg, 0);
  split_tile<64, W, false>(Qh, Qh, Ql, nullptr, nullptr);
  split_tile<64, W, false>(Gh, Gh, Gl, nullptr, nullptr);
  const uint32_t qh = smem_u32(Qh), ql = smem_u32(Ql), gh = smem_u32(Gh), gl = smem_u32(Gl);
  const uint32_t kh = smem_u32(Kh), kl = smem_u32(Kl), vh = smem_u32(Vh), vl = smem_u32(Vl);
  const uint32_t kth = smem_u32(KTh), ktl = smem_u32(KTl);

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&bar_kv, t & 1);
    split_tile<BK, W, true>(Kr, Kh, Kl, KTh, KTl);
    split_tile<BK, W, false>(Vr, Vh, Vl, nullptr, nullptr);
    fence_proxy_async();
    __syncthreads();
    if (RING && tid == 0 && t + 1 < n_tiles) load_kv(t + 1);  // lands while tile t computes

    // S = Q K^T and dP = dO V^T, two groups so P starts while dP runs.
    float sacc[BK / 2], pacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = pacc[i] = 0.f;
    fence_operands(sacc);
    fence_operands(pacc);
    wgmma_fence();
    wgmma_3xtf32_ss<BK, W, Q_BOX, K_BOX>(sacc, qh, ql, kh, kl);
    wgmma_commit();
    wgmma_3xtf32_ss<BK, W, Q_BOX, K_BOX>(pacc, gh, gl, vh, vl);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sacc);

    // P = exp(scale * S - lse) on the fragment, 0 where masked.
    const int k0 = t * BK;
    const bool edge = k0 + BK > S || (CAUSAL && k0 + BK > m0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(sacc[i], scale2, -lse2[h]));
      if (edge) {
        const int q_pos = m0 + r_lo + 8 * h;
        const int k_pos = k0 + 8 * (i >> 2) + c2 + (i & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) p = 0.f;
      }
      sacc[i] = p;
    }
    wgmma_wait<0>();
    fence_operands(pacc);
    // dS = P (dP - delta), split into the A fragments of BK / 8 k8 steps.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) pacc[i] = sacc[i] * (pacc[i] - dlt[(i >> 1) & 1]);
    uint32_t dh[BK / 8][4], dl[BK / 8][4];
    accum_to_tf32_a<BK>(pacc, dh, dl);

    // dQ += dS K over the tile's keys, K read from its transposed copy; the
    // tile's product sums in a fresh accumulator that is then added to dQ
    // in f32 (see the dk/dv kernel).
    float part[W / 2] = {};
    fence_operands(part);
    wgmma_fence();
    wgmma_3xtf32_rs<W, BK, KT_BOX>(part, dh, dl, kth, ktl);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(part);
    fence_fragments(dh);
    fence_fragments(dl);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] += part[i];
    __syncthreads();  // every warp is done with the split tiles (and, in place, the landing ones)
    if (!RING && tid == 0 && t + 1 < n_tiles) load_kv(t + 1);
  }

  store_rows_f32<W>(dq + (size_t)bh * S * d, acc, scale, m0, r_lo, c2, S, d);
}

template <int W, int BQ, bool RING, bool CAUSAL>
__global__ void __launch_bounds__(TF32_NT)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int d,
                          float scale) {
  using namespace hopper;
  constexpr int KT = 64 * W * 4;                      // bytes of a k or v tile
  constexpr int QT = BQ * W * 4;                      // bytes of a q or dO tile
  constexpr int QTT = transposed_bytes<BQ, W>();       // bytes of a transposed q or dO copy
  constexpr int K_BOX = 64 * 128, Q_BOX = BQ * 128, QT_BOX = W * 128;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_q;
  // The q tile's lse (in log2 units) and delta by column, 0 past S.
  __shared__ float lse2_s[BQ], dlt_s[BQ];
  uint8_t* Kh = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Kl = Kh + KT;
  uint8_t* Vh = Kl + KT;
  uint8_t* Vl = Vh + KT;
  uint8_t* Qh = Vl + KT;
  uint8_t* Ql = Qh + QT;
  uint8_t* Gh = Ql + QT;  // dO
  uint8_t* Gl = Gh + QT;
  uint8_t* QTh = Gl + QT;  // q transposed: W rows x BQ columns
  uint8_t* QTl = QTh + QTT;
  uint8_t* GTh = QTl + QTT;  // dO transposed
  uint8_t* GTl = GTh + QTT;
  uint8_t* Qr = RING ? GTl + QTT : Qh;
  uint8_t* Gr = RING ? Qr + QT : Gh;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // k tile 0 walks the most causal q tiles and launches first.
  const int n0 = blockIdx.y * 64;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt0 = CAUSAL ? n0 / BQ : 0;
  const int n_tiles = (S + BQ - 1) / BQ - qt0;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* dlt_bh = delta + (size_t)bh * S;
  auto load_q = [&](int t) {
    const int m = (qt0 + t) * BQ;
    mbar_arrive_expect_tx(&bar_q, 2 * QT);
    tma_tile_f32<W, BQ>(Qr, &tq, &bar_q, m, bh);
    tma_tile_f32<W, BQ>(Gr, &tg, &bar_q, m, bh);
  };

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    mbar_init(&bar_q, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar_kv, 2 * KT);
    tma_tile_f32<W, 64>(Kh, &tk, &bar_kv, n0, bh);
    tma_tile_f32<W, 64>(Vh, &tv, &bar_kv, n0, bh);
    load_q(0);
  }

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator. Threads
  // below BQ fetch one q row's lse and delta a step ahead.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  auto fetch_stats = [&](int t, float& l2, float& d) {
    const int row = (qt0 + t) * BQ + tid;
    l2 = row < S ? lse_bh[row] * LOG2E : 0.f;
    d = row < S ? dlt_bh[row] : 0.f;
  };
  float next_l2 = 0.f, next_d = 0.f;
  if (tid < BQ) fetch_stats(0, next_l2, next_d);
  float dk_acc[W / 2], dv_acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(&bar_kv, 0);
  split_tile<64, W, false>(Kh, Kh, Kl, nullptr, nullptr);
  split_tile<64, W, false>(Vh, Vh, Vl, nullptr, nullptr);
  const uint32_t kh = smem_u32(Kh), kl = smem_u32(Kl), vh = smem_u32(Vh), vl = smem_u32(Vl);
  const uint32_t qh = smem_u32(Qh), ql = smem_u32(Ql), gh = smem_u32(Gh), gl = smem_u32(Gl);
  const uint32_t qth = smem_u32(QTh), qtl = smem_u32(QTl), gth = smem_u32(GTh), gtl = smem_u32(GTl);

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&bar_q, t & 1);
    split_tile<BQ, W, true>(Qr, Qh, Ql, QTh, QTl);
    split_tile<BQ, W, true>(Gr, Gh, Gl, GTh, GTl);
    if (tid < BQ) {
      lse2_s[tid] = next_l2;
      dlt_s[tid] = next_d;
      if (t + 1 < n_tiles) fetch_stats(t + 1, next_l2, next_d);
    }
    fence_proxy_async();
    __syncthreads();
    if (RING && tid == 0 && t + 1 < n_tiles) load_q(t + 1);  // lands while step t computes

    // S^T = K Q^T and dP^T = V dO^T, two groups so P^T starts while dP^T runs.
    float sacc[BQ / 2], pacc[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sacc[i] = pacc[i] = 0.f;
    fence_operands(sacc);
    fence_operands(pacc);
    wgmma_fence();
    wgmma_3xtf32_ss<BQ, W, K_BOX, Q_BOX>(sacc, kh, kl, qh, ql);
    wgmma_commit();
    wgmma_3xtf32_ss<BQ, W, K_BOX, Q_BOX>(pacc, vh, vl, gh, gl);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sacc);

    // P^T = exp(scale * S^T - lse) on the fragment, lse by column, 0 where
    // masked.
    const int m0 = (qt0 + t) * BQ;
    const bool edge = m0 + BQ > S || n0 + 64 > S || (CAUSAL && m0 < n0 + 64);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = 8 * (i >> 2) + c2 + (i & 1);
      float p = exp2f(fmaf(sacc[i], scale2, -lse2_s[col]));
      if (edge) {
        const int k_pos = n0 + r_lo + 8 * ((i >> 1) & 1);
        const int q_pos = m0 + col;
        bool keep = q_pos < S && k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) p = 0.f;
      }
      sacc[i] = p;
    }
    wgmma_wait<0>();
    fence_operands(pacc);
    // dS^T = P^T (dP^T - delta).
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = 8 * (i >> 2) + c2 + (i & 1);
      pacc[i] = sacc[i] * (pacc[i] - dlt_s[col]);
    }

    // dV += P^T dO, then dK += dS^T Q, dO and Q read from their transposed
    // copies; one product's fragments at a time. Each step's product sums
    // in a fresh accumulator that is then added to the running one in f32:
    // wgmma's adds into its accumulator are not rounded to nearest, and a
    // causal k tile's first q tile brings its largest terms (p near 1 on
    // the diagonal), so adding the many small later ones straight into
    // that sum left dv 3.9e-5 from f64 at S = 512, D = 64 on the card,
    // where the f32 plain version is 6.0e-6 from it; summed per step, 4.0e-6.
    float part[W / 2] = {};
    {
      uint32_t ah[BQ / 8][4], al[BQ / 8][4];
      accum_to_tf32_a<BQ>(sacc, ah, al);
      fence_operands(part);
      wgmma_fence();
      wgmma_3xtf32_rs<W, BQ, QT_BOX>(part, ah, al, gth, gtl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      fence_fragments(ah);
      fence_fragments(al);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) dv_acc[i] += part[i];
    }
    {
      uint32_t ah[BQ / 8][4], al[BQ / 8][4];
      accum_to_tf32_a<BQ>(pacc, ah, al);
      fence_operands(part);
      wgmma_fence();
      wgmma_3xtf32_rs<W, BQ, QT_BOX>(part, ah, al, qth, qtl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      fence_fragments(ah);
      fence_fragments(al);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) dk_acc[i] += part[i];
    }
    __syncthreads();  // every warp is done with the split tiles and the stats
    if (!RING && tid == 0 && t + 1 < n_tiles) load_q(t + 1);
  }

  const size_t base = (size_t)bh * S * d;
  store_rows_f32<W>(dk + base, dk_acc, scale, n0, r_lo, c2, S, d);
  store_rows_f32<W>(dv + base, dv_acc, 1.f, n0, r_lo, c2, S, d);
}

// ------------------------------------------ f32 (3xTF32) at tile width 256
//
// At W = 256 (128 < d <= 256) a 64-row f32 tile takes 64 KB, its hi and
// lo 128 KB: resident split operands would fill shared memory, and one
// warpgroup's outputs would take 128 (dq) or 256 (dk and dv) accumulator
// registers a thread. So every operand streams in chunks of 32 columns of
// d (one TMA box), split where it is used, and the work parts by product:
//   - two warpgroups, each a pipeline of its own: a ring of landing slots
//     that one of its threads refills by TMA once the warpgroup is done
//     with a slot (after issuing the chunk's products), and two split
//     slots, so that it splits chunk i while the tensor cores run chunk
//     i - 1's products; one barrier of the warpgroup a chunk;
//   - the score products (dq: S = Q K^T in warpgroup 0, dP = dO V^T in
//     warpgroup 1, 64-key tiles; dk/dv: S^T = K Q^T and dP^T = V dO^T,
//     32-row q tiles) run over the chunks below d, both operands of a
//     chunk split into hi and lo in shared memory and read by wgmma from
//     there (hopper.cuh wgmma_3xtf32_chunk): the small terms chain over
//     the chunks, each chunk's large terms sum fresh and are added in f32;
//   - one exchange a tile, through shared memory in fragment order (each
//     thread reads back the slots of its own fragment): dq hands P to
//     warpgroup 1, which returns dS; dk/dv hands P^T to warpgroup 1;
//   - the output products read pairs of chunks again, transposed as they
//     are split (split_tile_transposed), 64 output columns an item: dq's
//     columns 0-127 in warpgroup 0 and 128.. in warpgroup 1; dk/dv keeps
//     dV in warpgroup 0 and dK in warpgroup 1 (128 registers a thread).
//     Each item's product sums in a fresh accumulator, added to the
//     running one in f32;
//   - dq streams q and dO (A) and k and v (B) for each key tile, and k
//     again for the output; dk/dv streams k and v (A) and q and dO (B) for
//     each q tile, and q and dO again for the outputs.
// Chunks wholly past d are not loaded or computed: d = 132 runs 5 chunks.
// Resident raw operands split fragment by fragment for each 8-row
// streamed tile took 162.10 us (dq) and 262.72 us (dk/dv) at BH 64, S 128,
// d 256, causal: half of each tile went to reading and splitting the
// resident fragments (scripts/flash_bwd_wide_probe.py on that design).
// This design takes 34.91 and 58.63 us there, 93.54 together against
// 119.11 for SDPA's efficient f32 backward (dq, dk and dv in one call) and
// 92.53 and 111.58 for the plain versions (CUDA-graph timer, chip_smoke
// phase 8, NVIDIA H100 80GB HBM3, 700.00 W). The chunks' splits take the
// largest share of a streamed tile (32-34% in dq); every instance takes
// 252-255 registers and spills none.
constexpr int WIDE = 256;
constexpr int WIDE_DQ_KEYS = 64;   // keys a dq tile streams
constexpr int WIDE_DKV_ROWS = 32;  // q rows a dk/dv tile streams
constexpr int WIDE_DQ_STAGES = 2;  // landing slots of a dq warpgroup
constexpr int WIDE_DKV_STAGES = 5;  // landing slots of a dk/dv warpgroup

// Shared memory of the dq kernel: for each warpgroup, its landing slots (a
// 64-row A chunk and a 64-row B chunk, or two k chunks: 16 KB) and two
// split slots (the hi and lo of a score chunk's A and B, or the transposed
// hi and lo of two k chunks: 32 KB); the exchange (64 x 64 f32); 1024
// bytes of slack.
constexpr int wide_dq_smem_bytes() {
  return 2 * (WIDE_DQ_STAGES * 2 + 2 * 4) * 64 * 128 + 64 * WIDE_DQ_KEYS * 4 + 1024;
}

// Shared memory of the dk/dv kernel: for each warpgroup, its landing slots
// (a 64-row A chunk and a 32-row B chunk, or two 32-row chunks: 12 KB) and
// two split slots (the hi and lo of a score chunk's A and B, 24 KB; the
// transposed hi and lo of two 32-row chunks take 16 KB); the exchange (64 x
// 32 f32); 1024 bytes of slack.
constexpr int wide_dkv_smem_bytes() {
  return 2 * (WIDE_DKV_STAGES + 4) * (64 + WIDE_DKV_ROWS) * 128 + 64 * WIDE_DKV_ROWS * 4 + 1024;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dq_tf32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int S, int d, float scale) {
  using namespace hopper;
  constexpr int BK = WIDE_DQ_KEYS, STAGES = WIDE_DQ_STAGES;
  constexpr int BOX = 64 * 128;       // bytes of a 64-row chunk
  constexpr int LAND = 2 * BOX;       // a landing slot: the A chunk, then the B chunk
  // A split slot: a score chunk's A hi and lo, then its B hi and lo; or an
  // output item's transposed hi, then lo.
  constexpr int SPLIT = 4 * BOX;
  constexpr int WG_BYTES = STAGES * LAND + 2 * SPLIT;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * WG_BYTES;
  uint8_t* split = land + STAGES * LAND;
  float* xch = reinterpret_cast<float*>(base + 2 * WG_BYTES);

  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * 64;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // K tiles wholly above the diagonal are skipped (pallas_attention.py:113-117).
    n_tiles = min((min(m0 + 64, S) + BK - 1) / BK, n_tiles);
  }
  // A key tile is nc chunks of the score product, then this warpgroup's
  // pairs of dq chunks: 0-3 in warpgroup 0, 4..nc-1 in warpgroup 1 (a
  // pair's second chunk may lie past d: TMA lands it as zeros).
  const int nc = (d + 31) / 32;
  const int nb = wg == 0 ? (min(nc, 4) + 1) / 2 : (max(nc - 4, 0) + 1) / 2;
  const int per_tile = nc + nb, items = n_tiles * per_tile;
  const CUtensorMap* ta = wg == 0 ? &tq : &tg;
  const CUtensorMap* tb = wg == 0 ? &tk : &tv;
  // The item at place j of key tile t in this warpgroup's stream, into
  // landing slot s.
  auto issue = [&](int t, int j, int s) {
    uint8_t* dst = land + s * LAND;
    uint64_t* bar = &full[wg][s];
    if (j < nc) {
      mbar_arrive_expect_tx(bar, LAND);
      tma_load_3d(dst, ta, bar, 32 * j, m0, bh);
      tma_load_3d(dst + BOX, tb, bar, 32 * j, t * BK, bh);
    } else {
      const int c0 = 32 * (4 * wg + 2 * (j - nc));
      mbar_arrive_expect_tx(bar, LAND);
      tma_load_3d(dst, &tk, bar, c0, t * BK, bh);
      tma_load_3d(dst + BOX, &tk, bar, c0 + 32, t * BK, bh);
    }
  };
  // Item i (place j of tile t) is done with its landing slot: one thread
  // refills it with item i + STAGES (STAGES <= per_tile), after the
  // products of item i are issued.
  auto issue_ahead = [&](int i, int t, int j) {
    if (wt != 0 || i + STAGES >= items) return;
    j += STAGES;
    if (j >= per_tile) j -= per_tile, ++t;
    issue(t, j, i % STAGES);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[0][s], 1);
      mbar_init(&full[1][s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wt == 0)
    for (int s = 0; s < STAGES; ++s) issue(0, s, s);

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator; its rows' lse (in
  // log2 units, warpgroup 0) or delta (warpgroup 1), 0 past S.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float stat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r_lo + 8 * h;
    const float* src = wg == 0 ? lse : delta;
    stat[h] = row < S ? src[(size_t)bh * S + row] * (wg == 0 ? LOG2E : 1.f) : 0.f;
  }
  const float scale2 = scale * LOG2E;
  float acc[2][32] = {};
  float part[32];

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    // S (warpgroup 0) or dP (warpgroup 1) over the chunks below d. The
    // accumulators are made here (and each output item's, part, zeroed
    // before its products), so that no register holds them between uses.
    float small[BK / 2] = {}, big[BK / 2] = {}, large[BK / 2] = {};
    for (int c = 0; c < nc; ++c, ++i) {
      const int s = i % STAGES;
      const uint8_t* ld = land + s * LAND;
      uint8_t* sp = split + (i & 1) * SPLIT;
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      split_box<BOX>(ld, sp, sp + BOX, wt);                   // A: q or dO
      split_box<BOX>(ld + BOX, sp + 2 * BOX, sp + 3 * BOX, wt);  // B: k or v
      wgmma_wait<0>();  // the last chunk's products, which read the other split slot
      fence_operands(small);
      fence_operands(big);
      if (c > 0) add_to(large, big);
      fence_proxy_async();
      // The warpgroup is done with the landing slot and the last products.
      named_barrier(1 + wg, NT);
      const uint32_t a = smem_u32(sp);
      wgmma_fence();
      wgmma_3xtf32_chunk<BK>(small, big, a, a + BOX, a + 2 * BOX, a + 3 * BOX, c == 0);
      wgmma_commit();
      issue_ahead(i, t, c);
    }
    wgmma_wait<0>();
    fence_operands(small);
    fence_operands(big);
    add_to(large, big);

    // P = exp(scale * S - lse), 0 where masked (warpgroup 0), handed to
    // warpgroup 1, which returns dS = P (dP - delta).
    float ds[BK / 2];
    if (wg == 0) {
      const int k0 = t * BK;
      const bool edge = k0 + BK > S || (CAUSAL && k0 + BK > m0);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int h = (e >> 1) & 1;
        float p = exp2f(fmaf(small[e] + large[e], scale2, -stat[h]));
        if (edge) {
          const int q_pos = m0 + r_lo + 8 * h;
          const int k_pos = k0 + 8 * (e >> 2) + c2 + (e & 1);
          bool keep = k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        xch[e * NT + wt] = p;
      }
      named_arrive(3, 2 * NT);
      named_barrier(4, 2 * NT);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) ds[e] = xch[e * NT + wt];
    } else {
      named_barrier(3, 2 * NT);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        ds[e] = xch[e * NT + wt] * (small[e] + large[e] - stat[(e >> 1) & 1]);
        xch[e * NT + wt] = ds[e];
      }
      named_arrive(4, 2 * NT);
    }
    uint32_t dh[BK / 8][4], dl[BK / 8][4];
    accum_to_tf32_a<BK>(ds, dh, dl);

    // dQ += dS K, 64 columns (two chunks) an item, K from its transposed
    // copy; each item's product sums fresh and is added in f32.
    static_for<2>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j < nb) {
        const int s = i % STAGES;
        uint8_t* sp = split + (i & 1) * SPLIT;
        mbar_wait(&full[wg][s], (i / STAGES) & 1);
        split_tile_transposed<BK, 64>(land + s * LAND, sp, sp + 2 * BOX, wt);
        wgmma_wait<0>();
        fence_operands(part);
        if (j > 0) add_to(acc[j > 0 ? j - 1 : 0], part);
        fence_proxy_async();
        named_barrier(1 + wg, NT);
#pragma unroll
        for (int e = 0; e < 32; ++e) part[e] = 0.f;
        wgmma_fence();
        wgmma_3xtf32_rs<64, BK, 64 * 128>(part, dh, dl, smem_u32(sp), smem_u32(sp + 2 * BOX));
        wgmma_commit();
        issue_ahead(i, t, nc + j);
        ++i;
      }
    });
    wgmma_wait<0>();
    fence_operands(part);
    fence_fragments(dh);
    fence_fragments(dl);
    static_for<2>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j == nb - 1) add_to(acc[j], part);
    });
  }

  float* out = dq + (size_t)bh * S * d;
  static_for<2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    if (j < nb) store_rows_f32<64>(out, acc[j], scale, m0, r_lo, c2, S, d, 128 * wg + 64 * j);
  });
}

template <bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dkv_tf32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int S, int d,
                               float scale) {
  using namespace hopper;
  constexpr int BQ = WIDE_DKV_ROWS, STAGES = WIDE_DKV_STAGES;
  constexpr int ABOX = 64 * 128;      // bytes of a 64-row (k or v) chunk
  constexpr int BOX = BQ * 128;       // bytes of a q or dO chunk
  constexpr int LAND = ABOX + BOX;    // a landing slot: the A chunk, then the B chunk
  // A split slot: a score chunk's A hi and lo, then its B hi and lo; or an
  // output item's transposed hi, then lo.
  constexpr int SPLIT = 2 * ABOX + 2 * BOX;
  constexpr int WG_BYTES = STAGES * LAND + 2 * SPLIT;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  // The q tile's lse (in log2 units, warpgroup 0) or delta (warpgroup 1)
  // by row, 0 past S.
  __shared__ float stat_s[2][BQ];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * WG_BYTES;
  uint8_t* split = land + STAGES * LAND;
  float* xch = reinterpret_cast<float*>(base + 2 * WG_BYTES);

  const int bh = blockIdx.x;
  // k tile 0 walks the most causal q tiles and launches first.
  const int n0 = blockIdx.y * 64;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt0 = CAUSAL ? n0 / BQ : 0;
  const int n_tiles = (S + BQ - 1) / BQ - qt0;
  // A q tile is nc chunks of the score product, then nb pairs of chunks of
  // this warpgroup's output (dV in warpgroup 0, dK in warpgroup 1; a pair's
  // second chunk may lie past d: TMA lands it as zeros).
  const int nc = (d + 31) / 32, nb = (nc + 1) / 2;
  const int per_tile = nc + nb, items = n_tiles * per_tile;
  const CUtensorMap* ta = wg == 0 ? &tk : &tv;  // A of S^T or dP^T
  const CUtensorMap* tb = wg == 0 ? &tq : &tg;  // B of S^T or dP^T
  const CUtensorMap* tt = wg == 0 ? &tg : &tq;  // transposed for dV or dK
  // The item at place j of q tile t in this warpgroup's stream, into
  // landing slot s; issue_ahead as in the dq kernel.
  auto issue = [&](int t, int j, int s) {
    uint8_t* dst = land + s * LAND;
    uint64_t* bar = &full[wg][s];
    const int m = (qt0 + t) * BQ;
    if (j < nc) {
      mbar_arrive_expect_tx(bar, LAND);
      tma_load_3d(dst, ta, bar, 32 * j, n0, bh);
      tma_load_3d(dst + ABOX, tb, bar, 32 * j, m, bh);
    } else {
      mbar_arrive_expect_tx(bar, 2 * BOX);
      tma_load_3d(dst, tt, bar, 64 * (j - nc), m, bh);
      tma_load_3d(dst + BOX, tt, bar, 64 * (j - nc) + 32, m, bh);
    }
  };
  auto issue_ahead = [&](int i, int t, int j) {
    if (wt != 0 || i + STAGES >= items) return;
    j += STAGES;
    if (j >= per_tile) j -= per_tile, ++t;
    issue(t, j, i % STAGES);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[0][s], 1);
      mbar_init(&full[1][s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wt == 0)
    for (int s = 0; s < STAGES; ++s) issue(0, s, s);

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  const float* stat_g = (wg == 0 ? lse : delta) + (size_t)bh * S;
  float acc[4][32] = {};
  float part[32];

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    const int m = (qt0 + t) * BQ;
    if (wt < BQ) {
      // Written before the first barrier of this tile's score chunks, read
      // at its exchange; the last tile's values were read before the
      // barriers of its output items.
      const int row = m + wt;
      stat_s[wg][wt] = row < S ? stat_g[row] * (wg == 0 ? LOG2E : 1.f) : 0.f;
    }
    // S^T (warpgroup 0) or dP^T (warpgroup 1) over the chunks below d.
    float small[BQ / 2] = {}, big[BQ / 2] = {}, large[BQ / 2] = {};
    for (int c = 0; c < nc; ++c, ++i) {
      const int s = i % STAGES;
      const uint8_t* ld = land + s * LAND;
      uint8_t* sp = split + (i & 1) * SPLIT;
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      split_box<ABOX>(ld, sp, sp + ABOX, wt);                          // A: k or v
      split_box<BOX>(ld + ABOX, sp + 2 * ABOX, sp + 2 * ABOX + BOX, wt);  // B: q or dO
      wgmma_wait<0>();  // the last chunk's products, which read the other split slot
      fence_operands(small);
      fence_operands(big);
      if (c > 0) add_to(large, big);
      fence_proxy_async();
      // The warpgroup is done with the landing slot and the last products.
      named_barrier(1 + wg, NT);
      const uint32_t a = smem_u32(sp);
      wgmma_fence();
      wgmma_3xtf32_chunk<BQ>(small, big, a, a + ABOX, a + 2 * ABOX, a + 2 * ABOX + BOX, c == 0);
      wgmma_commit();
      issue_ahead(i, t, c);
    }
    wgmma_wait<0>();
    fence_operands(small);
    fence_operands(big);
    add_to(large, big);

    // P^T = exp(scale S^T - lse) by column, 0 where masked (warpgroup 0),
    // handed to warpgroup 1 for dS^T = P^T (dP^T - delta).
    float pt[BQ / 2];
    if (wg == 0) {
      const bool edge = m + BQ > S || n0 + 64 > S || (CAUSAL && m < n0 + 64);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e >> 2) + c2 + (e & 1);
        float p = exp2f(fmaf(small[e] + large[e], scale2, -stat_s[0][col]));
        if (edge) {
          const int k_pos = n0 + r_lo + 8 * ((e >> 1) & 1);
          const int q_pos = m + col;
          bool keep = q_pos < S && k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        pt[e] = p;
      }
      if (t > 0) named_barrier(4, 2 * NT);  // warpgroup 1 has read the last tile's
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) xch[e * NT + wt] = pt[e];
      named_arrive(3, 2 * NT);
    } else {
      named_barrier(3, 2 * NT);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e >> 2) + c2 + (e & 1);
        pt[e] = xch[e * NT + wt] * (small[e] + large[e] - stat_s[1][col]);
      }
      if (t + 1 < n_tiles) named_arrive(4, 2 * NT);
    }
    uint32_t ph[BQ / 8][4], pl[BQ / 8][4];
    accum_to_tf32_a<BQ>(pt, ph, pl);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), 64 columns
    // (two chunks) an item, from their transposed copy; each item's product
    // sums fresh and is added in f32.
    static_for<4>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j < nb) {
        const int s = i % STAGES;
        uint8_t* sp = split + (i & 1) * SPLIT;
        mbar_wait(&full[wg][s], (i / STAGES) & 1);
        split_tile_transposed<BQ, 64>(land + s * LAND, sp, sp + 2 * BOX, wt);
        wgmma_wait<0>();
        fence_operands(part);
        if (j > 0) add_to(acc[j > 0 ? j - 1 : 0], part);
        fence_proxy_async();
        named_barrier(1 + wg, NT);
#pragma unroll
        for (int e = 0; e < 32; ++e) part[e] = 0.f;
        wgmma_fence();
        wgmma_3xtf32_rs<64, BQ, 64 * 128>(part, ph, pl, smem_u32(sp), smem_u32(sp + 2 * BOX));
        wgmma_commit();
        issue_ahead(i, t, nc + j);
        ++i;
      }
    });
    wgmma_wait<0>();
    fence_operands(part);
    fence_fragments(ph);
    fence_fragments(pl);
    static_for<4>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j == nb - 1) add_to(acc[j], part);
    });
  }

  float* out = (wg == 0 ? dv : dk) + (size_t)bh * S * d;
  const float mul = wg == 0 ? 1.f : scale;
  static_for<4>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    if (j < nb) store_rows_f32<64>(out, acc[j], mul, n0, r_lo, c2, S, d, 64 * j);
  });
}

// ------------------------------------- f32 (3xTF32) past head dim 256
//
// The f32 dk/dv kernel past d = 256 (flash_bwd_dkv_tf32_deep_kernel), the
// W = 256 kernel above carried past 256. PR 26's FFMA form (a dK and a dV
// block for each k tile, f32 arithmetic) took 159.44 us at BH 64, S 128,
// d 320, causal, over its plain version (134.70). The W = 256 kernel's
// shape holds: warpgroup 0 runs S^T and dV, warpgroup 1 dP^T and dK, each
// streaming 32-column chunks of d through its own landing and split
// slots, with no atomics and a fixed summation order (a run is
// bit-reproducible). What changes past 256:
//   - a warpgroup's output accumulators are 64 registers a thread for each
//     64 columns: a block owns DEEP_DKV_ITEMS items (320 columns) of both
//     outputs, grid axis z the rest of d, each block computing the score
//     tiles over the whole of d;
//   - to keep those 160 registers beside the products, each score chunk's
//     three products sum in one fresh accumulator (small terms first, as
//     the forward's chunks), added in f32, and P^T (dS^T) goes to shared
//     memory once a q tile, split into hi and lo with its q columns in the
//     order of the transposed copies (perm8), so that the output products
//     read both operands from shared memory (SS) instead of holding the
//     A fragments in registers. P^T's hi and lo take the last 8 KB of the
//     two split slots, which the output items' transposed copies leave
//     free; three landing slots a warpgroup (181,248 B); 255 registers,
//     no spills.
// Its times, against PR 26's form, the plain version and SDPA, are in
// PERF.md §6 (chip_smoke.py phase 8, scripts/flash_deep_times.py).
constexpr int DEEP_DKV_ITEMS = 5;   // 64-column items of each output a block owns
constexpr int DEEP_DKV_STAGES = 3;  // landing slots of a warpgroup (3 timed 1-2% under 4 and 5)

// Shared memory of the deep dk/dv kernel: for each warpgroup, its landing
// slots (a 64-row A chunk and a 32-row B chunk: 12 KB) and two split slots
// (24 KB: P^T's hi and lo in their last 8 KB); the exchange (64 x 32 f32);
// 1024 bytes of slack.
__host__ __device__ constexpr int deep_dkv_smem_bytes() {
  return 2 * (DEEP_DKV_STAGES + 4) * (64 + WIDE_DKV_ROWS) * 128 + 64 * WIDE_DKV_ROWS * 4 + 1024;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dkv_tf32_deep_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int S, int d,
                               float scale) {
  using namespace hopper;
  constexpr int BQ = WIDE_DKV_ROWS, STAGES = DEEP_DKV_STAGES, NI = DEEP_DKV_ITEMS;
  constexpr int ABOX = 64 * 128;    // bytes of a 64-row (k or v) chunk
  constexpr int BOX = BQ * 128;     // bytes of a q or dO chunk
  constexpr int LAND = ABOX + BOX;  // a landing slot: the A chunk, then the B chunk
  // A split slot: a score chunk's A hi and lo, then its B hi and lo; or an
  // output item's transposed hi, then lo, and P^T's (dS^T's) hi (slot 0)
  // or lo (slot 1) in its last 2 ABOX.. SPLIT.
  constexpr int SPLIT = 2 * ABOX + 2 * BOX;
  constexpr int WG_BYTES = STAGES * LAND + 2 * SPLIT;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  // The q tile's lse (in log2 units, warpgroup 0) or delta (warpgroup 1)
  // by row, 0 past S.
  __shared__ float stat_s[2][BQ];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * WG_BYTES;
  uint8_t* split = land + STAGES * LAND;
  // P^T (warpgroup 0) or dS^T (warpgroup 1), hi and lo, as the A operand
  // of the output products: K-major, 64 k rows of 32 q columns.
  uint8_t* pt_hi = split + 2 * ABOX;
  uint8_t* pt_lo = split + SPLIT + 2 * ABOX;
  float* xch = reinterpret_cast<float*>(base + 2 * WG_BYTES);

  const int bh = blockIdx.x;
  // k tile 0 walks the most causal q tiles and launches first.
  const int n0 = blockIdx.y * 64;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt0 = CAUSAL ? n0 / BQ : 0;
  const int n_tiles = (S + BQ - 1) / BQ - qt0;
  // This block's output columns: NI items of 64 from col0, those below d.
  const int col0 = 64 * NI * blockIdx.z;
  const int nc = (d + 31) / 32, nb = min(NI, (d - col0 + 63) / 64);
  // A q tile is nc chunks of the score product, then nb items of this
  // warpgroup's output (dV in warpgroup 0, dK in warpgroup 1; an item's
  // second chunk may lie past d: TMA lands it as zeros).
  const int per_tile = nc + nb, items = n_tiles * per_tile;
  const CUtensorMap* ta = wg == 0 ? &tk : &tv;  // A of S^T or dP^T
  const CUtensorMap* tb = wg == 0 ? &tq : &tg;  // B of S^T or dP^T
  const CUtensorMap* tt = wg == 0 ? &tg : &tq;  // transposed for dV or dK
  // The item at place j of q tile t in this warpgroup's stream, into
  // landing slot s; issue_ahead as in the W = 256 kernels.
  auto issue = [&](int t, int j, int s) {
    uint8_t* dst = land + s * LAND;
    uint64_t* bar = &full[wg][s];
    const int m = (qt0 + t) * BQ;
    if (j < nc) {
      mbar_arrive_expect_tx(bar, LAND);
      tma_load_3d(dst, ta, bar, 32 * j, n0, bh);
      tma_load_3d(dst + ABOX, tb, bar, 32 * j, m, bh);
    } else {
      mbar_arrive_expect_tx(bar, 2 * BOX);
      tma_load_3d(dst, tt, bar, col0 + 64 * (j - nc), m, bh);
      tma_load_3d(dst + BOX, tt, bar, col0 + 64 * (j - nc) + 32, m, bh);
    }
  };
  auto issue_ahead = [&](int i, int t, int j) {
    if (wt != 0 || i + STAGES >= items) return;
    j += STAGES;
    while (j >= per_tile) j -= per_tile, ++t;
    issue(t, j, i % STAGES);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[0][s], 1);
      mbar_init(&full[1][s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wt == 0)
    for (int s = 0; s < STAGES && s < items; ++s) issue(s / per_tile, s % per_tile, s);

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  const float* stat_g = (wg == 0 ? lse : delta) + (size_t)bh * S;
  float acc[NI][32] = {};
  float part[32];

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    const int m = (qt0 + t) * BQ;
    if (wt < BQ) {
      // Written before the first barrier of this tile's score chunks, read
      // at its exchange; the last tile's values were read before the
      // barriers of its output items.
      const int row = m + wt;
      stat_s[wg][wt] = row < S ? stat_g[row] * (wg == 0 ? LOG2E : 1.f) : 0.f;
    }
    // S^T (warpgroup 0) or dP^T (warpgroup 1) over the chunks below d:
    // each chunk's three products sum fresh, small terms first, and are
    // added in f32.
    float fresh[BQ / 2] = {}, sacc[BQ / 2] = {};
    for (int c = 0; c < nc; ++c, ++i) {
      const int s = i % STAGES;
      const uint8_t* ld = land + s * LAND;
      uint8_t* sp = split + (i & 1) * SPLIT;
      PROBE_MARK(i, 0);
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      PROBE_MARK(i, 1);
      split_box<ABOX>(ld, sp, sp + ABOX, wt);                             // A: k or v
      split_box<BOX>(ld + ABOX, sp + 2 * ABOX, sp + 2 * ABOX + BOX, wt);  // B: q or dO
      PROBE_MARK(i, 2);
      wgmma_wait<0>();  // the last chunk's products, which read the other split slot
      fence_operands(fresh);
      if (c > 0) add_to(sacc, fresh);
      PROBE_MARK(i, 3);
      fence_proxy_async();
      // The warpgroup is done with the landing slot and the last products.
      named_barrier(1 + wg, NT);
      PROBE_MARK(i, 4);
      const uint32_t a = smem_u32(sp);
      wgmma_fence();
      wgmma_3xtf32_ss<BQ, 32, ABOX, BOX>(fresh, a, a + ABOX, a + 2 * ABOX, a + 2 * ABOX + BOX);
      wgmma_commit();
      PROBE_MARK(i, 5);
      issue_ahead(i, t, c);
      PROBE_MARK(i, 6);
    }
    wgmma_wait<0>();
    fence_operands(fresh);
    add_to(sacc, fresh);

    // P^T = exp(scale S^T - lse) by column, 0 where masked (warpgroup 0),
    // handed to warpgroup 1 for dS^T = P^T (dP^T - delta).
    float pv[BQ / 2];
    if (wg == 0) {
      const bool edge = m + BQ > S || n0 + 64 > S || (CAUSAL && m < n0 + 64);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e >> 2) + c2 + (e & 1);
        float p = exp2f(fmaf(sacc[e], scale2, -stat_s[0][col]));
        if (edge) {
          const int k_pos = n0 + r_lo + 8 * ((e >> 1) & 1);
          const int q_pos = m + col;
          bool keep = q_pos < S && k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        pv[e] = p;
      }
      if (t > 0) named_barrier(4, 2 * NT);  // warpgroup 1 has read the last tile's
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) xch[e * NT + wt] = pv[e];
      named_arrive(3, 2 * NT);
    } else {
      named_barrier(3, 2 * NT);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e >> 2) + c2 + (e & 1);
        pv[e] = xch[e * NT + wt] * (sacc[e] - stat_s[1][col]);
      }
      if (t + 1 < n_tiles) named_arrive(4, 2 * NT);
    }
    // P^T or dS^T into shared memory, split into hi and lo: element (r, q)
    // at column perm8(q), where the transposed copies of dO and q hold q.
    // The products that read these boxes last (this tile's score chunks,
    // the last tile's output items) have completed.
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int r = r_lo + 8 * ((e >> 1) & 1);
      const int off = sw_off(r, 8 * (e >> 2) + lane % 4 + 4 * (e & 1), 64);
      uint32_t h, l;
      split_tf32(pv[e], h, l);
      *reinterpret_cast<uint32_t*>(pt_hi + off) = h;
      *reinterpret_cast<uint32_t*>(pt_lo + off) = l;
    }
    PROBE_MARK(i, 7);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), 64 columns
    // (two chunks) an item, both operands from shared memory; each item's
    // product sums fresh and is added in f32.
    static_for<NI>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j < nb) {
        const int s = i % STAGES;
        uint8_t* sp = split + (i & 1) * SPLIT;
        PROBE_MARK(i, 0);
        mbar_wait(&full[wg][s], (i / STAGES) & 1);
        PROBE_MARK(i, 1);
        // One step at a time: beside the outputs' 160 registers, both
        // steps unrolled spilled (and took 4% more time).
        split_tile_transposed<BQ, 64, 1>(land + s * LAND, sp, sp + 2 * BOX, wt);
        PROBE_MARK(i, 2);
        wgmma_wait<0>();
        fence_operands(part);
        if (j > 0) add_to(acc[j > 0 ? j - 1 : 0], part);
        PROBE_MARK(i, 3);
        fence_proxy_async();
        named_barrier(1 + wg, NT);
        PROBE_MARK(i, 4);
        wgmma_fence();
        wgmma_3xtf32_ss<64, BQ, ABOX, 2 * BOX>(part, smem_u32(pt_hi), smem_u32(pt_lo),
                                                smem_u32(sp), smem_u32(sp + 2 * BOX));
        wgmma_commit();
        PROBE_MARK(i, 5);
        issue_ahead(i, t, nc + j);
        PROBE_MARK(i, 6);
        ++i;
      }
    });
    wgmma_wait<0>();
    fence_operands(part);
    static_for<NI>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j == nb - 1) add_to(acc[j], part);
    });
  }

  float* out = (wg == 0 ? dv : dk) + (size_t)bh * S * d;
  const float mul = wg == 0 ? 1.f : scale;
  static_for<NI>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    if (j < nb) store_rows_f32<64>(out, acc[j], mul, n0, r_lo, c2, S, d, col0 + 64 * j);
  });
}

// The f32 dq kernel past d = 256 (flash_bwd_dq_tf32_deep_kernel), the
// W = 256 dq kernel carried past 256 as the dk/dv kernel above was. PR
// 26's FFMA form (one thread a 4 x 4 micro-tile, f32 arithmetic) took
// 108.07 us at BH 64, S 128, d 320, causal, against 113.25 for its plain
// version (PR 27 run F, NVIDIA H100 80GB HBM3, 700.00 W). The W = 256
// shape holds: warpgroup 0 runs S = Q K^T and warpgroup 1 dP = dO V^T over
// the 32-column chunks of d, 64-key tiles, each warpgroup streaming its
// chunks through its own landing and split slots, no atomics and a fixed
// summation order. What changes past 256:
//   - a block owns up to 2 NI items of 64 dq columns, the first half
//     (rounded up) in warpgroup 0, the rest in warpgroup 1, grid axis z the
//     rest of d, each block computing the score tiles over the whole of d.
//     NI is 3 up to d = 384 (96 accumulator registers a thread, a spill of
//     16 B) and 4 past it (128, a spill of 128-156 B): at d 320 three
//     items timed 4% under four, at d 512 four items 23% under three,
//     which needed a second block along z (scripts/flash_deep_times.py,
//     NVIDIA H100 80GB HBM3, 700.00 W);
//   - as in the dk/dv kernel, each score chunk's three products sum in one
//     fresh accumulator, added in f32, and dS goes to shared memory once a
//     key tile, split into hi and lo with its keys in the order of k's
//     transposed copies (perm8), so that dQ += dS K reads both operands
//     from shared memory (SS) instead of holding dS's 64 registers of A
//     fragments beside 128 of dQ;
//   - the exchange: warpgroup 0 hands P (f32, fragment order) to warpgroup
//     1 through the 32 KB that then hold dS's hi and lo; warpgroup 1 forms
//     dS = P (dP - delta), writes its hi and lo over P once every thread of
//     it has read P, and hands it to both warpgroups' output items;
//     warpgroup 0 writes the next tile's P once warpgroup 1's output
//     products, the last readers of dS, have completed.
// Shared memory: two landing and two split slots a warpgroup as at W = 256
// and dS's 32 KB: 230,400 B, one block an SM. 255 registers. At BH 64, S
// 128, causal, in turns against the FFMA form (scripts/flash_deep_times.py,
// CUDA-graph timer, NVIDIA H100 80GB HBM3, 700.00 W): 46.0 us at d 320
// against 103.4, 75.8 at d 512 against 165.9. Its phase-8 times, against
// the plain version and SDPA, are in PERF.md §6.
__host__ __device__ constexpr int deep_dq_smem_bytes() {
  return 2 * (WIDE_DQ_STAGES * 2 + 2 * 4) * 64 * 128 + 4 * 64 * 128 + 1024;
}

// The 64-column items of dq a warpgroup of the deep f32 dq kernel owns at
// head dim d (> 256): 3 up to 384, else 4.
inline int deep_dq_items(int d) { return d <= 6 * 64 ? 3 : 4; }

template <int NI, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dq_tf32_deep_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int S, int d, float scale) {
  using namespace hopper;
  constexpr int BK = WIDE_DQ_KEYS, STAGES = WIDE_DQ_STAGES;
  constexpr int BOX = 64 * 128;  // bytes of a 64-row chunk of 32 columns
  constexpr int LAND = 2 * BOX;  // a landing slot: the A chunk, then the B chunk; or two k chunks
  // A split slot: a score chunk's A hi and lo, then its B hi and lo; or an
  // output item's transposed hi, then lo.
  constexpr int SPLIT = 4 * BOX;
  constexpr int WG_BYTES = STAGES * LAND + 2 * SPLIT;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * WG_BYTES;
  uint8_t* split = land + STAGES * LAND;
  // P (f32, fragment order, the first 16 KB), then dS's hi and lo as the A
  // operand of the output products: K-major, 64 q rows of 64 keys.
  float* xch = reinterpret_cast<float*>(base + 2 * WG_BYTES);
  uint8_t* ds_hi = base + 2 * WG_BYTES;
  uint8_t* ds_lo = ds_hi + 2 * BOX;

  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * 64;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // K tiles wholly above the diagonal are skipped (pallas_attention.py:113-117).
    n_tiles = min((min(m0 + 64, S) + BK - 1) / BK, n_tiles);
  }
  // This block's items of dq: up to 2 NI from ib, those below d; warpgroup 0
  // takes the first half (rounded up), warpgroup 1 the rest.
  const int ib = 2 * NI * blockIdx.z;
  const int nb_all = min(2 * NI, (d + 63) / 64 - ib), nb0 = (nb_all + 1) / 2;
  const int j0 = wg == 0 ? ib : ib + nb0, nb = wg == 0 ? nb0 : nb_all - nb0;
  // A key tile is nc chunks of the score product, then nb items of dq (an
  // item's second chunk may lie past d: TMA lands it as zeros).
  const int nc = (d + 31) / 32;
  const int per_tile = nc + nb, items = n_tiles * per_tile;
  const CUtensorMap* ta = wg == 0 ? &tq : &tg;
  const CUtensorMap* tb = wg == 0 ? &tk : &tv;
  // The item at place j of key tile t in this warpgroup's stream, into
  // landing slot s; issue_ahead as in the W = 256 kernels.
  auto issue = [&](int t, int j, int s) {
    uint8_t* dst = land + s * LAND;
    uint64_t* bar = &full[wg][s];
    mbar_arrive_expect_tx(bar, LAND);
    if (j < nc) {
      tma_load_3d(dst, ta, bar, 32 * j, m0, bh);
      tma_load_3d(dst + BOX, tb, bar, 32 * j, t * BK, bh);
    } else {
      const int c0 = 64 * (j0 + j - nc);
      tma_load_3d(dst, &tk, bar, c0, t * BK, bh);
      tma_load_3d(dst + BOX, &tk, bar, c0 + 32, t * BK, bh);
    }
  };
  auto issue_ahead = [&](int i, int t, int j) {
    if (wt != 0 || i + STAGES >= items) return;
    j += STAGES;
    while (j >= per_tile) j -= per_tile, ++t;
    issue(t, j, i % STAGES);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[0][s], 1);
      mbar_init(&full[1][s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wt == 0)
    for (int s = 0; s < STAGES && s < items; ++s) issue(s / per_tile, s % per_tile, s);

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator; its rows' lse (in
  // log2 units, warpgroup 0) or delta (warpgroup 1), 0 past S.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float stat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r_lo + 8 * h;
    const float* src = wg == 0 ? lse : delta;
    stat[h] = row < S ? src[(size_t)bh * S + row] * (wg == 0 ? LOG2E : 1.f) : 0.f;
  }
  const float scale2 = scale * LOG2E;
  float acc[NI][32] = {};
  float part[32];

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    // S (warpgroup 0) or dP (warpgroup 1) over the chunks below d: each
    // chunk's three products sum fresh, small terms first, and are added
    // in f32.
    float fresh[BK / 2] = {}, sacc[BK / 2] = {};
    for (int c = 0; c < nc; ++c, ++i) {
      const int s = i % STAGES;
      const uint8_t* ld = land + s * LAND;
      uint8_t* sp = split + (i & 1) * SPLIT;
      PROBE_MARK(i, 0);
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      PROBE_MARK(i, 1);
      split_box<BOX>(ld, sp, sp + BOX, wt);                      // A: q or dO
      split_box<BOX>(ld + BOX, sp + 2 * BOX, sp + 3 * BOX, wt);  // B: k or v
      PROBE_MARK(i, 2);
      wgmma_wait<0>();  // the last chunk's products, which read the other split slot
      fence_operands(fresh);
      if (c > 0) add_to(sacc, fresh);
      PROBE_MARK(i, 3);
      fence_proxy_async();
      // The warpgroup is done with the landing slot and the last products.
      named_barrier(1 + wg, NT);
      PROBE_MARK(i, 4);
      const uint32_t a = smem_u32(sp);
      wgmma_fence();
      wgmma_3xtf32_ss<BK, 32, BOX, BOX>(fresh, a, a + BOX, a + 2 * BOX, a + 3 * BOX);
      wgmma_commit();
      PROBE_MARK(i, 5);
      issue_ahead(i, t, c);
      PROBE_MARK(i, 6);
    }
    wgmma_wait<0>();
    fence_operands(fresh);
    add_to(sacc, fresh);

    // P = exp(scale * S - lse), 0 where masked (warpgroup 0), handed to
    // warpgroup 1, which writes dS = P (dP - delta) in its place, split
    // into hi and lo: element (r, k) at column perm8(k), where k's
    // transposed copies hold key k. Barrier 3 hands P over, 4 dS; 5 says
    // that warpgroup 1's output products of the last tile have completed.
    if (wg == 0) {
      const int k0 = t * BK;
      const bool edge = k0 + BK > S || (CAUSAL && k0 + BK > m0);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int h = (e >> 1) & 1;
        float p = exp2f(fmaf(sacc[e], scale2, -stat[h]));
        if (edge) {
          const int q_pos = m0 + r_lo + 8 * h;
          const int k_pos = k0 + 8 * (e >> 2) + c2 + (e & 1);
          bool keep = k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        sacc[e] = p;
      }
      if (t > 0) named_barrier(5, 2 * NT);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) xch[e * NT + wt] = sacc[e];
      named_arrive(3, 2 * NT);
      named_barrier(4, 2 * NT);
    } else {
      named_barrier(3, 2 * NT);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sacc[e] = xch[e * NT + wt] * (sacc[e] - stat[(e >> 1) & 1]);
      named_barrier(2, NT);  // every thread of this warpgroup has read P
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = r_lo + 8 * ((e >> 1) & 1);
        const int off = sw_off(r, 8 * (e >> 2) + lane % 4 + 4 * (e & 1), 64);
        uint32_t h, l;
        split_tf32(sacc[e], h, l);
        *reinterpret_cast<uint32_t*>(ds_hi + off) = h;
        *reinterpret_cast<uint32_t*>(ds_lo + off) = l;
      }
      fence_proxy_async();
      named_arrive(4, 2 * NT);
    }
    PROBE_MARK(i, 7);

    // dQ += dS K, 64 columns (two chunks) an item, both operands from
    // shared memory, K from its transposed copy; each item's product sums
    // fresh and is added in f32.
    static_for<NI>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j < nb) {
        const int s = i % STAGES;
        uint8_t* sp = split + (i & 1) * SPLIT;
        PROBE_MARK(i, 0);
        mbar_wait(&full[wg][s], (i / STAGES) & 1);
        PROBE_MARK(i, 1);
        // One step at a time, beside the outputs' registers (as the dk/dv
        // kernel's).
        split_tile_transposed<BK, 64, 1>(land + s * LAND, sp, sp + 2 * BOX, wt);
        PROBE_MARK(i, 2);
        wgmma_wait<0>();
        fence_operands(part);
        if (j > 0) add_to(acc[j > 0 ? j - 1 : 0], part);
        PROBE_MARK(i, 3);
        fence_proxy_async();
        named_barrier(1 + wg, NT);
        PROBE_MARK(i, 4);
        wgmma_fence();
        wgmma_3xtf32_ss<64, BK, BOX, BOX>(part, smem_u32(ds_hi), smem_u32(ds_lo), smem_u32(sp),
                                          smem_u32(sp + 2 * BOX));
        wgmma_commit();
        PROBE_MARK(i, 5);
        issue_ahead(i, t, nc + j);
        PROBE_MARK(i, 6);
        ++i;
      }
    });
    wgmma_wait<0>();
    fence_operands(part);
    static_for<NI>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if (j == nb - 1) add_to(acc[j], part);
    });
    if (wg == 1 && t + 1 < n_tiles) named_arrive(5, 2 * NT);
  }

  float* out = dq + (size_t)bh * S * d;
  static_for<NI>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    if (j < nb) store_rows_f32<64>(out, acc[j], scale, m0, r_lo, c2, S, d, 64 * (j0 + j));
  });
}

// Checks of the pieces above, for the tests on the card. The split of n
// values into their hi and lo words, as split_tile leaves them.
__global__ void tf32_split_probe_kernel(const float* __restrict__ x, uint32_t* __restrict__ hi,
                                        uint32_t* __restrict__ lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) hopper::split_tf32(x[i], hi[i], lo[i]);
}

// C (64 x N) = X (64 x 64) Y (64 x N), f32 row-major, by the path of the
// backward kernels' last products alone: X enters an m64n64 accumulator
// fragment and leaves it as 3xTF32 A fragments (accum_to_tf32_a); Y is
// stored as an f32 tile lands (sw_off) and split_tile writes its permuted
// transposed copy; the three RS products accumulate.
template <int N>
__global__ void __launch_bounds__(TF32_NT)
tf32_relayout_probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           float* __restrict__ c) {
  using namespace hopper;
  constexpr int YT = 64 * N * 4, YTT = transposed_bytes<64, N>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Yr = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Yl = Yr + YT;
  uint8_t* YTh = Yl + YT;
  uint8_t* YTl = YTh + YTT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < 64 * N; i += TF32_NT)
    *reinterpret_cast<float*>(Yr + sw_off(i / N, i % N, 64)) = y[i];
  __syncthreads();
  split_tile<64, N, true>(Yr, Yr, Yl, YTh, YTl);
  fence_proxy_async();
  __syncthreads();
  const int r_lo = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  float xf[32], acc[N / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    xf[i] = x[(r_lo + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + c2 + (i & 1)];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t ah[8][4], al[8][4];
  accum_to_tf32_a<64>(xf, ah, al);
  fence_operands(acc);
  wgmma_fence();
  wgmma_3xtf32_rs<N, 64, N * 128>(acc, ah, al, smem_u32(YTh), smem_u32(YTl));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  fence_fragments(ah);
  fence_fragments(al);
  store_rows_f32<N>(c, acc, 1.f, 0, r_lo, c2, 64, N);
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *out0, *out1;  // dq (out1 unused), or dk and dv
  int BH, S, d;
  float scale;
};

template <bool DKV, int W, bool CAUSAL>
int launch_tf32(const Args& a, cudaStream_t stream) {
  using Tiles = Tf32Tiles<W>;
  constexpr int ROWS = DKV ? Tiles::DKV_ROWS : Tiles::DQ_ROWS;  // streamed rows per tile
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  // The resident operands land as 64-row tiles, the streamed ones as ROWS.
  const int q_rows = DKV ? ROWS : 64, k_rows = DKV ? 64 : ROWS;
  CUtensorMap tq, tk, tv, tg;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, a.d, F32, q_rows);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, a.d, F32, k_rows);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, a.d, F32, k_rows);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, a.d, F32, q_rows);
  if (err) return err;
  // dq transposes k; dk/dv transposes q and dO.
  constexpr int smem = tf32_smem_bytes<W, ROWS, DKV ? 2 : 1, Tiles::RING>();
  dim3 grid(a.BH, (a.S + 63) / 64);
  cudaError_t e;
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_tf32_kernel<W, ROWS, Tiles::RING, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, TF32_NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (float*)a.out0,
                                          (float*)a.out1, a.S, a.d, a.scale);
  } else {
    auto kern = flash_bwd_dq_tf32_kernel<W, ROWS, Tiles::RING, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, TF32_NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (float*)a.out0, a.S,
                                          a.d, a.scale);
  }
  return (int)cudaGetLastError();
}

template <bool DKV, bool CAUSAL>
int launch_tf32_wide(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  // Chunks of 64 rows, but dk/dv's q and dO chunks of WIDE_DKV_ROWS.
  const int q_rows = DKV ? WIDE_DKV_ROWS : 64;
  CUtensorMap tq, tk, tv, tg;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, a.d, F32, q_rows);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, a.d, F32, 64);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, a.d, F32, 64);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, a.d, F32, q_rows);
  if (err) return err;
  constexpr int smem = DKV ? wide_dkv_smem_bytes() : wide_dq_smem_bytes();
  dim3 grid(a.BH, (a.S + 63) / 64);
  cudaError_t e;
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_tf32_wide_kernel<CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (float*)a.out0,
                                         (float*)a.out1, a.S, a.d, a.scale);
  } else {
    auto kern = flash_bwd_dq_tf32_wide_kernel<CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (float*)a.out0, a.S,
                                         a.d, a.scale);
  }
  return (int)cudaGetLastError();
}

// T is the 16-bit element type, __nv_bfloat16 or __half.
template <typename T, bool DKV, int W, bool CAUSAL>
int launch_bf16(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  constexpr CUtensorMapDataType type = hopper::Elem16<T>::MAP;
  CUtensorMap tq, tk, tv, tg;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, a.d, type);
  if (err) return err;
  constexpr int smem = wgmma_smem_bytes<W>();
  // Both kernels tile S by 64 rows (BM = BN).
  dim3 grid(a.BH, (a.S + BM - 1) / BM);
  cudaError_t e;
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_wgmma_kernel<T, W, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (T*)a.out0, (T*)a.out1, a.S,
                                     a.d, a.scale);
  } else {
    auto kern = flash_bwd_dq_wgmma_kernel<T, W, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, NT * hopper::warpgroups<W>(), smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta,
                                                               (T*)a.out0, a.S, a.d, a.scale);
  }
  return (int)cudaGetLastError();
}

// The bf16 dk/dv kernel at tile width 256 (128 < d <= 256), two
// warpgroups. Its first form (flash_bwd_dkv_wgmma_kernel at W = 256) ran
// both warpgroups over the whole S^T and dP^T tiles, one lane issuing
// every TMA box and copying lse and delta before either warpgroup could
// start, and stored dk and dv from registers, four bytes a store. This
// kernel parts the work by product, so nothing is computed twice:
//   - warpgroup 0 runs S^T = K Q^T (16 k16 steps), forms P^T, hands it in
//     f32 to warpgroup 1 through shared memory (two buffers, by the q
//     tile's parity; an mbarrier of its 128 threads) and takes dV += P^T dO
//     over all 256 columns (m64n256k16, 128 accumulator registers a
//     thread);
//   - warpgroup 1 runs dP^T = V dO^T, forms dS^T = P^T (dP^T - delta) from
//     the P^T it is handed and takes dK += dS^T Q over all 256 columns;
//   - the TMA issue is spread over the warps, one box each: warps 0-3 land
//     K's four boxes and Q's, warps 4-7 V's and dO's, each warp's maps
//     prefetched first. Q and dO stages have a barrier each, so that
//     warpgroup 0 starts on Q and warpgroup 1 on dO. Warpgroup 1, the
//     later of the two, refills a stage once all eight warps are done
//     with it. Each thread loads the lse (warpgroup 0) or delta
//     (warpgroup 1) of its fragment's 16 columns at the top of a step,
//     while the step's tiles land;
//   - dV (warpgroup 0) and scale dK (warpgroup 1) are staged in bf16 in the
//     K and V tiles (each read only by its own warpgroup's score products)
//     and stored with four TMA stores each (columns past d and rows past S
//     are not written).
// P^T, and dS^T from the f32 P^T, are rounded to bf16 as the A operands of
// the output products, as in flash_bwd_dkv_wgmma_kernel. Shared memory: K,
// V, two stages of Q and of dO (32,768 B each), the two P^T buffers (2 x 64
// x 64 f32) and 1024 bytes of slack: 230,400 B, one block an SM; 228-236
// registers, no spills. In the heaviest block at BH 64, S 128, d 256,
// causal, the first form spent 27% of its cycles in the one lane's issue
// of 24 boxes and copy of lse and delta, 24-31% storing dk and dv from
// registers and 11-14% in the score products of each warpgroup; this one
// takes 15,500-18,800 cycles of the block where that took 17,000-24,000,
// the largest share waiting for the q tiles to land (27-39%): it is bound
// by the bytes it streams (scripts/flash_bf16_wide_probe.py, NVIDIA H100
// 80GB HBM3, 700.00 W).
__host__ __device__ constexpr int wgmma_dkv_wide_smem_bytes() {
  return 6 * 64 * 256 * 2 + 2 * BM * BN * 4 + 1024;
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dkv_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tg,
                                const __grid_constant__ CUtensorMap tdk,
                                const __grid_constant__ CUtensorMap tdv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                int S, int d, float scale) {
  using namespace hopper;
  constexpr int BOX = 64 * 128;  // bytes of a 64-column box of 64 rows
  constexpr int TILE = 4 * BOX;  // bytes of a 64-row tile of 256 columns

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_k, bar_v, bar_q[2], bar_g[2], bar_p[2], bar_free[2];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Ks + 2 * TILE;  // two stages
  uint8_t* Gs = Ks + 4 * TILE;  // dO, two stages
  float* xch = reinterpret_cast<float*>(Ks + 6 * TILE);  // P^T by the q tile's parity

  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // k tile 0 walks the most causal q tiles and launches first.
  const int n0 = blockIdx.y * BN;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt0 = CAUSAL ? n0 / BM : 0;
  const int n_tiles = (S + BM - 1) / BM - qt0;
  // lse (in log2 units) in warpgroup 0, delta in warpgroup 1.
  const float* stat_bh = (wg == 0 ? lse : delta) + (size_t)bh * S;
  const float stat_mul = wg == 0 ? LOG2E : 1.f;

  // This warp's box: column 64 warp of K (warpgroup 0) or V (1) and of
  // each Q (0) or dO (1) tile.
  const CUtensorMap* t_res = wg == 0 ? &tk : &tv;
  const CUtensorMap* t_str = wg == 0 ? &tq : &tg;
  // Lane 0 of each warp: its Q box and dO box of step t into stage t & 1
  // (at first the warps of warpgroup 0 land Q's boxes and those of
  // warpgroup 1 dO's; warpgroup 1 refills both).
  auto load_q = [&](int t, bool q, bool g) {
    const int s = t & 1, m = (qt0 + t) * BM;
    if (q) {
      mbar_arrive_expect_tx(&bar_q[s], BOX);
      tma_load_3d(Qs + s * TILE + warp * BOX, &tq, &bar_q[s], 64 * warp, m, bh);
    }
    if (g) {
      mbar_arrive_expect_tx(&bar_g[s], BOX);
      tma_load_3d(Gs + s * TILE + warp * BOX, &tg, &bar_g[s], 64 * warp, m, bh);
    }
  };
  if (lane == 0) {
    prefetch_map(t_res);
    prefetch_map(t_str);
    if (wg == 1) prefetch_map(&tq);
    if (warp == 0) prefetch_map(wg == 0 ? &tdv : &tdk);
  }
  if (tid == 0) {
    mbar_init(&bar_k, 4);  // a box from each warp of warpgroup 0
    mbar_init(&bar_v, 4);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_q[s], 4);  // a box from each warp of a warpgroup
      mbar_init(&bar_g[s], 4);
      mbar_init(&bar_p[s], NT);       // every thread of warpgroup 0, after its P^T
      mbar_init(&bar_free[s], 2 * NT / 32);  // every warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0) {
    uint64_t* bar = wg == 0 ? &bar_k : &bar_v;
    mbar_arrive_expect_tx(bar, BOX);
    tma_load_3d((wg == 0 ? Ks : Vs) + warp * BOX, t_res, bar, 64 * warp, n0, bh);
    for (int t = 0; t < 2 && t < n_tiles; ++t) load_q(t, wg == 0, wg == 1);
  }

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  const float2 mul = ds_scales<T>(scale);
  float acc[128];  // dV (warpgroup 0) or dK (warpgroup 1), all 256 columns
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const uint32_t a_base = smem_u32(wg == 0 ? Ks : Vs);
  const uint32_t q_base = smem_u32(Qs), g_base = smem_u32(Gs);
  mbar_wait(wg == 0 ? &bar_k : &bar_v, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const int m0 = (qt0 + t) * BM;
    const bool edge = m0 + BM > S || n0 + BN > S || (CAUSAL && m0 < n0 + BN);
    float* pt_x = xch + s * BM * BN;
    // This thread's columns' lse or delta, 0 past S, loaded while the
    // step's tiles land: column 8 (c >> 1) + c2 + (c & 1) at c.
    float stat[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int row = m0 + 8 * (c >> 1) + c2 + (c & 1);
      stat[c] = row < S ? stat_bh[row] * stat_mul : 0.f;
    }

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1).
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    mbar_wait(wg == 0 ? &bar_q[s] : &bar_g[s], parity);
    fence_operands(sacc);
    wgmma_fence();
    wgmma_ss_tiles<T, 256>(sacc, a_base, (wg == 0 ? q_base : g_base) + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sacc);

    uint32_t fa[4][4];
    if (wg == 0) {
      // P^T = exp(scale * S^T - lse) on the fragment, lse by column, 0
      // where masked; handed to warpgroup 1 in f32.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + c2 + (i & 1);
        float p = exp2f(fmaf(sacc[i], scale2, -stat[2 * (i >> 2) + (i & 1)]));
        if (edge) {
          const int k_pos = n0 + r_lo + 8 * ((i >> 1) & 1);
          const int q_pos = m0 + col;
          bool keep = q_pos < S && k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        sacc[i] = p;
        pt_x[i * NT + wt] = p;
      }
      mbar_arrive(&bar_p[s]);
    } else {
      // dS^T = P^T (dP^T - delta) (times mul.x), delta by column.
      mbar_wait(&bar_p[s], parity);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sacc[i] = pt_x[i * NT + wt] * (sacc[i] - stat[2 * (i >> 2) + (i & 1)]) * mul.x;
    }
    // P^T or dS^T as the A fragments of four k16 steps over the q rows.
    accum_to_a<T>(sacc, fa);

    // dV += P^T dO or dK += dS^T Q over the step's q rows, all 256 columns.
    mbar_wait(wg == 0 ? &bar_g[s] : &bar_q[s], parity);
    fence_operands(acc);
    wgmma_fence();
    wgmma_rs_tile<T, 256>(acc, fa, (wg == 0 ? g_base : q_base) + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_fragments(fa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[s]);
    if (wg == 1 && t + 2 < n_tiles) {
      // Every warp is done with stage s: refill it with step t + 2.
      mbar_wait(&bar_free[s], parity);
      if (lane == 0) load_q(t + 2, true, true);
    }
  }

  // dV, or scale dK, in T, staged in this warpgroup's K or V tile.
  uint8_t* stage = wg == 0 ? Ks : Vs;
  const float out_mul[2] = {wg == 0 ? 1.f : mul.y, wg == 0 ? 1.f : mul.y};
  stage_rows16<T, 256>(stage, acc, out_mul, r_lo, lane);
  fence_proxy_async();
  named_barrier(1 + wg, NT);
  if (wt == 0) {
    const CUtensorMap* out = wg == 0 ? &tdv : &tdk;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (64 * b < d) tma_store_3d(out, stage + b * BOX, 64 * b, n0, bh);
    tma_store_wait();
  }
}

template <typename T, bool CAUSAL>
int launch_bf16_dkv_wide(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  constexpr CUtensorMapDataType type = hopper::Elem16<T>::MAP;
  CUtensorMap tq, tk, tv, tg, tdk, tdv;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tdk, a.out0, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tdv, a.out1, a.BH, a.S, a.d, type);
  if (err) return err;
  constexpr int smem = wgmma_dkv_wide_smem_bytes();
  auto kern = flash_bwd_dkv_wgmma_wide_kernel<T, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.BH, (a.S + BN - 1) / BN);
  kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, tdk, tdv, a.lse, a.delta, a.S, a.d, a.scale);
  return (int)cudaGetLastError();
}

// The 16-bit kernels at tile width 256: dq's is flash_bwd_dq_wgmma_kernel<T,
// 256>, dk/dv's a kernel of its own.
template <typename T, bool DKV, bool CAUSAL>
int launch_bf16_wide(const Args& a, cudaStream_t stream) {
  if constexpr (DKV)
    return launch_bf16_dkv_wide<T, CAUSAL>(a, stream);
  else
    return launch_bf16<T, false, 256, CAUSAL>(a, stream);
}

// ------------------------------- 16-bit (bf16, f16) past head dim 256
//
// The bf16 and f16 dq and dk/dv kernels past d = 256
// (flash_bwd_dq_wgmma_deep_kernel, flash_bwd_dkv_wgmma_deep_kernel; one
// template each over the 16-bit type). PR 26's FFMA forms (256 threads of
// 4 x 4 micro-tiles in f32 arithmetic, 32-column chunks through shared
// memory, plain loads) took 118.02 us (dq) and 174.91 us (dk/dv) in bf16
// at BH 64, S 128, d 320, causal, 1.38x SDPA's backward together (PR 27
// run F, NVIDIA H100 80GB HBM3, 700.00 W). Past 256 a 64-row 16-bit tile of
// d columns does not stay resident beside a ring (40 KB at d = 320: K and
// V and two stages of Q and dO would take 240 KB), and an output of d
// columns is 160 f32 accumulator registers a thread at d = 320 in one
// warpgroup. Both kernels therefore take the deep forward's shape
// (flash_fwd.cu, flash_fwd_wgmma_deep_kernel):
//   - two warpgroups, each a pipeline of its own: its items land by TMA in
//     a ring of DEEP16_STAGES landing slots, one 128-byte box (64 rows x 64
//     columns) a warp, refilled once every warp of the warpgroup is done
//     with a slot; a score item is a chunk of 64 columns of d of the
//     product's two operands, an output item one box of the tile the
//     output product reads;
//   - the score products chain over the chunks in one accumulator
//     (wgmma's adds, as at W <= 256), both operands read K-major as they
//     land; the output products read their box MN-major, the A operand
//     (P^T, dS^T or dS) repacked from the score accumulator to T in
//     registers, one product of 64 columns an item;
//   - dq (flash_bwd_dq_wgmma_deep_kernel): warpgroup 0 runs S = Q K^T over
//     the chunks, warpgroup 1 dP = dO V^T; P (f32) goes to warpgroup 1
//     through shared memory, which returns dS = P (dP - delta) in its
//     place; a block owns up to 2 DEEP16_DQ_GROUPS groups of 64 dq columns
//     (the first half, rounded up, in warpgroup 0), grid axis z the rest
//     of d; each key tile streams q and dO again with k and v, and the k
//     boxes of the warpgroup's groups;
//   - dk/dv (flash_bwd_dkv_wgmma_deep_kernel): warpgroup 0 runs S^T = K
//     Q^T and dV += P^T dO, warpgroup 1 dP^T = V dO^T and dK += dS^T Q, as
//     the W = 256 kernel (flash_bwd_dkv_wgmma_wide_kernel); P^T (f32) goes
//     to warpgroup 1 through shared memory; a block owns DEEP16_DKV_GROUPS
//     groups of 64 columns of both outputs (320: 160 accumulator
//     registers a thread), grid axis z the rest; each q tile, from the
//     causal diagonal, streams k and v again with q and dO, and the dO (or
//     q) boxes of the block's groups; lse and delta by column go through
//     shared memory;
//   - the outputs are staged in T in the landing slots and stored by TMA
//     (no column past d, no row past S).
// P^T, P and dS^T, dS are rounded to T as the A operands of the output
// products, as the W <= 256 16-bit kernels do (f16 rounds scale dS:
// ds_scales). Each output tile is owned by one block and summed in a fixed
// order: no atomics, and a run is bit-reproducible. Shared memory: six
// landing slots of two boxes a warpgroup and the 64 x 64 f32 exchange:
// 214,016 B, one block an SM. Registers: dq 217-222, dk/dv 247-248, no
// spills. At BH 64, S 128, d 320, causal, in turns against the FFMA forms
// (scripts/flash_deep_times.py, CUDA-graph timer, NVIDIA H100 80GB HBM3,
// 700.00 W): dq 13.24 / 13.09 us in bf16 / f16 against 117.4 / 116.2, dk/dv
// 16.70 / 16.29 against 174.3 / 176.5; at d 512 dq 18.46 / 17.85, dk/dv
// 31.66 / 31.20. The heaviest block spends 21-32% of its cycles at the
// warpgroup's barrier and the refill's TMA issue, 21-23% issuing wgmma
// and 13-15% waiting for TMA (scripts/flash_deep_probe.py). Their phase-8
// times, against the plain versions and SDPA, are in PERF.md §6.
constexpr int DEEP16_DQ_GROUPS = 4;   // 64-column groups of dq a warpgroup owns
constexpr int DEEP16_DKV_GROUPS = 5;  // 64-column groups of dk and of dv a block owns
constexpr int DEEP16_STAGES = 6;      // landing slots of a warpgroup

__host__ __device__ constexpr int deep16_bwd_smem_bytes() {
  return 2 * DEEP16_STAGES * 2 * 64 * 128 + 64 * 64 * 4 + 1024;
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dq_wgmma_deep_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,
                               const __grid_constant__ CUtensorMap tdq,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               int S, int d, float scale) {
  using namespace hopper;
  constexpr int G = DEEP16_DQ_GROUPS, STAGES = DEEP16_STAGES;
  constexpr int BOX = 64 * 128;  // bytes of a 64-column box of 64 rows
  constexpr int LAND = 2 * BOX;  // a landing slot: the A chunk, then the B chunk; or a k box

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * STAGES * LAND;
  // P, then dS, 64 x 64 f32 in fragment order (each thread its own slots).
  float* xch = reinterpret_cast<float*>(base + 2 * STAGES * LAND);

  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BN - 1) / BN;
  if (CAUSAL) {
    // K tiles wholly above the diagonal are skipped (pallas_attention.py:113-117).
    n_tiles = min((min(m0 + BM, S) + BN - 1) / BN, n_tiles);
  }
  // This block's groups of dq: up to 2 G from gb, those below d; warpgroup
  // 0 takes the first half (rounded up), warpgroup 1 the rest.
  const int gb = 2 * G * blockIdx.z;
  const int ng_all = min(2 * G, (d + 63) / 64 - gb), ng0 = (ng_all + 1) / 2;
  const int g0 = wg == 0 ? gb : gb + ng0, ng = wg == 0 ? ng0 : ng_all - ng0;
  const int nc = (d + 63) / 64;
  const int per_tile = nc + ng, items = n_tiles * per_tile;
  const CUtensorMap* ta = wg == 0 ? &tq : &tg;  // A of S or dP: the block's rows
  const CUtensorMap* tb = wg == 0 ? &tk : &tv;  // B of S or dP: the key tile
  // Item i of this warpgroup (place j of key tile t) into its landing
  // slot, one box a warp: a score item's A chunk from warp 0 and its B
  // chunk from warp 1, an output item's k box from warp 0. Every warp
  // arrives once (a slot's barrier counts 4), each with the bytes it asks
  // for.
  auto issue = [&](int i) {
    const int t = i / per_tile, j = i % per_tile;
    uint8_t* dst = land + (i % STAGES) * LAND;
    uint64_t* bar = &full[wg][i % STAGES];
    if (j < nc && warp < 2) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst + warp * BOX, warp == 0 ? ta : tb, bar, 64 * j, warp == 0 ? m0 : t * BN, bh);
    } else if (j >= nc && warp == 0) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst, &tk, bar, 64 * (g0 + j - nc), t * BN, bh);
    } else {
      mbar_arrive(bar);
    }
  };
  // Every warp of the warpgroup is done with item i (its products have
  // completed): refill its slot with item i + STAGES.
  auto release = [&](int i) {
    named_barrier(1 + wg, NT);
    if (lane == 0 && i + STAGES < items) issue(i + STAGES);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[0][s], 4);  // one arrival a warp
      mbar_init(&full[1][s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0) {
    prefetch_map(warp == 0 ? ta : warp == 1 ? tb : warp == 2 ? &tk : &tdq);
    for (int i = 0; i < STAGES && i < items; ++i) issue(i);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator; its rows' lse (in
  // log2 units, warpgroup 0) or delta (warpgroup 1), 0 past S.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float stat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r_lo + 8 * h;
    const float* src = wg == 0 ? lse : delta;
    stat[h] = row < S ? src[(size_t)bh * S + row] * (wg == 0 ? LOG2E : 1.f) : 0.f;
  }
  const float scale2 = scale * LOG2E;
  const float2 mul = ds_scales<T>(scale);
  float acc[G][32] = {};  // dq's groups g0.. of this warpgroup

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    // S (warpgroup 0) or dP (warpgroup 1) over the chunks.
    float sacc[32] = {};
    deep16_scores<T, STAGES>(sacc, land, full[wg], i, nc, release);

    // P = exp(scale * S - lse), 0 where masked (warpgroup 0), handed to
    // warpgroup 1 (barrier 3), which returns dS = P (dP - delta) (times
    // mul.x) in its place (barrier 4); warpgroup 0 writes the next tile's
    // P only after reading this tile's dS.
    if (wg == 0) {
      const int k0 = t * BN;
      const bool edge = k0 + BN > S || (CAUSAL && k0 + BN > m0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        float p = exp2f(fmaf(sacc[e], scale2, -stat[h]));
        if (edge) {
          const int q_pos = m0 + r_lo + 8 * h;
          const int k_pos = k0 + 8 * (e >> 2) + c2 + (e & 1);
          bool keep = k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        xch[e * NT + wt] = p;
      }
      named_arrive(3, 2 * NT);
      named_barrier(4, 2 * NT);
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] = xch[e * NT + wt];
    } else {
      named_barrier(3, 2 * NT);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sacc[e] = xch[e * NT + wt] * (sacc[e] - stat[(e >> 1) & 1]) * mul.x;
        xch[e * NT + wt] = sacc[e];
      }
      named_arrive(4, 2 * NT);
    }
    // dS as the A fragments of four k16 steps over this tile's 64 keys.
    uint32_t da[4][4];
    accum_to_a<T>(sacc, da);
    PROBE_MARK(i, 7);

    // dQ_g += dS K_g for each of this warpgroup's groups.
    deep16_outputs<T, G, STAGES>(acc, da, land, full[wg], i, ng, release);
  }

  // dQ (times mul.y) in T, staged in this warpgroup's landing slots (each
  // item is consumed, none is in flight) and stored by TMA.
  const float out_mul[2] = {mul.y, mul.y};
  static_for<G>([&](auto gc) {
    constexpr int g = decltype(gc)::value;
    if (g < ng) stage_rows16<T, 64>(land + g * BOX, acc[g], out_mul, r_lo, lane);
  });
  fence_proxy_async();
  named_barrier(1 + wg, NT);
  if (wt == 0) {
    for (int g = 0; g < ng; ++g) tma_store_3d(&tdq, land + g * BOX, 64 * (g0 + g), m0, bh);
    tma_store_wait();
  }
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_bwd_dkv_wgmma_deep_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tg,
                                const __grid_constant__ CUtensorMap tdk,
                                const __grid_constant__ CUtensorMap tdv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                int S, int d, float scale) {
  using namespace hopper;
  constexpr int NI = DEEP16_DKV_GROUPS, STAGES = DEEP16_STAGES;
  constexpr int BOX = 64 * 128;  // bytes of a 64-column box of 64 rows
  constexpr int LAND = 2 * BOX;  // a landing slot: the A chunk, then the B chunk; or a box

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  // The q tile's lse (in log2 units, warpgroup 0) or delta (warpgroup 1)
  // by row, 0 past S.
  __shared__ float stat_s[2][BM];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * STAGES * LAND;
  // P^T, 64 x 64 f32 in fragment order (each thread its own slots).
  float* xch = reinterpret_cast<float*>(base + 2 * STAGES * LAND);

  const int bh = blockIdx.x;
  // k tile 0 walks the most causal q tiles and launches first.
  const int n0 = blockIdx.y * BN;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt0 = CAUSAL ? n0 / BM : 0;
  const int n_tiles = (S + BM - 1) / BM - qt0;
  // This block's groups of dK and dV: NI from col0, those below d.
  const int col0 = 64 * NI * blockIdx.z;
  const int nc = (d + 63) / 64, ng = min(NI, (d - col0 + 63) / 64);
  const int per_tile = nc + ng, items = n_tiles * per_tile;
  const CUtensorMap* ta = wg == 0 ? &tk : &tv;  // A of S^T or dP^T: the block's rows
  const CUtensorMap* tb = wg == 0 ? &tq : &tg;  // B of S^T or dP^T: the q tile
  const CUtensorMap* tx = wg == 0 ? &tg : &tq;  // B of dV or dK
  // Item i of this warpgroup into its landing slot, as in the dq kernel:
  // an output item is a box of dO (warpgroup 0) or q (warpgroup 1).
  auto issue = [&](int i) {
    const int t = i / per_tile, j = i % per_tile, m = (qt0 + t) * BM;
    uint8_t* dst = land + (i % STAGES) * LAND;
    uint64_t* bar = &full[wg][i % STAGES];
    if (j < nc && warp < 2) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst + warp * BOX, warp == 0 ? ta : tb, bar, 64 * j, warp == 0 ? n0 : m, bh);
    } else if (j >= nc && warp == 0) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst, tx, bar, col0 + 64 * (j - nc), m, bh);
    } else {
      mbar_arrive(bar);
    }
  };
  auto release = [&](int i) {
    named_barrier(1 + wg, NT);
    if (lane == 0 && i + STAGES < items) issue(i + STAGES);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[0][s], 4);  // one arrival a warp
      mbar_init(&full[1][s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0) {
    prefetch_map(warp == 0 ? ta : warp == 1 ? tb : warp == 2 ? tx : wg == 0 ? &tdv : &tdk);
    for (int i = 0; i < STAGES && i < items; ++i) issue(i);
  }

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  const float2 mul = ds_scales<T>(scale);
  const float* stat_g = (wg == 0 ? lse : delta) + (size_t)bh * S;
  const float stat_mul = wg == 0 ? LOG2E : 1.f;
  float acc[NI][32] = {};  // dV (warpgroup 0) or dK (warpgroup 1), groups 0..ng-1

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    const int m0 = (qt0 + t) * BM;
    if (wt < BM) {
      // Written before the first barrier of this tile's score chunks, read
      // at its exchange; the last tile's values were read before the
      // barriers of its output items.
      const int row = m0 + wt;
      stat_s[wg][wt] = row < S ? stat_g[row] * stat_mul : 0.f;
    }
    // S^T (warpgroup 0) or dP^T (warpgroup 1) over the chunks.
    float sacc[32] = {};
    deep16_scores<T, STAGES>(sacc, land, full[wg], i, nc, release);

    // P^T = exp(scale * S^T - lse) by column, 0 where masked (warpgroup 0),
    // handed to warpgroup 1 (barrier 3) for dS^T = P^T (dP^T - delta)
    // (times mul.x); barrier 4 says that warpgroup 1 has read it.
    const bool edge = m0 + BM > S || n0 + BN > S || (CAUSAL && m0 < n0 + BN);
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e >> 2) + c2 + (e & 1);
        float p = exp2f(fmaf(sacc[e], scale2, -stat_s[0][col]));
        if (edge) {
          const int k_pos = n0 + r_lo + 8 * ((e >> 1) & 1);
          const int q_pos = m0 + col;
          bool keep = q_pos < S && k_pos < S;
          if (CAUSAL) keep = keep && q_pos >= k_pos;
          if (!keep) p = 0.f;
        }
        sacc[e] = p;
      }
      if (t > 0) named_barrier(4, 2 * NT);  // warpgroup 1 has read the last tile's
#pragma unroll
      for (int e = 0; e < 32; ++e) xch[e * NT + wt] = sacc[e];
      named_arrive(3, 2 * NT);
    } else {
      named_barrier(3, 2 * NT);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e >> 2) + c2 + (e & 1);
        sacc[e] = xch[e * NT + wt] * (sacc[e] - stat_s[1][col]) * mul.x;
      }
      if (t + 1 < n_tiles) named_arrive(4, 2 * NT);
    }
    // P^T or dS^T as the A fragments of four k16 steps over the q rows.
    uint32_t fa[4][4];
    accum_to_a<T>(sacc, fa);
    PROBE_MARK(i, 7);

    // dV_g += P^T dO_g or dK_g += dS^T Q_g for each group.
    deep16_outputs<T, NI, STAGES>(acc, fa, land, full[wg], i, ng, release);
  }

  // dV, or scale dK (mul.y), in T, staged in this warpgroup's landing
  // slots and stored by TMA.
  const float m = wg == 0 ? 1.f : mul.y;
  const float out_mul[2] = {m, m};
  static_for<NI>([&](auto gc) {
    constexpr int g = decltype(gc)::value;
    if (g < ng) stage_rows16<T, 64>(land + g * BOX, acc[g], out_mul, r_lo, lane);
  });
  fence_proxy_async();
  named_barrier(1 + wg, NT);
  if (wt == 0) {
    const CUtensorMap* out = wg == 0 ? &tdv : &tdk;
    for (int g = 0; g < ng; ++g) tma_store_3d(out, land + g * BOX, col0 + 64 * g, n0, bh);
    tma_store_wait();
  }
}

// The 16-bit deep forms: q, k, v and dO, and the outputs (dq, or dk and
// dv), through 64-row tensor maps.
template <typename T, bool DKV, bool CAUSAL>
int launch_bf16_deep(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  constexpr CUtensorMapDataType type = hopper::Elem16<T>::MAP;
  CUtensorMap tq, tk, tv, tg, t0, t1;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, a.d, type);
  if (!err) err = hopper::encode_map(encode, &t0, a.out0, a.BH, a.S, a.d, type);
  if (!err && DKV) err = hopper::encode_map(encode, &t1, a.out1, a.BH, a.S, a.d, type);
  if (err) return err;
  constexpr int smem = deep16_bwd_smem_bytes();
  const int groups = (a.d + 63) / 64;
  cudaError_t e;
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_wgmma_deep_kernel<T, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.BH, (a.S + BN - 1) / BN, (groups + DEEP16_DKV_GROUPS - 1) / DEEP16_DKV_GROUPS);
    kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, t0, t1, a.lse, a.delta, a.S, a.d, a.scale);
  } else {
    auto kern = flash_bwd_dq_wgmma_deep_kernel<T, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.BH, (a.S + BM - 1) / BM, (groups + 2 * DEEP16_DQ_GROUPS - 1) / (2 * DEEP16_DQ_GROUPS));
    kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, t0, a.lse, a.delta, a.S, a.d, a.scale);
  }
  return (int)cudaGetLastError();
}

// The f32 deep forms: dq (flash_bwd_dq_tf32_deep_kernel) through 64-row
// chunks of every operand, dk/dv (flash_bwd_dkv_tf32_deep_kernel) through
// 64-row chunks of k and v and WIDE_DKV_ROWS-row chunks of q and dO.
template <bool DKV, bool CAUSAL>
int launch_tf32_deep(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  const int q_rows = DKV ? WIDE_DKV_ROWS : 64;
  CUtensorMap tq, tk, tv, tg;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, a.d, F32, q_rows);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, a.d, F32, 64);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, a.d, F32, 64);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, a.d, F32, q_rows);
  if (err) return err;
  const int items = (a.d + 63) / 64;
  cudaError_t e;
  if constexpr (DKV) {
    constexpr int smem = deep_dkv_smem_bytes();
    auto kern = flash_bwd_dkv_tf32_deep_kernel<CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.BH, (a.S + 63) / 64, (items + DEEP_DKV_ITEMS - 1) / DEEP_DKV_ITEMS);
    kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (float*)a.out0,
                                         (float*)a.out1, a.S, a.d, a.scale);
  } else {
    constexpr int smem = deep_dq_smem_bytes();
    const int ni = deep_dq_items(a.d);
    auto kern = ni == 3 ? flash_bwd_dq_tf32_deep_kernel<3, CAUSAL>
                        : flash_bwd_dq_tf32_deep_kernel<4, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.BH, (a.S + 63) / 64, (items + 2 * ni - 1) / (2 * ni));
    kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (float*)a.out0, a.S,
                                         a.d, a.scale);
  }
  return (int)cudaGetLastError();
}

typedef int (*Launcher)(const Args&, cudaStream_t);

// The launcher by dtype (0 f32, 1 bf16, 2 f16), tile width
// (hopper::tile_width of a.d; past 256 the deep form) and mask.
template <bool DKV>
int dispatch(const Args& a, int dtype, int causal, void* stream) {
  using bf16_t = __nv_bfloat16;
  static const Launcher f32[3][2] = {
      {launch_tf32<DKV, 64, false>, launch_tf32<DKV, 64, true>},
      {launch_tf32<DKV, 128, false>, launch_tf32<DKV, 128, true>},
      {launch_tf32_wide<DKV, false>, launch_tf32_wide<DKV, true>}};
  static const Launcher bf16[3][2] = {
      {launch_bf16<bf16_t, DKV, 64, false>, launch_bf16<bf16_t, DKV, 64, true>},
      {launch_bf16<bf16_t, DKV, 128, false>, launch_bf16<bf16_t, DKV, 128, true>},
      {launch_bf16_wide<bf16_t, DKV, false>, launch_bf16_wide<bf16_t, DKV, true>}};
  static const Launcher f16[3][2] = {
      {launch_bf16<__half, DKV, 64, false>, launch_bf16<__half, DKV, 64, true>},
      {launch_bf16<__half, DKV, 128, false>, launch_bf16<__half, DKV, 128, true>},
      {launch_bf16_wide<__half, DKV, false>, launch_bf16_wide<__half, DKV, true>}};
  static const Launcher deep_forms[3][2] = {
      {launch_tf32_deep<DKV, false>, launch_tf32_deep<DKV, true>},
      {launch_bf16_deep<bf16_t, DKV, false>, launch_bf16_deep<bf16_t, DKV, true>},
      {launch_bf16_deep<__half, DKV, false>, launch_bf16_deep<__half, DKV, true>}};
  if (a.BH <= 0 || a.S <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  const int w = hopper::tile_width(a.d, dtype == 0 ? 4 : 2);
  if (w == 0) return (int)cudaErrorInvalidValue;
  const int c = causal != 0;
  if (w == hopper::DEEP) return deep_forms[dtype][c](a, (cudaStream_t)stream);
  const int i = w == 64 ? 0 : w == 128 ? 1 : 2;
  if (dtype == 0) return f32[i][c](a, (cudaStream_t)stream);
  return (dtype == 1 ? bf16 : f16)[i][c](a, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32 wgmma kernels), 1 = bfloat16 and 2 = float16
// (the 16-bit wgmma kernels); past D = 256 the deep forms of the dtype. Each returns a cudaError_t (0 on success) or one of hopper.cuh's
// ERR_* codes.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, void* dq, int BH, int S, int D,
                 int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dq, nullptr, BH, S, D, scale};
  return dispatch<false>(a, dtype, causal, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                  int D, int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dk, dv, BH, S, D, scale};
  return dispatch<true>(a, dtype, causal, stream);
}

// The checks of the split and of the fragment re-layout (tests on the card):
// hi and lo words of n values; C = X Y with X 64 x 64 and Y 64 x N, N = 64
// or 128.
int tf32_split_probe(const float* x, void* hi, void* lo, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  tf32_split_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, (uint32_t*)hi, (uint32_t*)lo, n);
  return (int)cudaGetLastError();
}

int tf32_relayout_probe(const float* x, const float* y, float* c, int N, void* stream) {
  if (N != 64 && N != 128) return (int)cudaErrorInvalidValue;
  const int smem = 2 * 64 * N * 4 + 2 * N * 128 * 2 + 1024;
  auto kern = N == 64 ? tf32_relayout_probe_kernel<64> : tf32_relayout_probe_kernel<128>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, TF32_NT, smem, (cudaStream_t)stream>>>(x, y, c);
  return (int)cudaGetLastError();
}

const char* flash_bwd_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
