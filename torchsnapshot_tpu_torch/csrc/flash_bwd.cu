// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bf16 on the tensor cores (wgmma fed by TMA), f32 by FFMA on the
// CUDA cores.
//
// Replaces the Pallas TPU kernels of torchsnapshot_tpu/ops/pallas_attention.py:
//   - `_bwd_dq_kernel` (lines 94-143, called at line 263) by
//     flash_bwd_dq_wgmma_kernel (bf16) and flash_bwd_dq_f32_kernel (f32);
//   - `_bwd_dkv_kernel` (lines 146-200, called at line 278) by
//     flash_bwd_dkv_wgmma_kernel (bf16) and flash_bwd_dkv_f32_kernel (f32).
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
//
// The TPU split is kept: dq is gridded over q tiles and streams K/V; dk/dv
// is gridded over k tiles and streams Q/dO. Each output tile is owned by one
// block and its products are summed in a fixed order, so there are no
// atomics and a run is bit-reproducible (a resumed training step repeats
// bit for bit). Tiles are the kernels' own, 64 rows: S need not be a
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
// Rounding: the products run on the unscaled bf16 inputs (bf16 x bf16
// products are exact in f32) and the f32 scores are scaled after. P and dS
// are rounded to bf16 to be the A operands of the last products, which the
// TPU kernels and the f32 design do not do; the tests hold these kernels
// to a plain recompute that rounds P and dS the same way.
//
// f32 design (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel): the FFMA
// kernels of the first design, kept for f32 inputs, whose 1e-4 gradient bar
// forbids TF32. Multiplied in full f32.
//   - dq: 128 threads per (bh, 64-row q tile). q and dO tiles, the current
//     K and V tiles and the 64x64 ds tile live in shared memory (rows
//     padded by one word against bank conflicts); dq accumulates in
//     registers, a 4-row by D/8-column micro-tile per thread.
//   - dk/dv: 256 threads per (bh, 64-row k tile), so that both accumulators
//     fit in registers (2 rows a thread); K and V tiles stay in shared
//     memory, q and dO tiles stream; p^T and ds^T tiles go through shared
//     memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // k rows per tile
constexpr int NT = 128;  // threads of a wgmma block: one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16

template <int D>
constexpr int wgmma_smem_bytes() {
  // Two resident tiles, two stages of two streamed tiles, and slack to
  // align the base to 1024.
  return 6 * 64 * D * 2 + 1024;
}

// Rows r_lo and r_lo + 8 of a 64 x D f32 accumulator fragment, times
// `mul`, as bf16 into rows row0 + r_lo (+ 8) of a (S, D) tensor; rows past
// S are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&acc)[D / 2],
                                           float mul, int row0, int r_lo, int c2, int S) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_lo + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, float scale) {
  using namespace hopper;
  constexpr int TILE = 64 * D * 2;  // bytes of one 64-row tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg, bar_kv[2], bar_free[2];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Gs = Qs + TILE;      // dO
  uint8_t* Ks = Qs + 2 * TILE;  // two stages
  uint8_t* Vs = Qs + 4 * TILE;  // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
    tma_tile<D>(Ks + s * TILE, &tk, &bar_kv[s], t * BN, bh);
    tma_tile<D>(Vs + s * TILE, &tv, &bar_kv[s], t * BN, bh);
  };

  if (tid == 0) {
    mbar_init(&bar_qg, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_kv[s], 1);
      mbar_init(&bar_free[s], NT / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar_qg, 2 * TILE);
    tma_tile<D>(Qs, &tq, &bar_qg, m0, bh);
    tma_tile<D>(Gs, &tg, &bar_qg, m0, bh);
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
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_base = smem_u32(Qs), g_base = smem_u32(Gs);
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
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
    wgmma_ss_tiles<D>(sacc, q_base, k_base + s * TILE);
    wgmma_commit();
    wgmma_ss_tiles<D>(pacc, g_base, v_base + s * TILE);
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
    // dS = P (dP - delta), as the bf16 A fragments of four k16 steps over
    // this tile's 64 keys.
#pragma unroll
    for (int i = 0; i < 32; ++i) pacc[i] = sacc[i] * (pacc[i] - dlt[(i >> 1) & 1]);
    uint32_t da[4][4];
    accum_to_a(pacc, da);

    // dQ += dS K over the tile's keys.
    fence_operands(acc);
    wgmma_fence();
    wgmma_rs_tile<D>(acc, da, k_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_fragments(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[s]);
  }

  store_rows<D>(dq + (size_t)bh * S * D, acc, scale, m0, r_lo, c2, S);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int S, float scale) {
  using namespace hopper;
  constexpr int TILE = 64 * D * 2;  // bytes of one 64-row tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[2], bar_free[2];
  // Each stage's q tile: lse (in log2 units) and delta by column, 0 past S.
  __shared__ __align__(8) float lse2_s[2][BM], dlt_s[2][BM];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Ks + 2 * TILE;  // two stages
  uint8_t* Gs = Ks + 4 * TILE;  // dO, two stages

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
      tma_tile<D>(Qs + s * TILE, &tq, &bar_full[s], m, bh);
      tma_tile<D>(Gs + s * TILE, &tg, &bar_full[s], m, bh);
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
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar_kv, 2 * TILE);
      tma_tile<D>(Ks, &tk, &bar_kv, n0, bh);
      tma_tile<D>(Vs, &tv, &bar_kv, n0, bh);
    }
    load_q(0);
    if (n_tiles > 1) load_q(1);
  }

  // This thread's rows of the k tile (r_lo and r_lo + 8) and its first
  // column (q) in each 8-column chunk of a score accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  const uint32_t q_base = smem_u32(Qs), g_base = smem_u32(Gs);
  mbar_wait(&bar_kv, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    if (warp == 0 && t >= 1 && t + 1 < n_tiles) {
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
    wgmma_ss_tiles<D>(sacc, k_base, q_base + s * TILE);
    wgmma_commit();
    wgmma_ss_tiles<D>(pacc, v_base, g_base + s * TILE);
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
    // dS^T = P^T (dP^T - delta); both as the bf16 A fragments of four k16
    // steps over this step's 64 q rows.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + c2 + (i & 1);
      pacc[i] = sacc[i] * (pacc[i] - dlt_t[col]);
    }
    uint32_t pa[4][4], da[4][4];
    accum_to_a(sacc, pa);
    accum_to_a(pacc, da);

    // dV += P^T dO and dK += dS^T Q over the step's q rows.
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    wgmma_fence();
    wgmma_rs_tile<D>(dv_acc, pa, g_base + s * TILE);
    wgmma_rs_tile<D>(dk_acc, da, q_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    fence_fragments(pa);
    fence_fragments(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[s]);
  }

  const size_t base = (size_t)bh * S * D;
  store_rows<D>(dk + base, dk_acc, scale, n0, r_lo, c2, S);
  store_rows<D>(dv + base, dv_acc, 1.f, n0, r_lo, c2, S);
}

// ----------------------------------------------------------------- f32

// A 64-row tile of a (S, D) operand into shared memory with row stride
// D + 1; rows past S load as zeros.
template <int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < S ? src[(size_t)row * D + d] : 0.f;
  }
}

// lse and delta of a 64-row q tile; rows past S load as zeros.
__device__ __forceinline__ void load_stats(float* lse_s, float* dlt_s, const float* lse,
                                           const float* delta, int row0, int S) {
  const int t = threadIdx.x;
  if (t < BM) {
    const int row = row0 + t;
    lse_s[t] = row < S ? lse[row] : 0.f;
    dlt_s[t] = row < S ? delta[row] : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Qs, Gs (dO), Ks, Vs: 64 x (D+1) each; Ds: 64 x 65; lse, delta: 64 each.
  return 4 * 64 * (D + 1) + BM * (BN + 1) + 2 * BM;
}

template <int D>
constexpr int dkv_smem_floats() {
  // Ks, Vs, Qs, Gs: 64 x (D+1) each; Ps, Ds (transposed): 64 x 65 each;
  // lse, delta: 64 each.
  return 4 * 64 * (D + 1) + 2 * BN * (BM + 1) + 2 * BM;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, float scale) {
  constexpr int NT = 128, RT = 4, LD = D + 1, DJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                  // BM x LD
  float* Gs = Qs + BM * LD;          // BM x LD
  float* Ks = Gs + BM * LD;          // BN x LD
  float* Vs = Ks + BN * LD;          // BN x LD
  float* Ds = Vs + BN * LD;          // BM x (BN+1)
  float* lse_s = Ds + BM * (BN + 1);  // BM
  float* dlt_s = lse_s + BM;          // BM

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const size_t base = (size_t)bh * S * D;

  load_tile<D, NT>(Qs, q + base, m0, S);
  load_tile<D, NT>(Gs, g + base, m0, S);
  load_stats(lse_s, dlt_s, lse + (size_t)bh * S, delta + (size_t)bh * S, m0, S);

  // Micro-tile ownership: rows rg*RT+i, columns cg+8*j.
  const int rg = tid / 8, cg = tid % 8;
  float acc[RT][DJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles_all = (S + BN - 1) / BN;
  int n_tiles = n_tiles_all;
  if (CAUSAL) {
    // K tiles wholly above the diagonal are skipped (pallas_attention.py:113-117).
    const int q_end = min(m0 + BM, S);
    n_tiles = min((q_end + BN - 1) / BN, n_tiles_all);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ds are done
    load_tile<D, NT>(Ks, k + base, k0, S);
    load_tile<D, NT>(Vs, v + base, k0, S);
    __syncthreads();

    // s = q . k and dp = dO . v for the micro-tile.
    float s[RT][8], dp[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RT], gv[RT], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        qv[i] = Qs[(rg * RT + i) * LD + d];
        gv[i] = Gs[(rg * RT + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(cg + 8 * j) * LD + d];
        vv[j] = Vs[(cg + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg * RT + i;
      const int q_pos = m0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        const int k_pos = k0 + c;
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && (q_pos >= k_pos);
        const float sc = keep ? scale * s[i][j] : NEG_INF;
        const float p = expf(sc - lse_s[r]);
        Ds[r * (BN + 1) + c] = p * (dp[i][j] - dlt_s[r]);
      }
    }
    __syncthreads();

    // dq += ds . k
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float dsv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) dsv[i] = Ds[(rg * RT + i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[n * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = m0 + rg * RT + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + (size_t)row * D + cg + 8 * j] = acc[i][j] * scale;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, float scale) {
  constexpr int NT = 256, RT = 2, LD = D + 1, DJ = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;                  // BN x LD
  float* Vs = Ks + BN * LD;          // BN x LD
  float* Qs = Vs + BN * LD;          // BM x LD
  float* Gs = Qs + BM * LD;          // BM x LD
  float* Ps = Gs + BM * LD;          // p^T, BN x (BM+1)
  float* Ds = Ps + BN * (BM + 1);    // ds^T, BN x (BM+1)
  float* lse_s = Ds + BN * (BM + 1);  // BM
  float* dlt_s = lse_s + BM;          // BM

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const size_t base = (size_t)bh * S * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* dlt_bh = delta + (size_t)bh * S;

  load_tile<D, NT>(Ks, k + base, n0, S);
  load_tile<D, NT>(Vs, v + base, n0, S);

  // Micro-tile ownership: k rows rg*RT+i; q columns (and output columns)
  // cg+8*j.
  const int rg = tid / 8, cg = tid % 8;
  float acc_k[RT][DJ], acc_v[RT][DJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q_tiles = (S + BM - 1) / BM;
  // The first q tile that can see this k tile (pallas_attention.py:163).
  const int qt_start = CAUSAL ? n0 / BM : 0;

  for (int qt = qt_start; qt < n_q_tiles; ++qt) {
    const int m0 = qt * BM;
    __syncthreads();  // the previous tile's readers of Qs, Gs, Ps and Ds are done
    load_tile<D, NT>(Qs, q + base, m0, S);
    load_tile<D, NT>(Gs, g + base, m0, S);
    load_stats(lse_s, dlt_s, lse_bh, dlt_bh, m0, S);
    __syncthreads();

    // s^T = k . q and dp^T = v . dO for the micro-tile.
    float s[RT][8], dp[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RT], vv[RT], qv[8], gv[8];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        kv[i] = Ks[(rg * RT + i) * LD + d];
        vv[i] = Vs[(rg * RT + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = Qs[(cg + 8 * j) * LD + d];
        gv[j] = Gs[(cg + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(gv[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int kr = rg * RT + i;
      const int k_pos = n0 + kr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = cg + 8 * j;
        const int q_pos = m0 + qc;
        bool keep = k_pos < S && q_pos < S;
        if (CAUSAL) keep = keep && (q_pos >= k_pos);
        const float sc = keep ? scale * s[i][j] : NEG_INF;
        const float p = expf(sc - lse_s[qc]);
        Ps[kr * (BM + 1) + qc] = p;
        Ds[kr * (BM + 1) + qc] = p * (dp[i][j] - dlt_s[qc]);
      }
    }
    __syncthreads();

    // dv += p^T . dO and dk += ds^T . q
#pragma unroll 4
    for (int m = 0; m < BM; ++m) {
      float pv[RT], dsv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        pv[i] = Ps[(rg * RT + i) * (BM + 1) + m];
        dsv[i] = Ds[(rg * RT + i) * (BM + 1) + m];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float gg = Gs[m * LD + cg + 8 * j];
        const float qq = Qs[m * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          acc_v[i][j] = fmaf(pv[i], gg, acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qq, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = n0 + rg * RT + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = base + (size_t)row * D + cg + 8 * j;
      dk[off] = acc_k[i][j] * scale;
      dv[off] = acc_v[i][j];
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *out0, *out1;  // dq (out1 unused), or dk and dv
  int BH, S;
  float scale;
};

template <bool DKV, int D, bool CAUSAL>
int launch_f32(const Args& a, cudaStream_t stream) {
  const float *q = (const float*)a.q, *k = (const float*)a.k, *v = (const float*)a.v,
              *g = (const float*)a.g;
  cudaError_t err;
  if constexpr (DKV) {
    constexpr int smem = dkv_smem_floats<D>() * (int)sizeof(float);
    auto kern = flash_bwd_dkv_f32_kernel<D, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.BH, (a.S + BN - 1) / BN);
    kern<<<grid, 256, smem, stream>>>(q, k, v, g, a.lse, a.delta, (float*)a.out0,
                                      (float*)a.out1, a.S, a.scale);
  } else {
    constexpr int smem = dq_smem_floats<D>() * (int)sizeof(float);
    auto kern = flash_bwd_dq_f32_kernel<D, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.BH, (a.S + BM - 1) / BM);
    kern<<<grid, 128, smem, stream>>>(q, k, v, g, a.lse, a.delta, (float*)a.out0, a.S, a.scale);
  }
  return (int)cudaGetLastError();
}

template <bool DKV, int D, bool CAUSAL>
int launch_bf16(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv, tg;
  int err = hopper::encode_map(encode, &tq, a.q, a.BH, a.S, D);
  if (!err) err = hopper::encode_map(encode, &tk, a.k, a.BH, a.S, D);
  if (!err) err = hopper::encode_map(encode, &tv, a.v, a.BH, a.S, D);
  if (!err) err = hopper::encode_map(encode, &tg, a.g, a.BH, a.S, D);
  if (err) return err;
  constexpr int smem = wgmma_smem_bytes<D>();
  // Both kernels tile S by 64 rows (BM = BN).
  dim3 grid(a.BH, (a.S + BM - 1) / BM);
  cudaError_t e;
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_wgmma_kernel<D, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (__nv_bfloat16*)a.out0,
                                     (__nv_bfloat16*)a.out1, a.S, a.scale);
  } else {
    auto kern = flash_bwd_dq_wgmma_kernel<D, CAUSAL>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, stream>>>(tq, tk, tv, tg, a.lse, a.delta, (__nv_bfloat16*)a.out0,
                                     a.S, a.scale);
  }
  return (int)cudaGetLastError();
}

typedef int (*Launcher)(const Args&, cudaStream_t);

template <bool DKV>
int dispatch(const Args& a, int D, int dtype, int causal, void* stream) {
  static const Launcher f32[2][2] = {
      {launch_f32<DKV, 64, false>, launch_f32<DKV, 64, true>},
      {launch_f32<DKV, 128, false>, launch_f32<DKV, 128, true>}};
  static const Launcher bf16[2][2] = {
      {launch_bf16<DKV, 64, false>, launch_bf16<DKV, 64, true>},
      {launch_bf16<DKV, 128, false>, launch_bf16<DKV, 128, true>}};
  if (a.BH <= 0 || a.S <= 0 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const int d = D == 128, c = causal != 0;
  if (dtype == 0) return f32[d][c](a, (cudaStream_t)stream);
  if (dtype == 1) return bf16[d][c](a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FFMA kernels), 1 = bfloat16 (wgmma kernels). Each
// returns a cudaError_t (0 on success) or one of hopper.cuh's ERR_* codes.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, void* dq, int BH, int S, int D,
                 int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dq, nullptr, BH, S, scale};
  return dispatch<false>(a, D, dtype, causal, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                  int D, int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, g, lse, delta, dk, dv, BH, S, scale};
  return dispatch<true>(a, D, dtype, causal, stream);
}

const char* flash_bwd_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
