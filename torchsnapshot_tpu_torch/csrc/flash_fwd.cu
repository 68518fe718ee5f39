// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma fed by TMA), f32 by FFMA on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_kernel` of
// torchsnapshot_tpu/ops/pallas_attention.py (lines 44-91), launched by
// `fwd_impl` in `_make_flash_parts` (line 237). Same function:
//   - an online softmax keeps (acc, m, l) in f32 and streams K/V tiles;
//   - o = acc / l in the input dtype, lse = m + log(l) in f32;
//   - causal: K tiles wholly above the diagonal are skipped by the loop
//     bound; inside a tile q_pos >= k_pos attends (a tie attends), and
//     masked scores are NEG_INF = -1e30, not -inf.
// Layout: q, k, v, o contiguous (BH, S, D); lse contiguous (BH, S). S need
// not be a multiple of the 64-row tiles: rows and keys past S read as
// zeros and keys past S are masked.
//
// Bound at the entry shape (BH=32, S=256, D=64, bf16, causal): the kernel
// must read q, k, v and write o and lse, 4,227,072 B, 1.262 us at 3.35 TB/s;
// the causal dots are 269 Mflop, 0.27 us at the 989 TFLOP/s bf16 tensor-core
// peak. So it is bound by bytes and, at this size, by latency. The first
// design (FFMA for both dtypes) took 38.69-41.71 us there per call with the
// host and 37.67 us of device time; this design takes 6.06 us of device time
// (chip_smoke phase 8, H100 80GB HBM3, 700.00 W).
//
// bf16 design (flash_fwd_wgmma_kernel), against the four faults of the
// FFMA design:
//   1. Tensor cores: S = Q K^T by wgmma m64n64k16 with both operands in
//      shared memory (K-major), O += P V by wgmma m64nDk16 with P from
//      registers (the S accumulator fragment converted to bf16 is the A
//      fragment) and V from shared memory (MN-major, no transpose).
//   2. Latency: one warpgroup (128 threads) per (bh, 64-row q tile), with
//      40 KB of shared memory at D=64 (80 KB at D=128), so several blocks
//      fit on an SM; the q tiles that walk the most causal K tiles are
//      launched first.
//   3. Loads: TMA copies whole 64-row boxes (3-D tensor maps over (D, S, BH),
//      128-byte swizzle, zero fill past S) into a two-stage K/V ring; one
//      thread issues tile t+1 while the warpgroup computes tile t, and
//      mbarriers with transaction counts say when a tile has landed and when
//      every warp is done with a stage.
//   4. Softmax in registers: the mask, the row max (quad shuffles) and the
//      exponentials run on the accumulator fragment; no score tile in shared
//      memory and no block-wide barrier in the loop.
// Scaling: the product runs on the unscaled bf16 q (bf16 x bf16 products are
// exact in f32) and the f32 scores are multiplied by `scale`, so lse stays
// within 1e-4 of the plain version. The one rounding the TPU kernel does not
// do: P is rounded to bf16 to be the A operand of the second product (the
// row sums l use the f32 P). o is held at 3e-2, as the JAX tests hold bf16.
//
// f32 design (flash_fwd_f32_kernel): the FFMA kernel of the first design,
// kept for f32 inputs, whose 1e-5 bar forbids TF32. One 128-thread block
// per (bh, 64-row q tile): q (pre-scaled), K, V and the score tile in
// padded shared memory, acc in registers as 4-row micro-tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // k rows per tile
constexpr int NT = 128;       // threads per block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16

template <int D>
constexpr int wgmma_smem_bytes() {
  // Q, two K stages, two V stages, and slack to align the base to 1024.
  return 5 * BM * D * 2 + 1024;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                       float scale) {
  using namespace hopper;
  constexpr int TILE = BM * D * 2;  // bytes of one 64-row tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[2], bar_v[2], bar_free[2];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + TILE;      // two stages
  uint8_t* Vs = Qs + 3 * TILE;  // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BN - 1) / BN;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    n_tiles = min((min(m0 + BM, S) + BN - 1) / BN, n_tiles);
  }

  auto load_kv = [&](int t) {
    const int s = t & 1;
    mbar_arrive_expect_tx(&bar_k[s], TILE);
    tma_tile<D>(Ks + s * TILE, &tk, &bar_k[s], t * BN, bh);
    mbar_arrive_expect_tx(&bar_v[s], TILE);
    tma_tile<D>(Vs + s * TILE, &tv, &bar_v[s], t * BN, bh);
  };

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], NT / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar_q, TILE);
    tma_tile<D>(Qs, &tq, &bar_q, m0, bh);
    load_kv(0);
    if (n_tiles > 1) load_kv(1);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row sum
  const uint32_t q_base = smem_u32(Qs), k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  mbar_wait(&bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    if (tid == 0 && t >= 1 && t + 1 < n_tiles) {
      // Stage s^1 held tile t-1: once every warp is done with it, load t+1.
      mbar_wait(&bar_free[s ^ 1], ((t - 1) >> 1) & 1);
      load_kv(t + 1);
    }
    __syncwarp();

    // S = Q K^T over D in k16 steps.
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    mbar_wait(&bar_k[s], parity);
    fence_operands(sacc);
    wgmma_fence();
    wgmma_ss_tiles<D>(sacc, q_base, k_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sacc);

    // Scale, mask, and the online softmax on the fragment.
    const int k0 = t * BN;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] *= scale;
    if (k0 + BN > S || (CAUSAL && k0 + BN > m0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q_pos = m0 + r_lo + 8 * ((i >> 1) & 1);
        const int k_pos = k0 + 8 * (i >> 2) + c2 + (i & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) sacc[i] = NEG_INF;
      }
    }
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sacc[i]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2f((m_r[h] - m_new[h]) * LOG2E);
      neg_m[h] = -m_new[h] * LOG2E;
      m_r[h] = m_new[h];
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = exp2f(fmaf(sacc[i], LOG2E, neg_m[(i >> 1) & 1]));  // exp(s - m_new)
      l_r[(i >> 1) & 1] += sacc[i];
    }
    // P as the A fragments of four k16 steps over this tile's 64 keys.
    uint32_t pa[4][4];
    accum_to_a(sacc, pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O += P V over the tile's keys, V read MN-major.
    mbar_wait(&bar_v[s], parity);
    fence_operands(oacc);
    wgmma_fence();
    wgmma_rs_tile<D>(oacc, pa, v_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(oacc);
    fence_fragments(pa);
    if (lane == 0) mbar_arrive(&bar_free[s]);
  }

  const size_t row0 = (size_t)bh * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + r_lo + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (row0 + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * h] / l, oacc[4 * j + 2 * h + 1] / l);
    if (lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);
  }
}

template <int D, bool CAUSAL>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
                float scale, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_map(encode, &tq, q, BH, S, D);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, D);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, D);
  if (err) return err;
  constexpr int smem = wgmma_smem_bytes<D>();
  auto kern = flash_fwd_wgmma_kernel<D, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(tq, tk, tv, (__nv_bfloat16*)o, lse, S, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32

template <int D>
constexpr int smem_floats() {
  // Qs (BM x D+1), Ks (BN x D+1), Vs (BN x D), Ss (BM x BN+1), m, l, alpha.
  return BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + 3 * BM;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // BM x (D+1)
  float* Ks = Qs + BM * (D + 1);       // BN x (D+1)
  float* Vs = Ks + BN * (D + 1);       // BN x D
  float* Ss = Vs + BN * D;             // BM x (BN+1)
  float* m_s = Ss + BM * (BN + 1);     // BM
  float* l_s = m_s + BM;               // BM
  float* a_s = l_s + BM;               // BM

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const size_t base = (size_t)bh * S * D;

  // q tile, pre-scaled in f32 (pallas_attention.py:48).
  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = m0 + r;
    Qs[r * (D + 1) + d] = row < S ? q[base + (size_t)row * D + d] * scale : 0.f;
  }
  if (tid < BM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // Micro-tile ownership: rows rg*4+i, columns cg+8*j.
  const int rg = tid / 8, cg = tid % 8;
  constexpr int DJ = D / 8;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles_all = (S + BN - 1) / BN;
  int n_tiles = n_tiles_all;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    const int q_end = min(m0 + BM, S);
    n_tiles = min((q_end + BN - 1) / BN, n_tiles_all);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // previous tile's readers of Ks/Vs/Ss are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int n = idx / D, d = idx % D;
      const int row = k0 + n;
      const bool ok = row < S;
      const size_t off = base + (size_t)row * D + d;
      Ks[n * (D + 1) + d] = ok ? k[off] : 0.f;
      Vs[n * D + d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    // s = q_scaled . k for the 4x8 micro-tile.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(cg + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int q_pos = m0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        const int k_pos = k0 + c;
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && (q_pos >= k_pos);
        Ss[r * (BN + 1) + c] = keep ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: two threads per row, 32 columns each.
    {
      const int r = tid / 2, h = tid % 2;
      float* srow = Ss + r * (BN + 1) + h * 32;
      float mx = NEG_INF;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (h == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(rg * 4 + i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[n * D + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int row = m0 + r;
    if (row >= S) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[base + (size_t)row * D + cg + 8 * j] = acc[i][j] / l;
  }
  if (tid < BM && m0 + tid < S)
    lse[(size_t)bh * S + m0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
               float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_fwd_f32_kernel<D, CAUSAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (float*)o,
                                   lse, S, scale);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- dispatch

typedef int (*Launcher)(const void*, const void*, const void*, void*, float*, int, int, float,
                        cudaStream_t);

Launcher pick(int dtype, int D, int causal) {
  static const Launcher f32[2][2] = {{launch_f32<64, false>, launch_f32<64, true>},
                                     {launch_f32<128, false>, launch_f32<128, true>}};
  static const Launcher bf16[2][2] = {{launch_bf16<64, false>, launch_bf16<64, true>},
                                      {launch_bf16<128, false>, launch_bf16<128, true>}};
  if (D != 64 && D != 128) return nullptr;
  const int d = D == 128, c = causal != 0;
  if (dtype == 0) return f32[d][c];
  if (dtype == 1) return bf16[d][c];
  return nullptr;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FFMA kernel), 1 = bfloat16 (wgmma kernel). Returns a
// cudaError_t (0 on success) or one of hopper.cuh's ERR_* codes.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              int BH, int S, int D, int dtype, int causal, float scale,
              void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Launcher launch = pick(dtype, D, causal);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, BH, S, scale, (cudaStream_t)stream);
}

const char* flash_fwd_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
