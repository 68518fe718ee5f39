// Flash-attention forward for Hopper (sm_90a), on the tensor cores for every
// dtype and head dim: bf16 and f16 as wgmma fed by TMA (one template, the
// 16-bit element type its parameter), f32 as three TF32 wgmma products (an
// error-compensated split) fed by TMA; past 256 in kernels that stream d in
// chunks ("head dims over 256 (tensor cores)" below).
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
// Head dims: the kernels take every d whose row, d times the element size,
// is a multiple of 16 bytes (bf16 and f16 d = 8, 16, ...; f32 d = 4, 8,
// ...; hopper::tile_width); the wrapper (ops/flash_attention.py) zero-pads
// any other d to the next such row and slices o back, the scale taken from
// the caller's d. Up to 256 the kernels are built for three tile widths W,
// 64 (d <= 64), 128 (d <= 128) and 256, with d a runtime argument; past
// 256 the deep forms stream d in chunks. The tensor
// maps span d columns, so TMA lands zeros in a tile's columns d..W-1; zero
// columns add exactly zero to Q K^T (in bf16 and in the 3xTF32 split
// alike, a zero splits into hi = lo = 0), and P V's columns past d come
// out zero and are not stored: o is written with row stride d, columns
// below d only. The scale comes from the caller (d^-0.5 by default), never
// from W. A narrow head does the product and shared-memory work of W.
// At W = 256 both dtypes have kernels of their own with two warpgroups
// (O's 64 x 256 f32 accumulator would be 128 registers a thread in one
// beside the scores), each owning 128 columns of O. The bf16 one
// (flash_fwd_wgmma_wide_kernel, below) spreads its TMA issue over the
// warps and stores O by TMA: at BH 64, S 128, d 256, causal (bound 5.018
// us by bytes) it takes 7.4-7.8 us by the CUDA-graph timer, where its
// first form took 10.2-10.6 and SDPA's forward takes 10.8-11.2
// (scripts/flash_tree_times.py, scripts/flash_bf16_wide_probe.py, NVIDIA
// H100 80GB HBM3, 700.00 W). The f32 one (flash_fwd_tf32_wide_kernel)
// takes 25.2-25.4 us there, under SDPA's efficient f32 forward, 31.3-31.4.
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
//      40 KB of shared memory at W = 64 (80 KB at W = 128), so several blocks
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
// f32 design (flash_fwd_tf32_kernel), the redesign of the FFMA kernel of the
// first design, which took 41.42-41.59 us by the CUDA-graph timer at the
// entry shape in f32, 1.38-1.41 x SDPA's f32 forward (efficient backend).
//   - Bound (BH=32, S=256, D=64, f32, causal): 8,421,376 B, 2.514 us at
//     3.35 TB/s; the 269 Mflop as three TF32 products take 1.63 us at 495
//     TFLOP/s. Bound by bytes. No FFMA kernel can go under 4.022 us, the
//     flops at the 67 TFLOP/s of the f32 pipe.
//   - Precision: both products run as A_lo B_hi + A_hi B_lo + A_hi B_hi
//     (hopper.cuh, "f32 as three TF32 products"), which holds the f32 bar
//     (1e-5 on o and lse) as f32 itself does; q is pre-scaled in f32 before
//     its split, as the TPU kernel scales it (pallas_attention.py:48). P is
//     split from the running max in registers (accum_to_tf32_a) and the row
//     sums l use the f32 P. Each tile's P V sums in a fresh accumulator
//     that is added to the running output in f32 (wgmma's own adds are not
//     rounded to nearest; see flash_bwd.cu, "Sums").
//   - Layout: S = Q K^T reads the split q and k tiles as they land
//     (K-major). tf32 wgmma takes no transpose, so O += P V reads v from a
//     transposed copy (D rows x the tile's keys) whose columns are permuted
//     by perm8 to meet the A fragments of P; split_tile_transposed writes it
//     one 16-byte store per lane, free of bank conflicts.
//   - Warp specialization: each block holds one q tile and two warpgroups.
//     The producer lands q, k and v by TMA (raw stages, zero fill past S)
//     and splits each K/V tile into one of two buffers while the consumer
//     runs the products and the online softmax on the other; mbarriers say
//     when a buffer is split and when it is free again. With one warpgroup
//     doing both, a tile's split and its products ran one after the other
//     (16.40 us at the entry shape). Apart they overlap: clock64 marks
//     (scripts/flash_fwd_f32_probe.py) show a 64-key tile every 1.8 us, the
//     producer's split about 1.5 us of it and the consumer's S, softmax
//     and P V 0.5, 0.6 and 0.5 us; dropping the products leaves the time
//     as it is, dropping the split takes 1.9 us off, so the split and the
//     TMA landings pace the kernel.
//   - Shared memory (227 KB a block): q's hi and lo tiles, two split
//     buffers (k's hi and lo tiles, v's hi and lo transposed copies) and the
//     raw stages: 64-key tiles and two stages at W = 64, 32-key tiles and
//     one stage at W = 128, 230,400 B each; one block an SM, the heaviest
//     causal q tile first. The entry shape's 128 blocks take 128 of the 132
//     SMs, one wave.
//   This design takes 13.48 us by the graph timer there (12.48 us by the
//   profiler), 19% of the bound and 0.449 of SDPA's f32 forward at 30.04
//   us (chip_smoke phase 8, NVIDIA H100 80GB HBM3, 700.00 W, 1980 MHz).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // k rows per tile
constexpr int NT = 128;       // threads of a warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16

template <int W>
constexpr int wgmma_smem_bytes() {
  // Q, two K stages, two V stages, and slack to align the base to 1024.
  return 5 * BM * W * 2 + 1024;
}

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, float* __restrict__ lse, int S, int d,
                       float scale) {
  using namespace hopper;
  constexpr int TILE = BM * W * 2;  // bytes of one 64-row tile

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
    tma_tile<W>(Ks + s * TILE, &tk, &bar_k[s], t * BN, bh);
    mbar_arrive_expect_tx(&bar_v[s], TILE);
    tma_tile<W>(Vs + s * TILE, &tv, &bar_v[s], t * BN, bh);
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
    tma_tile<W>(Qs, &tq, &bar_q, m0, bh);
    load_kv(0);
    if (n_tiles > 1) load_kv(1);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) oacc[i] = 0.f;
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

    // S = Q K^T over W in k16 steps.
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    mbar_wait(&bar_k[s], parity);
    fence_operands(sacc);
    wgmma_fence();
    wgmma_ss_tiles<T, W>(sacc, q_base, k_base + s * TILE);
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
    accum_to_a<T>(sacc, pa);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O += P V over the tile's keys, V read MN-major.
    mbar_wait(&bar_v[s], parity);
    fence_operands(oacc);
    wgmma_fence();
    wgmma_rs_tile<T, W>(oacc, pa, v_base + s * TILE);
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
    // Row stride and column bound dd; at d = W both are constants (a
    // runtime bound here cost 0.4 us at D = 64 and 1.0 us at D = 128).
    auto store = [&](int dd) {
      T* orow = o + (row0 + row) * dd;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        if (8 * j + c2 < dd)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + c2) =
              pack16<T>(oacc[4 * j + 2 * h] / l, oacc[4 * j + 2 * h + 1] / l);
    };
    if (d == W)
      store(W);
    else
      store(d);
    if (lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);
  }
}

// T is the 16-bit element type, __nv_bfloat16 or __half.
template <typename T, int W, bool CAUSAL>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
                int d, float scale, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  constexpr CUtensorMapDataType type = hopper::Elem16<T>::MAP;
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_map(encode, &tq, q, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, d, type);
  if (err) return err;
  constexpr int smem = wgmma_smem_bytes<W>();
  auto kern = flash_fwd_wgmma_kernel<T, W, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(tq, tk, tv, (T*)o, lse, S, d, scale);
  return (int)cudaGetLastError();
}

// The bf16 forward at tile width 256 (128 < d <= 256), two warpgroups,
// each computing the whole score tile and owning 128 columns of O. Its
// first form (flash_fwd_wgmma_kernel at W = 256) had one thread issue all
// 20 TMA boxes of q and both stages before its own first wait, and stored
// O from registers, a division and a 4-byte store an element pair. This
// kernel:
//   - spreads the TMA issue over the warps, one box a warp at a time:
//     warps 0-3 land q's four boxes and then v's, warps 4-7 k's, each
//     warp's maps prefetched first; a stage is freed by all eight warps;
//   - stages O times 1 / l in bf16 in the warpgroup's half of the last
//     tile's v stage (which only its own P V reads) and stores it with two
//     TMA stores a warpgroup (columns past d and rows past S are not
//     written).
// Splitting d between the warpgroups for the scores instead (8 k16 steps
// each, the f32 halves exchanged through shared memory once a tile) timed
// 3-4% slower on the card: the exchange's shared-memory traffic and
// barrier cost more than the 8 k16 steps each warpgroup repeats
// (scripts/flash_tree_times.py in turns, NVIDIA H100 80GB HBM3, 700.00 W).
// Shared memory: q and two stages of k and of v (32,768 B each) and 1024
// bytes of slack: 164,864 B, one block an SM; 125-128 registers, no
// spills. In the heaviest block at BH 64, S 128, d 256, causal, the first
// form spent 41% of its 15,400-15,800 cycles storing O and 12% in thread
// 0's issue; this one takes 11,000-11,700, in about equal shares the
// score products, the softmax and the epilogue (17-20% each)
// (scripts/flash_bf16_wide_probe.py, NVIDIA H100 80GB HBM3, 700.00 W).
__host__ __device__ constexpr int wgmma_wide_smem_bytes() { return 5 * BM * 256 * 2 + 1024; }

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                            int S, int d, float scale) {
  using namespace hopper;
  constexpr int BOX = BM * 128;   // bytes of a 64-column box of 64 rows
  constexpr int TILE = 4 * BOX;   // bytes of a 64-row tile of 256 columns

  extern __shared__ uint8_t smem_raw[];
  // q, and k and v by stage; a stage is freed by every warp.
  __shared__ __align__(8) uint64_t bar_q, bar_k[2], bar_v[2], bar_free[2];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + TILE;      // two stages
  uint8_t* Vs = Qs + 3 * TILE;  // two stages

  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BN - 1) / BN;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    n_tiles = min((min(m0 + BM, S) + BN - 1) / BN, n_tiles);
  }
  // This warp's box, columns 64 warp..: the warps of warpgroup 0 land q's
  // and v's, those of warpgroup 1 k's.
  const bool kv_is_k = wg == 1;
  const CUtensorMap* tkv = kv_is_k ? &tk : &tv;
  uint8_t* kv_dst = (kv_is_k ? Ks : Vs) + warp * BOX;
  auto load = [&](int t) {  // this warp's box of key tile t
    const int s = t & 1;
    uint64_t* bar = kv_is_k ? &bar_k[s] : &bar_v[s];
    mbar_arrive_expect_tx(bar, BOX);
    tma_load_3d(kv_dst + s * TILE, tkv, bar, 64 * warp, t * BN, bh);
  };
  if (lane == 0) {
    prefetch_map(tkv);
    if (!kv_is_k) prefetch_map(&tq);
    if (warp == 0) prefetch_map(&to);
  }
  if (tid == 0) {
    mbar_init(&bar_q, 4);  // a box from each of warps 0-3
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_k[s], 4);  // warps 4-7
      mbar_init(&bar_v[s], 4);  // warps 0-3
      mbar_init(&bar_free[s], 2 * NT / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0) {
    if (!kv_is_k) {
      mbar_arrive_expect_tx(&bar_q, BOX);
      tma_load_3d(Qs + warp * BOX, &tq, &bar_q, 64 * warp, m0, bh);
    }
    load(0);
    if (n_tiles > 1) load(1);
  }
  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[64];  // O's columns 128 wg..
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row sum
  const int half = 2 * wg;  // the first box of this warpgroup's columns
  const uint32_t q_base = smem_u32(Qs), k_base = smem_u32(Ks);
  const uint32_t v_base = smem_u32(Vs) + half * BOX;
  mbar_wait(&bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    if (lane == 0 && t >= 1 && t + 1 < n_tiles) {
      // Stage s^1 held tile t-1: once every warp is done with it, load t+1.
      mbar_wait(&bar_free[s ^ 1], ((t - 1) >> 1) & 1);
      load(t + 1);
    }
    __syncwarp();

    // S = Q K^T over the whole tile width in k16 steps (both warpgroups:
    // the same values, in the same order).
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    mbar_wait(&bar_k[s], parity);
    fence_operands(sacc);
    wgmma_fence();
    wgmma_ss_tiles<T, 256>(sacc, q_base, k_base + s * TILE);
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
    accum_to_a<T>(sacc, pa);
#pragma unroll
    for (int i = 0; i < 64; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O_w += P V_w over the tile's keys, V read MN-major.
    mbar_wait(&bar_v[s], parity);
    fence_operands(oacc);
    wgmma_fence();
    wgmma_rs_tile<T, 128>(oacc, pa, v_base + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(oacc);
    fence_fragments(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[s]);
  }

  // O / l in bf16 or f16 (one division a row), staged in this warpgroup's half of
  // the last tile's v stage, which only its own P V read.
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[h] = 1.f / l;
    const int row = m0 + r_lo + 8 * h;
    if (wg == 0 && lane % 4 == 0 && row < S) lse[(size_t)bh * S + row] = m_r[h] + logf(l);
  }
  uint8_t* stage = Vs + ((n_tiles - 1) & 1) * TILE + half * BOX;
  stage_rows16<T, 128>(stage, oacc, inv_l, r_lo, lane);
  fence_proxy_async();
  named_barrier(2 + wg, NT);
  if (wt == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (64 * (half + b) < d) tma_store_3d(&to, stage + b * BOX, 64 * (half + b), m0, bh);
    tma_store_wait();
  }
}

template <typename T, bool CAUSAL>
int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                     int S, int d, float scale, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  constexpr CUtensorMapDataType type = hopper::Elem16<T>::MAP;
  CUtensorMap tq, tk, tv, to;
  int err = hopper::encode_map(encode, &tq, q, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &to, o, BH, S, d, type);
  if (err) return err;
  constexpr int smem = wgmma_wide_smem_bytes();
  auto kern = flash_fwd_wgmma_wide_kernel<T, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, to, lse, S, d, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ f32 (3xTF32)

// The hi and lo tiles of N f32 values at `raw` times `mul`, in the layout
// they have there, by the 128 threads of a warpgroup (`tid` 0-127 in it),
// 16 bytes a step. The steps are unrolled so that each thread's loads are
// in flight together.
template <int N>
__device__ __forceinline__ void split_rows(const uint8_t* raw, uint8_t* hi, uint8_t* lo, float mul,
                                           int tid) {
  static_assert(N % (4 * NT) == 0, "whole 16-byte steps for every thread");
#pragma unroll
  for (int i = 0; i < N / (4 * NT); ++i) {
    const int o = (tid + i * NT) * 16;
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    uint32_t h[4], l[4];
    hopper::split_tf32(x.x * mul, h[0], l[0]);
    hopper::split_tf32(x.y * mul, h[1], l[1]);
    hopper::split_tf32(x.z * mul, h[2], l[2]);
    hopper::split_tf32(x.w * mul, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Tiles of the tf32 kernel by tile width: the key rows a streamed tile holds
// and the raw stages K and V land in, so that q's split tiles, two split
// buffers and the stages fit in 227 KB (230,400 B at both widths).
template <int W>
struct Tf32Fwd {
  static constexpr int BK = W == 64 ? 64 : 32;
  static constexpr int STAGES = W == 64 ? 2 : 1;
};

// Shared memory of the tf32 kernel: q's hi and lo tiles, two split buffers
// (k's hi and lo tiles, v's hi and lo transposed copies), the raw stages,
// and slack to align the base to 1024.
template <int W, int BK, int STAGES>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return 2 * BM * W * 4 + 2 * (2 * BK * W * 4 + 2 * hopper::transposed_bytes<BK, W>()) +
         STAGES * 2 * BK * W * 4 + 1024;
}

template <int W, int BK, int STAGES, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      float* __restrict__ o, float* __restrict__ lse, int S, int d,
                      float scale) {
  using namespace hopper;
  constexpr int QT = BM * W * 4;                  // bytes of the q tile
  constexpr int KT = BK * W * 4;                  // bytes of a k or v tile
  constexpr int VTT = transposed_bytes<BK, W>();  // bytes of v's transposed copy
  constexpr int BUF = 2 * KT + 2 * VTT;           // a split buffer: k hi, k lo, v^T hi, v^T lo
  constexpr int Q_BOX = BM * 128, K_BOX = BK * 128, VT_BOX = W * 128;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, q_split, raw_full[STAGES], split_full[2],
      split_free[2];
  uint8_t* Qh = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ql = Qh + QT;
  uint8_t* buf = Ql + QT;        // buffer b at buf + b BUF
  uint8_t* raw = buf + 2 * BUF;  // stage st: k at raw + 2 st KT, v KT after it

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    n_tiles = min((min(m0 + BM, S) + BK - 1) / BK, n_tiles);
  }

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&q_split, NT);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) mbar_init(&raw_full[st], 1);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&split_full[b], NT);  // every producer thread, after its writes
      mbar_init(&split_free[b], NT);  // every consumer thread, after its products
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NT) {
    // The producer warpgroup: TMA, and the split of each tile into a buffer
    // while the consumers compute on the other one.
    const int ptid = tid - NT;
    auto load_kv = [&](int t) {
      const int st = t % STAGES;
      mbar_arrive_expect_tx(&raw_full[st], 2 * KT);
      tma_tile_f32<W, BK>(raw + 2 * st * KT, &tk, &raw_full[st], t * BK, bh);
      tma_tile_f32<W, BK>(raw + (2 * st + 1) * KT, &tv, &raw_full[st], t * BK, bh);
    };
    if (ptid == 0) {
      mbar_arrive_expect_tx(&bar_q, QT);
      tma_tile_f32<W, BM>(Qh, &tq, &bar_q, m0, bh);
      for (int t = 0; t < STAGES && t < n_tiles; ++t) load_kv(t);
    }
    // q pre-scaled in f32 (pallas_attention.py:48) and split in place.
    mbar_wait(&bar_q, 0);
    split_rows<BM * W>(Qh, Qh, Ql, scale, ptid);
    fence_proxy_async();
    mbar_arrive(&q_split);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES, b = t & 1;
      uint8_t* kb = buf + b * BUF;
      mbar_wait(&raw_full[st], (t / STAGES) & 1);
      if (t >= 2) mbar_wait(&split_free[b], ((t >> 1) - 1) & 1);
      split_rows<BK * W>(raw + 2 * st * KT, kb, kb + KT, 1.f, ptid);
      split_tile_transposed<BK, W>(raw + (2 * st + 1) * KT, kb + 2 * KT, kb + 2 * KT + VTT, ptid);
      fence_proxy_async();
      mbar_arrive(&split_full[b]);
      if (t + STAGES < n_tiles) {
        named_barrier(1, NT);  // every producer is done with stage st
        if (ptid == 0) load_kv(t + STAGES);
      }
    }
    return;
  }

  // The consumer warpgroup: the products and the online softmax. This
  // thread's rows of the q tile (r_lo and r_lo + 8) and its first column in
  // each 8-column chunk of an accumulator.
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row sum
  const uint32_t qh = smem_u32(Qh), ql = smem_u32(Ql);
  mbar_wait(&q_split, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    const uint32_t kh = smem_u32(buf + b * BUF), kl = kh + KT, vth = kh + 2 * KT, vtl = vth + VTT;
    mbar_wait(&split_full[b], (t >> 1) & 1);

    // S = (scale Q) K^T.
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    fence_operands(sacc);
    wgmma_fence();
    wgmma_3xtf32_ss<BK, W, Q_BOX, K_BOX>(sacc, qh, ql, kh, kl);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sacc);

    // Mask and the online softmax on the fragment.
    const int k0 = t * BK;
    if (k0 + BK > S || (CAUSAL && k0 + BK > m0)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int q_pos = m0 + r_lo + 8 * ((i >> 1) & 1);
        const int k_pos = k0 + 8 * (i >> 2) + c2 + (i & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) sacc[i] = NEG_INF;
      }
    }
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sacc[i]);
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
    for (int i = 0; i < BK / 2; ++i) {
      sacc[i] = exp2f(fmaf(sacc[i], LOG2E, neg_m[(i >> 1) & 1]));  // exp(s - m_new)
      l_r[(i >> 1) & 1] += sacc[i];
    }
    // P (unnormalized, f32) as the hi and lo A fragments of BK / 8 k8 steps.
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
    accum_to_tf32_a<BK>(sacc, ph, pl);

    // O = O alpha + P V, V read from its transposed copy. The tile's product
    // sums in a fresh accumulator that is then added to O in f32: wgmma's
    // own adds are not rounded to nearest (see flash_bwd.cu, "Sums").
    float part[W / 2] = {};
    fence_operands(part);
    wgmma_fence();
    wgmma_3xtf32_rs<W, BK, VT_BOX>(part, ph, pl, vth, vtl);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(part);
    fence_fragments(ph);
    fence_fragments(pl);
    mbar_arrive(&split_free[b]);  // the buffer may take tile t + 2
#pragma unroll
    for (int i = 0; i < W / 2; ++i) oacc[i] = fmaf(oacc[i], alpha[(i >> 1) & 1], part[i]);
  }

  const size_t row0 = (size_t)bh * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + r_lo + 8 * h;
    if (row >= S) continue;
    auto store = [&](int dd) {  // as the bf16 kernel's
      float* orow = o + (row0 + row) * dd;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        if (8 * j + c2 < dd)
          *reinterpret_cast<float2*>(orow + 8 * j + c2) =
              make_float2(oacc[4 * j + 2 * h] / l, oacc[4 * j + 2 * h + 1] / l);
    };
    if (d == W)
      store(W);
    else
      store(d);
    if (lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);
  }
}

// The f32 forward at tile width 256 (128 < d <= 256). Its first design
// kept q raw (q's hi and lo take 131,072 B) and read and split q's
// fragments for each 32-key tile and pass: 30% of a tile, beside 15% for
// k's and v's splits and two block barriers a tile; 38.40 us at BH 64, S
// 128, d 256, causal, where SDPA's efficient f32 forward takes 31.25
// (scripts/flash_fwd_wide_probe.py). A tf32 wgmma k8 step takes about 43
// cycles of an SM at N = 32 or 64 (the probe, here and on
// flash_fwd_tf32_kernel), so this design also cuts the number of
// products: 64-key tiles, N = 64 for the scores and N = 128 for P V.
// Everything streams in 32-column chunks of d, as in the wide backward
// kernels (flash_bwd.cu), with a warpgroup's 128 columns of O (64
// registers a thread) the only resident state:
//   - the warpgroups split d for the scores: warpgroup 0 contracts the
//     first half of the chunks below d, warpgroup 1 the rest; each chunk's
//     q (pre-scaled in f32, pallas_attention.py:48) and k land together
//     and are split into hi and lo in shared memory, and the chunk's three
//     products run SS, small terms first, summed fresh and added in f32.
//     The two halves meet through shared memory once a tile (f32 addition
//     commutes: both warpgroups hold the same bits), and both run the mask
//     and the online softmax;
//   - P V: warpgroup w owns O's columns 128w..128w + 127 and takes v's in
//     two items of 32 keys (the tile's first half, then its second), each
//     split transposed (split_tile_transposed) and read by m64n128k8
//     products from P's fragments in registers; each item sums fresh and
//     is added to O in f32, the rescale with the first;
//   - each warpgroup is a pipeline of its own: its items land by TMA in
//     one of two landing slots, refilled once the warpgroup has issued
//     the item's products (one box a warp: a TMA issue holds its thread
//     for over a hundred cycles), and are split into one of two split
//     slots, so that item i splits while the tensor cores run item i - 1's
//     products; one barrier of the warpgroup an item.
// Chunks wholly past d are not loaded or computed: d = 132 runs 3 chunks in
// warpgroup 0 and 2 in warpgroup 1. Shared memory: for each warpgroup two
// landing slots of 16,384 B and two split slots of 32,768 B; the exchange,
// 2 x 64 x 64 f32; 1024 bytes of slack: 230,400 B, one block an SM; 244-247
// registers, no spills. It takes 25.22-25.39 us there by the graph timer,
// 0.80-0.81 of SDPA's efficient f32 forward in the same runs (31.33-31.41),
// with the splits of q, k and v 39% of a tile and the products' issue
// 21-22% (scripts/flash_fwd_wide_probe.py, NVIDIA H100 80GB HBM3, 700.00
// W). Kept out, each timed slower on the card: q split once into shared
// memory with the warpgroups on alternate key tiles, each holding all of
// O (28.8 us at 32-key tiles, spilling; 38.0 at 64), and on that design
// four independent product chains (40.1) or warpgroups taking turns to
// issue (37.5); here, q's fragments read into registers (spills, 32.9).
constexpr int WIDE_BK = 64;     // keys a tile
constexpr int WIDE_STAGES = 2;  // landing slots of a warpgroup

__host__ __device__ constexpr int tf32_wide_smem_bytes() {
  return 2 * (WIDE_STAGES * 2 + 2 * 4) * BM * 128 + 2 * BM * WIDE_BK * 4 + 1024;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_fwd_tf32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, float* __restrict__ lse, int S, int d,
                           float scale) {
  using namespace hopper;
  constexpr int BK = WIDE_BK, HK = BK / 2, STAGES = WIDE_STAGES;
  constexpr int BOX = BM * 128;   // bytes of a 32-column box of 64 rows
  constexpr int VBOX = HK * 128;  // bytes of a 32-column box of 32 keys
  constexpr int LAND = 2 * BOX;   // a landing slot: q's chunk, then k's; or four v boxes
  constexpr int SPLIT = 4 * BOX;  // a split slot: q hi, q lo, k hi, k lo; or v^T's hi, then lo
  constexpr int WG_BYTES = STAGES * LAND + 2 * SPLIT;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * WG_BYTES;
  uint8_t* split = land + STAGES * LAND;
  // The exchange of the score halves: warpgroup w writes xch + w 32 NT.
  float* xch = reinterpret_cast<float*>(base + 2 * WG_BYTES);

  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    n_tiles = min((min(m0 + BM, S) + BK - 1) / BK, n_tiles);
  }
  // A key tile is this warpgroup's ncw score chunks (chunks c0.. of the nc
  // below d), then its two output items.
  const int nc = (d + 31) / 32;
  const int c0 = wg == 0 ? 0 : (nc + 1) / 2, ncw = wg == 0 ? (nc + 1) / 2 : nc / 2;
  const int per_tile = ncw + 2, items = n_tiles * per_tile;
  // Item j of key tile t into landing slot s, by lane 0 of each warp, one
  // box a warp (a TMA issue takes over a hundred cycles of its thread):
  // q's and k's chunks of a score item from warps 0 and 1, the four boxes
  // of an output item from warps 0-3. Every warp arrives once (a landing
  // slot's barrier counts 4), each with the bytes it asks for.
  auto issue = [&](int t, int j, int s) {
    uint8_t* dst = land + s * LAND;
    uint64_t* bar = &full[wg][s];
    if (j < ncw) {
      if (warp < 2) {
        mbar_arrive_expect_tx(bar, BOX);
        tma_load_3d(dst + warp * BOX, warp == 0 ? &tq : &tk, bar, 32 * (c0 + j),
                    warp == 0 ? m0 : t * BK, bh);
      } else {
        mbar_arrive(bar);
      }
    } else {
      mbar_arrive_expect_tx(bar, VBOX);
      tma_load_3d(dst + warp * VBOX, &tv, bar, 128 * wg + 32 * warp, t * BK + HK * (j - ncw), bh);
    }
  };
  // Item i (place j of tile t) is done with its landing slot: refill it
  // with item i + STAGES (STAGES <= per_tile), after the products of item
  // i are issued.
  auto issue_ahead = [&](int i, int t, int j) {
    if (lane != 0 || i + STAGES >= items) return;
    j += STAGES;
    if (j >= per_tile) j -= per_tile, ++t;
    issue(t, j, i % STAGES);
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
  if (lane == 0)
    for (int s = 0; s < STAGES; ++s) issue(0, s, s);

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[64] = {};  // O's columns 128 wg..
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row sum
  float* mine = xch + wg * (BK / 2) * NT;
  const float* theirs = xch + (1 - wg) * (BK / 2) * NT;

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    // This warpgroup's half of S = (scale Q) K^T: each chunk's three
    // products sum fresh, small terms first, and are added in f32.
    float fresh[BK / 2] = {}, sacc[BK / 2] = {};
    for (int c = 0; c < ncw; ++c, ++i) {
      const int s = i % STAGES;
      const uint8_t* ld = land + s * LAND;
      uint8_t* sp = split + (i & 1) * SPLIT;
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      split_rows<BM * 32>(ld, sp, sp + BOX, scale, wt);           // q, pre-scaled
      split_box<BOX>(ld + BOX, sp + 2 * BOX, sp + 3 * BOX, wt);  // k
      wgmma_wait<0>();  // the last item's products, which read the other split slot
      fence_operands(fresh);
      if (c > 0) add_to(sacc, fresh);
      fence_proxy_async();
      // The warpgroup is done with the landing slot and the last products.
      named_barrier(1 + wg, NT);
      const uint32_t a = smem_u32(sp);
      wgmma_fence();
      wgmma_3xtf32_ss<BK, 32, BOX, BOX>(fresh, a, a + BOX, a + 2 * BOX, a + 3 * BOX);
      wgmma_commit();
      issue_ahead(i, t, c);
    }
    wgmma_wait<0>();
    fence_operands(fresh);
    add_to(sacc, fresh);

    // The whole S: this warpgroup's half and the other's. Barrier 3 hands
    // the halves over; barrier 4 + w says that warpgroup w's buffer was
    // read and may take the next tile's half.
    if (t > 0) named_barrier(4 + wg, 2 * NT);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mine[e * NT + wt] = sacc[e];
    named_barrier(3, 2 * NT);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sacc[e] += theirs[e * NT + wt];
    if (t + 1 < n_tiles) named_arrive(5 - wg, 2 * NT);

    // Mask and the online softmax on the fragment.
    const int k0 = t * BK;
    if (k0 + BK > S || (CAUSAL && k0 + BK > m0)) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int q_pos = m0 + r_lo + 8 * ((e >> 1) & 1);
        const int k_pos = k0 + 8 * (e >> 2) + c2 + (e & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) sacc[e] = NEG_INF;
      }
    }
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) m_new[(e >> 1) & 1] = fmaxf(m_new[(e >> 1) & 1], sacc[e]);
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
    for (int e = 0; e < BK / 2; ++e) {
      sacc[e] = exp2f(fmaf(sacc[e], LOG2E, neg_m[(e >> 1) & 1]));  // exp(s - m_new)
      l_r[(e >> 1) & 1] += sacc[e];
    }

    // O = O alpha + P V over this warpgroup's 128 columns, 32 keys an item,
    // V from its transposed copy; each item's product sums fresh and is
    // added in f32, the rescale with the first.
    float part[64];  // no register holds it between tiles
    uint32_t ph[HK / 8][4], pl[HK / 8][4];
    // P's fragments of the keys of half h: accumulator registers 16h..
    auto p_half = [&](int h) {
      float x[HK / 2];
#pragma unroll
      for (int e = 0; e < HK / 2; ++e) x[e] = sacc[HK / 2 * h + e];
      accum_to_tf32_a<HK>(x, ph, pl);
    };
    p_half(0);
#pragma unroll
    for (int h = 0; h < 2; ++h, ++i) {
      const int s = i % STAGES;
      uint8_t* sp = split + (i & 1) * SPLIT;
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      // Two of its four steps unrolled: more loads in flight beside this
      // warpgroup's product of the first half (part) spill.
      split_tile_transposed<HK, 128, 2>(land + s * LAND, sp, sp + 2 * BOX, wt);
      if (h == 1) {
        wgmma_wait<0>();  // the first half's product
        fence_operands(part);
        fence_fragments(ph);
        fence_fragments(pl);
#pragma unroll
        for (int e = 0; e < 64; ++e) oacc[e] = fmaf(oacc[e], alpha[(e >> 1) & 1], part[e]);
        p_half(1);
      }
      fence_proxy_async();
      named_barrier(1 + wg, NT);
      wgmma_fence();
      wgmma_3xtf32_rs<128, HK, 128 * 128>(part, ph, pl, smem_u32(sp), smem_u32(sp + 2 * BOX));
      wgmma_commit();
      issue_ahead(i, t, ncw + h);
    }
    wgmma_wait<0>();
    fence_operands(part);
    fence_fragments(ph);
    fence_fragments(pl);
    add_to(oacc, part);
  }

  const size_t row0 = (size_t)bh * S;
  const int col0 = 128 * wg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + r_lo + 8 * h;
    if (row >= S) continue;
    float* orow = o + (row0 + row) * d + col0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col0 + 8 * j + c2 < d)
        *reinterpret_cast<float2*>(orow + 8 * j + c2) =
            make_float2(oacc[4 * j + 2 * h] / l, oacc[4 * j + 2 * h + 1] / l);
    if (wg == 0 && lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);
  }
}

template <bool CAUSAL>
int launch_f32_wide(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                    int S, int d, float scale, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::encode_map(encode, &tq, q, BH, S, d, F32, BM);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, d, F32, WIDE_BK);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, d, F32, WIDE_BK / 2);
  if (err) return err;
  constexpr int smem = tf32_wide_smem_bytes();
  auto kern = flash_fwd_tf32_wide_kernel<CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, (float*)o, lse, S, d, scale);
  return (int)cudaGetLastError();
}

template <int W, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
               int d, float scale, cudaStream_t stream) {
  using Tiles = Tf32Fwd<W>;
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::encode_map(encode, &tq, q, BH, S, d, F32, BM);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, d, F32, Tiles::BK);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, d, F32, Tiles::BK);
  if (err) return err;
  constexpr int smem = tf32_smem_bytes<W, Tiles::BK, Tiles::STAGES>();
  auto kern = flash_fwd_tf32_kernel<W, Tiles::BK, Tiles::STAGES, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, (float*)o, lse, S, d, scale);
  return (int)cudaGetLastError();
}

// ------------------------------- head dims over 256 (tensor cores)

// The forward past d = 256, on the tensor cores in every dtype: bf16 and
// f16 as wgmma on 16-bit operands (flash_fwd_wgmma_deep_kernel), f32 as
// three TF32 products (flash_fwd_tf32_deep_kernel). PR 26's FFMA form
// (one thread a 4 x 4 micro-tile, f32 arithmetic) took 81.45 us in bf16
// and f16 and 99.90 in f32 at BH 64, S 128, d 320, causal, 6.4x and 2.3x
// SDPA's forward (PERF.md §6). Past 256 a 64-row tile of d columns does
// not stay resident beside a ring (40 KB in 16 bits at d = 320, 80 KB in
// f32), and O (64 x d in f32) is 160 registers a thread at d = 320 in
// one warpgroup. Both kernels therefore take the shape of the W = 256 f32
// kernel (flash_fwd_tf32_wide_kernel):
//   - a block of two warpgroups owns 64 q rows and up to 2 G groups of 64
//     columns of O (G = 4 in 16 bits, 512 columns; G = 3 in f32, 384:
//     its items need fresh accumulators beside O); grid axis z takes the
//     rest of d, each block computing the scores over the whole of d;
//   - each warpgroup owns a run of O's groups (warpgroup 0 the first
//     half, rounded up) and takes a run of the score chunks, q and k
//     chunks of one 128-byte box (64 columns in 16 bits, 32 in f32),
//     sized so that both warpgroups issue about the same products
//     (deep_part); the two partial score tiles meet through shared
//     memory once a key tile, and both run the mask and the softmax;
//   - each warpgroup is a pipeline of its own: its items (its score
//     chunks, then its output items) land by TMA in a ring of landing
//     slots, one box a warp, refilled once the warpgroup is done with
//     a slot.
// 16 bits: the score chunks chain in one accumulator (wgmma's adds, as at
// W <= 256) and read q and k as they land; P is rounded to the 16-bit type
// as the A operand of P V (its f32 values go into the row sums), and each
// of a warpgroup's groups takes one v box a key tile (64 keys x 64
// columns) into its accumulator; O times 1 / l is staged in the landing
// slots and stored by TMA. f32: q (pre-scaled in f32) and k are split into
// hi and lo in shared memory, each chunk's three products sum fresh, small
// terms first, and are added in f32; P V runs in items of 32 keys x 64
// columns, v split transposed, P split into hi and lo in the split slots'
// free boxes once a tile (both operands from shared memory), each item
// summed fresh and added to O in f32, the rescale first. The times of both, against PR 26's form, the plain
// version and SDPA, are in PERF.md §6 (chip_smoke.py phase 8,
// scripts/flash_deep_times.py).
constexpr int DEEP_BK = 64;        // keys a tile
constexpr int DEEP16_GROUPS = 4;   // 64-column groups of O a warpgroup owns, 16-bit
constexpr int DEEP32_GROUPS = 3;   // f32
constexpr int DEEP16_STAGES = 6;   // landing slots of a warpgroup, 16-bit
constexpr int DEEP32_STAGES = 2;   // f32, beside its two split slots

// One warpgroup's share of a deep block: output groups g0.. (ng of them)
// and score chunks c0.. (nc of them). Block z owns groups 2 G z.., at most
// 2 G, those below d; warpgroup 0 takes the first half (rounded up) and
// enough of the score chunks (of `chunk` columns; a chunk costs one unit
// of products, a group `unit`) that both issue about the same products.
struct DeepPart {
  int g0, ng, c0, nc;
};

__host__ __device__ inline DeepPart deep_part(int d, int z, int wg, int G, int chunk, int unit) {
  const int gb = 2 * G * z;
  const int all = (d + 63) / 64 - gb;
  const int ng = all < 2 * G ? all : 2 * G;
  const int ng0 = (ng + 1) / 2;
  const int nc = (d + chunk - 1) / chunk;
  int nc0 = (nc + unit * (ng - 2 * ng0)) / 2;
  nc0 = nc0 < 0 ? 0 : nc0 > nc ? nc : nc0;
  return wg == 0 ? DeepPart{gb, ng0, 0, nc0} : DeepPart{gb + ng0, ng - ng0, nc0, nc - nc0};
}

// Blocks along z at head dim d: 2 G groups of 64 columns a block.
inline int deep_blocks(int d, int G) { return ((d + 63) / 64 + 2 * G - 1) / (2 * G); }

__host__ __device__ constexpr int deep16_smem_bytes() {
  return 2 * DEEP16_STAGES * 2 * BM * 128 + 2 * (DEEP_BK / 2) * NT * 4 + 1024;
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_fwd_wgmma_deep_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                            int S, int d, float scale) {
  using namespace hopper;
  constexpr int BK = DEEP_BK, G = DEEP16_GROUPS, STAGES = DEEP16_STAGES;
  constexpr int BOX = BM * 128;  // bytes of a 64-column box of 64 rows
  constexpr int LAND = 2 * BOX;  // a landing slot: q's chunk, then k's; or a v box

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / NT, wt = tid % NT;
  const int warp = wt / 32, lane = tid % 32;
  uint8_t* land = base + wg * STAGES * LAND;
  // The exchange of the score tiles' parts: warpgroup w writes xch + w 32 NT.
  float* xch = reinterpret_cast<float*>(base + 2 * STAGES * LAND);

  const int bh = blockIdx.x;
  // The last q tile walks the most causal K tiles: launch it first.
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    n_tiles = min((min(m0 + BM, S) + BK - 1) / BK, n_tiles);
  }
  const DeepPart part = deep_part(d, blockIdx.z, wg, G, 64, 1);
  const int per_tile = part.nc + part.ng, items = n_tiles * per_tile;
  // Item i of this warpgroup (place j of key tile t) into its landing
  // slot, one box a warp: q's and k's chunks of a score item from warps 0
  // and 1, the v box of an output item from warp 0. Every warp arrives
  // once (a slot's barrier counts 4), each with the bytes it asks for.
  auto issue = [&](int i) {
    const int t = i / per_tile, j = i % per_tile;
    uint8_t* dst = land + (i % STAGES) * LAND;
    uint64_t* bar = &full[wg][i % STAGES];
    if (j < part.nc && warp < 2) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst + warp * BOX, warp == 0 ? &tq : &tk, bar, 64 * (part.c0 + j),
                  warp == 0 ? m0 : t * BK, bh);
    } else if (j >= part.nc && warp == 0) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst, &tv, bar, 64 * (part.g0 + j - part.nc), t * BK, bh);
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
    prefetch_map(warp == 1 ? &tk : warp == 0 ? &tq : &tv);
    for (int i = 0; i < STAGES && i < items; ++i) issue(i);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[G][32] = {};  // O's groups g0.. of this warpgroup
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row sum
  float* mine = xch + wg * (BK / 2) * NT;
  const float* theirs = xch + (1 - wg) * (BK / 2) * NT;

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    // This warpgroup's part of S = Q K^T: its chunks in k16 steps, chained
    // in one accumulator, one chunk's products in flight while the next
    // is issued.
    float sacc[32] = {};
    deep16_scores<T, STAGES>(sacc, land, full[wg], i, part.nc, release);

    // The whole S: this warpgroup's part and the other's. Barrier 3 hands
    // the parts over; barrier 4 + w says that warpgroup w's buffer was
    // read and may take the next tile's part.
    if (t > 0) named_barrier(4 + wg, 2 * NT);
#pragma unroll
    for (int e = 0; e < 32; ++e) mine[e * NT + wt] = sacc[e];
    named_barrier(3, 2 * NT);
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] += theirs[e * NT + wt];
    if (t + 1 < n_tiles) named_arrive(5 - wg, 2 * NT);

    // Scale, mask, and the online softmax on the fragment.
    const int k0 = t * BK;
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] *= scale;
    if (k0 + BK > S || (CAUSAL && k0 + BK > m0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int q_pos = m0 + r_lo + 8 * ((e >> 1) & 1);
        const int k_pos = k0 + 8 * (e >> 2) + c2 + (e & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) sacc[e] = NEG_INF;
      }
    }
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) m_new[(e >> 1) & 1] = fmaxf(m_new[(e >> 1) & 1], sacc[e]);
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
    for (int e = 0; e < 32; ++e) {
      sacc[e] = exp2f(fmaf(sacc[e], LOG2E, neg_m[(e >> 1) & 1]));  // exp(s - m_new)
      l_r[(e >> 1) & 1] += sacc[e];
    }
    // P as the A fragments of four k16 steps over this tile's 64 keys.
    uint32_t pa[4][4];
    accum_to_a<T>(sacc, pa);
    PROBE_MARK(i, 7);

    // O_g = O_g alpha + P V_g for each of this warpgroup's groups, V read
    // MN-major as it lands, one group's products in flight while the next
    // is issued.
    static_for<G>([&](auto gc) {
      constexpr int g = decltype(gc)::value;
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[g][e] *= alpha[(e >> 1) & 1];
    });
    deep16_outputs<T, G, STAGES>(oacc, pa, land, full[wg], i, part.ng, release);
  }

  // O / l in T (one division a row), staged in this warpgroup's landing
  // slots (each item is consumed, none is in flight) and stored by TMA,
  // which writes no column past d and no row past S.
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[h] = 1.f / l;
    const int row = m0 + r_lo + 8 * h;
    if (blockIdx.z == 0 && wg == 0 && lane % 4 == 0 && row < S)
      lse[(size_t)bh * S + row] = m_r[h] + logf(l);
  }
  static_for<G>([&](auto gc) {
    constexpr int g = decltype(gc)::value;
    if (g < part.ng) stage_rows16<T, 64>(land + g * BOX, oacc[g], inv_l, r_lo, lane);
  });
  fence_proxy_async();
  named_barrier(1 + wg, NT);
  if (wt == 0) {
    for (int g = 0; g < part.ng; ++g) tma_store_3d(&to, land + g * BOX, 64 * (part.g0 + g), m0, bh);
    tma_store_wait();
  }
}

template <typename T, bool CAUSAL>
int launch_bf16_deep(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                     int S, int d, float scale, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  constexpr CUtensorMapDataType type = hopper::Elem16<T>::MAP;
  CUtensorMap tq, tk, tv, to;
  int err = hopper::encode_map(encode, &tq, q, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, d, type);
  if (!err) err = hopper::encode_map(encode, &to, o, BH, S, d, type);
  if (err) return err;
  constexpr int smem = deep16_smem_bytes();
  auto kern = flash_fwd_wgmma_deep_kernel<T, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM, deep_blocks(d, DEEP16_GROUPS));
  kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, to, lse, S, d, scale);
  return (int)cudaGetLastError();
}

template <bool CAUSAL>
__global__ void __launch_bounds__(2 * NT, 1)
flash_fwd_tf32_deep_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, float* __restrict__ lse, int S, int d,
                           float scale) {
  using namespace hopper;
  constexpr int BK = DEEP_BK, HK = BK / 2, G = DEEP32_GROUPS, STAGES = DEEP32_STAGES;
  constexpr int BOX = BM * 128;   // bytes of a 32-column box of 64 rows
  constexpr int VBOX = HK * 128;  // bytes of a 32-column box of 32 keys
  constexpr int LAND = 2 * BOX;   // a landing slot: q's chunk, then k's; or two v boxes
  constexpr int SPLIT = 4 * BOX;  // a split slot: q hi, q lo, k hi, k lo; or v^T's hi, then lo
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
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (S + BK - 1) / BK;
  if (CAUSAL) {
    // Skip K tiles wholly above the diagonal (pallas_attention.py:51-58).
    n_tiles = min((min(m0 + BM, S) + BK - 1) / BK, n_tiles);
  }
  // A key tile is this warpgroup's score chunks, then its output items:
  // for each half of the tile's keys, one item a group.
  const DeepPart part = deep_part(d, blockIdx.z, wg, G, 32, 2);
  const int per_tile = part.nc + 2 * part.ng, items = n_tiles * per_tile;
  // Item i (place j of key tile t) into landing slot i % STAGES, by lane 0
  // of each warp, one box a warp: q's and k's chunks of a score item, or
  // the two v boxes of an output item, from warps 0 and 1. Every warp
  // arrives once (a slot's barrier counts 4), each with the bytes it asks
  // for.
  auto issue = [&](int i) {
    const int t = i / per_tile, j = i % per_tile;
    uint8_t* dst = land + (i % STAGES) * LAND;
    uint64_t* bar = &full[wg][i % STAGES];
    if (warp >= 2) {
      mbar_arrive(bar);
    } else if (j < part.nc) {
      mbar_arrive_expect_tx(bar, BOX);
      tma_load_3d(dst + warp * BOX, warp == 0 ? &tq : &tk, bar, 32 * (part.c0 + j),
                  warp == 0 ? m0 : t * BK, bh);
    } else {
      const int h = (j - part.nc) / part.ng, g = (j - part.nc) % part.ng;
      mbar_arrive_expect_tx(bar, VBOX);
      tma_load_3d(dst + warp * VBOX, &tv, bar, 64 * (part.g0 + g) + 32 * warp, t * BK + HK * h, bh);
    }
  };
  // Item i is done with its landing slot (split, and a barrier of the
  // warpgroup after): refill the slot with item i + STAGES.
  auto issue_ahead = [&](int i) {
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
    if (warp < 2) prefetch_map(warp == 0 ? &tq : &tk);
    for (int i = 0; i < STAGES && i < items; ++i) issue(i);
  }

  // This thread's rows of the q tile (r_lo and r_lo + 8) and its first
  // column in each 8-column chunk of an accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  float oacc[G][32] = {};  // O's groups g0.. of this warpgroup
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row sum
  float* mine = xch + wg * (BK / 2) * NT;
  const float* theirs = xch + (1 - wg) * (BK / 2) * NT;
  // An output item's product into group gi of O, in f32.
  float pv[32];
  auto add_item = [&](int gi) {
    static_for<G>([&](auto gc) {
      if (decltype(gc)::value == gi) add_to(oacc[decltype(gc)::value], pv);
    });
  };

  int i = 0;  // this warpgroup's item
  for (int t = 0; t < n_tiles; ++t) {
    // This warpgroup's part of S = (scale Q) K^T: each chunk's three
    // products sum fresh, small terms first, and are added in f32.
    float fresh[BK / 2] = {}, sacc[BK / 2] = {};
    for (int c = 0; c < part.nc; ++c, ++i) {
      const int s = i % STAGES;
      const uint8_t* ld = land + s * LAND;
      uint8_t* sp = split + (i & 1) * SPLIT;
      PROBE_MARK(i, 0);
      mbar_wait(&full[wg][s], (i / STAGES) & 1);
      PROBE_MARK(i, 1);
      split_rows<BM * 32>(ld, sp, sp + BOX, scale, wt);           // q, pre-scaled
      split_box<BOX>(ld + BOX, sp + 2 * BOX, sp + 3 * BOX, wt);  // k
      PROBE_MARK(i, 2);
      wgmma_wait<0>();  // the last item's products, which read the other split slot
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
      issue_ahead(i);
      PROBE_MARK(i, 6);
    }
    wgmma_wait<0>();
    fence_operands(fresh);
    if (part.nc > 0) add_to(sacc, fresh);

    // The whole S: this warpgroup's part and the other's. Barrier 3 hands
    // the parts over; barrier 4 + w says that warpgroup w's buffer was
    // read and may take the next tile's part.
    if (t > 0) named_barrier(4 + wg, 2 * NT);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mine[e * NT + wt] = sacc[e];
    named_barrier(3, 2 * NT);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sacc[e] += theirs[e * NT + wt];
    if (t + 1 < n_tiles) named_arrive(5 - wg, 2 * NT);

    // Mask and the online softmax on the score fragment.
    const int k0 = t * BK;
    if (k0 + BK > S || (CAUSAL && k0 + BK > m0)) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int q_pos = m0 + r_lo + 8 * ((e >> 1) & 1);
        const int k_pos = k0 + 8 * (e >> 2) + c2 + (e & 1);
        bool keep = k_pos < S;
        if (CAUSAL) keep = keep && q_pos >= k_pos;
        if (!keep) sacc[e] = NEG_INF;
      }
    }
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) m_new[(e >> 1) & 1] = fmaxf(m_new[(e >> 1) & 1], sacc[e]);
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
    for (int e = 0; e < BK / 2; ++e) {
      sacc[e] = exp2f(fmaf(sacc[e], LOG2E, neg_m[(e >> 1) & 1]));  // exp(s - m_new)
      l_r[(e >> 1) & 1] += sacc[e];
    }

    // P (f32) split into hi and lo in the split slots' second and fourth
    // boxes, which the output items' transposed copies leave free: half h
    // of the tile's keys in slot h, K-major (64 q rows of 32 keys), each
    // key at column perm8 of its place in the half, where the transposed
    // copies of v hold it. The products that read these boxes last (this
    // tile's score chunks, the last tile's output items) have completed.
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      uint8_t* p = split + (e >> 4) * SPLIT + BOX;
      const int off = sw_off(r_lo + 8 * ((e >> 1) & 1), 8 * ((e >> 2) & 3) + lane % 4 + 4 * (e & 1), 64);
      uint32_t hi, lo;
      split_tf32(sacc[e], hi, lo);
      *reinterpret_cast<uint32_t*>(p + off) = hi;
      *reinterpret_cast<uint32_t*>(p + 2 * BOX + off) = lo;
    }

    // O = O alpha + P V over this warpgroup's groups, in items of 32 keys
    // (the tile's halves) x 64 columns, P and V's transposed copy both
    // read from shared memory; each item's product sums fresh and is added
    // in f32 once the next item is split.
    static_for<G>([&](auto gc) {
      constexpr int g = decltype(gc)::value;
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[g][e] *= alpha[(e >> 1) & 1];
    });
    int prev = -1;  // the group of the item whose product is in flight
    PROBE_MARK(i, 7);
    for (int h = 0; h < 2; ++h) {
      const uint32_t p = smem_u32(split + h * SPLIT + BOX);
      for (int g = 0; g < part.ng; ++g, ++i) {
        const int s = i % STAGES;
        uint8_t* sp = split + (i & 1) * SPLIT;
        PROBE_MARK(i, 0);
        mbar_wait(&full[wg][s], (i / STAGES) & 1);
        PROBE_MARK(i, 1);
        // One step at a time: both steps unrolled spilled.
        split_tile_transposed<HK, 64, 1>(land + s * LAND, sp, sp + 2 * BOX, wt);
        PROBE_MARK(i, 2);
        wgmma_wait<0>();  // the last item's product
        fence_operands(pv);
        add_item(prev);
        PROBE_MARK(i, 3);
        fence_proxy_async();
        named_barrier(1 + wg, NT);
        PROBE_MARK(i, 4);
        wgmma_fence();
        wgmma_3xtf32_ss<64, HK, BOX, BOX>(pv, p, p + 2 * BOX, smem_u32(sp), smem_u32(sp + 2 * BOX));
        wgmma_commit();
        PROBE_MARK(i, 5);
        issue_ahead(i);
        PROBE_MARK(i, 6);
        prev = g;
      }
    }
    wgmma_wait<0>();
    fence_operands(pv);
    add_item(prev);
  }

  const size_t row0 = (size_t)bh * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + r_lo + 8 * h;
    if (row >= S) continue;
    float* orow = o + (row0 + row) * d;
    static_for<G>([&](auto gc) {
      constexpr int g = decltype(gc)::value;
      const int col = 64 * (part.g0 + g);
      if (g < part.ng) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col + 8 * j + c2 < d)
            *reinterpret_cast<float2*>(orow + col + 8 * j + c2) =
                make_float2(oacc[g][4 * j + 2 * h] / l, oacc[g][4 * j + 2 * h + 1] / l);
      }
    });
    if (blockIdx.z == 0 && wg == 0 && lane % 4 == 0) lse[row0 + row] = m_r[h] + logf(l);
  }
}

template <bool CAUSAL>
int launch_f32_deep(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                    int S, int d, float scale, cudaStream_t stream) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::encode_map(encode, &tq, q, BH, S, d, F32, BM);
  if (!err) err = hopper::encode_map(encode, &tk, k, BH, S, d, F32, DEEP_BK);
  if (!err) err = hopper::encode_map(encode, &tv, v, BH, S, d, F32, DEEP_BK / 2);
  if (err) return err;
  // The layout of the W = 256 f32 kernel: two landing and two split slots a
  // warpgroup and the exchange.
  constexpr int smem = tf32_wide_smem_bytes();
  auto kern = flash_fwd_tf32_deep_kernel<CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (S + BM - 1) / BM, deep_blocks(d, DEEP32_GROUPS));
  kern<<<grid, 2 * NT, smem, stream>>>(tq, tk, tv, (float*)o, lse, S, d, scale);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- dispatch

typedef int (*Launcher)(const void*, const void*, const void*, void*, float*, int, int, int,
                        float, cudaStream_t);

// The launcher of a dtype (0 f32, 1 bf16, 2 f16), a head dim and a mask, or
// null: the tile width W is 64 for d <= 64, 128 for 64 < d <= 128 and 256
// for 128 < d <= 256, and past 256 the deep form (hopper::tile_width).
Launcher pick(int dtype, int d, int causal) {
  using bf16_t = __nv_bfloat16;
  static const Launcher f32[3][2] = {{launch_f32<64, false>, launch_f32<64, true>},
                                     {launch_f32<128, false>, launch_f32<128, true>},
                                     {launch_f32_wide<false>, launch_f32_wide<true>}};
  static const Launcher bf16[3][2] = {{launch_bf16<bf16_t, 64, false>, launch_bf16<bf16_t, 64, true>},
                                      {launch_bf16<bf16_t, 128, false>, launch_bf16<bf16_t, 128, true>},
                                      {launch_bf16_wide<bf16_t, false>, launch_bf16_wide<bf16_t, true>}};
  static const Launcher f16[3][2] = {{launch_bf16<__half, 64, false>, launch_bf16<__half, 64, true>},
                                     {launch_bf16<__half, 128, false>, launch_bf16<__half, 128, true>},
                                     {launch_bf16_wide<__half, false>, launch_bf16_wide<__half, true>}};
  static const Launcher deep_forms[3][2] = {
      {launch_f32_deep<false>, launch_f32_deep<true>},
      {launch_bf16_deep<bf16_t, false>, launch_bf16_deep<bf16_t, true>},
      {launch_bf16_deep<__half, false>, launch_bf16_deep<__half, true>}};
  if (dtype < 0 || dtype > 2) return nullptr;
  const int w = hopper::tile_width(d, dtype == 0 ? 4 : 2);
  if (w == 0) return nullptr;
  const int c = causal != 0;
  if (w == hopper::DEEP) return deep_forms[dtype][c];
  const int i = w == 64 ? 0 : w == 128 ? 1 : 2;
  return dtype == 0 ? f32[i][c] : dtype == 1 ? bf16[i][c] : f16[i][c];
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32 wgmma kernel), 1 = bfloat16 and 2 = float16
// (the 16-bit wgmma kernel); past D = 256 the deep form of the dtype.
// Returns a cudaError_t (0 on success) or one of hopper.cuh's ERR_* codes.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              int BH, int S, int D, int dtype, int causal, float scale,
              void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Launcher launch = pick(dtype, D, causal);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, BH, S, D, scale, (cudaStream_t)stream);
}

const char* flash_fwd_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
