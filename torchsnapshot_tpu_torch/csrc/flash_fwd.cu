// Flash-attention forward for Hopper (sm_90a), FFMA on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_kernel` of
// torchsnapshot_tpu/ops/pallas_attention.py (lines 44-91), launched by
// `fwd_impl` in `_make_flash_parts` (line 237). Same function:
//   - q is pre-scaled by `scale` in f32 before the dot;
//   - an online softmax keeps (acc, m, l) in f32 and streams K/V tiles;
//   - o = acc / l in the input dtype, lse = m + log(l) in f32;
//   - causal: K tiles wholly above the diagonal are skipped by the loop
//     bound; inside a tile q_pos >= k_pos attends (a tie attends), and
//     masked scores are NEG_INF = -1e30, not -inf.
// Layout: q, k, v, o contiguous (BH, S, D); lse contiguous (BH, S).
//
// Design. One thread block of 128 threads per (bh, 64-row q tile). The
// q tile (pre-scaled, f32), the current 64-row K and V tiles and the
// 64x64 score tile live in shared memory; acc lives in registers (a 4-row
// by D/8-column micro-tile per thread), m and l in shared memory. The
// tiles are the kernel's own: S need not be a multiple of 64, so rows and
// keys past S are loaded as zeros and keys past S are masked.
// f32 inputs are multiplied in full f32 (no TF32), so the kernel meets
// the reference's 1e-5 bar.
//
// Bound at the serving shape (BH=32, S=256, D=64, bf16, causal): it must
// read q, k, v and write o (4 x 32*256*64 bf16 = 4.19 MB) plus lse
// (32 KB f32), about 1.26 us at 3.35 TB/s; the causal dot work is about
// 2*32*256^2*64 = 0.27 GFLOP, 0.27 us at the 989 TFLOP/s bf16 tensor-core
// peak. So the shape is bound by memory and by launch overhead. This
// first kernel runs its dots as FFMA on the CUDA cores; wgmma, TMA and a
// pipelined K/V ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // k rows per tile
constexpr int NT = 128;       // threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
  // Qs (BM x D+1), Ks (BN x D+1), Vs (BN x D), Ss (BM x BN+1), m, l, alpha.
  return BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + 3 * BM;
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
    Qs[r * (D + 1) + d] = row < S ? to_f32(q[base + (size_t)row * D + d]) * scale : 0.f;
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
      Ks[n * (D + 1) + d] = ok ? to_f32(k[off]) : 0.f;
      Vs[n * D + d] = ok ? to_f32(v[off]) : 0.f;
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
    for (int j = 0; j < DJ; ++j)
      store(&o[base + (size_t)row * D + cg + 8 * j], acc[i][j] / l);
  }
  if (tid < BM && m0 + tid < S)
    lse[(size_t)bh * S + m0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, D, CAUSAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                   lse, S, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_causal(const void* q, const void* k, const void* v, void* o,
                  float* lse, int BH, int S, int causal, float scale,
                  cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, o, lse, BH, S, scale, stream)
                : launch<T, D, false>(q, k, v, o, lse, BH, S, scale, stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int BH, int S, int D, int causal, float scale, cudaStream_t stream) {
  if (D == 64) return launch_causal<T, 64>(q, k, v, o, lse, BH, S, causal, scale, stream);
  if (D == 128) return launch_causal<T, 128>(q, k, v, o, lse, BH, S, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              int BH, int S, int D, int dtype, int causal, float scale,
              void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, o, lse, BH, S, D, causal, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, BH, S, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
