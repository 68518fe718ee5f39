// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, FFMA on the CUDA cores.
//
// Replaces the Pallas TPU kernels of torchsnapshot_tpu/ops/pallas_attention.py:
//   - `_bwd_dq_kernel` (lines 94-143, called at line 263) by flash_bwd_dq_kernel;
//   - `_bwd_dkv_kernel` (lines 146-200, called at line 278) by
//     flash_bwd_dkv_kernel.
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
// Design. The TPU split is kept: dq is gridded over q tiles and streams K/V;
// dk/dv is gridded over k tiles and streams Q/dO. Each output element is
// owned by one thread and summed in a fixed order, so there are no atomics
// and a run is bit-reproducible. Tiles are the kernel's own, 64 rows: S need
// not be a multiple of 64; rows past S load as zeros (dO, lse and delta
// too) and are masked, and the causal loop bounds are computed on these
// tiles, not on the caller's blocks.
//   - dq: 128 threads per (bh, 64-row q tile). q and dO tiles, the current
//     K and V tiles and the 64x64 ds tile live in shared memory as f32 (rows
//     padded by one word against bank conflicts); dq accumulates in
//     registers, a 4-row by D/8-column micro-tile per thread. Causal
//     programs stop after the diagonal K tile, as the forward does.
//   - dk/dv: 256 threads per (bh, 64-row k tile). Two accumulators (dk and
//     dv) would need 2 x 4 x D/8 registers a thread at 128 threads, 128 at
//     D=128; at 256 threads each thread owns 2 rows, so both fit in 64
//     registers without spilling. K and V tiles stay in shared memory, q and
//     dO tiles stream; p^T and ds^T tiles go through shared memory. Causal
//     programs start at the q tile that holds the k tile's diagonal.
// f32 inputs are multiplied in full f32 (no TF32), so the kernels meet the
// reference's 1e-4 gradient bar.
//
// Bound at the training shape (BH=32, S=256, D=64, bf16, causal): dq reads
// q, k, v, dO (4.19 MB) and lse, delta (65.5 KB) and writes dq (1.05 MB),
// about 1.58 us at 3.35 TB/s; dk/dv writes two outputs, about 1.90 us. The
// causal dots are 3 (dq) and 4 (dk/dv) products of 2*D flop over 1,052,672
// attended pairs, 0.40 and 0.54 GFLOP, under 0.6 us at the 989 TFLOP/s bf16
// tensor-core peak. Both are bound by bytes and, at this size, by launch
// latency; these first kernels run their dots as FFMA, and wgmma, TMA and
// pipelined tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // k rows per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// A 64-row tile of a (S, D) operand, as f32, into shared memory with row
// stride D + 1; rows past S load as zeros.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < S ? to_f32(src[(size_t)row * D + d]) : 0.f;
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

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, float scale) {
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

  load_tile<T, D, NT>(Qs, q + base, m0, S);
  load_tile<T, D, NT>(Gs, g + base, m0, S);
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
    load_tile<T, D, NT>(Ks, k + base, k0, S);
    load_tile<T, D, NT>(Vs, v + base, k0, S);
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
    for (int j = 0; j < DJ; ++j) store(&dq[base + (size_t)row * D + cg + 8 * j], acc[i][j] * scale);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, float scale) {
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

  load_tile<T, D, NT>(Ks, k + base, n0, S);
  load_tile<T, D, NT>(Vs, v + base, n0, S);

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
    load_tile<T, D, NT>(Qs, q + base, m0, S);
    load_tile<T, D, NT>(Gs, g + base, m0, S);
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
      store(&dk[off], acc_k[i][j] * scale);
      store(&dv[off], acc_v[i][j]);
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

template <bool DKV, typename T, int D, bool CAUSAL>
int launch(const Args& a, cudaStream_t stream) {
  const T *q = (const T*)a.q, *k = (const T*)a.k, *v = (const T*)a.v, *g = (const T*)a.g;
  cudaError_t err;
  if constexpr (DKV) {
    constexpr int smem = dkv_smem_floats<D>() * (int)sizeof(float);
    auto kern = flash_bwd_dkv_kernel<T, D, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.BH, (a.S + BN - 1) / BN);
    kern<<<grid, 256, smem, stream>>>(q, k, v, g, a.lse, a.delta, (T*)a.out0, (T*)a.out1,
                                      a.S, a.scale);
  } else {
    constexpr int smem = dq_smem_floats<D>() * (int)sizeof(float);
    auto kern = flash_bwd_dq_kernel<T, D, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.BH, (a.S + BM - 1) / BM);
    kern<<<grid, 128, smem, stream>>>(q, k, v, g, a.lse, a.delta, (T*)a.out0, a.S, a.scale);
  }
  return (int)cudaGetLastError();
}

template <bool DKV, typename T>
int dispatch_d(const Args& a, int D, int causal, cudaStream_t st) {
  if (D == 64) return causal ? launch<DKV, T, 64, true>(a, st) : launch<DKV, T, 64, false>(a, st);
  if (D == 128)
    return causal ? launch<DKV, T, 128, true>(a, st) : launch<DKV, T, 128, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <bool DKV>
int dispatch(const Args& a, int D, int dtype, int causal, void* stream) {
  if (a.BH <= 0 || a.S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<DKV, float>(a, D, causal, st);
  if (dtype == 1) return dispatch_d<DKV, __nv_bfloat16>(a, D, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 on success).
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

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
