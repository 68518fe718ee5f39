// K4: the 128-bit device fingerprint of a tensor, for Hopper (sm_90a).
//
// Replaces torchsnapshot_tpu/device_digest.py::_fingerprint_jit (lines
// 73-89) and ::_partial_jit (lines 196-227), which are jnp under jax.jit,
// not Pallas. The digest strings go into manifests that both packages read
// and must be bit-identical to the JAX package's, so the kernel computes
// exactly the JAX function:
//
//   word stream  the tensor's row-major elements as uint32 words: 1- and
//                2-byte elements (and bool) zero-extended to one word each,
//                4-byte elements one word, 8-byte elements two words, low
//                word first (on this little-endian card an 8-byte tensor is
//                read as its own uint32 memory);
//   lane s       sum over words, wrapping at 2^32, of
//                  mix32(word ^ mix32(w * 0x9E3779B9 + seed_s)),
//                w the word's index in the PIECE's word stream (uint32),
//                mix32 the lowbias32 finalizer
//                  x ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15;
//                  x *= 0x846CA68B; x ^= x >> 16.
// The host folds in the byte length (device_digest.py::_fold_lanes).
//
// Two kernels:
//   - digest_full_kernel<WB>: the whole tensor, w = the word's own index
//     (offsets 0, the region's own strides). WB = bytes per word in memory
//     (1, 2 or 4; 8-byte elements are WB = 4 over twice the words).
//   - digest_partial_kernel: a region of a piece (lane additivity: the sum
//     of the regions' lanes is the piece's lanes). Each element's index in
//     the piece is sum_d (offset_d + i_d) * stride_d in uint32, from the
//     region's own coordinates; w = that * words_per_element + j.
//
// Bound. Per word, each of the four lanes costs the tag (one IMAD and a
// mix32: two IMULs, three shifts, three XORs), the data mix (one XOR and a
// mix32) and one add: about 19 integer operations, 76 a word. nvcc shares
// the word's own shift between the lanes and folds the tag's multiply into
// one IMAD a vector, so the 16-byte loop is 288 SASS instructions for 4
// words, 72 a word (96 SHF, 96 LOP3, 66 IMAD, 16 VIADD, ...). That is 18
// instructions a byte of f32 data against the 5 a byte of memory bandwidth
// the card has, so K4 is bound by integer instructions, not by memory: at
// the most the card dispatches (132 SMs x 4 schedulers x 32 lanes a clock at
// 1.98 GHz, both integer pipes busy) a 16,777,216-byte f32 tensor needs
// 9.0 us, where its bytes alone take 5.0 us. The shifts and logic all go
// to the ALU pipe, half that rate, which puts the practical floor near
// 13 us. The tag depends only on the position and cannot come from a table
// without paying bytes again. (chip_smoke.py phase 1 counts the SASS and
// phase 10 times the kernel.)
//
// Design: a grid-stride loop with one 16-byte load per thread per step
// (when the tensor starts on a 16-byte boundary; otherwise, and for the
// ragged tail, word by word), the four lanes in registers, the shared
// w * golden product computed once per word for all four lanes, a warp
// reduction by shuffles, a block reduction through shared memory, and one
// atomicAdd per lane per block into the 16-byte output. Wrapping uint32
// addition is associative and commutative, so the atomics give a
// bit-identical result in any order: two launches on the same bytes agree
// bit for bit. The kernel allocates nothing; the wrapper zeroes the output
// and launches on the current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kM1 = 0x7FEB352Du;
constexpr unsigned kM2 = 0x846CA68Bu;
constexpr unsigned kGolden = 0x9E3779B9u;
constexpr unsigned kSeed0 = 0x85EBCA6Bu;
constexpr unsigned kSeed1 = 0xC2B2AE35u;
constexpr unsigned kSeed2 = 0x27D4EB2Fu;
constexpr unsigned kSeed3 = 0x165667B1u;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 8;

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

struct Lanes {
  unsigned s0, s1, s2, s3;
};

__device__ __forceinline__ void add_word(Lanes& l, unsigned word, unsigned w) {
  const unsigned wg = w * kGolden;
  l.s0 += mix32(word ^ mix32(wg + kSeed0));
  l.s1 += mix32(word ^ mix32(wg + kSeed1));
  l.s2 += mix32(word ^ mix32(wg + kSeed2));
  l.s3 += mix32(word ^ mix32(wg + kSeed3));
}

// Word i (0 <= i < 16 / WB) of a 16-byte vector, zero-extended.
template <int WB>
__device__ __forceinline__ unsigned vec_word(const uint4& v, int i) {
  const unsigned c = i * WB / 4 == 0 ? v.x : i * WB / 4 == 1 ? v.y : i * WB / 4 == 2 ? v.z : v.w;
  if (WB == 4) return c;
  const int shift = (i * WB % 4) * 8;
  return (c >> shift) & (WB == 2 ? 0xFFFFu : 0xFFu);
}

template <int WB>
__device__ __forceinline__ unsigned load_word(const unsigned char* src, unsigned long long k) {
  if (WB == 4) return __ldg(reinterpret_cast<const unsigned*>(src) + k);
  if (WB == 2) return __ldg(reinterpret_cast<const unsigned short*>(src) + k);
  return __ldg(src + k);
}

// Sum the block's lanes and add them to out[0..3] (one atomic per lane).
__device__ __forceinline__ void block_reduce_add(Lanes l, unsigned* out) {
  __shared__ unsigned partial[kWarps][4];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l.s0 += __shfl_down_sync(0xFFFFFFFFu, l.s0, off);
    l.s1 += __shfl_down_sync(0xFFFFFFFFu, l.s1, off);
    l.s2 += __shfl_down_sync(0xFFFFFFFFu, l.s2, off);
    l.s3 += __shfl_down_sync(0xFFFFFFFFu, l.s3, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    partial[warp][0] = l.s0;
    partial[warp][1] = l.s1;
    partial[warp][2] = l.s2;
    partial[warp][3] = l.s3;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][threadIdx.x];
    atomicAdd(out + threadIdx.x, s);
  }
}

// n_vec 16-byte vectors from src (0 when src is not 16-byte aligned), then
// words [n_vec * 16 / WB, n_words) one by one.
template <int WB>
__global__ void __launch_bounds__(kThreads) digest_full_kernel(
    const unsigned char* __restrict__ src, unsigned long long n_words,
    unsigned long long n_vec, unsigned* __restrict__ out) {
  constexpr int W = 16 / WB;
  Lanes l{0u, 0u, 0u, 0u};
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  const unsigned long long first = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src);
  for (unsigned long long v = first; v < n_vec; v += stride) {
    const uint4 raw = __ldg(vsrc + v);
    const unsigned base = (unsigned)(v * W);  // w wraps at 2^32, as in JAX
#pragma unroll
    for (int i = 0; i < W; ++i) add_word(l, vec_word<WB>(raw, i), base + i);
  }
  for (unsigned long long k = n_vec * W + first; k < n_words; k += stride) {
    add_word(l, load_word<WB>(src, k), (unsigned)k);
  }
  block_reduce_add(l, out);
}

struct Geometry {
  int ndim;
  unsigned long long shape[kMaxDims];  // the region's shape, in elements
  unsigned offsets[kMaxDims];          // the region's offsets in the piece
  unsigned strides[kMaxDims];          // the piece's row-major strides
};

__global__ void __launch_bounds__(kThreads) digest_partial_kernel(
    const unsigned char* __restrict__ src, unsigned long long n_elems, int elem_bytes,
    Geometry g, unsigned* __restrict__ out) {
  Lanes l{0u, 0u, 0u, 0u};
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  for (unsigned long long r = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
       r < n_elems; r += stride) {
    unsigned long long rem = r;
    unsigned e = 0;
    for (int d = g.ndim - 1; d >= 0; --d) {
      const unsigned long long i = rem % g.shape[d];
      rem /= g.shape[d];
      e += (g.offsets[d] + (unsigned)i) * g.strides[d];
    }
    if (elem_bytes == 8) {
      const unsigned* p = reinterpret_cast<const unsigned*>(src) + 2 * r;
      add_word(l, __ldg(p), e * 2u);
      add_word(l, __ldg(p + 1), e * 2u + 1u);
    } else if (elem_bytes == 4) {
      add_word(l, load_word<4>(src, r), e);
    } else if (elem_bytes == 2) {
      add_word(l, load_word<2>(src, r), e);
    } else {
      add_word(l, load_word<1>(src, r), e);
    }
  }
  block_reduce_add(l, out);
}

// Enough blocks to give every thread a few vectors, at most 8 per SM.
unsigned grid_for(unsigned long long items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 132;
  }
  const unsigned long long want = (items + kThreads - 1) / kThreads;
  const unsigned long long cap = 8ull * (unsigned long long)sms;
  return (unsigned)(want == 0 ? 1 : want < cap ? want : cap);
}

}  // namespace

extern "C" {

// The lanes of src, added into out[0..3] (the caller zeroes out first).
// ndim < 0: the whole tensor (digest_full_kernel). 0 <= ndim <= 8: a region
// of shape[0..ndim) at offsets[] in a piece with row-major strides[], all in
// elements (digest_partial_kernel). elem_bytes is 1, 2, 4 or 8. Returns a
// cudaError_t: 0 on success.
int digest_lanes(const void* src, unsigned long long n_elems, int elem_bytes, int ndim,
                 const unsigned long long* shape, const unsigned* offsets,
                 const unsigned* strides, unsigned* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* p = static_cast<const unsigned char*>(src);
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 && elem_bytes != 8)
    return (int)cudaErrorInvalidValue;
  if (ndim > kMaxDims) return (int)cudaErrorInvalidValue;
  if (ndim < 0) {
    const int wb = elem_bytes == 8 ? 4 : elem_bytes;
    const unsigned long long n_words = n_elems * (elem_bytes == 8 ? 2ull : 1ull);
    const bool aligned = ((uintptr_t)p % 16) == 0;
    const unsigned long long n_vec = aligned ? n_words * wb / 16 : 0;
    const unsigned grid = grid_for(n_vec > 0 ? n_vec : n_words);
    if (wb == 4)
      digest_full_kernel<4><<<grid, kThreads, 0, s>>>(p, n_words, n_vec, out);
    else if (wb == 2)
      digest_full_kernel<2><<<grid, kThreads, 0, s>>>(p, n_words, n_vec, out);
    else
      digest_full_kernel<1><<<grid, kThreads, 0, s>>>(p, n_words, n_vec, out);
  } else {
    Geometry g;
    g.ndim = ndim;
    for (int d = 0; d < kMaxDims; ++d) {
      g.shape[d] = d < ndim ? shape[d] : 1;
      g.offsets[d] = d < ndim ? offsets[d] : 0;
      g.strides[d] = d < ndim ? strides[d] : 0;
    }
    for (int d = 0; d < ndim; ++d)
      if (g.shape[d] == 0) n_elems = 0;
    digest_partial_kernel<<<grid_for(n_elems), kThreads, 0, s>>>(p, n_elems, elem_bytes, g, out);
  }
  return (int)cudaGetLastError();
}

const char* digest_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
