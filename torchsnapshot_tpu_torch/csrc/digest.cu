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
//   - digest_partial_kernel<EB>: a region of a piece (lane additivity: the
//     sum of the regions' lanes is the piece's lanes), read in place through
//     its own element strides. EB = bytes per element (1, 2, 4 or 8). Each
//     element's index in the piece is e = sum_d (offset_d + i_d) * stride_d
//     in uint32, stride_d the piece's row-major strides; its words are
//     w = e * words_per_element + j.
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
// Full form: a grid-stride loop with one 16-byte load per thread per step
// (when the tensor starts on a 16-byte boundary; otherwise, and for the
// ragged tail, word by word), the four lanes in registers, the shared
// w * golden product computed once per word for all four lanes, a warp
// reduction by shuffles, a block reduction through shared memory, and one
// atomicAdd per lane per block into the 16-byte output. Wrapping uint32
// addition is associative and commutative, so the atomics give a
// bit-identical result in any order: two launches on the same bytes agree
// bit for bit. The kernel allocates nothing; the wrapper zeroes the output
// and launches on the current stream.
//
// Partial form. Placing each element by its coordinates costs a 64-bit
// divide and modulo per dim per element, which the GPU emulates in dozens
// of instructions: more than the 72 a word of the hash itself (the direct
// transcription of _partial_jit that did so, with 4-byte scalar loads, ran
// at a fifth of its bound). So the host
// (device_digest.py::region_runs) reduces the region's geometry to RUNS:
// stretches contiguous both in the piece's word index and in the region's
// memory (size-1 dims dropped, each inner dim merged into the one outside
// it while the piece strides and the memory strides both stay row-major
// over it). A run has `len` elements; runs are indexed by up to 8 outer
// dims, each with its count, its piece stride (uint32) and its memory
// stride (elements). Within a run, e and the address both advance by one
// per element, so the hash loop needs no division at all; a run's start
// (e, address) is decomposed once per run, or once per 4 KiB tile of a
// long run, by multiply-high divisions whose magic numbers the host
// computes (FastDiv: no division by a runtime value in the kernel). Two
// mappings, picked by the host from the run's bytes:
//   - long runs (>= 512 bytes, 32 vectors: one for every lane of a warp):
//     a WARP takes a tile of `tile_vecs` 16-byte vectors of one run
//     (chunk c of the run's aligned body), the lanes on neighbouring
//     vectors (512 coalesced bytes a warp a load). The elements before the
//     run's first 16-byte boundary and after its last whole vector (fewer
//     than 16 bytes each) are hashed one by one by chunk 0's lanes. This is
//     the full form's loop plus one add a vector; phase 15's (2, 4, 512,
//     2048) f32 region is 2 runs of 4,194,304 elements, 8,192 tiles, about
//     one a warp of a full grid.
//   - short runs (fewer than 512 bytes, such as a slice of 1-64 columns
//     over many rows): a flat grid-stride walk over the region's elements,
//     one element a thread a step, (run, column) from one FastDiv by `len`
//     and the run's start from one FastDiv per outer dim, with scalar
//     loads (neighbouring threads on neighbouring elements within a run).
//     Per element that is 1 + n_outer multiply-high divisions, some 10
//     instructions each, beside the 72 a word of the hash.
// Both end in the full form's block reduction: one atomic per lane per
// block.

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
constexpr int kMaxOuter = 8;  // outer dims of a region's runs

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

// n / d and n % d for any 64-bit n without a divide instruction: t the
// high half of n * m, q = (t + ((n - t) >> 1)) >> s, with the magic m and
// the shift s computed on the host (device_digest.py::_fast_divisor;
// d == 1 passes n through).
struct FastDiv {
  unsigned long long d, m;
  unsigned s;
};

__device__ __forceinline__ unsigned long long div_rem(const FastDiv& f, unsigned long long n,
                                                      unsigned long long& rem) {
  unsigned long long q = n;
  if (f.d != 1) {
    const unsigned long long t = __umul64hi(n, f.m);
    q = (t + ((n - t) >> 1)) >> f.s;
  }
  rem = n - q * f.d;
  return q;
}

// A region as runs (device_digest.py::region_runs, ::_runs_words): runs of
// `len` elements, each contiguous in the piece's element index and in
// memory, indexed by n_outer outer dims (innermost first).
struct Runs {
  unsigned long long len;        // elements a run
  unsigned long long n_items;    // tiles (tile_vecs > 0) or elements (flat walk)
  unsigned long long tile_vecs;  // 16-byte vectors a tile; 0: the flat walk
  unsigned base;                 // e of the region's first element
  int n_outer;
  FastDiv inner;                 // by tiles a run (tiles) or by len (flat walk)
  FastDiv count[kMaxOuter];
  unsigned pstride[kMaxOuter];            // piece stride, uint32
  unsigned long long mstride[kMaxOuter];  // memory stride, elements
};

// The piece index e and the memory offset m (elements) of run r's first
// element.
__device__ __forceinline__ void locate(const Runs& g, unsigned long long r, unsigned& e,
                                       unsigned long long& m) {
  e = g.base;
  m = 0;
#pragma unroll
  for (int d = 0; d < kMaxOuter; ++d) {
    if (d < g.n_outer) {
      unsigned long long i;
      r = div_rem(g.count[d], r, i);
      e += (unsigned)i * g.pstride[d];
      m += i * g.mstride[d];
    }
  }
}

// Element k of src (an EB-byte element at piece index e): one word, or two
// (low first) for 8-byte elements.
template <int EB>
__device__ __forceinline__ void add_elem(Lanes& l, const unsigned char* src, unsigned long long k,
                                         unsigned e) {
  if (EB == 8) {
    const unsigned* p = reinterpret_cast<const unsigned*>(src) + 2 * k;
    add_word(l, __ldg(p), e * 2u);
    add_word(l, __ldg(p + 1), e * 2u + 1u);
  } else {
    add_word(l, load_word<EB>(src, k), e);
  }
}

template <int EB>
__global__ void __launch_bounds__(kThreads) digest_partial_kernel(
    const unsigned char* __restrict__ src, Runs g, unsigned* __restrict__ out) {
  constexpr int WB = EB == 8 ? 4 : EB;  // bytes a word in memory
  constexpr int W = 16 / WB;            // words a vector
  constexpr int VE = 16 / EB;           // elements a vector
  constexpr unsigned WPE = EB == 8 ? 2u : 1u;
  Lanes l{0u, 0u, 0u, 0u};
  if (g.tile_vecs > 0) {
    // Long runs: a warp a tile (run r, chunk c of its aligned body).
    const unsigned lane = threadIdx.x % 32;
    const unsigned long long warps = (unsigned long long)gridDim.x * kWarps;
    for (unsigned long long t = ((unsigned long long)blockIdx.x * kThreads + threadIdx.x) / 32;
         t < g.n_items; t += warps) {
      unsigned long long chunk, m;
      unsigned e;
      locate(g, div_rem(g.inner, t, chunk), e, m);
      const unsigned char* p = src + m * EB;
      const unsigned head = (unsigned)((16u - ((uintptr_t)p & 15u)) & 15u) / EB;
      const unsigned long long n_vec = (g.len - head) * EB / 16;
      const uint4* vp = reinterpret_cast<const uint4*>(p + head * EB);
      const unsigned eh = e + head;
      const unsigned long long v0 = chunk * g.tile_vecs;
      const unsigned long long v1 = v0 + g.tile_vecs < n_vec ? v0 + g.tile_vecs : n_vec;
      for (unsigned long long v = v0 + lane; v < v1; v += 32) {
        const uint4 raw = __ldg(vp + v);
        const unsigned w0 = (eh + (unsigned)v * VE) * WPE;  // wraps at 2^32, as in JAX
#pragma unroll
        for (int i = 0; i < W; ++i) add_word(l, vec_word<WB>(raw, i), w0 + i);
      }
      if (chunk == 0) {
        if (lane < head) add_elem<EB>(l, p, lane, e + lane);
        const unsigned long long tail = head + n_vec * VE;
        if (lane < g.len - tail) add_elem<EB>(l, p, tail + lane, e + (unsigned)(tail + lane));
      }
    }
  } else {
    // Short runs: a flat walk, one element a thread a step.
    const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
    for (unsigned long long k = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
         k < g.n_items; k += stride) {
      unsigned long long col, m;
      unsigned e;
      locate(g, div_rem(g.inner, k, col), e, m);
      add_elem<EB>(l, src, m + col, e + (unsigned)col);
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
// runs == NULL: the whole tensor of n_elems elements (digest_full_kernel).
// Otherwise a region given as runs (digest_partial_kernel): 8 + 5 x 8
// 64-bit words laid out by device_digest.py::_runs_words,
//   [0] len, [1] n_items, [2] base, [3] n_outer, [4] tile_vecs,
//   [5..7] the inner divisor (d, m, s),
//   [8 + 5 k .. 12 + 5 k] outer dim k, innermost first: (d, m, s) of its
//   count, its piece stride, its memory stride.
// elem_bytes is 1, 2, 4 or 8. Returns a cudaError_t: 0 on success.
int digest_lanes(const void* src, unsigned long long n_elems, int elem_bytes,
                 const unsigned long long* runs, unsigned* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* p = static_cast<const unsigned char*>(src);
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 && elem_bytes != 8)
    return (int)cudaErrorInvalidValue;
  if (runs == nullptr) {
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
    return (int)cudaGetLastError();
  }
  Runs g;
  g.len = runs[0];
  g.n_items = runs[1];
  g.base = (unsigned)runs[2];
  g.n_outer = (int)runs[3];
  g.tile_vecs = runs[4];
  if (g.n_outer < 0 || g.n_outer > kMaxOuter) return (int)cudaErrorInvalidValue;
  g.inner = FastDiv{runs[5], runs[6], (unsigned)runs[7]};
  for (int d = 0; d < kMaxOuter; ++d) {
    const unsigned long long* o = runs + 8 + 5 * d;
    g.count[d] = FastDiv{o[0], o[1], (unsigned)o[2]};
    g.pstride[d] = (unsigned)o[3];
    g.mstride[d] = o[4];
  }
  // Tiles: a warp each, kWarps a block. The flat walk: a thread an element.
  const unsigned grid = g.tile_vecs > 0 ? grid_for(g.n_items * 32) : grid_for(g.n_items);
  if (elem_bytes == 8)
    digest_partial_kernel<8><<<grid, kThreads, 0, s>>>(p, g, out);
  else if (elem_bytes == 4)
    digest_partial_kernel<4><<<grid, kThreads, 0, s>>>(p, g, out);
  else if (elem_bytes == 2)
    digest_partial_kernel<2><<<grid, kThreads, 0, s>>>(p, g, out);
  else
    digest_partial_kernel<1><<<grid, kThreads, 0, s>>>(p, g, out);
  return (int)cudaGetLastError();
}

const char* digest_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
