// Hopper (sm_90a) building blocks for the port's kernels: mbarriers, TMA
// tensor loads, wgmma shared-memory descriptors and the wgmma products.
//
// Written against the PTX ISA for sm_90a (no CUTLASS). Every device function
// is issued as inline PTX; the kernels compose them. The host side encodes
// the TMA tensor maps the kernels take. Conventions:
//   - shared-memory addresses are 32-bit `.shared` addresses (smem_u32);
//   - a tile that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B is a run of
//     8-row x 128-byte atoms and must start on a 1024-byte boundary, the
//     period of the swizzle, so the TMA's and wgmma's views of it agree;
//   - wgmma accumulators use the m64nNk16 f32 fragment: thread t of the
//     warpgroup holds rows 16*(t/32) + (t%32)/4 and that row + 8, and in
//     each 8-column chunk j the columns 8j + 2*(t%4) and that column + 1:
//     register 4j+0, 4j+1 (row), 4j+2, 4j+3 (row + 8).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow it with a block-wide barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// --------------------------------------------------------------------- TMA

// Copy one box of a 3-D tensor map at coordinates (c0, c1, c2), innermost
// first, into shared memory at `dst`; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units, 14 bits
// each) and layout type 1 (SWIZZLE_128B) in bits 62-63. Base offset 0: the
// tile starts on a 1024-byte boundary.
//   K-major (rows of 64 bf16 along K): lbo unused (1), sbo = 1024, the
//     stride between 8-row atoms; a k16 step inside the 128-byte row
//     advances the start address by 32 bytes.
//   MN-major (rows of 64 bf16 along N, one row per k): lbo = the stride
//     between 64-column atoms along N, sbo = 1024, the stride between
//     groups of 8 k-rows; a k16 step advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// Orders this thread's earlier register and shared-memory writes before
// the wgmma that follow (needed before the first wgmma, and after any
// register of an accumulator or A fragment was written by other code).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an issue or a wait: an empty asm that claims to change each one.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64 f32) (+)= A (64 x 16, shared memory) * B (64 x 16, shared memory)^T,
// both operands K-major through descriptors. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64 f32) (+)= A (64 x 16 bf16, registers) * B (16 x 64, shared
// memory), B MN-major (N contiguous, transposed) through its descriptor.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128 f32) (+)= A (64 x 16 bf16, registers) * B (16 x 128, shared
// memory), B MN-major (N contiguous, transposed) through its descriptor.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x N f32) (+)= A (64 x 16 bf16, registers) * B (16 x N, shared memory,
// MN-major), N = 64 or 128: the product of an A fragment repacked from an
// accumulator with a tile read as it lies (the forward's P V, the
// backward's dS K, P^T dO and dS^T Q).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_m64n64k16_rs(d, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_m64n128k16_rs(d, a, desc_b, 1);
}

// ------------------------------------------------ 64-row bf16 tiles
//
// A tile is 64 rows of D = 64 or 128 bf16 columns as TMA lands it: one
// 64-row x 128-byte swizzled box per 64 columns, boxes 8,192 bytes apart.

// acc (+)= A B^T over D in k16 steps, both 64-row tiles K-major in shared
// memory at a_base and b_base (a k16 step moves 32 bytes inside a box's
// rows, and the fifth step starts the second box); the first step
// overwrites.
template <int D>
__device__ __forceinline__ void wgmma_ss_tiles(float (&acc)[32], uint32_t a_base, uint32_t b_base) {
  constexpr int BOX = 64 * 128;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a_base + off, 16, 1024), desc_sw128(b_base + off, 16, 1024),
                       kk > 0);
  }
}

// acc (+)= A B over a tile's 64 rows in k16 steps: A the four k16 A
// fragments in registers, B a 64-row tile in shared memory at b_base read
// MN-major (16 rows, 2,048 bytes, a k16 step; N crosses into the second box
// BOX bytes on).
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                              uint32_t b_base) {
  constexpr int BOX = 64 * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, a[kk], desc_sw128(b_base + kk * 2048, BOX, 1024));
}

// The 64-row tile of a (BH, S, D) tensor map at row `row` of head `bh`,
// one box per 64 columns, into dst; completion counts on bar.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int bh) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) tma_load_3d(dst + b * 64 * 128, map, bar, b * 64, row, bh);
}

// Two f32 values as one register of two bf16 (lo in the low half): the
// element pair an A fragment holds.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 32 f32 accumulator fragment (rows x 64 columns) as the A fragments
// of four k16 steps over its columns: step kk takes columns 16kk..16kk+15.
__device__ __forceinline__ void accum_to_a(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);  // row lo, columns 16kk + 2(t%4)
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);  // row lo + 8
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);  // row lo, columns + 8
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);  // row lo + 8, columns + 8
  }
}

// wgmma reads its A fragments asynchronously: keeps their registers from
// being reused before the wait that follows the issue.
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// ------------------------------------------------------- tensor maps (host)

// Return codes beside cudaError_t: a tensor map that could not be encoded
// (plus its CUresult), or no cuTensorMapEncodeTiled in the driver.
constexpr int ERR_ENCODE = 10000;
constexpr int ERR_NO_ENCODE = 20000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 3-D map over a contiguous (BH, S, D) bf16 tensor, innermost first, with
// 64 x 64 x 1 boxes (64 rows of 64 columns), 128-byte swizzle and zero fill
// out of bounds. The encoder refuses a base address that is not 16-byte
// aligned. Returns 0 or ERR_ENCODE + the CUresult.
inline int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int BH, int S, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// The message of a launcher's return code: a tensor-map code above, else
// the cudaError_t's own.
inline const char* error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_NO_ENCODE) return "the driver has no cuTensorMapEncodeTiled";
  if (err >= ERR_ENCODE && err < ERR_NO_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d", err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace hopper
