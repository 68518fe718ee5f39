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
#include <cuda_fp16.h>
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

// Fetch a tensor map into the cache before its first TMA: the first use of
// an uncached map holds the issuing thread.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy one box from shared memory at `src` to a 3-D tensor map at (c0, c1,
// c2); the box's elements past the map's bounds are not written. The
// threads that wrote `src` run fence_proxy_async and a barrier first; the
// issuing thread commits and waits (tma_store_wait) before the block ends.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Commit this thread's TMA stores and wait until they have read their
// shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ------------------------------------------------ 16-bit element types
//
// The 16-bit tensor-core kernels take bf16 or f16, one template for both:
// Elem16<T> gives the type's wgmma operand name (through the HOPPER_WGMMA
// macros below) and its tensor-map data type; pack16<T> rounds two f32
// values into one register of T. A bf16 wgmma on f16 bits (or the reverse)
// computes wrong numbers with no error, so the type is never a runtime
// value inside a kernel.
template <typename T>
struct Elem16;
template <>
struct Elem16<__nv_bfloat16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem16<__half> {
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

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
// both operands K-major through descriptors, of element type T (bf16 or
// f16). scale_d = 0 overwrites D.
#define HOPPER_WGMMA_SS64(TY)                                                                       \
  asm volatile(                                                                                      \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "           \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (Elem16<T>::F16)
    HOPPER_WGMMA_SS64("f16");
  else
    HOPPER_WGMMA_SS64("bf16");
}

// D (64 x 64 f32) (+)= A (64 x 16 of T, registers) * B (16 x 64, shared
// memory), B MN-major (N contiguous, transposed) through its descriptor.
#define HOPPER_WGMMA_RS64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (Elem16<T>::F16)
    HOPPER_WGMMA_RS64("f16");
  else
    HOPPER_WGMMA_RS64("bf16");
}

// D (64 x 128 f32) (+)= A (64 x 16 of T, registers) * B (16 x 128, shared
// memory), B MN-major (N contiguous, transposed) through its descriptor.
#define HOPPER_WGMMA_RS128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (Elem16<T>::F16)
    HOPPER_WGMMA_RS128("f16");
  else
    HOPPER_WGMMA_RS128("bf16");
}

// D (64 x 256 f32) (+)= A (64 x 16 of T, registers) * B (16 x 256, shared
// memory), B MN-major (N contiguous, transposed) through its descriptor.
#define HOPPER_WGMMA_RS256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (Elem16<T>::F16)
    HOPPER_WGMMA_RS256("f16");
  else
    HOPPER_WGMMA_RS256("bf16");
}

// D (64 x N f32) (+)= A (64 x 16 of T, registers) * B (16 x N, shared memory,
// MN-major), N = 64, 128 or 256: the product of an A fragment repacked from an
// accumulator with a tile read as it lies (the forward's P V, the
// backward's dS K, P^T dO and dS^T Q).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs takes N = 64, 128 or 256");
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<T>(d, a, desc_b, 1);
  else if constexpr (N == 128)
    wgmma_m64n128k16_rs<T>(d, a, desc_b, 1);
  else
    wgmma_m64n256k16_rs<T>(d, a, desc_b, 1);
}

// Warpgroups of a bf16 dq block (flash_bwd_dq_wgmma_kernel) by tile width:
// one up to 128; at 256 two, each computing the whole S and dP tiles and
// owning a 128-column half of dq, which in one warpgroup would take 128 f32
// accumulator registers a thread beside the score tiles. At 256 the bf16
// forward and dk/dv are kernels of their own (flash_fwd_wgmma_wide_kernel;
// flash_bwd_dkv_wgmma_wide_kernel, whose warpgroups part the score work).
template <int W>
__host__ __device__ constexpr int warpgroups() {
  return W > 128 ? 2 : 1;
}

// ------------------------------------------------ 64-row 16-bit tiles
//
// A tile is 64 rows of D = 64, 128 or 256 bf16 or f16 columns (the tile width; a
// head dim under it lands zeros in the columns past it) as TMA lands it:
// one 64-row x 128-byte swizzled box per 64 columns, boxes 8,192 bytes
// apart.

// acc (+)= A B^T over D in k16 steps, both 64-row tiles K-major in shared
// memory at a_base and b_base (a k16 step moves 32 bytes inside a box's
// rows, and the fifth step starts the second box); the first step
// overwrites.
template <typename T, int D>
__device__ __forceinline__ void wgmma_ss_tiles(float (&acc)[32], uint32_t a_base, uint32_t b_base) {
  constexpr int BOX = 64 * 128;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_m64n64k16_ss<T>(acc, desc_sw128(a_base + off, 16, 1024), desc_sw128(b_base + off, 16, 1024),
                       kk > 0);
  }
}

// acc (+)= A B over a tile's 64 rows in k16 steps: A the four k16 A
// fragments in registers, B a 64-row tile in shared memory at b_base read
// MN-major (16 rows, 2,048 bytes, a k16 step; N crosses into the next box
// BOX bytes on). D is the product's width, 64 or 128: at tile width 256 a
// warpgroup takes the 128 columns of its half, b_base two boxes on.
template <typename T, int D>
__device__ __forceinline__ void wgmma_rs_tile(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                              uint32_t b_base) {
  constexpr int BOX = 64 * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<T, D>(acc, a[kk], desc_sw128(b_base + kk * 2048, BOX, 1024));
}

// The 64-row tile of a (BH, S, D) tensor map at row `row` of head `bh`,
// one box per 64 columns, into dst; completion counts on bar.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int bh) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) tma_load_3d(dst + b * 64 * 128, map, bar, b * 64, row, bh);
}

// Two f32 values as one register of two T (bf16 or f16, rounded to nearest,
// lo in the low half): the element pair an A fragment holds, or an output
// pair as it is stored.
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (Elem16<T>::F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// A 64 x 32 f32 accumulator fragment (rows x 64 columns) as the A fragments
// of four k16 steps over its columns: step kk takes columns 16kk..16kk+15.
template <typename T>
__device__ __forceinline__ void accum_to_a(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack16<T>(c[8 * kk + 0], c[8 * kk + 1]);  // row lo, columns 16kk + 2(t%4)
    a[kk][1] = pack16<T>(c[8 * kk + 2], c[8 * kk + 3]);  // row lo + 8
    a[kk][2] = pack16<T>(c[8 * kk + 4], c[8 * kk + 5]);  // row lo, columns + 8
    a[kk][3] = pack16<T>(c[8 * kk + 6], c[8 * kk + 7]);  // row lo + 8, columns + 8
  }
}

// Rows r_lo and r_lo + 8 of a 64 x N f32 accumulator fragment, row r_lo + 8h
// times mul[h], as T (bf16 or f16) into 64-row tiles laid out as TMA lands
// and stores them (one 128-byte swizzled box per 64 columns, boxes 8,192
// bytes apart) at dst: an output tile staged for tma_store_3d. The 32 lanes
// of a warp store each 8-column chunk to 32 distinct banks.
template <typename T, int N>
__device__ __forceinline__ void stage_rows16(uint8_t* dst, const float (&acc)[N / 2],
                                                const float (&mul)[2], int r_lo, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    uint8_t* row = dst + r * 128 + (lane % 4) * 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + (j / 8) * 64 * 128 + (((j % 8) ^ (r % 8)) << 4)) =
          pack16<T>(acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
  }
}

// wgmma reads its A fragments asynchronously: keeps their registers from
// being reused before the wait that follows the issue.
template <int K>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// ------------------------------------------- f32 as three TF32 products
//
// The f32 kernels (the forward and both backward ones) run each f32 product
// A B on the tensor cores as A_lo B_hi + A_hi B_lo + A_hi B_hi into one f32
// accumulator, small terms first, with hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest with ties away from zero (cvt.rna.tf32.f32). A
// tf32 operand of wgmma must be K-major, so an operand contracted over its
// rows is written transposed by the split pass. f32 tiles land as TMA
// writes them with 128-byte swizzle: 32-column boxes of R rows x 128 bytes,
// R * 128 bytes apart.

// Orders this thread's generic-proxy writes to shared memory before reads
// by the async proxy (wgmma, TMA) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Block barrier `id` (1-15; 0 is __syncthreads) over `n` threads, a
// multiple of 32: one warpgroup of a warp-specialized block syncs alone.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as a 32-bit pattern whose low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "r"(__float_as_uint(x)));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Byte offset of element (r, c) in an R-row f32 tile as TMA lands it.
__device__ __forceinline__ int sw_off(int r, int c, int R) {
  return (c >> 5) * R * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The column a transposed copy stores element row x at: inside each group of
// 8, x = 2t goes to position t and x = 2t + 1 to position t + 4, the order
// in which accum_to_tf32_a hands an accumulator's columns to wgmma as k.
__device__ __forceinline__ int perm8(int x) {
  return (x & ~7) | ((x & 7) >> 1) | ((x & 1) << 2);
}

// Bytes of the transposed copy of an R-row x C-column tile: C rows of 128
// bytes for every 32 (or fewer) of its R columns.
template <int R, int C>
__host__ __device__ constexpr int transposed_bytes() {
  return C * 128 * ((R + 31) / 32);
}

// Split an R x C f32 tile at `raw` (which may be `hi` itself) into its hi
// and lo tiles of the same layout and, if T, into hi and lo copies of its
// transpose (C rows x R columns, columns permuted by perm8), by the 128
// threads of the block, 16 bytes a step.
template <int R, int C, bool T>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                           uint8_t* hi_t, uint8_t* lo_t) {
  for (int ch = threadIdx.x; ch < R * C / 4; ch += 128) {
    const int o = ch * 16;
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
    if constexpr (T) {
      const int r = (o >> 7) % R;
      const int c = (o / (R * 128)) * 32 + ((((o >> 4) & 7) ^ (r & 7)) << 2);
      const int col = perm8(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = sw_off(c + e, col, C);
        *reinterpret_cast<uint32_t*>(hi_t + off) = h[e];
        *reinterpret_cast<uint32_t*>(lo_t + off) = l[e];
      }
    }
  }
}

// The hi and lo copies of the transpose of an R x C f32 tile at `raw` (C
// rows x R columns, columns permuted by perm8; R a multiple of 8, C of 32),
// by the 128 threads of a warpgroup (`tid` 0-127 in it). A warp takes 8
// rows and 32 columns a step, one column a lane: perm8 puts the 4 even and
// the 4 odd rows of a group of 8 side by side, so each lane writes them as
// one 16-byte store each. Its loads and stores are free of bank conflicts,
// where split_tile's transposed stores are 4-way conflicted. UNROLL steps of
// a warp are unrolled (all by default).
template <int R, int C, int UNROLL = (R / 8) * (C / 32) / 4>
__device__ __forceinline__ void split_tile_transposed(const uint8_t* raw, uint8_t* hi_t,
                                                      uint8_t* lo_t, int tid) {
  static_assert((R / 8) * (C / 32) % 4 == 0, "the warps share the groups evenly");
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll UNROLL
  for (int i = 0; i < (R / 8) * (C / 32) / 4; ++i) {
    const int task = warp + 4 * i;
    const int r0 = (task % (R / 8)) * 8;
    const int c = (task / (R / 8)) * 32 + lane;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(*reinterpret_cast<const float*>(raw + sw_off(r0 + 2 * j + odd, c, R)), h[j],
                   l[j]);
      // perm8(r0 + 2j + odd) = r0 + 4 odd + j.
      const int off = sw_off(c, r0 + 4 * odd, C);
      *reinterpret_cast<uint4*>(hi_t + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo_t + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// D (64 x N f32) (+)= A (64 x 8 tf32) * B (N x 8 tf32)^T, both K-major in
// shared memory through descriptors (tf32 takes no transpose).
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d);
// D (64 x N f32) (+)= A (64 x 8 tf32, registers) * B (N x 8 tf32, K-major in
// shared memory)^T. A register holds, for thread t of the warpgroup, rows
// 16*(t/32) + (t%32)/4 (a[0], a[2]) and that row + 8 (a[1], a[3]), k = t%4
// (a[0], a[1]) and k = t%4 + 4 (a[2], a[3]).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// acc (+)= A B^T over KD f32 columns in k8 steps, A a 64-row and B an N-row
// tile K-major in shared memory (boxes A_BOX and B_BOX bytes apart); the
// first step overwrites when `fresh`.
template <int N, int KD, int A_BOX, int B_BOX>
__device__ __forceinline__ void wgmma_tf32_ss_tiles(float (&acc)[N / 2], uint32_t a, uint32_t b,
                                                    bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;
    wgmma_tf32_ss<N>(acc, desc_sw128(a + (kk / 4) * A_BOX + in_box, 16, 1024),
                     desc_sw128(b + (kk / 4) * B_BOX + in_box, 16, 1024), !(fresh && kk == 0));
  }
}

// acc = A B^T as the three TF32 products, small terms first.
template <int N, int KD, int A_BOX, int B_BOX>
__device__ __forceinline__ void wgmma_3xtf32_ss(float (&acc)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                                uint32_t b_hi, uint32_t b_lo) {
  wgmma_tf32_ss_tiles<N, KD, A_BOX, B_BOX>(acc, a_lo, b_hi, true);
  wgmma_tf32_ss_tiles<N, KD, A_BOX, B_BOX>(acc, a_hi, b_lo, false);
  wgmma_tf32_ss_tiles<N, KD, A_BOX, B_BOX>(acc, a_hi, b_hi, false);
}

// acc = A B^T as the three TF32 products, small terms first: A the hi and
// lo fragments of KD / 8 k8 steps in registers, B an N-row tile K-major in
// shared memory (boxes B_BOX bytes apart).
template <int N, int KD, int B_BOX>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&acc)[N / 2], const uint32_t (&a_hi)[KD / 8][4],
                                                const uint32_t (&a_lo)[KD / 8][4], uint32_t b_hi,
                                                uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk)
    wgmma_tf32_rs<N>(acc, a_lo[kk], desc_sw128(b_hi + (kk / 4) * B_BOX + (kk % 4) * 32, 16, 1024),
                     kk > 0);
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk)
    wgmma_tf32_rs<N>(acc, a_hi[kk], desc_sw128(b_lo + (kk / 4) * B_BOX + (kk % 4) * 32, 16, 1024), 1);
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk)
    wgmma_tf32_rs<N>(acc, a_hi[kk], desc_sw128(b_hi + (kk / 4) * B_BOX + (kk % 4) * 32, 16, 1024), 1);
}

// ------------------------------ 32-column chunks (the kernels at W = 256)
//
// The f32 kernels at tile width 256 stream their operands in chunks of 32
// columns of d, one TMA box each (R rows x 128 bytes, 128-byte swizzle),
// split both operands of a score chunk into hi and lo (split_box) and run
// the score products chunk by chunk (the backward's wgmma_3xtf32_chunk).

// Arrive on block barrier `id` (counting `n` threads, as the bar.sync that
// waits on it) without waiting: a warpgroup hands data to another. The
// fence makes this thread's shared-memory writes visible first.
__device__ __forceinline__ void named_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Split BYTES of f32 values at `raw` into their hi and lo words at the same
// offsets (a chunk keeps its swizzled layout), by the 128 threads of a
// warpgroup (`wt` 0-127), 16 bytes a step.
template <int BYTES>
__device__ __forceinline__ void split_box(const uint8_t* raw, uint8_t* hi, uint8_t* lo, int wt) {
  static_assert(BYTES % 2048 == 0, "whole steps of the warpgroup");
#pragma unroll
  for (int s = 0; s < BYTES / 2048; ++s) {
    const int o = s * 2048 + wt * 16;
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A number as a type: the index static_for hands its body.
template <int I>
struct Index {
  static constexpr int value = I;
};

// f(Index<0>()), ..., f(Index<N - 1>()): a loop whose index is a constant
// in each body, so that an array of accumulators indexed by it stays in
// registers (a `#pragma unroll` loop over an array of output tiles left
// the array in local memory).
template <int N, int I = 0, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Index<I>());
    static_for<N, I + 1>(static_cast<F&&>(f));
  }
}

// acc += x, element by element, in f32 (rounded to nearest).
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N], const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += x[i];
}

// One chunk (four k8 steps) of a score product A B^T as the three TF32
// products: small (+)= A_lo B_hi + A_hi B_lo and big = A_hi B_hi, A a
// 64-row and B an N-row chunk, each K-major hi and lo in shared memory;
// `first` overwrites small at the first step. big sums fresh, four k8
// steps: the caller adds it to the running sum of the large terms in f32,
// and the product is that sum + small. wgmma's adds are not rounded to
// nearest, so no chain of them runs over more than a chunk of large terms
// (one chain over the 32 k8 steps of d = 256 failed the float64 bound of
// tests/test_torch_kernels_cuda.py); the small terms, 2^-11 of the large,
// take one chain over every chunk.
template <int N>
__device__ __forceinline__ void wgmma_3xtf32_chunk(float (&small)[N / 2], float (&big)[N / 2],
                                                   uint32_t a_hi, uint32_t a_lo, uint32_t b_hi,
                                                   uint32_t b_lo, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ah = desc_sw128(a_hi + kk * 32, 16, 1024);
    const uint64_t al = desc_sw128(a_lo + kk * 32, 16, 1024);
    const uint64_t bh = desc_sw128(b_hi + kk * 32, 16, 1024);
    const uint64_t bl = desc_sw128(b_lo + kk * 32, 16, 1024);
    wgmma_tf32_ss<N>(small, al, bh, !(first && kk == 0));
    wgmma_tf32_ss<N>(small, ah, bl, 1);
    wgmma_tf32_ss<N>(big, ah, bh, kk > 0);
  }
}

// A 64 x N f32 accumulator fragment as the hi and lo tf32 A fragments of
// N / 8 k8 steps over its columns. Step j takes columns 8j..8j+7 with no
// value moving between threads: the accumulator gives thread t columns
// 2(t%4) and 2(t%4) + 1 of each chunk, which the A fragment reads as k =
// t%4 and t%4 + 4; the B operand of the product is a transposed copy whose
// columns split_tile permuted the same way (perm8).
template <int N>
__device__ __forceinline__ void accum_to_tf32_a(const float (&c)[N / 2], uint32_t (&hi)[N / 8][4],
                                                uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split_tf32(c[4 * j + 0], hi[j][0], lo[j][0]);  // row lo,     column 2(t%4)     -> k = t%4
    split_tf32(c[4 * j + 2], hi[j][1], lo[j][1]);  // row lo + 8, column 2(t%4)     -> k = t%4
    split_tf32(c[4 * j + 1], hi[j][2], lo[j][2]);  // row lo,     column 2(t%4) + 1 -> k = t%4 + 4
    split_tf32(c[4 * j + 3], hi[j][3], lo[j][3]);  // row lo + 8, column 2(t%4) + 1 -> k = t%4 + 4
  }
}

// The R-row tile of a (BH, S, D) f32 tensor map (boxes of 32 columns x R
// rows) at row `row` of head `bh` into dst; completion counts on bar.
template <int D, int R>
__device__ __forceinline__ void tma_tile_f32(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                             int row, int bh) {
#pragma unroll
  for (int b = 0; b < D / 32; ++b) tma_load_3d(dst + b * R * 128, map, bar, b * 32, row, bh);
}

// --------------------------------------------- clock64() marks (probes)
//
// PROBE_MARK(row, k): with HOPPER_PROBE defined (scripts/flash_deep_probe.py
// builds so), thread 0 of each warpgroup of block (0, 0, 0) records
// clock64() as mark k (0-7) of row `row` (an item of its stream), read back
// by probe_read; otherwise nothing. The marks cost the probed build a store
// each; the package's build has none.
constexpr int PROBE_ROWS = 96;
#ifdef HOPPER_PROBE
__device__ long long g_probe[2][PROBE_ROWS][8];
#define PROBE_MARK(row, k)                                                                     \
  do {                                                                                          \
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x % 128 == 0 &&      \
        (row) < ::hopper::PROBE_ROWS)                                                           \
      ::hopper::g_probe[threadIdx.x / 128][(row)][(k)] = clock64();                             \
  } while (0)
#else
#define PROBE_MARK(row, k) \
  do {                     \
  } while (0)
#endif

// ------------------------------------ 16-bit rings past head dim 256
//
// The 16-bit deep kernels (flash_fwd.cu flash_fwd_wgmma_deep_kernel,
// flash_bwd.cu flash_bwd_dq_wgmma_deep_kernel and
// flash_bwd_dkv_wgmma_deep_kernel) stream each warpgroup's items through
// a ring of STAGES landing slots of two 64-row boxes of 64 columns (LAND
// bytes apart), whose full barriers are `full`: a score item is a chunk of
// d of the product's A and B, an output item one box of the operand its
// product reads MN-major. `i` counts the warpgroup's items; release(j)
// hands item j's slot back (every warp of the warpgroup is done with it)
// and refills it.

// acc = A B^T over nc chunks of 64 columns of d, items i.., chained in one
// accumulator, one chunk's products in flight while the next is issued.
template <typename T, int STAGES, typename Release>
__device__ __forceinline__ void deep16_scores(float (&acc)[32], const uint8_t* land,
                                              uint64_t* full, int& i, int nc, Release&& release) {
  constexpr int BOX = 64 * 128, LAND = 2 * BOX;
  for (int c = 0; c < nc; ++c, ++i) {
    const uint32_t a = smem_u32(land + (i % STAGES) * LAND);
    PROBE_MARK(i, 0);
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    PROBE_MARK(i, 1);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<T>(acc, desc_sw128(a + kk * 32, 16, 1024),
                            desc_sw128(a + BOX + kk * 32, 16, 1024), c > 0 || kk > 0);
    wgmma_commit();
    PROBE_MARK(i, 5);
    if (c > 0) {
      wgmma_wait<1>();
      PROBE_MARK(i, 3);
      release(i - 1);
      PROBE_MARK(i, 4);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (nc > 0) release(i - 1);
}

// acc[g] (+)= A B_g for the warpgroup's ng (<= G) groups, items i.., A the
// four k16 A fragments (64 rows x 64 k) in registers, each B_g a 64-row box
// read MN-major as it lands, one group's products in flight while the
// next is issued.
template <typename T, int G, int STAGES, typename Release>
__device__ __forceinline__ void deep16_outputs(float (&acc)[G][32], uint32_t (&a)[4][4],
                                               const uint8_t* land, uint64_t* full, int& i,
                                               int ng, Release&& release) {
  constexpr int LAND = 2 * 64 * 128;
  static_for<G>([&](auto gc) {
    constexpr int g = decltype(gc)::value;
    if (g < ng) {
      const uint32_t b = smem_u32(land + (i % STAGES) * LAND);
      PROBE_MARK(i, 0);
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      PROBE_MARK(i, 1);
      fence_operands(acc[g]);
      wgmma_fence();
      wgmma_rs_tile<T, 64>(acc[g], a, b);
      wgmma_commit();
      PROBE_MARK(i, 5);
      if (g > 0) {
        wgmma_wait<1>();
        PROBE_MARK(i, 3);
        release(i - 1);
        PROBE_MARK(i, 4);
      }
      ++i;
    }
  });
  wgmma_wait<0>();
  static_for<G>([&](auto gc) { fence_operands(acc[decltype(gc)::value]); });
  fence_fragments(a);
  if (ng > 0) release(i - 1);
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

// The tile width W a kernel runs head dim d at: 64 for d <= 64, 128 for
// 64 < d <= 128, 256 for 128 < d <= 256; DEEP for d > 256, the forms that
// stream d in chunks. Every form takes a row of d elements of `elt` bytes
// that is a multiple of 16 bytes (the global stride TMA takes; the
// wrappers pad a head dim to it); 0 where no kernel takes d.
constexpr int DEEP = -1;
inline int tile_width(int d, int elt) {
  if (d <= 0 || (d * elt) % 16) return 0;
  if (d > 256) return DEEP;
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// A 3-D map over a contiguous (BH, S, D) tensor of `type`, innermost first,
// with boxes of `rows` rows of 128 bytes (64 bf16 or f16 columns, 32 f32),
// 128-byte swizzle and zero fill out of bounds. D is the tensor's own head
// dim, which may be under the kernel's
// tile width: a box stays 128 bytes wide, TMA lands zeros in its columns
// past D (a box wholly past D lands all zeros) and counts every byte of the
// box on the barrier, so a tile's transaction count does not depend on D.
// The encoder refuses a base address that is not 16-byte aligned.
// Returns 0 or ERR_ENCODE + the CUresult.
inline int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int BH, int S, int D,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, int rows = 64) {
  const cuuint64_t elt = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elt, (cuuint64_t)S * D * elt};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elt), (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
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

#ifdef HOPPER_PROBE
// The marks of the last probed launch (2 x PROBE_ROWS x 8 int64), and their
// reset to 0.
extern "C" int probe_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, hopper::g_probe, sizeof(hopper::g_probe));
}
extern "C" int probe_clear() {
  static const long long zeros[2 * hopper::PROBE_ROWS * 8] = {};
  return (int)cudaMemcpyToSymbol(hopper::g_probe, zeros, sizeof(hopper::g_probe));
}
#endif
