// Host runtime of torchsnapshot_tpu_torch: the byte work of the checkpoint
// path that runs on the CPU. A copy of the JAX package's native runtime
// (torchsnapshot_tpu/_native/native.cpp) without its io_uring engine; the
// two packages keep separate copies so that neither imports the other.
//
//   ts_crc32c       - CRC32C (Castagnoli) checksums for end-to-end snapshot
//                     integrity. Uses the SSE4.2 CRC32 instruction when the
//                     CPU has it, 3-way interleaved over independent lanes
//                     to hide the instruction's 3-cycle latency, with a
//                     slicing-by-8 software fallback.
//   ts_copy_crc32c  - a copy and the CRC32C of the copied bytes in one pass
//                     over the source.
//   ts_scatter_copy - one C call performing many (dst_off, src_off, size)
//                     memcpys within a single source buffer.
//   ts_gather_copy  - one C call packing many separate source buffers into
//                     one destination (write-batcher slab packing).
//   ts_slab_*       - page-aligned staging slabs: mmap-backed (MAP_HUGETLB
//                     when the size permits, THP via MADV_HUGEPAGE
//                     otherwise), pre-faulted at allocation so the first
//                     staging copy never pays page faults, mlock'd
//                     best-effort. Every capability degrades independently;
//                     the caller learns what it got. The Python side
//                     registers each slab with CUDA (cudaHostRegister) so
//                     that device copies DMA into it directly.
//
// Built with plain g++ (no pybind11 dependency); loaded via ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__linux__)
#include <sys/mman.h>
#include <unistd.h>
#endif

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // CRC32C, reflected

uint32_t g_table[8][256];
bool g_table_init = false;

void init_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) {
      crc = (crc >> 1) ^ ((crc & 1) ? kPoly : 0);
    }
    g_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_table[0][i];
    for (int k = 1; k < 8; ++k) {
      crc = g_table[0][crc & 0xFF] ^ (crc >> 8);
      g_table[k][i] = crc;
    }
  }
  g_table_init = true;
}

uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  if (!g_table_init) init_table();
  // Slicing-by-8: fold 8 bytes per iteration through 8 tables.
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
    uint32_t hi = static_cast<uint32_t>(p[4]) |
                  (static_cast<uint32_t>(p[5]) << 8) |
                  (static_cast<uint32_t>(p[6]) << 16) |
                  (static_cast<uint32_t>(p[7]) << 24);
    crc = g_table[7][crc & 0xFF] ^ g_table[6][(crc >> 8) & 0xFF] ^
          g_table[5][(crc >> 16) & 0xFF] ^ g_table[4][crc >> 24] ^
          g_table[3][hi & 0xFF] ^ g_table[2][(hi >> 8) & 0xFF] ^
          g_table[1][(hi >> 16) & 0xFF] ^ g_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) {
    crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  }
  return crc;
}

#if defined(__x86_64__) && defined(__SSE4_2__)
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) {
    c32 = _mm_crc32_u8(c32, *p++);
  }
  return c32;
}

// --- 3-way interleaved CRC32C ------------------------------------------
//
// A single crc32q dependency chain is latency-bound (3 cycles/8 bytes,
// ~2 GB/s on this class of core); three INDEPENDENT chains fill the
// pipeline for ~3x. Each 3K-byte block is split into lanes A|B|C crc'd
// concurrently, then recombined with the standard zero-append identity
//   F(s, A||B||C) = shift_2K(F(s,A)) ^ shift_K(F(0,B)) ^ F(0,C)
// where shift_z (the CRC state after appending z zero bytes) is a
// GF(2)-linear map applied as a 32x32 bit-matrix, built once by
// square-and-multiply from the one-zero-bit LFSR step.

uint32_t gf2_times(const uint32_t* m, uint32_t v) {
  uint32_t s = 0;
  for (int i = 0; v; v >>= 1, ++i) {
    if (v & 1) s ^= m[i];
  }
  return s;
}

void make_zero_shift_op(uint32_t* op, uint64_t zero_bits) {
  uint32_t m[32], tmp[32];
  // One-zero-bit step on the reflected-polynomial state (column i = step
  // applied to the unit vector 1<<i); identical to init_table's
  // crc = (crc >> 1) ^ (crc & 1 ? poly : 0).
  for (int i = 0; i < 32; ++i) {
    uint32_t v = 1u << i;
    m[i] = (v >> 1) ^ ((v & 1) ? kPoly : 0);
  }
  for (int i = 0; i < 32; ++i) op[i] = 1u << i;  // identity
  while (zero_bits) {
    if (zero_bits & 1) {
      for (int i = 0; i < 32; ++i) tmp[i] = gf2_times(m, op[i]);
      std::memcpy(op, tmp, sizeof(tmp));
    }
    for (int i = 0; i < 32; ++i) tmp[i] = gf2_times(m, m[i]);
    std::memcpy(m, tmp, sizeof(tmp));
    zero_bits >>= 1;
  }
}

constexpr size_t kLane = 8192;  // bytes per lane; block = 3 lanes

struct ShiftOps {
  uint32_t by_lane[32];    // shift by kLane zero bytes
  uint32_t by_2lanes[32];  // shift by 2*kLane zero bytes
  ShiftOps() {
    make_zero_shift_op(by_lane, 8ull * kLane);
    make_zero_shift_op(by_2lanes, 16ull * kLane);
  }
};

const ShiftOps& shift_ops() {
  static const ShiftOps ops;  // C++11 thread-safe init
  return ops;
}

uint32_t crc32c_hw_3way(const uint8_t* p, size_t n, uint32_t crc) {
  const ShiftOps& ops = shift_ops();
  while (n >= 3 * kLane) {
    uint64_t a = crc, b = 0, c = 0;
    const uint8_t* pa = p;
    const uint8_t* pb = p + kLane;
    const uint8_t* pc = p + 2 * kLane;
    for (size_t i = 0; i < kLane; i += 8) {
      uint64_t va, vb, vc;
      std::memcpy(&va, pa + i, 8);
      std::memcpy(&vb, pb + i, 8);
      std::memcpy(&vc, pc + i, 8);
      a = _mm_crc32_u64(a, va);
      b = _mm_crc32_u64(b, vb);
      c = _mm_crc32_u64(c, vc);
    }
    crc = gf2_times(ops.by_2lanes, static_cast<uint32_t>(a)) ^
          gf2_times(ops.by_lane, static_cast<uint32_t>(b)) ^
          static_cast<uint32_t>(c);
    p += 3 * kLane;
    n -= 3 * kLane;
  }
  return crc32c_hw(p, n, crc);
}
#endif

}  // namespace

extern "C" {

int ts_has_hw_crc() {
#if defined(__x86_64__) && defined(__SSE4_2__)
  return __builtin_cpu_supports("sse4.2") ? 1 : 0;
#else
  return 0;
#endif
}

// Incremental CRC32C over [p, p+n). Pass crc=0 to start; chain the returned
// value for subsequent extents. (Pre/post inversion is handled internally,
// matching the common crc32c() convention.)
uint32_t ts_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
#if defined(__x86_64__) && defined(__SSE4_2__)
  if (__builtin_cpu_supports("sse4.2")) {
    // 3-way interleave pays for its combine only on real payloads.
    if (n >= 3 * kLane) {
      return ~crc32c_hw_3way(p, n, crc);
    }
    return ~crc32c_hw(p, n, crc);
  }
#endif
  return ~crc32c_sw(p, n, crc);
}

// Fused copy + CRC32C: dst[0:n] = src[0:n], returning the CRC32C of the
// bytes, reading the source ONCE. async_take's staging must both copy
// (consistency: the caller may mutate/donate after it returns) and
// checksum (integrity entries are gathered right after staging); doing
// them in one pass saves a full memory read of the state per snapshot.
// Chunked so src stays L2-resident between the memcpy and the crc of
// each block.
uint32_t ts_copy_crc32c(uint8_t* dst, const uint8_t* src, size_t n,
                        uint32_t crc) {
  constexpr size_t kBlock = 1 << 18;  // 256 KB
  size_t off = 0;
  while (off < n) {
    size_t len = n - off < kBlock ? n - off : kBlock;
    std::memcpy(dst + off, src + off, len);
    crc = ts_crc32c(dst + off, len, crc);
    off += len;
  }
  return crc;
}

// n region copies in one call: dst[dst_off[i] : +sizes[i]] =
// src[src_off[i] : +sizes[i]]. Caller guarantees bounds and no overlap.
void ts_scatter_copy(uint8_t* dst, const uint8_t* src, const uint64_t* dst_off,
                     const uint64_t* src_off, const uint64_t* sizes, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    std::memcpy(dst + dst_off[i], src + src_off[i],
                static_cast<size_t>(sizes[i]));
  }
}

// Pack n separate source buffers into dst: dst[dst_off[i] : +sizes[i]] =
// srcs[i][0 : sizes[i]]. Caller guarantees bounds and no overlap.
void ts_gather_copy(uint8_t* dst, const uint8_t* const* srcs,
                    const uint64_t* dst_off, const uint64_t* sizes, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    std::memcpy(dst + dst_off[i], srcs[i], static_cast<size_t>(sizes[i]));
  }
}

}  // extern "C"

// ===================================================================
// Staging slabs (Linux only; elsewhere the allocator reports "unavailable"
// and the Python layer stages without slabs).
// ===================================================================

#if defined(__linux__)

namespace {
constexpr size_t kHugePage = 2ull << 20;  // MAP_HUGETLB granule (x86_64)
constexpr size_t kSmallPage = 4096;
}  // namespace

extern "C" {

// Capability bits for ts_slab_alloc (both `want` and the `*got` result):
//   1 = MAP_HUGETLB backing      (only attempted when n % 2 MiB == 0)
//   2 = mlock'd (never swapped)  (fails under RLIMIT_MEMLOCK: degraded)
//   4 = pre-faulted              (touch loop — always achieved on success)
//   8 = MADV_HUGEPAGE            (THP hint on the non-hugetlb path)
//
// Returns a page-aligned mapping of n bytes, or NULL (errno set). The
// touch loop runs AFTER the THP hint so first faults can be promoted,
// and strides every 4 KiB so the slab is fully resident when this
// returns: staging copies and O_DIRECT transfers never fault.
void* ts_slab_alloc(size_t n, int want, int* got) {
  int caps = 0;
  void* p = MAP_FAILED;
  if ((want & 1) && n >= kHugePage && (n % kHugePage) == 0) {
    p = mmap(nullptr, n, PROT_READ | PROT_WRITE,
             MAP_PRIVATE | MAP_ANONYMOUS | MAP_HUGETLB | MAP_POPULATE, -1, 0);
    if (p != MAP_FAILED) caps |= 1 | 4;
  }
  if (p == MAP_FAILED) {
    p = mmap(nullptr, n, PROT_READ | PROT_WRITE,
             MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    if (want & 8) {
      if (madvise(p, n, MADV_HUGEPAGE) == 0) caps |= 8;
    }
    if (want & 4) {
      volatile uint8_t* b = static_cast<volatile uint8_t*>(p);
      for (size_t off = 0; off < n; off += kSmallPage) b[off] = 0;
      caps |= 4;
    }
  }
  if (want & 2) {
    if (mlock(p, n) == 0) caps |= 2;
  }
  if (got) *got = caps;
  return p;
}

void ts_slab_free(void* p, size_t n) {
  if (p != nullptr && n) munmap(p, n);
}

}  // extern "C"

#else  // !__linux__

extern "C" {
void* ts_slab_alloc(size_t, int, int* got) {
  if (got) *got = 0;
  return nullptr;
}
void ts_slab_free(void*, size_t) {}
}  // extern "C"

#endif  // __linux__
