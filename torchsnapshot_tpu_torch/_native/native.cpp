// Host runtime of torchsnapshot_tpu_torch: the byte work of the checkpoint
// path that runs on the CPU. A copy of the JAX package's native runtime
// (torchsnapshot_tpu/_native/native.cpp); the two packages keep separate
// copies so that neither imports the other.
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
//   ts_uring_*      - a minimal io_uring submission/completion engine
//                     (raw syscalls, no liburing): sub-chunk pwrites and
//                     preads become queued SQEs executed by kernel workers
//                     (IOSQE_ASYNC), so the checksum and staging of chunk
//                     N+1 run while the kernel moves chunk N. Short ops are
//                     resubmitted internally; errors surface per slot as
//                     -errno.
//
// Built with plain g++ (no pybind11 dependency); loaded via ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__linux__)
#include <cerrno>
#include <new>
#include <sys/mman.h>
#include <sys/syscall.h>
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

// ------------------------------------------------------------- io_uring
//
// Raw-syscall engine (the toolchain ships no liburing). ABI structs are
// declared locally — they are kernel-stable since 5.6, and the opcodes
// used (IORING_OP_READ/WRITE) are plain fd+offset transfers.

namespace uring {

constexpr long kSetup = 425;  // x86_64 syscall numbers
constexpr long kEnter = 426;

constexpr uint64_t kOffSqRing = 0ull;
constexpr uint64_t kOffCqRing = 0x8000000ull;
constexpr uint64_t kOffSqes = 0x10000000ull;

constexpr unsigned kEnterGetevents = 1u;
constexpr uint8_t kOpRead = 22;
constexpr uint8_t kOpWrite = 23;

struct sqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array, resv1;
  uint64_t resv2;
};
struct cqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes, flags, resv1;
  uint64_t resv2;
};
struct params {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle;
  uint32_t features, wq_fd, resv[3];
  sqring_offsets sq_off;
  cqring_offsets cq_off;
};
struct sqe {
  uint8_t opcode, flags;
  uint16_t ioprio;
  int32_t fd;
  uint64_t off, addr;
  uint32_t len, rw_flags;
  uint64_t user_data;
  uint16_t buf_index, personality;
  int32_t splice_fd_in;
  uint64_t pad2[2];
};
static_assert(sizeof(sqe) == 64, "io_uring_sqe ABI");
struct cqe {
  uint64_t user_data;
  int32_t res;
  uint32_t flags;
};

struct Op {
  uint8_t* buf;
  uint64_t len, off, done;
  int fd;
  int32_t err;
  uint8_t is_write, in_use, completed, retries;
  uint8_t sqe_flags;  // submit-time IOSQE_* bits, reused on resubmits
};

struct Engine {
  int ring_fd;
  unsigned entries;   // sq_entries (pow2 >= requested depth)
  unsigned inflight;
  void* sq_ptr;
  size_t sq_map_len;
  void* cq_ptr;
  size_t cq_map_len;
  sqe* sqes;
  size_t sqes_map_len;
  uint32_t* sq_head;
  uint32_t* sq_tail;
  uint32_t* sq_mask;
  uint32_t* sq_array;
  uint32_t* cq_head;
  uint32_t* cq_tail;
  uint32_t* cq_mask;
  cqe* cqes;
  Op* ops;  // [entries]
};

constexpr uint8_t kMaxOpRetries = 16;  // -EAGAIN / short-op resubmit cap

int enter(int fd, unsigned to_submit, unsigned min_complete, unsigned flags) {
  for (;;) {
    long r = syscall(kEnter, fd, to_submit, min_complete, flags, nullptr, 0);
    if (r >= 0) return static_cast<int>(r);
    if (errno != EINTR) return -errno;
  }
}

// Push one SQE (ring is always drained of submissions between calls —
// non-SQPOLL io_uring_enter consumes every queued SQE synchronously).
int push(Engine* e, unsigned slot, uint8_t sqe_flags) {
  Op* op = &e->ops[slot];
  uint32_t tail = *e->sq_tail;
  uint32_t idx = tail & *e->sq_mask;
  sqe* s = &e->sqes[idx];
  std::memset(s, 0, sizeof(*s));
  s->opcode = op->is_write ? kOpWrite : kOpRead;
  s->flags = sqe_flags;
  s->fd = op->fd;
  s->off = op->off + op->done;
  s->addr = reinterpret_cast<uint64_t>(op->buf + op->done);
  s->len = static_cast<uint32_t>(op->len - op->done);
  s->user_data = slot;
  e->sq_array[idx] = idx;
  __atomic_store_n(e->sq_tail, tail + 1, __ATOMIC_RELEASE);
  int r = enter(e->ring_fd, 1, 0, 0);
  if (r < 1) {
    // Nothing consumed: roll the tail back so the stale SQE can never
    // be picked up by a later enter and execute as a duplicate. Safe:
    // the engine is single-threaded and a non-SQPOLL kernel only reads
    // the SQ during enter.
    __atomic_store_n(e->sq_tail, tail, __ATOMIC_RELEASE);
    return r < 0 ? r : -EBUSY;
  }
  return 0;
}

// Process every available CQE; short/-EAGAIN ops are resubmitted (same
// slot, advanced offset) up to the retry cap. Returns completions
// processed, or -errno on a resubmission transport failure.
int reap(Engine* e) {
  int n = 0;
  for (;;) {
    uint32_t head = *e->cq_head;
    uint32_t tail = __atomic_load_n(e->cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) return n;
    cqe c = e->cqes[head & *e->cq_mask];
    __atomic_store_n(e->cq_head, head + 1, __ATOMIC_RELEASE);
    Op* op = &e->ops[c.user_data];
    bool done = false;
    if (c.res == -EAGAIN && op->retries < kMaxOpRetries) {
      op->retries++;
      int r = push(e, static_cast<unsigned>(c.user_data), op->sqe_flags);
      if (r < 0) {
        // A failed resubmission MUST complete the op with the error:
        // leaving it counted as inflight with no queued SQE would make
        // every later drain/close spin in GETEVENTS forever.
        op->err = r;
        done = true;
      }
    } else if (c.res < 0) {
      op->err = c.res;
      done = true;
    } else if (c.res == 0 && !op->is_write && op->done < op->len) {
      op->err = -ENODATA;  // EOF before the requested range was served
      done = true;
    } else {
      op->done += static_cast<uint64_t>(c.res);
      if (op->done < op->len) {
        if (op->retries++ >= kMaxOpRetries) {
          op->err = -EIO;
          done = true;
        } else {
          int r = push(e, static_cast<unsigned>(c.user_data), op->sqe_flags);
          if (r < 0) {
            op->err = r;
            done = true;
          }
        }
      } else {
        done = true;
      }
    }
    if (done) {
      op->completed = 1;
      e->inflight--;
      n++;
    }
  }
}

int wait_some(Engine* e, unsigned min_done) {
  unsigned got = 0;
  for (;;) {
    int r = reap(e);
    if (r < 0) return r;
    got += static_cast<unsigned>(r);
    if (got >= min_done || e->inflight == 0) return static_cast<int>(got);
    r = enter(e->ring_fd, 0, 1, kEnterGetevents);
    if (r < 0 && r != -EBUSY) return r;
  }
}

}  // namespace uring

extern "C" {

// Create an engine with ~depth queued ops. Returns an opaque handle, or
// NULL with errno set (ENOSYS: old kernel; EPERM: seccomp/sysctl).
void* ts_uring_init(unsigned depth) {
  using namespace uring;
  if (depth < 1) depth = 1;
  if (depth > 256) depth = 256;
  params p;
  std::memset(&p, 0, sizeof(p));
  long fd = syscall(kSetup, depth, &p);
  if (fd < 0) return nullptr;
  Engine* e = new (std::nothrow) Engine();
  if (e == nullptr) {
    close(static_cast<int>(fd));
    errno = ENOMEM;
    return nullptr;
  }
  std::memset(e, 0, sizeof(*e));
  e->ring_fd = static_cast<int>(fd);
  e->entries = p.sq_entries;
  e->sq_map_len = p.sq_off.array + p.sq_entries * sizeof(uint32_t);
  e->cq_map_len = p.cq_off.cqes + p.cq_entries * sizeof(cqe);
  e->sqes_map_len = p.sq_entries * sizeof(sqe);
  e->sq_ptr = mmap(nullptr, e->sq_map_len, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, e->ring_fd, kOffSqRing);
  e->cq_ptr = mmap(nullptr, e->cq_map_len, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, e->ring_fd, kOffCqRing);
  e->sqes = static_cast<sqe*>(
      mmap(nullptr, e->sqes_map_len, PROT_READ | PROT_WRITE,
           MAP_SHARED | MAP_POPULATE, e->ring_fd, kOffSqes));
  e->ops = new (std::nothrow) Op[e->entries];
  if (e->sq_ptr == MAP_FAILED || e->cq_ptr == MAP_FAILED ||
      e->sqes == MAP_FAILED || e->ops == nullptr) {
    int saved = errno ? errno : ENOMEM;
    if (e->sq_ptr != MAP_FAILED) munmap(e->sq_ptr, e->sq_map_len);
    if (e->cq_ptr != MAP_FAILED) munmap(e->cq_ptr, e->cq_map_len);
    if (e->sqes != MAP_FAILED) munmap(e->sqes, e->sqes_map_len);
    delete[] e->ops;
    close(e->ring_fd);
    delete e;
    errno = saved;
    return nullptr;
  }
  std::memset(e->ops, 0, e->entries * sizeof(Op));
  uint8_t* sq = static_cast<uint8_t*>(e->sq_ptr);
  e->sq_head = reinterpret_cast<uint32_t*>(sq + p.sq_off.head);
  e->sq_tail = reinterpret_cast<uint32_t*>(sq + p.sq_off.tail);
  e->sq_mask = reinterpret_cast<uint32_t*>(sq + p.sq_off.ring_mask);
  e->sq_array = reinterpret_cast<uint32_t*>(sq + p.sq_off.array);
  uint8_t* cq = static_cast<uint8_t*>(e->cq_ptr);
  e->cq_head = reinterpret_cast<uint32_t*>(cq + p.cq_off.head);
  e->cq_tail = reinterpret_cast<uint32_t*>(cq + p.cq_off.tail);
  e->cq_mask = reinterpret_cast<uint32_t*>(cq + p.cq_off.ring_mask);
  e->cqes = reinterpret_cast<uring::cqe*>(cq + p.cq_off.cqes);
  return e;
}

void ts_uring_close(void* handle) {
  using namespace uring;
  if (handle == nullptr) return;
  Engine* e = static_cast<Engine*>(handle);
  // Outstanding kernel ops hold the buffers the caller pinned; closing
  // the ring fd cancels/except them, but draining first keeps slot
  // accounting honest for callers that skipped ts_uring_drain on error.
  if (e->inflight) wait_some(e, e->inflight);
  munmap(e->sq_ptr, e->sq_map_len);
  munmap(e->cq_ptr, e->cq_map_len);
  munmap(e->sqes, e->sqes_map_len);
  close(e->ring_fd);
  delete[] e->ops;
  delete e;
}

// Quick availability probe: can this process set up a ring at all?
// 0 when yes, -errno (ENOSYS/EPERM/...) when not.
int ts_uring_probe() {
  void* e = ts_uring_init(2);
  if (e == nullptr) return errno ? -errno : -1;
  ts_uring_close(e);
  return 0;
}

// Queue one positional transfer. Returns the op's slot id (>= 0), or
// -errno. When every slot is busy, blocks until one completes first.
// ``sqe_flags``: IOSQE_* bits — callers pass IOSQE_ASYNC (0x10) to force
// kernel-worker execution so the submitting thread returns immediately.
int ts_uring_submit(void* handle, int is_write, int fd, void* buf,
                    uint64_t len, uint64_t off, unsigned sqe_flags) {
  using namespace uring;
  Engine* e = static_cast<Engine*>(handle);
  while (e->inflight >= e->entries) {
    // Full ring: progress requires a completion — but the freed slot may
    // still be awaiting its ts_uring_wait_slot, so only ops the caller
    // has already released are reusable below.
    int r = wait_some(e, 1);
    if (r < 0) return r;
    break;
  }
  unsigned slot = e->entries;
  for (unsigned i = 0; i < e->entries; ++i) {
    if (!e->ops[i].in_use) {
      slot = i;
      break;
    }
  }
  if (slot == e->entries) return -EBUSY;  // caller holds every slot
  Op* op = &e->ops[slot];
  std::memset(op, 0, sizeof(*op));
  op->buf = static_cast<uint8_t*>(buf);
  op->len = len;
  op->off = off;
  op->fd = fd;
  op->is_write = is_write ? 1 : 0;
  op->in_use = 1;
  op->sqe_flags = static_cast<uint8_t>(sqe_flags);
  int r = push(e, slot, static_cast<uint8_t>(sqe_flags));
  if (r < 0) {
    op->in_use = 0;
    return r;
  }
  e->inflight++;
  return static_cast<int>(slot);
}

// Transport-layer failures (io_uring_enter itself erroring while ops
// may still be live in the kernel) are offset by this so callers can
// distinguish them from per-op errnos and KEEP their buffer pins: the
// op's buffer may still be written by the kernel, so the slot is NOT
// released — teardown goes through ts_uring_close, which drains.
constexpr int kTransportErrOffset = 4096;

// Block until ``slot`` completes; releases the slot. Returns 0, the
// op's -errno (-ENODATA marks EOF inside the requested read range), or
// -(errno + 4096) for a transport failure (slot NOT released).
int ts_uring_wait_slot(void* handle, int slot) {
  using namespace uring;
  Engine* e = static_cast<Engine*>(handle);
  if (slot < 0 || static_cast<unsigned>(slot) >= e->entries ||
      !e->ops[slot].in_use) {
    return -EINVAL;
  }
  Op* op = &e->ops[slot];
  while (!op->completed) {
    int r = wait_some(e, 1);
    if (r < 0) {
      return r - kTransportErrOffset;
    }
  }
  int err = op->err;
  op->in_use = 0;
  op->completed = 0;
  return err;
}

// Block until every queued op completes; releases all slots. Returns 0,
// the FIRST failed op's -errno, or -(errno + 4096) on a transport
// failure (slots NOT released — ts_uring_close finishes the job).
int ts_uring_drain(void* handle) {
  using namespace uring;
  Engine* e = static_cast<Engine*>(handle);
  while (e->inflight) {
    int r = wait_some(e, e->inflight);
    if (r < 0) return r - kTransportErrOffset;
  }
  int first_err = 0;
  for (unsigned i = 0; i < e->entries; ++i) {
    Op* op = &e->ops[i];
    if (op->in_use) {
      if (first_err == 0 && op->err != 0) first_err = op->err;
      op->in_use = 0;
      op->completed = 0;
    }
  }
  return first_err;
}

}  // extern "C"

#else  // !__linux__

extern "C" {
void* ts_slab_alloc(size_t, int, int* got) {
  if (got) *got = 0;
  return nullptr;
}
void ts_slab_free(void*, size_t) {}
void* ts_uring_init(unsigned) { return nullptr; }
void ts_uring_close(void*) {}
int ts_uring_probe() { return -38; /* ENOSYS */ }
int ts_uring_submit(void*, int, int, void*, uint64_t, uint64_t, unsigned) {
  return -38;
}
int ts_uring_wait_slot(void*, int) { return -38; }
int ts_uring_drain(void*) { return -38; }
}  // extern "C"

#endif  // __linux__
