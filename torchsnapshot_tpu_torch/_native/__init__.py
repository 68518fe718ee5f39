"""ctypes loader for the port's host runtime (``native.cpp``).

Counterpart of ``torchsnapshot_tpu/_native/__init__.py``. The source is compiled by ``g++ -O3 -shared -fPIC
-std=c++17 -msse4.2`` at first use into ``build/_ts_native-<hash>.so``
inside the package (the hash covers the source and the flags), through a
temp file and ``os.replace``, so a concurrent loader never maps a
half-written library. Nothing is built at import.

- ``crc32c(data, crc=0)``: CRC32C (SSE4.2 with a 3-way merge, or
  slicing-by-8), chainable;
- ``copy_crc32c(dst, src, crc=0)``: ``dst[:] = src`` and the CRC32C of the
  bytes in one pass over the source;
- ``scatter_copy`` / ``gather_copy``: many memcpys in one call;
- ``slab_alloc`` / ``slab_free`` / ``slab_caps_seen``: page-aligned,
  pre-faulted staging slabs (the staging pool's backing store);
- ``uring_probe`` / ``uring_init`` / ``uring_submit`` / ``uring_wait_slot``
  / ``uring_drain`` / ``uring_close``: int-level passthroughs to the
  io_uring engine (the engine object, with its buffer pins and errno
  mapping, is ``native_io.py``);
- ``native_available()`` / ``has_hw_crc()``.

The plain versions (:func:`crc32c_plain`, :func:`scatter_copy_plain`,
:func:`gather_copy_plain`) compute the same functions in Python; they run
when the library is not built and are the tests' reference.
``TORCHSNAPSHOT_GPU_DISABLE_NATIVE=1`` keeps the library unloaded: the
checksum is then zlib ``crc32:`` and staging uses no slabs. A failed
build is logged at WARNING.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import uuid
from typing import Any, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

DISABLE_NATIVE_ENV_VAR = "TORCHSNAPSHOT_GPU_DISABLE_NATIVE"

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-msse4.2"]

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_load_lock = threading.Lock()


def library_path() -> str:
    """Where the built library lives: ``build/_ts_native-<hash>.so``."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    # tsalint: allow[restricted-context] unreachable from UringEngine.__del__ in practice: an engine only exists after the lib loaded, so _load_attempted is True and _load's fast path returns before the library's path is computed
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"_ts_native-{h.hexdigest()[:12]}.so")


def _build(target: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Unique per thread and process; published atomically.
    tmp = f"{target}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
    try:
        # tsalint: allow[restricted-context] unreachable from UringEngine.__del__ in practice: an engine only exists after the lib loaded, so _load_attempted is True and _load's fast path returns before _build can be reached
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning(
            "building the native host library failed (%s%s); checksums fall back "
            "to zlib crc32 and staging to unpooled buffers",
            e,
            ": " + detail.decode(errors="replace")[-2000:] if detail else "",
        )
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    if _load_attempted:
        return _lib
    # tsalint: allow[restricted-context] safe from UringEngine.__del__: an engine only exists after the lib loaded, so the fast path above already returned; the lock is only ever reachable on true first-touch threads
    with _load_lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    try:
        _lib = _try_load()
    finally:
        # Published after _lib: the unlocked fast path of _load reads
        # _load_attempted first, and must never see it set with a stale
        # _lib of None (which would mix crc32 and crc32c in one take).
        _load_attempted = True
    return _lib


def _try_load() -> Optional[ctypes.CDLL]:
    if os.environ.get(DISABLE_NATIVE_ENV_VAR, "0").strip().lower() not in ("0", "", "false"):
        return None
    target = library_path()
    if not os.path.isfile(target) and not _build(target):
        return None
    try:
        lib = ctypes.CDLL(target)
    except OSError as e:
        logger.warning("loading the native host library %s failed (%s)", target, e)
        return None
    lib.ts_crc32c.restype = ctypes.c_uint32
    lib.ts_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.ts_has_hw_crc.restype = ctypes.c_int
    lib.ts_has_hw_crc.argtypes = []
    lib.ts_scatter_copy.restype = None
    lib.ts_scatter_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
    ]
    lib.ts_gather_copy.restype = None
    lib.ts_gather_copy.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_size_t,
    ]
    lib.ts_copy_crc32c.restype = ctypes.c_uint32
    lib.ts_copy_crc32c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32,
    ]
    lib.ts_slab_alloc.restype = ctypes.c_void_p
    lib.ts_slab_alloc.argtypes = [ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ts_slab_free.restype = None
    lib.ts_slab_free.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ts_uring_init.restype = ctypes.c_void_p
    lib.ts_uring_init.argtypes = [ctypes.c_uint]
    lib.ts_uring_close.restype = None
    lib.ts_uring_close.argtypes = [ctypes.c_void_p]
    lib.ts_uring_probe.restype = ctypes.c_int
    lib.ts_uring_probe.argtypes = []
    lib.ts_uring_submit.restype = ctypes.c_int
    lib.ts_uring_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint,
    ]
    lib.ts_uring_wait_slot.restype = ctypes.c_int
    lib.ts_uring_wait_slot.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ts_uring_drain.restype = ctypes.c_int
    lib.ts_uring_drain.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """True when the library is built and loaded (building it if needed)."""
    return _load() is not None


def has_hw_crc() -> bool:
    """True when the library runs CRC32C on the SSE4.2 instruction."""
    lib = _load()
    return lib is not None and bool(lib.ts_has_hw_crc())


def _as_flat_u8(data, writable_target: bool = False):
    """(numpy u8 view, address) of a contiguous buffer, without a copy.
    A non-contiguous destination is refused: writes into a copy would be
    lost."""
    import numpy as np

    mv = memoryview(data)
    if not mv.contiguous:
        if writable_target:
            raise ValueError("destination buffer must be contiguous")
        mv = memoryview(bytes(mv))
    arr = np.frombuffer(mv, dtype=np.uint8)
    if writable_target and not arr.flags["WRITEABLE"]:
        raise ValueError("destination buffer is read-only")
    return arr, arr.ctypes.data


# ------------------------------------------------------------------ crc32c

_PLAIN_TABLE: Optional[List[int]] = None


def _plain_table() -> List[int]:
    global _PLAIN_TABLE
    if _PLAIN_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _PLAIN_TABLE = table
    return _PLAIN_TABLE


def crc32c_plain(data, crc: int = 0) -> int:
    """CRC32C by the byte-wise table: the reference for :func:`crc32c`."""
    table = _plain_table()
    crc = ~crc & 0xFFFFFFFF
    for b in bytes(memoryview(data).cast("B")):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data`` (any buffer-protocol object).
    Chainable: ``crc32c(b, crc32c(a)) == crc32c(a + b)``."""
    lib = _load()
    if lib is None:
        return crc32c_plain(data, crc)
    arr, addr = _as_flat_u8(data)
    if arr.nbytes == 0:
        return crc
    return lib.ts_crc32c(ctypes.cast(addr, ctypes.c_char_p), arr.nbytes, ctypes.c_uint32(crc))


def copy_crc32c(dst, src, crc: int = 0) -> Optional[int]:
    """``dst[:] = src[:]`` and the CRC32C of the bytes, reading the source
    once; chainable like :func:`crc32c`. Returns None when the library is
    not built (callers copy, then hash). Both buffers are contiguous and
    of one size."""
    lib = _load()
    if lib is None:
        return None
    dst_arr, dst_addr = _as_flat_u8(dst, writable_target=True)
    src_arr, src_addr = _as_flat_u8(src)
    if dst_arr.nbytes != src_arr.nbytes:
        raise ValueError(
            f"copy_crc32c size mismatch: dst={dst_arr.nbytes}B src={src_arr.nbytes}B"
        )
    if src_arr.nbytes == 0:
        return crc
    return lib.ts_copy_crc32c(
        ctypes.c_void_p(dst_addr), ctypes.c_void_p(src_addr), src_arr.nbytes, ctypes.c_uint32(crc)
    )


# ------------------------------------------------------- scatter / gather

Region = Tuple[int, int, int]  # (dst_off, src_off, nbytes)


def scatter_copy_plain(dst, src, regions: Sequence[Region]) -> None:
    dst_mv = memoryview(dst).cast("B")
    src_mv = memoryview(src).cast("B")
    for d, s, n in regions:
        dst_mv[d : d + n] = src_mv[s : s + n]


def scatter_copy(dst, src, regions: Sequence[Region]) -> None:
    """``dst[d:d+n] = src[s:s+n]`` for every region, in one call."""
    lib = _load()
    if lib is None or len(regions) < 4:
        scatter_copy_plain(dst, src, regions)
        return
    n = len(regions)
    dst_arr, dst_addr = _as_flat_u8(dst, writable_target=True)
    src_arr, src_addr = _as_flat_u8(src)
    for d, s, sz in regions:
        if d + sz > dst_arr.nbytes or s + sz > src_arr.nbytes:
            raise ValueError(
                f"scatter_copy region out of bounds: dst[{d}:{d + sz}) src[{s}:{s + sz}) "
                f"for dst={dst_arr.nbytes}B src={src_arr.nbytes}B"
            )
    lib.ts_scatter_copy(
        ctypes.c_void_p(dst_addr), ctypes.c_void_p(src_addr),
        (ctypes.c_uint64 * n)(*(r[0] for r in regions)),
        (ctypes.c_uint64 * n)(*(r[1] for r in regions)),
        (ctypes.c_uint64 * n)(*(r[2] for r in regions)),
        n,
    )


def gather_copy_plain(dst, sources: Sequence[Tuple[int, Any]]) -> None:
    dst_mv = memoryview(dst).cast("B")
    for off, src in sources:
        mv = memoryview(src).cast("B")
        dst_mv[off : off + mv.nbytes] = mv


def gather_copy(dst, sources: Sequence[Tuple[int, Any]]) -> None:
    """Pack separate buffers into ``dst``: for each ``(dst_off, src)``,
    ``dst[dst_off : dst_off + len(src)] = src``, in one call."""
    lib = _load()
    if lib is None or len(sources) < 4:
        gather_copy_plain(dst, sources)
        return
    n = len(sources)
    dst_arr, dst_addr = _as_flat_u8(dst, writable_target=True)
    # Held until the call returns: the addresses point into these.
    srcs = [_as_flat_u8(src) for _, src in sources]
    sizes = [arr.nbytes for arr, _ in srcs]
    for (off, _), sz in zip(sources, sizes):
        if off + sz > dst_arr.nbytes:
            raise ValueError(
                f"gather_copy region out of bounds: dst[{off}:{off + sz}) for dst={dst_arr.nbytes}B"
            )
    lib.ts_gather_copy(
        ctypes.c_void_p(dst_addr),
        (ctypes.c_void_p * n)(*(addr for _, addr in srcs)),
        (ctypes.c_uint64 * n)(*(off for off, _ in sources)),
        (ctypes.c_uint64 * n)(*sizes),
        n,
    )


# ------------------------------------------------------------ slabs

SLAB_HUGETLB = 1
SLAB_MLOCK = 2
SLAB_PREFAULT = 4
SLAB_THP = 8
_SLAB_WANT = SLAB_HUGETLB | SLAB_MLOCK | SLAB_PREFAULT | SLAB_THP

# Union of the capability bits of every slab this process allocated.
_slab_caps_seen = 0


def slab_caps_seen() -> int:
    return _slab_caps_seen


def slab_alloc(nbytes: int) -> Optional[Tuple[int, int]]:
    """A pre-faulted, page-aligned slab: ``(address, capability bits)``,
    or None. The caller owns it and frees it with :func:`slab_free`."""
    global _slab_caps_seen
    lib = _load()
    if lib is None or nbytes <= 0:
        return None
    got = ctypes.c_int(0)
    ptr = lib.ts_slab_alloc(nbytes, _SLAB_WANT, ctypes.byref(got))
    if not ptr:
        return None
    _slab_caps_seen |= got.value
    return int(ptr), got.value


def slab_free(addr: int, nbytes: int) -> None:
    lib = _load()
    if lib is not None and addr:
        lib.ts_slab_free(ctypes.c_void_p(addr), nbytes)


# ------------------------------------------------------------ io_uring

# IOSQE_ASYNC: the kernel runs the op on a worker thread, so the submitting
# thread returns at once.
IOSQE_ASYNC = 0x10


def uring_probe() -> int:
    """0 when an io_uring ring can be set up, else -errno (-1 without the
    library)."""
    lib = _load()
    if lib is None:
        return -1
    return int(lib.ts_uring_probe())


def uring_init(depth: int) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    handle = lib.ts_uring_init(ctypes.c_uint(depth))
    return int(handle) if handle else None


def uring_close(handle: int) -> None:
    lib = _load()
    if lib is not None and handle:
        lib.ts_uring_close(ctypes.c_void_p(handle))


def uring_submit(
    handle: int,
    is_write: bool,
    fd: int,
    addr: int,
    nbytes: int,
    offset: int,
    sqe_flags: int = IOSQE_ASYNC,
) -> int:
    """Queue one positional transfer: its slot (>= 0), or -errno."""
    lib = _load()
    assert lib is not None
    return int(
        lib.ts_uring_submit(
            ctypes.c_void_p(handle), 1 if is_write else 0, fd, ctypes.c_void_p(addr),
            ctypes.c_uint64(nbytes), ctypes.c_uint64(offset), ctypes.c_uint(sqe_flags),
        )
    )


def uring_wait_slot(handle: int, slot: int) -> int:
    lib = _load()
    assert lib is not None
    return int(lib.ts_uring_wait_slot(ctypes.c_void_p(handle), slot))


def uring_drain(handle: int) -> int:
    lib = _load()
    assert lib is not None
    return int(lib.ts_uring_drain(ctypes.c_void_p(handle)))
