"""Native I/O engines over ``_native``, and their election.

Counterpart of ``torchsnapshot_tpu/native_io.py``:

- **io_uring engine** (:class:`UringEngine`): the sub-chunk positional
  transfers of a streamed write or read become queued SQEs submitted with
  ``IOSQE_ASYNC``, so kernel workers move chunk N while the pipeline stages
  or checksums chunk N+1, and a stream runs ``queue_depth`` transfers deep
  instead of one.
- **pwrite/preadv fallback** (:class:`PosixEngine`): when io_uring is
  unavailable (an old kernel, seccomp) but O_DIRECT is enabled, plain
  positional syscalls against an O_DIRECT fd still bypass the page cache.
  Without O_DIRECT it adds nothing over the thread-pool path, so it is not
  elected.
- **election** (:func:`elect`, ``IOGovernor.should_native_io``):
  ``TORCHSNAPSHOT_GPU_NATIVE_IO`` ``auto`` (default) defers to the
  governor, which measures the engine like any plugin (the fs plugin
  records its rate under ``<Plugin>.native``); ``always``/``never`` force.
  A missing library, ``ENOSYS`` and permission failures all degrade to the
  Python path; :func:`probe_result` keeps the probe's return code.

Buffer lifetime: the engine references every submitted buffer until its
slot is waited (or the engine drains or closes), so a staging slab, which
returns to the pool only when its last reference dies, is never handed out
again while the kernel may still touch it.

Knobs: ``TORCHSNAPSHOT_GPU_NATIVE_QUEUE_DEPTH`` (SQEs in flight per stream,
default 8), ``TORCHSNAPSHOT_GPU_NATIVE_ALIGN`` (O_DIRECT alignment, default
4096), ``TORCHSNAPSHOT_GPU_NATIVE_ODIRECT`` (``1`` opens the write path
with O_DIRECT where the filesystem allows; default off).
"""

from __future__ import annotations

import logging
import os
import threading
from collections import Counter
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

NATIVE_IO_ENV_VAR = "TORCHSNAPSHOT_GPU_NATIVE_IO"
NATIVE_QD_ENV_VAR = "TORCHSNAPSHOT_GPU_NATIVE_QUEUE_DEPTH"
NATIVE_ALIGN_ENV_VAR = "TORCHSNAPSHOT_GPU_NATIVE_ALIGN"
NATIVE_ODIRECT_ENV_VAR = "TORCHSNAPSHOT_GPU_NATIVE_ODIRECT"

_DEFAULT_QUEUE_DEPTH = 8
_DEFAULT_ALIGN = 4096


def native_io_mode() -> str:
    """The parser for ``TORCHSNAPSHOT_GPU_NATIVE_IO``: ``never`` disables
    the native engine, ``always`` elects it whenever the probe succeeds,
    the default ``auto`` defers to the governor's election."""
    raw = os.environ.get(NATIVE_IO_ENV_VAR, "auto").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "never"
    if raw in ("1", "always", "force", "on"):
        return "always"
    return "auto"


def queue_depth() -> int:
    raw = os.environ.get(NATIVE_QD_ENV_VAR, "").strip()
    if raw:
        try:
            return max(1, min(256, int(raw)))
        except ValueError:
            logger.warning("ignoring non-integer %s=%r", NATIVE_QD_ENV_VAR, raw)
    return _DEFAULT_QUEUE_DEPTH


def alignment() -> int:
    raw = os.environ.get(NATIVE_ALIGN_ENV_VAR, "").strip()
    if raw:
        try:
            val = int(raw)
            if val > 0 and (val & (val - 1)) == 0:
                return val
            logger.warning("%s=%r is not a power of two; using default",
                           NATIVE_ALIGN_ENV_VAR, raw)
        except ValueError:
            logger.warning("ignoring non-integer %s=%r", NATIVE_ALIGN_ENV_VAR, raw)
    return _DEFAULT_ALIGN


def odirect_enabled() -> bool:
    raw = os.environ.get(NATIVE_ODIRECT_ENV_VAR, "0").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


# ------------------------------------------------------------- engines


def _os_error(code: int, what: str) -> OSError:
    err = -code
    return OSError(err, f"{what}: {os.strerror(err)}")


class UringEngine:
    """One io_uring ring driving one stream's sub-chunk transfers.

    Every submitted buffer is referenced by the engine until its slot is
    waited (or the engine drains or closes): a pooled staging slab is never
    recycled while the kernel may still touch it. Not thread-safe: callers
    serialize submit/wait/drain (the fs plugin's awaited executor hops
    do)."""

    kind = "uring"

    def __init__(self, handle: int, depth: int) -> None:
        self._h: Optional[int] = handle
        self.depth = depth
        self._bufs: Dict[int, object] = {}

    @property
    def inflight(self) -> int:
        return len(self._bufs)

    def _submit(self, is_write: bool, fd: int, buf, offset: int) -> int:
        from . import _native

        if hasattr(buf, "numpy"):  # a CPU tensor, e.g. a staging slab
            buf = buf.numpy()
        arr, addr = _native._as_flat_u8(buf, writable_target=not is_write)
        slot = _native.uring_submit(
            self._h, is_write, fd, addr, arr.nbytes, offset
        )
        if slot < 0:
            raise _os_error(slot, "io_uring submit")
        # `arr` views (and therefore pins) the caller's buffer; holding
        # it holds the slab until the kernel is done with it.
        self._bufs[slot] = arr
        return slot

    def submit_pwrite(self, fd: int, buf, offset: int) -> int:
        return self._submit(True, fd, buf, offset)

    def submit_pread(self, fd: int, buf, offset: int) -> int:
        return self._submit(False, fd, buf, offset)

    # The C engine offsets transport-layer errors (io_uring_enter itself
    # failing while ops may still be live in the kernel) by this, so the
    # Python side can tell "the op finished (badly)" from "the op may
    # still be running": for the latter the buffer pin is KEPT — it is
    # released by close(), whose C side drains the ring first.
    _TRANSPORT_ERR_OFFSET = 4096

    def wait(self, slot: int, what: str = "io_uring op") -> None:
        """Block until ``slot`` completes; releases the engine's buffer
        pin. EOF inside a requested read range surfaces as ``EOFError``
        (the taxonomy the buffered fs path and mirror failover speak)."""
        from . import _native

        code = _native.uring_wait_slot(self._h, slot)
        if code <= -self._TRANSPORT_ERR_OFFSET:
            # The op may still be executing: the slab must stay pinned
            # or the pool could recycle it under a live kernel write.
            raise _os_error(
                code + self._TRANSPORT_ERR_OFFSET, f"io_uring wait ({what})"
            )
        self._bufs.pop(slot, None)
        if code == 0:
            return
        if code == -61:  # ENODATA: the C engine's EOF marker
            raise EOFError(f"short read: {what} ended before the requested range")
        raise _os_error(code, what)

    def drain(self) -> None:
        from . import _native

        code = _native.uring_drain(self._h)
        if code <= -self._TRANSPORT_ERR_OFFSET:
            # Slots were not released; pins stay until close() drains.
            raise _os_error(
                code + self._TRANSPORT_ERR_OFFSET, "io_uring drain"
            )
        self._bufs.clear()
        if code != 0:
            raise _os_error(code, "io_uring drain")

    def close(self) -> None:
        from . import _native

        if self._h is not None:
            # ts_uring_close drains outstanding kernel ops before the
            # ring dies, so dropping the buffer pins afterwards is safe.
            _native.uring_close(self._h)
            self._h = None
        self._bufs.clear()

    def __del__(self) -> None:
        # Backstop for an engine abandoned before its stream ran (a read
        # stream never iterated): the ring fd and its three mappings must
        # not leak. Idempotent with close().
        try:
            self.close()
        except Exception:  # noqa: BLE001 - finalizer must never raise
            pass


class PosixEngine:
    """Fallback tier: synchronous pwrite/preadv against (optionally
    O_DIRECT) fds, with the same call surface as :class:`UringEngine`.
    Ops complete at submit time; wait/drain only surface errors."""

    kind = "posix"
    depth = 1

    def __init__(self) -> None:
        self._next = 0

    @property
    def inflight(self) -> int:
        return 0

    def _full_pwrite(self, fd: int, mv: memoryview, offset: int) -> None:
        written = 0
        while written < mv.nbytes:
            written += os.pwrite(fd, mv[written:], offset + written)

    def _full_pread(self, fd: int, buf, offset: int) -> None:
        if hasattr(buf, "numpy"):
            buf = buf.numpy()
        view = memoryview(buf).cast("B")
        got = 0
        while got < view.nbytes:
            n = os.preadv(fd, [view[got:]], offset + got)
            if n == 0:
                raise EOFError(
                    f"short read: fd {fd} yielded {got} of {view.nbytes} "
                    f"bytes (offset {offset})"
                )
            got += n

    def submit_pwrite(self, fd: int, buf, offset: int) -> int:
        if hasattr(buf, "numpy"):
            buf = buf.numpy()
        self._full_pwrite(fd, memoryview(buf).cast("B"), offset)
        self._next += 1
        return self._next - 1

    def submit_pread(self, fd: int, buf, offset: int) -> int:
        self._full_pread(fd, buf, offset)
        self._next += 1
        return self._next - 1

    def wait(self, slot: int, what: str = "") -> None:
        return None

    def drain(self) -> None:
        return None

    def close(self) -> None:
        return None


# ------------------------------------------------------------ probing

# Cached capability probe: "uring" | "posix" | None. One probe per
# process: ENOSYS, EPERM and a missing library all land on None (or
# "posix" when O_DIRECT is enabled) and the Python path takes over, logged
# once. _probe_rc keeps uring_probe's return code (None: not probed).
_probe_lock = threading.Lock()
_probe_done = False
_probe_kind: Optional[str] = None
_probe_rc: Optional[int] = None

# Engines opened in this process, by kind.
opened: "Counter[str]" = Counter()


def engine_kind() -> Optional[str]:
    """The engine this process can open: "uring", "posix" or None."""
    global _probe_done, _probe_kind, _probe_rc
    if _probe_done:
        return _probe_kind
    with _probe_lock:
        if _probe_done:
            return _probe_kind
        kind: Optional[str] = None
        try:
            from . import _native

            if _native.native_available():
                rc = _native.uring_probe()
                _probe_rc = rc
                if rc == 0:
                    kind = "uring"
                else:
                    logger.info(
                        "io_uring unavailable (%s); native I/O %s",
                        os.strerror(-rc) if rc < 0 else rc,
                        "degrades to pwritev/O_DIRECT" if odirect_enabled()
                        else "disabled (Python path)",
                    )
                    # The posix tier only beats the existing thread-pool
                    # path when O_DIRECT is in play; otherwise it is the
                    # same syscalls with extra indirection.
                    kind = "posix" if odirect_enabled() else None
        except Exception as e:  # noqa: BLE001 - probe must never raise
            logger.info("native I/O probe failed (%s); using Python path", e)
            kind = None
        _probe_kind = kind
        _probe_done = True
    return _probe_kind


def probe_result() -> Optional[int]:
    """``uring_probe``'s return code in this process (0: io_uring works,
    else -errno), or None when the library is not built."""
    engine_kind()
    return _probe_rc


def _reset_probe_for_tests() -> None:
    global _probe_done, _probe_kind, _probe_rc
    _probe_done = False
    _probe_kind = None
    _probe_rc = None


def open_engine() -> Optional[object]:
    """A fresh engine for one stream, or None (degrade silently)."""
    kind = engine_kind()
    if kind == "uring":
        from . import _native

        depth = queue_depth()
        handle = _native.uring_init(depth)
        if handle is None:
            return None
        opened["uring"] += 1
        return UringEngine(handle, depth)
    if kind == "posix":
        opened["posix"] += 1
        return PosixEngine()
    return None


# ----------------------------------------------------------- O_DIRECT


def open_for_write(path: str) -> Tuple[int, bool]:
    """Open ``path`` for the native write stream: ``(fd, direct)``.
    O_DIRECT is tried only when enabled, and dropped where the filesystem
    rejects it (tmpfs)."""
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    if odirect_enabled() and hasattr(os, "O_DIRECT"):
        try:
            return os.open(path, flags | os.O_DIRECT, 0o644), True
        except OSError:
            pass
    return os.open(path, flags, 0o644), False


def clear_direct(fd: int) -> None:
    """Drop O_DIRECT from an open fd (the unaligned-tail escape)."""
    import fcntl

    fcntl.fcntl(fd, fcntl.F_SETFL, fcntl.fcntl(fd, fcntl.F_GETFL) & ~os.O_DIRECT)


def io_aligned(mv: memoryview, offset: int) -> bool:
    """True when (address, length, file offset) all satisfy the
    configured O_DIRECT alignment."""
    import numpy as np

    align = alignment()
    if offset % align or mv.nbytes % align:
        return False
    addr = np.frombuffer(mv, np.uint8).ctypes.data if mv.nbytes else 0
    return addr % align == 0


# ----------------------------------------------------------- election

def elect(op: str, plugin_key: str) -> bool:
    """Should this stream use the native engine? ``op`` is "write" or
    "read"; ``plugin_key`` the storage plugin class name."""
    mode = native_io_mode()
    if mode == "never":
        return False
    kind = engine_kind()
    if kind is None:
        return False
    if kind == "posix" and op == "read":
        # The posix tier's only advantage is O_DIRECT, which applies to
        # the write fd alone: for reads it would serialize each pread with
        # consumption and lose the Python path's read-ahead.
        return False
    if mode == "always":
        decision = True
    else:
        from .scheduler import io_governor

        decision = io_governor().should_native_io(plugin_key, op=op)
    logger.debug("native I/O election (%s, %s): mode %s, engine %s, elected %s",
                 op, plugin_key, mode, kind, decision)
    return decision


def maybe_engine(op: str, plugin_key: str) -> Optional[object]:
    """The fs plugin's entry: an engine when elected and openable, else
    None (the caller takes the Python path)."""
    if not elect(op, plugin_key):
        return None
    return open_engine()
