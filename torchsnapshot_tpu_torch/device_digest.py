"""Device fingerprints of tensors for incremental change detection.

Counterpart of ``torchsnapshot_tpu/device_digest.py``. The host dedup path
(``dedup.py``) pays the device-to-host copy and a SHA-256 pass before it can
see that a payload is unchanged. This module computes a 128-bit
position-dependent integer fingerprint of a tensor on the device and
fetches only its 16 bytes. When it equals the fingerprint the base snapshot
recorded for the same storage location, staging skips the copy and the
storage write; on restore, a destination that already holds the content
skips the read and the host-to-device copy.

The fingerprint is the JAX package's, bit for bit: the digest strings go
into manifests that both packages read. Four lanes; lane ``s`` is the sum,
wrapping at 2^32, of ``mix32(word ^ mix32(w * GOLDEN + SEEDS[s]))`` over
the tensor's uint32 word stream (1- and 2-byte elements and bool
zero-extended, 8-byte elements two words, low word first), ``w`` the
word's index; the byte length is folded in on the host (:func:`_fold_lanes`).

- A CUDA tensor goes through kernel K4, ``csrc/digest.cu``, on the current
  stream (:func:`fingerprint_lanes`; the launches of its full form are
  counted in ``fingerprint_lanes.launches``, those of its partial form in
  ``fingerprint_lanes.partial_launches``). It launches or raises.
- A CPU tensor goes through the plain version (:func:`lanes_reference`),
  int64 arithmetic masked to 32 bits: the counterpart of a JAX array on the
  CPU backend, which the JAX package fingerprints too.
- Anything else (numpy arrays, objects) and dtypes without a clean word
  stream (complex, the sub-byte integers) give None, as the JAX package's
  ``TypeError``/``ValueError`` cases do.

Trust model: not cryptographic. Four independently seeded lanes give about
2^-128 collision odds for random changes, ample for "did training change
this weight", but an adversary could build a collision. Device digests are
opt-in: ``device_digests=True`` or ``TORCHSNAPSHOT_GPU_DEVICE_DIGESTS=1``.

:func:`probe_hash_throughput` fingerprints one 16 MiB buffer twice (K4 on
the card) and records the rate as the I/O governor's hash rate, which the
restore-side preverify gate weighs against the read rate.

:func:`fingerprint_any` (and :func:`fingerprint_all`, its batched form) is
the delta journal's dirty detector over any state leaf: a CUDA tensor
through K4, a CPU tensor through K4's plain version, a numpy array by the
SHA-256 of its bytes, anything else by the SHA-256 of its pickle. The
digests live in memory only and are never persisted.
"""

from __future__ import annotations

import array
import ctypes
import os
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .serialization import DTYPE_TO_STRING

PREFIX = "xxh4x32"  # fingerprint scheme tag recorded in manifests
ENV_VAR = "TORCHSNAPSHOT_GPU_DEVICE_DIGESTS"

# lowbias32 finalizer constants and the four lane seeds.
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SEEDS = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)
_MASK = 0xFFFFFFFF

# Words per plain-version step: bounds the int64 temporaries on the CPU.
_REFERENCE_BLOCK_WORDS = 1 << 20


def enabled_by_env() -> bool:
    # The JAX package's falsy spellings: an explicit "false" must never turn
    # the opt-in trust model on.
    return os.environ.get(ENV_VAR, "0") not in ("0", "", "false")


def _mix32(x: int) -> int:
    """lowbias32 on a Python int in [0, 2^32)."""
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 15
    x = (x * _M2) & _MASK
    x ^= x >> 16
    return x


# --------------------------------------------------------- the word stream


def _word_bytes(dtype: torch.dtype) -> Optional[int]:
    """Bytes each element contributes as words, or None for a dtype with no
    clean word stream (complex, sub-byte integers, dtypes the snapshot
    format does not know)."""
    if dtype not in DTYPE_TO_STRING or dtype.is_complex:
        return None
    if DTYPE_TO_STRING[dtype] in ("int4", "uint4", "int2", "uint2"):
        return None
    size = dtype.itemsize
    return size if size in (1, 2, 4, 8) else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _words_reference(t: torch.Tensor) -> torch.Tensor:
    """The word stream of a tensor as int64 values in [0, 2^32)."""
    flat = t.detach().contiguous().reshape(-1)
    size = t.element_size()
    if size == 1:
        return flat.view(torch.uint8).to(torch.int64)
    if size == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    # 4 bytes: one word; 8 bytes: two words, low first (little-endian host).
    return flat.view(torch.int32).to(torch.int64) & _MASK


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m`` modulo 2^32 for int64 ``x`` in [0, 2^32), without int64
    overflow: the high half of ``x`` only reaches the result through the low
    16 bits of ``m``."""
    lo = (x & 0xFFFF) * m
    hi = (((x >> 16) * (m & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _piece_strides(shape: Sequence[int]) -> List[int]:
    strides, acc = [], 1
    for dim in reversed(tuple(shape)):
        strides.append(acc)
        acc *= int(dim)
    return list(reversed(strides))


def _word_index_reference(
    shape: Sequence[int],
    offsets: Sequence[int],
    strides: Sequence[int],
    wpe: int,
    device: torch.device,
) -> torch.Tensor:
    """Each word's index in the piece's word stream (int64 in [0, 2^32)),
    for a region of ``shape`` at ``offsets`` in a piece of row-major element
    ``strides``: uint32 arithmetic, as ``_partial_jit`` does it."""
    e = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    for d, (n, off, st) in enumerate(zip(shape, offsets, strides)):
        idx = (torch.arange(int(n), dtype=torch.int64, device=device) + int(off)) & _MASK
        view = [1] * len(shape)
        view[d] = int(n)
        e = (e + _mul32(idx, int(st) & _MASK).reshape(view)) & _MASK
    e = e.reshape(-1)
    if wpe == 1:
        return e
    j = torch.arange(wpe, dtype=torch.int64, device=device)
    return ((_mul32(e, wpe)[:, None] + j) & _MASK).reshape(-1)


def lanes_reference(
    t: torch.Tensor,
    offsets: Optional[Sequence[int]] = None,
    piece_shape: Optional[Sequence[int]] = None,
) -> Tuple[int, int, int, int]:
    """The plain version of K4: the four lanes of ``t``, or, with
    ``offsets`` and ``piece_shape``, of ``t`` as the region at ``offsets`` of
    a piece of that shape. Plain tensor arithmetic on ``t``'s device (the
    CPU path uses it; on the card it is what K4 is held against). Raises
    ``TypeError`` for a dtype with no word stream."""
    if _word_bytes(t.dtype) is None:
        raise TypeError(f"no uint32 word stream for dtype {t.dtype}")
    words = _words_reference(t)
    wpe = 2 if t.element_size() == 8 else 1
    if offsets is None:
        index = None
    else:
        index = _word_index_reference(
            t.shape, offsets, _piece_strides(piece_shape), wpe, t.device
        )
    lanes = [0, 0, 0, 0]
    for lo in range(0, words.numel(), _REFERENCE_BLOCK_WORDS):
        hi = min(lo + _REFERENCE_BLOCK_WORDS, words.numel())
        if index is None:
            w = torch.arange(lo, hi, dtype=torch.int64, device=t.device) & _MASK
        else:
            w = index[lo:hi]
        wg = _mul32(w, _GOLDEN)
        block = words[lo:hi]
        for s, seed in enumerate(_SEEDS):
            tag = _mix32_t((wg + seed) & _MASK)
            lanes[s] = (lanes[s] + int(_mix32_t(block ^ tag).sum())) & _MASK
    return tuple(lanes)


# ------------------------------------------------ a region as runs


class Runs(NamedTuple):
    """A region of a piece as runs: stretches of ``run`` elements that are
    contiguous both in the piece's element index and in the region's
    memory. ``base`` is the piece index of the region's first element
    (uint32); ``outer`` lists the dims that index the runs, outermost
    first, as ``(count, piece stride mod 2^32, memory stride in
    elements)``. Run ``(i_0, ..., i_k)`` starts at piece index ``base +
    sum i_d * piece_stride_d`` (mod 2^32) and at memory offset ``sum i_d *
    memory_stride_d``; within it both advance by one an element."""

    run: int
    base: int
    outer: Tuple[Tuple[int, int, int], ...]


def region_runs(
    shape: Sequence[int],
    offsets: Sequence[int],
    piece_shape: Sequence[int],
    strides: Sequence[int],
) -> Runs:
    """Reduce a region of ``shape`` at ``offsets`` in a piece of
    ``piece_shape``, held in memory with element ``strides``, to runs
    (:class:`Runs`): size-1 dims are dropped, and each inner dim is merged
    into the one outside it while the outer dim's piece stride and memory
    stride are both the inner dim's extent times the inner dim's. The
    innermost merged dim is the run when its piece and memory strides are
    both 1, else runs are single elements. Pure: no tensor is touched."""
    pstrides = _piece_strides(piece_shape)
    base = sum(int(o) * ps for o, ps in zip(offsets, pstrides)) & _MASK
    if any(int(n) == 0 for n in shape):
        return Runs(0, base, ())
    merged: List[List[int]] = []  # [extent, piece stride, memory stride], innermost first
    for n, ps, ms in reversed(list(zip(shape, pstrides, strides))):
        n, ms = int(n), int(ms)
        if n == 1:
            continue
        if merged and ps == merged[-1][0] * merged[-1][1] and ms == merged[-1][0] * merged[-1][2]:
            merged[-1][0] *= n
        else:
            merged.append([n, ps, ms])
    run = 1
    if merged and merged[0][1] == 1 and merged[0][2] == 1:
        run = merged.pop(0)[0]
    return Runs(run, base, tuple((n, ps & _MASK, ms) for n, ps, ms in reversed(merged)))


def _fast_divisor(d: int) -> Tuple[int, int, int]:
    """``(d, m, s)`` for the kernel's division without a divide
    instruction (``csrc/digest.cu``, ``div_rem``): for every 64-bit ``n``,
    ``n // d == (t + ((n - t) >> 1)) >> s`` with ``t = (n * m) >> 64``
    (Hacker's Delight's round-down method with a 65-bit magic, its top bit
    implied). ``d == 1`` gives ``(1, 0, 0)``, which the kernel passes
    through."""
    if d < 1 or d >= 1 << 64:
        raise ValueError(f"divisor {d} out of range")
    if d == 1:
        return 1, 0, 0
    l = (d - 1).bit_length()  # ceil(log2 d)
    return d, ((1 << 64) * ((1 << l) - d)) // d + 1, l - 1


# Runs of at least this many bytes are walked by warps, in tiles of
# _TILE_BYTES of 16-byte vectors; shorter runs by a flat walk over the
# elements (csrc/digest.cu, "Partial form").
_LONG_RUN_BYTES = 512
_TILE_BYTES = 4096
_MAX_OUTER = 8
_RUNS_WORDS = 8 + 5 * _MAX_OUTER


def _runs_words(runs: Runs, elem_bytes: int) -> List[int]:
    """The kernel's parameters for ``runs`` of ``elem_bytes``-byte
    elements, as the 64-bit words ``digest_lanes`` takes (its comment gives
    the layout): the mapping (warps on tiles of long runs, or the flat
    walk), the item count, and every divisor with its magic."""
    if len(runs.outer) > _MAX_OUTER:
        raise ValueError(f"a region of more than {_MAX_OUTER} outer dims: {runs}")
    n_runs = 1
    for count, _, _ in runs.outer:
        n_runs *= count
    if runs.run * elem_bytes >= _LONG_RUN_BYTES:
        tiles_a_run = -(-runs.run * elem_bytes // _TILE_BYTES)
        head = [runs.run, n_runs * tiles_a_run, runs.base, len(runs.outer), _TILE_BYTES // 16,
                *_fast_divisor(tiles_a_run)]
    else:
        head = [runs.run, n_runs * runs.run, runs.base, len(runs.outer), 0,
                *_fast_divisor(max(runs.run, 1))]
    words = head
    for count, pstride, mstride in reversed(runs.outer):
        words += [*_fast_divisor(count), pstride, mstride]
    return words + [0] * (_RUNS_WORDS - len(words))


# ---------------------------------------------------------------- kernel K4

_MAX_DIMS = 8
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    """``csrc/digest.cu``'s library, built at first use, typed."""
    from .ops import _build

    lib = _build.load("digest")
    if not getattr(lib, "_typed", False):
        lib.digest_lanes.argtypes = [_P, ctypes.c_ulonglong, ctypes.c_int, _P, _P, _P]
        lib.digest_lanes.restype = ctypes.c_int
        lib.digest_error_string.argtypes = [ctypes.c_int]
        lib.digest_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def fingerprint_lanes(
    t: torch.Tensor,
    offsets: Optional[Sequence[int]] = None,
    piece_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Launch K4 on a CUDA tensor, on the current stream: a 16-byte int32
    device tensor holding the four lanes (as uint32 bits) of ``t``, or, with
    ``offsets`` and ``piece_shape``, of ``t`` as a region of that piece.
    The full form makes a non-contiguous ``t`` contiguous first (a device
    copy). The partial form reads ``t`` in place through its strides, with
    no copy: a view whose innermost stride is 1 as runs of 16-byte loads
    (:func:`region_runs`), any other view element by element. Raises on a
    dtype with no word stream and on a failed launch."""
    if t.device.type != "cuda":
        raise ValueError(f"fingerprint_lanes takes a CUDA tensor, got {t.device}")
    size = _word_bytes(t.dtype)
    if size is None:
        raise TypeError(f"fingerprint_lanes: no uint32 word stream for dtype {t.dtype}")
    t = t.detach()
    lib = _lib()
    params = None  # the partial form's runs (``_runs_words``), alive through the call
    if offsets is None:
        if not t.is_contiguous():
            t = t.contiguous()
    else:
        if len(offsets) != t.dim() or len(piece_shape) != t.dim() or t.dim() > _MAX_DIMS:
            raise ValueError(
                f"fingerprint_lanes: offsets {tuple(offsets)} and piece shape "
                f"{tuple(piece_shape)} must have the region's {t.dim()} (<= {_MAX_DIMS}) dims"
            )
        runs = region_runs(t.shape, offsets, piece_shape, t.stride())
        params = array.array("Q", _runs_words(runs, size))
    with torch.cuda.device(t.device):
        out = torch.zeros(4, dtype=torch.int32, device=t.device)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        runs_ptr = None if params is None else params.buffer_info()[0]
        err = lib.digest_lanes(t.data_ptr(), t.numel(), size, runs_ptr, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"digest_lanes kernel launch failed: {lib.digest_error_string(err).decode()} "
            f"(shape {tuple(t.shape)}, dtype {t.dtype})"
        )
    if offsets is None:
        fingerprint_lanes.launches += 1  # digest_full_kernel
    else:
        fingerprint_lanes.partial_launches += 1  # digest_partial_kernel
    return out


fingerprint_lanes.launches = 0
fingerprint_lanes.partial_launches = 0


# ------------------------------------------------------- dispatch / fetch


def _dispatch(t, offsets=None, piece_shape=None) -> Optional[torch.Tensor]:
    """Kick the fingerprint computation of ``t`` without waiting: K4's
    in-flight lanes for a CUDA tensor, the plain version's lanes for a CPU
    tensor, or None when ``t`` cannot be fingerprinted."""
    if not isinstance(t, torch.Tensor) or _word_bytes(t.dtype) is None:
        return None
    if t.device.type == "cuda":
        return fingerprint_lanes(t, offsets, piece_shape)
    if t.device.type != "cpu":
        return None
    lanes = lanes_reference(t, offsets, piece_shape)
    return torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in lanes], dtype=torch.int32)


def _fetch(pendings: Sequence[torch.Tensor]) -> List[Tuple[int, int, int, int]]:
    """The lanes of every dispatched computation, with ONE 16-byte-per-item
    device-to-host copy per device: stacked on the device, copied into
    pinned memory on the current stream, and read after that copy's CUDA
    event has fired."""
    out: List[Optional[Tuple[int, int, int, int]]] = [None] * len(pendings)
    by_device = {}
    for i, p in enumerate(pendings):
        by_device.setdefault(p.device, []).append(i)
    for device, idx in by_device.items():
        stacked = torch.stack([pendings[i] for i in idx])
        if device.type == "cuda":
            host = torch.empty(stacked.shape, dtype=torch.int32, pin_memory=True)
            with torch.cuda.device(device):
                host.copy_(stacked, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            event.synchronize()
        else:
            host = stacked
        for row, i in zip(host.tolist(), idx):
            out[i] = tuple(v & _MASK for v in row)
    return out


def _fold_lanes(lanes: Iterable[int], nbytes: int) -> str:
    """Fold the byte length into the four summed lanes and format the
    digest. The one definition of the final fold: device_fingerprint and
    combine_partials must agree bit for bit."""
    final = [
        (int(lane) & _MASK) ^ _mix32((nbytes & _MASK) ^ seed)
        for lane, seed in zip(lanes, _SEEDS)
    ]
    return PREFIX + ":" + "".join(f"{v:08x}" for v in final)


def _finalize(t: torch.Tensor, pending: torch.Tensor) -> str:
    """Fetch a dispatched fingerprint of ``t`` and fold in its length."""
    return _fold_lanes(_fetch([pending])[0], _nbytes(t))


def device_fingerprint(t) -> Optional[str]:
    """128-bit fingerprint of a tensor's content, ``"xxh4x32:<32 hex>"``:
    computed by K4 on a CUDA tensor (only 16 bytes cross to the host), by
    the plain version on a CPU tensor. None when ``t`` cannot be
    fingerprinted (not a tensor, a dtype with no word stream): callers fall
    back to the host SHA-256 path."""
    pending = _dispatch(t)
    if pending is None:
        return None
    return _finalize(t, pending)


# ------------------------------------------------- any state leaf


def fingerprint_all(values: Sequence) -> List[Tuple[str, str]]:
    """``(fingerprint, kind)`` of every state leaf, ``kind`` being
    ``"array"`` or ``"object"`` (device_digest.py:348-376 of the JAX
    package, over a list). Every tensor's computation is dispatched before
    one fetch of all their lanes, so a state of many CUDA leaves pays one
    device-to-host sync, not one a leaf. A CUDA tensor goes through K4
    (which launches or raises), a CPU tensor through its plain version; a
    tensor whose dtype has no word stream, and a numpy array, hash their
    bytes with SHA-256; anything else hashes its pickle. A DTensor raises:
    the journal has no form for a sharded leaf."""
    import hashlib

    import numpy as np

    from .io_preparers.prepare import is_dtensor
    from .serialization import object_as_bytes

    out: List[Optional[Tuple[str, str]]] = [None] * len(values)
    pending_idx, pendings = [], []
    for i, value in enumerate(values):
        if is_dtensor(value):
            raise NotImplementedError(
                "fingerprinting a DTensor leaf for the delta journal is not supported "
                "by torchsnapshot_tpu_torch (the journal records whole leaves)"
            )
        pending = _dispatch(value)
        if pending is not None:
            pending_idx.append(i)
            pendings.append(pending)
            continue
        if isinstance(value, torch.Tensor):
            data = value.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
        elif isinstance(value, np.ndarray):
            data = np.ascontiguousarray(value).reshape(-1).view(np.uint8)
        else:
            out[i] = ("sha256:" + hashlib.sha256(object_as_bytes(value)).hexdigest(), "object")
            continue
        out[i] = ("sha256:" + hashlib.sha256(memoryview(data)).hexdigest(), "array")
    if pendings:
        for i, lanes in zip(pending_idx, _fetch(pendings)):
            out[i] = (_fold_lanes(lanes, _nbytes(values[i])), "array")
    return out


def fingerprint_any(value) -> Tuple[str, str]:
    """``(fingerprint, kind)`` of one state leaf (:func:`fingerprint_all`)."""
    return fingerprint_all([value])[0]


# ------------------------------------------------------- partial lanes
#
# The lanes are commutative uint32 sums over position-tagged words, so a
# piece's fingerprint is additive over any disjoint cover of its word
# stream: fingerprint(piece) = fold(sum of the regions' lanes), each region
# tagged with its words' absolute indices in the piece.


def partial_dispatch(region, piece_shape, region_offsets) -> Optional[torch.Tensor]:
    """Kick the partial-lanes computation of ``region``, located at
    ``region_offsets`` in a piece of shape ``piece_shape``. Returns the
    in-flight lanes, or None when the region cannot be fingerprinted."""
    return _dispatch(region, tuple(region_offsets), tuple(piece_shape))


def partial_fetch(pending: torch.Tensor) -> Tuple[int, int, int, int]:
    """Fetch a dispatched partial's 16 bytes (four uint32 lanes)."""
    return _fetch([pending])[0]


def combine_partials(lane_groups, nbytes: int) -> str:
    """Wrapping sum of partial lanes covering a whole piece, with the
    piece's byte length folded in: the piece's ``device_fingerprint``."""
    total = [0, 0, 0, 0]
    for lanes in lane_groups:
        total = [(a + int(b)) & _MASK for a, b in zip(total, lanes)]
    return _fold_lanes(total, nbytes)


# ------------------------------------------------- windowed verification

# Restore-side verification window: at most MATCH_WINDOW slices AND
# MATCH_WINDOW_BYTES of slice data in flight per batch. The count bound
# amortizes the device round trip; the byte bound limits transient device
# memory.
MATCH_WINDOW = 4
MATCH_WINDOW_BYTES = 512 * 1024 * 1024


def fingerprints_match(
    items, window: int = MATCH_WINDOW, window_bytes: int = MATCH_WINDOW_BYTES
) -> bool:
    """Bounded-memory fingerprint comparison for restore-side skips.

    ``items`` yields ``(nbytes, get_slice, expected)`` or ``(nbytes,
    get_slice, expected, cost_bytes)``: the slice's byte size (known from
    the manifest, without touching the device), a thunk producing the
    slice, the recorded digest, and the slice's transient device footprint
    when it exceeds ``nbytes``. A window of slices is dispatched together,
    then its lanes come back in one fetch; the slice references are dropped
    before the next window materializes. A window closes at ``window``
    slices, or before the slice that would push it past ``window_bytes`` of
    cost (one over-budget slice still goes alone). The budget check runs
    before ``get_slice``, so nothing is materialized twice. Returns False
    on the first mismatch or unfingerprintable slice; later windows are
    never materialized."""
    if window < 1 or window_bytes < 1:
        # An empty first window would return True with no verification.
        raise ValueError(
            f"window and window_bytes must be >= 1, got {window}/{window_bytes}"
        )
    it = iter(items)
    carried = None  # the item that overflowed the previous window's budget
    while True:
        pendings, sizes, expected_fps = [], [], []
        batch_bytes = 0
        while len(pendings) < window and batch_bytes < window_bytes:
            if carried is not None:
                item, carried = carried, None
            else:
                try:
                    item = next(it)
                except StopIteration:
                    break
            nbytes, get_slice, expected = item[0], item[1], item[2]
            cost = item[3] if len(item) > 3 else nbytes
            if pendings and batch_bytes + cost > window_bytes:
                carried = item  # nothing materialized for it yet
                break
            piece = get_slice()
            pending = _dispatch(piece)
            if pending is None:
                return False
            pendings.append(pending)
            sizes.append(nbytes)
            expected_fps.append(expected)
            batch_bytes += cost
            del piece
        if not pendings:
            return True
        for lanes, nbytes, expected in zip(_fetch(pendings), sizes, expected_fps):
            if _fold_lanes(lanes, nbytes) != expected:
                return False


# ------------------------------------------------------ hash-rate probe

_HASH_PROBE_BYTES = 16 << 20
_hash_probe_done = False


def probe_hash_throughput(device: Optional[str] = None) -> Optional[float]:
    """The device fingerprint rate, once a process, recorded into the I/O
    governor (device_digest.py:293-330 of the JAX package): one
    ``_HASH_PROBE_BYTES`` int32 buffer on ``device`` (default: the current
    CUDA device when there is one, else the CPU and the plain version) is
    fingerprinted twice, the first pass untimed (it builds and loads K4),
    the second timed from dispatch to fetch. Returns the governor's hash
    rate in bytes/s, or None when nothing could be fingerprinted (the
    preverify gate then keeps verifying). Later calls return the recorded
    rate without probing."""
    global _hash_probe_done
    from . import telemetry
    from .scheduler import _feed_governor_rates, io_governor

    if _hash_probe_done:
        return io_governor().hash_bps()
    _hash_probe_done = True
    try:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        buf = torch.zeros(_HASH_PROBE_BYTES // 4, dtype=torch.int32, device=device)
        pending = _dispatch(buf)
        if pending is None:
            return None
        _fetch([pending])
        t0 = telemetry.monotonic()
        _fetch([_dispatch(buf)])
        _feed_governor_rates("hash", None, _HASH_PROBE_BYTES, telemetry.monotonic() - t0)
        return io_governor().hash_bps()
    except Exception:  # noqa: BLE001 - the probe never breaks a restore
        return None
