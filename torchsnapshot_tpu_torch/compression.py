"""Optional payload compression with entry-recorded codecs.

Counterpart of ``torchsnapshot_tpu/compression.py``; the codec strings,
the compressed bytes and the rules are the JAX package's, so either
package restores the other's compressed snapshots.

Rules (they keep every other part of the checkpoint path unchanged):

- The codec is recorded per entry (``codec: "zstd:3"``): snapshots are
  self-describing, mixed-codec chains restore, and a reader rejects an
  unknown codec with a clear error instead of garbage.
- The integrity checksum covers the stored (compressed) bytes, so
  corruption is detected before decompression.
- The dedup digest and the device fingerprint cover the uncompressed
  bytes, so incremental chains are stable across codec and level changes.
- A payload whose compressed form isn't smaller is stored raw, with no
  codec: enabling compression is never a size regression.
- Payloads under ``MIN_COMPRESS_BYTES`` and byte-ranged payloads (write
  batcher slabs, whose offsets are planned before staging) are never
  compressed.

Codec specs: ``"zstd"`` / ``"zstd:<level>"`` (python-zstandard, level 3 by
default; ``resolve_codec`` raises ValueError where ``zstandard`` does not
import) and ``"zlib"`` / ``"zlib:<level>"`` (stdlib, level 6 by default).
Enable per call (``Snapshot.take(..., compression="zlib")``) or
process-wide with ``TORCHSNAPSHOT_GPU_COMPRESSION``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import zlib
from typing import Optional

COMPRESSION_ENV_VAR = "TORCHSNAPSHOT_GPU_COMPRESSION"

# Payloads below this size aren't worth a codec's framing overhead.
MIN_COMPRESS_BYTES = 4096


class UnknownCodecError(RuntimeError):
    """A snapshot entry records a codec this build cannot decode."""


def _zstd():
    try:
        import zstandard

        return zstandard
    except ImportError:  # pragma: no cover - environment-dependent
        return None


def resolve_codec(spec: Optional[str]) -> Optional[str]:
    """Normalize a user codec spec to its canonical ``name:level`` form.

    ``None``/empty disables compression. Raises ValueError for unknown
    names, non-integer levels, or ``zstd`` without python-zstandard.
    """
    if spec is None:
        return None
    spec = spec.strip().lower()
    if spec in ("", "0", "none", "off", "false"):
        return None
    name, _, level_s = spec.partition(":")
    if name == "zstd":
        zstd = _zstd()
        if zstd is None:
            raise ValueError(
                "compression='zstd' requires the zstandard package; use "
                "'zlib' or install zstandard"
            )
        level = int(level_s) if level_s else 3
        max_level = getattr(zstd, "MAX_COMPRESSION_LEVEL", 22)
        if not 1 <= level <= max_level:
            raise ValueError(f"zstd level must be 1-{max_level}, got {level}")
    elif name == "zlib":
        level = int(level_s) if level_s else 6
        if not 0 <= level <= 9:
            raise ValueError(f"zlib level must be 0-9, got {level}")
    else:
        raise ValueError(
            f"unknown compression codec {name!r} (supported: zstd, zlib)"
        )
    return f"{name}:{level}"


def env_codec() -> Optional[str]:
    """The process-wide default codec from the environment (validated)."""
    return resolve_codec(os.environ.get(COMPRESSION_ENV_VAR))


def compress(codec: str, buf) -> bytes:
    """Compress ``buf`` (bytes-like) under a canonical codec spec.

    The input is passed to the codec via the buffer protocol — no
    intermediate copy: staging buffers are GB-scale and an extra copy
    here would inflate the staging peak outside the scheduler's cost
    accounting."""
    name, _, level_s = codec.partition(":")
    level = int(level_s)
    view = buf if isinstance(buf, memoryview) else memoryview(buf)
    if name == "zstd":
        zstd = _zstd()
        if zstd is None:
            raise UnknownCodecError(
                "zstd compression requested but zstandard is not installed"
            )
        return zstd.ZstdCompressor(level=level).compress(view)
    if name == "zlib":
        return zlib.compress(view, level)
    raise UnknownCodecError(f"unknown compression codec {codec!r}")


def decompress(codec: str, buf, expected_size: Optional[int] = None):
    """Decompress stored bytes; returns a bytes-like of the raw payload.

    ``expected_size`` (when the entry's shape/dtype imply it) is both a
    decompression-bomb bound and an integrity cross-check.
    """
    name, _, _ = codec.partition(":")
    view = buf if isinstance(buf, memoryview) else memoryview(buf)
    if name == "zstd":
        zstd = _zstd()
        if zstd is None:
            raise UnknownCodecError(
                f"snapshot payload is compressed with {codec!r} but "
                "zstandard is not installed on this host"
            )
        if expected_size is not None:
            # Enforce the bomb bound BEFORE decompressing: zstandard's
            # decompress allocates from the frame header's declared
            # content size (max_output_size is ignored when the header
            # carries one), so a corrupt/crafted header could demand a
            # huge allocation. Our compressor always embeds the size.
            params = zstd.get_frame_parameters(view)
            if params.content_size not in (
                expected_size,
                zstd.CONTENTSIZE_UNKNOWN,
            ):
                raise RuntimeError(
                    f"compressed payload declares {params.content_size} "
                    f"bytes, expected {expected_size} ({codec})"
                )
        out = zstd.ZstdDecompressor().decompress(
            view, max_output_size=expected_size or 0
        )
    elif name == "zlib":
        if expected_size is not None:
            # Honor the bomb bound: cap the output at expected_size and
            # require the stream to end exactly there.
            d = zlib.decompressobj()
            out = d.decompress(view, expected_size)
            if d.unconsumed_tail or d.decompress(b"", 1):
                raise RuntimeError(
                    f"decompressed payload exceeds expected "
                    f"{expected_size} bytes (zlib)"
                )
            if d.eof and d.unused_data:
                # Trailing bytes after a complete stream: with checksums
                # disabled nothing else would catch the mutation (the
                # stream itself decompressed to exactly expected_size).
                raise RuntimeError(
                    f"{len(d.unused_data)} trailing bytes after zlib "
                    "stream end; stored payload is corrupt"
                )
        else:
            out = zlib.decompress(view)
    else:
        raise UnknownCodecError(
            f"snapshot payload records unknown codec {codec!r}; upgrade "
            "torchsnapshot_tpu_torch or restore on a build that supports it"
        )
    if expected_size is not None and len(out) != expected_size:
        raise RuntimeError(
            f"decompressed payload is {len(out)} bytes, expected "
            f"{expected_size} ({codec})"
        )
    return out


class StreamingDecompressor:
    """Incremental decompression for a STREAMED consume.

    ``feed`` decodes one stored sub-chunk and returns whatever raw bytes
    it produced (possibly none — codecs buffer internally); ``finish``
    flushes the tail and enforces the same bomb bound and exact-size
    checks as the buffered :func:`decompress`, so streamed and buffered
    consumes of the same stored bytes accept/reject identically.

    Bomb bound: zlib output is capped at ``expected_size`` per feed (one
    byte of probe past the budget, never a chunk of overshoot). zstd has
    no streaming output cap, so when ``expected_size`` is known the
    frame header — buffered across feeds until it parses, since a
    coalesced slab slice can split it — MUST declare exactly that size
    before any byte is decompressed; our compressor always embeds it, so
    only corrupt/foreign frames are rejected (the buffered path bounds
    those via ``max_output_size`` instead)."""

    def __init__(self, codec: str, expected_size: Optional[int] = None) -> None:
        self._codec = codec
        self._expected = expected_size
        self._produced = 0
        self._header = bytearray()  # zstd: stored bytes held until parsed
        self._header_done = False
        name, _, _ = codec.partition(":")
        if name == "zstd":
            zstd = _zstd()
            if zstd is None:
                raise UnknownCodecError(
                    f"snapshot payload is compressed with {codec!r} but "
                    "zstandard is not installed on this host"
                )
            self._zstd = zstd
            self._obj = zstd.ZstdDecompressor().decompressobj()
        elif name == "zlib":
            self._zstd = None
            self._obj = zlib.decompressobj()
        else:
            raise UnknownCodecError(
                f"snapshot payload records unknown codec {codec!r}; upgrade "
                "torchsnapshot_tpu_torch or restore on a build that supports it"
            )

    @staticmethod
    def available(codec: Optional[str]) -> bool:
        """True when ``codec`` can be decoded incrementally on this host
        (consumers gate ``can_stream`` on this — an unavailable codec
        falls back to the buffered path, which raises the same
        UnknownCodecError the user would see either way)."""
        if codec is None:
            return True
        name = codec.partition(":")[0]
        if name == "zlib":
            return True
        if name == "zstd":
            return _zstd() is not None
        return False

    def _check_bound(self) -> None:
        if self._expected is not None and self._produced > self._expected:
            raise RuntimeError(
                f"decompressed payload exceeds expected "
                f"{self._expected} bytes ({self._codec})"
            )

    def feed(self, chunk) -> bytes:
        view = chunk if isinstance(chunk, memoryview) else memoryview(chunk)
        view = view.cast("B")
        if (
            self._zstd is not None
            and self._expected is not None
            and not self._header_done
        ):
            # Hold stored bytes until the frame header parses — nothing
            # is decompressed before the declared size is checked, so a
            # crafted frame can never demand an unbounded allocation.
            self._header += view
            try:
                params = self._zstd.get_frame_parameters(
                    memoryview(self._header)
                )
            except Exception:
                return b""  # header still split across feeds
            if params.content_size != self._expected:
                raise RuntimeError(
                    f"compressed payload declares {params.content_size} "
                    f"bytes, expected {self._expected} ({self._codec})"
                )
            self._header_done = True
            view = memoryview(bytes(self._header))
            self._header = bytearray()
        if self._zstd is None and self._expected is not None:
            # Cap zlib output at one byte past the remaining budget: an
            # overshooting stream is rejected without ever allocating
            # beyond it.
            out = self._obj.decompress(view, self._expected - self._produced + 1)
        else:
            out = self._obj.decompress(view)
        self._produced += len(out)
        self._check_bound()
        return out

    def finish(self) -> bytes:
        if self._zstd is None:
            if self._expected is not None:
                # Mirror the buffered bound checks: capped feeds leave any
                # overshoot as unconsumed input, and a probe decompress
                # surfaces withheld output — flush() is never called here
                # because it would decode past the bound uncapped.
                if self._obj.unconsumed_tail or self._obj.decompress(b"", 1):
                    raise RuntimeError(
                        f"decompressed payload exceeds expected "
                        f"{self._expected} bytes ({self._codec})"
                    )
                if self._obj.eof and self._obj.unused_data:
                    raise RuntimeError(
                        f"{len(self._obj.unused_data)} trailing bytes after "
                        "zlib stream end; stored payload is corrupt"
                    )
                tail = b""
            else:
                tail = self._obj.flush()
                self._produced += len(tail)
        else:
            tail = self._obj.flush()
            self._produced += len(tail)
            self._check_bound()
        if self._expected is not None and self._produced != self._expected:
            raise RuntimeError(
                f"decompressed payload is {self._produced} bytes, expected "
                f"{self._expected} ({self._codec})"
            )
        return tail


# Stagers capture the active codec when they are planned (as they capture
# the dedup context, dedup.dedup_staging).
_active_codec: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "tsnap_gpu_active_codec", default=None
)


def active_codec() -> Optional[str]:
    return _active_codec.get()


@contextlib.contextmanager
def compression_staging(codec: Optional[str]):
    token = _active_codec.set(codec)
    try:
        yield
    finally:
        _active_codec.reset(token)
