"""RSS memory profiler (rss_profiler.py of the JAX package).

A context manager that samples the process's RSS delta on a background
thread at a fixed interval and records the deltas into a list. Benchmarks
use it to check that the scheduler's per-process memory budget holds
(peak RSS delta <= budget + slack).

RSS is read from ``/proc/self/statm`` (:func:`rss_bytes`, which the
progress reporter's log line reads too), so the port needs no psutil.
Unlike the reporter, which logs 0 when the read fails, the profiler
raises: a peak of 0 must never pass for a measurement.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Generator, List, Optional

from . import telemetry

_DEFAULT_INTERVAL_S = 0.1
_STATM = "/proc/self/statm"


def rss_bytes() -> int:
    """The process's resident set size in bytes. Raises ``OSError`` when
    ``/proc/self/statm`` cannot be read or parsed."""
    try:
        with open(_STATM) as f:
            resident_pages = int(f.read().split()[1])
    except (ValueError, IndexError) as e:
        raise OSError(f"cannot parse {_STATM}: {e}") from e
    return resident_pages * os.sysconf("SC_PAGE_SIZE")


class RSSProfiler:
    """Samples the RSS delta relative to entry on a daemon thread.

    ``rss_deltas`` holds one sample per interval, in bytes. The first
    sample is taken on entry, so short regions still record. A failed
    read raises from ``__enter__``, or from ``__exit__`` when it happened
    on the sampling thread.
    """

    def __init__(self, interval_s: float = _DEFAULT_INTERVAL_S) -> None:
        self.rss_deltas: List[int] = []
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._baseline = 0
        self._error: Optional[BaseException] = None

    def __enter__(self) -> "RSSProfiler":
        self._baseline = rss_bytes()
        self._error = None
        self._stop.clear()
        self._thread = threading.Thread(target=self._sample_loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc: object) -> None:
        self._stop.set()
        assert self._thread is not None
        self._thread.join()
        if self._error is not None:
            raise self._error

    def _sample_loop(self) -> None:
        try:
            while True:
                delta = rss_bytes() - self._baseline
                self.rss_deltas.append(delta)
                # Samples also land on the telemetry bus (a gauge track in
                # the exported trace), beside the pipeline's spans.
                telemetry.gauge_set("rss_delta_bytes", delta)
                if self._stop.wait(self.interval_s):
                    # One final sample, so that a peak between the last tick
                    # and __exit__ is not missed.
                    self.rss_deltas.append(rss_bytes() - self._baseline)
                    return
        except OSError as e:
            self._error = e

    @property
    def peak_delta_bytes(self) -> int:
        return max(self.rss_deltas, default=0)


@contextlib.contextmanager
def measure_rss_deltas(
    rss_deltas: List[int], interval_s: float = _DEFAULT_INTERVAL_S
) -> Generator[None, None, None]:
    """Fill ``rss_deltas`` with RSS-versus-entry samples while the body
    runs (the JAX package's ``measure_rss_deltas``)."""
    profiler = RSSProfiler(interval_s=interval_s)
    try:
        with profiler:
            yield
    finally:
        rss_deltas.extend(profiler.rss_deltas)
