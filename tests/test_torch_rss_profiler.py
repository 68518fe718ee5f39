"""The port's RSS profiler (``rss_profiler.py``) against the JAX package's.

The port reads RSS from ``/proc/self/statm`` with no psutil; the JAX
package's profiler reads it through psutil, which the CPU tests have (a
GPU host's is not counted on). The two read the same resident size,
sample the same way, and publish ``rss_delta_bytes`` on the bus; a failed
read raises instead of passing a 0 for a measurement.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from torchsnapshot_tpu import rss_profiler as jax_rss
from torchsnapshot_tpu_torch import rss_profiler, telemetry
from torchsnapshot_tpu_torch.rss_profiler import RSSProfiler, measure_rss_deltas


def test_the_resident_size_is_psutils() -> None:
    psutil = pytest.importorskip("psutil")
    before = psutil.Process().memory_info().rss
    mine = rss_profiler.rss_bytes()
    after = psutil.Process().memory_info().rss
    assert min(before, after) - (1 << 20) <= mine <= max(before, after) + (1 << 20)


@pytest.mark.parametrize("mod", [rss_profiler, jax_rss], ids=["port", "jax"])
def test_samples_are_collected_and_the_thread_stops(mod) -> None:
    deltas = []
    with mod.measure_rss_deltas(deltas, interval_s=0.01):
        time.sleep(0.1)
    assert len(deltas) >= 2
    prof = mod.RSSProfiler(interval_s=0.01)
    with prof:
        time.sleep(0.03)
    n = len(prof.rss_deltas)
    time.sleep(0.05)
    assert len(prof.rss_deltas) == n


def test_an_allocation_shows_in_the_peak_as_in_the_jax_package() -> None:
    peaks = []
    for cls in (RSSProfiler, jax_rss.RSSProfiler):
        prof = cls(interval_s=0.01)
        with prof:
            buf = np.ones(64 * 1024 * 1024, dtype=np.uint8)  # touched: 64 MiB
            buf[::4096] += 1
            time.sleep(0.1)
        del buf
        peaks.append(prof.peak_delta_bytes)
    assert all(p > 32 * 1024 * 1024 for p in peaks)
    assert abs(peaks[0] - peaks[1]) < 24 * 1024 * 1024


def test_samples_land_on_the_bus() -> None:
    telemetry.set_enabled(True)
    try:
        telemetry.reset()
        with RSSProfiler(interval_s=0.01):
            time.sleep(0.03)
        assert "rss_delta_bytes" in telemetry.gauges()
    finally:
        telemetry.set_enabled(False)
        telemetry.reset()


@pytest.mark.parametrize("where", ["enter", "sampling"])
def test_a_failed_read_raises(monkeypatch, tmp_path, where) -> None:
    bad = tmp_path / "statm"
    bad.write_text("garbage\n")
    if where == "enter":
        monkeypatch.setattr(rss_profiler, "_STATM", str(bad))
        with pytest.raises(OSError, match="cannot parse"):
            with RSSProfiler(interval_s=0.01):
                pass
        monkeypatch.setattr(rss_profiler, "_STATM", str(tmp_path / "absent"))
        with pytest.raises(OSError):
            measure_rss_deltas([]).__enter__()
        return
    prof = RSSProfiler(interval_s=0.01)
    with pytest.raises(OSError):
        with prof:
            monkeypatch.setattr(rss_profiler, "_STATM", str(bad))
            time.sleep(0.05)
