"""The device trace of a run's traced segment, reduced.

The segment runs under ``torch.profiler`` (CPU and CUDA activity) inside
one ``portbench.segment`` annotation that ends after a synchronise, and
the harness labels what the host does in it (``portbench.step``,
``portbench.take`` and so on). From the exported trace this module takes:

- ``window_s``: the segment annotation's length;
- ``busy_s``: the union of every kernel, copy and memset interval on any
  stream, inside the window;
- ``kernels``: launches and device seconds by kernel name;
- ``idle_gaps``: the device's idle time inside the window, by the host
  label over the middle of each gap (the labels do not nest).
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LABEL_PREFIX = "portbench."
SEGMENT = LABEL_PREFIX + "segment"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _label_at(labels: List[Tuple[float, float, str]], starts: List[float], t: float) -> str:
    """The label over time ``t``; ``labels`` do not overlap and are sorted,
    ``starts`` their starts."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= labels[i][1]:
        return labels[i][2][len(LABEL_PREFIX):]
    return "unlabelled"


def reduce(events: List[Dict]) -> Dict:
    """Reduce chrome-trace ``events`` (µs timestamps) to seconds."""
    segs = [e for e in events if e.get("ph") == "X" and e.get("name") == SEGMENT
            and e.get("cat") == "user_annotation"]
    if len(segs) != 1:
        raise ValueError(f"expected one {SEGMENT} annotation, found {len(segs)}")
    lo, hi = segs[0]["ts"], segs[0]["ts"] + segs[0]["dur"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, List[float]] = {}
    spans = []
    for e in device:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        spans.append((a, b))
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += e["dur"] * 1e-6
    busy = _union(spans)
    labels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(LABEL_PREFIX) and e["name"] != SEGMENT)
    starts = [a for a, _, _ in labels]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = _label_at(labels, starts, (a + b) / 2)
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": kernels,
        "idle_gaps": gaps,
    }


def load(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def breakdown(reduced: Dict, top: int = 10) -> Dict:
    """The ``breakdown`` of a traced result line: the device operations
    that took most time and the longest idle gaps, by what the host was
    doing."""
    ops = sorted(((n, s) for n, (_, s) in reduced["kernels"].items()), key=lambda x: -x[1])
    gaps = sorted(reduced["idle_gaps"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:200], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
