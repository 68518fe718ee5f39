"""How ``correct`` is decided: the numbers compared and their limits.

A training step is compared with the plain reference over the first
``COMPARE_STEPS`` steps of the run, which go through the window's own call
and feed:

- ``loss_gap``: the largest relative gap between the program's loss and
  the reference's, over the three steps;
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over ``1 - b1``), by the worst leaf: the gap
  between the program's norm of that leaf and the reference's, over the
  reference's norm of the leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same of each leaf's change after the three steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf under that moves under Adam by rounding alone).

The limits of these three are the configuration's, in
``limits/<config>.json``, set from the program's readings on a dozen seeds
and the float8 control's (see ``calibrate.py``) at ``COMPARE_STEPS``
steps, which is why that count lives here and not in a traffic file. The
exact checks have the limit 0: losses that are not finite, operations
that failed, and restored bytes that differ from the state the benchmark
held at the take.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

import torch

# The steps the reference follows; the limits were set at this count.
COMPARE_STEPS = 3
# A leaf whose reference gradient is under this share of the median
# leaf's is left out of the change comparison.
STILL_LEAF_SHARE = 1e-3
STEP_NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def norm(t: torch.Tensor) -> float:
    """The L2 norm of ``t``, accumulated in float64."""
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def step_numbers(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], int]:
    """The three step numbers of ``prog`` against ``ref`` (each as
    the configuration's ``follow`` returns it), and how many leaves the
    change comparison left out."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True))
    grads = ref["grad_norms"]
    if set(prog["grad_norms"]) != set(grads) or set(prog["change_norms"]) != set(grads):
        raise ValueError("the program's leaves are not the reference's")
    grad_gap = _worst_leaf(prog["grad_norms"], grads, list(grads))
    floor = STILL_LEAF_SHARE * statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= floor]
    change_gap = _worst_leaf(prog["change_norms"], ref["change_norms"], moved)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    return numbers, len(grads) - len(moved)


def checks(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
           ) -> Dict[str, Dict[str, float]]:
    """Each number compared, beside its limit. A number absent from
    ``limits`` is exact (limit 0); one whose limit is null is not compared
    (no control or fault reads far enough above the program's readings to
    set one; PERF.md gives its readings)."""
    return {k: {"value": v, "limit": limits.get(k, 0)} for k, v in numbers.items()
            if limits.get(k, 0) is not None}


def passed(table: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in table.values())
