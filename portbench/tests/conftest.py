"""Shared pieces of the benchmark's CPU tests: the checkout on the path,
and each cell of BENCHMARK.json cut to a size the CPU runs in seconds."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_PORT = {"vocab_size": 96, "d_model": 32, "n_heads": 2, "n_layers": 2, "d_ff": 64,
             "max_seq_len": 16}
TINY_TRAFFIC = {"batch": 4, "seq_len": 16, "trace_steps": 6, "reference_rows": 2}
# The tiny model's own limits, from its CPU readings (3 seeds: loss 2.6e-4,
# grad 3.0e-3, change 1.7e-3 at the worst), not the configurations'.
TINY_LIMITS = {"loss_gap": 2e-3, "grad_gap": 2e-2, "change_gap": 2e-2}


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_cell(bench):
    """``tiny_cell(name, **traffic)``: the cell with the tiny model and
    batch, its checkpoint cadence and resumes kept."""
    from portbench import harness

    def make(name, **traffic):
        cell = harness.resolve(bench, name)
        cell["config"] = copy.deepcopy(cell["config"])
        cell["config"]["port"].update(TINY_PORT)
        cell["traffic"] = {**cell["traffic"], **TINY_TRAFFIC, **traffic}
        cell["limits"] = dict(TINY_LIMITS)
        return cell

    return make
