"""The plain reference against the port's model on the CPU at a tiny size:
in float32 the two agree to rounding, and the program's bf16 steps lie
nearer the reference than the float8 control does."""

import copy

import pytest
import torch

from portbench import harness, judge


def _cell(tiny_cell, dtype):
    cell = tiny_cell("gpt2m.train")
    cell["config"] = copy.deepcopy(cell["config"])
    cell["config"]["port"]["dtype"] = dtype
    return cell


@pytest.mark.parametrize("seed", [0, 2_147_483_647 + 5])
def test_reference_follows_the_port_in_float32(tiny_cell, seed):
    run = harness.CellRun(_cell(tiny_cell, "float32"), seed, torch.device("cpu"))
    prog = run.first_steps()
    run.free()
    ref = run.follow_reference()
    numbers, excluded = judge.step_numbers(prog, ref)
    assert excluded == 0
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4


def test_the_control_is_further_than_the_program(tiny_cell):
    from portbench import calibrate

    out = calibrate.readings(_cell(tiny_cell, "bfloat16"), seeds=2, controls=2,
                             device=torch.device("cpu"))
    worst, control, half = out["program_max"], out["control_fp8_min"], out["fault_half_batch_min"]
    assert control["grad_gap"] > 3 * worst["grad_gap"]
    assert half["grad_gap"] > 10 * worst["grad_gap"]
    assert set(out["program"]) and set(out["control_fp8"]) and set(out["fault_half_batch"])
