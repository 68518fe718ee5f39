"""A whole run on the CPU at a tiny size, the chip's look skipped: sound,
``correct`` is true; with the timed path broken underneath, false, once
for each fault a cell can have."""

import types

import pytest
import torch

from portbench import harness, program


def _run(cell, prog=program, trace=False):
    out, notes = harness.run_cell(cell, 2_147_483_000 + 77, 0.5, trace, torch.device("cpu"),
                                  0.0, program=prog)
    assert list(out)[-1] == "checks"
    return out, notes


def _program(**overrides):
    return types.SimpleNamespace(**{**{k: getattr(program, k) for k in dir(program)
                                       if not k.startswith("__")}, **overrides})


E2E = {"gpt2m.ckpt": {"goodput_tokens_per_s.ckpt", "setup_s"},
       "gpt2m.train": {"goodput_tokens_per_s", "setup_s"}}
# The per-layer metrics on the host clock alone, which an untraced run
# reads too and prints on standard error.
UNTRACED = {"gpt2m.ckpt": {"save_stall_ms", "take_call_ms", "take_wait_ms", "restore_s"},
            "gpt2m.train": {"train_mfu"}}


@pytest.mark.parametrize("name", ["gpt2m.ckpt", "gpt2m.train"])
def test_a_sound_run_is_correct(tiny_cell, name):
    out, notes = _run(tiny_cell(name, take_every_steps=2) if name == "gpt2m.ckpt"
                      else tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == E2E[name]
    assert set(notes["untraced"]) == UNTRACED[name]
    if name == "gpt2m.ckpt":
        # The resumes come after the window, every one timed and checked.
        assert len(notes["op_seconds"]["restore"]) == 5
        assert out["checks"]["restore_bad_bytes"]["value"] == 0


def test_a_step_that_leaves_the_state_unchanged(tiny_cell):
    def make_step(port, opt):
        cfg = program.model_config(port)
        def unchanged(state, batch):
            return state, program.transformer.loss_fn(state["params"], batch, cfg)
        return unchanged

    out, _ = _run(tiny_cell("gpt2m.train"), _program(make_step=make_step))
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tiny_cell):
    def make_step(port, opt):
        step = program.make_step(port, opt)

        def half(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})
        return half

    out, _ = _run(tiny_cell("gpt2m.train"), _program(make_step=make_step))
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] > out["checks"]["grad_gap"]["limit"]


class _AlteringCheckpointer(program.Checkpointer):
    def restore(self, n):
        super().restore(n)
        with torch.no_grad():
            self.app["train"]["params"]["embed"].view(-1)[3].add_(1.0)


class _IdleCheckpointer(program.Checkpointer):
    """A restore that reads the snapshot and writes nothing back."""

    def restore(self, n):
        if n > 0:
            return
        super().restore(n)


@pytest.mark.parametrize("checkpointer", [_AlteringCheckpointer, _IdleCheckpointer],
                         ids=["altered", "left_unwritten"])
def test_a_restored_answer_altered(tiny_cell, checkpointer):
    out, _ = _run(tiny_cell("gpt2m.ckpt", take_every_steps=2),
                  _program(Checkpointer=checkpointer))
    assert not out["correct"]
    assert out["checks"]["restore_bad_bytes"]["value"] > 0


PER_LAYER = {"gpt2m.ckpt": ({"save_stall_ms", "take_stage_ms", "take_write_ms", "restore_s",
                             "restore_decode_ms", "take_call_ms", "take_wait_ms"}, set()),
             # No device on the CPU: the device's readers find nothing.
             "gpt2m.train": ({"train_mfu"}, {"flash_roofline", "device_idle"})}


@pytest.mark.parametrize("name", ["gpt2m.ckpt", "gpt2m.train"])
def test_a_traced_run_reads_its_metrics_on_the_cpu(tiny_cell, name):
    cell = tiny_cell(name, take_every_steps=2) if name == "gpt2m.ckpt" else tiny_cell(name)
    out, notes = _run(cell, trace=True)
    assert out["correct"]
    read, missing = PER_LAYER[name]
    assert set(out["metrics"]) == read
    assert set(notes["missing"]) == missing
    assert out["device"]["window_s"] > 0
