"""On a card: one short run of each cell through the command line, which
has to come out correct. Skips where there is none."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs only on a card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt2m.ckpt", "gptj6b.train", "gpt2m.train"])
def test_a_short_run_is_correct(card, name):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          "2147483111", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]


@pytest.mark.cuda
def test_an_altered_restore_is_caught_on_the_card(card, bench):
    from portbench import harness, program

    class Altering(program.Checkpointer):
        def restore(self, n):
            super().restore(n)
            with torch.no_grad():
                self.app["train"]["params"]["embed"].view(-1)[3].add_(1.0)

    cell = harness.resolve(bench, "gpt2m.ckpt")
    prog = type("P", (), {k: getattr(program, k) for k in dir(program) if not k.startswith("__")})
    prog.Checkpointer = Altering
    out, _ = harness.run_cell(cell, 2147483112, 3.0, False, torch.device("cuda", 0), 0.0,
                              program=prog)
    assert not out["correct"] and out["checks"]["restore_bad_bytes"]["value"] > 0
