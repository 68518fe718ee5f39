"""The command line and the tricks over CUDA-taken state, on the card.

- ``cat`` of a leaf taken from a CUDA tensor prints what the same CPU
  leaf prints, bf16 included, and the CLI process never starts CUDA.
- ``diff`` of two CUDA takes with device digests (K4 on the card) finds
  the leaves one train-like update changed.
- A migrated reference snapshot restores bit-exact onto the card, and a
  ``TrainStateAdapter`` and a ``PytreeAdapter`` round-trip CUDA state.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cli_cuda.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch import cli
from torchsnapshot_tpu_torch.tricks import PytreeAdapter, TrainStateAdapter
from torchsnapshot_tpu_torch.tricks import torchsnapshot_interop as tsi
from torch_cli_env import run_cli
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "reference_snapshot")


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(64, 32, generator=g)
    return {"m": P.StateDict(w=w.to(device), bf=w[:4].bfloat16().to(device),
                             i=torch.arange(50).to(device), step=3)}


def test_cat_of_cuda_leaves_prints_as_cpu_leaves_and_starts_no_cuda(card, tmp_path) -> None:
    on_card, on_host = str(tmp_path / "card"), str(tmp_path / "host")
    P.Snapshot.take(on_card, _state(card))
    P.Snapshot.take(on_host, _state("cpu"))
    for leaf in ("0/m/w", "0/m/bf", "0/m/i", "0/m/step"):
        assert run_cli(cli.main, ["cat", on_card, leaf]) == run_cli(cli.main, ["cat", on_host, leaf])
    code = ("import sys, torch, torchsnapshot_tpu_torch.cli as c\n"
            f"snap = {on_card!r}\n"
            "for argv in (['info', snap], ['ls', snap], ['cat', snap, '0/m/bf'],\n"
            "             ['verify', snap], ['fsck', snap], ['diff', snap, snap]):\n"
            "    assert c.main(argv) == 0, argv\n"
            "print('cuda initialized', torch.cuda.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "cuda initialized False"


def test_diff_of_cuda_takes_by_device_digests(card, tmp_path) -> None:
    a, same, changed = (str(tmp_path / n) for n in ("a", "same", "changed"))
    state = _state(card)
    P.Snapshot.take(a, state, device_digests=True, record_digests=True)
    P.Snapshot.take(same, state, device_digests=True, record_digests=True, incremental_base=a)
    state["m"]["w"].add_(1.0)
    P.Snapshot.take(changed, state, device_digests=True, record_digests=True)
    entry = P.Snapshot(a).metadata.manifest["0/m/w"].chunks[0].array
    assert entry.device_digest.startswith("xxh4x32:")
    rc, out, _ = run_cli(cli.main, ["diff", a, same])
    assert rc == 0 and "0 changed" in out
    rc, out, _ = run_cli(cli.main, ["diff", a, changed])
    assert rc == 1 and out.splitlines()[0].startswith("~ 0/m/w") and "1 changed" in out


def test_a_migrated_snapshot_restores_onto_the_card(card, tmp_path) -> None:
    native = str(tmp_path / "native")
    assert run_cli(cli.main, ["migrate", FIXTURE, native])[0] == 0
    want = tsi.load_torchsnapshot(FIXTURE)["app"]

    def zeros_on_card(tree):
        if isinstance(tree, torch.Tensor):
            return torch.zeros_like(tree, device=card)
        if isinstance(tree, dict):
            return {k: zeros_on_card(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(zeros_on_card(v) for v in tree)
        return tree

    dst = P.StateDict(zeros_on_card(want))
    P.Snapshot(native).restore({"app": dst})
    assert dst["weights"].is_cuda and torch.equal(dst["weights"].cpu(), want["weights"])
    assert dst["bf"].is_cuda
    assert torch.equal(dst["bf"].cpu().view(torch.int16), want["bf"].view(torch.int16))
    assert torch.equal(dst["nested"]["b"]["c"].cpu(), want["nested"]["b"]["c"])
    assert dst["step"] == 7 and dst["opt"]["momenta"] == (0.9, 0.999)
    back = str(tmp_path / "back")
    tsi.migrate_to_torchsnapshot(native, back)
    assert torch.equal(tsi.load_torchsnapshot(back)["app"]["weights"], want["weights"])


def test_adapters_round_trip_cuda_state(card, tmp_path) -> None:
    tree = {"a": [torch.randn(8, device=card), (torch.ones(2, device=card), 3)]}
    P.Snapshot.take(str(tmp_path / "t"), {"t": PytreeAdapter(tree)})
    dst = PytreeAdapter({"a": [torch.zeros(8, device=card), (torch.zeros(2, device=card), 0)]})
    P.Snapshot(str(tmp_path / "t")).restore({"t": dst})
    assert dst.tree["a"][0].is_cuda and torch.equal(dst.tree["a"][0], tree["a"][0])
    assert dst.tree["a"][1][1] == 3
    from torchsnapshot_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                              max_seq_len=16)
    opt = T.make_optimizer(1e-3)
    src = T.init_state(torch.Generator().manual_seed(0), cfg, opt, device="cuda")
    P.Snapshot.take(str(tmp_path / "s"), {"train": TrainStateAdapter(src)})
    adapter = TrainStateAdapter(T.init_state(torch.Generator().manual_seed(1), cfg, opt,
                                             device="cuda"))
    P.Snapshot(str(tmp_path / "s")).restore({"train": adapter})
    assert torch.equal(adapter.state["params"]["embed"], src["params"]["embed"])
    assert adapter.state["params"]["embed"].is_cuda
