"""Without a card the harness fails and prints no result; it never falls
back to the CPU. Without the port beside it, it fails too."""

import os
import shutil
import subprocess
import sys

from portbench.harness import ROOT


def _run(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "gpt2m.train",
                           "--seed", "2147483647", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _run(tmp_path).returncode != 0
    # On a card the device check passes, and the system under test is
    # missing: the benchmark carries no copy of it.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", "import sys; sys.path[0] = %r; "
                          "from portbench import program" % str(tmp_path)],
                         cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "torchsnapshot_tpu_torch" in out.stderr
