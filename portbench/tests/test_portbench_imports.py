"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
port."""

import ast
import os
import subprocess
import sys

from portbench import harness

from portbench.harness import ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchsnapshot_tpu_torch_lookalike", sys)
    assert "torchsnapshot_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "torchsnapshot_tpu.snapshot", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "torchsnapshot_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness, program, calibrate; "
            "import json; cell = harness.resolve(json.load(open(%r)), 'gpt2m.ckpt'); "
            "print(harness.forbidden_modules())"
            % (ROOT, os.path.join(ROOT, "BENCHMARK.json")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_only_torch_and_the_benchmark():
    for rel in ("configs/gpt_block.py", "judge.py"):
        for name in _imports(os.path.join(harness.PKG_DIR, rel)):
            top = name.split(".")[0]
            assert top in ("__future__", "typing", "statistics", "torch", "portbench"), (rel, name)
            assert name in ("portbench.judge",) or top != "portbench", (rel, name)
