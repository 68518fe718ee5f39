"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "torchsnapshot_tpu_torch")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "torchsnapshot_tpu", "ml_dtypes", "optax", "flax")


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_static_scan_finds_no_jax_import() -> None:
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = [(f, m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_import_leaves_no_jax_in_sys_modules() -> None:
    code = (
        "import sys, torchsnapshot_tpu_torch, torchsnapshot_tpu_torch.entry, "
        "torchsnapshot_tpu_torch.ops.flash_attention; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torchsnapshot_tpu', 'ml_dtypes')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
