"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from torch_test_env import autotune_never  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "torchsnapshot_tpu_torch")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "torchsnapshot_tpu", "ml_dtypes", "optax", "flax", "psutil")


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
    names = {os.path.relpath(f, PORT) for f in files}
    assert {"native_io.py", "faultinject.py", "scheduler.py", "storage_plugins/fs.py",
            "ops/moe.py", "ops/ssm.py", "models/ssm_lm.py", "models/embedding.py",
            "dist_store.py", "pg_wrapper.py", "layout.py", "io_preparers/sharded.py",
            "test_utils.py", "fanout.py", "reshard.py", "distrib.py", "tenancy/__init__.py",
            "tenancy/registry.py", "tenancy/quota.py", "tenancy/pool.py", "tenancy/admission.py",
            "telemetry/history.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/comm.py", "ops/ring_attention.py", "ops/ring_flash.py",
            "ops/ulysses.py", "models/transformer_mesh.py", "device.py", "parallel/pipeline.py",
            "telemetry/__init__.py", "telemetry/core.py", "telemetry/taxonomy.py",
            "telemetry/flightrec.py", "telemetry/export.py", "telemetry/aggregate.py",
            "telemetry/health.py", "storage_plugins/retry.py", "storage_plugins/mirror.py",
            "colmanifest.py", "journal.py", "georep.py", "dedup.py", "cli.py", "__main__.py",
            "rss_profiler.py", "tricks/__init__.py", "tricks/torchsnapshot_interop.py",
            "tricks/train_state.py", "tricks/dcp_interop.py"} <= names
    bad = [(f, m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_import_leaves_no_jax_in_sys_modules() -> None:
    code = (
        "import sys, torchsnapshot_tpu_torch, torchsnapshot_tpu_torch.entry, "
        "torchsnapshot_tpu_torch.ops.flash_attention, torchsnapshot_tpu_torch.native_io, "
        "torchsnapshot_tpu_torch.faultinject, torchsnapshot_tpu_torch.scheduler, "
        "torchsnapshot_tpu_torch.storage_plugins.fs, torchsnapshot_tpu_torch.ops.moe, "
        "torchsnapshot_tpu_torch.ops.ssm, torchsnapshot_tpu_torch.models.ssm_lm, "
        "torchsnapshot_tpu_torch.models.embedding, torchsnapshot_tpu_torch.dist_store, "
        "torchsnapshot_tpu_torch.pg_wrapper, torchsnapshot_tpu_torch.layout, "
        "torchsnapshot_tpu_torch.io_preparers.sharded, torchsnapshot_tpu_torch.test_utils, "
        "torchsnapshot_tpu_torch.fanout, torchsnapshot_tpu_torch.reshard, "
        "torchsnapshot_tpu_torch.parallel, torchsnapshot_tpu_torch.parallel.comm, "
        "torchsnapshot_tpu_torch.ops.ring_attention, torchsnapshot_tpu_torch.ops.ring_flash, "
        "torchsnapshot_tpu_torch.ops.ulysses, torchsnapshot_tpu_torch.models.transformer_mesh, "
        "torchsnapshot_tpu_torch.device, torchsnapshot_tpu_torch.parallel.pipeline, "
        "torchsnapshot_tpu_torch.telemetry, torchsnapshot_tpu_torch.telemetry.health, "
        "torchsnapshot_tpu_torch.storage_plugins.retry, "
        "torchsnapshot_tpu_torch.storage_plugins.mirror, torchsnapshot_tpu_torch.colmanifest, "
        "torchsnapshot_tpu_torch.journal, torchsnapshot_tpu_torch.georep, "
        "torchsnapshot_tpu_torch.cli, torchsnapshot_tpu_torch.rss_profiler, "
        "torchsnapshot_tpu_torch.tricks.torchsnapshot_interop, "
        "torchsnapshot_tpu_torch.tricks.train_state, torchsnapshot_tpu_torch.tricks.dcp_interop; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torchsnapshot_tpu', 'ml_dtypes', 'psutil')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _device_or_collective_names(source: str):
    """Every ``torch.cuda`` / ``torch.distributed`` the source names: as an
    import, as an attribute chain off ``torch``, or through an alias of
    either."""
    tree = ast.parse(source)
    banned = ("torch.cuda", "torch.distributed")
    found = []
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(banned):
                    found.append(alias.name)
                elif alias.name == "torch":
                    aliases[alias.asname or "torch"] = "torch"
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.startswith(banned) or (
                node.module == "torch" and any(a.name in ("cuda", "distributed") for a in node.names)
            ):
                found.append(node.module)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if aliases.get(node.value.id) == "torch" and node.attr in ("cuda", "distributed"):
                found.append(f"{node.value.id}.{node.attr}")
    return found


def test_peer_plane_names_no_device_and_no_collective() -> None:
    """``fanout.py``, ``reshard.py`` and ``distrib.py`` run on background
    threads (restores, seeding sessions, update receivers): they name
    neither ``torch.cuda`` nor ``torch.distributed`` (the counterpart of
    the JAX package's ``scripts/check_peer_channel.py``)."""
    for name in ("fanout.py", "reshard.py", "distrib.py"):
        with open(os.path.join(PORT, name)) as f:
            assert _device_or_collective_names(f.read()) == [], name
    assert _device_or_collective_names("import torch\nx = torch.cuda.Event()\n")
    assert _device_or_collective_names("import torch.distributed as dist\n")
    assert _device_or_collective_names("from torch import cuda\n")
    assert _device_or_collective_names("import torch as t\nt.distributed.barrier()\n")
    assert _device_or_collective_names("import torch\nx = torch.zeros(2)\n") == []


_RESTORE_OPTAX_STATE = """
import sys
import numpy as np
import torch
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.models import transformer as T

root, expected = sys.argv[1], np.load(sys.argv[2])
params = {"w": torch.zeros((3, 4)), "b": torch.zeros((4,))}
dst = {"params": params, "opt_state": T.make_optimizer().init(params),
       "step": torch.zeros((), dtype=torch.int32)}
holder = P.StateDict(dst)
P.Snapshot(root).restore({"train": holder})
got = dict(holder)
adam = got["opt_state"][0]
assert type(adam) is T.ScaleByAdamState, type(adam)
assert [type(s) for s in got["opt_state"][1:]] == [T.EmptyState, T.EmptyState]
leaves = {"params/w": got["params"]["w"], "params/b": got["params"]["b"],
          "count": adam.count, "mu/w": adam.mu["w"], "nu/b": adam.nu["b"], "step": got["step"]}
for name, t in leaves.items():
    assert np.array_equal(t.numpy(), expected[name]), name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "torchsnapshot_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_restoring_a_jax_optax_state_imports_no_jax(tmp_path) -> None:
    """The manifest of a JAX-written train state names optax's modules
    (``optax._src.transform.ScaleByAdamState``); the port's restore must
    rebuild those namedtuples from the destination's classes and import
    none of them."""
    import jax.numpy as jnp
    import numpy as np
    import optax

    import torchsnapshot_tpu as J

    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.standard_normal((3, 4), dtype=np.float32)),
              "b": jnp.asarray(rng.standard_normal(4, dtype=np.float32))}
    tx = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01)
    opt_state = tx.init(params)
    grads = {k: jnp.ones_like(v) * 0.5 for k, v in params.items()}
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    state = {"params": params, "opt_state": opt_state, "step": jnp.ones((), jnp.int32)}
    J.Snapshot.take(str(tmp_path / "s"), {"train": J.StateDict(**state)})
    manifest = J.Snapshot(str(tmp_path / "s")).get_manifest()
    assert manifest["0/train/opt_state/0"].module.startswith("optax")

    adam = opt_state[0]
    np.savez(tmp_path / "expected.npz", **{
        "params/w": np.asarray(params["w"]), "params/b": np.asarray(params["b"]),
        "count": np.asarray(adam.count), "mu/w": np.asarray(adam.mu["w"]),
        "nu/b": np.asarray(adam.nu["b"]), "step": np.asarray(state["step"]),
    })
    out = subprocess.run(
        [sys.executable, "-c", _RESTORE_OPTAX_STATE, str(tmp_path / "s"),
         str(tmp_path / "expected.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_inflate_without_a_destination_imports_nothing() -> None:
    from torchsnapshot_tpu_torch.flatten import inflate
    from torchsnapshot_tpu_torch.manifest import NamedTupleEntry
    from torchsnapshot_tpu_torch.models import transformer as T

    leaves = {"/0": 1, "/1": 2, "/2": 3}
    unknown = {"": NamedTupleEntry("not_a_loaded_module.sub", "State", ["count", "mu", "nu"])}
    rebuilt = inflate(unknown, dict(leaves))
    assert type(rebuilt) is tuple and rebuilt == (1, 2, 3)
    assert "not_a_loaded_module" not in sys.modules
    loaded = {"": NamedTupleEntry(T.__name__, "ScaleByAdamState", ["count", "mu", "nu"])}
    assert type(inflate(loaded, dict(leaves))) is T.ScaleByAdamState
    renamed = {"": NamedTupleEntry(T.__name__, "ScaleByAdamState", ["count", "m", "v"])}
    assert type(inflate(renamed, dict(leaves))) is tuple


def test_the_parallel_and_ops_layers_import_no_model() -> None:
    """``parallel/`` and ``ops/`` sit below ``models/``: none of their
    modules imports a model module."""
    bad = []
    for sub in ("parallel", "ops"):
        for name in sorted(os.listdir(os.path.join(PORT, sub))):
            if not name.endswith(".py"):
                continue
            path = os.path.join(PORT, sub, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and "models" in (
                    (node.module or "").split(".") if node.level else
                    (node.module or "").split(".")[1:2]
                ):
                    bad.append((f"{sub}/{name}", node.module))
    assert bad == []
