"""The port's read_state_dict against the JAX package's.

Both packages read the same snapshot, written by either package; the
JAX package returns numpy arrays, the port CPU ``torch.Tensor``s of the
stored dtype (bf16 stays bf16), a deliberate difference of the port. The
leaves must agree bit-exact, compared as dtype name, shape and raw bytes,
with primitives and objects equal; ``key=`` and a memory budget change
nothing. A JAX-written optax train state reads with no JAX module
imported.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.flatten import flatten as jax_flatten
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.serialization import dtype_to_string
from torch_test_env import autotune_never  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    bf = rng.standard_normal((16, 8)).astype(np.float32)
    ids = rng.integers(0, 1000, (40,)).astype(np.int64)
    return w, bf, ids


def _take(writer: str, path: str) -> None:
    w, bf, ids = _arrays()
    if writer == "jax":
        import jax.numpy as jnp

        J.Snapshot.take(path, {
            "model": J.StateDict(w=w, bf=jnp.asarray(bf, jnp.bfloat16), nested={"ids": ids},
                                 layers=[w[:4], w[4:8]], lr=0.5, name="m"),
            "extra": J.StateDict(obj={"k": (1, 2)}, step=7),
        })
    else:
        P.Snapshot.take(path, {
            "model": P.StateDict(w=torch.from_numpy(w), bf=torch.from_numpy(bf).to(torch.bfloat16),
                                 nested={"ids": torch.from_numpy(ids)},
                                 layers=[torch.from_numpy(w[:4]), torch.from_numpy(w[4:8])],
                                 lr=0.5, name="m"),
            "extra": P.StateDict(obj={"k": (1, 2)}, step=7),
        })


def _canon(value):
    """(dtype name, shape, bytes) for an array leaf, the value otherwise."""
    if isinstance(value, torch.Tensor):
        assert value.device.type == "cpu"
        flat = value.contiguous().reshape(-1)
        return (dtype_to_string(value.dtype), tuple(value.shape),
                flat.view(torch.uint8).numpy().tobytes())
    if isinstance(value, np.ndarray):
        return (str(value.dtype), value.shape, np.ascontiguousarray(value).tobytes())
    return value


def _leaves(tree, flatten) -> dict:
    return {p: _canon(v) for p, v in flatten(tree)[1].items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_state_dict_equals_the_jax_packages(tmp_path, writer) -> None:
    path = str(tmp_path / "snap")
    _take(writer, path)
    want = J.Snapshot(path).read_state_dict()
    got = P.Snapshot(path).read_state_dict()
    assert sorted(got) == sorted(want) == ["extra", "model"]
    want_leaves = _leaves(want, jax_flatten)
    got_leaves = _leaves(got, port_flatten)
    assert got_leaves == want_leaves and len(got_leaves) == 10
    assert isinstance(got["model"]["w"], torch.Tensor) and got["model"]["bf"].dtype == torch.bfloat16
    assert isinstance(got["model"]["layers"], list) and got["extra"]["obj"] == {"k": (1, 2)}
    assert got["model"]["lr"] == 0.5 and got["model"]["name"] == "m" and got["extra"]["step"] == 7


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("budget", [None, 64, 1 << 20])
def test_read_state_dict_of_one_key_under_a_budget(tmp_path, writer, budget) -> None:
    path = str(tmp_path / "snap")
    _take(writer, path)
    want = J.Snapshot(path).read_state_dict(key="model", memory_budget_bytes=budget)
    got = P.Snapshot(path).read_state_dict(key="model", memory_budget_bytes=budget)
    assert _leaves(got, port_flatten) == _leaves(want, jax_flatten)
    assert set(got) == {"w", "bf", "nested", "layers", "lr", "name"}
    assert P.Snapshot(path).read_state_dict(key="extra", rank=0)["step"] == 7


def test_an_unknown_key_raises_as_in_the_jax_package(tmp_path) -> None:
    path = str(tmp_path / "snap")
    _take("port", path)
    with pytest.raises(RuntimeError, match="No entries under 'nope'"):
        J.Snapshot(path).read_state_dict(key="nope")
    with pytest.raises(RuntimeError, match="No entries under 'nope'"):
        P.Snapshot(path).read_state_dict(key="nope")


def test_read_state_dict_follows_incremental_origins(tmp_path) -> None:
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    frozen = torch.full((64, 8), 1.0)
    P.Snapshot.take(base, {"app": P.StateDict(frozen=frozen, t=torch.zeros(4))}, record_digests=True)
    P.Snapshot.take(inc, {"app": P.StateDict(frozen=frozen, t=torch.ones(4))},
                    incremental_base=base)
    got = P.Snapshot(inc).read_state_dict(key="app")
    assert torch.equal(got["frozen"], frozen) and torch.equal(got["t"], torch.ones(4))
    assert _leaves(got, port_flatten) == _leaves(J.Snapshot(inc).read_state_dict(key="app"),
                                                  jax_flatten)


_READ_OPTAX_STATE = """
import sys
import numpy as np
import torch
import torchsnapshot_tpu_torch as P

root, expected = sys.argv[1], np.load(sys.argv[2])
state = P.Snapshot(root).read_state_dict(key="train")
adam = state["opt_state"][0]
# optax is not imported, so its namedtuples come back as plain tuples.
assert type(adam) is tuple and len(state["opt_state"]) == 3, type(adam)
leaves = {"params/w": state["params"]["w"], "count": adam[0], "mu/w": adam[1]["w"],
          "nu/b": adam[2]["b"], "step": state["step"]}
for name, t in leaves.items():
    assert isinstance(t, torch.Tensor), name
    assert np.array_equal(t.numpy(), expected[name]), name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "torchsnapshot_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_a_jax_optax_train_state_reads_with_no_jax_imported(tmp_path) -> None:
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.standard_normal((3, 4), dtype=np.float32)),
              "b": jnp.asarray(rng.standard_normal(4, dtype=np.float32))}
    tx = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01)
    opt_state = tx.init(params)
    updates, opt_state = tx.update({k: v * 0.5 for k, v in params.items()}, opt_state, params)
    params = optax.apply_updates(params, updates)
    J.Snapshot.take(str(tmp_path / "s"), {"train": J.StateDict(
        params=params, opt_state=opt_state, step=jnp.ones((), jnp.int32))})
    adam = opt_state[0]
    np.savez(tmp_path / "expected.npz", **{
        "params/w": np.asarray(params["w"]), "count": np.asarray(adam.count),
        "mu/w": np.asarray(adam.mu["w"]), "nu/b": np.asarray(adam.nu["b"]),
        "step": np.ones((), np.int32),
    })
    out = subprocess.run(
        [sys.executable, "-c", _READ_OPTAX_STATE, str(tmp_path / "s"),
         str(tmp_path / "expected.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
