"""The on-disk contract, held between the JAX package and the PyTorch port:
the golden manifest, the dtype-string tables and flatten's logical paths."""

from __future__ import annotations

import os
from collections import OrderedDict, namedtuple
from dataclasses import asdict

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import flatten as jax_flatten
from torchsnapshot_tpu import serialization as jax_ser
from torchsnapshot_tpu.manifest import SnapshotMetadata as JaxSnapshotMetadata
from torchsnapshot_tpu_torch import flatten as port_flatten
from torchsnapshot_tpu_torch import serialization as port_ser
from torchsnapshot_tpu_torch.manifest import SnapshotMetadata
from torch_test_env import autotune_never  # noqa: F401 - autouse

DATA = os.path.join(os.path.dirname(__file__), "data")


def _read(name: str) -> str:
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def test_golden_manifest_round_trips_byte_exact() -> None:
    text = _read("golden_manifest.json")
    md = SnapshotMetadata.from_yaml(text)
    assert md.to_yaml() == text
    assert md.to_yaml() == JaxSnapshotMetadata.from_yaml(text).to_yaml()


def test_legacy_yaml_golden_parses_like_json() -> None:
    legacy = SnapshotMetadata.from_yaml(_read("golden_manifest.yaml"))
    current = SnapshotMetadata.from_yaml(_read("golden_manifest.json"))
    assert asdict(legacy) == asdict(current)
    assert legacy.to_yaml() == _read("golden_manifest.json")


def test_dtype_tables_agree_on_every_shared_dtype() -> None:
    shared = set(port_ser.STRING_TO_DTYPE) & set(jax_ser.STRING_TO_DTYPE)
    # The port supports nothing the JAX package can't name...
    assert set(port_ser.STRING_TO_DTYPE) <= set(jax_ser.STRING_TO_DTYPE)
    # ...and lacks only the six ml_dtypes torch has no dtype for (those
    # this ml_dtypes build has).
    assert set(jax_ser.STRING_TO_DTYPE) - shared <= port_ser.TORCH_MISSING_DTYPE_STRINGS
    for name in sorted(shared):
        dtype = port_ser.string_to_dtype(name)
        assert port_ser.dtype_to_string(dtype) == name
        assert jax_ser.dtype_to_string(jax_ser.string_to_dtype(name)) == name
        assert dtype.itemsize == jax_ser.dtype_size_bytes(name), name


@pytest.mark.parametrize("name", sorted(port_ser.TORCH_MISSING_DTYPE_STRINGS))
def test_dtypes_torch_lacks_are_refused_by_name(name: str) -> None:
    with pytest.raises(port_ser.UnsupportedDtypeError, match=name):
        port_ser.string_to_dtype(name)


def test_unknown_dtype_string_is_not_mistaken_for_a_missing_one() -> None:
    with pytest.raises(ValueError, match="newer version") as info:
        port_ser.string_to_dtype("float13_e9")
    assert not isinstance(info.value, port_ser.UnsupportedDtypeError)


_Point = namedtuple("_Point", ["x", "y"])


def _nested_state():
    return {
        "params": {"w": 1, "a/b": 2, "50%": 3, 7: 4},
        "opt": _Point(x=[5, (6, 7)], y=OrderedDict(z=8, first=9)),
        "steps": [10, {"inner": 11}],
        "empty": {},
    }


def test_flatten_gives_identical_logical_paths() -> None:
    jm, jf = jax_flatten.flatten(_nested_state(), prefix="app")
    pm, pf = port_flatten.flatten(_nested_state(), prefix="app")
    assert list(pm) == list(jm)
    assert [type(e).__name__ for e in pm.values()] == [type(e).__name__ for e in jm.values()]
    assert [asdict(e) for e in pm.values()] == [asdict(e) for e in jm.values()]
    assert pf == jf
    rebuilt = port_flatten.inflate(pm, pf, prefix="app")
    assert rebuilt == _nested_state()


def test_tensor_bytes_match_numpy_bytes() -> None:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    mv = port_ser.tensor_as_memoryview(torch.from_numpy(a))
    assert bytes(mv) == a.tobytes()
    back = port_ser.tensor_from_buffer(bytearray(mv), "float32", [3, 5])
    assert np.array_equal(back.numpy(), a)
