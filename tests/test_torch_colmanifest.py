"""The port's columnar manifest codec (TSCM) and manifest diffs (TSCD)
against the JAX package's: the golden fixtures encode to the same bytes in
both packages, each decodes the other's, and a columnar snapshot written
by either package restores bit-exact in the other."""

from __future__ import annotations

import copy
import os
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import colmanifest as jax_col
from torchsnapshot_tpu.manifest import SnapshotMetadata as JaxMetadata
from torchsnapshot_tpu_torch import colmanifest as port_col
from torchsnapshot_tpu_torch.manifest import ArrayEntry, SnapshotMetadata
from torch_test_env import autotune_never  # noqa: F401 - autouse

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDENS = ["golden_manifest.json", "golden_manifest.yaml"]


def _text(name: str) -> str:
    with open(os.path.join(DATA, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_tscm_bytes_equal_jax(name) -> None:
    raw = port_col.encode_metadata(SnapshotMetadata.from_yaml(_text(name)))
    assert raw[:4] == b"TSCM"
    assert raw == jax_col.encode_metadata(JaxMetadata.from_yaml(_text(name)))


@pytest.mark.parametrize("name", GOLDENS)
def test_each_package_decodes_the_others_bytes(name) -> None:
    port_md = SnapshotMetadata.from_yaml(_text(name))
    jax_md = JaxMetadata.from_yaml(_text(name))
    from_jax = port_col.decode_metadata(jax_col.encode_metadata(jax_md))
    from_port = jax_col.decode_metadata(port_col.encode_metadata(port_md))
    assert from_jax.to_yaml() == port_md.to_yaml() == jax_md.to_yaml() == from_port.to_yaml()


def test_golden_round_trip_reproduces_the_json_text() -> None:
    text = _text("golden_manifest.json")
    md = SnapshotMetadata.from_yaml(text)
    assert port_col.decode_metadata(port_col.encode_metadata(md)).to_yaml() == text


def _mutated(md: SnapshotMetadata) -> SnapshotMetadata:
    new = copy.deepcopy(md)
    new.manifest["0/model/weight"].checksum = "crc32c:0badf00d"
    del new.manifest["0/extra/blob"]
    new.manifest["0/model/extra_w"] = ArrayEntry(
        location="0/model/extra_w", serializer="buffer_protocol", dtype="float32",
        shape=[4], replicated=False,
    )
    return new


def test_manifest_diff_round_trip_and_interchange() -> None:
    md = SnapshotMetadata.from_yaml(_text("golden_manifest.json"))
    new = _mutated(md)
    diff = port_col.encode_manifest_diff(md, new)
    assert diff[:4] == b"TSCD"
    applied = port_col.apply_manifest_diff(md, diff)
    assert asdict(applied) == asdict(new) and applied.to_yaml() == new.to_yaml()
    assert len(diff) < len(port_col.encode_metadata(new))
    # The same diff bytes in the JAX package, applied there too.
    jax_md = JaxMetadata.from_yaml(_text("golden_manifest.json"))
    jax_new = JaxMetadata.from_yaml(new.to_yaml())
    assert jax_col.encode_manifest_diff(jax_md, jax_new) == diff
    assert jax_col.apply_manifest_diff(jax_md, diff).to_yaml() == new.to_yaml()


def test_bad_magic_is_refused() -> None:
    with pytest.raises(ValueError, match="magic"):
        port_col.decode_metadata(b"XXXX\x01")
    with pytest.raises(ValueError, match="magic"):
        port_col.apply_manifest_diff(SnapshotMetadata.from_yaml(_text("golden_manifest.json")),
                                     b"TSCM\x01")


def _np_state():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((64, 33)).astype(np.float32),
        "h": rng.standard_normal((17,)).astype(np.float32),
        "i": rng.integers(-9, 9, (8, 3)).astype(np.int32),
    }


@pytest.mark.parametrize("fmt", ["columnar", "json"])
def test_port_take_restores_in_jax(tmp_path, monkeypatch, fmt) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_MANIFEST_FORMAT", fmt)
    s = _np_state()
    bf = torch.arange(12, dtype=torch.float32).to(torch.bfloat16)
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"m": P.StateDict(**{k: torch.from_numpy(v.copy()) for k, v in s.items()},
                                             bf=bf, step=3, name="x")})
    head = open(os.path.join(path, ".snapshot_metadata"), "rb").read(4)
    assert (head == b"TSCM") == (fmt == "columnar")
    dst = J.StateDict(**{k: jnp.zeros(v.shape, v.dtype) for k, v in s.items()},
                      bf=jnp.zeros((12,), jnp.bfloat16), step=0, name="")
    J.Snapshot(path).restore({"m": dst})
    for k, v in s.items():
        assert np.array_equal(np.asarray(dst[k]), v), k
    assert np.array_equal(np.asarray(dst["bf"], dtype=np.float32), bf.float().numpy())
    assert dst["step"] == 3 and dst["name"] == "x"


def test_jax_columnar_take_restores_in_port(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_MANIFEST_FORMAT", "columnar")
    s = _np_state()
    path = str(tmp_path / "s")
    J.Snapshot.take(path, {"m": J.StateDict(**{k: jnp.asarray(v) for k, v in s.items()}, step=4)})
    assert open(os.path.join(path, ".snapshot_metadata"), "rb").read(4) == b"TSCM"
    dst = P.StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
                         for k, v in s.items()}, step=0)
    P.Snapshot(path).restore({"m": dst})
    for k, v in s.items():
        assert np.array_equal(dst[k].numpy(), v), k
    assert dst["step"] == 4
    # The columnar metadata decodes to what the JSON reader gives.
    meta = P.Snapshot(path).metadata
    assert port_col.decode_metadata(port_col.encode_metadata(meta)).to_yaml() == meta.to_yaml()


def test_columnar_metadata_is_smaller_at_many_leaves(tmp_path, monkeypatch) -> None:
    state = P.StateDict(**{f"p{i}": torch.full((4,), float(i)) for i in range(200)})
    sizes = {}
    for fmt in ("json", "columnar"):
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_MANIFEST_FORMAT", fmt)
        path = str(tmp_path / fmt)
        P.Snapshot.take(path, {"m": state})
        sizes[fmt] = os.path.getsize(os.path.join(path, ".snapshot_metadata"))
        dst = P.StateDict(**{f"p{i}": torch.zeros(4) for i in range(200)})
        P.Snapshot(path).restore({"m": dst})
        assert all(torch.equal(dst[k], state[k]) for k in state)
    assert sizes["columnar"] < sizes["json"]
