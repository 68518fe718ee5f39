"""The port's async_restore on the CPU, against the JAX package's.

Mirrors ``tests/test_async_restore.py`` (:21, :42), with one case
restoring a JAX-written snapshot. The caller's overlapping work is a torch
op in place of the JAX test's jit compile. Every test waits on the
restores it starts, so no thread outlives it. The ordering of the
restore's copies against the caller's CUDA work is tested on the card
(``tests/test_torch_surface_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torch_test_env import autotune_never  # noqa: F401 - autouse


def _state(v: float = 1.0) -> P.StateDict:
    return P.StateDict(
        w=torch.full((128, 64), v, dtype=torch.float32),
        nested={"b": torch.full((32,), v * 2, dtype=torch.float32)},
        step=int(v),
    )


def test_async_restore_roundtrip(tmp_path) -> None:
    p = str(tmp_path / "snap")
    P.Snapshot.take(p, {"app": _state(3.0)})
    dst = _state(0.0)
    pending = P.Snapshot(p).async_restore({"app": dst})
    assert isinstance(pending, P.PendingRestore)
    # Caller-side work overlapping the restore.
    work = (torch.ones((8, 8)) * 2).sum()
    assert pending.wait() is None
    assert pending.done()
    assert torch.equal(dst["w"], torch.full((128, 64), 3.0))
    assert torch.equal(dst["nested"]["b"], torch.full((32,), 6.0))
    assert dst["step"] == 3
    assert work.item() == 128.0


def test_async_restore_propagates_failure(tmp_path) -> None:
    p = str(tmp_path / "snap")
    P.Snapshot.take(p, {"app": _state(1.0)})
    # A destination whose structure mismatches: the restore fails in wait().
    dst = P.StateDict(w=torch.zeros((7, 7)))
    pending = P.Snapshot(p).async_restore({"app": dst})
    with pytest.raises(RuntimeError):
        pending.wait()
    assert pending.done()


def test_async_restore_of_a_jax_written_snapshot(tmp_path) -> None:
    p = str(tmp_path / "snap")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    J.Snapshot.take(p, {"app": J.StateDict(w=w, nested={"b": b}, step=5)})
    dst = _state(0.0)
    pending = P.Snapshot(p).async_restore({"app": dst})
    pending.wait()
    assert np.array_equal(dst["w"].numpy(), w)
    assert np.array_equal(dst["nested"]["b"].numpy(), b)
    assert dst["step"] == 5


def test_async_restore_equals_restore_with_rng_and_device_digests(tmp_path) -> None:
    """The same snapshot restored by ``restore`` and by ``async_restore``,
    with device digests and an RNG state, gives identical tensors and
    generator state; a destination already holding the content is
    skipped by both."""
    p = str(tmp_path / "snap")
    torch.manual_seed(11)
    src = {"app": _state(4.0), "rng": P.RNGState()}
    P.Snapshot.take(p, src, device_digests=True)
    expected_draw = torch.rand(3)
    a = {"app": _state(0.0), "rng": P.RNGState()}
    P.Snapshot(p).restore(a, device_digests=True)
    draw_a = torch.rand(3)
    b = {"app": _state(0.0), "rng": P.RNGState()}
    P.Snapshot(p).async_restore(b, device_digests=True).wait()
    draw_b = torch.rand(3)
    assert torch.equal(draw_a, expected_draw) and torch.equal(draw_b, expected_draw)
    for key in ("w", "step"):
        assert torch.equal(torch.as_tensor(a["app"][key]), torch.as_tensor(b["app"][key]))
    held = a["app"]["w"]
    P.Snapshot(p).async_restore({"app": a["app"]}, device_digests=True).wait()
    assert a["app"]["w"] is held and torch.equal(held, torch.full((128, 64), 4.0))
