"""The port's CUDA kernels held against their plain versions on the card.

These tests need an NVIDIA GPU with ``nvcc``; elsewhere they skip. They
import torch only, so on a machine without JAX run them without the
suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# Bars of tests/test_pallas_attention.py: 1e-5 for f32, 3e-2 for bf16.
ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        for _ in range(3)
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 256, 64), (4, 192, 128), (3, 100, 64)])
def test_flash_fwd_kernel_matches_plain(card, causal, dtype, shape) -> None:
    q, k, v = _qkv(shape, dtype, card)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    assert o.dtype == dtype and lse.shape == shape[:2]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=ATOL[dtype], rtol=0)


def test_flash_fwd_kernel_refuses_unsupported(card) -> None:
    q, k, v = _qkv((2, 64, 32), torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, v)
    q, k, v = _qkv((2, 64, 64), torch.float16, card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, k, v)
