"""Ring-flash on the card, in a world of 2 processes.

Both processes sit on ``cuda:0`` (gloo moves the hops through pinned host
memory, ``parallel/comm.py``). Each rank runs ring-flash and zigzag-flash
on its block of one bf16 layer, forward and backward, and holds them
against K1-K3 on the whole sequence in its own process: forward 3e-2,
gradients 0.1 (the bf16 attention bars). Each rank's kernel launches are
the ones the ring implies: the rank of seq index i runs i + 1 hops, zigzag
2n + 1 calls. The transformer's ring, zigzag and Ulysses routes take the
kernels also where the local length has no tile divisor.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda

SHAPE = (2, 256, 4, 64)  # B, S, H, D


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    return [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]


def _worker(rank: int, world: int, impl: str) -> dict:
    from torchsnapshot_tpu_torch.ops import ring_attention
    from torchsnapshot_tpu_torch.ops.flash_attention import flash_attention
    from torchsnapshot_tpu_torch.ops.ring_flash import (
        ring_flash_self_attention,
        zigzag_ring_flash_self_attention,
    )
    from torchsnapshot_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh({"data": 1, "seq": world, "model": 1})
    gen = torch.Generator().manual_seed(7)
    q, k, v, dO = (torch.randn(SHAPE, generator=gen).to("cuda", torch.bfloat16) for _ in range(4))
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*whole, causal=True)
    o.backward(dO)
    S_l = SHAPE[1] // world
    if impl == "ring":
        idx = torch.arange(rank * S_l, (rank + 1) * S_l, device="cuda")
        body = ring_flash_self_attention
    else:
        idx = ring_attention.zigzag_layout_indices(SHAPE[1], world, "cuda")[
            rank * S_l : (rank + 1) * S_l]
        body = zigzag_ring_flash_self_attention
    local = [t.index_select(1, idx).contiguous().requires_grad_(True) for t in (q, k, v)]
    before = _launches()
    o_l = body(*local, group=mesh.get_group("seq"))
    o_l.backward(dO.index_select(1, idx))
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(_launches(), before)]
    fwd = (o_l.float() - o.index_select(1, idx).float()).abs().max().item()
    grad = max((a.grad.float() - b.grad.index_select(1, idx).float()).abs().max().item()
               for a, b in zip(local, whole))
    return {"fwd": fwd, "grad": grad, "launches": launches}


@pytest.mark.parametrize("impl", ["ring", "zigzag"])
def test_ring_flash_on_the_card_matches_the_whole_sequence_kernels(card, impl: str) -> None:
    out = run_with_subprocesses(_worker, 2, impl, backend="gloo", timeout=300)
    for rank, res in out.items():
        assert res["fwd"] <= 3e-2 and res["grad"] <= 0.1, (rank, res)
        want = rank + 1 if impl == "ring" else 5
        assert res["launches"] == [want] * 3, (rank, res["launches"])


# S = 2092 = 4 x 523: on seq 2 the ring's shard (1046), the zigzag half
# (523) and Ulysses' whole sequence have no tile divisor by the 512-target
# pick, the length at which the JAX package leaves its Pallas kernels.
UNTILED = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=1, d_ff=256,
               dtype=torch.float32)
UNTILED_TOKENS = (1, 2092)


def _untiled_worker(rank: int, world: int, impl: str) -> dict:
    from torchsnapshot_tpu_torch.models import transformer as T
    from torchsnapshot_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh({"data": 1, "seq": world, "model": 1})
    cfg = T.TransformerConfig(**UNTILED, attn_impl=impl)
    gen = torch.Generator().manual_seed(11)
    params = T.init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, UNTILED_TOKENS, generator=gen).to("cuda")
    with torch.no_grad():
        ref = T.forward(params, tokens, T.TransformerConfig(**UNTILED))
        before = _launches()
        got = T.forward(params, tokens, cfg, mesh=mesh)
    torch.cuda.synchronize()
    return {"err": (got - ref).abs().max().item(),
            "k1": _launches()[0] - before[0]}


@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
def test_context_parallel_routes_take_the_kernels_at_an_untiled_length(card, impl: str) -> None:
    out = run_with_subprocesses(_untiled_worker, 2, impl, backend="gloo", timeout=300)
    for rank, res in out.items():
        # f32 kernels against the single-process kernels on the whole sequence.
        assert res["err"] <= 1e-4, (rank, res)
        want = {"ring": rank + 1, "zigzag": 5, "ulysses": 1}[impl]
        assert res["k1"] == want, (rank, res)
