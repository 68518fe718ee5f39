"""The single-process surface and the workloads on the card.

- ``async_restore``: the caller's zero fill queued before the call lands
  before the restored bytes, and a kernel launched on the caller's stream
  (or on another stream) right after ``wait()`` returns, with no
  synchronization of the caller's own, reads the restored bytes, while
  the caller ran device work of its own during the restore.
- ``read_object(memory_budget_bytes=)`` into a CUDA tensor: every range
  goes HtoD into its flat slice; bit-exact for contiguous, strided, cast
  and chunked destinations, and streamed.
- The MoE FFN, the SSM LM and the embedding model on the card against the
  same weights on the CPU: MoE in f32 with identical routing within 1e-5;
  SSM and embedding logits within relative L2 1e-5.

These tests need an NVIDIA GPU; elsewhere they skip. Run them on the card
without the suite's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_surface_cuda.py
"""

from __future__ import annotations

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu_torch.io_preparers import chunked as C
from torchsnapshot_tpu_torch.models import embedding as PE
from torchsnapshot_tpu_torch.models import ssm_lm as PL
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import moe as PM
from torch_test_env import autotune_never  # noqa: F401 - autouse

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("other_stream", [False, True])
def test_a_kernel_right_after_wait_reads_the_restored_bytes(tmp_path, card, other_stream) -> None:
    n = 64 << 20  # 256 MiB of f32 per tensor
    gen = torch.Generator(device=card).manual_seed(0)
    src = {f"t{i}": torch.rand(n, device=card, generator=gen) for i in range(3)}
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"app": P.StateDict(src)})
    dst = {k: torch.full_like(v, 7.0) for k, v in src.items()}
    # Queued on the caller's stream before the call, behind a long matmul:
    # the restore's copies must land after it.
    a = torch.rand((4096, 4096), device=card)
    for _ in range(4):
        a = a @ a / 4096
    for v in dst.values():
        v.zero_()
    pending = P.Snapshot(path).async_restore({"app": P.StateDict(dst)})
    busy = a
    for _ in range(8):  # the caller's own device work meanwhile
        busy = torch.tanh(busy @ busy / 4096)
    pending.wait()
    stream = torch.cuda.Stream() if other_stream else torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        checks = [torch.equal(dst[k], src[k]) for k in src]
    assert all(checks)
    assert torch.isfinite(busy).all()


def test_async_restore_into_cuda_propagates_failure(tmp_path, card) -> None:
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"app": P.StateDict(w=torch.ones(16, device=card))})
    pending = P.Snapshot(path).async_restore({"app": P.StateDict(w=torch.zeros(15, device=card))})
    with pytest.raises(RuntimeError):
        pending.wait()
    assert pending.done()


@pytest.mark.parametrize("budget", [4, 1 << 10, 1 << 20, 1 << 30])
def test_a_budgeted_read_into_a_cuda_tensor(tmp_path, card, budget) -> None:
    # One element a range at the smallest budget: a small tensor.
    shape = (7, 13) if budget == 4 else (300, 1031)
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"app": P.StateDict(w=w)})
    out = torch.zeros_like(w, device=card)
    assert P.Snapshot(path).read_object("0/app/w", obj_out=out, memory_budget_bytes=budget) is out
    assert torch.equal(out.cpu(), w)
    strided = torch.zeros(shape[::-1], device=card).T
    P.Snapshot(path).read_object("0/app/w", obj_out=strided, memory_budget_bytes=budget)
    assert torch.equal(strided.cpu(), w)
    wider = torch.zeros(w.shape, dtype=torch.float64, device=card)
    P.Snapshot(path).read_object("0/app/w", obj_out=wider, memory_budget_bytes=budget)
    assert torch.equal(wider.cpu(), w.double())


def test_budgeted_chunked_and_streamed_reads_into_cuda(tmp_path, card, monkeypatch) -> None:
    monkeypatch.setattr(C, "DEFAULT_MAX_CHUNK_SIZE_BYTES", 1 << 20)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES", str(64 << 10))
    w = torch.randn((1024, 1024), generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "s")
    P.Snapshot.take(path, {"app": P.StateDict(w=w)})
    assert len(P.Snapshot(path).get_manifest()["0/app/w"].chunks) == 4
    out = torch.zeros_like(w, device=card)
    P.Snapshot(path).read_object("0/app/w", obj_out=out, memory_budget_bytes=512 << 10)
    assert torch.equal(out.cpu(), w)


def test_moe_ffn_on_the_card_matches_the_cpu(card) -> None:
    gen = torch.Generator().manual_seed(0)
    params = PM.init_moe_params(gen, 64, 128, 8)
    x = torch.randn((512, 64), generator=gen)
    for dispatch in ("einsum", "sort"):
        y, aux = PM.moe_ffn(params, x, dispatch=dispatch)
        gp = {k: v.to(card) for k, v in params.items()}
        yc, auxc = PM.moe_ffn(gp, x.to(card), dispatch=dispatch)
        for a, b in zip(PM._top2_route(x, params["router"])[:2],
                        PM._top2_route(x.to(card), gp["router"])[:2]):
            assert torch.equal(a, b.cpu())
        assert (yc.cpu() - y).abs().max().item() <= 1e-5
        assert abs(auxc.item() - aux.item()) <= 1e-6


def test_ssm_lm_and_embedding_forward_on_the_card_match_the_cpu(card) -> None:
    cfg = PL.SSMConfig(vocab_size=512, d_model=64, d_state=8, n_layers=2, d_ff=128)
    params = PL.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(1))
    want = PL.forward(params, tokens, cfg)
    got = PL.forward(T.params_from_numpy(T.params_to_numpy(params), device="cuda"),
                     tokens.to(card), cfg)
    assert _rel_l2(got, want) <= 1e-5

    ecfg = PE.EmbeddingConfig(n_tables=4, rows_per_table=1000, dim=16, mlp_hidden=(64, 16))
    eparams = PE.init_params(ecfg, torch.Generator().manual_seed(2), device="cpu")
    gen = torch.Generator().manual_seed(3)
    dense = torch.randn((256, 13), generator=gen)
    ids = torch.randint(0, 1000, (256, 4), generator=gen)
    want = PE.forward(eparams, dense, ids, ecfg)
    got = PE.forward(T.params_from_numpy(T.params_to_numpy(eparams), device="cuda"),
                     dense.to(card), ids.to(card), ecfg)
    assert _rel_l2(got, want) <= 1e-5
