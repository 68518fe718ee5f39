"""float16, rows that are not a multiple of 16 bytes, and head dims over 256.

K1-K3 take all three of the JAX model's float dtypes and every head dim
(``fa.kernel_width``): a row the tensor-core kernels do not take runs on
operands zero-padded to ``fa.padded_dim`` with the results sliced back,
and ``d > 256`` runs the deep forms (all three kernels, in every dtype, on
the tensor cores). On the CPU the wrappers' plain versions stand in for
the kernels; held here:

- the port's ``flash_attention`` against the JAX package's (Pallas in
  interpret mode) at bf16 and f16 ``d = 12``, f32 ``d = 6``, and ``d =
  264, 320, 512`` in every dtype, at ``tests/test_pallas_attention.py``'s
  bars (f32 1e-5 / 1e-4, bf16 3e-2 / 0.1; f16 at bf16's);
- the emulations of the deep tensor-core forms' arithmetic (16-bit P in
  K1, 16-bit P and dS in K2 and K3, the 3xTF32 chunks of K1 and K3 in
  f32, every product as three TF32 products in K2 and K3) against the JAX
  package's Pallas kernels at ``d = 320`` and ``512``, at the same bars;
- the pad and slice of the raw functions and of the model's route, with
  the scale taken from the caller's ``d`` (a scale from the padded width
  fails these tests);
- the model at f16, and at head_dim 12 and 320, ``attn_impl="flash"``
  against the JAX model's, on weights carried over by
  ``params_from_numpy``;
- the model's ``auto`` route on a CUDA device: the kernels for every dtype
  they take, and a dtype they do not take (float64, the port's deliberate
  difference: the JAX package runs with x64 off) refused by name before
  any work;
- the f16 backward's rounding of scale dS under a loss-scaled gradient.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_headdims import _check_against_jax
from test_torch_kernels_cuda import flash_bwd_emul
from torchsnapshot_tpu.flatten import flatten as jax_flatten
from torchsnapshot_tpu.models import transformer as JT
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import flash_attention as fa
from torch_test_env import autotune_never  # noqa: F401 - autouse

# Head dims whose row is not a multiple of 16 bytes (bf16 and f16 12, f32
# 6), and past 256 (264, 320, 512) in every dtype: the JAX package's flash
# takes them all.
PADDED_AND_DEEP = ([(12, "bfloat16"), (12, "float16"), (6, "float32")]
                   + [(d, dt) for d in (264, 320, 512) for dt in ("float32", "bfloat16", "float16")])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", PADDED_AND_DEEP, ids=str)
def test_flash_attention_matches_jax_at_padded_and_deep_head_dims(d, dtype, causal) -> None:
    """Forward and the gradients of ``sum(o * dO)`` through
    ``flash_attention`` (B 2, S 64, H 2, blocks 32 and 64; its layout copy
    padded to ``fa.padded_dim``) against the JAX package's."""
    _check_against_jax(d, causal, dtype, blocks=(32, 64))


# The deep tensor-core forms' arithmetic, emulated in torch, against the JAX
# package's Pallas kernels in interpret mode (BH 2, S 80: a length that
# ends inside a 64-key tile, blocks of 16), at tests/test_pallas_attention.py's
# bars: f32 o and lse 1e-5, gradients 1e-4; 16-bit o and lse 3e-2.
DEEP_EMUL_CASES = [(d, dt) for d in (320, 512) for dt in ("float32", "bfloat16", "float16")]
DEEP_S, DEEP_BLOCK = 80, 16


def _deep_arrays(n, d, dtype, seed):
    """``n`` (2, S, d) arrays in ``dtype`` as numpy f32 and as torch (the
    same values on both sides)."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal((2, DEEP_S, d), dtype=np.float32))
          .to(getattr(torch, dtype)) for _ in range(n)]
    return [t.float().numpy() for t in ts], ts


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", DEEP_EMUL_CASES, ids=str)
def test_deep_forward_emulations_match_jax(d, dtype, causal) -> None:
    """The deep forward kernels' arithmetic in their own order: f32 as
    ``fa.flash_fwd_tf32_emulated`` (64-key tiles, each 32-column chunk's
    three TF32 products summed fresh, the chunks parted between the two
    warpgroups as ``fa.deep_score_chunks``, P V by halves of a tile), bf16
    and f16 as ``fa.flash_fwd_bf16_wide_emulated`` (P rounded to the input
    dtype for P V), against the JAX forward."""
    from test_torch_flash_headdims import FWD_ATOL, _np
    from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts

    assert fa.kernel_width(d, getattr(torch, dtype)) == fa.DEEP
    arrays, (q, k, v) = _deep_arrays(3, d, dtype, seed=d + 5)
    fwd_impl, _ = _make_flash_parts(causal, None, DEEP_BLOCK, DEEP_BLOCK, True)
    jo, jlse = fwd_impl(*(jnp.asarray(a).astype(dtype) for a in arrays))
    emul = fa.flash_fwd_tf32_emulated if dtype == "float32" else fa.flash_fwd_bf16_wide_emulated
    o, lse = emul(q, k, v, causal=causal)
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    np.testing.assert_allclose(_np(o), _np(jo), atol=FWD_ATOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(lse), _np(jlse)[..., 0], atol=FWD_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 512])
def test_deep_f32_backward_emulation_matches_jax(d, causal) -> None:
    """dq, dk and dv of the deep f32 backward kernels' arithmetic
    (``fa.flash_bwd_tf32_emulated``: every product as three TF32
    products), from the JAX forward's lse and delta = rowsum(dO o),
    against the JAX backward at the f32 gradient bar."""
    from test_torch_flash_headdims import GRAD_ATOL, _np
    from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts

    arrays, (q, k, v, g) = _deep_arrays(4, d, "float32", seed=d + 6)
    fwd_impl, bwd_impl = _make_flash_parts(causal, None, DEEP_BLOCK, DEEP_BLOCK, True)
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)
    jo, jlse = fwd_impl(jq, jk, jv)
    jdelta = jnp.sum(jo * jg, axis=-1, keepdims=True)
    jgrads = bwd_impl(jq, jk, jv, jg, jlse, jdelta)
    lse, delta = (torch.from_numpy(np.asarray(x)[..., 0].copy()) for x in (jlse, jdelta))
    grads = fa.flash_bwd_tf32_emulated(q, k, v, g, lse, delta, causal=causal)
    for a, b in zip(grads, jgrads):
        assert a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL["float32"], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", [(d, dt) for d in (320, 512) for dt in ("bfloat16", "float16")],
                         ids=str)
def test_deep_16bit_backward_emulation_matches_jax(d, dtype, causal) -> None:
    """dq, dk and dv of the deep 16-bit backward kernels' arithmetic
    (``fa.flash_bwd_bf16_wide_emulated``: the scores over the whole of d,
    P and dS rounded to the input dtype as the operands of the output
    products, f16 rounding scale dS), from the JAX forward's lse and delta
    = rowsum(dO o), against the JAX backward (Pallas in interpret mode) at
    the 16-bit gradient bar of ``tests/test_torch_flash_headdims.py``
    (``GRAD_ATOL``, 0.1)."""
    from test_torch_flash_headdims import GRAD_ATOL, _np
    from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts

    assert fa.kernel_width(d, getattr(torch, dtype)) == fa.DEEP
    arrays, (q, k, v, g) = _deep_arrays(4, d, dtype, seed=d + 8)
    fwd_impl, bwd_impl = _make_flash_parts(causal, None, DEEP_BLOCK, DEEP_BLOCK, True)
    jq, jk, jv, jg = (jnp.asarray(a).astype(dtype) for a in arrays)
    jo, jlse = fwd_impl(jq, jk, jv)
    jdelta = jnp.sum(jo.astype(jnp.float32) * jg.astype(jnp.float32), axis=-1, keepdims=True)
    jgrads = bwd_impl(jq, jk, jv, jg, jlse, jdelta)
    lse, delta = (torch.from_numpy(np.asarray(x)[..., 0].copy()) for x in (jlse, jdelta))
    grads = fa.flash_bwd_bf16_wide_emulated(q, k, v, g, lse, delta, causal=causal)
    for a, b in zip(grads, jgrads):
        assert a.dtype == q.dtype and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL[dtype], rtol=0)


# ------------------------------------------------------------ pad and slice

def _operands(shape, dtype, seed, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
            for _ in range(n)]


class _Spy:
    """A forward or backward that records the scale and head dim it is given
    and runs the plain version on what it is given."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, *args, causal, scale):
        self.seen.append((scale, args[0].shape[-1]))
        return self.fn(*args, causal=causal, scale=scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", [(12, torch.bfloat16), (12, torch.float16),
                                     (6, torch.float32), (10, torch.float32)], ids=str)
def test_raw_pad_and_slice_keep_the_callers_scale(d, dtype, causal) -> None:
    """``fwd_on_padded`` and ``bwd_on_padded`` (what the kernel wrappers run
    on a CUDA tensor) around the plain versions: the operands go in padded
    to ``fa.padded_dim`` with the scale of the caller's ``d``, and what
    comes back, sliced to ``d``, is the plain version of the unpadded
    operands."""
    width = fa.padded_dim(d, dtype)
    assert width > d
    q, k, v, g = _operands((3, 70, d), dtype, seed=d, n=4)
    fwd = _Spy(fa.flash_fwd_reference)
    o, lse = fa.fwd_on_padded(fwd, q, k, v, causal=causal)
    assert fwd.seen == [(d**-0.5, width)]
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=causal)
    assert o.shape == q.shape and o.dtype == dtype and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-6, rtol=0)

    delta = (g.float() * o_ref.float()).sum(-1)
    bwd = _Spy(fa.flash_bwd_reference)
    got = fa.bwd_on_padded(bwd, q, k, v, g, lse_ref, delta, causal=causal)
    assert bwd.seen == [(d**-0.5, width)]
    want = fa.flash_bwd_reference(q, k, v, g, lse_ref, delta, causal=causal)
    for a, b in zip(got, want):
        assert a.shape == q.shape and a.dtype == dtype and a.is_contiguous()
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6, rtol=0)
    # An explicit scale goes through as it is.
    fa.fwd_on_padded(fwd, q, k, v, causal=causal, scale=0.3)
    assert fwd.seen[-1] == (0.3, width)


@pytest.mark.parametrize("d,dtype,width", [(16, torch.bfloat16, 16), (8, torch.float32, 8),
                                           (264, torch.float16, 264), (300, torch.bfloat16, 304),
                                           (257, torch.float32, 260)], ids=str)
def test_raw_pad_and_slice_leave_aligned_and_deep_rows_alone(d, dtype, width) -> None:
    """An aligned row (16 bytes a multiple), below 256 or past it, goes in
    as it is; a deep row that is not aligned goes in padded (the deep forms
    load through TMA too), with the scale of the caller's ``d`` and ``o``
    sliced back."""
    q, k, v = _operands((2, 20, d), dtype, seed=d, n=3)
    fwd = _Spy(fa.flash_fwd_reference)
    o, _ = fa.fwd_on_padded(fwd, q, k, v)
    assert fwd.seen == [(d**-0.5, width)] and o.shape == q.shape


@pytest.mark.parametrize("d,dtype", [(12, torch.float16), (6, torch.float32)], ids=str)
def test_model_route_pads_in_its_layout_copy(d, dtype, monkeypatch) -> None:
    """``fa.flash`` (the model's route) hands the kernels operands of the
    padded width with the scale of the caller's ``d``; o and the gradients
    of ``sum(o * dO)`` are those of dense attention on the unpadded
    operands."""
    seen = []
    real = fa.flash_fwd

    def spy(q, k, v, *, causal, scale):
        seen.append((tuple(q.shape), scale))
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    q, k, v, g = _operands((2, 48, 3, d), torch.float32, seed=7, n=4)
    q, k, v = (t.to(dtype).requires_grad_(True) for t in (q, k, v))
    o = fa.flash(q, k, v, causal=True)
    assert seen == [((6, 48, fa.padded_dim(d, dtype)), d**-0.5)]
    assert o.shape == (2, 48, 3, d) and o.dtype == dtype
    grads = torch.autograd.grad((o.float() * g).sum(), (q, k, v))

    qd, kd, vd = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * d**-0.5
    s = s.masked_fill(~torch.ones(48, 48, dtype=torch.bool).tril(), float("-inf"))
    od = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    want = torch.autograd.grad((od * g).sum(), (qd, kd, vd))
    atol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(o.float(), od.detach(), atol=atol, rtol=0)
    for a, b in zip(grads, want):
        assert a.shape == q.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b, atol=10 * atol, rtol=0)


# ------------------------------------------------------------------ the model

def _model_setup(dtype: str, head_dim: int, n_layers: int = 2):
    kw = dict(vocab_size=256, d_model=2 * head_dim, n_heads=2, n_layers=n_layers, d_ff=128,
              max_seq_len=64, attn_impl="flash", attn_block_size=32)
    jcfg = JT.TransformerConfig(**kw, dtype=getattr(jnp, dtype))
    pcfg = T.TransformerConfig(**kw, dtype=getattr(torch, dtype))
    assert pcfg.head_dim == head_dim
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    tokens, targets = (rng.integers(0, 256, (2, 64), dtype=np.int32) for _ in range(2))
    return jcfg, pcfg, jparams, params, tokens, targets


@pytest.mark.parametrize("dtype,head_dim", [("float16", 32), ("float16", 12), ("float32", 12),
                                            ("float32", 320), ("bfloat16", 320)], ids=str)
def test_model_flash_logits_match_jax(dtype, head_dim) -> None:
    """Logits of ``attn_impl="flash"`` on both sides (2 layers, 2 heads of
    ``head_dim``, S 64): f32 at 2e-4, bf16 and f16 at 0.0625 on the maximum
    and 0.01 on the mean, as ``tests/test_torch_transformer.py`` holds
    them."""
    jcfg, pcfg, jparams, params, tokens, _ = _model_setup(dtype, head_dim)
    port = T.forward(params, torch.from_numpy(tokens).long(), pcfg)
    assert port.dtype == getattr(torch, dtype) and port.shape == (2, 64, 256)
    ref = np.asarray(JT.forward(jparams, jnp.asarray(tokens), jcfg).astype(jnp.float32))
    diff = np.abs(port.float().numpy() - ref)
    if dtype == "float32":
        assert diff.max() <= 2e-4, diff.max()
    else:
        assert diff.max() <= 0.0625 and diff.mean() <= 0.01, (diff.max(), diff.mean())


@pytest.mark.parametrize("head_dim", [12, 320])
def test_model_flash_f32_loss_and_gradients_match_jax(head_dim) -> None:
    """The f32 loss and every gradient leaf at 1e-6 absolute (one layer),
    as ``tests/test_torch_train.py`` holds them."""
    jcfg, pcfg, jparams, params, tokens, targets = _model_setup("float32", head_dim, n_layers=1)
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    pbatch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jparams, jbatch, jcfg)
    loss, grads = T.loss_and_grads(params, pbatch, pcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-6
    want = {p: np.asarray(x) for p, x in jax_flatten(jgrads)[1].items()}
    got = {p: x.numpy() for p, x in port_flatten(grads)[1].items()}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6, rtol=0, err_msg=path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_auto_routes_every_kernel_dtype_to_the_kernels_on_cuda(dtype) -> None:
    cfg = T.TransformerConfig(d_model=24, n_heads=2, dtype=dtype)
    assert T._resolve_attn_impl(cfg, torch.device("cuda"), 64) == "flash"


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_a_dtype_no_kernel_takes_is_refused_by_name_on_cuda(attn_impl) -> None:
    """float64 (the deliberate difference): refused with its name when the
    plan is made, before any work; on the CPU the plain routes take it."""
    cfg = T.TransformerConfig(d_model=64, n_heads=2, dtype=torch.float64, attn_impl=attn_impl)
    with pytest.raises(TypeError, match=r"got torch\.float64$"):
        T._resolve_attn_impl(cfg, torch.device("cuda"), 64)
    assert T._resolve_attn_impl(cfg, torch.device("cpu"), 64) in ("dense", "flash")
    f64 = dataclasses.replace(cfg, vocab_size=64, n_layers=1, d_ff=32, max_seq_len=16,
                              attn_impl="auto")
    params = T.init_params(f64, torch.Generator().manual_seed(0), "cpu")
    logits = T.forward(params, torch.zeros((1, 16), dtype=torch.long), f64)
    assert logits.dtype == torch.float64 and bool(torch.isfinite(logits).all())


# --------------------------------------------- f16 under a loss-scaled dO

@pytest.mark.parametrize("D", [64, 256, 320])
def test_f16_backward_rounding_stays_finite_under_loss_scaling(D) -> None:
    """The f16 backward kernels round scale dS (the scale folded in before
    the rounding) and P to f16 as their A operands; ``flash_bwd_emul``
    rounds as they do. With dO scaled by 2^12, as a loss-scaled gradient
    is, dS alone comes within 1.4x of f16's 65,504 at D = 256; scale dS
    stays finite, and the rounded recompute, scaled back by 2^-12, is held
    to the gradient bar of the plain version (0.1)."""
    BH, S = 8, 128
    q, k, v, g = _operands((BH, S, D), torch.float16, seed=D, n=4)
    g = (g.float() * 2.0**12).to(torch.float16)
    o, lse = fa.flash_fwd_reference(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    plain = fa.flash_bwd_reference(q, k, v, g, lse, delta)
    emul = flash_bwd_emul(q, k, v, g, lse, delta)
    for t in (*plain, *emul):
        assert bool(torch.isfinite(t).all())
    for p, e in zip(plain, emul):
        assert (e.float() - p.float()).abs().max().item() * 2.0**-12 <= 0.1
