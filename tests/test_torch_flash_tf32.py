"""The 3xTF32 split of the port's f32 flash kernels, on the CPU.

The f32 forward kernel (csrc/flash_fwd.cu) and the f32 backward kernels
(csrc/flash_bwd.cu) run every product A B on the tensor cores as
A_lo B_hi + A_hi B_lo + A_hi B_hi, with hi = tf32(x) and lo = tf32(x - hi)
rounded by ``cvt.rna.tf32.f32``. Here:

- ``fa.split_tf32`` is held bit for bit to a numpy model of that rounding
  (to nearest, ties away from zero) written in float64 arithmetic;
- ``fa.flash_fwd_tf32_emulated``, the forward kernel's arithmetic in its
  own order (key tiles, the online softmax, each tile's P V summed fresh),
  and ``fa.flash_bwd_tf32_emulated``, the plain backward with every product
  split so, are held to the JAX package's f32 flash (its Pallas kernels in
  interpret mode, as tests/test_pallas_attention.py runs them) at that
  file's bars: 1e-5 on o and lse, 1e-4 on dq, dk and dv; the emulated
  forward also to a float64 forward at 2e-6;
- the f32 training path as a whole: the port's f32 transformer with its
  flash forward and backward swapped for the emulations against the JAX
  package's f32 loss and gradients through flash, at the bars
  ``chip_smoke.py`` holds the f32 path to on the card (loss 1e-5, each
  gradient leaf relative L2 1e-5).

The kernels themselves are held to the emulation on the card by
tests/test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.flatten import flatten as jax_flatten
from torchsnapshot_tpu.models import transformer as JT
from torchsnapshot_tpu.ops.pallas_attention import _make_flash_parts
from torchsnapshot_tpu_torch.flatten import flatten as port_flatten
from torchsnapshot_tpu_torch.models import transformer as T
from torchsnapshot_tpu_torch.ops import flash_attention as fa
from torch_test_env import autotune_never  # noqa: F401 - autouse

F32_MAX = np.finfo(np.float32).max


def tf32_rna_model(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` in float64 arithmetic: a finite value keeps 11
    significant bits, its quantum 2^(e - 11) for x = m 2^e (0.5 <= |m| < 1),
    never under 2^-136 (tf32 subnormals sit where f32's do); the magnitude
    rounds half away from zero, past the largest f32 to infinity. An
    infinity or a NaN keeps its pattern but its 13 low bits, as the card
    does (tests/test_torch_kernels_cuda.py holds the card to this)."""
    x = np.asarray(x, dtype=np.float32)
    out = x.view(np.uint32) & ~np.uint32(0x1FFF)
    finite = np.isfinite(x)
    xf = x[finite].astype(np.float64)
    _, e = np.frexp(xf)
    quantum = np.ldexp(1.0, np.maximum(e, -125) - 11)
    r = np.copysign(np.floor(np.abs(xf) / quantum + 0.5) * quantum, xf)
    r[np.abs(r) > F32_MAX] = np.copysign(np.inf, r[np.abs(r) > F32_MAX])
    out[finite] = r.astype(np.float32).view(np.uint32)
    return out.view(np.float32)


def split_model(x: np.ndarray):
    """hi and lo, the remainder x - hi as the card's f32 subtraction gives it
    (its canonical NaN 0x7FFFFFFF where the CPU would keep a payload)."""
    hi = tf32_rna_model(x)
    with np.errstate(invalid="ignore"):
        rem = x.astype(np.float32) - hi
    rem[np.isnan(rem)] = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)[0]
    return hi, tf32_rna_model(rem)


def _patterns(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    u32 = lambda lo, hi, n: rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    sign = u32(0, 2, 4096) << 31
    if case == "random":  # every exponent, both signs
        return u32(0, 2**32, 20000)
    if case == "ties":  # the 13 dropped bits exactly half a tf32 step, and one bit either side
        top = u32(0, 2**19, 4096) << 13
        return np.concatenate([top | 0x1000, top | 0x0FFF, top | 0x1001])
    if case == "subnormals":  # exponent 0, ties among them
        frac = u32(0, 0x800000, 4096)
        return np.concatenate([sign | frac, sign | (frac & ~np.uint32(0x1FFF)) | 0x1000])
    if case == "largest":  # the top of the range, some rounding to infinity
        frac = u32(0x7F7F0000, 0x7F800000, 4096)
        return np.concatenate([frac, frac | 0x80000000,
                               np.array([0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x7F7FE000],
                                        dtype=np.uint32)])
    assert case == "specials"  # zeros, infinities, NaNs, the smallest values
    return np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                     0x7FBFFFFF, 1, 0x80000001, 0x1000, 0x80001000, 0x2000, 0x00800000,
                     0x3F800000, 0xBF801000], dtype=np.uint32)


@pytest.mark.parametrize("case", ["random", "ties", "subnormals", "largest", "specials"])
def test_split_tf32_is_the_cvt_rna_model_bit_for_bit(case: str) -> None:
    x = _patterns(case).view(np.float32)
    hi, lo = fa.split_tf32(torch.from_numpy(x.copy()))
    want_hi, want_lo = split_model(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    for t in (hi, lo):  # a tf32 pattern: the 13 low bits clear
        assert not (t.numpy().view(np.uint32) & fa.TF32_DROP).any()


def test_split_tf32_keeps_about_21_bits() -> None:
    """hi has 11 significant bits and lo the next 11 of the remainder:
    |x - (hi + lo)| <= 2^-22 |x| for every normal x whose lo is normal."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(100000) * np.exp2(rng.integers(-90, 90, 100000))).astype(np.float32)
    hi, lo = (t.numpy().astype(np.float64) for t in fa.split_tf32(torch.from_numpy(x)))
    err = np.abs(x.astype(np.float64) - (hi + lo))
    assert (err <= np.exp2(-22) * np.abs(x)).all()
    assert np.abs(x - hi).max() > 0  # the split has work to do


@pytest.mark.parametrize("shape", [(64, 256, 64), (200, 512, 128)])
def test_matmul_3xtf32_holds_f32_accuracy_where_one_tf32_product_does_not(shape) -> None:
    m, k, n = shape
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(fa.matmul_3xtf32(ta, tb).numpy() - want).max()
    err32 = np.abs((ta @ tb).numpy() - want).max()
    err1 = np.abs((fa.round_tf32(ta) @ fa.round_tf32(tb)).numpy() - want).max()
    assert err3 <= 2 * err32, (err3, err32)
    assert err1 >= 100 * err3, (err1, err3)


def _arrays(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [96, 160])
def test_emulated_split_matches_jax_f32_flash(S: int, D: int, causal: bool) -> None:
    """S not a multiple of the kernels' 64-row tiles; the JAX side in
    blocks of 32."""
    arrays = _arrays((2, S, D), seed=S + D, n=4)
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)
    fwd_impl, bwd_impl = _make_flash_parts(causal, None, 32, 32, True)
    jo, jlse = fwd_impl(jq, jk, jv)
    jdelta = jnp.sum(jg * jo, axis=-1, keepdims=True)
    want = bwd_impl(jq, jk, jv, jg, jlse, jdelta)

    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    o, lse = fa.flash_fwd_tf32_emulated(q, k, v, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-5, rtol=0)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    delta = torch.from_numpy(np.asarray(jdelta)[..., 0].copy())
    got = fa.flash_bwd_tf32_emulated(q, k, v, g, lse, delta, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == (2, S, D)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)


def _dense_f64(q, k, v, causal):
    """The forward in float64, dense: the softmax of the pre-scaled scores
    with NEG_INF masking, ``(o, lse)``."""
    q, k, v = (t.double() for t in (q, k, v))
    s = (q * q.shape[2] ** -0.5) @ k.transpose(1, 2)
    if causal:
        pos = torch.arange(s.shape[1])
        s = torch.where(pos[:, None] >= pos[None, :], s, torch.full_like(s, fa.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return (p @ v) / l, (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [96, 160])
def test_emulated_forward_in_the_kernels_order_is_near_f64(S: int, D: int, causal: bool) -> None:
    """The emulated forward, tile by tile as the kernel runs (64 keys a
    tile at D = 64, the last one ragged here; 32 at D = 128), within 2e-6
    of a float64 forward; a dense f32 forward reads up to 1e-6 from it
    here. One TF32 product per matmul instead of three misses the bar."""
    assert fa.fwd_tf32_rows(D) == (64 if D == 64 else 32)
    q, k, v = (torch.from_numpy(a) for a in _arrays((2, S, D), seed=S + D + 1, n=3))
    want_o, want_lse = _dense_f64(q, k, v, causal)
    o, lse = fa.flash_fwd_tf32_emulated(q, k, v, causal=causal)
    assert o.dtype == torch.float32 and o.shape == (2, S, D) and lse.shape == (2, S)
    np.testing.assert_allclose(o.double().numpy(), want_o.numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(lse.double().numpy(), want_lse.numpy(), atol=2e-6, rtol=0)
    one = fa.flash_fwd_reference(fa.round_tf32(q), fa.round_tf32(k), fa.round_tf32(v),
                                 causal=causal)[0]
    assert (one.double() - want_o).abs().max().item() > 2e-6


SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_layers=2, d_ff=512, max_seq_len=96)


def test_f32_training_path_with_the_split_matches_jax(monkeypatch) -> None:
    """The f32 path as the card runs it, at a small size: head_dim 64 (the
    kernels' own) and S = 96; attention's forward and backward through the
    emulated split, as the f32 kernels compute them."""
    jcfg = JT.TransformerConfig(**SMALL, dtype=jnp.float32, attn_impl="flash", attn_block_size=32)
    pcfg = T.TransformerConfig(**SMALL, dtype=torch.float32, attn_impl="flash", attn_block_size=32)
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(3)
    tokens, targets = (rng.integers(0, 256, (2, 96), dtype=np.int32) for _ in range(2))
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jparams, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}, jcfg)

    calls = []

    def split_forward(q, k, v, *, causal=True, scale=None):
        calls.append(("fwd", q.shape))
        return fa.flash_fwd_tf32_emulated(q, k, v, causal=causal, scale=scale)

    def split_backward(q, k, v, dO, lse, delta, *, causal=True, scale=None):
        calls.append(("bwd", q.shape))
        return fa.flash_bwd_tf32_emulated(q, k, v, dO, lse, delta, causal=causal, scale=scale)

    monkeypatch.setattr(fa, "flash_fwd", split_forward)
    monkeypatch.setattr(fa, "flash_bwd", split_backward)
    loss, grads = T.loss_and_grads(
        params, {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}, pcfg)
    # Each once a layer, the forwards first.
    assert calls == [("fwd", (2 * 4, 96, 64))] * 2 + [("bwd", (2 * 4, 96, 64))] * 2
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = {p: np.asarray(x) for p, x in jax_flatten(jgrads)[1].items()}
    got = {p: x.numpy() for p, x in port_flatten(grads)[1].items()}
    assert got.keys() == want.keys()
    for path in want:
        rel = np.linalg.norm(got[path] - want[path]) / np.linalg.norm(want[path])
        assert rel <= 1e-5, (path, rel)
