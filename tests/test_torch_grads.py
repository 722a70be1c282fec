"""The port's training attention and LayerNorm against the JAX package's,
on the CPU: forward with logsumexp, backward, and the autograd wiring.

Inputs are drawn with numpy from a seed and fed to both. The JAX side runs
its Pallas kernels interpreted (``flash_attention``, ``_flash_fwd_rule``,
``_bwd_pallas``), as the JAX package's own tests run them on the CPU, and
its XLA references; the port runs its plain versions, which is what its
wrappers do for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.ops import layer_norm as jln
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.ops import layer_norm as tln

torch.backends.cuda.matmul.allow_tf32 = False

_TORCH = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
_JAX = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}
# attention: f32 agrees to summation order; bf16 rounds P (and dS) at
# another point than the interpreted TPU kernel (the exp2 argument there,
# the exp2 result here), the bound of tests/test_flash_attention.py
_ATTN_TOL = {np.float32: 1e-5, "bfloat16": 3e-2}


def _pair(arr, dtype):
    j = jnp.asarray(arr, _JAX[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_scaled(got, ref, tol):
    """|got − ref| ≤ tol · max(1, max |ref|): a bound relative to the
    tensor's scale, for gradients whose entries straddle zero."""
    got, ref = _np(got), _np(ref)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)


def _qkv(rng, s, dtype, b=2, h=2, d=64):
    return [_pair(rng.standard_normal((b, h, s, d)).astype(np.float32), dtype)
            for _ in range(3)]


def _strongly_negative(rng, dtype, s=65):
    """Every valid score of a row strongly negative (the case
    tests/test_flash_attention.py pins for the TPU kernel): about −98
    after scaling, past the −87 at which exp2 of an unanchored row
    underflows; q perturbed so that the scores are not uniform."""
    q = (3.5 + 0.1 * rng.standard_normal((1, 2, s, 64))).astype(np.float32)
    k = np.full((1, 2, s, 64), -3.5, np.float32)
    v = rng.standard_normal((1, 2, s, 64)).astype(np.float32)
    return [_pair(a, dtype) for a in (q, k, v)]


# ---------------------------------------------------------------------------
# Attention forward with logsumexp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [17, 37, 65])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_fwd_reference_matches_jax_fwd_rule(rng, s, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, s, dtype)
    o_ref, res = jfa._flash_fwd_rule(jq, jk, jv, None, jfa.auto_block_q(s))
    lse_ref = np.asarray(res[4])[:, :s, 0].reshape(2, 2, s)
    o, lse = tfa.attention_fwd_reference(tq, tk, tv)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (2, 2, s)
    tol = _ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=tol, rtol=tol)
    # the wrapper runs the plain version for CPU tensors
    before = tfa.flash_attention_fwd.launches
    o2, lse2 = tfa.flash_attention_fwd(tq, tk, tv)
    torch.testing.assert_close(o2, o, atol=0, rtol=0)
    torch.testing.assert_close(lse2, lse, atol=0, rtol=0)
    assert tfa.flash_attention_fwd.launches == before


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_fwd_strongly_negative_scores(rng, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _strongly_negative(rng, dtype)
    o_ref, res = jfa._flash_fwd_rule(jq, jk, jv, None, jfa.auto_block_q(65))
    o, lse = tfa.attention_fwd_reference(tq, tk, tv)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    tol = _ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(res[4])[:, :65, 0].reshape(1, 2, 65),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# Attention backward
# ---------------------------------------------------------------------------

def _jax_grads(jq, jk, jv, do):
    """jax.grad of Σ(flash_attention(q, k, v) ∘ dO), Pallas interpreted."""
    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, None, jfa.auto_block_q(q.shape[2]))
        return jnp.sum(o.astype(jnp.float32) * do)
    return jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)


def _check_bwd(rng, qkv, dtype):
    (jq, tq), (jk, tk), (jv, tv) = qkv
    do = rng.standard_normal(tq.shape).astype(np.float32)
    _, tdo = _pair(do, dtype)
    ref = _jax_grads(jq, jk, jv, jnp.asarray(_np(tdo)))
    tol = _ATTN_TOL[dtype]

    o, lse = tfa.attention_fwd_reference(tq, tk, tv)
    plain = tfa.attention_bwd_reference(tq, tk, tv, o, lse, tdo)
    for got, r in zip(plain, ref):
        assert got.dtype == tq.dtype
        _close_scaled(got, r, tol)

    # the autograd paths: attention(inference=False) on the CPU (plain
    # autograd) and the FlashAttention function (plain wrappers)
    for run in (lambda q, k, v: tfa.attention(q, k, v, inference=False),
                tfa.FlashAttention.apply):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        (run(*leaves).float() * tdo.float()).sum().backward()
        for leaf, r in zip(leaves, ref):
            _close_scaled(leaf.grad, r, tol)


@pytest.mark.parametrize("s", [17, 37, 65])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_bwd_matches_jax_grad(rng, s, dtype):
    _check_bwd(rng, _qkv(rng, s, dtype), dtype)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_bwd_strongly_negative_scores(rng, dtype):
    _check_bwd(rng, _strongly_negative(rng, dtype), dtype)


def test_attention_bwd_wrapper_is_plain_on_cpu(rng):
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 33, np.float32)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv)
    do = torch.randn(tq.shape, generator=torch.Generator().manual_seed(1))
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, do)
    for a, b in zip(got, tfa.attention_bwd_reference(tq, tk, tv, o, lse, do)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert tfa.flash_attention_bwd.launches == before


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------

def _ln_inputs(rng, x_dtype, w_dtype, shape=(3, 37, 256)):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    b = rng.standard_normal(shape[-1:]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return (_pair(x, x_dtype), _pair(s, w_dtype), _pair(b, w_dtype),
            _pair(dy, x_dtype))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_ln_grads(got, ref, dtypes):
    """dx within f32 rounding (one bf16 ulp when x is bf16); dscale and
    dbias, sums over 111 rows, within 1e-5 relative to their scale in f32
    and one bf16 ulp plus that when they are cast to bf16."""
    for g, r, dt in zip(got, ref, dtypes):
        g, r = _np(g), _np(r)
        if dt == np.float32:
            assert np.abs(g - r).max() <= 1e-5 * max(1.0, np.abs(r).max())
        else:
            assert (np.abs(g - r) <= _bf16_ulp(r) + 1e-5 * max(
                1.0, np.abs(r).max())).all()


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (np.float32, np.float32), ("bfloat16", "bfloat16"),
    ("bfloat16", np.float32)])
def test_layer_norm_bwd_reference_matches_jax(rng, reference, x_dtype,
                                              w_dtype):
    (jx, tx), (js, ts), _, (jdy, tdy) = _ln_inputs(rng, x_dtype, w_dtype)
    fn = jln._bwd_xla if reference == "xla" else jln._bwd_pallas
    ref = fn(1e-12, jx, js, jdy)
    got = tln.layer_norm_bwd_reference(tx, ts, tdy, 1e-12)
    assert [g.dtype for g in got] == [tx.dtype, ts.dtype, ts.dtype]
    assert got[0].shape == tx.shape and got[1].shape == ts.shape
    _assert_ln_grads(got, ref, (x_dtype, w_dtype, w_dtype))


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (np.float32, np.float32), ("bfloat16", "bfloat16"),
    ("bfloat16", np.float32)])
def test_layer_norm_autograd_matches_jax_grad(rng, x_dtype, w_dtype):
    (jx, tx), (js, ts), (jb, tb), (jdy, tdy) = _ln_inputs(rng, x_dtype,
                                                          w_dtype)

    def f(x, s, b):
        y = jln.layer_norm(x, s, b, 1e-12)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2))(jx, js, jb)
    leaves = [t.clone().requires_grad_() for t in (tx, ts, tb)]
    y = tln.layer_norm(*leaves, 1e-12)
    (y.float() * tdy.float()).sum().backward()
    _assert_ln_grads([t.grad for t in leaves], ref,
                     (x_dtype, w_dtype, w_dtype))


def test_layer_norm_saves_only_x_and_scale(rng):
    (_, tx), (_, ts), (_, tb), _ = _ln_inputs(rng, np.float32, np.float32)
    leaves = [t.clone().requires_grad_() for t in (tx, ts, tb)]
    y = tln.layer_norm(*leaves, 1e-12)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == leaves[0].data_ptr()
    assert saved[1].data_ptr() == leaves[1].data_ptr()
    before = tln.layer_norm_bwd_cuda.launches
    y.sum().backward()
    assert tln.layer_norm_bwd_cuda.launches == before


def test_layer_norm_bwd_cuda_refuses_cpu_tensors(rng):
    (_, tx), (_, ts), _, (_, tdy) = _ln_inputs(rng, np.float32, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_bwd_cuda(tx, ts, tdy, 1e-12)
