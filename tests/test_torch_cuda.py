"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no NVIDIA GPU (the CPU
tests hold the plain versions against the JAX package instead). On a
machine with a card and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chestxray_vit_tpu.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.models import bridge, vit
from chestxray_vit_tpu_torch.ops import flash_attention as fa
from chestxray_vit_tpu_torch.ops import layer_norm as ln
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train import steps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; the CPU tests cover their plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


# bf16: the tolerance of tests/test_flash_attention.py for bf16 inputs
# (P is rounded to bf16 at another point than in the plain version);
# f32: summation order only
_ATTN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}


@pytest.mark.parametrize("s", [37, 64, 512, 577])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_matches_plain(dev, s, dtype):
    q, k, v = (_randn((2, 12, s, 64), dtype, dev, seed=i) for i in range(3))
    before = fa.flash_attention_inference.launches
    out = fa.flash_attention_inference(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_inference.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               fa.attention_reference(q, k, v).float(),
                               atol=_ATTN_TOL[dtype], rtol=_ATTN_TOL[dtype])


def test_attention_kernel_reads_projection_views(dev):
    """q/k/v as [B, H, S, d] views of one [B, S, 3·D] product, as the model
    passes them (no copies)."""
    x = _randn((2, 577, 3 * 768), torch.bfloat16, dev)
    q, k, v = (t.view(2, 577, 12, 64).transpose(1, 2)
               for t in x.split(768, dim=-1))
    torch.testing.assert_close(fa.flash_attention_inference(q, k, v).float(),
                               fa.attention_reference(q, k, v).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_strongly_negative_rows(dev, dtype):
    q = torch.full((1, 1, 130, 64), 10.0, device=dev, dtype=dtype)
    k = torch.full((1, 1, 130, 64), -10.0, device=dev, dtype=dtype)
    v = _randn((1, 1, 130, 64), dtype, dev)
    out = fa.flash_attention_inference(q, k, v)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(),
                               fa.attention_reference(q, k, v).float(),
                               atol=_ATTN_TOL[dtype], rtol=_ATTN_TOL[dtype])


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    q = _randn((1, 2, 40, 80), torch.bfloat16, dev)
    with pytest.raises(NotImplementedError, match="head dim"):
        fa.flash_attention_inference(q, q, q)
    q = _randn((1, 2, 40, 64), torch.float16, dev)
    with pytest.raises(TypeError):
        fa.flash_attention_inference(q, q, q)
    q = _randn((1, 2, 40, 64), torch.float32, dev).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        fa.flash_attention_inference(q, q, q)
    with pytest.raises(RuntimeError, match="autograd"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_layer_norm_kernel_matches_plain(dev, x_dtype, w_dtype):
    x = _randn((8 * 577, 768), x_dtype, dev) * 3 + 1
    s, b = _randn((768,), w_dtype, dev, 1), _randn((768,), w_dtype, dev, 2)
    before = ln.layer_norm_cuda.launches
    y = ln.layer_norm(x, s, b, 1e-12)
    torch.cuda.synchronize()
    assert ln.layer_norm_cuda.launches == before + 1
    ref = ln.layer_norm_reference(x, s, b, 1e-12).float()
    if x_dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
    else:
        # one bf16 ulp (the f32 statistics may round either way at the end)
        # plus 1e-5 for the f32 rounding of the affine step, which shows
        # where x̂·scale and bias cancel to a small output
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                         - 7)
        assert ((y.float() - ref).abs() <= ulp + 1e-5).all()


def test_layer_norm_kernel_refuses_what_it_does_not_take(dev):
    x = _randn((16, 768), torch.bfloat16, dev)
    s = torch.ones(768, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm(x.t(), torch.ones(16, device=dev),
                      torch.zeros(16, device=dev), 1e-12)
    with pytest.raises(TypeError):
        ln.layer_norm(x, s, torch.zeros(768, device=dev,
                                        dtype=torch.bfloat16), 1e-12)
    with pytest.raises(RuntimeError, match="autograd"):
        ln.layer_norm_cuda(x.float().requires_grad_(), s, s, 1e-12)


def test_predictor_on_card_matches_cpu(dev):
    """The f32 forward on the card (both kernels) against the CPU (plain
    versions) on the same weights and images."""
    cfg = ModelConfig(img_size=64, patch_size=16, hidden_size=128,
                      num_layers=2, num_heads=2, mlp_dim=256, num_classes=5,
                      dtype="float32")
    params = vit.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    grays = [rng.integers(0, 256, (100 + 7 * i, 90), np.uint8)
             for i in range(3)]
    outs = [Predictor(params, cfg, batch_size=4, canvas_size=128,
                      placement="device", device=d).predict_arrays(grays)
            for d in ("cpu", "cuda")]
    np.testing.assert_allclose(outs[1].logits, outs[0].logits, atol=1e-4)


# ---------------------------------------------------------------------------
# Training kernels
# ---------------------------------------------------------------------------

# o and lse: _ATTN_TOL, absolute. Gradients relative to each one's largest
# magnitude: bf16 rounds P and dS before their products at other points
# than the plain version; f32 differs in summation order only.
_GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _rel(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def _heads_views(b, s, dtype, dev, seed=0):
    """q, k, v as [B, H, S, 64] views of one [B, S, 3, H, 64] product."""
    x = _randn((b, s, 3, 12, 64), dtype, dev, seed)
    return [t.transpose(1, 2) for t in x.unbind(2)]


@pytest.mark.parametrize("s", [37, 64, 65, 577])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_fwd_bwd_kernels_match_plain(dev, s, dtype):
    q, k, v = _heads_views(2, s, dtype, dev)
    do = _randn(q.shape, dtype, dev, seed=5)
    n_fwd, n_bwd = fa.flash_attention_fwd.launches, \
        fa.flash_attention_bwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n_fwd + 1
    assert fa.flash_attention_bwd.launches == n_bwd + 1
    ro, rlse = fa.attention_fwd_reference(q, k, v)
    assert lse.shape == (2, 12, s) and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), atol=_ATTN_TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, rlse, atol=_ATTN_TOL[dtype], rtol=0)
    for g, r in zip(grads, fa.attention_bwd_reference(q, k, v, o, lse, do)):
        assert g.dtype == dtype and g.shape == q.shape
        # [B, H, S, d] views of a [B, S, H, d] buffer
        assert g.transpose(1, 2).is_contiguous()
        assert _rel(g, r) <= _GRAD_TOL[dtype]


def test_attention_bwd_kernel_is_deterministic(dev):
    q, k, v = _heads_views(2, 577, torch.bfloat16, dev)
    do = _randn(q.shape, torch.bfloat16, dev, seed=5)
    o, lse = fa.flash_attention_fwd(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_autograd_on_card_matches_plain_autograd(dev, dtype):
    """FlashAttention (both training kernels) against plain autograd of
    attention_reference, with a non-contiguous upstream gradient."""
    q, k, v = (t.detach().requires_grad_()
               for t in _heads_views(2, 577, dtype, dev))
    go = _randn((2, 577, 12, 64), dtype, dev, seed=7).transpose(1, 2)
    fa.attention(q, k, v, inference=False).backward(go)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    fa.attention(q, k, v, impl="xla").backward(go)
    # bf16: plain autograd rounds the softmax output (not exp2's) to bf16
    # and keeps dS in f32, so the two differ by more than kernel vs plain
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-5}[dtype]
    for g, t in zip(got, (q, k, v)):
        assert _rel(g, t.grad) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_strongly_negative_rows(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    q = (3.5 + 0.1 * torch.randn((1, 2, 130, 64), generator=g, device=dev)
         ).to(dtype)
    k = torch.full((1, 2, 130, 64), -3.5, device=dev, dtype=dtype)
    v = _randn((1, 2, 130, 64), dtype, dev)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.attention_fwd_reference(q, k, v)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=_ATTN_TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, rlse, atol=_ATTN_TOL[dtype], rtol=1e-5)
    do = _randn(q.shape, dtype, dev, seed=2)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    ref = fa.attention_bwd_reference(q, k, v, o, lse, do)
    # one scale for the three: with every key equal, dQ = K·Σ dS is zero up
    # to rounding, and its own largest entry is no scale to measure against
    scale = max(r.float().abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        # lse ≈ −98: recomputing P from it costs ~1e-5 relative in f32
        err = (g.float() - r.float()).abs().max().item()
        assert err <= max(_GRAD_TOL[dtype], 1e-4) * scale


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows,d", [(36 * 577, 768), (37, 128)])
def test_layer_norm_bwd_kernel_matches_plain(dev, x_dtype, w_dtype, rows, d):
    x = _randn((rows, d), x_dtype, dev) * 3 + 1
    s = _randn((d,), w_dtype, dev, 1)
    dy = _randn((rows, d), x_dtype, dev, 2)
    before = ln.layer_norm_bwd_cuda.launches
    got = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    again = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd_cuda.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    ref = ln.layer_norm_bwd_reference(x, s, dy, 1e-12)
    assert [t.dtype for t in got] == [x_dtype, w_dtype, w_dtype]
    dx, rdx = got[0].float(), ref[0].float()
    if x_dtype == torch.float32:
        torch.testing.assert_close(dx, rdx, atol=1e-5, rtol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(rdx.abs().clamp_min(1e-30)))
                         - 7)
        assert ((dx - rdx).abs() <= ulp + 1e-5).all()
    for g, r in zip(got[1:], ref[1:]):
        g, r = g.float(), r.float()
        bound = 1e-5 * r.abs().max()
        if w_dtype == torch.bfloat16:     # plus one ulp of the cast
            bound = bound + torch.exp2(torch.floor(torch.log2(
                r.abs().clamp_min(1e-30))) - 7)
        assert ((g - r).abs() <= bound).all()


def test_layer_norm_autograd_on_card_uses_both_kernels(dev):
    x = (_randn((4, 577, 768), torch.bfloat16, dev) * 2).requires_grad_()
    s = _randn((768,), torch.float32, dev, 1).requires_grad_()
    b = _randn((768,), torch.float32, dev, 2).requires_grad_()
    n_fwd, n_bwd = ln.layer_norm_cuda.launches, ln.layer_norm_bwd_cuda.launches
    y = ln.layer_norm(x, s, b, 1e-12)
    y.float().square().sum().backward()
    assert ln.layer_norm_cuda.launches == n_fwd + 1
    assert ln.layer_norm_bwd_cuda.launches == n_bwd + 1
    dx, ds, db = ln.layer_norm_bwd_reference(
        x.detach(), s.detach(), (2 * y.float()).to(x.dtype), 1e-12)
    # dx rounds to bf16 once (one ulp is at most 2^-7 of the value); the
    # parameter gradients are f32 sums over 2308 rows
    torch.testing.assert_close(x.grad.float(), dx.float(), atol=1e-5,
                               rtol=2 ** -7)
    for got, r in ((s.grad, ds), (b.grad, db)):
        assert (got - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(dev, remat):
    """One f32 train step of a small ViT with every training kernel on the
    card against the same step on the CPU (plain versions)."""
    cfg = Config(model=ModelConfig(img_size=64, patch_size=16,
                                   hidden_size=128, num_layers=2,
                                   num_heads=2, mlp_dim=256, num_classes=5,
                                   dtype="float32", remat=remat),
                 train=TrainConfig(warmup_steps=1))
    cpu = vit.init_params(torch.Generator().manual_seed(0), cfg.model)
    card = bridge.params_from_jax(bridge.params_to_numpy(cpu),
                                  cfg.model).to(dev)
    rng = np.random.default_rng(0)
    batch = {"pixel_values": torch.from_numpy(
        rng.standard_normal((4, 64, 64, 3)).astype(np.float32)),
        "labels": torch.from_numpy(
            (rng.random((4, 5)) < 0.3).astype(np.float32))}
    out = []
    for params, device in ((cpu, "cpu"), (card, dev)):
        step = steps.make_train_step(cfg, 10)
        state = steps.TrainState.create(params, 0)
        for _ in range(2):
            state, m = step(state, {k: v.to(device) for k, v in batch.items()})
        out.append((m, bridge.grads_to_numpy(params),
                    bridge.params_to_numpy(params)))
    (mc, gc, pc), (mg, gg, pg) = out
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]),
                               rtol=1e-4)
    for key in gc:
        for a, b in zip(_leaves(gg[key]), _leaves(gc[key])):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-3)
    for key in pc:
        for a, b in zip(_leaves(pg[key]), _leaves(pc[key])):
            np.testing.assert_allclose(a, b, atol=1e-5)


def _leaves(tree):
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in _leaves(tree[k])]


def test_eval_step_on_card_matches_cpu(dev):
    cfg = Config(model=ModelConfig(img_size=64, patch_size=16,
                                   hidden_size=128, num_layers=2,
                                   num_heads=2, mlp_dim=256, num_classes=5,
                                   dtype="float32"))
    cpu = vit.init_params(torch.Generator().manual_seed(1), cfg.model)
    card = bridge.params_from_jax(bridge.params_to_numpy(cpu),
                                  cfg.model).to(dev)
    rng = np.random.default_rng(1)
    batch = {"pixel_values_u8": torch.from_numpy(
        rng.integers(0, 256, (6, 64, 64), np.uint8)),
        "labels": torch.from_numpy((rng.random((6, 5)) < 0.3)
                                   .astype(np.float32))}
    before = fa.flash_attention_inference.launches
    lg, rg = steps.make_eval_step(cfg)(
        card, {k: v.to(dev) for k, v in batch.items()})
    assert fa.flash_attention_inference.launches == before + 2
    lc, rc = steps.make_eval_step(cfg)(cpu, batch)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=1e-4)
    np.testing.assert_allclose(rg.cpu().numpy(), rc.numpy(), atol=1e-4)
