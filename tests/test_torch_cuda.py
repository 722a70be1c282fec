"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no NVIDIA GPU (the CPU
tests hold the plain versions against the JAX package instead). On a
machine with a card and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from chestxray_vit_tpu_torch import kernels
from chestxray_vit_tpu_torch.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.models import bridge, quantized, vit
from chestxray_vit_tpu_torch.ops import flash_attention as fa
from chestxray_vit_tpu_torch.ops import hidden_dropout as hd
from chestxray_vit_tpu_torch.ops import int8_matmul as i8
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


# tile edges of the 64-row tiles, a tail of one row, the training length,
# more tiles than the ring has stages
_BWD_LENGTHS = [1, 16, 37, 63, 64, 65, 127, 128, 129, 576, 577, 640, 1025]


@pytest.mark.parametrize("s", sorted({*_BWD_LENGTHS, 512}))
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


def _forward(kind, q, k, v):
    """The outputs of one forward entry point: the inference, training or
    dropout forward."""
    if kind == "inference":
        return (fa.flash_attention_inference(q, k, v),)
    if kind == "training":
        return fa.flash_attention_fwd(q, k, v)
    return fa.flash_attention_dropout_fwd(q, k, v, -123456789, 0.1,
                                          block_q=fa.auto_block_q(q.shape[2]))


@pytest.mark.parametrize("kind", ["inference", "training", "dropout"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [65, 577])
def test_attention_fwd_reads_nothing_past_s(dev, kind, dtype, s):
    """q, k, v as [:, :, :S] views of tensors 64 rows longer whose rows at
    or past S are NaN: the outputs are finite and equal, bit for bit, to
    those of contiguous copies (no copy reads a row past S, and no masked
    row reaches a sum)."""
    q, k, v = (_randn((2, 12, s + 64, 64), dtype, dev, seed=i)
               for i in range(3))
    for t in (q, k, v):
        t[:, :, s:] = float("nan")
    views = [t[:, :, :s] for t in (q, k, v)]
    got = _forward(kind, *views)
    ref = _forward(kind, *(t.contiguous() for t in views))
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_attention_fwd_kernel_is_deterministic(dev):
    q, k, v = _randn((3, 2, 12, 577, 64), torch.bfloat16, dev).unbind(0)
    o1, lse1 = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    """Every head dim runs: d = 136 (the wide kernels) and d = 20 (zero-
    padded to 24) equal their plain versions, forward and backward, in
    bf16 and f32. Refused still: other dtypes, and operands that need
    gradients outside the autograd functions."""
    for d in (136, 20):     # above 128; not a multiple of 8
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (_randn((1, 2, 40, d), dtype, dev, seed=i)
                           for i in range(4))
            out = fa.flash_attention_inference(q, k, v)
            o, lse = fa.flash_attention_fwd(q, k, v)
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
            ref_o, ref_lse = fa.attention_fwd_reference(q, k, v)
            ref = fa.attention_bwd_reference(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            assert out.shape == o.shape == (1, 2, 40, d)
            for got, want in ((out, ref_o), (o, ref_o), (lse, ref_lse),
                              *zip(grads, ref)):
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=_ATTN_TOL[dtype], rtol=0)
    q = _randn((1, 2, 40, 64), torch.float16, dev)
    with pytest.raises(TypeError):
        fa.flash_attention_inference(q, q, q)
    q = _randn((1, 2, 40, 64), torch.float32, dev).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        fa.flash_attention_inference(q, q, q)
    with pytest.raises(RuntimeError, match="autograd"):
        fa.flash_attention_fwd(q, q, q)


_LN_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


def _assert_ln_close(y, ref, x_dtype):
    """f32: 1e-5. bf16: one bf16 ulp (the f32 statistics may round either
    way at the end) plus 1e-5 for the f32 rounding of the affine step,
    which shows where x̂·scale and bias cancel to a small output."""
    ref = ref.float()
    if x_dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                         - 7)
        assert ((y.float() - ref).abs() <= ulp + 1e-5).all()


@pytest.mark.parametrize("x_dtype,w_dtype", _LN_PAIRS)
def test_layer_norm_kernel_matches_plain(dev, x_dtype, w_dtype):
    x = _randn((8 * 577, 768), x_dtype, dev) * 3 + 1
    s, b = _randn((768,), w_dtype, dev, 1), _randn((768,), w_dtype, dev, 2)
    before = ln.layer_norm_cuda.launches
    y = ln.layer_norm(x, s, b, 1e-12)
    torch.cuda.synchronize()
    assert ln.layer_norm_cuda.launches == before + 1
    _assert_ln_close(y, ln.layer_norm_reference(x, s, b, 1e-12), x_dtype)


# every rung of the forward's register ladder (16-byte vectors a lane: 1, 2,
# 3, 4, 6, 8 in bf16; f32 rows hold half the values, and past D = 1024 take
# the rungs of 12 and 16 vectors that read scale and bias where they use
# them: 1280 is ViT-H/14's width, in both dtypes)
_LN_WIDTHS = {torch.bfloat16: [16, 128, 512, 768, 1024, 1280, 1536, 2048],
              torch.float32: [16, 128, 512, 768, 1024, 1280, 1536, 2048]}


@pytest.mark.parametrize("rows", [1, 7, 32 * 577])
@pytest.mark.parametrize("x_dtype,w_dtype,d", [
    (x, w, d) for x, w in _LN_PAIRS for d in _LN_WIDTHS[x]])
def test_layer_norm_kernel_matches_plain_at_every_width(dev, x_dtype, w_dtype,
                                                        d, rows):
    x = _randn((rows, d), x_dtype, dev) * 3 + 1
    s, b = _randn((d,), w_dtype, dev, 1), _randn((d,), w_dtype, dev, 2)
    y = ln.layer_norm_cuda(x, s, b, 1e-12)
    torch.cuda.synchronize()
    _assert_ln_close(y, ln.layer_norm_reference(x, s, b, 1e-12), x_dtype)


@pytest.mark.parametrize("x_dtype,w_dtype", _LN_PAIRS)
@pytest.mark.parametrize("rows,d", [(1, 768), (7, 768), (65, 16),
                                    (1000, 128), (65, 50), (37, 1001),
                                    (37, 2560), (5, 9000)])
def test_layer_norm_fwd_reads_and_writes_no_row_past_the_last(
        dev, x_dtype, w_dtype, rows, d):
    """The forward entry point on the first ``rows`` rows of buffers that
    hold three more: NaN after the input, a sentinel after the output; on
    the rungs and in each branch of the any-D forward (50: a warp a row;
    1001: a block a row off the vector; 2560: a block a row of whole
    vectors, bf16; 9000: the row read once a pass, bf16)."""
    x = torch.full((rows + 3, d), float("nan"), device=dev, dtype=x_dtype)
    x[:rows] = _randn((rows, d), x_dtype, dev) * 3 + 1
    s, b = _randn((d,), w_dtype, dev, 1), _randn((d,), w_dtype, dev, 2)
    y = torch.full((rows + 3, d), 7.0, device=dev, dtype=x_dtype)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    kernels.check(kernels.library().cxr_layer_norm_fwd(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d,
        1e-12, codes[x_dtype], codes[w_dtype], dev.index or 0,
        torch.cuda.current_stream().cuda_stream), "layer_norm")
    torch.cuda.synchronize()
    _assert_ln_close(y[:rows], ln.layer_norm_reference(x[:rows], s, b, 1e-12),
                     x_dtype)
    assert bool((y[rows:] == 7.0).all())


# the any-D widths of test_layer_norm_kernel_at_any_width; those past
# 16392 at 1 and 37 rows only, to keep the run short
_ANY_WIDTHS = [50, 250, 255, 256, 258, 1001, 2056, 2560, 4096, 4100, 6144,
               8192, 8200, 9000, 16390, 16392, 32768, 32772, 65536, 65544]


@pytest.mark.parametrize("d,rows", [(d, rows) for d in _ANY_WIDTHS
                                    for rows in (1, 37, 8 * 577)
                                    if d <= 16392 or rows < 8 * 577])
@pytest.mark.parametrize("x_dtype,w_dtype", _LN_PAIRS)
def test_layer_norm_kernel_at_any_width(dev, x_dtype, w_dtype, d, rows):
    """Widths off the 16-byte vector (50, 250, 255: a warp a row, 2 and 8
    elements a lane; 258, 1001: a block a row, 2 and 4 elements a thread)
    and past the register rungs (2056, 2560, 6144, bf16 8192, f32 4096: a
    block a row from registers, 2-4 vectors a thread), with 256 on the
    rungs beside them; past those (forward: ``ln_fwd_rowloop``; backward: a
    cluster of k blocks a row of whole vectors, ``ln_bwd_cluster``) at each
    branch and edge of k: bf16 8200 and 9000 (k = 2), 16392 (3), 32768
    (4), 65536 (8); f32 4100 to 8192 (2), 8200 and 9000 (3), 16392 (5),
    32768 (8); off the vector past 4096 and past a cluster of eight the
    two-pass form (bf16 4100, 16390 and 32772 off the vector, and 65544;
    f32 16390 off the vector, 32772, 65536 and 65544); forward
    and backward, against the plain versions (dscale and dbias 1e-5 of the
    largest, plus one ulp in bf16), the bits of both the same twice; at
    one row, at 37 (fewer blocks than a wave, the last one short of the
    others' rows) and at the b8 serving rows (up to 16392 columns)."""
    x = _randn((rows, d), x_dtype, dev) * 3 + 1
    s, b = _randn((d,), w_dtype, dev, 1), _randn((d,), w_dtype, dev, 2)
    dy = _randn((rows, d), x_dtype, dev, 3)
    y = ln.layer_norm_cuda(x, s, b, 1e-12)
    y_again = ln.layer_norm_cuda(x, s, b, 1e-12)
    got = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    again = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    ref = ln.layer_norm_bwd_reference(x, s, dy, 1e-12)
    torch.cuda.synchronize()
    _assert_ln_close(y, ln.layer_norm_reference(x, s, b, 1e-12), x_dtype)
    assert torch.equal(y, y_again)
    _assert_ln_close(got[0], ref[0], x_dtype)
    for g, r in zip(got[1:], ref[1:]):
        r = r.float()
        bound = 1e-5 * r.abs().max()
        if w_dtype == torch.bfloat16:
            bound = bound + torch.exp2(torch.floor(torch.log2(
                r.abs().clamp_min(1e-30))) - 7)
        assert ((g.float() - r).abs() <= bound).all()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


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


def _assert_grads_close(grads, refs, dtype, s):
    """Each gradient within _GRAD_TOL of its plain version, relative to the
    plain version's largest magnitude. At S = 1 the softmax is the constant
    1, so dQ and dK are zero up to rounding and no scale of their own: the
    three are then measured against the largest of the three."""
    scale = max(r.float().abs().max().item() for r in refs)
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and g.shape == r.shape
        # [B, H, S, d] views of a [B, S, H, d] buffer
        assert g.transpose(1, 2).is_contiguous()
        assert torch.isfinite(g).all()
        if s == 1:
            err = (g.float() - r.float()).abs().max().item() / scale
        else:
            err = _rel(g, r)
        assert err <= _GRAD_TOL[dtype]


@pytest.mark.parametrize("s", _BWD_LENGTHS)
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
    _assert_grads_close(grads, fa.attention_bwd_reference(q, k, v, o, lse,
                                                          do), dtype, s)


@pytest.mark.parametrize("mode", [5, 6])
@pytest.mark.parametrize("rows", [64, 48, 17, 1])
def test_16_wide_tiles_multiply_like_matmul(dev, mode, rows):
    """The 32-byte swizzled 64 x 16 tiles of the forward at kD = 80
    (columns 64-79 of a head dim of 80), alone, against torch.matmul in
    f32. mode 5: A Bᵀ (64 x 64 x 16) with A and B [64, 16] through
    K-major descriptors, the one 16-deep step S = Q Kᵀ adds for them;
    mode 6: A B (64 x 16 x 64) with A as register fragments and B [64, 16]
    in the transposed (MN-major) form, m64n16k16, only the k-steps that
    reach one of B's first ``rows`` rows: O += P V on V's 16 columns."""
    a = _randn((64, 16 if mode == 5 else 64), torch.bfloat16, dev, seed=1)
    b = _randn((64, 16), torch.bfloat16, dev, seed=2)
    c = torch.full((64, 64 if mode == 5 else 16), float("nan"), device=dev)
    kernels.check(kernels.library().cxr_tile_mma_selftest(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), mode, rows, dev.index or 0,
        torch.cuda.current_stream().cuda_stream), "tile_mma_selftest")
    torch.cuda.synchronize()
    bz = b.float()
    bz[rows:] = 0
    ref = a.float() @ (bz.t() if mode == 5 else bz)
    torch.testing.assert_close(c, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 7])
@pytest.mark.parametrize("rows", [64, 48, 17, 1])
def test_tile_helpers_multiply_like_matmul(dev, mode, rows):
    """The kernels' tile machinery alone (cp.async into 128-byte swizzled
    tiles, B through a wgmma descriptor): a known A times a known B, B whole
    and with only its first rows present, against torch.matmul. bf16, in
    f32: mode 0: A Bᵀ (64 x 64 x 64), A as ldmatrix fragments, B K-major;
    mode 1: A B, B in the transposed (MN-major) form, only the k-steps that
    reach a row of B; mode 2: A Bᵀ with A through a descriptor too. bf16
    products are exact in f32 and 64 of them sum to within a few f32 ulps of
    O(10). int8, exactly, against the int64 product: mode 3: A Bᵀ with A and
    B [64, 128] int8 tiles through the int8 kernel's s8 wgmma (m64n128k32,
    B's tile 128 rows, those past ``rows`` zero-filled); mode 4: the same
    on the first 64 of the 128 bytes of k (a half k tile). mode 7: mode 1
    with A's fragments stored into a tile (``store_a_swizzled``) and read
    back first, the wide backward's hand-over of P and dS."""
    if mode in (3, 4):
        g = torch.Generator(device=dev).manual_seed(1)
        a, b = (torch.randint(-128, 128, (64, 128), generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
        c = torch.full((64, 64), -12345, device=dev, dtype=torch.int32)
    else:
        a = _randn((64, 64), torch.bfloat16, dev, seed=1)
        b = _randn((64, 64), torch.bfloat16, dev, seed=2)
        c = torch.full((64, 64), float("nan"), device=dev)
    kernels.check(kernels.library().cxr_tile_mma_selftest(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), mode, rows, dev.index or 0,
        torch.cuda.current_stream().cuda_stream), "tile_mma_selftest")
    torch.cuda.synchronize()
    if mode in (3, 4):
        k = 128 if mode == 3 else 64
        a64, b64 = a.long().cpu()[:, :k], b.long().cpu()[:, :k]
        b64[rows:] = 0
        assert torch.equal(c.cpu().long(), a64 @ b64.t())
        return
    bz = b.float()
    bz[rows:] = 0
    ref = a.float() @ (bz if mode in (1, 7) else bz.t())
    torch.testing.assert_close(c, ref, atol=1e-4, rtol=0)


def _bwd_into(bufs, s, dtype, dropout=None):
    """The dense backward entry point on the first ``s`` rows of operands
    and outputs that are [B, H, S_buf, 64] views of larger buffers."""
    q, k, v, o, do, dq, dk, dv = bufs
    b, h = q.shape[:2]
    lse = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = [st for t in bufs for st in t.stride()[:3]]
    strides_c = (ctypes.c_longlong * len(strides))(*strides)
    args = (*(t.data_ptr() for t in (q, k, v, o, do)), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, s, 64, ctypes.addressof(strides_c), 0.125)
    tail = ({torch.float32: 0, torch.bfloat16: 1}[dtype], q.device.index,
            torch.cuda.current_stream().cuda_stream)
    lib = kernels.library()
    if dropout is None:
        err = lib.cxr_attention_bwd(*args, *tail)
    else:
        err = lib.cxr_attention_bwd_dropout(*args, *dropout, *tail)
    kernels.check(err, "attention_bwd")
    torch.cuda.synchronize()


@pytest.mark.parametrize("s", [1, 63, 65, 129])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bwd_passes_leave_rows_past_s_untouched(dev, s, dtype,
                                                          rate):
    """dQ (the dQ pass), dK and dV (the dK/dV pass) of the first S rows of
    buffers 192 rows long: every row at or past S keeps its sentinel, every
    row below S is written, and rows past S of the inputs are never part of
    the result (NaN there would spread)."""
    s_buf = 192
    bufs = [_randn((2, s_buf, 3, 64), dtype, dev, seed=i).transpose(1, 2)
            for i in range(5)]
    for t in bufs:
        t[:, :, s:] = float("nan")
    sentinel = 12345.0
    outs = [torch.full((2, s_buf, 3, 64), sentinel, dtype=dtype, device=dev
                       ).transpose(1, 2) for _ in range(3)]
    dropout = None
    if rate:
        # bh_base 0, the call's 3 heads of 3 from head 0, 1 / (1 - rate)
        dropout = (*fa.dropout_constants(-123456789, rate),
                   *fa.mask_strides(s, fa.auto_block_q(s)), 0, 3, 0,
                   1.0 / (1.0 - rate))
    _bwd_into([*bufs, *outs], s, dtype, dropout)
    for g in outs:
        assert (g[:, :, s:] == sentinel).all()
        assert torch.isfinite(g[:, :, :s]).all()
        assert (g[:, :, :s] != sentinel).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_bwd_reads_a_strided_upstream_gradient(dev, dtype):
    """dO as a [B, H, S, d] view of a [B, S, H, d] tensor (what the output
    projection's backward hands over) is read in place and gives what its
    contiguous copy gives, bit for bit."""
    q, k, v = _heads_views(2, 577, dtype, dev)
    do = _randn((2, 577, 12, 64), dtype, dev, seed=5).transpose(1, 2)
    assert not do.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _assert_grads_close(a, fa.attention_bwd_reference(q, k, v, o, lse, do),
                        dtype, 577)


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


def _assert_ln_bwd_close(got, ref, x_dtype, w_dtype):
    """dx as the forward's output (1 bf16 ulp + 1e-5, or 1e-5 in f32);
    dscale and dbias, sums over the rows in another order, within 1e-5 of
    the largest (plus one ulp of each element when cast to bf16)."""
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


def _ln_bwd_inputs(rows, d, x_dtype, w_dtype, dev):
    return (_randn((rows, d), x_dtype, dev) * 3 + 1,
            _randn((d,), w_dtype, dev, 1), _randn((rows, d), x_dtype, dev, 2))


@pytest.mark.parametrize("x_dtype,w_dtype", _LN_PAIRS)
@pytest.mark.parametrize("rows,d", [(36 * 577, 768), (37, 128)])
def test_layer_norm_bwd_kernel_matches_plain(dev, x_dtype, w_dtype, rows, d):
    x, s, dy = _ln_bwd_inputs(rows, d, x_dtype, w_dtype, dev)
    before = ln.layer_norm_bwd_cuda.launches
    got = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    again = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd_cuda.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    _assert_ln_bwd_close(got, ln.layer_norm_bwd_reference(x, s, dy, 1e-12),
                         x_dtype, w_dtype)


# every rung of the backward's register ladder (16-byte vectors a lane: 1,
# 2, 3, 4, 6, 8, and in f32 12 and 16 with the sums in shared memory),
# D = 8 (one lane of a warp busy) and D = 520 (a rung's last vectors on
# some lanes only); 1280 is ViT-H/14's width, in both dtypes
_LN_BWD_WIDTHS = {torch.bfloat16: [8, 256, 512, 520, 768, 1024, 1280, 1536,
                                   2048],
                  torch.float32: [8, 128, 256, 384, 512, 520, 768, 1024,
                                  1280, 1544, 2048]}


@pytest.mark.parametrize("rows", [1, 7, 32 * 577])
@pytest.mark.parametrize("x_dtype,w_dtype,d", [
    (x, w, d) for x, w in _LN_PAIRS for d in _LN_BWD_WIDTHS[x]])
def test_layer_norm_bwd_kernel_matches_plain_at_every_width(
        dev, x_dtype, w_dtype, d, rows):
    x, s, dy = _ln_bwd_inputs(rows, d, x_dtype, w_dtype, dev)
    got = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    torch.cuda.synchronize()
    _assert_ln_bwd_close(got, ln.layer_norm_bwd_reference(x, s, dy, 1e-12),
                         x_dtype, w_dtype)


@pytest.mark.parametrize("x_dtype,w_dtype", _LN_PAIRS)
@pytest.mark.parametrize("rows,d", [(1, 768), (7, 768), (65, 16),
                                    (1000, 128)])
@pytest.mark.parametrize("blocks", ["wave", 1, 3000])
def test_layer_norm_bwd_writes_no_row_past_the_last(dev, x_dtype, w_dtype,
                                                    rows, d, blocks):
    """The backward entry point on the first ``rows`` rows of buffers that
    hold three more (NaN after x and dy, a sentinel after dx), with the
    wrapper's block count, one block, and more blocks than rows."""
    x = torch.full((rows + 3, d), float("nan"), device=dev, dtype=x_dtype)
    dy = x.clone()
    x[:rows], s, dy[:rows] = _ln_bwd_inputs(rows, d, x_dtype, w_dtype, dev)
    dx = torch.full((rows + 3, d), 7.0, device=dev, dtype=x_dtype)
    n_blocks = ln._bwd_blocks(x, s, rows) if blocks == "wave" else blocks
    work = torch.empty((n_blocks, 2, d), device=dev)
    ds, db = (torch.empty(d, device=dev, dtype=w_dtype) for _ in range(2))
    codes = {torch.float32: 0, torch.bfloat16: 1}
    kernels.check(kernels.library().cxr_layer_norm_bwd(
        x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ds.data_ptr(), db.data_ptr(), work.data_ptr(), rows, d, 1e-12,
        n_blocks, codes[x_dtype], codes[w_dtype], dev.index or 0,
        torch.cuda.current_stream().cuda_stream), "layer_norm_bwd")
    torch.cuda.synchronize()
    _assert_ln_bwd_close(
        (dx[:rows], ds, db),
        ln.layer_norm_bwd_reference(x[:rows], s, dy[:rows], 1e-12),
        x_dtype, w_dtype)
    assert bool((dx[rows:] == 7.0).all())


@pytest.mark.parametrize("x_dtype,w_dtype", _LN_PAIRS)
@pytest.mark.parametrize("rows,d", [(5, 9000), (37, 6144), (7, 4100),
                                    (3, 32772), (2, 65544)])
def test_layer_norm_bwd_reads_and_writes_no_row_past_the_last(
        dev, x_dtype, w_dtype, rows, d):
    """The backward entry point on the first ``rows`` rows of buffers that
    hold three more (NaN after x and dy, a sentinel after dx), with the
    wrapper's block count and workspace, past ln_bwd_any's widths: a
    cluster of blocks a row (bf16 9000, f32 6144) and the two-pass form
    (bf16 4100 off the vector, 32772, 65544)."""
    x = torch.full((rows + 3, d), float("nan"), device=dev, dtype=x_dtype)
    dy = x.clone()
    x[:rows], s, dy[:rows] = _ln_bwd_inputs(rows, d, x_dtype, w_dtype, dev)
    dx = torch.full((rows + 3, d), 7.0, device=dev, dtype=x_dtype)
    n_blocks = ln._bwd_blocks(x, s, rows)
    work = ln._bwd_workspace(n_blocks, rows, d, x_dtype, dev)
    ds, db = (torch.empty(d, device=dev, dtype=w_dtype) for _ in range(2))
    codes = {torch.float32: 0, torch.bfloat16: 1}
    kernels.check(kernels.library().cxr_layer_norm_bwd(
        x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ds.data_ptr(), db.data_ptr(), work.data_ptr(), rows, d, 1e-12,
        n_blocks, codes[x_dtype], codes[w_dtype], dev.index or 0,
        torch.cuda.current_stream().cuda_stream), "layer_norm_bwd")
    torch.cuda.synchronize()
    _assert_ln_bwd_close(
        (dx[:rows], ds, db),
        ln.layer_norm_bwd_reference(x[:rows], s, dy[:rows], 1e-12),
        x_dtype, w_dtype)
    assert bool((dx[rows:] == 7.0).all())


def test_layer_norm_bwd_launch_makes_one_library_call(dev, monkeypatch):
    """After the first call at a width and dtypes (which finds the wave), a
    backward launch makes one ctypes call: the kernel's entry point."""
    x, s, dy = _ln_bwd_inputs(32 * 257, 1280, torch.bfloat16, torch.bfloat16,
                              dev)
    first = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    lib, calls = kernels.library(), []

    class Counting:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(kernels, "library", Counting)
    again = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    torch.cuda.synchronize()
    assert calls == ["cxr_layer_norm_bwd"]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel_is_deterministic_at_the_packed_rows(dev,
                                                                  w_dtype):
    x, s, dy = _ln_bwd_inputs(32 * 1152, 768, torch.bfloat16, w_dtype, dev)
    got = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    again = ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_ln_bwd_close(got, ln.layer_norm_bwd_reference(x, s, dy, 1e-12),
                         torch.bfloat16, w_dtype)


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


# ---------------------------------------------------------------------------
# Attention-dropout kernels
# ---------------------------------------------------------------------------

_RATE, _SEED = 0.1, -123456789      # a negative int32 seed, as JAX allows


@pytest.mark.parametrize("s", [37, 64, 65, 129, 577, 1025])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block_q", [0, 32])
def test_dropout_debug_kernel_mask_is_keep_mask(dev, s, dtype, block_q):
    """The mask the debug kernel applied equals the plain counter hash bit
    for bit, single-block (auto) and multi-block (32-row) row strides."""
    block_q = block_q or fa.auto_block_q(s)
    q, k, v = _heads_views(2, s, dtype, dev)
    before = fa.flash_attention_dropout_debug.launches
    o, keep = fa.flash_attention_dropout_debug(q, k, v, _SEED, _RATE,
                                               block_q=block_q)
    torch.cuda.synchronize()
    assert fa.flash_attention_dropout_debug.launches == before + 1
    ref_keep = fa._keep(q, _SEED, _RATE, block_q)
    assert keep.dtype == torch.bool and keep.shape == (2, 12, s, s)
    assert int((keep != ref_keep).sum()) == 0
    ro, _ = fa.attention_dropout_fwd_reference(q, k, v, _SEED, _RATE,
                                               block_q=block_q)
    torch.testing.assert_close(o.float(), ro.float(), atol=_ATTN_TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("row_base", [1, 100_000])
def test_dropout_debug_kernel_mask_at_a_row_base(dev, row_base):
    """With a row base the debug kernel's mask is keep_mask's at that base
    (rows 2-3 of a batch of 4 hold the global mask's rows there), and a
    large base wraps the uint32 counter as the plain hash does."""
    q, k, v = _heads_views(4, 577, torch.bfloat16, dev)
    bq = fa.auto_block_q(577)
    _, whole = fa.flash_attention_dropout_debug(q, k, v, _SEED, _RATE,
                                                block_q=bq)
    _, part = fa.flash_attention_dropout_debug(q[2:], k[2:], v[2:], _SEED,
                                               _RATE, block_q=bq, row_base=2)
    torch.cuda.synchronize()
    assert torch.equal(part, whole[2:])
    _, keep = fa.flash_attention_dropout_debug(q, k, v, _SEED, _RATE,
                                               block_q=bq, row_base=row_base)
    ref = fa._keep(q, _SEED, _RATE, bq, row_base)
    assert int((keep != ref).sum()) == 0


@pytest.mark.parametrize("packed", [False, True])
def test_dropout_kernels_split_equals_whole(dev, packed):
    """Forward and backward over batch rows 1-2 with row base 1 equal rows
    1-2 of the call over the whole batch of 3, bit for bit."""
    q, k, v = _heads_views(3, 577, torch.bfloat16, dev)
    do = _randn(q.shape, torch.bfloat16, dev, seed=5)
    if packed:
        seg = torch.zeros((3, 577), dtype=torch.int32, device=dev)
        seg[:, 300:] = 1
        bq = fa.packed_block_q(577)
        fwd = lambda sl, base: fa.flash_attention_packed_dropout_fwd(  # noqa
            q[sl], k[sl], v[sl], seg[sl].contiguous(), _SEED, _RATE, None,
            bq, base)
        bwd = lambda sl, o, lse, base: fa.flash_attention_packed_dropout_bwd(  # noqa
            q[sl], k[sl], v[sl], seg[sl].contiguous(), o, lse, do[sl], _SEED,
            _RATE, None, bq, base)
    else:
        bq = fa.auto_block_q(577)
        fwd = lambda sl, base: fa.flash_attention_dropout_fwd(  # noqa
            q[sl], k[sl], v[sl], _SEED, _RATE, None, bq, base)
        bwd = lambda sl, o, lse, base: fa.flash_attention_dropout_bwd(  # noqa
            q[sl], k[sl], v[sl], o, lse, do[sl], _SEED, _RATE, None, bq,
            base)
    whole = slice(0, 3)
    o, lse = fwd(whole, 0)
    grads = bwd(whole, o, lse, 0)
    sl = slice(1, 3)
    o2, lse2 = fwd(sl, 1)
    grads2 = bwd(sl, o[sl], lse[sl].contiguous(), 1)
    torch.cuda.synchronize()
    assert torch.equal(o2, o[sl]) and torch.equal(lse2, lse[sl])
    assert all(torch.equal(a, b[sl]) for a, b in zip(grads2, grads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(36, 577, 768), (3, 7, 5)],
                         ids=["b36", "ragged"])
def test_hidden_dropout_kernel_equals_plain(dev, dtype, shape):
    """The kernel equals its plain version bit for bit, forward and
    backward (the backward is the same kernel on the upstream gradient),
    at a row base, also where the elements are no whole 16-byte vectors
    (the element-wise path) and on a misaligned view."""
    x = _randn(shape, dtype, dev, seed=3)
    before = hd.hidden_dropout_cuda.launches
    y = hd.hidden_dropout_cuda(x, 4321, 0.1, row_base=18)
    torch.cuda.synchronize()
    assert hd.hidden_dropout_cuda.launches == before + 1
    assert torch.equal(y, hd.hidden_dropout_reference(x, 4321, 0.1, 18))
    xg = x.detach().clone().requires_grad_()
    dy = _randn(shape, dtype, dev, seed=4)
    hd.hidden_dropout(xg, 4321, 0.1, row_base=18).backward(dy)
    assert torch.equal(xg.grad, hd.hidden_dropout_reference(dy, 4321, 0.1,
                                                            18))
    flat = _randn((x.numel() + 1,), dtype, dev, seed=5)
    view = flat[1:].view(shape)             # 2 or 4 bytes off a vector
    assert torch.equal(hd.hidden_dropout_cuda(view, 7, 0.3),
                       hd.hidden_dropout_reference(view, 7, 0.3))


@pytest.mark.parametrize("s", _BWD_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_fwd_bwd_kernels_match_plain(dev, s, dtype):
    q, k, v = _heads_views(2, s, dtype, dev)
    do = _randn(q.shape, dtype, dev, seed=5)
    bq = fa.auto_block_q(s)
    n_fwd = fa.flash_attention_dropout_fwd.launches
    n_bwd = fa.flash_attention_dropout_bwd.launches
    o, lse = fa.flash_attention_dropout_fwd(q, k, v, _SEED, _RATE,
                                            block_q=bq)
    grads = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, _SEED,
                                           _RATE, block_q=bq)
    torch.cuda.synchronize()
    assert fa.flash_attention_dropout_fwd.launches == n_fwd + 1
    assert fa.flash_attention_dropout_bwd.launches == n_bwd + 1
    ro, rlse = fa.attention_dropout_fwd_reference(q, k, v, _SEED, _RATE,
                                                  block_q=bq)
    torch.testing.assert_close(o.float(), ro.float(), atol=_ATTN_TOL[dtype],
                               rtol=0)
    # lse is the clean softmax's, the dense forward's
    torch.testing.assert_close(lse, rlse, atol=_ATTN_TOL[dtype], rtol=0)
    refs = fa.attention_dropout_bwd_reference(q, k, v, o, lse, do, _SEED,
                                              _RATE, block_q=bq)
    _assert_grads_close(grads, refs, dtype, s)


def test_dropout_bwd_kernel_is_deterministic_and_seeded(dev):
    q, k, v = _heads_views(2, 577, torch.bfloat16, dev)
    do = _randn(q.shape, torch.bfloat16, dev, seed=5)
    o, lse = fa.flash_attention_dropout_fwd(q, k, v, _SEED, _RATE)
    a = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, _SEED, _RATE)
    b = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, _SEED, _RATE)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    o2, _ = fa.flash_attention_dropout_fwd(q, k, v, _SEED + 1, _RATE)
    assert not torch.equal(o, o2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_autograd_on_card_matches_plain_autograd(dev, dtype):
    """FlashAttentionDropout against plain autograd of the plain forward on
    the same mask, with a non-contiguous upstream gradient."""
    q, k, v = (t.detach().requires_grad_()
               for t in _heads_views(2, 577, dtype, dev))
    go = _randn((2, 577, 12, 64), dtype, dev, seed=7).transpose(1, 2)
    fa.attention_dropout(q, k, v, _SEED, _RATE).backward(go)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    fa.attention_dropout(q, k, v, _SEED, _RATE, impl="xla").backward(go)
    # as test_attention_autograd_on_card_matches_plain_autograd
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-5}[dtype]
    for g, t in zip(got, (q, k, v)):
        assert _rel(g, t.grad) <= tol


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_with_attention_dropout_on_card_matches_cpu(dev, remat):
    """One f32 train step with attention and hidden dropout through the
    dropout kernels on the card against the CPU's plain versions, on the
    same seeds: the counter-hash masks are equal on both sides."""
    cfg = Config(model=ModelConfig(img_size=64, patch_size=16,
                                   hidden_size=128, num_layers=2,
                                   num_heads=2, mlp_dim=256, num_classes=5,
                                   dtype="float32", remat=remat,
                                   attention_dropout=0.2,
                                   hidden_dropout=0.2),
                 train=TrainConfig(warmup_steps=1))
    cpu = vit.init_params(torch.Generator().manual_seed(0), cfg.model)
    card = bridge.params_from_jax(bridge.params_to_numpy(cpu),
                                  cfg.model).to(dev)
    rng = np.random.default_rng(0)
    batch = {"pixel_values": torch.from_numpy(
        rng.standard_normal((4, 64, 64, 3)).astype(np.float32)),
        "labels": torch.from_numpy(
            (rng.random((4, 5)) < 0.3).astype(np.float32))}
    draws = [steps.draw(torch.Generator().manual_seed(9), cfg, 4)]
    n_fwd = fa.flash_attention_dropout_fwd.launches
    n_hidden = hd.hidden_dropout_cuda.launches
    out = []
    for params, device in ((cpu, "cpu"), (card, dev)):
        state, m = steps.make_train_step(cfg, 10)(
            steps.TrainState.create(params, 0),
            {k: v.to(device) for k, v in batch.items()}, draws)
        out.append((m, bridge.grads_to_numpy(params)))
    assert fa.flash_attention_dropout_fwd.launches - n_fwd == (
        4 if remat else 2)
    # two sites a layer, forward and backward, and under remat the first
    # again (the recompute stops before the block's closing dropout)
    assert hd.hidden_dropout_cuda.launches - n_hidden == (
        10 if remat else 8)
    (mc, gc), (mg, gg) = out
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               atol=1e-5)
    for key in gc:
        for a, b in zip(_leaves(gg[key]), _leaves(gc[key])):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# The int8 kernel and the int8 serving paths
# ---------------------------------------------------------------------------

def _int8_operands(dev, m, k, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rint8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    scale = (torch.rand(n, generator=g, device=dev) + 0.5) \
        / (127.0 * 127.0 * k ** 0.5)
    return (rint8(m, k), rint8(n, k), scale,
            torch.randn(n, generator=g, device=dev) * 0.1,
            torch.randn(m, n, generator=g, device=dev))


def _int8_call(dev, m, k, n, form, seed=0):
    """(kernel output, plain output) of one call form on seeded operands."""
    xq, wq, scale, bias, resid = _int8_operands(dev, m, k, n, seed)
    if form == "sums_i32":          # the raw int32 sums, no epilogue
        before = i8.int8_matmul_fused.launches
        out = i8.int8_matmul_fused(xq, wq, out_dtype=torch.int32)
        assert i8.int8_matmul_fused.launches == before + 1
        return out, i8.int8_matmul_fused_reference(xq, wq,
                                                   out_dtype=torch.int32)
    dtype = torch.float32 if form.endswith("f32") else torch.bfloat16
    kw = {"out_dtype": dtype}
    if form.startswith("resid"):
        kw["resid"] = resid.to(dtype)
    if form == "gelu_requant":
        kw.update(gelu=True, out_quant_scale=torch.tensor(0.02, device=dev))
    before = i8.int8_matmul_fused.launches
    out = i8.int8_matmul_fused(xq, wq, scale, bias, **kw)
    assert i8.int8_matmul_fused.launches == before + 1
    return out, i8.int8_matmul_fused_reference(xq, wq, scale, bias, **kw)


# rows: the batch-32 serving rows (144 tiles of 128 and a 32-row tail), a
# few images, one tile, one tile and a row, a few rows. k, n: the model's
# products, K = 192 (one and a half 128-byte k tiles) and 64 (half a tile),
# N = 64 (half an output tile) and 136 (a tile and 8 columns: N % 16 = 8)
@pytest.mark.parametrize("m", [32 * 577, 3 * 577, 64, 65, 5])
@pytest.mark.parametrize("k,n", [(192, 768), (768, 768), (768, 3072),
                                 (3072, 768), (64, 768), (768, 64),
                                 (768, 136), (192, 136), (64, 64)])
@pytest.mark.parametrize("form", ["plain", "resid", "gelu_requant",
                                  "plain_f32", "resid_f32", "sums_i32"])
def test_int8_kernel_matches_plain(dev, m, k, n, form):
    """Every output equals the plain version's, int8 and the int32 sums
    included: the integer sums are exact and the epilogue rounds at the
    same points, its exp2f included (libdevice's, as PyTorch's exp2 on the
    card)."""
    out, ref = _int8_call(dev, m, k, n, form)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == (m, n)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("form", ["resid", "gelu_requant"])
def test_int8_kernel_is_deterministic(dev, form):
    """Two calls on the same operands give equal bits."""
    first, _ = _int8_call(dev, 32 * 577, 768, 3072, form)
    again, _ = _int8_call(dev, 32 * 577, 768, 3072, form)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_int8_kernel_refuses_what_it_does_not_take(dev):
    """K off 64 (zero-padded by the wrapper) and N off 8 (the tail
    epilogue) run and equal the plain version on the CPU; the dtype,
    residual, layout and int32-form refusals stay."""
    xq, wq, scale, bias, resid = _int8_operands(dev, 40, 768, 64)
    for x, w, n in ((xq[:, :100].contiguous(), wq[:, :100].contiguous(), 64),
                    (xq, wq[:60].contiguous(), 60)):
        out = i8.int8_matmul_fused(x, w, scale[:n], bias[:n])
        assert out.shape == (40, n)
        assert torch.equal(out.cpu(), i8.int8_matmul_fused_reference(
            x.cpu(), w.cpu(), scale[:n].cpu(), bias[:n].cpu()))
    with pytest.raises(TypeError):
        i8.int8_matmul_fused(xq.float(), wq, scale, bias)
    with pytest.raises(ValueError, match="resid"):
        i8.int8_matmul_fused(xq, wq, scale, bias, resid=resid)   # f32, bf16 out
    with pytest.raises(ValueError, match="contiguous"):
        i8.int8_matmul_fused(xq.t().contiguous().t(), wq, scale, bias)
    with pytest.raises(ValueError, match="takes no scale, bias"):
        i8.int8_matmul_fused(xq, wq, scale, bias, out_dtype=torch.int32)
    # the launch itself refuses an epilogue operand with the int32 out
    # code (3), and a missing scale with any other
    out = torch.empty((40, 64), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    lib = kernels.library()
    for sc, bi, code in ((scale, None, 3), (None, bias, 3), (None, None, 0)):
        assert lib.cxr_int8_matmul_fused(
            xq.data_ptr(), wq.data_ptr(),
            sc.data_ptr() if sc is not None else None,
            bi.data_ptr() if bi is not None else None, None, None,
            out.data_ptr(), 40, 64, 768, 0, code, -1, dev.index or 0,
            stream) != 0


def test_int8_kernel_at_patch14_k(dev):
    """K = 3 · 14 · 14 = 588 (a patch-14 patch embedding): as it is (the
    wrapper pads it) and with both operands zero-padded to 640 (pad_k),
    equal, bit for bit, to the plain version on the unpadded operands (on
    the CPU)."""
    xq, wq, scale, bias, _ = _int8_operands(dev, 8 * 256, 588, 1280)
    out = i8.int8_matmul_fused(i8.pad_k(xq), i8.pad_k(wq), scale, bias)
    ref = i8.int8_matmul_fused_reference(xq.cpu(), wq.cpu(), scale.cpu(),
                                         bias.cpu())
    assert i8.pad_k(xq).shape == (8 * 256, 640)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(i8.int8_matmul_fused(xq, wq, scale, bias), out)


@pytest.mark.parametrize("n", [50, 100, 130])
@pytest.mark.parametrize("form", ["plain", "resid", "gelu_requant", "int32"])
def test_int8_kernel_at_n_off_8(dev, n, form):
    """N off the multiple of 8 (a hidden 50 or MLP 100; 130: a full 128-wide
    tile and a tail of 2), K = 50 padded by the wrapper, in every epilogue
    form: equal to the plain version on the CPU bit for bit."""
    xq, wq, scale, bias, _ = _int8_operands(dev, 8 * 577, 50, n)
    kw = {}
    if form == "resid":
        kw["resid"] = _randn((8 * 577, n), torch.bfloat16, dev, 5)
    elif form == "gelu_requant":
        kw.update(gelu=True, out_quant_scale=torch.tensor(0.02, device=dev))
    if form == "int32":
        out = i8.int8_matmul_fused(xq, wq, out_dtype=torch.int32)
        ref = i8.int8_matmul_fused_reference(xq.cpu(), wq.cpu(),
                                             out_dtype=torch.int32)
    else:
        out = i8.int8_matmul_fused(xq, wq, scale, bias, **kw)
        ref = i8.int8_matmul_fused_reference(
            xq.cpu(), wq.cpu(), scale.cpu(), bias.cpu(),
            **{k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()})
    assert out.shape == (8 * 577, n)
    assert torch.equal(out.cpu(), ref)


def _int8_cfg(dtype="float32"):
    # hidden 128 in 2 heads of 64 (the attention kernel's head dim), K and
    # N multiples of 64
    return ModelConfig(img_size=64, patch_size=16, hidden_size=128,
                       num_layers=2, num_heads=2, mlp_dim=256, num_classes=5,
                       dtype=dtype)


@pytest.mark.parametrize("quantize", ["static", "dynamic"])
def test_quantized_predictor_on_card_matches_cpu(dev, quantize, tmp_path):
    """The static Predictor on the card (the int8 kernel, 73 launches per
    forward at 12 layers: here 1 + 6 · 2) and the dynamic one
    (``torch._int_mm``) against the CPU's plain versions on the same
    weights, calibration and images: 2e-2, the JAX package's bound for
    its two routes (an activation on a rounding boundary may quantize one
    step apart where LayerNorm or attention sum in another order)."""
    cfg = _int8_cfg("bfloat16")
    params = vit.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    grays = [rng.integers(0, 256, (100 + 7 * i, 90), np.uint8)
             for i in range(5)]
    kw = dict(batch_size=4, canvas_size=128, placement="device",
              quantize=quantize, calibration=grays[:3])
    cpu = Predictor(params, cfg, device="cpu", **kw)
    card = Predictor(params, cfg, device="cuda",
                     qparams=quantized.load_quantized(
                         cpu.save_quantized(str(tmp_path / "q")), cfg), **kw)
    before = i8.int8_matmul_fused.launches
    got = card.predict_arrays(grays)
    launches = i8.int8_matmul_fused.launches - before
    assert launches == (13 * card.forwards if quantize == "static" else 0)
    np.testing.assert_allclose(got.logits, cpu.predict_arrays(grays).logits,
                               atol=2e-2)


@pytest.mark.parametrize("quantize", [False, "static"])
def test_two_replicas_on_card_equal_one_at_their_batch(dev, quantize):
    """Two replicas on cuda:0, each on its own stream (the one-card stand-in
    for ``data_parallel=2``), at batch 8: each replica's rows equal, bit for
    bit, a one-replica Predictor at batch 4 on those rows, and the kernels
    launch twice what one forward launches. ViT-B/16 @384 width at depth
    2, bf16; static int8 on the fused kernel."""
    cfg = ModelConfig(num_layers=2)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    grays = [rng.integers(0, 256, (300 + 7 * i, 290), np.uint8)
             for i in range(8)]
    kw = dict(canvas_size=512, placement="device", quantize=quantize,
              calibration=grays[:4])
    two = Predictor(params, cfg, batch_size=8, device=["cuda:0"] * 2, **kw)
    one = Predictor(params, cfg, batch_size=4, device="cuda", **kw)
    assert two.replicas == 2 and two.devices == [torch.device("cuda:0")] * 2
    counters = (fa.flash_attention_inference, ln.layer_norm_cuda,
                i8.int8_matmul_fused)
    before = [c.launches for c in counters]
    out = two.predict_arrays(grays)
    launches = [c.launches - b for c, b in zip(counters, before)]
    assert two.forwards == 1
    assert launches == [2 * 2, 2 * 5, 2 * 13 if quantize else 0]
    for r in range(2):
        want = one.predict_arrays(grays[4 * r:4 * r + 4])
        assert np.array_equal(out.logits[4 * r:4 * r + 4], want.logits), r


def test_quantized_eval_step_on_card_matches_cpu(dev):
    cfg = Config(model=_int8_cfg("bfloat16"), train=TrainConfig())
    params = vit.init_params(torch.Generator().manual_seed(1), cfg.model)
    rng = np.random.default_rng(2)
    batch = {"pixel_values": torch.from_numpy(
                 rng.standard_normal((6, 64, 64, 3)).astype(np.float32)),
             "labels": torch.from_numpy(
                 (rng.random((6, 5)) < 0.2).astype(np.float32))}
    qp = quantized.quantize_vit_params(params, quantized.calibrate_vit_scales(
        params, batch["pixel_values"], cfg.model))
    step = steps.make_inference_eval_step(cfg, quantized=True)
    cpu_logits, cpu_rows = step(qp, batch)
    card_logits, card_rows = step(qp.to(dev), {k: v.to(dev)
                                               for k, v in batch.items()})
    np.testing.assert_allclose(card_logits.cpu().numpy(), cpu_logits.numpy(),
                               atol=2e-2)
    np.testing.assert_allclose(card_rows.cpu().numpy(), cpu_rows.numpy(),
                               atol=5 * 2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_ste_op_on_card(dev, dtype):
    """The int8 straight-through linear at a training shape (4 images of
    577 tokens, 768 → 3072): the forward launches the int8 kernel once and
    equals its plain version (the kernel's plain twin on the same int8
    operands, and the op on CPU copies) bit for bit; the gradients equal
    the dense linear's on the card (f32: rtol 1e-5; bf16: 1e-2 of the
    largest, cuBLAS may sum in another order for the other layouts)."""
    from chestxray_vit_tpu_torch.models import int8_train
    from chestxray_vit_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 577, 768, generator=g).to(dtype)
    w = (torch.randn(768, 3072, generator=g) * 0.02).to(dtype)
    b = torch.randn(3072, generator=g).to(dtype) * 0.1
    dy = torch.randn(4, 577, 3072, generator=g).to(dtype)
    xs = float(x.float().abs().max()) / 127.0
    leaves = [t.to(dev).requires_grad_() for t in (x, w, b)]
    before = i8.int8_matmul_fused.launches
    y = int8_train.int8_linear_ste(*leaves, xs, dtype)
    assert i8.int8_matmul_fused.launches == before + 1
    wq, ws = quant.quantize_weight_tensors(leaves[1].detach())
    s = torch.tensor(xs, device=dev)
    plain = i8.int8_matmul_fused_reference(
        quant.quantize_static(leaves[0].detach(), s), wq, s * ws,
        leaves[2].detach().float(), out_dtype=dtype)
    assert torch.equal(y.detach(), plain)
    assert torch.equal(y.detach().cpu(), int8_train.int8_linear_ste(
        x, w, b, xs, dtype))
    (y * dy.to(dev)).sum().backward()
    dense = [t.to(dev).requires_grad_() for t in (x, w, b)]
    ((dense[0] @ dense[1] + dense[2]) * dy.to(dev)).sum().backward()
    for got, want in zip(leaves, dense):
        a, r = got.grad.float(), want.grad.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            assert float((a - r).abs().max()) <= 1e-2 * float(r.abs().max())


# ---------------------------------------------------------------------------
# Segment-masked (packed) attention
# ---------------------------------------------------------------------------

def _merged_order(ids):
    """Ids in the order a token merge leaves them: the kept even positions,
    then the odd ones, so two contiguous segments interleave as
    0…0 1…1 0…0 1…1."""
    return np.concatenate([ids[0::2], ids[1::2]])


_SEG_LAYOUTS = {
    # name: ids of one sequence (−1 is padding)
    "two-segments": np.repeat([0, 1], 576),
    "mixed-pad": np.concatenate([np.repeat([0, 1, 2], [576, 256, 256]),
                                 np.full(64, -1)]),
    "interleaved-ragged": _merged_order(np.repeat([0, 1], 576))[:1136],
    "odd-S": np.repeat([0, 1, -1], [70, 50, 9]),
    "short": np.repeat([0, 1], [20, 17]),
    "one-segment": np.zeros(200, np.int64),
    "all-pad": np.full(130, -1),
    "first-tiles-foreign": np.repeat([3, 0, 7], [128, 65, 64]),
    "unsorted": np.random.default_rng(0).integers(-1, 4, 333),
    # 35 tiles: the backward scans the ids 32 tiles at a time
    "long": np.repeat([0, 1, 2], [1100, 700, 377]),
}


def _seg_ids(name, b, dev):
    """[b, S] int32: the layout, rolled by 7·row so rows differ."""
    ids = _SEG_LAYOUTS[name]
    rows = [ids if name == "interleaved-ragged" or i == 0
            else np.roll(ids, 7 * i) for i in range(b)]
    return torch.tensor(np.stack(rows), dtype=torch.int32, device=dev)


# The segment kernels are held tighter than the dense ones, so that a key
# dropped or wrongly masked on a few rows cannot pass. bf16 o: one bf16 ulp
# of the value (at most 2^-7 of it) for the last rounding plus 8e-3 for P
# rounded to bf16 before the running sum; the f32 lse: 5e-3 (the rounding
# of P moves the sum by at most 2^-9 of it, and a short segment that loses
# one key moves lse by far more). f32: summation order only.
_SEG_O_TOL = {torch.bfloat16: {"atol": 8e-3, "rtol": 2.0 ** -7},
              torch.float32: {"atol": 1e-5, "rtol": 0}}
_SEG_LSE_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}


@pytest.mark.parametrize("layout", sorted(_SEG_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, _RATE])
def test_packed_fwd_bwd_kernels_match_plain(dev, layout, dtype, rate):
    seg = _seg_ids(layout, 2, dev)
    s = seg.shape[1]
    q, k, v = _heads_views(2, s, dtype, dev)
    do = _randn(q.shape, dtype, dev, seed=5)
    if rate:
        bq = fa.packed_block_q(s)
        fwd, bwd = (fa.flash_attention_packed_dropout_fwd,
                    fa.flash_attention_packed_dropout_bwd)
        rfwd, rbwd = (fa.attention_packed_dropout_fwd_reference,
                      fa.attention_packed_dropout_bwd_reference)
        extra = (_SEED, rate, None, bq)
    else:
        fwd, bwd = (fa.flash_attention_packed_fwd,
                    fa.flash_attention_packed_bwd)
        rfwd, rbwd = (fa.attention_packed_fwd_reference,
                      fa.attention_packed_bwd_reference)
        extra = ()
    n_fwd, n_bwd = fwd.launches, bwd.launches
    o, lse = fwd(q, k, v, seg, *extra)
    grads = bwd(q, k, v, seg, o, lse, do, *extra)
    torch.cuda.synchronize()
    assert fwd.launches == n_fwd + 1 and bwd.launches == n_bwd + 1
    ro, rlse = rfwd(q, k, v, seg, *extra)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert lse.shape == (2, 12, s) and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), **_SEG_O_TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=_SEG_LSE_TOL[dtype], rtol=0)
    for g, r in zip(grads, rbwd(q, k, v, seg, o, lse, do, *extra)):
        assert g.dtype == dtype and g.transpose(1, 2).is_contiguous()
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= _GRAD_TOL[dtype]


@pytest.mark.parametrize("layout", ["two-segments", "interleaved-ragged",
                                    "unsorted"])
@pytest.mark.parametrize("rate", [0.0, _RATE])
def test_packed_bwd_kernel_is_deterministic(dev, layout, rate):
    """Two calls on the same inputs give the same bits: no atomics."""
    seg = _seg_ids(layout, 2, dev)
    s = seg.shape[1]
    q, k, v = _heads_views(2, s, torch.bfloat16, dev)
    do = _randn(q.shape, torch.bfloat16, dev, seed=5)
    if rate:
        extra = (_SEED, rate, None, fa.packed_block_q(s))
        o, lse = fa.flash_attention_packed_dropout_fwd(q, k, v, seg, *extra)
        bwd = fa.flash_attention_packed_dropout_bwd
    else:
        extra = ()
        o, lse = fa.flash_attention_packed_fwd(q, k, v, seg)
        bwd = fa.flash_attention_packed_bwd
    a = bwd(q, k, v, seg, o, lse, do, *extra)
    b = bwd(q, k, v, seg, o, lse, do, *extra)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_packed_kernels_one_segment_agree_with_dense_kernels(dev):
    """With one segment the mask is empty: the segment kernels do the dense
    kernels' arithmetic. The two are separate instantiations, which the
    compiler may contract differently (lse came out a few f32 ulps apart),
    so: lse within 1e-5, o within one bf16 ulp of values below 1, the
    gradients within the kernels' own bf16 tolerance (a last-bit
    difference in lse moves P by a bf16 ulp)."""
    q, k, v = _heads_views(2, 577, torch.bfloat16, dev)
    do = _randn(q.shape, torch.bfloat16, dev, seed=5)
    seg = torch.zeros((2, 577), dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_packed_fwd(q, k, v, seg)
    dense_o, dense_lse = fa.flash_attention_fwd(q, k, v)
    torch.testing.assert_close(lse, dense_lse, atol=1e-5, rtol=0)
    torch.testing.assert_close(o.float(), dense_o.float(), atol=2.0 ** -8,
                               rtol=0)
    for a, b in zip(fa.flash_attention_packed_bwd(q, k, v, seg, o, lse, do),
                    fa.flash_attention_bwd(q, k, v, dense_o, dense_lse, do)):
        assert _rel(a, b) <= _GRAD_TOL[torch.bfloat16]


def test_packed_kernels_isolate_segments(dev):
    """Changing one segment's tokens leaves the other rows' outputs and
    gradients bit for bit, at interleaved ids."""
    seg = _seg_ids("interleaved-ragged", 1, dev)
    q, k, v = _heads_views(1, seg.shape[1], torch.bfloat16, dev)
    do = _randn(q.shape, torch.bfloat16, dev, seed=5)
    other = (seg[0] == 1)
    q2, k2, v2 = (t.clone() for t in (q, k, v))
    for t in (q2, k2, v2):
        t[:, :, other] += 1.0
    o, lse = fa.flash_attention_packed_fwd(q, k, v, seg)
    o2, lse2 = fa.flash_attention_packed_fwd(q2, k2, v2, seg)
    assert torch.equal(o[:, :, ~other], o2[:, :, ~other])
    assert not torch.equal(o[:, :, other], o2[:, :, other])
    g = fa.flash_attention_packed_bwd(q, k, v, seg, o, lse, do)
    g2 = fa.flash_attention_packed_bwd(q2, k2, v2, seg, o2, lse2, do)
    for a, b in zip(g, g2):
        assert torch.equal(a[:, :, ~other], b[:, :, ~other])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, _RATE])
def test_packed_autograd_on_card_matches_plain_autograd(dev, dtype, rate):
    """FlashAttentionPacked / …Dropout through ``attention_packed`` against
    plain autograd of the plain forward, non-contiguous upstream gradient."""
    seg = _seg_ids("mixed-pad", 2, dev)
    s = seg.shape[1]
    q, k, v = (t.detach().requires_grad_()
               for t in _heads_views(2, s, dtype, dev))
    go = _randn((2, s, 12, 64), dtype, dev, seed=7).transpose(1, 2)
    seed = _SEED if rate else None
    fa.attention_packed(q, k, v, seg, "auto", seed, rate).backward(go)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    fa.attention_packed(q, k, v, seg, "xla", seed, rate).backward(go)
    tol = {torch.bfloat16: 3e-2, torch.float32: 1e-5}[dtype]
    for g, t in zip(got, (q, k, v)):
        assert _rel(g, t.grad) <= tol


def test_packed_kernels_refuse_what_they_do_not_take(dev):
    q, k, v = _heads_views(2, 64, torch.bfloat16, dev)
    seg = torch.zeros((2, 64), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_packed_fwd(q, k, v, seg)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_packed_fwd(q, k, v, seg.int()[:, :63])
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_packed_fwd(q, k, v, seg.int().cpu())


def test_tome_tie_rules_on_card_equal_cpu(dev):
    """Pad pairs all score 2.0: the card picks the pairs the CPU picks."""
    from chestxray_vit_tpu_torch.ops import tome
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 96, 32), generator=g)
    metric = torch.randn((3, 96, 16), generator=g)
    seg = torch.tensor(np.stack([np.repeat([0, 1, -1], [30, 26, 40])] * 3),
                       dtype=torch.int32)
    metric[seg < 0] = 0.0
    pw = torch.rand((3, 2, 96), generator=g) * (seg >= 0)[:, None, :]
    sizes = torch.ones((3, 96))
    cpu = tome.tome_merge_packed(x, metric, sizes, seg, pw, 20)
    card = tome.tome_merge_packed(*(t.to(dev) for t in
                                    (x, metric, sizes, seg, pw)), 20)
    for a, b in zip(cpu, card):
        torch.testing.assert_close(a, b.cpu(), atol=1e-6, rtol=1e-6)
    assert torch.equal(cpu[2], card[2].cpu())


def test_packed_train_step_with_accumulation_on_card(dev):
    """The packed step with gradient accumulation 2 on the card: its
    strided micro-batches reach the segment kernels (which read the ids in
    place) and the step equals the CPU's, with both dropouts at a rank's
    row base."""
    from chestxray_vit_tpu_torch.data import packing as pk
    rng = np.random.default_rng(1)
    sizes = [96, 64, 48, 64]
    imgs = [rng.integers(0, 255, (s, s), np.uint8) for s in sizes]
    labs = [(rng.random(15) < 0.3).astype(np.float32) for _ in sizes]
    grids = (3, 4, 6)
    pb = pk.pack_images(imgs, labs, patch=16, seq_len=70, grids=grids)
    keys = ("tokens", "segment_ids", "pos_indices", "pool_weights", "labels",
            "image_mask")
    cfg = Config(model=ModelConfig(num_layers=2, img_size=96, dtype="float32",
                                   remat=True, attention_dropout=0.1,
                                   hidden_dropout=0.1),
                 train=TrainConfig(gradient_accumulation_steps=2))
    out = []
    for device in ("cpu", dev):
        params = vit.init_params(torch.Generator().manual_seed(0),
                                 cfg.model).to(device)
        batch = {k: torch.from_numpy(np.concatenate([getattr(pb, k)] * 2))
                 .to(device) for k in keys}
        state, m = steps.make_packed_train_step(cfg, 100, grids, rank=1,
                                                world=2)(
            steps.TrainState.create(params, 0), batch)
        out.append((m["loss"].item(), bridge.grads_to_numpy(params)))
    (l0, g0), (l1, g1) = out
    assert abs(l0 - l1) <= 1e-5
    scale = max(float(np.abs(a).max()) for a in _leaves(g0))
    for a, b in zip(_leaves(g0), _leaves(g1)):
        assert float(np.abs(a - b).max()) <= 1e-4 * scale


@pytest.mark.parametrize("tome_r", [0, 6])
def test_packed_train_step_on_card_matches_cpu(dev, tome_r):
    """One packed f32 step at full width, depth 2, on the card against the
    CPU (plain versions), with attention dropout on injected seeds."""
    from chestxray_vit_tpu_torch.data import packing as pk
    rng = np.random.default_rng(0)
    sizes = [96, 64, 48, 64, 96, 48]
    imgs = [rng.integers(0, 255, (s, s), np.uint8) for s in sizes]
    labs = [(rng.random(15) < 0.3).astype(np.float32) for _ in sizes]
    grids = (3, 4, 6)
    pb = pk.pack_images(imgs, labs, patch=16, seq_len=70, grids=grids)
    keys = ("tokens", "segment_ids", "pos_indices", "pool_weights", "labels",
            "image_mask")
    cfg = Config(model=ModelConfig(num_layers=2, img_size=96, dtype="float32",
                                   remat=True, attention_dropout=0.1,
                                   tome_r=tome_r,
                                   tome_schedule="decreasing"),
                 train=TrainConfig())
    draws = [steps.Draws(seeds=[(-77, 0, 0), (1234567, 0, 0)])]
    out = []
    for device in ("cpu", dev):
        params = vit.init_params(torch.Generator().manual_seed(0),
                                 cfg.model).to(device)
        batch = {k: torch.from_numpy(getattr(pb, k)).to(device)
                 for k in keys}
        before = (fa.flash_attention_packed_dropout_fwd.launches,
                  fa.flash_attention_packed_dropout_bwd.launches)
        state, m = steps.make_packed_train_step(cfg, 100, grids)(
            steps.TrainState.create(params, 0), batch, draws)
        after = (fa.flash_attention_packed_dropout_fwd.launches,
                 fa.flash_attention_packed_dropout_bwd.launches)
        if device != "cpu":        # forward + recompute, backward
            assert (after[0] - before[0], after[1] - before[1]) == (4, 2)
        out.append((m["loss"].item(), bridge.grads_to_numpy(params)))
    (l0, g0), (l1, g1) = out
    assert abs(l0 - l1) <= 1e-5

    def leaves(t):
        return [x for k in sorted(t) for x in
                (leaves(t[k]) if isinstance(t[k], dict) else [t[k]])]

    scale = max(float(np.abs(a).max()) for a in leaves(g0))
    for a, b in zip(leaves(g0), leaves(g1)):
        assert float(np.abs(a - b).max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# Token merging on the dense forward
# ---------------------------------------------------------------------------

def _tome_cfg(**kw):
    base = dict(img_size=64, patch_size=8, hidden_size=128, num_layers=2,
                num_heads=2, mlp_dim=256, num_classes=5, dtype="float32",
                tome_r=16, tome_schedule="decreasing")
    return ModelConfig(**{**base, **kw})


@pytest.mark.parametrize("quantize", [None, "static"])
def test_tome_forward_on_card_matches_cpu(dev, quantize):
    """The merged serving forward (65 → 43 → 33 tokens) on the card against
    the CPU (plain versions), f32: dense, and static int8 on the fused
    route; every attention and int8 product runs a kernel."""
    import copy

    from chestxray_vit_tpu_torch.models import tome_forward
    cfg = _tome_cfg()
    cpu = vit.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((3, 64, 64, 3), generator=torch.Generator()
                    .manual_seed(1))
    if quantize:
        cpu = quantized.quantize_vit_params(
            cpu, quantized.calibrate_vit_scales(cpu, x, cfg))
    card = copy.deepcopy(cpu).to(dev)
    kw = dict(quantized=bool(quantize), schedule="decreasing",
              backend="pallas" if quantize else "xla")
    n_attn, n_i8 = (fa.flash_attention_inference.launches,
                    i8.int8_matmul_fused.launches)
    with torch.inference_mode():
        got = tome_forward.apply_tome(card, x.to(dev), cfg, 16, **kw).cpu()
        want = tome_forward.apply_tome(cpu, x, cfg, 16, **kw)
    assert fa.flash_attention_inference.launches == n_attn + 2
    assert i8.int8_matmul_fused.launches == n_i8 + (13 if quantize else 0)
    # f32: summation order; int8: a value that lands on a rounding
    # boundary moves one int8 step (the bound of the int8 card tests
    # above)
    torch.testing.assert_close(got, want, atol=2e-2 if quantize else 1e-4,
                               rtol=0)


def test_tome_remat_step_on_card_is_deterministic(dev):
    """The merged step under full remat recomputes each block's matching in
    the backward; it equals the forward's only if every kernel before it
    gives the same bits. Two steps from the same state, bf16: equal loss
    and gradients, bit for bit."""
    cfg = Config(model=_tome_cfg(dtype="bfloat16", remat=True),
                 train=TrainConfig(warmup_steps=1))
    rng = np.random.default_rng(0)
    batch = {"pixel_values": torch.from_numpy(
        rng.standard_normal((4, 64, 64, 3)).astype(np.float32)).to(dev),
        "labels": torch.from_numpy(
            (rng.random((4, 5)) < 0.3).astype(np.float32)).to(dev)}
    out = []
    for _ in range(2):
        params = vit.init_params(torch.Generator().manual_seed(0), cfg.model,
                                 dev)
        before = fa.flash_attention_fwd.launches
        _, m = steps.make_train_step(cfg, 10)(
            steps.TrainState.create(params, 0), batch)
        assert fa.flash_attention_fwd.launches == before + 4
        out.append((m["loss"].item(),
                    [p.grad.clone() for p in params.parameters()]))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_training_attention_reads_fused_qkv_views(dev):
    """The fused projection hands the training kernels q, k, v as
    [B, H, S, 64] views of one [B, S, 3, H, 64] product (row stride 3·D, k
    and v D and 2·D elements on): forward and gradients against the plain
    autograd on contiguous copies."""
    qkv = _randn((2, 577, 3, 12, 64), torch.bfloat16, dev)
    do = _randn((2, 12, 577, 64), torch.bfloat16, dev, seed=1)
    leaf = qkv.clone().requires_grad_()
    q, k, v = (t.transpose(1, 2) for t in leaf.unbind(2))
    assert all(fa._fits(t) for t in (q, k, v))
    before = fa.flash_attention_fwd.launches
    o = fa.FlashAttention.apply(q, k, v)
    (o.float() * do.float()).sum().backward()
    assert fa.flash_attention_fwd.launches == before + 1
    ref_leaf = qkv.clone().requires_grad_()
    rq, rk, rv = (t.transpose(1, 2).contiguous()
                  for t in ref_leaf.unbind(2))
    ref = fa.attention_reference(rq, rk, rv)
    (ref.float() * do.float()).sum().backward()
    torch.testing.assert_close(o.float(), ref.float(), atol=3e-2, rtol=3e-2)
    scale = ref_leaf.grad.float().abs().max()
    assert (leaf.grad.float() - ref_leaf.grad.float()).abs().max() \
        <= 1e-2 * scale


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused_qkv"])
@pytest.mark.parametrize("policy", ["mlp", "attn", "attn_mlp", "flash_out",
                                    "dots"])
def test_remat_policy_step_on_card_equals_no_remat(dev, policy, fused):
    """Each remat policy on the card, bf16: the step's loss and gradients
    equal the step's without remat bit for bit (a policy changes what the
    backward keeps, not what it computes), and the attention forward runs
    once a layer where o and lse are kept, twice where they are not."""
    rng = np.random.default_rng(0)
    batch = {"pixel_values": torch.from_numpy(
        rng.standard_normal((4, 64, 64, 3)).astype(np.float32)).to(dev),
        "labels": torch.from_numpy(
            (rng.random((4, 5)) < 0.3).astype(np.float32)).to(dev)}
    out = []
    for remat in (False, True):
        model = ModelConfig(img_size=64, patch_size=8, hidden_size=128,
                            num_layers=2, num_heads=2, mlp_dim=256,
                            num_classes=5, dtype="bfloat16", remat=remat,
                            remat_policy=policy, fused_qkv=fused)
        params = vit.init_params(torch.Generator().manual_seed(0), model,
                                 dev)
        before = fa.flash_attention_fwd.launches
        _, m = steps.make_train_step(
            Config(model=model, train=TrainConfig(warmup_steps=1)), 10)(
            steps.TrainState.create(params, 0), batch)
        runs = 2 if remat and policy == "dots" else 1
        assert fa.flash_attention_fwd.launches == before + 2 * runs
        out.append((m["loss"].item(),
                    [p.grad.clone() for p in params.parameters()]))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_trainer_on_card_resumes_bit_for_bit(dev, tmp_path):
    """Two Trainer steps on the card at a small width (bf16, full remat,
    host placement with augmentation, a checkpoint after step 1), then a
    second Trainer resumed from step 1 in a fresh directory: its step-2
    loss and weights equal the first run's bit for bit, because every
    kernel on the path is deterministic."""
    import json
    import shutil

    from chestxray_vit_tpu_torch.config import DataConfig
    from chestxray_vit_tpu_torch.data.testing import build_fake_nih
    from chestxray_vit_tpu_torch.train.trainer import Trainer

    fake = build_fake_nih(num_images=40, image_size=96, seed=5)

    def cfg(out, **kw):
        return Config(
            data=DataConfig(backend="memory", augment=True, num_workers=2),
            model=ModelConfig(img_size=64, hidden_size=128, num_heads=2,
                              num_layers=2, mlp_dim=256, remat=True),
            train=TrainConfig(batch_size_per_core=8, max_steps=2,
                              save_steps=1, eval_strategy="no",
                              load_best_model_at_end=False, logging_steps=1,
                              report_to="none", output_dir=str(out), **kw))

    def losses(out):
        with open(out / "metrics.jsonl") as f:
            return [(r["step"], r["loss"]) for r in map(json.loads, f)
                    if r["prefix"] == "train"]

    first = Trainer(cfg(tmp_path / "a"), store=fake.store, pretrained=False)
    first.train()
    first.close()
    assert next(first.state.params.parameters()).is_cuda
    (tmp_path / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(tmp_path / "a" / "checkpoints" / "1",
                    tmp_path / "b" / "checkpoints" / "1")
    again = Trainer(cfg(tmp_path / "b", resume_from_checkpoint="1"),
                    store=fake.store, pretrained=False)
    again.train()
    again.close()
    assert losses(tmp_path / "b") == losses(tmp_path / "a")[1:]
    for (n, p), q in zip(first.state.params.named_parameters(),
                         again.state.params.parameters()):
        assert torch.equal(p, q), n


def test_packed_trainer_on_card_resumes_bit_for_bit(dev, tmp_path):
    """Three PackedTrainer steps on the card at a small width (bf16, full
    remat, segment-masked kernels, a third of the images at 32 or 48 px, a
    checkpoint after step 1), then a second PackedTrainer resumed from
    step 1 in a fresh directory: the cursor counts the images of the one
    consumed batch, and steps 2-3 and the weights equal the first run's
    bit for bit."""
    import io
    import json
    import shutil

    from PIL import Image

    from chestxray_vit_tpu_torch.config import DataConfig
    from chestxray_vit_tpu_torch.data.testing import build_fake_nih
    from chestxray_vit_tpu_torch.train.packed_trainer import PackedTrainer

    fake = build_fake_nih(num_images=120, image_size=64, seed=5)
    rng = np.random.default_rng(0)
    for i, name in enumerate(fake.image_names[::3]):
        size = int(rng.choice([32, 48]))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (size, size), np.uint8),
                        "L").save(buf, format="PNG")
        fake.store.put(f"images_{(3 * i % 12) + 1:03d}/images/{name}",
                       buf.getvalue())

    def trainer(out, **kw):
        cfg = Config(
            data=DataConfig(backend="memory", num_workers=2),
            model=ModelConfig(img_size=64, hidden_size=128, num_heads=2,
                              num_layers=2, mlp_dim=256, remat=True),
            train=TrainConfig(max_steps=3, save_steps=1, save_total_limit=3,
                              eval_strategy="no",
                              load_best_model_at_end=False, logging_steps=1,
                              report_to="none", output_dir=str(out), **kw))
        return PackedTrainer(cfg, seq_len=48, grids=(2, 3, 4), batch_seqs=8,
                             store=fake.store, pretrained=False,
                             census_sample=16)

    def losses(out):
        with open(out / "metrics.jsonl") as f:
            return [(r["step"], r["loss"]) for r in map(json.loads, f)
                    if r["prefix"] == "train"]

    first = trainer(tmp_path / "a")
    first.train()
    first.close()
    assert next(first.state.params.parameters()).is_cuda
    meta = json.loads((tmp_path / "a" / "checkpoints" / "1" /
                       "meta.json").read_text())
    full = next(b for b in first._packed_iter(first.bundle.train, 0,
                                              batch_seqs=8)
                if int(b["n_seqs"]) == 8)
    assert meta["cursor"] == {"epoch": 0,
                              "batch_in_epoch": int(full["n_images"])}
    (tmp_path / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(tmp_path / "a" / "checkpoints" / "1",
                    tmp_path / "b" / "checkpoints" / "1")
    again = trainer(tmp_path / "b", resume_from_checkpoint="1")
    again.train()
    again.close()
    assert losses(tmp_path / "b") == losses(tmp_path / "a")[1:]
    for (n, p), q in zip(first.state.params.named_parameters(),
                         again.state.params.parameters()):
        assert torch.equal(p, q), n


# ---------------------------------------------------------------------------
# Head dims other than 64: the kernels at the padded width 64 (d = 16) and
# 128 (d = 80, ViT-H/14's, and d = 128), and the wide kernels (d = 192 and
# 256: three and four 64-column chunks of one 256-column block with Q
# resident; d = 264: a second block of 8 columns)
# ---------------------------------------------------------------------------

_HEAD_DIMS = [16, 80, 128, 192, 256, 264]
# a tail of one row, a short odd S, a tile and a row, the wide forward's
# 128-row block and a row past it, ViT-H/14 @224, 384, @512
_HD_LENGTHS = [1, 37, 65, 128, 129, 257, 577, 1025]
# the wide forwards' head dims: three and four chunks, a last chunk of 8
# columns, two and three 256-column blocks
_WIDE_HEAD_DIMS = [136, 192, 200, 256, 264, 768]


def _qkv_at(d, b, s, dtype, dev, heads=3, seed=0):
    """q, k, v as [B, H, S, d] views of one [B, S, 3, H, d] product."""
    x = _randn((b, s, 3, heads, d), dtype, dev, seed)
    return [t.transpose(1, 2) for t in x.unbind(2)]


@pytest.mark.parametrize("d", _HEAD_DIMS)
@pytest.mark.parametrize("s", _HD_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_at_head_dim(dev, d, s, dtype):
    """The inference, training and dropout forwards and both backwards at
    head dim d against their plain versions, with the tolerances of d =
    64, each backward's bits the same twice (d = 264: the wide kernels'
    second 256-column block holds 8 columns)."""
    q, k, v = _qkv_at(d, 2, s, dtype, dev)
    do = _randn(q.shape, dtype, dev, seed=5)
    torch.testing.assert_close(fa.flash_attention_inference(q, k, v).float(),
                               fa.attention_reference(q, k, v).float(),
                               atol=_ATTN_TOL[dtype], rtol=_ATTN_TOL[dtype])
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.attention_fwd_reference(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(), atol=_ATTN_TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, rlse, atol=_ATTN_TOL[dtype], rtol=0)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    _assert_grads_close(grads,
                        fa.attention_bwd_reference(q, k, v, o, lse, do),
                        dtype, s)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    bq = fa.auto_block_q(s)
    o, lse = fa.flash_attention_dropout_fwd(q, k, v, _SEED, _RATE,
                                            block_q=bq)
    ro, rlse = fa.attention_dropout_fwd_reference(q, k, v, _SEED, _RATE,
                                                  block_q=bq)
    torch.testing.assert_close(o.float(), ro.float(), atol=_ATTN_TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, rlse, atol=_ATTN_TOL[dtype], rtol=0)
    grads = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, _SEED,
                                           _RATE, block_q=bq)
    again = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, _SEED,
                                           _RATE, block_q=bq)
    _assert_grads_close(
        grads,
        fa.attention_dropout_bwd_reference(q, k, v, o, lse, do, _SEED,
                                           _RATE, block_q=bq), dtype, s)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("d", _WIDE_HEAD_DIMS)
@pytest.mark.parametrize("s", _HD_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_forward_forms_match_plain_with_equal_bits_twice(dev, d, s,
                                                             dtype):
    """Every form of the wide forward (d > 128): inference, with lse,
    dropout, the debug kernel (its mask bit for bit against the plain
    hash), segment ids (two segments) with and without dropout, each
    within the tolerance of d = 64 of its plain version and the same bits
    on a second call."""
    q, k, v = _qkv_at(d, 2, s, dtype, dev)
    seg = (torch.arange(s, device=dev) >= s // 2).to(torch.int32)
    seg = seg.expand(2, s).contiguous()
    bq, pbq = fa.auto_block_q(s), fa.packed_block_q(s)
    drop = (_SEED, _RATE)

    def run():
        return {
            "inference": (fa.flash_attention_inference(q, k, v),),
            "lse": fa.flash_attention_fwd(q, k, v),
            "dropout": fa.flash_attention_dropout_fwd(q, k, v, *drop,
                                                      block_q=bq),
            "debug": fa.flash_attention_dropout_debug(q, k, v, *drop,
                                                      block_q=bq),
            "segment": fa.flash_attention_packed_fwd(q, k, v, seg),
            "segment_dropout": fa.flash_attention_packed_dropout_fwd(
                q, k, v, seg, *drop, None, pbq)}

    got, again = run(), run()
    dropped = fa.attention_dropout_fwd_reference(q, k, v, *drop, block_q=bq)
    ref = {"inference": (fa.attention_reference(q, k, v),),
           "lse": fa.attention_fwd_reference(q, k, v),
           "dropout": dropped,
           "debug": (dropped[0], fa._keep(q, *drop, bq)),
           "segment": fa.attention_packed_fwd_reference(q, k, v, seg),
           "segment_dropout": fa.attention_packed_dropout_fwd_reference(
               q, k, v, seg, *drop, None, pbq)}
    torch.cuda.synchronize()
    for form, outs in got.items():
        assert all(torch.equal(a, b) for a, b in zip(outs, again[form])), form
        for g, r in zip(outs, ref[form]):
            if g.dtype == torch.bool:
                assert torch.equal(g, r), form
                continue
            assert torch.isfinite(g).all(), form
            torch.testing.assert_close(g.float(), r.float(),
                                       atol=_ATTN_TOL[dtype], rtol=0,
                                       msg=form)


@pytest.mark.parametrize("d", _HEAD_DIMS)
def test_dropout_debug_mask_does_not_depend_on_head_dim(dev, d):
    """The debug kernel's mask at head dim d equals its mask at d = 64 and
    the plain counter hash: the counter holds no d."""
    bq = fa.auto_block_q(257)
    q, k, v = _qkv_at(d, 2, 257, torch.bfloat16, dev)
    _, keep = fa.flash_attention_dropout_debug(q, k, v, _SEED, _RATE,
                                               block_q=bq, row_base=3)
    q64, k64, v64 = _qkv_at(64, 2, 257, torch.bfloat16, dev)
    _, keep64 = fa.flash_attention_dropout_debug(q64, k64, v64, _SEED, _RATE,
                                                 block_q=bq, row_base=3)
    torch.cuda.synchronize()
    assert torch.equal(keep, keep64)
    assert torch.equal(keep, fa._keep(q, _SEED, _RATE, bq, 3))


@pytest.mark.parametrize("d", _HEAD_DIMS)
@pytest.mark.parametrize("layout", ["odd-S", "interleaved-ragged",
                                    "first-tiles-foreign"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, _RATE])
def test_packed_kernels_at_head_dim(dev, d, layout, dtype, rate):
    seg = _seg_ids(layout, 2, dev)
    s = seg.shape[1]
    q, k, v = _qkv_at(d, 2, s, dtype, dev)
    do = _randn(q.shape, dtype, dev, seed=5)
    if rate:
        fwd, bwd = (fa.flash_attention_packed_dropout_fwd,
                    fa.flash_attention_packed_dropout_bwd)
        rfwd, rbwd = (fa.attention_packed_dropout_fwd_reference,
                      fa.attention_packed_dropout_bwd_reference)
        extra = (_SEED, rate, None, fa.packed_block_q(s))
    else:
        fwd, bwd = (fa.flash_attention_packed_fwd,
                    fa.flash_attention_packed_bwd)
        rfwd, rbwd = (fa.attention_packed_fwd_reference,
                      fa.attention_packed_bwd_reference)
        extra = ()
    o, lse = fwd(q, k, v, seg, *extra)
    grads = bwd(q, k, v, seg, o, lse, do, *extra)
    again = bwd(q, k, v, seg, o, lse, do, *extra)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ro, rlse = rfwd(q, k, v, seg, *extra)
    torch.testing.assert_close(o.float(), ro.float(), **_SEG_O_TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=_SEG_LSE_TOL[dtype], rtol=0)
    for g, r in zip(grads, rbwd(q, k, v, seg, o, lse, do, *extra)):
        assert g.dtype == dtype and g.shape == q.shape
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= _GRAD_TOL[dtype]


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_read_no_column_past_d(dev, d, dtype):
    """q, k, v, o and dO as [..., :d] views of 128-wide buffers whose
    columns at or past d are NaN: every output is finite and equal, bit for
    bit, to that of contiguous copies (the padding to 64 or 128 columns
    lives in shared memory only)."""
    wide = [_randn((2, 3, 129, 128), dtype, dev, seed=i) for i in range(4)]
    for t in wide:
        t[..., d:] = float("nan")
    q, k, v, do = (t[..., :d] for t in wide)
    copies = [t.contiguous() for t in (q, k, v, do)]
    got = fa.flash_attention_fwd(q, k, v)
    ref = fa.flash_attention_fwd(*copies[:3])
    assert all(torch.isfinite(a).all() and torch.equal(a, b)
               for a, b in zip(got, ref))
    o_wide = torch.full_like(wide[0], float("nan"))
    o_wide[..., :d] = got[0]
    o = o_wide[..., :d]
    grads = fa.flash_attention_bwd(q, k, v, o, got[1], do)
    refs = fa.flash_attention_bwd(*copies[:3], got[0].contiguous(), got[1],
                                  copies[3])
    torch.cuda.synchronize()
    assert all(torch.isfinite(a).all() and torch.equal(a, b)
               for a, b in zip(grads, refs))


@pytest.mark.parametrize("rate", [0.0, _RATE])
@pytest.mark.parametrize("d,wide", [(16, 64), (80, 128), (80, 96),
                                    (136, 256), (200, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("packed", [False, True])
def test_head_dim_equals_zero_padded_wider_head_dim(dev, d, wide, dtype,
                                                    packed, rate):
    """The training forward and backward at head dim d equal, bit for bit,
    the same kernels at a wider head dim on operands zero-padded to it (at
    the same scale): the columns past d add nothing, and the last chunk's
    skipped 16-deep steps change no bit; with a rate, the dropout kernels
    (dense or segment), whose mask holds no d. In bf16, d = 80 runs at
    kD = 80 and 96 and 128 at kD = 128, so the 16-column tiles meet the
    64-column chunk; 136, 200 and 256 run the wide kernels, 136's and
    200's last chunk 8 columns (one 16-deep step of S) against whole
    chunks of one 256-column block. (f32 splits a row over as many threads
    as the padded width needs, so 16 against 128 would differ in
    summation order; the pairs here share that split.)"""
    seg = _seg_ids("odd-S", 2, dev)
    s = seg.shape[1]
    q, k, v = _qkv_at(d, 2, s, dtype, dev)
    do = _randn(q.shape, dtype, dev, seed=5)
    qw, kw, vw, dow = (torch.nn.functional.pad(t, (0, wide - d)).contiguous()
                       for t in (q, k, v, do))
    scale = d ** -0.5
    if packed:
        fwd, bwd, extra = (fa.flash_attention_packed_fwd,
                           fa.flash_attention_packed_bwd, (seg,))
        if rate:
            fwd, bwd = (fa.flash_attention_packed_dropout_fwd,
                        fa.flash_attention_packed_dropout_bwd)
    else:
        fwd, bwd, extra = fa.flash_attention_fwd, fa.flash_attention_bwd, ()
        if rate:
            fwd, bwd = (fa.flash_attention_dropout_fwd,
                        fa.flash_attention_dropout_bwd)
    # the arguments after the operands: the scale, or the mask's seed and
    # rate, the scale and the block the mask's strides are padded to
    tail = ((_SEED, rate, scale,
             fa.packed_block_q(s) if packed else fa.auto_block_q(s))
            if rate else (scale,))
    o, lse = fwd(q, k, v, *extra, *tail)
    ow, lsew = fwd(qw, kw, vw, *extra, *tail)
    grads = bwd(q, k, v, *extra, o, lse, do, *tail)
    wgrads = bwd(qw, kw, vw, *extra, ow, lsew, dow, *tail)
    torch.cuda.synchronize()
    assert torch.equal(o, ow[..., :d]) and torch.equal(lse, lsew)
    assert not ow[..., d:].any()
    for g, w in zip(grads, wgrads):
        assert torch.equal(g, w[..., :d]) and not w[..., d:].any()


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_dropout_autograd_at_a_head_base(dev, t, dtype):
    """The segment dropout path under autograd (``attention_packed`` with
    a seed) on a tensor rank's heads [h0, h0 + H/t), told ``head_base`` =
    h0 and ``heads_total`` = H, equals the whole call's slice bit for bit:
    the output and the gradients of q, k and v."""
    seg = _seg_ids("odd-S", 2, dev)
    q, k, v = (x.detach().requires_grad_(True)
               for x in _qkv_at(64, 2, seg.shape[1], dtype, dev, heads=12))
    do = _randn(q.shape, dtype, dev, seed=5)
    o = fa.attention_packed(q, k, v, seg, "auto", _SEED, _RATE, row_base=3)
    o.backward(do)
    n = 12 // t
    for r in range(t):
        sl = slice(r * n, (r + 1) * n)
        qs, ks, vs = (x.detach()[:, sl].requires_grad_(True)
                      for x in (q, k, v))
        part = fa.attention_packed(qs, ks, vs, seg, "auto", _SEED, _RATE,
                                   row_base=3, head_base=r * n,
                                   heads_total=12)
        part.backward(do[:, sl])
        torch.cuda.synchronize()
        assert torch.equal(part, o[:, sl])
        for got, whole in ((qs, q), (ks, k), (vs, v)):
            assert torch.equal(got.grad, whole.grad[:, sl])


@pytest.mark.parametrize("k", [768, 3072])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_row_partials_of_two_ranks_equal_one_product(dev, out_dtype, k):
    """K = 768 (``wo``) and 3072 (``mlp_out``) split over two emulated
    tensor ranks: each rank's int32 partial on the int8 kernel's int32 out
    form (``int8_train.row_partial``), the two summed as int32, then the
    epilogue once, equal the one-process int8 product's bits. The operands
    sit at ±127 in part, so the sums reach k · 127²; at K = 3072 row 0's
    partials are odd and past 2²⁴ (one and two weights at 126), where
    partials rounded to f32 would miss the int32 sum."""
    from chestxray_vit_tpu_torch.models import int8_train
    g = torch.Generator(device=dev).manual_seed(3)
    m, n = 2308, 768
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)
    xq[0], wq[0] = 127, 127                  # the largest sum
    xq[1], wq[1] = -127, 127
    half = k // 2
    if k == 3072:
        wq[0, 0], wq[0, half:half + 2] = 126, 126
    scale = torch.rand(n, generator=g, device=dev) * 1e-4
    bias = torch.randn(n, generator=g, device=dev)
    whole = i8.int8_matmul_fused(xq, wq, scale, bias, out_dtype=out_dtype)
    parts = [int8_train.row_partial(xq[:, sl].contiguous(),
                                    wq[:, sl].contiguous())
             for sl in (slice(0, half), slice(half, k))]
    acc = parts[0] + parts[1]
    got = (acc.float() * scale + bias).to(out_dtype)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32
    assert int(acc[0, 0]) == k * 127 ** 2 - (3 * 127 if k == 3072 else 0)
    assert torch.equal(got, whole)
