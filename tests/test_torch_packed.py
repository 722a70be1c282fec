"""The port's packed (NaViT-style) path against the JAX package's, on the
CPU: packing, the position-embedding resize, segment-masked attention with
and without dropout, the packed forward and the packed train step.

Inputs come from numpy seeds and go to both sides. The JAX side runs its
segment kernels interpreted (``flash_attention_packed``,
``attention_impl="pallas"``) or its XLA oracle (``"xla"``); the port runs
the plain versions, which is what its wrappers do for CPU tensors.

Pad rows: the Pallas wrapper pads S to its block with id −1 and zero K/V,
so on the JAX side pad *tokens* also see those zero rows and their outputs
differ from the oracle's. The port reads S in place and follows the
oracle. Attention is therefore compared on rows with id ≥ 0 (with the
upstream gradient zero on pad rows), and models on the logits of real
images, which no pad row reaches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.data import packing as jpk
from chestxray_vit_tpu.models import packed as jpm
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.data import packing as tpk
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import packed as tpm
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.train import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False

GRIDS = (2, 3, 4)       # 32 / 48 / 64 px at patch 16
KEYS = ("tokens", "segment_ids", "pos_indices", "pool_weights", "labels",
        "image_mask")
RATE, SEED = 0.3, -12345
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# f32: summation order only; bf16: P and dS round at other points than in
# the interpreted TPU kernel (the bound of tests/test_flash_attention.py)
_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def model_cfg(**kw):
    """The JAX packed tests' model: width 64, 2 layers, 4 heads, MLP 128,
    5 classes, f32."""
    base = dict(img_size=64, patch_size=16, hidden_size=64, num_layers=2,
                num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                attention_impl="xla")
    return ModelConfig(**{**base, **kw})


def jax_cfg(cfg):
    """The JAX package's config with the port's config's fields."""
    if isinstance(cfg, ModelConfig):
        return jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return jconfig.Config(**{
        f.name: getattr(jconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


def params_pair(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), jax_cfg(cfg))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def make_images(rng, sizes, classes=5):
    return ([rng.integers(0, 255, (s, s), np.uint8) for s in sizes],
            [(rng.random(classes) < 0.4).astype(np.float32) for _ in sizes])


def packed_batch(seed, sizes, seq_len=48):
    """A numpy dict batch from the JAX package's packer."""
    imgs, labs = make_images(np.random.default_rng(seed), sizes)
    b = jpk.pack_images(imgs, labs, patch=16, seq_len=seq_len, grids=GRIDS)
    return {k: getattr(b, k) for k in KEYS}


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def fwd_args(batch):
    return [batch[k] for k in KEYS[:4]]


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def pair(arr, dtype):
    j = jnp.asarray(arr, _JAX[dtype])
    return j, torch.from_numpy(to_np(j).copy()).to(_TORCH[dtype])


def assert_trees_close(got, ref, rtol):
    """Leaf by leaf within rtol of the largest |ref| over the tree."""
    ref_leaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref)]
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    scale = max(float(np.abs(a).max()) for a in ref_leaves)
    for path, g, r in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                          jax.tree.leaves(got), ref_leaves):
        err = float(np.abs(g - r).max())
        assert err <= rtol * scale, (jax.tree_util.keystr(path[0]), err)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,seq_len,cap", [
    ([64, 48, 32, 32, 64], 32, None), ([32, 48, 32], 48, None),
    ([32] * 8, 128, 2), ([64, 100, 20, 48], 16, None)])
def test_pack_images_equals_jax(sizes, seq_len, cap):
    imgs, labs = make_images(np.random.default_rng(3), sizes)
    kw = dict(patch=16, seq_len=seq_len, grids=GRIDS, max_imgs_per_seq=cap)
    ref, got = jpk.pack_images(imgs, labs, **kw), tpk.pack_images(imgs, labs,
                                                                  **kw)
    assert got.n_images == ref.n_images
    for k in KEYS:
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tpk.PAD_SEGMENT == jpk.PAD_SEGMENT
    assert tpk.grid_table_offsets(GRIDS) == jpk.grid_table_offsets(GRIDS)
    for h, w in [(64, 64), (47, 90), (10, 10), (500, 33)]:
        assert tpk.choose_grid(h, w, 16, GRIDS) == jpk.choose_grid(
            h, w, 16, GRIDS)


def test_pack_rejects_oversized():
    imgs, labs = make_images(np.random.default_rng(0), [64])
    with pytest.raises(ValueError, match="tokens"):
        tpk.pack_images(imgs, labs, patch=16, seq_len=8, grids=GRIDS)


@pytest.mark.parametrize("kw", [
    {}, {"epoch": 2}, {"shuffle": False, "skip_images": 5},
    {"host_shard": (1, 2)}, {"max_imgs_per_seq": 2}],
    ids=["default", "epoch", "resume", "host-shard", "cap"])
def test_iterate_packed_batches_equals_jax(kw):
    """The streaming packer over the JAX package's fake bucket (the port's
    copy is duck-typed over the index and the store): every array of every
    batch, and the census."""
    from chestxray_vit_tpu.config import DataConfig
    from chestxray_vit_tpu.data.pipeline import build_datasets
    from chestxray_vit_tpu.data.testing import build_fake_nih

    fake = build_fake_nih(num_images=40, image_size=64, seed=7)
    bundle = build_datasets(DataConfig(backend="memory"), store=fake.store)
    args = (bundle.train, bundle.blob_map, fake.store)
    common = dict(batch_seqs=2, patch=16, seq_len=32, grids=GRIDS,
                  num_workers=2, **kw)
    ref = list(jpk.iterate_packed_batches(*args, **common))
    got = list(tpk.iterate_packed_batches(*args, **common))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    counts = tpk.sample_token_counts(*args, grids=GRIDS, sample=8,
                                     num_workers=2)
    assert counts == jpk.sample_token_counts(*args, grids=GRIDS, sample=8,
                                             num_workers=2)
    assert tpk.estimate_sequences_per_epoch(counts, 40, 32, 2) == \
        jpk.estimate_sequences_per_epoch(counts, 40, 32, 2)


# ---------------------------------------------------------------------------
# Position-embedding resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g_old,g_new", [(4, 2), (4, 3), (4, 6), (24, 16),
                                         (24, 32), (5, 5)])
def test_interpolate_pos_embed_matches_jax_and_torch_interpolate(g_old,
                                                                 g_new):
    d = 8
    pe = np.random.default_rng(0).standard_normal(
        (1, g_old * g_old + 1, d)).astype(np.float32)
    got = tvit.interpolate_pos_embed(torch.from_numpy(pe), g_new * g_new + 1)
    ref = jvit.interpolate_pos_embed(jnp.asarray(pe), g_new * g_new + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    grid = torch.from_numpy(pe[:, 1:]).reshape(1, g_old, g_old, d).permute(
        0, 3, 1, 2)
    oracle = torch.nn.functional.interpolate(
        grid, size=(g_new, g_new), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(
        got[:, 1:].numpy(),
        oracle.permute(0, 2, 3, 1).reshape(1, g_new * g_new, d).numpy(),
        atol=1e-5)
    np.testing.assert_array_equal(got[:, :1].numpy(), pe[:, :1])
    np.testing.assert_array_equal(
        tvit._torch_bicubic_weights(g_new, g_old),
        np.asarray(jvit._torch_bicubic_weights(g_new, g_old)))


def test_interpolate_pos_embed_carries_the_gradient():
    pe = torch.randn((1, 17, 8), generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    w = torch.randn((1, 10, 8), generator=torch.Generator().manual_seed(1))
    (tvit.interpolate_pos_embed(pe, 10) * w).sum().backward()
    ref = jax.grad(lambda p: jnp.sum(jvit.interpolate_pos_embed(p, 10)
                                     * jnp.asarray(w.numpy())))(
        jnp.asarray(pe.detach().numpy()))
    np.testing.assert_allclose(pe.grad.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="grid"):
        tvit.interpolate_pos_embed(pe, 12)


def test_adapt_params_to_img_size_and_pos_table():
    cfg = model_cfg()
    jp, tp = params_pair(cfg)
    big = dataclasses.replace(cfg, img_size=96)
    ref = jvit.adapt_params_to_img_size(jp, jax_cfg(big))
    got = tvit.adapt_params_to_img_size(tp, big)
    assert got.pos_embed.shape == (1, 37, 64) and got.cfg is big
    np.testing.assert_allclose(got.pos_embed.detach().numpy(),
                               np.asarray(ref["pos_embed"]), atol=1e-5)
    assert tvit.adapt_params_to_img_size(tp, cfg) is tp
    table = tpm.build_pos_table(tp, cfg, GRIDS)
    assert table.shape == (4 + 9 + 16, 64)
    np.testing.assert_allclose(
        table.detach().numpy(),
        np.asarray(jpm.build_pos_table(jp, jax_cfg(cfg), GRIDS)), atol=1e-5)


# ---------------------------------------------------------------------------
# Segment-masked attention
# ---------------------------------------------------------------------------

def merged_order(ids):
    """Ids in the order a token merge leaves them: even positions, then
    odd ones (contiguous segments interleave)."""
    return np.concatenate([ids[0::2], ids[1::2]])


LAYOUTS = {   # name: (ids of one sequence, the JAX kernel's Q block)
    "contiguous-pad": (np.repeat([0, 1, -1], [40, 35, 21]), 128),
    "interleaved-ragged": (merged_order(np.repeat([0, 1, -1],
                                                  [40, 40, 16]))[:89], 128),
    "ragged-multi-block": (np.repeat([2, 0, 1, -1], [30, 20, 22, 5]), 32),
    "first-tiles-foreign": (np.repeat([3, 0, 7], [128, 40, 32]), 128),
    "one-segment": (np.zeros(48, np.int64), 128),
    "unsorted": (np.random.default_rng(5).integers(-1, 3, 70), 32),
}


def attention_inputs(name, dtype, seed=0, b=2, h=2, d=64):
    ids, block_q = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    seg = np.stack([np.roll(ids, 3 * i) if name == "unsorted" else ids
                    for i in range(b)]).astype(np.int32)
    qkv = [pair(rng.standard_normal((b, h, len(ids), d)).astype(np.float32),
                dtype) for _ in range(3)]
    do = rng.standard_normal((b, h, len(ids), d)).astype(np.float32)
    do[np.broadcast_to((seg < 0)[:, None, :, None], do.shape)] = 0.0
    return qkv, seg, pair(do, dtype), block_q


def close_on_real_rows(got, ref, seg, tol):
    """|got − ref| ≤ tol · max(1, max |ref|) on rows with id ≥ 0."""
    got, ref = to_np(got), to_np(ref)
    real = np.broadcast_to((seg >= 0)[:, None, :, None], ref.shape)
    bound = tol * max(1.0, float(np.abs(ref[real]).max()))
    err = float(np.abs(got - ref)[real].max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_attention_forward_matches_jax(layout, dtype):
    ((jq, tq), (jk, tk), (jv, tv)), seg, _, block_q = attention_inputs(
        layout, dtype)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    kernel = jfa.flash_attention_packed(jq, jk, jv, jseg, None, block_q)
    oracle = jfa.attention_xla_packed(jq, jk, jv, jseg)
    o, lse = tfa.attention_packed_fwd_reference(tq, tk, tv, tseg)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    close_on_real_rows(o, kernel, seg, _TOL[dtype])
    # the oracle has the port's pad-row semantics: every row
    close_on_real_rows(o, oracle, np.zeros_like(seg), _TOL[dtype])
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = tfa.flash_attention_packed_fwd.launches
    o2, lse2 = tfa.flash_attention_packed_fwd(tq, tk, tv, tseg)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert tfa.flash_attention_packed_fwd.launches == before
    assert torch.equal(tfa.attention_packed_reference(tq, tk, tv, tseg), o)
    assert torch.equal(tfa.attention_packed(tq, tk, tv, tseg, "xla"), o)


def test_packed_attention_lse_is_the_segment_logsumexp():
    ((_, q), (_, k), (_, v)), seg, _, _ = attention_inputs("contiguous-pad",
                                                           "float32")
    _, lse = tfa.attention_packed_fwd_reference(q, k, v,
                                                torch.from_numpy(seg))
    s = torch.matmul(q, k.transpose(-1, -2)) / 8.0
    for row in (0, 39, 40, 74, 75, 95):
        same = torch.from_numpy(seg[0] == seg[0, row])
        torch.testing.assert_close(
            lse[0, 1, row], torch.logsumexp(s[0, 1, row][same], dim=0))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_attention_gradients_match_jax(layout, dtype):
    ((jq, tq), (jk, tk), (jv, tv)), seg, (jdo, tdo), block_q = \
        attention_inputs(layout, dtype, seed=1)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    jdo32 = jdo.astype(jnp.float32)
    tol = _TOL[dtype]

    def f(q, k, v):
        o = jfa.flash_attention_packed(q, k, v, jseg, None, block_q)
        return jnp.sum(o.astype(jnp.float32) * jdo32)

    ref = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = tfa.attention_packed_fwd_reference(tq, tk, tv, tseg)
    plain = tfa.attention_packed_bwd_reference(tq, tk, tv, tseg, o, lse, tdo)
    wrapped = tfa.flash_attention_packed_bwd(tq, tk, tv, tseg, o, lse, tdo)
    for got, again, r in zip(plain, wrapped, ref):
        assert got.dtype == tq.dtype and torch.isfinite(got).all()
        assert torch.equal(again, got)
        close_on_real_rows(got, r, seg, tol)
    # plain autograd and the autograd function (plain wrappers on the CPU)
    for run in (lambda q, k, v: tfa.flash_attention_packed(q, k, v, tseg),
                lambda q, k, v: tfa.FlashAttentionPacked.apply(q, k, v,
                                                               tseg)):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        (run(*leaves).float() * tdo.float()).sum().backward()
        for leaf, r in zip(leaves, ref):
            close_on_real_rows(leaf.grad, r, seg, tol)


def test_packed_attention_isolates_segments():
    """Changing one segment's tokens leaves the other rows bit for bit,
    at interleaved ids."""
    ((_, q), (_, k), (_, v)), seg, _, _ = attention_inputs(
        "interleaved-ragged", "float32")
    tseg = torch.from_numpy(seg)
    other = torch.from_numpy(seg[0] == 1)
    q2, k2, v2 = (t.clone() for t in (q, k, v))
    for t in (q2, k2, v2):
        t[:, :, other] += 1.0
    a = tfa.attention_packed_reference(q, k, v, tseg)
    b = tfa.attention_packed_reference(q2, k2, v2, tseg)
    assert torch.equal(a[:, :, ~other], b[:, :, ~other])
    assert not torch.allclose(a[:, :, other], b[:, :, other])


def test_packed_mask_strides_follow_the_tpu_wrapper():
    """q_pad = s_pad = S padded to the Q block, and the Q block of
    ``_packed_mha``: 384 when it tiles pad128(S), else 128."""
    assert tfa.packed_block_q(1152) == 384
    assert tfa.packed_block_q(1136) == 384       # pad128 = 1152
    assert tfa.packed_block_q(1100) == 384
    assert tfa.packed_block_q(1000) == 128       # pad128 = 1024
    assert tfa.packed_block_q(48) == 128
    assert tfa.packed_mask_strides(1152, 384) == (1152, 1152)
    assert tfa.packed_mask_strides(1136, 384) == (1152, 1152)
    assert tfa.packed_mask_strides(48, 128) == (128, 128)
    assert tfa.packed_mask_strides(200, 128) == (256, 256)
    assert tfa.packed_mask_strides(577, 640) != tfa.mask_strides(577, 640)
    for s in (48, 200, 1136, 1152):
        bq = tfa.packed_block_q(s)
        assert tfa.packed_mask_strides(s, bq)[1] == jfa._pad_len(s, bq)


def test_keep_mask_counter_wraps_like_uint32():
    """Past B·H·S_pad² = 2³² the counter wraps as the TPU kernel's uint32
    arithmetic does: the row product and the hash, on rows near the wrap
    (the whole mask of such a batch would not fit a test)."""
    pad = 1152
    rows = np.array([0, 1, 3_728_270, 3_728_271, 3_916_799, 2 ** 32 - 1],
                    np.uint32)                   # 3,728,270 · 1152 < 2³²
    cols = np.arange(pad - 3, pad, dtype=np.uint32)
    mix, thr = tfa.dropout_constants(SEED, RATE)
    with np.errstate(over="ignore"):
        base = rows * np.uint32(pad)
        x = (base[:, None] + cols[None, :]) ^ np.uint32(mix)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    assert int(rows[3]) * pad > 2 ** 32 > int(rows[2]) * pad
    trows = torch.from_numpy(rows.astype(np.int64))
    tbase = tfa._mul32(trows, pad)
    np.testing.assert_array_equal(tbase.numpy(), base.astype(np.int64))
    counter = (tbase[:, None] + torch.from_numpy(cols.astype(np.int64))) \
        & 0xFFFFFFFF
    np.testing.assert_array_equal(tfa._fmix32(counter ^ mix).numpy(),
                                  x.astype(np.int64))
    # and the mask itself is that hash against the threshold
    keep = tfa.keep_mask(2, pad, pad, SEED, RATE)
    np.testing.assert_array_equal(
        keep[1, 5, -3:].numpy(),
        (tfa._fmix32((torch.tensor((pad + 5) * pad) + torch.from_numpy(
            cols.astype(np.int64))) ^ mix) >= thr).numpy())


DROP_CASES = {   # name: (layout, the JAX kernel's Q block)
    "S48-one-block": ("one-segment", 128),
    "S96-block32": ("contiguous-pad", 32),
    "S200-two-blocks": ("first-tiles-foreign", 128),
    "S89-interleaved": ("interleaved-ragged", 128),
    "S77-ragged-block32": ("ragged-multi-block", 32),
}


@pytest.mark.parametrize("case", sorted(DROP_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_dropout_forward_and_gradients_match_jax(case, dtype):
    """The plain dropout twins against the interpreted
    ``flash_attention_packed_dropout`` with the same seed: the mask is
    held through the outputs (the JAX package has no segment debug
    kernel)."""
    layout, block_q = DROP_CASES[case]
    ((jq, tq), (jk, tk), (jv, tv)), seg, (jdo, tdo), _ = attention_inputs(
        layout, dtype, seed=2)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    jseed = jnp.asarray([SEED], jnp.int32)
    jdo32 = jdo.astype(jnp.float32)
    tol = _TOL[dtype]

    def f(q, k, v):
        o = jfa.flash_attention_packed_dropout(q, k, v, jseg, jseed, RATE,
                                               None, block_q)
        return jnp.sum(o.astype(jnp.float32) * jdo32), o

    (_, ref_o), ref = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)
    o, lse = tfa.attention_packed_dropout_fwd_reference(
        tq, tk, tv, tseg, SEED, RATE, None, block_q)
    close_on_real_rows(o, ref_o, seg, tol)
    # lse is the clean segment softmax's
    torch.testing.assert_close(
        lse, tfa.attention_packed_fwd_reference(tq, tk, tv, tseg)[1])
    # dropout is on, and the dense strides would give another mask
    assert not torch.allclose(
        o, tfa.attention_packed_fwd_reference(tq, tk, tv, tseg)[0])
    plain = tfa.attention_packed_dropout_bwd_reference(
        tq, tk, tv, tseg, o, lse, tdo, SEED, RATE, None, block_q)
    wrapped = tfa.flash_attention_packed_dropout_bwd(
        tq, tk, tv, tseg, o, lse, tdo, SEED, RATE, None, block_q)
    for got, again, r in zip(plain, wrapped, ref):
        assert torch.equal(again, got)
        close_on_real_rows(got, r, seg, tol)
    for run in (lambda q, k, v: tfa.flash_attention_packed_dropout(
                    q, k, v, tseg, SEED, RATE, None, block_q),
                lambda q, k, v: tfa.FlashAttentionPackedDropout.apply(
                    q, k, v, tseg, SEED, RATE, None, block_q)):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = run(*leaves)
        assert torch.equal(out.detach(), o)
        (out.float() * tdo.float()).sum().backward()
        for leaf, r in zip(leaves, ref):
            close_on_real_rows(leaf.grad, r, seg, tol)


def test_packed_dropout_dispatch_uses_the_automatic_block():
    ((_, q), (_, k), (_, v)), seg, _, _ = attention_inputs("contiguous-pad",
                                                           "float32")
    tseg = torch.from_numpy(seg)
    want = tfa.attention_packed_dropout_fwd_reference(
        q, k, v, tseg, SEED, RATE, None, tfa.packed_block_q(96))[0]
    for impl in ("auto", "pallas", "xla"):
        assert torch.equal(tfa.attention_packed(q, k, v, tseg, impl, SEED,
                                                RATE), want)
    assert torch.equal(tfa.attention_packed(q, k, v, tseg, "auto", None,
                                            RATE),
                       tfa.attention_packed_reference(q, k, v, tseg))
    with pytest.raises(ValueError, match="impl"):
        tfa.attention_packed(q, k, v, tseg, "cudnn")


# ---------------------------------------------------------------------------
# The packed forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("remat", [False, True])
def test_apply_packed_logits_match_jax(impl, dtype, tol, remat):
    cfg = model_cfg(attention_impl=impl, dtype=dtype, remat=remat)
    jp, tp = params_pair(cfg)
    batch = packed_batch(0, [64, 48, 32, 32, 48, 64, 32])
    ref = jpm.apply_packed(jp, *fwd_args(jx(batch)), jax_cfg(cfg), GRIDS,
                           train=remat)
    got = tpm.apply_packed(tp, *fwd_args(tt(batch)), cfg, GRIDS, train=remat)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    mask = batch["image_mask"]
    assert mask.sum() == 7 and np.isfinite(to_np(got)).all()
    np.testing.assert_allclose(to_np(got)[mask], to_np(ref)[mask], atol=tol)


def test_apply_packed_isolation():
    """Changing one image leaves the other image's logits."""
    rng = np.random.default_rng(1)
    imgs, labs = make_images(rng, [48, 48])
    imgs2 = [imgs[0], rng.integers(0, 255, (48, 48), np.uint8)]
    cfg = model_cfg()
    _, tp = params_pair(cfg, 1)
    out = []
    for pics in (imgs, imgs2):
        b = tpk.pack_images(pics, labs, patch=16, seq_len=32, grids=GRIDS)
        assert b.tokens.shape[0] == 1
        with torch.no_grad():
            out.append(tpm.apply_packed(
                tp, *(torch.from_numpy(getattr(b, k)) for k in KEYS[:4]),
                cfg, GRIDS).numpy())
    np.testing.assert_allclose(out[0][0, 0], out[1][0, 0], atol=1e-6)
    assert np.abs(out[0][0, 1] - out[1][0, 1]).max() > 1e-3


def test_apply_packed_dropout_is_seeded_and_off_in_eval():
    cfg = model_cfg(hidden_dropout=0.3, attention_dropout=0.2)
    _, tp = params_pair(cfg, 2)
    args = fwd_args(tt(packed_batch(2, [32, 48, 32])))
    seeds = [(5, 6, 7), (-8, 9, 10)]
    with torch.no_grad():
        base = tpm.apply_packed(tp, *args, model_cfg(), GRIDS)
        a = tpm.apply_packed(tp, *args, cfg, GRIDS, train=True,
                             dropout_seeds=seeds)
        b = tpm.apply_packed(tp, *args, cfg, GRIDS, train=True,
                             dropout_seeds=seeds)
        c = tpm.apply_packed(tp, *args, cfg, GRIDS, train=True,
                             dropout_seeds=[(1, 2, 3), (4, 5, 6)])
        assert torch.equal(a, b) and not torch.allclose(a, base)
        assert not torch.allclose(a, c)
        # eval mode, and train without seeds, ignore the rates
        assert torch.equal(tpm.apply_packed(tp, *args, cfg, GRIDS), base)
        assert torch.equal(tpm.apply_packed(tp, *args, cfg, GRIDS,
                                            train=True), base)
        with pytest.raises(ValueError, match="seed"):
            tpm.apply_packed(tp, *args, cfg, GRIDS, train=True,
                             dropout_seeds=seeds[:1])


def test_packed_bce_parts_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 4, 5)).astype(np.float32) * 3
    labels = (rng.random((3, 4, 5)) < 0.4).astype(np.float32)
    mask = rng.random((3, 4)) < 0.6
    ref = jpm.packed_bce_parts(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(mask))
    got = tpm.packed_bce_parts(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    assert float(got[1]) == float(ref[1]) == mask.sum() * 5
    np.testing.assert_allclose(
        float(tpm.packed_bce_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask))),
        float(jpm.packed_bce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(mask))), rtol=1e-6)
    none = torch.zeros((3, 4), dtype=torch.bool)
    assert float(tpm.packed_bce_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels), none)) == 0.0


# ---------------------------------------------------------------------------
# The packed train step
# ---------------------------------------------------------------------------

def train_cfg(accum=1, **model):
    return Config(model=model_cfg(**model),
                  train=TrainConfig(learning_rate=2e-3, warmup_steps=1,
                                    gradient_accumulation_steps=accum))


def jax_grads(params, cfg, batch, rng):
    """The gradient of the JAX packed loss for one big batch."""
    jc = jax_cfg(cfg)
    fwd = jpm.apply_packed_tome if cfg.model.tome_r > 0 else jpm.apply_packed

    def loss(p):
        logits = fwd(p, *fwd_args(batch), jc.model, GRIDS, train=True,
                     rng=rng)
        return jpm.packed_bce_loss(logits, batch["labels"],
                                   batch["image_mask"])
    return jax.jit(jax.grad(loss))(params)


def jax_attention_seeds(state_rng, cfg):
    """The attention seeds the JAX packed step derives from ``state.rng``
    (accum 1): the step key split per layer, ``_dropout_seed(sub, 2)``."""
    _, key = jax.random.split(state_rng)
    seeds = []
    for _ in range(cfg.model.num_layers):
        key, sub = jax.random.split(key)
        seeds.append((int(jvit._dropout_seed(sub, 2)[0]), 0, 0))
    return [tsteps.Draws(seeds=seeds)]


def run_steps_against_jax(cfg, batches, draws_of=None):
    jp, tp = params_pair(cfg.model)
    jstep = jax.jit(jsteps.make_packed_train_step(jax_cfg(cfg), 100, GRIDS))
    tstep = tsteps.make_packed_train_step(cfg, 100, GRIDS)
    jstate = jsteps.TrainState.create(jp, seed=0)
    tstate = tsteps.TrainState.create(tp, seed=0)
    accum = cfg.train.gradient_accumulation_steps
    for batch in batches:
        jb = jx(batch)
        draws = draws_of(jstate.rng) if draws_of else None
        if accum == 1:
            grads = jax_grads(jstate.params, cfg, jb,
                              jax.random.split(jstate.rng)[1])
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tt(batch), draws)
        assert tm["loss"].dtype == torch.float32 and tm["loss"].dim() == 0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        if accum == 1:
            assert_trees_close(bridge.grads_to_numpy(tstate.params), grads,
                               rtol=1e-4)
    assert tstate.step == int(jstate.step) == len(batches)
    got = bridge.opt_state_to_numpy(tstate.opt_state)
    for moment in ("mu", "nu"):
        assert_trees_close(got[moment], jstate.opt_state[moment], rtol=1e-4)
    assert_trees_close(bridge.params_to_numpy(tstate.params), jstate.params,
                       rtol=1e-4)
    return tstate


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("remat", [False, True])
def test_packed_train_step_matches_jax(impl, remat):
    """Three steps on three packed batches: loss, grad_norm, lr, every
    gradient leaf, then the moments and the weights."""
    cfg = train_cfg(attention_impl=impl, remat=remat)
    batches = [packed_batch(i, [64, 48, 32, 48, 64, 32], seq_len=32)
               for i in range(3)]
    run_steps_against_jax(cfg, batches)


def unequal_batch(seed=0, n_seqs=8, seq_len=32):
    """tests/test_packed_accum.py's batch: 8 sequences whose two strided
    micro-batches hold unequal real-image counts."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.choice([32, 48, 64])) for _ in range(n_seqs * 2)]
    imgs, labs = make_images(rng, sizes)
    b = jpk.pack_images(imgs, labs, patch=16, seq_len=seq_len, grids=GRIDS)

    def fit(x):
        out = np.zeros((n_seqs,) + x.shape[1:], x.dtype)
        m = min(n_seqs, x.shape[0])
        out[:m] = x[:m]
        return out

    batch = {k: fit(getattr(b, k)) for k in KEYS}
    batch["segment_ids"][b.segment_ids.shape[0]:] = jpk.PAD_SEGMENT
    mask = batch["image_mask"]
    if mask[0::2].sum() == mask[1::2].sum():
        s = next(i for i in range(0, n_seqs, 2) if mask[i].any())
        mask[s, int(np.nonzero(mask[s])[0][-1])] = False
    assert mask[0::2].sum() != mask[1::2].sum()
    return batch


def test_packed_accumulation_over_unequal_image_counts_matches_jax():
    """accum 2 against JAX's accum 2, and against the port's one big
    batch: the numerators' gradients are summed and divided once."""
    batch = unequal_batch()
    acc = run_steps_against_jax(train_cfg(accum=2), [batch] * 3)
    big = run_steps_against_jax(train_cfg(accum=1), [batch] * 3)
    for (n, a), (_, b) in zip(acc.params.named_parameters(),
                              big.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=2e-4, err_msg=n)
    # averaging the two micro-batch losses is another number
    cfg = train_cfg()
    _, tp = params_pair(cfg.model)
    halves = []
    for i in range(2):
        micro = {k: torch.from_numpy(v[i::2]) for k, v in batch.items()}
        with torch.no_grad():
            logits = tpm.apply_packed(tp, *fwd_args(micro), cfg.model, GRIDS)
            halves.append(tpm.packed_bce_parts(logits, micro["labels"],
                                               micro["image_mask"]))
    exact = float((halves[0][0] + halves[1][0])
                  / (halves[0][1] + halves[1][1]))
    naive = float((halves[0][0] / halves[0][1]
                   + halves[1][0] / halves[1][1]) / 2)
    _, m = tsteps.make_packed_train_step(train_cfg(accum=2), 100, GRIDS)(
        tsteps.TrainState.create(tp, 0), tt(batch))
    np.testing.assert_allclose(float(m["loss"]), exact, rtol=1e-6)
    assert abs(naive - exact) > 1e-4


@pytest.mark.parametrize("remat", [False, True])
def test_packed_train_step_with_jax_attention_seeds(remat):
    """attention_dropout 0.2 with the JAX step's per-layer seeds injected
    (its kernels interpreted): loss, grad_norm, gradients, two steps."""
    cfg = train_cfg(attention_impl="pallas", attention_dropout=0.2,
                    remat=remat)
    batches = [packed_batch(i, [64, 48, 32, 48, 64, 32], seq_len=32)
               for i in range(2)]
    run_steps_against_jax(cfg, batches,
                          lambda rng: jax_attention_seeds(rng, cfg))
    # dropout was on: other seeds move the loss
    _, tp = params_pair(cfg.model)
    step = tsteps.make_packed_train_step(cfg, 100, GRIDS)
    losses = [float(step(tsteps.TrainState.create(
        params_pair(cfg.model)[1], 0), tt(batches[0]),
        [tsteps.Draws(seeds=[(s, 0, 0), (s + 1, 0, 0)])])[1]["loss"])
        for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]


def test_packed_train_step_draws_from_the_state_generator():
    cfg = train_cfg(hidden_dropout=0.3, attention_dropout=0.2)
    batch = tt(packed_batch(0, [64, 48, 32, 48], seq_len=32))
    step = tsteps.make_packed_train_step(cfg, 100, GRIDS)
    losses = []
    for seed in (1, 1, 2):
        state = tsteps.TrainState.create(params_pair(cfg.model)[1], seed)
        torch.manual_seed(seed * 77)        # the global RNG plays no part
        losses.append(float(step(state, batch)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="draws"):
        step(tsteps.TrainState.create(params_pair(cfg.model)[1], 0), batch,
             [tsteps.Draws(), tsteps.Draws()])


def test_packed_train_step_loss_decreases():
    cfg = train_cfg(remat=True)
    state = tsteps.TrainState.create(params_pair(cfg.model, 5)[1], 0)
    step = tsteps.make_packed_train_step(cfg, 100, GRIDS)
    batch = tt(packed_batch(4, [64, 48, 32, 48, 64, 32], seq_len=32))
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert state.params.cls_token.grad.abs().max() == 0   # pooled readout
