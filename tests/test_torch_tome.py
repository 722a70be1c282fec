"""The port's token merging (``ops/tome.py``) and the merged packed forward
and train step against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides. Ties are the point of
several cases: on padded packed inputs every pad–pad pair scores exactly
2.0, and the port has to pick the pairs ``jax.lax.top_k`` and ``argmax``
pick (lowest index first).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu.data import packing as jpk
from chestxray_vit_tpu.models import packed as jpm
from chestxray_vit_tpu.ops import tome as jtome
from chestxray_vit_tpu_torch.config import Config, TrainConfig
from chestxray_vit_tpu_torch.models import packed as tpm
from chestxray_vit_tpu_torch.ops import tome as ttome
from chestxray_vit_tpu_torch.train import steps as tsteps

from test_torch_packed import (GRIDS, KEYS, fwd_args,
                               jax_attention_seeds, jax_cfg, jx, model_cfg,
                               packed_batch, params_pair,
                               run_steps_against_jax, to_np, tt)

torch.backends.cuda.matmul.allow_tf32 = False

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("r,layers,schedule", [
    (16, 12, "constant"), (16, 12, "decreasing"), (2, 2, "decreasing"),
    (7, 5, "decreasing"), (0, 3, "decreasing"), (32, 24, "decreasing")])
def test_r_schedule_equals_jax(r, layers, schedule):
    got = ttome.r_schedule(r, layers, schedule)
    assert got == jtome.r_schedule(r, layers, schedule)
    assert sum(got) == r * layers
    for bad in ((-1, 2, "constant"), (1, 0, "constant"), (1, 2, "linear")):
        with pytest.raises(ValueError):
            ttome.r_schedule(*bad)


def dense_inputs(seed, b=3, s=21, d=16, dim=24, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, dim)).astype(np.float32)
    metric = rng.standard_normal((b, s, d)).astype(np.float32)
    if ties:        # equal keys: equal scores across many pairs
        metric[:, 3:15] = metric[:, 3:4]
    sizes = rng.integers(1, 4, (b, s)).astype(np.float32)
    return x, metric, sizes


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("s,r", [(21, 4), (20, 9), (7, 1)])
def test_bipartite_matching_and_merge_equal_jax(s, r, ties):
    x, metric, sizes = dense_inputs(0, s=s, ties=ties)
    ref = jtome.bipartite_soft_matching(jnp.asarray(metric), r)
    got = ttome.bipartite_soft_matching(torch.from_numpy(metric), r)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ref_x, ref_sz = jtome.merge_tokens(jnp.asarray(x), jnp.asarray(sizes),
                                       *ref)
    got_x, got_sz = ttome.merge_tokens(torch.from_numpy(x),
                                       torch.from_numpy(sizes), *got)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=1e-6)
    np.testing.assert_array_equal(got_sz.numpy(), np.asarray(ref_sz))
    # the CLS token is never a source and stays at position 0
    np.testing.assert_allclose(got_x[:, 0].numpy(), x[:, 0], atol=1e-6)
    with pytest.raises(ValueError, match="must be in"):
        ttome.bipartite_soft_matching(torch.from_numpy(metric), (s + 1) // 2)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tome_merge_is_merge_of_matching_and_equals_jax(ties, dtype):
    x, metric, sizes = dense_inputs(1, ties=ties)
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    tm, ts = torch.from_numpy(metric), torch.from_numpy(sizes)
    fused = ttome.tome_merge(tx, tm, ts, 5)
    split = ttome.merge_tokens(tx, ts, *ttome.bipartite_soft_matching(tm, 5))
    for a, b in zip(fused, split):
        assert torch.equal(a, b)
    ref = jtome.tome_merge(jnp.asarray(x, _JAX[dtype]), jnp.asarray(metric),
                           jnp.asarray(sizes), 5)
    assert fused[0].dtype == tx.dtype and fused[1].dtype == torch.float32
    # bf16: the routing product's result is read back from bf16 here and
    # from f32 there (one bf16 rounding of a sum of a few tokens)
    tol = 1e-6 if dtype == "float32" else 2e-2
    scale = max(1.0, float(np.abs(to_np(ref[0])).max()))
    assert np.abs(to_np(fused[0]) - to_np(ref[0])).max() <= tol * scale
    np.testing.assert_array_equal(fused[1].numpy(), np.asarray(ref[1]))


def packed_inputs(seed, b=3, d=16, dim=24, dtype="float32", layout="pad"):
    """Three segments and a pad tail whose tokens are identical (zero
    metric and zero x, as the packed forward leaves padding), optionally
    in the interleaved order an earlier merge leaves."""
    rng = np.random.default_rng(seed)
    counts = {"pad": [9, 7, 4, 12], "no-pad": [14, 10, 8, 0],
              "mostly-pad": [3, 2, 0, 27], "interleaved": [9, 7, 4, 12]}
    ids = np.repeat([0, 1, 2, -1], counts[layout])
    if layout == "interleaved":
        ids = np.concatenate([ids[0::2], ids[1::2]])[:29]
    s = len(ids)
    seg = np.stack([ids] * b).astype(np.int32)
    x = rng.standard_normal((b, s, dim)).astype(np.float32)
    metric = rng.standard_normal((b, s, d)).astype(np.float32)
    x[seg < 0], metric[seg < 0] = 0.0, 0.0
    sizes = np.ones((b, s), np.float32)
    pw = np.zeros((b, 3, s), np.float32)
    for m in range(3):
        n = max(int((ids == m).sum()), 1)
        pw[:, m, ids == m] = 1.0 / n
    return x, metric, sizes, seg, pw


@pytest.mark.parametrize("layout,r", [
    ("pad", 5), ("pad", 12), ("no-pad", 6), ("mostly-pad", 13),
    ("interleaved", 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tome_merge_packed_equals_jax_output_for_output(layout, r, dtype):
    """x, sizes, segment ids and pool weights, on tie-laden padded inputs
    (every pad pair scores 2.0)."""
    x, metric, sizes, seg, pw = packed_inputs(2, dtype=dtype, layout=layout)
    ref = jtome.tome_merge_packed(
        jnp.asarray(x, _JAX[dtype]), jnp.asarray(metric), jnp.asarray(sizes),
        jnp.asarray(seg), jnp.asarray(pw), r)
    got = ttome.tome_merge_packed(
        torch.from_numpy(x).to(_TORCH[dtype]), torch.from_numpy(metric),
        torch.from_numpy(sizes), torch.from_numpy(seg), torch.from_numpy(pw),
        r)
    gx, gsz, gseg, gpw = got
    assert gx.shape == (3, x.shape[1] - r, 24) and gx.dtype == _TORCH[dtype]
    assert gsz.dtype == torch.float32 and gpw.dtype == torch.float32
    assert gseg.dtype == torch.int32 and gseg.is_contiguous()
    tol = 1e-6 if dtype == "float32" else 2e-2
    scale = max(1.0, float(np.abs(to_np(ref[0])).max()))
    assert np.abs(to_np(gx) - to_np(ref[0])).max() <= tol * scale
    np.testing.assert_array_equal(gsz.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(gseg.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(gpw.numpy(), np.asarray(ref[3]), atol=1e-7)
    assert (gseg.numpy() >= -1).all()       # the −2 init never survives


def test_tome_merge_packed_stays_within_segments_and_merges_pads_first():
    x, metric, sizes, seg, pw = packed_inputs(3)
    gx, gsz, gseg, gpw = ttome.tome_merge_packed(
        *(torch.from_numpy(a) for a in (x, metric, sizes, seg, pw)), 5)
    gseg, gsz = gseg.numpy(), gsz.numpy()
    for b in range(3):
        # 5 merges < the 6 pad pairs: every real token is untouched
        for sid, n in [(0, 9), (1, 7), (2, 4), (-1, 12)]:
            assert gsz[b][gseg[b] == sid].sum() == n
        assert (gsz[b][gseg[b] >= 0] == 1.0).all()
    np.testing.assert_allclose(gpw.numpy().sum(-1), pw.sum(-1), rtol=1e-6)
    # weighted content is conserved
    np.testing.assert_allclose(np.einsum("bs,bsd->bd", gsz, gx.numpy()),
                               np.einsum("bs,bsd->bd", sizes, x), atol=1e-5)
    # past the pad budget merges stay inside segments
    _, gsz, gseg, _ = ttome.tome_merge_packed(
        *(torch.from_numpy(a) for a in (x, metric, sizes, seg, pw)), 12)
    for sid, n in [(0, 9), (1, 7), (2, 4), (-1, 12)]:
        assert gsz[0][gseg[0] == sid].sum() == n
    with pytest.raises(ValueError, match="must be in"):
        ttome.tome_merge_packed(
            *(torch.from_numpy(a) for a in (x, metric, sizes, seg, pw)), 16)


def test_tome_merge_carries_the_gradient_of_the_means_only():
    x, metric, sizes, seg, pw = packed_inputs(4)
    tx = torch.from_numpy(x).requires_grad_()
    tm = torch.from_numpy(metric).requires_grad_()
    w = torch.randn((3, 32 - 7, 24), generator=torch.Generator().manual_seed(0))
    out = ttome.tome_merge_packed(tx, tm, torch.from_numpy(sizes),
                                  torch.from_numpy(seg),
                                  torch.from_numpy(pw), 7)
    (out[0] * w).sum().backward()
    ref = jax.grad(lambda a: jnp.sum(jtome.tome_merge_packed(
        a, jnp.asarray(metric), jnp.asarray(sizes), jnp.asarray(seg),
        jnp.asarray(pw), 7)[0] * jnp.asarray(w.numpy())))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), atol=1e-6)
    assert tm.grad is None              # the matching is piecewise constant


# ---------------------------------------------------------------------------
# The merged packed forward and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("r,schedule,remat", [
    (2, "decreasing", False), (4, "constant", True), (30, "constant", False)])
def test_apply_packed_tome_logits_match_jax(impl, dtype, tol, r, schedule,
                                            remat):
    """The merged forward; r = 30 runs into the per-layer clamp."""
    cfg = model_cfg(attention_impl=impl, dtype=dtype, remat=remat, tome_r=r,
                    tome_schedule=schedule)
    jp, tp = params_pair(cfg, 3)
    batch = packed_batch(1, [64, 48, 32, 32, 48, 64, 32])
    ref = jpm.apply_packed_tome(jp, *fwd_args(jx(batch)), jax_cfg(cfg),
                                GRIDS, train=remat)
    got = tpm.apply_packed_tome(tp, *fwd_args(tt(batch)), cfg, GRIDS,
                                train=remat)
    mask = batch["image_mask"]
    assert got.dtype == torch.float32 and np.isfinite(to_np(got)).all()
    np.testing.assert_allclose(to_np(got)[mask], to_np(ref)[mask], atol=tol)


def test_pad_budget_merge_preserves_logits():
    """A budget the padding absorbs leaves the real images' logits: merging
    is within segments and the routed pool weights keep the readout."""
    cfg = model_cfg()
    _, tp = params_pair(cfg)
    args = fwd_args(tt(packed_batch(0, [32, 48], seq_len=48)))
    with torch.no_grad():
        base = tpm.apply_packed(tp, *args, cfg, GRIDS)
        merged = tpm.apply_packed_tome(
            tp, *args, dataclasses.replace(cfg, tome_r=4), GRIDS)
    np.testing.assert_allclose(merged[0, :2].numpy(), base[0, :2].numpy(),
                               atol=2e-4)


def test_apply_packed_tome_returns_the_ids_each_layer_saw():
    """``return_segment_ids``: the same logits, and per layer the ids at
    that layer's length: the lengths follow the schedule, the first entry
    is the input, and no id appears that the input lacked."""
    cfg = model_cfg(tome_r=4, tome_schedule="constant")
    _, tp = params_pair(cfg)
    batch = tt(packed_batch(2, [64, 48, 32, 32]))
    args = fwd_args(batch)
    with torch.no_grad():
        plain = tpm.apply_packed_tome(tp, *args, cfg, GRIDS)
        logits, seen = tpm.apply_packed_tome(tp, *args, cfg, GRIDS,
                                             return_segment_ids=True)
    np.testing.assert_array_equal(logits.numpy(), plain.numpy())
    seg = batch["segment_ids"]
    s = seg.shape[1]
    assert [t.shape[1] for t in seen] == [s - 4 * i
                                          for i in range(cfg.num_layers)]
    assert seen[0] is seg
    ids = set(seg.unique().tolist())
    assert all(set(t.unique().tolist()) <= ids for t in seen)


def test_apply_packed_tome_refuses_what_the_reference_refuses():
    cfg = model_cfg()
    _, tp = params_pair(cfg)
    args = fwd_args(tt(packed_batch(0, [32, 48])))
    with pytest.raises(ValueError, match="positive"):
        tpm.apply_packed_tome(tp, *args, cfg, GRIDS)
    with pytest.raises(ValueError, match="fused_qkv"):
        tpm.apply_packed_tome(tp, *args, dataclasses.replace(
            cfg, tome_r=2, fused_qkv=True), GRIDS)


def tome_train_cfg(accum=1, **model):
    kw = dict(tome_r=2, tome_schedule="decreasing")
    return Config(model=model_cfg(**{**kw, **model}),
                  train=TrainConfig(learning_rate=2e-3, warmup_steps=1,
                                    gradient_accumulation_steps=accum))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("remat", [False, True])
def test_packed_tome_train_step_matches_jax(impl, remat):
    cfg = tome_train_cfg(attention_impl=impl, remat=remat)
    batches = [packed_batch(i, [64, 48, 32, 48, 64, 32], seq_len=32)
               for i in range(3)]
    run_steps_against_jax(cfg, batches)


def test_packed_tome_train_step_with_jax_attention_seeds():
    """The segment dropout twins at the merged lengths, whose mask strides
    follow each layer's own S."""
    cfg = tome_train_cfg(attention_impl="pallas", attention_dropout=0.2,
                         remat=True)
    batches = [packed_batch(i, [64, 48, 32, 48, 64, 32], seq_len=32)
               for i in range(2)]
    run_steps_against_jax(cfg, batches,
                          lambda rng: jax_attention_seeds(rng, cfg))


def test_packed_tome_golden_trajectory():
    """The pinned ten-step loss path of tests/test_packed_tome.py (CPU f32,
    fixed seeds), from the JAX package's ``jax.random.key(7)`` weights
    bridged into the port."""
    golden = [0.69683367, 0.60803425, 0.53642815, 0.47607034, 0.43201065,
              0.39969572, 0.37361142, 0.35013288, 0.32860592, 0.30870613]
    r = np.random.default_rng(11)
    imgs = [r.integers(0, 255, (s, s), np.uint8)
            for s in [64, 48, 32, 48, 64, 32]]
    labs = [(r.random(5) < 0.4).astype(np.float32) for _ in range(6)]
    b = jpk.pack_images(imgs, labs, patch=16, seq_len=32, grids=GRIDS)
    cfg = Config(model=model_cfg(tome_r=2, tome_schedule="decreasing"),
                 train=TrainConfig(learning_rate=2e-3))
    _, tp = params_pair(cfg.model, seed=7)
    state = tsteps.TrainState.create(tp, 0)
    step = tsteps.make_packed_train_step(cfg, 100, GRIDS)
    batch = {k: torch.from_numpy(getattr(b, k)) for k in KEYS}
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, golden, rtol=5e-4,
                               err_msg="packed tome trajectory drifted")
