"""The port's optimizer, train and eval steps and metrics against the JAX
package's, on the CPU.

Both sides start from the same weights (drawn by the JAX package's
``init_params`` and bridged) and take the same numpy batches. The JAX
steps run jitted on one CPU device with ``attention_impl="pallas"``, so
its attention is the interpreted Pallas kernel pair; the port runs its
plain versions, which is what its wrappers do for CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.eval import metrics as jmetrics
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.train import optimizer as jopt
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.eval import metrics as tmetrics
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import quantized as tq
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.train import optimizer as topt
from chestxray_vit_tpu_torch.train import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False


def tiny_cfg(dtype="float32", accum=1, remat=False, **train):
    """img 32, patch 8, hidden 128, 2 heads of dim 64, MLP 256, 2 layers,
    15 classes: every kernel shape of ViT-B/16 but the widths."""
    return Config(
        model=ModelConfig(img_size=32, patch_size=8, hidden_size=128,
                          num_layers=2, num_heads=2, mlp_dim=256,
                          num_classes=15, dtype=dtype,
                          attention_impl="pallas", remat=remat),
        train=TrainConfig(gradient_accumulation_steps=accum,
                          warmup_steps=1, **train))


def _jax_cfg(cfg):
    """The JAX package's Config with the port's config's fields."""
    return jconfig.Config(**{
        f.name: getattr(jconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


def _params(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), _jax_cfg(cfg).model)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      cfg.model)


def _batches(n, b=4, seed=0, classes=15):
    rng = np.random.default_rng(seed)
    return [{"pixel_values": rng.standard_normal((b, 32, 32, 3))
             .astype(np.float32),
             "labels": (rng.random((b, classes)) < 0.2).astype(np.float32)}
            for _ in range(n)]


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_trees_close(got, ref, rtol, scale=None):
    """Leaf by leaf: |got − ref| ≤ rtol · scale, the scale by default the
    largest |ref| over the whole tree. The tree-wide scale keeps leaves
    whose true value is 0 fair (the key bias gets no gradient: softmax
    ignores a constant per query row, so its computed gradient is
    rounding noise on both sides)."""
    ref_leaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref)]
    got_leaves = jax.tree.leaves(got)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    if scale is None:
        scale = max(float(np.abs(a).max()) for a in ref_leaves)
    for path, g, r in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                          got_leaves, ref_leaves):
        err = float(np.abs(g - r).max())
        assert err <= rtol * scale, (jax.tree_util.keystr(path[0]), err)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear", "cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_jax(name, warmup):
    total = 20
    ref = jopt.SCHEDULES[name](1e-4, total, warmup)
    got = topt.SCHEDULES[name](1e-4, total, warmup)
    for step in (0, 1, 2, 3, total // 2, total - 1, total, total + 5):
        r = float(ref(jnp.asarray(step)))
        g = got(step)
        assert g.dtype == torch.float32 and g.dim() == 0
        # the same f32 arithmetic; cos may round one ulp apart
        np.testing.assert_allclose(float(g), r, rtol=1e-6, atol=0)


def test_decay_mask_by_name_matches_jax():
    cfg = tiny_cfg()
    jp, tp = _params(cfg)
    ref = jopt.default_decay_mask(jp)
    got = topt.default_decay_mask(tp)
    assert got["cls_token"] and got["pos_embed"] and got["head.kernel"]
    assert not got["final_ln.scale"] and not got["blocks.1.ln2.bias"]
    assert not got["blocks.0.wq.bias"] and got["blocks.0.mlp_in.kernel"]
    for name, decay in got.items():
        node = ref
        for part in name.split("."):
            if not part.isdigit():      # the JAX mask has one entry per
                node = node[part]       # stacked leaf, not per layer
        assert decay == node, name


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(rng, max_norm):
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    arrs = {k: rng.standard_normal(s).astype(np.float32) * 3
            for k, s in shapes.items()}
    ref, ref_norm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in arrs.items()}, max_norm)
    got, norm = topt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in arrs.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0)
    if max_norm == 100.0:           # no clipping: the gradients unchanged
        for k in shapes:
            np.testing.assert_array_equal(got[k].numpy(), arrs[k])


def test_adamw_three_steps_match_jax(rng):
    cfg = tiny_cfg()
    jp, tp = _params(cfg)
    adam = topt.AdamWConfig()
    jstate, tstate = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    mask_j, mask_t = jopt.default_decay_mask(jp), topt.default_decay_mask(tp)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2,
            jax.tree.map(np.asarray, jp))
        lr = 1e-3 * (step + 1)
        jp, jstate = jopt.adamw_update(
            jax.tree.map(jnp.asarray, grads), jstate, jp,
            jnp.asarray(step, jnp.int32), jnp.asarray(lr, jnp.float32),
            jopt.AdamWConfig(), mask_j)
        tgrads = {n: torch.from_numpy(bridge._leaf(grads, n).copy())
                  for n, _ in tp.named_parameters()}
        topt.adamw_update(tgrads, tstate, tp, step, torch.tensor(lr), adam,
                          mask_t)
    # the same f32 operations in the same order: the moments come out
    # bit-exact; the weights within 1e-7 (one or two ulps of O(0.04)
    # weights: the two backends round the final update differently)
    for g, r in zip(jax.tree.leaves(bridge.opt_state_to_numpy(tstate)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jstate))):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(jax.tree.leaves(bridge.params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(g, r, atol=1e-7, rtol=0)


def test_opt_state_bridge_round_trip():
    cfg = tiny_cfg()
    jp, tp = _params(cfg)
    state = jax.tree.map(np.asarray, jopt.init_opt_state(jp))
    state["mu"] = jax.tree.map(
        lambda a: np.arange(a.size, dtype=np.float32).reshape(a.shape),
        state["mu"])
    port = bridge.opt_state_from_jax(state, tp)
    assert port["mu"]["blocks.1.wo.kernel"].dtype == torch.float32
    back = bridge.opt_state_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _jax_grads(jp, cfg, batch):
    def loss(p):
        logits = jvit.apply(p, batch["pixel_values"], _jax_cfg(cfg).model,
                            train=True)
        return jsteps.bce_with_logits(logits, batch["labels"])
    return jax.jit(jax.value_and_grad(loss))(jp)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_f32_matches_jax(accum):
    """Loss, grad_norm and lr per step, every gradient leaf of the first
    step, and the parameters and AdamW moments after three steps."""
    cfg = tiny_cfg(accum=accum)
    jp, tp = _params(cfg)
    batches = _batches(3)
    jstep = jax.jit(jsteps.make_train_step(_jax_cfg(cfg), total_steps=10))
    tstep = tsteps.make_train_step(cfg, total_steps=10)
    jstate = jsteps.TrainState.create(jp, seed=0)
    tstate = tsteps.TrainState.create(tp, seed=0)
    _, grads0 = _jax_grads(jp, cfg, _jax(batches[0]))
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        if i == 0:
            # the whole batch's gradient; with accumulation the port's is
            # the mean of the two strided micro-batches' gradients
            _assert_trees_close(bridge.grads_to_numpy(tstate.params),
                                grads0, rtol=1e-4)
        assert tstate.step == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["lr"]) == float(jm["lr"])
    # AdamW's first steps move each weight by about lr = 1e-4; 1e-6
    # (absolute) is 1 % of that
    _assert_trees_close(bridge.params_to_numpy(tstate.params),
                        jstate.params, rtol=1e-6, scale=1.0)
    got_moments = bridge.opt_state_to_numpy(tstate.opt_state)
    for key in ("mu", "nu"):
        _assert_trees_close(got_moments[key], jstate.opt_state[key],
                            rtol=1e-4)


def test_gradient_accumulation_splits_strided():
    """k = 2 over a batch equals the mean of one step on rows 0, 2, … and
    one on rows 1, 3, …"""
    cfg, cfg1 = tiny_cfg(accum=2), tiny_cfg()
    batch = _batches(1)[0]
    _, tp = _params(cfg)
    tsteps.make_train_step(cfg, 10)(tsteps.TrainState.create(tp, 0),
                                    _torch(batch))
    grads = []
    for rows in (slice(0, None, 2), slice(1, None, 2)):
        _, p1 = _params(cfg1)
        tsteps.make_train_step(cfg1, 10)(
            tsteps.TrainState.create(p1, 0),
            _torch({k: v[rows] for k, v in batch.items()}))
        grads.append(dict((n, p.grad) for n, p in p1.named_parameters()))
    for n, p in tp.named_parameters():
        torch.testing.assert_close(p.grad, (grads[0][n] + grads[1][n]) / 2,
                                   atol=1e-7, rtol=1e-5, msg=n)


def test_remat_matches_no_remat_exactly():
    batch = _torch(_batches(1)[0])
    out = []
    for remat in (False, True):
        cfg = tiny_cfg(remat=remat)
        _, tp = _params(cfg)
        state, m = tsteps.make_train_step(cfg, 10)(
            tsteps.TrainState.create(tp, 0), batch)
        out.append((m, bridge.grads_to_numpy(state.params),
                    bridge.params_to_numpy(state.params)))
    (m0, g0, p0), (m1, g1, p1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    # full remat recomputes the same operations on the same inputs
    for a, b in zip(jax.tree.leaves((g0, p0)), jax.tree.leaves((g1, p1))):
        np.testing.assert_array_equal(a, b)


def test_remat_recomputes_each_block(monkeypatch):
    """Under full remat the backward re-runs every block's forward: the
    LayerNorm forward runs 2L + 1 times in the forward and 2L more in the
    backward, as the card's launch counts show."""
    calls = []
    orig = tvit.layer_norm

    def counting(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(tvit, "layer_norm", counting)
    for remat, expected in ((False, 5), (True, 9)):
        cfg = tiny_cfg(remat=remat)
        _, tp = _params(cfg)
        calls.clear()
        tsteps.make_train_step(cfg, 10)(tsteps.TrainState.create(tp, 0),
                                        _torch(_batches(1)[0]))
        assert len(calls) == expected


def test_train_step_bf16_close_to_jax():
    cfg = tiny_cfg(dtype="bfloat16")
    jp, tp = _params(cfg)
    batch = _batches(1)[0]
    jstate, jm = jax.jit(jsteps.make_train_step(_jax_cfg(cfg), 10))(
        jsteps.TrainState.create(jp, 0), _jax(batch))
    tstate, tm = tsteps.make_train_step(cfg, 10)(
        tsteps.TrainState.create(tp, 0), _torch(batch))
    # bf16 activations round at the same places on both sides but the two
    # CPU backends accumulate in different orders (and the interpreted TPU
    # kernel rounds P before the exp2); losses are O(0.7)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=5e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-2)
    _, grads0 = _jax_grads(jp, cfg, _jax(batch))
    _assert_trees_close(bridge.grads_to_numpy(tstate.params), grads0,
                        rtol=5e-2)


@pytest.mark.parametrize("field,value", [
    ("remat_policy", "mlp"), ("remat_policy", "dots"),
    ("fused_qkv", True)])
def test_unported_training_options_raise(field, value):
    """These options raised until they were ported (as dropout and token
    merging did: tests/test_torch_dropout.py,
    tests/test_torch_tome_dense.py); each now trains a step that equals
    the reference's (the JAX side on its "xla" attention, nothing
    interpreted), with the step's tolerances of
    test_train_steps_match_jax_over_three_steps."""
    cfg = tiny_cfg(remat=True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **{field: value}))
    jcfg = _jax_cfg(cfg)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, attention_impl="xla"))
    jp, tp = _params(tiny_cfg())
    batch = _batches(1)[0]
    jstate, jm = jax.jit(jsteps.make_train_step(jcfg, 10))(
        jsteps.TrainState.create(jp, 0), _jax(batch))
    tstate, tm = tsteps.make_train_step(cfg, 10)(
        tsteps.TrainState.create(tp, 0), _torch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_trees_close(bridge.params_to_numpy(tstate.params),
                        jstate.params, rtol=1e-6, scale=1.0)


def test_mixup_int8_and_packed_raise():
    """Mixup builds a step now (tests/test_torch_dropout.py holds it to
    the reference), and so does the quantized eval step
    (tests/test_torch_quant.py), and the packed step
    (tests/test_torch_packed.py), with token merging too
    (tests/test_torch_tome.py), and token merging on the dense train and
    eval steps (tests/test_torch_tome_dense.py), and the int8
    straight-through train step, which builds and takes a step here
    (tests/test_torch_int8_train.py holds it to the reference)."""
    cfg = tiny_cfg()
    tsteps.make_train_step(dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, mixup_alpha=0.2)), 10)
    _, tp = _params(cfg)
    batch = _torch(_batches(1)[0])
    scales = tq.calibrate_vit_scales(tp, batch["pixel_values"], cfg.model)
    state, m = tsteps.make_train_step(cfg, 10, int8_scales=scales)(
        tsteps.TrainState.create(tp, 0), batch)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    tome = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, tome_r=2))
    assert callable(tsteps.make_packed_train_step(cfg, 10))
    assert callable(tsteps.make_packed_train_step(tome, 10))
    assert callable(tsteps.make_train_step(tome, 10))
    assert callable(tsteps.make_inference_eval_step(cfg, quantized=True,
                                                    tome_r=2))


def test_tome_train_and_eval_steps_run_merged():
    """With ``model.tome_r`` the train step trains the merged model and the
    eval step evaluates it: its logits equal ``vit.apply``'s merged
    forward and differ from the full-token model's (the merged forward
    against the reference: tests/test_torch_tome_dense.py)."""
    cfg = tiny_cfg()
    tome = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, tome_r=2))
    _, tp = _params(cfg)
    batch = _torch(_batches(1)[0])
    logits, rows = tsteps.make_eval_step(tome)(tp, batch)
    plain, _ = tsteps.make_eval_step(cfg)(tp, batch)
    assert logits.shape == (4, 15) and rows.shape == (4,)
    assert (logits - plain).abs().max() > 1e-5
    state, m = tsteps.make_train_step(tome, 10)(
        tsteps.TrainState.create(tp, 0), batch)
    assert state.step == 1 and torch.isfinite(m["loss"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tp.parameters())


# ---------------------------------------------------------------------------
# Eval step and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["make_eval_step",
                                  "make_inference_eval_step"])
def test_eval_step_matches_jax(make):
    cfg = tiny_cfg()
    jp, tp = _params(cfg, seed=1)
    batch = _batches(1, b=5, seed=3)[0]
    jl, jr = jax.jit(getattr(jsteps, make)(_jax_cfg(cfg)))(jp, _jax(batch))
    tl, tr = getattr(tsteps, make)(cfg)(tp, _torch(batch))
    assert tl.dtype == torch.float32 and tl.shape == (5, 15)
    assert tr.shape == (5,) and not tl.requires_grad
    # the bound of tests/test_vit_parity.py::test_parity_small_vit
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)


def test_bce_matches_jax(rng):
    logits = (rng.standard_normal((6, 15)) * 8).astype(np.float32)
    labels = (rng.random((6, 15)) < 0.3).astype(np.float32)
    ref = np.asarray(jsteps.bce_elements(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    got = tsteps.bce_elements(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tsteps.bce_with_logits(torch.from_numpy(logits),
                                     torch.from_numpy(labels))),
        float(jsteps.bce_with_logits(jnp.asarray(logits),
                                     jnp.asarray(labels))), rtol=1e-6)


def _metric_inputs(rng):
    """Heavy ties (scores on a coarse grid), a degenerate all-negative and
    an all-positive column."""
    n, c = 64, 6
    scores = (rng.integers(-4, 5, (n, c)) * 0.5).astype(np.float32)
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    labels[:, 2] = 0.0
    labels[:, 4] = 1.0
    return scores, labels


def test_auroc_and_f1_match_jax(rng):
    scores, labels = _metric_inputs(rng)
    js, jl = jnp.asarray(scores), jnp.asarray(labels)
    ts, tl = torch.from_numpy(scores), torch.from_numpy(labels)
    ref = np.asarray(jmetrics.auroc_per_class(js, jl))
    got = tmetrics.auroc_per_class(ts, tl).numpy()
    assert np.isnan(got[2]) and np.isnan(got[4])
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(float(tmetrics.avg_auroc(ts, tl)),
                               float(jmetrics.avg_auroc(js, jl)), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics.f1_micro(ts, tl)),
                               float(jmetrics.f1_micro(js, jl)), rtol=1e-6)
    for g, r in zip(tmetrics.precision_recall_f1_per_class(ts, tl, 0.4),
                    jmetrics.precision_recall_f1_per_class(js, jl, 0.4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_metrics_degenerate_and_empty_cases():
    labels = torch.zeros(8, 3)
    scores = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
    assert float(tmetrics.avg_auroc(scores, labels)) == 0.0
    assert float(tmetrics.f1_micro(torch.full((8, 3), -9.0), labels)) == 0.0
    assert float(jmetrics.avg_auroc(jnp.asarray(scores.numpy()),
                                    jnp.asarray(labels.numpy()))) == 0.0


def test_compute_metrics_matches_jax(rng):
    scores, labels = _metric_inputs(rng)
    names = [f"c{i}" for i in range(scores.shape[1])]
    ref = jmetrics.compute_metrics(scores, labels, names)
    got = tmetrics.compute_metrics(torch.from_numpy(scores),
                                   torch.from_numpy(labels), names)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6,
                                   equal_nan=True)
