"""The port's ViT against the JAX package's, through the parameter bridge.

Both run the same weights (drawn with ``jax.random`` by the JAX package's
``init_params`` and bridged) on the same numpy inputs, on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import vit as tvit

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def small_cfg(**kw):
    base = dict(img_size=32, patch_size=16, hidden_size=64, num_layers=3,
                num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                attention_impl="auto")
    base.update(kw)
    return ModelConfig(**base)


def _jax(cfg):
    """The JAX package's ModelConfig with the port's config's fields."""
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), _jax(cfg))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _images(cfg, n=4, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def test_bridge_round_trip_is_exact():
    cfg = small_cfg()
    jp, tp = _pair(cfg)
    back = bridge.params_to_numpy(tp)
    ref = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # and per-layer: the stacked [L, ...] leaf i is block i
    np.testing.assert_array_equal(tp.blocks[2].wo.kernel.detach().numpy(),
                                  ref["blocks"]["wo"]["kernel"][2])


def test_bridge_rejects_wrong_shapes():
    cfg = small_cfg()
    jp, _ = _pair(cfg)
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                               small_cfg(hidden_size=32))


def test_patchify_matches_jax():
    x = _images(small_cfg(), n=2)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(x), 16).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(x), 16)))


def test_logits_f32_match_jax():
    cfg = small_cfg()
    jp, tp = _pair(cfg)
    x = _images(cfg)
    ref = np.asarray(jvit.apply(jp, jnp.asarray(x), _jax(cfg)))
    with torch.inference_mode():
        got = tvit.apply(tp, torch.from_numpy(x), cfg).numpy()
        as_module = tp(torch.from_numpy(x)).numpy()
    # the bound of tests/test_vit_parity.py::test_parity_small_vit
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(as_module, got)


def test_logits_bf16_match_jax():
    cfg = small_cfg(dtype="bfloat16", hidden_size=128, num_heads=2)
    jp, tp = _pair(cfg)
    x = _images(cfg)
    ref = np.asarray(jvit.apply(jp, jnp.asarray(x), _jax(cfg)))
    with torch.inference_mode():
        got = tvit.apply(tp, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32
    # bf16 activations round at the same places on both sides, but the two
    # CPU backends accumulate matmuls in different orders, so bf16
    # roundings drift apart through the stack; logits here are O(0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)


def test_return_features_and_head_logits_match_jax():
    cfg = small_cfg()
    jp, tp = _pair(cfg, seed=1)
    x = _images(cfg, n=2)
    jl, jf = jvit.apply(jp, jnp.asarray(x), _jax(cfg), return_features=True)
    with torch.inference_mode():
        tl, tf = tvit.apply(tp, torch.from_numpy(x), cfg,
                            return_features=True)
        tokens = torch.randn(2, cfg.seq_len, cfg.hidden_size,
                             generator=torch.Generator().manual_seed(0))
        th = tvit.head_logits(tp, tokens, cfg).numpy()
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    jh = jvit.head_logits(jp, jnp.asarray(tokens.numpy()), _jax(cfg))
    np.testing.assert_allclose(th, np.asarray(jh), atol=2e-5)


def test_inference_params_cast_once_same_logits():
    cfg = small_cfg(dtype="bfloat16", hidden_size=128, num_heads=2)
    _, tp = _pair(cfg)
    fwd = tvit.inference_params(tp, torch.device("cpu"))
    assert fwd.blocks[0].wq.kernel.dtype == torch.bfloat16
    assert fwd.pos_embed.dtype == torch.bfloat16
    assert fwd.final_ln.scale.dtype == torch.float32
    assert fwd.head.kernel.dtype == torch.float32
    assert tp.blocks[0].wq.kernel.dtype == torch.float32   # not mutated
    x = torch.from_numpy(_images(cfg, n=2))
    with torch.inference_mode():
        torch.testing.assert_close(tvit.apply(fwd, x, cfg),
                                   tvit.apply(tp, x, cfg), atol=0, rtol=0)


def test_init_params_is_seeded_trunc_normal():
    cfg = small_cfg()
    a = tvit.init_params(torch.Generator().manual_seed(3), cfg)
    b = tvit.init_params(torch.Generator().manual_seed(3), cfg)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=na)
    w = a.blocks[0].mlp_in.kernel.detach()
    assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02
    assert (a.blocks[0].ln1.scale == 1).all() and (a.head.bias == 0).all()
    # and the tree has the JAX package's shapes
    ref = jax.tree.map(lambda t: t.shape,
                       jvit.init_params(jax.random.key(0), _jax(cfg)))
    got = jax.tree.map(lambda t: t.shape, bridge.params_to_numpy(a))
    assert got == ref


@pytest.mark.parametrize("kw,train", [
    ({"fused_qkv": True}, False),
    ({"remat": True, "remat_policy": "dots"}, True)])
def test_unported_paths_raise(kw, train):
    """These two paths raised until they were ported; each now runs and
    gives the reference's logits on the same weights (the policies and
    the fused projection in full: tests/test_torch_remat.py)."""
    cfg = small_cfg(**kw)
    jp, tp = _pair(small_cfg())
    x = _images(cfg, n=2)
    ref = jvit.apply(jp, jnp.asarray(x), _jax(dataclasses.replace(
        cfg, attention_impl="xla")), train=train)
    with torch.set_grad_enabled(train):
        got = tvit.apply(tp, torch.from_numpy(x), cfg, train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_tome_r_runs_the_merged_forward():
    """``tome_r`` is ported (tests/test_torch_tome_dense.py holds it to the
    reference): ``vit.apply`` runs the merging forward, which differs from
    the full-token one and equals ``apply_tome`` at eval."""
    from chestxray_vit_tpu_torch.models.tome_forward import apply_tome
    cfg = small_cfg(tome_r=2)
    _, tp = _pair(small_cfg())
    x = torch.from_numpy(_images(cfg, n=2))
    with torch.no_grad():
        merged = tvit.apply(tp, x, cfg)
        plain = tvit.apply(tp, x, small_cfg())
        torch.testing.assert_close(merged, apply_tome(tp, x, cfg, 2),
                                   atol=1e-6, rtol=0)
    assert merged.shape == plain.shape
    assert (merged - plain).abs().max() > 1e-5


def test_params_to_numpy_copies():
    """The tree does not share memory with the parameters: an in-place
    update of the weights (the optimizer's) leaves it as it was."""
    cfg = small_cfg()
    _, tp = _pair(cfg)
    tree = bridge.params_to_numpy(tp)
    before = tree["head"]["kernel"].copy()
    with torch.no_grad():
        tp.head.kernel.add_(1.0)
    np.testing.assert_array_equal(tree["head"]["kernel"], before)
