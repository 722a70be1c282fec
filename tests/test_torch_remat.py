"""The port's remat policies, fused Q/K/V projection and unrolled forward
(``models/remat.py``, ``models/vit.py``) against the JAX package's, on the
CPU.

Both sides take the same numpy-seeded images and the same weights (drawn
by the JAX package's ``init_params`` and bridged). The JAX side runs its
``"xla"`` attention (nothing interpreted); the port runs its ``"auto"``
dispatch, whose training attention on CPU tensors is the autograd
function over the kernels' plain twins, so it keeps what the card keeps.

Tolerances: f32 logits 1e-5; gradients 1e-4 of the largest, as
tests/test_torch_packed.py holds them (the two CPU backends sum in other
orders; the port's attention backward recomputes P from lse, the JAX
``"xla"`` one differentiates the softmax); the fused projection with
tests/test_attention_variants.py's tolerances. Against the port's own
step without remat every policy is held bit for bit: it recomputes the
same operations on the same inputs.

What a policy keeps is read from memory, not from the code that keeps it:
after the forward, the memory of each GELU output, each q (the first of
q, k, v) and each attention forward's o and lse is alive only if the
autograd graph or the policy holds it.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from chestxray_vit_tpu.models import packed as jpm
from chestxray_vit_tpu.models import tome_forward as jtf
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import packed as tpm
from chestxray_vit_tpu_torch.models import remat
from chestxray_vit_tpu_torch.models import tome_forward as ttf
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.ops import flash_attention as tfa

from test_torch_packed import (GRIDS, assert_trees_close, fwd_args,
                               jax_cfg, jx, model_cfg, packed_batch, tt)

torch.backends.cuda.matmul.allow_tf32 = False

GRAD_RTOL = 1e-4
POLICIES = ["full", "mlp", "attn", "attn_mlp", "flash_out", "dots"]
LAYERS = 2
# per policy: (GELU output, q, o and lse) alive after the forward, and the
# attention forwards one step runs per layer
KEEPS = {None: ((True, True, True), 1), "full": ((False, False, False), 2),
         "mlp": ((False, True, True), 1), "attn": ((True, False, True), 1),
         "attn_mlp": ((False, False, True), 1),
         "flash_out": ((False, False, True), 1),
         "dots": ((False, False, False), 2)}


def small_cfg(**kw):
    """img 32, patch 8 (17 tokens), width 64, 4 heads, MLP 128, 2 layers,
    5 classes, f32."""
    base = dict(img_size=32, patch_size=8, hidden_size=64,
                num_layers=LAYERS, num_heads=4, mlp_dim=128, num_classes=5,
                dtype="float32", attention_impl="auto")
    return ModelConfig(**{**base, **kw})


def policy_cfg(policy, **kw):
    if policy is None:
        return small_cfg(**kw)
    return small_cfg(remat=True, remat_policy=policy, **kw)


def params_pair(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), jax_cfg(cfg))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def xla(cfg):
    return jax_cfg(dataclasses.replace(cfg, attention_impl="xla"))


def port_grads(tp, cfg, x, **kw):
    """Gradients of Σ logits² of the training forward, as the JAX tree."""
    for p in tp.parameters():
        p.grad = None
    tvit.apply(tp, torch.from_numpy(x), cfg, train=True,
               **kw).square().sum().backward()
    return bridge.grads_to_numpy(tp)


def jax_grads(jp, cfg, x):
    def loss(p):
        return jnp.sum(jvit.apply(p, jnp.asarray(x), xla(cfg),
                                  train=True) ** 2)
    return jax.jit(jax.grad(loss))(jp)


def assert_trees_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# The policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_match_jax(policy):
    cfg = policy_cfg(policy)
    jp, tp = params_pair(cfg)
    x = images()
    assert_trees_close(port_grads(tp, cfg, x), jax_grads(jp, cfg, x),
                       GRAD_RTOL)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused_qkv"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_equal_no_remat_bit_for_bit(policy, fused):
    cfg = policy_cfg(policy, fused_qkv=fused)
    _, tp = params_pair(cfg)
    x = images()
    assert_trees_equal(port_grads(tp, cfg, x),
                       port_grads(tp, small_cfg(fused_qkv=fused), x))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_with_both_dropouts_equals_no_remat(policy):
    """The dropout attention function's saves under every policy: the
    same seeds give the no-remat gradients bit for bit, so every recompute
    redraws the same masks."""
    drop = {"attention_dropout": 0.1, "hidden_dropout": 0.1}
    cfg = policy_cfg(policy, **drop)
    _, tp = params_pair(cfg)
    x = images()
    seeds = [(11 + i, 22 + i, -33 - i) for i in range(LAYERS)]
    got = port_grads(tp, cfg, x, dropout_seeds=seeds)
    ref = port_grads(tp, small_cfg(**drop), x, dropout_seeds=seeds)
    plain = port_grads(tp, small_cfg(), x)
    assert_trees_equal(got, ref)
    assert any(not np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(ref), jax.tree.leaves(plain)))


def _storage(t):
    return StorageWeakRef(t.untyped_storage())


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_policy_keeps_what_the_reference_keeps(monkeypatch, policy):
    """After the forward, the GELU outputs (``mlp_hidden``), q
    (``attn_heads``, the kernel's ``flash_residual``) and the attention
    forward's o and lse (``flash_out``) are alive exactly where the
    policy keeps them; the attention forward runs again in the backward
    only where o and lse are not kept."""
    seen = {"mlp_hidden": [], "attn_heads": [], "flash_out": []}
    name, fwd = tvit.checkpoint_name, tfa.attention_fwd_reference

    def naming(n, fn, *args):
        out = name(n, fn, *args)
        seen[n].append(_storage(out[0] if isinstance(out, tuple) else out))
        return out

    def forward(*args):
        o, lse = fwd(*args)
        seen["flash_out"] += [_storage(o), _storage(lse)]
        return o, lse

    monkeypatch.setattr(tvit, "checkpoint_name", naming)
    monkeypatch.setattr(tfa, "attention_fwd_reference", forward)
    cfg = policy_cfg(policy)
    _, tp = params_pair(cfg)
    loss = tvit.apply(tp, torch.from_numpy(images()), cfg,
                      train=True).square().sum()
    gc.collect()
    alive = tuple({not w.expired() for w in seen[n]}
                  for n in ("mlp_hidden", "attn_heads", "flash_out"))
    assert [len(v) for v in seen.values()] == [LAYERS, LAYERS, 2 * LAYERS]
    kept, runs = KEEPS[policy]
    assert alive == tuple({k} for k in kept)
    loss.backward()
    assert len(seen["flash_out"]) == 2 * runs * LAYERS


class _Outputs(TorchDispatchMode):
    """Weak references to the storage of every op's outputs, in order
    (but autograd's own ``detach`` of an output it saves, which saved
    tensor hooks replace)."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops.aten.detach.default:
            self.refs += [_storage(t) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("policy", ["mlp", "attn", "attn_mlp"])
def test_save_anything_except_frees_only_the_named_values(monkeypatch,
                                                          policy):
    """Of every tensor the forward makes, a "save anything except" policy
    keeps alive what the step without remat keeps, less what lies in the
    named values' memory: nothing more (a rebuild holds only what the
    backward keeps anyway) and nothing else less."""
    named = []
    name = tvit.checkpoint_name

    def naming(n, fn, *args):
        out = name(n, fn, *args)
        if n in remat._EXCEPT[policy]:
            named.extend(_storage(t).cdata for t in tree_leaves(out))
        return out

    def alive(cfg):
        _, tp = params_pair(cfg)
        with _Outputs() as mode:
            loss = tvit.apply(tp, torch.from_numpy(images()), cfg,
                              train=True).square().sum()
        gc.collect()
        return [not r.expired() for r in mode.refs], mode.refs, loss

    base, _, _ = alive(small_cfg())
    monkeypatch.setattr(tvit, "checkpoint_name", naming)
    got, refs, _ = alive(policy_cfg(policy))
    dropped = {i for i, r in enumerate(refs) if r.cdata in set(named)}
    assert len(got) == len(base) and dropped
    assert all(base[i] and not got[i] for i in dropped)
    assert [a for i, a in enumerate(got) if i not in dropped] == \
        [a for i, a in enumerate(base) if i not in dropped]


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_matrix_products():
    """``dots`` runs no projection product again in the backward, though
    the attention reruns. Full remat runs five of the block's six again:
    its recompute stops once the last saved tensor is rebuilt, the inputs
    of the MLP's second product, before that product runs."""
    counts = {}
    for policy in (None, "full", "dots"):
        cfg = policy_cfg(policy)
        _, tp = params_pair(cfg)
        with _CountProducts() as mode:
            tvit.apply(tp, torch.from_numpy(images()), cfg,
                       train=True).square().sum().backward()
        counts[policy] = mode.mm
    assert counts["dots"] == counts[None]
    assert counts["full"] == counts[None] + 5 * LAYERS


def test_remat_policy_names_and_refuses_unknown():
    assert [tvit.remat_policy(small_cfg(remat_policy=p)).name
            for p in POLICIES] == POLICIES
    with pytest.raises(ValueError, match="remat_policy 'mlp_hidden'"):
        tvit.remat_policy(small_cfg(remat_policy="mlp_hidden"))
    # a name is only rebuilt under a policy that drops it
    assert remat.checkpoint_name("mlp_hidden", torch.ones, 2).tolist() == \
        [1.0, 1.0]


# ---------------------------------------------------------------------------
# The merged and packed forwards
# ---------------------------------------------------------------------------

def _attention_runs(monkeypatch, module, name):
    calls = []
    fwd = getattr(module, name)

    def counting(*args, **kw):
        calls.append(1)
        return fwd(*args, **kw)

    monkeypatch.setattr(module, name, counting)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_tome_train_honours_the_policy(monkeypatch, policy):
    """The merged forward runs every block under the policy (the JAX
    package's ``tome_forward.py:149-151``): no-remat gradients bit for
    bit, and the attention forward again only where o and lse are not
    kept."""
    calls = _attention_runs(monkeypatch, tfa, "attention_fwd_reference")
    cfg = policy_cfg(policy, tome_r=3)
    _, tp = params_pair(cfg)
    x = images()
    got = port_grads(tp, cfg, x)
    assert len(calls) == KEEPS[policy][1] * LAYERS
    assert_trees_equal(got, port_grads(tp, small_cfg(tome_r=3), x))


@pytest.mark.parametrize("policy", ["attn_mlp", "flash_out"])
def test_tome_train_policy_matches_jax(policy):
    cfg = policy_cfg(policy, tome_r=3)
    jp, tp = params_pair(cfg)
    x = images()

    def loss(p):
        return jnp.sum(jtf.apply_tome_train(p, jnp.asarray(x), xla(cfg), 3,
                                            train=True) ** 2)
    assert_trees_close(port_grads(tp, cfg, x), jax.jit(jax.grad(loss))(jp),
                       GRAD_RTOL)


def _packed_grads(tp, fn, cfg, batch):
    for p in tp.parameters():
        p.grad = None
    mask = torch.from_numpy(batch["image_mask"])[..., None]
    (fn(tp, *fwd_args(tt(batch)), cfg, GRIDS, train=True).square()
     * mask).sum().backward()
    tp.cls_token.grad = torch.zeros_like(tp.cls_token)   # pooled, not used
    return bridge.grads_to_numpy(tp)


@pytest.mark.parametrize("policy", ["mlp", "flash_out", "dots"])
def test_packed_forwards_follow_the_reference(monkeypatch, policy):
    """``apply_packed`` stays full remat whatever the policy and ignores
    ``fused_qkv`` (the reference's ``packed.py:135`` checkpoints without a
    policy, its ``_packed_mha`` has no fused projection);
    ``apply_packed_tome`` honours the policy, whose only named value there
    is the GELU output, so ``flash_out`` is full remat too."""
    calls = _attention_runs(monkeypatch, tfa, "_packed_fwd_plain")
    batch = packed_batch(0, [64, 48, 32, 32, 48])
    base = model_cfg(remat=True, remat_policy=policy)
    _, tp = params_pair(base)
    plain = _packed_grads(tp, tpm.apply_packed, model_cfg(), batch)
    calls.clear()
    got = _packed_grads(tp, tpm.apply_packed,
                        dataclasses.replace(base, fused_qkv=True), batch)
    assert len(calls) == 2 * base.num_layers
    assert_trees_equal(got, plain)

    tome = dataclasses.replace(base, tome_r=4, tome_schedule="constant")
    plain = _packed_grads(tp, tpm.apply_packed_tome,
                          dataclasses.replace(tome, remat=False), batch)
    calls.clear()
    got = _packed_grads(tp, tpm.apply_packed_tome, tome, batch)
    assert len(calls) == (1 if policy == "mlp" else 2) * base.num_layers
    assert_trees_equal(got, plain)


def test_packed_tome_policy_matches_jax():
    cfg = model_cfg(remat=True, remat_policy="mlp", tome_r=4,
                    tome_schedule="constant")
    jp, tp = params_pair(cfg)
    batch = packed_batch(0, [64, 48, 32, 32, 48])
    mask = jnp.asarray(batch["image_mask"])[..., None]

    def loss(p):
        return jnp.sum(jpm.apply_packed_tome(
            p, *fwd_args(jx(batch)), jax_cfg(cfg), GRIDS,
            train=True) ** 2 * mask)
    assert_trees_close(_packed_grads(tp, tpm.apply_packed_tome, cfg, batch),
                       jax.jit(jax.grad(loss))(jp), GRAD_RTOL)


# ---------------------------------------------------------------------------
# The fused Q/K/V projection
# ---------------------------------------------------------------------------

def test_fused_qkv_matches_jax():
    cfg = small_cfg(fused_qkv=True)
    jp, tp = params_pair(cfg)
    x = images()
    with torch.no_grad():
        got = tvit.apply(tp, torch.from_numpy(x), cfg)
        split = tvit.apply(tp, torch.from_numpy(x), small_cfg())
    ref = jvit.apply(jp, jnp.asarray(x), xla(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), split.numpy(), atol=1e-5,
                               rtol=1e-5)
    ref_g, got_g = jax_grads(jp, cfg, x), port_grads(tp, cfg, x)
    for a, b in zip(jax.tree.leaves(got_g), jax.tree.leaves(ref_g)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)


def test_fused_qkv_hands_the_kernels_strided_views(monkeypatch):
    """q, k, v are [B, H, S, hd] views of the one [B, S, 3, H, hd]
    product: row stride 3D, k and v D and 2D elements after q, which the
    kernels' stride check takes as they are."""
    seen = []
    fwd = tfa.flash_attention_fwd

    def spy(q, k, v, sm_scale=None):
        seen.append((q, k, v))
        return fwd(q, k, v, sm_scale)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    cfg = small_cfg(fused_qkv=True)
    _, tp = params_pair(cfg)
    tvit.apply(tp, torch.from_numpy(images()), cfg, train=True)
    d, s = cfg.hidden_size, cfg.seq_len
    for q, k, v in seen:
        assert q.stride() == (s * 3 * d, cfg.head_dim, 3 * d, 1)
        assert k.stride() == v.stride() == q.stride()
        assert k.data_ptr() - q.data_ptr() == d * q.element_size()
        assert v.data_ptr() - q.data_ptr() == 2 * d * q.element_size()
        assert all(tfa._fits(t) for t in (q, k, v))
    assert len(seen) == LAYERS


def test_merged_forwards_refuse_fused_qkv():
    cfg = small_cfg(fused_qkv=True, tome_r=2)
    _, tp = params_pair(cfg)
    with pytest.raises(ValueError, match="fused_qkv"):
        ttf.apply_tome_train(tp, torch.from_numpy(images(1)), cfg, 2)
    pcfg = model_cfg(fused_qkv=True, tome_r=2)
    batch = packed_batch(0, [64, 32])
    with pytest.raises(ValueError, match="fused_qkv"):
        tpm.apply_packed_tome(tp, *fwd_args(tt(batch)), pcfg, GRIDS)


# ---------------------------------------------------------------------------
# The unrolled form
# ---------------------------------------------------------------------------

def test_unstack_blocks_matches_jax():
    cfg = small_cfg(dtype="bfloat16")
    jp, tp = params_pair(cfg)
    got = tvit.unstack_blocks(tp, cfg)
    ref = jvit.unstack_blocks(jp, jax_cfg(cfg))
    assert len(got) == len(ref) == LAYERS
    for g, r in zip(got, ref):
        for path, leaf in jax.tree_util.tree_flatten_with_path(r)[0]:
            site, name = (k.key for k in path)
            t = getattr(getattr(g, site), name)
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.detach().float().numpy(),
                np.asarray(leaf.astype(jnp.float32)))


def test_apply_with_attention_matches_jax():
    cfg = small_cfg()
    jp, tp = params_pair(cfg)
    x = images()
    ref_logits, ref_probs = jvit.apply_with_attention(jp, jnp.asarray(x),
                                                      jax_cfg(cfg))
    with torch.no_grad():
        logits, probs = tvit.apply_with_attention(tp, torch.from_numpy(x),
                                                  cfg)
        plain = tvit.apply(tp, torch.from_numpy(x), cfg)
    assert probs.shape == (LAYERS, 3, 4, 17, 17)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), atol=1e-5)
