"""Token-merging ViT forwards, ported from
``chestxray_vit_tpu/models/tome_forward.py``.

After every attention block the r most similar token pairs merge
(``ops/tome.py``: bipartite soft matching on the keys' mean over heads,
size-weighted means; Bolya et al., arXiv:2210.09461), so layer l runs at
its own length. Token counts shrink per layer, so both forwards are an
unrolled loop over the layers; every count is a Python int from the
shapes, so the loop never waits on the device. Each layer's count is
clamped to ceil(S_l/2) − 1, and ``schedule`` spreads the r·L budget over
the layers (``ops/tome.r_schedule``).

- :func:`apply_tome_train`: the differentiable forward that
  ``vit.apply`` dispatches to when ``cfg.tome_r`` is set, for training and
  eval. Gradients flow through the size-weighted means (the one-hot
  routing product); the matching is piecewise constant, as in the paper's
  training. With ``cfg.remat`` each block runs under
  ``cfg.remat_policy`` (``vit.remat_policy``), the merge included; where
  the policy recomputes it, the backward recomputes the matching, which
  equals the forward's because every kernel before it is deterministic.
  With ``int8_scales`` its projections run on the int8 straight-through
  product (``models/int8_train.py``), as the train step's int8 forward
  does when ``model.tome_r`` is set.
- :func:`apply_tome`: the serving forward on the dense tree or on a
  ``QuantizedViT``, with the attention always the forward-only kernel.

Merging is lossy by design: it trades throughput, about linear in the
tokens merged away, for fidelity, which a user has to validate on their
own data.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import int8_train
from chestxray_vit_tpu_torch.models import quantized as quantized_mod
from chestxray_vit_tpu_torch.models import vit
from chestxray_vit_tpu_torch.ops.layer_norm import layer_norm
from chestxray_vit_tpu_torch.ops.tome import r_schedule, tome_merge_clamped
from chestxray_vit_tpu_torch.parallel import fsdp


def _tome_block(x: torch.Tensor, sizes: torch.Tensor, bp: vit.Block,
                cfg: ModelConfig, dt: torch.dtype, train: bool,
                seeds: Optional[vit.LayerSeeds], r_i: int, row_base: int,
                layout=None):
    """One pre-LN block with the merge between the attention residual and
    LN2 (the paper's placement); the metric is this layer's keys' mean
    over heads, aligned with x before the merge. The dropout counters run
    over each site's own token count. A sharded tree's block is gathered
    here; on a tensor axis the metric is the mean over every head's keys,
    gathered (``parallel/tensor.py``), so each rank merges as one process
    does."""
    tp = vit._tensor_axis(layout)
    if layout is not None:
        bp = fsdp.gather_block(layout, bp, dt)
    attn_seed, seed_attn_out, seed_mlp_out = seeds or (None, None, None)
    hidden = cfg.hidden_dropout if train else 0.0
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt),
                      cfg.layernorm_eps)
    attn_out, kmean = vit._mha(a_in, bp, cfg, cfg.attention_impl, dt, train,
                               attn_seed, return_key_mean=True,
                               row_base=row_base, tp=tp)
    x = x + vit._dropout(attn_out, hidden, seed_attn_out, row_base)
    x, sizes = tome_merge_clamped(x, kmean, sizes, r_i)
    return (vit._mlp(x, bp, cfg, dt, hidden, seed_mlp_out, row_base, tp),
            sizes)


def _tome_int8_block(x: torch.Tensor, sizes: torch.Tensor, bp: vit.Block,
                     cfg: ModelConfig, dt: torch.dtype, train: bool,
                     seeds: Optional[vit.LayerSeeds], r_i: int,
                     row_base: int, act: dict, layout=None):
    """:func:`_tome_block` with every projection on the int8
    straight-through product (``models/int8_train.py``) at this layer's
    activation scales ``act``; the metric is the mean of its keys (on a
    tensor axis, of every head's, gathered)."""
    tp = vit._tensor_axis(layout)
    if layout is not None:
        bp = fsdp.gather_block(layout, bp, dt)
    x, kmean = int8_train.attention_residual(x, bp, cfg, dt, train, seeds,
                                             act, return_key_mean=True,
                                             row_base=row_base, tp=tp)
    x, sizes = tome_merge_clamped(x, kmean, sizes, r_i)
    return int8_train.mlp_residual(x, bp, cfg, dt, train, seeds, act,
                                   row_base, tp), sizes


def apply_tome_train(params: vit.ViT, images: torch.Tensor, cfg: ModelConfig,
                     r: int, *, train: bool = True,
                     dropout_seeds: Optional[Sequence[vit.LayerSeeds]] = None,
                     schedule: str = "constant",
                     int8_scales=None, row_base: int = 0) -> torch.Tensor:
    """Differentiable token-merging forward: NHWC images → f32 logits.

    The counterpart of :func:`vit.apply` (the same weights, casts, kernels
    and dropout): one ``(attention, hidden after attention, hidden after
    MLP)`` seed triple per layer in ``dropout_seeds`` takes the place of
    the reference's per-layer key split. ``int8_scales`` (a
    ``calibrate_vit_scales`` tree) runs every projection, the patch
    embedding included, on the int8 straight-through product of
    ``models/int8_train.py`` inside the merged forward, at the layer's
    calibrated scales. ``row_base`` as in :func:`vit.apply`."""
    if r <= 0:
        raise ValueError(f"tome r={r} must be positive")
    if cfg.fused_qkv:
        raise ValueError("model.fused_qkv does not compose with tome_r")
    vit._check_supported(cfg, dropout_seeds)
    dt = vit.torch_dtype(cfg.dtype)
    layout = params.layout
    if int8_scales is None:
        x = vit.embed(params, images, cfg, dt)
    else:
        int8_scales = int8_train.place_scales(int8_scales, images.device)
        x = int8_train.embed(params, images, cfg, dt, int8_scales["patch"])
    sizes = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    policy = (vit.remat_policy(cfg)
              if train and cfg.remat and torch.is_grad_enabled() else None)
    for i, (bp, r_i) in enumerate(zip(params.blocks,
                                      r_schedule(r, cfg.num_layers,
                                                 schedule))):
        args = (x, sizes, bp, cfg, dt, train,
                tuple(dropout_seeds[i]) if dropout_seeds is not None
                else None, r_i, row_base)
        block = _tome_block
        if int8_scales is not None:
            block = _tome_int8_block
            args += (int8_train.layer_scales(int8_scales, i),)
        args += (layout,)
        x, sizes = policy(block, *args) if policy else block(*args)
    return vit.head_logits(params, x, cfg)


def apply_tome(params, images: torch.Tensor, cfg: ModelConfig, r: int,
               quantized: bool = False, schedule: str = "constant",
               backend: str = "xla") -> torch.Tensor:
    """Serving forward, merging up to ``r`` token pairs per layer: NHWC
    images → f32 logits.

    ``params`` is a dense ``ViT`` (its weights cast to the compute dtype
    at each product, the LayerNorm parameters read as they are stored, as
    in the reference) or, with ``quantized``, a ``QuantizedViT``. A
    quantized tree runs on ``backend`` as ``apply_quantized`` does:
    ``"xla"`` the plain route (the reference's), ``"pallas"`` (static trees
    only) the fused int8 kernel, with the merge between the ``wo``
    residual product and LN2. Run under ``torch.no_grad()`` or
    ``torch.inference_mode()``."""
    if r <= 0:
        raise ValueError(f"tome r={r} must be positive (use the plain "
                         f"forward for r=0)")
    merges = r_schedule(r, cfg.num_layers, schedule)
    if quantized:
        return quantized_mod.apply_quantized(params, images, cfg, backend,
                                             merges=merges)
    if backend != "xla":
        raise ValueError(f"backend={backend!r}: a dense tree has the one "
                         f"route 'xla'; 'pallas' runs static int8 trees")
    x = quantized_mod.embed_tokens(params, images, cfg, quantized=False)
    x, _ = quantized_mod._encoder_scan(x, params.blocks, cfg,
                                       quantized_mod.dense_proj(cfg),
                                       merges=merges)
    return vit.head_logits(params, x, cfg)
