"""Packed variable-resolution ViT forward, ported from
``chestxray_vit_tpu/models/packed.py``.

Runs the ViT encoder weights over NaViT-style packed sequences
(``data/packing.py``): several images per sequence, isolated by
segment-masked attention (the segment kernels on the card, their plain
versions on the CPU); per-image masked mean pooling replaces the CLS token,
so padding and neighbour images contribute nothing. The position table
concatenates bicubic re-interpolations of the [1, S, D] embedding for every
allowed grid, so @384 weights serve 256/384/512-px images in one batch.

``apply_packed_tome`` merges tokens within segments after every attention
block (``ops.tome.tome_merge_packed``), so later layers see a shorter
sequence whose segment ids interleave.

Dropout takes per-layer seed triples and the global sequence of the
batch's first one (``row_base``), as ``vit.apply(dropout_seeds=...,
row_base=...)`` does.

A sharded tree (``parallel/fsdp.shard_params``, with ``params.layout``)
runs as ``vit.apply`` runs one: each block gathers its fsdp shards inside
the checkpoint, so the recompute gathers again, and on a tensor axis each
block runs the rank's heads and MLP columns between the two collectives
of ``parallel/tensor.py``, the segment kernels told the heads' place in
the model (``head_base``, ``heads_total``). The embedding, the position
table and the head read their shards gathered at the dtype the
one-process forward reads them in (the position embedding in f32 for the
bicubic products). The CLS token is not read.

As in the reference, ``apply_packed`` checkpoints each block whole under
``cfg.remat`` whatever ``cfg.remat_policy`` says, and has no fused Q/K/V
projection (``cfg.fused_qkv`` changes nothing there);
``apply_packed_tome`` runs each block under ``vit.remat_policy`` and
refuses ``fused_qkv``. The packed attention names no value: of the named
values only the GELU output (``mlp_hidden``) is there to drop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import vit
from chestxray_vit_tpu_torch.ops.flash_attention import attention_packed
from chestxray_vit_tpu_torch.ops.layer_norm import layer_norm
from chestxray_vit_tpu_torch.ops.tome import r_schedule, tome_merge_packed
from chestxray_vit_tpu_torch.parallel import fsdp


def build_pos_table(params: vit.ViT, cfg: ModelConfig,
                    grids: Sequence[int]) -> torch.Tensor:
    """Concatenated patch-position table [sum(g²), D] over the allowed
    grids, each block a bicubic re-interpolation of the embedding (the CLS
    slot dropped). Differentiable in ``params.pos_embed`` (a sharded
    tree's gathered in its own dtype)."""
    pe = params.pos_embed
    pe = fsdp.use(getattr(params, "layout", None), "pos_embed", pe, pe.dtype)
    return torch.cat([vit.interpolate_pos_embed(pe, g * g + 1)[0, 1:]
                      for g in grids], dim=0)


def _packed_mha(x: torch.Tensor, bp: vit.Block, cfg: ModelConfig,
                seg_ids: torch.Tensor, compute_dtype: torch.dtype,
                train: bool = False, seed: Optional[int] = None,
                return_key_mean: bool = False, row_base: int = 0, tp=None):
    """Multi-head attention within segments on the pre-LN input. The
    projections land as [B, H, S, hd] views, as in ``vit._mha``. With
    ``return_key_mean`` also the keys' mean over heads [B, S, hd], the
    token-merging metric. On a tensor axis ``tp`` (a ``mesh.Axis``) ``bp``
    holds this rank's columns and rows, as in ``vit._mha``: its H/t heads
    from head H/t·index on, the ``wo`` partials summed over the ranks
    before the bias, every head's keys gathered for the metric."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    x, h, head_base = vit._local_heads(x, cfg, tp)

    def heads(p: vit.Dense) -> torch.Tensor:
        return vit._linear(x, p, compute_dtype).view(b, s, h, hd).transpose(
            1, 2)

    q, k, v = heads(bp.wq), heads(bp.wk), heads(bp.wv)
    drop = train and cfg.attention_dropout > 0.0 and seed is not None
    o = attention_packed(q, k, v, seg_ids, cfg.attention_impl,
                         seed if drop else None, cfg.attention_dropout,
                         row_base, head_base, cfg.num_heads)
    out = vit._row_linear(o.transpose(1, 2).reshape(b, s, h * hd), bp.wo,
                          compute_dtype, tp)
    if return_key_mean:
        return out, vit._key_mean(k, tp)
    return out


def _packed_block(x: torch.Tensor, seg: torch.Tensor, bp: vit.Block,
                  cfg: ModelConfig, dt: torch.dtype, train: bool,
                  seeds: Optional[vit.LayerSeeds],
                  row_base: int, layout=None) -> torch.Tensor:
    """One packed block; a sharded tree's (``layout``) gathered here, so
    that a recompute gathers again."""
    tp = vit._tensor_axis(layout)
    if layout is not None:
        bp = fsdp.gather_block(layout, bp, dt)
    attn_seed, seed_attn_out, seed_mlp_out = seeds or (None, None, None)
    hidden = cfg.hidden_dropout if train else 0.0
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt),
                      cfg.layernorm_eps)
    attn_out = _packed_mha(a_in, bp, cfg, seg, dt, train, attn_seed,
                           row_base=row_base, tp=tp)
    x = x + vit._dropout(attn_out, hidden, seed_attn_out, row_base)
    return vit._mlp(x, bp, cfg, dt, hidden, seed_mlp_out, row_base, tp)


def _packed_tome_block(x: torch.Tensor, sizes: torch.Tensor,
                       seg: torch.Tensor, pw: torch.Tensor, bp: vit.Block,
                       cfg: ModelConfig, dt: torch.dtype, train: bool,
                       seeds: Optional[vit.LayerSeeds], r_i: int,
                       row_base: int, layout=None):
    """One block with the merge between attention and MLP; the count is
    clamped to the feasible maximum, as in the dense merging forward. A
    sharded tree's block is gathered here."""
    tp = vit._tensor_axis(layout)
    if layout is not None:
        bp = fsdp.gather_block(layout, bp, dt)
    attn_seed, seed_attn_out, seed_mlp_out = seeds or (None, None, None)
    hidden = cfg.hidden_dropout if train else 0.0
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt),
                      cfg.layernorm_eps)
    attn_out, kmean = _packed_mha(a_in, bp, cfg, seg, dt, train, attn_seed,
                                  return_key_mean=True, row_base=row_base,
                                  tp=tp)
    x = x + vit._dropout(attn_out, hidden, seed_attn_out, row_base)
    r_l = min(r_i, (x.shape[1] + 1) // 2 - 1)
    if r_l > 0:
        x, sizes, seg, pw = tome_merge_packed(x, kmean, sizes, seg, pw, r_l)
    return (vit._mlp(x, bp, cfg, dt, hidden, seed_mlp_out, row_base, tp),
            sizes, seg, pw)


def _embed_packed(params: vit.ViT, tokens: torch.Tensor,
                  segment_ids: torch.Tensor, pos_indices: torch.Tensor,
                  cfg: ModelConfig, grids: Sequence[int],
                  dt: torch.dtype) -> torch.Tensor:
    """Patch embedding plus the gathered position rows, zero on padding."""
    x = vit._linear(tokens.to(dt), fsdp.gather(
        getattr(params, "layout", None), params.patch_embed, "patch_embed",
        dt), dt)
    pos = build_pos_table(params, cfg, grids).to(dt)[pos_indices.long()]
    return (x + pos) * (segment_ids >= 0)[..., None].to(dt)


def _pooled_logits(params: vit.ViT, x: torch.Tensor,
                   pool_weights: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Final LN, per-image weighted mean of the tokens and the classifier
    head, in f32: [B, M, C]."""
    fl = params.final_ln
    x = layer_norm(x, fl.scale, fl.bias, cfg.layernorm_eps)
    pooled = torch.matmul(pool_weights.float(), x.float())
    return vit._head(params, pooled)


def apply_packed(params: vit.ViT, tokens: torch.Tensor,
                 segment_ids: torch.Tensor, pos_indices: torch.Tensor,
                 pool_weights: torch.Tensor, cfg: ModelConfig,
                 grids: Sequence[int] = (16, 24, 32), *, train: bool = False,
                 dropout_seeds: Optional[Sequence[vit.LayerSeeds]] = None,
                 row_base: int = 0) -> torch.Tensor:
    """Packed forward: tokens [B, S, patch_dim], int32 ``segment_ids`` and
    ``pos_indices`` [B, S], ``pool_weights`` [B, max_imgs, S] → f32 logits
    [B, max_imgs, C]. Shares every weight with :func:`vit.apply` except
    the CLS token (pooled instead). ``train``, ``dropout_seeds`` and
    ``row_base`` (here the global sequence of the first one) as in
    :func:`vit.apply`."""
    vit._check_supported(cfg, dropout_seeds)
    dt = vit.torch_dtype(cfg.dtype)
    x = _embed_packed(params, tokens, segment_ids, pos_indices, cfg, grids,
                      dt)
    # full remat whatever cfg.remat_policy says, as the reference's scan
    # body is checkpointed without a policy
    remat = train and cfg.remat and torch.is_grad_enabled()
    for i, bp in enumerate(params.blocks):
        args = (x, segment_ids, bp, cfg, dt, train,
                tuple(dropout_seeds[i]) if dropout_seeds is not None
                else None, row_base, params.layout)
        if remat:
            x = torch.utils.checkpoint.checkpoint(_packed_block, *args,
                                                  use_reentrant=False)
        else:
            x = _packed_block(*args)
    return _pooled_logits(params, x, pool_weights, cfg)


def apply_packed_tome(params: vit.ViT, tokens: torch.Tensor,
                      segment_ids: torch.Tensor, pos_indices: torch.Tensor,
                      pool_weights: torch.Tensor, cfg: ModelConfig,
                      grids: Sequence[int] = (16, 24, 32), *,
                      train: bool = False,
                      dropout_seeds: Optional[Sequence[vit.LayerSeeds]] = None,
                      return_segment_ids: bool = False, row_base: int = 0):
    """Packed forward with within-segment token merging (``cfg.tome_r``
    pairs per layer under ``cfg.tome_schedule``): after every attention
    block the most similar same-segment pairs merge, and the segment ids
    and pooling weights are routed with the tokens, so the segment-masked
    attention of later layers and the masked-mean readout stay exact.
    Padding merges first. Token counts shrink per layer, so every layer's
    attention runs at its own length. Gradients flow through the
    size-weighted means; the matching is piecewise constant. With
    ``return_segment_ids`` also the list of the ids [B, S_l] that each
    layer's attention saw (for tests and diagnostics)."""
    if cfg.tome_r <= 0:
        raise ValueError(f"tome r={cfg.tome_r} must be positive (use "
                         f"apply_packed for the un-merged path)")
    if cfg.fused_qkv:
        raise ValueError("model.fused_qkv does not compose with tome_r")
    vit._check_supported(cfg, dropout_seeds)
    dt = vit.torch_dtype(cfg.dtype)
    x = _embed_packed(params, tokens, segment_ids, pos_indices, cfg, grids,
                      dt)
    sizes = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    seg, pw = segment_ids, pool_weights.float()
    rs = r_schedule(cfg.tome_r, cfg.num_layers, cfg.tome_schedule)
    policy = (vit.remat_policy(cfg)
              if train and cfg.remat and torch.is_grad_enabled() else None)
    seen = []
    for i, (bp, r_i) in enumerate(zip(params.blocks, rs)):
        seen.append(seg)
        args = (x, sizes, seg, pw, bp, cfg, dt, train,
                tuple(dropout_seeds[i]) if dropout_seeds is not None
                else None, r_i, row_base, params.layout)
        x, sizes, seg, pw = (policy(_packed_tome_block, *args) if policy
                             else _packed_tome_block(*args))
    logits = _pooled_logits(params, x, pw, cfg)
    return (logits, seen) if return_segment_ids else logits


def packed_bce_parts(logits: torch.Tensor, labels: torch.Tensor,
                     image_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the masked mean BCE: the element sum
    over real images, and real images × classes. Kept apart so that
    gradient accumulation over micro-batches with unequal real-image
    counts stays exact: loss = Σnum_i / Σden_i, gradients Σ∇num_i / Σden_i
    (averaging per-micro ratios would weight micro-batches by 1/images_i)."""
    from chestxray_vit_tpu_torch.train.steps import bce_elements
    m = image_mask[..., None].float()                    # [B, M, 1]
    return (torch.sum(bce_elements(logits, labels) * m),
            torch.sum(m) * logits.shape[-1])


def packed_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    image_mask: torch.Tensor) -> torch.Tensor:
    """Mean BCE over real images only (pad slots masked out)."""
    num, den = packed_bce_parts(logits, labels, image_mask)
    return num / den.clamp_min(1.0)
