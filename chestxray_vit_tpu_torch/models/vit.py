"""Vision Transformer forward for serving and training, ported from
``chestxray_vit_tpu/models/vit.py``.

Parameters live in an ``nn.Module`` tree whose names mirror the JAX
parameter dict (``blocks.3.wq.kernel`` is ``params["blocks"]["wq"]
["kernel"][3]``). Dense kernels keep the JAX orientation ``[in, out]`` and
images stay NHWC with the (row, col, channel) patch flatten order, so the
bridge to the JAX tree is a copy (``models/bridge.py``).

Numerics follow the reference: block and embedding weights run in the
compute dtype, LayerNorm upcasts to f32 statistics (the final LN keeps its
f32 scale), GELU computes in f32, attention takes f32 scores and softmax,
and the classifier head runs in f32 on the CLS features.

Training (``train=True``) runs the dense forward with gradients through
the training attention and LayerNorm kernels; master parameters stay in
``param_dtype`` and are cast to the compute dtype inside every step, so
gradients reach them through the casts. ``remat=True`` runs each block
under ``cfg.remat_policy`` (:func:`remat_policy`, ``models/remat.py``:
``full`` checkpoints the block, as ``jax.checkpoint(scan_body,
policy=None)`` does; the selective policies keep what the reference's
keep, with the values named as there: ``attn_heads`` for q, k and v,
``mlp_hidden`` for the GELU output). ``cfg.fused_qkv`` runs the three
Q/K/V projections as one [D, 3D] product, the weights stacked once per
forward outside the layer loop. Dropout follows the reference's HF
semantics: on the softmax probabilities (``attention_dropout``, through the
dropout attention kernels, whose counter-hash mask is the JAX package's
bit for bit) and after the attention output and the MLP
(``hidden_dropout``, the counter-hash kernel of ``ops/hidden_dropout.py``).
Each takes a per-layer integer seed from the caller
(``apply(dropout_seeds=...)``; the train step draws them), so a block
recomputed under remat draws the same masks, and both masks are keyed by
the global batch row (``apply(row_base=...)``), so a data-parallel rank
draws its slice of the global batch's masks.

With ``cfg.tome_r`` set, :func:`apply` runs the token-merging forward of
``models/tome_forward.py`` (training and eval alike, as the reference
does).

A sharded tree (``parallel/fsdp.shard_params``: this rank's shards of a
(dcn, data, fsdp, tensor) mesh, with ``params.layout``) runs the same
forward: each layer gathers its ``fsdp`` shards at use, inside the block,
so remat gathers again (``parallel/fsdp.py``), and on a ``tensor`` axis
each block runs the rank's heads and MLP columns between the two
conjugate collectives of ``parallel/tensor.py``: q, k and v are
[B, H/t, S, hd] views of the local column products (:class:`RankHeads`;
where t divides the width but not the heads, the columns of every rank are
gathered and the rank runs the heads its columns touch), the attention
takes the heads' place in the model (``head_base``, ``heads_total``) so
the dropout mask is the global one's slice, and the row products' partial
sums are summed over the tensor ranks before their bias and the hidden
dropout. A pair whose width t does not divide (q, k, v with ``wo``;
``mlp_in`` with ``mlp_out``) is not split: it runs whole on every tensor
rank, as one process runs it, with no collective (:func:`_tensor_axis`).

The unrolled form (:func:`unstack_blocks`, :func:`run_block`,
:func:`apply_with_attention`) serves the attention maps: its attention is
the plain one with f32 scores and softmax, returning the probabilities.
"""

from __future__ import annotations

import copy
import types
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import remat
from chestxray_vit_tpu_torch.models.remat import checkpoint_name
from chestxray_vit_tpu_torch.ops.flash_attention import (attention,
                                                         attention_dropout)
from chestxray_vit_tpu_torch.ops.gelu import erf_gelu_factors, gelu
from chestxray_vit_tpu_torch.ops.hidden_dropout import hidden_dropout
from chestxray_vit_tpu_torch.ops.layer_norm import layer_norm
from chestxray_vit_tpu_torch.parallel import fsdp, tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# One layer's dropout seeds: (attention probabilities, hidden dropout after
# the attention output, hidden dropout after the MLP).
LayerSeeds = Tuple[int, int, int]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ModelConfig dtype name (f32 or bf16: the two
    the kernels take)."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: the port runs float32 or bfloat16")
    return _DTYPES[name]


class Dense(nn.Module):
    """``x @ kernel + bias`` with a JAX-oriented ``[in, out]`` kernel."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype))


class Norm(nn.Module):
    """LayerNorm parameters (scale ones, bias zeros)."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype))


class Block(nn.Module):
    """Parameters of one pre-LN encoder block (HF ViTLayer)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d, m = cfg.hidden_size, cfg.mlp_dim
        self.ln1, self.ln2 = Norm(d, dtype), Norm(d, dtype)
        self.wq, self.wk = Dense(d, d, dtype), Dense(d, d, dtype)
        self.wv, self.wo = Dense(d, d, dtype), Dense(d, d, dtype)
        self.mlp_in, self.mlp_out = Dense(d, m, dtype), Dense(m, d, dtype)


class ViT(nn.Module):
    """The parameter tree of ``vit.init_params``; ``forward`` is
    :func:`apply`."""

    # a sharded tree's ``parallel.mesh.Layout`` (parallel/fsdp.py)
    layout = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        pdt = torch_dtype(cfg.param_dtype)
        d = cfg.hidden_size
        self.patch_embed = Dense(cfg.patch_size * cfg.patch_size * 3, d, pdt)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=pdt))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, d,
                                                  dtype=pdt))
        self.blocks = nn.ModuleList(Block(cfg, pdt)
                                    for _ in range(cfg.num_layers))
        self.final_ln = Norm(d, pdt)
        self.head = Dense(d, cfg.num_classes, pdt)

    def forward(self, images: torch.Tensor,
                return_features: bool = False):
        return apply(self, images, self.cfg, return_features=return_features)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Optional[torch.device] = None) -> ViT:
    """HF ViT init: trunc-normal(0.02) weights (cut at ±2 std, as
    ``jax.nn.initializers.truncated_normal``), zero biases, unit LN
    scales. Drawn on the CPU from ``generator`` (the same seed gives the
    same weights on any device), then moved to ``device``."""
    params = ViT(cfg)
    trunc = [params.patch_embed.kernel, params.cls_token, params.pos_embed,
             params.head.kernel]
    for blk in params.blocks:
        trunc += [blk.wq.kernel, blk.wk.kernel, blk.wv.kernel,
                  blk.wo.kernel, blk.mlp_in.kernel, blk.mlp_out.kernel]
    with torch.no_grad():
        for t in trunc:
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
    return params.to(device) if device is not None else params


def inference_params(params: ViT, device: torch.device) -> ViT:
    """A frozen copy of ``params`` on ``device`` with every weight that
    :func:`apply` casts to the compute dtype already cast, so a serving
    forward does not re-cast 85M weights per call. The final LN and the
    head keep the parameter dtype, as ``apply`` reads them."""
    cfg = params.cfg
    out = copy.deepcopy(params).to(device=device,
                                   dtype=torch_dtype(cfg.dtype))
    out.final_ln = copy.deepcopy(params.final_ln).to(device)
    out.head = copy.deepcopy(params.head).to(device)
    return out.requires_grad_(False)


# ---------------------------------------------------------------------------
# Position-embedding resize
# ---------------------------------------------------------------------------

def _torch_bicubic_weights(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] f32 1-D resampling matrix with the numerics of
    ``torch.nn.functional.interpolate(mode='bicubic', align_corners=False)``:
    the cubic-convolution kernel with a = −0.75, source coordinate
    (i + 0.5)·scale − 0.5, and taps clamped to the edge (a clamped tap adds
    its weight to the edge sample). Built in f64 on the host, as the
    reference builds it."""
    a = -0.75
    scale = in_size / out_size

    def cubic(x: float) -> float:
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
        if x < 2.0:
            return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a
        return 0.0

    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for k in range(-1, 3):
            idx = min(max(i0 + k, 0), in_size - 1)
            w[i, idx] += cubic(k - t)
    return w.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          new_seq_len: int) -> torch.Tensor:
    """Resize learned position embeddings to a new patch grid:
    [1, S_old, D] → [1, S_new, D]. The CLS slot is kept and the patch grid
    is resampled by the separable bicubic of :func:`_torch_bicubic_weights`
    as two f32 matrix products on tensors, so the gradient reaches
    ``pos_embed`` (``F.interpolate`` is the tests' oracle, not called
    here). An unchanged grid returns ``pos_embed`` itself."""
    cls_tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    g_old = int(grid.shape[1] ** 0.5)
    g_new = int((new_seq_len - 1) ** 0.5)
    if g_new * g_new != new_seq_len - 1:
        raise ValueError(f"seq_len {new_seq_len} is not grid² + 1")
    if g_new == g_old:
        return pos_embed
    d = grid.shape[-1]
    w = torch.from_numpy(_torch_bicubic_weights(g_new, g_old)).to(
        pos_embed.device)                                # [g_new, g_old]
    g = grid.reshape(g_old, g_old, d).float()
    g = torch.einsum("oi,ijd->ojd", w, g)                # rows
    g = torch.einsum("oj,njd->nod", w, g)                # then columns
    resized = g.reshape(1, g_new * g_new, d).to(pos_embed.dtype)
    return torch.cat([cls_tok, resized], dim=1)


def adapt_params_to_img_size(params: ViT, cfg: ModelConfig) -> ViT:
    """``params`` with position embeddings matched to ``cfg.img_size``:
    the same tree when they already match, else a copy with ``pos_embed``
    resized (and ``cfg`` as its config)."""
    if params.pos_embed.shape[1] == cfg.seq_len:
        return params
    out = copy.deepcopy(params)
    out.cfg = cfg
    with torch.no_grad():
        out.pos_embed = nn.Parameter(
            interpolate_pos_embed(params.pos_embed.detach(), cfg.seq_len))
    return out


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, p: Dense, dtype: torch.dtype) -> torch.Tensor:
    # product and bias add round separately, as jnp.dot(x, k) + b does
    return torch.matmul(x, p.kernel.to(dtype)) + p.bias.to(dtype)


def _row_linear(x: torch.Tensor, p: Dense, dtype: torch.dtype,
                tp) -> torch.Tensor:
    """:func:`_linear` of a row-parallel product on a tensor axis ``tp``
    (a ``mesh.Axis``, or None): the partial products summed over the
    tensor ranks, then the bias, once."""
    if tp is None:
        return _linear(x, p, dtype)
    return (tensor.reduce_out(torch.matmul(x, p.kernel.to(dtype)), tp)
            + p.bias.to(dtype))


def _tensor_axis(layout, pair: str = "wq"):
    """The tensor axis a sharded tree's layout splits a block's Megatron
    pair over (``pair`` "wq": the attention's, "mlp_in": the MLP's), None
    without one or where the tensor size does not divide the pair's width:
    that pair runs whole on every tensor rank, with no collective."""
    if layout is None or layout.mesh.tensor == 1:
        return None
    if layout.of(f"blocks.0.{pair}.kernel")[1] is None:
        return None
    return layout.mesh.axis("tensor")


class RankHeads:
    """Where a rank's q, k and v columns lie among the model's heads.

    Without a tensor axis (or with the attention pair whole on it) the rank
    holds every head. On a tensor axis ``tp`` of t it holds the D/t columns
    [c0, c0 + D/t) of q, k and v and the matching rows of ``wo``. When t
    divides the heads those columns are whole heads [H/t·index, H/t·(index
    + 1)); when it does not, they may cut a head: the columns of every rank
    are gathered (``tensor.gather_columns``), the rank runs the heads
    [h0, h1) its columns touch, and its ``wo`` rows read their columns of
    the heads' output back."""

    def __init__(self, cfg: ModelConfig, tp):
        d, hd = cfg.hidden_size, cfg.head_dim
        self.tp, self.hd = tp, hd
        self.cols = d if tp is None else d // tp.size
        self.c0 = 0 if tp is None else tp.index * self.cols
        self.gather = self.cols % hd != 0
        self.h0 = self.c0 // hd
        self.h1 = -(-(self.c0 + self.cols) // hd)

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        """A [B, S, D/t] column product as heads [B, h, S, hd]: the rank's
        whole heads, or, when its columns cut a head, every head (the
        columns gathered over the tensor ranks)."""
        b, s, _ = t.shape
        if self.gather:
            t = tensor.gather_columns(t, self.tp)
        return t.view(b, s, -1, self.hd).transpose(1, 2)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The heads the rank runs attention on, from :meth:`heads`."""
        return t[:, self.h0:self.h1] if self.gather else t

    def merge(self, o: torch.Tensor) -> torch.Tensor:
        """[B, h, S, hd] attention output → [B, S, D/t], the columns the
        rank's ``wo`` rows read."""
        b, h, s, hd = o.shape
        o = o.transpose(1, 2).reshape(b, s, h * hd)
        if self.gather:
            lo = self.c0 - self.h0 * hd
            o = o[..., lo:lo + self.cols]
        return o

    def key_mean(self, k: torch.Tensor) -> torch.Tensor:
        """The token-merging metric from :meth:`heads`' keys, the mean over
        every head: on a rank of whole heads every head's keys are gathered
        first (a sum of the ranks' partial means would flip sort ties);
        gathered columns already hold every head."""
        if self.tp is not None and not self.gather:
            k = tensor.gather_heads(k, self.tp)
        return k.mean(dim=1)


def _local_heads(x: torch.Tensor, cfg: ModelConfig, tp):
    """(the column products' input, the rank's :class:`RankHeads`) on a
    tensor axis ``tp`` (None: the attention pair runs whole here): on a
    split pair the input passes ``tensor.copy_in``."""
    if tp is not None:
        x = tensor.copy_in(x, tp)
    return x, RankHeads(cfg, tp)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC [B, H, W, 3] → [B, N, patch*patch*3], flattened per patch as
    (row-in-patch, col-in-patch, channel)."""
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images.reshape(b, nh, patch, nw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)                # [B, nh, nw, p, p, c]
    return x.reshape(b, nh * nw, patch * patch * c)


def embed(params: ViT, images: torch.Tensor, cfg: ModelConfig,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """Patch-embed + CLS + learned position embeddings (HF ViTEmbeddings)."""
    layout, dt = getattr(params, "layout", None), compute_dtype
    patches = patchify(images.to(dt), cfg.patch_size)
    x = _linear(patches, fsdp.gather(layout, params.patch_embed,
                                     "patch_embed", dt), dt)
    cls = fsdp.use(layout, "cls_token", params.cls_token, dt).expand(
        x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + fsdp.use(layout, "pos_embed", params.pos_embed, dt)


def _mha(x: torch.Tensor, bp: Block, cfg: ModelConfig, attn_impl: str,
         compute_dtype: torch.dtype, train: bool = False,
         seed: Optional[int] = None, return_key_mean: bool = False,
         wqkv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
         return_probs: bool = False, row_base: int = 0, tp=None):
    """Multi-head attention on the pre-LN input.

    Each projection lands as a [B, H, S, hd] view of its [B, S, D] product
    (no copy); with ``wqkv`` (the stacked [D, 3D] kernel and [3D] bias of
    :func:`fused_qkv_weights`) the three are one product, and q, k, v are
    views of its [B, S, 3, H, hd] result. The kernels read those strides
    in place and write heads already merged in memory for the output
    projection. q, k and v are named ``attn_heads`` for the remat
    policies. A training forward with ``attention_dropout`` and a ``seed``
    drops probabilities inside the attention (the dropout kernels on the
    card, their plain version on the CPU or with ``impl='xla'``), x's first
    row global batch row ``row_base``.
    ``return_probs`` runs the plain attention with f32 scores and softmax
    (the reference's ``"xla"`` route) and also returns the probabilities
    [B, H, S, S] f32. With ``return_key_mean`` also the keys' mean over
    heads [B, S, hd] in the compute dtype, the token-merging metric.
    On a tensor axis ``tp`` (a ``mesh.Axis``) ``bp`` holds this rank's
    columns and rows (:class:`RankHeads`): its H/t heads from head
    H/t·index on, or, when its columns cut a head, the heads they touch
    after a gather of every rank's columns; the keys of every head for the
    metric."""
    b, s, _ = x.shape
    x, rh = _local_heads(x, cfg, tp)

    def heads():
        if wqkv is not None:
            qkv = torch.matmul(x, wqkv[0]) + wqkv[1]
            return tuple(rh.heads(t)
                         for t in qkv.view(b, s, 3, rh.cols).unbind(2))
        return tuple(rh.heads(_linear(x, p, compute_dtype))
                     for p in (bp.wq, bp.wk, bp.wv))

    q, k, v = checkpoint_name("attn_heads", heads)
    probs = None
    if return_probs:
        o, probs = _attention_probs(q, k, v)
    else:
        o = attend(rh.own(q), rh.own(k), rh.own(v), cfg, attn_impl, train,
                   seed, row_base, rh.h0)
    out = _row_linear(rh.merge(o), bp.wo, compute_dtype, tp)
    if return_probs:
        return out, probs
    if return_key_mean:
        return out, rh.key_mean(k)
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, attn_impl: str, train: bool,
           seed: Optional[int], row_base: int = 0,
           head_base: int = 0) -> torch.Tensor:
    """The attention of a block on [B, H, S, hd] heads: with ``train``,
    ``attention_dropout`` and a ``seed`` the dropout kernels (q's first
    row global batch row ``row_base``, its first head the model's head
    ``head_base`` of ``cfg.num_heads``), else the training kernels
    (``train``) or the forward-only one."""
    if train and cfg.attention_dropout > 0.0 and seed is not None:
        return attention_dropout(q, k, v, seed, cfg.attention_dropout,
                                 impl=attn_impl, row_base=row_base,
                                 head_base=head_base,
                                 heads_total=cfg.num_heads)
    return attention(q, k, v, impl=attn_impl, inference=not train)


def _attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in v's dtype, probabilities f32 [B, H, S, S]): scores and softmax
    in f32, the product with V in v's dtype, as the reference's unfused
    branch computes them."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (
        q.shape[-1] ** 0.5)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v), probs


def fused_qkv_weights(params: "ViT", compute_dtype: torch.dtype
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer, the Q/K/V kernels stacked into one [D, 3D] kernel (q's
    columns, then k's, then v's) and their biases into one [3D] bias, in
    the compute dtype: the reference's ``wqkv``, built once per forward
    outside the layer loop. Differentiable in the three projections."""
    return [_stacked_qkv(bp, compute_dtype) for bp in params.blocks]


def _stacked_qkv(bp, compute_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's [D, 3D] kernel and [3D] bias of :func:`fused_qkv_weights`
    (of a tensor rank's columns: [D, 3D/t])."""
    return (torch.cat([bp.wq.kernel, bp.wk.kernel, bp.wv.kernel],
                      dim=1).to(compute_dtype),
            torch.cat([bp.wq.bias, bp.wk.bias, bp.wv.bias]).to(
                compute_dtype))


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int],
             row_base: int = 0) -> torch.Tensor:
    """Hidden dropout, ``where(keep, x / (1 − rate), 0)`` in x's dtype
    (the reference's ``_dropout``), through ``ops.hidden_dropout``: keep
    is a counter hash of ``seed`` and each element's global index (x's
    first row global batch row ``row_base``), so a recompute under remat,
    a data-parallel rank's slice and the card and the CPU draw the same
    mask. Off at rate 0 or without a seed."""
    if rate == 0.0 or seed is None:
        return x
    return hidden_dropout(x, seed, rate, row_base)


def _gelu_named(u: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU of the MLP's first product, named ``mlp_hidden``. Its rebuild
    reads what the GELU's backward keeps anyway: the two f32 factors of
    the exact form (their product's node saves both), the input of the
    tanh form."""
    if approximate:
        return checkpoint_name("mlp_hidden", gelu, u, True)
    half, cdf = erf_gelu_factors(u)
    dt = u.dtype          # the rebuild must not hold u itself
    return checkpoint_name("mlp_hidden", lambda a, c: (a * c).to(dt),
                           half, cdf)


def _mlp(x: torch.Tensor, bp: Block, cfg: ModelConfig, dt: torch.dtype,
         hidden: float, seed: Optional[int],
         row_base: int = 0, tp=None) -> torch.Tensor:
    """x + drop(MLP(LN2(x))) with erf GELU (on a tensor axis ``tp``, this
    rank's MLP columns, the output summed over the tensor ranks)."""
    m_in = layer_norm(x, bp.ln2.scale.to(dt), bp.ln2.bias.to(dt),
                      cfg.layernorm_eps)
    if tp is not None:
        m_in = tensor.copy_in(m_in, tp)
    hmid = _gelu_named(_linear(m_in, bp.mlp_in, dt), cfg.gelu_approximate)
    return x + _dropout(_row_linear(hmid, bp.mlp_out, dt, tp), hidden, seed,
                        row_base)


def _block(x: torch.Tensor, bp: Block, cfg: ModelConfig, attn_impl: str,
           compute_dtype: torch.dtype, train: bool = False,
           seeds: Optional[LayerSeeds] = None,
           wqkv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           row_base: int = 0, layout=None) -> torch.Tensor:
    """One pre-LN encoder block (HF ViTLayer):
    x += drop(MHA(LN1(x))); x += drop(MLP(LN2(x))) with erf GELU. With a
    sharded tree's ``layout`` the block's shards are gathered here (and
    with ``cfg.fused_qkv`` stacked), so that a recompute gathers again."""
    dt = compute_dtype
    tp, tp_mlp = _tensor_axis(layout), _tensor_axis(layout, "mlp_in")
    if layout is not None:
        bp = fsdp.gather_block(layout, bp, dt)
        if cfg.fused_qkv:
            wqkv = _stacked_qkv(bp, dt)
    attn_seed, seed_attn_out, seed_mlp_out = seeds or (None, None, None)
    hidden = cfg.hidden_dropout if train else 0.0
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt),
                      cfg.layernorm_eps)
    attn_out = _mha(a_in, bp, cfg, attn_impl, dt, train, attn_seed,
                    wqkv=wqkv, row_base=row_base, tp=tp)
    x = x + _dropout(attn_out, hidden, seed_attn_out, row_base)
    return _mlp(x, bp, cfg, dt, hidden, seed_mlp_out, row_base, tp_mlp)


def _check_supported(cfg: ModelConfig,
                     dropout_seeds: Optional[Sequence[LayerSeeds]] = None
                     ) -> None:
    """Refuse a seed list of the wrong length."""
    if dropout_seeds is not None and len(dropout_seeds) != cfg.num_layers:
        raise ValueError(f"{len(dropout_seeds)} dropout seed triples for "
                         f"{cfg.num_layers} layers")


def remat_policy(cfg: ModelConfig) -> remat.Policy:
    """The block remat of ``cfg.remat_policy`` with the reference's
    meaning (``models/remat.py``): ``full`` recomputes the block; ``mlp``
    saves anything except the GELU output, ``attn`` anything except q, k
    and v (the attention kernel's operands), ``attn_mlp`` both;
    ``flash_out`` saves only the attention kernel's o and lse, ``dots``
    only matrix-product outputs. An unknown name raises (the reference
    runs full remat for it)."""
    return remat.Policy(cfg.remat_policy)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def head_logits(params: ViT, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Final LN + CLS classifier head on encoder output tokens."""
    fl = params.final_ln
    x = layer_norm(tokens, fl.scale, fl.bias, cfg.layernorm_eps)
    return _head(params, x[:, 0, :])


def _head(params: ViT, cls_features: torch.Tensor) -> torch.Tensor:
    head = params.head
    kernel = fsdp.use(getattr(params, "layout", None), "head.kernel",
                      head.kernel, torch.float32)
    return torch.matmul(cls_features.float(), kernel) + head.bias.float()


def apply(params: ViT, images: torch.Tensor, cfg: ModelConfig, *,
          train: bool = False, return_features: bool = False,
          dropout_seeds: Optional[Sequence[LayerSeeds]] = None,
          row_base: int = 0):
    """Forward pass.

    Args:
      images: NHWC f32/bf16 [B, img, img, 3].
      train: the training forward (attention through the training
        kernels, which keep what the backward needs; ``cfg.remat`` runs
        each block under :func:`remat_policy`). False takes the
        forward-only attention kernel, which refuses tensors that need a
        gradient: run eval and serving under ``torch.no_grad()`` or
        ``torch.inference_mode()``.
      return_features: also return the final-LN CLS features.
      dropout_seeds: one ``(attention, hidden after attention, hidden
        after MLP)`` triple of ints per layer, the counterpart of the
        reference's ``rng``: with ``train`` they switch on the configured
        dropout rates; None leaves dropout off, as ``rng=None`` does there.
      row_base: the global batch row of ``images``' first row (0 in one
        process; a data-parallel rank's offset in the global batch), the
        row the dropout masks are keyed by.

    With ``cfg.tome_r`` set (and no ``return_features``) the forward is
    :func:`models.tome_forward.apply_tome_train`, for ``train`` True and
    False alike, as in the reference: the model evaluated is the model
    trained.

    Returns logits f32 [B, num_classes] (and features if requested).
    """
    if cfg.tome_r and not return_features:
        # per-layer shapes: an unrolled loop of its own (imported here:
        # tome_forward imports this module)
        from chestxray_vit_tpu_torch.models.tome_forward import (
            apply_tome_train)
        return apply_tome_train(params, images, cfg, cfg.tome_r, train=train,
                                dropout_seeds=dropout_seeds,
                                schedule=cfg.tome_schedule,
                                row_base=row_base)
    _check_supported(cfg, dropout_seeds)
    compute_dtype = torch_dtype(cfg.dtype)
    x = embed(params, images, cfg, compute_dtype)
    policy = (remat_policy(cfg)
              if train and cfg.remat and torch.is_grad_enabled() else None)
    layout = params.layout
    wqkv = (fused_qkv_weights(params, compute_dtype)
            if cfg.fused_qkv and layout is None
            else [None] * cfg.num_layers)
    for i, bp in enumerate(params.blocks):   # the JAX lax.scan over layers
        args = (x, bp, cfg, cfg.attention_impl, compute_dtype, train,
                tuple(dropout_seeds[i]) if dropout_seeds is not None
                else None, wqkv[i], row_base, layout)
        x = policy(_block, *args) if policy else _block(*args)
    fl = params.final_ln
    x = layer_norm(x, fl.scale, fl.bias, cfg.layernorm_eps)
    cls_features = x[:, 0, :]
    logits = _head(params, cls_features)
    if return_features:
        return logits, cls_features
    return logits


# ---------------------------------------------------------------------------
# Unrolled form (attention maps)
# ---------------------------------------------------------------------------

def unstack_blocks(params: ViT, cfg: ModelConfig,
                   compute_dtype: Optional[torch.dtype] = None) -> list:
    """Per-layer parameter trees in the compute dtype (``cfg.dtype`` by
    default): attribute trees shaped like a :class:`Block`, differentiable
    in the parameters."""
    dt = compute_dtype or torch_dtype(cfg.dtype)

    def cast(module: nn.Module):
        return types.SimpleNamespace(**{
            name: cast(child) for name, child in module.named_children()},
            **{name: p.to(dt) for name, p in
               module.named_parameters(recurse=False)})
    return [cast(bp) for bp in params.blocks]


def run_block(x: torch.Tensor, bp, cfg: ModelConfig,
              return_probs: bool = False):
    """One encoder block, unrolled form (the introspection paths): (x,
    probabilities [B, H, S, S] f32 with ``return_probs``, else None). The
    attention is the plain one with f32 scores and softmax; LayerNorm is
    the kernel. No dropout."""
    dt = torch_dtype(cfg.dtype)
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt),
                      cfg.layernorm_eps)
    if return_probs:
        attn_out, probs = _mha(a_in, bp, cfg, "xla", dt, return_probs=True)
    else:
        attn_out, probs = _mha(a_in, bp, cfg, "xla", dt), None
    return _mlp(x + attn_out, bp, cfg, dt, 0.0, None), probs


def apply_with_attention(params: ViT, images: torch.Tensor,
                         cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass that also returns every layer's attention
    probabilities [L, B, H, S, S] f32, for attention-rollout maps (the
    serving path): (logits f32 [B, C], probabilities)."""
    dt = torch_dtype(cfg.dtype)
    x = embed(params, images, cfg, dt)
    blocks = unstack_blocks(params, cfg, dt)
    all_probs = None
    for i, bp in enumerate(blocks):
        x, probs = run_block(x, bp, cfg, return_probs=True)
        if all_probs is None:
            all_probs = probs.new_empty((len(blocks), *probs.shape))
        all_probs[i] = probs
    return head_logits(params, x, cfg), all_probs
