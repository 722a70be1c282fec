"""Token merging (ToMe-style bipartite soft matching), ported from
``chestxray_vit_tpu/ops/tome.py``.

Tokens split into alternating sets A (even positions) and B (odd); each A
token proposes its most similar B token under cosine similarity of the
attention keys (mean over heads); the r best proposals merge source into
destination with a size-weighted mean, and sizes accumulate so repeated
merges stay means over the original tokens (Bolya et al., "Token Merging:
Your ViT But Faster", arXiv:2210.09461). Output tokens are ordered
[kept A …, B …]. As in the reference there is no proportional attention.

The merge stays the reference's one-hot routing product (a plain
``torch.matmul``; the reference has no Pallas kernel here).

Ties are certain on the packed path, not rare: every pad–pad pair scores
exactly 2.0. The reference resolves them by index (``jax.lax.top_k`` and a
stable ``argsort`` take the lowest index first among equals, ``argmax`` the
first maximum). ``torch.topk`` promises no order, so the r best proposals
come from a stable descending sort (:func:`_best_first`) and the
destination from an explicit first-maximum rule (:func:`_first_argmax`),
which give the same indices on the CPU and the card.

Rounding: with bf16 tokens the routing product runs in bf16 and its result
is read back as f32 before the divide by the sizes; the reference asks XLA
for an f32 result of the same bf16 product. A slot holds one token or the
sum of a few, so the two differ by at most one bf16 rounding of that sum.
"""

from __future__ import annotations

from typing import Tuple

import torch

_NEG_INF = -1e30


def r_schedule(r: int, num_layers: int, schedule: str = "constant"
               ) -> Tuple[int, ...]:
    """Per-layer merge counts for a nominal rate ``r``: ``'constant'`` is r
    pairs every layer; ``'decreasing'`` linearly decaying counts with the
    same nominal total r·L, weighted ∝ (L − l), the remainder going to the
    front. The forwards still clamp each layer to the feasible maximum."""
    if r < 0:
        raise ValueError(f"r={r} must be >= 0")
    if num_layers < 1:
        raise ValueError(f"num_layers={num_layers} must be >= 1")
    if schedule == "constant":
        return (r,) * num_layers
    if schedule != "decreasing":
        raise ValueError(f"unknown tome schedule {schedule!r} "
                         "(expected 'constant' or 'decreasing')")
    total = r * num_layers
    sw = num_layers * (num_layers + 1) // 2
    rs = [total * w // sw for w in range(num_layers, 0, -1)]
    for i in range(total - sum(rs)):
        rs[i] += 1
    return tuple(rs)


def _check_r(r: int, s: int) -> int:
    na = (s + 1) // 2
    if not 0 < r < na:
        raise ValueError(f"r={r} must be in (0, {na}) for S={s}")
    return na


def _scores(metric: torch.Tensor) -> torch.Tensor:
    """Cosine similarity [B, |A|, |B|] of the A tokens (even positions)
    with the B tokens (odd), in f32. The matching is piecewise constant:
    no gradient flows through it."""
    m = metric.detach().float()
    m = m / torch.linalg.norm(m, dim=-1, keepdim=True).clamp_min(1e-6)
    return torch.matmul(m[:, 0::2], m[:, 1::2].transpose(1, 2))


def _first_argmax(scores: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, index of the first maximum) over the last dim: among equal
    maxima the lowest index, on every device."""
    node_max = scores.max(dim=-1).values
    idx = torch.arange(scores.shape[-1], device=scores.device)
    first = idx.expand_as(scores).masked_fill(
        scores != node_max[..., None], scores.shape[-1]).min(dim=-1).values
    return node_max, first


def _best_first(node_max: torch.Tensor) -> torch.Tensor:
    """A-token indices by descending score; equal scores keep ascending
    index order (a stable sort)."""
    return torch.sort(node_max, dim=-1, descending=True,
                      stable=True).indices


def bipartite_soft_matching(metric: torch.Tensor, r: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Pick the r most mergeable (source, destination) pairs. metric:
    [B, S, d]; token 0 (CLS) is protected. Returns ``(unm_idx, src_idx,
    dst_idx)``: the A-set indices kept (ascending) and merged, and each
    merged source's B-set destination. Requires 0 < r < ceil(S/2)."""
    _check_r(r, metric.shape[1])
    scores = _scores(metric)
    scores[:, 0, :].fill_(_NEG_INF)                  # protect CLS
    node_max, node_idx = _first_argmax(scores)
    edge_order = _best_first(node_max)
    src_idx = edge_order[:, :r]
    unm_idx = torch.sort(edge_order[:, r:], dim=-1).values
    dst_idx = torch.gather(node_idx, 1, src_idx)
    return unm_idx, src_idx, dst_idx


def merge_tokens(x: torch.Tensor, sizes: torch.Tensor, unm_idx: torch.Tensor,
                 src_idx: torch.Tensor, dst_idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a matching: the size-weighted mean of each source into its
    destination. x: [B, S, D]; sizes: [B, S]. Returns ``(x', sizes')``
    with S − r tokens ordered [kept A …, B …]."""
    b, s, _ = x.shape
    na = (s + 1) // 2
    r = src_idx.shape[1]
    apos = torch.zeros((b, na), dtype=torch.int64, device=x.device)
    apos.scatter_(1, unm_idx, torch.arange(na - r, device=x.device)
                  .expand(b, na - r))
    apos.scatter_(1, src_idx, na - r + dst_idx)
    return _route_merge(x, sizes, apos, r)


def _match(scores: torch.Tensor, r: int) -> torch.Tensor:
    """Per-A-token output slots [B, |A|] of the r best proposals: a kept
    token its rank among the kept (ascending), a source its destination's
    B slot."""
    b, na, _ = scores.shape
    node_max, node_idx = _first_argmax(scores)
    src_idx = _best_first(node_max)[:, :r]
    dst_idx = torch.gather(node_idx, 1, src_idx)
    kept = torch.ones((b, na), dtype=torch.int64, device=scores.device)
    kept.scatter_(1, src_idx, 0)
    apos = (torch.cumsum(kept, dim=1) - 1) * kept
    return apos.scatter(1, src_idx, na - r + dst_idx)


def tome_merge(x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor,
               r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ToMe step: match on ``metric``, merge ``x``; equal to
    ``merge_tokens(x, sizes, *bipartite_soft_matching(metric, r))``.
    Returns ``(x', sizes')`` with r fewer tokens."""
    _check_r(r, x.shape[1])
    scores = _scores(metric)
    scores[:, 0, :].fill_(_NEG_INF)                  # protect CLS
    return _route_merge(x, sizes, _match(scores, r), r)


def tome_merge_clamped(x: torch.Tensor, metric: torch.Tensor,
                       sizes: torch.Tensor, r: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tome_merge` with ``r`` clamped to the most the length allows,
    ceil(S/2) − 1, as the merging forwards clamp every layer's count: deep
    layers with few tokens left merge less instead of erroring, and none at
    all once S ≤ 2."""
    r = min(r, (x.shape[1] + 1) // 2 - 1)
    if r <= 0:
        return x, sizes
    return tome_merge(x, metric, sizes, r)


def _out_slots(apos: torch.Tensor, b: int, s: int, r: int) -> torch.Tensor:
    """Per-token output slots [B, S] from per-A-token slots: B tokens keep
    their order after the kept-A block; A tokens go to their kept rank or
    their destination's B slot."""
    na, nb = (s + 1) // 2, s // 2
    out_slot = torch.empty((b, s), dtype=torch.int64, device=apos.device)
    out_slot[:, 0::2] = apos
    out_slot[:, 1::2] = na - r + torch.arange(nb, device=apos.device)
    return out_slot


def _route(out_slot: torch.Tensor, so: int) -> torch.Tensor:
    """The one-hot routing matrix, bool [B, S, S']."""
    return out_slot[..., None] == torch.arange(so, device=out_slot.device)


def _route_tokens(x: torch.Tensor, sizes: torch.Tensor, route: torch.Tensor,
                  out_slot: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(size-weighted mean of x per output slot in x's dtype, f32 sizes
    per slot): the routing product in bf16 for bf16 tokens, else f32;
    sizes are an exact f32 scatter-add (bf16 would round counts above 256)."""
    mm_dtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    sz = sizes.float()
    xw = (x.float() * sz[..., None]).to(mm_dtype)
    num = torch.matmul(route.to(mm_dtype).transpose(1, 2), xw).float()
    den = torch.zeros((x.shape[0], route.shape[2]), dtype=torch.float32,
                      device=x.device).scatter_add_(1, out_slot, sz)
    return (num / den[..., None]).to(x.dtype), den


def _route_merge(x: torch.Tensor, sizes: torch.Tensor, apos: torch.Tensor,
                 r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge via one one-hot routing product given per-A-token output
    slots."""
    b, s, _ = x.shape
    out_slot = _out_slots(apos, b, s, r)
    return _route_tokens(x, sizes, _route(out_slot, s - r), out_slot)


def tome_merge_packed(x: torch.Tensor, metric: torch.Tensor,
                      sizes: torch.Tensor, seg_ids: torch.Tensor,
                      pool_weights: torch.Tensor, r: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One within-segment ToMe step for packed sequences: the math of
    :func:`tome_merge` with two rules of its own. Cross-segment
    similarities are masked, so merges do not mix images; and the
    per-image pooling weights [B, M, S] ride the same routing matrix (as
    plain 0/1 sums: they carry the sizes already), which keeps the
    masked-mean readout exact. There is no CLS to protect. Pad pairs (both
    ids −1) are forced to score 2.0, above any cosine, so padding is
    compacted before content; they all tie, and the tie rules of this
    module pick the pairs the reference picks.

    As in the reference, nothing checks that r does not exceed the number
    of same-segment (A, B) pairs: a batch of length-1 segments would merge
    across segments silently (a masked proposal still has a destination).
    Returns ``(x', sizes', seg_ids', pool_weights')`` with S' = S − r."""
    b, s, _ = x.shape
    _check_r(r, s)
    scores = _scores(metric)
    seg_a, seg_b = seg_ids[:, 0::2], seg_ids[:, 1::2]
    scores = scores.masked_fill(seg_a[:, :, None] != seg_b[:, None, :],
                                _NEG_INF)
    pad_pair = (seg_a < 0)[:, :, None] & (seg_b < 0)[:, None, :]
    scores = scores.masked_fill(pad_pair, 2.0)
    out_slot = _out_slots(_match(scores, r), b, s, r)
    so = s - r
    route = _route(out_slot, so)
    out, den = _route_tokens(x, sizes, route, out_slot)
    # groups are segment-pure and every slot holds a token, so a
    # scatter-max from −2 recovers each slot's id
    seg_out = torch.full((b, so), -2, dtype=seg_ids.dtype,
                         device=x.device).scatter_reduce_(
        1, out_slot, seg_ids, "amax")
    pw = torch.matmul(pool_weights.float(), route.float())
    return out, den, seg_out, pw
