"""The Megatron split over the ``tensor`` mesh axis: the collectives XLA
derives from ``param_sharding``'s ``tensor`` rule
(``chestxray_vit_tpu/parallel/mesh.py``), written out as the two conjugate
autograd functions of Shoeybi et al. (arXiv:1909.08053) and a gather.

A tensor rank holds the columns of ``wq``, ``wk``, ``wv`` and ``mlp_in``
(with their biases) that make its heads and its MLP columns, and the
matching rows of ``wo`` and ``mlp_out``. In a block:

- :func:`copy_in` at the input of the column products: the identity
  forward; the backward sums the input's gradient over the tensor ranks
  (each rank's products see only its columns);
- :func:`reduce_out` after the row products: the forward sums the partial
  products over the tensor ranks; the backward is the identity. The bias
  is added once, after the sum, and hidden dropout runs on the summed,
  full residual stream, so every tensor rank draws the same mask;
- :func:`gather_heads`: the keys of every head, gathered in head order, so
  that the token-merging metric (their mean over heads) is computed as one
  process computes it. A partial-sum all-reduce of the mean would not do:
  matching sorts its scores, and a one-ulp change flips ties;
- :func:`gather_columns`: where the tensor size divides the width but not
  the heads, a rank's D/t columns of q, k or v may cut a head; the columns
  of every rank are gathered into whole heads, and the backward is the
  conjugate reduce-scatter (each rank keeps its columns' slice of the
  gradient summed over the ranks).

A Megatron pair (q, k, v with ``wo``; ``mlp_in`` with ``mlp_out``) whose
width the tensor size does not divide is not split at all: it runs whole
on every tensor rank, with none of these collectives, as the JAX rule
leaves its leaves replicated.

The sums run in f32 and round once to the activations' dtype.
"""

from __future__ import annotations

import torch

from chestxray_vit_tpu_torch.parallel.distributed import Axis


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad.float()).to(grad.dtype), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        return axis.all_reduce(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis, ctx.heads = axis, x.shape[1]
        return axis.all_gather(x, 1)

    @staticmethod
    def backward(ctx, grad):
        h0 = ctx.axis.index * ctx.heads
        return grad[:, h0:h0 + ctx.heads], None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return axis.all_gather(x, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.axis.reduce_scatter(grad.float(), grad.dim() - 1)
        return g.to(grad.dtype), None


def copy_in(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The input of the column products (identity; gradient summed)."""
    return _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of the row products' partials over the tensor ranks."""
    return _ReduceOut.apply(x, axis)


def gather_heads(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[B, H/t, ...] local heads → [B, H, ...] every head, in order."""
    return _GatherHeads.apply(x, axis)


def gather_columns(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[..., D/t] this rank's columns → [..., D] every rank's, in order;
    the backward sums the gradient over the ranks in f32 and keeps this
    rank's columns."""
    return _GatherColumns.apply(x, axis)
