"""ZeRO-3 parameter shards over the ``fsdp`` mesh axis: the port's
counterpart of the JAX package's ``fsdp`` shardings
(``chestxray_vit_tpu/parallel/mesh.py`` ``param_sharding``), whose
collectives XLA derives and which are written out here.

Each rank keeps its shard of every ``fsdp``-sharded parameter
(:func:`shard_params`: a ``ViT`` whose parameters are the local slices,
carrying its ``Layout`` as ``params.layout``), and the AdamW moments
follow the parameters' shapes, so they are sharded alike. A layer's shards
are gathered where the forward reads them (:func:`use`, :func:`gather`),
after the cast to the compute dtype, so a bf16 step moves half the bytes;
the gather's backward reduce-scatters the gradient in f32 over the
``fsdp`` group, each rank keeping its shard's sum
(``distributed.all_reduce_grads`` then sums it over dcn × data). Under
remat the recompute gathers again, as XLA's rematerialised all-gather
does. ``tensor`` splits (``parallel/tensor.py``) stay local here: a
parameter split on both axes is gathered over ``fsdp`` only.

:func:`gather_params` / :func:`gather_named` rebuild the full tensors
(gathered over both axes, on every rank) for a checkpoint, a saved model
or a quantized tree; :func:`shard_named` cuts full tensors to this rank's
shards. ``torch.distributed.fsdp`` is not used: the port keeps its own
AdamW and global-norm clip (``train/optimizer.py``).
"""

from __future__ import annotations

import types
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from chestxray_vit_tpu_torch.parallel.distributed import Axis
from chestxray_vit_tpu_torch.parallel.mesh import Layout, Mesh, param_layout


class _GatherCast(torch.autograd.Function):
    """Forward: cast a shard to the compute dtype and all-gather it along
    its fsdp dim. Backward: the f32 reduce-scatter of the gradient."""

    @staticmethod
    def forward(ctx, shard, dtype, dim, axis: Axis):
        ctx.dim, ctx.axis, ctx.dtype = dim, axis, shard.dtype
        return axis.all_gather(shard.to(dtype), dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.axis.reduce_scatter(grad.float(), ctx.dim)
        return g.to(ctx.dtype), None, None, None


def use(layout: Optional[Layout], name: str, p: torch.Tensor,
        dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` (``p``, this rank's shard of it) in ``dtype`` as
    the forward reads it: gathered over ``fsdp`` when it is sharded there,
    else just cast."""
    if layout is None or layout.mesh.fsdp == 1:
        return p.to(dtype)
    dim = layout.of(name)[0]
    if dim is None:
        return p.to(dtype)
    return _GatherCast.apply(p, dtype, dim, layout.mesh.axis("fsdp"))


def gather(layout: Optional[Layout], module: nn.Module, prefix: str,
           dtype: torch.dtype):
    """``module``'s parameters (``prefix`` its name in the model; a block
    may be named by block 0, the layers are laid out alike) as an
    attribute tree shaped like it, each leaf :func:`use`'d in ``dtype``."""
    return types.SimpleNamespace(
        **{n: gather(layout, c, f"{prefix}.{n}", dtype)
           for n, c in module.named_children()},
        **{n: use(layout, f"{prefix}.{n}", p, dtype)
           for n, p in module.named_parameters(recurse=False)})


def gather_block(layout: Optional[Layout], bp: nn.Module,
                 dtype: torch.dtype):
    """A block's parameters gathered and cast (see :func:`gather`)."""
    return gather(layout, bp, "blocks.0", dtype)


# ---------------------------------------------------------------------------
# Whole tensors <-> shards
# ---------------------------------------------------------------------------

def local_slice(layout: Layout, name: str, full: torch.Tensor
                ) -> torch.Tensor:
    """This rank's shard of the full tensor of ``name``."""
    mesh = layout.mesh
    _, _, f, t = mesh.coords
    fd, tdim = layout.of(name)
    if tuple(full.shape) != layout.shapes[name]:
        raise ValueError(f"{name}: shape {tuple(full.shape)} != "
                         f"{layout.shapes[name]}")
    if fd is not None:
        full = full.chunk(mesh.fsdp, fd)[f]
    if tdim is not None:
        full = full.chunk(mesh.tensor, tdim)[t]
    return full.contiguous()


def full_tensor(layout: Layout, name: str, local: torch.Tensor
                ) -> torch.Tensor:
    """The full tensor of ``name`` from every rank's shard, on every rank
    (a collective: every rank calls it for the same names, in order)."""
    mesh = layout.mesh
    fd, tdim = layout.of(name)
    out = local.detach()
    if fd is not None:
        out = mesh.axis("fsdp").all_gather(out, fd)
    if tdim is not None:
        out = mesh.axis("tensor").all_gather(out, tdim)
    return out


def gather_named(layout: Optional[Layout],
                 named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full tensors of a by-name dict of shards (parameters or moments);
    the dict itself without a layout."""
    if layout is None:
        return dict(named)
    return {n: full_tensor(layout, n, t) for n, t in named.items()}


def shard_named(layout: Optional[Layout],
                named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's shards of a by-name dict of full tensors."""
    if layout is None:
        return dict(named)
    return {n: local_slice(layout, n, t) for n, t in named.items()}


def shard_params(params: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut a full ``ViT`` (the same on every rank: seed-drawn, loaded or
    bridged) to this rank's shards of ``mesh``'s layout, in place, and
    give it ``params.layout``. A mesh without fsdp or tensor axes leaves
    it whole and without a layout."""
    if not mesh.sharded:
        return params
    layout = param_layout(mesh, params)
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        module._parameters[leaf] = nn.Parameter(
            local_slice(layout, name, p.detach()).clone(),
            requires_grad=p.requires_grad)
    params.layout = layout
    return params


def gather_params(params: nn.Module) -> nn.Module:
    """The full model of a sharded ``ViT``, on every rank (a collective), as
    a new ``ViT`` without a layout on the shards' device; an unsharded one
    comes back as it is."""
    layout = getattr(params, "layout", None)
    if layout is None:
        return params
    from chestxray_vit_tpu_torch.models.vit import ViT
    dev = next(params.parameters()).device
    full = ViT(params.cfg).to(dev)
    with torch.no_grad():
        for name, p in full.named_parameters():
            p.copy_(full_tensor(layout, name,
                                params.get_parameter(name)))
    return full
