"""The device mesh of the port, ported from
``chestxray_vit_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` over every device with the
axes ``data``, ``fsdp`` and ``tensor`` (and ``dcn`` across slices), places
parameters and batches with shardings and lets XLA derive the collectives.
The port runs one process per device (``parallel/distributed.py``) and
lays the same mesh over the processes: rank r sits at the coordinates of
``reshape(dcn, data, fsdp, tensor)``, the tensor axis innermost, as the
JAX device order puts it. The collectives XLA would derive are written out
over process subgroups that :func:`build_mesh` creates once:

- the batch is split over ``dcn`` × ``data`` × ``fsdp`` (:func:`dp_axes`):
  a rank's slot in the global batch is :attr:`Mesh.dp_index`, and the
  tensor ranks of one slot share their rows;
- ``fsdp`` shards parameters ZeRO-3 style (``parallel/fsdp.py``: gathered
  at use, gradients reduce-scattered);
- ``tensor`` splits each block Megatron style (``parallel/tensor.py``).

:func:`param_layout` is ``param_sharding``'s rule applied to the port's
per-layer parameters. ``batch_sharding``, ``replicated`` and
``shard_batch`` have no counterpart: each process loads and places only
its own rows (``distributed.host_batch_slice``).

The mesh's shape follows the JAX ``build_mesh``'s rule over the devices
(:func:`mesh_shape`): ``data = -1`` takes what the fixed axes leave, and a
shape that does not tile the devices raises. A process outside a group
that is given several devices starts one rank a device
(``parallel/launch.py``), so the JAX package's one process over every
device becomes one rank a device here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as td
from torch import nn

from chestxray_vit_tpu_torch.config import MeshConfig
from chestxray_vit_tpu_torch.parallel import distributed as dist
from chestxray_vit_tpu_torch.parallel.distributed import Axis

# Megatron placement (``param_sharding``): the column-parallel products
# split their output dim, the row-parallel ones their input dim
TP_COL = ("wq", "wk", "wv", "mlp_in")
TP_ROW = ("wo", "mlp_out")


@dataclass(frozen=True)
class Mesh:
    """The (dcn, data, fsdp, tensor) mesh over the processes and this
    rank's place on it."""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    dcn: int = 1
    rank: int = 0
    # the subgroups, by name: the four axes, "batch" (dcn × data × fsdp at
    # this rank's tensor index) and "replica" (dcn × data at its fsdp and
    # tensor indices)
    groups: Dict[str, object] = field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def world(self) -> int:
        return self.dcn * self.data * self.fsdp * self.tensor

    @property
    def coords(self) -> Tuple[int, int, int, int]:
        """This rank's (dcn, data, fsdp, tensor) indices."""
        r = self.rank
        r, t = divmod(r, self.tensor)
        r, f = divmod(r, self.fsdp)
        c, d = divmod(r, self.data)
        return c, d, f, t

    @property
    def dp_index(self) -> int:
        """This rank's slot in the global batch (dcn-major, then data,
        then fsdp, as ``batch_sharding`` splits it); the tensor ranks of one
        slot share it."""
        return self.rank // self.tensor

    @property
    def sharded(self) -> bool:
        """Whether parameters are split at all (fsdp or tensor > 1)."""
        return self.fsdp > 1 or self.tensor > 1

    def axis(self, name: str) -> Axis:
        """The axis ``name`` (dcn, data, fsdp, tensor, "batch" or
        "replica") as this rank sees it."""
        c, d, f, t = self.coords
        size, index = {
            "dcn": (self.dcn, c), "data": (self.data, d),
            "fsdp": (self.fsdp, f), "tensor": (self.tensor, t),
            "batch": (dp_size(self), self.dp_index),
            "replica": (self.dcn * self.data, c * self.data + d)}[name]
        if size > 1 and name not in self.groups and size != self.world:
            raise RuntimeError(
                f"the {name} axis of {size} needs a process group: call "
                f"distributed.initialize before build_mesh")
        return Axis(size, index, self.groups.get(name))


def _partitions(dcn: int, data: int, fsdp: int, tensor: int) -> dict:
    """Each subgroup kind as its list of rank lists (every rank in one)."""
    def rank(c, d, f, t):
        return ((c * data + d) * fsdp + f) * tensor + t
    idx = [(c, d, f, t) for c in range(dcn) for d in range(data)
           for f in range(fsdp) for t in range(tensor)]

    def by(key):
        out: Dict[tuple, list] = {}
        for co in idx:
            out.setdefault(key(*co), []).append(rank(*co))
        return [sorted(v) for _, v in sorted(out.items())]
    return {"dcn": by(lambda c, d, f, t: (d, f, t)),
            "data": by(lambda c, d, f, t: (c, f, t)),
            "fsdp": by(lambda c, d, f, t: (c, d, t)),
            "tensor": by(lambda c, d, f, t: (c, d, f)),
            "batch": by(lambda c, d, f, t: (t,)),
            "replica": by(lambda c, d, f, t: (f, t))}


_GROUP_CACHE: Dict[tuple, Dict[str, object]] = {}


def _groups(dcn: int, data: int, fsdp: int, tensor: int
            ) -> Dict[str, object]:
    """This rank's subgroup of each kind that is neither one rank nor the
    whole group, created once per group and mesh shape (every rank creates
    every group, in one order)."""
    if not dist.is_initialized():
        return {}
    key = (id(td.group.WORLD), dcn, data, fsdp, tensor)
    if key not in _GROUP_CACHE:
        world = dcn * data * fsdp * tensor
        me = td.get_rank()
        mine = {}
        for name, parts in _partitions(dcn, data, fsdp, tensor).items():
            if len(parts[0]) in (1, world):
                continue
            for ranks in parts:
                g = td.new_group(ranks)
                if me in ranks:
                    mine[name] = g
        _GROUP_CACHE[key] = mine
    return _GROUP_CACHE[key]


def mesh_shape(cfg: Optional[MeshConfig], devices: Union[int, Sequence]
               ) -> Tuple[int, int, int, int]:
    """(dcn, data, fsdp, tensor) of ``cfg`` over ``devices`` (a sequence,
    or their number), by the JAX ``build_mesh``'s rule
    (``chestxray_vit_tpu/parallel/mesh.py``) over n devices: ``data = -1``
    takes ``n // (dcn · fsdp · tensor)``, and a shape whose product is not
    ``n`` raises ``ValueError("mesh AxBxC != n devices")``."""
    cfg = cfg or MeshConfig()
    n = devices if isinstance(devices, int) else len(devices)
    dcn = max(cfg.dcn_data, 1)
    fixed = cfg.fsdp * cfg.tensor
    data = cfg.data if cfg.data != -1 else n // (fixed * dcn)
    if dcn * data * fixed != n:
        raise ValueError(
            f"mesh {'%dx' % dcn if dcn > 1 else ''}{data}x{cfg.fsdp}"
            f"x{cfg.tensor} != {n} devices")
    return dcn, data, cfg.fsdp, cfg.tensor


def build_mesh(cfg: Optional[MeshConfig] = None,
               world: Optional[int] = None,
               rank: Optional[int] = None) -> Mesh:
    """The mesh of ``cfg`` over ``world`` ranks, one device each (the
    process group's size by default), seen from ``rank`` (the group's
    rank by default), shaped by :func:`mesh_shape`. A group that does not
    tile the mesh raises its ``ValueError``. In a process group the
    subgroups are created here, by every rank."""
    world = dist.world() if world is None else world
    rank = dist.rank() if rank is None else rank
    try:
        dcn, data, fsdp, tensor = mesh_shape(cfg, world)
    except ValueError as e:
        raise ValueError(
            f"{e}: the group's processes drive one device each ({world} in "
            f"all); a process outside a group trains on several devices by "
            f"starting one rank a device (Trainer(cfg, device=[...]), or "
            f"device='cuda' for every card)") from None
    groups = (_groups(dcn, data, fsdp, tensor)
              if world == dist.world() else {})
    return Mesh(data=data, fsdp=fsdp, tensor=tensor, dcn=dcn, rank=rank,
                groups=groups)


def dp_axes(mesh: Mesh) -> tuple:
    """Mesh axes the global batch is split over (in mesh order)."""
    return ("dcn", "data", "fsdp") if mesh.dcn > 1 else ("data", "fsdp")


def dp_size(mesh: Mesh) -> int:
    """Data-parallel world size: the product of the batch-carrying
    axes."""
    return mesh.dcn * mesh.data * mesh.fsdp


def local_batch_to_global(batch_size_per_core: int, mesh: Mesh) -> int:
    """The global batch: ``batch_size_per_core`` × the data-parallel
    world size."""
    return batch_size_per_core * dp_size(mesh)


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

Dims = Tuple[Optional[int], Optional[int]]


@dataclass(eq=False)
class Layout:
    """Where each parameter of a model is split: by name, its ``fsdp`` dim
    and its ``tensor`` dim (None where it is whole), with the full shapes.
    A sharded ``ViT`` carries its layout as ``params.layout``."""
    mesh: Mesh
    dims: Dict[str, Dims]
    shapes: Dict[str, Tuple[int, ...]]

    def of(self, name: str) -> Dims:
        """The dims of ``name``; a block leaf's by its name in block 0 (the
        layers are laid out alike)."""
        parts = name.split(".")
        if parts[0] == "blocks":
            name = ".".join(["blocks", "0", *parts[2:]])
        return self.dims[name]


def leaf_dims(name: str, shape: Tuple[int, ...], fsdp: int,
              tensor: int) -> Dims:
    """``param_sharding``'s rule for one port parameter: (fsdp dim, tensor
    dim) in the port's shape. A block leaf is one layer of the JAX
    package's scanned ``[L, ...]`` leaf, so JAX's dim i is its dim i − 1;
    JAX never shards dim 0 of a leaf."""
    parts = name.split(".")
    block = parts[0] == "blocks"
    keys = parts[2:] if block else parts
    jshape = ((0,) if block else ()) + tuple(shape)
    nd = len(jshape)
    dims: list = [None] * nd
    owner = next((k for k in keys if k in TP_COL + TP_ROW), None)
    if tensor > 1 and nd == 3 and "kernel" in keys:
        if owner in TP_COL and jshape[2] % tensor == 0:
            dims[2] = "tensor"
        elif owner in TP_ROW and jshape[1] % tensor == 0:
            dims[1] = "tensor"
    if tensor > 1 and nd == 2 and "bias" in keys:
        if owner in TP_COL and jshape[1] % tensor == 0:
            dims[1] = "tensor"
    if fsdp > 1 and nd >= 2:
        order = sorted(range(1, nd), key=lambda i: jshape[i], reverse=True)
        for i in order:
            if dims[i] is None and jshape[i] % fsdp == 0:
                dims[i] = "fsdp"
                break
    off = 1 if block else 0
    fd = next((i - off for i, a in enumerate(dims) if a == "fsdp"), None)
    tdim = next((i - off for i, a in enumerate(dims) if a == "tensor"), None)
    return fd, tdim


def param_layout(mesh: Mesh, params: nn.Module) -> Layout:
    """The layout of ``params`` (a full, unsharded ``ViT``) on ``mesh``:
    ``param_sharding``'s rule leaf for leaf (:func:`leaf_dims`). Tensor
    parallelism needs whole heads and whole MLP columns on every rank: a
    tensor size that does not divide the heads and the MLP width is
    refused (ROADMAP Queue 1 #15)."""
    cfg = getattr(params, "cfg", None)
    if mesh.tensor > 1 and cfg is not None and (
            cfg.num_heads % mesh.tensor or cfg.mlp_dim % mesh.tensor):
        raise NotImplementedError(
            f"tensor={mesh.tensor} over {cfg.num_heads} heads and an MLP "
            f"of {cfg.mlp_dim}: the port splits whole heads and columns "
            f"only (ROADMAP Queue 1 #15)")
    dims, shapes = {}, {}
    for name, p in params.named_parameters():
        shapes[name] = tuple(p.shape)
        dims[name] = leaf_dims(name, tuple(p.shape), mesh.fsdp, mesh.tensor)
    return Layout(mesh, dims, shapes)
