"""The data-parallel layout of the port, ported from
``chestxray_vit_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` with ``data``, ``fsdp`` and
``tensor`` axes (and ``dcn`` across slices) and places parameters and
batches with shardings. The port keeps only the ``data`` axis, carried by
processes: one process per device (``parallel/distributed.py``), each with
a full replica of the parameters. So ``param_sharding``, ``replicated``,
``batch_sharding`` and ``shard_batch`` have no counterpart here:
parameters are replicated by construction, and each process loads and
places only its own slice of the batch. The ``fsdp``, ``tensor`` and
``dcn_data`` axes are refused (ROADMAP Queue 1 #12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from chestxray_vit_tpu_torch.config import MeshConfig
from chestxray_vit_tpu_torch.parallel import distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The data axis: how many processes share each global batch."""
    data: int = 1


def build_mesh(cfg: Optional[MeshConfig] = None,
               world: Optional[int] = None) -> Mesh:
    """The mesh of ``cfg`` over ``world`` processes (the process group's
    size by default). ``data = -1`` means the world size; any other data
    size must equal it, since one process drives one device."""
    cfg = cfg or MeshConfig()
    world = dist.world() if world is None else world
    if cfg.fsdp != 1 or cfg.tensor != 1 or cfg.dcn_data != 1:
        raise NotImplementedError(
            f"the fsdp, tensor and dcn_data mesh axes (fsdp={cfg.fsdp}, "
            f"tensor={cfg.tensor}, dcn_data={cfg.dcn_data}) are not ported "
            f"to PyTorch yet (ROADMAP Queue 1 #12: FSDP and TP axes); the "
            f"port is data-parallel only")
    data = world if cfg.data == -1 else cfg.data
    if data != world:
        raise NotImplementedError(
            f"a data axis of {data} over {world} process(es): the port runs "
            f"one process per device (start {data} with torchrun "
            f"--nproc_per_node {data}); one process driving several "
            f"devices is not ported to PyTorch yet (ROADMAP Queue 1 #8)")
    return Mesh(data=data)


def dp_size(mesh: Mesh) -> int:
    """Data-parallel world size."""
    return mesh.data


def local_batch_to_global(batch_size_per_core: int, mesh: Mesh) -> int:
    """The global batch: ``batch_size_per_core`` × the data-parallel
    world size."""
    return batch_size_per_core * dp_size(mesh)
