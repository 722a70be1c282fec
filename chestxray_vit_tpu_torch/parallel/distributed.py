"""Multi-process data parallelism on ``torch.distributed``, ported from
``chestxray_vit_tpu/parallel/distributed.py``.

The JAX package runs one process per host over a global device mesh and
lets XLA derive the gradient all-reduce from the shardings. The port runs
one process per device (``torchrun --nproc_per_node N``), each holding its
slice of every global batch, and sums the gradients itself
(:func:`all_reduce_grads`) after the backward and before the clip:
distributed data parallelism (DDP) written out, without
``torch.nn.parallel.DistributedDataParallel``'s bucketing, so that the
packed step can sum its loss's numerator and denominator in the same
collective. On a mesh with ``fsdp`` or ``tensor`` axes
(``parallel/mesh.py``) the batch is split over the batch group only (dcn ×
data × fsdp): a rank's rows are those of its ``Mesh.dp_index``, and the
gathers, the mixup neighbour and the gradient sums run over that group.

Names follow the JAX module so a reader finds each counterpart:
``rank()`` / ``world()`` are ``jax.process_index()`` /
``jax.process_count()``. ``form_global_batch`` has no counterpart: under
DDP there is no global array, and each rank's slice is its batch, placed
on its own device by ``data.pipeline.to_device``. The JAX package's three
gathers (``process_allgather``, ``gather_global_rows`` and
``allgather_host_rows``) are one operation here, :func:`process_allgather`:
an ``all_gather`` of equal-size row blocks, concatenated in rank order.
:func:`neighbour_last_row` has no counterpart either: the JAX step rolls
the global micro-batch, which carries one row across each shard boundary
(a ``ppermute``); here each rank asks for the previous rank's last row.

Everything degrades to the identity without a process group, so the same
trainer code runs in one process; with a group of one process the
collectives still run (the card's NCCL path at a world of one).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as td

# a collective that waits longer than this has lost a peer
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> torch.device:
    """Join a process group when one is configured and return the device
    this process drives.

    A group is configured by the arguments (``coordinator_address`` as
    ``tcp://host:port``, with the world size and this process's rank) or
    by the environment ``torchrun`` sets (``WORLD_SIZE`` > 1 with
    ``MASTER_ADDR`` and ``MASTER_PORT``). The backend is NCCL for a
    ``cuda`` device and gloo for the CPU; a ``cuda`` process drives
    ``cuda:LOCAL_RANK`` (else its rank modulo the local cards). A
    configured group that cannot be joined raises: the process never
    carries on alone. Without a configured group nothing is joined; an
    environment that names a world size but no address says so once.
    Calling it again in a joined process changes nothing."""
    device = torch.device(device)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    from_env = (env_world > 1 and bool(os.environ.get("MASTER_ADDR"))
                and bool(os.environ.get("MASTER_PORT")))
    if not coordinator_address and not from_env:
        if env_world > 1:
            print(f"[distributed] single-process mode (WORLD_SIZE="
                  f"{env_world} without MASTER_ADDR / MASTER_PORT)")
        return device
    if device.type == "cuda":
        rank_ = (process_id if coordinator_address
                 else int(os.environ.get("RANK", "0")))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank_ % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address:
        td.init_process_group(backend, init_method=coordinator_address,
                              world_size=num_processes, rank=process_id,
                              timeout=TIMEOUT)
    else:
        td.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return device


def is_initialized() -> bool:
    return td.is_available() and td.is_initialized()


def rank() -> int:
    """This process's index in the group (0 without one)."""
    return td.get_rank() if is_initialized() else 0


def world() -> int:
    """The number of processes in the group (1 without one)."""
    return td.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """The 'rank 0 only' gate: saves, results files, TensorBoard."""
    return rank() == 0


def comm_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    host under gloo (a gloo group of ranks on one card stages through
    it)."""
    if td.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it and the process group of the ranks that differ only there (None:
    the whole group). The collectives run in the tensor's own dtype as
    given (f32; int32 for the int8 row partials, whose sums are exact in
    any order), staged through the host under gloo (the copy keeps the
    dtype), and are the identity on an axis of one."""
    size: int = 1
    index: int = 0
    group: Optional[object] = field(default=None, repr=False)

    def _run(self, fn, x: torch.Tensor, copy: bool = False) -> torch.Tensor:
        t = x.to(comm_device()).contiguous()
        if copy and t.data_ptr() == x.data_ptr():
            t = t.clone()
        return fn(t).to(x.device)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op`` "sum") or the elementwise max ("max") of ``x``
        over the axis, on every rank of it (``x`` is left as it is)."""
        if self.size == 1:
            return x
        reduce_op = {"sum": td.ReduceOp.SUM, "max": td.ReduceOp.MAX}[op]

        def fn(t):
            td.all_reduce(t, op=reduce_op, group=self.group)
            return t
        return self._run(fn, x, copy=True)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The axis's blocks of ``x`` concatenated along ``dim`` in axis
        order (one ``all_gather_into_tensor``)."""
        if self.size == 1:
            return x

        def fn(t):
            t = t.movedim(dim, 0).contiguous()
            out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
            td.all_gather_into_tensor(out, t, group=self.group)
            return out.movedim(0, dim).contiguous()
        return self._run(fn, x)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``x`` over the axis
        (one ``reduce_scatter_tensor``)."""
        if self.size == 1:
            return x

        def fn(t):
            t = t.movedim(dim, 0).contiguous()
            out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
            td.reduce_scatter_tensor(out, t, group=self.group)
            return out.movedim(0, dim).contiguous()
        return self._run(fn, x)

    def all_gather_rows(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (equal shapes), in axis order."""
        if self.size == 1:
            return [x]
        dev = comm_device()
        t = x.to(dev).contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        td.all_gather(parts, t, group=self.group)
        return [p.to(x.device) for p in parts]


def barrier(name: str = "barrier") -> None:
    """Every process waits here for the others (no-op without a group);
    ``name`` says what is waited for, in a hang's traceback."""
    if is_initialized():
        td.barrier()


def agree_flag(flag: bool) -> bool:
    """Logical OR of a per-process flag over the group (an ``all_reduce``
    MAX; the identity without one). The preemption stop is agreed this
    way, so every process saves at the same step."""
    if not is_initialized():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=comm_device())
    td.all_reduce(t, op=td.ReduceOp.MAX)
    return bool(t.item())


def host_shard_range(n: int) -> range:
    """The contiguous slice of a global batch of ``n`` this process
    loads."""
    per = n // world()
    start = rank() * per
    return range(start, start + per)


def host_batch_slice(global_batch: int, mesh=None) -> Optional[tuple]:
    """(start, stop) of the global batch this process loads, or None when
    one process loads all of it; feeds
    ``pipeline.iterate_batches(host_range=...)``, so each process decodes
    only its slice. On ``mesh`` the slice is that of its ``dp_index`` of
    ``dp_size`` (the tensor ranks of one slot load the same rows), else of
    this rank of the group."""
    if mesh is None:
        slot, slots = rank(), world()
    else:
        slot, slots = mesh.dp_index, mesh.dcn * mesh.data * mesh.fsdp
    if slots == 1:
        return None
    per = global_batch // slots
    return (slot * per, slot * per + per)


def world_axis() -> Axis:
    """The whole group as one axis (one process without a group)."""
    return Axis(world(), rank()) if is_initialized() else Axis()


def process_allgather(x, axis: Optional[Axis] = None) -> np.ndarray:
    """Concatenate every process's row block of ``x`` (a tensor or an
    array; the blocks have equal shapes) in rank order, as a host array on
    every process: over the whole group, or over ``axis`` (e.g. a mesh's
    batch group) in its order. The identity without a group."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    return torch.cat((axis or world_axis()).all_gather_rows(t)).cpu().numpy()


def neighbour_last_row(*rows: torch.Tensor, axis: Optional[Axis] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The previous rank's ``rows`` (rank 0 gets the last rank's, as a roll
    wraps): mixup's partner of a rank's first row is the last row of the
    previous rank's slice of the global micro-batch. Over ``axis`` (a
    mesh's batch group, whose order is the batch's) or the whole group.
    One ``all_gather`` of the tensors packed flat in f32 (exact for f32
    and bf16 pixels and for labels); every rank's tensors must have the
    same shapes. The identity on one process. Nothing flows back: the
    pixels are no parameters, so the backward needs no collective."""
    axis = axis or world_axis()
    if axis.size == 1:
        return rows
    flat = torch.cat([r.detach().reshape(-1).float() for r in rows])
    prev = axis.all_gather_rows(flat)[(axis.index - 1) % axis.size]
    out, offset = [], 0
    for r in rows:
        out.append(prev[offset:offset + r.numel()].view(r.shape)
                   .to(r.device, r.dtype))
        offset += r.numel()
    return tuple(out)


def all_reduce_grads(params, *scalars: torch.Tensor, average: bool = False,
                     mesh=None) -> Sequence[torch.Tensor]:
    """Sum every parameter's ``.grad`` and the 0-d ``scalars`` over the
    ranks that hold the same parameters on other rows, in ONE ``all_reduce``
    of a flat f32 buffer laid out in the parameters' fixed order (the
    scalars last); ``average`` then divides all of it by the number of
    batch slices. Without a mesh (or on a data-only one) that is the whole
    group. On ``mesh`` (by default that of ``params.layout``, a sharded
    model's) it is the batch group (dcn × data × fsdp at this rank's tensor
    index: a tensor shard's gradient is its own); an fsdp-sharded leaf's
    gradient, already reduce-scattered over ``fsdp`` in the backward
    (``parallel/fsdp.py``), is summed over the replica group (dcn × data)
    in a second buffer. Returns the reduced scalars. Without a group the
    gradients stay as they are and the scalars come back unchanged. A
    parameter without a gradient is an error: every rank must contribute
    the same leaves."""
    if not is_initialized():
        return scalars
    layout = getattr(params, "layout", None)
    if mesh is None and layout is not None:
        mesh = layout.mesh
    if mesh is not None and not mesh.sharded:
        mesh = None             # the batch group is the whole group
    named = list(params.named_parameters())
    if any(p.grad is None for _, p in named):
        raise ValueError("all_reduce_grads: a parameter has no gradient")
    if mesh is None:
        buckets = [(None, [p.grad for _, p in named], scalars)]
        n = world()
    else:
        split = layout is not None and mesh.fsdp > 1
        sharded = [split and layout.of(name)[0] is not None
                   for name, _ in named]
        buckets = [(mesh.axis("batch"),
                    [p.grad for (_, p), sh in zip(named, sharded) if not sh],
                    scalars),
                   (mesh.axis("replica"),
                    [p.grad for (_, p), sh in zip(named, sharded) if sh],
                    ())]
        n = mesh.dcn * mesh.data * mesh.fsdp
    out = []
    for axis, grads, scal in buckets:
        if not grads and not scal:
            continue
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [s.reshape(1).float() for s in scal])
        if axis is None:
            td.all_reduce(flat)
        else:
            flat = axis.all_reduce(flat)
        if average and n > 1:
            flat.div_(n)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        out += [flat[offset + i].reshape(()).to(s.dtype)
                for i, s in enumerate(scal)]
    return out
