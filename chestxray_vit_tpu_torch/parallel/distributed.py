"""Multi-process data parallelism on ``torch.distributed``, ported from
``chestxray_vit_tpu/parallel/distributed.py``.

The JAX package runs one process per host over a global device mesh and
lets XLA derive the gradient all-reduce from the shardings. The port runs
one process per device (``torchrun --nproc_per_node N``), each holding a
full replica of the parameters and its own slice of every global batch,
and sums the gradients itself (:func:`all_reduce_grads`) after the
backward and before the clip: distributed data parallelism (DDP) written
out, without ``torch.nn.parallel.DistributedDataParallel``'s bucketing,
so that the packed step can sum its loss's numerator and denominator in
the same collective.

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


def _comm_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL."""
    if td.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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
                     device=_comm_device())
    td.all_reduce(t, op=td.ReduceOp.MAX)
    return bool(t.item())


def host_shard_range(n: int) -> range:
    """The contiguous slice of a global batch of ``n`` this process
    loads."""
    per = n // world()
    start = rank() * per
    return range(start, start + per)


def host_batch_slice(global_batch: int) -> Optional[tuple]:
    """(start, stop) of the global batch this process loads, or None in a
    world of one (load everything); feeds
    ``pipeline.iterate_batches(host_range=...)``, so each process decodes
    only its slice."""
    if world() == 1:
        return None
    r = host_shard_range(global_batch)
    return (r.start, r.stop)


def process_allgather(x) -> np.ndarray:
    """Concatenate every process's row block of ``x`` (a tensor or an
    array; the blocks have equal shapes) in rank order, as a host array on
    every process. The identity without a group."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    if is_initialized():
        t = t.to(_comm_device()).contiguous()
        parts = [torch.empty_like(t) for _ in range(world())]
        td.all_gather(parts, t)
        t = torch.cat(parts)
    return t.cpu().numpy()


def neighbour_last_row(*rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The previous rank's ``rows`` (rank 0 gets the last rank's, as a roll
    wraps): mixup's partner of a rank's first row is the last row of the
    previous rank's slice of the global micro-batch. One ``all_gather`` of
    the tensors packed flat in f32 (exact for f32 and bf16 pixels and for
    labels); every rank's tensors must have the same shapes. The identity
    without a group. Nothing flows back: the pixels are no parameters, so
    the backward needs no collective."""
    if not is_initialized():
        return rows
    dev = _comm_device()
    flat = torch.cat([r.detach().reshape(-1).to(dev, torch.float32)
                      for r in rows])
    parts = [torch.empty_like(flat) for _ in range(world())]
    td.all_gather(parts, flat)
    prev = parts[(rank() - 1) % world()]
    out, offset = [], 0
    for r in rows:
        out.append(prev[offset:offset + r.numel()].view(r.shape)
                   .to(r.device, r.dtype))
        offset += r.numel()
    return tuple(out)


def all_reduce_grads(params, *scalars: torch.Tensor, average: bool = False
                     ) -> Sequence[torch.Tensor]:
    """Sum every parameter's ``.grad`` and the 0-d ``scalars`` over the
    group, in ONE ``all_reduce`` of a flat f32 buffer laid out in the
    parameters' fixed order (the scalars last); ``average`` then divides
    all of it by the world size. Returns the reduced scalars. Without a
    group the gradients stay as they are and the scalars come back
    unchanged. A parameter without a gradient is an error: every rank must
    contribute the same leaves."""
    if not is_initialized():
        return scalars
    grads = [p.grad for p in params.parameters()]
    if any(g is None for g in grads):
        raise ValueError("all_reduce_grads: a parameter has no gradient")
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [s.reshape(1).float() for s in scalars])
    td.all_reduce(flat)
    n = world()
    if average and n > 1:
        flat.div_(n)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return [flat[offset + i].reshape(()).to(s.dtype)
            for i, s in enumerate(scalars)]
