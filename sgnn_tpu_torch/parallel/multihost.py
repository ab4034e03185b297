"""Several processes, each driving its part of the mesh.

Port of ``sgnn_tpu/parallel/multihost.py`` on ``torch.distributed``: where
``jax.distributed.initialize`` forms JAX's process group, ``initialize``
forms torch's (NCCL for CUDA, gloo for the CPU). A data-parallel step over
a mesh then spans the processes: each process feeds its slice of the
global batch (``host_batch_slice``, ``make_global_batch``), draws the
noise of the WHOLE global batch from the same seeded generator and keeps
its own rows, divides its masked sums by the global count, and the
gradients are summed across processes in rank order
(``all_gather_sum``), so that every process holds the same bits. Typical
flow, per process::

    from sgnn_tpu_torch.parallel import multihost
    multihost.initialize()                       # no-op for one process
    mesh = make_mesh(data=torch.cuda.device_count())
    batcher = SampleBatcher(..., seed=multihost.host_seed(base_seed))
    for batch in batcher.epochs():
        local = multihost.make_global_batch(batch, mesh)  # this process's rows
        metrics = dp_step(local, step)
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from sgnn_tpu_torch.data.prefetch import to_device
from sgnn_tpu_torch.utils.device import Device, resolve_device


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Device = None,
) -> None:
    """Form the process group. With no ``init_method`` and no rendezvous in
    the environment (``MASTER_ADDR``...), a no-op: one process. The backend
    is ``backend`` if given, else NCCL for a CUDA ``device`` (the default:
    CUDA unless ``device="cpu"``) and gloo for the CPU; a backend that fails
    raises, it is not swapped for another."""
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size or -1,
                            rank=-1 if rank is None else rank)


def distributed() -> bool:
    """A process group is formed (it may hold one process)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def host_seed(base_seed: int) -> int:
    """Deterministic per-process data-shuffling seed."""
    return base_seed * 1_000_003 + process_index()


def host_batch_slice(global_batch_size: int) -> int:
    """Per-process batch size for an evenly split global batch."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def make_global_batch(local_batch, mesh):
    """This process's slice of the global batch, staged on the mesh's
    primary device: what a data-parallel step over ``mesh`` takes (it knows
    the global batch from the process count: ``local rows x processes``,
    this process's rows starting at ``process_index() x local rows``)."""
    return to_device(local_batch, mesh.primary)


def all_gather_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the group's processes of ``t``, added in rank order, so
    that every process gets the same bits (a ring reduction adds in another
    order on each rank); ``t`` itself when no group is formed."""
    if not distributed():
        return t
    parts: List[torch.Tensor] = [torch.empty_like(t.reshape(-1)) for _ in range(process_count())]
    dist.all_gather(parts, t.reshape(-1).contiguous())
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.reshape(t.shape)


def shutdown() -> None:
    """Leave the process group, if one was formed."""
    if distributed():
        dist.destroy_process_group()
