"""Device meshes, batch placement and replicated modules.

Port of ``sgnn_tpu/parallel/mesh.py`` (``make_mesh``, ``batch_sharding``,
``stacked_batch_sharding``, ``replicated``). JAX's mesh is a
``('data', 'graph')`` array of devices that one controller drives; here it
is the same array of ``torch.device``s, driven by one process: a shard or a
replica is a plain tensor on its device, and what JAX's shardings place,
``shard_batch``, ``shard_stacked_batch`` and ``Replicas`` place by hand.
A mesh may name one device several times, so that two shards or two
replicas sit on one card (or on the CPU in the tests) and exchange and
reduce for real; every step whose mesh holds one device is captured in one
CUDA graph. Across processes (``parallel/multihost.py``) a mesh is this
process's part of the global one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from sgnn_tpu_torch.data.prefetch import tree_map


@dataclass(frozen=True)
class Mesh:
    """A ``[data, graph]`` grid of devices (rows: replicas; columns: the
    shards of one graph)."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def data_devices(self) -> List[torch.device]:
        """One device per replica (the first shard's)."""
        return [row[0] for row in self.devices]

    @property
    def graph_devices(self) -> List[torch.device]:
        """One device per shard (the first replica's)."""
        return list(self.devices[0])

    @property
    def primary(self) -> torch.device:
        """The mesh's first device: it holds the parameters and Adam's
        state, and gradients are summed onto it."""
        return self.devices[0][0]

    @property
    def one_device(self) -> bool:
        """Every entry is the primary device: a step over the mesh can be
        captured in one CUDA graph."""
        return all(d == self.primary for row in self.devices for d in row)


def _concrete(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: int = 1, graph: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """A ``[data, graph]`` mesh over the first ``data * graph`` entries of
    ``devices``, which may repeat a device. Without ``devices``, that many
    distinct CUDA devices; raises if there are fewer (never the CPU)."""
    need = data * graph
    if need < 1:
        raise ValueError(f"a mesh needs at least one device, asked for {data} x {graph}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise ValueError(
                f"need {need} CUDA devices, have {have}; pass devices=[...] to place "
                "several shards or replicas on one device"
            )
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = [_concrete(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[r * graph : (r + 1) * graph]) for r in range(data)))


def _split(leaf: torch.Tensor, parts: int, axis: int) -> List[torch.Tensor]:
    if leaf.shape[axis] % parts:
        raise ValueError(f"axis {axis} of size {leaf.shape[axis]} does not split into {parts}")
    return list(torch.chunk(leaf, parts, dim=axis))


def split_tree(tree, parts: int, axis: int = 0) -> list:
    """``parts`` trees, each with an equal contiguous slice of every leaf's
    ``axis`` (views, on the leaves' device)."""
    return [tree_map(lambda t, i=i: _split(t, parts, axis)[i], tree) for i in range(parts)]


def shard_batch(mesh: Mesh, batch) -> list:
    """The batch's leading (batch) axis split over the replicas, each slice
    on its replica's device (``batch_sharding``). Leaves are tensors; the
    multi-scale batch's static graph stacks its leaves on the batch axis too."""
    return [tree_map(lambda t, d=d: t.to(d), part) for part, d in
            zip(split_tree(batch, len(mesh.data_devices)), mesh.data_devices)]


def shard_stacked_batch(mesh: Mesh, batches) -> list:
    """``shard_batch`` for time-stacked ``[T, B, ...]`` batches: axis 1
    (``stacked_batch_sharding``)."""
    return [tree_map(lambda t, d=d: t.to(d), part) for part, d in
            zip(split_tree(batches, len(mesh.data_devices), axis=1), mesh.data_devices)]


class Replicas:
    """One module per device of ``devices`` (``replicated``): the primary
    module itself on its own device, one copy on each other device. Each
    step calls ``sync`` (the copies take the primary's parameters, in place,
    so that a captured graph keeps their addresses) and, after a backward
    through a copy, ``fold`` (its gradients added onto the primary's)."""

    def __init__(self, module: torch.nn.Module, devices: Sequence[torch.device]):
        primary = next(module.parameters()).device
        copies = {}
        for d in devices:
            if d != primary and d not in copies:
                copies[d] = copy.deepcopy(module).to(d)
        self.primary = module
        self.modules = [module if d == primary else copies[d] for d in devices]
        self.copies = list(copies.values())

    @torch.no_grad()
    def sync(self) -> None:
        for c in self.copies:
            for dst, src in zip(c.parameters(), self.primary.parameters()):
                dst.copy_(src)

    def zero_grad(self) -> None:
        for m in (self.primary, *self.copies):
            m.zero_grad(set_to_none=True)

    @torch.no_grad()
    def fold(self, module: torch.nn.Module) -> None:
        """Add ``module``'s gradients onto the primary's and clear them (a
        no-op for the primary itself)."""
        if module is self.primary:
            return
        for dst, src in zip(self.primary.parameters(), module.parameters()):
            if src.grad is not None:
                g = src.grad.to(dst.device)
                dst.grad = g if dst.grad is None else dst.grad.add_(g)
                src.grad = None
