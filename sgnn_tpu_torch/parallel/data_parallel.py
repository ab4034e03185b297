"""Data-parallel training over a mesh's replicas.

Port of ``sgnn_tpu/parallel/data_parallel.py`` (``shard_batch``,
``make_dp_train_step``, ``shard_stacked_batch``,
``make_dp_train_multi_step``). JAX shards the batch axis over the mesh's
'data' axis and lets GSPMD insert the gradient all-reduce; here one step
(``DataParallelStep``, a ``TrainStep``) does the same by hand, with the
JAX step's math:

  * the loss is the masked mean over every particle of the GLOBAL batch:
    each replica divides its masked sum by the global count (a mean of
    per-replica means would be wrong whenever their counts differ);
  * the noise is drawn once for the global batch from the one generator
    (the single-device step's draw) and split with the batch, so a
    data-parallel step sees the same noise as a single-device step;
  * replica r runs forward and backward on its slice; its gradients are
    added onto the mesh's first device in replica order (a replica on
    that device accumulates into the primary's gradients directly, one on
    another device through a copy of the model, ``mesh.Replicas``); across
    processes (``multihost``) they are then summed in rank order; then one
    Adam step. No sum adds with float atomics, so two runs are equal bit
    for bit.

With every replica on one device and one process, the whole step (the
replicas' forwards and backwards, the sum, Adam) is one captured CUDA
graph; a mesh over several devices or processes runs the step eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from sgnn_tpu_torch.parallel import multihost
from sgnn_tpu_torch.parallel.mesh import Mesh, Replicas, shard_batch, shard_stacked_batch
from sgnn_tpu_torch.train.captured_train_step import Metrics, TrainStep, make_multi_step

__all__ = ["DataParallelStep", "make_dp_train_step", "make_dp_train_multi_step", "shard_batch",
           "shard_stacked_batch"]

LossFn = Callable[..., tuple]  # (batch, noise, denom) -> (loss, aux)
MakeLoss = Callable[[torch.nn.Module, torch.device], LossFn]


class DataParallelStep(TrainStep):
    """The step ``(batch, step, noise=None) -> metrics`` over ``mesh``'s
    replicas (see the module docstring). ``make_loss(module, device)``
    gives the loss ``(batch, noise, denom) -> (loss, aux)`` of one
    replica's model on its device, every aux metric a masked sum over
    ``denom``; ``batch`` is this
    process's part of the global batch on the mesh's first device."""

    def __init__(
        self,
        make_loss: MakeLoss,
        module: torch.nn.Module,
        mesh: Mesh,
        optimizer: torch.optim.Optimizer,
        sched: Callable[[int], float],
        noise_std: float,
        generator: Optional[torch.Generator] = None,
        *,
        capture: bool = True,
    ):
        super().__init__(None, optimizer, sched, noise_std, generator, capture=capture)
        self.mesh = mesh
        self.replicas = Replicas(module, mesh.data_devices)
        self.loss_fns = [make_loss(m, d) for m, d in zip(self.replicas.modules, mesh.data_devices)]
        self.capturable = mesh.one_device and not multihost.distributed()

    def noise_shape(self, batch) -> tuple:
        """The global batch's: every process draws it and keeps its rows."""
        shape = tuple(batch["positions"].shape)
        return (shape[0] * multihost.process_count(),) + shape[1:]

    def update(self, batch, noise: torch.Tensor) -> Metrics:
        rows = batch["positions"].shape[0]
        start = multihost.process_index() * rows
        noise = noise[start : start + rows]
        self.replicas.sync()
        self.replicas.zero_grad()
        primary = self.mesh.primary
        denom = multihost.all_gather_sum(batch["node_mask"].to(torch.float32).sum())
        denom = torch.clamp(denom, min=1.0)
        parts = shard_batch(self.mesh, {"batch": batch, "noise": noise})
        metrics: Dict[str, torch.Tensor] = {}
        for module, loss_fn, part in zip(self.replicas.modules, self.loss_fns, parts):
            noise_r = part["noise"]
            loss, aux = loss_fn(part["batch"], noise_r, denom.to(noise_r.device))
            loss.backward()
            self.replicas.fold(module)
            for name, value in {"train/loss": loss, **aux}.items():
                value = value.detach().to(primary)
                metrics[name] = value if name not in metrics else metrics[name] + value
        if multihost.distributed():
            self._sum_over_processes(metrics)
        self.optimizer.step()
        return metrics

    def _sum_over_processes(self, metrics: Metrics) -> None:
        """Gradients and metrics summed over the processes, in rank order."""
        params = [p for p in self.replicas.primary.parameters()]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = multihost.all_gather_sum(torch.cat([g.reshape(-1) for g in grads]))
        for p, g in zip(params, torch.split(flat, [g.numel() for g in grads])):
            p.grad = g.view_as(p).clone()
        names = sorted(metrics)
        summed = multihost.all_gather_sum(torch.stack([metrics[n].float() for n in names]))
        for i, name in enumerate(names):
            metrics[name] = summed[i]

    def close(self) -> None:
        super().close()
        self.replicas.zero_grad()


def make_dp_train_step(
    make_loss: MakeLoss,
    module: torch.nn.Module,
    mesh: Mesh,
    optimizer: torch.optim.Optimizer,
    sched: Callable[[int], float],
    noise_std: float,
    generator: Optional[torch.Generator] = None,
) -> DataParallelStep:
    """The data-parallel step of ``module`` over ``mesh`` (``DataParallelStep``)."""
    return DataParallelStep(make_loss, module, mesh, optimizer, sched, noise_std, generator)


def make_dp_train_multi_step(dp_step: DataParallelStep) -> Callable:
    """``(batches [T, B, ...], step, noise=None) -> metrics stacked [T]``:
    ``T`` data-parallel steps, each on its own batch (``make_multi_step``)."""
    return make_multi_step(dp_step)
