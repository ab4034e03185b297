"""The multi-scale family and its entry point.

Port of ``sgnn_tpu/train/train_multi_scale.py`` (single device): the
family ``MULTI_SCALE`` that the one trainer (``train/train.py``) runs, and
its ``build_training``, ``make_train_step``, ``train``, ``predict`` and
CLI, which pass it::

  python -m sgnn_tpu_torch.train.train_multi_scale --config configs/taylor2d_multi_scale.yaml \\
      --mode train|valid|rollout [--model_file NAME] [--device cuda|cpu]

The family: ``ms_config_from``; the loss of the batched forward over the
batch's per-sample static graphs flattened into one
(``ms_forward_batched``: every latent-row gather is the row-gather kernel,
its backward the sorted segment sum or the transpose plan's kernel); the
training batcher and the split loader (``make_loader``) with their static
graphs in the layout ``ms_dense`` picks (``"auto"``, True or False); the
rollout ``ms_rollout`` with the loader item's static graph
(``_rollout_fn``), scored by its PER-STEP RMSE (total, position and strain
at the last step, one_step at the first) plus the rollouts' mean_time and
std_time, as the JAX multi-scale evaluator.

``data_parallel: P`` trains over P replicas (``sgnn_tpu/train/
train_multi_scale.py:356-381``; ``parallel/data_parallel.DataParallelStep``
over the mesh of ``devices``, which may name one device several times):
each replica flattens its own samples' static graphs
(``ms_forward_batched``) and divides its masked sums by the global batch's
count. ``graph_parallel: P`` (with ``batch_size: 1``, and not with
``data_parallel``; ``sgnn_tpu/train/train_multi_scale.py:382-451``) plans
one exact slab partition per training trajectory with one set of shapes
(``parallel/ms_partition.ms_dataset_partition``; the dense layout only for
``ms_dense: True``), keeps each trajectory's sharded graph on the card,
x-sorts each sample into its trajectory's plan (``ms_partition_sample``)
and trains with ``MSPartitionedTrainStep`` (one halo exchange per
interaction block); the validation rolls out partitioned
(``make_ms_partitioned_host_rollout``). ``predict`` ignores both, as JAX's.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from sgnn_tpu_torch.data.prefetch import to_device
from sgnn_tpu_torch.data.static_graph_loader import MultiScaleSampleBatcher, MultiScaleTrajectoryLoader
from sgnn_tpu_torch.parallel.edge_partition import PartitionSpec1D
from sgnn_tpu_torch.parallel.mesh import Mesh
from sgnn_tpu_torch.parallel.ms_partition import (
    MSPartitionedTrainStep,
    make_ms_partitioned_rollout,
    ms_dataset_partition,
    ms_partition_sample,
    pinned_plans,
    plan_ms_partition,
    sharded_graph_to,
)
from sgnn_tpu_torch.physics.multi_scale_graph import DenseStaticGraph, StaticGraph
from sgnn_tpu_torch.physics.multi_scale_simulator import (
    MultiScaleSimulator,
    MultiScaleSimulatorConfig,
    graph_to,
    ms_predict_accelerations_batched,
    ms_rollout,
    multi_scale_simulator_init,
)
from sgnn_tpu_torch.physics.simulator import NormStats
from sgnn_tpu_torch.train import train as trainer
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.train.train import Family, Training, lr_schedule


def ms_config_from(cfg: TrainConfig, metadata: dict) -> MultiScaleSimulatorConfig:
    return MultiScaleSimulatorConfig(
        dim=cfg.dim,
        latent_dim=cfg.hidden_dim,
        num_message_passing_steps=cfg.layers,
        num_mlp_layers=2,  # reference multi-scale
        input_sequence_length=cfg.input_sequence_length,
        num_particle_types=int(metadata.get("num_particle_types", 1)),
        particle_type_embedding_size=cfg.particle_type_embedding_size,
        num_scales=cfg.num_scales,
        window_size=cfg.window_size,
        radius_multiplier=cfg.radius_multiplier,
        compute_dtype=cfg.compute_dtype,
    )


def batch_to_device(batch: Dict[str, object], device: torch.device) -> Dict[str, object]:
    """A host batch on ``device``: its arrays as tensors, its stacked graph
    as the same graph of tensors (a graph-parallel sample's sharded graph
    too)."""
    return {k: graph_to(v, device) if isinstance(v, (StaticGraph, DenseStaticGraph)) else to_device(v, device)
            for k, v in batch.items()}


def make_loss_fn(sim: MultiScaleSimulator, sim_cfg: MultiScaleSimulatorConfig, stats: NormStats,
                 cfg: TrainConfig) -> Callable:
    """The loss ``(batch, noise, denom=None) -> (loss, aux)`` of ``sim`` on a
    batch with its stacked graph: masked sums over ``denom`` (default: the
    batch's masked count; a data-parallel replica gets the global one)."""

    def loss_fn(batch, noise, denom=None):
        pred_acc, target_acc, pred_strain = ms_predict_accelerations_batched(
            sim, sim_cfg, stats, batch["next_position"], noise, batch["positions"], batch["particle_type"],
            batch["graph"],
        )
        mask = batch["node_mask"].to(pred_acc.dtype)  # [B, N]
        if denom is None:
            denom = torch.clamp(mask.sum(), min=1.0)
        loss_pos = ((pred_acc - target_acc) ** 2).sum(dim=-1)
        loss_strain = (pred_strain - batch["next_strain"]) ** 2
        loss = cfg.loss_weight_position * loss_pos + cfg.loss_weight_strain * loss_strain
        aux = {
            "train/loss-position": (loss_pos * mask).sum() / denom,
            "train/loss-strain": (loss_strain * mask).sum() / denom,
        }
        return (loss * mask).sum() / denom, aux

    return loss_fn


def _dense_row_advantage(cfg: TrainConfig) -> float:
    # the JAX trainer's rule: bf16 halves the dense layout's edge traffic,
    # so dense is taken up to twice the slot padding
    return 4.0 if cfg.compute_dtype == "bfloat16" else 2.0


@dataclass
class MSPartitionedTraining(Training):
    """``Training`` of a graph-parallel multi-scale run: each training
    trajectory's plan order and sharded graph (on the mesh's first device)."""

    orders: list = field(default_factory=list)
    graphs: list = field(default_factory=list)

    def epochs(self):
        """The training samples, endlessly, each x-sorted into its
        trajectory's plan with that trajectory's sharded graph attached."""
        for b in self.batcher.epochs():
            ti = int(b["traj_idx"][0])
            out = ms_partition_sample(b, self.spec, self.orders[ti])
            out["graph"] = self.graphs[ti]
            yield out

    def validation_rollout(self, family: Family, cfg: TrainConfig, loader, device: torch.device) -> Callable:
        """The host rollout pinned to the training spec, every validation
        trajectory planned up front (``make_ms_partitioned_host_rollout``)."""
        print(f"ms graph-parallel: {cfg.graph_parallel} shards x {self.spec.nodes_per_shard} nodes "
              f"(halo {self.spec.halo})")
        return make_ms_partitioned_host_rollout(self.mesh, self.sim_cfg, self.stats, self.spec, cfg.inference_mode,
                                                frames=[pos[0] for pos, _, _ in loader.trajectories])


def _partitioned_training(cfg: TrainConfig, sim, sim_cfg: MultiScaleSimulatorConfig, stats: NormStats, optimizer,
                          noise_gen, mesh: Mesh, batch_size: int) -> MSPartitionedTraining:
    """The multi-scale graph-parallel wiring: a plain batcher, one partition
    plan per training trajectory (the plans replace the batcher's static
    graphs), ``MSPartitionedTrainStep``."""
    batcher = trainer.sample_batcher(cfg, sim_cfg, batch_size)
    # ms_dense: True partitions the dense layout; "auto" and False stay COO
    spec, plans = ms_dataset_partition(sim_cfg.graph_config, [pos[0] for pos, _, _ in batcher.trajectories],
                                       cfg.graph_parallel, layout="dense" if cfg.ms_dense is True else "coo")
    step_fn = MSPartitionedTrainStep(mesh, sim_cfg, stats, spec, sim, optimizer, lr_schedule(cfg), cfg.noise_std,
                                     noise_gen, loss_weight_position=cfg.loss_weight_position,
                                     loss_weight_strain=cfg.loss_weight_strain)
    return MSPartitionedTraining(sim, sim_cfg, stats, optimizer, step_fn, batcher, mesh, spec,
                                 orders=[o for o, _ in plans],
                                 graphs=[sharded_graph_to(g, mesh.primary) for _, g in plans])


def _sample_batcher(cfg: TrainConfig, sim_cfg: MultiScaleSimulatorConfig, batch_size: int) -> MultiScaleSampleBatcher:
    """The training split's batcher with each sample's static graph, in the
    layout ``cfg.ms_dense`` picks."""
    return MultiScaleSampleBatcher(
        Path(cfg.data_path) / "train.npz", cfg.input_sequence_length, batch_size,
        ms_cfg=sim_cfg.graph_config, pad_multiple=cfg.pad_multiple, edge_pad_multiple=cfg.edge_pad_multiple,
        seed=cfg.seed, dense=cfg.ms_dense, dense_row_advantage=_dense_row_advantage(cfg),
        m2m_traversals=cfg.layers,
    )


def make_loader(cfg: TrainConfig, sim_cfg: MultiScaleSimulatorConfig, split: str) -> MultiScaleTrajectoryLoader:
    """The trajectories of ``split`` with their static graphs, in the
    layout ``cfg.ms_dense`` picks."""
    return MultiScaleTrajectoryLoader(
        Path(cfg.data_path) / f"{split}.npz",
        ms_cfg=sim_cfg.graph_config,
        pad_multiple=cfg.pad_multiple,
        edge_pad_multiple=cfg.edge_pad_multiple,
        dense=cfg.ms_dense,
        dense_row_advantage=_dense_row_advantage(cfg),
        m2m_traversals=cfg.layers,
    )


def _rollout_fn(sim_cfg: MultiScaleSimulatorConfig, stats: NormStats, mode: str, device: torch.device) -> Callable:
    """The rollout ``predict`` and the validation run: ``ms_rollout``, its
    step captured in a CUDA graph on the card."""

    def rollout(sim, positions, types, strains, node_mask, graph):
        return ms_rollout(sim, sim_cfg, stats, positions, types, strains, graph,
                          node_mask=node_mask, inference_mode=mode, device=device)

    return rollout


# rollout outputs whose axis 1 is the node axis
_NODE_AXIS1_KEYS = ("initial_positions", "initial_strains", "predicted_rollout", "ground_truth_rollout",
                    "predicted_strain", "ground_truth_strain")


def make_ms_partitioned_host_rollout(mesh: Mesh, sim_cfg: MultiScaleSimulatorConfig, stats: NormStats,
                                     spec: PartitionSpec1D, mode: str, frames: Sequence = ()) -> Callable:
    """The graph-parallel rollout with host-side planning per trajectory,
    with ``_rollout_fn``'s call signature (the loader's graph is ignored):
    each trajectory is planned from the t = 0 positions of its real nodes,
    pinned to the training spec's slabs and halo, rolled out by
    ``make_ms_partitioned_rollout`` (its step captured where the mesh is
    one card) and its outputs scattered back to the caller's order. It
    plans the COO layout whatever layout training takes, as JAX's does.
    The trajectories whose t = 0 positions ``frames`` lists are planned
    up front with one set of shapes (``pinned_plans``), so that one capture
    serves them all; every plan's sharded graph goes to the card once and
    is kept, keyed on its frame's bytes; a trajectory not among ``frames``
    is planned when it comes, with shapes of its own."""
    run = make_ms_partitioned_rollout(mesh, sim_cfg, stats, spec, inference_mode=mode)
    plans: Dict[tuple, tuple] = {}

    def key(frame) -> tuple:
        frame = np.ascontiguousarray(frame, np.float32)
        return frame.shape, hashlib.sha1(frame.tobytes()).hexdigest()

    def keep(frame, order, graph) -> None:
        plans[key(frame)] = (order, sharded_graph_to(graph, mesh.primary))

    for frame, (order, graph) in zip(frames, pinned_plans(sim_cfg.graph_config, frames, spec) if frames else ()):
        keep(frame, order, graph)

    def _rollout(sim, positions, types, strains, node_mask, graph_unused=None):
        del graph_unused
        pos, ty = np.asarray(positions), np.asarray(types)
        st, m = np.asarray(strains), np.asarray(node_mask, bool)
        idx = np.nonzero(m)[0]
        if key(pos[idx, 0]) not in plans:
            _, order_rel, graph = plan_ms_partition(sim_cfg.graph_config, pos[idx, 0], spec.num_shards,
                                                    nodes_per_shard=spec.nodes_per_shard, halo=spec.halo)
            keep(pos[idx, 0], order_rel, graph)
        order_rel, graph = plans[key(pos[idx, 0])]
        order = idx[order_rel]
        nt, k = spec.total_nodes, len(order)
        pos_s = np.zeros((nt, *pos.shape[1:]), pos.dtype)
        pos_s[:k] = pos[order]
        ty_s = np.zeros(nt, ty.dtype)
        ty_s[:k] = ty[order]
        st_s = np.zeros((st.shape[0], nt), st.dtype)  # strains are [T, N]: the node axis is axis 1
        st_s[:, :k] = st[:, order]
        m_s = np.arange(nt) < k
        out = run(sim, pos_s, ty_s, st_s, m_s, graph)
        n_view, order_d = pos.shape[0], torch.as_tensor(order, device=mesh.primary)
        for name, v in out.items():
            if name == "particle_types":
                buf = v.new_zeros((n_view, *v.shape[1:]))
                buf[order_d] = v[:k]
                out[name] = buf
            elif name in _NODE_AXIS1_KEYS:
                buf = v.new_zeros((v.shape[0], n_view, *v.shape[2:]))
                buf[:, order_d] = v[:, :k]
                out[name] = buf
        return out

    return _rollout


MULTI_SCALE = Family(
    title="multi-scale", config_from=ms_config_from, init=multi_scale_simulator_init, loss=make_loss_fn,
    batcher=_sample_batcher, loader=make_loader, rollout=_rollout_fn,
    banner=lambda cfg, sim_cfg: f"scales={cfg.num_scales} window={cfg.window_size}",
    per_step=True, partitioned=_partitioned_training,
)
build_training = functools.partial(trainer.build_training, family=MULTI_SCALE)
make_train_step = functools.partial(trainer.make_train_step, family=MULTI_SCALE)
train = functools.partial(trainer.train, family=MULTI_SCALE)
predict = functools.partial(trainer.predict, family=MULTI_SCALE)
main = functools.partial(trainer.main, family=MULTI_SCALE)


if __name__ == "__main__":
    main()
