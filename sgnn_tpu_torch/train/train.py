"""The trainer of every model family: training, validation, rollout and the CLI.

Port of ``sgnn_tpu/train/train.py`` and of the loop
``sgnn_tpu/train/train_multi_scale.py`` repeats (single device):
``lr_schedule``, ``make_train_step`` (a family's loss, its backward and an
Adam update), ``build_training`` (the model, optimizer, step and batcher
``train`` runs), ``train``, ``evaluate_split``, ``predict`` and the CLI::

  python -m sgnn_tpu_torch.train.train --config configs/taylor2d_single_scale.yaml \\
      --mode train|valid|rollout [--model_file NAME] [--device cuda|cpu]

What differs between the model families is one ``Family`` each: ``GNS``
(the single-scale model), ``MESHGRAPHNET`` (``physics/mesh_simulator.py``)
and ``GRAPHCAST`` (``models/graphcast.py`` on gridded fields), which
``cfg.architecture`` picks (``gns``, ``meshgraphnet``, ``graphcast``), and
``train_multi_scale.MULTI_SCALE``, which that module's entry point passes.
A family gives the simulator's config and init, the loss and its terms,
the statistics it normalises with, the optimiser and its schedule, whether
a step draws input noise, the training batcher and the split loader, the
rollout of one loader item and how it is scored, its words in the training
banner, and its graph-parallel wiring.
A new model configuration is its simulator module, its family entry and
its tests; the loop stays as it is.

Each training step draws random-walk noise from a ``torch.Generator``
seeded from ``cfg.seed``, runs the family's forward, takes the masked
position + strain loss, its gradients, and one ``torch.optim.Adam`` update
at ``lr = sched(step)``, the step counted before the update as optax does.
On the card the batches come through ``data/prefetch.DevicePrefetcher``
(depth 2, as JAX's trainers) and the step is captured in a CUDA graph and
replayed (``train/captured_train_step.TrainStep``; Adam is capturable, its
lr a device tensor); ``inner_steps`` are that many replays. Best-only
checkpoints on the validation rollout loss, a final checkpoint when no
validation ran or on interrupt, resume from ``model_file``.

Parallel runs (``sgnn_tpu/train/train.py:364-452``), over a mesh of
``devices`` (an explicit list, which may name one device several times;
by default that many distinct CUDA devices, ``parallel/mesh.make_mesh``):

  * ``data_parallel: P`` splits each batch over P replicas
    (``parallel/data_parallel.DataParallelStep``: the global masked mean,
    the global batch's noise, gradients summed in replica order, one Adam
    step); ``batch_size`` must divide by P;
  * ``graph_parallel: P`` (with ``batch_size: 1``, and not with
    ``data_parallel``) is the family's own (``Family.partitioned``). The
    single-scale one plans one static slab partition over the training
    split's first, middle and last frames (its radius widened by 4 sigma of
    the noise walk), x-sorts each sample into it (``partition_sample``) and
    trains with ``parallel/edge_partition.PartitionedTrainStep``, whose halo
    guard rejects a step inside the step; a ``RejectionTracker`` aborts
    after 20 consecutive rejected log points. Validation and ``predict``
    roll out with ``make_partitioned_host_rollout`` (re-planning when the
    guard fires).

With every replica or shard on one device, the step is captured as one
CUDA graph.

The capacity knobs reach the single-scale model through the config:
``remat`` (the layers' recomputation in the backward,
``models/epd_flat.py``) and ``band_nodes`` (the banded gathers,
``ops/sym_gather.py``). With a band the loss adds ``train/band_violations``
(edges that broke it, counted inside the captured step; a graph-parallel
step folds them into its halo guard, which rejects the step), and the
trainer warns at a log point where it is above 0. ``debug_graph: true``
audits the first training sample's graph before training
(``utils/graph_debug.audit_neighbor_list``).

GraphCast's graphs are static: built on the host with the model
(``physics/sphere_graph.build_graph``) and kept on it; a batch holds each
sample's input states, forcings, static fields and target
(``data/fields.FieldBatcher``), and a loader item a whole trajectory, which
the rollout forecasts step after step. Its optimiser is AdamW with the
published warm-up and cosine schedule (``graphcast_optimizer``,
``graphcast_schedule``), and its step draws no noise.

MeshGraphNets' batches carry each sample's static mesh
(``MeshSampleBatcher``), and each rolled-out trajectory's mesh is built
from its first frame (``make_mesh_rollout``). Its slot widths
(``mesh_slots``, ``world_search_slots``, ``world_slots``) are derived from
the training split where the config leaves them unset; it runs on one
device in f32 (``check_meshgraphnet``).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import pickle
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sgnn_tpu_torch.data.loader import (
    MeshSampleBatcher,
    SampleBatcher,
    TrajectoryLoader,
    load_metadata,
    load_trajectories,
)
from sgnn_tpu_torch.data.fields import FieldBatcher, load_field_split
from sgnn_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from sgnn_tpu_torch.models import graphcast as gc
from sgnn_tpu_torch.models.epd_flat import check_remat
from sgnn_tpu_torch.parallel.data_parallel import DataParallelStep
from sgnn_tpu_torch.parallel.edge_partition import (
    PartitionedTrainStep,
    PartitionSpec1D,
    RejectionTracker,
    dataset_partition_plan,
    make_replanning_rollout,
    partition_sample,
)
from sgnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from sgnn_tpu_torch.physics import mesh_simulator
from sgnn_tpu_torch.physics.mesh_simulator import (
    MeshSimulatorConfig,
    build_mesh,
    derive_slots,
    mesh_rollout,
    mesh_simulator_init,
)
from sgnn_tpu_torch.physics.rollout import rollout as rollout_fn
from sgnn_tpu_torch.physics.simulator import (
    LearnedSimulator,
    NormStats,
    SimulatorConfig,
    compute_neighbors,
    make_norm_stats,
    predict_accelerations_batched,
    simulator_init,
)
from sgnn_tpu_torch.train.captured_train_step import TrainStep
from sgnn_tpu_torch.train.checkpoint import CheckpointManager, load_optimizer_state, train_state
from sgnn_tpu_torch.train.config import TrainConfig, load_config
from sgnn_tpu_torch.train.loss import one_step_loss
from sgnn_tpu_torch.train.metrics import MetricLogger
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.graph_debug import audit_neighbor_list
from sgnn_tpu_torch.utils.profiling import trace_region
from sgnn_tpu_torch.utils.resource_monitor import ResourceMonitor

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8  # optax.adam's defaults
# GraphCast's optimiser (its paper, section 4): AdamW at beta 0.9 / 0.95 and weight decay 0.1,
# the learning rate warmed up linearly from 0 to lr_init over 1,000 steps, then a half cosine to 0
# at ntraining_steps
GRAPHCAST_BETAS = (0.9, 0.95)
GRAPHCAST_WEIGHT_DECAY = 0.1
GRAPHCAST_WARMUP_STEPS = 1000
PREFETCH_DEPTH = 2  # batches staged ahead, as JAX's trainers
REJECTION_LIMIT = 20  # consecutive rejected log points before a graph-parallel run aborts


def simulator_config_from(cfg: TrainConfig, metadata: dict) -> SimulatorConfig:
    """Auto-derivations from the builder-recorded dataset facts
    (``max_degree``, ``pos_min``/``pos_max``); explicit config values win."""
    max_neighbors = 20
    slots = cfg.neighbor_slots
    max_degree = metadata.get("max_degree")
    if slots is None and max_degree is not None:
        # +2 margin: noise can move a pair across the radius; widths are
        # rounded to 8 or the next multiple of 4, as the JAX trainer does
        slots = min(max_neighbors, int(max_degree) + 2)
        slots = min(max_neighbors, 8 if slots <= 8 else -(-slots // 4) * 4)
    check_remat(cfg.remat)
    symmetric = cfg.symmetric_gather
    if symmetric is None:
        # the JAX trainer's rule: on with bf16 edge latents, when the cap
        # cannot bind (max degree + 2 fits the slots)
        symmetric = (
            cfg.compute_dtype == "bfloat16"
            and max_degree is not None
            and slots is not None
            and int(max_degree) + 2 <= slots
        )
    return SimulatorConfig(
        dim=cfg.dim,
        latent_dim=cfg.hidden_dim,
        num_message_passing_steps=cfg.layers,
        num_mlp_layers=1,  # reference single-scale
        connectivity_radius=cfg.connection_radius,
        input_sequence_length=cfg.input_sequence_length,
        num_particle_types=int(metadata.get("num_particle_types", 1)),
        particle_type_embedding_size=cfg.particle_type_embedding_size,
        max_neighbors=max_neighbors,
        neighbor_slots=slots,
        symmetric_gather=bool(symmetric),
        compute_dtype=cfg.compute_dtype,
        domain=_domain(cfg, metadata, cfg.connection_radius),
        cell_capacity=cfg.cell_capacity,
        band_nodes=cfg.band_nodes,
        remat=cfg.remat,
    )


def _domain(cfg: TrainConfig, metadata: dict, radius: float):
    """The config's static search domain, else the dataset's extent with a
    rollout-drift margin; None without either."""
    if cfg.domain is not None or "pos_min" not in metadata or "pos_max" not in metadata:
        return cfg.domain
    lo = np.asarray(metadata["pos_min"], np.float64)
    hi = np.asarray(metadata["pos_max"], np.float64)
    pad = 0.25 * (hi - lo) + 4 * radius  # rollout-drift margin
    return (tuple(lo - pad), tuple(hi + pad))


def check_meshgraphnet(cfg: TrainConfig) -> None:
    """MeshGraphNets runs on one device, in f32, without the single-scale
    model's capacity knobs."""
    unsupported = {"data_parallel": cfg.data_parallel > 1, "graph_parallel": cfg.graph_parallel > 1,
                   "remat": check_remat(cfg.remat) is not False, "band_nodes": cfg.band_nodes is not None,
                   "symmetric_gather": bool(cfg.symmetric_gather), "debug_graph": cfg.debug_graph,
                   "compute_dtype": cfg.compute_dtype != "float32"}
    named = sorted(k for k, v in unsupported.items() if v)
    if named:
        raise ValueError(f"architecture meshgraphnet does not take {', '.join(named)}")


def mesh_config_from(cfg: TrainConfig, metadata: dict) -> MeshSimulatorConfig:
    """The MeshGraphNets simulator's config (``check_meshgraphnet`` first);
    slot widths the config leaves unset are derived from the training split
    (``derive_slots``) and printed."""
    check_meshgraphnet(cfg)
    slots = {k: getattr(cfg, k) for k in ("mesh_slots", "world_search_slots", "world_slots")}
    if None in slots.values():
        derived = derive_slots(load_trajectories(Path(cfg.data_path) / "train.npz"), cfg.mesh_radius,
                               cfg.world_radius)
        slots = {k: derived[k] if v is None else v for k, v in slots.items()}
        print(f"meshgraphnet slot widths from the training split: {slots}")
    return MeshSimulatorConfig(
        dim=cfg.dim,
        latent_dim=cfg.hidden_dim,
        num_message_passing_steps=cfg.layers,
        num_mlp_layers=2,  # MeshGraphNets' MLPs (core_model.py)
        connectivity_radius=cfg.connection_radius,
        mesh_radius=cfg.mesh_radius,
        world_radius=cfg.world_radius,
        input_sequence_length=cfg.input_sequence_length,
        num_particle_types=int(metadata.get("num_particle_types", 1)),
        particle_type_embedding_size=cfg.particle_type_embedding_size,
        domain=_domain(cfg, metadata, cfg.world_radius),
        cell_capacity=cfg.cell_capacity,
        **slots,
    )


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr_init * decay^(step / decay_steps) + 1e-6 (the reference's)."""

    def sched(step):
        return cfg.lr_init * cfg.lr_decay ** (step / cfg.lr_decay_steps) + 1e-6

    return sched


def make_optimizer(sim: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with optax's defaults; the training step sets its lr. On the
    card it is capturable (step counts and lr on the device, so that its
    update can be captured in a CUDA graph); capturable Adam takes device
    tensors only, so the CPU keeps the default one, with a float lr."""
    lr = lr_schedule(cfg)(0)
    device = next(sim.parameters()).device
    if device.type == "cuda":
        return torch.optim.Adam(sim.parameters(), lr=torch.tensor(lr, device=device), betas=ADAM_BETAS,
                                eps=ADAM_EPS, capturable=True)
    return torch.optim.Adam(sim.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def roll_particles(rollout: Callable, sim: torch.nn.Module, item: dict) -> dict:
    """A particle family's rollout of one loader item."""
    return rollout(sim, item["positions"], item["particle_type"], item["strains"], item["node_mask"],
                   item.get("graph"))


@dataclass(frozen=True)
class Family:
    """What differs between the model families the one trainer runs."""

    title: str  # in the training banner and the rollout summary
    config_from: Callable  # (cfg, metadata) -> the simulator's config
    init: Callable  # (sim_cfg, *, generator, device) -> the simulator
    # (sim, sim_cfg, stats, cfg) -> loss_fn(batch, noise, denom=None) -> (loss, aux); aux holds
    # train/loss-<term> of each of ``terms``, which the step's log line prints
    loss: Callable
    batcher: Callable  # (cfg, sim_cfg, batch_size) -> the training split's batcher
    loader: Callable  # (cfg, sim_cfg, split) -> the split's trajectories, one loader item each
    # (sim_cfg, stats, mode, device) -> the rollout that ``roll`` calls on one loader item
    rollout: Callable
    banner: Callable  # (cfg, sim_cfg) -> the family's words in the training banner
    # scores a rollout by its per-step RMSE and the rollouts' times (the multi-scale
    # evaluator), else by the cumulative RMSE
    per_step: bool = False
    audit: Optional[Callable] = None  # (batcher, sim_cfg, radius): ``debug_graph``'s audit
    # graph_parallel: (cfg, sim, sim_cfg, stats, optimizer, noise_gen, mesh, batch_size) -> Training
    partitioned: Optional[Callable] = None
    # graph_parallel in predict: (cfg, sim_cfg, stats, loader, device, devices) -> rollout; None ignores it
    partitioned_predict: Optional[Callable] = None
    stats: Callable = make_norm_stats  # (metadata, noise_std, device) -> what loss and rollout normalise with
    schedule: Callable = lr_schedule  # cfg -> sched(step) -> lr
    optimizer: Callable = make_optimizer  # (sim, cfg) -> the optimizer
    noisy: bool = True  # each step draws the random-walk input noise
    # (rollout, sim, loader item) -> outputs: ``rmse_<term>`` (or ``rmse_<term>_per_step``) of each term
    roll: Callable = roll_particles
    terms: Tuple[str, ...] = ("position", "strain")  # the loss's parts, logged and scored


batch_to_device = to_device  # a host batch on a device: its arrays (and a mesh's) as tensors


def make_loss_fn(sim: LearnedSimulator, sim_cfg: SimulatorConfig, stats: NormStats, cfg: TrainConfig) -> Callable:
    """The loss ``(batch, noise, denom=None) -> (loss, aux)`` of ``sim`` on a
    ``[B, N, ...]`` batch: every term a masked sum over ``denom`` (default:
    the batch's masked count; a data-parallel replica gets the global one).
    With ``band_nodes`` set, aux adds ``train/band_violations``."""

    banded = sim_cfg.band_nodes is not None

    def loss_fn(batch, noise, denom=None):
        out = predict_accelerations_batched(
            sim, sim_cfg, stats, batch["next_position"], noise, batch["positions"],
            batch["particle_type"], batch["node_mask"], return_aux=banded,
        )
        loss, aux = one_step_loss(*out[:3], batch["next_strain"], batch["node_mask"],
                                  weight_position=cfg.loss_weight_position, weight_strain=cfg.loss_weight_strain,
                                  denom=denom)
        if banded:
            # the banded gathers' contract (ops/sym_gather.band_violations):
            # above 0, the node ordering decayed past band_nodes this step
            aux["train/band_violations"] = out[3]["band_violations"]
        return loss, aux

    return loss_fn


def make_mesh_loss_fn(sim: torch.nn.Module, sim_cfg: MeshSimulatorConfig, stats: NormStats,
                      cfg: TrainConfig) -> Callable:
    """``make_loss_fn`` of a MeshGraphNets simulator: its batches carry the
    samples' meshes (``batch["mesh"]``)."""

    def loss_fn(batch, noise, denom=None):
        out = mesh_simulator.predict_accelerations_batched(
            sim, sim_cfg, stats, batch["next_position"], noise, batch["positions"], batch["particle_type"],
            batch["node_mask"], batch["mesh"],
        )
        return one_step_loss(*out, batch["next_strain"], batch["node_mask"], weight_position=cfg.loss_weight_position,
                             weight_strain=cfg.loss_weight_strain, denom=denom)

    return loss_fn


def make_train_step(
    sim: torch.nn.Module,
    sim_cfg,
    stats: NormStats,
    cfg: TrainConfig,
    optimizer: torch.optim.Optimizer,
    generator: Optional[torch.Generator] = None,
    family: Optional[Family] = None,
) -> TrainStep:
    """The step ``(batch, step, noise=None) -> metrics`` of ``family``'s loss
    (default: ``cfg.architecture``'s): updates ``sim``'s parameters in place
    through ``optimizer``, captured in a CUDA graph on the card
    (``TrainStep``). ``step`` is the count of updates before this one (the
    schedule's argument); ``noise`` replaces the draw from ``generator``
    (the parity tests inject JAX's). Metrics are 0-d tensors left on the
    device."""
    family = family or family_of(cfg)
    loss = family.loss(sim, sim_cfg, stats, cfg)
    return TrainStep(loss, optimizer, family.schedule(cfg), cfg.noise_std if family.noisy else None, generator)


@dataclass
class Training:
    """What ``build_training`` wires together for ``train``; ``mesh`` for a
    parallel run, ``spec`` for a graph-parallel one (whose ``Training`` is
    its family's: ``PartitionedTraining``,
    ``train_multi_scale.MSPartitionedTraining``)."""

    sim: torch.nn.Module
    sim_cfg: object
    stats: NormStats
    optimizer: torch.optim.Adam
    step_fn: TrainStep
    batcher: SampleBatcher
    mesh: Optional[Mesh] = None
    spec: Optional[PartitionSpec1D] = None

    def epochs(self) -> Iterator[dict]:
        """The training batches, endlessly."""
        return self.batcher.epochs()

    def validation_rollout(self, family: Family, cfg: TrainConfig, loader, device: torch.device) -> Callable:
        """The rollout the validation takes over ``loader``'s trajectories."""
        return family.rollout(self.sim_cfg, self.stats, cfg.inference_mode, device)


@dataclass
class PartitionedTraining(Training):
    """``Training`` of a graph-parallel single-scale run."""

    def epochs(self) -> Iterator[dict]:
        """The training batches, endlessly, each sample x-sorted into the
        plan's slabs (``partition_sample``)."""
        return (partition_sample(b, self.spec) for b in self.batcher.epochs())

    def validation_rollout(self, family: Family, cfg: TrainConfig, loader, device: torch.device) -> Callable:
        """The host rollout on the training plan
        (``make_partitioned_host_rollout``)."""
        print(f"graph-parallel: {cfg.graph_parallel} shards x {self.spec.nodes_per_shard} nodes "
              f"(halo {self.spec.halo})")
        return make_partitioned_host_rollout(self.mesh, self.sim_cfg, self.stats, self.spec, cfg.inference_mode)


def check_parallel(cfg: TrainConfig) -> None:
    """The JAX trainer's config errors for parallel runs."""
    if cfg.graph_parallel > 1:
        if cfg.data_parallel > 1:
            raise ValueError("data_parallel and graph_parallel are mutually exclusive")
        if cfg.batch_size != 1:
            raise ValueError("graph_parallel trains one partitioned graph per step; set batch_size: 1")
    if cfg.data_parallel > 1 and cfg.batch_size % cfg.data_parallel:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by data_parallel {cfg.data_parallel}")


def parallel_mesh(cfg: TrainConfig, device: torch.device, devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The mesh of a data- or graph-parallel run (None for one device): over
    ``devices`` if given, else that many distinct CUDA devices; its first
    device must be ``device``."""
    if cfg.data_parallel <= 1 and cfg.graph_parallel <= 1:
        return None
    mesh = make_mesh(data=cfg.data_parallel, graph=cfg.graph_parallel, devices=devices)
    if mesh.primary != resolve_device(device):
        raise ValueError(f"the mesh's first device is {mesh.primary}, the run's device {device}")
    return mesh


def partition_frames(trajectories) -> list:
    """First, middle and last frame of every trajectory: what a dataset
    partition plan covers."""
    return [pos[t] for pos, _, _ in trajectories for t in (0, pos.shape[0] // 2, pos.shape[0] - 1)]


def sample_batcher(cfg: TrainConfig, sim_cfg, batch_size: int) -> SampleBatcher:
    """The training split's plain batcher."""
    return SampleBatcher(Path(cfg.data_path) / "train.npz", cfg.input_sequence_length, batch_size,
                         pad_multiple=cfg.pad_multiple, seed=cfg.seed)


def mesh_sample_batcher(cfg: TrainConfig, sim_cfg: MeshSimulatorConfig, batch_size: int) -> MeshSampleBatcher:
    """The training split's batcher with each sample's mesh."""
    return MeshSampleBatcher(Path(cfg.data_path) / "train.npz", cfg.input_sequence_length, batch_size,
                             mesh_radius=sim_cfg.mesh_radius, mesh_slots=sim_cfg.mesh_slots,
                             pad_multiple=cfg.pad_multiple, seed=cfg.seed)


def trajectory_loader(cfg: TrainConfig, sim_cfg, split: str) -> TrajectoryLoader:
    """The trajectories of ``split``, padded."""
    return TrajectoryLoader(Path(cfg.data_path) / f"{split}.npz", pad_multiple=cfg.pad_multiple)


def _partitioned_training(cfg: TrainConfig, sim, sim_cfg, stats, optimizer, noise_gen, mesh,
                          batch_size: int) -> PartitionedTraining:
    """The single-scale graph-parallel wiring: one plan over the training
    split, ``PartitionedTrainStep``."""
    batcher = sample_batcher(cfg, sim_cfg, batch_size)
    # plan with a noise margin: the step adds a random walk of cumulative
    # std noise_std * sqrt(S - 1) at the last frame, 4 sigma of it on
    # each of two nodes, so that the guard does not fire on clean frames
    plan_radius = cfg.connection_radius + 4.0 * cfg.noise_std * float(
        np.sqrt(max(cfg.input_sequence_length - 1, 1)))
    spec = dataset_partition_plan(partition_frames(batcher.trajectories), cfg.graph_parallel, plan_radius)
    step_fn = PartitionedTrainStep(mesh, sim_cfg, stats, spec, sim, optimizer, lr_schedule(cfg), cfg.noise_std,
                                   noise_gen, loss_weight_position=cfg.loss_weight_position,
                                   loss_weight_strain=cfg.loss_weight_strain)
    return PartitionedTraining(sim, sim_cfg, stats, optimizer, step_fn, batcher, mesh, spec)


def _partitioned_predict(cfg: TrainConfig, sim_cfg, stats, loader, device, devices) -> Callable:
    """``predict``'s single-scale graph-parallel rollout: a plan over the
    split's trajectories, re-planned when the guard fires."""
    mesh = parallel_mesh(dataclasses.replace(cfg, data_parallel=1), device, devices)
    spec = dataset_partition_plan(partition_frames(loader.trajectories), cfg.graph_parallel, cfg.connection_radius)
    print(f"graph-parallel rollout: {cfg.graph_parallel} shards x {spec.nodes_per_shard} nodes (halo {spec.halo})")
    return make_partitioned_host_rollout(mesh, sim_cfg, stats, spec, cfg.inference_mode)


def build_training(
    cfg: TrainConfig, device: torch.device, batch_size: Optional[int] = None, devices: Optional[Sequence] = None,
    family: Optional[Family] = None,
) -> Training:
    """``family``'s model (default: ``cfg.architecture``'s) from
    ``cfg.seed``, its optimizer, the training step (noise from a generator
    seeded from ``cfg.seed``; data- or graph-parallel over the mesh of
    ``devices`` when the config asks) and the batcher of the training
    split; ``batch_size`` overrides ``cfg.batch_size``."""
    family = family or family_of(cfg)
    check_parallel(cfg)
    metadata = load_metadata(cfg.data_path)
    sim_cfg = family.config_from(cfg, metadata)
    stats = family.stats(metadata, cfg.noise_std, device=device)
    sim = family.init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=device)
    optimizer = family.optimizer(sim, cfg)
    noise_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    mesh, batch_size = parallel_mesh(cfg, device, devices), batch_size or cfg.batch_size
    if cfg.graph_parallel > 1:
        return family.partitioned(cfg, sim, sim_cfg, stats, optimizer, noise_gen, mesh, batch_size)
    if mesh is not None:
        step_fn = DataParallelStep(lambda m, d: family.loss(m, sim_cfg, stats.to(d), cfg), sim, mesh, optimizer,
                                   family.schedule(cfg), cfg.noise_std, noise_gen)
    else:
        step_fn = make_train_step(sim, sim_cfg, stats, cfg, optimizer, noise_gen, family)
    return Training(sim, sim_cfg, stats, optimizer, step_fn, family.batcher(cfg, sim_cfg, batch_size), mesh)


def audit_first_sample(batcher: SampleBatcher, sim_cfg: SimulatorConfig, radius: float) -> dict:
    """The connectivity audit (``utils/graph_debug.audit_neighbor_list``)
    of the first sample's graph, on the CPU, before training: JAX's
    ``debug_graph``."""
    sample = next(iter(batcher))
    pos0 = sample["positions"][0, :, -1]
    m0 = sample["node_mask"][0]
    nl0 = compute_neighbors(sim_cfg, torch.from_numpy(np.asarray(pos0)), torch.from_numpy(np.asarray(m0)))
    return audit_neighbor_list(pos0, nl0, radius, node_mask=m0)


def make_rollout(
    sim_cfg: SimulatorConfig, stats: NormStats, mode: str, device: torch.device
) -> Callable:
    """The single-scale rollout ``predict`` and the validation run: its step
    captured in a CUDA graph on the card (``physics/captured_step.py``),
    the counterpart of JAX's ``make_jit_rollout``."""

    def _rollout(sim, positions, types, strains, node_mask, graph=None):
        return rollout_fn(sim, sim_cfg, stats, positions, types, strains, node_mask=node_mask,
                          inference_mode=mode, device=device)

    return _rollout


def make_mesh_rollout(
    sim_cfg: MeshSimulatorConfig, stats: NormStats, mode: str, device: torch.device
) -> Callable:
    """``make_rollout`` of MeshGraphNets: each trajectory's mesh built from
    its first frame (``build_mesh``), then ``mesh_rollout``."""

    def _rollout(sim, positions, types, strains, node_mask, graph=None):
        real = np.asarray(positions)[np.asarray(node_mask, bool)]
        mesh = build_mesh(real[:, 0], sim_cfg.mesh_radius, sim_cfg.mesh_slots, len(node_mask))
        return mesh_rollout(sim, sim_cfg, stats, positions, types, strains, mesh, node_mask=node_mask,
                            inference_mode=mode, device=device)

    return _rollout


def check_graphcast(cfg: TrainConfig) -> None:
    """GraphCast runs on one device, in f32, without input noise (as
    published), forecasting autoregressively."""
    unsupported = {"data_parallel": cfg.data_parallel > 1, "graph_parallel": cfg.graph_parallel > 1,
                   "remat": check_remat(cfg.remat) is not False, "band_nodes": cfg.band_nodes is not None,
                   "symmetric_gather": bool(cfg.symmetric_gather), "debug_graph": cfg.debug_graph,
                   "compute_dtype": cfg.compute_dtype != "float32", "noise_std": cfg.noise_std != 0,
                   "inference_mode": cfg.inference_mode != "autoregressive"}
    named = sorted(k for k, v in unsupported.items() if v)
    if named:
        raise ValueError(f"architecture graphcast does not take {', '.join(named)}")


def graphcast_config_from(cfg: TrainConfig, metadata: dict) -> gc.GraphCastConfig:
    """GraphCast's config from the run's and the dataset's (``check_graphcast`` first)."""
    check_graphcast(cfg)
    return gc.GraphCastConfig(
        latent_dim=cfg.hidden_dim, num_message_passing_steps=cfg.layers,
        state_dim=len(metadata["surface_variables"]) + len(metadata["atmospheric_variables"]) * len(
            metadata["levels"]),
        forcing_dim=len(metadata["forcing_variables"]), static_dim=len(metadata["static_variables"]),
        resolution_deg=float(metadata["resolution_deg"]), mesh_refinement=cfg.mesh_refinement,
        edge_pad_multiple=cfg.edge_pad_multiple,
        input_frames=cfg.input_sequence_length,
    )


def graphcast_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """GraphCast's: linear warm-up to lr_init, then a half cosine to 0 at ntraining_steps."""
    warm = GRAPHCAST_WARMUP_STEPS

    def sched(step):
        if step < warm:
            return cfg.lr_init * step / warm
        frac = min(1.0, (step - warm) / max(1, cfg.ntraining_steps - warm))
        return cfg.lr_init * 0.5 * (1.0 + math.cos(math.pi * frac))

    return sched


def graphcast_optimizer(sim: torch.nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    """GraphCast's AdamW, capturable on the card as ``make_optimizer``'s Adam."""
    lr = graphcast_schedule(cfg)(0)
    device = next(sim.parameters()).device
    kw = dict(betas=GRAPHCAST_BETAS, eps=ADAM_EPS, weight_decay=GRAPHCAST_WEIGHT_DECAY)
    if device.type == "cuda":
        return torch.optim.AdamW(sim.parameters(), lr=torch.tensor(lr, device=device), capturable=True, **kw)
    return torch.optim.AdamW(sim.parameters(), lr=lr, **kw)


def make_graphcast_loss_fn(sim: gc.GraphCast, sim_cfg: gc.GraphCastConfig, stats: gc.FieldStats,
                           cfg: TrainConfig) -> Callable:
    """GraphCast's loss of a batch: each sample's forward over the one
    static graph, the samples' losses averaged (``noise`` is None)."""

    def loss_fn(batch, noise, denom=None):
        surf, atm = [], []
        for b in range(batch["state"].shape[0]):
            y = gc.predict_residual(sim, stats, batch["state"][b], batch["forcings"][b], batch["static"][b])
            s, a = gc.loss_terms(stats, y, gc.target_residual(stats, batch["state"][b, -1], batch["target"][b]))
            surf.append(s)
            atm.append(a)
        surf, atm = torch.stack(surf).mean(), torch.stack(atm).mean()
        return surf + atm, {"train/loss-surface": surf, "train/loss-atmosphere": atm}

    return loss_fn


def field_batcher(cfg: TrainConfig, sim_cfg: gc.GraphCastConfig, batch_size: int) -> FieldBatcher:
    return FieldBatcher(Path(cfg.data_path) / "train.npz", sim_cfg.input_frames, batch_size, seed=cfg.seed)


def field_loader(cfg: TrainConfig, sim_cfg: gc.GraphCastConfig, split: str) -> List[dict]:
    """The split's trajectories, one forecast item each: ``{"state", "forcings", "static", "name"}``."""
    return [dict(fields, name=name) for name, fields in load_field_split(Path(cfg.data_path) / f"{split}.npz")]


def make_graphcast_rollout(sim_cfg: gc.GraphCastConfig, stats: gc.FieldStats, mode: str,
                           device: torch.device) -> Callable:
    """The forecast of one loader item: every 6-hour step after the input
    frames, autoregressively, scored by the latitude-weighted RMSE per step
    of the surface and of the atmospheric channels (in standard deviations)."""

    def _rollout(sim, item):
        with torch.no_grad(), trace_region("rollout"):
            state, forcings, static = (torch.as_tensor(item[k], device=device) for k in ("state", "forcings",
                                                                                          "static"))
            pred = gc.rollout(sim, stats, state, forcings, static, state.shape[0] - sim_cfg.input_frames)
            truth = state[sim_cfg.input_frames:]
            return {"predicted_rollout": pred, "ground_truth_rollout": truth,
                    "rmse_surface": gc.lat_weighted_rmse(stats, pred, truth, stats.surface),
                    "rmse_atmosphere": gc.lat_weighted_rmse(stats, pred, truth, ~stats.surface)}

    return _rollout


def make_partitioned_host_rollout(
    mesh: Mesh, sim_cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D, mode: str
) -> Callable:
    """The graph-parallel rollout with host-side partitioning and re-planning
    (``edge_partition.make_replanning_rollout``), with ``make_rollout``'s
    call signature, so ``evaluate_split`` takes it unchanged."""
    run = make_replanning_rollout(mesh, sim_cfg, stats, spec, inference_mode=mode)

    def _rollout(sim, positions, types, strains, node_mask, graph=None):
        out = run(sim, positions, types, strains, node_mask)
        if int(out["replans"]):
            print(f"  partition re-planned {int(out['replans'])}x during rollout")
        viol = int(out["halo_violations"].sum())
        if viol:
            print(
                f"  WARNING: {viol} residual halo violations AFTER re-planning — the plan's "
                "slab/halo sizes are too small for this geometry; rebuild the spec with more slack"
            )
        return out

    return _rollout


GNS = Family(
    title="single-scale", config_from=simulator_config_from, init=simulator_init, loss=make_loss_fn,
    batcher=sample_batcher, loader=trajectory_loader, rollout=make_rollout,
    banner=lambda cfg, sim_cfg: f"slots={sim_cfg.slots} symmetric_gather={sim_cfg.symmetric_gather}",
    audit=audit_first_sample, partitioned=_partitioned_training, partitioned_predict=_partitioned_predict,
)
MESHGRAPHNET = Family(
    title="meshgraphnet", config_from=mesh_config_from, init=mesh_simulator_init, loss=make_mesh_loss_fn,
    batcher=mesh_sample_batcher, loader=trajectory_loader, rollout=make_mesh_rollout,
    banner=lambda cfg, sim_cfg: (f"mesh_slots={sim_cfg.mesh_slots} world_slots={sim_cfg.world_slots} "
                                 f"(search {sim_cfg.world_search_slots})"),
)
GRAPHCAST = Family(
    title="graphcast", config_from=graphcast_config_from, init=gc.GraphCast, loss=make_graphcast_loss_fn,
    batcher=field_batcher, loader=field_loader, rollout=make_graphcast_rollout,
    banner=lambda cfg, sim_cfg: (f"grid={sim_cfg.resolution_deg}deg mesh_refinement={sim_cfg.mesh_refinement} "
                                 f"frames={sim_cfg.input_frames}"),
    stats=gc.field_stats, schedule=graphcast_schedule, optimizer=graphcast_optimizer, noisy=False,
    roll=lambda rollout, sim, item: rollout(sim, item), terms=("surface", "atmosphere"),
)
ARCHITECTURES = {"gns": GNS, "meshgraphnet": MESHGRAPHNET, "graphcast": GRAPHCAST}


def family_of(cfg: TrainConfig) -> Family:
    """The family ``cfg.architecture`` names."""
    if cfg.architecture not in ARCHITECTURES:
        raise ValueError(f"architecture must be one of {tuple(ARCHITECTURES)}, got {cfg.architecture!r}")
    return ARCHITECTURES[cfg.architecture]


def evaluate_split(sim: torch.nn.Module, loader, rollout: Callable, family: Family):
    """Roll out every trajectory of the loader; (per-case outputs, summary).
    The summary scores total and each of the family's terms (position and
    strain) at the last step and one_step at the first: by the cumulative RMSE, or for a ``per_step``
    family by the per-step RMSE, with the rollouts' mean_time and std_time
    (the JAX multi-scale evaluator)."""
    suffix = "_per_step" if family.per_step else ""
    outputs, losses = [], {"total": [], **{t: [] for t in family.terms}, "one_step": []}
    for traj in loader:
        t0 = time.perf_counter()
        out = family.roll(rollout, sim, traj)
        out = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the device
        out["run_time"] = time.perf_counter() - t0
        outputs.append(out)
        rmse = [out[f"rmse_{t}{suffix}"] for t in family.terms]
        for t, r in zip(family.terms, rmse):
            losses[t].append(r[-1])
        losses["total"].append(sum(r[-1] for r in rmse))
        losses["one_step"].append(sum(r[0] for r in rmse))
    summary = {k: float(np.mean(v)) for k, v in losses.items() if v}
    if family.per_step and outputs:
        times = [o["run_time"] for o in outputs]
        summary["mean_time"] = float(np.mean(times))
        summary["std_time"] = float(np.std(times))
    return outputs, summary


def train(cfg: TrainConfig, device: Device = None, devices: Optional[Sequence] = None,
          family: Optional[Family] = None) -> dict:
    """Train ``family`` (default: ``cfg.architecture``'s) on ``device``
    (CUDA unless told otherwise; a parallel run over the mesh of
    ``devices``, whose first is ``device``); returns
    ``{"step", "lowest_eval_loss"}``."""
    dev = resolve_device(device)
    family = family or family_of(cfg)
    inner = max(1, int(cfg.inner_steps))
    for name in ("log_every", "nsave_steps", "ntraining_steps"):
        if getattr(cfg, name) % inner:
            raise ValueError(f"{name}={getattr(cfg, name)} must be a multiple of inner_steps={inner}")
    built = build_training(cfg, dev, devices=devices, family=family)
    sim, sim_cfg, optimizer, train_step = built.sim, built.sim_cfg, built.optimizer, built.step_fn
    ckpt_dir = Path(cfg.model_path) / cfg.run_name
    ckpt = CheckpointManager(ckpt_dir)
    lowest_eval_loss = float("inf")
    step = 0
    if cfg.model_file is not None:
        state, meta = ckpt.restore(cfg.model_file, map_location=dev)
        sim.load_state_dict(state["params"], strict=True)
        if state["opt_state"] is not None:
            load_optimizer_state(optimizer, state["opt_state"])
        step = int(state["step"])
        lowest_eval_loss = meta.get("lowest_eval_loss") or float("inf")
        print(f"resumed from {cfg.model_file} at step {step}")

    valid_loader = family.loader(cfg, sim_cfg, "valid")
    rollout = built.validation_rollout(family, cfg, valid_loader, dev)
    if cfg.data_parallel > 1:
        print(f"data-parallel over {cfg.data_parallel} replicas")
    monitor = ResourceMonitor(dev)
    sched = family.schedule(cfg)
    rejection_tracker = RejectionTracker(limit=REJECTION_LIMIT)
    print(
        f"{family.title} training: {family.banner(cfg, sim_cfg)} layers={cfg.layers} hidden={cfg.hidden_dim} "
        f"batch={cfg.batch_size} nodes_padded={built.batcher.num_nodes} dtype={cfg.compute_dtype} "
        f"steps={cfg.ntraining_steps} device={dev}"
    )
    if cfg.debug_graph and family.audit is not None:
        family.audit(built.batcher, sim_cfg, cfg.connection_radius)

    logger = MetricLogger(ckpt_dir, use_wandb=cfg.log, project=cfg.project_name, run_name=cfg.run_name)
    source = DevicePrefetcher(built.epochs(), depth=PREFETCH_DEPTH, device=dev)
    interrupted = False
    t_last = time.perf_counter()
    try:
        while step < cfg.ntraining_steps:
            for _ in range(inner):  # inner_steps: replays of the captured step, each on its own batch
                metrics = train_step(next(source), step)
                step += 1

            if step % cfg.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                metrics["lr"] = float(sched(step))
                metrics["train/vram_mb"] = monitor.get_current_memory()
                dt = (time.perf_counter() - t_last) / cfg.log_every
                t_last = time.perf_counter()
                metrics["train/step_time_s"] = dt
                logger.log(metrics, step)
                terms = " ".join(f"{t}={metrics[f'train/loss-{t}']:.6f}" for t in family.terms)
                print(f"step {step}: loss={metrics['train/loss']:.6f} {terms} ({dt * 1e3:.1f} ms/step)")
                if metrics.get("train/halo_violations", 0) > 0:
                    print(
                        "  NOTE: halo-contract violations this step — the noisy sample geometry "
                        "outgrew the static partition plan; the update was REJECTED in-step "
                        "(train/halo_rejected) and the sample skipped (step and lr schedule "
                        "advance). Frequent rejections mean the plan's noise margin is too thin: "
                        "rebuild with a larger halo_slack."
                    )
                # a plan the geometry outgrew for good rejects every step: abort
                # after REJECTION_LIMIT consecutive rejected log points
                rejection_tracker.update(metrics.get("train/halo_rejected", 0) > 0)
                if metrics.get("train/band_violations", 0) > 0:
                    print(
                        "  WARNING: banded-gather contract violations this step — node ordering decayed "
                        "past band_nodes; this step's gathers were inexact (sym_gather.band_violations)"
                    )

            if step % cfg.nsave_steps == 0 and step > 0:
                print(f"validating at step {step}...")
                monitor.start()
                _, summary = evaluate_split(sim, valid_loader, rollout, family)
                val_stats = monitor.stop()
                t_last = time.perf_counter()  # step times exclude validation
                if not summary:
                    print("  WARNING: validation split is empty — skipping")
                    continue
                logged = {
                    "val/loss": summary["total"],
                    **{f"val/loss-{t}": summary[t] for t in family.terms},
                    "val/rmse-oneStep": summary["one_step"],
                    "val/runtime": val_stats["elapsed_time"],
                    "val/vram_mb": val_stats["max_memory_mb"],
                }
                logged.update({f"val/{k}": summary[k] for k in ("mean_time", "std_time") if k in summary})
                logger.log(logged, step)
                print(
                    f"  val loss={summary['total']:.6f} (best {lowest_eval_loss:.6f}), "
                    f"{val_stats['elapsed_time']:.1f}s"
                )
                if summary["total"] < lowest_eval_loss:
                    lowest_eval_loss = summary["total"]
                    path = ckpt.save_best(train_state(sim, optimizer, step), step, lowest_eval_loss)
                    print(f"  new best -> {path.name}")
    except KeyboardInterrupt:
        interrupted = True  # the reference saves a fallback checkpoint on interrupt
        print("training interrupted")
    finally:
        source.close()
        train_step.close()
        logger.close()

    if interrupted or lowest_eval_loss == float("inf"):
        path = ckpt.save_final(train_state(sim, optimizer, step), step)
        print(f"saved fallback {path.name}")
    return {"step": step, "lowest_eval_loss": lowest_eval_loss}


def predict(cfg: TrainConfig, device: Device = None, devices: Optional[Sequence] = None,
            family: Optional[Family] = None) -> dict:
    """Rollout of ``family`` (default: ``cfg.architecture``'s) over valid
    (mode=valid) or test (mode=rollout) trajectories, on ``device`` (CUDA
    unless told otherwise); ``graph_parallel: P`` partitions each
    trajectory over the mesh of ``devices`` (first: ``device``) where the
    family has a partitioned ``predict`` (the multi-scale one ignores it,
    as JAX's). ``data_parallel`` plays no part in a rollout, as in JAX."""
    dev = resolve_device(device)
    family = family or family_of(cfg)
    metadata = load_metadata(cfg.data_path)
    sim_cfg = family.config_from(cfg, metadata)
    stats = family.stats(metadata, cfg.noise_std, device=dev)

    if cfg.model_file is None:
        print("error: valid/rollout modes require model_file", file=sys.stderr)
        sys.exit(1)
    sim = family.init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(cfg.model_file, map_location=dev)
    sim.load_state_dict(state["params"], strict=True)
    sim.eval()

    split = "test" if cfg.mode == "rollout" else "valid"
    loader = family.loader(cfg, sim_cfg, split)
    if cfg.graph_parallel > 1 and family.partitioned_predict is not None:
        rollout = family.partitioned_predict(cfg, sim_cfg, stats, loader, dev, devices)
    else:
        rollout = family.rollout(sim_cfg, stats, cfg.inference_mode, dev)
    monitor = ResourceMonitor(dev)
    monitor.start()
    outputs, summary = evaluate_split(sim, loader, rollout, family)
    run_stats = monitor.stop()

    if cfg.mode == "rollout":
        save_dir = Path(cfg.output_path) / cfg.run_name
        save_dir.mkdir(parents=True, exist_ok=True)
        case_names = metadata.get(f"file_{split}", [])
        for i, out in enumerate(outputs):
            name = case_names[i].replace(".npz", "") if i < len(case_names) else f"rollout_{i}"
            out["metadata"] = metadata
            out["case_name"] = name
            out["inference_mode"] = cfg.inference_mode
            with open(save_dir / f"{name}.pkl", "wb") as f:
                pickle.dump(out, f)
        print(f"saved {len(outputs)} rollout pickles to {save_dir}")

    print("=" * 70)
    print(f"{family.title} rollout summary ({dev})")
    print(f"  mean loss: {summary.get('total', float('nan')):.6f}")
    print(f"  total runtime: {run_stats['elapsed_time']:.2f}s")
    if outputs:
        print(f"  avg per rollout: {run_stats['elapsed_time'] / len(outputs):.2f}s")
    print(f"  peak device mem: {run_stats['max_memory_mb']:.1f}MB")
    print("=" * 70)
    return summary


def main(argv: Optional[list] = None, device: Device = None, family: Optional[Family] = None):
    """The CLI of ``train`` and ``predict`` (``family``: default
    ``cfg.architecture``'s)."""
    parser = argparse.ArgumentParser(description="GNN training and rollout (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--mode", type=str, choices=["train", "valid", "rollout"])
    parser.add_argument("--model_file", type=str)
    parser.add_argument("--log", type=str, choices=["True", "False"])
    parser.add_argument("--device", type=str, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(
        args.config,
        {"mode": args.mode, "model_file": args.model_file, "log": None if args.log is None else args.log == "True"},
    )
    print(f"config loaded from {args.config}; mode={cfg.mode}")
    run = train if cfg.mode == "train" else predict
    return run(cfg, device=args.device or device, family=family)


if __name__ == "__main__":
    main()
