"""Single-scale training, validation and rollout entry point.

Port of ``sgnn_tpu/train/train.py`` (single device): ``simulator_config_from``,
``lr_schedule``, ``make_train_step`` (the loss of ``_make_step_body``,
its backward and an Adam update), ``build_training`` (the model,
optimizer, step and batcher ``train`` runs), ``train``, ``make_rollout``
(the counterpart of ``make_jit_rollout``: the rollout whose step is
captured in a CUDA graph on the card, which ``predict`` and the
validation take), ``evaluate_split``, ``predict`` and the CLI::

  python -m sgnn_tpu_torch.train.train --config configs/taylor2d_single_scale.yaml \\
      --mode train|valid|rollout [--model_file NAME] [--device cuda|cpu]

Each training step draws random-walk noise from a ``torch.Generator``
seeded from ``cfg.seed``, runs the flat forward (every layer's edge stage
is the fused edge-block kernel, its backward the edge-block backward
kernel; the sender gathers sorted once per forward so that their
backward adds with no atomics), takes the masked position + strain loss,
its gradients, and one ``torch.optim.Adam`` update at ``lr = sched(step)``,
the step counted before the update as optax does. On the card the
batches come through ``data/prefetch.DevicePrefetcher`` (depth 2, as
JAX's trainer) and the step is captured in a CUDA graph and replayed
(``train/captured_train_step.TrainStep``; Adam is capturable, its lr a
device tensor); ``inner_steps`` are that many replays. Best-only
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
    ``data_parallel``) plans one static slab partition over the training
    split's first, middle and last frames (its radius widened by 4 sigma of
    the noise walk), x-sorts each sample into it (``partition_sample``) and
    trains with ``parallel/edge_partition.PartitionedTrainStep``, whose halo
    guard rejects a step inside the step; a ``RejectionTracker`` aborts
    after 20 consecutive rejected log points. Validation and ``predict``
    roll out with ``make_partitioned_host_rollout`` (re-planning when the
    guard fires).

With every replica or shard on one device, the step is captured as one
CUDA graph.

The capacity knobs reach the model through the config: ``remat`` (the
layers' recomputation in the backward, ``models/epd_flat.py``) and
``band_nodes`` (the banded gathers, ``ops/sym_gather.py``). With a band the
loss adds ``train/band_violations`` (edges that broke it, counted inside
the captured step; a graph-parallel step folds them into its halo guard,
which rejects the step), and the trainer warns at a log point where it is
above 0. ``debug_graph: true`` audits the first training sample's graph
before training (``utils/graph_debug.audit_neighbor_list``).

``architecture: meshgraphnet`` trains and rolls out MeshGraphNets
(``physics/mesh_simulator.py``) through the same feed, step, validation
and ``predict``: ``MeshSampleBatcher`` attaches each sample's static mesh,
the loss is ``make_mesh_loss_fn``'s, and each rolled-out trajectory's mesh
is built from its first frame (``make_rollout``). Its slot widths
(``mesh_slots``, ``world_search_slots``, ``world_slots``) are derived from
the training split where the config leaves them unset; it runs on one
device in f32 (``check_architecture``).
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from sgnn_tpu_torch.data.loader import (
    MeshSampleBatcher,
    SampleBatcher,
    TrajectoryLoader,
    load_metadata,
    load_trajectories,
)
from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
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
from sgnn_tpu_torch.physics.mesh_simulator import MeshSimulatorConfig, build_mesh, derive_slots, mesh_simulator_init
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
from sgnn_tpu_torch.utils.resource_monitor import ResourceMonitor

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8  # optax.adam's defaults
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


ARCHITECTURES = ("gns", "meshgraphnet")


def check_architecture(cfg: TrainConfig) -> None:
    """The architecture is known; MeshGraphNets runs on one device, in
    f32, without the single-scale model's capacity knobs."""
    if cfg.architecture not in ARCHITECTURES:
        raise ValueError(f"architecture must be one of {ARCHITECTURES}, got {cfg.architecture!r}")
    if cfg.architecture == "meshgraphnet":
        unsupported = {"data_parallel": cfg.data_parallel > 1, "graph_parallel": cfg.graph_parallel > 1,
                       "remat": check_remat(cfg.remat) is not False, "band_nodes": cfg.band_nodes is not None,
                       "symmetric_gather": bool(cfg.symmetric_gather), "debug_graph": cfg.debug_graph,
                       "compute_dtype": cfg.compute_dtype != "float32"}
        named = sorted(k for k, v in unsupported.items() if v)
        if named:
            raise ValueError(f"architecture meshgraphnet does not take {', '.join(named)}")


def mesh_config_from(cfg: TrainConfig, metadata: dict, data_dir: Path) -> MeshSimulatorConfig:
    """The MeshGraphNets simulator's config; slot widths the config leaves
    unset are derived from the training split (``derive_slots``) and
    printed."""
    slots = {k: getattr(cfg, k) for k in ("mesh_slots", "world_search_slots", "world_slots")}
    if None in slots.values():
        derived = derive_slots(load_trajectories(data_dir / "train.npz"), cfg.mesh_radius, cfg.world_radius)
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


def model_config_from(cfg: TrainConfig, metadata: dict, data_dir: Path):
    """The simulator config of ``cfg.architecture``."""
    check_architecture(cfg)
    if cfg.architecture == "meshgraphnet":
        return mesh_config_from(cfg, metadata, data_dir)
    return simulator_config_from(cfg, metadata)


def model_init(sim_cfg, cfg: TrainConfig, device: torch.device) -> torch.nn.Module:
    """The simulator of ``sim_cfg``'s architecture, its weights from ``cfg.seed``."""
    init = mesh_simulator_init if isinstance(sim_cfg, MeshSimulatorConfig) else simulator_init
    return init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=device)


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


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


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
    sim: LearnedSimulator,
    sim_cfg: SimulatorConfig,
    stats: NormStats,
    cfg: TrainConfig,
    optimizer: torch.optim.Optimizer,
    generator: Optional[torch.Generator] = None,
) -> TrainStep:
    """The step ``(batch, step, noise=None) -> metrics``: updates ``sim``'s
    parameters in place through ``optimizer``, captured in a CUDA graph on
    the card (``TrainStep``). ``step`` is the count of updates before this
    one (the schedule's argument); ``noise`` replaces the draw from
    ``generator`` (the parity tests inject JAX's). Metrics are 0-d tensors
    left on the device. A MeshGraphNets config takes its own loss."""
    make = make_mesh_loss_fn if isinstance(sim_cfg, MeshSimulatorConfig) else make_loss_fn
    return TrainStep(make(sim, sim_cfg, stats, cfg), optimizer, lr_schedule(cfg), cfg.noise_std, generator)


@dataclass
class Training:
    """What ``build_training`` wires together for ``train`` (of either
    family: the multi-scale trainer fills it with its own simulator and
    batcher); ``mesh`` and ``spec`` for a parallel run."""

    sim: torch.nn.Module
    sim_cfg: object
    stats: NormStats
    optimizer: torch.optim.Adam
    step_fn: TrainStep
    batcher: SampleBatcher
    mesh: Optional[Mesh] = None
    spec: Optional[PartitionSpec1D] = None

    def epochs(self) -> Iterator[dict]:
        """The training batches, endlessly; for a graph-parallel run each
        sample x-sorted into the plan's slabs (``partition_sample``)."""
        source = self.batcher.epochs()
        if self.spec is None:
            return source
        return (partition_sample(b, self.spec) for b in source)


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


def build_training(
    cfg: TrainConfig, device: torch.device, batch_size: Optional[int] = None, devices: Optional[Sequence] = None
) -> Training:
    """The model from ``cfg.seed``, its optimizer, the training step (noise
    from a generator seeded from ``cfg.seed``; data- or graph-parallel over
    the mesh of ``devices`` when the config asks) and the batcher of the
    training split; ``batch_size`` overrides ``cfg.batch_size``."""
    check_parallel(cfg)
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = model_config_from(cfg, metadata, data_dir)
    stats = make_norm_stats(metadata, cfg.noise_std, device=device)
    sim = model_init(sim_cfg, cfg, device)
    optimizer = make_optimizer(sim, cfg)
    noise_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    kw = dict(pad_multiple=cfg.pad_multiple, seed=cfg.seed)
    if isinstance(sim_cfg, MeshSimulatorConfig):
        batcher = MeshSampleBatcher(data_dir / "train.npz", cfg.input_sequence_length, batch_size or cfg.batch_size,
                                    mesh_radius=sim_cfg.mesh_radius, mesh_slots=sim_cfg.mesh_slots, **kw)
    else:
        batcher = SampleBatcher(data_dir / "train.npz", cfg.input_sequence_length, batch_size or cfg.batch_size, **kw)
    mesh, spec = parallel_mesh(cfg, device, devices), None
    sched = lr_schedule(cfg)
    if cfg.data_parallel > 1:
        step_fn = DataParallelStep(lambda m, d: make_loss_fn(m, sim_cfg, stats.to(d), cfg), sim, mesh, optimizer, sched,
                                   cfg.noise_std, noise_gen)
    elif cfg.graph_parallel > 1:
        # plan with a noise margin: the step adds a random walk of cumulative
        # std noise_std * sqrt(S - 1) at the last frame, 4 sigma of it on
        # each of two nodes, so that the guard does not fire on clean frames
        plan_radius = cfg.connection_radius + 4.0 * cfg.noise_std * float(
            np.sqrt(max(cfg.input_sequence_length - 1, 1)))
        spec = dataset_partition_plan(partition_frames(batcher.trajectories), cfg.graph_parallel, plan_radius)
        step_fn = PartitionedTrainStep(mesh, sim_cfg, stats, spec, sim, optimizer, sched, cfg.noise_std, noise_gen,
                                       loss_weight_position=cfg.loss_weight_position,
                                       loss_weight_strain=cfg.loss_weight_strain)
    else:
        step_fn = make_train_step(sim, sim_cfg, stats, cfg, optimizer, noise_gen)
    return Training(sim, sim_cfg, stats, optimizer, step_fn, batcher, mesh, spec)


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
    """The rollout ``predict`` and the validation run: its step captured in
    a CUDA graph on the card (``physics/captured_step.py``), the
    counterpart of JAX's ``make_jit_rollout``. A MeshGraphNets config
    builds each trajectory's mesh from its first frame first."""

    def _rollout(sim, positions, types, strains, node_mask):
        mesh = None
        if isinstance(sim_cfg, MeshSimulatorConfig):
            real = np.asarray(positions)[np.asarray(node_mask, bool)]
            mesh = build_mesh(real[:, 0], sim_cfg.mesh_radius, sim_cfg.mesh_slots, len(node_mask))
        return rollout_fn(
            sim, sim_cfg, stats, positions, types, strains,
            node_mask=node_mask, inference_mode=mode, device=device, mesh=mesh,
        )

    return _rollout


def make_partitioned_host_rollout(
    mesh: Mesh, sim_cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D, mode: str
) -> Callable:
    """The graph-parallel rollout with host-side partitioning and re-planning
    (``edge_partition.make_replanning_rollout``), with ``make_rollout``'s
    call signature, so ``evaluate_split`` takes it unchanged."""
    run = make_replanning_rollout(mesh, sim_cfg, stats, spec, inference_mode=mode)

    def _rollout(sim, positions, types, strains, node_mask):
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


def evaluate_split(
    sim: LearnedSimulator,
    sim_cfg: SimulatorConfig,
    stats: NormStats,
    loader: TrajectoryLoader,
    rollout: Callable,
):
    """Roll out every trajectory of the loader; (per-case outputs, summary)."""
    outputs, losses = [], {"total": [], "position": [], "strain": [], "one_step": []}
    for traj in loader:
        t0 = time.perf_counter()
        out = rollout(
            sim, traj["positions"], traj["particle_type"], traj["strains"], traj["node_mask"]
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the device
        out["run_time"] = time.perf_counter() - t0
        outputs.append(out)
        losses["position"].append(out["rmse_position"][-1])
        losses["strain"].append(out["rmse_strain"][-1])
        losses["total"].append(out["rmse_position"][-1] + out["rmse_strain"][-1])
        losses["one_step"].append(out["rmse_position"][0] + out["rmse_strain"][0])
    summary = {k: float(np.mean(v)) for k, v in losses.items() if v}
    return outputs, summary


def train(cfg: TrainConfig, device: Device = None, devices: Optional[Sequence] = None) -> dict:
    """Train on ``device`` (CUDA unless told otherwise; a parallel run over
    the mesh of ``devices``, whose first is ``device``); returns
    ``{"step", "lowest_eval_loss"}``."""
    dev = resolve_device(device)
    check_parallel(cfg)
    inner = max(1, int(cfg.inner_steps))
    for name in ("log_every", "nsave_steps", "ntraining_steps"):
        if getattr(cfg, name) % inner:
            raise ValueError(f"{name}={getattr(cfg, name)} must be a multiple of inner_steps={inner}")
    built = build_training(cfg, dev, devices=devices)
    sim, sim_cfg, stats, optimizer = built.sim, built.sim_cfg, built.stats, built.optimizer
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

    batcher, train_step = built.batcher, built.step_fn
    valid_loader = TrajectoryLoader(Path(cfg.data_path) / "valid.npz", pad_multiple=cfg.pad_multiple)
    if built.spec is not None:
        rollout = make_partitioned_host_rollout(built.mesh, sim_cfg, stats, built.spec, cfg.inference_mode)
        print(f"graph-parallel: {cfg.graph_parallel} shards x {built.spec.nodes_per_shard} nodes "
              f"(halo {built.spec.halo})")
    else:
        rollout = make_rollout(sim_cfg, stats, cfg.inference_mode, dev)
    if cfg.data_parallel > 1:
        print(f"data-parallel over {cfg.data_parallel} replicas")
    monitor = ResourceMonitor(dev)
    sched = lr_schedule(cfg)
    rejection_tracker = RejectionTracker(limit=REJECTION_LIMIT)
    if isinstance(sim_cfg, MeshSimulatorConfig):
        graph = (f"mesh_slots={sim_cfg.mesh_slots} world_slots={sim_cfg.world_slots} "
                 f"(search {sim_cfg.world_search_slots})")
    else:
        graph = f"slots={sim_cfg.slots} symmetric_gather={sim_cfg.symmetric_gather}"
    print(
        f"training: {cfg.architecture} layers={cfg.layers} hidden={cfg.hidden_dim} batch={cfg.batch_size} "
        f"nodes_padded={batcher.num_nodes} {graph} dtype={cfg.compute_dtype} "
        f"steps={cfg.ntraining_steps} device={dev}"
    )

    if cfg.debug_graph:
        audit_first_sample(built.batcher, sim_cfg, cfg.connection_radius)

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
                print(
                    f"step {step}: loss={metrics['train/loss']:.6f} "
                    f"pos={metrics['train/loss-position']:.6f} "
                    f"strain={metrics['train/loss-strain']:.6f} ({dt * 1e3:.1f} ms/step)"
                )
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
                _, summary = evaluate_split(sim, sim_cfg, stats, valid_loader, rollout)
                val_stats = monitor.stop()
                t_last = time.perf_counter()  # step times exclude validation
                if not summary:
                    print("  WARNING: validation split is empty — skipping")
                    continue
                logger.log(
                    {
                        "val/loss": summary["total"],
                        "val/loss-position": summary["position"],
                        "val/loss-strain": summary["strain"],
                        "val/rmse-oneStep": summary["one_step"],
                        "val/runtime": val_stats["elapsed_time"],
                        "val/vram_mb": val_stats["max_memory_mb"],
                    },
                    step,
                )
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


def predict(cfg: TrainConfig, device: Device = None, devices: Optional[Sequence] = None) -> dict:
    """Rollout over valid (mode=valid) or test (mode=rollout) trajectories,
    on ``device`` (CUDA unless told otherwise); ``graph_parallel: P``
    partitions each trajectory over the mesh of ``devices`` (first:
    ``device``). ``data_parallel`` plays no part in a rollout, as in JAX."""
    dev = resolve_device(device)
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = model_config_from(cfg, metadata, data_dir)
    stats = make_norm_stats(metadata, cfg.noise_std, device=dev)

    if cfg.model_file is None:
        print("error: valid/rollout modes require model_file", file=sys.stderr)
        sys.exit(1)
    sim = model_init(sim_cfg, cfg, dev)
    state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(
        cfg.model_file, map_location=dev
    )
    sim.load_state_dict(state["params"], strict=True)
    sim.eval()

    split = "test" if cfg.mode == "rollout" else "valid"
    loader = TrajectoryLoader(data_dir / f"{split}.npz", pad_multiple=cfg.pad_multiple)
    if cfg.graph_parallel > 1:
        mesh = parallel_mesh(dataclasses.replace(cfg, data_parallel=1), dev, devices)
        spec = dataset_partition_plan(partition_frames(loader.trajectories), cfg.graph_parallel, cfg.connection_radius)
        rollout = make_partitioned_host_rollout(mesh, sim_cfg, stats, spec, cfg.inference_mode)
        print(f"graph-parallel rollout: {cfg.graph_parallel} shards x {spec.nodes_per_shard} nodes "
              f"(halo {spec.halo})")
    else:
        rollout = make_rollout(sim_cfg, stats, cfg.inference_mode, dev)
    monitor = ResourceMonitor(dev)
    monitor.start()
    outputs, summary = evaluate_split(sim, sim_cfg, stats, loader, rollout)
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
    print(f"rollout summary ({dev})")
    print(f"  mean loss: {summary.get('total', float('nan')):.6f}")
    print(f"  total runtime: {run_stats['elapsed_time']:.2f}s")
    if outputs:
        print(f"  avg per rollout: {run_stats['elapsed_time'] / len(outputs):.2f}s")
    print(f"  peak device mem: {run_stats['max_memory_mb']:.1f}MB")
    print("=" * 70)
    return summary


def main(argv: Optional[list] = None, device: Device = None):
    parser = argparse.ArgumentParser(description="Single-scale GNN training and rollout (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--mode", type=str, choices=["train", "valid", "rollout"])
    parser.add_argument("--model_file", type=str)
    parser.add_argument("--log", type=str, choices=["True", "False"])
    parser.add_argument("--device", type=str, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    overrides = {
        "mode": args.mode,
        "model_file": args.model_file,
        "log": None if args.log is None else args.log == "True",
    }
    cfg = load_config(args.config, overrides)
    print(f"config loaded from {args.config}; mode={cfg.mode}")
    if cfg.mode == "train":
        return train(cfg, device=args.device or device)
    return predict(cfg, device=args.device or device)


if __name__ == "__main__":
    main()
