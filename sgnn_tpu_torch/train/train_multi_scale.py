"""Multi-scale training, validation and rollout entry point.

Port of ``sgnn_tpu/train/train_multi_scale.py`` (single device):
``ms_config_from``, ``lr_schedule``, ``make_train_step``,
``build_training`` (the model, optimizer, step and batcher ``train``
runs), ``train``, ``evaluate_split``, ``predict`` and the CLI::

  python -m sgnn_tpu_torch.train.train_multi_scale --config configs/taylor2d_multi_scale.yaml \\
      --mode train|valid|rollout [--model_file NAME] [--device cuda|cpu]

Each training step draws random-walk noise from a ``torch.Generator``
seeded from ``cfg.seed``, runs the batched forward over the batch's
per-sample static graphs flattened into one (``ms_forward_batched``:
every latent-row gather is the row-gather kernel, its backward the sorted
segment sum or the transpose plan's kernel), takes the masked position +
strain loss, its gradients, and one ``torch.optim.Adam`` update at
``lr = sched(step)`` (optax's defaults, ``train.train.make_optimizer``).
On the card the batches, their static graphs included, come through
``data/prefetch.DevicePrefetcher`` and the step is captured in a CUDA
graph and replayed (``train/captured_train_step.TrainStep``), as in the
single-scale trainer; ``inner_steps`` are that many replays. Best-only
checkpoints on the validation rollout loss, a final one when no
validation ran or on interrupt, resume from ``model_file``.

``predict`` restores the simulator from a train-state checkpoint
(``{"params", "opt_state", "step"}``, ``train/checkpoint.py``), builds one
static graph per trajectory in the layout ``ms_dense`` picks (``"auto"``,
True or False) and rolls every trajectory out with ``ms_rollout``, its
step captured in a CUDA graph on the card (``_rollout_fn``, the
counterpart of JAX's ``make_jit_rollout``; the validation takes it too). The
multi-scale family scores a rollout by its PER-STEP RMSE: total, position
and strain at the last step, one_step at the first.

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

import argparse
import hashlib
import pickle
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sgnn_tpu_torch.data.loader import SampleBatcher, load_metadata
from sgnn_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from sgnn_tpu_torch.data.static_graph_loader import MultiScaleSampleBatcher, MultiScaleTrajectoryLoader
from sgnn_tpu_torch.parallel.data_parallel import DataParallelStep
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
from sgnn_tpu_torch.physics.simulator import NormStats, make_norm_stats
from sgnn_tpu_torch.train.captured_train_step import TrainStep
from sgnn_tpu_torch.train.checkpoint import CheckpointManager, load_optimizer_state, train_state
from sgnn_tpu_torch.train.config import TrainConfig, load_config
from sgnn_tpu_torch.train.metrics import MetricLogger
from sgnn_tpu_torch.train.train import (
    PREFETCH_DEPTH,
    Training,
    check_parallel,
    lr_schedule,
    make_optimizer,
    parallel_mesh,
)
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.resource_monitor import ResourceMonitor


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


def make_train_step(
    sim: MultiScaleSimulator,
    sim_cfg: MultiScaleSimulatorConfig,
    stats: NormStats,
    cfg: TrainConfig,
    optimizer: torch.optim.Optimizer,
    generator: Optional[torch.Generator] = None,
) -> TrainStep:
    """The step ``(batch, step, noise=None) -> metrics``: updates ``sim``'s
    parameters in place through ``optimizer``, captured in a CUDA graph on
    the card (``TrainStep``). ``step`` is the count of
    updates before this one (the schedule's argument); ``noise`` replaces
    the draw from ``generator`` (the parity tests inject JAX's). Metrics
    (the JAX step's names) are 0-d tensors left on the device."""
    return TrainStep(make_loss_fn(sim, sim_cfg, stats, cfg), optimizer, lr_schedule(cfg), cfg.noise_std, generator)


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


def build_training(
    cfg: TrainConfig, device: torch.device, batch_size: Optional[int] = None, devices: Optional[Sequence] = None
) -> Training:
    """The model from ``cfg.seed``, its optimizer, the training step (noise
    from a generator seeded from ``cfg.seed``; data- or graph-parallel over
    the mesh of ``devices`` when the config asks) and the batcher of the
    training split with its static graphs in the layout ``cfg.ms_dense``
    picks (graph-parallel: a plain batcher and one partition plan per
    trajectory); ``batch_size`` overrides ``cfg.batch_size``."""
    check_parallel(cfg)
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = ms_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=device)
    sim = multi_scale_simulator_init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=device)
    optimizer = make_optimizer(sim, cfg)
    noise_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    mesh = parallel_mesh(cfg, device, devices)
    if cfg.graph_parallel > 1:
        # the partition plans replace the batcher's static graphs
        batcher = SampleBatcher(data_dir / "train.npz", cfg.input_sequence_length, batch_size or cfg.batch_size,
                                pad_multiple=cfg.pad_multiple, seed=cfg.seed)
        # ms_dense: True partitions the dense layout; "auto" and False stay COO
        spec, plans = ms_dataset_partition(sim_cfg.graph_config, [pos[0] for pos, _, _ in batcher.trajectories],
                                           cfg.graph_parallel, layout="dense" if cfg.ms_dense is True else "coo")
        step_fn = MSPartitionedTrainStep(mesh, sim_cfg, stats, spec, sim, optimizer, lr_schedule(cfg),
                                         cfg.noise_std, noise_gen, loss_weight_position=cfg.loss_weight_position,
                                         loss_weight_strain=cfg.loss_weight_strain)
        return MSPartitionedTraining(sim, sim_cfg, stats, optimizer, step_fn, batcher, mesh, spec,
                                     orders=[o for o, _ in plans],
                                     graphs=[sharded_graph_to(g, mesh.primary) for _, g in plans])
    if mesh is not None:
        step_fn = DataParallelStep(lambda m, d: make_loss_fn(m, sim_cfg, stats.to(d), cfg), sim, mesh, optimizer,
                                   lr_schedule(cfg), cfg.noise_std, noise_gen)
    else:
        step_fn = make_train_step(sim, sim_cfg, stats, cfg, optimizer, noise_gen)
    batcher = MultiScaleSampleBatcher(
        data_dir / "train.npz", cfg.input_sequence_length, batch_size or cfg.batch_size,
        ms_cfg=sim_cfg.graph_config, pad_multiple=cfg.pad_multiple, edge_pad_multiple=cfg.edge_pad_multiple,
        seed=cfg.seed, dense=cfg.ms_dense, dense_row_advantage=_dense_row_advantage(cfg),
        m2m_traversals=cfg.layers,
    )
    return Training(sim, sim_cfg, stats, optimizer, step_fn, batcher, mesh)


def evaluate_split(sim: MultiScaleSimulator, loader: MultiScaleTrajectoryLoader, rollout: Callable):
    """Roll out every trajectory of the loader; (per-case outputs, summary).
    The summary scores per-step RMSE (last step for total, position and
    strain; first step for one_step) plus the rollouts' mean_time and
    std_time, as the JAX multi-scale evaluator."""
    outputs, losses = [], {"total": [], "position": [], "strain": [], "one_step": []}
    for traj in loader:
        t0 = time.perf_counter()
        out = rollout(sim, traj["positions"], traj["particle_type"], traj["strains"], traj["node_mask"],
                      traj["graph"])
        out = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the device
        out["run_time"] = time.perf_counter() - t0
        outputs.append(out)
        pos, strain = out["rmse_position_per_step"], out["rmse_strain_per_step"]
        losses["position"].append(pos[-1])
        losses["strain"].append(strain[-1])
        losses["total"].append(pos[-1] + strain[-1])
        losses["one_step"].append(pos[0] + strain[0])
    summary = {k: float(np.mean(v)) for k, v in losses.items() if v}
    if outputs:
        times = [o["run_time"] for o in outputs]
        summary["mean_time"] = float(np.mean(times))
        summary["std_time"] = float(np.std(times))
    return outputs, summary


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


def train(cfg: TrainConfig, device: Device = None, devices: Optional[Sequence] = None) -> dict:
    """Train on ``device`` (CUDA unless told otherwise; a data- or
    graph-parallel run over the mesh of ``devices``, whose first is
    ``device``); returns ``{"step", "lowest_eval_loss"}``."""
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
    valid_loader = make_loader(cfg, sim_cfg, "valid")
    if cfg.graph_parallel > 1:
        rollout = make_ms_partitioned_host_rollout(built.mesh, sim_cfg, stats, built.spec, cfg.inference_mode,
                                                   frames=[pos[0] for pos, _, _ in valid_loader.trajectories])
        print(f"ms graph-parallel: {cfg.graph_parallel} shards x {built.spec.nodes_per_shard} nodes "
              f"(halo {built.spec.halo})")
    else:
        rollout = _rollout_fn(sim_cfg, stats, cfg.inference_mode, dev)
    monitor = ResourceMonitor(dev)
    sched = lr_schedule(cfg)
    print(
        f"multi-scale training: scales={cfg.num_scales} window={cfg.window_size} layers={cfg.layers} "
        f"hidden={cfg.hidden_dim} batch={cfg.batch_size} nodes_padded={batcher.num_nodes} "
        f"dtype={cfg.compute_dtype} steps={cfg.ntraining_steps} device={dev}"
    )

    if cfg.data_parallel > 1:
        print(f"data-parallel over {cfg.data_parallel} replicas")
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
                dt = (time.perf_counter() - t_last) / cfg.log_every
                t_last = time.perf_counter()
                metrics["train/step_time_s"] = dt
                logger.log(metrics, step)
                print(f"step {step}: loss={metrics['train/loss']:.6f} ({dt * 1e3:.1f} ms/step)")

            if step % cfg.nsave_steps == 0 and step > 0:
                print(f"validating at step {step}...")
                monitor.start()
                _, summary = evaluate_split(sim, valid_loader, rollout)
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
                        "val/mean_time": summary["mean_time"],
                        "val/std_time": summary["std_time"],
                    },
                    step,
                )
                print(f"  val loss={summary['total']:.6f} (best {lowest_eval_loss:.6f})")
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


def predict(cfg: TrainConfig, device: Device = None) -> dict:
    """Rollout over valid (mode=valid) or test (mode=rollout) trajectories,
    on ``device`` (CUDA unless told otherwise). Like JAX's, it ignores
    ``data_parallel`` and ``graph_parallel``: one device rolls out."""
    dev = resolve_device(device)
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = ms_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=dev)

    if cfg.model_file is None:
        print("error: valid/rollout modes require model_file", file=sys.stderr)
        sys.exit(1)
    sim = multi_scale_simulator_init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(cfg.model_file, map_location=dev)
    sim.load_state_dict(state["params"], strict=True)
    sim.eval()

    split = "test" if cfg.mode == "rollout" else "valid"
    loader = make_loader(cfg, sim_cfg, split)
    monitor = ResourceMonitor(dev)
    monitor.start()
    outputs, summary = evaluate_split(sim, loader, _rollout_fn(sim_cfg, stats, cfg.inference_mode, dev))
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
    print(f"multi-scale rollout summary ({dev})")
    print(f"  mean loss: {summary.get('total', float('nan')):.6f}")
    print(f"  total runtime: {run_stats['elapsed_time']:.2f}s")
    print(f"  peak device mem: {run_stats['max_memory_mb']:.1f}MB")
    print("=" * 70)
    return summary


def main(argv: Optional[list] = None, device: Device = None):
    parser = argparse.ArgumentParser(description="Multi-scale GNN training and rollout (PyTorch/CUDA)")
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
    if cfg.mode == "train":
        return train(cfg, device=args.device or device)
    return predict(cfg, device=args.device or device)


if __name__ == "__main__":
    main()
