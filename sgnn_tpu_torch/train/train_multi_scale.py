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
and strain at the last step, one_step at the first. Data-parallel and
graph-parallel runs are not ported yet (ROADMAP.md, Queue A item 6).
"""

from __future__ import annotations

import argparse
import pickle
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sgnn_tpu_torch.data.loader import load_metadata
from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
from sgnn_tpu_torch.data.static_graph_loader import MultiScaleSampleBatcher, MultiScaleTrajectoryLoader
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
from sgnn_tpu_torch.train.train import PREFETCH_DEPTH, Training, lr_schedule, make_optimizer
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
    as the same graph of tensors."""
    return {k: graph_to(v, device) if k == "graph" else torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


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
    def loss_fn(batch, noise):
        pred_acc, target_acc, pred_strain = ms_predict_accelerations_batched(
            sim, sim_cfg, stats, batch["next_position"], noise, batch["positions"], batch["particle_type"],
            batch["graph"],
        )
        mask = batch["node_mask"].to(pred_acc.dtype)  # [B, N]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss_pos = ((pred_acc - target_acc) ** 2).sum(dim=-1)
        loss_strain = (pred_strain - batch["next_strain"]) ** 2
        loss = cfg.loss_weight_position * loss_pos + cfg.loss_weight_strain * loss_strain
        aux = {
            "train/loss-position": (loss_pos * mask).sum() / denom,
            "train/loss-strain": (loss_strain * mask).sum() / denom,
        }
        return (loss * mask).sum() / denom, aux

    return TrainStep(loss_fn, optimizer, lr_schedule(cfg), cfg.noise_std, generator)


def _dense_row_advantage(cfg: TrainConfig) -> float:
    # the JAX trainer's rule: bf16 halves the dense layout's edge traffic,
    # so dense is taken up to twice the slot padding
    return 4.0 if cfg.compute_dtype == "bfloat16" else 2.0


def build_training(cfg: TrainConfig, device: torch.device, batch_size: Optional[int] = None) -> Training:
    """The model from ``cfg.seed``, its optimizer, the training step (noise
    from a generator seeded from ``cfg.seed``) and the batcher of the
    training split with its static graphs in the layout ``cfg.ms_dense``
    picks; ``batch_size`` overrides ``cfg.batch_size``."""
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = ms_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=device)
    sim = multi_scale_simulator_init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=device)
    optimizer = make_optimizer(sim, cfg)
    noise_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    step_fn = make_train_step(sim, sim_cfg, stats, cfg, optimizer, noise_gen)
    batcher = MultiScaleSampleBatcher(
        data_dir / "train.npz", cfg.input_sequence_length, batch_size or cfg.batch_size,
        ms_cfg=sim_cfg.graph_config, pad_multiple=cfg.pad_multiple, edge_pad_multiple=cfg.edge_pad_multiple,
        seed=cfg.seed, dense=cfg.ms_dense, dense_row_advantage=_dense_row_advantage(cfg),
        m2m_traversals=cfg.layers,
    )
    return Training(sim, sim_cfg, stats, optimizer, step_fn, batcher)


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


def _refuse_parallel(cfg: TrainConfig) -> None:
    if cfg.graph_parallel > 1 or cfg.data_parallel > 1:
        raise NotImplementedError(
            "data_parallel and graph_parallel are not ported yet (ROADMAP.md, Queue A item 6)"
        )


def _rollout_fn(sim_cfg: MultiScaleSimulatorConfig, stats: NormStats, mode: str, device: torch.device) -> Callable:
    """The rollout ``predict`` and the validation run: ``ms_rollout``, its
    step captured in a CUDA graph on the card."""

    def rollout(sim, positions, types, strains, node_mask, graph):
        return ms_rollout(sim, sim_cfg, stats, positions, types, strains, graph,
                          node_mask=node_mask, inference_mode=mode, device=device)

    return rollout


def train(cfg: TrainConfig, device: Device = None) -> dict:
    """Train on ``device`` (CUDA unless told otherwise); returns
    ``{"step", "lowest_eval_loss"}``."""
    dev = resolve_device(device)
    _refuse_parallel(cfg)
    inner = max(1, int(cfg.inner_steps))
    for name in ("log_every", "nsave_steps", "ntraining_steps"):
        if getattr(cfg, name) % inner:
            raise ValueError(f"{name}={getattr(cfg, name)} must be a multiple of inner_steps={inner}")
    built = build_training(cfg, dev)
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
    rollout = _rollout_fn(sim_cfg, stats, cfg.inference_mode, dev)
    monitor = ResourceMonitor(dev)
    sched = lr_schedule(cfg)
    print(
        f"multi-scale training: scales={cfg.num_scales} window={cfg.window_size} layers={cfg.layers} "
        f"hidden={cfg.hidden_dim} batch={cfg.batch_size} nodes_padded={batcher.num_nodes} "
        f"dtype={cfg.compute_dtype} steps={cfg.ntraining_steps} device={dev}"
    )

    logger = MetricLogger(ckpt_dir, use_wandb=cfg.log, project=cfg.project_name, run_name=cfg.run_name)
    source = DevicePrefetcher(batcher.epochs(), depth=PREFETCH_DEPTH, device=dev)
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
    on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    _refuse_parallel(cfg)
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
