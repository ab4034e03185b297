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
validation ran or on interrupt, resume from ``model_file``. Data-parallel,
graph-parallel and the graph audit are not ported yet (ROADMAP.md, Queue
A items 6 and 8).
"""

from __future__ import annotations

import argparse
import pickle
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sgnn_tpu_torch.data.loader import SampleBatcher, TrajectoryLoader, load_metadata
from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
from sgnn_tpu_torch.physics.rollout import rollout as rollout_fn
from sgnn_tpu_torch.physics.simulator import (
    LearnedSimulator,
    NormStats,
    SimulatorConfig,
    make_norm_stats,
    predict_accelerations_batched,
    simulator_init,
)
from sgnn_tpu_torch.train.captured_train_step import TrainStep
from sgnn_tpu_torch.train.checkpoint import CheckpointManager, load_optimizer_state, train_state
from sgnn_tpu_torch.train.config import TrainConfig, load_config
from sgnn_tpu_torch.train.metrics import MetricLogger
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.resource_monitor import ResourceMonitor

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8  # optax.adam's defaults
PREFETCH_DEPTH = 2  # batches staged ahead, as JAX's trainers


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
    domain = cfg.domain
    if domain is None and "pos_min" in metadata and "pos_max" in metadata:
        lo = np.asarray(metadata["pos_min"], np.float64)
        hi = np.asarray(metadata["pos_max"], np.float64)
        pad = 0.25 * (hi - lo) + 4 * cfg.connection_radius  # rollout-drift margin
        domain = (tuple(lo - pad), tuple(hi + pad))
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
        domain=domain,
        cell_capacity=cfg.cell_capacity,
        band_nodes=cfg.band_nodes,
        remat=cfg.remat,
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


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


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
    left on the device."""

    def loss_fn(batch, noise):
        pred_acc, target_acc, pred_strain = predict_accelerations_batched(
            sim, sim_cfg, stats, batch["next_position"], noise, batch["positions"],
            batch["particle_type"], batch["node_mask"],
        )
        mask = batch["node_mask"].to(pred_acc.dtype)  # [B, N]
        denom = torch.clamp(mask.sum(), min=1.0)
        sq_acc = (pred_acc - target_acc) ** 2  # [B, N, dim]
        loss_pos = sq_acc.sum(dim=-1)  # the reference sums the dims
        loss_strain = (pred_strain - batch["next_strain"]) ** 2
        loss = cfg.loss_weight_position * loss_pos + cfg.loss_weight_strain * loss_strain
        loss = (loss * mask).sum() / denom
        loss_xy = (sq_acc * mask[..., None]).sum(dim=(0, 1)) / denom
        aux = {
            "train/loss-position": (loss_pos * mask).sum() / denom,
            "train/loss-strain": (loss_strain * mask).sum() / denom,
            "train/loss-x": loss_xy[0],
            "train/loss-y": loss_xy[1],
        }
        if sim_cfg.dim == 3:
            aux["train/loss-z"] = loss_xy[2]
        return loss, aux

    return TrainStep(loss_fn, optimizer, lr_schedule(cfg), cfg.noise_std, generator)


@dataclass
class Training:
    """What ``build_training`` wires together for ``train`` (of either
    family: the multi-scale trainer fills it with its own simulator and
    batcher)."""

    sim: torch.nn.Module
    sim_cfg: object
    stats: NormStats
    optimizer: torch.optim.Adam
    step_fn: TrainStep
    batcher: SampleBatcher


def build_training(cfg: TrainConfig, device: torch.device, batch_size: Optional[int] = None) -> Training:
    """The model from ``cfg.seed``, its optimizer, the training step (noise
    from a generator seeded from ``cfg.seed``) and the batcher of the
    training split; ``batch_size`` overrides ``cfg.batch_size``."""
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = simulator_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=device)
    sim = simulator_init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=device)
    optimizer = make_optimizer(sim, cfg)
    noise_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    step_fn = make_train_step(sim, sim_cfg, stats, cfg, optimizer, noise_gen)
    batcher = SampleBatcher(
        data_dir / "train.npz", cfg.input_sequence_length, batch_size or cfg.batch_size,
        pad_multiple=cfg.pad_multiple, seed=cfg.seed,
    )
    return Training(sim, sim_cfg, stats, optimizer, step_fn, batcher)


def make_rollout(
    sim_cfg: SimulatorConfig, stats: NormStats, mode: str, device: torch.device
) -> Callable:
    """The rollout ``predict`` and the validation run: its step captured in
    a CUDA graph on the card (``physics/captured_step.py``), the
    counterpart of JAX's ``make_jit_rollout``."""

    def _rollout(sim, positions, types, strains, node_mask):
        return rollout_fn(
            sim, sim_cfg, stats, positions, types, strains,
            node_mask=node_mask, inference_mode=mode, device=device,
        )

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


def _refuse_parallel(cfg: TrainConfig) -> None:
    if cfg.graph_parallel > 1 or cfg.data_parallel > 1:
        raise NotImplementedError(
            "data_parallel and graph_parallel are not ported yet (ROADMAP.md, Queue A item 6)"
        )


def train(cfg: TrainConfig, device: Device = None) -> dict:
    """Train on ``device`` (CUDA unless told otherwise); returns
    ``{"step", "lowest_eval_loss"}``."""
    dev = resolve_device(device)
    _refuse_parallel(cfg)
    if cfg.debug_graph:
        raise NotImplementedError("debug_graph is not ported yet (ROADMAP.md, Queue A item 8)")
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
    valid_loader = TrajectoryLoader(Path(cfg.data_path) / "valid.npz", pad_multiple=cfg.pad_multiple)
    rollout = make_rollout(sim_cfg, stats, cfg.inference_mode, dev)
    monitor = ResourceMonitor(dev)
    sched = lr_schedule(cfg)
    print(
        f"training: layers={cfg.layers} hidden={cfg.hidden_dim} batch={cfg.batch_size} "
        f"nodes_padded={batcher.num_nodes} slots={sim_cfg.slots} "
        f"symmetric_gather={sim_cfg.symmetric_gather} dtype={cfg.compute_dtype} "
        f"steps={cfg.ntraining_steps} device={dev}"
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


def predict(cfg: TrainConfig, device: Device = None) -> dict:
    """Rollout over valid (mode=valid) or test (mode=rollout) trajectories,
    on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    _refuse_parallel(cfg)
    data_dir = Path(cfg.data_path)
    metadata = load_metadata(data_dir)
    sim_cfg = simulator_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=dev)

    if cfg.model_file is None:
        print("error: valid/rollout modes require model_file", file=sys.stderr)
        sys.exit(1)
    sim = simulator_init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(
        cfg.model_file, map_location=dev
    )
    sim.load_state_dict(state["params"], strict=True)
    sim.eval()

    split = "test" if cfg.mode == "rollout" else "valid"
    loader = TrajectoryLoader(data_dir / f"{split}.npz", pad_multiple=cfg.pad_multiple)
    monitor = ResourceMonitor(dev)
    monitor.start()
    outputs, summary = evaluate_split(
        sim, sim_cfg, stats, loader, make_rollout(sim_cfg, stats, cfg.inference_mode, dev)
    )
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
