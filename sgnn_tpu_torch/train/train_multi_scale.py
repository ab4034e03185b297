"""Multi-scale validation and rollout entry point.

Port of ``sgnn_tpu/train/train_multi_scale.py`` (serving, single device):
``ms_config_from``, ``evaluate_split``, ``predict`` and the CLI::

  python -m sgnn_tpu_torch.train.train_multi_scale --config configs/taylor2d_multi_scale.yaml \\
      --mode valid|rollout --model_file NAME [--device cuda|cpu]

``predict`` restores the simulator from a train-state checkpoint
(``{"params", "opt_state", "step"}``, ``train/checkpoint.py``), builds one
static graph per trajectory in the layout ``ms_dense`` picks (``"auto"``,
True or False) and rolls every trajectory out with ``ms_rollout``. The
multi-scale family scores a rollout by its PER-STEP RMSE: total, position
and strain at the last step, one_step at the first. ``--mode train``,
data-parallel and graph-parallel runs are not ported yet (ROADMAP.md,
Queue A items 5b and 6).
"""

from __future__ import annotations

import argparse
import pickle
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from sgnn_tpu_torch.data.loader import load_metadata
from sgnn_tpu_torch.data.static_graph_loader import MultiScaleTrajectoryLoader
from sgnn_tpu_torch.physics.multi_scale_simulator import (
    MultiScaleSimulator,
    MultiScaleSimulatorConfig,
    ms_rollout,
    multi_scale_simulator_init,
)
from sgnn_tpu_torch.physics.simulator import make_norm_stats
from sgnn_tpu_torch.train.checkpoint import CheckpointManager
from sgnn_tpu_torch.train.config import TrainConfig, load_config
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.resource_monitor import ResourceMonitor

NOT_PORTED_TRAIN = "multi-scale training is not ported yet (ROADMAP.md, Queue A item 5b)"


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
        # the JAX trainer's rule: bf16 halves the dense layout's edge
        # traffic, so dense is taken up to twice the slot padding
        dense_row_advantage=4.0 if cfg.compute_dtype == "bfloat16" else 2.0,
        m2m_traversals=cfg.layers,
    )


def _refuse_parallel(cfg: TrainConfig) -> None:
    if cfg.graph_parallel > 1 or cfg.data_parallel > 1:
        raise NotImplementedError(
            "data_parallel and graph_parallel are not ported yet (ROADMAP.md, Queue A item 6)"
        )


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

    def rollout(sim_, positions, types, strains, node_mask, graph):
        return ms_rollout(sim_, sim_cfg, stats, positions, types, strains, graph,
                          node_mask=node_mask, inference_mode=cfg.inference_mode, device=dev)

    monitor = ResourceMonitor(dev)
    monitor.start()
    outputs, summary = evaluate_split(sim, loader, rollout)
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
    parser = argparse.ArgumentParser(description="Multi-scale GNN validation and rollout (PyTorch/CUDA)")
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
        raise NotImplementedError(NOT_PORTED_TRAIN)
    return predict(cfg, device=args.device or device)


if __name__ == "__main__":
    main()
