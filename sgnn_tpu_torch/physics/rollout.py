"""Autoregressive rollout, one step captured in a CUDA graph.

Port of ``sgnn_tpu/physics/rollout.py``. Each step rebuilds the graph,
runs the flat forward (``predict_positions_flat``) and shifts the
window (``rollout_step``). JAX runs the steps as one compiled
``lax.scan`` (``make_jit_rollout``); here ``rollout`` captures the step in
a CUDA graph on the card and replays it
(``physics/captured_step.py``), and on the CPU runs the same step over
the same static buffers; ``capture=False`` takes the eager Python loop.
A call is one span ``rollout`` (a request's root: ``utils/profiling``),
with ``rollout.inputs`` (the arrays placed on the device) inside it.
Semantics kept from the reference evaluation loop:

  * erosional particles (type -1) follow the ground-truth trajectory and
    strain;
  * 'autoregressive' shifts the window with the prediction, 'one_step'
    with the ground truth;
  * cumulative RMSE sqrt(cumsum(mean sq) / t).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics.simulator import (
    LearnedSimulator,
    NormStats,
    SimulatorConfig,
    predict_positions_flat,
)
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.profiling import trace_region

EROSIONAL_PARTICLE_ID = -1


def _mean_sq(pred, gt, node_mask):
    t = pred.shape[0]
    sq = (pred - gt).square().reshape(t, pred.shape[1], -1)
    if node_mask is None:
        return sq.mean(dim=(1, 2))
    w = node_mask.to(sq.dtype)[None, :, None]
    return (sq * w).sum(dim=(1, 2)) / (w.sum() * sq.shape[-1])


def cumulative_rmse(
    pred: torch.Tensor, gt: torch.Tensor, node_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[T]: out[t] is the RMSE of the first t+1 steps pooled together."""
    mean_sq = _mean_sq(pred, gt, node_mask)
    steps = torch.arange(1, pred.shape[0] + 1, dtype=mean_sq.dtype, device=mean_sq.device)
    return torch.sqrt(torch.cumsum(mean_sq, dim=0) / steps)


def per_step_rmse(
    pred: torch.Tensor, gt: torch.Tensor, node_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[T] RMSE of each step on its own."""
    return torch.sqrt(_mean_sq(pred, gt, node_mask))


def advance_window(window, next_pos, strain, gt_pos, gt_strain, erosional, inference_mode: str):
    """The end of a step (the body of the JAX scan): erosional particles
    take the ground truth; the window shifts by the prediction
    ('autoregressive') or by the ground truth ('one_step').
    Returns (new window, next positions, strain)."""
    next_pos = torch.where(erosional, gt_pos, next_pos)
    strain = torch.where(erosional[:, 0], gt_strain, strain)
    fill = next_pos if inference_mode == "autoregressive" else gt_pos
    return torch.cat([window[:, 1:], fill[:, None, :]], dim=1), next_pos, strain


def rollout_step(sim: LearnedSimulator, cfg: SimulatorConfig, stats: NormStats, inference_mode: str):
    """The step ``(window [N, S, dim], gt_pos [N, dim], gt_strain [N], *,
    particle_types, node_mask, erosional) -> (new window, next positions,
    strain)``: no host sync and no host data, so it can be captured."""

    def step(window, gt_pos, gt_strain, *, particle_types, node_mask, erosional):
        next_pos, strain = predict_positions_flat(sim, cfg, stats, window, particle_types, node_mask)
        return advance_window(window, next_pos, strain, gt_pos, gt_strain, erosional, inference_mode)

    return step


@torch.inference_mode()
def rollout(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    positions,  # [N, T, dim] full ground-truth trajectory
    particle_types,  # [N]
    strains,  # [T, N]
    node_mask=None,  # [N] bool
    inference_mode: str = "autoregressive",
    device: Device = None,
    capture: bool = True,
) -> Dict[str, torch.Tensor]:
    """Roll the model out over a trajectory on ``device`` (CUDA unless
    told otherwise; ``sim`` and ``stats`` must already live there), its
    step captured in a CUDA graph on the card; ``capture=False`` runs the
    eager loop. Returns the reference's output dict as tensors."""
    if inference_mode not in ("autoregressive", "one_step"):
        raise ValueError(f"Unknown inference_mode: {inference_mode}")
    dev = resolve_device(device)
    if sim.device != dev:
        raise ValueError(f"simulator lives on {sim.device}, rollout asked for {dev}")
    with trace_region("rollout"):
        with trace_region("rollout.inputs"):
            positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
            particle_types = torch.as_tensor(particle_types, device=dev)
            strains = torch.as_tensor(strains, dtype=torch.float32, device=dev)
            if node_mask is not None:
                node_mask = torch.as_tensor(node_mask, dtype=torch.bool, device=dev)

        s = cfg.input_sequence_length
        window = positions[:, :s]  # [N, S, dim]
        gt_positions = positions[:, s:].transpose(0, 1)  # [T-S, N, dim]
        gt_strains = strains[s:]  # [T-S, N]
        erosional = (particle_types == EROSIONAL_PARTICLE_ID)[:, None]

        fixed = dict(particle_types=particle_types, node_mask=node_mask, erosional=erosional)
        key = ("rollout", cfg, inference_mode, captured_step.tensors_key(stats), captured_step.module_key(sim))
        pred_positions, pred_strains = captured_step.roll(
            rollout_step(sim, cfg, stats, inference_mode), window, gt_positions, gt_strains, fixed,
            capture=capture, owner=sim, key=key,
        )

        return {
            "initial_positions": positions[:, :s].transpose(0, 1),
            "initial_strains": strains[:s],
            "predicted_rollout": pred_positions,  # [T-S, N, dim]
            "ground_truth_rollout": gt_positions,
            "predicted_strain": pred_strains,  # [T-S, N]
            "ground_truth_strain": gt_strains,
            "particle_types": particle_types,
            "rmse_position": cumulative_rmse(pred_positions, gt_positions, node_mask),
            "rmse_strain": cumulative_rmse(pred_strains[..., None], gt_strains[..., None], node_mask),
        }
