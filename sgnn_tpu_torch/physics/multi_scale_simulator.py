"""Multi-scale simulator: the single-scale contract over an injected
static multi-scale graph.

Port of ``sgnn_tpu/physics/multi_scale_simulator.py``:
``MultiScaleSimulatorConfig``, the parameter module
``MultiScaleSimulator`` (reference keys ``_multi_scale_gnn.*`` and, with
several particle types, ``_particle_type_embedding.weight``),
``multi_scale_simulator_init``, the features, ``_forward``,
``ms_predict_positions``, the training forwards
(``ms_predict_accelerations``, ``ms_forward_batched``,
``ms_predict_accelerations_batched``) and ``ms_rollout``, whose step
(``ms_rollout_step``) is captured in a CUDA graph on the card as the
single-scale one is (``physics/captured_step.py``). Family differences
kept from the reference:

  * the wall distance is normalised by the grid radius;
  * edge features normalise per edge type: grid radius for g2m and m2g,
    the coarsest scale's radius for m2m;
  * the static graph is built once per trajectory from t=0 positions
    and reused for every step (``graph_to`` moves it to the device once).

A training batch stacks each sample's own graph on a leading axis;
``ms_forward_batched`` flattens the batch into ONE block-diagonal graph
(``flatten_dense_ms_graph`` / ``flatten_ms_graph``), so every gather is a
flat row gather whose backward is one of the deterministic kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sgnn_tpu_torch.models.multi_scale import (
    MSGNNConfig,
    MultiScaleGNN,
    flatten_dense_ms_graph,
    flatten_ms_graph,
    multi_scale_gnn_apply,
    multi_scale_gnn_apply_dense,
)
from sgnn_tpu_torch.nn.core import Embedding
from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics.multi_scale_graph import (
    DenseStaticGraph,
    MultiScaleConfig,
    PaddedEdges,
    StaticGraph,
    sender_order,
)
from sgnn_tpu_torch.physics.rollout import EROSIONAL_PARTICLE_ID, advance_window, cumulative_rmse, per_step_rmse
from sgnn_tpu_torch.physics.simulator import (
    _DTYPES,
    NormStats,
    decoder_postprocess,
    inverse_decoder_postprocess,
    time_diff,
)
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.profiling import trace_region


@dataclasses.dataclass(frozen=True)
class MultiScaleSimulatorConfig:
    dim: int = 2
    latent_dim: int = 128
    num_message_passing_steps: int = 10
    num_mlp_layers: int = 2
    input_sequence_length: int = 11
    num_particle_types: int = 1
    particle_type_embedding_size: int = 9
    wall_x: float = -2.0
    num_scales: int = 2
    window_size: int = 2
    radius_multiplier: float = 2.0
    grid_spacing: float = 0.5
    max_neighbors: int = 24
    # 'float32' or 'bfloat16': dtype of the edge-sized tensors; LayerNorm
    # moments, node updates and the prediction head stay f32
    compute_dtype: str = "float32"

    @property
    def graph_config(self) -> MultiScaleConfig:
        return MultiScaleConfig(
            num_scales=self.num_scales,
            window_size=self.window_size,
            radius_multiplier=self.radius_multiplier,
            grid_spacing=self.grid_spacing,
            max_neighbors=self.max_neighbors,
        )

    @property
    def node_in(self) -> int:
        base = (self.input_sequence_length - 1) * self.dim + 1
        if self.num_particle_types > 1:
            base += self.particle_type_embedding_size
        return base

    @property
    def edge_in(self) -> int:
        return self.dim + 1

    @property
    def node_out(self) -> int:
        return self.dim + 1

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        return _DTYPES[self.compute_dtype]

    def gnn_config(self) -> MSGNNConfig:
        return MSGNNConfig(
            node_in=self.node_in,
            edge_in=self.edge_in,
            node_out=self.node_out,
            latent_dim=self.latent_dim,
            num_message_passing_steps=self.num_message_passing_steps,
            num_mlp_layers=self.num_mlp_layers,
        )


class MultiScaleSimulator(nn.Module):
    """Parameters in the reference ``MultiScaleSimulator`` key layout."""

    def __init__(self, cfg: MultiScaleSimulatorConfig, *, generator=None, device=None):
        super().__init__()
        self._multi_scale_gnn = MultiScaleGNN(cfg.gnn_config(), generator=generator, device=device)
        if cfg.num_particle_types > 1:
            self._particle_type_embedding = Embedding(
                cfg.num_particle_types, cfg.particle_type_embedding_size, generator=generator, device=device
            )

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def multi_scale_simulator_init(
    cfg: MultiScaleSimulatorConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device: Device = None,
) -> MultiScaleSimulator:
    """A simulator with freshly drawn weights (from ``generator`` on the
    CPU), placed on ``device`` (CUDA unless told otherwise)."""
    return MultiScaleSimulator(cfg, generator=generator, device=resolve_device(device))


def graph_to(graph, device: torch.device):
    """A StaticGraph or DenseStaticGraph of numpy arrays (or tensors) as
    the same graph of tensors on ``device``; COO edges built without their
    sender order get it here (``sender_order``, on the host)."""

    def edges(e):
        if isinstance(e, PaddedEdges) and e.order is None:
            e = e._replace(order=sender_order(*(torch.as_tensor(a).cpu().numpy() for a in (e.senders, e.mask))))
        return type(e)(*(torch.as_tensor(a, device=device) for a in e))

    if isinstance(graph, DenseStaticGraph):
        return DenseStaticGraph(g2m=edges(graph.g2m), m2m=tuple(edges(de) for de in graph.m2m), m2g=edges(graph.m2g))
    if isinstance(graph, StaticGraph):
        return StaticGraph(*(edges(e) for e in graph))
    raise TypeError(f"expected a StaticGraph or DenseStaticGraph, got {type(graph).__name__}")


def _edge_features_for(positions: torch.Tensor, edges, radius: float) -> torch.Tensor:
    """COO features [E, dim+1]: (p_sender - p_receiver) / radius and its norm."""
    disp = (positions[edges.senders] - positions[edges.receivers]) / radius
    dist = torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return torch.cat([disp, dist], dim=-1) * edges.mask[:, None].to(disp.dtype)


def _edge_features_dense(positions: torch.Tensor, de, radius: float) -> torch.Tensor:
    """Dense-slot features [R, K, dim+1] over DenseEdges."""
    disp = (positions[de.senders] - positions[de.recv][:, None, :]) / radius
    dist = torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return torch.cat([disp, dist], dim=-1) * de.mask[..., None].to(disp.dtype)


def _ms_edge_features(cfg: MultiScaleSimulatorConfig, most_recent: torch.Tensor, graph) -> Dict[str, object]:
    """Per-edge-type features; every m2m scale normalises by the ONE
    coarsest radius, as the reference's concatenated list does."""
    gc = cfg.graph_config
    if isinstance(graph, DenseStaticGraph):
        f = _edge_features_dense
        m2m = tuple(f(most_recent, de, gc.coarsest_radius) for de in graph.m2m)
    else:
        f = _edge_features_for
        m2m = f(most_recent, graph.m2m, gc.coarsest_radius)
    return {"g2m": f(most_recent, graph.g2m, gc.grid_radius), "m2m": m2m, "m2g": f(most_recent, graph.m2g, gc.grid_radius)}


def _ms_node_features(
    sim: MultiScaleSimulator,
    cfg: MultiScaleSimulatorConfig,
    stats: NormStats,
    position_sequence: torch.Tensor,  # [..., S, dim]
    particle_types: torch.Tensor,  # [...]
) -> torch.Tensor:
    most_recent = position_sequence[..., -1, :]
    norm_vel = (time_diff(position_sequence) - stats.vel_mean) / stats.vel_std
    feats = [norm_vel.reshape(*position_sequence.shape[:-2], -1)]
    grid_radius = cfg.graph_config.grid_radius
    feats.append(torch.clamp(most_recent[..., 0:1] - cfg.wall_x, 0.0, grid_radius) / grid_radius)
    if cfg.num_particle_types > 1:
        feats.append(sim._particle_type_embedding(particle_types))
    return torch.cat(feats, dim=-1)


def ms_encoder_preprocess(sim, cfg, stats, position_sequence, particle_types, graph):
    """(node features [N, node_in], edge features per type)."""
    node_features = _ms_node_features(sim, cfg, stats, position_sequence, particle_types)
    return node_features, _ms_edge_features(cfg, position_sequence[:, -1], graph)


def _forward(sim, cfg, stats, position_sequence, particle_types, graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised accelerations [N, dim], strain [N]) through the layout
    the graph has (dense or COO). A COO graph goes through the flattening
    of a batch of one (``flatten_ms_graph``: padding at the last node, so
    the receivers ascend and the sender order holds), as training's does."""
    if isinstance(graph, StaticGraph):
        graph = flatten_ms_graph(StaticGraph(*(PaddedEdges(*(a[None] for a in e)) for e in graph)),
                                 position_sequence.shape[0])
    node_f, edge_f = ms_encoder_preprocess(sim, cfg, stats, position_sequence, particle_types, graph)
    apply = multi_scale_gnn_apply_dense if isinstance(graph, DenseStaticGraph) else multi_scale_gnn_apply
    pred = apply(sim._multi_scale_gnn, node_f, edge_f, graph, compute_dtype=cfg.torch_compute_dtype)
    return pred[:, : cfg.dim], pred[:, -1]


def ms_predict_positions(sim, cfg, stats, current_positions, particle_types, graph):
    """Next positions [N, dim] (Euler, dt = 1) and strain [N]."""
    norm_acc, strain = _forward(sim, cfg, stats, current_positions, particle_types, graph)
    return decoder_postprocess(stats, norm_acc, current_positions), strain


def ms_predict_accelerations(sim, cfg, stats, next_positions, position_sequence_noise, position_sequence,
                             particle_types, graph):
    """The training forward of one graph: (predicted normalised
    accelerations [N, dim], target accelerations [N, dim], predicted
    strain [N]) of the noisy window."""
    noisy = position_sequence + position_sequence_noise
    pred_acc, pred_strain = _forward(sim, cfg, stats, noisy, particle_types, graph)
    next_adjusted = next_positions + position_sequence_noise[:, -1]
    return pred_acc, inverse_decoder_postprocess(stats, next_adjusted, noisy), pred_strain


def ms_forward_batched(
    sim: MultiScaleSimulator,
    cfg: MultiScaleSimulatorConfig,
    stats: NormStats,
    position_sequences: torch.Tensor,  # [B, N, S, dim]
    particle_types: torch.Tensor,  # [B, N]
    graph,  # batched StaticGraph or DenseStaticGraph of tensors ([B, ...] leaves)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised accelerations [B, N, dim], strain [B, N]) of the batch as
    ONE flat block-diagonal graph. Outputs at padded nodes are garbage the
    caller masks (padded nodes have no edges)."""
    b, n = position_sequences.shape[:2]
    dense = isinstance(graph, DenseStaticGraph)
    flat_graph = flatten_dense_ms_graph(graph, n) if dense else flatten_ms_graph(graph, n)
    nf = _ms_node_features(sim, cfg, stats, position_sequences, particle_types).reshape(b * n, -1)
    ef = _ms_edge_features(cfg, position_sequences[..., -1, :].reshape(b * n, -1), flat_graph)
    gnn, dt = sim._multi_scale_gnn, cfg.torch_compute_dtype
    if dense:
        pred = multi_scale_gnn_apply_dense(gnn, nf, ef, flat_graph, compute_dtype=dt)
    else:
        pred = multi_scale_gnn_apply(gnn, nf, ef, flat_graph, compute_dtype=dt)
    pred = pred.reshape(b, n, -1)
    return pred[..., : cfg.dim], pred[..., -1]


def ms_predict_accelerations_batched(sim, cfg, stats, next_positions, position_sequence_noise, position_sequences,
                                     particle_types, graph):
    """The batched training forward ([B, N, ...] inputs, a batched graph);
    the contract of ``ms_predict_accelerations``."""
    noisy = position_sequences + position_sequence_noise
    pred_acc, pred_strain = ms_forward_batched(sim, cfg, stats, noisy, particle_types, graph)
    next_adjusted = next_positions + position_sequence_noise[..., -1, :]
    return pred_acc, inverse_decoder_postprocess(stats, next_adjusted, noisy), pred_strain


def ms_rollout_step(sim: MultiScaleSimulator, cfg: MultiScaleSimulatorConfig, stats: NormStats, inference_mode: str):
    """The step ``(window [N, S, dim], gt_pos [N, dim], gt_strain [N], *,
    particle_types, erosional, graph) -> (new window, next positions,
    strain)`` over a static graph of tensors: no host sync and no host
    data, so it can be captured."""

    def step(window, gt_pos, gt_strain, *, particle_types, erosional, graph):
        next_pos, strain = ms_predict_positions(sim, cfg, stats, window, particle_types, graph)
        return advance_window(window, next_pos, strain, gt_pos, gt_strain, erosional, inference_mode)

    return step


@torch.inference_mode()
def ms_rollout(
    sim: MultiScaleSimulator,
    cfg: MultiScaleSimulatorConfig,
    stats: NormStats,
    positions,  # [N, T, dim] full ground-truth trajectory
    particle_types,  # [N]
    strains,  # [T, N]
    graph,  # StaticGraph or DenseStaticGraph (numpy or tensors)
    node_mask=None,  # [N] bool
    inference_mode: str = "autoregressive",
    device: Device = None,
    capture: bool = True,
) -> Dict[str, torch.Tensor]:
    """Roll the model out with the static graph held fixed, on ``device``
    (CUDA unless told otherwise; ``sim`` and ``stats`` must already live
    there), its step captured in a CUDA graph on the card (the graph is
    copied into the captured step's static buffers); ``capture=False``
    runs the eager loop. Erosional particles (type -1) follow the ground truth;
    'one_step' shifts the window with the ground truth. Returns the JAX
    ``ms_rollout``'s keys as tensors, per-step RMSE included."""
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
            graph = graph_to(graph, dev)

        s = cfg.input_sequence_length
        window = positions[:, :s]
        gt_positions = positions[:, s:].transpose(0, 1)  # [T-S, N, dim]
        gt_strains = strains[s:]
        erosional = (particle_types == EROSIONAL_PARTICLE_ID)[:, None]

        fixed = dict(particle_types=particle_types, erosional=erosional, graph=graph)
        key = ("ms_rollout", cfg, inference_mode, captured_step.tensors_key(stats), captured_step.module_key(sim))
        pred_positions, pred_strains = captured_step.roll(
            ms_rollout_step(sim, cfg, stats, inference_mode), window, gt_positions, gt_strains, fixed,
            capture=capture, owner=sim, key=key,
        )
        return {
            "initial_positions": positions[:, :s].transpose(0, 1),
            "initial_strains": strains[:s],
            "predicted_rollout": pred_positions,
            "ground_truth_rollout": gt_positions,
            "predicted_strain": pred_strains,
            "ground_truth_strain": gt_strains,
            "particle_types": particle_types,
            "rmse_position": cumulative_rmse(pred_positions, gt_positions, node_mask),
            "rmse_strain": cumulative_rmse(pred_strains[..., None], gt_strains[..., None], node_mask),
            # the reference's multi-scale evaluator scores per step
            "rmse_position_per_step": per_step_rmse(pred_positions, gt_positions, node_mask),
            "rmse_strain_per_step": per_step_rmse(pred_strains[..., None], gt_strains[..., None], node_mask),
        }
