"""The MeshGraphNets simulator on the Taylor bars: its features, its two
edge sets, its forward and its one-step training forward.

The Lagrangian variant of MeshGraphNets (``models/mesh_graph_net.py``;
Pfaff et al. 2021, FlagDynamic and DeformingPlate) over the port's
particles, with the port's head, loss, noise and Euler step
(``physics/simulator``):

  * the mesh is built once per trajectory on the host (``build_mesh``):
    every pair closer than ``mesh_radius`` in the first frame, no self
    pairs (on the bar's 0.5 lattice at 0.6: the 4 axis neighbours, the
    edges of its quad mesh); dense ``[N, mesh_slots]`` senders,
    prefix-compacted and ascending per receiver, with their stable sort
    order taken once (``StaticMesh.order``), so that the mesh gathers'
    backward is ``ops/row_gather.ordered_gather``'s sorted sum. Its span is
    ``graph.mesh`` (``nodes``, ``edges``, ``max_degree``);
  * the world edges are searched every step on the card (``world_edges``):
    the cell-list search (``ops/neighbors.radius_neighbors_grid_batched``)
    at ``world_radius`` keeping ``world_search_slots``, then self and mesh
    pairs taken out by comparing each slot with the receiver's mesh senders,
    and the rest re-compacted to ``world_slots`` by the search's own top-k;
    nothing is read back to the host, so the step can be captured;
  * node features: the normalised velocities of the window (one, at
    ``input_sequence_length`` 2) and the port's clamped wall distance
    ``clamp(x - wall_x, 0, connectivity_radius)`` (and a type embedding
    when there are several types); mesh edge features ``[u_ij, |u_ij|, x_ij,
    |x_ij|] / mesh_radius`` with u the first frame (the mesh space) and x
    the last position, world edge features ``[x_ij, |x_ij|] /
    world_radius``, each ``sender - receiver``;
  * the head emits dim normalised accelerations and one strain;
  * ``mesh_rollout`` rolls a trajectory out with its mesh held fixed.

``MeshSimulator.world_edge_count`` (int64 [2], not in the state dict) is a
device-side running sum of the valid world edges and of the world slots
(rows x ``world_slots``) of every forward: captured steps add to it at
every replay, and a reader takes differences around a stretch (the
benchmark's ``world_slot_fill.train``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.models.epd_flat import edge_features_from, sender_gather
from sgnn_tpu_torch.models.mesh_graph_net import EdgeSet, MeshGraphNet, MGNConfig, mesh_graph_net_apply
from sgnn_tpu_torch.nn.core import Embedding
from sgnn_tpu_torch.ops.neighbors import _INF, NeighborList, _finalize, radius_neighbors_grid_batched
from sgnn_tpu_torch.ops.row_gather import ordered_gather
from sgnn_tpu_torch.physics.multi_scale_graph import _radius_edges
from sgnn_tpu_torch.physics.simulator import (
    NormStats,
    _node_features_batched,
    decoder_postprocess,
    inverse_decoder_postprocess,
)
from sgnn_tpu_torch.physics.rollout import _roll_out, advance_window
from sgnn_tpu_torch.utils.device import Device, resolve_device
from sgnn_tpu_torch.utils.profiling import trace_region

MAX_SLOTS = 64  # the widest slot layout derive_slots gives


@dataclasses.dataclass(frozen=True)
class MeshSimulatorConfig:
    """Static hyperparameters of the MeshGraphNets simulator."""

    dim: int = 2
    latent_dim: int = 128
    num_message_passing_steps: int = 15
    num_mlp_layers: int = 2
    # the clamp of the wall-distance node feature (the port's feature)
    connectivity_radius: float = 0.6
    mesh_radius: float = 0.6
    world_radius: float = 0.75
    input_sequence_length: int = 2
    num_particle_types: int = 1
    particle_type_embedding_size: int = 9
    mesh_slots: int = 4
    world_search_slots: int = 12
    world_slots: int = 8
    wall_x: float = -2.0
    # static spatial domain of the world edges' cell-list search
    domain: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    cell_capacity: int = 8

    def __post_init__(self):
        if self.domain is None:
            raise ValueError("the world edges' search needs a static domain (domain_min / domain_max, "
                             "or the dataset's pos_min / pos_max)")
        if self.world_slots > self.world_search_slots:
            raise ValueError(f"world_slots {self.world_slots} > world_search_slots {self.world_search_slots}")

    @property
    def node_in(self) -> int:
        base = (self.input_sequence_length - 1) * self.dim + 1
        if self.num_particle_types > 1:
            base += self.particle_type_embedding_size
        return base

    def net_config(self) -> MGNConfig:
        return MGNConfig(
            node_in=self.node_in,
            mesh_edge_in=2 * (self.dim + 1),
            world_edge_in=self.dim + 1,
            node_out=self.dim + 1,  # accelerations + strain
            latent_dim=self.latent_dim,
            num_message_passing_steps=self.num_message_passing_steps,
            num_mlp_layers=self.num_mlp_layers,
        )


class StaticMesh(NamedTuple):
    """The mesh of one trajectory (or stacked ``[B, ...]``): numpy on the
    host, tensors on the card."""

    senders: object  # int64[N, mesh_slots] node ids; padded slots hold the row's own id
    mask: object  # bool[N, mesh_slots]
    order: object  # int64[N * mesh_slots] the stable argsort of the flat senders
    rest: object  # f32[N, dim] the first frame: mesh-space positions


def _mesh_pairs(first_frame: np.ndarray, radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) of the first frame's pairs closer than radius, no self."""
    edges = _radius_edges(np.asarray(first_frame, np.float64), radius, MAX_SLOTS + 1)
    keep = edges.senders != edges.receivers
    return edges.senders[keep], edges.receivers[keep]


def build_mesh(first_frame: np.ndarray, radius: float, slots: int, num_nodes: int) -> StaticMesh:
    """The mesh of a trajectory whose real particles' first frame is
    ``first_frame`` [n, dim], laid out for ``num_nodes`` padded nodes, the
    real ones first as the loaders pad them (span ``graph.mesh``)."""
    n = first_frame.shape[0]
    with trace_region("graph.mesh", nodes=n) as span:
        snd, rcv = _mesh_pairs(first_frame, radius)
        deg = np.bincount(rcv, minlength=n)
        max_degree = int(deg.max()) if n else 0
        if max_degree > slots:
            raise ValueError(f"a mesh node has {max_degree} mesh neighbours, mesh_slots is {slots}")
        senders = np.repeat(np.arange(num_nodes, dtype=np.int64)[:, None], slots, axis=1)
        mask = np.zeros((num_nodes, slots), bool)
        # receiver-major, senders ascending per receiver (the search's order)
        order = np.lexsort((snd, rcv))
        snd, rcv = snd[order], rcv[order]
        slot = np.arange(len(rcv)) - np.searchsorted(rcv, rcv)
        senders[rcv, slot] = snd
        mask[rcv, slot] = True
        rest = np.zeros((num_nodes, first_frame.shape[1]), np.float32)
        rest[:n] = first_frame
        if span is not None:
            span.attrs.update(edges=int(len(snd)), max_degree=max_degree)
    flat = senders.reshape(-1)
    return StaticMesh(senders, mask, np.argsort(flat, kind="stable").astype(np.int64), rest)


def _round_slots(width: int) -> int:
    """8, or the next multiple of 4 (the single-scale trainer's rounding)."""
    return 8 if width <= 8 else -(-width // 4) * 4


def derive_slots(trajectories: Sequence, mesh_radius: float, world_radius: float) -> dict:
    """The slot widths from a split's trajectories (positions [T, n, dim]
    first): ``mesh_slots`` the largest mesh degree; ``world_search_slots``
    and ``world_slots`` the largest degree at ``world_radius`` over every
    frame, self included, and without self and mesh pairs, each + 2 (noise
    can move a pair across the radius) and rounded as the single-scale
    trainer rounds ``neighbor_slots``."""
    from scipy.spatial import cKDTree

    mesh_slots, search, world = 0, 0, 0
    for traj in trajectories:
        pos = traj[0]
        n = pos.shape[1]
        snd, rcv = _mesh_pairs(pos[0], mesh_radius)
        if len(rcv):
            mesh_slots = max(mesh_slots, int(np.bincount(rcv).max()))
        mesh_keys = np.sort(rcv * n + snd)
        for frame in pos:
            pairs = cKDTree(frame).query_pairs(world_radius, output_type="ndarray")
            both = np.concatenate([pairs, pairs[:, ::-1]])  # (receiver, sender)
            off_mesh = ~np.isin(both[:, 0] * n + both[:, 1], mesh_keys)
            search = max(search, 1 + int(np.bincount(both[:, 0], minlength=n).max(initial=0)))
            world = max(world, int(np.bincount(both[off_mesh, 0], minlength=n).max(initial=0)))
    out = {"mesh_slots": max(mesh_slots, 1), "world_search_slots": _round_slots(search + 2),
           "world_slots": _round_slots(world + 2)}
    if max(out.values()) > MAX_SLOTS:
        raise ValueError(f"slot widths {out} exceed {MAX_SLOTS}")
    return out


class MeshSimulator(nn.Module):
    """Parameters: ``_encode_process_decode`` (``MeshGraphNet``) and, with
    several particle types, ``_particle_type_embedding``; the buffer
    ``world_edge_count`` (see the module docstring)."""

    def __init__(self, cfg: MeshSimulatorConfig, *, generator=None, device=None):
        super().__init__()
        self._encode_process_decode = MeshGraphNet(cfg.net_config(), generator=generator, device=device)
        if cfg.num_particle_types > 1:
            self._particle_type_embedding = Embedding(cfg.num_particle_types, cfg.particle_type_embedding_size,
                                                      generator=generator, device=device)
        self.register_buffer("world_edge_count", torch.zeros(2, dtype=torch.int64, device=device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def mesh_simulator_init(cfg: MeshSimulatorConfig, *, generator: Optional[torch.Generator] = None,
                        device: Device = None) -> MeshSimulator:
    """A simulator with freshly drawn weights (from ``generator`` on the
    CPU), placed on ``device`` (CUDA unless told otherwise)."""
    return MeshSimulator(cfg, generator=generator, device=resolve_device(device))


def world_edges(cfg: MeshSimulatorConfig, last: torch.Tensor, node_mask: torch.Tensor,
                mesh_senders: torch.Tensor, mesh_mask: torch.Tensor) -> NeighborList:
    """[B*N, world_slots] world edges of positions ``last`` [B, N, dim]
    (global flat ids): the radius search's pairs less self and the mesh's
    (``mesh_senders`` / ``mesh_mask`` [B*N, mesh_slots], global flat ids),
    re-compacted, the lowest sender ids kept."""
    b, n, _ = last.shape
    nl = radius_neighbors_grid_batched(
        last, cfg.world_radius, domain_min=tuple(cfg.domain[0]), domain_max=tuple(cfg.domain[1]),
        max_neighbors=cfg.world_search_slots, node_mask=node_mask, cell_capacity=cfg.cell_capacity,
    )
    rows = torch.arange(b * n, device=last.device)[:, None]
    on_mesh = ((nl.senders[:, :, None] == mesh_senders[:, None, :]) & mesh_mask[:, None, :]).any(dim=-1)
    keep = nl.mask & ~on_mesh & (nl.senders != rows)
    return _finalize(torch.where(keep, nl.senders, _INF), cfg.world_slots)


def _mesh_gather(senders: torch.Tensor, order: torch.Tensor, num_nodes: int):
    """The per-layer mesh sender gather over the host's sender order:
    ``ordered_gather`` where gradients are taken, else ``index_select``."""
    if not torch.is_grad_enabled():
        return lambda table: table.index_select(0, senders)
    sorted_idx = senders[order]
    return lambda table: ordered_gather(table, senders, order, sorted_idx, num_nodes)


def forward_batched(
    sim: MeshSimulator,
    cfg: MeshSimulatorConfig,
    stats: NormStats,
    position_sequences: torch.Tensor,  # [B, N, S, dim]
    particle_types: torch.Tensor,  # [B, N]
    node_mask: Optional[torch.Tensor],  # [B, N]
    mesh: StaticMesh,  # tensors, each with a leading [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised accelerations [B, N, dim], strain [B, N]) over one flat
    block-diagonal graph of the batch."""
    b, n = position_sequences.shape[:2]
    dev = position_sequences.device
    m, km, kw = b * n, cfg.mesh_slots, cfg.world_slots
    if node_mask is None:
        node_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    last = position_sequences[..., -1, :]
    flat_last = last.reshape(m, -1)
    rest = mesh.rest.reshape(m, -1)
    offsets = torch.arange(b, device=dev)[:, None, None] * n
    mesh_senders = (mesh.senders + offsets).reshape(m, km)
    mesh_mask = mesh.mask.reshape(m, km)
    mesh_order = (mesh.order.reshape(b, -1) + offsets[:, 0] * km).reshape(-1)
    world = world_edges(cfg, last, node_mask, mesh_senders, mesh_mask)
    sim.world_edge_count[0].add_(world.mask.sum())
    sim.world_edge_count[1].add_(world.mask.numel())

    nf = _node_features_batched(sim, cfg, stats, position_sequences, particle_types).reshape(m, -1)
    mesh_feats = torch.cat([
        edge_features_from(rest[mesh_senders], rest, mesh_mask, cfg.mesh_radius),
        edge_features_from(flat_last[mesh_senders], flat_last, mesh_mask, cfg.mesh_radius),
    ], dim=-1)
    world_feats = edge_features_from(flat_last[world.senders], flat_last, world.mask, cfg.world_radius)
    flat_mesh = mesh_senders.reshape(-1)
    mesh_set = EdgeSet(mesh_feats.reshape(m * km, -1), mesh_mask.sum(dim=-1, keepdim=True).float(),
                       _mesh_gather(flat_mesh, mesh_order, m), km)
    world_set = EdgeSet(world_feats.reshape(m * kw, -1), world.mask.sum(dim=-1, keepdim=True).float(),
                        sender_gather(world.senders.reshape(-1), m), kw)
    pred = mesh_graph_net_apply(sim._encode_process_decode, nf, mesh_set, world_set).reshape(b, n, -1)
    return pred[..., : cfg.dim], pred[..., -1]


def predict_accelerations_batched(
    sim: MeshSimulator,
    cfg: MeshSimulatorConfig,
    stats: NormStats,
    next_positions: torch.Tensor,  # [B, N, dim]
    position_sequence_noise: torch.Tensor,  # [B, N, S, dim]
    position_sequences: torch.Tensor,  # [B, N, S, dim]
    particle_types: torch.Tensor,  # [B, N]
    node_mask: Optional[torch.Tensor],  # [B, N]
    mesh: StaticMesh,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward: (predicted and target normalised accelerations,
    strain), the target taken on the noise-adjusted next position (the
    contract of ``simulator.predict_accelerations_batched``)."""
    noisy = position_sequences + position_sequence_noise
    acc, strain = forward_batched(sim, cfg, stats, noisy, particle_types, node_mask, mesh)
    target = inverse_decoder_postprocess(stats, next_positions + position_sequence_noise[..., -1, :], noisy)
    return acc, target, strain


def predict_positions(
    sim: MeshSimulator,
    cfg: MeshSimulatorConfig,
    stats: NormStats,
    current_positions: torch.Tensor,  # [N, S, dim]
    particle_types: torch.Tensor,  # [N]
    node_mask: Optional[torch.Tensor],  # [N]
    mesh: StaticMesh,  # one trajectory's, on the device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next positions and strain of one graph (a batch of one)."""
    acc, strain = forward_batched(sim, cfg, stats, current_positions[None], particle_types[None],
                                  None if node_mask is None else node_mask[None],
                                  StaticMesh(*(t[None] for t in mesh)))
    return decoder_postprocess(stats, acc[0], current_positions), strain[0]


def mesh_rollout_step(sim: MeshSimulator, cfg: MeshSimulatorConfig, stats: NormStats, inference_mode: str):
    """``physics/rollout.rollout_step`` of a MeshGraphNets simulator, whose
    step also takes the trajectory's static mesh (a ``StaticMesh`` of
    tensors)."""

    def step(window, gt_pos, gt_strain, *, particle_types, node_mask, erosional, mesh):
        next_pos, strain = predict_positions(sim, cfg, stats, window, particle_types, node_mask, mesh)
        return advance_window(window, next_pos, strain, gt_pos, gt_strain, erosional, inference_mode)

    return step


def mesh_rollout(
    sim: MeshSimulator,
    cfg: MeshSimulatorConfig,
    stats: NormStats,
    positions,  # [N, T, dim] full ground-truth trajectory
    particle_types,  # [N]
    strains,  # [T, N]
    mesh: StaticMesh,  # the trajectory's (``build_mesh`` of its first frame)
    node_mask=None,  # [N] bool
    inference_mode: str = "autoregressive",
    device: Device = None,
    capture: bool = True,
) -> Dict[str, torch.Tensor]:
    """``physics/rollout.rollout`` of a MeshGraphNets simulator: the
    trajectory's static mesh is held fixed over the steps
    (``mesh_rollout_step``)."""
    return _roll_out(sim, cfg, stats, mesh_rollout_step, "mesh_rollout", positions, particle_types, strains,
                     node_mask, inference_mode, device, capture,
                     lambda dev, mask: {"node_mask": mask, "mesh": StaticMesh(*(torch.as_tensor(a, device=dev)
                                                                               for a in mesh))})


def stack_meshes(meshes: List[StaticMesh]) -> StaticMesh:
    """Meshes of one padded size stacked on a leading batch axis."""
    return StaticMesh(*(np.stack(parts) for parts in zip(*meshes)))
