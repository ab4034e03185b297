"""The learned particle simulator: features, graph, model, integration.

Port of ``sgnn_tpu/physics/simulator.py`` (inference and the training
forward ``predict_accelerations[_batched]``). The
parameters live in ``LearnedSimulator``, an ``nn.Module`` whose
``state_dict()`` keys are the reference ``LearnedSimulator`` layout
(``_encode_process_decode.*`` and, with several particle types,
``_particle_type_embedding.weight``); the steps are plain functions of
the module, a frozen ``SimulatorConfig`` and ``NormStats``.

Contract (as in the JAX module): node features are the normalized
velocity finite differences plus the clamped wall distance
``clamp(x - wall_x, 0, R)`` (plus a type
embedding when there are several types); edge features are
``(p_sender - p_receiver) / R`` and its norm; the graph is rebuilt every
call (strict ``< R``, self loops, per-receiver cap); the head emits dim
accelerations plus one strain channel; integration is Euler with dt=1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from sgnn_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecode,
    EPDConfig,
    encode_process_decode_apply,
)
from sgnn_tpu_torch.models.epd_flat import (
    check_remat,
    edge_features_from,
    encode_process_decode_apply_flat,
    encode_process_decode_apply_flat_fused,
    flatten_batch_graph,
)
from sgnn_tpu_torch.nn.core import Embedding
from sgnn_tpu_torch.ops.neighbors import (
    NeighborList,
    radius_neighbors,
    radius_neighbors_grid_batched,
)
from sgnn_tpu_torch.ops.sym_gather import band_violations, reverse_edge_positions
from sgnn_tpu_torch.utils.device import Device, resolve_device

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class NormStats(NamedTuple):
    """Normalization statistics (metadata-derived, noise folded into std)."""

    vel_mean: torch.Tensor  # [dim]
    vel_std: torch.Tensor
    acc_mean: torch.Tensor
    acc_std: torch.Tensor

    def to(self, device) -> "NormStats":
        """The statistics on ``device`` (a replica's or a shard's)."""
        return NormStats(*(t.to(device) for t in self))


def make_norm_stats(metadata: dict, noise_std: float, device: Device = "cpu") -> NormStats:
    """std = sqrt(std^2 + noise^2), as the reference simulator builder."""

    def t(key):
        return torch.as_tensor(metadata[key], dtype=torch.float32, device=device)

    return NormStats(
        vel_mean=t("vel_mean"),
        vel_std=torch.sqrt(t("vel_std") ** 2 + noise_std**2),
        acc_mean=t("acc_mean"),
        acc_std=torch.sqrt(t("acc_std") ** 2 + noise_std**2),
    )


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Static hyperparameters of the single-scale simulator (the fields of
    the JAX ``SimulatorConfig`` that inference and training read)."""

    dim: int = 2
    latent_dim: int = 64
    num_message_passing_steps: int = 5
    num_mlp_layers: int = 1
    connectivity_radius: float = 0.6
    input_sequence_length: int = 11
    num_particle_types: int = 1
    particle_type_embedding_size: int = 9
    max_neighbors: int = 20
    # physical slot count; defaults to max_neighbors (same semantics while
    # every degree fits)
    neighbor_slots: Optional[int] = None
    # gather-based backward for the sender gathers (ops/sym_gather.py);
    # valid only when the graph is symmetric: the dataset's max degree
    # fits the slots, so the neighbour cap never binds
    symmetric_gather: bool = False
    # 'float32' or 'bfloat16': dtype of the edge latents in the flat path
    compute_dtype: str = "float32"
    wall_x: float = -2.0
    # static spatial domain enabling the batched cell-list search
    domain: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    # max occupants read per search cell; must cover the densest cell
    cell_capacity: int = 8
    # the search of compute_neighbors: 'auto' (the cell list when a domain
    # is given, else brute force) | 'grid' | 'bruteforce'
    neighbor_method: str = "auto"
    # max |sender - receiver| node index distance of a spatially sorted
    # ordering: gathers past JAX's table thresholds take the banded index
    # (ops/sym_gather.py); forward_batched(return_aux=True) counts the
    # edges that break it. None = off
    band_nodes: Optional[int] = None
    # node count up to which a symmetric graph takes the packed gather
    # (ops/sym_gather.packed_sym_gather); above it the reverse index is
    # built apart and the unfused route runs, as in JAX. The two routes
    # are bit-equal. On an H100 (80GB HBM3, 700 W; chip_smoke.py phase
    # 12) the packed route's captured training step was faster at every
    # size timed: 25.09 / 25.51 ms at 77,824 nodes, 180.0 / 183.0 at
    # 614,400 and 354.8 / 360.8 at 1,228,800 (packed / unfused, bf16,
    # K = 8). No crossover was found, so the ceiling is the largest size
    # timed. JAX's 800,000 is its TPU compiler's single-buffer ceiling,
    # which the take kernel does not have.
    packed_gather_max_nodes: int = 1_228_800
    # rematerialisation of the processor layers in the backward:
    # False | True ("xj") | "xj_msg" | "full" | "group" (models/epd_flat.py)
    remat: object = False

    @property
    def slots(self) -> int:
        return self.neighbor_slots or self.max_neighbors

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
        return self.dim + 1  # accelerations + strain

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        return _DTYPES[self.compute_dtype]

    def epd_config(self) -> EPDConfig:
        return EPDConfig(
            node_in=self.node_in,
            edge_in=self.edge_in,
            node_out=self.node_out,
            latent_dim=self.latent_dim,
            num_message_passing_steps=self.num_message_passing_steps,
            num_mlp_layers=self.num_mlp_layers,
        )


class LearnedSimulator(nn.Module):
    """Parameters in the reference ``LearnedSimulator`` key layout."""

    def __init__(self, cfg: SimulatorConfig, *, generator=None, device=None):
        super().__init__()
        self._encode_process_decode = EncodeProcessDecode(
            cfg.epd_config(), generator=generator, device=device
        )
        if cfg.num_particle_types > 1:
            self._particle_type_embedding = Embedding(
                cfg.num_particle_types,
                cfg.particle_type_embedding_size,
                generator=generator,
                device=device,
            )

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def simulator_init(
    cfg: SimulatorConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device: Device = None,
) -> LearnedSimulator:
    """A simulator with freshly drawn weights (from ``generator`` on the
    CPU), placed on ``device`` (CUDA unless told otherwise)."""
    return LearnedSimulator(cfg, generator=generator, device=resolve_device(device))


def time_diff(position_sequence: torch.Tensor) -> torch.Tensor:
    """[..., S, dim] -> [..., S-1, dim] finite-difference velocities."""
    return position_sequence[..., 1:, :] - position_sequence[..., :-1, :]


def compute_neighbors(
    cfg: SimulatorConfig, positions: torch.Tensor, node_mask: Optional[torch.Tensor] = None
) -> NeighborList:
    return radius_neighbors(
        positions,
        cfg.connectivity_radius,
        max_neighbors=cfg.slots,
        node_mask=node_mask,
        domain=cfg.domain,
        method=cfg.neighbor_method,
        cell_capacity=cfg.cell_capacity,
    )


def _node_features_batched(sim, cfg, stats, position_sequences, particle_types):
    """Node features on [..., S, dim] sequences (batched or not)."""
    most_recent = position_sequences[..., -1, :]
    norm_vel = (time_diff(position_sequences) - stats.vel_mean) / stats.vel_std
    feats = [norm_vel.reshape(*position_sequences.shape[:-2], -1)]
    feats.append(torch.clamp(most_recent[..., 0:1] - cfg.wall_x, 0.0, cfg.connectivity_radius))
    if cfg.num_particle_types > 1:
        feats.append(sim._particle_type_embedding(particle_types))
    return torch.cat(feats, dim=-1)


def _edge_features(
    last: torch.Tensor, nl: NeighborList, radius: float, table: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[N, K, dim+1]: (p_sender - p_receiver)/R and its norm, masked. The
    senders index ``table`` (default: ``last``; a graph shard's extended
    array, ``parallel/edge_partition.py``)."""
    return edge_features_from((last if table is None else table)[nl.senders], last, nl.mask, radius)


def encoder_preprocess(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    position_sequence: torch.Tensor,  # [N, S, dim]
    particle_types: torch.Tensor,  # [N]
    node_mask: Optional[torch.Tensor] = None,  # [N] bool
) -> Tuple[torch.Tensor, torch.Tensor, NeighborList]:
    """(node_features [N, node_in], edge_features [N, K, dim+1], graph)."""
    most_recent = position_sequence[:, -1]
    nl = compute_neighbors(cfg, most_recent, node_mask)
    nf = _node_features_batched(sim, cfg, stats, position_sequence, particle_types)
    return nf, _edge_features(most_recent, nl, cfg.connectivity_radius), nl


def decoder_postprocess(
    stats: NormStats,
    normalized_acceleration: torch.Tensor,  # [N, dim]
    position_sequence: torch.Tensor,  # [N, S, dim]
) -> torch.Tensor:
    """Denormalize + Euler integrate, dt=1."""
    acceleration = normalized_acceleration * stats.acc_std + stats.acc_mean
    most_recent = position_sequence[..., -1, :]
    velocity = most_recent - position_sequence[..., -2, :]
    return most_recent + (velocity + acceleration)


def inverse_decoder_postprocess(
    stats: NormStats,
    next_position: torch.Tensor,  # [N, dim]
    position_sequence: torch.Tensor,  # [N, S, dim]
) -> torch.Tensor:
    """Exact inverse of the Euler update."""
    previous = position_sequence[..., -1, :]
    previous_velocity = previous - position_sequence[..., -2, :]
    acceleration = (next_position - previous) - previous_velocity
    return (acceleration - stats.acc_mean) / stats.acc_std


def predict_positions(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    current_positions: torch.Tensor,  # [N, S, dim]
    particle_types: torch.Tensor,
    node_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next positions + strain through the readable per-graph forward."""
    nf, ef, nl = encoder_preprocess(sim, cfg, stats, current_positions, particle_types, node_mask)
    pred = encode_process_decode_apply(sim._encode_process_decode, nf, ef, nl)
    next_positions = decoder_postprocess(stats, pred[:, : cfg.dim], current_positions)
    return next_positions, pred[:, -1]


def forward_batched(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    position_sequences: torch.Tensor,  # [B, N, S, dim]
    particle_types: torch.Tensor,  # [B, N]
    node_mask: Optional[torch.Tensor] = None,  # [B, N]
    return_aux: bool = False,
):
    """Batch forward through the flat block-diagonal model.

    With a spatial domain the radius search runs batched-flat (one
    cell-list search over all graphs); without one, each graph is
    preprocessed on its own (brute-force search) and flattened. With
    ``cfg.symmetric_gather`` and a domain, the sender gathers take the
    reverse-edge index: up to ``cfg.packed_gather_max_nodes`` nodes through
    the packed gather (edge features, reverse index and layer 0's senders
    in one gather, ``encode_process_decode_apply_flat_fused``), above it
    built apart for the unfused route, as JAX routes. ``cfg.band_nodes``
    and ``cfg.remat`` reach every gather and layer.
    Returns (normalized accelerations [B, N, dim], strain [B, N]), and with
    ``return_aux=True`` a third item ``{"band_violations": count}``
    (``ops/sym_gather.band_violations``, 0 without a band; a device
    tensor).
    """
    check_remat(cfg.remat)
    b, n = position_sequences.shape[:2]
    dev = position_sequences.device
    if node_mask is None:
        node_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    k = cfg.slots
    rev = None
    dtype = cfg.torch_compute_dtype
    if cfg.domain is not None:
        last = position_sequences[..., -1, :]
        nl = radius_neighbors_grid_batched(
            last,
            cfg.connectivity_radius,
            domain_min=tuple(cfg.domain[0]),
            domain_max=tuple(cfg.domain[1]),
            max_neighbors=k,
            node_mask=node_mask,
            cell_capacity=cfg.cell_capacity,
        )
        senders, mask = nl.senders, nl.mask  # [B*N, K] global flat indices
        nf = _node_features_batched(sim, cfg, stats, position_sequences, particle_types)
        nf = nf.reshape(b * n, -1)
        flat_last = last.reshape(b * n, -1)
        if cfg.symmetric_gather and b * n <= cfg.packed_gather_max_nodes:
            pred = encode_process_decode_apply_flat_fused(
                sim._encode_process_decode, nf, flat_last, senders, mask, cfg.connectivity_radius,
                compute_dtype=dtype, band_nodes=cfg.band_nodes, remat=cfg.remat,
            ).reshape(b, n, -1)
            return _with_aux((pred[..., : cfg.dim], pred[..., -1]), cfg, senders, mask, return_aux)
        ef = _edge_features(flat_last, nl, cfg.connectivity_radius)
        senders_flat = senders.reshape(-1)
        degrees = mask.sum(dim=-1, keepdim=True).float()
        if cfg.symmetric_gather:
            rev = reverse_edge_positions(senders, mask)
    else:
        per_graph = [
            encoder_preprocess(sim, cfg, stats, position_sequences[i], particle_types[i], node_mask[i])
            for i in range(b)
        ]
        nf = torch.cat([p[0] for p in per_graph])
        ef = torch.cat([p[1] for p in per_graph])
        senders = torch.stack([p[2].senders for p in per_graph])
        mask = torch.stack([p[2].mask for p in per_graph])
        senders_flat, degrees = flatten_batch_graph(senders, mask, n)
    pred = encode_process_decode_apply_flat(
        sim._encode_process_decode,
        nf,
        ef.reshape(b * n * k, -1),
        senders_flat,
        degrees,
        k,
        compute_dtype=dtype,
        rev=rev,
        band_nodes=cfg.band_nodes,
        remat=cfg.remat,
    ).reshape(b, n, -1)
    return _with_aux((pred[..., : cfg.dim], pred[..., -1]), cfg, senders, mask, return_aux)


def _with_aux(out: tuple, cfg: SimulatorConfig, senders: torch.Tensor, mask: torch.Tensor, return_aux: bool):
    """``out``, plus the guard metrics where asked for."""
    if not return_aux:
        return out
    if cfg.band_nodes is None:
        viol = torch.zeros((), dtype=torch.int64, device=senders.device)
    else:
        viol = band_violations(senders, mask, cfg.band_nodes)
    return out + ({"band_violations": viol},)


def predict_accelerations(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    next_positions: torch.Tensor,  # [N, dim]
    position_sequence_noise: torch.Tensor,  # [N, S, dim]
    position_sequence: torch.Tensor,  # [N, S, dim]
    particle_types: torch.Tensor,
    node_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward through the readable per-graph model: (predicted
    and target normalized accelerations, strain). The target is taken on
    the noise-adjusted next position, so the velocity noise cancels."""
    noisy = position_sequence + position_sequence_noise
    nf, ef, nl = encoder_preprocess(sim, cfg, stats, noisy, particle_types, node_mask)
    pred = encode_process_decode_apply(sim._encode_process_decode, nf, ef, nl)
    target = inverse_decoder_postprocess(stats, next_positions + position_sequence_noise[:, -1], noisy)
    return pred[:, : cfg.dim], target, pred[:, -1]


def predict_accelerations_batched(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    next_positions: torch.Tensor,  # [B, N, dim]
    position_sequence_noise: torch.Tensor,  # [B, N, S, dim]
    position_sequences: torch.Tensor,  # [B, N, S, dim]
    particle_types: torch.Tensor,  # [B, N]
    node_mask: Optional[torch.Tensor] = None,
    return_aux: bool = False,
):
    """Batched training forward through the flat model (the contract of
    ``predict_accelerations``); with ``return_aux=True`` a fourth item,
    ``forward_batched``'s guard metrics."""
    noisy = position_sequences + position_sequence_noise
    out = forward_batched(sim, cfg, stats, noisy, particle_types, node_mask, return_aux=return_aux)
    next_adjusted = next_positions + position_sequence_noise[..., -1, :]
    target_acc = inverse_decoder_postprocess(stats, next_adjusted, noisy)
    res = (out[0], target_acc, out[1])
    return res + (out[2],) if return_aux else res


def predict_positions_flat(
    sim: LearnedSimulator,
    cfg: SimulatorConfig,
    stats: NormStats,
    current_positions: torch.Tensor,  # [N, S, dim]
    particle_types: torch.Tensor,
    node_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-graph inference through the flat path (B=1)."""
    mask = None if node_mask is None else node_mask[None]
    norm_acc, strain = forward_batched(
        sim, cfg, stats, current_positions[None], particle_types[None], mask
    )
    return decoder_postprocess(stats, norm_acc[0], current_positions), strain[0]
