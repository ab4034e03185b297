"""Edge-partitioned message passing: one big graph split across shards.

Port of ``sgnn_tpu/parallel/edge_partition.py`` (single scale). Nodes are
sorted along x and split into contiguous slabs of equal size, one per
shard of the mesh's graph axis. The interaction radius is small, so each
layer needs only a HALO EXCHANGE of the first and last ``halo`` rows of
each slab with its two neighbours.

JAX runs the shard function once per device under ``shard_map`` and
exchanges with ``ppermute``. Here one process drives every shard in
lockstep (``mesh.Mesh``; a mesh may put several shards on one device):

  * a shard is a plain tensor on its device; the halo exchange is slicing,
    ``torch.cat`` and ``.to(device)`` (``_halo_exchange``), so autograd
    carries a halo row's gradient back to the shard that owns it (the
    transpose of ``ppermute``), and boundary shards receive zeros;
  * ``_halo_guard`` stacks each shard's four x statistics in place of the
    ``all_gather`` and counts the broken conditions of the plan;
  * each shard searches its extended array (receivers: its own rows),
    encodes, and runs ``models/epd_flat._process_decode`` over all shards
    at once, whose per-layer gather hook exchanges every shard's sender
    projections and gathers each shard's senders from its ``[N_ext, H]``
    extended table (the fused edge-block kernel and, in training, the take
    kernel with the sorted-sum backward over the table's N_ext rows; at
    ``_SYM_MIN_LOCAL_ROWS`` local rows and more with ``symmetric_gather``,
    ``sym_gather`` over the extended rows' reverse index, kept to the local
    edges; up to ``packed_gather_max_nodes`` extended rows layer 0's
    senders, the edge features' sender positions and the reverse index
    come from one packed gather over the extended rows, as in JAX);
  * ``band_nodes`` gives the shard's gathers the banded index with the halo
    offset (``ops/sym_gather.py``), and the edges that break the band add
    to the halo guard's count, so a broken band rejects the step;
    ``remat`` checkpoints the layers over every shard at once (in
    ``"full"`` the halo exchange recomputes too);
  * a step whose shards sit on one device is one CUDA graph on the card:
    the training step (``PartitionedTrainStep``: the halo guard gates Adam
    inside the graph, parameters and Adam's state restored with
    ``torch.where`` when it fires) and the rollout step
    (``make_partitioned_rollout``, and ``make_replanning_rollout``, which
    re-sorts between steps and replays the same graph on new contents).
    Shards on several devices run eagerly.

The numpy planning (``PartitionSpec1D``, ``partition_plan``,
``dataset_partition_plan``, ``scatter_to_shards``, ``partition_sample``) is
this package's own copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sgnn_tpu_torch.models.encode_process_decode import mlp_ln_apply, split_first_layer
from sgnn_tpu_torch.models.epd_flat import (
    _process_decode,
    _slot_mask,
    check_remat,
    edge_features_from,
    sender_gather,
)
from sgnn_tpu_torch.ops.f32_product import linear
from sgnn_tpu_torch.ops.neighbors import NeighborList
from sgnn_tpu_torch.ops.sym_gather import band_violations, packed_sym_gather, reverse_edge_positions
from sgnn_tpu_torch.parallel.mesh import Mesh, Replicas
from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics.rollout import EROSIONAL_PARTICLE_ID, advance_window, cumulative_rmse
from sgnn_tpu_torch.physics.simulator import (
    LearnedSimulator,
    NormStats,
    SimulatorConfig,
    _node_features_batched,
    compute_neighbors,
    decoder_postprocess,
    inverse_decoder_postprocess,
)
from sgnn_tpu_torch.train.captured_train_step import Metrics, TrainStep, make_multi_step
from sgnn_tpu_torch.train.loss import one_step_loss


@dataclasses.dataclass(frozen=True)
class PartitionSpec1D:
    """Static plan for slab partitioning of one graph."""

    num_shards: int
    nodes_per_shard: int  # padded local node count
    halo: int  # boundary strip rows exchanged per side

    @property
    def total_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def ext_nodes(self) -> int:
        return self.nodes_per_shard + 2 * self.halo


def _halo_needed(xs: np.ndarray, per: int, num_shards: int, radius: float) -> int:
    """Rows each slab must export per side so the halo contract holds.

    For every slab boundary b = s*per, nodes with |x - x_b| <= radius must
    lie entirely in the two adjacent slabs and within ``halo`` rows of the
    boundary on each side. Raises if an interaction strip spans beyond the
    adjacent slabs.
    """
    n = len(xs)
    halo_needed = 0
    for s in range(1, num_shards):
        b = s * per
        if b >= n:
            break  # later shards are pure padding
        x_b = 0.5 * (xs[b - 1] + xs[b])
        i0 = int(np.searchsorted(xs, x_b - radius, side="left"))
        i1 = int(np.searchsorted(xs, x_b + radius, side="right"))
        if i0 < (s - 1) * per or i1 > (s + 1) * per:
            raise ValueError(
                f"boundary {s}: interaction strip spans beyond adjacent slabs "
                f"(strip [{i0},{i1}) vs slabs [{(s-1)*per},{(s+1)*per})); "
                "too many shards for this graph — reduce num_shards"
            )
        halo_needed = max(halo_needed, b - i0, i1 - b)
    return halo_needed


def _halo_rows(halo_needed: int, per: int, pad_multiple: int, halo_slack: float) -> int:
    halo = max(pad_multiple, -(-int(halo_needed * halo_slack) // pad_multiple) * pad_multiple)
    return min(halo, per)


def partition_plan(
    positions: np.ndarray,
    num_shards: int,
    radius: float,
    *,
    pad_multiple: int = 8,
    halo_slack: float = 1.5,
    nodes_per_shard: Optional[int] = None,
) -> Tuple[PartitionSpec1D, np.ndarray]:
    """Host-side: sort nodes by x, size the slabs and halos, validate.

    Returns (spec, order) where ``order`` is the permutation that sorts
    nodes by x. Pass ``nodes_per_shard`` to pin the slab size.
    """
    n = positions.shape[0]
    order = np.argsort(positions[:, 0], kind="stable")
    xs = positions[order, 0]
    if nodes_per_shard is None:
        per = -(-n // num_shards)
        per = -(-per // pad_multiple) * pad_multiple
    else:
        per = nodes_per_shard
        if per * num_shards < n:
            raise ValueError(f"nodes_per_shard {per} x {num_shards} shards < {n} nodes")
    halo = _halo_rows(_halo_needed(xs, per, num_shards, radius), per, pad_multiple, halo_slack)
    return PartitionSpec1D(num_shards, per, halo), order


def dataset_partition_plan(
    frames, num_shards: int, radius: float, *, pad_multiple: int = 8, halo_slack: float = 1.5
) -> PartitionSpec1D:
    """One static plan covering every frame in ``frames`` ([N, dim] position
    arrays): slab size from the largest frame, halo the max over frames
    (plus slack), every frame validated against the adjacency contract."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("dataset_partition_plan needs at least one frame")
    max_n = max(f.shape[0] for f in frames)
    per = -(-max_n // num_shards)
    per = -(-per // pad_multiple) * pad_multiple
    halo_needed = 0
    for f in frames:
        xs = np.sort(f[:, 0], kind="stable")
        halo_needed = max(halo_needed, _halo_needed(xs, per, num_shards, radius))
    return PartitionSpec1D(num_shards, per, _halo_rows(halo_needed, per, pad_multiple, halo_slack))


def scatter_to_shards(arr: np.ndarray, order: np.ndarray, spec: PartitionSpec1D) -> np.ndarray:
    """Reorder by ``order`` and pad the node axis (axis 0) to P*per."""
    arr = np.asarray(arr)[order]
    pad = spec.total_nodes - arr.shape[0]
    if pad:
        arr = np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
    return arr


def partition_sample(batch: dict, spec: PartitionSpec1D, *, sort_frame: int = -1) -> dict:
    """Host-side: one [1, N, ...] SampleBatcher batch -> a partitioned flat
    sample. Real (masked) nodes are x-sorted by ``positions[:, sort_frame,
    0]`` and padded to ``spec.total_nodes``; loader padding rows are dropped
    and re-appended at the end with ``node_mask`` False."""
    m = np.asarray(batch["node_mask"][0])
    idx = np.nonzero(m)[0]
    pos = np.asarray(batch["positions"][0])
    order = idx[np.argsort(pos[idx, sort_frame, 0], kind="stable")]
    nt = spec.total_nodes
    if len(order) > nt:
        raise ValueError(f"sample has {len(order)} nodes > plan capacity {nt}")
    out = {}
    for k in ("positions", "next_position", "next_strain", "particle_type"):
        a = np.asarray(batch[k][0])
        buf = np.zeros((nt, *a.shape[1:]), a.dtype)
        buf[: len(order)] = a[order]
        out[k] = buf
    mask = np.zeros(nt, bool)
    mask[: len(order)] = True
    out["node_mask"] = mask
    return out


# Sharded symmetric-gather backward threshold, the JAX module's: below it
# the plain gather's backward runs even when cfg.symmetric_gather is set.
_SYM_MIN_LOCAL_ROWS = 12_288


def _halo_exchange(xs: Sequence[torch.Tensor], halo: int, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Per shard s: cat([left neighbour's last ``halo`` rows, x_s, right
    neighbour's first ``halo`` rows]) on shard s's device; boundary shards
    receive zeros. Differentiable: a halo row's gradient reaches its owner."""
    out = []
    for s, (x, d) in enumerate(zip(xs, devices)):
        zeros = x.new_zeros((halo, *x.shape[1:]))
        left = xs[s - 1][-halo:].to(d) if s > 0 else zeros
        right = xs[s + 1][:halo].to(d) if s + 1 < len(xs) else zeros
        out.append(torch.cat([left, x, right]))
    return out


def _halo_guard(
    xs: Sequence[torch.Tensor],  # per shard [N_local] x coordinates (the sorted axis)
    masks: Sequence[torch.Tensor],  # per shard [N_local]
    halo: int,
    radius: float,
    primary: torch.device,
) -> torch.Tensor:
    """int64 count of broken halo-contract conditions (0: the static plan
    still covers this geometry), on ``primary``.

    Each shard publishes (min_x, max_x) over its masked nodes, min_x over
    nodes not in its first ``halo`` rows (not shipped left) and max_x over
    nodes not in its last ``halo`` rows (not shipped right); stacked, they
    flag for each shard s:
      * a right neighbour whose unshipped-left nodes come within ``radius``
        (in x) of s's extent,
      * its own unshipped-right nodes within ``radius`` of the right
        neighbour's extent,
      * any shard two or more slabs away whose x-extent comes within
        ``radius``.
    An empty shard's extent is (+inf, -inf), which flags nothing.
    """
    stats = []
    for x, m in zip(xs, masks):
        row = torch.arange(x.shape[0], device=x.device)
        tail = m & (row >= halo)  # not shipped to the left neighbour
        head = m & (row < x.shape[0] - halo)  # not shipped right
        stats.append(torch.stack([
            torch.where(m, x, math.inf).min(),
            torch.where(m, x, -math.inf).max(),
            torch.where(tail, x, math.inf).min(),
            torch.where(head, x, -math.inf).max(),
        ]).to(primary))
    g = torch.stack(stats)  # [P, 4]: rows s (own), columns t (the other shard)
    p = g.shape[0]
    s_idx = torch.arange(p, device=primary)[:, None]
    t_idx = torch.arange(p, device=primary)[None, :]
    own_min, own_max, own_head = g[:, None, 0], g[:, None, 1], g[:, None, 3]
    is_right = t_idx == s_idx + 1
    viol = is_right & (g[None, :, 2] < own_max + radius)
    viol |= is_right & (own_head > g[None, :, 0] - radius)
    gap = torch.maximum(g[None, :, 0] - own_max, own_min - g[None, :, 1])
    viol |= (t_idx > s_idx + 1) & (gap < radius)
    return viol.sum()


def _sharded_forward(
    sims: Sequence[LearnedSimulator],
    cfg: SimulatorConfig,
    stats: Sequence[NormStats],
    spec: PartitionSpec1D,
    devices: Sequence[torch.device],
    seqs: Sequence[torch.Tensor],  # per shard [N_local, S, dim]
    types: Sequence[torch.Tensor],  # per shard [N_local]
    masks: Sequence[torch.Tensor],  # per shard [N_local]
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Every shard's forward, in lockstep: (per shard [N_local, node_out],
    the halo guard's count on the first device)."""
    halo, k, r = spec.halo, cfg.slots, cfg.connectivity_radius
    lasts = [seq[:, -1] for seq in seqs]
    pos_ext = _halo_exchange(lasts, halo, devices)
    mask_ext = [m > 0 for m in _halo_exchange([m.int() for m in masks], halo, devices)]
    violations = _halo_guard([p[:, 0] for p in lasts], masks, halo, r, devices[0])
    dtype = cfg.torch_compute_dtype
    graphs, xs = [], []
    for s, sim in enumerate(sims):
        n_local = seqs[s].shape[0]
        nl_ext = compute_neighbors(cfg, pos_ext[s], mask_ext[s])  # receivers: every ext row
        nl = NeighborList(nl_ext.senders[halo : halo + n_local], nl_ext.mask[halo : halo + n_local])
        if cfg.band_nodes is not None:
            # a broken band makes this step's gathers wrong, as a broken halo
            # contract does: the same count rejects the step
            violations = violations + band_violations(nl.senders, nl.mask, cfg.band_nodes, halo).to(devices[0])
        graphs.append((nl_ext, nl))
        nf = _node_features_batched(sim, cfg, stats[s], seqs[s], types[s])
        xs.append(mlp_ln_apply(sim._encode_process_decode._encoder.node_fn, nf))
    n_ext = pos_ext[0].shape[0]
    use_sym = cfg.symmetric_gather and seqs[0].shape[0] >= _SYM_MIN_LOCAL_ROWS
    packed = None
    if use_sym and n_ext <= cfg.packed_gather_max_nodes:
        # layer 0's f32 sender projections, halo-exchanged, ride the packed
        # gather over the ext rows with the sender positions and the reverse
        # index; receivers and senders are both ext rows, so the band needs
        # no halo offset there
        d = xs[0].shape[-1]
        proj0 = []
        for sim, x in zip(sims, xs):
            (_, w_j0, _), _ = split_first_layer(sim._encode_process_decode._processor.gnn_stacks[0].edge_fn[0],
                                                (d, d, d))
            proj0.append(linear(x, w_j0))
        packed = [packed_sym_gather(p, t, g[0].senders, g[0].mask, dtype, cfg.band_nodes)
                  for p, t, g in zip(pos_ext, _halo_exchange(proj0, halo, devices), graphs)]
    es, degrees, gathers, xj0 = [], [], [], None if packed is None else []
    for s, sim in enumerate(sims):
        n_local = seqs[s].shape[0]
        nl_ext, nl = graphs[s]
        lo, hi = halo * k, (halo + n_local) * k
        if packed is not None:
            g_aux, xj_all, rev_pos, rev_ok = packed[s]
            sender_pos = g_aux[lo:hi].reshape(n_local, k, -1)
            xj0.append(xj_all[lo:hi])
        else:
            sender_pos = pos_ext[s][nl.senders]
        ef = edge_features_from(sender_pos, lasts[s], nl.mask, r)  # sender positions from the ext array
        deg = nl.mask.sum(dim=-1, keepdim=True).float()
        e = mlp_ln_apply(sim._encode_process_decode._encoder.edge_fn, ef.reshape(n_local * k, -1))
        e = e * _slot_mask(deg, n_local, k)
        rev = None
        if use_sym:
            # the reverse index over every ext row, kept to the reverses in
            # this shard's edge table; the rest reach their owners through
            # the halo exchange's backward
            if packed is None:
                rev_pos, rev_ok = reverse_edge_positions(nl_ext.senders, nl_ext.mask)
            rev_ok = rev_ok & (rev_pos >= lo) & (rev_pos < hi)
            rev = (torch.where(rev_ok, rev_pos - lo, 0), rev_ok)
        es.append(e if dtype is None else e.to(dtype))
        degrees.append(deg)
        gathers.append(sender_gather(nl.senders.reshape(-1), n_ext, rev, cfg.band_nodes, halo))

    def gather(proj_js: List[torch.Tensor]) -> List[torch.Tensor]:
        # the projections arrive in the compute dtype: bf16 halos ship half the bytes
        return [g(t) for g, t in zip(gathers, _halo_exchange(proj_js, halo, devices))]

    preds = _process_decode([sim._encode_process_decode for sim in sims], xs, es, degrees, k, gather, dtype,
                            xj0=xj0, remat=cfg.remat)
    return preds, violations


Forward = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _build_forward(mesh: Mesh, cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D) -> Forward:
    """``(sims, position_sequence [N_total, S, dim], particle_types
    [N_total], node_mask [N_total]) -> (norm_acc [N_total, dim], strain
    [N_total], halo_violations)``: global inputs and outputs on the mesh's
    first device, one module per shard (``mesh.Replicas``)."""
    check_remat(cfg.remat)
    devices = mesh.graph_devices
    if len(devices) != spec.num_shards:
        raise ValueError(f"the plan has {spec.num_shards} shards, the mesh's graph axis {len(devices)}")
    shard_stats = [stats.to(d) for d in devices]

    def forward(sims, position_sequence, particle_types, node_mask):
        if position_sequence.shape[0] != spec.total_nodes:
            raise ValueError(f"{position_sequence.shape[0]} nodes, the plan holds {spec.total_nodes}")

        def split(t):
            return [c.to(d) for c, d in zip(torch.chunk(t, spec.num_shards), devices)]

        preds, violations = _sharded_forward(
            sims, cfg, shard_stats, spec, devices, split(position_sequence), split(particle_types), split(node_mask)
        )
        primary = mesh.primary
        pred = torch.cat([p.to(primary) for p in preds])
        return pred[:, : cfg.dim], pred[:, -1], violations

    return forward


def make_partitioned_forward(mesh: Mesh, cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D):
    """``(sim, seq, types, mask) -> (norm_acc, strain)`` over the mesh."""
    fwd = _build_forward(mesh, cfg, stats, spec)

    def forward(sim, position_sequence, particle_types, node_mask):
        acc, strain, _ = fwd(Replicas(sim, mesh.graph_devices).modules, position_sequence, particle_types,
                             node_mask)
        return acc, strain

    return forward


def make_partitioned_predict_positions(mesh: Mesh, cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D):
    """Distributed inference step: Euler-integrate the partitioned forward."""
    fwd = _build_forward(mesh, cfg, stats, spec)

    def predict(sim, position_sequence, particle_types, node_mask):
        norm_acc, strain, _ = fwd(Replicas(sim, mesh.graph_devices).modules, position_sequence, particle_types,
                                  node_mask)
        return decoder_postprocess(stats, norm_acc, position_sequence), strain

    return predict


def _loss_fn(fwd: Forward, sims, stats: NormStats, loss_weight_position: float, loss_weight_strain: float):
    """The partitioned training loss ``(batch, noise) -> (loss, aux)`` over
    flat ``[N_total, ...]`` arrays (noise-corrupted one-step objective)."""

    def loss_fn(batch, noise):
        noisy = batch["positions"] + noise
        pred_acc, pred_strain, violations = fwd(sims, noisy, batch["particle_type"], batch["node_mask"])
        next_adjusted = batch["next_position"] + noise[:, -1]
        target_acc = inverse_decoder_postprocess(stats, next_adjusted, noisy)
        loss, aux = one_step_loss(pred_acc, target_acc, pred_strain, batch["next_strain"], batch["node_mask"],
                                  weight_position=loss_weight_position, weight_strain=loss_weight_strain)
        return loss, {**aux, "train/halo_violations": violations}

    return loss_fn


def make_partitioned_loss(
    mesh: Mesh,
    cfg: SimulatorConfig,
    stats: NormStats,
    spec: PartitionSpec1D,
    *,
    loss_weight_position: float = 1.0,
    loss_weight_strain: float = 1.0,
):
    """``(sim, position_sequence, noise, next_positions, next_strains,
    particle_types, node_mask) -> loss``: the distributed training loss."""
    fwd = _build_forward(mesh, cfg, stats, spec)

    def loss(sim, position_sequence, noise, next_positions, next_strains, particle_types, node_mask):
        batch = dict(positions=position_sequence, next_position=next_positions, next_strain=next_strains,
                     particle_type=particle_types, node_mask=node_mask)
        sims = Replicas(sim, mesh.graph_devices).modules
        return _loss_fn(fwd, sims, stats, loss_weight_position, loss_weight_strain)(batch, noise)[0]

    return loss


@torch.no_grad()
def gated_step(optimizer: torch.optim.Optimizer, keep: torch.Tensor) -> None:
    """``optimizer.step()``, then every parameter and every tensor of the
    optimizer's state (Adam's moments and step count) set back to its value
    before the step where ``keep`` (a 0-d bool tensor) is False: a rejected
    step leaves them bit-equal to what they were. Branch-free (two
    ``torch.where``s per tensor), so it runs inside a CUDA graph; state the
    step creates is restored to zeros, the optimizer's initial state."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    old_params = [p.clone() for p in params]
    old_state = {p: {k: v.clone() for k, v in optimizer.state[p].items() if isinstance(v, torch.Tensor)}
                 for p in params if p in optimizer.state}
    optimizer.step()
    for p, old in zip(params, old_params):
        p.copy_(torch.where(keep, p, old))
    for p in params:
        before = old_state.get(p, {})
        for name, v in optimizer.state[p].items():
            if isinstance(v, torch.Tensor):
                old = before.get(name)
                v.copy_(torch.where(keep.to(v.device), v, torch.zeros_like(v) if old is None else old))


class PartitionedTrainStep(TrainStep):
    """The graph-partitioned training step ``(batch, step, noise=None) ->
    metrics`` (the port of ``_make_partitioned_step_body``): the batch is
    one flat ``[N_total, ...]`` sample in the plan's layout
    (``partition_sample``) on the mesh's first device; noise is drawn for
    all of it from the one generator, as on one device. A step whose halo
    guard fired computed its gradients on a truncated edge set: it is
    REJECTED inside the step (``gated_step``: parameters and Adam's state
    unchanged), while the caller's step count and lr schedule advance.
    Metrics add ``train/halo_violations`` and ``train/halo_rejected``."""

    def __init__(
        self,
        mesh: Mesh,
        cfg: SimulatorConfig,
        stats: NormStats,
        spec: PartitionSpec1D,
        sim: LearnedSimulator,
        optimizer: torch.optim.Optimizer,
        sched: Callable[[int], float],
        noise_std: float,
        generator: Optional[torch.Generator] = None,
        *,
        loss_weight_position: float = 1.0,
        loss_weight_strain: float = 1.0,
        capture: bool = True,
    ):
        self.replicas = Replicas(sim, mesh.graph_devices)
        fwd = _build_forward(mesh, cfg, stats, spec)
        loss_fn = _loss_fn(fwd, self.replicas.modules, stats, loss_weight_position, loss_weight_strain)
        super().__init__(loss_fn, optimizer, sched, noise_std, generator, capture=capture)
        self.capturable = mesh.one_device

    def update(self, batch, noise: torch.Tensor) -> Metrics:
        self.replicas.sync()
        self.replicas.zero_grad()
        loss, aux = self.loss_fn(batch, noise)
        loss.backward()
        for module in self.replicas.copies:
            self.replicas.fold(module)
        keep = aux["train/halo_violations"] == 0
        gated_step(self.optimizer, keep)
        aux = {k: v.detach() for k, v in aux.items()}
        return {"train/loss": loss.detach(), **aux, "train/halo_rejected": (~keep).to(torch.int32)}

    def close(self) -> None:
        super().close()
        self.replicas.zero_grad()


def make_partitioned_train_step(
    mesh: Mesh,
    cfg: SimulatorConfig,
    stats: NormStats,
    spec: PartitionSpec1D,
    sim: LearnedSimulator,
    optimizer: torch.optim.Optimizer,
    sched: Callable[[int], float],
    *,
    noise_std: float = 0.02,
    generator: Optional[torch.Generator] = None,
    loss_weight_position: float = 1.0,
    loss_weight_strain: float = 1.0,
) -> PartitionedTrainStep:
    """The partitioned step of ``sim`` through ``optimizer`` (its lr
    ``sched(step)``), captured in a CUDA graph where the mesh is one card."""
    return PartitionedTrainStep(mesh, cfg, stats, spec, sim, optimizer, sched, noise_std, generator,
                                loss_weight_position=loss_weight_position, loss_weight_strain=loss_weight_strain)


class RejectionTracker:
    """Host-side guard against a permanently outgrown partition plan: counts
    CONSECUTIVE rejected steps and raises after ``limit`` of them, so that
    the run fails loudly with the fix instead of freezing the parameters
    while the lr schedule advances."""

    def __init__(self, limit: int = 50):
        self.limit = int(limit)
        self.consecutive = 0
        self.total = 0

    def update(self, rejected) -> None:
        if rejected:
            self.consecutive += 1
            self.total += 1
            if self.consecutive >= self.limit:
                raise RuntimeError(
                    f"{self.consecutive} consecutive training steps rejected "
                    "by the halo-contract guard: the sample geometry has "
                    "outgrown the static partition plan (params are frozen "
                    "while the LR schedule advances). Rebuild the plan on "
                    "current positions (edge_partition.partition_plan) or "
                    "increase halo_slack."
                )
        else:
            self.consecutive = 0


def make_partitioned_multi_step(step: PartitionedTrainStep, num_steps: int) -> Callable:
    """``num_steps`` partitioned steps per call: ``(batches [num_steps,
    N_total, ...], step, noise=None) -> metrics stacked [num_steps]``, each
    step the same math as one ``PartitionedTrainStep`` call (the port of the
    JAX scan; ``noise`` ``[num_steps, N_total, S, dim]``)."""
    multi = make_multi_step(step)

    def run(batches, step_count: int, noise: Optional[torch.Tensor] = None) -> Metrics:
        if batches["positions"].shape[0] != num_steps:
            raise ValueError(f"{batches['positions'].shape[0]} stacked batches for {num_steps} steps")
        return multi(batches, step_count, noise)

    return run


def _rollout_step(fwd: Forward, sims, stats: NormStats, inference_mode: str):
    """The step ``(window, gt_pos, gt_strain, *, particle_types, node_mask,
    erosional) -> (new window, next positions, strain, halo violations)``."""

    def step(window, gt_pos, gt_strain, *, particle_types, node_mask, erosional):
        norm_acc, strain, violations = fwd(sims, window, particle_types, node_mask)
        next_pos = decoder_postprocess(stats, norm_acc, window)
        return (*advance_window(window, next_pos, strain, gt_pos, gt_strain, erosional, inference_mode), violations)

    return step


def _check_mode(inference_mode: str) -> None:
    if inference_mode not in ("autoregressive", "one_step"):
        raise ValueError(f"Unknown inference_mode: {inference_mode}")


def _check_sim(sim: LearnedSimulator, mesh: Mesh) -> None:
    if sim.device != mesh.primary:
        raise ValueError(f"simulator lives on {sim.device}, the mesh's first device is {mesh.primary}")


def make_partitioned_rollout(
    mesh: Mesh, cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D, *,
    inference_mode: str = "autoregressive",
):
    """Distributed autoregressive rollout, its step captured in a CUDA graph
    where the mesh is one card (the port of the JAX ``lax.scan``):
    ``(sim, positions [N, T, dim], particle_types [N], strains [T, N],
    node_mask [N], capture=True) -> the reference rollout dict`` plus
    ``halo_violations`` ``[T-S]`` (nonzero: the body outgrew the static plan
    that step). Node arrays are in the plan's x-sorted layout."""
    _check_mode(inference_mode)
    fwd = _build_forward(mesh, cfg, stats, spec)
    s = cfg.input_sequence_length

    @torch.inference_mode()
    def run(sim, positions, particle_types, strains, node_mask, capture: bool = True) -> Dict[str, torch.Tensor]:
        _check_sim(sim, mesh)
        dev = mesh.primary
        positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
        particle_types = torch.as_tensor(particle_types, device=dev)
        strains = torch.as_tensor(strains, dtype=torch.float32, device=dev)
        node_mask = torch.as_tensor(node_mask, dtype=torch.bool, device=dev)
        window = positions[:, :s]
        gt_positions = positions[:, s:].transpose(0, 1)
        gt_strains = strains[s:]
        erosional = (particle_types == EROSIONAL_PARTICLE_ID)[:, None]
        fixed = dict(particle_types=particle_types, node_mask=node_mask, erosional=erosional)
        step = _rollout_step(fwd, Replicas(sim, mesh.graph_devices).modules, stats, inference_mode)
        key = ("partitioned_rollout", cfg, spec, mesh, inference_mode, captured_step.tensors_key(stats),
               captured_step.module_key(sim))
        pred_positions, pred_strains, violations = captured_step.roll(
            step, window, gt_positions, gt_strains, fixed, capture=capture and mesh.one_device, owner=sim, key=key,
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
            "halo_violations": violations,
        }

    return run


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_replanning_rollout(
    mesh: Mesh, cfg: SimulatorConfig, stats: NormStats, spec: PartitionSpec1D, *,
    inference_mode: str = "autoregressive",
):
    """Distributed rollout that RE-PLANS the partition when the halo guard
    fires, instead of silently truncating edges.

    Host-driven, as JAX's: one step per frame (the captured step where the
    mesh is one card: ``CapturedStep.call``, the same graph replayed on new
    contents), one read of the guard's count. On a nonzero count the
    current (pre-step) window comes back to the host, the nodes are
    re-sorted by their CURRENT x (the same static spec: only the permutation
    changes) and the step re-runs. The guard is conservative, so a step
    with 0 violations computed the full graph's edge set.

    ``(sim, positions [N, T, dim], particle_types [N], strains [T, N],
    node_mask [N], capture=True)``, every node array in the CALLER's order
    (sorting is internal) -> the reference rollout dict plus
    ``halo_violations`` ``[T-S]`` (residual count per step, after any
    replan) and ``replans``.
    """
    _check_mode(inference_mode)
    fwd = _build_forward(mesh, cfg, stats, spec)
    s = cfg.input_sequence_length

    @torch.inference_mode()
    def run(sim, positions, particle_types, strains, node_mask, capture: bool = True) -> Dict[str, torch.Tensor]:
        _check_sim(sim, mesh)
        dev = mesh.primary
        pos, ty, st, m = _host(positions), _host(particle_types), _host(strains), _host(node_mask).astype(bool)
        n_view, total_t = pos.shape[:2]
        nt = spec.total_nodes
        idx = np.nonzero(m)[0]
        k = len(idx)
        if k > nt:
            raise ValueError(f"{k} nodes > plan capacity {nt}")

        def plan(frame: np.ndarray) -> np.ndarray:  # [N, dim] caller order -> validated sort order
            order = idx[np.argsort(frame[idx, 0], kind="stable")]
            need = _halo_needed(frame[order, 0], spec.nodes_per_shard, spec.num_shards, cfg.connectivity_radius)
            if need > spec.halo:
                raise ValueError(
                    f"re-plan needs halo {need} > spec halo {spec.halo}; the geometry outgrew the "
                    "static plan — rebuild the spec (dataset_partition_plan) with these frames"
                )
            return order

        pos_d = torch.as_tensor(pos, dtype=torch.float32, device=dev)  # [N, T, dim] caller order
        st_d = torch.as_tensor(st, dtype=torch.float32, device=dev)  # [T, N]
        ty_d = torch.as_tensor(ty, device=dev)

        def sort_pad(a: torch.Tensor, order_d: torch.Tensor) -> torch.Tensor:
            buf = a.new_zeros((nt, *a.shape[1:]))
            buf[:k] = a[order_d]
            return buf

        mask_s = torch.zeros(nt, dtype=torch.bool, device=dev)
        mask_s[:k] = True  # sorted layout: real nodes first, padding last
        window_h = pos[:, :s].copy()  # [N, S, dim] caller order (host mirror, refreshed at replans)

        def layout(order: np.ndarray):
            order_d = torch.as_tensor(order, device=dev)
            types_s = sort_pad(ty_d, order_d)
            fixed = dict(particle_types=types_s, node_mask=mask_s,
                         erosional=(types_s == EROSIONAL_PARTICLE_ID)[:, None])
            window = sort_pad(torch.as_tensor(window_h, device=dev), order_d)
            return order_d, fixed, window

        order = plan(pos[:, 0])
        order_d, fixed, window_d = layout(order)
        step = _rollout_step(fwd, Replicas(sim, mesh.graph_devices).modules, stats, inference_mode)
        gp0, gs0 = window_d[:, 0], window_d[:, 0, 0]
        capture = capture and mesh.one_device
        key = ("replanning_rollout", cfg, spec, mesh, inference_mode, capture, captured_step.tensors_key(stats),
               captured_step.module_key(sim), captured_step._spec(window_d), captured_step._spec(fixed))
        captured = captured_step.cached_step(
            sim, key, lambda: captured_step.CapturedStep(window_d, gp0[None], gs0[None], fixed, capture=capture))

        preds = pos_d.new_zeros((total_t - s, n_view, pos.shape[-1]))
        pred_strains = st_d.new_zeros((total_t - s, n_view))
        viols = np.zeros(total_t - s, np.int64)
        replans = 0
        for t in range(total_t - s):
            gp_d, gs_d = sort_pad(pos_d[:, s + t], order_d), sort_pad(st_d[s + t], order_d)
            new_w, next_p, strain, v = captured.call(step, window_d, gp_d, gs_d, fixed)
            v = int(v)
            if v:
                # re-plan from the CURRENT (pre-step) window and re-run
                window_h[order] = window_d[:k].cpu().numpy()
                order = plan(window_h[:, -1])
                replans += 1
                order_d, fixed, window_d = layout(order)
                gp_d, gs_d = sort_pad(pos_d[:, s + t], order_d), sort_pad(st_d[s + t], order_d)
                new_w, next_p, strain, v = captured.call(step, window_d, gp_d, gs_d, fixed)
                v = int(v)  # residual violations (the spec itself is insufficient)
            window_d = new_w.clone()  # the buffer is the next call's input
            preds[t, order_d] = next_p[:k]
            pred_strains[t, order_d] = strain[:k]
            viols[t] = v

        gt_positions = pos_d[:, s:].transpose(0, 1)
        gt_strains = st_d[s:]
        mask_d = torch.as_tensor(m, device=dev)
        return {
            "initial_positions": pos_d[:, :s].transpose(0, 1),
            "initial_strains": st_d[:s],
            "predicted_rollout": preds,
            "ground_truth_rollout": gt_positions,
            "predicted_strain": pred_strains,
            "ground_truth_strain": gt_strains,
            "particle_types": ty_d,
            "rmse_position": cumulative_rmse(preds, gt_positions, mask_d),
            "rmse_strain": cumulative_rmse(pred_strains[..., None], gt_strains[..., None], mask_d),
            "halo_violations": torch.from_numpy(viols),
            "replans": torch.tensor(replans),
        }

    return run
