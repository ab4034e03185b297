"""Graph-axis (slab) partitioning for the MULTI-SCALE family.

Port of ``sgnn_tpu/parallel/ms_partition.py``. The multi-scale hierarchy
is STATIC, built once per trajectory from its t = 0 positions, so its
partition is planned EXACTLY on the host: every edge of every type (g2m,
the m2m scales, m2g) is known up front, the halo each slab needs is the
largest sender overhang over those edges (no runtime guard, no rejected
step), and each shard's edge lists are remapped to its extended array
(left halo | local slab | right halo). The coarsest m2m radius sets the
one halo every edge type shares; a plan whose senders reach past the
adjacent slab fails validation (reduce the shard count).

The numpy planning is this package's own copy: ``ShardedEdges``,
``ShardedMSGraph``, ``ShardedDenseMSGraph``, ``plan_ms_partition``,
``ms_dataset_partition`` and ``ms_partition_sample``. Its arrays equal
JAX's, and the COO layout adds each shard's stable sender ``order``
(``physics/multi_scale_graph.sender_order``), which the port's
deterministic sender-gather backward reads.

Device side, one process drives every shard in lockstep (``mesh.Mesh``;
a mesh may name one device several times):

  * node state is one ``[per, D]`` tensor per shard at every stage; the
    last positions are exchanged once for the edge features, the latents
    once before every interaction block (``edge_partition._halo_exchange``,
    whose autograd carries a halo row's gradient back to its owner);
  * each block is the single-device ``models/multi_scale._interact``
    (COO) or ``_interact_dense`` / ``_interact_dense_scales`` (dense) with
    the halo-extended latents as its sender table: the take kernel for the
    gathers, the sorted segment sum for every sum at receivers and its
    backwards, the transpose plan's kernel for the dense sender backward
    over the ``[per + 2 halo, H]`` table;
  * COO padding: JAX pads sharded senders with 0; here a padded slot is
    re-pointed at the extended table's last row in the forward (as
    ``flatten_ms_graph`` does on one device), so that the senders taken
    in ``order`` ascend, padding included;
  * a step whose shards sit on one device is one CUDA graph on the card:
    the training step (``MSPartitionedTrainStep``) and the rollout step
    (``make_ms_partitioned_rollout``, one capture for every trajectory
    whose sharded graph has the same shapes). Shards on several devices
    run eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sgnn_tpu_torch.data.prefetch import to_device, tree_map
from sgnn_tpu_torch.models.encode_process_decode import mlp_ln_apply
from sgnn_tpu_torch.models.multi_scale import _encode_edges, _interact, _interact_dense, _interact_dense_scales
from sgnn_tpu_torch.parallel.edge_partition import PartitionSpec1D, _check_mode, _check_sim, _halo_exchange
from sgnn_tpu_torch.parallel.mesh import Mesh, Replicas
from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics.multi_scale_graph import (
    CooEdges,
    DenseEdges,
    MultiScaleConfig,
    PaddedEdges,
    create_all_edges,
    dense_edges,
    sender_order,
)
from sgnn_tpu_torch.physics.multi_scale_simulator import MultiScaleSimulator, MultiScaleSimulatorConfig, _ms_node_features
from sgnn_tpu_torch.physics.rollout import EROSIONAL_PARTICLE_ID, advance_window, cumulative_rmse, per_step_rmse
from sgnn_tpu_torch.physics.simulator import NormStats, decoder_postprocess, inverse_decoder_postprocess
from sgnn_tpu_torch.train.captured_train_step import Metrics, TrainStep, make_multi_step


class ShardedEdges(NamedTuple):
    """One edge type split by the receiver's shard (host-built, exact).

    senders: int32[P, E_pad] sender row in the shard's EXTENDED array,
      global_sorted_idx - shard*per + halo (padding 0, as JAX's).
    receivers: int32[P, E_pad] receiver row in the LOCAL slab,
      non-decreasing per shard (padded slots hold per-1, appended last).
    mask: bool[P, E_pad].
    order: int32[P, E_pad] each shard's stable sort of its valid senders,
      padded slots last (``sender_order``).
    """

    senders: np.ndarray
    receivers: np.ndarray
    mask: np.ndarray
    order: np.ndarray


class ShardedMSGraph(NamedTuple):
    g2m: ShardedEdges
    m2m: ShardedEdges
    m2g: ShardedEdges


class ShardedDenseMSGraph(NamedTuple):
    """Dense-slot sharded static graph: DenseEdges with a leading [P]
    axis; receivers index the LOCAL slab, senders and the transpose plans
    the halo-EXTENDED array. ``m2m`` is a tuple of per-scale DenseEdges."""

    g2m: DenseEdges
    m2m: tuple
    m2g: DenseEdges


def _shard_edges(senders: np.ndarray, receivers: np.ndarray, spec: PartitionSpec1D, e_pad: int) -> ShardedEdges:
    """Split global-sorted-index COO edges by receiver's slab and remap."""
    per, halo, p = spec.nodes_per_shard, spec.halo, spec.num_shards
    shard = receivers // per
    s_out = np.zeros((p, e_pad), np.int32)
    r_out = np.full((p, e_pad), per - 1, np.int32)
    m_out = np.zeros((p, e_pad), bool)
    for sh in range(p):
        sel = shard == sh
        s = senders[sel] - sh * per + halo
        r = receivers[sel] - sh * per
        # receiver-sorted, each receiver's edges in their order (pad_edges'
        # stable sort: per-receiver sums in the single-device order)
        order = np.argsort(r, kind="stable")
        s, r = s[order], r[order]
        if len(s) > e_pad:
            raise ValueError(f"shard {sh}: {len(s)} edges > pad {e_pad}")
        if len(s) and (s.min() < 0 or s.max() >= per + 2 * halo):
            raise ValueError(f"shard {sh}: sender outside the halo window — plan invalid")
        s_out[sh, : len(s)] = s
        r_out[sh, : len(r)] = r
        m_out[sh, : len(s)] = True
    return ShardedEdges(s_out, r_out, m_out, sender_order(s_out, m_out))


def _shard_dense_edges(
    senders: np.ndarray, receivers: np.ndarray, spec: PartitionSpec1D, sizes: Tuple[int, int, int, int]
) -> DenseEdges:
    """Per-shard DenseEdges stacked on a leading [P] axis from global
    x-sorted COO edges; sizes = (rows, K, plan rows, plan K), common
    across shards (and trajectories when pinned)."""
    per, halo, p = spec.nodes_per_shard, spec.halo, spec.num_shards
    rows_pad, k_slots, tsp_rows_pad, tsp_slots = sizes
    ext = spec.ext_nodes
    shard = receivers // per
    parts = []
    for sh in range(p):
        sel = shard == sh
        s = senders[sel] - sh * per + halo
        r = receivers[sel] - sh * per
        if len(s) and (s.min() < 0 or s.max() >= ext):
            raise ValueError(f"shard {sh}: sender outside the halo window — plan invalid")
        parts.append(dense_edges(CooEdges(s.astype(np.int64), r.astype(np.int64)), per, rows_pad, k_slots,
                                 tsp_rows_pad=tsp_rows_pad, tsp_slots=tsp_slots, num_sender_nodes=ext))
    return DenseEdges(*(np.stack(xs) for xs in zip(*parts)))


def _dense_shard_sizes(
    senders: np.ndarray, receivers: np.ndarray, per: int, num_shards: int, pad_multiple: int = 8
) -> Tuple[int, int, int, int]:
    """(rows, K, plan rows, plan K) maxima over shards for one edge set:
    rows padded to ``pad_multiple``, the slot widths K EXACT (every padded
    slot row runs the whole edge MLP)."""
    shard = receivers // per
    r_max = k_max = sr_max = sk_max = 1
    for sh in range(num_shards):
        sel = shard == sh
        if not sel.any():
            continue
        _, counts = np.unique(receivers[sel], return_counts=True)
        r_max = max(r_max, len(counts))
        k_max = max(k_max, int(counts.max()))
        _, scounts = np.unique(senders[sel], return_counts=True)
        sr_max = max(sr_max, len(scounts))
        sk_max = max(sk_max, int(scounts.max()))

    def up(v, m):
        return -(-v // m) * m

    return up(r_max, pad_multiple), k_max, up(sr_max, pad_multiple), sk_max


def _slab_rows(n: int, num_shards: int, pad_multiple: int) -> int:
    return -(-(-(-n // num_shards)) // pad_multiple) * pad_multiple


def plan_ms_partition(
    ms_cfg: MultiScaleConfig,
    grid_positions: np.ndarray,  # [N, dim] trajectory t=0 positions
    num_shards: int,
    *,
    pad_multiple: int = 8,
    halo_slack: float = 1.25,
    nodes_per_shard: Optional[int] = None,
    halo: Optional[int] = None,
    e_pads: Optional[Dict[str, int]] = None,
    layout: str = "coo",
    dense_sizes: Optional[dict] = None,
):
    """Host-side exact partition plan for one trajectory's static graph:
    (spec, order, sharded graph). ``order`` x-sorts the nodes (every
    per-node array is fed in this order, padding appended); the hierarchy
    is built from the SORTED positions. Raises when a sender falls past
    the adjacent slab. ``nodes_per_shard`` / ``halo`` / ``e_pads`` (and
    ``dense_sizes``: ``{"g2m": (rows, K, plan rows, plan K), "m2m": [per
    scale], "m2g": ...}``) pin the shapes across trajectories.
    ``layout="dense"`` returns a ShardedDenseMSGraph."""
    grid_positions = np.asarray(grid_positions)
    n = grid_positions.shape[0]
    order = np.argsort(grid_positions[:, 0], kind="stable")
    pos_sorted = grid_positions[order]
    per = nodes_per_shard or _slab_rows(n, num_shards, pad_multiple)
    if per * num_shards < n:
        raise ValueError(f"nodes_per_shard {per} x {num_shards} < {n} nodes")

    edges = create_all_edges(ms_cfg, pos_sorted)
    types = {"g2m": edges["grid2mesh_edges"], "m2m": edges["mesh2mesh_edges"], "m2g": edges["mesh2grid_edges"]}

    halo_needed = 0
    for e in types.values():
        if not len(e.senders):
            continue
        shard = e.receivers // per
        over_l = int(np.max(shard * per - e.senders))
        over_r = int(np.max(e.senders - ((shard + 1) * per - 1)))
        halo_needed = max(halo_needed, over_l, over_r, 0)
    if halo_needed > per:
        raise ValueError(
            f"coarsest-scale senders reach {halo_needed} rows past their slab (> slab size {per}) — beyond the "
            "adjacent-slab exchange pattern; reduce num_shards"
        )
    if halo is None:
        halo = min(max(pad_multiple, -(-int(halo_needed * halo_slack) // pad_multiple) * pad_multiple), per)
    elif halo_needed > halo:
        raise ValueError(f"pinned halo {halo} < needed {halo_needed}")
    spec = PartitionSpec1D(num_shards, per, halo)

    if layout == "dense":
        ds = dense_sizes or {}

        def shard(e, pinned):
            s, r = np.asarray(e.senders), np.asarray(e.receivers)
            sizes = pinned if pinned is not None else _dense_shard_sizes(s, r, per, num_shards, pad_multiple)
            return _shard_dense_edges(s, r, spec, sizes)

        per_scale = edges["mesh2mesh_edges_per_scale"]
        m2m_pinned = ds.get("m2m") or [None] * len(per_scale)
        graph = ShardedDenseMSGraph(
            g2m=shard(types["g2m"], ds.get("g2m")),
            m2m=tuple(shard(e, m2m_pinned[i]) for i, e in enumerate(per_scale)),
            m2g=shard(types["m2g"], ds.get("m2g")),
        )
        return spec, order, graph

    e_pads = e_pads or {}
    sharded = {}
    for name, e in types.items():
        if name in e_pads:
            pad = e_pads[name]
        else:
            counts = np.bincount(e.receivers // per, minlength=num_shards)
            pad = max(-(-int(counts.max()) // pad_multiple) * pad_multiple, pad_multiple)
        sharded[name] = _shard_edges(np.asarray(e.senders), np.asarray(e.receivers), spec, pad)
    return spec, order, ShardedMSGraph(**sharded)


def _common_shapes(graphs, layout: str) -> dict:
    """The pinning arguments of ``plan_ms_partition`` that give every plan
    the largest shape of each edge type over ``graphs``."""
    if layout == "dense":
        def size_max(des):  # DenseEdges leaves are [P, ...]: (rows, K, plan rows, plan K)
            return (max(d.recv.shape[1] for d in des), max(d.senders.shape[2] for d in des),
                    max(d.tsp_node.shape[1] for d in des), max(d.tsp_rows.shape[2] for d in des))

        return dict(dense_sizes={
            "g2m": size_max([g.g2m for g in graphs]),
            "m2m": [size_max([g.m2m[s] for g in graphs]) for s in range(len(graphs[0].m2m))],
            "m2g": size_max([g.m2g for g in graphs]),
        })
    return dict(e_pads={t: max(getattr(g, t).senders.shape[1] for g in graphs) for t in ("g2m", "m2m", "m2g")})


def pinned_plans(ms_cfg: MultiScaleConfig, frames, spec: PartitionSpec1D, *, pad_multiple: int = 8,
                 halo_slack: float = 1.25, layout: str = "coo") -> list:
    """[(order, sharded graph)] of every frame in ``frames`` on ``spec``'s
    slabs and halo, with ONE set of shapes (the largest of each edge type
    over the frames): one captured step serves them all."""
    kw = dict(pad_multiple=pad_multiple, halo_slack=halo_slack, nodes_per_shard=spec.nodes_per_shard,
              halo=spec.halo, layout=layout)
    pin = _common_shapes([plan_ms_partition(ms_cfg, f, spec.num_shards, **kw)[2] for f in frames], layout)
    return [plan_ms_partition(ms_cfg, f, spec.num_shards, **kw, **pin)[1:] for f in frames]


def ms_dataset_partition(
    ms_cfg: MultiScaleConfig,
    frame0_list,  # iterable of [N, dim] t=0 positions, one per trajectory
    num_shards: int,
    *,
    pad_multiple: int = 8,
    halo_slack: float = 1.25,
    layout: str = "coo",
):
    """(spec, plans) for every trajectory with ONE set of static shapes:
    slab size from the largest trajectory, the halo the largest any plan
    needs, plans[i] = (order_i, sharded graph_i)."""
    frames = [np.asarray(f) for f in frame0_list]
    if not frames:
        raise ValueError("ms_dataset_partition needs at least one trajectory")
    per = _slab_rows(max(f.shape[0] for f in frames), num_shards, pad_multiple)
    kw = dict(pad_multiple=pad_multiple, halo_slack=halo_slack, nodes_per_shard=per)
    draft = [plan_ms_partition(ms_cfg, f, num_shards, layout=layout, **kw) for f in frames]
    spec = PartitionSpec1D(num_shards, per, max(sp.halo for sp, _, _ in draft))
    pin = _common_shapes([g for _, _, g in draft], layout)
    return spec, [plan_ms_partition(ms_cfg, f, num_shards, halo=spec.halo, layout=layout, **kw, **pin)[1:]
                  for f in frames]


def ms_partition_sample(batch: dict, spec: PartitionSpec1D, order: np.ndarray) -> dict:
    """Host-side: one [1, N, ...] batch -> a partitioned flat sample. Real
    nodes are reordered by the trajectory plan's ``order`` and padded to
    ``spec.total_nodes`` (padding masked False at the end). The caller
    attaches the trajectory's sharded graph as ``graph``."""
    nt = spec.total_nodes
    out = {}
    for k in ("positions", "next_position", "next_strain", "particle_type"):
        a = np.asarray(batch[k][0])
        buf = np.zeros((nt, *a.shape[1:]), a.dtype)
        buf[: len(order)] = a[order]
        out[k] = buf
    m = np.asarray(batch["node_mask"][0])
    mask = np.zeros(nt, bool)
    mask[: len(order)] = m[order]
    out["node_mask"] = mask
    return out


def sharded_graph_to(graph, device: torch.device):
    """A sharded graph of numpy arrays (or tensors) as the same graph of
    tensors on ``device``."""
    if not isinstance(graph, (ShardedMSGraph, ShardedDenseMSGraph)):
        raise TypeError(f"expected a ShardedMSGraph or ShardedDenseMSGraph, got {type(graph).__name__}")
    return to_device(graph, torch.device(device))


# --------------------------------------------------------------------------
# Device side
# --------------------------------------------------------------------------


def _coo_features(pos_ext: torch.Tensor, last: torch.Tensor, edges: PaddedEdges, radius: float) -> torch.Tensor:
    """[E, dim+1]: (p_sender - p_receiver) / radius and its norm, senders
    from the extended array."""
    disp = (pos_ext[edges.senders] - last[edges.receivers]) / radius
    dist = torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return torch.cat([disp, dist], dim=-1) * edges.mask[:, None].to(disp.dtype)


def _dense_features(pos_ext: torch.Tensor, last: torch.Tensor, de: DenseEdges, radius: float) -> torch.Tensor:
    """[R, K, dim+1] over dense slots, senders from the extended array."""
    disp = (pos_ext[de.senders] - last[de.recv][:, None, :]) / radius
    dist = torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return torch.cat([disp, dist], dim=-1) * de.mask[..., None].to(disp.dtype)


def _coo_shard(e: ShardedEdges, ext: int) -> Tuple[PaddedEdges, torch.Tensor]:
    """One shard's COO edges for ``_interact``: padded senders re-pointed at
    the extended table's last row, and the senders in ``order`` (ascending)."""
    senders = torch.where(e.mask, e.senders, ext - 1)
    return PaddedEdges(senders, e.receivers, e.mask, e.order), senders.index_select(0, e.order)


def _ms_sharded_forward(
    sims: Sequence[MultiScaleSimulator],
    cfg: MultiScaleSimulatorConfig,
    stats: Sequence[NormStats],
    spec: PartitionSpec1D,
    devices: Sequence[torch.device],
    seqs: Sequence[torch.Tensor],  # per shard [per, S, dim]
    types: Sequence[torch.Tensor],  # per shard [per]
    graphs: Sequence,  # per shard ShardedMSGraph or ShardedDenseMSGraph leaves (no [P] axis)
) -> List[torch.Tensor]:
    """Every shard's forward in lockstep -> per shard [per, node_out]: one
    exchange of the last positions for the edge features, then one of the
    latents before every interaction block, whose sender table is the
    halo-extended latents."""
    halo, gc, cd = spec.halo, cfg.graph_config, cfg.torch_compute_dtype
    dense = isinstance(graphs[0], ShardedDenseMSGraph)
    lasts = [seq[:, -1] for seq in seqs]
    pos_ext = _halo_exchange(lasts, halo, devices)
    gnns = [sim._multi_scale_gnn for sim in sims]
    xs, es, sets = [], [], []
    for s, (sim, gnn, g) in enumerate(zip(sims, gnns, graphs)):
        xs.append(mlp_ln_apply(gnn.grid_node_encoder, _ms_node_features(sim, cfg, stats[s], seqs[s], types[s])))
        if dense:
            sets.append({"g2m": g.g2m, "m2m": list(g.m2m), "m2g": g.m2g})

            def enc(name, de, radius):
                return _encode_edges(gnn, name, _dense_features(pos_ext[s], lasts[s], de, radius), de.mask, cd)

            es.append({"g2m": enc("g2m_edge_encoder", g.g2m, gc.grid_radius),
                       "m2m": [enc("m2m_edge_encoder", de, gc.coarsest_radius) for de in g.m2m],
                       "m2g": enc("m2g_edge_encoder", g.m2g, gc.grid_radius)})
        else:
            coo = {k: _coo_shard(getattr(g, k), spec.ext_nodes) for k in ("g2m", "m2m", "m2g")}
            sets.append(coo)
            radius = {"g2m": gc.grid_radius, "m2m": gc.coarsest_radius, "m2g": gc.grid_radius}
            es.append({k: _encode_edges(gnn, f"{k}_edge_encoder",
                                        _coo_features(pos_ext[s], lasts[s], coo[k][0], radius[k]), coo[k][0].mask, cd)
                       for k in coo})

    def block(key: str, pick: Callable) -> None:
        exts = _halo_exchange(xs, halo, devices)
        for s, gnn in enumerate(gnns):
            b = pick(gnn)
            if not dense:
                edges, sorted_senders = sets[s][key]
                xs[s], es[s][key] = _interact(b, xs[s], es[s][key], edges, sorted_senders, cd,
                                              x_sender_table=exts[s])
            elif key == "m2m":
                xs[s], es[s][key] = _interact_dense_scales(b, xs[s], es[s][key], sets[s][key], cd,
                                                           x_sender_table=exts[s])
            else:
                xs[s], es[s][key] = _interact_dense(b, xs[s], es[s][key], sets[s][key], cd, x_sender_table=exts[s])

    block("g2m", lambda gnn: gnn.g2m_block)
    for m in range(len(gnns[0].m2m_blocks)):
        block("m2m", lambda gnn, m=m: gnn.m2m_blocks[m])
    block("m2g", lambda gnn: gnn.m2g_block)
    return [gnn.prediction_head(x) for gnn, x in zip(gnns, xs)]


Forward = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _build_ms_forward(mesh: Mesh, cfg: MultiScaleSimulatorConfig, stats: NormStats, spec: PartitionSpec1D) -> Forward:
    """``(sims, position_sequence [N_total, S, dim], particle_types
    [N_total], graph) -> (norm_acc [N_total, dim], strain [N_total])``:
    global inputs and outputs on the mesh's first device, one module per
    shard (``mesh.Replicas``); ``graph`` a ShardedMSGraph (COO) or
    ShardedDenseMSGraph (dense) of tensors with [P, ...] leaves, whose
    type picks the layout."""
    devices = mesh.graph_devices
    if len(devices) != spec.num_shards:
        raise ValueError(f"the plan has {spec.num_shards} shards, the mesh's graph axis {len(devices)}")
    shard_stats = [stats.to(d) for d in devices]

    def forward(sims, position_sequence, particle_types, graph):
        if position_sequence.shape[0] != spec.total_nodes:
            raise ValueError(f"{position_sequence.shape[0]} nodes, the plan holds {spec.total_nodes}")
        if not isinstance(graph, (ShardedMSGraph, ShardedDenseMSGraph)):
            raise TypeError(f"expected a ShardedMSGraph or ShardedDenseMSGraph, got {type(graph).__name__}")

        def split(t):
            return [c.to(d) for c, d in zip(torch.chunk(t, spec.num_shards), devices)]

        graphs = [tree_map(lambda a, s=s, d=d: a[s].to(d).contiguous(), graph) for s, d in enumerate(devices)]
        preds = _ms_sharded_forward(sims, cfg, shard_stats, spec, devices, split(position_sequence),
                                    split(particle_types), graphs)
        pred = torch.cat([p.to(mesh.primary) for p in preds])
        return pred[:, : cfg.dim], pred[:, -1]

    return forward


def make_ms_partitioned_forward(mesh: Mesh, cfg: MultiScaleSimulatorConfig, stats: NormStats, spec: PartitionSpec1D):
    """``(sim, seq, types, graph) -> (norm_acc, strain)`` over the mesh."""
    fwd = _build_ms_forward(mesh, cfg, stats, spec)

    def forward(sim, position_sequence, particle_types, graph):
        return fwd(Replicas(sim, mesh.graph_devices).modules, position_sequence, particle_types, graph)

    return forward


def _loss_fn(fwd: Forward, sims, stats: NormStats, loss_weight_position: float, loss_weight_strain: float):
    """``(batch, noise) -> (loss, aux)``: the masked mean over every node of
    every shard of the noise-corrupted one-step objective."""

    def loss_fn(batch, noise):
        noisy = batch["positions"] + noise
        pred_acc, pred_strain = fwd(sims, noisy, batch["particle_type"], batch["graph"])
        target_acc = inverse_decoder_postprocess(stats, batch["next_position"] + noise[:, -1], noisy)
        m = batch["node_mask"].to(pred_acc.dtype)
        denom = torch.clamp(m.sum(), min=1.0)
        loss_pos = ((pred_acc - target_acc) ** 2).sum(dim=-1)
        loss_strain = (pred_strain - batch["next_strain"]) ** 2
        loss = loss_weight_position * loss_pos + loss_weight_strain * loss_strain
        return (loss * m).sum() / denom, {"train/loss-position": (loss_pos * m).sum() / denom,
                                          "train/loss-strain": (loss_strain * m).sum() / denom}

    return loss_fn


class MSPartitionedTrainStep(TrainStep):
    """The partitioned multi-scale training step ``(batch, step, noise=None)
    -> metrics``: ``batch`` is one flat ``[N_total, ...]`` sample in the
    plan's x-sorted layout (``ms_partition_sample``) with its trajectory's
    sharded graph as ``graph``, on the mesh's first device; the noise is
    drawn for all of it from the one generator, as on one device. The plan
    is exact, so there is no guard and no rejected step: each shard's
    gradients are folded onto the first device, then one Adam step."""

    def __init__(
        self,
        mesh: Mesh,
        cfg: MultiScaleSimulatorConfig,
        stats: NormStats,
        spec: PartitionSpec1D,
        sim: MultiScaleSimulator,
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
        fwd = _build_ms_forward(mesh, cfg, stats, spec)
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
        self.optimizer.step()
        return {"train/loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def close(self) -> None:
        super().close()
        self.replicas.zero_grad()


def make_ms_partitioned_train_step(
    mesh: Mesh,
    cfg: MultiScaleSimulatorConfig,
    stats: NormStats,
    spec: PartitionSpec1D,
    sim: MultiScaleSimulator,
    optimizer: torch.optim.Optimizer,
    sched: Callable[[int], float],
    *,
    noise_std: float = 0.02,
    generator: Optional[torch.Generator] = None,
    loss_weight_position: float = 1.0,
    loss_weight_strain: float = 1.0,
) -> MSPartitionedTrainStep:
    """The partitioned step of ``sim`` through ``optimizer`` (its lr
    ``sched(step)``), captured in a CUDA graph where the mesh is one card."""
    return MSPartitionedTrainStep(mesh, cfg, stats, spec, sim, optimizer, sched, noise_std, generator,
                                  loss_weight_position=loss_weight_position, loss_weight_strain=loss_weight_strain)


def make_ms_partitioned_multi_step(step: MSPartitionedTrainStep, num_steps: int) -> Callable:
    """``num_steps`` partitioned steps per call: ``(batches [num_steps,
    N_total, ...] with their graphs stacked [num_steps, P, ...], step,
    noise=None) -> metrics stacked [num_steps]``, each the math of one
    ``MSPartitionedTrainStep`` call (replays of its graph on the card; the
    port of the JAX scan)."""
    multi = make_multi_step(step)

    def run(batches, step_count: int, noise: Optional[torch.Tensor] = None) -> Metrics:
        if batches["positions"].shape[0] != num_steps:
            raise ValueError(f"{batches['positions'].shape[0]} stacked batches for {num_steps} steps")
        return multi(batches, step_count, noise)

    return run


def make_ms_partitioned_rollout(
    mesh: Mesh, cfg: MultiScaleSimulatorConfig, stats: NormStats, spec: PartitionSpec1D, *,
    inference_mode: str = "autoregressive",
):
    """Distributed autoregressive multi-scale rollout, its step captured in
    a CUDA graph where the mesh is one card (the port of the JAX scan):
    ``(sim, positions [N, T, dim], particle_types [N], strains [T, N],
    node_mask [N], graph, capture=True) -> ms_rollout's dict``. Node arrays
    are in the plan's x-sorted layout, ``graph`` its sharded graph. The
    hierarchy is static, so the plan stays exact for the whole trajectory:
    no guard and no re-plan. The graph is copied into the captured step's
    static buffers at every call: one capture serves every trajectory whose
    sharded graph has the same shapes (``ms_dataset_partition``,
    ``pinned_plans``)."""
    _check_mode(inference_mode)
    fwd = _build_ms_forward(mesh, cfg, stats, spec)
    s = cfg.input_sequence_length

    @torch.inference_mode()
    def run(sim, positions, particle_types, strains, node_mask, graph, capture: bool = True) -> Dict[str, torch.Tensor]:
        _check_sim(sim, mesh)
        dev = mesh.primary
        positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
        particle_types = torch.as_tensor(particle_types, device=dev)
        strains = torch.as_tensor(strains, dtype=torch.float32, device=dev)
        node_mask = torch.as_tensor(node_mask, dtype=torch.bool, device=dev)
        graph = sharded_graph_to(graph, dev)
        window = positions[:, :s]
        gt_positions = positions[:, s:].transpose(0, 1)
        gt_strains = strains[s:]
        erosional = (particle_types == EROSIONAL_PARTICLE_ID)[:, None]
        sims = Replicas(sim, mesh.graph_devices).modules

        def step(window, gt_pos, gt_strain, *, particle_types, erosional, graph):
            norm_acc, strain = fwd(sims, window, particle_types, graph)
            next_pos = decoder_postprocess(stats, norm_acc, window)
            return advance_window(window, next_pos, strain, gt_pos, gt_strain, erosional, inference_mode)

        fixed = dict(particle_types=particle_types, erosional=erosional, graph=graph)
        key = ("ms_partitioned_rollout", cfg, spec, mesh, inference_mode, captured_step.tensors_key(stats),
               captured_step.module_key(sim))
        pred_positions, pred_strains = captured_step.roll(
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
            "rmse_position_per_step": per_step_rmse(pred_positions, gt_positions, node_mask),
            "rmse_strain_per_step": per_step_rmse(pred_strains[..., None], gt_strains[..., None], node_mask),
        }

    return run
