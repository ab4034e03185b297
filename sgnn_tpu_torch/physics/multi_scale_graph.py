"""Static multi-scale graph hierarchy, built on the host in numpy.

The port's own copy of ``sgnn_tpu/physics/multi_scale_graph.py``
(``MultiScaleConfig``, ``CooEdges``, ``_radius_edges``,
``build_hierarchy``, ``create_all_edges``, ``PaddedEdges``, ``pad_edges``,
``StaticGraph``, ``build_static_graph``, ``DenseEdges``, ``dense_edges``,
``DenseStaticGraph``, ``build_dense_static_graph``). A grid -> mesh1 ->
mesh2 ... coarsening is built ONCE per trajectory from its frame-0
positions and reused for every step (the hierarchy does not track
deformation):

  * coarsening by strided coordinate subsampling: every window_size-th
    unique coordinate along each axis, chained global indices;
  * grid <-> mesh edges from ONE grid radius graph (r = radius_multiplier
    * grid_spacing, self loops, per-receiver cap 24) filtered on mesh
    membership of the receiver (g2m) or the sender (m2g);
  * per-scale mesh2mesh radius graphs over the sampled positions, r =
    scale spacing * radius_multiplier, remapped to global grid indices.

The radius search is scipy's cKDTree (the JAX module's fallback branch;
its native C++ search gives the same edges). Arrays are numpy; the
simulator moves them to the device once per trajectory. ``PaddedEdges``
also carries the sender order (``sender_order``), built here once per
trajectory, which the port's deterministic sender-gather backward reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
from scipy.spatial import cKDTree


@dataclasses.dataclass(frozen=True)
class MultiScaleConfig:
    """Hierarchy settings (grid_spacing fixed at 0.5 by the reference)."""

    num_scales: int = 3
    window_size: int = 3
    radius_multiplier: float = 2.0
    grid_spacing: float = 0.5
    max_neighbors: int = 24

    def __post_init__(self):
        if self.num_scales < 2:
            raise ValueError(
                f"num_scales must be >= 2 (grid + >=1 mesh level), got {self.num_scales}"
            )

    @property
    def grid_radius(self) -> float:
        return self.radius_multiplier * self.grid_spacing

    def scale_spacing(self, scale: int) -> float:
        return self.grid_spacing * self.window_size**scale

    def scale_radius(self, scale: int) -> float:
        return self.scale_spacing(scale) * self.radius_multiplier

    @property
    def coarsest_radius(self) -> float:
        return self.scale_radius(self.num_scales - 1)


class CooEdges(NamedTuple):
    """Variable-length COO edges (host-side intermediate)."""

    senders: np.ndarray  # [E]
    receivers: np.ndarray  # [E]


def _radius_edges(positions: np.ndarray, r: float, max_neighbors: int) -> CooEdges:
    """Radius graph: strict < r, self loops, per-receiver cap keeping the
    lowest sender indices. Edge = (sender j, receiver i), j within r of i."""
    tree = cKDTree(positions)
    senders, receivers = [], []
    for i, nbrs in enumerate(tree.query_ball_point(positions, r)):
        nbrs = np.sort(np.asarray(nbrs, np.int64))
        d = np.linalg.norm(positions[nbrs] - positions[i], axis=-1)
        nbrs = nbrs[d < r][:max_neighbors]
        senders.append(nbrs)
        receivers.append(np.full(len(nbrs), i, np.int64))
    return CooEdges(np.concatenate(senders), np.concatenate(receivers))


def build_hierarchy(cfg: MultiScaleConfig, grid_positions: np.ndarray) -> Dict[int, dict]:
    """Strided coordinate subsampling with chained global indices."""
    n = grid_positions.shape[0]
    hierarchy = {
        0: {"sampling_indices": np.arange(n, dtype=np.int64), "spacing": cfg.grid_spacing, "num_particles": n}
    }
    current_positions = grid_positions
    current_spacing = cfg.grid_spacing
    for scale in range(1, cfg.num_scales):
        masks = []
        for d in range(current_positions.shape[1]):
            coords = current_positions[:, d]
            sampled = np.unique(coords)[:: cfg.window_size]
            masks.append(np.isin(coords, sampled))
        local_idx = np.where(np.logical_and.reduce(masks))[0]
        global_idx = hierarchy[scale - 1]["sampling_indices"][local_idx]
        current_positions = current_positions[local_idx]
        current_spacing = current_spacing * cfg.window_size
        hierarchy[scale] = {
            "sampling_indices": global_idx,
            "spacing": current_spacing,
            "num_particles": len(global_idx),
        }
    return hierarchy


def create_all_edges(cfg: MultiScaleConfig, grid_positions: np.ndarray) -> dict:
    """Full static graph: hierarchy + g2m/m2m/m2g COO edges (global ids)."""
    grid_positions = np.asarray(grid_positions, np.float64)
    hierarchy = build_hierarchy(cfg, grid_positions)

    grid_edges = _radius_edges(grid_positions, cfg.grid_radius, cfg.max_neighbors)
    is_mesh = np.zeros(len(grid_positions), bool)
    is_mesh[hierarchy[1]["sampling_indices"]] = True
    g2m_mask = is_mesh[grid_edges.receivers]  # receiver is a mesh node
    m2g_mask = is_mesh[grid_edges.senders]  # sender is a mesh node
    g2m = CooEdges(grid_edges.senders[g2m_mask], grid_edges.receivers[g2m_mask])
    m2g = CooEdges(grid_edges.senders[m2g_mask], grid_edges.receivers[m2g_mask])

    m2m_scales: List[CooEdges] = []
    for scale in range(1, cfg.num_scales):
        idx = hierarchy[scale]["sampling_indices"]
        e = _radius_edges(grid_positions[idx], cfg.scale_radius(scale), cfg.max_neighbors)
        m2m_scales.append(CooEdges(idx[e.senders], idx[e.receivers]))
    m2m = CooEdges(
        np.concatenate([e.senders for e in m2m_scales]),
        np.concatenate([e.receivers for e in m2m_scales]),
    )
    return {
        "graph_hierarchy": hierarchy,
        "grid2mesh_edges": g2m,
        "mesh2mesh_edges": m2m,
        # per-scale views of the same m2m edges (scale order 1..S-1): the
        # dense layout keys its slot widths per scale off these
        "mesh2mesh_edges_per_scale": m2m_scales,
        "mesh2grid_edges": m2g,
    }


class PaddedEdges(NamedTuple):
    """Fixed-size COO edges: receiver-sorted with a validity mask, and the
    sender order (``sender_order``) that the sender gather's backward
    reads (the port's own field: JAX's backward scatters with XLA)."""

    senders: np.ndarray  # int32[E_pad]
    receivers: np.ndarray  # int32[E_pad]
    mask: np.ndarray  # bool[E_pad]
    order: Optional[np.ndarray] = None  # int32[E_pad]


def sender_order(senders: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """int32[..., E_pad]: the stable argsort of the valid senders, padded slots
    last in slot order. Padding is re-pointed at the graph's last node once
    the graph is flattened (``flatten_ms_graph``), at or above every valid
    sender, so the flattened senders taken in this order ascend."""
    key = np.where(mask, np.asarray(senders, np.int64), np.iinfo(np.int64).max)
    return np.argsort(key, axis=-1, kind="stable").astype(np.int32)


def pad_edges(edges: CooEdges, e_pad: int) -> PaddedEdges:
    e = len(edges.senders)
    if e > e_pad:
        raise ValueError(f"edge count {e} exceeds pad size {e_pad}")
    order = np.argsort(edges.receivers, kind="stable")
    s = np.zeros(e_pad, np.int32)
    r = np.zeros(e_pad, np.int32)
    m = np.zeros(e_pad, bool)
    s[:e] = edges.senders[order]
    r[:e] = edges.receivers[order]
    m[:e] = True
    return PaddedEdges(s, r, m, sender_order(s, m))


class StaticGraph(NamedTuple):
    """The static COO multi-scale graph of one trajectory. The edge
    features normalise by the grid radius (g2m, m2g) and by the coarsest
    scale's radius (m2m), both from MultiScaleConfig."""

    g2m: PaddedEdges
    m2m: PaddedEdges
    m2g: PaddedEdges


def build_static_graph(
    cfg: MultiScaleConfig, grid_positions: np.ndarray, *, g2m_pad: int, m2m_pad: int, m2g_pad: int
) -> StaticGraph:
    out = create_all_edges(cfg, grid_positions)
    return StaticGraph(
        g2m=pad_edges(out["grid2mesh_edges"], g2m_pad),
        m2m=pad_edges(out["mesh2mesh_edges"], m2m_pad),
        m2g=pad_edges(out["mesh2grid_edges"], m2g_pad),
    )


class DenseEdges(NamedTuple):
    """One edge type as dense per-receiver neighbour slots.

    Attributes:
      recv: int32[R] global grid index of each receiver row, ascending;
        padded rows hold the LAST node index so the array stays sorted.
      senders: int32[R, K] global sender index per slot; padded slots hold
        the row's own receiver index (in bounds, inert).
      mask: bool[R, K] slot validity (valid slots form a row prefix).
      tsp_rows / tsp_node / tsp_mask: the static transpose plan, the same
        edges grouped by SENDER as flat edge positions (row*K + slot); the
        sender gather's backward reads it (multi-scale training). tsp_node
        is ascending; padded rows hold the last node with tsp_rows 0 and
        mask False.
    """

    recv: np.ndarray
    senders: np.ndarray
    mask: np.ndarray
    tsp_rows: np.ndarray  # int32[Rs, Ks]
    tsp_node: np.ndarray  # int32[Rs]
    tsp_mask: np.ndarray  # bool[Rs, Ks]


def dense_edges(
    edges: CooEdges,
    num_nodes: int,
    r_pad: int,
    k_slots: int,
    *,
    tsp_rows_pad: Optional[int] = None,
    tsp_slots: Optional[int] = None,
    num_sender_nodes: Optional[int] = None,
) -> DenseEdges:
    """Group COO edges by receiver into dense [R, K] slots (+ sender plan).

    tsp_rows_pad / tsp_slots size the transpose plan (distinct senders /
    max out-degree); the defaults fit this edge set exactly.
    num_sender_nodes: size of the sender index space where it differs
    from the receiver space; pads of tsp_node use its last row.
    """
    sender_last = (num_sender_nodes or num_nodes) - 1
    recv_ids, counts = np.unique(edges.receivers, return_counts=True)
    r = len(recv_ids)
    if r > r_pad:
        raise ValueError(f"receiver count {r} exceeds pad size {r_pad}")
    kmax = int(counts.max()) if r else 0
    if kmax > k_slots:
        raise ValueError(f"max degree {kmax} exceeds slot count {k_slots}")

    order = np.argsort(edges.receivers, kind="stable")
    s_sorted = edges.senders[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(s_sorted)) - np.repeat(starts, counts)  # slot within its row

    recv = np.full(r_pad, num_nodes - 1, np.int32)
    recv[:r] = recv_ids
    senders = np.repeat(recv[:, None], k_slots, axis=1).astype(np.int32)
    mask = np.zeros((r_pad, k_slots), bool)
    row = np.repeat(np.arange(r), counts)
    senders[row, slot] = s_sorted
    mask[row, slot] = True

    # transpose plan: flat edge positions grouped by sender
    flatpos = (row * k_slots + slot).astype(np.int32)
    sorder = np.argsort(s_sorted, kind="stable")
    snd_sorted = s_sorted[sorder]
    pos_sorted = flatpos[sorder]
    snd_ids, scounts = np.unique(snd_sorted, return_counts=True)
    rs = len(snd_ids)
    ks = tsp_slots or (int(scounts.max()) if rs else 1)
    rs_pad = tsp_rows_pad or max(-(-rs // 8) * 8, 8)
    if rs > rs_pad:
        raise ValueError(f"sender count {rs} exceeds plan pad {rs_pad}")
    if rs and int(scounts.max()) > ks:
        raise ValueError(f"max out-degree {int(scounts.max())} exceeds plan slots {ks}")
    tsp_node = np.full(rs_pad, sender_last, np.int32)
    tsp_node[:rs] = snd_ids
    tsp_rows = np.zeros((rs_pad, ks), np.int32)
    tsp_mask = np.zeros((rs_pad, ks), bool)
    sstarts = np.concatenate([[0], np.cumsum(scounts)[:-1]])
    sslot = np.arange(len(snd_sorted)) - np.repeat(sstarts, scounts)
    srow = np.repeat(np.arange(rs), scounts)
    tsp_rows[srow, sslot] = pos_sorted
    tsp_mask[srow, sslot] = True
    return DenseEdges(recv=recv, senders=senders, mask=mask, tsp_rows=tsp_rows, tsp_node=tsp_node, tsp_mask=tsp_mask)


class DenseStaticGraph(NamedTuple):
    """Dense-slot static multi-scale graph of one trajectory. ``m2m`` is a
    TUPLE of per-scale DenseEdges (scale order 1..S-1): every coarse node
    is also a member of all finer scales, so one slot width over the
    concatenated m2m edges would pad every fine row to the summed degree,
    while per-scale widths stay tight. Each m2m block consumes all scales'
    edges per layer, as the reference's concatenated list does."""

    g2m: DenseEdges
    m2m: tuple  # Tuple[DenseEdges, ...], one per scale
    m2g: DenseEdges


def _per_scale(val, num: int, default=None):
    """Broadcast an int (or None -> default) sizing argument to per-scale values."""
    if val is None:
        val = default
    if isinstance(val, (list, tuple)):
        if len(val) != num:
            raise ValueError(f"expected {num} per-scale values, got {len(val)}")
        return list(val)
    return [val] * num


def build_dense_static_graph(
    cfg: MultiScaleConfig,
    grid_positions: np.ndarray,
    *,
    g2m_rows: int,
    m2m_rows,  # int or per-scale sequence
    m2g_rows: int,
    g2m_slots: Optional[int] = None,
    m2m_slots=None,  # int or per-scale sequence
    m2g_slots: Optional[int] = None,
    tsp_rows: Optional[dict] = None,  # {'g2m','m2m','m2g'} -> sender-row pad
    tsp_slots: Optional[dict] = None,  # {'g2m','m2m','m2g'} -> out-degree pad
) -> DenseStaticGraph:
    """Host-side dense graph build (the same edges as build_static_graph)."""
    n = len(grid_positions)
    out = create_all_edges(cfg, grid_positions)
    k = cfg.max_neighbors
    tr = tsp_rows or {}
    ts = tsp_slots or {}
    ns = cfg.num_scales - 1
    m2m_rows_l = _per_scale(m2m_rows, ns)
    m2m_slots_l = _per_scale(m2m_slots, ns, default=k)
    m2m_tr = _per_scale(tr.get("m2m"), ns)
    m2m_ts = _per_scale(ts.get("m2m"), ns)
    return DenseStaticGraph(
        g2m=dense_edges(out["grid2mesh_edges"], n, g2m_rows, g2m_slots or k,
                        tsp_rows_pad=tr.get("g2m"), tsp_slots=ts.get("g2m")),
        m2m=tuple(
            dense_edges(e, n, m2m_rows_l[s], m2m_slots_l[s] or k, tsp_rows_pad=m2m_tr[s], tsp_slots=m2m_ts[s])
            for s, e in enumerate(out["mesh2mesh_edges_per_scale"])
        ),
        m2g=dense_edges(out["mesh2grid_edges"], n, m2g_rows, m2g_slots or k,
                        tsp_rows_pad=tr.get("m2g"), tsp_slots=ts.get("m2g")),
    )
