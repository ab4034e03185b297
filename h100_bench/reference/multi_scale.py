"""Plain reference of the multi-scale simulator: a static grid -> mesh
hierarchy built once per trajectory from its first frame, and G2M, M2M
and M2G interaction networks over it.

The hierarchy follows the reference's ``multi_scale`` graph construction:

  * scale s keeps, of scale s-1's nodes, those whose every coordinate is
    one of every ``window``-th distinct value of that coordinate (in
    float64, sorted);
  * a radius graph (strict < r, self loops, at most ``max_neighbors``
    senders per receiver, the lowest indices) over the grid at r = grid
    spacing * multiplier gives G2M (receiver in scale 1) and M2G (sender
    in scale 1); each mesh scale s has its own radius graph at r =
    spacing * window^s * multiplier, over global indices.

The model: the grid node encoder, one edge encoder per edge type, a G2M
block, ``layers`` M2M blocks (over every scale's edges at once, the edge
latents carried from block to block), an M2G block and the prediction
head; each block ``msg = LN(MLP([x_i, x_j, e]))``, ``x += LN(MLP([sum of
msg at i, x_i]))`` over all nodes. Edge features are (p_j - p_i) / r and
the norm, r the grid radius for G2M and M2G and the coarsest scale's for
M2M; the wall distance is clamp(x - wall_x, 0, r_grid) / r_grid. The
radius search is scipy's cKDTree (the port builds with its own C++ one).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from h100_bench.reference.common import Params, Precision, features_velocity, mlp, mlp_ln, mlp_shapes, segment_sum

WALL_X = -2.0
GRID_SPACING = 0.5
MAX_NEIGHBORS = 24
EDGE_TYPES = ("g2m", "m2m", "m2g")


def param_shapes(mc: dict) -> Dict[str, Tuple[int, ...]]:
    """The reference ``MultiScaleSimulator`` layout (``_multi_scale_gnn.*``)."""
    d, dim, hid = mc["latent"], mc["dim"], mc["mlp_hidden_layers"]
    node_in = (mc["seq_len"] - 1) * dim + 1
    pre = "_multi_scale_gnn"
    shapes = {}
    shapes.update(mlp_shapes(f"{pre}.grid_node_encoder", [node_in] + [d] * hid + [d], True))
    for t in EDGE_TYPES:
        shapes.update(mlp_shapes(f"{pre}.{t}_edge_encoder", [dim + 1] + [d] * hid + [d], True))

    def block(name):
        shapes.update(mlp_shapes(f"{name}.edge_fn", [3 * d] + [d] * hid + [d], True))
        shapes.update(mlp_shapes(f"{name}.node_fn", [2 * d] + [d] * hid + [d], True))

    block(f"{pre}.g2m_block")
    for m in range(mc["layers"]):
        block(f"{pre}.m2m_blocks.{m}")
    block(f"{pre}.m2g_block")
    shapes.update(mlp_shapes(f"{pre}.prediction_head", [d] + [d] * hid + [dim + 1], False))
    return shapes


def output_layer(mc: dict) -> str:
    return f"_multi_scale_gnn.prediction_head.NN-{mc['mlp_hidden_layers']}"


def _radius_edges(points: np.ndarray, r: float, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    snd, rcv = [], []
    for i, nbrs in enumerate(tree.query_ball_point(points, r)):
        nbrs = np.sort(np.asarray(nbrs, np.int64))
        nbrs = nbrs[np.linalg.norm(points[nbrs] - points[i], axis=-1) < r][:cap]
        snd.append(nbrs)
        rcv.append(np.full(len(nbrs), i, np.int64))
    return np.concatenate(snd), np.concatenate(rcv)


def hierarchy(frame0: np.ndarray, mc: dict) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """(senders, receivers) per edge type over the grid's global indices,
    from the first frame [N, dim] of a trajectory's real particles."""
    pts = np.asarray(frame0, np.float64)
    window, mult, scales = mc["window_size"], mc["radius_multiplier"], mc["num_scales"]
    levels = [np.arange(len(pts))]
    for _ in range(1, scales):
        cur = pts[levels[-1]]
        keep = np.ones(len(cur), bool)
        for d in range(cur.shape[1]):
            keep &= np.isin(cur[:, d], np.unique(cur[:, d])[::window])
        levels.append(levels[-1][np.nonzero(keep)[0]])
    s, r = _radius_edges(pts, mult * GRID_SPACING, MAX_NEIGHBORS)
    is_mesh = np.zeros(len(pts), bool)
    is_mesh[levels[1]] = True
    out = {"g2m": (s[is_mesh[r]], r[is_mesh[r]]), "m2g": (s[is_mesh[s]], r[is_mesh[s]])}
    m_s, m_r = [], []
    for scale in range(1, scales):
        idx = levels[scale]
        es, er = _radius_edges(pts[idx], GRID_SPACING * window ** scale * mult, MAX_NEIGHBORS)
        m_s.append(idx[es])
        m_r.append(idx[er])
    out["m2m"] = (np.concatenate(m_s), np.concatenate(m_r))
    return out


def batch_hierarchy(graphs: List[Dict], n: int, device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Block-diagonal union of per-sample hierarchies over samples of n
    nodes each, as device tensors."""
    out = {}
    for t in EDGE_TYPES:
        s = np.concatenate([g[t][0] + i * n for i, g in enumerate(graphs)])
        r = np.concatenate([g[t][1] + i * n for i, g in enumerate(graphs)])
        out[t] = (torch.from_numpy(s).to(device), torch.from_numpy(r).to(device))
    return out


def forward(p: Params, mc: dict, windows: torch.Tensor, graph, stats, prec: Precision):
    """(normalised accelerations [M, dim], strain [M]) for flat windows
    [M, S, dim] over the flat hierarchy ``graph`` (per type (senders,
    receivers))."""
    hid, dim = mc["mlp_hidden_layers"], mc["dim"]
    n_lin = hid + 1
    r_grid = mc["radius_multiplier"] * GRID_SPACING
    r_coarse = GRID_SPACING * mc["window_size"] ** (mc["num_scales"] - 1) * mc["radius_multiplier"]
    pre = "_multi_scale_gnn"
    last = windows[:, -1]
    wall = torch.clamp(last[:, 0:1] - WALL_X, 0.0, r_grid) / r_grid
    nf = torch.cat([features_velocity(windows, stats), wall], dim=-1)
    x = mlp_ln(p, f"{pre}.grid_node_encoder", nf, n_lin, prec)
    m = x.shape[0]
    lat = {}
    for t in EDGE_TYPES:
        s, r = graph[t]
        disp = (last[s] - last[r]) / (r_coarse if t == "m2m" else r_grid)
        ef = torch.cat([disp, torch.linalg.vector_norm(disp, dim=-1, keepdim=True)], dim=-1)
        lat[t] = mlp_ln(p, f"{pre}.{t}_edge_encoder", ef, n_lin, prec)

    def block(name, t):
        nonlocal x
        s, r = graph[t]
        msg = mlp_ln(p, f"{name}.edge_fn", torch.cat([x[r], x[s], lat[t]], dim=-1), n_lin, prec)
        agg = segment_sum(msg, r, m)
        x = x + mlp_ln(p, f"{name}.node_fn", torch.cat([agg, x], dim=-1), n_lin, prec)
        lat[t] = lat[t] + msg

    block(f"{pre}.g2m_block", "g2m")
    for layer in range(mc["layers"]):
        block(f"{pre}.m2m_blocks.{layer}", "m2m")
    block(f"{pre}.m2g_block", "m2g")
    out = mlp(p, f"{pre}.prediction_head", x, n_lin, prec)
    return out[:, :dim], out[:, dim]
