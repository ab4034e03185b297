"""Plain reference of GraphCast (Lam et al., "Learning skillful
medium-range global weather forecasting", Science 2023,
arXiv:2212.12794; github.com/google-deepmind/graphcast ``graphcast.py``,
``deep_typed_graph_net.py``, ``icosahedral_mesh.py``, ``losses.py``),
in plain torch over a flat parameter dict, products at the precision
asked for under ``tf32_off``. It shares no code with the program.

With MLP(.) = LN(W2 silu(W1 . + b1) + b2) (one hidden layer of the latent
width; the decoder has no LayerNorm):

  * embedding: v_G = MLP(x_G) (the grid inputs), v_M = MLP(x_M) (cos lat,
    sin lon, cos lon of the mesh node), each edge set e = MLP(f_e);
  * grid2mesh: e' = MLP([v_M_r, v_G_s, e]); v_M += MLP([sum e', v_M]);
    v_G += MLP(v_G);
  * processor: per layer, its own weights: e' = MLP([v_r, v_s, e]);
    v += MLP([sum e', v]); e += e';
  * mesh2grid: e' = MLP([v_G_r, v_M_s, e]); v_G += MLP([sum e', v_G]);
  * decoder: y = W2 silu(W1 v_G + b1) + b2; x_{t+1} = x_t + mu_d + sigma_d y;
  * loss: the mean over grid nodes of the latitude's cell area (mean 1)
    times the sum over channels of the channel's weight times (y - the
    normalised target residual)^2; a channel's weight is its variable's
    (2 m temperature 1, the other surface variables 0.1, atmospheric
    variables 1 times the level's pressure over the mean pressure, over
    the level count).

The first Linears read their inputs concatenated (receiver, sender, edge;
aggregate, node): the program's row order, a fixed permutation of
GraphCast's. Sums at receivers are ``index_add_``.

The graphs, built here by brute force from their definitions:

  * the grid: lat from -90 to 90 (poles included), lon from 0, node
    ``i_lat * n_lon + i_lon``;
  * the icosahedron: the 12 cyclic permutations of (0, +-1, +-phi) on the
    unit sphere, its faces every triple of mutually nearest vertices,
    rotated about y by (pi - acos(-sqrt(5) / 3)) / 2, as GraphCast's;
    each refinement splits every face into four at its sides' midpoints
    pushed out to the sphere; the multi-mesh is the union of every level's
    sides, both directions;
  * grid2mesh: every (grid point, mesh node) pair whose chord is at most
    0.6 times the finest level's longest side;
  * mesh2grid: per grid point, of the finest faces that hold it (every
    barycentric coordinate of the point >= -1e-9), the one whose centre is
    the largest by (z, y, x) (rounded to 1e-9): its three vertices send to
    the point;
  * features: an edge's length and its sender minus its receiver in the
    receiver's (radial, east, north) basis, over the set's longest edge.

Departures from GraphCast, as the configuration lists them: synthetic
fields of ERA5's shape in place of ERA5 (the statistics fixed by the
data); one trajectory's samples in place of decades; the first Linears'
row order (above). One sample a step (the published batch of 32 is one
sample on each of 32 devices).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.common import LN_EPS, Params, Precision

PHI = (1.0 + math.sqrt(5.0)) / 2.0
WEIGHTS = {"2m_temperature": 1.0, "10m_u_component_of_wind": 0.1, "10m_v_component_of_wind": 0.1,
           "mean_sea_level_pressure": 0.1, "total_precipitation_6hr": 0.1}
BETAS = (0.9, 0.95)
EPS = 1e-8
WEIGHT_DECAY = 0.1
WARMUP = 1000
CHUNK = 1024  # grid points or mesh nodes per brute-force block
BARY_TOL = 1e-9
G2M_RADIUS_FRACTION = 0.6  # GraphCast's radius_query_fraction_edge_length


# -- graphs ---------------------------------------------------------------------


def lat_lon_grid(resolution_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    n_lat = int(round(180.0 / resolution_deg)) + 1
    n_lon = int(round(360.0 / resolution_deg))
    lat = np.repeat(np.linspace(-90.0, 90.0, n_lat), n_lon)
    lon = np.tile(np.arange(n_lon) * resolution_deg, n_lat)
    return lat, lon


def unit(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    p, q = np.radians(lat_deg), np.radians(lon_deg)
    return np.stack([np.cos(p) * np.cos(q), np.cos(p) * np.sin(q), np.sin(p)], axis=1)


def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    pts = []
    for a in (-1.0, 1.0):
        for b in (-PHI, PHI):
            pts += [(0.0, a, b), (a, b, 0.0), (b, 0.0, a)]
    v = np.asarray(pts) / math.sqrt(1.0 + PHI * PHI)
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    side = d[d > 1e-9].min()
    near = np.abs(d - side) < 1e-9
    faces = [(i, j, k) for i in range(12) for j in range(i + 1, 12) for k in range(j + 1, 12)
             if near[i, j] and near[j, k] and near[i, k]]
    alpha = (math.pi - math.acos(-math.sqrt(5.0) / 3.0)) / 2.0
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    v = np.stack([x * math.cos(alpha) - z * math.sin(alpha), y, x * math.sin(alpha) + z * math.cos(alpha)], axis=1)
    return v, np.asarray(faces, np.int64)


def refine(v: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    sides = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    uniq, inv = np.unique(sides, axis=0, return_inverse=True)
    mid = v[uniq[:, 0]] + v[uniq[:, 1]]
    mid /= np.linalg.norm(mid, axis=1, keepdims=True)
    m = len(v) + inv.reshape(3, -1)  # the midpoint of each face's sides 01, 12, 20
    a, b, c = faces.T
    new = np.concatenate([np.stack(t, axis=1) for t in ((a, m[0], m[2]), (m[0], b, m[1]), (m[2], m[1], c),
                                                        (m[0], m[1], m[2]))])
    return np.concatenate([v, mid]), new


def mesh(refinement: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vertices [V, 3], finest faces [F, 3], multi-mesh edges [E, 2] as (sender, receiver))."""
    v, f = icosahedron()
    sides = []
    for level in range(refinement + 1):
        if level:
            v, f = refine(v, f)
        s = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        sides += [s, s[:, ::-1]]
    return v, f, np.unique(np.concatenate(sides), axis=0)


def longest_side(v: np.ndarray, f: np.ndarray) -> float:
    s = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    return float(np.linalg.norm(v[s[:, 0]] - v[s[:, 1]], axis=1).max())


def grid2mesh(grid_xyz: np.ndarray, mesh_xyz: np.ndarray, radius: float, device) -> np.ndarray:
    g = torch.as_tensor(grid_xyz, dtype=torch.float64, device=device)
    out = []
    for lo in range(0, len(mesh_xyz), CHUNK):
        m = torch.as_tensor(mesh_xyz[lo:lo + CHUNK], dtype=torch.float64, device=device)
        r, s = torch.nonzero(torch.cdist(m, g) <= radius, as_tuple=True)
        out.append(torch.stack([s, r + lo], dim=1).cpu().numpy())
    return np.concatenate(out)


def mesh2grid(grid_xyz: np.ndarray, mesh_xyz: np.ndarray, faces: np.ndarray, device) -> np.ndarray:
    tri = torch.as_tensor(mesh_xyz[faces], dtype=torch.float64, device=device)  # [F, 3 vertices, 3]
    inv = torch.linalg.inv(tri.transpose(1, 2))  # p = T^T w  ->  w = (T^T)^-1 p
    centre = np.round(mesh_xyz[faces].mean(axis=1) * 1e9)
    order = sorted(range(len(faces)), key=lambda f: (centre[f, 2], centre[f, 1], centre[f, 0]))
    rank = torch.empty(len(faces), dtype=torch.int64, device=device)
    rank[torch.as_tensor(order, device=device)] = torch.arange(len(faces), device=device)
    best = []
    for lo in range(0, len(grid_xyz), CHUNK):
        p = torch.as_tensor(grid_xyz[lo:lo + CHUNK], dtype=torch.float64, device=device)
        holds = torch.einsum("fij,pj->pfi", inv, p).min(dim=-1).values >= -BARY_TOL  # [P, F]
        best.append(torch.where(holds, rank, -1).argmax(dim=1).cpu().numpy())
    face = np.concatenate(best)
    return np.stack([faces[face].reshape(-1), np.repeat(np.arange(len(grid_xyz)), 3)], axis=1)


def lat_lon_of(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (np.degrees(np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0))),
            np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0])) % 360.0)


def node_features(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    return np.stack([np.cos(np.radians(lat)), np.sin(np.radians(lon)), np.cos(np.radians(lon))], axis=1)


def edge_features(edges: np.ndarray, s_xyz, r_xyz, r_lat, r_lon) -> np.ndarray:
    s, r = edges[:, 0], edges[:, 1]
    d = s_xyz[s] - r_xyz[r]
    p, q = np.radians(r_lat[r]), np.radians(r_lon[r])
    radial = r_xyz[r]
    east = np.stack([-np.sin(q), np.cos(q), np.zeros_like(q)], axis=1)
    north = np.stack([-np.sin(p) * np.cos(q), -np.sin(p) * np.sin(q), np.cos(p)], axis=1)
    rel = np.stack([(d * radial).sum(1), (d * east).sum(1), (d * north).sum(1)], axis=1)
    length = np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([length, rel], axis=1) / length.max()


def graphs(mc: dict, device) -> dict:
    """Every graph and feature the forward reads, as tensors on ``device``."""
    lat, lon = lat_lon_grid(mc["resolution_deg"])
    gx = unit(lat, lon)
    mx, faces, m2m = mesh(mc["refinement"])
    m_lat, m_lon = lat_lon_of(mx)
    g2m = grid2mesh(gx, mx, mc["radius_fraction"] * longest_side(mx, faces), device)
    m2g = mesh2grid(gx, mx, faces, device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    out = {"grid_nodes": len(gx), "mesh_nodes": len(mx), "grid_lat": lat, "grid_lon": lon, "mesh_xyz": mx,
           "grid_features": t(node_features(lat, lon)), "mesh_features": t(node_features(m_lat, m_lon))}
    for name, e, sx, rx, rla, rlo in (("g2m", g2m, gx, mx, m_lat, m_lon), ("m2m", m2m, mx, mx, m_lat, m_lon),
                                      ("m2g", m2g, mx, gx, lat, lon)):
        out[name] = (t(e[:, 0], torch.int64), t(e[:, 1], torch.int64))
        out[f"{name}_features"] = t(edge_features(e, sx, rx, rla, rlo))
    return out


# -- the model ------------------------------------------------------------------


def _linear(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def _mlp(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _linear(p, f"{name}.NN-1", F.silu(_linear(p, f"{name}.NN-0", x, prec)), prec)


def _ln(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


def _mlp_ln(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _ln(p, f"{name}.1", _mlp(p, f"{name}.0", x, prec))


def _block(p: Params, name: str, v_recv, v_send, e, edges, prec: Precision):
    s, r = edges
    msg = _mlp_ln(p, f"{name}.edge_fn", torch.cat([v_recv[r], v_send[s], e], dim=-1), prec)
    agg = torch.zeros((v_recv.shape[0], msg.shape[1]), dtype=msg.dtype, device=msg.device).index_add_(0, r, msg)
    return v_recv + _mlp_ln(p, f"{name}.node_fn", torch.cat([agg, v_recv], dim=-1), prec), e + msg


def forward(p: Params, mc: dict, grid_inputs: torch.Tensor, g: dict, prec: Precision) -> torch.Tensor:
    """The normalised residual ``[N_grid, C]`` from the normalised grid inputs."""
    v_g = _mlp_ln(p, "grid_encoder", grid_inputs, prec)
    v_m = _mlp_ln(p, "mesh_encoder", g["mesh_features"], prec)
    e = {k: _mlp_ln(p, f"{k}_edge_encoder", g[f"{k}_features"], prec) for k in ("g2m", "m2m", "m2g")}
    v_m_new, _ = _block(p, "g2m_block", v_m, v_g, e["g2m"], g["g2m"], prec)
    v_g = v_g + _mlp_ln(p, "grid_update", v_g, prec)
    v_m, e_m = v_m_new, e["m2m"]
    for i in range(mc["layers"]):
        v_m, e_m = _block(p, f"m2m_blocks.{i}", v_m, v_m, e_m, g["m2m"], prec)
    v_g, _ = _block(p, "m2g_block", v_g, v_m, e["m2g"], g["m2g"], prec)
    return _mlp(p, "decoder", v_g, prec)


def param_shapes(mc: dict) -> Dict[str, Tuple[int, ...]]:
    """The parameters in the program's ``state_dict`` order."""
    d = mc["latent"]
    node_in = mc["frames"] * (mc["state_dim"] + mc["forcing_dim"]) + mc["forcing_dim"] + mc["static_dim"] + 3
    out: Dict[str, Tuple[int, ...]] = {}

    def mlp(name, n_in, n_out, ln=True):
        base = f"{name}.0" if ln else name
        for i, (a, b) in enumerate(((n_in, d), (d, n_out))):
            out[f"{base}.NN-{i}.weight"] = (b, a)
            out[f"{base}.NN-{i}.bias"] = (b,)
        if ln:
            out[f"{name}.1.weight"] = (n_out,)
            out[f"{name}.1.bias"] = (n_out,)

    def block(name):
        mlp(f"{name}.edge_fn", 3 * d, d)
        mlp(f"{name}.node_fn", 2 * d, d)

    mlp("grid_encoder", node_in, d)
    mlp("mesh_encoder", 3, d)
    for k in ("g2m", "m2m", "m2g"):
        mlp(f"{k}_edge_encoder", 4, d)
    block("g2m_block")
    mlp("grid_update", d, d)
    for i in range(mc["layers"]):
        block(f"m2m_blocks.{i}")
    block("m2g_block")
    mlp("decoder", d, mc["state_dim"], ln=False)
    return out


# -- fields, loss, forecast, optimiser -------------------------------------------


def stats(metadata: dict, device) -> Dict[str, torch.Tensor]:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32, device=device)

    levels = np.asarray(metadata["levels"], np.float64)
    w = [WEIGHTS.get(v, 1.0) for v in metadata["surface_variables"]]
    for v in metadata["atmospheric_variables"]:
        w += [WEIGHTS.get(v, 1.0) * lv / levels.mean() / len(levels) for lv in levels]
    n_lat, n_lon = int(metadata["lat"]), int(metadata["lon"])
    phi = np.radians(np.linspace(-90.0, 90.0, n_lat))
    step = math.pi / (n_lat - 1)
    area = np.where(np.abs(np.abs(phi) - math.pi / 2) < 1e-12, math.sin(step / 4) ** 2, np.cos(phi) * math.sin(step / 2))
    area = area / area.mean()
    out = {k: t(metadata[k]) for k in ("state_mean", "state_std", "diff_mean", "diff_std", "forcing_mean",
                                       "forcing_std", "static_mean", "static_std")}
    out["weight"] = t(w)
    out["lat_weight"] = t(np.repeat(area, n_lon))
    out["n_surface"] = len(metadata["surface_variables"])
    return out


def inputs(st: dict, g: dict, state: torch.Tensor, forcings: torch.Tensor, static: torch.Tensor) -> torch.Tensor:
    """Grid inputs from raw ``state [frames, N, C]``, ``forcings [frames + 1, N, F]``, ``static [N, S]``."""
    parts = []
    for k in range(state.shape[0]):
        parts += [(state[k] - st["state_mean"]) / st["state_std"], (forcings[k] - st["forcing_mean"]) / st["forcing_std"]]
    parts += [(forcings[-1] - st["forcing_mean"]) / st["forcing_std"],
              (static - st["static_mean"]) / st["static_std"], g["grid_features"]]
    return torch.cat(parts, dim=1)


def loss(st: dict, y: torch.Tensor, state: torch.Tensor, target: torch.Tensor, rows=None) -> torch.Tensor:
    """GraphCast's loss of one sample; ``rows`` (bool [N]) keeps only those
    grid nodes in the mean."""
    want = (target - state[-1] - st["diff_mean"]) / st["diff_std"]
    per = ((y - want) ** 2 * st["weight"]).sum(dim=1) * st["lat_weight"]
    return per.mean() if rows is None else per[rows].mean()


def rollout(p: Params, mc: dict, st: dict, g: dict, state: torch.Tensor, forcings: torch.Tensor,
            static: torch.Tensor, steps: int, prec: Precision) -> torch.Tensor:
    f = mc["frames"]
    window: List[torch.Tensor] = [state[k] for k in range(f)]
    out = []
    for k in range(steps):
        y = forward(p, mc, inputs(st, g, torch.stack(window), forcings[k:k + f + 1], static), g, prec)
        nxt = window[-1] + st["diff_mean"] + st["diff_std"] * y
        out.append(nxt)
        window = window[1:] + [nxt]
    return torch.stack(out)


def learning_rate(step: int, lr_peak: float, total_steps: int) -> float:
    """Linear warm-up from 0 over 1,000 steps, then a half cosine to 0 at ``total_steps``."""
    if step < WARMUP:
        return lr_peak * step / WARMUP
    return lr_peak * 0.5 * (1.0 + math.cos(math.pi * min(1.0, (step - WARMUP) / max(1, total_steps - WARMUP))))


class AdamW:
    """AdamW over a dict of leaves (betas 0.9 / 0.95, eps 1e-8, decoupled
    weight decay 0.1 scaled by the learning rate), written out."""

    def __init__(self, params: Params):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Params, grads: Params, lr: float) -> Params:
        b1, b2 = BETAS
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p * (1 - lr * WEIGHT_DECAY) - lr * m_hat / (torch.sqrt(v_hat) + EPS)
        return out
