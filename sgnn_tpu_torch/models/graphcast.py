"""GraphCast: an encode-process-decode GNN from a lat-lon grid to an
icosahedral multi-mesh and back (Lam et al., Science 2023,
arXiv:2212.12794; github.com/google-deepmind/graphcast ``graphcast.py``,
``deep_typed_graph_net.py``).

With MLP(.) = LN(W2 act(W1 . + b1) + b2), act SiLU (swish), one hidden
layer of the latent width:

  * embedding: v_G = MLP(x_G) on the grid, v_M = MLP(x_M) on the mesh, and
    each edge set's four structural features through an MLP of its own;
  * grid2mesh: e' = MLP_e([v_M_r, v_G_s, e]); v_M_r += MLP_v([sum_s e',
    v_M_r]); v_G += MLP(v_G);
  * processor: ``layers`` interaction steps on the multi-mesh, unshared:
    e' = MLP_e([v_r, v_s, e]); v_r += MLP_v([sum e', v_r]); e += e';
  * mesh2grid: e' = MLP_e([v_G_r, v_M_s, e]); v_G_r += MLP_v([sum e', v_G_r]);
  * decoder: y = W2 act(W1 v_G + b1) + b2, no LayerNorm.

The first Linears take their inputs in the port's interaction-network
order (receiver, sender, edge; aggregate, node): a fixed permutation of
GraphCast's rows. Every stage is ``models/multi_scale._interact`` over COO
edges (``physics/sphere_graph.build_graph``): the bipartite stages give
the sender table (``x_sender_table``: the grid's latents in grid2mesh, the
mesh's in mesh2grid) and the receivers' latents; the gathers and sums are
the row-gather kernels and the products ``ops/f32_product.linear``.

``GraphCast`` is the simulator: the parameters, the graphs on the device
(built on the host at init, kept out of ``state_dict``) and the
normalisation of the fields: inputs (two frames of the state and their
forcings, the target time's forcings, the static fields, each
z-scored by the dataset's statistics, and the grid's cos(lat), sin(lon),
cos(lon)) and the prediction y of the normalised residual,
x_{t+1} = x_t + mu_delta + sigma_delta * y. The loss (``loss_terms``) is
GraphCast's: the squared error of y against the normalised target
residual, weighted by the latitude's cell area, by the variable and by the
pressure level (``field_stats``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.models.encode_process_decode import InteractionNetwork, mlp_ln_apply
from sgnn_tpu_torch.models.multi_scale import _interact
from sgnn_tpu_torch.nn.core import MLP, mlp_ln
from sgnn_tpu_torch.physics import sphere_graph
from sgnn_tpu_torch.physics.multi_scale_graph import PaddedEdges

ACTIVATION = "silu"
EDGE_FEATURES = 4
NODE_POSITION_FEATURES = 3
G2M_RADIUS_FRACTION = 0.6  # of the finest mesh level's longest edge (GraphCast's radius_query_fraction_edge_length)
# GraphCast's per-variable loss weights (graphcast/losses.py as its training
# sets them); every other variable weighs 1, and an atmospheric variable's
# levels by their pressure over the mean pressure
VARIABLE_WEIGHTS = {"2m_temperature": 1.0, "10m_u_component_of_wind": 0.1, "10m_v_component_of_wind": 0.1,
                    "mean_sea_level_pressure": 0.1, "total_precipitation_6hr": 0.1}


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    """The model's sizes and its graphs' parameters."""

    latent_dim: int
    num_message_passing_steps: int
    state_dim: int  # predicted variables per grid node (surface + atmospheric x levels)
    forcing_dim: int
    static_dim: int
    resolution_deg: float
    mesh_refinement: int
    edge_pad_multiple: int = 1024
    input_frames: int = 2

    @property
    def hidden_dims(self):
        """Every MLP's one hidden layer, of the latent width."""
        return [self.latent_dim]

    @property
    def node_in(self) -> int:
        """Grid inputs: every input frame's state and forcings, the target
        time's forcings, the static fields, the node's position features."""
        return (self.input_frames * (self.state_dim + self.forcing_dim) + self.forcing_dim + self.static_dim
                + NODE_POSITION_FEATURES)


class FieldStats(NamedTuple):
    """Normalisation and loss weights on the device."""

    state_mean: torch.Tensor  # [C]
    state_std: torch.Tensor
    diff_mean: torch.Tensor  # the 6-hour residual's
    diff_std: torch.Tensor
    forcing_mean: torch.Tensor  # [F]
    forcing_std: torch.Tensor
    static_mean: torch.Tensor  # [S]
    static_std: torch.Tensor
    channel_weight: torch.Tensor  # [C]: variable weight, over the level count for an atmospheric one
    lat_weight: torch.Tensor  # [N]: cell area by latitude, mean 1
    surface: torch.Tensor  # bool[C]


def latitude_weights(n_lat: int) -> np.ndarray:
    """f64[n_lat]: the area of each latitude's cells on an equiangular grid
    with poles (GraphCast's ``_weight_for_latitude_vector_with_poles``):
    cos(lat) sin(d/2) inside, sin(d/4)^2 at the poles; mean 1."""
    lat = np.deg2rad(np.linspace(-90.0, 90.0, n_lat))
    d = np.pi / (n_lat - 1)
    w = np.cos(lat) * np.sin(d / 2)
    w[0] = w[-1] = np.sin(d / 4) ** 2
    return w / w.mean()


def channel_weights(metadata: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(f64[C] weights, bool[C] surface) of the state's channels: surface
    variables first, then each atmospheric variable at every level."""
    levels = np.asarray(metadata["levels"], np.float64)
    level_w = levels / levels.mean()
    w = [VARIABLE_WEIGHTS.get(v, 1.0) for v in metadata["surface_variables"]]
    for v in metadata["atmospheric_variables"]:
        w += list(VARIABLE_WEIGHTS.get(v, 1.0) * level_w / len(levels))
    n_surface = len(metadata["surface_variables"])
    return np.asarray(w), np.arange(len(w)) < n_surface


def field_stats(metadata: dict, noise_std: float = 0.0, device=None) -> FieldStats:
    """The dataset's statistics and the loss weights (``noise_std`` is the
    seam's argument: GraphCast adds no input noise)."""
    del noise_std

    def t(key):
        return torch.tensor(metadata[key], dtype=torch.float32, device=device)

    cw, surface = channel_weights(metadata)
    lat_w = np.repeat(latitude_weights(int(metadata["lat"])), int(metadata["lon"]))
    return FieldStats(t("state_mean"), t("state_std"), t("diff_mean"), t("diff_std"), t("forcing_mean"),
                      t("forcing_std"), t("static_mean"), t("static_std"),
                      torch.tensor(cw, dtype=torch.float32, device=device),
                      torch.tensor(lat_w, dtype=torch.float32, device=device),
                      torch.tensor(surface, device=device))


class GraphTensors(NamedTuple):
    """``sphere_graph.SphereGraph`` on the device, with each edge set's
    senders in sender order."""

    grid_features: torch.Tensor
    mesh_features: torch.Tensor
    g2m: PaddedEdges
    m2m: PaddedEdges
    m2g: PaddedEdges
    g2m_features: torch.Tensor
    m2m_features: torch.Tensor
    m2g_features: torch.Tensor
    sorted_senders: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def graph_tensors(g: sphere_graph.SphereGraph, device) -> GraphTensors:
    def edges(pe: PaddedEdges) -> PaddedEdges:
        return PaddedEdges(*(torch.as_tensor(a, device=device) for a in pe))

    def t(a):
        return torch.as_tensor(a, device=device)

    sets = [edges(pe) for pe in (g.g2m, g.m2m, g.m2g)]
    return GraphTensors(t(g.grid_features), t(g.mesh_features), *sets, t(g.g2m_features), t(g.m2m_features),
                        t(g.m2g_features), tuple(pe.senders.index_select(0, pe.order) for pe in sets))


class GraphCast(nn.Module):
    """Parameters: ``grid_encoder``, ``mesh_encoder``,
    ``{g2m,m2m,m2g}_edge_encoder`` (each ``Sequential(MLP, LayerNorm)``),
    ``g2m_block``, ``grid_update``, ``m2m_blocks.{m}``, ``m2g_block``
    (``edge_fn`` / ``node_fn``), ``decoder`` (MLP). ``graph`` (the graphs on
    the device) and ``edge_counts`` (per stage: valid edges, padded edge
    rows) are attributes, not state."""

    def __init__(self, cfg: GraphCastConfig, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device, activation=ACTIVATION)
        d, hidden = cfg.latent_dim, cfg.hidden_dims
        self.cfg = cfg
        self.grid_encoder = mlp_ln(cfg.node_in, hidden, d, **kw)
        self.mesh_encoder = mlp_ln(NODE_POSITION_FEATURES, hidden, d, **kw)
        self.g2m_edge_encoder = mlp_ln(EDGE_FEATURES, hidden, d, **kw)
        self.m2m_edge_encoder = mlp_ln(EDGE_FEATURES, hidden, d, **kw)
        self.m2g_edge_encoder = mlp_ln(EDGE_FEATURES, hidden, d, **kw)
        self.g2m_block = InteractionNetwork(cfg, **kw)
        self.grid_update = mlp_ln(d, hidden, d, **kw)
        self.m2m_blocks = nn.ModuleList(InteractionNetwork(cfg, **kw) for _ in range(cfg.num_message_passing_steps))
        self.m2g_block = InteractionNetwork(cfg, **kw)
        self.decoder = MLP(d, hidden, cfg.state_dim, **kw)
        built = sphere_graph.build_graph(cfg.resolution_deg, cfg.mesh_refinement, G2M_RADIUS_FRACTION,
                                         cfg.edge_pad_multiple)
        self.edge_counts: Dict[str, Tuple[int, int]] = built.edge_counts
        self.graph = graph_tensors(built, device)


def _edges(enc: nn.Sequential, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return mlp_ln_apply(enc, feats) * mask[:, None].to(feats.dtype)


def graphcast_apply(gc: GraphCast, grid_inputs: torch.Tensor) -> torch.Tensor:
    """The forward: grid inputs ``[N_grid, node_in]`` (normalised) -> the
    normalised residual ``[N_grid, state_dim]``."""
    g = gc.graph
    s_g2m, s_m2m, s_m2g = g.sorted_senders
    v_grid = mlp_ln_apply(gc.grid_encoder, grid_inputs)
    v_mesh = mlp_ln_apply(gc.mesh_encoder, g.mesh_features)
    e_g2m = _edges(gc.g2m_edge_encoder, g.g2m_features, g.g2m.mask)
    e_m2m = _edges(gc.m2m_edge_encoder, g.m2m_features, g.m2m.mask)
    e_m2g = _edges(gc.m2g_edge_encoder, g.m2g_features, g.m2g.mask)
    v_mesh, _ = _interact(gc.g2m_block, v_mesh, e_g2m, g.g2m, s_g2m, x_sender_table=v_grid)
    v_grid = v_grid + mlp_ln_apply(gc.grid_update, v_grid)
    for block in gc.m2m_blocks:
        v_mesh, e_m2m = _interact(block, v_mesh, e_m2m, g.m2m, s_m2m)
    v_grid, _ = _interact(gc.m2g_block, v_grid, e_m2g, g.m2g, s_m2g, x_sender_table=v_mesh)
    return gc.decoder(v_grid)


def grid_inputs(gc: GraphCast, stats: FieldStats, state: torch.Tensor, forcings: torch.Tensor,
                static: torch.Tensor) -> torch.Tensor:
    """``[N, node_in]`` from raw fields: ``state [frames, N, C]``,
    ``forcings [frames + 1, N, F]`` (the input frames' and the target
    time's), ``static [N, S]``."""
    s = (state - stats.state_mean) / stats.state_std
    f = (forcings - stats.forcing_mean) / stats.forcing_std
    parts = []
    for k in range(state.shape[0]):
        parts += [s[k], f[k]]
    parts += [f[-1], (static - stats.static_mean) / stats.static_std, gc.graph.grid_features]
    return torch.cat(parts, dim=-1)


def predict_residual(gc: GraphCast, stats: FieldStats, state, forcings, static) -> torch.Tensor:
    """The normalised residual y of one sample."""
    return graphcast_apply(gc, grid_inputs(gc, stats, state, forcings, static))


def next_state(stats: FieldStats, last: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return last + stats.diff_mean + stats.diff_std * y


def target_residual(stats: FieldStats, last: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - last - stats.diff_mean) / stats.diff_std


def loss_terms(stats: FieldStats, y: torch.Tensor, want: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(surface, atmospheric) parts of GraphCast's loss of one sample: the
    mean over grid nodes of the latitude weight times the channel-weighted
    squared error."""
    per = (y - want).square() * stats.channel_weight  # [N, C]
    surf = (per * stats.surface).sum(dim=-1)
    atm = (per * ~stats.surface).sum(dim=-1)
    return (surf * stats.lat_weight).mean(), (atm * stats.lat_weight).mean()


def rollout(gc: GraphCast, stats: FieldStats, state: torch.Tensor, forcings: torch.Tensor, static: torch.Tensor,
            steps: int) -> torch.Tensor:
    """``steps`` autoregressive 6-hour steps from the first ``frames``
    frames of ``state [T, N, C]`` with the known ``forcings [T, N, F]``:
    the predicted states ``[steps, N, C]``."""
    frames = gc.cfg.input_frames
    window = [state[k] for k in range(frames)]
    out = []
    for k in range(steps):
        y = predict_residual(gc, stats, torch.stack(window), forcings[k:k + frames + 1], static)
        nxt = next_state(stats, window[-1], y)
        out.append(nxt)
        window = window[1:] + [nxt]
    return torch.stack(out)


def lat_weighted_rmse(stats: FieldStats, pred: torch.Tensor, truth: torch.Tensor,
                      channels: torch.Tensor) -> torch.Tensor:
    """Per step: the latitude-weighted RMSE over ``channels`` of the
    states in units of each channel's standard deviation."""
    err = ((pred - truth) / stats.state_std).square()[..., channels].mean(dim=-1)  # [T, N]
    return torch.sqrt((err * stats.lat_weight).mean(dim=-1))
