"""Plain reference of the single-scale learned simulator (encode-process-
decode over a radius graph), from the reference model's description:

  * graph: an edge (sender j, receiver i) for every pair with
    |p_j - p_i|^2 < r^2 (f32 squares of f32 differences, summed over the
    coordinates; r^2 the f32 square of r), self loops included, masked
    nodes neither send nor receive, at most ``slots`` senders per receiver
    (the lowest indices);
  * node features: normalised velocities of the window, then the wall
    distance clamp(x - wall_x, 0, r); edge features (p_j - p_i) / r and its
    norm;
  * encoders MLP + LayerNorm; each interaction network ``msg =
    LN(MLP([x_i, x_j, e]))``, ``x += LN(MLP([sum of msg at i, x_i]))``, ``e
    += msg``; decoder MLP, no LayerNorm; outputs dim accelerations and one
    strain;
  * MLPs of ``num_mlp_layers`` hidden layers of width ``latent``.

Everything is over one flat COO graph (a batch is block-diagonal).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from h100_bench.reference.common import (
    Params,
    Precision,
    features_velocity,
    mlp,
    mlp_ln,
    mlp_shapes,
    segment_sum,
)

WALL_X = -2.0


def param_shapes(mc: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the simulator's parameters (the reference
    ``LearnedSimulator`` layout), for ``mc`` the model sizes: dim, latent,
    layers, hidden layers per MLP, sequence length."""
    d, dim, hid = mc["latent"], mc["dim"], mc["mlp_hidden_layers"]
    node_in = (mc["seq_len"] - 1) * dim + 1
    pre = "_encode_process_decode"
    shapes = {}
    shapes.update(mlp_shapes(f"{pre}._encoder.node_fn", [node_in] + [d] * hid + [d], True))
    shapes.update(mlp_shapes(f"{pre}._encoder.edge_fn", [dim + 1] + [d] * hid + [d], True))
    for m in range(mc["layers"]):
        shapes.update(mlp_shapes(f"{pre}._processor.gnn_stacks.{m}.edge_fn", [3 * d] + [d] * hid + [d], True))
        shapes.update(mlp_shapes(f"{pre}._processor.gnn_stacks.{m}.node_fn", [2 * d] + [d] * hid + [d], True))
    shapes.update(mlp_shapes(f"{pre}._decoder.node_fn", [d] + [d] * hid + [dim + 1], False))
    return shapes


def output_layer(mc: dict) -> str:
    """The name of the decoder's last Linear."""
    return f"_encode_process_decode._decoder.node_fn.NN-{mc['mlp_hidden_layers']}"


def radius_graph(pos: torch.Tensor, mask: torch.Tensor, radius: float, slots: int,
                 chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(senders, receivers) of one graph's edges, receiver-major, senders
    ascending per receiver. pos f32 [N, dim], mask bool [N]."""
    r2 = float(np.float32(radius) * np.float32(radius))
    n = pos.shape[0]
    cols = torch.arange(n, device=pos.device)
    snd, rcv = [], []
    for start in range(0, n, chunk):
        q = pos[start:start + chunk]
        diff = pos[None, :, :] - q[:, None, :]
        d2 = (diff * diff).sum(dim=-1)
        ok = (d2 < r2) & mask[None, :] & mask[start:start + chunk, None]
        # keep the lowest ``slots`` sender indices: rank of each candidate in its row
        rank = torch.cumsum(ok.to(torch.int32), dim=1)
        ok &= rank <= slots
        r_idx, s_idx = torch.nonzero(ok, as_tuple=True)
        snd.append(cols[s_idx])
        rcv.append(r_idx + start)
    return torch.cat(snd), torch.cat(rcv)


def forward(p: Params, mc: dict, windows: torch.Tensor, graph, stats, prec: Precision):
    """(normalised accelerations [M, dim], strain [M]) for flat windows
    [M, S, dim] over the flat graph (senders, receivers)."""
    senders, receivers = graph
    hid, radius, dim = mc["mlp_hidden_layers"], mc["radius"], mc["dim"]
    n_lin = hid + 1
    pre = "_encode_process_decode"
    last = windows[:, -1]
    wall = torch.clamp(last[:, 0:1] - WALL_X, 0.0, radius)
    nf = torch.cat([features_velocity(windows, stats), wall], dim=-1)
    disp = (last[senders] - last[receivers]) / radius
    ef = torch.cat([disp, torch.linalg.vector_norm(disp, dim=-1, keepdim=True)], dim=-1)
    x = mlp_ln(p, f"{pre}._encoder.node_fn", nf, n_lin, prec)
    e = mlp_ln(p, f"{pre}._encoder.edge_fn", ef, n_lin, prec)
    m = x.shape[0]
    for layer in range(mc["layers"]):
        blk = f"{pre}._processor.gnn_stacks.{layer}"
        msg = mlp_ln(p, f"{blk}.edge_fn", torch.cat([x[receivers], x[senders], e], dim=-1), n_lin, prec)
        agg = segment_sum(msg, receivers, m)
        x = x + mlp_ln(p, f"{blk}.node_fn", torch.cat([agg, x], dim=-1), n_lin, prec)
        e = e + msg
    out = mlp(p, f"{pre}._decoder.node_fn", x, n_lin, prec)
    return out[:, :dim], out[:, dim]
