"""Plain reference of MeshGraphNets (Pfaff, Fortunato, Sanchez-Gonzalez,
Battaglia, "Learning Mesh-Based Simulation with Graph Networks", ICLR
2021, arXiv:2010.03409), its Lagrangian variant, in the concatenation
orders of ``meshgraphnets/core_model.py`` (github.com/deepmind/
deepmind-research: ``EncodeProcessDecode``, ``GraphNetBlock``):

  * every MLP is Linear-ReLU stacks of ``mlp_hidden_layers`` hidden layers
    of width ``latent`` and a Linear out, followed by a LayerNorm, except
    the decoder's;
  * encoder: ``v = MLP_V(f)``; mesh edges ``e_M = MLP_M([u_ij, |u_ij|,
    x_ij, |x_ij|])``; world edges ``e_W = MLP_W([x_ij, |x_ij|])``; ``._ij``
    is sender j minus receiver i, u the mesh-space position, x the world
    position;
  * each block: ``m_M = MLP([v_j, v_i, e_M])`` and ``m_W = MLP([v_j, v_i,
    e_W])`` from the block's input v; ``v_i += MLP([v_i, sum_j m_M, sum_j
    m_W])``; ``e_M += m_M``, ``e_W += m_W``;
  * decoder ``MLP_D(v)``: dim accelerations and one strain.

Graphs, built here by brute force:

  * mesh: every pair (j, i), j != i, of the trajectory's first frame closer
    than ``mesh_radius`` (float64 distances);
  * world: every pair of the last position closer than ``world_radius``
    (f32 squares of f32 differences summed over the coordinates, against
    the f32 square of the radius), neither self nor a mesh pair.

Departures from MeshGraphNets, as the configuration lists them: fixed
dataset statistics in place of its online normalisers (velocities and
accelerations normalised with the noise folded into the std); the repo's
random-walk training noise; the clamped wall distance ``clamp(x - wall_x,
0, radius)`` as a node feature beside the one velocity (there is one
particle type, so no one-hot); a quad mesh built from the radius in place
of a shipped triangle mesh; the port's head, loss and Euler step. Also
the program's two caps on the world edges, ``world_search_slots`` per
receiver before self and mesh pairs are taken out and ``world_slots``
after (the lowest sender indices kept): the derived widths keep them from
binding. Everything is over one flat COO graph (a batch is
block-diagonal); products at the precision asked for, under ``tf32_off``.
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
    tf32_off,
)

WALL_X = -2.0
PRE = "_encode_process_decode"


def param_shapes(mc: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the simulator's parameters (the port's
    ``MeshSimulator`` layout)."""
    d, dim, hid = mc["latent"], mc["dim"], mc["mlp_hidden_layers"]
    node_in = (mc["seq_len"] - 1) * dim + 1
    shapes = {}
    shapes.update(mlp_shapes(f"{PRE}._encoder.node_fn", [node_in] + [d] * hid + [d], True))
    shapes.update(mlp_shapes(f"{PRE}._encoder.mesh_edge_fn", [2 * (dim + 1)] + [d] * hid + [d], True))
    shapes.update(mlp_shapes(f"{PRE}._encoder.world_edge_fn", [dim + 1] + [d] * hid + [d], True))
    for m in range(mc["layers"]):
        for fn in ("mesh_edge_fn", "world_edge_fn", "node_fn"):
            shapes.update(mlp_shapes(f"{PRE}._processor.blocks.{m}.{fn}", [3 * d] + [d] * hid + [d], True))
    shapes.update(mlp_shapes(f"{PRE}._decoder.node_fn", [d] + [d] * hid + [dim + 1], False))
    return shapes


def output_layer(mc: dict) -> str:
    """The name of the decoder's last Linear."""
    return f"{PRE}._decoder.node_fn.NN-{mc['mlp_hidden_layers']}"


def mesh_graph(first_frame: np.ndarray, radius: float, chunk: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) of the mesh of one trajectory, receiver-major."""
    pos = np.asarray(first_frame, np.float64)
    snd, rcv = [], []
    for start in range(0, pos.shape[0], chunk):
        d = np.linalg.norm(pos[None, :, :] - pos[start:start + chunk, None, :], axis=-1)
        ok = d < radius
        r_idx, s_idx = np.nonzero(ok)
        keep = s_idx != r_idx + start
        snd.append(s_idx[keep])
        rcv.append(r_idx[keep] + start)
    return np.concatenate(snd), np.concatenate(rcv)


def world_graph(pos: torch.Tensor, mesh: Tuple[np.ndarray, np.ndarray], mc: dict,
                chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(senders, receivers) of one graph's world edges at positions pos
    [n, dim] (f32), receiver-major, senders ascending per receiver."""
    r = np.float32(mc["world_radius"])
    r2 = float(r * r)
    n, dev = pos.shape[0], pos.device
    on_mesh = torch.zeros((n, n), dtype=torch.bool, device=dev)
    on_mesh[torch.as_tensor(mesh[1], device=dev), torch.as_tensor(mesh[0], device=dev)] = True
    on_mesh.fill_diagonal_(True)
    snd, rcv = [], []
    for start in range(0, n, chunk):
        q = pos[start:start + chunk]
        diff = pos[None, :, :] - q[:, None, :]
        ok = (diff * diff).sum(dim=-1) < r2
        ok &= torch.cumsum(ok.to(torch.int32), dim=1) <= mc["world_search_slots"]
        ok &= ~on_mesh[start:start + chunk]
        ok &= torch.cumsum(ok.to(torch.int32), dim=1) <= mc["world_slots"]
        r_idx, s_idx = torch.nonzero(ok, as_tuple=True)
        snd.append(s_idx)
        rcv.append(r_idx + start)
    return torch.cat(snd), torch.cat(rcv)


def _displacement(pos: torch.Tensor, senders, receivers, radius: float) -> torch.Tensor:
    disp = (pos[senders] - pos[receivers]) / radius
    return torch.cat([disp, torch.linalg.vector_norm(disp, dim=-1, keepdim=True)], dim=-1)


def forward(p: Params, mc: dict, windows: torch.Tensor, graph: dict, stats, prec: Precision):
    """(normalised accelerations [M, dim], strain [M]) for flat windows
    [M, S, dim] over the flat graph: ``graph["mesh"]`` and
    ``graph["world"]`` (senders, receivers), ``graph["rest"]`` the
    mesh-space positions [M, dim]."""
    hid, dim = mc["mlp_hidden_layers"], mc["dim"]
    n_lin = hid + 1
    m_snd, m_rcv = graph["mesh"]
    w_snd, w_rcv = graph["world"]
    with tf32_off():
        last = windows[:, -1]
        wall = torch.clamp(last[:, 0:1] - WALL_X, 0.0, mc["radius"])
        nf = torch.cat([features_velocity(windows, stats), wall], dim=-1)
        mesh_f = torch.cat([_displacement(graph["rest"], m_snd, m_rcv, mc["mesh_radius"]),
                            _displacement(last, m_snd, m_rcv, mc["mesh_radius"])], dim=-1)
        world_f = _displacement(last, w_snd, w_rcv, mc["world_radius"])
        x = mlp_ln(p, f"{PRE}._encoder.node_fn", nf, n_lin, prec)
        e_m = mlp_ln(p, f"{PRE}._encoder.mesh_edge_fn", mesh_f, n_lin, prec)
        e_w = mlp_ln(p, f"{PRE}._encoder.world_edge_fn", world_f, n_lin, prec)
        n = x.shape[0]
        for layer in range(mc["layers"]):
            blk = f"{PRE}._processor.blocks.{layer}"
            msg_m = mlp_ln(p, f"{blk}.mesh_edge_fn", torch.cat([x[m_snd], x[m_rcv], e_m], dim=-1), n_lin, prec)
            msg_w = mlp_ln(p, f"{blk}.world_edge_fn", torch.cat([x[w_snd], x[w_rcv], e_w], dim=-1), n_lin, prec)
            upd = torch.cat([x, segment_sum(msg_m, m_rcv, n), segment_sum(msg_w, w_rcv, n)], dim=-1)
            x = x + mlp_ln(p, f"{blk}.node_fn", upd, n_lin, prec)
            e_m = e_m + msg_m
            e_w = e_w + msg_w
        out = mlp(p, f"{PRE}._decoder.node_fn", x, n_lin, prec)
    return out[:, :dim], out[:, dim]
