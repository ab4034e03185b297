"""Multi-scale GNN: grid encoder + G2M -> M x M2M -> M2G interaction blocks.

Port of ``sgnn_tpu/models/multi_scale.py``: ``MSGNNConfig``, the
parameter module ``MultiScaleGNN``, the COO forward (``_interact``,
``multi_scale_gnn_apply``), the dense-slot forward (``_interact_dense``,
``_interact_dense_scales``, ``multi_scale_gnn_apply_dense``) and the
batch flattening of both layouts (``flatten_ms_graph``,
``flatten_dense_ms_graph``).

Node state is one full-grid ``[N, D]`` tensor at every stage; the mesh
scales exist only as edge lists over global grid indices. G2M, M2M and
M2G blocks are the same interaction network over different static edge
lists: ``msg = edge_fn([x_receiver, x_sender, e])``, sum at receivers,
``upd = node_fn([agg, x])``, residuals on nodes and edges; the node
update runs on ALL N nodes. The first Linear of ``edge_fn`` is applied in
split form, so the receiver and sender projections are ``[N, H]`` node
products whose rows are gathered per edge. Every latent-row gather is
the row-gather kernel, and every sum at receivers the sorted segment sum
kernel, inside the autograd Functions of ``ops/row_gather``, as JAX's
custom VJPs; none adds with atomics, so the bits repeat from run to run:

  * receivers (ascending): ``sorted_gather``, backward the sorted segment
    sum kernel; the COO layout's receivers ascend once a graph is
    flattened (``flatten_ms_graph``, a batch of one in serving);
  * dense senders: ``planned_gather``, backward the transpose plan's kernel;
  * COO senders: ``ordered_gather`` over the graph's sender order
    (``PaddedEdges.order``), backward the sorted segment sum of the
    cotangent's rows in that order (JAX's plain gather transposes to XLA's
    unsorted scatter there);
  * aggregation at receivers: ``sorted_sum`` (JAX's ``segment_sum`` over
    receiver-sorted ids), backward a gather.

``compute_dtype`` (bf16) lowers the edge-sized tensors; aggregation,
LayerNorm moments, node updates and the prediction head stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from sgnn_tpu_torch.models.encode_process_decode import (
    InteractionNetwork,
    mlp_ln_apply,
    mlp_tail,
    split_first_layer,
)
from sgnn_tpu_torch.nn.core import MLP, layer_norm, mlp_ln
from sgnn_tpu_torch.ops.row_gather import ordered_gather, planned_gather, sorted_gather, sorted_sum
from sgnn_tpu_torch.physics.multi_scale_graph import DenseEdges, DenseStaticGraph, PaddedEdges, StaticGraph


@dataclasses.dataclass(frozen=True)
class MSGNNConfig:
    """Hyperparameters (the JAX ``MSGNNConfig``; two hidden layers per MLP
    is the reference trainer's default)."""

    node_in: int
    edge_in: int
    node_out: int
    latent_dim: int
    num_message_passing_steps: int
    num_mlp_layers: int = 2

    @property
    def hidden_dims(self):
        return [self.latent_dim] * self.num_mlp_layers


class MultiScaleGNN(nn.Module):
    """Parameters in the reference ``MultiScaleGNN`` key layout:
    ``grid_node_encoder``, ``{g2m,m2m,m2g}_edge_encoder`` (each
    ``Sequential(MLP, LayerNorm)``), ``g2m_block``, ``m2m_blocks.{m}``,
    ``m2g_block`` (each with ``edge_fn``/``node_fn``) and
    ``prediction_head`` (MLP). The forwards are the functions below."""

    def __init__(self, cfg: MSGNNConfig, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d, hidden = cfg.latent_dim, cfg.hidden_dims
        self.grid_node_encoder = mlp_ln(cfg.node_in, hidden, d, **kw)
        self.g2m_edge_encoder = mlp_ln(cfg.edge_in, hidden, d, **kw)
        self.m2m_edge_encoder = mlp_ln(cfg.edge_in, hidden, d, **kw)
        self.m2g_edge_encoder = mlp_ln(cfg.edge_in, hidden, d, **kw)
        self.g2m_block = InteractionNetwork(cfg, **kw)
        self.m2m_blocks = nn.ModuleList(InteractionNetwork(cfg, **kw) for _ in range(cfg.num_message_passing_steps))
        self.m2g_block = InteractionNetwork(cfg, **kw)
        self.prediction_head = MLP(d, hidden, cfg.node_out, **kw)


def _mlp_tail_in(mlp: MLP, h: torch.Tensor) -> torch.Tensor:
    """``mlp_tail`` that keeps the activations in h's dtype (weights cast
    to it); identical to ``mlp_tail`` in f32."""
    dt = h.dtype
    linears = mlp.linears
    if len(linears) == 1:
        return h
    x = torch.relu(h)
    for lin in linears[1:-1]:
        x = torch.relu(x @ lin.weight.t().to(dt) + lin.bias.to(dt))
    last = linears[-1]
    return x @ last.weight.t().to(dt) + last.bias.to(dt)


def _edge_mlp_in(block: InteractionNetwork, d: int, dt: torch.dtype):
    """The edge MLP's first Linear split over [x_i, x_j, e]."""
    (w_i, w_j, w_e), b_e = split_first_layer(block.edge_fn[0], (d, d, d))
    return w_i, w_j, w_e.to(dt), b_e.to(dt)


def _edge_msg(block: InteractionNetwork, h: torch.Tensor, maskf: torch.Tensor) -> torch.Tensor:
    ln = block.edge_fn[1]
    return layer_norm(_mlp_tail_in(block.edge_fn[0], h), ln.weight, ln.bias) * maskf


def _node_update(block: InteractionNetwork, x: torch.Tensor, agg_hn: torch.Tensor) -> torch.Tensor:
    """x + LN(node_fn(cat[agg, x])) given ``agg_hn``, the aggregate
    already through its block of the first Linear (f32)."""
    d = x.shape[-1]
    (_, w_x), b_n = split_first_layer(block.node_fn[0], (d, d))
    ln = block.node_fn[1]
    upd = layer_norm(mlp_tail(block.node_fn[0], agg_hn + x @ w_x + b_n), ln.weight, ln.bias)
    return x + upd


def _agg_weight(block: InteractionNetwork, d: int) -> torch.Tensor:
    (w_agg, _), _ = split_first_layer(block.node_fn[0], (d, d))
    return w_agg


def _interact(block: InteractionNetwork, x: torch.Tensor, e: torch.Tensor, edges, sorted_senders: torch.Tensor,
              compute_dtype=None):
    """One interaction step over flattened padded COO edges (``PaddedEdges``
    of tensors, ``flatten_ms_graph``'s contract: receivers non-decreasing,
    padding included; ``sorted_senders = senders[order]``): padded slots
    (mask False) add nothing to the aggregation and their latents stay
    zero. Returns (new x [N, D], new e [E, D])."""
    d, n = x.shape[-1], x.shape[0]
    dt = e.dtype if compute_dtype is None else compute_dtype
    maskf = edges.mask[:, None].to(dt)
    w_i, w_j, w_e, b_e = _edge_mlp_in(block, d, dt)
    proj_i = x @ w_i  # [N, H]
    proj_j = x @ w_j
    if compute_dtype is not None:
        proj_j = proj_j.to(dt)
    xj = ordered_gather(proj_j, edges.senders, edges.order, sorted_senders, n)
    h = sorted_gather(proj_i, edges.receivers, n).to(dt) + xj + e @ w_e + b_e
    msg = _edge_msg(block, h, maskf)
    agg = sorted_sum(msg.float(), edges.receivers, n)  # f32 accumulation
    return _node_update(block, x, agg @ _agg_weight(block, d)), (e + msg) * maskf


def _encode_edges(gnn: MultiScaleGNN, name: str, feats: torch.Tensor, mask: torch.Tensor, compute_dtype):
    out = mlp_ln_apply(getattr(gnn, name), feats) * mask[..., None].to(feats.dtype)
    return out if compute_dtype is None else out.to(compute_dtype)


def multi_scale_gnn_apply(
    gnn: MultiScaleGNN,
    node_features: torch.Tensor,  # [N, node_in] full-grid nodes
    edge_features: Dict[str, torch.Tensor],  # {'g2m','m2m','m2g'}: [E_pad, edge_in]
    graph,  # flattened StaticGraph of tensors (flatten_ms_graph)
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """COO forward over a flattened graph; returns [N, node_out]."""
    x = mlp_ln_apply(gnn.grid_node_encoder, node_features)
    e_g2m = _encode_edges(gnn, "g2m_edge_encoder", edge_features["g2m"], graph.g2m.mask, compute_dtype)
    e_m2m = _encode_edges(gnn, "m2m_edge_encoder", edge_features["m2m"], graph.m2m.mask, compute_dtype)
    e_m2g = _encode_edges(gnn, "m2g_edge_encoder", edge_features["m2g"], graph.m2g.mask, compute_dtype)
    s_g2m, s_m2m, s_m2g = (pe.senders.index_select(0, pe.order) for pe in graph)
    x, _ = _interact(gnn.g2m_block, x, e_g2m, graph.g2m, s_g2m, compute_dtype)
    for block in gnn.m2m_blocks:
        x, e_m2m = _interact(block, x, e_m2m, graph.m2m, s_m2m, compute_dtype)
    x, _ = _interact(gnn.m2g_block, x, e_m2g, graph.m2g, s_m2g, compute_dtype)
    return gnn.prediction_head(x)


def _interact_dense_scales(
    block: InteractionNetwork,
    x: torch.Tensor,
    es: Sequence[torch.Tensor],  # per edge set: [R_s, K_s, D]
    des: Sequence,  # DenseEdges of tensors, disjoint edge sets over the same nodes
    compute_dtype=None,
):
    """One interaction step over a union of dense edge sets (one per m2m
    scale; a single set is ``_interact_dense``). The edge update runs per
    set on ``[R, K, .]`` slots; each set's masked slot sum goes through
    the node MLP's aggregate block (f32 products of the edge dtype's
    values, summed in f32) and ONE sorted sum over the ascending receiver
    rows writes it back to the full grid; the node update runs once on the
    sum over the sets.
    Returns (new x [N, D], new edge latents per set)."""
    d, n = x.shape[-1], x.shape[0]
    dt = es[0].dtype if compute_dtype is None else compute_dtype
    w_i, w_j, w_e, b_e = _edge_mlp_in(block, d, dt)
    proj_i_full = x @ w_i  # [N, H]
    proj_j = x @ w_j
    if compute_dtype is not None:
        proj_j = proj_j.to(dt)
    w_agg = _agg_weight(block, d).to(dt).float()
    agg_hn = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    new_es = []
    for e, de in zip(es, des):
        maskf = de.mask[..., None].to(dt)
        proj_i = sorted_gather(proj_i_full, de.recv, n)  # [R, H]
        xj = planned_gather(proj_j, de.senders, de.tsp_rows, de.tsp_node, de.tsp_mask, n)  # [R, K, H]
        h = proj_i.to(dt)[:, None, :] + xj + e @ w_e + b_e
        msg = _edge_msg(block, h, maskf)
        new_es.append((e + msg) * maskf)
        agg_rows = msg.float().sum(dim=1) @ w_agg  # [R, D]
        agg_hn = agg_hn + sorted_sum(agg_rows, de.recv, n)
    return _node_update(block, x, agg_hn), new_es


def _interact_dense(block: InteractionNetwork, x: torch.Tensor, e: torch.Tensor, de, compute_dtype=None):
    """One interaction step over one DenseEdges set."""
    x, (new_e,) = _interact_dense_scales(block, x, [e], [de], compute_dtype)
    return x, new_e


def multi_scale_gnn_apply_dense(
    gnn: MultiScaleGNN,
    node_features: torch.Tensor,  # [N, node_in]
    edge_features: Dict[str, object],  # g2m/m2g: [R, K, edge_in]; m2m: one per scale
    graph,  # DenseStaticGraph of tensors
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dense-slot forward; the parameters and semantics of
    ``multi_scale_gnn_apply``. Returns [N, node_out]."""
    x = mlp_ln_apply(gnn.grid_node_encoder, node_features)
    e_g2m = _encode_edges(gnn, "g2m_edge_encoder", edge_features["g2m"], graph.g2m.mask, compute_dtype)
    # one shared m2m encoder applied to each scale's features
    e_m2m = [
        _encode_edges(gnn, "m2m_edge_encoder", f, de.mask, compute_dtype)
        for f, de in zip(edge_features["m2m"], graph.m2m)
    ]
    e_m2g = _encode_edges(gnn, "m2g_edge_encoder", edge_features["m2g"], graph.m2g.mask, compute_dtype)
    x, _ = _interact_dense(gnn.g2m_block, x, e_g2m, graph.g2m, compute_dtype)
    for block in gnn.m2m_blocks:
        x, e_m2m = _interact_dense_scales(block, x, e_m2m, graph.m2m, compute_dtype)
    x, _ = _interact_dense(gnn.m2g_block, x, e_m2g, graph.m2g, compute_dtype)
    return gnn.prediction_head(x)


def flatten_dense_ms_graph(graph: DenseStaticGraph, n: int) -> DenseStaticGraph:
    """A batched DenseStaticGraph of tensors ([B, R, ...] leaves) as ONE
    flat block-diagonal graph over B*n nodes: graph b's node i becomes
    b*n + i, and its transpose plan's edge positions move by b*R*K (the
    JAX ``flatten_dense_ms_graph``). Padded rows already hold their graph's
    last node, so ``recv`` and ``tsp_node`` stay ascending."""

    def flat(de):
        b, r = de.recv.shape
        k = de.senders.shape[-1]
        rs = de.tsp_node.shape[1]
        off = (torch.arange(b, dtype=de.recv.dtype, device=de.recv.device) * n)[:, None]
        eoff = (torch.arange(b, dtype=de.tsp_rows.dtype, device=de.tsp_rows.device) * (r * k))[:, None, None]
        return DenseEdges(
            recv=(de.recv + off).reshape(-1),
            senders=(de.senders + off[..., None]).reshape(b * r, -1),
            mask=de.mask.reshape(b * r, -1),
            tsp_rows=(de.tsp_rows + eoff).reshape(b * rs, -1),
            tsp_node=(de.tsp_node + off).reshape(-1),
            tsp_mask=de.tsp_mask.reshape(b * rs, -1),
        )

    return DenseStaticGraph(g2m=flat(graph.g2m), m2m=tuple(flat(de) for de in graph.m2m), m2g=flat(graph.m2g))


def flatten_ms_graph(graph: StaticGraph, n: int) -> StaticGraph:
    """A batched StaticGraph of tensors ([B, E_pad] leaves) as ONE flat
    block-diagonal COO graph over B*n nodes (the JAX ``flatten_ms_graph``).
    Padded slots are re-pointed at their graph's last node ((b+1)*n - 1;
    their messages are masked), which keeps the receivers globally
    non-decreasing: valid edges are receiver-sorted per graph
    (``pad_edges``) and graph b+1 starts above graph b's last node. Each
    graph's sender order moves by b*E_pad, and the flat senders taken in
    the flat order ascend for the same reason."""

    def flat(pe):
        b, e = pe.senders.shape
        off = (torch.arange(b, dtype=pe.senders.dtype, device=pe.senders.device) * n)[:, None]
        last = off + (n - 1)
        s = torch.where(pe.mask, pe.senders + off, last).reshape(-1)
        r = torch.where(pe.mask, pe.receivers + off, last).reshape(-1)
        eoff = (torch.arange(b, dtype=pe.order.dtype, device=pe.order.device) * e)[:, None]
        return PaddedEdges(senders=s, receivers=r, mask=pe.mask.reshape(-1), order=(pe.order + eoff).reshape(-1))

    return StaticGraph(g2m=flat(graph.g2m), m2m=flat(graph.m2m), m2g=flat(graph.m2g))
