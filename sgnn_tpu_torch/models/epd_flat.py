"""Flat (block-diagonal batched) encode-process-decode forward.

Port of ``sgnn_tpu/models/epd_flat.py`` (``flatten_batch_graph``,
``_slot_mask``, ``encode_process_decode_apply_flat`` and
``_process_decode``). The batch is one flat graph of M = B*N receivers
whose senders carry global flat indices; edge tensors are 2D
``[M*K, D]`` in receiver-major order, and the edge mask is
``slot < degree`` because neighbor rows are prefix-compacted.

Each processor layer's edge stage is the fused edge-block kernel
(``ops/edge_block.fused_edge_block``: the ``use_pallas=True`` branch of
the JAX ``_process_decode``), so the port supports one hidden layer per
MLP (``num_mlp_layers == 1``, the single-scale configuration).

``compute_dtype=torch.bfloat16`` keeps the edge latents and gathered
sender projections in bf16; node latents, LayerNorm moments, the node
update and the decoder stay f32. The forward is differentiable. Every
product outside the kernel takes f32 operands (the receiver and sender
projections, the node update on ``agg`` widened to f32) and the kernel
emits its weight gradients in f32, so in bf16 no weight gradient is
rounded through bf16 on its way to the optimizer: the contract of the
JAX module's ``_dot_wf32``.

With ``rev=(rev_pos, rev_ok)`` (``ops/sym_gather.reverse_edge_positions``
of a symmetric graph) each layer's sender gather is ``sym_gather``, whose
backward is a gather in place of ``index_select``'s scatter-add. Without
it, where gradients are taken, the senders are sorted once per forward on
the device (``torch.sort(stable=True)``) and each layer's sender gather is
``ops/row_gather.ordered_gather`` over that order: the take kernel, whose
backward adds each node's cotangent rows in index order with the sorted
segment sum kernel, with no atomics (``index_select``'s backward adds with
float atomics on the card). A forward taken with no gradients (serving)
gathers with ``index_select``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from sgnn_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecode,
    mlp_ln_apply,
    mlp_tail,
    split_first_layer,
)
from sgnn_tpu_torch.nn.core import layer_norm
from sgnn_tpu_torch.ops.edge_block import fused_edge_block
from sgnn_tpu_torch.ops.row_gather import ordered_gather
from sgnn_tpu_torch.ops.sym_gather import sym_gather


def flatten_batch_graph(
    senders: torch.Tensor,  # int[B, N, K] per-graph sender indices
    mask: torch.Tensor,  # bool[B, N, K]
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-graph neighbor lists -> (global flat senders [B*N*K],
    f32 degrees [B*N, 1])."""
    b = senders.shape[0]
    offsets = (torch.arange(b, device=senders.device, dtype=senders.dtype) * n)[:, None, None]
    senders_flat = (senders + offsets).reshape(-1)
    degrees = mask.sum(dim=-1).reshape(-1, 1).float()
    return senders_flat, degrees


def _slot_mask(degrees: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """f32[M*K, 1] edge validity from prefix-compacted degrees."""
    slot = torch.arange(k, device=degrees.device, dtype=torch.float32)[None, :]
    return (slot < degrees).float().reshape(m * k, 1)


def sender_gather(
    senders: torch.Tensor,  # int[R*K] row indices into the table
    num_nodes: int,  # the table's row count
    rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-layer sender gather ``table [num_nodes, H] -> [R*K, H]`` of
    one graph: ``sym_gather`` with ``rev``; else, where gradients are taken,
    ``ordered_gather`` over one stable sort of the senders made here (once
    per forward, for every layer); else ``index_select``. ``num_nodes`` is
    the TABLE's row count, which a shard's extended table makes larger than
    its receivers' (``parallel/edge_partition.py``)."""
    if rev is not None:
        return lambda table: sym_gather(table, senders, rev[0], rev[1])
    if torch.is_grad_enabled():
        sorted_senders, order = torch.sort(senders.int(), stable=True)
        return lambda table: ordered_gather(table, senders, order, sorted_senders, num_nodes)
    return lambda table: table.index_select(0, senders)


def encode_process_decode_apply_flat(
    epd: EncodeProcessDecode,
    node_features: torch.Tensor,  # f32[M, node_in]
    edge_features: torch.Tensor,  # f32[M*K, edge_in] receiver-major
    senders: torch.Tensor,  # int[M*K] global flat sender indices
    degrees: torch.Tensor,  # f32[M, 1]
    k: int,
    compute_dtype: Optional[torch.dtype] = None,
    rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Full forward over one flat graph; returns f32[M, node_out].
    rev: optional (rev_pos [M, K], rev_ok [M, K]) reverse-edge index."""
    m = node_features.shape[0]
    x, e = encode_flat(epd, node_features, edge_features, degrees, k, compute_dtype)
    gather = sender_gather(senders, m, rev)
    (out,) = _process_decode([epd], [x], [e], [degrees], k, lambda projs: [gather(projs[0])], compute_dtype)
    return out


def encode_flat(
    epd: EncodeProcessDecode,
    node_features: torch.Tensor,  # f32[M, node_in]
    edge_features: torch.Tensor,  # f32[M*K, edge_in]
    degrees: torch.Tensor,  # f32[M, 1]
    k: int,
    compute_dtype: Optional[torch.dtype],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(node latents f32[M, D], edge latents [M*K, D] masked, in the compute dtype)."""
    maskf = _slot_mask(degrees, node_features.shape[0], k)
    x = mlp_ln_apply(epd._encoder.node_fn, node_features)
    e = mlp_ln_apply(epd._encoder.edge_fn, edge_features) * maskf
    return x, e if compute_dtype is None else e.to(compute_dtype)


def _process_decode(
    epds: List[EncodeProcessDecode],  # per shard: the model, on the shard's device
    xs: List[torch.Tensor],  # per shard f32[M_s, D] encoded node latents
    es: List[torch.Tensor],  # per shard [M_s*K, D] encoded edge latents (masked, compute dtype)
    degrees: List[torch.Tensor],  # per shard f32[M_s, 1]
    k: int,
    gather: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    compute_dtype: Optional[torch.dtype],
) -> List[torch.Tensor]:
    """Processor layers (fused edge block + node update) and decoder, over
    the shards of one graph in lockstep (one graph on one device is one
    shard). ``gather`` is the per-layer sender gather: it takes every
    shard's sender projections ``[M_s, H]`` (already in the compute dtype)
    and returns every shard's gathered senders ``[M_s*K, H]``: the hook by
    which the graph-partitioned forward halo-exchanges the projections
    before gathering (``parallel/edge_partition.py``), as the JAX
    ``_process_decode``'s ``gather_fn``. Returns per shard f32[M_s, node_out]."""
    d = xs[0].shape[-1]
    xs, es = list(xs), list(es)
    for layer in range(len(epds[0]._processor.gnn_stacks)):
        blocks = [epd._processor.gnn_stacks[layer] for epd in epds]
        proj_js = []
        for block, x in zip(blocks, xs):
            if len(block.edge_fn[0].linears) != 2:
                raise NotImplementedError(
                    "the flat forward runs the fused edge-block kernel, which covers "
                    "one hidden layer per edge MLP (num_mlp_layers == 1)"
                )
            (_, w_j, _), _ = split_first_layer(block.edge_fn[0], (d, d, d))
            proj_j = x @ w_j  # [M_s, H]
            proj_js.append(proj_j if compute_dtype is None else proj_j.to(compute_dtype))
        xjs = gather(proj_js)  # [M_s*K, H]
        for s, (block, x) in enumerate(zip(blocks, xs)):
            edge_mlp, edge_ln = block.edge_fn[0], block.edge_fn[1]
            (w_i, _, w_e), b_e = split_first_layer(edge_mlp, (d, d, d))
            w2 = edge_mlp.linears[1]
            es[s], agg = fused_edge_block(
                es[s],
                xjs[s],
                x @ w_i,  # proj_i [M_s, H]
                degrees[s],
                w_e.contiguous(),
                b_e,
                w2.weight.t().contiguous(),
                w2.bias,
                edge_ln.weight,
                edge_ln.bias,
                k,
            )
            # node update: node_fn(cat[agg, x]) + residual
            node_mlp, node_ln = block.node_fn[0], block.node_fn[1]
            (w_agg, w_x), b_n = split_first_layer(node_mlp, (d, d))
            hn = agg.float() @ w_agg + x @ w_x + b_n
            xs[s] = x + layer_norm(mlp_tail(node_mlp, hn), node_ln.weight, node_ln.bias)
    # decoder: node MLP, no LayerNorm
    return [epd._decoder.node_fn(x) for epd, x in zip(epds, xs)]
