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

from typing import Optional, Tuple

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
    maskf = _slot_mask(degrees, m, k)
    x = mlp_ln_apply(epd._encoder.node_fn, node_features)
    e = mlp_ln_apply(epd._encoder.edge_fn, edge_features) * maskf
    if compute_dtype is not None:
        e = e.to(compute_dtype)
    return _process_decode(epd, x, e, senders, degrees, k, compute_dtype, rev)


def _process_decode(
    epd: EncodeProcessDecode,
    x: torch.Tensor,  # f32[M, D] encoded node latents
    e: torch.Tensor,  # [M*K, D] encoded edge latents (masked, compute dtype)
    senders: torch.Tensor,  # int[M*K]
    degrees: torch.Tensor,  # f32[M, 1]
    k: int,
    compute_dtype: Optional[torch.dtype],
    rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Processor layers (fused edge block + node update) and decoder."""
    d, m = x.shape[-1], x.shape[0]
    order = None
    if rev is None and torch.is_grad_enabled():
        sorted_senders, order = torch.sort(senders.int(), stable=True)  # one order for all layers
    for block in epd._processor.gnn_stacks:
        edge_mlp, edge_ln = block.edge_fn[0], block.edge_fn[1]
        if len(edge_mlp.linears) != 2:
            raise NotImplementedError(
                "the flat forward runs the fused edge-block kernel, which covers "
                "one hidden layer per edge MLP (num_mlp_layers == 1)"
            )
        (w_i, w_j, w_e), b_e = split_first_layer(edge_mlp, (d, d, d))
        proj_i = x @ w_i  # [M, H]
        proj_j = x @ w_j
        if compute_dtype is not None:
            proj_j = proj_j.to(compute_dtype)
        if rev is not None:
            xj = sym_gather(proj_j, senders, rev[0], rev[1])  # [M*K, H]
        elif order is not None:
            xj = ordered_gather(proj_j, senders, order, sorted_senders, m)
        else:
            xj = proj_j.index_select(0, senders)
        w2 = edge_mlp.linears[1]
        e, agg = fused_edge_block(
            e,
            xj,
            proj_i,
            degrees,
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
        upd = layer_norm(mlp_tail(node_mlp, hn), node_ln.weight, node_ln.bias)
        x = x + upd
    # decoder: node MLP, no LayerNorm
    return epd._decoder.node_fn(x)
