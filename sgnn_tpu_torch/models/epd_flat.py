"""Flat (block-diagonal batched) encode-process-decode forward.

Port of ``sgnn_tpu/models/epd_flat.py`` (``flatten_batch_graph``,
``_slot_mask``, ``encode_process_decode_apply_flat``,
``encode_process_decode_apply_flat_fused`` and ``_process_decode``). The
batch is one flat graph of M = B*N receivers whose senders carry global
flat indices; edge tensors are 2D ``[M*K, D]`` in receiver-major order,
and the edge mask is ``slot < degree`` because neighbor rows are
prefix-compacted.

Each processor layer's edge stage is the fused edge-block kernel
(``ops/edge_block.fused_edge_block``: the ``use_pallas=True`` branch of
the JAX ``_process_decode``) where the edge MLP has one hidden layer
(``num_mlp_layers == 1``, the single-scale configuration). Deeper edge
MLPs take JAX's XLA edge stage (``_edge_block_plain``: ``_edge_block_xla``,
``_mlp_tail_in`` and ``_recv_broadcast_add``) in plain PyTorch up to its
last product, and the epilogue after it (bias, LayerNorm, slot mask,
residual, slot sum) in one kernel each way (``ops/edge_epilogue``) for f32
latents on the card (D up to 128); the slot sum adds no ``index_add_``.
Every f32 product (the projections, the edge stage's products, the node
update, the encoders and the decoder) is ``ops/f32_product.linear``, with
a hidden layer's bias and ReLU: the 3xTF32 kernels on the card.

``compute_dtype=torch.bfloat16`` keeps the edge latents and gathered
sender projections in bf16; node latents, LayerNorm moments, the node
update and the decoder stay f32. The forward is differentiable. No weight
gradient is rounded through bf16 on its way to the optimizer (the contract
of the JAX module's ``_dot_wf32``): the kernel emits its weight gradients
in f32, the products outside it take f32 operands, and the plain edge
stage's products are ``_DotWf32``, whose weight gradient is an f32 product
of the bf16 operands (``_dot``: in f32 ``linear``).

With ``rev=(rev_pos, rev_ok)`` (``ops/sym_gather.reverse_edge_positions``
of a symmetric graph) each layer's sender gather is ``sym_gather``, whose
backward is a gather in place of ``index_select``'s scatter-add. Without
it, where gradients are taken, the senders are sorted once per forward on
the device (``torch.sort(stable=True)``) and each layer's sender gather is
``ops/row_gather.ordered_gather`` over that order: the take kernel, whose
backward adds each node's cotangent rows in index order with the sorted
segment sum kernel, with no atomics (``index_select``'s backward adds with
float atomics on the card). A forward taken with no gradients (serving)
gathers with ``index_select``. ``band_nodes`` gives every gather the
banded index of ``ops/sym_gather`` past JAX's thresholds, made once per
forward.

``remat`` (JAX's ``_process_decode``, ``torch.utils.checkpoint`` without
reentry) trades memory for recomputation and changes no bit of the
outputs or gradients: the backward runs the same operations on recomputed
values that equal the first ones. What stays held between the forward and
the backward:

  * ``False``: every layer's residuals;
  * ``True`` / ``"xj"``: each layer's inputs (x, e) and its gathered
    senders xj (the gather stays outside the checkpointed region); the
    edge stage and node update recompute;
  * ``"xj_msg"``: also the edge stage's outputs (the edge block stays
    outside too); only the node update recomputes;
  * ``"full"``: only (x, e); the gather (and a graph shard's halo
    exchange) recomputes too;
  * ``"group"``: the layers split at (L + 1) // 2 into two checkpointed
    groups of ``"full"`` layers, as JAX nests them; only the groups'
    (x, e) are held. The backward recomputes a group, which holds its
    layers' (x, e), then each layer again, one layer's residuals at a
    time: three forwards of each layer.

Every region is made with early stop off
(``torch.utils.checkpoint.set_checkpoint_early_stop(False)``): a
recompute runs its whole region, so the nested ``"group"`` recomputes
the same operations on every torch version (with early stop on, torch
2.11 and 2.13 gave 13 and 10 edge-block forwards per step at five
layers, in place of 15).

The senders' sort and banded indices are made once per forward, outside
every checkpointed region.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from sgnn_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecode,
    mlp_ln_apply,
    mlp_tail,
    split_first_layer,
)
from sgnn_tpu_torch.nn.core import layer_norm
from sgnn_tpu_torch.ops.edge_block import fused_edge_block
from sgnn_tpu_torch.ops.edge_epilogue import edge_stage_epilogue
from sgnn_tpu_torch.ops.f32_product import linear
from sgnn_tpu_torch.ops.row_gather import ordered_gather
from sgnn_tpu_torch.ops.sym_gather import BANDED, forward_banded_index, packed_sym_gather, sym_gather_plan

REMAT_MODES = (False, True, "xj", "xj_msg", "full", "group")


def check_remat(remat) -> object:
    """``remat`` normalised (None and False are off, True is "xj"); raises
    for a value JAX's ``_process_decode`` does not take."""
    if remat is None or remat is False:
        return False
    if remat is True or remat == "xj":
        return "xj"
    if remat in REMAT_MODES:
        return remat
    raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")


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
    band_nodes: Optional[int] = None,
    halo: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-layer sender gather ``table [num_nodes, H] -> [R*K, H]`` of
    one graph: ``sym_gather`` with ``rev``; else, where gradients are taken,
    ``ordered_gather`` over one stable sort of the senders made here (once
    per forward, for every layer); else ``index_select``. ``num_nodes`` is
    the TABLE's row count, which a shard's extended table makes larger than
    its receivers' (``parallel/edge_partition.py``; ``halo`` its left halo).
    With ``band_nodes`` past JAX's thresholds the senders are the banded
    index (``ops/sym_gather.forward_banded_index``), made here once."""
    if rev is not None:
        return sym_gather_plan(senders, num_nodes, rev[0], rev[1], band_nodes, halo)
    banded = forward_banded_index(senders, num_nodes, band_nodes, halo)
    idx = senders if banded is None else banded
    if torch.is_grad_enabled():
        sorted_idx, order = torch.sort(idx.int(), stable=True)

        def gather(table):
            return ordered_gather(table, idx, order, sorted_idx, num_nodes)
    else:
        def gather(table):
            return table.index_select(0, idx)
    if banded is None:
        return gather

    def banded_gather(table):
        BANDED["forward"] += 1
        return gather(table)

    return banded_gather


def encode_process_decode_apply_flat(
    epd: EncodeProcessDecode,
    node_features: torch.Tensor,  # f32[M, node_in]
    edge_features: torch.Tensor,  # f32[M*K, edge_in] receiver-major
    senders: torch.Tensor,  # int[M*K] global flat sender indices
    degrees: torch.Tensor,  # f32[M, 1]
    k: int,
    compute_dtype: Optional[torch.dtype] = None,
    rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    band_nodes: Optional[int] = None,
    remat=False,
) -> torch.Tensor:
    """Full forward over one flat graph; returns f32[M, node_out].
    rev: optional (rev_pos [M, K], rev_ok [M, K]) reverse-edge index."""
    m = node_features.shape[0]
    x, e = encode_flat(epd, node_features, edge_features, degrees, k, compute_dtype)
    gather = sender_gather(senders, m, rev, band_nodes)
    (out,) = _process_decode([epd], [x], [e], [degrees], k, lambda projs: [gather(projs[0])], compute_dtype,
                             remat=remat)
    return out


def edge_features_from(
    sender_pos: torch.Tensor,  # [N, K, dim] the senders' positions
    last: torch.Tensor,  # [N, dim] the receivers'
    mask: torch.Tensor,  # bool[N, K]
    radius: float,
) -> torch.Tensor:
    """[N, K, dim+1]: (p_sender - p_receiver)/R and its norm, masked."""
    disp = (sender_pos - last[:, None, :]) / radius
    dist = torch.linalg.vector_norm(disp, dim=-1, keepdim=True)
    return torch.cat([disp, dist], dim=-1) * mask[..., None].to(disp.dtype)


def encode_process_decode_apply_flat_fused(
    epd: EncodeProcessDecode,
    node_features: torch.Tensor,  # f32[M, node_in]
    flat_last: torch.Tensor,  # f32[M, dim] most-recent positions
    senders2d: torch.Tensor,  # int[M, K] neighbour lists (global flat ids)
    mask2d: torch.Tensor,  # bool[M, K]
    radius: float,
    compute_dtype: Optional[torch.dtype] = None,
    band_nodes: Optional[int] = None,
    remat=False,
) -> torch.Tensor:
    """The forward with the packed gather (symmetric graphs only): the
    sender positions of the edge features, the reverse-edge index and layer
    0's sender projections come from ONE gather
    (``ops/sym_gather.packed_sym_gather``). Outputs and gradients equal
    building the features and reverse index apart and calling
    ``encode_process_decode_apply_flat`` with ``rev``. Positions get no
    gradient. Returns f32[M, node_out]."""
    m, k = senders2d.shape
    dim = flat_last.shape[-1]
    x = mlp_ln_apply(epd._encoder.node_fn, node_features)
    d = x.shape[-1]
    (_, w_j0, _), _ = split_first_layer(epd._processor.gnn_stacks[0].edge_fn[0], (d, d, d))
    g_aux, xj0, rev_pos, rev_ok = packed_sym_gather(flat_last, linear(x, w_j0), senders2d, mask2d, compute_dtype,
                                                    band_nodes)
    ef = edge_features_from(g_aux.reshape(m, k, dim), flat_last, mask2d, radius)
    degrees = mask2d.sum(dim=-1, keepdim=True).float()
    e = mlp_ln_apply(epd._encoder.edge_fn, ef.reshape(m * k, -1)) * _slot_mask(degrees, m, k)
    if compute_dtype is not None:
        e = e.to(compute_dtype)
    gather = sender_gather(senders2d.reshape(-1), m, (rev_pos, rev_ok), band_nodes)
    (out,) = _process_decode([epd], [x], [e], [degrees], k, lambda projs: [gather(projs[0])], compute_dtype,
                             xj0=[xj0], remat=remat)
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


class _DotWf32(torch.autograd.Function):
    """``x @ w.to(x.dtype)`` whose weight gradient is the f32 product of
    x and the cotangent (JAX's ``_dot_wf32``): in bf16 it is not rounded
    through bf16. d_x is the plain product in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d_x = g @ w.to(x.dtype).t()
        d_w = x.reshape(-1, x.shape[-1]).float().t() @ g.reshape(-1, g.shape[-1]).float()
        return d_x, d_w.to(w.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """``x @ w (+ b) (ReLU)`` of the plain edge stage: ``linear``, whose
    routes off the f32 kernels take ``_DotWf32``'s product."""
    return linear(x, w, b, relu, product=_DotWf32.apply)


class _RecvBroadcastAdd(torch.autograd.Function):
    """``h[m*K + k] += proj[m]`` (proj cast to h's dtype) whose backward
    sums proj's cotangent over the K slots in f32 (JAX's
    ``_recv_broadcast_add``)."""

    @staticmethod
    def forward(ctx, h, proj, k: int):
        ctx.k, ctx.proj_dtype = k, proj.dtype
        m, d = proj.shape
        return (h.view(m, k, d) + proj.to(h.dtype)[:, None, :]).view(h.shape)

    @staticmethod
    def backward(ctx, g):
        d = g.shape[-1]
        d_proj = g.reshape(-1, ctx.k, d).float().sum(dim=1).to(ctx.proj_dtype)
        return g, d_proj, None


def _mlp_tail_in(mlp, h: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MLP's remaining layers given the first layer's preactivation,
    activations kept in h's dtype (JAX's ``_mlp_tail_in``), short of the
    last Linear's bias: (its product, that bias); (h, None) for a
    one-Linear MLP."""
    linears = mlp.linears
    if len(linears) == 1:
        return h, None
    dt = h.dtype
    x = torch.relu(h)
    for lin in linears[1:-1]:
        x = _dot(x, lin.weight.t(), lin.bias.to(dt), relu=True)
    last = linears[-1]
    return _dot(x, last.weight.t()), last.bias


def _edge_block_plain(edge_fn, e, xj, proj_i, degrees, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_edge_block_xla`` for any edge-MLP depth: (new_e, agg) with
    agg the f32 slot sum of the messages [M, D]. ``edge_fn`` is the
    ``Sequential(MLP, LayerNorm)`` whose first Linear reads the edge
    latent as its third block of D rows. The epilogue after the last
    product (bias, LayerNorm, mask, residual, slot sum) is
    ``ops/edge_epilogue``'s: one kernel each way where it takes the
    latents."""
    edge_mlp, edge_ln = edge_fn[0], edge_fn[1]
    d = e.shape[-1]
    (_, _, w_e), b_e = split_first_layer(edge_mlp, (d, d, d))
    m = proj_i.shape[0]
    dt = e.dtype
    h = _dot(e, w_e) + xj.to(dt)
    h = _RecvBroadcastAdd.apply(h, proj_i + b_e, k)
    o, b2 = _mlp_tail_in(edge_mlp, h)
    return edge_stage_epilogue(o, b2, edge_ln.weight, edge_ln.bias, _slot_mask(degrees, m, k).to(dt), e, k)


def _edge_stage(block, x, e, xj, degrees, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's edge stage: (new edge latents, f32 agg [M, D])."""
    d = x.shape[-1]
    edge_mlp, edge_ln = block.edge_fn[0], block.edge_fn[1]
    (w_i, _, w_e), b_e = split_first_layer(edge_mlp, (d, d, d))
    proj_i = linear(x, w_i)  # [M_s, H]
    if len(edge_mlp.linears) != 2:
        return _edge_block_plain(block.edge_fn, e, xj, proj_i, degrees, k)
    w2 = edge_mlp.linears[1]
    new_e, agg = fused_edge_block(
        e, xj, proj_i, degrees, w_e.contiguous(), b_e, w2.weight.t().contiguous(), w2.bias,
        edge_ln.weight, edge_ln.bias, k,
    )
    return new_e, agg.float()


def _node_update(block, x, agg) -> torch.Tensor:
    """node_fn(cat[agg, x]) + residual."""
    d = x.shape[-1]
    node_mlp, node_ln = block.node_fn[0], block.node_fn[1]
    (w_agg, w_x), b_n = split_first_layer(node_mlp, (d, d))
    hn = linear(agg, w_agg) + linear(x, w_x) + b_n
    return x + layer_norm(mlp_tail(node_mlp, hn), node_ln.weight, node_ln.bias)


def _checkpointed(fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (no reentry, no early
    stop; the layers draw no random numbers) where gradients are taken.
    The tuples of per-shard tensors in ``args`` are passed to the
    checkpoint flat: it saves only its top-level tensor arguments through
    the saved-tensor hooks, so only these are recomputed by an enclosing
    checkpoint (a tensor inside a tuple would be held as it is)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    flat, sizes = [], []
    for a in args:
        if isinstance(a, tuple):
            flat.extend(a)
            sizes.append(len(a))
        else:
            flat.append(a)
            sizes.append(None)

    def run(*flat):
        rebuilt, i = [], 0
        for size in sizes:
            rebuilt.append(flat[i] if size is None else tuple(flat[i:i + size]))
            i += 1 if size is None else size
        return fn(*rebuilt)

    with set_checkpoint_early_stop(False):
        return checkpoint(run, *flat, use_reentrant=False, preserve_rng_state=False)


def _process_decode(
    epds: List[EncodeProcessDecode],  # per shard: the model, on the shard's device
    xs: Sequence[torch.Tensor],  # per shard f32[M_s, D] encoded node latents
    es: Sequence[torch.Tensor],  # per shard [M_s*K, D] encoded edge latents (masked, compute dtype)
    degrees: List[torch.Tensor],  # per shard f32[M_s, 1]
    k: int,
    gather: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    compute_dtype: Optional[torch.dtype],
    xj0: Optional[Sequence[torch.Tensor]] = None,
    remat=False,
) -> List[torch.Tensor]:
    """Processor layers (edge stage + node update) and decoder, over the
    shards of one graph in lockstep (one graph on one device is one shard).
    ``gather`` is the per-layer sender gather: it takes every shard's
    sender projections ``[M_s, H]`` (already in the compute dtype) and
    returns every shard's gathered senders ``[M_s*K, H]``: the hook by
    which the graph-partitioned forward halo-exchanges the projections
    before gathering (``parallel/edge_partition.py``), as the JAX
    ``_process_decode``'s ``gather_fn``. ``xj0``: layer 0's gathered
    senders per shard, from the packed gather. ``remat``: see the module
    docstring. Returns per shard f32[M_s, node_out]."""
    mode = check_remat(remat)
    d = xs[0].shape[-1]
    stacks = [epd._processor.gnn_stacks for epd in epds]
    num_layers = len(stacks[0])

    def gathered(layer, xs, xj0_l):
        if xj0_l is not None:
            return tuple(xj0_l)
        projs = []
        for stack, x in zip(stacks, xs):
            (_, w_j, _), _ = split_first_layer(stack[layer].edge_fn[0], (d, d, d))
            proj_j = linear(x, w_j)  # [M_s, H]
            projs.append(proj_j if compute_dtype is None else proj_j.to(compute_dtype))
        return tuple(gather(projs))

    def edges(layer, xs, es, xjs):
        out = [_edge_stage(st[layer], x, e, xj, deg, k) for st, x, e, xj, deg in zip(stacks, xs, es, xjs, degrees)]
        return tuple(o[0] for o in out), tuple(o[1] for o in out)

    def nodes(layer, xs, aggs):
        return tuple(_node_update(st[layer], x, agg) for st, x, agg in zip(stacks, xs, aggs))

    def after_gather(layer, xs, es, xjs):
        new_es, aggs = edges(layer, xs, es, xjs)
        return nodes(layer, xs, aggs), new_es

    def full_layer(layer, xs, es, xj0_l):
        return after_gather(layer, xs, es, gathered(layer, xs, xj0_l))

    def layer_fn(layer, xs, es, xj0_l):
        if mode == "xj":
            return _checkpointed(after_gather, layer, xs, es, gathered(layer, xs, xj0_l))
        if mode == "xj_msg":
            new_es, aggs = edges(layer, xs, es, gathered(layer, xs, xj0_l))
            return _checkpointed(nodes, layer, xs, aggs), new_es
        if mode == "full":
            return _checkpointed(full_layer, layer, xs, es, xj0_l)
        return full_layer(layer, xs, es, xj0_l)

    xs, es = tuple(xs), tuple(es)
    xj0 = None if xj0 is None else tuple(xj0)
    if mode == "group":
        def run_group(layers, xs, es, xj0_g):
            for layer in layers:
                xs, es = _checkpointed(full_layer, layer, xs, es, xj0_g if layer == 0 else None)
            return xs, es

        mid = (num_layers + 1) // 2
        for layers in (range(mid), range(mid, num_layers)):
            xs, es = _checkpointed(run_group, layers, xs, es, xj0 if 0 in layers else None)
    else:
        for layer in range(num_layers):
            xs, es = layer_fn(layer, xs, es, xj0 if layer == 0 else None)
    # decoder: node MLP, no LayerNorm
    return [epd._decoder.node_fn(x) for epd, x in zip(epds, xs)]
