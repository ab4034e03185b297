"""Encode-process-decode GNN: modules in the reference layout plus the
readable per-graph ``[N, K]`` forward.

Port of ``sgnn_tpu/models/encode_process_decode.py``. The module tree
reproduces the reference ``EncodeProcessDecode`` key layout, so
``state_dict()`` keys read e.g.::

  _encoder.node_fn.0.NN-0.weight        (Sequential(MLP, LayerNorm))
  _processor.gnn_stacks.{m}.edge_fn.1.weight
  _decoder.node_fn.NN-1.bias            (MLP, no LayerNorm)

Semantics (graph_network.py of the reference, as in the JAX module):
node/edge encoders are MLP + LayerNorm; each interaction network updates
edges with ``edge_fn(cat[x_i, x_j, e])`` (x_i receiver, x_j sender), sums
messages at receivers, updates nodes with ``node_fn(cat[agg, x])`` and
adds residuals on both; the decoder is an MLP without LayerNorm.

The first Linear of ``edge_fn``/``node_fn`` is applied in split form
(``cat(a, b, c) @ W == a @ W_a + b @ W_b + c @ W_c``): ``split_first_layer``
returns VIEWS of the Linear's weight, never separate parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sgnn_tpu_torch.nn.core import MLP, activate, layer_norm, mlp_ln
from sgnn_tpu_torch.ops.f32_product import linear
from sgnn_tpu_torch.ops.neighbors import NeighborList


@dataclasses.dataclass(frozen=True)
class EPDConfig:
    """Hyperparameters of the encode-process-decode stack (the JAX
    ``EPDConfig``): ``num_mlp_layers`` counts hidden layers per MLP, each
    of width ``latent_dim``."""

    node_in: int
    edge_in: int
    node_out: int
    latent_dim: int
    num_message_passing_steps: int
    num_mlp_layers: int = 1

    @property
    def hidden_dims(self):
        return [self.latent_dim] * self.num_mlp_layers


class InteractionNetwork(nn.Module):
    def __init__(self, cfg: EPDConfig, *, generator=None, device=None, activation: str = "relu"):
        super().__init__()
        d = cfg.latent_dim
        kw = dict(generator=generator, device=device, activation=activation)
        # init order edge then node, as interaction_network_init
        self.edge_fn = mlp_ln(3 * d, cfg.hidden_dims, d, **kw)
        self.node_fn = mlp_ln(2 * d, cfg.hidden_dims, d, **kw)


class _Encoder(nn.Module):
    def __init__(self, cfg: EPDConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.node_fn = mlp_ln(cfg.node_in, cfg.hidden_dims, cfg.latent_dim, **kw)
        self.edge_fn = mlp_ln(cfg.edge_in, cfg.hidden_dims, cfg.latent_dim, **kw)


class _Processor(nn.Module):
    def __init__(self, cfg: EPDConfig, *, generator=None, device=None):
        super().__init__()
        self.gnn_stacks = nn.ModuleList(
            InteractionNetwork(cfg, generator=generator, device=device)
            for _ in range(cfg.num_message_passing_steps)
        )


class _Decoder(nn.Module):
    def __init__(self, cfg: EPDConfig, *, generator=None, device=None):
        super().__init__()
        self.node_fn = MLP(
            cfg.latent_dim, cfg.hidden_dims, cfg.node_out, generator=generator, device=device
        )


class EncodeProcessDecode(nn.Module):
    """Parameter container; the forwards are the functions below."""

    def __init__(self, cfg: EPDConfig, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._encoder = _Encoder(cfg, generator=generator, device=device)
        self._processor = _Processor(cfg, generator=generator, device=device)
        self._decoder = _Decoder(cfg, generator=generator, device=device)


def mlp_ln_apply(block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    mlp, ln = block[0], block[1]
    return layer_norm(mlp(x), ln.weight, ln.bias)


def split_first_layer(
    mlp: MLP, splits: Sequence[int]
) -> Tuple[list[torch.Tensor], torch.Tensor]:
    """Row blocks ``[in_s, out]`` of the first Linear in JAX's ``x @ w``
    orientation: transposed views of the torch ``[out, in]`` weight."""
    first = mlp.linears[0]
    w = first.weight.t()
    out, start = [], 0
    for s in splits:
        out.append(w[start : start + s])
        start += s
    if start != w.shape[0]:
        raise ValueError(f"splits {tuple(splits)} do not cover input width {w.shape[0]}")
    return out, first.bias


def mlp_tail(mlp: MLP, h: torch.Tensor) -> torch.Tensor:
    """The MLP's remaining layers given the first layer's preactivation
    (each Linear and its activation one ``MLP.hidden`` call)."""
    linears = mlp.linears
    if len(linears) == 1:
        return h  # a single Linear: its preactivation is the output
    x = activate(mlp, h)
    for lin in linears[1:-1]:
        x = mlp.hidden(x, lin)
    return linear(x, linears[-1].weight.t(), linears[-1].bias)


def interaction_network_apply(
    block: InteractionNetwork,
    x: torch.Tensor,  # f32[N, D]
    edge_latent: torch.Tensor,  # f32[N, K, D], padded slots zero
    nl: NeighborList,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One message-passing step; returns (new_x, new_edge_latent)."""
    d = x.shape[-1]
    mask = nl.mask[..., None].to(x.dtype)

    (w_i, w_j, w_e), b_e = split_first_layer(block.edge_fn[0], (d, d, d))
    proj_i = linear(x, w_i)
    proj_j = linear(x, w_j)
    h = proj_i[:, None, :] + proj_j[nl.senders] + linear(edge_latent, w_e) + b_e
    msg = mlp_tail(block.edge_fn[0], h)
    ln = block.edge_fn[1]
    msg = layer_norm(msg, ln.weight, ln.bias) * mask

    agg = msg.sum(dim=1)
    (w_agg, w_x), b_n = split_first_layer(block.node_fn[0], (d, d))
    hn = linear(agg, w_agg) + linear(x, w_x) + b_n
    upd = mlp_tail(block.node_fn[0], hn)
    ln = block.node_fn[1]
    upd = layer_norm(upd, ln.weight, ln.bias)
    return x + upd, (edge_latent + msg) * mask


def encode_process_decode_apply(
    epd: EncodeProcessDecode,
    node_features: torch.Tensor,  # f32[N, node_in]
    edge_features: torch.Tensor,  # f32[N, K, edge_in]
    nl: NeighborList,
) -> torch.Tensor:
    """Full forward; returns f32[N, node_out]."""
    mask = nl.mask[..., None].to(node_features.dtype)
    x = mlp_ln_apply(epd._encoder.node_fn, node_features)
    e = mlp_ln_apply(epd._encoder.edge_fn, edge_features) * mask
    for block in epd._processor.gnn_stacks:
        x, e = interaction_network_apply(block, x, e, nl)
    return epd._decoder.node_fn(x)
