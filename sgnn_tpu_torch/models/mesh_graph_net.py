"""MeshGraphNets: encode-process-decode over a mesh edge set and a world
edge set side by side.

Pfaff, Fortunato, Sanchez-Gonzalez, Battaglia, "Learning Mesh-Based
Simulation with Graph Networks" (ICLR 2021, arXiv:2010.03409), as its code
has it (github.com/deepmind/deepmind-research ``meshgraphnets/core_model.py``:
``EncodeProcessDecode``, ``GraphNetBlock``):

  * every MLP is Linear-ReLU stacks of ``num_mlp_layers`` hidden layers of
    width ``latent_dim`` and a Linear out, followed by a LayerNorm, except
    the decoder's;
  * the encoder embeds the node features and each edge set's features with
    an MLP of its own;
  * each block (``GraphNetBlock._update_edge_features`` then
    ``_update_node_features``) computes each edge set's messages
    ``m_ij = edge_fn([v_j, v_i, e_ij])`` (j the sender, i the receiver) from
    the block's input ``v``, then ``v_i += node_fn([v_i, sum_j m^mesh_ij,
    sum_j m^world_ij])`` and ``e += m`` per edge set;
  * the decoder is an MLP on the node latents.

Parameters are ``nn/core`` modules (``_encoder.{node_fn,mesh_edge_fn,
world_edge_fn}``, ``_processor.blocks.{l}.{mesh_edge_fn,world_edge_fn,
node_fn}``, ``_decoder.node_fn``). The forward runs over one flat
block-diagonal graph, as ``models/epd_flat``: each edge set is a dense
``[M*K, D]`` receiver-major slot layout whose mask is ``slot < degree``;
each edge stage is ``epd_flat._edge_block_plain`` over the first Linear in
split form (``[v_j, v_i, e]``: the sender projection gathered per slot, the
receiver projection broadcast over the slots), its slot sum the aggregate;
in f32 its epilogue (bias, LayerNorm, mask, residual, slot sum) is one
kernel each way (``ops/edge_epilogue``), and every product (projections,
edge and node MLPs, encoders, decoder) ``ops/f32_product.linear``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from sgnn_tpu_torch.models.encode_process_decode import mlp_ln_apply, mlp_tail, split_first_layer
from sgnn_tpu_torch.models.epd_flat import _edge_block_plain, _slot_mask
from sgnn_tpu_torch.nn.core import MLP, layer_norm, mlp_ln
from sgnn_tpu_torch.ops.f32_product import linear

EDGE_SETS = ("mesh", "world")


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    node_in: int
    mesh_edge_in: int
    world_edge_in: int
    node_out: int
    latent_dim: int
    num_message_passing_steps: int
    num_mlp_layers: int = 2

    @property
    def hidden_dims(self):
        return [self.latent_dim] * self.num_mlp_layers


class GraphNetBlock(nn.Module):
    def __init__(self, cfg: MGNConfig, *, generator=None, device=None):
        super().__init__()
        d = cfg.latent_dim
        kw = dict(generator=generator, device=device)
        self.mesh_edge_fn = mlp_ln(3 * d, cfg.hidden_dims, d, **kw)
        self.world_edge_fn = mlp_ln(3 * d, cfg.hidden_dims, d, **kw)
        self.node_fn = mlp_ln(3 * d, cfg.hidden_dims, d, **kw)


class _Encoder(nn.Module):
    def __init__(self, cfg: MGNConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.node_fn = mlp_ln(cfg.node_in, cfg.hidden_dims, cfg.latent_dim, **kw)
        self.mesh_edge_fn = mlp_ln(cfg.mesh_edge_in, cfg.hidden_dims, cfg.latent_dim, **kw)
        self.world_edge_fn = mlp_ln(cfg.world_edge_in, cfg.hidden_dims, cfg.latent_dim, **kw)


class _Processor(nn.Module):
    def __init__(self, cfg: MGNConfig, *, generator=None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            GraphNetBlock(cfg, generator=generator, device=device) for _ in range(cfg.num_message_passing_steps)
        )


class _Decoder(nn.Module):
    def __init__(self, cfg: MGNConfig, *, generator=None, device=None):
        super().__init__()
        self.node_fn = MLP(cfg.latent_dim, cfg.hidden_dims, cfg.node_out, generator=generator, device=device)


class MeshGraphNet(nn.Module):
    """Parameter container; the forward is ``mesh_graph_net_apply``."""

    def __init__(self, cfg: MGNConfig, *, generator=None, device=None):
        super().__init__()
        self._encoder = _Encoder(cfg, generator=generator, device=device)
        self._processor = _Processor(cfg, generator=generator, device=device)
        self._decoder = _Decoder(cfg, generator=generator, device=device)


class EdgeSet(NamedTuple):
    """One edge set of the flat graph in the dense slot layout."""

    features: torch.Tensor  # f32[M*K, edge_in] receiver-major, padded slots zero
    degrees: torch.Tensor  # f32[M, 1] valid slots per receiver (prefix-compacted)
    gather: Callable[[torch.Tensor], torch.Tensor]  # the sender gather [M, H] -> [M*K, H]
    k: int


def mesh_graph_net_apply(net: MeshGraphNet, node_features: torch.Tensor, mesh: EdgeSet,
                         world: EdgeSet) -> torch.Tensor:
    """Full forward over one flat graph; returns f32[M, node_out]."""
    m = node_features.shape[0]
    x = mlp_ln_apply(net._encoder.node_fn, node_features)
    d = x.shape[-1]
    sets = (mesh, world)
    es = [mlp_ln_apply(getattr(net._encoder, f"{name}_edge_fn"), s.features) * _slot_mask(s.degrees, m, s.k)
          for name, s in zip(EDGE_SETS, sets)]
    for block in net._processor.blocks:
        aggs, new_es = [], []
        for name, s, e in zip(EDGE_SETS, sets, es):
            edge_fn = getattr(block, f"{name}_edge_fn")
            (w_j, w_i, _), _ = split_first_layer(edge_fn[0], (d, d, d))
            new_e, agg = _edge_block_plain(edge_fn, e, s.gather(linear(x, w_j)), linear(x, w_i), s.degrees, s.k)
            new_es.append(new_e)
            aggs.append(agg)
        node_mlp, node_ln = block.node_fn[0], block.node_fn[1]
        (w_x, w_mesh, w_world), b_n = split_first_layer(node_mlp, (d, d, d))
        hn = linear(x, w_x) + linear(aggs[0], w_mesh) + linear(aggs[1], w_world) + b_n
        x = x + layer_norm(mlp_tail(node_mlp, hn), node_ln.weight, node_ln.bias)
        es = new_es
    return net._decoder.node_fn(x)
