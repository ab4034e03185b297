"""Linear, MLP, LayerNorm and Embedding as torch modules.

Port of ``sgnn_tpu/nn/core.py``. Parameter names follow the reference
PyTorch layout, so a simulator's ``state_dict()`` has the keys that
``sgnn_tpu/utils/torch_import.export_single_scale`` emits:

  * Linear: ``weight [out, in]``, ``bias [out]``; init U(-1/sqrt(in),
    1/sqrt(in)) for both, as ``core.py:34-41`` (from an explicit
    ``torch.Generator``).
  * MLP: the reference ``build_mlp`` Sequential, children ``NN-i``
    (Linear) and ``Act-i`` (ReLU, or SiLU where ``activation="silu"``;
    Identity on the last layer).
  * LayerNorm: ``weight`` (scale, init 1) and ``bias`` (init 0); moments
    in f32 with eps 1e-5, output in the input's dtype (``core.py:81-91``).
  * Embedding: ``weight [num, dim]``, init N(0, 1).

A Linear, and an MLP's Linear with the ReLU after it, is one call of
``ops/f32_product.linear``: the 3xTF32 tensor-core kernels for f32 inputs
on the card, else the composite (``x @ w + b``, then the ReLU). A SiLU
layer is that product with its bias, then ``F.silu`` (``activate``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sgnn_tpu_torch.ops.f32_product import linear

LN_EPS = 1e-5
ACTIVATIONS = ("relu", "silu")


class Linear(nn.Module):
    """y = x @ weight.T + bias, weight stored [out, in] (torch layout)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        bound = 1.0 / (in_dim**0.5)
        w = torch.empty(out_dim, in_dim).uniform_(-bound, bound, generator=generator)
        b = torch.empty(out_dim).uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(b.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight.t(), self.bias)


class MLP(nn.Sequential):
    """Reference ``build_mlp``: Linear->activation stacks, identity on the
    last; the activation is ReLU, or SiLU (GraphCast's swish)."""

    def __init__(
        self,
        in_dim: int,
        hidden_dims: Sequence[int],
        out_dim: int,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
        activation: str = "relu",
    ):
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
        sizes = [in_dim, *hidden_dims, out_dim]
        mods = OrderedDict()
        for i in range(len(sizes) - 1):
            mods[f"NN-{i}"] = Linear(sizes[i], sizes[i + 1], generator=generator, device=device)
            act = nn.ReLU() if activation == "relu" else nn.SiLU()
            mods[f"Act-{i}"] = act if i < len(sizes) - 2 else nn.Identity()
        super().__init__(mods)
        self.activation = activation

    @property
    def linears(self) -> list[Linear]:
        return [m for m in self if isinstance(m, Linear)]

    def hidden(self, x: torch.Tensor, lin: Linear) -> torch.Tensor:
        """A hidden layer: ``lin`` and the activation after it (the ReLU
        inside the product's call)."""
        if self.activation == "relu":
            return linear(x, lin.weight.t(), lin.bias, relu=True)
        return F.silu(linear(x, lin.weight.t(), lin.bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The children in order, each hidden Linear with its activation."""
        linears = self.linears
        for lin in linears[:-1]:
            x = self.hidden(x, lin)
        last = linears[-1]
        return linear(x, last.weight.t(), last.bias)


def activate(mlp: MLP, h: torch.Tensor) -> torch.Tensor:
    """The MLP's activation of a preactivation ``h`` taken apart from its
    product (the split first layer's)."""
    return torch.relu(h) if mlp.activation == "relu" else F.silu(h)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with f32 moments; returns x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return (xhat * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def mlp_ln(
    in_dim: int,
    hidden_dims: Sequence[int],
    out_dim: int,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    activation: str = "relu",
) -> nn.Sequential:
    """Sequential(MLP, LayerNorm): the encoder / interaction-network block
    (children ``0`` and ``1``, as the reference)."""
    return nn.Sequential(
        MLP(in_dim, hidden_dims, out_dim, generator=generator, device=device, activation=activation),
        LayerNorm(out_dim, device=device),
    )


class Embedding(nn.Module):
    def __init__(
        self,
        num_embeddings: int,
        dim: int,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        w = torch.randn(num_embeddings, dim, generator=generator)
        self.weight = nn.Parameter(w.to(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # advanced indexing (not F.embedding): negative ids wrap like the
        # JAX table lookup ``table[ids]``
        return self.weight[ids]
