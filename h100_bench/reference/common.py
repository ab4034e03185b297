"""Shared pieces of the plain reference: products at a stated precision,
Linear / MLP / LayerNorm over a flat parameter dict, the random-walk
training noise, the masked one-step loss, Adam, and normalisation."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch

LN_EPS = 1e-5
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def tf32_off():
    """Plain float32 products on the card (TF32 off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even), kept in
    float32: what a TF32 tensor core reads of an f32 operand. No gradient."""
    x = x.detach().contiguous()
    bits = x.view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, in the forward
    and in both products of the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.t(), ra.t() @ rg


class Precision:
    """Products at ``"f32"`` (TF32 off) or ``"tf32"`` (operands rounded)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision is f32 or tf32, got {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return a @ b


def linear(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """y = x W^T + b with W [out, in] (the reference layout)."""
    return prec.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def mlp(p: Params, name: str, x: torch.Tensor, n_linear: int, prec: Precision) -> torch.Tensor:
    """The reference ``build_mlp``: Linear (``NN-i``) and ReLU, none after the last."""
    for i in range(n_linear):
        x = linear(p, f"{name}.NN-{i}", x, prec)
        if i < n_linear - 1:
            x = torch.relu(x)
    return x


def layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


def mlp_ln(p: Params, name: str, x: torch.Tensor, n_linear: int, prec: Precision) -> torch.Tensor:
    """``Sequential(MLP, LayerNorm)``: children ``0`` and ``1``."""
    return layer_norm(p, f"{name}.1", mlp(p, f"{name}.0", x, n_linear, prec))


def mlp_shapes(name: str, sizes: List[int], ln: bool) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes of an MLP (``name.0.NN-i`` with a LayerNorm at
    ``name.1``, or ``name.NN-i`` without)."""
    base = f"{name}.0" if ln else name
    out = {}
    for i in range(len(sizes) - 1):
        out[f"{base}.NN-{i}.weight"] = (sizes[i + 1], sizes[i])
        out[f"{base}.NN-{i}.bias"] = (sizes[i + 1],)
    if ln:
        out[f"{name}.1.weight"] = (sizes[-1],)
        out[f"{name}.1.bias"] = (sizes[-1],)
    return out


def norm_stats(metadata: dict, noise_std: float, device) -> Dict[str, torch.Tensor]:
    """Velocity and acceleration statistics with the noise folded into the
    std: sqrt(std^2 + noise^2)."""

    def t(key):
        return torch.tensor(metadata[key], dtype=torch.float32, device=device)

    return {"vel_mean": t("vel_mean"), "vel_std": torch.sqrt(t("vel_std") ** 2 + noise_std ** 2),
            "acc_mean": t("acc_mean"), "acc_std": torch.sqrt(t("acc_std") ** 2 + noise_std ** 2)}


def random_walk_noise(z: torch.Tensor, seq_len: int, dim: int, std: float) -> torch.Tensor:
    """Position noise [..., S, dim] from standard-normal draws z [...,
    (S-1)*dim] laid out step-major: velocity noise is the running sum of
    the draws scaled by std / sqrt(S - 1), position noise the running sum
    of the velocity noise, zero on the first frame."""
    steps = seq_len - 1
    vel = torch.cumsum(z.reshape(*z.shape[:-1], steps, dim) * (std / math.sqrt(steps)), dim=-2)
    pos = torch.cumsum(vel, dim=-2)
    return torch.cat([torch.zeros_like(pos[..., :1, :]), pos], dim=-2)


def features_velocity(window: torch.Tensor, stats) -> torch.Tensor:
    """Normalised finite-difference velocities of a window [..., S, dim],
    flattened step-major to [..., (S-1)*dim]."""
    vel = (window[..., 1:, :] - window[..., :-1, :] - stats["vel_mean"]) / stats["vel_std"]
    return vel.reshape(*window.shape[:-2], -1)


def target_acceleration(next_pos: torch.Tensor, window: torch.Tensor, stats) -> torch.Tensor:
    """The normalised acceleration that carries the window to next_pos."""
    last = window[..., -1, :]
    acc = (next_pos - last) - (last - window[..., -2, :])
    return (acc - stats["acc_mean"]) / stats["acc_std"]


def integrate(norm_acc: torch.Tensor, window: torch.Tensor, stats) -> torch.Tensor:
    """Euler with dt = 1: last + (velocity + acceleration)."""
    acc = norm_acc * stats["acc_std"] + stats["acc_mean"]
    last = window[..., -1, :]
    return last + ((last - window[..., -2, :]) + acc)


def one_step_loss(pred_acc, target_acc, pred_strain, next_strain, mask) -> torch.Tensor:
    """The masked mean over real nodes of the summed squared acceleration
    error plus the squared strain error (weights 1 and 1)."""
    m = mask.to(pred_acc.dtype)
    per_node = ((pred_acc - target_acc) ** 2).sum(dim=-1) + (pred_strain - next_strain) ** 2
    return (per_node * m).sum() / m.sum().clamp(min=1.0)


def learning_rate(step: int, train_config: dict) -> float:
    """lr_init * decay^(step / decay_steps) + 1e-6, with the step counted
    before the update."""
    return train_config["lr_init"] * train_config["lr_decay"] ** (step / train_config["lr_decay_steps"]) + 1e-6


class Adam:
    """Adam over a dict of leaves (betas 0.9 / 0.999, eps 1e-8), written out."""

    def __init__(self, params: Params):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Params, grads: Params, lr: float) -> Params:
        b1, b2 = ADAM_BETAS
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        return out


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n, data.shape[-1]), dtype=data.dtype, device=data.device).index_add_(0, ids, data)
