"""Random-walk training noise.

Port of ``sgnn_tpu/physics/noise.py`` (itself a re-derivation of the
reference's ``noise_utils.py``). Velocity noise is a random walk with zero
noise on the first frame, integrated to positions; the per-step std is
``noise_std_last_step / sqrt(num_velocities)``, so the velocity noise at
the last step has the configured std. Both integrations are one linear
map of the iid draws: a matmul against the constant integration matrix

    W[(u, c), (t, c')] = (c == c') * max(t - u, 0)

on draws laid out as ``[..., V*dim]``, as in the JAX module. The draws
come from a ``torch.Generator`` (another stream than JAX's); ``z`` lets a
caller pass its own draws, so that both packages give the same noise, or
a static buffer that ``draw_into`` fills (the captured training step draws
outside its CUDA graph, on the same stream as the eager step).
"""

from __future__ import annotations

from typing import Optional

import torch


def integration_matrix(n_steps: int, dim: int, device=None) -> torch.Tensor:
    """f32[V*dim, S*dim]: W[(u, c), (t, c')] = (c == c') * max(t - u, 0)."""
    v = n_steps - 1
    u = torch.arange(v, device=device)[:, None]
    t = torch.arange(n_steps, device=device)[None, :]
    counts = torch.clamp(t - u, min=0).float()  # [V, S]
    eye = torch.eye(dim, device=device)
    return torch.einsum("ut,cd->uctd", counts, eye).reshape(v * dim, n_steps * dim)


def draw_shape(shape: tuple) -> tuple:
    """The shape of the iid draws ``z`` behind noise of ``shape``:
    ``shape[:-2] + ((S - 1) * dim,)``."""
    return tuple(shape[:-2]) + ((shape[-2] - 1) * shape[-1],)


def draw_into(z: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``z`` with standard-normal draws from ``generator``, in place:
    the numbers ``torch.randn(z.shape, generator=generator)`` draws."""
    return torch.randn(z.shape, generator=generator, out=z)


def random_walk_position_noise(
    shape: tuple,  # (N, S, dim) or (B, N, S, dim)
    std: float,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32 noise of ``shape`` to add to a position sequence.

    z: optional iid standard-normal draws ``[..., V*dim]`` (V = S - 1);
    drawn from ``generator`` on ``device`` when not given.
    """
    n_steps, dim = shape[-2], shape[-1]
    v = n_steps - 1
    lead = tuple(shape[:-2])
    if z is None:
        z = torch.randn(draw_shape(shape), generator=generator, device=device)
    elif tuple(z.shape) != draw_shape(shape):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {draw_shape(shape)}")
    z = z.to(device=device, dtype=torch.float32) * (std / v**0.5)
    w = integration_matrix(n_steps, dim, device=z.device)
    return (z @ w).reshape(lead + (n_steps, dim))
