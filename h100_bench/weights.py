"""The model's weights, made by the benchmark from the run's seed.

One ``torch.rand`` call on the device (a ``torch.Generator`` there, seeded
from the run's seed) draws every Linear's weight and bias at once; each
takes the reference's init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)); LayerNorm
scales are 1 and offsets 0. ``output_scale`` multiplies the last Linear of
the decoder (a serving cell's stand-in for a trained model, whose
predicted accelerations stay small: see ``traffic/*.json``). The same
tensors go to the port (``load_state_dict``) and, cloned, to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device, output_layer: str = "",
                 output_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    linear = [k for k in shapes if ".NN-" in k]
    total = sum(math.prod(shapes[k]) for k in linear)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if ".NN-" not in name:  # LayerNorm
            fill = 1.0 if name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
            continue
        fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
        size = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        w = (flat[at:at + size] * 2.0 - 1.0) * bound
        at += size
        if name.startswith(output_layer + ".") and output_layer:
            w = w * output_scale
        out[name] = w.reshape(shape)
    return out
