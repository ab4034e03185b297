"""Weights carried across: JAX simulator params <-> the port's state_dict.

The port's own copy of the mappings in ``sgnn_tpu/utils/torch_import.py``:
``export_single_scale`` / ``import_single_scale`` (the reference
``LearnedSimulator`` layout) and ``export_multi_scale`` /
``import_multi_scale`` (the reference ``MultiScaleSimulator`` layout). JAX params are nested dicts
of arrays with Linear weights stored ``[in, out]``; torch stores
``[out, in]``. LayerNorm ``scale``/``bias`` become ``weight``/``bias``.
Imports nothing from JAX: arrays arrive and leave as numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

EPD = "_encode_process_decode"
MSG = "_multi_scale_gnn"
MS_ENCODERS = ("grid_node_encoder", "g2m_edge_encoder", "m2m_edge_encoder", "m2g_edge_encoder")
EMBEDDING = "_particle_type_embedding.weight"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _mlp_to(prefix: str, mlp: dict, out: Dict[str, torch.Tensor]) -> None:
    for i, layer in enumerate(mlp["layers"]):
        out[f"{prefix}.NN-{i}.weight"] = _t(np.asarray(layer["w"]).T)
        out[f"{prefix}.NN-{i}.bias"] = _t(layer["b"])


def _mlp_ln_to(prefix: str, p: dict, out: Dict[str, torch.Tensor]) -> None:
    _mlp_to(f"{prefix}.0", p["mlp"], out)
    out[f"{prefix}.1.weight"] = _t(p["ln"]["scale"])
    out[f"{prefix}.1.bias"] = _t(p["ln"]["bias"])


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX simulator params (``{'epd': ..., 'type_embedding'?: ...}``) ->
    a state_dict that ``LearnedSimulator.load_state_dict(strict=True)``
    accepts."""
    epd = params["epd"]
    out: Dict[str, torch.Tensor] = {}
    _mlp_ln_to(f"{EPD}._encoder.node_fn", epd["encoder"]["node"], out)
    _mlp_ln_to(f"{EPD}._encoder.edge_fn", epd["encoder"]["edge"], out)
    for m, block in enumerate(epd["processor"]):
        _mlp_ln_to(f"{EPD}._processor.gnn_stacks.{m}.edge_fn", block["edge"], out)
        _mlp_ln_to(f"{EPD}._processor.gnn_stacks.{m}.node_fn", block["node"], out)
    _mlp_to(f"{EPD}._decoder.node_fn", epd["decoder"], out)
    if "type_embedding" in params:
        out[EMBEDDING] = _t(params["type_embedding"]["table"])
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _mlp_from(prefix: str, sd: Mapping[str, torch.Tensor]) -> dict:
    layers, i = [], 0
    while f"{prefix}.NN-{i}.weight" in sd:
        layers.append(
            {
                "w": np.ascontiguousarray(_np(sd[f"{prefix}.NN-{i}.weight"]).T),
                "b": _np(sd[f"{prefix}.NN-{i}.bias"]),
            }
        )
        i += 1
    if not layers:
        raise KeyError(f"no NN-i linears under '{prefix}'")
    return {"layers": layers}


def _mlp_ln_from(prefix: str, sd: Mapping[str, torch.Tensor]) -> dict:
    return {
        "mlp": _mlp_from(f"{prefix}.0", sd),
        "ln": {"scale": _np(sd[f"{prefix}.1.weight"]), "bias": _np(sd[f"{prefix}.1.bias"])},
    }


def state_dict_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``state_dict_from_jax``: nested numpy params."""
    steps = sorted(
        {
            int(m.group(1))
            for key in sd
            for m in [re.match(rf"{EPD}\._processor\.gnn_stacks\.(\d+)\.", key)]
            if m
        }
    )
    params: dict = {
        "epd": {
            "encoder": {
                "node": _mlp_ln_from(f"{EPD}._encoder.node_fn", sd),
                "edge": _mlp_ln_from(f"{EPD}._encoder.edge_fn", sd),
            },
            "processor": [
                {
                    "edge": _mlp_ln_from(f"{EPD}._processor.gnn_stacks.{m}.edge_fn", sd),
                    "node": _mlp_ln_from(f"{EPD}._processor.gnn_stacks.{m}.node_fn", sd),
                }
                for m in steps
            ],
            "decoder": _mlp_from(f"{EPD}._decoder.node_fn", sd),
        }
    }
    if EMBEDDING in sd:
        params["type_embedding"] = {"table": _np(sd[EMBEDDING])}
    return params


def ms_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX multi-scale simulator params (``{'gnn': ..., 'type_embedding'?:
    ...}``) -> a state_dict that ``MultiScaleSimulator.load_state_dict(
    strict=True)`` accepts."""
    gnn = params["gnn"]
    out: Dict[str, torch.Tensor] = {}
    for enc in MS_ENCODERS:
        _mlp_ln_to(f"{MSG}.{enc}", gnn[enc], out)
    blocks = [("g2m_block", gnn["g2m_block"])]
    blocks += [(f"m2m_blocks.{m}", b) for m, b in enumerate(gnn["m2m_blocks"])]
    blocks.append(("m2g_block", gnn["m2g_block"]))
    for name, block in blocks:
        _mlp_ln_to(f"{MSG}.{name}.edge_fn", block["edge"], out)
        _mlp_ln_to(f"{MSG}.{name}.node_fn", block["node"], out)
    _mlp_to(f"{MSG}.prediction_head", gnn["prediction_head"], out)
    if "type_embedding" in params:
        out[EMBEDDING] = _t(params["type_embedding"]["table"])
    return out


def ms_state_dict_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``ms_state_dict_from_jax``: nested numpy params."""
    steps = sorted(
        {int(m.group(1)) for key in sd for m in [re.match(rf"{MSG}\.m2m_blocks\.(\d+)\.", key)] if m}
    )

    def block(prefix):
        return {"edge": _mlp_ln_from(f"{prefix}.edge_fn", sd), "node": _mlp_ln_from(f"{prefix}.node_fn", sd)}

    gnn = {enc: _mlp_ln_from(f"{MSG}.{enc}", sd) for enc in MS_ENCODERS}
    gnn["g2m_block"] = block(f"{MSG}.g2m_block")
    gnn["m2m_blocks"] = [block(f"{MSG}.m2m_blocks.{m}") for m in steps]
    gnn["m2g_block"] = block(f"{MSG}.m2g_block")
    gnn["prediction_head"] = _mlp_from(f"{MSG}.prediction_head", sd)
    params: dict = {"gnn": gnn}
    if EMBEDDING in sd:
        params["type_embedding"] = {"table": _np(sd[EMBEDDING])}
    return params
