"""Reference checkpoints into the port.

The counterpart of ``sgnn_tpu/utils/torch_import.py``. The reference saves
plain state_dicts (learned_simulator.py:519-527,
multi_scale_simulator.py:362-368) whose keys follow its module tree; the
port's ``LearnedSimulator`` and ``MultiScaleSimulator`` use that very key
layout, so a reference checkpoint loads straight into them with
``strict=True``: no mapping is needed (JAX's mappings, for the tests, are
``utils/jax_params.py``). What this module adds is reading the file
(``load_torch_checkpoint``: a ``.pt``, or an ``.npz`` of the same keys),
telling the family apart (``detect_family``) and reading the model's sizes
from the tensors' shapes (``single_scale_config``, ``multi_scale_config``),
so that ``simulator_from_state_dict`` builds the module the checkpoint
fits.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

import numpy as np
import torch

from sgnn_tpu_torch.physics.multi_scale_simulator import MultiScaleSimulator, MultiScaleSimulatorConfig
from sgnn_tpu_torch.physics.simulator import LearnedSimulator, SimulatorConfig

EPD = "_encode_process_decode"
MSG = "_multi_scale_gnn"
EMB = "_particle_type_embedding.weight"


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint as a dict of CPU tensors: a ``.pt`` state_dict
    (or a dict holding one under ``"state_dict"``), or an ``.npz`` of the
    same keys."""
    if str(path).endswith(".npz"):
        with np.load(path) as d:
            return {k: torch.from_numpy(np.array(d[k])) for k in d.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}


def detect_family(sd: Mapping[str, torch.Tensor]) -> str:
    """``"multi"`` or ``"single"`` from the key prefixes."""
    if any(k.startswith(MSG) for k in sd):
        return "multi"
    if any(k.startswith(EPD) for k in sd):
        return "single"
    raise ValueError(f"cannot detect model family: no {EPD} or {MSG} keys in the checkpoint")


def _count(sd: Mapping, pattern: str) -> int:
    return len({m.group(1) for k in sd for m in [re.match(pattern, k)] if m})


def _linears(sd: Mapping, prefix: str) -> int:
    return _count(sd, rf"{re.escape(prefix)}\.NN-(\d+)\.weight$")


def _types(sd: Mapping) -> tuple:
    if EMB in sd:
        return tuple(sd[EMB].shape)
    return 1, 9


def single_scale_config(sd: Mapping[str, torch.Tensor], **overrides) -> SimulatorConfig:
    """The ``SimulatorConfig`` whose ``LearnedSimulator`` has this
    state_dict's shapes (width, steps, MLP depth, input window, types);
    ``overrides`` set the fields the weights do not fix (radius, slots...)."""
    node_w = sd[f"{EPD}._encoder.node_fn.0.NN-0.weight"]
    edge_w = sd[f"{EPD}._encoder.edge_fn.0.NN-0.weight"]
    num_types, emb = _types(sd)
    dim = edge_w.shape[1] - 1
    node_in = node_w.shape[1] - (emb if num_types > 1 else 0)
    kw = dict(
        dim=dim,
        latent_dim=node_w.shape[0],
        num_message_passing_steps=_count(sd, rf"{EPD}\._processor\.gnn_stacks\.(\d+)\."),
        num_mlp_layers=_linears(sd, f"{EPD}._encoder.node_fn.0") - 1,
        input_sequence_length=(node_in - 1) // dim + 1,
        num_particle_types=num_types,
        particle_type_embedding_size=emb,
    )
    return dataclasses.replace(SimulatorConfig(**kw), **overrides)


def multi_scale_config(sd: Mapping[str, torch.Tensor], **overrides) -> MultiScaleSimulatorConfig:
    """The ``MultiScaleSimulatorConfig`` this state_dict's shapes fix."""
    node_w = sd[f"{MSG}.grid_node_encoder.0.NN-0.weight"]
    edge_w = sd[f"{MSG}.g2m_edge_encoder.0.NN-0.weight"]
    num_types, emb = _types(sd)
    dim = edge_w.shape[1] - 1
    node_in = node_w.shape[1] - (emb if num_types > 1 else 0)
    kw = dict(
        dim=dim,
        latent_dim=node_w.shape[0],
        num_message_passing_steps=_count(sd, rf"{MSG}\.m2m_blocks\.(\d+)\."),
        num_mlp_layers=_linears(sd, f"{MSG}.grid_node_encoder.0") - 1,
        input_sequence_length=(node_in - 1) // dim + 1,
        num_particle_types=num_types,
        particle_type_embedding_size=emb,
    )
    return dataclasses.replace(MultiScaleSimulatorConfig(**kw), **overrides)


def simulator_from_state_dict(sd: Mapping[str, torch.Tensor], device, cfg=None):
    """(module, config) with the reference state_dict loaded,
    ``strict=True``: a ``LearnedSimulator`` or a ``MultiScaleSimulator`` by
    the family; ``cfg`` (else read from the shapes) must fit the weights."""
    family = detect_family(sd)
    if family == "single":
        cfg = cfg or single_scale_config(sd)
        sim = LearnedSimulator(cfg, device=device)
    else:
        cfg = cfg or multi_scale_config(sd)
        sim = MultiScaleSimulator(cfg, device=device)
    sim.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return sim, cfg

