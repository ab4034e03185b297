"""YAML config + CLI overrides.

The port's own copy of ``sgnn_tpu/train/config.py``: the same flat
``TrainConfig`` fields, so every config in ``configs/`` loads 1:1.
``yaml`` is imported inside ``load_config`` only; a caller that builds
``TrainConfig`` in Python needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # mode & paths
    mode: str = "train"  # train | valid | rollout
    data_path: str = "datasets/taylor_impact_2d/data_processed/"
    model_path: str = "models/single_scale/"
    output_path: str = "rollouts/single_scale/"

    # model
    layers: int = 5
    hidden_dim: int = 64
    dim: int = 2
    particle_type_embedding_size: int = 9
    input_sequence_length: int = 11
    connection_radius: float = 0.6

    # training
    batch_size: int = 32
    noise_std: float = 0.02
    ntraining_steps: int = 100_000
    nsave_steps: int = 2000

    # loss weights
    loss_weight_position: float = 1.0
    loss_weight_strain: float = 1.0

    # LR schedule
    lr_init: float = 1e-3
    lr_decay: float = 0.1
    lr_decay_steps: int = 30_000

    # logging
    log: bool = False
    project_name: str = "Taylor_impact_2d"
    run_name: str = "single_scale_default"

    # model loading
    model_file: Optional[str] = None
    train_state_file: Optional[str] = None

    # inference
    inference_mode: str = "autoregressive"
    debug_graph: bool = False

    # multi-scale family
    num_scales: int = 2
    window_size: int = 2
    radius_multiplier: float = 2.0
    edge_pad_multiple: int = 1024
    ms_dense: bool | str = "auto"

    # additions of the JAX package (same names, same defaults)
    pad_multiple: int = 128  # node-count padding granularity
    domain_min: Optional[List[float]] = None  # static search domain; None -> O(N^2)
    domain_max: Optional[List[float]] = None
    cell_capacity: int = 8  # max occupants read per search cell
    data_parallel: int = 1
    graph_parallel: int = 1
    neighbor_slots: Optional[int] = None  # None -> recorded max degree + 2
    symmetric_gather: Optional[bool] = None
    compute_dtype: str = "float32"
    band_nodes: Optional[int] = None
    remat: object = False
    inner_steps: int = 1
    seed: int = 0
    log_every: int = 10

    # the single-scale trainer's model: "gns" (the reference's),
    # "meshgraphnet" (physics/mesh_simulator.py) or "graphcast"
    # (models/graphcast.py, on gridded fields: data/fields.py)
    architecture: str = "gns"
    # meshgraphnet: the static mesh (first-frame pairs closer than
    # mesh_radius) and the per-step world edges (pairs closer than
    # world_radius, mesh pairs and self taken out); slot widths None ->
    # derived from the training split (mesh_simulator.derive_slots)
    mesh_radius: float = 0.6
    world_radius: float = 0.75
    mesh_slots: Optional[int] = None
    world_search_slots: Optional[int] = None
    world_slots: Optional[int] = None
    # graphcast: the icosahedral mesh's refinement level (the multi-mesh
    # joins levels 0 to it)
    mesh_refinement: int = 5

    @property
    def domain(self) -> Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]]:
        if self.domain_min is None or self.domain_max is None:
            return None
        return (tuple(self.domain_min), tuple(self.domain_max))


def load_config(path: str | Path, overrides: Optional[dict] = None) -> TrainConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"Unknown config keys in {path}: {sorted(unknown)}")
    cfg = TrainConfig(**raw)
    for k, v in (overrides or {}).items():
        if v is not None:
            setattr(cfg, k, v)
    return cfg
