"""What every cell shares: finding a cell's files by name, the context a
runner runs in, the model sizes the reference and the counters take from a
configuration, the check of imported modules, and the scratch and data
directories."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sgnn_tpu")  # top-level names, compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json``, with every file it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, benchmark: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration (the
    config entry's ``file``), its traffic mix (``traffic/<traffic>.json``
    under the benchmark's directory), its workload file
    (``workloads/<name>.json``: the limits of its check) and the metrics
    that name it (an entry without ``workloads`` names every cell that
    reports the end-to-end metric it moves). ``benchmark``: another
    ``BENCHMARK.json``, whose directory holds that benchmark's files."""
    path = Path(benchmark) if benchmark else ROOT / "BENCHMARK.json"
    bench = load_json(path)
    root = path.parent
    bench_dir = root / bench["paths"][0]
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {path}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]
    return Cell(name, int(entry["chips"]), config, traffic, workload, e2e, per_layer)


def model_sizes(config: dict) -> dict:
    """The sizes the reference and the counters read, from a configuration."""
    tc = config["train_config"]
    family = config["family"]
    mc = {
        "family": family, "latent": tc["hidden_dim"], "dim": tc["dim"], "layers": tc["layers"],
        "seq_len": tc["input_sequence_length"], "radius": tc["connection_radius"],
        # hidden layers per MLP: the reference trainers' (single-scale 1, multi-scale 2)
        "mlp_hidden_layers": 1 if family == "single_scale" else 2,
        "slots": tc.get("neighbor_slots") or 20, "dtype": tc.get("compute_dtype", "float32"),
        "noise_std": tc["noise_std"],
    }
    if family == "multi_scale":
        mc.update(window_size=tc["window_size"], radius_multiplier=tc["radius_multiplier"],
                  num_scales=tc["num_scales"])
    return mc


def forbidden_loaded() -> List[str]:
    """Modules of ``sys.modules`` whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES})


def scratch_dir(cell: str) -> Path:
    """The run's scratch directory (a trace, the serving cells' request
    files): under ``TMPDIR``, else under the checkout's ``build/``."""
    base = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else ROOT / "build"
    path = base / "h100_bench" / cell
    path.mkdir(parents=True, exist_ok=True)
    return path


def data_cache_dir(spec: dict) -> Path:
    """A dataset's fixed directory inside the checkout, named by a hash of
    its spec: the first run of a cell writes it, later runs read it."""
    digest = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    return ROOT / "build" / "h100_bench_data" / digest
