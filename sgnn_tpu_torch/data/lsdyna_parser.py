"""LS-DYNA text-dump parser (L0 raw-data ingestion).

The port's own copy of ``sgnn_tpu/data/lsdyna_parser.py`` (numpy only):
``parse_simulation``, ``parse_simulation_strain``, ``convert_to_npz`` and
the CLI ``python -m sgnn_tpu_torch.data.lsdyna_parser FILE... --out DIR``.

Re-derivation of the reference parser
(notebooks/parse_lsdyna_simulation.py:6-124): extracts per-timestep
particle coordinates, particle types (from per-case particle-ID range
tables), and effective-plastic-strain / max-principal-strain fields from
LS-DYNA keyword-format text dumps.

Format recognized (same sentinels as the reference):
  *NODE                                -> start of a position block
  $NODAL_RESULTS                       -> end of a position block
  $RESULT OF Effective Plastic Strain  -> start of a strain block
  $RESULT OF  Max Prin Strain          -> start of a max-principal block
  *END                                 -> end of a strain block

Output schema matches the synthetic generator / dataset builder inputs:
positions [T, N, 2], particle_types [N], strains [T, N].
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_NUM = re.compile(r"[-+\d\.Ee]+")

# Per-case particle-ID ranges -> type id (reference table,
# parse_lsdyna_simulation.py:14-33). Type codes: 0=bulk material,
# 1=support/boundary (rigid), 2=impactor, 3=kinematic loading.
DEFAULT_PARTICLE_TABLES: Dict[str, Dict[str, Tuple[int, int]]] = {
    "B_80_320": {"concrete": (1, 4096), "kinematic": (4153, 4264), "support": (4265, 4328)},
    "B_80_480": {"concrete": (1, 6144), "kinematic": (6181, 6292), "support": (6293, 6356)},
    "B_80_640": {"concrete": (1, 8192), "kinematic": (8229, 8340), "support": (8341, 8404)},
    "R_80_320": {"concrete": (1, 4096), "kinematic": (4153, 4264), "support": (4265, 4328)},
    "R_80_480": {"concrete": (1, 6144), "kinematic": (6181, 6292), "support": (6293, 6356)},
    "R_80_640": {"concrete": (1, 8192), "kinematic": (8229, 8340), "support": (8341, 8404)},
    "S_80_320": {"concrete": (1, 4096), "kinematic": (4097, 4208), "support": (4209, 4272)},
    "S_80_480": {"concrete": (1, 6144), "kinematic": (6145, 6256), "support": (6257, 6320)},
    "S_80_640": {"concrete": (1, 8192), "kinematic": (8193, 8304), "support": (8305, 8368)},
    "C_80_320": {"concrete": (1, 4096), "kinematic": (4097, 4128), "support": (4129, 4196)},
    "C_80_480": {"concrete": (1, 6144), "kinematic": (6145, 6176), "support": (6177, 6244)},
    "C_80_640": {"concrete": (1, 8192), "kinematic": (8193, 8224), "support": (8225, 8292)},
    "C_60_240": {"concrete": (1, 2304), "kinematic": (8193, 8224), "support": (8225, 8292)},
    "C_80_560": {"concrete": (1, 7168), "kinematic": (8193, 8224), "support": (8225, 8292)},
    "S_80_400": {"concrete": (177, 5296), "kinematic": (1, 112), "support": (113, 176)},
    "S_100_80": {"concrete": (177, 12976), "kinematic": (1, 112), "support": (113, 176)},
}


def _block_ranges(lines, start_tag: str, end_tags: Tuple[str, ...]):
    starts, ends = [], []
    for idx, line in enumerate(lines):
        if line.startswith(start_tag):
            starts.append(idx)
        elif any(line.startswith(t) for t in end_tags):
            ends.append(idx)
    return list(zip(starts, ends))


def parse_simulation(
    file: str | Path,
    particle_tables: Optional[Dict] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse one LS-DYNA dump -> (trajectory [T,N,2], types [N], eps [T,N]).

    Particle types resolve from the per-case ID-range table keyed by the
    first 8 chars of the filename (reference convention); unknown cases
    default to all-zero types with a warning-free fallback.
    """
    particle_tables = particle_tables or DEFAULT_PARTICLE_TABLES
    file = Path(file)
    lines = file.read_text().splitlines()

    pos_blocks = _block_ranges(lines, "*NODE", ("$NODAL_RESULTS",))
    strain_blocks = _block_ranges(
        lines, "$RESULT OF Effective Plastic Strain", ("*END",)
    )

    trajectory = []
    particle_ids = None
    for b_start, b_end in pos_blocks:
        step = []
        ids = []
        for line in lines[b_start + 1 : b_end]:
            nums = _NUM.findall(line)
            if len(nums) < 3:
                continue
            ids.append(int(float(nums[0])))
            step.append((float(nums[1]), float(nums[2])))
        trajectory.append(step)
        if particle_ids is None:
            particle_ids = ids

    case = file.name[:8]
    table = particle_tables.get(case)
    types = []
    for pid in particle_ids or []:
        if table is None:
            types.append(0)
        elif table["concrete"][0] <= pid <= table["concrete"][1]:
            types.append(0)
        elif table["support"][0] <= pid <= table["support"][1]:
            types.append(1)
        elif table["kinematic"][0] <= pid <= table["kinematic"][1]:
            types.append(3 if case.startswith("C") else 2)
        else:
            raise ValueError(f"particle id {pid} not in type table for {case}")

    strains = []
    for b_start, b_end in strain_blocks:
        vals = []
        for line in lines[b_start + 1 : b_end]:
            nums = _NUM.findall(line)
            if len(nums) < 2:
                continue
            vals.append(float(nums[1]))
        strains.append(vals)

    return (
        np.asarray(trajectory, float),
        np.asarray(types, float),
        np.asarray(strains, float),
    )


def parse_simulation_strain(file: str | Path) -> np.ndarray:
    """Max-principal-strain companion file (…_strain.txt under mps/)."""
    file = str(file)
    filename = file.split(".")[0] + "_strain.txt"
    filename = filename.replace("coordinates_eps", "mps")
    lines = Path(filename).read_text().splitlines()
    blocks = _block_ranges(lines, "$RESULT OF  Max Prin Strain", ("*END",))
    strains = []
    for b_start, b_end in blocks:
        vals = []
        for line in lines[b_start + 1 : b_end]:
            nums = _NUM.findall(line)
            if len(nums) < 2:
                continue
            vals.append(float(nums[1]))
        strains.append(vals)
    return np.asarray(strains, float)


def convert_to_npz(txt_file: str | Path, out_file: str | Path) -> Path:
    """Parse an LS-DYNA dump and write the raw-npz schema the dataset
    builder consumes (positions/particle_types/strains)."""
    positions, types, strains = parse_simulation(txt_file)
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        out_file,
        positions=positions.astype(np.float32),
        particle_types=types.astype(np.int64),
        strains=strains.astype(np.float32),
    )
    return out_file


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Parse LS-DYNA txt dumps to raw npz")
    p.add_argument("inputs", nargs="+", help="LS-DYNA .txt files")
    p.add_argument("--out", required=True, help="output directory")
    args = p.parse_args()
    for f in args.inputs:
        out = Path(args.out) / (Path(f).stem + ".npz")
        convert_to_npz(f, out)
        print(f"{f} -> {out}")
