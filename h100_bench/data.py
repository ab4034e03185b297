"""The benchmark's synthetic Taylor-impact dataset, made in memory.

A frozen copy of ``sgnn_tpu_torch/data/synthetic.py``
(``simulate_taylor_impact``, unchanged) and of the statistics of
``sgnn_tpu_torch/data/builder.py`` (``DatasetBuilder._process_file`` and
``build``: the crop one raw step before the first frame whose mean stress
passes the threshold, ``total_steps`` raw steps strided by ``step_size``,
the last ``boundary_particles_to_remove`` particles dropped, pooled
velocity and acceleration statistics, z-scored stresses and the spatial
extent; ``max_degree`` is DatasetBuilder's largest degree, which the
configurations write out as ``neighbor_slots``, so set-up skips it). No
raw file is written: the runs are made in memory and only the processed
splits the port reads are written (``write_split``, ``write_metadata``),
in the port's format.

The dataset does not depend on the run's seed: ``data_seed`` in the
configuration fixes the runs, so that every seed of a cell serves the
same set of sizes (the run's seed orders the samples and requests and
makes the weights and the noise).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

Trajectory = Tuple[np.ndarray, np.ndarray, np.ndarray]  # positions [T, N, 2], types [N], stresses [T, N]


def _bar_lattice(nx: int, ny: int, spacing: float, x0: float, y0: float):
    xs, ys = np.meshgrid(np.arange(nx) * spacing, np.arange(ny) * spacing, indexing="ij")
    return np.stack([xs.ravel() + x0, ys.ravel() + y0], axis=-1)


def simulate_taylor_impact(*, nx: int = 120, ny: int = 40, spacing: float = 0.5, wall_x: float = -2.0,
                           impact_speed: float = 0.25, num_steps: int = 152, dt: float = 1.0,
                           softness: float = 3.0, rng: Optional[np.random.Generator] = None):
    """One synthetic run: (positions [T, N, 2], types [N], stress [T, N]).
    A copy of ``sgnn_tpu_torch.data.synthetic.simulate_taylor_impact``."""
    rng = rng or np.random.default_rng(0)
    base = _bar_lattice(nx, ny, spacing, x0=wall_x + 1.0, y0=-(ny - 1) * spacing / 2)
    n = base.shape[0]
    base = base + rng.normal(scale=0.02 * spacing, size=base.shape)
    bar_len = nx * spacing
    positions = np.empty((num_steps, n, 2), np.float32)
    stress = np.zeros((num_steps, n), np.float32)
    s_coord = base[:, 0] - base[:, 0].min()
    y_coord = base[:, 1]
    gap0 = base[:, 0].min() - wall_x
    t_contact = gap0 / impact_speed
    for t in range(num_steps):
        time = t * dt
        if time < t_contact:
            x = base[:, 0] - impact_speed * time
            y = y_coord.copy()
            sig = np.zeros(n)
        else:
            tau = (time - t_contact) / softness
            squash = 1.0 - 0.35 * np.exp(-s_coord / (0.3 * bar_len)) * (1 - np.exp(-tau))
            x = wall_x + gap0 * np.exp(-tau * 3.0) + s_coord * squash
            spread = 1.0 + 0.5 * np.exp(-s_coord / (0.15 * bar_len)) * (1 - np.exp(-tau))
            y = y_coord * spread
            sig = 120.0 * np.exp(-s_coord / (0.4 * bar_len)) * (1 - np.exp(-tau * 4)) * np.exp(-tau / 4)
        positions[t, :, 0] = x
        positions[t, :, 1] = y
        stress[t] = sig + rng.normal(scale=0.5, size=n) * (sig > 0)
    return positions, np.zeros(n, np.int64), stress.astype(np.float32)


def max_degree(frames: np.ndarray, radius: float) -> int:
    """The largest radius-graph degree (``<= r``, self included) over
    ``frames`` [T, N, 2], as DatasetBuilder counts it with cKDTree."""
    from scipy.spatial import cKDTree

    best = 0
    for frame in frames:
        best = max(best, int(cKDTree(frame).query_ball_point(frame, radius, return_length=True).max()))
    return best


def make_dataset(spec: dict) -> Tuple[List[Trajectory], dict]:
    """The processed trajectories and their metadata from a dataset spec
    (the ``dataset`` block of a configuration file): ``num_trajectories``
    runs of an ``nx`` x ``ny`` bar, run i at impact speed ``0.15 + 0.02 i``
    from ``default_rng(data_seed + i)``, as the port's generator makes them."""
    n_traj, nx, ny = int(spec["num_trajectories"]), int(spec["nx"]), int(spec["ny"])
    raw_steps, step_size, total = int(spec["raw_steps"]), int(spec["step_size"]), int(spec["total_steps"])
    nb, thresh, radius = int(spec["boundary_particles_to_remove"]), float(spec["stress_threshold"]), float(
        spec["radius"])
    trajs: List[Trajectory] = []
    vels, accs, stresses = [], [], []
    lo, hi = None, None
    for i in range(n_traj):
        pos, types, sig = simulate_taylor_impact(nx=nx, ny=ny, impact_speed=0.15 + 0.02 * i, num_steps=raw_steps,
                                                 rng=np.random.default_rng(int(spec["data_seed"]) + i))
        above = np.nonzero(sig.mean(axis=1) > thresh)[0]
        if len(above) == 0:
            continue
        start = max(int(above[0]) - 1, 0)
        sl = slice(start, start + total, step_size)
        keep = slice(None, -nb) if nb else slice(None)
        pos, sig, types = pos[sl, keep, :], sig[sl, keep], np.zeros_like(types[keep])
        vel = pos[1:] - pos[:-1]
        vels.append(vel.reshape(-1, 2))
        accs.append((vel[1:] - vel[:-1]).reshape(-1, 2))
        stresses.append(sig.reshape(-1))
        plo, phi = pos.min(axis=(0, 1)), pos.max(axis=(0, 1))
        lo = plo if lo is None else np.minimum(lo, plo)
        hi = phi if hi is None else np.maximum(hi, phi)
        trajs.append((pos.astype(np.float32), types.astype(np.int64), sig.astype(np.float32)))
    vel, acc, st = np.concatenate(vels), np.concatenate(accs), np.concatenate(stresses)
    mean, std = float(st.mean()), float(st.std())
    trajs = [(p, t, (s - mean) / std) for p, t, s in trajs]
    metadata = {
        "dim": 2, "sequence_length": total // step_size, "default_connectivity_radius": radius,
        "num_particle_types": 1,
        "vel_mean": vel.mean(axis=0).tolist(), "vel_std": vel.std(axis=0).tolist(),
        "acc_mean": acc.mean(axis=0).tolist(), "acc_std": acc.std(axis=0).tolist(),
        "stress_mean": mean, "stress_std": std,
        "pos_min": lo.tolist(), "pos_max": hi.tolist(),
    }
    return trajs, metadata


def write_split(path: Path, trajectories: List[Trajectory], names: Optional[List[str]] = None) -> Path:
    """One split file in the port's format: ``{"trajectories": {name:
    (positions, types, stresses)}}`` (the loaders sort by name)."""
    names = names or [f"case-{i:03d}" for i in range(len(trajectories))]
    data: Dict[str, Trajectory] = dict(zip(names, trajectories))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, trajectories=data)
    return path


def write_metadata(directory: Path, metadata: dict) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "metadata.json", "w") as f:
        json.dump(metadata, f)


def prepare(spec: dict, directory: Path, cases: bool) -> Tuple[List[Trajectory], dict]:
    """The dataset of ``spec`` in ``directory``: made and written on the
    first call (``train.npz``, ``metadata.json`` and, with ``cases``, one
    ``cases/case-XXX.npz`` per trajectory), read back on later ones."""
    import os
    import shutil

    done = directory / "complete"
    if not done.exists():
        trajs, metadata = make_dataset(spec)
        tmp = directory.with_name(f"{directory.name}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        names = [f"case-{i:03d}" for i in range(len(trajs))]
        write_split(tmp / "train.npz", trajs, names)
        if cases:
            for name, traj in zip(names, trajs):
                write_split(tmp / "cases" / f"{name}.npz", [traj], [name])
        write_metadata(tmp, metadata)
        (tmp / "complete").write_text("ok\n")
        if directory.exists():
            shutil.rmtree(directory)
        os.replace(tmp, directory)
    with open(directory / "metadata.json") as f:
        metadata = json.load(f)
    with np.load(directory / "train.npz", allow_pickle=True) as z:
        table = z["trajectories"].item()
    return [table[k] for k in sorted(table)], metadata
