"""The GraphCast cell's synthetic gridded fields, made from the dataset
spec's ``data_seed`` (not the run's seed) and written in the port's split
format (``sgnn_tpu_torch/data/fields.py``): ERA5's shape without ERA5.

Per trajectory, ``frames`` 6-hour steps on the lat-lon grid with poles:

  * the state: the configuration's surface variables, then each
    atmospheric variable at every pressure level; channel c is
    ``mean_c + std_c * sum_k a_ck P_k(lat) cos(m_k (lon - v_k t) + p_ck)``
    over 16 smooth modes (P_k = cos(lat)^m_k times a polynomial in
    sin(lat), so every mode is smooth at the poles), drifting zonally at
    speeds of a few degrees an hour, with means and spreads of the
    variable's kind;
  * the forcings: the top-of-atmosphere solar radiation of a point-sun
    model (declination from the year's progress, hour angle from the local
    time), the year's progress (sine, cosine) and the local day's progress
    (sine, cosine);
  * the static fields: a smooth surface geopotential and a land-sea mask
    in [0, 1].

The statistics in ``metadata.json`` are fixed by the data: the state's and
the 6-hour residual's mean and standard deviation per channel over the
training split, the forcings' (the progress sines and cosines at mean 0
and standard deviation 1/sqrt(2), as over whole years) and the static
fields'. ``prepare`` writes the splits once into a directory named by the
spec (``harness.data_cache_dir``) and reads them back.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from h100_bench.reference.graphcast import lat_lon_grid

SURFACE = ["2m_temperature", "10m_u_component_of_wind", "10m_v_component_of_wind", "mean_sea_level_pressure",
           "total_precipitation_6hr"]
ATMOSPHERIC = ["temperature", "geopotential", "u_component_of_wind", "v_component_of_wind", "vertical_velocity",
               "specific_humidity"]
LEVELS = [50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000]
FORCINGS = ["toa_incident_solar_radiation", "year_progress_sin", "year_progress_cos", "day_progress_sin",
            "day_progress_cos"]
STATIC = ["geopotential_at_surface", "land_sea_mask"]
MODES = 16
STEP_HOURS = 6
# (mean, standard deviation) of each variable's kind
SCALES = {"2m_temperature": (288.0, 15.0), "10m_u_component_of_wind": (0.0, 6.0),
          "10m_v_component_of_wind": (0.0, 5.0), "mean_sea_level_pressure": (101325.0, 1100.0),
          "total_precipitation_6hr": (0.0006, 0.0015), "temperature": (240.0, 20.0), "geopotential": (5.0e4, 3.0e3),
          "u_component_of_wind": (8.0, 12.0), "v_component_of_wind": (0.0, 8.0), "vertical_velocity": (0.0, 0.2),
          "specific_humidity": (0.004, 0.004)}


def _modes(rng: np.random.Generator, lat: np.ndarray):
    """Per mode: P_k on the grid [K, N], its zonal wavenumber and drift (rad per step)."""
    s, c = np.sin(np.deg2rad(lat)), np.cos(np.deg2rad(lat))
    m = rng.integers(0, 5, size=MODES)
    deg = rng.integers(0, 4, size=MODES)
    p = np.stack([c ** m[k] * np.polynomial.legendre.legval(s, np.eye(4)[deg[k]]) for k in range(MODES)])
    drift = np.deg2rad(rng.uniform(-3.0, 6.0, size=MODES)) * STEP_HOURS
    return p, m, drift


def _smooth(rng: np.random.Generator, lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    p, m, _ = _modes(rng, lat)
    a = rng.normal(size=MODES) / np.sqrt(MODES)
    ph = rng.uniform(0, 2 * np.pi, size=MODES)
    return (a[:, None] * p * np.cos(m[:, None] * np.deg2rad(lon)[None] + ph[:, None])).sum(axis=0)


def _channels(spec: dict) -> List[Tuple[str, float, float]]:
    """(variable, mean, std) of every state channel."""
    out = [(v, *SCALES[v]) for v in spec.get("surface_variables", SURFACE)]
    levels = spec.get("levels", LEVELS)
    for v in spec.get("atmospheric_variables", ATMOSPHERIC):
        mean, std = SCALES[v]
        out += [(v, mean * (0.6 + 0.4 * i / max(1, len(levels) - 1)), std * (1.0 + 0.05 * i))
                for i in range(len(levels))]
    return out


def _forcings(lat: np.ndarray, lon: np.ndarray, hours: np.ndarray, day0: float) -> np.ndarray:
    """f32[T, N, 5] in ``FORCINGS`` order."""
    days = day0 + hours / 24.0
    year = (days / 365.25) % 1.0  # [T]
    local = (hours[:, None] / 24.0 + lon[None] / 360.0) % 1.0  # [T, N]
    decl = np.deg2rad(23.44) * np.sin(2 * np.pi * (year - 0.22))
    phi = np.deg2rad(lat)[None]
    cosz = np.sin(phi) * np.sin(decl)[:, None] + np.cos(phi) * np.cos(decl)[:, None] * np.cos(2 * np.pi * local - np.pi)
    toa = 1361.0 * np.maximum(cosz, 0.0)
    ones = np.ones_like(local)
    return np.stack([toa, np.sin(2 * np.pi * year)[:, None] * ones, np.cos(2 * np.pi * year)[:, None] * ones,
                     np.sin(2 * np.pi * local), np.cos(2 * np.pi * local)], axis=-1).astype(np.float32)


def make_trajectory(spec: dict, index: int) -> Dict[str, np.ndarray]:
    """Trajectory ``index`` of the spec: ``state [T, N, C]``, ``forcings
    [T, N, 5]``, ``static [N, 2]`` (f32)."""
    rng = np.random.default_rng([int(spec["data_seed"]), index])
    lat, lon = lat_lon_grid(float(spec["resolution_deg"]))
    frames = int(spec["frames"])
    chans = _channels(spec)
    p, m, drift = _modes(rng, lat)
    lam = np.deg2rad(lon)
    basis = np.concatenate([p * np.cos(m[:, None] * lam[None]), p * np.sin(m[:, None] * lam[None])])  # [2K, N]
    amp = rng.uniform(0.3, 1.0, size=(len(chans), MODES)) / np.sqrt(MODES)
    phase = rng.uniform(0, 2 * np.pi, size=(len(chans), MODES))
    t = np.arange(frames)[:, None, None]
    b = m[None, None] * drift[None, None] * t - phase[None]  # [T, C, K]: cos(m lon - b) = cos m lon cos b + sin m lon sin b
    coef = np.concatenate([amp * np.cos(b), amp * np.sin(b)], axis=-1)  # [T, C, 2K]
    field = coef.reshape(-1, 2 * MODES) @ basis  # [T * C, N]
    mean = np.array([c[1] for c in chans])[None, :, None]
    std = np.array([c[2] for c in chans])[None, :, None]
    state = (mean + std * field.reshape(frames, len(chans), -1)).transpose(0, 2, 1).astype(np.float32)
    hours = np.arange(frames) * float(STEP_HOURS)
    forcings = _forcings(lat, lon, hours, day0=float(rng.uniform(0, 365)))
    static = np.stack([2000.0 * np.maximum(_smooth(rng, lat, lon), 0.0),
                       1.0 / (1.0 + np.exp(-6.0 * _smooth(rng, lat, lon)))], axis=-1).astype(np.float32)
    return {"state": state, "forcings": forcings, "static": static}


def make_dataset(spec: dict) -> Tuple[Dict[str, Dict[str, dict]], dict]:
    """The splits (``splits``: trajectories per split, default one training
    trajectory) and the metadata with the training split's statistics."""
    counts = spec.get("splits", {"train": 1})
    splits, index = {}, 0
    for name, n in counts.items():
        splits[name] = {}
        for i in range(int(n)):
            splits[name][f"case-{i:03d}"] = make_trajectory(spec, index)
            index += 1
    train = list(splits["train"].values())
    state = np.concatenate([t["state"].reshape(-1, t["state"].shape[-1]) for t in train]).astype(np.float64)
    diff = np.concatenate([(t["state"][1:] - t["state"][:-1]).reshape(-1, t["state"].shape[-1]) for t in train])
    forcing = np.concatenate([t["forcings"].reshape(-1, t["forcings"].shape[-1]) for t in train]).astype(np.float64)
    static = np.concatenate([t["static"] for t in train]).astype(np.float64)
    f_mean, f_std = forcing.mean(axis=0), forcing.std(axis=0)
    f_mean[1:], f_std[1:] = 0.0, 1.0 / np.sqrt(2.0)  # the progress sines and cosines, as over whole years
    lat, lon = lat_lon_grid(float(spec["resolution_deg"]))
    levels = spec.get("levels", LEVELS)
    metadata = {
        "family": "graphcast", "resolution_deg": float(spec["resolution_deg"]),
        "lat": int(round(180.0 / float(spec["resolution_deg"]))) + 1,
        "lon": int(round(360.0 / float(spec["resolution_deg"]))), "step_hours": STEP_HOURS,
        "surface_variables": list(spec.get("surface_variables", SURFACE)),
        "atmospheric_variables": list(spec.get("atmospheric_variables", ATMOSPHERIC)), "levels": list(levels),
        "forcing_variables": FORCINGS, "static_variables": STATIC,
        "state_mean": state.mean(axis=0).tolist(), "state_std": state.std(axis=0).tolist(),
        "diff_mean": diff.astype(np.float64).mean(axis=0).tolist(),
        "diff_std": diff.astype(np.float64).std(axis=0).tolist(),
        "forcing_mean": f_mean.tolist(), "forcing_std": f_std.tolist(),
        "static_mean": static.mean(axis=0).tolist(), "static_std": static.std(axis=0).tolist(),
    }
    assert len(lat) == metadata["lat"] * metadata["lon"] == len(lon)
    return splits, metadata


def prepare(spec: dict, directory: Path) -> Tuple[Dict[str, Dict[str, dict]], dict]:
    """The dataset of ``spec`` in ``directory``: made and written on the
    first call (one ``<split>.npz`` per split, ``metadata.json``), read
    back on later ones."""
    done = directory / "complete"
    if not done.exists():
        splits, metadata = make_dataset(spec)
        tmp = directory.with_name(f"{directory.name}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        for name, trajs in splits.items():
            np.savez(tmp / f"{name}.npz", trajectories=trajs)
        with open(tmp / "metadata.json", "w") as f:
            json.dump(metadata, f)
        (tmp / "complete").write_text("ok\n")
        if directory.exists():
            shutil.rmtree(directory)
        os.replace(tmp, directory)
    with open(directory / "metadata.json") as f:
        metadata = json.load(f)
    splits = {}
    for path in sorted(directory.glob("*.npz")):
        with np.load(path, allow_pickle=True) as z:
            splits[path.stem] = z["trajectories"].item()
    return splits, metadata
