"""Gridded fields for the GraphCast family: the split files, the training
batcher and the forecast loader.

A split file (``train.npz``, ``valid.npz``, ``test.npz`` under the data
path) holds ``{"trajectories": {name: {"state", "forcings", "static"}}}``:
``state f32[T, N, C]`` the predicted variables at 6-hour steps on the
grid's N nodes, ``forcings f32[T, N, F]`` the known inputs at the same
times, ``static f32[N, S]``. ``metadata.json`` beside it names the
variables and levels, the grid's size and the statistics
(``models/graphcast.field_stats``).

A training sample at time t of a trajectory is ``frames`` input states up
to t, the forcings of those times and of t + 1, the static fields, and
the state at t + 1 (``FieldBatcher``: every t with a full window and a
target, shuffled each pass). The forecast's items are whole trajectories
(``load_field_split``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

Fields = Dict[str, np.ndarray]


def load_field_split(path: str | Path) -> List[Tuple[str, Fields]]:
    """(name, fields) of every trajectory of a split file, by name."""
    with np.load(path, allow_pickle=True) as z:
        table = z["trajectories"].item()
    return [(k, {f: np.asarray(v[f], np.float32) for f in ("state", "forcings", "static")})
            for k, v in sorted(table.items())]


class FieldBatcher:
    """Shuffled training batches of gridded samples (numpy):
      state     f32[B, frames, N, C]   the input states, oldest first
      forcings  f32[B, frames + 1, N, F]
      static    f32[B, N, S]
      target    f32[B, N, C]           the state 6 hours after the last input
      traj_idx  i32[B], time i32[B]    the sample: trajectory and last input time
    """

    def __init__(self, path: str | Path, frames: int, batch_size: int, *, seed: int = 0):
        self.trajectories = [fields for _, fields in load_field_split(path)]
        if not self.trajectories:
            raise ValueError(f"No trajectories in {path}")
        self.frames, self.batch_size = frames, batch_size
        self._rng = np.random.default_rng(seed)
        self.num_nodes = self.trajectories[0]["state"].shape[1]
        self.samples = [(ti, t) for ti, tr in enumerate(self.trajectories)
                        for t in range(frames - 1, tr["state"].shape[0] - 1)]

    def __len__(self) -> int:
        return len(self.samples)

    def _gather(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        f = self.frames
        picked = [self.samples[i] for i in idxs]
        trs = [self.trajectories[ti] for ti, _ in picked]
        return {
            "state": np.stack([tr["state"][t - f + 1:t + 1] for tr, (_, t) in zip(trs, picked)]),
            "forcings": np.stack([tr["forcings"][t - f + 1:t + 2] for tr, (_, t) in zip(trs, picked)]),
            "static": np.stack([tr["static"] for tr in trs]),
            "target": np.stack([tr["state"][t + 1] for tr, (_, t) in zip(trs, picked)]),
            "traj_idx": np.asarray([ti for ti, _ in picked], np.int32),
            "time": np.asarray([t for _, t in picked], np.int32),
        }

    def _epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._rng.permutation(len(self.samples))
        bs = self.batch_size
        for i in range(0, len(order) - len(order) % bs, bs):
            yield self._gather(order[i:i + bs])

    def epochs(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite shuffled stream (reshuffles every pass)."""
        if len(self.samples) < self.batch_size:
            raise ValueError(f"{len(self.samples)} samples make no batch of {self.batch_size}")
        while True:
            yield from self._epoch()

    def __iter__(self):
        return self._epoch()
