"""Fixed-shape data loading: training batches and whole trajectories.

The port's own copy of ``sgnn_tpu/data/loader.py`` (``load_metadata``,
``load_trajectories``, ``SampleBatcher``, ``TrajectoryLoader``): every
graph is padded to a common node count (a multiple of ``pad_multiple``)
with a boolean node mask and batched on a leading axis. A training sample
at (trajectory, t) is the window positions[t-S:t] with positions[t] and
stresses[t] as targets. Plain numpy; the shuffle is a numpy
``default_rng(seed)``, so the same seed gives the JAX package's batches.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from sgnn_tpu_torch.physics.mesh_simulator import build_mesh, stack_meshes
from sgnn_tpu_torch.utils.profiling import trace_region

Trajectory = Tuple[np.ndarray, np.ndarray, np.ndarray]


def load_metadata(data_dir: str | Path) -> dict:
    with open(Path(data_dir) / "metadata.json") as f:
        return json.load(f)


def load_trajectories(path: str | Path) -> List[Trajectory]:
    """npz -> list of (positions [T,N,dim], types [N], stresses [T,N]),
    sorted by case name (span ``load.read``)."""
    with trace_region("load.read"), np.load(path, allow_pickle=True) as data:
        trajectories = data["trajectories"].item()
    out = []
    for name in sorted(trajectories):
        t = trajectories[name]
        if isinstance(t, tuple) and len(t) == 3:
            out.append(t)
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class SampleBatcher:
    """Shuffled fixed-shape training batches.

    Yields dicts of numpy arrays:
      positions  f32[B, Np, S, dim]
      particle_type i32[B, Np]
      node_mask  bool[B, Np]
      next_position f32[B, Np, dim]
      next_strain   f32[B, Np]
      traj_idx   i32[B]
    Padded node slots carry zeros and mask False.
    """

    def __init__(
        self,
        path: str | Path,
        input_sequence_length: int,
        batch_size: int,
        *,
        pad_multiple: int = 128,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        self.trajectories = load_trajectories(path)
        if not self.trajectories:
            raise ValueError(f"No trajectories in {path}")
        self.s = input_sequence_length
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        self.dim = self.trajectories[0][0].shape[-1]
        max_n = max(p.shape[1] for p, _, _ in self.trajectories)
        self.num_nodes = _round_up(max_n, pad_multiple)
        # flattened (trajectory, time) sample index
        self.samples: List[Tuple[int, int]] = [
            (ti, t) for ti, (pos, _, _) in enumerate(self.trajectories) for t in range(self.s, pos.shape[0])
        ]

    def __len__(self) -> int:
        return len(self.samples)

    def steps_per_epoch(self) -> int:
        n = len(self.samples) // self.batch_size
        if not self.drop_remainder and len(self.samples) % self.batch_size:
            n += 1
        return n

    def _gather(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        b = len(idxs)
        np_, s, dim = self.num_nodes, self.s, self.dim
        batch = {
            "positions": np.zeros((b, np_, s, dim), np.float32),
            "particle_type": np.zeros((b, np_), np.int32),
            "node_mask": np.zeros((b, np_), bool),
            "next_position": np.zeros((b, np_, dim), np.float32),
            "next_strain": np.zeros((b, np_), np.float32),
            "traj_idx": np.zeros((b,), np.int32),
        }
        for k, sample_i in enumerate(idxs):
            ti, t = self.samples[sample_i]
            batch["traj_idx"][k] = ti
            pos, types, stress = self.trajectories[ti]
            n = pos.shape[1]
            batch["positions"][k, :n] = np.transpose(pos[t - s : t], (1, 0, 2))
            batch["particle_type"][k, :n] = types
            batch["node_mask"][k, :n] = True
            batch["next_position"][k, :n] = pos[t]
            batch["next_strain"][k, :n] = stress[t]
        return batch

    def _epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._rng.permutation(len(self.samples))
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_remainder else 0)
        for i in range(0, end, bs):
            yield self._gather(order[i : i + bs])

    def epochs(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite shuffled stream (reshuffles every epoch)."""
        if self.steps_per_epoch() == 0:
            raise ValueError(f"{len(self.samples)} samples make no batch of {self.batch_size}")
        while True:
            yield from self._epoch()

    def __iter__(self):
        """One shuffled epoch."""
        return self._epoch()


class MeshSampleBatcher(SampleBatcher):
    """SampleBatcher that attaches each sample's trajectory mesh
    (``physics/mesh_simulator.build_mesh`` of its first frame, built once
    per trajectory), stacked over the batch (``batch["mesh"]``, a
    ``StaticMesh`` of [B, ...] arrays)."""

    def __init__(self, path: str | Path, input_sequence_length: int, batch_size: int, *, mesh_radius: float,
                 mesh_slots: int, pad_multiple: int = 128, seed: int = 0, drop_remainder: bool = True):
        super().__init__(path, input_sequence_length, batch_size, pad_multiple=pad_multiple, seed=seed,
                         drop_remainder=drop_remainder)
        self.meshes = [build_mesh(pos[0], mesh_radius, mesh_slots, self.num_nodes) for pos, _, _ in self.trajectories]

    def _gather(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        batch = super()._gather(idxs)
        batch["mesh"] = stack_meshes([self.meshes[self.samples[i][0]] for i in idxs])
        return batch


class TrajectoryLoader:
    """Whole trajectories padded to a common N.

    Yields dicts of numpy arrays:
      positions f32[Np, T, dim], particle_type i32[Np], node_mask bool[Np],
      strains f32[T, Np]
    (the padding of each: span ``load.pad``).
    """

    def __init__(self, path: str | Path, *, pad_multiple: int = 128):
        self.trajectories = load_trajectories(path)
        max_n = max((p.shape[1] for p, _, _ in self.trajectories), default=0)
        self.num_nodes = _round_up(max_n, pad_multiple)

    def __len__(self):
        return len(self.trajectories)

    def __iter__(self):
        for pos, types, stress in self.trajectories:
            with trace_region("load.pad"):
                t, n, dim = pos.shape
                np_ = self.num_nodes
                out = {
                    "positions": np.zeros((np_, t, dim), np.float32),
                    "particle_type": np.zeros((np_,), np.int32),
                    "node_mask": np.zeros((np_,), bool),
                    "strains": np.zeros((t, np_), np.float32),
                }
                out["positions"][:n] = np.transpose(pos, (1, 0, 2))
                out["particle_type"][:n] = types
                out["node_mask"][:n] = True
                out["strains"][:, :n] = stress
            yield out
