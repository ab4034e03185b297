"""The training runner of the MeshGraphNets configuration (family
``meshgraphnet``): ``runners/train.Runner`` with that family's pieces.

  * set-up: the port's single-scale trainer builds the architecture its
    config names (``architecture: meshgraphnet``), so set-up takes
    ``sgnn_tpu_torch.train.train.build_training``; the feed, the step and
    the checked steps are the base runner's;
  * the reference is ``reference/mesh_graph_net.py``; its graph per sample
    is the trajectory's mesh (its first frame) and the world edges of the
    sample's noisy last position, built there by brute force;
  * the operation count is the MeshGraphNets forward's on real nodes, mesh
    edges and the world edges of the clean last frame of each sample's
    window (``mgn_forward_flops``);
  * with a tracer, ``world_fill`` is the share of the world slots that held
    a valid edge over the traced steps, from the port's device-side counter
    (``MeshSimulator.world_edge_count``, read before and after the traced
    steps; ``metrics/world_slot_fill.train.py``). A port without that
    counter leaves it None.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from h100_bench import yardstick
from h100_bench.reference import mesh_graph_net as ref_mgn
from h100_bench.runners import train


def mgn_forward_flops(mc: dict, nodes: int, mesh_edges: int, world_edges: int) -> int:
    """Matrix-product operations of one MeshGraphNets forward over
    ``nodes`` real nodes and the valid edges of each set: every edge MLP's
    first Linear in split form (sender and receiver projections once per
    node, the edge latent's block once per edge)."""
    d, hid, dim = mc["latent"], mc["mlp_hidden_layers"], mc["dim"]
    node_in = (mc["seq_len"] - 1) * dim + 1
    f = (yardstick.mlp_flops(nodes, [node_in] + [d] * hid + [d])
         + yardstick.mlp_flops(mesh_edges, [2 * (dim + 1)] + [d] * hid + [d])
         + yardstick.mlp_flops(world_edges, [dim + 1] + [d] * hid + [d]))
    per_block = yardstick.mlp_flops(nodes, [3 * d] + [d] * hid + [d])
    for e in (mesh_edges, world_edges):
        per_block += 2 * 2 * nodes * d * d + 2 * e * d * d + yardstick.mlp_flops(e, [d] * hid + [d])
    return f + mc["layers"] * per_block + yardstick.mlp_flops(nodes, [d] + [d] * hid + [dim + 1])


class _CountingTracer:
    """The run's tracer, with the port's world edge counter read before its
    start and after its stop (both outside the profile)."""

    def __init__(self, tracer, runner: "Runner"):
        self.tracer, self.runner, self.before = tracer, runner, None

    def _count(self) -> Optional[list]:
        counter = getattr(self.runner.built.sim, "world_edge_count", None)
        return None if counter is None else counter.tolist()

    def start(self) -> None:
        self.before = self._count()
        self.tracer.start()

    def stop(self) -> None:
        self.tracer.stop()
        after = self._count()
        if self.before is not None and after is not None and after[1] > self.before[1]:
            self.runner.world_fill = 100.0 * (after[0] - self.before[0]) / (after[1] - self.before[1])


class Runner(train.Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        tc = self.config["train_config"]
        # two hidden layers per MLP: MeshGraphNets' (the port's trainer fixes it for the architecture)
        self.mc.update(mlp_hidden_layers=2, mesh_radius=tc["mesh_radius"],
                       world_radius=tc["world_radius"], world_search_slots=tc["world_search_slots"],
                       world_slots=tc["world_slots"])
        self.ref = ref_mgn
        self.world_fill: Optional[float] = None

    def setup(self) -> None:
        # the base runner picks the trainer by family: this one is the single-scale trainer's
        self.family = "single_scale"
        try:
            super().setup()
        finally:
            self.family = self.config["family"]

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        return super().window(seconds, None if tracer is None else _CountingTracer(tracer, self))

    # -- the reference's graph --------------------------------------------------

    def _mesh(self, ti: int) -> Tuple[np.ndarray, np.ndarray]:
        cache = self.__dict__.setdefault("_mesh_cache", {})
        if ti not in cache:
            cache[ti] = ref_mgn.mesh_graph(self.trajs[ti][0][0], self.mc["mesh_radius"])
        return cache[ti]

    def _graph(self, windows, rows):
        dev = self.ctx.device
        parts = {"ms": [], "mr": [], "ws": [], "wr": [], "rest": []}
        off = 0
        for w, (ti, _) in zip(windows, rows):
            mesh = self._mesh(ti)
            ws, wr = ref_mgn.world_graph(w[:, -1], mesh, self.mc)
            parts["ms"].append(torch.as_tensor(mesh[0], device=dev) + off)
            parts["mr"].append(torch.as_tensor(mesh[1], device=dev) + off)
            parts["ws"].append(ws + off)
            parts["wr"].append(wr + off)
            parts["rest"].append(torch.from_numpy(self.trajs[ti][0][0]).to(dev))
            off += w.shape[0]
        cat = {k: torch.cat(v) for k, v in parts.items()}
        return {"mesh": (cat["ms"], cat["mr"]), "world": (cat["ws"], cat["wr"]), "rest": cat["rest"]}

    # -- the operation count ----------------------------------------------------

    def _forward_flops(self, sample) -> float:
        ti, t = sample
        n = self.trajs[ti][0].shape[1]
        mesh_edges, world_edges = self._edge_counts(ti, t - 1)
        return mgn_forward_flops(self.mc, n, mesh_edges, world_edges)

    def _edge_counts(self, ti: int, frame: int) -> Tuple[int, int]:
        """Mesh edges and world edges (at most ``world_slots`` per receiver)
        of a clean frame."""
        from scipy.spatial import cKDTree

        cache = self.__dict__.setdefault("_edge_count_cache", {})
        if (ti, frame) not in cache:
            pos = self.trajs[ti][0]
            n = pos.shape[1]
            snd, rcv = self._mesh(ti)
            pairs = cKDTree(pos[frame]).query_pairs(self.mc["world_radius"], output_type="ndarray")
            both = np.concatenate([pairs, pairs[:, ::-1]])
            world = both[~np.isin(both[:, 0] * n + both[:, 1], rcv * n + snd)]
            deg = np.bincount(world[:, 0], minlength=n)
            cache[(ti, frame)] = (len(snd), int(np.minimum(deg, self.mc["world_slots"]).sum()))
        return cache[(ti, frame)]
