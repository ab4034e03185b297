"""Graph-connectivity audit (the reference's `debug_graph` facility).

The port's own copy of ``sgnn_tpu/utils/graph_debug.py``; it takes the
port's ``NeighborList`` (torch tensors, read back to numpy) or numpy arrays.
Counterpart of LearnedSimulator._test_graph_connectivity /
test_graph_connectivity_once (learned_simulator.py:126-229, 318-378):
per-node edge counts, isolated-node detection, degree statistics, and a
brute-force spot check that the emitted neighbor lists agree with true
within-radius counts. Enabled from the trainer via config
``debug_graph: true`` — runs host-side on numpy copies, so it costs
nothing when off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sgnn_tpu_torch.ops.neighbors import NeighborList


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def audit_neighbor_list(
    positions: np.ndarray,  # [N, dim]
    nl: NeighborList,
    radius: float,
    *,
    node_mask: Optional[np.ndarray] = None,
    num_spot_checks: int = 5,
    seed: int = 0,
    verbose: bool = True,
) -> dict:
    """Return (and optionally print) connectivity statistics.

    Keys: num_nodes, num_edges, degree_{min,max,mean,std}, isolated_nodes,
    spot_check_failures (nodes whose emitted degree != true within-radius
    count, ignoring cap saturation).
    """
    positions = _host(positions)
    mask = _host(nl.mask)
    if node_mask is None:
        node_mask = np.ones(len(positions), bool)
    node_mask = _host(node_mask).astype(bool)

    degrees = mask.sum(axis=1)[node_mask]
    n = int(node_mask.sum())
    e = int(degrees.sum())
    isolated = int((degrees == 0).sum())

    rng = np.random.default_rng(seed)
    idxs = rng.choice(np.where(node_mask)[0], size=min(num_spot_checks, n), replace=False)
    failures = []
    k = mask.shape[1]
    for i in idxs:
        d = np.linalg.norm(positions[node_mask] - positions[i], axis=-1)
        true_deg = int((d < radius).sum())  # includes self
        emitted = int(mask[i].sum())
        if emitted != min(true_deg, k):
            failures.append((int(i), emitted, true_deg))

    stats = {
        "num_nodes": n,
        "num_edges": e,
        "degree_min": int(degrees.min()) if n else 0,
        "degree_max": int(degrees.max()) if n else 0,
        "degree_mean": float(degrees.mean()) if n else 0.0,
        "degree_std": float(degrees.std()) if n else 0.0,
        "isolated_nodes": isolated,
        "spot_check_failures": failures,
        "cap_saturated_nodes": int((degrees == k).sum()),
    }
    if verbose:
        print(f"graph audit (radius={radius:.3f})")
        print(f"  nodes={n} edges={e} avg_degree={stats['degree_mean']:.2f}")
        print(
            f"  degree range [{stats['degree_min']}, {stats['degree_max']}] "
            f"std {stats['degree_std']:.2f}; cap-saturated {stats['cap_saturated_nodes']}"
        )
        if isolated:
            print(f"  WARNING: {isolated} isolated nodes")
        if failures:
            print(f"  WARNING: spot-check failures {failures}")
        else:
            print(f"  spot checks OK ({len(idxs)} nodes)")
    return stats
