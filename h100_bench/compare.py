"""The numbers that decide ``correct``, and the count of valid edges.

Training: the gap of the first step's loss, relative to the reference's;
the gap between the program's and the reference's norms of the first
gradient, leaf by leaf, against the larger of the reference's norm of that
leaf and of the median leaf, the worst leaf counting; and the same gap of
the parameters' change after the checked steps, the median leaf counting.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out (their change under Adam is round-off). The second step, the
first that replays the captured step, is held teacher-forced: its loss and
its gradient (from Adam's first moments) against the reference's second
step from the program's own parameters after the first, by the same
measures (``loss2_gap``, ``grad2_gap``). The later steps'
losses and the worst leaf's change are reported and not compared: Adam's
normalised step turns the round-off of gradient entries near zero into
whole steps of the learning rate, so they swing from seed to seed.

Serving: at every step of a sampled request, the reference's next
positions and strains from the program's own window (the request's first
frames, then the program's predictions); the widest strain gap relative to
the reference strains' root mean square, and the widest position gap in
units of the float32 spacing at the larger of the reference's coordinate
and the window's last one.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


class CheckFailed(Exception):
    """The program's output cannot be compared (a malformed answer)."""


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _grad_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> tuple:
    """The worst leaf's gap of gradient norms, and the leaves it kept."""
    g_want, g_got = _norms(want), _norms(got)
    med_g = float(np.median(list(g_want.values())))
    kept = [k for k, v in g_want.items() if v >= EXCLUDE_BELOW * med_g]
    return max(abs(g_got[k] - g_want[k]) / max(g_want[k], med_g) for k in kept), kept


def training_gaps(got: dict, want: dict, initial: Dict[str, torch.Tensor], teacher: dict) -> Dict[str, float]:
    """The compared numbers of a training cell, and two more that are
    reported beside them and not compared (``*_all_steps``, ``*_worst``):
    the gap of every step's loss and the worst leaf's change, which Adam's
    later steps make swing (see PERF.md). ``teacher``: the reference's
    second step from ``got``'s parameters after the first."""
    inf = float("inf")
    if len(got["losses"]) != len(want["losses"]) or not all(np.isfinite(got["losses"])):
        return {"loss1_gap": inf, "grad1_gap": inf, "change_median_gap": inf, "loss2_gap": inf, "grad2_gap": inf}
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    grad_gap, kept = _grad_gap(got["grad1"], want["grad1"])
    grad2_gap, _ = _grad_gap(got["grad2"], teacher["grad"])
    d_want = _norms({k: want["params"][k] - initial[k] for k in kept})
    d_got = _norms({k: got["params"][k] - initial[k] for k in kept})
    med_d = float(np.median(list(d_want.values())))
    change = [abs(d_got[k] - d_want[k]) / max(d_want[k], med_d) for k in kept]
    return {"loss1_gap": losses[0], "grad1_gap": grad_gap, "change_median_gap": float(np.median(change)),
            "loss2_gap": abs(got["losses"][1] - teacher["loss"]) / abs(teacher["loss"]), "grad2_gap": grad2_gap,
            "loss_gap_all_steps": max(losses), "change_gap_worst": max(change),
            "leaves_left_out": float(len(want["grad1"]) - len(kept))}


def serving_gaps(pairs: List[dict]) -> Dict[str, float]:
    """``pairs``: per request the program's and the reference's positions
    [T, n, dim] and strains [T, n] (numpy)."""
    strain_gap, pos_gap = 0.0, 0.0
    for p in pairs:
        ref_s = p["ref_strain"].astype(np.float64)
        got_s = p["strain"].astype(np.float64)
        if not (np.isfinite(got_s).all() and np.isfinite(p["pos"]).all()):
            return {"strain_gap": float("inf"), "pos_gap_ulp": float("inf")}
        rms = float(np.sqrt(np.mean(ref_s ** 2)))
        strain_gap = max(strain_gap, float(np.abs(got_s - ref_s).max()) / rms)
        ref_p = p["ref_pos"].astype(np.float32)
        # the spacing at the larger of the coordinate and the window's last one
        # (the sum last + (velocity + acceleration) rounds at that scale)
        scale = np.maximum(np.abs(ref_p), np.abs(p["last"]).astype(np.float32))
        ulp = np.spacing(scale).astype(np.float64)
        pos_gap = max(pos_gap, float((np.abs(p["pos"].astype(np.float64) - ref_p.astype(np.float64)) / ulp).max()))
    return {"strain_gap": strain_gap, "pos_gap_ulp": pos_gap}


def valid_edges(frame: np.ndarray, radius: float, slots: int) -> int:
    """Edges of the radius graph of one frame of real particles (self loops
    included, at most ``slots`` per receiver)."""
    from scipy.spatial import cKDTree

    deg = cKDTree(frame).query_ball_point(frame, radius, return_length=True)
    return int(np.minimum(deg, slots).sum())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(name in numbers and numbers[name] <= lim for name, lim in limits.items())
