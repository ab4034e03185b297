"""Rollout visualization: side-by-side ground-truth vs prediction GIF.

The port's own copy of ``sgnn_tpu/viz/render_rollout.py``; matplotlib is
imported inside the functions that draw, so importing this module needs
none.

Functional counterpart of the reference renderer
(sgnn/render_rollout.py:69-412): loads a rollout pickle, draws a
two-panel scatter animation (LS-DYNA/ground truth left, GNN prediction
right) colored by denormalized von Mises stress, marks the rigid wall at
x=-2, overlays per-frame RMSE, writes a GIF (pillow writer), and
supports batch mode over a folder of pickles.

CLI:
  python -m sgnn_tpu_torch.viz.render_rollout --rollout_path X.pkl --output_path X.gif
  python -m sgnn_tpu_torch.viz.render_rollout --rollout_path dir/ --output_path outdir/ --batch_mode
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

WALL_X = -2.0
DEFAULT_STRESS_MEAN = 150.25897834554806  # dataset stats (render_rollout.py:55)
DEFAULT_STRESS_STD = 83.50737010164767


def _stress_stats(rollout: dict) -> tuple[float, float]:
    md = rollout.get("metadata", {}) or {}
    mean = md.get("stress_mean", DEFAULT_STRESS_MEAN)
    std = md.get("stress_std", DEFAULT_STRESS_STD)
    if mean is None or std is None:
        mean, std = DEFAULT_STRESS_MEAN, DEFAULT_STRESS_STD
    return float(mean), float(std)


def render_rollout_dict(
    rollout: dict,
    output_path: str | Path,
    *,
    step_stride: int = 1,
    fps: int = 5,
    dpi: int = 100,
) -> Path:
    """Render one rollout dict (the trainer's pickle schema) to a GIF."""
    gt = np.asarray(rollout["ground_truth_rollout"])  # [T, N, 2]
    pred = np.asarray(rollout["predicted_rollout"])
    gt_strain = np.asarray(rollout["ground_truth_strain"])  # [T, N]
    pred_strain = np.asarray(rollout["predicted_strain"])
    rmse = np.asarray(rollout.get("rmse_position", np.zeros(len(gt))))
    mean, std = _stress_stats(rollout)

    # Restrict to real particles when a node mask survives in the pickle.
    types = np.asarray(rollout.get("particle_types", np.zeros(gt.shape[1])))
    n = gt.shape[1]

    gt_stress = gt_strain * std + mean
    pred_stress = pred_strain * std + mean
    vmin, vmax = float(gt_stress.min()), float(gt_stress.max()) or 1.0

    all_pos = np.concatenate([gt.reshape(-1, 2), pred.reshape(-1, 2)])
    pad = 2.0
    x_lo, y_lo = all_pos.min(0) - pad
    x_hi, y_hi = all_pos.max(0) + pad
    x_lo = min(x_lo, WALL_X - 1.0)

    frames = range(0, gt.shape[0], step_stride)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    scatters = []
    for ax, title in zip(axes, ["Ground truth (LS-DYNA)", "GNN prediction"]):
        ax.set_xlim(x_lo, x_hi)
        ax.set_ylim(y_lo, y_hi)
        ax.set_title(title)
        ax.set_aspect("equal")
        ax.axvline(x=WALL_X - 0.4, color="darkgray", linewidth=8, alpha=0.9)
        sc = ax.scatter([], [], s=4, c=[], cmap="viridis", vmin=vmin, vmax=vmax)
        scatters.append(sc)
    cbar = fig.colorbar(scatters[1], ax=axes, shrink=0.8)
    cbar.set_label("von Mises stress [MPa]")
    info = axes[1].text(
        0.02, 0.98, "", transform=axes[1].transAxes, va="top", fontsize=9
    )

    def update(t):
        scatters[0].set_offsets(gt[t, :n])
        scatters[0].set_array(gt_stress[t, :n])
        scatters[1].set_offsets(pred[t, :n])
        scatters[1].set_array(pred_stress[t, :n])
        info.set_text(f"step {t}  rmse={rmse[min(t, len(rmse)-1)]:.3e}")
        return (*scatters, info)

    anim = animation.FuncAnimation(fig, update, frames=list(frames), interval=1000 // fps)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    anim.save(str(output_path), writer=animation.PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return output_path


def render_rollout_file(
    rollout_path: str | Path, output_path: str | Path, **kwargs
) -> Path:
    with open(rollout_path, "rb") as f:
        rollout = pickle.load(f)
    return render_rollout_dict(rollout, output_path, **kwargs)


def main():
    p = argparse.ArgumentParser(description="Render rollout pickle(s) to GIF")
    p.add_argument("--rollout_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--step_stride", type=int, default=1)
    p.add_argument("--batch_mode", action="store_true")
    args = p.parse_args()

    if args.batch_mode:
        in_dir, out_dir = Path(args.rollout_path), Path(args.output_path)
        pkls = sorted(in_dir.glob("*.pkl"))
        if not pkls:
            raise SystemExit(f"no .pkl files in {in_dir}")
        for pkl in pkls:
            out = out_dir / (pkl.stem + ".gif")
            print(f"rendering {pkl.name} -> {out}")
            render_rollout_file(pkl, out, step_stride=args.step_stride)
    else:
        out = render_rollout_file(
            args.rollout_path, args.output_path, step_stride=args.step_stride
        )
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
