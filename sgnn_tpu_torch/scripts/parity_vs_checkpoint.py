"""Reference-checkpoint parity driver for the port: a reference .pt/.npz
state_dict -> the port's per-stage activations and their diffs.

The port's counterpart of ``scripts/parity_vs_checkpoint.py``: the same
CLI, stages and exit rule, running ``sgnn_tpu_torch`` on the card (or the
CPU with ``--device cpu``). The checkpoint loads straight into the port's
``LearnedSimulator`` / ``MultiScaleSimulator`` (``strict=True``: the port
uses the reference key layout, ``utils/torch_import.py``)::

  python -m sgnn_tpu_torch.scripts.parity_vs_checkpoint \\
      --checkpoint model-best-020000.pt --input case0.npz \\
      [--family auto] [--metadata metadata.json] [--tol 2e-4] [--device cpu]

Input npz:
  position_sequence  f32[N, S, dim]   required
  particle_types     int[N]           optional (default zeros)
  vel_mean/vel_std/acc_mean/acc_std   optional (else --metadata, else
                                      identity stats)
  expect/<stage>     f32[...]         optional reference activations;
                                      any stage present is diffed and
                                      counted toward pass/fail

Stages (node-indexed, so edge order cannot make false mismatches):
  single-scale: node_feat, node_enc, block{i}/x, output, next_positions
  multi-scale:  node_feat, node_enc, g2m/x, m2m{i}/x, m2g/x, output,
                next_positions

Exit code 0 iff every provided expect/ stage is within --tol max-abs diff.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from sgnn_tpu_torch.models.encode_process_decode import interaction_network_apply, mlp_ln_apply
from sgnn_tpu_torch.models.multi_scale import _encode_edges, _interact, flatten_ms_graph
from sgnn_tpu_torch.physics.multi_scale_graph import PaddedEdges, StaticGraph, build_static_graph
from sgnn_tpu_torch.physics.multi_scale_simulator import graph_to, ms_encoder_preprocess
from sgnn_tpu_torch.physics.simulator import NormStats, decoder_postprocess, encoder_preprocess
from sgnn_tpu_torch.utils.device import resolve_device
from sgnn_tpu_torch.utils.torch_import import (
    detect_family,
    load_torch_checkpoint,
    multi_scale_config,
    simulator_from_state_dict,
    single_scale_config,
)


def load_stats(inp: dict, metadata_path, dim: int, noise_std: float, device) -> NormStats:
    vals = {k: (np.asarray(inp[k], np.float32) if k in inp else None)
            for k in ("vel_mean", "vel_std", "acc_mean", "acc_std")}
    if metadata_path:
        meta = json.loads(Path(metadata_path).read_text())
        for k in vals:
            if vals[k] is None and k in meta:
                vals[k] = np.asarray(meta[k], np.float32)
        # fold noise into the stds as the reference trainer does
        for k in ("vel_std", "acc_std"):
            if vals[k] is not None and noise_std > 0:
                vals[k] = np.sqrt(vals[k] ** 2 + noise_std**2)
    for k in vals:
        if vals[k] is None:
            vals[k] = np.zeros(dim, np.float32) if k.endswith("mean") else np.ones(dim, np.float32)
    return NormStats(**{k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in vals.items()})


def run_single(sd, seq, types, stats, args, device) -> dict:
    """Single-scale per-stage chain (the readable path; the flat path is
    held equal to it by the port's tests)."""
    n, s, dim = seq.shape
    cfg = single_scale_config(sd, input_sequence_length=s, connectivity_radius=args.radius,
                              max_neighbors=args.max_neighbors, wall_x=args.wall_x)
    sim, cfg = simulator_from_state_dict(sd, device, cfg)
    node_f, edge_f, nl = encoder_preprocess(sim, cfg, stats, seq, types)
    stages = {"node_feat": node_f}
    epd = sim._encode_process_decode
    x = mlp_ln_apply(epd._encoder.node_fn, node_f)
    e = mlp_ln_apply(epd._encoder.edge_fn, edge_f) * nl.mask[..., None].to(x.dtype)
    stages["node_enc"] = x
    for i, block in enumerate(epd._processor.gnn_stacks):
        x, e = interaction_network_apply(block, x, e, nl)
        stages[f"block{i}/x"] = x
    out = epd._decoder.node_fn(x)
    stages["output"] = out
    stages["next_positions"] = decoder_postprocess(stats, out[:, :dim], seq)
    return stages


def run_multi(sd, seq, types, stats, args, device) -> dict:
    """Multi-scale per-stage chain (COO, flattened as a batch of one)."""
    n, s, dim = seq.shape
    cfg = multi_scale_config(sd, input_sequence_length=s, num_scales=args.num_scales, window_size=args.window_size,
                             radius_multiplier=args.radius_multiplier, wall_x=args.wall_x)
    sim, cfg = simulator_from_state_dict(sd, device, cfg)
    pos0 = seq[:, 0].detach().cpu().numpy().astype(np.float64)
    graph = build_static_graph(cfg.graph_config, pos0, g2m_pad=args.edge_pad, m2m_pad=args.edge_pad,
                               m2g_pad=args.edge_pad)
    graph = graph_to(graph, device)
    graph = flatten_ms_graph(StaticGraph(*(PaddedEdges(*(a[None] for a in e)) for e in graph)), n)
    node_f, edge_f = ms_encoder_preprocess(sim, cfg, stats, seq, types, graph)
    gnn = sim._multi_scale_gnn
    stages = {"node_feat": node_f}
    x = mlp_ln_apply(gnn.grid_node_encoder, node_f)
    stages["node_enc"] = x
    e = {t: _encode_edges(gnn, f"{t}_edge_encoder", edge_f[t], getattr(graph, t).mask, None)
         for t in ("g2m", "m2m", "m2g")}
    s_g2m, s_m2m, s_m2g = (pe.senders.index_select(0, pe.order) for pe in graph)
    x, _ = _interact(gnn.g2m_block, x, e["g2m"], graph.g2m, s_g2m)
    stages["g2m/x"] = x
    for i, block in enumerate(gnn.m2m_blocks):
        x, e["m2m"] = _interact(block, x, e["m2m"], graph.m2m, s_m2m)
        stages[f"m2m{i}/x"] = x
    x, _ = _interact(gnn.m2g_block, x, e["m2g"], graph.m2g, s_m2g)
    stages["m2g/x"] = x
    out = gnn.prediction_head(x)
    stages["output"] = out
    stages["next_positions"] = decoder_postprocess(stats, out[:, :dim], seq)
    return stages


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True, help=".pt or .npz state_dict")
    ap.add_argument("--input", required=True, help="input npz (see module doc)")
    ap.add_argument("--family", default="auto", choices=["auto", "single", "multi"])
    ap.add_argument("--metadata", default=None, help="metadata.json for stats")
    ap.add_argument("--noise-std", type=float, default=0.0,
                    help="fold into metadata stds like the reference trainer")
    ap.add_argument("--tol", type=float, default=2e-4, help="max-abs tolerance per provided expect/ stage")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    # single-scale graph knobs (reference config.yaml defaults)
    ap.add_argument("--radius", type=float, default=0.6)
    ap.add_argument("--max-neighbors", type=int, default=20)
    ap.add_argument("--wall-x", type=float, default=-2.0, dest="wall_x")
    # multi-scale hierarchy knobs (multi_scale_config.yaml defaults)
    ap.add_argument("--num-scales", type=int, default=2, dest="num_scales")
    ap.add_argument("--window-size", type=int, default=2, dest="window_size")
    ap.add_argument("--radius-multiplier", type=float, default=2.0, dest="radius_multiplier")
    ap.add_argument("--edge-pad", type=int, default=1 << 17, dest="edge_pad")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sd = load_torch_checkpoint(args.checkpoint)
    family = detect_family(sd) if args.family == "auto" else args.family
    print(f"family: {family}  checkpoint keys: {len(sd)}  device: {device}")

    with np.load(args.input) as d:
        inp = {k: d[k] for k in d.files}
    raw = inp.get("position_sequence", inp.get("positions"))
    if raw is None:
        raise SystemExit("input npz needs position_sequence [N, S, dim]")
    seq = torch.as_tensor(raw, dtype=torch.float32, device=device)
    n, s, dim = seq.shape
    types = torch.as_tensor(inp.get("particle_types", np.zeros(n, np.int64)), device=device).long()
    stats = load_stats(inp, args.metadata, dim, args.noise_std, device)
    print(f"input: N={n} S={s} dim={dim}")

    runner = run_single if family == "single" else run_multi
    with torch.no_grad():
        stages = runner(sd, seq, types, stats, args, device)

    failures = checked = 0
    for name, val in stages.items():
        val = val.detach().cpu().numpy()
        line = f"  {name:<16s} shape={str(val.shape):<14s} |x|max={np.abs(val).max():.4e}"
        key = f"expect/{name}"
        if key in inp:
            diff = float(np.abs(val - inp[key]).max())
            ok = diff <= args.tol
            checked += 1
            failures += 0 if ok else 1
            line += f"  max-abs-diff={diff:.3e} {'OK' if ok else 'FAIL'}"
        print(line)
    if checked:
        print(f"{checked - failures}/{checked} provided stages within tol={args.tol}")
    else:
        print("no expect/ stages in input npz — stats printed only")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
