#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (sgnn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (/usr/local/cuda); exits non-zero, printing
no result, without them or without the repository beside it. Phases,
each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of the port, from ``sgnn_tpu_torch/csrc``, one
     nvcc per source, all started together;
  3. kernels: the edge-block forward and backward against their plain
     PyTorch versions on the card, at the listed shapes and at the
     training shapes of A (f32) and B (bf16); the backward twice on the
     same inputs, bit for bit; then each kernel and its plain version
     timed with CUDA events at the shapes of the paths below, and
     ``index_select`` (the library call of the gather probes) at the
     probes' shape;
  4. dataset: a synthetic Taylor-impact dataset at the reference's raw
     scale (120 x 40 particles, 152 frames) built by the port's builder;
  5. training: ``train`` on the card for 20 steps with the values of
     configs/taylor2d_single_scale.yaml (A: f32, batch 32, explicit
     domain) and configs/taylor2d_demo_bf16.yaml (B: bf16, batch 16,
     domain from metadata, symmetric gather by the auto-rule), 5 layers,
     hidden 64, r = 0.6, window 11. Each run counts the kernels' launches
     and the symmetric gather's backward passes, reads its metrics and
     checkpoint, and is profiled over 3 steps. Then A's loss on one fixed
     batch must fall over 10 steps; one step of each of A and B at full
     width on 2 samples must match the same step on the CPU through the
     plain versions (loss, every gradient, the parameters after Adam);
     and on B's graph sym_gather's backward must match index_select's;
  6. rollout: ``predict`` in rollout mode from the checkpoint each
     training run wrote (A in f32, B in bf16), counting the forward
     kernel's launches; the f32 run's first steps are held against the
     same rollout on the CPU, and a warm rollout is profiled.

The last lines are the kernel summary (JSON), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# kernel checks: (R, K, D=H); the first is the rollout shape
SHAPES = [(4864, 8, 64), (4797, 8, 64), (64, 20, 64), (512, 4, 16)]
# forward. f32: the tolerance of tests/test_pallas_edge_block.py (sums of
# 64 products taken in another order). bf16: the outputs carry 8
# significant bits, so an f32 sum in another order can flip the rounding
# of an output (2^-7 relative) or of a message |msg| < 8 (up to 2^-5) that
# then enters agg.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-4, 2.0**-7)}  # (atol, rtol)
# backward, g_e / g_xj / g_proj_i. f32: sums of 64 products and the
# LayerNorm means in another order. bf16: as the forward; a flipped bf16
# rounding of relu(h) also moves one row's g_o.
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0**-4, 2.0**-7)}
# backward, weight gradients: sums over all R*K edges (up to 1.25 M at the
# training shapes), so the error of summing in another order scales with
# the sum of the absolute terms, not with the result:
# |err| <= rtol * sum|terms| + 1e-6. Measured on the H100 at the listed
# shapes: f32 at most 1.34e-7 of sum|terms|, bf16 at most 1.54e-7 (the
# flipped roundings of relu(h) add little). Both limits leave ~100x above
# that for the longer sums of the training shapes, and lie far below the
# error of a dropped block partial (about 1/grid of sum|terms|, grid at
# most a few blocks per SM).
SUM_RTOL = {"float32": 2e-5, "bfloat16": 1e-5}
# f32 rollout on the card vs on the CPU, first steps: sums in another order
# through 5 layers, positions of |x| < 64 carry an f32 ulp of 7.6e-6.
ROLLOUT_TOL = (1e-4, 1e-4)
ROLLOUT_CHECK_STEPS = 3
# one training step on the card vs on the CPU at full width. A (f32): sums
# in another order through 5 layers and their backward (and index_select's
# backward adds with atomics on the card), ReLU gates whose h lies within
# rounding of 0 may differ. Loss and metrics to 1e-4 relative; each
# gradient to 1e-3 of its tensor's largest entry plus 1e-3 relative.
# Adam's first step moves an entry by lr * g / (|g| + eps), which two
# gradients g1, g2 of one sign move apart by at most
# lr * |g1 - g2| / max(|g1|, |g2|), and of opposite signs (entries within
# the gradient tolerance of 0) by up to 2 lr: the parameters after the
# step must agree to that, plus the f32 rounding of the parameter
# (2^-22 |p|) and of the update (1e-5 lr) and 1e-7.
# B (bf16 edge tensors, symmetric gather): where the two sides' f32 sums
# straddle a bf16 rounding boundary, an edge latent or gradient entry
# rounds one bf16 step (2^-8) apart, and the 5 layers carry that on.
# Measured on the H100: loss 1.8e-5 relative, gradients 5.2e-4 of their
# scale (A: 1.1e-7 and 1.5e-5); B's limits are ~10x those.
STEP_TOL = {
    "A": dict(loss_rtol=1e-4, grad_rel=1e-3, param_atol=1e-7, param_rtol=2.0**-22, update_rtol=1e-5),
    "B": dict(loss_rtol=2e-4, grad_rel=5e-3, param_atol=1e-7, param_rtol=2.0**-22, update_rtol=1e-5),
}
TRAIN_STEPS, SAVE_EVERY, LOG_EVERY = 20, 10, 10
PROFILE_STEPS = 3
FIXED_BATCH_STEPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor f32; bf16 tensor
# the gather probes of scripts/gather_kernel_probe.py: tbl [38384, 64] f32,
# idx [307008] i32
GATHER_SHAPE = (38384, 64, 307008)
MODEL = dict(  # the model of both configs
    layers=5,
    hidden_dim=64,
    dim=2,
    particle_type_embedding_size=9,
    input_sequence_length=11,
    connection_radius=0.6,
    noise_std=0.02,
    pad_multiple=128,
    inference_mode="autoregressive",
    lr_init=1e-3,
    lr_decay=0.1,
    lr_decay_steps=30000,
    seed=0,
)
CONFIGS = {
    # configs/taylor2d_single_scale.yaml
    "A": dict(batch_size=32, compute_dtype="float32", domain_min=[-5.0, -30.0], domain_max=[80.0, 30.0]),
    # configs/taylor2d_demo_bf16.yaml: slots, symmetric gather and domain from metadata
    "B": dict(batch_size=16, compute_dtype="bfloat16"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def dtype_of(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def edge_inputs(r, k, d, h, dtype, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    degrees = torch.randint(0, k + 1, (r, 1), generator=g).float()
    slot = torch.arange(k).repeat(r)[:, None]
    mask = (slot < degrees.repeat_interleave(k, dim=0)).float()

    def n(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    args = [
        (n(r * k, d) * mask).to(dtype),  # e
        n(r * k, h).to(dtype),  # xj
        n(r, h),  # proj_i
        degrees,
        n(d, h, scale=0.2),  # we
        n(h, scale=0.1),  # be
        n(h, d, scale=0.2),  # w2
        n(d, scale=0.1),  # b2
        1.0 + n(d, scale=0.1),  # lns
        n(d, scale=0.1),  # lnb
    ]
    return [a.to(device).contiguous() for a in args]


def bwd_inputs(r, k, d, dtype, seed, device):
    """Forward inputs with xj moved off the ReLU ties, plus cotangents.

    Where |h| < 0.05, xj gets +0.1: the kernel and the plain version sum
    e @ We in different orders, and a gate h > 0 that flips between them
    changes g_h by a whole g_a, which no tolerance on sums covers."""
    import torch

    args = edge_inputs(r, k, d, d, dtype, seed, device)
    e, xj, proj_i, _, we, be = args[:6]
    h = e.float() @ we.to(dtype).float() + xj.float() + proj_i.repeat_interleave(k, dim=0) + be
    args[1] = torch.where(h.abs() < 0.05, xj.float() + 0.1, xj.float()).to(dtype).contiguous()
    g = torch.Generator().manual_seed(seed + 7)
    g_new = torch.randn(r * k, d, generator=g).to(dtype).to(device)
    g_agg = torch.randn(r, d, generator=g).to(dtype).to(device)
    return args, g_new, g_agg


def _bound(n_bytes, flops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_bound(args, k, dtype_name, backward=False):
    """Least time on the card for this call: the bytes it must move (each
    input read once, each output written once) over HBM rate, against the
    operations these inputs need over the peak rate for their type; the
    larger, and which. Only what this call's data needs counts: an edge at
    a masked slot (slot >= degree) needs no xj and no products, and in the
    backward no e either (g_e = g_new, g_xj = 0 there); proj_i and g_agg
    matter only at receivers with an edge. Every output is written in
    full, and the forward reads e at every slot (new_e = e where masked).
    Products count 2*D*H per valid edge: two in the forward, six in the
    backward (h and o recomputed, g_a, g_e, g_we, g_w2)."""
    e, _, proj_i, degrees = args[:4]
    r, d, h = proj_i.shape[0], e.shape[1], proj_i.shape[1]
    es = 2 if dtype_name == "bfloat16" else 4
    valid = int(degrees.clamp(max=k).sum())
    live = int((degrees > 0).sum())
    weights = (2 * d * h + h + 3 * d) * 4
    if backward:
        n_bytes = (
            valid * d * es + valid * h * es + r * k * d * es  # e, xj (valid rows), g_new
            + live * h * 4 + r * 4 + live * d * es  # proj_i, degrees, g_agg
            + weights  # weights in, weight gradients out
            + r * k * d * es + r * k * h * es + r * h * es  # g_e, g_xj, g_proj_i
            + weights
        )
        flops = 6 * 2 * valid * d * h
    else:
        n_bytes = (
            r * k * d * es + valid * h * es  # e, xj (valid rows)
            + live * h * 4 + r * 4 + weights  # proj_i, degrees, weights
            + r * k * d * es + r * d * es  # new_e, agg
        )
        flops = 2 * 2 * valid * d * h
    ms, by = _bound(n_bytes, flops, dtype_name)
    return dict(bound_ms=ms, bound_by=by, bytes=n_bytes, flops=flops, valid_edges=valid)


def time_ms(fn, sets, iters=200, warmup=20):
    """Mean ms per call over ``iters`` calls cycling through input sets
    (together larger than the 50 MB L2, so inputs come from HBM)."""
    import torch

    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kern, plain, sets, **kw):
    """Kernel and plain version in turns (plain, kernel, kernel, plain)."""
    t_plain_a = time_ms(plain, sets, **kw)
    t_kern_a = time_ms(kern, sets, **kw)
    t_kern_b = time_ms(kern, sets, **kw)
    t_plain_b = time_ms(plain, sets, **kw)
    return dict(ms=(t_kern_a + t_kern_b) / 2, plain_ms=(t_plain_a + t_plain_b) / 2,
                kernel_ms_runs=[t_kern_a, t_kern_b], plain_ms_runs=[t_plain_a, t_plain_b])


def compare_fwd(eb, args, k, dtype_name, where):
    """Max |err| of the kernel's new_e and agg against the plain version
    on ``args``; raises beyond the tolerance."""
    import torch

    atol, rtol = TOL[dtype_name]
    got = eb.edge_block_fwd(*args, k)
    want = eb.fused_edge_block_reference(*args, k)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("new_e", "agg"), got, want):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"edge_block_fwd {where} {name}: bad output")
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if (err > atol + rtol * b.abs()).any():
            raise AssertionError(f"edge_block_fwd {where} {name}: max |err| {float(err.max()):.3e} "
                                 f"beyond atol {atol} + rtol {rtol}")
    return worst


def check_fwd(eb, dtype_name):
    worst = 0.0
    for si, (r, k, d) in enumerate(SHAPES):
        args = edge_inputs(r, k, d, d, dtype_of(dtype_name), seed=si, device="cuda")
        worst = max(worst, compare_fwd(eb, args, k, dtype_name, f"{dtype_name} {(r, k, d)}"))
        log(f"kernel edge_block_fwd {dtype_name} R,K,D={r},{k},{d}: ok (max |err| so far {worst:.3e})")
    return worst


def compare_bwd(eb, got, want, sums, dtype_name, where):
    """Max |err| of the three row outputs and the six weight gradients;
    raises beyond the tolerances."""
    import torch

    atol, rtol = BWD_TOL[dtype_name]
    dtype = dtype_of(dtype_name)
    worst = {"rows": 0.0, "wgrad": 0.0, "wgrad_over_abs_sum": 0.0}
    for name, a, b in zip(("g_e", "g_xj", "g_proj_i"), got[:3], want[:3]):
        if a.dtype != dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"edge_block_bwd {where} {name}: bad output")
        err = (a.float() - b.float()).abs()
        worst["rows"] = max(worst["rows"], float(err.max()))
        if (err > atol + rtol * b.float().abs()).any():
            raise AssertionError(f"edge_block_bwd {where} {name}: max |err| {float(err.max()):.3e} "
                                 f"beyond atol {atol} + rtol {rtol}")
    names = ("g_we", "g_be", "g_w2", "g_b2", "g_lns", "g_lnb")
    for name, a, b, s in zip(names, got[3:], want[3:], sums):
        if a.dtype != torch.float32 or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"edge_block_bwd {where} {name}: bad output")
        err = (a - b).abs()
        worst["wgrad"] = max(worst["wgrad"], float(err.max()))
        worst["wgrad_over_abs_sum"] = max(worst["wgrad_over_abs_sum"], float((err / (s + 1e-30)).max()))
        if (err > SUM_RTOL[dtype_name] * s + 1e-6).any():
            raise AssertionError(f"edge_block_bwd {where} {name}: max |err| {float(err.max()):.3e} "
                                 f"beyond {SUM_RTOL[dtype_name]} * sum|terms| + 1e-6")
    return worst


def check_bwd(eb, dtype_name):
    import torch

    worst = {"rows": 0.0, "wgrad": 0.0, "wgrad_over_abs_sum": 0.0}
    for si, (r, k, d) in enumerate(SHAPES):
        args, g_new, g_agg = bwd_inputs(r, k, d, dtype_of(dtype_name), seed=si, device="cuda")
        got = eb.edge_block_bwd(*args, g_new, g_agg, k)
        again = eb.edge_block_bwd(*args, g_new, g_agg, k)
        want = eb.fused_edge_block_bwd_reference(*args, g_new, g_agg, k)
        sums = eb.weight_grad_abs_sums(*args, g_new, g_agg, k)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"edge_block_bwd {dtype_name} {(r, k, d)}: two launches differ")
        w = compare_bwd(eb, got, want, sums, dtype_name, f"{dtype_name} {(r, k, d)}")
        worst = {key: max(worst[key], w[key]) for key in worst}
        log(f"kernel edge_block_bwd {dtype_name} R,K,D={r},{k},{d}: ok, bit-identical twice "
            f"(max |err| rows {w['rows']:.3e}, weight grads {w['wgrad']:.3e} = "
            f"{w['wgrad_over_abs_sum']:.2e} of sum|terms|)")
    return worst


def phase_kernels(train_rows):
    """Checks, then times. train_rows: {dtype_name: R} of the training
    shapes (batch x padded nodes)."""
    import torch

    from sgnn_tpu_torch.ops import edge_block as eb

    results = {"edge_block_fwd": {}, "edge_block_bwd": {}}
    for dtype_name in ("float32", "bfloat16"):
        dtype = dtype_of(dtype_name)
        fwd_err = check_fwd(eb, dtype_name)
        bwd_err = check_bwd(eb, dtype_name)
        k, d = 8, 64

        # forward at the rollout shape (as before) and at the training shape
        r = SHAPES[0][0]
        sets = [edge_inputs(r, k, d, d, dtype, seed=100 + i, device="cuda") for i in range(4)]
        roll = time_pair(lambda *a: eb.edge_block_fwd(*a, k), lambda *a: eb.fused_edge_block_reference(*a, k), sets)
        roll.update(edge_bound(sets[0], k, dtype_name), shape=[r, k, d])
        del sets
        r = train_rows[dtype_name]
        sets = [edge_inputs(r, k, d, d, dtype, seed=200 + i, device="cuda") for i in range(2)]
        fwd_train_err = compare_fwd(eb, sets[0], k, dtype_name, f"{dtype_name} R={r}")
        fwd_err = max(fwd_err, fwd_train_err)
        log(f"kernel edge_block_fwd {dtype_name} R,K,D={r},{k},{d}: ok (max |err| {fwd_train_err:.3e})")
        fwd = time_pair(lambda *a: eb.edge_block_fwd(*a, k), lambda *a: eb.fused_edge_block_reference(*a, k),
                        sets, iters=20, warmup=4)
        fwd.update(edge_bound(sets[0], k, dtype_name), shape=[r, k, d])
        del sets
        results["edge_block_fwd"][dtype_name] = dict(
            fwd, max_abs_err=fwd_err, errors_at_training_shape={"max_abs_err": fwd_train_err},
            checked_shapes=[*SHAPES, (r, k, d)],
            tol={"atol": TOL[dtype_name][0], "rtol": TOL[dtype_name][1]}, at_rollout_shape=roll,
        )
        log(f"time edge_block_fwd {dtype_name} R,K,D={r},{k},{d}: kernel {fwd['ms'] * 1e3:.2f} us, "
            f"plain {fwd['plain_ms'] * 1e3:.2f} us, bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']}); "
            f"at R={SHAPES[0][0]}: kernel {roll['ms'] * 1e3:.2f} us, plain {roll['plain_ms'] * 1e3:.2f} us, "
            f"bound {roll['bound_ms'] * 1e3:.2f} us")

        # backward at the training shape
        sets = [(*a, gn, ga) for a, gn, ga in
                (bwd_inputs(r, k, d, dtype, seed=300 + i, device="cuda") for i in range(2))]
        once = eb.edge_block_bwd(*sets[0], k)
        twice = eb.edge_block_bwd(*sets[0], k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(once, twice)):
            raise AssertionError(f"edge_block_bwd {dtype_name} R={r}: two launches differ")
        w = bwd_train_err = compare_bwd(eb, once, eb.fused_edge_block_bwd_reference(*sets[0], k),
                                        eb.weight_grad_abs_sums(*sets[0], k), dtype_name, f"{dtype_name} R={r}")
        bwd_err = {key: max(bwd_err[key], w[key]) for key in bwd_err}
        log(f"kernel edge_block_bwd {dtype_name} R,K,D={r},{k},{d}: ok, bit-identical twice "
            f"(max |err| rows {w['rows']:.3e}, weight grads {w['wgrad']:.3e} = "
            f"{w['wgrad_over_abs_sum']:.2e} of sum|terms|)")
        del once, twice
        bwd = time_pair(lambda *a: eb.edge_block_bwd(*a, k), lambda *a: eb.fused_edge_block_bwd_reference(*a, k),
                        sets, iters=10, warmup=2)
        bwd.update(edge_bound(sets[0], k, dtype_name, backward=True), shape=[r, k, d])
        del sets
        results["edge_block_bwd"][dtype_name] = dict(
            bwd, max_abs_err=max(bwd_err["rows"], bwd_err["wgrad"]), errors=bwd_err,
            errors_at_training_shape=bwd_train_err, checked_shapes=[*SHAPES, (r, k, d)],
            tol={"atol": BWD_TOL[dtype_name][0], "rtol": BWD_TOL[dtype_name][1],
                 "weight_grads": f"{SUM_RTOL[dtype_name]} * sum|terms| + 1e-6"},
        )
        log(f"time edge_block_bwd {dtype_name} R,K,D={r},{k},{d}: kernel {bwd['ms'] * 1e3:.2f} us, "
            f"plain {bwd['plain_ms'] * 1e3:.2f} us, bound {bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']})")
        torch.cuda.empty_cache()

    # the library call of the gather probes (rows 3-5 of PERF.md's table)
    rows, width, n_idx = GATHER_SHAPE
    g = torch.Generator().manual_seed(5)
    sets = [(torch.randn(rows, width, generator=g).cuda(),
             torch.randint(0, rows, (n_idx,), generator=g, dtype=torch.int32).cuda()) for _ in range(4)]
    gather_ms = time_ms(lambda t, i: torch.index_select(t, 0, i), sets)
    n_bytes = rows * width * 4 + n_idx * 4 + n_idx * width * 4
    bound_ms, by = _bound(n_bytes, 0, "float32")
    results["index_select"] = dict(shape=[rows, width, n_idx], library_ms=gather_ms, bound_ms=bound_ms,
                                   bound_by=by, bytes=n_bytes)
    log(f"time index_select tbl [{rows}, {width}] f32, {n_idx} indices: {gather_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us ({by})")
    return results


def make_dataset(root: Path) -> Path:
    from sgnn_tpu_torch.data.builder import DatasetBuilder
    from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

    generate_synthetic_raw_dataset(root / "raw", num_sims=4, nx=120, ny=40, num_steps=152, seed=0)
    DatasetBuilder(
        root / "raw", root / "data", val_patterns=["-110"], test_patterns=["-120", "-130"]
    ).build()
    return root / "data"


def train_config(root: Path, data: Path, name: str, **kw):
    from sgnn_tpu_torch.train.config import TrainConfig

    base = dict(
        mode="train", data_path=str(data), model_path=str(root / "models"),
        output_path=str(root / "rollouts"), run_name=f"smoke_{name}",
        ntraining_steps=TRAIN_STEPS, nsave_steps=SAVE_EVERY, log_every=LOG_EVERY,
        **MODEL, **CONFIGS[name],
    )
    base.update(kw)
    return TrainConfig(**base)


def run_training(root: Path, data: Path, name: str, smi: str, kind: str):
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_metadata
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.train.train import simulator_config_from, train

    cfg = train_config(root, data, name)
    sim_cfg = simulator_config_from(cfg, load_metadata(data))
    valid = TrajectoryLoader(data / "valid.npz", pad_multiple=cfg.pad_multiple)
    nodes = TrajectoryLoader(data / "train.npz", pad_multiple=cfg.pad_multiple).num_nodes
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    layers = cfg.layers
    expect = dict(bwd=layers * TRAIN_STEPS,
                  fwd=layers * TRAIN_STEPS + layers * val_steps * (TRAIN_STEPS // SAVE_EVERY),
                  sym_bwd=layers * TRAIN_STEPS if sim_cfg.symmetric_gather else 0)
    log(f"train {name} ({cfg.compute_dtype}): batch {cfg.batch_size}, K={sim_cfg.slots}, "
        f"symmetric_gather={sim_cfg.symmetric_gather}, domain {sim_cfg.domain}")

    torch.cuda.synchronize()
    eb.LAUNCHES = eb.BWD_LAUNCHES = sg.BWD_CALLS = 0
    t0 = time.perf_counter()
    result = train(cfg)  # the port's entry point, on CUDA by default
    got = dict(fwd=eb.LAUNCHES, bwd=eb.BWD_LAUNCHES, sym_bwd=sg.BWD_CALLS)
    wall_s = time.perf_counter() - t0
    if got != expect:
        raise AssertionError(f"train {name}: launches {got}, expected {expect}")
    if result["step"] != TRAIN_STEPS or not math.isfinite(result["lowest_eval_loss"]):
        raise AssertionError(f"train {name}: {result}")
    run_dir = Path(cfg.model_path) / cfg.run_name
    meta = json.loads((run_dir / "checkpoint_meta.json").read_text())
    if not meta["path"].startswith("model-best-") or not (run_dir / meta["path"]).exists():
        raise AssertionError(f"train {name}: no best checkpoint ({meta})")
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rec = [r for r in records if "train/loss" in r]
    val_rec = [r for r in records if "val/loss" in r]
    if [r["step"] for r in train_rec] != [10, 20] or len(val_rec) != 2:
        raise AssertionError(f"train {name}: metrics {records}")
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"train {name}: non-finite metric in {r}")

    out = dict(
        config=name, compute_dtype=cfg.compute_dtype, batch_size=cfg.batch_size,
        receivers=cfg.batch_size * nodes, slots=sim_cfg.slots,
        symmetric_gather=sim_cfg.symmetric_gather, launches=got, expected_launches=expect,
        ms_per_step_11_20=train_rec[-1]["train/step_time_s"] * 1e3,
        ms_per_step_1_10=train_rec[0]["train/step_time_s"] * 1e3,
        train_loss=[r["train/loss"] for r in train_rec], val_loss=[r["val/loss"] for r in val_rec],
        checkpoint=meta["path"], wall_s=wall_s, device=kind, nvidia_smi=smi,
    )
    out["profile"] = profile_training(cfg, torch.device("cuda", torch.cuda.current_device()))
    log(f"train {name} " + json.dumps(out))
    return out, cfg, meta["path"]


def profile_training(cfg, device, warm=2):
    """Peak memory of a training step, and device time per step from
    torch.profiler over PROFILE_STEPS warm steps beside the wall time of
    the same steps unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgnn_tpu_torch.train.train import batch_to_device, build_training

    built = build_training(cfg, device)
    sim, step_fn = built.sim, built.step_fn
    source = built.batcher.epochs()
    batches = [batch_to_device(next(source), sim.device) for _ in range(warm + 2 * PROFILE_STEPS)]
    step = 0
    for b in batches[:warm]:
        step_fn(b, step)
        step += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[warm:warm + PROFILE_STEPS]:
        step_fn(b, step)
        step += 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[warm + PROFILE_STEPS:]:
            step_fn(b, step)
            step += 1
        torch.cuda.synchronize()
    del built, sim, step_fn, batches
    torch.cuda.empty_cache()
    res = dict(wall_ms_per_step=wall_ms, peak_memory_mb=peak_mb)
    res.update(device_profile(prof, PROFILE_STEPS, wall_ms))
    return res


def device_profile(prof, steps, wall_ms_step):
    import torch

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return {"device_ms_per_step": "not measured (the profiler recorded no device time)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    device_ms = busy_us / 1e3 / steps
    return {
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms_step,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_us_per_step": {e.key[:60]: e.self_device_time_total / steps for e in top},
    }


def fixed_batch_check(cfg, device):
    """FIXED_BATCH_STEPS steps of config A on one batch with one noise draw
    lower the loss below its first value."""
    import torch

    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train.train import batch_to_device, build_training

    built = build_training(cfg, device)
    batch = batch_to_device(next(built.batcher.epochs()), device)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                       generator=torch.Generator(device=device).manual_seed(1), device=device)
    losses = [float(built.step_fn(batch, i, noise=noise)["train/loss"]) for i in range(FIXED_BATCH_STEPS)]
    del built, batch
    if not all(math.isfinite(v) for v in losses) or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"fixed batch: loss did not fall: {losses}")
    log(f"fixed batch (A, {FIXED_BATCH_STEPS} steps): loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    return losses


def card_vs_cpu_step(cfg, name, device):
    """One step of config ``name`` at full width on 2 samples, on the card
    (kernels) and on the CPU (plain versions), from the same weights,
    batch and noise; held to STEP_TOL[name]."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train.train import batch_to_device, build_training

    step_tol = STEP_TOL[name]
    runs = {}
    batch = None
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        built = build_training(cfg, dev, batch_size=2)
        sim = built.sim
        if batch is None:
            batch = next(built.batcher.epochs())
            noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                               generator=torch.Generator().manual_seed(2))
        before = {k: v.detach().cpu().clone() for k, v in sim.state_dict().items()}
        sym_expect = cfg.layers if built.sim_cfg.symmetric_gather else 0
        sym_calls = sg.BWD_CALLS
        t0 = time.perf_counter()
        metrics = built.step_fn(batch_to_device(batch, dev), 0, noise=noise.to(dev))
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        runs[where] = dict(metrics=metrics, seconds=seconds, sym_bwd=sg.BWD_CALLS - sym_calls,
                           grads={k: p.grad.detach().cpu() for k, p in sim.named_parameters()},
                           params={k: v.detach().cpu() for k, v in sim.state_dict().items()}, before=before)
        del built, sim
    card, cpu = runs["card"], runs["cpu"]
    if card["sym_bwd"] != sym_expect or cpu["sym_bwd"] != sym_expect:
        raise AssertionError(f"card vs CPU step {name}: sym_gather backward passes "
                             f"{card['sym_bwd']}, {cpu['sym_bwd']}, expected {sym_expect}")
    lr = cfg.lr_init + 1e-6  # sched(0)
    worst = dict(loss_rel=0.0, grad_rel=0.0, param=0.0, param_over_allowed=0.0, sign_flips=0)
    for k, v in cpu["metrics"].items():
        rel = abs(card["metrics"][k] - v) / max(abs(v), 1e-30)
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        if rel > step_tol["loss_rtol"]:
            raise AssertionError(f"card vs CPU step {name}: {k} {card['metrics'][k]} vs {v}")
    for k, g_cpu in cpu["grads"].items():
        g_card = card["grads"][k]
        tol = step_tol["grad_rel"] * (float(g_cpu.abs().max()) + g_cpu.abs())
        err = (g_card - g_cpu).abs()
        worst["grad_rel"] = max(worst["grad_rel"], float(err.max()) / max(float(g_cpu.abs().max()), 1e-30))
        if (err > tol).any():
            raise AssertionError(f"card vs CPU step {name}: grad {k} max |err| {float(err.max()):.3e}")
        p_cpu = cpu["params"][k]
        perr = (card["params"][k] - p_cpu).abs()
        g_big = torch.maximum(g_card.abs(), g_cpu.abs()).clamp(min=1e-30)
        flip = g_card * g_cpu < 0
        apart = torch.where(flip, 2.0, torch.clamp(err / g_big, max=2.0))
        allowed = (step_tol["param_atol"] + step_tol["param_rtol"] * p_cpu.abs()
                   + lr * (step_tol["update_rtol"] + apart))
        worst["sign_flips"] += int(flip.sum())
        worst["param"] = max(worst["param"], float(perr.max()))
        worst["param_over_allowed"] = max(worst["param_over_allowed"], float((perr / allowed).max()))
        if (perr > allowed).any():
            raise AssertionError(f"card vs CPU step {name}: param {k} max |err| {float(perr.max()):.3e}")
        if torch.equal(card["params"][k], card["before"][k]):
            raise AssertionError(f"card vs CPU step {name}: param {k} did not move")
    out = dict(config=name, compute_dtype=cfg.compute_dtype, samples=2,
               receivers=int(np.prod(batch["node_mask"].shape)), sym_gather_backward=card["sym_bwd"],
               loss=card["metrics"]["train/loss"], max_err=worst, tol=step_tol,
               card_s=card["seconds"], cpu_s=cpu["seconds"])
    log("card vs CPU step " + json.dumps(out))
    return out


def sym_gather_check(cfg, device):
    """sym_gather's backward against index_select's on the graph of one full
    training batch of ``cfg`` (searched on the card as forward_batched
    does), in f32 and in bf16, with a cotangent that is 0 at masked slots
    as the edge-block backward's g_xj is. Both sum the same <= K terms per
    node in another order: f32 to K * 2^-23 of sum|terms|; in bf16
    sym_gather sums in f32 and rounds once, index_add_ rounds every add,
    so to K * 2^-8 of sum|terms|. A wrong reverse position moves a whole
    term."""
    import torch

    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.ops.neighbors import radius_neighbors_grid_batched
    from sgnn_tpu_torch.train.train import batch_to_device, build_training

    built = build_training(cfg, device)
    sim_cfg = built.sim_cfg
    batch = batch_to_device(next(built.batcher.epochs()), device)
    del built
    nl = radius_neighbors_grid_batched(
        batch["positions"][..., -1, :], sim_cfg.connectivity_radius,
        domain_min=tuple(sim_cfg.domain[0]), domain_max=tuple(sim_cfg.domain[1]),
        max_neighbors=sim_cfg.slots, node_mask=batch["node_mask"], cell_capacity=sim_cfg.cell_capacity,
    )
    rev_pos, rev_ok = sg.reverse_edge_positions(nl.senders, nl.mask)
    if not torch.equal(rev_ok, nl.mask):
        raise AssertionError("sym_gather check: the graph is not symmetric")
    r, k = nl.senders.shape
    idx = nl.senders.reshape(-1)
    width = sim_cfg.latent_dim
    g = torch.Generator(device=device).manual_seed(3)
    table = torch.randn(r, width, generator=g, device=device)
    cot = torch.randn(r * k, width, generator=g, device=device) * nl.mask.reshape(-1, 1)
    out = dict(receivers=r, slots=k, edges=int(nl.mask.sum()))
    for dtype, rtol in ((torch.float32, k * 2.0**-23), (torch.bfloat16, k * 2.0**-8)):
        c = cot.to(dtype)
        abs_sum = torch.zeros(r, width, device=device).index_add_(0, idx.long(), c.float().abs())
        tab = table.to(dtype).requires_grad_(True)
        (got,) = torch.autograd.grad(sg.sym_gather(tab, idx, rev_pos, rev_ok), tab, c)
        (want,) = torch.autograd.grad(tab.index_select(0, idx), tab, c)
        err = (got.float() - want.float()).abs()
        name = str(dtype).removeprefix("torch.")
        out[name] = dict(max_abs_err=float(err.max()),
                         max_err_over_abs_sum=float((err / abs_sum.clamp(min=1e-30)).max()), rtol=rtol)
        if got.dtype != dtype or (err > rtol * abs_sum).any():
            raise AssertionError(f"sym_gather check {name}: max |err| {float(err.max()):.3e} "
                                 f"beyond {rtol:.3e} * sum|terms|")
    log("sym_gather backward vs index_select backward " + json.dumps(out))
    return out


def run_rollout(root: Path, data: Path, train_cfg, model_file: str, smi: str, kind: str):
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_metadata
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager
    from sgnn_tpu_torch.train.train import predict, simulator_config_from

    cfg = train_cfg
    cfg.mode, cfg.model_file = "rollout", model_file
    compute_dtype = cfg.compute_dtype
    metadata = load_metadata(data)
    sim_cfg = simulator_config_from(cfg, metadata)
    loader = TrajectoryLoader(data / "test.npz", pad_multiple=cfg.pad_multiple)
    frames = [p.shape[0] for p, _, _ in loader.trajectories]
    steps = sum(f - cfg.input_sequence_length for f in frames)
    expected = cfg.layers * steps
    log(
        f"rollout {compute_dtype}: {len(frames)} test trajectories x {loader.num_nodes} nodes "
        f"(padded), K={sim_cfg.slots}, {steps} rollout steps, from {cfg.run_name}/{model_file}"
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eb.LAUNCHES = eb.BWD_LAUNCHES = 0
    summary = predict(cfg)  # the port's entry point, on CUDA by default
    launches, bwd_launches = eb.LAUNCHES, eb.BWD_LAUNCHES
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    if launches != expected or bwd_launches != 0:
        raise AssertionError(f"rollout: edge_block_fwd launched {launches} times (expected {expected}), "
                             f"edge_block_bwd {bwd_launches}")
    if not math.isfinite(summary["total"]):
        raise AssertionError(f"non-finite rollout loss {summary}")

    outs = []
    for name in metadata["file_test"]:
        with open(Path(cfg.output_path) / cfg.run_name / name.replace(".npz", ".pkl"), "rb") as f:
            outs.append(pickle.load(f))
    for out in outs:
        for key in ("predicted_rollout", "predicted_strain", "rmse_position", "rmse_strain"):
            if not np.isfinite(out[key]).all():
                raise AssertionError(f"{out['case_name']}: non-finite {key}")
        if out["predicted_rollout"].shape != out["ground_truth_rollout"].shape:
            raise AssertionError(f"{out['case_name']}: rollout shape mismatch")

    # steady state: the last trajectory (the first one warmed up the card)
    warm = outs[-1]
    n_steps = warm["predicted_rollout"].shape[0]
    ms_step = warm["run_time"] / n_steps * 1e3
    result = dict(
        compute_dtype=compute_dtype, launches=launches, expected_launches=expected,
        launches_per_step=launches / steps, steps=steps, nodes=loader.num_nodes,
        slots=sim_cfg.slots, ms_per_step=ms_step, steps_per_s=1e3 / ms_step,
        first_trajectory_s=outs[0]["run_time"], peak_memory_mb=peak_mb,
        mean_loss=summary["total"], checkpoint=model_file, device=kind, nvidia_smi=smi,
    )

    if compute_dtype == "float32":
        # the same rollout's first steps on the CPU through the plain versions
        from sgnn_tpu_torch.physics.rollout import rollout
        from sgnn_tpu_torch.physics.simulator import make_norm_stats, simulator_init

        state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(model_file)
        cpu_sim = simulator_init(sim_cfg, device="cpu")
        cpu_sim.load_state_dict(state["params"], strict=True)
        traj = next(iter(loader))
        t_end = cfg.input_sequence_length + ROLLOUT_CHECK_STEPS
        ref = rollout(
            cpu_sim, sim_cfg, make_norm_stats(metadata, cfg.noise_std, device="cpu"),
            traj["positions"][:, :t_end], traj["particle_type"], traj["strains"][:t_end],
            traj["node_mask"], device="cpu",
        )
        atol, rtol = ROLLOUT_TOL
        errs = {}
        for key in ("predicted_rollout", "predicted_strain"):
            a = outs[0][key][:ROLLOUT_CHECK_STEPS]
            b = ref[key].numpy()
            err = np.abs(a - b)
            errs[key] = float(err.max())
            if (err > atol + rtol * np.abs(b)).any():
                raise AssertionError(
                    f"card vs CPU rollout, {key}: max |err| {err.max():.3e} beyond "
                    f"atol {atol} + rtol {rtol}"
                )
        result["cpu_check"] = dict(steps=ROLLOUT_CHECK_STEPS, max_abs_err=errs, atol=atol, rtol=rtol)

        gpu_sim = simulator_init(sim_cfg)
        gpu_sim.load_state_dict(state["params"], strict=True)
        result["profile"] = profile_rollout(
            gpu_sim, sim_cfg, make_norm_stats(metadata, cfg.noise_std, device=gpu_sim.device),
            traj, ms_step,
        )
    log("rollout " + json.dumps(result))
    return result


def profile_rollout(sim, sim_cfg, stats, traj, wall_ms_step, steps=10):
    """Device time per rollout step from torch.profiler over ``steps``
    steps of a warm rollout, beside the unprofiled wall time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgnn_tpu_torch.physics.rollout import rollout

    t_end = sim_cfg.input_sequence_length + steps
    args = (traj["positions"][:, :t_end], traj["particle_type"], traj["strains"][:t_end],
            traj["node_mask"])
    rollout(sim, sim_cfg, stats, *args)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rollout(sim, sim_cfg, stats, *args)
        torch.cuda.synchronize()
    return dict(wall_ms_per_step=wall_ms_step, **device_profile(prof, steps, wall_ms_step))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from sgnn_tpu_torch.data.loader import TrajectoryLoader
    from sgnn_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"build: {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke-") as tmp:
        root = Path(tmp)
        # 4. dataset (first: its node count sets the training shapes timed in 3)
        t0 = time.perf_counter()
        data = make_dataset(root)
        nodes = TrajectoryLoader(data / "train.npz", pad_multiple=MODEL["pad_multiple"]).num_nodes
        log(f"dataset: built in {time.perf_counter() - t0:.1f} s; {nodes} padded nodes")
        train_rows = {CONFIGS[n]["compute_dtype"]: CONFIGS[n]["batch_size"] * nodes for n in CONFIGS}

        # 3. kernels against their plain versions, then timed
        kernel_results = phase_kernels(train_rows)

        # 5. training, through train
        trained = {}
        for name in CONFIGS:
            out, cfg, ckpt = run_training(root, data, name, smi, kind)
            trained[name] = (out, cfg, ckpt)
        checks = {name: train_config(root, data, name, run_name=f"smoke_checks_{name}") for name in CONFIGS}
        card = torch.device("cuda", torch.cuda.current_device())
        fixed = fixed_batch_check(checks["A"], card)
        torch.cuda.empty_cache()
        step_checks = {}
        for name, cfg in checks.items():
            step_checks[name] = card_vs_cpu_step(cfg, name, card)
            torch.cuda.empty_cache()
        sym_check = sym_gather_check(checks["B"], card)
        torch.cuda.empty_cache()

        # 6. rollout, through predict, from the checkpoints training wrote
        rollouts = {}
        for name in CONFIGS:
            out, cfg, ckpt = trained[name]
            rollouts[cfg.compute_dtype] = run_rollout(root, data, cfg, ckpt, smi, kind)

    by_dtype = {trained[n][0]["compute_dtype"]: trained[n][0] for n in CONFIGS}
    kernels = []
    for kname, src, replaces in (
        ("edge_block_fwd", "sgnn_tpu_torch/csrc/edge_block_fwd.cu", "sgnn_tpu/experimental/edge_block.py:118"),
        ("edge_block_bwd", "sgnn_tpu_torch/csrc/edge_block_bwd.cu", "sgnn_tpu/experimental/edge_block.py:138"),
    ):
        for dt, res in kernel_results[kname].items():
            tr = by_dtype[dt]
            per_path = {f"train_{tr['config']}": tr["launches"]["fwd" if kname == "edge_block_fwd" else "bwd"]}
            if kname == "edge_block_fwd":
                per_path[f"rollout_{dt}"] = rollouts[dt]["launches"]
            entry = dict(
                name=kname, route="cuda", source=src, replaces=replaces,
                launches=per_path[f"train_{tr['config']}"], launches_by_path=per_path,
                dtype=dt, shape=res["shape"], max_abs_err=res["max_abs_err"], tol=res["tol"],
                checked_shapes=res["checked_shapes"], errors_at_training_shape=res["errors_at_training_shape"],
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=None, bytes=res["bytes"], flops=res["flops"],
                kernel_ms_runs=res["kernel_ms_runs"], plain_ms_runs=res["plain_ms_runs"],
            )
            if "at_rollout_shape" in res:
                entry["at_rollout_shape"] = {k: res["at_rollout_shape"][k] for k in
                                             ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
            kernels.append(entry)
    log("library " + json.dumps({"index_select": kernel_results["index_select"],
                                 "fixed_batch_losses": fixed, "card_vs_cpu_step": step_checks,
                                 "sym_gather_backward_check": sym_check,
                                 "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
