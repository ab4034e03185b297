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
     training shapes of A (f32) and B (bf16), the forward also at ragged
     tile shapes, D != H and widths beyond the tile, each on the kernel
     its shape rule picks; the backward twice on the same inputs, bit for
     bit; then each kernel and its plain version
     timed with CUDA events at the shapes of the paths below, and
     ``index_select`` (the library call of the gather probes) at the
     probes' shape;
  4. dataset: a synthetic Taylor-impact dataset at the reference's raw
     scale (120 x 40 particles, 152 frames) built by the port's builder;
  5. training: ``train`` on the card for 20 steps with the values of
     configs/taylor2d_single_scale.yaml (A: f32, batch 32, explicit
     domain) and configs/taylor2d_demo_bf16.yaml (B: bf16, batch 16,
     domain from metadata, symmetric gather by the auto-rule), 5 layers,
     hidden 64, r = 0.6, window 11: its batches through the prefetcher,
     its step captured in a CUDA graph and replayed, validating at step
     10 while the prefetcher stages. Each run counts the kernels' launches
     (every forward launch must be the tensor-core kernel's; A's sender
     gathers: the take kernel forward and backward, the sorted sum
     backward) and the symmetric gather's backward passes, reads its
     metrics and checkpoint; then ``training_routes`` runs the captured
     step and the eager one (A: the eager one twice) on the same staged
     batches and noise stream: parameters, Adam's moments and steps and
     every metric equal with torch.equal, the launches of both, wall,
     device busy and idle, kernels and host calls per step, capture time,
     peak memory of the capturing and of an eager call, and one warm step
     of each under sync-debug mode "error". Then A's loss on one fixed
     batch must fall over 10 steps; one step of each of A and B at full
     width on 2 samples must match the same step on the CPU through the
     plain versions (loss, every gradient, the parameters after Adam); on
     B's graph sym_gather's backward must match index_select's; and A's
     deterministic sender gather (one stable sort, the take kernel, the
     sorted sum) is timed against index_select's (``c2_cost``);
  6. rollout: ``predict`` in rollout mode from the checkpoint each
     training run wrote (A in f32, B in bf16), its step captured in a
     CUDA graph and replayed (the port of ``make_jit_rollout``), counting
     the forward kernel's launches (replays add what their capture
     recorded); each of the f32 run's first steps is held against the
     same step on the CPU from the card's window; then on the warm
     trajectory the captured route against the eager one in the same call
     (``compare_routes``): equal with torch.equal, the launch counts of
     both, wall ms/step, capture time, graph launches per step, peak
     memory and a profile of each, and one warm eager step under
     sync-debug mode "error";
  7. row gather: the three row-gather kernels against their plain
     version, bit for bit, at the probe's shape (f32, bf16; int32), at
     the multi-scale model's sender gathers (f32, bf16; int64, the
     graph's own indices) and at ragged sizes with clamped indices; then
     each timed beside ``index_select`` and its bound (device time: the
     calls captured in one CUDA graph, its replay between CUDA events;
     and the same calls launched one by one from the host);
  8. probe: the ported gather probe (``sgnn_tpu_torch.scripts.
     gather_kernel_probe``) in bf16 and f32, counting each kernel's
     launches;
  9. multi-scale rollout: ``train_multi_scale.main`` in rollout mode at
     the values of configs/taylor2d_multi_scale.yaml (10 M2M layers,
     hidden 128) from a checkpoint of seeded initial weights, for the
     dense layout (``ms_dense: auto``) in f32 and bf16 and for COO in
     f32; each run must launch ``row_gather`` exactly 2 x (blocks) per
     step (and the sorted sum once per block: the aggregation); the f32
     runs' first steps are held against the same rollout on the CPU, the
     bf16 run's first forward against the CPU's within twice the CPU's own
     bf16-vs-f32 gap; the rollouts are captured as in 6, and each run's
     captured route is held against its eager one as there, every layout
     with torch.equal over the whole trajectory (no sum adds with atomics);
 10. multi-scale training: ``train_multi_scale.main`` in train mode at the
     same values, dense f32 and dense bf16 for 20 steps and COO f32 for 10,
     prefetched and captured as in 5, each launching the take kernel and
     the sorted and planned kernels exactly as the graph asks (per step
     and block: 2 gathers forward and one per backward of a sorted sum or
     of the COO sender order; a sorted sum per aggregation and per
     receiver backward, and per COO sender backward; a planned backward
     per dense block; per validation rollout step: 2 gathers and one
     sorted sum per block); metrics, checkpoint, and ``training_routes``
     as in 5 (COO: the eager step twice). Then one dense f32 and one dense
     bf16 step at full width on 2 samples against the same step on the
     CPU (STEP_TOL), and both backward kernels against their plain
     versions at the model's shapes (dense and COO batches), at
     GraphCast_small's g2m receivers (1 degree grid, mesh level 5: a pole's
     594-id runs on 2 KB rows) and at ragged sizes (a run of 5,003 ids,
     runs across the sorted sum's chunks), each
     launched twice and bit-identical to its plain version, timed beside
     the index_add_ route and their bound.

 11. parallel runs, one process driving a mesh that names the one card
     twice (two replicas or two shards on it, real exchanges and
     reductions, each step one CUDA graph): config A with
     ``data_parallel: 2`` through ``train`` for 20 steps (launches twice
     A's per step), one step against the single-device step (STEP_TOL),
     the same step inside a one-process NCCL group (``multihost.
     initialize``) equal to it without (torch.equal), captured against
     eager and two eager runs (``training_routes``); the multi-scale model
     (dense f32, batch 16) with ``data_parallel: 2``: one step against one
     device, captured against eager; config A with ``graph_parallel: 2``
     (batch 1) through ``train`` (halo violations and rejections printed),
     its first step against one device at the JAX tests' tolerances
     (GP_TOL), captured against eager, ``predict`` partitioned against
     the single-device rollout (GP_ROLLOUT_TOL) and the replanning
     rollout's captured route against its eager one; config B (bf16,
     symmetric gather) with ``graph_parallel: 2`` on a second bar of 28,796
     particles (the sharded symmetric route: 14,400 local rows) through
     ``train`` for 3 steps, its first step against one device (GP_SYM_TOL),
     captured against eager; the multi-scale model (taylor2d_multi_scale.
     yaml's values) with ``graph_parallel: 2``, batch 1, dense f32 and COO
     f32, through ``train`` for 20 steps validating at 10 and 20 through
     the partitioned host rollout, each kernel launched as the plan asks,
     the first step against the one-device step on the same x-sorted
     layout (GP_MS_TOL: the loss, every parameter after Adam, the
     forward), captured against eager, the partitioned rollout of the
     validation trajectory against the one-device captured rollout on the
     same layout (GP_MS_ROLLOUT_TOL) and its captured route against its
     eager one (torch.equal), the plan's slab, halo and per-type sizes;
     dense bf16: one step against one device (GP_MS_TOL). Launch counters
     are set to 0 before each route; one ``parallel {...}`` JSON line;
 12. capacity knobs: the native radius search (built with g++) against
     cKDTree on the dataset's first frame; config A's captured training
     step at full width for every remat mode (``False``, ``"xj"``,
     ``"xj_msg"``, ``"full"``, ``"group"``) on one staged batch, equal to
     ``False`` and to its own eager step (torch.equal: metrics, gradients,
     parameters, Adam), with the launches per step of REMAT_LAUNCHES, peak
     memory of the capturing and replaying calls, busy time through
     ``utils/profiling``; B's packed gather against the unfused route
     (torch.equal, and both captured steps timed in one call: RACE_REPS);
     B with ``band_nodes`` from the data through ``train``
     (0 violations, the reverse gathers banded, gradients equal to no
     band) and with a lowered band (counted, warned about, the card's
     banded gather equal to the clamp formula on the CPU); ``train`` of A
     with ``debug_graph``, ``remat: "full"`` and a band, then ``predict``;
     GP A with remat (against one device, captured against eager) and GP
     B's packed symmetric route with a band (against one device; a lowered
     band rejects the step); the capacity point, 614,400 particles
     (CAPACITY_POINT) with B's values and a band from the lattice, one
     captured step for remat ``False`` and ``"full"`` (torch.equal), its
     banded gathers counted, and the packed route timed against the
     unfused one at batches 1 and 2 (614,400 and 1,228,800 nodes;
     torch.equal). One ``capacity {...}`` JSON line;
 13. the edge stage's epilogue kernels (``csrc/edge_epilogue.cu``):
     their launches per step of the trainer's captured step
     (``epilogue_launches``: MeshGraphNets at its published widths 30
     and 30, the dense f32 multi-scale model one each per dense edge set,
     config A none), then checked against the composite they replace
     (new_e, agg and g_o to their limits, g_e exactly, the parameter
     gradients to EPILOGUE_SUM_RTOL of their terms; two runs bit for bit)
     and timed against their bytes bound at the training configurations'
     shapes (``phase_edge_epilogue``: one ``edge_epilogue <shape> {...}``
     line each). Phases 9-11 hold their launches on every multi-scale
     route (dense f32: one a block; bf16 and COO: none). The f32 product
     kernels' launches per step of the same three models are held too
     (one forward and one weight gradient per product a step), and of a
     small GraphCast built by the trainer (10 degree grid, mesh level 2,
     latent 32, 2 layers; no epilogue launch), held to its count of
     products exactly (``graphcast_products``).
 14. The f32 product kernels (``csrc/f32_product.cu``) at the cells'
     shapes: checked through ``ops/f32_product.linear`` under autograd
     (strided rows, a [2, M/2, K] input, a transposed weight or its row
     block) against f64 and two runs bit for bit, then timed in captured
     CUDA graphs against their bound and ``torch.matmul``
     (``phase_f32_product``: one ``f32_product <shape> {...}`` line
     each), GraphCast_small's K and N to 512 among them. Phases 5, 6 and 9-12 zero the kernels' counters before their
     runs and record the launches by kind; every f32 training run of 5
     and 10 is held to P forwards and P weight gradients per training
     step, whole numbers per validation step, and its captured route's
     launches per step; every f32 rollout of 6 and 9 to a whole number of
     forwards per step and no backward.

The last lines are the training routes of 5 and 10 (one ``train routes
{...}`` JSON line), the rollout routes of 6 and 9 (one ``routes {...}``
JSON line), the kernel summary (JSON; the parallel routes' and phase 12's
launches under ``launches_by_path``), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --only row_gather_bwd
    python3 chip_smoke.py --only parallel
    python3 chip_smoke.py --only capacity
    python3 chip_smoke.py --only edge_epilogue
    python3 chip_smoke.py --only f32_product

run phases 1, 2, 4 and the backward kernels' checks and times of 10 (one
``bwd {...}`` JSON line), phase 11 (its ``parallel {...}`` line), phase
12 (its ``capacity {...}`` line), phase 13 (its ``edge_epilogue
{...}`` line) or phase 14 (its ``f32_product <shape> {...}`` lines),
alone.
"""

from __future__ import annotations

import dataclasses
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
# forward only, (R, K, D, H): ragged tiles of the tensor-core kernel (K
# dividing no tile, R*K below one tile, widths not a multiple of 16, rows
# loaded element by element, K = 128), D != H, and the warp-per-receiver
# kernel beyond the tile's width of 64
FWD_SHAPES = [(301, 7, 64, 64), (9, 7, 64, 64), (200, 8, 40, 40), (50, 7, 21, 21), (5, 128, 64, 64),
              (300, 8, 48, 64), (300, 8, 64, 40), (37, 3, 96, 96), (300, 8, 128, 128)]
# forward. f32: the tolerance of tests/test_pallas_edge_block.py (sums of
# 64 products taken in another order). bf16: the outputs carry 8
# significant bits, so an f32 sum in another order can flip the rounding
# of an output (2^-7 relative) or of a message |msg| < 8 (up to 2^-5) that
# then enters agg.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-4, 2.0**-7)}  # (atol, rtol)
# f32 agg sums a receiver's K messages, each within the forward's f32 error;
# the tensor-core kernel's errors share a lean (the card's agg error at
# K = 128 is several times its CPU emulation's, which rounds every sum to
# nearest), so they add up with K. TOL holds up to the 20 slots it was set
# on; past them agg's f32 atol grows as K / 20 (6.4e-5 at K = 128, inside
# the backward's 1e-4). check_fwd reports both sides' errors against an f64
# run of the plain version.
AGG_TOL_SLOTS = 20


def fwd_tol(dtype_name, name, k):
    atol, rtol = TOL[dtype_name]
    if name == "agg" and dtype_name == "float32":
        atol *= max(1.0, k / AGG_TOL_SLOTS)
    return atol, rtol

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
# through 5 layers, positions of |x| < 64 carry an f32 ulp of 7.6e-6. The
# multi-scale rollout is held to the same: its sums run through 12 blocks of
# 3-layer MLPs at width 128 (the GEMMs sum in another order on the card),
# but positions move by the normalised acceleration times acc_std, so the
# outputs' f32 rounding (|x| < 64, strain O(1)) sets the error.
ROLLOUT_TOL = (1e-4, 1e-4)
ROLLOUT_CHECK_STEPS = 3
# dense bf16 multi-scale forward, card vs CPU: the CPU's bf16 forward lies
# its bf16-vs-f32 gap from the f32 result and the card's about as far, so
# by the triangle inequality the two lie within twice the gap of each
# other. Measured on the H100: 0.47 (acceleration) and 0.43 (strain) of
# the gap, so one side's roundings do not all land where the other's do.
BF16_GAP_FACTOR = 2.0
# one training step on the card vs on the CPU at full width. A (f32): sums
# in another order through 5 layers and their backward, ReLU gates whose h lies within
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
# MS_f32 (multi-scale, dense f32, 12 blocks of 3-layer MLPs at width 128):
# A's limits; its gathers' backwards and its aggregations add in one fixed
# order on both sides, the products sum in another order on the card.
# MS_bf16: both sides round the edge tensors to bf16 op by op, at the same
# ops; an f32 sum in another order flips a rounding now and then, and the
# sums over every edge (the edge MLPs' bias gradients) cancel down to small
# results, so each gradient's limit is 1e-2 of its scale plus BF16_GAP_FACTOR
# times the CPU's own bf16-vs-f32 gap in that tensor (the CPU test of the
# step against JAX takes the same rule: tests/test_torch_port_ms_train.py).
STEP_TOL = {
    "A": dict(loss_rtol=1e-4, grad_rel=1e-3, param_atol=1e-7, param_rtol=2.0**-22, update_rtol=1e-5),
    "B": dict(loss_rtol=2e-4, grad_rel=5e-3, param_atol=1e-7, param_rtol=2.0**-22, update_rtol=1e-5),
    "MS_f32": dict(loss_rtol=1e-4, grad_rel=1e-3, param_atol=1e-7, param_rtol=2.0**-22, update_rtol=1e-5),
    "MS_bf16": dict(loss_rtol=1e-2, grad_rel=1e-2, param_atol=1e-7, param_rtol=2.0**-22, update_rtol=1e-5),
}
# graph-parallel against one device, the JAX tests' tolerances: the first
# training step (tests/test_edge_partition.py:242-247: loss rtol 2e-4,
# gradients rtol 5e-3 atol 1e-5); the symmetric sharded route's gradients
# (:573-574: rtol 2e-4, atol 1e-6; its loss to :242's); the rollout
# (:284-289: positions rtol 1e-3 atol 2e-4; strain and the cumulative RMSE
# rtol 1e-3 atol 1e-5): (rtol, atol)
GP_TOL = dict(loss_rtol=2e-4, grad_rtol=5e-3, grad_atol=1e-5)
GP_SYM_TOL = dict(loss_rtol=2e-4, grad_rtol=2e-4, grad_atol=1e-6)
# config B itself (bf16 edge tensors): a halo row's gradient is the sum of
# two bf16 partial sums, its own shard's and its neighbour's, where one
# device rounds one sum, so a boundary row's d_proj_j moves by a bf16
# rounding (2^-8): B's step tolerance (STEP_TOL["B"]: loss 2e-4 relative,
# each gradient 5e-3 of its largest entry plus 5e-3 relative)
GP_SYM_BF16_TOL = dict(loss_rtol=STEP_TOL["B"]["loss_rtol"], grad_rtol=STEP_TOL["B"]["grad_rel"],
                       grad_atol_rel=STEP_TOL["B"]["grad_rel"])
GP_ROLLOUT_TOL = {"predicted_rollout": (1e-3, 2e-4), "predicted_strain": (1e-3, 1e-5),
                  "rmse_position": (1e-3, 1e-5)}
# the multi-scale graph partition against one device, tests/test_ms_partition.py's
# tolerances: the first step's loss (:169-170, rtol 2e-4) and parameters after
# Adam (COO :171, rtol 5e-3 atol 1e-5; dense :432-433, rtol 2e-4 atol 1e-6),
# the forward (:95-100, rtol 2e-4 atol 2e-5; bf16 :313-318, rtol 0.05 atol
# 0.02), the rollout (:276-285): (rtol, atol). The parameters after Adam
# are held to their limit with what Adam's first step makes of the two
# gradients added (``adam_step_report``): at full width some gradients lie
# near Adam's eps, where their last bits move the update by a share of lr
# (dense f32 on the H100: an entry 1.18e-5 apart, over the bare 1e-6 +
# 2e-4 |p|, its gradients -1.31e-9 and -1.46e-9). The gradients take
# STEP_TOL's rule for sums in another order at this width (``compare_steps``):
# in the COO step one entry of the prediction head's first weight lies 4.1e-5
# apart (of the tensor's 0.457), a discrete gap such as a ReLU gate within
# rounding of 0 at one node gives
GP_MS_TOL = {
    "dense_f32": dict(loss_rtol=2e-4, param=(2e-4, 1e-6), forward=(2e-4, 2e-5), grad_rel=STEP_TOL["MS_f32"]["grad_rel"]),
    "coo_f32": dict(loss_rtol=2e-4, param=(5e-3, 1e-5), forward=(2e-4, 2e-5), grad_rel=STEP_TOL["MS_f32"]["grad_rel"]),
    "dense_bf16": dict(loss_rtol=0.05, param=(0.05, 0.02), forward=(0.05, 0.02),
                       grad_rel=STEP_TOL["MS_bf16"]["grad_rel"]),
}
GP_MS_ROLLOUT_TOL = {"predicted_rollout": (1e-3, 2e-4), "rmse_position_per_step": (1e-3, 1e-5)}
# the symmetric sharded route runs at >= 12,288 local rows
# (edge_partition._SYM_MIN_LOCAL_ROWS): a second bar of 28,796 particles, 2
# shards of 14,400 rows; 20 frames per run (60 raw steps, 40 kept)
GP_SYM_MIN_LOCAL_ROWS = 12_288
GP_BIG_BAR = dict(nx=240, ny=120, num_steps=60)
GP_BIG_BAR_KEPT_STEPS = 40
GP_SYM_STEPS = 3
TRAIN_STEPS, SAVE_EVERY, LOG_EVERY = 20, 10, 10
PROFILE_STEPS = 3
# training_routes: steps per route on batches staged beforehand: warm (the
# captured route's first is its warm-up and capture), timed, PROFILE_STEPS
# profiled, and one under sync-debug mode "error"
ROUTE_WARM_STEPS, ROUTE_TIMED_STEPS = 2, 3
C2_TIMING_ITERS = 20  # c2_cost: per-step sender gathers captured in one CUDA graph
PROFILE_ROLLOUT_STEPS = 10
# the CUDA API calls (cuda* and cu*) by which the host launches work, counted in profiles
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync")
FIXED_BATCH_STEPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor f32; bf16 tensor
# the gather probes of scripts/gather_kernel_probe.py: tbl [38384, 64] f32,
# idx [307008] i32
GATHER_SHAPE = (38384, 64, 307008)
GATHER_TIMING_ITERS = 200
# the multi-scale model: configs/taylor2d_multi_scale.yaml (its data_path
# is the synthetic dataset built here)
MS_MODEL = dict(
    num_scales=2, window_size=2, radius_multiplier=2.0, layers=10, hidden_dim=128, dim=2,
    particle_type_embedding_size=9, input_sequence_length=11, connection_radius=0.6, batch_size=16,
    noise_std=0.02, lr_init=0.001, lr_decay=0.1, lr_decay_steps=15000, inference_mode="autoregressive",
    pad_multiple=128, edge_pad_multiple=4096, seed=0,
)
# name: (ms_dense, compute_dtype); "auto" picks the dense layout at this scale
MS_RUNS = {"dense_f32": ("auto", "float32"), "dense_bf16": ("auto", "bfloat16"), "coo_f32": (False, "float32")}
# multi-scale training (phase 10): name -> (ms_dense, compute_dtype, steps, log_every)
MS_TRAIN_RUNS = {"dense_f32": ("auto", "float32", TRAIN_STEPS, LOG_EVERY),
                 "dense_bf16": ("auto", "bfloat16", TRAIN_STEPS, LOG_EVERY),
                 "coo_f32": (False, "float32", 10, 5)}  # logs steps 6-10: the warm step time

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


def compare_fwd(eb, args, k, dtype_name, where, exact=False):
    """Max |err| of the kernel's new_e and agg against the plain version
    on ``args``; raises beyond the tolerance. With ``exact``, also
    returns the max |err| of agg, the kernel's and the plain version's,
    against the plain version run in f64."""
    import torch

    got = eb.edge_block_fwd(*args, k)
    want = eb.fused_edge_block_reference(*args, k)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("new_e", "agg"), got, want):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"edge_block_fwd {where} {name}: bad output")
        atol, rtol = fwd_tol(dtype_name, name, k)
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if (err > atol + rtol * b.abs()).any():
            raise AssertionError(f"edge_block_fwd {where} {name}: max |err| {float(err.max()):.3e} "
                                 f"beyond atol {atol} + rtol {rtol}")
    if not exact:
        return worst
    agg64 = eb.fused_edge_block_reference(*[a.double() for a in args], k)[1]
    return worst, {side: float((t.double() - agg64).abs().max()) for side, t in
                   (("kernel", got[1]), ("plain", want[1]))}


def fwd_variant(eb, k, d, h):
    """The forward kernel the shape rule of csrc/edge_block_fwd.cu picks."""
    return "tensor_core" if max(d, h) <= eb.MAX_BWD_WIDTH and k <= eb.MAX_BWD_K else "warp"


def check_fwd(eb, dtype_name):
    worst = 0.0
    shapes = [(r, k, d, d) for r, k, d in SHAPES] + FWD_SHAPES
    for si, (r, k, d, h) in enumerate(shapes):
        args = edge_inputs(r, k, d, h, dtype_of(dtype_name), seed=si, device="cuda")
        before = dict(eb.FWD_VARIANT_LAUNCHES)
        err, agg_vs_f64 = compare_fwd(eb, args, k, dtype_name, f"{dtype_name} {(r, k, d, h)}", exact=True)
        worst = max(worst, err)
        ran = [v for v in before if eb.FWD_VARIANT_LAUNCHES[v] != before[v]]
        if ran != [fwd_variant(eb, k, d, h)]:
            raise AssertionError(f"edge_block_fwd {dtype_name} {(r, k, d, h)}: launched {ran}, "
                                 f"expected {fwd_variant(eb, k, d, h)}")
        log(f"kernel edge_block_fwd {dtype_name} R,K,D,H={r},{k},{d},{h} ({ran[0]}): ok, max |err| {err:.3e} "
            f"(so far {worst:.3e}); agg vs an f64 run: kernel {agg_vs_f64['kernel']:.3e}, "
            f"plain {agg_vs_f64['plain']:.3e}")
    return worst, shapes


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
        fwd_err, fwd_shapes = check_fwd(eb, dtype_name)
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
            checked_shapes=[*fwd_shapes, (r, k, d, d)],
            tol={"atol": TOL[dtype_name][0], "rtol": TOL[dtype_name][1],
                 "agg_atol": f"atol * max(1, K / {AGG_TOL_SLOTS})" if dtype_name == "float32" else "atol"},
            at_rollout_shape=roll,
        )
        log(f"time edge_block_fwd {dtype_name} R,K,D={r},{k},{d}: kernel {fwd['ms'] * 1e3:.2f} us, "
            f"plain {fwd['plain_ms'] * 1e3:.2f} us, bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']}, "
            f"{fwd['bound_ms'] / fwd['ms']:.3f} of the kernel's time); "
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
            f"plain {bwd['plain_ms'] * 1e3:.2f} us, bound {bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']}, "
            f"{bwd['bound_ms'] / bwd['ms']:.3f} of the kernel's time)")
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
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.train import train as trainer
    from sgnn_tpu_torch.train.train import simulator_config_from, train

    cfg = train_config(root, data, name)
    sim_cfg = simulator_config_from(cfg, load_metadata(data))
    valid = TrajectoryLoader(data / "valid.npz", pad_multiple=cfg.pad_multiple)
    nodes = TrajectoryLoader(data / "train.npz", pad_multiple=cfg.pad_multiple).num_nodes
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    layers = cfg.layers
    ordered = 0 if sim_cfg.symmetric_gather else layers * TRAIN_STEPS  # A's sender gathers, one per layer
    # B's packed gather: one take launch per training step and per validation rollout step
    packed = TRAIN_STEPS + val_steps * (TRAIN_STEPS // SAVE_EVERY) if sim_cfg.symmetric_gather else 0
    expect = dict(bwd=layers * TRAIN_STEPS,
                  fwd=layers * TRAIN_STEPS + layers * val_steps * (TRAIN_STEPS // SAVE_EVERY),
                  sym_bwd=layers * TRAIN_STEPS if sim_cfg.symmetric_gather else 0,
                  take=2 * ordered + packed, sorted=ordered)  # the take kernel forward and over the order backward
    log(f"train {name} ({cfg.compute_dtype}): batch {cfg.batch_size}, K={sim_cfg.slots}, "
        f"symmetric_gather={sim_cfg.symmetric_gather}, domain {sim_cfg.domain}")

    torch.cuda.synchronize()
    eb.LAUNCHES = eb.BWD_LAUNCHES = sg.BWD_CALLS = 0
    reset_fwd_variant_launches()
    reset_gather_launches()
    reset_bwd_gather_launches()
    reset_f32_product_launches()
    t0 = time.perf_counter()
    result = train(cfg)  # the port's entry point, on CUDA by default: prefetched, captured
    got = dict(fwd=eb.LAUNCHES, bwd=eb.BWD_LAUNCHES, sym_bwd=sg.BWD_CALLS, take=rg.LAUNCHES[rg.MODEL_VARIANT],
               sorted=rg.BWD_LAUNCHES["sorted"])
    products = f32_product_counts()
    variants = dict(eb.FWD_VARIANT_LAUNCHES)
    wall_s = time.perf_counter() - t0
    if got != expect:
        raise AssertionError(f"train {name}: launches {got}, expected {expect}")
    if variants != {"tensor_core": expect["fwd"], "warp": 0}:
        raise AssertionError(f"train {name}: edge_block_fwd launches by kernel {variants}, expected "
                             f"only the tensor-core kernel's {expect['fwd']}")
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
        fwd_launches_by_kernel=variants, f32_product_launches=products,
        ms_per_step_11_20=train_rec[-1]["train/step_time_s"] * 1e3,
        ms_per_step_1_10=train_rec[0]["train/step_time_s"] * 1e3,
        train_loss=[r["train/loss"] for r in train_rec], val_loss=[r["val/loss"] for r in val_rec],
        checkpoint=meta["path"], wall_s=wall_s, device=kind, nvidia_smi=smi,
    )
    out["routes"] = training_routes(f"train {name}", cfg, torch.device("cuda", torch.cuda.current_device()),
                                    trainer, repeat_eager=not sim_cfg.symmetric_gather)
    if cfg.compute_dtype == "float32":
        out["f32_products"] = f32_products_of_training(
            f"train {name}", products, TRAIN_STEPS, val_steps * (TRAIN_STEPS // SAVE_EVERY),
            out["routes"]["captured"]["launches_per_step"])
    log(f"train {name} " + json.dumps(out))
    return out, cfg, meta["path"]


def _clone(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


def _launch_counts():
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.ops import edge_epilogue as ee
    from sgnn_tpu_torch.ops import f32_product as fp
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.ops import sym_gather as sg

    return dict(edge_block_fwd=eb.LAUNCHES, edge_block_bwd=eb.BWD_LAUNCHES, sym_gather_bwd=sg.BWD_CALLS,
                take=rg.LAUNCHES[rg.MODEL_VARIANT], sorted=rg.BWD_LAUNCHES["sorted"],
                planned=rg.BWD_LAUNCHES["planned"], epilogue_fwd=ee.LAUNCHES, epilogue_bwd=ee.BWD_LAUNCHES,
                **{f"f32_product_{k}": v for k, v in fp.LAUNCHES.items()})


EPILOGUE_KEYS = ("epilogue_fwd", "epilogue_bwd")


def reset_epilogue_launches():
    from sgnn_tpu_torch.ops import edge_epilogue as ee

    ee.LAUNCHES = ee.BWD_LAUNCHES = 0


def epilogue_counts() -> dict:
    counts = _launch_counts()
    return {k: counts[k] for k in EPILOGUE_KEYS}


F32_PRODUCT_KEYS = ("f32_product_fwd", "f32_product_dgrad", "f32_product_wgrad")


def reset_f32_product_launches():
    from sgnn_tpu_torch.ops import f32_product as fp

    for k in fp.LAUNCHES:
        fp.LAUNCHES[k] = 0


def f32_product_counts() -> dict:
    counts = _launch_counts()
    return {k: counts[k] for k in F32_PRODUCT_KEYS}


def f32_products_of_training(where: str, got: dict, steps: int, rollout_steps: int, route: dict) -> dict:
    """The f32 product kernels' launches of an f32 training run: per training
    step P forwards and P weight gradients (one each per product) and D input
    gradients (0 < D <= P: the encoders' first Linears read features), per
    validation rollout step V forwards, all whole numbers; P, D and the
    captured route's launches per step (``training_routes``) agree."""
    fwd, dgrad, wgrad = (got[k] for k in F32_PRODUCT_KEYS)
    per = dict(products_per_train_step=wgrad / steps, dgrad_per_train_step=dgrad / steps,
               fwd_per_rollout_step=(fwd - wgrad) / rollout_steps if rollout_steps else fwd - wgrad)
    whole = all(v == int(v) and v >= (1 if rollout_steps or k != "fwd_per_rollout_step" else 0)
                for k, v in per.items())
    p, d = per["products_per_train_step"], per["dgrad_per_train_step"]
    by_route = [route[k] for k in F32_PRODUCT_KEYS]
    if not whole or d > p or by_route != [p, d, p]:
        raise AssertionError(f"{where}: f32_product launches {got} over {steps} training and {rollout_steps} "
                             f"rollout steps ({per}); the captured route's per step {by_route}")
    return per


def f32_products_of_rollout(where: str, got: dict, steps: int) -> float:
    """The f32 product kernels' forwards per rollout step (a whole number, no backward)."""
    per = got["f32_product_fwd"] / steps
    if per != int(per) or per < 1 or got["f32_product_dgrad"] or got["f32_product_wgrad"]:
        raise AssertionError(f"{where}: f32_product launches {got} over {steps} rollout steps")
    return per


def training_routes(where, cfg, device, trainer, repeat_eager=False, devices=None):
    """The captured training step against the eager one (``capture=False``),
    each from the seeded start of ``trainer.build_training(cfg)`` (the same
    weights and noise stream) on the same batches staged beforehand:
    ROUTE_WARM_STEPS steps (the captured route's first: its warm-up step
    and the capture), ROUTE_TIMED_STEPS timed (host clock around steps
    ending in a sync), PROFILE_STEPS under torch.profiler, and one under
    sync-debug mode "error". Captured equals eager with torch.equal: every
    metric of every warm step and of the last step of each phase, every
    parameter, Adam's moments and step counts; ``repeat_eager``: a second
    eager run equals the first too (determinism). Per route: the kernel
    launches per step (equal on both), wall, device busy and idle share,
    kernels and host calls per step, peak memory of the first call (the
    capturing call) and of the timed steps, and the capture's host time.
    ``devices``: the mesh of a parallel run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    built = trainer.build_training(cfg, device, devices=devices)
    source = built.epochs()
    n_steps = ROUTE_WARM_STEPS + ROUTE_TIMED_STEPS + PROFILE_STEPS + 1
    batches = [trainer.batch_to_device(next(source), device) for _ in range(n_steps)]
    del built, source

    def run(capture):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        built = trainer.build_training(cfg, device, devices=devices)
        step_fn = built.step_fn
        step_fn.capture = capture
        before, metrics = _launch_counts(), []
        steps = iter(enumerate(batches))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(ROUTE_WARM_STEPS):
            i, b = next(steps)
            metrics.append(_clone(step_fn(b, i)))
            if i == 0:  # the captured route's first call: the warm-up step and the capture
                torch.cuda.synchronize()
                first_s, first_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e6
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(ROUTE_TIMED_STEPS):
            i, b = next(steps)
            m = step_fn(b, i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ROUTE_TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e6
        metrics.append(_clone(m))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                i, b = next(steps)
                m = step_fn(b, i)
            torch.cuda.synchronize()
        metrics.append(_clone(m))
        i, b = next(steps)
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = step_fn(b, i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        metrics.append(_clone(m))
        res = dict(wall_ms_per_step=wall_ms, first_call_s=first_s, first_call_peak_memory_mb=first_peak,
                   peak_memory_mb=peak, launches_per_step={k: (v - before[k]) / n_steps
                                                           for k, v in _launch_counts().items()})
        res.update(device_profile(prof, PROFILE_STEPS, wall_ms))
        if capture:
            if step_fn.graph is None or step_fn.replays != n_steps - 1:
                raise AssertionError(f"{where}: the captured route replayed {step_fn.replays} steps, "
                                     f"expected {n_steps - 1}")
            res.update(capture_s=step_fn.capture_seconds, replays=step_fn.replays)
        state = (metrics, _clone(built.sim.state_dict()),
                 [_clone(st) for st in built.optimizer.state.values()])
        step_fn.close()
        del built, step_fn
        torch.cuda.empty_cache()
        return res, state

    def same(a, b):
        (ma, pa, sa), (mb, pb, sb) = a, b
        return (all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(ma, mb))
                and all(torch.equal(v, pb[k]) for k, v in pa.items())
                and len(sa) == len(sb) and all(all(torch.equal(x[k], y[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
                                               for x, y in zip(sa, sb)))

    out, states = {}, {}
    for name, capture in [("captured", True), ("eager", False)] + ([("eager_again", False)] if repeat_eager else []):
        out[name], states[name] = run(capture)
    for name in states:
        if out[name]["launches_per_step"] != out["eager"]["launches_per_step"]:
            raise AssertionError(f"{where}: {name} launches per step {out[name]['launches_per_step']}, eager "
                                 f"{out['eager']['launches_per_step']}")
        if not same(states[name], states["eager"]):
            raise AssertionError(f"{where}: {name} training differs from the eager one (torch.equal on the "
                                 "metrics, parameters and Adam's state)")
    out["check"] = ("torch.equal: metrics, parameters, Adam's moments and steps after "
                    f"{len(batches)} steps; " + ", ".join(n for n in states if n != "eager") + " vs eager")
    out["steps"] = len(batches)
    log(f"{where} routes: captured {out['captured']['wall_ms_per_step']:.3f} ms/step "
        f"(capture {out['captured']['capture_s']:.3f} s), eager {out['eager']['wall_ms_per_step']:.3f} ms/step; "
        f"{out['check']}: ok; warm steps sync-free")
    return out


def device_profile(prof, steps, wall_ms_step):
    import torch

    # device events, less the user annotations the profiler may also put on
    # the device timeline (Adam's `Optimizer.step#Adam.step` range): no kernels
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return {"device_ms_per_step": "not measured (the profiler recorded no device time)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    device_ms = busy_us / 1e3 / steps
    return {
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms_step,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        # what the host asked of the runtime: kernel and graph launches, copies
        "host_calls_per_step": {e.key: e.count / steps for e in prof.key_averages() if e.key in HOST_LAUNCH_CALLS},
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


def compare_steps(where, card, cpu, step_tol, lr, gaps=None):
    """Loss and metrics, every gradient and every parameter after Adam of
    one step on the card against the same step on the CPU, to
    ``step_tol``. ``gaps`` ({param: the CPU's own bf16-vs-f32 gradient
    gap, its largest entry}) widens each gradient's limit by
    ``BF16_GAP_FACTOR`` times it. Returns the worst errors."""
    import torch

    worst = dict(loss_rel=0.0, grad_rel=0.0, param=0.0, param_over_allowed=0.0, sign_flips=0)
    for k, v in cpu["metrics"].items():
        rel = abs(card["metrics"][k] - v) / max(abs(v), 1e-30)
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        if rel > step_tol["loss_rtol"]:
            raise AssertionError(f"{where}: {k} {card['metrics'][k]} vs {v}")
    for k, g_cpu in cpu["grads"].items():
        g_card = card["grads"][k]
        tol = step_tol["grad_rel"] * (float(g_cpu.abs().max()) + g_cpu.abs())
        if gaps is not None:
            tol = tol + BF16_GAP_FACTOR * gaps[k]
        err = (g_card - g_cpu).abs()
        worst["grad_rel"] = max(worst["grad_rel"], float(err.max()) / max(float(g_cpu.abs().max()), 1e-30))
        if (err > tol).any():
            raise AssertionError(f"{where}: grad {k} max |err| {float(err.max()):.3e}")
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
            raise AssertionError(f"{where}: param {k} max |err| {float(perr.max()):.3e}")
        if torch.equal(card["params"][k], card["before"][k]):
            raise AssertionError(f"{where}: param {k} did not move")
    return worst


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
    worst = compare_steps(f"card vs CPU step {name}", card, cpu, step_tol, cfg.lr_init + 1e-6)  # lr = sched(0)
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


def c2_cost(cfg, device):
    """What config A's deterministic sender gathers cost per training step
    (``cfg.layers`` of them) against index_select's, on the graph of one
    full A batch (searched on the card as forward_batched does), each
    route's calls captured in one CUDA graph and its replay timed (device
    time): the old route, index_select forward and index_add_ (its
    backward, float atomics) per layer; the new one, one stable sort of the
    senders per step, then per layer the take kernel forward, the take
    kernel over the order and the sorted sum backward. The new backward
    repeats bit for bit and lies within f32 rounding of index_add_'s
    (K * 2^-23 of sum|terms|)."""
    import torch

    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.ops.neighbors import radius_neighbors_grid_batched
    from sgnn_tpu_torch.scripts.gather_kernel_probe import time_ms as graph_time_ms
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
    r, k = nl.senders.shape
    senders, width, layers = nl.senders.reshape(-1), sim_cfg.latent_dim, cfg.layers
    g = torch.Generator(device=device).manual_seed(5)
    table = torch.randn(r, width, generator=g, device=device)
    cot = torch.randn(r * k, width, generator=g, device=device) * nl.mask.reshape(-1, 1)  # 0 at padded slots

    def old():
        for _ in range(layers):
            table.index_select(0, senders)
            torch.zeros(r, width, device=device).index_add_(0, senders, cot)

    def sort():
        return torch.sort(senders.int(), stable=True)

    def new():
        sorted_s, order = sort()
        for _ in range(layers):
            rg.row_gather(table, senders)
            rg.sorted_segment_sum(rg.row_gather(cot, order), sorted_s, r)

    sorted_s, order = sort()
    got = rg.sorted_segment_sum(rg.row_gather(cot, order), sorted_s, r)
    again = rg.sorted_segment_sum(rg.row_gather(cot, sort()[1]), sorted_s, r)
    want = torch.zeros(r, width, device=device).index_add_(0, senders, cot)
    abs_sum = torch.zeros(r, width, device=device).index_add_(0, senders, cot.abs())
    err = (got - want).abs()
    if not torch.equal(got, again) or (err > k * 2.0**-23 * abs_sum).any():
        raise AssertionError(f"c2 cost: the sorted sender backward repeats: {torch.equal(got, again)}; "
                             f"max |err| vs index_add_ {float(err.max()):.3e}")
    runs = {name: [] for name in ("old", "new", "sort")}
    for name in ("old", "new", "sort", "sort", "new", "old"):
        runs[name].append(graph_time_ms({"old": old, "new": new, "sort": sort}[name], C2_TIMING_ITERS, device))
    out = {name: sum(v) / len(v) for name, v in runs.items()}
    out = dict(index_select_route_ms_per_step=out["old"], sorted_route_ms_per_step=out["new"],
               sort_ms_per_step=out["sort"], extra_ms_per_step=out["new"] - out["old"], runs_ms=runs,
               receivers=r, slots=k, width=width, layers=layers, edges=int(nl.mask.sum()),
               max_abs_err_vs_index_add=float(err.max()), repeats_bitwise=True)
    log("c2 cost (A's sender gathers per step) " + json.dumps(out))
    return out


def run_rollout(root: Path, data: Path, train_cfg, model_file: str, smi: str, kind: str):
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_metadata
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.physics.rollout import rollout, rollout_step
    from sgnn_tpu_torch.physics.simulator import make_norm_stats, simulator_init
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
    reset_fwd_variant_launches()
    reset_f32_product_launches()
    take0 = rg.LAUNCHES["take"]
    summary = predict(cfg)  # the port's entry point, on CUDA by default: its step captured and replayed
    launches, bwd_launches = eb.LAUNCHES, eb.BWD_LAUNCHES
    products = f32_product_counts()
    take = rg.LAUNCHES["take"] - take0
    if take != (steps if sim_cfg.symmetric_gather else 0):  # the packed gather, once per step
        raise AssertionError(f"rollout: the take kernel launched {take} times over {steps} steps")
    variants = dict(eb.FWD_VARIANT_LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    if launches != expected or bwd_launches != 0:
        raise AssertionError(f"rollout: edge_block_fwd launched {launches} times (expected {expected}), "
                             f"edge_block_bwd {bwd_launches}")
    if variants != {"tensor_core": expected, "warp": 0}:
        raise AssertionError(f"rollout: edge_block_fwd launches by kernel {variants}, expected only the "
                             f"tensor-core kernel's {expected}")
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
        fwd_launches_by_kernel=variants, take_launches=take, f32_product_launches=products,
        f32_products_per_step=(f32_products_of_rollout("rollout", products, steps)
                               if compute_dtype == "float32" else None),
        launches_per_step=launches / steps, steps=steps, nodes=loader.num_nodes,
        slots=sim_cfg.slots, ms_per_step=ms_step, steps_per_s=1e3 / ms_step,
        first_trajectory_s=outs[0]["run_time"], peak_memory_mb=peak_mb,
        mean_loss=summary["total"], checkpoint=model_file, device=kind, nvidia_smi=smi,
    )

    state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(model_file)
    if compute_dtype == "float32":
        # each of the first steps on the CPU through the plain versions, from
        # the card's own window: a 'one_step' rollout whose ground truth is the
        # card's prediction. The graph is searched anew every step, so a
        # free-running comparison would let a 1e-6 drift flip a pair at the
        # radius and move a particle by far more than rounding; its error is
        # reported, not held.
        cpu_sim = simulator_init(sim_cfg, device="cpu")
        cpu_sim.load_state_dict(state["params"], strict=True)
        cpu_stats = make_norm_stats(metadata, cfg.noise_std, device="cpu")
        traj = next(iter(loader))
        s, t_end = cfg.input_sequence_length, cfg.input_sequence_length + ROLLOUT_CHECK_STEPS
        card_pred = outs[0]["predicted_rollout"][:ROLLOUT_CHECK_STEPS]
        card_windows = np.concatenate([traj["positions"][:, :s], card_pred.transpose(1, 0, 2)], axis=1)
        ref = rollout(cpu_sim, sim_cfg, cpu_stats, card_windows, traj["particle_type"],
                      traj["strains"][:t_end], traj["node_mask"], inference_mode="one_step", device="cpu")
        free = rollout(cpu_sim, sim_cfg, cpu_stats, traj["positions"][:, :t_end], traj["particle_type"],
                       traj["strains"][:t_end], traj["node_mask"], device="cpu")
        atol, rtol = ROLLOUT_TOL
        errs = {}
        for key in ("predicted_rollout", "predicted_strain"):
            a = outs[0][key][:ROLLOUT_CHECK_STEPS]
            b = ref[key].numpy()
            err = np.abs(a - b)
            errs[key] = float(err.max())
            errs[f"{key}_free_running"] = float(np.abs(a - free[key].numpy()).max())
            if (err > atol + rtol * np.abs(b)).any():
                raise AssertionError(
                    f"card vs CPU rollout, {key}: max |err| {err.max():.3e} beyond "
                    f"atol {atol} + rtol {rtol}"
                )
        result["cpu_check"] = dict(steps=ROLLOUT_CHECK_STEPS, from_card_windows=True, max_abs_err=errs,
                                   atol=atol, rtol=rtol)

    # the captured route against the eager one on the warm trajectory, on a
    # simulator no rollout has used yet (its first captured call captures)
    gpu_sim = simulator_init(sim_cfg)
    gpu_sim.load_state_dict(state["params"], strict=True)
    stats = make_norm_stats(metadata, cfg.noise_std, device=gpu_sim.device)
    warm = list(loader)[-1]
    s = cfg.input_sequence_length
    step_inputs = first_step_inputs(warm, s, gpu_sim.device,
                                    node_mask=torch.as_tensor(warm["node_mask"], device=gpu_sim.device))
    result["routes"] = compare_routes(
        f"rollout {compute_dtype}", gpu_sim,
        lambda capture, t_end=None: rollout(gpu_sim, sim_cfg, stats, warm["positions"][:, :t_end],
                                            warm["particle_type"], warm["strains"][:t_end], warm["node_mask"],
                                            inference_mode=cfg.inference_mode, capture=capture),
        steps=warm["positions"].shape[1] - s, launches=lambda: eb.LAUNCHES, per_step=cfg.layers,
        step=rollout_step(gpu_sim, sim_cfg, stats, cfg.inference_mode), step_inputs=step_inputs,
    )
    log("rollout " + json.dumps(result))
    return result


def profile_rollout(run, wall_ms_step, steps=PROFILE_ROLLOUT_STEPS):
    """Device time per rollout step from torch.profiler over ``run()``, a
    rollout of ``steps`` steps, once warm, beside the unprofiled wall
    time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return dict(wall_ms_per_step=wall_ms_step, **device_profile(prof, steps, wall_ms_step))


def first_step_inputs(traj, s, device, **fixed):
    """The first rollout step's inputs from trajectory ``traj`` (window length
    ``s``) on ``device``: (window, ground-truth positions, strain), and the
    fixed ones (particle types, the erosional mask and ``fixed``)."""
    import torch

    types = torch.as_tensor(traj["particle_type"], device=device)
    args = tuple(torch.as_tensor(a, device=device)
                 for a in (traj["positions"][:, :s], traj["positions"][:, s], traj["strains"][s]))
    return args, dict(particle_types=types, erosional=(types == -1)[:, None], **fixed)


def no_sync_step(step, args, fixed):
    """One warm eager rollout step on the card under sync-debug mode
    "error": any host sync in it raises."""
    import torch

    with torch.inference_mode():
        step(*args, **fixed)  # warm: the search's constants and every cache made
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(*args, **fixed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def compare_routes(where, sim, run, steps, launches, per_step, step, step_inputs):
    """The captured rollout route against the eager one on one warm
    trajectory of ``steps`` steps; ``run(capture, t_end=None)`` rolls it
    out on ``sim``, a simulator no rollout has used (so that its first
    captured call captures). Calls in turns: captured (the warm-up step,
    the capture and the replays), eager, captured, captured, eager. Per
    route: wall ms/step (host clock around a call that ends in a sync),
    peak memory, the kernel counter ``launches()`` (``per_step`` per step
    on both routes; on the captured one added by the replays), device busy
    and idle share and host launch calls per step from a profile of
    PROFILE_ROLLOUT_STEPS steps; the capture's host time and graph launches
    per step. Captured equals eager, and the second eager call the first,
    with torch.equal over the whole trajectory. Last, one warm eager
    ``step`` on ``step_inputs`` under sync-debug mode "error"."""
    import torch

    from sgnn_tpu_torch.physics import captured_step

    def timed(capture):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        t0 = time.perf_counter()
        out = run(capture)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        got = launches() - before
        if got != per_step * steps:
            raise AssertionError(f"{where} {'captured' if capture else 'eager'}: {got} kernel launches, "
                                 f"expected {per_step} x {steps}")
        return dict(out=out, ms=ms, peak_mb=torch.cuda.max_memory_allocated() / 1e6)

    first = timed(True)
    captured = captured_step.steps_of(sim)[-1]
    if captured.graph is None:
        raise AssertionError(f"{where}: the captured route captured no graph")
    runs = {"eager": [timed(False)], "captured": []}
    replays = captured.replays
    runs["captured"] += [timed(True), timed(True)]
    graph_launches = (captured.replays - replays) / (2 * steps)
    runs["eager"].append(timed(False))

    eager = runs["eager"][0]["out"]
    diffs = {}
    for key in ("predicted_rollout", "predicted_strain"):
        want = eager[key]
        for out in [first["out"]] + [r["out"] for r in runs["captured"]]:
            got = out[key]
            diff = float((got - want).abs().max())
            diffs[key] = max(diffs.get(key, 0.0), diff)
            if not torch.equal(got, want):
                raise AssertionError(f"{where}: captured {key} differs from eager (max |diff| {diff:.3e})")
        if not torch.equal(runs["eager"][1]["out"][key], want):
            raise AssertionError(f"{where}: two eager rollouts differ in {key}")
    no_sync_step(step, *step_inputs)

    out = {"steps": steps, "check": "torch.equal over the whole trajectory (captured vs eager, eager vs eager)",
           "max_abs_diff_all_steps": diffs, "eager_repeats_bitwise": True, "warm_eager_step_sync_free": True}
    for name, rs in runs.items():
        ms = [r["ms"] for r in rs]
        out[name] = dict(ms_per_step=sum(ms) / len(ms), ms_per_step_runs=ms, peak_memory_mb=rs[0]["peak_mb"],
                         counted_launches_per_step=per_step)
    out["captured"].update(first_call_ms_per_step=first["ms"], first_call_peak_memory_mb=first["peak_mb"],
                           capture_s=captured.capture_seconds, graph_launches_per_step=graph_launches)
    t_end = step_inputs[0][0].shape[1] + PROFILE_ROLLOUT_STEPS  # the window's length + the profiled steps
    for name in ("eager", "captured"):
        capture = name == "captured"
        out[name]["profile"] = profile_rollout(lambda: run(capture, t_end), out[name]["ms_per_step"])
    log(f"{where} routes: eager {out['eager']['ms_per_step']:.3f} ms/step, captured "
        f"{out['captured']['ms_per_step']:.3f} ms/step (capture {captured.capture_seconds:.3f} s), "
        f"torch.equal: ok; warm eager step sync-free")
    return out


def gather_bound(tbl, idx):
    """Least time of ``tbl[idx]`` on the card: the bytes it must move (each
    table row these indices read, once; the indices; the output) over HBM
    rate. A gather does no arithmetic."""
    import torch

    rows_read = int(torch.unique(idx.reshape(-1).long().clamp(0, tbl.shape[0] - 1)).numel())
    row_bytes = tbl.shape[1] * tbl.element_size()
    n_bytes = rows_read * row_bytes + idx.numel() * idx.element_size() + idx.numel() * row_bytes
    ms, by = _bound(n_bytes, 0, "float32")
    return dict(bound_ms=ms, bound_by=by, bytes=n_bytes, table_rows_read=rows_read)


def ms_config(data: Path, **kw):
    from sgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(data_path=str(data), **{**MS_MODEL, **kw})


def phase_row_gather(data: Path, dev):
    """The three row-gather kernels against their plain version, bit for
    bit, then timed (plain / kernel / kernel / plain) beside index_select
    and the bound. Shapes: the probe's (int32 indices), and the sender
    gathers of the dense multi-scale graph of the first test trajectory
    (its own int64 indices into a [nodes, hidden] table); ragged sizes
    with clamped indices are checked, not timed."""
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.scripts.gather_kernel_probe import probe_inputs
    from sgnn_tpu_torch.scripts.gather_kernel_probe import time_ms as graph_time_ms
    from sgnn_tpu_torch.train.train_multi_scale import make_loader, ms_config_from

    cfg = ms_config(data, ms_dense=True)
    loader = make_loader(cfg, ms_config_from(cfg, load_metadata(data)), "test")
    graph = loader.graphs[0]
    g = torch.Generator().manual_seed(11)
    timed = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        timed[f"probe_{name}"] = probe_inputs(dtype, dev)
        table = torch.randn(loader.num_nodes, cfg.hidden_dim, generator=g).to(dtype).to(dev)
        for edge_type, de in (("m2m", graph.m2m[0]), ("m2g", graph.m2g)):
            timed[f"{edge_type}_senders_{name}"] = (table, torch.as_tensor(de.senders, dtype=torch.int64, device=dev))
    checks = dict(timed)
    for name, dtype, width in (("float32", torch.float32, 4), ("bfloat16", torch.bfloat16, 8)):
        table = torch.randn(97, width, generator=g).to(dtype).to(dev)
        idx = torch.randint(0, 97, (1001,), generator=g)
        idx[[0, 500, 1000]] = torch.tensor([97, -3, 97 + 40])  # clamped into [0, 97)
        for itype in (torch.int32, torch.int64):
            checks[f"ragged_{name}_{str(itype)[-5:]}"] = (table, idx.to(itype).to(dev))

    worst = 0.0
    for case, (tbl, idx) in checks.items():
        want = rg.row_gather_reference(tbl, idx)
        for variant in rg.VARIANTS:
            got = getattr(rg, f"row_gather_{variant}")(tbl, idx)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"row_gather_{variant} {case}: differs from the plain version")
            worst = max(worst, float((got.float() - want.float()).abs().max()))
        log(f"kernel row_gather {case}: tbl {list(tbl.shape)} {str(tbl.dtype)[6:]}, idx {list(idx.shape)} "
            f"{str(idx.dtype)[6:]}: loop, unroll8, take bit-identical to the plain version")

    results = {v: {} for v in rg.VARIANTS}
    for case, (tbl, idx) in timed.items():
        bound = gather_bound(tbl, idx)
        library_ms = graph_time_ms(lambda: torch.index_select(tbl, 0, idx.reshape(-1)), GATHER_TIMING_ITERS, dev)
        for variant in rg.VARIANTS:
            fn = getattr(rg, f"row_gather_{variant}")
            # plain / kernel / kernel / plain, each GATHER_TIMING_ITERS calls in one CUDA graph
            runs = [graph_time_ms(lambda f=f: f(tbl, idx), GATHER_TIMING_ITERS, dev)
                    for f in (rg.row_gather_reference, fn, fn, rg.row_gather_reference)]
            results[variant][case] = dict(
                bound, ms=(runs[1] + runs[2]) / 2, plain_ms=(runs[0] + runs[3]) / 2,
                kernel_ms_runs=runs[1:3], plain_ms_runs=[runs[0], runs[3]], library_ms=library_ms,
                # the same calls launched one by one from the host (the model's way)
                host_loop_ms=time_ms(fn, [(tbl, idx)], iters=GATHER_TIMING_ITERS),
                shape=[list(tbl.shape), list(idx.shape)], dtype=str(tbl.dtype)[6:], index_dtype=str(idx.dtype)[6:],
            )
            results[variant][case]["bound_share"] = bound["bound_ms"] / results[variant][case]["ms"]
        log(f"time row_gather {case}: " + ", ".join(f"{v} {results[v][case]['ms'] * 1e3:.2f} us "
                                                   f"({results[v][case]['bound_share']:.3f} of the bound)"
                                                   for v in rg.VARIANTS)
            + f"; plain {results['take'][case]['plain_ms'] * 1e3:.2f} us, index_select {library_ms * 1e3:.2f} us, "
            f"bound {bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}, {bound['table_rows_read']} table rows read); "
            "launched from a host loop: " + ", ".join(f"{v} {results[v][case]['host_loop_ms'] * 1e3:.2f} us"
                                                       for v in rg.VARIANTS))
    fastest = min(rg.VARIANTS, key=lambda v: sum(results[v][c]["ms"] for c in ("m2m_senders_float32", "m2g_senders_float32")))
    log(f"row_gather: fastest at the multi-scale f32 sender gathers: {fastest}; the model calls {rg.MODEL_VARIANT}")
    return dict(results=results, max_abs_err=worst, checked=sorted(checks), fastest_at_ms_shapes=fastest)


def reset_fwd_variant_launches():
    from sgnn_tpu_torch.ops import edge_block as eb

    for v in eb.FWD_VARIANT_LAUNCHES:
        eb.FWD_VARIANT_LAUNCHES[v] = 0


def reset_gather_launches():
    from sgnn_tpu_torch.ops import row_gather as rg

    for v in rg.LAUNCHES:
        rg.LAUNCHES[v] = 0


def phase_probe():
    """The ported gather probe in bf16 (its data type) and f32; its lines
    are printed, and each kernel must have launched."""
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.scripts import gather_kernel_probe as probe

    out = {}
    for name in ("bfloat16", "float32"):
        reset_gather_launches()
        times = probe.main(["--dtype", name])
        launches = dict(rg.LAUNCHES)
        if min(launches.values()) == 0:
            raise AssertionError(f"probe {name}: a kernel did not launch: {launches}")
        out[name] = dict(times_ms=times, launches=launches)
    log("probe " + json.dumps(out))
    return out


def ms_write_inputs(root: Path, data: Path):
    """A checkpoint of seeded initial weights at full width, written with
    the port's checkpoint code; returns its file name."""
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.physics.multi_scale_simulator import multi_scale_simulator_init
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager, train_state
    from sgnn_tpu_torch.train.train_multi_scale import ms_config_from

    cfg = ms_config(data)
    sim = multi_scale_simulator_init(ms_config_from(cfg, load_metadata(data)),
                                     generator=torch.Generator().manual_seed(cfg.seed), device="cpu")
    return CheckpointManager(root / "ms_models" / "smoke_ms").save_best(train_state(sim), 0, float("inf")).name


def run_ms(root: Path, data: Path, name: str, model_file: str, smi: str, kind: str):
    """``train_multi_scale.main`` in rollout mode from the config written
    for run ``name``; launches, ms/step, peak memory, the card-vs-CPU check
    (f32; bf16: the first forward), and the captured route against the
    eager one (``compare_routes``)."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.physics.multi_scale_graph import DenseStaticGraph
    from sgnn_tpu_torch.physics.multi_scale_simulator import (
        graph_to,
        ms_rollout,
        ms_rollout_step,
        multi_scale_simulator_init,
    )
    from sgnn_tpu_torch.physics.simulator import make_norm_stats
    from sgnn_tpu_torch.train import train_multi_scale as tms
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager

    ms_dense, dtype_name = MS_RUNS[name]
    run_cfg = dict(MS_MODEL, data_path=str(data), model_path=str(root / "ms_models"), run_name="smoke_ms",
                   output_path=str(root / "ms_rollouts" / name), ms_dense=ms_dense, compute_dtype=dtype_name)
    yml = root / f"ms_{name}.yaml"
    yml.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in run_cfg.items()))
    cfg = ms_config(data, **{k: v for k, v in run_cfg.items() if k != "data_path"}, mode="rollout",
                    model_file=model_file)
    metadata = load_metadata(data)
    sim_cfg = tms.ms_config_from(cfg, metadata)
    loader = tms.make_loader(cfg, sim_cfg, "test")
    graph = loader.graphs[0]
    dense = isinstance(graph, DenseStaticGraph)
    if dense != name.startswith("dense"):
        raise AssertionError(f"ms {name}: ms_dense={ms_dense} gave the {'dense' if dense else 'COO'} layout")
    blocks = 2 + cfg.layers * (len(graph.m2m) if dense else 1)  # G2M, M2G, and M2M per layer (and scale)
    per_step = 2 * blocks  # proj_i[receivers], proj_j[senders]
    frames = [p.shape[0] for p, _, _ in loader.trajectories]
    steps = sum(f - cfg.input_sequence_length for f in frames)
    expect = {v: (per_step * steps if v == rg.MODEL_VARIANT else 0) for v in rg.VARIANTS}
    expect["sorted_sum"] = blocks * steps  # the aggregation of every block
    log(f"ms {name}: {len(frames)} test trajectories x {loader.num_nodes} nodes (padded), "
        f"{'dense' if dense else 'COO'} layout, {blocks} blocks, {steps} rollout steps, {dtype_name}")

    # the edge stages' epilogue kernels: one forward per dense block in f32
    expect_epilogue = dict(epilogue_fwd=blocks * steps if dense and dtype_name == "float32" else 0, epilogue_bwd=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_gather_launches()
    reset_bwd_gather_launches()
    reset_epilogue_launches()
    reset_f32_product_launches()
    # the port's entry point, on CUDA by default: its step captured and replayed
    summary = tms.main(["--config", str(yml), "--mode", "rollout", "--model_file", model_file])
    launches = dict(rg.LAUNCHES, sorted_sum=rg.BWD_LAUNCHES["sorted"])
    epilogue = epilogue_counts()
    products = f32_product_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    if launches != expect:
        raise AssertionError(f"ms {name}: row_gather launches {launches}, expected {expect}")
    if epilogue != expect_epilogue:
        raise AssertionError(f"ms {name}: edge_epilogue launches {epilogue}, expected {expect_epilogue}")
    if not all(math.isfinite(summary[k]) for k in ("total", "position", "strain", "one_step")):
        raise AssertionError(f"ms {name}: non-finite summary {summary}")
    outs = []
    for case in metadata["file_test"]:
        with open(Path(cfg.output_path) / cfg.run_name / case.replace(".npz", ".pkl"), "rb") as f:
            outs.append(pickle.load(f))
    for out in outs:
        for key in ("predicted_rollout", "predicted_strain", "rmse_position_per_step", "rmse_strain_per_step"):
            if not np.isfinite(out[key]).all():
                raise AssertionError(f"ms {name} {out['case_name']}: non-finite {key}")
        if out["predicted_rollout"].shape != out["ground_truth_rollout"].shape:
            raise AssertionError(f"ms {name} {out['case_name']}: rollout shape mismatch")
    warm = outs[-1]  # the first trajectory warmed up the card
    ms_step = warm["run_time"] / warm["predicted_rollout"].shape[0] * 1e3
    result = dict(
        run=name, layout="dense" if dense else "coo", compute_dtype=dtype_name, blocks=blocks,
        launches=launches, expected_launches=expect, epilogue_launches=epilogue, gathers_per_step=per_step,
        f32_product_launches=products, f32_products_per_step=(f32_products_of_rollout(f"ms {name}", products, steps)
                                                              if dtype_name == "float32" else None),
        steps=steps, nodes=loader.num_nodes, ms_per_step=ms_step, steps_per_s=1e3 / ms_step,
        first_trajectory_s=outs[0]["run_time"], peak_memory_mb=peak_mb,
        summary={k: summary[k] for k in ("total", "position", "strain", "one_step", "mean_time", "std_time")},
        device=kind, nvidia_smi=smi,
    )

    state, _ = CheckpointManager(Path(cfg.model_path) / cfg.run_name).restore(model_file)
    traj = next(iter(loader))
    if dtype_name == "float32":
        # the same rollout's first steps on the CPU through the plain versions
        cpu_sim = multi_scale_simulator_init(sim_cfg, device="cpu")
        cpu_sim.load_state_dict(state["params"], strict=True)
        t_end = cfg.input_sequence_length + ROLLOUT_CHECK_STEPS
        ref = ms_rollout(cpu_sim, sim_cfg, make_norm_stats(metadata, cfg.noise_std), traj["positions"][:, :t_end],
                         traj["particle_type"], traj["strains"][:t_end], traj["graph"], traj["node_mask"],
                         device="cpu")
        atol, rtol = ROLLOUT_TOL
        errs = {}
        for key in ("predicted_rollout", "predicted_strain"):
            a, b = outs[0][key][:ROLLOUT_CHECK_STEPS], ref[key].numpy()
            err = np.abs(a - b)
            errs[key] = float(err.max())
            if (err > atol + rtol * np.abs(b)).any():
                raise AssertionError(f"ms {name}: card vs CPU rollout, {key}: max |err| {err.max():.3e} "
                                     f"beyond atol {atol} + rtol {rtol}")
        result["cpu_check"] = dict(steps=ROLLOUT_CHECK_STEPS, max_abs_err=errs, atol=atol, rtol=rtol)

    gpu_sim = multi_scale_simulator_init(sim_cfg)
    gpu_sim.load_state_dict(state["params"], strict=True)
    stats = make_norm_stats(metadata, cfg.noise_std, device=gpu_sim.device)
    if dtype_name == "bfloat16":
        result["cpu_check"] = ms_bf16_forward_check(name, gpu_sim, sim_cfg, state, metadata, cfg.noise_std, traj)
    # the captured route against the eager one on the warm trajectory, on a
    # simulator no rollout has used yet
    warm = list(loader)[-1]
    s = cfg.input_sequence_length
    step_inputs = first_step_inputs(warm, s, gpu_sim.device, graph=graph_to(warm["graph"], gpu_sim.device))
    result["routes"] = compare_routes(
        f"ms rollout {name}", gpu_sim,
        lambda capture, t_end=None: ms_rollout(gpu_sim, sim_cfg, stats, warm["positions"][:, :t_end],
                                               warm["particle_type"], warm["strains"][:t_end], warm["graph"],
                                               warm["node_mask"], inference_mode=cfg.inference_mode,
                                               capture=capture),
        steps=warm["positions"].shape[1] - s, launches=lambda: rg.LAUNCHES[rg.MODEL_VARIANT],
        per_step=per_step, step=ms_rollout_step(gpu_sim, sim_cfg, stats, cfg.inference_mode),
        step_inputs=step_inputs,
    )
    log(f"ms rollout {name} " + json.dumps(result))
    return result


def ms_bf16_forward_check(name, gpu_sim, sim_cfg, state, metadata, noise_std, traj):
    """One bf16 forward from the first window on the card against the same
    forward on the CPU through the plain versions, to ``BF16_GAP_FACTOR``
    times the CPU's own bf16-vs-f32 gap."""
    import dataclasses

    import torch

    from sgnn_tpu_torch.physics.multi_scale_simulator import _forward, graph_to, multi_scale_simulator_init
    from sgnn_tpu_torch.physics.simulator import make_norm_stats

    window = torch.as_tensor(traj["positions"][:, : sim_cfg.input_sequence_length], dtype=torch.float32)
    types = torch.as_tensor(traj["particle_type"])

    def forward(sim, cfg):
        dev = sim.device
        with torch.no_grad():
            acc, strain = _forward(sim, cfg, make_norm_stats(metadata, noise_std, device=dev), window.to(dev),
                                   types.to(dev), graph_to(traj["graph"], dev))
        return {"acceleration": acc.cpu(), "strain": strain.cpu()}

    def on_cpu(cfg):
        sim = multi_scale_simulator_init(cfg, device="cpu")
        sim.load_state_dict(state["params"], strict=True)
        return forward(sim, cfg)

    f32_cfg = dataclasses.replace(sim_cfg, compute_dtype="float32")
    card, cpu, cpu_f32 = forward(gpu_sim, sim_cfg), on_cpu(sim_cfg), on_cpu(f32_cfg)
    errs, gaps, scale = {}, {}, {}
    for key in ("acceleration", "strain"):
        errs[key] = float((card[key] - cpu[key]).abs().max())
        gaps[key] = float((cpu[key] - cpu_f32[key]).abs().max())
        scale[key] = float(cpu_f32[key].abs().max())
        if not errs[key] <= BF16_GAP_FACTOR * gaps[key]:
            raise AssertionError(f"ms {name}: card vs CPU bf16 forward, {key}: max |err| {errs[key]:.3e} beyond "
                                 f"{BF16_GAP_FACTOR} x the CPU's bf16-vs-f32 gap {gaps[key]:.3e}")
    return dict(steps=1, forward=True, max_abs_err=errs, cpu_bf16_vs_f32_gap=gaps, gap_factor=BF16_GAP_FACTOR,
                output_max_abs=scale)


def reset_bwd_gather_launches():
    from sgnn_tpu_torch.ops import row_gather as rg

    for v in rg.BWD_LAUNCHES:
        rg.BWD_LAUNCHES[v] = 0


def ms_train_config(root: Path, data: Path, name: str, **kw):
    ms_dense, dtype_name, steps, log_every = MS_TRAIN_RUNS[name]
    base = dict(mode="train", model_path=str(root / "ms_train_models"), output_path=str(root / "ms_train_rollouts"),
                run_name=f"smoke_ms_train_{name}", ms_dense=ms_dense, compute_dtype=dtype_name,
                ntraining_steps=steps, nsave_steps=min(SAVE_EVERY, steps), log_every=log_every)
    return ms_config(data, **{**base, **kw})


def ms_blocks(graph) -> int:
    """Interaction blocks of one forward over ``graph``'s layout: G2M, M2G,
    and M2M per layer (and per scale in the dense layout)."""
    from sgnn_tpu_torch.physics.multi_scale_graph import DenseStaticGraph

    per_layer = len(graph.m2m) if isinstance(graph, DenseStaticGraph) else 1
    return 2 + MS_MODEL["layers"] * per_layer


def run_ms_train(root: Path, data: Path, name: str, smi: str, kind: str):
    """``train_multi_scale.main`` in train mode at the values of
    configs/taylor2d_multi_scale.yaml for run ``name`` (prefetched and
    captured): launches of the take kernel and of the sorted and planned
    kernels against the counts the graph asks (see ``expect``), metrics,
    checkpoint, and ``training_routes`` (COO: the eager step twice)."""
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.physics.multi_scale_graph import DenseStaticGraph
    from sgnn_tpu_torch.train import train_multi_scale as tms

    cfg = ms_train_config(root, data, name)
    keys = sorted(set(MS_MODEL) | {"data_path", "model_path", "output_path", "run_name", "ms_dense", "compute_dtype",
                                   "ntraining_steps", "nsave_steps", "log_every", "mode"})
    yml = root / f"ms_train_{name}.yaml"
    yml.write_text("".join(f"{k}: {json.dumps(getattr(cfg, k))}\n" for k in keys))
    steps, n_val = cfg.ntraining_steps, cfg.ntraining_steps // cfg.nsave_steps
    card = torch.device("cuda", torch.cuda.current_device())

    torch.cuda.synchronize()
    reset_gather_launches()
    reset_bwd_gather_launches()
    reset_epilogue_launches()
    reset_f32_product_launches()
    t0 = time.perf_counter()
    result = tms.main(["--config", str(yml), "--mode", "train"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = dict(rg.LAUNCHES, **{f"bwd_{k}": v for k, v in rg.BWD_LAUNCHES.items()})
    epilogue = epilogue_counts()
    products = f32_product_counts()

    # the counts the graphs ask: the training split's batcher and the validation loader
    sim_cfg = tms.ms_config_from(cfg, load_metadata(data))
    valid = tms.make_loader(cfg, sim_cfg, "valid")
    built = tms.build_training(cfg, card)
    train_graph = built.batcher.graphs[0]
    del built
    dense = isinstance(train_graph, DenseStaticGraph)
    if dense != name.startswith("dense") or isinstance(valid.graphs[0], DenseStaticGraph) != dense:
        raise AssertionError(f"ms train {name}: ms_dense={cfg.ms_dense} gave the "
                             f"{'dense' if dense else 'COO'} layout")
    blocks, val_blocks = ms_blocks(train_graph), ms_blocks(valid.graphs[0])
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    rollout_steps = val_steps * n_val
    # per training step and block: the receiver and sender gathers, and the
    # take kernel in the aggregation's backward (and COO: over the sender
    # order); the sorted sum in the aggregation and the receiver backward
    # (and COO: the sender backward); the plan's backward (dense). Per
    # validation rollout step and block: the two gathers and the aggregation
    expect = {v: 0 for v in rg.VARIANTS}
    expect[rg.MODEL_VARIANT] = (3 if dense else 4) * blocks * steps + 2 * val_blocks * rollout_steps
    expect.update(bwd_sorted=(2 if dense else 3) * blocks * steps + val_blocks * rollout_steps,
                  bwd_planned=blocks * steps if dense else 0)
    if got != expect:
        raise AssertionError(f"ms train {name}: launches {got}, expected {expect}")
    # the edge stages' epilogue kernels, dense f32 only: per block, one forward
    # and one backward a training step and one forward a validation step
    on = dense and cfg.compute_dtype == "float32"
    expect_epilogue = dict(epilogue_fwd=blocks * steps + val_blocks * rollout_steps if on else 0,
                           epilogue_bwd=blocks * steps if on else 0)
    if epilogue != expect_epilogue:
        raise AssertionError(f"ms train {name}: edge_epilogue launches {epilogue}, expected {expect_epilogue}")
    if result["step"] != steps or not math.isfinite(result["lowest_eval_loss"]):
        raise AssertionError(f"ms train {name}: {result}")
    run_dir = Path(cfg.model_path) / cfg.run_name
    meta = json.loads((run_dir / "checkpoint_meta.json").read_text())
    if not meta["path"].startswith("model-best-") or not (run_dir / meta["path"]).exists():
        raise AssertionError(f"ms train {name}: no best checkpoint ({meta})")
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rec = [r for r in records if "train/loss" in r]
    val_rec = [r for r in records if "val/loss" in r]
    log_steps = list(range(cfg.log_every, steps + 1, cfg.log_every))
    if [r["step"] for r in train_rec] != log_steps or len(val_rec) != n_val:
        raise AssertionError(f"ms train {name}: metrics {records}")
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"ms train {name}: non-finite metric in {r}")

    out = dict(
        run=name, layout="dense" if dense else "coo", compute_dtype=cfg.compute_dtype, batch_size=cfg.batch_size,
        blocks=blocks, steps=steps, validation_rollout_steps=val_steps * n_val, launches=got,
        expected_launches=expect, epilogue_launches=epilogue, f32_product_launches=products,
        ms_per_step_last_log=train_rec[-1]["train/step_time_s"] * 1e3,
        logged_steps=log_steps, train_loss=[r["train/loss"] for r in train_rec],
        val_loss=[r["val/loss"] for r in val_rec], checkpoint=meta["path"], wall_s=wall_s, device=kind,
        nvidia_smi=smi,
    )
    out["routes"] = training_routes(f"ms train {name}", cfg, card, tms, repeat_eager=not dense)
    if cfg.compute_dtype == "float32":
        out["f32_products"] = f32_products_of_training(f"ms train {name}", products, steps, rollout_steps,
                                                       out["routes"]["captured"]["launches_per_step"])
    log(f"ms train {name} " + json.dumps(out))
    return out


def ms_card_vs_cpu_step(root: Path, data: Path, name: str, device):
    """One multi-scale training step of run ``name`` at full width on 2
    samples, on the card (kernels) and on the CPU (plain versions), from
    the same weights, batch and noise; held to STEP_TOL (bf16: with the
    CPU's own bf16-vs-f32 gap, from the same step in f32 on the CPU)."""
    import dataclasses

    import torch

    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train_multi_scale as tms

    cfg = ms_train_config(root, data, name, run_name=f"smoke_ms_checks_{name}")
    bf16 = cfg.compute_dtype == "bfloat16"
    step_tol = STEP_TOL["MS_bf16" if bf16 else "MS_f32"]
    cpu = torch.device("cpu")
    # the card's step twice: whether the whole step's gradients repeat bit
    # for bit is reported, not held (the gathers' backwards are; the rest
    # is PyTorch's)
    plan = [("card", device, cfg), ("card_again", device, cfg), ("cpu", cpu, cfg)]
    if bf16:
        plan.append(("cpu_f32", cpu, dataclasses.replace(cfg, compute_dtype="float32")))
    runs, batch = {}, None
    for where, dev, c in plan:
        built = tms.build_training(c, dev, batch_size=2)
        if batch is None:
            batch = next(built.batcher.epochs())
            noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                               generator=torch.Generator().manual_seed(2))
            blocks = ms_blocks(built.batcher.graphs[0])
        before = {k: v.detach().cpu().clone() for k, v in built.sim.state_dict().items()}
        launches, epilogue = dict(rg.BWD_LAUNCHES), epilogue_counts()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in built.step_fn(tms.batch_to_device(batch, dev), 0,
                                                          noise=noise.to(dev)).items()}
        runs[where] = dict(metrics=metrics, seconds=time.perf_counter() - t0,
                           bwd={k: rg.BWD_LAUNCHES[k] - launches[k] for k in launches},
                           epilogue={k: v - epilogue[k] for k, v in epilogue_counts().items()},
                           grads={k: p.grad.detach().cpu() for k, p in built.sim.named_parameters()},
                           params={k: v.detach().cpu() for k, v in built.sim.state_dict().items()}, before=before)
        del built
    card, on_cpu = runs["card"], runs["cpu"]
    # per block: the aggregation's sorted sum and the receiver gather's backward; the plan's backward
    if card["bwd"] != {"sorted": 2 * blocks, "planned": blocks} or on_cpu["bwd"] != {"sorted": 0, "planned": 0}:
        raise AssertionError(f"ms card vs CPU step {name}: sorted / planned launches {card['bwd']} (card), "
                             f"{on_cpu['bwd']} (CPU), expected {2 * blocks} / {blocks} on the card")
    # the epilogue kernels on the card in f32 (per block), the plain composite on the CPU
    want = dict.fromkeys(EPILOGUE_KEYS, 0 if bf16 else blocks)
    if card["epilogue"] != want or on_cpu["epilogue"] != dict.fromkeys(EPILOGUE_KEYS, 0):
        raise AssertionError(f"ms card vs CPU step {name}: edge_epilogue launches {card['epilogue']} (card), "
                             f"{on_cpu['epilogue']} (CPU), expected {want} on the card")
    gaps = None
    if bf16:
        gaps = {k: float((g - runs["cpu_f32"]["grads"][k]).abs().max()) for k, g in on_cpu["grads"].items()}
    worst = compare_steps(f"ms card vs CPU step {name}", card, on_cpu, step_tol, cfg.lr_init + 1e-6, gaps)
    repeats = all(torch.equal(g, runs["card_again"]["grads"][k]) for k, g in card["grads"].items())
    out = dict(run=name, compute_dtype=cfg.compute_dtype, samples=2, receivers=int(batch["node_mask"].size),
               backward_launches=card["bwd"], epilogue_launches=card["epilogue"], loss=card["metrics"]["train/loss"], max_err=worst, tol=step_tol,
               card_gradients_repeat_bitwise=repeats,
               gap_factor=BF16_GAP_FACTOR if bf16 else None, card_s=card["seconds"], cpu_s=on_cpu["seconds"])
    log("ms card vs CPU step " + json.dumps(out))
    return out


def _long_run_ids(chunk: int):
    """Ascending ids over 260 nodes with what splits a sorted sum: ids
    below 0, runs of 0-40 ids (many cross a multiple of ``chunk``), a run
    of exactly ``chunk`` ids starting at a multiple of it, a run of 5,003
    ids, ids past the end, and nodes 203-259 with no id."""
    import torch

    g = torch.Generator().manual_seed(19)
    runs = torch.randint(0, 41, (200,), generator=g) * (torch.rand(200, generator=g) < 0.7)
    ids = torch.cat([torch.full((5,), -2), torch.repeat_interleave(torch.arange(200), runs)])
    ids = torch.cat([ids, torch.full((-len(ids) % chunk,), 200)])  # node 200 up to a multiple of chunk
    return torch.cat([ids, torch.full((chunk,), 201), torch.full((5003,), 202), torch.full((40,), 267)]), 260


# GraphCast_small's graphs (graphcast_small_1deg_f32 in the benchmark): a 1 degree grid, mesh level 5,
# latent 512; its g2m receivers take up to 594 grid senders a mesh node near a pole
GRAPHCAST_SMALL = dict(resolution_deg=1.0, refinement=5, edge_pad_multiple=1024, latent=512, max_g2m_run=594)


def _graphcast_g2m_receivers():
    """(receivers [E_pad], mesh nodes) of GraphCast_small's g2m edges as the
    model takes them (receivers non-decreasing, padded rows included)."""
    import torch

    from sgnn_tpu_torch.models.graphcast import G2M_RADIUS_FRACTION
    from sgnn_tpu_torch.physics import sphere_graph

    g = sphere_graph.build_graph(GRAPHCAST_SMALL["resolution_deg"], GRAPHCAST_SMALL["refinement"],
                                 G2M_RADIUS_FRACTION, GRAPHCAST_SMALL["edge_pad_multiple"])
    recv, n = torch.as_tensor(g.g2m.receivers), g.mesh_nodes
    runs = torch.bincount(recv[torch.as_tensor(g.g2m.mask)].long(), minlength=n)
    if int(runs.max()) != GRAPHCAST_SMALL["max_g2m_run"]:
        raise AssertionError(f"GraphCast_small's g2m: longest run {int(runs.max())} ids, expected "
                             f"{GRAPHCAST_SMALL['max_g2m_run']}")
    return recv, n


def _bwd_gather_cases(data: Path, dev):
    """The backwards' inputs at the model's shapes, from one flattened
    training batch of 16 of each layout (dense: the m2m and m2g receivers
    and plans, f32 and bf16 cotangents; COO: the g2m, m2m and m2g
    receivers in f32 and the m2m receivers in bf16), the dense m2g
    receivers without each sample's padded rows, and at ragged sizes:
    {case: (kind, args)}; kind is "sorted" or "planned"."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.data.static_graph_loader import MultiScaleSampleBatcher
    from sgnn_tpu_torch.models.multi_scale import flatten_dense_ms_graph, flatten_ms_graph
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.physics.multi_scale_graph import CooEdges, dense_edges
    from sgnn_tpu_torch.physics.multi_scale_simulator import graph_to
    from sgnn_tpu_torch.train.train_multi_scale import ms_config_from

    def batch_graph(dense):
        cfg = ms_config(data, ms_dense=dense)
        sim_cfg = ms_config_from(cfg, load_metadata(data))
        batcher = MultiScaleSampleBatcher(
            data / "train.npz", cfg.input_sequence_length, cfg.batch_size, ms_cfg=sim_cfg.graph_config,
            pad_multiple=cfg.pad_multiple, edge_pad_multiple=cfg.edge_pad_multiple, seed=cfg.seed, dense=dense,
            m2m_traversals=cfg.layers)
        flat = flatten_dense_ms_graph if dense else flatten_ms_graph
        return flat(graph_to(next(batcher.epochs())["graph"], dev), batcher.num_nodes), batcher.num_nodes, cfg

    graph, nodes, cfg = batch_graph(True)
    n = cfg.batch_size * nodes
    g = torch.Generator().manual_seed(13)

    def cot(rows, dtype, width=cfg.hidden_dim):
        return torch.randn(rows, width, generator=g).to(dtype).to(dev)

    cases = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for edge_type, de in (("m2m", graph.m2m[0]), ("m2g", graph.m2g)):
            cases[f"{edge_type}_recv_{name}"] = ("sorted", (cot(de.recv.numel(), dtype), de.recv, n))
            cases[f"{edge_type}_plan_{name}"] = ("planned", (cot(de.senders.numel(), dtype), de.tsp_rows,
                                                             de.tsp_node, de.tsp_mask, n))
        # the m2g receivers without the padded rows, which repeat each sample's last node
        recv = graph.m2g.recv
        padded = (recv % nodes == nodes - 1) & (recv == torch.cat([recv[:1] - 1, recv[:-1]]))
        kept = recv[~padded].contiguous()
        cases[f"m2g_recv_unpadded_{name}"] = ("sorted", (cot(kept.numel(), dtype), kept, n))
    coo, _, _ = batch_graph(False)
    for edge_type, name, dtype in (("g2m", "float32", torch.float32), ("m2m", "float32", torch.float32),
                                   ("m2g", "float32", torch.float32), ("m2m", "bfloat16", torch.bfloat16)):
        recv = getattr(coo, edge_type).receivers
        cases[f"coo_{edge_type}_recv_{name}"] = ("sorted", (cot(recv.numel(), dtype), recv, n))
    gc_ids, gc_n = _graphcast_g2m_receivers()
    cases["graphcast_g2m_recv_float32"] = ("sorted", (cot(gc_ids.numel(), torch.float32, GRAPHCAST_SMALL["latent"]),
                                                      gc_ids.to(dev), gc_n))
    rng = np.random.default_rng(17)
    long_ids, long_n = _long_run_ids(rg.SORTED_CHUNK_MANY)
    assert rg.sorted_chunk(len(long_ids), long_n) == rg.SORTED_CHUNK_MANY
    for name, dtype, width in (("float32", torch.float32, 4), ("bfloat16", torch.bfloat16, 8)):
        ids = torch.sort(torch.randint(0, 90, (1001,), generator=g)).values  # runs, gaps, rows 90-96 empty
        cases[f"ragged_recv_{name}"] = ("sorted", (cot(1001, dtype, width), ids.to(dev), 97))
        cases[f"long_run_recv_{name}"] = ("sorted", (cot(len(long_ids), dtype), long_ids.to(dev), long_n))
        de = dense_edges(CooEdges(rng.integers(0, 301, 3000).astype(np.int32),
                                  rng.integers(0, 301, 3000).astype(np.int32)), 301, 310, 24, tsp_slots=40,
                         tsp_rows_pad=320)  # plan slots past one warp's 32; padded plan rows
        cases[f"ragged_plan_{name}"] = ("planned", (cot(de.senders.size, dtype, width),
                                                    *(torch.from_numpy(a).to(dev) for a in
                                                      (de.tsp_rows, de.tsp_node, de.tsp_mask)), 301))
    return cases


def bwd_gather_bound(kind, args):
    """Least time of the backward on the card: the bytes it must move (the
    cotangent rows its ids name, once: all of them for the sorted sum, the
    unmasked slots' for the plan; the ids or the whole plan; the [N, W]
    output) over HBM rate, against its f32 adds over the f32 peak."""
    g, n = args[0], args[-1]
    row = g.shape[1] * g.element_size()
    if kind == "sorted":
        idx = args[1]
        rows = g.shape[0]
        n_bytes = rows * row + idx.numel() * idx.element_size() + n * row
    else:
        tsp_rows, tsp_node, tsp_mask = args[1:4]
        rows = int(tsp_mask.sum())
        n_bytes = (rows * row + tsp_rows.numel() * tsp_rows.element_size() + tsp_node.numel() * tsp_node.element_size()
                   + tsp_mask.numel() + n * row)
    flops = rows * g.shape[1]
    ms, by = _bound(n_bytes, flops, "float32")
    return dict(bound_ms=ms, bound_by=by, bytes=n_bytes, flops=flops, cotangent_rows_read=rows)


def phase_row_gather_bwd(data: Path, dev):
    """Both backward kernels against their plain versions at the model's
    shapes (dense and COO; f32, bf16) and at ragged sizes, each launched
    twice and held bit for bit to the plain version and to the other
    launch; then timed (CUDA-graph replay of GATHER_TIMING_ITERS calls)
    beside their plain versions (host loop), the index_add_ route and the
    bound."""
    import torch

    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.scripts.gather_kernel_probe import time_ms as graph_time_ms

    fns = {"sorted": (rg.sorted_segment_sum, rg.sorted_segment_sum_reference),
           "planned": (rg.planned_gather_bwd, rg.planned_gather_bwd_reference)}
    cases = _bwd_gather_cases(data, dev)
    for case, (kind, args) in cases.items():
        kern, plain = fns[kind]
        got, again = kern(*args), kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{kind} backward {case}: two launches differ")
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max()) if got.shape == want.shape else math.inf
            raise AssertionError(f"{kind} backward {case}: not bit-identical to the plain version (max |err| "
                                 f"{err:.3e}); both add in one order")
        log(f"kernel {kind} backward {case}: g {list(args[0].shape)} {str(args[0].dtype)[6:]}, "
            f"{str(args[1].dtype)[6:]} ids -> [{args[-1]}, {args[0].shape[1]}]: ok, bit-identical to the plain "
            f"version and twice")

    def library(kind, args):
        """index_add_ of the cotangent rows at their ids (the plan's
        unmasked slots gathered first)."""
        g, n = args[0], args[-1]
        if kind == "sorted":
            return lambda: torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device).index_add_(0, args[1], g)
        tsp_rows, tsp_node, tsp_mask = args[1:4]
        rows, idx = tsp_rows[tsp_mask], tsp_node[:, None].expand_as(tsp_rows)[tsp_mask]
        return lambda: torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device).index_add_(
            0, idx, g.index_select(0, rows))

    timed = {}
    for case in ("m2m_recv_float32", "m2g_recv_float32", "m2m_recv_bfloat16", "m2g_recv_bfloat16",
                 "m2g_recv_unpadded_float32", "m2g_recv_unpadded_bfloat16", "coo_g2m_recv_float32",
                 "coo_m2m_recv_float32", "coo_m2g_recv_float32", "coo_m2m_recv_bfloat16",
                 "graphcast_g2m_recv_float32", "m2m_plan_float32", "m2g_plan_float32", "m2m_plan_bfloat16", "m2g_plan_bfloat16"):
        kind, args = cases[case]
        kern, plain = fns[kind]
        t_plain_a = time_ms(lambda: plain(*args), [()], iters=20, warmup=3)
        t_kern = [graph_time_ms(lambda: kern(*args), GATHER_TIMING_ITERS, dev) for _ in range(2)]
        t_plain_b = time_ms(lambda: plain(*args), [()], iters=20, warmup=3)
        lib_ms = graph_time_ms(library(kind, args), GATHER_TIMING_ITERS, dev)
        timed[case] = dict(
            bwd_gather_bound(kind, args), kind=kind, ms=sum(t_kern) / 2, kernel_ms_runs=t_kern,
            plain_ms=(t_plain_a + t_plain_b) / 2, plain_ms_runs=[t_plain_a, t_plain_b], library_ms=lib_ms,
            host_loop_ms=time_ms(lambda: kern(*args), [()], iters=GATHER_TIMING_ITERS),
            shape=[list(args[0].shape), args[-1]], dtype=str(args[0].dtype)[6:],
        )
        r = timed[case]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"time {kind} backward {case}: kernel {r['ms'] * 1e3:.2f} us (graph replay; host loop "
            f"{r['host_loop_ms'] * 1e3:.2f} us), plain {r['plain_ms'] * 1e3:.2f} us, index_add_ route "
            f"{lib_ms * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, "
            f"{r['bound_share']:.3f} of the kernel's time)")
    return dict(checked=sorted(cases), timed=timed)


def bwd_gather_summary(bwd, ms_train, train_a):
    """The kernel-summary entries of the two backward kernels: times at the
    dense f32 m2m gathers (the training step's; the sorted one's at the COO
    f32 m2m receivers beside them), launches by path (the sorted sum's in
    config A's training too: its sender backward)."""
    entries = []
    for kind, name, case, replaces in (
        ("sorted", "sorted_segment_sum", "m2m_recv_float32", "sgnn_tpu/models/multi_scale.py:243"),
        ("planned", "planned_gather_bwd", "m2m_plan_float32", "sgnn_tpu/models/multi_scale.py:266"),
    ):
        main = bwd["timed"][case]
        by_path = {f"ms_train_{n}": r["launches"][f"bwd_{kind}"] for n, r in ms_train.items()}
        if kind == "sorted":
            by_path["train_A"] = train_a["launches"]["sorted"]
        entries.append(dict(
            name=name, route="cuda", source="sgnn_tpu_torch/csrc/row_gather_bwd.cu",
            replaces=f"{replaces} (a custom VJP's XLA backward; no Pallas original)",
            launches=by_path["ms_train_dense_f32"], launches_by_path=by_path, dtype=main["dtype"], shape=main["shape"],
            max_abs_err=0.0, tol="bit-identical (torch.equal)", checked=bwd["checked"], ms=main["ms"],
            plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=main["library_ms"], bytes=main["bytes"],
            bound_share=main["bound_share"], kernel_ms_runs=main["kernel_ms_runs"],
            plain_ms_runs=main["plain_ms_runs"], host_loop_ms=main["host_loop_ms"],
            at_shapes={c: {k: r[k] for k in ("shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_share",
                                             "library_ms", "host_loop_ms")}
                       for c, r in bwd["timed"].items() if r["kind"] == kind},
        ))
    coo = bwd["timed"]["coo_m2m_recv_float32"]
    entries[0]["coo_m2m_float32"] = {k: coo[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_share",
                                                         "library_ms", "host_loop_ms")}
    return entries


def gather_summary(gather, probe, ms_runs, train_a, packed_paths):
    """The kernel-summary entries of the three row-gather kernels: times
    at the dense m2m sender gather (f32), the main path's, and at every
    timed shape; launches by path (the take kernel's in config A's
    training too: its sender gathers; and B's packed gather, in training
    and rollout: ``packed_paths``)."""
    from sgnn_tpu_torch.ops import row_gather as rg

    main_case = "m2m_senders_float32"
    entries = []
    for variant, line in (("loop", 56), ("unroll8", 64), ("take", 74)):
        by_path = {f"probe_{d}": probe[d]["launches"][variant] for d in probe}
        by_path.update({f"ms_{n}": r["launches"][variant] for n, r in ms_runs.items()})
        if variant == rg.MODEL_VARIANT:
            by_path["train_A"] = train_a["launches"]["take"]
            by_path.update(packed_paths)
        res = gather["results"][variant]
        main = res[main_case]
        entries.append(dict(
            name=f"row_gather_{variant}", route="cuda", source="sgnn_tpu_torch/csrc/row_gather.cu",
            replaces=f"scripts/gather_kernel_probe.py:{line}",
            launches=by_path["ms_dense_f32"] if variant == rg.MODEL_VARIANT else by_path["probe_bfloat16"],
            launches_by_path=by_path, model_variant=variant == rg.MODEL_VARIANT, dtype=main["dtype"],
            shape=main["shape"], max_abs_err=gather["max_abs_err"], tol="bit-identical (torch.equal)",
            checked=gather["checked"], ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"], bytes=main["bytes"],
            bound_share=main["bound_share"], kernel_ms_runs=main["kernel_ms_runs"],
            plain_ms_runs=main["plain_ms_runs"], host_loop_ms=main["host_loop_ms"],
            at_shapes={c: {k: r[k] for k in ("shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_share",
                                             "library_ms", "host_loop_ms")}
                       for c, r in res.items()},
        ))
    return entries


def train_routes_summary(trained, ms_train, smi):
    """Per training route (A, B, multi-scale dense f32, dense bf16, COO
    f32), the captured and eager steps' figures from ``training_routes``
    and the trainer's own logged ms/step (prefetched, captured), in one
    line."""
    paths = {f"train_{n}": (t[0]["routes"], t[0]["ms_per_step_11_20"]) for n, t in trained.items()}
    paths.update({f"ms_train_{n}": (r["routes"], r["ms_per_step_last_log"]) for n, r in ms_train.items()})
    out = {}
    for path, (routes, logged) in paths.items():
        out[path] = {"check": routes["check"], "trainer_logged_ms_per_step": logged}
        for name in ("captured", "eager"):
            r = routes[name]
            out[path][name] = {k: r[k] for k in ("wall_ms_per_step", "device_ms_per_step", "device_idle_share",
                                                 "kernels_per_step", "host_calls_per_step", "first_call_s",
                                                 "first_call_peak_memory_mb", "peak_memory_mb", "capture_s")
                               if k in r}
    return {"paths": out, "nvidia_smi": smi}


def routes_summary(rollouts, ms_runs, smi):
    """Per rollout path, each route's wall and device figures (from
    ``compare_routes``), in one line."""
    paths = {f"single_scale_{dt}": r["routes"] for dt, r in rollouts.items()}
    paths.update({f"multi_scale_{name}": r["routes"] for name, r in ms_runs.items()})
    out = {}
    for path, routes in paths.items():
        out[path] = {"check": routes["check"], "max_abs_diff_all_steps": routes["max_abs_diff_all_steps"]}
        for name in ("eager", "captured"):
            r, prof = routes[name], routes[name]["profile"]
            out[path][name] = {k: r[k] for k in r if k != "profile"}
            out[path][name].update({k: prof[k] for k in ("device_ms_per_step", "device_idle_share",
                                                         "kernels_per_step", "host_calls_per_step") if k in prof})
    return {"paths": out, "nvidia_smi": smi}


# --------------------------------------------------------------------------
# 11. parallel runs: replicas and shards on the one card
# --------------------------------------------------------------------------


def step_outputs(built, batch, noise, step=0):
    """One step of ``built`` on ``batch`` with ``noise`` injected (the eager
    route): metrics, gradients, parameters before and after, as
    ``compare_steps`` reads them."""
    before = {k: v.detach().clone() for k, v in built.sim.state_dict().items()}
    metrics = {k: float(v) for k, v in built.step_fn(batch, step, noise=noise).items()}
    return dict(metrics=metrics, before=before,
                grads={k: p.grad.detach().clone() for k, p in built.sim.named_parameters()},
                params={k: v.detach().clone() for k, v in built.sim.state_dict().items()})


def allclose_report(where, got, want, rtol, atol, atol_rel=0.0):
    """``|got - want| <= atol + atol_rel max|want| + rtol |want|`` (numpy's
    assert_allclose rule, and a share of each tensor's largest entry) over
    every tensor of two dicts; the worst ratio of error to limit."""
    worst = 0.0
    for k, w in want.items():
        err = (got[k].double() - w.double()).abs()
        limit = atol + atol_rel * float(w.abs().max()) + rtol * w.double().abs()
        worst = max(worst, float((err / limit).max()))
        if (err > limit).any():
            raise AssertionError(f"{where}: {k} max |err| {float(err.max()):.3e} over atol {atol} + rtol {rtol}")
    return worst


def dp_a_route(root: Path, data: Path, card, smi: str):
    """Config A with ``data_parallel: 2`` on [card, card]: ``train`` for
    TRAIN_STEPS steps (launches: twice A's per step, the validation as A's),
    one step against the single-device step on the same batch and noise
    (STEP_TOL["A"]), the NCCL group's step against the one without
    (torch.equal), captured against eager and two eager runs
    (``training_routes``: torch.equal)."""
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.parallel import multihost
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train as trainer

    devices = [card, card]
    cfg = train_config(root, data, "A", run_name="smoke_dp_A", data_parallel=2)
    valid = TrajectoryLoader(data / "valid.npz", pad_multiple=cfg.pad_multiple)
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    layers = cfg.layers
    expect = dict(fwd=2 * layers * TRAIN_STEPS + layers * val_steps * (TRAIN_STEPS // SAVE_EVERY),
                  bwd=2 * layers * TRAIN_STEPS, take=4 * layers * TRAIN_STEPS, sorted=2 * layers * TRAIN_STEPS)
    torch.cuda.synchronize()
    eb.LAUNCHES = eb.BWD_LAUNCHES = 0
    reset_gather_launches()
    reset_bwd_gather_launches()
    result = trainer.train(cfg, device=card, devices=devices)
    got = dict(fwd=eb.LAUNCHES, bwd=eb.BWD_LAUNCHES, take=rg.LAUNCHES[rg.MODEL_VARIANT],
               sorted=rg.BWD_LAUNCHES["sorted"])
    if got != expect or result["step"] != TRAIN_STEPS or not math.isfinite(result["lowest_eval_loss"]):
        raise AssertionError(f"dp A: launches {got}, expected {expect}; {result}")
    records = [json.loads(line) for line in (Path(cfg.model_path) / cfg.run_name / "metrics.jsonl").open()]
    logged = [r["train/step_time_s"] * 1e3 for r in records if "train/step_time_s" in r]

    # one step against the single-device step, and inside a one-process NCCL group
    single_cfg = train_config(root, data, "A", run_name="smoke_dp_A_single")
    built = trainer.build_training(cfg, card, devices=devices)
    batch = trainer.batch_to_device(next(built.epochs()), card)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                       generator=torch.Generator(device=card).manual_seed(2), device=card)
    dp = step_outputs(built, batch, noise)
    del built
    single = step_outputs(trainer.build_training(single_cfg, card), batch, noise)
    worst = compare_steps("dp A vs one device", dp, single, STEP_TOL["A"], cfg.lr_init + 1e-6)
    multihost.initialize(f"tcp://localhost:{free_port()}", world_size=1, rank=0)  # NCCL: the card's backend
    try:
        backend = torch.distributed.get_backend()
        in_group = step_outputs(trainer.build_training(cfg, card, devices=devices), batch, noise)
    finally:
        multihost.shutdown()
    group_equal = (all(torch.equal(v, dp["grads"][k]) for k, v in in_group["grads"].items())
                   and all(torch.equal(v, dp["params"][k]) for k, v in in_group["params"].items())
                   and in_group["metrics"] == dp["metrics"])
    if backend != ("nccl" if card.type == "cuda" else "gloo"):
        raise AssertionError(f"dp A: multihost.initialize formed a {backend} group on {card}")
    if not group_equal:
        raise AssertionError(f"dp A: the step in a one-process {backend} group differs from the one without")
    torch.cuda.empty_cache()
    routes = training_routes("dp A", cfg, card, trainer, repeat_eager=True, devices=devices)
    return dict(config="A", data_parallel=2, devices=[str(d) for d in devices], launches=got, expected_launches=expect,
                trainer_logged_ms_per_step=logged, vs_one_device=worst, tol=STEP_TOL["A"],
                nccl_group=dict(backend=backend, equal=group_equal, check="torch.equal: gradients, parameters, "
                                "metrics of one step in a one-process NCCL group vs without"),
                routes=routes, nvidia_smi=smi)


def dp_ms_route(root: Path, data: Path, card, smi: str):
    """The multi-scale model (dense f32, taylor2d_multi_scale.yaml's values,
    batch 16) with ``data_parallel: 2`` on [card, card]: one step against the
    single-device step (STEP_TOL["MS_f32"]); captured against eager
    (``training_routes``: torch.equal), twice the single step's launches."""
    import torch

    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train_multi_scale as tms

    devices = [card, card]
    cfg = ms_train_config(root, data, "dense_f32", run_name="smoke_dp_ms", data_parallel=2)
    built = tms.build_training(cfg, card, devices=devices)
    blocks = ms_blocks(built.batcher.graphs[0])
    batch = tms.batch_to_device(next(built.epochs()), card)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                       generator=torch.Generator(device=card).manual_seed(2), device=card)
    dp = step_outputs(built, batch, noise)
    del built
    single = step_outputs(tms.build_training(ms_train_config(root, data, "dense_f32"), card), batch, noise)
    worst = compare_steps("dp ms vs one device", dp, single, STEP_TOL["MS_f32"], cfg.lr_init + 1e-6)
    del batch, noise, single, dp
    torch.cuda.empty_cache()
    routes = training_routes("dp ms dense_f32", cfg, card, tms, devices=devices)
    expect = dict(take=2 * 3 * blocks, sorted=2 * 2 * blocks, planned=2 * blocks,  # twice one replica's
                  **dict.fromkeys(EPILOGUE_KEYS, 2 * blocks))
    got = {k: routes["captured"]["launches_per_step"][k] for k in expect}
    if got != expect:
        raise AssertionError(f"dp ms: launches per step {got}, expected {expect}")
    return dict(run="dense_f32", data_parallel=2, batch_size=cfg.batch_size, blocks=blocks,
                launches_per_step=got, vs_one_device=worst, tol=STEP_TOL["MS_f32"], routes=routes, nvidia_smi=smi)


def gp_vs_one_device(where, cfg, single_cfg, card, sym_expect, tol):
    """The first step of a graph-parallel run against the single-device step
    on the same sorted sample and noise, to ``tol``."""
    import torch

    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train as trainer

    built = trainer.build_training(cfg, card, devices=[card, card])
    spec = built.spec
    batch = trainer.batch_to_device(next(built.epochs()), card)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                       generator=torch.Generator(device=card).manual_seed(2), device=card)
    calls = sg.BWD_CALLS
    gp = step_outputs(built, batch, noise)
    sym_calls = sg.BWD_CALLS - calls
    del built
    single = step_outputs(trainer.build_training(single_cfg, card, batch_size=1),
                          {k: v[None] for k, v in batch.items()}, noise[None])
    loss_rel = abs(gp["metrics"]["train/loss"] - single["metrics"]["train/loss"]) / abs(single["metrics"]["train/loss"])
    if gp["metrics"]["train/halo_violations"] != 0 or loss_rel > tol["loss_rtol"] or sym_calls != sym_expect:
        raise AssertionError(f"{where}: violations {gp['metrics']['train/halo_violations']}, loss {loss_rel:.3e} "
                             f"relative, sym_gather backward passes {sym_calls} (expected {sym_expect})")
    grad_worst = allclose_report(f"{where} gradients", gp["grads"], single["grads"], tol["grad_rtol"],
                                 tol.get("grad_atol", 0.0), tol.get("grad_atol_rel", 0.0))
    return dict(spec=dict(num_shards=spec.num_shards, nodes_per_shard=spec.nodes_per_shard, halo=spec.halo),
                nodes=int(batch["node_mask"].sum()), loss_rel=loss_rel, grad_err_over_limit=grad_worst,
                sym_gather_backward=sym_calls, tol=tol)


def gp_a_route(root: Path, data: Path, card, smi: str):
    """Config A with ``graph_parallel: 2`` (batch 1) on [card, card]:
    ``train`` for TRAIN_STEPS steps (violations and rejections printed), the
    first step against the single-device step (GP_TOL), captured against
    eager (``training_routes``), and ``predict`` on the test split against
    the single-device captured rollout (GP_ROLLOUT_TOL), the replanning
    rollout's captured route against its eager one (torch.equal)."""
    import pickle

    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_metadata
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.parallel.edge_partition import dataset_partition_plan, make_replanning_rollout
    from sgnn_tpu_torch.parallel.mesh import make_mesh
    from sgnn_tpu_torch.physics.rollout import rollout
    from sgnn_tpu_torch.physics.simulator import make_norm_stats, simulator_init
    from sgnn_tpu_torch.train import train as trainer
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager

    devices, shards = [card, card], 2
    cfg = train_config(root, data, "A", run_name="smoke_gp_A", graph_parallel=shards, batch_size=1)
    single_cfg = train_config(root, data, "A", run_name="smoke_gp_A_single")
    layers = cfg.layers
    valid = TrajectoryLoader(data / "valid.npz", pad_multiple=cfg.pad_multiple)
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    train_part = dict(fwd=shards * layers * TRAIN_STEPS, bwd=shards * layers * TRAIN_STEPS,
                      take=2 * shards * layers * TRAIN_STEPS, sorted=shards * layers * TRAIN_STEPS)
    torch.cuda.synchronize()
    eb.LAUNCHES = eb.BWD_LAUNCHES = 0
    reset_gather_launches()
    reset_bwd_gather_launches()
    result = trainer.train(cfg, device=card, devices=devices)
    got = dict(fwd=eb.LAUNCHES, bwd=eb.BWD_LAUNCHES, take=rg.LAUNCHES[rg.MODEL_VARIANT],
               sorted=rg.BWD_LAUNCHES["sorted"])
    # the validation's re-planned steps run again: every frame is one
    # forward per shard and layer, and each re-plan one more
    val_fwd = got["fwd"] - train_part["fwd"]
    val_replans, rest = divmod(val_fwd - shards * layers * val_steps * (TRAIN_STEPS // SAVE_EVERY), shards * layers)
    if ({k: got[k] for k in ("bwd", "take", "sorted")} != {k: train_part[k] for k in ("bwd", "take", "sorted")}
            or val_replans < 0 or rest or result["step"] != TRAIN_STEPS):
        raise AssertionError(f"gp A: launches {got}, expected {train_part} + the validation's; {result}")
    run_dir = Path(cfg.model_path) / cfg.run_name
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    train_rec = [r for r in records if "train/loss" in r]
    violations = [r["train/halo_violations"] for r in train_rec]
    rejected = [r["train/halo_rejected"] for r in train_rec]
    log(f"gp A: halo violations at the logged steps {violations}, rejected {rejected}; "
        f"validation re-plans {val_replans}")
    first = gp_vs_one_device("gp A vs one device", cfg, single_cfg, card, 0, GP_TOL)
    torch.cuda.empty_cache()
    routes = training_routes("gp A", cfg, card, trainer, devices=devices)

    # predict, partitioned, from the run's checkpoint; against the
    # single-device captured rollout on the layout the partitioned one
    # starts from (its initial x-sort): where the neighbour cap or a cell's
    # capacity binds, the lowest indices are kept, so two orders of the
    # same particles may keep other neighbours (tests/test_edge_partition.py
    # holds its single-device reference on the sorted layout too)
    meta = json.loads((run_dir / "checkpoint_meta.json").read_text())
    metadata = load_metadata(data)
    test = TrajectoryLoader(data / "test.npz", pad_multiple=cfg.pad_multiple)
    steps = [p.shape[0] - cfg.input_sequence_length for p, _, _ in test.trajectories]
    c = dataclasses.replace(cfg, mode="rollout", model_file=meta["path"], output_path=str(root / "gp_predict"))
    eb.LAUNCHES = 0
    trainer.predict(c, device=card, devices=devices)
    fwd = eb.LAUNCHES
    outs = [pickle.loads((root / "gp_predict" / c.run_name / f"{case.replace('.npz', '')}.pkl").read_bytes())
            for case in metadata["file_test"]]  # predict's order: the loader's
    replans = [int(o["replans"]) for o in outs]
    expect_fwd = shards * layers * (sum(steps) + sum(replans))
    if fwd != expect_fwd or len(outs) != len(steps) or any(replans):
        raise AssertionError(f"gp A predict: edge_block_fwd launches {fwd}, expected {expect_fwd}; "
                             f"re-plans {replans} (the comparison below needs none)")
    sim_cfg = trainer.simulator_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=card)
    sim = simulator_init(sim_cfg, device=card)
    state, _ = CheckpointManager(run_dir).restore(meta["path"], map_location=card)
    sim.load_state_dict(state["params"], strict=True)
    worst = {}
    for gp, traj in zip(outs, test):
        m = np.asarray(traj["node_mask"], bool)
        idx = np.nonzero(m)[0]
        order = idx[np.argsort(traj["positions"][idx, 0, 0], kind="stable")]  # the replanning rollout's first plan
        one = rollout(sim, sim_cfg, stats, traj["positions"][order], traj["particle_type"][order],
                      traj["strains"][:, order], device=card)
        for key, (rtol, atol) in GP_ROLLOUT_TOL.items():
            a, b = np.asarray(gp[key]), one[key].cpu().numpy()
            if key != "rmse_position":
                a = a[:, order]
            ratio = float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())
            worst[key] = max(worst.get(key, 0.0), ratio)
        if int(np.sum(gp["halo_violations"])):
            raise AssertionError(f"gp A predict: residual halo violations {gp['halo_violations']}")
    log(f"gp A predict vs the one-device captured rollout: worst |err| / limit {worst}; re-plans {replans}")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"gp A predict: partitioned rollout outside {GP_ROLLOUT_TOL} of one device's: {worst}")

    # the replanning rollout's captured route against its eager one, timed
    spec = dataset_partition_plan(trainer.partition_frames(test.trajectories), shards, cfg.connection_radius)
    run = make_replanning_rollout(make_mesh(graph=shards, devices=devices), sim_cfg, stats, spec)
    traj = next(iter(test))
    args = (traj["positions"], traj["particle_type"], traj["strains"], traj["node_mask"])
    timed = {}
    for name, capture in (("captured", True), ("eager", False), ("captured_warm", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(sim, *args, capture=capture)
        torch.cuda.synchronize()
        timed[name] = dict(ms_per_step=(time.perf_counter() - t0) * 1e3 / steps[0], out=out)
    same = all(torch.equal(timed["captured"]["out"][k], timed["eager"]["out"][k])
               for k in ("predicted_rollout", "predicted_strain", "halo_violations"))
    if not same:
        raise AssertionError("gp A: the captured replanning rollout differs from its eager one")
    rollout_routes = {n: t["ms_per_step"] for n, t in timed.items()}
    log(f"gp A replanning rollout routes (wall ms/step, host clock, per-frame guard read): {rollout_routes}")
    return dict(config="A", graph_parallel=shards, devices=[str(d) for d in devices], launches=got,
                training_launches=train_part, validation_replans=val_replans, halo_violations=violations,
                halo_rejected=rejected, first_step_vs_one_device=first, routes=routes,
                predict=dict(fwd_launches=fwd, replans=replans, worst_err_over_limit=worst, tol=GP_ROLLOUT_TOL,
                             rollout_steps=steps, reference="the one-device captured rollout on the first plan's "
                             "x-sorted layout"),
                replanning_rollout=dict(check="torch.equal: predicted positions, strains, violations; captured "
                                        "vs eager", wall_ms_per_step=rollout_routes),
                nvidia_smi=smi)


def make_big_bar(root: Path) -> Path:
    """A second synthetic bar of GP_BIG_BAR particles (the symmetric sharded
    route's size): one training and one validation run, short."""
    from sgnn_tpu_torch.data.builder import DatasetBuilder
    from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

    generate_synthetic_raw_dataset(root / "raw_big", num_sims=2, **GP_BIG_BAR, seed=1)
    DatasetBuilder(root / "raw_big", root / "data_big", total_steps=GP_BIG_BAR_KEPT_STEPS,
                   val_patterns=["-110"]).build()
    return root / "data_big"


def gp_sym_route(root: Path, card, smi: str):
    """Config B (bf16, symmetric gather by the auto-rule) with
    ``graph_parallel: 2`` on the big bar: ``train`` for GP_SYM_STEPS steps
    (the sharded symmetric route: its backward once per layer and shard),
    the first step against the single-device step (GP_SYM_TOL), captured
    against eager."""
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_metadata
    from sgnn_tpu_torch.ops import edge_block as eb
    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.train import train as trainer

    data = make_big_bar(root)
    devices, shards = [card, card], 2
    kw = dict(run_name="smoke_gp_B_sym", ntraining_steps=GP_SYM_STEPS, nsave_steps=GP_SYM_STEPS, log_every=1)
    cfg = train_config(root, data, "B", graph_parallel=shards, batch_size=1, **kw)
    sim_cfg = trainer.simulator_config_from(cfg, load_metadata(data))
    if not sim_cfg.symmetric_gather:
        raise AssertionError("gp B: the auto-rule left the symmetric gather off on the big bar")
    torch.cuda.synchronize()
    eb.LAUNCHES = eb.BWD_LAUNCHES = sg.BWD_CALLS = 0
    result = trainer.train(cfg, device=card, devices=devices)
    got = dict(bwd=eb.BWD_LAUNCHES, sym_bwd=sg.BWD_CALLS, fwd=eb.LAUNCHES)
    expect = dict(bwd=shards * cfg.layers * GP_SYM_STEPS, sym_bwd=shards * cfg.layers * GP_SYM_STEPS)
    valid = TrajectoryLoader(data / "valid.npz", pad_multiple=cfg.pad_multiple)
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    val_replans, rest = divmod(got["fwd"] - shards * cfg.layers * (GP_SYM_STEPS + val_steps), shards * cfg.layers)
    if {k: got[k] for k in expect} != expect or val_replans < 0 or rest or result["step"] != GP_SYM_STEPS:
        raise AssertionError(f"gp B: launches {got}, expected {expect} and the validation's; {result}")
    records = [json.loads(line) for line in (Path(cfg.model_path) / cfg.run_name / "metrics.jsonl").open()]
    violations = [r["train/halo_violations"] for r in records if "train/halo_violations" in r]
    single_cfg = train_config(root, data, "B", **kw)
    first = gp_vs_one_device("gp B (symmetric, bf16) vs one device", cfg, single_cfg, card, shards * cfg.layers,
                             GP_SYM_BF16_TOL)
    # the route's math at the JAX test's f32 tolerances: B's graph and
    # gather, f32 edge tensors
    f32 = dict(compute_dtype="float32", symmetric_gather=True)
    first_f32 = gp_vs_one_device("gp B (symmetric, f32) vs one device", dataclasses.replace(cfg, **f32),
                                 dataclasses.replace(single_cfg, **f32), card, shards * cfg.layers, GP_SYM_TOL)
    if first["spec"]["nodes_per_shard"] < GP_SYM_MIN_LOCAL_ROWS:
        raise AssertionError(f"gp B: {first['spec']} holds fewer local rows than the symmetric route needs")
    torch.cuda.empty_cache()
    routes = training_routes("gp B sym", cfg, card, trainer, devices=devices)
    return dict(config="B", graph_parallel=shards, nodes=first["nodes"], launches=got, expected_launches=expect,
                validation_replans=val_replans, halo_violations=violations, first_step_vs_one_device=first,
                first_step_f32_vs_one_device=first_f32, routes=routes, nvidia_smi=smi)


def gp_ms_blocks(graph) -> int:
    """Interaction blocks of one partitioned forward over ``graph``'s layout
    (the dense layout's m2m blocks run per scale)."""
    from sgnn_tpu_torch.parallel.ms_partition import ShardedDenseMSGraph

    per_layer = len(graph.m2m) if isinstance(graph, ShardedDenseMSGraph) else 1
    return 2 + MS_MODEL["layers"] * per_layer


def gp_ms_plan_sizes(built) -> dict:
    """The plan's slab, halo and per-type sizes (COO: edge slots per shard;
    dense: receiver rows, slots, plan rows and plan slots per shard)."""
    from sgnn_tpu_torch.parallel.ms_partition import ShardedDenseMSGraph

    spec, graph = built.spec, built.graphs[0]
    out = dict(num_shards=spec.num_shards, nodes_per_shard=spec.nodes_per_shard, halo=spec.halo,
               trajectories=len(built.graphs))
    if isinstance(graph, ShardedDenseMSGraph):
        def sizes(de):
            return [int(de.recv.shape[1]), int(de.senders.shape[2]), int(de.tsp_node.shape[1]),
                    int(de.tsp_rows.shape[2])]

        out["dense_rows_slots_plan_rows_plan_slots"] = dict(g2m=sizes(graph.g2m), m2m=[sizes(d) for d in graph.m2m],
                                                           m2g=sizes(graph.m2g))
    else:
        out["coo_edge_slots_per_shard"] = {k: int(getattr(graph, k).senders.shape[1]) for k in ("g2m", "m2m", "m2g")}
    return out


def sorted_ms_graph(graph_cfg, frame, dense: bool):
    """The one-device static graph of ``frame`` (already x-sorted) at its
    exact sizes: what the partitioned run's plan holds, on one device."""
    from sgnn_tpu_torch.physics import multi_scale_graph as mg

    if dense:
        n = len(frame)
        return mg.build_dense_static_graph(graph_cfg, frame, g2m_rows=n, m2m_rows=n, m2g_rows=n)
    edges = mg.create_all_edges(graph_cfg, frame)
    return mg.StaticGraph(*(mg.pad_edges(edges[k], len(edges[k].senders))
                            for k in ("grid2mesh_edges", "mesh2mesh_edges", "mesh2grid_edges")))


def gp_ms_first_step(where, cfg, card, tol):
    """The first step of a graph-parallel multi-scale run against the
    one-device step on the same x-sorted sample (its real nodes), graph and
    noise: the loss and the parameters after Adam to ``tol`` (numpy's
    allclose rule, every parameter), the gradients reported; and the
    forward of the sample, partitioned against one device. Returns the
    worst ratios of error to limit and the plan's sizes."""
    import torch

    from sgnn_tpu_torch.data.prefetch import tree_map
    from sgnn_tpu_torch.parallel.ms_partition import ShardedDenseMSGraph, make_ms_partitioned_forward
    from sgnn_tpu_torch.physics.multi_scale_simulator import _forward, graph_to
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train_multi_scale as tms

    built = tms.build_training(cfg, card, devices=[card, card])
    plan = gp_ms_plan_sizes(built)
    dense = isinstance(built.graphs[0], ShardedDenseMSGraph)
    host = next(built.batcher.epochs())
    ti = int(host["traj_idx"][0])
    order = built.orders[ti]
    n = len(order)
    frame = built.batcher.trajectories[ti][0][0][order]
    batch = tms.batch_to_device({**tms.ms_partition_sample(host, built.spec, order), "graph": built.graphs[ti]},
                                card)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                       generator=torch.Generator(device=card).manual_seed(2), device=card)
    with torch.no_grad():
        fwd = make_ms_partitioned_forward(built.mesh, built.sim_cfg, built.stats, built.spec)(
            built.sim, batch["positions"], batch["particle_type"], batch["graph"])
    before = _launch_counts()
    gp = step_outputs(built, batch, noise)
    step_launches = {k: v - before[k] for k, v in _launch_counts().items()
                     if k in ("take", "sorted", "planned") + EPILOGUE_KEYS}
    blocks, shards = gp_ms_blocks(built.graphs[0]), built.spec.num_shards
    # per shard and block, as one device's step (see run_ms_train); the
    # epilogue kernels per shard and dense block in f32
    expect = dict(take=shards * (3 if dense else 4) * blocks, sorted=shards * (2 if dense else 3) * blocks,
                  planned=shards * blocks if dense else 0,
                  **dict.fromkeys(EPILOGUE_KEYS, shards * blocks if dense and cfg.compute_dtype == "float32" else 0))
    if step_launches != expect:
        raise AssertionError(f"{where}: the partitioned step launched {step_launches}, expected {expect}")
    del built
    torch.cuda.empty_cache()
    single_cfg = dataclasses.replace(cfg, graph_parallel=1, ms_dense=dense, run_name=cfg.run_name + "_single")
    one_built = tms.build_training(single_cfg, card, batch_size=1)
    one_batch = {k: v[None, :n] for k, v in batch.items() if k != "graph"}
    one_batch["graph"] = graph_to(tree_map(lambda a: a[None], sorted_ms_graph(one_built.sim_cfg.graph_config,
                                                                               frame, dense)), card)
    with torch.no_grad():
        flat = graph_to(sorted_ms_graph(one_built.sim_cfg.graph_config, frame, dense), card)
        one_fwd = _forward(one_built.sim, one_built.sim_cfg, one_built.stats, batch["positions"][:n],
                           batch["particle_type"][:n], flat)
    one = step_outputs(one_built, one_batch, noise[None, :n])
    del one_built
    rtol, atol = tol["param"]
    fwd_worst = allclose_report(f"{where} forward", {"acc": fwd[0][:n], "strain": fwd[1][:n]},
                                {"acc": one_fwd[0], "strain": one_fwd[1]}, *tol["forward"])
    loss_rel = {k: abs(v - one["metrics"][k]) / abs(one["metrics"][k]) for k, v in gp["metrics"].items()}
    if max(loss_rel.values()) > tol["loss_rtol"]:
        raise AssertionError(f"{where}: metrics {gp['metrics']} vs {one['metrics']}")
    grad_worst, grad_at = 0.0, None
    for k, g in one["grads"].items():  # compare_steps' gradient rule
        err = (gp["grads"][k] - g).abs()
        limit = tol["grad_rel"] * (float(g.abs().max()) + g.abs())
        if float((err / limit).max()) > grad_worst:
            grad_worst = float((err / limit).max())
            grad_at = dict(param=k, max_err=float(err.max()), scale=float(g.abs().max()))
        if (err > limit).any():
            raise AssertionError(f"{where}: gradient {k} max |err| {float(err.max()):.3e}")
    adam = adam_step_report(f"{where} parameters after Adam", gp, one, rtol, atol, cfg.lr_init + 1e-6)
    return dict(plan=plan, layout="dense" if dense else "coo", nodes=n, step_launches=step_launches,
                metrics_rel=loss_rel, grad_err_over_limit=grad_worst, grad_worst=grad_at, params_after_adam=adam,
                forward_err_over_limit=fwd_worst, tol=tol)


def adam_step_report(where, got, want, rtol, atol, lr):
    """The parameters after Adam's first step of two runs whose gradients
    agree to (rtol, atol): each entry within atol + rtol |p| plus what Adam
    makes of the two gradients. Its first step moves an entry by lr * g /
    (|g| + eps), which two gradients g1, g2 of one sign move apart by at
    most lr * |g1 - g2| / max(|g1|, |g2|) (and by up to 2 lr where their
    signs differ): near Adam's eps (1e-8) a gradient's rounding in the
    last bits becomes a share of lr (``compare_steps``' rule, its update
    rounding 1e-5 lr). Also reports the bare (rtol, atol) ratio and the
    gradients at its worst entry."""
    import torch

    worst, bare, at = 0.0, 0.0, None
    for k, p_want in want["params"].items():
        g1, g2 = got["grads"][k], want["grads"][k]
        apart = torch.where(g1 * g2 < 0, 2.0,
                            torch.clamp((g1 - g2).abs() / torch.maximum(g1.abs(), g2.abs()).clamp(min=1e-30), max=2.0))
        err = (got["params"][k] - p_want).abs().double()
        plain = atol + rtol * p_want.abs().double()
        allowed = plain + lr * (1e-5 + apart.double())
        worst = max(worst, float((err / allowed).max()))
        ratio = err / plain
        if float(ratio.max()) > bare:
            i = int(ratio.argmax())
            bare = float(ratio.max())
            at = dict(param=k, err=float(err.reshape(-1)[i]), grad=float(g2.reshape(-1)[i]),
                      grad_other=float(g1.reshape(-1)[i]))
        if (err > allowed).any():
            raise AssertionError(f"{where}: {k} max |err| {float(err.max()):.3e} over the limit")
    return dict(err_over_limit=worst, bare_err_over_limit=bare, bare_worst=at)


def gp_ms_rollout_check(where, cfg, run_dir, card):
    """The partitioned host rollout of the validation trajectory (COO, from
    the run's checkpoint) against the one-device captured rollout on the
    same sorted layout over the whole trajectory (GP_MS_ROLLOUT_TOL); the
    partitioned rollout's captured route against its eager one
    (torch.equal), each timed."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.parallel.mesh import make_mesh
    from sgnn_tpu_torch.parallel.ms_partition import make_ms_partitioned_rollout, plan_ms_partition
    from sgnn_tpu_torch.physics.multi_scale_simulator import ms_rollout, multi_scale_simulator_init
    from sgnn_tpu_torch.physics.simulator import make_norm_stats
    from sgnn_tpu_torch.train import train_multi_scale as tms
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager

    meta = json.loads((run_dir / "checkpoint_meta.json").read_text())
    metadata = load_metadata(Path(cfg.data_path))
    sim_cfg = tms.ms_config_from(cfg, metadata)
    stats = make_norm_stats(metadata, cfg.noise_std, device=card)
    sim = multi_scale_simulator_init(sim_cfg, device=card)
    state, _ = CheckpointManager(run_dir).restore(meta["path"], map_location=card)
    sim.load_state_dict(state["params"], strict=True)
    built = tms.build_training(cfg, card, devices=[card, card])
    spec, mesh = built.spec, built.mesh
    del built
    loader = tms.make_loader(cfg, sim_cfg, "valid")
    traj = next(iter(loader))
    m = np.asarray(traj["node_mask"], bool)
    idx = np.nonzero(m)[0]
    host = tms.make_ms_partitioned_host_rollout(mesh, sim_cfg, stats, spec, cfg.inference_mode,
                                                frames=[p[0] for p, _, _ in loader.trajectories])
    gp = host(sim, traj["positions"], traj["particle_type"], traj["strains"], traj["node_mask"], None)
    _, order_rel, sgraph = plan_ms_partition(sim_cfg.graph_config, traj["positions"][idx, 0], spec.num_shards,
                                             nodes_per_shard=spec.nodes_per_shard, halo=spec.halo)
    order = idx[order_rel]
    frame = traj["positions"][order, 0]
    one = ms_rollout(sim, sim_cfg, stats, traj["positions"][order], traj["particle_type"][order],
                     traj["strains"][:, order], sorted_ms_graph(sim_cfg.graph_config, frame, False), device=card)
    worst = {}
    for key, (rtol, atol) in GP_MS_ROLLOUT_TOL.items():
        a, b = gp[key], one[key]
        if key != "rmse_position_per_step":
            a = a[:, torch.as_tensor(order, device=card)]
        worst[key] = allclose_report(f"{where} rollout", {key: a}, {key: b}, rtol, atol)
    # the partitioned rollout's two routes on the sorted layout, timed
    nt, k = spec.total_nodes, len(order)
    pos = np.zeros((nt, *traj["positions"].shape[1:]), np.float32)
    pos[:k] = traj["positions"][order]
    strains = np.zeros((traj["strains"].shape[0], nt), np.float32)
    strains[:, :k] = traj["strains"][:, order]
    types = np.zeros(nt, np.int32)
    types[:k] = traj["particle_type"][order]
    args = (pos, types, strains, np.arange(nt) < k, sgraph)
    run = make_ms_partitioned_rollout(make_mesh(graph=spec.num_shards, devices=[card, card]), sim_cfg, stats, spec,
                                      inference_mode=cfg.inference_mode)
    steps = pos.shape[1] - cfg.input_sequence_length
    timed = {}
    for name, capture in (("captured", True), ("eager", False), ("captured_warm", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(sim, *args, capture=capture)
        torch.cuda.synchronize()
        timed[name] = dict(ms_per_step=(time.perf_counter() - t0) * 1e3 / steps, out=out)
    if not all(torch.equal(timed["captured"]["out"][key], timed["eager"]["out"][key])
               for key in ("predicted_rollout", "predicted_strain")):
        raise AssertionError(f"{where}: the captured partitioned rollout differs from its eager one")
    return dict(steps=steps, worst_err_over_limit=worst, tol=GP_MS_ROLLOUT_TOL,
                reference="the one-device captured rollout (COO) on the plan's x-sorted layout",
                routes=dict(check="torch.equal: predicted positions and strains, captured vs eager",
                            wall_ms_per_step={name: t["ms_per_step"] for name, t in timed.items()}))


def gp_ms_route(root: Path, data: Path, name: str, card, smi: str):
    """The multi-scale model (taylor2d_multi_scale.yaml's values) with
    ``graph_parallel: 2``, batch 1, in the layout of ``name`` (dense_f32:
    ``ms_dense: True``; coo_f32: False) on [card, card]: ``train`` for
    TRAIN_STEPS steps validating at 10 and 20 through the partitioned host
    rollout, its launches against the counts the plan asks; the first step
    against one device (GP_MS_TOL); captured against eager
    (``training_routes``; COO: the eager step twice); the partitioned
    rollout against the one-device rollout (``gp_ms_rollout_check``)."""
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.train import train_multi_scale as tms

    dense = name.startswith("dense")
    devices, shards = [card, card], 2
    cfg = ms_train_config(root, data, name, run_name=f"smoke_gp_ms_{name}", graph_parallel=shards, batch_size=1,
                          ms_dense=dense, ntraining_steps=TRAIN_STEPS, nsave_steps=SAVE_EVERY, log_every=LOG_EVERY)
    built = tms.build_training(cfg, card, devices=devices)
    blocks = gp_ms_blocks(built.graphs[0])
    del built
    valid = tms.make_loader(cfg, tms.ms_config_from(cfg, load_metadata(data)), "valid")
    val_steps = sum(p.shape[0] - cfg.input_sequence_length for p, _, _ in valid.trajectories)
    rollout_steps = val_steps * (TRAIN_STEPS // SAVE_EVERY)
    val_blocks = 2 + MS_MODEL["layers"]  # the validation plans COO
    torch.cuda.synchronize()
    reset_gather_launches()
    reset_bwd_gather_launches()
    reset_epilogue_launches()
    t0 = time.perf_counter()
    result = tms.train(cfg, device=card, devices=devices)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = dict(rg.LAUNCHES, **{f"bwd_{k}": v for k, v in rg.BWD_LAUNCHES.items()})
    epilogue = epilogue_counts()
    # per shard, training step and block as on one device (see run_ms_train);
    # per shard, validation rollout step and block: two gathers, one sum
    expect = {v: 0 for v in rg.VARIANTS}
    expect[rg.MODEL_VARIANT] = shards * ((3 if dense else 4) * blocks * TRAIN_STEPS + 2 * val_blocks * rollout_steps)
    expect.update(bwd_sorted=shards * ((2 if dense else 3) * blocks * TRAIN_STEPS + val_blocks * rollout_steps),
                  bwd_planned=shards * blocks * TRAIN_STEPS if dense else 0)
    if got != expect or result["step"] != TRAIN_STEPS or not math.isfinite(result["lowest_eval_loss"]):
        raise AssertionError(f"gp ms {name}: launches {got}, expected {expect}; {result}")
    # the epilogue kernels per shard, dense block and training step (f32; the validation plans COO)
    expect_epilogue = dict.fromkeys(EPILOGUE_KEYS, shards * blocks * TRAIN_STEPS if dense else 0)
    if epilogue != expect_epilogue:
        raise AssertionError(f"gp ms {name}: edge_epilogue launches {epilogue}, expected {expect_epilogue}")
    run_dir = Path(cfg.model_path) / cfg.run_name
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rec = [r for r in records if "train/loss" in r]
    val_rec = [r for r in records if "val/loss" in r]
    if len(train_rec) != TRAIN_STEPS // LOG_EVERY or len(val_rec) != TRAIN_STEPS // SAVE_EVERY or not all(
            math.isfinite(v) for r in records for v in r.values()):
        raise AssertionError(f"gp ms {name}: metrics {records}")
    first = gp_ms_first_step(f"gp ms {name} vs one device", cfg, card, GP_MS_TOL[name])
    torch.cuda.empty_cache()
    log(f"gp ms {name}: first step vs one device {json.dumps(first)}")
    routes = training_routes(f"gp ms {name}", cfg, card, tms, repeat_eager=not dense, devices=devices)
    torch.cuda.empty_cache()
    rollout = gp_ms_rollout_check(f"gp ms {name}", cfg, run_dir, card)
    log(f"gp ms {name} rollout: {json.dumps(rollout)}")
    return dict(run=name, graph_parallel=shards, batch_size=1, blocks=blocks, validation_blocks=val_blocks,
                validation_rollout_steps=rollout_steps, launches=got, expected_launches=expect,
                epilogue_launches=epilogue, launches_per_step=routes["captured"]["launches_per_step"], wall_s=wall_s,
                ms_per_step_last_log=train_rec[-1]["train/step_time_s"] * 1e3,
                train_loss=[r["train/loss"] for r in train_rec], val_loss=[r["val/loss"] for r in val_rec],
                first_step_vs_one_device=first, routes=routes, rollout=rollout, nvidia_smi=smi)


def gp_ms_bf16_route(root: Path, data: Path, card, smi: str):
    """The multi-scale model, dense bf16, ``graph_parallel: 2``: one step
    (eager, injected noise) against the one-device step within
    GP_MS_TOL["dense_bf16"], the forward too; its launches."""
    import torch

    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.train import train_multi_scale as tms

    cfg = ms_train_config(root, data, "dense_bf16", run_name="smoke_gp_ms_dense_bf16", graph_parallel=2,
                          batch_size=1, ms_dense=True)
    torch.cuda.synchronize()
    reset_gather_launches()
    reset_bwd_gather_launches()
    first = gp_ms_first_step("gp ms dense_bf16 vs one device", cfg, card, GP_MS_TOL["dense_bf16"])
    log(f"gp ms dense_bf16: first step vs one device {json.dumps(first)}")
    return dict(run="dense_bf16", graph_parallel=2, first_step_vs_one_device=first,
                launches_per_step=first["step_launches"], nvidia_smi=smi)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def add_parallel_launches(kernels, par) -> None:
    """The parallel routes' launches in the kernel summary's
    ``launches_by_path`` (the multi-scale DP route's per captured step)."""
    dp, gp, sym = par["dp_A"], par["gp_A"], par["gp_B_sym"]
    ms = par["dp_ms_dense_f32"]["launches_per_step"]
    gd, gc = par["gp_ms_dense_f32"], par["gp_ms_coo_f32"]
    gb = par["gp_ms_dense_bf16"]["launches_per_step"]
    paths = {
        ("edge_block_fwd", "float32"): {"dp_train_A": dp["launches"]["fwd"], "gp_train_A": gp["launches"]["fwd"],
                                        "gp_predict_A": gp["predict"]["fwd_launches"]},
        ("edge_block_fwd", "bfloat16"): {"gp_train_B_sym": sym["launches"]["fwd"]},
        ("edge_block_bwd", "float32"): {"dp_train_A": dp["launches"]["bwd"], "gp_train_A": gp["launches"]["bwd"]},
        ("edge_block_bwd", "bfloat16"): {"gp_train_B_sym": sym["launches"]["bwd"]},
        ("row_gather_take", None): {"dp_train_A": dp["launches"]["take"], "gp_train_A": gp["launches"]["take"],
                                    "dp_ms_dense_f32_per_step": ms["take"],
                                    "gp_train_ms_dense_f32": gd["launches"]["take"],
                                    "gp_train_ms_coo_f32": gc["launches"]["take"],
                                    "gp_ms_dense_f32_per_step": gd["launches_per_step"]["take"],
                                    "gp_ms_coo_f32_per_step": gc["launches_per_step"]["take"],
                                    "gp_ms_dense_bf16_per_step": gb["take"]},
        ("sorted_segment_sum", None): {"dp_train_A": dp["launches"]["sorted"],
                                       "gp_train_A": gp["launches"]["sorted"],
                                       "dp_ms_dense_f32_per_step": ms["sorted"],
                                       "gp_train_ms_dense_f32": gd["launches"]["bwd_sorted"],
                                       "gp_train_ms_coo_f32": gc["launches"]["bwd_sorted"],
                                       "gp_ms_dense_f32_per_step": gd["launches_per_step"]["sorted"],
                                       "gp_ms_coo_f32_per_step": gc["launches_per_step"]["sorted"],
                                       "gp_ms_dense_bf16_per_step": gb["sorted"]},
        ("planned_gather_bwd", None): {"dp_ms_dense_f32_per_step": ms["planned"],
                                       "gp_train_ms_dense_f32": gd["launches"]["bwd_planned"],
                                       "gp_ms_dense_f32_per_step": gd["launches_per_step"]["planned"],
                                       "gp_ms_dense_bf16_per_step": gb["planned"]},
    }
    for kname, key in (("edge_epilogue_fwd", "epilogue_fwd"), ("edge_epilogue_bwd", "epilogue_bwd")):
        paths[(kname, "float32")] = {"dp_ms_dense_f32_per_step": ms[key],
                                     "gp_train_ms_dense_f32": gd["epilogue_launches"][key],
                                     "gp_train_ms_coo_f32": gc["epilogue_launches"][key],
                                     "gp_ms_dense_f32_per_step": gd["launches_per_step"][key],
                                     "gp_ms_coo_f32_per_step": gc["launches_per_step"][key],
                                     "gp_ms_dense_bf16_per_step": gb[key]}
    for key in F32_PRODUCT_KEYS:
        paths[(key, "float32")] = {"parallel_phase": par["f32_product_launches"][key],
                                   "gp_ms_dense_f32_per_step": gd["launches_per_step"][key],
                                   "gp_ms_coo_f32_per_step": gc["launches_per_step"][key]}
    for entry in kernels:
        for key in ((entry["name"], entry.get("dtype")), (entry["name"], None)):
            entry["launches_by_path"].update(paths.get(key, {}))


def phase_parallel(root: Path, data: Path, card, smi: str):
    """Phase 11: every parallel route, each with its launch counters reset
    just before it; one ``parallel {...}`` line."""
    import torch

    reset_f32_product_launches()
    out = {}
    for name, fn in (("dp_A", lambda: dp_a_route(root, data, card, smi)),
                     ("dp_ms_dense_f32", lambda: dp_ms_route(root, data, card, smi)),
                     ("gp_A", lambda: gp_a_route(root, data, card, smi)),
                     ("gp_B_sym", lambda: gp_sym_route(root, card, smi)),
                     ("gp_ms_dense_f32", lambda: gp_ms_route(root, data, "dense_f32", card, smi)),
                     ("gp_ms_coo_f32", lambda: gp_ms_route(root, data, "coo_f32", card, smi)),
                     ("gp_ms_dense_bf16", lambda: gp_ms_bf16_route(root, data, card, smi))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    busy = {n: {r: out[n]["routes"][r].get("device_ms_per_step") for r in ("captured", "eager")} for n in out
            if "routes" in out[n]}
    line = dict(design="one process drives a mesh of torch.devices; cuda:0 named twice: 2 replicas / 2 shards on the "
                       "one card, exchanges and reductions real, one CUDA graph per step",
                busy_ms_per_step=busy, routes=out, f32_product_launches=f32_product_counts(), nvidia_smi=smi)
    log("parallel " + json.dumps(line))
    out["f32_product_launches"] = line["f32_product_launches"]
    return out


# --------------------------------------------------------------------------
# 12. the capacity knobs: remat, band_nodes, the packed gather, a capacity point
# --------------------------------------------------------------------------

# launches per training step of config A (5 layers) by remat mode, the design
# of models/epd_flat.py (tests/test_torch_port_capacity.py counts the edge
# block's): (edge_block_fwd, edge_block_bwd, take kernel). "xj" recomputes
# the edge block, "full" the gather too; "group" recomputes each of its two
# groups once, then each of its nested "full" layers again
REMAT_LAUNCHES = {False: (5, 5, 10), "xj": (10, 5, 10), "xj_msg": (5, 5, 10), "full": (10, 5, 15),
                  "group": (15, 5, 20)}
KNOB_STEPS = 10  # train of B with a band and of A with the knobs set
PROFILE_REPLAYS = 2  # captured replays traced through utils/profiling
# the capacity point: a 1,280 x 480 bar lattice at spacing 0.5 (614,400
# particles), r = 0.6, K = 8, config B's values, batch 1
CAPACITY_POINT = dict(nx=1280, ny=480, spacing=0.5, slots=8)
CAPACITY_REMATS = (False, "full")
# the packed route against the unfused one (packed_gather_max_nodes): timed
# replays of a captured step per visit, visits in the order packed,
# unfused, unfused, packed; at B's 77,824 nodes and at the point's window
# in batches of 1 and 2 (614,400 and 1,228,800 nodes)
RACE_REPS = {"B": 20, 1: 5, 2: 3}


def noisy_radius(cfg) -> float:
    """The radius widened by 8 sigma of the training noise between two
    nodes (the random walk's last frame has std noise_std * sqrt(S - 1) per
    node and coordinate, sqrt(2) times that between two nodes): a band
    measured at it holds on noisy steps. 4 sigma of one node, the partition
    plan's margin, let B's steps break the band on 12-38 of 622,592 edges
    (an H100 80GB HBM3 at 700 W)."""
    import numpy as np

    sigma_pair = cfg.noise_std * float(np.sqrt(max(cfg.input_sequence_length - 1, 1))) * float(np.sqrt(2.0))
    return cfg.connection_radius + 8.0 * sigma_pair


def max_band(frames, radius: float) -> int:
    """The largest |sender - receiver| over the radius graphs of ``frames``
    ([N, dim] arrays; uncapped, so at least the model's capped graphs')."""
    import numpy as np

    from sgnn_tpu_torch import native
    from sgnn_tpu_torch.physics.multi_scale_graph import _radius_edges_ckdtree

    worst = 0
    for f in frames:
        res = native.radius_search_host(np.asarray(f, np.float64), radius, 64)
        s, r = res if res is not None else _radius_edges_ckdtree(np.asarray(f, np.float64), radius, 64)
        worst = max(worst, int(np.abs(s - r).max()))
    return worst


def _capacity_counts() -> dict:
    from sgnn_tpu_torch.ops import sym_gather as sg

    return {**_launch_counts(), "banded_forward": sg.BANDED["forward"], "banded_reverse": sg.BANDED["reverse"]}


def _state(sim, optimizer, metrics) -> dict:
    return dict(metrics=metrics, grads={k: p.grad.detach().clone() for k, p in sim.named_parameters()},
                params=_clone(sim.state_dict()), adam=[_clone(st) for st in optimizer.state.values()])


def _same_state(a, b) -> bool:
    import torch

    return (all(all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(a["metrics"], b["metrics"]))
            and all(torch.equal(v, b["grads"][k]) for k, v in a["grads"].items())
            and all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
            and all(all(torch.equal(x[k], y[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
                    for x, y in zip(a["adam"], b["adam"])))


def profile_replays(step_fn, batch, start: int, trace_dir: Path) -> dict:
    """PROFILE_REPLAYS calls of a captured step traced through the port's
    own ``utils/profiling``: device busy ms and kernels per step from
    ``summarize_trace``'s rows, the wall per step, the top kernels."""
    import torch

    from sgnn_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.start_trace(str(trace_dir))
    t0 = time.perf_counter()
    for i in range(PROFILE_REPLAYS):
        step_fn(batch, start + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_REPLAYS
    path = profiling.stop_trace()
    rows = profiling.summarize_trace(path, top=5, steps=PROFILE_REPLAYS)
    rollup = [r for r in rows if r["category"] == "rollup"]
    busy = sum(r["ms_per_step"] for r in rollup)
    if busy == 0:
        return {"busy_ms_per_step": "not measured (the trace holds no device time)", "wall_ms_per_step": wall_ms}
    return dict(busy_ms_per_step=busy, wall_ms_per_step=wall_ms, idle_share=1.0 - busy / wall_ms,
                kernels_per_step=sum(r["launches_per_step"] for r in rollup),
                top=[(r["name"][:60], round(r["ms_per_step"], 4)) for r in rows if r["category"] == "op"])


def _step_run(make, batch, capture: bool, trace_dir: Path):
    """Two calls of a fresh step (``make() -> (step_fn, sim, optimizer)``)
    on ``batch``: the first (captured route: the warm-up step and the
    capture) and the second (a replay), each's peak memory, the second's
    launches and the state after it; the captured route's replays traced."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    step_fn, sim, optimizer = make()
    step_fn.capture = capture
    torch.cuda.reset_peak_memory_stats()
    first = _clone(step_fn(batch, 0))
    torch.cuda.synchronize()
    first_peak = torch.cuda.max_memory_allocated() / 1e6
    torch.cuda.reset_peak_memory_stats()
    before = _capacity_counts()
    second = _clone(step_fn(batch, 1))
    torch.cuda.synchronize()
    res = dict(first_call_peak_memory_mb=first_peak, step_peak_memory_mb=torch.cuda.max_memory_allocated() / 1e6,
               launches_per_step={k: v - before[k] for k, v in _capacity_counts().items()},
               loss=float(second["train/loss"]))
    state = _state(sim, optimizer, [first, second])
    if capture:
        res.update(profile_replays(step_fn, batch, 2, trace_dir))
    step_fn.close()
    del step_fn, sim, optimizer
    torch.cuda.empty_cache()
    return res, state


def race_routes(makes: dict, batch, reps: int) -> tuple:
    """Two routes' captured steps (``make() -> (step_fn, sim, optimizer)``
    each) timed in one call: visits in the order a, b, b, a; each visit
    makes a fresh step, calls it twice (the warm-up step and the capture,
    then a replay) and times ``reps`` more replays with CUDA events around
    them. Returns (per route: ms per replayed step of each visit and their
    mean; per route: the state after its first visit's two calls)."""
    import torch

    names = list(makes)
    rounds, states = {name: [] for name in names}, {}
    for name in names + names[::-1]:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        step_fn, sim, optimizer = makes[name]()
        step_fn.capture = True
        calls = [_clone(step_fn(batch, 0)), _clone(step_fn(batch, 1))]
        states.setdefault(name, _state(sim, optimizer, calls))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            step_fn(batch, 2 + i)
        end.record()
        end.synchronize()
        rounds[name].append(start.elapsed_time(end) / reps)
        step_fn.close()
        del step_fn, sim, optimizer
    torch.cuda.empty_cache()
    times = {name: dict(ms_per_step=sum(t) / len(t), visits=t) for name, t in rounds.items()}
    return times, states


def remat_modes_A(root: Path, data: Path, card) -> dict:
    """One captured training step of A at full width per remat mode, on one
    staged batch and the same noise stream: equal to remat=False and to its
    own eager step (torch.equal: metrics, gradients, parameters, Adam), the
    launches per step of REMAT_LAUNCHES, peak memory, busy time."""
    from sgnn_tpu_torch.train import train as trainer

    built = trainer.build_training(train_config(root, data, "A"), card)
    batch = trainer.batch_to_device(next(built.epochs()), card)
    del built
    out, states = {}, {}
    for mode in REMAT_LAUNCHES:
        cfg = train_config(root, data, "A", remat=mode, run_name=f"smoke_cap_remat_{mode}")

        def make():
            b = trainer.build_training(cfg, card)
            return b.step_fn, b.sim, b.optimizer

        captured, states[mode] = _step_run(make, batch, True, root / "traces" / f"remat_{mode}")
        eager, eager_state = _step_run(make, batch, False, root / "traces")
        got = {k: captured["launches_per_step"][k] for k in ("edge_block_fwd", "edge_block_bwd", "take")}
        want = dict(zip(("edge_block_fwd", "edge_block_bwd", "take"), REMAT_LAUNCHES[mode]))
        if got != want or eager["launches_per_step"] != captured["launches_per_step"]:
            raise AssertionError(f"remat {mode}: launches per step {captured['launches_per_step']} (eager "
                                 f"{eager['launches_per_step']}), expected {want}")
        if not _same_state(states[mode], eager_state):
            raise AssertionError(f"remat {mode}: the captured step differs from the eager one")
        if not _same_state(states[mode], states[False]):
            raise AssertionError(f"remat {mode}: the step differs from remat=False (torch.equal)")
        out[str(mode)] = dict(captured=captured, eager_peak_memory_mb=eager["step_peak_memory_mb"])
        log(f"capacity remat {mode}: " + json.dumps(out[str(mode)]))
    return out


def packed_vs_unfused_B(root: Path, data: Path, card) -> dict:
    """B's default route (the packed gather, 77,824 <= 1,228,800 nodes)
    against packed_gather_max_nodes=1 (the unfused route): one step on the
    same batch and noise, loss and every gradient torch.equal."""
    import dataclasses

    import torch

    from sgnn_tpu_torch.ops import row_gather as rg
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train as trainer

    cfg = train_config(root, data, "B", run_name="smoke_cap_packed")
    batch = noise = None
    runs = {}
    for name, max_nodes in (("packed", None), ("unfused", 1)):
        built = trainer.build_training(cfg, card)
        if batch is None:
            batch = trainer.batch_to_device(next(built.epochs()), card)
            noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                               generator=torch.Generator(device=card).manual_seed(5), device=card)
        sim_cfg = built.sim_cfg
        if max_nodes is not None:
            sim_cfg = dataclasses.replace(sim_cfg, packed_gather_max_nodes=max_nodes)
        if not sim_cfg.symmetric_gather:
            raise AssertionError("packed B: the auto-rule left the symmetric gather off")
        step = trainer.make_train_step(built.sim, sim_cfg, built.stats, cfg, built.optimizer)
        take = rg.LAUNCHES["take"]
        loss = step(batch, 0, noise=noise)["train/loss"].clone()
        runs[name] = dict(loss=loss, take=rg.LAUNCHES["take"] - take,
                          grads={k: p.grad.detach().clone() for k, p in built.sim.named_parameters()})
        del built, step
    p, u = runs["packed"], runs["unfused"]
    if not (torch.equal(p["loss"], u["loss"]) and all(torch.equal(g, u["grads"][k]) for k, g in p["grads"].items())):
        raise AssertionError("packed B: the packed route's loss or gradients differ from the unfused route's")
    if (p["take"], u["take"]) != (1, 0):
        raise AssertionError(f"packed B: take kernel launches {p['take']} (packed), {u['take']} (unfused)")

    def make(max_nodes):
        def made():
            built = trainer.build_training(cfg, card)
            sim_cfg = dataclasses.replace(built.sim_cfg, packed_gather_max_nodes=max_nodes)
            step = trainer.make_train_step(built.sim, sim_cfg, built.stats, cfg, built.optimizer,
                                           torch.Generator(device=card).manual_seed(cfg.seed))
            return step, built.sim, built.optimizer
        return made

    times, states = race_routes({"packed": make(batch["node_mask"].numel()), "unfused": make(1)}, batch,
                                RACE_REPS["B"])
    if not _same_state(states["packed"], states["unfused"]):
        raise AssertionError("packed B: the captured packed step differs from the captured unfused one")
    log("capacity packed B: " + json.dumps(times))
    return dict(check="torch.equal: loss and every gradient (eager, injected noise); metrics, gradients, "
                      "parameters, Adam after two captured steps", loss=float(p["loss"]),
                take_launches={"packed": p["take"], "unfused": u["take"]},
                receivers=int(batch["node_mask"].numel()), captured_ms_per_step=times)


def _train_captured(cfg, card):
    """``train(cfg)`` on the card, its printed lines echoed and returned."""
    import contextlib
    import io

    from sgnn_tpu_torch.train import train as trainer

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = trainer.train(cfg, device=card)
    text = buf.getvalue()
    for line in text.splitlines():
        log("  | " + line)
    records = [json.loads(x) for x in (Path(cfg.model_path) / cfg.run_name / "metrics.jsonl").open()]
    return result, text, records


def band_B(root: Path, data: Path, card) -> dict:
    """B with band_nodes from the data: train for KNOB_STEPS steps with 0
    violations at every log point, its reverse gathers (622,592 rows) on the
    banded index, one step's gradients equal to no band; a band lowered
    below this batch's graph counted, warned about, and its banded gather
    equal to the JAX clamp formula evaluated on the CPU."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_metadata
    from sgnn_tpu_torch.ops import sym_gather as sg
    from sgnn_tpu_torch.ops.neighbors import radius_neighbors_grid_batched
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train as trainer

    base = train_config(root, data, "B")
    frames = [f for pos, _, _ in TrajectoryLoader(data / "train.npz").trajectories for f in pos]
    band = max_band(frames, noisy_radius(base))
    cfg = train_config(root, data, "B", run_name="smoke_cap_band_B", band_nodes=band, ntraining_steps=KNOB_STEPS,
                       nsave_steps=KNOB_STEPS, log_every=1)
    sg.BANDED.update(forward=0, reverse=0)
    result, _, records = _train_captured(cfg, card)
    banded = dict(sg.BANDED)
    viol = [r["train/band_violations"] for r in records if "train/band_violations" in r]
    if len(viol) != KNOB_STEPS or any(viol) or result["step"] != KNOB_STEPS:
        raise AssertionError(f"band B: band_violations at the log points {viol}, {result}")
    if banded["reverse"] != cfg.layers * KNOB_STEPS:  # the sender tables (77,824 rows) stay plain
        raise AssertionError(f"band B: banded gathers {banded}, expected the {cfg.layers} reverse gathers per step")

    # one step with and without the band: the same gradients
    built = trainer.build_training(cfg, card)
    batch_np = next(built.epochs())
    batch = trainer.batch_to_device(batch_np, card)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), cfg.noise_std,
                                       generator=torch.Generator(device=card).manual_seed(6), device=card)
    with_band = step_outputs(built, batch, noise)
    del built
    without = step_outputs(trainer.build_training(train_config(root, data, "B"), card), batch, noise)
    if not all(torch.equal(g, without["grads"][k]) for k, g in with_band["grads"].items()):
        raise AssertionError("band B: gradients differ from band_nodes=None")

    # a band one below this batch's own graph: counted and warned about
    pos, mask = batch_np["positions"][..., -1, :], batch_np["node_mask"]
    lowered = max_band([p[m] for p, m in zip(pos, mask)], base.connection_radius) - 1
    low_cfg = train_config(root, data, "B", run_name="smoke_cap_band_B_low", band_nodes=lowered, ntraining_steps=1,
                           nsave_steps=1000, log_every=1)
    _, text, records = _train_captured(low_cfg, card)
    low_viol = [r["train/band_violations"] for r in records if "train/band_violations" in r]
    if not low_viol or low_viol[0] <= 0 or "banded-gather contract violations" not in text:
        raise AssertionError(f"band B lowered to {lowered}: violations {low_viol}, no warning printed")

    # the banded reverse gather at the lowered band: the card's index and
    # gather against the clamp formula on the CPU
    sim_cfg = trainer.simulator_config_from(cfg, load_metadata(data))
    nl = radius_neighbors_grid_batched(batch["positions"][..., -1, :], sim_cfg.connectivity_radius,
                                       domain_min=tuple(sim_cfg.domain[0]), domain_max=tuple(sim_cfg.domain[1]),
                                       max_neighbors=sim_cfg.slots, node_mask=batch["node_mask"],
                                       cell_capacity=sim_cfg.cell_capacity)
    rev_pos, rev_ok = sg.reverse_edge_positions(nl.senders, nl.mask)
    rows = rev_pos.numel()
    idx = sg.reverse_banded_index(rev_pos, rows, lowered)
    idx_cpu = sg.reverse_banded_index(rev_pos.cpu(), rows, lowered)
    cot = torch.randn(rows, sim_cfg.latent_dim, generator=torch.Generator(device=card).manual_seed(7),
                      device=card).bfloat16()
    got = cot.index_select(0, idx)
    if idx is None or not (torch.equal(idx.cpu(), idx_cpu) and torch.equal(got.cpu(), cot.cpu()[idx_cpu])):
        raise AssertionError("band B: the card's banded reverse gather differs from the clamp formula on the CPU")
    moved = int((idx.cpu() != rev_pos.reshape(-1).long().cpu()).sum())
    margin = f"radius widened to {noisy_radius(base):.4f} (8 sigma of the noise between two nodes)"
    return dict(band_nodes=band, margin=margin,
                band_violations=viol, banded_gathers=banded, steps=KNOB_STEPS,
                reverse_gather_rows=rows, grads_equal_to_no_band=True,
                lowered=dict(band_nodes=lowered, violations=low_viol, warned=True,
                             banded_index_rows_moved_by_the_clamp=moved, gather_vs_cpu="torch.equal"))


def knobs_through_train_A(root: Path, data: Path, card) -> dict:
    """``train`` of A with debug_graph, remat "full" and a band: the audit
    line with no spot-check failure, train/band_violations in the metrics,
    then ``predict`` from its checkpoint."""
    import math

    from sgnn_tpu_torch.data.loader import TrajectoryLoader
    from sgnn_tpu_torch.train import train as trainer

    base = train_config(root, data, "A")
    frames = [f for pos, _, _ in TrajectoryLoader(data / "train.npz").trajectories for f in pos]
    band = max_band(frames, noisy_radius(base))
    cfg = train_config(root, data, "A", run_name="smoke_cap_knobs_A", debug_graph=True, remat="full",
                       band_nodes=band, ntraining_steps=KNOB_STEPS, nsave_steps=KNOB_STEPS, log_every=5)
    result, text, records = _train_captured(cfg, card)
    viol = [r["train/band_violations"] for r in records if "train/band_violations" in r]
    if "graph audit" not in text or "spot checks OK" not in text or "spot-check failures" in text:
        raise AssertionError("knobs A: no clean graph audit line")
    if len(viol) != KNOB_STEPS // 5 or any(viol) or result["step"] != KNOB_STEPS:
        raise AssertionError(f"knobs A: band_violations {viol}, {result}")
    meta = json.loads((Path(cfg.model_path) / cfg.run_name / "checkpoint_meta.json").read_text())
    cfg.mode, cfg.model_file = "rollout", meta["path"]
    summary = trainer.predict(cfg, device=card)
    if not math.isfinite(summary["total"]):
        raise AssertionError(f"knobs A: predict {summary}")
    audit = next(line for line in text.splitlines() if "avg_degree" in line).strip()
    return dict(band_nodes=band, audit=audit, band_violations=viol, predict_loss=summary["total"],
                checkpoint=meta["path"])


def gp_knobs(root: Path, data: Path, card, smi: str) -> dict:
    """The graph partition with the knobs: gp_A with remat "full" (its
    first step against one device at GP_TOL, captured against eager);
    B's symmetric route on the big bar (f32, packed over the ext rows) with
    a band from the x-sorted frames (its first step against one device at
    GP_SYM_TOL), and a band lowered below the first sample's graph, which
    the guard counts and which rejects the step."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import TrajectoryLoader
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise
    from sgnn_tpu_torch.train import train as trainer

    devices, shards = [card, card], 2
    cfg = train_config(root, data, "A", run_name="smoke_cap_gp_A", graph_parallel=shards, batch_size=1, remat="full")
    single = train_config(root, data, "A", run_name="smoke_cap_gp_A_single")
    gp_a = gp_vs_one_device("capacity gp A (remat full) vs one device", cfg, single, card, 0, GP_TOL)
    gp_a["routes"] = training_routes("capacity gp A remat full", cfg, card, trainer, devices=devices)
    torch.cuda.empty_cache()

    big = root / "data_big" if (root / "data_big" / "train.npz").exists() else make_big_bar(root)
    f32 = dict(compute_dtype="float32", symmetric_gather=True)
    base = train_config(root, big, "B", **f32)
    frames = [f[np.argsort(f[:, 0], kind="stable")]
              for pos, _, _ in TrajectoryLoader(big / "train.npz").trajectories for f in pos]
    band = max_band(frames, noisy_radius(base))
    kw = dict(run_name="smoke_cap_gp_B_band", band_nodes=band, **f32)
    gp_cfg = train_config(root, big, "B", graph_parallel=shards, batch_size=1, **kw)
    first = gp_vs_one_device("capacity gp B (band, packed, f32) vs one device", gp_cfg,
                             train_config(root, big, "B", batch_size=1, **kw), card, shards * base.layers, GP_SYM_TOL)
    built = trainer.build_training(gp_cfg, card, devices=devices)
    sample = next(built.epochs())
    lowered = max_band([sample["positions"][sample["node_mask"], -1]], base.connection_radius) - 1
    del built
    built = trainer.build_training(dataclasses.replace(gp_cfg, band_nodes=lowered), card, devices=devices)
    batch = trainer.batch_to_device(sample, card)
    noise = random_walk_position_noise(tuple(batch["positions"].shape), base.noise_std,
                                       generator=torch.Generator(device=card).manual_seed(8), device=card)
    rejected = step_outputs(built, batch, noise)
    del built
    m = rejected["metrics"]
    unchanged = all(torch.equal(v, rejected["before"][k]) for k, v in rejected["params"].items())
    if m["train/halo_violations"] <= 0 or m["train/halo_rejected"] != 1 or not unchanged:
        raise AssertionError(f"capacity gp B: band {lowered} gave {m}, parameters unchanged: {unchanged}")
    return dict(gp_A_remat_full=gp_a, gp_B_band=dict(band_nodes=band, first_step_vs_one_device=first,
                                                      lowered=dict(band_nodes=lowered, metrics=m,
                                                                   parameters_unchanged=unchanged)),
                nvidia_smi=smi)


def capacity_point(root: Path, data: Path, card) -> dict:
    """One graph of 614,400 particles (CAPACITY_POINT) with B's values and a
    band from the lattice: one captured step per CAPACITY_REMATS mode,
    gradients torch.equal between them, peak memory of the capturing and
    the replaying call, busy time through utils/profiling, the banded
    gathers per step."""
    import numpy as np
    import torch

    from sgnn_tpu_torch.data.loader import load_metadata
    from sgnn_tpu_torch.data.synthetic import simulate_taylor_impact
    from sgnn_tpu_torch.physics.simulator import SimulatorConfig, make_norm_stats, simulator_init
    from sgnn_tpu_torch.train import train as trainer

    cfg = train_config(root, data, "B", batch_size=1, run_name="smoke_cap_point")
    s = cfg.input_sequence_length
    pt = CAPACITY_POINT
    t0 = time.perf_counter()
    pos, _, stress = simulate_taylor_impact(nx=pt["nx"], ny=pt["ny"], spacing=pt["spacing"], num_steps=s + 1,
                                            rng=np.random.default_rng(0))
    gen_s = time.perf_counter() - t0
    n = pos.shape[1]
    band = max_band(list(pos), noisy_radius(cfg))
    lo, hi = pos.reshape(-1, 2).min(0).astype(np.float64), pos.reshape(-1, 2).max(0).astype(np.float64)
    pad = 0.25 * (hi - lo) + 4 * cfg.connection_radius  # the trainer's domain rule
    domain = (tuple(lo - pad), tuple(hi + pad))

    def point_batch(b):  # the window, b times
        def rep(a):
            return torch.as_tensor(np.repeat(a[None], b, axis=0), device=card)

        return {"positions": rep(np.transpose(pos[:s], (1, 0, 2))), "next_position": rep(pos[s]),
                "next_strain": rep(stress[s]), "particle_type": torch.zeros((b, n), dtype=torch.int64, device=card),
                "node_mask": torch.ones((b, n), dtype=torch.bool, device=card)}

    stats = make_norm_stats(load_metadata(data), cfg.noise_std, device=card)

    def maker(mode, max_nodes):
        sim_cfg = SimulatorConfig(
            latent_dim=cfg.hidden_dim, num_message_passing_steps=cfg.layers, connectivity_radius=cfg.connection_radius,
            input_sequence_length=s, neighbor_slots=pt["slots"], symmetric_gather=True, compute_dtype="bfloat16",
            domain=domain, band_nodes=band, remat=mode, packed_gather_max_nodes=max_nodes)

        def make():
            sim = simulator_init(sim_cfg, generator=torch.Generator().manual_seed(cfg.seed), device=card)
            optimizer = trainer.make_optimizer(sim, cfg)
            step = trainer.make_train_step(sim, sim_cfg, stats, cfg, optimizer,
                                           torch.Generator(device=card).manual_seed(cfg.seed))
            return step, sim, optimizer
        return make

    batch = point_batch(1)
    out, states = {}, {}
    for mode in CAPACITY_REMATS:
        res, states[mode] = _step_run(maker(mode, n), batch, True, root / "traces" / f"point_{mode}")
        if states[mode]["metrics"][1]["train/band_violations"] != 0:
            raise AssertionError(f"capacity point: band {band} broken: {states[mode]['metrics'][1]}")
        launches = res["launches_per_step"]
        if launches["banded_reverse"] != cfg.layers or launches["banded_forward"] < cfg.layers:
            raise AssertionError(f"capacity point remat {mode}: banded gathers {launches}")
        out[str(mode)] = res
        log(f"capacity point remat {mode}: " + json.dumps(res))
    if not _same_state(states["full"], states[False]):
        raise AssertionError("capacity point: remat full's step differs from remat=False's (torch.equal)")
    races = {}
    for b in (1, 2):
        del batch
        batch = point_batch(b)
        times, raced = race_routes({"packed": maker(False, b * n), "unfused": maker(False, 1)}, batch, RACE_REPS[b])
        if not _same_state(raced["packed"], raced["unfused"]):
            raise AssertionError(f"capacity point, batch {b}: the packed step differs from the unfused one")
        if raced["packed"]["metrics"][1]["train/band_violations"] != 0:
            raise AssertionError(f"capacity point, batch {b}: band {band} broken")
        races[f"{b * n}_nodes"] = times
        log(f"capacity point packed vs unfused, batch {b}: " + json.dumps(times))
    return dict(particles=n, lattice=f"{pt['nx']} x {pt['ny']} at spacing {pt['spacing']}", slots=pt["slots"],
                window="simulate_taylor_impact (the port's synthetic generator) at this size, frames 0-"
                       f"{s} (generated in {gen_s:.1f} s)",
                band_nodes=band, table_rows={"forward_packed": n, "reverse": n * pt["slots"]},
                check="torch.equal: remat full vs False, metrics, gradients, parameters, Adam; packed vs unfused "
                      "(remat False, batches 1 and 2)", modes=out, packed_vs_unfused_ms_per_step=races)


def native_search_check(data: Path) -> dict:
    """The native radius search, built by this run with the host g++: the
    multi-scale graph builder takes it; its edges equal cKDTree's on the
    first frame of the dataset (the grid radius, the builder's cap)."""
    import numpy as np

    from sgnn_tpu_torch import native
    from sgnn_tpu_torch.data.loader import TrajectoryLoader
    from sgnn_tpu_torch.physics import multi_scale_graph as msg

    if not native.available():
        raise AssertionError("native radius search: the library did not build")
    frame = np.asarray(TrajectoryLoader(data / "train.npz").trajectories[0][0][0], np.float64)
    gc = msg.MultiScaleConfig(num_scales=MS_MODEL["num_scales"], window_size=MS_MODEL["window_size"],
                              radius_multiplier=MS_MODEL["radius_multiplier"])
    t0 = time.perf_counter()
    nat = msg._radius_edges(frame, gc.grid_radius, gc.max_neighbors)
    native_s = time.perf_counter() - t0
    if native.LAST_SEARCH != "native":
        raise AssertionError(f"native radius search: the builder took {native.LAST_SEARCH}")
    t0 = time.perf_counter()
    ref = msg._radius_edges_ckdtree(frame, gc.grid_radius, gc.max_neighbors)
    ckdtree_s = time.perf_counter() - t0
    if not (np.array_equal(nat.senders, ref.senders) and np.array_equal(nat.receivers, ref.receivers)):
        raise AssertionError("native radius search: its edges differ from cKDTree's")
    return dict(library=native.library_path().name, edges=int(len(nat.senders)), points=int(len(frame)),
                radius=gc.grid_radius, native_s=native_s, ckdtree_s=ckdtree_s, equal_to_ckdtree=True)


def phase_capacity(root: Path, data: Path, card, smi: str) -> dict:
    """Phase 12: the capacity knobs (one ``capacity {...}`` JSON line)."""
    import torch

    t0 = time.perf_counter()
    reset_f32_product_launches()
    out = dict(native_search=native_search_check(data))
    out["remat_A"] = remat_modes_A(root, data, card)
    out["packed_B"] = packed_vs_unfused_B(root, data, card)
    torch.cuda.empty_cache()
    out["band_B"] = band_B(root, data, card)
    torch.cuda.empty_cache()
    out["knobs_A"] = knobs_through_train_A(root, data, card)
    torch.cuda.empty_cache()
    out["graph_partition"] = gp_knobs(root, data, card, smi)
    torch.cuda.empty_cache()
    out["capacity_point"] = capacity_point(root, data, card)
    torch.cuda.empty_cache()
    out.update(seconds=time.perf_counter() - t0, f32_product_launches=f32_product_counts(), nvidia_smi=smi)
    log("capacity " + json.dumps(out))
    return out


def add_capacity_launches(kernels, cap) -> None:
    """Phase 12's launches per step under each kernel's ``launches_by_path``:
    config A's remat modes (f32) and the capacity point's (bf16)."""
    keys = {"edge_block_fwd": "edge_block_fwd", "edge_block_bwd": "edge_block_bwd", "row_gather_take": "take",
            "edge_epilogue_fwd": "epilogue_fwd", "edge_epilogue_bwd": "epilogue_bwd",
            **{key: key for key in F32_PRODUCT_KEYS}}
    a = {f"capacity_A_remat_{m}_per_step": r["captured"]["launches_per_step"] for m, r in cap["remat_A"].items()}
    point = {f"capacity_point_remat_{m}_per_step": r["launches_per_step"]
             for m, r in cap["capacity_point"]["modes"].items()}
    for entry in kernels:
        key = keys.get(entry["name"])
        if key is None:
            continue
        for paths, dtype in ((a, "float32"), (point, "bfloat16")):
            if key == "take" or entry.get("dtype") == dtype:
                entry["launches_by_path"].update({path: counts[key] for path, counts in paths.items()})
        if key in F32_PRODUCT_KEYS:
            entry["launches_by_path"]["capacity_phase"] = cap["f32_product_launches"][key]


# the edge stage's epilogue (csrc/edge_epilogue.cu) at the training cells'
# shapes: (receivers, slots, width, share of live slots). The live shares:
# MeshGraphNets' quad mesh (interior nodes 4 of 4) and its world stage
# (world_slot_fill.train, 34 %); the multi-scale stages a half (their
# degrees are the hierarchy's, not measured here)
EPILOGUE_SHAPES = {
    "mgn_mesh": (38912, 4, 128, 0.95),
    "mgn_world": (38912, 8, 128, 0.34),
    "ms_m2m": (19456, 24, 128, 0.5),
    "ms_g2m": (19456, 16, 128, 0.5),
    "ms_m2g": (77824, 8, 128, 0.5),
}


def epilogue_inputs(r, k, d, fill, seed, device):
    """o, b2, lns, lnb, mask [R*K, 1], e, g_new, g_agg; degrees drawn so
    that about ``fill`` of the slots are live (prefix-compacted)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    degrees = torch.distributions.Binomial(k, torch.full((r, 1), fill)).sample()
    mask = (torch.arange(k)[None, :] < degrees).float().reshape(r * k, 1)
    out = [torch.randn(r * k, d, generator=g) * 2.0 + 0.5, torch.randn(d, generator=g) * 0.1,
           1.0 + torch.randn(d, generator=g) * 0.1, torch.randn(d, generator=g) * 0.1, mask,
           torch.randn(r * k, d, generator=g) * mask, torch.randn(r * k, d, generator=g),
           torch.randn(r, d, generator=g)]
    return [t.to(device) for t in out]


# the parameter gradients' limit against the composite: their error grows with
# the sum of the terms' sizes (rows added in another order); the edge block's
# measured 1.3e-7 of it at 39k terms, 2e-5 leaves room for 12 times the rows
EPILOGUE_SUM_RTOL = 2e-5


def epilogue_sum_terms(o, b2, mask, g_new, g_agg, g_o, k):
    """Per column, the sum of the sizes of the terms of g_b2 (the composite's
    g_o), g_lns (g_ln * xhat) and g_lnb (g_ln)."""
    import torch.nn.functional as F

    xhat = F.layer_norm(o + b2, (o.shape[-1],))
    g_ln = (g_new * mask + g_agg.repeat_interleave(k, dim=0)) * mask
    return g_o.abs().sum(0), (g_ln * xhat).abs().sum(0), g_ln.abs().sum(0)


def epilogue_bound(r, k, d, live):
    """Least ms of each direction: the bytes over HBM rate (no products).
    Forward: o and e at the live slots, the mask, new_e and agg written
    once; backward: o and g_new at the live slots, g_agg, the mask, g_o
    and g_e written once, the three parameter gradients."""
    fwd = 4 * d * (2 * live + r * k + r) + 4 * r * k + 4 * 3 * d
    bwd = 4 * d * (2 * live + r + 2 * r * k) + 4 * r * k + 4 * 2 * 3 * d
    return {"fwd_bytes": fwd, "bwd_bytes": bwd, "fwd_bound_ms": fwd / HBM_BYTES_PER_S * 1e3,
            "bwd_bound_ms": bwd / HBM_BYTES_PER_S * 1e3}


def phase_edge_epilogue(dev) -> dict:
    """The epilogue kernels against the composite at the cells' shapes
    (max errors; forward and backward twice, bit for bit), then timed with
    CUDA events, two input sets in turn (each past the 50 MB L2): the
    kernels alone against their bytes bound, the composite's forward and
    its forward + backward under autograd, the kernels' forward +
    backward through ``EdgeEpilogue``, and, as a yardstick only,
    ``torch.nn.functional.layer_norm`` (which the port never calls)."""
    import torch
    import torch.nn.functional as F

    from sgnn_tpu_torch.ops import edge_epilogue as ee

    out = {}
    for name, (r, k, d, fill) in EPILOGUE_SHAPES.items():
        sets = [epilogue_inputs(r, k, d, fill, seed, dev) for seed in (1, 2)]
        o, b2, lns, lnb, mask, e, g_new, g_agg = sets[0]
        live = int(mask.sum())

        def fwd_bwd(fn, o, b2, lns, lnb, mask, e, g_new, g_agg):
            leaves = [t.detach().requires_grad_(i != 4) for i, t in enumerate((o, b2, lns, lnb, mask, e))]
            new_e, agg = fn(*leaves, k)
            torch.autograd.backward((new_e, agg), (g_new, g_agg))
            o_, b2_, lns_, lnb_, _, e_ = leaves
            return new_e, agg, o_.grad, b2_.grad, lns_.grad, lnb_.grad, e_.grad

        got = fwd_bwd(ee.edge_stage_epilogue, *sets[0])
        again = fwd_bwd(ee.edge_stage_epilogue, *sets[0])
        want = fwd_bwd(ee.epilogue_plain, *sets[0])
        torch.cuda.synchronize()
        names = ("new_e", "agg", "g_o", "g_b2", "g_lns", "g_lnb", "g_e")
        got, again, want = ([t.detach() for t in run] for run in (got, again, want))
        errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, got, want)}
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        if not repeat:
            raise AssertionError(f"edge_epilogue {name}: two runs differ")
        if errs["new_e"] > 1e-4 or errs["agg"] > 1e-3 or errs["g_o"] > 1e-4:
            raise AssertionError(f"edge_epilogue {name}: kernel against the composite {errs}")
        if not torch.equal(got[6], g_new * mask):
            raise AssertionError(f"edge_epilogue {name}: g_e is not g_new * mask")
        # the parameter gradients: sums over every row in another order than
        # PyTorch's, held to EPILOGUE_SUM_RTOL of the sum of their terms' sizes
        worst = {}
        for n, a, b, terms in zip(names[3:6], got[3:6], want[3:6], epilogue_sum_terms(o, b2, mask, g_new, g_agg,
                                                                                      want[2], k)):
            ratio = (a - b).abs() / (EPILOGUE_SUM_RTOL * terms + 1e-6)
            worst[n] = float(ratio.max())
            if worst[n] > 1:
                raise AssertionError(f"edge_epilogue {name}: {n} beyond its limit ({worst[n]:.3f} of it)")
        del got, again, want
        bound = epilogue_bound(r, k, d, live)
        args = [[t.detach() for t in s] for s in sets]
        fwd = time_pair(lambda o, b2, lns, lnb, mask, e, *_: ee._launch_fwd(o, b2, lns, lnb, mask, e, k),
                        lambda o, b2, lns, lnb, mask, e, *_: ee.epilogue_plain(o, b2, lns, lnb, mask, e, k),
                        args, iters=50, warmup=5)
        bwd_ms = time_ms(lambda o, b2, lns, lnb, mask, e, g_new, g_agg: ee._launch_bwd(o, b2, lns, mask, g_new,
                                                                                        g_agg, k),
                         args, iters=50, warmup=5)
        both = time_pair(lambda *a: fwd_bwd(ee.edge_stage_epilogue, *a), lambda *a: fwd_bwd(ee.epilogue_plain, *a),
                         args,
                         iters=20, warmup=3)
        lib_fwd = time_ms(lambda o, b2, lns, lnb, *_: F.layer_norm(o + b2, (d,), lns, lnb), args, iters=50,
                          warmup=5)

        def lib_both(o, b2, lns, lnb, mask, e, g_new, g_agg):
            leaves = [t.detach().requires_grad_(True) for t in (o, b2, lns, lnb)]
            F.layer_norm(leaves[0] + leaves[1], (d,), leaves[2], leaves[3]).backward(g_new)

        lib_both_ms = time_ms(lib_both, args, iters=20, warmup=3)
        out[name] = dict(
            shape=[r, k, d], live_rows=live, fill=live / (r * k), max_abs_err=errs, repeat_bits=repeat,
            param_grad_err_over_limit=worst, **bound,
            fwd_ms=fwd["ms"], fwd_plain_ms=fwd["plain_ms"], fwd_runs=fwd["kernel_ms_runs"],
            fwd_plain_runs=fwd["plain_ms_runs"], bwd_ms=bwd_ms, fwd_bwd_ms=both["ms"],
            fwd_bwd_plain_ms=both["plain_ms"],
            fwd_bound_share=bound["fwd_bound_ms"] / fwd["ms"], bwd_bound_share=bound["bwd_bound_ms"] / bwd_ms,
            library_layer_norm_fwd_ms=lib_fwd, library_layer_norm_fwd_bwd_ms=lib_both_ms,
        )
        log(f"edge_epilogue {name} " + json.dumps(out[name]))
        del sets, args, o, e, g_new, g_agg, mask
        torch.cuda.empty_cache()
    return out


# MeshGraphNets at its published widths (15 blocks, latent 128, two hidden
# layers an MLP), on the smoke's dataset with config A's domain; the slot
# widths the trainer derives from the training split
MGN_MODEL = dict(architecture="meshgraphnet", layers=15, hidden_dim=128, input_sequence_length=2, mesh_radius=0.6,
                 world_radius=0.75, batch_size=8, lr_init=1e-4, lr_decay_steps=5000000)
EPILOGUE_STEPS = 5
# a small GraphCast through the trainer: 10 degree grid, mesh level 2, latent 32, 2 processor layers
GRAPHCAST_DATA = dict(resolution_deg=10.0, frames=8, surface_variables=["2m_temperature", "mean_sea_level_pressure"],
                      atmospheric_variables=["temperature", "geopotential"], levels=[300, 500, 850],
                      forcing_variables=["toa_incident_solar_radiation", "year_progress_sin"],
                      static_variables=["land_sea_mask"])
GRAPHCAST_MODEL = dict(architecture="graphcast", layers=2, hidden_dim=32, input_sequence_length=2, mesh_refinement=2,
                       edge_pad_multiple=64, batch_size=1, noise_std=0.0, lr_init=1e-3)


def make_graphcast_dataset(root: Path) -> Path:
    """GRAPHCAST_DATA's fields in the port's split format (``data/fields.py``:
    one trajectory a split, ``metadata.json`` beside them): seeded normal
    noise with unit statistics, enough to count a step's launches."""
    import numpy as np

    spec, rng = GRAPHCAST_DATA, np.random.default_rng(7)
    res = spec["resolution_deg"]
    n_lat, n_lon = int(round(180.0 / res)) + 1, int(round(360.0 / res))
    sizes = {"state": len(spec["surface_variables"]) + len(spec["atmospheric_variables"]) * len(spec["levels"]),
             "forcing": len(spec["forcing_variables"]), "static": len(spec["static_variables"])}
    out = root / "graphcast_data"
    out.mkdir(parents=True, exist_ok=True)
    for split in ("train", "valid", "test"):
        traj = {"state": rng.standard_normal((spec["frames"], n_lat * n_lon, sizes["state"]), dtype=np.float32),
                "forcings": rng.standard_normal((spec["frames"], n_lat * n_lon, sizes["forcing"]), dtype=np.float32),
                "static": rng.standard_normal((n_lat * n_lon, sizes["static"]), dtype=np.float32)}
        np.savez(out / f"{split}.npz", trajectories={"case-000": traj})
    metadata = dict({k: v for k, v in spec.items() if k != "frames"}, family="graphcast", lat=n_lat, lon=n_lon,
                    step_hours=6, **{f"{kind}_{stat}": [float(stat == "std")] * n
                                     for kind, n in (("state", sizes["state"]), ("diff", sizes["state"]),
                                                     ("forcing", sizes["forcing"]), ("static", sizes["static"]))
                                     for stat in ("mean", "std")})
    (out / "metadata.json").write_text(json.dumps(metadata))
    return out


def graphcast_products(layers: int) -> dict:
    """f32 products of one GraphCast training step by kind: the five
    encoders, the grid update and the decoder two each (one hidden layer);
    each of the layers + 2 interaction steps seven (the edge MLP's first
    layer split three ways and its output; the node MLP's aggregate and node
    blocks and its output); every weight takes a gradient, every input but
    the five encoders' features."""
    fwd = 7 * 2 + 7 * (layers + 2)
    return dict(zip(F32_PRODUCT_KEYS, (fwd, fwd - 5, fwd)))


def epilogue_launches(root: Path, data: Path, dev) -> dict:
    """The epilogue kernels' launches per step of the trainer's captured
    ``TrainStep`` (the first step eager, then a capture and replays:
    EPILOGUE_STEPS steps): MeshGraphNets at its published widths (2 edge
    sets x 15 blocks), the dense f32 multi-scale model (one per dense edge
    set: g2m, each m2m set of each block, m2g) and config A (one hidden
    layer: the fused edge block, none). Also the f32 product kernels' per
    step of each and of a small GraphCast (no epilogue; its products counted
    exactly: ``graphcast_products``), returned second."""
    import torch

    from sgnn_tpu_torch.data.prefetch import to_device
    from sgnn_tpu_torch.train import train as trainer
    from sgnn_tpu_torch.train import train_multi_scale as tms
    from sgnn_tpu_torch.train.config import TrainConfig

    runs = {"mgn_f32": (trainer, train_config(root, data, "A", run_name="smoke_epilogue_mgn", **MGN_MODEL)),
            "ms_dense_f32": (tms, ms_train_config(root, data, "dense_f32", run_name="smoke_epilogue_ms")),
            "A": (trainer, train_config(root, data, "A", run_name="smoke_epilogue_A"))}
    runs["graphcast_f32"] = (trainer, TrainConfig(mode="train", data_path=str(make_graphcast_dataset(root)),
                                                  model_path=str(root / "models"),
                                                  run_name="smoke_epilogue_graphcast", **GRAPHCAST_MODEL))
    out, products = {}, {}
    for name, (mod, cfg) in runs.items():
        built = mod.build_training(cfg, dev)
        built.step_fn.capture = True
        if name == "ms_dense_f32":
            want = ms_blocks(built.batcher.graphs[0])
        else:
            want = 2 * MGN_MODEL["layers"] if name == "mgn_f32" else 0
        want_products = graphcast_products(GRAPHCAST_MODEL["layers"]) if name == "graphcast_f32" else None
        source = built.epochs()
        batches = [to_device(next(source), dev) for _ in range(EPILOGUE_STEPS)]
        torch.cuda.synchronize()
        before, before_products = epilogue_counts(), f32_product_counts()
        for i, batch in enumerate(batches):
            built.step_fn(batch, i)
        torch.cuda.synchronize()
        got = {k: (v - before[k]) / EPILOGUE_STEPS for k, v in epilogue_counts().items()}
        # the f32 product kernels: one forward and one weight gradient per product a step
        products[name] = {k: (v - before_products[k]) / EPILOGUE_STEPS for k, v in f32_product_counts().items()}
        fwd, dgrad, wgrad = (products[name][k] for k in F32_PRODUCT_KEYS)
        if not (fwd == wgrad == int(fwd) >= 1 and int(dgrad) == dgrad and 1 <= dgrad <= fwd):
            raise AssertionError(f"f32_product launches {name}: {products[name]} a step")
        if want_products is not None and products[name] != want_products:
            raise AssertionError(f"f32_product launches {name}: {products[name]} a step, expected {want_products}")
        replays = built.step_fn.replays
        built.step_fn.close()
        del built, batches, source
        torch.cuda.empty_cache()
        if got != dict.fromkeys(EPILOGUE_KEYS, want) or replays != EPILOGUE_STEPS - 1:
            raise AssertionError(f"edge_epilogue launches {name}: {got} a step ({replays} replays), expected {want}")
        out[name] = got
    log("edge_epilogue launches per step " + json.dumps(out))
    log("f32_product launches per step " + json.dumps(products))
    return out, products


def phase_epilogue(root: Path, data: Path, card) -> dict:
    """Phase 13 (one ``edge_epilogue {...}`` JSON line)."""
    import torch

    launches, products = epilogue_launches(root, data, card)
    out = dict(launches_per_step=launches, f32_products_per_step=products)
    torch.cuda.empty_cache()
    out["timed"] = phase_edge_epilogue(card)
    log("edge_epilogue " + json.dumps(out))
    return out


def epilogue_summary(epi: dict, trained_a: dict, ms_runs: dict, ms_train: dict, ms_step_checks: dict) -> list:
    """The epilogue kernels' entries of the kernel summary: checked and
    timed at the MeshGraphNets world stage's shape (every shape under
    ``by_shape``), launches by path (the rest in phases 11 and 12)."""
    timed, launches = epi["timed"], epi["launches_per_step"]
    out = []
    for kname, direction, key in (("edge_epilogue_fwd", "fwd", "epilogue_fwd"),
                                  ("edge_epilogue_bwd", "bwd", "epilogue_bwd")):
        per_path = {f"train_{n}_per_step": launches[n][key] for n in launches}
        per_path["train_A_per_step"] = trained_a["routes"]["captured"]["launches_per_step"][key]
        per_path.update({f"ms_rollout_{n}": r["epilogue_launches"][key] for n, r in ms_runs.items()})
        per_path.update({f"ms_train_{n}": r["epilogue_launches"][key] for n, r in ms_train.items()})
        per_path.update({f"ms_card_vs_cpu_step_{n}": r["epilogue_launches"][key] for n, r in ms_step_checks.items()})
        res = timed["mgn_world"]
        ms = res["fwd_ms"] if direction == "fwd" else res["bwd_ms"]
        bound = res[f"{direction}_bound_ms"]
        out.append(dict(
            name=kname, route="cuda", source="sgnn_tpu_torch/csrc/edge_epilogue.cu",
            replaces="sgnn_tpu/models/epd_flat.py _edge_block_xla, sgnn_tpu/models/multi_scale.py "
                     "_interact_dense_scales (their epilogue, XLA; no Pallas original)",
            launches=launches["mgn_f32"][key], launches_by_path=per_path, dtype="float32", shape=res["shape"],
            max_abs_err=res["max_abs_err"], param_grad_err_over_limit=res["param_grad_err_over_limit"],
            tol={"new_e": 1e-4, "agg": 1e-3, "g_o": 1e-4, "g_e": 0.0, "param_grad_sum_rtol": EPILOGUE_SUM_RTOL},
            ms=ms, plain_ms=res["fwd_plain_ms"] if direction == "fwd" else None,
            fwd_bwd_ms=res["fwd_bwd_ms"], fwd_bwd_plain_ms=res["fwd_bwd_plain_ms"], bound_ms=bound, bound_by="bytes",
            bound_share=bound / ms, library_ms=res["library_layer_norm_fwd_ms"] if direction == "fwd" else
            res["library_layer_norm_fwd_bwd_ms"], bytes=res[f"{direction}_bytes"], flops=None,
            by_shape={n: {f: t[f] for f in ("shape", "fill", f"{direction}_ms", f"{direction}_bound_ms",
                                             f"{direction}_bound_share")} for n, t in timed.items()},
        ))
    return out


# the f32 product kernels' shapes (rows, K, N): the training cells' edge-row and node products at
# MeshGraphNets' and the dense multi-scale model's widths, single-scale's width 64, the edge
# encoders' 3- and 6-wide inputs and the decoder's 3-wide output
F32_PRODUCT_SHAPES = {
    "mgn_world_edges": (311296, 128, 128),
    "mgn_mesh_edges": (155648, 128, 128),
    "mgn_nodes": (38912, 128, 128),
    "ms_m2m_edges": (466944, 128, 128),
    "ms_m2g_edges": (622592, 128, 128),
    "ms_grid_nodes": (77824, 128, 128),
    "ss_nodes": (155648, 64, 64),
    "edge_encoder_3": (311296, 3, 128),
    "edge_encoder_6": (155648, 6, 128),
    "decoder_3": (38912, 128, 3),
    # GraphCast_small (graphcast_small_f32_train), 512-deep products on the mma.sync rows kernel and
    # 264-split weight gradients: the edge latents' row block of the first edge Linear at the padded
    # m2g and g2m rows, the grid encoder's 186 inputs and the decoder's 83 outputs at the grid's nodes
    "gc_m2g_edge_block": (195584, 512, 512),
    "gc_g2m_edge_block": (102400, 512, 512),
    "gc_grid_encoder": (65160, 186, 512),
    "gc_decoder": (65160, 512, 83),
}
F32_PRODUCT_LAUNCHES = 20  # a captured graph of this many launches, two input sets in turns, per timing


def graph_ms(fn, sets, launches=F32_PRODUCT_LAUNCHES):
    """Device ms per call: ``launches`` calls cycling through ``sets`` captured in
    one CUDA graph (no host time between launches), its replays timed with
    CUDA events after a warm replay."""
    import torch

    for i in range(2):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * launches)


TF32_PEAK_FLOPS = 495e12  # the tensor cores' TF32 rate: the yardstick's f32 peak (counts 2 M K N, not 3x)


def f32_product_bounds(m, k, n, gated=True):
    """Least ms of each entry kind: the larger of its bytes over HBM rate (each
    input read once, each output written once) and 2 M K N over the TF32 peak.
    ``gated``: the backward kinds read the ReLU's output as their gate."""
    ops = 2 * m * k * n
    gate = m * n if gated else 0
    moved = {"fwd": m * k + m * n + k * n + n,  # x, y, w, b
             "dgrad": m * n + gate + k * n + m * k,  # g, the gate y, w, dx
             "wgrad": m * k + m * n + gate + k * n + n}  # x, g, the gate y, dw, db
    out = {}
    for kind, words in moved.items():
        t_bytes, t_ops = 4 * words / HBM_BYTES_PER_S * 1e3, ops / TF32_PEAK_FLOPS * 1e3
        out[kind] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def _f32_product_operands(m, k, n, seed, dev):
    """x [m, k] in the first k columns of an [m, k + 4] buffer (rows k + 4
    words apart), a [n, 3k] torch weight whose transpose's middle [k, n] row
    block is what the split first layers pass, b [n] and a cotangent [m, n]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.zeros(m, k + 4)
    x[:, :k] = torch.randn(m, k, generator=g)
    full = torch.randn(n, 3 * k, generator=g) / k ** 0.5
    return [t.to(dev) for t in (x, full, torch.randn(n, generator=g) * 0.1, torch.randn(m, n, generator=g))]


def _through_linear(operands, k, row_block, relu=True):
    """``linear(x, w, b, relu)`` under autograd as the models call it: x a
    [2, m / 2, k] view of strided rows (the wrapper's reshape), w a transposed
    torch weight or its row block; returns y, dx, dw (in w's view), db and the
    launches it made by kind."""
    from sgnn_tpu_torch.ops import f32_product as fp

    buf, full, b, cot = (t.detach().clone().requires_grad_(True) for t in operands)
    m = buf.shape[0]
    view = (lambda t: t.t()[k:2 * k]) if row_block else (lambda t: t[:, :k].t())
    before = dict(fp.LAUNCHES)
    y = fp.linear(buf[:, :k].view(2, m // 2, k), view(full), b, relu=relu)
    y.backward(cot.detach().view(2, m // 2, -1))
    launches = {kind: fp.LAUNCHES[kind] - before[kind] for kind in before}
    return (y.detach().reshape(m, -1), buf.grad[:, :k], view(full.grad), b.grad), launches


def phase_f32_product(dev) -> dict:
    """Phase 14, the f32 product kernels at the cells' shapes. Checked through
    ``linear`` under autograd (``_through_linear``: one launch of each kind)
    against f64 (the error over the sum of the terms' sizes; the gradients
    gated by the kernel's own ReLU) and two runs bit for bit. Then timed inside
    captured CUDA graphs (``graph_ms``: device time, as in the captured
    training step), two input sets in turns (past the 50 MB L2): the forward
    (bias and ReLU) through ``linear``, the gated input gradient and the
    weight gradient with the bias gradient through the launchers the backward
    calls, each against its bound and against ``torch.matmul`` of the same
    operands in f32 with TF32 off (a yardstick: the port never calls it for an
    f32 product on the card); kernel, library, library, kernel. GraphCast's
    shapes (``gc_``) take no ReLU, as its SiLU MLPs call the product."""
    import torch

    from sgnn_tpu_torch.ops import f32_product as fp

    out = {}
    for name, (m, k, n) in F32_PRODUCT_SHAPES.items():
        row_block = name.endswith(("nodes", "_block"))  # the split first layers
        relu = not name.startswith("gc_")
        operands = _f32_product_operands(m, k, n, 7, dev)
        runs = [_through_linear(operands, k, row_block, relu) for _ in range(2)]
        torch.cuda.synchronize()
        if any(launches != dict.fromkeys(fp.LAUNCHES, 1) for _, launches in runs):
            raise AssertionError(f"f32_product {name}: linear's forward and backward launched {runs[0][1]}")
        if not all(torch.equal(p, q) for p, q in zip(runs[0][0], runs[1][0])):
            raise AssertionError(f"f32_product {name}: two runs differ")
        y = runs[0][0][0]
        x64 = operands[0][:, :k].double()
        w64 = (operands[1].t()[k:2 * k] if row_block else operands[1][:, :k].t()).double()
        b64, gg = operands[2].double(), torch.where(y > 0, operands[3].double(), 0.0) if relu else operands[3].double()
        want = ((x64 @ w64 + b64).clamp_min(0.0 if relu else -math.inf), gg @ w64.t(), x64.t() @ gg, gg.sum(0))
        terms = (x64.abs() @ w64.abs() + b64.abs(), gg.abs() @ w64.abs().t(), x64.abs().t() @ gg.abs(),
                 gg.abs().sum(0))
        err = {kind: float(((got.double() - ref).abs() / (t + 1e-30)).max())
               for kind, got, ref, t in zip(("fwd", "dgrad", "wgrad", "db"), runs[0][0], want, terms)}
        if err["fwd"] > 1e-5 or err["dgrad"] > 1e-5 or err["wgrad"] > 2e-5 or err["db"] > 2e-5:
            raise AssertionError(f"f32_product {name}: error over the terms' sizes {err}")
        del runs, want, terms, x64, w64, gg, operands, y
        sets = []
        for seed in (1, 2):
            g = torch.Generator().manual_seed(seed)
            x, w = torch.randn(m, k, generator=g), (torch.randn(n, k, generator=g) / k ** 0.5).t()
            b, cot = torch.randn(n, generator=g) * 0.1, torch.randn(m, n, generator=g)
            w_dev = torch.empty((n, k), device=dev).t()
            sets.append([x.to(dev), w_dev.copy_(w), b.to(dev), cot.to(dev)])
        for s in sets:
            s.append(fp.linear(s[0], s[1], s[2], True) if relu else None)  # the gate of the backward kinds
        kernel = {"fwd": lambda x, w, b, g, y: fp.linear(x, w, b, relu),
                  "dgrad": lambda x, w, b, g, y: fp._launch_dgrad(g, y, w),
                  "wgrad": lambda x, w, b, g, y: fp._launch_wgrad(x, g, y, w, True)}
        library = {"fwd": lambda x, w, b, g, y: torch.matmul(x, w),
                   "dgrad": lambda x, w, b, g, y: torch.matmul(g, w.t()),
                   "wgrad": lambda x, w, b, g, y: torch.matmul(x.t(), g)}
        bounds = f32_product_bounds(m, k, n, relu)
        res = dict(shape=[m, k, n], weight="row block" if row_block else "transposed", relu=relu, err_over_terms=err)
        for kind in kernel:
            times = [graph_ms(fn, sets) for fn in (kernel[kind], library[kind], library[kind], kernel[kind])]
            ms = (times[0] + times[3]) / 2
            res[kind] = dict(ms=ms, runs=[times[0], times[3]], library_ms=(times[1] + times[2]) / 2,
                             library_runs=times[1:3], bound_ms=bounds[kind][0], bound_by=bounds[kind][1],
                             bound_share=bounds[kind][0] / ms)
        out[name] = res
        log(f"f32_product {name} " + json.dumps(res))
        del sets
        torch.cuda.empty_cache()
    return out


def f32_product_summary(prod: dict, trained: dict, rollouts: dict, ms_runs: dict, ms_train: dict,
                        epi: dict) -> list:
    """The product kernels' entries of the kernel summary, one per kind:
    checked and timed at MeshGraphNets' world-edge shape (every shape under
    ``by_shape``); launches per MeshGraphNets step at its published widths,
    and by path (the rest in phases 11 and 12)."""
    head = prod["mgn_world_edges"]
    out = []
    for kind in ("fwd", "dgrad", "wgrad"):
        key = f"f32_product_{kind}"
        per_path = {f"train_{n}_per_step": c[key] for n, c in epi["f32_products_per_step"].items()}
        for n, (res, _, _) in trained.items():
            per_path[f"train_{n}"] = res["f32_product_launches"][key]
            per_path[f"train_{n}_route_per_step"] = res["routes"]["captured"]["launches_per_step"][key]
        per_path.update({f"rollout_{dt}": r["f32_product_launches"][key] for dt, r in rollouts.items()})
        per_path.update({f"ms_rollout_{n}": r["f32_product_launches"][key] for n, r in ms_runs.items()})
        per_path.update({f"ms_train_{n}": r["f32_product_launches"][key] for n, r in ms_train.items()})
        res = head[kind]
        out.append(dict(
            name=key, route="cuda", source="sgnn_tpu_torch/csrc/f32_product.cu",
            replaces="XLA's dot of every Linear (sgnn_tpu/nn/core.py, the split first layers of "
                     "sgnn_tpu/models/epd_flat.py and multi_scale.py; no Pallas original)",
            launches=epi["f32_products_per_step"]["mgn_f32"][key], launches_by_path=per_path, dtype="float32",
            shape=head["shape"], err_over_terms=head["err_over_terms"],
            tol={"fwd": 1e-5, "dgrad": 1e-5, "wgrad": 2e-5, "db": 2e-5}, ms=res["ms"], kernel_ms_runs=res["runs"],
            library_ms=res["library_ms"], library_ms_runs=res["library_runs"], plain_ms=None,
            bound_ms=res["bound_ms"], bound_by=res["bound_by"], bound_share=res["bound_share"],
            by_shape={n: dict(shape=r["shape"], **{f: r[kind][f] for f in ("ms", "library_ms", "bound_ms",
                                                                            "bound_share")})
                      for n, r in prod.items()},
        ))
    return out


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="On-card smoke run of the PyTorch/CUDA port.")
    parser.add_argument("--only", choices=["row_gather_bwd", "parallel", "capacity", "edge_epilogue", "feed",
                                           "f32_product"],
                        help="run only this phase (after 1, 2 and 4)")
    only = parser.parse_args().only
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
        card = torch.device("cuda", torch.cuda.current_device())
        if only == "row_gather_bwd":
            log("bwd " + json.dumps(phase_row_gather_bwd(data, card)))
            return 0
        if only == "parallel":
            phase_parallel(root, data, card, smi)
            return 0
        if only == "capacity":
            phase_capacity(root, data, card, smi)
            return 0
        if only == "edge_epilogue":
            phase_epilogue(root, data, card)
            return 0
        if only == "f32_product":
            log("f32_product " + json.dumps(phase_f32_product(card)))
            return 0
        train_rows = {CONFIGS[n]["compute_dtype"]: CONFIGS[n]["batch_size"] * nodes for n in CONFIGS}

        # 3. kernels against their plain versions, then timed
        kernel_results = phase_kernels(train_rows)

        # 5. training, through train
        trained = {}
        for name in CONFIGS:
            out, cfg, ckpt = run_training(root, data, name, smi, kind)
            trained[name] = (out, cfg, ckpt)
        checks = {name: train_config(root, data, name, run_name=f"smoke_checks_{name}") for name in CONFIGS}
        fixed = fixed_batch_check(checks["A"], card)
        torch.cuda.empty_cache()
        step_checks = {}
        for name, cfg in checks.items():
            step_checks[name] = card_vs_cpu_step(cfg, name, card)
            torch.cuda.empty_cache()
        sym_check = sym_gather_check(checks["B"], card)
        torch.cuda.empty_cache()
        c2 = c2_cost(checks["A"], card)
        torch.cuda.empty_cache()

        # 6. rollout, through predict, from the checkpoints training wrote
        rollouts = {}
        for name in CONFIGS:
            out, cfg, ckpt = trained[name]
            rollouts[cfg.compute_dtype] = run_rollout(root, data, cfg, ckpt, smi, kind)
        torch.cuda.empty_cache()

        # 7. row gather against its plain version, then timed
        gather = phase_row_gather(data, card)
        torch.cuda.empty_cache()

        # 8. the ported gather probe
        probe = phase_probe()
        torch.cuda.empty_cache()

        # 9. multi-scale rollout, through train_multi_scale.main
        ms_ckpt = ms_write_inputs(root, data)
        ms_runs = {}
        for name in MS_RUNS:
            ms_runs[name] = run_ms(root, data, name, ms_ckpt, smi, kind)
            torch.cuda.empty_cache()
        from sgnn_tpu_torch import native

        if native.LAST_SEARCH != "native":
            raise AssertionError(f"multi-scale graphs: built by the {native.LAST_SEARCH} search, not the native one")
        log(f"multi-scale graphs: native radius search ({native.library_path().name}, built by this run with g++)")
        log(f"phases 1-9: {time.perf_counter() - t_start:.1f} s")

        # 10. multi-scale training, through train_multi_scale.main; the
        # gathers' backward kernels against their plain versions, then timed
        ms_train = {}
        for name in MS_TRAIN_RUNS:
            ms_train[name] = run_ms_train(root, data, name, smi, kind)
            torch.cuda.empty_cache()
        ms_step_checks = {}
        for name in ("dense_f32", "dense_bf16"):
            ms_step_checks[name] = ms_card_vs_cpu_step(root, data, name, card)
            torch.cuda.empty_cache()
        bwd_gather = phase_row_gather_bwd(data, card)
        torch.cuda.empty_cache()
        log(f"phase 10: {time.perf_counter() - t_start:.1f} s in all")

        # 11. parallel runs: replicas and shards on the one card
        parallel = phase_parallel(root, data, card, smi)
        log(f"phase 11: {time.perf_counter() - t_start:.1f} s in all")

        # 12. the capacity knobs: remat, band_nodes, the packed gather, a capacity point
        capacity = phase_capacity(root, data, card, smi)
        log(f"phase 12: {time.perf_counter() - t_start:.1f} s in all")

        # 13. the edge stage's epilogue kernels: launches per step, checked, timed
        epilogue = phase_epilogue(root, data, card)
        log(f"phase 13: {time.perf_counter() - t_start:.1f} s in all")

        # 14. the f32 product kernels through linear: checked, timed
        products = phase_f32_product(card)
        log(f"phase 14: {time.perf_counter() - t_start:.1f} s in all")

    by_dtype = {trained[n][0]["compute_dtype"]: trained[n][0] for n in CONFIGS}
    kernels = []
    for kname, src, replaces in (
        ("edge_block_fwd", "sgnn_tpu_torch/csrc/edge_block_fwd.cu", "sgnn_tpu/experimental/edge_block.py:118"),
        ("edge_block_bwd", "sgnn_tpu_torch/csrc/edge_block_bwd.cu", "sgnn_tpu/experimental/edge_block.py:138"),
    ):
        for dt, res in kernel_results[kname].items():
            tr = by_dtype[dt]
            per_path = {f"train_{tr['config']}": tr["launches"]["fwd" if kname == "edge_block_fwd" else "bwd"]}
            by_kernel = {}
            if kname == "edge_block_fwd":
                per_path[f"rollout_{dt}"] = rollouts[dt]["launches"]
                by_kernel = {f"train_{tr['config']}": tr["fwd_launches_by_kernel"],
                             f"rollout_{dt}": rollouts[dt]["fwd_launches_by_kernel"]}
            entry = dict(
                name=kname, route="cuda", source=src, replaces=replaces,
                launches=per_path[f"train_{tr['config']}"], launches_by_path=per_path,
                dtype=dt, shape=res["shape"], max_abs_err=res["max_abs_err"], tol=res["tol"],
                checked_shapes=res["checked_shapes"], errors_at_training_shape=res["errors_at_training_shape"],
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=None, bytes=res["bytes"], flops=res["flops"],
                kernel_ms_runs=res["kernel_ms_runs"], plain_ms_runs=res["plain_ms_runs"],
            )
            entry["bound_share"] = res["bound_ms"] / res["ms"]
            if by_kernel:
                entry["launches_by_kernel"] = by_kernel
            if "at_rollout_shape" in res:
                entry["at_rollout_shape"] = {k: res["at_rollout_shape"][k] for k in
                                             ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
            kernels.append(entry)
    kernels.extend(gather_summary(gather, probe, ms_runs, trained["A"][0],
                                  {"train_B": trained["B"][0]["launches"]["take"],
                                   "rollout_bfloat16": rollouts["bfloat16"]["take_launches"]}))
    kernels.extend(bwd_gather_summary(bwd_gather, ms_train, trained["A"][0]))
    kernels.extend(epilogue_summary(epilogue, trained["A"][0], ms_runs, ms_train, ms_step_checks))
    kernels.extend(f32_product_summary(products, trained, rollouts, ms_runs, ms_train, epilogue))
    add_parallel_launches(kernels, parallel)
    add_capacity_launches(kernels, capacity)
    log("library " + json.dumps({"index_select": kernel_results["index_select"],
                                 "fixed_batch_losses": fixed, "card_vs_cpu_step": step_checks,
                                 "sym_gather_backward_check": sym_check, "c2_cost": c2,
                                 "ms_card_vs_cpu_step": ms_step_checks,
                                 "seconds": time.perf_counter() - t_start}))
    log("train routes " + json.dumps(train_routes_summary(trained, ms_train, smi)))
    log("routes " + json.dumps(routes_summary(rollouts, ms_runs, smi)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
