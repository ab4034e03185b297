"""The port's graph-partitioned single-scale model against JAX's on the CPU.

The same numpy inputs and JAX parameters (``state_dict_from_jax``) go
through ``sgnn_tpu.parallel.edge_partition`` on the 8-device host mesh and
through ``sgnn_tpu_torch.parallel.edge_partition`` on a mesh of CPU devices
(one process drives every shard), at the JAX tests' tolerances
(``tests/test_edge_partition.py``): the plan, the forward (brute force,
cell table, bf16), loss and gradients (plain and symmetric gather), the
train step, the multi-step, the rollout, the halo guard and in-step
rejection, both replanning rollouts; then ``train`` and ``predict`` with
``graph_parallel: 2`` and the trainer's config errors.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JMesh

from sgnn_tpu.parallel import edge_partition as jep
from sgnn_tpu.physics import noise as jnoise
from sgnn_tpu.physics import simulator as jsim
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.ops import sym_gather as tsg
from sgnn_tpu_torch.parallel import edge_partition as tep
from sgnn_tpu_torch.parallel.mesh import make_mesh
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.jax_params import state_dict_from_jax

torch.set_num_threads(1)

S, R = 5, 0.6
LR = 1e-3
# the JAX tests' tolerances: forward (tests/test_edge_partition.py:92-97),
# bf16 forward (:531-536), loss and gradients (:134-136), the train step
# (:241-247), the symmetric gradients (:572-574), the rollout (:281-289),
# the deforming replanning rollout (:497-504)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=0.05, atol=0.02)
LOSS_RTOL, GRAD_TOL = 1e-5, dict(rtol=5e-4, atol=1e-5)
STEP_LOSS_RTOL, STEP_PARAM_TOL = 2e-4, dict(rtol=5e-3, atol=1e-5)
SYM_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
ROLLOUT_TOL, RMSE_TOL = dict(rtol=1e-3, atol=2e-4), dict(rtol=1e-3, atol=1e-5)
REPLAN_TOL, REPLAN_RMSE_TOL = dict(rtol=2e-3, atol=5e-4), dict(rtol=2e-3, atol=1e-5)


def bar_lattice(nx=64, ny=8, spacing=0.5, jitter=0.02, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx) * spacing, np.arange(ny) * spacing, indexing="ij")
    pos = np.stack([xs.ravel() - 1.0, ys.ravel()], -1).astype(np.float32)
    return pos + rng.normal(scale=jitter, size=pos.shape).astype(np.float32)


def jax_mesh(p):
    return JMesh(np.asarray(jax.devices()[:p]).reshape(p), ("graph",))


def cpu_mesh(p):
    return make_mesh(data=1, graph=p, devices=["cpu"] * p)


def setup(seed=0, **cfg_kw):
    """Configs, stats and a seeded model of both packages, and a drifting
    bar of 512 particles [N, S, 2]."""
    rng = np.random.default_rng(seed)
    pos = bar_lattice(seed=seed)
    n = pos.shape[0]
    kw = dict(dim=2, latent_dim=16, num_message_passing_steps=2, input_sequence_length=S,
              connectivity_radius=R, max_neighbors=20)
    kw.update(cfg_kw)
    jcfg, tcfg = jsim.SimulatorConfig(**kw), tsim.SimulatorConfig(**kw)
    v = {k: rng.uniform(0.5, 1.5, size=2).astype(np.float32) * sc
         for k, sc in (("vel_mean", 0.001), ("vel_std", 0.01), ("acc_mean", 0.0001), ("acc_std", 0.002))}
    jstats = jsim.NormStats(**{k: jnp.asarray(a) for k, a in v.items()})
    tstats = tsim.NormStats(**{k: torch.from_numpy(a) for k, a in v.items()})
    params = jsim.simulator_init(jax.random.key(seed), jcfg)
    drift = rng.normal(scale=0.005, size=(n, S, 2)).cumsum(axis=1).astype(np.float32)
    return jcfg, tcfg, jstats, tstats, params, pos[:, None, :] + drift, n


def port_sim(tcfg, params):
    sim = tsim.simulator_init(tcfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return sim


def sorted_inputs(seq, n, shards=8, **plan_kw):
    spec, order = jep.partition_plan(seq[:, -1], shards, R, **plan_kw)
    seq_sorted = jep.scatter_to_shards(seq, order, spec)
    mask = np.zeros(spec.total_nodes, bool)
    mask[:n] = True
    return spec, order, seq_sorted, np.zeros(spec.total_nodes, np.int32), mask


def flat_batch(rng, seq_sorted, mask):
    nt = seq_sorted.shape[0]
    return {
        "positions": seq_sorted,
        "next_position": seq_sorted[:, -1] + rng.normal(scale=0.01, size=(nt, 2)).astype(np.float32),
        "next_strain": rng.normal(size=(nt,)).astype(np.float32),
        "particle_type": np.zeros(nt, np.int32),
        "node_mask": mask,
    }


def t(a):
    return torch.from_numpy(np.array(a))


def as_port(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


# --- plan -------------------------------------------------------------------------


def test_plan_matches_jax():
    pos = bar_lattice()
    for kw in ({}, dict(nodes_per_shard=96), dict(pad_multiple=16, halo_slack=2.0)):
        (js, jo), (ts, to) = jep.partition_plan(pos, 8, R, **kw), tep.partition_plan(pos, 8, R, **kw)
        assert dataclasses.astuple(ts) == dataclasses.astuple(js) and (to == jo).all()
        np.testing.assert_array_equal(tep.scatter_to_shards(pos, to, ts), jep.scatter_to_shards(pos, jo, js))
    f1 = pos.copy()
    f1[:, 0] *= 0.7
    assert dataclasses.astuple(tep.dataset_partition_plan([pos, f1], 8, R)) == dataclasses.astuple(
        jep.dataset_partition_plan([pos, f1], 8, R))
    crushed = pos.copy()
    crushed[:, 0] *= 0.01
    for fn in (lambda m: m.partition_plan(bar_lattice(nx=4, ny=16), 8, R),
               lambda m: m.dataset_partition_plan([pos, crushed], 8, R),
               lambda m: m.dataset_partition_plan([], 8, R)):
        with pytest.raises(ValueError):
            fn(jep)
        with pytest.raises(ValueError):
            fn(tep)
    # a loader batch with padding rows at x = 0, reordered and padded to the plan
    rng = np.random.default_rng(3)
    spec = tep.dataset_partition_plan([pos], 4, R)
    batch = {"positions": np.concatenate([pos[:, None, :].repeat(S, 1), np.zeros((16, S, 2), np.float32)])[None],
             "next_position": rng.normal(size=(1, len(pos) + 16, 2)).astype(np.float32),
             "next_strain": rng.normal(size=(1, len(pos) + 16)).astype(np.float32),
             "particle_type": np.zeros((1, len(pos) + 16), np.int32),
             "node_mask": np.arange(len(pos) + 16)[None] < len(pos)}
    got, want = tep.partition_sample(batch, spec), jep.partition_sample(batch, jep.PartitionSpec1D(*dataclasses.astuple(spec)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_halo_exchange_gradient_reaches_the_owner_shard():
    """Two shards on the CPU: each ext row is its neighbour's row (zeros at
    the boundaries), and its gradient reaches the shard that owns it (the
    transpose of JAX's ppermute); the card runs the same check on cuda:0."""
    from test_torch_port_cuda import halo_exchange_gradient_check

    halo_exchange_gradient_check(torch.device("cpu"))


# --- forward, loss, gradients -------------------------------------------------------


@pytest.mark.parametrize("variant", ["bruteforce", "celltable", "bf16"])
def test_partitioned_forward_matches_jax(variant):
    kw = {"celltable": dict(domain=((-2.0, -2.0), (34.0, 6.0))), "bf16": dict(compute_dtype="bfloat16")}
    jcfg, tcfg, jstats, tstats, params, seq, n = setup(**kw.get(variant, {}))
    spec, _, seq_sorted, types, mask = sorted_inputs(seq, n)
    want_pos, want_strain = jep.make_partitioned_predict_positions(jax_mesh(8), jcfg, jstats, spec)(
        params, jnp.asarray(seq_sorted), jnp.asarray(types), jnp.asarray(mask))
    sim = port_sim(tcfg, params)
    with torch.no_grad():
        got_pos, got_strain = tep.make_partitioned_predict_positions(cpu_mesh(8), tcfg, tstats, spec)(
            sim, t(seq_sorted), t(types), t(mask))
        single_pos, single_strain = tsim.predict_positions_flat(sim, tcfg, tstats, t(seq_sorted), t(types), t(mask))
    tol = BF16_TOL if variant == "bf16" else FWD_TOL
    np.testing.assert_allclose(got_pos.numpy()[mask], np.asarray(want_pos)[mask], **tol)
    np.testing.assert_allclose(got_strain.numpy()[mask], np.asarray(want_strain)[mask], **tol)
    # and the port's own single-device forward on the same sorted layout
    np.testing.assert_allclose(got_pos.numpy()[mask], single_pos.numpy()[mask], **tol)
    np.testing.assert_allclose(got_strain.numpy()[mask], single_strain.numpy()[mask], **tol)


def _loss_inputs(seq, n):
    spec, _, seq_sorted, types, mask = sorted_inputs(seq, n)
    rng = np.random.default_rng(1)
    noise = rng.normal(scale=1e-3, size=seq_sorted.shape).astype(np.float32)
    b = flat_batch(rng, seq_sorted, mask)
    return spec, (seq_sorted, noise, b["next_position"], b["next_strain"], types, mask)


@pytest.mark.parametrize("symmetric", [False, True], ids=["plain_gather", "symmetric_gather"])
def test_partitioned_loss_and_grads_match_jax(symmetric, monkeypatch):
    """Loss and every gradient of the partitioned objective; the symmetric
    route (engaged at the test's size by the threshold set to 0 on both
    sides, as tests/test_edge_partition.py:550) also against the port's plain
    route: its reverses owned by neighbour shards reach them through the
    halo exchange's backward."""
    if symmetric:
        monkeypatch.setattr(jep, "_SYM_MIN_LOCAL_ROWS", 0)
        monkeypatch.setattr(tep, "_SYM_MIN_LOCAL_ROWS", 0)
    jcfg, tcfg, jstats, tstats, params, seq, n = setup(symmetric_gather=symmetric)
    spec, args = _loss_inputs(seq, n)
    jloss = jep.make_partitioned_loss(jax_mesh(8), jcfg, jstats, spec)
    want_l, want_g = jax.value_and_grad(lambda p: jloss(p, *map(jnp.asarray, args)))(params)

    def port(cfg):
        sim = port_sim(cfg, params)
        loss = tep.make_partitioned_loss(cpu_mesh(8), cfg, tstats, spec)(sim, *map(t, args))
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in sim.named_parameters()}

    calls = tsg.BWD_CALLS
    got_l, got_g = port(tcfg)
    assert tsg.BWD_CALLS - calls == (2 * 8 if symmetric else 0)  # one per layer and shard
    np.testing.assert_allclose(got_l, float(want_l), rtol=LOSS_RTOL)
    want_g = as_port(want_g)
    assert set(got_g) == set(want_g)
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), **(SYM_GRAD_TOL if symmetric else GRAD_TOL),
                                   err_msg=k)
    if symmetric:
        plain_l, plain_g = port(dataclasses.replace(tcfg, symmetric_gather=False))
        np.testing.assert_allclose(got_l, plain_l, rtol=1e-6)
        for k, g in got_g.items():
            np.testing.assert_allclose(g.numpy(), plain_g[k].numpy(), **SYM_GRAD_TOL, err_msg=k)


# --- training -----------------------------------------------------------------------


def _port_step(tcfg, tstats, spec, params, mesh=None):
    sim = port_sim(tcfg, params)
    opt = torch.optim.Adam(sim.parameters(), lr=LR, betas=ttrain.ADAM_BETAS, eps=ttrain.ADAM_EPS)
    step = tep.make_partitioned_train_step(mesh or cpu_mesh(spec.num_shards), tcfg, tstats, spec, sim, opt,
                                           lambda _: LR, noise_std=1e-3)
    return sim, opt, step


def test_partitioned_train_step_matches_jax():
    """3 steps from the same parameters on the same noise (JAX's draws
    injected): loss per step, and the parameters after Adam."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    spec, _, seq_sorted, _, mask = sorted_inputs(seq, n)
    batch = flat_batch(np.random.default_rng(3), seq_sorted, mask)
    tx = optax.adam(LR)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}
    jstep = jep.make_partitioned_train_step(jax_mesh(8), jcfg, jstats, spec, tx, noise_std=1e-3)
    sim, _, step = _port_step(tcfg, tstats, spec, params)
    tbatch = {k: t(v) for k, v in batch.items()}
    for i in range(3):
        key = jax.random.key(100 + i)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        noise = jnoise.random_walk_position_noise(key, seq_sorted.shape, 1e-3)
        m = step(tbatch, i, noise=t(noise))
        np.testing.assert_allclose(float(m["train/loss"]), float(jm["train/loss"]), rtol=STEP_LOSS_RTOL)
        assert int(m["train/halo_violations"]) == int(jm["train/halo_violations"]) == 0
        assert int(m["train/halo_rejected"]) == 0
    want = as_port(state["params"])
    for k, p in sim.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), **STEP_PARAM_TOL, err_msg=k)


def test_partitioned_multi_step_matches_jax():
    """make_partitioned_multi_step (3 stacked samples, noise from fold_in
    keys) against JAX's scanned one."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    spec, _, seq_sorted, _, mask = sorted_inputs(seq, n)
    batch = flat_batch(np.random.default_rng(9), seq_sorted, mask)
    inner, key = 3, jax.random.key(11)
    stacked = {k: np.broadcast_to(v[None], (inner,) + v.shape).copy() for k, v in batch.items()}
    tx = optax.adam(LR)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}
    multi = jep.make_partitioned_multi_step(jax_mesh(8), jcfg, jstats, spec, tx, inner, noise_std=1e-3)
    j_state, jm = multi(state, jax.tree.map(jnp.asarray, stacked), key)
    noise = np.stack([np.asarray(jnoise.random_walk_position_noise(
        jax.random.fold_in(key, np.uint32(i)), seq_sorted.shape, 1e-3)) for i in range(inner)])
    sim, _, step = _port_step(tcfg, tstats, spec, params)
    tm = tep.make_partitioned_multi_step(step, inner)({k: t(v) for k, v in stacked.items()}, 0, noise=t(noise))
    np.testing.assert_allclose(tm["train/loss"].numpy(), np.asarray(jm["train/loss"]), rtol=STEP_LOSS_RTOL)
    assert tm["train/halo_violations"].shape == (inner,)
    want = as_port(j_state["params"])
    for k, p in sim.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), **STEP_PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("layout", ["drift", "empty_shards"])
def test_halo_guard_counts_match_jax(layout):
    """The guard's count of broken conditions equals JAX's: a bar whose first
    slab's interior nodes teleport 20 units right, on 8 full shards, and
    on a plan whose last two shards hold only padding (their extents are
    (+inf, -inf))."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    plan_kw = {"empty_shards": dict(nodes_per_shard=88)}.get(layout, {})
    spec, _, seq_sorted, types, mask = sorted_inputs(seq, n, **plan_kw)
    bad = seq_sorted.copy()
    bad[: spec.nodes_per_shard // 2, :, 0] += 20.0
    for pos in (seq_sorted, bad):
        _, _, want = jax.jit(jep._build_forward(jax_mesh(8), jcfg, jstats, spec, "graph"))(
            params, jnp.asarray(pos), jnp.asarray(types), jnp.asarray(mask))
        with torch.no_grad():
            sims = [port_sim(tcfg, params)] * 8
            _, _, got = tep._build_forward(cpu_mesh(8), tcfg, tstats, spec)(sims, t(pos), t(types), t(mask))
        assert int(got) == int(want), (layout, int(got), int(want))
    assert int(want) > 0


def test_rejected_step_leaves_parameters_and_adam_state_bit_equal():
    """After a clean step (Adam's moments and count exist), a step whose
    guard fires changes no bit of the parameters or of Adam's state, as
    JAX's (tests/test_edge_partition.py:318-328); the next clean step
    updates them again."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    spec, _, seq_sorted, _, mask = sorted_inputs(seq, n)
    bad = seq_sorted.copy()
    bad[: spec.nodes_per_shard // 2, :, 0] += 20.0
    good = {k: t(v) for k, v in flat_batch(np.random.default_rng(0), seq_sorted, mask).items()}
    sim, opt, step = _port_step(tcfg, tstats, spec, params)
    step(good, 0)
    before = ({k: v.clone() for k, v in sim.state_dict().items()},
              [{k: v.clone() for k, v in st.items()} for st in opt.state.values()])
    m = step({**good, "positions": t(bad), "next_position": t(bad[:, -1])}, 1)
    assert int(m["train/halo_violations"]) > 0 and int(m["train/halo_rejected"]) == 1
    assert all(torch.equal(v, before[0][k]) for k, v in sim.state_dict().items())
    for st, old in zip(opt.state.values(), before[1]):
        assert all(torch.equal(st[k], old[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    m = step(good, 2)
    assert int(m["train/halo_rejected"]) == 0
    assert any(not torch.equal(v, before[0][k]) for k, v in sim.state_dict().items())
    assert float(next(iter(opt.state.values()))["step"]) == 2.0


def test_a_rejected_first_step_leaves_adam_at_its_start():
    """A first step rejected before Adam has any state: the parameters stay,
    and the state Adam's step made is set back to zeros (optax's fresh
    state), so the next clean step is Adam's first."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    spec, _, seq_sorted, _, mask = sorted_inputs(seq, n)
    bad = seq_sorted.copy()
    bad[: spec.nodes_per_shard // 2, :, 0] += 20.0
    batch = {k: t(v) for k, v in flat_batch(np.random.default_rng(0), bad, mask).items()}
    sim, opt, step = _port_step(tcfg, tstats, spec, params)
    before = {k: v.clone() for k, v in sim.state_dict().items()}
    assert int(step(batch, 0)["train/halo_rejected"]) == 1
    assert all(torch.equal(v, before[k]) for k, v in sim.state_dict().items())
    for st in opt.state.values():
        assert all(not st[k].any() for k in ("step", "exp_avg", "exp_avg_sq"))


def test_rejection_tracker_contract():
    tr = tep.RejectionTracker(limit=3)
    tr.update(True)
    tr.update(True)
    tr.update(False)  # a clean step resets the consecutive count
    tr.update(True)
    tr.update(True)
    assert tr.total == 4 and tr.consecutive == 2
    with pytest.raises(RuntimeError, match="halo-contract"):
        tr.update(True)


# --- rollouts -----------------------------------------------------------------------


def _trajectory(seq, n, t_total, seed=7):
    rng = np.random.default_rng(seed)
    drift = rng.normal(scale=0.003, size=(n, t_total, 2)).cumsum(axis=1).astype(np.float32)
    return seq[:, :1] + drift, rng.normal(size=(t_total, n)).astype(np.float32)


def test_partitioned_rollout_matches_jax():
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    t_total = 9
    traj, strains = _trajectory(seq, n, t_total)
    spec, order = jep.partition_plan(traj[:, 0], 8, R)
    traj_sorted = jep.scatter_to_shards(traj, order, spec)
    strains_sorted = np.zeros((t_total, spec.total_nodes), np.float32)
    strains_sorted[:, :n] = strains[:, order]
    types = np.zeros(spec.total_nodes, np.int32)
    types[5] = -1  # one erosional particle follows the ground truth
    mask = np.zeros(spec.total_nodes, bool)
    mask[:n] = True
    args = (traj_sorted, types, strains_sorted, mask)
    want = jep.make_partitioned_rollout(jax_mesh(8), jcfg, jstats, spec)(params, *map(jnp.asarray, args))
    run = tep.make_partitioned_rollout(cpu_mesh(8), tcfg, tstats, spec)
    sim = port_sim(tcfg, params)
    got = run(sim, *args)
    eager = run(sim, *args, capture=False)
    assert got["halo_violations"].shape == (t_total - S,) and int(got["halo_violations"].sum()) == 0
    np.testing.assert_allclose(got["predicted_rollout"].numpy()[:, mask],
                               np.asarray(want["predicted_rollout"])[:, mask], **ROLLOUT_TOL)
    np.testing.assert_allclose(got["rmse_position"].numpy(), np.asarray(want["rmse_position"]), **RMSE_TOL)
    for k in ("predicted_rollout", "predicted_strain", "halo_violations"):
        assert torch.equal(got[k], eager[k]), k  # the step over static buffers = the eager loop


@pytest.mark.parametrize("geometry", ["clean", "deforming"])
def test_replanning_rollout_matches_jax(geometry):
    """Caller-order rollouts that re-plan when the guard fires. clean: a
    gently drifting bar, no replan; deforming: a block of erosional
    particles crosses every slab of 4 (tests/test_edge_partition.py:458-504),
    both sides re-plan the same number of times and end with 0 residual
    violations."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    if geometry == "clean":
        t_total = 8
        traj, strains = _trajectory(seq, n, t_total)
        types = np.zeros(n, np.int32)
        spec, _ = jep.partition_plan(traj[:, 0], 8, R)
        tol, rmse_tol = ROLLOUT_TOL, RMSE_TOL
    else:
        t_total = 10
        pos0 = seq[:, -1]
        x_min, x_max = pos0[:, 0].min(), pos0[:, 0].max()
        migrate = pos0[:, 0] < x_min + 4.0
        traj = np.repeat(pos0[:, None, :], t_total, axis=1).astype(np.float32)
        traj[migrate, :, 0] += np.linspace(0.0, x_max - x_min, t_total, dtype=np.float32)[None, :]
        types = np.where(migrate, -1, 0).astype(np.int32)
        strains = np.zeros((t_total, n), np.float32)
        spec, _ = jep.partition_plan(traj[:, 0], 4, R)
        spec = dataclasses.replace(spec, halo=spec.nodes_per_shard // 2)
        tol, rmse_tol = REPLAN_TOL, REPLAN_RMSE_TOL
    mask = np.ones(n, bool)
    p = spec.num_shards
    want = jep.make_replanning_rollout(jax_mesh(p), jcfg, jstats, spec)(params, traj, types, strains, mask)
    tspec = tep.PartitionSpec1D(*dataclasses.astuple(spec))
    got = tep.make_replanning_rollout(cpu_mesh(p), tcfg, tstats, tspec)(port_sim(tcfg, params), traj, types,
                                                                         strains, mask)
    assert int(got["replans"]) == want["replans"] and (want["replans"] > 0) == (geometry == "deforming")
    np.testing.assert_array_equal(got["halo_violations"].numpy(), want["halo_violations"])
    assert int(got["halo_violations"].sum()) == 0
    np.testing.assert_allclose(got["predicted_rollout"].numpy(), want["predicted_rollout"], **tol)
    np.testing.assert_allclose(got["rmse_position"].numpy(), want["rmse_position"], **rmse_tol)


def test_replanning_rollout_keeps_its_eager_and_captured_steps_apart():
    """capture=False runs the step eagerly even after a captured run of
    the same shapes cached its step (and the other way round)."""
    from sgnn_tpu_torch.physics import captured_step

    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    traj, strains = _trajectory(seq, n, 7)
    spec, _ = tep.partition_plan(traj[:, 0], 2, R)
    run = tep.make_replanning_rollout(cpu_mesh(2), tcfg, tstats, spec)
    sim = port_sim(tcfg, params)
    args = (traj, np.zeros(n, np.int32), strains, np.ones(n, bool))
    outs = [run(sim, *args, capture=c) for c in (True, False, True)]
    assert sorted(s.capture for s in captured_step.steps_of(sim)) == [False, True]
    assert all(torch.equal(o["predicted_rollout"], outs[0]["predicted_rollout"]) for o in outs)


def test_shards_on_one_device_match_shards_on_their_own():
    """Two and eight shards of one graph give the same rollout (within the
    forward's tolerance), and a model of one shard the single-device one."""
    jcfg, tcfg, jstats, tstats, params, seq, n = setup()
    traj, strains = _trajectory(seq, n, 7)
    sim, mask, types = port_sim(tcfg, params), np.ones(n, bool), np.zeros(n, np.int32)
    outs = []
    for p in (1, 2, 8):
        spec, _ = tep.partition_plan(traj[:, 0], p, R)
        outs.append(tep.make_replanning_rollout(cpu_mesh(p), tcfg, tstats, spec)(sim, traj, types, strains, mask))
    from sgnn_tpu_torch.physics.rollout import rollout

    single = rollout(sim, tcfg, tstats, traj, types, strains, node_mask=mask, device="cpu")
    for out in outs:
        np.testing.assert_allclose(out["predicted_rollout"].numpy(), single["predicted_rollout"].numpy(),
                                   **ROLLOUT_TOL)


# --- the trainer --------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_gp")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=24, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root, root / "data"


def tiny_config(root, data, **kw):
    base = dict(mode="train", data_path=str(data), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, dim=2,
                input_sequence_length=6, connection_radius=0.6, batch_size=1, noise_std=0.001,
                ntraining_steps=20, nsave_steps=10, lr_init=1e-3, run_name="gp", pad_multiple=32,
                seed=0, log_every=1, graph_parallel=2)
    base.update(kw)
    return TrainConfig(**base)


def test_train_and_predict_graph_parallel(tiny_env):
    """train over 2 shards on the CPU: validates with the re-planning
    rollout, checkpoints, every step's guard quiet; predict reads the
    checkpoint and rolls out partitioned, within the rollout tolerance of
    the single-device predict."""
    root, data = tiny_env
    cpu2 = ["cpu", "cpu"]
    result = ttrain.train(tiny_config(root, data), device="cpu", devices=cpu2)
    assert result["step"] == 20 and np.isfinite(result["lowest_eval_loss"])
    lines = [json.loads(line) for line in open(root / "models" / "gp" / "metrics.jsonl")]
    hv = [line["train/halo_violations"] for line in lines if "train/halo_violations" in line]
    assert len(hv) == 20 and max(hv) == 0
    assert all(line["train/halo_rejected"] == 0 for line in lines if "train/halo_rejected" in line)
    meta = json.load(open(root / "models" / "gp" / "checkpoint_meta.json"))
    cfg = tiny_config(root, data, mode="rollout", model_file=meta["path"])
    summary = ttrain.predict(cfg, device="cpu", devices=cpu2)
    single = ttrain.predict(dataclasses.replace(cfg, graph_parallel=1, output_path=str(root / "single")),
                            device="cpu")
    assert np.isfinite(summary["total"])
    np.testing.assert_allclose(summary["total"], single["total"], rtol=1e-3)


def test_train_graph_parallel_config_errors(tiny_env):
    root, data = tiny_env
    with pytest.raises(ValueError, match="batch_size"):
        ttrain.train(tiny_config(root, data, batch_size=4), device="cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttrain.train(tiny_config(root, data, data_parallel=2), device="cpu", devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="CUDA devices"):
        ttrain.train(tiny_config(root, data), device="cpu")  # no mesh named: never the CPU by default
    with pytest.raises(ValueError, match="first device"):
        ttrain.train(tiny_config(root, data), device="cpu", devices=["meta", "cpu"])


def test_capacity_knobs_raise_as_on_one_device():
    """The capacity knobs build a partitioned forward now; a remat value
    that the one-device forward refuses is refused here too, as is a plan
    whose shards the mesh does not have."""
    _, tcfg, _, tstats, _, _, _ = setup()
    spec = tep.PartitionSpec1D(2, 64, 8)
    for kw in (dict(band_nodes=64), dict(remat=True), dict(remat="group")):
        tep.make_partitioned_forward(cpu_mesh(2), dataclasses.replace(tcfg, **kw), tstats, spec)
    with pytest.raises(ValueError, match="remat"):
        tep.make_partitioned_forward(cpu_mesh(2), dataclasses.replace(tcfg, remat="half"), tstats, spec)
    with pytest.raises(ValueError, match="2 shards"):
        tep.make_partitioned_forward(cpu_mesh(4), tcfg, tstats, spec)
