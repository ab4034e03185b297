"""The port's multi-scale graph partition against JAX's on the CPU.

The same numpy inputs and JAX parameters (``ms_state_dict_from_jax``) go
through ``sgnn_tpu.parallel.ms_partition`` on the 8-device host mesh (4
shards) and through ``sgnn_tpu_torch.parallel.ms_partition`` on a mesh of
CPU devices (one process drives every shard), at the JAX tests'
tolerances (``tests/test_ms_partition.py``): the plans exactly (COO and
dense), the forward (f32, bf16, dense), the train step (COO and dense),
the multi-step, the rollout, the dataset plans and the dense slot widths;
then the port's own contracts (the COO sender order, the captured rollout
against the eager one) and ``train`` with ``graph_parallel: 2`` in both
layouts.
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

from sgnn_tpu.parallel import ms_partition as jmp
from sgnn_tpu.physics import multi_scale_simulator as jms
from sgnn_tpu.physics import noise as jnoise
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.parallel import ms_partition as tmp
from sgnn_tpu_torch.parallel.edge_partition import PartitionSpec1D
from sgnn_tpu_torch.parallel.mesh import make_mesh
from sgnn_tpu_torch.physics import multi_scale_graph as tg
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train import train_multi_scale as ttms
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.jax_params import ms_state_dict_from_jax

torch.set_num_threads(1)

SHARDS, LR = 4, 1e-3
# tests/test_ms_partition.py's tolerances: the forward (:95-100), the
# train step (:169-171), the multi-step (:238-244), the rollout (:276-285),
# bf16 (:313-318), the dense train step (:426-433)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_LOSS_RTOL, STEP_PARAM_TOL = 2e-4, dict(rtol=5e-3, atol=1e-5)
MULTI_LOSS_RTOL, MULTI_PARAM_TOL = 1e-5, dict(rtol=1e-4, atol=1e-7)
ROLLOUT_TOL, RMSE_TOL = dict(rtol=1e-3, atol=2e-4), dict(rtol=1e-3, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.02)
DENSE_LOSS_RTOL, DENSE_PARAM_TOL = 2e-5, dict(rtol=2e-4, atol=1e-6)


def bar(nx=48, ny=8, spacing=0.5):
    xs, ys = np.meshgrid(np.arange(nx) * spacing, np.arange(ny) * spacing, indexing="ij")
    return np.stack([xs.ravel() - 1.0, ys.ravel()], -1).astype(np.float32)


def jax_mesh(p=SHARDS):
    return JMesh(np.asarray(jax.devices()[:p]).reshape(p), ("graph",))


def cpu_mesh(p=SHARDS):
    return make_mesh(data=1, graph=p, devices=["cpu"] * p)


def t(a):
    return torch.from_numpy(np.array(a))


def setup(rng, s=4, nx=48, ny=8, num_scales=2, layout="coo", **cfg_kw):
    """Configs of both packages, JAX's params, both plans (equal) and a
    drifting bar in the plan's sorted layout (the JAX test's ``_setup``
    and ``_setup3``)."""
    kw = dict(dim=2, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=2, input_sequence_length=s,
              num_scales=num_scales, window_size=2, radius_multiplier=2.0, **cfg_kw)
    jcfg, tcfg = jms.MultiScaleSimulatorConfig(**kw), tms.MultiScaleSimulatorConfig(**kw)
    params = jms.multi_scale_simulator_init(jax.random.key(0), jcfg)
    grid = bar(nx=nx, ny=ny)
    n = grid.shape[0]
    spec, order, jgraph = jmp.plan_ms_partition(jcfg.graph_config, grid, SHARDS, layout=layout)
    tspec, torder, tgraph = tmp.plan_ms_partition(tcfg.graph_config, grid, SHARDS, layout=layout)
    assert dataclasses.astuple(tspec) == dataclasses.astuple(spec) and np.array_equal(torder, order)
    drift = rng.normal(scale=0.004, size=(n, s, 2)).cumsum(axis=1).astype(np.float32)
    nt = spec.total_nodes
    seq_pad = np.zeros((nt, s, 2), np.float32)
    seq_pad[:n] = grid[order][:, None, :] + drift
    mask = np.zeros(nt, bool)
    mask[:n] = True
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, spec=spec, tspec=tspec, order=order, jgraph=jgraph,
                tgraph=tgraph, grid=grid, seq=seq_pad, types=np.zeros(nt, np.int32), mask=mask, n=n)


def stats_pair():
    z, o = np.zeros(2, np.float32), np.ones(2, np.float32)
    return jms.NormStats(*(jnp.asarray(a) for a in (z, o, z, o))), tms.NormStats(*(t(a) for a in (z, o, z, o)))


def port_sim(tcfg, params):
    sim = tms.multi_scale_simulator_init(tcfg, device="cpu")
    sim.load_state_dict(ms_state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return sim


def as_port(params):
    return ms_state_dict_from_jax(jax.tree.map(np.asarray, params))


def jgraph_dev(graph):
    return jax.tree.map(jnp.asarray, graph)


def assert_plan_equal(tgraph, jgraph):
    """Every sharded index and mask array equal, the COO sender order the
    port's own (a stable sort of each shard's valid senders)."""
    if isinstance(jgraph, jmp.ShardedDenseMSGraph):
        assert isinstance(tgraph, tmp.ShardedDenseMSGraph) and len(tgraph.m2m) == len(jgraph.m2m)
        for tde, jde in zip((tgraph.g2m, *tgraph.m2m, tgraph.m2g), (jgraph.g2m, *jgraph.m2m, jgraph.m2g)):
            for name in jde._fields:
                a, b = getattr(tde, name), np.asarray(getattr(jde, name))
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        return
    for name in ("g2m", "m2m", "m2g"):
        te, je = getattr(tgraph, name), getattr(jgraph, name)
        for f in ("senders", "receivers", "mask"):
            a, b = getattr(te, f), np.asarray(getattr(je, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
        np.testing.assert_array_equal(te.order, tg.sender_order(te.senders, te.mask))


def port_forward(d, tstats, **cfg_kw):
    tcfg = dataclasses.replace(d["tcfg"], **cfg_kw)
    with torch.no_grad():
        return tmp.make_ms_partitioned_forward(cpu_mesh(), tcfg, tstats, d["tspec"])(
            port_sim(tcfg, d["params"]), t(d["seq"]), t(d["types"]), tmp.sharded_graph_to(d["tgraph"], "cpu"))


def single_device_forward(d, tstats, graph, **cfg_kw):
    """The port's one-device forward on the plan's sorted layout."""
    tcfg, n = dataclasses.replace(d["tcfg"], **cfg_kw), d["n"]
    with torch.no_grad():
        return tms._forward(port_sim(tcfg, d["params"]), tcfg, tstats, t(d["seq"][:n]), t(d["types"][:n]),
                            tms.graph_to(graph, torch.device("cpu")))


def sorted_static_graph(d):
    return tg.build_static_graph(d["tcfg"].graph_config, d["grid"][d["order"]], g2m_pad=2048, m2m_pad=1024,
                                 m2g_pad=2048)


def sorted_dense_graph(d):
    n = d["n"]
    return tg.build_dense_static_graph(d["tcfg"].graph_config, d["grid"][d["order"]], g2m_rows=n, m2m_rows=n,
                                       m2g_rows=n)


# --- plans ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_plan_validates_and_sizes_halo(layout):
    """3 scales on a 64 x 8 bar: the spec, order and every sharded array
    equal JAX's; senders lie in the extended window; too many shards for
    the coarsest scale raise on both sides."""
    jcfg = jms.MultiScaleSimulatorConfig(num_scales=3, window_size=2, input_sequence_length=4)
    tcfg = tms.MultiScaleSimulatorConfig(num_scales=3, window_size=2, input_sequence_length=4)
    grid = bar(nx=64, ny=8)
    js, jo, jg = jmp.plan_ms_partition(jcfg.graph_config, grid, 4, layout=layout)
    ts, to, tgr = tmp.plan_ms_partition(tcfg.graph_config, grid, 4, layout=layout)
    assert dataclasses.astuple(ts) == dataclasses.astuple(js) and np.array_equal(to, jo)
    assert (np.diff(grid[to, 0]) >= 0).all() and ts.halo >= 32
    assert_plan_equal(tgr, jg)
    if layout == "coo":
        for e in tgr:
            assert e.senders[e.mask].min() >= 0 and e.senders[e.mask].max() < ts.ext_nodes
    bad = dict(num_scales=3, window_size=3, input_sequence_length=4)
    for mod, cfg in ((jmp, jms.MultiScaleSimulatorConfig(**bad)), (tmp, tms.MultiScaleSimulatorConfig(**bad))):
        with pytest.raises(ValueError):
            mod.plan_ms_partition(cfg.graph_config, bar(nx=24, ny=8), 8, layout=layout)


def test_coo_sender_order_ascends_padding_included():
    """Port only: in every shard and edge type the senders the forward
    gathers (padded slots at the extended table's last row) taken in the
    shard's ``order`` ascend, padding included, as the sorted segment sum of
    the sender backward needs; the receivers ascend too."""
    d = setup(np.random.default_rng(0))
    ext = d["tspec"].ext_nodes
    graph = tmp.sharded_graph_to(d["tgraph"], "cpu")
    padded = 0
    for e in graph:
        for s in range(SHARDS):
            edges, sorted_senders = tmp._coo_shard(tg.PaddedEdges(*(a[s] for a in e)), ext)
            assert bool((sorted_senders[1:] >= sorted_senders[:-1]).all())
            assert bool((edges.receivers[1:] >= edges.receivers[:-1]).all())
            assert int(sorted_senders.max()) <= ext - 1
            pad = ~edges.mask
            padded += int(pad.sum())
            assert bool((edges.senders[pad] == ext - 1).all())
            assert bool(pad[edges.order][len(pad) - int(pad.sum()):].all())  # padded slots come last
    assert padded > 0


def test_ms_dataset_partition_common_shapes(rng):
    """Three bars of different lengths: the spec and every plan equal
    JAX's (both layouts), one set of shapes; ms_partition_sample equals
    JAX's."""
    cfg_kw = dict(num_scales=2, window_size=2, input_sequence_length=4)
    jcfg, tcfg = jms.MultiScaleSimulatorConfig(**cfg_kw), tms.MultiScaleSimulatorConfig(**cfg_kw)
    frames = [bar(nx=40, ny=8), bar(nx=48, ny=8), bar(nx=44, ny=8)]
    for layout in ("coo", "dense"):
        js, jplans = jmp.ms_dataset_partition(jcfg.graph_config, frames, 4, layout=layout)
        ts, tplans = tmp.ms_dataset_partition(tcfg.graph_config, frames, 4, layout=layout)
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)
        for (to, tgr), (jo, jgr) in zip(tplans, jplans):
            assert np.array_equal(to, jo)
            assert_plan_equal(tgr, jgr)
        shapes = [[a.shape for a in jax.tree.leaves(tuple(g))] for _, g in tplans]
        assert shapes[0] == shapes[1] == shapes[2]
    assert ts.total_nodes >= max(len(f) for f in frames)
    n = len(frames[1])
    batch = {
        "positions": rng.normal(size=(1, n, 4, 2)).astype(np.float32),
        "next_position": rng.normal(size=(1, n, 2)).astype(np.float32),
        "next_strain": rng.normal(size=(1, n)).astype(np.float32),
        "particle_type": np.zeros((1, n), np.int32),
        "node_mask": np.ones((1, n), bool),
    }
    order = tplans[1][0]
    got = tmp.ms_partition_sample(batch, ts, order)
    want = jmp.ms_partition_sample(batch, js, jplans[1][0])
    assert set(got) == set(want) and got["positions"].shape == (ts.total_nodes, 4, 2)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError):
        tmp.ms_dataset_partition(tcfg.graph_config, [], 4)


def test_dense_shard_sizes_use_exact_slot_widths():
    """K and the plan's K are the exact per-shard maxima (no round-up), the
    rows keep the pad multiple: the values of JAX's helper."""
    senders = np.array([0, 1, 2, 3, 4, 5, 6], np.int64)
    receivers = np.array([0, 0, 0, 0, 0, 1, 2], np.int64)
    got = tmp._dense_shard_sizes(senders, receivers, per=64, num_shards=1)
    assert got == jmp._dense_shard_sizes(senders, receivers, per=64, num_shards=1)
    rows, k, tsp_rows, tsp_k = got
    assert k == 5 and tsp_k == 1 and rows % 8 == 0 and tsp_rows % 8 == 0


# --- forwards ------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["f32", "bf16", "dense"])
def test_ms_partitioned_forward_matches_jax(rng, variant):
    """COO f32 and bf16 on 2 scales, dense f32 on 3 scales: the port's
    partitioned forward against JAX's, and against the port's one-device
    forward on the same sorted layout."""
    kw = {"bf16": dict(compute_dtype="bfloat16")}.get(variant, {})
    geo = dict(nx=64, num_scales=3, layout="dense") if variant == "dense" else {}
    d = setup(rng, **geo, **kw)
    jstats, tstats = stats_pair()
    want_acc, want_strain = jmp.make_ms_partitioned_forward(jax_mesh(), d["jcfg"], jstats, d["spec"])(
        d["params"], jnp.asarray(d["seq"]), jnp.asarray(d["types"]), jgraph_dev(d["jgraph"]))
    acc, strain = port_forward(d, tstats)
    n = d["n"]
    tol = BF16_TOL if variant == "bf16" else FWD_TOL
    np.testing.assert_allclose(acc.numpy()[:n], np.asarray(want_acc)[:n], **tol)
    np.testing.assert_allclose(strain.numpy()[:n], np.asarray(want_strain)[:n], **tol)
    graph = sorted_dense_graph(d) if variant == "dense" else sorted_static_graph(d)
    one_acc, one_strain = single_device_forward(d, tstats, graph)
    np.testing.assert_allclose(acc.numpy()[:n], one_acc.numpy(), **tol)
    np.testing.assert_allclose(strain.numpy()[:n], one_strain.numpy(), **tol)


# --- training ------------------------------------------------------------------------


def train_batch(d, rng):
    nt = d["spec"].total_nodes
    return {
        "positions": d["seq"],
        "next_position": d["seq"][:, -1] + rng.normal(scale=0.01, size=(nt, 2)).astype(np.float32),
        "next_strain": rng.normal(size=(nt,)).astype(np.float32),
        "particle_type": d["types"],
        "node_mask": d["mask"],
    }


def port_step(d, tstats, noise_std):
    sim = port_sim(d["tcfg"], d["params"])
    opt = torch.optim.Adam(sim.parameters(), lr=LR, betas=ttrain.ADAM_BETAS, eps=ttrain.ADAM_EPS)
    step = tmp.make_ms_partitioned_train_step(cpu_mesh(), d["tcfg"], tstats, d["tspec"], sim, opt, lambda _: LR,
                                              noise_std=noise_std)
    return sim, step


def jax_state(params):
    tx = optax.adam(LR)
    return tx, {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_ms_partitioned_train_step_matches_jax(rng, layout):
    """COO: 2 steps from the same parameters on JAX's noise, the loss per
    step and the parameters after Adam at the JAX test's tolerances; dense
    (3 scales, no noise): one step at the dense test's."""
    geo = dict(nx=64, num_scales=3, layout="dense") if layout == "dense" else {}
    d = setup(rng, **geo)
    jstats, tstats = stats_pair()
    batch = train_batch(d, rng)
    noise_std = 0.0 if layout == "dense" else 1e-3
    tx, state = jax_state(d["params"])
    jstep = jmp.make_ms_partitioned_train_step(jax_mesh(), d["jcfg"], jstats, d["spec"], tx, noise_std=noise_std)
    sim, step = port_step(d, tstats, noise_std)
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "graph": jgraph_dev(d["jgraph"])}
    tbatch = {**{k: t(v) for k, v in batch.items()}, "graph": tmp.sharded_graph_to(d["tgraph"], "cpu")}
    steps = 1 if layout == "dense" else 2
    for i in range(steps):
        key = jax.random.key(50 + i)
        state, jm = jstep(state, jbatch, key)
        noise = jnoise.random_walk_position_noise(key, d["seq"].shape, noise_std)
        m = step(tbatch, i, noise=t(noise))
        rtol = DENSE_LOSS_RTOL if layout == "dense" else STEP_LOSS_RTOL
        np.testing.assert_allclose(float(m["train/loss"]), float(jm["train/loss"]), rtol=rtol)
        for k in ("train/loss-position", "train/loss-strain"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=k)
    want = as_port(state["params"])
    for k, p in sim.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(),
                                   **(DENSE_PARAM_TOL if layout == "dense" else STEP_PARAM_TOL), err_msg=k)


def test_ms_partitioned_multi_step_matches_jax(rng):
    """make_ms_partitioned_multi_step (2 stacked samples with their graphs,
    noise from fold_in keys) against JAX's scan, and against the port's
    single steps, at the JAX multi-step test's tolerances."""
    d = setup(rng)
    jstats, tstats = stats_pair()
    batch = train_batch(d, rng)
    inner, key = 2, jax.random.key(21)
    stacked = {k: np.broadcast_to(v[None], (inner,) + v.shape).copy() for k, v in batch.items()}
    tx, state = jax_state(d["params"])
    multi = jmp.make_ms_partitioned_multi_step(jax_mesh(), d["jcfg"], jstats, d["spec"], tx, inner, noise_std=1e-3)
    jgraphs = jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (inner,) + a.shape), d["jgraph"])
    j_state, jm = multi(state, {**{k: jnp.asarray(v) for k, v in stacked.items()}, "graph": jgraphs}, key)
    noise = np.stack([np.asarray(jnoise.random_walk_position_noise(jax.random.fold_in(key, np.uint32(i)),
                                                                   d["seq"].shape, 1e-3)) for i in range(inner)])
    tgraphs = jax.tree.map(lambda a: t(np.broadcast_to(a[None], (inner,) + a.shape)), tuple(d["tgraph"]))
    tgraphs = tmp.ShardedMSGraph(*(tmp.ShardedEdges(*e) for e in tgraphs))
    sim, step = port_step(d, tstats, 1e-3)
    tm = tmp.make_ms_partitioned_multi_step(step, inner)(
        {**{k: t(v) for k, v in stacked.items()}, "graph": tgraphs}, 0, noise=t(noise))
    np.testing.assert_allclose(tm["train/loss"].numpy(), np.asarray(jm["train/loss"]), rtol=STEP_LOSS_RTOL)
    want = as_port(j_state["params"])
    for k, p in sim.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), **STEP_PARAM_TOL, err_msg=k)
    single_sim, single = port_step(d, tstats, 1e-3)
    graph = tmp.sharded_graph_to(d["tgraph"], "cpu")
    for i in range(inner):
        m = single({**{k: t(v) for k, v in batch.items()}, "graph": graph}, i, noise=t(noise[i]))
        np.testing.assert_allclose(float(tm["train/loss"][i]), float(m["train/loss"]), rtol=MULTI_LOSS_RTOL)
    for k, p in sim.state_dict().items():
        np.testing.assert_allclose(p.numpy(), single_sim.state_dict()[k].numpy(), **MULTI_PARAM_TOL, err_msg=k)
    with pytest.raises(ValueError, match="3 steps"):
        tmp.make_ms_partitioned_multi_step(step, 3)({k: t(v) for k, v in stacked.items()}, 0)


# --- rollout -------------------------------------------------------------------------


def test_ms_partitioned_rollout_matches_jax(rng):
    """The partitioned rollout (one erosional particle) against JAX's; the
    captured route equals the eager loop with torch.equal, and a second
    trajectory of the same shapes replays the same captured step."""
    from sgnn_tpu_torch.physics import captured_step

    d = setup(rng)
    jstats, tstats = stats_pair()
    t_total, n, nt = 7, d["n"], d["spec"].total_nodes
    traj = np.zeros((nt, t_total, 2), np.float32)
    traj[:n] = d["grid"][d["order"]][:, None, :] + rng.normal(scale=0.003, size=(n, t_total, 2)).cumsum(axis=1)
    strains = np.zeros((t_total, nt), np.float32)
    strains[:, :n] = rng.normal(size=(t_total, n))
    types = d["types"].copy()
    types[3] = -1  # one erosional particle follows the ground truth
    args = (traj, types, strains, d["mask"])
    want = jmp.make_ms_partitioned_rollout(jax_mesh(), d["jcfg"], jstats, d["spec"])(
        d["params"], *map(jnp.asarray, args), jgraph_dev(d["jgraph"]))
    run = tmp.make_ms_partitioned_rollout(cpu_mesh(), d["tcfg"], tstats, d["tspec"])
    sim = port_sim(d["tcfg"], d["params"])
    got = run(sim, *args, d["tgraph"])
    m = d["mask"]
    np.testing.assert_allclose(got["predicted_rollout"].numpy()[:, m], np.asarray(want["predicted_rollout"])[:, m],
                               **ROLLOUT_TOL)
    for k in ("rmse_position_per_step", "rmse_strain_per_step", "rmse_position"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **RMSE_TOL, err_msg=k)
    eager = run(sim, *args, d["tgraph"], capture=False)
    for k in ("predicted_rollout", "predicted_strain"):
        assert torch.equal(got[k], eager[k]), k
    again = run(sim, traj[:, ::-1].copy(), types, strains, d["mask"], d["tgraph"])
    assert len(captured_step.steps_of(sim)) == 1 and again["predicted_rollout"].shape == got["predicted_rollout"].shape


def test_host_rollout_scatters_back_to_the_caller_order(rng):
    """make_ms_partitioned_host_rollout on a shuffled trajectory with 8
    loader padding rows equals the partitioned rollout of its sorted
    layout, scattered back to the caller's order (padding rows zero); a
    trajectory not planned up front is planned when it comes."""
    d = setup(rng)
    _, tstats = stats_pair()
    n, t_total = d["n"], 6
    perm = rng.permutation(n)
    drift = rng.normal(scale=0.003, size=(n, t_total, 2)).cumsum(axis=1)
    traj = d["grid"][perm][:, None, :] + drift - drift[:, :1]  # t = 0 on the lattice, as the plan's bar
    traj = np.concatenate([traj, np.zeros((8, t_total, 2))]).astype(np.float32)
    types, mask = np.zeros(n + 8, np.int32), np.arange(n + 8) < n
    strains = rng.normal(size=(t_total, n + 8)).astype(np.float32)
    sim = port_sim(d["tcfg"], d["params"])
    host = ttms.make_ms_partitioned_host_rollout(cpu_mesh(), d["tcfg"], tstats, d["tspec"], "autoregressive",
                                                 frames=[traj[:n, 0]])
    got = host(sim, traj, types, strains, mask, None)
    _, order, graph = tmp.plan_ms_partition(d["tcfg"].graph_config, traj[:n, 0], SHARDS,
                                            nodes_per_shard=d["tspec"].nodes_per_shard, halo=d["tspec"].halo)
    nt = d["tspec"].total_nodes
    pad = np.zeros((nt - n, t_total, 2), np.float32)
    want = tmp.make_ms_partitioned_rollout(cpu_mesh(), d["tcfg"], tstats, d["tspec"])(
        sim, np.concatenate([traj[order], pad]), np.zeros(nt, np.int32),
        np.concatenate([strains[:, order], np.zeros((t_total, nt - n), np.float32)], 1), np.arange(nt) < n, graph)
    np.testing.assert_array_equal(got["predicted_rollout"].numpy()[:, order], want["predicted_rollout"].numpy()[:, :n])
    assert not got["predicted_rollout"][:, n:].any()
    np.testing.assert_array_equal(got["rmse_position_per_step"].numpy(), want["rmse_position_per_step"].numpy())
    host(sim, traj[::-1].copy(), types[::-1].copy(), strains[:, ::-1].copy(), mask[::-1].copy(), None)


# --- the trainer ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ms_gp")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=24, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root


def tiny_config(root, **kw):
    base = dict(mode="train", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, input_sequence_length=5,
                run_name="ms_gp", pad_multiple=32, edge_pad_multiple=256, batch_size=1, noise_std=0.01,
                lr_init=LR, ntraining_steps=8, nsave_steps=4, log_every=2, seed=0, graph_parallel=2)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("ms_dense", [False, True], ids=["coo", "dense"])
def test_train_graph_parallel(tiny_env, capsys, ms_dense):
    """``train`` over 2 shards on the CPU in either layout: the plan's print,
    8 steps with finite metrics, two validations through the partitioned
    host rollout, a best checkpoint; the first step equals the partitioned
    step built by hand on the same plan."""
    run = f"ms_gp_{'dense' if ms_dense else 'coo'}"
    cfg = tiny_config(tiny_env, run_name=run, ms_dense=ms_dense)
    built = ttms.build_training(cfg, torch.device("cpu"), devices=["cpu", "cpu"])
    graph_type = tmp.ShardedDenseMSGraph if ms_dense else tmp.ShardedMSGraph
    assert isinstance(built.graphs[0], graph_type) and built.spec.num_shards == 2
    sample = next(built.epochs())
    assert sample["positions"].shape[0] == built.spec.total_nodes and isinstance(sample["graph"], graph_type)
    result = ttms.train(cfg, device="cpu", devices=["cpu", "cpu"])
    printed = capsys.readouterr().out
    assert f"ms graph-parallel: 2 shards x {built.spec.nodes_per_shard} nodes (halo {built.spec.halo})" in printed
    assert result["step"] == 8 and np.isfinite(result["lowest_eval_loss"])
    lines = [json.loads(line) for line in open(tiny_env / "models" / run / "metrics.jsonl")]
    assert len([r for r in lines if "val/loss" in r]) == 2
    assert all(np.isfinite(v) for r in lines for v in r.values())
    meta = json.load(open(tiny_env / "models" / run / "checkpoint_meta.json"))
    assert meta["path"].startswith("model-best-")


def test_train_graph_parallel_validation_matches_one_device(tiny_env):
    """The validation of a graph-parallel run (the partitioned host rollout,
    COO) scores the trajectories as the one-device rollout on the same
    weights does, within the partitioned rollout's tolerance."""
    cfg = tiny_config(tiny_env, run_name="ms_gp_val")
    built = ttms.build_training(cfg, torch.device("cpu"), devices=["cpu", "cpu"])
    loader = ttms.make_loader(cfg, built.sim_cfg, "valid")
    host = ttms.make_ms_partitioned_host_rollout(built.mesh, built.sim_cfg, built.stats, built.spec,
                                                 cfg.inference_mode,
                                                 frames=[p[0] for p, _, _ in loader.trajectories])
    one_device = ttms._rollout_fn(built.sim_cfg, built.stats, cfg.inference_mode, "cpu")
    _, gp = ttrain.evaluate_split(built.sim, loader, host, ttms.MULTI_SCALE)
    _, one = ttrain.evaluate_split(built.sim, loader, one_device, ttms.MULTI_SCALE)
    for k in ("total", "position", "strain", "one_step"):
        np.testing.assert_allclose(gp[k], one[k], **ROLLOUT_TOL, err_msg=k)


def test_ms_partition_refuses_a_wrong_mesh_or_graph():
    tcfg = tms.MultiScaleSimulatorConfig(latent_dim=8, num_message_passing_steps=1, input_sequence_length=4)
    _, tstats = stats_pair()
    spec = PartitionSpec1D(2, 64, 8)
    with pytest.raises(ValueError, match="2 shards"):
        tmp.make_ms_partitioned_forward(cpu_mesh(4), tcfg, tstats, spec)
    with pytest.raises(TypeError, match="ShardedMSGraph"):
        tmp.sharded_graph_to(tg.StaticGraph(None, None, None), "cpu")
