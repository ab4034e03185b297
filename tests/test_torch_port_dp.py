"""The port's data-parallel training against JAX's on the CPU.

One data-parallel step of each family (``parallel/data_parallel.
DataParallelStep`` over two replicas of a CPU mesh) against JAX's DP step
(``make_dp_train_step`` on the 8-device host mesh) from the same parameters,
batch and noise (JAX's draws injected), and against the port's own
single-device step (tests/test_train.py:100,
tests/test_train_multi_scale.py:94-142): the replicas' masked counts differ,
so a mean of per-replica means would fail. Then the mesh helpers, the
multi-step, bit-reproducibility, and ``train`` with ``data_parallel: 2``.
A mesh of ``cpu`` and ``cpu:0`` counts as two devices: the second replica
runs on a copy of the model, whose gradients are folded onto the first's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sgnn_tpu.parallel import make_dp_train_step as jmake_dp_train_step
from sgnn_tpu.parallel import make_mesh as jmake_mesh
from sgnn_tpu.physics import noise as jnoise
from sgnn_tpu.physics import simulator as jsim
from sgnn_tpu.train import config as jconfig
from sgnn_tpu.train import train as jtrain
from sgnn_tpu_torch.parallel import data_parallel as tdp
from sgnn_tpu_torch.parallel import mesh as tmesh
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train import train_multi_scale as ttms
from sgnn_tpu_torch.utils.jax_params import state_dict_from_jax

import test_torch_port_ms_train as msh
import test_torch_port_train as ssh
from test_torch_port_ms_train import tiny  # noqa: F401 (the multi-scale dataset fixture)
from test_torch_port_train import tiny_env  # noqa: F401 (the single-scale dataset fixture)

torch.set_num_threads(1)

MESHES = {"one_device": ["cpu", "cpu"], "two_devices": ["cpu", "cpu:0"]}
# one DP step against the single-device step of the same package: the two
# replicas' sums added in another order (the JAX test's 1e-5 on the loss)
SINGLE_LOSS_RTOL = 1e-5


def _batch(rng, b=4):
    """b graphs of ssh.N particles; the second replica's graphs mask 4 and 7
    nodes, the first's none: the replicas' masked counts differ."""
    base = ssh.make_batch(rng)
    reps = -(-b // ssh.B)
    out = {k: np.concatenate([v] * reps)[:b].copy() for k, v in base.items()}
    out["positions"] = out["positions"] + rng.normal(scale=1e-3, size=out["positions"].shape).astype(np.float32)
    out["node_mask"][:] = True
    out["node_mask"][b // 2, -4:] = False
    out["node_mask"][b - 1, -7:] = False
    return out


def _assert_step(tm, tgrads, after, before, want_m, want_g, want_p, loss_tol):
    """The rules of tests/test_torch_port_train.py::test_training_step_matches_jax."""
    assert set(tm) == set(want_m)
    for name in want_m:
        np.testing.assert_allclose(tm[name], want_m[name], err_msg=name, **loss_tol)
    for name, wg in want_g.items():
        g = tgrads[name]
        atol = ssh.GRAD_ATOL_REL * float(wg.abs().max())
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=ssh.GRAD_RTOL, atol=atol, err_msg=name)
        either_way = (wg.abs() <= atol + ssh.GRAD_RTOL * wg.abs()).numpy()
        err = ((after[name] - want_p[name]).abs() - ssh.PARAM_RTOL * want_p[name].abs()).numpy()
        assert (err[~either_way] <= ssh.PARAM_ATOL).all(), f"{name}: max |err| {err[~either_way].max():.3e}"
        assert (err <= 2 * ssh.LR + ssh.PARAM_ATOL).all(), name
        assert (after[name] != before[name]).any(), f"{name} did not move"


def _port_dp(tcfg, tstats, cfg, params, devices):
    sim = tsim.simulator_init(tcfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    opt = ttrain.make_optimizer(sim, cfg)
    mesh = tmesh.make_mesh(data=2, devices=devices)
    step = tdp.DataParallelStep(lambda m, d: ttrain.make_loss_fn(m, tcfg, tstats.to(d), cfg), sim, mesh, opt,
                                ttrain.lr_schedule(cfg), cfg.noise_std)
    return sim, opt, step


@pytest.mark.parametrize("devices", MESHES.values(), ids=MESHES.keys())
def test_dp_step_matches_jax_and_one_device(rng, devices):
    jcfg, tcfg = ssh.configs()
    jstats, tstats = ssh.stats_pair(rng)
    cfg = dataclasses.replace(ssh.train_cfg(), batch_size=4, data_parallel=2)
    params = jsim.simulator_init(jax.random.key(0), jcfg)
    batch = _batch(rng)
    key = jax.random.key(5)
    noise = torch.from_numpy(np.array(jnoise.random_walk_position_noise(key, batch["positions"].shape,
                                                                        cfg.noise_std)))
    # JAX: make_dp_train_step over a 2-device data mesh, once with Adam, once
    # with a transformation that keeps the gradients
    jcfg_train = jconfig.TrainConfig(**{f: getattr(cfg, f) for f in (
        "batch_size", "noise_std", "input_sequence_length", "hidden_dim", "layers",
        "lr_init", "lr_decay", "lr_decay_steps")})
    out = {}
    for name, tx in (("grads", ssh._capture_grads()), ("adam", optax.adam(jtrain.lr_schedule(jcfg_train)))):
        state = {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}
        step = jmake_dp_train_step(jtrain.make_train_step(jcfg, jstats, jcfg_train, tx), jmake_mesh(data=2))
        out[name] = step(state, batch, key)
    want_m = {k: float(v) for k, v in out["adam"][1].items()}
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, out["grads"][0]["opt_state"]["g"]))
    want_p = state_dict_from_jax(jax.tree.map(np.asarray, out["adam"][0]["params"]))

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    sim, _, step = _port_dp(tcfg, tstats, cfg, params, devices)
    before = {k: v.clone() for k, v in sim.state_dict().items()}
    tm = {k: float(v) for k, v in step(tbatch, 0, noise=noise).items()}
    tgrads = {k: p.grad.clone() for k, p in sim.named_parameters()}
    _assert_step(tm, tgrads, sim.state_dict(), before, want_m, want_g, want_p, ssh.LOSS_TOL)

    # the port's single-device step on the same batch and noise
    one = tsim.simulator_init(tcfg, device="cpu")
    one.load_state_dict(before, strict=True)
    single = ttrain.make_train_step(one, tcfg, tstats, cfg, ttrain.make_optimizer(one, cfg))
    sm = {k: float(v) for k, v in single(tbatch, 0, noise=noise).items()}
    for name in sm:
        np.testing.assert_allclose(tm[name], sm[name], rtol=SINGLE_LOSS_RTOL, err_msg=name)
    for name, p in one.named_parameters():
        np.testing.assert_allclose(tgrads[name].numpy(), p.grad.numpy(), rtol=ssh.GRAD_RTOL,
                                   atol=ssh.GRAD_ATOL_REL * float(p.grad.abs().max()), err_msg=name)


@pytest.mark.parametrize("ms_dense", [True, False], ids=["dense", "coo"])
def test_ms_dp_step_matches_jax_and_one_device(tiny, rng, ms_dense):  # noqa: F811
    """Multi-scale: each replica flattens its own samples' static graphs."""
    cfg = msh.tiny_config(tiny, ms_dense=ms_dense, batch_size=4, data_parallel=2)
    jsim_cfg, tsim_cfg, params, sim = msh.model_pair(cfg, seed=2)
    jstats, tstats = msh.stats_pair(rng)
    batch, jbatch = (next(b.epochs()) for b in msh.batchers(cfg))
    for b in (batch, jbatch):  # the replicas' masked counts differ
        b["node_mask"] = b["node_mask"].copy()
        b["node_mask"][3, :5] = False
    key = jax.random.key(7)
    noise = torch.from_numpy(np.array(jnoise.random_walk_position_noise(key, batch["positions"].shape,
                                                                        cfg.noise_std)))
    out = {}
    for name, tx in (("grads", msh._capture_grads()), ("adam", optax.adam(msh.jtms.lr_schedule(msh.jax_cfg(cfg))))):
        state = {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}
        step = jmake_dp_train_step(msh.jtms.make_train_step(jsim_cfg, jstats, msh.jax_cfg(cfg), tx),
                                   jmake_mesh(data=2))
        out[name] = step(state, jbatch, key)
    want_m = {k: float(v) for k, v in out["adam"][1].items()}
    want_g = msh.ms_state_dict_from_jax(jax.tree.map(np.asarray, out["grads"][0]["opt_state"]["g"]))
    want_p = msh.ms_state_dict_from_jax(jax.tree.map(np.asarray, out["adam"][0]["params"]))

    before = {k: v.clone() for k, v in sim.state_dict().items()}
    mesh = tmesh.make_mesh(data=2, devices=["cpu", "cpu"])
    step = tdp.DataParallelStep(lambda m, d: ttms.make_loss_fn(m, tsim_cfg, tstats.to(d), cfg), sim, mesh,
                                ttrain.make_optimizer(sim, cfg), ttrain.lr_schedule(cfg), cfg.noise_std)
    tbatch = msh.torch_batch(batch)
    tm = {k: float(v) for k, v in step(tbatch, 0, noise=noise).items()}
    tgrads = {k: p.grad.clone() for k, p in sim.named_parameters()}
    _assert_step(tm, tgrads, sim.state_dict(), before, want_m, want_g, want_p, msh.LOSS_TOL)

    one = msh.model_pair(cfg, seed=2)[3]
    single = ttms.make_train_step(one, tsim_cfg, tstats, cfg, ttrain.make_optimizer(one, cfg))
    sm = {k: float(v) for k, v in single(tbatch, 0, noise=noise).items()}
    for name in sm:
        np.testing.assert_allclose(tm[name], sm[name], rtol=SINGLE_LOSS_RTOL, err_msg=name)
    # the mean of the replicas' own means is another number here
    halves = [b["node_mask"].sum() for b in tmesh.split_tree({"node_mask": tbatch["node_mask"]}, 2)]
    assert halves[0] != halves[1]


def test_mesh_and_placement(monkeypatch):
    mesh = tmesh.make_mesh(data=2, graph=3, devices=["cpu"] * 6 + ["meta"])
    assert mesh.shape == (2, 3) and mesh.one_device and mesh.primary == torch.device("cpu")
    assert mesh.data_devices == [torch.device("cpu")] * 2 and len(mesh.graph_devices) == 3
    assert not tmesh.make_mesh(data=2, devices=["cpu", "cpu:0"]).one_device
    with pytest.raises(ValueError, match="need 4 devices"):
        tmesh.make_mesh(data=2, graph=2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 2 CUDA devices, have 0"):
        tmesh.make_mesh(data=2)  # never the CPU by default
    x = torch.arange(24.0).reshape(4, 3, 2)
    parts = tmesh.shard_batch(mesh, {"x": x, "g": (x[:, 0], None)})
    assert [p["x"].tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
    assert parts[1]["g"][1] is None and torch.equal(parts[1]["g"][0], x[2:, 0])
    y = x.reshape(3, 4, 2)  # [T, B, ...]: the batch axis is 1
    assert torch.equal(tmesh.shard_stacked_batch(mesh, {"y": y})[1]["y"], y[:, 2:])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(tmesh.make_mesh(data=3, devices=["cpu"] * 3), {"x": x})


def test_replicas_copy_sync_and_fold():
    sim = torch.nn.Linear(3, 2)
    reps = tmesh.Replicas(sim, [torch.device("cpu"), torch.device("cpu", 0), torch.device("cpu", 0)])
    assert reps.modules[0] is sim and reps.modules[1] is reps.modules[2] is reps.copies[0]
    with torch.no_grad():
        sim.weight.add_(1.0)
    reps.sync()
    assert torch.equal(reps.copies[0].weight, sim.weight)
    x = torch.randn(5, 3)
    sim(x).sum().backward()
    g0 = sim.weight.grad.clone()
    reps.copies[0](2 * x).sum().backward()
    g1 = reps.copies[0].weight.grad.clone()
    reps.fold(reps.copies[0])
    assert torch.equal(sim.weight.grad, g0 + g1)
    assert reps.copies[0].weight.grad is None
    reps.fold(sim)  # the primary itself: nothing to fold


def _dp_run(tiny_env, devices, steps=3, seed=0):  # noqa: F811
    root, data = tiny_env
    cfg = ssh.tiny_config(root, data, batch_size=4, data_parallel=2, seed=seed)
    built = ttrain.build_training(cfg, torch.device("cpu"), devices=devices)
    source = built.epochs()
    metrics = [{k: v.clone() for k, v in built.step_fn(ttrain.batch_to_device(next(source), "cpu"), i).items()}
               for i in range(steps)]
    return metrics, {k: v.clone() for k, v in built.sim.state_dict().items()}, built


def test_dp_runs_repeat_bit_for_bit(tiny_env):  # noqa: F811
    """Two runs on one device equal each other, and the run whose second
    replica runs on a copy (gradients folded in replica order) equals them:
    the same sums in the same order."""
    runs = [_dp_run(tiny_env, d)[:2] for d in (MESHES["one_device"], MESHES["one_device"], MESHES["two_devices"])]
    for metrics, params in runs[1:]:
        assert all(torch.equal(a[k], b[k]) for a, b in zip(metrics, runs[0][0]) for k in a)
        assert all(torch.equal(v, runs[0][1][k]) for k, v in params.items())


def test_dp_multi_step_equals_single_steps(tiny_env):  # noqa: F811
    root, data = tiny_env
    cfg = ssh.tiny_config(root, data, batch_size=4, data_parallel=2)
    first = ttrain.build_training(cfg, torch.device("cpu"), devices=MESHES["one_device"])
    source = first.epochs()
    batches = [ttrain.batch_to_device(next(source), "cpu") for _ in range(3)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    multi = tdp.make_dp_train_multi_step(first.step_fn)(stacked, 0)
    second = ttrain.build_training(cfg, torch.device("cpu"), devices=MESHES["one_device"])
    single = [{k: v.clone() for k, v in second.step_fn(b, i).items()} for i, b in enumerate(batches)]
    for k in multi:
        assert torch.equal(multi[k], torch.stack([m[k] for m in single])), k
    assert all(torch.equal(v, second.sim.state_dict()[k]) for k, v in first.sim.state_dict().items())


def test_train_data_parallel_both_families(tiny_env, tiny):  # noqa: F811
    root, data = tiny_env
    cfg = ssh.tiny_config(root, data, ntraining_steps=6, nsave_steps=6, log_every=3, batch_size=4,
                          data_parallel=2, run_name="dp")
    result = ttrain.train(cfg, device="cpu", devices=MESHES["two_devices"])
    assert result["step"] == 6 and np.isfinite(result["lowest_eval_loss"])
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.train(dataclasses.replace(cfg, batch_size=3), device="cpu", devices=MESHES["one_device"])
    ms_cfg = msh.tiny_config(tiny, ntraining_steps=4, nsave_steps=4, log_every=2, batch_size=2, data_parallel=2,
                             run_name="msdp")
    result = ttms.train(ms_cfg, device="cpu", devices=MESHES["one_device"])
    assert result["step"] == 4 and np.isfinite(result["lowest_eval_loss"])
    meta = json.load(open(tiny / "models" / "msdp" / "checkpoint_meta.json"))
    assert np.isfinite(ttms.predict(dataclasses.replace(ms_cfg, mode="valid", model_file=meta["path"]),
                                    device="cpu")["total"])  # a rollout ignores data_parallel, as JAX's
