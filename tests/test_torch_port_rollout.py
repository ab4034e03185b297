"""Port simulator, rollout and predict entry point against the JAX package on CPU,
with JAX params carried across by state_dict_from_jax."""

import dataclasses
import importlib
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.physics import simulator as jsim
from sgnn_tpu.utils.torch_import import export_single_scale
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.loader import TrajectoryLoader
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.physics import rollout as troll
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.checkpoint import CheckpointManager, train_state
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.jax_params import state_dict_from_jax, state_dict_to_jax

# the module, not the function that sgnn_tpu.physics re-exports under its name
jroll = importlib.import_module("sgnn_tpu.physics.rollout")

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol=5e-5)  # f32 sums in another order through 2 layers
# 5 autoregressive steps: each step's error feeds the next window
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)
S, N, DIM = 6, 48, 2


def configs(ntypes=1, domain=None):
    kw = dict(dim=DIM, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=1,
              connectivity_radius=0.6, input_sequence_length=S, num_particle_types=ntypes,
              max_neighbors=12, wall_x=-2.0, domain=domain)
    return jsim.SimulatorConfig(**kw), tsim.SimulatorConfig(**kw)


def stats_pair(rng):
    v = {k: rng.uniform(0.5, 1.5, size=DIM).astype(np.float32) * s
         for k, s in (("vel_mean", 0.01), ("vel_std", 0.05), ("acc_mean", 0.001), ("acc_std", 0.01))}
    return jsim.NormStats(**{k: jnp.asarray(a) for k, a in v.items()}), tsim.NormStats(
        **{k: torch.from_numpy(a) for k, a in v.items()}
    )


def sim_pair(jcfg, tcfg, seed=0):
    params = jsim.simulator_init(jax.random.key(seed), jcfg)
    sim = tsim.simulator_init(tcfg, device="cpu")
    sim.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return params, sim


def trajectory(rng, n=N, t=S + 5):
    """A drifting jittered lattice [N, T, dim], with padding-mask and types."""
    side = int(np.ceil(np.sqrt(n)))
    base = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1)
    base = base.reshape(-1, 2)[:n] * 0.5 - 1.0
    steps = np.cumsum(rng.normal(scale=0.01, size=(t, n, 2)), axis=0)
    pos = (base[None] + steps + 0.02 * rng.normal(size=(1, n, 2))).astype(np.float32)
    return np.transpose(pos, (1, 0, 2)).copy()  # [N, T, dim]


@pytest.mark.parametrize("ntypes", [1, 3])
def test_state_dict_keys_match_reference_export(ntypes):
    jcfg, tcfg = configs(ntypes)
    params = jax.tree.map(np.asarray, jsim.simulator_init(jax.random.key(0), jcfg))
    sd = state_dict_from_jax(params)
    assert set(sd) == set(export_single_scale(params))
    assert set(sd) == set(tsim.simulator_init(tcfg, device="cpu").state_dict())
    for key, val in export_single_scale(params).items():
        np.testing.assert_array_equal(sd[key].numpy(), val)


def test_state_dict_round_trip():
    jcfg, _ = configs(3)
    params = jax.tree.map(np.asarray, jsim.simulator_init(jax.random.key(1), jcfg))
    back = state_dict_to_jax(state_dict_from_jax(params))
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_strict_load_refuses_missing_keys():
    jcfg, tcfg = configs(1)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, jsim.simulator_init(jax.random.key(0), jcfg)))
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError):
        tsim.simulator_init(tcfg, device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("domain", [None, ((-3.0, -3.0), (6.0, 6.0))])
@pytest.mark.parametrize("ntypes", [1, 3])
def test_forward_batched_matches_jax(rng, domain, ntypes):
    jcfg, tcfg = configs(ntypes, domain)
    jstats, tstats = stats_pair(rng)
    params, sim = sim_pair(jcfg, tcfg)
    b = 2
    seq = np.stack([trajectory(rng)[:, :S] for _ in range(b)])  # [B, N, S, dim]
    types = rng.integers(0, ntypes, size=(b, N)).astype(np.int32)
    mask = np.ones((b, N), bool)
    mask[1, -5:] = False
    ja, js = jsim.forward_batched(params, jcfg, jstats, jnp.asarray(seq), jnp.asarray(types), jnp.asarray(mask))
    with torch.no_grad():
        ta, ts = tsim.forward_batched(sim, tcfg, tstats, torch.from_numpy(seq),
                                      torch.from_numpy(types).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_predict_positions_flat_matches_jax(rng):
    jcfg, tcfg = configs(1, ((-3.0, -3.0), (6.0, 6.0)))
    jstats, tstats = stats_pair(rng)
    params, sim = sim_pair(jcfg, tcfg, seed=3)
    seq = trajectory(rng)[:, :S]
    types = np.zeros(N, np.int32)
    jp, jst = jsim.predict_positions_flat(params, jcfg, jstats, jnp.asarray(seq), jnp.asarray(types))
    with torch.no_grad():
        tp, tst = tsim.predict_positions_flat(sim, tcfg, tstats, torch.from_numpy(seq), torch.from_numpy(types).long())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("mode", ["autoregressive", "one_step"])
def test_rollout_matches_jax(rng, mode):
    jcfg, tcfg = configs(1, ((-3.0, -3.0), (6.0, 6.0)))
    jstats, tstats = stats_pair(rng)
    params, sim = sim_pair(jcfg, tcfg, seed=4)
    pos = trajectory(rng)  # [N, S+5, dim]: 5 rollout steps
    types = np.zeros(N, np.int32)
    types[:3] = troll.EROSIONAL_PARTICLE_ID  # follow the ground truth
    strains = rng.normal(size=(pos.shape[1], N)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[-4:] = False
    want = jroll.rollout(params, jcfg, jstats, jnp.asarray(pos), jnp.asarray(types),
                         jnp.asarray(strains), jnp.asarray(mask), inference_mode=mode)
    got = troll.rollout(sim, tcfg, tstats, pos, types, strains, mask, inference_mode=mode, device="cpu")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **ROLLOUT_TOL)
    assert got["predicted_rollout"].shape == (5, N, DIM)
    np.testing.assert_array_equal(got["predicted_rollout"][:, :3].numpy(), pos[:3, S:].transpose(1, 0, 2))


def test_rmse_metrics_match_jax(rng):
    pred = rng.normal(size=(6, 10, 2)).astype(np.float32)
    gt = rng.normal(size=(6, 10, 2)).astype(np.float32)
    mask = rng.random(10) > 0.3
    for jf, tf in ((jroll.cumulative_rmse, troll.cumulative_rmse), (jroll.per_step_rmse, troll.per_step_rmse)):
        for m in (None, mask):
            want = jf(jnp.asarray(pred), jnp.asarray(gt), None if m is None else jnp.asarray(m))
            got = tf(torch.from_numpy(pred), torch.from_numpy(gt), None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# --- predict / CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_tiny")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root


def tiny_config(root, **kw):
    base = dict(mode="rollout", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, input_sequence_length=6,
                run_name="t", pad_multiple=32, model_file="model-best-000000")
    base.update(kw)
    return TrainConfig(**base)


def _save_random_model(root, cfg):
    md = ttrain.load_metadata(root / "data")
    sim = tsim.simulator_init(ttrain.simulator_config_from(cfg, md),
                              generator=torch.Generator().manual_seed(0), device="cpu")
    CheckpointManager(root / "models" / cfg.run_name).save_best(train_state(sim), 0, float("inf"))
    return sim


def test_predict_end_to_end_on_cpu(tiny_data):
    cfg = tiny_config(tiny_data)
    sim = _save_random_model(tiny_data, cfg)
    summary = ttrain.predict(cfg, device="cpu")
    assert np.isfinite(summary["total"])
    pkls = list((tiny_data / "rollouts" / "t").glob("*.pkl"))
    assert len(pkls) == 1  # one test trajectory
    with open(pkls[0], "rb") as f:
        out = pickle.load(f)
    for key in ["initial_positions", "initial_strains", "predicted_rollout", "ground_truth_rollout",
                "predicted_strain", "ground_truth_strain", "particle_types", "rmse_position",
                "rmse_strain", "run_time", "metadata", "case_name", "inference_mode"]:
        assert key in out, key
    assert np.isfinite(out["predicted_rollout"]).all()
    # the pickle is the rollout of the saved weights
    traj = next(iter(TrajectoryLoader(tiny_data / "data" / "test.npz", pad_multiple=32)))
    md = ttrain.load_metadata(tiny_data / "data")
    sim_cfg = ttrain.simulator_config_from(cfg, md)
    again = troll.rollout(sim, sim_cfg, tsim.make_norm_stats(md, cfg.noise_std), traj["positions"],
                          traj["particle_type"], traj["strains"], traj["node_mask"], device="cpu")
    np.testing.assert_array_equal(out["predicted_rollout"], again["predicted_rollout"].numpy())


def test_simulator_config_from_metadata(tiny_data):
    cfg = tiny_config(tiny_data)
    md = ttrain.load_metadata(tiny_data / "data")
    sc = ttrain.simulator_config_from(cfg, md)
    assert sc.slots == 8 and sc.num_mlp_layers == 1  # max_degree + 2 rounded up to 8
    lo, hi = np.array(sc.domain[0]), np.array(sc.domain[1])
    assert (lo < np.array(md["pos_min"])).all() and (hi > np.array(md["pos_max"])).all()
    assert ttrain.simulator_config_from(dataclasses.replace(cfg, neighbor_slots=11), md).slots == 11


def test_main_cli(tiny_data, tmp_path):
    cfg = tiny_config(tiny_data, run_name="cli")
    _save_random_model(tiny_data, cfg)
    yml = tmp_path / "tiny.yaml"
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    yml.write_text("".join(f"{k}: {v!r}\n" if isinstance(v, str) else f"{k}: {'null' if v is None else v}\n"
                           for k, v in fields.items() if k in ("data_path", "model_path", "output_path",
                                                               "layers", "hidden_dim", "input_sequence_length",
                                                               "run_name", "pad_multiple")))
    summary = ttrain.main(["--config", str(yml), "--mode", "valid", "--model_file", "model-best-000000",
                           "--device", "cpu"])
    assert np.isfinite(summary["total"])
    # --mode train trains the tiny config on the CPU
    yml.write_text(yml.read_text() + "ntraining_steps: 4\nnsave_steps: 2\nlog_every: 2\nbatch_size: 2\n")
    result = ttrain.main(["--config", str(yml), "--mode", "train", "--device", "cpu"])
    assert result["step"] == 4 and np.isfinite(result["lowest_eval_loss"])
