"""The port's multi-scale serving slice against the JAX package on CPU:
graph hierarchy and layouts, weights, COO and dense forwards (f32 and
bf16), the golden ``ms/*`` fixture, ``ms_rollout`` and ``predict``.

JAX params are carried across by ``ms_state_dict_from_jax``; inputs come
from numpy seeds and are handed to both packages.
"""

import dataclasses
import importlib
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.data import static_graph_loader as jloader
from sgnn_tpu.ops import segment as jseg
from sgnn_tpu.physics import multi_scale_graph as jg
from sgnn_tpu.physics import multi_scale_simulator as jms
from sgnn_tpu.physics.simulator import NormStats as JNormStats
from sgnn_tpu.train import config as jconfig
from sgnn_tpu.utils.torch_import import export_multi_scale
from sgnn_tpu_torch.data import static_graph_loader as tloader
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.loader import load_trajectories
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.ops import row_gather as rg
from sgnn_tpu_torch.physics import multi_scale_graph as tg
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics.simulator import NormStats as TNormStats
from sgnn_tpu_torch.train import multi_scale_inference as tinfer
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train import train_multi_scale as ttms
from sgnn_tpu_torch.train.checkpoint import CheckpointManager
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.jax_params import ms_state_dict_from_jax, ms_state_dict_to_jax

# the modules, not what the packages re-export under their names
jtms = importlib.import_module("sgnn_tpu.train.train_multi_scale")

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
S, DIM = 5, 2
# f32: the JAX tests' own tolerance for the two layouts (sums in another order)
TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 edge tensors: where the two sides' f32 sums straddle a bf16 rounding
# boundary an edge entry rounds one bf16 step (2^-8 relative) apart, and the
# node updates carry that on; one bf16 step of the outputs' scale
BF16_TOL = dict(rtol=2.0**-8, atol=2.0**-8)
# a few autoregressive steps: each step's error feeds the next window
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)


def bar_grid(nx, ny, spacing=0.5, jitter=0.0, seed=0):
    xs, ys = np.meshgrid(np.arange(nx) * spacing, np.arange(ny) * spacing, indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], -1)
    return grid + np.random.default_rng(seed).normal(scale=jitter, size=grid.shape)


GRIDS = {"square8": bar_grid(8, 8), "bar9x4": bar_grid(9, 4), "jittered12x5": bar_grid(12, 5, jitter=0.01)}


def configs(ntypes=1, compute_dtype="float32", num_scales=2):
    kw = dict(dim=DIM, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=2, input_sequence_length=S,
              num_particle_types=ntypes, num_scales=num_scales, window_size=2, compute_dtype=compute_dtype)
    return jms.MultiScaleSimulatorConfig(**kw), tms.MultiScaleSimulatorConfig(**kw)


def sim_pair(jcfg, tcfg, seed=0):
    params = jax.tree.map(np.asarray, jms.multi_scale_simulator_init(jax.random.key(seed), jcfg))
    sim = tms.multi_scale_simulator_init(tcfg, device="cpu")
    sim.load_state_dict(ms_state_dict_from_jax(params), strict=True)
    return params, sim


def stats_pair(rng):
    v = {k: rng.uniform(0.5, 1.5, size=DIM).astype(np.float32) * s
         for k, s in (("vel_mean", 0.01), ("vel_std", 0.05), ("acc_mean", 0.001), ("acc_std", 0.01))}
    return (JNormStats(**{k: jnp.asarray(a) for k, a in v.items()}),
            TNormStats(**{k: torch.from_numpy(a) for k, a in v.items()}))


def graphs(jcfg, tcfg, grid, layout):
    """The same graph built by each package: (JAX's as jnp, the port's as tensors)."""
    n = len(grid)
    if layout == "dense":
        kw = dict(g2m_rows=32, m2m_rows=32, m2g_rows=n, tsp_rows={"g2m": n, "m2m": 32, "m2g": 32},
                  tsp_slots={"g2m": 8, "m2m": 24, "m2g": 24})
        jgr, tgr = (m.build_dense_static_graph(c.graph_config, grid, **kw) for m, c in ((jg, jcfg), (tg, tcfg)))
    else:
        kw = dict(g2m_pad=512, m2m_pad=256, m2g_pad=512)
        jgr, tgr = (m.build_static_graph(c.graph_config, grid, **kw) for m, c in ((jg, jcfg), (tg, tcfg)))
    return jax.tree.map(jnp.asarray, jgr), tms.graph_to(tgr, torch.device("cpu"))


def sequence(rng, grid, t=S):
    drift = rng.normal(scale=0.01, size=(len(grid), t, DIM)).cumsum(axis=1)
    return (grid[:, None, :] + drift).astype(np.float32)


def assert_same_arrays(a, b, where=""):
    """Two graph pytrees (NamedTuples / tuples / lists / dicts of arrays) equal, exactly."""
    if isinstance(a, (tuple, list)):
        if type(a).__name__ == "PaddedEdges" and len(a) == len(b) + 1:
            # the port's own field, the sender order its deterministic sender
            # backward reads (JAX's scatters): the stable sort of the senders,
            # padding last, computed here from JAX's arrays
            np.testing.assert_array_equal(np.asarray(a.order), tg.sender_order(np.asarray(b.senders),
                                                                               np.asarray(b.mask)),
                                          err_msg=f"{where}.order")
            a, b = tuple(a[:-1]), tuple(b)
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_arrays(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same_arrays(a[k], b[k], f"{where}.{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=where)


# --- graph -------------------------------------------------------------------------


@pytest.mark.parametrize("num_scales", [2, 3])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_create_all_edges_matches_jax(grid, num_scales):
    kw = dict(num_scales=num_scales, window_size=2)
    want = jg.create_all_edges(jg.MultiScaleConfig(**kw), GRIDS[grid])
    got = tg.create_all_edges(tg.MultiScaleConfig(**kw), GRIDS[grid])
    assert_same_arrays(got, want)
    assert len(got["grid2mesh_edges"].senders) > 0 and len(got["mesh2mesh_edges"].senders) > 0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_pad_and_dense_edges_match_jax(grid):
    cfg = dict(num_scales=2, window_size=2)
    out = tg.create_all_edges(tg.MultiScaleConfig(**cfg), GRIDS[grid])
    n = len(GRIDS[grid])
    for key in ("grid2mesh_edges", "mesh2mesh_edges", "mesh2grid_edges"):
        e = out[key]
        assert_same_arrays(tg.pad_edges(e, 1024), jg.pad_edges(jg.CooEdges(*e), 1024), key)
        for kw in ({}, dict(tsp_rows_pad=n + 8, tsp_slots=28), dict(num_sender_nodes=n + 5)):
            assert_same_arrays(tg.dense_edges(e, n, 64, 24, **kw), jg.dense_edges(jg.CooEdges(*e), n, 64, 24, **kw),
                               f"{key} {kw}")
    with pytest.raises(ValueError, match="pad size"):
        tg.pad_edges(out["grid2mesh_edges"], 4)
    with pytest.raises(ValueError, match="slot count"):
        tg.dense_edges(out["mesh2grid_edges"], n, 64, 1)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """A synthetic Taylor-impact dataset: 2 validation and 1 test trajectory
    of 12 x 5 particles over 20 frames."""
    root = tmp_path_factory.mktemp("port_ms_tiny")
    generate_synthetic_raw_dataset(root / "raw", num_sims=4, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110", "-120"], test_patterns=["-130"], boundary_particles_to_remove=2).build()
    return root


@pytest.mark.parametrize("dense", [False, True, "auto"])
def test_build_graphs_matches_jax(tiny_data, dense, capsys):
    trajs = load_trajectories(tiny_data / "data" / "valid.npz")
    assert len(trajs) == 2
    kw = dict(dense=dense, num_nodes=64, m2m_traversals=2, dense_row_advantage=2.0)
    want = jloader._build_graphs(trajs, jg.MultiScaleConfig(num_scales=2, window_size=2), 256, **kw)
    jax_line = capsys.readouterr().out
    got = tloader._build_graphs(trajs, tg.MultiScaleConfig(num_scales=2, window_size=2), 256, **kw)
    assert capsys.readouterr().out == jax_line
    assert_same_arrays(got, want)
    if dense == "auto":
        assert jax_line.startswith("ms layout auto: ")


def test_static_graph_builders_match_jax():
    grid = GRIDS["jittered12x5"]
    kw = dict(g2m_pad=512, m2m_pad=256, m2g_pad=512)
    assert_same_arrays(tg.build_static_graph(tg.MultiScaleConfig(num_scales=2, window_size=2), grid, **kw),
                       jg.build_static_graph(jg.MultiScaleConfig(num_scales=2, window_size=2), grid, **kw))
    kw = dict(g2m_rows=32, m2m_rows=[24, 16], m2g_rows=64, m2m_slots=[24, 20])
    assert_same_arrays(tg.build_dense_static_graph(tg.MultiScaleConfig(num_scales=3, window_size=2), grid, **kw),
                       jg.build_dense_static_graph(jg.MultiScaleConfig(num_scales=3, window_size=2), grid, **kw))


def test_segment_sum_matches_jax(rng):
    """The COO aggregation (``sorted_sum`` over receiver-sorted ids, what
    replaced ``index_add_``) against JAX's ``coo_segment_sum`` (masked)
    and ``segment_sum``; its gradient is the cotangent's rows gathered."""
    data = rng.normal(size=(50, 4)).astype(np.float32)
    ids = np.sort(rng.integers(0, 7, 50)).astype(np.int32)
    mask = rng.random(50) > 0.3
    # the port's callers zero padded entries before the sum (JAX's mask)
    want = jseg.coo_segment_sum(jnp.asarray(data), jnp.asarray(ids), 9, mask=jnp.asarray(mask))
    got = rg.sorted_sum(torch.from_numpy(data * mask[:, None]), torch.from_numpy(ids), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(data).requires_grad_(True)
    got = rg.sorted_sum(t, torch.from_numpy(ids).long(), 9)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 9)),
                               rtol=1e-6, atol=1e-6)
    cot = rng.normal(size=(9, 4)).astype(np.float32)
    (grad,) = torch.autograd.grad(got, t, torch.from_numpy(cot))
    assert torch.equal(grad, torch.from_numpy(cot[ids]))


@pytest.mark.parametrize("ntypes", [1, 3])
def test_ms_state_dict_matches_reference_export(ntypes):
    jcfg, tcfg = configs(ntypes)
    params = jax.tree.map(np.asarray, jms.multi_scale_simulator_init(jax.random.key(0), jcfg))
    sd = ms_state_dict_from_jax(params)
    export = export_multi_scale(params)
    assert set(sd) == set(export)
    assert set(sd) == set(tms.multi_scale_simulator_init(tcfg, device="cpu").state_dict())
    for key, val in export.items():
        np.testing.assert_array_equal(sd[key].numpy(), val)
    tms.multi_scale_simulator_init(tcfg, device="cpu").load_state_dict(sd, strict=True)
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError):
        tms.multi_scale_simulator_init(tcfg, device="cpu").load_state_dict(sd, strict=True)


def test_ms_state_dict_round_trip():
    jcfg, _ = configs(3)
    params = jax.tree.map(np.asarray, jms.multi_scale_simulator_init(jax.random.key(1), jcfg))
    back = ms_state_dict_to_jax(ms_state_dict_from_jax(params))
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


# --- forward -----------------------------------------------------------------------


@pytest.mark.parametrize("ntypes", [1, 3])
@pytest.mark.parametrize("layout", ["coo", "dense"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(rng, layout, ntypes, compute_dtype):
    jcfg, tcfg = configs(ntypes, compute_dtype)
    jstats, tstats = stats_pair(rng)
    params, sim = sim_pair(jcfg, tcfg)
    grid = GRIDS["jittered12x5"]
    jgr, tgr = graphs(jcfg, tcfg, grid, layout)
    seq = sequence(rng, grid)
    types = rng.integers(0, ntypes, len(grid)).astype(np.int32)
    launches = rg.LAUNCHES.copy()
    ja, js = jms._forward(params, jcfg, jstats, jnp.asarray(seq), jnp.asarray(types), jgr)
    with torch.no_grad():
        ta, ts = tms._forward(sim, tcfg, tstats, torch.from_numpy(seq), torch.from_numpy(types).long(), tgr)
    tol = TOL if compute_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **tol)
    assert rg.LAUNCHES == launches  # CPU tensors take the plain version


def test_forward_gathers_latent_rows_through_row_gather(rng, monkeypatch):
    """Every latent-row gather of both layouts is a row_gather call: 2 per
    block, and per m2m scale in the dense layout."""
    jcfg, tcfg = configs(num_scales=3)
    _, sim = sim_pair(jcfg, tcfg)
    grid = GRIDS["jittered12x5"]
    calls = []
    gather = rg.row_gather  # the forward of every gather Function of the model

    monkeypatch.setattr(rg, "row_gather", lambda t, i: calls.append(t.shape[1]) or gather(t, i))
    stats = TNormStats(torch.zeros(2), torch.ones(2), torch.zeros(2), torch.ones(2))
    seq = torch.from_numpy(sequence(rng, grid))
    for layout, per_step in (("coo", 2 * (2 + 2)), ("dense", 2 * (2 + 2 * 2))):
        calls.clear()
        if layout == "coo":
            graph = tg.build_static_graph(tcfg.graph_config, grid, g2m_pad=512, m2m_pad=512, m2g_pad=512)
        else:
            graph = tg.build_dense_static_graph(tcfg.graph_config, grid, g2m_rows=32, m2m_rows=32, m2g_rows=64)
        with torch.no_grad():
            tms._forward(sim, tcfg, stats, seq, torch.zeros(len(grid), dtype=torch.long),
                         tms.graph_to(graph, torch.device("cpu")))
        assert calls == [16] * per_step, layout


def test_golden_fixture(rng):
    """The ``ms/*`` part of golden_sim.npz (numpy features and the torch
    multi-scale oracle) through both layouts, as tests/test_golden_parity.py
    holds JAX: node features to 2e-5, outputs to rtol 5e-4, atol 5e-5."""
    with np.load(FIXTURES / "golden_sim.npz") as z:
        fix = {k: z[k] for k in z.files}
    mn, ms_d, ms_steps, ms_nlayers = (int(v) for v in fix["ms/meta"])
    tcfg = tms.MultiScaleSimulatorConfig(dim=2, latent_dim=ms_d, num_message_passing_steps=ms_steps,
                                         num_mlp_layers=ms_nlayers, input_sequence_length=int(fix["ss/meta"][1]),
                                         num_scales=2, window_size=2, radius_multiplier=2.0)
    stats = TNormStats(*(torch.from_numpy(fix[f"ss/{k}"]) for k in ("vel_mean", "vel_std", "acc_mean", "acc_std")))
    params = {}
    for key, val in fix.items():
        if key.startswith("ms/param/"):
            node = params
            parts = key[len("ms/param/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    sim = tms.multi_scale_simulator_init(tcfg, device="cpu")
    sim.load_state_dict(ms_state_dict_from_jax({"gnn": listify(params)}), strict=True)
    coo = tg.StaticGraph(*(tg.PaddedEdges(fix[f"ms/{t}_senders"], fix[f"ms/{t}_receivers"], fix[f"ms/{t}_mask"])
                           for t in ("g2m", "m2m", "m2g")))
    dense = tg.build_dense_static_graph(tcfg.graph_config, fix["ms/grid"], g2m_rows=64, m2m_rows=32, m2g_rows=64)
    seq = torch.from_numpy(fix["ms/seq"])
    types = torch.zeros(mn, dtype=torch.long)
    golden = fix["ms/golden_out"]
    for graph in (coo, dense):
        g = tms.graph_to(graph, torch.device("cpu"))
        with torch.no_grad():
            nf, _ = tms.ms_encoder_preprocess(sim, tcfg, stats, seq, types, g)
            acc, strain = tms._forward(sim, tcfg, stats, seq, types, g)
        np.testing.assert_allclose(nf.numpy(), fix["ms/node_feat"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(acc.numpy(), golden[:, :2], rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(strain.numpy(), golden[:, -1], rtol=5e-4, atol=5e-5)


# --- rollout -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["autoregressive", "one_step"])
@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_ms_rollout_matches_jax(rng, layout, mode):
    jcfg, tcfg = configs()
    jstats, tstats = stats_pair(rng)
    params, sim = sim_pair(jcfg, tcfg, seed=2)
    grid = GRIDS["jittered12x5"]
    n = len(grid)
    jgr, tgr = graphs(jcfg, tcfg, grid, layout)
    pos = sequence(rng, grid, t=S + 4)  # [N, S+4, dim]: 4 rollout steps
    types = np.zeros(n, np.int32)
    types[:3] = -1  # erosional: follow the ground truth
    strains = rng.normal(size=(S + 4, n)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-4:] = False
    want = jms.ms_rollout(params, jcfg, jstats, jnp.asarray(pos), jnp.asarray(types), jnp.asarray(strains), jgr,
                          node_mask=jnp.asarray(mask), inference_mode=mode)
    got = tms.ms_rollout(sim, tcfg, tstats, pos, types, strains, tgr, mask, inference_mode=mode, device="cpu")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **ROLLOUT_TOL)
    np.testing.assert_array_equal(got["predicted_rollout"][:, :3].numpy(), pos[:3, S:].transpose(1, 0, 2))
    np.testing.assert_array_equal(got["predicted_strain"][:, :3].numpy(), strains[S:, :3])


# --- predict (the slice) -----------------------------------------------------------


def tiny_config(root, **kw):
    base = dict(mode="rollout", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, input_sequence_length=S,
                run_name="ms", pad_multiple=32, edge_pad_multiple=256, model_file="model-best-000000")
    base.update(kw)
    return TrainConfig(**base)


def write_yaml(path, cfg):
    keys = ("data_path", "model_path", "output_path", "layers", "hidden_dim", "input_sequence_length", "run_name",
            "pad_multiple", "edge_pad_multiple", "ms_dense", "compute_dtype", "inference_mode")
    path.write_text("".join(f"{k}: {getattr(cfg, k)!r}\n" if isinstance(getattr(cfg, k), str)
                            else f"{k}: {getattr(cfg, k)}\n" for k in keys))
    return path


def jax_params_for(cfg, root):
    md = ttrain.load_metadata(root / "data")
    jcfg_train = jconfig.TrainConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(jconfig.TrainConfig)
                                        if hasattr(cfg, f.name)})
    jsim_cfg = jtms.ms_config_from(jcfg_train, md)
    params = jax.tree.map(np.asarray, jms.multi_scale_simulator_init(jax.random.key(5), jsim_cfg))
    return jcfg_train, jsim_cfg, params, md


@pytest.mark.parametrize("ms_dense,compute_dtype,mode", [
    ("auto", "float32", "rollout"), (False, "float32", "valid"), (True, "bfloat16", "rollout")])
def test_predict_matches_jax_evaluate_split(tiny_data, tmp_path, capsys, ms_dense, compute_dtype, mode):
    run = f"ms_{ms_dense}_{compute_dtype}"
    cfg = tiny_config(tiny_data, run_name=run, ms_dense=ms_dense, compute_dtype=compute_dtype, mode=mode)
    jcfg_train, jsim_cfg, params, md = jax_params_for(cfg, tiny_data)
    CheckpointManager(tiny_data / "models" / run).save_best(
        {"params": ms_state_dict_from_jax(params), "opt_state": None, "step": 0}, 0, float("inf"))

    split = "test" if mode == "rollout" else "valid"
    jload = jloader.MultiScaleTrajectoryLoader(
        tiny_data / "data" / f"{split}.npz", ms_cfg=jsim_cfg.graph_config, pad_multiple=cfg.pad_multiple,
        edge_pad_multiple=cfg.edge_pad_multiple, dense=ms_dense,
        dense_row_advantage=4.0 if compute_dtype == "bfloat16" else 2.0, m2m_traversals=cfg.layers)
    jstats = jms.NormStats(*(jnp.asarray(a) for a in ttrain.make_norm_stats(md, cfg.noise_std)))
    _, want = jtms.evaluate_split(params, jload, jtms.make_jit_rollout(jsim_cfg, jstats, cfg.inference_mode))
    capsys.readouterr()

    summary = ttms.main(["--config", str(write_yaml(tmp_path / "ms.yaml", cfg)), "--mode", mode,
                         "--model_file", "model-best-000000", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert set(summary) == set(want) == {"total", "position", "strain", "one_step", "mean_time", "std_time"}
    tol = ROLLOUT_TOL if compute_dtype == "float32" else BF16_TOL
    for key in ("total", "position", "strain", "one_step"):
        np.testing.assert_allclose(summary[key], want[key], err_msg=key, **tol)
    assert "multi-scale rollout summary (cpu)" in printed
    if ms_dense == "auto":
        assert "ms layout auto: " in printed
    pkls = sorted((tiny_data / "rollouts" / run).glob("*.pkl"))
    assert len(pkls) == (1 if mode == "rollout" else 0)
    if pkls:
        with open(pkls[0], "rb") as f:
            out = pickle.load(f)
        for key in ("predicted_rollout", "rmse_position_per_step", "rmse_strain_per_step", "run_time",
                    "metadata", "case_name", "inference_mode"):
            assert key in out, key
        assert np.isfinite(out["predicted_rollout"]).all()


def test_inference_cli_runs_predict(tiny_data, tmp_path):
    cfg = tiny_config(tiny_data, run_name="ms_cli")
    _, _, params, _ = jax_params_for(cfg, tiny_data)
    CheckpointManager(tiny_data / "models" / "ms_cli").save_best(
        {"params": ms_state_dict_from_jax(params), "opt_state": None, "step": 0}, 0, float("inf"))
    yml = write_yaml(tmp_path / "ms.yaml", cfg)
    summary = tinfer.main(["--config", str(yml), "--model_file", "model-best-000000", "--split", "valid",
                           "--device", "cpu"])
    assert np.isfinite(summary["total"])


# --- refusals ----------------------------------------------------------------------


def test_train_mode_is_refused(tiny_data, tmp_path):
    """Training runs (tests/test_torch_port_ms_train.py), data- and
    graph-parallel too (tests/test_torch_port_dp.py,
    tests/test_torch_port_ms_partition.py); a graph-parallel training run
    is refused, as JAX's, with data_parallel and with a batch of more than
    one sample. predict ignores graph_parallel, as JAX's: the summary of
    graph_parallel: 2 equals that of 1."""
    kw = dict(mode="train", run_name="refused", graph_parallel=2)
    cpu2 = ["cpu", "cpu"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttms.train(tiny_config(tiny_data, batch_size=1, data_parallel=2, **kw), device="cpu", devices=cpu2 * 2)
    with pytest.raises(ValueError, match="batch_size"):
        ttms.train(tiny_config(tiny_data, batch_size=2, **kw), device="cpu", devices=cpu2)
    cfg = tiny_config(tiny_data, run_name="ms_gp_predict", mode="valid")
    _, _, params, _ = jax_params_for(cfg, tiny_data)
    CheckpointManager(tiny_data / "models" / "ms_gp_predict").save_best(
        {"params": ms_state_dict_from_jax(params), "opt_state": None, "step": 0}, 0, float("inf"))
    one = ttms.predict(cfg, device="cpu")
    two = ttms.predict(dataclasses.replace(cfg, graph_parallel=2, batch_size=1), device="cpu")
    assert set(one) == set(two)
    for key in ("total", "position", "strain", "one_step"):
        assert one[key] == two[key], key


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_without_a_device(no_cuda, tiny_data, tmp_path):
    jcfg, tcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tms.multi_scale_simulator_init(tcfg)
    sim = tms.multi_scale_simulator_init(tcfg, device="cpu")
    grid = GRIDS["square8"]
    graph = tg.build_static_graph(tcfg.graph_config, grid, g2m_pad=512, m2m_pad=256, m2g_pad=512)
    stats = TNormStats(*(torch.ones(2) for _ in range(4)))
    pos = np.zeros((len(grid), S + 2, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tms.ms_rollout(sim, tcfg, stats, pos, np.zeros(len(grid), np.int32),
                       np.zeros((S + 2, len(grid)), np.float32), graph)
    cfg = tiny_config(tiny_data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttms.predict(cfg)
    yml = write_yaml(tmp_path / "ms.yaml", cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttms.main(["--config", str(yml), "--mode", "rollout"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinfer.main(["--config", str(yml), "--model_file", "model-best-000000"])
