"""The port's utilities against JAX's on the CPU: the graph audit, the
profiling hooks (the span recorder) and trace summary, the rollout
renderer, the LS-DYNA parser, the native radius search, the
reference-checkpoint import and the parity driver (the counterparts of
``tests/test_aux.py:13-40, 140-230``, ``tests/test_lsdyna_parser.py``,
``tests/test_multi_scale.py:480-520`` and
``tests/test_torch_import.py:75``)."""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from sgnn_tpu.data import lsdyna_parser as jparser
from sgnn_tpu.models import encode_process_decode_apply as jepd_apply
from sgnn_tpu.ops import radius_neighbors_bruteforce as jsearch
from sgnn_tpu.physics import simulator as jsim
from sgnn_tpu.utils.graph_debug import audit_neighbor_list as jaudit
from sgnn_tpu.utils.torch_import import export_single_scale, import_single_scale
from sgnn_tpu_torch import native
from sgnn_tpu_torch.data import lsdyna_parser as tparser
from sgnn_tpu_torch.models.encode_process_decode import encode_process_decode_apply as tepd_apply
from sgnn_tpu_torch.ops.neighbors import NeighborList, radius_neighbors_bruteforce
from sgnn_tpu_torch.physics import multi_scale_graph as tmsg
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.utils import profiling
from sgnn_tpu_torch.utils import torch_import as timport
from sgnn_tpu_torch.utils.graph_debug import audit_neighbor_list
from sgnn_tpu_torch.viz.render_rollout import render_rollout_dict, render_rollout_file
from test_lsdyna_parser import make_dump
from test_torch_import import ReferenceLayoutEPD

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# --- graph audit ------------------------------------------------------------------------


def test_graph_audit(rng):
    pos = rng.uniform(-1, 1, size=(50, 2)).astype(np.float32)
    nl = radius_neighbors_bruteforce(torch.from_numpy(pos), 0.5, max_neighbors=32)
    stats = audit_neighbor_list(pos, nl, 0.5, verbose=False)
    assert stats["num_nodes"] == 50
    assert stats["num_edges"] == int(nl.mask.sum())
    assert stats["isolated_nodes"] == 0  # self loops guarantee degree >= 1
    assert stats["spot_check_failures"] == []
    assert stats == jaudit(pos, jsearch(jnp.asarray(pos), 0.5, max_neighbors=32), 0.5, verbose=False)


def test_graph_audit_detects_isolation():
    # no self loops + far-apart points -> isolated nodes
    pos = np.array([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0]], np.float32)
    jnl = jsearch(jnp.asarray(pos), 0.5, max_neighbors=4, include_self=False)
    nl = NeighborList(torch.from_numpy(np.array(jnl.senders)), torch.from_numpy(np.array(jnl.mask)))
    stats = audit_neighbor_list(pos, nl, 0.5, verbose=False, num_spot_checks=0)
    assert stats["isolated_nodes"] == 3
    assert stats == jaudit(pos, jnl, 0.5, verbose=False, num_spot_checks=0)


# --- profiling --------------------------------------------------------------------------


def test_step_profiler():
    """The port's span recorder (which replaced the step counter): off, a
    span records nothing; under a profile it records its name and
    attributes, nested under the enclosing span."""
    profiling.reset()
    with profiling.trace_region("train.step"):
        pass
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.trace_region("train.step", seq=2):
            with profiling.trace_region("train.capture"):
                pass
    step, capture = profiling.spans()
    assert (step.name, step.attrs, step.parent, step.root) == ("train.step", {"seq": 2}, -1, 0)
    assert (capture.name, capture.parent, capture.root) == ("train.capture", 0, 0)
    assert step.start_ns <= capture.start_ns <= capture.end_ns <= step.end_ns
    profiling.reset()


def test_summarize_trace_of_a_cpu_trace(tmp_path):
    """A CPU torch.profiler trace through start/stop_trace: summarize_trace
    rows in JAX's format, the named region in the trace, per-step times by
    the ProfilerStep count; no card work in a CPU trace."""
    a = torch.randn(64, 64)
    profiling.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path))
    for _ in range(3):
        with profiling.trace_region("step"):
            (a @ a).relu().sum()
    path = profiling.stop_trace()
    assert Path(path).exists() and "step" in Path(path).read_text()
    rows = profiling.summarize_trace(str(tmp_path), top=5, categories=("cpu_op",))
    ops = [r for r in rows if r["category"] == "op"]
    rollup = [r for r in rows if r["category"] == "rollup"]
    assert 0 < len(ops) <= 5 and rollup
    assert {"name", "ms_per_step", "category", "launches_per_step"} == set(rows[0])
    assert next(r for r in ops if r["name"] == "aten::mm")["launches_per_step"] == 3
    assert any(r["name"] == "aten::mm" for r in ops)
    assert all(r["ms_per_step"] >= 0 for r in rows)
    assert [r["ms_per_step"] for r in ops] == sorted((r["ms_per_step"] for r in ops), reverse=True)
    per3 = profiling.summarize_trace(path, top=5, steps=3, categories=("cpu_op",))
    assert per3[0]["ms_per_step"] == pytest.approx(ops[0]["ms_per_step"] / 3)
    assert profiling.summarize_trace(path) == []  # the card ran nothing
    assert profiling._category("void sgnn::edge_block_fwd_tc<float, 64>(float const*)") == "edge"
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "empty"))


# --- renderer ---------------------------------------------------------------------------


def test_render_rollout_gif(tmp_path, rng):
    """The renderer writes a GIF from the trainer's rollout pickle schema,
    directly and from a pickle."""
    t, n = 4, 30
    gt = rng.normal(size=(t, n, 2)).astype(np.float32)
    rollout = {
        "ground_truth_rollout": gt,
        "predicted_rollout": gt + 0.01,
        "ground_truth_strain": rng.normal(size=(t, n)).astype(np.float32),
        "predicted_strain": rng.normal(size=(t, n)).astype(np.float32),
        "rmse_position": np.linspace(0, 1e-2, t),
        "particle_types": np.zeros(n, np.int32),
        "metadata": {"stress_mean": 150.0, "stress_std": 80.0},
    }
    out = render_rollout_dict(rollout, tmp_path / "case.gif", fps=2)
    assert out.exists() and out.stat().st_size > 1000
    with open(tmp_path / "case.pkl", "wb") as f:
        pickle.dump(rollout, f)
    out2 = render_rollout_file(tmp_path / "case.pkl", tmp_path / "case2.gif", fps=2)
    assert out2.exists()


# --- LS-DYNA parser ---------------------------------------------------------------------


def test_parse_simulation(tmp_path):
    f = tmp_path / "C_80_320_case.txt"  # known case key -> type table applies
    pos, eps = make_dump(f)
    traj, types, strains = tparser.parse_simulation(f)
    assert traj.shape == (3, 8, 2) and strains.shape == (3, 8)
    np.testing.assert_allclose(traj, pos, rtol=1e-5)
    np.testing.assert_allclose(strains, eps, rtol=1e-5)
    assert (types == 0).all()
    for a, b in zip((traj, types, strains), jparser.parse_simulation(f)):
        np.testing.assert_array_equal(a, b)
    # the max-principal-strain companion file, in its own block format
    mps = ["$RESULT OF  Max Prin Strain"] + [f" {i + 1}, {0.01 * i:.6e}" for i in range(8)] + ["*END"]
    (tmp_path / "C_80_320_case_strain.txt").write_text("\n".join(mps * 3) + "\n")
    got, want = tparser.parse_simulation_strain(f), jparser.parse_simulation_strain(f)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_unknown_case_defaults_to_type_zero(tmp_path):
    f = tmp_path / "X_unknown_case.txt"
    make_dump(f, n_particles=4)
    _, types, _ = tparser.parse_simulation(f)
    assert (types == 0).all() and len(types) == 4
    np.testing.assert_array_equal(types, jparser.parse_simulation(f)[1])


def test_convert_to_npz_roundtrip(tmp_path):
    f = tmp_path / "C_80_320_case.txt"
    pos, eps = make_dump(f)
    out = tparser.convert_to_npz(f, tmp_path / "raw" / "case.npz")
    ref = jparser.convert_to_npz(f, tmp_path / "ref" / "case.npz")
    with np.load(out) as data, np.load(ref) as want:
        np.testing.assert_allclose(data["positions"], pos, rtol=1e-5)
        assert data["strains"].shape == (3, 8)
        assert data["particle_types"].dtype == np.int64
        assert set(data.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(data[k], want[k])


# --- native radius search ---------------------------------------------------------------


def _ckdtree_edges(pos, r):
    tree = cKDTree(pos)
    return {(j, i) for i, nbrs in enumerate(tree.query_ball_point(pos, r)) for j in nbrs
            if np.linalg.norm(pos[j] - pos[i]) < r}


@pytest.mark.parametrize("dim, n, r", [(2, 500, 0.5), (3, 300, 0.4)])
def test_native_radius_search_matches_scipy(rng, dim, n, r):
    """Built with the host g++ into build/native/ (never JAX's committed
    library): its edges equal cKDTree's, its max degree the edges'."""
    assert native.available()
    assert native.library_path().parent == REPO / "build" / "native"
    assert "sgnn_tpu/native" not in str(native.library_path())
    pos = rng.uniform(-2, 2, size=(n, dim)).astype(np.float64)
    s, rcv = native.radius_search_host(pos, r, 64)
    assert set(zip(s.tolist(), rcv.tolist())) == _ckdtree_edges(pos, r)
    assert native.max_degree_host(pos, r) == np.bincount(rcv, minlength=n).max()


def test_multi_scale_graph_takes_the_native_search(rng, monkeypatch):
    """_radius_edges takes the native search where it builds and cKDTree
    where it does not; both give the same edges (capped, lowest ids)."""
    pos = rng.uniform(0, 6, size=(400, 2))
    nat = tmsg._radius_edges(pos, 0.6, 8)
    assert native.LAST_SEARCH == "native"
    monkeypatch.setattr(native, "_load", lambda: None)
    ref = tmsg._radius_edges(pos, 0.6, 8)
    assert native.LAST_SEARCH == "ckdtree"
    np.testing.assert_array_equal(nat.senders, ref.senders)
    np.testing.assert_array_equal(nat.receivers, ref.receivers)


# --- reference checkpoints --------------------------------------------------------------


def _reference_checkpoint():
    """A reference-layout module (the reference's key names) sized as a
    simulator: dim 2, a 6-frame window, 3 particle types, width 16."""
    torch.manual_seed(0)
    ref = ReferenceLayoutEPD(node_in=5 * 2 + 1 + 9, edge_in=3, node_out=3, d=16, steps=2, nlayers=1)
    return {k: v.detach().clone() for k, v in ref.state_dict().items()}


def test_reference_checkpoint_loads_into_the_port(tmp_path, rng):
    """A reference state_dict loads straight into the port's
    LearnedSimulator (strict=True, the config read from its shapes), from
    a .pt or an .npz; its forward equals JAX's through import_single_scale."""
    sd = _reference_checkpoint()
    torch.save(sd, tmp_path / "ref.pt")
    np.savez(tmp_path / "ref.npz", **{k: v.numpy() for k, v in sd.items()})
    for path in ("ref.pt", "ref.npz"):
        loaded = timport.load_torch_checkpoint(str(tmp_path / path))
        assert set(loaded) == set(sd) and all(torch.equal(loaded[k], sd[k]) for k in sd)
    assert timport.detect_family(sd) == "single"
    sim, cfg = timport.simulator_from_state_dict(sd, "cpu")
    assert (cfg.dim, cfg.latent_dim, cfg.num_message_passing_steps, cfg.num_mlp_layers) == (2, 16, 2, 1)
    assert (cfg.input_sequence_length, cfg.num_particle_types, cfg.particle_type_embedding_size) == (6, 3, 9)
    assert all(torch.equal(v, sd[k]) for k, v in sim.state_dict().items())

    params = jax.tree.map(jnp.asarray, import_single_scale({k: v.numpy() for k, v in sd.items()}))
    n, k = 30, 8
    pos = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    jnl = jsearch(jnp.asarray(pos), 0.6, max_neighbors=k)
    nf = rng.normal(size=(n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(n, k, 3)).astype(np.float32)
    want = jepd_apply(params["epd"], jnp.asarray(nf), jnp.asarray(ef), jnl)
    nl = NeighborList(torch.from_numpy(np.array(jnl.senders)).long(), torch.from_numpy(np.array(jnl.mask)))
    with torch.no_grad():
        got = tepd_apply(sim._encode_process_decode, torch.from_numpy(nf), torch.from_numpy(ef), nl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)

    # the whole simulator step, both packages on the same checkpoint
    jcfg = jsim.SimulatorConfig(input_sequence_length=6, latent_dim=16, num_message_passing_steps=2,
                                num_particle_types=3, max_neighbors=k)
    seq = (pos[:, None, :] + rng.normal(scale=0.01, size=(n, 6, 2)).cumsum(1)).astype(np.float32)
    types = rng.integers(0, 3, n).astype(np.int32)
    jstats = jsim.NormStats(*(jnp.full(2, v, jnp.float32) for v in (0.0, 0.05, 0.0, 0.01)))
    tstats = tsim.NormStats(*(torch.full((2,), v) for v in (0.0, 0.05, 0.0, 0.01)))
    jp = {"epd": params["epd"], "type_embedding": params["type_embedding"]}
    want_pos, want_strain = jsim.predict_positions(jp, jcfg, jstats, jnp.asarray(seq), jnp.asarray(types))
    cfg = timport.single_scale_config(sd, max_neighbors=k)
    with torch.no_grad():
        got_pos, got_strain = tsim.predict_positions(sim, cfg, tstats, torch.from_numpy(seq),
                                                     torch.from_numpy(types).long())
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(got_strain.numpy(), np.asarray(want_strain), rtol=5e-5, atol=5e-5)


def test_parity_driver_against_the_golden_fixture(tmp_path):
    """The port's parity driver end to end, on the CPU, with the committed
    golden oracle weights as the reference checkpoint (as
    tests/test_aux.py runs JAX's): every expect/ stage within tol, exit 0;
    a corrupted weight fails with exit 1."""
    from test_golden_parity import unflatten_params

    fix = np.load(REPO / "tests" / "fixtures" / "golden_sim.npz")
    flat = {k[len("ss/param/"):]: fix[k] for k in fix.files if k.startswith("ss/param/")}
    sd = export_single_scale({"epd": unflatten_params(flat), "type_embedding": {"table": fix["ss/emb_table"]}})
    ckpt = tmp_path / "ref_ckpt.npz"
    np.savez(ckpt, **sd)
    n, s, dim, k, d, steps, nlayers, ntypes = (int(v) for v in fix["ss/meta"])
    r, wall_x = (float(v) for v in fix["ss/radius"])
    inp = {
        "position_sequence": fix["ss/seq"],
        "particle_types": fix["ss/types"],
        "vel_mean": fix["ss/vel_mean"],
        "vel_std": fix["ss/vel_std"],
        "acc_mean": fix["ss/acc_mean"],
        "acc_std": fix["ss/acc_std"],
        "expect/node_feat": fix["ss/node_feat"],
        "expect/output": np.concatenate([fix["ss/golden_norm_acc"], fix["ss/golden_strain"][:, None]], axis=1),
        "expect/next_positions": fix["ss/golden_next_pos"],
    }
    inp_path = tmp_path / "input.npz"
    np.savez(inp_path, **inp)
    cmd = [sys.executable, "-m", "sgnn_tpu_torch.scripts.parity_vs_checkpoint", "--device", "cpu",
           "--checkpoint", str(ckpt), "--input", str(inp_path), "--radius", str(r), "--max-neighbors", str(k),
           "--wall-x", str(wall_x), "--tol", "2e-4"]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "3/3 provided stages within tol" in res.stdout and "family: single" in res.stdout

    sd_bad = dict(sd)
    key = "_encode_process_decode._encoder.node_fn.0.NN-0.weight"
    sd_bad[key] = sd_bad[key] + 0.1
    np.savez(ckpt, **sd_bad)
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "FAIL" in res.stdout
