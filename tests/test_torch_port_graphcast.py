"""GraphCast in the port (``physics/sphere_graph``, ``models/graphcast``,
``data/fields``, the trainer's family ``GRAPHCAST``, which ``architecture:
graphcast`` picks) against the benchmark's plain reference
(``h100_bench/reference/graphcast.py``, its own graphs built by brute
force), on the CPU at a small size: a 10 degree grid (19 x 36), mesh level
2, latent 32, 2 processor layers, 5 surface and 2 atmospheric variables at
3 levels. Also the graphs' counts and contracts, the SiLU MLPs
against ``F.silu`` composites, the ReLU MLPs' arithmetic as it was, the
step on its buffers against the eager step, its products a step, and the options the family
refuses; training, predict and resume through the trainer are in
``test_torch_port_families.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree

from _f32_product_emulation import through_emulation
from h100_bench import graphcast_data
from h100_bench.reference import graphcast as ref_gc
from h100_bench.reference.common import Precision
from h100_bench.weights import make_weights
from sgnn_tpu_torch.data.fields import FieldBatcher, load_field_split
from sgnn_tpu_torch.data.prefetch import to_device
from sgnn_tpu_torch.models import graphcast as gc
from sgnn_tpu_torch.models.encode_process_decode import mlp_tail
from sgnn_tpu_torch.models.multi_scale import _mlp_tail_product
from sgnn_tpu_torch.nn.core import MLP, mlp_ln
from sgnn_tpu_torch.ops import f32_product as fp
from sgnn_tpu_torch.ops.f32_product import plain
from sgnn_tpu_torch.physics import sphere_graph as sg
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.config import TrainConfig

SPEC = dict(resolution_deg=10.0, levels=[300, 500, 850], atmospheric_variables=["temperature", "geopotential"],
            frames=8, data_seed=7, splits={"train": 1, "valid": 1, "test": 1})
SMALL = dict(layers=2, hidden_dim=32, input_sequence_length=2, mesh_refinement=2, edge_pad_multiple=64)
# the same f32 operations as the reference in another order (split first Linears against
# concatenations, sorted sums against index_add_): outputs of order 1 differ by round-off, a few 1e-7
FWD_TOL = 1e-5
# the loss: a weighted mean of such outputs' squared errors, the same round-off
LOSS_TOL = 1e-5
# each leaf's gradient, relative to its norm: round-off through 2 layers of backward, a few 1e-7
GRAD_TOL = 1e-4
# a 4-step forecast in the state's standard deviations: the states are of order 1e5 (pressure,
# geopotential) in f32, whose spacing there is 1e-5 of a standard deviation, and each step adds to them
FORECAST_TOL = 1e-3
# the graphs' features: float64 geometry rounded to f32 in both, in another order of operations
FEATURE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    """The small dataset in the port's split format: (its directory, the
    metadata, the training trajectory)."""
    root = tmp_path_factory.mktemp("port_graphcast")
    splits, metadata = graphcast_data.prepare(SPEC, root / "data")
    return root, metadata, splits["train"]["case-000"]


def graphcast_config(root, **kw) -> TrainConfig:
    base = dict(mode="train", architecture="graphcast", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), batch_size=1, noise_std=0.0, ntraining_steps=40,
                nsave_steps=20, log_every=10, lr_init=0.05, run_name="graphcast", seed=0, **SMALL)
    base.update(kw)
    return TrainConfig(**base)


def _ref_sizes(sim_cfg: gc.GraphCastConfig) -> dict:
    return dict(latent=sim_cfg.latent_dim, layers=sim_cfg.num_message_passing_steps, state_dim=sim_cfg.state_dim,
                forcing_dim=sim_cfg.forcing_dim, static_dim=sim_cfg.static_dim, frames=sim_cfg.input_frames,
                resolution_deg=sim_cfg.resolution_deg, refinement=sim_cfg.mesh_refinement,
                radius_fraction=gc.G2M_RADIUS_FRACTION)


@pytest.fixture(scope="module")
def model(fields):
    """The port's model and the reference's sizes, weights and graphs, on one seed's weights."""
    root, metadata, _ = fields
    sim_cfg = ttrain.graphcast_config_from(graphcast_config(root), metadata)
    sim = gc.GraphCast(sim_cfg, generator=torch.Generator().manual_seed(0))
    mc = _ref_sizes(sim_cfg)
    weights = make_weights(ref_gc.param_shapes(mc), 2 ** 31 + 5, torch.device("cpu"))
    sim.load_state_dict(weights, strict=True)
    return sim, gc.field_stats(metadata), mc, weights, ref_gc.graphs(mc, "cpu"), ref_gc.stats(metadata, "cpu")


# --- the graphs ------------------------------------------------------------------


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_icosphere_counts(r):
    mesh = sg.icosphere(r)
    assert len(mesh.xyz) == 10 * 4 ** r + 2 and len(mesh.faces) == 20 * 4 ** r
    assert len(sg.face_edges(mesh.faces)) == 2 * 30 * 4 ** r  # E = 30 * 4^r sides, both directions
    assert np.allclose(np.linalg.norm(mesh.xyz, axis=1), 1.0)


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_multi_mesh_joins_every_level(r):
    """The paper's rule: levels 0 to r, 60 * (4^(r+1) - 1) / 3 directed edges, no self edges."""
    edges = sg.multi_mesh(sg.icosphere(r))
    assert len(edges) == 60 * (4 ** (r + 1) - 1) // 3 and not (edges[:, 0] == edges[:, 1]).any()


@pytest.mark.parametrize("res,level", [(10.0, 2), (5.0, 3)])
def test_every_grid_node_is_covered(res, level):
    """Every grid node sends at least one g2m edge and receives exactly 3
    m2g edges, from the vertices of a finest triangle that holds it; each
    set's receivers ascend and its senders, in the sender order, ascend."""
    g = sg.build_graph(res, level, 0.6, 64)
    grid, mesh = sg.grid(res), sg.icosphere(level)
    g2m, m2g = g.g2m, g.m2g
    assert np.bincount(g2m.senders[g2m.mask], minlength=g.grid_nodes).min() >= 1
    assert (np.bincount(m2g.receivers[m2g.mask], minlength=g.grid_nodes) == 3).all()
    tri = m2g.senders[m2g.mask].reshape(-1, 3)  # receivers ascend, three rows each
    faces = {tuple(sorted(f)) for f in mesh.faces.tolist()}
    assert all(tuple(sorted(t)) in faces for t in tri.tolist())
    w = sg.barycentric(grid.xyz, mesh.xyz[tri])
    assert w.min() >= -1e-9
    for pe in (g.g2m, g.m2m, g.m2g):
        assert (np.diff(pe.receivers) >= 0).all() and (np.diff(pe.senders[pe.order]) >= 0).all()
        assert len(pe.mask) % 64 == 0 and not pe.mask[pe.mask.sum():].any()
    assert g.edge_counts == {k: (int(getattr(g, k).mask.sum()), len(getattr(g, k).mask)) for k in ("g2m", "m2m", "m2g")}


@pytest.mark.parametrize("res,level", [(10.0, 2), (5.0, 3)])
def test_graphs_and_features_equal_the_reference(res, level):
    """The reference's brute-force graphs (its own vertex numbering, mapped
    onto the port's by position) are the port's edge for edge, and so are
    the node and edge features."""
    mc = dict(resolution_deg=res, refinement=level, radius_fraction=0.6)
    want = ref_gc.graphs(mc, "cpu")
    got = sg.build_graph(res, level, 0.6, 64)
    dist, to_port = cKDTree(sg.icosphere(level).xyz).query(want["mesh_xyz"])
    assert dist.max() < 1e-12 and len(set(to_port)) == len(to_port)
    np.testing.assert_allclose(got.grid_features, want["grid_features"].numpy(), atol=FEATURE_TOL)
    np.testing.assert_allclose(got.mesh_features[to_port], want["mesh_features"].numpy(), atol=FEATURE_TOL)
    for name, send_map, recv_map in (("g2m", None, to_port), ("m2m", to_port, to_port), ("m2g", to_port, None)):
        s, r = (x.numpy() for x in want[name])
        s = s if send_map is None else send_map[s]
        r = r if recv_map is None else recv_map[r]
        row = {e: i for i, e in enumerate(zip(s.tolist(), r.tolist()))}
        pe = getattr(got, name)
        edges = list(zip(pe.senders[pe.mask].tolist(), pe.receivers[pe.mask].tolist()))
        assert set(edges) == set(row)
        np.testing.assert_allclose(getattr(got, f"{name}_features")[pe.mask],
                                   want[f"{name}_features"].numpy()[[row[e] for e in edges]], atol=FEATURE_TOL)


# --- the model against the reference ----------------------------------------------


def test_forward_loss_and_gradients_match_the_reference(fields, model):
    _, _, tr = fields
    sim, stats, mc, weights, rg, rst = model
    state, forcings, static = (torch.from_numpy(tr[k]) for k in ("state", "forcings", "static"))
    t = 3
    y = gc.predict_residual(sim, stats, state[t - 1:t + 1], forcings[t - 1:t + 2], static)
    surf, atm = gc.loss_terms(stats, y, gc.target_residual(stats, state[t], state[t + 1]))
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    y_ref = ref_gc.forward(leaves, mc, ref_gc.inputs(rst, rg, state[t - 1:t + 1], forcings[t - 1:t + 2], static),
                           rg, Precision("f32"))
    loss_ref = ref_gc.loss(rst, y_ref, state[t - 1:t + 1], state[t + 1])
    assert float((y - y_ref).detach().abs().max()) <= FWD_TOL * float(y_ref.detach().abs().max())
    assert abs(float((surf + atm).detach()) - float(loss_ref.detach())) <= LOSS_TOL * float(loss_ref.detach())
    names = [n for n, _ in sim.named_parameters()]
    got = torch.autograd.grad(surf + atm, list(sim.parameters()))
    want = torch.autograd.grad(loss_ref, [leaves[n] for n in names])
    for n, a, b in zip(names, got, want):
        assert float((a - b).norm()) <= GRAD_TOL * float(b.norm()), n


def test_four_step_forecast_matches_the_reference(fields, model):
    _, _, tr = fields
    sim, stats, mc, weights, rg, rst = model
    state, forcings, static = (torch.from_numpy(tr[k]) for k in ("state", "forcings", "static"))
    with torch.no_grad():
        got = gc.rollout(sim, stats, state, forcings, static, 4)
        want = ref_gc.rollout(weights, mc, rst, rg, state, forcings, static, 4, Precision("f32"))
    assert got.shape == (4, *state.shape[1:])
    assert float(((got - want) / rst["state_std"]).abs().max()) <= FORECAST_TOL


def test_a_fault_each_tolerance_catches(fields, model):
    """A wrong m2g sender (one grid node's triangle shifted) moves the
    forward past FWD_TOL: the tolerances are not loose enough to pass it."""
    _, _, tr = fields
    sim, stats, mc, weights, rg, rst = model
    state, forcings, static = (torch.from_numpy(tr[k]) for k in ("state", "forcings", "static"))
    s, r = rg["m2g"]
    bad = dict(rg, m2g=(torch.cat([s[:1] + 1, s[1:]]), r))
    with torch.no_grad():
        y = gc.predict_residual(sim, stats, state[:2], forcings[:3], static)
    y_bad = ref_gc.forward(weights, mc, ref_gc.inputs(rst, bad, state[:2], forcings[:3], static), bad,
                           Precision("f32"))
    assert float((y - y_bad).abs().max()) > FWD_TOL * float(y_bad.abs().max())


# --- the MLPs' activations ----------------------------------------------------------


def test_silu_mlp_is_the_silu_composite():
    torch.manual_seed(0)
    mlp = MLP(6, [8, 8], 5, generator=torch.Generator().manual_seed(1), activation="silu")
    x = torch.randn(7, 6)
    a, b, c = mlp.linears
    want = F.silu(x @ a.weight.t() + a.bias)
    want = F.silu(want @ b.weight.t() + b.bias)
    want = want @ c.weight.t() + c.bias
    assert torch.equal(mlp(x), want)
    h = x @ a.weight.t() + a.bias
    assert torch.equal(mlp_tail(mlp, h), want)
    o, bias = _mlp_tail_product(mlp, h)
    assert torch.equal(o + bias, want)
    assert isinstance(mlp_ln(6, [8], 5, activation="silu")[0]._modules["Act-0"], torch.nn.SiLU)
    with pytest.raises(ValueError, match="activation"):
        MLP(6, [8], 5, activation="gelu")


def test_relu_mlps_compute_as_before():
    """The ReLU MLP, ``mlp_tail`` and ``_mlp_tail_product`` as they were
    written before the activation was a choice (``plain``'s composite with
    the ReLU in the product's call), bit for bit."""
    mlp = MLP(6, [8, 8], 5, generator=torch.Generator().manual_seed(2))
    x = torch.randn(7, 6, generator=torch.Generator().manual_seed(3))
    lins = mlp.linears
    want = x
    for i, lin in enumerate(lins):
        want = plain(want, lin.weight.t(), lin.bias, relu=i < len(lins) - 1)
    assert torch.equal(mlp(x), want)
    h = plain(x, lins[0].weight.t(), lins[0].bias)
    tail = plain(torch.relu(h), lins[1].weight.t(), lins[1].bias, relu=True)
    assert torch.equal(mlp_tail(mlp, h), plain(tail, lins[2].weight.t(), lins[2].bias))
    o, bias = _mlp_tail_product(mlp, h)
    assert torch.equal(o, plain(tail, lins[2].weight.t())) and bias is lins[2].bias


# --- the family ------------------------------------------------------------------------


def test_batcher_samples_and_loader(fields):
    root, metadata, tr = fields
    batcher = FieldBatcher(root / "data" / "train.npz", 2, 2, seed=0)
    assert len(batcher) == SPEC["frames"] - 2 and batcher.num_nodes == 19 * 36
    batch = next(iter(batcher))
    for k, (ti, t) in enumerate(zip(batch["traj_idx"], batch["time"])):
        assert ti == 0 and 1 <= t <= SPEC["frames"] - 2
        assert np.array_equal(batch["state"][k], tr["state"][t - 1:t + 1])
        assert np.array_equal(batch["forcings"][k], tr["forcings"][t - 1:t + 2])
        assert np.array_equal(batch["target"][k], tr["state"][t + 1])
    items = load_field_split(root / "data" / "valid.npz")
    assert len(items) == 1 and items[0][1]["state"].shape == (SPEC["frames"], 19 * 36, len(metadata["state_mean"]))


def test_captured_step_buffers_equal_the_eager_step(fields):
    """The step over its static buffers (the card's captured route, eager
    here) gives the eager loop's loss and parameters bit for bit, with no
    noise drawn, and AdamW's published settings."""
    root, _, _ = fields
    runs = []
    for capture in (True, False):
        built = ttrain.build_training(graphcast_config(root), torch.device("cpu"))
        built.step_fn.capture = capture
        batches = built.epochs()
        losses = [float(built.step_fn(to_device(next(batches), torch.device("cpu")), s)["train/loss"])
                  for s in range(1001, 1004)]
        runs.append((losses, [p.detach().clone() for p in built.sim.parameters()]))
        assert built.step_fn.z is None and isinstance(built.optimizer, torch.optim.AdamW)
        group = built.optimizer.param_groups[0]
        assert group["betas"] == ttrain.GRAPHCAST_BETAS and group["weight_decay"] == ttrain.GRAPHCAST_WEIGHT_DECAY
    assert runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))



def test_products_a_step_on_the_kernels(fields):
    """Every f32 product of a training step goes through ``F32Product`` (the kernels, emulated here):
    the five encoders, the grid update and the decoder two products each, each of the layers + 2
    interaction steps seven (the first edge Linear split three ways, its output, the node Linear's
    aggregate and node blocks, its output); a weight gradient each, an input gradient each but the
    encoders' first layers on the features."""
    root, _, _ = fields
    with through_emulation():
        built = ttrain.build_training(graphcast_config(root), torch.device("cpu"))
        batches = built.epochs()
        counts = []
        for s in range(2):
            before = dict(fp.LAUNCHES)
            built.step_fn(to_device(next(batches), torch.device("cpu")), s)
            counts.append({k: fp.LAUNCHES[k] - before[k] for k in before})
    products = 7 * 2 + 7 * (SMALL["layers"] + 2)
    assert counts == [{"fwd": products, "dgrad": products - 5, "wgrad": products}] * 2

def test_schedule_warms_up_then_decays():
    sched = ttrain.graphcast_schedule(TrainConfig(lr_init=1e-3, ntraining_steps=3000))
    assert sched(0) == 0.0 and sched(500) == pytest.approx(5e-4) and sched(1000) == pytest.approx(1e-3)
    assert sched(2000) == pytest.approx(5e-4) and sched(3000) == pytest.approx(0.0, abs=1e-12)
    assert ref_gc.learning_rate(500, 1e-3, 3000) == sched(500) and ref_gc.learning_rate(2000, 1e-3, 3000) == sched(2000)


@pytest.mark.parametrize("option", [dict(noise_std=0.02), dict(compute_dtype="bfloat16"), dict(data_parallel=2),
                                    dict(remat=True), dict(inference_mode="one_step")])
def test_graphcast_refuses(fields, option):
    root, metadata, _ = fields
    with pytest.raises(ValueError, match="graphcast does not take"):
        ttrain.graphcast_config_from(graphcast_config(root, **option), metadata)
