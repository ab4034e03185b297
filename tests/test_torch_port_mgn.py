"""MeshGraphNets in the port (``physics/mesh_simulator``,
``models/mesh_graph_net``, the trainer's family ``MESHGRAPHNET``, which
``architecture: meshgraphnet`` picks) against the benchmark's plain reference
(``h100_bench/reference/mesh_graph_net.py``), on the CPU at a tiny size: a
12 x 6 bar, latent 16, 2 blocks, batch 2, one thread. Also the two edge
sets against brute-force numpy sets, a fault that each tolerance catches,
the world edge counter, and the options it refuses; training, predict
and resume through the trainer are in ``test_torch_port_families.py``."""


import numpy as np
import pytest
import torch

from h100_bench.reference import common as ref
from h100_bench.reference import mesh_graph_net as ref_mgn
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.loader import MeshSampleBatcher, TrajectoryLoader, load_metadata, load_trajectories
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.models import mesh_graph_net as tmgn
from sgnn_tpu_torch.physics import mesh_simulator as tms
from sgnn_tpu_torch.physics.noise import random_walk_position_noise
from sgnn_tpu_torch.physics.simulator import make_norm_stats
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.config import TrainConfig

NOISE = 0.02
# the same f32 operations as the reference in another order (slot sums
# against index_add_, split first Linears against concatenations): the
# outputs, of order 0.1-1, differ by round-off, about 1e-7
FWD_TOL = 1e-5
# the loss of one step: a masked mean of such outputs, same round-off
LOSS_TOL = 1e-5
# the worst leaf's gradient, relative to the larger of its norm and the
# median leaf's: round-off through 2 blocks of backward, a few 1e-6
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_mgn")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=6, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root, root / "data"


def _config(root, data, **kw):
    base = dict(mode="train", data_path=str(data), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, dim=2, input_sequence_length=2,
                connection_radius=0.6, batch_size=2, noise_std=NOISE, ntraining_steps=20, nsave_steps=10,
                lr_init=1e-3, run_name="mgn", pad_multiple=32, seed=0, log_every=10, architecture="meshgraphnet")
    base.update(kw)
    return TrainConfig(**base)


class Model:
    """The port's model and the reference's view of the same weights."""

    def __init__(self, env, seed=0):
        root, data = env
        self.cfg = _config(root, data, seed=seed)
        self.md = load_metadata(data)
        self.sim_cfg = ttrain.MESHGRAPHNET.config_from(self.cfg, self.md)
        self.sim = ttrain.MESHGRAPHNET.init(self.sim_cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
        self.stats = make_norm_stats(self.md, NOISE)
        self.ref_stats = ref.norm_stats(self.md, NOISE, "cpu")
        sc = self.sim_cfg
        self.mc = dict(latent=16, dim=2, layers=2, mlp_hidden_layers=2, seq_len=2, radius=0.6,
                       mesh_radius=sc.mesh_radius, world_radius=sc.world_radius,
                       world_search_slots=sc.world_search_slots, world_slots=sc.world_slots)
        self.batcher = MeshSampleBatcher(data / "train.npz", 2, 2, mesh_radius=sc.mesh_radius,
                                         mesh_slots=sc.mesh_slots, pad_multiple=32, seed=3)

    def params(self):
        return {k: v.detach().clone() for k, v in self.sim.state_dict().items()}

    def ref_graph(self, windows, traj_ids):
        """The reference's flat graph of the real nodes' windows."""
        ms, mr, ws, wr, rest, off = [], [], [], [], [], 0
        for w, ti in zip(windows, traj_ids):
            first = self.batcher.trajectories[ti][0][0]
            mesh = ref_mgn.mesh_graph(first, self.mc["mesh_radius"])
            s, r = ref_mgn.world_graph(w[:, -1], mesh, self.mc)
            ms.append(torch.as_tensor(mesh[0]) + off)
            mr.append(torch.as_tensor(mesh[1]) + off)
            ws.append(s + off)
            wr.append(r + off)
            rest.append(torch.from_numpy(first))
            off += w.shape[0]
        return {"mesh": (torch.cat(ms), torch.cat(mr)), "world": (torch.cat(ws), torch.cat(wr)),
                "rest": torch.cat(rest)}


def _tensors(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    out["mesh"] = tms.StaticMesh(*(torch.from_numpy(a) for a in batch["mesh"]))
    return out


def _real(t, mask):
    """The real nodes of a [B, N, ...] tensor, per sample."""
    return [t[k][mask[k]] for k in range(t.shape[0])]


def _port_and_reference(model, batch):
    b = _tensors(batch)
    acc, strain = tms.forward_batched(model.sim, model.sim_cfg, model.stats, b["positions"], b["particle_type"],
                                      b["node_mask"], b["mesh"])
    windows = _real(b["positions"], b["node_mask"])
    graph = model.ref_graph(windows, batch["traj_idx"])
    with torch.no_grad():
        r_acc, r_strain = ref_mgn.forward(model.params(), model.mc, torch.cat(windows), graph, model.ref_stats,
                                          ref.Precision("f32"))
    mask = b["node_mask"]
    return (acc[mask], strain[mask]), (r_acc, r_strain)


def test_state_dict_is_the_reference_layout(env):
    model = Model(env)
    shapes = {k: tuple(v.shape) for k, v in model.sim.state_dict().items()}
    assert shapes == ref_mgn.param_shapes(model.mc)


def test_forward_matches_reference(env):
    model = Model(env)
    batch = next(iter(model.batcher))
    (acc, strain), (r_acc, r_strain) = _port_and_reference(model, batch)
    assert torch.allclose(acc, r_acc, rtol=0, atol=FWD_TOL), (acc - r_acc).abs().max()
    assert torch.allclose(strain, r_strain, rtol=0, atol=FWD_TOL), (strain - r_strain).abs().max()


@pytest.mark.parametrize("fault", ["no_world_stage", "swapped_node_concatenation"])
def test_fault_breaks_the_forward_tolerance(env, fault, monkeypatch):
    model = Model(env)
    if fault == "no_world_stage":
        plain = tms.world_edges

        def no_world(*a, **kw):
            nl = plain(*a, **kw)
            return nl._replace(mask=torch.zeros_like(nl.mask))

        monkeypatch.setattr(tms, "world_edges", no_world)
    else:
        node_mlps = {id(b.node_fn[0]) for b in model.sim._encode_process_decode._processor.blocks}
        plain = tmgn.split_first_layer

        def swapped(mlp, splits):
            (a, c, e), bias = plain(mlp, splits)
            return ((c, a, e) if id(mlp) in node_mlps else (a, c, e)), bias

        monkeypatch.setattr(tmgn, "split_first_layer", swapped)
    batch = next(iter(model.batcher))
    (acc, strain), (r_acc, r_strain) = _port_and_reference(model, batch)
    gap = max(float((acc - r_acc).abs().max().detach()), float((strain - r_strain).abs().max().detach()))
    assert gap > FWD_TOL, gap


def test_one_train_step_matches_reference(env):
    model = Model(env)
    batch = next(iter(model.batcher))
    b = _tensors(batch)
    z = torch.randn(b["positions"].shape[:2] + (2,), generator=torch.Generator().manual_seed(5))
    noise = random_walk_position_noise(tuple(b["positions"].shape), NOISE, z=z)
    params = model.params()
    opt = ttrain.make_optimizer(model.sim, model.cfg)
    step = ttrain.make_train_step(model.sim, model.sim_cfg, model.stats, model.cfg, opt)
    loss = float(step(b, 0, noise)["train/loss"])
    grads = {n: p.grad.detach().clone() for n, p in model.sim.named_parameters()}

    mask = b["node_mask"]
    noise_r = _real(noise, mask)
    windows = [w + nz for w, nz in zip(_real(b["positions"], mask), noise_r)]
    nexts = torch.cat([x + nz[:, -1] for x, nz in zip(_real(b["next_position"], mask), noise_r)])
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    flat = torch.cat(windows)
    acc, strain = ref_mgn.forward(leaves, model.mc, flat, model.ref_graph(windows, batch["traj_idx"]),
                                  model.ref_stats, ref.Precision("f32"))
    target = ref.target_acceleration(nexts, flat, model.ref_stats)
    r_loss = ref.one_step_loss(acc, target, strain, torch.cat(_real(b["next_strain"], mask)),
                               torch.ones(flat.shape[0], dtype=torch.bool))
    r_grads = dict(zip(leaves, torch.autograd.grad(r_loss, list(leaves.values()))))
    assert abs(loss - float(r_loss)) <= LOSS_TOL * abs(float(r_loss))
    norms = {k: float(g.norm()) for k, g in r_grads.items()}
    med = float(np.median(list(norms.values())))
    worst = max(float((grads[k] - g).norm()) / max(norms[k], med) for k, g in r_grads.items())
    assert worst <= GRAD_TOL, worst


def test_rollout_matches_reference(env):
    model = Model(env)
    traj = next(iter(TrajectoryLoader(env[1] / "train.npz", pad_multiple=32)))
    steps = 3
    pos = traj["positions"][:, :2 + steps]
    mask = traj["node_mask"]
    first = pos[mask][:, 0]
    mesh = tms.build_mesh(first, model.sim_cfg.mesh_radius, model.sim_cfg.mesh_slots, len(mask))
    out = tms.mesh_rollout(model.sim, model.sim_cfg, model.stats, pos, traj["particle_type"],
                           traj["strains"][:2 + steps], mesh, node_mask=mask, device="cpu")
    params = model.params()
    window = torch.from_numpy(pos[mask][:, :2])
    mesh_ref = ref_mgn.mesh_graph(first, model.mc["mesh_radius"])
    for t in range(steps):
        s, r = ref_mgn.world_graph(window[:, -1], mesh_ref, model.mc)
        graph = {"mesh": (torch.as_tensor(mesh_ref[0]), torch.as_tensor(mesh_ref[1])), "world": (s, r),
                 "rest": torch.from_numpy(first)}
        with torch.no_grad():
            acc, strain = ref_mgn.forward(params, model.mc, window, graph, model.ref_stats, ref.Precision("f32"))
        nxt = ref.integrate(acc, window, model.ref_stats)
        got = out["predicted_rollout"][t][torch.from_numpy(mask)]
        # positions of order 10, each step adds accelerations of order acc_std: f32 round-off of the sum
        assert torch.allclose(got, nxt, rtol=0, atol=1e-5), (got - nxt).abs().max()
        assert torch.allclose(out["predicted_strain"][t][torch.from_numpy(mask)], strain, rtol=0, atol=FWD_TOL)
        window = torch.cat([window[:, 1:], got[:, None]], dim=1)  # the program's own prediction, as the check


def _brute_pairs(pos, radius):
    """(receiver, sender) pairs closer than radius, no self: f32 squares summed, as the search."""
    d = pos[None, :, :] - pos[:, None, :]
    r = np.float32(radius)
    ok = (d * d).sum(-1) < r * r
    np.fill_diagonal(ok, False)
    return {(int(i), int(j)) for i, j in zip(*np.nonzero(ok))}


def _rows(senders, mask):
    """Per receiver its valid senders, checked prefix-compacted and ascending."""
    out = {}
    for i, (s, m) in enumerate(zip(senders, mask)):
        k = int(m.sum())
        assert m[:k].all() and not m[k:].any()
        assert (np.diff(s[:k]) > 0).all()
        out[i] = set(int(x) for x in s[:k])
    return out


def test_edge_sets_equal_brute_force(env):
    model = Model(env)
    batch = next(iter(model.batcher))
    rng = np.random.default_rng(0)
    b = _tensors(batch)
    last = b["positions"][:, :, -1] + torch.from_numpy(rng.normal(scale=0.05, size=(2, b["positions"].shape[1], 2))
                                                       .astype(np.float32))
    n = last.shape[1]
    mesh = b["mesh"]
    offsets = torch.arange(2)[:, None, None] * n
    flat_ms = (mesh.senders + offsets).reshape(2 * n, -1)
    world = tms.world_edges(model.sim_cfg, last, b["node_mask"], flat_ms, mesh.mask.reshape(2 * n, -1))
    w_rows = _rows(world.senders.numpy(), world.mask.numpy())
    m_rows = _rows(flat_ms.numpy(), mesh.mask.reshape(2 * n, -1).numpy())
    for k in range(2):
        real = batch["node_mask"][k]
        ti = batch["traj_idx"][k]
        mesh_pairs = _brute_pairs(model.batcher.trajectories[ti][0][0].astype(np.float64), model.sim_cfg.mesh_radius)
        world_pairs = _brute_pairs(last[k].numpy()[real], model.sim_cfg.world_radius) - mesh_pairs
        for i in range(n):
            g = k * n + i
            want_m = {k * n + j for r, j in mesh_pairs if r == i}
            want_w = {k * n + j for r, j in world_pairs if r == i}
            assert m_rows[g] == want_m
            assert w_rows[g] == want_w  # no cap binds at these widths
            assert g not in w_rows[g] and not (w_rows[g] & m_rows[g])
        # the host's sender order sorts the flat senders
        flat = batch["mesh"].senders[k].reshape(-1)
        assert (np.diff(flat[batch["mesh"].order[k]]) >= 0).all()


def test_world_edge_counter_counts_valid_edges(env):
    model = Model(env)
    batch = next(iter(model.batcher))
    b = _tensors(batch)
    before = model.sim.world_edge_count.clone()
    with torch.no_grad():
        tms.forward_batched(model.sim, model.sim_cfg, model.stats, b["positions"], b["particle_type"],
                            b["node_mask"], b["mesh"])
    windows = _real(b["positions"], b["node_mask"])
    valid = len(model.ref_graph(windows, batch["traj_idx"])["world"][0])
    delta = (model.sim.world_edge_count - before).tolist()
    assert delta == [valid, b["positions"].shape[0] * b["positions"].shape[1] * model.sim_cfg.world_slots]
    assert "world_edge_count" not in model.sim.state_dict()


def test_derived_slots_cover_the_split(env):
    md = load_metadata(env[1])
    trajs = load_trajectories(env[1] / "train.npz")
    slots = tms.derive_slots(trajs, 0.6, 0.75)
    assert slots["mesh_slots"] == 4  # the quad mesh's axis neighbours
    assert slots["world_search_slots"] >= 9 + 2 and slots["world_slots"] >= slots["world_search_slots"] - 4 - 1 - 2
    sim_cfg = ttrain.MESHGRAPHNET.config_from(_config(*env), md)
    assert {k: getattr(sim_cfg, k) for k in slots} == slots


def test_meshgraphnet_refuses_what_it_does_not_take(env):
    with pytest.raises(ValueError, match="remat"):
        ttrain.MESHGRAPHNET.config_from(_config(*env, remat="full"), load_metadata(env[1]))
    with pytest.raises(ValueError, match="architecture"):
        ttrain.family_of(_config(*env, architecture="transformer"))
