"""The plain reference against the port at tiny sizes (this test alone may
import both): the radius graph against the port's cell-list search, the
noise against the port's integration matrix, and the forwards of both
configurations on the same weights and windows."""

import numpy as np
import pytest
import torch

from h100_bench import data, harness
from h100_bench.reference import common as ref
from h100_bench.reference import multi_scale as ref_ms
from h100_bench.reference import single_scale as ref_ss
from h100_bench.weights import make_weights

SPEC = {"nx": 16, "ny": 6, "raw_steps": 152, "step_size": 2, "total_steps": 100, "boundary_particles_to_remove": 4,
        "stress_threshold": 0.001, "radius": 0.6, "data_seed": 11, "num_trajectories": 2}


@pytest.fixture(scope="module")
def dataset():
    return data.make_dataset(SPEC)


def _windows(trajs, t=20, s_len=11):
    pos = trajs[0][0]
    return torch.from_numpy(np.ascontiguousarray(pos[t - s_len:t].transpose(1, 0, 2)))


def test_noise_matches_the_port():
    from sgnn_tpu_torch.physics.noise import random_walk_position_noise

    z = torch.randn(2, 7, 20)
    want = random_walk_position_noise((2, 7, 11, 2), 0.02, z=z)
    torch.testing.assert_close(ref.random_walk_noise(z, 11, 2, 0.02), want, rtol=0, atol=1e-7)


def test_radius_graph_matches_the_port(dataset):
    from sgnn_tpu_torch.ops.neighbors import radius_neighbors_grid_batched

    trajs, _ = dataset
    last = torch.from_numpy(trajs[0][0][30])
    nl = radius_neighbors_grid_batched(last[None], 0.6, domain_min=(-5.0, -30.0), domain_max=(80.0, 30.0),
                                       max_neighbors=8)
    s, r = ref_ss.radius_graph(last, torch.ones(len(last), dtype=torch.bool), 0.6, 8)
    want = {(int(a), int(b)) for a, b in zip(nl.senders[nl.mask], torch.nonzero(nl.mask)[:, 0])}
    assert set(zip(s.tolist(), r.tolist())) == want


def test_max_degree_fits_eight_slots():
    trajs, _ = data.make_dataset({**SPEC, "nx": 120, "ny": 40, "num_trajectories": 1, "data_seed": 20261018})
    assert data.max_degree(trajs[0][0], 0.6) + 2 <= 8


def test_single_scale_forward_matches_the_port(dataset):
    from sgnn_tpu_torch.physics.simulator import SimulatorConfig, forward_batched, make_norm_stats, simulator_init

    trajs, metadata = dataset
    mc = harness.model_sizes({"family": "single_scale", "train_config": {
        "hidden_dim": 16, "dim": 2, "layers": 2, "input_sequence_length": 11, "connection_radius": 0.6,
        "neighbor_slots": 8, "noise_std": 0.02}})
    cfg = SimulatorConfig(latent_dim=16, num_message_passing_steps=2, neighbor_slots=8,
                          domain=((-5.0, -30.0), (80.0, 30.0)))
    sim = simulator_init(cfg, device="cpu")
    w = make_weights(ref_ss.param_shapes(mc), 3, "cpu")
    sim.load_state_dict(w, strict=True)
    win = _windows(trajs)
    acc, strain = forward_batched(sim, cfg, make_norm_stats(metadata, 0.02), win[None], torch.zeros(1, len(win),
                                                                                                      dtype=torch.int32))
    graph = ref_ss.radius_graph(win[:, -1], torch.ones(len(win), dtype=torch.bool), 0.6, 8)
    r_acc, r_strain = ref_ss.forward(w, mc, win, graph, ref.norm_stats(metadata, 0.02, "cpu"), ref.Precision())
    torch.testing.assert_close(acc[0], r_acc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(strain[0], r_strain, rtol=1e-4, atol=1e-5)


def test_multi_scale_forward_matches_the_port(dataset):
    from sgnn_tpu_torch.data.static_graph_loader import _build_graphs
    from sgnn_tpu_torch.physics.multi_scale_simulator import (
        MultiScaleSimulatorConfig,
        _forward,
        graph_to,
        multi_scale_simulator_init,
    )
    from sgnn_tpu_torch.physics.simulator import make_norm_stats

    trajs, metadata = dataset
    mc = harness.model_sizes({"family": "multi_scale", "train_config": {
        "hidden_dim": 16, "dim": 2, "layers": 2, "input_sequence_length": 11, "connection_radius": 0.6,
        "noise_std": 0.02, "window_size": 2, "radius_multiplier": 2.0, "num_scales": 2}})
    cfg = MultiScaleSimulatorConfig(latent_dim=16, num_message_passing_steps=2)
    sim = multi_scale_simulator_init(cfg, device="cpu")
    w = make_weights(ref_ms.param_shapes(mc), 4, "cpu")
    sim.load_state_dict(w, strict=True)
    win = _windows(trajs)
    for dense in (True, False):
        graph = graph_to(_build_graphs([trajs[0]], cfg.graph_config, 1024, dense=dense, num_nodes=len(win))[0], "cpu")
        acc, strain = _forward(sim, cfg, make_norm_stats(metadata, 0.02), win, torch.zeros(len(win),
                                                                                           dtype=torch.int32), graph)
        h = ref_ms.batch_hierarchy([ref_ms.hierarchy(trajs[0][0][0], mc)], len(win), "cpu")
        r_acc, r_strain = ref_ms.forward(w, mc, win, h, ref.norm_stats(metadata, 0.02, "cpu"), ref.Precision())
        torch.testing.assert_close(acc, r_acc, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(strain, r_strain, rtol=1e-4, atol=1e-5)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0, float("inf")])
    got = ref.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -9, -3.0, float("inf")]
