"""The serving loader's shape buckets (``static_graph_loader.bucket_dense_sizes``)
on the CPU: on bars of the multi-scale benchmark configuration's size, few
shapes, every size between its own and its bound, and the padding's cost;
two bars of different own sizes rolled out through one captured step, equal
to their own-size rollouts; and the training batcher, which keeps the
split's exact maxima."""

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.data import static_graph_loader as sgl
from sgnn_tpu_torch.data.loader import _round_up, load_trajectories
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset, simulate_taylor_impact
from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.physics.multi_scale_graph import DenseStaticGraph, MultiScaleConfig, create_all_edges

torch.set_num_threads(1)

# the multi-scale benchmark configuration's bars (h100_bench/configs/gns_taylor2d_ms_f32.json): 120 x 40
# particles, bar i from default_rng(data_seed + i) at impact speed 0.15 + 0.02 i, cropped one raw step
# before the first frame whose mean stress passes 1e-3, the last 4 particles dropped; nodes padded to 128
CELL = dict(nx=120, ny=40, raw_steps=152, boundary=4, stress_threshold=1e-3, pad_multiple=128, layers=10)
CELL_SEED = 20261018
NEXT_SEED = CELL_SEED + 16  # the generator's next sixteen bars
MS_CFG = MultiScaleConfig(num_scales=2, window_size=2, radius_multiplier=2.0)


def _frame0(data_seed, i):
    pos, _, sig = simulate_taylor_impact(nx=CELL["nx"], ny=CELL["ny"], impact_speed=0.15 + 0.02 * i,
                                         num_steps=CELL["raw_steps"], rng=np.random.default_rng(data_seed + i))
    start = max(int(np.nonzero(sig.mean(axis=1) > CELL["stress_threshold"])[0][0]) - 1, 0)
    return pos[start : start + 1, : -CELL["boundary"]].astype(np.float32)


def _sizes(graph):
    """A DenseStaticGraph's pad sizes, in the form ``_split_dense_sizes`` gives."""

    def of(de):
        return de.recv.shape[0], de.senders.shape[1], de.tsp_node.shape[0], de.tsp_rows.shape[1]

    return {"g2m": of(graph.g2m), "m2m": [of(de) for de in graph.m2m], "m2g": of(graph.m2g)}


def _flat(sizes):
    return [*sizes["g2m"], *(v for s in sizes["m2m"] for v in s), *sizes["m2g"]]


def _widest(sizes_list):
    """The largest of each size over ``sizes_list``: the training rule's one shape."""

    def widest(get):
        return tuple(max(v) for v in zip(*map(get, sizes_list)))

    return {"g2m": widest(lambda s: s["g2m"]), "m2g": widest(lambda s: s["m2g"]),
            "m2m": [widest(lambda s, i=i: s["m2m"][i]) for i in range(len(sizes_list[0]["m2m"]))]}


def _arrays(tree):
    """The arrays of a graph (NamedTuples and tuples of arrays), in order."""
    if isinstance(tree, tuple):
        return [a for t in tree for a in _arrays(t)]
    return [tree]


@pytest.fixture(scope="module")
def bars():
    """Per data seed, each of 16 bars' (own sizes, padded sizes, padded
    node count): the sizes of its dense graph as a one-bar split pads it
    for training (``_split_dense_sizes``) and for serving
    (``bucket_dense_sizes``), one hierarchy per bar; the cell's ``"auto"``
    picks the dense layout on each."""
    out = {}
    for data_seed in (CELL_SEED, NEXT_SEED):
        pairs = []
        for i in range(16):
            pos = _frame0(data_seed, i)
            num_nodes = _round_up(pos.shape[1], CELL["pad_multiple"])
            raw = sgl._search([(pos, None, None)], MS_CFG)
            assert sgl._auto_dense(raw, 4096, CELL["layers"], 2.0)
            own = sgl._dense_graphs(raw, sgl._split_dense_sizes(raw), num_nodes)[0]
            padded = sgl._dense_graphs(raw, sgl.bucket_dense_sizes(sgl._split_dense_sizes(raw), num_nodes,
                                                                   MS_CFG.max_neighbors), num_nodes)[0]
            pairs.append((_sizes(own), _sizes(padded), num_nodes))
        out[data_seed] = pairs
    return out


@pytest.mark.parametrize("data_seed", [CELL_SEED, NEXT_SEED])
def test_bars_of_the_cell_share_two_shapes_within_their_bounds(bars, data_seed):
    pairs = bars[data_seed]
    assert len({str(_flat(p)) for _, p, _ in pairs}) <= 2
    assert len({str(_flat(o)) for o, _, _ in pairs}) > 2  # their own sizes differ
    cap = _round_up(MS_CFG.max_neighbors, 4)
    for own, padded, num_nodes in pairs:
        assert all(p >= o for p, o in zip(_flat(padded), _flat(own)))
        for r, k, sr, sk in (padded["g2m"], *padded["m2m"], padded["m2g"]):
            assert r <= num_nodes and sr <= num_nodes and k <= cap
            assert sk & (sk - 1) == 0 and sk.bit_length() % 2 == 1  # a power of 4
    # the padding's device cost: the traversal-weighted slot-rows of every bar over their own, the measure
    # by which the training rule's one split-wide shape reads 6.7 % on the cell's bars
    own_rows = sum(sgl.dense_slot_rows(o, CELL["layers"]) for o, _, _ in pairs)
    padded_rows = sum(sgl.dense_slot_rows(p, CELL["layers"]) for _, p, _ in pairs)
    split_wide = len(pairs) * sgl.dense_slot_rows(_widest([o for o, _, _ in pairs]), CELL["layers"])
    inflation, split_inflation = padded_rows / own_rows - 1, split_wide / own_rows - 1
    # the buckets cost at most two points more than the tightest single shape; on the cell's bars, at most 8 %
    assert inflation <= split_inflation + 0.02, (inflation, split_inflation)
    if data_seed == CELL_SEED:
        assert inflation <= 0.08, inflation


# --- two bars, one capture ---------------------------------------------------------

S = 4  # input sequence length of the tiny rollouts
STEPS = 3


def _write_bar(path, seed):
    pos, types, sig = simulate_taylor_impact(nx=24, ny=8, num_steps=S + STEPS, rng=np.random.default_rng(seed))
    np.savez(path, trajectories={"case": (pos, types, sig)})


@pytest.mark.parametrize("layout", [True, "auto"], ids=["dense", "auto"])
def test_two_bars_of_different_sizes_share_one_captured_step(tmp_path, layout):
    cfg = tms.MultiScaleSimulatorConfig(dim=2, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=2,
                                        input_sequence_length=S, num_scales=2, window_size=2)
    stats = tsim.NormStats(*(torch.full((2,), v) for v in (0.01, 0.05, 0.001, 0.01)))
    sim = tms.multi_scale_simulator_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    kw = dict(ms_cfg=cfg.graph_config, pad_multiple=32, edge_pad_multiple=256, dense=layout, m2m_traversals=2)
    items, owns = [], []
    for seed in (2, 3):
        path = tmp_path / f"bar{seed}.npz"
        _write_bar(path, seed)
        loader = sgl.MultiScaleTrajectoryLoader(path, **kw)
        items.append(next(iter(loader)))
        owns.append(sgl._build_graphs(load_trajectories(path), cfg.graph_config, 256, dense=layout,
                                      num_nodes=loader.num_nodes, m2m_traversals=2)[0])
    assert all(isinstance(g, DenseStaticGraph) for g in owns)
    assert _sizes(owns[0]) != _sizes(owns[1])
    assert _sizes(items[0]["graph"]) == _sizes(items[1]["graph"])

    def roll(item, graph):
        return tms.ms_rollout(sim, cfg, stats, item["positions"], item["particle_type"], item["strains"], graph,
                              node_mask=item["node_mask"], device="cpu")

    served = [roll(item, item["graph"]) for item in items]
    assert len(captured_step.steps_of(sim)) == 1
    for item, own, got in zip(items, owns, served):
        want = roll(item, own)
        for key in ("predicted_rollout", "predicted_strain"):
            torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-6, msg=key)


# --- training keeps the exact maxima -----------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """4 training trajectories of 12 x 5 particles over 20 frames."""
    root = tmp_path_factory.mktemp("serving_buckets")
    generate_synthetic_raw_dataset(root / "raw", num_sims=5, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-140"], test_patterns=["-150"], boundary_particles_to_remove=2).build()
    return root / "data" / "train.npz"


def test_the_training_batcher_keeps_the_split_wide_maxima(tiny):
    kw = dict(ms_cfg=MS_CFG, pad_multiple=32, edge_pad_multiple=256, dense=True, m2m_traversals=2)
    batcher = sgl.MultiScaleSampleBatcher(tiny, S, 2, seed=0, **kw)
    trajs = load_trajectories(tiny)
    want = sgl._build_graphs(trajs, MS_CFG, 256, dense=True, num_nodes=batcher.num_nodes, m2m_traversals=2)
    own = sgl._split_dense_sizes([create_all_edges(MS_CFG, pos[0]) for pos, _, _ in trajs])
    assert sgl.bucket_dense_sizes(own, batcher.num_nodes, MS_CFG.max_neighbors) != own  # serving would pad more
    assert len(batcher.graphs) == len(want) == 4
    for got, exp in zip(batcher.graphs, want):
        assert _sizes(got) == own
        for a, b in zip(_arrays(got), _arrays(exp)):
            np.testing.assert_array_equal(a, b)
    batch = next(batcher.epochs())
    stacked = sgl._stack_graphs([want[i] for i in batch["traj_idx"]])
    for a, b in zip(_arrays(batch["graph"]), _arrays(stacked)):
        np.testing.assert_array_equal(a, b)
