"""The captured rollout step (the port of JAX's make_jit_rollout) on the CPU.

On CPU tensors ``rollout`` and ``ms_rollout`` run their step over the
captured step's static buffers eagerly (``physics/captured_step.py``), so
these tests drive the same code as the card, less the graph itself: the
sync-free cell-list search against JAX, the steps with every host read
refused, the captured route against the eager loop (bit for bit) and JAX,
the launch accounting of capture and replay, and the cache's keys. The
card's own checks are in tests/test_torch_port_cuda.py.
"""

import contextlib
import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgnn_tpu.ops import neighbors as jnb
from sgnn_tpu.physics import multi_scale_simulator as jms
from sgnn_tpu_torch.ops import neighbors as tnb
from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics import rollout as troll
from test_torch_port_multi_scale import GRIDS, graphs, sequence
from test_torch_port_multi_scale import S as MS_S
from test_torch_port_multi_scale import configs as ms_configs
from test_torch_port_multi_scale import sim_pair as ms_sim_pair
from test_torch_port_multi_scale import stats_pair as ms_stats_pair
from test_torch_port_rollout import S, configs, sim_pair, stats_pair, trajectory

# the module, not the function that sgnn_tpu.physics re-exports under its name
jroll = importlib.import_module("sgnn_tpu.physics.rollout")

torch.set_num_threads(1)

R = 0.6
DOMAIN = ((-3.0, -3.0), (6.0, 6.0))
# a few autoregressive steps against JAX: each step's error feeds the next
# window (the tolerance of tests/test_torch_port_rollout.py and
# tests/test_torch_port_multi_scale.py)
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def host_reads_refused():
    """Every way a step could read the device back to the host, or make a
    tensor from host data, raises while the context is open."""

    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"{name} called inside a step")

        return raiser

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "__bool__", "__int__", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        mp.setattr(torch, "bincount", refuse("torch.bincount"))
        mp.setattr(torch, "tensor", refuse("torch.tensor"))
        yield


# --- (a) the cell-list search: no host sync, bit-equal to JAX ----------------------


def _cloud(rng, b, n, extent):
    return rng.uniform(0.0, extent, size=(b, n, 2)).astype(np.float32)


def _on_cell_boundaries(rng, b, n):
    """Particles whose coordinates sit on multiples of R from the domain's
    corner (the cell boundaries, binned by an f32 division), and on
    multiples of R / 2 between them."""
    steps = rng.integers(0, 16, size=(b, n, 2)).astype(np.float32)
    return (np.float32(DOMAIN[0][0]) + steps * np.float32(R / 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["masked", "over_capacity", "on_boundaries"])
def test_grid_search_is_sync_free_and_matches_jax(rng, case):
    b, n = 2, 160
    k, cap = 16, 8
    if case == "over_capacity":
        pos, cap = _cloud(rng, b, n, 3.0), 2  # several cells hold more than 2 particles
    elif case == "on_boundaries":
        pos = _on_cell_boundaries(rng, b, n)
    else:
        pos = _cloud(rng, b, n, 6.0)
    mask = rng.random((b, n)) > 0.15
    kw = dict(domain_min=DOMAIN[0], domain_max=DOMAIN[1], max_neighbors=k, cell_capacity=cap)
    want = jnb.radius_neighbors_grid_batched(jnp.asarray(pos), R, node_mask=jnp.asarray(mask), **kw)
    pos_t, mask_t = torch.from_numpy(pos), torch.from_numpy(mask)
    tnb.radius_neighbors_grid_batched(pos_t, R, node_mask=mask_t, **kw)  # makes the kept constants
    with host_reads_refused():
        got = tnb.radius_neighbors_grid_batched(pos_t, R, node_mask=mask_t, **kw)
    np.testing.assert_array_equal(got.senders.numpy(), np.asarray(want.senders))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert not got.mask.numpy()[~mask.reshape(-1)].any()  # masked nodes have degree 0
    if case == "over_capacity":
        cells = np.floor((pos - np.float32(DOMAIN[0][0])) / np.float32(R)).astype(int)  # [B, N, 2]
        keyed = np.concatenate([np.repeat(np.arange(b), n)[:, None], cells.reshape(-1, 2)], axis=1)
        occupancy = np.unique(keyed[mask.reshape(-1)], axis=0, return_counts=True)[1]
        assert occupancy.max() > cap
    if case == "on_boundaries":
        assert int(got.mask.sum()) > b * n // 2  # pairs at the cell boundaries are found


# --- (b) the steps read nothing back and copy nothing in ----------------------------


def _ss_step_inputs(sim, tcfg, tstats, pos, types_, mask):
    types_t = torch.from_numpy(types_).long()
    fixed = dict(particle_types=types_t, node_mask=torch.from_numpy(mask),
                 erosional=(types_t == troll.EROSIONAL_PARTICLE_ID)[:, None])
    return (torch.from_numpy(pos[:, :S].copy()), torch.from_numpy(pos[:, S].copy()), torch.zeros(pos.shape[0])), fixed


@pytest.mark.parametrize("symmetric_gather", [False, True])
def test_single_scale_step_needs_no_host_read(rng, symmetric_gather):
    jcfg, tcfg = configs(1, DOMAIN)
    tcfg = dataclasses.replace(tcfg, symmetric_gather=symmetric_gather)
    _, tstats = stats_pair(rng)
    _, sim = sim_pair(jcfg, tcfg, seed=1)
    pos = trajectory(rng)
    types_ = np.zeros(pos.shape[0], np.int32)
    types_[:2] = troll.EROSIONAL_PARTICLE_ID
    mask = np.ones(pos.shape[0], bool)
    mask[-3:] = False
    args, fixed = _ss_step_inputs(sim, tcfg, tstats, pos, types_, mask)
    step = troll.rollout_step(sim, tcfg, tstats, "autoregressive")
    with torch.inference_mode():
        want = step(*args, **fixed)  # set-up: the search's constants are made once
        with host_reads_refused():
            got = step(*args, **fixed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == args[0].shape and torch.equal(got[0][:, :-1], args[0][:, 1:])


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_multi_scale_step_needs_no_host_read(rng, layout):
    jcfg, tcfg = ms_configs()
    _, tstats = ms_stats_pair(rng)
    _, sim = ms_sim_pair(jcfg, tcfg, seed=1)
    grid = GRIDS["jittered12x5"]
    _, graph = graphs(jcfg, tcfg, grid, layout)
    pos = sequence(rng, grid, t=MS_S + 1)
    types_t = torch.zeros(len(grid), dtype=torch.long)
    fixed = dict(particle_types=types_t, erosional=(types_t == -1)[:, None], graph=graph)
    args = (torch.from_numpy(pos[:, :MS_S].copy()), torch.from_numpy(pos[:, MS_S].copy()), torch.zeros(len(grid)))
    step = tms.ms_rollout_step(sim, tcfg, tstats, "one_step")
    with torch.inference_mode():
        want = step(*args, **fixed)
        with host_reads_refused():
            got = step(*args, **fixed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][:, -1], args[1])  # one_step shifts in the ground truth


# --- (c) the captured route equals the eager loop and JAX ---------------------------


@pytest.mark.parametrize("symmetric_gather", [False, True])
@pytest.mark.parametrize("mode", ["autoregressive", "one_step"])
def test_captured_rollout_equals_eager_and_jax(rng, mode, symmetric_gather):
    jcfg, tcfg = configs(1, DOMAIN)
    jcfg = dataclasses.replace(jcfg, symmetric_gather=symmetric_gather)
    tcfg = dataclasses.replace(tcfg, symmetric_gather=symmetric_gather)
    jstats, tstats = stats_pair(rng)
    params, sim = sim_pair(jcfg, tcfg, seed=4)
    pos = trajectory(rng)  # [N, S+5, dim]: 5 rollout steps
    n = pos.shape[0]
    types_ = np.zeros(n, np.int32)
    types_[:3] = troll.EROSIONAL_PARTICLE_ID
    strains = rng.normal(size=(pos.shape[1], n)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-4:] = False
    args = (sim, tcfg, tstats, pos, types_, strains, mask)
    eager = troll.rollout(*args, inference_mode=mode, device="cpu", capture=False)
    got = troll.rollout(*args, inference_mode=mode, device="cpu")
    again = troll.rollout(*args, inference_mode=mode, device="cpu")  # the cached step
    assert len(captured_step.steps_of(sim)) == 1
    want = jroll.rollout(params, jcfg, jstats, jnp.asarray(pos), jnp.asarray(types_), jnp.asarray(strains),
                         jnp.asarray(mask), inference_mode=mode)
    assert set(got) == set(eager) == set(want)
    for key in want:
        assert torch.equal(got[key], eager[key]), key
        assert torch.equal(again[key], eager[key]), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **ROLLOUT_TOL)
    np.testing.assert_array_equal(got["predicted_rollout"][:, :3].numpy(), pos[:3, S:].transpose(1, 0, 2))


@pytest.mark.parametrize("mode", ["autoregressive", "one_step"])
@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_captured_ms_rollout_equals_eager_and_jax(rng, layout, mode):
    jcfg, tcfg = ms_configs()
    jstats, tstats = ms_stats_pair(rng)
    params, sim = ms_sim_pair(jcfg, tcfg, seed=2)
    grid = GRIDS["jittered12x5"]
    n = len(grid)
    jgr, tgr = graphs(jcfg, tcfg, grid, layout)
    pos = sequence(rng, grid, t=MS_S + 4)
    types_ = np.zeros(n, np.int32)
    types_[:3] = -1
    strains = rng.normal(size=(MS_S + 4, n)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-4:] = False
    args = (sim, tcfg, tstats, pos, types_, strains, tgr, mask)
    eager = tms.ms_rollout(*args, inference_mode=mode, device="cpu", capture=False)
    got = tms.ms_rollout(*args, inference_mode=mode, device="cpu")
    want = jms.ms_rollout(params, jcfg, jstats, jnp.asarray(pos), jnp.asarray(types_), jnp.asarray(strains), jgr,
                          node_mask=jnp.asarray(mask), inference_mode=mode)
    assert set(got) == set(eager) == set(want)
    for key in want:
        assert torch.equal(got[key], eager[key]), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **ROLLOUT_TOL)
    np.testing.assert_array_equal(got["predicted_strain"][:, :3].numpy(), strains[MS_S:, :3])


def test_a_new_static_graph_is_copied_into_the_buffers(rng):
    """Two trajectories with graphs of one shape share one captured step;
    the second reads its own graph."""
    jcfg, tcfg = ms_configs()
    _, tstats = ms_stats_pair(rng)
    _, sim = ms_sim_pair(jcfg, tcfg, seed=3)
    outs = []
    for grid in (GRIDS["jittered12x5"], GRIDS["jittered12x5"][::-1].copy()):
        _, tgr = graphs(jcfg, tcfg, grid, "dense")
        pos = sequence(rng, grid, t=MS_S + 2)
        args = (sim, tcfg, tstats, pos, np.zeros(len(grid), np.int32), np.zeros((MS_S + 2, len(grid)), np.float32), tgr)
        outs.append((tms.ms_rollout(*args, device="cpu"), tms.ms_rollout(*args, device="cpu", capture=False)))
    assert len(captured_step.steps_of(sim)) == 1
    for got, eager in outs:
        assert torch.equal(got["predicted_rollout"], eager["predicted_rollout"])


# --- (d) launch accounting -----------------------------------------------------------


@pytest.fixture
def stub_counters(monkeypatch):
    stub = types.SimpleNamespace(LAUNCHES=0, BY_KERNEL={"a": 0, "b": 0})
    monkeypatch.setattr(captured_step, "COUNTERS", [(stub, "LAUNCHES"), (stub, "BY_KERNEL")])
    return stub


def test_launch_record_takes_back_the_capture_and_adds_each_replay(stub_counters):
    stub = stub_counters

    def capture():  # what the wrappers count while a step is captured
        stub.LAUNCHES += 3
        stub.BY_KERNEL["b"] += 2

    stub.LAUNCHES = 5
    record = captured_step.LaunchRecord.around(capture)
    assert stub.LAUNCHES == 5 and stub.BY_KERNEL == {"a": 0, "b": 0}
    for _ in range(4):
        record.replayed()
    assert stub.LAUNCHES == 5 + 4 * 3 and stub.BY_KERNEL == {"a": 0, "b": 4 * 2}
    stub.LAUNCHES = 0  # a caller's reset, as chip_smoke.py makes: replays count from it
    record.replayed()
    assert stub.LAUNCHES == 3


def test_capture_that_raises_still_takes_back_its_counts(stub_counters):
    def capture():
        stub_counters.LAUNCHES += 2
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        captured_step.LaunchRecord.around(capture)
    assert stub_counters.LAUNCHES == 0


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay launches nothing here,
    so only the accounting moves the counters."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def test_card_route_counts_one_step_per_step(stub_counters, monkeypatch):
    """The card's route (warm-up step, capture, replays) with the CUDA calls
    stubbed: a step that counts one launch counts one launch per step,
    whether the step ran eagerly (the warm-up), was captured (taken back)
    or was replayed (added)."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    modes = []  # thread_local: the trainers' prefetcher may stage a batch during a capture
    monkeypatch.setattr(torch.cuda, "graph", lambda g, capture_error_mode: modes.append(capture_error_mode)
                        or contextlib.nullcontext())

    def step(window, gt_pos, gt_strain, *, erosional):
        stub_counters.LAUNCHES += 1
        return torch.cat([window[:, 1:], gt_pos[:, None]], dim=1), gt_pos * 2, gt_strain + 1

    n, t = 7, 5
    window, gt_pos, gt_strain = torch.zeros(n, 3, 2), torch.randn(t, n, 2), torch.randn(t, n)
    fixed = dict(erosional=torch.zeros(n, 1, dtype=torch.bool))
    captured = captured_step.CapturedStep(window, gt_pos, gt_strain, fixed)
    captured.device = torch.device("cuda", 0)
    captured.run(step, window, gt_pos, gt_strain, fixed)
    assert stub_counters.LAUNCHES == t and captured.replays == t - 1 == _FakeGraph.replays
    assert captured.launches.delta == {(0, None): 1} and captured.capture_seconds >= 0
    assert modes == ["thread_local"]
    captured.run(step, window, gt_pos, gt_strain, fixed)
    assert stub_counters.LAUNCHES == 2 * t and captured.replays == 2 * t - 1


def test_a_failed_capture_raises_and_falls_back_to_nothing(stub_counters, monkeypatch):
    """A capture that fails raises out of the rollout: no eager retreat, its
    counts taken back, and the next call captures anew."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)

    @contextlib.contextmanager
    def failing_capture(graph, capture_error_mode):
        yield
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", failing_capture)
    calls = []

    def step(window, gt_pos, gt_strain):
        calls.append(1)
        stub_counters.LAUNCHES += 1
        return window, gt_pos, gt_strain

    n, t = 5, 4
    window, gt_pos, gt_strain = torch.zeros(n, 3, 2), torch.randn(t, n, 2), torch.randn(t, n)
    captured = captured_step.CapturedStep(window, gt_pos, gt_strain, {})
    captured.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        captured.run(step, window, gt_pos, gt_strain, {})
    assert len(calls) == 2  # the warm-up step and the capture; no step after it ran eagerly
    assert stub_counters.LAUNCHES == 1 and captured.graph is None and captured._step is None


# --- (e) the cache follows the weights ------------------------------------------------


def test_load_state_dict_changes_the_output_and_a_new_storage_recaptures(rng):
    jcfg, tcfg = configs(1, DOMAIN)
    _, tstats = stats_pair(rng)
    _, sim = sim_pair(jcfg, tcfg, seed=5)
    pos = trajectory(rng)
    args = (sim, tcfg, tstats, pos, np.zeros(pos.shape[0], np.int32), np.zeros((pos.shape[1], pos.shape[0]),
                                                                                np.float32))
    first = troll.rollout(*args, device="cpu")["predicted_rollout"]
    (step,) = captured_step.steps_of(sim)

    sim.load_state_dict({k: v * 1.01 for k, v in sim.state_dict().items()})  # in place: the same step
    moved = troll.rollout(*args, device="cpu")["predicted_rollout"]
    assert captured_step.steps_of(sim) == [step]
    assert not torch.equal(moved, first)
    assert torch.equal(moved, troll.rollout(*args, device="cpu", capture=False)["predicted_rollout"])

    p = next(sim.parameters())
    p.data = p.data.clone()  # a new storage: the key changes, a new step is made
    again = troll.rollout(*args, device="cpu")["predicted_rollout"]
    steps = captured_step.steps_of(sim)
    assert len(steps) == 2 and steps[0] is step
    assert torch.equal(again, moved)


def test_cache_keeps_a_few_steps_per_module(rng):
    jcfg, tcfg = configs(1, DOMAIN)
    _, tstats = stats_pair(rng)
    _, sim = sim_pair(jcfg, tcfg, seed=6)
    for n in range(20, 20 + captured_step.MAX_CACHED + 2):  # another node count, another step
        pos = trajectory(rng, n=n, t=S + 1)
        troll.rollout(sim, tcfg, tstats, pos, np.zeros(n, np.int32), np.zeros((S + 1, n), np.float32), device="cpu")
    steps = captured_step.steps_of(sim)
    assert len(steps) == captured_step.MAX_CACHED
    assert steps[-1].window.shape[0] == 20 + captured_step.MAX_CACHED + 1
