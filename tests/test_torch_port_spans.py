"""The port's spans (``utils/profiling.trace_region``) on the CPU: off,
nothing is recorded, allocated or timed; on (a ``torch.profiler`` profile
active), names, nesting, parents and roots; spans of the prefetcher's
thread, paired with the consumer's by sequence number; the records on the
exported trace's clock; ``stop_trace`` merging both threads' records; the
spans of a tiny single-scale and multi-scale request and of a tiny
GraphCast graph build; many threads at once; the bounded buffer."""

import itertools
import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.data.loader import TrajectoryLoader, load_trajectories
from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
from sgnn_tpu_torch.data.static_graph_loader import (MultiScaleTrajectoryLoader, _split_dense_sizes, bucket_dense_sizes,
                                                       bucket_key, dense_slot_rows)
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.physics.multi_scale_graph import create_all_edges
from sgnn_tpu_torch.physics.rollout import rollout
from sgnn_tpu_torch.physics.sphere_graph import build_graph
from sgnn_tpu_torch.utils import profiling
from sgnn_tpu_torch.utils.profiling import trace_region

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]
CLOCK_SLACK_US = 100.0  # a port span and a profiler range inside it, on the trace's clock


@pytest.fixture(autouse=True)
def fresh():
    assert not torch.autograd.profiler._is_profiler_enabled
    profiling.reset()
    yield
    profiling.reset()


def _profile():
    return torch.profiler.profile(activities=CPU)


def _by_name(recs):
    out = {}
    for s in recs:
        out.setdefault(s.name, []).append(s)
    return out


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read while recording is off")


def _loop_bare(it):
    for _ in it:
        with profiling._OFF:
            with profiling._OFF:
                pass


def _loop_spans(it):
    for _ in it:
        with trace_region("feed.build"):
            with trace_region("feed.wait", seq=3):
                pass


def _traced_bytes(loop):
    """(current, peak) bytes that tracemalloc traced over 10,000 turns of
    ``loop``, run once before to warm it, over an iterator made beforehand."""
    loop(itertools.repeat(None, 10_000))
    it = itertools.repeat(None, 10_000)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        loop(it)
        return tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()


def test_off_records_nothing_allocates_nothing_reads_no_clock(monkeypatch):
    """Off: the shared no-op, no record, no clock read, and no more memory
    traced over 10,000 calls (with attributes and without) than the bare
    no-op's loop (nothing kept, no transient beyond it)."""
    monkeypatch.setattr(profiling, "time", _NoClock())
    assert trace_region("feed.build") is trace_region("feed.wait", seq=3) is profiling._OFF
    with trace_region("rollout"):
        with trace_region("rollout.inputs", steps=39):
            pass
    bare, spans = _traced_bytes(_loop_bare), _traced_bytes(_loop_spans)
    assert spans[0] == 0 and spans[1] <= bare[1], (spans, bare)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_on_records_names_nesting_parents_and_roots():
    with _profile():
        with trace_region("rollout", case=7):
            with trace_region("rollout.inputs"):
                pass
            with trace_region("rollout.replays", steps=3):
                with trace_region("step.warmup"):
                    pass
                with trace_region("step.capture"):
                    pass
        with trace_region("load.read"):
            pass
    with trace_region("rollout"):  # the profile has ended: not kept
        pass
    recs = profiling.spans()
    assert [s.name for s in recs] == ["rollout", "rollout.inputs", "rollout.replays", "step.warmup",
                                      "step.capture", "load.read"]
    assert [s.index for s in recs] == list(range(6))
    assert [s.parent for s in recs] == [-1, 0, 0, 2, 2, -1]
    assert [s.root for s in recs] == [0, 0, 0, 0, 0, 5]
    assert recs[0].attrs == {"case": 7} and recs[2].attrs == {"steps": 3} and recs[1].attrs is None
    assert len({s.tid for s in recs}) == 1 and recs[0].tid == threading.get_native_id()
    for s in recs:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = recs[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    assert recs[3].end_ns <= recs[4].start_ns


def _host_batches(n):
    rng = np.random.default_rng(0)
    return [{"positions": rng.normal(size=(2, 8, 3, 2)).astype(np.float32), "step": i} for i in range(n)]


def test_prefetcher_thread_spans_pair_up_by_sequence_number():
    batches = _host_batches(4)
    with _profile():
        with DevicePrefetcher(iter(batches), depth=2, device="cpu") as feed:
            got = list(feed)
    assert [b["step"] for b in got] == [0, 1, 2, 3]
    named = _by_name(profiling.spans())
    worker = {s.tid for s in named["feed.build"] + named["feed.stage"]}
    (consumer,) = {s.tid for s in named["feed.wait"]}
    assert len(worker) == 1 and consumer not in worker and consumer == threading.get_native_id()
    for seq in range(4):
        (build,) = [s for s in named["feed.build"] if s.attrs["seq"] == seq]
        (stage,) = [s for s in named["feed.stage"] if s.attrs["seq"] == seq]
        (wait,) = [s for s in named["feed.wait"] if s.attrs["seq"] == seq]
        assert build.end_ns <= stage.start_ns and stage.end_ns <= wait.end_ns
        assert build.parent == stage.parent == wait.parent == -1
    # the end of the stream: one more ask of the batcher and one more wait
    assert {s.attrs["seq"] for s in named["feed.build"]} <= {0, 1, 2, 3, 4}
    assert sorted(s.attrs["seq"] for s in named["feed.wait"]) == [0, 1, 2, 3, 4]
    assert len(named["feed.stage"]) == 4


def _trace_events(path):
    with open(path) as f:
        return json.load(f)


def test_a_profiler_range_inside_a_span_lies_inside_it_on_the_trace_clock(tmp_path):
    profiling.start_trace(str(tmp_path))
    with torch.profiler.record_function("warm"):  # the profiler's first range pays its own set-up
        pass
    for _ in range(3):
        with trace_region("train.step"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
    trace = _trace_events(profiling.stop_trace())
    outer = sorted((e for e in trace["traceEvents"] if e.get("cat") == profiling.SPAN_CATEGORY), key=lambda e: e["ts"])
    inner = sorted((e for e in trace["traceEvents"] if e.get("name") == "inner" and e.get("ph") == "X"),
                   key=lambda e: e["ts"])
    assert len(outer) == len(inner) == 3
    for o, i in zip(outer, inner):
        assert o["name"] == "train.step" and o["ph"] == "X"
        assert i["ts"] >= o["ts"] - CLOCK_SLACK_US, (o, i)
        assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + CLOCK_SLACK_US, (o, i)


def test_stop_trace_writes_the_spans_of_both_threads(tmp_path):
    with _profile():
        with trace_region("load.read"):  # an earlier profile: not in the next trace
            pass
    profiling.start_trace(str(tmp_path))

    def other():
        with trace_region("feed.build", seq=0):
            with trace_region("feed.stage", seq=0):
                pass

    thread = threading.Thread(target=other)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    with trace_region("feed.wait", seq=0):
        pass
    trace = _trace_events(profiling.stop_trace())
    events = trace["traceEvents"]
    mine = [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]
    assert sorted(e["name"] for e in mine) == ["feed.build", "feed.stage", "feed.wait"]
    tids = {e["name"]: e["tid"] for e in mine}
    assert tids["feed.build"] == tids["feed.stage"] != tids["feed.wait"]
    named = {e["tid"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert set(tids.values()) <= named
    stage = next(e for e in mine if e["name"] == "feed.stage")
    build = next(e for e in mine if e["name"] == "feed.build")
    assert stage["args"]["parent"] == build["args"]["index"] == stage["args"]["root"]
    assert stage["args"]["seq"] == 0 and stage["dur"] >= 0
    assert trace["portSpansDropped"] == 0
    assert len(profiling.spans()) == 4  # the buffer keeps every record until reset()


S = 4  # input sequence length of the tiny requests


def _lattice_trajectory(rng, nx, ny, frames):
    xs, ys = np.meshgrid(np.arange(nx) * 0.5, np.arange(ny) * 0.5, indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], -1) + rng.normal(scale=0.01, size=(nx * ny, 2))
    pos = grid[None] + rng.normal(scale=0.005, size=(frames, nx * ny, 2)).cumsum(axis=0)
    n = nx * ny
    return pos.astype(np.float32), np.zeros(n, np.int32), rng.normal(size=(frames, n)).astype(np.float32)


def _write_split(path, n_traj=1):
    rng = np.random.default_rng(1)
    np.savez(path, trajectories={f"case{i}": _lattice_trajectory(rng, 12, 5, S + 3) for i in range(n_traj)})


def _stats():
    return tsim.NormStats(*(torch.full((2,), v) for v in (0.01, 0.05, 0.001, 0.01)))


def _assert_request(recs, loader_names):
    named = _by_name(recs)
    for name in loader_names:
        assert name in named, (name, sorted(named))
        assert all(s.parent == -1 for s in named[name])
    (root,) = named["rollout"]
    assert root.parent == -1
    for name in ("rollout.inputs", "rollout.replays"):
        (s,) = named[name]
        assert s.parent == root.index and s.root == root.index
    assert named["rollout.replays"][0].attrs == {"steps": 3}
    assert "step.warmup" not in named and "step.capture" not in named  # the CPU captures nothing


def test_a_tiny_single_scale_request_gives_its_spans(tmp_path):
    path = tmp_path / "test.npz"
    _write_split(path)
    cfg = tsim.SimulatorConfig(dim=2, latent_dim=16, num_message_passing_steps=1, num_mlp_layers=1,
                               connectivity_radius=0.6, input_sequence_length=S, max_neighbors=12)
    sim = tsim.simulator_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with _profile():
        item = next(iter(TrajectoryLoader(path, pad_multiple=32)))
        out = rollout(sim, cfg, _stats(), item["positions"], item["particle_type"], item["strains"],
                      item["node_mask"], device="cpu")
    assert out["predicted_rollout"].shape == (3, 64, 2)
    recs = profiling.spans()
    assert [s.name for s in recs if s.name.startswith(("load.", "graph."))] == ["load.read", "load.pad"]
    _assert_request(recs, ("load.read", "load.pad"))


def test_a_tiny_multi_scale_request_gives_its_spans(tmp_path):
    path = tmp_path / "test.npz"
    _write_split(path, n_traj=2)
    cfg = tms.MultiScaleSimulatorConfig(dim=2, latent_dim=16, num_message_passing_steps=1, num_mlp_layers=2,
                                        input_sequence_length=S, num_scales=2, window_size=2)
    sim = tms.multi_scale_simulator_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with _profile():
        item = next(iter(MultiScaleTrajectoryLoader(path, ms_cfg=cfg.graph_config, pad_multiple=32,
                                                    edge_pad_multiple=256, dense=True)))
        tms.ms_rollout(sim, cfg, _stats(), item["positions"], item["particle_type"], item["strains"], item["graph"],
                       node_mask=item["node_mask"], device="cpu")
    recs = profiling.spans()
    # one search per trajectory of the split, then its layout, then the request's padding
    assert [s.name for s in recs if s.name.startswith(("load.", "graph."))] == [
        "load.read", "graph.search", "graph.search", "graph.layout", "load.pad"]
    _assert_request(recs, ("load.read", "graph.search", "graph.layout", "load.pad"))
    # the serving loader's layout: its shape bucket, and the slot-rows it costs over the split's own
    (layout,) = _by_name(recs)["graph.layout"]
    assert layout.attrs["bucket"] == bucket_key(bucket_dense_sizes(
        _split_dense_sizes([create_all_edges(cfg.graph_config, pos[0]) for pos, _, _ in load_trajectories(path)]),
        64, cfg.graph_config.max_neighbors))
    assert 0 < layout.attrs["own_slot_rows"] <= layout.attrs["padded_slot_rows"]
    assert layout.attrs["padded_slot_rows"] == dense_slot_rows(
        {"g2m": item["graph"].g2m.senders.shape + (0, 0), "m2g": item["graph"].m2g.senders.shape + (0, 0),
         "m2m": [de.senders.shape + (0, 0) for de in item["graph"].m2m]}, 6)


def test_a_tiny_graphcast_build_gives_its_spans_and_edge_counts():
    """GraphCast's graphs at a 10 degree grid and mesh level 2: the four
    ``graph.*`` spans with their nodes, edges and largest in-degree; the
    counter holds each stage's valid edges and padded rows (multiples of 64)."""
    with _profile():
        g = build_graph(10.0, 2, 0.6, 64)
    spans = {s.name: s.attrs for s in profiling.spans() if s.name.startswith("graph.")}
    assert spans["graph.grid"] == {"nodes": 684, "edges": 0, "max_in_degree": 0}
    # the 12 icosahedron vertices have 5 neighbours at each of the 3 levels
    assert spans["graph.multimesh"] == {"nodes": 162, "edges": 1260, "max_in_degree": 15}
    assert spans["graph.g2m"]["nodes"] == 162 and spans["graph.g2m"]["edges"] == g.edge_counts["g2m"][0]
    assert spans["graph.m2g"] == {"nodes": 684, "edges": 3 * 684, "max_in_degree": 3}
    assert g.edge_counts["m2m"] == (1260, 1280) and g.edge_counts["m2g"] == (2052, 2112)


def test_many_threads_record_at_once():
    """More threads than cores, switching every microsecond: every span kept
    once, at its own index, its parent the enclosing span of its own thread."""
    threads, per_thread = 12, 150
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            def work(k):
                for i in range(per_thread):
                    with trace_region("feed.build", seq=i, thread=k):
                        with trace_region("feed.stage", seq=i, thread=k):
                            pass

            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.spans()
    assert len(recs) == threads * per_thread * 2
    assert [s.index for s in recs] == list(range(len(recs)))
    for s in recs:
        if s.name == "feed.stage":
            up = recs[s.parent]
            assert up.name == "feed.build" and up.tid == s.tid and up.attrs == s.attrs and s.root == up.index
        else:
            assert s.parent == -1 and s.root == s.index
    assert len({s.tid for s in recs}) == threads


def test_the_buffer_is_bounded_and_reset_clears_it(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _profile():
        with trace_region("rollout"):
            profiling.reset()  # the open span has no index in the new buffer: the next is a root
            with trace_region("rollout.inputs"):
                pass
        for _ in range(4):
            with trace_region("load.read"):
                pass
    recs = profiling.spans()
    assert [s.name for s in recs] == ["rollout.inputs", "load.read", "load.read"]
    assert recs[0].parent == -1 and recs[0].root == 0
    assert profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0
