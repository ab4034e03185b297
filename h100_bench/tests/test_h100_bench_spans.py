"""The readers of the port's own spans (``feed_busy_ms.train``,
``capture_ms.rollout``, ``load_ms.rollout``, ``graph_search_ms.rollout``):
None with no records, None on a port that keeps none, and the documented
mean per batch or per request on synthetic records."""

from types import SimpleNamespace

import pytest

from h100_bench import harness

READERS = ["feed_busy_ms.train", "capture_ms.rollout", "load_ms.rollout", "graph_search_ms.rollout"]
MS = 1_000_000  # ns


def _reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"h100_bench.metrics.{name}")


class _Records:
    """Synthetic records in the port's order: ``add`` enters a span (its
    parent and root from ``parent``) lasting ``ms`` milliseconds."""

    def __init__(self):
        self.items = []
        self.at = 0

    def add(self, name, ms, parent=None, tid=1, end=True, **attrs):
        index = len(self.items)
        root = index if parent is None else parent.root
        span = SimpleNamespace(name=name, index=index, parent=-1 if parent is None else parent.index, root=root,
                               tid=tid, start_ns=self.at, end_ns=self.at + int(ms * MS) if end else None,
                               attrs=attrs or None)
        self.items.append(span)
        self.at += 1
        return span


@pytest.fixture
def port(monkeypatch):
    from sgnn_tpu_torch.utils import profiling

    recs = _Records()
    monkeypatch.setattr(profiling, "spans", lambda: list(recs.items))
    return recs


@pytest.mark.parametrize("name", READERS)
def test_no_records_read_none(port, name):
    assert _reader(name).read(None, None) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_spans_reads_none(monkeypatch, name):
    from sgnn_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _reader(name).read(None, None) is None


def test_feed_busy_is_build_plus_stage_per_whole_batch(port):
    port.add("feed.wait", 9.0, tid=2, seq=0)  # the consumer's wait: not busy time
    port.add("feed.build", 2.0, seq=0)
    port.add("feed.stage", 1.0, seq=0)
    port.add("feed.build", 4.0, seq=1)
    port.add("feed.stage", 1.5, seq=1)
    port.add("feed.build", 7.0, seq=2)  # staged after the trace: left out
    port.add("feed.stage", 3.0, seq=3)  # built before it: left out
    port.add("feed.build", 5.0, seq=4, end=False)  # still open
    port.add("feed.stage", 1.0, seq=4)
    assert _reader("feed_busy_ms.train").read(None, None) == pytest.approx((3.0 + 5.5) / 2)


def test_feed_busy_pairs_by_thread_too(port):
    port.add("feed.build", 2.0, tid=1, seq=0)
    port.add("feed.build", 6.0, tid=3, seq=0)  # another prefetcher's batch 0
    port.add("feed.stage", 1.0, tid=1, seq=0)
    port.add("feed.stage", 1.0, tid=3, seq=0)
    assert _reader("feed_busy_ms.train").read(None, None) == pytest.approx((3.0 + 7.0) / 2)


def test_capture_is_warmup_plus_capture_per_request(port):
    first = port.add("rollout", 100.0)
    loop = port.add("rollout.replays", 90.0, parent=first)
    port.add("step.warmup", 10.0, parent=loop)
    port.add("step.capture", 30.0, parent=loop)
    second = port.add("rollout", 50.0)
    port.add("rollout.replays", 40.0, parent=second)  # replays a capture: none
    port.add("step.capture", 500.0)  # outside any request: not counted
    assert _reader("capture_ms.rollout").read(None, None) == pytest.approx((10.0 + 30.0) / 2)


def test_capture_is_zero_where_no_request_captured(port):
    for _ in range(3):
        root = port.add("rollout", 40.0)
        port.add("rollout.replays", 39.0, parent=root)
    assert _reader("capture_ms.rollout").read(None, None) == 0.0


def _served_requests(port, multi_scale):
    for _ in range(2):
        port.add("load.read", 5.0)
        if multi_scale:
            port.add("graph.search", 3.0)
            layout = port.add("graph.layout", 1.0)
            port.add("load.pad", 0.25, parent=layout)  # nested in a counted span: counted once
        port.add("load.pad", 1.0)
        root = port.add("rollout", 60.0)
        port.add("rollout.inputs", 2.0, parent=root)


def test_load_is_read_pad_search_and_layout_per_request(port):
    _served_requests(port, multi_scale=True)
    assert _reader("load_ms.rollout").read(None, None) == pytest.approx(5.0 + 3.0 + 1.0 + 1.0)
    assert _reader("graph_search_ms.rollout").read(None, None) == pytest.approx(3.0)


def test_single_scale_load_is_read_and_pad(port):
    _served_requests(port, multi_scale=False)
    assert _reader("load_ms.rollout").read(None, None) == pytest.approx(5.0 + 1.0)


def test_loads_without_a_request_read_none(port):
    port.add("load.read", 5.0)
    port.add("graph.search", 3.0)
    assert _reader("load_ms.rollout").read(None, None) is None
    assert _reader("graph_search_ms.rollout").read(None, None) is None


@pytest.mark.parametrize("cell", ["ss_f32_train", "ms_f32_train", "ss_f32_rollout", "ms_f32_rollout"])
def test_a_traced_tiny_run_reports_each_span_metric_its_entry_names(cell):
    """A whole ``--trace 1`` run at tiny sizes on the CPU: every new metric
    whose entry names the cell is in the result line."""
    from h100_bench.tests._tiny import load_run, tiny

    res = load_run().run(cell, 2 ** 31 + 17, 0.3, True, device="cpu", require_cuda=False, adjust=tiny)
    named = {m["name"] for m in harness.find_cell(cell).per_layer} & set(READERS)
    assert named and named <= set(res["metrics"]), (named, res["metrics"])
    assert all(res["metrics"][n]["value"] >= 0 for n in named)
