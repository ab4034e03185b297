"""The union of device intervals, the idle share and the gaps' labels on a
small synthetic Chrome trace."""

import json

import pytest

from h100_bench import trace


def _events():
    x = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}  # noqa: E731
    return [
        x("bench.window", "user_annotation", 100.0, 100.0),
        x("bench.feed", "user_annotation", 100.0, 30.0),
        x("bench.step", "user_annotation", 130.0, 70.0),
        x("void k_a<float>(int)", "kernel", 90.0, 20.0),  # clipped to [100, 110]
        x("k_b", "kernel", 105.0, 10.0),  # overlaps k_a: union [100, 115]
        x("Memcpy HtoD", "gpu_memcpy", 140.0, 20.0),  # [140, 160]
        x("k_b", "kernel", 190.0, 30.0),  # clipped to [190, 200]
        x("cpu_thing", "cpu_op", 100.0, 100.0),  # not on the device
    ]


def test_union_busy_and_idle():
    b = trace.breakdown(_events())
    assert b["window_s"] == pytest.approx(100e-6)
    assert b["busy_s"] == pytest.approx((15 + 20 + 10) * 1e-6)
    assert b["per_name"]["k_b"] == (pytest.approx(20e-6), 2)
    assert dict(b["device_ops"])["k_a"] == pytest.approx(10e-6)


def test_gaps_longest_first_with_host_span():
    b = trace.breakdown(_events())
    gaps = b["idle_gaps"]
    assert [g[0] for g in gaps] == ["step", "feed"]
    assert gaps[0][1] == pytest.approx(30e-6) and gaps[1][1] == pytest.approx(25e-6)


def test_no_window_no_breakdown(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()[1:]}))
    assert trace.breakdown(trace.load(str(path))) is None


def test_kernel_seconds_by_pattern():
    b = trace.breakdown(_events())
    sec, n = trace.kernel_seconds(b["per_name"], r"k_\w")
    assert n == 3 and sec == pytest.approx(30e-6)
