"""Reading a ``torch.profiler`` Chrome trace: per-kernel device time, the
union of busy intervals (the device's idle share), and the idle gaps by
what the benchmark's host code was doing.

``summarize`` is a frozen copy of ``sgnn_tpu_torch.utils.profiling.
summarize_trace`` (its per-name sums; the rollup by category is left
out); the union of intervals and the gaps are new here.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def load(path: str) -> List[dict]:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its namespaces, its template and
    its arguments."""
    base = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    return base.split("::")[-1] or name


def window_of(events: List[dict]) -> Optional[Tuple[float, float]]:
    """(start, end) in microseconds of the benchmark's traced window."""
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == WINDOW_SPAN and ev.get("cat") == "user_annotation":
            return float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
    return None


def device_intervals(events: List[dict], window: Tuple[float, float]) -> List[Tuple[float, float, str]]:
    """(start, end, name) of every kernel, copy and set on the device,
    clipped to the window (microseconds)."""
    lo, hi = window
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e, ev.get("name", "?")))
    return out


def summarize(intervals) -> Dict[str, Tuple[float, int]]:
    """Per name: (device seconds, launches)."""
    agg: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in intervals:
        agg[name][0] += (e - s) * 1e-6
        agg[name][1] += 1
    return {k: (v[0], int(v[1])) for k, v in agg.items()}


def busy_union(intervals) -> List[Tuple[float, float]]:
    """The union of the intervals, sorted and disjoint."""
    merged: List[List[float]] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(union) -> float:
    return sum(e - s for s, e in union) * 1e-6


def idle_gaps(union, window) -> List[Tuple[float, float]]:
    """The idle stretches of the window between busy intervals."""
    lo, hi = window
    gaps, at = [], lo
    for s, e in union:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def host_spans(events: List[dict]) -> List[Tuple[float, float, str]]:
    """The benchmark's own host spans (``bench.*`` record_function ranges)."""
    out = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" and str(ev.get("name", "")).startswith(
                SPAN_PREFIX) and ev["name"] != WINDOW_SPAN:
            s = float(ev["ts"])
            out.append((s, s + float(ev.get("dur", 0.0)), ev["name"]))
    return sorted(out)


def label_gap(gap, spans) -> str:
    """The innermost benchmark span around the gap's middle, else "host"."""
    mid = 0.5 * (gap[0] + gap[1])
    best = None
    starts = [s for s, _, _ in spans]
    for s, e, name in spans[:bisect.bisect_right(starts, mid)]:
        if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2][len(SPAN_PREFIX):] if best else "host"


def breakdown(events: List[dict], top: int = 10) -> Optional[dict]:
    """The traced window's device busy and length (seconds), its top
    device operations by name, and its longest idle gaps by host span."""
    window = window_of(events)
    if window is None:
        return None
    intervals = device_intervals(events, window)
    union = busy_union(intervals)
    per_name = summarize(intervals)
    by_short: Dict[str, float] = collections.defaultdict(float)
    for name, (sec, _) in per_name.items():
        by_short[short_name(name)] += sec
    spans = host_spans(events)
    gaps = sorted(idle_gaps(union, window), key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy_seconds(union),
        "window_s": (window[1] - window[0]) * 1e-6,
        "per_name": per_name,
        "device_ops": sorted(([k, v] for k, v in by_short.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[label_gap(g, spans), (g[1] - g[0]) * 1e-6] for g in gaps],
    }


def kernel_seconds(per_name: Dict[str, Tuple[float, int]], pattern: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose short name matches."""
    rx = re.compile(pattern)
    sec, n = 0.0, 0
    for name, (s, c) in per_name.items():
        if rx.fullmatch(short_name(name)):
            sec += s
            n += c
    return sec, n
