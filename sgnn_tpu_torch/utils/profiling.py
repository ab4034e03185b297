"""Profiling hooks: ``torch.profiler`` traces and per-step throughput
counters.

The port of ``sgnn_tpu/utils/profiling.py``. Usage::

    start_trace(logdir)           # CPU ops, and the card's kernels on CUDA
    with trace_region("train_step"):
        ...                       # a named range in the trace
    path = stop_trace()           # writes logdir/trace-<pid>-<n>.json
    rows = summarize_trace(logdir, steps=3)

    prof = StepProfiler(edges_per_step=...)
    prof.tick()                   # per step
    prof.summary()                # steps/s, edge updates/s

``summarize_trace`` reads the Chrome-trace JSON that ``torch.profiler``
exports and returns the rows of JAX's summary: per-kernel device time per
step, largest first, and a rollup per category of kernel name.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import time
from typing import Optional, Sequence

import torch

# the trace categories of work on the card (kernels and copies)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_active: Optional[torch.profiler.profile] = None
_logdir: Optional[str] = None
_count = 0


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` trace (the card's activity too where
    CUDA is available), written to ``logdir`` by ``stop_trace``."""
    global _active, _logdir
    if _active is not None:
        raise RuntimeError("a trace is already running; stop_trace() first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _active, _logdir = prof, logdir


def stop_trace() -> str:
    """Stop the trace and write its Chrome-trace JSON; returns its path."""
    global _active, _logdir, _count
    if _active is None:
        raise RuntimeError("no trace is running; start_trace() first")
    prof, logdir = _active, _logdir
    _active = _logdir = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    _count += 1
    path = os.path.join(logdir, f"trace-{os.getpid()}-{_count}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_region(name: str):
    """A named range in the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def _category(name: str) -> str:
    """The rollup key of a kernel name: its base name (no ``void``, scope,
    template or arguments) up to the first '.', '_' or digit."""
    base = re.sub(r"^void ", "", name)
    base = re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1]
    return re.split(r"[._\d]", base, maxsplit=1)[0] or base


def summarize_trace(
    logdir: str,
    top: int = 20,
    *,
    steps: Optional[int] = None,
    categories: Sequence[str] = DEVICE_CATEGORIES,
) -> list:
    """Per-op time of the newest trace under ``logdir`` (or of the file
    ``logdir`` names): ``[{name, ms_per_step, category: "op"}, ...]`` for
    the ``top`` largest, then one ``{name, ms_per_step, category:
    "rollup"}`` row per name category (JAX's rows, each with its
    ``launches_per_step`` too; the rollup rows add up to the whole
    trace). Events of the trace categories ``categories`` count (default:
    the card's kernels, copies and sets; ``("cpu_op",)`` reads a CPU-only
    trace). ``steps`` divides the totals;
    by default the trace's ``ProfilerStep`` ranges, else 1."""
    if os.path.isfile(logdir):
        path = logdir
    else:
        paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True), key=os.path.getmtime)
        if not paths:
            raise FileNotFoundError(f"no trace .json under {logdir}")
        path = paths[-1]
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    agg: collections.Counter = collections.Counter()
    cat: collections.Counter = collections.Counter()
    calls: collections.Counter = collections.Counter()
    cat_calls: collections.Counter = collections.Counter()
    marked = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "?")
        if name.startswith("ProfilerStep#"):
            marked += 1
        if ev.get("cat") not in categories:
            continue
        ms = float(ev.get("dur", 0.0)) / 1e3  # microseconds in the trace
        agg[name] += ms
        cat[_category(name)] += ms
        calls[name] += 1
        cat_calls[_category(name)] += 1
    steps = steps or max(1, marked)
    rows = [{"name": name, "ms_per_step": ms / steps, "category": "op", "launches_per_step": calls[name] / steps}
            for name, ms in agg.most_common(top)]
    rows += [{"name": name, "ms_per_step": ms / steps, "category": "rollup",
              "launches_per_step": cat_calls[name] / steps} for name, ms in cat.most_common()]
    return rows


class StepProfiler:
    """Lightweight throughput counter: steps/s and edge-updates/s."""

    def __init__(self, edges_per_step: Optional[int] = None):
        self.edges_per_step = edges_per_step
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def summary(self) -> dict:
        dt = time.perf_counter() - self._t0
        out = {
            "steps": self._steps,
            "elapsed_s": dt,
            "steps_per_s": self._steps / dt if dt > 0 else 0.0,
        }
        if self.edges_per_step:
            out["edge_updates_per_s"] = self._steps * self.edges_per_step / dt
        return out

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
