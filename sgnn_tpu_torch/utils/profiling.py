"""Profiling hooks: ``torch.profiler`` traces, the port's own spans, and
the trace summary.

The port of ``sgnn_tpu/utils/profiling.py``. Usage::

    start_trace(logdir)           # CPU ops, and the card's kernels on CUDA
    with trace_region("feed.wait", seq=3):
        ...                       # a span of the port (see below)
    path = stop_trace()           # writes logdir/trace-<pid>-<n>.json
    rows = summarize_trace(logdir, steps=3)

``trace_region(name, **attrs)`` is the port's span. It records only while a
``torch.profiler`` profile is active (``start_trace``, or any other
profile, such as a benchmark's traced stretch); otherwise it is one
attribute read that returns a shared no-op context manager, with no
allocation and no clock read. A record (``Span``) holds the name, start
and end in ns on the profiler trace's clock (``time.time_ns()``: a Chrome
trace places an event at ``ts * 1000 + baseTimeNanoseconds``), the native
thread id, the index of the enclosing span on the same thread (-1 for
none), the index of the outermost one (``root``: a request's identifier)
and the attributes. Records of every thread go to one bounded in-memory
buffer, in the order the spans were entered, so a record's ``index`` is
its position in ``spans()``; once it holds ``MAX_SPANS`` further spans are
counted in ``dropped()`` and not kept. ``reset()`` clears both. Spans on
threads that ``torch.profiler`` does not follow (the prefetcher's) are
kept too: ``stop_trace`` merges the records of its trace, of every thread,
into the Chrome trace it writes, as ``X`` events of category
``port_span`` on that trace's own clock, so the feed's thread shows beside
the card's kernels. Spans are not also ``record_function`` ranges.

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
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.autograd.profiler as _profiler  # its _is_profiler_enabled: True while a profile is active

# the trace categories of work on the card (kernels and copies)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATEGORY = "port_span"  # the merged spans' category in a Chrome trace
MAX_SPANS = 1 << 16  # records kept until reset(); later spans are counted as dropped

_active: Optional[torch.profiler.profile] = None
_logdir: Optional[str] = None
_started_ns = 0
_count = 0

_OFF = contextlib.nullcontext()
_lock = threading.Lock()  # the buffer, the drop count and the generation
_records: List["Span"] = []
_dropped = 0
_generation = 0  # bumped by reset(): a span entered before it has no index in the buffer
_thread = threading.local()  # per thread: (stack of open spans, native thread id)


class Span:
    """One span: a record and the context manager that stamps it. ``end_ns``
    is None while it is open; ``index`` is None if the buffer was full."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "tid", "index", "parent", "root", "_generation")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = self.index = self.root = self.tid = None
        self.parent = -1

    def __enter__(self) -> "Span":
        global _dropped
        local = getattr(_thread, "state", None)
        if local is None:
            local = _thread.state = ([], threading.get_native_id())
        stack, self.tid = local
        outer = stack[-1] if stack else None
        with _lock:
            self._generation = _generation
            if outer is not None and outer.index is not None and outer._generation == _generation:
                self.parent, self.root = outer.index, outer.root
            if len(_records) < MAX_SPANS:
                self.index = len(_records)
                if self.parent == -1:
                    self.root = self.index
                _records.append(self)
            else:
                _dropped += 1
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _thread.state[0].pop()
        return False


def trace_region(name: str, **attrs):
    """The port's span ``name`` with the attributes ``attrs`` (see the
    module docstring): recorded while a ``torch.profiler`` profile is
    active, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs or None)


def spans() -> List[Span]:
    """The records kept since the last ``reset()``, in the order entered
    (``spans()[i].index == i``); open spans have ``end_ns`` None."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept since the last ``reset()`` because the buffer was full."""
    return _dropped


def reset() -> None:
    """Clear the records and the drop count."""
    global _dropped, _generation
    with _lock:
        _records.clear()
        _dropped = 0
        _generation += 1


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` trace (the card's activity too where
    CUDA is available), written to ``logdir`` by ``stop_trace``."""
    global _active, _logdir, _started_ns
    if _active is not None:
        raise RuntimeError("a trace is already running; stop_trace() first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    _started_ns = time.time_ns()
    prof.__enter__()
    _active, _logdir = prof, logdir


def stop_trace() -> str:
    """Stop the trace and write its Chrome-trace JSON, the port's spans of
    the trace merged in; returns its path."""
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
    merge_spans(path, [s for s in spans() if s.end_ns is not None and s.start_ns >= _started_ns])
    return path


def merge_spans(path: str, records: Sequence[Span]) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as ``X`` events on
    its clock (``ts`` in microseconds after ``baseTimeNanoseconds``), in
    this process, on their own threads (named where the trace names none),
    with the drop count under ``portSpansDropped``."""
    with open(path) as f:
        trace = json.load(f)
    if isinstance(trace, list):
        trace = {"traceEvents": trace}
    events = trace["traceEvents"]
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    named = {ev.get("tid") for ev in events if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    for tid in sorted({s.tid for s in records} - named):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"thread {tid} (port spans)"}})
    for s in records:
        args: Dict[str, object] = {"index": s.index, "parent": s.parent, "root": s.root}
        args.update(s.attrs or {})
        events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid, "tid": s.tid,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    trace["portSpansDropped"] = _dropped
    with open(path, "w") as f:
        json.dump(trace, f)


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
