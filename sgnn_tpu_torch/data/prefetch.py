"""Background host-to-device batch prefetching.

The port's own copy of ``DevicePrefetcher`` (``sgnn_tpu/data/prefetch.py``),
which both JAX trainers run on every step. A daemon thread pulls batches
from the host iterator and stages them on the device, keeping ``depth``
batches in flight, so that batch assembly and the copy leave the training
step's critical path:

  * on CUDA the thread (on the consumer's device, ``torch.cuda.set_device``)
    pins each array of a batch, copies it with ``non_blocking=True`` on a
    side stream of its own, and records an event there. ``__next__`` makes
    the consumer's current stream wait on that event and calls
    ``record_stream`` on the staged tensors, so that the caching allocator
    does not hand their memory out again while the consumer's stream may
    still read it;
  * on the CPU ``put`` is a plain copy, so the CPU tests drive the same
    class;
  * ``put`` may be replaced (the JAX class's hook for shardings); it runs
    in the thread, on the side stream.

A batch is a tree of dicts, tuples and NamedTuples (the multi-scale
batch's static graph) whose numpy leaves become tensors; other leaves pass
through. A loader's error is raised by the ``__next__`` that reaches it;
``close()`` (or leaving the ``with`` block) stops the thread, also on an
infinite stream.

Spans (``utils/profiling.trace_region``, kept while a profile is active):
``feed.build`` (the host iterator producing a batch) and ``feed.stage``
(``_stage``) on the thread, ``feed.wait`` (the consumer's wait on the
queue) in ``__next__``, each with the batch's sequence number ``seq``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from sgnn_tpu_torch.utils.profiling import trace_region

_SENTINEL = object()
CLOSE_TIMEOUT_S = 10.0  # close() waits this long for a batch being staged


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and
    NamedTuples (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def to_device(batch, device: torch.device, non_blocking: bool = False):
    """A host batch on ``device``: numpy leaves (and tensors) as tensors
    there, other leaves as they are. ``non_blocking``: the arrays are
    pinned and copied asynchronously on the current stream."""

    def put(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if non_blocking and device.type == "cuda" and leaf.device.type == "cpu":
            leaf = leaf.pin_memory()
        return leaf.to(device, non_blocking=non_blocking)

    return tree_map(put, batch)


class DevicePrefetcher:
    """Iterator over the batches of ``iterable`` staged on ``device``, with
    up to ``depth`` staged ahead by a daemon thread. ``put(batch)`` replaces
    the default staging. Use it as a context manager or call ``close()``."""

    def __init__(
        self,
        iterable: Iterable[Any],
        depth: int = 2,
        device: Optional[torch.device] = None,
        put: Optional[Callable[[Any], Any]] = None,
    ):
        self._device = torch.device("cpu") if device is None else torch.device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._put = put or (lambda b: to_device(b, self._device, non_blocking=True))
        self._taken = 0  # items the consumer has taken: the next batch's sequence number
        self._thread = threading.Thread(target=self._worker, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _stage(self, batch, stream):
        if stream is None:
            return self._put(batch), None
        with torch.cuda.stream(stream):
            staged = self._put(batch)
            event = torch.cuda.Event()
            event.record(stream)
        return staged, event

    def _offer(self, item) -> bool:
        """Queue ``item`` unless the consumer closed; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator[Any]) -> None:
        try:
            stream = None
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            seq = 0
            while True:
                with trace_region("feed.build", seq=seq):
                    batch = next(it, _SENTINEL)
                if batch is _SENTINEL:
                    break
                with trace_region("feed.stage", seq=seq):
                    staged = self._stage(batch, stream)
                if not self._offer(staged):
                    return
                seq += 1
        except Exception as e:  # surface loader errors to the consumer
            self._offer(e)
            return
        self._offer(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        with trace_region("feed.wait", seq=self._taken):
            item = self._q.get()
        self._taken += 1
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        staged, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            tree_map(lambda t: t.record_stream(consumer) if isinstance(t, torch.Tensor) and t.is_cuda else None,
                     staged)
        return staged

    def close(self) -> None:
        self._stop.set()
        # drain so the worker unblocks promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=CLOSE_TIMEOUT_S)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
