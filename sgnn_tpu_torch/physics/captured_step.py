"""The rollout step captured in a CUDA graph and replayed: the port of JAX's
``make_jit_rollout`` (``sgnn_tpu/train/train.py:288-296``,
``sgnn_tpu/train/train_multi_scale.py:149-157``).

JAX compiles a whole rollout, the ``lax.scan`` over its steps
(``sgnn_tpu/physics/rollout.py:103``), into one program. Here ONE step is
captured and replayed once per step, so that the graph does not depend on
the trajectory's length and its capture costs one step:

  * a step is ``step(window, gt_pos, gt_strain, **fixed) -> (new window,
    next_pos, strain, *extra)`` (``physics/rollout.rollout_step``,
    ``physics/multi_scale_simulator.ms_rollout_step``; the graph-partitioned
    step of ``parallel/edge_partition.py`` adds one extra output, its halo
    guard's count); ``fixed`` holds what stays the same over a trajectory:
    particle types, the erosional mask, and the node mask or the static
    multi-scale graph;
  * ``CapturedStep`` keeps static buffers for all of them and for the
    step's two outputs, and ``body`` runs the step on those buffers. It
    computes the new window first and then copies it over the old one (a
    shift of the window into itself would read what it had just written);
  * per step, outside the graph: the step's ground truth copied in (two
    copies), one graph launch, the outputs copied out (two copies); the
    host loop over the steps is the span ``rollout.replays``;
  * the first call on the card runs its first step eagerly on a side
    stream (the warm-up: the kernels are built, cuBLAS makes its handles
    and every cache is filled, so none of that happens under capture),
    then captures ``body`` (in the ``thread_local`` error mode: the
    trainers' validation captures while their prefetcher's thread pins and
    copies batches) and replays it for the other steps. A capture that
    fails raises: nothing retreats to the eager loop. The two are the
    spans ``step.warmup`` and ``step.capture``, and ``CAPTURES`` counts
    them (always on; ``physics/rollout`` and ``ms_rollout`` open the
    request's root span ``rollout``);
  * on CPU tensors ``body`` runs eagerly on the same buffers, so the CPU
    tests drive the same code; ``roll(..., capture=False)`` is the eager
    loop, kept for comparisons;
  * ``CapturedStep.call`` runs one step on inputs the caller sets anew each
    time (the replanning rollout of ``parallel/edge_partition.py``, which
    re-sorts the window between steps); ``capture=False`` runs ``body``
    eagerly over the buffers (a step whose shards span several devices).

The graph bakes in the addresses of everything it reads. Its cache is
kept per module (``cached_step``) and keyed on the addresses, shapes and
dtypes of the module's tensors and of the normalisation statistics, on
the config, the mode and the buffers' shapes: Adam and ``load_state_dict``
update parameters in place and keep the graph valid; whatever replaces a
parameter's storage changes the key, and the next call captures anew.

The kernels' wrappers count their launches in Python, so they count when
a step is captured, not when the graph runs. ``LaunchRecord`` takes the
capture's counts back and adds them again at every replay, so that the
counters go on counting kernel launches on the card.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from sgnn_tpu_torch.ops import edge_block, edge_epilogue, f32_product, row_gather, sym_gather
from sgnn_tpu_torch.utils.profiling import trace_region

# the kernels' launch counters, each an int or a dict of ints: (module, attribute)
COUNTERS = [
    (edge_block, "LAUNCHES"),
    (edge_block, "BWD_LAUNCHES"),
    (edge_block, "FWD_VARIANT_LAUNCHES"),
    (row_gather, "LAUNCHES"),
    (row_gather, "BWD_LAUNCHES"),
    (sym_gather, "BWD_CALLS"),
    (sym_gather, "BANDED"),
    (edge_epilogue, "LAUNCHES"),
    (edge_epilogue, "BWD_LAUNCHES"),
    (f32_product, "LAUNCHES"),
]
MAX_CACHED = 4  # captured steps kept per module; the least recently used goes first
CAPTURES = 0  # rollout steps captured (each after its eager warm-up step) in this process

Step = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _counts() -> Dict[tuple, int]:
    out = {}
    for i, (mod, attr) in enumerate(COUNTERS):
        value = getattr(mod, attr)
        if isinstance(value, dict):
            out.update({(i, k): n for k, n in value.items()})
        else:
            out[(i, None)] = value
    return out


def _add(delta: Dict[tuple, int], sign: int) -> None:
    for (i, key), n in delta.items():
        mod, attr = COUNTERS[i]
        if key is None:
            setattr(mod, attr, getattr(mod, attr) + sign * n)
        else:
            getattr(mod, attr)[key] += sign * n


class LaunchRecord:
    """The launches that a capture recorded: taken back from the counters
    at capture (nothing ran on the card), added at every replay."""

    def __init__(self, delta: Dict[tuple, int]):
        self.delta = delta

    @classmethod
    def around(cls, capture: Callable[[], None]) -> "LaunchRecord":
        before = _counts()
        try:
            capture()
        finally:
            after = _counts()
            delta = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
            _add(delta, -1)
        return cls(delta)

    def replayed(self) -> None:
        _add(self.delta, 1)


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree (dicts, NamedTuples, tuples, None)
    and the trees of the same structure in ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"a step's inputs are trees of tensors, got {type(tree).__name__}")


def _spec(tree):
    """The structure, shapes, dtypes and devices of a tree, hashable."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _spec(v)) for k, v in sorted(tree.items()))
    return (type(tree).__name__,) + tuple(_spec(x) for x in tree)


def tensors_key(tensors) -> tuple:
    """What a graph that reads ``tensors`` in place depends on: their
    addresses, shapes, strides and dtypes."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device) for t in tensors)


def module_key(module: torch.nn.Module) -> tuple:
    return tuple((name, *tensors_key([t])) for name, t in module.state_dict(keep_vars=True).items())


def _buffer(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype, device=t.device)


class CapturedStep:
    """Static buffers of one rollout step, and the step captured over them
    (on the card) or run over them eagerly (on the CPU)."""

    def __init__(self, window, gt_positions, gt_strains, fixed, capture: bool = True):
        self.device, self.capture = window.device, capture
        self.window = _buffer(window)  # [N, S, dim], shifted in place
        self.gt_pos = _buffer(gt_positions, gt_positions.shape[1:])  # [N, dim]
        self.gt_strain = _buffer(gt_strains, gt_strains.shape[1:])  # [N]
        self.next_pos = _buffer(self.gt_pos)
        self.strain = _buffer(self.gt_strain)
        self.fixed = _tree_map(_buffer, fixed)
        self.extra: Optional[List[torch.Tensor]] = None  # the step's extra outputs, made by its first run
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[LaunchRecord] = None
        self.capture_seconds: Optional[float] = None  # host time of the capture (the warm-up step apart)
        self.replays = 0
        self._step: Optional[Step] = None  # set only inside run: the cache holds no module

    def body(self) -> None:
        """One step over the static buffers, launched eagerly (or captured)."""
        window, next_pos, strain, *extra = self._step(self.window, self.gt_pos, self.gt_strain, **self.fixed)
        self.window.copy_(window)
        self.next_pos.copy_(next_pos)
        self.strain.copy_(strain)
        if self.extra is None:
            self.extra = [_buffer(t) for t in extra]
        for buf, t in zip(self.extra, extra):
            buf.copy_(t)

    def run(self, step: Step, window, gt_positions, gt_strains, fixed) -> Tuple[torch.Tensor, ...]:
        """The trajectory from ``window`` over the ground truth ``gt_positions``
        [T, N, dim] and ``gt_strains`` [T, N]: (predicted positions [T, N,
        dim], predicted strains [T, N], *each extra output stacked [T, ...])."""
        self._step = step
        try:
            self.window.copy_(window)
            _tree_map(lambda buf, t: buf.copy_(t), self.fixed, fixed)
            pred_pos = gt_positions.new_empty(gt_positions.shape)
            pred_strain = gt_strains.new_empty(gt_strains.shape)
            extras = []
            with trace_region("rollout.replays", steps=gt_positions.shape[0]):
                for t in range(gt_positions.shape[0]):
                    self.gt_pos.copy_(gt_positions[t])
                    self.gt_strain.copy_(gt_strains[t])
                    self._advance()
                    pred_pos[t].copy_(self.next_pos)
                    pred_strain[t].copy_(self.strain)
                    extras.append([e.clone() for e in self.extra])
            return (pred_pos, pred_strain, *(torch.stack(e) for e in zip(*extras)))
        finally:
            self._step = None

    def call(self, step: Step, window, gt_pos, gt_strain, fixed) -> Tuple[torch.Tensor, ...]:
        """One step on these inputs: (new window, next_pos, strain, *extra),
        the static buffers themselves (read them before the next call)."""
        self._step = step
        try:
            self.window.copy_(window)
            self.gt_pos.copy_(gt_pos)
            self.gt_strain.copy_(gt_strain)
            _tree_map(lambda buf, t: buf.copy_(t), self.fixed, fixed)
            self._advance()
            return (self.window, self.next_pos, self.strain, *self.extra)
        finally:
            self._step = None

    def _advance(self) -> None:
        if self.device.type != "cuda" or not self.capture:
            self.body()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.launches.replayed()
            self.replays += 1

    def _warm_up_and_capture(self) -> None:
        """This step eagerly on a side stream, then ``body`` captured
        (spans ``step.warmup`` and ``step.capture``; counted in ``CAPTURES``)."""
        global CAPTURES
        current = torch.cuda.current_stream(self.device)
        with trace_region("step.warmup"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.body()
            current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()

        def capture():  # thread_local: the training prefetcher's thread may stage a batch meanwhile
            with torch.cuda.device(self.device), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.body()

        t0 = time.perf_counter()
        with trace_region("step.capture"):
            self.launches = LaunchRecord.around(capture)
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        CAPTURES += 1


_CACHE: "weakref.WeakKeyDictionary[torch.nn.Module, OrderedDict]" = weakref.WeakKeyDictionary()


def cached_step(owner: torch.nn.Module, key: tuple, make: Callable[[], CapturedStep]) -> CapturedStep:
    """The captured step of ``owner`` under ``key``, made by ``make`` if none."""
    steps = _CACHE.setdefault(owner, OrderedDict())
    step = steps.get(key)
    if step is None:
        step = steps[key] = make()
        while len(steps) > MAX_CACHED:
            steps.popitem(last=False)
    steps.move_to_end(key)
    return step


def steps_of(owner: torch.nn.Module) -> List[CapturedStep]:
    """The captured steps kept for ``owner``, the most recently used last."""
    return list(_CACHE.get(owner, {}).values())


def roll(
    step: Step,
    window: torch.Tensor,  # [N, S, dim]
    gt_positions: torch.Tensor,  # [T, N, dim]
    gt_strains: torch.Tensor,  # [T, N]
    fixed: dict,
    *,
    capture: bool,
    owner: torch.nn.Module,
    key: tuple,
) -> Tuple[torch.Tensor, ...]:
    """(predicted positions [T, N, dim], strains [T, N], *the step's extra
    outputs stacked [T, ...]) of the rollout of ``step``: through
    ``owner``'s ``CapturedStep`` under ``key`` (and the shapes of the
    inputs), or with ``capture=False`` the eager loop."""
    if not capture:
        outs = []
        for gt_pos, gt_strain in zip(gt_positions, gt_strains):
            window, *out = step(window, gt_pos, gt_strain, **fixed)
            outs.append(out)
        return tuple(torch.stack(o) for o in zip(*outs))
    # not the trajectory's length: the graph is one step's
    per_step = [(tuple(t.shape[1:]), t.dtype, t.device) for t in (gt_positions, gt_strains)]
    key = (*key, _spec(window), *per_step, _spec(fixed))
    captured = cached_step(owner, key, lambda: CapturedStep(window, gt_positions, gt_strains, fixed))
    return captured.run(step, window, gt_positions, gt_strains, fixed)
