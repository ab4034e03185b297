"""The training step captured in a CUDA graph and replayed: the port of
JAX's jitted train step (``make_train_step``, ``sgnn_tpu/train/train.py:
124-126``; ``sgnn_tpu/train/train_multi_scale.py:84-128``) and of its
``make_train_multi_step`` (``lax.scan`` over ``inner_steps``), for both
families.

``TrainStep`` is the step ``(batch, step, noise=None) -> metrics`` that the
trainers run: random-walk noise, the masked loss of ``loss_fn``, its
gradients and one Adam update at ``lr = sched(step)``, the step counted
before the update as optax does. It keeps static buffers for the batch
(the multi-scale static graph included), for the noise's standard-normal
draws ``z``, and for the metrics, and on the card:

  * the first call runs its step eagerly on a side stream (the warm-up:
    the kernels build, cuBLAS makes its handles and Adam its state), then
    sets the gradients to None and captures forward, ``backward`` and
    ``optimizer.step()`` in one graph (PyTorch's whole-network capture),
    in the ``thread_local`` error mode, so that the prefetcher's thread
    may pin and copy while the graph is captured. A capture that fails
    raises: nothing retreats to the eager loop;
  * every later call copies the batch into the buffers (device to
    device), draws into ``z`` from the generator (one launch, the same
    random stream as the eager step's), fills the lr, a device tensor of
    the capturable Adam, and replays the graph once. ``inner_steps`` are
    that many replays, each on its own batch: the math of JAX's scan, whose
    last metrics JAX reports; so do the trainers;
  * the metrics are the graph's static outputs, left on the device: read
    them before the next call overwrites them;
  * a call is the span ``train.step`` (``utils/profiling``), with
    ``train.warmup`` and ``train.capture`` inside the first.

The parallel steps are ``TrainStep``s too
(``parallel/data_parallel.DataParallelStep``,
``parallel/edge_partition.PartitionedTrainStep``): they replace ``update``
(the replicas' or shards' forward and backward, the gradient sum, Adam)
and, for data parallelism across processes, ``noise_shape`` (the global
batch's); ``capturable`` is False where their mesh spans several devices
or processes, and the body then runs eagerly over the buffers on the card
too. ``make_multi_step`` stacks steps as JAX's scanned multi-step does.

The graph bakes in the addresses of what it reads and writes, so it is
kept under a key of the parameters', Adam's state's and the lr's
addresses and of the batch's shapes: whatever replaces one of them (say,
``load_state_dict`` on the optimizer) makes the next call warm up and
capture anew. ``close()`` frees the graph and the buffers. On CPU tensors
the same body runs eagerly over the same buffers; ``capture=False`` is
the eager loop, kept for comparisons, and an injected ``noise`` (the
parity tests inject JAX's) takes it too. The kernels' launch counters
tick at capture; ``captured_step.LaunchRecord`` takes that back and adds
it at every replay.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from sgnn_tpu_torch.data.prefetch import tree_map
from sgnn_tpu_torch.physics.captured_step import LaunchRecord, _buffer, _spec, _tree_map
from sgnn_tpu_torch.physics.noise import draw_into, draw_shape, random_walk_position_noise
from sgnn_tpu_torch.utils.profiling import trace_region

Metrics = Dict[str, torch.Tensor]


def set_lr(optimizer: torch.optim.Optimizer, value: float) -> None:
    """Every group's lr to ``value``: in place where it is a device tensor
    (the capturable Adam's, which a graph reads), else as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


class TrainStep:
    """One training step over static buffers, captured in a CUDA graph on
    the card (see the module docstring). ``loss_fn(batch, noise) -> (loss,
    aux)``; ``sched(step) -> lr``; noise of std ``noise_std`` from
    ``generator`` (``noise_std`` None: no noise, ``loss_fn`` gets None)."""

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: torch.optim.Optimizer,
        sched: Callable[[int], float],
        noise_std: Optional[float],
        generator: Optional[torch.Generator] = None,
        *,
        capture: bool = True,
    ):
        self.loss_fn, self.optimizer, self.sched = loss_fn, optimizer, sched
        self.noise_std, self.generator, self.capture = noise_std, generator, capture
        # False: the step runs eagerly over its buffers on the card too (a
        # parallel step over a mesh of several devices, or of several processes)
        self.capturable = True
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[LaunchRecord] = None
        self.capture_seconds: Optional[float] = None  # host time of the capture (the warm-up apart)
        self.replays = 0
        self._key = None
        self.batch = self.z = self.metrics = None

    def update(self, batch, noise: torch.Tensor) -> Metrics:
        """The step's body on ``batch`` and ``noise``, launched eagerly (or
        captured): gradients, one Adam update, the metrics."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(batch, noise)
        loss.backward()
        self.optimizer.step()
        return {"train/loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def __call__(self, batch, step: int, noise: Optional[torch.Tensor] = None) -> Metrics:
        with trace_region("train.step"):
            set_lr(self.optimizer, self.sched(step))
            if noise is not None:
                return self.update(batch, noise)
            device = next(v for v in batch.values() if isinstance(v, torch.Tensor)).device
            if not self.capture:
                z = self._draws(batch, device)
                if z is not None:
                    draw_into(z, self.generator)
                return self.update(batch, self._noise(batch, z))
            if self._key_of(batch) != self._key:
                self.close()
                self.batch = _tree_map(_buffer, batch)
                self.z = self._draws(batch, device)
            _tree_map(lambda buf, t: buf.copy_(t), self.batch, batch)
            if self.z is not None:
                draw_into(self.z, self.generator)
            if device.type != "cuda" or not self.capturable:
                metrics = self._body()
                self._key = self._key_of(self.batch)  # Adam's state exists now
                return metrics
            if self.graph is None:
                return self._warm_up_and_capture(device)
            self.graph.replay()
            self.launches.replayed()
            self.replays += 1
            return self.metrics

    def noise_shape(self, batch) -> tuple:
        """The shape of the noise one step draws: the batch's positions'."""
        return tuple(batch["positions"].shape)

    def _draws(self, batch, device: torch.device) -> Optional[torch.Tensor]:
        """An empty buffer of a step's standard-normal draws (None without noise)."""
        if self.noise_std is None:
            return None
        return torch.empty(draw_shape(self.noise_shape(batch)), device=device)

    def _noise(self, batch, z: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if z is None:
            return None
        return random_walk_position_noise(self.noise_shape(batch), self.noise_std, z=z)

    def _body(self) -> Metrics:
        return self.update(self.batch, self._noise(self.batch, self.z))

    def _key_of(self, batch) -> tuple:
        opt = self.optimizer
        tensors = [p for g in opt.param_groups for p in g["params"]]
        tensors += [t for state in opt.state.values() for t in state.values() if isinstance(t, torch.Tensor)]
        tensors += [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
        return tuple(t.data_ptr() for t in tensors), _spec(batch)

    def _warm_up_and_capture(self, device: torch.device) -> Metrics:
        """This step eagerly on a side stream, then the body captured
        (spans ``train.warmup`` and ``train.capture``)."""
        current = torch.cuda.current_stream(device)
        with trace_region("train.warmup"):
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                metrics = self._body()
            current.wait_stream(side)
        self._key = self._key_of(self.batch)  # Adam's state exists now
        self.optimizer.zero_grad(set_to_none=True)  # the graph allocates and writes the gradients
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.device(device), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.metrics = self._body()

        t0 = time.perf_counter()
        with trace_region("train.capture"):
            self.launches = LaunchRecord.around(capture)
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        return metrics

    def close(self) -> None:
        """Free the graph, its gradients and the buffers."""
        if self.graph is not None:
            self.optimizer.zero_grad(set_to_none=True)
        self.graph = self.launches = self._key = None
        self.batch = self.z = self.metrics = None


def make_multi_step(step_fn: TrainStep) -> Callable:
    """``(batches, step, noise=None) -> metrics stacked [T]``: ``T`` calls of
    ``step_fn``, each on its own batch of ``batches`` (every leaf stacked
    ``[T, ...]``; ``noise`` ``[T, ...]``): the math of JAX's scanned
    multi-step (``make_train_multi_step`` and its parallel twins), step
    after step, as the trainers' ``inner_steps`` replays."""

    def multi(batches, step: int, noise: Optional[torch.Tensor] = None) -> Metrics:
        out: List[Metrics] = []
        for i in range(batches["positions"].shape[0]):
            m = step_fn(tree_map(lambda t: t[i], batches), step + i, None if noise is None else noise[i])
            out.append({k: v.clone() for k, v in m.items()})
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return multi
