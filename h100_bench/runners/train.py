"""The training runner: the port's trainer feed and step, timed.

Set-up builds the port's training (``train.build_training`` of the
configuration's family: the model, capturable Adam, the captured
``TrainStep`` and the batcher of the training split), loads the
benchmark's weights, and drives that one object through its first
``check_steps`` steps on the window's own feed: the batcher's batches
through ``data/prefetch.DevicePrefetcher`` (depth from the traffic mix),
the first step eager and captured, the rest replays. It keeps each step's
loss, the first gradient (Adam's first moment after one step over 1 -
beta1), the parameters after the first step, the second step's gradient
(the first replay's: ``(m2 - beta1 m1) / (1 - beta1)`` from Adam's first
moments) and the parameters after the last of those steps. The window
then goes on with the same feed and step for its seconds; ``check``
follows those first steps with the plain reference from the benchmark's
own dataset, weights and noise draws, and holds the replayed step against
the reference's loss and gradient at the program's own parameters after
the first step (teacher-forced, so that the two need not drift apart).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench import compare, yardstick
from h100_bench.harness import model_sizes
from h100_bench.reference import common as ref
from h100_bench.reference import multi_scale as ref_ms
from h100_bench.reference import single_scale as ref_ss

SPAN_FEED, SPAN_STEP = "bench.feed", "bench.step"


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.cell.config, ctx.cell.traffic
        self.mc = model_sizes(self.config)
        self.family = self.config["family"]
        self.ref = ref_ss if self.family == "single_scale" else ref_ms
        self.feed_waits: List[float] = []
        self.fingerprints: List[np.ndarray] = []  # per produced batch: (traj_idx, node 0's target strain)
        self.recorded: List[dict] = []
        self.steps = 0
        self.window_steps = 0
        self.traced_steps = 0
        self.window_s = 0.0
        self.counters: Dict[str, int] = {}

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
        from sgnn_tpu_torch.train.config import TrainConfig

        ctx = self.ctx
        self.trajs, self.metadata, data_dir = ctx.dataset(cases=False)
        tc = dict(self.config["train_config"])
        self.cfg = TrainConfig(**tc, data_path=str(data_dir), seed=ctx.seed,
                               model_path=str(ctx.scratch / "models"), output_path=str(ctx.scratch / "out"))
        if self.family == "single_scale":
            from sgnn_tpu_torch.train.train import build_training
        else:
            from sgnn_tpu_torch.train.train_multi_scale import build_training
        with ctx.quiet():
            self.built = build_training(self.cfg, ctx.device)
        self.shapes = self.ref.param_shapes(self.mc)
        self.weights = ctx.weights(self.shapes, self.ref.output_layer(self.mc),
                                   float(self.traffic.get("output_scale", 1.0)))
        self.built.sim.load_state_dict(self.weights, strict=True)
        self.names = {p: n for n, p in self.built.sim.named_parameters()}
        self.batch_size = self.cfg.batch_size
        self.n_pad = self.built.batcher.num_nodes
        self.source = DevicePrefetcher(self._recorder(self.built.epochs()), depth=int(self.traffic["prefetch_depth"]),
                                       device=ctx.device)
        self.losses, self.grad1, self.grad2, self.params1, self.params_after = [], None, None, None, None
        beta1 = ref.ADAM_BETAS[0]
        opt = self.built.optimizer
        moments = []
        for i in range(int(self.traffic["check_steps"])):
            metrics = self.built.step_fn(next(self.source), self.steps)
            self.steps += 1
            self.losses.append(float(metrics["train/loss"]))
            if i < 2:
                # no state: the optimizer took no step (a first moment of zero for the check)
                moments.append({self.names[p]: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                                for g in opt.param_groups for p in g["params"]})
            if i == 0:
                self.grad1 = {k: m / (1 - beta1) for k, m in moments[0].items()}
                self.params1 = {n: p.detach().clone() for n, p in self.built.sim.named_parameters()}
            if i == 1:
                self.grad2 = {k: (m - beta1 * moments[0][k]) / (1 - beta1) for k, m in moments[1].items()}
        self.params_after = {n: p.detach().clone() for n, p in self.built.sim.named_parameters()}
        torch.cuda.synchronize(ctx.device) if ctx.device.type == "cuda" else None

    def _recorder(self, batches):
        """The batcher's stream, its first batches kept for the check and
        every batch's samples noted for the operation count."""
        keep = int(self.traffic["check_steps"])
        for batch in batches:
            self.fingerprints.append(np.stack([batch["traj_idx"].astype(np.float64),
                                               batch["next_strain"][:, 0].astype(np.float64)], axis=1))
            if len(self.recorded) < keep:
                self.recorded.append({k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
            yield batch

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        """The measured window; with a tracer, ``trace_steps`` more steps of
        the same feed and step after it closes, under the profiler."""
        from h100_bench.counters import read_counters

        ctx, step_fn, source = self.ctx, self.built.step_fn, self.source
        ctx.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            with ctx.span(SPAN_FEED):
                tf = time.perf_counter()
                batch = next(source)
                self.feed_waits.append(time.perf_counter() - tf)
            with ctx.span(SPAN_STEP):
                step_fn(batch, self.steps)
            self.steps += 1
            self.window_steps += 1
            if time.perf_counter() >= deadline:
                break
        ctx.sync()
        self.window_s = time.perf_counter() - t0
        result = {"train_samples_per_s": self.window_steps * self.batch_size / self.window_s}
        if tracer is not None:
            before = read_counters()
            tracer.start()
            for _ in range(int(self.traffic["trace_steps"])):
                with ctx.span(SPAN_FEED):
                    batch = next(source)
                with ctx.span(SPAN_STEP):
                    step_fn(batch, self.steps)
                self.steps += 1
                self.traced_steps += 1
            ctx.sync()
            tracer.stop()
            self.counters = {k: v - before[k] for k, v in read_counters().items()}
        return result

    # -- the operation count ----------------------------------------------------

    def _sample_ids(self, upto: int) -> List[tuple]:
        """(trajectory, time) of every sample of the first ``upto`` batches
        consumed, from their fingerprints."""
        lookup = {}
        for ti, (pos, _, stress) in enumerate(self.trajs):
            for t in range(self.mc["seq_len"], pos.shape[0]):
                lookup[(ti, float(stress[t, 0]))] = t
        out = []
        for fp in self.fingerprints[:upto]:
            out.extend((int(ti), lookup[(int(ti), x)]) for ti, x in fp)
        return out

    def model_flops(self) -> Optional[float]:
        """Matrix-product operations of the window's steps (forward and
        backward: three forwards), counted on the inputs' real nodes and
        valid edges (the clean last frame of each sample's window; the
        multi-scale model's static hierarchy)."""
        first = int(self.traffic["check_steps"])
        ids = self._sample_ids(first + self.window_steps)[first * self.batch_size:]
        return 3.0 * sum(self._forward_flops(s) for s in ids)

    def _forward_flops(self, sample) -> float:
        ti, t = sample
        pos = self.trajs[ti][0]
        n = pos.shape[1]
        if self.family == "single_scale":
            return yardstick.single_scale_forward_flops(self.mc, n, self._edges_of(ti, t - 1))
        return yardstick.multi_scale_forward_flops(self.mc, n, self._hierarchy_edges(ti))

    def _edges_of(self, ti: int, frame: int) -> int:
        cache = self.__dict__.setdefault("_edge_cache", {})
        key = (ti, frame)
        if key not in cache:
            cache[key] = compare.valid_edges(self.trajs[ti][0][frame], self.mc["radius"], self.mc["slots"])
        return cache[key]

    def _hierarchy_edges(self, ti: int) -> Dict[str, int]:
        cache = self.__dict__.setdefault("_hier_cache", {})
        if ti not in cache:
            h = ref_ms.hierarchy(self.trajs[ti][0][0], self.mc)
            cache[ti] = {t: len(h[t][0]) for t in ref_ms.EDGE_TYPES}
        return cache[ti]

    def kernel_bounds(self) -> Dict[str, dict]:
        """Least seconds of the traced steps' launches, per kernel group of
        the single-scale step, with the launches per step the program's
        counters say (``counters``) and the trace's kernel names."""
        if self.family != "single_scale" or not self.traced_steps:
            return {}
        first = int(self.traffic["check_steps"]) + self.window_steps
        ids = self._sample_ids(first + self.traced_steps)[first * self.batch_size:]
        b, d, k, dt = self.batch_size, self.mc["latent"], self.mc["slots"], self.mc["dtype"]
        es = 2 if dt == "bfloat16" else 4
        r = b * self.n_pad
        groups = {"edge_block_fwd": [], "edge_block_bwd": [], "row_gather": []}
        layers = self.mc["layers"]
        for s in range(self.traced_steps):
            batch = ids[s * b:(s + 1) * b]
            valid = sum(self._edges_of(ti, t - 1) for ti, t in batch)
            live = sum(self.trajs[ti][0].shape[1] for ti, _ in batch)
            # every layer launches each kernel once, at the step's shapes
            groups["edge_block_fwd"] += [yardstick.edge_bound(r, k, d, d, valid, live, dt)] * layers
            groups["edge_block_bwd"] += [yardstick.edge_bound(r, k, d, d, valid, live, dt, backward=True)] * layers
            # the sender gathers: forward take of the node table, backward take of the
            # cotangent rows in sender order, and the sorted sum of those rows
            groups["row_gather"] += [yardstick.gather_bound(live, valid, d, es, 8),
                                     yardstick.gather_bound(valid, valid, d, es, 4),
                                     yardstick.sorted_sum_bound(valid, live, d, es, 4)] * layers
        return {
            "edge_block_fwd": {"bounds": groups["edge_block_fwd"], "per_step": layers,
                               "launches": self.counters.get("edge_block_fwd", -1), "kernels": r"edge_block_fwd_\w+"},
            "edge_block_bwd": {"bounds": groups["edge_block_bwd"], "per_step": layers,
                               "launches": self.counters.get("edge_block_bwd", -1),
                               "kernels": r"edge_block_bwd_kernel|reduce_partials_kernel"},
            "row_gather": {"bounds": groups["row_gather"], "per_step": 3 * layers,
                           "launches": self.counters.get("take", -1) + self.counters.get("sorted", -1),
                           "kernels": r"row_gather_take_kernel|sorted_segment_\w+_kernel"},
        }

    # -- the check --------------------------------------------------------------

    def free(self) -> None:
        self.source.close()
        self.built.step_fn.close()
        del self.built, self.source
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, precision: str, drop_half: bool = False) -> dict:
        """The plain reference's first ``check_steps`` steps from the
        benchmark's weights, the dataset's rows of the recorded batches and
        the seed's noise: the losses, the first and second gradients, the
        parameters after the first step and after the last."""
        params = {k: v.detach().clone() for k, v in self.weights.items()}
        adam = ref.Adam(params)
        losses, grads_of, params1 = [], [], None
        with ref.tf32_off():
            for step, inputs in enumerate(self._reference_inputs(drop_half)):
                loss, grads = self._loss_and_grads(params, inputs, ref.Precision(precision))
                losses.append(loss)
                if step < 2:
                    grads_of.append(grads)
                params = adam.step(params, grads, ref.learning_rate(step, self.config["train_config"]))
                if step == 0:
                    params1 = params
        return {"losses": losses, "grad1": grads_of[0], "grad2": grads_of[1] if len(grads_of) > 1 else None,
                "params1": params1, "params": params}

    def teacher_step(self, params1: Dict[str, torch.Tensor]) -> dict:
        """The reference's second step (f32, the whole batch) from the given
        parameters after the first: its loss and gradient."""
        with ref.tf32_off():
            inputs = list(self._reference_inputs(False, upto=2))[1]
            loss, grads = self._loss_and_grads({k: v.detach() for k, v in params1.items()}, inputs,
                                               ref.Precision("f32"))
        return {"loss": loss, "grad": grads}

    def _reference_inputs(self, drop_half: bool, upto: Optional[int] = None):
        """Per checked step: the noisy windows (flat), the reference's graph,
        the targets and the masks, from the dataset's rows of the recorded
        batch and the seed's noise draws (one per step, in order)."""
        dev, mc = self.ctx.device, self.mc
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        s_len = mc["seq_len"]
        ids = self._sample_ids(len(self.recorded))
        for step, batch in enumerate(self.recorded[:upto]):
            b = batch["positions"].shape[0]
            z = torch.randn((b, self.n_pad, (s_len - 1) * mc["dim"]), generator=gen, device=dev)
            rows = ids[step * b:(step + 1) * b]
            self._check_rows(batch, rows)
            keep = range(b // 2) if drop_half else range(b)
            windows, nexts, strains = [], [], []
            for k in keep:
                ti, t = rows[k]
                pos, _, stress = self.trajs[ti]
                n = pos.shape[1]
                noise = ref.random_walk_noise(z[k, :n], s_len, mc["dim"], mc["noise_std"])
                windows.append(torch.from_numpy(np.ascontiguousarray(pos[t - s_len:t].transpose(1, 0, 2))).to(dev)
                               + noise)
                nexts.append(torch.from_numpy(pos[t]).to(dev) + noise[:, -1])
                strains.append(torch.from_numpy(stress[t]).to(dev))
            flat_w = torch.cat(windows)
            yield {"windows": flat_w, "graph": self._graph(windows, [rows[k] for k in keep]),
                   "next": torch.cat(nexts), "strain": torch.cat(strains),
                   "mask": torch.ones(flat_w.shape[0], dtype=torch.bool, device=dev)}

    def _loss_and_grads(self, params, inputs, prec) -> tuple:
        stats = ref.norm_stats(self.metadata, self.mc["noise_std"], self.ctx.device)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        acc, strain = self.ref.forward(leaves, self.mc, inputs["windows"], inputs["graph"], stats, prec)
        target = ref.target_acceleration(inputs["next"], inputs["windows"], stats)
        loss = ref.one_step_loss(acc, target, strain, inputs["strain"], inputs["mask"])
        grads = dict(zip(leaves, (g.detach() for g in torch.autograd.grad(loss, list(leaves.values())))))
        return float(loss.detach()), grads

    def _graph(self, windows, rows):
        dev, mc = self.ctx.device, self.mc
        if self.family == "single_scale":
            snd, rcv, off = [], [], 0
            for w in windows:
                s, r = ref_ss.radius_graph(w[:, -1], torch.ones(w.shape[0], dtype=torch.bool, device=dev),
                                           mc["radius"], mc["slots"])
                snd.append(s + off)
                rcv.append(r + off)
                off += w.shape[0]
            return torch.cat(snd), torch.cat(rcv)
        cache = self.__dict__.setdefault("_hier_full", {})
        graphs = []
        for ti, _ in rows:
            if ti not in cache:
                cache[ti] = ref_ms.hierarchy(self.trajs[ti][0][0], mc)
            graphs.append(cache[ti])
        return ref_ms.batch_hierarchy(graphs, windows[0].shape[0], dev)

    def _check_rows(self, batch, rows) -> None:
        """The program's batch holds the dataset's rows of these samples."""
        s_len = self.mc["seq_len"]
        for k, (ti, t) in enumerate(rows):
            pos, _, stress = self.trajs[ti]
            n = pos.shape[1]
            ok = (np.array_equal(batch["positions"][k, :n], pos[t - s_len:t].transpose(1, 0, 2))
                  and np.array_equal(batch["next_position"][k, :n], pos[t])
                  and np.array_equal(batch["next_strain"][k, :n], stress[t])
                  and bool(batch["node_mask"][k, :n].all()) and not bool(batch["node_mask"][k, n:].any()))
            if not ok:
                raise compare.CheckFailed(f"batch row {k}: not the dataset's sample ({ti}, {t})")

    def program_readings(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1, "grad2": self.grad2, "params1": self.params1,
                "params": self.params_after}

    def gaps(self, got: dict, want: dict) -> Dict[str, float]:
        """The numbers of ``got`` (the program's readings, or the reference's
        in its place) against the reference's steps ``want`` and its second
        step from ``got``'s own parameters after the first."""
        return compare.training_gaps(got, want, self.weights, self.teacher_step(got["params1"]))

    def check(self) -> Dict[str, float]:
        """The numbers compared: the program's first steps against the reference's."""
        return self.gaps(self.program_readings(), self.reference_steps("f32"))

    def control(self) -> Dict[str, float]:
        """The control: the reference at TF32 in the program's place."""
        return self.gaps(self.reference_steps("tf32"), self.reference_steps("f32"))
