"""The serving runner: whole-trajectory rollouts requested by closed-loop
clients, as ``predict`` serves them.

A request is one trajectory of the served set. It runs from its arrival on
the host (a split file of one trajectory in the port's format) to its
predicted positions and strains back on the host: the port's loader (for
the multi-scale model ``train_multi_scale.make_loader``, which builds the
trajectory's static hierarchy, dense or COO as ``ms_dense`` picks), then
the captured rollout (``physics.rollout.rollout`` through
``train.make_rollout``, or ``physics.multi_scale_simulator.ms_rollout``),
then the copies to the host. The traffic mix gives the clients, the number
of trajectories and the requests the check samples; set-up serves every
trajectory once.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Dict, List

import numpy as np
import torch

from h100_bench import compare, yardstick
from h100_bench.harness import model_sizes
from h100_bench.reference import common as ref
from h100_bench.reference import multi_scale as ref_ms
from h100_bench.reference import single_scale as ref_ss

SPAN_LOAD, SPAN_ROLLOUT, SPAN_HOST = "bench.load", "bench.rollout", "bench.to_host"
REFERENCE_CHUNK = 13  # rollout steps the reference batches into one forward (its memory, not traffic)


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.cell.config, ctx.cell.traffic
        self.mc = model_sizes(self.config)
        self.family = self.config["family"]
        self.ref = ref_ss if self.family == "single_scale" else ref_ms
        self.latencies: List[float] = []
        self.build_s: List[float] = []
        self.captures: List[int] = []  # captured steps the port made anew, per request of the window
        self._captured = weakref.WeakSet()  # the port's captured steps seen so far
        self.served: List[int] = []  # trajectory of each request of the window
        self.particle_steps = 0
        self.window_s = 0.0
        self.sample: List[dict] = []

    def setup(self) -> None:
        from sgnn_tpu_torch.train.config import TrainConfig

        ctx = self.ctx
        self.trajs, self.metadata, data_dir = ctx.dataset(cases=True)
        self.case_dir = data_dir / "cases"
        self.cases = sorted(p.stem for p in self.case_dir.glob("*.npz"))
        tc = dict(self.config["train_config"])
        self.cfg = TrainConfig(**tc, data_path=str(self.case_dir), seed=ctx.seed)
        dev = ctx.device
        if self.family == "single_scale":
            from sgnn_tpu_torch.physics.simulator import make_norm_stats, simulator_init
            from sgnn_tpu_torch.train.train import make_rollout, simulator_config_from

            self.sim_cfg = simulator_config_from(self.cfg, self.metadata)
            self.sim = simulator_init(self.sim_cfg, generator=torch.Generator().manual_seed(0), device=dev)
            self._rollout = make_rollout(self.sim_cfg, make_norm_stats(self.metadata, self.cfg.noise_std, device=dev),
                                         self.cfg.inference_mode, dev)
        else:
            from sgnn_tpu_torch.physics.multi_scale_simulator import multi_scale_simulator_init
            from sgnn_tpu_torch.physics.simulator import make_norm_stats
            from sgnn_tpu_torch.train.train_multi_scale import ms_config_from

            self.sim_cfg = ms_config_from(self.cfg, self.metadata)
            self.sim = multi_scale_simulator_init(self.sim_cfg, generator=torch.Generator().manual_seed(0),
                                                  device=dev)
            self.stats = make_norm_stats(self.metadata, self.cfg.noise_std, device=dev)
        self.weights = ctx.weights(self.ref.param_shapes(self.mc), self.ref.output_layer(self.mc),
                                   float(self.traffic.get("output_scale", 1.0)))
        self.sim.load_state_dict(self.weights, strict=True)
        self.sim.eval()
        rng = np.random.default_rng(ctx.seed)
        self.order = [int(i) for _ in range(64) for i in rng.permutation(len(self.cases))]
        self.pick = np.random.default_rng([ctx.seed, 1])
        # warm-up: one request of every trajectory, so that every shape the
        # window serves has been captured once (the port keeps 4 captures, so
        # the window captures again; what first-time shapes cost is set-up)
        for case in range(len(self.cases)):
            self.request(case)
        ctx.sync()

    def request(self, case: int) -> dict:
        """One request: (predicted positions [T, N, dim], strains [T, N]) on the host."""
        ctx = self.ctx
        path = self.case_dir / f"{self.cases[case]}.npz"
        with ctx.quiet():
            tb = time.perf_counter()
            with ctx.span(SPAN_LOAD):
                if self.family == "single_scale":
                    from sgnn_tpu_torch.data.loader import TrajectoryLoader

                    item = next(iter(TrajectoryLoader(path, pad_multiple=self.cfg.pad_multiple)))
                else:
                    from sgnn_tpu_torch.train.train_multi_scale import make_loader

                    item = next(iter(make_loader(self.cfg, self.sim_cfg, self.cases[case])))
            build = time.perf_counter() - tb
            with ctx.span(SPAN_ROLLOUT):
                if self.family == "single_scale":
                    out = self._rollout(self.sim, item["positions"], item["particle_type"], item["strains"],
                                        item["node_mask"])
                else:
                    from sgnn_tpu_torch.physics.multi_scale_simulator import ms_rollout

                    out = ms_rollout(self.sim, self.sim_cfg, self.stats, item["positions"], item["particle_type"],
                                     item["strains"], item["graph"], node_mask=item["node_mask"],
                                     inference_mode=self.cfg.inference_mode, device=ctx.device)
            with ctx.span(SPAN_HOST):
                pos = out["predicted_rollout"].cpu().numpy()
                strain = out["predicted_strain"].cpu().numpy()
        return {"pos": pos, "strain": strain, "build_s": build, "real": int(item["node_mask"].sum()),
                "captures": self._new_captures()}

    def _new_captures(self) -> int:
        """The port's captured steps of the model (``captured_step.steps_of``)
        that were captured since the last look: a shape it holds no capture
        of, or one it had dropped (it keeps ``MAX_CACHED``)."""
        from sgnn_tpu_torch.physics.captured_step import steps_of

        new = [s for s in steps_of(self.sim) if s.graph is not None and s not in self._captured]
        self._captured.update(new)
        return len(new)

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        """The measured window; with a tracer, ``trace_requests`` more
        requests after it closes, under the profiler."""
        ctx = self.ctx
        keep = int(self.traffic["check_requests"])
        ctx.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            case = self.order[i % len(self.order)]
            ta = time.perf_counter()
            out = self.request(case)
            self.latencies.append(time.perf_counter() - ta)
            self.build_s.append(out["build_s"])
            self.captures.append(out["captures"])
            self.served.append(case)
            self.particle_steps += out["real"] * out["pos"].shape[0]
            # a uniform sample of the window's requests (reservoir), drawn from the seed
            if len(self.sample) < keep:
                self.sample.append({"case": case, **out})
            else:
                j = int(self.pick.integers(0, i + 1))
                if j < keep:
                    self.sample[j] = {"case": case, **out}
            i += 1
            if time.perf_counter() >= deadline:
                break
        self.window_s = time.perf_counter() - t0
        result = {"rollout_ms_p90": 1e3 * float(np.percentile(self.latencies, 90)),
                  "rollout_particle_steps_per_s": self.particle_steps / self.window_s}
        if tracer is not None:
            tracer.start()
            for j in range(int(self.traffic["trace_requests"])):
                self.request(self.order[(i + j) % len(self.order)])
            ctx.sync()
            tracer.stop()
        return result

    def model_flops(self) -> float:
        """Matrix-product operations of the window's rollout steps: forward
        only, on each step's real nodes and the valid edges of the
        trajectory's own frame at that step (single-scale) or of its static
        hierarchy (multi-scale)."""
        total = 0.0
        cache = self.__dict__.setdefault("_flops_cache", {})
        s_len = self.mc["seq_len"]
        for case in self.served:
            if case not in cache:
                pos = self.trajs[case][0]
                n = pos.shape[1]
                if self.family == "single_scale":
                    cache[case] = sum(yardstick.single_scale_forward_flops(
                        self.mc, n, compare.valid_edges(pos[t - 1], self.mc["radius"], self.mc["slots"]))
                        for t in range(s_len, pos.shape[0]))
                else:
                    h = ref_ms.hierarchy(pos[0], self.mc)
                    edges = {t: len(h[t][0]) for t in ref_ms.EDGE_TYPES}
                    cache[case] = (pos.shape[0] - s_len) * yardstick.multi_scale_forward_flops(self.mc, n, edges)
            total += cache[case]
        return total

    def free(self) -> None:
        del self.sim
        self.__dict__.pop("_rollout", None)
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, item: dict, precision: str) -> dict:
        """The reference's next positions and strains at every step of a
        sampled request, from the program's own windows."""
        dev, mc = self.ctx.device, self.mc
        prec = ref.Precision(precision)
        stats = ref.norm_stats(self.metadata, mc["noise_std"], dev)
        params = {k: v.detach() for k, v in self.weights.items()}
        pos, types, _ = self.trajs[item["case"]]
        n, s_len = pos.shape[1], mc["seq_len"]
        steps = item["pos"].shape[0]
        seq = np.concatenate([pos[:s_len], item["pos"][:, :n]], axis=0)  # [S + T, n, dim]
        seq_t = torch.from_numpy(np.ascontiguousarray(seq.transpose(1, 0, 2))).to(dev)  # [n, S + T, dim]
        chunk = REFERENCE_CHUNK
        out_p, out_s = [], []
        hier = None if self.family == "single_scale" else ref_ms.hierarchy(pos[0], mc)
        with torch.no_grad(), ref.tf32_off():
            for start in range(0, steps, chunk):
                ts = list(range(start, min(steps, start + chunk)))
                windows = [seq_t[:, t:t + s_len] for t in ts]
                if hier is None:
                    snd, rcv = [], []
                    for j, w in enumerate(windows):
                        s, r = ref_ss.radius_graph(w[:, -1], torch.ones(n, dtype=torch.bool, device=dev),
                                                   mc["radius"], mc["slots"])
                        snd.append(s + j * n)
                        rcv.append(r + j * n)
                    graph = (torch.cat(snd), torch.cat(rcv))
                else:
                    graph = ref_ms.batch_hierarchy([hier] * len(ts), n, dev)
                flat = torch.cat(windows)
                acc, strain = self.ref.forward(params, mc, flat, graph, stats, prec)
                nxt = ref.integrate(acc, flat, stats)
                out_p.append(nxt.reshape(len(ts), n, -1))
                out_s.append(strain.reshape(len(ts), n))
        ref_pos = torch.cat(out_p).cpu().numpy()
        ref_strain = torch.cat(out_s).cpu().numpy()
        erosional = types == -1  # follow the ground truth
        if erosional.any():
            ref_pos[:, erosional] = pos[s_len:][:, erosional]
        return {"ref_pos": ref_pos, "ref_strain": ref_strain}

    def _pairs(self, precision_got: str = None) -> List[dict]:
        pairs = []
        s_len = self.mc["seq_len"]
        for item in self.sample:
            pos = self.trajs[item["case"]][0]
            n = pos.shape[1]
            # each step's window's last frame: the first frames', then the program's predictions
            last = np.concatenate([pos[s_len - 1:s_len], item["pos"][:-1, :n]], axis=0)
            want = {**self._reference(item, "f32"), "last": last}
            if precision_got is None:
                got = {"pos": item["pos"][:, :n], "strain": item["strain"][:, :n]}
            else:
                r = self._reference(item, precision_got)
                got = {"pos": r["ref_pos"], "strain": r["ref_strain"]}
            pairs.append({**got, **want})
        return pairs

    def check(self) -> Dict[str, float]:
        if not self.sample:
            raise compare.CheckFailed("no request finished in the window")
        return compare.serving_gaps(self._pairs())

    def control(self) -> Dict[str, float]:
        return compare.serving_gaps(self._pairs("tf32"))
