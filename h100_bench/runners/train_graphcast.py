"""The training runner of the GraphCast configuration (family
``graphcast``): ``runners/train.Runner``'s window and checked steps with
this family's set-up, data and reference.

  * set-up: the synthetic gridded fields (``graphcast_data.prepare``,
    cached under ``harness.data_cache_dir``), then the port's trainer with
    its ``GRAPHCAST`` family (``build_training``: the model with its graphs
    built on the host, capturable AdamW, the captured ``TrainStep``, the
    fields' batcher), the benchmark's weights, and the first
    ``check_steps`` steps through the ``DevicePrefetcher`` as the base
    runner takes them;
  * the sizes come from the configuration's own keys (``harness.
    model_sizes`` reads a particle model's);
  * the reference is ``reference/graphcast.py`` with its own graphs, built
    once on the device; its steps read the dataset's rows of the recorded
    samples (inputs at t - 6 h and t, the target at t + 6 h), AdamW at the
    published schedule; the fault (``drop_half``) leaves the second half
    of the grid's rows (the northern hemisphere) out of the loss;
  * the operation count is the forward's products on the reference's
    nodes and valid edges (the first Linears in split form, as the program
    takes them), three forwards a step;
  * with a tracer: ``coo_edge_fill.train`` reads the port's counter of
    valid edges and padded edge rows (``GraphCast.edge_counts``) and
    ``sorted_sum_ms.train`` the sorted sums' kernels in the trace.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench import compare, graphcast_data, harness, yardstick
from h100_bench.reference import common as ref
from h100_bench.reference import graphcast as ref_gc
from h100_bench.runners import train


def sizes(config: dict) -> dict:
    """The sizes the reference and the counters read, from the configuration."""
    tc, ds = config["train_config"], config["dataset"]
    surface = ds.get("surface_variables", graphcast_data.SURFACE)
    atmospheric = ds.get("atmospheric_variables", graphcast_data.ATMOSPHERIC)
    levels = ds.get("levels", graphcast_data.LEVELS)
    return {"family": config["family"], "latent": tc["hidden_dim"], "layers": tc["layers"],
            "frames": tc["input_sequence_length"], "dtype": tc.get("compute_dtype", "float32"),
            "state_dim": len(surface) + len(atmospheric) * len(levels),
            "forcing_dim": len(graphcast_data.FORCINGS), "static_dim": len(graphcast_data.STATIC),
            "resolution_deg": float(ds["resolution_deg"]), "refinement": tc["mesh_refinement"],
            "radius_fraction": ref_gc.G2M_RADIUS_FRACTION}


def forward_flops(mc: dict, grid_nodes: int, mesh_nodes: int, edges: Dict[str, int]) -> int:
    """Matrix-product operations of one forward: the encoders, the three
    stages (each edge MLP's first Linear in split form: the receiver and
    sender projections once per node, the edge block once per edge), the
    grid's own update in grid2mesh, the decoder."""
    d, mlp = mc["latent"], yardstick.mlp_flops
    node_in = mc["frames"] * (mc["state_dim"] + mc["forcing_dim"]) + mc["forcing_dim"] + mc["static_dim"] + 3

    def stage(e, n_recv, n_send):
        return (2 * (n_recv + n_send) * d * d + 2 * e * d * d + mlp(e, [d, d])
                + mlp(n_recv, [2 * d, d, d]))

    f = mlp(grid_nodes, [node_in, d, d]) + mlp(mesh_nodes, [3, d, d])
    f += sum(mlp(e, [4, d, d]) for e in edges.values())
    f += stage(edges["g2m"], mesh_nodes, grid_nodes) + mlp(grid_nodes, [d, d, d])
    f += mc["layers"] * stage(edges["m2m"], mesh_nodes, mesh_nodes)
    f += stage(edges["m2g"], grid_nodes, mesh_nodes)
    return f + mlp(grid_nodes, [d, d, mc["state_dim"]])


class Runner(train.Runner):
    def __init__(self, ctx):  # noqa: D107 (the base's set-up reads particle sizes)
        self.ctx = ctx
        self.config, self.traffic = ctx.cell.config, ctx.cell.traffic
        self.mc = sizes(self.config)
        self.family = self.config["family"]
        self.feed_waits: List[float] = []
        self.samples: List[tuple] = []  # (trajectory, last input time) of every produced batch's samples
        self.recorded: List[dict] = []
        self.steps = self.window_steps = self.traced_steps = 0
        self.window_s = 0.0
        self.counters: Dict[str, int] = {}
        self._ref_graphs: Optional[dict] = None

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
        from sgnn_tpu_torch.train.config import TrainConfig
        from sgnn_tpu_torch.train.train import GRAPHCAST, build_training

        ctx = self.ctx
        spec = dict(self.config["dataset"])
        spec.update(self.traffic.get("dataset", {}))
        data_dir = harness.data_cache_dir(spec)
        splits, self.metadata = graphcast_data.prepare(spec, data_dir)
        self.trajs = [splits["train"][k] for k in sorted(splits["train"])]
        tc = dict(self.config["train_config"])
        self.cfg = TrainConfig(**tc, data_path=str(data_dir), seed=ctx.seed,
                               model_path=str(ctx.scratch / "models"), output_path=str(ctx.scratch / "out"))
        with ctx.quiet():
            self.built = build_training(self.cfg, ctx.device, family=GRAPHCAST)
        self.shapes = ref_gc.param_shapes(self.mc)
        self.weights = ctx.weights(self.shapes, "decoder.NN-1", float(self.traffic.get("output_scale", 1.0)))
        self.built.sim.load_state_dict(self.weights, strict=True)
        self.names = {p: n for n, p in self.built.sim.named_parameters()}
        self.batch_size = self.cfg.batch_size
        self.source = DevicePrefetcher(self._recorder(self.built.epochs()), depth=int(self.traffic["prefetch_depth"]),
                                       device=ctx.device)
        self._checked_steps()

    def _checked_steps(self) -> None:
        """The first ``check_steps`` steps, with the losses, the first two
        gradients (from AdamW's first moments) and the parameters kept."""
        beta1 = ref_gc.BETAS[0]
        opt = self.built.optimizer
        self.losses, self.grad1, self.grad2, self.params1, self.params_after = [], None, None, None, None
        moments = []
        for i in range(int(self.traffic["check_steps"])):
            metrics = self.built.step_fn(next(self.source), self.steps)
            self.steps += 1
            self.losses.append(float(metrics["train/loss"]))
            if i < 2:
                moments.append({self.names[p]: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                                for g in opt.param_groups for p in g["params"]})
            if i == 0:
                self.grad1 = {k: m / (1 - beta1) for k, m in moments[0].items()}
                self.params1 = {n: p.detach().clone() for n, p in self.built.sim.named_parameters()}
            if i == 1:
                self.grad2 = {k: (m - beta1 * moments[0][k]) / (1 - beta1) for k, m in moments[1].items()}
        self.params_after = {n: p.detach().clone() for n, p in self.built.sim.named_parameters()}
        self.ctx.sync()

    def _recorder(self, batches):
        keep = int(self.traffic["check_steps"])
        for batch in batches:
            self.samples.extend(zip(batch["traj_idx"].tolist(), batch["time"].tolist()))
            if len(self.recorded) < keep:
                self.recorded.append({k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
            yield batch

    # -- the reference's graphs and the operation count -------------------------

    def ref_graphs(self) -> dict:
        if self._ref_graphs is None:
            self._ref_graphs = ref_gc.graphs(self.mc, self.ctx.device)
        return self._ref_graphs

    def model_flops(self) -> Optional[float]:
        """Matrix-product operations of the window's steps: three forwards
        per sample, on the reference graphs' nodes and edges."""
        g = self.ref_graphs()
        edges = {k: int(g[k][0].numel()) for k in ("g2m", "m2m", "m2g")}
        per = forward_flops(self.mc, g["grid_nodes"], g["mesh_nodes"], edges)
        return 3.0 * per * self.window_steps * self.batch_size

    def kernel_bounds(self) -> Dict[str, dict]:
        return {}

    # -- the check --------------------------------------------------------------

    def _reference_inputs(self, upto: Optional[int] = None):
        """Per checked step, per sample: the dataset's state [frames, N, C],
        forcings [frames + 1, N, F], static [N, S] and target [N, C]."""
        dev, f = self.ctx.device, self.mc["frames"]
        for step, batch in enumerate(self.recorded[:upto]):
            b = batch["state"].shape[0]
            rows = self.samples[step * b:(step + 1) * b]
            out = []
            for k, (ti, t) in enumerate(rows):
                tr = self.trajs[ti]
                sample = {"state": tr["state"][t - f + 1:t + 1], "forcings": tr["forcings"][t - f + 1:t + 2],
                          "static": tr["static"], "target": tr["state"][t + 1]}
                if not all(np.array_equal(batch[key][k], v) for key, v in sample.items()):
                    raise compare.CheckFailed(f"batch row {k}: not the dataset's sample ({ti}, {t})")
                out.append({key: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for key, v in sample.items()})
            yield out

    def _loss_and_grads(self, params, samples, prec, drop_half: bool = False) -> tuple:
        g = self.ref_graphs()
        st = ref_gc.stats(self.metadata, self.ctx.device)
        rows = None
        if drop_half:
            rows = torch.arange(g["grid_nodes"], device=self.ctx.device) < g["grid_nodes"] // 2
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total = 0.0
        for s in samples:
            y = ref_gc.forward(leaves, self.mc, ref_gc.inputs(st, g, s["state"], s["forcings"], s["static"]), g, prec)
            total = total + ref_gc.loss(st, y, s["state"], s["target"], rows)
        loss = total / len(samples)
        grads = dict(zip(leaves, (x.detach() for x in torch.autograd.grad(loss, list(leaves.values())))))
        return float(loss.detach()), grads

    def _lr(self, step: int) -> float:
        tc = self.config["train_config"]
        return ref_gc.learning_rate(step, tc["lr_init"], tc["ntraining_steps"])

    def reference_steps(self, precision: str, drop_half: bool = False) -> dict:
        params = {k: v.detach().clone() for k, v in self.weights.items()}
        opt = ref_gc.AdamW(params)
        losses, grads_of, params1 = [], [], None
        with ref.tf32_off():
            for step, samples in enumerate(self._reference_inputs()):
                loss, grads = self._loss_and_grads(params, samples, ref.Precision(precision), drop_half)
                losses.append(loss)
                if step < 2:
                    grads_of.append(grads)
                params = opt.step(params, grads, self._lr(step))
                if step == 0:
                    params1 = params
        return {"losses": losses, "grad1": grads_of[0], "grad2": grads_of[1] if len(grads_of) > 1 else None,
                "params1": params1, "params": params}

    def teacher_step(self, params1: Dict[str, torch.Tensor]) -> dict:
        with ref.tf32_off():
            samples = list(self._reference_inputs(upto=2))[1]
            loss, grads = self._loss_and_grads({k: v.detach() for k, v in params1.items()}, samples,
                                               ref.Precision("f32"))
        return {"loss": loss, "grad": grads}
