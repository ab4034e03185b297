"""The one trainer over the model families, on the CPU.

``train``, ``predict`` and a resumed ``train`` for each of the four
families (``train/train.py``'s ``GNS``, ``MESHGRAPHNET`` and
``GRAPHCAST``, picked by ``cfg.architecture``;
``train_multi_scale.MULTI_SCALE`` through its entry point), each on the
dataset and config of its own tests; and a family defined here that
trains, validates and predicts through the same loop.
"""

import json
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.physics.rollout import cumulative_rmse
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train import train_multi_scale as ttms
from sgnn_tpu_torch.train.checkpoint import CheckpointManager
from sgnn_tpu_torch.train.loss import one_step_loss

from test_torch_port_graphcast import fields  # noqa: F401 (the GraphCast dataset fixture)
from test_torch_port_graphcast import graphcast_config
from test_torch_port_mgn import _config as mgn_config
from test_torch_port_mgn import env  # noqa: F401 (the MeshGraphNets dataset fixture)
from test_torch_port_ms_train import tiny  # noqa: F401 (the multi-scale dataset fixture)
from test_torch_port_ms_train import tiny_config as ms_config
from test_torch_port_train import tiny_config as ss_config
from test_torch_port_train import tiny_env  # noqa: F401 (the single-scale dataset fixture)

torch.set_num_threads(1)


@dataclass
class Flow:
    """A family's run: its entry module, its dataset fixture, its config,
    the steps of the run and of its resumption, a parameter name its
    checkpoint holds, and whether its logged loss falls over the run."""

    entry: object
    fixture: str
    config: object  # (dataset, **kw) -> TrainConfig
    steps: int
    resumed: dict
    param: str
    falls: bool = True


FLOWS = {
    "gns": Flow(ttrain, "tiny_env", lambda d, **kw: ss_config(*d, **kw), 120,
                dict(ntraining_steps=130, nsave_steps=10, log_every=10), "_encode_process_decode."),
    "meshgraphnet": Flow(ttrain, "env", lambda d, **kw: mgn_config(*d, **kw), 20,
                         dict(ntraining_steps=30, nsave_steps=10), "world_edge_fn.0.NN-2.weight",
                         # two log points of one batch of 2 each: its loss swings 1.4 -> 9.6 -> 0.45
                         # over 100 steps, falling only on the whole
                         falls=False),
    "multi_scale": Flow(ttms, "tiny", ms_config, 40, dict(ntraining_steps=50, nsave_steps=10), "_multi_scale_gnn."),
    "graphcast": Flow(ttrain, "fields", lambda d, **kw: graphcast_config(d[0], **kw), 40,
                      dict(ntraining_steps=50, nsave_steps=10), "m2m_blocks.1.edge_fn.0.NN-0.weight"),
}
CASES = [(f, phase) for f in FLOWS for phase in ("train", "predict", "resume")]


def _run_dir(dataset):
    return dataset if not isinstance(dataset, tuple) else dataset[0]


@pytest.fixture(scope="module")
def trained(request):
    """Each family's training run, made once: (its dataset, what ``train``
    returned, its run directory)."""
    runs = {}

    def get(name):
        if name not in runs:
            flow = FLOWS[name]
            dataset = request.getfixturevalue(flow.fixture)
            cfg = flow.config(dataset)
            runs[name] = dataset, flow.entry.train(cfg, device="cpu"), _run_dir(dataset) / "models" / cfg.run_name
        return runs[name]

    return get


@pytest.mark.parametrize("name,phase", CASES, ids=[f"{f}-{p}" for f, p in CASES])
def test_train_predict_resume(trained, name, phase, capsys):
    """train: the steps run, the loss falls, a best checkpoint of the
    family's model, the train and validation keys of every family (each of
    its loss terms; the multi-scale rollouts' times); predict: the family's summary from that
    checkpoint, one rollout pickle; resume: from that checkpoint to more
    steps."""
    flow = FLOWS[name]
    family = ttms.MULTI_SCALE if name == "multi_scale" else ttrain.ARCHITECTURES[name]
    dataset, result, run = trained(name)
    meta = json.load(open(run / "checkpoint_meta.json"))
    if phase == "train":
        assert result["step"] == flow.steps and np.isfinite(result["lowest_eval_loss"])
        assert meta["lowest_eval_loss"] is not None and meta["path"].startswith("model-best-")
        state, _ = CheckpointManager(run).restore(meta["path"])
        assert set(state) == {"params", "opt_state", "step"} and state["step"] == meta["step"]
        assert any(flow.param in k for k in state["params"])
        lines = [json.loads(line) for line in open(run / "metrics.jsonl")]
        tl = [line["train/loss"] for line in lines if "train/loss" in line]
        assert len(tl) == flow.steps // flow.config(dataset).log_every and all(np.isfinite(tl))
        assert tl[-1] < tl[0] or not flow.falls, f"loss did not decrease: {tl[0]} -> {tl[-1]}"
        terms = {f"train/loss-{t}" for t in family.terms}
        assert terms | {"lr", "train/step_time_s", "train/vram_mb"} <= set(lines[0])
        val = [line for line in lines if "val/loss" in line]
        assert len(val) == flow.steps // flow.config(dataset).nsave_steps
        want = {f"val/loss-{t}" for t in family.terms} | {"val/rmse-oneStep", "val/runtime", "val/vram_mb"}
        assert want | ({"val/mean_time", "val/std_time"} if family.per_step else set()) <= set(val[0])
    elif phase == "predict":
        summary = flow.entry.predict(flow.config(dataset, mode="rollout", model_file=meta["path"]), device="cpu")
        assert np.isfinite(summary["total"])
        times = {"mean_time", "std_time"} if family.per_step else set()
        assert set(summary) == {"total", *family.terms, "one_step"} | times
        assert f"{family.title} rollout summary (cpu)" in capsys.readouterr().out
        assert len(list((_run_dir(dataset) / "rollouts" / run.name).glob("*.pkl"))) == 1
    else:
        cfg = flow.config(dataset, model_file=meta["path"], **flow.resumed)
        assert flow.entry.train(cfg, device="cpu")["step"] == flow.resumed["ntraining_steps"]
        assert f"resumed from {meta['path']} at step {meta['step']}" in capsys.readouterr().out


# --- a fourth family, defined here ---------------------------------------------------


class Drift(torch.nn.Module):
    """Each particle moves on at its last velocity times (1 + a); the strain
    is b everywhere."""

    def __init__(self, sim_cfg, *, generator=None, device=None):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros((), device=device))
        self.b = torch.nn.Parameter(torch.zeros((), device=device))

    @property
    def device(self):
        return self.a.device

    def forward(self, window):  # [..., S, dim] -> next positions [..., dim]
        return window[..., -1, :] + (window[..., -1, :] - window[..., -2, :]) * (1 + self.a)


def _drift_loss(sim, sim_cfg, stats, cfg):
    def loss_fn(batch, noise, denom=None):
        pred = sim(batch["positions"] + noise)
        strain = sim.b.expand_as(batch["next_strain"])
        return one_step_loss(pred, batch["next_position"], strain, batch["next_strain"], batch["node_mask"],
                             weight_position=cfg.loss_weight_position, weight_strain=cfg.loss_weight_strain,
                             denom=denom)

    return loss_fn


def drift_family(rolled: list) -> ttrain.Family:
    """The family of ``Drift``; its rollout notes each trajectory it is
    given in ``rolled``."""

    def make_rollout(sim_cfg, stats, mode, device):
        def rollout(sim, positions, types, strains, node_mask, graph=None):
            rolled.append(len(node_mask))
            pos, st, mask = (torch.as_tensor(a) for a in (positions, strains, node_mask))
            s = sim_cfg  # the family's config is its window length
            window, pred = pos[:, :s], []
            with torch.no_grad():
                for _ in range(s, pos.shape[1]):
                    pred.append(sim(window))
                    window = torch.cat([window[:, 1:], pred[-1][:, None]], dim=1)
            pred, strain = torch.stack(pred), sim.b.detach().expand_as(st[s:])
            gt = pos[:, s:].transpose(0, 1)
            return {"predicted_rollout": pred, "rmse_position": cumulative_rmse(pred, gt, mask),
                    "rmse_strain": cumulative_rmse(strain[..., None], st[s:, :, None], mask)}

        return rollout

    return ttrain.Family(
        title="drift", config_from=lambda cfg, metadata: cfg.input_sequence_length, init=Drift, loss=_drift_loss,
        batcher=ttrain.sample_batcher, loader=ttrain.trajectory_loader, rollout=make_rollout,
        banner=lambda cfg, sim_cfg: f"window={sim_cfg}",
    )


def test_a_family_defined_outside_trains_validates_and_predicts(tiny_env, capsys):
    """``train`` and ``predict`` take a family they do not know: its model
    learns, its rollout scores every validation and test trajectory, and
    its checkpoint, summary and pickles come out as any family's."""
    rolled = []
    family = drift_family(rolled)
    cfg = ss_config(*tiny_env, run_name="drift", ntraining_steps=40, nsave_steps=20, log_every=10)
    result = ttrain.train(cfg, device="cpu", family=family)
    out = capsys.readouterr().out
    assert "drift training: window=6 layers=" in out and result["step"] == 40
    run = tiny_env[0] / "models" / "drift"
    meta = json.load(open(run / "checkpoint_meta.json"))
    assert meta["path"].startswith("model-best-") and meta["lowest_eval_loss"] == result["lowest_eval_loss"]
    state, _ = CheckpointManager(run).restore(meta["path"])
    assert set(state["params"]) == {"a", "b"} and float(state["params"]["a"]) != 0.0
    assert len(rolled) == 2  # one validation trajectory, validated at steps 20 and 40
    summary = ttrain.predict(ss_config(*tiny_env, run_name="drift", mode="rollout", model_file=meta["path"]),
                             device="cpu", family=family)
    assert set(summary) == {"total", "position", "strain", "one_step"} and np.isfinite(summary["total"])
    assert "drift rollout summary (cpu)" in capsys.readouterr().out and len(rolled) == 3
    assert len(list((tiny_env[0] / "rollouts" / "drift").glob("*.pkl"))) == 1
