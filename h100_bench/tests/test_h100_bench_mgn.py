"""The MeshGraphNets cell (``mgn_f32_train``) driven through a whole run at
tiny sizes on the CPU, as ``test_h100_bench_check.py`` drives the other
cells: a sound program is correct and its traced run reads the world
slots' fill; the control and each fault a training cell can have fail
its limits. On the card (``-m cuda``): a short run of the cell is correct."""

import pytest
import torch

from h100_bench import compare, harness
from h100_bench.tests._tiny import load_run, tiny

CELL = "mgn_f32_train"


@pytest.fixture(scope="module")
def run_mod():
    return load_run()


def _run(run_mod, trace=False):
    return run_mod.run(CELL, 2 ** 31 + 17, 0.3, trace, device="cpu", require_cuda=False, adjust=tiny)


def test_sound_program_is_correct_and_reads_its_metrics(run_mod):
    res = _run(run_mod, trace=True)
    assert res["correct"], res["numbers"]
    fill = res["metrics"]["world_slot_fill.train"]["value"]
    assert 0 < fill < 100
    assert {"mfu.train", "feed_busy_ms.train"} <= set(res["metrics"])
    assert not compare.judge(res["_runner"].control(), harness.find_cell(CELL).workload["limits"])


def test_untraced_run_reports_the_end_to_end_metrics(run_mod):
    res = _run(run_mod)
    assert set(res["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}


def test_state_left_unchanged_is_not_correct(run_mod, monkeypatch):
    from sgnn_tpu_torch.train import captured_train_step as cts

    def update(self, batch, noise):
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(batch, noise)
        loss.backward()  # no optimizer step
        return {"train/loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    monkeypatch.setattr(cts.TrainStep, "update", update)
    assert not _run(run_mod)["correct"]


def test_half_batch_is_not_correct(run_mod, monkeypatch):
    from sgnn_tpu_torch.data.prefetch import tree_map
    from sgnn_tpu_torch.train import captured_train_step as cts

    plain = cts.TrainStep.update

    def update(self, batch, noise):
        half = batch["positions"].shape[0] // 2
        return plain(self, tree_map(lambda t: t[:half] if isinstance(t, torch.Tensor) else t, batch), noise[:half])

    monkeypatch.setattr(cts.TrainStep, "update", update)
    assert not _run(run_mod)["correct"]


@pytest.mark.cuda
def test_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = load_run().run(CELL, 2 ** 31 + 101, 2.0, False)
    assert res["correct"], res["numbers"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
