"""The check that decides ``correct``, driven through a whole run at tiny
sizes on the CPU (the look for a card skipped): a sound program passes;
the control (the reference at TF32 in the program's place) and each fault
that a cell can have (a step that returns its state unchanged, half of
the batch left out and the mean taken over the rest, a fault in the
replayed step alone, an answer altered where it is produced) fail. The limits are the cells' own."""

import pytest
import torch

from h100_bench import compare, harness
from h100_bench.tests._tiny import load_run, tiny

CELLS = ["ss_f32_train", "ms_f32_train", "ss_f32_rollout", "ms_f32_rollout"]
TRAIN = ["ss_f32_train", "ms_f32_train"]
SERVE = ["ss_f32_rollout", "ms_f32_rollout"]


@pytest.fixture(scope="module")
def run_mod():
    return load_run()


def _run(run_mod, cell, on_runner=None):
    return run_mod.run(cell, 2 ** 31 + 17, 0.3, False, device="cpu", require_cuda=False, adjust=tiny,
                       on_runner=on_runner)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(run_mod, cell):
    res = _run(run_mod, cell)
    assert res["correct"], res["numbers"]
    assert set(res["metrics"]) == {m["name"] for m in harness.find_cell(cell).end_to_end}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_mod, cell):
    res = _run(run_mod, cell)
    control = res["_runner"].control()
    assert not compare.judge(control, harness.find_cell(cell).workload["limits"]), control


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_not_correct(run_mod, cell, monkeypatch):
    from sgnn_tpu_torch.train import captured_train_step as cts

    def update(self, batch, noise):
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(batch, noise)
        loss.backward()  # no optimizer step: the state stays as it was
        return {"train/loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    monkeypatch.setattr(cts.TrainStep, "update", update)
    assert not _run(run_mod, cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_not_correct(run_mod, cell, monkeypatch):
    from sgnn_tpu_torch.data.prefetch import tree_map
    from sgnn_tpu_torch.train import captured_train_step as cts

    plain = cts.TrainStep.update

    def update(self, batch, noise):
        half = batch["positions"].shape[0] // 2
        return plain(self, tree_map(lambda t: t[:half] if isinstance(t, torch.Tensor) else t, batch), noise[:half])

    monkeypatch.setattr(cts.TrainStep, "update", update)
    assert not _run(run_mod, cell)["correct"]


@pytest.mark.parametrize("fault", ["gradient", "loss"])
@pytest.mark.parametrize("cell", TRAIN)
def test_replayed_step_at_fault_is_not_correct(run_mod, cell, fault, monkeypatch):
    """A fault in every call after the first (on the card: in the captured
    body, which only replays run), which leaves the first step sound and
    touches one leaf's gradient, or the loss, only."""
    from sgnn_tpu_torch.train import captured_train_step as cts

    calls = {}

    def update(self, batch, noise):
        calls[id(self)] = calls.get(id(self), 0) + 1
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(batch, noise)
        loss.backward()
        if calls[id(self)] > 1:
            if fault == "gradient":
                next(iter(self.optimizer.param_groups[0]["params"])).grad.mul_(1.5)
            else:
                loss = loss * 1.01
        self.optimizer.step()
        return {"train/loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    monkeypatch.setattr(cts.TrainStep, "update", update)
    res = _run(run_mod, cell)
    assert not res["correct"], res["numbers"]
    assert res["numbers"]["loss1_gap"]["value"] <= res["numbers"]["loss1_gap"]["limit"]
    assert res["numbers"]["grad1_gap"]["value"] <= res["numbers"]["grad1_gap"]["limit"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_not_correct(run_mod, cell, monkeypatch):
    from sgnn_tpu_torch.physics import multi_scale_simulator, rollout

    plain = rollout.advance_window

    def advance(window, next_pos, strain, *rest):
        next_pos = next_pos.clone()
        next_pos[0] += 1e-3  # one particle's answer moved where it is produced
        return plain(window, next_pos, strain, *rest)

    monkeypatch.setattr(rollout, "advance_window", advance)
    monkeypatch.setattr(multi_scale_simulator, "advance_window", advance)
    assert not _run(run_mod, cell)["correct"]


def test_no_card_no_result(run_mod, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_mod.main(["--workload", "ss_f32_train", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
