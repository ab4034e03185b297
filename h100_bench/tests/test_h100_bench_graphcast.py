"""The GraphCast cell (``graphcast_small_f32_train``) driven through a whole
run at tiny sizes on the CPU (a 10 degree grid, mesh level 2, latent 16):
it is found by name, a sound program is correct and its traced run reads
its metrics; the TF32 control, and a program that leaves half of the
grid's rows out of its loss, fail the cell's limits. On the card
(``-m cuda``): a short run of the cell is correct."""

import pytest
import torch

from h100_bench import compare, harness
from h100_bench.tests._tiny import load_run

CELL = "graphcast_small_f32_train"


def tiny(cell):
    cell.config["dataset"].update(resolution_deg=10.0, levels=[300, 500, 850], frames=6,
                                  atmospheric_variables=["temperature", "geopotential"])
    cell.config["train_config"].update(hidden_dim=16, layers=2, mesh_refinement=2, edge_pad_multiple=64)
    cell.traffic["trace_steps"] = 2


@pytest.fixture(scope="module")
def run_mod():
    return load_run()


def _run(run_mod, trace=False):
    return run_mod.run(CELL, 2 ** 31 + 23, 0.3, trace, device="cpu", require_cuda=False, adjust=tiny)


def test_cell_is_found_with_its_files():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.traffic["runner"] == "train_graphcast"
    assert cell.config["train_config"]["hidden_dim"] == 512 and cell.config["train_config"]["layers"] == 16
    assert cell.config["reduced"] == ["batch_size"] and cell.config["train_config"]["batch_size"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"mfu.train", "device_idle.train", "feed_busy_ms.train",
                                                    "feed_wait_ms.train", "coo_edge_fill.train",
                                                    "sorted_sum_ms.train"}


def test_sound_program_is_correct_and_reads_its_metrics(run_mod):
    res = _run(run_mod, trace=True)
    assert res["correct"], res["numbers"]
    fill = res["metrics"]["coo_edge_fill.train"]["value"]
    assert 50 < fill < 100
    assert {"mfu.train", "feed_busy_ms.train", "feed_wait_ms.train"} <= set(res["metrics"])
    assert not compare.judge(res["_runner"].control(), harness.find_cell(CELL).workload["limits"])


def test_half_grid_left_out_of_the_loss_is_not_correct(run_mod, monkeypatch):
    from sgnn_tpu_torch.models import graphcast as gc

    plain = gc.loss_terms

    def half(stats, y, want):
        n = y.shape[0] // 2
        return plain(stats._replace(lat_weight=stats.lat_weight[:n]), y[:n], want[:n])

    monkeypatch.setattr(gc, "loss_terms", half)
    assert not _run(run_mod)["correct"]


@pytest.mark.cuda
def test_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = load_run().run(CELL, 2 ** 31 + 107, 2.0, False)
    assert res["correct"], res["numbers"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
