"""On the card: a short run of each cell, whose check must pass. Skips
without a CUDA card (decided in the fixture)::

    python -m pytest h100_bench/tests/test_h100_bench_card.py -m cuda -q
"""

import pytest
import torch

from h100_bench.tests._tiny import load_run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["ss_f32_train", "ms_f32_rollout", "ms_f32_train", "ss_f32_rollout"])
def test_short_run_is_correct(card, cell):
    res = load_run().run(cell, 2 ** 31 + 101, 2.0, False)
    assert res["correct"], res["numbers"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
