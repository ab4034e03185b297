"""The byte, operation and L2-rule counters against hand counts."""

import pytest

from h100_bench import yardstick as y


def test_edge_bound_forward_hand_count():
    # r=2 receivers, k=2 slots, d=h=4, 3 valid edges, 2 live receivers, f32
    got = y.edge_bound(2, 2, 4, 4, 3, 2, "float32")
    weights = (2 * 16 + 4 + 12) * 4
    want_bytes = 2 * 2 * 4 * 4 + 3 * 4 * 4 + 2 * 4 * 4 + 2 * 4 + weights + 2 * 2 * 4 * 4 + 2 * 4 * 4
    assert got["bytes"] == want_bytes
    assert got["flops"] == 2 * 2 * 3 * 16
    assert got["by"] == "bytes"
    assert got["seconds"] == pytest.approx(want_bytes / 3.35e12)


def test_edge_bound_backward_and_bf16():
    got = y.edge_bound(2, 2, 4, 4, 3, 2, "bfloat16", backward=True)
    weights = (2 * 16 + 4 + 12) * 4
    want = (3 * 4 * 2 + 3 * 4 * 2 + 2 * 2 * 4 * 2 + 2 * 4 * 4 + 2 * 4 + 2 * 4 * 2 + weights
            + 2 * 2 * 4 * 2 + 2 * 2 * 4 * 2 + 2 * 4 * 2 + weights)
    assert got["bytes"] == want
    assert got["flops"] == 6 * 2 * 3 * 16


def test_compute_bound_uses_tensor_core_peak():
    got = y.bound(1.0, 495e12, "float32")
    assert got["by"] == "operations" and got["seconds"] == pytest.approx(1.0)
    assert y.bound(0, 989e12, "bfloat16")["seconds"] == pytest.approx(1.0)


def test_gather_and_sorted_sum_bounds():
    g = y.gather_bound(rows_read=5, n_out=7, width=8, elem=4, idx_bytes=8)
    assert g["bytes"] == 5 * 32 + 7 * 8 + 7 * 32 and g["flops"] == 0
    s = y.sorted_sum_bound(rows=7, n_out=3, width=8, elem=4, idx_bytes=4)
    assert s["bytes"] == 7 * 32 + 7 * 4 + 3 * 32 and s["flops"] == 7 * 8


def test_l2_rule():
    assert not y.qualifies(4 * 50 * 2 ** 20 - 1)
    assert y.qualifies(4 * 50 * 2 ** 20)


def test_single_scale_flops_hand_count():
    mc = {"latent": 2, "mlp_hidden_layers": 1, "dim": 2, "seq_len": 3, "layers": 1}
    nodes, edges = 3, 5
    node_in = 2 * 2 + 1
    enc = 2 * nodes * (node_in * 2 + 2 * 2) + 2 * edges * (3 * 2 + 2 * 2)
    layer = 2 * 2 * nodes * 4 + 2 * edges * 4 + 2 * edges * 4 + 2 * nodes * (4 * 2 + 2 * 2)
    dec = 2 * nodes * (2 * 2 + 2 * 3)
    assert y.single_scale_forward_flops(mc, nodes, edges) == enc + layer + dec


def test_multi_scale_flops_hand_count():
    mc = {"latent": 2, "mlp_hidden_layers": 2, "dim": 2, "seq_len": 3, "layers": 2}
    nodes, e = 3, {"g2m": 4, "m2m": 5, "m2g": 6}
    node_in = 5

    def mlp(rows, sizes):
        return 2 * rows * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))

    f = mlp(nodes, [node_in, 2, 2, 2]) + sum(mlp(v, [3, 2, 2, 2]) for v in e.values())

    def block(x):
        return 2 * 2 * nodes * 4 + 2 * x * 4 + mlp(x, [2, 2, 2]) + mlp(nodes, [4, 2, 2, 2])

    f += block(4) + 2 * block(5) + block(6) + mlp(nodes, [2, 2, 2, 3])
    assert y.multi_scale_forward_flops(mc, nodes, e) == f
