"""The yardstick of the per-layer metrics: the card's peaks, the least
time of a kernel launch (its bytes and operations), the L2 rule, and the
model's matrix-product operations per step.

``edge_bound``, ``gather_bound`` and ``sorted_sum_bound`` are frozen
copies of ``chip_smoke.edge_bound``, ``chip_smoke.gather_bound`` and
``chip_smoke.bwd_gather_bound`` (its sorted branch), taking sizes in place
of tensors and counting only what these inputs need: a gather's rows at
valid edges, a sum's rows at valid edges. Two corrections: the float32
peak is the TF32 tensor-core rate (the port's f32 products run on tensor
cores as 3xTF32, so the non-tensor 67 TFLOP/s could be beaten by a real
kernel), and a launch counts toward a roofline only where its bytes are at
least ``L2_FACTOR`` times the 50 MB L2 (``qualifies``), so that a
cache-resident working set cannot read above its HBM bound.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}  # H100 SXM dense: TF32 and bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
L2_FACTOR = 4


def qualifies(n_bytes: float) -> bool:
    """A launch counts toward a roofline only past four times the L2."""
    return n_bytes >= L2_FACTOR * L2_BYTES


def bound(n_bytes: float, flops: float, dtype: str) -> Dict[str, object]:
    """Least seconds of a launch: the larger of bytes over HBM and
    operations over the dtype's peak, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return {"seconds": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def edge_bound(r: int, k: int, d: int, h: int, valid: int, live: int, dtype: str, backward: bool = False):
    """One edge-block launch over r receivers of k slots, valid edges and
    live receivers (degree > 0): inputs read once, outputs written once;
    the forward reads e at every slot and writes every output; products 2 *
    D * H per valid edge, twice in the forward, six times in the backward."""
    es = 2 if dtype == "bfloat16" else 4
    weights = (2 * d * h + h + 3 * d) * 4
    if backward:
        n_bytes = (valid * d * es + valid * h * es + r * k * d * es
                   + live * h * 4 + r * 4 + live * d * es + weights
                   + r * k * d * es + r * k * h * es + r * h * es + weights)
        flops = 6 * 2 * valid * d * h
    else:
        n_bytes = (r * k * d * es + valid * h * es + live * h * 4 + r * 4 + weights
                   + r * k * d * es + r * d * es)
        flops = 2 * 2 * valid * d * h
    return bound(n_bytes, flops, dtype)


def gather_bound(rows_read: int, n_out: int, width: int, elem: int, idx_bytes: int):
    """``table[idx]`` for the n_out indices these inputs need: each table
    row they name read once, the indices, the output; no arithmetic."""
    row = width * elem
    return bound(rows_read * row + n_out * idx_bytes + n_out * row, 0, "float32")


def sorted_sum_bound(rows: int, n_out: int, width: int, elem: int, idx_bytes: int):
    """A sum of ``rows`` rows into ``n_out`` rows over ascending ids: the
    rows, the ids, the output; one f32 add per element."""
    row = width * elem
    return bound(rows * row + rows * idx_bytes + n_out * row, rows * width, "float32")


def mlp_flops(rows: int, sizes) -> int:
    """2 * rows * sum of in * out over an MLP's Linears."""
    return 2 * rows * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def single_scale_forward_flops(mc: dict, nodes: int, edges: int) -> int:
    """Matrix-product operations of one single-scale forward over ``nodes``
    real nodes and ``edges`` valid edges: the edge MLP's first Linear taken
    in split form (receiver and sender projections once per node, the edge
    latent's block once per edge)."""
    d, hid, dim = mc["latent"], mc["mlp_hidden_layers"], mc["dim"]
    node_in = (mc["seq_len"] - 1) * dim + 1
    f = mlp_flops(nodes, [node_in] + [d] * hid + [d]) + mlp_flops(edges, [dim + 1] + [d] * hid + [d])
    per_layer = (2 * 2 * nodes * d * d + 2 * edges * d * d + mlp_flops(edges, [d] * hid + [d])
                 + mlp_flops(nodes, [2 * d] + [d] * hid + [d]))
    return f + mc["layers"] * per_layer + mlp_flops(nodes, [d] + [d] * hid + [dim + 1])


def multi_scale_forward_flops(mc: dict, nodes: int, edges: Dict[str, int]) -> int:
    """The same for the multi-scale model: ``edges`` per type (g2m, m2m, m2g)."""
    d, hid, dim = mc["latent"], mc["mlp_hidden_layers"], mc["dim"]
    node_in = (mc["seq_len"] - 1) * dim + 1
    f = mlp_flops(nodes, [node_in] + [d] * hid + [d])
    f += sum(mlp_flops(e, [dim + 1] + [d] * hid + [d]) for e in edges.values())

    def block(e):
        return (2 * 2 * nodes * d * d + 2 * e * d * d + mlp_flops(e, [d] * hid + [d])
                + mlp_flops(nodes, [2 * d] + [d] * hid + [d]))

    f += block(edges["g2m"]) + mc["layers"] * block(edges["m2m"]) + block(edges["m2g"])
    return f + mlp_flops(nodes, [d] + [d] * hid + [dim + 1])
