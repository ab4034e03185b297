"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc; every test skips without a card. Imports no
JAX, so it runs on a machine without it::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import pytest
import torch

from sgnn_tpu_torch.ops import edge_block as eb
from sgnn_tpu_torch.ops import row_gather as rg

pytestmark = pytest.mark.cuda

# f32: sums of 64 products in another order; bf16: 8 significant bits,
# a flipped rounding of an output (2^-7 rel) or of a message entering agg
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-4, 2.0**-7)}  # (atol, rtol)
# f32 agg sums a receiver's K messages, each within the forward's f32 error;
# the tensor-core kernel's errors share a lean (the card's agg error at
# K = 128 is several times its CPU emulation's, which rounds every sum to
# nearest), so they add up with K. TOL holds up to the 20 slots it was set
# on; past them agg's f32 atol grows as K / 20 (6.4e-5 at K = 128, inside
# the backward's 1e-4).
AGG_TOL_SLOTS = 20


def _fwd_tol(dtype, name, k):
    atol, rtol = TOL[dtype]
    if name == "agg" and dtype == torch.float32:
        atol *= max(1.0, k / AGG_TOL_SLOTS)
    return atol, rtol
# backward, elementwise outputs (g_e, g_xj, g_proj_i). f32: sums of 64
# products and the LayerNorm means in another order. bf16: as the forward,
# and a flipped bf16 rounding of relu(h) moves one row's g_o.
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-4, 2.0**-7)}
# weight gradients: sums over all edges, so the error scales with the sum
# of the absolute terms. f32: another summation order over <= 39k terms;
# bf16: also the flipped roundings of relu(h) above. Measured on an H100
# at these shapes: at most 1.34e-7 (f32) and 1.54e-7 (bf16) of the sum.
SUM_RTOL = {torch.float32: 2e-5, torch.bfloat16: 1e-5}
WGRAD = ("g_we", "g_be", "g_w2", "g_b2", "g_lns", "g_lnb")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(r, k, d, dtype, device, seed=0, h=None):
    """Forward inputs with D = d and H = h (default d)."""
    h = d if h is None else h
    g = torch.Generator().manual_seed(seed)
    degrees = torch.randint(0, k + 1, (r, 1), generator=g).float()
    mask = (torch.arange(k).repeat(r)[:, None] < degrees.repeat_interleave(k, dim=0)).float()
    args = [
        (torch.randn(r * k, d, generator=g) * mask).to(dtype),
        torch.randn(r * k, h, generator=g).to(dtype),
        torch.randn(r, h, generator=g),
        degrees,
        torch.randn(d, h, generator=g) * 0.2,
        torch.randn(h, generator=g) * 0.1,
        torch.randn(h, d, generator=g) * 0.2,
        torch.randn(d, generator=g) * 0.1,
        1.0 + 0.1 * torch.randn(d, generator=g),
        0.1 * torch.randn(d, generator=g),
    ]
    return [a.to(device) for a in args]


def _away_from_relu_ties(args, k):
    """Move xj where |h| < 0.05 by +0.1, so that no ReLU gate h > 0 hangs
    on the summation order (the kernel and the plain version sum e @ We in
    different orders; a gate that flips changes g_h by a whole g_a)."""
    e, xj, proj_i, _, we, be, *_ = args
    h = e.float() @ we.to(e.dtype).float() + xj.float() + proj_i.repeat_interleave(k, dim=0) + be
    near = h.abs() < 0.05
    args[1] = torch.where(near, xj.float() + 0.1, xj.float()).to(xj.dtype).contiguous()
    return args


def _cotangents(r, k, d, dtype, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(r * k, d, generator=g).to(dtype).to(device),
            torch.randn(r, d, generator=g).to(dtype).to(device))


def _check_bwd(got, want, sums, dtype):
    atol, rtol = BWD_TOL[dtype]
    for name, a, b in zip(("g_e", "g_xj", "g_proj_i"), got[:3], want[:3]):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol, msg=name)
    for name, a, b, s in zip(WGRAD, got[3:], want[3:], sums):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        over = (a - b).abs() > SUM_RTOL[dtype] * s + 1e-6
        assert not over.any(), f"{name}: max |err| {float((a - b).abs().max()):.3e}"


def _fwd_variant(k, d, h):
    """The forward kernel the shape rule picks (csrc/edge_block_fwd.cu)."""
    return "tensor_core" if max(d, h) <= eb.MAX_BWD_WIDTH and k <= eb.MAX_BWD_K else "warp"


def _check_fwd(args, k, dtype):
    """One forward launch against the plain version; asserts which kernel
    ran and returns its outputs."""
    d, h = args[0].shape[1], args[1].shape[1]
    before = (eb.LAUNCHES, dict(eb.FWD_VARIANT_LAUNCHES))
    got = eb.fused_edge_block(*args, k)
    variant = _fwd_variant(k, d, h)
    assert eb.LAUNCHES == before[0] + 1
    assert eb.FWD_VARIANT_LAUNCHES == {**before[1], variant: before[1][variant] + 1}
    want = eb.fused_edge_block_reference(*args, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("new_e", "agg"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        atol, rtol = _fwd_tol(dtype, name, k)
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol, msg=name)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,k,d", [
    (4864, 8, 64), (4797, 8, 64), (64, 20, 64), (512, 4, 16),
    # shapes that cut the tensor-core kernel's 128-row tiles raggedly
    (301, 7, 64),  # K divides no tile: 18 receivers = 126 rows per tile
    (9, 7, 64),  # R*K below one tile
    (200, 8, 40),  # D = H = 40, not a multiple of 16
    (50, 7, 21),  # rows of 84 / 42 bytes: loaded and stored element by element
    (5, 128, 64),  # the largest K: one receiver per tile
    # the warp-per-receiver kernel: wider than the tile
    (37, 3, 96), (300, 8, 128),
])
def test_kernel_matches_plain(cuda, r, k, d, dtype):
    _check_fwd(_inputs(r, k, d, dtype, cuda), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,k,d", [(4864, 8, 64), (301, 7, 64), (50, 7, 21), (37, 3, 96)])
def test_fwd_kernel_repeats_bits(cuda, r, k, d, dtype):
    args = _inputs(r, k, d, dtype, cuda, seed=5)
    once = eb.edge_block_fwd(*args, k)
    twice = eb.edge_block_fwd(*args, k)
    torch.cuda.synchronize()
    for a, b in zip(once, twice):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,k,d,h", [(300, 8, 48, 64), (300, 8, 64, 40)])
def test_rectangular_weights_fwd_and_bwd(cuda, r, k, d, h, dtype):
    """D != H (we [D, H], w2 [H, D]) through both kernels."""
    args = _away_from_relu_ties(_inputs(r, k, d, dtype, cuda, seed=6, h=h), k)
    _check_fwd(args, k, dtype)
    g_new, g_agg = _cotangents(r, k, d, dtype, cuda, seed=7)
    got = eb.edge_block_bwd(*args, g_new, g_agg, k)
    again = eb.edge_block_bwd(*args, g_new, g_agg, k)
    want = eb.fused_edge_block_bwd_reference(*args, g_new, g_agg, k)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got[:4]] == [(r * k, d), (r * k, h), (r, h), (d, h)]
    _check_bwd(got, want, eb.weight_grad_abs_sums(*args, g_new, g_agg, k), dtype)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,k,d", [
    (4864, 8, 64), (4797, 8, 64), (64, 20, 64), (512, 4, 16), (3, 5, 24),
    # shapes that cut the kernel's 128-row tiles of whole receivers raggedly
    (301, 7, 64),  # K divides no tile: 18 receivers = 126 rows per tile
    (9, 7, 64),  # R*K below one tile
    (200, 8, 40),  # D = H = 40, not a multiple of 16
    (50, 7, 21),  # rows of 84 / 42 bytes: loaded and stored element by element
    (5, 128, 64),  # the largest K: one receiver per tile
])
def test_bwd_kernel_matches_plain_and_repeats_bits(cuda, r, k, d, dtype):
    args = _away_from_relu_ties(_inputs(r, k, d, dtype, cuda), k)
    g_new, g_agg = _cotangents(r, k, d, dtype, cuda)
    before = eb.BWD_LAUNCHES
    got = eb.edge_block_bwd(*args, g_new, g_agg, k)
    again = eb.edge_block_bwd(*args, g_new, g_agg, k)
    assert eb.BWD_LAUNCHES == before + 2
    want = eb.fused_edge_block_bwd_reference(*args, g_new, g_agg, k)
    torch.cuda.synchronize()
    _check_bwd(got, want, eb.weight_grad_abs_sums(*args, g_new, g_agg, k), dtype)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gradients_through_the_kernel_match_the_plain_backward(cuda, dtype):
    r, k, d = 300, 8, 64
    args = _away_from_relu_ties(_inputs(r, k, d, dtype, cuda, seed=3), k)
    g_new, g_agg = _cotangents(r, k, d, dtype, cuda, seed=4)
    leaves = [a.clone().requires_grad_(i != 3) for i, a in enumerate(args)]
    before = (eb.LAUNCHES, eb.BWD_LAUNCHES)
    new_e, agg = eb.fused_edge_block(*leaves, k)
    torch.autograd.backward((new_e, agg), (g_new, g_agg))
    assert (eb.LAUNCHES, eb.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = eb.fused_edge_block_bwd_reference(*args, g_new, g_agg, k)
    got = [leaves[i].grad for i in (0, 1, 2, 4, 5, 6, 7, 8, 9)]
    assert leaves[2].grad.dtype == torch.float32  # g_proj_i cast back to proj_i's dtype
    got[2] = got[2].to(dtype)
    _check_bwd(got, want, eb.weight_grad_abs_sums(*args, g_new, g_agg, k), dtype)
    assert leaves[3].grad is None


def test_kernel_refuses_degree_grad_and_wide_tiles(cuda):
    args = _inputs(16, 4, 16, torch.float32, cuda)
    args[3].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        eb.fused_edge_block(*args, 4)
    wide = _inputs(4, 2, 160, torch.float32, cuda)
    with pytest.raises(ValueError):
        eb.fused_edge_block(*wide, 2)
    bwd_wide = _inputs(4, 2, 96, torch.float32, cuda)
    g_new, g_agg = _cotangents(4, 2, 96, torch.float32, cuda)
    with pytest.raises(ValueError, match="backward kernel"):
        eb.edge_block_bwd(*bwd_wide, g_new, g_agg, 2)
    many = _inputs(2, eb.MAX_BWD_K + 1, 16, torch.float32, cuda)
    g_new, g_agg = _cotangents(2, eb.MAX_BWD_K + 1, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="K <= 128"):
        eb.edge_block_bwd(*many, g_new, g_agg, eb.MAX_BWD_K + 1)


GATHERS = {"loop": rg.row_gather_loop, "unroll8": rg.row_gather_unroll8, "take": rg.row_gather_take}


@pytest.mark.parametrize("itype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,w,idx_shape", [
    (4864, 128, (1216, 24)),  # dense m2m senders of the multi-scale model
    (4864, 128, (4608, 8)),  # dense m2g senders
    (38384, 64, (307008,)),  # the gather probe
    (97, 4, (1001,)),  # ragged: E not a multiple of 8 or 32; 16-byte rows (W 4 f32, 8 bf16)
])
@pytest.mark.parametrize("variant", list(GATHERS))
def test_row_gather_kernels_equal_the_plain_version(cuda, variant, rows, w, idx_shape, dtype, itype):
    if w * torch.tensor([], dtype=dtype).element_size() % 16:
        w *= 2  # the narrowest row the kernel takes: 16 bytes
    g = torch.Generator().manual_seed(rows + w)
    tbl = torch.randn(rows, w, generator=g).to(dtype).to(cuda)
    idx = torch.randint(0, rows, idx_shape, generator=g).to(itype)
    idx.view(-1)[[0, -1]] = torch.tensor([rows + 3, -2]).to(itype)  # clamped into [0, rows)
    idx = idx.to(cuda)
    before = rg.LAUNCHES[variant]
    got = GATHERS[variant](tbl, idx)
    assert rg.LAUNCHES[variant] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (*idx_shape, w) and got.dtype == dtype
    assert torch.equal(got, rg.row_gather_reference(tbl, idx))


@pytest.mark.parametrize("itype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ppr,n", [  # 16-byte pieces per row, rows gathered
    *((ppr, n) for ppr in (1, 6, 8, 16, 32, 40, 64) for n in (5, 1001, 50001)),
    (8, 300007), (16, 300007), (32, 300007),
])
def test_row_gather_loop_lane_groups(cuda, ppr, n, dtype, itype):
    """The loop kernel's geometry: lane groups of ppr lanes (32 // ppr rows
    per warp step; ppr 6 leaves two lanes idle), rows wider than a warp in
    several steps (ppr 40: the second step's lanes 8-31 idle), n a multiple
    neither of the rows per step nor of a chunk, chunks of 1 to 32 rows (as
    many rows as spread n evenly over the card's warps), and at 300,007
    rows several chunks per warp, each with the next chunk's indices
    fetched ahead."""
    w = ppr * 16 // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator().manual_seed(ppr * 7 + n)
    rows = 301
    tbl = torch.randn(rows, w, generator=g).to(dtype).to(cuda)
    idx = torch.randint(-4, rows + 4, (n,), generator=g).to(itype).to(cuda)  # some clamped
    before = rg.LAUNCHES["loop"]
    got = rg.row_gather_loop(tbl, idx)
    assert rg.LAUNCHES["loop"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, rg.row_gather_reference(tbl, idx))


def test_row_gather_refuses_grad_on_the_card(cuda):
    """A bare row_gather has no backward; the model's Functions do."""
    tbl = torch.randn(8, 16, device=cuda, requires_grad=True)
    idx = torch.tensor([0, 0, 3, 7], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="sorted_gather"):
        rg.row_gather(tbl, idx)
    before = dict(rg.BWD_LAUNCHES)
    (grad,) = torch.autograd.grad(rg.sorted_gather(tbl, idx, 8).sum(), tbl)
    assert rg.BWD_LAUNCHES == {**before, "sorted": before["sorted"] + 1}
    assert torch.equal(grad.cpu()[:, 0], torch.tensor([2.0, 0, 0, 1, 0, 0, 0, 1]))


# --- the gathers' backwards (csrc/row_gather_bwd.cu) ---------------------------------

# Both kernels add in their plain versions' order, from 0, rounded once: bit for bit.


def _sorted_inputs(m, n, w, dtype, itype, device, seed, samples=1, pad=9):
    """g [m, w] and ascending ids over `samples` blocks of n / samples
    nodes, each block's ids random (repeats, gaps: rows with no id) up to
    a run of `pad` ids at its last node: a few padded rows in the dense
    layout, thousands of padded edges in the flattened COO layout."""
    gen = torch.Generator().manual_seed(seed)
    per, nodes = m // samples, n // samples
    idx = torch.sort(torch.randint(0, nodes, (samples, per), generator=gen)).values
    idx[:, per - min(per, pad):] = nodes - 1
    idx = (idx + torch.arange(samples)[:, None] * nodes).reshape(-1)
    g = torch.randn(m, w, generator=gen).to(dtype)
    return g.to(device), idx.to(itype).to(device)


def _plan_inputs(n, edges, w, dtype, itype, device, seed, k_slots=None, tsp_slots=None):
    """g [R*K, w] (nonzero at masked slots too: the kernel must skip them)
    and the transpose plan of random edges over n nodes, padded rows and
    all, built by the port's host code."""
    import numpy as np

    from sgnn_tpu_torch.physics.multi_scale_graph import CooEdges, dense_edges

    rng = np.random.default_rng(seed)
    coo = CooEdges(rng.integers(0, n, edges).astype(np.int32), rng.integers(0, n, edges).astype(np.int32))
    degree = np.bincount(coo.receivers).max()
    de = dense_edges(coo, n, len(np.unique(coo.receivers)) + 5, k_slots or int(degree), tsp_slots=tsp_slots)
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(de.senders.size, w, generator=gen).to(dtype).to(device)
    plan = [torch.from_numpy(de.tsp_rows).to(itype).to(device), torch.from_numpy(de.tsp_node).to(itype).to(device),
            torch.from_numpy(de.tsp_mask).to(device)]
    return g, plan


@pytest.mark.parametrize("itype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,w,samples,pad", [
    (19456, 77824, 128, 16, 2),  # the dense m2m receivers of a batch of 16
    (73728, 77824, 128, 16, 4),  # the dense m2g receivers
    (262144, 77824, 128, 16, 3000),  # the COO receivers: 3,000 padded ids at each sample's last node
    (6000, 50, 256, 1, 5000),  # a run over many chunks; W = 256 (64 pieces per row in f32, 32 in bf16)
    (3000, 3001, 128, 1, 40),  # at most one id per node (short chunks): runs across them, one of 40 ids
    (1001, 97, 8, 1, 9),  # ragged: runs of many ids, W of 16 bytes in bf16 (1 piece per row)
    (0, 5, 8, 1, 0),  # no ids: every row zero
])
def test_sorted_segment_sum_kernel_matches_plain_and_repeats_bits(cuda, m, n, w, samples, pad, dtype, itype):
    g, idx = _sorted_inputs(m, n, w, dtype, itype, cuda, seed=m + n, samples=samples, pad=pad)
    before = rg.BWD_LAUNCHES["sorted"]
    got = rg.sorted_segment_sum(g, idx, n)
    again = rg.sorted_segment_sum(g, idx, n)
    assert rg.BWD_LAUNCHES["sorted"] == before + 2
    torch.cuda.synchronize()
    want = rg.sorted_segment_sum_reference(g, idx, n)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)  # the same adds in the same order, rounded once
    assert torch.equal(got, again)


@pytest.mark.parametrize("itype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,edges,w,k_slots,tsp_slots", [
    (4864, 20000, 128, 24, None),  # m2m-like: about 4 edges per sender
    (301, 3000, 8, None, 40),  # plan slots past one warp's 32
    (50, 7, 16, None, None),  # few edges: most rows empty
])
def test_planned_gather_bwd_kernel_matches_plain_and_repeats_bits(cuda, n, edges, w, k_slots, tsp_slots, dtype,
                                                                  itype):
    g, plan = _plan_inputs(n, edges, w, dtype, itype, cuda, seed=n, k_slots=k_slots, tsp_slots=tsp_slots)
    before = rg.BWD_LAUNCHES["planned"]
    got = rg.planned_gather_bwd(g, *plan, n)
    again = rg.planned_gather_bwd(g, *plan, n)
    assert rg.BWD_LAUNCHES["planned"] == before + 2
    torch.cuda.synchronize()
    want = rg.planned_gather_bwd_reference(g, *plan, n)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)  # the same adds in the same order, rounded once
    assert torch.equal(got, again)


def _runs_plan(n, runs, ks, seed, masked_rows=0.1, pad_rows=0, past_rows=0):
    """A transpose plan built directly: node v gets runs[v] plan rows
    (tsp_node ascending), each with a random prefix of unmasked slots and
    random unmasked slots past it, a share of rows wholly masked, then
    pad_rows padded rows at the last node (all masked) and past_rows rows
    of a node past n (they add to no output row)."""
    gen = torch.Generator().manual_seed(seed)
    node = torch.repeat_interleave(torch.arange(n), runs)
    node = torch.cat([node, torch.full((pad_rows,), n - 1), torch.full((past_rows,), n + 3)])
    rs = node.numel()
    g_rows = max(rs * ks, 1)
    rows = torch.randint(-2, g_rows + 2, (rs, ks), generator=gen)  # some clamped into [0, g_rows)
    prefix = torch.randint(0, ks + 1, (rs, 1), generator=gen)
    mask = (torch.arange(ks)[None, :] < prefix) | (torch.rand(rs, ks, generator=gen) < 0.2)
    mask &= torch.rand(rs, 1, generator=gen) >= masked_rows
    mask[rs - pad_rows - past_rows: rs - past_rows] = False
    return g_rows, rows, node, mask


@pytest.mark.parametrize("itype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("w", [8, 128, 256])  # bf16: 1, 16, 32 pieces per row; f32: 2, 32, 64
@pytest.mark.parametrize("ks,run_max,pad_rows,past_rows", [
    (1, 3, 0, 0),  # one slot per plan row
    (7, 40, 37, 0),  # runs past 32 rows, so past one 32-row step of the scan; padded rows at the end
    (40, 5, 9, 5),  # slots past one read of 32 (f32) or 16 (bf16) lanes; rows past n
])
def test_planned_gather_bwd_runs_and_slots(cuda, ks, run_max, pad_rows, past_rows, w, dtype, itype):
    """The planned kernel's geometry against the plain version, bit for
    bit: runs of 0 to run_max plan rows per node (most nodes none, so
    gaps of zero rows; runs of up to 40 rows, so the group that owns a run
    sums rows of many warps and blocks, at the edges of the first ones
    too), wholly masked plan rows, tsp_slots 1, 7 and 40 (more slots than
    one round of a group's lanes), trailing padded plan rows, rows of a
    node past n, and lane groups of 1 to 32 lanes (W = 8 bf16 to 256
    f32, which takes two passes)."""
    n = 523
    gen = torch.Generator().manual_seed(ks * 1000 + w)
    runs = torch.randint(0, run_max + 1, (n,), generator=gen) * (torch.rand(n, generator=gen) < 0.3)
    runs[[15, 16, 127, 128]] = run_max  # long runs at a warp's and a block's edge
    g_rows, rows, node, mask = _runs_plan(n, runs, ks, seed=ks + w, pad_rows=pad_rows, past_rows=past_rows)
    g = torch.randn(g_rows, w, generator=gen).to(dtype).to(cuda)
    plan = [rows.to(itype).to(cuda), node.to(itype).to(cuda), mask.to(cuda)]
    got = rg.planned_gather_bwd(g, *plan, n)
    again = rg.planned_gather_bwd(g, *plan, n)
    torch.cuda.synchronize()
    want = rg.planned_gather_bwd_reference(g, *plan, n)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_functions_take_their_kernels_on_the_card(cuda, dtype):
    """sorted_gather, planned_gather and ordered_gather: the forward is the
    take kernel, each backward its kernel (ordered_gather's: the take kernel
    over the order, then the sorted sum), the gradients those of the plain
    versions; sorted_sum: the sorted sum kernel, its backward the take
    kernel. Every gradient repeats bit for bit."""
    import numpy as np

    from sgnn_tpu_torch.physics.multi_scale_graph import CooEdges, dense_edges

    rng = np.random.default_rng(1)
    n, w = 200, 32
    de = dense_edges(CooEdges(rng.integers(0, n, 900).astype(np.int32), rng.integers(0, n, 900).astype(np.int32)),
                     n, 200, 16)
    de = [torch.from_numpy(a).to(cuda) for a in de]
    sorted_s, order = torch.sort(de[1].reshape(-1).int(), stable=True)
    table = torch.randn(n, w, device=cuda).to(dtype).requires_grad_(True)
    rows = torch.randn(de[0].numel(), w, device=cuda).to(dtype).requires_grad_(True)
    cot_i = torch.randn(de[0].numel(), w, device=cuda).to(dtype)
    cot_j = (torch.randn(*de[1].shape, w, device=cuda) * de[2][..., None]).to(dtype)  # zero at masked slots
    cot_n = torch.randn(n, w, device=cuda).to(dtype)

    def grads():
        launches, bwd = dict(rg.LAUNCHES), dict(rg.BWD_LAUNCHES)
        outs = (rg.sorted_gather(table, de[0], n), rg.planned_gather(table, de[1], *de[3:], n),
                rg.ordered_gather(table, de[1], order, sorted_s, n), rg.sorted_sum(rows, de[0], n))
        got = torch.autograd.grad(outs, (table, rows), (cot_i, cot_j, cot_j, cot_n))
        assert rg.LAUNCHES[rg.MODEL_VARIANT] == launches[rg.MODEL_VARIANT] + 5  # 3 forwards, 2 backwards
        assert rg.BWD_LAUNCHES == {"sorted": bwd["sorted"] + 3, "planned": bwd["planned"] + 1}
        return got

    got, again = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    cj = cot_j.reshape(-1, w)
    want = (rg.sorted_segment_sum_reference(cot_i, de[0], n).float()
            + rg.planned_gather_bwd_reference(cj, *de[3:], n).float()
            + rg.sorted_segment_sum_reference(cj[order], sorted_s, n).float())
    atol = 1e-5 if dtype == torch.float32 else 2.0**-5 * float(want.abs().max())
    torch.testing.assert_close(got[0].float(), want, atol=atol, rtol=1e-5 if dtype == torch.float32 else 2.0**-6)
    assert torch.equal(got[1], cot_n[de[0].long()])


# --- the captured rollout: one step in a CUDA graph --------------------------------
# Captured and eager routes launch the same kernels on the same inputs, and
# no sum adds with atomics, so they agree bit for bit, every layout.


def _drifting_lattice(n_side, frames, seed, spacing=0.5):
    """A jittered lattice drifting by a random walk: [N, T, 2] float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xs = np.arange(n_side) * spacing
    base = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    walk = np.cumsum(rng.normal(scale=0.01, size=(frames, len(base), 2)), axis=0)
    return np.transpose(base[None] + walk + 0.02 * rng.normal(size=(1, len(base), 2)), (1, 0, 2)).astype(np.float32)


def _norm_stats(device, dim=2):
    from sgnn_tpu_torch.physics.simulator import NormStats

    g = torch.Generator().manual_seed(4)
    scale = dict(vel_mean=0.01, vel_std=0.05, acc_mean=0.001, acc_std=0.01)
    return NormStats(**{k: ((0.5 + torch.rand(dim, generator=g)) * s).to(device) for k, s in scale.items()})


def _single_scale(device, compute_dtype, s=6, frames=14):
    import numpy as np

    from sgnn_tpu_torch.physics.simulator import SimulatorConfig, simulator_init

    cfg = SimulatorConfig(latent_dim=32, num_message_passing_steps=2, num_mlp_layers=1, connectivity_radius=0.6,
                          input_sequence_length=s, max_neighbors=12, compute_dtype=compute_dtype,
                          symmetric_gather=compute_dtype == "bfloat16", domain=((-3.0, -3.0), (12.0, 12.0)))
    sim = simulator_init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    pos = _drifting_lattice(18, frames, seed=1)
    n = pos.shape[0]
    types = np.zeros(n, np.int64)
    types[:5] = -1  # erosional: follow the ground truth
    mask = np.ones(n, bool)
    mask[-7:] = False
    strains = np.random.default_rng(2).normal(size=(frames, n)).astype(np.float32)
    return sim, cfg, _norm_stats(device), (pos, types, strains, mask)


def _multi_scale(device, layout, compute_dtype, s=5, frames=12):
    import numpy as np

    from sgnn_tpu_torch.physics import multi_scale_graph as tg
    from sgnn_tpu_torch.physics.multi_scale_simulator import MultiScaleSimulatorConfig, multi_scale_simulator_init

    cfg = MultiScaleSimulatorConfig(latent_dim=32, num_message_passing_steps=2, num_mlp_layers=2,
                                    input_sequence_length=s, num_scales=2, window_size=2,
                                    compute_dtype=compute_dtype)
    sim = multi_scale_simulator_init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    xs, ys = np.meshgrid(np.arange(12) * 0.5, np.arange(5) * 0.5, indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], -1) + np.random.default_rng(0).normal(scale=0.01, size=(60, 2))
    n = len(grid)
    if layout == "dense":
        graph = tg.build_dense_static_graph(cfg.graph_config, grid, g2m_rows=32, m2m_rows=32, m2g_rows=n,
                                            tsp_rows={"g2m": n, "m2m": 32, "m2g": 32},
                                            tsp_slots={"g2m": 8, "m2m": 24, "m2g": 24})
    else:
        graph = tg.build_static_graph(cfg.graph_config, grid, g2m_pad=512, m2m_pad=256, m2g_pad=512)
    rng = np.random.default_rng(3)
    pos = (grid[:, None, :] + rng.normal(scale=0.01, size=(n, frames, 2)).cumsum(axis=1)).astype(np.float32)
    types = np.zeros(n, np.int64)
    types[:3] = -1
    strains = rng.normal(size=(frames, n)).astype(np.float32)
    blocks = 2 + cfg.num_message_passing_steps * (len(graph.m2m) if layout == "dense" else 1)
    return sim, cfg, _norm_stats(device), (pos, types, strains, graph), blocks


def _assert_no_sync(step, *args, **fixed):
    """One warm step of ``step`` under sync-debug mode "error"."""
    with torch.inference_mode():
        step(*args, **fixed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(*args, **fixed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_captured_rollout_equals_eager_single_scale(cuda, compute_dtype):
    """rollout: captured (the first call warms up, captures and replays;
    the second replays every step) equal to the eager loop with
    torch.equal; the forward kernel's launches counted per replay; a warm
    step needs no host sync."""
    from sgnn_tpu_torch.physics import captured_step
    from sgnn_tpu_torch.physics.rollout import rollout, rollout_step

    sim, cfg, stats, (pos, types, strains, mask) = _single_scale(cuda, compute_dtype)
    steps = pos.shape[1] - cfg.input_sequence_length
    eager = rollout(sim, cfg, stats, pos, types, strains, mask, capture=False)
    before = eb.LAUNCHES
    first = rollout(sim, cfg, stats, pos, types, strains, mask)
    assert eb.LAUNCHES - before == cfg.num_message_passing_steps * steps
    again = rollout(sim, cfg, stats, pos, types, strains, mask)
    assert eb.LAUNCHES - before == 2 * cfg.num_message_passing_steps * steps
    (captured,) = captured_step.steps_of(sim)
    assert captured.graph is not None and captured.replays == 2 * steps - 1
    for out in (first, again):
        for key in ("predicted_rollout", "predicted_strain", "rmse_position", "rmse_strain"):
            assert torch.equal(out[key], eager[key]), key

    s = cfg.input_sequence_length
    t = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    types_t = t(types)
    _assert_no_sync(rollout_step(sim, cfg, stats, "autoregressive"), t(pos[:, :s]), t(pos[:, s]), t(strains[s]),
                    particle_types=types_t, node_mask=t(mask), erosional=(types_t == -1)[:, None])


@pytest.mark.parametrize("layout,compute_dtype", [("dense", "float32"), ("dense", "bfloat16"), ("coo", "float32")])
def test_captured_ms_rollout_equals_eager(cuda, layout, compute_dtype):
    """ms_rollout: captured equal to eager with torch.equal, and two eager
    rollouts equal (every layout: no sum adds with atomics); 2 take
    launches and one sorted sum per block per step under replay; no host
    sync."""
    from sgnn_tpu_torch.physics import captured_step
    from sgnn_tpu_torch.physics.multi_scale_simulator import graph_to, ms_rollout, ms_rollout_step

    sim, cfg, stats, (pos, types, strains, graph), blocks = _multi_scale(cuda, layout, compute_dtype)
    steps = pos.shape[1] - cfg.input_sequence_length
    eager = ms_rollout(sim, cfg, stats, pos, types, strains, graph, capture=False)
    before, sums = rg.LAUNCHES[rg.MODEL_VARIANT], rg.BWD_LAUNCHES["sorted"]
    first = ms_rollout(sim, cfg, stats, pos, types, strains, graph)
    again = ms_rollout(sim, cfg, stats, pos, types, strains, graph)
    assert rg.LAUNCHES[rg.MODEL_VARIANT] - before == 2 * 2 * blocks * steps
    assert rg.BWD_LAUNCHES["sorted"] - sums == 2 * blocks * steps
    (captured,) = captured_step.steps_of(sim)
    assert captured.graph is not None and captured.replays == 2 * steps - 1
    eager_again = ms_rollout(sim, cfg, stats, pos, types, strains, graph, capture=False)
    for out in (first, again, eager_again):
        for key in ("predicted_rollout", "predicted_strain"):
            assert torch.equal(out[key], eager[key]), key

    s = cfg.input_sequence_length
    t = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    types_t = t(types)
    _assert_no_sync(ms_rollout_step(sim, cfg, stats, "autoregressive"), t(pos[:, :s]), t(pos[:, s]), t(strains[s]),
                    particle_types=types_t, erosional=(types_t == -1)[:, None], graph=graph_to(graph, cuda))


def test_captured_rollout_follows_the_weights(cuda):
    """The graph reads the parameters in place: load_state_dict changes the
    output and keeps the graph; a parameter whose storage is replaced is
    read by a new capture."""
    from sgnn_tpu_torch.physics import captured_step
    from sgnn_tpu_torch.physics.rollout import rollout

    sim, cfg, stats, (pos, types, strains, mask) = _single_scale(cuda, "float32")
    first = rollout(sim, cfg, stats, pos, types, strains, mask)["predicted_rollout"]
    other = {k: v * 1.01 for k, v in sim.state_dict().items()}
    sim.load_state_dict(other)
    (graph,) = [c.graph for c in captured_step.steps_of(sim)]
    moved = rollout(sim, cfg, stats, pos, types, strains, mask)["predicted_rollout"]
    assert [c.graph for c in captured_step.steps_of(sim)] == [graph]
    assert not torch.equal(moved, first)
    assert torch.equal(moved, rollout(sim, cfg, stats, pos, types, strains, mask, capture=False)["predicted_rollout"])
    p = next(sim.parameters())
    p.data = p.data.clone()
    replaced = rollout(sim, cfg, stats, pos, types, strains, mask)["predicted_rollout"]
    assert len(captured_step.steps_of(sim)) == 2
    assert torch.equal(replaced, moved)


def test_captured_rollout_spans_and_capture_counter(cuda):
    """Under a profile, a captured rollout's first call gives one
    ``step.warmup`` and one ``step.capture`` span under its ``rollout`` root
    and raises ``captured_step.CAPTURES`` by one; the second call replays
    every step, with neither."""
    from sgnn_tpu_torch.physics import captured_step
    from sgnn_tpu_torch.physics.rollout import rollout
    from sgnn_tpu_torch.utils import profiling

    sim, cfg, stats, (pos, types, strains, mask) = _single_scale(cuda, "float32")
    before = captured_step.CAPTURES
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(2):
            rollout(sim, cfg, stats, pos, types, strains, mask)
        torch.cuda.synchronize()
    assert captured_step.CAPTURES - before == 1
    recs = profiling.spans()
    profiling.reset()
    first, second = [s for s in recs if s.name == "rollout"]
    assert first.parent == second.parent == -1
    for name in ("step.warmup", "step.capture"):
        (span,) = [s for s in recs if s.name == name]
        assert span.root == first.index and recs[span.parent].name == "rollout.replays"
        assert span.end_ns > span.start_ns
    replays = [s for s in recs if s.name == "rollout.replays"]
    assert [s.root for s in replays] == [first.index, second.index]


def test_a_step_that_syncs_fails_to_capture_and_raises(cuda):
    """A step that reads the device back cannot be captured: the rollout
    raises, and no step after the warm-up runs eagerly in its place."""
    from sgnn_tpu_torch.physics import captured_step

    n, t = 64, 4
    window, gt_pos, gt_strain = torch.zeros(n, 3, 2, device=cuda), torch.randn(t, n, 2, device=cuda), \
        torch.randn(t, n, device=cuda)
    calls = []

    def step(window, gt_pos, gt_strain):
        calls.append(float(gt_strain.sum()))  # a host read: a sync, refused under capture
        return torch.cat([window[:, 1:], gt_pos[:, None]], dim=1), gt_pos * 2, gt_strain + 1

    captured = captured_step.CapturedStep(window, gt_pos, gt_strain, {})
    with pytest.raises(RuntimeError):
        captured.run(step, window, gt_pos, gt_strain, {})
    assert captured.graph is None and len(calls) == 1  # the warm-up step only
    torch.cuda.synchronize()


# --- the captured training step, fed by the prefetcher ------------------------------
# Captured and eager training launch the same kernels on the same batches
# and the same random stream, and no sum adds with atomics: parameters,
# Adam's moments and step counts, and every metric agree bit for bit, and
# two eager trainings too.

@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    from sgnn_tpu_torch.data.builder import DatasetBuilder
    from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

    root = tmp_path_factory.mktemp("card_train")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40, val_patterns=["-110"],
                   test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root


def _train_config(root, family, **kw):
    from sgnn_tpu_torch.train.config import TrainConfig

    base = dict(mode="train", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=32, dim=2, input_sequence_length=6,
                connection_radius=0.6, batch_size=4, noise_std=0.001, lr_init=1e-3, pad_multiple=32, seed=0,
                run_name=family, ntraining_steps=8, nsave_steps=4, log_every=4)
    if family == "multi_scale":
        base.update(num_scales=2, window_size=2, edge_pad_multiple=256, batch_size=2)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(family):
    from sgnn_tpu_torch.train import train, train_multi_scale

    return train_multi_scale if family == "multi_scale" else train


def _train_route(cfg, family, device, batches, capture, devices=None):
    """Train on ``batches`` from the seeded start (over the mesh of
    ``devices``, for a parallel run): (metrics per step, params, Adam's
    state, the step)."""
    built = _trainer(family).build_training(cfg, device, devices=devices)
    built.step_fn.capture = capture
    metrics = [{k: v.clone() for k, v in built.step_fn(b, i).items()} for i, b in enumerate(batches)]
    params = {k: v.clone() for k, v in built.sim.state_dict().items()}
    adam = [{k: v.clone() for k, v in st.items()} for st in built.optimizer.state.values()]
    step_fn = built.step_fn
    step_fn.close()
    return metrics, params, adam, step_fn


def _assert_same_training(a, b):
    for x, y in zip(a[0], b[0]):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(v, b[1][k]) for k, v in a[1].items())
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert all(torch.equal(x[k], y[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("family,kw", [("single_scale", {}), ("multi_scale", dict(ms_dense=False)),
                                       ("multi_scale", dict(ms_dense=True))], ids=["A_f32", "coo_f32", "dense_f32"])
def test_captured_training_equals_eager_and_repeats(cuda, tiny_data, family, kw):
    """5 steps captured (warm-up, capture, 4 replays) against the eager loop
    and a second eager run: torch.equal on every parameter, Adam's moments
    and step counts, and every metric; the kernels' counters add each
    replay's launches; the capture's lr and batch come from outside it."""
    cfg = _train_config(tiny_data, family, **kw)
    trainer = _trainer(family)
    built = trainer.build_training(cfg, cuda)
    source = built.batcher.epochs()
    batches = [trainer.batch_to_device(next(source), cuda) for _ in range(5)]
    del built
    before = dict(rg.BWD_LAUNCHES)
    captured = _train_route(cfg, family, cuda, batches, capture=True)
    per_step = {k: (rg.BWD_LAUNCHES[k] - before[k]) / 5 for k in before}
    before = dict(rg.BWD_LAUNCHES)
    eager = _train_route(cfg, family, cuda, batches, capture=False)
    assert {k: (rg.BWD_LAUNCHES[k] - before[k]) / 5 for k in before} == per_step
    assert per_step["sorted"] > 0  # A's sender backward and every multi-scale sum take the sorted kernel
    assert captured[3].graph is None and captured[3].replays == 4  # closed after 4 replays
    _assert_same_training(captured, eager)
    _assert_same_training(eager, _train_route(cfg, family, cuda, batches, capture=False))


def test_warm_captured_training_step_needs_no_host_sync(cuda, tiny_data):
    """A warm replay of the captured step (batch copied in, z drawn, lr
    filled, one graph launch) and a warm eager step pass sync-debug mode
    "error"."""
    from sgnn_tpu_torch.train import train

    cfg = _train_config(tiny_data, "single_scale")
    for capture in (True, False):
        built = train.build_training(cfg, cuda)
        built.step_fn.capture = capture
        source = built.batcher.epochs()
        batches = [train.batch_to_device(next(source), cuda) for _ in range(3)]
        built.step_fn(batches[0], 0)
        built.step_fn(batches[1], 1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            built.step_fn(batches[2], 2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        built.step_fn.close()


def test_prefetcher_delivers_the_host_batches_during_a_rollout_capture(cuda):
    """The prefetcher pins and copies on its own thread and stream while the
    main thread captures a rollout step: every batch arrives on the card
    equal to what the host sent, and the captured rollout equals the eager
    one."""
    import time

    import numpy as np

    from sgnn_tpu_torch.data.prefetch import DevicePrefetcher
    from sgnn_tpu_torch.physics.rollout import rollout

    rng = np.random.default_rng(5)
    host = [{"x": rng.normal(size=(256, 1024)).astype(np.float32), "i": np.full(3, i)} for i in range(48)]

    def slow():  # about half a second of staging, fresh host memory pinned for every batch
        for b in host:
            time.sleep(0.01)
            yield {k: v.copy() for k, v in b.items()}

    sim, cfg, stats, (pos, types, strains, mask) = _single_scale(cuda, "float32")
    eager = rollout(sim, cfg, stats, pos, types, strains, mask, capture=False)  # the kernels built
    with DevicePrefetcher(slow(), depth=len(host), device=cuda) as pf:
        captured = rollout(sim, cfg, stats, pos, types, strains, mask)  # captures while the thread stages
        got = list(pf)
    assert torch.equal(captured["predicted_rollout"], eager["predicted_rollout"])
    assert len(got) == len(host)
    for a, b in zip(got, host):
        assert a["x"].is_cuda and torch.equal(a["x"].cpu(), torch.from_numpy(b["x"]))
        assert torch.equal(a["i"].cpu(), torch.from_numpy(b["i"]))


# --- parallel runs: shards and replicas on one card --------------------------------


def halo_exchange_gradient_check(device):
    """Two shards of one graph on ``device``: every ext row's gradient
    reaches the row it came from (its own shard's, or the neighbour's
    through the exchange's backward), boundary zeros reach nothing."""
    from sgnn_tpu_torch.parallel.edge_partition import _halo_exchange

    torch.manual_seed(0)
    halo, n = 3, 8
    xs = [torch.randn(n, 4, device=device, requires_grad=True) for _ in range(2)]
    ext = _halo_exchange(xs, halo, [device, device])
    assert [tuple(e.shape) for e in ext] == [(n + 2 * halo, 4)] * 2
    assert not ext[0][:halo].any() and not ext[1][-halo:].any()  # boundary shards receive zeros
    assert torch.equal(ext[0][-halo:], xs[1][:halo]) and torch.equal(ext[1][:halo], xs[0][-halo:])
    ws = [torch.randn(n + 2 * halo, 4, device=device) for _ in range(2)]
    sum((w * e).sum() for w, e in zip(ws, ext)).backward()
    want0 = ws[0][halo : halo + n].clone()
    want0[-halo:] += ws[1][:halo]
    want1 = ws[1][halo : halo + n].clone()
    want1[:halo] += ws[0][-halo:]
    assert torch.equal(xs[0].grad, want0) and torch.equal(xs[1].grad, want1)


def test_halo_exchange_gradient_on_two_shards_of_one_card(cuda):
    halo_exchange_gradient_check(cuda)


def _parallel_batches(trainer, built, device, n):
    source = built.epochs()
    return [trainer.batch_to_device(next(source), device) for _ in range(n)]


PARALLEL_RUNS = dict(
    argnames="family,kw",
    argvalues=[("single_scale", dict(data_parallel=2)), ("multi_scale", dict(data_parallel=2, ms_dense=True)),
               ("single_scale", dict(graph_parallel=2, batch_size=1)),
               ("multi_scale", dict(graph_parallel=2, batch_size=1, ms_dense=True)),
               ("multi_scale", dict(graph_parallel=2, batch_size=1, ms_dense=False))],
    ids=["dp_A_f32", "dp_dense_f32", "gp_A_f32", "gp_ms_dense_f32", "gp_ms_coo_f32"],
)


@pytest.mark.parametrize(**PARALLEL_RUNS)
def test_parallel_training_captured_equals_eager(cuda, tiny_data, family, kw):
    """A data-parallel step (2 replicas) and a graph-parallel step (2
    shards; multi-scale: both layouts) on one card: one captured graph per
    step, equal to the eager loop with torch.equal on every parameter,
    Adam's state and metric."""
    cfg = _train_config(tiny_data, family, **kw)
    trainer = _trainer(family)
    devices = [cuda, cuda]
    built = trainer.build_training(cfg, cuda, devices=devices)
    assert built.mesh.one_device and built.step_fn.capturable
    batches = _parallel_batches(trainer, built, cuda, 5)
    del built
    captured = _train_route(cfg, family, cuda, batches, capture=True, devices=devices)
    eager = _train_route(cfg, family, cuda, batches, capture=False, devices=devices)
    _assert_same_training(captured, eager)
    assert captured[3].replays == 4


def test_rejected_captured_step_leaves_parameters_and_adam_bit_equal(cuda, tiny_data):
    """The graph-parallel step captured on one card: a replay whose halo
    guard fires (a slab's nodes teleported 20 units) leaves every bit of the
    parameters and of Adam's moments and step counts as they were; the next
    clean replay updates them."""
    from sgnn_tpu_torch.train import train

    cfg = _train_config(tiny_data, "single_scale", graph_parallel=2, batch_size=1)
    built = train.build_training(cfg, cuda, devices=[cuda, cuda])
    good = _parallel_batches(train, built, cuda, 3)
    step = built.step_fn
    step(good[0], 0)  # warm-up and capture
    step(good[1], 1)  # a replay
    bad = {k: v.clone() for k, v in good[2].items()}
    bad["positions"][: built.spec.nodes_per_shard // 2, :, 0] += 20.0
    before = ({k: v.clone() for k, v in built.sim.state_dict().items()},
              [{k: v.clone() for k, v in st.items()} for st in built.optimizer.state.values()])
    m = step(bad, 2)
    assert int(m["train/halo_violations"]) > 0 and int(m["train/halo_rejected"]) == 1
    assert all(torch.equal(v, before[0][k]) for k, v in built.sim.state_dict().items())
    for st, old in zip(built.optimizer.state.values(), before[1]):
        assert all(torch.equal(st[k], old[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    m = step(good[2], 3)
    assert int(m["train/halo_rejected"]) == 0 and step.replays == 3
    assert any(not torch.equal(v, before[0][k]) for k, v in built.sim.state_dict().items())
    step.close()


@pytest.mark.parametrize(**PARALLEL_RUNS)
def test_parallel_training_on_two_cards_equals_one_card(cuda, tiny_data, family, kw):
    """The same parallel run with its second replica or shard on a second
    card (a copy of the model there, its gradients folded onto the first
    card's; the step runs eagerly) equals the run with both on one card,
    bit for bit. Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cfg = _train_config(tiny_data, family, **kw)
    trainer = _trainer(family)
    one, two = [torch.device("cuda", 0)] * 2, [torch.device("cuda", 0), torch.device("cuda", 1)]
    built = trainer.build_training(cfg, one[0], devices=two)
    assert not built.mesh.one_device and not built.step_fn.capturable and len(built.step_fn.replicas.copies) == 1
    batches = _parallel_batches(trainer, built, one[0], 4)
    del built
    _assert_same_training(_train_route(cfg, family, one[0], batches, capture=True, devices=two),
                          _train_route(cfg, family, one[0], batches, capture=True, devices=one))


def test_two_process_nccl_dp_step_matches_one_process(cuda, tmp_path):
    """The multihost test on the cards: two processes in an NCCL group, one
    card each, end bit-equal and within 1e-6 of one process's
    ``data_parallel: 2`` step. Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from test_torch_port_multihost import two_process_check

    two_process_check(tmp_path, device="cuda")


# --- the capacity knobs on the card ---------------------------------------------------


def _knob_batch(device, cfg, b=2, seed=4):
    """A drifting-lattice batch of b graphs for forward_batched."""
    import numpy as np

    pos = _drifting_lattice(18, cfg.input_sequence_length, seed=seed)
    seq = torch.as_tensor(np.stack([pos] * b), device=device)
    types = torch.zeros(seq.shape[:2], dtype=torch.long, device=device)
    return seq, types


def _grads_of(sim, cfg, stats, seq, types):
    from sgnn_tpu_torch.physics.simulator import forward_batched

    sim.zero_grad()
    acc, strain = forward_batched(sim, cfg, stats, seq, types)
    (acc.float().square().sum() + strain.float().square().sum()).backward()
    return [acc.detach(), strain.detach()] + [p.grad.clone() for p in sim.parameters()]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_modes_are_bit_equal_on_the_card(cuda, compute_dtype):
    """Every remat mode's outputs and gradients torch.equal to remat=False,
    on the kernels (edge block forward and backward, take kernel)."""
    import dataclasses

    sim, cfg, stats, _ = _single_scale(cuda, compute_dtype)
    seq, types = _knob_batch(cuda, cfg)
    ref = _grads_of(sim, cfg, stats, seq, types)
    for mode in (True, "xj_msg", "full", "group"):
        got = _grads_of(sim, dataclasses.replace(cfg, remat=mode), stats, seq, types)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), mode


def test_packed_route_equals_unfused_on_the_card(cuda):
    """B's packed gather (the take kernel over the padded f32 table) against
    the unfused symmetric route: outputs and gradients torch.equal."""
    import dataclasses

    sim, cfg, stats, _ = _single_scale(cuda, "bfloat16")
    assert cfg.symmetric_gather
    seq, types = _knob_batch(cuda, cfg)
    before = rg.LAUNCHES["take"]
    got = _grads_of(sim, cfg, stats, seq, types)
    assert rg.LAUNCHES["take"] == before + 1  # the packed gather
    ref = _grads_of(sim, dataclasses.replace(cfg, packed_gather_max_nodes=1), stats, seq, types)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_banded_index_gathers_equal_plain_on_the_card(cuda):
    """The banded index built on the card equals the one built on the CPU,
    and gathers JAX's clamped rows: table[idx] where the band holds, the
    window's clamp where it breaks (both checked against the CPU)."""
    from sgnn_tpu_torch.ops import sym_gather as sg

    g = torch.Generator().manual_seed(0)
    n, k, w = 300_000, 8, 40
    send = (torch.arange(n)[:, None] + torch.randint(-w, w + 1, (n, k), generator=g)).clamp(0, n - 1)
    bad = send.clone()
    bad.view(-1)[torch.randint(0, n * k, (50,), generator=g)] = torch.randint(0, n, (50,), generator=g)
    table = torch.randn(n, 64, generator=g)
    for ids in (send, bad):
        cpu = sg.forward_banded_index(ids.reshape(-1), n, w)
        assert cpu is not None  # 300k rows fanned out 8x: the banded route
        card = sg.forward_banded_index(ids.reshape(-1).to(cuda), n, w)
        assert torch.equal(card.cpu(), cpu)
        out = rg.row_gather_take(table.to(cuda), card)
        assert torch.equal(out.cpu(), table[cpu])
    assert torch.equal(sg.forward_banded_index(send.reshape(-1), n, w), send.reshape(-1))
