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

# f32: the kernels add in the plain versions' order, from 0; the stated
# limit is 1e-6 relative and absolute. bf16: f32 sums rounded once, within
# one bf16 step (2^-7 relative) of the plain version.
BWD_GATHER_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (0.0, 2.0**-7)}  # (atol, rtol)


def _sorted_inputs(m, n, w, dtype, itype, device, seed):
    """g [m, w] and ascending ids with repeats, gaps (rows with no id) and
    a long run at the last node (the dense layout's padded rows)."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.sort(torch.randint(0, n, (m,), generator=gen)).values
    idx[-min(m, 9):] = n - 1
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


def _check_bwd_gather(got, want, dtype):
    atol, rtol = BWD_GATHER_TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert (err <= atol + rtol * want.float().abs()).all(), float(err.max())


@pytest.mark.parametrize("itype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,w", [
    (19456, 77824, 128),  # the m2m receivers of a batch of 16
    (73728, 77824, 128),  # the m2g receivers
    (1001, 97, 8),  # ragged: runs of many ids, W of 16 bytes in bf16
    (0, 5, 8),  # no ids: every row zero
])
def test_sorted_segment_sum_kernel_matches_plain_and_repeats_bits(cuda, m, n, w, dtype, itype):
    g, idx = _sorted_inputs(m, n, w, dtype, itype, cuda, seed=m + n)
    before = rg.BWD_LAUNCHES["sorted"]
    got = rg.sorted_segment_sum(g, idx, n)
    again = rg.sorted_segment_sum(g, idx, n)
    assert rg.BWD_LAUNCHES["sorted"] == before + 2
    torch.cuda.synchronize()
    _check_bwd_gather(got, rg.sorted_segment_sum_reference(g, idx, n), dtype)
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
    _check_bwd_gather(got, rg.planned_gather_bwd_reference(g, *plan, n), dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_functions_take_their_kernels_on_the_card(cuda, dtype):
    """sorted_gather and planned_gather: the forward is the take kernel,
    each backward its kernel, the gradients those of the plain versions;
    indexed_gather's backward is index_add_."""
    import numpy as np

    from sgnn_tpu_torch.physics.multi_scale_graph import CooEdges, dense_edges

    rng = np.random.default_rng(1)
    n, w = 200, 32
    de = dense_edges(CooEdges(rng.integers(0, n, 900).astype(np.int32), rng.integers(0, n, 900).astype(np.int32)),
                     n, 200, 16)
    de = [torch.from_numpy(a).to(cuda) for a in de]
    table = torch.randn(n, w, device=cuda).to(dtype).requires_grad_(True)
    launches, bwd = dict(rg.LAUNCHES), dict(rg.BWD_LAUNCHES)
    proj_i = rg.sorted_gather(table, de[0], n)
    xj = rg.planned_gather(table, de[1], *de[3:], n)
    xs = rg.indexed_gather(table, de[1], n)
    cot_i = torch.randn_like(proj_i)
    cot_j = torch.randn_like(xj) * de[2][..., None]  # zero at masked slots, as the model's
    got = torch.autograd.grad((proj_i, xj, xs), table, (cot_i, cot_j, cot_j))[0]
    assert rg.LAUNCHES[rg.MODEL_VARIANT] == launches[rg.MODEL_VARIANT] + 3
    assert rg.BWD_LAUNCHES == {"sorted": bwd["sorted"] + 1, "planned": bwd["planned"] + 1}
    want = (rg.sorted_segment_sum_reference(cot_i, de[0], n).float()
            + rg.planned_gather_bwd_reference(cot_j.reshape(-1, w), *de[3:], n).float()
            + torch.zeros(n, w, device=cuda).index_add_(0, de[1].reshape(-1), cot_j.reshape(-1, w).float()))
    atol = 1e-5 if dtype == torch.float32 else 2.0**-5 * float(want.abs().max())
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=1e-5 if dtype == torch.float32 else 2.0**-6)
