"""The port's multi-scale training slice against the JAX package on CPU:
the gathers' backwards, batch flattening, the training batcher, the
batched training forward, one full training step (loss, aux, gradients,
parameters after Adam) and the CLI in train mode (train, predict and
resume are in ``test_torch_port_families.py``).

JAX params are carried across by ``ms_state_dict_from_jax``; inputs and
JAX's noise come from numpy seeds and JAX keys and are handed to both.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sgnn_tpu.data import static_graph_loader as jloader
from sgnn_tpu.models import multi_scale as jmodel
from sgnn_tpu.physics import multi_scale_graph as jg
from sgnn_tpu.physics import multi_scale_simulator as jms
from sgnn_tpu.physics import noise as jnoise
from sgnn_tpu.physics.simulator import NormStats as JNormStats
from sgnn_tpu.train import config as jconfig
from sgnn_tpu_torch.data import static_graph_loader as tloader
from sgnn_tpu_torch.data.builder import DatasetBuilder
from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset
from sgnn_tpu_torch.models import multi_scale as tmodel
from sgnn_tpu_torch.ops import row_gather as rg
from sgnn_tpu_torch.physics import multi_scale_graph as tg
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics.simulator import NormStats as TNormStats
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train import train_multi_scale as ttms
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.jax_params import ms_state_dict_from_jax

jtms = importlib.import_module("sgnn_tpu.train.train_multi_scale")

torch.set_num_threads(1)

S, DIM, LR = 5, 2, 1e-3
# gathers' backwards, f32: the same sums in another order (XLA's segment
# sum and identity dot against the kernels' index order)
GATHER_RTOL, GATHER_ATOL_REL = 1e-6, 1e-6
# training step, f32: the tolerances of tests/test_torch_port_train.py
LOSS_TOL = dict(rtol=2e-5, atol=1e-7)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-7, 2.0**-22
# bf16 edge tensors: a flipped bf16 rounding moves an edge value by 2^-8
# relative, and the sums of the backward run in another order; gradients
# and loss agree to ~1e-2 (tests/test_torch_port_train.py's bf16 limit)
BF16_TOL = 1e-2
# bf16 gradients of sums that cancel: within this factor of JAX's own
# bf16-vs-f32 gap (the repo's bf16 contract, chip_smoke.BF16_GAP_FACTOR;
# measured on the CPU over 3 seeds x 2 layouts: at most 0.58 of the limit)
BF16_GAP_FACTOR = 2.0
# the batched training forward: the forwards' own limits
# (tests/test_torch_port_multi_scale.py)
FWD_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2.0**-8, atol=2.0**-8)}


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 step (8 significant bits) at |x|; the smallest normal's at 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def to_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def assert_gather_grad(got: torch.Tensor, want, dtype):
    got, want = to_f32(got), to_f32(want)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=GATHER_RTOL, atol=GATHER_ATOL_REL * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= bf16_ulp(want)).all(), np.abs(got - want).max()


# --- the gathers' backwards --------------------------------------------------------

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _plan(rng, n, edges, r_pad_extra=3, tsp_pad_extra=5):
    """A dense edge set over n nodes with its transpose plan, padded
    receiver rows and padded plan rows (last node, mask False)."""
    coo = tg.CooEdges(rng.integers(0, n, edges).astype(np.int32), rng.integers(0, n, edges).astype(np.int32))
    rs = len(np.unique(coo.senders))
    return tg.dense_edges(coo, n, len(np.unique(coo.receivers)) + r_pad_extra,
                          int(np.bincount(coo.receivers).max()), tsp_rows_pad=rs + tsp_pad_extra)


def _jax_sorted_vjp(table, idx, g, jdt):
    _, vjp = jax.vjp(lambda t: jmodel._sorted_gather(t, jnp.asarray(idx), len(table)), jnp.asarray(table, jdt))
    return vjp(jnp.asarray(g, jdt))[0]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_sorted_gather_grad_matches_jax(rng, dt):
    """Runs of one to many ids, empty rows (gaps), a padded run at the last
    node; f32 to 1e-6. bf16: JAX's segment sum rounds to bf16 after every
    add, the kernel once after an f32 sum, so runs of three or more are
    held against JAX's f32 VJP of the same bf16 values rounded once, and
    runs of at most two (one rounding either way) against JAX's bf16 VJP;
    both to one bf16 step."""
    tdt, jdt = DTYPES[dt]
    n, w = 40, 8
    idx = np.sort(np.concatenate([rng.integers(0, n - 10, 60), np.full(7, n - 1)])).astype(np.int32)
    table = rng.normal(size=(n, w)).astype(np.float32)
    g = np.array(jnp.asarray(rng.normal(size=(len(idx), w)), jdt).astype(jnp.float32))
    short = np.unique(idx)  # each id once, then a second copy of every other one
    short = np.sort(np.concatenate([short, short[::2]])).astype(np.int32)
    for ids, jax_dt in ((idx, jdt if dt == "f32" else jnp.float32), (short, jdt)):
        cot = g[: len(ids)]
        want = _jax_sorted_vjp(table, ids, cot, jax_dt).astype(jdt)
        tab = torch.from_numpy(table).to(tdt).requires_grad_(True)
        out = rg.sorted_gather(tab, torch.from_numpy(ids), n)
        assert torch.equal(out.detach(), tab.detach()[ids])
        (got,) = torch.autograd.grad(out, tab, torch.from_numpy(cot).to(tdt))
        assert got.dtype == tdt and not got[np.setdiff1d(np.arange(n), ids)].any()
        assert_gather_grad(got, want, tdt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_planned_gather_grad_matches_jax(rng, dt):
    """The transpose plan of random edges: padded receiver rows, padded plan
    rows at the last node, senders with no edge; cotangents nonzero at
    masked slots too (the plan must skip them)."""
    tdt, jdt = DTYPES[dt]
    n, w = 50, 16
    de = _plan(rng, n, 120)
    assert (de.tsp_node[-5:] == n - 1).all() and not de.tsp_mask[-5:].any()
    table = rng.normal(size=(n, w)).astype(np.float32)
    g = rng.normal(size=(*de.senders.shape, w)).astype(np.float32)
    plan = (de.tsp_rows, de.tsp_node, de.tsp_mask)
    _, vjp = jax.vjp(lambda t: jmodel._planned_gather(t, jnp.asarray(de.senders), *map(jnp.asarray, plan), n),
                     jnp.asarray(table, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    tab = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = rg.planned_gather(tab, torch.from_numpy(de.senders), *map(torch.from_numpy, plan), n)
    assert out.shape == (*de.senders.shape, w) and torch.equal(out.detach(), tab.detach()[de.senders])
    (got,) = torch.autograd.grad(out, tab, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    assert_gather_grad(got, want, tdt)


@pytest.mark.parametrize("tsp_slots", [1, 7, 40])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_planned_gather_grad_matches_jax_at_plan_widths(rng, dt, tsp_slots):
    """The plan geometries the card tests hold the kernel to, bit for bit,
    against its plain version: plan slots 1, 7 and 40 (past one read of 16
    or 32 lanes), a plan row wholly masked, trailing padded plan rows, and
    nodes with no plan row; the plain version against JAX's VJP."""
    tdt, jdt = DTYPES[dt]
    n, w = 60, 16
    deg = rng.integers(1, tsp_slots + 1, 40)  # out-degree of senders 0..39; 40..59 send nothing
    snd = np.repeat(np.arange(40), deg).astype(np.int32)
    coo = tg.CooEdges(snd, rng.integers(0, n, len(snd)).astype(np.int32))
    de = tg.dense_edges(coo, n, len(np.unique(coo.receivers)) + 2, int(np.bincount(coo.receivers).max()),
                        tsp_rows_pad=40 + 6, tsp_slots=tsp_slots)
    de.tsp_mask[3] = False  # a sender's plan row wholly masked: it adds nothing
    assert (de.tsp_node[-6:] == n - 1).all() and not de.tsp_mask[-6:].any()
    table = rng.normal(size=(n, w)).astype(np.float32)
    g = rng.normal(size=(*de.senders.shape, w)).astype(np.float32)
    plan = (de.tsp_rows, de.tsp_node, de.tsp_mask)
    _, vjp = jax.vjp(lambda t: jmodel._planned_gather(t, jnp.asarray(de.senders), *map(jnp.asarray, plan), n),
                     jnp.asarray(table, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    tab = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = rg.planned_gather(tab, torch.from_numpy(de.senders), *map(torch.from_numpy, plan), n)
    (got,) = torch.autograd.grad(out, tab, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and not got[3].any() and not got[40:].any()
    assert_gather_grad(got, want, tdt)


def test_backward_plain_versions_sum_in_index_order(rng):
    """The plain versions add each run from 0 in index (slot, then plan
    row) order, as the kernels do; checked against a Python loop."""
    n, w = 12, 4
    idx = np.sort(rng.integers(0, n, 30))
    g = torch.from_numpy(rng.normal(size=(30, w)).astype(np.float32))
    want = torch.zeros(n, w)
    for i, s in enumerate(idx):
        want[s] = want[s] + g[i]
    assert torch.equal(rg.sorted_segment_sum_reference(g, torch.from_numpy(idx), n), want)
    de = _plan(rng, n, 40)
    gp = torch.from_numpy(rng.normal(size=(de.senders.size, w)).astype(np.float32))
    want = torch.zeros(n, w)
    for r, node in enumerate(de.tsp_node):
        row = torch.zeros(w)
        for k in range(de.tsp_rows.shape[1]):
            if de.tsp_mask[r, k]:
                row = row + gp[de.tsp_rows[r, k]]
        want[node] = want[node] + row
    got = rg.planned_gather_bwd_reference(gp, *map(torch.from_numpy, (de.tsp_rows, de.tsp_node, de.tsp_mask)), n)
    assert torch.equal(got, want)


def _coo_like_ids(rng, samples=3, n=40, pad=150):
    """Flattened COO-like receivers: per sample, runs of 0-20 ids over its
    first n - 1 nodes, then `pad` padded ids at its last node (as
    ``flatten_ms_graph`` re-points them), so runs cross chunks and one
    spans several."""
    out = []
    for s in range(samples):
        runs = rng.integers(0, 21, n - 1) * (rng.random(n - 1) < 0.8)
        out += [np.repeat(np.arange(n - 1), runs) + s * n, np.full(pad, s * n + n - 1)]
    return np.concatenate(out), samples * n


def _chunk_edge_ids(chunk, n):
    """Ids below 0, a run that exactly fills a chunk, a run ending on a
    chunk boundary, runs of one id, a run over several chunks, ids past
    the end (n) and nodes 10 to n - 1 with no id; 5 * chunk + 3 positions."""
    return np.concatenate([np.full(3, -4), np.full(chunk - 3, 0), np.full(chunk, 2), np.full(chunk - 5, 3),
                           np.arange(4, 9), np.full(2 * chunk - 4, 9), np.full(7, n + 1)])


def _emulate_sorted_kernels(g: torch.Tensor, ids: np.ndarray, n: int, chunk: int) -> torch.Tensor:
    """``csrc/row_gather_bwd.cu``'s two sorted kernels, group by group, in
    f32 (one group's lanes hold one row's pieces): sorted_segment_sum_kernel
    (a group per chunk of `chunk` positions: runs inside the chunk to their
    node, the zero rows before each run start and, in the chunk that holds
    position m, after the last id; a head or tail f32 partial for a run
    that crosses the chunk's edge), then sorted_segment_combine_kernel (a
    warp per chunk boundary: where the run there crosses no earlier
    boundary, its partials in chunk order from 0). Each row must be
    written once and each partial read once."""
    m, w = g.shape
    data = g.float()
    ids = [int(v) for v in ids]
    out = torch.full((n, w), float("nan"))
    writes = np.zeros(n, int)
    partials, used = {}, []
    for ch in range(m // chunk + 1):
        begin, end = ch * chunk, min(ch * chunk + chunk, m)
        cur, summing, head, acc = ids[begin - 1] if begin else -1, False, True, torch.zeros(w)
        for i in range(begin, end + 1):  # i == end: the chunk's last run ends
            if i < end and ids[i] == cur:
                summing, acc = True, acc + data[i]
                continue
            goes_on = i == end and end < m and ids[end] == cur
            if summing and 0 <= cur < n:
                if head or goes_on:
                    partials[(ch, 0 if head else 1)] = acc
                else:
                    out[cur], writes[cur] = acc.to(g.dtype).float(), writes[cur] + 1
            if i < end:
                out[max(cur + 1, 0):max(min(ids[i], n), 0)] = 0.0
                writes[max(cur + 1, 0):max(min(ids[i], n), 0)] += 1
                cur, summing, head, acc = ids[i], True, False, torch.zeros(w) + data[i]
        if ch == m // chunk:
            out[max(cur + 1, 0):] = 0.0
            writes[max(cur + 1, 0):] += 1
    for b in range(1, (m - 1) // chunk + 1 if m else 0):
        at, node = b * chunk, ids[b * chunk]
        if node != ids[at - 1] or (b > 1 and ids[at - chunk - 1] == node) or not 0 <= node < n:
            continue
        last = b
        while (last + 1) * chunk < m and ids[(last + 1) * chunk] == node:
            last += 1
        keys = [(b - 1, 1)] + [(c, 0) for c in range(b, last + 1)]
        acc = torch.zeros(w)
        for key in keys:
            acc = acc + partials[key]
        used += keys
        out[node], writes[node] = acc.to(g.dtype).float(), writes[node] + 1
    assert (writes == 1).all(), np.flatnonzero(writes != 1)
    assert sorted(used) == sorted(partials)
    return out.to(g.dtype)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["coo_like", "chunk_edges_many", "chunk_edges_few", "few", "many", "one_id",
                                  "none"])
def test_sorted_kernels_emulated_group_by_group_equal_the_plain_version(rng, case, dt):
    """The sorted kernels' index logic, emulated group by group, against
    ``sorted_segment_sum_reference``, bit for bit, at both chunk lengths
    (more ids than nodes: 128; at most one per node: 16): COO-like
    receivers with a padded run over several chunks, runs that fill a
    chunk or end on its edge, ids outside [0, N), a single id, no id."""
    if case == "coo_like":
        ids, n = _coo_like_ids(rng)
    elif case == "chunk_edges_many":
        ids, n = _chunk_edge_ids(rg.SORTED_CHUNK_MANY, 30), 30
    elif case == "chunk_edges_few":
        ids, n = _chunk_edge_ids(rg.SORTED_CHUNK_FEW, 90), 90
    elif case in ("few", "many"):
        n = 400 if case == "few" else 47
        ids = np.sort(rng.integers(-2, 103, 390 if case == "few" else 600))  # runs of 1-10 ids, gaps
    else:
        ids, n = np.arange(1 if case == "one_id" else 0) + 5, 9
    chunk = rg.sorted_chunk(len(ids), n)
    assert chunk == {"coo_like": rg.SORTED_CHUNK_MANY, "chunk_edges_many": rg.SORTED_CHUNK_MANY,
                     "many": rg.SORTED_CHUNK_MANY}.get(case, rg.SORTED_CHUNK_FEW)
    g = torch.from_numpy(rng.normal(size=(len(ids), 8)).astype(np.float32)).to(DTYPES[dt][0])
    want = rg.sorted_segment_sum_reference(g, torch.from_numpy(ids), n)
    assert torch.equal(_emulate_sorted_kernels(g, ids, n, chunk), want)


def test_sorted_plain_version_keeps_the_index_order_sum_inside_a_chunk(rng):
    """A run inside one chunk gives the bits of its index-order sum from 0
    (the plain version before the chunk split); a run across chunks adds
    its chunks' sums in chunk order, within f32 rounding of that sum."""
    ids, n = _coo_like_ids(rng)
    g = torch.from_numpy(rng.normal(size=(len(ids), 8)).astype(np.float32))
    old = rg._ordered_segment_sum(g, torch.from_numpy(ids), n)
    got = rg.sorted_segment_sum_reference(g, torch.from_numpy(ids), n)
    at = [np.flatnonzero(ids == v) // rg.sorted_chunk(len(ids), n) for v in range(n)]
    inside = np.array([len(c) == 0 or c[0] == c[-1] for c in at])
    assert (~inside).sum() > 0 and inside.sum() > n // 2
    assert torch.equal(got[inside], old[inside])
    torch.testing.assert_close(got, old, rtol=1e-6, atol=1e-5)
    short = np.sort(np.concatenate([np.arange(10), np.arange(10)]))  # 20 ids: one chunk
    gs = g[:20]
    assert torch.equal(rg.sorted_segment_sum_reference(gs, torch.from_numpy(short), 12),
                       rg._ordered_segment_sum(gs, torch.from_numpy(short), 12))


# sha256 (first 16 hex digits) of planned_gather_bwd_reference's output on
# the inputs below, from the plain version as it was before the sorted
# sum's chunk split: its order and bits must not move
PLANNED_BITS = {"f32": "b1555ceba1039b82", "bf16": "68e290a2e6116f18"}


@pytest.mark.parametrize("dt", list(DTYPES))
def test_planned_plain_version_keeps_its_bits(dt):
    import hashlib

    rng = np.random.default_rng(23)
    n, w = 90, 16
    coo = tg.CooEdges(rng.integers(0, n, 700).astype(np.int32), rng.integers(0, n, 700).astype(np.int32))
    de = tg.dense_edges(coo, n, len(np.unique(coo.receivers)) + 4, int(np.bincount(coo.receivers).max()),
                        tsp_rows_pad=len(np.unique(coo.senders)) + 6)
    g = torch.from_numpy(rng.normal(size=(de.senders.size, w)).astype(np.float32)).to(DTYPES[dt][0])
    got = rg.planned_gather_bwd_reference(g, *map(torch.from_numpy, (de.tsp_rows, de.tsp_node, de.tsp_mask)), n)
    bits = got.view(torch.int16 if dt == "bf16" else torch.int32).numpy().tobytes()
    assert hashlib.sha256(bits).hexdigest()[:16] == PLANNED_BITS[dt]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_sorted_gather_grad_matches_jax_at_coo_shape(rng, dt):
    """Flattened COO-like receivers of 3 samples with a padded run of 150
    ids at each sample's last node (several chunks): the backward against
    JAX's VJP of ``_sorted_gather`` (bf16: against JAX's f32 VJP of the
    same bf16 values, rounded once), at the tolerances above."""
    tdt, jdt = DTYPES[dt]
    ids, n = _coo_like_ids(rng)
    ids = ids.astype(np.int32)
    table = rng.normal(size=(n, 8)).astype(np.float32)
    g = np.array(jnp.asarray(rng.normal(size=(len(ids), 8)), jdt).astype(jnp.float32))
    want = _jax_sorted_vjp(table, ids, g, jnp.float32).astype(jdt)
    tab = torch.from_numpy(table).to(tdt).requires_grad_(True)
    (got,) = torch.autograd.grad(rg.sorted_gather(tab, torch.from_numpy(ids), n), tab, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    assert_gather_grad(got, want, tdt)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    g = torch.zeros(4, 8)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids for"):
        rg.sorted_segment_sum(g, idx[:3], 5)
    with pytest.raises(TypeError, match="int32 or int64"):
        rg.sorted_segment_sum(g, idx.float(), 5)
    with pytest.raises(ValueError, match="16 bytes"):
        rg.sorted_segment_sum(torch.zeros(4, 3), idx, 5)
    with pytest.raises(ValueError, match="contiguous"):
        rg.sorted_segment_sum(torch.zeros(8, 4).t(), idx, 5)
    plan = (torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, dtype=torch.int64), torch.zeros(2, 3, dtype=torch.bool))
    with pytest.raises(TypeError, match="one index dtype"):
        rg.planned_gather_bwd(g, *plan, 5)
    with pytest.raises(ValueError, match="bool tsp_mask"):
        rg.planned_gather_bwd(g, plan[0], plan[0][:, 0].contiguous(), plan[2].int(), 5)
    with pytest.raises(ValueError, match="num_nodes=5"):
        rg.sorted_gather(torch.zeros(4, 8), idx, 5)


# --- batches ---------------------------------------------------------------------


def bar_grid(nx, ny, jitter, seed):
    xs, ys = np.meshgrid(np.arange(nx) * 0.5, np.arange(ny) * 0.5, indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], -1)
    return grid + np.random.default_rng(seed).normal(scale=jitter, size=grid.shape)


def batched_graphs(layout, n=64):
    """Three samples' graphs (60 nodes each, padded to n), built and
    stacked by each package (numpy)."""
    grids = [bar_grid(12, 5, 0.01, s) for s in range(3)]
    out = []
    for mod, loader in ((jg, jloader), (tg, tloader)):
        cfg = mod.MultiScaleConfig(num_scales=3, window_size=2)
        if layout == "dense":
            kw = dict(g2m_rows=32, m2m_rows=[24, 16], m2g_rows=n, m2m_slots=[24, 20],
                      tsp_rows={"g2m": n, "m2m": [24, 16], "m2g": 24}, tsp_slots={"g2m": 8, "m2m": 24, "m2g": 24})
            graphs = [mod.build_dense_static_graph(cfg, grid, **kw) for grid in grids]
        else:
            graphs = [mod.build_static_graph(cfg, grid, g2m_pad=512, m2m_pad=256, m2g_pad=512) for grid in grids]
        out.append(loader._stack_graphs(graphs))
    return out


def assert_same_arrays(a, b, where=""):
    if isinstance(a, (tuple, list)):
        if type(a).__name__ == "PaddedEdges" and len(a) == len(b) + 1:
            # the port's own field, the sender order its deterministic sender
            # backward reads (JAX's scatters): the stable sort of the senders,
            # padding last, computed here from JAX's arrays
            np.testing.assert_array_equal(np.asarray(a.order), tg.sender_order(np.asarray(b.senders),
                                                                               np.asarray(b.mask)),
                                          err_msg=f"{where}.order")
            a, b = tuple(a[:-1]), tuple(b)
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_arrays(x, y, f"{where}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_stack_and_flatten_match_jax_exactly(layout):
    n = 64
    jgraph, tgraph = batched_graphs(layout, n)
    assert_same_arrays(tgraph, jgraph)
    tloader.check_sorted_ids(tgraph, n)
    jflat = (jmodel.flatten_dense_ms_graph if layout == "dense" else jmodel.flatten_ms_graph)(
        jax.tree.map(jnp.asarray, jgraph), n)
    tflat = (tmodel.flatten_dense_ms_graph if layout == "dense" else tmodel.flatten_ms_graph)(
        tms.graph_to(tgraph, torch.device("cpu")), n)
    numpy_flat = jax.tree.map(lambda t: t.numpy(), tflat, is_leaf=lambda t: isinstance(t, torch.Tensor))
    if layout == "coo":
        # the flat sender order is each graph's, moved by b * E_pad; the
        # fields JAX's flattening also has are held to JAX's below
        for t, pe in zip(("g2m", "m2m", "m2g"), numpy_flat):
            b, e = getattr(tgraph, t).order.shape
            want = (getattr(tgraph, t).order + np.arange(b, dtype=np.int32)[:, None] * e).reshape(-1)
            np.testing.assert_array_equal(pe.order, want, err_msg=t)
        numpy_flat = type(numpy_flat)(*(tuple(pe[:-1]) for pe in numpy_flat))
        jflat = type(jflat)(*(tuple(pe) for pe in jflat))
    assert_same_arrays(numpy_flat, jax.tree.map(np.asarray, jflat))
    edge_sets = ([tflat.g2m, *tflat.m2m, tflat.m2g] if layout == "dense" else [tflat.g2m, tflat.m2m, tflat.m2g])
    for de in edge_sets:  # the ids the sorted kernels search stay ascending
        ids = [de.recv, de.tsp_node] if layout == "dense" else [de.receivers, de.senders[de.order.long()]]
        for a in ids:
            assert (torch.diff(a) >= 0).all()


def test_check_sorted_ids_refuses_unsorted_ids():
    _, graph = batched_graphs("dense")
    tloader.check_sorted_ids(graph, 64)
    bad = graph._replace(g2m=graph.g2m._replace(recv=graph.g2m.recv[:, ::-1].copy()))
    with pytest.raises(ValueError, match="g2m.recv"):
        tloader.check_sorted_ids(bad, 64)
    _, coo = batched_graphs("coo")
    bad = coo._replace(m2m=coo.m2m._replace(receivers=coo.m2m.receivers + 64))
    with pytest.raises(ValueError, match="m2m.receivers"):
        tloader.check_sorted_ids(bad, 64)
    bad = coo._replace(g2m=coo.g2m._replace(order=coo.g2m.order[:, ::-1].copy()))
    with pytest.raises(ValueError, match="g2m.order"):
        tloader.check_sorted_ids(bad, 64)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A synthetic Taylor-impact dataset: 2 training, 1 validation and 1
    test trajectory of 12 x 5 particles over 20 frames."""
    root = tmp_path_factory.mktemp("port_ms_train")
    generate_synthetic_raw_dataset(root / "raw", num_sims=4, nx=12, ny=5, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40,
                   val_patterns=["-110"], test_patterns=["-130"], boundary_particles_to_remove=2).build()
    return root


def tiny_config(root, **kw):
    base = dict(mode="train", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=16, input_sequence_length=S,
                run_name="ms", pad_multiple=32, edge_pad_multiple=256, batch_size=2, noise_std=0.01,
                lr_init=LR, lr_decay=0.1, lr_decay_steps=1000, ntraining_steps=40, nsave_steps=20, log_every=10,
                seed=0)
    base.update(kw)
    return TrainConfig(**base)


def jax_cfg(cfg):
    return jconfig.TrainConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(jconfig.TrainConfig)
                                  if hasattr(cfg, f.name)})


def batchers(cfg, seed=3):
    sim_cfg = ttms.ms_config_from(cfg, ttrain.load_metadata(cfg.data_path))
    kw = dict(ms_cfg=sim_cfg.graph_config, pad_multiple=cfg.pad_multiple, edge_pad_multiple=cfg.edge_pad_multiple,
              seed=seed, dense=cfg.ms_dense, m2m_traversals=cfg.layers,
              dense_row_advantage=4.0 if cfg.compute_dtype == "bfloat16" else 2.0)
    path = f"{cfg.data_path}/train.npz"
    jkw = dict(kw, ms_cfg=jg.MultiScaleConfig(**dataclasses.asdict(sim_cfg.graph_config)))
    return (tloader.MultiScaleSampleBatcher(path, S, cfg.batch_size, **kw),
            jloader.MultiScaleSampleBatcher(path, S, cfg.batch_size, **jkw))


@pytest.mark.parametrize("ms_dense", [True, False], ids=["dense", "coo"])
def test_ms_sample_batcher_matches_jax(tiny, ms_dense, capsys):
    ours, ref = batchers(tiny_config(tiny, ms_dense=ms_dense))
    assert len(ours) == len(ref) and ours.num_nodes == ref.num_nodes
    a, b = ours.epochs(), ref.epochs()
    for _ in range(ours.steps_per_epoch() + 2):  # into the second epoch
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for k in y:
            assert_same_arrays(x[k], y[k], k)


# --- forward and step ------------------------------------------------------------


def stats_pair(rng):
    v = {k: rng.uniform(0.5, 1.5, size=DIM).astype(np.float32) * s
         for k, s in (("vel_mean", 0.01), ("vel_std", 0.05), ("acc_mean", 0.001), ("acc_std", 0.01))}
    return (JNormStats(**{k: jnp.asarray(a) for k, a in v.items()}),
            TNormStats(**{k: torch.from_numpy(a) for k, a in v.items()}))


def model_pair(cfg, seed=0):
    md = ttrain.load_metadata(cfg.data_path)
    jsim_cfg = jtms.ms_config_from(jax_cfg(cfg), md)
    tsim_cfg = ttms.ms_config_from(cfg, md)
    params = jax.tree.map(np.asarray, jms.multi_scale_simulator_init(jax.random.key(seed), jsim_cfg))
    sim = tms.multi_scale_simulator_init(tsim_cfg, device="cpu")
    sim.load_state_dict(ms_state_dict_from_jax(params), strict=True)
    return jsim_cfg, tsim_cfg, params, sim


def torch_batch(batch):
    return ttms.batch_to_device(batch, torch.device("cpu"))


LAYOUT_DTYPES = [(True, "float32"), (False, "float32"), (True, "bfloat16"), (False, "bfloat16")]
LAYOUT_IDS = ["dense_f32", "coo_f32", "dense_bf16", "coo_bf16"]


@pytest.mark.parametrize("ms_dense,compute_dtype", LAYOUT_DTYPES, ids=LAYOUT_IDS)
def test_ms_predict_accelerations_batched_matches_jax(tiny, rng, ms_dense, compute_dtype):
    cfg = tiny_config(tiny, ms_dense=ms_dense, compute_dtype=compute_dtype)
    jsim_cfg, tsim_cfg, params, sim = model_pair(cfg, seed=1)
    jstats, tstats = stats_pair(rng)
    batch, jbatch = (next(b.epochs()) for b in batchers(cfg))  # the same batch, each package's graph type
    noise = rng.normal(scale=0.01, size=batch["positions"].shape).astype(np.float32)
    args = (batch["next_position"], noise, batch["positions"], batch["particle_type"])
    want = jms.ms_predict_accelerations_batched(params, jsim_cfg, jstats, *map(jnp.asarray, args),
                                                jax.tree.map(jnp.asarray, jbatch["graph"]),
                                                jnp.asarray(batch["node_mask"]))
    tb = torch_batch(batch)
    with torch.no_grad():
        got = tms.ms_predict_accelerations_batched(sim, tsim_cfg, tstats, tb["next_position"],
                                                   torch.from_numpy(noise), tb["positions"], tb["particle_type"],
                                                   tb["graph"])
    m = batch["node_mask"]  # outputs at padded nodes are garbage both sides mask
    for name, a, b in zip(("pred_acc", "target_acc", "pred_strain"), got, want):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], err_msg=name, **FWD_TOL[compute_dtype])


@pytest.mark.parametrize("layout", ["coo", "dense"])
def test_ms_predict_accelerations_matches_jax(rng, layout):
    """The one-graph training forward (COO: padding at 0 until the graph is flattened)."""
    kw = dict(dim=DIM, latent_dim=16, num_message_passing_steps=2, num_mlp_layers=2, input_sequence_length=S,
              num_scales=2, window_size=2)
    jcfg, tcfg = jms.MultiScaleSimulatorConfig(**kw), tms.MultiScaleSimulatorConfig(**kw)
    params = jax.tree.map(np.asarray, jms.multi_scale_simulator_init(jax.random.key(4), jcfg))
    sim = tms.multi_scale_simulator_init(tcfg, device="cpu")
    sim.load_state_dict(ms_state_dict_from_jax(params), strict=True)
    jstats, tstats = stats_pair(rng)
    grid = bar_grid(12, 5, 0.01, 0)
    jgraph, graph = (
        mod.build_dense_static_graph(c.graph_config, grid, g2m_rows=32, m2m_rows=32, m2g_rows=len(grid))
        if layout == "dense" else mod.build_static_graph(c.graph_config, grid, g2m_pad=512, m2m_pad=256, m2g_pad=512)
        for mod, c in ((jg, jcfg), (tg, tcfg)))
    seq = (grid[:, None, :] + rng.normal(scale=0.01, size=(len(grid), S + 1, DIM)).cumsum(1)).astype(np.float32)
    noise = rng.normal(scale=0.01, size=(len(grid), S, DIM)).astype(np.float32)
    types = np.zeros(len(grid), np.int32)
    args = (seq[:, S], noise, seq[:, :S], types)
    want = jms.ms_predict_accelerations(params, jcfg, jstats, *map(jnp.asarray, args),
                                        jax.tree.map(jnp.asarray, jgraph))
    tab = sim._multi_scale_gnn.m2m_blocks[0].edge_fn[0].linears[0].weight
    got = tms.ms_predict_accelerations(sim, tcfg, tstats, *map(torch.from_numpy, args),
                                       tms.graph_to(graph, torch.device("cpu")))
    (got[0].sum() + got[2].sum()).backward()  # one COO graph: flattened as a batch of one
    assert tab.grad is not None and torch.isfinite(tab.grad).all()
    for name, a, b in zip(("pred_acc", "target_acc", "pred_strain"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **FWD_TOL["float32"])


def _capture_grads():
    """An optax transformation that keeps the gradients in its state."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}),
    )


def _jax_step_outputs(jsim_cfg, jstats, cfg, params, jbatch, key):
    """(metrics, grads, params after Adam) of JAX's make_train_step."""
    out = {}
    for name, tx in (("grads", _capture_grads()), ("adam", optax.adam(jtms.lr_schedule(jax_cfg(cfg))))):
        state = {"params": params, "opt_state": tx.init(params), "step": jnp.asarray(0, jnp.int32)}
        out[name] = jtms.make_train_step(jsim_cfg, jstats, jax_cfg(cfg), tx)(state, jbatch, key)
    return ({k: float(v) for k, v in out["adam"][1].items()},
            ms_state_dict_from_jax(jax.tree.map(np.asarray, out["grads"][0]["opt_state"]["g"])),
            ms_state_dict_from_jax(jax.tree.map(np.asarray, out["adam"][0]["params"])))


@pytest.mark.parametrize("ms_dense,compute_dtype", LAYOUT_DTYPES, ids=LAYOUT_IDS)
def test_train_step_matches_jax(tiny, rng, ms_dense, compute_dtype):
    """One step of make_train_step against JAX's, from the same params,
    batch and noise: loss and aux, every gradient, the parameters after
    Adam; the launch counts of the sorted-sum and plan wrappers (plain
    versions on the CPU) as the model's blocks ask.

    bf16: JAX runs op by op (``jax.disable_jit``), rounding to bf16 after
    every op as the port's eager ops do (under jit XLA computes fused bf16
    chains in f32). Loss and aux to 1e-2; each gradient entry to 1e-2 of
    itself and of its tensor's largest entry, plus BF16_GAP_FACTOR times
    JAX's own bf16-vs-f32 gap in that tensor (its largest entry): the
    two round dh to bf16 at different points, and a sum over every edge
    of such dh (the edge MLPs' bias gradients) cancels down to a small
    result, so there the two lie about JAX's own error apart."""
    cfg = tiny_config(tiny, ms_dense=ms_dense, compute_dtype=compute_dtype)
    jsim_cfg, tsim_cfg, params, sim = model_pair(cfg, seed=2)
    jstats, tstats = stats_pair(rng)
    batch, jbatch = (next(b.epochs()) for b in batchers(cfg))  # the same batch, each package's graph type
    key = jax.random.key(7)
    noise = jnoise.random_walk_position_noise(key, batch["positions"].shape, cfg.noise_std)
    jbatch = {k: jax.tree.map(jnp.asarray, v) for k, v in jbatch.items()}
    f32 = compute_dtype == "float32"
    if f32:
        jm, want_g, want_p = _jax_step_outputs(jsim_cfg, jstats, cfg, params, jbatch, key)
    else:
        with jax.disable_jit():
            jm, want_g, want_p = _jax_step_outputs(jsim_cfg, jstats, cfg, params, jbatch, key)
        f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
        _, jax_f32_g, _ = _jax_step_outputs(dataclasses.replace(jsim_cfg, compute_dtype="float32"), jstats, f32_cfg,
                                            params, jbatch, key)

    before = {k: v.detach().clone() for k, v in sim.state_dict().items()}
    calls = {"sorted": 0, "planned": 0}
    wrap = {name: getattr(rg, name) for name in ("sorted_segment_sum", "planned_gather_bwd")}
    step = ttms.make_train_step(sim, tsim_cfg, tstats, cfg, ttrain.make_optimizer(sim, cfg))
    with pytest.MonkeyPatch.context() as mp:
        for kind, name in (("sorted", "sorted_segment_sum"), ("planned", "planned_gather_bwd")):
            mp.setattr(rg, name, lambda *a, _k=kind, _f=wrap[name]: calls.__setitem__(_k, calls[_k] + 1) or _f(*a))
        tm = {k: float(v) for k, v in step(torch_batch(batch), 0, noise=torch.from_numpy(np.array(noise))).items()}
    blocks = 2 + cfg.layers * (cfg.num_scales - 1 if ms_dense else 1)  # G2M, M2G, M2M per layer (and scale)
    # per block: the aggregation's sorted sum and the receiver gather's
    # backward; the sender gather's backward, the plan's (dense) or a sorted
    # sum over the sender order (COO)
    assert calls == {"sorted": (2 if ms_dense else 3) * blocks, "planned": blocks if ms_dense else 0}

    assert set(tm) == set(jm) == {"train/loss", "train/loss-position", "train/loss-strain"}
    for name in jm:
        np.testing.assert_allclose(tm[name], jm[name], err_msg=name, **(LOSS_TOL if f32 else dict(rtol=BF16_TOL)))
    lr0 = ttrain.lr_schedule(cfg)(0)  # lr_init + 1e-6
    tgrads = {k: p.grad for k, p in sim.named_parameters()}
    after = sim.state_dict()
    assert set(tgrads) == set(want_g) == set(want_p)
    for name, wg in want_g.items():
        g = tgrads[name]
        assert g.dtype == torch.float32, name
        if f32:
            tol = GRAD_ATOL_REL * wg.abs().max() + GRAD_RTOL * wg.abs()
        else:
            gap = (wg - jax_f32_g[name]).abs().max()  # JAX's own bf16-vs-f32 error in this tensor
            tol = BF16_TOL * (wg.abs().max() + wg.abs()) + BF16_GAP_FACTOR * gap
        err_g = (g - wg).abs()
        assert (err_g <= tol).all(), f"{name}: max |err| {float(err_g.max()):.3e}"
        # Adam's first step, entry by entry: an entry whose gradient lies
        # within the tolerance of 0 may step either way (at most 2 * lr0);
        # two gradients of one sign move the update apart by at most
        # lr0 * |g1 - g2| / max(|g1|, |g2|) (chip_smoke's rule)
        either_way = (wg.abs() <= tol).numpy()
        err = ((after[name] - want_p[name]).abs() - PARAM_RTOL * want_p[name].abs()).numpy()
        if f32:
            assert (err[~either_way] <= PARAM_ATOL).all(), f"{name}: max |err| {err[~either_way].max():.3e}"
        else:
            apart = (err_g / torch.maximum(g.abs(), wg.abs()).clamp(min=1e-30)).clamp(max=2.0).numpy()
            assert (err[~either_way] <= (PARAM_ATOL + lr0 * (1e-5 + apart))[~either_way]).all(), name
        assert (err <= 2 * lr0 + PARAM_ATOL).all(), name
        assert (after[name] != before[name]).any(), f"{name} did not move"


def test_lr_schedule_matches_jax(tiny):
    cfg = tiny_config(tiny)
    for step in (0, 1, 500, 1000, 5000):
        assert ttrain.lr_schedule(cfg)(step) == pytest.approx(float(jtms.lr_schedule(jax_cfg(cfg))(step)), rel=1e-12)


# --- train / predict / resume on the CPU -------------------------------------------


def test_main_trains_bf16_coo_and_runs_inner_steps(tiny, tmp_path):
    """--mode train through the CLI (bf16, COO), inner_steps as single
    steps, a final checkpoint when no validation ran."""
    cfg = tiny_config(tiny, run_name="cli", ms_dense=False, compute_dtype="bfloat16", ntraining_steps=4,
                      nsave_steps=100, log_every=2, inner_steps=2)
    keys = ("data_path", "model_path", "output_path", "layers", "hidden_dim", "input_sequence_length", "run_name",
            "pad_multiple", "edge_pad_multiple", "ms_dense", "compute_dtype", "batch_size", "ntraining_steps",
            "nsave_steps", "log_every", "inner_steps")
    yml = tmp_path / "ms.yaml"
    yml.write_text("".join(f"{k}: {json.dumps(getattr(cfg, k))}\n" for k in keys))
    assert ttms.main(["--config", str(yml), "--mode", "train", "--device", "cpu"]) == {
        "step": 4, "lowest_eval_loss": float("inf")}
    meta = json.load(open(tiny / "models" / "cli" / "checkpoint_meta.json"))
    assert meta["path"] == "model-final-000004"
    with pytest.raises(ValueError, match="inner_steps"):
        ttms.train(tiny_config(tiny, ntraining_steps=9, inner_steps=2), device="cpu")
