"""The f32 product (``ops/f32_product``) on the CPU: the kernels' 3xTF32
arithmetic and partitions emulated (``_f32_product_emulation``) against
f64, the autograd Function over the emulated kernels, the launch counts of
a model step, and every call site's CPU route against the composite it ran
before, bit for bit. The kernels themselves run only on the card
(``tests/test_torch_port_f32_product_cuda.py``)."""

import pytest
import torch
from _f32_product_emulation import bias_sums, product, tf32_split, through_emulation, wgrad
from test_torch_port_edge_epilogue import _forward_backward, _mgn, _ms

from sgnn_tpu_torch.models import epd_flat
from sgnn_tpu_torch.models import mesh_graph_net as tmgn
from sgnn_tpu_torch.models import multi_scale as tmodel
from sgnn_tpu_torch.models.encode_process_decode import EncodeProcessDecode, EPDConfig, mlp_tail, split_first_layer
from sgnn_tpu_torch.nn.core import MLP, Linear, layer_norm
from sgnn_tpu_torch.ops import f32_product as fp
from sgnn_tpu_torch.ops.edge_epilogue import edge_stage_epilogue
from sgnn_tpu_torch.physics import captured_step

# |error| over the sum of the terms' sizes: one 3xTF32 product carries about 2^-22 of its size
# (hi*hi exact, lo read to 11 bits, lo*lo dropped), an f32 sum adds 2^-24 a step
RTOL_3XTF32 = 2.0 ** -20


@pytest.fixture(autouse=True)
def zero_launches():
    fp.LAUNCHES.update(dict.fromkeys(fp.LAUNCHES, 0))
    yield
    fp.LAUNCHES.update(dict.fromkeys(fp.LAUNCHES, 0))


def _worst(got, want, terms):
    return float(((got.double() - want).abs() / terms.clamp_min(1e-30)).max())


# --- the arithmetic -------------------------------------------------------------------


def test_split_is_a_tf32_value_and_an_exact_remainder():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * torch.logspace(-20, 20, 4096)
    hi, lo = tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()  # 10 explicit mantissa bits
    assert not (lo.view(torch.int32) & 0x1FFF).any()  # lo as the tensor cores read it
    exact_lo = x - hi
    assert torch.equal(hi + exact_lo, x)
    assert bool((exact_lo.abs() <= x.abs() * 2.0 ** -11).all())  # hi is x rounded to nearest


SHAPES = [(257, 3, 128), (300, 128, 128), (64, 384, 128), (100, 64, 64), (50, 128, 3), (33, 256, 200), (9, 6, 9)]


@pytest.mark.parametrize("chunked", [True, False], ids=["wgmma", "mma_sync"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_emulated_product_keeps_f32_accuracy_and_tf32_does_not(m, k, n, chunked):
    g = torch.Generator().manual_seed(m * k + n)
    x, w = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
    want, terms = x.double() @ w.double(), x.double().abs() @ w.double().abs()
    assert _worst(product(x, w, chunked), want, terms) <= RTOL_3XTF32
    one_pass = tf32_split(x)[0].double() @ tf32_split(w)[0].double()  # 1xTF32: the precision below
    assert _worst(one_pass, want, terms) > 16 * RTOL_3XTF32


@pytest.mark.parametrize("m", [1, 31, 32, 255, 256, 257, 4097, 38912, 155648, 311296, 466944, 622592, 10 ** 7])
def test_weight_gradient_partition_covers_the_rows_once(m):
    splits, rows = fp.wgrad_partition(m)
    assert 1 <= splits <= fp.MAX_SPLITS and rows % fp.CHUNK_ROWS == 0
    assert (splits - 1) * rows < m <= splits * rows  # every split holds rows, the last the rest
    # as many splits as the rows allow, up to MAX_SPLITS (rows rounded up to whole chunks lose at most 1/9)
    target = min(fp.MAX_SPLITS, -(-m // fp.SPLIT_MIN_ROWS))
    assert 9 * splits >= 8 * target
    assert fp.wgrad_partition(m) == (splits, rows)


@pytest.mark.parametrize("m,k,n", [(1000, 128, 128), (777, 3, 64), (600, 64, 3), (900, 96, 40), (4100, 8, 8)])
def test_emulated_weight_gradient_adds_in_a_fixed_order(m, k, n):
    g = torch.Generator().manual_seed(m + k)
    x, gr = torch.randn(m, k, generator=g), torch.randn(m, n, generator=g)
    total, partials = wgrad(x, gr)
    splits, rows = fp.wgrad_partition(m)
    assert len(partials) == splits > 1
    strided = [sum(partials[w + 8::8], partials[w]) for w in range(min(8, splits))]  # the reduce's order
    assert torch.equal(total, sum(strided[1:], strided[0])) and torch.equal(wgrad(x, gr)[0], total)
    assert _worst(total, x.double().t() @ gr.double(), x.double().abs().t() @ gr.double().abs()) <= 2e-6
    db = bias_sums(gr, rows)
    assert torch.equal(db, bias_sums(gr, rows))
    assert _worst(db, gr.double().sum(0), gr.double().abs().sum(0)) <= 2e-6


# --- the autograd Function over the emulated kernels ----------------------------------


def _layout(k, n, layout, g):
    if layout == "transposed":
        return torch.randn(n, k, generator=g).t()
    if layout == "row_block":
        return torch.randn(n, 3 * k, generator=g).t()[k:2 * k]
    return torch.randn(k, n, generator=g)


@pytest.mark.parametrize("layout", ["transposed", "row_block", "contiguous"])
@pytest.mark.parametrize("relu,bias", [(True, True), (False, True), (False, False)])
def test_function_matches_f64_through_the_emulated_kernels(relu, bias, layout):
    g = torch.Generator().manual_seed(7)
    m, k, n = 300, 40, 24
    x = torch.randn(2, m // 2, k, generator=g).requires_grad_(True)  # leading axes are kept
    weight = _layout(k, n, layout, g)
    w = weight.detach().clone().requires_grad_(True) if layout == "contiguous" else weight.requires_grad_(True)
    b = torch.randn(n, generator=g).requires_grad_(True) if bias else None
    cot = torch.randn(2, m // 2, n, generator=g)
    with through_emulation():
        y = fp.linear(x, w, b, relu)
        y.backward(cot)
    assert y.shape == (2, m // 2, n)
    assert fp.LAUNCHES == {"fwd": 1, "dgrad": 1, "wgrad": 1}
    x64, w64 = x.detach().reshape(m, k).double(), w.detach().double()
    pre = x64 @ w64 + (b.detach().double() if bias else 0.0)
    gate = (y.detach().reshape(m, n) > 0) if relu else torch.ones(m, n, dtype=torch.bool)
    gg = torch.where(gate, cot.reshape(m, n).double(), 0.0)
    terms = x64.abs() @ w64.abs() + (b.detach().double().abs() if bias else 0.0)
    assert _worst(y.detach().reshape(m, n), pre.clamp_min(0.0) if relu else pre, terms) <= RTOL_3XTF32
    assert _worst(x.grad.reshape(m, k), gg @ w64.t(), gg.abs() @ w64.abs().t()) <= RTOL_3XTF32
    assert _worst(w.grad, x64.t() @ gg, x64.abs().t() @ gg.abs()) <= RTOL_3XTF32
    if bias:
        assert _worst(b.grad, gg.sum(0), gg.abs().sum(0)) <= RTOL_3XTF32
    if layout == "transposed":  # the gradient keeps the weight's layout
        assert w.grad.stride() == w.stride()


def test_function_skips_the_gradients_nobody_takes():
    """Features (no gradient) launch no input gradient; a frozen weight with a
    bias still takes the weight-gradient pass for the bias."""
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(64, 6, generator=g), torch.randn(6, 16, generator=g).requires_grad_(True)
    with through_emulation():
        fp.linear(x, w, None, True).sum().backward()
    assert fp.LAUNCHES == {"fwd": 1, "dgrad": 0, "wgrad": 1}
    b = torch.zeros(16, requires_grad=True)
    with through_emulation():
        fp.linear(x.requires_grad_(True), w.detach(), b).sum().backward()
    assert fp.LAUNCHES == {"fwd": 2, "dgrad": 1, "wgrad": 2}
    assert torch.equal(b.grad, torch.full((16,), 64.0))


def test_function_refuses_what_does_not_chain():
    with through_emulation():
        with pytest.raises(ValueError):
            fp.linear(torch.zeros(4, 5), torch.zeros(6, 3))
        with pytest.raises(ValueError):
            fp.linear(torch.zeros(4, 5), torch.zeros(5, 3), torch.zeros(4))
        with pytest.raises(ValueError):
            fp.linear(torch.zeros(4, 5), torch.zeros(5, 3, dtype=torch.float64))


def test_cpu_tensors_take_the_composite():
    g = torch.Generator().manual_seed(2)
    x, w, b = torch.randn(10, 8, generator=g), torch.randn(8, 4, generator=g), torch.randn(4, generator=g)
    assert not fp.takes(x) and not fp.takes(x.bfloat16())
    assert torch.equal(fp.linear(x, w, b, True), torch.relu(x @ w + b))
    assert torch.equal(fp.linear(x.bfloat16(), w, b), x.bfloat16() @ w.bfloat16() + b.bfloat16())
    assert fp.LAUNCHES == {"fwd": 0, "dgrad": 0, "wgrad": 0}


# --- the call sites on the CPU, as they were --------------------------------------------


def _mlp_before(mlp, x):
    """``MLP`` as it was: its Sequential children, ``x @ weight.t() + bias`` then ReLU."""
    return torch.nn.Sequential.forward(mlp, x)


def _linear_before(lin, x):
    return x @ lin.weight.t() + lin.bias


def _mlp_tail_before(mlp, h):
    linears = mlp.linears
    if len(linears) == 1:
        return h
    x = torch.relu(h)
    for lin in linears[1:-1]:
        x = torch.relu(_linear_before(lin, x))
    return _linear_before(linears[-1], x)


def _grads(fn, params, x):
    out = fn(x)
    out.square().sum().backward()
    grads = [None if p.grad is None else p.grad.clone() for p in [*params, x]]
    for p in [*params, x]:
        p.grad = None
    return out.detach(), grads


def _same(a, b):
    assert torch.equal(a[0], b[0])
    assert all(p is q is None or torch.equal(p, q) for p, q in zip(a[1], b[1]))


@pytest.mark.parametrize("hidden", [[], [16], [16, 16]])
def test_linear_mlp_and_tail_as_before(hidden):
    mlp = MLP(12, hidden, 8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(30, 12, generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    params = list(mlp.parameters())
    _same(_grads(mlp, params, x), _grads(lambda t: _mlp_before(mlp, t), params, x))
    lin = mlp.linears[0]
    _same(_grads(lin, params, x), _grads(lambda t: _linear_before(lin, t), params, x))
    h = torch.randn(30, 8 if not hidden else 16, generator=torch.Generator().manual_seed(2)).requires_grad_(True)
    _same(_grads(lambda t: mlp_tail(mlp, t), params, h), _grads(lambda t: _mlp_tail_before(mlp, t), params, h))


def _mlp_tail_in_before(mlp, h):
    """``epd_flat._mlp_tail_in`` as it was: ``_DotWf32`` products."""
    linears = mlp.linears
    if len(linears) == 1:
        return h, None
    dt = h.dtype
    x = torch.relu(h)
    for lin in linears[1:-1]:
        x = torch.relu(epd_flat._DotWf32.apply(x, lin.weight.t()) + lin.bias.to(dt))
    return epd_flat._DotWf32.apply(x, linears[-1].weight.t()), linears[-1].bias


def _mlp_tail_product_before(mlp, h):
    """``multi_scale._mlp_tail_product`` as it was."""
    dt = h.dtype
    linears = mlp.linears
    if len(linears) == 1:
        return h, None
    x = torch.relu(h)
    for lin in linears[1:-1]:
        x = torch.relu(x @ lin.weight.t().to(dt) + lin.bias.to(dt))
    return x @ linears[-1].weight.t().to(dt), linears[-1].bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("new,before", [(epd_flat._mlp_tail_in, _mlp_tail_in_before),
                                        (tmodel._mlp_tail_product, _mlp_tail_product_before)],
                         ids=["epd_flat", "multi_scale"])
def test_edge_mlp_tails_as_before(new, before, dtype):
    mlp = MLP(16, [16, 16], 16, generator=torch.Generator().manual_seed(3))
    h = torch.randn(40, 16, generator=torch.Generator().manual_seed(4)).to(dtype).requires_grad_(True)
    params = list(mlp.parameters())
    _same(_grads(lambda t: new(mlp, t)[0], params, h), _grads(lambda t: before(mlp, t)[0], params, h))


def _edge_block_plain_before(edge_fn, e, xj, proj_i, degrees, k):
    """``epd_flat._edge_block_plain`` as it was."""
    edge_mlp, edge_ln = edge_fn[0], edge_fn[1]
    d = e.shape[-1]
    (_, _, w_e), b_e = split_first_layer(edge_mlp, (d, d, d))
    m = proj_i.shape[0]
    dt = e.dtype
    h = epd_flat._DotWf32.apply(e, w_e) + xj.to(dt)
    h = epd_flat._RecvBroadcastAdd.apply(h, proj_i + b_e, k)
    o, b2 = _mlp_tail_in_before(edge_mlp, h)
    return edge_stage_epilogue(o, b2, edge_ln.weight, edge_ln.bias, epd_flat._slot_mask(degrees, m, k).to(dt), e, k)


def _mgn_apply_before(net, node_features, mesh, world):
    """``mesh_graph_net.mesh_graph_net_apply`` as it was."""
    def mlp_ln(block, x):
        return layer_norm(_mlp_before(block[0], x), block[1].weight, block[1].bias)

    m = node_features.shape[0]
    x = mlp_ln(net._encoder.node_fn, node_features)
    d = x.shape[-1]
    sets = (mesh, world)
    es = [mlp_ln(getattr(net._encoder, f"{name}_edge_fn"), s.features) * epd_flat._slot_mask(s.degrees, m, s.k)
          for name, s in zip(tmgn.EDGE_SETS, sets)]
    for block in net._processor.blocks:
        aggs, new_es = [], []
        for name, s, e in zip(tmgn.EDGE_SETS, sets, es):
            edge_fn = getattr(block, f"{name}_edge_fn")
            (w_j, w_i, _), _ = split_first_layer(edge_fn[0], (d, d, d))
            new_e, agg = _edge_block_plain_before(edge_fn, e, s.gather(x @ w_j), x @ w_i, s.degrees, s.k)
            new_es.append(new_e)
            aggs.append(agg)
        node_mlp, node_ln = block.node_fn[0], block.node_fn[1]
        (w_x, w_mesh, w_world), b_n = split_first_layer(node_mlp, (d, d, d))
        hn = x @ w_x + aggs[0] @ w_mesh + aggs[1] @ w_world + b_n
        x = x + layer_norm(_mlp_tail_before(node_mlp, hn), node_ln.weight, node_ln.bias)
        es = new_es
    return _mlp_before(net._decoder.node_fn, x)


def test_mgn_forward_and_backward_as_before():
    net, nodes, sets = _mgn(blocks=2)
    got = _forward_backward(net, lambda: tmgn.mesh_graph_net_apply(net, nodes, *sets))
    want = _forward_backward(net, lambda: _mgn_apply_before(net, nodes, *sets))
    assert torch.equal(got[0], want[0])
    for name in got[1]:
        assert torch.equal(got[1][name], want[1][name]), name


def _node_update_ms_before(block, x, agg_hn):
    d = x.shape[-1]
    (_, w_x), b_n = split_first_layer(block.node_fn[0], (d, d))
    ln = block.node_fn[1]
    return x + layer_norm(_mlp_tail_before(block.node_fn[0], agg_hn + x @ w_x + b_n), ln.weight, ln.bias)


def _interact_dense_scales_before(block, x, es, des, compute_dtype=None, *, x_sender_table=None):
    """``multi_scale._interact_dense_scales`` as it was."""
    d, n = x.shape[-1], x.shape[0]
    xs = x if x_sender_table is None else x_sender_table
    dt = es[0].dtype if compute_dtype is None else compute_dtype
    w_i, w_j, w_e, b_e = tmodel._edge_mlp_in(block, d, dt)
    proj_i_full = x @ w_i
    proj_j = xs @ w_j
    if compute_dtype is not None:
        proj_j = proj_j.to(dt)
    w_agg = tmodel._agg_weight(block, d).to(dt).float()
    agg_hn = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    new_es = []
    ln = block.edge_fn[1]
    for e, de in zip(es, des):
        maskf = de.mask[..., None].to(dt)
        proj_i = tmodel.sorted_gather(proj_i_full, de.recv, n)
        xj = tmodel.planned_gather(proj_j, de.senders, de.tsp_rows, de.tsp_node, de.tsp_mask, xs.shape[0])
        h = proj_i.to(dt)[:, None, :] + xj + e @ w_e + b_e
        o, b2 = _mlp_tail_product_before(block.edge_fn[0], h)
        new_e, agg = edge_stage_epilogue(o, b2, ln.weight, ln.bias, maskf, e, de.mask.shape[-1])
        new_es.append(new_e)
        agg_hn = agg_hn + tmodel.sorted_sum(agg @ w_agg, de.recv, n)
    return _node_update_ms_before(block, x, agg_hn), new_es


def test_dense_multi_scale_forward_and_backward_as_before(monkeypatch):
    sim, graph, run = _ms(blocks=2)
    got = _forward_backward(sim, run)
    monkeypatch.setattr(tmodel, "_interact_dense_scales", _interact_dense_scales_before)
    monkeypatch.setattr(MLP, "forward", _mlp_before)
    want = _forward_backward(sim, run)
    assert torch.equal(got[0], want[0])
    for name in got[1]:
        assert torch.equal(got[1][name], want[1][name]), name


def _node_update_flat_before(block, x, agg):
    d = x.shape[-1]
    node_mlp, node_ln = block.node_fn[0], block.node_fn[1]
    (w_agg, w_x), b_n = split_first_layer(node_mlp, (d, d))
    hn = agg @ w_agg + x @ w_x + b_n
    return x + layer_norm(_mlp_tail_before(node_mlp, hn), node_ln.weight, node_ln.bias)


def _flat_epd(layers_per_mlp):
    epd = EncodeProcessDecode(EPDConfig(node_in=5, edge_in=3, node_out=2, latent_dim=16, num_message_passing_steps=2,
                                        num_mlp_layers=layers_per_mlp), generator=torch.Generator().manual_seed(5))
    m, k = 20, 4
    g = torch.Generator().manual_seed(6)
    degrees = torch.randint(0, k + 1, (m, 1), generator=g).float()
    args = (torch.randn(m, 5, generator=g), torch.randn(m * k, 3, generator=g),
            torch.randint(0, m, (m * k,), generator=g), degrees, k)
    return epd, lambda: epd_flat.encode_process_decode_apply_flat(epd, *args)


@pytest.mark.parametrize("layers_per_mlp", [1, 2])
def test_flat_single_scale_forward_and_backward_as_before(monkeypatch, layers_per_mlp):
    """One hidden layer (the fused edge block's plain version on the CPU) and two
    (the plain edge stage)."""
    epd, run = _flat_epd(layers_per_mlp)
    got = _forward_backward(epd, run)
    monkeypatch.setattr(epd_flat, "_edge_block_plain", _edge_block_plain_before)
    monkeypatch.setattr(epd_flat, "_node_update", _node_update_flat_before)
    monkeypatch.setattr(MLP, "forward", _mlp_before)
    want = _forward_backward(epd, run)
    assert torch.equal(got[0], want[0])
    for name in got[1]:
        assert torch.equal(got[1][name], want[1][name]), name


# --- the counts of a model step ----------------------------------------------------------


def _counts(model, run):
    """A forward and backward inside ``LaunchRecord.around`` (taken back, as at
    a capture), then one replay's count."""
    record = captured_step.LaunchRecord.around(lambda: _forward_backward(model, run))
    assert fp.LAUNCHES == {"fwd": 0, "dgrad": 0, "wgrad": 0}
    record.replayed()
    return dict(fp.LAUNCHES)


def test_mgn_step_counts_one_launch_of_each_kind_per_product():
    """MeshGraphNets with two hidden layers an MLP: 3 encoders and the decoder of
    3 Linears; a block's two edge sets each 2 projections, e @ W_e and 2 more
    Linears, its node update 3 products of the split first layer and 2 more.
    The encoders' first Linears read features: no input gradient."""
    net, nodes, sets = _mgn(blocks=2, n=12)
    with through_emulation():
        got = _counts(net, lambda: tmgn.mesh_graph_net_apply(net, nodes, *sets))
    products = 3 * 3 + 2 * (2 * 5 + 5) + 3
    assert got == {"fwd": products, "dgrad": products - 3, "wgrad": products}


def test_function_route_keeps_the_models_outputs_and_gradients():
    """The models over the emulated kernels against the composite: round-off only."""
    net, nodes, sets = _mgn(blocks=2)
    run = lambda: tmgn.mesh_graph_net_apply(net, nodes, *sets)  # noqa: E731
    want = _forward_backward(net, run)
    with through_emulation():
        got = _forward_backward(net, run)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for name in got[1]:
        torch.testing.assert_close(got[1][name], want[1][name], rtol=1e-4, atol=1e-5)
