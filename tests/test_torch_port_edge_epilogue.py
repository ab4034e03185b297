"""The plain edge stage's epilogue (``ops/edge_epilogue``) on the CPU: the
wrapper's plain path against the composite the models ran before it (bit
for bit), the autograd Function over the kernels' plain versions
(``_edge_epilogue_reference``) under ``gradcheck`` in f64, MeshGraphNets
and the dense multi-scale model forward and backward against their edge
stages as they were, and the launch counters through a ``LaunchRecord``
round trip. The kernels themselves run only on the card
(``tests/test_torch_port_edge_epilogue_cuda.py``)."""

import numpy as np
import pytest
import torch
from _edge_epilogue_reference import through_reference

from sgnn_tpu_torch.models import epd_flat
from sgnn_tpu_torch.models import mesh_graph_net as tmgn
from sgnn_tpu_torch.models import multi_scale as tmodel
from sgnn_tpu_torch.models.encode_process_decode import split_first_layer
from sgnn_tpu_torch.nn.core import layer_norm
from sgnn_tpu_torch.ops import edge_epilogue as ee
from sgnn_tpu_torch.physics import captured_step
from sgnn_tpu_torch.physics import multi_scale_graph as tg
from sgnn_tpu_torch.physics import multi_scale_simulator as tms
from sgnn_tpu_torch.physics.simulator import NormStats

SLOTS = [4, 8, 16, 24]


def _inputs(r, k, d, seed, dtype=torch.float32):
    """(o, b2, lns, lnb, mask [R*K, 1], e [R*K, D] zero at masked slots);
    degrees ragged from 0 to K, the first receiver's 0 and the last's K."""
    g = torch.Generator().manual_seed(seed)
    degrees = torch.randint(0, k + 1, (r, 1), generator=g)
    degrees[0], degrees[-1] = 0, k
    mask = (torch.arange(k)[None, :] < degrees).to(dtype).reshape(r * k, 1)
    o = torch.randn(r * k, d, generator=g, dtype=dtype) * 2.0 + 0.5
    b2 = torch.randn(d, generator=g, dtype=dtype) * 0.1
    lns = 1.0 + torch.randn(d, generator=g, dtype=dtype) * 0.1
    lnb = torch.randn(d, generator=g, dtype=dtype) * 0.1
    e = torch.randn(r * k, d, generator=g, dtype=dtype) * mask
    return o, b2, lns, lnb, mask, e


def _leaves(tensors):
    return [t.clone().requires_grad_(True) for t in tensors]


def _mgn_before(o, b2, lns, lnb, mask, e, k):
    """MeshGraphNets' edge stage after its last product, as it was."""
    m, d = o.shape[0] // k, o.shape[-1]
    msg = layer_norm(o + b2, lns, lnb) * mask
    return e + msg, msg.reshape(m, k, d).float().sum(dim=1)


def _ms_before(o, b2, lns, lnb, mask, e, k):
    """The dense multi-scale stage after its last product, as it was ([R, K, .] rows)."""
    r, d = o.shape[0] // k, o.shape[-1]
    o, e, mask = o.reshape(r, k, d), e.reshape(r, k, d), mask.reshape(r, k, 1)
    msg = layer_norm(o + b2, lns, lnb) * mask
    return ((e + msg) * mask).reshape(r * k, d), msg.float().sum(dim=1)


@pytest.mark.parametrize("k", SLOTS)
@pytest.mark.parametrize("before", [_mgn_before, _ms_before], ids=["mgn", "ms"])
def test_plain_path_equals_the_composite_it_replaced(k, before):
    """On CPU tensors the wrapper is the composite in its order: new_e, agg
    and every gradient torch.equal to each model's stage as it was, but
    MeshGraphNets' e gradient at masked slots, which the masked residual
    makes 0 (its encoder's ``* mask`` zeroed it there before any
    parameter; the model test below holds every parameter's gradient)."""
    tensors = _inputs(37, k, 16, seed=k)
    got_in, want_in = _leaves(tensors), _leaves(tensors)
    for t in (got_in[4], want_in[4]):
        t.requires_grad_(False)  # the mask
    got = ee.edge_stage_epilogue(*got_in, k)
    want = before(*want_in, k)
    g = torch.Generator().manual_seed(100 + k)
    cot = (torch.randn(got[0].shape, generator=g), torch.randn(got[1].shape, generator=g))
    torch.autograd.backward(got, cot)
    torch.autograd.backward(want, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for i in (0, 1, 2, 3):
        assert torch.equal(got_in[i].grad, want_in[i].grad), i
    mask = tensors[4]
    assert torch.equal(got_in[5].grad, want_in[5].grad * mask)
    assert before is _mgn_before or torch.equal(got_in[5].grad, want_in[5].grad)


@pytest.fixture
def through_function(monkeypatch):
    """f32 stages through EdgeEpilogue over the kernels' plain versions, as
    the card runs them through the kernels, counters zeroed."""
    through_reference(monkeypatch)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("outputs", ["both", "agg_only"])
def test_function_passes_gradcheck_in_f64(through_function, k, outputs):
    """EdgeEpilogue over the kernels' plain versions against finite
    differences in f64, ragged degrees with a receiver of none;
    ``agg_only`` leaves new_e's cotangent to autograd (None: read as
    zero), as a stage whose new edges go unused."""
    o, b2, lns, lnb, mask, e = _inputs(6, k, 8, seed=7 + k, dtype=torch.float64)
    leaves = _leaves((o, b2, lns, lnb, e))

    def fn(o, b2, lns, lnb, e):
        new_e, agg = ee.EdgeEpilogue.apply(o, b2, lns, lnb, mask, e, k)
        return (new_e, agg) if outputs == "both" else agg

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("k", SLOTS + [48])
def test_kernel_plain_versions_match_the_composite(through_function, k):
    """The wrapper through the Function over the kernels' plain versions
    (the kernels' order: two-pass moments in the input's dtype, the
    hand-written backward; K past 32 in slot groups, as the kernels) against
    autograd of the composite in f32: round-off only (values of order 1,
    sums of 16 terms: a few 1e-7), so 1e-5."""
    tensors = _inputs(41, k, 16, seed=3 * k)
    got_in, want_in = _leaves(tensors), _leaves(tensors)
    for t in (got_in[4], want_in[4]):
        t.requires_grad_(False)
    got = ee.edge_stage_epilogue(*got_in, k)
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == (1, 0)
    want = ee.epilogue_plain(*want_in, k)
    g = torch.Generator().manual_seed(k)
    cot = (torch.randn(got[0].shape, generator=g), torch.randn(got[1].shape, generator=g))
    torch.autograd.backward(got, cot)
    torch.autograd.backward(want, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for i in (0, 1, 2, 3, 5):
        torch.testing.assert_close(got_in[i].grad, want_in[i].grad, rtol=1e-5, atol=1e-5)


def test_the_rule_the_callers_choose_by():
    """The kernels take f32 latents on a CUDA device, whatever D and K; bf16
    latents and CPU tensors keep the plain code."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ee.takes(cuda, torch.float32)
    assert not ee.takes(cuda, torch.bfloat16) and not ee.takes(cpu, torch.float32)


def test_wrapper_refuses_shapes_it_cannot_read(through_function):
    o, b2, lns, lnb, mask, e = _inputs(5, 4, 8, seed=0)
    with pytest.raises(ValueError):
        ee.edge_stage_epilogue(o, b2, lns, lnb, mask, e[:-1], 4)
    with pytest.raises(ValueError):
        ee.edge_stage_epilogue(o, b2, lns, lnb, mask[:-1], e, 4)
    with pytest.raises(ValueError):
        ee.edge_stage_epilogue(o, b2[:-1], lns, lnb, mask, e, 4)
    with pytest.raises(ValueError):
        ee.edge_stage_epilogue(o, b2, lns, lnb, mask, e, 3)
    for d in (6, 256):  # not a multiple of 4, past 128: the kernels raise, no plain fallback
        o, b2, lns, lnb, mask, e = _inputs(5, 4, d, seed=d)
        with pytest.raises(ValueError):
            ee.edge_stage_epilogue(o, b2, lns, lnb, mask, e, 4)
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == (0, 0)


# --- the models -------------------------------------------------------------------


def _edge_block_plain_before(edge_fn, e, xj, proj_i, degrees, k):
    """``epd_flat._edge_block_plain`` as it was before the epilogue moved into ``ops/edge_epilogue``."""
    edge_mlp, edge_ln = edge_fn[0], edge_fn[1]
    d = e.shape[-1]
    (_, _, w_e), b_e = split_first_layer(edge_mlp, (d, d, d))
    m = proj_i.shape[0]
    dt = e.dtype
    h = epd_flat._DotWf32.apply(e, w_e) + xj.to(dt)
    h = epd_flat._RecvBroadcastAdd.apply(h, proj_i + b_e, k)
    x = torch.relu(h)
    for lin in edge_mlp.linears[1:-1]:
        x = torch.relu(epd_flat._DotWf32.apply(x, lin.weight.t()) + lin.bias.to(dt))
    last = edge_mlp.linears[-1]
    msg = layer_norm(epd_flat._DotWf32.apply(x, last.weight.t()) + last.bias.to(dt), edge_ln.weight, edge_ln.bias)
    msg = msg * epd_flat._slot_mask(degrees, m, k).to(dt)
    return e + msg, msg.reshape(m, k, d).float().sum(dim=1)


def _interact_dense_scales_before(block, x, es, des, compute_dtype=None, *, x_sender_table=None):
    """``multi_scale._interact_dense_scales`` as it was before the epilogue moved into ``ops/edge_epilogue``."""
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
    for e, de in zip(es, des):
        maskf = de.mask[..., None].to(dt)
        proj_i = tmodel.sorted_gather(proj_i_full, de.recv, n)
        xj = tmodel.planned_gather(proj_j, de.senders, de.tsp_rows, de.tsp_node, de.tsp_mask, xs.shape[0])
        h = proj_i.to(dt)[:, None, :] + xj + e @ w_e + b_e
        msg = tmodel._edge_msg(block, h, maskf)
        new_es.append((e + msg) * maskf)
        agg_hn = agg_hn + tmodel.sorted_sum(msg.float().sum(dim=1) @ w_agg, de.recv, n)
    return tmodel._node_update(block, x, agg_hn), new_es


def _mgn(blocks, seed=0, n=40, latent=8):
    """A tiny MeshGraphNet and its two edge sets (ragged degrees, zero-degree nodes)."""
    cfg = tmgn.MGNConfig(node_in=3, mesh_edge_in=3, world_edge_in=3, node_out=2, latent_dim=latent,
                         num_message_passing_steps=blocks)
    net = tmgn.MeshGraphNet(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sets = []
    for k in (4, 8):
        degrees = torch.randint(0, k + 1, (n, 1), generator=g)
        degrees[0] = 0
        senders = torch.randint(0, n, (n * k,), generator=g)
        mask = (torch.arange(k)[None, :] < degrees).reshape(-1, 1).float()
        feats = torch.randn(n * k, 3, generator=g) * mask
        sets.append(tmgn.EdgeSet(feats, degrees.float(), lambda t, s=senders: t.index_select(0, s), k))
    nodes = torch.randn(n, 3, generator=g)
    return net, nodes, sets


def _forward_backward(model, run):
    out = run()
    out.square().sum().backward()
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out.detach(), grads


def test_mgn_forward_and_backward_as_before(monkeypatch):
    net, nodes, sets = _mgn(blocks=2)
    run = lambda: tmgn.mesh_graph_net_apply(net, nodes, *sets)  # noqa: E731
    got = _forward_backward(net, run)
    monkeypatch.setattr(tmgn, "_edge_block_plain", _edge_block_plain_before)
    want = _forward_backward(net, run)
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for name in got[1]:
        assert torch.equal(got[1][name], want[1][name]), name


def _ms(blocks, num_scales=3, latent=8):
    """A tiny multi-scale simulator and one dense hierarchy's training
    inputs; ``num_scales`` 3 gives two m2m edge sets per block."""
    cfg = tms.MultiScaleSimulatorConfig(dim=2, latent_dim=latent, num_message_passing_steps=blocks,
                                        input_sequence_length=3, num_scales=num_scales, window_size=2)
    torch.manual_seed(0)
    sim = tms.multi_scale_simulator_init(cfg, device="cpu")
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(12) * 0.5, np.arange(5) * 0.5, indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], -1) + rng.normal(scale=0.01, size=(60, 2))
    graph = tms.graph_to(tg.build_dense_static_graph(cfg.graph_config, grid, g2m_rows=32, m2m_rows=32,
                                                     m2g_rows=len(grid)), torch.device("cpu"))
    seq = (grid[:, None, :] + rng.normal(scale=0.01, size=(60, 4, 2)).cumsum(1)).astype(np.float32)
    noise = rng.normal(scale=0.01, size=(60, 3, 2)).astype(np.float32)
    stats = NormStats(*(torch.full((2,), s) for s in (0.0, 0.05, 0.0, 0.01)))
    args = (torch.from_numpy(seq[:, 3]), torch.from_numpy(noise), torch.from_numpy(seq[:, :3]),
            torch.zeros(60, dtype=torch.int32), graph)

    def run():
        pred_acc, _, pred_strain = tms.ms_predict_accelerations(sim, cfg, stats, *args)
        return torch.cat([pred_acc, pred_strain[:, None]], dim=1)

    return sim, graph, run


def test_dense_multi_scale_forward_and_backward_as_before(monkeypatch):
    sim, graph, run = _ms(blocks=2)
    assert len(graph.m2m) == 2
    got = _forward_backward(sim, run)
    monkeypatch.setattr(tmodel, "_interact_dense_scales", _interact_dense_scales_before)
    want = _forward_backward(sim, run)
    assert torch.equal(got[0], want[0])
    for name in got[1]:
        assert torch.equal(got[1][name], want[1][name]), name


# --- the counters -----------------------------------------------------------------


def _round_trip(model, run):
    """One forward and backward inside ``LaunchRecord.around`` (its counts
    taken back, as at a capture), then one replay's."""
    record = captured_step.LaunchRecord.around(lambda: _forward_backward(model, run))
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == (0, 0)
    record.replayed()
    return ee.LAUNCHES, ee.BWD_LAUNCHES


def test_counters_read_thirty_and_thirty_for_one_mgn_step(through_function):
    """The cell's 15 blocks, two edge sets each: 30 forwards and 30 backwards."""
    net, nodes, sets = _mgn(blocks=15, n=16)
    assert _round_trip(net, lambda: tmgn.mesh_graph_net_apply(net, nodes, *sets)) == (30, 30)


def test_counters_read_one_each_per_dense_edge_set_of_a_multi_scale_step(through_function):
    """g2m, each m2m set of each of the 10 M2M blocks, m2g: 2 + 10 * 2 at
    three scales."""
    sim, graph, run = _ms(blocks=10)
    want = 2 + 10 * len(graph.m2m)
    assert want == 22 and _round_trip(sim, run) == (want, want)


def test_function_path_keeps_the_models_gradients(through_function):
    """The models with their stages through EdgeEpilogue's plain versions
    against the composite: round-off only."""
    net, nodes, sets = _mgn(blocks=2)
    run = lambda: tmgn.mesh_graph_net_apply(net, nodes, *sets)  # noqa: E731
    got = _forward_backward(net, run)
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == (4, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ee, "takes", lambda device, dtype: False)
        want = _forward_backward(net, run)
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == (4, 4)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for name in got[1]:
        torch.testing.assert_close(got[1][name], want[1][name], rtol=1e-4, atol=1e-5)


def test_single_scale_one_hidden_layer_never_reaches_the_epilogue(through_function):
    """The single-scale GNS (one hidden layer) takes the fused edge block:
    the epilogue's counters stay at 0."""
    from sgnn_tpu_torch.models.encode_process_decode import EncodeProcessDecode, EPDConfig

    epd = EncodeProcessDecode(EPDConfig(node_in=4, edge_in=3, node_out=2, latent_dim=8, num_message_passing_steps=2),
                              generator=torch.Generator().manual_seed(0))
    m, k = 12, 4
    g = torch.Generator().manual_seed(1)
    degrees = torch.randint(0, k + 1, (m, 1), generator=g).float()
    out = epd_flat.encode_process_decode_apply_flat(epd, torch.randn(m, 4, generator=g),
                                                    torch.randn(m * k, 3, generator=g),
                                                    torch.randint(0, m, (m * k,), generator=g), degrees, k)
    out.sum().backward()
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == (0, 0)
