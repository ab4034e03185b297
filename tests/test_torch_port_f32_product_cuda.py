"""The f32 product kernels (``csrc/f32_product.cu``) on the card, against an
f64 product, at the shapes the five cells run.

Needs a CUDA card and nvcc; every test skips without a card. Imports no
JAX, so it runs on a machine without it::

    python -m pytest tests/test_torch_port_f32_product_cuda.py --noconftest -m cuda -q
"""

import pytest
import torch
from _f32_product_emulation import through_emulation

from sgnn_tpu_torch.ops import f32_product as fp

pytestmark = pytest.mark.cuda

# (rows, inner width K, output width N): the training cells' products. MeshGraphNets at batch 8
# (38,912 nodes; mesh 4 and world 8 slots), dense multi-scale at batch 16 (77,824 grid nodes; m2m
# 19,456 x 24, g2m 19,456 x 16, m2g 77,824 x 8 slot rows), single-scale at batch 32 (155,648 nodes,
# width 64); the encoders' feature widths, the decoder's 3-wide output; rows 0 and a ragged few
SHAPES = {
    "mgn_world_edges": (311296, 128, 128),
    "mgn_mesh_edges": (155648, 128, 128),
    "mgn_nodes": (38912, 128, 128),
    "ms_m2m_edges": (466944, 128, 128),
    "ms_m2g_edges": (622592, 128, 128),
    "ms_grid_nodes": (77824, 128, 128),
    "ss_nodes": (155648, 64, 64),
    "edge_encoder_3": (311296, 3, 128),
    "edge_encoder_6": (155648, 6, 128),
    "node_encoder_30": (77824, 30, 128),
    "ss_node_encoder": (155648, 37, 64),
    "decoder_3": (38912, 128, 3),
    "ss_decoder_2": (155648, 64, 2),
    "wide_inner_384": (38912, 384, 128),
    "inner_256_out_200": (5000, 256, 200),
    "ragged": (129, 5, 9),
    "one_row": (1, 128, 128),
    "no_rows": (0, 128, 128),
}
# |error| against the f64 product, over the sum of the terms' sizes. The products: 3xTF32 terms
# (about 2^-22 of a term each) summed in f32 over K <= 384, so 1e-5. The weight and bias gradients:
# sums over up to 622,592 rows in f32 (chunks, then splits, then the reduce), so 2e-5, as the
# epilogue's parameter gradients.
ROWS_RTOL = 1e-5
SUM_RTOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weight(k, n, layout, g):
    """w [k, n] as the models pass it: a transposed torch weight, a row block of a [n, 384] one, or
    contiguous."""
    if layout == "transposed":
        return (torch.randn(n, k, generator=g) / k ** 0.5).t()
    if layout == "row_block":
        return (torch.randn(n, 3 * k, generator=g) / k ** 0.5).t()[k:2 * k]
    return torch.randn(k, n, generator=g) / k ** 0.5


def _inputs(m, k, n, layout, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    w = _weight(k, n, layout, g)
    b = torch.randn(n, generator=g) * 0.1
    cot = torch.randn(m, n, generator=g)
    # keep w's strides on the card: move its storage, then view it the same way
    w_dev = torch.empty_strided(w.shape, w.stride(), device=device)
    w_dev.copy_(w)
    return x.to(device), w_dev, b.to(device), cot.to(device)


def _run(x, w, b, relu, cot):
    """linear's output and the gradients of x, w (in w's layout) and b (None without a bias)."""
    xl = x.detach().clone().requires_grad_(True)
    wl = torch.empty_strided(w.shape, w.stride(), device=w.device).copy_(w).requires_grad_(True)
    bl = None if b is None else b.detach().clone().requires_grad_(True)
    y = fp.linear(xl, wl, bl, relu)
    y.backward(cot)
    return y.detach(), xl.grad, wl.grad, None if bl is None else bl.grad


def _assert_within(name, got, want, terms, rtol):
    err = (got.double() - want).abs()
    worst = float((err / (rtol * terms + 1e-30)).max()) if err.numel() else 0.0
    assert worst <= 1.0, f"{name}: {worst:.3f} of its limit (max |err| {float(err.max()):.3e})"


@pytest.mark.parametrize("relu,bias", [(True, True), (False, False)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_products_match_f64_at_the_cells_shapes(cuda, shape, relu, bias):
    """Forward, input, weight and bias gradients against f64 (the gradients with
    the kernels' ReLU gate: where the preactivation lies within rounding of 0
    the two sides' gates may differ, and only there)."""
    m, k, n = SHAPES[shape]
    layout = "row_block" if shape in ("mgn_nodes", "ms_grid_nodes") else "transposed"
    x, w, b, cot = _inputs(m, k, n, layout, cuda, seed=m + k + n)
    b = b if bias else None
    before = dict(fp.LAUNCHES)
    y, dx, dw, db = _run(x, w, b, relu, cot)
    torch.cuda.synchronize()
    assert {key: fp.LAUNCHES[key] - before[key] for key in before} == dict.fromkeys(fp.LAUNCHES, int(m > 0))
    x64, w64 = x.double(), w.double()
    pre = x64 @ w64 + (0.0 if b is None else b.double())
    terms = x64.abs() @ w64.abs() + (0.0 if b is None else b.double().abs())
    _assert_within("y", y, pre.clamp_min(0.0) if relu else pre, terms, ROWS_RTOL)
    if relu:
        gate = y > 0
        assert bool(((gate == (pre > 0)) | (pre.abs() <= ROWS_RTOL * terms)).all())
        gg = torch.where(gate, cot.double(), 0.0)
    else:
        gg = cot.double()
    ag = gg.abs()
    _assert_within("dx", dx, gg @ w64.t(), ag @ w64.abs().t(), ROWS_RTOL)
    _assert_within("dw", dw, x64.t() @ gg, x64.abs().t() @ ag, SUM_RTOL)
    if b is not None:
        _assert_within("db", db, gg.sum(0), ag.sum(0), SUM_RTOL)
    if layout == "transposed":  # the gradient comes back in w's layout: a torch weight's is contiguous
        assert dw.t().is_contiguous()


def test_two_runs_give_the_same_bits(cuda):
    x, w, b, cot = _inputs(466944, 128, 128, "transposed", cuda, seed=3)
    runs = [_run(x, w, b, True, cot) for _ in range(2)]
    assert all(torch.equal(p, q) for p, q in zip(*runs))


def test_kernels_replay_inside_a_captured_graph(cuda):
    """Forward and backward captured in a CUDA graph and replayed on new inputs
    give the eager route's bits."""
    x, w, b, cot = _inputs(100000, 128, 128, "transposed", cuda, seed=4)
    xs, ws, bs, cs = (t.detach().clone() for t in (x, w, b, cot))
    ws = torch.empty_strided(w.shape, w.stride(), device=cuda).copy_(w)
    leaves = [t.requires_grad_(True) for t in (xs, ws, bs)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):  # warm-up outside the capture
            y = fp.linear(*leaves, relu=True)
            grads = torch.autograd.grad(y, leaves, cs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fp.linear(*leaves, relu=True)
        grads = torch.autograd.grad(y, leaves, cs)
    x2, w2, b2, c2 = _inputs(100000, 128, 128, "transposed", cuda, seed=5)
    for dst, src in zip((xs, ws, bs, cs), (x2, w2, b2, c2)):
        dst.detach().copy_(src)
    before = dict(fp.LAUNCHES)
    graph.replay()
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before  # a replay launches nothing through the wrapper
    want = _run(x2, w2, b2, True, c2)
    assert torch.equal(y, want[0])
    assert all(torch.equal(p, q) for p, q in zip(grads, want[1:]))


def test_wrapper_routes_and_refusals(cuda):
    """bf16 takes the plain product (no launch); f32 on the card always the kernels, or an error."""
    x, w, b, _ = _inputs(64, 128, 128, "transposed", cuda)
    before = dict(fp.LAUNCHES)
    got = fp.linear(x.bfloat16(), w, b)
    assert fp.LAUNCHES == before
    assert torch.equal(got, fp.plain(x.bfloat16(), w, b))
    with pytest.raises(ValueError):
        fp.linear(x, w[:64], b)
    with pytest.raises(ValueError):
        fp.linear(x, w.bfloat16(), b)


# --- inside a captured training step ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    from sgnn_tpu_torch.data.builder import DatasetBuilder
    from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

    root = tmp_path_factory.mktemp("card_f32_product")
    generate_synthetic_raw_dataset(root / "raw", num_sims=3, nx=12, ny=6, num_steps=60, seed=0)
    DatasetBuilder(root / "raw", root / "data", step_size=2, total_steps=40, val_patterns=["-110"],
                   test_patterns=["-120"], boundary_particles_to_remove=2).build()
    return root


def _config(root, family):
    from sgnn_tpu_torch.train.config import TrainConfig

    base = dict(mode="train", data_path=str(root / "data"), model_path=str(root / "models"),
                output_path=str(root / "rollouts"), layers=2, hidden_dim=32, dim=2, input_sequence_length=2,
                connection_radius=0.6, batch_size=2, noise_std=0.02, lr_init=1e-3, pad_multiple=32, seed=0,
                run_name=family, ntraining_steps=8, nsave_steps=4, log_every=4)
    if family == "meshgraphnet":
        base.update(architecture="meshgraphnet")
    elif family == "multi_scale":
        base.update(num_scales=2, window_size=2, ms_dense=True, input_sequence_length=3)
    return TrainConfig(**base)


def _trainer(family):
    from sgnn_tpu_torch.train import train, train_multi_scale

    return train_multi_scale if family == "multi_scale" else train


def _batches(family, cfg, device, n):
    from sgnn_tpu_torch.data.prefetch import to_device

    built = _trainer(family).build_training(cfg, device)
    source = built.batcher.epochs()
    return [to_device(next(source), device) for _ in range(n)]


def _products_per_step(family, cfg):
    """The model's f32 products in one training step, counted by running the
    step on the CPU over the emulated kernels (each product one launch)."""
    from sgnn_tpu_torch.data.prefetch import to_device

    cpu = torch.device("cpu")
    built = _trainer(family).build_training(cfg, cpu)
    batch = to_device(next(built.batcher.epochs()), cpu)
    before = dict(fp.LAUNCHES)
    with through_emulation():
        built.step_fn(batch, 0)
    return {key: fp.LAUNCHES[key] - before[key] for key in before}


@pytest.mark.parametrize("family", ["meshgraphnet", "multi_scale", "gns"])
def test_launches_per_captured_train_step(cuda, tiny_data, family):
    """5 steps of the trainer's TrainStep (warm-up, capture, 4 replays): each
    step counts one launch of each kind per f32 product the model makes (the
    step's count on the CPU), and the captured route ends with the eager
    route's bits."""
    cfg = _config(tiny_data, family)
    batches = _batches(family, cfg, cuda, 5)
    per_step = _products_per_step(family, cfg)
    assert per_step["fwd"] > 0 and per_step["wgrad"] == per_step["fwd"]
    runs = []
    for capture in (True, False):
        built = _trainer(family).build_training(cfg, cuda)
        built.step_fn.capture = capture
        before = dict(fp.LAUNCHES)
        losses = [built.step_fn(b, i)["train/loss"].clone() for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        assert {key: fp.LAUNCHES[key] - before[key] for key in before} == {k: 5 * v for k, v in per_step.items()}
        runs.append((losses, {n: p.detach().clone() for n, p in built.sim.named_parameters()}))
        built.step_fn.close()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(v, runs[1][1][n]) for n, v in runs[0][1].items())


GEMM_NAMES = ("gemm", "Kernel2", "xmma", "cutlass")


@pytest.mark.parametrize("family", ["meshgraphnet", "multi_scale"])
def test_no_library_gemm_in_a_captured_step(cuda, tiny_data, family):
    """A profiled replay of the captured step runs the product kernels, and no
    cuBLAS or CUTLASS GEMM beyond the noise's product (at most two launches)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _config(tiny_data, family)
    batches = _batches(family, cfg, cuda, 3)
    built = _trainer(family).build_training(cfg, cuda)
    built.step_fn.capture = True
    for i, b in enumerate(batches[:2]):
        built.step_fn(b, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        built.step_fn(batches[2], 2)
        torch.cuda.synchronize()
    built.step_fn.close()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if "rows_kernel" in n or "wgrad" in n]
    library = [n for n in names if any(s in n for s in GEMM_NAMES) and n not in ours]
    assert ours, names
    assert len(library) <= 2, library
