"""The edge stage's epilogue kernels (``csrc/edge_epilogue.cu``) on the
card, against the composite they replace, at the training cells' shapes.

Needs a CUDA card and nvcc; every test skips without a card. Imports no
JAX, so it runs on a machine without it::

    python -m pytest tests/test_torch_port_edge_epilogue_cuda.py --noconftest -m cuda -q
"""

import pytest
import torch
from _edge_epilogue_reference import bwd_reference, stats

from sgnn_tpu_torch.ops import edge_epilogue as ee

pytestmark = pytest.mark.cuda

# (receivers, slots, width): MeshGraphNets' mesh and world stages at batch 8
# (38,912 nodes), the dense multi-scale m2m, g2m and m2g stages at batch 16
CELL_SHAPES = {
    "mgn_mesh": (38912, 4, 128),
    "mgn_world": (38912, 8, 128),
    "ms_m2m": (19456, 24, 128),
    "ms_g2m": (19456, 16, 128),
    "ms_m2g": (77824, 8, 128),
}
# new_e: a row's LayerNorm with its mean and mean square summed in another
# order than PyTorch's, and rsqrtf (2 ulp): values up to about 8 carry a few
# ulp of 1e-6. agg: a receiver's up to 24 such messages added, so 1e-4.
# g_o: the same moments, and two means of g_xhat * (1, xhat) in another
# order: values of order 1, 1e-5. g_e = g_new * mask: one exact product,
# equal bit for bit.
TOL = {"new_e": (2e-5, 1e-5), "agg": (1e-4, 1e-5), "g_o": (1e-5, 1e-5)}  # (atol, rtol)
# the parameter gradients: sums over up to 466,944 rows, in another order
# (per warp, per block, then blocks) than PyTorch's reduction; the error
# scales with the sum of the absolute terms (the edge block's measured
# 1.3e-7 of it at 39k terms; 2e-5 leaves room for 12 times the rows)
SUM_RTOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(r, k, d, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    degrees = torch.randint(0, k + 1, (r, 1), generator=g)
    degrees[0], degrees[-1] = 0, k
    mask = (torch.arange(k)[None, :] < degrees).float().reshape(r * k, 1)
    tensors = [
        torch.randn(r * k, d, generator=g) * 2.0 + 0.5,  # o
        torch.randn(d, generator=g) * 0.1,  # b2
        1.0 + torch.randn(d, generator=g) * 0.1,  # lns
        torch.randn(d, generator=g) * 0.1,  # lnb
        mask,
        torch.randn(r * k, d, generator=g) * mask,  # e
    ]
    cot = (torch.randn(r * k, d, generator=g), torch.randn(r, d, generator=g))
    return [t.to(device) for t in tensors], [t.to(device) for t in cot]


def _run(fn, tensors, cot, k):
    """Forward and backward: (new_e, agg, g_o, g_b2, g_lns, g_lnb, g_e)."""
    leaves = [t.clone().requires_grad_(i != 4) for i, t in enumerate(tensors)]
    new_e, agg = fn(*leaves, k)
    torch.autograd.backward((new_e, agg), cot)
    o, b2, lns, lnb, _, e = leaves
    return new_e.detach(), agg.detach(), o.grad, b2.grad, lns.grad, lnb.grad, e.grad


def _terms(tensors, cot, k):
    """|terms| summed per column of g_b2, g_lns, g_lnb (the kernels' plain backward's)."""
    o, b2, lns, _, mask, _ = tensors
    xhat, _ = stats(o, b2)
    g_o = bwd_reference(o, b2, lns, mask, *cot, k)[0]
    g_ln = (cot[0] * mask + cot[1].repeat_interleave(k, dim=0)) * mask
    return g_o.abs().sum(0), (g_ln * xhat).abs().sum(0), g_ln.abs().sum(0)


@pytest.mark.parametrize("shape", list(CELL_SHAPES))
def test_kernels_match_the_composite_at_the_cells_shapes_and_repeat_bits(cuda, shape):
    r, k, d = CELL_SHAPES[shape]
    tensors, cot = _inputs(r, k, d, cuda, seed=r + k)
    before = (ee.LAUNCHES, ee.BWD_LAUNCHES)
    got = _run(ee.edge_stage_epilogue, tensors, cot, k)
    again = _run(ee.edge_stage_epilogue, tensors, cot, k)
    assert (ee.LAUNCHES - before[0], ee.BWD_LAUNCHES - before[1]) == (2, 2)
    want = _run(ee.epilogue_plain, tensors, cot, k)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: the same bits
    for name, a, b in zip(("new_e", "agg", "g_o"), got[:3], want[:3]):
        atol, rtol = TOL[name]
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)
    mask = tensors[4]
    assert torch.equal(got[6], cot[0] * mask)  # g_e
    for name, a, b, s in zip(("g_b2", "g_lns", "g_lnb"), got[3:6], want[3:6], _terms(tensors, cot, k)):
        assert ((a - b).abs() <= SUM_RTOL * s + 1e-6).all(), (name, float((a - b).abs().max()))


@pytest.mark.parametrize("d,k", [(64, 8), (36, 5), (128, 32), (128, 1), (128, 48), (64, 64)])
def test_kernels_at_other_widths_and_slots(cuda, d, k):
    """D below 128 (lanes past D / 4 idle), K of one slot, of one whole
    group of 32, and past it (a group and a part; MeshGraphNets' widest
    slot layout, 64)."""
    tensors, cot = _inputs(1001, k, d, cuda, seed=d * k)
    before = (ee.LAUNCHES, ee.BWD_LAUNCHES)
    got = _run(ee.edge_stage_epilogue, tensors, cot, k)
    assert (ee.LAUNCHES - before[0], ee.BWD_LAUNCHES - before[1]) == (1, 1)
    want = _run(ee.epilogue_plain, tensors, cot, k)
    for name, a, b in zip(("new_e", "agg", "g_o"), got[:3], want[:3]):
        atol, rtol = TOL[name]
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)
    for name, a, b, s in zip(("g_b2", "g_lns", "g_lnb"), got[3:6], want[3:6], _terms(tensors, cot, k)):
        assert ((a - b).abs() <= SUM_RTOL * s + 1e-6).all(), name


def test_an_unused_new_e_reads_as_a_zero_cotangent(cuda):
    """g2m and m2g keep only agg: autograd hands the backward no g_new."""
    tensors, cot = _inputs(3000, 16, 128, cuda, seed=5)
    leaves = [t.clone().requires_grad_(i != 4) for i, t in enumerate(tensors)]
    _, agg = ee.edge_stage_epilogue(*leaves, 16)
    agg.backward(cot[1])
    want = _run(ee.epilogue_plain, tensors, (torch.zeros_like(cot[0]), cot[1]), 16)
    torch.testing.assert_close(leaves[0].grad, want[2], atol=1e-5, rtol=1e-5)
    assert leaves[5].grad is None or not leaves[5].grad.any()


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """bf16 latents take the plain code (no launch); f32 latents the kernels
    do not take raise, with no plain fallback."""
    tensors, _ = _inputs(10, 4, 128, cuda)
    bf16 = [t.bfloat16() if i in (0, 4, 5) else t for i, t in enumerate(tensors)]
    before = (ee.LAUNCHES, ee.BWD_LAUNCHES)
    got = ee.edge_stage_epilogue(*bf16, 4)
    want = ee.epilogue_plain(*bf16, 4)
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for d in (256, 6):
        wide, _ = _inputs(10, 4, d, cuda)
        with pytest.raises(ValueError):
            ee.edge_stage_epilogue(*wide, 4)


def test_no_receivers_launch_nothing(cuda):
    """R = 0: empty outputs and gradients, and the counters do not move."""
    tensors, cot = _inputs(1, 8, 128, cuda)
    empty = [t[:0] if t.dim() == 2 else t for t in tensors]
    before = (ee.LAUNCHES, ee.BWD_LAUNCHES)
    got = _run(ee.edge_stage_epilogue, empty, (cot[0][:0], cot[1][:0]), 8)
    assert (ee.LAUNCHES, ee.BWD_LAUNCHES) == before
    assert got[0].shape == (0, 128) and got[1].shape == (0, 128) and got[2].shape == (0, 128)
    assert all(g is None or not g.any() for g in got[3:6])


# --- inside a captured training step --------------------------------------------


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    from sgnn_tpu_torch.data.builder import DatasetBuilder
    from sgnn_tpu_torch.data.synthetic import generate_synthetic_raw_dataset

    root = tmp_path_factory.mktemp("card_epilogue")
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
    else:
        base.update(num_scales=2, window_size=2, ms_dense=True, input_sequence_length=3)
    return TrainConfig(**base)


def _steps(family, cfg, device, batches, capture):
    from sgnn_tpu_torch.train import train, train_multi_scale

    built = (train_multi_scale if family == "multi_scale" else train).build_training(cfg, device)
    built.step_fn.capture = capture
    losses = [built.step_fn(b, i)["train/loss"].clone() for i, b in enumerate(batches)]
    params = {n: p.detach().clone() for n, p in built.sim.named_parameters()}
    built.step_fn.close()
    return losses, params


@pytest.mark.parametrize("family,per_step", [("meshgraphnet", 4), ("multi_scale", 4)])
def test_kernels_launch_inside_a_captured_train_step(cuda, tiny_data, family, per_step):
    """5 steps of the trainer's TrainStep, captured (warm-up, capture, 4
    replays) and eager: every step counts its launches (MeshGraphNets: 2
    edge sets x 2 blocks; dense multi-scale: g2m, 2 M2M blocks of one set,
    m2g), replays through the capture's record, and the two routes end
    with the same bits."""
    from sgnn_tpu_torch.data.prefetch import to_device
    from sgnn_tpu_torch.train import train, train_multi_scale

    trainer = train_multi_scale if family == "multi_scale" else train
    cfg = _config(tiny_data, family)
    built = trainer.build_training(cfg, cuda)
    source = built.batcher.epochs()
    batches = [to_device(next(source), cuda) for _ in range(5)]
    del built
    counts = []
    for capture in (True, False):
        before = (ee.LAUNCHES, ee.BWD_LAUNCHES)
        run = _steps(family, cfg, cuda, batches, capture)
        counts.append((ee.LAUNCHES - before[0], ee.BWD_LAUNCHES - before[1]))
        if capture:
            captured = run
    assert counts == [(5 * per_step, 5 * per_step)] * 2
    eager = run
    assert all(torch.equal(a, b) for a, b in zip(captured[0], eager[0]))
    assert all(torch.equal(v, eager[1][n]) for n, v in captured[1].items())
