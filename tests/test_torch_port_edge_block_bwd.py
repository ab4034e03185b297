"""Port edge-block backward (plain version and autograd Function) against
the JAX Pallas kernel's VJP in interpret mode, on CPU."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.experimental import edge_block as jeb
from sgnn_tpu_torch.ops import edge_block as teb
from sgnn_tpu_torch.scripts import edge_block_bwd_ablation as ablation
from _edge_block_emulation import KERNEL_SPLIT, emulated_bwd, tf32, tf32_truncate

torch.set_num_threads(1)

ARG_ORDER = ["e", "xj", "proj_i", "degrees", "we", "be", "w2", "b2", "lns", "lnb"]
GRAD_NAMES = ["e", "xj", "proj_i", "we", "be", "w2", "b2", "lns", "lnb"]
F32_TOL = dict(rtol=2e-4, atol=2e-4)  # as tests/test_pallas_edge_block.py
# bf16: g_e, g_xj and g_proj_i are stored with 8 significant bits, so an
# f32 sum in another order can flip one rounding (2^-7 relative; at most
# 2^-5 at |x| < 8). The weight gradients stay f32 sums over all edges;
# a flipped bf16 rounding of relu(h) moves one term by 2^-8 relative.
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-5)
BF16_WGRAD_TOL = dict(rtol=2.0**-8, atol=2e-3)


def make_inputs(rng, r, k, d, h):
    degrees = rng.integers(0, k + 1, size=(r, 1)).astype(np.float32)
    slot = np.tile(np.arange(k), r)[:, None]
    mask = (slot < np.repeat(degrees, k, axis=0)).astype(np.float32)
    return dict(
        e=rng.normal(size=(r * k, d)).astype(np.float32) * mask,
        xj=rng.normal(size=(r * k, h)).astype(np.float32),
        proj_i=rng.normal(size=(r, h)).astype(np.float32),
        degrees=degrees,
        we=rng.normal(size=(d, h)).astype(np.float32) * 0.2,
        be=rng.normal(size=(h,)).astype(np.float32) * 0.1,
        w2=rng.normal(size=(h, d)).astype(np.float32) * 0.2,
        b2=rng.normal(size=(d,)).astype(np.float32) * 0.1,
        lns=1.0 + 0.1 * rng.normal(size=(d,)).astype(np.float32),
        lnb=0.1 * rng.normal(size=(d,)).astype(np.float32),
    )


def both(rng, r, k, d, bf16=False):
    inp = make_inputs(rng, r, k, d, d)
    g_new = rng.normal(size=(r * k, d)).astype(np.float32)
    g_agg = rng.normal(size=(r, d)).astype(np.float32)
    jargs = [jnp.asarray(inp[n]) for n in ARG_ORDER]
    targs = [torch.from_numpy(inp[n]) for n in ARG_ORDER]
    jg, tg = [jnp.asarray(g_new), jnp.asarray(g_agg)], [torch.from_numpy(g_new), torch.from_numpy(g_agg)]
    if bf16:
        for lst, cast in ((jargs, lambda a: a.astype(jnp.bfloat16)), (jg, lambda a: a.astype(jnp.bfloat16)),
                          (targs, lambda a: a.to(torch.bfloat16)), (tg, lambda a: a.to(torch.bfloat16))):
            lst[0], lst[1] = cast(lst[0]), cast(lst[1])
    return jargs, targs, jg, tg


def jax_vjp(jargs, jg, k):
    """The JAX kernel's cotangents of the nine differentiable inputs."""
    _, vjp = jax.vjp(lambda *a: jeb.fused_edge_block(*a, k, True), *jargs)
    out = vjp(tuple(jg))
    return out[:3] + out[4:]


@pytest.mark.parametrize("r,k,d", [(32, 8, 32), (512, 4, 16), (64, 20, 64), (37, 8, 32)])
def test_plain_bwd_matches_jax_kernel_f32(rng, r, k, d):
    jargs, targs, jg, tg = both(rng, r, k, d)
    got = teb.fused_edge_block_bwd_reference(*targs, *tg, k)
    want = jax_vjp(jargs, jg, k)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **F32_TOL)


def test_plain_bwd_matches_jax_kernel_bf16(rng):
    r, k, d = 64, 8, 32
    jargs, targs, jg, tg = both(rng, r, k, d, bf16=True)
    got = teb.fused_edge_block_bwd_reference(*targs, *tg, k)
    want = jax_vjp(jargs, jg, k)
    # g_e, g_xj and g_proj_i come out in e's dtype: bf16 even for the f32
    # proj_i, as the JAX kernel emits them
    for name, a, b in zip(GRAD_NAMES[:3], got[:3], want[:3]):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), err_msg=name, **BF16_TOL)
    for name, a, b in zip(GRAD_NAMES[3:], got[3:], want[3:]):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **BF16_WGRAD_TOL)


def test_function_backward_is_the_plain_backward_on_cpu(rng):
    r, k, d = 24, 4, 16
    _, targs, _, tg = both(rng, r, k, d)
    leaves = [a.clone().requires_grad_(i != 3) for i, a in enumerate(targs)]
    before = (teb.LAUNCHES, teb.BWD_LAUNCHES)
    new_e, agg = teb.fused_edge_block(*leaves, k)
    torch.autograd.backward((new_e, agg), tuple(tg))
    assert (teb.LAUNCHES, teb.BWD_LAUNCHES) == before  # CPU tensors: no kernel
    want = teb.fused_edge_block_bwd_reference(*targs, *tg, k)
    got = [leaves[i].grad for i in (0, 1, 2, 4, 5, 6, 7, 8, 9)]
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert torch.equal(a, b), name
    assert leaves[3].grad is None  # degrees gets no gradient


def test_function_bf16_casts_proj_i_grad_back_to_f32(rng):
    r, k, d = 16, 4, 16
    _, targs, _, tg = both(rng, r, k, d, bf16=True)
    proj_i = targs[2].clone().requires_grad_(True)
    new_e, agg = teb.fused_edge_block(*targs[:2], proj_i, *targs[3:], k)
    torch.autograd.backward((new_e, agg), tuple(tg))
    want = teb.fused_edge_block_bwd_reference(*targs, *tg, k)[2]
    assert proj_i.grad.dtype == torch.float32 and want.dtype == torch.bfloat16
    assert torch.equal(proj_i.grad, want.float())


def test_gradcheck_f64():
    """The Function's CPU path against finite differences, in f64 (the
    plain versions keep f64 as f64)."""
    g = torch.Generator().manual_seed(0)
    r, k, d = 5, 3, 4
    deg = torch.tensor([[0.0], [1.0], [3.0], [2.0], [3.0]], dtype=torch.float64)

    def n(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float64) * scale).requires_grad_(True)

    args = (n(r * k, d), n(r * k, d), n(r, d), deg, n(d, d, scale=0.3), n(d, scale=0.1),
            n(d, d, scale=0.3), n(d, scale=0.1), (1 + n(d, scale=0.1)).detach().requires_grad_(True),
            n(d, scale=0.1))
    assert torch.autograd.gradcheck(lambda *a: teb.FusedEdgeBlock.apply(*a, k), args, eps=1e-6, atol=1e-5)


def test_degree_grad_is_refused(rng):
    _, targs, _, _ = both(rng, 8, 4, 16)
    targs[3].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="degrees"):
        teb.fused_edge_block(*targs, 4)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_bwd_launch_checks(rng, bad):
    _, targs, _, tg = both(rng, 8, 4, 16)
    if bad == "shape":
        tg[1] = tg[1][:-1]
    else:
        tg[0] = tg[0].double()
    with pytest.raises(ValueError):
        teb._check_bwd(targs, *tg, 4)


def test_bwd_check_refuses_more_slots_than_a_tile(rng):
    k = teb.MAX_BWD_K + 1
    _, targs, _, tg = both(rng, 2, k, 16)
    with pytest.raises(ValueError, match=f"K <= {teb.MAX_BWD_K}"):
        teb._check_bwd(targs, *tg, k)


# The CUDA backward's arithmetic, emulated on the CPU (tests/_edge_block_emulation.py),
# is held to the card tests' limits (tests/test_torch_port_cuda.py, chip_smoke.py): rows
# BWD_TOL, weight gradients SUM_RTOL * sum|terms| + 1e-6. Single-pass TF32 must fail the
# f32 row limit on the same inputs, which is why the kernel takes three passes.
CARD_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-4, 2.0**-7)}  # (atol, rtol)
CARD_SUM_RTOL = {torch.float32: 2e-5, torch.bfloat16: 1e-5}


def emulation_inputs(rng, r, k, d, bf16):
    """A few thousand rows at the model's width, xj moved off the ReLU ties
    (|h| < 0.05 gets +0.1) as the card tests do: a gate that flips between
    two summation orders changes g_h by a whole g_a."""
    _, targs, _, tg = both(rng, r, k, d, bf16=bf16)
    e, xj, proj_i, _, we, be = targs[:6]
    h = e.float() @ we.to(e.dtype).float() + xj.float() + proj_i.repeat_interleave(k, dim=0) + be
    targs[1] = torch.where(h.abs() < 0.05, xj.float() + 0.1, xj.float()).to(e.dtype)
    return targs, tg


def row_and_sum_errors(got, want, sums, dtype):
    """(worst row error over its limit, worst weight-gradient error over its
    limit): both at most 1 where the card tests would pass."""
    atol, rtol = CARD_BWD_TOL[dtype]
    rows = max(float(((a.float() - b.float()).abs() / (atol + rtol * b.float().abs())).max())
               for a, b in zip(got[:3], want[:3]))
    wg = max(float(((a - b).abs() / (CARD_SUM_RTOL[dtype] * s + 1e-6)).max())
             for a, b, s in zip(got[3:], want[3:], sums))
    return rows, wg


@pytest.mark.parametrize("rnd", [tf32, tf32_truncate, KERNEL_SPLIT], ids=["nearest", "truncate", "kernel"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_three_pass_tf32_meets_the_card_limits(rng, bf16, rnd):
    r, k, d = 512, 8, 64  # 4,096 edge rows
    targs, tg = emulation_inputs(rng, r, k, d, bf16)
    dtype = targs[0].dtype
    want = teb.fused_edge_block_bwd_reference(*targs, *tg, k)
    sums = teb.weight_grad_abs_sums(*targs, *tg, k)
    got = emulated_bwd(*targs, *tg, k, passes=3, rnd=rnd)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    rows, wg = row_and_sum_errors(got, want, sums, dtype)
    assert rows <= 1.0, f"rows at {rows:.3g} of the limit"
    assert wg <= 1.0, f"weight gradients at {wg:.3g} of the limit"
    if not bf16:  # far inside: the split leaves ~2^-22 relative per product
        assert rows < 0.1 and wg < 0.1, (rows, wg)


def test_single_pass_tf32_fails_the_f32_row_limit(rng):
    r, k, d = 512, 8, 64
    targs, tg = emulation_inputs(rng, r, k, d, bf16=False)
    want = teb.fused_edge_block_bwd_reference(*targs, *tg, k)
    sums = teb.weight_grad_abs_sums(*targs, *tg, k)
    rows, _ = row_and_sum_errors(emulated_bwd(*targs, *tg, k, passes=1), want, sums, torch.float32)
    assert rows > 1.0, f"single-pass TF32 rows at {rows:.3g} of the f32 limit"


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -1.5, 0.0])
    want = torch.tensor([1.0, 1.0, 1.0 + 2.0**-9, 1.0 + 2.0**-10, -1.5, 0.0])  # ties to even
    assert torch.equal(tf32(x), want)
    cut = torch.tensor([1.0, 1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -1.5, 0.0])  # toward zero
    assert torch.equal(tf32_truncate(x), cut)
    assert torch.equal(tf32_truncate(-x), -cut)


@pytest.mark.parametrize("name", sorted(ablation.VARIANTS))
def test_ablation_variants_cut_their_part_from_the_kernel_source(name):
    """The card-side ablation script removes each part by a pattern of the
    source text (with the tile header inlined): each must still match the
    kernel as often as it says."""
    src = ablation.kernel_source()
    variants = ablation.variant_sources(src)
    assert variants["kernel"] == src
    pattern, count = ablation.VARIANTS[name]
    assert len(variants[name]) < len(src)
    assert not re.findall(pattern, variants[name], flags=re.S)


def test_ablation_refuses_a_source_its_patterns_miss():
    with pytest.raises(ValueError, match="no_tile_loads"):
        ablation.variant_sources(ablation.kernel_source().replace("stage_rows<T>(", "stage<T>(", 1))
