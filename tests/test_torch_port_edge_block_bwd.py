"""Port edge-block backward (plain version and autograd Function) against
the JAX Pallas kernel's VJP in interpret mode, on CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.experimental import edge_block as jeb
from sgnn_tpu_torch.ops import edge_block as teb

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
