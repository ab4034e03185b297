"""Port edge block (plain version) against the JAX Pallas kernel in
interpret mode and its jnp reference, on CPU; wrapper checks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgnn_tpu.experimental import edge_block as jeb
from sgnn_tpu_torch.ops import edge_block as teb

torch.set_num_threads(1)

ARG_ORDER = ["e", "xj", "proj_i", "degrees", "we", "be", "w2", "b2", "lns", "lnb"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # as tests/test_pallas_edge_block.py
# bf16 outputs carry 8 significant bits: an f32 sum in another order can
# flip an output's rounding (2^-7 rel) or a message's (up to 2^-5 at
# |msg| < 8) that then enters agg
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-4)


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


def _both(inp, dtype_jax=None, dtype_torch=None):
    jargs = [jnp.asarray(inp[n]) for n in ARG_ORDER]
    targs = [torch.from_numpy(inp[n]) for n in ARG_ORDER]
    if dtype_jax is not None:
        jargs[0], jargs[1] = jargs[0].astype(dtype_jax), jargs[1].astype(dtype_jax)
        targs[0], targs[1] = targs[0].to(dtype_torch), targs[1].to(dtype_torch)
    return jargs, targs


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("r,k,d", [(32, 8, 32), (512, 4, 16), (64, 20, 64), (37, 8, 32)])
def test_plain_matches_jax_kernel_and_reference(rng, r, k, d):
    jargs, targs = _both(make_inputs(rng, r, k, d, d))
    before = teb.LAUNCHES
    got = teb.fused_edge_block(*targs, k)  # CPU tensors: the plain version
    assert teb.LAUNCHES == before
    assert got[0].shape == (r * k, d) and got[1].shape == (r, d)
    _close(got, jeb.fused_edge_block(*jargs, k, True), F32_TOL)
    _close(got, jeb.fused_edge_block_reference(*jargs, k), F32_TOL)


def test_plain_bf16_matches_jax_kernel(rng):
    r, k, d = 64, 8, 32
    jargs, targs = _both(make_inputs(rng, r, k, d, d), jnp.bfloat16, torch.bfloat16)
    got = teb.fused_edge_block_reference(*targs, k)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    _close(got, jeb.fused_edge_block(*jargs, k, True), BF16_TOL)


def test_masked_slots_carry_no_message(rng):
    r, k, d = 16, 4, 16
    inp = make_inputs(rng, r, k, d, d)
    inp["degrees"][:4] = 0.0  # masked receivers
    inp["e"][: 4 * k] = 0.0
    _, targs = _both(inp)
    new_e, agg = teb.fused_edge_block_reference(*targs, k)
    assert torch.equal(new_e[: 4 * k], torch.zeros(4 * k, d))
    assert torch.equal(agg[:4], torch.zeros(4, d))
    deg = inp["degrees"][:, 0].astype(int)
    rows = torch.arange(r * k)
    padded = (rows % k) >= torch.from_numpy(deg).repeat_interleave(k)
    assert torch.equal(new_e[padded], targs[0][padded])  # e + 0


def _cpu_args(rng, r=8, k=4, d=16):
    return [torch.from_numpy(v) for v in (make_inputs(rng, r, k, d, d)[n] for n in ARG_ORDER)]


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda a: a.__setitem__(1, a[1][:-1]), ValueError),  # xj rows
        (lambda a: a.__setitem__(3, a[3].reshape(-1)), ValueError),  # degrees [R]
        (lambda a: a.__setitem__(4, a[4].t()), ValueError),  # we not contiguous
        (lambda a: a.__setitem__(2, a[2].double()), TypeError),  # proj_i f64
        (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), TypeError),  # mixed e/xj
        (lambda a: a[3].requires_grad_(True), NotImplementedError),  # degrees carry no gradient
    ],
)
def test_launch_checks_refuse_bad_inputs(rng, mutate, error):
    args = _cpu_args(rng)
    mutate(args)
    with pytest.raises(error):
        teb._check(*args, 4)


def test_launch_checks_accept_good_inputs(rng):
    assert teb._check(*_cpu_args(rng), 4) == (8, 16, 16)


def test_other_devices_are_refused(rng):
    args = [a.to("meta") for a in _cpu_args(rng)]
    with pytest.raises(ValueError):
        teb.fused_edge_block(*args, 4)
