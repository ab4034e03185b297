"""The CUDA edge-block forward's arithmetic (tests/_edge_block_emulation.py)
against the port's plain version and the JAX Pallas kernel in interpret
mode, on CPU; the h that the forward and backward emulations share; the
forward's ablation patterns; kernel counts on CPU tensors."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgnn_tpu.experimental import edge_block as jeb
from sgnn_tpu_torch.ops import edge_block as teb
from sgnn_tpu_torch.scripts import edge_block_bwd_ablation as ablation
from _edge_block_emulation import KERNEL_SPLIT, emulated_bwd, emulated_fwd, tf32, tf32_truncate
from test_torch_port_edge_block import ARG_ORDER, BF16_TOL, F32_TOL, make_inputs

torch.set_num_threads(1)

# The card tests' per-element forward limits (tests/test_torch_port_cuda.py TOL,
# chip_smoke.TOL), (atol, rtol); on the card f32 agg's atol also grows as K / 20
# past 20 slots. The emulation of the tensor-core kernel's f32 arithmetic
# (3xTF32) meets the per-element limit at every tensor-core shape of the card
# tests, and a single TF32 pass fails it, which is why the kernel takes three.
CARD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0**-4, 2.0**-7)}
# (R, K, D, H): the tensor-core shapes of the card tests, at R small enough for the CPU
TC_SHAPES = [
    (512, 8, 64, 64),  # the model's K and width
    (301, 7, 64, 64),  # K divides no tile
    (200, 8, 40, 40),  # width not a multiple of 16
    (50, 7, 21, 21),  # rows of 84 bytes: element by element on the card
    (5, 128, 64, 64),  # the largest K: one receiver per tile
    (300, 8, 48, 64),  # D != H
    (300, 8, 64, 40),
]


def torch_args(inp, dtype=torch.float32):
    """make_inputs' arrays in ARG_ORDER as tensors, e and xj in ``dtype``."""
    args = [torch.from_numpy(inp[n]) for n in ARG_ORDER]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    return args


def over_limit(got, want, dtype):
    """Worst |err| / (atol + rtol * |want|) over new_e and agg: at most 1
    where the card test would pass."""
    atol, rtol = CARD_TOL[dtype]
    return max(float(((a.float() - b.float()).abs() / (atol + rtol * b.float().abs())).max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("rnd", [tf32, KERNEL_SPLIT], ids=["nearest", "kernel"])
@pytest.mark.parametrize("r,k,d,h", TC_SHAPES)
def test_three_pass_tf32_meets_the_f32_card_limit(rng, r, k, d, h, rnd):
    args = torch_args(make_inputs(rng, r, k, d, h))
    want = teb.fused_edge_block_reference(*args, k)
    new_e, agg, _ = emulated_fwd(*args, k, passes=3, rnd=rnd)
    for a, b in zip((new_e, agg), want):
        assert a.dtype == b.dtype and a.shape == b.shape
    err = over_limit((new_e, agg), want, torch.float32)
    # measured over 8 seeds: the kernel's split at most 0.25 of the limit at
    # K <= 8 and 0.60 at K = 128, where agg sums 128 messages
    assert err <= 1.0, f"3xTF32 at {err:.3g} of the f32 limit"


@pytest.mark.parametrize("seed", [4, 7])
def test_a_truncating_split_fails_the_f32_card_limit_at_128_slots(seed):
    """Truncated hi parts make every product lean toward zero; over 128
    slots agg drifts past the per-element limit (2.09 and 1.83 of it on
    these inputs, 0.31 and 0.60 with the kernel's rounded split), which is
    why the kernels round hi."""
    args = torch_args(make_inputs(np.random.default_rng(seed), 5, 128, 64, 64))
    want = teb.fused_edge_block_reference(*args, 128)
    assert over_limit(emulated_fwd(*args, 128, passes=3, rnd=tf32_truncate)[:2], want, torch.float32) > 1.0
    assert over_limit(emulated_fwd(*args, 128, passes=3, rnd=KERNEL_SPLIT)[:2], want, torch.float32) <= 1.0


def test_single_pass_tf32_fails_the_f32_card_limit(rng):
    args = torch_args(make_inputs(rng, 512, 8, 64, 64))
    want = teb.fused_edge_block_reference(*args, 8)
    err = over_limit(emulated_fwd(*args, 8, passes=1)[:2], want, torch.float32)
    assert err > 1.0, f"single-pass TF32 at {err:.3g} of the f32 limit"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_emulated_kernel_matches_the_jax_kernel(rng, dtype, tol):
    r, k, d = 64, 8, 32
    inp = make_inputs(rng, r, k, d, d)
    jargs = [jnp.asarray(inp[n]) for n in ARG_ORDER]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs[0], jargs[1] = jargs[0].astype(jdt), jargs[1].astype(jdt)
    want = jeb.fused_edge_block(*jargs, k, True)
    got = emulated_fwd(*torch_args(inp, dtype), k, passes=3)[:2]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype,rnd", [(torch.float32, tf32), (torch.float32, KERNEL_SPLIT),
                                       (torch.bfloat16, KERNEL_SPLIT)], ids=["f32-nearest", "f32-kernel", "bf16"])
def test_forward_and_backward_take_the_same_h(rng, dtype, rnd):
    """Both kernels compute h, a and o with one device function, so the
    forward's ReLU gate is the backward's, bit for bit; the emulations
    mirror that. h by another route (the plain version's f32 product) is
    not the same bits, which is what a gate near 0 hangs on."""
    r, k, d = 512, 8, 64
    args = torch_args(make_inputs(rng, r, k, d, d), dtype)
    g_new = torch.randn(r * k, d, generator=torch.Generator().manual_seed(1)).to(dtype)
    g_agg = torch.randn(r, d, generator=torch.Generator().manual_seed(2)).to(dtype)
    _, _, h_fwd = emulated_fwd(*args, k, passes=3, rnd=rnd)
    _, h_bwd = emulated_bwd(*args, g_new, g_agg, k, passes=3, rnd=rnd, return_h=True)
    assert torch.equal(h_fwd, h_bwd)
    if dtype == torch.float32:
        assert not torch.equal(h_fwd, teb._recompute(*args[:3], *args[4:8], k)[0])


@pytest.mark.parametrize("name", sorted(ablation.FWD_VARIANTS))
def test_fwd_ablation_variants_change_their_part_of_the_kernel_source(name):
    src = ablation.kernel_source(ablation.FWD_SOURCE)
    assert '#include "' + "edge_block_tile.cuh" not in src  # the header is inlined
    variants = ablation.variant_sources(src, ablation.FWD_VARIANTS)
    assert variants["kernel"] == src and variants[name] != src
    pattern = ablation.FWD_VARIANTS[name][0]
    assert not re.findall(pattern, variants[name], flags=re.S)


def test_fwd_ablation_refuses_a_source_its_patterns_miss():
    src = ablation.kernel_source(ablation.FWD_SOURCE).replace("residual_piece(new_e", "piece(new_e", 1)
    with pytest.raises(ValueError, match="no_row_stores"):
        ablation.variant_sources(src, ablation.FWD_VARIANTS)


def test_cpu_tensors_launch_no_forward_kernel(rng):
    args = torch_args(make_inputs(rng, 8, 4, 16, 16))
    before = (teb.LAUNCHES, dict(teb.FWD_VARIANT_LAUNCHES))
    teb.edge_block_fwd(*args, 4)
    assert (teb.LAUNCHES, teb.FWD_VARIANT_LAUNCHES) == before
    assert tuple(teb.FWD_VARIANT_LAUNCHES) == teb.FWD_VARIANTS
