"""The CUDA edge-block kernels' arithmetic, emulated on the CPU.

Both kernels compute their products on tensor cores: every product with
an f32 operand as 3xTF32 (x = hi + lo, lo*hi + hi*lo + hi*hi with f32
sums), 2 passes where one operand is exactly bf16, and bf16's two
recompute products natively in bf16 with an f32 sum. The kernels split x
into hi = x rounded to TF32 (to nearest, ties away from zero, by an
integer add) and lo = x - hi, whose low 13 bits the tensor cores ignore
(truncation): ``KERNEL_SPLIT``. The emulation also holds round-to-nearest-
even and truncation of both parts. h, a and o come from one function,
``emulated_recompute``, as both
kernels take them from one device function (``recompute_tile`` of
``sgnn_tpu_torch/csrc/edge_block_tile.cuh``).

Imported by tests/test_torch_port_edge_block_bwd.py and
tests/test_torch_port_edge_block_fwd.py.
"""

import numpy as np
import torch

from sgnn_tpu_torch.ops import edge_block as teb


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    b = x.detach().float().contiguous().numpy().view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return torch.from_numpy(b.view(np.float32).copy())


def tf32_truncate(x):
    """x's top 19 bits: the TF32 value the tensor cores read from an f32."""
    b = x.detach().float().contiguous().numpy().view(np.uint32) & np.uint32(0xFFFFE000)
    return torch.from_numpy(b.view(np.float32).copy())


def tf32_half_away(x):
    """x rounded to TF32 by adding half a TF32 ulp to its magnitude bits
    and truncating: to nearest, ties away from zero (the kernels' hi)."""
    b = x.detach().float().contiguous().numpy().view(np.uint32)
    b = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(b.view(np.float32).copy())


KERNEL_SPLIT = (tf32_half_away, tf32_truncate)  # (hi, lo) roundings of the kernels


def mm_tf32(a, b, passes, rnd=tf32):
    """a @ b as the tensor cores take it: TF32 operands, exact products,
    f32 sums; passes 3 splits both operands, 2 only b (a exactly bf16).
    ``rnd`` rounds the hi and lo parts, or is a pair (hi's, lo's)."""
    hi, lo = rnd if isinstance(rnd, tuple) else (rnd, rnd)
    a, b = a.float(), b.float()
    ah, bh = hi(a), hi(b)
    if passes == 1:
        return ah @ bh
    bl = lo(b - bh)
    if passes == 2:
        assert torch.equal(a, ah)  # a needs no lo part
        return a @ bl + a @ bh
    al = lo(a - ah)
    return (al @ bh + ah @ bl) + ah @ bh


def emulated_recompute(e, xj, proj_i, we, be, w2, b2, k, passes, rnd=tf32):
    """(h, a, o) in f32 as the kernels' shared recompute takes them:
    h = ((e @ We + xj) + proj_i) + be, a = relu(h) rounded to e's dtype,
    o = a @ W2 + b2; in bf16 the weights are rounded to bf16 and the
    products are exact with f32 sums."""
    dt = e.dtype
    bf16 = dt == torch.bfloat16
    e32, xj32 = e.float(), xj.float()
    ew = e32 @ we.to(dt).float() if bf16 else mm_tf32(e32, we, passes, rnd)
    h = ew + xj32 + proj_i.repeat_interleave(k, dim=0) + be
    a = torch.relu(h).to(dt).float()
    o = (a @ w2.to(dt).float() if bf16 else mm_tf32(a, w2, passes, rnd)) + b2
    return h, a, o


def emulated_fwd(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k, passes, rnd=tf32):
    """fused_edge_block_reference with h and o taken as the CUDA
    tensor-core kernel takes them. Returns (new_e, agg, h)."""
    dt = e.dtype
    r, d = proj_i.shape[0], e.shape[-1]
    h, _, o = emulated_recompute(e, xj, proj_i, we, be, w2, b2, k, passes, rnd)
    xhat, _ = teb._ln_stats(o)
    msg = ((xhat * lns + lnb) * teb._slot_mask(degrees, k)).to(dt)
    agg = torch.zeros(r, d)
    for slot in msg.float().reshape(r, k, d).unbind(dim=1):  # f32, in slot order
        agg = agg + slot
    return e + msg, agg.to(dt), h


def emulated_bwd(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, g_new, g_agg, k, passes, rnd=tf32,
                 return_h=False):
    """fused_edge_block_bwd_reference with its products taken as the CUDA
    kernel takes them (``passes`` for every f32 operand). With
    ``return_h``, returns (the nine gradients, h)."""
    def mm(a, b, p):
        return mm_tf32(a, b, p, rnd)

    dt = e.dtype
    bf16 = dt == torch.bfloat16
    r = proj_i.shape[0]
    h, a, o = emulated_recompute(e, xj, proj_i, we, be, w2, b2, k, passes, rnd)
    xhat, inv = teb._ln_stats(o)
    g_msg = (g_new.float() + g_agg.float().repeat_interleave(k, dim=0)) * teb._slot_mask(degrees, k)
    g_xhat = g_msg * lns
    g_o = inv * (g_xhat - xhat * (g_xhat * xhat).mean(dim=-1, keepdim=True)
                 - g_xhat.mean(dim=-1, keepdim=True))
    g_h = torch.where(h > 0, mm(g_o, w2.t(), passes), torch.zeros(()))
    g_e = (g_new.float() + mm(g_h, we.t(), passes)).to(dt)
    exact = 2 if bf16 and passes == 3 else passes  # e and a are exactly bf16
    grads = (
        g_e, g_h.to(dt), g_h.reshape(r, k, -1).sum(dim=1).to(dt),
        mm(e.float().t(), g_h, exact), g_h.sum(dim=0),
        mm(a.t(), g_o, exact), g_o.sum(dim=0),
        (g_msg * xhat).sum(dim=0), g_msg.sum(dim=0),
    )
    return (grads, h) if return_h else grads
