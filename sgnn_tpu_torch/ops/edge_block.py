"""Fused edge block: edge MLP + LayerNorm + slot mask + edge residual +
receiver sum, forward and backward, each as one CUDA kernel.

Port of ``sgnn_tpu/experimental/edge_block.py``. One interaction-network
layer's edge stage over receiver-major flat edges (row ``r*K + s``)::

    h     = e @ We + xj + proj_i[r] + be
    a     = relu(h)
    o     = a @ W2 + b2
    msg   = (LN(o) * lns + lnb) * [s < degrees[r]]
    new_e = e + msg
    agg   = sum over the K slots of msg

``fused_edge_block`` takes JAX's argument order and layouts and is
differentiable through ``FusedEdgeBlock`` (the ``custom_vjp`` of the JAX
module): the forward saves its inputs, the backward recomputes h, a, o
and the LayerNorm statistics from them. On CPU tensors both directions
run the plain versions (``fused_edge_block_reference``,
``fused_edge_block_bwd_reference``); on CUDA tensors they launch
``csrc/edge_block_fwd.cu`` and ``csrc/edge_block_bwd.cu`` (built at first
use) or raise. ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches,
``FWD_VARIANT_LAUNCHES`` the forward's by the kernel that ran.

The forward's kernel is chosen by shape alone: the tensor-core tile kernel
(128-row tiles of whole receivers, the backward's layout) where
max(D, H) <= 64 and K <= 128, which covers every model of the repository;
else the warp-per-receiver kernel, for D and H up to 128 and any K.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sgnn_tpu_torch.kernels import build

LN_EPS = 1e-5
KERNEL = "edge_block_fwd"
BWD_KERNEL = "edge_block_bwd"
MAX_WIDTH = 128  # D and H the forward's warp-per-receiver kernel covers
MAX_BWD_WIDTH = 64  # D and H the tiles of the backward and the forward's tensor-core kernel cover
MAX_BWD_K = 128  # slots per receiver: one receiver's rows must fit a 128-row tile

# Kernel launches since the last reset (plain counters: callers set them
# to 0 and read them to show which path ran through the kernels).
# the forward's kernels, by the code sgnn_edge_block_fwd_variant returns
FWD_VARIANTS = ("tensor_core", "warp")

LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_VARIANT_LAUNCHES = dict.fromkeys(FWD_VARIANTS, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARG_NAMES = ("e", "xj", "proj_i", "degrees", "we", "be", "w2", "b2", "lns", "lnb")


def _wide(t):
    """t in f32 for the computation (f64 stays f64, for gradient checks)."""
    return t if t.dtype == torch.float64 else t.float()


def _recompute(e, xj, proj_i, we, be, w2, b2, k: int):
    """(h, a, o) in f32, rounded where ``_recompute`` of the JAX module
    rounds: in bf16 the weights are cast to bf16 before each product and
    relu(h) is rounded to bf16; every cast is the identity in f32."""
    dt = e.dtype
    h = _wide(e) @ _wide(we.to(dt)) + _wide(xj) + proj_i.repeat_interleave(k, dim=0) + be
    a = _wide(torch.relu(h).to(dt))
    o = a @ _wide(w2.to(dt)) + b2
    return h, a, o


def _ln_stats(o):
    mu = o.mean(dim=-1, keepdim=True)
    var = (o - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    return (o - mu) * inv, inv


def _slot_mask(degrees, k: int):
    """[R*K, 1] in degrees' dtype: slot < degree of the row's receiver."""
    r = degrees.shape[0]
    slot = torch.arange(k, device=degrees.device, dtype=torch.float32).repeat(r)[:, None]
    return (slot < degrees.repeat_interleave(k, dim=0)).to(degrees.dtype)


def fused_edge_block_reference(
    e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward, rounding where the TPU kernel rounds.

    In bf16, msg is rounded to bf16 before the residual and agg sums the
    rounded messages in f32 before its cast (``_fwd_kernel`` of the JAX
    module); see ``_recompute`` for h, a and o.
    """
    dt = e.dtype
    r, d = proj_i.shape[0], e.shape[-1]
    _, _, o = _recompute(e, xj, proj_i, we, be, w2, b2, k)
    xhat, _ = _ln_stats(o)
    msg = ((xhat * lns + lnb) * _slot_mask(degrees, k)).to(dt)
    new_e = e + msg
    agg = _wide(msg).reshape(r, k, d).sum(dim=1).to(dt)
    return new_e, agg


def fused_edge_block_bwd_reference(
    e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, g_new, g_agg, k: int
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward, written from ``_bwd_kernel``'s formulas.

    Recomputes h, a, o with the rounded weights (``_recompute``), then:

        g_msg = (g_new + g_agg[r]) * [s < deg]
        g_o   = inv * (g_xhat - xhat * mean(g_xhat * xhat) - mean(g_xhat)),
                g_xhat = g_msg * lns, f32 moments
        g_h   = (g_o @ W2^T) * [h > 0]            f32 weights
        g_e   = g_new + g_h @ We^T                f32 sum, then e's dtype
        g_xj  = g_h                               in e's dtype
        g_proj_i = sum over the K slots of g_h    f32 sum, then e's dtype

    and the weight gradients summed over all edges in f32: ``g_we`` from
    e as stored, ``g_w2`` from the rounded a. Returns (g_e, g_xj,
    g_proj_i, g_we, g_be, g_w2, g_b2, g_lns, g_lnb).
    """
    dt = e.dtype
    r = proj_i.shape[0]
    a, xhat, g_msg, g_o, g_h = _bwd_terms(e, xj, proj_i, degrees, we, be, w2, b2, lns, g_new, g_agg, k)
    g_e = (_wide(g_new) + g_h @ we.t()).to(dt)
    g_proj_i = g_h.reshape(r, k, -1).sum(dim=1).to(dt)
    return (
        g_e,
        g_h.to(dt),
        g_proj_i,
        _wide(e).t() @ g_h,
        g_h.sum(dim=0),
        a.t() @ g_o,
        g_o.sum(dim=0),
        (g_msg * xhat).sum(dim=0),
        g_msg.sum(dim=0),
    )


def _bwd_terms(e, xj, proj_i, degrees, we, be, w2, b2, lns, g_new, g_agg, k: int):
    """Per-edge f32 terms of the backward: (a, xhat, g_msg, g_o, g_h)."""
    h, a, o = _recompute(e, xj, proj_i, we, be, w2, b2, k)
    xhat, inv = _ln_stats(o)
    g_msg = (_wide(g_new) + _wide(g_agg).repeat_interleave(k, dim=0)) * _slot_mask(degrees, k)
    g_xhat = g_msg * lns
    g_o = inv * (
        g_xhat
        - xhat * (g_xhat * xhat).mean(dim=-1, keepdim=True)
        - g_xhat.mean(dim=-1, keepdim=True)
    )
    g_h = torch.where(h > 0, g_o @ w2.t(), torch.zeros((), device=h.device))
    return a, xhat, g_msg, g_o, g_h


def weight_grad_abs_sums(
    e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, g_new, g_agg, k: int
) -> Tuple[torch.Tensor, ...]:
    """For each entry of the six weight gradients, the sum over all edges
    of the absolute values of its terms: the scale of the error that
    summing them in another order can make (checks of the kernel use it)."""
    a, xhat, g_msg, g_o, g_h = (
        t.abs() for t in _bwd_terms(e, xj, proj_i, degrees, we, be, w2, b2, lns, g_new, g_agg, k)
    )
    return (
        _wide(e).abs().t() @ g_h,
        g_h.sum(dim=0),
        a.t() @ g_o,
        g_o.sum(dim=0),
        (g_msg * xhat).sum(dim=0),
        g_msg.sum(dim=0),
    )


def _refuse_degree_grad(degrees) -> None:
    if degrees.requires_grad:
        raise NotImplementedError(
            "degrees (valid-slot counts) is not differentiable; pass a tensor "
            "that does not require grad"
        )


def _check(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k):
    if e.dtype not in _DTYPE_CODE or xj.dtype != e.dtype:
        raise TypeError(f"e and xj must share a dtype in {list(_DTYPE_CODE)}: {e.dtype}, {xj.dtype}")
    for name, t in zip(_ARG_NAMES[2:], (proj_i, degrees, we, be, w2, b2, lns, lnb)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = (e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb)
    if any(t.device != e.device for t in tensors):
        raise ValueError("all fused_edge_block inputs must lie on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_edge_block inputs must be contiguous")
    _refuse_degree_grad(degrees)
    rows, d = e.shape
    h = we.shape[1]
    r = proj_i.shape[0]
    if rows != r * k:
        raise ValueError(f"e has {rows} rows, expected R*K = {r}*{k}")
    if xj.shape != (rows, h) or proj_i.shape != (r, h) or degrees.shape != (r, 1):
        raise ValueError(f"shapes: xj {tuple(xj.shape)} proj_i {tuple(proj_i.shape)} degrees {tuple(degrees.shape)}")
    if we.shape != (d, h) or w2.shape != (h, d) or be.shape != (h,):
        raise ValueError(f"shapes: we {tuple(we.shape)} w2 {tuple(w2.shape)} be {tuple(be.shape)}")
    if b2.shape != (d,) or lns.shape != (d,) or lnb.shape != (d,):
        raise ValueError("b2, lns and lnb must be [D]")
    if max(d, h) > MAX_WIDTH:
        raise ValueError(f"the kernel covers D, H <= {MAX_WIDTH}; got D={d}, H={h}")
    return r, d, h


def _check_bwd(args, g_new, g_agg, k):
    r, d, h = _check(*args, k)
    e = args[0]
    if max(d, h) > MAX_BWD_WIDTH:
        raise ValueError(f"the backward kernel covers D, H <= {MAX_BWD_WIDTH}; got D={d}, H={h}")
    if k > MAX_BWD_K:
        raise ValueError(f"the backward kernel covers K <= {MAX_BWD_K} slots per receiver; got K={k}")
    for name, g, shape in (("g_new", g_new, e.shape), ("g_agg", g_agg, (r, d))):
        if g.dtype != e.dtype or tuple(g.shape) != tuple(shape) or g.device != e.device:
            raise ValueError(f"{name} must be {e.dtype} {tuple(shape)} on {e.device}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
        if not g.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return r, d, h


def _error(lib, err: int, name: str) -> RuntimeError:
    return RuntimeError(f"{name} launch failed: CUDA error {err} ({lib.sgnn_cuda_error_string(err).decode()})")


def _bind_fwd(lib: ctypes.CDLL) -> None:
    fn = lib.sgnn_edge_block_fwd
    if fn.argtypes is not None:
        return
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sgnn_edge_block_fwd_variant.argtypes = [ctypes.c_int] * 3
    lib.sgnn_edge_block_fwd_variant.restype = ctypes.c_int
    lib.sgnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgnn_cuda_error_string.restype = ctypes.c_char_p


def _bind_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.sgnn_edge_block_bwd
    if fn.argtypes is not None:
        return
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grid = lib.sgnn_edge_block_bwd_grid
    grid.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    grid.restype = ctypes.c_int
    lib.sgnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgnn_cuda_error_string.restype = ctypes.c_char_p


def _device_of(e):
    if e.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_edge_block runs on cpu or cuda tensors, got {e.device}")
    return e.device.type


def edge_block_fwd(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k: int):
    """The forward on its own (no autograd): the plain version for CPU
    tensors, a CUDA kernel for CUDA tensors (the tensor-core kernel where
    max(D, H) <= 64 and K <= 128, else the warp-per-receiver kernel)."""
    global LAUNCHES
    args = (e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb)
    if _device_of(e) == "cpu":
        return fused_edge_block_reference(*args, k)
    _check(*args, k)
    new_e, agg, variant = _launch_fwd(build.load(KERNEL), args, k)
    LAUNCHES += 1
    FWD_VARIANT_LAUNCHES[variant] += 1
    return new_e, agg


def _launch_fwd(lib: ctypes.CDLL, args, k: int):
    """Launch the forward of the library ``lib`` (``csrc/edge_block_fwd.cu``
    or a build of it) on checked CUDA tensors; returns (new_e, agg, the
    name of the kernel it chose)."""
    _bind_fwd(lib)
    e, proj_i = args[0], args[2]
    r, d, h = proj_i.shape[0], e.shape[1], proj_i.shape[1]
    new_e = torch.empty_like(e)
    agg = torch.empty((r, d), dtype=e.dtype, device=e.device)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        ptrs = [t.data_ptr() for t in (*args, new_e, agg)]
        err = lib.sgnn_edge_block_fwd(*ptrs, r, k, d, h, _DTYPE_CODE[e.dtype], stream)
    if err != 0:
        raise _error(lib, err, KERNEL)
    return new_e, agg, FWD_VARIANTS[lib.sgnn_edge_block_fwd_variant(k, d, h)]


def edge_block_bwd(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, g_new, g_agg, k: int):
    """The backward on its own: the nine gradients of
    ``fused_edge_block_bwd_reference``, from the CUDA kernel for CUDA
    tensors (tensor-core tiles of whole receivers, K <= ``MAX_BWD_K``).
    The weight gradients come from per-block partial sums reduced in a
    fixed order, so two launches on the same inputs give the same bits."""
    global BWD_LAUNCHES
    args = (e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb)
    if _device_of(e) == "cpu":
        return fused_edge_block_bwd_reference(*args, g_new, g_agg, k)
    _check_bwd(args, g_new, g_agg, k)
    grads = _launch_bwd(build.load(BWD_KERNEL), args, g_new, g_agg, k)
    BWD_LAUNCHES += 1
    return grads


def _launch_bwd(lib: ctypes.CDLL, args, g_new, g_agg, k: int):
    """Launch the backward of the library ``lib`` (``csrc/edge_block_bwd.cu``
    or a build of it) on checked CUDA tensors."""
    _bind_bwd(lib)
    e, xj, proj_i = args[:3]
    r, d, h = proj_i.shape[0], e.shape[1], proj_i.shape[1]
    dev = e.device
    g_e = torch.empty_like(e)
    g_xj = torch.empty_like(xj)
    g_proj_i = torch.empty((r, h), dtype=e.dtype, device=dev)
    # weight gradients, in the order of _bwd_kernel's outputs
    sizes = (d * h, h, h * d, d, d, d)
    wgrads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        grid = ctypes.c_int(0)
        err = lib.sgnn_edge_block_bwd_grid(r, k, d, h, _DTYPE_CODE[e.dtype], ctypes.byref(grid))
        if err != 0:
            raise _error(lib, err, BWD_KERNEL)
        partials = torch.empty((max(grid.value, 1), wgrads.numel()), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (*args, g_new, g_agg, g_e, g_xj, g_proj_i, partials, wgrads)]
        err = lib.sgnn_edge_block_bwd(*ptrs, r, k, d, h, _DTYPE_CODE[e.dtype], grid.value, stream)
    if err != 0:
        raise _error(lib, err, BWD_KERNEL)
    g_we, g_be, g_w2, g_b2, g_lns, g_lnb = torch.split(wgrads, sizes)
    return g_e, g_xj, g_proj_i, g_we.view(d, h), g_be, g_w2.view(h, d), g_b2, g_lns, g_lnb


class FusedEdgeBlock(torch.autograd.Function):
    """``fused_edge_block`` with its backward kernel (the ``custom_vjp``
    of the JAX module): the forward saves its inputs as residuals, the
    backward recomputes from them. ``degrees`` gets no gradient."""

    @staticmethod
    def forward(ctx, e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k):
        ctx.k = k
        ctx.save_for_backward(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb)
        return edge_block_fwd(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k)

    @staticmethod
    def backward(ctx, g_new, g_agg):
        grads = edge_block_bwd(*ctx.saved_tensors, g_new.contiguous(), g_agg.contiguous(), ctx.k)
        g_e, g_xj, g_proj_i, *wgrads = grads
        # g_proj_i is in e's dtype, as the JAX kernel emits it; autograd
        # casts it to proj_i's f32
        return (g_e, g_xj, g_proj_i, None, *wgrads, None)


def fused_edge_block(
    e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward. e/xj: [R*K, D|H] receiver-major flat edges (f32 or bf16);
    proj_i [R, H] f32; degrees [R, 1] f32 valid-slot counts (rows are
    prefix-compacted, so the mask is slot < degree); weights f32
    (we [D, H], be [H], w2 [H, D], b2/lns/lnb [D]).
    Returns (new_e [R*K, D], agg [R, D]) in e's dtype; differentiable in
    every input but ``degrees``."""
    _device_of(e)
    _refuse_degree_grad(degrees)
    return FusedEdgeBlock.apply(e, xj, proj_i, degrees, we, be, w2, b2, lns, lnb, k)
