"""The plain edge stage's epilogue (bias, LayerNorm, slot mask, residual,
slot sum), forward and backward, each as one CUDA kernel.

No Pallas original: the JAX package leaves an edge stage whose MLP has two
hidden layers to XLA (``_edge_block_xla`` of ``sgnn_tpu/models/epd_flat.py``,
``_interact_dense_scales`` of ``sgnn_tpu/models/multi_scale.py``), and the
fused edge-block kernels (``ops/edge_block``) stop at D, H <= 64 and one
hidden layer. Over receiver-major slot rows (row ``r*K + k``)::

    y     = o + b2                 o: the edge MLP's last product, before its bias
    msg   = LN(y) * mask           LN: f32 moments, two-pass, eps 1e-5, affine lns, lnb
    new_e = (e + msg) * mask
    agg   = sum over the K slots of msg        f32 [R, D]

``new_e`` masks the residual: MeshGraphNets' stage writes ``e + msg``,
which has the same values since its ``e`` is zero at masked slots, and a
masked slot's gradient ends at a ``* mask`` either way; the dense
multi-scale stage writes ``(e + msg) * mask``. So one function serves both.

``edge_stage_epilogue`` is what the models call. On CUDA tensors with f32
edge latents it is ``EdgeEpilogue``, whose forward and backward launch
``csrc/edge_epilogue.cu`` (built at first use) or raise (D above 128 or not
a multiple of 4); the backward recomputes the moments from o, the one
edge-sized tensor the forward saves, and adds the parameter gradients from
per-block partials in a fixed order, so its bits repeat. Elsewhere (CPU
tensors, bf16 latents) it is ``epilogue_plain``, the composite the models
ran before the kernels, in the same order, so the CPU tests against the
JAX package see the same operations.

``LAUNCHES`` and ``BWD_LAUNCHES`` count the forward and backward kernels'
launches (the backward's second, small launch counted with it).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sgnn_tpu_torch.kernels import build
from sgnn_tpu_torch.nn.core import layer_norm

KERNEL = "edge_epilogue"
MAX_WIDTH = 128  # D: one float4 of a row per lane of a warp
_PARTIAL_FLOATS = 3 * MAX_WIDTH  # a block's partial row of the backward (g_b2, g_lns, g_lnb)

# Launches of the forward and backward kernels since the last reset (plain
# counters: callers set them to 0 and read them to show the kernels ran).
LAUNCHES = 0
BWD_LAUNCHES = 0


def takes(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether an edge stage whose latents live on ``device`` in ``dtype``
    runs on the kernels (else on ``epilogue_plain``)."""
    return device.type == "cuda" and dtype == torch.float32


def epilogue_plain(o, b2: Optional[torch.Tensor], lns, lnb, mask, e, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composite in the models' order, any dtype (``b2`` None: o
    already carries its bias). o, e ``[..., D]`` with R*K rows in all;
    mask broadcasts against them. Returns (new_e in e's shape, f32 agg
    ``[R, D]``)."""
    y = o if b2 is None else o + b2.to(o.dtype)
    msg = layer_norm(y, lns, lnb) * mask
    return (e + msg) * mask, msg.reshape(-1, k, msg.shape[-1]).float().sum(dim=1)


def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    if lib.sgnn_edge_epilogue_fwd.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sgnn_edge_epilogue_fwd.argtypes = [p] * 8 + [ll, i, i, p]
        lib.sgnn_edge_epilogue_bwd.argtypes = [p] * 9 + [i] + [p] * 3 + [ll, i, i, p]
        lib.sgnn_edge_epilogue_bwd_blocks.argtypes = [ll]
        for fn in (lib.sgnn_edge_epilogue_fwd, lib.sgnn_edge_epilogue_bwd, lib.sgnn_edge_epilogue_bwd_blocks):
            fn.restype = ctypes.c_int
        lib.sgnn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, what: str, err: int):
    raise RuntimeError(f"{what} launch failed: CUDA error {err} ({lib.sgnn_cuda_error_string(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(o, b2, lns, lnb, mask, e, k: int):
    global LAUNCHES
    rk, d = o.shape
    r = rk // k
    new_e = torch.empty_like(e)
    agg = torch.empty((r, d), dtype=torch.float32, device=o.device)
    if r == 0:
        return new_e, agg
    lib = _lib()
    with torch.cuda.device(o.device):
        err = lib.sgnn_edge_epilogue_fwd(*(t.data_ptr() for t in (o, b2, lns, lnb, mask, e, new_e, agg)), r, k, d,
                                         torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        _raise(lib, "edge_epilogue_fwd", err)
    LAUNCHES += 1
    return new_e, agg


def _launch_bwd(o, b2, lns, mask, g_new, g_agg, k: int):
    global BWD_LAUNCHES
    rk, d = o.shape
    r = rk // k
    dev = o.device
    g_o, g_e = torch.empty_like(o), torch.empty_like(o)
    if r == 0:
        return g_o, g_e, *torch.zeros((3, d), dtype=torch.float32, device=dev)
    g_params = torch.empty((3, d), dtype=torch.float32, device=dev)  # g_b2, g_lns, g_lnb
    lib = _lib()
    with torch.cuda.device(dev):
        blocks = lib.sgnn_edge_epilogue_bwd_blocks(r)
        if blocks < 1:
            raise RuntimeError(f"edge_epilogue_bwd: no grid for {r} receivers")
        partials = torch.empty((blocks, _PARTIAL_FLOATS), dtype=torch.float32, device=dev)
        err = lib.sgnn_edge_epilogue_bwd(
            o.data_ptr(), b2.data_ptr(), lns.data_ptr(), mask.data_ptr(), _ptr(g_new), _ptr(g_agg), g_o.data_ptr(),
            g_e.data_ptr(), partials.data_ptr(), blocks, g_params[0].data_ptr(), g_params[1].data_ptr(),
            g_params[2].data_ptr(), r, k, d, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise(lib, "edge_epilogue_bwd", err)
    BWD_LAUNCHES += 1
    return g_o, g_e, *g_params


class EdgeEpilogue(torch.autograd.Function):
    """The epilogue with its backward kernel: the forward saves o (not the
    LayerNorm's centred or normalised rows), the backward recomputes the
    moments. A cotangent autograd leaves out (an unused ``new_e``) stays
    None and reads as zero. ``mask`` gets no gradient. Takes o, e
    ``[R*K, D]`` and mask ``[R*K, 1]``, contiguous."""

    @staticmethod
    def forward(ctx, o, b2, lns, lnb, mask, e, k):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(o, b2, lns, mask)
        ctx.k = k
        return _launch_fwd(o, b2, lns, lnb, mask, e, k)

    @staticmethod
    def backward(ctx, g_new, g_agg):
        o, b2, lns, mask = ctx.saved_tensors
        g_new = None if g_new is None else g_new.contiguous()
        g_agg = None if g_agg is None else g_agg.contiguous()
        g_o, g_e, g_b2, g_lns, g_lnb = _launch_bwd(o, b2, lns, mask, g_new, g_agg, ctx.k)
        return g_o, g_b2, g_lns, g_lnb, None, g_e, None


def _check(o, b2, lns, lnb, mask, e, k: int) -> None:
    d = o.shape[-1]
    if k < 1 or d < 1 or e.shape != o.shape or o.numel() % (k * d):
        raise ValueError(f"edge_epilogue: o {tuple(o.shape)} and e {tuple(e.shape)} must share a shape of "
                         f"R*{k} rows")
    if mask.numel() != o.numel() // d:
        raise ValueError(f"edge_epilogue: {mask.numel()} mask values for {o.numel() // d} rows")
    for name, t in (("b2", b2), ("lns", lns), ("lnb", lnb)):
        if t.shape != (d,):
            raise ValueError(f"edge_epilogue: {name} must be [{d}], got {tuple(t.shape)}")
    if any(t.device != o.device for t in (b2, lns, lnb, mask, e)):
        raise ValueError(f"edge_epilogue runs on one device, got o on {o.device}")
    if d > MAX_WIDTH or d % 4 or any(t.dtype != torch.float32 for t in (o, b2, lns, lnb, mask, e)):
        raise ValueError(f"edge_epilogue's kernels take f32 and D <= {MAX_WIDTH}, a multiple of 4: got "
                         f"{e.dtype}, D = {d}")


def edge_stage_epilogue(o, b2: Optional[torch.Tensor], lns, lnb, mask, e, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epilogue of one edge stage: o (the last product, before its bias
    ``b2``; None where o carries it) and e ``[..., D]`` with R*K rows in
    all, receiver-major; lns, lnb ``[D]``; mask the slot validity in e's
    dtype, R*K values (``[R*K, 1]`` or ``[R, K, 1]``). Returns (new_e in
    e's shape, f32 agg ``[R, D]``), differentiable in every input but the
    mask: the kernels where ``takes`` the latents (or an error), else
    ``epilogue_plain``."""
    if not takes(e.device, e.dtype):
        return epilogue_plain(o, b2, lns, lnb, mask, e, k)
    d = o.shape[-1]
    if b2 is None:
        b2 = o.new_zeros(d)
    _check(o, b2, lns, lnb, mask, e, k)
    new_e, agg = EdgeEpilogue.apply(o.reshape(-1, d).contiguous(), b2.contiguous(), lns.contiguous(),
                                    lnb.contiguous(), mask.reshape(-1, 1).contiguous(),
                                    e.reshape(-1, d).contiguous(), k)
    return new_e.reshape(e.shape), agg
