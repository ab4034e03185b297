"""The port's f32 matrix products, ``x @ w (+ b) (ReLU)``, forward and
backward, as hand-written 3xTF32 tensor-core kernels on the card.

No Pallas original: the JAX package leaves its Linears to XLA's dot, and on
the card PyTorch runs an f32 product (TF32 off) with cuBLAS's SIMT kernels
on the CUDA cores. ``csrc/edge_block_tile.cuh``'s split makes the tensor
cores give f32 accuracy: ``x = hi + lo`` (hi rounded to TF32) and each
product ``lo*hi + hi*lo + hi*hi``, summed in short partials that f32 adds
join (the tensor cores truncate their own sums). ``csrc/f32_product.cu``
holds three entry kinds:

  * forward ``Y = act(X W + b)``: the bias and the ReLU in the epilogue;
  * input gradient ``dX = (G * [Y > 0]) W^T``: the ReLU's gate read from
    the saved output as the cotangent is loaded;
  * weight gradient ``dW = X^T (G * [Y > 0])`` and the bias gradient (its
    column sums) from the same pass, split over the rows
    (``wgrad_partition``, a function of the row count alone) and the
    splits' partials added in split order by a second launch: no atomics,
    so the bits repeat (``remat`` recomputes bit for bit).

The forward and the input gradient run on ``wgmma`` where the inner width
is at most 128 and the output wider than 8 (every hidden product of the
three model families), else on ``mma.sync`` (the decoder's last Linear,
inner widths past 128); the kernel takes its tile from the widths it sees.

``linear`` is what the models call. f32 inputs on a CUDA device take the
kernels (``F32Product``) or raise; anything else (CPU tensors, bf16) takes
``plain``, the composite the call sites ran before, operation for
operation, so the CPU tests against the JAX package see the same bits.
``w`` is ``[K, N]`` in JAX's ``x @ w`` orientation and may be any strided
view (a transposed torch weight, a row block of it): no copy is made, and
its gradient comes back in the same orientation.

``LAUNCHES`` counts the launches by kind (``fwd``, ``dgrad``, ``wgrad``;
the weight gradient's second, small launch counted with it), after a launch
returned no error and not for an empty product.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from sgnn_tpu_torch.kernels import build

KERNEL = "f32_product"
# the weight gradient's split of the rows: at least SPLIT_MIN_ROWS rows a split and at most
# MAX_SPLITS splits (two blocks on each of the H100's 132 SMs), each a whole number of the
# kernel's CHUNK_ROWS-row chunks
MAX_SPLITS = 264
SPLIT_MIN_ROWS = 256
CHUNK_ROWS = 32

# Launches by kind since the last reset (plain counters: callers set them to 0 and read them
# to show the kernels ran).
LAUNCHES = {"fwd": 0, "dgrad": 0, "wgrad": 0}


def takes(x: torch.Tensor) -> bool:
    """Whether a product whose input ``x`` lives where it does runs on the
    kernels (else on ``plain``)."""
    return x.device.type == "cuda" and x.dtype == torch.float32


def plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, relu: bool = False,
          product: Optional[Callable] = None) -> torch.Tensor:
    """``x @ w (+ b) (ReLU)`` in x's dtype: the composite of the call sites;
    ``product(x, w)`` in place of ``x @ w`` where given."""
    y = x @ w.to(x.dtype) if product is None else product(x, w)
    if b is not None:
        y = y + b.to(x.dtype)
    return torch.relu(y) if relu else y


def wgrad_partition(m: int) -> Tuple[int, int]:
    """(splits, rows a split) of the weight gradient's sum over m >= 1 rows:
    split s adds rows [s * rows, (s + 1) * rows), the last one the rest."""
    target = min(MAX_SPLITS, -(-m // SPLIT_MIN_ROWS))
    chunks = -(-m // CHUNK_ROWS)
    rows = -(-chunks // target) * CHUNK_ROWS
    return -(-m // rows), rows


def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    if lib.sgnn_f32_product_rows.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sgnn_f32_product_rows.argtypes = [p, ll, p, ll, p, ll, ll, p, i, p, ll, ll, i, i, p]
        lib.sgnn_f32_product_wgrad.argtypes = [p, ll, p, ll, p, ll, p, p, i, ll, p, ll, ll, p, ll, i, i, p]
        for fn in (lib.sgnn_f32_product_rows, lib.sgnn_f32_product_wgrad):
            fn.restype = ctypes.c_int
        lib.sgnn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, what: str, err: int):
    raise RuntimeError(f"{what} launch failed: CUDA error {err} ({lib.sgnn_cuda_error_string(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _rows(kind: str, a, gate, b_ptr, sbk: int, sbn: int, bias, relu: bool, out):
    """One launch of the rows kernel: out [M, N] = act(a (* [gate > 0]) @ B + bias)."""
    m, k = a.shape
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.sgnn_f32_product_rows(a.data_ptr(), a.stride(0), _ptr(gate), 0 if gate is None else gate.stride(0),
                                        b_ptr, sbk, sbn, _ptr(bias), int(relu), out.data_ptr(), out.stride(0), m,
                                        out.shape[1], k, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        _raise(lib, f"f32_product {kind}", err)
    LAUNCHES[kind] += 1
    return out


def _launch_fwd(x, w, b, relu: bool):
    """y [M, N] = act(x @ w + b)."""
    y = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    return _rows("fwd", x, None, w.data_ptr(), w.stride(0), w.stride(1), b, relu, y)


def _launch_dgrad(g, gate, w):
    """dx [M, K] = (g * [gate > 0]) @ w^T (gate None: no gate)."""
    dx = torch.empty((g.shape[0], w.shape[0]), dtype=torch.float32, device=g.device)
    return _rows("dgrad", g, gate, w.data_ptr(), w.stride(1), w.stride(0), None, False, dx)


def _grad_like(w: torch.Tensor) -> torch.Tensor:
    """An empty [K, N] tensor laid out as w is ordered (a transposed weight's
    gradient comes back transposed, so its weight's gradient is contiguous)."""
    k, n = w.shape
    if w.stride(0) < w.stride(1):
        return torch.empty((n, k), dtype=torch.float32, device=w.device).t()
    return torch.empty((k, n), dtype=torch.float32, device=w.device)


def _launch_wgrad(x, g, gate, w, with_bias: bool):
    """(dw = x^T (g * [gate > 0]) in w's layout, db = its column sums or None)."""
    m, k = x.shape
    n = g.shape[1]
    dw = _grad_like(w)
    db = torch.empty(n, dtype=torch.float32, device=x.device) if with_bias else None
    if m == 0:
        return dw.zero_(), None if db is None else db.zero_()
    splits, rows = wgrad_partition(m)
    partials = torch.empty((splits, k, n), dtype=torch.float32, device=x.device)
    partials_b = torch.empty((splits, n), dtype=torch.float32, device=x.device) if with_bias else None
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sgnn_f32_product_wgrad(x.data_ptr(), x.stride(0), g.data_ptr(), g.stride(0), _ptr(gate),
                                         0 if gate is None else gate.stride(0), partials.data_ptr(),
                                         _ptr(partials_b), splits, rows, dw.data_ptr(), dw.stride(0), dw.stride(1),
                                         _ptr(db), m, k, n, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        _raise(lib, "f32_product wgrad", err)
    LAUNCHES["wgrad"] += 1
    return dw, db


class F32Product(torch.autograd.Function):
    """``act(x @ w + b)`` with its backward kernels: saves x, w and (with the
    ReLU) the output, whose sign is the gate. Takes x ``[M, K]`` with unit
    column stride, w ``[K, N]`` (any strides), b ``[N]`` or None."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        y = _launch_fwd(x, w, b, relu)
        ctx.with_bias = b is not None
        ctx.save_for_backward(x, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _launch_dgrad(g, y, w)
        if ctx.needs_input_grad[1] or (ctx.with_bias and ctx.needs_input_grad[2]):
            dw, db = _launch_wgrad(x, g, y, w, ctx.with_bias and ctx.needs_input_grad[2])
        return dx, dw if ctx.needs_input_grad[1] else None, db, None


def _check(x, w, b) -> None:
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"f32_product: x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    if w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"f32_product: w {tuple(w.shape)} is empty")
    if b is not None and b.shape != (w.shape[1],):
        raise ValueError(f"f32_product: b must be [{w.shape[1]}], got {tuple(b.shape)}")
    if any(t.device != x.device or t.dtype != torch.float32 for t in (w, b) if t is not None):
        raise ValueError(f"f32_product's kernels take f32 x, w and b on one device, got x {x.dtype} on {x.device}")


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, relu: bool = False,
           product: Optional[Callable] = None) -> torch.Tensor:
    """``x @ w (+ b) (ReLU)``: x ``[..., K]``, w ``[K, N]``, b ``[N]``;
    returns ``[..., N]``, differentiable in x, w and b. The kernels where
    ``takes(x)`` (or an error), else ``plain`` (with ``product``: a call
    site's own product for the routes off the kernels)."""
    if not takes(x):
        return plain(x, w, b, relu, product)
    _check(x, w, b)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1 or x2.stride(0) < x2.shape[1]:
        x2 = x2.contiguous()
    y = F32Product.apply(x2, w, None if b is None else b.contiguous(), relu)
    return y.reshape(*x.shape[:-1], w.shape[1])
