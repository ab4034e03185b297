"""Row gather ``out[..., :] = table[idx[...], :]``: three CUDA kernels.

Port of the three Pallas kernels of ``scripts/gather_kernel_probe.py``
(``_gather_loop_kernel``, ``_gather_unroll8_kernel``,
``_gather_take_kernel``), built from ``csrc/row_gather.cu`` at first use.
Each wrapper (``row_gather_loop``, ``row_gather_unroll8``,
``row_gather_take``) takes a 2-D table ``[rows, W]`` (float32 or bfloat16)
and an index tensor of any shape (int32 or int64) and returns
``idx.shape + (W,)`` in the table's dtype:

  * an index outside ``[0, rows)`` is clamped into it, as XLA's gather
    clamps (an index past the end reads the last row, as the TPU kernels'
    dynamic row reads do), so the kernels never read outside the table;
  * on CPU tensors a wrapper returns the plain version,
    ``row_gather_reference``; on CUDA tensors it launches its kernel on
    the current stream or raises; every other check is the same on both;
  * a table that requires grad is refused: the gathers' backwards
    (``_sorted_gather``, ``_planned_gather`` of the JAX multi-scale model)
    come with multi-scale training (ROADMAP.md, Queue A item 5b).

``row_gather`` is the one the multi-scale model calls: the variant named
by ``MODEL_VARIANT``, which ``chip_smoke.py`` timed fastest at the model's
shapes (PERF.md). ``LAUNCHES[variant]`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from sgnn_tpu_torch.kernels import build

KERNEL = "row_gather"
VARIANTS = ("loop", "unroll8", "take")
MODEL_VARIANT = "take"  # the fastest at the multi-scale sender gathers on the H100

# Kernel launches since the last reset, per variant (plain counters:
# callers set them to 0 and read them to show which path ran the kernels).
LAUNCHES = {name: 0 for name in VARIANTS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_CODE = {torch.int32: 0, torch.int64: 1}
_MAX_PIECES = 2**31  # 16-byte pieces of one output (32-bit piece indices)


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[idx]`` with indices clamped into
    ``[0, rows)``."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"row_gather takes a [rows >= 1, W] table, got {tuple(table.shape)}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_gather tables are float32 or bfloat16, got {table.dtype}")
    if idx.dtype not in _INDEX_CODE:
        raise TypeError(f"row_gather indices are int32 or int64, got {idx.dtype}")
    if table.device != idx.device or table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"table and idx must lie on one cpu or cuda device: {table.device}, {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather takes contiguous tensors")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16:
        raise ValueError(f"a row must be a multiple of 16 bytes: W={table.shape[1]} in {table.dtype}")
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary")
    if idx.numel() * row_bytes // 16 >= _MAX_PIECES:
        raise ValueError(f"output of {idx.numel()} rows x {row_bytes} bytes is too large for one launch")
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "row_gather has no backward yet: the gathers' backwards come with multi-scale "
            "training (ROADMAP.md, Queue A item 5b); call it under torch.no_grad()"
        )


def _bind(lib: ctypes.CDLL) -> None:
    if lib.sgnn_row_gather_take.argtypes is not None:
        return
    for name in VARIANTS:
        fn = getattr(lib, f"sgnn_row_gather_{name}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.sgnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgnn_cuda_error_string.restype = ctypes.c_char_p


def _gather(variant: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check(table, idx)
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    rows, width = table.shape
    out = torch.empty((*idx.shape, width), dtype=table.dtype, device=table.device)
    if idx.numel() == 0:
        return out
    lib = build.load(KERNEL)
    _bind(lib)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = getattr(lib, f"sgnn_row_gather_{variant}")(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), rows, width,
            _DTYPE_CODE[table.dtype], _INDEX_CODE[idx.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"row_gather_{variant} launch failed: CUDA error {err} "
            f"({lib.sgnn_cuda_error_string(err).decode()})"
        )
    LAUNCHES[variant] += 1
    return out


def row_gather_loop(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each warp walks its rows one at a time (``_gather_loop_kernel``)."""
    return _gather("loop", table, idx)


def row_gather_unroll8(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each warp keeps 8 row loads in flight (``_gather_unroll8_kernel``)."""
    return _gather("unroll8", table, idx)


def row_gather_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One thread per 16-byte piece of the flat output (``_gather_take_kernel``)."""
    return _gather("take", table, idx)


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather of the multi-scale model's latent rows."""
    return _gather(MODEL_VARIANT, table, idx)
