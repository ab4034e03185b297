"""Row gather ``out[..., :] = table[idx[...], :]``: three CUDA kernels, and
the gathers of the multi-scale model with their backwards as two more.

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
  * a table that requires grad is refused: a gather that needs a backward
    goes through one of the autograd Functions below.

``row_gather`` is the one the multi-scale model calls: the variant named
by ``MODEL_VARIANT``, which ``chip_smoke.py`` timed fastest at the model's
shapes (PERF.md). ``LAUNCHES[variant]`` counts each kernel's launches.

The model's gathers are ``torch.autograd.Function``s whose forward is
``row_gather`` (the counterparts of the JAX model's custom VJPs,
``sgnn_tpu/models/multi_scale.py``):

  * ``sorted_gather`` (``_sorted_gather``): idx ascending; its backward is
    ``sorted_segment_sum``;
  * ``planned_gather`` (``_planned_gather``): its backward is
    ``planned_gather_bwd``, the masked slot sum over the static transpose
    plan (``DenseEdges.tsp_*``), then the sum of the plan rows per node;
  * ``indexed_gather``: any indices; its backward is ``ops/segment``'s
    ``segment_sum`` on ``index_add_`` (float atomics on the card, in no
    fixed order), as JAX's plain ``table[idx]`` transposes to XLA's
    unsorted scatter. The COO layout's sender gathers take it.

The two backwards are CUDA kernels of ``csrc/row_gather_bwd.cu``: one warp
per output row, sums in index (slot, then plan row) order in f32 from 0,
rounded once to g's dtype, no atomics, so two launches give the same bits;
their plain versions (``sorted_segment_sum_reference``,
``planned_gather_bwd_reference``) add in the same order. Ids must be
ascending (``recv``, ``tsp_node`` and flattened COO receivers are by
construction; the training batcher checks it on the host, the kernels do
not). ``BWD_LAUNCHES["sorted"|"planned"]`` counts their launches.
"""
from __future__ import annotations

import ctypes

import torch

from sgnn_tpu_torch.kernels import build
from sgnn_tpu_torch.ops.segment import segment_sum

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
            "row_gather has no backward: a gather that needs one goes through sorted_gather, "
            "planned_gather or indexed_gather; or call it under torch.no_grad()"
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


# --- the backwards: csrc/row_gather_bwd.cu ----------------------------------------

BWD_KERNEL = "row_gather_bwd"
# Kernel launches since the last reset, per backward (plain counters, as LAUNCHES)
BWD_LAUNCHES = {"sorted": 0, "planned": 0}
_MAX_COUNT = 2**31 - 64  # int positions in the kernels


def _ordered_segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """f32 ``out[s] = sum of data[i] over ids[i] == s`` for ascending ids,
    each run added in index order from 0 (an id outside ``[0,
    num_segments)`` adds nothing): the kernels' order. ``data`` is f32."""
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32, device=data.device)
    ids = ids.reshape(-1).long()
    if ids.numel() == 0:
        return out
    rank = torch.arange(ids.numel(), device=ids.device) - torch.searchsorted(ids, ids)  # position in its run
    keep = (ids >= 0) & (ids < num_segments)
    for j in range(int(rank.max()) + 1):
        sel = keep & (rank == j)  # at most one entry per run: no two adds to one row
        out[ids[sel]] += data[sel]
    return out


def sorted_segment_sum_reference(g: torch.Tensor, idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The plain version of ``sorted_segment_sum``."""
    return _ordered_segment_sum(g.float(), idx, num_nodes).to(g.dtype)


def planned_gather_bwd_reference(
    g: torch.Tensor, tsp_rows: torch.Tensor, tsp_node: torch.Tensor, tsp_mask: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """The plain version of ``planned_gather_bwd``."""
    rows = g.float()[tsp_rows.long().clamp(0, g.shape[0] - 1)]  # [Rs, Ks, W]
    sums = torch.zeros((rows.shape[0], g.shape[1]), dtype=torch.float32, device=g.device)
    for k in range(rows.shape[1]):  # slot order; a masked slot adds nothing
        sums = sums + torch.where(tsp_mask[:, k, None], rows[:, k], 0.0)
    return _ordered_segment_sum(sums, tsp_node, num_nodes).to(g.dtype)


def _check_rows(name: str, g: torch.Tensor, num_nodes: int) -> None:
    if g.dim() != 2:
        raise ValueError(f"{name} takes g as [rows, W], got {tuple(g.shape)}")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: g is float32 or bfloat16, got {g.dtype}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: g must lie on a cpu or cuda device, got {g.device}")
    if not g.is_contiguous():
        raise ValueError(f"{name} takes a contiguous g")
    if (g.shape[1] * g.element_size()) % 16 or g.shape[1] < 1:
        raise ValueError(f"{name}: a row must be a multiple of 16 bytes: W={g.shape[1]} in {g.dtype}")
    if g.data_ptr() % 16:
        raise ValueError(f"{name}: g must start on a 16-byte boundary")
    if not 0 <= num_nodes <= _MAX_COUNT or g.shape[0] > _MAX_COUNT:
        raise ValueError(f"{name}: {g.shape[0]} rows into {num_nodes} nodes is too large for one launch")


def _check_ids(name: str, g: torch.Tensor, **ids: torch.Tensor) -> None:
    for key, t in ids.items():
        if t.dtype not in _INDEX_CODE:
            raise TypeError(f"{name}: {key} is int32 or int64, got {t.dtype}")
        if t.device != g.device:
            raise ValueError(f"{name}: {key} lies on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {key}")


def _launch_bwd(kind: str, fn_name: str, device: torch.device, *args) -> None:
    lib = build.load(BWD_KERNEL)
    if lib.sgnn_sorted_segment_sum.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sgnn_sorted_segment_sum.argtypes = [p, p, p, ll, ll, i, i, i, p]
        lib.sgnn_planned_gather_bwd.argtypes = [p, ll, p, p, p, p, ll, ll, ll, i, i, i, p]
        for fn in (lib.sgnn_sorted_segment_sum, lib.sgnn_planned_gather_bwd):
            fn.restype = ctypes.c_int
        lib.sgnn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgnn_cuda_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} ({lib.sgnn_cuda_error_string(err).decode()})")
    BWD_LAUNCHES[kind] += 1


def sorted_segment_sum(g: torch.Tensor, idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``out[n] = sum of g[i] over idx[i] == n`` -> ``[num_nodes, W]`` in g's
    dtype, for g ``[M, W]`` and ascending idx of M entries (the backward of
    ``sorted_gather``)."""
    _check_rows("sorted_segment_sum", g, num_nodes)
    _check_ids("sorted_segment_sum", g, idx=idx)
    if idx.numel() != g.shape[0]:
        raise ValueError(f"sorted_segment_sum: {idx.numel()} ids for {g.shape[0]} rows of g")
    if g.device.type == "cpu":
        return sorted_segment_sum_reference(g, idx, num_nodes)
    out = torch.empty((num_nodes, g.shape[1]), dtype=g.dtype, device=g.device)
    _launch_bwd("sorted", "sgnn_sorted_segment_sum", g.device, g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                g.shape[0], num_nodes, g.shape[1], _DTYPE_CODE[g.dtype], _INDEX_CODE[idx.dtype])
    return out


def planned_gather_bwd(
    g: torch.Tensor, tsp_rows: torch.Tensor, tsp_node: torch.Tensor, tsp_mask: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """``out[n] = sum over plan rows r with tsp_node[r] == n of the masked
    slot sum of g[tsp_rows[r, k]]`` -> ``[num_nodes, W]`` in g's dtype, for
    g ``[R*K, W]`` (the cotangent of the gathered ``[R, K, W]``), tsp_rows
    and tsp_mask ``[Rs, Ks]``, tsp_node ``[Rs]`` ascending (the backward of
    ``planned_gather``)."""
    _check_rows("planned_gather_bwd", g, num_nodes)
    _check_ids("planned_gather_bwd", g, tsp_rows=tsp_rows, tsp_node=tsp_node)
    if tsp_rows.dtype != tsp_node.dtype:
        raise TypeError(f"planned_gather_bwd: tsp_rows ({tsp_rows.dtype}) and tsp_node ({tsp_node.dtype}) "
                        "must share one index dtype")
    if tsp_mask.dtype != torch.bool or tsp_mask.device != g.device or not tsp_mask.is_contiguous():
        raise ValueError("planned_gather_bwd takes a contiguous bool tsp_mask on g's device")
    if tsp_rows.dim() != 2 or tsp_mask.shape != tsp_rows.shape or tsp_node.shape != tsp_rows.shape[:1]:
        raise ValueError(f"planned_gather_bwd: plan shapes tsp_rows {tuple(tsp_rows.shape)}, tsp_node "
                         f"{tuple(tsp_node.shape)}, tsp_mask {tuple(tsp_mask.shape)}")
    if g.shape[0] < 1 or tsp_rows.shape[0] > _MAX_COUNT:
        raise ValueError(f"planned_gather_bwd: g of {g.shape[0]} rows, plan of {tsp_rows.shape[0]} rows")
    if g.device.type == "cpu":
        return planned_gather_bwd_reference(g, tsp_rows, tsp_node, tsp_mask, num_nodes)
    out = torch.empty((num_nodes, g.shape[1]), dtype=g.dtype, device=g.device)
    rs, ks = tsp_rows.shape
    _launch_bwd("planned", "sgnn_planned_gather_bwd", g.device, g.data_ptr(), g.shape[0], tsp_rows.data_ptr(),
                tsp_node.data_ptr(), tsp_mask.data_ptr(), out.data_ptr(), rs, ks, num_nodes, g.shape[1],
                _DTYPE_CODE[g.dtype], _INDEX_CODE[tsp_rows.dtype])
    return out


def _rows(g: torch.Tensor) -> torch.Tensor:
    """A gather's cotangent ``[..., W]`` as contiguous ``[rows, W]``."""
    return g.reshape(-1, g.shape[-1]).contiguous()


def _check_table(table: torch.Tensor, num_nodes: int) -> None:
    if table.dim() != 2 or table.shape[0] != num_nodes:
        raise ValueError(f"the gathered table must be [num_nodes={num_nodes}, W], got {tuple(table.shape)}")


class _SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, num_nodes):
        ctx.save_for_backward(idx)
        ctx.num_nodes = num_nodes
        return row_gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return sorted_segment_sum(_rows(g), idx.reshape(-1), ctx.num_nodes), None, None


class _PlannedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, senders, tsp_rows, tsp_node, tsp_mask, num_nodes):
        ctx.save_for_backward(tsp_rows, tsp_node, tsp_mask)
        ctx.num_nodes = num_nodes
        return row_gather(table, senders)

    @staticmethod
    def backward(ctx, g):
        tsp_rows, tsp_node, tsp_mask = ctx.saved_tensors
        d_table = planned_gather_bwd(_rows(g), tsp_rows, tsp_node, tsp_mask, ctx.num_nodes)
        return d_table, None, None, None, None, None


class _IndexedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, num_nodes):
        ctx.save_for_backward(idx)
        ctx.num_nodes = num_nodes
        return row_gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(_rows(g), idx.reshape(-1), ctx.num_nodes), None, None


def sorted_gather(table: torch.Tensor, idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``table[idx]`` for ascending idx; its backward is ``sorted_segment_sum``
    (``_sorted_gather`` of the JAX model)."""
    _check_table(table, num_nodes)
    return _SortedGather.apply(table, idx, num_nodes)


def planned_gather(
    table: torch.Tensor,
    senders: torch.Tensor,  # [R, K]
    tsp_rows: torch.Tensor,
    tsp_node: torch.Tensor,
    tsp_mask: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """``table[senders]`` whose backward reads the static transpose plan
    (``planned_gather_bwd``; ``_planned_gather`` of the JAX model)."""
    _check_table(table, num_nodes)
    return _PlannedGather.apply(table, senders, tsp_rows, tsp_node, tsp_mask, num_nodes)


def indexed_gather(table: torch.Tensor, idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``table[idx]`` for any indices; its backward is ``segment_sum``
    (``index_add_``)."""
    _check_table(table, num_nodes)
    return _IndexedGather.apply(table, idx, num_nodes)
