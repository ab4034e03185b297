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

The model's gathers and sums are ``torch.autograd.Function``s around
``row_gather`` and ``sorted_segment_sum`` (the counterparts of the JAX
model's custom VJPs, ``sgnn_tpu/models/multi_scale.py``, and of its sums
over receiver-sorted ids); none of them adds with atomics, so their bits
repeat:

  * ``sorted_gather`` (``_sorted_gather``): idx ascending; its backward is
    ``sorted_segment_sum``;
  * ``planned_gather`` (``_planned_gather``): its backward is
    ``planned_gather_bwd``, the masked slot sum over the static transpose
    plan (``DenseEdges.tsp_*``), then the sum of the plan rows per node;
  * ``ordered_gather``: any indices, with ``order``, their stable sort,
    and ``idx[order]``; its backward is ``sorted_segment_sum`` of the
    cotangent's rows taken in that order (``row_gather(g, order)``). The
    COO layout's sender gathers (the order built with the graph on the
    host) and config A's sender gathers (sorted on the device) take it;
  * ``sorted_sum``: ``sorted_segment_sum`` over ascending ids (an
    aggregation at receivers); its backward is ``row_gather(g, ids)``,
    ``_SortedGather`` turned around.

The two backwards are CUDA kernels of ``csrc/row_gather_bwd.cu``, with no
atomics, so two launches give the same bits, and their plain versions
(``sorted_segment_sum_reference``, ``planned_gather_bwd_reference``) add in
the kernels' order:

  * the sorted sum goes by chunk of id positions (``sorted_chunk``: 16 or
    128 by shape; a lane group per chunk, no search): a run of ids inside
    one chunk is summed in index order in f32 from 0 and rounded once to
    g's dtype; a run that crosses a multiple of the chunk is summed per
    chunk in index order, and the chunks' f32 partials are added in chunk
    order from 0 (a second small launch) and rounded once;
  * the planned one goes by plan row (a lane group per run of plan rows):
    slots in slot order, then plan rows in row order, f32 from 0, rounded
    once.

Ids must be ascending (``recv``, ``tsp_node``, flattened COO receivers and
a sender order's ``idx[order]`` are by construction; the training batcher
checks the graph's on the host, the kernels do not).
``BWD_LAUNCHES["sorted"|"planned"]`` counts the wrappers' launches, one per
call, whether a backward or (the sorted sum) an aggregation called it.
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
            "row_gather has no backward: a gather that needs one goes through sorted_gather, "
            "planned_gather or ordered_gather; or call it under torch.no_grad()"
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
    """A loop over rows (``_gather_loop_kernel``): each warp walks chunks of
    rows, a lane group per row, several row loads in flight per lane."""
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
# id positions per chunk of the sorted sum: at most one id per output row, or more
SORTED_CHUNK_FEW, SORTED_CHUNK_MANY = 16, 128


def sorted_chunk(num_ids: int, num_nodes: int) -> int:
    """Id positions per chunk of ``sorted_segment_sum``, by shape alone:
    short chunks where there is at most one id per output row (more lane
    groups for the zero rows of the nodes with no id), long ones where
    there are more (fewer runs cut, fewer partials to combine)."""
    return SORTED_CHUNK_FEW if num_ids <= num_nodes else SORTED_CHUNK_MANY


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
    """The plain version of ``sorted_segment_sum``: each run of ids cut at
    the multiples of ``sorted_chunk`` into pieces, each piece summed in
    index order from 0, then a run's pieces in chunk order from 0 (a run
    inside one chunk: its index-order sum, 0 + s adding no bit). Its loops
    are bounded by the shapes alone, so it reads nothing back from the
    device (the serving step takes it on the CPU)."""
    ids = idx.reshape(-1).long()
    m, w, dev = ids.numel(), g.shape[1], g.device
    out = torch.zeros((num_nodes, w), dtype=torch.float32, device=dev)
    if m == 0:
        return out.to(g.dtype)
    chunk = sorted_chunk(m, num_nodes)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    # -1 pads the last chunk: a run of its own or part of a run of ids < 0, written nowhere
    cid = torch.cat([ids, ids.new_full((pad,), -1)]).reshape(n_chunks, chunk)
    x = torch.cat([g.float(), g.new_zeros((pad, w), dtype=torch.float32)]).reshape(n_chunks, chunk, w)
    starts = torch.ones_like(cid, dtype=torch.bool)  # a piece starts at a chunk's edge or a new id
    starts[:, 1:] = cid[:, 1:] != cid[:, :-1]
    ends = torch.ones_like(starts)
    ends[:, :-1] = starts[:, 1:]
    scan = torch.empty_like(x)  # each piece's running sum from 0, in index order
    acc = torch.zeros((n_chunks, w), dtype=torch.float32, device=dev)
    for j in range(chunk):
        acc = torch.where(starts[:, j, None], 0.0, acc) + x[:, j]
        scan[:, j] = acc
    # where a run crosses a chunk's edge: the first piece of each chunk (its
    # head) and the last (its tail), added in chunk order from 0
    flat = cid.reshape(-1)
    cont = torch.zeros(n_chunks + 1, dtype=torch.bool, device=dev)  # chunk c continues chunk c - 1's run
    cont[1:-1] = flat[chunk::chunk] == flat[chunk - 1:-1:chunk]
    head_end = torch.argmax(ends.int(), dim=1)  # the first maximum
    head = scan[torch.arange(n_chunks, device=dev), head_end]
    single = head_end == chunk - 1  # the head piece fills its chunk
    tail = scan[:, -1]
    carried = torch.zeros(w, dtype=torch.float32, device=dev)
    finals = torch.empty((n_chunks, w), dtype=torch.float32, device=dev)
    # only the chunks a run crosses into or out of matter; on the CPU every
    # chunk is walked, so nothing is read back (the serving step on the CPU
    # takes this version), on the card (checks only) just those
    walk = range(n_chunks) if dev.type == "cpu" else torch.nonzero(cont[:-1] | cont[1:]).flatten().tolist()
    for c in walk:
        v = torch.where(cont[c], carried + head[c], head[c])
        finals[c] = v
        carried = torch.where(single[c], v, tail[c])
    # a piece ends its run unless it closes a chunk that the next continues;
    # it started the run unless it is the head of a continued chunk
    pos = torch.arange(n_chunks * chunk, device=dev)
    c_of, j_of = pos // chunk, pos % chunk
    run_end = ends.reshape(-1) & ~((j_of == chunk - 1) & cont[c_of + 1])
    run_start = ~(cont[c_of] & (j_of == head_end[c_of]))
    inside = run_end & run_start & (flat >= 0) & (flat < num_nodes)
    out[flat[inside]] = scan.reshape(-1, w)[inside]
    crossing = cont[:-1] & ~(single & cont[1:])  # a continued run whose head piece ends it
    first = cid[:, 0]
    sel = crossing & (first >= 0) & (first < num_nodes)
    out[first[sel]] = finals[sel]
    return out.to(g.dtype)


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
        lib.sgnn_sorted_segment_sum.argtypes = [p, p, p, p, ll, ll, i, i, i, i, p]
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
    chunk = sorted_chunk(g.shape[0], num_nodes)
    # f32 scratch: a head and a tail partial row per chunk, for the runs that cross chunks
    partials = torch.empty(((g.shape[0] // chunk + 1) * 2 * g.shape[1],), dtype=torch.float32, device=g.device)
    _launch_bwd("sorted", "sgnn_sorted_segment_sum", g.device, g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                partials.data_ptr(), g.shape[0], num_nodes, g.shape[1], chunk, _DTYPE_CODE[g.dtype],
                _INDEX_CODE[idx.dtype])
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


class _OrderedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, order, sorted_idx, num_nodes):
        ctx.save_for_backward(order, sorted_idx)
        ctx.num_nodes = num_nodes
        return row_gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        order, sorted_idx = ctx.saved_tensors
        d_table = sorted_segment_sum(row_gather(_rows(g), order), sorted_idx, ctx.num_nodes)
        return d_table, None, None, None, None


class _SortedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_nodes):
        ctx.save_for_backward(ids)
        return sorted_segment_sum(data.contiguous(), ids, num_nodes)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return row_gather(g.contiguous(), ids), None, None


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


def ordered_gather(
    table: torch.Tensor, idx: torch.Tensor, order: torch.Tensor, sorted_idx: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """``table[idx]`` for any indices, given ``order``, a stable sort of
    the flat idx, and ``sorted_idx = idx.reshape(-1)[order]`` (ascending);
    its backward is ``sorted_segment_sum(row_gather(g, order), sorted_idx)``:
    each node's cotangent rows added in index order, with no atomics."""
    _check_table(table, num_nodes)
    if order.shape != (idx.numel(),) or sorted_idx.shape != order.shape:
        raise ValueError(f"ordered_gather: {idx.numel()} ids, order {tuple(order.shape)}, "
                         f"sorted ids {tuple(sorted_idx.shape)}")
    return _OrderedGather.apply(table, idx, order, sorted_idx, num_nodes)


def sorted_sum(data: torch.Tensor, ids: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``out[n] = sum of data[i] over ids[i] == n`` -> ``[num_nodes, W]``
    for data ``[M, W]`` and ascending ids, differentiable: the forward is
    ``sorted_segment_sum``, the backward ``row_gather(g, ids)``."""
    return _SortedSum.apply(data, ids, num_nodes)
