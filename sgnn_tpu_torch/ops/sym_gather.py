"""Row gather whose backward is a gather (no scatter-add), the banded
gathers, and the packed three-stream gather.

Port of ``sgnn_tpu/ops/sym_gather.py``. For a **symmetric** graph (a
radius graph whose neighbour cap never binds: the dataset's max degree
fits the slots) the edges in which node v is the sender are exactly the
reverses of v's own incoming edges, so the transpose of ``table[idx]`` has
a closed form::

    (d table)[v] = sum over v's K slots of cot[reverse_edge_position(v, k)]

a dense gather plus a masked slot sum. On CUDA this backward is
deterministic, where ``index_select``'s (``index_add_``) adds with float
atomics in an order that changes from run to run.

**Banded gathers** (``band_nodes``). On the TPU a row gather's cost grows
with the table's rows, so JAX gathers index-local tables (spatially sorted
nodes, |sender - receiver| <= band) tile by tile from a window of the table
(``banded_gather_rows``: a scan over output tiles, a chunked form past
2.5M table rows). On the card a gather's cost does not depend on the
table's rows, so the port keeps no scan: ``banded_index`` computes, as one
int64 tensor, the index that JAX's scan ends up reading (each tile's
window start, ``clip(idx - start, 0, slice_rows - 1)`` inside it, and the
chunk's offset), and one gather on the route the unbanded gather takes
reads it. The values equal JAX's, also where the band is broken (JAX clamps
into the window and reads a wrong row; ``band_violations`` counts such
edges); where the band holds they equal ``table[idx]``. The thresholds are
JAX's (``_banded_worth``), so the same gathers take the banded index.
``gather_rows``'s P = 4 row packing is a TPU layout device whose result is
``table[idx]`` exactly: the port gathers plainly.

**The packed gather** (``packed_sym_gather``): the sender positions, the
senders-of-senders of the reverse-edge index and layer 0's sender
projections ride one f32 table ``[aux | senders bit-cast to f32 | proj]``
and one gather, the take kernel (``ops/row_gather.row_gather_take``; the
row padded to a multiple of 16 bytes). The int32 columns come back bit for
bit (a gather is a copy; -1 is a NaN pattern read as f32, never
arithmetic). Its results and its backward equal the unfused route's.

``BWD_CALLS`` counts backward passes; ``BANDED["forward"|"reverse"]``
counts the gathers that took a banded index (the sender gathers and
the backward's reverse gathers), once per call. Both are in
``physics/captured_step.COUNTERS``: a captured graph's replays add the
counts its capture made, as the kernels' launch counters do.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sgnn_tpu_torch.ops.row_gather import row_gather_take

# Backward passes since the last reset (a plain counter, as the kernels').
BWD_CALLS = 0
# Gathers that read a banded index since the last reset.
BANDED = {"forward": 0, "reverse": 0}

# JAX's engagement thresholds (sgnn_tpu/ops/sym_gather.py:148-170), kept so
# that the same gathers take the banded index.
_BANDED_MIN_ROWS = 450_000
_BANDED_MIN_FANOUT_ROWS = 200_000
_BANDED_TILE_ROWS = 32_768
_BANDED_MAX_ROWS = 2_500_000


def reverse_edge_positions(
    senders: torch.Tensor,  # int[R, K] global flat sender indices
    mask: torch.Tensor,  # bool[R, K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each edge (sender j -> receiver i) at slot (i, k), the flat
    position j*K + k' of the reverse edge (i -> j) in j's row.

    Returns (rev_pos int32[R, K], rev_ok bool[R, K]); rev_pos is 0 where
    rev_ok is False. For a symmetric, uncapped graph rev_ok == mask.
    """
    r, k = senders.shape
    flat_s = senders.reshape(-1).long()
    # invalid slots as -1: no receiver id matches them
    packed = torch.where(mask, senders.long(), torch.full_like(flat_s.view(r, k), -1))
    return _reverse_from_sos(packed[flat_s], flat_s, mask)


def _reverse_from_sos(sos: torch.Tensor, flat_s: torch.Tensor, mask: torch.Tensor):
    """The reverse-edge index from the gathered senders-of-senders
    ``sos`` [R*K, K] (invalid slots -1)."""
    r, k = mask.shape
    rows = torch.arange(r, device=mask.device).repeat_interleave(k)[:, None]
    hit = sos == rows
    kp = torch.argmax(hit.to(torch.uint8), dim=-1)  # first matching slot
    rev_ok = (hit.any(dim=-1) & mask.reshape(-1)).reshape(r, k)
    rev_pos = (flat_s * k + kp).reshape(r, k)
    rev_pos = torch.where(rev_ok, rev_pos, torch.zeros_like(rev_pos))
    return rev_pos.to(torch.int32), rev_ok


def _banded_worth(table_rows: int, out_rows: int) -> bool:
    return table_rows >= _BANDED_MIN_ROWS or (
        table_rows >= _BANDED_MIN_FANOUT_ROWS and out_rows >= 4 * table_rows
    )


def banded_index(
    idx: torch.Tensor,
    table_rows: int,
    band_rows: int,
    tile_rows: Optional[int] = None,
    *,
    map_rows: Optional[int] = None,
    map_offset: int = 0,
) -> Optional[torch.Tensor]:
    """The flat int64 index that JAX's ``banded_gather_rows(table, idx,
    band_rows, tile_rows, map_rows=, map_offset=)`` reads from a table of
    ``table_rows`` rows, or None where JAX falls back to ``table[idx]``.

    Output row i lies in tile i // tile_rows; the tile reads the window of
    ``slice_rows`` table rows that starts at ``clip(row_to_table(tile's
    first row) - band_rows, 0, rows - slice_rows)``, and row i reads
    ``start + clip(idx[i] - start, 0, slice_rows - 1)``. Past
    ``_BANDED_MAX_ROWS`` table rows the outputs split into chunks, each
    over its own table window from ``t_lo``, as JAX's two-level form.
    int64 throughout (``i * map_rows`` passes int32 at these sizes).
    """
    e = int(table_rows)
    flat = idx.reshape(-1).long()
    r = flat.numel()
    if r == 0:
        return None
    tr = min(tile_rows or _BANDED_TILE_ROWS, r)
    slice_rows = (tr * e) // r + 2 * band_rows + 2
    slice_rows = -(-slice_rows // 512) * 512
    mr = map_rows or e
    if r % mr == 0:
        q = r // mr

        def row_to_table(i):
            return i // q + map_offset
    elif mr % r == 0:
        q = mr // r

        def row_to_table(i):
            return i * q + map_offset
    else:
        return None
    if slice_rows >= e:
        return None

    def core(sub_flat: torch.Tensor, e_s: int, out_base: int, table_base: int) -> torch.Tensor:
        """JAX's ``_core`` over one output chunk, in sub-table rows."""
        r_s = sub_flat.numel()
        n_tiles = -(-r_s // tr)
        if slice_rows >= e_s or n_tiles <= 1:
            return sub_flat.clamp(0, e_s - 1)
        tiles = torch.arange(n_tiles, device=flat.device, dtype=torch.int64)
        starts = (row_to_table(out_base + tiles * tr) - table_base - band_rows).clamp(0, e_s - slice_rows)
        start = starts[torch.arange(r_s, device=flat.device) // tr]
        return start + (sub_flat - start).clamp(0, slice_rows - 1)

    if e <= _BANDED_MAX_ROWS:
        return core(flat, e, 0, 0)
    n_chunks = -(-e // _BANDED_MAX_ROWS)
    per_out = -(-r // n_chunks)
    per_out = -(-per_out // tr) * tr  # tile-aligned chunk boundaries
    parts = []
    for lo in range(0, r, per_out):
        hi = min(r, lo + per_out)
        t_lo = max(0, int(row_to_table(lo)) - band_rows)
        t_hi = min(e, int(row_to_table(hi - 1)) + band_rows + 2)
        parts.append(t_lo + core(flat[lo:hi] - t_lo, t_hi - t_lo, lo, t_lo))
    return torch.cat(parts)


def banded_gather_rows(
    table: torch.Tensor,
    idx: torch.Tensor,
    band_rows: int,
    tile_rows: Optional[int] = None,
    *,
    map_rows: Optional[int] = None,
    map_offset: int = 0,
) -> torch.Tensor:
    """JAX's ``banded_gather_rows``: ``table[idx]`` where the band holds,
    JAX's clamped row where it does not. Shape ``idx.shape + (W,)``."""
    b = banded_index(idx, table.shape[0], band_rows, tile_rows, map_rows=map_rows, map_offset=map_offset)
    flat = idx.reshape(-1).long() if b is None else b
    return table.index_select(0, flat).reshape(*idx.shape, table.shape[1])


def gather_rows(
    table: torch.Tensor,
    idx: torch.Tensor,
    band_rows: Optional[int] = None,
    *,
    map_rows: Optional[int] = None,
    map_offset: int = 0,
) -> torch.Tensor:
    """``table[idx]`` for 2-D tables: banded where ``band_rows`` is given
    and the table is past JAX's thresholds. JAX's P = 4 row packing of
    500k-1.2M-row tables returns ``table[idx]`` exactly, so the port takes
    the plain gather there."""
    if band_rows is not None and _banded_worth(table.shape[0], idx.numel()):
        return banded_gather_rows(table, idx, band_rows, map_rows=map_rows, map_offset=map_offset)
    return table.index_select(0, idx.reshape(-1).long()).reshape(*idx.shape, table.shape[1])


def band_violations(
    senders: torch.Tensor,  # int[..., M, K] sender indices, receiver-major rows
    mask: torch.Tensor,  # bool[..., M, K]
    band_nodes: int,
    halo: int = 0,
) -> torch.Tensor:
    """int64 count of valid edges with |sender - (receiver + halo)| >
    band_nodes (the receiver is the row along the second-to-last axis). A
    zero count means the forward (band_nodes) and reverse ((band_nodes +
    1) * K) bands both held, so every banded gather of the step read
    ``table[idx]``. A device tensor; nothing is read back."""
    m = senders.shape[-2]
    rows = torch.arange(m, device=senders.device)[:, None] + halo
    dev = (senders.long() - rows).abs()
    return ((dev > band_nodes) & mask).sum()


def forward_banded_index(idx: torch.Tensor, table_rows: int, band_nodes: Optional[int], halo: int = 0):
    """The sender gather's banded index (JAX's ``_maybe_banded_gather``:
    idx[i] expected within band_nodes of i // K + halo), or None where it
    gathers plainly."""
    if band_nodes is None or not _banded_worth(table_rows, idx.numel()):
        return None
    return banded_index(idx, table_rows, band_nodes, map_rows=table_rows - 2 * halo, map_offset=halo)


def reverse_banded_index(rev_pos: torch.Tensor, cot_rows: int, band_nodes: Optional[int], halo: int = 0):
    """The backward's reverse-gather index into the [cot_rows, H]
    cotangent (a shard's local edges; rev_pos may span its extended rows),
    band (band_nodes + 1) * K, centre i - halo * K; or None."""
    k = rev_pos.shape[-1]
    if band_nodes is None or not _banded_worth(cot_rows, rev_pos.numel()):
        return None
    return banded_index(rev_pos, cot_rows, (band_nodes + 1) * k, map_rows=rev_pos.numel(), map_offset=-halo * k)


def _reverse_sum(cot: torch.Tensor, rev_idx: torch.Tensor, rev_ok: torch.Tensor) -> torch.Tensor:
    """d_table[v] = sum over v's K slots of cot[rev_idx], masked by rev_ok,
    summed in f32 and cast to the cotangent's dtype (``_slot_reduce_dot``)."""
    r, k = rev_ok.shape
    gathered = cot.index_select(0, rev_idx).reshape(r, k, -1)
    masked = gathered * rev_ok[..., None].to(cot.dtype)
    return masked.float().sum(dim=1).to(cot.dtype)


class SymGather(torch.autograd.Function):
    """``table[idx]`` whose backward gathers the cotangent at the reverse
    positions ``rev_idx`` (flat; banded or not), masks it with ``rev_ok``
    and sums the K slots in f32 before casting to the cotangent's dtype."""

    @staticmethod
    def forward(ctx, table, idx, rev_idx, rev_ok, banded_fwd: bool, banded_rev: bool):
        ctx.save_for_backward(rev_idx, rev_ok)
        ctx.banded_rev = banded_rev
        if banded_fwd:
            BANDED["forward"] += 1
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, cot):
        global BWD_CALLS
        rev_idx, rev_ok = ctx.saved_tensors
        if ctx.banded_rev:
            BANDED["reverse"] += 1
        BWD_CALLS += 1
        return _reverse_sum(cot, rev_idx, rev_ok), None, None, None, None, None


def sym_gather_plan(
    idx: torch.Tensor,  # int[R*K] flat sender indices
    table_rows: int,
    rev_pos: torch.Tensor,  # int32[R, K]
    rev_ok: torch.Tensor,  # bool[R, K]
    band_nodes: Optional[int] = None,
    halo: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``table -> sym_gather(table, idx, rev_pos, rev_ok, band_nodes,
    halo)`` with both indices (banded or not) made once here, for every
    layer that gathers over this graph."""
    fwd = forward_banded_index(idx, table_rows, band_nodes, halo)
    rev = reverse_banded_index(rev_pos, idx.numel(), band_nodes, halo)
    fwd_idx = idx.reshape(-1).long() if fwd is None else fwd
    rev_idx = rev_pos.reshape(-1).long() if rev is None else rev
    return lambda table: SymGather.apply(table, fwd_idx, rev_idx, rev_ok, fwd is not None, rev is not None)


def sym_gather(
    table: torch.Tensor,  # [N, H]
    idx: torch.Tensor,  # int[R*K] flat sender indices
    rev_pos: torch.Tensor,  # int32[R, K]
    rev_ok: torch.Tensor,  # bool[R, K]
    band_nodes: Optional[int] = None,
    halo: int = 0,
) -> torch.Tensor:
    """``table[idx]`` ([R*K, H]) with the gather-based backward; valid only
    for symmetric graphs whose neighbour cap never binds. ``band_nodes``
    takes the banded indices past JAX's thresholds; ``halo`` is the left
    halo of a shard's extended table (output row i expects table row
    i // K + halo; the reverse positions are the shard's local edges)."""
    return sym_gather_plan(idx, table.shape[0], rev_pos, rev_ok, band_nodes, halo)(table)


class PackedSymGather(torch.autograd.Function):
    """``packed_sym_gather``'s forward and its backward (JAX's custom VJP,
    ``_packed_sym_gather_bwd``): d_proj[v] = the masked f32 sum of d_xj at
    v's reverse positions, cast to d_xj's dtype, then to proj's."""

    @staticmethod
    def forward(ctx, aux, proj, senders, mask, out_dtype, band_nodes):
        m, k = senders.shape
        a, h = aux.shape[1], proj.shape[1]
        packed = torch.where(mask, senders.to(torch.int32), torch.full_like(senders, -1, dtype=torch.int32))
        pad = -(a + k + h) % 4  # rows of whole 16-byte pieces for the take kernel
        table = torch.cat(
            [aux.float(), packed.view(torch.float32), proj.float(), aux.new_zeros((m, pad), dtype=torch.float32)],
            dim=1,
        ).contiguous()
        flat = senders.reshape(-1).long()
        banded = forward_banded_index(flat, m, band_nodes)
        if banded is not None:
            BANDED["forward"] += 1
        g = row_gather_take(table, flat if banded is None else banded)  # [M*K, a + k + h + pad]
        g_aux = g[:, :a].contiguous()
        sos = g[:, a : a + k].contiguous().view(torch.int32)
        xj = g[:, a + k : a + k + h].to(out_dtype or proj.dtype).contiguous()
        rev_pos, rev_ok = _reverse_from_sos(sos.long(), flat, mask)
        rev = reverse_banded_index(rev_pos, flat.numel(), band_nodes)
        ctx.save_for_backward(rev_pos.reshape(-1).long() if rev is None else rev, rev_ok)
        ctx.banded_rev = rev is not None
        ctx.proj_dtype = proj.dtype
        ctx.mark_non_differentiable(g_aux, rev_pos, rev_ok)
        return g_aux, xj, rev_pos, rev_ok

    @staticmethod
    def backward(ctx, d_aux, d_xj, d_rev_pos, d_rev_ok):
        global BWD_CALLS
        rev_idx, rev_ok = ctx.saved_tensors
        if ctx.banded_rev:
            BANDED["reverse"] += 1
        BWD_CALLS += 1
        d_proj = _reverse_sum(d_xj, rev_idx, rev_ok).to(ctx.proj_dtype)
        return None, d_proj, None, None, None, None


def packed_sym_gather(
    aux: torch.Tensor,  # f32[M, A] gathered without gradient (positions)
    proj: torch.Tensor,  # f32[M, H] differentiable sender projections
    senders: torch.Tensor,  # int[M, K] neighbour lists
    mask: torch.Tensor,  # bool[M, K]
    out_dtype: Optional[torch.dtype] = None,
    band_nodes: Optional[int] = None,
):
    """ONE gather serving three consumers of the same sender indices:
    returns (g_aux f32[M*K, A], xj [M*K, H] in ``out_dtype`` (default
    proj's), rev_pos int32[M, K], rev_ok bool[M, K]); the reverse index is
    ``reverse_edge_positions(senders, mask)``'s. ``aux`` gets no gradient.
    Valid for symmetric, uncapped graphs, as ``sym_gather``."""
    return PackedSymGather.apply(aux.detach(), proj, senders, mask, out_dtype, band_nodes)
