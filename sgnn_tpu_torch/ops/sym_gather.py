"""Row gather whose backward is a gather (no scatter-add).

Port of the unbanded part of ``sgnn_tpu/ops/sym_gather.py``
(``reverse_edge_positions``, ``sym_gather``). For a **symmetric** graph
(a radius graph whose neighbour cap never binds: the dataset's max degree
fits the slots) the edges in which node v is the sender are exactly the
reverses of v's own incoming edges, so the transpose of ``table[idx]``
has a closed form::

    (d table)[v] = sum over v's K slots of cot[reverse_edge_position(v, k)]

a dense gather plus a masked slot sum. On CUDA this backward is
deterministic, where ``index_select``'s (``index_add_``) adds with float
atomics in an order that changes from run to run.

The TPU-specific parts are not ported: the banded gathers (``band_nodes``)
and the packed three-stream gather ``packed_sym_gather``, a fusion whose
results ``tests/test_epd_flat.py`` pins equal to the unfused route the
port takes (ROADMAP.md, Queue A item 7). ``BWD_CALLS`` counts backward
passes.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Backward passes since the last reset (a plain counter, as the kernels').
BWD_CALLS = 0


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
    sos = packed[flat_s]  # [R*K, K] valid senders of each edge's sender
    rows = torch.arange(r, device=senders.device).repeat_interleave(k)[:, None]
    hit = sos == rows
    kp = torch.argmax(hit.to(torch.uint8), dim=-1)  # first matching slot
    rev_ok = (hit.any(dim=-1) & mask.reshape(-1)).reshape(r, k)
    rev_pos = (flat_s * k + kp).reshape(r, k)
    rev_pos = torch.where(rev_ok, rev_pos, torch.zeros_like(rev_pos))
    return rev_pos.to(torch.int32), rev_ok


class SymGather(torch.autograd.Function):
    """``table[idx]`` whose backward gathers the cotangent at the reverse
    positions, masks it with ``rev_ok`` and sums the K slots in f32 before
    casting to the cotangent's dtype (``_slot_reduce_dot`` of the JAX
    module)."""

    @staticmethod
    def forward(ctx, table, idx, rev_pos, rev_ok):
        ctx.save_for_backward(rev_pos, rev_ok)
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, cot):
        global BWD_CALLS
        rev_pos, rev_ok = ctx.saved_tensors
        r, k = rev_pos.shape
        gathered = cot.index_select(0, rev_pos.reshape(-1).long()).reshape(r, k, -1)
        masked = gathered * rev_ok[..., None].to(cot.dtype)
        d_table = masked.float().sum(dim=1).to(cot.dtype)
        BWD_CALLS += 1
        return d_table, None, None, None


def sym_gather(
    table: torch.Tensor,  # [R, H]
    idx: torch.Tensor,  # int64[R*K] flat sender indices
    rev_pos: torch.Tensor,  # int32[R, K]
    rev_ok: torch.Tensor,  # bool[R, K]
    band_nodes=None,
) -> torch.Tensor:
    """``table[idx]`` ([R*K, H]) with the gather-based backward; valid only
    for symmetric graphs whose neighbour cap never binds."""
    if band_nodes is not None:
        raise NotImplementedError(
            "banded gathers (band_nodes) are not ported (ROADMAP.md, Queue A item 7)"
        )
    return SymGather.apply(table, idx, rev_pos, rev_ok)
