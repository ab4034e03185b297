"""Fixed-radius neighbor search with static shapes, in plain torch ops.

Port of ``sgnn_tpu/ops/neighbors.py``. The output is a dense neighbor
list: per receiver row ``i`` up to ``K`` sender indices plus a mask. The
contract (``neighbors.py:18-27, 54-62`` of the JAX module), which both
searches here reproduce exactly:

  * an edge exists iff ``d2 < r2`` (strict), with ``d2`` summed over the
    coordinates of the f32 squared difference and ``r2`` the f32 square
    of the f32 radius, so boundary pairs agree bit for bit;
  * self loops are included;
  * when more than ``K`` senders qualify, the lowest indices are kept;
  * rows are prefix-compacted and padded slots hold the row's own index;
  * masked nodes are neither senders nor receivers (degree 0);
  * in the cell-list search, a cell holding more than ``cell_capacity``
    particles keeps its lowest-index occupants and drops the rest.

The TPU layout devices of the JAX cell-table search (float index
channel, selector-matrix de-interleave, row triples) are not carried
over; the batched search here keeps the sorted-bucket structure of
``radius_neighbors_grid_batched``.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_INF = torch.iinfo(torch.int64).max  # key of an invalid candidate


class NeighborList(NamedTuple):
    """senders int64[N, K] (padded slots = own index); mask bool[N, K]."""

    senders: torch.Tensor
    mask: torch.Tensor


def _r2(radius: float) -> float:
    """f32 square of the f32 radius (as a Python float, exactly)."""
    r = np.float32(radius)
    return float(r * r)


def _finalize(keys: torch.Tensor, k: int, row0: int = 0) -> NeighborList:
    """Per row keep the k smallest keys (unique per row, _INF = invalid)."""
    n, c = keys.shape
    if c < k:
        keys = torch.cat([keys, keys.new_full((n, k - c), _INF)], dim=1)
    vals = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    mask = vals < _INF
    rows = torch.arange(row0, row0 + n, device=keys.device)[:, None].expand(n, k)
    return NeighborList(torch.where(mask, vals, rows), mask)


def radius_neighbors_bruteforce(
    positions: torch.Tensor,  # f32[N, dim]
    radius: float,
    *,
    max_neighbors: int = 20,
    node_mask: Optional[torch.Tensor] = None,  # bool[N]
    tile: int = 1024,
) -> NeighborList:
    """O(N^2) search over receiver tiles of ``tile`` rows."""
    n = positions.shape[0]
    dev = positions.device
    r2 = _r2(radius)
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    cols = torch.arange(n, device=dev)
    senders, masks = [], []
    for start in range(0, n, tile):
        q = positions[start : start + tile]
        d = q[:, None, :] - positions[None, :, :]
        d2 = (d * d).sum(dim=-1)
        valid = (d2 < r2) & node_mask[None, :] & node_mask[start : start + tile, None]
        keys = torch.where(valid, cols[None, :], _INF)
        nl = _finalize(keys, max_neighbors, row0=start)
        senders.append(nl.senders)
        masks.append(nl.mask)
    if not senders:
        empty = torch.zeros((0, max_neighbors), dtype=torch.int64, device=dev)
        return NeighborList(empty, empty.bool())
    return NeighborList(torch.cat(senders), torch.cat(masks))


def _cell_grid_shape(
    domain_min: Sequence[float], domain_max: Sequence[float], cell_size: float
) -> Tuple[int, ...]:
    return tuple(
        max(1, int(math.ceil((hi - lo) / cell_size))) for lo, hi in zip(domain_min, domain_max)
    )


class _GridConstants(NamedTuple):
    lo: torch.Tensor  # [dim] domain minimum
    cell: torch.Tensor  # [] cell side (the radius)
    gshape: torch.Tensor  # int64[dim] cells per axis
    strides: torch.Tensor  # int64[dim] row-major cell-id strides
    offsets: torch.Tensor  # int64[3^dim, dim] the neighbouring cells' offsets


_GRID_CONSTANTS: Dict[tuple, _GridConstants] = {}


def _grid_constants(device, dtype, domain_min, domain_max, radius: float, dim: int) -> _GridConstants:
    """The search's constant tensors, made once per (device, dtype, domain,
    radius, dim) and kept: a search copies nothing from the host, so it
    can be captured in a CUDA graph (which also keeps their addresses)."""
    key = (torch.device(device), dtype, tuple(map(float, domain_min)), tuple(map(float, domain_max)),
           float(radius), dim)
    c = _GRID_CONSTANTS.get(key)
    if c is None:
        grid_shape = _cell_grid_shape(domain_min, domain_max, radius)
        with torch.inference_mode(False):  # kept tensors, usable in and out of inference mode
            c = _GRID_CONSTANTS[key] = _GridConstants(
                lo=torch.tensor(domain_min, dtype=dtype, device=device),
                # a device tensor, not a Python scalar: CUDA divides by a host scalar
                # through its reciprocal, which would bin boundary particles differently
                cell=torch.tensor(radius, dtype=dtype, device=device),
                gshape=torch.tensor(grid_shape, dtype=torch.int64, device=device),
                strides=torch.tensor([math.prod(grid_shape[i + 1:]) for i in range(dim)], dtype=torch.int64,
                                     device=device),
                offsets=torch.tensor(list(itertools.product((-1, 0, 1), repeat=dim)), dtype=torch.int64,
                                     device=device),
            )
    return c


def radius_neighbors_grid_batched(
    positions: torch.Tensor,  # f32[B, N, dim]
    radius: float,
    *,
    domain_min: Tuple[float, ...],
    domain_max: Tuple[float, ...],
    max_neighbors: int = 20,
    node_mask: Optional[torch.Tensor] = None,  # bool[B, N]
    cell_capacity: int = 8,
) -> NeighborList:
    """Batched cell-list search over one block-diagonal flat graph.

    Cells of side ``radius`` over the static domain (positions are clipped
    into it); graph b's cells are offset by ``b * num_cells`` so no edge
    crosses graphs. Particles are stable-sorted by cell id, so each cell's
    occupants sit in index order in one bucket; a receiver reads the first
    ``cell_capacity`` occupants of each of its 3^dim cells. Every shape is
    static and no value is read back to the host or copied from it, so a
    step that runs the search can be captured in a CUDA graph.

    Returns senders as global flat indices into [B*N]; shapes [B*N, K].
    """
    b, n, dim = positions.shape
    dev = positions.device
    m = b * n
    grid_shape = _cell_grid_shape(domain_min, domain_max, radius)
    num_cells = math.prod(grid_shape)
    total = b * num_cells
    if node_mask is None:
        node_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    flat_pos = positions.reshape(m, dim)
    flat_mask = node_mask.reshape(m)

    c = _grid_constants(dev, positions.dtype, domain_min, domain_max, radius, dim)
    coords = torch.floor((flat_pos - c.lo) / c.cell).to(torch.int64)
    coords = torch.minimum(torch.clamp(coords, min=0), c.gshape - 1)  # [M, dim]
    batch_off = torch.arange(b, device=dev).repeat_interleave(n) * num_cells  # [M]
    cid = (coords * c.strides).sum(dim=-1) + batch_off
    cid = torch.where(flat_mask, cid, total)  # masked -> a cell nobody scans

    order = torch.sort(cid, stable=True).indices
    # buckets 0..total-1 real cells, total the masked nodes, total+1 empty;
    # a histogram of fixed size (bincount would size it from cid.max(), a
    # read of the device); integer adds are exact in any order
    counts = torch.zeros(total + 3, dtype=torch.int64, device=dev).index_add_(0, cid, torch.ones_like(cid))
    starts = torch.cumsum(counts, dim=0) - counts  # bucket c = [starts[c], starts[c+1])

    nbr = coords[:, None, :] + c.offsets[None]  # [M, 3^dim, dim]
    in_bounds = ((nbr >= 0) & (nbr < c.gshape)).all(dim=-1)
    nbr_cid = (nbr * c.strides).sum(dim=-1) + batch_off[:, None]
    nbr_cid = torch.where(in_bounds, nbr_cid, total + 1)  # an empty bucket

    c_start = starts[nbr_cid]
    c_end = starts[nbr_cid + 1]
    pos_sorted = c_start[..., None] + torch.arange(cell_capacity, device=dev)
    cand_valid = (pos_sorted < c_end[..., None]).reshape(m, -1)
    cand = order[pos_sorted.clamp(max=m - 1)].reshape(m, -1)  # [M, 3^dim * cap]

    d = flat_pos[cand] - flat_pos[:, None, :]
    d2 = (d * d).sum(dim=-1)
    valid = cand_valid & (d2 < _r2(radius)) & flat_mask[:, None]
    keys = torch.where(valid, cand, _INF)
    return _finalize(keys, max_neighbors)


def radius_neighbors(
    positions: torch.Tensor,  # f32[N, dim]
    radius: float,
    *,
    max_neighbors: int = 20,
    node_mask: Optional[torch.Tensor] = None,
    domain: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None,
    method: str = "auto",
    cell_capacity: int = 8,
) -> NeighborList:
    """Dispatcher: 'auto' picks the cell list when a domain is given."""
    if method == "auto":
        method = "grid" if domain is not None else "bruteforce"
    if method == "grid":
        if domain is None:
            raise ValueError("grid method requires a static `domain=(min, max)`")
        return radius_neighbors_grid_batched(
            positions[None],
            radius,
            domain_min=tuple(domain[0]),
            domain_max=tuple(domain[1]),
            max_neighbors=max_neighbors,
            node_mask=None if node_mask is None else node_mask[None],
            cell_capacity=cell_capacity,
        )
    if method != "bruteforce":
        raise ValueError(f"unknown neighbor method {method!r}")
    return radius_neighbors_bruteforce(
        positions, radius, max_neighbors=max_neighbors, node_mask=node_mask
    )
