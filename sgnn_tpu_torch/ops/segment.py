"""Segment sums on ``index_add_``.

Port of ``segment_sum`` and ``coo_segment_sum`` of
``sgnn_tpu/ops/segment.py``. The JAX package computes them with
``jax.ops.segment_sum`` outside any Pallas kernel, so the port leaves them
to PyTorch's ``index_add_``. On the card that adds with atomics, in no
fixed order; ``indices_are_sorted``, a hint to XLA there, has no
counterpart and is not taken. The JAX ``mask`` argument is not taken
either: every caller passes data whose padded entries are already zero.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[i] over segment_ids[i] == s``."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def coo_segment_sum(messages: torch.Tensor, receivers: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Aggregate COO edge messages [E, D] at receiver nodes -> [N, D]."""
    return segment_sum(messages, receivers, num_nodes)
