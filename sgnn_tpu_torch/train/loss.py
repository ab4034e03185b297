"""The single-scale one-step training loss.

The masked position + strain objective of JAX's ``_make_step_body``
(``sgnn_tpu/train/train.py``) and of its graph-partitioned twin
(``sgnn_tpu/parallel/edge_partition.py:631-658``), which compute the same
sums: shared by the port's single-device, data-parallel and partitioned
steps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def one_step_loss(
    pred_acc: torch.Tensor,  # [..., N, dim]
    target_acc: torch.Tensor,  # [..., N, dim]
    pred_strain: torch.Tensor,  # [..., N]
    next_strain: torch.Tensor,  # [..., N]
    node_mask: torch.Tensor,  # [..., N]
    *,
    weight_position: float,
    weight_strain: float,
    denom: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, aux metrics): masked sums over every node divided by ``denom``
    (default: the count of masked nodes, at least 1). A data-parallel
    replica passes the GLOBAL batch's count, so that its sums add up to the
    global masked mean."""
    mask = node_mask.to(pred_acc.dtype)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    sq_acc = (pred_acc - target_acc) ** 2  # [..., N, dim]
    loss_pos = sq_acc.sum(dim=-1)  # the reference sums the dims
    loss_strain = (pred_strain - next_strain) ** 2
    loss = weight_position * loss_pos + weight_strain * loss_strain
    loss = (loss * mask).sum() / denom
    loss_xy = (sq_acc * mask[..., None]).sum(dim=tuple(range(sq_acc.dim() - 1))) / denom
    aux = {
        "train/loss-position": (loss_pos * mask).sum() / denom,
        "train/loss-strain": (loss_strain * mask).sum() / denom,
        "train/loss-x": loss_xy[0],
        "train/loss-y": loss_xy[1],
    }
    if sq_acc.shape[-1] == 3:
        aux["train/loss-z"] = loss_xy[2]
    return loss, aux
