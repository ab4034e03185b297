"""The port's launch counters, read by name (they hold across capture and
replay: ``physics/captured_step.LaunchRecord``)."""

from __future__ import annotations

from typing import Dict


def read_counters() -> Dict[str, int]:
    from sgnn_tpu_torch.ops import edge_block, row_gather

    return {
        "edge_block_fwd": int(edge_block.LAUNCHES),
        "edge_block_bwd": int(edge_block.BWD_LAUNCHES),
        "take": int(row_gather.LAUNCHES["take"]),
        "sorted": int(row_gather.BWD_LAUNCHES["sorted"]),
        "planned": int(row_gather.BWD_LAUNCHES["planned"]),
    }
