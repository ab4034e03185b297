"""Data-parallel and graph-partitioned runs (the port of ``sgnn_tpu/parallel``)."""

from sgnn_tpu_torch.parallel.mesh import Mesh, Replicas, make_mesh, shard_batch, shard_stacked_batch
from sgnn_tpu_torch.parallel.data_parallel import DataParallelStep, make_dp_train_step

__all__ = [
    "Mesh",
    "Replicas",
    "make_mesh",
    "shard_batch",
    "shard_stacked_batch",
    "DataParallelStep",
    "make_dp_train_step",
]
