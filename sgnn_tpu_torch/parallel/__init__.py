"""Data-parallel and graph-partitioned runs (the port of ``sgnn_tpu/parallel``)."""

from sgnn_tpu_torch.parallel.mesh import Mesh, Replicas, make_mesh, shard_batch, shard_stacked_batch
from sgnn_tpu_torch.parallel.data_parallel import DataParallelStep, make_dp_train_step
from sgnn_tpu_torch.parallel.ms_partition import (
    MSPartitionedTrainStep,
    ShardedDenseMSGraph,
    ShardedEdges,
    ShardedMSGraph,
    make_ms_partitioned_forward,
    make_ms_partitioned_multi_step,
    make_ms_partitioned_rollout,
    make_ms_partitioned_train_step,
    ms_dataset_partition,
    ms_partition_sample,
    plan_ms_partition,
)

__all__ = [
    "Mesh",
    "Replicas",
    "make_mesh",
    "shard_batch",
    "shard_stacked_batch",
    "DataParallelStep",
    "make_dp_train_step",
    "MSPartitionedTrainStep",
    "ShardedDenseMSGraph",
    "ShardedEdges",
    "ShardedMSGraph",
    "make_ms_partitioned_forward",
    "make_ms_partitioned_multi_step",
    "make_ms_partitioned_rollout",
    "make_ms_partitioned_train_step",
    "ms_dataset_partition",
    "ms_partition_sample",
    "plan_ms_partition",
]
