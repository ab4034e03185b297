"""sgnn_tpu_torch: the PyTorch/CUDA port of sgnn_tpu for NVIDIA Hopper.

The JAX package ``sgnn_tpu`` is the reference and stays unchanged; this
package mirrors its layout module by module:

  nn/        Linear, MLP, LayerNorm, Embedding (reference state_dict layout)
  models/    readable EPD forward, the flat (block-diagonal) forward, and
             the multi-scale GNN (COO and dense-slot forwards)
  ops/       radius-neighbor search, the fused edge block (forward and
             backward CUDA kernels), the gather-backward sender gather,
             the row gather (three CUDA kernels), segment sums
  csrc/      hand-written CUDA C++ kernels for sm_90a
  kernels/   nvcc build + ctypes binding of csrc/
  physics/   simulator features, training noise, Euler integration, rollout;
             the multi-scale graph hierarchy, simulator and rollout
  data/      synthetic raw data, dataset builder, batch and trajectory
             loaders, the multi-scale static-graph loader
  train/     config, checkpoints, metrics, the loss, the captured training
             step, the train/validation/rollout entry points (both families)
  parallel/  device meshes, data-parallel steps, multi-process groups, the
             single-scale graph partition (halo exchange, guard, rollouts)
  scripts/   the row-gather probe
  utils/     JAX-params <-> state_dict mapping, device and memory helpers

Entry points run on CUDA unless the caller passes ``device="cpu"``. On
CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
