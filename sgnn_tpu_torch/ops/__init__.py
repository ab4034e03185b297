"""Radius search, the fused edge block, the row gather and its sums
(port of ``sgnn_tpu/ops`` and of the gather probe's kernels)."""
