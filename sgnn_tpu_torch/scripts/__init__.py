"""Probes of the port's kernels (``python -m sgnn_tpu_torch.scripts.<name>``)."""
