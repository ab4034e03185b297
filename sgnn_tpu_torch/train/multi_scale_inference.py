"""Standalone multi-scale inference entry point.

Port of ``sgnn_tpu/train/multi_scale_inference.py``: a rollout + save CLI
separate from the trainer, over the shared ``predict``::

  python -m sgnn_tpu_torch.train.multi_scale_inference --config CFG --model_file F \\
      [--split valid|rollout] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

from sgnn_tpu_torch.train.config import load_config
from sgnn_tpu_torch.train.train_multi_scale import predict
from sgnn_tpu_torch.utils.device import Device


def main(argv: Optional[list] = None, device: Device = None):
    p = argparse.ArgumentParser(description="Multi-scale GNN inference (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--model_file", required=True)
    p.add_argument("--split", choices=["valid", "rollout"], default="rollout")
    p.add_argument("--device", type=str, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, {"mode": args.split, "model_file": args.model_file})
    return predict(cfg, device=args.device or device)


if __name__ == "__main__":
    main()
