"""Metric logging: JSONL always, wandb when asked for.

The port's own copy of ``sgnn_tpu/train/metrics.py``. Metric names are the
reference's wandb schema: train/loss{,-position,-strain,-x,-y[,-z]}, lr,
val/loss{,-position,-strain}, val/rmse-oneStep, val/runtime. wandb is
imported only when ``use_wandb`` is set, and its absence then raises:
logging that was asked for is never dropped without a word.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    def __init__(self, log_dir: str | Path, *, use_wandb: bool = False, project: str = "", run_name: str = ""):
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore
            except ImportError as err:
                raise RuntimeError("log: true needs the wandb package, which is not installed") from err
            self._wandb = wandb
            wandb.init(project=project, name=run_name)
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")
        self._t0 = time.time()

    def log(self, metrics: dict, step: int):
        record = {"step": step, "time": time.time() - self._t0}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
