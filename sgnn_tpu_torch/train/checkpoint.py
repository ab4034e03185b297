"""Best-only checkpoints of the train state, with resume.

Port of ``sgnn_tpu/train/checkpoint.py`` with ``torch.save`` /
``torch.load`` in place of orbax. A checkpoint mirrors JAX's train state::

    {"params": simulator state_dict, "opt_state": optimizer.state_dict()
     (None when there is no optimizer), "step": int}

Names are the same (``model-best-XXXXXX``, ``model-final-XXXXXX``) and
``checkpoint_meta.json`` records the latest one with its step and best
validation loss. Tensors are stored on the CPU.

``load_optimizer_state`` restores Adam's state into an optimizer of either
form: the card's capturable Adam (its step counts and lr on the device)
or the CPU's (step counts on the CPU, a float lr), whichever form wrote
the checkpoint; the optimizer keeps its own lr and flags.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

STATE_KEYS = ("params", "opt_state", "step")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def train_state(sim: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None, step: int = 0) -> dict:
    """The state a checkpoint holds, from a simulator and its optimizer."""
    return {
        "params": sim.state_dict(),
        "opt_state": None if optimizer is None else optimizer.state_dict(),
        "step": int(step),
    }


# the settings of an optimizer group that its form fixes, not its checkpoint
_OWN_GROUP_KEYS = ("lr", "capturable", "foreach", "fused", "differentiable")


def load_optimizer_state(optimizer: torch.optim.Optimizer, opt_state: dict) -> None:
    """``optimizer.load_state_dict(opt_state)`` for a state written by either
    form of Adam. ``load_state_dict`` takes every group setting from the
    checkpoint; the lr (a device tensor that a captured step reads in
    place, or a float) and the capturable / foreach / fused flags are set
    back to this optimizer's own, and each step count is put where this
    form keeps it: an f32 tensor on the parameter's device when capturable,
    on the CPU otherwise."""
    own = [{k: g[k] for k in _OWN_GROUP_KEYS if k in g} for g in optimizer.param_groups]
    optimizer.load_state_dict(opt_state)
    for group, keep in zip(optimizer.param_groups, own):
        group.update(keep)
    for group in optimizer.param_groups:
        capturable = group.get("capturable", False)
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                step = float(state["step"])
                state["step"] = torch.tensor(step, dtype=torch.float32, device=p.device if capturable else "cpu")


class CheckpointManager:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)

    def _meta_path(self) -> Path:
        return self.dir / "checkpoint_meta.json"

    def _save(self, state: dict, name: str, meta: dict) -> Path:
        if set(state) != set(STATE_KEYS):
            raise ValueError(f"a checkpoint holds the keys {STATE_KEYS}, got {sorted(state)}")
        path = self.dir / name
        torch.save(_to_cpu(state), path)
        with open(self._meta_path(), "w") as f:
            json.dump({**meta, "path": path.name}, f)
        return path

    def save_best(self, state: dict, step: int, eval_loss: float) -> Path:
        """Save ``state`` as the new best checkpoint at ``step``."""
        return self._save(state, f"model-best-{step:06d}", {"step": step, "lowest_eval_loss": float(eval_loss)})

    def save_final(self, state: dict, step: int) -> Path:
        """Fallback save on interrupt or when no validation ever ran."""
        return self._save(state, f"model-final-{step:06d}", {"step": step, "lowest_eval_loss": None})

    def latest(self) -> Optional[dict]:
        if not self._meta_path().exists():
            return None
        with open(self._meta_path()) as f:
            return json.load(f)

    def restore(self, name: Optional[str] = None, map_location=None) -> Tuple[dict, dict]:
        """(state, meta) of checkpoint ``name`` (or the latest)."""
        meta = self.latest()
        if name is None:
            if meta is None:
                raise FileNotFoundError(f"No checkpoint metadata in {self.dir}")
            name = meta["path"]
        state = torch.load(self.dir / name, map_location=map_location, weights_only=True)
        if not isinstance(state, dict) or set(state) != set(STATE_KEYS):
            raise ValueError(
                f"{self.dir / name} is not a train-state checkpoint (keys {STATE_KEYS}); a bare "
                "state_dict of the first port release is not read: wrap it as "
                "{'params': state_dict, 'opt_state': None, 'step': 0}"
            )
        return state, (meta or {"step": 0, "lowest_eval_loss": None})
