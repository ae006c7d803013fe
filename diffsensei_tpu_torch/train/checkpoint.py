"""Checkpoints: the full train state with rotation, and weight export (port
of ``diffsensei_tpu/train/checkpoint.py``).

Like the JAX package, and unlike the reference (which saves weights only),
a checkpoint holds the trainables, the optimizer state, the step and the
generator state, so a resumed run continues the uninterrupted one. Layout and
rotation are the reference's: ``<root>/step-<N>/``, oldest removed first
beyond ``checkpoints_total_limit``. Files are ``torch.save`` pickles of whole
tensors under the single-process names, whatever the run's sharding; under
data parallelism rank 0 alone writes them (``train/runner.py``).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

_FILE = "ckpt.pt"


def _step_dirs(root: str) -> List[str]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step-(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return [p for _, p in sorted(out)]


def latest_step_dir(root: str) -> Optional[str]:
    dirs = _step_dirs(root)
    return dirs[-1] if dirs else None


class CheckpointManager:
    """``step-N`` directory checkpoints with total-limit rotation."""

    def __init__(self, root: str, total_limit: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.total_limit = total_limit
        os.makedirs(self.root, exist_ok=True)

    def save(self, step: int, state: Dict[str, Any],
             generator_state: Optional[torch.Tensor] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        path = os.path.join(self.root, f"step-{step}")
        os.makedirs(path, exist_ok=True)
        payload = {"state": state, "generator": generator_state, "extra": extra}
        tmp = os.path.join(path, _FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
        self._rotate()
        return path

    def _rotate(self) -> None:
        if self.total_limit is None:
            return
        dirs = _step_dirs(self.root)
        while len(dirs) > self.total_limit:
            shutil.rmtree(dirs.pop(0), ignore_errors=True)

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Dict[str, Any], Optional[torch.Tensor], int]:
        """``(state, generator_state, step)`` of the given or the latest step."""
        if step is None:
            path = latest_step_dir(self.root)
            if path is None:
                raise FileNotFoundError(f"no step-* checkpoints in {self.root}")
            step = int(path.rsplit("-", 1)[1])
        else:
            path = os.path.join(self.root, f"step-{step}")
        payload = torch.load(os.path.join(path, _FILE), map_location="cpu",
                             weights_only=False)
        return payload["state"], payload["generator"], step


def export_weights(path: str, params: Dict[str, torch.Tensor], writer: bool = True) -> None:
    """Serving artifact: parameters only (no optimizer state), whole under
    their single-process names. Sharded parameters are gathered first, a
    collective every rank must call; only the ``writer`` (rank 0) writes."""
    from diffsensei_tpu_torch.parallel.train import full_state

    weights = {k: full_state(v.detach()).cpu() for k, v in params.items()}
    if writer:
        torch.save(weights, os.path.abspath(path))


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
