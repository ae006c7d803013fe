"""Metrics, step timing and device-memory reporting (port of
``diffsensei_tpu/utils/observability.py``).

* ``MetricsLogger`` writes one JSON line per logged step. The JAX package's
  TensorBoard mirror is left out: ``torch.utils.tensorboard`` imports
  TensorFlow where it is installed, and TensorFlow imports JAX.
* ``StepTimer`` splits each step into data wait and step time, like the
  reference's tqdm postfix (``train.py:333-335,461-462``).
* ``device_memory_stats`` reads the CUDA caching allocator: in use, peak
  (``torch.cuda.max_memory_allocated``) and the card's total.
* ``profile_trace(dir)`` is the JAX ``jax.profiler`` trace context as a
  ``torch.profiler`` trace (host and, with a card, CUDA activity) written
  to ``dir`` as a Chrome trace JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


class MetricsLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._file = open(self.path, "a", buffering=1)

    def log(self, step: int, scalars: Dict[str, Any]) -> None:
        record = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        self._file.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._file.close()


class StepTimer:
    """Data wait vs step time, on the host clock."""

    def __init__(self):
        self._last = time.perf_counter()
        self.data_s = 0.0
        self.step_s = 0.0

    def data_ready(self) -> None:
        now = time.perf_counter()
        self.data_s = now - self._last
        self._last = now

    def step_done(self) -> None:
        now = time.perf_counter()
        self.step_s = now - self._last
        self._last = now

    def scalars(self) -> Dict[str, float]:
        return {"time/data_s": self.data_s, "time/step_s": self.step_s}


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """GiB in use, peak since the last ``reset_peak_memory_stats`` and the
    card's total; empty off the card."""
    if device is None or torch.device(device).type != "cuda":
        return {}
    gib = 1024 ** 3
    return {"mem/in_use_gib": torch.cuda.memory_allocated(device) / gib,
            "mem/peak_gib": torch.cuda.max_memory_allocated(device) / gib,
            "mem/limit_gib": torch.cuda.get_device_properties(device).total_memory / gib}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[Optional[Any]]:
    """``with profile_trace(dir) as prof:`` profiles the block and writes
    ``dir/trace_<pid>.json`` (``chrome://tracing``, Perfetto) when it ends;
    ``prof`` is the ``torch.profiler.profile`` (``key_averages()``). With
    no directory it does nothing and yields None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
