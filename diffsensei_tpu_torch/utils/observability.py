"""Spans, metrics, step timing and device-memory reporting (port of
``diffsensei_tpu/utils/observability.py``, plus the program's spans).

* ``span(name, **attrs)`` marks a phase of the program. While a
  ``torch.profiler`` session records (``profile_trace``, or any other
  ``torch.profiler.profile``), it enters ``record_function(name)``, so the
  phase lies on the profiler's clock beside the host ops and the device
  operations it launched, and it keeps a ``SpanRecord`` (name, attributes,
  its own and those of the spans open around it on its thread, thread,
  parent span, host start and end) in ``SPANS``. Otherwise it is one
  shared no-op context: no record, no device work. Tracing
  has no switch of its own: it is on exactly while a profiler records.
  A profiler records host ops on the threads torch propagates its state to
  (the caller's, autograd's); ``SPANS`` holds the spans of every thread,
  the loader's producer included.
* ``MetricsLogger`` writes one JSON line per logged step. The JAX package's
  TensorBoard mirror is left out: ``torch.utils.tensorboard`` imports
  TensorFlow where it is installed, and TensorFlow imports JAX.
* ``StepTimer`` splits the steps of each log interval into data wait and
  step time, means over the interval (the reference's tqdm postfix,
  ``train.py:333-335,461-462``, shows them a step).
* ``device_memory_stats`` reads the CUDA caching allocator: in use, peak
  (``torch.cuda.max_memory_allocated``) and the card's total.
* ``profile_trace(dir)`` is the JAX ``jax.profiler`` trace context as a
  ``torch.profiler`` trace (host and, with a card, CUDA activity, the spans
  among them) written to ``dir`` as a Chrome trace JSON.

The spans, by layer (attributes in brackets; a span holds those indented
under it):

* serving, ``serve/api.py`` ``DiffSenseiServer.generate``:
  ``serve.request`` [request: the server's own count, num_samples, height,
  width], the root of a request; under it ``serve.prepare`` (characters'
  preprocessing, bucket snap, the latent draw), the pipeline's spans, and
  ``serve.readback`` (the copy of the panels to the host);
* ``pipelines/pipeline.py``: ``pipeline.conditioning`` (everything before
  the denoise loop), holding ``pipeline.encode_prompt``,
  ``pipeline.ip_embeds`` (character encoders and Resampler) and
  ``pipeline.ip_bias`` (the CFG box arrays and the masked-IP biases);
  ``denoise.step`` [i], holding ``denoise.unet`` and ``denoise.sampler``
  (the CFG combine and the scheduler step); ``pipeline.decode`` [tiled,
  tiles, kernel_convs, fallback_convs: the VAE's 3x3 convolutions that ran
  kernel B9 and those that did not, set as the span closes];
* training, ``train/diffusion.py``: ``train.step`` [step], the root of a
  step, holding ``train.forward`` (in it ``train.encode``, which holds
  ``train.vae_encode`` [kernel_convs, fallback_convs], and
  ``train.unet_forward``), ``train.backward`` (``loss.backward()`` and the
  gradient sync), ``train.optimizer`` (the
  clip and AdamW) and ``train.metrics``; ``train.remat_replay``, the
  recompute of one checkpointed block (``models/remat.py``), runs inside
  the backward on the thread autograd gives it;
* data, ``data/loader.py``: ``data.put`` (a batch pinned and copied to the
  card, on the prefetch producer's thread) and ``data.wait`` (the
  consumer's wait for it).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Deque, Dict, Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class SpanRecord(NamedTuple):
    """A closed span: ``parent`` is the ``id`` of the span open on the same
    thread when it began (None at a root), whose attributes ``attrs``
    holds beside its own (so every span of a request carries the request's
    number); times are the host's ``perf_counter_ns``."""

    name: str
    attrs: Dict[str, Any]
    thread: int
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int


# the spans closed while a profiler recorded, oldest dropped first
SPANS: Deque[SpanRecord] = collections.deque(maxlen=1 << 16)
_NOOP = contextlib.nullcontext()
_ids = itertools.count()
_open = threading.local()


class _Span:
    __slots__ = ("name", "attrs", "_range", "_id", "_parent", "_start")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        stack = _open.__dict__.setdefault("stack", [])
        self._parent = None
        if stack:
            self._parent = stack[-1]._id
            self.attrs = {**stack[-1].attrs, **self.attrs}
        self._id = next(_ids)
        stack.append(self)
        args = " ".join(f"{k}={v}" for k, v in self.attrs.items()) or None
        self._range = _profiler.record_function(self.name, args)
        self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        SPANS.append(SpanRecord(self.name, self.attrs, threading.get_ident(), self._id,
                                self._parent, self._start, end))


def span(name: str, **attrs: Any):
    """``with span(name, **attrs):`` marks a phase (module docstring). With
    no profiler recording it returns the one shared no-op context; the
    attributes reach the profiler as the range's input where it records
    shapes, and ``SPANS`` always."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, attrs)


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
    """Data wait and step time, each a mean over the steps of a log
    interval, on the host clock. ``data_ready`` when a step's batch is in
    hand, ``step_done`` when its step was issued; ``scalars`` at a logged
    point closes the interval that began at the last one (or at the
    timer's start). The caller waits for the step before a logged point,
    as reading the step's metrics does, so each interval covers its steps'
    device time: ``time/step_s`` is the interval's length less the data
    waits, over its steps, and ``time/data_s`` the data waits' mean."""

    def __init__(self):
        self._mark = self._last = time.perf_counter()
        self._data = 0.0
        self._steps = 0

    def data_ready(self) -> None:
        now = time.perf_counter()
        self._data += now - self._last
        self._last = now

    def step_done(self) -> None:
        self._last = time.perf_counter()
        self._steps += 1

    def scalars(self) -> Dict[str, float]:
        n = max(self._steps, 1)
        out = {"time/data_s": self._data / n,
               "time/step_s": (self._last - self._mark - self._data) / n}
        self._mark = self._last
        self._data, self._steps = 0.0, 0
        return out


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
    ``prof`` is the ``torch.profiler.profile`` (``key_averages()``). The
    trace holds the program's spans opened in the block (module docstring),
    as user annotations beside the ops they enclose. With no directory it
    does nothing and yields None."""
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
