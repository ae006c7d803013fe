"""What a ``--trace 1`` run records and how it is read: CUDA-event spans from
the benchmark's wrappers around calls into the program's layers, the launch
shapes of the hand-written kernels, and a ``torch.profiler`` trace of the
device reduced to busy time, kernel time by name and idle gaps.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sync_all() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    """The allocator's peak on a card; 0 on the CPU."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class _HostEvent:
    """The host clock in a CUDA event's place, where there is no card."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def event():
    if torch.cuda.is_available():
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


class Spans:
    """CUDA events around calls, by name; read after a synchronize."""

    def __init__(self):
        self.events: Dict[str, List[Tuple]] = {}
        self._open = None

    @contextlib.contextmanager
    def span(self, name: str):
        start, end = event(), event()
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.setdefault(name, []).append((start, end))

    def open(self) -> None:
        """Start a span that ``close`` ends (for a pair of module hooks)."""
        self._open = event()
        self._open.record()

    def close(self, name: str) -> None:
        end = event()
        end.record()
        self.events.setdefault(name, []).append((self._open, end))

    def wrap(self, obj, attr: str, name: str) -> Callable[[], None]:
        """Put a span around every call of ``obj.attr``; returns the undo."""
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, wrapped)
        return lambda: setattr(obj, attr, inner)

    def ms(self, name: str) -> List[float]:
        return [s.elapsed_time(e) for s, e in self.events.get(name, [])]


class Launches:
    """The argument shapes of every launch of B1, B2 and B5, recorded by
    wrapping the functions that launch them."""

    HOOKS = (("diffsensei_tpu_torch.ops.flash_attention", "_flash_cuda", "b1"),
             ("diffsensei_tpu_torch.ops.flash_attention", "_bwd_dq_cuda", "b2"),
             ("diffsensei_tpu_torch.ops.dual_cross_attention", "_dual_cuda", "b5"))

    def __init__(self):
        self.shapes: Dict[str, List[Tuple]] = {k: [] for _, _, k in self.HOOKS}
        self._undo: List[Callable[[], None]] = []

    def __enter__(self):
        import importlib

        for mod_name, attr, key in self.HOOKS:
            mod = importlib.import_module(mod_name)
            inner = getattr(mod, attr)

            def wrapped(*args, _inner=inner, _key=key, **kwargs):
                self.shapes[_key].append(_shapes(_key, args))
                return _inner(*args, **kwargs)

            setattr(mod, attr, wrapped)
            self._undo.append(lambda m=mod, a=attr, f=inner: setattr(m, a, f))
        return self

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()


def _shapes(key: str, args) -> Tuple:
    def shape(t):        # a broadcast (stride-0) dimension is stored once
        if not isinstance(t, torch.Tensor):
            return ()
        return tuple(n if st else 1 for n, st in zip(t.shape, t.stride()))
    if key == "b5":              # q, kt, vt, ki, vi, bias
        return shape(args[0]), shape(args[1]), shape(args[3]), shape(args[5])
    return shape(args[0]), shape(args[1]), shape(args[3])   # q, k, v, bias


class DeviceTrace:
    """A profiler window reduced: every device operation as (name, start us,
    end us), the host ops, and the window's length."""

    def __init__(self):
        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.window_s = 0.0
        self.stop_s = self.reduce_s = 0.0    # the profiler's stop, the reduction
        self._prof = None
        self._t = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        sync_all()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync_all()
        t = time.perf_counter()
        self.window_s = t - self._t
        self._prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t
        self.kernels, self.host = raw_events(self._prof.profiler.kineto_results)
        self.reduce_s = time.perf_counter() - t - self.stop_s
        self._prof = None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def time_by(self, pick: Callable[[str], Optional[str]]) -> Dict[str, float]:
        """Device seconds summed by ``pick(name)`` (names it maps to None are
        left out)."""
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            key = pick(name)
            if key is not None:
                out[key] = out.get(key, 0.0) + (e - s) / 1e6
        return out

    def top_ops(self, n: int = 10) -> List[List]:
        by = self.time_by(lambda name: name[:120])
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps with no device operation, each named by the host
        op that overlaps it most (the innermost on ties: the shortest, the
        first of those)."""
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        he = np.array([h[2] for h in self.host], dtype=np.float64)
        out = []
        for s, e in gaps:
            best = "host"
            if len(hs):
                ov = np.minimum(e, he) - np.maximum(s, hs)
                top = ov.max()
                if top > 0:
                    tied = np.flatnonzero(ov == top)
                    best = self.host[tied[np.argmin(he[tied] - hs[tied])]][0]
            out.append([best[:120], (e - s) / 1e6])
        return out


def raw_events(results) -> Tuple[List[Tuple[str, float, float]], List[Tuple[str, float, float]]]:
    """``(kernels, host ops)`` of a profiler's results as ``(name, start us,
    end us)`` from the trace's start, each list in start order (the longer
    first on ties): what its parsed event list (``profile.events()``) holds,
    read from the raw events, which costs a tenth as much (a traced agent
    request holds millions). Left out as there: the profiler's own utility
    ops and hidden events; left out here besides: annotation ranges (the
    optimizer's, ``record_function``'s), which span operations counted on
    their own. Kept here only: a host op that is the one child of an op of
    its own name, which the parsed list folds into its parent; it names an
    idle gap as its parent would."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    base = results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    names: Dict[str, str] = {}
    kernels, host = [], []
    for e in results.events():
        name = e.name()
        if _filter_name(name) or e.is_user_annotation() or \
                getattr(e, "is_hidden_event", lambda: False)():
            continue
        if name not in names:
            names[name] = _rewrite_name(name, with_wildcard=True)
        row = (names[name], (e.start_ns() - base) / 1000, (e.end_ns() - base) / 1000)
        (kernels if e.device_type() == cuda else host).append(row)
    kernels.sort(key=lambda r: (r[1], -r[2]))
    host.sort(key=lambda r: (r[1], -r[2]))
    return kernels, host
