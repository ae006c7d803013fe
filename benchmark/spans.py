"""The program's spans (``diffsensei_tpu_torch/utils/observability.py``), as
the per-layer readers read them.

Host readings come from the program's own record, ``observability.SPANS``:
each closed span with its thread and host start and end, kept while a
profiler records, so in a ``--trace 1`` run exactly the traced requests' or
steps' spans, the loader's producer thread included (the profiler records
no host op there). A program without that record gives nothing to read.

Device readings need the profiler's view of the same spans: each span's
host range (``record_function``) on the profiler's clock, and the thread
and time that launched each device operation. A span's device work is
what it launched while open on the launching thread. (Kineto's device-side
range of a span, ``gpu_user_annotation``, holds only the operations
launched while the span was the innermost annotation: torch's own
``Optimizer.step#AdamW.step`` inside ``train.optimizer`` takes AdamW's.)
``DeviceTrace`` drops these today, so only ``tools/torch_trace_spans.py``,
which keeps them, calls the functions below that take ``annotations``:
tuples ``(name, side, start_us, end_us, thread)`` with side ``"host"`` or
``"device"``. Kernels are ``DeviceTrace.kernels``' ``(name, start_us,
end_us)``; a launch is ``(thread, time_us)`` for each kernel, in the same
order, or None where the profiler linked none.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

# the spans' names all begin so (observability.py lists them)
PREFIXES = ("serve.", "pipeline.", "denoise.", "train.", "data.")
OUTSIDE = "(outside any span)"
# CUDA runtime calls that block the host until the device catches up
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


def program_spans() -> list:
    """The program's closed spans, or [] where it keeps none."""
    from diffsensei_tpu_torch.utils import observability

    return list(getattr(observability, "SPANS", ()))


def host_ms(records, name: str) -> Optional[float]:
    """Mean host ms of the spans named ``name``; None where there are none."""
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in records if r.name == name]
    return statistics.fmean(ms) if ms else None


def merged(intervals) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_us(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def launched_in(kernels, launches, annotations, name: str) -> List[Interval]:
    """The device operations launched while a span ``name`` was open on the
    launching thread (at any depth), as intervals."""
    ranges: Dict[int, List[Interval]] = {}
    for n, side, s, e, th in annotations:
        if side == "host" and n == name:
            ranges.setdefault(th, []).append((s, e))
    ranges = {th: merged(r) for th, r in ranges.items()}
    starts = {th: [s for s, _ in r] for th, r in ranges.items()}
    out = []
    for (_, ks, ke), launch in zip(kernels, launches):
        if launch is None or launch[0] not in ranges:
            continue
        th, t = launch
        i = bisect.bisect_right(starts[th], t) - 1
        if i >= 0 and t <= ranges[th][i][1]:
            out.append((ks, ke))
    return out


def busy_in_ms(kernels, launches, annotations, name: str) -> Optional[float]:
    """Device-busy ms of a span: the union of the device operations it
    launched; None where it launched none."""
    ops = launched_in(kernels, launches, annotations, name)
    if not ops:
        return None
    return sum(e - s for s, e in merged(ops)) / 1e3


def loops(annotations) -> List[Tuple[float, float, int]]:
    """The host range and thread of each denoise loop: from the start of its
    first ``denoise.step`` to the end of its last; a loop ends where another
    of the pipeline's phases begins on its thread."""
    marks = sorted((th, s, e, n) for n, side, s, e, th in annotations if side == "host"
                   and n in ("denoise.step", "pipeline.conditioning", "pipeline.decode"))
    out: List[List] = []
    inside = None
    for th, s, e, n in marks:
        if n != "denoise.step":
            inside = None
        elif inside == th:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, th])
            inside = th
    return [(s, e, th) for s, e, th in out]


def loop_idle_pct(kernels, launches, annotations) -> Optional[float]:
    """Share of the denoise loops' device extent with no device operation:
    a loop's extent runs from the start of the first operation it launched
    to the end of the last."""
    extents = []
    for lo, hi, th in loops(annotations):
        ops = [(ks, ke) for (_, ks, ke), launch in zip(kernels, launches)
               if launch is not None and launch[0] == th and lo <= launch[1] <= hi]
        if ops:
            extents.append((min(s for s, _ in ops), max(e for _, e in ops)))
    length = sum(e - s for s, e in extents)
    if length <= 0:
        return None
    busy = overlap_us(merged((s, e) for _, s, e in kernels), merged(extents))
    return 100.0 * (1.0 - busy / length)


def _host(annotations):
    """Host ranges by thread, and the main thread: the one that opened most
    of the roots (``serve.request``, ``train.step``)."""
    by: Dict[int, List[Tuple[str, float, float]]] = {}
    roots: List[int] = []
    for nm, side, s, e, th in annotations:
        if side == "host":
            by.setdefault(th, []).append((nm, s, e))
            if nm in ("serve.request", "train.step"):
                roots.append(th)
    return by, (max(set(roots), key=roots.count) if roots else None)


def _innermost(ranges, t: float) -> Optional[str]:
    """The innermost of ``ranges`` open at ``t`` (the latest begun)."""
    best = None
    for n, s, e in ranges:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (n, s)
    return None if best is None else best[0]


def where(by, main, thread, t: float) -> str:
    """The span a thread was in at ``t``: its innermost open span; on a
    thread other than ``main`` with none open, the main thread's innermost,
    marked with the thread; else ``OUTSIDE``."""
    name = _innermost(by.get(thread, ()), t)
    if name is not None:
        return name
    if thread != main:
        name = _innermost(by.get(main, ()), t)
        if name is not None:
            return f"{name} [thread {thread}]"
    return OUTSIDE


def idle_by_span(kernels, launches, annotations, syncs=(), window: Optional[Interval] = None,
                 n: int = 10) -> List[list]:
    """The window's device-idle seconds by the span the issuing thread was
    in: each idle stretch belongs to the thread that launched the operation
    ending it, and each instant of it to that thread's innermost open span
    then (``where``). Rows ``[key, idle_s, stretches, syncs]``, the ``n``
    largest: a stretch counts once under each key it touches; ``syncs``
    (``(thread, time_us)``, the synchronising runtime calls) under the span
    open at the call. The stretch before the first operation counts from
    the window's start; the one after the last is ``(after the last device
    op)``."""
    by, main = _host(annotations)
    cuts = {th: sorted(x for _, s, e in r for x in (s, e)) for th, r in by.items()}
    starts: Dict[float, Optional[Tuple]] = {}
    for (_, s, _), launch in zip(kernels, launches):
        if s not in starts or (launch is not None and starts[s] is None):
            starts[s] = launch
    busy = merged((s, e) for _, s, e in kernels)
    if not busy:
        return []
    lo, hi = window if window is not None else (busy[0][0], busy[-1][1])
    stretches = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    out: Dict[str, list] = {}

    def add(key, us, stretch=0, sync=0):
        row = out.setdefault(key, [key, 0.0, 0, 0])
        row[1] += us / 1e6
        row[2] += stretch
        row[3] += sync

    for a, b in stretches:
        if b <= a:
            continue
        launch = starts.get(b)
        if launch is None:
            add(OUTSIDE, b - a, 1)
            continue
        th = launch[0]
        inner = {a, b}
        for t in {th, main}:
            c = cuts.get(t, [])
            inner.update(c[bisect.bisect_right(c, a):bisect.bisect_left(c, b)])
        edges = sorted(inner)
        pieces: Dict[str, float] = {}
        for x, y in zip(edges, edges[1:]):
            key = where(by, main, th, (x + y) / 2)
            pieces[key] = pieces.get(key, 0.0) + (y - x)
        for key, us in pieces.items():
            add(key, us, 1)
    if hi > busy[-1][1]:
        add("(after the last device op)", hi - busy[-1][1], 1)
    for thread, t in syncs:
        add(where(by, main, thread, t), 0.0, 0, 1)
    return sorted(out.values(), key=lambda r: -r[1])[:n]


def longest(kernels, launches, annotations, n: int = 5) -> List[list]:
    """The ``n`` longest idle stretches between device operations: ``[idle_s,
    the main thread's innermost span at the stretch's start, the span of the
    launch that ends it, start_us, end_us]``."""
    by, main = _host(annotations)
    first = {}
    for (_, s, _), launch in zip(kernels, launches):
        if launch is not None:
            first.setdefault(s, launch)
    busy = merged((s, e) for _, s, e in kernels)
    gaps = sorted(((busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  key=lambda g: g[0] - g[1])[:n]
    return [[(b - a) / 1e6, where(by, main, main, a),
             OUTSIDE if b not in first else where(by, main, *first[b]), a, b]
            for a, b in gaps]
