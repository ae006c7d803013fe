"""The device trace's reduction: read from the profiler's raw events, it
holds what the parsed event list holds; the idle gaps are named as the
loop over every host op names them."""

import random
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import trace as T


def _parsed(prof):
    """The lists as read from ``profile.events()``."""
    kernels, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        row = (e.name, e.time_range.start, e.time_range.end)
        (kernels if e.device_type == torch.autograd.DeviceType.CUDA else host).append(row)
    return kernels, host


def test_raw_events_hold_what_the_parsed_list_holds():
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(50):
            with record_function("outer"):
                y = torch.nn.functional.linear(x, x).softmax(-1)
            y.sum().item()
    kernels, host = T.raw_events(prof.profiler.kineto_results)
    want_kernels, want_host = _parsed(prof)
    assert len(want_host) > 200 and kernels == want_kernels
    assert not any(name == "outer" for name, _, _ in host)
    # the parsed list less the ops it folds into a parent of their own name
    extra = Counter(host) - Counter(want_host)
    assert not Counter(want_host) - Counter(host)
    assert all(any(n == m and s <= a and b <= e for m, s, e in want_host)
               for (n, a, b) in extra)


def _loop_gaps(dt, n):
    """The naming as a loop over every host op."""
    busy = dt.busy_intervals()
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        best, best_len, best_dur = "host", 0.0, float("inf")
        for name, hs, he in dt.host:
            ov = min(e, he) - max(s, hs)
            if ov > best_len or (ov == best_len and ov > 0 and he - hs < best_dur):
                best, best_len, best_dur = name, ov, he - hs
        out.append([best[:120], (e - s) / 1e6])
    return out


@pytest.mark.parametrize("seed", range(5))
def test_idle_gaps_name_as_the_loop_does(seed):
    r = random.Random(seed)
    dt = T.DeviceTrace()
    t = 0.0
    for k in range(300):
        t += r.choice([0.0, 1.0, 2.5, r.random() * 40])
        d = r.choice([1.0, 3.0, r.random() * 9])
        dt.kernels.append((f"k{k % 7}", t, t + d))
        t += d
    for k in range(900):              # nested and equal-length ops, ties of overlap
        s = r.choice([0.0, 1.0, 2.5]) + r.random() * t
        dt.host.append((f"op{k % 13}", s, s + r.choice([1.0, 2.0, 5.0, r.random() * 60])))
    dt.host.sort(key=lambda h: (h[1], -h[2]))
    assert dt.idle_gaps(10) == _loop_gaps(dt, 10)
    dt.host = []
    assert all(name == "host" for name, _ in dt.idle_gaps(10))
