"""Shared arithmetic of the per-layer metric readers in ``metrics/``. Each
reader gets ``run``: the cell module's ``layer`` record of a ``--trace 1`` run
(spans, kernel launch shapes, the device trace), the memory peak, the
end-to-end readings and the run's context. A reader that finds nothing to
read returns None."""

from __future__ import annotations

import json
import statistics
from typing import Optional

from benchmark import flops as F
from benchmark import yardstick as Y


def span_mean(run, name: str, per: Optional[str] = None) -> Optional[float]:
    """Mean ms of a span's calls; with ``per='request'`` the sum of the
    traced requests' calls over their count."""
    ms = run["layer"]["spans"].get(name, [])
    if not ms:
        return None
    if per == "request":
        return sum(ms) / run["layer"]["requests"]
    return statistics.fmean(ms)


def idle_pct(run) -> Optional[float]:
    dt = run["layer"]["trace"]
    if not dt.kernels or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)


def peak_gib(run) -> float:
    return run["peak"] / 2 ** 30


def kernel_seconds(run, key: str) -> float:
    return run["layer"]["trace"].time_by(Y.kernel_of).get(key, 0.0)


def roofline(run, keys, cost, launches_key: str) -> Optional[float]:
    """Sum of least times of the recorded launches over the named kernels'
    device time, in %."""
    shapes = run["layer"]["launches"].get(launches_key, [])
    if not shapes:
        return None
    least = [Y.least_s(*cost(*s)) for s in shapes]
    return Y.roofline_pct(least, sum(kernel_seconds(run, k) for k in keys))


def stack_json(run) -> str:
    return json.dumps(run["ctx"].cfg["stack"], sort_keys=True)


def serve_mfu(run) -> Optional[float]:
    """Least time of every request of the window over the window's span."""
    from benchmark.serve import request_spec

    ctx, layer = run["ctx"], run["layer"]
    steps = ctx.cfg["sampler"]["num_inference_steps"]
    total = 0.0
    for i in range(len(layer["latencies"])):
        s = request_spec(ctx.traffic, ctx.seed, i, ctx.cfg["stack"]["text_encoder"]["vocab_size"])
        total += F.least_s(dict(F.request_flops(stack_json(run), steps, s["height"], s["width"],
                                                s["num_samples"], bool(s["characters"]))))
    return 100.0 * total / layer["span"]


def train_mfu(run) -> Optional[float]:
    ctx, layer = run["ctx"], run["layer"]
    size = ctx.traffic["frame_size"]
    per = F.least_s(dict(F.train_step_flops(stack_json(run), layer["batch_rows"], size, size,
                                            ctx.cfg["train_data"]["max_num_ip_sources"])))
    return 100.0 * per * layer["window_steps"] / layer["span"]
