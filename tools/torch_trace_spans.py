#!/usr/bin/env python3
"""A benchmark cell's traced run, read through the program's spans, on one
NVIDIA GPU.

    python3 tools/torch_trace_spans.py --workload <cell> --seed <n> [--seconds 10] [--spans 0|1|2]
        [--out DIR]

Runs ``benchmark/run.py``'s ``--trace 1`` path for the cell, with the
profiler's view of the program's spans kept where ``DeviceTrace`` drops it:
each span's host range, the thread and time that launched each device
operation, and the synchronising CUDA runtime calls.
Prints one JSON line: the run's own result (``result``), and ``spans``:

* the six span metrics: ``host_enqueue_ms.serve``, ``prepare_ms.serve``,
  ``data_put_ms.train`` (as the benchmark's readers read them),
  ``loop_idle_pct.serve`` and the device-busy ms a step of what
  ``train.optimizer`` (``optimizer_ms.train``) and the
  ``train.remat_replay`` spans (``remat_replay_ms.train``) launched
  (``benchmark/spans.py``);
* ``idle_by_span``: the traced window's device-idle seconds by the span
  that launched the operation ending each idle stretch, with the stretches
  and the synchronising calls in each span, the ten largest;
* ``longest_gaps``: the five longest of those stretches, each with the
  main thread's span at its start, the span of the launch ending it, its
  bounds, and the host ops and runtime calls of a millisecond or more that
  cover half of it or more;
* ``traced_s``: the traced window's seconds over its requests or steps;
* ``span_off_ns``: host ns of one ``with span(...)`` with no profiler
  recording, less an empty ``with`` of the shared no-op.

``--spans 0`` makes every span of the program the no-op in the traced
window (the cost of the spans while the profiler records is ``traced_s``
against ``--spans 1`` on the same seed); ``--spans 2`` runs the window
without the profiler and records every span on the host clock (the host
readings free of the profiler's own cost).

The line is also written to ``DIR/spans_<cell>_<seed>_<spans>.json``
(default ``build/spans``), and what the span readings are computed from (device operations' bounds,
launches, annotations, synchronising and slow host calls) beside it as
``.raw.json``, so that they can be read again without the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def span_off_ns(rounds: int = 5, n: int = 200_000) -> float:
    """Median over ``rounds`` of the host ns a disabled ``with span()``
    costs beyond a ``with`` of the no-op itself."""
    import statistics

    from diffsensei_tpu_torch.utils import observability as O

    noop = O._NOOP
    costs = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for i in range(n):
            with O.span("denoise.step", i=i):
                pass
        t1 = time.perf_counter_ns()
        for i in range(n):
            with noop:
                pass
        t2 = time.perf_counter_ns()
        costs.append(((t1 - t0) - (t2 - t1)) / n)
    return statistics.median(costs)


def point_spans(to) -> dict:
    """Point every loaded module's ``span`` at ``to``; returns the undo map."""
    from diffsensei_tpu_torch.utils import observability as O

    undo = {}
    for name, mod in list(sys.modules.items()):
        if (name.startswith("diffsensei_tpu_torch") and mod is not O
                and getattr(mod, "span", None) is O.span):
            undo[mod] = mod.span
            mod.span = to
    return undo


def make_trace(T, mode: int, kept: list):
    """The trace class of ``--spans mode``."""
    from diffsensei_tpu_torch.utils import observability as O

    if mode == 2:
        class HostWindow(T.DeviceTrace):
            """The traced window with no profiler: every span recorded."""

            def __enter__(self):
                self.undo = point_spans(lambda name, **attrs: O._Span(name, attrs))
                T.sync_all()
                self._t = time.perf_counter()
                return self

            def __exit__(self, *exc):
                T.sync_all()
                self.window_s = time.perf_counter() - self._t
                for mod, fn in self.undo.items():
                    mod.span = fn
                self.annotations, self.launches, self.syncs, self.slow = [], [], [], []
                self.kernels_seen, self.linked, self.host_threads = [], 0, []
                self.window_us = (0.0, self.window_s * 1e6)
                kept.append(self)

        return HostWindow
    return _profiled(T, mode == 1, kept)


def _profiled(T, spans_on: bool, kept: list):
    from benchmark import spans as S
    from diffsensei_tpu_torch.utils import observability as O

    class SpanTrace(T.DeviceTrace):
        """``DeviceTrace`` that also keeps the spans, launches and syncs."""

        def __enter__(self):
            self.undo = {} if spans_on else point_spans(lambda name, **attrs: O._NOOP)
            return super().__enter__()

        def __exit__(self, *exc):
            prof = self._prof
            super().__exit__(*exc)
            for mod, fn in self.undo.items():
                mod.span = fn
            res = prof.profiler.kineto_results
            t0 = res.trace_start_ns()
            import torch

            cuda = torch.autograd.DeviceType.CUDA
            ops, runtime, device = {}, {}, []
            self.annotations, self.slow, syncs = [], [], []
            for k in res.events():
                s, e = (k.start_ns() - t0) / 1e3, (k.end_ns() - t0) / 1e3
                name = k.name()
                if k.is_user_annotation():
                    if name.startswith(S.PREFIXES):
                        side = "device" if k.device_type() == cuda else "host"
                        self.annotations.append((name, side, s, e, k.start_thread_id()))
                    continue
                if k.device_type() == cuda:
                    device.append((name, s, e, k.correlation_id(), k.linked_correlation_id()))
                    continue
                if e - s >= 1e3:        # host calls of a millisecond or more
                    self.slow.append((name, k.start_thread_id(), s, e))
                if name.startswith("cu"):
                    runtime[k.correlation_id()] = (k.start_thread_id(), s,
                                                   k.linked_correlation_id())
                    if name in S.SYNCS:
                        syncs.append(k.correlation_id())
                elif k.correlation_id():
                    ops[k.correlation_id()] = (k.start_thread_id(), s)
            # a runtime call's thread is the system's; an op's is torch's own:
            # pair them where a runtime call is linked to an op
            tids = {}
            for tid, _, linked in runtime.values():
                if linked in ops:
                    tids.setdefault(tid, ops[linked][0])
            self.kernels_seen = [(n, s, e) for n, s, e, _, _ in device]
            self.launches, self.linked = [], 0
            for _, _, _, corr, linked in device:
                if linked in ops:
                    self.launches.append(ops[linked])
                    self.linked += 1
                elif corr in runtime and runtime[corr][0] in tids:
                    self.launches.append((tids[runtime[corr][0]], runtime[corr][1]))
                    self.linked += 1
                else:
                    self.launches.append(None)
            self.syncs = [(tids.get(runtime[c][0]), runtime[c][1]) for c in syncs]
            self.host_threads = sorted({t for t, _ in ops.values()})
            self.window_us = (0.0, self.window_s * 1e6)
            kept.append(self)

    return SpanTrace


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--spans", type=int, choices=(0, 1, 2), default=1)
    parser.add_argument("--out", default=str(ROOT / "build" / "spans"))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    t_start = time.perf_counter()
    import torch

    from benchmark import run as R
    from benchmark import spans as S
    from benchmark import trace as T

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    off_ns = span_off_ns()
    bench = R.load_bench(ROOT)
    cell, cfg, traffic = R.cell_files(bench, args.workload, ROOT / "benchmark")
    tf32 = bool(cfg["stack"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kept: list = []
    T.DeviceTrace = make_trace(T, args.spans, kept)
    ctx = R.Context(cell, cfg, traffic, args.seed, args.seconds, 1, device, t_start)
    result = R.execute(ctx, bench)
    dt = kept[-1]
    records = S.program_spans()
    ann, kernels = dt.annotations, dt.kernels_seen
    units = traffic["trace_requests"] if traffic["kind"] == "serve" else traffic["trace_steps"]
    per = lambda v: None if v is None else v / units
    out = {
        "host_enqueue_ms.serve": S.host_ms(records, "denoise.step"),
        "prepare_ms.serve": S.host_ms(records, "serve.prepare"),
        "data_put_ms.train": S.host_ms(records, "data.put"),
        "loop_idle_pct.serve": S.loop_idle_pct(kernels, dt.launches, ann),
        "optimizer_ms.train": per(S.busy_in_ms(kernels, dt.launches, ann, "train.optimizer")),
        "remat_replay_ms.train": per(S.busy_in_ms(kernels, dt.launches, ann,
                                                  "train.remat_replay")),
        "idle_by_span": S.idle_by_span(kernels, dt.launches, ann, dt.syncs, dt.window_us),
        "longest_gaps": [g + [sorted({f"{n} (thread {th})" for n, th, s, e in dt.slow
                                      if min(e, g[4]) - max(s, g[3]) >= 0.5 * (g[4] - g[3])})]
                         for g in S.longest(kernels, dt.launches, ann)],
        "traced_s": dt.window_s / units,
        "units": units,
        "spans": args.spans,
        "modules_patched": len(dt.undo),
        "span_off_ns": off_ns,
        "annotations": {side: sum(1 for a in ann if a[1] == side) for side in ("host", "device")},
        "records": len(records),
        "device_ops": len(kernels),
        "device_ops_in_trace": len(dt.kernels),
        "launches_linked": dt.linked,
        "host_threads": dt.host_threads,
        "syncs": len(dt.syncs),
        "busy_s": dt.busy_s(),
        "window_s": dt.window_s,
    }
    line = json.dumps({"cell": args.workload, "seed": args.seed, "result": result, "spans": out})
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"spans_{args.workload}_{args.seed}_{args.spans}.json").write_text(line + "\n")
    raw = {"kernels": [(s, e) for _, s, e in kernels], "launches": dt.launches,
           "annotations": ann, "syncs": dt.syncs, "slow": dt.slow, "window_us": dt.window_us}
    (out_dir / f"spans_{args.workload}_{args.seed}_{args.spans}.raw.json").write_text(
        json.dumps(raw))
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
