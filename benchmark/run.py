"""The benchmark of ``diffsensei_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``benchmark/configs/<config>.json``, its traffic in
``benchmark/traffic/<traffic>.json`` (whose ``kind``, ``serve`` or
``train``, picks the module that runs it, ``benchmark/<kind>.py``), and each
per-layer metric's reader in ``benchmark/metrics/<metric>.py``. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``check``: every number compared with its limit, which also close standard
error. Without a card, or with fewer than the cell asks for, it exits 2 and
prints no result; it exits 3 if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffsensei_tpu")


class Context:
    """What a cell's module needs: the cell's files, the run's arguments, the
    device, and the switches that calibration and tests turn (``variant``
    ``control`` runs the program's own lower-precision path; ``fault``
    plants a fault)."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device, t_start,
                 variant="program", fault=None):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t_start = device, t_start
        self.variant, self.fault = variant, fault
        self.setup_s = None

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str, here: Path = HERE):
    """(cell, configuration, traffic) of a cell name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg = json.loads((here / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, here: Path = HERE):
    """The ``read(run)`` of ``benchmark/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def check_lines(check: dict, limits: dict) -> dict:
    return {k: {"value": check[k], "limit": limits[k]} for k in limits}


def execute(ctx: Context, bench: dict) -> dict:
    """Run the cell's module; return the result object (without printing)."""
    import torch

    module = importlib.import_module(f"benchmark.{ctx.traffic['kind']}")
    out = module.run(ctx)
    ctx.raw_check = out["check"]
    limits = ctx.traffic["limits"]
    check = check_lines(out["check"], limits)
    correct = all(v["value"] <= v["limit"] for v in check.values())
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    wanted = cell_metrics(bench, ctx.cell, ctx.trace)
    metrics = {}
    if not ctx.trace:
        for m in wanted:
            value, unit = out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": unit}
    else:
        run = dict(ctx=ctx, layer=out["layer"], peak=out["peak"], e2e=out["e2e"])
        for m in wanted:
            value = reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dt = out["layer"]["trace"]
        device.update(busy_s=dt.busy_s(), window_s=dt.window_s)
        result["breakdown"] = {"device_ops": dt.top_ops(10), "idle_gaps": dt.idle_gaps(10)}
    result["metrics"] = metrics
    result["device"] = device
    result["check"] = check
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = load_bench()
    cell, cfg, traffic = cell_files(bench, args.workload)
    # the port's kernels build into the checkout's build/kernels; any other
    # compile cache the stack may use stays in the checkout too
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    tf32 = bool(cfg["stack"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell, cfg, traffic, args.seed, args.seconds, args.trace, device, T_START)
    result = execute(ctx, bench)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
