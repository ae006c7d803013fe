"""The readings that the limits of ``correct`` are set from, many seeds in one
process (set-up is long and shared): the program as the configuration
states it, its control (``--variants control``: serving on the program's
weight-only int8 UNet with TF32 on for the VAE; training with bf16
trainables, no fp32 masters), or the program with a planted fault
(``--fault half_batch``). One JSON line a run with the numbers compared
and the end-to-end readings; the benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 8 \
        [--variants program,control] [--fault half_batch]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, variants, seconds: float, fault=None, trace: int = 0):
    """Yield one record a (variant, seed)."""
    import torch

    from benchmark import run as R

    bench = R.load_bench()
    cell, cfg, traffic = R.cell_files(bench, workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for variant in variants:
        for seed in seeds:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = \
                bool(cfg["stack"]["tf32"])
            torch.cuda.reset_peak_memory_stats(device)
            ctx = R.Context(cell, cfg, traffic, seed, seconds, trace, device,
                            time.perf_counter(), variant, fault)
            res = R.execute(ctx, bench)
            yield dict(workload=workload, variant=variant, fault=fault, seed=seed,
                       check=ctx.raw_check,
                       metrics={k: v["value"] for k, v in res["metrics"].items()},
                       attempted=res["attempted"], peak_gib=res["device"]["memory_peak_bytes"] / 2 ** 30,
                       seconds=time.perf_counter() - ctx.t_start)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--variants", default="program")
    parser.add_argument("--seconds", type=float, default=8)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--trace", type=int, default=0)
    args = parser.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(args.workload, seeds, args.variants.split(","), args.seconds,
                        args.fault, args.trace):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
