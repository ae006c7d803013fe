#!/usr/bin/env python3
"""Kernel B3 (GroupNorm + SiLU) at every shape of ``chip_smoke.GN_CASES``.

    python3 tools/torch_groupnorm_probe.py [--root DIR] [--variants]

Imports ``diffsensei_tpu_torch`` from the checkout at DIR (default: this
one), so a parent commit unpacked with ``git archive`` into a git-ignored
directory can be timed beside this checkout in the same call, process by
process. One JSON line a shape: its time cold (``chip_smoke.cold_calls``:
distinct copies, more bytes than the L2 holds) and warm, its bound, and
whether it agrees with the plain twin (bf16 allclose 1e-2, fp32 within 1e-4).
The row is ``chip_smoke.gn_row``'s, the smoke run's own comparison. With
``--variants`` (a checkout with ``groupnorm.plan``) also the plans the plan
did not pick at the shapes in ``VARIANT_SHAPES``: the other vector widths of
its route, and the streaming route where it picked the resident one, each
swapped in for ``plan`` in this process and held to the same comparison.
The last line is ``{"ok": true, ...}``. Needs a CUDA device; imports torch
only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# shapes where the plan's choice between the routes or the vector widths is
# close: resident near the grid's capacity against streaming
VARIANT_SHAPES = [
    ((2, 128, 128, 320), "bfloat16", 1e-5),
    ((1, 128, 128, 320), "bfloat16", 1e-5),
    ((2, 64, 64, 1280), "bfloat16", 1e-5),
    ((2, 32, 32, 1280), "bfloat16", 1e-5),
    ((1, 96, 96, 512), "float32", 1e-6),
    ((1, 1024, 1024, 128), "float32", 1e-6),
]


def other_plans(gn, shape, dtype) -> list:
    """The plans ``gn.plan`` did not pick at ``shape``: its route at the
    other vector widths the kernel takes there, and, where it picked the
    resident route, the streaming one as the plan makes it for larger x
    (whole rows, one slab a block on every SM)."""
    import dataclasses

    sms = gn._sms(0)
    p = gn.plan(shape, dtype, 32, sms)
    b, h, w, c = shape
    width = p.groups_per_strip * c // 32 * dtype.itemsize
    out = [dataclasses.replace(p, vec=v) for v in (16, 8, 4)
           if v != p.vec and width % v == 0 and width // v <= gn.THREADS]
    if p.route == "resident":
        slabs = min(h * w, sms // b)
        out.append(dataclasses.replace(
            p, route="streaming", slabs=slabs, rows_per_block=-(-h * w // slabs),
            smem_bytes=0, blocks=b * slabs, kernels=2, workspace_floats=b * slabs * 32 * 4))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs           # this checkout's cases and timers
    import torch

    if not torch.cuda.is_available():
        print("torch_groupnorm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path[0] = str(Path(args.root).resolve())
    from diffsensei_tpu_torch.ops import groupnorm as gn
    if not gn.__file__.startswith(str(Path(args.root).resolve())):
        raise AssertionError(f"imported {gn.__file__}, not from {args.root}")
    device = torch.device("cuda", 0)
    cs.emit({"probe": "groupnorm", "root": args.root, "nvidia_smi": cs.nvidia_smi_line()})
    gn.build()
    log = Path(gn._build.BUILD_DIR).glob("groupnorm_silu-*.log")
    cs.emit({"ptxas": [ln.strip() for f in log for ln in f.read_text().splitlines()
                       if "registers" in ln or "spill" in ln or "smem" in ln]})

    gen = torch.Generator(device=device).manual_seed(1)
    bad = []

    def measure(shape, dtype_name, eps, **extra):
        try:
            row = cs.gn_row(gn, shape, dtype_name, eps, gen, device)
        except AssertionError as e:
            row = dict(shape=list(shape), dtype=dtype_name, error=str(e)[:2000])
            bad.append(row)
        cs.emit({**extra, **row})

    for shape, dtype_name, eps, r1, t1 in cs.GN_CASES:
        measure(shape, dtype_name, eps, case="plan", calls_r1=r1, calls_t1=t1)
    if args.variants:
        picked = gn.plan
        for shape, dtype_name, eps in VARIANT_SHAPES:
            for forced in other_plans(gn, shape, getattr(torch, dtype_name)):
                gn.plan = lambda *_, forced=forced: forced
                try:
                    measure(shape, dtype_name, eps, case="variant")
                finally:
                    gn.plan = picked
    cs.emit({"ok": not bad, "bad": bad})
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
