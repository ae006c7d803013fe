#!/usr/bin/env python3
"""Seconds of R1 requests through the PyTorch port's server, on one NVIDIA GPU.

    python3 tools/torch_r1_seconds.py [--root DIR] [--requests N]

R1 is the first request that ``chip_smoke.py`` serves: 1024x1024, 20 Euler
steps with CFG 7.5, two characters and a dialog box, at full SDXL width with
random weights from seed 0 (TF32 off). ``diffsensei_tpu_torch`` is imported
from the checkout at DIR (default: this one), so that two checkouts can be
timed in one call on one card, alternated, one process each. After two
untimed one-step requests (1024x1024, conditioned) it serves R1 N times and
prints one JSON line a request: seconds, B1 and B5 launches, peak memory.
Then the host's cost of one call of B1 and of B5 (microseconds on the host
clock, the median of 5 rounds of 2000 calls at a shape whose kernel is
shorter than its launch, so that the host sets the pace), and the card's
``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--requests", type=int, default=3)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_r1_seconds: no CUDA device", file=sys.stderr)
        return 1
    from PIL import Image
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest

    if not fa.__file__.startswith(str(root)):
        raise AssertionError(f"imported {fa.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    mods = PipelineModules.sdxl(device=device, seed=0)
    server = DiffSenseiServer(DiffSenseiPipeline(mods))
    vocab = mods.text_encoder.config.vocab_size
    rng = np.random.default_rng(3)
    ids = lambda: dict(ids=rng.integers(1, vocab - 1, (1, 77)),
                       neg_ids=rng.integers(1, vocab - 1, (1, 77)),
                       ids_2=rng.integers(1, vocab - 1, (1, 77)),
                       neg_ids_2=rng.integers(1, vocab - 1, (1, 77)))
    chars = [Image.fromarray((rng.random((300, 200, 3)) * 255).astype(np.uint8))
             for _ in range(2)]
    conditioned = dict(character_images=chars,
                       ip_bbox=[[0.05, 0.1, 0.5, 0.95], [0.5, 0.2, 0.95, 0.9]],
                       dialog_bbox=[[0.1, 0.02, 0.6, 0.2]])
    for _ in range(2):
        server.generate(GenerationRequest(height=1024, width=1024, num_inference_steps=1,
                                          prompt_ids=ids(), **conditioned))
    torch.cuda.synchronize()
    for i in range(args.requests):
        req = GenerationRequest(height=1024, width=1024, num_inference_steps=20,
                                guidance_scale=7.5, seed=1, prompt_ids=ids(), **conditioned)
        torch.cuda.reset_peak_memory_stats()
        before = fa.launches, dca.launches
        t0 = time.perf_counter()
        img = server.generate(req)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        print(json.dumps(dict(root=str(root), request=i, seconds=seconds,
                              flash_fwd=fa.launches - before[0], dual=dca.launches - before[1],
                              finite=bool(np.isfinite(img).all()),
                              max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)),
              flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    mk = lambda s: torch.randn((1, 1, s, 64), generator=g, device=device).bfloat16()
    q, kt, vt, ki, vi = mk(64), mk(77), mk(77), mk(80), mk(80)
    bias = torch.zeros((1, 1, 64, 80), device=device)
    calls = {"flash_attention": lambda: fa.flash_attention(q, kt, vt),
             "dual_cross_attention": lambda: dca.dual_cross_attention(q, kt, vt, ki, vi, bias)}
    host_us = {}
    for name, call in calls.items():
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                call()
            rounds.append((time.perf_counter() - t0) / 2000 * 1e6)
        torch.cuda.synchronize()
        host_us[name] = statistics.median(rounds)
    print(json.dumps(dict(root=str(root), host_us_per_call=host_us)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
