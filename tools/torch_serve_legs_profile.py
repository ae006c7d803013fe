#!/usr/bin/env python3
"""Where the time of R1 and of each serving-extras leg goes, on one NVIDIA GPU.

    python3 tools/torch_serve_legs_profile.py [--repeats N]

The legs are ``chip_smoke._legs()`` (DDIM 4 unconditioned, DPM-Solver++ 12,
Euler 20 with DeepCache N = 2 and 3 at split 2, DPM++ 12 with N = 2, Euler 20
on the int8 UNet) beside R1 itself (Euler 20, exact), all on R1's kind of
request: 1024x1024, CFG 7.5, two characters and a dialog box (the DDIM leg
without them), full SDXL width, random weights from seed 0, TF32 off. Each
leg is warmed with one 2-step request, then served ``--repeats`` times
(seconds on the host clock, synchronized), then once more under
``torch.profiler``: device time (kernel time summed), kernels launched, the
device's busy share of that request's wall time, and the five kernels that
take the most time. One JSON line a leg, then the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_legs_profile: no CUDA device", file=sys.stderr)
        return 1
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.models.quant_unet import quantize_unet
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    mods = PipelineModules.sdxl(device=device, seed=0)
    int8_unet = quantize_unet(mods.unet)
    vocab = mods.text_encoder.config.vocab_size
    rng = np.random.default_rng(3)
    ids = {k: rng.integers(1, vocab - 1, (1, 77)) for k in ("ids", "neg_ids", "ids_2",
                                                            "neg_ids_2")}
    chars = [Image.fromarray((rng.random((300, 200, 3)) * 255).astype(np.uint8))
             for _ in range(2)]
    base = GenerationRequest(height=1024, width=1024, num_inference_steps=20,
                             guidance_scale=7.5, seed=1, prompt_ids=ids, character_images=chars,
                             ip_bbox=[[0.05, 0.1, 0.5, 0.95], [0.5, 0.2, 0.95, 0.9]],
                             dialog_bbox=[[0.1, 0.02, 0.6, 0.2]])
    legs = [("euler_20_exact", "euler_discrete", 20, None, True, False)]
    legs += [leg[:6] for leg in chip_smoke._legs()]
    for name, scheduler, steps, interval, conditioned, int8 in legs:
        m = dataclasses.replace(mods, unet=int8_unet) if int8 else mods
        server = DiffSenseiServer(DiffSenseiPipeline(m, PipelineConfig(scheduler=scheduler)))
        req = base if conditioned else dataclasses.replace(
            base, character_images=(), ip_bbox=(), dialog_bbox=())
        req = dataclasses.replace(req, num_inference_steps=steps,
                                  deep_cache_interval=interval)
        server.generate(dataclasses.replace(req, num_inference_steps=2))
        seconds = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.generate(req)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.generate(req)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        device_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        print(json.dumps(dict(
            leg=name, seconds=seconds, profiled_wall_s=wall, device_s=device_us / 1e6,
            device_busy_share=device_us / 1e6 / wall,
            kernels=sum(e.count for e in kernels),
            top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3, count=e.count)
                 for e in top])), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
