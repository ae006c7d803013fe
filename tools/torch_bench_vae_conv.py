#!/usr/bin/env python3
"""Kernel B9 (the VAE's fp32 3x3 convolutions) beside cuDNN on one NVIDIA GPU.

    python3 tools/torch_bench_vae_conv.py [--check] [--batch N] [--rows SUBSTR]

Run from the root of the repository. The rows are every distinct 3x3
convolution the VAE runs through ``ops/vae_conv.py`` in the benchmark's two
cells, found by running the VAE on the meta device (``vae_conv_rows``): the
encoder at 1024x1024 (stage-2 training) and the decoder from a 128x128
latent (serving), each at batch ``--batch`` (default 1). One JSON line a row:

* ``kernel_ms``: B9's time (with its GroupNorm statistics launches where the
  row has GroupNorm+SiLU first), and ``kernel_tflops``, the fp32 products a
  second (2 B Ho Wo Cout 9 Cin);
* ``cudnn_ms``: ``F.conv2d`` alone on the same (normalised) input in fp32
  with TF32 off, and ``composition_ms``: what the VAE ran before B9, B3 (where
  the row has GroupNorm), the upsample (where it has one), ``F.conv2d`` and
  the residual add;
* ``fused_mb`` and ``unfused_mb``: the device-memory traffic of the two
  paths, each input and output byte counted once a pass;
* the errors of B9 and of cuDNN against an fp64 convolution of the same fp32
  inputs (GroupNorm+SiLU in fp64 where the row has it): RMS and largest
  absolute error, each over the reference's RMS; ``ok`` where B9's RMS is
  no larger than cuDNN's and its largest error at most twice cuDNN's;
* ``bound_ms``: B9's least time, at the split-TF32 ceiling (165 TFLOP/s) or
  the memory rate (``timings``).

``--check`` takes the errors alone, at batch 1 and a 64 x 96 crop of each
row (seconds), for a first run of a new build. Times are medians of
CUDA-event passes (``chip_smoke.cuda_ms``). Then the card's ``nvidia-smi``
line and ``{"ok": true}`` (``{"ok": false}`` and exit code 1 where a check
fails). It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ENCODE = dict(batch=8, size=1024)       # train_stage2_1024_b8
DECODE = dict(batch=4, latent=128)      # serve_candidates_1024x4


def vae_conv_rows(enc_batch: int = 8, size: int = 1024, dec_batch: int = 4,
                  latent: int = 128) -> list:
    """Every distinct call of ``vae_conv.vae_conv3x3`` the SDXL VAE makes
    encoding ``enc_batch`` images of ``size``² and decoding ``dec_batch``
    latents of ``latent``², in order of first use: dicts of ``name``
    (encode/decode), ``shape`` (x's NHWC shape), ``cout``, ``mode``, ``gn``
    (GroupNorm+SiLU first) and ``res`` (a residual), and ``count`` (calls
    of that kind a pass). Runs on the meta device: no memory, no card."""
    import torch
    from diffsensei_tpu_torch.core.config import VAEConfig
    from diffsensei_tpu_torch.models.vae import AutoencoderKL
    from diffsensei_tpu_torch.ops import vae_conv

    rows, real = {}, vae_conv.vae_conv3x3
    where = ["encode"]

    def record(x, weight, bias, mode=vae_conv.STRIDE1, norm=None, residual=None, split=None):
        key = (where[0], tuple(x.shape), int(weight.shape[0]), mode, norm is not None,
               residual is not None)
        rows.setdefault(key, 0)
        rows[key] += 1
        ho, wo = vae_conv.out_hw(x.shape[1], x.shape[2], mode)
        return torch.empty((x.shape[0], ho, wo, weight.shape[0]), device="meta")

    vae_conv.vae_conv3x3 = record
    try:
        with torch.device("meta"):
            vae = AutoencoderKL(VAEConfig.sdxl())
            vae.encode(torch.empty(enc_batch, size, size, 3))
            where[0] = "decode"
            vae.decode(torch.empty(dec_batch, latent, latent, 4))
    finally:
        vae_conv.vae_conv3x3 = real
    return [dict(name=k[0], shape=k[1], cout=k[2], mode=k[3], gn=k[4], res=k[5], count=n)
            for k, n in rows.items()]


def make_case(row: dict, batch: int, device, seed: int = 0, crop=None) -> dict:
    """Seeded inputs for one row at ``batch`` (and an optional (h, w) crop):
    x, weight, bias, residual, and a GroupNorm module with random scale and
    shift (so that the padding's activation, silu(beta - mean rstd gamma),
    is not 0)."""
    import torch
    from diffsensei_tpu_torch.models.layers import FusedGroupNormSiLU
    from diffsensei_tpu_torch.ops import vae_conv

    _, h, w, cin = row["shape"]
    if crop is not None:
        h, w = min(h, crop[0]), min(w, crop[1])
    cout, mode = row["cout"], row["mode"]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, h, w, cin), generator=g, device=device) * 1.5 + 0.3
    weight = torch.randn((cout, cin, 3, 3), generator=g, device=device) * (9 * cin) ** -0.5
    bias = torch.randn((cout,), generator=g, device=device) * 0.1
    norm = None
    if row["gn"]:
        norm = FusedGroupNormSiLU(32, cin, 1e-6, device=device)
        with torch.no_grad():
            norm.weight.copy_(torch.rand((cin,), generator=g, device=device) + 0.5)
            norm.bias.copy_(torch.randn((cin,), generator=g, device=device))
        norm.requires_grad_(False)
    ho, wo = vae_conv.out_hw(h, w, mode)
    res = (torch.randn((batch, ho, wo, cout), generator=g, device=device) if row["res"]
           else None)
    return dict(x=x, weight=weight, bias=bias, norm=norm, res=res, mode=mode)


def reference64(case: dict):
    """The row's function in fp64 from the same fp32 inputs."""
    import torch
    from diffsensei_tpu_torch.ops import vae_conv

    x = case["x"].double()
    norm = case["norm"]
    if norm is not None:
        b, h, w, c = x.shape
        xg = x.reshape(b, h * w, 32, c // 32)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        x = ((xg - mean) / torch.sqrt(var + norm.eps)).reshape(b, h, w, c)
        x = torch.nn.functional.silu(x * norm.weight.double() + norm.bias.double())
    res = None if case["res"] is None else case["res"].double()
    return vae_conv._conv_tail(x, case["weight"].double(), case["bias"].double(), case["mode"],
                               res)


def kernel_call(case: dict):
    from diffsensei_tpu_torch.ops import vae_conv

    halves = vae_conv.split_weight(case["weight"])
    return lambda: vae_conv.vae_conv3x3(case["x"], case["weight"], case["bias"], case["mode"],
                                        case["norm"], case["res"], lambda: halves)


def composition_call(case: dict):
    """What the VAE ran before B9: B3, the upsample, cuDNN, the residual add."""
    from diffsensei_tpu_torch.ops import vae_conv

    def run():
        h = case["x"] if case["norm"] is None else case["norm"](case["x"])
        return vae_conv._conv_tail(h, case["weight"], case["bias"], case["mode"], case["res"])
    return run


def errors(case: dict, samples=None) -> dict:
    """RMS and largest error of B9 and of the composition (cuDNN fp32) against
    fp64, over the reference's RMS; both run on the whole batch, compared on
    the ``samples`` listed (all by default), each sample's statistics its own."""
    import torch

    with torch.no_grad():
        sub = case if samples is None else dict(
            case, x=case["x"][samples], res=None if case["res"] is None else case["res"][samples])
        want = reference64(sub)
        scale = want.square().mean().sqrt().item()
        out = {}
        for name, fn in (("kernel", kernel_call(case)), ("cudnn", composition_call(case))):
            got = fn()
            d = (got if samples is None else got[samples]).double() - want
            del got
            out[f"{name}_rms"] = d.square().mean().sqrt().item() / scale
            out[f"{name}_max"] = d.abs().max().item() / scale
    out["ok"] = bool(out["kernel_rms"] <= out["cudnn_rms"]
                     and out["kernel_max"] <= 2 * out["cudnn_max"])
    return out


def traffic_mb(row: dict, batch: int) -> tuple:
    """(fused, unfused) device-memory traffic in MB, each byte once a pass."""
    from diffsensei_tpu_torch.ops import vae_conv

    _, h, w, cin = row["shape"]
    ho, wo = vae_conv.out_hw(h, w, row["mode"])
    x, y = 4 * batch * h * w * cin, 4 * batch * ho * wo * row["cout"]
    fused = x * (2 if row["gn"] else 1) + y * (2 if row["res"] else 1)
    unfused = x + y
    if row["gn"]:
        unfused += 3 * x            # B3: read x, write x'; the conv reads x'
    if row["mode"] == vae_conv.UPSAMPLE:
        unfused += 2 * 4 * x        # write the upsampled tensor, read it back
    if row["res"]:
        unfused += 3 * y            # the add: read y and the residual, write
    return fused / 1e6, unfused / 1e6


SPLIT_TF32_FLOPS = 165e12   # three TF32 products a fp32 one: 495 / 3 TFLOP/s
HBM_BYTES_PER_S = 3.35e12


def timings(case: dict, row: dict) -> dict:
    """The row's times in ms (medians of ``chip_smoke.cuda_ms``): B9
    (``kernel_ms``), cuDNN's ``F.conv2d`` alone on the normalised (and
    upsampled) input (``cudnn_ms``), the composition the VAE ran before B9
    (``composition_ms``); the fp32 products a second of each; the traffic
    (``traffic_mb``); and B9's least time ``bound_ms``, the larger of its
    fused traffic over 3.35 TB/s and its products at the split-TF32 ceiling
    (165 TFLOP/s), with ``bound_by``."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from diffsensei_tpu_torch.ops import vae_conv

    b, h, w, cin = case["x"].shape
    ho, wo = vae_conv.out_hw(h, w, row["mode"])
    flops = 2 * b * ho * wo * row["cout"] * 9 * cin
    out = {}
    with torch.no_grad():
        xin = case["x"] if case["norm"] is None else case["norm"](case["x"])
        if row["mode"] == vae_conv.UPSAMPLE:
            xin = vae_conv.upsample2x(xin)
        xin = xin.permute(0, 3, 1, 2)
        stride = 2 if row["mode"] == vae_conv.STRIDE2 else 1
        out["kernel_ms"] = cs.cuda_ms(kernel_call(case))
        out["cudnn_ms"] = cs.cuda_ms(lambda: F.conv2d(
            xin, case["weight"], case["bias"], stride=stride, padding=1))
        del xin
        out["composition_ms"] = cs.cuda_ms(composition_call(case))
    out["kernel_tflops"] = flops / out["kernel_ms"] / 1e9
    out["cudnn_tflops"] = flops / out["cudnn_ms"] / 1e9
    out["fused_mb"], out["unfused_mb"] = traffic_mb(row, b)
    by_bytes = out["fused_mb"] * 1e6 / HBM_BYTES_PER_S * 1e3
    by_ops = flops / SPLIT_TF32_FLOPS * 1e3
    out["bound_ms"] = max(by_bytes, by_ops)
    out["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return out


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from diffsensei_tpu_torch.ops import vae_conv

    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--rows", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_vae_conv: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ok = True
    for row in vae_conv_rows():
        label = (f"{row['name']} {row['shape'][1]}x{row['shape'][2]} {row['shape'][3]}->"
                 f"{row['cout']} {vae_conv.MODE_NAMES[row['mode']]}"
                 f"{' gn' if row['gn'] else ''}{' res' if row['res'] else ''}")
        if args.rows not in label:
            continue
        out = dict(row=label, count=row["count"])
        case = make_case(row, 1 if args.check else args.batch, device,
                         crop=(64, 96) if args.check else None)
        out.update(errors(case))
        ok &= out["ok"]
        if not args.check:
            out.update(timings(case, row))
        print(json.dumps(out), flush=True)
        del case
        torch.cuda.empty_cache()
    print(json.dumps(dict(gpu=cs.nvidia_smi_line(), launches=vae_conv.launches)))
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
