#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of the repository. Phases, one JSON line each:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: kernels B1 (CUDA C++, nvcc) and B3 (Triton) from ``diffsensei_tpu_torch/csrc``;
3. flash_attention: B1 against its plain twin at the UNet's shapes, with times
   beside the plain twin and ``F.scaled_dot_product_attention``;
4. groupnorm_silu: B3 likewise, beside ``F.group_norm`` + ``F.silu``;
5. reference: a cut-down SDXL-width UNet (bf16, kernels on) and the SDXL VAE
   decoder (fp32) on the card against the same weights on the CPU in fp32;
6. serve: ``DiffSenseiServer.generate`` at full SDXL width with random
   weights: 1024² with 20 Euler steps and CFG, two characters and a dialog
   box; the 768x1344 bucket; an unconditioned 1024² panel. The kernels'
   launch counts are reset before and checked after.

Then the kernels line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernels against their plain twins
# ---------------------------------------------------------------------------
FLASH_CASES = [  # (B, H, Sq, Sk, D, causal, bias)
    (2, 10, 4096, 4096, 64, False, False),   # UNet level 1 at 1024²
    (2, 20, 1024, 1024, 64, False, False),   # UNet level 2 at 1024²
    (2, 10, 4032, 4032, 64, False, False),   # level 1 of the 768x1344 bucket
    (1, 4, 1100, 1300, 64, False, True),     # ragged tails, broadcast bias
    (1, 4, 1100, 1100, 64, True, False),     # causal
    (1, 4, 1024, 1024, 128, False, False),   # head_dim 128
]
GN_CASES = [  # (shape, dtype name, eps)
    ((2, 128, 128, 320), "bfloat16", 1e-5),  # UNet level 0 at 1024²
    ((2, 32, 32, 1280), "bfloat16", 1e-5),   # UNet level 2
    ((1, 1024, 1024, 128), "float32", 1e-6),  # VAE last level at 1024²
]


def check_flash(device) -> dict:
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for b, h, sq, sk, d, causal, with_bias in FLASH_CASES:
        mk = lambda s: torch.randn((b, h, s, d), generator=gen, device=device).bfloat16()
        q, k, v = mk(sq), mk(sk), mk(sk)
        bias = None
        if with_bias:
            bias = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=device) > 0.3,
                               0.0, -10000.0)
        o, lse = fa.flash_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_ref(q.float(), k.float(), v.float(), bias, causal)
        err_o = (o.float() - ro).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        row = dict(shape=[b, h, sq, sk, d], causal=causal, bias=with_bias,
                   max_abs_err_o=err_o, max_abs_err_lse=err_lse,
                   ms=cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal=causal)),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_ref(q, k, v, bias, causal)),
                   sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=None if bias is None else bias.bfloat16(),
                       is_causal=causal)))
        rows.append(row)
        emit({"phase": "flash_attention", **row})
        if not (err_o <= 2e-2 and err_lse <= 1e-3):
            raise AssertionError(f"flash_attention disagrees with its plain twin: {row}")
    return dict(max_abs_err=max(r["max_abs_err_o"] for r in rows), ms=rows[0]["ms"],
                plain_ms=rows[0]["plain_ms"])


def check_groupnorm(device) -> dict:
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for shape, dtype_name, eps in GN_CASES:
        dtype = getattr(torch, dtype_name)
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
        scale = torch.randn(c, generator=gen, device=device).to(dtype)
        bias = torch.randn(c, generator=gen, device=device).to(dtype)
        got = gn.groupnorm_silu(x, scale, bias, 32, eps)
        torch.cuda.synchronize()
        want = gn.groupnorm_silu_ref(x, scale, bias, 32, eps)
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        else:
            ok = err <= 1e-4
        nchw = x.permute(0, 3, 1, 2)
        row = dict(shape=list(shape), dtype=dtype_name, eps=eps, max_abs_err=err,
                   ms=cuda_ms(lambda: gn.groupnorm_silu(x, scale, bias, 32, eps)),
                   plain_ms=cuda_ms(lambda: gn.groupnorm_silu_ref(x, scale, bias, 32, eps)),
                   library_ms=cuda_ms(lambda: F.silu(F.group_norm(nchw, 32, scale, bias, eps))))
        rows.append(row)
        emit({"phase": "groupnorm_silu", **row})
        if not ok:
            raise AssertionError(f"groupnorm_silu disagrees with its plain twin: {row}")
        del x, got, want, nchw
        torch.cuda.empty_cache()
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=rows[0]["ms"],
                plain_ms=rows[0]["plain_ms"])


# ---------------------------------------------------------------------------
# the modules on the card against the CPU on a small input
# ---------------------------------------------------------------------------
def check_reference(device) -> None:
    import torch
    from diffsensei_tpu_torch.core.config import UNetConfig, VAEConfig
    from diffsensei_tpu_torch.models.unet import UNetMangaModel
    from diffsensei_tpu_torch.models.vae import AutoencoderKL
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.utils.init import init_flax_like_

    # SDXL widths and heads, depth cut: a 64x64 latent gives 1024 tokens at level 1
    cfg = UNetConfig(block_out_channels=(320, 640), transformer_layers_per_block=(0, 1),
                     layers_per_block=1, mid_transformer_layers=1)
    gen = torch.Generator().manual_seed(2)
    unet = init_flax_like_(UNetMangaModel(cfg), gen).eval()
    rng = np.random.default_rng(2)
    manga = cfg.manga
    inputs = dict(
        sample=rng.normal(size=(2, 64, 64, 4)), timesteps=np.array([500.0, 500.0]),
        encoder_hidden_states=rng.normal(size=(2, 77, cfg.cross_attention_dim)),
        pooled_text_embeds=rng.normal(size=(2, cfg.pooled_projection_dim)),
        time_ids=np.tile([[512.0, 512.0, 0.0, 0.0, 512.0, 512.0]], (2, 1)),
        ip_hidden_states=rng.normal(size=(2, manga.num_context_image_tokens,
                                          cfg.cross_attention_dim)))
    cpu_in = {k: torch.tensor(v, dtype=torch.float32) for k, v in inputs.items()}
    with torch.inference_mode():
        want = unet(**cpu_in).float()
        unet_gpu = unet.to(device=device, dtype=torch.bfloat16)
        fa.launches = gn.launches = 0
        got = unet_gpu(**{k: v.to(device) for k, v in cpu_in.items()}).float().cpu()
        torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    row = dict(module="unet_320_640_bf16", max_rel_err=rel, bound=5e-2,
               flash_launches=fa.launches, groupnorm_launches=gn.launches)
    emit({"phase": "reference", **row})
    if not (rel <= 5e-2 and fa.launches > 0 and gn.launches > 0):
        raise AssertionError(f"UNet on the card disagrees with the CPU: {row}")
    del unet, unet_gpu

    vcfg = VAEConfig.sdxl()
    vae = init_flax_like_(AutoencoderKL(vcfg), gen).eval()
    z = torch.tensor(rng.normal(size=(1, 16, 16, 4)), dtype=torch.float32)
    with torch.inference_mode():
        want = vae.decode(z)
        got = vae.to(device).decode(z.to(device)).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    row = dict(module="sdxl_vae_decoder_fp32", max_rel_err=rel, bound=1e-3)
    emit({"phase": "reference", **row})
    if not rel <= 1e-3:
        raise AssertionError(f"VAE decoder on the card disagrees with the CPU: {row}")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def serve(device) -> dict:
    import torch
    from PIL import Image
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest

    t0 = time.perf_counter()
    mods = PipelineModules.sdxl(device=device, seed=0)
    torch.cuda.synchronize()
    emit({"phase": "serve_build", "seconds": time.perf_counter() - t0,
          "params": {name: sum(p.numel() for p in m.parameters())
                     for name, m in mods.networks().items()}})
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
    # per request: (request, expected B1 launches, expected B3 launches)
    # per UNet forward on the CFG batch of 2: B1 70 at 1024² (10 at 4096 tokens,
    # 60 at 1024), 10 at 768x1344 (level 2 has 1008 tokens, below 1024);
    # B3 34 (17 resnets x 2); the VAE decode adds 28 B3 (14 resnets x 2)
    requests = [
        (GenerationRequest(height=1024, width=1024, num_inference_steps=20,
                           guidance_scale=7.5, seed=1, prompt_ids=ids(), **conditioned),
         20 * 70, 20 * 34 + 28),
        (GenerationRequest(height=768, width=1344, num_inference_steps=4,
                           guidance_scale=7.5, seed=2, prompt_ids=ids(), **conditioned),
         4 * 10, 4 * 34 + 28),
        (GenerationRequest(height=1024, width=1024, num_inference_steps=4,
                           guidance_scale=7.5, seed=3, prompt_ids=ids()),
         4 * 70, 4 * 34 + 28),
    ]
    # warm the Triton specializations and cuDNN plans off the clock
    server.generate(GenerationRequest(height=1024, width=1024, num_inference_steps=1,
                                      prompt_ids=ids(), **conditioned))
    server.generate(GenerationRequest(height=768, width=1344, num_inference_steps=1,
                                      prompt_ids=ids(), **conditioned))
    torch.cuda.synchronize()

    fa.launches = gn.launches = 0
    totals = dict(flash=0, groupnorm=0)
    for req, want_fa, want_gn in requests:
        torch.cuda.reset_peak_memory_stats()
        fa0, gn0 = fa.launches, gn.launches
        t0 = time.perf_counter()
        img = server.generate(req)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got_fa, got_gn = fa.launches - fa0, gn.launches - gn0
        row = dict(height=req.height, width=req.width, steps=req.num_inference_steps,
                   conditioned=bool(req.character_images), seconds=seconds,
                   shape=list(img.shape), finite=bool(np.isfinite(img).all()),
                   min=float(img.min()), max=float(img.max()), mean=float(img.mean()),
                   std=float(img.std()),
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                   flash_launches=got_fa, groupnorm_launches=got_gn)
        emit({"phase": "serve", **row})
        if img.shape != (1, req.height, req.width, 3) or not row["finite"] \
                or row["min"] < 0.0 or row["max"] > 1.0:
            raise AssertionError(f"bad panel: {row}")
        if (got_fa, got_gn) != (want_fa, want_gn):
            raise AssertionError(f"launch counts {(got_fa, got_gn)} != expected "
                                 f"{(want_fa, want_gn)} for {row}")
    totals.update(flash=fa.launches, groupnorm=gn.launches)
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    fa.build()
    t_flash = time.perf_counter() - t0
    t0 = time.perf_counter()
    gn.build()
    x = torch.ones((1, 8, 8, 64), device=device)
    gn.groupnorm_silu(x, torch.ones(64, device=device), torch.zeros(64, device=device), 32)
    torch.cuda.synchronize()
    t_gn = time.perf_counter() - t0
    from diffsensei_tpu_torch.ops import _build
    log = _build.cuda_library("flash_attention.cu").with_suffix(".log").read_text()
    emit({"phase": "build", "flash_attention_nvcc_s": t_flash,
          "groupnorm_triton_s": t_gn,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    flash = check_flash(device)
    gnorm = check_groupnorm(device)
    check_reference(device)
    launches = serve(device)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:59",
             launches=launches["flash"], **flash),
        dict(name="groupnorm_silu", route="triton",
             source="diffsensei_tpu_torch/csrc/groupnorm_silu.py",
             replaces="diffsensei_tpu/ops/groupnorm.py:44",
             launches=launches["groupnorm"], **gnorm),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
