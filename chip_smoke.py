#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of the repository. Phases, one JSON line each:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: kernels B1, B2 and B4 (one CUDA C++ source) and B6 (CUDA C++),
   one nvcc each, started together, and B3 (Triton) from
   ``diffsensei_tpu_torch/csrc``;
3. flash_attention: B1 against its plain twin at the UNet's shapes, with times
   beside the plain twin and ``F.scaled_dot_product_attention``;
4. groupnorm_silu: B3 likewise, beside ``F.group_norm`` + ``F.silu``;
5. int4_matmul: B6 against its plain twin at the agent's decode shapes, with
   times beside the twin and ``torch.matmul`` on the weight dequantized to bf16;
6. reference: a cut-down SDXL-width UNet (bf16, kernels on), the SDXL VAE
   decoder (fp32) and a cut-down SEED-X-width int4 LLaMA (prefill and 8
   decode steps) on the card against the same weights on the CPU in fp32;
7. serve: ``DiffSenseiServer.generate`` at full SDXL width with random
   weights: 1024² with 20 Euler steps and CFG, two characters and a dialog
   box; the 768x1344 bucket; an unconditioned 1024² panel;
8. serve_agent: the same server with the SEED-X agent (int4 LLaMA-13B at
   full width, random weights) beside the SDXL stack on the one card: the
   1024² request again, its characters adapted by 500 greedy decode steps.
9. profile_decode: ``torch.profiler`` over 16 of the agent's decode steps:
   device time and kernels a token, the device's busy share, the top kernels;
10. flash_attention_bwd (run after phase 5): B2 (dQ) and B4 (dK/dV) against
   their plain twin at the training shapes and the edge cases, with times
   beside the twin and the backward of ``F.scaled_dot_product_attention``;
11. reference_train (after phase 6): one stage-2 loss and backward on a
   cut-down SDXL-width stack, bf16 on the card against fp32 on the CPU;
12. train: 6 stage-2 steps through the port's train CLI on
   ``configs/train/condition.yaml`` at full SDXL width (random weights,
   synthetic MangaZero pages from a numpy seed, the 1024² bucket, batch 1),
   one line a step; profile_train: ``torch.profiler`` over one of them.

The kernels' launch counts are set to 0 before each served or trained path
and checked after it. Then the kernels line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# one H100 SXM (NVIDIA's data sheet): HBM rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of one call in ms, from CUDA events around a pass.

    ``fns`` is one call, or a list of the same call on distinct copies of its
    operands, together more bytes than the 50 MB L2 holds, so each call finds
    its weights cold, as in a decode step. Every pass is queued behind a
    device sleep of about 10 ms, so the events time the device and not the
    host's launch rate."""
    import torch

    fns = fns if isinstance(fns, list) else [fns]
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for fn in fns:
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
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
    b, h, sq, sk, d = FLASH_CASES[0][:5]
    nbytes = 2 * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    return dict(max_abs_err=max(r["max_abs_err_o"] for r in rows), ms=rows[0]["ms"],
                plain_ms=rows[0]["plain_ms"], library_ms=rows[0]["sdpa_ms"],
                **bound(nbytes, 4 * b * h * sq * sk * d))


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
    shape = GN_CASES[0][0]
    n = int(np.prod(shape))
    # bf16 in and out; about 10 operations an element (stats, affine, SiLU)
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=rows[0]["ms"],
                plain_ms=rows[0]["plain_ms"], library_ms=rows[0]["library_ms"],
                **bound(2 * 2 * n + 4 * shape[-1], 10 * n))


INT4_CASES = [  # (tokens, in, features): the agent's decode projections at T = 1
    (1, 5120, 5120),       # q/k/v/o_proj
    (1, 5120, 13824),      # gate/up_proj (the row in the kernels line)
    (1, 13824, 5120),      # down_proj
    (1, 5120, 32330),      # lm_head, padded to 32512
    (16, 5120, 13824),     # the kernel's largest token count
]


def check_int4(device) -> dict:
    import torch
    from diffsensei_tpu_torch.ops import int4_matmul as i4

    gen = torch.Generator(device=device).manual_seed(4)
    rows = []
    for tokens, in_f, features in INT4_CASES:
        padded = i4.padded_features(features, in_f, 128)
        wbytes = in_f * padded // 2 + (in_f // 128) * padded * 4
        copies = min(64, -(-256 * 2**20 // wbytes))
        weights = [(torch.randint(0, 256, (in_f, padded // 2), generator=gen, device=device,
                                  dtype=torch.uint8),
                    (torch.rand((in_f // 128, padded), generator=gen, device=device) + 0.5)
                    / (4.61 * in_f ** 0.5))      # around the served scale: outputs of order 1
                   for _ in range(copies)]
        x = torch.randn((tokens, in_f), generator=gen, device=device).bfloat16()
        packed, scale = weights[0]
        got = i4.int4_decode_matmul(x, packed, scale)
        again = i4.int4_decode_matmul(x, packed, scale)
        torch.cuda.synchronize()
        dense = [i4.dequantize(q, s, torch.bfloat16) for q, s in weights]
        ref = x.float() @ dense[0].float()          # bf16 dequant matmul, fp32 sums
        xf = x.float()
        twin = i4.int4_decode_fallback(xf, packed, scale)
        row = dict(shape=[tokens, in_f, features], padded=padded,
                   max_abs_err=(got - twin).abs().max().item(),
                   rel_frobenius=((got - twin).norm() / twin.norm()).item(),
                   allclose_bf16=torch.allclose(got, ref, rtol=2e-2, atol=2e-2),
                   bit_equal=torch.equal(got, again), copies=copies,
                   ms=cuda_ms([lambda q=q, s=s: i4.int4_decode_matmul(x, q, s)
                                     for q, s in weights]),
                   plain_ms=cuda_ms([lambda q=q, s=s: i4.int4_decode_fallback(xf, q, s)
                                           for q, s in weights]),
                   library_ms=cuda_ms([lambda w=w: torch.matmul(x, w) for w in dense]),
                   **bound(wbytes + 2 * tokens * in_f + 4 * tokens * padded,
                           2 * tokens * in_f * padded))
        rows.append(row)
        emit({"phase": "int4_matmul", **row})
        if not (row["allclose_bf16"] and row["rel_frobenius"] < 2e-2 and row["bit_equal"]):
            raise AssertionError(f"int4_decode_matmul disagrees with its plain twin: {row}")
        del weights, dense, twin, ref
        torch.cuda.empty_cache()
    main = rows[1]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})


FLASH_BWD_CASES = [  # (B, H, Sq, Sk, D, causal, bias)
    (1, 10, 4096, 4096, 64, False, False),   # UNet level 1 at 1024², train batch 1
    (1, 20, 1024, 1024, 64, False, False),   # UNet level 2
] + FLASH_CASES[3:]                          # ragged + bias, causal, head_dim 128


def _causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: every pair, or below the
    diagonal for causal."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def check_flash_bwd(device):
    """B2 (dQ) and B4 (dK/dV) against the fp32 plain twin on the same bf16
    inputs: relative Frobenius error of each gradient at most 2e-2, two calls
    bit-equal. Times beside the twin's and the backward of
    ``F.scaled_dot_product_attention`` (one call that computes dQ, dK and dV
    together)."""
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(7)
    rel = lambda g, w: ((g.float() - w).norm() / w.norm()).item()
    rows = []
    for b, h, sq, sk, d, causal, with_bias in FLASH_BWD_CASES:
        mk = lambda s: torch.randn((b, h, s, d), generator=gen, device=device).bfloat16()
        q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
        bias = None
        if with_bias:
            bias = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=device) > 0.3,
                               0.0, -10000.0)
        kw = dict(causal=causal)
        o, lse = fa.flash_attention(q, k, v, bias, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, bias, o, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, lse, delta, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), bias, o.float(),
                                          lse, do.float(), causal)
        errs = {n: rel(g, w) for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        abs_err = {n: (g.float() - w).abs().max().item()
                   for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        bit_equal = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
        del want, again
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=None if bias is None else bias.bfloat16(), is_causal=causal)
        pairs = b * h * _causal_pairs(sq, sk, causal)
        elems_q, elems_k = b * h * sq * d, b * h * sk * d
        bias_bytes = 0 if bias is None else 4 * bias.numel()
        row = dict(shape=[b, h, sq, sk, d], causal=causal, bias=with_bias,
                   rel_frobenius=errs, max_abs_err=abs_err, bit_equal=bit_equal,
                   dq_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, bias, o, lse, do,
                                                                   **kw)),
                   dkv_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, lse, delta,
                                                                     do, **kw)),
                   dq_plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq_ref(
                       q, k, v, bias, o, lse, do, causal), reps=5),
                   dkv_plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv_ref(
                       q, k, v, bias, lse, delta, do, causal), reps=5),
                   sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                                   retain_graph=True)),
                   # B2 reads q k v o dO lse, writes dQ and delta; 3 products a pair
                   dq_bound=bound(2 * (4 * elems_q + 2 * elems_k) + 8 * b * h * sq + bias_bytes,
                                  3 * 2 * pairs * d),
                   # B4 reads q k v dO lse delta, writes dK dV; 4 products a pair
                   dkv_bound=bound(2 * (2 * elems_q + 4 * elems_k) + 8 * b * h * sq + bias_bytes,
                                   4 * 2 * pairs * d))
        rows.append(row)
        emit({"phase": "flash_attention_bwd", **row})
        if not (max(errs.values()) <= 2e-2 and bit_equal):
            raise AssertionError(f"the flash backward kernels disagree with their twin: {row}")
        del q, k, v, do, o, lse, dq, dk, dv, delta, out, qs, ks, vs
        torch.cuda.empty_cache()
    main = rows[0]
    library = dict(library_ms=main["sdpa_bwd_ms"],
                   library_call="scaled_dot_product_attention backward (dq, dk, dv together)")
    dq_row = dict(max_abs_err=max(r["max_abs_err"]["dq"] for r in rows), ms=main["dq_ms"],
                  plain_ms=main["dq_plain_ms"], **main["dq_bound"], **library)
    dkv_row = dict(max_abs_err=max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"])
                                   for r in rows),
                   ms=main["dkv_ms"], plain_ms=main["dkv_plain_ms"], **main["dkv_bound"],
                   **library)
    return dq_row, dkv_row


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


def check_llama_reference(device, num_layers: int = 2, prompt_len: int = 24,
                          steps: int = 8) -> None:
    """SEED-X width (hidden 5120, 40 heads of 128, intermediate 13824, vocab
    32330) with ``num_layers`` layers in int4: a prefill and ``steps`` greedy
    decode steps on the card (B6) against the same weights on the CPU in fp32.
    The card is fed the CPU's tokens, so each step's logits compare; its own
    argmax must pick the CPU's token unless the CPU's top two logits lie
    within the bound."""
    import dataclasses
    import torch
    from diffsensei_tpu_torch.core.config import LlamaConfig
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM, init_caches
    from diffsensei_tpu_torch.ops import int4_matmul as i4
    from diffsensei_tpu_torch.utils.init import init_flax_like_

    cfg = dataclasses.replace(LlamaConfig.seed_x_13b(), num_layers=num_layers)
    with torch.device("meta"):
        llm = LlamaForCausalLM(cfg, quantized="int4")
    init_flax_like_(llm.to_empty(device="cpu"), torch.Generator().manual_seed(5)).eval()
    ids = torch.from_numpy(np.random.default_rng(5).integers(3, cfg.vocab_size, (1, prompt_len)))

    def run(model, dev, tokens=None):
        caches = init_caches(cfg, 1, prompt_len + steps, torch.float32, dev)
        logits, _, caches = model(ids.to(dev), positions=torch.arange(prompt_len, device=dev)[None],
                                  caches=caches, cache_index=0)
        out = [logits[0].float().cpu()]
        picked = []
        for i in range(steps):
            picked.append(int(out[-1][-1].argmax()))
            tok = picked[-1] if tokens is None else tokens[i]
            pos = torch.full((1, 1), prompt_len + i, device=dev)
            logits, _, caches = model(torch.full((1, 1), tok, device=dev), positions=pos,
                                      caches=caches, cache_index=prompt_len + i)
            out.append(logits[0].float().cpu())
        return out, picked

    with torch.inference_mode():
        want, cpu_tokens = run(llm, torch.device("cpu"))
        i4.launches = 0
        got, card_tokens = run(llm.to(device), device, cpu_tokens)
        torch.cuda.synchronize()
    rels = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
    ties = []
    for step, (w, tok, card) in enumerate(zip(want, cpu_tokens, card_tokens)):
        top2 = w[-1].topk(2).values
        gap = (top2[0] - top2[1]).item() / w[-1].abs().max().item()
        if card != tok:
            ties.append(dict(step=step, cpu=tok, card=card, top2_gap_rel=gap))
    row = dict(module=f"llama_seed_x_width_{num_layers}_layers_int4", max_rel_err=max(rels),
               prefill_rel_err=rels[0], decode_rel_errs=rels[1:], bound=5e-2,
               cpu_tokens=cpu_tokens, card_tokens=card_tokens, int4_launches=i4.launches)
    emit({"phase": "reference", **row})
    if not (max(rels) <= 5e-2 and i4.launches == steps * (7 * num_layers + 1)
            and all(t["top2_gap_rel"] <= 5e-2 for t in ties)):
        raise AssertionError(f"the int4 LLaMA on the card disagrees with the CPU: {row} {ties}")


def check_reference_train(device) -> None:
    """One stage-2 ``loss_fn`` and its backward on a cut-down SDXL-width
    stack: the UNet of ``check_reference`` (320/640, 1024 tokens at level 1,
    per-block remat) beside the full SDXL VAE and DiffSensei Resampler, the
    text and character encoders at full width with 2 layers each. On the
    card in bf16 with fp32 trainables (kernels B1-B4 on), against the same
    weights, batch and draws on the CPU in fp32. Bounds: the loss within
    2e-2 and the concatenated trainables' gradient within 5e-2 (relative),
    every gradient tensor within 1.5e-1."""
    import copy
    import dataclasses
    import torch
    from diffsensei_tpu_torch.core.config import (
        ResamplerConfig, TextEncoderConfig, UNetConfig, VAEConfig, VisionEncoderConfig)
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules
    from diffsensei_tpu_torch.train import diffusion as td, optim

    two = lambda cfg: dataclasses.replace(cfg, num_layers=2)
    configs = dict(
        unet=UNetConfig(block_out_channels=(320, 640), transformer_layers_per_block=(0, 1),
                        layers_per_block=1, mid_transformer_layers=1),
        vae=VAEConfig.sdxl(), text_encoder=two(TextEncoderConfig.clip_l()),
        text_encoder_2=two(TextEncoderConfig.clip_bigg()),
        image_encoder=two(VisionEncoderConfig.clip_vit_h()),
        magi_encoder=two(VisionEncoderConfig.magi_vitmae()), resampler=ResamplerConfig.diffsensei())
    cpu = PipelineModules.build(configs, torch.float32, device="cpu", seed=6)
    card = copy.deepcopy(cpu)
    for name, mod in card.networks().items():
        mod.to(device=device, dtype=torch.float32 if name == "vae" else torch.bfloat16)
    manga = cpu.manga
    rng = np.random.default_rng(6)
    i, hw = manga.max_num_ips, 512
    batch = dict(
        pixel_values=rng.uniform(-1, 1, (1, hw, hw, 3)),
        text_input_ids=rng.integers(1, 49000, (1, 77)),
        text_input_ids_2=rng.integers(1, 49000, (1, 77)),
        ip_pixel_values=rng.normal(size=(1, i, 1, 224, 224, 3)),
        magi_pixel_values=rng.normal(size=(1, i, 1, 224, 224, 3)),
        ip_exists=np.ones((1, i, 1)), ip_bbox=np.array([[[0.05, 0.1, 0.45, 0.9],
                                                          [0.5, 0.1, 0.95, 0.6],
                                                          [0.5, 0.6, 0.8, 0.95],
                                                          [0.1, 0.7, 0.3, 0.95]]]),
        dialog_bbox=np.concatenate([[[[0.1, 0.02, 0.6, 0.2], [0.6, 0.7, 0.95, 0.95]]],
                                    np.zeros((1, manga.max_num_dialogs - 2, 4))], axis=1),
        original_size=np.array([[hw, hw]]), crop_coords_top_left=np.zeros((1, 2)),
        target_size=np.array([[hw, hw]]))
    draws = dict(latent_noise=rng.normal(size=(1, hw // 8, hw // 8, 4)),
                 noise=rng.normal(size=(1, hw // 8, hw // 8, 4)), timesteps=np.array([500]))

    def grads(mods, dev):
        mods.unet.enable_remat()
        trainable, _ = optim.partition_params(
            mods.unet, optim.unet_trainable_mask(mods.unet, "new"))
        params = {f"unet.{k}": p for k, p in trainable.items()}
        res, _ = optim.partition_params(
            mods.resampler, {k: True for k, _ in mods.resampler.named_parameters()})
        params.update({f"resampler.{k}": p for k, p in res.items()})
        step = td.make_stage2_step(mods.unet, mods.resampler, DDPMSchedule(), td.Stage2Config(
            manga=manga, ip_contrastive="fast"))
        frozen = td.FrozenDiffusionStack(
            vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
            image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder)
        as_t = lambda a: torch.tensor(a, dtype=torch.int32 if a.dtype.kind == "i"
                                      else torch.float32, device=dev)
        loss, _ = step.loss_fn(frozen, {k: as_t(v) for k, v in batch.items()},
                               **{k: as_t(v) for k, v in draws.items()})
        loss.backward()
        return loss.item(), {k: p.grad.float().cpu() for k, p in params.items()}

    want_loss, want = grads(cpu, "cpu")
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = gn.launches = 0
    got_loss, got = grads(card, device)
    torch.cuda.synchronize()
    launches = dict(flash_fwd=fa.launches, flash_dq=fa.bwd_dq_launches,
                    flash_dkv=fa.bwd_dkv_launches, groupnorm=gn.launches)
    per = {k: ((got[k] - want[k]).norm() / want[k].norm()).item() for k in want}
    cat = lambda d: torch.cat([d[k].flatten() for k in want])
    total = ((cat(got) - cat(want)).norm() / cat(want).norm()).item()
    worst = max(per, key=per.get)
    row = dict(module="stage2_unet_320_640_bf16", loss=got_loss, loss_cpu=want_loss,
               loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
               grad_rel_frobenius=total, worst_tensor=worst, worst_rel_frobenius=per[worst],
               median_rel_frobenius=float(np.median(list(per.values()))),
               trainable_tensors=len(per), bounds=dict(loss=2e-2, grad=5e-2, tensor=1.5e-1),
               launches=launches)
    emit({"phase": "reference_train", **row})
    # 4 self-attentions of 1024 tokens at level 1: B1 forward + remat replay
    if not (row["loss_rel_err"] <= 2e-2 and total <= 5e-2 and per[worst] <= 1.5e-1
            and launches["flash_fwd"] == 8 and launches["flash_dq"] == 4
            and launches["flash_dkv"] == 4 and launches["groupnorm"] > 0):
        raise AssertionError(f"the stage-2 step on the card disagrees with the CPU: {row}")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def serve(device):
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
    return totals, mods, ids


def serve_agent(device, mods, ids, max_new_tokens: int = 500) -> dict:
    """R1 with the SEED-X agent attached: ``ContinuousLVLM`` at ``AgentConfig()``
    width, int4, random weights from seed 0, beside ``mods`` on the card. One
    warm request, then one timed with every launch count checked: B6 runs 281
    times a decode step (40 layers x 7 projections + lm_head), B1 and B3 as R1."""
    import torch
    from PIL import Image
    from diffsensei_tpu_torch.core.config import AgentConfig
    from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec, build_inference_prompt
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.ops import int4_matmul as i4
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest

    acfg = AgentConfig()
    t0 = time.perf_counter()
    agent = ContinuousLVLM.build(acfg, quantized="int4", device=device, seed=0)
    torch.cuda.synchronize()
    emit({"phase": "serve_agent_build", "seconds": time.perf_counter() - t0,
          "params": {name: sum(p.numel() for p in m.parameters())
                     for name, m in zip(("llm", "input_resampler", "output_resampler"),
                                        agent.networks())},
          "llm_bytes": sum(p.numel() * p.element_size() for p in agent.llm.parameters()),
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30})

    # no tokenizer files: text ids from a numpy generator seeded by the text,
    # the image ladder at the top of the vocabulary
    vocab, n_img = acfg.llm.vocab_size, acfg.input_resampler.num_queries
    ladder = list(range(vocab - n_img - 2, vocab))
    encode = lambda text: np.random.default_rng(list(text.encode()) or [0]).integers(
        3, ladder[0], max(1, len(text.split()))).tolist()
    spec = MLLMTokenSpec(bos_id=1, eos_id=2, pad_id=0, boi_id=ladder[0], eoi_id=ladder[-1],
                         img_ids=ladder[1:-1], encode_text=encode)
    server = DiffSenseiServer(DiffSenseiPipeline(mods), agent=agent, mllm_spec=spec,
                              mllm_max_new_tokens=max_new_tokens)

    # device time of every LLM forward (CUDA events), and the agent's output
    calls, result = [], {}
    forward, generate = agent.llm.forward, agent.generate

    def timed_forward(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(*args, **kwargs)
        end.record()
        calls.append((start, end))
        return out

    def timed_generate(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(*args, **kwargs)
        torch.cuda.synchronize()
        result.update(out, seconds=time.perf_counter() - t)
        return out

    agent.llm.forward, agent.generate = timed_forward, timed_generate
    rng = np.random.default_rng(4)
    chars = [Image.fromarray((rng.random((300, 200, 3)) * 255).astype(np.uint8))
             for _ in range(2)]
    req = GenerationRequest(
        prompt="two girls talk on a rainy street, one holds an umbrella, speech bubble",
        height=1024, width=1024, num_inference_steps=20, guidance_scale=7.5, seed=1,
        prompt_ids=ids(), character_images=chars,
        ip_bbox=[[0.05, 0.1, 0.5, 0.95], [0.5, 0.2, 0.95, 0.9]],
        dialog_bbox=[[0.1, 0.02, 0.6, 0.2]])
    server.generate(req)                    # warm: Triton specializations, cuDNN plans
    torch.cuda.synchronize()

    calls.clear()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = gn.launches = i4.launches = 0
    t0 = time.perf_counter()
    img = server.generate(req)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(flash=fa.launches, groupnorm=gn.launches, int4=i4.launches)
    call_ms = [start.elapsed_time(end) for start, end in calls]
    feat = result["img_gen_feat"]
    ids_out = result["output_ids"][0]
    prompt = build_inference_prompt(encode(req.prompt), spec, encode("\n"))
    row = dict(seconds=seconds, agent_seconds=result["seconds"],
               prompt_tokens=prompt["input_ids"].shape[1],
               agent_prefill_ms=call_ms[0], decode_steps=len(call_ms) - 1,
               decode_ms_per_token_mean=statistics.mean(call_ms[1:]),
               decode_ms_per_token_median=statistics.median(call_ms[1:]),
               num_gen_imgs=result["num_gen_imgs"],
               img_gen_feat_shape=None if feat is None else list(feat.shape),
               img_gen_feat_finite=feat is not None and bool(torch.isfinite(feat).all()),
               ladder_forced=bool((ids_out[:n_img + 1] == np.asarray(ladder[1:])).all()),
               shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               min=float(img.min()), max=float(img.max()), mean=float(img.mean()),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    emit({"phase": "serve_agent", **row})
    want = dict(flash=20 * 70, groupnorm=20 * 34 + 28,
                int4=max_new_tokens * (7 * acfg.llm.num_layers + 1))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if not (row["num_gen_imgs"] >= 1 and row["img_gen_feat_finite"] and row["ladder_forced"]
            and row["decode_steps"] == max_new_tokens):
        raise AssertionError(f"the agent's output is wrong: {row}")
    if img.shape != (1, 1024, 1024, 3) or not row["finite"] or row["min"] < 0.0 \
            or row["max"] > 1.0:
        raise AssertionError(f"bad panel: {row}")
    profile_decode(device, agent.llm)
    return launches


def write_mangazero(root, pages: int = 8, seed: int = 8) -> None:
    """A MangaZero-format page set from a numpy seed: each page one
    1024x1024 frame (the 1024² bucket) with four characters and two dialog
    boxes, the page image a smooth random PNG."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    words = ["girl", "boy", "rain", "street", "umbrella", "talks", "shouts", "night", "room"]
    anns = []
    for p in range(pages):
        img = Image.fromarray((rng.random((36, 36, 3)) * 255).astype(np.uint8))
        img.resize((1152, 1152), Image.BICUBIC).save(root / f"page_{p}.png")
        x0, y0 = 64, 64

        def box(w_range, h_range):
            w, h = rng.integers(*w_range), rng.integers(*h_range)
            x, y = rng.integers(x0, x0 + 1024 - w), rng.integers(y0, y0 + 1024 - h)
            return [int(x), int(y), int(x + w), int(y + h)]
        anns.append({"image_path": f"page_{p}.png", "frames": [{
            "bbox": [x0, y0, x0 + 1024, y0 + 1024],
            "caption": " ".join(rng.choice(words, 6)),
            "characters": [{"id": c, "bbox": box((150, 400), (200, 600)), "type": 0}
                           for c in range(4)],
            "dialogs": [{"bbox": box((100, 300), (60, 200))} for _ in range(2)]}]})
    (root / "annotations.json").write_text(json.dumps(anns))


TRAIN_STEPS, PROFILED_STEP = 6, 5


def train(device) -> dict:
    """Stage 2 through the port's CLI (``train.cli.main``) on
    ``configs/train/condition.yaml`` at full SDXL width with four changes:
    ``init: random``, no ``weights:`` group, the synthetic data paths (and
    the log directory beside them), ``max_train_steps: 6, log_every: 1,
    checkpoint_every: 3``. Each step's loss, seconds, peak memory and kernel
    launches; step ``PROFILED_STEP`` under ``torch.profiler``. Checks: finite
    losses, checkpoints at steps 3 and 6, the trainables moved and the frozen
    UNet weights did not, the same launch counts on every step."""
    import pathlib
    import tempfile
    import torch
    import yaml
    from torch.profiler import ProfilerActivity, profile
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.train import cli, optim

    names = ("flash_fwd", "flash_dq", "flash_dkv", "groupnorm")
    counts = lambda: (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches, gn.launches)
    snap, built = {}, {}
    build_models = cli.build_models

    def capture(*args, **kwargs):     # the CLI's models, for the moved/frozen check
        mods = build_models(*args, **kwargs)
        mask = optim.unet_trainable_mask(mods.unet, "new")
        for name, p in mods.unet.named_parameters():   # on the host: no device memory
            snap[("unet", name, mask[name])] = p.detach().cpu()
        for name, p in mods.resampler.named_parameters():
            snap[("resampler", name, True)] = p.detach().cpu()
        built["mods"] = mods
        return mods

    rows, prof = [], profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now, c = time.perf_counter(), counts()
        if step == PROFILED_STEP + 1:
            prof.stop()
            clock["profiled_s"] = now - clock["profile_start"]
        rows.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                         host_s=now - clock["last"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=dict(zip(names, (a - b for a, b in zip(c, clock["counts"]))))))
        torch.cuda.reset_peak_memory_stats()
        if step == PROFILED_STEP:
            prof.start()
            clock["profile_start"] = time.perf_counter()
        clock.update(last=time.perf_counter(), counts=counts())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp)
        cfg = yaml.safe_load(pathlib.Path("configs/train/condition.yaml").read_text())
        cfg.pop("weights")
        cfg["model"]["init"] = "random"
        cfg["train_data"].update(ann_path=str(tmp / "annotations.json"), image_root=str(tmp))
        cfg["trainer"].update(max_train_steps=TRAIN_STEPS, log_every=1, checkpoint_every=3,
                              log_dir=str(tmp / "logs"))
        (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))

        cli.build_models = capture
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = gn.launches = 0
        t0 = clock["last"] = time.perf_counter()
        clock["counts"] = counts()
        try:
            state = cli.main(["--config", str(tmp / "config.yaml")], on_step=on_step)
        finally:
            cli.build_models = build_models
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        totals = dict(zip(names, counts()))
        logged = [json.loads(line) for line in (tmp / "logs" / "metrics.jsonl").read_text()
                  .splitlines()]
        checkpoints = sorted(p.parent.name for p in (tmp / "logs").glob("step-*/ckpt.pt"))

    for row, rec in zip(rows, logged):
        row.update(step_s=rec["time/step_s"], data_s=rec["time/data_s"])
        emit({"phase": "train", **row})
    moved = {"unet": [], "resampler": [], "frozen_unet": []}
    mods = built.pop("mods")
    live = {("unet", n): p for n, p in mods.unet.named_parameters()}
    live.update({("resampler", n): p for n, p in mods.resampler.named_parameters()})
    for (module, name, trains), before in snap.items():
        changed = not torch.equal(live[(module, name)].detach().float().cpu(), before.float())
        moved["frozen_unet" if not trains else module].append(changed)
    del snap, live, mods
    summary = dict(steps=len(rows), seconds=seconds, checkpoints=checkpoints,
                   trainable_tensors=len(state.params),
                   trainable_params=sum(p.numel() for p in state.params.values()),
                   moved_unet=f"{sum(moved['unet'])}/{len(moved['unet'])}",
                   moved_resampler=f"{sum(moved['resampler'])}/{len(moved['resampler'])}",
                   moved_frozen_unet=f"{sum(moved['frozen_unet'])}/{len(moved['frozen_unet'])}",
                   launches=totals)
    emit({"phase": "train_summary", **summary})
    # per step, remat on: B1 70 forward + 70 replayed, B2 and B4 70 each; B3 34 in
    # the UNet forward + 34 replayed + 20 in the VAE encoder
    want = dict(flash_fwd=140, flash_dq=70, flash_dkv=70, groupnorm=88)
    if len(rows) != TRAIN_STEPS or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"a bad loss: {rows}")
    if checkpoints != ["step-3", "step-6"]:
        raise AssertionError(f"checkpoints {checkpoints} != step-3, step-6")
    if not (all(moved["unet"]) and all(moved["resampler"]) and not any(moved["frozen_unet"])):
        raise AssertionError(f"trainables did not move or frozen weights did: {summary}")
    if any(r["launches"] != want for r in rows):
        raise AssertionError(f"launch counts per step {[r['launches'] for r in rows]} "
                             f"!= {want}")
    profile_train(prof, clock["profiled_s"])
    return totals


def profile_train(prof, wall_s: float) -> None:
    """Where one train step's time goes, from the profiler over step
    ``PROFILED_STEP + 1``: device time (kernel time summed), kernels launched,
    the device's busy share, the ten kernels that take the most time."""
    import torch

    events = prof.key_averages()
    # device-side entries only, without the optimizer's annotation ranges,
    # which span kernels counted on their own
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    seen = bool(kernels)     # None below: the profiler saw no device time
    emit({"phase": "profile_train", "step": PROFILED_STEP + 1, "wall_s": wall_s,
          "device_s": device_us / 1e6 if seen else None,
          "device_busy_share": device_us / 1e6 / wall_s if seen else None,
          "kernels": sum(e.count for e in kernels) if seen else None,
          "top": [dict(name=e.key[:80], ms=e.self_device_time_total / 1e3, count=e.count)
                  for e in top]})


def profile_decode(device, llm, prompt_len: int = 83, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` cached decode steps of the
    agent's LLM under ``torch.profiler``; device time a token (kernel time
    summed) beside the host clock, the kernels launched a token, and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffsensei_tpu_torch.models.mllm.llama import init_caches

    caches = init_caches(llm.config, 1, prompt_len + steps + 1, torch.float32, device)
    tok = torch.full((1, 1), 5, device=device)
    pos = lambda i: torch.full((1, 1), i, device=device)
    with torch.inference_mode():
        llm(torch.arange(3, 3 + prompt_len, device=device)[None],
            positions=torch.arange(prompt_len, device=device)[None],
            caches=caches, cache_index=0)
        llm(tok, positions=pos(prompt_len), caches=caches, cache_index=prompt_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, steps + 1):
                llm(tok, positions=pos(prompt_len + i), caches=caches, cache_index=prompt_len + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side entries only: the operators' own rows repeat their kernels' time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    launch_calls = sum(e.count for e in events if "LaunchKernel" in e.key)
    seen = bool(kernels)     # None below: the profiler saw no device time
    emit({"phase": "profile_decode", "steps": steps,
          "wall_ms_per_token_profiled": wall / steps * 1e3,
          "device_ms_per_token": device_us / steps / 1e3 if seen else None,
          "device_busy_share": device_us / 1e6 / wall if seen else None,
          "kernels_per_token": sum(e.count for e in kernels) / steps if seen else None,
          "host_launch_calls_per_token": launch_calls / steps,
          "top": [dict(name=e.key[:80], ms_per_token=e.self_device_time_total / steps / 1e3,
                       per_token=e.count / steps) for e in top]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.ops import int4_matmul as i4

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(2) as pool:       # one nvcc for each CUDA source, together
        nvcc = {"flash_attention": pool.submit(timed, fa.build),
                "int4_matmul": pool.submit(timed, i4.build)}
        t0 = time.perf_counter()
        gn.build()
        x = torch.ones((1, 8, 8, 64), device=device)
        gn.groupnorm_silu(x, torch.ones(64, device=device), torch.zeros(64, device=device), 32)
        torch.cuda.synchronize()
        t_gn = time.perf_counter() - t0
        nvcc = {name: fut.result() for name, fut in nvcc.items()}
    from diffsensei_tpu_torch.ops import _build
    ptxas = {}
    for name in nvcc:
        log = _build.cuda_library(f"{name}.cu").with_suffix(".log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "flash_attention_nvcc_s": nvcc["flash_attention"],
          "int4_matmul_nvcc_s": nvcc["int4_matmul"], "groupnorm_triton_s": t_gn,
          "ptxas": ptxas})

    flash = check_flash(device)
    gnorm = check_groupnorm(device)
    int4 = check_int4(device)
    flash_dq, flash_dkv = check_flash_bwd(device)
    check_reference(device)
    check_llama_reference(device)
    check_reference_train(device)
    launches, mods, ids = serve(device)
    agent_launches = serve_agent(device, mods, ids)
    del mods
    torch.cuda.empty_cache()
    train_launches = train(device)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    by_path = lambda serve_key, train_key: dict(
        launches=launches[serve_key] + agent_launches[serve_key] + train_launches[train_key],
        launches_by_path=dict(serve=launches[serve_key], serve_agent=agent_launches[serve_key],
                              train=train_launches[train_key]))

    emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:59",
             **by_path("flash", "flash_fwd"), **flash),
        dict(name="groupnorm_silu", route="triton",
             source="diffsensei_tpu_torch/csrc/groupnorm_silu.py",
             replaces="diffsensei_tpu/ops/groupnorm.py:44",
             **by_path("groupnorm", "groupnorm"), **gnorm),
        dict(name="int4_decode_matmul", route="cuda",
             source="diffsensei_tpu_torch/csrc/int4_matmul.cu",
             replaces="diffsensei_tpu/ops/int4_matmul.py:125",
             launches=agent_launches["int4"], **int4),
        dict(name="flash_attention_dq", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:196",
             launches=train_launches["flash_dq"], **flash_dq),
        dict(name="flash_attention_dkv", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:258",
             launches=train_launches["flash_dkv"], **flash_dkv),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
