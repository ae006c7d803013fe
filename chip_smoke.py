#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of the repository. Phases, one JSON line each:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: kernels B1, B2 and B4 (one CUDA C++ source), B5, B3, B6, B7 and
   B8 (CUDA C++) from ``diffsensei_tpu_torch/csrc``, one nvcc each, started together,
   with each kernel's ptxas lines; flash_layout: the head_dim-64 B1 (64- and
   128-key tiles), B2 and B4 kernels' registers, spills, blocks per SM, grid
   and waves at the UNet's shapes;
3. flash_attention: B1 against its plain twin at the UNet's shapes (o within
   2e-2 and within 5e-3 in relative Frobenius norm, lse within 1e-3), with
   times beside the plain twin and ``F.scaled_dot_product_attention``, and
   each row's bound;
4. groupnorm_silu: B3 at every shape R1, R2 and T1 launch and at the gpu
   tests' ragged ones (``GN_CASES``) against its plain twin, two calls
   bit-equal, with its plan (route, slabs, blocks), the kernels a call
   (``torch.profiler``), its time cold and warm beside its bound, the twin
   and ``F.group_norm`` + ``F.silu``; per_request: R1's and T1's B3 time
   (calls x ms) against their bounds;
5. int4_matmul: B6 (one launch a call: a cluster of 2-16 blocks splits a
   strip's rows, TMA boxes through an mbarrier ring, mma.sync on nibbles
   turned bf16 in registers, the blocks' sums met through distributed shared
   memory; it takes the fp32 x) against its plain twin at the agent's decode
   shapes, bf16 x and, at T = 1, fp32 x (the same bits), with times beside
   the twin and ``torch.matmul`` on the weight dequantized to bf16;
   int4_layout: its registers, spills, clusters, grid, blocks an SM and
   waves; per_token: a decode token's B6 time and bound;
6. reference (in the ``references`` process beside the main path, after
   the lane's waves; its lines carry their own ``process_at_s``): a
   cut-down SDXL-width UNet (bf16, kernels on), the SDXL VAE decoder (fp32)
   whole and tiled, and a cut-down SEED-X-width int4 LLaMA (prefill and 8
   decode steps) on the card against the same weights on the CPU in fp32;
7. serve: ``DiffSenseiServer.generate`` at full SDXL width with random
   weights: 1024² with 20 Euler steps and CFG, two characters and a dialog
   box; the 768x1344 bucket (its 96x168 latent decoded in two tiles); an
   unconditioned 1024² panel; serve_weights: R1's modules written as a
   released artifact directory (the UNet and the Resampler as torch files,
   the rest as safetensors, about 9 GB in a temp dir kept for the train
   phases), loaded into ``PipelineModules.sdxl(init="none")`` through
   ``utils.load.load_weights_any`` (every parameter's dtype, device and
   strides R1's), R1's request from it bit-equal to R1's panel with R1's
   launches, the same request again from the built, the loaded and the
   built stack (seconds and the allocator's new segments of each), then the
   serve CLI once on the directory with ``--weights`` and
   a CLIP vocabulary the smoke writes (``--tokenizer``); serve_extras: R1's
   request on the same modules
   through six legs (DDIM 4 steps unconditioned, DPM-Solver++ 12, Euler 20
   with DeepCache N = 2 and N = 3 at split 2, DPM++ 12 with DeepCache N = 2,
   Euler 20 on the int8 UNet, made on the card and held byte for byte to
   the host numpy quantization at every 40th projection), each leg's
   launches checked exactly and its latent and image PSNR against R1's
   exact panel reported;
   deep_cache_exact: a full-width 1024² UNet forward with ``return_deep`` and
   one with its feature bit-equal (splits 2 and 1), and the interval-1 loop
   bit-equal to the uncached loop over 2 steps; eval_pages: two frames of
   ``MangaEvaluationDataset`` over synthetic MangaZero pages through the
   server at their bucket, 4 Euler steps, exact launches;
8. serve_agent: the same server with the SEED-X agent (int4 LLaMA-13B at
   full width, random weights) beside the SDXL stack on the one card: the
   1024² request again (warmed by the 65-token ladder at 2 steps), its
   characters adapted by 500 greedy decode steps;
   agent_weights: a 2-layer SEED-X-width agent (LoRA r 64) written as a
   ``pytorch_model.bin`` with peft names and ``module.`` prefixes, loaded by
   the serve CLI's ``--quantize-llm --quantize-llm-bits 4`` path (built on
   the meta device, quantized on the host): bytes equal to
   ``quantize_agent`` of the agent in memory, 8 greedy ids equal, B6 15
   launches a token, the load's device peak below the bf16 LLM's bytes;
   eval_mllm_item: one ``MangaEvalMLLMDataset`` item's prompt ids with the
   agent's token spec; agent_cli: the serve CLI's agent panel from files
   (``--weights``, the CLIP vocabulary, ``--agent-weights`` of agent_weights
   with ``--quantize-llm --quantize-llm-bits 4`` and ``--mllm-tokenizer``
   of a LLaMA-2-layout tokenizer the smoke writes: 32,000 pieces and
   SEED-X's 330 added tokens), R4's prompt, characters and boxes at 1024²,
   4 Euler steps: the prompt ids that reach ``generate`` those of
   ``build_inference_prompt`` over the tokenizer's ids, exact launches (B6
   15 a token for 500 tokens), a finite panel.
9. profile_decode: ``torch.profiler`` over 16 of the agent's decode steps,
   through ``utils.observability.profile_trace`` (the trace file's bytes):
   device time and kernels a token, the device's busy share, the top kernels;
10. flash_attention_bwd (run after phase 5): B2 (dQ) and B4 (dK/dV) against
   their plain twin at the training shapes and the edge cases, with times
   beside the twin and the backward of ``F.scaled_dot_product_attention``,
   and the pair (B2 then B4) beside that backward and its own bound;
11. reference_train (in the references process, after phase 6): one
   stage-2 loss and backward on a cut-down SDXL-width stack, bf16 on the
   card against fp32 on the CPU;
12. train: 6 stage-2 steps through the port's train CLI on
   ``configs/train/condition.yaml`` at full SDXL width (its ``weights:``
   group pointed at serve_weights' files, ``init: zeros``; synthetic
   MangaZero pages from a numpy seed, the 1024² bucket, batch 1), one line a
   step; profile_train: ``torch.profiler`` over one of them; train_bf16: 2
   more with ``param_dtype: bfloat16`` (bf16 trainables, no fp32 copies);
   train_lora: 3 more stage-2 steps with UNet LoRA (rank 64) set in memory:
   only the adapters, the IP projections and the Resampler move, every base
   UNet weight stays bit-equal, and the merged rank-0 UNet agrees with the
   adapter UNet; train_remat: T1 built once by the CLI with
   ``model.remat_policy: attn`` and one CLI step, then from the same state
   and batch one step under each remat policy (None, dots, attn, dots_attn,
   dots_deepest): exact launches (B1 70 under attn and dots_attn, 140
   otherwise), peaks, seconds, trainables bit-equal to the None step's;
   train_proj: 2 stage-2 steps with the linear ``ImageProjDummyModel``
   (``ip_adapter_plus=False``) on train_remat's modules;
13. dual_cross_attention (after phase 5): B5 against its plain twin at the
   UNet's cross-attention shapes, with times beside the twin and two
   ``F.scaled_dot_product_attention`` calls, each row's bound and occupancy;
   dual_layout: its registers and spills;
14. reference_train_mllm (in the references process, after phase 11): one
   stage-3 loss and backward on a cut-down stack with a 2-layer
   SEED-X-width LLaMA, bf16 on the card against fp32 on the CPU;
15. train_mllm: 4 stage-3 steps through the train CLI on
   ``configs/train/mllm.yaml`` at full SDXL and SEED-X width and depth (the
   13B LLaMA in bf16 with fp32 LoRA, embeddings, norms and resamplers), one
   line a step, checkpoints, the trainables moved and the frozen weights
   bit-equal (checksums kept on the host), then ``MLLM_ATTN_STEPS`` more
   (none since the data-axis phases came) with the LLaMA's remat policy
   ``attn``; profile_train_mllm over the fourth and the last step;
16. ring_attention (after phase 13): the ring's schedule in one process
   (``ops.ring_attention.ring_schedule``: n ranks' chunks on B1 and their
   log-sum-exp merges) at 2048²'s level-1 shape (2, 10, 16384, 64) for 2, 4
   and 8 ranks and at (2, 10, 4096, 64) for 4, against one B1 call over the
   whole sequence (B1's limits), n² launches, with times beside that call,
   SDPA and the bound;
17. serve_cp (after agent_weights): a NCCL world of one in this process;
   a 2048² panel with ``snap_to_buckets=False``, 4 Euler steps, CFG, R1's
   characters and dialog box, through ``DiffSenseiPipeline(...,
   PipelineConfig(context_parallel=True), mesh=make_mesh())`` (its 10
   level-1 self-attentions a forward through the ring) and without the
   mesh: exact launches, the panels bit-equal; serve_cp_cli (in the lane):
   the serve CLI with ``--context-parallel`` under ``torch.distributed.run``
   on serve_weights' directory (its bucket snap keeps the ring out of reach);
18. train_dp (in the lane): T1's config through the train CLI under
   ``torch.distributed.run`` (one NCCL rank; this script's ``train-rank``
   mode wraps ``train.cli.main`` to record each step), 2 steps with
   ``trainer.parallel: dp`` (losses bit-equal to T1's) and 2 with ``fsdp``
   (within 1e-3) at once, then the FSDP checkpoint resumed for a third;
   train_dp2: two ranks sharing the card over gloo, ``dp``, a bucket batch
   of 2, 2 steps: trainables and losses bit-equal on both ranks.
19. the model axis (tensor parallelism of the agent's LLaMA): int4_matmul_tp
   (after phase 5): B6 at a model rank's ten layer shapes at tp = 2 and 4
   against its plain twin, with times, bounds and a rank's B6 a token;
   model_axis (after serve_agent): serve_agent's int4 LLaMA cut on the card
   into 2 and 4 ranks' shard sets run in one process by
   ``parallel.tensor.model_axis_schedule`` (83-token prefill, 16 decode
   steps fed the unsharded ids): logits within 2e-2 of the unsharded, B6
   281 x tp a token, each rank's device ms a token beside its bound;
   serve_agent_tp (in the lane): ``generate`` of an 8-layer
   SEED-X-width int4 agent cut over two gloo ranks sharing the card under
   ``torch.distributed.run`` (an 83-token prompt ending with ``<img>``: the
   forced ladder to ``</img>``, then 32 free tokens): ids and
   ``img_gen_feat`` against the unsharded agent on each rank, B6 57 a token,
   half the KV cache; train_mllm_tp (after the lane's waves): two stage-3
   SGD steps on a ``(data=1, model=2)`` mesh of two more gloo ranks (full
   SDXL, a 4-layer SEED-X-width bf16 LLaMA with fp32 LoRA r 64) against the
   one-process step (losses, first gradients, the trainables' move),
   replicated trainables bit-equal across the ranks (the seconds of both
   are host round trips, contended by what runs beside them);
   train_mllm_fsdp: T3's config with ``trainer.parallel: fsdp`` through the
   train CLI in this process as one NCCL rank, 2 steps at T3's depth
   against T3's losses, a whole-tensor checkpoint;
20. qwen_visual: the Qwen-VL tower with attention pooling at Qwen-VL's
   visual widths, 2 layers, bf16 on the card against fp32 on the CPU;
21. attention_chunked and attention_single (after phase 16, before serve):
   the attention experiments of ``tools/`` (B7, ``chunked_attention``, at
   chunks 64, 128, 256 and 512; B8, ``single_pass_attention``, at block_q
   512) at (2, 20, 1024, 64) and (2, 10, 4096, 64), and B7 at chunk 512 at
   (2, 10, 16384, 64), where B8 must refuse, q, k and v apart: each entry
   once a shape with the counts from 0 (the path), then each kernel against
   its plain twin and against B1 (max abs 4e-3,
   relative Frobenius 5e-3, max|twin| printed beside; two calls bit-equal),
   with times beside the twin, B1, SDPA and the bound.

The kernels' checks (phases 2-5, 10, 13, 16, 21 and int4_matmul_tp) run first,
alone on the card, and give the kernels' times. From serve_weights on, the
paths that run as processes of their own (torchrun ranks) run in a lane
beside the main path (``beside``), in waves that hold 36 GiB of the card
or less at their peaks while the main path holds 25 or less: train_dp's DP
and FSDP runs; the FSDP resume with serve_agent_tp; serve_cp_cli;
train_dp2; each started once the card has its peak and 10 GiB more free
(phase ``beside``: each wave's wait, its end and the card's least free
memory while it ran). The main path checks their records after train_lora
(T1's losses known), then runs train_mllm_tp (46 GiB at its ranks' peaks)
and T3; the references process runs once the waves are done, beside them.
The main path's seconds from serve_weights on are therefore shared with
the lane's (the host's cores and the card).

The kernels' launch counts are set to 0 before each served or trained path
and checked after it (every kernel, every path), and B3's calls by shape
with them (every shape a GN_CASES row; R1, R1 from files, R4 and T1
exactly). Every phase line carries ``at_s``, the seconds since the start. Then the
kernels line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Needs one CUDA device; imports nothing of JAX.
``python3 chip_smoke.py train-rank OUT ARGS...`` is the rank of a train CLI
run that train_dp and train_dp2 start under
``torch.distributed.run``; ``agent-tp-rank OUT`` and ``train-tp-rank OUT LR``
the ranks of serve_agent_tp and train_mllm_tp; ``references`` phases 6, 11
and 14.
"""

from __future__ import annotations

import contextlib
import gc
import json
import pathlib
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
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


STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``at_s``), so that phases can be timed from the log."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "groupnorm", "dual", "int4", "chunked",
           "single")


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (B1, B2, B4, B3, B5, B6, B7, B8)."""
    from diffsensei_tpu_torch.ops import chunked_attention as ca
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.ops import int4_matmul as i4
    from diffsensei_tpu_torch.ops import single_pass_attention as sp

    return dict(flash_fwd=fa.launches, flash_dq=fa.bwd_dq_launches,
                flash_dkv=fa.bwd_dkv_launches, groupnorm=gn.launches, dual=dca.launches,
                int4=i4.launches, chunked=ca.launches, single=sp.launches)


def reset_counts() -> None:
    from diffsensei_tpu_torch.ops import chunked_attention as ca
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.ops import int4_matmul as i4
    from diffsensei_tpu_torch.ops import single_pass_attention as sp

    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    gn.launches = dca.launches = i4.launches = ca.launches = sp.launches = 0
    gn.calls.clear()


def gn_calls(before=None) -> dict:
    """B3's calls by (shape, dtype name) since ``before`` (a copy of
    ``groupnorm.calls``), or all of them."""
    from diffsensei_tpu_torch.ops import groupnorm as gn

    now = dict(gn.calls)
    return {k: v - (before or {}).get(k, 0) for k, v in now.items() if v - (before or {}).get(k, 0)}


def check_gn_calls(got: dict, where: str, want: dict | None = None) -> None:
    """Every B3 shape a path launched is a GN_CASES row, so its time is
    measured; with ``want``, the calls by shape are exactly those."""
    unlisted = sorted(str(k) for k in got if k not in GN_SHAPES)
    if unlisted:
        raise AssertionError(f"{where}: B3 shapes missing from GN_CASES: {unlisted}")
    if want is not None and got != want:
        raise AssertionError(f"{where}: B3 calls by shape {got} != expected {want}")


def since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in KERNELS}


def expect(**counts) -> dict:
    """A full launch-count dict: the kernels not named launched 0 times."""
    return {k: counts.get(k, 0) for k in KERNELS}


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
# B3's shapes: every (shape, dtype, eps) that the served and trained paths
# launch (the full-width modules run on the meta device give the same list),
# with the calls a request of R1 makes at each (20 UNet forwards on the CFG
# batch of 2, then the decode; R3 and R4 make the same) and a step of T1 (the
# UNet forward at batch 1 and its remat replay, then the VAE encoder). R2's
# shapes (the 768x1344 UNet and its two 96x96 decode tiles) and the gpu
# tests' ragged shapes count 0 in both.
GN_CASES = [  # (shape, dtype name, eps, calls a request of R1, calls a step of T1)
    ((2, 128, 128, 320), "bfloat16", 1e-5, 140, 0),    # UNet 1024², CFG batch
    ((2, 128, 128, 640), "bfloat16", 1e-5, 40, 0),
    ((2, 128, 128, 960), "bfloat16", 1e-5, 20, 0),
    ((2, 64, 64, 320), "bfloat16", 1e-5, 20, 0),
    ((2, 64, 64, 640), "bfloat16", 1e-5, 120, 0),
    ((2, 64, 64, 960), "bfloat16", 1e-5, 20, 0),
    ((2, 64, 64, 1280), "bfloat16", 1e-5, 20, 0),
    ((2, 64, 64, 1920), "bfloat16", 1e-5, 20, 0),
    ((2, 32, 32, 640), "bfloat16", 1e-5, 20, 0),
    ((2, 32, 32, 1280), "bfloat16", 1e-5, 200, 0),
    ((2, 32, 32, 1920), "bfloat16", 1e-5, 20, 0),
    ((2, 32, 32, 2560), "bfloat16", 1e-5, 40, 0),
    ((1, 128, 128, 512), "float32", 1e-6, 10, 8),      # VAE decoder / encoder
    ((1, 256, 256, 512), "float32", 1e-6, 6, 3),
    ((1, 256, 256, 256), "float32", 1e-6, 0, 1),
    ((1, 512, 512, 512), "float32", 1e-6, 1, 0),
    ((1, 512, 512, 256), "float32", 1e-6, 5, 3),
    ((1, 512, 512, 128), "float32", 1e-6, 0, 1),
    ((1, 1024, 1024, 256), "float32", 1e-6, 1, 0),
    ((1, 1024, 1024, 128), "float32", 1e-6, 5, 4),
    ((1, 128, 128, 320), "bfloat16", 1e-5, 0, 14),     # UNet at batch 1 (T1, T3)
    ((1, 128, 128, 640), "bfloat16", 1e-5, 0, 4),
    ((1, 128, 128, 960), "bfloat16", 1e-5, 0, 2),
    ((1, 64, 64, 320), "bfloat16", 1e-5, 0, 2),
    ((1, 64, 64, 640), "bfloat16", 1e-5, 0, 12),
    ((1, 64, 64, 960), "bfloat16", 1e-5, 0, 2),
    ((1, 64, 64, 1280), "bfloat16", 1e-5, 0, 2),
    ((1, 64, 64, 1920), "bfloat16", 1e-5, 0, 2),
    ((1, 32, 32, 640), "bfloat16", 1e-5, 0, 2),
    ((1, 32, 32, 1280), "bfloat16", 1e-5, 0, 20),
    ((1, 32, 32, 1920), "bfloat16", 1e-5, 0, 2),
    ((1, 32, 32, 2560), "bfloat16", 1e-5, 0, 4),
    ((2, 96, 168, 320), "bfloat16", 1e-5, 0, 0),       # R2: UNet at 768x1344
    ((2, 96, 168, 640), "bfloat16", 1e-5, 0, 0),
    ((2, 96, 168, 960), "bfloat16", 1e-5, 0, 0),
    ((2, 48, 84, 320), "bfloat16", 1e-5, 0, 0),
    ((2, 48, 84, 640), "bfloat16", 1e-5, 0, 0),
    ((2, 48, 84, 960), "bfloat16", 1e-5, 0, 0),
    ((2, 48, 84, 1280), "bfloat16", 1e-5, 0, 0),
    ((2, 48, 84, 1920), "bfloat16", 1e-5, 0, 0),
    ((2, 24, 42, 640), "bfloat16", 1e-5, 0, 0),
    ((2, 24, 42, 1280), "bfloat16", 1e-5, 0, 0),
    ((2, 24, 42, 1920), "bfloat16", 1e-5, 0, 0),
    ((2, 24, 42, 2560), "bfloat16", 1e-5, 0, 0),
    ((1, 96, 96, 512), "float32", 1e-6, 0, 0),         # R2: a 96x96 decode tile
    ((1, 192, 192, 512), "float32", 1e-6, 0, 0),
    ((1, 384, 384, 512), "float32", 1e-6, 0, 0),
    ((1, 384, 384, 256), "float32", 1e-6, 0, 0),
    ((1, 768, 768, 256), "float32", 1e-6, 0, 0),
    ((1, 768, 768, 128), "float32", 1e-6, 0, 0),
    ((3, 7, 9, 96), "bfloat16", 1e-5, 0, 0),           # ragged: 3 channels a group
    ((1, 33, 17, 64), "float32", 1e-6, 0, 0),          # ragged: 2 channels a group
]
GN_SHAPES = {(shape, dtype) for shape, dtype, *_ in GN_CASES}
GN_CALLS_R1 = {(shape, dtype): n for shape, dtype, _, n, _ in GN_CASES if n}
GN_CALLS_T1 = {(shape, dtype): n for shape, dtype, _, _, n in GN_CASES if n}


# B1's outputs against its fp32 twin's: o within FLASH_O_ABS at every element
# and within FLASH_O_REL in relative Frobenius norm, lse within FLASH_LSE_ABS.
# The relative limit lies between sound builds and builds with a planted P V
# fault (tools/torch_kernel_variants.py measures both; PERF.md).
FLASH_O_ABS, FLASH_O_REL, FLASH_LSE_ABS = 2e-2, 5e-3, 1e-3


def flash_readings(o, lse, ro, rlse) -> dict:
    """o's largest error, its error in relative Frobenius norm and its largest
    error over the twin's largest value; lse's largest error."""
    err = o.float() - ro
    return dict(max_abs_err_o=err.abs().max().item(),
                rel_frobenius_o=(err.norm() / ro.norm()).item(),
                rel_max_o=(err.abs().max() / ro.abs().max()).item(),
                max_abs_err_lse=(lse - rlse).abs().max().item())


def flash_agrees(r: dict) -> bool:
    return (r["max_abs_err_o"] <= FLASH_O_ABS and r["rel_frobenius_o"] <= FLASH_O_REL
            and r["max_abs_err_lse"] <= FLASH_LSE_ABS)


def flash_inputs(case, gen, device):
    """q, k, v (bf16 randn) and the bias (0 or -10000 at random, broadcast
    over heads) of a FLASH_CASES row."""
    import torch

    b, h, sq, sk, d, causal, with_bias = case
    mk = lambda s: torch.randn((b, h, s, d), generator=gen, device=device).bfloat16()
    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=device) > 0.3,
                           0.0, -10000.0)
    return q, k, v, bias


def check_flash(device) -> dict:
    """B1 against the fp32 math of its plain twin on the same bf16 inputs
    (``flash_agrees``), two calls bit-equal; the head_dim-64 kernel streams
    128-key tiles at the 4096- and 4032-key rows and 64-key tiles at the
    others. Times beside the twin's and ``F.scaled_dot_product_attention``'s;
    each row's bound counts q, k, v and the bias read once, o and lse written
    once, and 2 products a (query, key) pair."""
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for case in FLASH_CASES:
        b, h, sq, sk, d, causal, with_bias = case
        q, k, v, bias = flash_inputs(case, gen, device)
        call = lambda: fa.flash_attention(q, k, v, bias, causal=causal)
        o, lse = call()
        again = call()
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_ref(q.float(), k.float(), v.float(), bias, causal)
        row = dict(shape=[b, h, sq, sk, d], causal=causal, bias=with_bias,
                   key_tile=(128 if sk > fa.FWD_WIDE_KEYS else 64) if d == 64 else None,
                   **flash_readings(o, lse, ro, rlse),
                   bit_equal=torch.equal(o, again[0]) and torch.equal(lse, again[1]),
                   ms=cuda_ms(call),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_ref(q, k, v, bias, causal)),
                   sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=None if bias is None else bias.bfloat16(),
                       is_causal=causal)),
                   **bound(2 * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
                           + (0 if bias is None else 4 * bias.numel()),
                           4 * b * h * _causal_pairs(sq, sk, causal) * d))
        row["vs_sdpa"] = row["ms"] / row["sdpa_ms"]
        rows.append(row)
        emit({"phase": "flash_attention", **row})
        if not (flash_agrees(row) and row["bit_equal"]):
            raise AssertionError(f"flash_attention disagrees with its plain twin: {row}")
        del q, k, v, bias, o, lse, again, ro, rlse
    main = rows[0]
    return dict(max_abs_err=max(r["max_abs_err_o"] for r in rows), ms=main["ms"],
                plain_ms=main["plain_ms"], library_ms=main["sdpa_ms"],
                **{k: main[k] for k in ("bound_ms", "bound_by")})


def kernels_per_call(fn) -> float | None:
    """Device kernels a call of ``fn`` runs, from ``torch.profiler`` over 4
    calls; None where 6 profiles see no device activity (on the card's
    machine a profile has missed every kernel of a B3 call, and once three
    in a row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = 4
    for attempt in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return sum(e.count for e in kernels) / calls
        time.sleep(0.5 * (attempt + 1))
    return None


def gn_inputs(shape, dtype_name, gen, device):
    """x (randn * 2 + 0.5), scale and bias (randn) of a GN_CASES row, in its dtype."""
    import torch

    dtype = getattr(torch, dtype_name)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=gen, device=device).to(dtype)
    bias = torch.randn(c, generator=gen, device=device).to(dtype)
    return x, scale, bias


def cold_calls(fn, x, copies_bytes: float = 100e6, most: int = 64) -> list:
    """Calls of ``fn`` on distinct copies of x, each keeping its output until
    its next turn, together more bytes than the 50 MB L2 holds (for
    ``cuda_ms``): every call finds its input and its output cold."""
    n = max(1, min(most, -(-int(copies_bytes) // (2 * x.numel() * x.element_size()))))
    xs = [x] + [x.clone() for _ in range(n - 1)]
    outs = [None] * n

    def call(i):
        outs[i] = fn(xs[i])
    return [lambda i=i: call(i) for i in range(n)]


def gn_row(gn, shape, dtype_name, eps, gen, device) -> dict:
    """B3 of the module ``gn`` at one shape against its plain twin (bf16
    allclose 1e-2, fp32 within 1e-4), two calls bit-equal; the plan (route,
    slabs, blocks), the kernels a call from the profiler (1 resident, 2
    streaming), times cold and warm beside the bound, the twin and
    ``F.group_norm`` + ``F.silu``. Raises if it disagrees, if the profiler
    sees no kernel, or if it counts other kernels a call than the plan. An
    older checkout's module with no plan (``tools/torch_groupnorm_probe.py
    --root``) is held to all but the last."""
    import torch
    import torch.nn.functional as F

    x, scale, bias = gn_inputs(shape, dtype_name, gen, device)
    call = lambda x: gn.groupnorm_silu(x, scale, bias, 32, eps)
    got, again = call(x), call(x)
    torch.cuda.synchronize()
    want = gn.groupnorm_silu_ref(x, scale, bias, 32, eps)
    err = (got.float() - want.float()).abs().max().item()
    if x.dtype == torch.bfloat16:
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    else:
        ok = err <= 1e-4
    bit_equal = torch.equal(got, again)
    del got, again, want
    row = dict(shape=list(shape), dtype=dtype_name, eps=eps)
    p = gn.plan(shape, x.dtype, 32, gn._sms(0)) if hasattr(gn, "plan") else None
    if p:
        row.update(route=p.route, vec=p.vec, groups_per_strip=p.groups_per_strip,
                   slabs=p.slabs, blocks=p.blocks, **gn.layout(shape, x.dtype, 32))
    library = lambda x: F.silu(F.group_norm(x.permute(0, 3, 1, 2), 32, scale, bias, eps))
    row.update(kernels_per_call=kernels_per_call(lambda: call(x)),
               max_abs_err=err, ok=ok, bit_equal=bit_equal,
               ms=cuda_ms(cold_calls(call, x)), ms_warm=cuda_ms(lambda: call(x)),
               **bound(2 * x.numel() * x.element_size() + 2 * shape[-1] * scale.element_size(),
                       10 * x.numel()),
               plain_ms=cuda_ms(cold_calls(
                   lambda x: gn.groupnorm_silu_ref(x, scale, bias, 32, eps), x, most=8)),
               library_ms=cuda_ms(cold_calls(library, x, most=8)))
    row["vs_bound"] = row["ms"] / row["bound_ms"]
    del x
    torch.cuda.empty_cache()
    if not (ok and bit_equal):
        raise AssertionError(f"groupnorm_silu disagrees with its plain twin: {row}")
    if row["kernels_per_call"] is None:
        raise AssertionError(f"groupnorm_silu: the profiler saw no device kernel: {row}")
    if p and row["kernels_per_call"] != p.kernels:
        raise AssertionError(f"groupnorm_silu ran {row['kernels_per_call']} kernels a "
                             f"call, its plan {p.kernels}: {row}")
    return row


def check_groupnorm(device) -> dict:
    """B3 at every GN_CASES row (``gn_row``); then ``per_request``: R1's and
    T1's B3 time (calls x cold ms) against their bounds."""
    import torch
    from diffsensei_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for shape, dtype_name, eps, r1_calls, t1_calls in GN_CASES:
        row = dict(calls_r1=r1_calls, calls_t1=t1_calls,
                   **gn_row(gn, shape, dtype_name, eps, gen, device))
        rows.append(row)
        emit({"phase": "groupnorm_silu", **row})

    def per(key):
        return dict(calls=sum(r[key] for r in rows),
                    kernels=sum(r[key] * r["kernels_per_call"] for r in rows),
                    ms=sum(r[key] * r["ms"] for r in rows),
                    bound_ms=sum(r[key] * r["bound_ms"] for r in rows))
    emit({"phase": "per_request", "r1_request": per("calls_r1"), "t1_step": per("calls_t1")})
    main = rows[0]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
                plain_ms=main["plain_ms"], library_ms=main["library_ms"],
                **{k: main[k] for k in ("bound_ms", "bound_by")})


INT4_CASES = [  # (tokens, in, features): the agent's decode projections at T = 1
    (1, 5120, 5120),       # q/k/v/o_proj
    (1, 5120, 13824),      # gate/up_proj (the row in the kernels line)
    (1, 13824, 5120),      # down_proj
    (1, 5120, 32330),      # lm_head, padded to 32512
    (16, 5120, 13824),     # the kernel's largest token count
]
# B6 calls a decode token makes at each T = 1 shape: 40 layers of q, k, v, o
# (5120 -> 5120), gate, up (5120 -> 13824) and down, then lm_head
INT4_CALLS_PER_TOKEN = {(5120, 5120): 160, (5120, 13824): 80, (13824, 5120): 40,
                        (5120, 32330): 1}


def int4_layout() -> dict:
    """B6's registers and spills for each instantiation (from the nvcc log of
    ``int4_matmul.cu``), and at each of INT4_CASES' shapes, for the x the
    served path passes (fp32), its cluster, grid, blocks an SM, clusters
    resident at once and waves; T = 1 with 16-block clusters too."""
    import re
    import torch
    from diffsensei_tpu_torch.ops import _build, int4_matmul as i4

    ptxas, name = {}, None
    log = _build.cuda_library("int4_matmul.cu").with_suffix(".log").read_text()
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E", line)
            name = m and "bpr{}_nt{}_ncol{}_{}".format(
                *m.groups()[:3], "f32" if m.group(4) == "f" else "bf16")
        elif name and ("spill" in line or "registers" in line):
            ptxas.setdefault(name, []).append(line.split(":")[-1].strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {}
    for tokens, in_f, features in INT4_CASES:
        out2 = i4.padded_features(features, in_f, 128) // 2
        for cluster in (0, 16) if tokens == 1 else (0,):
            lay = i4.layout(tokens, torch.float32, out2, cluster)
            lay["waves"] = lay["blocks"] / (sms * lay["blocks_per_sm"])
            lay["cluster_waves"] = (lay["blocks"] / lay["cluster"]
                                    / max(lay["clusters_resident"], 1))
            shapes[f"{tokens},{in_f},{features}@{'cluster16' if cluster else 'picked'}"] = lay
    return dict(ptxas=ptxas, sms=sms, shapes=shapes)


def check_int4(device) -> dict:
    """B6 at INT4_CASES against its plain twin: a bf16-x row at every shape
    (allclose 2e-2 to the bf16-dequant product, relative Frobenius under 2e-2
    to the twin, bit-equal twice) and an fp32-x row at each T = 1 shape (the
    served path's x: the same bits as the bf16-rounded x), each timed beside
    the twin and ``torch.matmul`` on the weight dequantized to bf16; the fp32
    rows also with 16-block clusters. Then per_token: a decode token's B6
    time (calls x ms over the four T = 1 shapes) beside its bound."""
    import torch
    from diffsensei_tpu_torch.ops import int4_matmul as i4

    gen = torch.Generator(device=device).manual_seed(4)
    rows, per_token = [], dict(ms=0.0, bound_ms=0.0, ms_cluster16=0.0)
    for tokens, in_f, features in INT4_CASES:
        padded = i4.padded_features(features, in_f, 128)
        wbytes = in_f * padded // 2 + (in_f // 128) * padded * 4
        copies = min(64, -(-256 * 2**20 // wbytes))
        weights = [(torch.randint(0, 256, (in_f, padded // 2), generator=gen, device=device,
                                  dtype=torch.uint8),
                    (torch.rand((in_f // 128, padded), generator=gen, device=device) + 0.5)
                    / (4.61 * in_f ** 0.5))      # around the served scale: outputs of order 1
                   for _ in range(copies)]
        x32 = torch.randn((tokens, in_f), generator=gen, device=device)
        x = x32.bfloat16()
        packed, scale = weights[0]
        got = i4.int4_decode_matmul(x, packed, scale)
        again = i4.int4_decode_matmul(x, packed, scale)
        torch.cuda.synchronize()
        dense = [i4.dequantize(q, s, torch.bfloat16) for q, s in weights]
        ref = x.float() @ dense[0].float()          # bf16 dequant matmul, fp32 sums
        xf = x.float()
        twin = i4.int4_decode_fallback(xf, packed, scale)
        shape = dict(shape=[tokens, in_f, features], padded=padded, copies=copies,
                     plain_ms=cuda_ms([lambda q=q, s=s: i4.int4_decode_fallback(xf, q, s)
                                       for q, s in weights]),
                     library_ms=cuda_ms([lambda w=w: torch.matmul(x, w) for w in dense]))

        def readings(y, y2):
            return dict(max_abs_err=(y - twin).abs().max().item(),
                        rel_frobenius=((y - twin).norm() / twin.norm()).item(),
                        allclose_bf16=torch.allclose(y, ref, rtol=2e-2, atol=2e-2),
                        bit_equal=torch.equal(y, y2))

        row = dict(x="bfloat16", **shape, **readings(got, again),
                   ms=cuda_ms([lambda q=q, s=s: i4.int4_decode_matmul(x, q, s)
                               for q, s in weights]),
                   **bound(wbytes + 2 * tokens * in_f + 4 * tokens * padded,
                           2 * tokens * in_f * padded))
        todo = [row]
        if tokens == 1:
            got32 = i4.int4_decode_matmul(x32, packed, scale)
            again32 = i4.int4_decode_matmul(x32, packed, scale)
            wide = i4._decode_cuda(x32, packed, scale, cluster=16)
            torch.cuda.synchronize()
            row32 = dict(x="float32", **shape, **readings(got32, again32),
                         equal_to_bf16_x=torch.equal(got32, got),
                         rel_frobenius_cluster16=((wide - twin).norm() / twin.norm()).item(),
                         ms=cuda_ms([lambda q=q, s=s: i4.int4_decode_matmul(x32, q, s)
                                     for q, s in weights]),
                         ms_cluster16=cuda_ms([lambda q=q, s=s: i4._decode_cuda(x32, q, s, 16)
                                               for q, s in weights]),
                         **bound(wbytes + 4 * tokens * in_f + 4 * tokens * padded,
                                 2 * tokens * in_f * padded))
            todo.append(row32)
            calls = INT4_CALLS_PER_TOKEN[(in_f, features)]
            for key in per_token:
                per_token[key] += calls * row32[key]
        for r in todo:
            rows.append(r)
            emit({"phase": "int4_matmul", **r})
            agrees = (r["allclose_bf16"] and r["rel_frobenius"] < 2e-2 and r["bit_equal"]
                      and r.get("equal_to_bf16_x", True)
                      and r.get("rel_frobenius_cluster16", 0.0) < 2e-2)
            if not agrees:
                raise AssertionError(f"int4_decode_matmul disagrees with its plain twin: {r}")
        del weights, dense, twin, ref
        torch.cuda.empty_cache()
    emit({"phase": "int4_layout", **int4_layout()})
    emit({"phase": "int4_matmul", "per_token": per_token,
          "calls_per_token": sum(INT4_CALLS_PER_TOKEN.values())})
    main = next(r for r in rows if r["x"] == "float32" and r["shape"] == [1, 5120, 13824])
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})


FLASH_BWD_CASES = [  # (B, H, Sq, Sk, D, causal, bias)
    (1, 10, 4096, 4096, 64, False, False),   # UNet level 1 at 1024², train batch 1
    (1, 20, 1024, 1024, 64, False, False),   # UNet level 2
] + FLASH_CASES[3:] + [                      # ragged + bias, causal, head_dim 128
    (1, 4, 63, 65, 64, False, False),        # one below / one above the 64-row tile
    (1, 4, 65, 63, 64, True, False),         # the other way round, causal
    (1, 4, 100, 1, 64, False, False),        # a single key
    (1, 4, 300, 40, 64, False, False),       # Sk under one tile, Sq five tiles long
]
UNET_FWD_SHAPES = [(2, 10, 4096), (2, 20, 1024)]   # (B, H, S) at head_dim 64, CFG batch 2
UNET_BWD_SHAPES = [(1, 10, 4096), (1, 20, 1024)]   # the same, train batch 1


def flash_layout() -> dict:
    """The head_dim-64 kernels' registers, stack and spills (from the nvcc
    log of ``flash_attention.cu``): B1 over 64- and 128-key tiles, B2, B4; their
    blocks per SM, threads and shared memory, and their grid and waves at the
    UNet's shapes (B1 at the CFG batch, B2 and B4 at the training batch)."""
    import torch
    from diffsensei_tpu_torch.ops import _build, flash_attention as fa

    tags = (("fwd_64", "hop10fwd_kernelILi64E"), ("fwd_128", "hop10fwd_kernelILi128E"),
            ("dq", "hop13bwd_dq_kernel"), ("dkv", "hop14bwd_dkv_kernel"))
    ptxas, name = {}, None
    log = _build.cuda_library("flash_attention.cu").with_suffix(".log").read_text()
    for line in log.splitlines():
        if "Function properties for" in line:
            name = next((k for k, tag in tags if tag in line), None)
        elif name and ("spill" in line or "registers" in line):
            ptxas.setdefault(name, []).append(line.split(":")[-1].strip())
    occupancy = fa.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {}
    for kernel, occ in occupancy.items():
        for b, h, s in UNET_FWD_SHAPES if kernel.startswith("fwd") else UNET_BWD_SHAPES:
            blocks = -(-s // occ["rows_per_block"]) * h * b
            grids[f"{kernel}@{b},{h},{s},64"] = dict(
                blocks=blocks, waves=blocks / (sms * occ["blocks_per_sm"]))
    return dict(ptxas=ptxas, occupancy=occupancy, sms=sms, grids=grids)


def _causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: every pair, or below the
    diagonal for causal."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def check_flash_bwd(device):
    """B2 (dQ) and B4 (dK/dV) against the fp32 plain twin on the same bf16
    inputs: relative Frobenius error of each gradient at most 2e-2, two calls
    bit-equal. Times beside the twin's and the backward of
    ``F.scaled_dot_product_attention`` (one call that computes dQ, dK and dV
    together); the pair ``flash_attention_bwd`` (B2 then B4) timed as one
    call beside SDPA's backward and the least work of the function (5
    products a pair; q, k, v, o, dO and lse read once, dq, dk, dv written
    once)."""
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
                   pair_ms=cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, bias, o, lse, do,
                                                                  **kw)),
                   pair_bound=bound(2 * (5 * elems_q + 4 * elems_k) + 4 * b * h * sq + bias_bytes,
                                    5 * 2 * pairs * d),
                   # B2 reads q k v o dO lse, writes dQ and delta; 3 products a pair
                   dq_bound=bound(2 * (4 * elems_q + 2 * elems_k) + 8 * b * h * sq + bias_bytes,
                                  3 * 2 * pairs * d),
                   # B4 reads q k v dO lse delta, writes dK dV; 4 products a pair
                   dkv_bound=bound(2 * (2 * elems_q + 4 * elems_k) + 8 * b * h * sq + bias_bytes,
                                   4 * 2 * pairs * d))
        row["pair_vs_sdpa"] = row["pair_ms"] / row["sdpa_bwd_ms"]
        rows.append(row)
        emit({"phase": "flash_attention_bwd", **row})
        # one key: P = 1 and dS = dP - delta vanish, dq and dk are rounding noise
        ok = (errs["dv"] <= 2e-2 and max(abs_err["dq"], abs_err["dk"]) <= 1e-3 if sk == 1
              else max(errs.values()) <= 2e-2)
        if not (ok and bit_equal):
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


DUAL_CASES = [  # (B, H, S, D, text keys, IP keys, bias shape)
    (2, 10, 4096, 64, 77, 80, "b"),    # UNet level 1 at 1024², the CFG batch
    (2, 20, 1024, 64, 77, 80, "b"),    # level 2
    (2, 10, 4032, 64, 77, 80, "b"),    # level 1 of the 768x1344 bucket: an odd q tail
    (2, 20, 1008, 64, 77, 80, "1"),    # level 2 there, a [1, 1, S, 80] broadcast bias
    (2, 10, 4096, 64, 77, 128, "b"),   # the most IP keys B5 takes: its 16-key-tile kernel
]


def dual_inputs(case, gen, device):
    """q, both key/value sets (bf16 randn) and the bias (0 or -10000 at
    random, [B|1, 1, S, IP keys]) of a DUAL_CASES row."""
    import torch

    b, h, sq, d, nt, ni, bias_kind = case
    mk = lambda s: torch.randn((b, h, s, d), generator=gen, device=device).bfloat16()
    q, kt, vt, ki, vi = mk(sq), mk(nt), mk(nt), mk(ni), mk(ni)
    shape = (b if bias_kind == "b" else 1, 1, sq, ni)
    bias = torch.where(torch.rand(shape, generator=gen, device=device) > 0.4, 0.0, -10000.0)
    return q, kt, vt, ki, vi, bias


def check_dual(device) -> dict:
    """B5 against the fp32 math of its plain twin on the same bf16 inputs:
    o_text and o_ip within 2e-2, two calls bit-equal. Times beside the twin's
    and two ``F.scaled_dot_product_attention`` calls (the IP one with the
    bias as a bf16 ``attn_mask``)."""
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca

    gen = torch.Generator(device=device).manual_seed(9)
    rows = []
    for case in DUAL_CASES:
        b, h, sq, d, nt, ni, _ = case
        q, kt, vt, ki, vi, bias = dual_inputs(case, gen, device)
        shape = tuple(bias.shape)
        got = dca.dual_cross_attention(q, kt, vt, ki, vi, bias)
        again = dca.dual_cross_attention(q, kt, vt, ki, vi, bias)
        torch.cuda.synchronize()
        want = dca.dual_cross_attention_ref(q.float(), kt.float(), vt.float(), ki.float(),
                                            vi.float(), bias)
        errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        mask = bias.bfloat16()
        row = dict(shape=[b, h, sq, d], keys=[nt, ni], bias=list(shape),
                   max_abs_err_text=errs[0], max_abs_err_ip=errs[1],
                   bit_equal=all(torch.equal(x, y) for x, y in zip(got, again)),
                   ms=cuda_ms(lambda: dca.dual_cross_attention(q, kt, vt, ki, vi, bias)),
                   plain_ms=cuda_ms(lambda: dca.dual_cross_attention_ref(q, kt, vt, ki, vi,
                                                                         bias)),
                   sdpa_ms=cuda_ms(lambda: (F.scaled_dot_product_attention(q, kt, vt),
                                            F.scaled_dot_product_attention(q, ki, vi,
                                                                           attn_mask=mask))),
                   # q, both key/value sets and the fp32 bias read once, two outputs
                   # written; QK^T and PV over both key sets
                   **bound(2 * b * h * d * (3 * sq + 2 * (nt + ni)) + 4 * bias.numel(),
                           4 * b * h * sq * (nt + ni) * d))
        row["vs_sdpa"] = row["ms"] / row["sdpa_ms"]
        row["occupancy"] = dca.occupancy(b, h, sq, nt, ni, d)
        rows.append(row)
        emit({"phase": "dual_cross_attention", **row})
        if not (max(errs) <= 2e-2 and row["bit_equal"]):
            raise AssertionError(f"dual_cross_attention disagrees with its plain twin: {row}")
        del q, kt, vt, ki, vi, bias, got, again, want, mask
    from diffsensei_tpu_torch.ops import _build
    log = _build.cuda_library("dual_cross_attention.cu").with_suffix(".log").read_text()
    emit({"phase": "dual_layout",
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]})
    main = rows[0]
    return dict(max_abs_err=max(max(r["max_abs_err_text"], r["max_abs_err_ip"]) for r in rows),
                library_ms=main["sdpa_ms"],
                library_call="two scaled_dot_product_attention calls (text; IP with the bias)",
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})


# ---------------------------------------------------------------------------
# the modules on the card against the CPU on a small input
# ---------------------------------------------------------------------------
def check_reference(device) -> None:
    import torch
    from diffsensei_tpu_torch.core.config import UNetConfig, VAEConfig
    from diffsensei_tpu_torch.models.unet import UNetMangaModel
    from diffsensei_tpu_torch.models.vae import AutoencoderKL, tiled_decode
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
        reset_counts()
        got = unet_gpu(**{k: v.to(device) for k, v in cpu_in.items()}).float().cpu()
        torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    launches = launch_counts()
    row = dict(module="unet_320_640_bf16", max_rel_err=rel, bound=5e-2, launches=launches)
    emit({"phase": "reference", **row})
    # 4 cross-attentions with IP tokens (no bias): B5 once each
    if not (rel <= 5e-2 and launches["flash_fwd"] > 0 and launches["groupnorm"] > 0
            and launches["dual"] == 4):
        raise AssertionError(f"UNet on the card disagrees with the CPU: {row}")
    del unet, unet_gpu

    # the SDXL VAE decoder whole, and tiled (6 tiles of 12 at overlap 4)
    vcfg = VAEConfig.sdxl()
    vae = init_flax_like_(AutoencoderKL(vcfg), gen).eval()
    z = torch.tensor(rng.normal(size=(1, 16, 16, 4)), dtype=torch.float32)
    zt = torch.tensor(rng.normal(size=(1, 20, 28, 4)), dtype=torch.float32)
    tiled = lambda x: tiled_decode(vae, x, tile=12, overlap=4)
    with torch.inference_mode():
        want, want_t = vae.decode(z), tiled(zt)
        vae.to(device)
        got, got_t = vae.decode(z.to(device)).cpu(), tiled(zt.to(device)).cpu()
    for module, g, w in (("sdxl_vae_decoder_fp32", got, want),
                         ("sdxl_vae_tiled_decode_fp32", got_t, want_t)):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        row = dict(module=module, shape=list(g.shape), max_rel_err=rel, bound=1e-3)
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


def cut_down_stacks(device, seed: int):
    """The reference training phases' stack, ``(on the CPU in fp32, a copy on
    the card in bf16 with the VAE in fp32)``: SDXL widths and heads with the
    UNet cut to 320/640 channels (1024 tokens at level 1 for a 512² panel),
    the full VAE and Resampler, the text and character encoders at full width
    with 2 layers each; random weights from ``seed``."""
    import copy
    import dataclasses
    import torch
    from diffsensei_tpu_torch.core.config import (
        ResamplerConfig, TextEncoderConfig, UNetConfig, VAEConfig, VisionEncoderConfig)
    from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules

    two = lambda cfg: dataclasses.replace(cfg, num_layers=2)
    configs = dict(
        unet=UNetConfig(block_out_channels=(320, 640), transformer_layers_per_block=(0, 1),
                        layers_per_block=1, mid_transformer_layers=1),
        vae=VAEConfig.sdxl(), text_encoder=two(TextEncoderConfig.clip_l()),
        text_encoder_2=two(TextEncoderConfig.clip_bigg()),
        image_encoder=two(VisionEncoderConfig.clip_vit_h()),
        magi_encoder=two(VisionEncoderConfig.magi_vitmae()), resampler=ResamplerConfig.diffsensei())
    cpu = PipelineModules.build(configs, torch.float32, device="cpu", seed=seed)
    card = copy.deepcopy(cpu)
    for name, mod in card.networks().items():
        mod.to(device=device, dtype=torch.float32 if name == "vae" else torch.bfloat16)
    return cpu, card


def check_reference_train(device) -> None:
    """One stage-2 ``loss_fn`` and its backward on a cut-down SDXL-width
    stack: the UNet of ``check_reference`` (320/640, 1024 tokens at level 1,
    per-block remat) beside the full SDXL VAE and DiffSensei Resampler, the
    text and character encoders at full width with 2 layers each. On the
    card in bf16 with fp32 trainables (kernels B1-B4 on), against the same
    weights, batch and draws on the CPU in fp32. Bounds: the loss within
    2e-2 and the concatenated trainables' gradient within 5e-2 (relative),
    every gradient tensor within 1.5e-1."""
    import torch
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.train import diffusion as td, optim

    cpu, card = cut_down_stacks(device, seed=6)
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
    reset_counts()
    got_loss, got = grads(card, device)
    torch.cuda.synchronize()
    launches = launch_counts()
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
    # 4 self-attentions of 1024 tokens at level 1: B1 forward + remat replay;
    # 4 cross-attentions: B5 forward + remat replay
    if not (row["loss_rel_err"] <= 2e-2 and total <= 5e-2 and per[worst] <= 1.5e-1
            and launches["flash_fwd"] == 8 and launches["flash_dq"] == 4
            and launches["flash_dkv"] == 4 and launches["groupnorm"] > 0
            and launches["dual"] == 8):
        raise AssertionError(f"the stage-2 step on the card disagrees with the CPU: {row}")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def serve(device):
    import torch
    from PIL import Image
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
    # per request: (request, expected launches)
    # per UNet forward on the CFG batch of 2: B1 70 at 1024² (10 at 4096 tokens,
    # 60 at 1024), 10 at 768x1344 (level 2 has 1008 tokens, below 1024);
    # B3 34 (17 resnets x 2); B5 70 with characters (one per cross-attention),
    # 0 without; the VAE decode adds 28 B3 (14 resnets x 2) a tile: one at
    # 1024² (a 128x128 latent, decoded whole), two at 768x1344 (96x168)
    requests = [
        (GenerationRequest(height=1024, width=1024, num_inference_steps=20,
                           guidance_scale=7.5, seed=1, prompt_ids=ids(), **conditioned),
         expect(flash_fwd=20 * 70, groupnorm=20 * 34 + 28, dual=20 * 70)),
        (GenerationRequest(height=768, width=1344, num_inference_steps=4,
                           guidance_scale=7.5, seed=2, prompt_ids=ids(), **conditioned),
         expect(flash_fwd=4 * 10, groupnorm=4 * 34 + 2 * 28, dual=4 * 70)),
        (GenerationRequest(height=1024, width=1024, num_inference_steps=4,
                           guidance_scale=7.5, seed=3, prompt_ids=ids()),
         expect(flash_fwd=4 * 70, groupnorm=4 * 34 + 28)),
    ]
    # warm the cuDNN plans and the caching allocator off the clock
    server.generate(GenerationRequest(height=1024, width=1024, num_inference_steps=1,
                                      prompt_ids=ids(), **conditioned))
    server.generate(GenerationRequest(height=768, width=1344, num_inference_steps=1,
                                      prompt_ids=ids(), **conditioned))
    torch.cuda.synchronize()

    reset_counts()
    for req, want in requests:
        torch.cuda.reset_peak_memory_stats()
        before, calls_before = launch_counts(), gn_calls()
        t0 = time.perf_counter()
        img = server.generate(req)
        if req is requests[0][0]:
            r1 = (req, img)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = since(before)
        check_gn_calls(gn_calls(calls_before), f"serve {req.height}x{req.width}",
                       GN_CALLS_R1 if req is requests[0][0] else None)
        row = dict(height=req.height, width=req.width, steps=req.num_inference_steps,
                   conditioned=bool(req.character_images), seconds=seconds,
                   **panel_row(img, req.height, req.width),
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                   # B3 launches of the decode over the 28 of one tile's decode
                   decode_tiles=(got["groupnorm"] - 34 * req.num_inference_steps) / 28,
                   launches=got)
        emit({"phase": "serve", **row})
        if got != want:
            raise AssertionError(f"launch counts {got} != expected {want} for {row}")
    return launch_counts(), mods, ids, r1


# safetensors dtype names of the tensors the smoke writes
ST_DTYPES = {"float32": "F32", "bfloat16": "BF16"}


def write_safetensors(path, sd) -> None:
    """A state dict as a ``.safetensors`` file without the ``safetensors``
    package: an 8-byte little-endian header length, the JSON header (padded
    to 8 bytes), then each tensor's raw bytes in order."""
    import struct
    import torch

    host = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    header, offset = {}, 0
    for k, t in host.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": ST_DTYPES[str(t.dtype).removeprefix("torch.")],
                     "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in host.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)


PROMPT_WORDS = ["two", "girls", "talk", "on", "a", "rainy", "street", "one", "holds", "an",
                "umbrella", "speech", "bubble", "manga", "panel", "night", "city", "lights"]


def prompt_merges(words=PROMPT_WORDS) -> list:
    """BPE merges that join each of ``words`` left to right into one token."""
    merges = []
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in merges:
                merges.append(pair)
            parts = [parts[0] + parts[1]] + parts[2:]
    return merges


def write_clip_vocab(root, merges, pad_token="<|endoftext|>"):
    """A CLIP tokenizer directory in the released layout: the 256 byte
    symbols (ids 0-255), their ``</w>`` forms (256-511), the tokens of
    ``merges`` in order, then ``<|startoftext|>`` and ``<|endoftext|>``;
    ``special_tokens_map.json`` naming the pad token."""
    from diffsensei_tpu_torch.utils.tokenizer import bytes_to_unicode

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    vocab += list(dict.fromkeys("".join(m) for m in merges if "".join(m) not in vocab))
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (root / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)},
                                                ensure_ascii=False), encoding="utf-8")
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges)
                                     + "\n", encoding="utf-8")
    special = dict(bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                   unk_token="<|endoftext|>", pad_token=pad_token)
    (root / "special_tokens_map.json").write_text(json.dumps(special))
    return root


def artifact_paths(root) -> dict:
    """The component files of the artifact directory at ``root``: the first
    of each component's names in ``utils.load.ARTIFACT_FILES`` (the UNet and
    the Resampler as torch files, the rest as safetensors)."""
    from diffsensei_tpu_torch.utils.load import ARTIFACT_FILES

    return {name: str(root / "image_generator" / files[0])
            for name, files in ARTIFACT_FILES.items()}


def serve_weights(device, mods, r1, root) -> dict:
    """R1's modules written as a released artifact directory under ``root``
    (kept for the train phases), loaded through ``utils.load.load_weights_any``
    into ``PipelineModules.sdxl(init="none")``: every parameter's dtype,
    device and strides those of ``mods``, none left on meta; R1's request
    from the loaded stack bit-equal to R1's panel with R1's launches; then
    the serve CLI once on the directory with a CLIP vocabulary the smoke
    writes (``--tokenizer``), 1024², 20 Euler steps, no characters."""
    import torch
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
    from diffsensei_tpu_torch.serve import cli
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer
    from diffsensei_tpu_torch.utils.load import load_weights_any

    t0 = time.perf_counter()
    for name, path in artifact_paths(root).items():
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        sd = getattr(mods, name).state_dict()
        if path.suffix == ".bin":
            torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)
        else:
            write_safetensors(path, sd)
    write_s = time.perf_counter() - t0
    disk = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loaded = load_weights_any(PipelineModules.sdxl(device=device, init="none"), str(root))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    mismatched, on_meta = [], []
    for name, mod in mods.networks().items():
        got = dict(getattr(loaded, name).named_parameters())
        for k, p in mod.named_parameters():
            q = got[k]
            on_meta += [f"{name}.{k}"] if q.is_meta else []
            if (q.dtype, q.device, q.stride()) != (p.dtype, p.device, p.stride()):
                mismatched.append(f"{name}.{k}")

    req, want = r1
    server = DiffSenseiServer(DiffSenseiPipeline(loaded))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls_before = gn_calls()
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    t0 = time.perf_counter()
    img = server.generate(req)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    segments = torch.cuda.memory_stats()["segment.all.allocated"] - segments
    check_gn_calls(gn_calls(calls_before), "serve_weights", GN_CALLS_R1)
    row = dict(write_s=write_s, load_s=load_s, disk_gb=disk / 1e9,
               load_peak_gib=load_peak, seconds=seconds,
               new_segments=segments, bit_equal_to_r1=bool(np.array_equal(img, want)),
               max_abs_diff_to_r1=float(np.abs(img - want).max()),
               params_checked=sum(1 for m in mods.networks().values() for _ in m.parameters()),
               layout_mismatches=mismatched[:8], on_meta=on_meta[:8],
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=got, **panel_row(img, req.height, req.width))
    emit({"phase": "serve_weights", **row})
    want_counts = expect(flash_fwd=20 * 70, groupnorm=20 * 34 + 28, dual=20 * 70)
    if mismatched or on_meta or not row["bit_equal_to_r1"] or got != want_counts:
        raise AssertionError(f"the loaded stack differs from the in-memory one: {row}")
    # the same request again from the built stack, the loaded one, the built
    # one: the loaded stack's time against the built one's in one phase, and
    # the allocator's new segments (cudaMalloc) of each
    built = DiffSenseiServer(DiffSenseiPipeline(mods))
    for leg, srv in (("built", built), ("loaded", server), ("built", built)):
        before, segments = launch_counts(), torch.cuda.memory_stats()["segment.all.allocated"]
        t0 = time.perf_counter()
        img = srv.generate(req)
        torch.cuda.synchronize()
        row = dict(leg=leg, seconds=time.perf_counter() - t0,
                   new_segments=torch.cuda.memory_stats()["segment.all.allocated"] - segments,
                   bit_equal_to_r1=bool(np.array_equal(img, want)), launches=since(before))
        emit({"phase": "serve_weights_again", **row})
        if not row["bit_equal_to_r1"] or row["launches"] != want_counts:
            raise AssertionError(f"a repeated request differs from R1: {row}")
    del server, built, loaded
    gc.collect()
    torch.cuda.empty_cache()

    # the serve CLI on the same directory, with tokenizer files
    write_clip_vocab(root / "tokenizer", prompt_merges())
    out = root / "cli_panel.png"
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    paths = cli.main(["--preset", "sdxl", "--weights", str(root), "--tokenizer",
                      str(root / "tokenizer"), "--prompt",
                      "two girls talk on a rainy street, one holds an umbrella",
                      "--height", "1024", "--width", "1024", "--steps", "20",
                      "--out", str(out)])
    torch.cuda.synchronize()
    cli_launches = since(before)
    from PIL import Image

    panel = np.asarray(Image.open(out))
    row = dict(seconds=time.perf_counter() - t0, paths=paths, shape=list(panel.shape),
               mean=float(panel.mean()), std=float(panel.std()),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=cli_launches)
    emit({"phase": "serve_weights_cli", **row})
    gc.collect()
    torch.cuda.empty_cache()
    if panel.shape != (1024, 1024, 3) or cli_launches != expect(flash_fwd=20 * 70,
                                                               groupnorm=20 * 34 + 28):
        raise AssertionError(f"the serve CLI's panel or launches are wrong: {row}")
    return launch_counts()


def panel_row(img, height: int, width: int) -> dict:
    """The serve gate's readings of a panel; raises unless it is finite, in
    [0, 1] and of the bucket's shape."""
    row = dict(shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               min=float(img.min()), max=float(img.max()), mean=float(img.mean()),
               std=float(img.std()))
    if img.shape != (1, height, width, 3) or not row["finite"] \
            or row["min"] < 0.0 or row["max"] > 1.0:
        raise AssertionError(f"bad panel: {row}")
    return row


def psnr(got, want, peak: float | None = None) -> float:
    """10 log10(peak^2 / MSE) in float64; ``peak`` defaults to the range of
    ``want`` (latent PSNR, as the JAX package's ``tools/bench_unet_int8.py``),
    images use 1.0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mse = float(np.mean((got - want) ** 2))
    peak = float(want.max() - want.min()) if peak is None else peak
    return float("inf") if mse == 0 else 10.0 * np.log10(peak**2 / mse)


class LatentTap:
    """Keeps the final latents of every request: wraps the pipeline module's
    ``_decode``, whose argument they are. Use as a context manager."""

    def __enter__(self):
        from diffsensei_tpu_torch.pipelines import pipeline

        self.module, self.decode, self.latents = pipeline, pipeline._decode, []

        def decode(vae, latents, scaling):
            self.latents.append(latents.float().cpu().numpy())
            return self.decode(vae, latents, scaling)
        pipeline._decode = decode
        return self

    def __exit__(self, *exc):
        self.module._decode = self.decode


# the legs of serve_extras on R1's request (1024², CFG 7.5): (name, scheduler,
# steps, DeepCache interval, conditioned, int8 UNet, expected launches). A full
# UNet step runs B1 70, B3 34, B5 70 (B5 only with characters); a cached step at
# split 2 runs levels 0 and 1 only: 10 resnets (B3 20) and 10 transformer layers
# at 4096 tokens (B1 10, B5 10); the decode adds B3 28.
def _legs():
    def counts(steps, interval, conditioned):
        full = len(range(0, steps, interval or 1))
        cached = steps - full
        b1 = 70 * full + 10 * cached
        return expect(flash_fwd=b1, groupnorm=34 * full + 20 * cached + 28,
                      dual=b1 if conditioned else 0)
    legs = [("ddim_4_unconditioned", "ddim", 4, None, False, False),
            ("dpmpp_12", "dpmsolver++", 12, None, True, False),
            ("euler_20_deepcache_2", "euler_discrete", 20, 2, True, False),
            ("euler_20_deepcache_3", "euler_discrete", 20, 3, True, False),
            ("dpmpp_12_deepcache_2", "dpmsolver++", 12, 2, True, False),
            ("euler_20_int8", "euler_discrete", 20, None, True, True)]
    return [(*leg, counts(leg[2], leg[3], leg[4])) for leg in legs]


def serve_extras(device, mods, r1) -> dict:
    """The serving extras through ``DiffSenseiServer.generate`` on R1's
    modules and request (its ids, characters, boxes and seed): DDIM,
    DPM-Solver++ 2M, DeepCache at N = 2 and 3 (split 2), DPM++ with DeepCache,
    and the int8 UNet. R1's exact panel is made again first as the reference.
    The int8 UNet (``quantize_unet``) is made just before its leg, and the
    bf16 UNet waits on the host while that leg runs, so each leg's peak is its
    own stack's; both come back as they were after it. One line a leg:
    seconds, peak memory, the launch counts (checked exactly), the serve
    gate, and latent and image PSNR against R1's exact panel (and the DPM++
    preview against DPM++ 12), reported and not gated."""
    import dataclasses
    import torch
    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.models.quant_unet import quantize_unet, tree_bytes
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer

    base_req, r1_img = r1
    unconditioned = dataclasses.replace(base_req, character_images=(), ip_bbox=(),
                                        dialog_bbox=())

    def server(scheduler, unet=None):
        m = mods if unet is None else dataclasses.replace(mods, unet=unet)
        return DiffSenseiServer(DiffSenseiPipeline(m, PipelineConfig(scheduler=scheduler)))

    def warm(srv, **knobs):
        """A 2-step request off the clock (a new program shape: the DeepCache
        calls, the int8 UNet); returns its launches, which the path's totals
        leave out."""
        before = launch_counts()
        srv.generate(dataclasses.replace(base_req, num_inference_steps=2, **knobs))
        torch.cuda.synchronize()
        return since(before)

    with LatentTap() as tap:
        warm(server("euler_discrete"), deep_cache_interval=2)
        reset_counts()
        ref = server("euler_discrete").generate(base_req)
        torch.cuda.synchronize()
        ref_lat = tap.latents[-1]
        emit({"phase": "serve_extras_reference", "equal_to_serve_r1":
              bool(np.array_equal(ref, r1_img)), "launches": launch_counts()})
        panels, warmed = {}, expect()
        for name, scheduler, steps, interval, conditioned, int8, want in _legs():
            int8_unet = None
            if int8:
                t0 = time.perf_counter()
                int8_unet = quantize_unet(mods.unet)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                bf16_bytes, int8_bytes = tree_bytes(mods.unet), tree_bytes(int8_unet)
                host_equal = int8_matches_host(mods.unet, int8_unet)
                emit({"phase": "serve_extras_quantize", "seconds": seconds,
                      "unet_bytes_bf16": bf16_bytes[0], "unet_bytes_int8": int8_bytes[0],
                      "unet_int8_weight_bytes": int8_bytes[1],
                      "bytes_equal_to_host_quantize": host_equal})
                if not all(host_equal.values()):
                    raise AssertionError(f"the int8 UNet made on the card differs from the "
                                         f"host's quantize_kernel: {host_equal}")
                mods.unet.to("cpu")
                gc.collect()
                torch.cuda.empty_cache()
                warmed = warm(server(scheduler, int8_unet))
            req = dataclasses.replace(base_req if conditioned else unconditioned,
                                      num_inference_steps=steps, deep_cache_interval=interval)
            srv = server(scheduler, int8_unet)
            torch.cuda.reset_peak_memory_stats()
            before = launch_counts()
            t0 = time.perf_counter()
            img = srv.generate(req)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = since(before)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_gn_calls(gn_calls(), f"serve_extras {name}")
            lat = tap.latents[-1]
            panels[name] = (img, lat)
            row = dict(leg=name, scheduler=scheduler, steps=steps,
                       deep_cache_interval=interval, deep_cache_split=2 if interval else None,
                       conditioned=conditioned, int8_unet=int8, seconds=seconds,
                       max_memory_allocated_gib=peak, launches=got,
                       **panel_row(img, req.height, req.width))
            if conditioned:
                row.update(latent_psnr_vs_r1_db=psnr(lat, ref_lat),
                           image_psnr_vs_r1_db=psnr(img, ref, 1.0))
            if name == "dpmpp_12_deepcache_2":
                img12, lat12 = panels["dpmpp_12"]
                row.update(latent_psnr_vs_dpmpp_12_db=psnr(lat, lat12),
                           image_psnr_vs_dpmpp_12_db=psnr(img, img12, 1.0))
            if int8:
                row.update(unet_bytes_bf16=bf16_bytes[0], unet_bytes_int8=int8_bytes[0],
                           bf16_unet_on=str(next(mods.unet.parameters()).device))
                del srv, int8_unet
                gc.collect()
                torch.cuda.empty_cache()
                mods.unet.to(device)
            emit({"phase": "serve_extras", **row})
            if got != want:
                raise AssertionError(f"serve_extras {name}: launch counts {got} != {want}")
    del panels
    return {k: v - warmed[k] for k, v in launch_counts().items()}


def int8_matches_host(unet, int8_unet, every: int = 40) -> dict:
    """Whether ``quantize_unet``'s bytes, made on the card, equal the host
    numpy ``quantize_kernel`` (the JAX arithmetic) of the same weights, for
    every ``every``-th quantized projection: ``{module: equal}``."""
    from diffsensei_tpu_torch.models.mllm.quant import quantize_kernel

    weights = dict(unet.named_parameters())
    quantized = dict(int8_unet.named_parameters())
    modules = sorted(k[: -len(".kernel_q")] for k in quantized if k.endswith(".kernel_q"))
    out = {}
    for module in modules[::every] + modules[-1:]:
        q, s = quantize_kernel(np.ascontiguousarray(
            weights[f"{module}.weight"].detach().float().cpu().numpy().T))
        out[module] = bool(np.array_equal(quantized[f"{module}.kernel_q"].cpu().numpy(), q)
                           and np.array_equal(quantized[f"{module}.kernel_scale"].cpu().numpy(),
                                              s))
    return out


def deep_cache_exact(device, mods, r1_req) -> None:
    """DeepCache's exactness on the card at full SDXL width: a 1024² CFG-batch
    UNet forward with ``return_deep`` and one with the returned feature give
    bit-equal noise (split 2 and split 1), with the full and the cached
    call's launches checked; and the interval-1 loop gives the uncached
    loop's latents and panel bit for bit over 2 steps of R1's request."""
    import dataclasses
    import torch
    from diffsensei_tpu_torch.models.unet import attention_levels, level_spatial_shape
    from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer

    unet, cfg = mods.unet, mods.unet.config
    manga = cfg.manga
    g = torch.Generator(device=device).manual_seed(7)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=device)
    boxes = torch.zeros((2, manga.max_num_ips, 4), device=device)
    boxes[1, :2] = torch.tensor([[0.05, 0.1, 0.5, 0.95], [0.5, 0.2, 0.95, 0.9]])
    dialog = torch.zeros((2, manga.max_num_dialogs, 4), device=device)
    dialog[1, 0] = torch.tensor([0.1, 0.02, 0.6, 0.2])
    args = (rnd(2, 128, 128, 4), torch.full((2,), 501.0, device=device),
            rnd(2, 77, cfg.cross_attention_dim).bfloat16(),
            rnd(2, cfg.pooled_projection_dim).bfloat16(),
            torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=device))
    kw = dict(ip_hidden_states=rnd(2, manga.num_context_image_tokens,
                                   cfg.cross_attention_dim).bfloat16(),
              ip_attn_bias={lv: build_ip_attention_bias(
                  boxes, *level_spatial_shape(cfg, 128, 128, lv), manga.num_vision_tokens,
                  manga.num_dummy_tokens) for lv in attention_levels(cfg)},
              ip_scale=0.6, dialog_bbox=dialog)
    full_want = expect(flash_fwd=70, groupnorm=34, dual=70)
    # split 2: levels 0 and 1 (10 resnets, 10 transformer layers at 4096
    # tokens); split 1: level 0 only (2 + 3 resnets, no attention)
    cached_want = {2: expect(flash_fwd=10, groupnorm=20, dual=10), 1: expect(groupnorm=10)}
    rows = []
    with torch.inference_mode():
        for split in (2, 1):
            counts = [launch_counts()]
            full, deep = unet(*args, **kw, return_deep=True, cache_split=split)
            counts.append(launch_counts())
            cached = unet(*args, **kw, deep_feature=deep, cache_split=split)
            counts.append(launch_counts())
            plain = unet(*args, **kw)
            torch.cuda.synchronize()
            full_counts, cached_counts = ({k: b[k] - a[k] for k in KERNELS}
                                          for a, b in zip(counts, counts[1:]))
            rows.append(dict(split=split, deep_shape=list(deep.shape),
                             cached_equal=bool(torch.equal(full, cached)),
                             plain_equal=bool(torch.equal(full, plain)),
                             max_abs_diff=float((full.float() - cached.float()).abs().max()),
                             full_launches=full_counts, cached_launches=cached_counts))
    server = DiffSenseiServer(DiffSenseiPipeline(mods))
    req = dataclasses.replace(r1_req, num_inference_steps=2)
    with LatentTap() as tap:
        exact = server.generate(req)
        once = server.generate(dataclasses.replace(req, deep_cache_interval=1))
    loop = dict(interval_1_panel_equal=bool(np.array_equal(exact, once)),
                interval_1_latents_equal=bool(np.array_equal(*tap.latents)))
    emit({"phase": "deep_cache_exact", "forwards": rows, **loop})
    for r in rows:
        if not (r["cached_equal"] and r["plain_equal"]):
            raise AssertionError(f"DeepCache is not exact on the card: {r}")
        if r["full_launches"] != full_want or r["cached_launches"] != cached_want[r["split"]]:
            raise AssertionError(f"DeepCache launch counts: {r}")
    if not all(loop.values()):
        raise AssertionError(f"the interval-1 loop differs from the uncached loop: {loop}")


EVAL_FRAMES, EVAL_STEPS = 2, 4


def eval_pages(device, mods) -> dict:
    """``MangaEvaluationDataset`` over the pages ``write_mangazero`` writes
    (1024x1024 frames, four characters and two dialog boxes each): two
    frames through ``DiffSenseiServer.generate`` at their bucket with their
    characters' page crops, boxes and dialogs, 4 Euler steps, CFG 7.5, the
    captions hashed to ids (``train.cli.hash_tokenizer``: no tokenizer files).
    Checks: a panel of the bucket's shape, finite, in [0, 1]; exact launches
    (a UNet forward B1 70, B3 34, B5 70; the decode B3 28)."""
    import random
    import torch
    from diffsensei_tpu_torch.data.eval_dataset import MangaEvaluationDataset
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest
    from diffsensei_tpu_torch.train.cli import hash_tokenizer

    server = DiffSenseiServer(DiffSenseiPipeline(mods))
    tok = hash_tokenizer(mods.text_encoder.config.vocab_size)
    manga = mods.manga
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp, pages=EVAL_FRAMES)
        dataset = MangaEvaluationDataset(str(tmp / "annotations.json"), str(tmp),
                                         max_num_ips=manga.max_num_ips,
                                         max_num_dialogs=manga.max_num_dialogs,
                                         rng=random.Random(0))
        items = [dataset[idx] for idx in range(EVAL_FRAMES)]
    reset_counts()
    for idx, item in enumerate(items):
        ids, neg = tok(item["caption"])[None], tok("")[None]
        req = GenerationRequest(
            height=item["height"], width=item["width"], num_inference_steps=EVAL_STEPS,
            guidance_scale=7.5, seed=idx, character_images=item["ip_images"],
            ip_bbox=item["ip_bbox"], dialog_bbox=item["dialog_bbox"],
            prompt_ids=dict(ids=ids, neg_ids=neg, ids_2=ids, neg_ids_2=neg))
        before = launch_counts()
        t0 = time.perf_counter()
        img = server.generate(req)
        torch.cuda.synchronize()
        row = dict(frame=idx, height=req.height, width=req.width,
                   characters=len(item["ip_images"]), dialogs=len(item["dialog_bbox"]),
                   seconds=time.perf_counter() - t0, **panel_row(img, req.height, req.width),
                   launches=since(before))
        emit({"phase": "eval_pages", **row})
        want = expect(flash_fwd=EVAL_STEPS * 70, groupnorm=EVAL_STEPS * 34 + 28,
                      dual=EVAL_STEPS * 70)
        if (req.height, req.width) != (1024, 1024) or row["characters"] < 1 \
                or row["launches"] != want:
            raise AssertionError(f"eval frame {row} (launches expected {want})")
    return launch_counts()


def serve_agent(device, mods, ids, max_new_tokens: int = 500) -> dict:
    """R1 with the SEED-X agent attached: ``ContinuousLVLM`` at ``AgentConfig()``
    width, int4, random weights from seed 0, beside ``mods`` on the card. A
    shorter warm request (the 65-token ladder, 2 steps), then R4 timed with
    every launch count checked: B6 runs 281 times a decode step (40 layers x
    7 projections + lm_head), B1 and B3 as R1."""
    import dataclasses
    import torch
    from PIL import Image
    from diffsensei_tpu_torch.core.config import AgentConfig
    from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec, build_inference_prompt
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
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
    # warm (cuDNN plans, the caching allocator) on a shorter request: the ladder
    # (65 tokens, so that the panel is adapted) and 2 steps
    warm = DiffSenseiServer(server.pipeline, agent=agent, mllm_spec=spec,
                            mllm_max_new_tokens=n_img + 1)
    warm.generate(dataclasses.replace(req, num_inference_steps=2))
    torch.cuda.synchronize()

    calls.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = server.generate(req)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    check_gn_calls(gn_calls(), "serve_agent", GN_CALLS_R1)
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
    want = expect(flash_fwd=20 * 70, groupnorm=20 * 34 + 28, dual=20 * 70,
                  int4=max_new_tokens * (7 * acfg.llm.num_layers + 1))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if not (row["num_gen_imgs"] >= 1 and row["img_gen_feat_finite"] and row["ladder_forced"]
            and row["decode_steps"] == max_new_tokens):
        raise AssertionError(f"the agent's output is wrong: {row}")
    if img.shape != (1, 1024, 1024, 3) or not row["finite"] or row["min"] < 0.0 \
            or row["max"] > 1.0:
        raise AssertionError(f"bad panel: {row}")
    eval_mllm_item(spec, encode, mods.manga)
    profile_decode(device, agent.llm)
    return launches, agent.llm


def eval_mllm_item(spec, encode, manga) -> None:
    """One ``MangaEvalMLLMDataset`` item over a ``write_mangazero`` page with
    the agent's token spec: its prompt ids are the serving prompt of its
    caption, with one comparison slot per image token."""
    import random
    from diffsensei_tpu_torch.data.eval_dataset import MangaEvalMLLMDataset
    from diffsensei_tpu_torch.data.mllm_dataset import build_inference_prompt

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp, pages=1)
        item = MangaEvalMLLMDataset(str(tmp / "annotations.json"), str(tmp), mllm_spec=spec,
                                    max_num_ips=manga.max_num_ips, rng=random.Random(0))[0]
    want = build_inference_prompt(encode(item["caption"]), spec, encode("\n"))
    row = dict(prompt_tokens=int(item["input_ids"].shape[1]),
               cmp_slots=int(item["ids_cmp_mask"].sum()), characters=len(item["ip_images"]),
               height=item["height"], width=item["width"])
    emit({"phase": "eval_mllm_item", **row})
    if not (np.array_equal(item["input_ids"], want["input_ids"])
            and np.array_equal(item["ids_cmp_mask"], want["ids_cmp_mask"])
            and row["cmp_slots"] == spec.num_img_tokens and row["characters"] >= 1):
        raise AssertionError(f"eval MLLM item: {row}")


def peft_llama_names(sd) -> dict:
    """The port's LLaMA state dict under the names of a peft-wrapped HF
    ``LlamaForCausalLM`` (the reference's stage-3 export): ``base_model.model.``
    before the HF names, ``.base_layer.`` in the projections,
    ``lora_A.default``."""
    out = {}
    for k, v in sd.items():
        k = (k.replace(".attn.", ".self_attn.").replace(".input_norm.", ".input_layernorm.")
             .replace(".post_norm.", ".post_attention_layernorm.")
             .replace(".base.weight", ".base_layer.weight")
             .replace(".lora_A.weight", ".lora_A.default.weight")
             .replace(".lora_B.weight", ".lora_B.default.weight"))
        out["base_model.model." + (k if k.startswith("lm_head") else "model." + k)] = v
    return out


AGENT_DECODE_STEPS = 8


def agent_weights(device, root, num_layers: int = 2, prompt_len: int = 24) -> dict:
    """A ``num_layers``-layer SEED-X-width agent (LLaMA width 5120, vocab
    32330, the two Qwen resamplers, LoRA r 64 with B drawn at random; bf16,
    random weights) written under ``root`` as ``pytorch_model.bin`` with peft
    LLaMA names, the ``llm.`` / ``input_resampler.`` / ``output_resampler.``
    groups and a ``module.`` prefix (and the resamplers' fixed ``pos_embed``,
    which the loader drops); loaded by the serve CLI's ``--quantize-llm
    --quantize-llm-bits 4`` path (built on the meta device, quantized on the
    host). Checks: the packed int4 weights and scales and every other tensor
    byte-equal to ``quantize_agent`` of the agent in memory; 8 greedy decode
    steps with the same ids as that agent's, B6 launched 7 x layers + 1 times
    a token; the load's peak device memory below the bf16 LLM's bytes."""
    import dataclasses
    import torch
    from diffsensei_tpu_torch.core.config import AgentConfig
    from diffsensei_tpu_torch.models.mllm.llama import LoRADense, init_caches
    from diffsensei_tpu_torch.models.mllm.quant import quantize_agent, quantize_agent_on_host
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.utils.load import agent_entries, load_torch_file, split_agent_ckpt

    # what serve_agent left on the card that only a collection frees
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "agent_weights_collect", "allocated_before_gib": held / 2**30,
          "allocated_after_gib": torch.cuda.memory_allocated() / 2**30})
    acfg = AgentConfig()
    acfg = dataclasses.replace(acfg, llm=dataclasses.replace(acfg.llm, num_layers=num_layers))
    agent = ContinuousLVLM.build(acfg, dtype=torch.bfloat16, device=device, seed=7)
    gen = torch.Generator(device=device).manual_seed(8)
    with torch.no_grad():
        for mod in agent.llm.modules():
            if isinstance(mod, LoRADense) and mod.lora_rank:
                mod.lora_B.weight.normal_(0.0, 0.02, generator=gen)
    llm_bytes = sum(p.numel() * p.element_size() for p in agent.llm.parameters())

    t0 = time.perf_counter()
    ckpt = {f"llm.{k}": v for k, v in peft_llama_names(agent.llm.state_dict()).items()}
    for name in ("input_resampler", "output_resampler"):
        mod = getattr(agent, name)
        ckpt.update({f"{name}.{k}": v for k, v in mod.state_dict().items()})
        ckpt[f"{name}.pos_embed"] = torch.zeros(mod.query.shape)
    path = root / "agent" / "pytorch_model.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({f"module.{k}": v.detach().cpu().contiguous() for k, v in ckpt.items()}, path)
    write_s = time.perf_counter() - t0
    del ckpt

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meta = ContinuousLVLM.build(acfg, dtype=torch.bfloat16, device=device, init="none")
    entries = agent_entries(meta, split_agent_ckpt(load_torch_file(str(path))))
    loaded = quantize_agent_on_host(meta, entries, bits=4, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() - base
    del entries

    want = quantize_agent(agent, bits=4)
    unequal = []
    for name in ("llm", "input_resampler", "output_resampler"):
        w, g = getattr(want, name).state_dict(), getattr(loaded, name).state_dict()
        unequal += [f"{name}.{k}" for k in w if k not in g or w[k].dtype != g[k].dtype
                    or not torch.equal(w[k], g[k])]

    ids = torch.from_numpy(np.random.default_rng(9).integers(3, acfg.llm.vocab_size,
                                                             (1, prompt_len))).to(device)

    def greedy(llm):
        caches = init_caches(acfg.llm, 1, prompt_len + AGENT_DECODE_STEPS, torch.bfloat16,
                             device)
        logits, _, caches = llm(ids, positions=torch.arange(prompt_len, device=device)[None],
                                caches=caches, cache_index=0)
        out = []
        for i in range(AGENT_DECODE_STEPS):
            out.append(logits[0, -1].argmax())
            logits, _, caches = llm(out[-1].view(1, 1), positions=torch.full(
                (1, 1), prompt_len + i, device=device), caches=caches,
                cache_index=prompt_len + i)
        return [int(t) for t in out]

    with torch.inference_mode():
        want_ids = greedy(want.llm)
        reset_counts()
        got_ids = greedy(loaded.llm)
        torch.cuda.synchronize()
    counts = launch_counts()
    row = dict(layers=num_layers, lora_rank=acfg.lora.rank, write_s=write_s,
               disk_gb=path.stat().st_size / 1e9, load_s=load_s,
               load_peak_gib=load_peak / 2**30, bf16_llm_gib=llm_bytes / 2**30,
               int4_llm_gib=sum(p.numel() * p.element_size()
                                for p in loaded.llm.parameters()) / 2**30,
               unequal=unequal[:8], ids=got_ids, ids_equal=got_ids == want_ids,
               launches=counts)
    emit({"phase": "agent_weights", **row})
    # the last decode step's logits are not fed back: 8 steps, 8 B6 forwards after the prefill
    want_counts = expect(int4=AGENT_DECODE_STEPS * (7 * num_layers + 1))
    if unequal or got_ids != want_ids or counts != want_counts or load_peak >= llm_bytes:
        raise AssertionError(f"the agent loaded from its checkpoint is wrong: {row}")
    return counts


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
# per step of T1 (stage 2 at 1024², batch 1 a rank, remat on)
T1_STEP = dict(flash_fwd=140, flash_dq=70, flash_dkv=70, groupnorm=88, dual=140)
T1_LOSSES: list = []          # T1's losses by step, from the train phase


def condition_config(tmp, weights_root, model=None, trainer=None, **groups) -> pathlib.Path:
    """``configs/train/condition.yaml`` with its ``weights:`` group pointed at
    the artifact files of ``serve_weights`` (``init`` left at the sdxl
    default, zeros), the synthetic data paths and the log directory under
    ``tmp``, ``model`` and ``trainer`` entries updated and other groups
    replaced; written to ``tmp/config.yaml``."""
    import yaml

    cfg = yaml.safe_load(pathlib.Path("configs/train/condition.yaml").read_text())
    cfg.update(groups, weights=artifact_paths(weights_root))
    cfg["model"].update(model or {})
    cfg["train_data"].update(ann_path=str(tmp / "annotations.json"), image_root=str(tmp))
    cfg["trainer"].update(trainer or {}, log_dir=str(tmp / "logs"))
    (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))
    return tmp / "config.yaml"


def snapshot_after_overlay(cli, snap, built, mode="new"):
    """Wrap ``cli.apply_ported_weights`` so that the CLI's modules are kept
    and their UNet and Resampler copied to the host just after the weights
    group is applied; returns the original to put back."""
    from diffsensei_tpu_torch.train import optim

    apply = cli.apply_ported_weights

    def capture(modules, weights):
        mods = apply(modules, weights)
        mask = optim.unet_trainable_mask(mods.unet, mode)
        for name, p in mods.unet.named_parameters():   # on the host: no device memory
            snap[("unet", name, mask[name])] = p.detach().cpu()
        for name, p in mods.resampler.named_parameters():
            snap[("resampler", name, True)] = p.detach().cpu()
        built["mods"] = mods
        return mods
    cli.apply_ported_weights = capture
    return apply


def moved_and_frozen(snap, mods) -> dict:
    """Per group, whether each snapshot parameter changed: the UNet's and the
    Resampler's trainables, and the frozen UNet weights."""
    import torch

    moved = {"unet": [], "resampler": [], "frozen_unet": []}
    live = {("unet", n): p for n, p in mods.unet.named_parameters()}
    live.update({("resampler", n): p for n, p in mods.resampler.named_parameters()})
    for (module, name, trains), before in snap.items():
        changed = not torch.equal(live[(module, name)].detach().float().cpu(), before.float())
        moved["frozen_unet" if not trains else module].append(changed)
    return moved


def train(device, weights_root) -> dict:
    """Stage 2 through the port's CLI (``train.cli.main``) on
    ``configs/train/condition.yaml`` at full SDXL width, its ``weights:``
    group pointed at the artifact files ``serve_weights`` wrote (R1's random
    weights; ``init: zeros``, the config's default for sdxl, then the
    overlay), with the synthetic data paths (and the log directory beside
    them) and ``max_train_steps: 6, log_every: 1, checkpoint_every: 3``. Each
    step's loss, seconds, peak memory and kernel launches; step
    ``PROFILED_STEP`` under ``torch.profiler``. Checks: finite losses,
    checkpoints at steps 3 and 6, the trainables moved and the frozen UNet
    weights did not (against a host copy taken after the overlay), the same
    launch counts on every step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffsensei_tpu_torch.train import cli

    snap, built = {}, {}
    rows, prof = [], profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now, launches = time.perf_counter(), since(clock["counts"])
        if step == PROFILED_STEP + 1:
            prof.stop()
            clock["profiled_s"] = now - clock["profile_start"]
        rows.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                         host_s=now - clock["last"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=launches))
        torch.cuda.reset_peak_memory_stats()
        if step == PROFILED_STEP:
            prof.start()
            clock["profile_start"] = time.perf_counter()
        clock.update(last=time.perf_counter(), counts=launch_counts())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp)
        config = condition_config(tmp, weights_root, trainer=dict(
            max_train_steps=TRAIN_STEPS, log_every=1, checkpoint_every=3))

        apply = snapshot_after_overlay(cli, snap, built)
        emit({"phase": "train_start",
              "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30})
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = clock["last"] = time.perf_counter()
        clock["counts"] = launch_counts()
        try:
            state = cli.main(["--config", str(config)], on_step=on_step)
        finally:
            cli.apply_ported_weights = apply
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        totals = launch_counts()
        check_gn_calls(gn_calls(), "train", {k: TRAIN_STEPS * n for k, n in GN_CALLS_T1.items()})
        logged = [json.loads(line) for line in (tmp / "logs" / "metrics.jsonl").read_text()
                  .splitlines()]
        checkpoints = sorted(p.parent.name for p in (tmp / "logs").glob("step-*/ckpt.pt"))

    for row, rec in zip(rows, logged):
        row.update(step_s=rec["time/step_s"], data_s=rec["time/data_s"])
        emit({"phase": "train", **row})
    T1_LOSSES[:] = [r["loss"] for r in rows]
    mods = built.pop("mods")
    moved = moved_and_frozen(snap, mods)
    del snap, mods
    summary = dict(steps=len(rows), seconds=seconds, checkpoints=checkpoints,
                   trainable_tensors=len(state.params),
                   trainable_params=sum(p.numel() for p in state.params.values()),
                   moved_unet=f"{sum(moved['unet'])}/{len(moved['unet'])}",
                   moved_resampler=f"{sum(moved['resampler'])}/{len(moved['resampler'])}",
                   moved_frozen_unet=f"{sum(moved['frozen_unet'])}/{len(moved['frozen_unet'])}",
                   launches=totals)
    emit({"phase": "train_summary", **summary})
    # per step, remat on: B1 70 forward + 70 replayed, B2 and B4 70 each; B3 34 in
    # the UNet forward + 34 replayed + 20 in the VAE encoder; B5 70 + 70 replayed
    want = expect(**T1_STEP)
    if len(rows) != TRAIN_STEPS or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"a bad loss: {rows}")
    if checkpoints != ["step-3", "step-6"]:
        raise AssertionError(f"checkpoints {checkpoints} != step-3, step-6")
    if not (all(moved["unet"]) and all(moved["resampler"]) and not any(moved["frozen_unet"])):
        raise AssertionError(f"trainables did not move or frozen weights did: {summary}")
    if any(r["launches"] != want for r in rows):
        raise AssertionError(f"launch counts per step {[r['launches'] for r in rows]} "
                             f"!= {want}")
    profile_train(prof, clock["profiled_s"], PROFILED_STEP + 1)
    return totals


BF16_STEPS = 2


def train_bf16(device, weights_root) -> dict:
    """Stage 2 as ``train`` runs it (the ``weights:`` group, ``init:
    zeros``) with ``param_dtype: bfloat16``: the trainables are trained in
    bf16 with no fp32 copies. 2 steps, no checkpoint, at a constant rate of
    1e-2: an AdamW step moves a weight by about the rate, and a bf16 weight
    near 1 (the norm scales) keeps its value under a step below half its
    ulp (2^-8), as the config's warmup start (1e-7) is. Checks: finite
    losses, every trainable bf16 and moved, the frozen UNet weights
    bit-equal, the launch counts of a T1 step on each step; reports the
    peak memory."""
    import torch
    from diffsensei_tpu_torch.train import cli

    gc.collect()
    torch.cuda.empty_cache()
    snap, built, rows, clock = {}, {}, [], {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        rows.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                         host_s=time.perf_counter() - clock["last"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=since(clock["counts"])))
        torch.cuda.reset_peak_memory_stats()
        clock.update(last=time.perf_counter(), counts=launch_counts())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp)
        config = condition_config(
            tmp, weights_root, model=dict(param_dtype="bfloat16"),
            trainer=dict(max_train_steps=BF16_STEPS, log_every=1, checkpoint_every=1000),
            optimizer=dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0),
            lr_scheduler=dict(name="constant"))
        apply = snapshot_after_overlay(cli, snap, built)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = clock["last"] = time.perf_counter()
        clock["counts"] = launch_counts()
        try:
            state = cli.main(["--config", str(config)], on_step=on_step)
        finally:
            cli.apply_ported_weights = apply
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    totals = launch_counts()
    for row in rows:
        emit({"phase": "train_bf16", **row})
    mods = built.pop("mods")
    moved = moved_and_frozen(snap, mods)
    dtypes = sorted({str(p.dtype) for p in state.params.values()})
    del snap, mods
    summary = dict(steps=len(rows), seconds=seconds, trainable_dtypes=dtypes,
                   trainable_tensors=len(state.params),
                   trainable_bytes=sum(p.numel() * p.element_size()
                                       for p in state.params.values()),
                   moved_unet=f"{sum(moved['unet'])}/{len(moved['unet'])}",
                   moved_resampler=f"{sum(moved['resampler'])}/{len(moved['resampler'])}",
                   moved_frozen_unet=f"{sum(moved['frozen_unet'])}/{len(moved['frozen_unet'])}",
                   peak_gib=max(r["peak_gib"] for r in rows), launches=totals)
    emit({"phase": "train_bf16_summary", **summary})
    want = expect(flash_fwd=140, flash_dq=70, flash_dkv=70, groupnorm=88, dual=140)
    if len(rows) != BF16_STEPS or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"a bad loss: {rows}")
    if dtypes != ["torch.bfloat16"] or not (all(moved["unet"]) and all(moved["resampler"])
                                            and not any(moved["frozen_unet"])):
        raise AssertionError(f"bf16 trainables did not move or frozen weights did: {summary}")
    if any(r["launches"] != want for r in rows):
        raise AssertionError(f"launch counts per step {[r['launches'] for r in rows]} "
                             f"!= {want}")
    return totals


REMAT_POLICIES = (None, "dots", "attn", "dots_attn", "dots_deepest")
# B1 a T1 step under each policy: attn and dots_attn keep the forward's (o,
# lse) and drop its 70 replays; B2 70, B4 70, B3 88 (resnets: full recompute)
# and B5 140 (not named, as in JAX: replayed) under all five
REMAT_B1 = {None: 140, "dots": 140, "attn": 70, "dots_attn": 70, "dots_deepest": 140}


def remat_launches(policy) -> dict:
    return expect(flash_fwd=REMAT_B1[policy], flash_dq=70, flash_dkv=70, groupnorm=88, dual=140)


def host_copy(params) -> dict:
    return {k: p.detach().to("cpu", copy=True) for k, p in params.items()}


def largest_difference(got: dict, want: dict) -> float:
    """The largest absolute difference between two host copies of the
    trainables (0.0 where bit-equal)."""
    import torch

    return max((0.0 if torch.equal(got[k], w) else float((got[k].float() - w.float()).abs().max()))
               for k, w in want.items())


def train_remat(device, weights_root, tmp) -> tuple:
    """T1 under each named remat policy. The train CLI reads
    ``configs/train/condition.yaml`` as ``train`` writes it, with
    ``model.remat_policy: attn``, builds T1's stack from serve_weights' files
    and takes one step (launches checked); the state before that step, its
    first batch and its generator's seed are kept. From that state, on that
    batch and with those draws, one step under each of None, dots, attn,
    dots_attn and dots_deepest (``UNetMangaModel.enable_remat``): the
    launches exactly ``remat_launches``, the step's seconds, the allocated
    memory at its start, its peak before the optimizer (the forward and
    backward, where the policies differ) and over the step (the first step's
    AdamW moments come last), and the trainables after the step bit-equal
    to the None step's (the CLI's attn step's too). Returns the launch
    totals and what train_proj reuses (modules, frozen stack, stream, the
    trainables put back to their state before the first step)."""
    import torch
    from diffsensei_tpu_torch.train import cli

    gc.collect()
    torch.cuda.empty_cache()
    t1 = {}
    build_models, run_training = cli.build_models, cli.run_training

    def capture_models(*args, **kwargs):
        t1["mods"] = build_models(*args, **kwargs)
        return t1["mods"]

    def capture_run(step_fn, state, batches_from, run_cfg, **kwargs):
        t1.update(step_fn=step_fn, state=state, frozen=kwargs["frozen"],
                  batches_from=batches_from, seed=run_cfg.seed, initial=state.state_dict())
        return run_training(step_fn, state, batches_from, run_cfg, **kwargs)

    def on_step(step, metrics):
        torch.cuda.synchronize()
        t1["cli"] = dict(loss=float(metrics["loss"]), launches=launch_counts(),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         params=host_copy(t1["state"].params))

    write_mangazero(tmp)
    config = condition_config(tmp, weights_root, model=dict(remat_policy="attn"), trainer=dict(
        max_train_steps=1, log_every=1, checkpoint_every=1000))
    cli.build_models, cli.run_training = capture_models, capture_run
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        cli.main(["--config", str(config)], on_step=on_step)
    finally:
        cli.build_models, cli.run_training = build_models, run_training
    totals = launch_counts()
    stream = iter(t1["batches_from"](0))
    batch = next(stream)                   # the CLI step's batch
    stream.close()

    state, unet, rows = t1["state"], t1["mods"].unet, []
    for policy in REMAT_POLICIES:
        state.load_state_dict(t1["initial"])
        unet.enable_remat(policy)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_counts()
        generator = torch.Generator(device=device).manual_seed(t1["seed"])
        t0 = time.perf_counter()
        # the step's own three calls (train/diffusion.py::_make_step), with
        # the peak read before the optimizer allocates its moments
        loss, _ = t1["step_fn"].loss_fn(t1["frozen"], batch, generator)
        loss.backward()
        torch.cuda.synchronize()
        peak_fwd_bwd = torch.cuda.max_memory_allocated()
        state.apply_gradients()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        totals = {k: totals[k] + launches[k] for k in KERNELS}
        after = host_copy(state.params)
        if policy is None:
            ref = after
        row = dict(policy=policy, loss=float(loss), step_s=seconds,
                   memory_allocated_start_gib=start / 2**30,
                   peak_forward_backward_gib=peak_fwd_bwd / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   max_abs_diff_to_none=largest_difference(after, ref), launches=launches)
        rows.append(row)
        emit({"phase": "train_remat", **row})
    cli_row = dict(loss=t1["cli"]["loss"], peak_gib=t1["cli"]["peak_gib"],
                   launches=t1["cli"]["launches"],
                   max_abs_diff_to_none=largest_difference(t1.pop("cli")["params"], ref))
    emit({"phase": "train_remat_cli", "policy": "attn", **cli_row})
    del ref, after
    unet.enable_remat(None)
    state.load_state_dict(t1["initial"])   # T1's trainables, no optimizer moments
    if cli_row["launches"] != remat_launches("attn"):
        raise AssertionError(f"the CLI's attn step launched {cli_row['launches']}")
    for row in rows:
        if row["launches"] != remat_launches(row["policy"]):
            raise AssertionError(f"policy {row['policy']}: launches {row['launches']} != "
                                 f"{remat_launches(row['policy'])}")
        if not np.isfinite(row["loss"]):
            raise AssertionError(f"policy {row['policy']}: a bad loss {row['loss']}")
    differ = [r["policy"] for r in rows if r["max_abs_diff_to_none"] != 0.0]
    if differ or cli_row["max_abs_diff_to_none"] != 0.0:
        raise AssertionError(f"trainables differ from the None step's: policies {differ}, "
                             f"the CLI's attn step by {cli_row['max_abs_diff_to_none']}")
    return totals, t1


PROJ_STEPS = 2


def train_proj(device, t1) -> dict:
    """Stage 2 with the linear IP projection: ``make_stage2_step`` with
    ``Stage2Config(ip_adapter_plus=False)`` (a library call; the CLI, as the
    JAX one, never sets it) on train_remat's modules, its UNet trainables
    and the stream's first two batches, with an ``ImageProjDummyModel`` at
    full width (CLIP-H 1280 and Magi 768 CLS -> 16 tokens of 2048 a
    character, 16 dummy tokens; bf16, fp32 trainables) in place of the
    Resampler (whose trainables stay resident, without moments). 2 steps at
    a constant 1e-4. Checks: finite losses, every
    projection weight moved, the frozen UNet weights bit-equal (checksums),
    T1's launches on each step."""
    import torch
    from diffsensei_tpu_torch.models.projection import ImageProjDummyModel
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.train import optim
    from diffsensei_tpu_torch.train.diffusion import Stage2Config, TrainState, make_stage2_step
    from diffsensei_tpu_torch.utils.init import init_flax_like_

    mods, manga = t1["mods"], t1["mods"].manga
    unet = mods.unet
    proj = ImageProjDummyModel(mods.image_encoder.config.hidden_size,
                               mods.magi_encoder.config.hidden_size,
                               unet.config.cross_attention_dim, manga.num_vision_tokens,
                               manga.num_dummy_tokens, dtype=unet.dtype, device=device)
    init_flax_like_(proj, torch.Generator(device=device).manual_seed(7))
    trainable, _ = optim.partition_params(proj, {k: True for k, _ in proj.named_parameters()})
    params = {k: p for k, p in t1["state"].params.items() if k.startswith("unet.")}
    params.update({f"proj.{k}": p for k, p in trainable.items()})
    state = TrainState(params, optim.make_optimizer(params.values(), 1e-4, weight_decay=1e-2,
                                                    max_grad_norm=1.0))
    step_fn = make_stage2_step(unet, proj, DDPMSchedule(), Stage2Config(
        manga=manga, ip_contrastive="fast", ip_adapter_plus=False))
    named = dict(unet.named_parameters())
    frozen_before = {k: v for k, v in checksums(unet).items() if not named[k].requires_grad}
    proj_before = host_copy({k: p for k, p in params.items() if k.startswith("proj.")})
    generator = torch.Generator(device=device).manual_seed(t1["seed"])
    stream, rows = iter(t1["batches_from"](0)), []
    reset_counts()
    for step in range(1, PROJ_STEPS + 1):
        batch = next(stream)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        metrics = step_fn(state, t1["frozen"], batch, generator)
        torch.cuda.synchronize()
        rows.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                         step_s=time.perf_counter() - t0,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=since(before)))
        emit({"phase": "train_proj", **rows[-1]})
    stream.close()
    totals = launch_counts()
    proj_after = host_copy({k: p for k, p in params.items() if k.startswith("proj.")})
    moved = [not torch.equal(proj_after[k], v) for k, v in proj_before.items()]
    frozen_after = checksums(unet)
    frozen_moved = [k for k, v in frozen_before.items() if frozen_after[k] != v]
    summary = dict(steps=len(rows), proj_params=sum(v.numel() for v in proj_before.values()),
                   moved_proj=f"{sum(moved)}/{len(moved)}",
                   moved_frozen_unet=f"{len(frozen_moved)}/{len(frozen_before)}",
                   launches=totals)
    emit({"phase": "train_proj_summary", **summary})
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"a bad loss: {rows}")
    if not all(moved) or frozen_moved:
        raise AssertionError(f"the projection did not move or frozen weights did: {summary}")
    if any(r["launches"] != remat_launches(None) for r in rows):
        raise AssertionError(f"launch counts per step {[r['launches'] for r in rows]} != "
                             f"{remat_launches(None)}")
    return totals


LORA_STEPS, LORA_RANK = 3, 64


def train_lora(device) -> dict:
    """Stage 2 with UNet LoRA through the port's CLI on
    ``configs/train/condition.yaml``, changed in memory as ``train`` changes
    it and further: ``unet_trained_parameters: lora``, ``lora_rank: 64``,
    ``max_train_steps: 3``, a checkpoint at step 3. Checks: finite losses,
    the checkpoint, only the adapters, the IP projections and the Resampler
    moved while every base UNet weight stayed bit-equal (checksums on the
    host), the same launch counts on every step; then, with the adapters' B
    drawn at random, the merged rank-0 UNet (``quant_unet.merge_lora``)
    against the adapter UNet on one 1024² forward within 5e-2 of its largest
    magnitude (bf16)."""
    import pathlib
    import tempfile
    import torch
    import yaml
    from diffsensei_tpu_torch.models.lora import LoRADense
    from diffsensei_tpu_torch.models.quant_unet import merge_lora
    from diffsensei_tpu_torch.train import cli

    gc.collect()
    torch.cuda.empty_cache()
    before, built = {}, {}
    build_models = cli.build_models

    def capture(*args, **kwargs):
        mods = build_models(*args, **kwargs)
        before["unet"] = checksums(mods.unet, dtype_free=True)
        before["resampler"] = checksums(mods.resampler, dtype_free=True)
        built["mods"] = mods
        return mods

    rows, clock = [], {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                         host_s=now - clock["last"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=since(clock["counts"])))
        torch.cuda.reset_peak_memory_stats()
        clock.update(last=time.perf_counter(), counts=launch_counts())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp)
        cfg = yaml.safe_load(pathlib.Path("configs/train/condition.yaml").read_text())
        cfg.pop("weights")
        cfg["model"].update(init="random", unet_trained_parameters="lora", lora_rank=LORA_RANK)
        cfg["train_data"].update(ann_path=str(tmp / "annotations.json"), image_root=str(tmp))
        cfg["trainer"].update(max_train_steps=LORA_STEPS, log_every=1,
                              checkpoint_every=LORA_STEPS, log_dir=str(tmp / "logs"))
        (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))
        cli.build_models = capture
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = clock["last"] = time.perf_counter()
        clock["counts"] = launch_counts()
        try:
            state = cli.main(["--config", str(tmp / "config.yaml")], on_step=on_step)
        finally:
            cli.build_models = build_models
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        totals = launch_counts()
        check_gn_calls(gn_calls(), "train_lora")
        logged = [json.loads(line) for line in (tmp / "logs" / "metrics.jsonl").read_text()
                  .splitlines()]
        ckpt = sorted((tmp / "logs").glob("step-*/ckpt.pt"))
        saved = torch.load(ckpt[-1], map_location="cpu", weights_only=False, mmap=True)["state"]
        saved_adapters = sum("lora_" in k for k in saved["params"]) if ckpt else 0

    for row, rec in zip(rows, logged):
        row.update(step_s=rec["time/step_s"], data_s=rec["time/data_s"])
        emit({"phase": "train_lora", **row})
    mods = built.pop("mods")
    after = {"unet": checksums(mods.unet, dtype_free=True),
             "resampler": checksums(mods.resampler, dtype_free=True)}
    groups = {"lora_A": [], "lora_B": [], "ip": [], "resampler": [], "base_unet": []}
    for module in ("unet", "resampler"):
        for name, sums in before[module].items():
            group = ("resampler" if module == "resampler" else "lora_A" if "lora_A" in name
                     else "lora_B" if "lora_B" in name else "ip" if "_ip" in name
                     else "base_unet")
            groups[group].append(after[module][name] != sums)
    moved = {k: f"{sum(v)}/{len(v)}" for k, v in groups.items()}

    # merge: B drawn at random (std 0.1: A B moves each weight by about half
    # its own std) so the adapters count, then one forward each; the base UNet
    # with the adapters dropped, a planted wrong merge, must miss the bound
    g = torch.Generator(device=device).manual_seed(11)
    with torch.no_grad():
        for mod in mods.unet.modules():
            if isinstance(mod, LoRADense) and mod.lora_rank:
                mod.lora_B.weight.normal_(0.0, 0.1, generator=g)
    cfg_u, manga = mods.unet.config, mods.unet.config.manga
    rnd = lambda *shape: torch.randn(shape, generator=g, device=device)
    args = (rnd(1, 128, 128, 4), torch.full((1,), 501.0, device=device),
            rnd(1, 77, cfg_u.cross_attention_dim), rnd(1, cfg_u.pooled_projection_dim),
            torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]], device=device))
    ip = rnd(1, manga.num_context_image_tokens, cfg_u.cross_attention_dim)
    with torch.inference_mode():
        adapted = mods.unet(*args, ip_hidden_states=ip).float()
    rel = {}
    for name, model in (("merged", lambda: contextlib.nullcontext(merge_lora(mods.unet))),
                        ("adapters_dropped", lambda: adapters_dropped(mods.unet))):
        with model() as unet, torch.inference_mode():
            out = unet(*args, ip_hidden_states=ip).float()
        rel[name] = ((out - adapted).abs().max() / adapted.abs().max()).item()
        del unet, out
    merge_rel = rel["merged"]
    del mods
    summary = dict(steps=len(rows), seconds=seconds, checkpoints=[p.parent.name for p in ckpt],
                   checkpoint_adapters=saved_adapters, trainable_tensors=len(state.params),
                   trainable_params=sum(p.numel() for p in state.params.values()),
                   moved=moved, merged_rel_err=merge_rel, merged_bound=5e-2,
                   adapters_dropped_rel_err=rel["adapters_dropped"], launches=totals)
    emit({"phase": "train_lora_summary", **summary})
    # a step as T1's, but the 3 resnets before the first adapted layer (down
    # level 0 and the first of level 1) need no backward, so remat replays 28
    # of the UNet's 34 B3 calls: B3 34 + 28 + 20 in the VAE encoder
    want = expect(flash_fwd=140, flash_dq=70, flash_dkv=70, groupnorm=82, dual=140)
    if len(rows) != LORA_STEPS or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"a bad loss: {rows}")
    n_adapters = len(groups["lora_A"]) + len(groups["lora_B"])
    if [p.parent.name for p in ckpt] != [f"step-{LORA_STEPS}"] or saved_adapters != n_adapters:
        raise AssertionError(f"checkpoint or its adapters missing: {summary}")
    if any(groups["base_unet"]) or not (all(groups["lora_B"]) and all(groups["ip"])
                                        and all(groups["resampler"]) and any(groups["lora_A"])):
        raise AssertionError(f"the wrong weights moved: {moved}")
    if any(r["launches"] != want for r in rows):
        raise AssertionError(f"launch counts per step {[r['launches'] for r in rows]} != {want}")
    if not merge_rel <= 5e-2:
        raise AssertionError(f"the merged UNet disagrees with the adapters: {merge_rel}")
    if not rel["adapters_dropped"] > 5e-2:
        raise AssertionError(f"the merge check cannot tell a dropped adapter: {rel}")
    return totals


@contextlib.contextmanager
def adapters_dropped(unet):
    """``unet`` with every adapter's B zeroed while the block runs, so that it
    computes its base weights alone: the merge check's planted fault (a
    merge that lost the adapters)."""
    import torch

    with torch.no_grad():
        saved = [(m.lora_B.weight, m.lora_B.weight.clone()) for m in unet.modules()
                 if getattr(m, "lora_rank", 0)]
        for w, _ in saved:
            w.zero_()
    try:
        yield unet
    finally:
        with torch.no_grad():
            for w, b in saved:
                w.copy_(b)


def profile_train(prof, wall_s: float, step: int, phase: str = "profile_train") -> None:
    """Where one train step's time goes, from the profiler over ``step``:
    device time (kernel time summed), kernels launched, the device's busy
    share, the ten kernels that take the most time."""
    import torch

    events = prof.key_averages()
    # device-side entries only, without the optimizer's annotation ranges,
    # which span kernels counted on their own
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    seen = bool(kernels)     # None below: the profiler saw no device time
    emit({"phase": phase, "step": step, "wall_s": wall_s,
          "device_s": device_us / 1e6 if seen else None,
          "device_busy_share": device_us / 1e6 / wall_s if seen else None,
          "kernels": sum(e.count for e in kernels) if seen else None,
          "top": [dict(name=e.key[:80], ms=e.self_device_time_total / 1e3, count=e.count)
                  for e in top]})


def stage3_batch(manga, agent, hw: int, tokens: int, seed: int = 13):
    """``(batch, draws)`` of one stage-3 step as numpy: an ``hw``² panel, its
    four characters' crops and targets, a dialog box, a ``tokens``-long
    stream of the agent's token spec, the noise and a timestep of 500."""
    from diffsensei_tpu_torch.data.mllm_dataset import build_mllm_token_stream
    from diffsensei_tpu_torch.train import cli

    spec = cli.mllm_token_spec(agent, {})
    stream = build_mllm_token_stream(spec.encode_text("two girls talk on a rainy street"),
                                     spec, [], tokens)
    rng = np.random.default_rng(seed)
    i = manga.max_num_ips
    boxes = np.array([[[0.05, 0.1, 0.45, 0.9], [0.5, 0.1, 0.95, 0.6], [0.5, 0.6, 0.8, 0.95],
                       [0.1, 0.7, 0.3, 0.95]]])[:, :i]
    batch = dict(
        pixel_values=rng.uniform(-1, 1, (1, hw, hw, 3)),
        text_input_ids=rng.integers(1, 49000, (1, 77)),
        text_input_ids_2=rng.integers(1, 49000, (1, 77)),
        ip_pixel_values=rng.normal(size=(1, i, 1, 224, 224, 3)),
        magi_pixel_values=rng.normal(size=(1, i, 1, 224, 224, 3)),
        target_ip_pixel_values=rng.normal(size=(1, i, 224, 224, 3)),
        target_magi_pixel_values=rng.normal(size=(1, i, 224, 224, 3)),
        ip_exists=np.ones((1, i, 1)), ip_bbox=boxes,
        dialog_bbox=np.concatenate([[[[0.1, 0.02, 0.6, 0.2]]],
                                    np.zeros((1, manga.max_num_dialogs - 1, 4))], axis=1),
        original_size=np.array([[hw, hw]]), crop_coords_top_left=np.zeros((1, 2)),
        target_size=np.array([[hw, hw]]),
        **{k: v[None] for k, v in stream.items() if k != "mllm_attention_mask"})
    draws = dict(latent_noise=rng.normal(size=(1, hw // 8, hw // 8, 4)),
                 noise=rng.normal(size=(1, hw // 8, hw // 8, 4)), timesteps=np.array([500]))
    return batch, draws


def as_t(a, dev):
    """A numpy array as a tensor on ``dev``: bool, int64 or float32."""
    import torch

    a = np.asarray(a)
    dtype = {"b": torch.bool, "i": torch.int64}.get(a.dtype.kind, torch.float32)
    return torch.tensor(a, dtype=dtype, device=dev)


def check_reference_train_mllm(device, num_layers: int = 2, tokens: int = 160) -> None:
    """One stage-3 ``loss_fn`` and its backward on a cut-down stack: the
    diffusion stack of ``check_reference_train`` (UNet 320/640 with per-block
    remat; full VAE and Resampler; 2-layer encoders), frozen, beside a
    SEED-X-width agent cut to ``num_layers`` LLaMA layers (hidden 5120, 40
    heads of 128, vocab 32330, LoRA r 64 on all seven projections, per-layer
    remat; the full Qwen resamplers) and a ``tokens``-long stream. On the card
    the LLaMA base is bf16 and the agent's trainables fp32 (kernels B1-B5 on),
    against the same weights (rounded to bf16 on both sides), batch and draws
    on the CPU in fp32. Bounds as ``check_reference_train``: the loss within
    2e-2, the concatenated trainables' gradient within 5e-2 (relative), every
    gradient tensor within 1.5e-1."""
    import dataclasses
    import torch
    from diffsensei_tpu_torch.core.config import AgentConfig, LlamaConfig
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.train import diffusion as td, mllm_step

    cpu, card = cut_down_stacks(device, seed=10)
    acfg = AgentConfig(llm=dataclasses.replace(LlamaConfig.seed_x_13b(), num_layers=num_layers))
    agents = {"cpu": ContinuousLVLM.build(acfg, torch.float32, device="cpu", seed=11),
              "card": ContinuousLVLM.build(acfg, torch.bfloat16, device=device, seed=11)}
    with torch.no_grad():
        for name, p in agents["cpu"].llm.named_parameters():
            if name.endswith("lora_B.weight"):   # nonzero, so that lora_A has a gradient
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(12))
        for cpu_mod, card_mod in zip(agents["cpu"].networks(), agents["card"].networks()):
            for p in cpu_mod.parameters():
                p.copy_(p.bfloat16().float())
            card_mod.load_state_dict(cpu_mod.state_dict())
    manga = cpu.manga
    batch, draws = stage3_batch(manga, agents["cpu"], 512, tokens)

    def grads(mods, agent, dev):
        mods.unet.enable_remat()
        agent.llm.remat = True
        params = mllm_step.agent_trainables(agent)
        step = mllm_step.make_stage3_step(mods.unet, mods.resampler, agent, DDPMSchedule(),
                                          mllm_step.Stage3Config(manga=manga))
        frozen = td.FrozenDiffusionStack(
            vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
            image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder)
        loss, metrics = step.loss_fn(frozen, {k: as_t(v, dev) for k, v in batch.items()},
                                     **{k: as_t(v, dev) for k, v in draws.items()})
        loss.backward()
        return (loss.item(), {k: v.item() for k, v in metrics.items()},
                {k: p.grad.float().cpu() for k, p in params.items()})

    want_loss, want_parts, want = grads(cpu, agents["cpu"], "cpu")
    reset_counts()
    got_loss, got_parts, got = grads(card, agents["card"], device)
    torch.cuda.synchronize()
    launches = launch_counts()
    per = {k: ((got[k] - want[k]).norm() / want[k].norm()).item() for k in want
           if want[k].norm() > 0}
    cat = lambda d: torch.cat([d[k].flatten() for k in want])
    total = ((cat(got) - cat(want)).norm() / cat(want).norm()).item()
    worst = max(per, key=per.get)
    row = dict(module=f"stage3_unet_320_640_llama_{num_layers}_layers_bf16", loss=got_loss,
               loss_cpu=want_loss, loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
               parts=got_parts, parts_cpu=want_parts, grad_rel_frobenius=total,
               worst_tensor=worst, worst_rel_frobenius=per[worst],
               median_rel_frobenius=float(np.median(list(per.values()))),
               trainable_tensors=len(want), zero_gradient_tensors=len(want) - len(per),
               bounds=dict(loss=2e-2, grad=5e-2, tensor=1.5e-1), launches=launches)
    emit({"phase": "reference_train_mllm", **row})
    # 4 self-attentions of 1024 tokens: B1 forward + replay, B2/B4 for the 3
    # whose input depends on the agent (the first block's comes before any IP
    # token); 4 cross-attentions: B5 forward + replay; B3 16 in the UNet
    # forward, 12 replayed (not the 2 resnets before the first IP token), 20
    # in the VAE encoder
    want_launches = expect(flash_fwd=8, flash_dq=3, flash_dkv=3, groupnorm=48, dual=8)
    if not (row["loss_rel_err"] <= 2e-2 and total <= 5e-2 and per[worst] <= 1.5e-1
            and launches == want_launches):
        raise AssertionError(f"the stage-3 step on the card disagrees with the CPU "
                             f"(launches expected {want_launches}): {row}")
    del cpu, card, agents


def checksums(module, dtype_free: bool = False) -> dict:
    """``{name: (sum, sum of squares)}`` of each parameter's bits as int16
    words, computed on the card and kept on the host. ``dtype_free`` reads the
    values as fp32 first, so that a cast without a change of value keeps the
    checksum."""
    import torch

    out = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            t = (p.detach().float() if dtype_free else p.detach()).contiguous().view(-1)
            words = t.view(torch.int16).int()
            out[name] = (int(words.sum(dtype=torch.int64)),
                         int((words * words).sum(dtype=torch.int64)))
    return out


MLLM_STEPS, MLLM_PROFILED_STEP = 4, 3
# then under model.agent.remat_policy: attn; 0 since the data-axis phases
# came (the smoke's time limit), the policy held by tests/test_torch_port_remat.py
MLLM_ATTN_STEPS = 0
T3_LOSSES: list = []          # T3's losses by step, from the train_mllm phase
T3_CKPT_SHAPES: dict = {}     # its step-2 checkpoint's trainables, name -> shape


def train_mllm(device) -> dict:
    """Stage 3 through the port's CLI (``train.cli.main``) on
    ``configs/train/mllm.yaml`` at full SDXL and SEED-X width and depth, with
    four changes: ``init: random``, no ``weights:`` group, the synthetic data
    paths (and the log directory beside them), ``max_train_steps: MLLM_STEPS
    + MLLM_ATTN_STEPS, log_every: 1, checkpoint_every: 2``. After step 4 the
    LLaMA's remat policy becomes ``attn`` (``enable_remat("attn")``, what
    ``model.agent.remat_policy: attn`` sets at the build), so the
    ``MLLM_ATTN_STEPS`` steps after it keep each layer's attention product
    on the stack already built. Each step's losses, seconds, peak memory and
    kernel launches; steps ``MLLM_PROFILED_STEP + 1`` and the last under
    ``torch.profiler``. Checks: finite losses, checkpoints every 2 steps and
    at the last, every trainable group moved, the
    frozen LLaMA base, UNet and Resampler bit-equal (checksums), the same
    launch counts on every step (the LLaMA's 400-token attention is plain
    math under both policies)."""
    import pathlib
    import tempfile
    import torch
    import yaml
    from torch.profiler import ProfilerActivity, profile
    from diffsensei_tpu_torch.train import cli

    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_mllm_start",
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30})
    before, built = {}, {}
    build_models, build_agent = cli.build_models, cli.build_agent

    def capture_models(*args, **kwargs):
        mods = build_models(*args, **kwargs)
        before["unet"], before["resampler"] = checksums(mods.unet), checksums(mods.resampler)
        built["mods"] = mods
        return mods

    def capture_agent(*args, **kwargs):
        agent = build_agent(*args, **kwargs)
        emit({"phase": "train_mllm_build",
              "params": {name: sum(p.numel() for p in m.parameters())
                         for name, m in zip(("llm", "input_resampler", "output_resampler"),
                                            agent.networks())},
              "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30})
        for name, mod in zip(("llm", "input_resampler", "output_resampler"), agent.networks()):
            before[name] = checksums(mod, dtype_free=True)
        built["agent"] = agent
        return agent

    last = MLLM_STEPS + MLLM_ATTN_STEPS
    profiled = {MLLM_PROFILED_STEP + 1: profile(activities=[ProfilerActivity.CPU,
                                                            ProfilerActivity.CUDA]),
                last: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])}
    rows, clock = [], {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now, launches = time.perf_counter(), since(clock["counts"])
        if step in profiled:
            profiled[step].stop()
            clock[step] = now - clock["profile_start"]
        rows.append(dict(step=step, remat_policy=built["agent"].llm.remat_policy,
                         **{k: float(v) for k, v in metrics.items()},
                         host_s=now - clock["last"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=launches))
        torch.cuda.reset_peak_memory_stats()
        if step == MLLM_STEPS:
            built["agent"].llm.enable_remat("attn")
        if step + 1 in profiled:
            profiled[step + 1].start()
            clock["profile_start"] = time.perf_counter()
        clock.update(last=time.perf_counter(), counts=launch_counts())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp)
        cfg = yaml.safe_load(pathlib.Path("configs/train/mllm.yaml").read_text())
        cfg.pop("weights")
        cfg["model"]["init"] = "random"
        cfg["train_data"].update(ann_path=str(tmp / "annotations.json"), image_root=str(tmp))
        cfg["trainer"].update(max_train_steps=last, log_every=1, checkpoint_every=2,
                              log_dir=str(tmp / "logs"))
        (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))

        cli.build_models, cli.build_agent = capture_models, capture_agent
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = clock["last"] = time.perf_counter()
        clock["counts"] = launch_counts()
        try:
            state = cli.main(["--config", str(tmp / "config.yaml")], on_step=on_step)
        finally:
            cli.build_models, cli.build_agent = build_models, build_agent
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        totals = launch_counts()
        check_gn_calls(gn_calls(), "train_mllm")
        logged = [json.loads(line) for line in (tmp / "logs" / "metrics.jsonl").read_text()
                  .splitlines()]
        ckpts = {p.parent.name: p.stat().st_size
                 for p in (tmp / "logs").glob("step-*/ckpt.pt")}

        first = torch.load(tmp / "logs" / "step-2" / "ckpt.pt", mmap=True, map_location="cpu",
                           weights_only=False)["state"]["params"]
        T3_CKPT_SHAPES.update({k: tuple(v.shape) for k, v in first.items()})
        del first

    for row, rec in zip(rows, logged):
        row.update(step_s=rec["time/step_s"], data_s=rec["time/data_s"])
        emit({"phase": "train_mllm", **row})
    T3_LOSSES[:] = [r["loss"] for r in rows]
    mods, agent = built.pop("mods"), built.pop("agent")
    after = {"unet": checksums(mods.unet), "resampler": checksums(mods.resampler)}
    for name, mod in zip(("llm", "input_resampler", "output_resampler"), agent.networks()):
        after[name] = checksums(mod, dtype_free=True)
    trainable = set(state.params)

    def group(net, name):
        if f"{net}.{name}" not in trainable:
            return f"frozen_{net}"
        if net != "llm":
            return net
        for key in ("lora_", "embed_tokens", "lm_head"):
            if key in name:
                return key.rstrip("_")
        return "norm"

    moved = {}
    for net, sums in before.items():
        for name, was in sums.items():
            moved.setdefault(group(net, name), []).append(after[net][name] != was)
    del mods, agent, state
    summary = dict(steps=len(rows), seconds=seconds, checkpoints=sorted(ckpts),
                   checkpoint_bytes=ckpts, trainable_tensors=len(trainable),
                   moved={k: f"{sum(v)}/{len(v)}" for k, v in sorted(moved.items())},
                   launches=totals)
    emit({"phase": "train_mllm_summary", **summary})
    # per step, remat on: B5 70 forward + 70 replayed; B1 70 + 70 replayed; B2
    # and B4 69, every self-attention but the first transformer block's, whose
    # input comes before any IP token and needs no gradient; B3 34 in the UNet
    # forward + 28 replayed (not the 3 resnets before the first cross-attention)
    # + 20 in the VAE encoder; the LLaMA's 400-token attention is plain math
    want = expect(flash_fwd=140, flash_dq=69, flash_dkv=69, groupnorm=82, dual=140)
    losses = ("loss", "loss_diffusion", "loss_lm", "loss_rec")
    if len(rows) != last or not all(np.isfinite(r[k]) for r in rows for k in losses):
        raise AssertionError(f"a bad loss: {rows}")
    if [r["remat_policy"] for r in rows] != [None] * MLLM_STEPS + ["attn"] * MLLM_ATTN_STEPS:
        raise AssertionError(f"remat policies by step {[r['remat_policy'] for r in rows]}")
    want_ckpts = sorted({f"step-{k}" for k in range(2, last + 1, 2)} | {f"step-{last}"})
    if sorted(ckpts) != want_ckpts:
        raise AssertionError(f"checkpoints {sorted(ckpts)} != {want_ckpts}")
    groups = ("lora", "embed_tokens", "lm_head", "norm", "input_resampler", "output_resampler")
    frozen = ("frozen_llm", "frozen_unet", "frozen_resampler")
    if not (all(all(moved[g]) for g in groups) and not any(any(moved[g]) for g in frozen)):
        raise AssertionError(f"trainables did not move or frozen weights did: {summary}")
    if any(r["launches"] != want for r in rows):
        raise AssertionError(f"launch counts per step {[r['launches'] for r in rows]} != {want}")
    for step, prof in profiled.items():
        profile_train(prof, clock[step], step, "profile_train_mllm")
    return totals


def profile_decode(device, llm, prompt_len: int = 83, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` cached decode steps of the
    agent's LLM under ``torch.profiler``; device time a token (kernel time
    summed) beside the host clock, the kernels launched a token, and the
    kernels that take the most device time."""
    import torch
    from diffsensei_tpu_torch.models.mllm.llama import init_caches
    from diffsensei_tpu_torch.utils.observability import profile_trace

    caches = init_caches(llm.config, 1, prompt_len + steps + 1, torch.float32, device)
    tok = torch.full((1, 1), 5, device=device)
    pos = lambda i: torch.full((1, 1), i, device=device)
    trace_dir = pathlib.Path(tempfile.mkdtemp(prefix="diffsensei_trace_"))
    try:
        with torch.inference_mode():
            llm(torch.arange(3, 3 + prompt_len, device=device)[None],
                positions=torch.arange(prompt_len, device=device)[None],
                caches=caches, cache_index=0)
            llm(tok, positions=pos(prompt_len), caches=caches, cache_index=prompt_len)
            torch.cuda.synchronize()
            with profile_trace(str(trace_dir)) as prof:
                t0 = time.perf_counter()
                for i in range(1, steps + 1):
                    llm(tok, positions=pos(prompt_len + i), caches=caches,
                        cache_index=prompt_len + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        trace_bytes = {f.name: f.stat().st_size for f in trace_dir.iterdir()}
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if len(trace_bytes) != 1 or min(trace_bytes.values()) == 0:
        raise AssertionError(f"profile_trace wrote {trace_bytes}")
    events = prof.key_averages()
    # device-side entries only: the operators' own rows repeat their kernels' time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    launch_calls = sum(e.count for e in events if "LaunchKernel" in e.key)
    seen = bool(kernels)     # None below: the profiler saw no device time
    emit({"phase": "profile_decode", "steps": steps,
          "trace_file_bytes": sum(trace_bytes.values()),
          "wall_ms_per_token_profiled": wall / steps * 1e3,
          "device_ms_per_token": device_us / steps / 1e3 if seen else None,
          "device_busy_share": device_us / 1e6 / wall if seen else None,
          "kernels_per_token": sum(e.count for e in kernels) / steps if seen else None,
          "host_launch_calls_per_token": launch_calls / steps,
          "top": [dict(name=e.key[:80], ms_per_token=e.self_device_time_total / steps / 1e3,
                       per_token=e.count / steps) for e in top]})



# ---------------------------------------------------------------------------
# the data axis: the ring, context-parallel serving, DP and FSDP training
# ---------------------------------------------------------------------------
RING_CASES = [  # (B, H, S, D, ranks): 2048² level 1 with CFG at 2, 4 and 8 ranks; 1024² at 4
    (2, 10, 16384, 64, 2), (2, 10, 16384, 64, 4), (2, 10, 16384, 64, 8), (2, 10, 4096, 64, 4)]


def check_ring(device) -> list:
    """The ring's schedule in one process (``ops.ring_attention.ring_schedule``:
    n ranks' chunks on B1 through ``chunk_attention``, merged by
    ``merge_partials`` in the ring's order) against one B1 call over the
    whole sequence: o and lse within B1's limits (``flash_agrees``), n²
    launches. Times of the schedule, of the one B1 call and of
    ``F.scaled_dot_product_attention``; the bound counts q, k, v read once,
    o and lse written once, and 2 products a (query, key) pair."""
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import flash_attention as fa, ring_attention as ra

    gen = torch.Generator(device=device).manual_seed(13)
    rows = []
    for b, h, s, d, n in RING_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=device).bfloat16()
                   for _ in range(3))
        whole_o, whole_lse = fa.flash_attention(q, k, v)
        before = fa.launches
        o, lse = ra.ring_schedule(q, k, v, n, return_lse=True)
        torch.cuda.synchronize()
        launches = fa.launches - before
        row = dict(shape=[b, h, s, d], ranks=n, launches=launches,
                   **flash_readings(o, lse, whole_o.float(), whole_lse),
                   ms=cuda_ms(lambda: ra.ring_schedule(q, k, v, n), reps=5, warmup=1),
                   b1_ms=cuda_ms(lambda: fa.flash_attention(q, k, v), reps=5, warmup=1),
                   sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                   reps=5, warmup=1),
                   **bound(2 * b * h * d * 4 * s + 4 * b * h * s, 4 * b * h * s * s * d))
        row["vs_b1"] = row["ms"] / row["b1_ms"]
        rows.append(row)
        emit({"phase": "ring_attention", **row})
        if launches != n * n or not flash_agrees(row):
            raise AssertionError(f"the ring's schedule disagrees with B1: {row}")
        del q, k, v, whole_o, whole_lse, o, lse
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the attention experiments of tools/: B7 and B8
# ---------------------------------------------------------------------------
EXPERIMENT_SHAPES = [(2, 20, 1024, 64), (2, 10, 4096, 64)]   # UNet levels 2 and 1 at 1024²
EXPERIMENT_LONG = (2, 10, 16384, 64)   # the tools' third shape: B7 at chunk 512, B8 refuses it
EXPERIMENT_ABS = 4e-3                  # max abs error, against the twin and against B1


def experiment_readings(o, ref, b1) -> dict:
    """An experiment's output against its plain twin and against B1: max
    abs and relative Frobenius errors, and max|twin|."""
    def errors(want):
        diff = o.float() - want.float()
        return diff.abs().max().item(), (diff.norm() / want.float().norm()).item()

    err, rel = errors(ref)
    err_b1, rel_b1 = errors(b1)
    return dict(max_abs_err=err, rel_frobenius=rel, max_ref=ref.float().abs().max().item(),
                max_abs_err_vs_b1=err_b1, rel_frobenius_vs_b1=rel_b1)


def experiment_agrees(r: dict) -> bool:
    """Within EXPERIMENT_ABS max abs and FLASH_O_REL relative Frobenius
    error, of the twin and of B1."""
    return (max(r["max_abs_err"], r["max_abs_err_vs_b1"]) <= EXPERIMENT_ABS
            and max(r["rel_frobenius"], r["rel_frobenius_vs_b1"]) <= FLASH_O_REL)


def check_attention_experiment(device, kind: str) -> tuple:
    """B7 (``kind`` "chunked": ``chunked_attention`` at every chunk it takes
    at EXPERIMENT_SHAPES, and at chunk 512 at EXPERIMENT_LONG) or B8
    ("single": ``single_pass_attention`` at block_q 512 at EXPERIMENT_SHAPES,
    and its refusal of EXPERIMENT_LONG), q, k and v drawn apart, as in
    FLASH_CASES; the tools keep the JAX scripts' q = k = v. The path: each
    entry once a shape and variant with the counts from 0, read just after.
    Then each output against the plain twin on the same inputs (B7's holds
    one chunk's scores, B8's one block_q's rows: neither builds the
    [B, H, Sq, Sk] tensor, 21.5 GB at 16384 keys) and against B1: max abs
    error within EXPERIMENT_ABS and relative Frobenius error within
    FLASH_O_REL, a second call bit-equal; each row prints max|twin| beside
    its errors. Times beside the twin, B1
    and ``F.scaled_dot_product_attention``; the bound counts q, k and v read
    once, o written once and 2 products a (query, key) pair. Returns the
    path's launches and the numbers of the kernels line (its main row:
    (2, 10, 4096, 64) at the JAX default, chunk 512 or block_q 512)."""
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import chunked_attention as ca
    from diffsensei_tpu_torch.ops import flash_attention as fa
    from diffsensei_tpu_torch.ops import single_pass_attention as sp

    if kind == "chunked":
        cases = [(s, dict(chunk=c)) for s in EXPERIMENT_SHAPES for c in ca.CHUNKS]
        cases.append((EXPERIMENT_LONG, dict(chunk=512)))
        call, twin = ca.chunked_attention, ca.chunked_attention_ref
    else:
        cases = [(s, dict(block_q=512)) for s in EXPERIMENT_SHAPES]
        call, twin = sp.single_pass_attention, sp.single_pass_attention_ref
    gen = torch.Generator(device=device).manual_seed(16)
    qkvs = {shape: [torch.randn(shape, generator=gen, device=device).bfloat16()
                    for _ in range(3)] for shape in dict.fromkeys(s for s, _ in cases)}
    reset_counts()
    outs = [(qkvs[shape], kw, call(*qkvs[shape], **kw)) for shape, kw in cases]
    torch.cuda.synchronize()
    path = launch_counts()
    if path != expect(**{kind: len(outs)}):
        raise AssertionError(f"attention_{kind}: launches {path}, expected {len(outs)} of {kind}")

    yardsticks = {}
    rows = []
    for qkv, kw, o in outs:
        b, h, s, d = qkv[0].shape
        if s not in yardsticks:
            yardsticks[s] = dict(b1=fa.flash_attention(*qkv)[0],
                                 b1_ms=cuda_ms(lambda: fa.flash_attention(*qkv)),
                                 sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*qkv)))
        ys = yardsticks[s]
        again = call(*qkv, **kw)
        ref = twin(*qkv, **kw)
        torch.cuda.synchronize()
        row = dict(shape=[b, h, s, d], **kw, **experiment_readings(o, ref, ys["b1"]),
                   bit_equal=torch.equal(o, again), ms=cuda_ms(lambda: call(*qkv, **kw)),
                   plain_ms=cuda_ms(lambda: twin(*qkv, **kw), reps=3, warmup=1),
                   b1_ms=ys["b1_ms"], sdpa_ms=ys["sdpa_ms"],
                   **bound(2 * b * h * d * 4 * s, 4 * b * h * s * s * d))
        row["vs_b1"] = row["ms"] / row["b1_ms"]
        rows.append(row)
        emit({"phase": f"attention_{kind}", **row})
        if not (experiment_agrees(row) and row["bit_equal"]):
            raise AssertionError(f"attention_{kind} disagrees with its plain twin or B1: {row}")
        del again, ref
    if kind == "single":     # beyond one cluster's registers: refused, naming the limit
        long = [torch.zeros(EXPERIMENT_LONG, dtype=torch.bfloat16, device=device)] * 3
        try:
            sp.single_pass_attention(*long)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError(f"attention_single took {EXPERIMENT_LONG}, beyond its limit")
        if f"at most {sp.MAX_KEYS} keys" not in refused:
            raise AssertionError(f"attention_single's refusal names no limit: {refused}")
        emit({"phase": "attention_single", "shape": list(EXPERIMENT_LONG), "refused": refused})
        del long
    main = next(r for r in rows if r["shape"][2] == 4096 and r.get("chunk", 512) == 512)
    del qkvs, outs, yardsticks
    torch.cuda.empty_cache()
    return path, dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
                      plain_ms=main["plain_ms"], library_ms=main["sdpa_ms"],
                      **{k: main[k] for k in ("bound_ms", "bound_by")},
                      rows=[{k: r[k] for k in ("shape", "ms", "plain_ms", "b1_ms", "sdpa_ms",
                                                "bound_ms", "max_abs_err", "max_ref")}
                            | ({"chunk": r["chunk"]} if "chunk" in r else {}) for r in rows])


CP_SIDE, CP_STEPS = 2048, 4


def _pb_varint(value: int) -> bytes:
    value &= (1 << 64) - 1              # a negative int32 as protobuf writes it
    out = bytearray()
    while True:
        byte, value = value & 0x7F, value >> 7
        out.append(byte | (0x80 if value else 0))
        if not value:
            return bytes(out)


def _pb_field(number: int, wire: int, value) -> bytes:
    """One protobuf field: a varint (wire 0), a float (5) or bytes (2)."""
    key = _pb_varint(number << 3 | wire)
    if wire == 0:
        return key + _pb_varint(int(value))
    if wire == 5:
        return key + struct.pack("<f", value)
    return key + _pb_varint(len(value)) + value


# SEED-X's 330 added tokens in their order (ids 32000-32329)
SEED_X_ADDED = (["<img>", "</img>"] + [f"<img_{k:05d}>" for k in range(100)]
                + ["<patch>", "</patch>"] + [f"<loc-{k}>" for k in range(224)]
                + ["<box_start>", "<box_end>"])
LLAMA_ALPHABET = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                  ".,!?'\"-:;()")


def llama_pieces(words=PROMPT_WORDS, size: int = 32000, seed: int = 15) -> list:
    """A LLaMA-2-layout piece list of ``size`` (or of the words' pieces where
    they are more) from a numpy seed: ``<unk>``,
    ``<s>``, ``</s>``, the 256 byte pieces, then NORMAL pieces with falling
    scores: each of ``words`` with a ``▁`` in front and its prefixes (the
    highest scores, so that BPE joins each word whole), ``▁▁`` and
    ``▁▁▁▁``, random joins of two pieces without ``▁`` (never across a word),
    and last the single characters. Returns ``(piece, score, type)``
    triples."""
    rng = np.random.default_rng(seed)
    alphabet = ["▁", *LLAMA_ALPHABET]
    normal = []
    for word in words:
        normal += [p for p in ("▁" + word[:k] for k in range(1, len(word) + 1))
                   if p not in normal and len(p) > 1]
    normal += ["▁▁", "▁▁▁▁"]
    seen, pool = set(normal) | set(alphabet), list(alphabet[1:])
    while 3 + 256 + len(normal) + len(alphabet) < size:
        short = [p for p in pool if len(p) <= 4]       # joins of at most 8 characters
        for i, j in rng.integers(0, len(short), (4096, 2)):
            piece = short[i] + short[j]
            if piece not in seen and 3 + 256 + len(normal) + len(alphabet) < size:
                seen.add(piece)
                pool.append(piece)
                normal.append(piece)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces += [(p, -float(i), 1) for i, p in enumerate(normal + alphabet)]
    return pieces


def write_llama_tokenizer(root, pieces, added=SEED_X_ADDED) -> pathlib.Path:
    """A LLaMA tokenizer directory as SEED-X's is laid out: ``tokenizer.model``
    (a sentencepiece BPE ``ModelProto``, protobuf's wire format written by
    hand: the identity normalizer with the dummy prefix, spaces kept, byte
    fallback), ``added_tokens.json`` (``added`` from id ``len(pieces)`` on),
    ``special_tokens_map.json`` and ``tokenizer_config.json`` (``legacy:
    false``, no pad token), as LLaMA-2's released files have them."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    proto = b"".join(_pb_field(1, 2, _pb_field(1, 2, p.encode()) + _pb_field(2, 5, score)
                               + _pb_field(3, 0, kind)) for p, score, kind in pieces)
    trainer = (_pb_field(3, 0, 2) + _pb_field(35, 0, 1) + _pb_field(40, 0, 0)
               + _pb_field(41, 0, 1) + _pb_field(42, 0, 2) + _pb_field(43, 0, -1))
    normalizer = (_pb_field(1, 2, b"identity") + _pb_field(3, 0, 1) + _pb_field(4, 0, 0)
                  + _pb_field(5, 0, 1))
    (root / "tokenizer.model").write_bytes(proto + _pb_field(2, 2, trainer)
                                           + _pb_field(3, 2, normalizer))
    (root / "added_tokens.json").write_text(json.dumps(
        {t: len(pieces) + i for i, t in enumerate(added)}))
    special = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>")
    (root / "special_tokens_map.json").write_text(json.dumps(special))
    (root / "tokenizer_config.json").write_text(json.dumps(
        dict(special, legacy=False, pad_token=None, add_bos_token=True, add_eos_token=False)))
    return root


AGENT_CLI_STEPS = 4
AGENT_CLI_PROMPT = "two girls talk on a rainy street, one holds an umbrella, speech bubble"


def agent_cli(device, root, num_layers: int = 2, max_new_tokens: int = 500) -> dict:
    """The serve CLI's agent panel from files: ``--preset sdxl --weights
    <root>`` (serve_weights' artifact directory and CLIP vocabulary as
    ``--tokenizer`` and ``--tokenizer-2``), ``--agent-weights`` of
    agent_weights' ``num_layers``-layer checkpoint with ``--quantize-llm
    --quantize-llm-bits 4`` (``AgentConfig()`` cut to that depth for the
    call) and ``--mllm-tokenizer`` of ``write_llama_tokenizer`` (32,000
    pieces, SEED-X's 330 added tokens); R4's prompt, characters and boxes at
    1024², ``AGENT_CLI_STEPS`` Euler steps. Checks: the spec's ids where
    SEED-X's layout puts them, the caption's ids the whole words' pieces, the
    ``input_ids`` that reach ``generate`` equal to ``build_inference_prompt``
    over them, exact launches (B6 7 x layers + 1 a decode token; the prefill
    is longer than B6's 16 rows), a finite panel in [0, 1]."""
    import dataclasses
    import torch
    from PIL import Image
    from diffsensei_tpu_torch.core import config as core_config
    from diffsensei_tpu_torch.data.mllm_dataset import build_inference_prompt
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.serve import cli
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer

    tmp = root / "agent_cli"
    t0 = time.perf_counter()
    pieces = llama_pieces()
    tok_dir = write_llama_tokenizer(tmp / "mllm_tokenizer", pieces)
    spec = cli.mllm_spec_from_tokenizer(str(tok_dir))
    write_s = time.perf_counter() - t0
    piece_ids = {p: i for i, (p, _, _) in enumerate(pieces)}
    words = AGENT_CLI_PROMPT.replace(",", " ,").split()
    caption = spec.encode_text(AGENT_CLI_PROMPT)
    layout = (spec.bos_id == 1 and spec.eos_id == 2 and spec.pad_id == 0
              and spec.boi_id == 32000 and spec.eoi_id == 32001
              and list(spec.img_ids) == list(range(32002, 32066))
              and caption == [piece_ids[w if w == "," else "▁" + w] for w in words])
    want = build_inference_prompt(caption, spec, spec.encode_text("\n"))
    rng = np.random.default_rng(4)
    chars = []
    for k in range(2):
        chars.append(tmp / f"char_{k}.png")
        Image.fromarray((rng.random((300, 200, 3)) * 255).astype(np.uint8)).save(chars[-1])
    out = tmp / "panel.png"
    argv = ["--preset", "sdxl", "--weights", str(root), "--tokenizer", str(root / "tokenizer"),
            "--tokenizer-2", str(root / "tokenizer"),
            "--agent-weights", str(root / "agent" / "pytorch_model.bin"), "--quantize-llm",
            "--quantize-llm-bits", "4", "--mllm-tokenizer", str(tok_dir),
            "--prompt", AGENT_CLI_PROMPT, "--height", "1024", "--width", "1024",
            "--steps", str(AGENT_CLI_STEPS), "--char-image", str(chars[0]),
            "--char-image", str(chars[1]), "--ip-bbox", "0.05,0.1,0.5,0.95",
            "--ip-bbox", "0.5,0.2,0.95,0.9", "--dialog-bbox", "0.1,0.02,0.6,0.2",
            "--out", str(out)]

    # record what reaches the agent and when the request starts; the CLI's
    # AgentConfig() cut to the checkpoint's depth
    seen, generate, serve = {}, ContinuousLVLM.generate, DiffSenseiServer.generate
    full = core_config.AgentConfig

    def cut_config():
        acfg = full()
        return dataclasses.replace(acfg, llm=dataclasses.replace(acfg.llm, num_layers=num_layers))

    def timed_generate(agent, input_ids, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = generate(agent, input_ids, *args, **kwargs)
        torch.cuda.synchronize()
        seen.update(input_ids=np.asarray(input_ids), agent_s=time.perf_counter() - t,
                    decode_steps=int(result["output_ids"].shape[1]),
                    num_gen_imgs=result["num_gen_imgs"])
        return result

    def timed_serve(server, req):
        seen["request_at"] = time.perf_counter()
        return serve(server, req)

    ContinuousLVLM.generate, DiffSenseiServer.generate = timed_generate, timed_serve
    core_config.AgentConfig = cut_config
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        paths = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        ContinuousLVLM.generate, DiffSenseiServer.generate = generate, serve
        core_config.AgentConfig = full
    check_gn_calls(gn_calls(), "agent_cli")
    img = np.asarray(Image.open(out)).astype(np.float32)[None] / 255.0
    got_ids = seen.get("input_ids")
    load_s = seen["request_at"] - t0
    row = dict(layers=num_layers, steps=AGENT_CLI_STEPS, pieces=len(pieces),
               added=len(SEED_X_ADDED), tokenizer_write_and_read_s=write_s,
               spec_layout_ok=layout, prompt_tokens=int(want["input_ids"].shape[1]),
               ids_reach_generate=got_ids is not None
               and np.array_equal(got_ids, want["input_ids"]),
               num_gen_imgs=seen.get("num_gen_imgs"), decode_steps=seen.get("decode_steps"),
               seconds=seconds, load_s=load_s, agent_s=seen.get("agent_s"),
               panel_s=seconds - load_s - seen.get("agent_s", 0.0), paths=paths,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, **panel_row(img, 1024, 1024))
    emit({"phase": "agent_cli", **row})
    want_counts = expect(flash_fwd=AGENT_CLI_STEPS * 70, groupnorm=AGENT_CLI_STEPS * 34 + 28,
                         dual=AGENT_CLI_STEPS * 70,
                         int4=max_new_tokens * (7 * num_layers + 1))
    if not (layout and row["ids_reach_generate"] and row["decode_steps"] == max_new_tokens
            and launches == want_counts):
        raise AssertionError(f"the serve CLI's agent panel is wrong (launches expected "
                             f"{want_counts}): {row}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_cp(device, mods, ids) -> dict:
    """Context-parallel serving in a NCCL world of one in this process:
    ``DiffSenseiPipeline(mods, PipelineConfig(context_parallel=True),
    mesh=make_mesh())`` at 2048² with ``snap_to_buckets=False``, 4 Euler
    steps, CFG, R1's two characters and dialog box. Its level-1
    self-attention has 16384 tokens, so the ring takes 10 of the UNet's 70
    B1 calls a forward (one chunk: B1 over the whole sequence). Checks: B1
    4 x 70, B5 4 x 70 and B3 4 x 34 plus 28 for each of the decode's 16
    tiles, exactly; the panel bit-equal to the same request without the
    mesh. The serve CLI's ``--context-parallel`` runs beside the main path
    (``serve_cp_cli``)."""
    import torch
    from PIL import Image
    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.models.vae import tile_plan
    from diffsensei_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer

    env = init_distributed(device)
    mesh = make_mesh(device=device)
    rng = np.random.default_rng(3)
    chars = [Image.fromarray((rng.random((300, 200, 3)) * 255).astype(np.uint8))
             for _ in range(2)]
    base = DiffSenseiPipeline(mods)
    cp = DiffSenseiPipeline(mods, PipelineConfig(context_parallel=True), mesh=mesh)
    server = DiffSenseiServer(base)
    lat_side = CP_SIDE // base.latent_scale
    call = dict(height=CP_SIDE, width=CP_SIDE, num_inference_steps=CP_STEPS,
                guidance_scale=7.5, snap_to_buckets=False, prompt_ids=ids(),
                ip_pixel_values=server._preprocess_characters(chars),
                ip_bbox=[[0.05, 0.1, 0.5, 0.95], [0.5, 0.2, 0.95, 0.9]],
                dialog_bbox=[[0.1, 0.02, 0.6, 0.2]],
                latents=server.initial_latents(7, (1, lat_side, lat_side, 4)))
    tiles = len(tile_plan(lat_side, lat_side))
    want = expect(flash_fwd=CP_STEPS * 70, dual=CP_STEPS * 70,
                  groupnorm=CP_STEPS * 34 + 28 * tiles)
    rows, panels = {}, {}
    reset_counts()
    for leg, pipe in (("replicated", base), ("context_parallel", cp)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        img = pipe(**call).cpu().numpy()
        torch.cuda.synchronize()
        rows[leg] = dict(seconds=time.perf_counter() - t0, launches=since(before),
                         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                         **panel_row(img, CP_SIDE, CP_SIDE))
        panels[leg] = img
        counts = launch_counts() if leg == "context_parallel" else None
    row = dict(side=CP_SIDE, steps=CP_STEPS, ranks=env.world, backend=env.backend,
               ring_calls_a_forward=10, decode_tiles=tiles, **rows["context_parallel"],
               replicated_seconds=rows["replicated"]["seconds"],
               replicated_launches=rows["replicated"]["launches"],
               bit_equal_to_replicated=bool(np.array_equal(panels["context_parallel"],
                                                            panels["replicated"])),
               max_abs_diff=float(np.abs(panels["context_parallel"]
                                         - panels["replicated"]).max()))
    emit({"phase": "serve_cp", **row})
    if (row["launches"] != want or row["replicated_launches"] != want
            or not row["bit_equal_to_replicated"]):
        raise AssertionError(f"context-parallel serving differs: {row}, want {want}")
    del panels, img
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serve_cp_cli(weights_root):
    """Start the serve CLI with ``--context-parallel`` under
    ``torch.distributed.run`` (one rank) on serve_weights' artifact
    directory, at serve_cp's side and steps: it snaps 2048² to 1024², so the
    ring is wired there but not reached. Returns a function that waits for it
    and gives its row (``serve_cp_cli_check`` emits and checks it)."""
    from PIL import Image

    out = weights_root / "cp_panel.png"
    wait = started(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "diffsensei_tpu_torch.serve.cli", "--preset", "sdxl", "--weights",
         str(weights_root), "--tokenizer", str(weights_root / "tokenizer"),
         "--context-parallel", "--prompt", "two girls talk on a rainy street",
         "--height", str(CP_SIDE), "--width", str(CP_SIDE), "--steps", str(CP_STEPS),
         "--out", str(out)], timeout=600)

    def row() -> dict:
        rc, log, seconds = wait()
        panel = np.asarray(Image.open(out)) if out.exists() else None
        return dict(seconds=seconds, rc=rc, shape=None if panel is None else list(panel.shape),
                    note="the server snaps 2048x2048 to its 1024x1024 bucket: the ring is "
                         "wired through the CLI but not taken (min_seq 16384 > 4096 tokens)",
                    log_tail=log[-600:])
    row.stop = wait.stop
    return row


def serve_cp_cli_check(cli_row) -> None:
    emit({"phase": "serve_cp_cli", **cli_row})
    if cli_row["rc"] != 0 or cli_row["shape"] != [1024, 1024, 3]:
        raise AssertionError(f"the serve CLI under --context-parallel failed: {cli_row}")


def bits_digest(tensors) -> list:
    """Two int64 sums (of the int16 words of every tensor's bits, and of
    their squares): equal digests for bit-equal tensors."""
    import torch
    from diffsensei_tpu_torch.parallel.train import local_part

    s1 = s2 = 0
    with torch.no_grad():
        for t in tensors:
            words = local_part(t.detach()).contiguous().view(-1).view(torch.int16).int()
            s1 += int(words.sum(dtype=torch.int64))
            s2 += int((words * words).sum(dtype=torch.int64))
    return [s1, s2]


def recorded_train(args) -> dict:
    """``train.cli.main(args)`` with an ``on_step`` that records each step's
    loss, host seconds, peak memory, kernel launches and a digest of the
    trainables' bits, and after the run a digest of the frozen UNet
    weights."""
    import torch
    import torch.distributed as dist
    from diffsensei_tpu_torch.train import cli

    held, rows = {}, []
    build_models, run_training = cli.build_models, cli.run_training

    def capture_models(*a, **kw):
        held["mods"] = build_models(*a, **kw)
        return held["mods"]

    def capture_run(step_fn, state, batches_from, run_cfg, **kw):
        held["state"] = state
        return run_training(step_fn, state, batches_from, run_cfg, **kw)

    clock = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                         host_s=now - clock["last"], launches=since(clock["counts"]),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         trainables=bits_digest(held["state"].params.values())))
        torch.cuda.reset_peak_memory_stats()
        clock.update(last=time.perf_counter(), counts=launch_counts())

    cli.build_models, cli.run_training = capture_models, capture_run
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = clock["last"] = time.perf_counter()
        clock["counts"] = launch_counts()
        cli.main(args, on_step=on_step)
    finally:
        cli.build_models, cli.run_training = build_models, run_training
    unet = held.pop("mods").unet
    frozen = bits_digest(p for p in unet.parameters() if not p.requires_grad)
    return dict(rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(),
                wall_s=time.perf_counter() - t0, steps=rows, frozen_unet=frozen)


def train_rank(argv) -> int:
    """One rank of a train CLI run under ``torch.distributed.run`` (the
    ``train-rank OUT CLI-ARGS...`` mode of this script): ``recorded_train``,
    its record written as JSON to ``OUT.rank<r>.json``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, args = argv[0], argv[1:]
    rec = recorded_train(args)
    pathlib.Path(f"{out}.rank{rec['rank']}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def stop(proc) -> None:
    """End a launcher and, through its SIGTERM handler, the ranks it started."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()


LIVE: list = []               # every process this script started, for stop_all
LIVE_LOCK = threading.Lock()
STOPPING = threading.Event()


def started(cmd, timeout: float = 900):
    """Start ``cmd`` with its output to a pipe; returns a function that waits
    for it and gives ``(returncode, output, seconds)``, with ``.stop``."""
    with LIVE_LOCK:
        if STOPPING.is_set():
            raise RuntimeError(f"not started, the run is stopping: {cmd}")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        LIVE.append(proc)

    def wait():
        try:
            log = proc.communicate(timeout=timeout)[0]
        finally:
            stop(proc)
        return proc.returncode, log, time.perf_counter() - t0
    wait.stop = lambda: stop(proc)
    return wait


def stop_all() -> None:
    """End every process this script started, and start no more."""
    with LIVE_LOCK:
        STOPPING.set()
        procs = list(LIVE)
    for proc in procs:
        stop(proc)


def wave(recs: dict, **waiting) -> None:
    """Wait for processes started together (``name=waiter``), each result
    into ``recs[name]``; if one fails, the others are ended."""
    try:
        for name, wait in waiting.items():
            recs[name] = wait()
    finally:
        for wait in waiting.values():
            wait.stop()


def torchrun_train(out, nproc: int, config, *extra, timeout: float = 900):
    """Start the train CLI on ``config`` under ``torch.distributed.run`` with
    ``nproc`` ranks on this card, each through ``train_rank``; returns a
    function that waits for it and gives every rank's record."""
    return torchrun_ranks("train-rank", out, nproc, "--config", str(config), *extra,
                          timeout=timeout)


def torchrun_ranks(mode: str, out, nproc: int, *args, timeout: float = 900):
    """Start ``nproc`` ranks of this script's ``mode`` (``RANK_MODES``) under
    ``torch.distributed.run`` on this card, each writing
    ``OUT.rank<r>.json``; returns a function that waits for them and gives
    every rank's record (``wall_s``: the launcher's seconds)."""
    wait = started(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc), str(pathlib.Path(__file__).resolve()), mode, str(out), *args],
        timeout=timeout)

    def records() -> list:
        rc, log, seconds = wait()
        if rc != 0:
            raise AssertionError(f"torchrun of {mode} failed ({rc}):\n{log[-3000:]}")
        recs = [json.loads(pathlib.Path(f"{out}.rank{r}.json").read_text())
                for r in range(nproc)]
        for rec in recs:
            rec["wall_s"] = seconds
        return recs
    records.stop = wait.stop
    return records


def path_counts(records) -> dict:
    """A path's launches over every rank and step of its records."""
    return {k: sum(r["launches"][k] for rec in records for r in rec["steps"]) for k in KERNELS}


def train_dp_start(weights_root, tmp, mode: str):
    """Start T1's config through the train CLI under ``torch.distributed.run``,
    one NCCL rank, 2 steps with ``trainer.parallel: mode`` (``dp``: DDP;
    ``fsdp``: FSDP2, every parameter of 64 Ki elements or more a shard of the
    world of one), a checkpoint at step 2, under ``tmp/mode``."""
    (tmp / mode).mkdir()
    write_mangazero(tmp / mode)
    config = condition_config(tmp / mode, weights_root, trainer=dict(
        parallel=mode, max_train_steps=2, log_every=1, checkpoint_every=2))
    return torchrun_train(tmp / mode / "out", 1, config)


def train_dp_resume_start(tmp):
    """Start the FSDP run's step-2 checkpoint resumed for a third step."""
    return torchrun_train(tmp / "fsdp" / "resumed", 1, tmp / "fsdp" / "config.yaml",
                          "--resume", "--max_train_steps", "3")


def train_dp_layouts(tmp) -> bool:
    """Whether the DP and FSDP step-2 checkpoints hold the same trainables
    (names and shapes) and the same optimizer state names."""
    import torch

    ckpt = {mode: torch.load(tmp / mode / "logs" / "step-2" / "ckpt.pt", mmap=True,
                             map_location="cpu", weights_only=False)["state"]
            for mode in ("dp", "fsdp")}
    return ({k: tuple(v.shape) for k, v in ckpt["dp"]["params"].items()}
            == {k: tuple(v.shape) for k, v in ckpt["fsdp"]["params"].items()}
            and ckpt["dp"]["optimizer"]["adamw"]["state"].keys()
            == ckpt["fsdp"]["optimizer"]["adamw"]["state"].keys())


def train_dp(device, weights_root) -> dict:
    """T1's config through the train CLI under ``torch.distributed.run``, one
    NCCL rank: 2 steps with ``trainer.parallel: dp`` and, at the same time in
    another process, 2 with ``fsdp`` (each run's peak is its own process's),
    then the FSDP run's checkpoint resumed for a third (``train_dp_check``)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp, recs = pathlib.Path(tmp), {}
        wave(recs, dp=train_dp_start(weights_root, tmp, "dp"),
             fsdp=train_dp_start(weights_root, tmp, "fsdp"))
        wave(recs, resume=train_dp_resume_start(tmp))
        recs["same_layout"] = train_dp_layouts(tmp)
    return train_dp_check(recs)


def train_dp_check(recs) -> dict:
    """train_dp's rows and checks: T1's launches every step; the DP losses
    bit-equal to T1's first two, the FSDP ones within 1e-3 relative of them;
    the checkpoints of both layouts under the same names and shapes; the
    resumed step finite."""
    rows = {}
    for mode in ("dp", "fsdp"):
        (rec,) = recs[mode]
        steps = rec["steps"]
        rows[mode] = dict(
            backend=rec["backend"], world=rec["world"], wall_s=rec["wall_s"],
            losses=[r["loss"] for r in steps], t1_losses=T1_LOSSES[:2],
            rel_diff_to_t1=[abs(r["loss"] - w) / abs(w) for r, w in zip(steps, T1_LOSSES)],
            step_host_s=[r["host_s"] for r in steps],
            peak_gib=[r["peak_gib"] for r in steps], launches=[r["launches"] for r in steps])
        emit({"phase": "train_dp", "parallel": mode, **rows[mode]})
    (res,) = recs["resume"]
    row = dict(parallel="fsdp", resumed_from=2, steps=[r["step"] for r in res["steps"]],
               losses=[r["loss"] for r in res["steps"]], t1_loss_3=T1_LOSSES[2],
               peak_gib=[r["peak_gib"] for r in res["steps"]],
               launches=[r["launches"] for r in res["steps"]],
               checkpoint_layouts_equal=recs["same_layout"], wall_s=res["wall_s"])
    emit({"phase": "train_dp_resume", **row})
    want = expect(**T1_STEP)
    dp, fsdp = rows["dp"], rows["fsdp"]
    if dp["losses"] != T1_LOSSES[:2] or max(fsdp["rel_diff_to_t1"]) > 1e-3:
        raise AssertionError(f"DP or FSDP steps differ from T1's: {dp}, {fsdp}")
    if any(c != want for r in (dp, fsdp, row) for c in r["launches"]):
        raise AssertionError(f"launches a step differ from T1's {want}: {rows}, {row}")
    if row["steps"] != [3] or not all(np.isfinite(row["losses"])) or not recs["same_layout"]:
        raise AssertionError(f"the FSDP resume or the checkpoint layout is wrong: {row}")
    return path_counts(recs["dp"] + recs["fsdp"] + recs["resume"])


def train_dp2_start(weights_root, tmp):
    """Start two ranks on the one card (gloo: NCCL refuses two ranks on one
    card) with ``trainer.parallel: dp``, a bucket batch of 2 (T1's per-rank
    batch of 1 at the 1024² bucket, one row a rank), 2 steps, under
    ``tmp/dp2``."""
    (tmp / "dp2").mkdir()
    write_mangazero(tmp / "dp2")
    cfg = condition_config(tmp / "dp2", weights_root, trainer=dict(
        parallel="dp", max_train_steps=2, log_every=1, checkpoint_every=2))
    return torchrun_train(tmp / "dp2" / "out", 2, cfg)


def train_dp2(device, weights_root) -> dict:
    """``train_dp2_start`` waited for, then ``train_dp2_check``."""
    with tempfile.TemporaryDirectory() as tmp:
        records = train_dp2_start(weights_root, pathlib.Path(tmp))()
    return train_dp2_check(records)


def train_dp2_check(records) -> dict:
    """train_dp2's row and checks: T1's launches every step on each rank,
    finite losses, the trainables' bits equal on both ranks after each step,
    the frozen UNet weights equal. Its seconds a step are a gloo all-reduce
    through the host, not an NCCL number."""
    want = expect(**T1_STEP)
    row = dict(backend=records[0]["backend"], world=records[0]["world"],
               wall_s=records[0]["wall_s"],
               losses=[r["loss"] for r in records[0]["steps"]],
               panels=[r["panels"] for r in records[0]["steps"]],
               step_host_s={rec["rank"]: [r["host_s"] for r in rec["steps"]] for rec in records},
               peak_gib={rec["rank"]: [r["peak_gib"] for r in rec["steps"]] for rec in records},
               trainables_equal=[a["trainables"] == b["trainables"] for a, b in
                                 zip(records[0]["steps"], records[1]["steps"])],
               losses_equal=[a["loss"] == b["loss"] for a, b in
                             zip(records[0]["steps"], records[1]["steps"])],
               frozen_equal=records[0]["frozen_unet"] == records[1]["frozen_unet"],
               launches={rec["rank"]: [r["launches"] for r in rec["steps"]] for rec in records},
               note="seconds a step over gloo: the gradients all-reduced through the host")
    emit({"phase": "train_dp2", **row})
    if (row["backend"] != "gloo" or row["world"] != 2 or len(row["losses"]) != 2
            or not all(np.isfinite(row["losses"])) or not all(row["trainables_equal"])
            or not all(row["losses_equal"]) or not row["frozen_equal"]
            or any(c != want for rec in records for c in (r["launches"] for r in rec["steps"]))):
        raise AssertionError(f"two ranks on one card disagree: {row}")
    return path_counts(records)


# ---------------------------------------------------------------------------
# the model axis: B6 at a rank's shapes, the sharded LLaMA in one process,
# the agent and stage 3 on two ranks sharing the card, stage 3 under FSDP;
# then the Qwen-VL tower (A8)
# ---------------------------------------------------------------------------
INT4_TP_CASES = [  # (tp, in, features, a rank's calls a token) of the SEED-X LLaMA, T = 1
    (2, 5120, 2560, 120), (2, 5120, 6912, 80), (2, 6912, 5120, 40), (2, 2560, 5120, 40),
    (2, 5120, 16165, 1),
    (4, 5120, 1280, 120), (4, 5120, 3456, 80), (4, 3456, 5120, 40), (4, 1280, 5120, 40),
    (4, 5120, 8083, 1)]


def check_int4_tp(device) -> list:
    """B6 at a model rank's layers under tensor parallelism (q/k/v and o,
    gate/up and down, lm_head's vocabulary rows, at tp = 2 and 4), T = 1,
    fp32 x as the sharded decode passes it, against its plain twin:
    relative Frobenius under 2e-2, allclose 2e-2 to the bf16-dequant
    product, two calls bit-equal; timed as ``check_int4`` times its rows
    beside the twin and ``torch.matmul`` on the bf16-dequantized weight.
    Then a rank's B6 time a token (calls x ms) beside its bound."""
    import torch
    from diffsensei_tpu_torch.ops import int4_matmul as i4

    gen = torch.Generator(device=device).manual_seed(6)
    rows, per_rank = [], {}
    for tp, in_f, features, calls in INT4_TP_CASES:
        padded = i4.padded_features(features, in_f, 128)
        wbytes = in_f * padded // 2 + (in_f // 128) * padded * 4
        copies = min(64, -(-256 * 2**20 // wbytes))
        weights = [(torch.randint(0, 256, (in_f, padded // 2), generator=gen, device=device,
                                  dtype=torch.uint8),
                    (torch.rand((in_f // 128, padded), generator=gen, device=device) + 0.5)
                    / (4.61 * in_f ** 0.5))
                   for _ in range(copies)]
        x = torch.randn((1, in_f), generator=gen, device=device)
        xb = x.bfloat16()
        xf = xb.float()
        packed, scale = weights[0]
        got = i4.int4_decode_matmul(x, packed, scale)
        again = i4.int4_decode_matmul(x, packed, scale)
        torch.cuda.synchronize()
        dense = [i4.dequantize(q, s_, torch.bfloat16) for q, s_ in weights]
        ref = xf @ dense[0].float()
        twin = i4.int4_decode_fallback(xf, packed, scale)
        row = dict(tp=tp, shape=[1, in_f, features], padded=padded, x="float32",
                   calls_per_token=calls, copies=copies,
                   max_abs_err=(got - twin).abs().max().item(),
                   rel_frobenius=((got - twin).norm() / twin.norm()).item(),
                   allclose_bf16=torch.allclose(got, ref, rtol=2e-2, atol=2e-2),
                   bit_equal=torch.equal(got, again),
                   ms=cuda_ms([lambda q=q, s_=s_: i4.int4_decode_matmul(x, q, s_)
                               for q, s_ in weights]),
                   plain_ms=cuda_ms([lambda q=q, s_=s_: i4.int4_decode_fallback(xf, q, s_)
                                     for q, s_ in weights]),
                   library_ms=cuda_ms([lambda w=w: torch.matmul(xb, w) for w in dense]),
                   **bound(wbytes + 4 * in_f + 4 * padded, 2 * in_f * padded))
        rows.append(row)
        emit({"phase": "int4_matmul_tp", **row})
        if not (row["allclose_bf16"] and row["rel_frobenius"] < 2e-2 and row["bit_equal"]):
            raise AssertionError(f"int4_decode_matmul disagrees with its plain twin: {row}")
        acc = per_rank.setdefault(tp, dict(ms=0.0, bound_ms=0.0, calls=0))
        acc["ms"] += calls * row["ms"]
        acc["bound_ms"] += calls * row["bound_ms"]
        acc["calls"] += calls
        del weights, dense, twin, ref
        torch.cuda.empty_cache()
    emit({"phase": "int4_matmul_tp", "per_token_per_rank": per_rank})
    return rows


def profiled_device_ms(fn, calls: int) -> dict:
    """Device time a call of ``fn`` (its kernels' time summed by
    ``torch.profiler``), kernels a call and the host's ms a call, over
    ``calls`` calls after a warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    return dict(device_ms=device_us / calls / 1e3 if kernels else None,
                kernels=sum(e.count for e in kernels) / calls if kernels else None,
                wall_ms=wall / calls * 1e3)


def model_axis(device, llm, prompt_len: int = 83, steps: int = 16) -> dict:
    """The served int4 SEED-X LLaMA (40 layers, serve_agent's) cut on the
    card into 2 and then 4 model ranks' shard sets (``shard_sets``: int4
    column shards repacked layer by layer), run in one process by
    ``model_axis_schedule`` (each shard set's own forward in a thread, the
    all-reduces summed in rank order): an ``prompt_len``-token prefill and ``steps``
    decode steps fed the unsharded LLaMA's greedy ids. Checks: each step's
    last logits within B6's limit (relative Frobenius 2e-2) of the
    unsharded ones; B6 281 x tp launches a token exactly (the prefill
    dequantizes: none) and no other kernel. The first and the last rank's
    shard set alone for a decode step: device ms (``torch.profiler``, 3
    steps) beside its bound, its weight bytes over the HBM rate (about
    2.0 / tp ms)."""
    import functools
    import torch
    from diffsensei_tpu_torch.models.mllm.llama import init_caches
    from diffsensei_tpu_torch.parallel.tensor import model_axis_schedule, shard_sets

    cfg = llm.config
    total = prompt_len + steps
    prompt = torch.from_numpy(np.random.default_rng(14).integers(
        3, cfg.vocab_size, (1, prompt_len))).to(device)
    pos = lambda i, n=1: torch.arange(i, i + n, device=device)[None]

    def decode(forward, caches, tokens=None):
        """Prefill and ``steps`` decode steps: the last logits of each, the
        tokens fed (greedy unless ``tokens``), the decode's host seconds."""
        logits, _, caches = forward(input_ids=prompt, positions=pos(0, prompt_len),
                                    caches=caches, cache_index=0)
        out, fed = [logits[0, -1].float()], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            fed.append(int(out[-1].argmax()) if tokens is None else tokens[i])
            logits, _, caches = forward(input_ids=torch.full((1, 1), fed[-1], device=device),
                                        positions=pos(prompt_len + i), caches=caches,
                                        cache_index=prompt_len + i)
            out.append(logits[0, -1].float())
        torch.cuda.synchronize()
        return out, fed, time.perf_counter() - t0

    counts = expect()
    with torch.inference_mode():
        want, ids, whole_s = decode(llm, init_caches(cfg, 1, total, torch.float32, device))
        for tp in (2, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shards = shard_sets(llm, tp)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
            caches = [init_caches(cfg, 1, total, torch.float32, device, tp=tp) for _ in shards]
            before = launch_counts()
            got, _, tp_s = decode(functools.partial(model_axis_schedule, shards), caches, ids)
            launches = since(before)
            rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
            ranks = []
            for r in (0, tp - 1):     # alike but for the last rank's shorter vocabulary
                shard, tok = shards[r], torch.full((1, 1), ids[-1], device=device)
                wbytes = sum(p.numel() * p.element_size() for n, p in shard.named_parameters()
                             if ".kernel_" in n)
                # the shard set alone: its rank's work, each all-reduce the identity
                timing = profiled_device_ms(lambda: model_axis_schedule(
                    [shard], input_ids=tok, positions=pos(total - 1), caches=[caches[r]],
                    cache_index=total - 1), 3)
                ranks.append(dict(rank=r, weight_bytes=wbytes, **bound(wbytes, 0), **timing))
            cache_bytes = [sum(t.numel() * t.element_size() for kv in c for t in kv)
                           for c in caches]
            row = dict(tp=tp, layers=cfg.num_layers, prompt_tokens=prompt_len, steps=steps,
                       shard_s=shard_s, max_rel_frobenius=max(rel), prefill_rel_frobenius=rel[0],
                       max_abs_diff=max((g - w).abs().max().item() for g, w in zip(got, want)),
                       argmax_agree=sum(int(g.argmax()) == int(w.argmax())
                                        for g, w in zip(got, want)),
                       schedule_host_ms_per_token=tp_s / steps * 1e3,
                       unsharded_host_ms_per_token=whole_s / steps * 1e3,
                       cache_bytes_per_rank=cache_bytes, ranks=ranks, launches=launches)
            emit({"phase": "model_axis", **row})
            want_launches = expect(int4=(7 * cfg.num_layers + 1) * tp * steps)
            if row["max_rel_frobenius"] > 2e-2 or launches != want_launches:
                raise AssertionError(f"the model axis's schedule disagrees with the unsharded "
                                     f"LLaMA (launches expected {want_launches}): {row}")
            counts = {k: counts[k] + launches[k] for k in KERNELS}
            del shards, caches
            gc.collect()
            torch.cuda.empty_cache()
    return counts


AGENT_TP_LAYERS, AGENT_TP_PROMPT, AGENT_TP_FREE = 8, 83, 32


def seed_x_agent_config(layers: int):
    """``AgentConfig()`` (SEED-X width: the 13B LLaMA's, its resamplers)
    with the LLaMA cut to ``layers`` layers."""
    import dataclasses
    from diffsensei_tpu_torch.core.config import AgentConfig, LlamaConfig

    return AgentConfig(llm=dataclasses.replace(LlamaConfig.seed_x_13b(), num_layers=layers))


def agent_tp_rank(argv) -> int:
    """A rank of serve_agent_tp (this script's ``agent-tp-rank OUT`` mode,
    under ``torch.distributed.run``): the int4 SEED-X-width agent cut to
    ``AGENT_TP_LAYERS`` layers, built whole on this rank's card from seed 0,
    its greedy ``generate`` on an ``AGENT_TP_PROMPT``-token prompt ending
    with ``<img>`` (the forced ladder to ``</img>``, then
    ``AGENT_TP_FREE`` free tokens) unsharded, then cut over the model axis
    of all ranks (``shard_agent``) and again; writes OUT.rank<r>.json."""
    import torch
    import torch.distributed as dist
    from diffsensei_tpu_torch.models.mllm import seed_x
    from diffsensei_tpu_torch.parallel.mesh import (
        MeshSpec, init_distributed, make_mesh, model_group)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = argv[0]
    env = init_distributed()
    group = model_group(make_mesh(MeshSpec(data=1, model=env.world)))
    acfg = seed_x_agent_config(AGENT_TP_LAYERS)
    agent = seed_x.ContinuousLVLM.build(acfg, quantized="int4", device=env.device, seed=0)
    vocab, nq = acfg.llm.vocab_size, acfg.input_resampler.num_queries
    ladder = np.arange(vocab - nq - 2, vocab)
    prompt = np.concatenate([np.random.default_rng(15).integers(3, ladder[0],
                                                                AGENT_TP_PROMPT - 1),
                             ladder[:1]])[None]
    new = nq + 1 + AGENT_TP_FREE
    cache_bytes, make_caches = [], seed_x.init_caches

    def recording_caches(*args, **kwargs):
        caches = make_caches(*args, **kwargs)
        cache_bytes.append(sum(t.numel() * t.element_size() for kv in caches for t in kv))
        return caches

    seed_x.init_caches = recording_caches

    def run(agent):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, t0 = launch_counts(), time.perf_counter()
        res = agent.generate(prompt, ladder_ids=ladder, max_new_tokens=new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return dict(seconds=seconds, s_per_token=seconds / new,
                    ids=res["output_ids"][0].tolist(), num_gen_imgs=res["num_gen_imgs"],
                    launches=since(before), cache_bytes=cache_bytes[-1],
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30), res["img_gen_feat"]

    with torch.inference_mode():
        whole, feat = run(agent)
        agent = seed_x.shard_agent(agent, group)
        gc.collect()
        torch.cuda.empty_cache()
        sharded, tp_feat = run(agent)
        rel = ((tp_feat.float() - feat.float()).norm() / feat.float().norm()).item()
        diff = (tp_feat.float() - feat.float()).abs().max().item()
    rank = dist.get_rank()
    pathlib.Path(f"{out}.rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, world=dist.get_world_size(), backend=dist.get_backend(),
        layers=AGENT_TP_LAYERS, prompt_tokens=int(prompt.shape[1]), new_tokens=new,
        whole=whole, sharded=sharded, img_gen_feat_rel_frobenius=rel,
        img_gen_feat_max_abs_diff=diff, img_gen_feat_shape=list(tp_feat.shape),
        img_gen_feat_bits=bits_digest([tp_feat]))))
    dist.destroy_process_group()
    return 0


def serve_agent_tp(device) -> dict:
    """The agent's decode under tensor parallelism on two gloo ranks that
    share the card (``agent_tp_rank`` under ``torch.distributed.run``): at
    SEED-X width, 8 layers (a depth cut: every token's all-reduces go
    through the host). Checks on each rank: the ids equal the unsharded
    agent's and the other rank's; ``img_gen_feat`` within 2e-2 (relative
    Frobenius) of the unsharded one and bit-equal across the ranks; B6 57 a
    token (8 x 7 + lm_head) and no other kernel; a KV cache of half the
    unsharded bytes. Returns the path's launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        records = torchrun_ranks("agent-tp-rank", pathlib.Path(tmp) / "out", 2)()
    return serve_agent_tp_check(records)


def serve_agent_tp_check(records) -> dict:
    """serve_agent_tp's row and checks (its docstring); returns the path's
    launch counts."""
    per_token = 7 * AGENT_TP_LAYERS + 1
    r0 = records[0]
    row = dict(backend=r0["backend"], world=r0["world"], layers=r0["layers"],
               prompt_tokens=r0["prompt_tokens"], new_tokens=r0["new_tokens"],
               ids_equal_to_unsharded=[r["sharded"]["ids"] == r["whole"]["ids"] for r in records],
               ids_equal_across_ranks=all(r["sharded"]["ids"] == r0["sharded"]["ids"]
                                          for r in records),
               num_gen_imgs=[r["sharded"]["num_gen_imgs"] for r in records],
               img_gen_feat_shape=r0["img_gen_feat_shape"],
               img_gen_feat_rel_frobenius=[r["img_gen_feat_rel_frobenius"] for r in records],
               img_gen_feat_max_abs_diff=[r["img_gen_feat_max_abs_diff"] for r in records],
               img_gen_feat_equal_across_ranks=all(r["img_gen_feat_bits"] ==
                                                   r0["img_gen_feat_bits"] for r in records),
               b6_per_token=[r["sharded"]["launches"]["int4"] / r["new_tokens"]
                             for r in records],
               cache_share=[r["sharded"]["cache_bytes"] / r["whole"]["cache_bytes"]
                            for r in records],
               s_per_token={r["rank"]: r["sharded"]["s_per_token"] for r in records},
               unsharded_s_per_token={r["rank"]: r["whole"]["s_per_token"] for r in records},
               peak_gib={r["rank"]: r["sharded"]["peak_gib"] for r in records},
               launches={r["rank"]: r["sharded"]["launches"] for r in records},
               note="seconds a token over gloo: each all-reduce goes through the host")
    emit({"phase": "serve_agent_tp", **row})
    from diffsensei_tpu_torch.ops.int4_matmul import MAX_TOKENS

    # one forward a new token, and the prefill's where a prompt is short enough for B6
    want = expect(int4=per_token * (r0["new_tokens"] + (r0["prompt_tokens"] <= MAX_TOKENS)))
    if (row["backend"] != "gloo" or row["world"] != 2 or not all(row["ids_equal_to_unsharded"])
            or not row["ids_equal_across_ranks"] or row["num_gen_imgs"] != [1, 1]
            or max(row["img_gen_feat_rel_frobenius"]) > 2e-2
            or not row["img_gen_feat_equal_across_ranks"] or row["cache_share"] != [0.5, 0.5]
            or any(r["sharded"]["launches"] != want for r in records)):
        raise AssertionError(f"the agent on two model ranks disagrees (launches expected "
                             f"{want}): {row}")
    return {k: sum(r["sharded"]["launches"][k] for r in records) for k in KERNELS}


# an SGD rate at which the first step moves the loss by 2% (22.61 -> 22.16 on an
# H100), so that a partial update shows in the second loss well above its 1e-3
# limit; the trainables' move is held on its own at every rate. At 1e-3 the first
# step halves the loss (22.6 -> 10.8) and the second loss is 1.6e-2 from the
# one-process one, while the move agrees within 0.93% as at 1e-4 and 3e-5: the
# layouts' bf16 differences grown by that step, not a wrong update
# (tools/torch_model_axis_probe.py train_mllm_tp_rates)
TRAIN_TP_LAYERS, TRAIN_TP_LR, TRAIN_TP_HW, TRAIN_TP_TOKENS = 4, 3e-5, 1024, 400
# a stage-3 step at T3's shapes: B1 70 + 70 replayed, B2/B4 69, B3 34 + 28 replayed + 20
# in the VAE encoder, B5 70 + 70 replayed (train_mllm's count)
T3_STEP = dict(flash_fwd=140, flash_dq=69, flash_dkv=69, groupnorm=82, dual=140)


def train_tp_stack(device):
    """The full SDXL stack, random weights from seed 0."""
    from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules

    return PipelineModules.sdxl(device=device, seed=0, init="random")


def train_tp_rank(argv) -> int:
    """A rank of train_mllm_tp (this script's ``train-tp-rank OUT`` mode):
    the full SDXL stack (random, seed 0, per-block remat) and a SEED-X-width
    agent of ``TRAIN_TP_LAYERS`` layers (bf16 base, LoRA r 64 with B drawn
    nonzero, per-layer remat), the same on every rank, then two
    SGD-with-momentum steps of stage 3 on one 1024² batch with fixed draws:
    on rank 0 first with the agent whole (the one-process step, its first
    gradients and its trainables' move saved beside OUT), then on every
    rank with it cut over a ``(data=1, model=ranks)`` mesh's model axis,
    DDP over its data axis, its first gradients and move against the saved
    ones cut to the rank's shards. argv: OUT and the SGD rate. Writes
    OUT.rank<r>.json."""
    import copy
    import torch
    import torch.distributed as dist
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM, shard_agent
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.parallel.mesh import (
        MeshSpec, data_group, init_distributed, llm_param_sharding_rules, make_mesh,
        model_group, sharded_dim)
    from diffsensei_tpu_torch.parallel.tensor import shard_llama_state
    from diffsensei_tpu_torch.parallel.train import wrap_ddp
    from diffsensei_tpu_torch.train import diffusion as td, mllm_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, lr = argv[0], float(argv[1])
    env = init_distributed()
    device = env.device
    mesh = make_mesh(MeshSpec(data=1, model=env.world))
    dgroup, mgroup = data_group(mesh), model_group(mesh)
    mods = train_tp_stack(device)
    mods.unet.enable_remat()
    acfg = seed_x_agent_config(TRAIN_TP_LAYERS)
    agent = ContinuousLVLM.build(acfg, mods.unet.dtype, device=device, seed=3, remat=True)
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(12)
        for name, p in agent.llm.named_parameters():
            if name.endswith("lora_B.weight"):   # nonzero, so that lora_A moves in step 1
                p.normal_(0.0, 0.02, generator=gen)
    batch, draws = stage3_batch(mods.manga, agent, TRAIN_TP_HW, TRAIN_TP_TOKENS)
    batch = {k: as_t(v, device) for k, v in batch.items()}
    draws = {k: as_t(v, device) for k, v in draws.items()}
    frozen = td.FrozenDiffusionStack(
        vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
        image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder,
        vae_scaling=mods.vae.config.scaling_factor)
    frozen_unet = lambda: bits_digest(list(mods.unet.parameters())
                                      + list(mods.resampler.parameters()))

    def steps(agent, group, ddp):
        params = mllm_step.agent_trainables(agent)
        start = {k: p.detach().float().clone() for k, p in params.items()}
        step = mllm_step.make_stage3_step(mods.unet, mods.resampler, agent, DDPMSchedule(),
                                          mllm_step.Stage3Config(manga=mods.manga), group)
        if ddp:
            wrap_ddp(step, {"llm": agent.llm, "input_resampler": agent.input_resampler,
                            "output_resampler": agent.output_resampler}, env, group=dgroup)
        sgd = torch.optim.SGD(list(params.values()), lr=lr, momentum=0.9)
        rows, grads = [], None
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, t0 = launch_counts(), time.perf_counter()
            loss, metrics = step.forward(frozen, batch, None, **draws)
            loss.backward()
            if grads is None:
                grads = {k: p.grad.detach().float().clone() for k, p in params.items()}
            sgd.step()
            sgd.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            rows.append(dict(loss=float(loss), **{k: float(v) for k, v in metrics.items()},
                             host_s=time.perf_counter() - t0, launches=since(before),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        moved = {k: p.detach().float() - start.pop(k) for k, p in params.items()}
        return rows, params, grads, moved

    unet_before = frozen_unet()
    reference = None
    if env.rank == 0:
        whole = copy.deepcopy(agent)
        reference, _, grads, moved = steps(whole, None, False)
        torch.save({k: g.cpu() for k, g in grads.items()}, f"{out}.grads.pt")
        torch.save({k: m.cpu() for k, m in moved.items()}, f"{out}.moved.pt")
        del whole, grads, moved
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    agent = shard_agent(agent, mgroup)
    base = [p for n, p in agent.llm.named_parameters() if ".base." in n]
    base_before = bits_digest(base)
    rows, params, grads, moved = steps(agent, dgroup, True)
    mrank, msize = dist.get_rank(mgroup), dist.get_world_size(mgroup)

    def against(got, path):
        """Relative Frobenius distances of ``got`` to the one-process tensors
        saved at ``path``, cut to this rank's shards: over all, the worst
        tensor's and the median."""
        want = {k: (shard_llama_state({k[4:]: g}, acfg.llm, mrank, msize)[k[4:]]
                    if k.startswith("llm.") else g).to(device)
                for k, g in torch.load(path).items()}
        per = {k: ((got[k] - w).norm() / w.norm()).item()
               for k, w in want.items() if w.norm() > 0}
        cat = lambda d: torch.cat([d[k].flatten() for k in sorted(want)])
        worst = max(per, key=per.get)
        return dict(rel_frobenius=((cat(got) - cat(want)).norm() / cat(want).norm()).item(),
                    worst_tensor=worst, worst_rel_frobenius=per[worst],
                    median_rel_frobenius=float(np.median(list(per.values()))))

    # the first gradients, and the trainables' move over both steps (rate,
    # momentum and the second gradient), against the one-process ones
    first_grads, update = against(grads, f"{out}.grads.pt"), against(moved, f"{out}.moved.pt")
    rules = llm_param_sharding_rules()
    replicated = [p for n, p in params.items()
                  if not n.startswith("llm.")
                  or sharded_dim(n[len("llm."):], p.dim(), rules) is None]
    rank = dist.get_rank()
    pathlib.Path(f"{out}.rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, world=dist.get_world_size(), backend=dist.get_backend(),
        layers=TRAIN_TP_LAYERS, lr=lr, steps=rows, reference=reference, grads=first_grads,
        update=update, trainables=len(params), replicated_trainables=len(replicated),
        replicated=bits_digest(replicated), frozen_base_moved=bits_digest(base) != base_before,
        frozen_unet=[unet_before, frozen_unet()])))
    dist.destroy_process_group()
    return 0


def train_mllm_tp(device, lr: float = TRAIN_TP_LR) -> dict:
    """Stage 3 on a ``(data=1, model=2)`` mesh of two gloo ranks sharing the
    card (``train_tp_rank``): full SDXL width, the LLaMA at SEED-X width cut
    to 4 layers (bf16, fp32 LoRA r 64), two SGD-with-momentum steps.
    SGD rate ``lr``. Checks: each rank's losses within 1e-3 (relative) of
    the one-process step's from the same state, batch and draws, and equal
    across the ranks; its first gradients, and its trainables' move over
    the two steps (the rate, the momentum and the second gradient), within
    ``check_reference_train_mllm``'s bounds of the one-process ones cut to
    its shards (5e-2 relative over all, 1.5e-1 the worst tensor); the replicated trainables bit-equal
    across the ranks; the frozen LLaMA base, UNet and Resampler unmoved and
    the latter two bit-equal across the ranks; T3's launches a step on each
    rank."""
    with tempfile.TemporaryDirectory() as tmp:
        records = torchrun_ranks("train-tp-rank", pathlib.Path(tmp) / "out", 2, str(lr))()
    return train_mllm_tp_check(records, lr)


def train_mllm_tp_check(records, lr: float = TRAIN_TP_LR) -> dict:
    """train_mllm_tp's row and checks (its docstring); returns the path's
    launch counts."""
    ref = next(r["reference"] for r in records if r["reference"])
    keys = ("loss", "loss_diffusion", "loss_lm", "loss_rec")
    rel = {r["rank"]: [max(abs(s[k] - w[k]) / max(abs(w[k]), 1e-30) for k in keys)
                       for s, w in zip(r["steps"], ref)] for r in records}
    row = dict(backend=records[0]["backend"], world=records[0]["world"],
               layers=records[0]["layers"], lr=lr,
               losses=[s["loss"] for s in records[0]["steps"]],
               one_process_losses=[s["loss"] for s in ref], max_rel_diff_by_rank=rel,
               grads={r["rank"]: r["grads"] for r in records},
               update={r["rank"]: r["update"] for r in records},
               losses_equal_across_ranks=all(
                   [s["loss"] for s in r["steps"]] == [s["loss"] for s in records[0]["steps"]]
                   for r in records),
               trainables=records[0]["trainables"],
               replicated_trainables=records[0]["replicated_trainables"],
               replicated_equal=all(r["replicated"] == records[0]["replicated"]
                                    for r in records),
               frozen_base_moved=[r["frozen_base_moved"] for r in records],
               frozen_unet_equal=all(r["frozen_unet"][0] == r["frozen_unet"][1]
                                     == records[0]["frozen_unet"][0] for r in records),
               step_host_s={r["rank"]: [s["host_s"] for s in r["steps"]] for r in records},
               one_process_step_host_s=[s["host_s"] for s in ref],
               peak_gib={r["rank"]: [s["peak_gib"] for s in r["steps"]] for r in records},
               one_process_peak_gib=[s["peak_gib"] for s in ref],
               launches={r["rank"]: [s["launches"] for s in r["steps"]] for r in records},
               note="seconds a step over gloo: the activations' all-reduces go through the host")
    emit({"phase": "train_mllm_tp", **row})
    want = expect(**T3_STEP)
    if (row["backend"] != "gloo" or max(max(v) for v in rel.values()) > 1e-3
            or any(r[k]["rel_frobenius"] > 5e-2 or r[k]["worst_rel_frobenius"] > 1.5e-1
                   for r in records for k in ("grads", "update"))
            or not row["losses_equal_across_ranks"] or not row["replicated_equal"]
            or any(row["frozen_base_moved"]) or not row["frozen_unet_equal"]
            or any(s["launches"] != want for r in records for s in r["steps"])):
        raise AssertionError(f"stage 3 on the model axis disagrees (launches expected "
                             f"{want}): {row}")
    return {k: sum(s["launches"][k] for r in records for s in r["steps"]) for k in KERNELS}


def train_mllm_fsdp(device) -> dict:
    """T3 under ``trainer.parallel: fsdp``: the train CLI on
    ``configs/train/mllm.yaml`` with train_mllm's changes (random init,
    synthetic pages, logs beside them) and ``parallel: fsdp``,
    ``max_train_steps: 2``, a checkpoint at step 2, in this process as one
    NCCL rank (``recorded_train``; the launcher's rendezvous is train_dp's),
    at T3's depth: the agent's LLaMA (one FSDP unit a layer,
    ``embed_tokens_only`` a forward method) and resamplers, the frozen stack,
    UNet and Resampler sharded over a data axis of one. Checks: T3's launches
    a step; losses within 1e-3 (relative) of T3's first two; the
    checkpoint's trainables whole, under the names and shapes of T3's."""
    import torch
    import yaml

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_mangazero(tmp)
        cfg = yaml.safe_load(pathlib.Path("configs/train/mllm.yaml").read_text())
        cfg.pop("weights")
        cfg["model"]["init"] = "random"
        cfg["train_data"].update(ann_path=str(tmp / "annotations.json"), image_root=str(tmp))
        cfg["trainer"].update(parallel="fsdp", max_train_steps=2, log_every=1,
                              checkpoint_every=2, log_dir=str(tmp / "logs"))
        (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))
        rec = recorded_train(["--config", str(tmp / "config.yaml")])
        gc.collect()
        torch.cuda.empty_cache()
        params = torch.load(tmp / "logs" / "step-2" / "ckpt.pt", mmap=True, map_location="cpu",
                            weights_only=False)["state"]["params"]
        whole = all(type(v) is torch.Tensor for v in params.values())
        layout = {k: tuple(v.shape) for k, v in params.items()} == T3_CKPT_SHAPES
        del params
    steps = rec["steps"]
    row = dict(backend=rec["backend"], world=rec["world"], wall_s=rec["wall_s"],
               losses=[r["loss"] for r in steps], t3_losses=T3_LOSSES[:2],
               rel_diff_to_t3=[abs(r["loss"] - w) / abs(w) for r, w in zip(steps, T3_LOSSES)],
               step_host_s=[r["host_s"] for r in steps], peak_gib=[r["peak_gib"] for r in steps],
               checkpoint_whole=whole, checkpoint_layout_of_t3=layout,
               launches=[r["launches"] for r in steps])
    emit({"phase": "train_mllm_fsdp", **row})
    want = expect(**T3_STEP)
    if (len(steps) != 2 or max(row["rel_diff_to_t3"]) > 1e-3 or not whole or not layout
            or row["backend"] != "nccl" or any(c != want for c in row["launches"])):
        raise AssertionError(f"T3 under FSDP differs from T3 (launches expected {want}): {row}")
    return path_counts([rec])


def check_qwen_visual(device) -> dict:
    """The Qwen-VL tower with attention pooling (A8) at Qwen-VL's published
    visual widths, this script's own config (no package preset): 1664 wide,
    16 heads, MLP 8192, patch 14, its 16 x 16 position table resized to a
    448 px panel's 32 x 32 grid, 256 pooled queries of 4096 (32 heads), the
    projection 4096; cut to 2 layers. bf16 on the card against the same
    weights in fp32 on the CPU: relative Frobenius within 5e-2; one B1
    launch (the pool's 1024 keys at head_dim 128; the blocks' head_dim 104
    takes the plain path)."""
    import copy
    import torch
    from diffsensei_tpu_torch.core.config import QwenResamplerConfig, VisionEncoderConfig
    from diffsensei_tpu_torch.models.mllm.qwen_visual import VisionTransformerWithAttnPool
    from diffsensei_tpu_torch.utils.init import init_flax_like_

    cfg = VisionEncoderConfig(image_size=224, patch_size=14, hidden_size=1664, num_layers=2,
                              num_heads=16, intermediate_size=8192, norm_eps=1e-6)
    pool = QwenResamplerConfig(grid_size=16, embed_dim=4096, num_heads=32, kv_dim=1664)
    with torch.device("meta"):
        cpu = VisionTransformerWithAttnPool(cfg, pool, output_dim=4096)
    gen = torch.Generator().manual_seed(16)
    init_flax_like_(cpu.to_empty(device="cpu"), gen)
    with torch.no_grad():      # the parameters outside the layers init_flax_like_ knows
        cpu.positional_embedding.normal_(0.0, 0.02, generator=gen)
        cpu.proj.normal_(0.0, 4096 ** -0.5, generator=gen)
        cpu.attn_pool.attn.in_proj_weight.normal_(0.0, 4096 ** -0.5, generator=gen)
    card = copy.deepcopy(cpu).to(device=device, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(17).uniform(0, 1, (1, 448, 448, 3))).float()
    with torch.inference_mode():
        want = cpu(x)
        reset_counts()
        got = card(x.to(device))
        torch.cuda.synchronize()
        launches = launch_counts()
        got = got.float().cpu()
    row = dict(module="qwen_visual_attn_pool_1664_2_layers_bf16", shape=list(got.shape),
               finite=bool(torch.isfinite(got).all()),
               rel_frobenius=((got - want).norm() / want.norm()).item(),
               max_abs_diff=(got - want).abs().max().item(), bound=5e-2, launches=launches)
    emit({"phase": "qwen_visual", **row})
    if (row["shape"] != [1, 256, 4096] or not row["finite"] or row["rel_frobenius"] > 5e-2
            or launches != expect(flash_fwd=1)):
        raise AssertionError(f"the Qwen-VL tower on the card disagrees with the CPU: {row}")
    return launches


REFERENCE_THREADS = 4     # the references' CPU threads, beside the main path's host


def references(argv) -> int:
    """The modules on the card against the CPU in fp32 (this script's
    ``references`` mode, a process of its own beside the main path):
    ``check_reference``, ``check_llama_reference``, ``check_reference_train``
    and ``check_reference_train_mllm``, each phase line on stdout; any
    disagreement raises. The CPU side takes ``REFERENCE_THREADS`` threads."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(REFERENCE_THREADS)
    device = torch.device("cuda", 0)
    check_reference(device)
    check_llama_reference(device)
    check_reference_train(device)
    check_reference_train_mllm(device)
    return 0


def references_start():
    """Start the ``references`` mode; returns a function that waits for it,
    emits its phase lines (its own ``at_s`` as ``process_at_s``) and raises
    if it failed."""
    wait = started([sys.executable, str(pathlib.Path(__file__).resolve()), "references"],
                   timeout=900)

    def finish() -> None:
        rc, log, seconds = wait()
        for line in log.splitlines():
            if line.startswith('{"phase"'):
                row = json.loads(line)
                emit({**row, "process_at_s": row.pop("at_s")})
        emit({"phase": "references", "seconds": seconds, "rc": rc})
        if rc != 0:
            raise AssertionError(f"the references failed ({rc}):\n{log[-3000:]}")
    finish.stop = wait.stop
    return finish


def beside(weights_root, tmp) -> dict:
    """The paths that run as processes of their own, in waves beside the main
    path (each wave's ranks together on the card, 36 GiB or less at their
    peaks, beside the main path's 25 or less), once serve_weights has
    written its files: train_dp's DP and FSDP runs; the FSDP resume with
    serve_agent_tp's two ranks; serve_cp_cli; train_dp2. train_mllm_tp
    (46 GiB at its ranks' peaks) runs in the main path's turn. Returns each
    one's records and the waves' ends; the main path checks them once T1's
    losses are known."""
    recs, ends = {}, []
    done = lambda waited, *names: ends.append(dict(
        wave=list(names), waited_s=waited, end_at_s=time.perf_counter() - STARTED))
    waited = room(35)
    wave(recs, dp=train_dp_start(weights_root, tmp, "dp"),
         fsdp=train_dp_start(weights_root, tmp, "fsdp"))
    done(waited, "train_dp dp", "train_dp fsdp")
    waited = room(22)
    wave(recs, resume=train_dp_resume_start(tmp),
         agent_tp=torchrun_ranks("agent-tp-rank", tmp / "agent_tp", 2))
    recs["same_layout"] = train_dp_layouts(tmp)
    for mode in ("dp", "fsdp"):
        shutil.rmtree(tmp / mode, ignore_errors=True)
    done(waited, "train_dp_resume", "serve_agent_tp")
    waited = room(22)
    wave(recs, serve_cp_cli=serve_cp_cli(weights_root))
    done(waited, "serve_cp_cli")
    waited = room(36)
    wave(recs, dp2=train_dp2_start(weights_root, tmp))
    done(waited, "train_dp2")
    recs["waves"] = ends
    return recs


def room(peak_gib: float, most_s: float = 120) -> float:
    """Wait, up to ``most_s``, until the card has a wave's ``peak_gib`` (its
    ranks' peaks, from the smoke's own runs) and 10 GiB more free: a wave
    starts where the main path's phase leaves it room, and the 10 GiB are
    the wave's contexts and cache plus the main path's next rise. Returns
    the seconds waited."""
    import torch

    t0 = time.perf_counter()
    while (torch.cuda.mem_get_info(0)[0] / 2**30 < peak_gib + 10
           and time.perf_counter() - t0 < most_s and not STOPPING.is_set()):
        time.sleep(0.5)
    return time.perf_counter() - t0


class FreeMemory:
    """The card's free memory over every process on it
    (``torch.cuda.mem_get_info``), sampled every 0.5 s on a thread between
    ``start`` and ``least``."""

    def __init__(self):
        self.samples, self.done = [], threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self):
        import torch

        while not self.done.wait(0.5):
            self.samples.append((time.perf_counter() - STARTED,
                                 torch.cuda.mem_get_info(0)[0] / 2**30))

    def start(self):
        self.started_at = time.perf_counter() - STARTED
        self.thread.start()
        return self

    def least(self, waves) -> list:
        """Stop; the least free GiB while each wave ran, then after the last."""
        self.done.set()
        self.thread.join()
        edges = [self.started_at] + [w["end_at_s"] for w in waves] + [float("inf")]
        return [min((f for t, f in self.samples if a <= t < b), default=None)
                for a, b in zip(edges, edges[1:])]


def settle() -> None:
    """Free what this process no longer holds and give its cached blocks
    back to the card, for the processes beside it."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.ops import int4_matmul as i4
    from diffsensei_tpu_torch.ops import chunked_attention as ca
    from diffsensei_tpu_torch.ops import single_pass_attention as sp

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "tmp_free_gb": shutil.disk_usage(tempfile.gettempdir()).free / 1e9})

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(6) as pool:       # one nvcc for each CUDA source, together
        nvcc = {"flash_attention": pool.submit(timed, fa.build),
                "dual_cross_attention": pool.submit(timed, dca.build),
                "int4_matmul": pool.submit(timed, i4.build),
                "groupnorm_silu": pool.submit(timed, gn.build),
                "chunked_attention": pool.submit(timed, ca.build),
                "single_pass_attention": pool.submit(timed, sp.build)}
        nvcc = {name: fut.result() for name, fut in nvcc.items()}
    from diffsensei_tpu_torch.ops import _build
    ptxas = {}
    for name in nvcc:
        log = _build.cuda_library(f"{name}.cu").with_suffix(".log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", **{f"{name}_nvcc_s": t for name, t in nvcc.items()},
          "ptxas": ptxas})
    emit({"phase": "flash_layout", **flash_layout()})

    # the kernels alone on the card first: their times are taken here
    flash = check_flash(device)
    gnorm = check_groupnorm(device)
    int4 = check_int4(device)
    int4_tp = check_int4_tp(device)
    flash_dq, flash_dkv = check_flash_bwd(device)
    dual = check_dual(device)
    ring = check_ring(device)
    paths = {}
    paths["attention_chunked"], chunked = check_attention_experiment(device, "chunked")
    paths["attention_single"], single = check_attention_experiment(device, "single")
    paths["serve"], mods, ids, r1 = serve(device)
    # R1's weights as checkpoint files, for serve_weights and the train phases
    weights_root = pathlib.Path(tempfile.mkdtemp(prefix="diffsensei_weights_"))
    beside_root = pathlib.Path(tempfile.mkdtemp(prefix="diffsensei_beside_"))
    lane = ThreadPoolExecutor(1)    # the processes beside the main path, one job at a time
    refs = None
    try:
        try:
            paths["serve_weights"] = serve_weights(device, mods, r1, weights_root)
            settle()        # from here the lane shares the card: hold no cached memory
            waves = lane.submit(beside, weights_root, beside_root)
            refs = lane.submit(references_start)
            free = FreeMemory().start()
            paths["serve_extras"] = serve_extras(device, mods, r1)
            deep_cache_exact(device, mods, r1[0])
            paths["eval_pages"] = eval_pages(device, mods)
            settle()
            paths["serve_agent"], llm = serve_agent(device, mods, ids)
            paths["model_axis"] = model_axis(device, llm)
            del llm
            settle()
            paths["agent_weights"] = agent_weights(device, weights_root)
            settle()
            paths["agent_cli"] = agent_cli(device, weights_root)
            settle()
            paths["serve_cp"] = serve_cp(device, mods, ids)
            del mods
            settle()
            paths["train"] = train(device, weights_root)
            settle()
            paths["train_bf16"] = train_bf16(device, weights_root)
            remat_root = pathlib.Path(tempfile.mkdtemp(prefix="diffsensei_remat_"))
            try:
                paths["train_remat"], t1 = train_remat(device, weights_root, remat_root)
                paths["train_proj"] = train_proj(device, t1)
                del t1
            finally:
                shutil.rmtree(remat_root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            paths["train_lora"] = train_lora(device)
            gc.collect()
            torch.cuda.empty_cache()
            recs = waves.result()       # T3T and T3 below need the card's memory
        finally:
            shutil.rmtree(weights_root, ignore_errors=True)
            shutil.rmtree(beside_root, ignore_errors=True)
        least = free.least(recs["waves"])
        for w, gib in zip(recs["waves"], least):
            w["device_free_gib_least"] = gib
        emit({"phase": "beside", "waves": recs["waves"],
              "device_free_gib_least_after": least[-1]})
        serve_cp_cli_check(recs["serve_cp_cli"])
        paths["train_dp"] = train_dp_check(recs)
        paths["train_dp2"] = train_dp2_check(recs["dp2"])
        paths["serve_agent_tp"] = serve_agent_tp_check(recs["agent_tp"])
        paths["train_mllm_tp"] = train_mllm_tp(device)
        paths["train_mllm"] = train_mllm(device)
        paths["train_mllm_fsdp"] = train_mllm_fsdp(device)
        paths["qwen_visual"] = check_qwen_visual(device)
        refs.result()()
    except BaseException:
        stop_all()
        raise
    finally:
        lane.shutdown(wait=True, cancel_futures=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    def on_paths(key):
        by_path = {name: counts[key] for name, counts in paths.items() if counts[key]}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:59",
             **on_paths("flash_fwd"), **flash,
             ring_schedule=[{k: r[k] for k in ("shape", "ranks", "launches", "ms", "b1_ms",
                                               "bound_ms")} for r in ring]),
        dict(name="groupnorm_silu", route="cuda",
             source="diffsensei_tpu_torch/csrc/groupnorm_silu.cu",
             replaces="diffsensei_tpu/ops/groupnorm.py:44",
             design="resident (x within one grid's shared memory): one cooperative launch, "
                    "slabs of whole rows held from load to store across one grid barrier; "
                    "streaming: two launches, slab partials then normalize in reverse; "
                    "fixed order",
             **on_paths("groupnorm"), **gnorm),
        dict(name="int4_decode_matmul", route="cuda",
             source="diffsensei_tpu_torch/csrc/int4_matmul.cu",
             replaces="diffsensei_tpu/ops/int4_matmul.py:125",
             design="one launch: cluster split-K, TMA ring, mma.sync, fp32 x",
             **on_paths("int4"), **int4,
             tp_shapes=[{k: r[k] for k in ("tp", "shape", "calls_per_token", "ms", "plain_ms",
                                           "library_ms", "bound_ms", "max_abs_err")}
                        for r in int4_tp]),
        dict(name="flash_attention_dq", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:196",
             **on_paths("flash_dq"), **flash_dq),
        dict(name="flash_attention_dkv", route="cuda",
             source="diffsensei_tpu_torch/csrc/flash_attention.cu",
             replaces="diffsensei_tpu/ops/flash_attention.py:258",
             **on_paths("flash_dkv"), **flash_dkv),
        dict(name="dual_cross_attention", route="cuda",
             source="diffsensei_tpu_torch/csrc/dual_cross_attention.cu",
             replaces="diffsensei_tpu/ops/dual_cross_attention.py:35",
             **on_paths("dual"), **dual),
        dict(name="attention_chunked", route="cuda",
             source="diffsensei_tpu_torch/csrc/chunked_attention.cu",
             replaces="tools/bench_attention_chunked.py:40",
             **on_paths("chunked"), **chunked),
        dict(name="attention_single", route="cuda",
             source="diffsensei_tpu_torch/csrc/single_pass_attention.cu",
             replaces="tools/bench_attention_single.py:28",
             **on_paths("single"), **single),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    RANK_MODES = {"train-rank": train_rank, "agent-tp-rank": agent_tp_rank,
                  "train-tp-rank": train_tp_rank, "references": references}
    if sys.argv[1:2] and sys.argv[1] in RANK_MODES:
        sys.exit(RANK_MODES[sys.argv[1]](sys.argv[2:]))
    sys.exit(main())
