"""Headless generation from the command line (port of
``diffsensei_tpu/serve/cli.py``):

  python -m diffsensei_tpu_torch.serve.cli --preset sdxl --prompt "a young man" \\
      --scheduler dpmsolver++ --steps 12 --deep-cache 2 --quantize-unet \\
      --char-image hero.png --ip-bbox 0,0,0.5,1 --out panel.png

It runs on the card unless ``--device cpu`` asks for the CPU. The stack has
random flax-like weights from seed 0 (``PipelineModules.tiny`` / ``sdxl``):
no checkpoint or tokenizer files are loaded yet, so prompts become token ids
by the train CLI's CRC-32 word hashing. The flags that need the weight
loaders, tokenizer files, the SEED-X agent's checkpoint or several cards
(``--weights``, ``--tokenizer``, ``--tokenizer-2``, ``--agent-weights``,
``--mllm-tokenizer``, ``--quantize-llm``, ``--quantize-llm-bits``,
``--context-parallel``) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Sequence

# flag -> the ROADMAP item (queue A) that ports what it needs
NOT_PORTED = {"weights": "A5", "tokenizer": "A5", "tokenizer_2": "A5", "agent_weights": "A5",
              "mllm_tokenizer": "A5", "quantize_llm": "A5", "quantize_llm_bits": "A5",
              "context_parallel": "A11"}


def parse_bbox(values: Sequence[str]) -> List[List[float]]:
    """``"x1,y1,x2,y2"`` strings (relative) -> boxes; others are skipped."""
    boxes = []
    for v in values or []:
        parts = [float(p) for p in v.replace(",", " ").split()]
        if len(parts) == 4:
            boxes.append(parts)
    return boxes


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="DiffSensei generation (PyTorch port)")
    parser.add_argument("--preset", default="tiny", choices=["tiny", "sdxl"])
    parser.add_argument("--device", default="cuda",
                        help="torch device; the card unless 'cpu' is asked for")
    for flag in ("--weights", "--tokenizer", "--tokenizer-2", "--agent-weights",
                 "--mllm-tokenizer"):
        parser.add_argument(flag, default=None, help="not ported yet")
    parser.add_argument("--quantize-llm", action="store_true", help="not ported yet")
    parser.add_argument("--quantize-llm-bits", type=int, default=None, choices=[4, 8],
                        help="not ported yet")
    parser.add_argument("--context-parallel", action="store_true", help="not ported yet")
    parser.add_argument("--quantize-unet", action="store_true",
                        help="serve the UNet's transformer matmuls as weight-only int8")
    parser.add_argument("--prompt", default="")
    parser.add_argument("--negative-prompt", default=None)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--guidance", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-samples", type=int, default=1)
    parser.add_argument("--char-image", action="append", default=[])
    parser.add_argument("--ip-bbox", action="append", default=[],
                        help="x1,y1,x2,y2 relative, one per character")
    parser.add_argument("--dialog-bbox", action="append", default=[])
    parser.add_argument("--ip-scale", type=float, default=None)
    parser.add_argument("--deep-cache", type=int, default=None,
                        help="DeepCache interval N: the UNet's deep subtree runs on every "
                             "N-th denoise step (1 exact; 2-3 faster, approximate)")
    parser.add_argument("--deep-cache-split", type=int, default=2,
                        help="UNet level boundary for --deep-cache")
    parser.add_argument("--scheduler", default=None,
                        choices=["euler_discrete", "ddim", "dpmsolver++"],
                        help="sampler (default: the config's euler_discrete)")
    parser.add_argument("--warmup", default=None,
                        help="comma-separated HxW sizes to run once before serving, "
                             "e.g. '1024x1024,768x1024'")
    parser.add_argument("--out", default="panel.png")
    return parser


def main(argv=None) -> List[str]:
    """Generate the request of ``argv``; returns the paths written."""
    args = build_parser().parse_args(argv)
    for name, item in NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(f"--{name.replace('_', '-')} is not ported yet "
                                      f"(ROADMAP {item})")

    import torch
    from PIL import Image

    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.models.quant_unet import quantize_unet
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest
    from diffsensei_tpu_torch.train.cli import hash_tokenizer

    device = torch.device(args.device)
    build = PipelineModules.sdxl if args.preset == "sdxl" else PipelineModules.tiny
    modules = build(device=device, seed=0)
    if args.quantize_unet:
        modules.unet = quantize_unet(modules.unet)
    pcfg = PipelineConfig()
    if args.scheduler:
        pcfg = dataclasses.replace(pcfg, scheduler=args.scheduler)
    server = DiffSenseiServer(DiffSenseiPipeline(modules, pcfg))

    if args.warmup:
        sizes = [tuple(int(v) for v in hw.split("x")) for hw in args.warmup.split(",")]
        print(f"# warming {len(sizes)} size(s)...")
        server.warmup(sizes, num_inference_steps=args.steps,
                      deep_cache_interval=args.deep_cache,
                      deep_cache_split=args.deep_cache_split)

    tok = hash_tokenizer(modules.text_encoder.config.vocab_size)
    tok_2 = hash_tokenizer(modules.text_encoder_2.config.vocab_size)
    neg = args.negative_prompt or ""
    req = GenerationRequest(
        prompt=args.prompt, negative_prompt=args.negative_prompt,
        height=args.height, width=args.width, num_inference_steps=args.steps,
        guidance_scale=args.guidance, num_samples=args.num_samples, seed=args.seed,
        character_images=[Image.open(p).convert("RGB") for p in args.char_image],
        ip_bbox=parse_bbox(args.ip_bbox), dialog_bbox=parse_bbox(args.dialog_bbox),
        ip_scale=args.ip_scale, deep_cache_interval=args.deep_cache,
        deep_cache_split=args.deep_cache_split,
        prompt_ids=dict(ids=tok(args.prompt)[None], neg_ids=tok(neg)[None],
                        ids_2=tok_2(args.prompt)[None], neg_ids_2=tok_2(neg)[None]))

    images = server.generate_pil(req)
    base, ext = os.path.splitext(args.out)
    paths = []
    for i, img in enumerate(images):
        path = args.out if len(images) == 1 else f"{base}_{i}{ext}"
        img.save(path)
        print(f"saved {path} ({img.size[0]}x{img.size[1]})")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
