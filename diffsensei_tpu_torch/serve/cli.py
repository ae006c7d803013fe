"""Headless generation from the command line (port of
``diffsensei_tpu/serve/cli.py``):

  python -m diffsensei_tpu_torch.serve.cli --preset sdxl --weights <artifact dir> \\
      --tokenizer <clip tokenizer dir> --tokenizer-2 <second tokenizer dir> \\
      --prompt "a young man" --scheduler dpmsolver++ --steps 12 --deep-cache 2 \\
      --char-image hero.png --ip-bbox 0,0,0.5,1 --out panel.png

It runs on the card unless ``--device cpu`` asks for the CPU. ``--weights``
takes what ``utils.load.load_weights_any`` takes: a YAML file of component
paths, a released artifact directory (``image_generator/...``) or a file of
the train CLI's ``export_weights``. Under ``--preset sdxl`` the stack is built
on the meta device, loaded, and whatever no checkpoint covered is zeros (with
no ``--weights`` at all, everything: a warning says so); ``--preset tiny``
starts from random weights of seed 0. ``--tokenizer`` / ``--tokenizer-2``
are CLIP tokenizer directories (``vocab.json``, ``merges.txt``); without
them prompts become ids by the train CLI's CRC-32 word hashing.
``--agent-weights`` loads the SEED-X agent; with ``--quantize-llm`` its
checkpoint is quantized on the host (``--quantize-llm-bits`` 8 or 4) and only
the quantized LLM and the resamplers reach the card. ``--mllm-tokenizer`` is
the agent's LLaMA tokenizer directory (``tokenizer.model``, the sentencepiece
BPE model, and the ``<img>``, ``</img>`` and ``<img_00000>``... tokens in
``added_tokens.json`` or ``tokenizer_config.json``); with ``--agent-weights``
it gives the server the token spec (``mllm_spec_from_tokenizer``, 64 image
ids), so that the agent adapts the characters to the prompt. Without it the
agent stays idle, as in the JAX CLI.

``--context-parallel`` runs the UNet's long self-attentions as ring attention
over every rank of the process group, under a launcher,

  python -m torch.distributed.run --standalone --nproc_per_node 4 \
      -m diffsensei_tpu_torch.serve.cli --preset sdxl --context-parallel ...

or alone as a world of one; each rank takes the card ``cuda:$LOCAL_RANK``,
and rank 0 alone writes the images. The ring takes self-attentions of at
least ``PipelineConfig.context_parallel_min_seq`` (16384) tokens, which only
a 2048²-class panel has; the server snaps a request to its bucket (2048²
becomes 1024²), so through this CLI the ring is wired but not reached, as in
the JAX CLI. ``DiffSenseiPipeline(..., mesh=...)`` called with
``snap_to_buckets=False`` reaches it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import TYPE_CHECKING, List, Sequence

if TYPE_CHECKING:
    from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec


def mllm_spec_from_tokenizer(path: str, num_img_tokens: int = 64) -> MLLMTokenSpec:
    """The agent's token spec from its LLaMA tokenizer directory (the JAX
    ``mllm_spec_from_tokenizer``; reference ``seed_x.py:10-12``,
    ``gradio.py:40-47``). A token's id is ``encode(text)[1]`` where the
    encoding has a word-start piece in front of it, else ``[0]``."""
    from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec
    from diffsensei_tpu_torch.utils.tokenizer import LlamaTokenizer

    tok = LlamaTokenizer.from_pretrained(path)

    def tid(text):
        ids = tok.encode(text, add_special_tokens=False)
        return ids[1] if len(ids) > 1 else ids[0]

    return MLLMTokenSpec(
        bos_id=tok.bos_token_id, eos_id=tok.eos_token_id,
        pad_id=tok.pad_token_id or 0,
        boi_id=tid("<img>"), eoi_id=tid("</img>"),
        img_ids=[tid(f"<img_{k:05d}>") for k in range(num_img_tokens)],
        encode_text=lambda s: tok.encode(s, add_special_tokens=False),
    )


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
    parser.add_argument("--weights", default=None,
                        help="a YAML file of component checkpoint paths, a released "
                             "artifact directory (image_generator/...) or a file of "
                             "train.checkpoint.export_weights")
    parser.add_argument("--tokenizer", default=None,
                        help="CLIP tokenizer directory (vocab.json, merges.txt); hashed ids "
                             "without one")
    parser.add_argument("--tokenizer-2", default=None,
                        help="the second text encoder's tokenizer (default --tokenizer)")
    parser.add_argument("--agent-weights", default=None,
                        help="ContinuousLVLM checkpoint (mllm/agent/pytorch_model.bin layout)")
    parser.add_argument("--mllm-tokenizer", default=None,
                        help="the agent's LLaMA tokenizer directory (tokenizer.model with the "
                             "<img>, </img> and <img_k> tokens added): with --agent-weights "
                             "the agent adapts the characters to the prompt")
    parser.add_argument("--quantize-llm", action="store_true",
                        help="quantize the agent's LLM on the host (weight-only)")
    parser.add_argument("--quantize-llm-bits", type=int, default=8, choices=[4, 8],
                        help="8: per-channel int8; 4: group-wise int4")
    parser.add_argument("--context-parallel", action="store_true",
                        help="shard big (>=16k-token) spatial self-attention over every rank "
                             "of the process group via ring attention (run under "
                             "torch.distributed.run, or alone as one rank); the server snaps "
                             "2048^2 to 1024^2, so through this CLI the ring is not reached")
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


def load_agent(args, modules, device):
    """The SEED-X agent of ``--agent-weights`` in the UNet's dtype:
    ``AgentConfig()`` for ``--preset sdxl``, ``AgentConfig.tiny()`` for tiny.
    With ``--quantize-llm`` it is built on the meta device and its checkpoint
    quantized on the host; else built with random weights of seed 1 and
    overlaid by the checkpoint's groups, as the JAX CLI does."""
    from diffsensei_tpu_torch.core.config import AgentConfig
    from diffsensei_tpu_torch.models.mllm.quant import quantize_agent_on_host
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.utils.load import (
        agent_entries, load_agent_weights, load_torch_file, split_agent_ckpt)

    acfg = AgentConfig() if args.preset == "sdxl" else AgentConfig.tiny()
    dtype = modules.unet.dtype
    if not args.quantize_llm:
        agent = ContinuousLVLM.build(acfg, dtype=dtype, device=device, seed=1)
        return load_agent_weights(agent, args.agent_weights)
    agent = ContinuousLVLM.build(acfg, dtype=dtype, device=device, init="none")
    entries = agent_entries(agent, split_agent_ckpt(load_torch_file(args.agent_weights)))
    return quantize_agent_on_host(agent, entries, bits=args.quantize_llm_bits, device=device)


def main(argv=None) -> List[str]:
    """Generate the request of ``argv``; returns the paths written (none on
    a rank other than 0)."""
    args = build_parser().parse_args(argv)
    mllm_spec = mllm_spec_from_tokenizer(args.mllm_tokenizer) if args.mllm_tokenizer else None

    import torch
    from PIL import Image

    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.models.quant_unet import quantize_unet
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest
    from diffsensei_tpu_torch.train.cli import hash_tokenizer
    from diffsensei_tpu_torch.utils.load import load_weights_any
    from diffsensei_tpu_torch.utils.tokenizer import CLIPTokenizer

    mesh, writer = None, True
    if args.context_parallel:
        from diffsensei_tpu_torch.parallel.mesh import init_distributed, make_mesh
        env = init_distributed(args.device)
        device, writer = env.device, env.is_writer
        mesh = make_mesh(device=device)
        print(f"# context parallelism over {env.world} rank(s)")
    else:
        device = torch.device(args.device)
    if args.preset == "sdxl":
        # the loaders write every component they find; the rest is zeros
        modules = PipelineModules.sdxl(device=device, init="none")
        if args.weights:
            modules = load_weights_any(modules, args.weights)
        else:
            print("# WARNING: sdxl preset with no --weights serves ZERO weights")
        modules.fill_missing_params()
    else:
        modules = PipelineModules.tiny(device=device, seed=0)
        if args.weights:
            modules = load_weights_any(modules, args.weights)
    if args.quantize_unet:
        modules.unet = quantize_unet(modules.unet)
    if args.tokenizer:
        modules.tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer)
        modules.tokenizer_2 = CLIPTokenizer.from_pretrained(args.tokenizer_2 or args.tokenizer)
    agent = load_agent(args, modules, device) if args.agent_weights else None
    pcfg = PipelineConfig(context_parallel=args.context_parallel)
    if args.scheduler:
        pcfg = dataclasses.replace(pcfg, scheduler=args.scheduler)
    server = DiffSenseiServer(DiffSenseiPipeline(modules, pcfg, mesh=mesh), agent=agent,
                              mllm_spec=mllm_spec)

    if args.warmup:
        sizes = [tuple(int(v) for v in hw.split("x")) for hw in args.warmup.split(",")]
        print(f"# warming {len(sizes)} size(s)...")
        server.warmup(sizes, num_inference_steps=args.steps,
                      deep_cache_interval=args.deep_cache,
                      deep_cache_split=args.deep_cache_split)

    if modules.tokenizer is not None:
        prompt_ids = None
    else:
        tok = hash_tokenizer(modules.text_encoder.config.vocab_size)
        tok_2 = hash_tokenizer(modules.text_encoder_2.config.vocab_size)
        neg = args.negative_prompt or ""
        prompt_ids = dict(ids=tok(args.prompt)[None], neg_ids=tok(neg)[None],
                          ids_2=tok_2(args.prompt)[None], neg_ids_2=tok_2(neg)[None])
    req = GenerationRequest(
        prompt=args.prompt, negative_prompt=args.negative_prompt,
        height=args.height, width=args.width, num_inference_steps=args.steps,
        guidance_scale=args.guidance, num_samples=args.num_samples, seed=args.seed,
        character_images=[Image.open(p).convert("RGB") for p in args.char_image],
        ip_bbox=parse_bbox(args.ip_bbox), dialog_bbox=parse_bbox(args.dialog_bbox),
        ip_scale=args.ip_scale, deep_cache_interval=args.deep_cache,
        deep_cache_split=args.deep_cache_split, prompt_ids=prompt_ids)

    images = server.generate_pil(req)
    base, ext = os.path.splitext(args.out)
    paths = []
    for i, img in enumerate(images if writer else []):
        path = args.out if len(images) == 1 else f"{base}_{i}{ext}"
        img.save(path)
        print(f"saved {path} ({img.size[0]}x{img.size[1]})")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
