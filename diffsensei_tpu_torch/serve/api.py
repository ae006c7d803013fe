"""Headless serving API (port of ``diffsensei_tpu/serve/api.py``).

``DiffSenseiServer.generate`` turns a ``GenerationRequest`` into panels:
character crops through the CLIP preprocessing, optionally the SEED-X agent
adapting the character embeddings to the prompt (blended by ``mllm_scale``,
reference ``scripts/demo/gradio.py:60-109``), the request's latents drawn
once from its seed, then the pipeline, batched or one sample at a time by the
auto-batch rule. ``generate_pil`` gives PIL images; ``warmup`` runs each
served size once at start.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from diffsensei_tpu_torch.core.buckets import snap_to_bucket
from diffsensei_tpu_torch.data import processors
from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec, build_inference_prompt
from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
from diffsensei_tpu_torch.utils.observability import span


@dataclasses.dataclass
class GenerationRequest:
    prompt: str = ""
    height: int = 1024
    width: int = 1024
    num_inference_steps: Optional[int] = None
    guidance_scale: Optional[float] = None
    negative_prompt: Optional[str] = None
    num_samples: int = 1
    seed: int = 0
    character_images: Sequence[Image.Image] = ()
    ip_bbox: Sequence[Sequence[float]] = ()
    dialog_bbox: Sequence[Sequence[float]] = ()
    ip_scale: Optional[float] = None
    mllm_scale: Optional[float] = None   # only used when an agent is attached
    prompt_ids: Optional[dict] = None    # pre-tokenized prompts (no tokenizer files)
    # DeepCache: the UNet's deep subtree runs on every N-th denoise step only
    # (None or 1 exact; 2-3 faster and approximate)
    deep_cache_interval: Optional[int] = None
    deep_cache_split: int = 2


class DiffSenseiServer:
    """The pipeline, and optionally the SEED-X agent (``agent`` with its
    ``mllm_spec``), behind a single ``generate`` call.

    Multi-sample requests run as one batched denoise when the bucket's long
    side is at most ``auto_batch_max_side`` (default 512) and one sample at a
    time above it, the JAX server's rule. Both modes draw the request's
    latents once from ``seed`` and give the same panels. ``None`` always
    batches."""

    def __init__(self, pipeline: DiffSenseiPipeline, agent=None,
                 mllm_spec: Optional[MLLMTokenSpec] = None,
                 mllm_max_new_tokens: int = 500,
                 auto_batch_max_side: Optional[int] = 512):
        self.pipeline = pipeline
        self.agent = agent
        self.mllm_spec = mllm_spec
        self.mllm_max_new_tokens = mllm_max_new_tokens
        self.auto_batch_max_side = auto_batch_max_side
        self.requests = 0        # generate calls so far: a request's number in its spans

    def _preprocess_characters(self, images: Sequence[Image.Image]) -> torch.Tensor:
        """Pad with black to ``max_num_ips``, grayscale to RGB; returns the CLIP
        pixels ``[max_num_ips, 224, 224, 3]`` (the boxes count the real crops)."""
        manga = self.pipeline.m.manga
        imgs = [im.convert("RGB") for im in images][: manga.max_num_ips]
        while len(imgs) < manga.max_num_ips:
            imgs.append(Image.new("RGB", (224, 224), (0, 0, 0)))
        return torch.from_numpy(processors.batch_clip(imgs))

    @torch.inference_mode()
    def _adapt_with_mllm(self, req: GenerationRequest, clip_pixels: torch.Tensor,
                         n_valid: int) -> Optional[torch.Tensor]:
        """SEED-X character adaptation: the resampled character block goes
        through ``agent.generate`` with the caption's prompt; the generated
        features are blended with it by ``mllm_scale`` and returned as
        per-character blocks ``[I, V, D_cross]`` (None if no image came out)."""
        pipe = self.pipeline
        manga = pipe.m.manga
        pos, _ = pipe.prepare_ip_image_embeds(clip_pixels, None, n_valid)
        char_block = pos[:, manga.num_dummy_tokens:, :]         # [1, I*V, D]
        spec = self.mllm_spec
        prompt = build_inference_prompt(spec.encode_text(req.prompt), spec,
                                        spec.encode_text("\n"))
        out = self.agent.generate(prompt["input_ids"], image_embeds=char_block,
                                  ids_cmp_mask=prompt["ids_cmp_mask"],
                                  ladder_ids=spec.ladder_ids,
                                  max_new_tokens=self.mllm_max_new_tokens)
        if out["img_gen_feat"] is None:
            return None
        gen = out["img_gen_feat"][:1].to(char_block.device)    # [1, I*V, D]
        scale = pipe.config.mllm_scale if req.mllm_scale is None else req.mllm_scale
        blended = scale * gen + (1.0 - scale) * char_block
        return blended.reshape(-1, manga.num_vision_tokens, blended.shape[-1])

    def initial_latents(self, seed: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """The request's standard-normal draw, from a CPU generator seeded with
        ``seed`` (the same panels on any device)."""
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    def generate(self, req: GenerationRequest) -> np.ndarray:
        """Returns ``[num_samples, H, W, 3]`` float32 in [0, 1]."""
        self.requests += 1
        with span("serve.request", request=self.requests - 1, num_samples=req.num_samples,
                  height=req.height, width=req.width):
            return self._generate(req)

    def _generate(self, req: GenerationRequest) -> np.ndarray:
        pipe = self.pipeline
        manga = pipe.m.manga
        clip_pixels, ip_image_embeds = None, None
        with span("serve.prepare"):
            if req.character_images:
                clip_pixels = self._preprocess_characters(req.character_images)
            height, width = snap_to_bucket(req.height, req.width)
            lat = self.initial_latents(
                req.seed, (req.num_samples, height // pipe.latent_scale,
                           width // pipe.latent_scale, pipe.m.unet.config.in_channels))
        if clip_pixels is not None and self.agent is not None and self.mllm_spec is not None:
            n_valid = min(len(req.character_images), manga.max_num_ips)
            ip_image_embeds = self._adapt_with_mllm(req, clip_pixels, n_valid)
        kwargs = dict(
            num_inference_steps=req.num_inference_steps,
            guidance_scale=req.guidance_scale,
            negative_prompt=req.negative_prompt,
            ip_pixel_values=clip_pixels,
            ip_image_embeds=ip_image_embeds,
            ip_bbox=list(req.ip_bbox)[: manga.max_num_ips] or None,
            ip_scale=req.ip_scale,
            dialog_bbox=list(req.dialog_bbox)[: manga.max_num_dialogs] or None,
            prompt_ids=req.prompt_ids,
            deep_cache_interval=req.deep_cache_interval,
            deep_cache_split=req.deep_cache_split,
        )
        batched = (req.num_samples == 1 or self.auto_batch_max_side is None
                   or max(height, width) <= self.auto_batch_max_side)
        calls = [lat] if batched else [lat[i:i + 1] for i in range(req.num_samples)]
        panels = []
        for part in calls:
            images = pipe(req.prompt, height=height, width=width, num_samples=part.shape[0],
                          latents=part, **kwargs)
            with span("serve.readback"):
                panels.append(images.cpu().numpy())
        return panels[0] if batched else np.concatenate(panels, axis=0)

    def generate_pil(self, req: GenerationRequest) -> List[Image.Image]:
        arr = (self.generate(req) * 255).round().astype(np.uint8)
        return [Image.fromarray(a) for a in arr]

    def warmup(self, sizes: Sequence[Tuple[int, int]],
               num_inference_steps: Optional[int] = None,
               deep_cache_interval: Optional[int] = None, deep_cache_split: int = 2) -> None:
        """Run one conditioned single-panel request at each ``(H, W)`` before
        serving, with the knobs production will use, so that the kernels are
        built and cuDNN's plans and the caching allocator's pools are made off
        a user's clock (the JAX server compiles its programs here). Its
        characters and boxes run kernel B5 too. No CUDA graph is captured."""
        manga = self.pipeline.m.manga
        prompt_ids = None
        if self.pipeline.m.tokenizer is None:
            prompt_ids = {k: np.zeros((1, 77), np.int64)
                          for k in ("ids", "neg_ids", "ids_2", "neg_ids_2")}
        for h, w in sizes:
            self.pipeline("", height=h, width=w, num_inference_steps=num_inference_steps,
                          generator=torch.Generator().manual_seed(0), prompt_ids=prompt_ids,
                          deep_cache_interval=deep_cache_interval,
                          deep_cache_split=deep_cache_split,
                          ip_pixel_values=torch.zeros((manga.max_num_ips, 224, 224, 3)),
                          ip_bbox=[[0.0, 0.0, 0.5, 0.5]], dialog_bbox=[[0.1, 0.1, 0.4, 0.3]])
