"""Headless serving API (port of ``diffsensei_tpu/serve/api.py``).

``DiffSenseiServer.generate`` turns a ``GenerationRequest`` into panels:
character crops through the CLIP preprocessing, the request's latents drawn
once from its seed, then the pipeline, batched or one sample at a time by the
auto-batch rule. The SEED-X agent (``agent=`` in the JAX server) waits for a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from diffsensei_tpu_torch.core.buckets import snap_to_bucket
from diffsensei_tpu_torch.data import processors
from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline


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
    prompt_ids: Optional[dict] = None    # pre-tokenized prompts (no tokenizer files)


class DiffSenseiServer:
    """The pipeline behind a single ``generate`` call.

    Multi-sample requests run as one batched denoise when the bucket's long
    side is at most ``auto_batch_max_side`` (default 512) and one sample at a
    time above it, the JAX server's rule. Both modes draw the request's
    latents once from ``seed`` and give the same panels. ``None`` always
    batches."""

    def __init__(self, pipeline: DiffSenseiPipeline,
                 auto_batch_max_side: Optional[int] = 512):
        self.pipeline = pipeline
        self.auto_batch_max_side = auto_batch_max_side

    def _preprocess_characters(self, images: Sequence[Image.Image]) -> torch.Tensor:
        """Pad with black to ``max_num_ips``, grayscale to RGB; returns the CLIP
        pixels ``[max_num_ips, 224, 224, 3]`` (the boxes count the real crops)."""
        manga = self.pipeline.m.manga
        imgs = [im.convert("RGB") for im in images][: manga.max_num_ips]
        while len(imgs) < manga.max_num_ips:
            imgs.append(Image.new("RGB", (224, 224), (0, 0, 0)))
        return torch.from_numpy(processors.batch_clip(imgs))

    def initial_latents(self, seed: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """The request's standard-normal draw, from a CPU generator seeded with
        ``seed`` (the same panels on any device)."""
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    def generate(self, req: GenerationRequest) -> np.ndarray:
        """Returns ``[num_samples, H, W, 3]`` float32 in [0, 1]."""
        pipe = self.pipeline
        manga = pipe.m.manga
        clip_pixels = None
        if req.character_images:
            clip_pixels = self._preprocess_characters(req.character_images)
        kwargs = dict(
            num_inference_steps=req.num_inference_steps,
            guidance_scale=req.guidance_scale,
            negative_prompt=req.negative_prompt,
            ip_pixel_values=clip_pixels,
            ip_bbox=list(req.ip_bbox)[: manga.max_num_ips] or None,
            ip_scale=req.ip_scale,
            dialog_bbox=list(req.dialog_bbox)[: manga.max_num_dialogs] or None,
            prompt_ids=req.prompt_ids,
        )
        height, width = snap_to_bucket(req.height, req.width)
        lat = self.initial_latents(
            req.seed, (req.num_samples, height // pipe.latent_scale,
                       width // pipe.latent_scale, pipe.m.unet.config.in_channels))
        batched = (req.num_samples == 1 or self.auto_batch_max_side is None
                   or max(height, width) <= self.auto_batch_max_side)
        if batched:
            images = pipe(req.prompt, height=height, width=width,
                          num_samples=req.num_samples, latents=lat, **kwargs)
            return images.cpu().numpy()
        return np.concatenate(
            [pipe(req.prompt, height=height, width=width, num_samples=1,
                  latents=lat[i:i + 1], **kwargs).cpu().numpy()
             for i in range(req.num_samples)], axis=0)
