"""DiffSensei inference pipeline: prompt -> manga panel (port of
``diffsensei_tpu/pipelines/pipeline.py``).

The wo-MLLM path: two CLIP text encoders, CLIP-H + Magi ViTMAE + Resampler
for the characters, masked-IP biases built once per call per attention
level, a CFG Euler loop over ``UNetMangaModel`` (a Python loop; the JAX
package's ``fori_loop``), and the fp32 VAE decode. CFG rows are
``[uncond | cond]``; the uncond half gets all-zero boxes (ROADMAP trap C4).

Left for later slices: the other samplers, DeepCache, the MLLM paste-over
(``ip_image_embeds``), the tiled decode above 1024², CUDA graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from diffsensei_tpu_torch.core.buckets import snap_to_bucket
from diffsensei_tpu_torch.core.config import (
    MangaConfig, PipelineConfig, ResamplerConfig, TextEncoderConfig, UNetConfig,
    VAEConfig, VisionEncoderConfig)
from diffsensei_tpu_torch.models.resampler import Resampler
from diffsensei_tpu_torch.models.schedulers import (
    SamplerState, make_sampler, scale_model_input, step as scheduler_step)
from diffsensei_tpu_torch.models.text_encoder import CLIPTextEncoder
from diffsensei_tpu_torch.models.unet import (
    UNetMangaModel, attention_levels, level_spatial_shape)
from diffsensei_tpu_torch.models.vae import AutoencoderKL
from diffsensei_tpu_torch.models.vision_encoder import VisionTransformer
from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu_torch.utils.init import init_flax_like_


def tiny_configs() -> Dict[str, Any]:
    """The configs of the JAX package's ``PipelineModules.tiny``."""
    manga = MangaConfig(max_num_ips=2, num_vision_tokens=4, num_dummy_tokens=4,
                        max_num_dialogs=3)
    ucfg = UNetConfig.tiny(manga)
    t1 = dataclasses.replace(TextEncoderConfig.tiny(), hidden_size=16,
                             intermediate_size=32)
    t2 = dataclasses.replace(
        TextEncoderConfig.tiny(projection_dim=ucfg.pooled_projection_dim),
        hidden_size=ucfg.cross_attention_dim - t1.hidden_size)
    icfg = VisionEncoderConfig.tiny()
    mcfg = dataclasses.replace(VisionEncoderConfig.tiny(), hidden_size=16)
    rcfg = dataclasses.replace(
        ResamplerConfig.tiny(manga), embedding_dim=icfg.hidden_size,
        magi_embedding_dim=mcfg.hidden_size, output_dim=ucfg.cross_attention_dim)
    return dict(unet=ucfg, vae=VAEConfig.tiny(), text_encoder=t1, text_encoder_2=t2,
                image_encoder=icfg, magi_encoder=mcfg, resampler=rcfg)


def sdxl_configs() -> Dict[str, Any]:
    """The configs of the JAX package's ``PipelineModules.sdxl``."""
    return dict(unet=UNetConfig.sdxl(MangaConfig()), vae=VAEConfig.sdxl(),
                text_encoder=TextEncoderConfig.clip_l(),
                text_encoder_2=TextEncoderConfig.clip_bigg(),
                image_encoder=VisionEncoderConfig.clip_vit_h(),
                magi_encoder=VisionEncoderConfig.magi_vitmae(),
                resampler=ResamplerConfig.diffsensei())


@dataclasses.dataclass
class PipelineModules:
    """The modules of every pipeline stage, with their weights."""

    unet: UNetMangaModel
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    text_encoder_2: CLIPTextEncoder
    image_encoder: Optional[VisionTransformer] = None
    magi_encoder: Optional[VisionTransformer] = None
    resampler: Optional[Resampler] = None
    tokenizer: Any = None      # callable(str, ...) like an HF tokenizer, or None
    tokenizer_2: Any = None

    @property
    def manga(self) -> MangaConfig:
        return self.unet.config.manga

    @classmethod
    def build(cls, configs: Dict[str, Any], dtype: torch.dtype = torch.float32,
              device="cpu", seed: int = 0) -> "PipelineModules":
        """Modules for ``configs`` with flax-like random weights drawn on
        ``device`` from ``seed``. The VAE is always fp32."""
        device = torch.device(device)
        with torch.device("meta"):
            mods = cls(
                unet=UNetMangaModel(configs["unet"], dtype),
                vae=AutoencoderKL(configs["vae"], torch.float32),
                text_encoder=CLIPTextEncoder(configs["text_encoder"], dtype),
                text_encoder_2=CLIPTextEncoder(configs["text_encoder_2"], dtype),
                image_encoder=VisionTransformer(configs["image_encoder"], dtype),
                magi_encoder=VisionTransformer(configs["magi_encoder"], dtype),
                resampler=Resampler(configs["resampler"], dtype))
        gen = torch.Generator(device=device).manual_seed(seed)
        for mod in mods.networks().values():
            init_flax_like_(mod.to_empty(device=device), gen).eval()
            mod.requires_grad_(False)
        return mods

    @classmethod
    def tiny(cls, device="cpu", seed: int = 0) -> "PipelineModules":
        """CPU-testable tiny stack (the JAX ``PipelineModules.tiny`` configs)."""
        return cls.build(tiny_configs(), torch.float32, device, seed)

    @classmethod
    def sdxl(cls, device="cuda", seed: int = 0) -> "PipelineModules":
        """Full-width stack: SDXL UNet with the manga modules and the
        encoders in bf16, fp32 VAE (CLIP-L + OpenCLIP-bigG, CLIP ViT-H + Magi
        ViTMAE, the DiffSensei Resampler); random weights from ``seed``."""
        mods = cls.build(sdxl_configs(), torch.bfloat16, device, seed)
        for mod in (mods.unet, mods.vae):
            mod.to(memory_format=torch.channels_last)  # conv weights for NHWC inputs
        return mods

    def networks(self) -> Dict[str, torch.nn.Module]:
        """The stages' modules by field name (absent ones left out)."""
        names = ("unet", "vae", "text_encoder", "text_encoder_2", "image_encoder",
                 "magi_encoder", "resampler")
        return {n: getattr(self, n) for n in names if getattr(self, n) is not None}


# ---------------------------------------------------------------------------
# the denoising loop and the decode
# ---------------------------------------------------------------------------
def _denoise(unet: UNetMangaModel, sampler: SamplerState, latents: torch.Tensor,
             ctx, pooled, time_ids, ip_tokens, ip_biases, dialog_bbox,
             guidance_scale: float, ip_scale: float,
             callback: Optional[Callable[[int, torch.Tensor], None]] = None
             ) -> torch.Tensor:
    """CFG Euler loop; conditioning arrives doubled ``[uncond; cond]`` on dim 0."""
    lat = latents
    for i in range(sampler.num_steps):
        lat_in = scale_model_input(sampler, torch.cat([lat, lat], dim=0), i)
        t = sampler.timesteps[i].expand(lat_in.shape[0])
        eps = unet(lat_in, t, ctx, pooled, time_ids, ip_hidden_states=ip_tokens,
                   ip_attn_bias=ip_biases, ip_scale=ip_scale,
                   dialog_bbox=dialog_bbox).float()
        eps_neg, eps_pos = eps.chunk(2, dim=0)
        lat = scheduler_step(sampler, eps_neg + guidance_scale * (eps_pos - eps_neg),
                             i, lat)
        if callback is not None:
            callback(i, lat)
    return lat


def _decode(vae: AutoencoderKL, latents: torch.Tensor, scaling_factor: float) -> torch.Tensor:
    img = vae.decode(latents.float() / scaling_factor)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


class DiffSenseiPipeline:
    """End-to-end manga panel generation (the wo-MLLM path)."""

    def __init__(self, modules: PipelineModules, config: PipelineConfig = PipelineConfig()):
        self.m = modules
        self.config = config
        self.vae_scaling = modules.vae.config.scaling_factor
        self.latent_scale = modules.vae.config.downscale_factor

    @property
    def device(self) -> torch.device:
        return self.m.unet.conv_in.weight.device

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(ids), dtype=torch.long,
                               device=self.device)

    def _tokenize(self, tokenizer, text: str) -> torch.Tensor:
        if tokenizer is None:
            raise ValueError("pipeline built without tokenizers; pass token ids")
        out = tokenizer(text, padding="max_length", max_length=77, truncation=True,
                        return_tensors="np")
        return self._ids(out["input_ids"])

    def encode_prompt(self, prompt: str, negative_prompt: str = "", ids=None,
                      neg_ids=None, ids_2=None, neg_ids_2=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(ctx [2, 77, D_cross], pooled [2, P])``, row 0 negative."""
        m = self.m
        if ids is None:
            ids = self._tokenize(m.tokenizer, prompt)
            neg_ids = self._tokenize(m.tokenizer, negative_prompt)
        if ids_2 is None:
            if m.tokenizer_2 is None and m.tokenizer is None:
                ids_2, neg_ids_2 = ids, neg_ids
            else:
                tok2 = m.tokenizer_2 or m.tokenizer
                ids_2 = self._tokenize(tok2, prompt)
                neg_ids_2 = self._tokenize(tok2, negative_prompt)
        both = torch.cat([self._ids(neg_ids), self._ids(ids)], dim=0)
        both_2 = torch.cat([self._ids(neg_ids_2), self._ids(ids_2)], dim=0)
        h1, _ = m.text_encoder(both)
        h2, pooled = m.text_encoder_2(both_2)
        return torch.cat([h1, h2], dim=-1), pooled

    def check_inputs(self, prompt, ip_pixel_values, ip_bbox, dialog_bbox, num_samples):
        """The reference's input contract (``check_inputs``)."""
        manga = self.m.manga
        if prompt is not None and not isinstance(prompt, str):
            raise ValueError(f"prompt must be a string, got {type(prompt)}")
        if num_samples < 1:
            raise ValueError("num_samples must be >= 1")
        n_chars = 0 if ip_pixel_values is None else ip_pixel_values.shape[0]
        if n_chars > manga.max_num_ips:
            raise ValueError(f"{n_chars} character images > max_num_ips="
                             f"{manga.max_num_ips}")
        if ip_bbox is not None and len(ip_bbox) > manga.max_num_ips:
            raise ValueError(f"{len(ip_bbox)} character bboxes > max_num_ips="
                             f"{manga.max_num_ips}")
        if (ip_bbox is not None and 0 < n_chars < manga.max_num_ips
                and len(ip_bbox) < n_chars):
            raise ValueError(f"{n_chars} character images but only {len(ip_bbox)} bboxes")
        if dialog_bbox is not None and len(dialog_bbox) > manga.max_num_dialogs:
            raise ValueError(f"{len(dialog_bbox)} dialog bboxes > max_num_dialogs="
                             f"{manga.max_num_dialogs}")

    def prepare_ip_image_embeds(self, ip_pixel_values: torch.Tensor,
                                num_valid: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Character crops ``[n <= max_num_ips, 224, 224, 3]`` -> resampled
        ``(positive, negative)`` IP tokens, each ``[1, D + I*V, D_cross]``.

        Crops are padded with black to ``max_num_ips``; the padding
        characters' embeddings are zeroed through ``num_valid``."""
        m = self.m
        manga = m.manga
        pixels = torch.as_tensor(ip_pixel_values, dtype=torch.float32).to(self.device)
        n_ips = pixels.shape[0]
        if n_ips < manga.max_num_ips:
            pad = pixels.new_zeros((manga.max_num_ips - n_ips,) + tuple(pixels.shape[1:]))
            pixels = torch.cat([pixels, pad], dim=0)
            num_valid = n_ips if num_valid is None else min(num_valid, n_ips)
            n_ips = manga.max_num_ips
        clip_h, _ = m.image_encoder(pixels)
        _, magi_cls = m.magi_encoder(pixels)
        clip_h, magi_cls = clip_h[None], magi_cls[None]
        if num_valid is not None and num_valid < n_ips:
            valid = (torch.arange(n_ips, device=self.device) < num_valid).to(clip_h.dtype)
            clip_h = clip_h * valid[None, :, None, None]
            magi_cls = magi_cls * valid[None, :, None]
        pos = m.resampler(clip_h, magi_cls)
        neg = m.resampler(torch.zeros_like(clip_h), torch.zeros_like(magi_cls))
        return pos, neg

    def _prepare_bboxes(self, ip_bbox, dialog_bbox, num_samples: int):
        """CFG box batches ``[uncond | cond]``; the uncond half is all zeros, so
        the negative branch attends only the dummy block and gets no dialog
        embedding."""
        manga = self.m.manga

        def cfg_pad(boxes, max_n):
            arr = np.zeros((max_n, 4), np.float32)
            if boxes is not None:
                boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
                arr[:min(len(boxes), max_n)] = boxes[:max_n]
            out = np.zeros((2 * num_samples, max_n, 4), np.float32)
            out[num_samples:] = arr[None]
            return torch.from_numpy(out).to(self.device)

        return (cfg_pad(ip_bbox, manga.max_num_ips),
                cfg_pad(dialog_bbox, manga.max_num_dialogs))

    @torch.inference_mode()
    def __call__(self, prompt: str = "", *, height: int = 1024, width: int = 1024,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 negative_prompt: Optional[str] = None,
                 original_size: Optional[Tuple[int, int]] = None,
                 crops_coords_top_left: Tuple[int, int] = (0, 0),
                 target_size: Optional[Tuple[int, int]] = None,
                 num_samples: int = 1, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 ip_pixel_values: Optional[torch.Tensor] = None,
                 ip_bbox: Optional[Sequence[Sequence[float]]] = None,
                 ip_scale: Optional[float] = None,
                 dialog_bbox: Optional[Sequence[Sequence[float]]] = None,
                 snap_to_buckets: bool = True, prompt_ids: Optional[Dict] = None,
                 return_latents: bool = False,
                 callback: Optional[Callable[[int, torch.Tensor], None]] = None
                 ) -> torch.Tensor:
        """Generate panels: ``[num_samples, H, W, 3]`` fp32 in [0, 1].

        ``latents``: a standard-normal draw ``[num_samples, H/8, W/8, C]``
        replacing the ``generator`` draw (the diffusers ``latents=`` surface),
        so a caller can split a request across calls, or feed two
        implementations the same draw. ``callback(i, latents)`` sees the
        latents after every denoising step."""
        cfg = self.config
        m = self.m
        manga = m.manga
        dev = self.device
        steps = num_inference_steps or cfg.num_inference_steps
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        ipscale = cfg.ip_scale if ip_scale is None else ip_scale
        neg = cfg.negative_prompt if negative_prompt is None else negative_prompt

        self.check_inputs(prompt, ip_pixel_values, ip_bbox, dialog_bbox, num_samples)
        if snap_to_buckets:
            height, width = snap_to_bucket(height, width)
        lh, lw = height // self.latent_scale, width // self.latent_scale

        ctx, pooled = self.encode_prompt(prompt, neg, **(prompt_ids or {}))

        use_ip = ip_pixel_values is not None and m.resampler is not None
        ip_tokens, ip_biases = None, None
        ip_bbox_arr, dialog_arr = self._prepare_bboxes(ip_bbox, dialog_bbox, num_samples)
        if use_ip:
            pos, negt = self.prepare_ip_image_embeds(
                ip_pixel_values, None if ip_bbox is None else len(ip_bbox))
            ip_tokens = torch.cat([negt.expand(num_samples, -1, -1),
                                   pos.expand(num_samples, -1, -1)], dim=0)
            ucfg = m.unet.config
            ip_biases = {
                level: build_ip_attention_bias(
                    ip_bbox_arr, *level_spatial_shape(ucfg, lh, lw, level),
                    manga.num_vision_tokens, manga.num_dummy_tokens)
                for level in attention_levels(ucfg)}

        orig = original_size or (height, width)
        tgt = target_size or (height, width)
        time_ids = torch.tensor([[orig[0], orig[1], crops_coords_top_left[0],
                                  crops_coords_top_left[1], tgt[0], tgt[1]]],
                                dtype=torch.float32, device=dev)
        time_ids = time_ids.expand(2 * num_samples, -1)

        lat_shape = (num_samples, lh, lw, m.unet.config.in_channels)
        if latents is None:
            gen_dev = generator.device if generator is not None else dev
            latents = torch.randn(lat_shape, generator=generator, device=gen_dev)
        elif tuple(latents.shape) != lat_shape:
            raise ValueError(f"latents must be {lat_shape}, got {tuple(latents.shape)}")
        sampler = make_sampler(cfg.scheduler, steps).to(dev)
        latents = latents.to(dev, torch.float32) * sampler.init_noise_sigma

        latents = _denoise(
            m.unet, sampler, latents, ctx.repeat_interleave(num_samples, dim=0),
            pooled.repeat_interleave(num_samples, dim=0), time_ids, ip_tokens,
            ip_biases, dialog_arr, gscale, ipscale, callback)
        if return_latents:
            return latents
        return _decode(m.vae, latents, self.vae_scaling)
