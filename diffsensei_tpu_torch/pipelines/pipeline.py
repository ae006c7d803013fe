"""DiffSensei inference pipeline: prompt -> manga panel (port of
``diffsensei_tpu/pipelines/pipeline.py``).

Two CLIP text encoders, CLIP-H + Magi ViTMAE + Resampler for the
characters, masked-IP biases built once per call per attention level, a CFG
sampler loop over ``UNetMangaModel`` (a Python loop; the JAX package's
``fori_loop``: Euler, DDIM or DPM-Solver++ 2M by ``PipelineConfig.scheduler``,
with the JAX package's DeepCache), and the fp32 VAE decode. CFG rows are
``[uncond | cond]``; the uncond half gets all-zero boxes (ROADMAP trap C4).
The SEED-X agent's per-character tokens (``ip_image_embeds``) are pasted
over the resampler's character block.

The decode goes through ``tiled_decode`` (tile 96, overlap 24) whenever a
latent side exceeds 128, as the JAX ``_decode_any`` does: every 1024-class
bucket but 1024x1024 is decoded in tiles.

Over a device mesh (``DiffSenseiPipeline(mesh=...)``, the JAX pipeline's
``mesh``) the pipeline serves in one of two modes. Batched: each rank of the
data axis runs the UNet on its contiguous block of the CFG batch and the
noise predictions are all-gathered before the CFG combine and the sampler
step, which stay replicated, as the decode does. Context-parallel
(``PipelineConfig.context_parallel``): the spatial self-attentions of at
least ``context_parallel_min_seq`` tokens run as ring attention over the
data axis, everything else replicated. Each rank then holds the whole panel.

Left for later slices: CUDA graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from diffsensei_tpu_torch.core.buckets import snap_to_bucket
from diffsensei_tpu_torch.core.config import (
    MangaConfig, PipelineConfig, ResamplerConfig, TextEncoderConfig, UNetConfig,
    VAEConfig, VisionEncoderConfig)
from diffsensei_tpu_torch.models.resampler import Resampler
from diffsensei_tpu_torch.models.schedulers import (
    SamplerState, make_sampler, multistep_step, scale_model_input, step as scheduler_step)
from diffsensei_tpu_torch.models.text_encoder import CLIPTextEncoder
from diffsensei_tpu_torch.models.unet import (
    UNetMangaModel, attention_levels, level_spatial_shape)
from diffsensei_tpu_torch.models.vae import AutoencoderKL, tile_plan, tiled_decode
from diffsensei_tpu_torch.models.vision_encoder import VisionTransformer
from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu_torch.parallel.mesh import data_group, shard_batch
from diffsensei_tpu_torch.utils.init import init_flax_like_
from diffsensei_tpu_torch.utils.observability import span


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
    device: Optional[torch.device] = None   # where ``build`` put (or will put) the weights

    INITS = ("random", "zeros", "none")

    @property
    def manga(self) -> MangaConfig:
        return self.unet.config.manga

    @classmethod
    def build(cls, configs: Dict[str, Any], dtype: torch.dtype = torch.float32,
              device="cuda", seed: int = 0, init: str = "random",
              channels_last: bool = False) -> "PipelineModules":
        """Modules for ``configs`` on ``device``; the VAE is always fp32.
        ``init``: "random" draws flax-like weights from ``seed``; "zeros"
        fills every parameter with zeros (the JAX ``init="zeros"``); "none"
        leaves the modules on the meta device for a checkpoint loader
        (``utils/load.py``), then ``fill_missing_params``. ``channels_last``
        lays the UNet's and the VAE's conv weights out for NHWC inputs."""
        if init not in cls.INITS:
            raise ValueError(f"init must be one of {cls.INITS}, got {init!r}")
        device = torch.device(device)
        with torch.device("meta"):
            mods = cls(
                unet=UNetMangaModel(configs["unet"], dtype),
                vae=AutoencoderKL(configs["vae"], torch.float32),
                text_encoder=CLIPTextEncoder(configs["text_encoder"], dtype),
                text_encoder_2=CLIPTextEncoder(configs["text_encoder_2"], dtype),
                image_encoder=VisionTransformer(configs["image_encoder"], dtype),
                magi_encoder=VisionTransformer(configs["magi_encoder"], dtype),
                resampler=Resampler(configs["resampler"], dtype), device=device)
        if init == "random":
            gen = torch.Generator(device=device).manual_seed(seed)
            for mod in mods.networks().values():
                init_flax_like_(mod.to_empty(device=device), gen)
        if channels_last:
            for mod in (mods.unet, mods.vae):
                mod.to(memory_format=torch.channels_last)
        for mod in mods.networks().values():
            mod.eval().requires_grad_(False)
        if init == "zeros":
            mods.fill_missing_params()
        return mods

    @classmethod
    def tiny(cls, device="cuda", seed: int = 0, lora_rank: int = 0,
             init: str = "random") -> "PipelineModules":
        """The tiny stack of the JAX ``PipelineModules.tiny`` configs (the CPU
        tests pass ``device="cpu"``), UNet adapters of ``lora_rank``."""
        cfgs = tiny_configs()
        cfgs["unet"] = dataclasses.replace(cfgs["unet"], lora_rank=lora_rank)
        return cls.build(cfgs, torch.float32, device, seed, init)

    @classmethod
    def sdxl(cls, device="cuda", seed: int = 0, lora_rank: int = 0,
             init: str = "random") -> "PipelineModules":
        """Full-width stack: SDXL UNet with the manga modules and the
        encoders in bf16, fp32 VAE (CLIP-L + OpenCLIP-bigG, CLIP ViT-H + Magi
        ViTMAE, the DiffSensei Resampler); weights by ``init`` (random from
        ``seed`` by default; the JAX ``sdxl``'s default is zeros); UNet
        adapters of ``lora_rank``; the UNet's and VAE's conv weights
        ``channels_last``."""
        cfgs = sdxl_configs()
        cfgs["unet"] = dataclasses.replace(cfgs["unet"], lora_rank=lora_rank)
        return cls.build(cfgs, torch.bfloat16, device, seed, init, channels_last=True)

    def fill_missing_params(self, device=None) -> None:
        """Zero-fill every parameter still on the meta device, on ``device``
        (default ``build``'s), in its dtype and layout; loaded weights stay
        (the JAX ``fill_missing_params``, which zero-fills the components
        whose trees are still ``None``)."""
        device = torch.device(device) if device is not None else self.device
        for mod in self.networks().values():
            current = mod.state_dict(keep_vars=True)
            zeros = {name: torch.empty_strided(p.shape, p.stride(), dtype=p.dtype,
                                               device=device).zero_()
                     for name, p in current.items() if p.is_meta}
            if zeros:
                mod.load_state_dict(zeros, strict=len(zeros) == len(current), assign=True)
                mod.eval().requires_grad_(False)

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
             callback: Optional[Callable[[int, torch.Tensor], None]] = None,
             cache_interval: Optional[int] = None, cache_split: int = 2,
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The CFG sampler loop; conditioning arrives doubled ``[uncond; cond]``
    on dim 0. DPM-Solver++ carries the previous step's x0 (zeros at step 0).
    With ``group`` each of its ranks runs the UNet on its contiguous block of
    the CFG rows and the predictions are all-gathered (the deep feature of
    DeepCache stays with its rows).

    ``cache_interval=N`` is DeepCache: the UNet's deep subtree (levels >=
    ``cache_split`` and the mid block) runs on every N-th step, and the
    steps between reuse its feature (the JAX ``lax.cond(i % N == 0, full,
    cached)`` as a host ``if``). N = 1 is exact; N > 1 approximates."""
    def unet_eps(lat_in, t, **kw):
        rows = dict(lat_in=lat_in, t=t, ctx=ctx, pooled=pooled, time_ids=time_ids,
                    dialog_bbox=dialog_bbox)
        rows.update({} if ip_tokens is None else dict(ip_tokens=ip_tokens))
        rows.update({f"bias{lv}": b for lv, b in (ip_biases or {}).items()})
        if group is not None:
            rows = shard_batch(rows, dist.get_rank(group), dist.get_world_size(group))
        out = unet(rows["lat_in"], rows["t"], rows["ctx"], rows["pooled"], rows["time_ids"],
                   ip_hidden_states=rows.get("ip_tokens"),
                   ip_attn_bias=None if ip_biases is None else
                   {lv: rows[f"bias{lv}"] for lv in ip_biases},
                   ip_scale=ip_scale, dialog_bbox=rows["dialog_bbox"], **kw)
        if group is None:
            return out
        eps, deep = out if kw.get("return_deep") else (out, None)
        parts = [torch.empty_like(eps) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, eps.contiguous(), group=group)
        eps = torch.cat(parts, dim=0)
        return (eps, deep) if kw.get("return_deep") else eps

    deep = None       # step 0 is a full step, so nothing reads a cache before one exists
    prev_x0 = torch.zeros_like(latents) if sampler.is_multistep else None
    lat = latents
    for i in range(sampler.num_steps):
        with span("denoise.step", i=i):
            lat_in = scale_model_input(sampler, torch.cat([lat, lat], dim=0), i)
            t = sampler.timesteps[i].expand(lat_in.shape[0])
            with span("denoise.unet"):
                if cache_interval is None:
                    eps = unet_eps(lat_in, t)
                elif i % cache_interval == 0:
                    eps, deep = unet_eps(lat_in, t, return_deep=True, cache_split=cache_split)
                else:
                    eps = unet_eps(lat_in, t, deep_feature=deep, cache_split=cache_split)
            with span("denoise.sampler"):
                eps_neg, eps_pos = eps.float().chunk(2, dim=0)
                guided = eps_neg + guidance_scale * (eps_pos - eps_neg)
                if sampler.is_multistep:
                    lat, prev_x0 = multistep_step(sampler, guided, i, lat, prev_x0)
                else:
                    lat = scheduler_step(sampler, guided, i, lat)
            if callback is not None:
                callback(i, lat)
    return lat


def _decode(vae: AutoencoderKL, latents: torch.Tensor, scaling_factor: float) -> torch.Tensor:
    """fp32 decode to [0, 1]; a latent side above 128 goes through
    ``tiled_decode`` (the JAX ``_decode_any``), else the latent is decoded
    whole."""
    z = latents.float() / scaling_factor
    tiled = max(z.shape[1:3]) > 128
    with span("pipeline.decode", tiled=tiled,
              tiles=len(tile_plan(*z.shape[1:3])) if tiled else 1):
        img = tiled_decode(vae, z) if tiled else vae.decode(z)
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


class DiffSenseiPipeline:
    """End-to-end manga panel generation (the wo-MLLM path)."""

    def __init__(self, modules: PipelineModules, config: PipelineConfig = PipelineConfig(),
                 mesh=None):
        """``mesh``: a ``(data, model)`` device mesh (``parallel.mesh.make_mesh``)
        for the batched or, with ``config.context_parallel``, the
        context-parallel mode; each needs every rank to make the same call."""
        self.m = modules
        self.config = config
        self.mesh = mesh
        self.group = None if mesh is None else data_group(mesh)
        self.vae_scaling = modules.vae.config.scaling_factor
        self.latent_scale = modules.vae.config.downscale_factor

    @property
    def device(self) -> torch.device:
        return self.m.unet.conv_in.weight.device

    def _ids(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):      # a tokenized prompt, already on the card
            return ids.to(self.device, torch.long)
        return torch.as_tensor(np.ascontiguousarray(ids), dtype=torch.long,
                               device=self.device)

    def _tokenize(self, tokenizer, text: str) -> torch.Tensor:
        if tokenizer is None:
            raise ValueError("pipeline built without tokenizers; pass token ids")
        out = tokenizer(text, padding="max_length", max_length=77, truncation=True,
                        return_tensors="np")
        return self._ids(out["input_ids"])

    def encode_prompt(self, prompt: str, negative_prompt: str = "", ids=None,
                      neg_ids=None, ids_2=None, neg_ids_2=None,
                      prompt_2: Optional[str] = None,
                      negative_prompt_2: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(ctx [2, 77, D_cross], pooled [2, P])``, row 0 negative.
        ``prompt_2`` / ``negative_prompt_2`` go to the second (OpenCLIP-bigG)
        encoder (the SDXL dual prompt); they default to the primary ones."""
        m = self.m
        if ids is None:
            ids = self._tokenize(m.tokenizer, prompt)
            neg_ids = self._tokenize(m.tokenizer, negative_prompt)
        if ids_2 is None:
            if m.tokenizer_2 is None and m.tokenizer is None:
                ids_2, neg_ids_2 = ids, neg_ids
            else:
                tok2 = m.tokenizer_2 or m.tokenizer
                ids_2 = self._tokenize(tok2, prompt if prompt_2 is None else prompt_2)
                neg_ids_2 = self._tokenize(tok2, negative_prompt if negative_prompt_2 is None
                                           else negative_prompt_2)
        both = torch.cat([self._ids(neg_ids), self._ids(ids)], dim=0)
        both_2 = torch.cat([self._ids(neg_ids_2), self._ids(ids_2)], dim=0)
        h1, _ = m.text_encoder(both)
        h2, pooled = m.text_encoder_2(both_2)
        return torch.cat([h1, h2], dim=-1), pooled

    def check_inputs(self, prompt, ip_pixel_values=None, ip_image_embeds=None,
                     ip_bbox=None, dialog_bbox=None, num_samples: int = 1):
        """The reference's input contract (``check_inputs``); pixels and
        embeds may come together (the embeds paste over)."""
        manga = self.m.manga
        if prompt is not None and not isinstance(prompt, str):
            raise ValueError(f"prompt must be a string, got {type(prompt)}")
        if num_samples < 1:
            raise ValueError("num_samples must be >= 1")
        n_chars = 0 if ip_pixel_values is None else ip_pixel_values.shape[0]
        if n_chars > manga.max_num_ips:
            raise ValueError(f"{n_chars} character images > max_num_ips="
                             f"{manga.max_num_ips}")
        if ip_image_embeds is not None and ip_image_embeds.shape[-2] % manga.num_vision_tokens:
            raise ValueError("ip_image_embeds token count must be a multiple of "
                             f"num_vision_tokens={manga.num_vision_tokens}")
        if ip_bbox is not None and len(ip_bbox) > manga.max_num_ips:
            raise ValueError(f"{len(ip_bbox)} character bboxes > max_num_ips="
                             f"{manga.max_num_ips}")
        if (ip_bbox is not None and 0 < n_chars < manga.max_num_ips
                and len(ip_bbox) < n_chars):
            raise ValueError(f"{n_chars} character images but only {len(ip_bbox)} bboxes")
        if dialog_bbox is not None and len(dialog_bbox) > manga.max_num_dialogs:
            raise ValueError(f"{len(dialog_bbox)} dialog bboxes > max_num_dialogs="
                             f"{manga.max_num_dialogs}")

    def prepare_ip_image_embeds(self, ip_pixel_values: Optional[torch.Tensor],
                                ip_image_embeds: Optional[torch.Tensor] = None,
                                num_valid: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Character crops ``[n <= max_num_ips, 224, 224, 3]`` -> resampled
        ``(positive, negative)`` IP tokens, each ``[1, D + I*V, D_cross]``.

        Crops are padded with black to ``max_num_ips``; the padding
        characters' embeddings are zeroed through ``num_valid``. Without
        crops the resampler sees all-zero character features.
        ``ip_image_embeds`` ``[n, V, D_cross]`` (the agent's per-character
        blocks) are pasted over the positive block after the dummy tokens."""
        m = self.m
        manga = m.manga
        if ip_pixel_values is not None:
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
        else:
            p = m.resampler.config
            clip_h = torch.zeros((1, manga.max_num_ips, m.image_encoder.config.seq_len,
                                  p.embedding_dim), device=self.device)
            magi_cls = torch.zeros((1, manga.max_num_ips, p.magi_embedding_dim),
                                   device=self.device)
        pos = m.resampler(clip_h, magi_cls)
        neg = m.resampler(torch.zeros_like(clip_h), torch.zeros_like(magi_cls))
        if ip_image_embeds is not None:
            nv, v = ip_image_embeds.shape[0], manga.num_vision_tokens
            start = manga.num_dummy_tokens
            pos = pos.clone()
            pos[:, start:start + nv * v] = torch.as_tensor(ip_image_embeds).reshape(
                1, nv * v, -1).to(pos.device, pos.dtype)
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
    def __call__(self, prompt: str = "", *, prompt_2: Optional[str] = None,
                 height: int = 1024, width: int = 1024,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 negative_prompt: Optional[str] = None,
                 negative_prompt_2: Optional[str] = None,
                 original_size: Optional[Tuple[int, int]] = None,
                 crops_coords_top_left: Tuple[int, int] = (0, 0),
                 target_size: Optional[Tuple[int, int]] = None,
                 num_samples: int = 1, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 ip_pixel_values: Optional[torch.Tensor] = None,
                 ip_image_embeds: Optional[torch.Tensor] = None,
                 ip_bbox: Optional[Sequence[Sequence[float]]] = None,
                 ip_scale: Optional[float] = None,
                 dialog_bbox: Optional[Sequence[Sequence[float]]] = None,
                 snap_to_buckets: bool = True, prompt_ids: Optional[Dict] = None,
                 return_latents: bool = False,
                 callback: Optional[Callable[[int, torch.Tensor], None]] = None,
                 deep_cache_interval: Optional[int] = None, deep_cache_split: int = 2
                 ) -> torch.Tensor:
        """Generate panels: ``[num_samples, H, W, 3]`` fp32 in [0, 1].

        ``latents``: a standard-normal draw ``[num_samples, H/8, W/8, C]``
        replacing the ``generator`` draw (the diffusers ``latents=`` surface),
        so a caller can split a request across calls, or feed two
        implementations the same draw. ``callback(i, latents)`` sees the
        latents after every denoising step. ``prompt_2`` /
        ``negative_prompt_2`` feed the second text encoder (default: the
        primary prompts). ``ip_image_embeds``
        ``[n, V, D_cross]`` are pasted over the encoded characters.
        ``deep_cache_interval=N`` (opt-in) recomputes the UNet's deep subtree
        (levels >= ``deep_cache_split`` and the mid block) on every N-th step
        only (``_denoise``); the masked-IP cross-attention of the shallow
        levels stays live on every step."""
        cfg = self.config
        m = self.m
        manga = m.manga
        dev = self.device
        steps = num_inference_steps or cfg.num_inference_steps
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        ipscale = cfg.ip_scale if ip_scale is None else ip_scale
        neg = cfg.negative_prompt if negative_prompt is None else negative_prompt

        self.check_inputs(prompt, ip_pixel_values, ip_image_embeds, ip_bbox, dialog_bbox,
                          num_samples)
        if snap_to_buckets:
            height, width = snap_to_bucket(height, width)
        lh, lw = height // self.latent_scale, width // self.latent_scale

        with span("pipeline.conditioning"):
            with span("pipeline.encode_prompt"):
                ctx, pooled = self.encode_prompt(prompt, neg, prompt_2=prompt_2,
                                                 negative_prompt_2=negative_prompt_2,
                                                 **(prompt_ids or {}))

            use_ip = ((ip_pixel_values is not None or ip_image_embeds is not None)
                      and m.resampler is not None)
            ip_tokens, ip_biases = None, None
            if use_ip:
                with span("pipeline.ip_embeds"):
                    pos, negt = self.prepare_ip_image_embeds(
                        ip_pixel_values, ip_image_embeds,
                        None if ip_bbox is None else len(ip_bbox))
                    ip_tokens = torch.cat([negt.expand(num_samples, -1, -1),
                                           pos.expand(num_samples, -1, -1)], dim=0)
            with span("pipeline.ip_bias"):
                ip_bbox_arr, dialog_arr = self._prepare_bboxes(ip_bbox, dialog_bbox,
                                                               num_samples)
                if use_ip:
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

        # batched over the data axis where the CFG rows split evenly over it
        batch_group = None
        if self.group is not None and not cfg.context_parallel \
                and (2 * num_samples) % dist.get_world_size(self.group) == 0:
            batch_group = self.group
        cp_before = (m.unet.cp_group, m.unet.cp_min_seq)
        if self.group is not None and cfg.context_parallel:
            m.unet.set_context_parallel(self.group, cfg.context_parallel_min_seq)
        try:
            latents = _denoise(
                m.unet, sampler, latents, ctx.repeat_interleave(num_samples, dim=0),
                pooled.repeat_interleave(num_samples, dim=0), time_ids, ip_tokens,
                ip_biases, dialog_arr, gscale, ipscale, callback, deep_cache_interval,
                deep_cache_split, batch_group)
        finally:
            m.unet.set_context_parallel(*cp_before)
        if return_latents:
            return latents
        return _decode(m.vae, latents, self.vae_scaling)
