"""Stage-3 training: the SEED-X agent as the character-feature adapter (port
of ``diffsensei_tpu/train/mllm_step.py``).

The diffusion stack (VAE, encoders, Resampler, UNet) is frozen; only the
agent trains: the LoRA adapters, embeddings, ``lm_head`` and norms of the
LLaMA, and both Qwen resamplers (``agent_trainables``). Per step
(``scripts/train/train_mllm.py:330-420`` in the reference):

1. encode the panel, draw the noise and timesteps, and encode the character
   crops through the frozen encoders and Resampler, as stage 2 does;
2. give the agent ``[source character block, target character block]`` per
   sample (the Resampler's output without its dummy tokens);
3. the agent's LM and reconstruction losses (``ContinuousLVLM.loss``);
4. paste the agent's reconstructed character block over the UNet context's
   character tokens, so that the diffusion MSE back-propagates through the
   frozen UNet into the agent;
5. ``loss = diffusion_mse + mllm_loss_weight * (lm_scale lm + rec_scale rec)``.

``loss_fn`` draws as stage 2's does (latent-sample noise, diffusion noise,
timesteps from ``generator``) or takes the draws as tensors. Under ``group``
(data parallelism) the draws are the global batch's, and the diffusion, LM
and reconstruction means are each scaled to the rank's share of the global
mean over its own count (rows, supervised tokens, rows with a generation
image), as ``train/diffusion.py`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from diffsensei_tpu_torch.core.config import MangaConfig
from diffsensei_tpu_torch.models.mllm.peft import lora_trainable_mask
from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
from diffsensei_tpu_torch.models.unet import attention_levels, level_spatial_shape
from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu_torch.parallel.train import rank_weight
from diffsensei_tpu_torch.train import losses
from diffsensei_tpu_torch.train.diffusion import (
    Batch, FrozenDiffusionStack, _diffusion_loss, _encode_latents, _encode_text, _make_step,
    _noise_and_t, _time_ids)
from diffsensei_tpu_torch.train.optim import partition_params


@dataclasses.dataclass(frozen=True)
class Stage3Config:
    manga: MangaConfig
    mllm_loss_weight: float = 1.0


def agent_trainables(agent) -> Dict[str, nn.Parameter]:
    """The agent's trainables by name (``llm.<name>``, ``input_resampler.<name>``,
    ``output_resampler.<name>``): the peft LoRA mask of the LLaMA and both
    resamplers whole. They become fp32 and trainable; the rest of the LLaMA
    stays frozen in its dtype, computing in it."""
    params = {}
    for prefix, mod, mask in (
            ("llm", agent.llm, lora_trainable_mask(agent.llm)),
            ("input_resampler", agent.input_resampler, None),
            ("output_resampler", agent.output_resampler, None)):
        mask = mask or {k: True for k, _ in mod.named_parameters()}
        trainable, _ = partition_params(mod, mask)
        params.update({f"{prefix}.{k}": p for k, p in trainable.items()})
    return params


def make_stage3_step(unet: nn.Module, resampler: nn.Module, agent, schedule: DDPMSchedule,
                     cfg: Stage3Config, group: Optional[dist.ProcessGroup] = None) -> Callable:
    """``step(state, frozen, batch, generator) -> metrics``; ``unet`` and
    ``resampler`` are frozen; ``group``: the data-parallel ranks.

    Batch: the stage-2 fields, plus ``target_ip_pixel_values`` /
    ``target_magi_pixel_values`` [B, I, 224, 224, 3], ``mllm_input_ids`` /
    ``mllm_labels`` / ``ids_cmp_mask`` / ``ids_gen_mask`` [B, L] and
    ``embeds_cmp_mask`` / ``embeds_gen_mask`` [B, 2]."""
    manga = cfg.manga

    def encode_chars(frozen, crops, magi_crops):
        clip_h, _ = frozen.image_encoder(crops)
        _, magi_cls = frozen.magi_encoder(magi_crops)
        return clip_h, magi_cls

    def loss_fn(frozen: FrozenDiffusionStack, batch: Batch,
                generator: Optional[torch.Generator] = None, *,
                latent_noise=None, noise=None, timesteps=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b, i, s = batch["ip_exists"].shape
        d = manga.num_dummy_tokens
        with torch.no_grad():
            latents = _encode_latents(frozen, batch["pixel_values"], generator, latent_noise,
                                      group)
            noise, t, noisy = _noise_and_t(schedule, latents, generator, noise, timesteps,
                                           group)
            # the frozen character encoders and Resampler (train_mllm.py:343-355)
            flat = lambda k, lead: batch[k].reshape((lead,) + tuple(batch[k].shape[-3:]))
            clip_h, magi_cls = encode_chars(frozen, flat("ip_pixel_values", b * i * s),
                                            flat("magi_pixel_values", b * i * s))
            p, dc = clip_h.shape[-2:]
            clip_h = clip_h.reshape(b, i, s, p, dc).transpose(1, 2).reshape(b * s, i, p, dc)
            magi_cls = magi_cls.reshape(b, i, s, -1).transpose(1, 2).reshape(b * s, i, -1)
            image_embeds = resampler(clip_h, magi_cls)
            tclip_h, tmagi_cls = encode_chars(frozen, flat("target_ip_pixel_values", b * i),
                                              flat("target_magi_pixel_values", b * i))
            target_embeds = resampler(tclip_h.reshape(b, i, p, dc), tmagi_cls.reshape(b, i, -1))
            image_embeds = losses.mean_multiple_ip_embeds(
                image_embeds, batch["ip_exists"], d, i, manga.num_vision_tokens, b)
            ctx, pooled = _encode_text(frozen, batch["text_input_ids"],
                                       batch["text_input_ids_2"])

        # the agent on [source block, target block] (train_mllm.py:44-57)
        agent_total, aux = agent.loss({
            "input_ids": batch["mllm_input_ids"], "labels": batch["mllm_labels"],
            "image_embeds": torch.stack([image_embeds[:, d:], target_embeds[:, d:]], dim=1),
            "embeds_cmp_mask": batch["embeds_cmp_mask"],
            "embeds_gen_mask": batch["embeds_gen_mask"],
            "ids_cmp_mask": batch["ids_cmp_mask"], "ids_gen_mask": batch["ids_gen_mask"]})
        if group is not None:
            # each mean as the rank's share of the global one, over its own count
            acfg = agent.config
            tokens = (batch["mllm_labels"][:, 1:] != -100).sum()
            rows = ((batch["embeds_gen_mask"].bool().sum(dim=1) > 0)
                    & (batch["ids_gen_mask"].bool().sum(dim=1)
                       >= acfg.input_resampler.num_queries)).sum()
            aux = dict(aux, lm_loss=aux["lm_loss"] * rank_weight(tokens, group),
                       rec_loss=aux["rec_loss"] * rank_weight(rows, group))
            agent_total = (acfg.lm_loss_scale * aux["lm_loss"]
                           + acfg.rec_loss_scale * aux["rec_loss"])

        # its reconstruction over the character block (train_mllm.py:60-68)
        ip_tokens = torch.cat([image_embeds[:, :d],
                               aux["recon_image_embeds"].to(image_embeds.dtype)], dim=1)
        lh, lw = latents.shape[1], latents.shape[2]
        biases = {
            level: build_ip_attention_bias(
                batch["ip_bbox"], *level_spatial_shape(unet.config, lh, lw, level),
                manga.num_vision_tokens, manga.num_dummy_tokens)
            for level in attention_levels(unet.config)}
        pred = unet(noisy, t.float(), ctx, pooled, _time_ids(batch),
                    ip_hidden_states=ip_tokens, ip_attn_bias=biases, ip_scale=1.0,
                    dialog_bbox=batch["dialog_bbox"])
        loss_d = _diffusion_loss(pred, noise, batch, group)
        loss = loss_d + cfg.mllm_loss_weight * agent_total
        return loss, {"loss_diffusion": loss_d, "loss_lm": aux["lm_loss"],
                      "loss_rec": aux["rec_loss"], "loss_mllm": agent_total}

    return _make_step(loss_fn, group)
