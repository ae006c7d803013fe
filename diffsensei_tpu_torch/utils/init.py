"""Random weights with the JAX package's (flax's) initializers, from a seed.

No checkpoint files are in the repository, so the serving path runs on
random weights made on the device. Flax-like scales keep activations finite
through the deep UNet: lecun-normal kernels (std 1/sqrt(fan_in)), zero
biases, unit norm scales, and the named parameters' own initializers from
the JAX modules (position and class embeddings, resampler latents, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diffsensei_tpu_torch.models.layers import FusedGroupNormSiLU, Int8Linear
from diffsensei_tpu_torch.models.lora import LoRADense
from diffsensei_tpu_torch.models.mllm.llama import Int4Dense, Int8Dense, RMSNorm

# parameter-name suffix -> normal std (None: zeros), as the JAX modules init them
_NAMED_STD = {
    "text_model.embeddings.position_embedding.weight": 0.01,
    "embeddings.class_embedding": 0.02,
    "embeddings.position_embedding.weight": 0.02,
    "embeddings.cls_token": 0.02,
    "embeddings.position_embeddings": 0.02,
    "dummy_tokens": 0.02,
    "dialog_bbox_embedding": None,
    "query": 0.02,                      # QwenResampler queries
    "lora_A.weight": 0.02,              # LLM adapters: A normal, B zero (UNet: below)
    "lora_B.weight": None,
    "attn.in_proj_bias": None,
}


@torch.no_grad()
def init_flax_like_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter of ``root`` in place; returns ``root``.

    The quantized projections (the agent's, the int8 UNet's) get what their
    JAX modules draw: uniform random bytes (int4 nibbles in [-8, 7], std
    4.61) or ints in [-127, 127] (int8, std 73.3), with the constant scale
    that makes the effective weight lecun-like, ``1 / (std * sqrt(in))``.
    The UNet's adapters start as the JAX ``LoRADense``'s: A normal with std
    1/r, B zero."""
    unet_lora_std = {f"{name}.lora_A.weight": 1.0 / mod.lora_rank
                     for name, mod in root.named_modules()
                     if isinstance(mod, LoRADense) and mod.lora_rank > 0}
    for mod in root.modules():
        if isinstance(mod, Int4Dense):
            mod.kernel_q.random_(0, 256, generator=generator)
            mod.kernel_scale.fill_(1.0 / (4.61 * mod.kernel_q.shape[0] ** 0.5))
        elif isinstance(mod, (Int8Dense, Int8Linear)):
            mod.kernel_q.random_(-127, 128, generator=generator)
            mod.kernel_scale.fill_(1.0 / (73.3 * mod.kernel_q.shape[0] ** 0.5))
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            # flax nn.Embed default: variance scaling 1.0 over the feature axis
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[1]),
                               generator=generator)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FusedGroupNormSiLU)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, param in root.named_parameters():
        if name == "latents":  # Resampler: normal(1/sqrt(dim))
            param.normal_(0.0, param.shape[-1] ** -0.5, generator=generator)
            continue
        if name == "attn.in_proj_weight":  # QwenResampler: three lecun-normal [E, E]
            param.normal_(0.0, param.shape[1] ** -0.5, generator=generator)
            continue
        if name in unet_lora_std:
            param.normal_(0.0, unet_lora_std[name], generator=generator)
            continue
        for suffix, std in _NAMED_STD.items():
            if name.endswith(suffix):
                if std is None:
                    param.zero_()
                else:
                    param.normal_(0.0, std, generator=generator)
                break
    return root
