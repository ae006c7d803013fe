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

from diffsensei_tpu_torch.models.layers import FusedGroupNormSiLU

# parameter-name suffix -> normal std (None: zeros), as the JAX modules init them
_NAMED_STD = {
    "text_model.embeddings.position_embedding.weight": 0.01,
    "embeddings.class_embedding": 0.02,
    "embeddings.position_embedding.weight": 0.02,
    "embeddings.cls_token": 0.02,
    "embeddings.position_embeddings": 0.02,
    "dummy_tokens": 0.02,
    "dialog_bbox_embedding": None,
}


@torch.no_grad()
def init_flax_like_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter of ``root`` in place; returns ``root``."""
    for mod in root.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
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
        for suffix, std in _NAMED_STD.items():
            if name.endswith(suffix):
                if std is None:
                    param.zero_()
                else:
                    param.normal_(0.0, std, generator=generator)
                break
    return root
