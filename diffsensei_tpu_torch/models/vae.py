"""SDXL VAE decoder in fp32 (port of ``diffsensei_tpu/models/vae.py``).

The slice decodes only: ``Decoder`` and ``AutoencoderKL.decode``. Parameter
names are diffusers' ``AutoencoderKL`` names; a full VAE state dict loads
through ``AutoencoderKL.load_decoder_state_dict``, which sets the encoder
keys aside. The encoder, ``encode`` and the tiled decode above 1024² wait for a
later slice.

The resnets' GroupNorm+SiLU runs on kernel B3. The mid-block attention stays
plain math: one head over (H/8)*(W/8) tokens, about 1 GiB of fp32 scores at
1024².
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.core.config import VAEConfig
from diffsensei_tpu_torch.models.layers import (
    Conv2d, GroupNorm, ResnetBlock2D, Upsample2D)


class VAEAttention(nn.Module):
    """Single-head mid-block self-attention over spatial tokens."""

    def __init__(self, channels: int, norm_num_groups: int = 32, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm(norm_num_groups, channels, eps=1e-6, **kw)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.matmul(p, v))
        return out.reshape(b, h, w, c) + x


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype=None, device=None):
        super().__init__()
        cfg = config
        kw = dict(dtype=dtype, device=device)
        groups = cfg.norm_num_groups
        chans = list(reversed(cfg.block_out_channels))
        mid = chans[0]
        self.conv_in = Conv2d(cfg.latent_channels, mid, 3, padding=1, **kw)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(mid, mid, groups, norm_eps=1e-6, **kw) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(mid, groups, **kw)])
        self.up_blocks = nn.ModuleList()
        prev = mid
        for rev, ch in enumerate(chans):
            stage = nn.Module()
            stage.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                stage.resnets.append(ResnetBlock2D(prev, ch, groups, norm_eps=1e-6, **kw))
                prev = ch
            if rev < len(chans) - 1:
                stage.upsamplers = nn.ModuleList([Upsample2D(ch, **kw)])
            self.up_blocks.append(stage)
        self.conv_norm_out = GroupNorm(groups, chans[-1], eps=1e-6, **kw)
        self.conv_out = Conv2d(chans[-1], cfg.out_channels, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        for stage in self.up_blocks:
            for resnet in stage.resnets:
                x = resnet(x)
            if hasattr(stage, "upsamplers"):
                x = stage.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """The decode half of the SDXL VAE, fp32 by default."""

    # diffusers keys that belong to the encoder half
    ENCODER_PREFIXES = ("encoder.", "quant_conv.")

    def __init__(self, config: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=device)
        self.decoder = Decoder(config, **kw)
        self.post_quant_conv = Conv2d(config.latent_channels, config.latent_channels,
                                      1, **kw)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``z [B, h, w, latent_channels]`` (already divided by the scaling
        factor) -> image ``[B, 8h, 8w, 3]`` in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def load_decoder_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> List[str]:
        """Load a full diffusers ``AutoencoderKL`` state dict strictly into the
        decode half; returns the encoder keys that were set aside."""
        skipped = [k for k in state_dict if k.startswith(self.ENCODER_PREFIXES)]
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(self.ENCODER_PREFIXES)})
        return skipped
