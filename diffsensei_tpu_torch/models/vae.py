"""SDXL VAE in fp32 (port of ``diffsensei_tpu/models/vae.py``).

``AutoencoderKL.decode`` serves panels; ``encode`` and ``sample_latent`` turn
training panels into latents (``scripts/train/train.py:339-341`` in the
reference: fp32 encode, reparameterized sample, times the scaling factor).
Parameter names are diffusers' ``AutoencoderKL`` names, so a full VAE state
dict loads as it is; ``load_decoder_state_dict`` loads only the decode half.
``tiled_decode`` decodes a latent with a side above one tile in overlapping
tiles, as the JAX package does for every latent side above 128.

The resnets' GroupNorm+SiLU runs on kernel B3. The mid-block attention stays
plain math: one head over (H/8)*(W/8) tokens, about 1 GiB of fp32 scores at
1024².
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.core.config import VAEConfig
from diffsensei_tpu_torch.models.layers import (
    Conv2d, Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D)


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


class Encoder(nn.Module):
    """Image ``[B, H, W, 3]`` -> moments ``[B, H/8, W/8, 2 * latent_channels]``."""

    def __init__(self, config: VAEConfig, dtype=None, device=None):
        super().__init__()
        cfg = config
        kw = dict(dtype=dtype, device=device)
        groups = cfg.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1, **kw)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for level, ch in enumerate(chans):
            stage = nn.Module()
            stage.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                stage.resnets.append(ResnetBlock2D(prev, ch, groups, norm_eps=1e-6, **kw))
                prev = ch
            if level < len(chans) - 1:
                stage.downsamplers = nn.ModuleList([Downsample2D(ch, **kw)])
            self.down_blocks.append(stage)
        mid = chans[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(mid, mid, groups, norm_eps=1e-6, **kw) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(mid, groups, **kw)])
        self.conv_norm_out = GroupNorm(groups, mid, eps=1e-6, **kw)
        self.conv_out = Conv2d(mid, 2 * cfg.latent_channels, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for resnet in stage.resnets:
                x = resnet(x)
            if hasattr(stage, "downsamplers"):
                x = stage.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


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
    """The SDXL VAE, fp32 by default."""

    # diffusers keys that belong to the encoder half
    ENCODER_PREFIXES = ("encoder.", "quant_conv.")

    def __init__(self, config: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=device)
        lc = config.latent_channels
        self.encoder = Encoder(config, **kw)
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1, **kw)
        self.decoder = Decoder(config, **kw)
        self.post_quant_conv = Conv2d(lc, lc, 1, **kw)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image ``[B, H, W, 3]`` in [-1, 1] -> ``(mean, logvar)``, each
        ``[B, H/8, W/8, latent_channels]``, logvar clipped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``z [B, h, w, latent_channels]`` (already divided by the scaling
        factor) -> image ``[B, 8h, 8w, 3]`` in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def load_decoder_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> List[str]:
        """Load the decode half of a full diffusers ``AutoencoderKL`` state
        dict strictly (every decoder key, no unknown key); returns the encoder
        keys that were set aside."""
        skipped = [k for k in state_dict if k.startswith(self.ENCODER_PREFIXES)]
        missing, unexpected = self.load_state_dict(
            {k: v for k, v in state_dict.items() if k not in skipped}, strict=False)
        missing = [k for k in missing if not k.startswith(self.ENCODER_PREFIXES)]
        if missing or unexpected:
            raise RuntimeError(f"VAE decoder state dict: missing {missing}, "
                               f"unexpected {unexpected}")
        return skipped


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, noise: torch.Tensor,
                  scaling_factor: float) -> torch.Tensor:
    """Reparameterized latent sample scaled for the diffusion space; ``noise``
    is the standard-normal draw (shape of ``mean``)."""
    return (mean + torch.exp(0.5 * logvar) * noise) * scaling_factor


def tile_plan(h: int, w: int, tile: int = 96, overlap: int = 24) -> List[Tuple[int, int]]:
    """Top-left latent corners ``(y0, x0)`` of the tiles that cover an
    ``h`` x ``w`` latent: a stride of ``tile - overlap``, the last tile of a
    row or column moved back to end at the edge."""
    stride = tile - overlap
    return [(min(y0, h - tile) if h > tile else 0, min(x0, w - tile) if w > tile else 0)
            for y0 in range(0, max(h - overlap, 1), stride)
            for x0 in range(0, max(w - overlap, 1), stride)]


def _ramp(length: int, start_px: int, total_px: int, overlap_px: int) -> np.ndarray:
    """Blend weights along one side of a tile: up over the overlap where a
    tile lies before it, down where one lies after it."""
    r = np.ones((length,), np.float32)
    if start_px > 0:
        r[:overlap_px] = np.linspace(0.0, 1.0, overlap_px, endpoint=False)
    if start_px + length < total_px:
        r[-overlap_px:] = r[-overlap_px:] * np.linspace(1.0, 0.0, overlap_px, endpoint=False)
    return r


def tiled_decode(vae: AutoencoderKL, z: torch.Tensor, tile: int = 96, overlap: int = 24,
                 decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Decode ``z [B, h, w, C]`` (already divided by the scaling factor) in
    overlapping ``tile`` x ``tile`` latent tiles, ramp-blended over
    ``overlap`` latent pixels: the arithmetic of the JAX ``tiled_decode``
    (``diffsensei_tpu/models/vae.py:176``). GroupNorm statistics are taken
    per tile, the approximation diffusers' ``enable_vae_tiling`` makes, so
    the result is not the whole decode of a large latent. A latent with both
    sides at most ``tile`` is decoded whole.

    The tiles are decoded one after another in a Python loop, so one tile's
    activations are resident at a time. ``decode_fn`` (a test hook) replaces
    ``vae.decode`` for each tile."""
    decode = vae.decode if decode_fn is None else decode_fn
    b, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return decode(z)
    f = vae.config.downscale_factor
    th = tw = tile * f
    plan = tile_plan(h, w, tile, overlap)
    masks = {}
    weight = np.zeros((1, h * f, w * f, 1), np.float32)
    for y0, x0 in plan:
        m = (_ramp(th, y0 * f, h * f, overlap * f)[:, None]
             * _ramp(tw, x0 * f, w * f, overlap * f)[None, :])[None, :, :, None]
        masks[y0, x0] = torch.from_numpy(m).to(z.device)
        weight[:, y0 * f:y0 * f + th, x0 * f:x0 * f + tw] += m
    inv_weight = torch.from_numpy(1.0 / np.clip(weight, 1e-6, None)).to(z.device)
    out = torch.zeros((b, h * f, w * f, vae.config.out_channels), dtype=torch.float32,
                      device=z.device)
    for y0, x0 in plan:
        img = decode(z[:, y0:y0 + tile, x0:x0 + tile]).float()
        out[:, y0 * f:y0 * f + th, x0 * f:x0 * f + tw] += img * masks[y0, x0]
    return out * inv_weight
