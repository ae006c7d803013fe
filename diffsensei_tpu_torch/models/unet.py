"""SDXL UNet with the manga conditioning hooks (port of
``diffsensei_tpu/models/unet.py``).

As in the JAX package, text and IP context stay split (two attentions per
cross-attention layer, combined as ``h + ip_scale * h_ip``), the masked-IP
biases arrive precomputed per attention level, and the learned dialog
embedding is pasted onto the post-``conv_in`` features inside the dialog
boxes. Parameter names are diffusers' ``UNet2DConditionModel`` names, with the
IP projections under ``attn2.processor.to_{k,v}_ip`` as the released
DiffSensei ``pytorch_model.bin`` stores them, plus ``dialog_bbox_embedding``.

Spatial self-attention with at least 1024 tokens runs on kernel B1 and every
resnet GroupNorm+SiLU on kernel B3 (through ``ops/attention.py`` and
``models/layers.py``). DeepCache, remat and context parallelism wait for later
slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from diffsensei_tpu_torch.core.config import UNetConfig
from diffsensei_tpu_torch.models.layers import (
    Conv2d, Downsample2D, GEGLUFeedForward, GroupNorm, ResnetBlock2D,
    TimestepEmbedding, Upsample2D, timestep_embedding)
from diffsensei_tpu_torch.models.lora import LoRADense
from diffsensei_tpu_torch.ops.attention import multi_head_attention
from diffsensei_tpu_torch.ops.masked_ip import rasterize_dialog_embedding


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class SelfAttention(nn.Module):
    """Spatial self-attention (``attn1``)."""

    def __init__(self, dim: int, heads: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.to_q = LoRADense(dim, dim, bias=False, **kw)
        self.to_k = LoRADense(dim, dim, bias=False, **kw)
        self.to_v = LoRADense(dim, dim, bias=False, **kw)
        self.to_out = nn.ModuleList([LoRADense(dim, dim, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(self.to_k(x), self.heads)
        v = _split_heads(self.to_v(x), self.heads)
        return self.to_out[0](_merge_heads(multi_head_attention(q, k, v)))


class MangaCrossAttention(nn.Module):
    """Text cross-attention plus masked IP cross-attention (``attn2``)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.to_q = LoRADense(dim, dim, bias=False, **kw)
        self.to_k = LoRADense(context_dim, dim, bias=False, **kw)
        self.to_v = LoRADense(context_dim, dim, bias=False, **kw)
        self.to_out = nn.ModuleList([LoRADense(dim, dim, **kw)])
        self.processor = nn.Module()
        self.processor.to_k_ip = nn.Linear(context_dim, dim, bias=False, **kw)
        self.processor.to_v_ip = nn.Linear(context_dim, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, ctx_text: torch.Tensor,
                ctx_ip: Optional[torch.Tensor] = None,
                ip_bias: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(self.to_k(ctx_text), self.heads)
        v = _split_heads(self.to_v(ctx_text), self.heads)
        h = multi_head_attention(q, k, v)
        if ctx_ip is not None:
            k_ip = _split_heads(self.processor.to_k_ip(ctx_ip), self.heads)
            v_ip = _split_heads(self.processor.to_v_ip(ctx_ip), self.heads)
            bias = None if ip_bias is None else ip_bias[:, None, :, :]
            h = h + ip_scale * multi_head_attention(q, k_ip, v_ip, bias=bias)
        return self.to_out[0](_merge_heads(h))


class BasicTransformerBlock(nn.Module):
    """self-attention, manga cross-attention, GEGLU FFN; each pre-LayerNorm
    with a residual."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = SelfAttention(dim, heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn2 = MangaCrossAttention(dim, context_dim, heads, **kw)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.ff = GEGLUFeedForward(dim, **kw)

    def forward(self, x, ctx_text, ctx_ip, ip_bias, ip_scale):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx_text, ctx_ip, ip_bias, ip_scale)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6, plain) -> proj_in -> N blocks -> proj_out, residual."""

    def __init__(self, num_layers: int, channels: int, context_dim: int,
                 heads: int, norm_num_groups: int = 32, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm(norm_num_groups, channels, eps=1e-6, **kw)
        self.proj_in = nn.Linear(channels, channels, **kw)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads, **kw)
             for _ in range(num_layers)])
        self.proj_out = nn.Linear(channels, channels, **kw)

    def forward(self, x, ctx_text, ctx_ip, ip_bias, ip_scale):
        b, h, w, c = x.shape
        residual = x
        x = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            x = block(x, ctx_text, ctx_ip, ip_bias, ip_scale)
        return self.proj_out(x).reshape(b, h, w, c) + residual


def _stage(resnets, attentions, sampler=None) -> nn.Module:
    """A diffusers down/up block: ``resnets``, ``attentions`` and
    ``downsamplers``/``upsamplers``."""
    stage = nn.Module()
    stage.resnets = nn.ModuleList(resnets)
    stage.attentions = nn.ModuleList(attentions)
    if sampler is not None:
        name = "downsamplers" if isinstance(sampler, Downsample2D) else "upsamplers"
        setattr(stage, name, nn.ModuleList([sampler]))
    return stage


class UNetMangaModel(nn.Module):
    """SDXL UNet with masked-IP cross-attention and the dialog embedding.

    ``forward`` takes NHWC latents ``[B, H, W, in_channels]``, timesteps
    ``[B]`` (or a scalar), the text context ``[B, T, cross_attention_dim]``,
    the pooled text embedding ``[B, pooled_projection_dim]``, the SDXL size
    ids ``[B, 6]``, and optionally the IP tokens ``[B, D + I*V, cross_dim]``
    (dummy block first), the per-level IP biases ``{level: [B, S_level, D + I*V]}``,
    ``ip_scale`` and the dialog boxes ``[B, max_num_dialogs, 4]``. It returns
    the predicted noise ``[B, H, W, out_channels]`` in the module's dtype.
    """

    def __init__(self, config: UNetConfig, dtype=torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=dtype, device=device)
        chans = cfg.block_out_channels
        groups = cfg.norm_num_groups
        ted = cfg.time_embed_dim
        tl = cfg.transformer_layers_per_block
        n = len(chans)

        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1, **kw)
        self.time_embedding = TimestepEmbedding(chans[0], ted, **kw)
        self.add_embedding = TimestepEmbedding(cfg.addition_embed_input_dim, ted, **kw)
        if cfg.use_dialog_embedding:
            self.dialog_bbox_embedding = nn.Parameter(torch.zeros(chans[0], **kw))

        def transformer(level, layers):
            return Transformer2D(layers, chans[level], cfg.cross_attention_dim,
                                 chans[level] // cfg.head_dim, groups, **kw)

        skips = [chans[0]]
        prev = chans[0]
        self.down_blocks = nn.ModuleList()
        for level, ch in enumerate(chans):
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(prev, ch, groups, ted, **kw))
                if tl[level] > 0:
                    attentions.append(transformer(level, tl[level]))
                prev = ch
                skips.append(ch)
            down = Downsample2D(ch, **kw) if level < n - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_stage(resnets, attentions, down))

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(chans[-1], chans[-1], groups, ted, **kw) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [transformer(n - 1, cfg.mid_transformer_layers)])

        self.up_blocks = nn.ModuleList()
        for level in reversed(range(n)):
            ch = chans[level]
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(prev + skips.pop(), ch, groups, ted, **kw))
                if tl[level] > 0:
                    attentions.append(transformer(level, tl[level]))
                prev = ch
            up = Upsample2D(ch, **kw) if level > 0 else None
            self.up_blocks.append(_stage(resnets, attentions, up))

        self.conv_norm_out = GroupNorm(groups, chans[0], eps=1e-5, **kw)
        self.conv_out = Conv2d(chans[0], cfg.out_channels, 3, padding=1, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_text_embeds: torch.Tensor,
                time_ids: torch.Tensor, ip_hidden_states: Optional[torch.Tensor] = None,
                ip_attn_bias: Optional[Dict[int, torch.Tensor]] = None,
                ip_scale: float = 1.0,
                dialog_bbox: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        dt = self.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])

        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        tid = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
        add = torch.cat([pooled_text_embeds.float(),
                         tid.reshape(time_ids.shape[0], -1)], dim=-1)
        temb = temb + self.add_embedding(add.to(dt))

        x = self.conv_in(sample.to(dt))
        if cfg.use_dialog_embedding and dialog_bbox is not None:
            x = rasterize_dialog_embedding(x, dialog_bbox, self.dialog_bbox_embedding)

        ctx_text = encoder_hidden_states.to(dt)
        ctx_ip = None if ip_hidden_states is None else ip_hidden_states.to(dt)

        def attend(attn, x, level):
            bias = None
            if ip_attn_bias is not None and ctx_ip is not None:
                bias = ip_attn_bias.get(level)
            return attn(x, ctx_text, ctx_ip, bias, ip_scale)

        n = len(cfg.block_out_channels)
        skips = [x]
        for level, stage in enumerate(self.down_blocks):
            for j, resnet in enumerate(stage.resnets):
                x = resnet(x, temb)
                if len(stage.attentions):
                    x = attend(stage.attentions[j], x, level)
                skips.append(x)
            if level < n - 1:
                x = stage.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = attend(mid.attentions[0], x, n - 1)
        x = mid.resnets[1](x, temb)

        for rev, stage in enumerate(self.up_blocks):
            level = n - 1 - rev
            for j, resnet in enumerate(stage.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
                if len(stage.attentions):
                    x = attend(stage.attentions[j], x, level)
            if level > 0:
                x = stage.upsamplers[0](x, output_size=tuple(skips[-1].shape[1:3]))

        x = torch.nn.functional.silu(self.conv_norm_out(x))
        return self.conv_out(x)


def attention_levels(cfg: UNetConfig) -> Tuple[int, ...]:
    """Level indices that hold cross-attention (each needs an IP bias)."""
    return tuple(i for i, t in enumerate(cfg.transformer_layers_per_block) if t > 0)


def level_spatial_shape(cfg: UNetConfig, height: int, width: int,
                        level: int) -> Tuple[int, int]:
    """Feature-map (h, w) of a UNet level for a latent (height, width):
    ``ceil(h / 2**level)``, as stride-2 padded downsampling gives."""
    return -(-height // (1 << level)), -(-width // (1 << level))
