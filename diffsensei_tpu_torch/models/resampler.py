"""Dual-stream Perceiver Resampler: character features -> IP tokens (port of
``diffsensei_tpu/models/resampler.py``).

Each character's CLIP patch features plus its Magi CLS feature become
``num_queries`` tokens at the UNet's cross-attention width, and a learned block
of ``num_dummy_tokens`` background tokens is prepended. Parameter names are
the reference ``Resampler``'s (``layers.{i}.0`` attention, ``layers.{i}.1``
LayerNorm-Linear-GELU-Linear).
"""

from __future__ import annotations

import torch
from torch import nn

from diffsensei_tpu_torch.core.config import ResamplerConfig
from diffsensei_tpu_torch.ops.attention import multi_head_attention


class PerceiverAttention(nn.Module):
    """Latents query ``[x | latents]``."""

    def __init__(self, dim: int, dim_head: int, heads: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        inner = heads * dim_head
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        lat = self.norm2(latents)
        k, v = self.to_kv(torch.cat([x, lat], dim=-2)).chunk(2, dim=-1)

        def heads_first(t):
            b, s, _ = t.shape
            return t.view(b, s, self.heads, -1).transpose(1, 2)

        o = multi_head_attention(heads_first(self.to_q(lat)), heads_first(k),
                                 heads_first(v))
        b, h, s, d = o.shape
        return self.to_out(o.transpose(1, 2).reshape(b, s, h * d))


def resampler_ffn(dim: int, mult: int, dtype=None, device=None) -> nn.Sequential:
    kw = dict(dtype=dtype, device=device)
    return nn.Sequential(nn.LayerNorm(dim, eps=1e-5, **kw),
                         nn.Linear(dim, dim * mult, bias=False, **kw),
                         nn.GELU(),  # exact erf form, as torch nn.GELU in the reference
                         nn.Linear(dim * mult, dim, bias=False, **kw))


class Resampler(nn.Module):
    """``forward(clip_embeds [B, I, P, E], magi_embeds [B, I, Em])`` returns
    ``[B, num_dummy_tokens + I * num_queries, output_dim]``."""

    def __init__(self, config: ResamplerConfig, dtype=torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=dtype, device=device)
        self.latents = nn.Parameter(torch.zeros(1, cfg.num_queries, cfg.dim, **kw))
        self.dummy_tokens = nn.Parameter(
            torch.zeros(cfg.num_dummy_tokens, cfg.output_dim, **kw))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim, **kw)
        self.proj_in_magi = nn.Linear(cfg.magi_embedding_dim, cfg.dim, **kw)
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(cfg.dim, cfg.dim_head, cfg.heads, **kw),
                           resampler_ffn(cfg.dim, cfg.ff_mult, **kw)])
            for _ in range(cfg.depth)])
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim, **kw)
        self.norm_out = nn.LayerNorm(cfg.output_dim, eps=1e-5, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_in.weight.dtype

    def forward(self, clip_embeds: torch.Tensor, magi_embeds: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, n_ips, n_patch, _ = clip_embeds.shape
        x = self.proj_in(clip_embeds.reshape(b * n_ips, n_patch, -1).to(self.dtype))
        magi = self.proj_in_magi(magi_embeds.reshape(b * n_ips, 1, -1).to(self.dtype))
        x = torch.cat([x, magi], dim=1)                      # [B*I, P+1, dim]
        lat = self.latents.expand(b * n_ips, -1, -1)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff(lat)
        out = self.norm_out(self.proj_out(lat))
        out = out.reshape(b, n_ips * cfg.num_queries, cfg.output_dim)
        dummy = self.dummy_tokens.to(out.dtype).expand(b, -1, -1)
        return torch.cat([dummy, out], dim=1)
