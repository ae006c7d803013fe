"""QwenResampler: the SEED-X agent's single-layer perceiver (port of
``diffsensei_tpu/models/mllm/qwen_resampler.py``).

``grid_size**2`` learned queries, a fixed 2-D sin-cos position table added to
the queries and the keys, an optional ``kv_proj`` when ``kv_dim != embed_dim``,
pre-LN on both sides and one ``nn.MultiheadAttention``-style attention. The
parameter names are the reference's (``attn.in_proj_weight [3E, E]``, ...), so
its state dict loads as it is; the position table is computed, not loaded.

The served agent uses it at 64 queries over 64 tokens (input resampler: kv
2048 -> 5120, output: kv 5120 -> 2048), where the position table needs no
resize. Other sequence lengths resize it like ``jax.image.resize(...,
"bicubic")`` (Keys cubic, a = -0.5, antialiased when shrinking, edge weights
renormalized) or, for non-square lengths, tile it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.core.config import QwenResamplerConfig
from diffsensei_tpu_torch.ops.attention import multi_head_attention


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size**2, embed_dim] fixed sin-cos table (reference ``:15-84``)."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)          # w goes first (reference :52)
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (``x >= 0``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_resize_weights(in_size: int, out_size: int,
                         device=None) -> torch.Tensor:
    """[in, out] fp32 weights of ``jax.image.resize``'s bicubic along one axis:
    half-pixel centres, the kernel widened by in/out when shrinking, each
    output's weights divided by their sum."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _abs_pos(pos_embed: torch.Tensor, target_len: int) -> torch.Tensor:
    """The square position grid resized to ``target_len`` tokens (reference
    ``get_abs_pos``); a non-square length tiles and truncates the table."""
    n = pos_embed.shape[0]
    src = int(round(math.sqrt(n)))
    tgt = int(round(math.sqrt(target_len)))
    if src * src == n and tgt * tgt == target_len:
        if src == tgt:
            return pos_embed
        grid = pos_embed.reshape(src, src, -1).float()
        w = cubic_resize_weights(src, tgt, pos_embed.device)
        out = torch.einsum("hwc,hH,wW->HWc", grid, w, w)
        return out.reshape(tgt * tgt, -1).to(pos_embed.dtype)
    reps = -(-target_len // n)
    return pos_embed.repeat(reps, 1)[:target_len]


class _Attention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (packed in-projection)."""

    def __init__(self, dim: int, dtype=None, device=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty((3 * dim, dim), dtype=dtype,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.empty((3 * dim,), dtype=dtype, device=device))
        self.out_proj = nn.Linear(dim, dim, dtype=dtype, device=device)


class QwenResampler(nn.Module):
    """``[B, S, kv_dim] -> [B, num_queries, embed_dim]``."""

    def __init__(self, config: QwenResamplerConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=device)
        dim = config.embed_dim
        self.query = nn.Parameter(torch.empty((config.num_queries, dim), **kw))
        self.kv_proj: Optional[nn.Linear] = None
        if config.kv_dim is not None and config.kv_dim != dim:
            self.kv_proj = nn.Linear(config.kv_dim, dim, bias=False, **kw)
        self.ln_q = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.ln_kv = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn = _Attention(dim, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.query.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        dim, heads, nq = cfg.embed_dim, cfg.num_heads, cfg.num_queries
        pos = torch.from_numpy(get_2d_sincos_pos_embed(dim, cfg.grid_size)).to(x.device)

        x = x.to(self.dtype)
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        x = self.ln_kv(x)
        q = self.ln_q(self.query)
        q = (q[None] + _abs_pos(pos, nq)[None].to(self.dtype)).expand(b, nq, dim)
        k = x + _abs_pos(pos, s)[None].to(self.dtype)

        w, bias = self.attn.in_proj_weight, self.attn.in_proj_bias
        split = lambda t, n: t.reshape(b, n, heads, -1).transpose(1, 2)
        qh = split(F.linear(q, w[:dim], bias[:dim]), nq)
        kh = split(F.linear(k, w[dim:2 * dim], bias[dim:2 * dim]), s)
        vh = split(F.linear(x, w[2 * dim:], bias[2 * dim:]), s)
        o = multi_head_attention(qh, kh, vh)
        return self.attn.out_proj(o.transpose(1, 2).reshape(b, nq, dim))
