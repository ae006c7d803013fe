"""The linear IP-Adapter projections (port of ``diffsensei_tpu/models/projection.py``).

The stage-2 path with ``ip_adapter_plus: false``: pooled character features
go through one linear layer each instead of the Perceiver ``Resampler``.

* ``ImageProjModel``: a pooled CLIP embedding -> ``num_tokens`` tokens at the
  cross-attention width (linear, reshape, LayerNorm).
* ``ImageProjDummyModel``: the same per character for the CLIP-H CLS and the
  Magi CLS, each branch normalized by the one ``norm`` before the sum (the
  order of the JAX module and the reference; LayerNorm is not linear), and a
  learned block of dummy tokens in front: ``[dummy | per-character tokens]``,
  the Resampler's output layout.

Parameter names are the reference's (``proj``, ``proj_magi``, ``norm``,
``dummy_tokens``). As the Resampler, the modules may keep fp32 trainables in
a bf16 stack: the layers cast them to the activations' dtype at use.
"""

from __future__ import annotations

import torch
from torch import nn

from diffsensei_tpu_torch.models.layers import LayerNorm, Linear


class ImageProjModel(nn.Module):
    """``[B, clip_embeddings_dim]`` -> ``[B, num_tokens, cross_attention_dim]``."""

    def __init__(self, clip_embeddings_dim: int, cross_attention_dim: int = 2048,
                 num_tokens: int = 4, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cross_attention_dim, self.num_tokens = cross_attention_dim, num_tokens
        self.proj = Linear(clip_embeddings_dim, cross_attention_dim * num_tokens, **kw)
        self.norm = LayerNorm(cross_attention_dim, eps=1e-5, **kw)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds)
        return self.norm(x.reshape(image_embeds.shape[0], self.num_tokens,
                                   self.cross_attention_dim))


class ImageProjDummyModel(nn.Module):
    """``clip_embeds [B, I, clip_embeddings_dim]`` and ``magi_embeds [B, I,
    magi_embeddings_dim]`` (pooled) -> ``[B, num_dummy_tokens + I *
    num_tokens, cross_attention_dim]``."""

    def __init__(self, clip_embeddings_dim: int, magi_embeddings_dim: int,
                 cross_attention_dim: int = 2048, num_tokens: int = 16,
                 num_dummy_tokens: int = 16, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cross_attention_dim, self.num_tokens = cross_attention_dim, num_tokens
        width = cross_attention_dim * num_tokens
        self.proj = Linear(clip_embeddings_dim, width, **kw)
        self.proj_magi = Linear(magi_embeddings_dim, width, **kw)
        self.norm = LayerNorm(cross_attention_dim, eps=1e-5, **kw)
        self.dummy_tokens = nn.Parameter(torch.empty(num_dummy_tokens, cross_attention_dim,
                                                     **kw))

    def _tokens(self, proj: nn.Module, x: torch.Tensor) -> torch.Tensor:
        b, n_ips, _ = x.shape
        return self.norm(proj(x).reshape(b, n_ips * self.num_tokens, self.cross_attention_dim))

    def forward(self, clip_embeds: torch.Tensor, magi_embeds: torch.Tensor) -> torch.Tensor:
        x = self._tokens(self.proj, clip_embeds) + self._tokens(self.proj_magi, magi_embeds)
        dummy = self.dummy_tokens.to(x.dtype)[None].expand(x.shape[0], -1, -1)
        return torch.cat([dummy, x], dim=1)
