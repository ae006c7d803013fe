"""CLIP text encoders for SDXL prompt conditioning (port of
``diffsensei_tpu/models/text_encoder.py``).

One implementation serves CLIP-L (quick-GELU) and OpenCLIP-bigG (exact GELU,
text projection). It returns the penultimate hidden state (SDXL's
``hidden_states[-2]``) and the pooled embedding at ``argmax(input_ids)`` after
the final LayerNorm, projected when the config has a ``projection_dim``.
Parameter names are HF ``CLIPTextModel(WithProjection)``'s.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.core.config import TextEncoderConfig
from diffsensei_tpu_torch.ops.attention import multi_head_attention

CAUSAL_MASK = -1e9


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)  # HF "gelu" is the exact erf form


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(dim, dim, **kw)
        self.v_proj = nn.Linear(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        b, s, d = x.shape
        split = lambda t: t.view(b, s, self.heads, -1).transpose(1, 2)
        o = multi_head_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                 split(self.v_proj(x)), bias=bias)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, inner: int, act: str, dtype=None, device=None):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(dim, inner, dtype=dtype, device=device)
        self.fc2 = nn.Linear(inner, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(activation(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dim = cfg.hidden_size
        self.self_attn = CLIPAttention(dim, cfg.num_heads, **kw)
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.mlp = CLIPMLP(dim, cfg.intermediate_size, cfg.hidden_act, **kw)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids [B, S]) -> (penultimate [B, S, D], pooled [B, P])``."""

    def __init__(self, config: TextEncoderConfig, dtype=torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=dtype, device=device)
        self.text_model = nn.Module()
        emb = self.text_model.embeddings = nn.Module()
        emb.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        emb.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                              cfg.hidden_size, **kw)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, **kw) for _ in range(cfg.num_layers)])
        self.text_model.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.text_projection = (
            nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False, **kw)
            if cfg.projection_dim is not None else None)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        b, s = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids)
        x = x + tm.embeddings.position_embedding.weight[:s][None]
        pos = torch.arange(s, device=input_ids.device)
        causal = torch.where(pos[:, None] >= pos[None, :], 0.0, CAUSAL_MASK)
        causal = causal.to(torch.float32)[None, None]

        penultimate = x
        for layer in tm.encoder.layers:
            penultimate = x
            x = layer(x, causal)
        final = tm.final_layer_norm(x)
        pooled = final[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return penultimate, pooled
