"""The Qwen-VL vision tower with attention pooling, SEED-X's original ViT
(port of ``diffsensei_tpu/models/mllm/qwen_visual.py``).

Conv patchify without bias, the absolute position table resized to the
patch grid, ``ln_pre``, pre-LN blocks and, in
``VisionTransformerWithAttnPool``, a ``QwenResampler`` pool to
``grid_size**2`` tokens, ``ln_post`` and a projection. The parameters carry
the reference's names (``conv1``, ``positional_embedding``,
``transformer.resblocks.{i}.attn.in_proj``, ``mlp.c_fc``, ``attn_pool``,
``proj``), so its state dict loads as it is; like the reference's
``VisualAttention`` the packed in-projection's rows interleave by head
(``[q_h; k_h; v_h]`` for head h), and ``proj`` is ``[in, out]``.

The position table is resized as ``jax.image.resize(..., "bicubic")`` does
(``qwen_resampler.cubic_resize_weights``: Keys' kernel with a = -0.5,
antialiased when it shrinks). The reference's ``get_abs_pos`` calls
``F.interpolate(mode="bicubic")``, whose a = -0.75 gives other values (up
to 0.28 apart on a 16 -> 32 grid, 1.40 on 16 -> 8); the port is held to the
JAX package and does not call it. No entry point of either package runs
this tower.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.core.config import QwenResamplerConfig, VisionEncoderConfig
from diffsensei_tpu_torch.models.mllm.qwen_resampler import QwenResampler, cubic_resize_weights
from diffsensei_tpu_torch.ops.attention import multi_head_attention


def interpolate_abs_pos(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """The square ``[src², C]`` position table resized to ``target_len =
    tgt²`` rows, bicubic as ``jax.image.resize`` (reference ``get_abs_pos``,
    ``qwen_visual.py:23-39``); computed in fp32, returned in pos's dtype."""
    src = int(round(math.sqrt(pos.shape[0])))
    tgt = int(round(math.sqrt(target_len)))
    if src == tgt:
        return pos
    if src * src != pos.shape[0] or tgt * tgt != target_len:
        raise ValueError(f"interpolate_abs_pos: {pos.shape[0]} -> {target_len} is not a "
                         f"square grid's resize")
    w = cubic_resize_weights(src, tgt, pos.device)
    grid = pos.reshape(src, src, -1).float()
    return torch.einsum("hwc,hH,wW->HWc", grid, w, w).reshape(tgt * tgt, -1).to(pos.dtype)


class _Attention(nn.Module):
    """The reference ``VisualAttention``'s parameters: a packed in-projection
    whose rows interleave by head, and the output projection."""

    def __init__(self, dim: int, heads: int, dtype=None, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.out_proj = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        qkv = self.in_proj(x).view(b, s, self.heads, 3, d // self.heads)
        q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))
        o = multi_head_attention(q, k, v)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=None, device=None):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden, dtype=dtype, device=device)
        self.c_proj = nn.Linear(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))     # exact erf, as the JAX ViTLayer


class _Block(nn.Module):
    """A pre-LN block (the reference ``VisualAttentionBlock``, the JAX
    ``ViTLayer``)."""

    def __init__(self, cfg: VisionEncoderConfig, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg.hidden_size
        self.ln_1 = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.attn = _Attention(d, cfg.num_heads, **kw)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.mlp = _MLP(d, cfg.intermediate_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig, dtype=None, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(_Block(cfg, dtype, device) for _ in range(cfg.num_layers))


class QwenVisionTransformer(nn.Module):
    """The head-less tower (reference ``qwen_visual.py:423``): ``[B, H, W, 3]
    -> [B, (H/p)(W/p), width]``, its 256-row position table resized to the
    patch grid."""

    num_positions = 256

    def __init__(self, config: VisionEncoderConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=device)
        d = config.hidden_size
        self.conv1 = nn.Conv2d(3, d, config.patch_size, stride=config.patch_size, bias=False,
                               **kw)
        self.positional_embedding = nn.Parameter(torch.empty((self._positions(), d), **kw))
        self.ln_pre = nn.LayerNorm(d, eps=config.norm_eps, **kw)
        self.transformer = _Transformer(config, **kw)

    def _positions(self) -> int:
        return self.num_positions

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.conv1(pixel_values.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                    # [B, P, D]
        x = x + interpolate_abs_pos(self.positional_embedding, x.shape[1])[None]
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        return x


class VisionTransformerWithAttnPool(QwenVisionTransformer):
    """``[B, H, W, 3] -> [B, grid_size**2, output_dim]`` (reference
    ``qwen_visual.py:321``): the tower, its position table of
    ``config.num_patches`` rows, then the ``QwenResampler`` pool,
    ``ln_post`` and ``x @ proj``."""

    def __init__(self, config: VisionEncoderConfig, pool: QwenResamplerConfig,
                 output_dim: int = 4096, dtype=torch.float32, device=None):
        super().__init__(config, dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.attn_pool = QwenResampler(pool, **kw)
        self.ln_post = nn.LayerNorm(pool.embed_dim, eps=config.norm_eps, **kw)
        self.proj = nn.Parameter(torch.empty((pool.embed_dim, output_dim), **kw))

    def _positions(self) -> int:
        return self.config.num_patches

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.ln_post(self.attn_pool(super().forward(pixel_values)))
        return x @ self.proj.to(x.dtype)
