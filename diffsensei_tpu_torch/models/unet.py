"""SDXL UNet with the manga conditioning hooks (port of
``diffsensei_tpu/models/unet.py``).

As in the JAX package, text and IP context stay split (two attentions per
cross-attention layer, combined as ``h + ip_scale * h_ip``), the masked-IP
biases arrive precomputed per attention level, and the learned dialog
embedding is pasted onto the post-``conv_in`` features inside the dialog
boxes. Parameter names are diffusers' ``UNet2DConditionModel`` names, with the
IP projections under ``attn2.processor.to_{k,v}_ip`` as the released
DiffSensei ``pytorch_model.bin`` stores them, plus ``dialog_bbox_embedding``.

Spatial self-attention with at least 1024 tokens runs on kernel B1 (B2 and
B4 in the backward) and every resnet GroupNorm+SiLU on kernel B3 (through
``ops/attention.py`` and ``models/layers.py``). On the card in bf16, a
cross-attention layer with IP context computes its two attentions in one
launch of kernel B5 (``ops/dual_cross_attention.py``); elsewhere (the CPU,
fp32, no IP context) it makes the two dispatcher calls of the JAX layer.

Training: ``enable_remat`` checkpoints each ``ResnetBlock2D`` (full
recompute) and each transformer stack (``torch.utils.checkpoint``) under one
of the JAX ``remat_blocks`` policies: None (full recompute), ``dots``,
``attn``, ``dots_attn`` or ``dots_deepest`` (``models/remat.py``); and
``compute_dtype`` lets fp32 trainable
parameters sit in a bf16 UNet: every layer casts its parameters to the
activations' dtype at use. ``config.lora_rank > 0`` puts adapters on
``to_q``, ``to_k``, ``to_v`` and ``to_out.0`` of both attentions
(``models/lora.py``), never on the IP projections.

Serving: ``quantized=True`` builds the weight-only int8 layout of
``models/quant_unet.py`` (every transformer matmul an ``Int8Linear``), and
``forward``'s ``return_deep`` / ``deep_feature`` / ``cache_split`` are the
JAX package's DeepCache. ``set_context_parallel(group, min_seq)`` sends
every spatial self-attention of at least ``min_seq`` tokens through the ring
of ``ops/ring_attention.py`` over ``group``, the JAX ``cp_mesh`` /
``cp_min_seq`` (the rest of the UNet stays replicated on every rank).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffsensei_tpu_torch.core.config import UNetConfig
from diffsensei_tpu_torch.models import remat
from diffsensei_tpu_torch.models.layers import (
    Conv2d, Downsample2D, GEGLUFeedForward, GroupNorm, LayerNorm, ResnetBlock2D,
    TimestepEmbedding, Upsample2D, linear, timestep_embedding)
from diffsensei_tpu_torch.models.lora import projection
from diffsensei_tpu_torch.ops.attention import multi_head_attention
from diffsensei_tpu_torch.ops.dual_cross_attention import dual_cross_attention, uses_kernel
from diffsensei_tpu_torch.ops.masked_ip import rasterize_dialog_embedding


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class SelfAttention(nn.Module):
    """Spatial self-attention (``attn1``). ``kw``: ``lora_rank``,
    ``quantized``, ``dtype``, ``device`` of the projections. With
    ``cp_group`` set, a sequence of at least ``cp_min_seq`` tokens runs as
    ring attention over that process group."""

    def __init__(self, dim: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.cp_group = None
        self.cp_min_seq = 16384
        self.to_q = projection(dim, dim, bias=False, **kw)
        self.to_k = projection(dim, dim, bias=False, **kw)
        self.to_v = projection(dim, dim, bias=False, **kw)
        self.to_out = nn.ModuleList([projection(dim, dim, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(self.to_k(x), self.heads)
        v = _split_heads(self.to_v(x), self.heads)
        cp = self.cp_group if x.shape[1] >= self.cp_min_seq else None
        return self.to_out[0](_merge_heads(multi_head_attention(q, k, v, cp_group=cp)))


class MangaCrossAttention(nn.Module):
    """Text cross-attention plus masked IP cross-attention (``attn2``). The
    IP projections take no adapter (the reference's peft targets exclude
    them) and are int8 where the others are."""

    def __init__(self, dim: int, context_dim: int, heads: int, lora_rank: int = 0,
                 quantized: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(quantized=quantized, dtype=dtype, device=device)
        self.heads = heads
        self.to_q = projection(dim, dim, bias=False, lora_rank=lora_rank, **kw)
        self.to_k = projection(context_dim, dim, bias=False, lora_rank=lora_rank, **kw)
        self.to_v = projection(context_dim, dim, bias=False, lora_rank=lora_rank, **kw)
        self.to_out = nn.ModuleList([projection(dim, dim, lora_rank=lora_rank, **kw)])
        self.processor = nn.Module()
        self.processor.to_k_ip = linear(context_dim, dim, bias=False, **kw)
        self.processor.to_v_ip = linear(context_dim, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, ctx_text: torch.Tensor,
                ctx_ip: Optional[torch.Tensor] = None,
                ip_bias: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(self.to_k(ctx_text), self.heads)
        v = _split_heads(self.to_v(ctx_text), self.heads)
        if ctx_ip is None:
            return self.to_out[0](_merge_heads(multi_head_attention(q, k, v)))
        k_ip = _split_heads(self.processor.to_k_ip(ctx_ip), self.heads)
        v_ip = _split_heads(self.processor.to_v_ip(ctx_ip), self.heads)
        bias = None if ip_bias is None else ip_bias[:, None, :, :]
        if uses_kernel(q, k, k_ip):
            h, h_ip = dual_cross_attention(q, k, v, k_ip, v_ip,
                                           None if bias is None else bias.float())
        else:
            h = multi_head_attention(q, k, v)
            h_ip = multi_head_attention(q, k_ip, v_ip, bias=bias)
        return self.to_out[0](_merge_heads(h + ip_scale * h_ip))


class BasicTransformerBlock(nn.Module):
    """self-attention, manga cross-attention, GEGLU FFN; each pre-LayerNorm
    with a residual."""

    def __init__(self, dim: int, context_dim: int, heads: int, lora_rank: int = 0,
                 quantized: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        pkw = dict(kw, lora_rank=lora_rank, quantized=quantized)
        self.norm1 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = SelfAttention(dim, heads, **pkw)
        self.norm2 = LayerNorm(dim, eps=1e-5, **kw)
        self.attn2 = MangaCrossAttention(dim, context_dim, heads, **pkw)
        self.norm3 = LayerNorm(dim, eps=1e-5, **kw)
        self.ff = GEGLUFeedForward(dim, quantized=quantized, **kw)

    def forward(self, x, ctx_text, ctx_ip, ip_bias, ip_scale):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx_text, ctx_ip, ip_bias, ip_scale)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6, plain) -> proj_in -> N blocks -> proj_out, residual."""

    def __init__(self, num_layers: int, channels: int, context_dim: int,
                 heads: int, norm_num_groups: int = 32, lora_rank: int = 0,
                 quantized: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm(norm_num_groups, channels, eps=1e-6, **kw)
        self.proj_in = linear(channels, channels, quantized=quantized, **kw)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads, lora_rank, quantized, **kw)
             for _ in range(num_layers)])
        self.proj_out = linear(channels, channels, quantized=quantized, **kw)

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

    ``config.lora_rank`` sizes the attention adapters; ``quantized`` builds
    the int8 serving layout (rank 0 only), whose weights come from
    ``models/quant_unet.py``.
    """

    def __init__(self, config: UNetConfig, dtype=torch.float32, device=None,
                 quantized: bool = False):
        super().__init__()
        cfg = self.config = config
        self.quantized = quantized
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
                                 chans[level] // cfg.head_dim, groups, cfg.lora_rank,
                                 quantized, **kw)

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
        self.compute_dtype: Optional[torch.dtype] = None
        self.remat = False
        self.remat_policy: Optional[str] = None
        self.cp_group = None
        self.cp_min_seq = 16384

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: ``compute_dtype`` when set, else the weights'."""
        return self.compute_dtype or self.conv_in.weight.dtype

    def enable_remat(self, policy: Optional[str] = None) -> None:
        """Recompute each resnet block and transformer stack in the backward
        instead of keeping their activations (the JAX ``remat_blocks``). The
        resnets are recomputed in full; the transformer stacks keep what
        ``policy`` names (``models/remat.py``: None, ``dots``, ``attn``,
        ``dots_attn``, ``dots_deepest``). An unknown name raises
        ``ValueError``."""
        self.remat_policy = remat.check_policy(policy)
        self.remat = True

    def set_context_parallel(self, group, min_seq: int = 16384) -> None:
        """Run every spatial self-attention of at least ``min_seq`` tokens as
        ring attention over the process group ``group`` (None: off)."""
        self.cp_group, self.cp_min_seq = group, min_seq
        for mod in self.modules():
            if isinstance(mod, SelfAttention):
                mod.cp_group, mod.cp_min_seq = group, min_seq

    def _block(self, block: nn.Module, *args, context=remat.FULL_RECOMPUTE):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, context_fn=context)
        return block(*args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_text_embeds: torch.Tensor,
                time_ids: torch.Tensor, ip_hidden_states: Optional[torch.Tensor] = None,
                ip_attn_bias: Optional[Dict[int, torch.Tensor]] = None,
                ip_scale: float = 1.0,
                dialog_bbox: Optional[torch.Tensor] = None,
                deep_feature: Optional[torch.Tensor] = None, cache_split: int = 2,
                return_deep: bool = False):
        """The predicted noise; with ``return_deep`` also the deep feature.

        DeepCache (the JAX ``UNetMangaModel.__call__``): ``return_deep=True``
        also returns the up path's feature just after the upsample out of
        level ``cache_split``, the output of the deep subtree (down levels >=
        ``cache_split``, the mid block, up levels >= ``cache_split``).
        ``deep_feature`` (an earlier ``return_deep``'s) skips that subtree:
        the down path stops before the level-``cache_split - 1`` downsample
        and the up path starts at level ``cache_split - 1`` from the feature.
        A cached call with ``return_deep`` passes the feature through. The
        contract: ``full(x)[0] == forward(x, deep_feature=full(x)[1])`` bit
        for bit; reusing a feature across steps is the only approximation."""
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

        n = len(cfg.block_out_channels)

        def attend(attn, x, level):
            bias = None
            if ip_attn_bias is not None and ctx_ip is not None:
                bias = ip_attn_bias.get(level)
            context = remat.context_fn(self.remat_policy, deepest=level == n - 1)
            return self._block(attn, x, ctx_text, ctx_ip, bias, ip_scale, context=context)

        use_cache = deep_feature is not None
        if (use_cache or return_deep) and not 1 <= cache_split < n:
            raise ValueError(f"cache_split must be in [1, {n - 1}], got {cache_split}")
        skips = [x]
        for level, stage in enumerate(self.down_blocks):
            if use_cache and level >= cache_split:
                break
            for j, resnet in enumerate(stage.resnets):
                x = self._block(resnet, x, temb)
                if len(stage.attentions):
                    x = attend(stage.attentions[j], x, level)
                skips.append(x)
            # the level-(split - 1) downsample feeds only the skipped subtree
            if level < n - 1 and not (use_cache and level == cache_split - 1):
                x = stage.downsamplers[0](x)
                skips.append(x)

        if use_cache:
            x = deep_feature.to(dt)
        else:
            mid = self.mid_block
            x = self._block(mid.resnets[0], x, temb)
            x = attend(mid.attentions[0], x, n - 1)
            x = self._block(mid.resnets[1], x, temb)

        deep_out = None
        for rev, stage in enumerate(self.up_blocks):
            level = n - 1 - rev
            if use_cache and level >= cache_split:
                continue
            for j, resnet in enumerate(stage.resnets):
                x = self._block(resnet, torch.cat([x, skips.pop()], dim=-1), temb)
                if len(stage.attentions):
                    x = attend(stage.attentions[j], x, level)
            if level > 0:
                x = stage.upsamplers[0](x, output_size=tuple(skips[-1].shape[1:3]))
                if return_deep and level == cache_split:
                    deep_out = x

        x = torch.nn.functional.silu(self.conv_norm_out(x))
        out = self.conv_out(x)
        if return_deep:
            return out, (deep_feature if deep_out is None else deep_out)
        return out


def attention_levels(cfg: UNetConfig) -> Tuple[int, ...]:
    """Level indices that hold cross-attention (each needs an IP bias)."""
    return tuple(i for i, t in enumerate(cfg.transformer_layers_per_block) if t > 0)


def level_spatial_shape(cfg: UNetConfig, height: int, width: int,
                        level: int) -> Tuple[int, int]:
    """Feature-map (h, w) of a UNet level for a latent (height, width):
    ``ceil(h / 2**level)``, as stride-2 padded downsampling gives."""
    return -(-height // (1 << level)), -(-width // (1 << level))
