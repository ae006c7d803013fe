"""The plain reference of the DiffSensei stack: SDXL manga UNet, VAE, the two
CLIP text encoders, CLIP ViT-H and Magi ViTMAE, the Perceiver Resampler.

Plain PyTorch in whatever dtype the weights have (the benchmark runs it in
float32 with TF32 off): every attention is softmax(q k^T / sqrt(d) + bias) v
in full, every GroupNorm is ``F.group_norm``. No kernel, no cache, no
batching trick. Activations are NHWC at the public boundaries, as in the
program, and the parameter names are the diffusers / Hugging Face names the
program's state dicts use, so one seeded state dict loads into both.

Departures from the published models, all shared with the program: the
UNet's text and IP contexts stay split (``h + ip_scale * h_ip``), the IP
attention carries an additive box mask (-10000 outside a character's box,
the dummy block only where no box covers the pixel), the learned dialog
embedding is added after ``conv_in`` inside the dialog boxes, and the VAE
decodes a latent with a side above 96 in ramp-blended 96-latent tiles.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

MASK_VALUE = -10000.0
CAUSAL_MASK = -1e9


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v over [B, H, S, D]."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if bias is not None:
        s = s + bias
    return torch.matmul(torch.softmax(s, dim=-1), v)


def heads(x, n):
    b, s, d = x.shape
    return x.view(b, s, n, d // n).transpose(1, 2)


def merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Conv(nn.Conv2d):
    """A conv on NHWC tensors."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm on NHWC tensors, with SiLU after it where ``silu``."""

    def __init__(self, groups, channels, eps, silu=False):
        super().__init__(groups, channels, eps=eps)
        self.silu = silu

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias,
                         self.eps).permute(0, 2, 3, 1)
        return F.silu(y) if self.silu else y


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.linear_1 = nn.Linear(din, dout)
        self.linear_2 = nn.Linear(dout, dout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, groups, temb=None, eps=1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, silu=True)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb is not None else None
        self.norm2 = GroupNorm(groups, cout, eps, silu=True)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Downsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest upsample to ``size`` (default twice), then a 3x3 conv."""

    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)

    def forward(self, x, size=None):
        _, h, w, _ = x.shape
        oh, ow = size or (2 * h, 2 * w)
        iy = torch.arange(oh, device=x.device) * h // oh
        ix = torch.arange(ow, device=x.device) * w // ow
        return self.conv(x[:, iy][:, :, ix])


# ---------------------------------------------------------------------------
# masked IP conditioning
# ---------------------------------------------------------------------------
def grid01(n, device):
    if n == 1:
        return torch.zeros(1, device=device)
    return torch.arange(n, dtype=torch.float32, device=device) / (n - 1)


def ip_bias(bbox, h, w, vision_tokens, dummy_tokens):
    """[B, h*w, dummy + I*V]: 0 where a query may attend, -10000 elsewhere.
    A pixel attends character i's tokens inside its box (bounds inclusive)
    and the dummy block where no box covers it."""
    xg = grid01(w, bbox.device).repeat(h)[None, :, None]
    yg = grid01(h, bbox.device).repeat_interleave(w)[None, :, None]
    b = bbox.float()
    inside = ((xg >= b[..., 0][:, None]) & (xg <= b[..., 2][:, None])
              & (yg >= b[..., 1][:, None]) & (yg <= b[..., 3][:, None]))
    chars = torch.where(inside, 0.0, MASK_VALUE).repeat_interleave(vision_tokens, dim=-1)
    dummy = torch.where(inside.any(-1, keepdim=True), MASK_VALUE, 0.0)
    return torch.cat([dummy.expand(-1, -1, dummy_tokens), chars], dim=-1)


def add_dialog(x, boxes, emb):
    """``emb`` added once inside the union of the dialog boxes (floor bounds,
    half-open)."""
    _, h, w, _ = x.shape
    bb = boxes.float()
    xs = torch.arange(w, dtype=torch.float32, device=x.device)
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    in_y = (ys >= torch.floor(bb[..., 1] * h)[..., None]) & (ys < torch.floor(bb[..., 3] * h)[..., None])
    in_x = (xs >= torch.floor(bb[..., 0] * w)[..., None]) & (xs < torch.floor(bb[..., 2] * w)[..., None])
    inside = (in_y[:, :, :, None] & in_x[:, :, None, :]).any(dim=1)
    return x + inside[..., None].to(x.dtype) * emb


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------
class SelfAttention(nn.Module):
    def __init__(self, dim, n):
        super().__init__()
        self.n = n
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x):
        o = attention(heads(self.to_q(x), self.n), heads(self.to_k(x), self.n),
                      heads(self.to_v(x), self.n))
        return self.to_out[0](merge(o))


class MangaCrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, n):
        super().__init__()
        self.n = n
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.processor = nn.Module()
        self.processor.to_k_ip = nn.Linear(ctx_dim, dim, bias=False)
        self.processor.to_v_ip = nn.Linear(ctx_dim, dim, bias=False)

    def forward(self, x, ctx, ctx_ip, bias, ip_scale):
        q = heads(self.to_q(x), self.n)
        h = attention(q, heads(self.to_k(ctx), self.n), heads(self.to_v(ctx), self.n))
        if ctx_ip is not None:
            h_ip = attention(q, heads(self.processor.to_k_ip(ctx_ip), self.n),
                             heads(self.processor.to_v_ip(ctx_ip), self.n),
                             None if bias is None else bias[:, None])
            h = h + ip_scale * h_ip
        return self.to_out[0](merge(h))


class GEGLU(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(dim, dim * mult * 2)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, n):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = SelfAttention(dim, n)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = MangaCrossAttention(dim, ctx_dim, n)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLU(dim)

    def forward(self, x, ctx, ctx_ip, bias, ip_scale):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx, ctx_ip, bias, ip_scale)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, layers, ch, ctx_dim, n, groups):
        super().__init__()
        self.norm = GroupNorm(groups, ch, 1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, ctx_dim, n) for _ in range(layers)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, ctx, ctx_ip, bias, ip_scale):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            y = block(y, ctx, ctx_ip, bias, ip_scale)
        return self.proj_out(y).reshape(b, h, w, c) + x


def _stage(resnets, attentions, sampler=None, name=None):
    stage = nn.Module()
    stage.resnets = nn.ModuleList(resnets)
    stage.attentions = nn.ModuleList(attentions)
    if sampler is not None:
        setattr(stage, name, nn.ModuleList([sampler]))
    return stage


class UNet(nn.Module):
    """``forward(latents [B, h, w, 4], t [B], ctx, pooled, time_ids, ip_tokens,
    ip_biases {level: [B, S, T]}, ip_scale, dialog_bbox)`` -> eps. With
    ``checkpointed`` each resnet and transformer stack is recomputed in the
    backward (memory only: the arithmetic is the same)."""

    def __init__(self, cfg: Dict, manga: Dict):
        super().__init__()
        self.cfg, self.manga = cfg, manga
        chans, groups, tl = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["transformer_layers_per_block"]
        ted = chans[0] * 4
        n = len(chans)
        self.checkpointed = False
        self.conv_in = Conv(cfg["in_channels"], chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], ted)
        self.add_embedding = TimestepEmbedding(
            cfg["pooled_projection_dim"] + 6 * cfg["addition_time_embed_dim"], ted)
        if cfg["use_dialog_embedding"]:
            self.dialog_bbox_embedding = nn.Parameter(torch.zeros(chans[0]))

        def transformer(level, layers):
            return Transformer2D(layers, chans[level], cfg["cross_attention_dim"],
                                 chans[level] // cfg["head_dim"], groups)

        skips, prev = [chans[0]], chans[0]
        self.down_blocks = nn.ModuleList()
        for level, ch in enumerate(chans):
            res, att = [], []
            for _ in range(cfg["layers_per_block"]):
                res.append(ResnetBlock2D(prev, ch, groups, ted))
                if tl[level] > 0:
                    att.append(transformer(level, tl[level]))
                prev = ch
                skips.append(ch)
            down = Downsample2D(ch) if level < n - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_stage(res, att, down, "downsamplers"))
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(chans[-1], chans[-1], groups, ted) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([transformer(n - 1, cfg["mid_transformer_layers"])])
        self.up_blocks = nn.ModuleList()
        for level in reversed(range(n)):
            ch = chans[level]
            res, att = [], []
            for _ in range(cfg["layers_per_block"] + 1):
                res.append(ResnetBlock2D(prev + skips.pop(), ch, groups, ted))
                if tl[level] > 0:
                    att.append(transformer(level, tl[level]))
                prev = ch
            up = Upsample2D(ch) if level > 0 else None
            self.up_blocks.append(_stage(res, att, up, "upsamplers"))
        self.conv_norm_out = GroupNorm(groups, chans[0], 1e-5, silu=True)
        self.conv_out = Conv(chans[0], cfg["out_channels"], 3, padding=1)

    def levels(self):
        return [i for i, t in enumerate(self.cfg["transformer_layers_per_block"]) if t > 0]

    def _run(self, block, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, x, t, ctx, pooled, time_ids, ip_tokens=None, ip_biases=None,
                ip_scale=1.0, dialog_bbox=None):
        cfg = self.cfg
        chans = cfg["block_out_channels"]
        n = len(chans)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        temb = self.time_embedding(timestep_embedding(t, chans[0]))
        tid = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"])
        temb = temb + self.add_embedding(torch.cat(
            [pooled.float(), tid.reshape(time_ids.shape[0], -1)], dim=-1))
        h = self.conv_in(x)
        if cfg["use_dialog_embedding"] and dialog_bbox is not None:
            h = add_dialog(h, dialog_bbox, self.dialog_bbox_embedding)

        def attend(att, h, level):
            bias = None if ip_biases is None or ip_tokens is None else ip_biases.get(level)
            return self._run(att, h, ctx, ip_tokens, bias, ip_scale)

        skips = [h]
        for level, stage in enumerate(self.down_blocks):
            for j, res in enumerate(stage.resnets):
                h = self._run(res, h, temb)
                if len(stage.attentions):
                    h = attend(stage.attentions[j], h, level)
                skips.append(h)
            if level < n - 1:
                h = stage.downsamplers[0](h)
                skips.append(h)
        h = self._run(self.mid_block.resnets[0], h, temb)
        h = attend(self.mid_block.attentions[0], h, n - 1)
        h = self._run(self.mid_block.resnets[1], h, temb)
        for rev, stage in enumerate(self.up_blocks):
            level = n - 1 - rev
            for j, res in enumerate(stage.resnets):
                h = self._run(res, torch.cat([h, skips.pop()], dim=-1), temb)
                if len(stage.attentions):
                    h = attend(stage.attentions[j], h, level)
            if level > 0:
                h = stage.upsamplers[0](h, tuple(skips[-1].shape[1:3]))
        return self.conv_out(self.conv_norm_out(h))


def level_shape(h, w, level):
    return -(-h // (1 << level)), -(-w // (1 << level))


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------
class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(ch, ch), nn.Linear(ch, ch), nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        o = attention(self.to_q(t)[:, None], self.to_k(t)[:, None], self.to_v(t)[:, None])[:, 0]
        return self.to_out[0](o).reshape(b, h, w, c) + x


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chans, groups = cfg["block_out_channels"], cfg["norm_num_groups"]
        self.conv_in = Conv(cfg["in_channels"], chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for level, ch in enumerate(chans):
            stage = nn.Module()
            stage.resnets = nn.ModuleList()
            for _ in range(cfg["layers_per_block"]):
                stage.resnets.append(ResnetBlock2D(prev, ch, groups, eps=1e-6))
                prev = ch
            if level < len(chans) - 1:
                stage.downsamplers = nn.ModuleList([Downsample2D(ch)])
            self.down_blocks.append(stage)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(chans[-1], chans[-1], groups, eps=1e-6) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(chans[-1], groups)])
        self.conv_norm_out = GroupNorm(groups, chans[-1], 1e-6, silu=True)
        self.conv_out = Conv(chans[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "downsamplers"):
                x = stage.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chans, groups = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
        self.conv_in = Conv(cfg["latent_channels"], chans[0], 3, padding=1)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(chans[0], chans[0], groups, eps=1e-6) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(chans[0], groups)])
        self.up_blocks = nn.ModuleList()
        prev = chans[0]
        for rev, ch in enumerate(chans):
            stage = nn.Module()
            stage.resnets = nn.ModuleList()
            for _ in range(cfg["layers_per_block"] + 1):
                stage.resnets.append(ResnetBlock2D(prev, ch, groups, eps=1e-6))
                prev = ch
            if rev < len(chans) - 1:
                stage.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(stage)
        self.conv_norm_out = GroupNorm(groups, chans[-1], 1e-6, silu=True)
        self.conv_out = Conv(chans[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        for stage in self.up_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "upsamplers"):
                x = stage.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class VAE(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        lc = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1)
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv(lc, lc, 1)

    @property
    def factor(self):
        return 2 ** (len(self.cfg["block_out_channels"]) - 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def tile_plan(h, w, tile=96, overlap=24):
    stride = tile - overlap
    return [(min(y0, h - tile) if h > tile else 0, min(x0, w - tile) if w > tile else 0)
            for y0 in range(0, max(h - overlap, 1), stride)
            for x0 in range(0, max(w - overlap, 1), stride)]


def _ramp(length, start, total, overlap):
    r = np.ones((length,), np.float32)
    if start > 0:
        r[:overlap] = np.linspace(0.0, 1.0, overlap, endpoint=False)
    if start + length < total:
        r[-overlap:] = r[-overlap:] * np.linspace(1.0, 0.0, overlap, endpoint=False)
    return r


def decode_image(vae: VAE, latents, scaling, tile=96, overlap=24):
    """Latents -> image in [0, 1]: whole up to a side of 128, else in
    ramp-blended tiles of ``tile`` latents."""
    z = latents.float() / scaling
    b, h, w, _ = z.shape
    if max(h, w) <= 128 or (h <= tile and w <= tile):
        img = vae.decode(z)
    else:
        f = vae.factor
        th = tile * f
        weight = np.zeros((1, h * f, w * f, 1), np.float32)
        img = torch.zeros((b, h * f, w * f, vae.cfg["out_channels"]), device=z.device)
        for y0, x0 in tile_plan(h, w, tile, overlap):
            m = (_ramp(th, y0 * f, h * f, overlap * f)[:, None]
                 * _ramp(th, x0 * f, w * f, overlap * f)[None, :])[None, :, :, None]
            weight[:, y0 * f:y0 * f + th, x0 * f:x0 * f + th] += m
            img[:, y0 * f:y0 * f + th, x0 * f:x0 * f + th] += (
                vae.decode(z[:, y0:y0 + tile, x0:x0 + tile]) * torch.from_numpy(m).to(z.device))
        img = img / torch.from_numpy(np.clip(weight, 1e-6, None)).to(z.device)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------
class CLIPAttention(nn.Module):
    def __init__(self, dim, n):
        super().__init__()
        self.n = n
        self.q_proj, self.k_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v_proj, self.out_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, x, bias=None):
        o = attention(heads(self.q_proj(x), self.n), heads(self.k_proj(x), self.n),
                      heads(self.v_proj(x), self.n), bias)
        return self.out_proj(merge(o))


class CLIPMLP(nn.Module):
    def __init__(self, dim, inner, act):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = nn.Linear(dim, inner), nn.Linear(inner, dim)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["hidden_size"]
        self.self_attn = CLIPAttention(d, cfg["num_heads"])
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = CLIPMLP(d, cfg["intermediate_size"], cfg["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class TextEncoder(nn.Module):
    """ids [B, S] -> (penultimate hidden state, pooled at argmax(ids))."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg["hidden_size"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg["num_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.text_projection = (nn.Linear(d, cfg["projection_dim"], bias=False)
                                if cfg.get("projection_dim") else None)

    def forward(self, ids):
        tm = self.text_model
        b, s = ids.shape
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:s][None]
        pos = torch.arange(s, device=ids.device)
        causal = torch.where(pos[:, None] >= pos[None, :], 0.0, CAUSAL_MASK)[None, None]
        pen = x
        for layer in tm.encoder.layers:
            pen = x
            x = layer(x, causal)
        pooled = tm.final_layer_norm(x)[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return pen, pooled


def _attach(root, path, module):
    *parents, leaf = path.split(".")
    node = root
    for name in parents:
        if not hasattr(node, name):
            node.add_module(name, nn.Module())
        node = getattr(node, name)
    node.add_module(leaf, module)
    return module


_CLIP = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
         "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
         "ln1": "layer_norm1", "ln2": "layer_norm2"}
_MAE = {"q": "attention.attention.query", "k": "attention.attention.key",
        "v": "attention.attention.value", "o": "attention.output.dense",
        "fc1": "intermediate.dense", "fc2": "output.dense",
        "ln1": "layernorm_before", "ln2": "layernorm_after"}


class ViTLayer(nn.Module):
    def __init__(self, cfg, names):
        super().__init__()
        d, inner = cfg["hidden_size"], cfg["intermediate_size"]
        self.n = cfg["num_heads"]
        dims = {"q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d), "fc1": (d, inner),
                "fc2": (inner, d)}
        self.m = {k: _attach(self, names[k], nn.Linear(*s)) for k, s in dims.items()}
        for k in ("ln1", "ln2"):
            self.m[k] = _attach(self, names[k], nn.LayerNorm(d, eps=cfg["norm_eps"]))

    def forward(self, x):
        m = self.m
        h = m["ln1"](x)
        o = attention(heads(m["q"](h), self.n), heads(m["k"](h), self.n), heads(m["v"](h), self.n))
        x = x + m["o"](merge(o))
        return x + m["fc2"](F.gelu(m["fc1"](m["ln2"](x))))


class ViT(nn.Module):
    """pixels [B, 224, 224, 3] -> (penultimate hidden state, final CLS)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d = cfg["hidden_size"]
        seq = (cfg["image_size"] // cfg["patch_size"]) ** 2 + int(cfg["use_class_embedding"])
        patch = nn.Conv2d(3, d, cfg["patch_size"], stride=cfg["patch_size"], bias=cfg["patch_bias"])
        post = nn.LayerNorm(d, eps=cfg["norm_eps"])
        if cfg["use_pre_layernorm"]:
            emb = _attach(self, "vision_model.embeddings", nn.Module())
            emb.patch_embedding = patch
            if cfg["use_class_embedding"]:
                emb.class_embedding = nn.Parameter(torch.zeros(d))
            emb.position_embedding = nn.Embedding(seq, d)
            pre = _attach(self, "vision_model.pre_layrnorm", nn.LayerNorm(d, eps=cfg["norm_eps"]))
            layers = _attach(self, "vision_model.encoder.layers", nn.ModuleList(
                [ViTLayer(cfg, _CLIP) for _ in range(cfg["num_layers"])]))
            _attach(self, "vision_model.post_layernorm", post)
        else:
            emb = _attach(self, "embeddings", nn.Module())
            _attach(emb, "patch_embeddings.projection", patch)
            if cfg["use_class_embedding"]:
                emb.cls_token = nn.Parameter(torch.zeros(1, 1, d))
            emb.position_embeddings = nn.Parameter(torch.zeros(1, seq, d))
            pre = None
            layers = _attach(self, "encoder.layer", nn.ModuleList(
                [ViTLayer(cfg, _MAE) for _ in range(cfg["num_layers"])]))
            _attach(self, "layernorm", post)
        self.m = dict(emb=emb, patch=patch, pre=pre, layers=layers, post=post)

    def forward(self, pixels):
        m, d = self.m, self.cfg["hidden_size"]
        x = m["patch"](pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        b = x.shape[0]
        if self.cfg["use_pre_layernorm"]:
            cls = getattr(m["emb"], "class_embedding", None)
            pos = m["emb"].position_embedding.weight
        else:
            cls = getattr(m["emb"], "cls_token", None)
            pos = m["emb"].position_embeddings
        if cls is not None:
            x = torch.cat([cls.reshape(1, 1, d).expand(b, 1, d), x], dim=1)
        x = x + pos.reshape(1, -1, d)
        if m["pre"] is not None:
            x = m["pre"](x)
        pen = x
        for layer in m["layers"]:
            pen = x
            x = layer(x)
        return pen, m["post"](x)[:, 0]


class PerceiverAttention(nn.Module):
    def __init__(self, dim, dim_head, n):
        super().__init__()
        inner = dim_head * n
        self.n = n
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=1e-5), nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, lat):
        x, lat = self.norm1(x), self.norm2(lat)
        k, v = self.to_kv(torch.cat([x, lat], dim=-2)).chunk(2, dim=-1)
        o = attention(heads(self.to_q(lat), self.n), heads(k, self.n), heads(v, self.n))
        return self.to_out(merge(o))


class Resampler(nn.Module):
    """(clip [B, I, P, E], magi [B, I, Em]) -> [B, dummy + I * queries, out]."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dim = cfg["dim"]
        self.latents = nn.Parameter(torch.zeros(1, cfg["num_queries"], dim))
        self.dummy_tokens = nn.Parameter(torch.zeros(cfg["num_dummy_tokens"], cfg["output_dim"]))
        self.proj_in = nn.Linear(cfg["embedding_dim"], dim)
        self.proj_in_magi = nn.Linear(cfg["magi_embedding_dim"], dim)
        self.layers = nn.ModuleList([nn.ModuleList([
            PerceiverAttention(dim, cfg["dim_head"], cfg["heads"]),
            nn.Sequential(nn.LayerNorm(dim, eps=1e-5), nn.Linear(dim, dim * cfg["ff_mult"], bias=False),
                          nn.GELU(), nn.Linear(dim * cfg["ff_mult"], dim, bias=False))])
            for _ in range(cfg["depth"])])
        self.proj_out = nn.Linear(dim, cfg["output_dim"])
        self.norm_out = nn.LayerNorm(cfg["output_dim"], eps=1e-5)

    def forward(self, clip, magi):
        b, i, p, _ = clip.shape
        x = torch.cat([self.proj_in(clip.reshape(b * i, p, -1)),
                       self.proj_in_magi(magi.reshape(b * i, 1, -1))], dim=1)
        lat = self.latents.expand(b * i, -1, -1)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff(lat)
        out = self.norm_out(self.proj_out(lat)).reshape(b, i * self.cfg["num_queries"], -1)
        return torch.cat([self.dummy_tokens.expand(b, -1, -1), out], dim=1)


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------
NETS = ("unet", "vae", "text_encoder", "text_encoder_2", "image_encoder", "magi_encoder",
        "resampler")


def build(stack: Dict) -> Dict[str, nn.Module]:
    """The stack's modules (parameters on the current default device)."""
    return dict(unet=UNet(stack["unet"], stack["manga"]), vae=VAE(stack["vae"]),
                text_encoder=TextEncoder(stack["text_encoder"]),
                text_encoder_2=TextEncoder(stack["text_encoder_2"]),
                image_encoder=ViT(stack["image_encoder"]), magi_encoder=ViT(stack["magi_encoder"]),
                resampler=Resampler(stack["resampler"]))


def encode_prompt(nets, ids, ids_2):
    """(ctx [B, 77, D1 + D2], pooled [B, P]) of two token-id batches."""
    h1, _ = nets["text_encoder"](ids)
    h2, pooled = nets["text_encoder_2"](ids_2)
    return torch.cat([h1, h2], dim=-1), pooled


def sizes(stack: Dict) -> Tuple[int, ...]:
    """Parameter counts by network, for the records."""
    with torch.device("meta"):
        nets = build(stack)
    return tuple(sum(p.numel() for p in nets[n].parameters()) for n in NETS)
