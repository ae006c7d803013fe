"""The plain reference of a LLaMA decoder (the SEED-X agent's LLM): RMSNorm,
rotary positions on the rotated halves, grouped-query attention with a causal
mask, the SwiGLU MLP, a final RMSNorm and an untied head.

Plain PyTorch in the weights' dtype (the benchmark runs it in float32 with
TF32 off): full causal attention over the whole sequence, no cache. The
parameter names are the program's (a LoRA-ready projection keeps its weight
under ``base``), so one seeded draw loads into both.

A reference decoder module gives the harness, by name:

* ``build(config)``: the module, its parameters on the current device;
* ``block_of(name)``: the block a parameter is drawn and loaded with
  (``embed``, ``layers.<i>``, ``head``);
* ``forward(model, ids, edit, load)``: logits and final hidden states of one
  teacher-forced causal pass, one block at a time (``load(block)`` holds the
  block's weights while it runs; ``edit`` changes the embedded sequence
  before the first layer);
* ``least_cost(config, prompt_len, new_tokens, dtype_bytes)``: the prefill's
  FLOPs and bytes and the decode's bytes, for the least time of a request.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nets import CAUSAL_MASK, attention


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


class Proj(nn.Module):
    """``x W^T`` with the weight under the program's name ``base.weight``."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.base = nn.Linear(din, dout, bias=False)

    def forward(self, x):
        return self.base(x)


def rotate(x, positions, theta: float):
    """Rotary positions on [B, H, S, D]: dimension i pairs with i + D/2."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).repeat(1, 2), torch.sin(ang).repeat(1, 2)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


class Attention(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, self.h, self.kv = cfg["hidden_size"], cfg["num_heads"], cfg["num_kv_heads"]
        self.hd, self.theta = d // self.h, cfg["rope_theta"]
        self.q_proj, self.o_proj = Proj(d, self.h * self.hd), Proj(self.h * self.hd, d)
        self.k_proj, self.v_proj = Proj(d, self.kv * self.hd), Proj(d, self.kv * self.hd)

    def forward(self, x, positions, mask):
        b, s, _ = x.shape
        split = lambda t, n: t.view(b, s, n, self.hd).transpose(1, 2)
        q = rotate(split(self.q_proj(x), self.h), positions, self.theta)
        k = rotate(split(self.k_proj(x), self.kv), positions, self.theta)
        v = split(self.v_proj(x), self.kv)
        rep = self.h // self.kv            # query head j reads key head j // rep
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        o = attention(q, k, v, mask)
        return self.o_proj(o.transpose(1, 2).reshape(b, s, self.h * self.hd))


class MLP(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, f = cfg["hidden_size"], cfg["intermediate_size"]
        self.gate_proj, self.up_proj, self.down_proj = Proj(d, f), Proj(d, f), Proj(f, d)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Layer(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.input_norm, self.post_norm = RMSNorm(d, eps), RMSNorm(d, eps)
        self.attn, self.mlp = Attention(cfg), MLP(cfg)

    def forward(self, x, positions, mask):
        x = x + self.attn(self.input_norm(x), positions, mask)
        return x + self.mlp(self.post_norm(x))


class Decoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.embed_tokens = nn.Embedding(cfg["vocab_size"], d)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg["num_layers"]))
        self.norm = RMSNorm(d, cfg["rms_norm_eps"])
        self.lm_head = nn.Linear(d, cfg["vocab_size"], bias=False)


def build(config: Dict) -> Decoder:
    return Decoder(config)


def block_of(name: str) -> str:
    if name.startswith("layers."):
        return ".".join(name.split(".")[:2])
    return "embed" if name.startswith("embed_tokens.") else "head"


def forward(model: Decoder, ids: torch.Tensor, edit: Callable, load: Callable):
    """``(logits [S, V], hidden [S, D])`` of the ids ``[S]``, causal; the
    hidden states are the final norm's output, as the program returns them."""
    s = ids.shape[0]
    positions = torch.arange(s, device=ids.device)
    mask = torch.triu(torch.full((s, s), CAUSAL_MASK, device=ids.device), diagonal=1)
    with load("embed"):
        x = edit(model.embed_tokens(ids)[None])
    for i, layer in enumerate(model.layers):
        with load(f"layers.{i}"):
            x = layer(x, positions, mask)
    with load("head"):
        hidden = model.norm(x)
        return model.lm_head(hidden)[0], hidden[0]


def least_cost(config: Dict, prompt_len: int, new_tokens: int, dtype_bytes: int = 2) -> Dict:
    """What a greedy request of ``prompt_len`` prompt tokens and
    ``new_tokens`` cached decode steps must do at the least: the prefill's
    FLOPs (every layer over the prompt, the head on its last row; counted on
    the meta device) and the bytes it reads (the weights once, the prompt's
    embedding rows); each decode step's reads: every weight but the
    embedding, one embedding row, and the K and V cache up to and with its
    own position."""
    from benchmark.yardstick import reference_flops

    with torch.device("meta"):
        model = build(config)
        x = torch.zeros((1, prompt_len, config["hidden_size"]))
        positions = torch.arange(prompt_len)
        mask = torch.zeros((prompt_len, prompt_len))

    def prefill():
        h = x
        for layer in model.layers:
            h = layer(h, positions, mask)
        model.lm_head(model.norm(h[:, -1:]))
    flops = reference_flops(prefill)
    d = config["hidden_size"]
    weights = sum(p.numel() for p in model.parameters()) - config["vocab_size"] * d
    kv_row = 2 * config["num_layers"] * config["num_kv_heads"] * (d // config["num_heads"])
    cache_rows = sum(prompt_len + k + 1 for k in range(new_tokens))
    return dict(prefill_flops=flops,
                prefill_bytes=dtype_bytes * (weights + prompt_len * d),
                decode_bytes=dtype_bytes * (new_tokens * (weights + d) + kv_row * cache_rows))
