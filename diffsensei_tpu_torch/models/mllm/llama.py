"""LLaMA for the SEED-X agent (port of ``diffsensei_tpu/models/mllm/llama.py``).

RMSNorm, rotary positions, GQA attention with a static KV cache, the SwiGLU
MLP, and every projection a ``LoRADense`` whose base is a dense weight, a
weight-only int8 ``Int8Dense`` or a packed int4 ``Int4Dense``. The state-dict
names follow the JAX tree (``layers.{i}.attn.q_proj.base.weight``,
``layers.{i}.input_norm.weight``, ``lm_head.kernel_q``, ...), so
``utils.from_jax.llama`` is a rename and a transpose.

The served decode is batch 1, one token a step: each ``Int4Dense`` then
streams its packed weight once through kernel B6 (``ops/int4_matmul.py``);
prefill dequantizes and runs one plain matmul. Attention goes through the
port's dispatcher, so it reaches B1 only at 1024 keys or more in bf16. The KV
cache is written in place at ``cache_index`` (the JAX package returns a new
one), which keeps one buffer per layer for the whole request.

Training (stage 3): ``cross_entropy_lm_loss`` is the shifted LM loss;
``remat`` recomputes each layer in the backward (``torch.utils.checkpoint``,
the JAX ``nn.remat``), in full or, with ``remat_policy = "attn"``, keeping
the attention outputs the JAX policy names (``models/remat.py``); and fp32
trainables (the adapters,
the embeddings, ``lm_head``, the norms) may sit in a bf16 model, because the
dense layers cast their weights to the activations' dtype at use and the
forward computes in ``compute_dtype`` when it is set. As in the JAX package,
the training forward masks causally and not over the padding.

Tensor parallelism (``tp_group``, the mesh's model axis; the JAX package's
``llm_param_sharding_rules`` with the KV cache's ``kv_sharding``): each rank
builds only its shards, ``num_heads / tp`` query and ``num_kv_heads / tp``
KV heads a layer, column-parallel q/k/v and gate/up, row-parallel o and
down, the vocabulary split over the embedding and ``lm_head``; the
collectives and the layout are ``parallel/tensor.py``'s, the shards
``shard_llama_state``'s. A ``ScheduleRank`` in place of the process group
builds a rank's shard set for ``model_axis_schedule``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffsensei_tpu_torch.core.config import LlamaConfig
from diffsensei_tpu_torch.models import remat
from diffsensei_tpu_torch.models.layers import Linear
from diffsensei_tpu_torch.ops import int4_matmul as i4
from diffsensei_tpu_torch.ops.attention import multi_head_attention
from diffsensei_tpu_torch.parallel.tensor import (
    ModelAxis, check_model_axis, copy_to_model, gather_vocab, model_axis, reduce_from_model,
    vocab_range)

NEG_INF = -1e30
Cache = Tuple[torch.Tensor, torch.Tensor]


class Int8Dense(nn.Module):
    """Weight-only int8, per output channel: ``y = (x @ Q) * s`` with ``Q``
    int8 ``[in, out]`` and ``s`` fp32 ``[out]``."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = nn.Parameter(torch.empty((in_features, features), dtype=torch.int8,
                                                 device=device), requires_grad=False)
        self.kernel_scale = nn.Parameter(torch.empty((features,), dtype=torch.float32,
                                                     device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel_q.to(self.dtype))
        return y * self.kernel_scale.to(self.dtype)


class Int4Dense(nn.Module):
    """Weight-only group-wise int4, nibble-packed (``ops/int4_matmul.py``):
    ``kernel_q`` uint8 ``[in, F'/2]``, ``kernel_scale`` fp32 ``[in/g, F']``
    with ``F'`` the padded feature count; the output is sliced to ``features``.

    Up to 16 tokens (decode) the product streams the packed bytes: kernel B6
    on the card where ``kernel_eligible`` (it takes the fp32 x and rounds it
    to bf16 itself, fp32 out, as the TPU kernel does), the plain twin
    otherwise. More tokens (prefill) dequantize once and run one
    ``torch.matmul``."""

    def __init__(self, in_features: int, features: int, group: int = 128,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.features, self.group, self.dtype = features, group, dtype
        g = i4.group_size(group, in_features)
        padded = i4.padded_features(features, in_features, group)
        self.kernel_q = nn.Parameter(torch.empty((in_features, padded // 2), dtype=torch.uint8,
                                                 device=device), requires_grad=False)
        self.kernel_scale = nn.Parameter(torch.empty((in_features // g, padded),
                                                     dtype=torch.float32, device=device),
                                         requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_f = x.shape[-1]
        q, s = self.kernel_q, self.kernel_scale
        tokens = math.prod(x.shape[:-1])
        if tokens <= i4.MAX_TOKENS:
            x2 = x.reshape(tokens, in_f)
            if i4.kernel_eligible(in_f, self.group):
                y = i4.int4_decode_matmul(x2.to(self.dtype).contiguous(), q, s).to(self.dtype)
            else:
                y = i4.int4_decode_fallback(x2.to(self.dtype), q, s)
            return y[..., :self.features].reshape(x.shape[:-1] + (self.features,))
        w = i4.dequantize(q, s, dtype=self.dtype)
        return torch.matmul(x.to(self.dtype), w)[..., :self.features]


class LoRADense(nn.Module):
    """A projection: a base (dense ``Linear`` without bias, ``Int8Dense``
    or ``Int4Dense`` by ``quantized``: False, True/"int8", "int4") plus an
    optional low-rank adapter, ``y = base(x) + (alpha/r) (x A) B``; the dense
    weights are cast to x's dtype at use. Under tensor parallelism
    (``parallel``: "column" or "row" on ``axis``) the sizes are the rank's
    and the collectives ``parallel/tensor.py``'s."""

    def __init__(self, in_features: int, features: int, lora_rank: int = 0,
                 lora_alpha: float = 16.0, quantized=False, dtype=torch.float32,
                 device=None, parallel: Optional[str] = None,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        self.parallel, self.axis = (parallel, axis) if axis is not None else (None, None)
        kw = dict(dtype=dtype, device=device)
        if str(quantized) == "int4":
            self.base = Int4Dense(in_features, features, **kw)
        elif quantized:
            self.base = Int8Dense(in_features, features, **kw)
        else:
            self.base = Linear(in_features, features, bias=False, **kw)
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        if lora_rank > 0:
            self.lora_A = Linear(in_features, lora_rank, bias=False, **kw)
            self.lora_B = Linear(lora_rank, features, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.lora_alpha / max(self.lora_rank, 1)
        if self.parallel == "column":
            # A reads x before the copy, so x's gradient through it is summed once
            y = self.base(copy_to_model(x, self.axis))
            if self.lora_rank > 0:
                y = y + scale * self.lora_B(copy_to_model(self.lora_A(x), self.axis))
            return y
        if self.parallel == "row":
            y = self.base(x)
            if self.lora_rank > 0:
                h = self.lora_A(x)
                # B is whole on every rank and its gradient a partial sum: summed backward
                b = copy_to_model(self.lora_B.weight, self.axis)
                y = y + scale * F.linear(h, b.to(h.dtype))
            return reduce_from_model(y, self.axis)
        y = self.base(x)
        if self.lora_rank > 0:
            y = y + scale * self.lora_B(self.lora_A(x))
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty((dim,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (norm * self.weight.float()).to(self.dtype)


def rotary_tables(head_dim: int, max_len: int, theta: float,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)``, each ``[max_len, head_dim]``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    freqs = torch.outer(torch.arange(max_len, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """x: ``[B, H, S, D]``; positions: ``[B, S]`` absolute positions."""
    c = cos[positions][:, None]
    s = sin[positions][:, None]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * c + rot.float() * s).to(x.dtype)


def decode_bias(positions: torch.Tensor, klen: int) -> torch.Tensor:
    """fp32 ``[B, 1, S, klen]``: 0 where the key's slot <= the query's
    position, -1e30 beyond the written prefix of the cache."""
    kpos = torch.arange(klen, device=positions.device)[None, None, None, :]
    qpos = positions[:, None, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    return torch.where(kpos <= qpos, zero, torch.full_like(zero, NEG_INF))


def _tp(axis: Optional[ModelAxis]) -> int:
    return 1 if axis is None else axis.size


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, lora_rank: int = 0, quantized=False,
                 dtype=torch.float32, device=None, axis: Optional[ModelAxis] = None):
        super().__init__()
        self.config = config
        hd, tp = config.head_dim, _tp(axis)
        self.num_heads, self.num_kv_heads = config.num_heads // tp, config.num_kv_heads // tp
        h, kvh = self.num_heads, self.num_kv_heads
        kw = dict(lora_rank=lora_rank, quantized=quantized, dtype=dtype, device=device,
                  axis=axis)
        d = config.hidden_size
        self.q_proj = LoRADense(d, h * hd, parallel="column", **kw)
        self.k_proj = LoRADense(d, kvh * hd, parallel="column", **kw)
        self.v_proj = LoRADense(d, kvh * hd, parallel="column", **kw)
        self.o_proj = LoRADense(h * hd, d, parallel="row", **kw)

    def forward(self, x, cos, sin, positions, cache: Optional[Cache] = None,
                cache_index: Optional[int] = None, bias: Optional[torch.Tensor] = None):
        """``bias``: the decode mask of ``decode_bias`` when the caller has it."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim

        def heads(t, n):
            return t.reshape(b, s, n, hd).transpose(1, 2)

        q = apply_rotary(heads(self.q_proj(x), self.num_heads), cos, sin, positions)
        k = apply_rotary(heads(self.k_proj(x), self.num_kv_heads), cos, sin, positions)
        v = heads(self.v_proj(x), self.num_kv_heads)

        new_cache = None
        if cache is not None:
            ck, cv = cache    # [B, H_kv, max_len, D], written in place
            ck[:, :, cache_index:cache_index + s] = k.to(ck.dtype)
            cv[:, :, cache_index:cache_index + s] = v.to(cv.dtype)
            k, v = ck, cv
            new_cache = (ck, cv)

        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)

        if cache is None:
            o = multi_head_attention(q, k, v, causal=True)
        else:
            if bias is None:
                bias = decode_bias(positions, k.shape[2])
            o = multi_head_attention(q, k, v, bias=bias)
        o = o.transpose(1, 2).reshape(b, s, self.num_heads * hd)
        return self.o_proj(o), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, lora_rank: int = 0, quantized=False,
                 dtype=torch.float32, device=None, axis: Optional[ModelAxis] = None):
        super().__init__()
        kw = dict(lora_rank=lora_rank, quantized=quantized, dtype=dtype, device=device,
                  axis=axis)
        d, f = config.hidden_size, config.intermediate_size // _tp(axis)
        self.gate_proj = LoRADense(d, f, parallel="column", **kw)
        self.up_proj = LoRADense(d, f, parallel="column", **kw)
        self.down_proj = LoRADense(f, d, parallel="row", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, config: LlamaConfig, lora_rank: int = 0, quantized=False,
                 dtype=torch.float32, device=None, axis: Optional[ModelAxis] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        qkw = dict(lora_rank=lora_rank, quantized=quantized, axis=axis, **kw)
        self.input_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.attn = LlamaAttention(config, **qkw)
        self.post_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **qkw)

    def forward(self, x, cos, sin, positions, cache=None, cache_index=None, bias=None):
        a, new_cache = self.attn(self.input_norm(x), cos, sin, positions, cache=cache,
                                 cache_index=cache_index, bias=bias)
        x = x + a
        x = x + self.mlp(self.post_norm(x))
        return x, new_cache


class LlamaForCausalLM(nn.Module):
    """Returns ``(logits, final_hidden, new_caches)``.

    ``inputs_embeds`` is first-class (the agent scatters image embeddings into
    token slots first); ``caches`` is a list of per-layer ``(k, v)`` buffers
    (``init_caches``) with ``cache_index`` the write offset, or None for a
    full causal forward. ``quantized``: False, True/"int8" or "int4".

    ``tp_group``: the model axis's process group (or ``ScheduleRank``); the
    module then holds this rank's shards (``parallel/tensor.py``) and every rank returns the whole
    logits. A layout that does not split over the group raises
    ``ValueError`` here (``check_model_axis``)."""

    def __init__(self, config: LlamaConfig, lora_rank: int = 0, quantized=False,
                 dtype=torch.float32, device=None, tp_group=None):
        super().__init__()
        self.config, self.lora_rank, self.quantized = config, lora_rank, quantized
        self._dtype = dtype
        self.axis = model_axis(tp_group)
        if self.axis is not None:
            check_model_axis(config, self.axis.size, quantized)
            self.vocab_rows = vocab_range(config.vocab_size, self.axis.rank, self.axis.size)
        else:
            self.vocab_rows = (0, config.vocab_size)
        rows = self.vocab_rows[1] - self.vocab_rows[0]
        kw = dict(dtype=dtype, device=device)
        self.embed_tokens = nn.Embedding(rows, config.hidden_size, **kw)
        self.layers = nn.ModuleList(
            LlamaLayer(config, lora_rank, quantized=quantized, axis=self.axis, **kw)
            for _ in range(config.num_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        if str(quantized) == "int4":
            self.lm_head = Int4Dense(config.hidden_size, rows, **kw)
        elif quantized:
            self.lm_head = Int8Dense(config.hidden_size, rows, **kw)
        else:
            self.lm_head = Linear(config.hidden_size, rows, bias=False, **kw)
        self.compute_dtype: Optional[torch.dtype] = None
        self.remat = False
        self.remat_policy: Optional[str] = None
        self._rope = {}

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: ``compute_dtype`` when set, else the build's."""
        return self.compute_dtype or self._dtype

    @property
    def tp_size(self) -> int:
        """Ranks on the model axis (1 without tensor parallelism)."""
        return _tp(self.axis)

    def enable_remat(self, policy: Optional[str] = None) -> None:
        """Recompute each layer in the backward: in full (None), or keeping
        its attention outputs (``"attn"``, the JAX
        ``save_only_these_names("attn_out", "attn_lse")``). Any other name
        raises ``ValueError``."""
        self.remat_policy = remat.check_policy(policy, allowed=("attn",))
        self.remat = True

    def _layer(self, layer: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False,
                              context_fn=remat.context_fn(self.remat_policy))
        return layer(*args)

    def rotary(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rotary tables on ``device``, computed once."""
        key = str(device)
        if key not in self._rope:
            cfg = self.config
            self._rope[key] = rotary_tables(cfg.head_dim, cfg.max_position_embeddings,
                                            cfg.rope_theta, device)
        return self._rope[key]

    def embed_tokens_only(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding lookup (the agent needs it before scattering);
        under tensor parallelism each rank looks up its rows, zero for the
        others', and the ranks' lookups are summed."""
        if self.axis is None:
            return self.embed_tokens(input_ids)
        start, stop = self.vocab_rows
        local = input_ids - start
        inside = (local >= 0) & (local < stop - start)
        emb = self.embed_tokens(torch.where(inside, local, 0)).masked_fill(~inside[..., None], 0)
        return reduce_from_model(emb, self.axis)

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """``lm_head`` over the final hidden state; under tensor parallelism
        the ranks' vocabulary slices gathered whole."""
        if self.axis is None:
            return self.lm_head(x)
        return gather_vocab(self.lm_head(copy_to_model(x, self.axis)), self.axis,
                            self.vocab_rows[0], self.config.vocab_size)

    def forward(self, input_ids=None, inputs_embeds=None, positions=None,
                caches: Optional[List[Cache]] = None, cache_index: Optional[int] = None):
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens_only(input_ids)
        x = inputs_embeds.to(self.dtype)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        cos, sin = self.rotary(x.device)
        bias = None if caches is None else decode_bias(positions, caches[0][0].shape[2])
        new_caches = []
        for idx, layer in enumerate(self.layers):
            if caches is None:
                x, nc = self._layer(layer, x, cos, sin, positions)
            else:
                x, nc = layer(x, cos, sin, positions, caches[idx], cache_index, bias)
            new_caches.append(nc)
        x = self.norm(x)
        return self.lm_logits(x), x, (new_caches if caches is not None else None)


def init_caches(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.float32,
                device=None, tp: int = 1) -> List[Cache]:
    """Per-layer ``(k, v)`` buffers ``[B, H_kv / tp, max_len, D]``: under
    tensor parallelism a rank's KV heads only (the JAX ``kv_sharding``
    ``P(None, "model", None, None)``)."""
    shape = (batch, cfg.num_kv_heads // tp, max_len, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]


def cross_entropy_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100) -> torch.Tensor:
    """Shifted LM loss (HF convention: ``logits[:, :-1]`` predict
    ``labels[:, 1:]``), the mean over the labels that are not
    ``ignore_index``; 0 where every label is ignored (the JAX package divides
    by ``max(count, 1)``, where ``F.cross_entropy`` would give NaN)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    valid = targets != ignore_index
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
