"""Weight-only int8 / int4 quantization of the SEED-X LLM (port of
``diffsensei_tpu/models/mllm/quant.py``).

The tree functions are the JAX package's numpy host code, copied: they take
and return nested dicts in the JAX layout (``.../base/kernel``, ``lm_head``)
and give the same bytes. ``quantize_agent`` does the same arithmetic on the
port's ``ContinuousLVLM``: LoRA merged into each projection, then every
projection and ``lm_head`` quantized; embeddings and norms stay as they are.

* int8: per output channel, symmetric, ``scale = max|w[:, j]| / 127``.
* int4: group-wise symmetric (``g = gcd(128, in)``), range +-7, output
  columns zero-padded to ``padded_features`` (pad scales 1), nibbles packed in
  the split-half layout of ``ops/int4_matmul.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from diffsensei_tpu_torch.ops.int4_matmul import pack_int4_host, padded_features


def quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: w[in, out] -> (q int8, scale fp32)."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def quantize_kernel_int4(w: np.ndarray,
                         group: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Group-wise symmetric int4: w[in, out] -> (packed uint8 [in, F'/2],
    scale fp32 [in/G, F']), ``G = gcd(group, in)``."""
    w = np.asarray(w, np.float32)
    in_f, out_f = w.shape
    g = math.gcd(group, in_f)
    padded = padded_features(out_f, in_f, group)
    if padded != out_f:
        w = np.concatenate(
            [w, np.zeros((in_f, padded - out_f), np.float32)], axis=1)
    wg = w.reshape(in_f // g, g, padded)
    absmax = np.max(np.abs(wg), axis=1)
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(wg / scale[:, None, :]), -7, 7).astype(np.int8)
    return pack_int4_host(q.reshape(in_f, padded)), scale


def _merge(kernel, lora_a, lora_b, alpha: Optional[float]) -> np.ndarray:
    """``kernel + (alpha / rank) * (a @ b)`` in fp32, cast back to kernel's dtype."""
    a = np.ascontiguousarray(lora_a, np.float32)
    b = np.ascontiguousarray(lora_b, np.float32)
    scale = (16.0 if alpha is None else alpha) / a.shape[-1]
    kern = np.asarray(kernel)
    return (np.asarray(kern, np.float32) + scale * (a @ b)).astype(kern.dtype)


def merge_llm_lora(params: Any, alpha: Optional[float] = None) -> Any:
    """Fold ``lora_a``/``lora_b`` into their nested ``base/kernel`` (JAX tree
    layout); the adapters are dropped. ``alpha`` defaults to 16."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        node = dict(node)
        if ("lora_a" in node and "lora_b" in node and "base" in node
                and isinstance(node["base"], dict)
                and "kernel" in node["base"]):
            a, b = node.pop("lora_a"), node.pop("lora_b")
            base = dict(node["base"])
            base["kernel"] = _merge(base["kernel"], a, b, alpha)
            node["base"] = base
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def _quantize(kernel, bits: int) -> Dict[str, np.ndarray]:
    q, s = quantize_kernel_int4(kernel) if bits == 4 else quantize_kernel(kernel)
    return {"kernel_q": q, "kernel_scale": s}


def quantize_llm_params(params: Any, bits: int = 8) -> Any:
    """LoRA-free LLM tree (JAX layout) -> quantized layout: every
    ``.../base/kernel`` and ``lm_head/kernel`` becomes ``{kernel_q,
    kernel_scale}`` (int8 ``bits=8``, packed int4 ``bits=4``); all else passes
    through."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        if "kernel" in node and name in ("base", "lm_head"):
            out = {k: v for k, v in node.items() if k != "kernel"}
            out.update(_quantize(node["kernel"], bits))
            return out
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params)


@torch.no_grad()
def quantize_agent(agent, alpha: Optional[float] = None, bits: int = 8):
    """``ContinuousLVLM`` -> the same agent with a quantized, LoRA-free LLM
    (``bits=8`` int8 per channel, ``bits=4`` group-wise int4), on the same
    device and in the same dtype. The resamplers are shared, not copied."""
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM, LoRADense

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    src = agent.llm
    if src.quantized:
        raise ValueError("the agent's LLM is already quantized")
    host = lambda t: t.detach().float().cpu().numpy()
    # projection weights by the name of their base (``...q_proj.base``, ``lm_head``)
    dense = {f"{name}.base": mod for name, mod in src.named_modules()
             if isinstance(mod, LoRADense)}
    dense["lm_head"] = src.lm_head
    state = {}
    for key, value in src.state_dict().items():
        owner = key.rsplit(".", 1)[0]
        if owner not in dense and ".lora_" not in key:
            state[key] = value            # embeddings and norms pass through
    for name, mod in dense.items():
        lin = mod.base if isinstance(mod, LoRADense) else mod
        kern = host(lin.weight).T
        if isinstance(mod, LoRADense) and mod.lora_rank:
            merged = _merge(kern, host(mod.lora_A.weight).T, host(mod.lora_B.weight).T, alpha)
            # round to the weight's dtype, as the JAX tree's astype does
            kern = torch.from_numpy(merged).to(lin.weight.dtype).float().numpy()
        for key, value in _quantize(kern, bits).items():
            state[f"{name}.{key}"] = torch.from_numpy(value)
    device = src.lm_head.weight.device
    with torch.device("meta"):
        qllm = LlamaForCausalLM(src.config, quantized="int4" if bits == 4 else "int8",
                                dtype=src.dtype)
    qllm.to_empty(device=device).load_state_dict(state)
    qllm.eval().requires_grad_(False)
    return dataclasses.replace(agent, llm=qllm)
