"""Weight-only int8 / int4 quantization of the SEED-X LLM (port of
``diffsensei_tpu/models/mllm/quant.py``).

The tree functions are the JAX package's numpy host code, copied: they take
and return nested dicts in the JAX layout (``.../base/kernel``, ``lm_head``)
and give the same bytes. ``quantize_llm_state`` does the same arithmetic on
the port's LLM state dict: LoRA merged into each projection, then every
projection and ``lm_head`` quantized; embeddings and norms stay as they are.
``quantize_agent`` applies it to an agent on its device;
``quantize_agent_on_host`` to a checkpoint on the host, for an agent built on
the meta device, so that only the quantized LLM reaches the card (under
tensor parallelism only this rank's shards of it).

* int8: per output channel, symmetric, ``scale = max|w[:, j]| / 127``.
* int4: group-wise symmetric (``g = gcd(128, in)``), range +-7, output
  columns zero-padded to ``padded_features`` (pad scales 1), nibbles packed in
  the split-half layout of ``ops/int4_matmul.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

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


def _merge(kernel, lora_a, lora_b) -> np.ndarray:
    """``kernel + (16 / rank) * (a @ b)`` in fp32 (16: the LLM's LoRA alpha),
    cast back to kernel's dtype."""
    a = np.ascontiguousarray(lora_a, np.float32)
    b = np.ascontiguousarray(lora_b, np.float32)
    scale = 16.0 / a.shape[-1]
    kern = np.asarray(kernel)
    return (np.asarray(kern, np.float32) + scale * (a @ b)).astype(kern.dtype)


def merge_llm_lora(params: Any) -> Any:
    """Fold ``lora_a``/``lora_b`` into their nested ``base/kernel`` (JAX tree
    layout); the adapters are dropped."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        node = dict(node)
        if ("lora_a" in node and "lora_b" in node and "base" in node
                and isinstance(node["base"], dict)
                and "kernel" in node["base"]):
            a, b = node.pop("lora_a"), node.pop("lora_b")
            base = dict(node["base"])
            base["kernel"] = _merge(base["kernel"], a, b)
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


def quantize_llm_state(state: Mapping[str, torch.Tensor],
                       bits: int = 8) -> Dict[str, torch.Tensor]:
    """A float LLM's state dict (the port's names, adapters included, any
    device) -> the state dict of the quantized, LoRA-free LLM on the host:
    each projection's adapters merged in fp32 and rounded to its weight's
    dtype, then ``.base.weight`` / ``lm_head.weight`` quantized to
    ``.kernel_q`` / ``.kernel_scale``; embeddings and norms pass through."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    host = lambda t: t.detach().float().cpu().numpy()
    out = {}
    for key, value in state.items():
        if ".lora_" in key:
            continue
        if not (key.endswith(".base.weight") or key == "lm_head.weight"):
            out[key] = value
            continue
        owner = key.removesuffix(".weight")
        kern = host(value).T
        adapter = owner.removesuffix(".base")
        if f"{adapter}.lora_A.weight" in state and owner != "lm_head":
            merged = _merge(kern, host(state[f"{adapter}.lora_A.weight"]).T,
                            host(state[f"{adapter}.lora_B.weight"]).T)
            # round to the weight's dtype, as the JAX tree's astype does
            kern = torch.from_numpy(merged).to(value.dtype).float().numpy()
        for name, q in _quantize(kern, bits).items():
            out[f"{owner}.{name}"] = torch.from_numpy(q)
    return out


def _quantized_llm(config, bits: int, dtype, tp_group=None):
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM

    with torch.device("meta"):
        return LlamaForCausalLM(config, quantized="int4" if bits == 4 else "int8", dtype=dtype,
                                tp_group=tp_group)


@torch.no_grad()
def quantize_agent(agent, bits: int = 8):
    """``ContinuousLVLM`` -> the same agent with a quantized, LoRA-free LLM
    (``bits=8`` int8 per channel, ``bits=4`` group-wise int4), on the same
    device and in the same dtype. The resamplers are shared, not copied."""
    src = agent.llm
    if src.quantized:
        raise ValueError("the agent's LLM is already quantized")
    state = quantize_llm_state(src.state_dict(), bits)
    qllm = _quantized_llm(src.config, bits, src.dtype)
    qllm.to_empty(device=src.lm_head.weight.device).load_state_dict(state)
    qllm.eval().requires_grad_(False)
    return dataclasses.replace(agent, llm=qllm)


@torch.no_grad()
def quantize_agent_on_host(agent, entries: Mapping[str, Mapping[str, torch.Tensor]],
                           bits: int = 8, device="cuda", tp_group=None):
    """The serve CLI's ``--quantize-llm`` load: ``agent`` built on the meta
    device and its checkpoint's state dicts (``utils.load.agent_entries``,
    host tensors) -> the agent with the quantized LLM and both resamplers on
    ``device``. The float LLM is cast to the agent's dtype and quantized on
    the host, so it never reaches the card; the bytes are ``quantize_agent``'s
    for the same weights. With ``tp_group`` (the model axis) the host cuts
    this rank's shards (``parallel.tensor.shard_llama_state``) and only they
    reach the card. A checkpoint without a resampler group raises."""
    from diffsensei_tpu_torch.parallel.tensor import model_axis, shard_llama_state
    from diffsensei_tpu_torch.utils.load import assign

    for name in ("llm", "input_resampler", "output_resampler"):
        if name not in entries:
            raise ValueError(f"--quantize-llm: the agent checkpoint is missing the {name} group")
    llm = agent.llm
    state = quantize_llm_state({k: v.to(llm.dtype) for k, v in entries["llm"].items()}, bits)
    axis = model_axis(tp_group)
    if axis is not None:
        state = shard_llama_state(state, llm.config, axis.rank, axis.size)
    qllm = _quantized_llm(llm.config, bits, llm.dtype, tp_group)
    assign(qllm, state, device, "llm")
    for name in ("input_resampler", "output_resampler"):
        assign(getattr(agent, name), entries[name], device, name)
    return dataclasses.replace(agent, llm=qllm)
