"""UNet LoRA: the low-rank adapters of the attention projections (port of
``diffsensei_tpu/models/lora.py``).

``LoRADense`` keeps ``nn.Linear``'s own ``weight`` and ``bias``, so a rank-0
and a rank-r UNet share every base name (``to_q.weight``,
``to_out.0.weight``) and rank-0 checkpoints load unchanged. At rank r > 0 the
adapters sit beside the base as ``lora_A.weight`` ``[r, in]`` and
``lora_B.weight`` ``[out, r]``, the names of the port's LLaMA adapters:
``y = x W^T + b + (x A^T) B^T``: the scale ``alpha / r`` is 1.0, the
reference's ``lora_alpha=lora_rank`` (``train.py:168-169``); the LLaMA's
adapters default to alpha 16 and are separate.

``merge_lora_state_dict`` folds the adapters into the base weights for rank-0
serving, in numpy fp32 as the JAX ``merge_lora_params`` does, and
``ensure_lora_init`` redraws dead (all-zero) adapters before training.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from diffsensei_tpu_torch.models.layers import Linear, linear


class LoRADense(Linear):
    """A projection with an optional rank-``lora_rank`` adapter; at rank 0 a
    plain ``Linear``. Computes in x's dtype, as every layer of the port."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lora_rank: int = 0, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype, device=device)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            kw = dict(bias=False, dtype=dtype, device=device)
            self.lora_A = Linear(in_features, lora_rank, **kw)
            self.lora_B = Linear(lora_rank, out_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_rank > 0:
            y = y + self.lora_B(self.lora_A(x))
        return y


def projection(in_features: int, out_features: int, bias: bool = True, lora_rank: int = 0,
               quantized: bool = False, **kw) -> nn.Module:
    """An attention projection: ``LoRADense``, or ``Int8Linear`` where
    ``quantized`` (int8 serving is rank 0: ``quant_unet.quantize_unet``
    merges the adapters first)."""
    if quantized:
        if lora_rank:
            raise ValueError("an int8 projection carries no adapter; merge LoRA first")
        return linear(in_features, out_features, bias=bias, quantized=True, **kw)
    return LoRADense(in_features, out_features, bias=bias, lora_rank=lora_rank, **kw)


def merge_lora_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every ``X.lora_A.weight`` / ``X.lora_B.weight`` pair into
    ``X.weight`` and drop the pair: a state dict a rank-0 model loads. The
    sum is numpy fp32 in the JAX layout (``kernel + a @ b``, a ``[in, r]``,
    b ``[r, out]``, the scale 1.0), cast back to the weight's dtype and device,
    so the bytes are those of the JAX ``merge_lora_params``."""
    out = dict(sd)
    for key in [k for k in sd if k.endswith(".lora_A.weight")]:
        base = key[: -len(".lora_A.weight")]
        a = np.ascontiguousarray(out.pop(key).float().cpu().numpy().T)
        b = np.ascontiguousarray(out.pop(f"{base}.lora_B.weight").float().cpu().numpy().T)
        w = out[f"{base}.weight"]
        kernel = np.ascontiguousarray(w.float().cpu().numpy().T)
        merged = kernel + a @ b
        out[f"{base}.weight"] = torch.from_numpy(np.ascontiguousarray(merged.T)).to(
            dtype=w.dtype, device=w.device)
    return out


@torch.no_grad()
def ensure_lora_init(root: nn.Module, seed: int = 0) -> int:
    """Give every adapter of ``root`` whose A is all zeros a live start:
    ``A ~ N(0, 1/r)``, ``B = 0`` (the reference ``init_lora_weights=
    "gaussian"``), drawn from numpy with ``seed`` in module order. A zero A
    with a zero B is dead: both factors' gradients vanish. Adapters already
    drawn (random init, restored checkpoints) stay. Returns how many were
    drawn."""
    rng = np.random.default_rng(seed)
    touched = 0
    for mod in root.modules():
        if isinstance(mod, LoRADense) and mod.lora_rank > 0 and not mod.lora_A.weight.any():
            a = mod.lora_A.weight
            a.copy_(torch.from_numpy(
                rng.normal(0.0, 1.0 / mod.lora_rank, (a.shape[1], a.shape[0])).T.copy()))
            mod.lora_B.weight.zero_()
            touched += 1
    return touched
