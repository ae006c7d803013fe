"""Weight-only int8 serving of the UNet's transformer matmuls (port of
``diffsensei_tpu/models/quant_unet.py``).

Every projection named in ``UNET_QUANT_TARGETS`` (the attention projections,
the IP pair among them, ``Transformer2D``'s ``proj_in``/``proj_out`` and the
GEGLU's two projections) goes from ``weight`` ``[out, in]`` to ``kernel_q``
int8 ``[in, out]`` plus ``kernel_scale`` fp32 ``[out]``, per output channel
and symmetric: the arithmetic of the LLaMA's ``quantize_kernel`` (the JAX
``quantize_unet_params``' numpy) done on the weight's own device, which gives
the same bytes (fp32 division and round-half-to-even are exact on the CPU and
the card alike). LoRA adapters are merged first; convolutions,
norms, biases and the time embeddings stay as they are. The int8 UNet is
``UNetMangaModel(..., quantized=True)`` (its ``Int8Linear`` layers compute
``(x @ q) * s`` in x's dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from diffsensei_tpu_torch.models.lora import merge_lora_state_dict
from diffsensei_tpu_torch.models.unet import UNetMangaModel

# the JAX targets under the port's module names: its ``proj_in``/``proj_out``
# name both Transformer2D's and the GEGLU's (diffusers' ``ff.net.0.proj``,
# ``ff.net.2``)
UNET_QUANT_TARGETS = frozenset({"to_q", "to_k", "to_v", "to_out.0", "to_k_ip", "to_v_ip",
                                "proj_in", "proj_out", "net.0.proj", "net.2"})


def _is_target(module_name: str) -> bool:
    return any(module_name == t or module_name.endswith("." + t) for t in UNET_QUANT_TARGETS)


def quantize_unet_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A UNet state dict -> the ``quantized=True`` layout: adapters merged,
    then every target's 2-D ``weight`` quantized on its own device, one weight
    at a time."""
    out = {}
    for name, t in merge_lora_state_dict(sd).items():
        module = name.rsplit(".", 1)[0]
        if name.endswith(".weight") and t.dim() == 2 and _is_target(module):
            q, s = quantize_rows(t)
            out[f"{module}.kernel_q"], out[f"{module}.kernel_scale"] = q, s
        else:
            out[name] = t
    return out


@torch.no_grad()
def quantize_rows(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_kernel(weight.T)`` on ``weight``'s device: a ``[out, in]``
    weight -> (``kernel_q`` int8 ``[in, out]``, ``kernel_scale`` fp32
    ``[out]``), symmetric per output channel, ``scale = max|w| / 127`` (1
    where the row is 0)."""
    w = weight.detach().float()
    absmax = w.abs().amax(dim=1)
    # a 0-dim tensor, not a Python number: CUDA's division by a host scalar
    # multiplies by its reciprocal, which can differ from numpy in the last bit
    scale = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0),
                        torch.ones_like(absmax))
    q = torch.round(w / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q.T.contiguous(), scale


def _rebuilt(unet: UNetMangaModel, sd: Dict[str, torch.Tensor],
             quantized: bool) -> UNetMangaModel:
    """A rank-0 copy of ``unet`` (its dtype, device, conv weight layout,
    compute dtype) holding ``sd``, for serving."""
    w = unet.conv_in.weight
    new = UNetMangaModel(dataclasses.replace(unet.config, lora_rank=0), w.dtype,
                         device="meta", quantized=quantized)
    new.to_empty(device=w.device)
    if not w.is_contiguous():
        new.to(memory_format=torch.channels_last)
    new.load_state_dict(sd)
    new.compute_dtype = unet.compute_dtype
    return new.eval().requires_grad_(False)


@torch.no_grad()
def merge_lora(unet: UNetMangaModel) -> UNetMangaModel:
    """A rank-0 copy of ``unet`` with its adapters folded into the base
    weights (``merge_lora_params``); ``unet`` is left as it is."""
    return _rebuilt(unet, merge_lora_state_dict(unet.state_dict()), quantized=False)


@torch.no_grad()
def quantize_unet(unet: UNetMangaModel) -> UNetMangaModel:
    """The int8 serving copy of ``unet`` (``quantize_unet_params``); ``unet``
    is left as it is."""
    return _rebuilt(unet, quantize_unet_state_dict(unet.state_dict()), quantized=True)


def tree_bytes(module: nn.Module) -> Tuple[int, int]:
    """``(total bytes, int8 bytes)`` of a module's state dict, for memory
    budgets (``tree_bytes``)."""
    total = q = 0
    for t in module.state_dict().values():
        b = t.numel() * t.element_size()
        total += b
        q += b if t.dtype == torch.int8 else 0
    return total, q
