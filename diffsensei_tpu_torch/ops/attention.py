"""Attention dispatcher (port of ``diffsensei_tpu/ops/attention.py``).

Long spatial self-attention goes to the flash kernel B1; everything else
(77 text tokens, 80 IP tokens, 257 image patches, perceiver latents) is the
plain einsum-softmax-einsum that XLA ran on the TPU. The rule depends on the
inputs' device, shape and dtype only.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffsensei_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, attention_scores, flash_attention)

# Below this key length a blocked kernel has nothing to block.
FLASH_MIN_KV = 1024


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Unblocked attention over ``[B, H, S, D]``: fp32 scores and softmax, the
    probabilities cast to v's dtype for the second product."""
    s = attention_scores(q, k, bias, causal, sm_scale)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def uses_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True where the dispatcher sends the call to kernel B1."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and k.shape[2] >= FLASH_MIN_KV
            and q.shape[-1] in HEAD_DIMS)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, causal: bool = False,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``[batch, heads, seq, head_dim]``; picks the path by shape."""
    if uses_flash(q, k):
        return flash_attention(q, k, v, None if bias is None else bias.float(),
                               causal=causal, sm_scale=sm_scale)[0]
    return attention_ref(q, k, v, bias, causal=causal, sm_scale=sm_scale)
