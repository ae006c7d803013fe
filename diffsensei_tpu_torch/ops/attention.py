"""Attention dispatcher (port of ``diffsensei_tpu/ops/attention.py``).

Long spatial self-attention goes to the flash kernel B1, with B2 and B4 as
its backward (the op ``diffsensei::flash_fwd`` where a gradient is needed);
everything else (77 text tokens, 80 IP tokens, 257 image patches, perceiver
latents) is the plain einsum-softmax-einsum that XLA ran on the TPU. The rule
depends on the inputs' device, shape and dtype only.

``cp_group`` opts plain self-attention (no bias, not causal, as many queries
as keys, a sequence the group's size divides) into the ring of
``ops/ring_attention.py``, the sequence sharded over the group's ranks, as
the JAX dispatcher takes ``cp_mesh`` (``attention.py:67-72``).

The plain path's output product is tagged ``attn_out``, as the JAX
dispatcher tags it with ``checkpoint_name`` (``attention.py:79-84``): a
selective checkpoint's policy sees ops, not tensors, so ``checkpoint_name``
here sets a thread-local name that the policy reads while the ops inside
dispatch (``models/remat.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist

from diffsensei_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, attention_scores, flash_attention)
from diffsensei_tpu_torch.ops.ring_attention import ring_attention_sharded

# Below this key length a blocked kernel has nothing to block.
FLASH_MIN_KV = 1024

_names = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the ops dispatched inside the block (the counterpart of JAX's
    ``checkpoint_name`` for a dispatch-mode remat policy)."""
    outer = getattr(_names, "name", None)
    _names.name = name
    try:
        yield
    finally:
        _names.name = outer


def current_name() -> Optional[str]:
    """The innermost ``checkpoint_name`` around the op now dispatching."""
    return getattr(_names, "name", None)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Unblocked attention over ``[B, H, S, D]``: fp32 scores and softmax, the
    probabilities cast to v's dtype for the second product, whose output is
    named ``attn_out``."""
    s = attention_scores(q, k, bias, causal, sm_scale)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    with checkpoint_name("attn_out"):
        return torch.matmul(p, v)


def uses_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True where the dispatcher sends the call to kernel B1."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and k.shape[2] >= FLASH_MIN_KV
            and q.shape[-1] in HEAD_DIMS)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, causal: bool = False,
                         sm_scale: Optional[float] = None, cp_group=None) -> torch.Tensor:
    """Attention over ``[batch, heads, seq, head_dim]``; picks the path by
    shape. The flash and plain paths are differentiable in q, k and v; the
    ring (``cp_group``, a process group) is forward only."""
    kv_len = k.shape[2]
    if (cp_group is not None and bias is None and not causal and q.shape[2] == kv_len
            and kv_len % dist.get_world_size(cp_group) == 0):
        return ring_attention_sharded(q, k, v, cp_group, sm_scale)
    if uses_flash(q, k):
        return flash_attention(q, k, v, None if bias is None else bias.float(),
                               causal=causal, sm_scale=sm_scale)[0]
    return attention_ref(q, k, v, bias, causal=causal, sm_scale=sm_scale)
