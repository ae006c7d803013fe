"""The named remat policies (port of ``diffsensei_tpu/models/unet.py:339-356``
and ``diffsensei_tpu/models/mllm/llama.py:341-350``).

A policy chooses what a checkpointed block keeps for the backward; it never
changes a value. Each is a selective checkpoint
(``torch.utils.checkpoint.create_selective_checkpoint_contexts``) whose
policy sees every dispatcher op of the block's forward:

* ``dots`` (JAX ``dots_with_no_batch_dims_saveable``): the outputs of
  ``aten.mm`` and ``aten.addmm``, which ``F.linear`` reaches on 3-d input;
  the attention products carry batch dims (``aten.bmm``) and are replayed;
* ``attn`` (JAX ``save_only_these_names("attn_out", "attn_lse")``): the
  outputs of ``diffsensei::flash_fwd`` (B1's ``(o, lse)``) and the plain
  attention's output product, named ``attn_out`` by ``ops/attention.py``.
  Eager recompute removes no dead code, so the plain path's replay still
  computes its scores and softmax, and only the product is taken from the
  saved output; B5 is not named (nor is it in JAX) and is replayed;
* ``dots_attn``: both; ``dots_deepest``: ``dots`` at the UNet's deepest
  level, full recompute elsewhere.

``None`` is full recompute. An unknown name raises ``ValueError`` (the JAX
factory falls back to full recompute). Every policy's recompute runs inside
the ``train.remat_replay`` span (``utils/observability.py``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, create_selective_checkpoint_contexts, noop_context_fn)

from diffsensei_tpu_torch.ops.attention import current_name
from diffsensei_tpu_torch.utils.observability import span

POLICIES = ("dots", "attn", "dots_attn", "dots_deepest")

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default)
_NAMED_PRODUCTS = (_aten.bmm.default, _aten.mm.default)


def check_policy(policy: Optional[str], allowed=POLICIES) -> Optional[str]:
    """``policy`` itself where it is None or one of ``allowed``; raises
    ``ValueError`` for any other name."""
    if policy is not None and policy not in allowed:
        raise ValueError(f"unknown remat policy {policy!r}; expected None or one of "
                         f"{', '.join(allowed)}")
    return policy


def _saves_attn(func) -> bool:
    return (func is torch.ops.diffsensei.flash_fwd.default
            or (func in _NAMED_PRODUCTS and current_name() == "attn_out"))


def _policy(dots: bool, attn: bool):
    def policy(ctx, func, *args, **kwargs):
        if (dots and func in _DOTS) or (attn and _saves_attn(func)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


@contextlib.contextmanager
def _replaying(recompute):
    with span("train.remat_replay"), recompute:
        yield


def _spanned(contexts: Callable) -> Callable:
    """``contexts`` (a ``context_fn``) with its recompute side inside the
    ``train.remat_replay`` span."""
    def fn():
        forward, recompute = contexts()
        return forward, _replaying(recompute)
    return fn


FULL_RECOMPUTE = _spanned(noop_context_fn)


def context_fn(policy: Optional[str], deepest: bool = False) -> Callable:
    """The ``torch.utils.checkpoint.checkpoint(..., context_fn=)`` of
    ``policy`` for a block (``deepest``: it sits at the UNet's deepest
    level); full recompute is ``FULL_RECOMPUTE``, checkpoint's default
    ``noop_context_fn`` with the replay span."""
    dots = policy in ("dots", "dots_attn") or (policy == "dots_deepest" and deepest)
    attn = policy in ("attn", "dots_attn")
    if not (dots or attn):
        return FULL_RECOMPUTE
    return _spanned(functools.partial(create_selective_checkpoint_contexts,
                                      _policy(dots, attn)))
