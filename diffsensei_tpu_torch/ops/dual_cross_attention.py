"""Dual cross-attention, kernel B5 (CUDA C++ in ``csrc/dual_cross_attention.cu``).

Port of the Pallas TPU kernel ``_kernel``
(``diffsensei_tpu/ops/dual_cross_attention.py:35``, entry
``dual_cross_attention:128``): one query set attends over the text keys (at
most 128, no bias) and over the IP keys (at most 128, plus the bbox bias
``[B|1, H|1, S, K_ip]``) in one pass, returning ``(o_text, o_ip)``; the
caller combines them as ``o_text + ip_scale * o_ip``. It is what every
``MangaCrossAttention`` of the UNet computes, and the port's UNet sends that
layer through it on the card (``uses_kernel``).

``dual_cross_attention`` runs the kernel for CUDA tensors and the plain twin
``dual_cross_attention_ref`` (two ``attention_ref`` calls) for CPU tensors;
any other device, or a CUDA input the kernel does not take, raises. With an
input that requires a gradient it runs through ``DualCrossAttentionFn``, whose
backward recomputes through the twin, as the JAX ``_dual_bwd`` does; the bias
gets no gradient. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from diffsensei_tpu_torch.ops import _build
from diffsensei_tpu_torch.ops.attention import attention_ref
from diffsensei_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, _check_qkv, _device_rule, _heads_merged_like)

MAX_KEYS = 128

launches = 0


def dual_cross_attention_ref(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                             ki: torch.Tensor, vi: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: the composite of the JAX ``_composite``."""
    return (attention_ref(q, kt, vt, sm_scale=sm_scale),
            attention_ref(q, ki, vi, bias=bias, sm_scale=sm_scale))


def uses_kernel(q: torch.Tensor, kt: torch.Tensor, ki: torch.Tensor) -> bool:
    """True where the UNet's cross-attention goes to kernel B5: bf16 on the
    card, both key sets at most 128 long, head_dim 64 or 128."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] in HEAD_DIMS
            and kt.shape[2] <= MAX_KEYS and ki.shape[2] <= MAX_KEYS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("dual_cross_attention.cu")))
    fn = lib.diffsensei_dual_cross_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.diffsensei_dual_cross_attention_occupancy
    occ.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def occupancy(b: int, h: int, sq: int, n_text: int, n_ip: int, d: int = 64) -> dict:
    """How a call of these sizes fills the card: the blocks that fit on one
    SM, a block's threads and dynamic shared memory bytes (sized to the padded
    key counts), the key tiles of scores it keeps in registers, the q tiles of
    64 rows a block, the blocks of the grid and the SMs."""
    out = (ctypes.c_int * 7)()
    err = _library().diffsensei_dual_cross_attention_occupancy(b, h, sq, n_text, n_ip, d, out)
    if err != 0:
        raise RuntimeError(f"dual_cross_attention occupancy query failed: cudaError {err}")
    keys = ("blocks_per_sm", "threads", "smem_bytes", "key_tiles", "tiles_per_block",
            "grid_blocks", "sms")
    return dict(zip(keys, out))


def _bias_strides(bias, q):
    b, h, sq, _ = q.shape
    if bias is None:
        return (0, 0, 0)
    if (bias.device != q.device or bias.dtype != torch.float32 or bias.dim() != 4
            or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)
            or bias.shape[2] != sq or bias.stride(-1) != 1):
        raise ValueError(f"dual_cross_attention: bias must be float32 [B|1, H|1, {sq}, K_ip] "
                         f"with unit last stride, got {bias.dtype} {tuple(bias.shape)}")
    return (bias.stride(0) if bias.shape[0] == b else 0,
            bias.stride(1) if bias.shape[1] == h else 0, bias.stride(2))


def _dual_cuda(q, kt, vt, ki, vi, bias, sm_scale):
    global launches
    b, h, sq, d = q.shape
    for name, t in (("q", q), ("kt", kt), ("vt", vt), ("ki", ki), ("vi", vi)):
        _check_qkv(name, t, q.device)
    nt, ni = kt.shape[2], ki.shape[2]
    if (tuple(vt.shape) != tuple(kt.shape) or tuple(kt.shape) != (b, h, nt, d)
            or tuple(vi.shape) != tuple(ki.shape) or tuple(ki.shape) != (b, h, ni, d)):
        raise ValueError(f"dual_cross_attention: key/value shapes {tuple(kt.shape)}, "
                         f"{tuple(vt.shape)}, {tuple(ki.shape)}, {tuple(vi.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or not (1 <= nt <= MAX_KEYS and 1 <= ni <= MAX_KEYS) \
            or sq < 1 or b > 65535 or h > 65535:
        raise ValueError(f"dual_cross_attention: unsupported q {tuple(q.shape)} with {nt} text "
                         f"and {ni} IP keys (head_dim one of {HEAD_DIMS}, 1..{MAX_KEYS} keys)")
    if bias is not None and bias.shape[3] != ni:
        raise ValueError(f"dual_cross_attention: bias has {bias.shape[3]} keys, not {ni}")
    bias_strides = _bias_strides(bias, q)
    ot, oi = _heads_merged_like(q), _heads_merged_like(q)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, kt, vt, ki, vi, ot, oi) for s in t.stride()[:3]), *bias_strides)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.diffsensei_dual_cross_attention(
            q.data_ptr(), kt.data_ptr(), vt.data_ptr(), ki.data_ptr(), vi.data_ptr(),
            None if bias is None else bias.data_ptr(), ot.data_ptr(), oi.data_ptr(),
            b, h, sq, nt, ni, d, strides, float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_cross_attention kernel launch failed: cudaError {err}")
    launches += 1
    return ot, oi


def _forward(q, kt, vt, ki, vi, bias, sm_scale):
    if _device_rule("dual_cross_attention", q):
        return dual_cross_attention_ref(q, kt, vt, ki, vi, bias, sm_scale)
    return _dual_cuda(q, kt, vt, ki, vi, bias, sm_scale)


class DualCrossAttentionFn(torch.autograd.Function):
    """``(o_text, o_ip)`` with B5 as the forward; the backward recomputes
    through the plain twin (the key sets are short, so recomputing costs
    little) for the inputs that need a gradient. The bias gets none."""

    @staticmethod
    def forward(ctx, q, kt, vt, ki, vi, bias, sm_scale):
        ctx.save_for_backward(q, kt, vt, ki, vi, bias)
        ctx.sm_scale = sm_scale
        return _forward(q, kt, vt, ki, vi, bias, sm_scale)

    @staticmethod
    def backward(ctx, g_text, g_ip):
        q, kt, vt, ki, vi, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip((q, kt, vt, ki, vi), needs)]
            outs = dual_cross_attention_ref(*inputs, bias, ctx.sm_scale)
            pairs = [(o, g) for o, g in zip(outs, (g_text, g_ip)) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs],
                                             [t for t in inputs if t.requires_grad],
                                             [g for _, g in pairs], allow_unused=True))
        return (*(next(grads) if n else None for n in needs), None, None)


def dual_cross_attention(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                         ki: torch.Tensor, vi: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o_text, o_ip)`` over ``[B, H, S, D]`` queries, text keys/values
    ``kt``/``vt`` and IP keys/values ``ki``/``vi`` (``[B, H, K, D]``, K <= 128
    each), the bias ``[B|1, H|1, S, K_ip]`` (or ``[B|1, S, K_ip]``) added to
    the IP scores only. On CUDA the kernel takes bfloat16 operands with
    head_dim 64 or 128 and a float32 bias."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if bias is not None and bias.dim() == 3:
        bias = bias[:, None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kt, vt, ki, vi)):
        return DualCrossAttentionFn.apply(q, kt, vt, ki, vi, bias, sm_scale)
    return _forward(q, kt, vt, ki, vi, bias, sm_scale)
