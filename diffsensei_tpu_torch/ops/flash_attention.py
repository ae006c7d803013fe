"""Flash-attention forward: kernel B1 (CUDA C++, ``csrc/flash_attention.cu``).

Port of the Pallas TPU forward ``_fwd_kernel`` / ``_fwd_kernel_bias``
(``diffsensei_tpu/ops/flash_attention.py:59,124``, entry ``flash_attention:480``).
It returns ``(o, lse)``: the attention output in q's dtype and the fp32 row
log-sum-exp ``[B, H, Sq]``, which the ring attention and the backward of later
slices need.

On the card the UNet's spatial self-attention (S = 1024..4096, head_dim 64)
is compute bound; the kernel keeps every score and probability on chip and
reads Q, K and V once per q tile. See the source for the design.

``flash_attention`` runs the kernel for CUDA tensors and the plain PyTorch
twin ``flash_attention_ref`` for CPU tensors; any other device, or a CUDA
input the kernel does not take, raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from diffsensei_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

launches = 0


def attention_scores(q: torch.Tensor, k: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, causal: bool = False,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """fp32 scores ``scale * q k^T (+ bias)``, causal entries set to -1e30.

    The product is taken in fp32 on the working-dtype values, as the JAX
    ``einsum(..., preferred_element_type=float32)`` does."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: ``(o, lse)``."""
    s = attention_scores(q, k, bias, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    return torch.matmul(p, v), lse


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("flash_attention.cu")))
    fn = lib.diffsensei_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def _check_qkv(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be a 4-d bfloat16 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs a unit last stride, other "
                         f"strides divisible by 8 and 16-byte alignment, got "
                         f"strides {t.stride()}")


def _flash_cuda(q, k, v, bias, causal, sm_scale):
    global launches
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_qkv(name, t, q.device)
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise ValueError(f"flash_attention: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or sq < 1 or sk < 1 or b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)} "
                         f"with {sk} keys (head_dim must be one of {HEAD_DIMS})")
    bias_strides = (0, 0, 0)
    if bias is not None:
        if (bias.device != q.device or bias.dtype != torch.float32 or bias.dim() != 4
                or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)
                or tuple(bias.shape[2:]) != (sq, sk) or bias.stride(-1) != 1):
            raise ValueError(f"flash_attention: bias must be float32 "
                             f"[B|1, H|1, {sq}, {sk}] with unit last stride, got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        bias_strides = (bias.stride(0) if bias.shape[0] == b else 0,
                        bias.stride(1) if bias.shape[1] == h else 0,
                        bias.stride(2))
    # O is laid out [B, Sq, H, D] so that merging the heads afterwards is free
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3],
                                        *v.stride()[:3], *o.stride()[:3],
                                        *bias_strides)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.diffsensei_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, strides, int(causal),
            float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, causal: bool = False,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over ``[B, H, S, D]``; returns ``(o, lse)``.

    ``bias`` may be ``[B|1, H|1, Sq, Sk]``; broadcast dims are read through a
    zero stride, never expanded. On CUDA the kernel takes bfloat16 q/k/v with
    head_dim 64 or 128 and a float32 bias."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _flash_cuda(q, k, v, bias, causal, sm_scale)
