"""k-chunked online-softmax attention: kernel B7, CUDA C++ in
``csrc/chunked_attention.cu``.

Port of the Pallas TPU experiment ``_chunked_kernel``
(``tools/bench_attention_chunked.py:40``, entry ``chunked_attention:83``),
which tested B1's design with the online softmax updated once per sub-chunk
of ``chunk`` keys inside each ``block_k`` block. No serving or training path
calls it: ``tools/torch_bench_attention_chunked.py`` runs it beside B1.

``chunked_attention`` keeps the JAX signature, its clamps and its asserts
(``ValueError`` here): ``block_q`` and ``block_k`` only shape the TPU's grid,
so the result depends on ``chunk`` alone, the keys of one update. On CUDA
tensors it launches the kernel, which holds a 64-row q tile's fp32 scores
in one warpgroup's registers (a chunk of up to 256 keys, 128 a thread at
256; a chunk of 512 in two passes, its first half's scores computed twice)
and takes bf16 with head_dim 64 and a chunk of 64, 128, 256 or 512 keys
(``CHUNKS``; 1024 would take four passes) and raises on anything else; on
CPU tensors it runs the plain twin ``chunked_attention_ref``. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffsensei_tpu_torch.ops import _build
from diffsensei_tpu_torch.ops.flash_attention import (NEG_INF, _aligned, _check_operands,
                                                      _device_rule, _launch_strides)

CHUNKS = (64, 128, 256, 512)

launches = 0


def effective_chunk(q: torch.Tensor, k: torch.Tensor, block_q: int = 1024,
                    block_k: int = 2048, chunk: int = 512) -> int:
    """The keys of one online-softmax update after the JAX clamps; raises
    ``ValueError`` where the JAX function's asserts fail."""
    sq, kv = q.shape[2], k.shape[2]
    block_q, block_k = min(block_q, sq), min(block_k, kv)
    chunk = min(chunk, block_k)
    if sq % block_q or kv % block_k or block_k % chunk:
        raise ValueError(f"chunked_attention: block_q {block_q} must divide {sq} queries, "
                         f"block_k {block_k} {kv} keys and chunk {chunk} block_k")
    return chunk


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_q: int = 1024, block_k: int = 2048,
                          chunk: int = 512) -> torch.Tensor:
    """Plain twin: the TPU kernel's online softmax, one update a chunk of
    keys, in its order (fp32 scores, max from -1e30, the fp32 p summed into
    l, p cast to v's dtype for the product, ``acc / where(l == 0, 1, l)``)."""
    chunk = effective_chunk(q, k, block_q, block_k, chunk)
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(0, k.shape[2], chunk):
        s = torch.matmul(qf, k[:, :, j:j + chunk].float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), v[:, :, j:j + chunk].float())
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("chunked_attention.cu")))
    fn = lib.diffsensei_chunked_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def _chunked_cuda(q, k, v, chunk):
    global launches
    _check_operands("chunked_attention", q, k, v)
    if chunk not in CHUNKS:
        raise ValueError(f"chunked_attention: the kernel takes a chunk of {CHUNKS} keys "
                         f"(a warpgroup holds the fp32 scores of 256 keys, 128 registers "
                         f"a thread: a chunk of 512 takes two passes, its first half's "
                         f"Q K^T computed twice; 1024 would take four), got {chunk}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, h, sq, _ = q.shape
    with torch.cuda.device(q.device):
        err = _library().diffsensei_chunked_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq, k.shape[2],
            _launch_strides(q, k, v, o), chunk, q.shape[-1] ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunked_attention kernel launch failed: cudaError {err}")
    launches += 1
    return o


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_q: int = 1024, block_k: int = 2048,
                      chunk: int = 512) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[B, H, S, D]``, the online
    softmax updated once per ``chunk`` keys (after the JAX clamps); output in
    q's dtype. Kernel B7 on CUDA, the plain twin on the CPU."""
    if _device_rule("chunked_attention", q):
        return chunked_attention_ref(q, k, v, block_q, block_k, chunk)
    return _chunked_cuda(q, k, v, effective_chunk(q, k, block_q, block_k, chunk))
