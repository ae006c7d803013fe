"""Single-pass exact-softmax attention: kernel B8, CUDA C++ in
``csrc/single_pass_attention.cu``.

Port of the Pallas TPU experiment ``_single_kernel``
(``tools/bench_attention_single.py:28``, entry ``single_pass_attention:43``),
which tested one exact softmax over a q block's whole score row (no running
max) against B1's online softmax. No serving or training path calls it:
``tools/torch_bench_attention_single.py`` runs it beside B1.

``single_pass_attention`` clamps ``block_q`` to the queries, as the JAX
script's callers do, and raises ``ValueError`` where ``block_q`` does not
divide them: there the JAX grid (``sq // block_q``) leaves the last rows of o
unwritten. On CUDA tensors it launches the kernel, which holds a 64-row q
tile's whole score row in the registers of one thread-block cluster (each
block 512 keys, their K and V resident in its shared memory while the
cluster walks a group of q tiles): bf16 with head_dim 64 and at most
``MAX_KEYS`` keys (8 blocks of 512 keys); it raises on anything else. Its q
tile is 64 rows whatever ``block_q`` is. On CPU tensors it runs the plain
twin ``single_pass_attention_ref``, ``block_q`` rows at a time. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffsensei_tpu_torch.ops import _build
from diffsensei_tpu_torch.ops.flash_attention import (_aligned, _check_operands, _device_rule,
                                                      _launch_strides)

KEYS_PER_BLOCK = 512    # 64 rows x 512 keys of fp32 scores: 128 registers a thread of two warpgroups
MAX_CLUSTER = 8         # the portable cluster size
MAX_KEYS = KEYS_PER_BLOCK * MAX_CLUSTER

launches = 0


def effective_block_q(q: torch.Tensor, block_q: int = 512) -> int:
    """``min(block_q, Sq)``; raises ``ValueError`` where it does not divide
    Sq (the JAX grid would leave the last rows unwritten)."""
    sq = q.shape[2]
    block_q = min(block_q, sq)
    if sq % block_q:
        raise ValueError(f"single_pass_attention: block_q {block_q} does not divide {sq} "
                         f"queries: the JAX grid of {sq} // {block_q} blocks would leave the "
                         f"last {sq % block_q} rows unwritten")
    return block_q


def single_pass_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              block_q: int = 512) -> torch.Tensor:
    """Plain twin, a q block at a time as the TPU grid runs it: fp32 scores,
    ``m = rowmax s``, ``p = exp(s - m)``, ``l = sum p`` (fp32),
    ``o = (p cast to v's dtype) @ v / l``. It never holds more than one
    block's ``[B, H, block_q, Sk]`` scores."""
    block_q = effective_block_q(q, block_q)
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float().transpose(-1, -2), v.float()
    o = torch.empty_like(q)
    for i in range(0, q.shape[2], block_q):
        s = torch.matmul(q[:, :, i:i + block_q].float(), kf) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o[:, :, i:i + block_q] = (torch.matmul(p.to(v.dtype).float(), vf) / l).to(q.dtype)
    return o


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("single_pass_attention.cu")))
    fn = lib.diffsensei_single_pass_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def _single_cuda(q, k, v):
    global launches
    _check_operands("single_pass_attention", q, k, v)
    if not 1 <= k.shape[2] <= MAX_KEYS:
        raise ValueError(
            f"single_pass_attention: the kernel holds a 64-row q tile's whole fp32 score row "
            f"in one thread-block cluster's registers, {KEYS_PER_BLOCK} keys a block and "
            f"at most {MAX_CLUSTER} blocks: at most {MAX_KEYS} keys, got {k.shape[2]}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, h, sq, _ = q.shape
    with torch.cuda.device(q.device):
        err = _library().diffsensei_single_pass_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq, k.shape[2],
            _launch_strides(q, k, v, o), q.shape[-1] ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"single_pass_attention kernel launch failed: cudaError {err}")
    launches += 1
    return o


def single_pass_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_q: int = 512) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[B, H, S, D]`` with one exact
    softmax a row; output in q's dtype. Kernel B8 on CUDA, the plain twin on
    the CPU."""
    block_q = effective_block_q(q, block_q)
    if _device_rule("single_pass_attention", q):
        return single_pass_attention_ref(q, k, v, block_q)
    return _single_cuda(q, k, v)
