"""Packed-int4 weight-only matmul: kernel B6 (CUDA C++, ``csrc/int4_matmul.cu``).

Port of ``diffsensei_tpu/ops/int4_matmul.py`` (kernel ``_decode_kernel:125``,
entry ``int4_decode_matmul:166``), storage format byte for byte:

* ``packed`` uint8 ``[in, F/2]`` in the split-half layout: byte column ``j``
  holds output column ``j`` in its low nibble, stored biased as ``q + 8``, and
  output column ``F/2 + j`` in its high nibble, stored two's complement
  (ROADMAP trap C3: a symmetric signed unpack of both halves mis-decodes).
* ``scale`` fp32 ``[in/g, F]``, ``g = gcd(group, in)``; ``w[i, o] = q[i, o] *
  scale[i // g, o]``. ``F`` is padded (``padded_features``): to a multiple of
  256 where the kernel takes the geometry, else to an even count.

``int4_decode_matmul`` computes ``y[T, F] = bf16(x)[T, in] @ dequant(packed,
scale)`` in fp32 for ``T <= 16`` (the decode regime), x fp32 or bf16: the
kernel rounds an fp32 x to bf16 itself, as the JAX entry does. On the card it
is one launch, a stream of the packed bytes, 0.53 bytes a parameter with the
scales: every decode step of the SEED-X agent reads the whole LLM once this
way. CUDA tensors launch the kernel, CPU tensors take the plain twin
``int4_decode_fallback``; anything else raises. ``launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from diffsensei_tpu_torch.ops import _build

MAX_TOKENS = 16        # the decode regime the kernel serves

launches = 0


def group_size(group: int, in_features: int) -> int:
    """Effective scale-group length: ``gcd(group, in)`` so any width works."""
    return math.gcd(group, in_features)


def kernel_eligible(in_features: int, group: int) -> bool:
    """True when the decode kernel takes this geometry (g = 128)."""
    return in_features % 128 == 0 and group_size(group, in_features) == 128


def padded_features(features: int, in_features: int, group: int) -> int:
    """Stored (padded) output-feature count: a multiple of 256 for
    kernel-eligible layers (``lm_head``'s 32330 -> 32512), else even."""
    mult = 256 if kernel_eligible(in_features, group) else 2
    return -(-features // mult) * mult


def pack_int4_host(q: np.ndarray) -> np.ndarray:
    """[in, F] int nibbles in [-8, 7] -> packed uint8 [in, F//2] (numpy).

    Low nibble biased (``q + 8``), high nibble two's complement."""
    q = np.asarray(q, np.int32)
    assert q.shape[-1] % 2 == 0, q.shape
    half = q.shape[-1] // 2
    lo, hi = q[..., :half] + 8, q[..., half:]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [in, F//2] -> int32 nibble values [in, F]."""
    b = packed.to(torch.int32)
    lo = (b & 0xF) - 8                    # biased storage
    hi = ((b >> 4) ^ 8) - 8               # two's complement storage
    return torch.cat([lo, hi], dim=-1)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``pack_int4_host`` on a tensor, on its device: [in, F] nibbles in
    [-8, 7] -> packed uint8 [in, F//2]."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4: an odd feature count {q.shape[-1]}")
    q = q.to(torch.int32)
    half = q.shape[-1] // 2
    return ((q[..., :half] + 8) & 0xF | (q[..., half:] & 0xF) << 4).to(torch.uint8)


def shard_int4_columns(packed: torch.Tensor, scale: torch.Tensor, start: int, stop: int,
                       group: int = 128) -> tuple:
    """Output columns ``[start, stop)`` of a packed layer as a layer of
    their own: ``(packed [in, F_s'/2], scale [in/g, F_s'])`` with ``F_s' =
    padded_features(stop - start, in, group)``, on the tensors' device.

    In the split-half layout byte column ``j`` holds outputs ``j`` and
    ``F'/2 + j``, so a run of outputs is not a run of bytes: the cut
    unpacks, slices, pads (nibbles 0, scales 1, as ``quantize_kernel_int4``
    pads) and repacks. The result is the bytes of quantizing those columns
    of the float weight alone."""
    in_f = packed.shape[0]
    width = stop - start
    padded = padded_features(width, in_f, group)
    q = unpack_int4(packed)[:, start:stop]
    s = scale[:, start:stop]
    if padded != width:
        q = torch.cat([q, q.new_zeros((in_f, padded - width))], dim=1)
        s = torch.cat([s, s.new_ones((s.shape[0], padded - width))], dim=1)
    return pack_int4(q), s.contiguous()


def shard_int4_rows(packed: torch.Tensor, scale: torch.Tensor, start: int,
                    stop: int) -> tuple:
    """Input rows ``[start, stop)`` of a packed layer: a slice of the packed
    rows and of the scale's group rows. The cut must fall on a group
    boundary (a scale covers ``g`` consecutive rows), else ValueError."""
    in_f = packed.shape[0]
    g = in_f // scale.shape[0]
    if start % g or stop % g:
        raise ValueError(f"rows [{start}, {stop}) of an int4 layer of {in_f} inputs cut a "
                         f"scale group of {g}")
    return packed[start:stop].contiguous(), scale[start // g:stop // g].contiguous()


def dequantize(packed: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full dequant -> [in, F] in ``dtype`` (the prefill path), in fp32 first."""
    in_f, f = packed.shape[0], packed.shape[1] * 2
    gn = scale.shape[0]
    q = unpack_int4(packed).reshape(gn, in_f // gn, f).float()
    return (q * scale.float()[:, None, :]).reshape(in_f, f).to(dtype)


def int4_decode_fallback(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: ``y = sum_g s[g] * (x_g @ Q_g)`` in x's
    dtype, the scale kept outside every product."""
    in_f, f = packed.shape[0], packed.shape[1] * 2
    gn = scale.shape[0]
    g = in_f // gn
    dtype = x.dtype
    q = unpack_int4(packed).reshape(gn, g, f).to(dtype)
    xg = x.reshape(x.shape[:-1] + (gn, g))
    part = torch.einsum("...gi,gio->...go", xg, q)
    return torch.sum(part * scale.to(dtype), dim=-2)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("int4_matmul.cu")))
    fn = lib.diffsensei_int4_decode_matmul
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.diffsensei_int4_layout.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.diffsensei_int4_layout.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def layout(tokens: int, x_dtype: torch.dtype, out2: int, cluster: int = 0) -> dict:
    """How the kernel serving ``tokens`` rows of ``x_dtype`` fills the card at
    ``out2`` packed byte columns with ``cluster`` blocks a cluster (0: the
    kernel's pick): blocks that fit on one SM, clusters resident at once, a
    cluster's strip of byte columns, a block's threads and shared memory
    bytes, the grid's blocks and the cluster."""
    out = (ctypes.c_int * 7)()
    err = _library().diffsensei_int4_layout(tokens, int(x_dtype == torch.float32), out2,
                                            cluster, out)
    if err != 0:
        raise RuntimeError(f"int4_decode_matmul layout query failed: cudaError {err}")
    keys = ("blocks_per_sm", "clusters_resident", "strip_bytes", "threads", "smem_bytes",
            "blocks", "cluster")
    return dict(zip(keys, out))


def _decode_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 cluster: int = 0) -> torch.Tensor:
    """One launch of B6; ``cluster`` 0 lets the kernel pick its blocks a
    cluster, any other (1..16) forces it, for measuring."""
    global launches
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"int4_decode_matmul: x must be a contiguous 2-d float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    tokens, in_f = x.shape
    if not 1 <= tokens <= MAX_TOKENS:
        raise ValueError(f"int4_decode_matmul: {tokens} tokens, the kernel takes "
                         f"1..{MAX_TOKENS}")
    if (packed.device != dev or packed.dtype != torch.uint8 or packed.dim() != 2
            or packed.shape[0] != in_f or not packed.is_contiguous()):
        raise ValueError(f"int4_decode_matmul: packed must be contiguous uint8 "
                         f"[{in_f}, F/2] on {dev}, got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    out2 = packed.shape[1]
    if (scale.device != dev or scale.dtype != torch.float32
            or tuple(scale.shape) != (in_f // 128, 2 * out2)
            or not scale.is_contiguous()):
        raise ValueError(f"int4_decode_matmul: scale must be contiguous float32 "
                         f"[{in_f // 128}, {2 * out2}] on {dev}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if in_f % 128 or out2 % 128 or in_f == 0 or out2 == 0:
        raise ValueError(f"int4_decode_matmul: in={in_f} must be a multiple of 128 "
                         f"and F={2 * out2} of 256")
    if x.data_ptr() % 16 or packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("int4_decode_matmul: x, packed and scale need 16-byte alignment")
    y = torch.empty((tokens, 2 * out2), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.diffsensei_int4_decode_matmul(
            x.data_ptr(), int(x.dtype == torch.float32), packed.data_ptr(),
            scale.data_ptr(), y.data_ptr(), tokens, in_f, out2, cluster, stream)
    if err != 0:
        raise RuntimeError(f"int4_decode_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return y


def int4_decode_matmul(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """``y[T, F] = x[T, in] @ dequant(packed, scale)`` for ``T <= 16``.

    On CUDA: x float32 or bfloat16 ``[T, in]`` (rounded to bf16 in the
    kernel), ``in % 128 == 0``, g = 128 (gate with :func:`kernel_eligible`),
    F a multiple of 256; fp32 out. On the CPU the plain twin, in x's dtype."""
    if x.device.type == "cpu":
        return int4_decode_fallback(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_decode_matmul: no kernel for device {x.device}")
    return _decode_cuda(x, packed, scale)
