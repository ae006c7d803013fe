"""Flash attention: forward kernel B1 and backward kernels B2 (dQ) and B4
(dK/dV), CUDA C++ in ``csrc/flash_attention.cu``.

Port of the Pallas TPU forward ``_fwd_kernel`` / ``_fwd_kernel_bias``
(``diffsensei_tpu/ops/flash_attention.py:59,124``, entry ``flash_attention:480``)
and backward ``_dq_kernel`` / ``_dkv_kernel`` and their ``_bias`` variants
(``:196,252,258,322``, called from ``_backward:328``). The forward returns
``(o, lse)``: the attention output in q's dtype and the fp32 row log-sum-exp
``[B, H, Sq]``. When an input requires a gradient it runs through the
dispatcher op ``diffsensei::flash_fwd`` (the JAX split at
``flash_attention.py:480-518``: the forward kernel's pair, then an autograd
rule), which saves ``(q, k, v, bias, o, lse)`` as the JAX ``_attach_fwd``
does and whose backward recomputes the probabilities from the lse; the bias
gets no gradient. A selective checkpoint (the remat policies of
``models/unet.py`` and ``models/mllm/llama.py``) can keep the op's outputs,
as the JAX ``attn_out`` / ``attn_lse`` tags let ``save_only_these_names``
keep them; it cannot see inside a ``torch.autograd.Function``.

On the card the UNet's spatial self-attention (S = 1024..4096, head_dim 64)
is bound by tensor-core operations and, at head_dim 64, by the exponentials;
the kernels keep every score and probability on chip and read each operand
once per tile. For head_dim 64 all three are built for Hopper: a TMA producer
warp streams tiles through mbarriers to consumer warpgroups that run wgmma,
with P and dS repacked in registers as the A operand of the next product; the
forward computes the next tile's softmax while this tile's P V runs, so the
exponentials overlap the tensor cores. B2 and B4 stay two
passes (7 products against a fused pass's 5) so that each block owns its
output rows and two calls give the same bits; a deterministic fused pass and
fp8 are later work. See the source for the design.

``flash_attention`` (B1), ``flash_attention_bwd_dq`` (B2) and
``flash_attention_bwd_dkv`` (B4) run their kernels for CUDA tensors and the
plain PyTorch twins (``flash_attention_ref``, ``flash_attention_bwd_dq_ref``,
``flash_attention_bwd_dkv_ref``) for CPU tensors; any other device, or a CUDA
input the kernels do not take, raises. ``flash_attention_bwd`` runs B2 then B4.
``launches``, ``bwd_dq_launches`` and ``bwd_dkv_launches`` count kernel
launches. Inputs the kernels cannot read by TMA (a misaligned view) are
copied first (``_aligned``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from diffsensei_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# The head_dim-64 forward streams K/V tiles of 128 keys where there are more
# than FWD_WIDE_KEYS keys (fewer, wider steps) and of 64 below (3 blocks an
# SM, more blocks in flight): the faster of the two on an H100 at the UNet's
# 4096 and 1024 keys.
FWD_WIDE_KEYS = 2048

launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


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


def _probs_and_ds(q, k, v, bias, lse, delta, do, causal, scale):
    """P recomputed from the lse (exactly 0 where causal set -1e30) and
    dS = P o (dO V^T - delta), in fp32."""
    p = torch.exp(attention_scores(q, k, bias, causal, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: Optional[torch.Tensor], o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
                               sm_scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B2: ``(dq, delta)`` with ``delta = rowsum(dO o O)`` in
    fp32 ``[B, H, Sq]``; dS is cast to k's dtype before the product, as in
    ``_dq_kernel``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    delta = (do.float() * o.float()).sum(dim=-1)
    _, ds = _probs_and_ds(q, k, v, bias, lse, delta, do, causal, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: Optional[torch.Tensor], lse: torch.Tensor,
                                delta: torch.Tensor, do: torch.Tensor, causal: bool = False,
                                sm_scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B4: ``(dk, dv)``, both products in fp32 as in
    ``_dkv_kernel``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    p, ds = _probs_and_ds(q, k, v, bias, lse, delta, do, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor], o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the backward, the math of the JAX ``_backward``:
    ``(dq, dk, dv)`` in the inputs' dtypes, the bias without gradient."""
    dq, delta = flash_attention_bwd_dq_ref(q, k, v, bias, o, lse, do, causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, bias, lse, delta, do, causal, sm_scale)
    return dq, dk, dv


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("flash_attention.cu")))
    strides = ctypes.POINTER(ctypes.c_longlong)
    for name, pointers, tail in (
            ("fwd", 6, [ctypes.c_int, ctypes.c_float, ctypes.c_int]),   # causal, scale, key tile
            ("bwd_dq", 9, [ctypes.c_int, ctypes.c_float]),
            ("bwd_dkv", 9, [ctypes.c_int, ctypes.c_float])):
        fn = getattr(lib, f"diffsensei_flash_attention_{name}")
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [strides] + tail
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.diffsensei_flash_attention_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.diffsensei_flash_attention_occupancy.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def occupancy() -> dict:
    """How the head_dim-64 kernels fill the card: for ``"fwd_64"`` and
    ``"fwd_128"`` (B1 over 64- or 128-key tiles), ``"dq"`` (B2) and ``"dkv"``
    (B4), the blocks that fit on one SM, a block's threads and dynamic shared
    memory bytes, and the rows it owns."""
    out = (ctypes.c_int * 16)()
    err = _library().diffsensei_flash_attention_occupancy(out)
    if err != 0:
        raise RuntimeError(f"flash_attention occupancy query failed: cudaError {err}")
    keys = ("blocks_per_sm", "threads", "smem_bytes", "rows_per_block")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(("fwd_64", "fwd_128", "dq", "dkv"))}


def _check_qkv(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be a 4-d bfloat16 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs a unit last stride, other "
                         f"strides divisible by 8 and 16-byte alignment, got "
                         f"strides {t.stride()}")


def _check_call(q, k, v, bias):
    """Validate the operands of a kernel call; return the bias strides."""
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
    if bias is None:
        return (0, 0, 0)
    if (bias.device != q.device or bias.dtype != torch.float32 or bias.dim() != 4
            or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)
            or tuple(bias.shape[2:]) != (sq, sk) or bias.stride(-1) != 1):
        raise ValueError(f"flash_attention: bias must be float32 "
                         f"[B|1, H|1, {sq}, {sk}] with unit last stride, got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    return (bias.stride(0) if bias.shape[0] == b else 0,
            bias.stride(1) if bias.shape[1] == h else 0,
            bias.stride(2))


def _heads_merged_like(t: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, H, S, D]`` tensor laid out ``[B, S, H, D]``, so that
    merging the heads afterwards is free."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype, device=t.device).transpose(1, 2)


def _flash_cuda(q, k, v, bias, causal, sm_scale):
    global launches
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = (_aligned(t) for t in (q, k, v))
    bias_strides = _check_call(q, k, v, bias)
    key_tile = 128 if sk > FWD_WIDE_KEYS else 64
    o = _heads_merged_like(q)
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
            float(sm_scale), key_tile, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return o, lse


def _check_stat(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, h, sq, _ = q.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()
            or t.device != q.device):
        raise ValueError(f"flash_attention_bwd: {name} must be contiguous float32 "
                         f"[{b}, {h}, {sq}] on {q.device}, got {t.dtype} {tuple(t.shape)}")


def _check_bwd_call(q, k, v, bias, lse, named):
    """Validate a backward kernel's operands (``named``: the tensors shaped
    like q); return the bias strides."""
    bias_strides = _check_call(q, k, v, bias)
    for name, t in named:
        _check_qkv(name, t, q.device)
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} shape {tuple(t.shape)} != "
                             f"q {tuple(q.shape)}")
    _check_stat("lse", lse, q)
    return bias_strides


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels can read it, else a contiguous copy in
    fresh (aligned) memory: an operand or an output gradient may come in any
    layout, at any offset."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _bwd_strides(q, k, v, o, do, dq, dk, dv, bias_strides, stat_pitch=0):
    return (ctypes.c_longlong * 28)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]), *bias_strides,
        stat_pitch)


def _stat_rows(lse: torch.Tensor, delta: torch.Tensor):
    """``(lse, delta, pitch)`` as the head_dim-64 dK/dV kernel reads them by
    TMA: 16-byte aligned, each (batch, head) row padded to a multiple of 4
    values (the padding is never read as a value)."""
    pad = -lse.shape[-1] % 4
    if pad:
        return (*(torch.nn.functional.pad(t, (0, pad)) for t in (lse, delta)),
                lse.shape[-1] + pad)
    lse, delta = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (lse, delta))
    return lse, delta, lse.shape[-1]


def _bwd_dq_cuda(q, k, v, bias, o, lse, do, causal, sm_scale):
    global bwd_dq_launches
    b, h, sq, d = q.shape
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    bias_strides = _check_bwd_call(q, k, v, bias, lse, (("o", o), ("do", do)))
    dq = _heads_merged_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # the dk/dv slots of the strides are unused by this kernel
    strides = _bwd_strides(q, k, v, o, do, dq, k, v, bias_strides)
    with torch.cuda.device(q.device):
        err = _library().diffsensei_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), None if bias is None else bias.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), b, h, sq, k.shape[2], d, strides, int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dQ kernel launch failed: cudaError {err}")
    bwd_dq_launches += 1
    return dq, delta


def _bwd_dkv_cuda(q, k, v, bias, lse, delta, do, causal, sm_scale):
    global bwd_dkv_launches
    b, h, sq, d = q.shape
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    bias_strides = _check_bwd_call(q, k, v, bias, lse, (("do", do),))
    _check_stat("delta", delta, q)
    lse, delta, pitch = _stat_rows(lse, delta) if d == 64 else (lse, delta, sq)
    dk, dv = _heads_merged_like(k), _heads_merged_like(v)
    # the o/dq slots of the strides are unused by this kernel
    strides = _bwd_strides(q, k, v, q, do, q, dk, dv, bias_strides, pitch)
    with torch.cuda.device(q.device):
        err = _library().diffsensei_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, k.shape[2], d, strides, int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention dK/dV kernel launch failed: cudaError {err}")
    bwd_dkv_launches += 1
    return dk, dv


def _device_rule(name: str, q: torch.Tensor) -> bool:
    """True for a CPU tensor (plain twin), False for CUDA (kernel); raises
    for any other device."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return False


def _check_operands(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless q, k and v are bf16 ``[B, H, S, 64]`` on
    one CUDA device with matching batch, heads and key counts: the only
    inputs the B7 and B8 kernels take."""
    b, h, _, d = q.shape
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(f"{name}: the kernel takes 4-d bfloat16 q, k, v on one "
                             f"device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if d != 64 or k.shape != v.shape or tuple(k.shape[:2]) != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: the kernel takes head_dim 64 and k, v [B, H, Sk, 64] "
                         f"matching q {tuple(q.shape)}, got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _launch_strides(q, k, v, o) -> ctypes.Array:
    """The 12 element strides, (b, h, s) of q, k, v and o, of a launch."""
    return (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))


def _forward(q, k, v, bias, causal, sm_scale):
    if _device_rule("flash_attention", q):
        return flash_attention_ref(q, k, v, bias, causal, sm_scale)
    return _flash_cuda(q, k, v, bias, causal, sm_scale)


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, *, causal: bool = False,
                           sm_scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, delta)``: kernel B2 on CUDA, its plain twin on the CPU."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _device_rule("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_ref(q, k, v, bias, o, lse, do, causal, sm_scale)
    return _bwd_dq_cuda(q, k, v, bias, o, lse, do, causal, sm_scale)


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor], lse: torch.Tensor,
                            delta: torch.Tensor, do: torch.Tensor, *, causal: bool = False,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from B2's ``delta``: kernel B4 on CUDA (on the stream B2
    ran on), its plain twin on the CPU."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _device_rule("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_dkv_ref(q, k, v, bias, lse, delta, do, causal, sm_scale)
    return _bwd_dkv_cuda(q, k, v, bias, lse, delta, do, causal, sm_scale)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of ``o = flash_attention(q, k, v, bias)[0]``
    for the output gradient ``do``, from the forward's ``o`` and ``lse``: B2
    then B4."""
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq, delta = flash_attention_bwd_dq(q, k, v, bias, o, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, lse, delta, do, **kw)
    return dq, dk, dv


@torch.library.custom_op("diffsensei::flash_fwd", mutates_args=(), device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
              causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's forward as a dispatcher op, ``(o, lse)``, for the calls that need
    a gradient: a selective checkpoint sees dispatcher ops only, so it can
    keep these outputs (the JAX ``attn_out`` / ``attn_lse`` tags) instead of
    replaying the kernel. The CPU implementation is the plain twin, its o
    copied into the heads-merged layout the kernel writes; the CUDA one is
    the kernel (``_flash_cuda``)."""
    o, lse = flash_attention_ref(q, k, v, bias, causal, sm_scale)
    return _heads_merged_like(q).copy_(o), lse


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, bias, causal, sm_scale):
    return _flash_cuda(q, k, v, bias, causal, sm_scale)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, bias, causal, sm_scale):
    b, h, sq, _ = q.shape
    return _heads_merged_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, bias, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, bias, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    """B2 then B4 (the plain twins on the CPU) from the residuals ``(q, k,
    v, bias, o, lse)``, as the JAX ``_attach_bwd``; lse takes no gradient,
    nor does the bias."""
    q, k, v, bias, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, bias, o, lse, do,
                                     causal=ctx.causal, sm_scale=ctx.sm_scale)
    return dq, dk, dv, None, None, None


flash_fwd.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, causal: bool = False,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over ``[B, H, S, D]``; returns ``(o, lse)``, differentiable
    in q, k and v through the op ``diffsensei::flash_fwd``. A call that needs
    no gradient (serving) launches B1 directly: the op's Python dispatch
    would add host time to each of R1's 1400 calls.

    ``bias`` may be ``[B|1, H|1, Sq, Sk]``; broadcast dims are read through a
    zero stride, never expanded. On CUDA the kernels take bfloat16 q/k/v with
    head_dim 64 or 128 and a float32 bias."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_fwd(q, k, v, bias, causal, float(sm_scale))
    return _forward(q, k, v, bias, causal, sm_scale)
