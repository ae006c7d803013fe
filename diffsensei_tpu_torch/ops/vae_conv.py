"""The VAE's fp32 3x3 convolutions: kernel B9 (CUDA C++, ``csrc/vae_conv.cu``).

Replaces no TPU kernel (the JAX package leaves the VAE's convolutions to
XLA). ``vae_conv3x3`` computes, over NHWC fp32 ``x [B, H, W, Cin]``,

    y = conv3x3(pre(x), weight, padding 1) + bias [+ residual]

in one of three modes: ``STRIDE1``, ``STRIDE2`` (the encoder's downsamplers)
and ``UPSAMPLE`` (a nearest 2x upsample of x first: the decoder's
upsamplers). ``pre`` is the identity, or GroupNorm+SiLU given as ``norm``, a
``FusedGroupNormSiLU`` (B3's module: ``weight``, ``bias``, ``num_groups``,
``eps``), whose result is zero-padded as a whole. The kernel keeps fp32
accuracy on the TF32 tensor cores by splitting each operand into two TF32
halves and taking three products (see the source); ``split_weight`` makes
the weights' halves once, in the kernel's layout.

:func:`plan` (plain Python, a function of the shape alone) says whether the
kernel takes a call, before any launch; :func:`takes` is its part that reads
the channels alone, by which ``models/vae.py`` builds each VAE convolution on
this entry or on plain ``layers`` modules. The entry launches the kernel for
a CUDA input the plan takes, raises for one it does not take, and runs the
plain twin ``vae_conv3x3_ref`` (GroupNorm+SiLU, upsample, conv, bias,
residual in fp32) for a CPU input. A meta input takes the card's route
without running it (the kernel's output shape, or the refusal), so that a
meta run shows what the card would launch. ``launches`` counts kernel
launches, ``fallbacks`` the VAE convolutions that ran the twin or, in a VAE
whose channels the kernel does not take, the plain modules. The kernel has
no backward: a kernel call with grad enabled on an input that requires grad
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from diffsensei_tpu_torch.ops import _build
from diffsensei_tpu_torch.ops.groupnorm import groupnorm_silu_ref

STRIDE1, STRIDE2, UPSAMPLE = 0, 1, 2
MODE_NAMES = ("stride1", "stride2", "upsample")
TILE_W, TILE_H = 32, 4   # output pixels a block (csrc: TW, TH)
BLOCK_N = 128            # output channels a block (csrc: BN)
CHUNK = 32               # input channels a k-chunk (csrc: KC)
MAX_GN_CHANNELS = 512    # csrc: MAX_GN_C
SMS = 132                # the H100 SXM's SMs: the statistics' grid
# B's k position p of every 16 input channels holds channel K_ORDER[p], so that
# a 16-byte load of channels 4t..4t+3 gives thread t its fragments of two
# TF32 k-steps (csrc: "K_ORDER")
K_ORDER = tuple(4 * (p % 4) + 2 * (p // 8) + (p % 8) // 4 for p in range(16))

launches = 0
fallbacks = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers one call."""

    mode: int
    out_shape: Tuple[int, int, int, int]
    stats_slabs: int         # slabs a sample of the GroupNorm statistics; 0 without


def out_hw(h: int, w: int, mode: int) -> Tuple[int, int]:
    """The output's spatial size (padding 1; stride 2 takes even sizes)."""
    if mode == STRIDE2:
        return (h + 1) // 2, (w + 1) // 2
    if mode == UPSAMPLE:
        return 2 * h, 2 * w
    return h, w


def takes(cin: int, cout: int, mode: int, groups: Optional[int] = None) -> bool:
    """Whether the kernel takes ``cin`` -> ``cout`` channels in ``mode`` with
    GroupNorm+SiLU of ``groups`` groups first (or none), at some shape."""
    return _channel_refusal(int(cin), int(cout), int(mode), groups) is None


def _channel_refusal(cin: int, cout: int, mode: int, groups: Optional[int]) -> Optional[str]:
    if mode not in (STRIDE1, STRIDE2, UPSAMPLE):
        return f"vae_conv: mode {mode}"
    if cin % CHUNK or cout % BLOCK_N:
        return f"vae_conv: {cin} -> {cout} channels (needs multiples of {CHUNK} -> {BLOCK_N})"
    if groups is not None and (mode != STRIDE1 or cin > MAX_GN_CHANNELS or cin % groups
                               or (cin // groups) % 4):
        return (f"vae_conv: no GroupNorm prologue for {cin} channels in {groups} groups "
                f"({MODE_NAMES[mode]})")
    return None


def plan(shape: Tuple[int, int, int, int], dtype: torch.dtype, cout: int, mode: int,
         groups: Optional[int] = None) -> Union[Plan, str]:
    """The kernel's plan for NHWC ``shape`` of ``dtype`` to ``cout`` channels
    in ``mode``, with GroupNorm+SiLU of ``groups`` groups first (or none), or
    why the kernel does not take the call."""
    return _plan(tuple(int(s) for s in shape), dtype, int(cout), int(mode), groups)


@functools.lru_cache(maxsize=None)
def _plan(shape, dtype, cout, mode, groups):
    if dtype != torch.float32:
        return f"vae_conv: no kernel for {dtype}"
    if len(shape) != 4 or min(shape) < 1:
        return f"vae_conv: shape {shape}"
    b, h, w, cin = shape
    why = _channel_refusal(cin, cout, mode, groups)
    if why is not None:
        return why
    if mode == STRIDE2 and (h % 2 or w % 2):
        return f"vae_conv: stride 2 needs an even height and width, got {h} x {w}"
    ho, wo = out_hw(h, w, mode)
    blocks = b * -(-ho // TILE_H) * -(-wo // TILE_W) * (cout // BLOCK_N)
    if blocks >= 2 ** 31:
        return f"vae_conv: {blocks} blocks"
    slabs = 0 if groups is None else max(1, min(h * w, -(-4 * SMS // b)))
    return Plan(mode, (b, ho, wo, cout), slabs)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: ``cvt.rna.tf32.f32``, the kernel's rounding of its activations."""
    bits = x.float().contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & torch.iinfo(torch.int32).min)).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, both TF32 values, ``hi = tf32(x)``, ``lo = tf32(x - hi)``:
    ``hi + lo`` holds x to about 2^-22 of its size."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def weight_layout(weight: torch.Tensor) -> torch.Tensor:
    """``[Cout, Cin, 3, 3]`` -> ``[Cout, 9 Cin]`` fp32: k = tap * Cin + c, taps
    row-major, channels in ``K_ORDER`` inside every 16."""
    cout, cin = weight.shape[:2]
    w = weight.detach().float().permute(0, 2, 3, 1).reshape(cout, 9, cin // 16, 16)
    return w[..., list(K_ORDER)].reshape(cout, 9 * cin).contiguous()


def split_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's ``(W_hi, W_lo)``, each ``[Cout, 9 Cin]`` fp32."""
    return split_tf32(weight_layout(weight))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x, as ``layers.Upsample2D`` indexes it."""
    _, h, w, _ = x.shape
    iy = torch.arange(2 * h, device=x.device) * h // (2 * h)
    ix = torch.arange(2 * w, device=x.device) * w // (2 * w)
    return x[:, iy][:, :, ix]


def _conv_tail(h: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], mode: int,
               residual: Optional[torch.Tensor]) -> torch.Tensor:
    """Upsample, conv (padding 1) and bias, residual: the part after pre."""
    if mode == UPSAMPLE:
        h = upsample2x(h)
    y = F.conv2d(h.permute(0, 3, 1, 2), weight.to(h.dtype),
                 None if bias is None else bias.to(h.dtype),
                 stride=2 if mode == STRIDE2 else 1, padding=1).permute(0, 2, 3, 1)
    return y if residual is None else residual + y


def vae_conv3x3_ref(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    mode: int = STRIDE1, norm=None,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: B3's twin (GroupNorm+SiLU in fp32) where ``norm`` is given,
    then the upsample, the conv with zero padding, the bias and the residual."""
    if norm is not None:
        x = groupnorm_silu_ref(x.contiguous(), norm.weight, norm.bias, norm.num_groups, norm.eps)
    return _conv_tail(x, weight, bias, mode, residual)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("vae_conv.cu")))
    lib.diffsensei_vae_conv.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    lib.diffsensei_vae_conv.restype = ctypes.c_int
    lib.diffsensei_vae_gn_stats.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.diffsensei_vae_gn_stats.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def _check(name: str, t: Optional[torch.Tensor], like: torch.Tensor, shape) -> None:
    if (t is None or t.device != like.device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"vae_conv: {name} must be a contiguous 16-byte aligned fp32 "
                         f"{tuple(shape)} tensor on {like.device}")


def _launch(x, split, bias, p: Plan, norm, residual) -> torch.Tensor:
    global launches
    b, h, w, cin = x.shape
    cout = p.out_shape[-1]
    inputs = [x, *split, bias, residual] + ([] if norm is None else [norm.weight, norm.bias])
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise ValueError("vae_conv: the kernel has no backward; call it under no_grad")
    _check("x", x, x, (b, h, w, cin))
    for name, t in zip(("w_hi", "w_lo"), split):
        _check(name, t, x, (cout, 9 * cin))
    _check("bias", bias, x, (cout,))
    if residual is not None:
        _check("residual", residual, x, p.out_shape)
    y = torch.empty(p.out_shape, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        gn = None
        if norm is not None:
            gamma, beta = norm.weight.float().contiguous(), norm.bias.float().contiguous()
            ws = torch.empty((b, p.stats_slabs, norm.num_groups, 2), dtype=torch.float64,
                             device=x.device)
            gn = torch.empty((b, 3, cin), dtype=torch.float32, device=x.device)
            err = lib.diffsensei_vae_gn_stats(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ws.data_ptr(), gn.data_ptr(),
                b, h * w, cin, norm.num_groups, float(norm.eps), p.stats_slabs, stream)
            if err != 0:
                raise RuntimeError(f"vae_conv statistics launch failed: cudaError {err}")
        err = lib.diffsensei_vae_conv(
            x.data_ptr(), split[0].data_ptr(), split[1].data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if gn is None else gn.data_ptr(), y.data_ptr(), b, h, w, cin, cout, p.mode,
            stream)
    if err != 0:
        raise RuntimeError(f"vae_conv kernel launch failed: cudaError {err}")
    launches += 1
    return y


def vae_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mode: int = STRIDE1,
                norm=None, residual: Optional[torch.Tensor] = None,
                split: Optional[Callable[[], Tuple[torch.Tensor, torch.Tensor]]] = None
                ) -> torch.Tensor:
    """``conv3x3(pre(x)) + bias [+ residual]`` over NHWC ``x`` (module
    docstring). ``split`` gives the weights' ``(W_hi, W_lo)`` (a module's
    cache); without it they are made for the call."""
    global fallbacks
    if x.device.type == "cpu":
        fallbacks += 1
        return vae_conv3x3_ref(x, weight, bias, mode, norm, residual)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"vae_conv: no kernel for device {x.device}")
    p = plan(tuple(x.shape), x.dtype, weight.shape[0], mode,
             None if norm is None else norm.num_groups)
    if isinstance(p, str):
        raise ValueError(p)
    if x.device.type == "meta":
        return x.new_empty(p.out_shape)
    halves = split() if split is not None else split_weight(weight)
    return _launch(x.contiguous(), halves, bias, p, norm,
                   None if residual is None else residual.contiguous())


def tally() -> Tuple[int, int]:
    """``(launches, fallbacks)`` so far, for ``span_counts``."""
    return launches, fallbacks


def span_counts(sp, before: Tuple[int, int]) -> None:
    """Put the VAE convolutions since ``before`` (a ``tally``) on the open
    span ``sp`` as ``kernel_convs`` and ``fallback_convs``; ``sp`` is None
    while no profiler records."""
    if sp is not None:
        sp.attrs.update(kernel_convs=launches - before[0], fallback_convs=fallbacks - before[1])
