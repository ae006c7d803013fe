"""Shared building blocks for the UNet and the VAE (port of
``diffsensei_tpu/models/layers.py``).

Activations are NHWC ``[B, H, W, C]`` at every public boundary, as in the JAX
package. Convolutions see them as ``channels_last`` NCHW views, which cost no
copy. Parameter names are the diffusers ones, so a diffusers or DiffSensei
state dict loads as it is.

Every layer computes in its input's dtype and casts its parameters to it at
use, as flax separates ``param_dtype`` from ``dtype``: training keeps the
trainable parameters in fp32 inside a bf16 stack, and their gradients reach
them in fp32. Where the dtypes already agree the cast is a no-op.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.ops.groupnorm import groupnorm_silu, groupnorm_silu_ref, kernel_plan


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Int8Linear(nn.Module):
    """Weight-only int8, per output channel (the JAX ``LoRADense`` with
    ``quantized=True``): ``y = (x @ Q) * s + b`` in x's dtype, with ``Q``
    int8 ``[in, out]`` (``kernel_q``), ``s`` fp32 ``[out]``
    (``kernel_scale``) and an optional bias. Serving only: nothing trains
    it, and the int8 values are exact in bf16."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, device=None):
        super().__init__()
        frozen = lambda shape, dt: nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                                requires_grad=False)
        self.kernel_q = frozen((in_features, out_features), torch.int8)
        self.kernel_scale = frozen((out_features,), torch.float32)
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel_q.to(x.dtype)) * self.kernel_scale.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def linear(in_features: int, out_features: int, bias: bool = True,
           quantized: bool = False, **kw) -> nn.Module:
    """A ``Linear``, or its ``Int8Linear`` serving form where ``quantized``."""
    return (Int8Linear if quantized else Linear)(in_features, out_features, bias=bias, **kw)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors (a ``channels_last`` view inside)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               _cast(self.bias, x.dtype))
        return y.permute(0, 2, 3, 1)


def Conv3x3(in_channels: int, out_channels: int, **kw) -> Conv2d:
    """3x3, padding 1. The JAX package's shifted-matmul formulation
    (``ops/conv3x3.py``) exists for the TPU MXU; here it is a plain conv."""
    return Conv2d(in_channels, out_channels, 3, padding=1, **kw)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` on NHWC tensors (plain PyTorch, no kernel)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), self.num_groups, _cast(self.weight, x.dtype),
                         _cast(self.bias, x.dtype), self.eps)
        return y.permute(0, 2, 3, 1)


class FusedGroupNormSiLU(nn.Module):
    """GroupNorm + SiLU through kernel B3 (``ops/groupnorm.py``); the
    parameter names are ``nn.GroupNorm``'s. Kernel and twin read the scale
    and shift in fp32 whatever their dtype, so they need no cast. A CUDA
    input the kernel has no plan for (``kernel_plan``: a dtype other than
    bf16 or fp32, a shape ``plan`` rejects) runs the twin, as the JAX entry
    does; the choice is made before any launch, and a malformed input (a
    misaligned x) still raises."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype=None, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        checked = None
        if x.device.type == "cuda":
            checked = kernel_plan(x, self.weight, self.bias, self.num_groups)
            if isinstance(checked, str):
                return groupnorm_silu_ref(x, self.weight, self.bias, self.num_groups, self.eps)
        return groupnorm_silu(x, self.weight, self.bias, self.num_groups, self.eps, checked)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal embedding (diffusers ``Timesteps``); ``[..., dim]`` fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting a sinusoidal embedding to the UNet width."""

    def __init__(self, in_dim: int, out_dim: int, dtype=None, device=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, out_dim, dtype=dtype, device=device)
        self.linear_2 = Linear(out_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-conv twice, with additive time conditioning.

    ``norm_eps``: 1e-5 in the UNet (diffusers' UNet default), 1e-6 in the VAE."""

    def __init__(self, in_channels: int, out_channels: int, norm_num_groups: int = 32,
                 temb_channels: Optional[int] = None, norm_eps: float = 1e-5,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = FusedGroupNormSiLU(norm_num_groups, in_channels, norm_eps, **kw)
        self.conv1 = Conv3x3(in_channels, out_channels, **kw)
        self.time_emb_proj = (Linear(temb_channels, out_channels, **kw)
                              if temb_channels is not None else None)
        self.norm2 = FusedGroupNormSiLU(norm_num_groups, out_channels, norm_eps, **kw)
        self.conv2 = Conv3x3(out_channels, out_channels, **kw)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype=None, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1,
                           dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest upsample to ``output_size`` (default 2x), then a 3x3 conv.

    Source indices are ``floor(dst * in / out)`` in integers, the rule of
    ``F.interpolate(mode="nearest")``, so odd skip sizes land exactly."""

    def __init__(self, channels: int, dtype=None, device=None):
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                output_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        oh, ow = output_size if output_size is not None else (2 * h, 2 * w)
        iy = torch.arange(oh, device=x.device) * h // oh
        ix = torch.arange(ow, device=x.device) * w // ow
        return self.conv(x[:, iy][:, :, ix])


class GEGLUFeedForward(nn.Module):
    """Transformer FFN with GEGLU gating (diffusers ``FeedForward`` names:
    ``net.0.proj``, ``net.2``).

    GELU policy of the JAX package (ROADMAP trap C2): the exact erf form in
    fp32, the tanh form in bf16. ``quantized`` serves both projections in
    int8 (``Int8Linear``)."""

    def __init__(self, dim: int, mult: int = 4, quantized: bool = False, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(quantized=quantized, dtype=dtype, device=device)
        inner = dim * mult
        geglu = nn.Module()
        geglu.proj = linear(dim, inner * 2, **kw)
        # net.1 is diffusers' dropout slot: no parameters, identity at inference
        self.net = nn.ModuleList([geglu, nn.Identity(), linear(inner, dim, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        approximate = "none" if gate.dtype == torch.float32 else "tanh"
        return self.net[2](h * F.gelu(gate, approximate=approximate))
