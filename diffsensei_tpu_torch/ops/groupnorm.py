"""GroupNorm + SiLU: kernel B3 (Triton, ``csrc/groupnorm_silu.py``).

Port of ``diffsensei_tpu/ops/groupnorm.py`` (kernel ``_gn_silu_kernel:44``,
entry ``groupnorm_silu:120``). Every ``ResnetBlock2D`` of the UNet and the VAE
runs it twice. Unlike the JAX dispatcher, which defaults to XLA's path on the
TPU, the port runs the kernel for every CUDA tensor: the card's own numbers
(``PERF.md``) say whether it pays.

The work is bound by memory bandwidth. The kernel makes two passes over NHWC
memory (per-group chunk statistics, then normalize + affine + SiLU), so a
sample of any size fits; see the source for the design.

``groupnorm_silu`` runs the kernel for CUDA tensors and the plain twin
``groupnorm_silu_ref`` for CPU tensors; any other device, or a CUDA input the
kernel does not take, raises. ``launches`` counts wrapper calls that launched
the kernel passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffsensei_tpu_torch.ops import _build

TILE = 4096            # elements of x per program and loop step
MAX_CHUNKS = 1024      # chunk partials per (sample, group)

launches = 0


def groupnorm_silu_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain twin: GroupNorm (per sample, over H, W and C/G; mean first, then
    the variance about it) and SiLU, in fp32; output in x's dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    norm = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    out = norm * scale.float() + bias.float()
    return F.silu(out).to(x.dtype)


def _kernels():
    return _build.triton_module("groupnorm_silu.py")


def build() -> None:
    """Import Triton and the kernel source (compilation happens per
    specialization at the first launch)."""
    _kernels()


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _groupnorm_silu_cuda(x, scale, bias, num_groups, eps):
    global launches
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"groupnorm_silu: x must be a 4-d bfloat16 or float32 "
                         f"NHWC tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu: x must be contiguous NHWC")
    b, h, w, c = x.shape
    if c % num_groups or b * h * w == 0:
        raise ValueError(f"groupnorm_silu: {c} channels, {num_groups} groups, "
                         f"shape {tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"groupnorm_silu: {name} must be a contiguous [{c}] "
                             f"tensor on {x.device}")
    k = _kernels()
    hw, cg = h * w, c // num_groups
    block_cg = _next_pow2(cg)
    block_hw = max(1, TILE // block_cg)
    rows_per_chunk = -(-max(-(-hw // MAX_CHUNKS), block_hw) // block_hw) * block_hw
    num_chunks = -(-hw // rows_per_chunk)
    n_stats = b * num_groups
    part = torch.empty((3, n_stats * num_chunks), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((2, n_stats), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        k.gn_partial_stats[(n_stats, num_chunks)](
            x, part[0], part[1], part[2], hw, c, cg, num_groups, rows_per_chunk,
            num_chunks, BLOCK_HW=block_hw, BLOCK_CG=block_cg)
        k.gn_combine[(n_stats,)](
            part[0], part[1], part[2], stats[0], stats[1], num_chunks, float(eps),
            BLOCK=_next_pow2(num_chunks))
        block_c = min(128, _next_pow2(c))
        block_r = max(1, TILE // block_c)
        n_row_blocks = -(-hw // block_r)
        k.gn_apply[(b * n_row_blocks, -(-c // block_c))](
            x, y, scale, bias, stats[0], stats[1], hw, c, cg, num_groups,
            n_row_blocks, BLOCK_R=block_r, BLOCK_C=block_c)
    launches += 1
    return y


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm + SiLU over NHWC ``x [B, H, W, C]``."""
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: no kernel for device {x.device}")
    return _groupnorm_silu_cuda(x, scale, bias, num_groups, eps)
