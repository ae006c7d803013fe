"""GroupNorm + SiLU: kernel B3 (CUDA C++, ``csrc/groupnorm_silu.cu``).

Port of ``diffsensei_tpu/ops/groupnorm.py`` (kernel ``_gn_silu_kernel:44``,
entry ``groupnorm_silu:120``). Every ``ResnetBlock2D`` of the UNet and the VAE
runs it twice. Unlike the JAX dispatcher, which defaults to XLA's path on the
TPU, the port runs the kernel for every CUDA tensor: the card's own numbers
(``PERF.md``) say whether it pays.

The work is bound by memory bandwidth. :func:`plan` (plain Python, a function
of the shape alone) cuts each sample into slabs of whole rows and picks one of
two routes: *resident* (one cooperative launch: every slab held in a block's
shared memory from load to store across one grid barrier, so x is read once)
where x fits in the shared memory of one grid the card holds at once, else
*streaming* (two launches: partial statistics per slab to a workspace, then
normalize; x is read twice). See the source for the design.

``groupnorm_silu`` runs the kernel for CUDA tensors and the plain twin
``groupnorm_silu_ref`` for CPU tensors; any other device, or a CUDA input the
kernel does not take, raises. ``kernel_plan`` makes the wrapper's checks
once: it gives the plan, or why the kernel has none for the inputs' dtypes or
shape (the model layer then runs the twin), and raises for malformed
inputs. ``launches`` counts
wrapper calls that launched the kernel, ``calls`` the same by ``(shape, dtype
name)``. When an input
requires a gradient the call goes through ``GroupNormSiLUFn``, whose backward
recomputes the twin and takes its VJP, as the JAX ``_fused_bwd``
(``groupnorm.py:102``) does: there is no backward kernel, on the TPU either.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from diffsensei_tpu_torch.ops import _build

THREADS = 512            # threads a block
MAX_STRIP_GROUPS = 32    # groups a streaming strip
MAX_GROUPS = 256         # groups a resident call
SMS = 132                # the H100 SXM's SMs; the plan takes the card's count
SMEM_MAX = 232_448       # dynamic shared memory a block may use on the H100
# a resident block's shared memory besides its slab (csrc: EXTRA_BYTES)
EXTRA_BYTES = (2 * THREADS * 8 + THREADS + 3 * MAX_GROUPS) * 4
SLAB_MAX = SMEM_MAX - EXTRA_BYTES    # a resident block's slab
MIN_SLAB_BYTES = 32768   # a sample is not cut into slabs smaller than this
MAX_BATCH = 65535        # samples a call (csrc: the grid's z extent)

launches = 0
calls: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers one shape. A strip is ``groups_per_strip`` whole
    groups of one sample (all its rows; resident: the whole row); its rows
    are split evenly into ``slabs`` (``row_split``), one a block."""

    route: str               # "resident" (one launch) or "streaming" (two)
    vec: int                 # bytes a thread loads or stores at once
    groups_per_strip: int
    strips: int              # strips a sample
    slabs: int               # slabs a strip
    rows_per_block: int      # the most rows a slab holds
    smem_bytes: int          # dynamic shared memory a resident block; 0 streaming
    blocks: int
    kernels: int             # launches a call
    workspace_floats: int    # partial statistics: (count, mean, M2, -) a slab and group


def row_split(rows: int, parts: int) -> list:
    """The kernel's slab boundaries: part k owns ``[b[k], b[k + 1])``."""
    return [rows * k // parts for k in range(parts + 1)]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(shape: Tuple[int, int, int, int], dtype: torch.dtype, num_groups: int,
         sms: int = SMS) -> Plan:
    """The kernel's plan for NHWC ``shape`` of ``dtype`` (bf16 or fp32) on a
    card of ``sms`` SMs: resident wherever x fits in the shared memory of a
    grid of one block an SM, else streaming. Raises what the kernel does not
    take."""
    p = _plan(tuple(shape), dtype, num_groups, sms)
    if isinstance(p, str):
        raise ValueError(p)
    return p


@functools.lru_cache(maxsize=None)
def _plan(shape: Tuple[int, int, int, int], dtype: torch.dtype, num_groups: int,
          sms: int) -> Plan | str:
    """``plan``'s work: the plan, or why the kernel does not take the shape."""
    b, h, w, c = shape
    hw = h * w
    if dtype not in (torch.bfloat16, torch.float32):
        return f"groupnorm_silu: no kernel for {dtype}"
    if b < 1 or b > MAX_BATCH or hw < 1 or num_groups < 1 or c % num_groups:
        return f"groupnorm_silu: {c} channels, {num_groups} groups, shape {shape}"
    es = 2 if dtype == torch.bfloat16 else 4
    cg, row = c // num_groups, c * es
    # four values a thread first (8-byte bf16 vectors measured 3-10% faster
    # than 16-byte ones on the H100: fewer registers), then wider, then narrower
    vecs = list(dict.fromkeys(v for v in (4 * es, 16, 8, 4) if row % v == 0))

    def strip_groups(v):
        """Group counts a streaming strip may hold at vector width v."""
        return [d for d in range(1, min(num_groups, MAX_STRIP_GROUPS) + 1)
                if num_groups % d == 0 and d * cg * es % v == 0
                and d * cg * es // v <= THREADS]

    if num_groups <= MAX_GROUPS:
        for v in vecs:      # a row at most one vector a thread
            slabs = min(hw, sms // b, max(1, hw * row // MIN_SLAB_BYTES))
            if row // v <= THREADS and slabs >= 1 and _ceil(hw, slabs) * row <= SLAB_MAX:
                return Plan("resident", v, num_groups, 1, slabs, _ceil(hw, slabs),
                            -(-_ceil(hw, slabs) * row // 16) * 16 + EXTRA_BYTES,
                            b * slabs, 1, b * slabs * num_groups * 4)
    for v in vecs:
        cands = strip_groups(v)
        if cands:
            ng = max(cands)     # the widest strip: the longest contiguous rows
            strips = num_groups // ng
            slabs = max(1, min(hw, sms // (b * strips)))
            return Plan("streaming", v, ng, strips, slabs, _ceil(hw, slabs), 0,
                        b * strips * slabs, 2, b * strips * slabs * ng * 4)
    return f"groupnorm_silu: no kernel for {c} channels of {dtype} in {num_groups} groups"


def kernel_plan(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                num_groups: int) -> Plan | str:
    """Every check the launching wrapper makes, once: the kernel's plan for
    these inputs, or why it has none for their dtypes or shape (x, scale or
    bias neither bf16 nor fp32, or a shape ``plan`` rejects). Those are the
    inputs the JAX entry (``diffsensei_tpu/ops/groupnorm.py:120``) runs on
    its plain path: ``FusedGroupNormSiLU`` sends them to the twin and the
    wrapper raises the reason. Inputs no path takes as they are raise
    ``ValueError`` here: x not a contiguous 4-d NHWC tensor, a scale or bias
    not a contiguous [C] tensor on x's device, x not aligned to the plan's
    vector width. It reads no device state but the card's SM count, so it
    answers for CPU tensors too (as if they were on an H100)."""
    if x.dim() != 4:
        raise ValueError(f"groupnorm_silu: x must be a 4-d bfloat16 or float32 "
                         f"NHWC tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu: x must be contiguous NHWC")
    c = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"groupnorm_silu: {name} must be a contiguous [{c}] "
                             f"bfloat16 or float32 tensor on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        return (f"groupnorm_silu: x must be a 4-d bfloat16 or float32 NHWC tensor, "
                f"got {x.dtype} {tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            return f"groupnorm_silu: {name} must be bfloat16 or float32, got {t.dtype}"
    # a resident grid needs every block on the card at once: one an SM
    sms = _sms(x.device.index) if x.device.type == "cuda" else SMS
    p = _plan(tuple(x.shape), x.dtype, num_groups, sms)
    if not isinstance(p, str) and x.data_ptr() % p.vec:
        raise ValueError(f"groupnorm_silu: x needs {p.vec}-byte alignment")
    return p


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.cuda_library("groupnorm_silu.cu")))
    fn = lib.diffsensei_groupnorm_silu
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    lib.diffsensei_groupnorm_layout.argtypes = ([ctypes.c_int] * 9
                                                + [ctypes.POINTER(ctypes.c_int)])
    lib.diffsensei_groupnorm_layout.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library (also done at first launch)."""
    _library()


def layout(shape, dtype: torch.dtype, num_groups: int) -> dict:
    """How the plan's kernels fill the first card: blocks an SM of the
    (first) kernel and of the streaming route's second (0 when resident), the
    resident block's shared memory (0 when streaming) and the card's SMs."""
    p = plan(tuple(shape), dtype, num_groups, _sms(0))
    b, h, w, c = shape
    out = (ctypes.c_int * 4)()
    err = _library().diffsensei_groupnorm_layout(
        int(dtype == torch.float32), b, h * w, c, num_groups, int(p.route == "streaming"),
        p.groups_per_strip, p.slabs, p.vec, out)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu layout query failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "blocks_per_sm_apply", "smem_bytes", "sms"), out))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _groupnorm_silu_cuda(x, scale, bias, num_groups, eps, checked=None):
    global launches
    p = kernel_plan(x, scale, bias, num_groups) if checked is None else checked
    if isinstance(p, str):
        raise ValueError(p)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    ws = torch.empty(p.workspace_floats, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().diffsensei_groupnorm_silu(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            int(x.dtype == torch.float32), int(scale.dtype == torch.float32),
            int(bias.dtype == torch.float32), b, h * w, c, num_groups, float(eps),
            int(p.route == "streaming"), p.groups_per_strip, p.slabs, p.vec, ws.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: cudaError {err}")
    launches += 1
    calls[(tuple(x.shape), str(x.dtype).removeprefix("torch."))] += 1
    return y


def _forward(x, scale, bias, num_groups, eps, checked):
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: no kernel for device {x.device}")
    return _groupnorm_silu_cuda(x, scale, bias, num_groups, eps, checked)


class GroupNormSiLUFn(torch.autograd.Function):
    """B3 forward (the twin on the CPU); the backward is the VJP of
    ``groupnorm_silu_ref`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, checked):
        ctx.save_for_backward(x, scale, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _forward(x, scale, bias, num_groups, eps, checked)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            y = groupnorm_silu_ref(*inputs, ctx.num_groups, ctx.eps)
            grads = torch.autograd.grad(y, [inputs[i] for i in wanted], g)
        out = [None] * 3
        for i, grad in zip(wanted, grads):
            out[i] = grad
        return (*out, None, None, None)


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5,
                   checked: Plan | None = None) -> torch.Tensor:
    """Fused GroupNorm + SiLU over NHWC ``x [B, H, W, C]``; differentiable in
    all three tensors. ``checked``: a plan ``kernel_plan`` gave for these
    inputs, so that a CUDA call does not check them again."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return GroupNormSiLUFn.apply(x, scale, bias, num_groups, eps, checked)
    return _forward(x, scale, bias, num_groups, eps, checked)
