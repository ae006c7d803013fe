"""Kernel B3's plan and statistics order, on the CPU.

``diffsensei_tpu_torch.ops.groupnorm.plan`` decides, from the shape alone, how
the CUDA kernel covers a call: the route (one resident launch or two
streaming ones), the strips of whole groups, the slabs of rows and the
shared memory. These tests hold it at every shape the served and
trained paths launch (``chip_smoke.GN_CASES``, checked here against the
full-width modules run on the meta device) and at the gpu tests' ragged
shapes, and check that the kernel's order of statistics (two-pass partials a
slab, merged with Chan's formula in a fixed order) keeps fp32 precision where
E[x^2] - E[x]^2 does not. The kernel itself runs only on the card
(``tests/test_torch_port_kernels.py``).
"""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from diffsensei_tpu_torch.models import layers
from diffsensei_tpu_torch.models.unet import UNetMangaModel
from diffsensei_tpu_torch.models.vae import AutoencoderKL
from diffsensei_tpu_torch.ops import groupnorm as tgn
from diffsensei_tpu_torch.pipelines.pipeline import sdxl_configs
from test_torch_port_kernels import GN_WIDTH_CASES

# the shapes larger than one resident grid's shared memory (about 25 MB, one
# block on each of 132 SMs): the UNet's widest levels, and the VAE from
# 128² x 512 up
STREAMING = {(2, 128, 128, 640), (2, 128, 128, 960), (2, 64, 64, 1920), (1, 128, 128, 960),
             (2, 96, 168, 640), (2, 96, 168, 960), (2, 48, 84, 1920),
             (1, 128, 128, 512), (1, 256, 256, 512), (1, 256, 256, 256), (1, 512, 512, 512),
             (1, 512, 512, 256), (1, 512, 512, 128), (1, 1024, 1024, 256),
             (1, 1024, 1024, 128), (1, 192, 192, 512), (1, 384, 384, 512), (1, 384, 384, 256),
             (1, 768, 768, 256), (1, 768, 768, 128)}


@pytest.mark.parametrize("shape,dtype_name", [(c[0], c[1]) for c in chip_smoke.GN_CASES],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_plan_covers_every_path_shape(shape, dtype_name):
    """The route (streaming exactly where x exceeds the resident grid's slabs);
    strips of whole groups and slabs of rows that cover every (sample,
    group, row) once; a resident block's shared memory within 227 KB and the
    resident grid on the card at once; the workspace."""
    dtype = getattr(torch, dtype_name)
    b, h, w, c = shape
    hw, es = h * w, 2 if dtype == torch.bfloat16 else 4
    p = tgn.plan(shape, dtype, 32)
    assert p.route == ("streaming" if shape in STREAMING else "resident")
    assert (b * hw * c * es > tgn.SMS * tgn.SLAB_MAX) == (p.route == "streaming")
    assert p.kernels == (1 if p.route == "resident" else 2)
    ng = p.groups_per_strip
    strips = [list(range(s * ng, (s + 1) * ng)) for s in range(p.strips)]
    assert sorted(g for s in strips for g in s) == list(range(32))
    strip_bytes = ng * (c // 32) * es
    assert strip_bytes % p.vec == 0 and c * es % p.vec == 0
    bounds = tgn.row_split(hw, p.slabs)
    assert bounds[0] == 0 and bounds[-1] == hw
    sizes = np.diff(bounds)
    assert sizes.min() >= 1 and sizes.max() == p.rows_per_block
    assert p.blocks == b * p.strips * p.slabs
    assert p.blocks <= tgn.SMS      # one block an SM: every block on the card at once
    assert p.workspace_floats == p.blocks * ng * 4
    if p.route == "resident":
        assert ng == 32 and p.strips == 1
        slab = p.rows_per_block * c * es
        assert slab + tgn.EXTRA_BYTES <= p.smem_bytes <= tgn.SMEM_MAX == 232_448
    else:
        assert strip_bytes // p.vec <= tgn.THREADS and p.smem_bytes == 0


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` one element past an aligned start."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


# (name, x, scale dtype, bias dtype, groups): inputs the kernel does not take
GN_TWIN_CASES = [
    ("float16_x", lambda: torch.zeros(1, 8, 8, 64, dtype=torch.float16), None, None, 32),
    ("float64_x", lambda: torch.zeros(1, 8, 8, 64, dtype=torch.float64), None, None, 32),
    ("float16_scale", lambda: torch.zeros(1, 8, 8, 64), torch.float16, None, 32),
    ("float16_bias", lambda: torch.zeros(1, 8, 8, 64), None, torch.float16, 32),
    ("odd_bf16_channels", lambda: torch.zeros(1, 8, 8, 33, dtype=torch.bfloat16), None, None, 3),
    ("group_over_8kb", lambda: torch.zeros(1, 2, 2, 4160), None, None, 2),
    ("batch_over_65535", lambda: torch.zeros(65536, 1, 1, 32), None, None, 32),
]


@pytest.mark.parametrize("name,make_x,scale_dtype,bias_dtype,groups", GN_TWIN_CASES,
                         ids=[c[0] for c in GN_TWIN_CASES])
def test_layer_routes_what_the_kernel_does_not_take_to_the_twin(
        monkeypatch, name, make_x, scale_dtype, bias_dtype, groups):
    """``kernel_plan`` gives a reason, not a plan, for each input ``plan`` or
    the dtype checks reject, from dtypes and shapes alone, and
    ``FusedGroupNormSiLU`` then computes the twin's result (as the JAX entry
    runs its plain path)."""
    x = make_x()
    c = x.shape[-1]
    layer = layers.FusedGroupNormSiLU(groups, c)
    with torch.no_grad():
        layer.weight.copy_(torch.linspace(0.5, 1.5, c))
        layer.bias.copy_(torch.linspace(-0.2, 0.2, c))
    pdt = x.dtype if x.dtype in (torch.bfloat16, torch.float32) else torch.float32
    layer.weight.data = layer.weight.data.to(scale_dtype or pdt)
    layer.bias.data = layer.bias.data.to(bias_dtype or pdt)
    x.copy_(torch.linspace(-1, 1, x.numel()).view(x.shape))   # in place: keeps the address
    assert isinstance(tgn.kernel_plan(x, layer.weight, layer.bias, groups), str)
    with torch.no_grad():
        got = layer(x)
        want = tgn.groupnorm_silu_ref(x, layer.weight, layer.bias, groups, layer.eps)
    assert got.dtype == x.dtype and torch.equal(got, want)


# (name, x, scale, bias, match): inputs no path takes as they are
GN_FAULT_CASES = [
    ("misaligned_x", lambda: _misaligned((1, 4, 4, 64), torch.bfloat16),
     lambda: torch.ones(64), lambda: torch.zeros(64), "alignment"),
    ("three_d_x", lambda: torch.zeros(8, 8, 64), lambda: torch.ones(64),
     lambda: torch.zeros(64), "4-d"),
    ("strided_x", lambda: torch.zeros(1, 8, 8, 64).transpose(1, 2),
     lambda: torch.ones(64), lambda: torch.zeros(64), "contiguous"),
    ("scale_of_65", lambda: torch.zeros(1, 8, 8, 64), lambda: torch.ones(65),
     lambda: torch.zeros(64), "scale"),
    ("bias_on_meta", lambda: torch.zeros(1, 8, 8, 64), lambda: torch.ones(64),
     lambda: torch.zeros(64, device="meta"), "bias"),
]


@pytest.mark.parametrize("name,make_x,make_scale,make_bias,match", GN_FAULT_CASES,
                         ids=[c[0] for c in GN_FAULT_CASES])
def test_kernel_plan_raises_for_what_no_path_takes(name, make_x, make_scale, make_bias, match):
    """Malformed inputs raise rather than run the twin: a misaligned x, an x
    that is not contiguous 4-d NHWC, a scale or bias of another shape or
    device. The layer asks ``kernel_plan`` on the card, so they raise there."""
    with pytest.raises(ValueError, match=match):
        tgn.kernel_plan(make_x(), make_scale(), make_bias(), 32)


@pytest.mark.parametrize("shape,dtype_name", sorted({(c[0], c[1]) for c in chip_smoke.GN_CASES}),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_kernel_takes_every_path_shape(shape, dtype_name):
    """Every shape the served and trained paths launch stays on the kernel,
    with the bf16 UNet's and the fp32 VAE's parameter dtypes."""
    dtype = getattr(torch, dtype_name)
    x = torch.empty(shape, dtype=dtype, device="meta")
    p = torch.empty(shape[-1], dtype=dtype, device="meta")
    assert isinstance(tgn.kernel_plan(x, p, p.float(), 32), tgn.Plan)


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tgn.plan((1, 8, 8, 64), torch.float16, 32)
    with pytest.raises(ValueError):
        tgn.plan((1, 8, 8, 65), torch.float32, 32)
    with pytest.raises(ValueError):       # odd bf16 rows: no 4-byte vector
        tgn.plan((1, 8, 8, 33), torch.bfloat16, 3)
    with pytest.raises(ValueError):
        tgn.plan((1, 0, 8, 64), torch.float32, 32)


@pytest.mark.parametrize("route,dtype,vec,shape,groups", GN_WIDTH_CASES,
                         ids=[f"{r}-{str(d)[6:]}-{v}" for r, d, v, *_ in GN_WIDTH_CASES])
def test_plan_picks_each_route_and_vector_width(route, dtype, vec, shape, groups):
    """The plan picks each route at each vector width the kernel is built
    for somewhere (``GN_WIDTH_CASES``, run on the card in
    ``test_torch_port_kernels.py``)."""
    p = tgn.plan(shape, dtype, groups)
    assert (p.route, p.vec) == (route, vec)
    assert shape[-1] // groups * p.groups_per_strip * dtype.itemsize // vec <= tgn.THREADS


def test_plan_fits_the_cards_sms():
    """On a card with fewer SMs the resident grid and the streaming slabs
    shrink to one block an SM of that card."""
    for shape, dtype in (((2, 128, 128, 320), torch.bfloat16),
                         ((1, 1024, 1024, 128), torch.float32)):
        full, fewer = tgn.plan(shape, dtype, 32), tgn.plan(shape, dtype, 32, 114)
        assert full.blocks == 132 and fewer.blocks <= 114 and fewer.route == full.route


def _record_gn_calls(monkeypatch):
    seen = collections.Counter()

    def record(x, scale, bias, num_groups, eps, checked=None):
        seen[(tuple(x.shape), str(x.dtype).removeprefix("torch."))] += 1
        return torch.empty_like(x)
    monkeypatch.setattr(layers, "groupnorm_silu", record)
    return seen


def test_gn_cases_are_the_paths_shapes(monkeypatch):
    """The full-width UNet and VAE on the meta device launch exactly the
    calls of GN_CALLS_R1 (20 UNet steps on the CFG batch, the decode) and
    GN_CALLS_T1 (the batch-1 UNet forward and its replay, the encoder), and
    R2's shapes are GN_CASES rows."""
    seen = _record_gn_calls(monkeypatch)
    cfg = sdxl_configs()
    with torch.device("meta"):
        unet = UNetMangaModel(cfg["unet"], torch.bfloat16)
        vae = AutoencoderKL(cfg["vae"], torch.float32)
    uc = cfg["unet"]

    def unet_forward(b, h, w):
        unet(torch.empty(b, h, w, 4, device="meta"), torch.zeros(b, device="meta"),
             torch.empty(b, 77, uc.cross_attention_dim, device="meta"),
             torch.empty(b, uc.pooled_projection_dim, device="meta"),
             torch.empty(b, 6, device="meta"))

    def counts(fn, times=1):
        seen.clear()
        fn()
        return {k: v * times for k, v in seen.items()}

    r1 = collections.Counter(counts(lambda: unet_forward(2, 128, 128), 20))
    r1.update(counts(lambda: vae.decode(torch.empty(1, 128, 128, 4, device="meta"))))
    assert dict(r1) == chip_smoke.GN_CALLS_R1
    t1 = collections.Counter(counts(lambda: unet_forward(1, 128, 128), 2))
    t1.update(counts(lambda: vae.encode(torch.empty(1, 1024, 1024, 3, device="meta"))))
    assert dict(t1) == chip_smoke.GN_CALLS_T1
    r2 = counts(lambda: unet_forward(2, 96, 168))
    r2.update(counts(lambda: vae.decode(torch.empty(1, 96, 96, 4, device="meta"))))
    assert set(r2) <= chip_smoke.GN_SHAPES


def _merge(a, b):
    """Chan's formula on fp32 (n, mean, M2) tensors, in the kernel's order."""
    n, mean, m2 = a
    nb, mb, m2b = b
    nn = n + nb
    d = mb - mean
    f = nb / nn
    return nn, mean + d * f, m2 + m2b + d * d * n * f


def _lane_tree(values):
    """A balanced sum over the lanes, lower lanes first (the kernel's xor
    butterfly)."""
    while len(values) > 1:
        values = [values[i] + values[i + 1] for i in range(0, len(values), 2)]
    return values[0]


def kernel_order_stats(x: torch.Tensor, p: tgn.Plan, groups: int):
    """Mean and variance a (sample, group) in the kernel's order, in fp32:
    less the group's shift (its first value), each slab's mean, then its
    squared deviations; then, over the slabs, tg lanes a group (16 at 32
    groups), lane l taking slabs l, l + tg, ...: the mean from the sums of the
    counts and of the count-weighted means, then the variance from the sums
    of the M2s and of the slabs' squared deviations from that mean."""
    b, h, w, c = x.shape
    xs = x.reshape(b, h * w, groups, c // groups).permute(0, 2, 1, 3)   # [b, group, row, channel]
    shift = xs[:, :, 0, 0]
    xs = xs - shift[..., None, None]
    bounds = tgn.row_split(h * w, p.slabs)
    parts = []
    for s in range(p.slabs):
        # a slab's values of a group, summed as a tree (the kernel: short runs
        # a thread, then columns and a shuffle tree), not one long fp32 run
        v = xs[:, :, bounds[s]:bounds[s + 1]].reshape(b, groups, -1)
        n = torch.full((b, groups), float(v.shape[-1]))
        mean = v.sum(dim=-1) / n
        m2 = (v - mean[..., None]).square().sum(dim=-1)
        parts.append((n, mean, m2))
    tg = 32
    while tg > 1 and tg * p.groups_per_strip > tgn.THREADS:
        tg //= 2
    zero = torch.zeros(b, groups)
    lanes = [parts[lane::tg] for lane in range(tg)]
    n_tot = _lane_tree([sum((e[0] for e in lane), zero) for lane in lanes])
    nm = []
    for lane in lanes:
        acc = zero
        for e in lane:
            acc = acc + e[0] * e[1]
        nm.append(acc)
    mean = _lane_tree(nm) / n_tot
    m2 = []
    for lane in lanes:
        acc = zero
        for e in lane:
            acc = acc + (e[2] + e[0] * (e[1] - mean).square())
        m2.append(acc)
    return shift + mean, _lane_tree(m2) / n_tot


@pytest.mark.parametrize("route,shape,groups", [("resident", (2, 64, 64, 64), 32),
                                                ("streaming", (1, 64, 64, 576), 288)],
                         ids=["resident", "streaming"])
def test_kernel_statistics_order_keeps_fp32_precision(route, shape, groups):
    """At a mean of 1e3 the kernel's order matches the twin's statistics
    within 1e-6 relative; E[x^2] - E[x]^2 in fp32 does not."""
    rng = np.random.default_rng(5)
    b, h, w, c = shape
    x = torch.from_numpy((rng.normal(size=shape) * 1.5 + 1e3).astype(np.float32))
    p = tgn.plan(shape, torch.float32, groups)
    assert p.route == route and p.slabs >= 8
    mean, var = kernel_order_stats(x, p, groups)
    # the twin's statistics (groupnorm_silu_ref: the mean, then the variance
    # about it) in float64, so that the twin's own fp32 rounding (about 2e-6
    # here) is not what is measured
    xd = x.double().reshape(b, h * w, groups, c // groups)
    twin_mean = xd.mean(dim=(1, 3))
    twin_var = (xd - twin_mean[:, None, :, None]).square().mean(dim=(1, 3))
    rel = lambda a, b: ((a.double() - b).abs() / b.abs()).max().item()
    assert rel(mean, twin_mean) <= 1e-6
    assert rel(var, twin_var) <= 1e-6
    xf = x.reshape(b, h * w, groups, c // groups).permute(0, 2, 1, 3).reshape(b, groups, -1)
    naive = xf.square().mean(dim=-1) - xf.mean(dim=-1).square()
    assert rel(naive, twin_var) > 1e-2


def test_port_imports_no_triton():
    """Every kernel of the port is CUDA C++ built by nvcc: no source of the
    package imports Triton."""
    root = Path(tgn.__file__).resolve().parents[1]
    importing = [str(f.relative_to(root)) for f in root.rglob("*.py")
                 if re.search(r"^\s*(import|from)\s+triton\b", f.read_text(), re.M)]
    assert not importing
    assert sorted(f.name for f in (root / "csrc").iterdir() if f.suffix in (".cu", ".py")) == [
        "dual_cross_attention.cu", "flash_attention.cu", "groupnorm_silu.cu", "int4_matmul.cu"]
