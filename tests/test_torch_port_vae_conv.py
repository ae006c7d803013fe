"""Kernel B9, the VAE's fp32 3x3 convolutions (``ops/vae_conv.py``).

On the CPU: the plain twin against the ``layers`` composition the VAE ran
before (GroupNorm+SiLU, conv, bias, residual; the stride-2 downsampler and
the upsampler), zero padding applied after the activation, the TF32 split of
the weights and their order, the plan at every VAE shape of the benchmark's
cells, the 768-px decode tile and the 256/512/1024 training buckets, the
VAE's own modules against the old composition from the same state dict (on
the kernel's entry where it takes the channels, plain modules where not), the
refusal of an input the plan does not take, the weights' TF32 halves across
reloads, the counters and the decode and encode spans' counts.

On the card (``gpu``-marked; the file imports torch only):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_vae_conv.py

the kernel and cuDNN's fp32 convolution (TF32 off) against an fp64
convolution of the same fp32 inputs at every VAE convolution shape of both
cells at batch 1, at a 768-px decode tile and at the 512 bucket: B9's RMS
error no larger than cuDNN's, its largest error at most twice cuDNN's.
"""

import copy
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffsensei_tpu_torch.core.buckets import make_bucket_table
from diffsensei_tpu_torch.core.config import VAEConfig
from diffsensei_tpu_torch.models import layers
from diffsensei_tpu_torch.models import vae as tvae
from diffsensei_tpu_torch.ops import vae_conv as tvc
from diffsensei_tpu_torch.ops.groupnorm import groupnorm_silu_ref
from diffsensei_tpu_torch.pipelines.pipeline import _decode
from diffsensei_tpu_torch.train.diffusion import _encode_latents
from diffsensei_tpu_torch.utils.observability import SPANS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "_torch_bench_vae_conv", os.path.join(REPO, "tools", "torch_bench_vae_conv.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool()
# every VAE convolution of the two cells (encode 8 x 1024², decode 4 x 128²)
CELL_ROWS = TOOL.vae_conv_rows()
# a 96-latent decode tile (768 px) and the 512 bucket's square encode
TILE_ROWS = TOOL.vae_conv_rows(enc_batch=1, size=512, dec_batch=1, latent=96)


def _label(row):
    b, h, w, c = row["shape"]
    return (f"{row['name']}-{h}x{w}x{c}-{row['cout']}-{tvc.MODE_NAMES[row['mode']]}"
            f"{'-gn' if row['gn'] else ''}{'-res' if row['res'] else ''}")


def _unique(rows):
    """One row a (shape without batch, cout, mode, gn, res)."""
    seen, out = set(), []
    for r in rows:
        key = (r["shape"][1:], r["cout"], r["mode"], r["gn"], r["res"])
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


def _norm(c, groups, g, mean_shift=0.0):
    norm = layers.FusedGroupNormSiLU(groups, c, 1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, generator=g) + 0.5)
        norm.bias.copy_(torch.randn(c, generator=g) + mean_shift)
    return norm


def _conv(cin, cout, g, **kw):
    conv = layers.Conv2d(cin, cout, 3, padding=1, **kw)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * (9 * cin) ** -0.5)
        conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
    return conv


# --- the plain twin against the layers composition -------------------------


@pytest.mark.parametrize("kind", ["conv1", "conv2_identity", "conv2_shortcut", "downsample",
                                  "upsample"])
def test_twin_matches_the_layers_composition(kind):
    """Each kind of VAE convolution: the twin equals what ``layers`` composed
    (B3's twin, ``Conv2d``, the residual add, ``Downsample2D``,
    ``Upsample2D``) on the same fp32 inputs."""
    g = torch.Generator().manual_seed(1)
    cin, cout = (32, 64) if kind in ("conv1", "conv2_shortcut") else (64, 64)
    x = torch.randn(2, 12, 18, cin, generator=g) * 2 + 0.5
    conv = _conv(cin, cout, g, stride=2 if kind == "downsample" else 1)
    with torch.no_grad():
        if kind == "conv1":
            norm = _norm(cin, 8, g)
            want = conv(norm(x))
            got = tvc.vae_conv3x3_ref(x, conv.weight, conv.bias, tvc.STRIDE1, norm)
        elif kind.startswith("conv2"):
            norm = _norm(cin, 8, g)
            res = torch.randn(2, 12, 18, cout, generator=g)
            if kind == "conv2_shortcut":
                res = layers.Conv2d(cin, cout, 1)(x)
            want = res + conv(norm(x))
            got = tvc.vae_conv3x3_ref(x, conv.weight, conv.bias, tvc.STRIDE1, norm, res)
        elif kind == "downsample":
            down = layers.Downsample2D(cin)
            down.conv.load_state_dict(conv.state_dict())
            want = down(x)
            got = tvc.vae_conv3x3_ref(x, conv.weight, conv.bias, tvc.STRIDE2)
        else:
            up = layers.Upsample2D(cin)
            up.conv.load_state_dict(conv.state_dict())
            want = up(x)
            got = tvc.vae_conv3x3_ref(x, conv.weight, conv.bias, tvc.UPSAMPLE)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6


def test_padding_follows_the_activation():
    """Zero padding belongs to the activated tensor: where silu(beta - mean *
    rstd * gamma) is far from 0, the twin equals the conv of the zero-padded
    activation, and transforming a zero-filled border instead (what a kernel
    that activated TMA's zero fill would compute) differs at the border."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 10, 14, 32, generator=g) + 3.0
    norm = _norm(32, 8, g, mean_shift=2.0)
    conv = _conv(32, 32, g)
    with torch.no_grad():
        got = tvc.vae_conv3x3_ref(x, conv.weight, conv.bias, tvc.STRIDE1, norm)
        act = groupnorm_silu_ref(x, norm.weight, norm.bias, 8, 1e-6)
        want = torch.nn.functional.conv2d(
            torch.nn.functional.pad(act.permute(0, 3, 1, 2), (1, 1, 1, 1)), conv.weight,
            conv.bias).permute(0, 2, 3, 1)
        # the activation of a zero input, channel by channel
        xf = x.reshape(1, -1, 8, 4)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        rstd = torch.rsqrt((xf - mean).square().mean(dim=(1, 3), keepdim=True) + 1e-6)
        zero = torch.nn.functional.silu(
            ((0 - mean) * rstd).expand(1, 1, 8, 4).reshape(32) * norm.weight + norm.bias)
        filled = torch.nn.functional.pad(act.permute(0, 3, 1, 2), (1, 1, 1, 1))
        border = torch.ones_like(filled[:, :1], dtype=torch.bool)
        border[..., 1:-1, 1:-1] = False
        filled = torch.where(border, zero[None, :, None, None], filled)
        wrong = torch.nn.functional.conv2d(filled, conv.weight, conv.bias).permute(0, 2, 3, 1)
    assert zero.abs().max().item() > 0.5
    assert (got - want).abs().max().item() <= 1e-5
    assert (got - wrong).abs().max().item() > 0.1


# --- the TF32 split and the weights' order ---------------------------------


def _tf32_rna_reference(x: np.ndarray) -> np.ndarray:
    """Round to 10 mantissa bits, ties away from zero, in float64."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    e = np.floor(np.log2(np.abs(x[nz])))
    ulp = 2.0 ** (e - 10)
    out[nz] = np.sign(x[nz]) * np.floor(np.abs(x[nz]) / ulp + 0.5) * ulp
    return out


def test_split_tf32_rounds_to_nearest_and_holds_fp32():
    """hi is x rounded to TF32 to nearest, ties away from zero (the kernel's
    cvt.rna), both halves have their 13 low bits clear, |x - hi| <= 2^-11 |x|
    and |x - (hi + lo)| <= 2^-22 |x|."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(20000) * np.exp(rng.uniform(-20, 20, 20000))).astype(np.float32)
    bits = rng.integers(0, 1 << 10, 64, dtype=np.int64) << 13 | 0x1000   # exact ties
    ties = (bits | 0x3F000000).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, 1.0, -2.5])])
    hi, lo = tvc.split_tf32(torch.from_numpy(x))
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _tf32_rna_reference(x))
    xd, hid, lod = x.astype(np.float64), hi.double().numpy(), lo.double().numpy()
    assert np.all(np.abs(xd - hid) <= 2.0 ** -11 * np.abs(xd))
    assert np.all(np.abs(xd - (hid + lod)) <= 2.0 ** -22 * np.abs(xd))
    # ties go away from zero
    tie_hi = tvc.tf32_round(torch.from_numpy(ties)).numpy()
    assert np.all(tie_hi > ties)


def test_weight_layout_follows_k_order():
    """W[o, tap Cin + 16 b + p] = weight[o, 16 b + K_ORDER[p], tap // 3, tap % 3];
    K_ORDER puts channel 4t + 2 kk2 in fragment column t of k-step kk2 and
    channel 4t + 2 kk2 + 1 in column t + 4."""
    assert sorted(tvc.K_ORDER) == list(range(16))
    for kk2 in range(2):
        for t in range(4):
            assert tvc.K_ORDER[8 * kk2 + t] == 4 * t + 2 * kk2
            assert tvc.K_ORDER[8 * kk2 + t + 4] == 4 * t + 2 * kk2 + 1
    g = torch.Generator().manual_seed(4)
    w = torch.randn(8, 32, 3, 3, generator=g)
    lay = tvc.weight_layout(w)
    assert lay.shape == (8, 9 * 32) and lay.is_contiguous()
    for o in (0, 7):
        for tap in range(9):
            for c in range(32):
                want = w[o, 16 * (c // 16) + tvc.K_ORDER[c % 16], tap // 3, tap % 3]
                assert lay[o, tap * 32 + c] == want
    hi, lo = tvc.split_weight(w.to(memory_format=torch.channels_last))
    assert torch.equal(hi, tvc.split_tf32(lay)[0]) and torch.equal(lo, tvc.split_tf32(lay)[1])


# --- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("row", CELL_ROWS + TILE_ROWS, ids=_label)
def test_plan_takes_every_vae_convolution_of_the_cells(row):
    """Every resnet, downsampler and upsampler convolution of the encode
    (8 x 1024²) and decode (4 x 128² latents) cells, of a 768-px decode tile
    and of the 512 bucket: the kernel takes it."""
    p = tvc.plan(row["shape"], torch.float32, row["cout"], row["mode"],
                 32 if row["gn"] else None)
    assert isinstance(p, tvc.Plan), p
    ho, wo = tvc.out_hw(row["shape"][1], row["shape"][2], row["mode"])
    assert p.out_shape == (row["shape"][0], ho, wo, row["cout"])


def _bucket_sizes():
    sizes = []
    for cls in (256, 512, 1024):
        table = make_bucket_table(cls)
        sizes += [(cls, table[i][0], table[i][1]) for i in (0, 5, 16, 25)]
    return sizes


@pytest.mark.parametrize("cls,h,w", _bucket_sizes(), ids=lambda v: str(v))
def test_plan_takes_the_training_buckets(cls, h, w):
    """The encoder at buckets of the 256, 512 and 1024 classes (partial
    32 x 4 tiles at the ragged widths): every 3x3 convolution with 128-multiple
    channels takes the kernel."""
    seen = []
    real = tvc.vae_conv3x3

    def record(x, weight, bias, mode=tvc.STRIDE1, norm=None, residual=None, split=None):
        seen.append(tvc.plan(tuple(x.shape), x.dtype, weight.shape[0], mode,
                             None if norm is None else norm.num_groups))
        ho, wo = tvc.out_hw(x.shape[1], x.shape[2], mode)
        return torch.empty((x.shape[0], ho, wo, weight.shape[0]), device="meta")

    tvc.vae_conv3x3 = record
    try:
        with torch.device("meta"):
            vae = tvae.AutoencoderKL(VAEConfig.sdxl())
            vae.encode(torch.empty(2, h, w, 3))
    finally:
        tvc.vae_conv3x3 = real
    assert len(seen) == 23
    assert all(isinstance(p, tvc.Plan) for p in seen), [p for p in seen if isinstance(p, str)]


@pytest.mark.parametrize("shape,dtype,cout,mode,groups,why", [
    ((1, 64, 64, 128), torch.bfloat16, 128, tvc.STRIDE1, 32, "bfloat16"),
    ((1, 64, 64, 16), torch.float32, 128, tvc.STRIDE1, None, "16 -> 128"),
    ((1, 64, 64, 128), torch.float32, 64, tvc.STRIDE1, None, "128 -> 64"),
    ((1, 64, 64, 128), torch.float32, 192, tvc.STRIDE1, None, "128 -> 192"),
    ((1, 63, 64, 128), torch.float32, 128, tvc.STRIDE2, None, "even height"),
    ((1, 64, 64, 1024), torch.float32, 1024, tvc.STRIDE1, 32, "GroupNorm prologue"),
    ((1, 64, 64, 128), torch.float32, 128, tvc.UPSAMPLE, 32, "GroupNorm prologue"),
    ((1, 64, 64, 96), torch.float32, 128, tvc.STRIDE1, 32, "GroupNorm prologue"),
    ((1, 64, 64, 128), torch.float32, 128, 3, None, "mode 3"),
])
def test_plan_rejects_what_the_kernel_does_not_take(shape, dtype, cout, mode, groups, why):
    p = tvc.plan(shape, dtype, cout, mode, groups)
    assert isinstance(p, str) and why in p


def test_plan_takes_odd_spatial_sizes():
    p = tvc.plan((3, 37, 50, 128), torch.float32, 256, tvc.STRIDE1, 32)
    assert isinstance(p, tvc.Plan) and p.out_shape == (3, 37, 50, 256)
    assert p.stats_slabs == 176
    up = tvc.plan((1, 9, 13, 128), torch.float32, 128, tvc.UPSAMPLE)
    assert up.out_shape == (1, 18, 26, 128) and up.stats_slabs == 0


# --- the VAE's own modules ---------------------------------------------------


# channels the kernel takes (a 1x1 shortcut at 128 -> 256), and channels it
# does not (the tiny presets' width: plain modules)
SMALL = VAEConfig(block_out_channels=(128, 128, 256, 256), layers_per_block=1,
                  norm_num_groups=32)
NARROW = VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)


def _convs(module):
    """The VAE 3x3 convolutions under ``module`` that ``vae_conv`` counts."""
    return sum(2 if isinstance(m, tvae.VAEResnetBlock) else 1 for m in module.modules()
               if isinstance(m, (tvae.VAEResnetBlock, tvae.VAEDownsample, tvae.VAEUpsample)))


def _small_vae(seed=5, config=SMALL):
    torch.manual_seed(seed)
    vae = tvae.AutoencoderKL(config).eval()
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if name.endswith("weight") and p.dim() == 1:
                p.copy_(1.0 + 0.2 * torch.randn_like(p))
            else:
                p.copy_(torch.randn_like(p) * (0.5 / max(1, p[0].numel()) ** 0.5))
    return vae


def _old_composition(vae):
    """The same VAE with ``layers``' shared blocks in place of its own, from
    the same state dict: what the port ran before B9."""
    old = copy.deepcopy(vae)
    for parent in old.modules():
        for name, child in list(parent.named_children()):
            if isinstance(child, tvae.VAEResnetBlock):
                new = layers.ResnetBlock2D(child.conv1.in_channels, child.conv1.out_channels,
                                           child.norm1.num_groups, norm_eps=child.norm1.eps)
            elif isinstance(child, tvae.VAEDownsample):
                new = layers.Downsample2D(child.conv.in_channels)
            elif isinstance(child, tvae.VAEUpsample):
                new = layers.Upsample2D(child.conv.in_channels)
            else:
                continue
            new.load_state_dict(child.state_dict(), strict=True)
            setattr(parent, name, new)
    return old


@pytest.mark.parametrize("config", [SMALL, NARROW], ids=["kernel", "plain"])
def test_vae_modules_keep_the_parameter_names(config):
    """A state dict of the old composition loads strictly into the new VAE,
    on either route."""
    vae = _small_vae(config=config)
    old = _old_composition(vae)
    assert list(old.state_dict()) == list(vae.state_dict())
    fresh = tvae.AutoencoderKL(config)
    fresh.load_state_dict(old.state_dict(), strict=True)


def test_route_is_chosen_from_the_channels_when_built():
    """Every resnet, downsampler and upsampler of the SDXL VAE and of SMALL
    is built on the kernel's entry; NARROW's on plain ``layers`` convolutions."""
    kinds = (tvae.VAEResnetBlock, tvae.VAEDownsample, tvae.VAEUpsample)
    with torch.device("meta"):
        for config, kernel in ((VAEConfig.sdxl(), True), (SMALL, True), (NARROW, False)):
            vae = tvae.AutoencoderKL(config)
            blocks = [m for m in vae.modules() if isinstance(m, kinds)]
            assert blocks and all(m.kernel is kernel for m in blocks)
            convs = [c for m in blocks for c in m.modules() if isinstance(c, layers.Conv2d)
                     and c.kernel_size == (3, 3)]
            assert len(convs) == _convs(vae)
            assert all(isinstance(c, tvae.VAEConv3x3) is kernel for c in convs)
    assert tvc.takes(128, 256, tvc.STRIDE1, 32) and not tvc.takes(16, 16, tvc.STRIDE1, 4)
    assert not tvc.takes(1024, 1024, tvc.STRIDE1, 32) and tvc.takes(1024, 1024, tvc.STRIDE1)


@pytest.mark.parametrize("config", [SMALL, NARROW], ids=["kernel", "plain"])
def test_encoder_and_decoder_match_the_old_composition(config):
    """The small VAE built from the new modules (on the CPU the kernel's
    route runs the twin) encodes and decodes as the old composition from the
    same state dict, within 1e-6."""
    vae = _small_vae(config=config)
    old = _old_composition(vae)
    g = torch.Generator().manual_seed(6)
    x = torch.rand(2, 48, 40, 3, generator=g) * 2 - 1
    z = torch.randn(2, 6, 5, 4, generator=g)
    with torch.no_grad():
        for a, b in zip(vae.encode(x), old.encode(x)):
            assert (a - b).abs().max().item() <= 1e-6
        assert (vae.decode(z) - old.decode(z)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("config", [SMALL, NARROW], ids=["kernel", "plain"])
def test_cpu_calls_count_as_fallbacks_and_split_once(config):
    """On the CPU every VAE convolution takes the twin or the plain modules
    (``fallbacks``), no launch; a CUDA-less module keeps no TF32 halves."""
    vae = _small_vae(config=config)
    n = _convs(vae.decoder)
    launches, fallbacks = tvc.tally()
    with torch.no_grad():
        vae.decode(torch.zeros(1, 3, 4, 4))
    assert tvc.tally() == (launches, fallbacks + n)
    assert all(m._halves is None for m in vae.modules() if isinstance(m, tvae.VAEConv3x3))


def test_module_split_is_cached_until_the_weight_changes():
    conv = tvae.VAEConv3x3(32, 128)
    first = conv._split()
    assert conv._split() is first
    with torch.no_grad():
        conv.weight.mul_(2)
    second = conv._split()
    assert second is not first and torch.equal(second[0], tvc.split_weight(conv.weight)[0])


def _halves_match(conv):
    want = tvc.split_weight(conv.weight)
    return all(torch.equal(a, b) for a, b in zip(conv._split(), want))


def test_module_split_follows_reloads_that_assign():
    """``load_state_dict(assign=True)`` twice with no forward between: the
    halves are those of the weight loaded last. And a new Parameter over the
    same storage, at the same version, whose values change through ``.data``
    (no version bump): the halves follow the Parameter, not its address."""
    g = torch.Generator().manual_seed(9)
    conv = tvae.VAEConv3x3(32, 128)
    conv._split()
    for _ in range(2):
        state = {k: torch.randn(v.shape, generator=g) for k, v in conv.state_dict().items()}
        conv.load_state_dict(state, assign=True)
    assert torch.equal(conv.weight, state["weight"]) and _halves_match(conv)
    old = conv.weight
    conv._split()
    conv.weight = torch.nn.Parameter(old.detach())
    assert (conv.weight.data_ptr(), conv.weight._version) == (old.data_ptr(), old._version)
    conv.weight.data.mul_(3)
    assert _halves_match(conv)


def test_kernel_entry_refuses_a_gradient():
    """The kernel has no backward: with grad enabled and an input that
    requires grad, the launching wrapper raises before any launch."""
    x = torch.zeros(1, 8, 32, 128, requires_grad=True)
    w = torch.zeros(128, 128, 3, 3)
    p = tvc.plan(tuple(x.shape), x.dtype, 128, tvc.STRIDE1)
    with pytest.raises(ValueError, match="no backward"):
        tvc._launch(x, tvc.split_weight(w), torch.zeros(128), p, None, None)


def test_an_input_the_plan_refuses_raises():
    """On the card's route (meta, as CUDA) an input the plan does not take
    raises: no quiet fallback. An odd height at stride 2, a bf16 input."""
    with torch.device("meta"):
        down = tvae.VAEDownsample(128)
        conv = tvae.VAEConv3x3(128, 128)
        with pytest.raises(ValueError, match="even height"):
            down(torch.empty(1, 15, 16, 128))
        with pytest.raises(ValueError, match="bfloat16"):
            conv(torch.empty(1, 16, 16, 128, dtype=torch.bfloat16))
        assert tuple(down(torch.empty(1, 16, 16, 128)).shape) == (1, 8, 8, 128)


def test_meta_run_of_the_sdxl_vae_takes_the_kernel_everywhere():
    """On the meta device the VAE takes the card's route: every resnet,
    downsampler and upsampler convolution the plan takes (no B3, no
    composition), and the output shapes are the twin's."""
    with torch.device("meta"):
        vae = tvae.AutoencoderKL(VAEConfig.sdxl())
        launches, fallbacks = tvc.tally()
        mean, _ = vae.encode(torch.empty(1, 256, 192, 3))
        img = vae.decode(torch.empty(1, 32, 24, 4))
    assert tuple(mean.shape) == (1, 32, 24, 4) and tuple(img.shape) == (1, 256, 192, 3)
    assert tvc.tally() == (launches, fallbacks)


def _spans(fn):
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    got = list(SPANS)
    SPANS.clear()
    return got


def test_decode_and_encode_spans_count_the_vae_convolutions():
    """``pipeline.decode`` and ``train.vae_encode`` carry ``kernel_convs`` and
    ``fallback_convs``: on the CPU 0 and every VAE 3x3 convolution."""
    vae = _small_vae()
    dec, enc = _convs(vae.decoder), _convs(vae.encoder)
    with torch.no_grad():
        spans = _spans(lambda: _decode(vae, torch.zeros(1, 4, 5, 4), 0.13025))
        [rec] = [s for s in spans if s.name == "pipeline.decode"]
        assert (rec.attrs["kernel_convs"], rec.attrs["fallback_convs"]) == (0, dec)
        frozen = SimpleNamespace(vae=vae, vae_scaling=0.13025)
        spans = _spans(lambda: _encode_latents(frozen, torch.zeros(1, 32, 40, 3),
                                               torch.Generator().manual_seed(0), None))
        [rec] = [s for s in spans if s.name == "train.vae_encode"]
        assert (rec.attrs["kernel_convs"], rec.attrs["fallback_convs"]) == (0, enc)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("row", _unique(CELL_ROWS) + _unique(TILE_ROWS), ids=_label)
def test_kernel_error_is_no_larger_than_cudnns(cuda, row):
    """At batch 1: against an fp64 convolution of the same fp32 inputs
    (GroupNorm+SiLU in fp64 where the row has it), B9's RMS error is no larger
    than cuDNN's fp32 one and its largest error at most twice cuDNN's; the
    launch is counted."""
    case = TOOL.make_case(row, 1, cuda)
    before = tvc.launches
    err = TOOL.errors(case)
    assert tvc.launches == before + 1
    assert err["kernel_rms"] <= err["cudnn_rms"], err
    assert err["kernel_max"] <= 2 * err["cudnn_max"], err


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout,mode,gn,res", [
    ((2, 37, 50, 128), 256, tvc.STRIDE1, True, True),     # ragged tiles both ways
    ((1, 5, 3, 256), 128, tvc.STRIDE1, True, False),      # smaller than one tile
    ((2, 36, 52, 128), 128, tvc.STRIDE2, False, False),
    ((1, 18, 25, 256), 128, tvc.UPSAMPLE, False, False),
    ((1, 20, 40, 96), 128, tvc.STRIDE1, False, True),     # 3 channel chunks, no norm
])
def test_kernel_edges_against_fp64(cuda, shape, cout, mode, gn, res):
    """Partial tiles, a tile larger than the image, odd sizes: B9 within 1e-5
    (relative to the output's RMS) of fp64 at every element, one launch."""
    row = dict(shape=shape, cout=cout, mode=mode, gn=gn, res=res)
    case = TOOL.make_case(row, shape[0], cuda)
    with torch.no_grad():
        want = TOOL.reference64(case)
        before = tvc.launches
        got = TOOL.kernel_call(case)()
    torch.cuda.synchronize()
    scale = want.square().mean().sqrt().item()
    assert (got.double() - want).abs().max().item() <= 1e-5 * scale
    assert tvc.launches == before + 1


@pytest.mark.gpu
def test_kernel_pads_after_the_activation(cuda):
    """The case of ``test_padding_follows_the_activation`` at kernel widths:
    B9 against the twin on the same inputs."""
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(1, 12, 40, 128, generator=g) + 3.0).to(cuda)
    norm = _norm(128, 32, g, mean_shift=2.0).to(cuda).requires_grad_(False)
    conv = _conv(128, 128, g).to(cuda)
    with torch.no_grad():
        got = tvc.vae_conv3x3(x, conv.weight, conv.bias, tvc.STRIDE1, norm)
        want = tvc.vae_conv3x3_ref(x.cpu().double(), conv.weight.cpu().double(),
                                   conv.bias.cpu().double(), tvc.STRIDE1,
                                   SimpleNamespace(weight=norm.weight.cpu().double(),
                                                   bias=norm.bias.cpu().double(),
                                                   num_groups=32, eps=1e-6))
    scale = want.square().mean().sqrt().item()
    assert (got.cpu().double() - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.gpu
def test_sdxl_vae_on_card_takes_the_kernel_for_every_convolution(cuda):
    """A 256x192 encode and a 32x24-latent decode of the SDXL VAE with random
    weights: every resnet, downsampler and upsampler convolution launches
    B9 (23 and 31), none falls back, and the images agree with the CPU."""
    torch.manual_seed(8)
    vae = tvae.AutoencoderKL(VAEConfig.sdxl()).eval()
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(torch.randn_like(p) * (0.5 / max(1, p[0].numel()) ** 0.5)
                    if p.dim() > 1 else 1.0 + 0.1 * torch.randn_like(p))
    x = torch.rand(1, 256, 192, 3) * 2 - 1
    z = torch.randn(1, 32, 24, 4)
    with torch.no_grad():
        want_mean, want_img = vae.encode(x)[0], vae.decode(z)
        vae.to(cuda)
        before = tvc.tally()
        mean = vae.encode(x.to(cuda))[0]
        mid = tvc.tally()
        img = vae.decode(z.to(cuda))
    after = tvc.tally()
    assert (mid[0] - before[0], mid[1] - before[1]) == (23, 0)
    assert (after[0] - mid[0], after[1] - mid[1]) == (31, 0)
    for got, want in ((mean, want_mean), (img, want_img)):
        scale = want.square().mean().sqrt().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale
