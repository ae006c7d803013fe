"""The hand-written kernels against their plain twins, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode). The file imports torch only, so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py
"""

import pytest
import torch

from diffsensei_tpu_torch.ops import attention as tatt
from diffsensei_tpu_torch.ops import chunked_attention as tca
from diffsensei_tpu_torch.ops import dual_cross_attention as tdca
from diffsensei_tpu_torch.ops import flash_attention as tfa
from diffsensei_tpu_torch.ops import groupnorm as tgn
from diffsensei_tpu_torch.ops import int4_matmul as ti4
from diffsensei_tpu_torch.ops import single_pass_attention as tsp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d,causal,with_bias", [
    (2, 10, 4096, 4096, 64, False, False),
    (2, 20, 1024, 1024, 64, False, False),
    (2, 10, 4032, 4032, 64, False, False),
    (1, 4, 1100, 1300, 64, False, True),
    (1, 4, 1100, 1100, 64, True, False),
    (1, 4, 1024, 1024, 128, False, False),
    (1, 3, 37, 45, 64, False, False),        # one partial tile each way
    (2, 2, 130, 70, 128, False, True),       # bias broadcast over heads, D=128 tails
    (1, 2, 200, 130, 64, True, False),       # causal with Sq > Sk
    (1, 2, 63, 65, 64, False, False),        # one below / above the 64-row tile
    (1, 2, 65, 63, 64, True, False),         # the other way round, causal
    (1, 2, 130, 200, 64, False, False),      # a third q tile of 2 rows
    (1, 3, 100, 1, 64, False, False),        # a single key
    (2, 3, 130, 100, 64, False, True),       # bias broadcast over heads, batch 2
    # above 2048 keys the head_dim-64 forward streams 128-key tiles
    (1, 2, 130, 2100, 64, False, False),     # a ragged last tile of 52 keys
    (1, 2, 2200, 2100, 64, True, False),     # causal with Sq > Sk
    (2, 2, 100, 2177, 64, False, True),      # bias broadcast over heads, odd Sk
    (1, 1, 63, 4097, 64, False, False),      # one key past 32 tiles, a partial q tile
])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, sq, sk, d, causal, with_bias):
    """o within 2e-2 of the fp32 twin and within 5e-3 in relative Frobenius
    norm, lse within 1e-3, two calls bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda s: torch.randn((b, h, s, d), generator=g, device=cuda).bfloat16()
    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, 1, sq, sk), generator=g, device=cuda) > 0.3,
                           0.0, -10000.0)
    before = tfa.launches
    o, lse = tfa.flash_attention(q, k, v, bias, causal=causal)
    again = tfa.flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    ro, rlse = tfa.flash_attention_ref(q.float(), k.float(), v.float(), bias, causal)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert _rel(o, ro) <= 5e-3
    assert (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("sk", [90, 2100])   # 64- and 128-key tiles
def test_flash_forward_rows_without_a_key_on_card(cuda, sk):
    """A row whose every key the bias masks with -inf gets o = 0 and
    lse = -1e30; the other rows match the twin."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((1, 2, s, 64), generator=g, device=cuda).bfloat16()
               for s in (150, sk, sk))
    bias = torch.zeros((1, 2, 150, sk), device=cuda)
    dead = torch.tensor([0, 7, 64, 149], device=cuda)
    bias[:, :, dead] = float("-inf")
    bias[:, 1, 30, 50:] = float("-inf")       # a row with keys in the first tile only
    o, lse = tfa.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(o[:, :, dead], torch.zeros_like(o[:, :, dead]))
    assert bool((lse[:, :, dead] == -1e30).all())
    live = torch.ones(150, dtype=torch.bool, device=cuda)
    live[dead] = False
    ro, rlse = tfa.flash_attention_ref(q.float(), k.float(), v.float(), bias)
    assert (o[:, :, live].float() - ro[:, :, live]).abs().max().item() <= 2e-2
    assert (lse[:, :, live] - rlse[:, :, live]).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_flash_reads_misaligned_and_heads_merged_inputs_on_card(cuda):
    """A q view 2 bytes into its buffer goes through ``_aligned`` in the
    forward and in the backward kernels; k and v in the heads-merged layout
    are read through their strides."""
    g = torch.Generator(device=cuda).manual_seed(4)
    mk = lambda s: torch.randn((1, 4, s, 64), generator=g, device=cuda).bfloat16()
    q, k, v = _laid_out(mk(300), "offset"), _laid_out(mk(200), "bshd"), _laid_out(mk(200), "bshd")
    assert q.data_ptr() % 16 and k.stride(2) == 4 * 64
    q.requires_grad_()
    before = (tfa.launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    o, lse = tfa.flash_attention(q, k, v)
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    qf = q.detach().float().requires_grad_()
    ro, rlse = tfa.flash_attention_ref(qf, k.float(), v.float())
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3
    ro.square().sum().backward()
    assert _rel(q.grad, qf.grad) <= 2e-2


def _rel(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


def _laid_out(t, layout):
    """``t`` with the same values in another memory layout: ``"bhsd"`` as it
    is, ``"bshd"`` the heads-merged layout that ``_merge_heads``'s backward
    hands in, ``"offset"`` a copy 2 bytes into its buffer (not 16-byte
    aligned)."""
    if layout == "bshd":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    if layout == "offset":
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        return flat[1:1 + t.numel()].view(t.shape).copy_(t)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d,causal,bias_shape,do_layout", [
    (1, 10, 4096, 4096, 64, False, None, "bhsd"),   # UNet level 1 at 1024², batch 1
    (1, 20, 1024, 1024, 64, False, None, "bhsd"),   # UNet level 2
    (1, 4, 1100, 1300, 64, False, "b", "bhsd"),     # ragged tails, bias broadcast over heads
    (2, 3, 100, 130, 64, False, "bh", "bhsd"),      # bias broadcast over batch and heads
    (1, 4, 1100, 1100, 64, True, None, "bhsd"),     # causal
    (1, 2, 200, 130, 64, True, None, "bhsd"),       # causal with Sq > Sk
    (1, 2, 130, 300, 64, True, None, "bhsd"),       # causal with Sq < Sk
    (1, 4, 1024, 1024, 128, False, None, "bhsd"),   # head_dim 128
    (2, 2, 130, 70, 128, True, "b", "bhsd"),        # head_dim 128, causal, bias, tails
    (1, 3, 37, 45, 64, False, None, "bhsd"),        # one partial tile each way
    (1, 2, 63, 65, 64, False, None, "bhsd"),        # one below / above the 64-row tile
    (1, 2, 65, 63, 64, True, None, "bhsd"),         # the same the other way, causal
    (2, 2, 129, 127, 64, False, "b", "bhsd"),       # around two tiles, bias
    (1, 3, 100, 1, 64, False, None, "bhsd"),        # a single key
    (1, 2, 300, 40, 64, False, None, "bhsd"),       # Sk under one tile, Sq five tiles
    (1, 20, 1024, 1024, 64, False, None, "bshd"),   # dO heads-merged: the maps' strides
    (1, 4, 300, 200, 64, False, None, "offset"),    # dO misaligned: copied by _aligned
])
def test_flash_backward_kernels_match_plain_on_card(cuda, b, h, sq, sk, d, causal,
                                                    bias_shape, do_layout):
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda s: torch.randn((b, h, s, d), generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    do = _laid_out(do, do_layout)
    bias = None
    if bias_shape is not None:
        shape = (b, 1, sq, sk) if bias_shape == "b" else (1, 1, sq, sk)
        bias = torch.where(torch.rand(shape, generator=g, device=cuda) > 0.3, 0.0, -10000.0)
    o, lse = tfa.flash_attention(q, k, v, bias, causal=causal)
    before = (tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    got = tfa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    again = tfa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == (before[0] + 2, before[1] + 2)
    want = tfa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), bias, o.float(),
                                       lse, do.float(), causal)
    for name, x, y, z in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == torch.bfloat16 and x.shape == z.shape, name
        assert torch.equal(x, y), f"{name}: two calls differ"   # no float atomics
        if sk == 1 and name != "dv":
            # one key: P = 1 and dS = dP - delta vanish, dq and dk are rounding noise
            assert (x.float() - z).abs().max().item() <= 1e-3, name
        else:
            assert _rel(x, z) <= 2e-2, f"{name}: relative error {_rel(x, z)}"


@pytest.mark.gpu
def test_flash_autograd_uses_the_backward_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((1, 2, 1024, 64), generator=g, device=cuda).bfloat16()
               .requires_grad_() for _ in range(3))
    before = (tfa.launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    out = tatt.multi_head_attention(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    tatt.attention_ref(qf, kf, vf).square().sum().backward()
    for x, y in ((q, qf), (k, kf), (v, vf)):
        assert _rel(x.grad, y.grad) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,causal,with_bias", [
    (2, 10, 1024, 1024, False, False), (1, 4, 1100, 1300, False, True),
    (1, 4, 1100, 1100, True, False)])
def test_flash_op_is_the_kernel_on_card(cuda, b, h, sq, sk, causal, with_bias):
    """``diffsensei::flash_fwd`` on CUDA is B1: its ``(o, lse)`` bit-equal to
    a direct ``_flash_cuda`` call, o laid out heads-merged as the fake
    declares, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((b, h, s, 64), generator=g, device=cuda).bfloat16().requires_grad_()
               for s in (sq, sk, sk))
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, 1, sq, sk), generator=g, device=cuda) > 0.3,
                           0.0, -10000.0)
    before = tfa.launches
    o, lse = tfa.flash_fwd(q, k, v, bias, causal, 0.125)
    ro, rlse = tfa._flash_cuda(q.detach(), k.detach(), v.detach(), bias, causal, 0.125)
    torch.cuda.synchronize()
    assert tfa.launches == before + 2
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert o.stride() == tfa._heads_merged_like(q).stride() == ro.stride()
    assert lse.is_contiguous() and o.requires_grad and not lse.requires_grad


# B1 launches of one forward and backward of the cut-down UNet under each
# remat policy: 3 self-attentions at level 1's 1024 tokens, replayed unless
# the policy keeps the op's (o, lse)
REMAT_B1 = {None: 6, "dots": 6, "attn": 3, "dots_attn": 3, "dots_deepest": 6}


@pytest.mark.gpu
def test_remat_policies_keep_b1_on_card(cuda):
    """One backward of the cut-down UNet per policy: B1 launches by
    ``REMAT_B1``; B2 and B4 3, B3 44 (11 resnets, replayed) and B5 14 (7
    cross-attentions, replayed: not named) under all; every gradient
    bit-equal to full recompute's (a parameter that takes no gradient on this
    path takes none under any policy)."""
    unet = _cut_down_unet(cuda).requires_grad_(True)
    args, kw = _unet_call_inputs(cuda, unet.config)
    counts = lambda: (tfa.launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches,
                      tgn.launches, tdca.launches)
    grads = {}
    for policy, b1 in REMAT_B1.items():
        unet.enable_remat(policy)
        unet.zero_grad(set_to_none=True)
        before = counts()
        unet(*args, **kw).float().square().mean().backward()
        torch.cuda.synchronize()
        assert [a - z for a, z in zip(counts(), before)] == [b1, 3, 3, 44, 14], policy
        grads[policy] = {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}
    for policy in REMAT_B1:
        assert grads[policy].keys() == grads[None].keys()
        for name, g in grads[policy].items():
            assert torch.equal(g, grads[None][name]), (policy, name)


@pytest.mark.gpu
def test_groupnorm_autograd_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn((1, 32, 32, 320), generator=g, device=cuda)).bfloat16().requires_grad_()
    scale = torch.randn(320, generator=g, device=cuda).bfloat16().requires_grad_()
    bias = torch.randn(320, generator=g, device=cuda).bfloat16()
    before = tgn.launches
    tgn.groupnorm_silu(x, scale, bias, 32).float().square().sum().backward()
    assert tgn.launches == before + 1
    xf, sf = x.detach().requires_grad_(), scale.detach().requires_grad_()
    tgn.groupnorm_silu_ref(xf, sf, bias, 32).float().square().sum().backward()
    assert bias.grad is None
    torch.testing.assert_close(x.grad, xf.grad)
    torch.testing.assert_close(scale.grad, sf.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,eps", [
    ((2, 128, 128, 320), torch.bfloat16, 1e-5),
    ((2, 32, 32, 1280), torch.bfloat16, 1e-5),
    ((1, 256, 256, 128), torch.float32, 1e-6),
    ((3, 7, 9, 96), torch.bfloat16, 1e-5),   # 3 channels per group, ragged rows
    ((1, 33, 17, 64), torch.float32, 1e-6),  # 2 channels per group
])
def test_groupnorm_kernel_matches_plain_on_card(cuda, shape, dtype, eps):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    c = shape[-1]
    scale = torch.randn(c, generator=g, device=cuda).to(dtype)
    bias = torch.randn(c, generator=g, device=cuda).to(dtype)
    before = tgn.launches
    got = tgn.groupnorm_silu(x, scale, bias, 32, eps)
    torch.cuda.synchronize()
    assert tgn.launches == before + 1
    want = tgn.groupnorm_silu_ref(x, scale, bias, 32, eps)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else dict(rtol=0, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _gn_inputs(cuda, shape, dtype, param_dtype=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=g, device=cuda).to(param_dtype or dtype)
    bias = torch.randn(c, generator=g, device=cuda).to(param_dtype or dtype)
    return x, scale, bias


def _gn_agrees(got, want):
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _device_kernels(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,eps,route", [
    ((2, 128, 128, 320), torch.bfloat16, 1e-5, "resident"),   # 132 blocks, one an SM
    ((1, 96, 96, 512), torch.float32, 1e-6, "resident"),
    ((2, 128, 128, 640), torch.bfloat16, 1e-5, "streaming"),
    ((1, 1024, 1024, 128), torch.float32, 1e-6, "streaming"),  # the VAE's last level
])
def test_groupnorm_routes_on_card(cuda, shape, dtype, eps, route):
    """The plan's route at a shape, its kernels a call (1 resident, 2
    streaming, from the profiler), the twin's result within tolerance."""
    x, scale, bias = _gn_inputs(cuda, shape, dtype)
    p = tgn.plan(shape, dtype, 32)
    assert p.route == route
    before = tgn.launches
    got = tgn.groupnorm_silu(x, scale, bias, 32, eps)
    torch.cuda.synchronize()
    assert tgn.launches == before + 1
    _gn_agrees(got, tgn.groupnorm_silu_ref(x, scale, bias, 32, eps))
    assert _device_kernels(lambda: tgn.groupnorm_silu(x, scale, bias, 32, eps)) == p.kernels


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((2, 64, 64, 640), torch.bfloat16),     # resident
                                         ((1, 256, 256, 512), torch.float32)])   # streaming
def test_groupnorm_bit_equal_over_calls_and_streams(cuda, shape, dtype):
    """Two calls, and two calls on two streams at once, give the same bits."""
    x, scale, bias = _gn_inputs(cuda, shape, dtype)
    call = lambda: tgn.groupnorm_silu(x, scale, bias, 32, 1e-6)
    first, second = call(), call()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for s in streams:
        with torch.cuda.stream(s):
            outs.append(call())
    torch.cuda.synchronize()
    for y in (second, *outs):
        assert torch.equal(first, y)


# (route, dtype, vector bytes, shape, groups): a shape where the plan picks
# each route at each vector width the kernel is built for, from the row's
# bytes (C = 2 mod 4: 4-byte bf16 and 8-byte fp32 vectors; odd fp32 C: 4-byte
# ones; bf16 rows of more than 512 8-byte vectors: 16-byte ones) and from x's
# size or its groups (over 256 groups, or x over the resident grid's slabs:
# streaming). ``tests/test_torch_port_groupnorm.py`` checks the plan's picks
# on the CPU.
GN_WIDTH_CASES = [
    ("resident", torch.bfloat16, 8, (2, 40, 24, 320), 32),
    ("resident", torch.bfloat16, 16, (1, 16, 24, 2560), 32),
    ("resident", torch.bfloat16, 4, (2, 40, 24, 330), 30),
    ("resident", torch.float32, 16, (2, 40, 24, 320), 32),
    ("resident", torch.float32, 8, (2, 40, 24, 330), 30),
    ("resident", torch.float32, 4, (2, 40, 24, 99), 33),
    ("streaming", torch.bfloat16, 8, (2, 40, 24, 576), 288),
    ("streaming", torch.bfloat16, 16, (1, 80, 80, 2560), 1),
    ("streaming", torch.bfloat16, 4, (2, 40, 24, 578), 289),
    ("streaming", torch.float32, 16, (2, 40, 24, 576), 288),
    ("streaming", torch.float32, 8, (2, 40, 24, 578), 289),
    ("streaming", torch.float32, 4, (2, 40, 24, 867), 289),
]


@pytest.mark.gpu
@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("route,dtype,vec,shape,groups", GN_WIDTH_CASES,
                         ids=[f"{r}-{str(d)[6:]}-{v}" for r, d, v, *_ in GN_WIDTH_CASES])
def test_groupnorm_every_route_and_vector_width_on_card(cuda, route, dtype, vec, shape, groups,
                                                        param_dtype):
    """Each route at each vector width, where the plan picks it, against the
    twin, scale and bias in bf16 or fp32."""
    x, scale, bias = _gn_inputs(cuda, shape, dtype, param_dtype, seed=4)
    p = tgn.plan(shape, dtype, groups)
    assert (p.route, p.vec) == (route, vec)
    got = tgn.groupnorm_silu(x, scale, bias, groups, 1e-5)
    torch.cuda.synchronize()
    _gn_agrees(got, tgn.groupnorm_silu_ref(x, scale, bias, groups, 1e-5))


@pytest.mark.gpu
def test_groupnorm_rejects_what_the_kernel_does_not_take(cuda):
    x, scale, bias = _gn_inputs(cuda, (1, 8, 8, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tgn.groupnorm_silu(x.permute(0, 2, 1, 3), scale, bias, 32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tgn.groupnorm_silu(x.half(), scale, bias, 32)
    with pytest.raises(ValueError, match="scale"):
        tgn.groupnorm_silu(x, torch.ones(65, device=cuda), bias, 32)
    with pytest.raises(ValueError, match="scale"):
        tgn.groupnorm_silu(x, scale.cpu(), bias, 32)
    with pytest.raises(ValueError, match="bias"):
        tgn.groupnorm_silu(x, scale, bias.half(), 32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,groups", [
    ((2, 32, 32, 320), torch.float16, 32),     # a float16 UNet's ResnetBlock
    ((1, 8, 8, 33), torch.bfloat16, 3),        # odd bf16 rows: plan has no vector width
    ((1, 2, 2, 4160), torch.float32, 2),       # a group wider than 8 KB
])
def test_groupnorm_layer_runs_the_twin_for_what_the_kernel_does_not_take(cuda, shape, dtype,
                                                                          groups):
    """``FusedGroupNormSiLU`` on the card: an input the kernel does not take
    gives the twin's result and launches nothing; a bf16 input it takes still
    launches once."""
    from diffsensei_tpu_torch.models.layers import FusedGroupNormSiLU

    layer = FusedGroupNormSiLU(groups, shape[-1], dtype=dtype, device=cuda)
    x, scale, bias = _gn_inputs(cuda, shape, dtype)
    with torch.no_grad():
        layer.weight.copy_(scale)
        layer.bias.copy_(bias)
        before = tgn.launches
        got = layer(x)
        torch.cuda.synchronize()
        assert tgn.launches == before
        assert got.dtype == dtype and torch.equal(got, tgn.groupnorm_silu_ref(x, scale, bias,
                                                                            groups))
        if dtype == torch.float16:      # the same layer in bf16 runs the kernel
            layer.bfloat16()(x.bfloat16())
            assert tgn.launches == before + 1


@pytest.mark.gpu
def test_groupnorm_layer_raises_for_a_misaligned_input(cuda):
    """A bf16 x the kernel has a plan for but that starts off its vector
    width raises in ``FusedGroupNormSiLU`` instead of running the twin."""
    from diffsensei_tpu_torch.models.layers import FusedGroupNormSiLU

    layer = FusedGroupNormSiLU(32, 64, dtype=torch.bfloat16, device=cuda)
    x = torch.zeros(8 * 8 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(1, 8, 8, 64)
    before = tgn.launches
    with torch.no_grad(), pytest.raises(ValueError, match="alignment"):
        layer(x)
    assert tgn.launches == before


@pytest.mark.gpu
def test_dispatcher_sends_long_bf16_attention_to_the_kernel(cuda):
    q = torch.randn(1, 2, 1024, 64, device=cuda).bfloat16()
    short = torch.randn(1, 2, 77, 64, device=cuda).bfloat16()
    before = tfa.launches
    tatt.multi_head_attention(q, q, q)
    tatt.multi_head_attention(q, short, short)
    tatt.multi_head_attention(q.float(), q.float(), q.float())
    assert tfa.launches == before + 1


def _int4_operands(cuda, tokens, in_f, features, seed=0):
    """packed, scale and an fp32 x on the card; group scales around the served
    1 / (4.61 sqrt(in)), so outputs are of order 1."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    padded = ti4.padded_features(features, in_f, 128)
    packed = torch.randint(0, 256, (in_f, padded // 2), generator=g, device=cuda,
                           dtype=torch.uint8)
    scale = (torch.rand((in_f // 128, padded), generator=g, device=cuda) + 0.5) \
        / (4.61 * in_f ** 0.5)
    return packed, scale, torch.randn((tokens, in_f), generator=g, device=cuda)


def _int4_agrees(y, x, packed, scale):
    ref = x.float() @ ti4.dequantize(packed, scale, torch.bfloat16).float()
    torch.testing.assert_close(y, ref, rtol=2e-2, atol=2e-2)
    twin = ti4.int4_decode_fallback(x.float(), packed, scale)
    assert ((y - twin).norm() / twin.norm()).item() < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("tokens,in_f,features", [
    (1, 128, 256),          # one group, fewer than the cluster's blocks; one strip
    (3, 384, 300),          # odd features padded to 512
    (16, 384, 1000),        # padded to 1024; 16 tokens
    (16, 128, 256),
    (1, 5120, 32330),       # the agent's lm_head, padded to 32512: 127 strips
    (1, 13824, 512),        # 108 groups, not a multiple of the cluster's 8 blocks
    (1, 1024, 256),         # F = 256: one strip
])
def test_int4_kernel_matches_plain_on_card(cuda, tokens, in_f, features):
    packed, scale, x = _int4_operands(cuda, tokens, in_f, features)
    x = x.bfloat16()
    before = ti4.launches
    y = ti4.int4_decode_matmul(x, packed, scale)
    y2 = ti4.int4_decode_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert ti4.launches == before + 2
    assert y.dtype == torch.float32 and y.shape == (tokens, packed.shape[1] * 2)
    assert torch.equal(y, y2)                      # no float atomics: same bits
    _int4_agrees(y, x, packed, scale)


# the SEED-X LLaMA's per-rank layers under tensor parallelism: column shards
# (q/k/v/o out 5120/tp, gate/up 13824/tp, lm_head's ceil(32330/tp) rows,
# each padded on its own) and row shards (o's and down's inputs over tp)
TP_SHARD_SHAPES = [(5120, 2560), (5120, 6912), (6912, 5120), (2560, 5120), (5120, 16165),
                   (5120, 1280), (5120, 3456), (3456, 5120), (1280, 5120), (5120, 8083)]


@pytest.mark.gpu
@pytest.mark.parametrize("in_f,features", TP_SHARD_SHAPES)
def test_int4_kernel_at_tensor_parallel_shard_shapes_on_card(cuda, in_f, features):
    """B6 at T = 1 with fp32 x, as the sharded decode calls it: within 2e-2
    of the twin, two calls bit-equal, one launch each."""
    packed, scale, x = _int4_operands(cuda, 1, in_f, features, seed=in_f + features)
    assert ti4.kernel_eligible(in_f, 128)
    before = ti4.launches
    y = ti4.int4_decode_matmul(x, packed, scale)
    y2 = ti4.int4_decode_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert ti4.launches == before + 2
    assert torch.equal(y, y2)
    _int4_agrees(y, x, packed, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", range(1, 17))
def test_int4_kernel_every_token_count_on_card(cuda, tokens):
    packed, scale, x = _int4_operands(cuda, tokens, 640, 768, seed=tokens)
    y = ti4.int4_decode_matmul(x.bfloat16(), packed, scale)
    torch.cuda.synchronize()
    _int4_agrees(y, x.bfloat16(), packed, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("tokens,in_f,features", [
    (1, 5120, 5120), (1, 13824, 512), (5, 384, 512), (16, 256, 256)])
def test_int4_kernel_fp32_x_equals_its_bf16_rounding_on_card(cuda, tokens, in_f, features):
    packed, scale, x = _int4_operands(cuda, tokens, in_f, features)
    before = ti4.launches
    y = ti4.int4_decode_matmul(x, packed, scale)
    want = ti4.int4_decode_matmul(x.bfloat16(), packed, scale)
    torch.cuda.synchronize()
    assert ti4.launches == before + 2              # one launch a call, no cast
    assert torch.equal(y, want)


@pytest.mark.gpu
def test_int4_kernel_on_two_streams_at_once(cuda):
    ops = [_int4_operands(cuda, 1, 5120, 5120, seed=s) for s in (1, 2)]
    alone = [ti4.int4_decode_matmul(x, p, s) for p, s, x in ops]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in ops]
    outs = [[] for _ in ops]
    for _ in range(8):
        for (p, s, x), stream, out in zip(ops, streams, outs):
            with torch.cuda.stream(stream):
                out.append(ti4.int4_decode_matmul(x, p, s))
    torch.cuda.synchronize()
    for want, out in zip(alone, outs):
        assert all(torch.equal(y, want) for y in out)


@pytest.mark.gpu
def test_int4_kernel_rejects_what_it_does_not_take(cuda):
    packed = torch.zeros((256, 128), dtype=torch.uint8, device=cuda)
    scale = torch.ones((2, 256), device=cuda)
    x = torch.zeros((1, 256), device=cuda)
    assert ti4.int4_decode_matmul(x, packed, scale).shape == (1, 256)   # fp32 x is taken
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError):
            ti4.int4_decode_matmul(x.to(dtype), packed, scale)
    with pytest.raises(ValueError):
        ti4.int4_decode_matmul(torch.zeros((17, 256), device=cuda).bfloat16(), packed, scale)
    with pytest.raises(ValueError):
        ti4.int4_decode_matmul(x.bfloat16(), packed, scale[:1])


def _dual_operands(cuda, b, h, sq, d, n_text, n_ip, bias_shape, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda s: torch.randn((b, h, s, d), generator=g, device=cuda).bfloat16()
    bias = None
    if bias_shape is not None:
        bias = torch.where(torch.rand(bias_shape, generator=g, device=cuda) > 0.4, 0.0, -10000.0)
    return mk(sq), mk(n_text), mk(n_text), mk(n_ip), mk(n_ip), bias


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,d,n_text,n_ip,bias", [
    (2, 10, 4096, 64, 77, 80, "b"),          # UNet level 1 at 1024², batch 2
    (2, 20, 1024, 64, 77, 80, "b"),          # level 2
    (2, 10, 4032, 64, 77, 80, "b"),          # the 768x1344 bucket's odd tail
    (2, 20, 1008, 64, 77, 80, "1"),          # [1, 1, S, K] broadcast bias, odd tail
    (1, 3, 37, 64, 1, 128, "bh"),            # one text key, the most IP keys
    (2, 2, 130, 128, 128, 17, None),         # head_dim 128, no bias
    (1, 2, 64, 64, 16, 16, "b"),             # key counts a multiple of 16
    (2, 3, 200, 64, 128, 1, "1"),            # the most text keys, one IP key: element bias path
    (1, 2, 150, 64, 17, 77, "bh"),           # one past 16; 77 IP keys: element bias path
    (2, 2, 100, 64, 16, 128, "1"),           # bias broadcast over batch and heads
    (1, 2, 70, 128, 77, 80, "b"),            # head_dim 128 with a bias
    (1, 1, 300, 128, 128, 128, "bh"),        # head_dim 128, the most keys: one Q/bias buffer
])
def test_dual_cross_attention_kernel_matches_plain_on_card(cuda, b, h, sq, d, n_text, n_ip,
                                                           bias):
    shape = {"b": (b, 1, sq, n_ip), "1": (1, 1, sq, n_ip), "bh": (b, h, sq, n_ip),
             None: None}[bias]
    q, kt, vt, ki, vi, bias_t = _dual_operands(cuda, b, h, sq, d, n_text, n_ip, shape)
    before = tdca.launches
    got = tdca.dual_cross_attention(q, kt, vt, ki, vi, bias_t)
    again = tdca.dual_cross_attention(q, kt, vt, ki, vi, bias_t)
    torch.cuda.synchronize()
    assert tdca.launches == before + 2
    want = tdca.dual_cross_attention_ref(q.float(), kt.float(), vt.float(), ki.float(),
                                         vi.float(), bias_t)
    for name, x, y, z in zip(("o_text", "o_ip"), got, again, want):
        assert x.dtype == torch.bfloat16 and x.shape == z.shape, name
        assert torch.equal(x, y), f"{name}: two calls differ"
        assert (x.float() - z).abs().max().item() <= 2e-2, name
        assert torch.isfinite(x).all(), name


@pytest.mark.gpu
def test_dual_cross_attention_last_block_with_fewer_tiles_on_card(cuda):
    """A grid whose last block holds fewer q tiles than the others, at an Sq
    that is not a multiple of 64."""
    b, h = 2, 4
    for n_q in range(300, 330):   # the first run of q tiles that the blocks split unevenly
        sq = n_q * 64 - 5
        tiles = tdca.occupancy(b, h, sq, 77, 80)["tiles_per_block"]
        if tiles > 1 and n_q % tiles:
            break
    else:
        pytest.fail("no uneven split between 300 and 330 q tiles")
    q, kt, vt, ki, vi, bias = _dual_operands(cuda, b, h, sq, 64, 77, 80, (b, 1, sq, 80), 2)
    got = tdca.dual_cross_attention(q, kt, vt, ki, vi, bias)
    torch.cuda.synchronize()
    want = tdca.dual_cross_attention_ref(q.float(), kt.float(), vt.float(), ki.float(),
                                         vi.float(), bias)
    for x, z in zip(got, want):
        assert (x.float() - z).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_dual_cross_attention_autograd_and_unet_dispatch_on_card(cuda):
    q, kt, vt, ki, vi, bias = _dual_operands(cuda, 1, 4, 1024, 64, 77, 80, (1, 1, 1024, 80), 1)
    q.requires_grad_()
    ki.requires_grad_()
    before = tdca.launches
    o_text, o_ip = tdca.dual_cross_attention(q, kt, vt, ki, vi, bias)
    (o_text.float().square().sum() + o_ip.float().sum()).backward()
    assert tdca.launches == before + 1
    qf, kif = q.detach().float().requires_grad_(), ki.detach().float().requires_grad_()
    rt, ri = tdca.dual_cross_attention_ref(qf, kt.float(), vt.float(), kif, vi.float(), bias)
    (rt.square().sum() + ri.sum()).backward()
    assert _rel(q.grad, qf.grad) <= 2e-2 and _rel(ki.grad, kif.grad) <= 2e-2
    assert tdca.uses_kernel(q, kt, ki) and not tdca.uses_kernel(q.float(), kt, ki)
    assert not tdca.uses_kernel(q, torch.zeros(1, 4, 129, 64, device=cuda), ki)


@pytest.mark.gpu
def test_dual_cross_attention_rejects_what_it_does_not_take(cuda):
    q, kt, vt, ki, vi, bias = _dual_operands(cuda, 1, 2, 64, 64, 77, 80, (1, 1, 64, 80))
    with pytest.raises(ValueError):
        tdca.dual_cross_attention(q.float(), kt, vt, ki, vi, bias)           # fp32 q
    with pytest.raises(ValueError):
        tdca.dual_cross_attention(q, kt, vt, ki, vi, bias.bfloat16())        # bf16 bias
    long = torch.zeros((1, 2, 129, 64), device=cuda).bfloat16()
    with pytest.raises(ValueError):
        tdca.dual_cross_attention(q, kt, vt, long, long, None)               # 129 IP keys


def _cut_down_unet(cuda, quantized=False):
    """SDXL widths and heads, depth cut to one block a level: a 64x64 latent
    gives 1024 tokens at level 1 (B1) and 256 at level 2."""
    from diffsensei_tpu_torch.core.config import UNetConfig
    from diffsensei_tpu_torch.models.unet import UNetMangaModel
    from diffsensei_tpu_torch.utils.init import init_flax_like_

    cfg = UNetConfig(block_out_channels=(320, 640, 1280), transformer_layers_per_block=(0, 1, 1),
                     layers_per_block=1, mid_transformer_layers=1)
    unet = UNetMangaModel(cfg, torch.bfloat16, device=cuda, quantized=quantized)
    return init_flax_like_(unet, torch.Generator(device=cuda).manual_seed(0)).eval()


def _unet_call_inputs(cuda, cfg, lh=64, lw=64):
    from diffsensei_tpu_torch.models.unet import attention_levels, level_spatial_shape
    from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias

    m = cfg.manga
    g = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=cuda)
    boxes = torch.zeros((2, m.max_num_ips, 4), device=cuda)
    boxes[1, :2] = torch.tensor([[0.05, 0.1, 0.5, 0.95], [0.5, 0.2, 0.95, 0.9]])
    args = (rnd(2, lh, lw, 4), torch.full((2,), 400.0, device=cuda),
            rnd(2, 77, cfg.cross_attention_dim), rnd(2, cfg.pooled_projection_dim),
            torch.tensor([[512.0, 512, 0, 0, 512, 512]] * 2, device=cuda))
    kw = dict(ip_hidden_states=rnd(2, m.num_context_image_tokens, cfg.cross_attention_dim),
              ip_attn_bias={lv: build_ip_attention_bias(
                  boxes, *level_spatial_shape(cfg, lh, lw, lv), m.num_vision_tokens,
                  m.num_dummy_tokens) for lv in attention_levels(cfg)},
              ip_scale=0.6)
    return args, kw


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2])
def test_deep_cache_is_bit_exact_through_the_kernels_on_card(cuda, split):
    """``forward(x, deep_feature=full(x)[1])`` repeats ``full(x)[0]`` bit for
    bit with B1, B3 and B5 on the path; the cached call skips the deep
    subtree's launches."""
    unet = _cut_down_unet(cuda)
    args, kw = _unet_call_inputs(cuda, unet.config)
    counts = lambda: (tfa.launches, tgn.launches, tdca.launches)
    with torch.inference_mode():
        c0 = counts()
        full, deep = unet(*args, **kw, return_deep=True, cache_split=split)
        c1 = counts()
        cached = unet(*args, **kw, deep_feature=deep, cache_split=split)
        again, passed = unet(*args, **kw, deep_feature=deep, cache_split=split,
                             return_deep=True)
        c2 = counts()
        plain = unet(*args, **kw)
    torch.cuda.synchronize()
    full_calls = [b - a for a, b in zip(c0, c1)]
    cached_calls = [(b - a) // 2 for a, b in zip(c1, c2)]
    # (B1, B3, B5): B1 at level 1's 1024 tokens (3 layers), B3 in 11 resnets,
    # B5 in all 7 cross-attentions; a cached call at split 2 keeps levels 0 and
    # 1 (6 resnets, 3 layers), at split 1 level 0 only (3 resnets)
    assert full_calls == [3, 22, 7]
    assert cached_calls == ([3, 12, 3] if split == 2 else [0, 6, 0])
    assert torch.equal(full, cached) and torch.equal(full, again) and torch.equal(full, plain)
    assert passed is deep


@pytest.mark.gpu
def test_int8_cross_attention_runs_b5_like_its_twin_on_card(cuda):
    """The int8 ``MangaCrossAttention`` at SDXL level-1 width (640 channels,
    10 heads, 4096 tokens, CFG batch 2) in bf16 computes both attentions in
    one B5 launch; the same weights in fp32 take the plain twin."""
    import copy

    from diffsensei_tpu_torch.core.config import MangaConfig
    from diffsensei_tpu_torch.models.unet import MangaCrossAttention
    from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias
    from diffsensei_tpu_torch.utils.init import init_flax_like_

    m = MangaConfig()
    attn = MangaCrossAttention(640, 2048, 10, quantized=True, dtype=torch.bfloat16, device=cuda)
    init_flax_like_(attn, torch.Generator(device=cuda).manual_seed(2)).eval()
    assert attn.processor.to_k_ip.kernel_q.dtype == torch.int8
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 4096, 640), generator=g, device=cuda)
    ctx = torch.randn((2, 77, 2048), generator=g, device=cuda)
    ip = torch.randn((2, m.num_context_image_tokens, 2048), generator=g, device=cuda)
    boxes = torch.rand((2, m.max_num_ips, 4), generator=g, device=cuda).sort(-1).values
    bias = build_ip_attention_bias(boxes, 64, 64, m.num_vision_tokens, m.num_dummy_tokens)
    before = tdca.launches
    with torch.inference_mode():
        got = attn(x.bfloat16(), ctx.bfloat16(), ip.bfloat16(), bias, 0.6)
        want = copy.deepcopy(attn).float()(x, ctx, ip, bias, 0.6)
    torch.cuda.synchronize()
    assert tdca.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert ((got.float() - want).abs().max() / want.abs().max()).item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,n", [(1, 2, 1024, 2), (2, 2, 2048, 4), (1, 3, 1000, 8)])
def test_ring_schedule_on_b1_matches_one_b1_call_on_card(cuda, b, h, s, n):
    """The ring's chunks on B1 and their log-sum-exp merges, n ranks' worth
    in one process (``ring_schedule``), against B1 over the whole sequence:
    o within 2e-2 and 5e-3 in relative Frobenius norm, lse within 1e-3, n²
    launches."""
    from diffsensei_tpu_torch.ops import ring_attention as tra

    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((b, h, s, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    want_o, want_lse = tfa.flash_attention(q, k, v)
    before = tfa.launches
    o, lse = tra.ring_schedule(q, k, v, n, return_lse=True)
    assert tfa.launches - before == n * n
    err = (o.float() - want_o.float())
    assert err.abs().max().item() < 2e-2
    assert (err.norm() / want_o.float().norm()).item() < 5e-3
    assert (lse - want_lse).abs().max().item() < 1e-3
    # one rank of the ring is B1 itself: o cast through fp32 and back, exactly
    one, one_lse = tra.ring_schedule(q, k, v, 1, return_lse=True)
    assert torch.equal(one, want_o) and torch.equal(one_lse, want_lse)


def _experiment_inputs(cuda, seed, b, h, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((b, h, s, 64), generator=g, device=cuda).bfloat16()
            for s in (sq, sk, sk)]


def _held_to_twin(module, fn, twin, q, k, v, **kw):
    """The kernel within 4e-3 (max abs) and 5e-3 (relative Frobenius) of its
    plain twin on the same inputs, one launch a call, two calls bit-equal."""
    before = module.launches
    o, again = fn(q, k, v, **kw), fn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert module.launches == before + 2
    assert o.dtype == torch.bfloat16 and o.shape == q.shape and torch.equal(o, again)
    ref = twin(q, k, v, **kw).float()
    diff = o.float() - ref
    assert diff.abs().max().item() <= 4e-3
    assert (diff.norm() / ref.norm()).item() <= 5e-3


def _held_to_b1(o, q, k, v):
    """An experiment's output within the same limits of B1's on the same inputs."""
    ref = tfa.flash_attention(q, k, v)[0].float()
    diff = o.float() - ref
    assert diff.abs().max().item() <= 4e-3
    assert (diff.norm() / ref.norm()).item() <= 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", tca.CHUNKS)
@pytest.mark.parametrize("b,h,sq,sk", [
    (2, 20, 1024, 1024),    # UNet level 2 at 1024²
    (2, 10, 4096, 4096),    # UNet level 1
    (2, 10, 16384, 16384),  # the tools' longest shape, 32-256 chunks a row
    (1, 2, 100, 1024),      # a partial q tile, sq != kv
    (1, 2, 64, 2048),       # one q tile: at 256 and 512 a block's second warpgroup has no rows
])
def test_chunked_kernel_matches_plain_on_card(cuda, chunk, b, h, sq, sk):
    q, k, v = _experiment_inputs(cuda, 16, b, h, sq, sk)
    _held_to_twin(tca, tca.chunked_attention, tca.chunked_attention_ref, q, k, v, chunk=chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", tca.CHUNKS)
@pytest.mark.parametrize("chunks", [1, 2])
def test_chunked_kernel_at_one_and_two_chunks_on_card(cuda, chunk, chunks):
    """B7 where its pipeline has edges: one chunk (no next chunk's S in
    flight, the ring's first fill only) and two (one hand-over), a partial q
    tile; held to the twin and to B1, two calls bit-equal."""
    q, k, v = _experiment_inputs(cuda, 21, 1, 3, 130, chunk * chunks)
    _held_to_twin(tca, tca.chunked_attention, tca.chunked_attention_ref, q, k, v, chunk=chunk)
    _held_to_b1(tca.chunked_attention(q, k, v, chunk=chunk), q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk", [
    (2, 20, 1024, 1024),    # a cluster of 2
    (2, 10, 4096, 4096),    # a cluster of 8
    (1, 2, 100, 37),        # one block, a ragged last key tile, a partial q tile
    (1, 3, 130, 1100),      # a cluster of 3, 6 + 6 + 6 tiles, the last ragged
    (2, 2, 64, 520),        # a cluster of 2 with 5 + 4 tiles
])
def test_single_pass_kernel_matches_plain_on_card(cuda, b, h, sq, sk):
    q, k, v = _experiment_inputs(cuda, 17, b, h, sq, sk)
    _held_to_twin(tsp, tsp.single_pass_attention, tsp.single_pass_attention_ref, q, k, v,
                  block_q=sq)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk", [
    (1, 2, 64, 1),          # one key: a cluster of one block, all but one key masked
    (1, 2, 100, 63),        # a ragged tile inside the first warpgroup's half
    (1, 2, 130, 257),       # one key into the second warpgroup's half
    (1, 3, 64, 511),        # one block, a ragged last tile
    (2, 2, 190, 513),       # a cluster of 2, one key in the second block
    (1, 4, 1000, 1000),     # a cluster of 2, Sq not a multiple of 64
    (1, 2, 257, 4095),      # a cluster of 8, ragged, 1-row last q tile
    (1, 2, 1, 4096),        # one query row, a cluster of 8
    (4, 16, 2048, 4096),    # 64 clusters of 8, more than resident: each walks many q tiles
])
def test_single_pass_kernel_at_its_edges_on_card(cuda, b, h, sq, sk):
    """B8 where its design has edges: the key split over a cluster of 1-8
    blocks and two warpgroups a block, ragged key and query tiles, and the
    loop over q tiles (double-buffered exchanges) at many tiles a cluster;
    held to the twin and to B1 at the smoke's limits, two calls bit-equal."""
    q, k, v = _experiment_inputs(cuda, 19, b, h, sq, sk)
    _held_to_twin(tsp, tsp.single_pass_attention, tsp.single_pass_attention_ref, q, k, v,
                  block_q=sq)
    _held_to_b1(tsp.single_pass_attention(q, k, v, block_q=sq), q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["chunked", "single"])
def test_attention_experiments_take_strided_inputs_on_card(cuda, kind):
    """q, k and v as views of one packed [B, S, 3, H, 64] tensor (strides
    that are not contiguous): the same bits as contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(20)
    qkv = torch.randn((2, 1024, 3, 4, 64), generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    fn = tca.chunked_attention if kind == "chunked" else tsp.single_pass_attention
    kw = dict(chunk=256) if kind == "chunked" else dict(block_q=512)
    o = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, fn(*(t.contiguous() for t in (q, k, v)), **kw))
    _held_to_b1(o, q, k, v)


@pytest.mark.gpu
def test_attention_experiments_refuse_what_they_do_not_take_on_card(cuda):
    q, k, v = _experiment_inputs(cuda, 18, 1, 2, 128, 2048)
    with pytest.raises(ValueError, match="1024 would take four"):
        tca.chunked_attention(q, k, v, chunk=1024)
    with pytest.raises(ValueError, match="at most 4096 keys, got 16384"):
        big = torch.zeros((1, 1, 16384, 64), dtype=torch.bfloat16, device=cuda)
        tsp.single_pass_attention(big[:, :, :64], big, big)
    for fn in (tca.chunked_attention, tsp.single_pass_attention):
        with pytest.raises(ValueError, match="bfloat16"):
            fn(q.float(), k.float(), v.float())
        with pytest.raises(ValueError, match="head_dim 64"):
            fn(*(torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16, device=cuda)
                 for _ in range(3)))
    with pytest.raises(ValueError, match="must divide"):
        tca.chunked_attention(q, k, v, block_k=1536)
    with pytest.raises(ValueError, match="unwritten"):
        tsp.single_pass_attention(q, k, v, block_q=96)
