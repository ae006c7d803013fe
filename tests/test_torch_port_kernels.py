"""The hand-written kernels against their plain twins, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode). The file imports torch only, so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py
"""

import pytest
import torch

from diffsensei_tpu_torch.ops import attention as tatt
from diffsensei_tpu_torch.ops import flash_attention as tfa
from diffsensei_tpu_torch.ops import groupnorm as tgn


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
])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, sq, sk, d, causal, with_bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda s: torch.randn((b, h, s, d), generator=g, device=cuda).bfloat16()
    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, 1, sq, sk), generator=g, device=cuda) > 0.3,
                           0.0, -10000.0)
    before = tfa.launches
    o, lse = tfa.flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    ro, rlse = tfa.flash_attention_ref(q.float(), k.float(), v.float(), bias, causal)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3


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


@pytest.mark.gpu
def test_dispatcher_sends_long_bf16_attention_to_the_kernel(cuda):
    q = torch.randn(1, 2, 1024, 64, device=cuda).bfloat16()
    short = torch.randn(1, 2, 77, 64, device=cuda).bfloat16()
    before = tfa.launches
    tatt.multi_head_attention(q, q, q)
    tatt.multi_head_attention(q, short, short)
    tatt.multi_head_attention(q.float(), q.float(), q.float())
    assert tfa.launches == before + 1
