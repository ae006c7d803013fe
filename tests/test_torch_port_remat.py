"""The named remat policies of the port against full recompute and the JAX
package (CPU, fp32).

A policy changes what the backward keeps, never a value: each UNet policy's
gradients are bit-equal to full recompute's in the port and within 5e-4 of
each tensor's largest magnitude of the JAX ``UNetMangaModel(remat_blocks=True,
remat_policy=...)`` gradients (``tests/test_deep_stacks.py``'s check, held
across packages). The flash route is forced on the CPU by routing the
self-attention's keys (at least ``FLASH_MIN_KV``, patched) to
``diffsensei::flash_fwd``, whose CPU implementation is the plain twin: under
``attn`` its forward runs once a ``backward()``, under full recompute twice
(the JAX counterpart counts kernels in ``tests/test_flash_backward.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsensei_tpu.core.config import UNetConfig as JUNetConfig
from diffsensei_tpu.models.unet import UNetMangaModel as JUNet, attention_levels
from diffsensei_tpu.ops.masked_ip import build_ip_attention_bias

from diffsensei_tpu_torch.core.config import LlamaConfig, UNetConfig
from diffsensei_tpu_torch.models import remat
from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM
from diffsensei_tpu_torch.models.unet import UNetMangaModel
from diffsensei_tpu_torch.ops import attention, flash_attention as fa
from diffsensei_tpu_torch.train import cli
from diffsensei_tpu_torch.utils import from_jax
from diffsensei_tpu_torch.utils.init import init_flax_like_

from tests.torch_port_util import random_tree

torch.set_num_threads(1)

# three levels, so that dots_deepest (level 2) differs from dots (levels 1, 2)
CFG = dict(block_out_channels=(32, 32, 64), transformer_layers_per_block=(0, 2, 1))
H = W = 20            # level 1: 100 keys (flash when patched), level 2: 25 keys (plain)
FLASH_KEYS = 78       # above the 77 text keys: only level 1's self-attention
FLASH_CALLS = 6       # level-1 transformer blocks: 1 x 2 down, 2 x 2 up


def _inputs(cfg):
    manga = cfg.manga
    rng = np.random.default_rng(4)
    boxes = np.zeros((1, manga.max_num_ips, 4), np.float32)
    boxes[0] = [[0.0, 0.0, 0.5, 1.0], [0.4, 0.2, 1.0, 0.9]]
    dialog = np.zeros((1, manga.max_num_dialogs, 4), np.float32)
    dialog[0, 0] = [0.1, 0.1, 0.6, 0.4]
    args = [rng.normal(size=(1, H, W, 4)).astype(np.float32), np.array([301.0], np.float32),
            rng.normal(size=(1, 77, cfg.cross_attention_dim)).astype(np.float32),
            rng.normal(size=(1, cfg.pooled_projection_dim)).astype(np.float32),
            np.array([[160, 160, 0, 0, 160, 160]], np.float32)]
    kw = dict(ip_hidden_states=rng.normal(size=(1, manga.num_context_image_tokens,
                                                cfg.cross_attention_dim)).astype(np.float32),
              ip_attn_bias={lv: np.asarray(build_ip_attention_bias(
                  jnp.asarray(boxes), -(-H // 2 ** lv), -(-W // 2 ** lv),
                  manga.num_vision_tokens, manga.num_dummy_tokens))
                  for lv in attention_levels(cfg)},
              ip_scale=0.7, dialog_bbox=dialog)
    return args, kw


@pytest.fixture(scope="module")
def stack():
    """(port config, JAX config, JAX weights, inputs) of the 3-level UNet."""
    jcfg = dataclasses.replace(JUNetConfig.tiny(), **CFG)
    tcfg = dataclasses.replace(UNetConfig.tiny(), **CFG)
    args, kw = _inputs(jcfg)
    jkw = dict(kw, ip_attn_bias={k: jnp.asarray(v) for k, v in kw["ip_attn_bias"].items()})
    params = random_tree(JUNet(jcfg), *map(jnp.asarray, args), seed=5, **jkw)
    params["params"]["dialog_bbox_embedding"] = np.linspace(
        -1, 1, tcfg.block_out_channels[0]).astype(np.float32)
    return tcfg, jcfg, params, (args, kw, jkw)


@pytest.fixture(scope="module")
def jax_grads(stack):
    """The JAX gradients of ``sum(out ** 2)`` under each policy, in the
    port's names, computed once a policy."""
    _, jcfg, params, (args, _, jkw) = stack
    cache = {}

    def get(policy):
        if policy not in cache:
            model = JUNet(jcfg, remat_blocks=True, remat_policy=policy)
            grads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.square(
                model.apply(p, *map(jnp.asarray, args), **jkw)))))(params)
            cache[policy] = from_jax.sdxl_unet(jax.tree.map(np.asarray, grads), jcfg)
        return cache[policy]
    return get


def _port_grads(stack, policy):
    tcfg, _, params, (args, kw, _) = stack
    unet = UNetMangaModel(tcfg)
    unet.load_state_dict(from_jax.to_tensors(from_jax.sdxl_unet(params, tcfg)))
    unet.enable_remat(policy)
    t = lambda a: torch.from_numpy(np.array(a))
    out = unet(*map(t, args), ip_hidden_states=t(kw["ip_hidden_states"]),
               ip_attn_bias={k: t(v) for k, v in kw["ip_attn_bias"].items()},
               ip_scale=kw["ip_scale"], dialog_bbox=t(kw["dialog_bbox"]))
    out.square().sum().backward()
    return {n: p.grad for n, p in unet.named_parameters()}


@pytest.fixture(scope="module")
def full_remat(stack):
    """The port's full-recompute gradients by route, computed once a route
    (the caller has set the route up)."""
    cache = {}

    def get(route):
        if route not in cache:
            cache[route] = _port_grads(stack, None)
        return cache[route]
    return get


@pytest.fixture
def flash_route(monkeypatch):
    """Send every attention with at least ``FLASH_KEYS`` keys through
    ``flash_attention`` (the op on the CPU) and count the op's forwards."""
    calls = []
    ref = fa.flash_attention_ref
    monkeypatch.setattr(attention, "FLASH_MIN_KV", FLASH_KEYS)
    monkeypatch.setattr(attention, "uses_flash",
                        lambda q, k: k.shape[2] >= attention.FLASH_MIN_KV)
    monkeypatch.setattr(fa, "flash_attention_ref",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    return calls


def _close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=name)


@pytest.mark.parametrize("route", ["plain", "flash"])
@pytest.mark.parametrize("policy", remat.POLICIES)
def test_unet_policy_grads_equal_full_remat_and_jax(stack, jax_grads, full_remat, policy,
                                                    route, request):
    if route == "flash":
        request.getfixturevalue("flash_route")
    full = full_remat(route)
    got = _port_grads(stack, policy)
    want = jax_grads(policy)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert torch.equal(g, full[name]), name
        _close(g, want[name], 5e-4, name)


@pytest.mark.parametrize("policy,forwards", [
    (None, 2 * FLASH_CALLS), ("dots", 2 * FLASH_CALLS), ("attn", FLASH_CALLS),
    ("dots_attn", FLASH_CALLS), ("dots_deepest", 2 * FLASH_CALLS)])
def test_flash_op_forward_is_kept_under_attn(stack, flash_route, policy, forwards):
    """One ``backward()``: the op's forward runs once a self-attention where
    the policy keeps ``(o, lse)``, twice (forward and replay) where not."""
    _port_grads(stack, policy)
    assert len(flash_route) == forwards


def test_flash_op_keeps_the_kernel_layout():
    """The op's o is laid out heads-merged, as the kernel writes it (and as
    the fake declares it), so that merging the heads is free; lse is
    ``[B, H, S]`` fp32 and takes no gradient; the values are the twin's."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 16, generator=g, requires_grad=True) for _ in range(3))
    o, lse = fa.flash_fwd(q, k, v, None, False, 0.25)
    ro, rlse = fa.flash_attention_ref(q, k, v, None, False, 0.25)
    assert o.stride() == fa._heads_merged_like(q).stride() and lse.is_contiguous()
    assert torch.equal(o, ro) and torch.equal(lse, rlse) and not lse.requires_grad
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    fake = [mode.from_tensor(t.detach()) for t in (q, k, v)]
    with mode:
        fo, flse = fa.flash_fwd(*fake, None, False, 0.25)
    assert fo.stride() == o.stride() and flse.stride() == lse.stride()
    o.sum().backward()
    want = fa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), None, o.detach(),
                                      lse, torch.ones_like(o), False, 0.25)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


def test_no_grad_calls_do_not_go_through_the_op(monkeypatch):
    """Serving (no gradient) calls B1's wrapper directly: the op's Python
    dispatch is for the calls that need a gradient."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g) for _ in range(3))
    monkeypatch.setattr(fa, "flash_fwd", lambda *a: pytest.fail("went through the op"))
    o, lse = fa.flash_attention(q, k, v)
    with torch.no_grad():
        fa.flash_attention(*(t.requires_grad_() for t in (q, k, v)))
    want = fa.flash_attention_ref(q, k, v)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


def test_unknown_policies_raise():
    with pytest.raises(ValueError, match="unknown remat policy"):
        UNetMangaModel(UNetConfig.tiny(), device="meta").enable_remat("dots_everything")
    llm = LlamaForCausalLM(LlamaConfig.tiny(), device="meta")
    for name in ("dots", "full"):
        with pytest.raises(ValueError, match="unknown remat policy"):
            llm.enable_remat(name)


def _llama_grads(policy):
    torch.manual_seed(0)
    llm = LlamaForCausalLM(LlamaConfig.tiny(), lora_rank=4)
    init_flax_like_(llm, torch.Generator().manual_seed(1))
    llm.enable_remat(policy)
    ids = torch.from_numpy(np.random.default_rng(2).integers(3, 200, (2, 24)))
    logits = llm(ids, positions=torch.arange(24)[None].expand(2, -1))[0]
    logits.float().square().mean().backward()
    return {n: p.grad for n, p in llm.named_parameters() if p.grad is not None}


def test_agent_attn_policy_grads_equal_full_remat(monkeypatch):
    """``remat_policy: attn`` on the LLaMA keeps each layer's plain attention
    product (named ``attn_out``; the 24-token attention is not flash) and
    gives full recompute's gradients bit for bit."""
    saved = []
    named = remat._saves_attn
    monkeypatch.setattr(remat, "_saves_attn",
                        lambda func: named(func) and (saved.append(func) or True))
    full = _llama_grads(None)
    assert not saved
    got = _llama_grads("attn")
    assert len(saved) == LlamaConfig.tiny().num_layers     # one product a layer, forward only
    assert sorted(got) == sorted(full) and got
    for name, g in got.items():
        assert torch.equal(g, full[name]), name


def test_cli_trains_stage3_under_the_agent_attn_policy(tmp_path):
    """``model.agent.remat_policy: attn`` through the CLI's ``stage: mllm``:
    the step's trainables equal those of full recompute bit for bit."""
    from tests.test_torch_port_stage3 import _write_run

    cfg = _write_run(tmp_path, max_train_steps=1)
    states = {}
    for policy in ("null", "attn"):
        with open(cfg) as f:
            text = f.read()
        with open(cfg, "w") as f:
            f.write(text.replace("    remat: true\n",
                                 f"    remat: true\n    remat_policy: {policy}\n", 1)
                    if policy == "null" else
                    text.replace("remat_policy: null", "remat_policy: attn"))
        states[policy] = cli.main(["--config", cfg, "--device", "cpu", "--log_dir",
                                   os.fspath(tmp_path / policy)])
    assert states["attn"].step == 1
    for name, p in states["null"].params.items():
        assert torch.equal(states["attn"].params[name], p), name
