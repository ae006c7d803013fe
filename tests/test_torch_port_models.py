"""The PyTorch port's models against the JAX package, on the CPU, in fp32.

Each JAX module is initialized at a tiny size, its weights cross to the port
through ``diffsensei_tpu_torch.utils.from_jax`` (loaded strictly, so every name
must match), and both see the same numpy inputs. The bound is the one the JAX
package holds against its torch oracles: atol 5e-4 in fp32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsensei_tpu.core.config import (
    ResamplerConfig, TextEncoderConfig, UNetConfig, VAEConfig, VisionEncoderConfig)
from diffsensei_tpu.models import layers as jlayers
from diffsensei_tpu.models import schedulers as jsched
from diffsensei_tpu.models.projection import (
    ImageProjDummyModel as JImageProjDummyModel, ImageProjModel as JImageProjModel)
from diffsensei_tpu.models.resampler import Resampler as JResampler
from diffsensei_tpu.models.text_encoder import CLIPTextEncoder as JText
from diffsensei_tpu.models.unet import UNetMangaModel as JUNet, attention_levels
from diffsensei_tpu.models.vae import AutoencoderKL as JVAE
from diffsensei_tpu.models.vision_encoder import VisionTransformer as JViT
from diffsensei_tpu.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu.utils import port_torch

from diffsensei_tpu_torch.models import layers as tlayers
from diffsensei_tpu_torch.models import schedulers as tsched
from diffsensei_tpu_torch.models.projection import (
    ImageProjDummyModel as TImageProjDummyModel, ImageProjModel as TImageProjModel)
from diffsensei_tpu_torch.models.resampler import Resampler as TResampler
from diffsensei_tpu_torch.models.text_encoder import CLIPTextEncoder as TText
from diffsensei_tpu_torch.models.unet import UNetMangaModel as TUNet
from diffsensei_tpu_torch.models.vae import AutoencoderKL as TVAE
from diffsensei_tpu_torch.models.vision_encoder import VisionTransformer as TViT
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import random_tree as _random_tree

torch.set_num_threads(1)
ATOL = 5e-4


def _apply(module, params, *args, **kwargs):
    return jax.jit(lambda p, a, kw: module.apply(p, *a, **kw))(params, args, kwargs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _assert_same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _load(module, sd):
    module.load_state_dict(from_jax.to_tensors(sd))
    return module.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 500.0, 999.0, 1024.0], np.float32)
    # sin/cos of fp32 arguments near 1000 rad: one ulp of the argument is 6e-5
    _close(tlayers.timestep_embedding(_t(t), 320),
           jlayers.timestep_embedding(jnp.asarray(t), 320), atol=2e-4)


@pytest.mark.parametrize("cin,cout,eps", [(8, 16, 1e-5), (16, 16, 1e-6)])
def test_resnet_block_matches_jax(cin, cout, eps):
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(2, 6, 5, cin)).astype(np.float32)
    temb = rng.normal(size=(2, 12)).astype(np.float32)
    jm = jlayers.ResnetBlock2D(out_channels=cout, norm_num_groups=4, norm_eps=eps)
    params = _random_tree(jm, jnp.asarray(x), jnp.asarray(temb), seed=cin)
    sd = {}
    from_jax._resnet(sd, "", params["params"])
    tm = _load(tlayers.ResnetBlock2D(cin, cout, 4, 12, eps), sd)
    _close(tm(_t(x), _t(temb)), _apply(jm, params, jnp.asarray(x), jnp.asarray(temb)))


@pytest.mark.parametrize("size,out", [((4, 5), None), ((4, 5), (7, 9)), ((3, 3), (5, 6))])
def test_upsample_matches_jax(size, out):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, *size, 8)).astype(np.float32)
    jm = jlayers.Upsample2D(out_channels=8)
    params = _random_tree(jm, jnp.asarray(x), out, seed=1)
    sd = {}
    from_jax._conv(sd, "conv", params["params"]["conv"])
    tm = _load(tlayers.Upsample2D(8), sd)
    _close(tm(_t(x), out), jm.apply(params, jnp.asarray(x), out))


def test_geglu_feed_forward_matches_jax_in_fp32_and_bf16():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jm = jlayers.GEGLUFeedForward(dim=16)
    params = _random_tree(jm, jnp.asarray(x), seed=2)
    sd = {}
    from_jax._lin(sd, "net.0.proj", params["params"]["proj_in"])
    from_jax._lin(sd, "net.2", params["params"]["proj_out"])
    tm = _load(tlayers.GEGLUFeedForward(16), sd)
    _close(tm(_t(x)), jm.apply(params, jnp.asarray(x)))

    def by_hand(ff, x, approximate):   # the GELU policy, ROADMAP trap C2
        h, gate = ff.net[0].proj(x).chunk(2, dim=-1)
        return ff.net[2](h * torch.nn.functional.gelu(gate, approximate=approximate))

    with torch.no_grad():
        assert torch.equal(tm(_t(x)), by_hand(tm, _t(x), "none"))
        tb, xb = tm.to(torch.bfloat16), _t(x).bfloat16()
        assert torch.equal(tb(xb), by_hand(tb, xb, "tanh"))
    jb = jlayers.GEGLUFeedForward(dim=16, dtype=jnp.bfloat16)
    want = np.asarray(jb.apply(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    _close(tb(xb).float(), want, atol=3e-2)


# ---------------------------------------------------------------------------
# the UNet
# ---------------------------------------------------------------------------
def test_tiny_unet_forward_matches_jax():
    cfg = UNetConfig.tiny()
    manga = cfg.manga
    rng = np.random.default_rng(3)
    b, h, w = 2, 12, 10                      # odd level-1 size: 6x5 -> 3x3 at level 2
    lat = rng.normal(size=(b, h, w, 4)).astype(np.float32)
    ts = np.array([951.0, 951.0], np.float32)
    ctx = rng.normal(size=(b, 77, cfg.cross_attention_dim)).astype(np.float32)
    pooled = rng.normal(size=(b, cfg.pooled_projection_dim)).astype(np.float32)
    time_ids = np.tile(np.array([[96, 80, 0, 0, 96, 80]], np.float32), (b, 1))
    ip = rng.normal(size=(b, manga.num_context_image_tokens,
                          cfg.cross_attention_dim)).astype(np.float32)
    boxes = np.zeros((b, manga.max_num_ips, 4), np.float32)
    boxes[1] = [[0.0, 0.0, 0.5, 1.0], [0.4, 0.2, 1.0, 0.9]]
    dialog = np.zeros((b, manga.max_num_dialogs, 4), np.float32)
    dialog[1, 0] = [0.1, 0.1, 0.6, 0.4]
    biases = {lv: np.asarray(build_ip_attention_bias(
        jnp.asarray(boxes), -(-h // 2 ** lv), -(-w // 2 ** lv),
        manga.num_vision_tokens, manga.num_dummy_tokens)) for lv in attention_levels(cfg)}

    jm = JUNet(cfg)
    args = (jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(pooled),
            jnp.asarray(time_ids))
    kw = dict(ip_hidden_states=jnp.asarray(ip), ip_scale=0.7,
              ip_attn_bias={k: jnp.asarray(v) for k, v in biases.items()},
              dialog_bbox=jnp.asarray(dialog))
    params = _random_tree(jm, *args, seed=3, **kw)
    params["params"]["dialog_bbox_embedding"] = rng.normal(
        size=(cfg.block_out_channels[0],)).astype(np.float32)
    want = _apply(jm, params, *args, **kw)

    tm = _load(TUNet(cfg), from_jax.sdxl_unet(params, cfg))
    with torch.no_grad():
        got = tm(_t(lat), _t(ts), _t(ctx), _t(pooled), _t(time_ids),
                 ip_hidden_states=_t(ip), ip_scale=0.7,
                 ip_attn_bias={k: _t(v) for k, v in biases.items()},
                 dialog_bbox=_t(dialog))
    _close(got, want)


# ---------------------------------------------------------------------------
# encoders, resampler, VAE decoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("projection", [None, 16])
def test_text_encoder_matches_jax(projection):
    cfg = TextEncoderConfig.tiny(projection_dim=projection)
    if projection:   # the bigG flavour: exact GELU and a projection
        cfg = dataclasses.replace(cfg, hidden_act="gelu")
    ids = np.random.default_rng(4).integers(1, 255, (2, 77)).astype(np.int32)
    ids[0, 30] = 255                          # a distinct argmax (EOS) position
    jm = JText(cfg)
    params = _random_tree(jm, jnp.asarray(ids), seed=4)
    jpen, jpool = _apply(jm, params, jnp.asarray(ids))
    tm = _load(TText(cfg), from_jax.clip_text(params, cfg.num_layers))
    with torch.no_grad():
        pen, pool = tm(_t(ids).long())
    _close(pen, jpen)
    _close(pool, jpool)


@pytest.mark.parametrize("mae", [False, True])
def test_vision_encoder_matches_jax(mae):
    cfg = VisionEncoderConfig.tiny()
    if mae:          # the Magi ViTMAE flavour
        cfg = dataclasses.replace(cfg, use_pre_layernorm=False, patch_bias=True,
                                  norm_eps=1e-12)
    px = np.random.default_rng(5).normal(size=(2, 224, 224, 3)).astype(np.float32)
    jm = JViT(cfg)
    params = _random_tree(jm, jnp.asarray(px), seed=5)
    jpen, jcls = _apply(jm, params, jnp.asarray(px))
    sd = from_jax.vision_encoder(params, cfg)
    assert any(k.startswith("encoder.layer.") for k in sd) == mae
    tm = _load(TViT(cfg), sd)
    with torch.no_grad():
        pen, cls = tm(_t(px))
    _close(pen, jpen)
    _close(cls, jcls)


def test_resampler_matches_jax():
    cfg = ResamplerConfig.tiny()
    rng = np.random.default_rng(6)
    clip = rng.normal(size=(2, 2, 17, cfg.embedding_dim)).astype(np.float32)
    magi = rng.normal(size=(2, 2, cfg.magi_embedding_dim)).astype(np.float32)
    jm = JResampler(cfg)
    params = _random_tree(jm, jnp.asarray(clip), jnp.asarray(magi), seed=6)
    tm = _load(TResampler(cfg), from_jax.resampler(params, cfg.depth))
    with torch.no_grad():
        got = tm(_t(clip), _t(magi))
    _close(got, _apply(jm, params, jnp.asarray(clip), jnp.asarray(magi)))


def test_image_proj_model_matches_jax():
    emb = np.random.default_rng(8).normal(size=(3, 24)).astype(np.float32)
    jm = JImageProjModel(cross_attention_dim=16, num_tokens=4)
    params = _random_tree(jm, jnp.asarray(emb), seed=8)
    tm = _load(TImageProjModel(24, cross_attention_dim=16, num_tokens=4),
               from_jax.image_proj(params))
    with torch.no_grad():
        got = tm(_t(emb))
    assert got.shape == (3, 4, 16)
    _close(got, _apply(jm, params, jnp.asarray(emb)))


def test_image_proj_dummy_model_matches_jax():
    """Each branch through the one LayerNorm before the sum, dummy tokens
    first."""
    rng = np.random.default_rng(9)
    clip = rng.normal(size=(2, 3, 24)).astype(np.float32)
    magi = (3.0 + rng.normal(size=(2, 3, 12))).astype(np.float32)
    jm = JImageProjDummyModel(cross_attention_dim=16, num_tokens=4, num_dummy_tokens=3)
    params = _random_tree(jm, jnp.asarray(clip), jnp.asarray(magi), seed=9)
    tm = _load(TImageProjDummyModel(24, 12, cross_attention_dim=16, num_tokens=4,
                                    num_dummy_tokens=3), from_jax.image_proj(params))
    with torch.no_grad():
        got = tm(_t(clip), _t(magi))
    assert got.shape == (2, 3 + 3 * 4, 16)
    _close(got, _apply(jm, params, jnp.asarray(clip), jnp.asarray(magi)))


def test_vae_decoder_matches_jax():
    cfg = VAEConfig.tiny()
    z = np.random.default_rng(7).normal(size=(1, 5, 6, 4)).astype(np.float32)
    jm = JVAE(cfg)
    params = _random_tree(jm, jnp.zeros((1, 32, 32, 3)), jax.random.key(8), seed=7)
    tm = TVAE(cfg)
    skipped = tm.load_decoder_state_dict(from_jax.to_tensors(from_jax.vae(params, cfg)))
    assert skipped and all(k.startswith(("encoder.", "quant_conv.")) for k in skipped)
    with torch.no_grad():
        got = tm.eval().decode(_t(z))
    _close(got, jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(params, z))


# ---------------------------------------------------------------------------
# the Euler sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 4, 20, 30])
def test_euler_tables_and_step_match_jax(steps):
    j = jsched.make_euler_discrete(steps)
    t = tsched.make_euler_discrete(steps)
    for name in ("timesteps", "sigmas", "init_noise_sigma"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=1e-5, rtol=0)
    rng = np.random.default_rng(steps)
    x = rng.normal(size=(1, 4, 4, 4)).astype(np.float32) * 10
    eps = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    i = steps - 1 if steps > 1 else 0
    _close(tsched.scale_model_input(t, _t(x), i),
           jsched.scale_model_input(j, jnp.asarray(x), i), atol=1e-5)
    _close(tsched.step(t, _t(eps), i, _t(x)),
           jsched.step(j, jnp.asarray(eps), i, jnp.asarray(x)), atol=1e-4)


def test_only_euler_is_ported():
    """Once only Euler was ported; now the JAX package's three kinds are
    (``test_torch_port_serving_extras.py``), and any other kind raises."""
    for kind in ("euler_discrete", "ddim", "dpmsolver++"):
        assert tsched.make_sampler(kind, 10).kind == kind
    for kind in ("pndm", "euler_ancestral", ""):
        with pytest.raises(ValueError, match="unknown sampler"):
            tsched.make_sampler(kind, 10)


# ---------------------------------------------------------------------------
# the weight bridge round-trips through the JAX package's porters
# ---------------------------------------------------------------------------
def test_from_jax_round_trips_through_port_torch():
    ids = jnp.zeros((1, 77), jnp.int32)
    img = jnp.zeros((1, 224, 224, 3))
    tcfg = TextEncoderConfig.tiny(projection_dim=8)
    text = _random_tree(JText(tcfg), ids)
    _assert_same_tree(port_torch.port_clip_text(from_jax.clip_text(text, 2), 2), text)

    ccfg = VisionEncoderConfig.tiny()
    clip = _random_tree(JViT(ccfg), img)
    _assert_same_tree(port_torch.port_clip_vision(from_jax.vision_encoder(clip, ccfg), 2),
                      clip)
    mcfg = dataclasses.replace(ccfg, use_pre_layernorm=False, patch_bias=True,
                               norm_eps=1e-12)
    mae = _random_tree(JViT(mcfg), img)
    _assert_same_tree(port_torch.port_vitmae(from_jax.vision_encoder(mae, mcfg), 2), mae)

    rcfg = ResamplerConfig.tiny()
    res = _random_tree(JResampler(rcfg), jnp.zeros((1, 2, 5, 32)), jnp.zeros((1, 2, 16)))
    _assert_same_tree(port_torch.port_resampler(from_jax.resampler(res, 1), 1), res)

    ucfg = UNetConfig.tiny()
    m = ucfg.manga
    unet = _random_tree(
        JUNet(ucfg), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)),
        jnp.zeros((1, 16)), jnp.zeros((1, 6)),
        ip_hidden_states=jnp.zeros((1, m.num_context_image_tokens, 32)))
    ported, missing = port_torch.port_sdxl_unet(from_jax.sdxl_unet(unet, ucfg), ucfg)
    assert missing == []
    _assert_same_tree(ported, unet)

    vcfg = VAEConfig.tiny()
    vae = _random_tree(JVAE(vcfg), jnp.zeros((1, 32, 32, 3)), jax.random.key(9))
    _assert_same_tree(port_torch.port_vae(from_jax.vae(vae, vcfg), vcfg), vae)
