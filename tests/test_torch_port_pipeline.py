"""The PyTorch port's tiny pipeline and server against the JAX package (CPU, fp32).

Both stacks carry the same weights (JAX trees moved across with
``diffsensei_tpu_torch.utils.from_jax``), the same token ids, character crops,
boxes and latent draw. The latents after every Euler step agree within
1e-4 * max|latent| (the bound of ``test_torch_oracle_parity.py``), and so do
the final images of ``DiffSenseiServer.generate`` on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from diffsensei_tpu.models import schedulers as jsched
from diffsensei_tpu.models.resampler import Resampler as JResampler
from diffsensei_tpu.models.text_encoder import CLIPTextEncoder as JText
from diffsensei_tpu.models.unet import UNetMangaModel as JUNet
from diffsensei_tpu.models.unet import attention_levels, level_spatial_shape
from diffsensei_tpu.models.vae import AutoencoderKL as JVAE
from diffsensei_tpu.models.vision_encoder import VisionTransformer as JViT
from diffsensei_tpu.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu.pipelines import pipeline as jpipeline
from diffsensei_tpu.serve import api as japi

from diffsensei_tpu_torch.pipelines import pipeline as tpipeline
from diffsensei_tpu_torch.serve import api as tapi
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import random_tree

torch.set_num_threads(1)

HEIGHT, WIDTH = 168, 384      # a 256-class bucket: latent 21x48, odd level-1 size
STEPS = 3


@pytest.fixture(scope="module")
def stacks():
    """(JAX pipeline, port pipeline) with the same random weights."""
    cfgs = tpipeline.tiny_configs()
    manga = cfgs["unet"].manga
    ids = jnp.zeros((1, 77), jnp.int32)
    img = jnp.zeros((1, 224, 224, 3))
    ucfg = cfgs["unet"]
    jm = jpipeline.PipelineModules(
        unet=JUNet(ucfg), vae=JVAE(cfgs["vae"]),
        text_encoder=JText(cfgs["text_encoder"]), text_encoder_2=JText(cfgs["text_encoder_2"]),
        image_encoder=JViT(cfgs["image_encoder"]), magi_encoder=JViT(cfgs["magi_encoder"]),
        resampler=JResampler(cfgs["resampler"]),
        unet_params=None, vae_params=None, text_encoder_params=None,
        text_encoder_2_params=None)
    jm.unet_params = random_tree(
        jm.unet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, ucfg.cross_attention_dim)),
        jnp.zeros((1, ucfg.pooled_projection_dim)), jnp.zeros((1, 6)), seed=1,
        ip_hidden_states=jnp.zeros((1, manga.num_context_image_tokens,
                                    ucfg.cross_attention_dim)))
    jm.vae_params = random_tree(jm.vae, jnp.zeros((1, 32, 32, 3)), jax.random.key(0), seed=2)
    jm.text_encoder_params = random_tree(jm.text_encoder, ids, seed=3)
    jm.text_encoder_2_params = random_tree(jm.text_encoder_2, ids, seed=4)
    jm.image_encoder_params = random_tree(jm.image_encoder, img, seed=5)
    jm.magi_encoder_params = random_tree(jm.magi_encoder, img, seed=6)
    rcfg = cfgs["resampler"]
    jm.resampler_params = random_tree(
        jm.resampler, jnp.zeros((1, manga.max_num_ips, cfgs["image_encoder"].seq_len,
                                 rcfg.embedding_dim)),
        jnp.zeros((1, manga.max_num_ips, rcfg.magi_embedding_dim)), seed=7)

    tm = tpipeline.PipelineModules.tiny()
    sds = {
        "unet": from_jax.sdxl_unet(jm.unet_params, ucfg),
        "text_encoder": from_jax.clip_text(jm.text_encoder_params,
                                           cfgs["text_encoder"].num_layers),
        "text_encoder_2": from_jax.clip_text(jm.text_encoder_2_params,
                                             cfgs["text_encoder_2"].num_layers),
        "image_encoder": from_jax.vision_encoder(jm.image_encoder_params,
                                                 cfgs["image_encoder"]),
        "magi_encoder": from_jax.vision_encoder(jm.magi_encoder_params,
                                                cfgs["magi_encoder"]),
        "resampler": from_jax.resampler(jm.resampler_params, rcfg.depth),
    }
    for name, sd in sds.items():
        getattr(tm, name).load_state_dict(from_jax.to_tensors(sd))
    tm.vae.load_decoder_state_dict(from_jax.to_tensors(from_jax.vae(jm.vae_params,
                                                                    cfgs["vae"])))
    return jpipeline.DiffSenseiPipeline(jm), tpipeline.DiffSenseiPipeline(tm)


def _request(api, num_samples=2):
    rng = np.random.default_rng(11)
    mk = lambda: rng.integers(1, 255, (1, 77)).astype(np.int32)
    chars = [Image.fromarray((rng.random((90, 60, 3)) * 255).astype(np.uint8))
             for _ in range(2)]
    return api.GenerationRequest(
        height=HEIGHT, width=WIDTH, num_inference_steps=STEPS, guidance_scale=7.5,
        num_samples=num_samples, seed=3, character_images=chars,
        ip_bbox=[[0.0, 0.0, 0.5, 1.0], [0.45, 0.1, 1.0, 0.8]],
        dialog_bbox=[[0.1, 0.05, 0.6, 0.3]], ip_scale=0.6,
        prompt_ids=dict(ids=mk(), neg_ids=mk(), ids_2=mk(), neg_ids_2=mk()))


def _jax_draw(req, pipe):
    lh, lw = HEIGHT // pipe.latent_scale, WIDTH // pipe.latent_scale
    return np.array(jax.random.normal(jax.random.key(req.seed),
                                      (req.num_samples, lh, lw, 4), jnp.float32))


def _jax_step_latents(jpipe, req, pixels, lat0):
    """The JAX pipeline's CFG Euler loop, one jitted UNet call per step."""
    m = jpipe.m
    n = req.num_samples
    ids = {k: jnp.asarray(v) for k, v in req.prompt_ids.items()}
    ctx, pooled = jpipe.encode_prompt("", "", **ids)
    pos, neg = jpipe.prepare_ip_image_embeds(jnp.asarray(pixels), None, len(req.ip_bbox))
    ip = jnp.concatenate([jnp.repeat(neg, n, 0), jnp.repeat(pos, n, 0)], 0)
    boxes, dialog = jpipe._prepare_bboxes(req.ip_bbox, req.dialog_bbox, n)
    lh, lw = lat0.shape[1:3]
    ucfg = m.unet.config
    biases = {lv: build_ip_attention_bias(boxes, *level_spatial_shape(ucfg, lh, lw, lv),
                                          ucfg.manga.num_vision_tokens,
                                          ucfg.manga.num_dummy_tokens)
              for lv in attention_levels(ucfg)}
    time_ids = jnp.repeat(jnp.asarray([[HEIGHT, WIDTH, 0, 0, HEIGHT, WIDTH]],
                                      jnp.float32), 2 * n, 0)
    sampler = jsched.make_euler_discrete(STEPS)
    unet = jax.jit(lambda x, t: m.unet.apply(
        m.unet_params, x, t, jnp.repeat(ctx, n, 0), jnp.repeat(pooled, n, 0), time_ids,
        ip_hidden_states=ip, ip_attn_bias=biases, ip_scale=req.ip_scale,
        dialog_bbox=dialog))
    lat = jnp.asarray(lat0) * sampler.init_noise_sigma
    out = []
    for i in range(STEPS):
        lat_in = jsched.scale_model_input(sampler, jnp.concatenate([lat, lat], 0), i)
        eps = unet(lat_in, jnp.broadcast_to(sampler.timesteps[i], (2 * n,)))
        en, ep = jnp.split(eps, 2, axis=0)
        lat = jsched.step(sampler, en + req.guidance_scale * (ep - en), i, lat)
        out.append(np.asarray(lat))
    return out


def test_per_step_latents_match_jax(stacks):
    jpipe, tpipe = stacks
    req = _request(tapi)
    server = tapi.DiffSenseiServer(tpipe)
    pixels = server._preprocess_characters(req.character_images)
    lat0 = _jax_draw(req, jpipe)
    want = _jax_step_latents(jpipe, req, pixels.numpy(), lat0)

    got = []
    tpipe(height=HEIGHT, width=WIDTH, num_inference_steps=STEPS, guidance_scale=7.5,
          num_samples=req.num_samples, latents=torch.from_numpy(lat0),
          ip_pixel_values=pixels, ip_bbox=req.ip_bbox, ip_scale=req.ip_scale,
          dialog_bbox=req.dialog_bbox, prompt_ids=req.prompt_ids, return_latents=True,
          negative_prompt="", callback=lambda i, lat: got.append(lat.numpy().copy()))
    assert len(got) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0,
                                   err_msg=f"step {i}")


def test_server_images_match_jax(stacks, monkeypatch):
    jpipe, tpipe = stacks
    jreq = _request(japi)
    treq = _request(tapi)
    want = japi.DiffSenseiServer(jpipe).generate(jreq)

    server = tapi.DiffSenseiServer(tpipe)
    lat0 = _jax_draw(treq, jpipe)
    monkeypatch.setattr(server, "initial_latents",
                        lambda seed, shape: torch.from_numpy(lat0))
    got = server.generate(treq)
    assert got.shape == want.shape == (2, HEIGHT, WIDTH, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_unconditioned_panel_is_finite(stacks):
    _, tpipe = stacks
    req = dataclasses.replace(_request(tapi, num_samples=1), character_images=(),
                              ip_bbox=(), dialog_bbox=())
    out = tapi.DiffSenseiServer(tpipe).generate(req)
    assert out.shape == (1, HEIGHT, WIDTH, 3)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0


def test_auto_batch_rule_keeps_the_panels(stacks):
    """Above ``auto_batch_max_side`` the samples run one at a time, below it
    as one batch; both draw the latents once from the seed, so the panels agree."""
    _, tpipe = stacks
    req = dataclasses.replace(_request(tapi), height=576, width=448, num_inference_steps=2)
    one_by_one = tapi.DiffSenseiServer(tpipe).generate(req)
    batched = tapi.DiffSenseiServer(tpipe, auto_batch_max_side=None).generate(req)
    assert one_by_one.shape == (2, 576, 448, 3)
    np.testing.assert_allclose(one_by_one, batched, atol=1e-5, rtol=0)


def test_encode_prompt_tokenizes_like_given_ids(stacks):
    _, tpipe = stacks
    ids = np.random.default_rng(12).integers(1, 255, (1, 77))

    def tokenizer(text, **kwargs):
        return {"input_ids": ids if text == "a panel" else ids[:, ::-1]}

    want = tpipe.encode_prompt("", "", ids=ids, neg_ids=ids[:, ::-1])
    pipe = tpipeline.DiffSenseiPipeline(dataclasses.replace(tpipe.m, tokenizer=tokenizer))
    got = pipe.encode_prompt("a panel", "neg")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs", [
    dict(num_samples=0),
    dict(ip_bbox=[[0, 0, 1, 1]] * 3),
    dict(dialog_bbox=[[0, 0, 1, 1]] * 4),
    dict(ip_pixel_values=torch.zeros(3, 224, 224, 3)),
])
def test_check_inputs_rejects_out_of_budget_requests(stacks, kwargs):
    _, tpipe = stacks
    args = dict(prompt="", ip_pixel_values=None, ip_bbox=None, dialog_bbox=None,
                num_samples=1)
    args.update(kwargs)
    with pytest.raises(ValueError):
        tpipe.check_inputs(**args)
