"""The port's serving extras against the JAX package (CPU, fp32): the DDIM and
DPM-Solver++ samplers, DeepCache in the UNet and the denoise loop, and the
serve CLI.

Sampler tables are built in numpy on both sides and must be equal; a step
agrees within 1e-5. Latents along the loop agree within 1e-4 * max|latent|
(the bound of ``test_torch_port_pipeline.py``), the UNet's outputs and deep
features within 5e-4 (``test_torch_port_models.py``). A cached UNet call
repeats the full call's output bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from diffsensei_tpu.core.config import UNetConfig as JUNetConfig
from diffsensei_tpu.models import schedulers as jsched
from diffsensei_tpu.models.unet import UNetMangaModel as JUNet, attention_levels
from diffsensei_tpu.models.unet import level_spatial_shape
from diffsensei_tpu.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu.pipelines import pipeline as jpipeline

from diffsensei_tpu_torch.core.buckets import snap_to_bucket
from diffsensei_tpu_torch.core.config import UNetConfig as TUNetConfig
from diffsensei_tpu_torch.models import schedulers as tsched
from diffsensei_tpu_torch.models.unet import UNetMangaModel as TUNet
from diffsensei_tpu_torch.pipelines import pipeline as tpipeline
from diffsensei_tpu_torch.serve import api as tapi, cli as tcli
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import (llama_tokenizer_dir, random_tree, record_servers,
                                   spec_fields, tiny_pipelines)

torch.set_num_threads(1)

KINDS = {"ddim": (jsched.make_ddim, tsched.make_ddim),
         "dpmsolver++": (jsched.make_dpmpp_2m, tsched.make_dpmpp_2m)}
TABLES = ("timesteps", "sigmas", "alphas_cumprod_t", "alphas_cumprod_prev",
          "init_noise_sigma", "dpm_tables")


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 4, 12, 20, 30])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sampler_tables_are_the_jax_tables(kind, steps):
    j, t = (make(steps) for make in KINDS[kind])
    assert t.kind == j.kind and t.num_steps == j.num_steps == steps
    assert t.is_multistep == j.is_multistep == (kind == "dpmsolver++")
    for name in TABLES:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert tsched.make_sampler(kind, steps).kind == kind


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sampler_steps_match_jax(kind):
    steps = 12
    j, t = (make(steps) for make in KINDS[kind])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 6, 4)).astype(np.float32) * 3
    eps = rng.normal(size=x.shape).astype(np.float32)
    prev = rng.normal(size=x.shape).astype(np.float32)
    tx, te, tp = (torch.from_numpy(a) for a in (x, eps, prev))
    for i in (0, 5, steps - 1):
        np.testing.assert_array_equal(tsched.scale_model_input(t, tx, i).numpy(),
                                      np.asarray(jsched.scale_model_input(j, x, i)))
        if kind == "ddim":
            got, want = tsched.step(t, te, i, tx), jsched.step(j, eps, i, x)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        else:
            got = tsched.multistep_step(t, te, i, tx, tp)
            want = jsched.multistep_step(j, eps, i, x, prev)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        if kind == "ddim":
            tsched.multistep_step(t, te, 0, tx, tp)
        else:
            tsched.step(t, te, 0, tx)


# ---------------------------------------------------------------------------
# the denoise loop on the tiny stack
# ---------------------------------------------------------------------------
HEIGHT, WIDTH = 168, 384      # a 256-class bucket: latent 21x48, odd level-1 size
STEPS = 3


@pytest.fixture(scope="module")
def stacks():
    return tiny_pipelines()


def _inputs(pipe, n=1):
    rng = np.random.default_rng(11)
    mk = lambda: rng.integers(1, 255, (1, 77)).astype(np.int32)
    pixels = rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    lat0 = rng.normal(size=(n, HEIGHT // 8, WIDTH // 8, 4)).astype(np.float32)
    return dict(ids=dict(ids=mk(), neg_ids=mk(), ids_2=mk(), neg_ids_2=mk()), pixels=pixels,
                lat0=lat0, ip_bbox=[[0.0, 0.0, 0.5, 1.0], [0.45, 0.1, 1.0, 0.8]],
                dialog_bbox=[[0.1, 0.05, 0.6, 0.3]])


def _jax_step_latents(jpipe, inp, sampler):
    """The JAX CFG loop with its step functions, one jitted UNet call a step."""
    m, n = jpipe.m, inp["lat0"].shape[0]
    ids = {k: jnp.asarray(v) for k, v in inp["ids"].items()}
    ctx, pooled = jpipe.encode_prompt("", "", **ids)
    pos, neg = jpipe.prepare_ip_image_embeds(jnp.asarray(inp["pixels"]), None, 2)
    ip = jnp.concatenate([jnp.repeat(neg, n, 0), jnp.repeat(pos, n, 0)], 0)
    boxes, dialog = jpipe._prepare_bboxes(inp["ip_bbox"], inp["dialog_bbox"], n)
    lh, lw = inp["lat0"].shape[1:3]
    ucfg = m.unet.config
    biases = {lv: build_ip_attention_bias(boxes, *level_spatial_shape(ucfg, lh, lw, lv),
                                          ucfg.manga.num_vision_tokens,
                                          ucfg.manga.num_dummy_tokens)
              for lv in attention_levels(ucfg)}
    time_ids = jnp.repeat(jnp.asarray([[HEIGHT, WIDTH, 0, 0, HEIGHT, WIDTH]], jnp.float32),
                          2 * n, 0)
    unet = jax.jit(lambda x, t: m.unet.apply(
        m.unet_params, x, t, jnp.repeat(ctx, n, 0), jnp.repeat(pooled, n, 0), time_ids,
        ip_hidden_states=ip, ip_attn_bias=biases, ip_scale=0.6, dialog_bbox=dialog))
    lat = jnp.asarray(inp["lat0"]) * sampler.init_noise_sigma
    prev_x0 = jnp.zeros_like(lat)
    out = []
    for i in range(sampler.num_steps):
        lat_in = jsched.scale_model_input(sampler, jnp.concatenate([lat, lat], 0), i)
        eps = unet(lat_in, jnp.broadcast_to(sampler.timesteps[i], (2 * n,)))
        en, ep = jnp.split(eps, 2, axis=0)
        guided = en + 7.5 * (ep - en)
        if sampler.is_multistep:
            lat, prev_x0 = jsched.multistep_step(sampler, guided, i, lat, prev_x0)
        else:
            lat = jsched.step(sampler, guided, i, lat)
        out.append(np.asarray(lat))
    return out


def _port(tpipe, scheduler):
    return tpipeline.DiffSenseiPipeline(
        tpipe.m, dataclasses.replace(tpipe.config, scheduler=scheduler))


def _port_call(pipe, inp, **kw):
    return pipe(height=HEIGHT, width=WIDTH, num_inference_steps=STEPS, guidance_scale=7.5,
                num_samples=inp["lat0"].shape[0], latents=torch.from_numpy(inp["lat0"]),
                ip_pixel_values=torch.from_numpy(inp["pixels"]), ip_bbox=inp["ip_bbox"],
                ip_scale=0.6, dialog_bbox=inp["dialog_bbox"], prompt_ids=inp["ids"],
                negative_prompt="", return_latents=True, **kw)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_per_step_latents_match_jax(stacks, kind):
    jpipe, tpipe = stacks
    inp = _inputs(tpipe, n=2)
    want = _jax_step_latents(jpipe, inp, jsched.make_sampler(kind, STEPS))
    got = []
    _port_call(_port(tpipe, kind), inp, callback=lambda i, lat: got.append(lat.numpy().copy()))
    assert len(got) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0,
                                   err_msg=f"{kind} step {i}")


@pytest.mark.parametrize("kind", ["euler_discrete", "dpmsolver++"])
def test_deep_cached_latents_match_the_jax_pipeline(stacks, kind):
    """``__call__(..., deep_cache_interval=2, return_latents=True)`` on both
    sides; the tiny UNet has two levels, so the split is 1."""
    jpipe, tpipe = stacks
    inp = _inputs(tpipe)
    jp = jpipeline.DiffSenseiPipeline(jpipe.m, dataclasses.replace(jpipe.config,
                                                                   scheduler=kind))
    want = np.asarray(jp(height=HEIGHT, width=WIDTH, num_inference_steps=STEPS,
                         guidance_scale=7.5, latents=jnp.asarray(inp["lat0"]),
                         ip_pixel_values=jnp.asarray(inp["pixels"]), ip_bbox=inp["ip_bbox"],
                         ip_scale=0.6, dialog_bbox=inp["dialog_bbox"],
                         prompt_ids={k: jnp.asarray(v) for k, v in inp["ids"].items()},
                         negative_prompt="", return_latents=True, deep_cache_interval=2,
                         deep_cache_split=1))
    seen = []
    got = _port_call(_port(tpipe, kind), inp, deep_cache_interval=2, deep_cache_split=1,
                     callback=lambda i, lat: seen.append(i)).numpy()
    assert seen == list(range(STEPS))
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0)
    exact = _port_call(_port(tpipe, kind), inp)
    assert not np.array_equal(got, exact.numpy())    # step 1 reused step 0's feature


def test_deep_cache_interval_one_is_the_uncached_loop(stacks):
    _, tpipe = stacks
    inp = _inputs(tpipe)
    pipe = _port(tpipe, "dpmsolver++")
    torch.testing.assert_close(_port_call(pipe, inp, deep_cache_interval=1, deep_cache_split=1),
                               _port_call(pipe, inp), rtol=0, atol=0)


def test_server_passes_the_deep_cache_knobs_and_makes_pil_panels(stacks):
    _, tpipe = stacks
    rng = np.random.default_rng(2)
    ids = {k: rng.integers(1, 255, (1, 77)) for k in ("ids", "neg_ids", "ids_2", "neg_ids_2")}
    server = tapi.DiffSenseiServer(tpipe)
    req = tapi.GenerationRequest(height=256, width=256, num_inference_steps=2, prompt_ids=ids,
                                 deep_cache_interval=2, deep_cache_split=1)
    panels = server.generate_pil(req)
    assert [p.size for p in panels] == [(256, 256)]
    with pytest.raises(ValueError, match="cache_split"):
        server.generate(dataclasses.replace(req, deep_cache_split=2))
    server.warmup([(256, 256)], num_inference_steps=1, deep_cache_interval=2,
                  deep_cache_split=1)


# ---------------------------------------------------------------------------
# DeepCache in the UNet, three levels
# ---------------------------------------------------------------------------
def _three_levels(cfg_cls):
    return dataclasses.replace(cfg_cls.tiny(), block_out_channels=(32, 64, 64),
                               transformer_layers_per_block=(0, 1, 1))


@pytest.fixture(scope="module")
def unets():
    """(JAX UNet, its tree, the port's UNet, inputs) of a 3-level tiny UNet."""
    jcfg = _three_levels(JUNetConfig)
    m = jcfg.manga
    ip_tokens = m.num_context_image_tokens
    junet = JUNet(jcfg)
    tree = random_tree(junet, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                       jnp.zeros((1, 77, 32)), jnp.zeros((1, 16)), jnp.zeros((1, 6)), seed=3,
                       ip_hidden_states=jnp.zeros((1, ip_tokens, 32)))
    tunet = TUNet(_three_levels(TUNetConfig))
    tunet.load_state_dict(from_jax.to_tensors(from_jax.sdxl_unet(tree, jcfg)))
    rng = np.random.default_rng(4)
    lh, lw = 12, 10
    boxes = rng.uniform(0, 1, (2, m.max_num_ips, 4)).astype(np.float32)
    inputs = dict(
        sample=rng.normal(size=(2, lh, lw, 4)).astype(np.float32),
        timesteps=np.array([500.0, 20.0], np.float32),
        encoder_hidden_states=rng.normal(size=(2, 77, 32)).astype(np.float32),
        pooled_text_embeds=rng.normal(size=(2, 16)).astype(np.float32),
        time_ids=np.tile(np.array([[96, 80, 0, 0, 96, 80]], np.float32), (2, 1)),
        ip_hidden_states=rng.normal(size=(2, ip_tokens, 32)).astype(np.float32),
        ip_attn_bias={lv: np.asarray(build_ip_attention_bias(
            jnp.asarray(boxes), *level_spatial_shape(jcfg, lh, lw, lv), m.num_vision_tokens,
            m.num_dummy_tokens)) for lv in attention_levels(jcfg)},
        dialog_bbox=rng.uniform(0, 1, (2, m.max_num_dialogs, 4)).astype(np.float32))
    return junet, tree, tunet.eval(), inputs


def _split_args(inputs, to):
    args = [to(inputs[k]) for k in ("sample", "timesteps", "encoder_hidden_states",
                                     "pooled_text_embeds", "time_ids")]
    kw = dict(ip_hidden_states=to(inputs["ip_hidden_states"]),
              ip_attn_bias={k: to(np.array(v)) for k, v in inputs["ip_attn_bias"].items()},
              ip_scale=0.7, dialog_bbox=to(inputs["dialog_bbox"]))
    return args, kw


@pytest.mark.parametrize("split", [1, 2])
def test_unet_deep_feature_matches_jax_and_repeats_the_full_call(unets, split):
    junet, tree, tunet, inputs = unets
    jargs, jkw = _split_args(inputs, jnp.asarray)
    targs, tkw = _split_args(inputs, torch.from_numpy)
    apply = jax.jit(lambda tree, deep: junet.apply(tree, *jargs, **jkw, return_deep=True,
                                                   cache_split=split, deep_feature=deep))
    jfull, jdeep = apply(tree, None)
    rng = np.random.default_rng(split)
    other = jdeep + jnp.asarray(rng.normal(size=jdeep.shape).astype(np.float32))
    jcached, jpassed = apply(tree, other)
    with torch.no_grad():
        full, deep = tunet(*targs, **tkw, return_deep=True, cache_split=split)
        cached, passed = tunet(*targs, **tkw, return_deep=True, cache_split=split,
                               deep_feature=torch.from_numpy(np.array(other)))
        again = tunet(*targs, **tkw, cache_split=split, deep_feature=deep)
        plain = tunet(*targs, **tkw)
    assert deep.shape == jdeep.shape == (2, *level_spatial_shape(
        tunet.config, 12, 10, split - 1), 64)
    for got, want in ((full, jfull), (deep, jdeep), (cached, jcached)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    np.testing.assert_array_equal(passed.numpy(), np.asarray(other))
    assert torch.equal(again, full) and torch.equal(plain, full)


@pytest.mark.parametrize("split", [0, 3])
def test_unet_refuses_a_split_outside_its_levels(unets, split):
    _, _, tunet, inputs = unets
    args, kw = _split_args(inputs, torch.from_numpy)
    with pytest.raises(ValueError, match="cache_split"):
        tunet(*args, **kw, return_deep=True, cache_split=split)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_cli_writes_a_panel_with_the_serving_extras(tmp_path):
    char = tmp_path / "hero.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 255, (60, 40, 3), np.uint8)).save(char)
    out = tmp_path / "panel.png"
    paths = tcli.main(["--device", "cpu", "--preset", "tiny", "--prompt", "a young man",
                       "--height", "128", "--width", "96", "--steps", "3",
                       "--scheduler", "dpmsolver++", "--deep-cache", "2",
                       "--deep-cache-split", "1", "--quantize-unet", "--char-image",
                       str(char), "--ip-bbox", "0,0,0.5,1", "--dialog-bbox", "0.1,0,0.5,0.2",
                       "--warmup", "128x96", "--out", str(out)])
    assert paths == [str(out)]
    img = np.asarray(Image.open(out))
    assert img.shape == (*snap_to_bucket(128, 96), 3) and img.dtype == np.uint8


@pytest.mark.parametrize("flag", [["--mllm-tokenizer", "tok"],
                                  ["--context-parallel", "--mllm-tokenizer", "tok"],
                                  ["--weights", "w.yaml", "--mllm-tokenizer", "tok"],
                                  ["--tokenizer", "tok", "--context-parallel",
                                   "--mllm-tokenizer", "tok"],
                                  ["--agent-weights", "a.bin", "--quantize-llm",
                                   "--mllm-tokenizer", "tok"]])
def test_cli_takes_the_mllm_tokenizer(tmp_path, monkeypatch, flag):
    """``--mllm-tokenizer`` with real files, alone or beside the other flags:
    the server is built with ``mllm_spec_from_tokenizer`` of the directory
    (64 image ids, as the JAX CLI's), and with the agent where one is
    loaded. The server is a recorder: the tiny agent cannot take 64 image
    ids, so the panel is ``tests/test_torch_port_llama_tokenizer.py``'s."""
    import torch.distributed as dist
    from diffsensei_tpu_torch.core.config import AgentConfig
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM

    import chip_smoke

    llama = llama_tokenizer_dir(tmp_path / "llama")
    mods = tpipeline.PipelineModules.tiny(device="cpu", seed=1)
    torch.save(mods.resampler.state_dict(), tmp_path / "resampler.pt")
    (tmp_path / "w.yaml").write_text("resampler: resampler.pt\n")
    agent = ContinuousLVLM.build(AgentConfig.tiny(), device="cpu", seed=3)
    torch.save({f"{name}.{k}": v for name in ("llm", "input_resampler", "output_resampler")
                for k, v in getattr(agent, name).state_dict().items()}, tmp_path / "a.bin")
    files = {"--mllm-tokenizer": llama, "--weights": tmp_path / "w.yaml",
             "--tokenizer": chip_smoke.write_clip_vocab(tmp_path / "clip",
                                                       chip_smoke.prompt_merges()),
             "--agent-weights": tmp_path / "a.bin"}
    argv = [str(files[flag[i - 1]]) if i and flag[i - 1] in files else a
            for i, a in enumerate(flag)]
    built = record_servers(monkeypatch)
    grouped = dist.is_initialized()
    try:
        assert tcli.main(["--device", "cpu", "--out", str(tmp_path / "p.png"), *argv]) == []
    finally:
        if dist.is_initialized() and not grouped:
            dist.destroy_process_group()
    want = tcli.mllm_spec_from_tokenizer(str(llama))
    assert len(built) == 1 and spec_fields(built[0]["mllm_spec"]) == spec_fields(want)
    assert list(want.img_ids) == list(range(want.boi_id + 2, want.boi_id + 66))
    assert (built[0]["agent"] is not None) == ("--agent-weights" in flag)


def test_cli_parses_boxes():
    assert tcli.parse_bbox(["0,0,0.5,1", "0.1 0.2 0.3 0.4", "1,2"]) == [
        [0.0, 0.0, 0.5, 1.0], [0.1, 0.2, 0.3, 0.4]]
