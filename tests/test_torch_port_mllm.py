"""The PyTorch port's SEED-X agent path against the JAX package (CPU, fp32).

Same numpy-seeded inputs on both sides; weights cross from the JAX trees
through ``diffsensei_tpu_torch.utils.from_jax`` (loaded strictly). Host code
(packing, quantization, prompts, scatters, the decoded ids) must agree
exactly; float outputs within 1e-4 of max|ref|. The int4 decode kernel's
plain twin is held against the Pallas kernel in interpret mode with the
bounds of ``tests/test_int4_matmul.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from diffsensei_tpu.core.config import AgentConfig, LlamaConfig, QwenResamplerConfig
from diffsensei_tpu.data import mllm_dataset as jdata
from diffsensei_tpu.models.mllm import llama as jllama
from diffsensei_tpu.models.mllm import quant as jquant
from diffsensei_tpu.models.mllm import qwen_resampler as jqwen
from diffsensei_tpu.models.mllm import seed_x as jseed
from diffsensei_tpu.ops import int4_matmul as ji4
from diffsensei_tpu.serve import api as japi

from diffsensei_tpu_torch.core import config as tconfig
from diffsensei_tpu_torch.data import mllm_dataset as tdata
from diffsensei_tpu_torch.models.mllm import llama as tllama
from diffsensei_tpu_torch.models.mllm import quant as tquant
from diffsensei_tpu_torch.models.mllm import qwen_resampler as tqwen
from diffsensei_tpu_torch.models.mllm import seed_x as tseed
from diffsensei_tpu_torch.ops import int4_matmul as ti4
from diffsensei_tpu_torch.serve import api as tapi
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import agents, near_one_norms, random_tree, tiny_pipelines

torch.set_num_threads(1)
REL = 1e-4


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def _random_packed(rng, in_f, features, group=128):
    padded = ji4.padded_features(features, in_f, group)
    nib = rng.integers(-8, 8, (in_f, padded)).astype(np.int32)
    gn = in_f // np.gcd(group, in_f)
    scale = rng.uniform(0.01, 0.05, (gn, padded)).astype(np.float32)
    return ji4.pack_int4_host(nib), scale, nib


def _spec(vocab, n_img, module=tdata):
    ladder = list(range(vocab - n_img - 2, vocab))
    return module.MLLMTokenSpec(
        bos_id=1, eos_id=2, pad_id=0, boi_id=ladder[0], eoi_id=ladder[-1],
        img_ids=ladder[1:-1], encode_text=lambda s: [(ord(c) % 200) + 10 for c in s])


# ---------------------------------------------------------------------------
# ops/int4_matmul.py: storage format and the plain twin of kernel B6
# ---------------------------------------------------------------------------
def test_pack_unpack_dequantize_equal_jax():
    rng = np.random.default_rng(0)
    packed, scale, nib = _random_packed(rng, 256, 300)
    np.testing.assert_array_equal(ti4.pack_int4_host(nib), packed)
    np.testing.assert_array_equal(ti4.unpack_int4(torch.from_numpy(packed)).numpy(), nib)
    want = np.asarray(ji4.dequantize(jnp.asarray(packed), jnp.asarray(scale)))
    got = ti4.dequantize(torch.from_numpy(packed), torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    for f, i, g in ((32330, 5120, 128), (5120, 5120, 128), (31, 64, 16), (300, 256, 128)):
        assert ti4.padded_features(f, i, g) == ji4.padded_features(f, i, g)
        assert ti4.kernel_eligible(i, g) == ji4.kernel_eligible(i, g)


@pytest.mark.parametrize("in_f,features", [(256, 300), (64, 31), (384, 512)])
def test_quantize_kernel_bytes_equal_jax(in_f, features):
    w = np.random.default_rng(1).normal(0, 0.05, (in_f, features)).astype(np.float32)
    w[:, 3] = 0.0                                        # a zero column
    for got, want in ((tquant.quantize_kernel_int4(w), jquant.quantize_kernel_int4(w)),
                      (tquant.quantize_kernel(w), jquant.quantize_kernel(w))):
        for g, x in zip(got, want):
            assert g.dtype == np.asarray(x).dtype
            np.testing.assert_array_equal(g, np.asarray(x))


@pytest.mark.parametrize("in_f,features,tokens",
                         [(256, 512, 1), (384, 512, 16), (512, 256, 3)])
def test_decode_twin_matches_pallas_kernel(in_f, features, tokens):
    rng = np.random.default_rng(2)
    packed, scale, _ = _random_packed(rng, in_f, features)
    x = rng.normal(size=(tokens, in_f)).astype(np.float32)
    kernel = np.asarray(ji4.int4_decode_matmul(jnp.asarray(x), jnp.asarray(packed),
                                               jnp.asarray(scale), interpret=True))
    fallback = np.asarray(ji4.int4_decode_fallback(jnp.asarray(x), jnp.asarray(packed),
                                                   jnp.asarray(scale)))
    got = ti4.int4_decode_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                 torch.from_numpy(scale)).numpy()
    assert got.shape == kernel.shape == (tokens, scale.shape[1])
    np.testing.assert_allclose(got, kernel, rtol=2e-2, atol=2e-2)
    assert np.linalg.norm(got - kernel) / np.linalg.norm(kernel) < 2e-2
    _close(got, fallback)


@pytest.mark.parametrize("in_f,features,tokens",
                         [(256, 512, 1), (384, 512, 16), (512, 256, 3)])
def test_twin_on_bf16_rounded_x_matches_pallas_kernel_on_fp32_x(in_f, features, tokens):
    """Kernel B6 takes fp32 x and rounds it to bf16 itself, as the JAX entry
    does: on bf16-rounded x the port's plain twin gives the Pallas kernel's
    product on the fp32 x, so the rounding is all the entry adds."""
    rng = np.random.default_rng(5)
    packed, scale, _ = _random_packed(rng, in_f, features)
    x = rng.normal(size=(tokens, in_f)).astype(np.float32)
    kernel = np.asarray(ji4.int4_decode_matmul(jnp.asarray(x), jnp.asarray(packed),
                                               jnp.asarray(scale), interpret=True))
    x_bf16 = torch.from_numpy(x).bfloat16().float()
    got = ti4.int4_decode_matmul(x_bf16, torch.from_numpy(packed), torch.from_numpy(scale))
    _close(got, kernel, rel=1e-5)


# ---------------------------------------------------------------------------
# models/mllm/llama.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("in_f,features", [(256, 300), (64, 31)])
@pytest.mark.parametrize("tokens", [4, 24])                 # decode, prefill
def test_int4_dense_matches_jax(in_f, features, tokens):
    rng = np.random.default_rng(3)
    packed, scale, _ = _random_packed(rng, in_f, features)
    params = {"params": {"kernel_q": jnp.asarray(packed), "kernel_scale": jnp.asarray(scale)}}
    x = rng.normal(size=(1, tokens, in_f)).astype(np.float32)
    want = jllama.Int4Dense(features).apply(params, jnp.asarray(x))
    layer = tllama.Int4Dense(in_f, features, device="cpu")
    layer.load_state_dict({"kernel_q": torch.from_numpy(packed),
                           "kernel_scale": torch.from_numpy(scale)})
    _close(layer(torch.from_numpy(x)), want)


def test_int8_dense_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.05, (64, 48)).astype(np.float32)
    q, s = jquant.quantize_kernel(w)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = jllama.Int8Dense(48).apply({"params": {"kernel_q": q, "kernel_scale": s}},
                                      jnp.asarray(x))
    layer = tllama.Int8Dense(64, 48, device="cpu")
    layer.load_state_dict({"kernel_q": torch.from_numpy(q), "kernel_scale": torch.from_numpy(s)})
    _close(layer(torch.from_numpy(x)), want)


# hidden 128 with group 128 is kernel_eligible: the decode takes B6's twin
LLAMA_CFGS = {
    "tiny": LlamaConfig.tiny(),
    "eligible_gqa": LlamaConfig(vocab_size=300, hidden_size=128, intermediate_size=256,
                                num_layers=2, num_heads=4, num_kv_heads=2,
                                max_position_embeddings=64),
}


def _jax_llama(cfg, weights, seed=0):
    """(JAX model, its params) for ``weights`` in float, bf16, int8, int4."""
    model = jllama.LlamaForCausalLM(cfg)
    params = near_one_norms(random_tree(model, input_ids=jnp.zeros((1, 8), jnp.int32), seed=seed))
    if weights == "bf16":
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    if weights in ("int8", "int4"):
        params = jquant.quantize_llm_params(params, bits=int(weights[3]))
        model = jllama.LlamaForCausalLM(cfg, quantized="int4" if weights == "int4" else True)
    return model, params


def _port_llama(cfg, params, weights):
    quantized = weights if weights in ("int8", "int4") else False
    model = tllama.LlamaForCausalLM(tconfig.LlamaConfig(**dataclasses.asdict(cfg)),
                                    quantized=quantized, device="cpu")
    model.load_state_dict(from_jax.to_tensors(from_jax.llama(params)))
    return model.eval()


@pytest.mark.parametrize("cfg_name", sorted(LLAMA_CFGS))
@pytest.mark.parametrize("weights", ["float", "bf16", "int8", "int4"])
def test_llama_logits_match_jax(cfg_name, weights):
    cfg = LLAMA_CFGS[cfg_name]
    jmodel, params = _jax_llama(cfg, weights)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 11))
    want_logits, want_hidden, _ = jax.jit(jmodel.apply)(params, jnp.asarray(ids))
    model = _port_llama(cfg, params, weights)
    with torch.no_grad():
        logits, hidden, caches = model(torch.from_numpy(ids))
    assert caches is None
    _close(logits, want_logits)
    _close(hidden, want_hidden)


@pytest.mark.parametrize("cfg_name,weights", [("tiny", "float"), ("eligible_gqa", "int4")])
def test_cached_decode_matches_full_forward_and_jax(cfg_name, weights):
    """Prefill 6 tokens into the cache, then one token at a time: each step's
    logits equal the full causal forward's, and the JAX package's cached run."""
    cfg = LLAMA_CFGS[cfg_name]
    jmodel, params = _jax_llama(cfg, weights, seed=1)
    model = _port_llama(cfg, params, weights)
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10))
    b, s = ids.shape
    with torch.no_grad():
        full, _, _ = model(torch.from_numpy(ids))
    jcaches = jllama.init_caches(cfg, b, s)
    caches = tllama.init_caches(cfg, b, s)
    pre = 6
    for start, stop in [(0, pre)] + [(i, i + 1) for i in range(pre, s)]:
        pos = np.broadcast_to(np.arange(start, stop)[None], (b, stop - start))
        want, _, jcaches = jmodel.apply(params, jnp.asarray(ids[:, start:stop]),
                                        positions=jnp.asarray(pos), caches=jcaches,
                                        cache_index=start)
        with torch.no_grad():
            got, _, caches = model(torch.from_numpy(ids[:, start:stop]),
                                   positions=torch.from_numpy(pos.copy()), caches=caches,
                                   cache_index=start)
        _close(got, want)
        _close(got, full[:, start:stop].numpy(), rel=1e-4)


# ---------------------------------------------------------------------------
# models/mllm/qwen_resampler.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid,seq", [(2, 8), (2, 9), (2, 1), (8, 64), (8, 25), (8, 121)])
def test_abs_pos_matches_jax(grid, seq):
    """Identity (64 on 8x8), the tile branch (8 on 2x2), and jax.image.resize's
    bicubic growing (2x2 -> 3x3, 8x8 -> 11x11) and shrinking (antialiased:
    2x2 -> 1x1, 8x8 -> 5x5)."""
    pos = tqwen.get_2d_sincos_pos_embed(16, grid)
    np.testing.assert_array_equal(pos, jqwen.get_2d_sincos_pos_embed(16, grid))
    want = jqwen._abs_pos(jnp.asarray(pos), seq)
    _close(tqwen._abs_pos(torch.from_numpy(pos), seq), want)


@pytest.mark.parametrize("nq_override,seq", [(None, 4), (8, 8), (None, 9), (None, 1)])
def test_qwen_resampler_matches_jax(nq_override, seq):
    cfg = QwenResamplerConfig(grid_size=2, embed_dim=32, num_heads=4, kv_dim=24,
                              num_queries_override=nq_override)
    jmod = jqwen.QwenResampler(cfg)
    x = np.random.default_rng(7).normal(size=(3, seq, 24)).astype(np.float32)
    params = random_tree(jmod, jnp.asarray(x), seed=2)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = tqwen.QwenResampler(tconfig.QwenResamplerConfig(**dataclasses.asdict(cfg)),
                               device="cpu")
    tmod.load_state_dict(from_jax.to_tensors(from_jax.qwen_resampler(params)))
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# models/mllm/quant.py and data/mllm_dataset.py
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_llm_params_trees_equal_jax(bits):
    cfg = LLAMA_CFGS["eligible_gqa"]
    model = jllama.LlamaForCausalLM(cfg, lora_rank=4)
    params = random_tree(model, input_ids=jnp.zeros((1, 8), jnp.int32), seed=3)
    want = _flat(jquant.quantize_llm_params(jquant.merge_llm_lora(params), bits=bits))
    np_params = jax.tree.map(np.asarray, params)
    got = _flat(tquant.quantize_llm_params(tquant.merge_llm_lora(np_params), bits=bits))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_agent_equals_jax(bits):
    """The port's ``quantize_agent`` on a LoRA agent gives the state the JAX
    package's gives (LoRA merged, every projection and lm_head quantized)."""
    cfg = _agent_config(LLAMA_CFGS["eligible_gqa"])
    jagent, tagent = agents(cfg, seed=4)
    want = from_jax.llama(jquant.quantize_agent(jagent, bits=bits).llm_params)
    got = tquant.quantize_agent(tagent, bits=bits).llm.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.astype(got[k].numpy().dtype),
                                      err_msg=k)


def test_inference_prompt_and_spec_equal_jax():
    tspec, jspec = _spec(512, 4), _spec(512, 4, jdata)
    np.testing.assert_array_equal(tspec.ladder_ids, jspec.ladder_ids)
    assert tspec.ladder_ids.dtype == jspec.ladder_ids.dtype
    caption = tspec.encode_text("two characters talk")
    got = tdata.build_inference_prompt(caption, tspec, [9])
    want = jdata.build_inference_prompt(caption, jspec, [9])
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_ordered_scatter_and_gather_equal_jax():
    rng = np.random.default_rng(8)
    base = rng.normal(size=(3, 12, 5)).astype(np.float32)
    mask = rng.random((3, 12)) > 0.5
    mask[2] = False
    tokens = rng.normal(size=(3, 12, 5)).astype(np.float32)
    want = jseed._ordered_scatter(jnp.asarray(base), jnp.asarray(mask), jnp.asarray(tokens))
    got = tseed._ordered_scatter(torch.from_numpy(base), torch.from_numpy(mask),
                                 torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jseed._ordered_true_gather(jnp.asarray(base), jnp.asarray(mask), 4)
    got = tseed._ordered_true_gather(torch.from_numpy(base), torch.from_numpy(mask), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# models/mllm/seed_x.py: ContinuousLVLM.generate
# ---------------------------------------------------------------------------
def _agent_config(llm):
    """``AgentConfig.tiny`` around another LLM width."""
    return AgentConfig(llm=llm, lora=AgentConfig.tiny().lora,
                       input_resampler=QwenResamplerConfig.tiny(embed_dim=llm.hidden_size,
                                                                kv_dim=32),
                       output_resampler=QwenResamplerConfig.tiny(embed_dim=32,
                                                                 kv_dim=llm.hidden_size))


@pytest.mark.parametrize("quantized", [False, True])
def test_generate_matches_jax(quantized):
    """Prompt with a comprehension block of resampled characters, the forced
    ladder, free tokens after it: the same ids (exact), the same number of
    images, and the output resampler's features within 1e-4."""
    cfg = _agent_config(LLAMA_CFGS["eligible_gqa"])
    jagent, tagent = agents(cfg, seed=5, quantized=quantized)
    nq = cfg.input_resampler.num_queries
    spec = _spec(cfg.llm.vocab_size, nq)
    prompt = tdata.build_inference_prompt(spec.encode_text("a cat"), spec, [9])
    chars = np.random.default_rng(9).normal(
        size=(1, nq, cfg.input_resampler.kv_dim)).astype(np.float32)
    kw = dict(ladder_ids=spec.ladder_ids, max_new_tokens=nq + 9)
    want = jagent.generate(prompt["input_ids"], image_embeds=jnp.asarray(chars),
                           ids_cmp_mask=jnp.asarray(prompt["ids_cmp_mask"]), **kw)
    got = tagent.generate(prompt["input_ids"], image_embeds=torch.from_numpy(chars),
                          ids_cmp_mask=prompt["ids_cmp_mask"], **kw)
    np.testing.assert_array_equal(got["output_ids"], np.asarray(want["output_ids"]))
    np.testing.assert_array_equal(got["output_ids"][0, :nq + 1], spec.ladder_ids[1:])
    assert got["num_gen_imgs"] == want["num_gen_imgs"] >= 1
    _close(got["img_gen_feat"], want["img_gen_feat"])


@pytest.mark.parametrize("ctor", ["ContinuousLVLM.build", "PipelineModules.build",
                                  "PipelineModules.tiny", "PipelineModules.sdxl"])
def test_constructors_default_to_the_card(ctor):
    import inspect

    from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules

    owner, name = ctor.split(".")
    cls = {"ContinuousLVLM": tseed.ContinuousLVLM, "PipelineModules": PipelineModules}[owner]
    assert inspect.signature(getattr(cls, name)).parameters["device"].default == "cuda"


def test_agent_build_draws_int4_bytes():
    agent = tseed.ContinuousLVLM.build(tconfig.AgentConfig.tiny(), quantized="int4",
                                       device="cpu", seed=3)
    head = agent.llm.lm_head
    assert head.kernel_q.dtype == torch.uint8 and head.kernel_q.shape == (64, 256)
    assert int(head.kernel_q.max()) > 200 and int(head.kernel_q.min()) < 50
    torch.testing.assert_close(head.kernel_scale,
                               torch.full_like(head.kernel_scale, 1 / (4.61 * 8.0)))
    out = agent.llm(torch.arange(12)[None])[0]
    assert out.shape == (1, 12, 512) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# serve/api.py with the agent
# ---------------------------------------------------------------------------
def test_server_with_agent_matches_jax(monkeypatch):
    jpipe, tpipe = tiny_pipelines()
    manga = tpipe.m.manga
    iv, cross = manga.num_ip_tokens, tpipe.m.unet.config.cross_attention_dim
    llm = LlamaConfig.tiny()
    cfg = AgentConfig(
        llm=llm,
        input_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                            embed_dim=llm.hidden_size, num_heads=4,
                                            kv_dim=cross),
        output_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                             embed_dim=cross, num_heads=4,
                                             kv_dim=llm.hidden_size))
    jagent, tagent = agents(cfg, seed=6)

    def request(api):
        rng = np.random.default_rng(10)
        mk = lambda: rng.integers(1, 255, (1, 77)).astype(np.int32)
        chars = [Image.fromarray((rng.random((70, 50, 3)) * 255).astype(np.uint8))]
        return api.GenerationRequest(
            prompt="two characters", height=128, width=128, num_inference_steps=2,
            seed=4, character_images=chars, ip_bbox=[[0.0, 0.0, 0.5, 1.0]],
            dialog_bbox=[[0.1, 0.05, 0.6, 0.3]], mllm_scale=0.4,
            prompt_ids=dict(ids=mk(), neg_ids=mk(), ids_2=mk(), neg_ids_2=mk()))

    kw = dict(mllm_max_new_tokens=iv + 4)
    want = japi.DiffSenseiServer(jpipe, agent=jagent, mllm_spec=_spec(llm.vocab_size, iv, jdata),
                                 **kw).generate(request(japi))
    server = tapi.DiffSenseiServer(tpipe, agent=tagent, mllm_spec=_spec(llm.vocab_size, iv),
                                   **kw)
    lat0 = np.array(jax.random.normal(jax.random.key(4), (1, 32, 32, 4), jnp.float32))
    monkeypatch.setattr(server, "initial_latents", lambda seed, shape: torch.from_numpy(lat0))
    adapted = []
    monkeypatch.setattr(server, "_adapt_with_mllm",
                        lambda *a, f=server._adapt_with_mllm: adapted.append(f(*a)) or adapted[-1])
    got = server.generate(request(tapi))
    assert adapted[0].shape == (manga.max_num_ips, manga.num_vision_tokens, cross)
    assert got.shape == want.shape == (1, 256, 256, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    # the agent changed the panel: without it the server gives another image
    plain = tapi.DiffSenseiServer(tpipe)
    monkeypatch.setattr(plain, "initial_latents", lambda seed, shape: torch.from_numpy(lat0))
    assert np.abs(plain.generate(request(tapi)) - got).max() > 1e-4


def test_pipeline_pastes_embeds_and_checks_their_count():
    _, tpipe = tiny_pipelines()
    manga = tpipe.m.manga
    d = tpipe.m.unet.config.cross_attention_dim
    embeds = torch.randn(2, manga.num_vision_tokens, d)
    pos, neg = tpipe.prepare_ip_image_embeds(None, embeds, None)
    start = manga.num_dummy_tokens
    torch.testing.assert_close(pos[0, start:], embeds.reshape(-1, d), rtol=0, atol=0)
    zero_pos, zero_neg = tpipe.prepare_ip_image_embeds(None)
    torch.testing.assert_close(pos[0, :start], zero_pos[0, :start], rtol=0, atol=0)
    torch.testing.assert_close(neg, zero_neg, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tpipe.check_inputs("", ip_image_embeds=torch.zeros(1, manga.num_vision_tokens + 1, d))
