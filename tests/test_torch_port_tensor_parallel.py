"""The port's model axis against the JAX package (CPU, fp32): tensor-parallel
SEED-X LLaMA, the agent's decode on it, stage 3 on a ``(data, model)`` mesh
and under FSDP, then the Qwen-VL tower (A8) and ``profile_trace`` (A12).

Multi-rank cases run their ranks as separate processes over gloo
(``tests/torch_parallel_workers.py``: a ``file://`` store in ``tmp_path``,
one thread a rank, no jax in the ranks, a timeout on each), several checks
a spawn, shared by the tests below through module fixtures. Inputs come from
numpy seeds; the rank shards come from the JAX trees through
``from_jax.llama_shard``. Tolerances: the LLaMA's logits 2e-4, as the JAX
package holds its own TP forward (``tests/test_peft_multichip.py:92``);
``generate``'s ids exactly and ``img_gen_feat`` 5e-4; a stage-3 step's
losses, gradients and parameters 5e-4 of each tensor's largest magnitude,
with SGD and momentum (AdamW's first step is about ``lr * sign(g)``, which
hides scale errors); the CLI's FSDP losses 1e-5 of its DP ones.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diffsensei_tpu.core.config import (
    AgentConfig as JAgentConfig, LlamaConfig as JLlamaConfig, LoRAConfig as JLoRAConfig,
    QwenResamplerConfig as JQwenResamplerConfig, VisionEncoderConfig as JVisionEncoderConfig)
from diffsensei_tpu.models.mllm import llama as jllama, quant as jquant
from diffsensei_tpu.models.mllm import qwen_visual as jqv
from diffsensei_tpu.parallel import mesh as jmesh
from diffsensei_tpu.train import optim as joptim

from diffsensei_tpu_torch.core import config as tconfig
from diffsensei_tpu_torch.models.mllm import llama as tllama, quant as tquant
from diffsensei_tpu_torch.models.mllm import qwen_visual as tqv
from diffsensei_tpu_torch.ops import int4_matmul as ti4
from diffsensei_tpu_torch.parallel import mesh as tmesh, tensor as ttensor
from diffsensei_tpu_torch.train import cli as train_cli
from diffsensei_tpu_torch.utils import from_jax
from diffsensei_tpu_torch.utils.observability import profile_trace, span

from tests.torch_parallel_workers import REPO, run_ranks
from tests.torch_port_util import agents, near_one_norms, port_names, random_tree

torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a))
RANK_TIMEOUT = 300


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


# A LLaMA every layout splits over 2 and 4 ranks: 8 heads over 4 KV heads, an
# int4 row input of 512 (128 a rank at tp = 4, one scale group), and a
# vocabulary of 31 that neither divides (16 + 15; 8 + 8 + 8 + 7).
TP_CFG = JLlamaConfig(vocab_size=31, hidden_size=512, intermediate_size=512, num_layers=2,
                      num_heads=8, num_kv_heads=4, max_position_embeddings=32)
LAYOUTS = ("bf16", "lora", "int8", "int4")
TP_SIZES = (2, 4)


def _port_cfg(cfg):
    return tconfig.LlamaConfig(**dataclasses.asdict(cfg))


def _jax_llama(layout, seed=0):
    """(JAX model, its params) in ``layout``: float weights ("bf16": the
    layout the bf16 LLaMA serves and trains in, computed here in fp32),
    with LoRA adapters of rank 4, int8 or int4."""
    lora = 4 if layout == "lora" else 0
    model = jllama.LlamaForCausalLM(TP_CFG, lora_rank=lora)
    params = near_one_norms(random_tree(model, input_ids=jnp.zeros((1, 8), jnp.int32),
                                        seed=seed))
    if layout in ("int8", "int4"):
        params = jquant.quantize_llm_params(params, bits=int(layout[3]))
        model = jllama.LlamaForCausalLM(TP_CFG, quantized="int4" if layout == "int4" else True)
    return model, params


def _port_quantized(layout):
    return layout if layout in ("int8", "int4") else False


@pytest.fixture(scope="module")
def jax_llamas():
    ids = np.random.default_rng(5).integers(0, TP_CFG.vocab_size, (2, 9))
    out = {}
    for layout in LAYOUTS:
        model, params = _jax_llama(layout)
        logits, hidden, _ = jax.jit(model.apply)(params, jnp.asarray(ids))
        out[layout] = dict(params=params, logits=np.asarray(logits), hidden=np.asarray(hidden))
    return ids, out


# ---------------------------------------------------------------------------
# (a) the rule table against JAX's param_specs
# ---------------------------------------------------------------------------
def _jax_dims(params, port_name_of):
    """JAX's sharded dim of each leaf under its rules, by port name and in
    the port's layout: a dense ``weight`` is the JAX kernel transposed."""
    leaves = jax.tree.leaves(jmesh.param_specs(params, jmesh.llm_param_sharding_rules()),
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    shapes = [np.shape(x) for x in jax.tree.leaves(params)]
    out = {}
    for name, idx in port_name_of.items():
        spec = tuple(leaves[idx]) + (None,) * (len(shapes[idx]) - len(tuple(leaves[idx])))
        dim = next((i for i, a in enumerate(spec) if a == jmesh.MODEL_AXIS), None)
        if dim is not None and name.endswith(".weight") and len(shapes[idx]) == 2 \
                and name != "embed_tokens.weight":
            dim = 1 - dim
        out[name] = dim
    return out


def _projection_names(suffix, projs=None):
    projs = projs or ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                      "down_proj")
    block = lambda p: "attn" if p in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
    return {f"layers.{i}.{block(p)}.{p}.{suffix}" for i in range(TP_CFG.num_layers)
            for p in projs}


# where the port's table differs from JAX's (ROADMAP C: the JAX rules'
# `q_proj.kernel` pattern misses `q_proj.base.kernel`, and their 1-D scale
# rule lands on int4's group rows)
RULE_DIFFERENCES = {
    "bf16": _projection_names("base.weight"),
    "lora": _projection_names("base.weight")
    | _projection_names("lora_B.weight", ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"))
    | _projection_names("lora_A.weight", ("o_proj", "down_proj")),
    "int8": set(),
    "int4": _projection_names("base.kernel_scale") | {"lm_head.kernel_scale"},
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rule_table_against_jax_param_specs(layout):
    """The port's ``llm_param_sharding_rules`` equal JAX's wherever JAX's
    rules match; the names where they differ are exactly the ones the JAX
    rules get wrong (trap 1), and each of those the port shards."""
    _, params = _jax_llama(layout)
    names = port_names(params, from_jax.llama)
    want = _jax_dims(params, names)
    rules = tmesh.llm_param_sharding_rules()
    got = {k: tmesh.sharded_dim(k, v.ndim, rules) for k, v in from_jax.llama(params).items()}
    differ = {n for n in got if got[n] != want[n]}
    assert differ == RULE_DIFFERENCES[layout]
    assert all(got[n] is not None for n in differ)
    assert sum(d is not None for d in got.values()) > 2 * TP_CFG.num_layers


# ---------------------------------------------------------------------------
# (b) shard_llama_state round trips and refusals
# ---------------------------------------------------------------------------
def _unpacked(packed, scale, features):
    """An int4 layer's nibbles and scales without its padding columns."""
    return ti4.unpack_int4(packed)[:, :features], scale[:, :features]


@pytest.mark.parametrize("size", TP_SIZES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_shard_llama_state_round_trips(layout, size):
    """The ranks' shards put back together are the whole state: each cut
    on the table's dim (the vocabulary in ceil-sized rows), replicated
    tensors whole on every rank; int4 column shards repacked with their own
    padding hold the whole layer's nibbles and scales, and are the bytes of
    quantizing those columns alone."""
    _, params = _jax_llama(layout)
    whole = from_jax.to_tensors(from_jax.llama(params))
    cfg = _port_cfg(TP_CFG)
    shards = [ttensor.shard_llama_state(whole, cfg, r, size) for r in range(size)]
    rules = tmesh.llm_param_sharding_rules()
    for name, value in whole.items():
        parts = [s[name] for s in shards]
        dim = tmesh.sharded_dim(name, value.dim(), rules)
        if dim is None:
            assert all(torch.equal(p, value) for p in parts), name
            continue
        if whole.get(name.rsplit(".", 1)[0] + ".kernel_q", value).dtype == torch.uint8:
            continue                        # int4: below, by layer
        assert torch.equal(torch.cat(parts, dim=dim), value), name
    for name in [n for n, v in whole.items() if v.dtype == torch.uint8]:
        owner = name[:-len("kernel_q")]
        proj = ttensor._projection(name)
        in_f, out_f = ttensor.projection_shape(cfg, proj)
        column = proj == "lm_head" or ttensor._PROJECTIONS[proj] == "column"
        q, s = _unpacked(whole[name], whole[owner + "kernel_scale"], out_f)
        if not column:
            for part in shards:
                assert part[name].shape[1] == whole[name].shape[1]
            got_q = torch.cat([ti4.unpack_int4(p[name]) for p in shards])[:, :out_f]
            got_s = torch.cat([p[owner + "kernel_scale"] for p in shards])[:, :out_f]
            assert torch.equal(got_q, q) and torch.equal(got_s, s), name
            continue
        cuts = [ttensor.vocab_range(out_f, r, size) if proj == "lm_head"
                else ttensor.even_range(out_f, r, size, proj) for r in range(size)]
        got = [_unpacked(p[name], p[owner + "kernel_scale"], stop - start)
               for p, (start, stop) in zip(shards, cuts)]
        assert torch.equal(torch.cat([g[0] for g in got], dim=1), q), name
        assert torch.equal(torch.cat([g[1] for g in got], dim=1), s), name
        for p, (start, stop) in zip(shards, cuts):
            assert p[name].shape[1] * 2 == ti4.padded_features(stop - start, in_f, 128)
    if layout == "int4":                    # a column shard = quantizing its columns alone
        _, fparams = _jax_llama("bf16")
        w = np.asarray(fparams["params"]["layers_0"]["attn"]["q_proj"]["base"]["kernel"])
        start, stop = ttensor.even_range(w.shape[1], size - 1, size, "q_proj")
        packed, scale = tquant.quantize_kernel_int4(w[:, start:stop])
        got = shards[-1]
        assert np.array_equal(got["layers.0.attn.q_proj.base.kernel_q"].numpy(), packed)
        assert np.array_equal(got["layers.0.attn.q_proj.base.kernel_scale"].numpy(), scale)


@pytest.mark.parametrize("cfg,size,quantized,match", [
    # SEED-X's down_proj: 13824 / 8 = 1728 = 13.5 groups of 128
    (tconfig.LlamaConfig.seed_x_13b(), 8, "int4", "cuts a scale group"),
    (tconfig.LlamaConfig.seed_x_13b(), 3, "int4", "num_heads"),
    (_port_cfg(dataclasses.replace(TP_CFG, num_kv_heads=2)), 4, False, "num_kv_heads"),
    (_port_cfg(dataclasses.replace(TP_CFG, vocab_size=9)), 4, False, "without rows"),
])
def test_model_axis_refuses_what_does_not_split(cfg, size, quantized, match):
    """A tp that cuts an int4 scale group, or does not divide the heads or
    the KV heads, or leaves a rank no vocabulary raises at the build."""
    with pytest.raises(ValueError, match=match):
        ttensor.check_model_axis(cfg, size, quantized)
    with pytest.raises(ValueError, match=match), torch.device("meta"):
        tllama.LlamaForCausalLM(cfg, quantized=quantized,
                                tp_group=ttensor.ScheduleRank(ttensor.ScheduleGroup(size), 0))


def test_seed_x_splits_over_two_and_four_ranks():
    """SEED-X at full width splits over 1, 2 and 4 ranks in int4, with
    the shard shapes the card's B6 rows time."""
    cfg = tconfig.LlamaConfig.seed_x_13b()
    for size in (1, 2, 4):
        ttensor.check_model_axis(cfg, size, "int4")
    assert ttensor.vocab_range(cfg.vocab_size, 1, 2) == (16165, 32330)
    assert [b - a for a, b in (ttensor.vocab_range(cfg.vocab_size, r, 4) for r in range(4))] \
        == [8083, 8083, 8083, 8081]
    assert ti4.padded_features(16165, 5120, 128) == 16384
    assert ti4.padded_features(3456, 5120, 128) == 3584


# ---------------------------------------------------------------------------
# (c) the TP forward on gloo ranks, (d) TP generate, (e) stage 3 on a mesh
# ---------------------------------------------------------------------------
GEN_CFG = JAgentConfig(
    llm=JLlamaConfig(vocab_size=301, hidden_size=256, intermediate_size=256, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_position_embeddings=64),
    lora=JAgentConfig.tiny().lora,
    input_resampler=JQwenResamplerConfig.tiny(embed_dim=256, kv_dim=32),
    output_resampler=JQwenResamplerConfig.tiny(embed_dim=32, kv_dim=256))


def _generate_case(quantized):
    """A prompt with a comprehension block, ending with <img>."""
    from diffsensei_tpu_torch.data import mllm_dataset as tdata

    jagent, tagent = agents(GEN_CFG, seed=5, quantized=quantized)
    nq = GEN_CFG.input_resampler.num_queries
    vocab = GEN_CFG.llm.vocab_size
    ladder = list(range(vocab - nq - 2, vocab))
    spec = tdata.MLLMTokenSpec(bos_id=1, eos_id=2, pad_id=0, boi_id=ladder[0],
                               eoi_id=ladder[-1], img_ids=ladder[1:-1],
                               encode_text=lambda t: [(ord(c) % 40) + 3 for c in t if c != " "])
    prompt = tdata.build_inference_prompt(spec.encode_text("a cat"), spec, [9])
    chars = np.random.default_rng(9).normal(
        size=(1, nq, GEN_CFG.input_resampler.kv_dim)).astype(np.float32)
    kw = dict(ladder_ids=spec.ladder_ids, max_new_tokens=nq + 9)
    want = jagent.generate(prompt["input_ids"], image_embeds=jnp.asarray(chars),
                           ids_cmp_mask=jnp.asarray(prompt["ids_cmp_mask"]), **kw)
    case = dict(config=tagent.config, quantized="int4" if quantized else False,
                state={n: getattr(tagent, n).state_dict()
                       for n in ("llm", "input_resampler", "output_resampler")},
                input_ids=prompt["input_ids"], image_embeds=T(chars),
                ids_cmp_mask=prompt["ids_cmp_mask"], kwargs=kw)
    return case, want


def _llama_cases(jax_llamas, size):
    ids, ref = jax_llamas
    return {layout: dict(config=_port_cfg(TP_CFG), lora_rank=4 if layout == "lora" else 0,
                         quantized=_port_quantized(layout), ids=T(ids),
                         shards=[from_jax.to_tensors(from_jax.llama_shard(
                             ref[layout]["params"], _port_cfg(TP_CFG), r, size))
                             for r in range(size)])
            for layout in LAYOUTS}


@pytest.fixture(scope="module")
def two_ranks(jax_llamas, tmp_path_factory):
    """The LLaMA in every layout, ``generate`` (float and int4) and the
    float agent's int4 host load on 2 gloo ranks, with the JAX ``generate``
    they are held to."""
    cases, wants = {}, {}
    for name, quantized in (("float", False), ("int4", True)):
        cases[name], wants[name] = _generate_case(quantized)
    outs = run_ranks("model_axis", tmp_path_factory.mktemp("tp2"), 2,
                     {"llama": _llama_cases(jax_llamas, 2), "generate": cases,
                      "host_int4": cases["float"]}, timeout=RANK_TIMEOUT)
    return outs, wants


def _stage3_case():
    """The tiny stacks, an agent whose LLaMA splits over 2 ranks (4 heads
    over 2 KV heads, vocabulary 96), a batch of 4 with unequal counts over
    the data ranks, the JAX single-device step's draws, losses, first
    gradients and parameters after two SGD-with-momentum steps."""
    from tests.test_torch_port_parallel import _global_batch, _stage3_batch_fields
    from tests.torch_port_util import tiny_pipelines
    from diffsensei_tpu.models.mllm import peft as jpeft
    from diffsensei_tpu.models.schedulers import DDPMSchedule as JDDPM
    from diffsensei_tpu.train import diffusion as jdiff, mllm_step as jstep3

    jpipe, tpipe = tiny_pipelines()
    tpipe.m.vae.load_state_dict(from_jax.to_tensors(
        from_jax.vae(jpipe.m.vae_params, jpipe.m.vae.config)))
    jm = jpipe.m
    manga = jm.manga
    llm = JLlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=2,
                       num_heads=4, num_kv_heads=2, max_position_embeddings=64)
    iv, kv = manga.num_ip_tokens, jm.unet.config.cross_attention_dim
    cfg = JAgentConfig(
        llm=llm, lora=JLoRAConfig(rank=4),
        input_resampler=JQwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                             embed_dim=llm.hidden_size, num_heads=4, kv_dim=kv),
        output_resampler=JQwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                              embed_dim=kv, num_heads=4,
                                              kv_dim=llm.hidden_size))
    jagent, tagent = agents(cfg, seed=9)
    batch = _stage3_batch_fields(_global_batch(manga, sources=1), manga, llm.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(2)
    mean, _ = jm.vae.apply(jm.vae_params, jbatch["pixel_values"], method=jm.vae.encode)
    rng_n, rng_t = jax.random.split(jax.random.fold_in(rng, 1))
    draws = dict(latent_noise=np.asarray(jax.random.normal(jax.random.fold_in(rng, 0),
                                                           mean.shape)),
                 noise=np.asarray(jax.random.normal(rng_n, mean.shape)),
                 timesteps=np.asarray(jax.random.randint(rng_t, (4,), 0, 1000)))
    jfrozen = jdiff.FrozenDiffusionStack(
        vae=jm.vae, vae_params=jm.vae_params, text_encoder=jm.text_encoder,
        text_encoder_params=jm.text_encoder_params, text_encoder_2=jm.text_encoder_2,
        text_encoder_2_params=jm.text_encoder_2_params, image_encoder=jm.image_encoder,
        image_encoder_params=jm.image_encoder_params, magi_encoder=jm.magi_encoder,
        magi_encoder_params=jm.magi_encoder_params, unet_params=jm.unet_params,
        resampler_params=jm.resampler_params, vae_scaling=jm.vae.config.scaling_factor)
    jstep = jstep3.make_stage3_step(jm.unet, jm.resampler, jagent, JDDPM(),
                                    jstep3.Stage3Config(manga=manga))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jfrozen, jbatch, rng), has_aux=True))
    params = {"llm": jagent.llm_params, "input_resampler": jagent.input_resampler_params,
              "output_resampler": jagent.output_resampler_params}
    mask = {"llm": jpeft.lora_trainable_mask(params["llm"]),
            "input_resampler": jax.tree.map(lambda _: True, params["input_resampler"]),
            "output_resampler": jax.tree.map(lambda _: True, params["output_resampler"])}
    lr = 0.1
    metrics_want, grads0, buf = [], None, None
    for s in range(3):
        (loss, metrics), g = grad_fn(params)
        metrics_want.append({"loss": float(loss), **{k: float(v) for k, v in metrics.items()}})
        g = jax.tree.map(lambda g_, m: g_ if m else jnp.zeros_like(g_), g, mask)
        if s == 2:
            break
        grads0 = g if grads0 is None else grads0
        buf = g if buf is None else jax.tree.map(lambda b_, g_: 0.9 * b_ + g_, buf, g)
        params = jax.tree.map(lambda p, b_, m: p - lr * b_ if m else p, params, buf, mask)
    # the third step: make_optimizer's clip and AdamW, the clip at a quarter of
    # the norm and eps at the clipped norm, above every clipped element, so
    # that AdamW's first update, lr g c / (|g c| + eps), is near lr g c / eps:
    # it shows the clip factor c, as a gradient's scale; at a rate of 1 the
    # update is of the weights' order, so that a weight's 5e-4 holds it
    norm = float(optax.global_norm(g))
    adamw = dict(learning_rate=1.0, weight_decay=0.05, max_grad_norm=norm / 4, eps=norm / 4)
    tx = joptim.make_optimizer(trainable_mask=mask, **adamw)
    updates, _ = tx.update(g, tx.init(params), params)
    adamw_params = optax.apply_updates(params, updates)
    by_name = lambda tree: {f"{net}.{k}": v for net, sd in from_jax.agent_tree(tree).items()
                            for k, v in sd.items()}
    case = dict(mesh=dict(data=2, model=2), lr=lr, adamw=adamw, agent_config=tagent.config,
                state={name: mod.state_dict() for name, mod in tpipe.m.networks().items()},
                agent_state={n: getattr(tagent, n).state_dict()
                             for n in ("llm", "input_resampler", "output_resampler")},
                batch={k: T(v) for k, v in batch.items()},
                draws={k: T(v) for k, v in draws.items()})
    frozen_llm = {k: v for k, v in tagent.llm.state_dict().items() if ".base." in k}
    return case, dict(metrics=metrics_want, grads=by_name(grads0), params=by_name(params),
                      norm=norm, adamw_params=by_name(adamw_params), frozen=frozen_llm)


@pytest.fixture(scope="module")
def four_ranks(jax_llamas, tmp_path_factory):
    """The LLaMA in every layout on 4 gloo ranks, then a stage-3 step on a
    ``(data=2, model=2)`` mesh of the same ranks."""
    case, want = _stage3_case()
    outs = run_ranks("model_axis", tmp_path_factory.mktemp("tp4"), 4,
                     {"llama": _llama_cases(jax_llamas, 4), "stage3": case},
                     timeout=RANK_TIMEOUT)
    return outs, want


def _ranks(request, size):
    return request.getfixturevalue("two_ranks" if size == 2 else "four_ranks")[0]


@pytest.mark.parametrize("size", TP_SIZES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_forward_on_ranks_matches_jax(request, jax_llamas, layout, size):
    """``LlamaForCausalLM(..., tp_group=g)`` on 2 and 4 gloo ranks, each
    with its shards of the JAX tree: every rank's whole logits and hidden
    state within 2e-4 of JAX's ``apply``, the vocabulary split unevenly and
    no padded column among the logits; a cached prefill and one decode step
    on a cache of the rank's KV heads give the full forward's last logits."""
    _, ref = jax_llamas
    for r, out in enumerate(_ranks(request, size)):
        got = out["llama"][layout]
        assert got["logits"].shape == ref[layout]["logits"].shape
        _close(got["logits"], ref[layout]["logits"], 2e-4, f"{layout} rank {r} logits")
        _close(got["hidden"], ref[layout]["hidden"], 2e-4, f"{layout} rank {r} hidden")
        _close(got["decode"][:, 0], ref[layout]["logits"][:, -1], 2e-4, f"{layout} decode")
        assert got["cache_shape"][1] == TP_CFG.num_kv_heads // size
        start, stop = ttensor.vocab_range(TP_CFG.vocab_size, r, size)
        assert got["embed_rows"] == stop - start


@pytest.mark.parametrize("name", ["float", "int4"])
def test_tp_generate_on_two_ranks_matches_jax(two_ranks, name):
    """The agent cut over 2 ranks (``shard_agent``) decodes JAX's ids on
    both ranks, forced ladder included; ``img_gen_feat`` within 5e-4; each
    rank's KV cache holds half the KV heads."""
    outs, wants = two_ranks
    want = wants[name]
    for r, out in enumerate(outs):
        got = out["generate"][name]
        np.testing.assert_array_equal(got["output_ids"], np.asarray(want["output_ids"]))
        assert got["num_gen_imgs"] == want["num_gen_imgs"] >= 1
        _close(got["img_gen_feat"], want["img_gen_feat"], 5e-4, f"rank {r} img_gen_feat")
        assert got["cache_shape"][1] == GEN_CFG.llm.num_kv_heads // 2


def test_host_int4_load_cuts_each_rank_its_shards(two_ranks):
    """``quantize_agent_on_host(..., bits=4, tp_group=g)`` on 2 gloo ranks:
    each rank's LLaMA state is byte for byte ``shard_llm`` of
    ``quantize_agent`` of the whole agent (int4 column shards repacked),
    and its ``generate`` gives the unsharded int4 agent's ids, its
    ``img_gen_feat`` within 5e-4."""
    outs, _ = two_ranks
    for r, out in enumerate(outs):
        got = out["host_int4"]
        assert got["differ"] == [] and got["names"] > 0, f"rank {r}: {got['differ']}"
        sharded, whole = got["sharded"], got["whole"]
        np.testing.assert_array_equal(sharded["output_ids"], whole["output_ids"])
        assert sharded["num_gen_imgs"] == whole["num_gen_imgs"] >= 1
        _close(sharded["img_gen_feat"], whole["img_gen_feat"].numpy(), 5e-4,
               f"rank {r} img_gen_feat")


def _unshard(parts, name):
    """The whole tensor from the model ranks' parts of the LLaMA's ``name``
    (None: not the LLaMA's): cut on the table's dim, else bit-equal on
    every rank."""
    rules = tmesh.llm_param_sharding_rules()
    dim = None if name is None else tmesh.sharded_dim(name, parts[0].dim(), rules)
    if dim is None:
        for p in parts[1:]:
            assert torch.equal(p, parts[0]), f"{name} differs across the model ranks"
        return parts[0]
    return torch.cat(parts, dim=dim)


def _llm_name(name):
    return name[len("llm."):] if name.startswith("llm.") else None


def test_stage3_step_on_data_model_mesh_matches_jax(four_ranks):
    """Two SGD-with-momentum steps of stage 3 on a ``(data=2, model=2)``
    mesh of 4 gloo ranks (the tiny agent's LLaMA cut over the model axis,
    LoRA rank 4, per-layer remat under the ``attn`` policy; DDP and the
    step's reductions over the data axis; each data rank with rows
    ``[rank::2]`` of a batch of 4 whose ranks hold
    different counts of panels, tokens and generation images) against the
    JAX single-device step on the global batch, 5e-4: the global loss and
    its parts on every rank, the first step's synced gradients and the
    trainables after the second put together from the model ranks'
    shards. Replicated trainables (norms, resamplers, the replicated LoRA
    halves) are bit-equal across the model ranks, the data ranks hold the
    same shards, and the frozen base is the whole base cut."""
    outs, want = four_ranks
    by = {(o["stage3"]["data_rank"], o["stage3"]["model_rank"]): o["stage3"] for o in outs}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for (d, m), got in by.items():
        for s, w in enumerate(want["metrics"]):
            for k in ("loss", "loss_diffusion", "loss_lm", "loss_rec", "loss_mllm"):
                _close(torch.tensor(got["losses"][s][k]), w[k], 5e-4, f"{d},{m} {k} {s}")
        for key in ("params", "frozen"):
            for name, p in got[key].items():
                assert torch.equal(p, by[(1 - d, m)][key][name]), (key, name)
    for key in ("grads", "params"):
        assert set(by[(0, 0)][key]) <= set(want[key])     # want: the frozen base too
        for name in by[(0, 0)][key]:
            whole = _unshard([by[(0, m)][key][name] for m in (0, 1)], _llm_name(name))
            _close(whole, want[key][name], 5e-4, f"{key} {name}")
    assert set(by[(0, 0)]["frozen"]) == set(want["frozen"])
    for name, value in want["frozen"].items():
        assert torch.equal(_unshard([by[(0, m)]["frozen"][name] for m in (0, 1)], name), value)


def test_stage3_adamw_step_on_data_model_mesh_matches_jax(four_ranks):
    """A third step of the same run, with ``make_optimizer`` (global-norm
    clip at a quarter of the norm, then AdamW with eps at the clipped norm,
    so that the update scales with the clip factor),
    against the JAX package's ``make_optimizer`` from the JAX state after
    its two SGD steps: the global norm on every rank (the model-sharded
    LLaMA leaves' squares summed over the model axis, the replicated ones
    counted once) and the loss within 5e-4; the trainables after it (a
    rate of 1, an update of the weights' order) within 5e-4 of each
    tensor's largest magnitude, put together from the model ranks' shards,
    the replicated ones bit-equal across the model ranks and every one
    across the data ranks."""
    outs, want = four_ranks
    by = {(o["stage3"]["data_rank"], o["stage3"]["model_rank"]): o["stage3"] for o in outs}
    for (d, m), got in by.items():
        _close(torch.tensor(got["norm"]), want["norm"], 5e-4, f"{d},{m} global norm")
        _close(torch.tensor(got["losses"][2]["loss"]), want["metrics"][2]["loss"], 5e-4,
               f"{d},{m} loss 2")
        for name, p in got["adamw_params"].items():
            assert torch.equal(p, by[(1 - d, m)]["adamw_params"][name]), name
    moved = 0
    for name in by[(0, 0)]["adamw_params"]:
        whole = _unshard([by[(0, m)]["adamw_params"][name] for m in (0, 1)], _llm_name(name))
        _close(whole, want["adamw_params"][name], 5e-4, f"AdamW step {name}")
        moved += not np.allclose(want["adamw_params"][name], want["params"][name])
    assert moved == len(by[(0, 0)]["adamw_params"])


# ---------------------------------------------------------------------------
# (f) the train CLI: stage mllm under fsdp
# ---------------------------------------------------------------------------
def _torchrun(cfg, log_dir, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "diffsensei_tpu_torch.train.cli", "--config", os.fspath(cfg), "--device",
           "cpu", "--log_dir", os.fspath(log_dir), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    for name, p in procs.items():
        try:
            log = p.communicate(timeout=RANK_TIMEOUT)[0]
        finally:
            p.kill()
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"


def _records(log_dir):
    return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]


def _write_stage3_run(root, **trainer):
    """A tiny stage-3 run (the train CLI's YAML) over three synthetic pages."""
    from tests.torch_port_util import mangazero_pages

    root.mkdir(parents=True)
    anns = mangazero_pages(np.random.default_rng(10))
    for ann in anns:
        ann.pop("image").save(root / ann["image_path"])
    (root / "annotations.json").write_text(json.dumps(anns))
    trainer = {"max_train_steps": 2, "log_every": 1, "checkpoint_every": 2, "seed": 0,
               **trainer}
    cfg = root / "config.yaml"
    cfg.write_text(f"""
stage: mllm
model:
  preset: tiny
  remat: true
  agent: {{lora_rank: 4, remat: true}}
train_data:
  ann_path: {root}/annotations.json
  image_root: {root}
  batch_size: 1
  max_num_ip_sources: 1
  max_token_length: 48
  num_workers: 1
optimizer: {{lr: 1.0e-3, weight_decay: 0.05, max_grad_norm: 1.0}}
lr_scheduler: {{name: constant}}
trainer:
""" + "".join(f"  {k}: {v}\n" for k, v in trainer.items()))
    return cfg


def test_train_cli_stage3_under_fsdp_on_two_ranks(tmp_path):
    """``stage: mllm`` with ``trainer.parallel: fsdp`` (parameters of 1024
    elements or more sharded) through the train CLI under
    ``torch.distributed.run`` on 2 CPU ranks: the losses of its 2 steps
    within 1e-5 of ``parallel: dp``'s on the same ranks, a whole-tensor
    checkpoint under the names and shapes of the DP one, then resumed to a
    third step."""
    runs = {mode: (_write_stage3_run(tmp_path / mode, parallel=mode, fsdp_min_size=1024),
                   tmp_path / mode / "logs") for mode in ("dp", "fsdp")}
    _wait({mode: _torchrun(cfg, log) for mode, (cfg, log) in runs.items()})
    dp, fsdp = (_records(runs[m][1]) for m in ("dp", "fsdp"))
    assert [r["step"] for r in fsdp] == [r["step"] for r in dp] == [1, 2]
    for a, b in zip(fsdp, dp):
        for k in ("loss", "loss_diffusion", "loss_lm", "loss_rec"):
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-30), k
    ckpt = {m: torch.load(runs[m][1] / "step-2" / "ckpt.pt", weights_only=False)["state"]
            for m in ("dp", "fsdp")}
    assert {k: v.shape for k, v in ckpt["fsdp"]["params"].items()} \
        == {k: v.shape for k, v in ckpt["dp"]["params"].items()}
    assert all(type(v) is torch.Tensor for v in ckpt["fsdp"]["params"].values())
    assert any(k.startswith("llm.layers.") for k in ckpt["fsdp"]["params"])
    cfg, log = runs["fsdp"]
    _wait({"resume": _torchrun(cfg, log, "--resume", "--max_train_steps", "3")})
    assert [r["step"] for r in _records(log)] == [1, 2, 3]
    assert np.isfinite(_records(log)[-1]["loss"])


# ---------------------------------------------------------------------------
# (g) model_axis_schedule against the unsharded LLaMA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", TP_SIZES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_model_axis_schedule_matches_unsharded(jax_llamas, layout, size):
    """The ranks' shard sets in one process (the all-reduces as sums in rank
    order): logits and hidden state of a full forward and of a cached
    prefill + decode step against the unsharded port LLaMA, 1e-5 of the
    largest logit; each shard set's KV cache a 1/size of the whole."""
    ids, ref = jax_llamas
    cfg = _port_cfg(TP_CFG)
    llm = tllama.LlamaForCausalLM(cfg, lora_rank=4 if layout == "lora" else 0,
                                  quantized=_port_quantized(layout), device="cpu")
    llm.load_state_dict(from_jax.to_tensors(from_jax.llama(ref[layout]["params"])))
    shards = ttensor.shard_sets(llm, size)
    ids = T(ids)
    b, s = ids.shape
    pos = torch.arange(s)[None].expand(b, s)
    with torch.no_grad():
        want, want_hidden, _ = llm(ids)
        got, hidden, _ = ttensor.model_axis_schedule(shards, input_ids=ids)
        caches = [tllama.init_caches(cfg, b, s, tp=size) for _ in shards]
        _, _, caches = ttensor.model_axis_schedule(shards, input_ids=ids[:, :-1],
                                                   positions=pos[:, :-1], caches=caches,
                                                   cache_index=0)
        step, _, _ = ttensor.model_axis_schedule(shards, input_ids=ids[:, -1:],
                                                 positions=pos[:, -1:], caches=caches,
                                                 cache_index=s - 1)
    _close(got, want, 1e-5, "logits")
    _close(hidden, want_hidden, 1e-5, "hidden")
    _close(step[:, 0], want[:, -1], 1e-5, "decode")
    _close(got, ref[layout]["logits"], 2e-4, "against JAX")
    assert caches[0][0][0].shape[1] == cfg.num_kv_heads // size


def test_schedule_group_sums_in_rank_order_and_refuses_a_mismatch():
    """``ScheduleGroup``: every rank's all-reduce gives the ranks' sum, one
    rank alone its own tensor; a rank that leaves before an all-reduce the
    others wait in raises instead of hanging, and a shard set called
    outside ``model_axis_schedule`` raises."""
    group = ttensor.ScheduleGroup(3)

    def job(rank, reduces):
        def run():
            y = torch.full((2,), float(rank + 1))
            for _ in range(reduces):
                group.all_reduce_(y, rank)
            return y
        return run

    out = group.run({r: job(r, 2) for r in range(3)})
    assert all(torch.equal(out[r], torch.full((2,), 18.0)) for r in range(3))
    assert torch.equal(group.run({1: job(1, 3)})[1], torch.full((2,), 2.0))
    with pytest.raises(RuntimeError, match="left the schedule"):
        group.run({0: job(0, 2), 1: job(1, 1), 2: job(2, 2)})
    with pytest.raises(RuntimeError, match="inside it only"):
        job(0, 1)()
    llm = tllama.LlamaForCausalLM(_port_cfg(TP_CFG), device="cpu")
    shard = ttensor.shard_sets(llm, 2)[0]
    with pytest.raises(RuntimeError, match="inside it only"), torch.no_grad():
        shard(torch.zeros((1, 2), dtype=torch.long))


# ---------------------------------------------------------------------------
# (h) A8: the Qwen-VL tower; A12: profile_trace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,tgt", [(16, 32), (16, 8)])
def test_interpolate_abs_pos_matches_jax_and_not_f_interpolate(src, tgt):
    """The position table's bicubic resize equals ``jax.image.resize``'s
    (Keys a = -0.5, antialiased when shrinking) within 1e-5; torch's
    ``F.interpolate`` bicubic (a = -0.75) would be far off."""
    pos = np.random.default_rng(3).normal(size=(src * src, 24)).astype(np.float32)
    want = np.asarray(jqv.interpolate_abs_pos(jnp.asarray(pos), tgt * tgt))
    got = tqv.interpolate_abs_pos(T(pos), tgt * tgt)
    _close(got, want, 1e-5)
    grid = T(pos).reshape(1, src, src, -1).permute(0, 3, 1, 2)
    other = torch.nn.functional.interpolate(grid, size=(tgt, tgt), mode="bicubic",
                                            align_corners=False)
    other = other.permute(0, 2, 3, 1).reshape(tgt * tgt, -1)
    assert float((other - got).abs().max()) > 0.1
    same = T(pos)
    assert tqv.interpolate_abs_pos(same, src * src) is same


QV_CFG = JVisionEncoderConfig(image_size=56, patch_size=14, hidden_size=32, num_layers=2,
                              num_heads=4, intermediate_size=64)
QV_POOL = JQwenResamplerConfig(grid_size=2, embed_dim=48, num_heads=4, kv_dim=32)


@pytest.mark.parametrize("pooled,pixels", [(False, 56), (True, 56), (True, 112)])
def test_qwen_visual_matches_jax(pooled, pixels):
    """``QwenVisionTransformer`` (its 256-row table resized to the 4 x 4
    grid) and ``VisionTransformerWithAttnPool`` (its own 4 x 4 table, and
    resized to 8 x 8 at twice the pixels) with the JAX trees' weights
    through ``from_jax.qwen_visual``, 1e-4 of the largest output."""
    x = np.random.default_rng(4).uniform(0, 1, (2, pixels, pixels, 3)).astype(np.float32)
    if pooled:
        jmod = jqv.VisionTransformerWithAttnPool(QV_CFG, QV_POOL, output_dim=40)
    else:
        jmod = jqv.QwenVisionTransformer(QV_CFG)
    params = random_tree(jmod, jnp.zeros((1, pixels, pixels, 3)), seed=6)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    cfg = tconfig.VisionEncoderConfig(**dataclasses.asdict(QV_CFG))
    if pooled:
        mod = tqv.VisionTransformerWithAttnPool(
            cfg, tconfig.QwenResamplerConfig(**dataclasses.asdict(QV_POOL)), output_dim=40)
    else:
        mod = tqv.QwenVisionTransformer(cfg)
    mod.load_state_dict(from_jax.to_tensors(from_jax.qwen_visual(params, QV_CFG.num_heads)))
    with torch.no_grad():
        got = mod(T(x))
    assert got.shape == want.shape
    _close(got, want, 1e-4)


def test_profile_trace_writes_a_trace(tmp_path):
    """``profile_trace(dir)`` writes one Chrome trace of the block, with
    the program's spans opened in it; without a directory it is a no-op."""
    with profile_trace(os.fspath(tmp_path / "trace")) as prof:
        with span("serve.request", request=0):
            torch.ones(64).sum()
    files = list((tmp_path / "trace").iterdir())
    events = json.loads(files[0].read_text())["traceEvents"]
    assert len(files) == 1 and events
    assert any(e.get("name") == "serve.request" for e in events)
    assert any("aten::ones" in e.key for e in prof.key_averages())
    with profile_trace(None) as prof:
        assert prof is None
