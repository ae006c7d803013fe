"""The PyTorch port's stage-3 (SEED-X agent) training path against the JAX
package (CPU, fp32).

Inputs, noise and timesteps come from numpy seeds (the train step is fed the
JAX step's own draws); weights cross from the JAX trees through
``diffsensei_tpu_torch.utils.from_jax``. Kernel B5's plain twin is held
against the Pallas kernel in interpret mode at 1e-5; the losses, the masks
and the data exactly or within 1e-6; the agent's loss and gradients and one
train step within 5e-4 of each tensor's largest magnitude.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffsensei_tpu.core.config import AgentConfig, LlamaConfig, LoRAConfig, QwenResamplerConfig
from diffsensei_tpu.data import mllm_dataset as jdata
from diffsensei_tpu.data.bucket_dataset import BucketDatasetConfig as JBucketConfig
from diffsensei_tpu.models.mllm import llama as jllama
from diffsensei_tpu.models.mllm import peft as jpeft
from diffsensei_tpu.models.schedulers import DDPMSchedule as JDDPM
from diffsensei_tpu.models.unet import MangaCrossAttention as JCrossAttention
from diffsensei_tpu.ops import dual_cross_attention as jdca
from diffsensei_tpu.train import diffusion as jdiff, mllm_step as jstep3, optim as joptim

from diffsensei_tpu_torch.core import config as tconfig
from diffsensei_tpu_torch.data import mllm_dataset as tdata
from diffsensei_tpu_torch.data.bucket_dataset import BucketDatasetConfig as TBucketConfig
from diffsensei_tpu_torch.models.mllm import llama as tllama
from diffsensei_tpu_torch.models.mllm import peft as tpeft
from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
from diffsensei_tpu_torch.models.unet import MangaCrossAttention
from diffsensei_tpu_torch.ops import attention as tatt
from diffsensei_tpu_torch.ops import dual_cross_attention as tdca
from diffsensei_tpu_torch.train import cli, diffusion as tdiff, mllm_step as tstep3
from diffsensei_tpu_torch.train import optim as toptim
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import (
    agents, mangazero_pages, near_one_norms, port_names, random_tree, tiny_pipelines)

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))      # numpy/JAX array -> CPU tensor


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


# ---------------------------------------------------------------------------
# ops/dual_cross_attention.py: kernel B5's plain twin and its autograd
# ---------------------------------------------------------------------------
def _dual_inputs(b=2, h=3, s=64, d=16, seed=0):
    """``tests/test_dual_cross_attention.py``'s inputs, as numpy."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
    bias = np.where(rng.uniform(size=(b, 1, s, 80)) > 0.4, 0.0, -10000.0).astype(np.float32)
    return (mk(b, h, s, d), mk(b, h, 77, d), mk(b, h, 77, d), mk(b, h, 80, d), mk(b, h, 80, d),
            bias)


@pytest.mark.parametrize("case", ["forward", "odd_tail", "gradients"])
def test_dual_cross_attention_twin_matches_pallas_kernel(case):
    """The three cases of ``tests/test_dual_cross_attention.py``: the forward,
    a q length that is no block multiple (block_q 32), and the gradients of
    q, k and v with no gradient for the bias."""
    args = _dual_inputs(s=50 if case == "odd_tail" else 64, seed=1 if case == "gradients" else 0)
    bias = args[-1]
    if case != "gradients":
        with pltpu.force_tpu_interpret_mode():
            want = jdca.dual_cross_attention(*(jnp.asarray(a) for a in args),
                                             block_q=32 if case == "odd_tail" else 1024)
        got = tdca.dual_cross_attention(*(T(a) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
        return

    def jloss(*a):
        o1, o2 = jdca.dual_cross_attention(*a, jnp.asarray(bias))
        return jnp.sum(jnp.tanh(o1 + 0.6 * o2))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args[:5]))
    inputs = [T(a).requires_grad_() for a in args[:5]]
    tbias = T(bias).requires_grad_()
    o1, o2 = tdca.dual_cross_attention(*inputs, tbias)
    torch.tanh(o1 + 0.6 * o2).sum().backward()
    assert tbias.grad is None
    for x, w in zip(inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_dual_cross_attention_backward_takes_only_the_needed_gradients():
    q, kt, vt, ki, vi, bias = (T(a) for a in _dual_inputs(s=20))
    ki.requires_grad_()
    o1, o2 = tdca.dual_cross_attention(q, kt, vt, ki, vi, bias)
    (o1.sum() + o2.square().sum()).backward()    # o_text takes no part: no kt in the graph
    kif = ki.detach().requires_grad_()
    tatt.attention_ref(q, kif, vi, bias).square().sum().backward()
    torch.testing.assert_close(ki.grad, kif.grad, rtol=0, atol=0)
    assert q.grad is None and kt.grad is None


@pytest.mark.parametrize("with_ip,with_bias", [(True, True), (True, False), (False, False)])
def test_cross_attention_layer_matches_jax_on_the_cpu(with_ip, with_bias):
    """``MangaCrossAttention`` on the CPU keeps the JAX layer's two dispatcher
    calls (B5 is for bf16 on the card) and its output."""
    rng = np.random.default_rng(2)
    b, s, dim, ctx_dim, heads, n_ip = 2, 24, 32, 16, 2, 10
    x = rng.normal(size=(b, s, dim)).astype(np.float32)
    ctx = rng.normal(size=(b, 7, ctx_dim)).astype(np.float32)
    ip = rng.normal(size=(b, n_ip, ctx_dim)).astype(np.float32) if with_ip else None
    bias = (np.where(rng.uniform(size=(b, s, n_ip)) > 0.4, 0.0, -10000.0).astype(np.float32)
            if with_bias else None)
    jmod = JCrossAttention(heads)
    params = random_tree(jmod, jnp.asarray(x), jnp.asarray(ctx),
                         jnp.zeros((b, n_ip, ctx_dim)), None, 1.0, seed=3)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx),
                      None if ip is None else jnp.asarray(ip),
                      None if bias is None else jnp.asarray(bias), 0.6)
    p = params["params"]
    sd = {f"{n}.weight": np.asarray(p[n]["kernel"]).T for n in ("to_q", "to_k", "to_v")}
    sd.update({"to_out.0.weight": np.asarray(p["to_out"]["kernel"]).T,
               "to_out.0.bias": np.asarray(p["to_out"]["bias"]),
               "processor.to_k_ip.weight": np.asarray(p["to_k_ip"]["kernel"]).T,
               "processor.to_v_ip.weight": np.asarray(p["to_v_ip"]["kernel"]).T})
    layer = MangaCrossAttention(dim, ctx_dim, heads)
    layer.load_state_dict(from_jax.to_tensors(sd))
    assert not tdca.uses_kernel(T(x)[:, None], T(ctx)[:, None], T(ctx)[:, None])
    with torch.no_grad():
        got = layer(T(x), T(ctx), None if ip is None else T(ip),
                    None if bias is None else T(bias), 0.6)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# models/mllm: the LM loss, peft, the agent's loss
# ---------------------------------------------------------------------------
def test_cross_entropy_lm_loss_matches_jax_and_is_zero_with_no_label():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 9, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (3, 9))
    labels[rng.random((3, 9)) < 0.4] = -100
    labels[2] = -100                                   # a row with no label
    for lab in (labels, np.full_like(labels, -100)):
        want, jgrad = jax.value_and_grad(
            lambda lg: jllama.cross_entropy_lm_loss(lg, jnp.asarray(lab)))(jnp.asarray(logits))
        tl = T(logits).requires_grad_()
        got = tllama.cross_entropy_lm_loss(tl, T(lab))
        got.backward()
        _close(got, want, 1e-6, "loss")
        _close(tl.grad, jgrad, 1e-6, "grad")
        assert torch.isfinite(got) and torch.isfinite(tl.grad).all()
    assert got.item() == 0.0


LLAMA = LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=3,
                    num_heads=4, num_kv_heads=2, max_position_embeddings=64)


def _llamas(lora_rank=4, seed=0):
    """(JAX LoRA LLaMA params, port LLaMA with the same weights)."""
    jmodel = jllama.LlamaForCausalLM(LLAMA, lora_rank=lora_rank)
    params = near_one_norms(random_tree(jmodel, input_ids=jnp.zeros((1, 8), jnp.int32), seed=seed))
    model = tllama.LlamaForCausalLM(tconfig.LlamaConfig(**dataclasses.asdict(LLAMA)),
                                    lora_rank=lora_rank, device="cpu")
    model.load_state_dict(from_jax.to_tensors(from_jax.llama(params)))
    return params, model


@pytest.mark.parametrize("mask", ["lora", "lora_no_norms", "later", "suffix"])
def test_peft_masks_select_the_jax_set(mask):
    params, model = _llamas()
    jfn, tfn = {
        "lora": (jpeft.lora_trainable_mask, tpeft.lora_trainable_mask),
        "lora_no_norms": (lambda p: jpeft.lora_trainable_mask(p, train_norms=False),
                          lambda m: tpeft.lora_trainable_mask(m, train_norms=False)),
        "later": (lambda p: jpeft.later_layers_mask(p, 3, 1),
                  lambda m: tpeft.later_layers_mask(m, 3, 1)),
        "suffix": (lambda p: jpeft.suffix_trainable_mask(p, ["q_proj", "post_norm"]),
                   lambda m: tpeft.suffix_trainable_mask(m, ["q_proj", "post_norm"])),
    }[mask]
    flags = jax.tree.leaves(jfn(params))
    names = port_names(params, from_jax.llama)
    want = {name for name, i in names.items() if flags[i]}
    got = tfn(model)
    assert got.keys() == names.keys()
    assert {n for n, keep in got.items() if keep} == want and want


def test_resize_vocab_matches_jax():
    params, model = _llamas(seed=1)
    want = from_jax.llama(jpeft.resize_vocab(jax.tree.map(np.asarray, params), 101))
    tpeft.resize_vocab(model, 101)
    assert model.config.vocab_size == 101
    for name in ("embed_tokens.weight", "lm_head.weight"):
        _close(model.state_dict()[name], want[name], 1e-6, name)
    logits, _, _ = model(torch.arange(5)[None])
    assert logits.shape == (1, 5, 101)
    with pytest.raises(ValueError):
        tpeft.resize_vocab(model, 50)


def _agent_config(iv=8, kv=32):
    """The JAX CLI's tiny-preset agent around ``LLAMA``, LoRA rank 4."""
    return AgentConfig(
        llm=LLAMA, lora=LoRAConfig(rank=4),
        input_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                            embed_dim=LLAMA.hidden_size, num_heads=4, kv_dim=kv),
        output_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                             embed_dim=kv, num_heads=4,
                                             kv_dim=LLAMA.hidden_size))


def _spec(vocab, n_img, module=tdata):
    ladder = list(range(vocab - n_img - 2, vocab))
    return module.MLLMTokenSpec(
        bos_id=1, eos_id=2, pad_id=0, boi_id=ladder[0], eoi_id=ladder[-1],
        img_ids=ladder[1:-1], encode_text=lambda s: [(ord(c) % 40) + 3 for c in s if c != " "])


def _streams(cfg, b, length=40):
    """``b`` supervised streams of ``build_mllm_token_stream`` as a batch."""
    spec = _spec(cfg.llm.vocab_size, cfg.input_resampler.num_queries)
    rows = [tdata.build_mllm_token_stream(spec.encode_text(f"panel {k} talks"), spec, [],
                                          length) for k in range(b)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _agent_batch(cfg, seed=5):
    """Two rows: the dataset's layout, and one with the comprehension image
    second (the stable row order) and no generation image (no rec loss)."""
    rng = np.random.default_rng(seed)
    streams = _streams(cfg, 2)
    ir = cfg.input_resampler
    cmp_mask = np.array([[True, False], [False, True]])
    gen_mask = np.array([[False, True], [False, False]])
    return {"input_ids": streams["mllm_input_ids"], "labels": streams["mllm_labels"],
            "image_embeds": rng.normal(size=(2, 2, ir.num_queries, ir.kv_dim)).astype(np.float32),
            "embeds_cmp_mask": cmp_mask, "embeds_gen_mask": gen_mask,
            "ids_cmp_mask": streams["ids_cmp_mask"], "ids_gen_mask": streams["ids_gen_mask"]}


def _agent_trees(jagent):
    return {"llm": jagent.llm_params, "input_resampler": jagent.input_resampler_params,
            "output_resampler": jagent.output_resampler_params}


def _by_port_name(tree):
    return {f"{net}.{k}": v for net, sd in from_jax.agent_tree(tree).items()
            for k, v in sd.items()}


def test_agent_loss_and_gradients_match_jax():
    cfg = _agent_config()
    jagent, tagent = agents(cfg, seed=6)
    batch = _agent_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(jagent.loss, has_aux=True))(
        _agent_trees(jagent), jbatch)
    params = tstep3.agent_trainables(tagent)
    total, aux = tagent.loss({k: T(v) for k, v in batch.items()})
    total.backward()
    _close(total, jtotal, 5e-4, "total")
    for k in ("lm_loss", "rec_loss", "recon_image_embeds"):
        _close(aux[k], jaux[k], 5e-4, k)
    assert aux["rec_loss"].item() > 0 and aux["lm_loss"].item() > 0
    want = _by_port_name(jgrads)
    assert any(".lora_A." in k for k in params) and "llm.lm_head.weight" in params
    assert not any(".base." in k for k in params)
    for name, p in params.items():
        _close(p.grad, want[name], 5e-4, f"grad {name}")


# ---------------------------------------------------------------------------
# data/mllm_dataset.py
# ---------------------------------------------------------------------------
def test_token_stream_equals_jax():
    tspec, jspec = _spec(200, 6), _spec(200, 6, jdata)
    caption = tspec.encode_text("two characters argue in the rain at night")
    for length, newline in ((40, []), (60, [9, 9]), (24, [])):
        want = jdata.build_mllm_token_stream(caption, jspec, newline, length)
        got = tdata.build_mllm_token_stream(caption, tspec, newline, length)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert tdata.build_mllm_token_stream(caption, tspec, [], 10) is None
    assert jdata.build_mllm_token_stream(caption, jspec, [], 10) is None
    assert tdata.relative_bbox_to_loc_tokens([0.1, 0.5, 0.999, 1.2]) == \
        jdata.relative_bbox_to_loc_tokens([0.1, 0.5, 0.999, 1.2])


def test_mllm_dataset_batches_are_the_jax_bytes():
    anns = mangazero_pages(np.random.default_rng(7))
    tok = lambda text: (np.arange(77) * 7 + len(text)) % 250
    kw = dict(max_num_ips=3, max_num_ip_sources=2, max_num_dialogs=2, batch_size=4,
              i_drop_rate=0.2, t_drop_rate=0.3)
    jds = jdata.MangaTrainMLLMDataset("", "", tok, config=JBucketConfig(**kw), annotations=anns,
                                      mllm_spec=_spec(300, 12, jdata), max_token_length=48)
    tds = tdata.MangaTrainMLLMDataset("", "", tok, config=TBucketConfig(**kw), annotations=anns,
                                      mllm_spec=_spec(300, 12), max_token_length=48)
    want = list(jds.batches(shuffle=True, seed=5, num_workers=2))
    got = list(tds.batches(shuffle=True, seed=5, num_workers=2))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and "target_ip_pixel_values" in g
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


# ---------------------------------------------------------------------------
# train/mllm_step.py and the CLI
# ---------------------------------------------------------------------------
def _stage3_batch(manga, cfg, b=2, hw=32):
    rng = np.random.default_rng(8)
    i = manga.max_num_ips
    batch = {
        "pixel_values": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        "text_input_ids": rng.integers(1, 250, (b, 77)).astype(np.int32),
        "text_input_ids_2": rng.integers(1, 250, (b, 77)).astype(np.int32),
        "ip_pixel_values": rng.uniform(0, 1, (b, i, 1, 224, 224, 3)).astype(np.float32),
        "magi_pixel_values": rng.uniform(0, 1, (b, i, 1, 224, 224, 3)).astype(np.float32),
        "ip_exists": np.array([[[1.0], [1.0]], [[1.0], [0.0]]], np.float32)[:b, :i],
        "ip_bbox": rng.uniform(0, 1, (b, i, 4)).astype(np.float32),
        "dialog_bbox": rng.uniform(0, 1, (b, manga.max_num_dialogs, 4)).astype(np.float32),
        "original_size": np.full((b, 2), float(hw), np.float32),
        "crop_coords_top_left": np.zeros((b, 2), np.float32),
        "target_size": np.full((b, 2), float(hw), np.float32),
        "target_ip_pixel_values": rng.uniform(0, 1, (b, i, 224, 224, 3)).astype(np.float32),
        "target_magi_pixel_values": rng.uniform(0, 1, (b, i, 224, 224, 3)).astype(np.float32),
        "sample_mask": np.array([1.0, 1.0], np.float32)[:b],
    }
    streams = _streams(cfg, b)
    batch.update({k: streams[k] for k in ("mllm_input_ids", "mllm_labels", "ids_cmp_mask",
                                          "ids_gen_mask", "embeds_cmp_mask", "embeds_gen_mask")})
    return batch


def test_stage3_step_matches_jax():
    """One JAX stage-3 step and one port step on the same weights, batch and
    draws: the loss and its parts, every trainable's gradient, the
    trainables after one AdamW update; the frozen LLaMA base, UNet and
    Resampler bit-equal."""
    jpipe, tpipe = tiny_pipelines()
    jm, tm = jpipe.m, tpipe.m
    manga = tm.manga
    cfg = _agent_config(iv=manga.num_ip_tokens, kv=tm.unet.config.cross_attention_dim)
    jagent, tagent = agents(cfg, seed=9)
    batch = _stage3_batch(manga, cfg)
    rng = jax.random.key(2)

    # JAX: the frozen stack with the UNet and Resampler trees, the optimizer
    # masked to the agent's trainables
    jfrozen = jdiff.FrozenDiffusionStack(
        vae=jm.vae, vae_params=jm.vae_params, text_encoder=jm.text_encoder,
        text_encoder_params=jm.text_encoder_params, text_encoder_2=jm.text_encoder_2,
        text_encoder_2_params=jm.text_encoder_2_params, image_encoder=jm.image_encoder,
        image_encoder_params=jm.image_encoder_params, magi_encoder=jm.magi_encoder,
        magi_encoder_params=jm.magi_encoder_params, unet_params=jm.unet_params,
        resampler_params=jm.resampler_params, vae_scaling=jm.vae.config.scaling_factor)
    jstep = jstep3.make_stage3_step(jm.unet, jm.resampler, jagent, JDDPM(),
                                    jstep3.Stage3Config(manga=manga))
    jparams = _agent_trees(jagent)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jfrozen, jbatch, rng), has_aux=True))(jparams)
    mask = {"llm": jpeft.lora_trainable_mask(jparams["llm"]),
            "input_resampler": jax.tree.map(lambda _: True, jparams["input_resampler"]),
            "output_resampler": jax.tree.map(lambda _: True, jparams["output_resampler"])}
    tx = joptim.make_optimizer(1e-4, weight_decay=0.05, max_grad_norm=1.0, trainable_mask=mask)
    jnew = jdiff.TrainState.create(jparams, tx).apply_gradients(jgrads).params

    # the JAX draws: latent-sample noise, diffusion noise, timesteps
    mean, _ = jm.vae.apply(jm.vae_params, jnp.asarray(batch["pixel_values"]),
                           method=jm.vae.encode)
    rng_n, rng_t = jax.random.split(jax.random.fold_in(rng, 1))
    draws = dict(latent_noise=T(jax.random.normal(jax.random.fold_in(rng, 0), mean.shape)),
                 noise=T(jax.random.normal(rng_n, mean.shape)),
                 timesteps=T(jax.random.randint(rng_t, (mean.shape[0],), 0, 1000)))

    tfrozen = tdiff.FrozenDiffusionStack(
        vae=tm.vae, text_encoder=tm.text_encoder, text_encoder_2=tm.text_encoder_2,
        image_encoder=tm.image_encoder, magi_encoder=tm.magi_encoder,
        vae_scaling=jm.vae.config.scaling_factor)
    tm.vae.load_state_dict(from_jax.to_tensors(from_jax.vae(jm.vae_params, jm.vae.config)))
    params = tstep3.agent_trainables(tagent)
    frozen_before = {f"{n}.{k}": p.detach().clone()
                     for n, mod in (("llm", tagent.llm), ("unet", tm.unet),
                                    ("resampler", tm.resampler))
                     for k, p in mod.named_parameters() if not p.requires_grad}
    step = tstep3.make_stage3_step(tm.unet, tm.resampler, tagent, DDPMSchedule(),
                                   tstep3.Stage3Config(manga=manga))
    loss, metrics = step.loss_fn(tfrozen, {k: T(v) for k, v in batch.items()}, **draws)
    loss.backward()
    _close(loss, jloss, 5e-4, "loss")
    for k in ("loss_diffusion", "loss_lm", "loss_rec", "loss_mllm"):
        _close(metrics[k], jmetrics[k], 5e-4, k)
    want_grads, want_new = _by_port_name(jgrads), _by_port_name(jnew)
    for name, p in params.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(grad, want_grads[name], 5e-4, f"grad {name}")
    opt = toptim.make_optimizer(params.values(), 1e-4, weight_decay=0.05, max_grad_norm=1.0)
    assert opt.step()
    for name, p in params.items():
        _close(p, want_new[name], 5e-4, f"updated {name}")
    live = {f"{n}.{k}": p for n, mod in (("llm", tagent.llm), ("unet", tm.unet),
                                         ("resampler", tm.resampler))
            for k, p in mod.named_parameters()}
    for name, before in frozen_before.items():
        assert torch.equal(live[name], before), f"frozen {name} moved"
    assert any(k.startswith("llm.layers.0.attn.q_proj.base") for k in frozen_before)


def _write_run(tmp_path, **trainer):
    root = tmp_path / "data"
    root.mkdir()
    anns = mangazero_pages(np.random.default_rng(10), n_pages=2)
    for ann in anns:
        ann.pop("image").save(root / ann["image_path"])
    (root / "annotations.json").write_text(json.dumps(anns))
    trainer = {"max_train_steps": 2, "log_every": 1, "checkpoint_every": 2, "seed": 0,
               **trainer}
    lines = "\n".join(f"  {k}: {v}" for k, v in trainer.items())
    cfg = root / "config.yaml"
    cfg.write_text(f"""
stage: mllm
model:
  preset: tiny
  mllm_loss_weight: 1.0
  remat: true
  agent:
    lora_rank: 4
    remat: true
train_data:
  ann_path: {root}/annotations.json
  image_root: {root}
  batch_size: 2
  max_num_ip_sources: 1
  max_token_length: 48
  num_workers: 2
optimizer: {{lr: 1.0e-3, weight_decay: 0.05, max_grad_norm: 1.0}}
lr_scheduler: {{name: cosine_with_min_lr, num_warmup_steps: 1, min_lr_ratio: 0.05}}
trainer:
{lines}
""")
    return os.fspath(cfg)


def test_cli_trains_stage3_checkpoints_and_resumes_exactly(tmp_path):
    cfg = _write_run(tmp_path)
    run = lambda *a: cli.main(["--config", cfg, "--device", "cpu", *a])
    full = run("--log_dir", os.fspath(tmp_path / "full"), "--max_train_steps", "3")
    records = [json.loads(line) for line in
               (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    for r in records:
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_diffusion", "loss_lm", "loss_rec"))
    assert os.path.isdir(tmp_path / "full" / "step-2") and os.path.isdir(tmp_path / "full" / "step-3")
    groups = {k.split(".")[0] for k in full.params}
    assert groups == {"llm", "input_resampler", "output_resampler"}
    assert not any(".base." in k for k in full.params)

    run("--log_dir", os.fspath(tmp_path / "cut"), "--max_train_steps", "1")
    resumed = run("--log_dir", os.fspath(tmp_path / "cut"), "--max_train_steps", "3", "--resume")
    assert resumed.step == full.step == 3
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k
