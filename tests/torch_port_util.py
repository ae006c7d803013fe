"""Helpers shared by the ``test_torch_port_*`` files."""

import dataclasses

import jax
import numpy as np
from PIL import Image


def random_tree(module, *args, seed=0, **kwargs):
    """A parameter tree of the flax ``module`` with random numpy values,
    shaped by ``jax.eval_shape`` (no init computation): lecun-scaled kernels,
    norm scales near 1, small nonzero biases and embeddings."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "embedding":
            return z / np.float32(np.sqrt(shape[-1]))
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(fill, shapes)


def near_one_norms(tree):
    """A random JAX tree with its RMSNorm weights near 1 (``random_tree``
    gives 0.1 * z to every ``weight``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: 1.0 + x if path[-1].key == "weight" else x, tree)


def port_names(jax_tree, convert):
    """Names of a JAX tree's leaves in the port, through ``from_jax``: a tree
    of leaf indices (each filling its leaf's shape) converted and read back."""
    leaves, treedef = jax.tree.flatten(jax_tree)
    marked = jax.tree.unflatten(treedef, [np.full(np.shape(x), i, np.float32)
                                          for i, x in enumerate(leaves)])
    return {name: int(np.asarray(a).flat[0]) for name, a in convert(marked).items()}


def mangazero_pages(rng, n_pages=3):
    """A small MangaZero-format page set with PIL images inline: several
    buckets, a repeated character id in one frame, a type-1 character."""
    anns = []
    for p in range(n_pages):
        frames = []
        for f, (w, h) in enumerate([(400, 300), (300, 500), (520, 512)][: 1 + p]):
            x0 = 20 * f
            chars = [{"id": c % 3, "bbox": [x0 + 10 + 40 * c, 10, x0 + 60 + 40 * c, 120 + c],
                      "type": int(c == 2)} for c in range(4)]
            frames.append({"bbox": [x0, 0, x0 + w, h], "caption": f"panel {p} {f}",
                           "characters": chars,
                           "dialogs": [{"bbox": [x0 + 30, 20, x0 + 150, 90]},
                                       {"bbox": [x0 + 100, 200, x0 + 200, 260]}]})
        img = Image.fromarray(rng.integers(0, 255, (600, 700, 3), np.uint8))
        anns.append({"image_path": f"page_{p}.png", "image": img, "frames": frames})
    return anns


def agents(cfg, seed=0, quantized=False):
    """(JAX ``ContinuousLVLM``, the port's on the CPU) of the JAX
    ``AgentConfig`` ``cfg`` with the same random weights (LoRA of
    ``cfg.lora.rank`` unless ``quantized``, which packs the JAX agent in int4
    first)."""
    import jax.numpy as jnp

    from diffsensei_tpu.models.mllm import quant as jquant
    from diffsensei_tpu.models.mllm import seed_x as jseed
    from diffsensei_tpu_torch.core import config as tconfig
    from diffsensei_tpu_torch.models.mllm import seed_x as tseed
    from diffsensei_tpu_torch.utils import from_jax

    jagent = jseed.ContinuousLVLM.build(cfg, jax.random.key(0), abstract=True)
    ir, orr = cfg.input_resampler, cfg.output_resampler
    jagent = dataclasses.replace(
        jagent,
        llm_params=near_one_norms(random_tree(jagent.llm, input_ids=jnp.zeros((1, 8), jnp.int32),
                                              seed=seed)),
        input_resampler_params=random_tree(jagent.input_resampler,
                                           jnp.zeros((1, 4, ir.kv_dim)), seed=seed + 1),
        output_resampler_params=random_tree(jagent.output_resampler,
                                            jnp.zeros((1, 4, orr.kv_dim)), seed=seed + 2))
    if quantized:
        jagent = jquant.quantize_agent(jagent, bits=4)
    tcfg = tconfig.AgentConfig(
        llm=tconfig.LlamaConfig(**dataclasses.asdict(cfg.llm)),
        lora=tconfig.LoRAConfig(**dataclasses.asdict(cfg.lora)),
        input_resampler=tconfig.QwenResamplerConfig(**dataclasses.asdict(ir)),
        output_resampler=tconfig.QwenResamplerConfig(**dataclasses.asdict(orr)))
    tagent = tseed.ContinuousLVLM.build(tcfg, quantized="int4" if quantized else False,
                                        device="cpu")
    for name, sd in from_jax.agent(jagent).items():
        getattr(tagent, name).load_state_dict(from_jax.to_tensors(sd))
    return jagent, tagent


def tiny_pipelines(lora_rank=0, text_vocab=None, magi_vitmae=False):
    """(JAX pipeline, port pipeline on the CPU) of the tiny configs, with the
    same random weights: JAX trees carried across by ``from_jax``; UNet
    adapters of ``lora_rank`` (random, nonzero A and B) on both sides; text
    encoders of ``text_vocab`` tokens where given; a ViTMAE-layout Magi
    encoder (no embedding LayerNorm, as the full-size one) where
    ``magi_vitmae``."""
    import jax.numpy as jnp

    from diffsensei_tpu.models.resampler import Resampler as JResampler
    from diffsensei_tpu.models.text_encoder import CLIPTextEncoder as JText
    from diffsensei_tpu.models.unet import UNetMangaModel as JUNet
    from diffsensei_tpu.models.vae import AutoencoderKL as JVAE
    from diffsensei_tpu.models.vision_encoder import VisionTransformer as JViT
    from diffsensei_tpu.pipelines import pipeline as jpipeline
    from diffsensei_tpu_torch.pipelines import pipeline as tpipeline
    from diffsensei_tpu_torch.utils import from_jax

    cfgs = tpipeline.tiny_configs()
    manga = cfgs["unet"].manga
    ids = jnp.zeros((1, 77), jnp.int32)
    img = jnp.zeros((1, 224, 224, 3))
    ucfg = cfgs["unet"] = dataclasses.replace(cfgs["unet"], lora_rank=lora_rank)
    if magi_vitmae:
        cfgs["magi_encoder"] = dataclasses.replace(cfgs["magi_encoder"], use_pre_layernorm=False)
    if text_vocab is not None:
        for name in ("text_encoder", "text_encoder_2"):
            cfgs[name] = dataclasses.replace(cfgs[name], vocab_size=text_vocab)
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

    tm = tpipeline.PipelineModules.build(cfgs, device="cpu")
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


def llama_tokenizer_dir(root, size=400):
    """A SEED-X-layout LLaMA tokenizer directory of ``size`` pieces and the
    330 added tokens (``chip_smoke.write_llama_tokenizer``)."""
    import chip_smoke

    return chip_smoke.write_llama_tokenizer(root, chip_smoke.llama_pieces(size=size))


def spec_fields(spec, texts=("two girls talk", "a rainy street, one umbrella", "\n")):
    """An ``MLLMTokenSpec``'s ids, and its ``encode_text`` of ``texts``, for
    comparing two specs (their encoders are different functions)."""
    return dict(bos=spec.bos_id, eos=spec.eos_id, pad=spec.pad_id, boi=spec.boi_id,
                eoi=spec.eoi_id, img=[int(i) for i in spec.img_ids],
                text={t: list(spec.encode_text(t)) for t in texts})


def record_servers(monkeypatch):
    """Replace the port's ``DiffSenseiServer`` with one that records the
    keywords it is built with and generates no panel; returns the records."""
    from diffsensei_tpu_torch.serve import api

    built = []

    class Recorder:
        def __init__(self, pipeline, **kwargs):
            built.append(kwargs)

        def generate_pil(self, req):
            return []

    monkeypatch.setattr(api, "DiffSenseiServer", Recorder)
    return built
