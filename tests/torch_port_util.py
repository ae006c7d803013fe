"""Helpers shared by the ``test_torch_port_*`` files."""

import jax
import numpy as np


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


def tiny_pipelines():
    """(JAX pipeline, port pipeline on the CPU) of the tiny configs, with the
    same random weights: JAX trees carried across by ``from_jax``."""
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

    tm = tpipeline.PipelineModules.tiny(device="cpu")
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
