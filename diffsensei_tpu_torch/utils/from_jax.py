"""Weight bridge: JAX parameter trees -> the port's state dicts (numpy only).

Each function takes a flax parameter tree (``{"params": {...}}`` of numpy or
JAX arrays, as ``diffsensei_tpu`` builds or ports them) and returns a flat
``{name: np.ndarray}`` under the port's names, which are the reference's:
diffusers names for the UNet and the VAE, the reference ``Resampler`` names,
HF CLIP and ViTMAE names for the encoders. It is the inverse of
``diffsensei_tpu/utils/port_torch.py``, so the released torch checkpoints
load into the port as they are. Dense kernels are transposed (in, out ->
out, in) and conv kernels reordered (HWIO -> OIHW).

Load a result with ``module.load_state_dict(to_tensors(sd))``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lin(sd: StateDict, name: str, node: Dict) -> None:
    sd[f"{name}.weight"] = _a(node["kernel"]).T
    if "bias" in node:
        sd[f"{name}.bias"] = _a(node["bias"])


def _conv(sd: StateDict, name: str, node: Dict) -> None:
    sd[f"{name}.weight"] = _a(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:
        sd[f"{name}.bias"] = _a(node["bias"])


def _norm(sd: StateDict, name: str, node: Dict) -> None:
    sd[f"{name}.weight"] = _a(node["scale"])
    sd[f"{name}.bias"] = _a(node["bias"])


def to_tensors(sd: StateDict, dtype=None, device=None):
    """numpy state dict -> contiguous torch tensors (imports torch lazily so
    the bridge itself stays numpy only)."""
    import torch

    return {k: torch.from_numpy(np.array(v, order="C")).to(dtype=dtype, device=device)
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------
_LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
_CLIP_NAMES = dict(q_proj="self_attn.q_proj", k_proj="self_attn.k_proj",
                   v_proj="self_attn.v_proj", out_proj="self_attn.out_proj",
                   fc1="mlp.fc1", fc2="mlp.fc2", layer_norm1="layer_norm1",
                   layer_norm2="layer_norm2")
_MAE_NAMES = dict(q_proj="attention.attention.query",
                  k_proj="attention.attention.key",
                  v_proj="attention.attention.value",
                  out_proj="attention.output.dense", fc1="intermediate.dense",
                  fc2="output.dense", layer_norm1="layernorm_before",
                  layer_norm2="layernorm_after")


def _layers(sd: StateDict, p: Dict, num_layers: int, base: str, names: Dict) -> None:
    for i in range(num_layers):
        lp = p[f"layers_{i}"]
        for ours in _LAYER_LINEARS:
            _lin(sd, f"{base}{i}.{names[ours]}", lp[ours])
        for ours in ("layer_norm1", "layer_norm2"):
            _norm(sd, f"{base}{i}.{names[ours]}", lp[ours])


def clip_text(params: Dict, num_layers: int, prefix: str = "text_model.") -> StateDict:
    """``CLIPTextEncoder`` tree -> HF ``CLIPTextModel(WithProjection)`` names."""
    p = params["params"]
    sd: StateDict = {
        f"{prefix}embeddings.token_embedding.weight": _a(p["token_embedding"]["embedding"]),
        f"{prefix}embeddings.position_embedding.weight": _a(p["position_embedding"]),
    }
    _layers(sd, p, num_layers, f"{prefix}encoder.layers.", _CLIP_NAMES)
    _norm(sd, f"{prefix}final_layer_norm", p["final_layer_norm"])
    if "text_projection" in p:
        _lin(sd, "text_projection", p["text_projection"])
    return sd


def vision_encoder(params: Dict, config) -> StateDict:
    """``VisionTransformer`` tree -> HF ``CLIPVisionModel`` names when the
    config has the embedding LayerNorm, HF ``ViTMAEModel`` names otherwise."""
    p = params["params"]
    sd: StateDict = {}
    if config.use_pre_layernorm:
        pre = "vision_model."
        _conv(sd, f"{pre}embeddings.patch_embedding", p["patch_embedding"])
        sd[f"{pre}embeddings.class_embedding"] = _a(p["class_embedding"])
        sd[f"{pre}embeddings.position_embedding.weight"] = _a(p["position_embedding"])
        _norm(sd, f"{pre}pre_layrnorm", p["pre_layernorm"])  # HF's spelling
        _layers(sd, p, config.num_layers, f"{pre}encoder.layers.", _CLIP_NAMES)
        _norm(sd, f"{pre}post_layernorm", p["post_layernorm"])
    else:
        _conv(sd, "embeddings.patch_embeddings.projection", p["patch_embedding"])
        sd["embeddings.cls_token"] = _a(p["class_embedding"]).reshape(1, 1, -1)
        sd["embeddings.position_embeddings"] = _a(p["position_embedding"])[None]
        _layers(sd, p, config.num_layers, "encoder.layer.", _MAE_NAMES)
        _norm(sd, "layernorm", p["post_layernorm"])
    return sd


def resampler(params: Dict, depth: int) -> StateDict:
    """``Resampler`` tree -> the reference ``Resampler`` names."""
    p = params["params"]
    sd: StateDict = {"latents": _a(p["latents"])[None],
                     "dummy_tokens": _a(p["dummy_tokens"])}
    _lin(sd, "proj_in", p["proj_in"])
    _lin(sd, "proj_in_magi", p["proj_in_magi"])
    _lin(sd, "proj_out", p["proj_out"])
    _norm(sd, "norm_out", p["norm_out"])
    for i in range(depth):
        a, f = f"layers.{i}.0.", f"layers.{i}.1."
        attn, ff = p[f"layers_{i}_attn"], p[f"layers_{i}_ff"]
        _norm(sd, a + "norm1", attn["norm1"])
        _norm(sd, a + "norm2", attn["norm2"])
        for name in ("to_q", "to_kv", "to_out"):
            _lin(sd, a + name, attn[name])
        _norm(sd, f + "0", ff["norm"])
        _lin(sd, f + "1", ff["fc1"])
        _lin(sd, f + "3", ff["fc2"])
    return sd


def image_proj(params: Dict) -> StateDict:
    """``ImageProjModel`` / ``ImageProjDummyModel`` tree -> the reference
    names (``proj``, ``norm``, and where present ``proj_magi`` and
    ``dummy_tokens``)."""
    p = params["params"]
    sd: StateDict = {}
    _lin(sd, "proj", p["proj"])
    _norm(sd, "norm", p["norm"])
    if "proj_magi" in p:
        _lin(sd, "proj_magi", p["proj_magi"])
    if "dummy_tokens" in p:
        sd["dummy_tokens"] = _a(p["dummy_tokens"])
    return sd


# ---------------------------------------------------------------------------
# UNet and VAE (diffusers names)
# ---------------------------------------------------------------------------
def _resnet(sd: StateDict, base: str, node: Dict) -> None:
    _norm(sd, base + "norm1", node["norm1"])
    _conv(sd, base + "conv1", node["conv1"])
    _norm(sd, base + "norm2", node["norm2"])
    _conv(sd, base + "conv2", node["conv2"])
    if "time_emb_proj" in node:
        _lin(sd, base + "time_emb_proj", node["time_emb_proj"])
    if "conv_shortcut" in node:
        _conv(sd, base + "conv_shortcut", node["conv_shortcut"])


def _unet_dense(sd: StateDict, name: str, node: Dict) -> None:
    """A UNet ``LoRADense`` (or ``nn.Dense``): the base as ``_projection``
    moves it (an int8 ``kernel_q`` stays int8), the bias, and the adapters
    ``lora_a`` ``[in, r]`` / ``lora_b`` ``[r, out]`` as ``lora_A.weight`` /
    ``lora_B.weight``."""
    _projection(sd, name, node)
    if "bias" in node:
        sd[f"{name}.bias"] = _a(node["bias"])
    if "lora_a" in node:
        sd[f"{name}.lora_A.weight"] = _a(node["lora_a"]).T
        sd[f"{name}.lora_B.weight"] = _a(node["lora_b"]).T


def _transformer(sd: StateDict, base: str, node: Dict, num_layers: int) -> None:
    _norm(sd, base + "norm", node["norm"])
    _unet_dense(sd, base + "proj_in", node["proj_in"])
    _unet_dense(sd, base + "proj_out", node["proj_out"])
    for k in range(num_layers):
        blk = node[f"blocks_{k}"]
        tb = f"{base}transformer_blocks.{k}."
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, tb + n, blk[n])
        for attn in ("attn1", "attn2"):
            a = blk[attn]
            for n in ("to_q", "to_k", "to_v"):
                _unet_dense(sd, f"{tb}{attn}.{n}", a[n])
            _unet_dense(sd, f"{tb}{attn}.to_out.0", a["to_out"])
        # the released checkpoints keep the IP projections in the processor
        _unet_dense(sd, f"{tb}attn2.processor.to_k_ip", blk["attn2"]["to_k_ip"])
        _unet_dense(sd, f"{tb}attn2.processor.to_v_ip", blk["attn2"]["to_v_ip"])
        _unet_dense(sd, tb + "ff.net.0.proj", blk["ff"]["proj_in"])
        _unet_dense(sd, tb + "ff.net.2", blk["ff"]["proj_out"])


def sdxl_unet(params: Dict, cfg) -> StateDict:
    """``UNetMangaModel`` tree -> diffusers ``UNet2DConditionModel`` names
    plus ``dialog_bbox_embedding``. A tree with LoRA leaves gives the
    adapters of a ``lora_rank`` UNet; a ``quantize_unet_params`` tree gives
    the ``quantized=True`` UNet's int8 ``kernel_q`` (load it without a
    dtype cast) and fp32 ``kernel_scale``."""
    p = params["params"]
    sd: StateDict = {}
    tl = cfg.transformer_layers_per_block
    n = len(cfg.block_out_channels)
    _conv(sd, "conv_in", p["conv_in"])
    for emb in ("time_embedding", "add_embedding"):
        _lin(sd, f"{emb}.linear_1", p[emb]["linear_1"])
        _lin(sd, f"{emb}.linear_2", p[emb]["linear_2"])
    for level in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"down_blocks.{level}.resnets.{j}.", p[f"down_{level}_resnet_{j}"])
            if tl[level] > 0:
                _transformer(sd, f"down_blocks.{level}.attentions.{j}.",
                             p[f"down_{level}_attn_{j}"], tl[level])
        if level < n - 1:
            _conv(sd, f"down_blocks.{level}.downsamplers.0.conv",
                  p[f"down_{level}_downsample"]["conv"])
    _resnet(sd, "mid_block.resnets.0.", p["mid_resnet_0"])
    _resnet(sd, "mid_block.resnets.1.", p["mid_resnet_1"])
    _transformer(sd, "mid_block.attentions.0.", p["mid_attn"], cfg.mid_transformer_layers)
    for rev, level in enumerate(reversed(range(n))):
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{rev}.resnets.{j}.", p[f"up_{rev}_resnet_{j}"])
            if tl[level] > 0:
                _transformer(sd, f"up_blocks.{rev}.attentions.{j}.",
                             p[f"up_{rev}_attn_{j}"], tl[level])
        if level > 0:
            _conv(sd, f"up_blocks.{rev}.upsamplers.0.conv", p[f"up_{rev}_upsample"]["conv"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    if "dialog_bbox_embedding" in p:
        sd["dialog_bbox_embedding"] = _a(p["dialog_bbox_embedding"])
    return sd


def _vae_attn(sd: StateDict, base: str, node: Dict) -> None:
    _norm(sd, base + "group_norm", node["group_norm"])
    for n in ("to_q", "to_k", "to_v"):
        _lin(sd, base + n, node[n])
    _lin(sd, base + "to_out.0", node["to_out"])


def vae(params: Dict, cfg) -> StateDict:
    """``AutoencoderKL`` tree -> diffusers ``AutoencoderKL`` names (encoder
    and decoder)."""
    p = params["params"]
    enc, dec = p["encoder"], p["decoder"]
    sd: StateDict = {}
    n = len(cfg.block_out_channels)
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for level in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{level}.resnets.{j}.",
                    enc[f"down_{level}_resnet_{j}"])
        if level < n - 1:
            _conv(sd, f"encoder.down_blocks.{level}.downsamplers.0.conv",
                  enc[f"down_{level}_downsample"]["conv"])
    for half, node in (("encoder", enc), ("decoder", dec)):
        _resnet(sd, f"{half}.mid_block.resnets.0.", node["mid_resnet_0"])
        _resnet(sd, f"{half}.mid_block.resnets.1.", node["mid_resnet_1"])
        _vae_attn(sd, f"{half}.mid_block.attentions.0.", node["mid_attn"])
        _norm(sd, f"{half}.conv_norm_out", node["conv_norm_out"])
        _conv(sd, f"{half}.conv_out", node["conv_out"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    for rev in range(n):
        for j in range(cfg.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{rev}.resnets.{j}.", dec[f"up_{rev}_resnet_{j}"])
        if rev < n - 1:
            _conv(sd, f"decoder.up_blocks.{rev}.upsamplers.0.conv",
                  dec[f"up_{rev}_upsample"]["conv"])
    _conv(sd, "quant_conv", p["quant_conv"])
    _conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


# ---------------------------------------------------------------------------
# the SEED-X agent (names of the port's modules, which follow the JAX tree)
# ---------------------------------------------------------------------------
def _projection(sd: StateDict, name: str, node: Dict) -> None:
    """A ``kernel`` dense -> ``weight`` [out, in]; a quantized one's
    ``kernel_q`` / ``kernel_scale`` pass through as they are (int8
    ``[in, out]``, or packed uint8 ``[in, F'/2]`` with fp32 ``[in/g, F']``)."""
    if "kernel" in node:
        sd[f"{name}.weight"] = _a(node["kernel"]).T
    else:
        sd[f"{name}.kernel_q"] = np.asarray(node["kernel_q"])
        sd[f"{name}.kernel_scale"] = _a(node["kernel_scale"])


def llama(params: Dict) -> StateDict:
    """``LlamaForCausalLM`` tree (float, LoRA, int8 or int4) -> the port's
    ``models.mllm.llama.LlamaForCausalLM`` names. Float leaves become fp32;
    cast with ``to_tensors(..., dtype)`` only a float tree."""
    p = params["params"]
    sd: StateDict = {"embed_tokens.weight": _a(p["embed_tokens"]["embedding"]),
                     "norm.weight": _a(p["norm"]["weight"])}
    i = 0
    while f"layers_{i}" in p:
        lp = p[f"layers_{i}"]
        for block, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for n in names:
                node, base = lp[block][n], f"layers.{i}.{block}.{n}"
                _projection(sd, f"{base}.base", node["base"])
                if "lora_a" in node:
                    sd[f"{base}.lora_A.weight"] = _a(node["lora_a"]).T
                    sd[f"{base}.lora_B.weight"] = _a(node["lora_b"]).T
        for n in ("input_norm", "post_norm"):
            sd[f"layers.{i}.{n}.weight"] = _a(lp[n]["weight"])
        i += 1
    _projection(sd, "lm_head", p["lm_head"])
    return sd


def llama_shard(params: Dict, config, rank: int, size: int) -> StateDict:
    """A JAX ``LlamaForCausalLM`` tree (any layout ``llama`` takes) -> rank
    ``rank``'s shards over ``size`` model ranks under the port's names
    (``llama``, then ``parallel.tensor.shard_llama_state``), for the
    ``LlamaForCausalLM(..., tp_group=g)`` of that rank."""
    import torch

    from diffsensei_tpu_torch.parallel.tensor import shard_llama_state

    whole = {k: torch.from_numpy(np.array(v, order="C")) for k, v in llama(params).items()}
    return {k: v.numpy() for k, v in shard_llama_state(whole, config, rank, size).items()}


def qwen_resampler(params: Dict) -> StateDict:
    """``QwenResampler`` tree -> the reference ``QwenResampler`` names (the
    ``nn.MultiheadAttention`` in-projection packed as ``[3E, E]``)."""
    p = params["params"]
    sd: StateDict = {"query": _a(p["query"])}
    if "kv_proj" in p:
        _lin(sd, "kv_proj", p["kv_proj"])
    _norm(sd, "ln_q", p["ln_q"])
    _norm(sd, "ln_kv", p["ln_kv"])
    names = ("q_in_proj", "k_in_proj", "v_in_proj")
    sd["attn.in_proj_weight"] = np.concatenate([_a(p[n]["kernel"]).T for n in names])
    sd["attn.in_proj_bias"] = np.concatenate([_a(p[n]["bias"]) for n in names])
    _lin(sd, "attn.out_proj", p["out_proj"])
    return sd


def qwen_visual(params: Dict, num_heads: int) -> StateDict:
    """``QwenVisionTransformer`` / ``VisionTransformerWithAttnPool`` tree ->
    the reference Qwen-VL names (the inverse of the JAX
    ``port_qwen_visual``): q/k/v packed into ``attn.in_proj`` with the rows
    interleaved by head, ``proj`` kept ``[in, out]``."""
    p = params["params"]
    sd: StateDict = {"conv1.weight": _a(p["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1),
                     "positional_embedding": _a(p["position_embedding"])}
    _norm(sd, "ln_pre", p["ln_pre"])
    i = 0
    while f"layers_{i}" in p:
        lp, base = p[f"layers_{i}"], f"transformer.resblocks.{i}."
        qkv = [lp[n] for n in ("q_proj", "k_proj", "v_proj")]
        e = _a(qkv[0]["kernel"]).shape[0]
        hn = e // num_heads
        sd[base + "attn.in_proj.weight"] = np.stack(
            [_a(n["kernel"]).T.reshape(num_heads, hn, e) for n in qkv], axis=1).reshape(3 * e, e)
        sd[base + "attn.in_proj.bias"] = np.stack(
            [_a(n["bias"]).reshape(num_heads, hn) for n in qkv], axis=1).reshape(3 * e)
        _lin(sd, base + "attn.out_proj", lp["out_proj"])
        _norm(sd, base + "ln_1", lp["layer_norm1"])
        _norm(sd, base + "ln_2", lp["layer_norm2"])
        _lin(sd, base + "mlp.c_fc", lp["fc1"])
        _lin(sd, base + "mlp.c_proj", lp["fc2"])
        i += 1
    if "attn_pool" in p:
        sd.update({f"attn_pool.{k}": v
                   for k, v in qwen_resampler({"params": p["attn_pool"]}).items()})
        _norm(sd, "ln_post", p["ln_post"])
        sd["proj"] = _a(p["proj"]["kernel"])
    return sd


def agent_tree(params: Dict) -> Dict[str, StateDict]:
    """A stage-3 trainable tree ``{"llm", "input_resampler",
    "output_resampler"}`` (the JAX ``make_stage3_step``'s params: LoRA
    adapters and fp32 leaves included) -> the port's state dicts of the same
    names."""
    return {"llm": llama(params["llm"]),
            "input_resampler": qwen_resampler(params["input_resampler"]),
            "output_resampler": qwen_resampler(params["output_resampler"])}


def agent(jagent) -> Dict[str, StateDict]:
    """A JAX ``ContinuousLVLM`` -> ``{"llm", "input_resampler",
    "output_resampler"}`` state dicts for the port's ``ContinuousLVLM``."""
    return agent_tree({"llm": jagent.llm_params,
                       "input_resampler": jagent.input_resampler_params,
                       "output_resampler": jagent.output_resampler_params})
