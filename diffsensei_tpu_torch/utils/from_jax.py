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

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype=dtype, device=device)
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


def _transformer(sd: StateDict, base: str, node: Dict, num_layers: int) -> None:
    _norm(sd, base + "norm", node["norm"])
    _lin(sd, base + "proj_in", node["proj_in"])
    _lin(sd, base + "proj_out", node["proj_out"])
    for k in range(num_layers):
        blk = node[f"blocks_{k}"]
        tb = f"{base}transformer_blocks.{k}."
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, tb + n, blk[n])
        for attn in ("attn1", "attn2"):
            a = blk[attn]
            for n in ("to_q", "to_k", "to_v"):
                _lin(sd, f"{tb}{attn}.{n}", a[n])
            _lin(sd, f"{tb}{attn}.to_out.0", a["to_out"])
        # the released checkpoints keep the IP projections in the processor
        _lin(sd, f"{tb}attn2.processor.to_k_ip", blk["attn2"]["to_k_ip"])
        _lin(sd, f"{tb}attn2.processor.to_v_ip", blk["attn2"]["to_v_ip"])
        _lin(sd, tb + "ff.net.0.proj", blk["ff"]["proj_in"])
        _lin(sd, tb + "ff.net.2", blk["ff"]["proj_out"])


def sdxl_unet(params: Dict, cfg) -> StateDict:
    """``UNetMangaModel`` tree (rank 0, not quantized) -> diffusers
    ``UNet2DConditionModel`` names plus ``dialog_bbox_embedding``."""
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
