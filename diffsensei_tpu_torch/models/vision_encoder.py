"""Character-image encoders: CLIP ViT-H/14 and Magi ViTMAE (port of
``diffsensei_tpu/models/vision_encoder.py``).

One pre-LN ViT serves both. It returns the penultimate hidden state (the CLIP
feature the Resampler reads) and the post-LayerNorm CLS token (the Magi
feature). The parameters sit under the HF names of the encoder the config
describes: ``CLIPVisionModel`` names when the config has the embedding
LayerNorm (``use_pre_layernorm``), ``ViTMAEModel`` names otherwise. The
layers keep direct references to their submodules, so the forward does not
depend on the naming.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffsensei_tpu_torch.core.config import VisionEncoderConfig
from diffsensei_tpu_torch.ops.attention import multi_head_attention

_CLIP_LAYER = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
               "v": "self_attn.v_proj", "o": "self_attn.out_proj",
               "fc1": "mlp.fc1", "fc2": "mlp.fc2",
               "ln1": "layer_norm1", "ln2": "layer_norm2"}
_MAE_LAYER = {"q": "attention.attention.query", "k": "attention.attention.key",
              "v": "attention.attention.value", "o": "attention.output.dense",
              "fc1": "intermediate.dense", "fc2": "output.dense",
              "ln1": "layernorm_before", "ln2": "layernorm_after"}


def _attach(root: nn.Module, path: str, module: nn.Module) -> nn.Module:
    """Register ``module`` under dotted ``path``, creating empty container
    modules on the way; returns it."""
    *parents, leaf = path.split(".")
    node = root
    for name in parents:
        if not hasattr(node, name):
            node.add_module(name, nn.Module())
        node = getattr(node, name)
    node.add_module(leaf, module)
    return module


class ViTLayer(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig, names: Dict[str, str], dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dim = cfg.hidden_size
        self.heads = cfg.num_heads
        shapes = {"q": (dim, dim), "k": (dim, dim), "v": (dim, dim),
                  "o": (dim, dim), "fc1": (dim, cfg.intermediate_size),
                  "fc2": (cfg.intermediate_size, dim)}
        self.m = {key: _attach(self, names[key], nn.Linear(*shape, **kw))
                  for key, shape in shapes.items()}
        for key in ("ln1", "ln2"):
            self.m[key] = _attach(self, names[key],
                                  nn.LayerNorm(dim, eps=cfg.norm_eps, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        b, s, d = x.shape
        h = m["ln1"](x)
        split = lambda t: t.view(b, s, self.heads, -1).transpose(1, 2)
        o = multi_head_attention(split(m["q"](h)), split(m["k"](h)), split(m["v"](h)))
        x = x + m["o"](o.transpose(1, 2).reshape(b, s, d))
        h = F.gelu(m["fc1"](m["ln2"](x)))  # HF ViT/CLIP gelu: exact erf
        return x + m["fc2"](h)


class VisionTransformer(nn.Module):
    """``forward(pixels [B, H, W, 3]) -> (penultimate [B, S, D], final_cls [B, D])``.

    Without a CLS token (``use_class_embedding=False``) the sequence is the
    patches alone and ``final_cls`` is the first patch's post-LN feature, as
    in the JAX module."""

    def __init__(self, config: VisionEncoderConfig, dtype=torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=dtype, device=device)
        d = cfg.hidden_size
        patch = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size,
                          bias=cfg.patch_bias, **kw)
        post_ln = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        # submodules by role (a plain dict: these are not registered twice)
        if cfg.use_pre_layernorm:          # HF CLIPVisionModel names
            emb = _attach(self, "vision_model.embeddings", nn.Module())
            emb.patch_embedding = patch
            if cfg.use_class_embedding:
                emb.class_embedding = nn.Parameter(torch.zeros(d, **kw))
            emb.position_embedding = nn.Embedding(cfg.seq_len, d, **kw)
            pre_ln = _attach(self, "vision_model.pre_layrnorm",
                             nn.LayerNorm(d, eps=cfg.norm_eps, **kw))
            layers = _attach(self, "vision_model.encoder.layers", nn.ModuleList(
                [ViTLayer(cfg, _CLIP_LAYER, **kw) for _ in range(cfg.num_layers)]))
            _attach(self, "vision_model.post_layernorm", post_ln)
        else:                              # HF ViTMAEModel names
            emb = _attach(self, "embeddings", nn.Module())
            _attach(emb, "patch_embeddings.projection", patch)
            if cfg.use_class_embedding:
                emb.cls_token = nn.Parameter(torch.zeros(1, 1, d, **kw))
            emb.position_embeddings = nn.Parameter(torch.zeros(1, cfg.seq_len, d, **kw))
            pre_ln = None
            layers = _attach(self, "encoder.layer", nn.ModuleList(
                [ViTLayer(cfg, _MAE_LAYER, **kw) for _ in range(cfg.num_layers)]))
            _attach(self, "layernorm", post_ln)
        self.m = dict(emb=emb, patch=patch, pre_ln=pre_ln, layers=layers,
                      post_ln=post_ln)

    @property
    def dtype(self) -> torch.dtype:
        return self.m["patch"].weight.dtype

    def _cls_and_pos(self) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        # looked up per call: moving the module may replace the Parameters;
        # no CLS token where the config has none
        emb = self.m["emb"]
        if self.config.use_pre_layernorm:
            return getattr(emb, "class_embedding", None), emb.position_embedding.weight
        return getattr(emb, "cls_token", None), emb.position_embeddings

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.m
        d = self.config.hidden_size
        x = m["patch"](pixel_values.to(self.dtype).permute(0, 3, 1, 2))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                    # [B, P, D]
        cls, pos = self._cls_and_pos()
        if cls is not None:
            x = torch.cat([cls.reshape(1, 1, d).expand(b, 1, d), x], dim=1)
        x = x + pos.reshape(1, -1, d)
        if m["pre_ln"] is not None:
            x = m["pre_ln"](x)
        penultimate = x
        for layer in m["layers"]:
            penultimate = x
            x = layer(x)
        return penultimate, m["post_ln"](x)[:, 0]
