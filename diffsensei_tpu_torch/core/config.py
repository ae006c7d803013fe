"""Copy of ``diffsensei_tpu/core/config.py``: the same dataclasses, kept equal
by ``tests/test_torch_port_ops.py`` (the JAX package's ``core`` imports jax).

Typed configuration for every DiffSensei-TPU component.

The reference drives everything through OmegaConf YAML (``configs/model/diffsensei.yaml``,
``configs/train/diffsensei/*.yaml``, loaded at ``scripts/train/train.py:67``). Here the
schema is dataclass-validated; YAML files with the same nesting load into these types.

Each model config carries both a production constructor (``sdxl()`` etc., matching the
released checkpoints' hyper-parameters) and a ``tiny()`` constructor used by the CPU
test-suite — the reference has no tests, so tiny configs are our substitute for
"run a real job to find out".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


def _freeze(seq):
    return tuple(seq)


# ---------------------------------------------------------------------------
# Manga conditioning hyper-parameters (configs/model/diffsensei.yaml:1-5)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MangaConfig:
    max_num_ips: int = 4          # characters per panel
    num_vision_tokens: int = 16   # IP tokens per character
    num_dummy_tokens: int = 16    # background ("dummy") tokens
    max_num_dialogs: int = 8      # dialog bboxes per panel

    @property
    def num_ip_tokens(self) -> int:
        return self.max_num_ips * self.num_vision_tokens

    @property
    def num_context_image_tokens(self) -> int:
        return self.num_dummy_tokens + self.num_ip_tokens


# ---------------------------------------------------------------------------
# UNet (SDXL backbone + manga hooks; reference src/models/unet.py:43)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    # attention depth of each stage; 0 = plain ResNet stage (SDXL: DownBlock2D)
    transformer_layers_per_block: Tuple[int, ...] = (0, 2, 10)
    head_dim: int = 64
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    # SDXL micro-conditioning: pooled text (1280) + 6 size ids * 256
    addition_time_embed_dim: int = 256
    pooled_projection_dim: int = 1280
    mid_transformer_layers: int = 10
    manga: MangaConfig = MangaConfig()
    # enable the additive dialog-layout embedding after conv_in (unet.py:86,209)
    use_dialog_embedding: bool = True
    # LoRA adapters on every attention projection (to_q/k/v/out), the
    # reference's unet_trained_parameters='lora' mode (train.py:162-174,
    # self_0.5.yaml:21 rank 128); 0 disables (param tree unchanged)
    lora_rank: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def addition_embed_input_dim(self) -> int:
        return self.pooled_projection_dim + 6 * self.addition_time_embed_dim

    @classmethod
    def sdxl(cls, manga: MangaConfig = MangaConfig()) -> "UNetConfig":
        return cls(manga=manga)

    @classmethod
    def tiny(cls, manga: Optional[MangaConfig] = None) -> "UNetConfig":
        manga = manga or MangaConfig(max_num_ips=2, num_vision_tokens=4,
                                     num_dummy_tokens=4, max_num_dialogs=3)
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            transformer_layers_per_block=(0, 1),
            head_dim=16,
            cross_attention_dim=32,
            norm_num_groups=8,
            addition_time_embed_dim=8,
            pooled_projection_dim=16,
            mid_transformer_layers=1,
            manga=manga,
        )


# ---------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL equivalent)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025  # SDXL VAE

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        # 4 stages so the tiny stack keeps the production latent = H/8 geometry
        return cls(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                   norm_num_groups=4)


# ---------------------------------------------------------------------------
# CLIP text encoders (SDXL uses two: CLIP-L and OpenCLIP-bigG)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None  # set on encoder 2 (pooled output)

    @classmethod
    def clip_l(cls) -> "TextEncoderConfig":
        return cls()

    @classmethod
    def clip_bigg(cls) -> "TextEncoderConfig":
        return cls(hidden_size=1280, num_layers=32, num_heads=20,
                   intermediate_size=5120, hidden_act="gelu",
                   projection_dim=1280)

    @classmethod
    def tiny(cls, projection_dim: Optional[int] = None) -> "TextEncoderConfig":
        return cls(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
                   max_position_embeddings=77, intermediate_size=64,
                   projection_dim=projection_dim)


# ---------------------------------------------------------------------------
# Vision encoders: CLIP ViT-H (IP-Adapter image encoder) and Magi ViTMAE
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VisionEncoderConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    hidden_act: str = "gelu"
    use_pre_layernorm: bool = True   # CLIP-style pre-LN stack
    use_class_embedding: bool = True
    patch_bias: bool = False         # CLIP patchify has no bias; ViTMAE does
    norm_eps: float = 1e-5           # HF ViTMAE uses 1e-12

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + int(self.use_class_embedding)

    @classmethod
    def clip_vit_h(cls) -> "VisionEncoderConfig":
        # laion CLIP-ViT-H/14, the IP-Adapter image encoder
        return cls()

    @classmethod
    def magi_vitmae(cls) -> "VisionEncoderConfig":
        # Magi manga-domain ViTMAE-base encoder (CLS feature consumer)
        return cls(patch_size=16, hidden_size=768, num_layers=12, num_heads=12,
                   intermediate_size=3072, use_pre_layernorm=False,
                   patch_bias=True, norm_eps=1e-12)

    @classmethod
    def tiny(cls, patch_size: int = 56) -> "VisionEncoderConfig":
        return cls(image_size=224, patch_size=patch_size, hidden_size=32,
                   num_layers=2, num_heads=2, intermediate_size=64)


# ---------------------------------------------------------------------------
# Dual-stream Perceiver Resampler (reference src/models/resampler.py:79,
# hyper-params configs/model/diffsensei.yaml:7-12)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1280
    depth: int = 4
    dim_head: int = 64
    heads: int = 20
    num_queries: int = 16         # = num_vision_tokens
    num_dummy_tokens: int = 16
    embedding_dim: int = 1280     # CLIP ViT-H hidden size
    magi_embedding_dim: int = 768 # Magi ViTMAE hidden size
    output_dim: int = 2048        # = cross_attention_dim
    ff_mult: int = 4

    @classmethod
    def diffsensei(cls) -> "ResamplerConfig":
        return cls()

    @classmethod
    def tiny(cls, manga: MangaConfig = MangaConfig(max_num_ips=2, num_vision_tokens=4,
                                                   num_dummy_tokens=4)) -> "ResamplerConfig":
        return cls(dim=32, depth=1, dim_head=8, heads=2,
                   num_queries=manga.num_vision_tokens,
                   num_dummy_tokens=manga.num_dummy_tokens,
                   embedding_dim=32, magi_embedding_dim=16, output_dim=32,
                   ff_mult=2)


# ---------------------------------------------------------------------------
# MLLM agent (SEED-X: LLaMA + LoRA + Qwen resamplers;
# configs/model/diffsensei.yaml:14-24)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32330        # resized for image tokens (mllm.yaml:32)
    hidden_size: int = 5120
    intermediate_size: int = 13824
    num_layers: int = 40
    num_heads: int = 40
    num_kv_heads: int = 40
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def seed_x_13b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=4,
                   max_position_embeddings=512)


@dataclasses.dataclass(frozen=True)
class QwenResamplerConfig:
    grid_size: int = 8
    embed_dim: int = 5120
    num_heads: int = 32
    kv_dim: Optional[int] = 2048
    # test hook: non-square query counts (production always grid_size**2 = 64,
    # which equals max_num_ips * num_vision_tokens)
    num_queries_override: Optional[int] = None

    @property
    def num_queries(self) -> int:
        return self.num_queries_override or self.grid_size ** 2

    @classmethod
    def seed_x_input(cls) -> "QwenResamplerConfig":
        return cls(grid_size=8, embed_dim=5120, num_heads=32, kv_dim=2048)

    @classmethod
    def seed_x_output(cls) -> "QwenResamplerConfig":
        return cls(grid_size=8, embed_dim=2048, num_heads=32, kv_dim=5120)

    @classmethod
    def tiny(cls, embed_dim: int = 64, kv_dim: int = 32) -> "QwenResamplerConfig":
        return cls(grid_size=2, embed_dim=embed_dim, num_heads=4, kv_dim=kv_dim)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 64
    alpha: int = 16
    target_modules: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "down_proj", "up_proj",
    )


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    llm: LlamaConfig = LlamaConfig()
    lora: LoRAConfig = LoRAConfig()
    input_resampler: QwenResamplerConfig = QwenResamplerConfig.seed_x_input()
    output_resampler: QwenResamplerConfig = QwenResamplerConfig.seed_x_output()
    lm_loss_scale: float = 1.0
    rec_loss_scale: float = 6.0
    mse: bool = True

    @classmethod
    def tiny(cls) -> "AgentConfig":
        llm = LlamaConfig.tiny()
        return cls(
            llm=llm,
            lora=LoRAConfig(rank=4),
            input_resampler=QwenResamplerConfig.tiny(embed_dim=llm.hidden_size, kv_dim=32),
            output_resampler=QwenResamplerConfig.tiny(embed_dim=32, kv_dim=llm.hidden_size),
        )


# ---------------------------------------------------------------------------
# Pipeline / serving configuration (configs/inference/diffsensei.yaml)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_inference_steps: int = 30
    guidance_scale: float = 7.5
    negative_prompt: str = (
        "think lines, pure black background, colored, lowres, bad anatomy, "
        "worst quality, low quality"
    )
    num_samples: int = 1
    ip_scale: float = 0.6
    mllm_scale: float = 0.4
    scheduler: str = "euler_discrete"  # "ddim" | "euler_discrete" | "dpmsolver++"
    # context-parallel serving: shard >=context_parallel_min_seq-token spatial
    # self-attention over the mesh data axis via ring-flash attention
    # (requires DiffSenseiPipeline(mesh=...); intended for 2048²-class panels)
    context_parallel: bool = False
    context_parallel_min_seq: int = 16384


# ---------------------------------------------------------------------------
# YAML loading (reference uses OmegaConf; plain PyYAML suffices here)
# ---------------------------------------------------------------------------
def load_yaml_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def dict_to_dataclass(cls, data: Dict[str, Any]):
    """Build a (possibly nested) dataclass from a dict, ignoring unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            continue
        ftype = fields[key].type
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = dict_to_dataclass(ftype, value)
        elif isinstance(value, list):
            value = _freeze(value)
        kwargs[key] = value
    return cls(**kwargs)
