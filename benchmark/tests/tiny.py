"""Tiny versions of the cells' configurations and traffic for CPU runs of
the harness: the port's tiny stack (``pipelines.pipeline.tiny_configs``'s
sizes) in float32, small panels, two steps; and a serving cell with the
SEED-X agent at ``AgentConfig.tiny()``'s widths (two grouped KV heads; both
resamplers at 8 queries, the tiny stack's 2 characters x 4 tokens)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

STACK = {
    "manga": {"max_num_ips": 2, "num_vision_tokens": 4, "num_dummy_tokens": 4,
              "max_num_dialogs": 3},
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "layers_per_block": 1, "transformer_layers_per_block": [0, 1], "head_dim": 16,
             "cross_attention_dim": 32, "norm_num_groups": 8, "addition_time_embed_dim": 8,
             "pooled_projection_dim": 16, "mid_transformer_layers": 1,
             "use_dialog_embedding": True},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4,
            "scaling_factor": 0.13025},
    "text_encoder": {"vocab_size": 256, "hidden_size": 16, "num_layers": 2, "num_heads": 2,
                     "max_position_embeddings": 77, "intermediate_size": 32,
                     "hidden_act": "quick_gelu", "projection_dim": None},
    "text_encoder_2": {"vocab_size": 256, "hidden_size": 16, "num_layers": 2, "num_heads": 2,
                       "max_position_embeddings": 77, "intermediate_size": 64,
                       "hidden_act": "gelu", "projection_dim": 16},
    "image_encoder": {"image_size": 224, "patch_size": 56, "hidden_size": 32, "num_layers": 2,
                      "num_heads": 2, "intermediate_size": 64, "hidden_act": "gelu",
                      "use_pre_layernorm": True, "use_class_embedding": True,
                      "patch_bias": False, "norm_eps": 1e-5},
    "magi_encoder": {"image_size": 224, "patch_size": 56, "hidden_size": 16, "num_layers": 2,
                     "num_heads": 2, "intermediate_size": 64, "hidden_act": "gelu",
                     "use_pre_layernorm": False, "use_class_embedding": True,
                     "patch_bias": True, "norm_eps": 1e-12},
    "resampler": {"dim": 32, "depth": 1, "dim_head": 8, "heads": 2, "num_queries": 4,
                  "num_dummy_tokens": 4, "embedding_dim": 32, "magi_embedding_dim": 16,
                  "output_dim": 32, "ff_mult": 2},
    "dtype": "float32", "vae_dtype": "float32", "tf32": False,
}


AGENT = {
    "llm": {"class": "diffsensei_tpu_torch.core.config.LlamaConfig", "reference": "llama",
            "vocab_size": 502, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2,
            "num_heads": 4, "num_kv_heads": 2, "max_position_embeddings": 512,
            "rope_theta": 10000.0, "rms_norm_eps": 1e-5},
    "input_resampler": {"grid_size": 2, "num_queries_override": 8, "embed_dim": 64,
                        "num_heads": 4, "kv_dim": 32},
    "output_resampler": {"grid_size": 2, "num_queries_override": 8, "embed_dim": 32,
                         "num_heads": 4, "kv_dim": 64},
    "num_img_tokens": 8, "added_tokens": 10, "bos_id": 1, "eos_id": 2, "pad_id": 0,
    "newline_ids": [13],
}
AGENT_LIMIT = 1e-4      # fp32 on both sides: order of operations only


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def serve_cell(traffic_name: str, **traffic_over):
    """(configuration, traffic) of a serving cell at tiny size."""
    cfg = copy.deepcopy(load("configs", "diffsensei-sdxl-serve"))
    cfg["stack"] = copy.deepcopy(STACK)
    cfg["sampler"]["num_inference_steps"] = 3
    traffic = load("traffic", traffic_name)
    traffic.update(sizes=[[256, 256]], warmup_steps=1, trace_requests=1)
    traffic.update(traffic_over)
    return cfg, traffic


def train_cell(traffic_name: str = "stage2_1024_b8", **traffic_over):
    cfg = copy.deepcopy(load("configs", "diffsensei-sdxl-stage2"))
    cfg["stack"] = copy.deepcopy(STACK)
    cfg["train_data"]["batch_size"] = 2
    traffic = load("traffic", traffic_name)
    traffic.update(pages=4, page_size=320, frame_size=256, num_workers=2, checked_steps=2,
                   trace_steps=1)
    traffic.update(traffic_over)
    return cfg, traffic


def agent_cell(**traffic_over):
    """(configuration, traffic) of a serving cell with the agent: one panel a
    request with characters, captions of 4-12 ids, 24 new tokens."""
    cfg, traffic = serve_cell("candidates_1024x4", num_samples=1, characters=[2, 1],
                              agent_prompt_tokens=[4, 12])
    cfg["stack"]["agent"] = copy.deepcopy(AGENT)
    cfg["sampler"].update(mllm_scale=0.4, mllm_max_new_tokens=24)
    traffic["limits"] = dict(traffic["limits"], agent_gap=AGENT_LIMIT)
    traffic.update(traffic_over)
    return cfg, traffic
