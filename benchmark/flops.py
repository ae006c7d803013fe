"""FLOPs of the work a request or a train step asks for, counted with
``FlopCounterMode`` over the plain reference on the meta device (matmuls
and convolutions; no arithmetic runs), split by the precision the
configuration states for each network: the VAE in ``vae_dtype``, the rest in
``dtype``. Remat's replay is not counted: the reference keeps every
activation. AdamW's elementwise update is not counted either (about ten
operations a trainable, under 0.01% of a step).

With an agent (``reference/agent.py``) a request also asks for the agent's
work, a term of its own (``agent_least_s``): its prefill and each decode
step at the least, as the configuration's reference decoder counts them
(``least_cost``), and the two resamplers.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Tuple

import torch

from benchmark.reference import agent as RA
from benchmark.reference import diffusion as RD
from benchmark.reference import nets as RN
from benchmark.weights import DTYPES
from benchmark.yardstick import HBM_BYTES_PER_S, PEAK_FLOPS, reference_flops


@functools.lru_cache(maxsize=None)
def _nets(stack_json: str):
    with torch.device("meta"):
        return RN.build(json.loads(stack_json))


def least_s(flops: Dict[str, float]) -> float:
    """The least time of work split by dtype, each at its peak."""
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops.items())


@functools.lru_cache(maxsize=None)
def request_flops(stack_json: str, steps: int, h: int, w: int, samples: int,
                  characters: bool) -> Tuple[Tuple[str, float], ...]:
    """One served request: both prompts through both text encoders, the
    characters through CLIP-H, ViTMAE and the Resampler twice, ``steps``
    UNet calls on the CFG batch, and the decode of every panel."""
    stack = json.loads(stack_json)
    nets = _nets(stack_json)
    meta = torch.device("meta")
    manga = stack["manga"]
    f = nets["vae"].factor
    lh, lw = h // f, w // f
    rows = 2 * samples
    ids = torch.zeros((2, 77), dtype=torch.long, device=meta)
    cond = reference_flops(RN.encode_prompt, nets, ids, ids)
    tokens, biases = None, None
    if characters:
        px = torch.zeros((manga["max_num_ips"], 224, 224, 3), device=meta)

        def chars():
            clip_h, _ = nets["image_encoder"](px)
            _, magi = nets["magi_encoder"](px)
            nets["resampler"](clip_h[None], magi[None])
            return nets["resampler"](clip_h[None], magi[None])
        cond += reference_flops(chars)
        n_tok = manga["num_dummy_tokens"] + manga["max_num_ips"] * manga["num_vision_tokens"]
        tokens = torch.zeros((rows, n_tok, stack["unet"]["cross_attention_dim"]), device=meta)
        biases = {lv: torch.zeros((rows, RN.level_shape(lh, lw, lv)[0] * RN.level_shape(lh, lw, lv)[1],
                                   n_tok), device=meta) for lv in nets["unet"].levels()}
    unet = reference_flops(
        nets["unet"], torch.zeros((rows, lh, lw, stack["unet"]["in_channels"]), device=meta),
        torch.zeros((rows,), device=meta),
        torch.zeros((rows, 77, stack["unet"]["cross_attention_dim"]), device=meta),
        torch.zeros((rows, stack["unet"]["pooled_projection_dim"]), device=meta),
        torch.zeros((rows, 6), device=meta), tokens, biases, 0.6,
        torch.zeros((rows, manga["max_num_dialogs"], 4), device=meta))
    dec = reference_flops(RN.decode_image, nets["vae"],
                          torch.zeros((samples, lh, lw, stack["vae"]["latent_channels"]), device=meta),
                          stack["vae"]["scaling_factor"])
    out = {stack["dtype"]: cond + steps * unet}
    out[stack["vae_dtype"]] = out.get(stack["vae_dtype"], 0.0) + dec
    return tuple(out.items())


@functools.lru_cache(maxsize=None)
def train_step_flops(stack_json: str, rows: int, h: int, w: int,
                     sources: int) -> Tuple[Tuple[str, float], ...]:
    """One stage-2 step: the VAE encode and the frozen encoders forward, the
    Resampler and the UNet forward and the backward that the trainables'
    gradients need (through the UNet's activations to its IP projections
    and dialog embedding, and through the Resampler)."""
    stack = json.loads(stack_json)
    nets = _nets(stack_json)
    meta = torch.device("meta")
    manga = stack["manga"]
    f = nets["vae"].factor
    lh, lw = h // f, w // f
    crops = rows * manga["max_num_ips"] * sources
    with torch.no_grad():
        vae = reference_flops(nets["vae"].encode, torch.zeros((rows, h, w, 3), device=meta))
        px = torch.zeros((crops, 224, 224, 3), device=meta)
        ids = torch.zeros((rows, 77), dtype=torch.long, device=meta)

        def frozen():
            nets["image_encoder"](px)
            nets["magi_encoder"](px)
            RN.encode_prompt(nets, ids, ids)
        enc = reference_flops(frozen)
    names = RD.trainable_names(nets, "new")
    params = [nets[n.split(".", 1)[0]].get_parameter(n.split(".", 1)[1]) for n in names]
    for p in params:
        p.requires_grad_(True)
    seq = (stack["image_encoder"]["image_size"] // stack["image_encoder"]["patch_size"]) ** 2 + 1

    def step():
        emb = nets["resampler"](torch.zeros((rows * sources, manga["max_num_ips"], seq,
                                             stack["resampler"]["embedding_dim"]), device=meta),
                                torch.zeros((rows * sources, manga["max_num_ips"],
                                             stack["resampler"]["magi_embedding_dim"]), device=meta))
        n_tok = emb.shape[1]
        biases = {lv: torch.zeros((rows, RN.level_shape(lh, lw, lv)[0] * RN.level_shape(lh, lw, lv)[1],
                                   n_tok), device=meta) for lv in nets["unet"].levels()}
        pred = nets["unet"](torch.zeros((rows, lh, lw, stack["unet"]["in_channels"]), device=meta),
                            torch.zeros((rows,), device=meta),
                            torch.zeros((rows, 77, stack["unet"]["cross_attention_dim"]), device=meta),
                            torch.zeros((rows, stack["unet"]["pooled_projection_dim"]), device=meta),
                            torch.zeros((rows, 6), device=meta), emb[:rows], biases, 1.0,
                            torch.zeros((rows, manga["max_num_dialogs"], 4), device=meta))
        pred.float().square().mean().backward()
    trained = reference_flops(step)
    for p in params:
        p.requires_grad_(False)
        p.grad = None
    out = {stack["dtype"]: enc + trained}
    out[stack["vae_dtype"]] = out.get(stack["vae_dtype"], 0.0) + vae
    return tuple(out.items())


@functools.lru_cache(maxsize=None)
def agent_least_s(stack_json: str, prompt_len: int, new_tokens: int) -> float:
    """The agent's least time in one request with characters: the input
    resampler over the character block, the prefill of ``prompt_len``
    tokens at the larger of its FLOPs over the peak and its bytes over the
    memory rate, ``new_tokens`` decode steps at the bytes each must read,
    and the output resampler, all in the stack's ``dtype``."""
    stack = json.loads(stack_json)
    agent = stack["agent"]
    manga = stack["manga"]
    dtype = stack["dtype"]
    cost = RA.decoder(agent).least_cost(RA.llm_config(agent), prompt_len, new_tokens,
                                        DTYPES[dtype].itemsize)
    meta = torch.device("meta")
    with meta:
        res = {k: RA.QwenResampler(agent[k]) for k in ("input_resampler", "output_resampler")}
    chars = torch.zeros((1, manga["max_num_ips"] * manga["num_vision_tokens"],
                         stack["unet"]["cross_attention_dim"]), device=meta)
    out_cfg = agent["output_resampler"]
    hidden = torch.zeros((1, RA.num_queries(agent["input_resampler"]),
                          out_cfg.get("kv_dim") or out_cfg["embed_dim"]), device=meta)
    resampled = reference_flops(lambda: (res["input_resampler"](chars),
                                         res["output_resampler"](hidden)))
    prefill = max(cost["prefill_flops"] / PEAK_FLOPS[dtype],
                  cost["prefill_bytes"] / HBM_BYTES_PER_S)
    return resampled / PEAK_FLOPS[dtype] + prefill + cost["decode_bytes"] / HBM_BYTES_PER_S
