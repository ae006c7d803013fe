"""The system under test, built as its users build it: the port's modules
from a configuration file, the benchmark's seeded weights loaded into them,
then the serving API (with the SEED-X agent where the stack has one) or the
stage-2 training step of the train CLI.

Everything of ``diffsensei_tpu_torch`` is imported inside these functions,
so that the reference and the yardstick import none of it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch


def port_configs(stack: Dict) -> Dict:
    """The port's config dataclasses for a configuration file's ``stack``."""
    from diffsensei_tpu_torch.core import config as C

    manga = C.dict_to_dataclass(C.MangaConfig, stack["manga"])
    unet = dataclasses.replace(C.dict_to_dataclass(C.UNetConfig, stack["unet"]), manga=manga)
    return dict(unet=unet, vae=C.dict_to_dataclass(C.VAEConfig, stack["vae"]),
                text_encoder=C.dict_to_dataclass(C.TextEncoderConfig, stack["text_encoder"]),
                text_encoder_2=C.dict_to_dataclass(C.TextEncoderConfig, stack["text_encoder_2"]),
                image_encoder=C.dict_to_dataclass(C.VisionEncoderConfig, stack["image_encoder"]),
                magi_encoder=C.dict_to_dataclass(C.VisionEncoderConfig, stack["magi_encoder"]),
                resampler=C.dict_to_dataclass(C.ResamplerConfig, stack["resampler"]))


def modules(stack: Dict, weights: Dict[str, Dict[str, torch.Tensor]], device):
    """``PipelineModules`` holding ``weights``; the UNet's and VAE's convs
    laid out channels-last, as ``PipelineModules.sdxl`` lays them out."""
    from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules
    from benchmark.weights import DTYPES

    mods = PipelineModules.build(port_configs(stack), DTYPES[stack["dtype"]], device,
                                 init="none", channels_last=True)
    for name, mod in mods.networks().items():
        _load(name, mod, weights[name])
        if name in ("unet", "vae"):
            mod.to(memory_format=torch.channels_last)
    return mods


def _load(name: str, mod, state: Dict[str, torch.Tensor]) -> None:
    have = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in state.items()}
    if have != want:
        raise ValueError(f"{name}: the program's parameters differ from the reference's: "
                         f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
    mod.load_state_dict(state, strict=True, assign=True)
    mod.eval().requires_grad_(False)


def _config(cls, keys: Dict):
    """A port config dataclass of exactly these keys (an unknown key raises)."""
    from diffsensei_tpu_torch.core.config import dict_to_dataclass

    unknown = set(keys) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__} has no {sorted(unknown)}")
    return dict_to_dataclass(cls, keys)


def agent(stack: Dict, weights: Dict[str, Dict[str, torch.Tensor]], device):
    """The port's ``ContinuousLVLM`` of the stack's ``agent`` section, built
    empty in the stack's ``dtype`` (its LLM of the config class the section
    names by import path, the vocabulary with the added rows), ``weights``
    loaded by strict names."""
    from diffsensei_tpu_torch.core.config import AgentConfig, QwenResamplerConfig
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from benchmark.reference.agent import llm_config
    from benchmark.weights import DTYPES

    a = stack["agent"]
    module, _, cls = a["llm"]["class"].rpartition(".")
    acfg = dataclasses.replace(
        AgentConfig(), llm=_config(getattr(importlib.import_module(module), cls), llm_config(a)),
        input_resampler=_config(QwenResamplerConfig, a["input_resampler"]),
        output_resampler=_config(QwenResamplerConfig, a["output_resampler"]))
    lvlm = ContinuousLVLM.build(acfg, DTYPES[stack["dtype"]], lora_rank=0, device=device,
                                init="none")
    for name, mod in zip(("llm", "input_resampler", "output_resampler"), lvlm.networks()):
        _load(name, mod, weights[name])
    return lvlm


def token_spec(agent_cfg: Dict):
    """The agent's ``MLLMTokenSpec``: the image ladder on the vocabulary's
    last ``num_img_tokens + 2`` rows; ``encode_text`` reads a request's
    caption ids from its prompt (space-separated ids) and gives the
    configuration's newline ids for a newline."""
    from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec
    from benchmark.reference.agent import ladder as ladder_of

    ladder = ladder_of(agent_cfg)
    newline = list(agent_cfg["newline_ids"])
    return MLLMTokenSpec(
        bos_id=agent_cfg["bos_id"], eos_id=agent_cfg["eos_id"], pad_id=agent_cfg["pad_id"],
        boi_id=ladder[0], eoi_id=ladder[-1], img_ids=ladder[1:-1],
        encode_text=lambda s: list(newline) if s == "\n" else [int(t) for t in s.split()])


def server(cfg: Dict, mods, auto_batch_max_side, lvlm=None):
    """``DiffSenseiServer`` over the pipeline with the configuration's
    sampler settings, and the agent ``lvlm`` where given (with
    ``mllm_scale`` and ``mllm_max_new_tokens`` of the sampler)."""
    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline
    from diffsensei_tpu_torch.serve.api import DiffSenseiServer

    s = cfg["sampler"]
    kw = dict(num_inference_steps=s["num_inference_steps"], guidance_scale=s["guidance_scale"],
              ip_scale=s["ip_scale"], scheduler=s["scheduler"])
    if lvlm is None:
        return DiffSenseiServer(DiffSenseiPipeline(mods, PipelineConfig(**kw)),
                                auto_batch_max_side=auto_batch_max_side)
    pcfg = PipelineConfig(mllm_scale=s["mllm_scale"], **kw)
    return DiffSenseiServer(DiffSenseiPipeline(mods, pcfg), agent=lvlm,
                            mllm_spec=token_spec(cfg["stack"]["agent"]),
                            mllm_max_new_tokens=s["mllm_max_new_tokens"],
                            auto_batch_max_side=auto_batch_max_side)


def request(spec: Dict):
    from diffsensei_tpu_torch.serve.api import GenerationRequest

    return GenerationRequest(prompt=spec.get("prompt", ""),
                             height=spec["height"], width=spec["width"],
                             num_inference_steps=spec.get("steps"),
                             num_samples=spec["num_samples"], seed=spec["seed"],
                             character_images=spec["characters"], ip_bbox=spec["ip_bbox"],
                             dialog_bbox=spec["dialog_bbox"], prompt_ids=spec["prompt_ids"])


def int8_unet(mods) -> None:
    """Swap in the program's own weight-only int8 UNet (the control)."""
    from diffsensei_tpu_torch.models.quant_unet import quantize_unet

    mods.unet = quantize_unet(mods.unet)


def trainer(cfg: Dict, mods, ann_path: str, image_root: str, seed: int, num_workers: int,
            device):
    """What ``train/cli.py`` builds for ``stage: condition`` in a world of one
    rank: the bucket dataset and the prefetch loader's stream, the frozen
    stack, the stage-2 step under DDP, the trainables (fp32 copies, or bf16
    where ``param_dtype`` says so) and their clipped AdamW. Returns
    ``(step_fn, state, frozen, batches_from, env)``."""
    from diffsensei_tpu_torch.data.bucket_dataset import (
        BucketDatasetConfig, MangaTrainSizeBucketDataset)
    from diffsensei_tpu_torch.data.loader import PrefetchLoader
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.parallel.mesh import init_distributed
    from diffsensei_tpu_torch.parallel.train import wrap_ddp
    from diffsensei_tpu_torch.train.cli import hash_tokenizer, trainable_dtype
    from diffsensei_tpu_torch.train.diffusion import (
        FrozenDiffusionStack, Stage2Config, TrainState, make_stage2_step)
    from diffsensei_tpu_torch.train.optim import (
        make_lr_schedule, make_optimizer, partition_params, unet_trainable_mask)

    env = init_distributed(device)
    if cfg.get("remat"):
        mods.unet.enable_remat(cfg.get("remat_policy"))
    manga = mods.manga
    td = cfg["train_data"]
    ds_cfg = BucketDatasetConfig(
        data_parallel=env.world, c_drop_rate=td["c_drop_rate"], t_drop_rate=td["t_drop_rate"],
        i_drop_rate=td["i_drop_rate"], max_num_ips=manga.max_num_ips,
        max_num_ip_sources=td["max_num_ip_sources"], max_num_dialogs=manga.max_num_dialogs,
        ip_self_condition_rate=td["ip_self_condition_rate"], ip_flip_rate=td["ip_flip_rate"],
        batch_size=td["batch_size"])
    dataset = MangaTrainSizeBucketDataset(
        ann_path=ann_path, image_root=image_root,
        tokenize=hash_tokenizer(mods.text_encoder.config.vocab_size),
        tokenize_2=hash_tokenizer(mods.text_encoder_2.config.vocab_size), config=ds_cfg)

    def batches_from(step: int):
        first, skip = divmod(step, dataset.num_batches())
        return PrefetchLoader(
            lambda e: dataset.batches(shuffle=True, seed=seed + e, num_workers=num_workers,
                                      skip=skip if e == first else 0, host_id=env.rank,
                                      num_hosts=env.world),
            device=device, first_epoch=first)

    frozen = FrozenDiffusionStack(
        vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
        image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder,
        vae_scaling=mods.vae.config.scaling_factor)
    step_fn = make_stage2_step(mods.unet, mods.resampler, DDPMSchedule(), Stage2Config(
        manga=manga, ip_contrastive=cfg["ip_contrastive_loss"],
        ip_contrastive_weight=cfg["ip_contrastive_loss_weight"]), env.group)
    model_cfg = {"preset": "sdxl", "param_dtype": cfg["param_dtype"]}
    dtype = trainable_dtype(model_cfg)
    trainable, _ = partition_params(
        mods.unet, unet_trainable_mask(mods.unet, cfg["unet_trained_parameters"]), dtype)
    params = {f"unet.{k}": p for k, p in trainable.items()}
    res = mods.resampler
    trainable, _ = partition_params(res, {k: True for k, _ in res.named_parameters()}, dtype)
    params.update({f"resampler.{k}": p for k, p in trainable.items()})
    wrap_ddp(step_fn, {"unet": mods.unet, "resampler": mods.resampler}, env)
    opt, sched = cfg["optimizer"], cfg["lr_scheduler"]
    lr = make_lr_schedule(sched["name"], float(opt["lr"]),
                          num_warmup_steps=int(sched["num_warmup_steps"]),
                          num_training_steps=int(cfg["max_train_steps"]),
                          min_lr_ratio=float(sched["min_lr_ratio"]))
    optimizer = make_optimizer(params.values(), lr, weight_decay=float(opt["weight_decay"]),
                               betas=tuple(opt["betas"]), eps=float(opt["eps"]),
                               max_grad_norm=opt["max_grad_norm"])
    return step_fn, TrainState(params, optimizer), frozen, batches_from, env
