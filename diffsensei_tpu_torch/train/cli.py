"""Training entry point: ``python -m diffsensei_tpu_torch.train.cli --config <yaml>``
(port of ``diffsensei_tpu/train/cli.py``).

The YAML schema is the JAX CLI's (``configs/train/*.yaml``): ``stage``, the
``model`` / ``train_data`` / ``optimizer`` / ``lr_scheduler`` / ``trainer``
groups. It runs on the card unless ``--device cpu`` asks for the CPU, where
every kernel wrapper takes its plain twin.

Ported: stages ``t2i`` (1), ``condition`` (2) and ``mllm`` (3: the SEED-X
agent with LoRA on its LLaMA, ``model.agent``), the presets ``tiny`` (random
weights; ``init`` and ``param_dtype`` ignored, as the JAX CLI ignores them)
and ``sdxl`` (``init: zeros`` by default, ``random`` or ``none``;
``param_dtype: float32`` trains fp32 copies of the trainables, ``bfloat16``
trains them in bf16 with no fp32 masters), the ``weights:`` group of
checkpoint files (``utils.load.apply_ported_weights``, after the build and
before the adapters' init), ``train_data.tokenizer_path`` /
``tokenizer_2_path`` (CLIP tokenizer directories; CRC-32 word hashing
without them), ``unet_trained_parameters`` ``full``, ``new``, ``ip`` and
``lora`` (UNet adapters of ``model.lora_rank``), per-block remat
(``model.remat``) under ``model.remat_policy`` (``dots``, ``attn``,
``dots_attn``, ``dots_deepest``; an unknown name raises), per-layer LLaMA
remat (``model.agent.remat``) under ``model.agent.remat_policy`` (``attn``),
a policy without its ``remat`` ignored as in the JAX CLI, gradient
accumulation, checkpoints and resume.

Multi-GPU: one process a rank under ``python -m torch.distributed.run
--nproc_per_node N -m diffsensei_tpu_torch.train.cli --config ...`` (alone, a
world of one rank), each on the card ``cuda:$LOCAL_RANK``. A bucket's batch
is the per-rank size times the world and each rank loads its rows
(``data_parallel``, ``host_id``, ``num_hosts`` of the bucket dataset).
``trainer.parallel: dp`` (the default) puts the trainables in DDP;
``fsdp`` shards them, their optimizer state and the frozen stack with FSDP2
(``trainer.fsdp_min_size``; for stage 3 the agent's LLaMA and resamplers,
the frozen stack, UNet and Resampler); another value raises
``ValueError``. Both spread the batch over the ranks; the model axis
(tensor parallelism of the agent's LLaMA) has no flag here, as in the JAX
CLI: it is reached through ``parallel.tensor`` and ``models.mllm.seed_x.
shard_agent``. Rank 0 alone writes ``metrics.jsonl`` and the checkpoints,
whose tensors are whole.
"""

from __future__ import annotations

import argparse
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from diffsensei_tpu_torch.core.config import (
    AgentConfig, LlamaConfig, QwenResamplerConfig, load_yaml_config)
from diffsensei_tpu_torch.data.bucket_dataset import (
    BucketDatasetConfig, MangaTrainSizeBucketDataset)
from diffsensei_tpu_torch.data.loader import PrefetchLoader
from diffsensei_tpu_torch.data.mllm_dataset import MangaTrainMLLMDataset, MLLMTokenSpec
from diffsensei_tpu_torch.models.lora import ensure_lora_init
from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
from diffsensei_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, init_distributed
from diffsensei_tpu_torch.parallel.train import PARALLEL_MODES, fsdp_train, wrap_ddp
from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules
from diffsensei_tpu_torch.train.diffusion import (
    FrozenDiffusionStack, Stage2Config, TrainState, make_stage1_step, make_stage2_step)
from diffsensei_tpu_torch.train.mllm_step import Stage3Config, agent_trainables, make_stage3_step
from diffsensei_tpu_torch.train.optim import (
    make_lr_schedule, make_optimizer, partition_params, unet_trainable_mask)
from diffsensei_tpu_torch.train.runner import RunConfig, run_training
from diffsensei_tpu_torch.utils.load import apply_ported_weights
from diffsensei_tpu_torch.utils.tokenizer import CLIPTokenizer


def hash_tokenizer(vocab_size: int = 49408, length: int = 77) -> Callable[[str], np.ndarray]:
    """Stand-in tokenizer for runs without CLIP vocabulary files: bos, one id a
    word, eos, zero padding. The JAX CLI's uses Python's ``hash``, which
    changes from process to process; this one uses CRC-32, so a resumed run
    sees the ids the first one saw."""
    def tok(text: str) -> np.ndarray:
        words = text.split()[: length - 2]
        ids = np.zeros((length,), np.int32)
        ids[0] = vocab_size - 2
        for i, word in enumerate(words):
            ids[i + 1] = zlib.crc32(word.encode()) % (vocab_size - 3) + 1
        ids[len(words) + 1] = vocab_size - 1
        return ids
    return tok


def load_tokenizer(path: Optional[str], vocab_size: int) -> Callable[[str], np.ndarray]:
    """The CLIP tokenizer of a tokenizer directory (``vocab.json``,
    ``merges.txt``), or the CRC-32 word hash without one (the JAX CLI's
    ``_load_tokenizer``)."""
    return CLIPTokenizer.from_pretrained(path) if path else hash_tokenizer(vocab_size)


def build_models(model_cfg: Dict[str, Any], device="cuda", seed: int = 0) -> PipelineModules:
    """The diffusion stack of the ``model:`` group: the tiny preset with
    random flax-like weights from ``seed``, the sdxl preset by ``init``
    (zeros unless set; a ``weights:`` group overlays checkpoints next).
    ``unet_trained_parameters: lora`` gives the UNet adapters of
    ``model.lora_rank`` (the reference's stage-1/2 LoRA mode), which must be
    positive."""
    lora_rank = 0
    if model_cfg.get("unet_trained_parameters") == "lora":
        lora_rank = int(model_cfg.get("lora_rank", 0))
        if lora_rank <= 0:
            raise ValueError("unet_trained_parameters: lora requires model.lora_rank > 0")
    preset = model_cfg.get("preset", "tiny")
    if preset == "tiny":
        mods = PipelineModules.tiny(device=device, seed=seed, lora_rank=lora_rank)
    elif preset == "sdxl":
        mods = PipelineModules.sdxl(device=device, seed=seed, lora_rank=lora_rank,
                                    init=model_cfg.get("init", "zeros"))
    else:
        raise ValueError(f"unknown model preset {preset}")
    if model_cfg.get("remat", False):
        mods.unet.enable_remat(model_cfg.get("remat_policy"))
    return mods


def trainable_dtype(model_cfg: Dict[str, Any]) -> Optional[torch.dtype]:
    """The trainables' dtype: fp32 copies (``param_dtype: float32``, the
    default), or the sdxl preset's bf16 weights as they are (``bfloat16``:
    None, no fp32 masters). The tiny preset ignores ``param_dtype``."""
    name = model_cfg.get("param_dtype", "float32")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"param_dtype must be float32 or bfloat16, got {name!r}")
    if name == "bfloat16" and model_cfg.get("preset", "tiny") == "sdxl":
        return None
    return torch.float32


def build_agent(model_cfg: Dict[str, Any], modules: PipelineModules, device="cuda",
                seed: int = 0) -> ContinuousLVLM:
    """The SEED-X agent of ``model.agent`` beside ``modules``, in the UNet's
    dtype, random flax-like weights from ``seed``: the JAX CLI's small agent
    for the ``tiny`` preset (its resamplers sized to the stack's IP tokens),
    ``AgentConfig()`` for ``sdxl``; ``lora_rank``, ``remat`` and
    ``remat_policy`` (None or ``attn``) from ``model.agent``."""
    agent_cfg = dict(model_cfg.get("agent", {}) or {})
    if model_cfg.get("preset", "tiny") == "tiny":
        llm, iv = LlamaConfig.tiny(), modules.manga.num_ip_tokens
        cross = modules.unet.config.cross_attention_dim
        acfg = AgentConfig(
            llm=llm,
            input_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                                embed_dim=llm.hidden_size, num_heads=4,
                                                kv_dim=cross),
            output_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                                 embed_dim=cross, num_heads=4,
                                                 kv_dim=llm.hidden_size))
    else:
        acfg = AgentConfig()
    return ContinuousLVLM.build(acfg, dtype=modules.unet.dtype,
                                lora_rank=int(agent_cfg.get("lora_rank", acfg.lora.rank)),
                                device=device, seed=seed + 3,
                                remat=bool(agent_cfg.get("remat", True)),
                                remat_policy=agent_cfg.get("remat_policy"))


def mllm_token_spec(agent: ContinuousLVLM, train_data: Dict[str, Any]) -> MLLMTokenSpec:
    """The stream's ids: the image ladder at the top of the vocabulary (or
    ``train_data.mllm_ladder_ids``) and caption words hashed by CRC-32 below
    it (the JAX CLI hashes with Python's ``hash``, which changes from process
    to process)."""
    vocab = agent.config.llm.vocab_size
    n_img = agent.config.input_resampler.num_queries
    ladder = list(train_data.get("mllm_ladder_ids", range(vocab - n_img - 2, vocab)))
    return MLLMTokenSpec(
        bos_id=train_data.get("mllm_bos_id", 1), eos_id=train_data.get("mllm_eos_id", 2),
        pad_id=train_data.get("mllm_pad_id", 0), boi_id=ladder[0], eoi_id=ladder[-1],
        img_ids=ladder[1:-1],
        encode_text=lambda text: [zlib.crc32(w.encode()) % (vocab - n_img - 10) + 3
                                  for w in text.split()])


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None) -> TrainState:
    """Run the config's training; ``on_step(step, metrics)`` sees every step."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--max_train_steps", type=int, default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = load_yaml_config(args.config)
    stage = cfg.get("stage", "condition")
    if stage not in ("t2i", "condition", "mllm"):
        raise ValueError(f"unknown stage {stage}")
    trainer = dict(cfg.get("trainer", {}))
    parallel = trainer.get("parallel", "dp")
    if parallel not in PARALLEL_MODES:
        raise ValueError(f"unknown trainer.parallel: {parallel!r} (expected 'dp' or 'fsdp')")
    if args.max_train_steps is not None:
        trainer["max_train_steps"] = args.max_train_steps
    if args.log_dir is not None:
        trainer["log_dir"] = args.log_dir
    if args.resume:
        trainer["resume"] = True
    env = init_distributed(args.device)
    device = env.device
    if parallel == "fsdp" and env.backend != "nccl" and device.type == "cuda":
        raise ValueError("trainer.parallel: fsdp needs NCCL (one card a rank): gloo does not "
                         "all-gather or reduce-scatter CUDA tensors")
    seed = int(trainer.get("seed", 0))
    max_steps = int(trainer.get("max_train_steps", 1000))

    mcfg = dict(cfg.get("model", {}))
    param_dtype = trainable_dtype(mcfg)
    modules = build_models(mcfg, device, seed)
    modules = apply_ported_weights(modules, cfg.get("weights") or {})
    left = [name for name, mod in modules.networks().items()
            if any(p.is_meta for p in mod.parameters())]
    if left:
        raise ValueError(f"init: none needs the weights: group to cover {left}")
    # a dead (all-zero) adapter never trains: gaussian-init it, as the JAX CLI does
    ensure_lora_init(modules.unet, seed=seed)
    manga = modules.manga

    # data ------------------------------------------------------------------
    td = dict(cfg.get("train_data", {}))
    ds_cfg = BucketDatasetConfig(
        data_parallel=env.world, c_drop_rate=td.get("c_drop_rate", 0.05),
        t_drop_rate=td.get("t_drop_rate", 0.05), i_drop_rate=td.get("i_drop_rate", 0.05),
        max_num_ips=manga.max_num_ips, max_num_ip_sources=td.get("max_num_ip_sources", 1),
        max_num_dialogs=manga.max_num_dialogs, mask_dialog=td.get("mask_dialog", False),
        ip_self_condition_rate=td.get("ip_self_condition_rate", 0.5),
        ip_flip_rate=td.get("ip_flip_rate", 0.5), batch_size=td.get("batch_size", 8))
    data_kw = dict(ann_path=td["ann_path"], image_root=td.get("image_root", ""),
                   tokenize=load_tokenizer(td.get("tokenizer_path"),
                                           modules.text_encoder.config.vocab_size),
                   tokenize_2=load_tokenizer(td.get("tokenizer_2_path"),
                                             modules.text_encoder_2.config.vocab_size),
                   config=ds_cfg)
    if stage == "mllm":
        agent = build_agent(mcfg, modules, device, seed)
        dataset = MangaTrainMLLMDataset(**data_kw, mllm_spec=mllm_token_spec(agent, td),
                                        max_token_length=td.get("max_token_length", 400))
    else:
        dataset = MangaTrainSizeBucketDataset(**data_kw)
    num_workers = int(td.get("num_workers", 8))

    def batches_from(step: int):
        """The stream from its ``step``-th batch: epoch ``e`` shuffled by
        ``seed + e``, as the JAX loader seeds it."""
        first, skip = divmod(step, dataset.num_batches())
        return PrefetchLoader(
            lambda e: dataset.batches(shuffle=True, seed=seed + e, num_workers=num_workers,
                                      skip=skip if e == first else 0, host_id=env.rank,
                                      num_hosts=env.world),
            device=device, first_epoch=first)

    # frozen stack, trainables, step -----------------------------------------
    frozen = FrozenDiffusionStack(
        vae=modules.vae, text_encoder=modules.text_encoder,
        text_encoder_2=modules.text_encoder_2, image_encoder=modules.image_encoder,
        magi_encoder=modules.magi_encoder, vae_scaling=modules.vae.config.scaling_factor)
    schedule = DDPMSchedule()
    if stage == "mllm":
        # the diffusion stack frozen, the agent's LoRA, embeddings, norms and
        # resamplers trained
        step_fn = make_stage3_step(modules.unet, modules.resampler, agent, schedule,
                                   Stage3Config(manga=manga, mllm_loss_weight=float(
                                       mcfg.get("mllm_loss_weight", 1.0))), env.group)
        params = agent_trainables(agent)
        trained = {"llm": agent.llm, "input_resampler": agent.input_resampler,
                   "output_resampler": agent.output_resampler}
        frozen_modules = {"unet": modules.unet, "resampler": modules.resampler}
    else:
        frozen_modules = None
        if stage == "t2i":
            step_fn = make_stage1_step(modules.unet, schedule, env.group)
            mode = mcfg.get("unet_trained_parameters", "full")
        else:
            step_fn = make_stage2_step(modules.unet, modules.resampler, schedule, Stage2Config(
                manga=manga, ip_contrastive=mcfg.get("ip_contrastive_loss"),
                ip_contrastive_weight=mcfg.get("ip_contrastive_loss_weight", 0.1)), env.group)
            mode = mcfg.get("unet_trained_parameters", "new")
        trainable, _ = partition_params(modules.unet, unet_trainable_mask(modules.unet, mode),
                                        param_dtype)
        params = {f"unet.{k}": p for k, p in trainable.items()}
        if stage == "condition":
            res = modules.resampler
            trainable, _ = partition_params(res, {k: True for k, _ in res.named_parameters()},
                                            param_dtype)
            params.update({f"resampler.{k}": p for k, p in trainable.items()})
        trained = {"unet": modules.unet}
        if stage == "condition":
            trained["resampler"] = modules.resampler

    # the parallel layout (the JAX CLI's trainer.parallel) ---------------------
    if parallel == "dp":
        wrap_ddp(step_fn, trained, env)
    else:
        params = fsdp_train(step_fn, trained, frozen, params, env,
                            int(trainer.get("fsdp_min_size", FSDP_MIN_SIZE)), frozen_modules)

    opt_cfg = dict(cfg.get("optimizer", {}))
    lr_cfg = dict(cfg.get("lr_scheduler", {}))
    lr = make_lr_schedule(lr_cfg.get("name", "constant_with_warmup"),
                          float(opt_cfg.get("lr", 1e-4)),
                          num_warmup_steps=int(lr_cfg.get("num_warmup_steps", 0)),
                          num_training_steps=max_steps,
                          min_lr_ratio=float(lr_cfg.get("min_lr_ratio", 0.0)))
    optimizer = make_optimizer(params.values(), lr,
                               weight_decay=float(opt_cfg.get("weight_decay", 1e-2)),
                               max_grad_norm=opt_cfg.get("max_grad_norm", 1.0),
                               accumulate=int(trainer.get("gradient_accumulation_steps", 1)))
    state = TrainState(params, optimizer)

    run_cfg = RunConfig(
        max_train_steps=max_steps, log_dir=trainer.get("log_dir", "logs/run"),
        log_every=int(trainer.get("log_every", 50)),
        checkpoint_every=int(trainer.get("checkpoint_every",
                                         trainer.get("checkpointing_interval", 1000))),
        checkpoint_steps=tuple(trainer.get("checkpointing_steps", ()) or ()),
        checkpoints_total_limit=trainer.get("checkpoints_total_limit", 5),
        seed=seed, resume=bool(trainer.get("resume", False)),
        memory_log_every=int(trainer.get("memory_log_every", 500)))
    return run_training(step_fn, state, batches_from, run_cfg, frozen=frozen, device=device,
                        on_step=on_step, env=env)


if __name__ == "__main__":
    main()
