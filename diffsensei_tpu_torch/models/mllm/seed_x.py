"""ContinuousLVLM, the SEED-X agent that adapts character embeddings to the
prompt (port of ``diffsensei_tpu/models/mllm/seed_x.py``, serving half).

* The resampled character tokens are scattered into the prompt's
  comprehension slots by an ordered scatter over fixed shapes.
* Greedy decode with the forced image-token ladder: a vocab-indexed successor
  table gives ``next = succ[last]`` where it is set, else the argmax of the
  logits with the ladder ids (``img_k`` and ``</img>``) set to **0.0** (not
  -inf), ties to the first index. All ``max_new_tokens`` steps run; there is
  no stop at EOS. The loop is a Python loop over a static KV cache, and the
  chosen token stays on the device between steps.
* The agent's output is the ``nq`` hidden states before each ``</img>``,
  resampled by the output resampler into ``img_gen_feat``.
* Under tensor parallelism (``shard_agent``: the LLM split over the mesh's
  model axis, ``parallel/tensor.py``) every model rank decodes the same
  tokens: ``pick`` reads the gathered logits, the KV cache holds the
  rank's KV heads (the JAX ``kv_sharding``), and the resamplers are whole
  on each rank, so ``output_ids`` and ``img_gen_feat`` agree on all of them.
* ``loss`` is the stage-3 training forward: resample the character blocks,
  scatter the comprehension block into the token stream, the LLM's LM loss,
  and the reconstruction loss of the output resampler over the generation
  slots' hidden states against the target block. The row orders are stable
  sorts, as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from diffsensei_tpu_torch.core.config import AgentConfig
from diffsensei_tpu_torch.models.mllm.llama import (
    LlamaForCausalLM, cross_entropy_lm_loss, init_caches)
from diffsensei_tpu_torch.models.mllm.qwen_resampler import QwenResampler


def _true_first(mask: torch.Tensor) -> torch.Tensor:
    """Per row, the indices with ``mask`` True first, each group in order
    (a stable argsort of ``~mask``)."""
    return torch.argsort((~mask).to(torch.int8), dim=1, stable=True)


def _ordered_true_gather(values: torch.Tensor, mask: torch.Tensor,
                         count: int) -> torch.Tensor:
    """Per row, the first ``count`` entries of ``values`` where ``mask`` is
    True, in order. values ``[B, L, D]``, mask ``[B, L]`` -> ``[B, count, D]``."""
    order = _true_first(mask)[:, :count]
    return torch.gather(values, 1, order[..., None].expand(-1, -1, values.shape[-1]))


def _ordered_scatter(base: torch.Tensor, mask: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Write ``tokens[k]`` into the k-th True position of ``mask``, per row.
    base ``[B, L, D]``, mask ``[B, L]``, tokens ``[B, K, D]``."""
    slot = torch.cumsum(mask.to(torch.long), dim=1) - 1
    slot = slot.clamp(0, tokens.shape[1] - 1)
    gathered = torch.gather(tokens, 1, slot[..., None].expand(-1, -1, tokens.shape[-1]))
    return torch.where(mask[..., None], gathered.to(base.dtype), base)


@dataclasses.dataclass
class ContinuousLVLM:
    """The LLM and its input/output resamplers."""

    config: AgentConfig
    llm: LlamaForCausalLM
    input_resampler: QwenResampler
    output_resampler: QwenResampler

    @classmethod
    def build(cls, config: AgentConfig, dtype: torch.dtype = torch.float32,
              lora_rank: Optional[int] = None, quantized=False, device="cuda",
              seed: int = 0, remat: bool = False, remat_policy: Optional[str] = None,
              init: str = "random") -> "ContinuousLVLM":
        """Random flax-like weights drawn on ``device`` from ``seed``, every
        parameter frozen; ``init="none"`` leaves the modules on the meta
        device for a checkpoint loader (``utils.load.load_agent_weights``,
        ``quant.quantize_agent_on_host``).

        ``quantized`` ("int8"/True or "int4") builds the weight-only quantized
        serving LLM without LoRA; real weights come through
        ``quant.quantize_agent``. For training, build in the base's dtype
        (bf16 on the card) with ``remat`` for per-layer recompute (under
        ``remat_policy``: None or ``"attn"``, ignored without ``remat``); then
        ``train.mllm_step.agent_trainables`` makes the trainables fp32 and
        trainable beside the frozen base."""
        from diffsensei_tpu_torch.utils.init import init_flax_like_

        lora = config.lora.rank if lora_rank is None else lora_rank
        if quantized:
            lora = 0
        device = torch.device(device)
        with torch.device("meta"):
            agent = cls(config,
                        LlamaForCausalLM(config.llm, lora_rank=lora, quantized=quantized,
                                         dtype=dtype),
                        QwenResampler(config.input_resampler, dtype=dtype),
                        QwenResampler(config.output_resampler, dtype=dtype))
        if init not in ("random", "none"):
            raise ValueError(f"init must be 'random' or 'none', got {init!r}")
        gen = torch.Generator(device=device).manual_seed(seed) if init == "random" else None
        for mod in agent.networks():
            if gen is not None:
                init_flax_like_(mod.to_empty(device=device), gen)
            mod.eval().requires_grad_(False)
        if remat:
            agent.llm.enable_remat(remat_policy)
        return agent

    def networks(self):
        return (self.llm, self.input_resampler, self.output_resampler)

    @property
    def device(self) -> torch.device:
        return self.llm.embed_tokens.weight.device

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(lm_scale * lm + rec_scale * rec, {"lm_loss", "rec_loss",
        "recon_image_embeds"})`` over the modules' parameters.

        batch: ``input_ids`` / ``labels`` [B, L] (labels -100 outside the
        supervision); ``image_embeds`` [B, n_img, S_img, D_in] character
        blocks; ``embeds_cmp_mask`` / ``embeds_gen_mask`` [B, n_img] bool;
        ``ids_cmp_mask`` / ``ids_gen_mask`` [B, L] bool (nq slots an image).
        ``recon_image_embeds`` is [B, nq_out, D_out]. A row's rec loss counts
        only where it has a generation image and at least nq generation
        slots."""
        cfg = self.config
        nq_in = cfg.input_resampler.num_queries
        nq_out = cfg.output_resampler.num_queries
        cmp_mask, gen_mask = batch["embeds_cmp_mask"].bool(), batch["embeds_gen_mask"].bool()
        ids_gen = batch["ids_gen_mask"].bool()
        b, n_img = cmp_mask.shape
        img = batch["image_embeds"]
        s_img, d_in = img.shape[-2:]

        # 1. every image block through the input resampler
        img_lm = self.input_resampler(img.reshape(b * n_img, s_img, d_in))
        img_lm = img_lm.reshape(b, n_img, nq_in, -1)

        # 2. comprehension rows first, flattened, scattered into the stream
        order = _true_first(cmp_mask)
        cmp_tokens = torch.gather(img_lm, 1, order[:, :, None, None].expand_as(img_lm))
        input_embeds = self.llm.embed_tokens_only(batch["input_ids"].long())
        input_embeds = _ordered_scatter(input_embeds, batch["ids_cmp_mask"].bool(),
                                        cmp_tokens.reshape(b, n_img * nq_in, -1))

        # 3. the LLM and its LM loss
        logits, hidden, _ = self.llm(inputs_embeds=input_embeds)
        lm_loss = cross_entropy_lm_loss(logits, batch["labels"])

        # 4. generation slots -> output resampler, against the target block
        recon = self.output_resampler(_ordered_true_gather(hidden, ids_gen, nq_in))
        first_gen = _true_first(gen_mask)[:, 0]
        target = img[torch.arange(b, device=img.device), first_gen][:, :nq_out].detach()
        valid = (gen_mask.sum(dim=1) > 0) & (ids_gen.sum(dim=1) >= nq_in)
        err = (recon.float() - target.float()).square().mean(dim=(1, 2))
        rec_loss = torch.where(valid, err, 0.0).sum() / valid.sum().clamp(min=1)

        total = cfg.lm_loss_scale * lm_loss + cfg.rec_loss_scale * rec_loss
        return total, {"lm_loss": lm_loss, "rec_loss": rec_loss, "recon_image_embeds": recon}

    @torch.inference_mode()
    def generate(self, input_ids, image_embeds=None, ids_cmp_mask=None,
                 ladder_ids=None, max_new_tokens: int = 120) -> Dict[str, Any]:
        """Greedy decode with the forced image-token ladder.

        ``ladder_ids`` = ``[boi, img_0, ..., img_{n-1}, eoi]``. Returns
        ``{"output_ids": np [B, max_new], "img_gen_feat": [n, nq_out, D] or
        None, "num_gen_imgs": n}``."""
        cfg = self.config
        nq_in = cfg.input_resampler.num_queries
        dev = self.device
        input_ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=dev)
        b, prompt_len = input_ids.shape

        vocab = cfg.llm.vocab_size
        ladder = np.asarray(ladder_ids, np.int64)
        succ = np.full((vocab,), -1, np.int64)
        succ[ladder[:-1]] = ladder[1:]
        spont_mask = np.zeros((vocab,), bool)
        spont_mask[ladder[1:]] = True        # img_k and </img> never spontaneous

        input_embeds = self.llm.embed_tokens_only(input_ids)
        if image_embeds is not None:
            image_embeds = torch.as_tensor(image_embeds).to(dev)
            n_img = (image_embeds.shape[0] // b if image_embeds.dim() == 3
                     else image_embeds.shape[1])
            img = image_embeds.reshape(b * n_img, *image_embeds.shape[-2:])
            img_lm = self.input_resampler(img).reshape(b, n_img * nq_in, -1)
            mask = torch.as_tensor(np.asarray(ids_cmp_mask), dtype=torch.bool, device=dev)
            input_embeds = _ordered_scatter(input_embeds, mask, img_lm)

        out_ids, hiddens = _greedy_decode(
            self.llm, input_embeds, input_ids[:, -1], prompt_len,
            prompt_len + max_new_tokens, torch.from_numpy(succ).to(dev),
            torch.from_numpy(spont_mask).to(dev))
        out_ids = out_ids.cpu().numpy()

        # the nq hidden states before each </img>
        eoi = int(ladder[-1])
        feats = [hiddens[row, idx - nq_in:idx]
                 for row, row_ids in enumerate(out_ids)
                 for idx in np.where(row_ids == eoi)[0] if idx >= nq_in]
        img_gen_feat = self.output_resampler(torch.stack(feats)) if feats else None
        return {"output_ids": out_ids, "img_gen_feat": img_gen_feat,
                "num_gen_imgs": len(feats)}


def shard_agent(agent: ContinuousLVLM, group=None) -> ContinuousLVLM:
    """The agent with its LLM cut into this rank's shards over the model
    axis ``group`` (a process group, or a ``ScheduleRank`` for
    ``model_axis_schedule``), on the agent's device; the resamplers are
    shared. Build the whole agent first (``build``, a loader or
    ``quant.quantize_agent``), so that every rank cuts the same weights."""
    from diffsensei_tpu_torch.parallel.tensor import shard_llm

    return dataclasses.replace(agent, llm=shard_llm(agent.llm, group))


def _greedy_decode(llm: LlamaForCausalLM, input_embeds: torch.Tensor,
                   last_prompt_token: torch.Tensor, prompt_len: int, max_len: int,
                   succ: torch.Tensor, spont_mask: torch.Tensor):
    """Prefill, then ``max_len - prompt_len`` cached decode steps; returns
    ``(ids [B, max_new], hiddens [B, max_new, dim])``: ``ids[:, k]`` is the
    k-th generated token and ``hiddens[:, k]`` the LLM's hidden state of that
    token (the state that predicts token k+1)."""
    b = input_embeds.shape[0]
    dev = input_embeds.device
    caches = init_caches(llm.config, b, max_len, input_embeds.dtype, dev, tp=llm.tp_size)
    positions = torch.arange(prompt_len, device=dev)[None].expand(b, prompt_len)
    logits, _, caches = llm(inputs_embeds=input_embeds, positions=positions,
                            caches=caches, cache_index=0)

    def pick(last, logits_row):
        forced = succ[last]
        masked = torch.where(spont_mask[None, :], 0.0, logits_row.float())
        free = torch.argmax(masked, dim=-1)
        return torch.where(forced >= 0, forced, free)

    # prompts end with <img>, which forces <img_0> here
    token = pick(last_prompt_token, logits[:, -1])
    ids, hiddens = [], []
    for i in range(max_len - prompt_len):
        emb = llm.embed_tokens_only(token[:, None])
        pos = torch.full((b, 1), prompt_len + i, dtype=torch.long, device=dev)
        logits, hidden, caches = llm(inputs_embeds=emb, positions=pos, caches=caches,
                                     cache_index=prompt_len + i)
        ids.append(token)
        hiddens.append(hidden[:, 0])
        token = pick(token, logits[:, -1])
    return torch.stack(ids, dim=1), torch.stack(hiddens, dim=1)
