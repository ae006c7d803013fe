"""Which parameters of the SEED-X LLaMA train (port of
``diffsensei_tpu/models/mllm/peft.py``).

The reference wraps the LLaMA in HF peft LoRA (r = 64 on q/k/v/o/gate/down/
up), keeps the embeddings and norms trainable, and resizes the vocabulary to
32330 for the image tokens; it offers two alternates, the top layers only
(``trained_layers: later_10``) and suffix-matched ``trained_parameters``.
LoRA is native to the port's ``LoRADense`` (``llama.py``), so the selection
is a ``{parameter name: trains}`` mask over the module's names (``lora_A`` /
``lora_B``, ``input_norm`` / ``post_norm`` / ``norm``, ``embed_tokens``,
``lm_head``), the form ``train.optim.partition_params`` takes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Sequence

import torch
from torch import nn


def lora_trainable_mask(llm: nn.Module, train_embeddings: bool = True,
                        train_norms: bool = True) -> Dict[str, bool]:
    """The adapters trainable (plus the embeddings and the norms), every base
    weight frozen: the reference's peft config."""
    def decide(name: str) -> bool:
        if "lora_A" in name or "lora_B" in name:
            return True
        if train_embeddings and ("embed_tokens" in name or "lm_head" in name):
            return True
        return train_norms and bool("input_norm" in name or "post_norm" in name
                                    or re.search(r"(^|\.)norm\.", name + "."))

    return {name: decide(name) for name, _ in llm.named_parameters()}


def later_layers_mask(llm: nn.Module, num_layers: int, train_last: int = 10) -> Dict[str, bool]:
    """``trained_layers: later_10``: only the top ``train_last`` decoder
    layers, the final norm and ``lm_head`` train."""
    first = num_layers - train_last

    def decide(name: str) -> bool:
        m = re.match(r"layers\.(\d+)\.", name)
        if m:
            return int(m.group(1)) >= first
        return "lm_head" in name or name.endswith("norm.weight") or ".norm." in name + "."

    return {name: decide(name) for name, _ in llm.named_parameters()}


def suffix_trainable_mask(llm: nn.Module, trained_parameters: Sequence[str]) -> Dict[str, bool]:
    """The parameters whose name ends with, or contains, one of
    ``trained_parameters``."""
    return {name: any(name.endswith(sfx) or sfx in name for sfx in trained_parameters)
            for name, _ in llm.named_parameters()}


@torch.no_grad()
def resize_vocab(llm: nn.Module, new_vocab_size: int) -> nn.Module:
    """Grow ``embed_tokens`` and ``lm_head`` to ``new_vocab_size`` rows in
    place (the reference resizes to 32330 for the image and location
    tokens); the new rows are the mean of the old ones (HF's convention).
    Returns ``llm``."""
    emb = llm.embed_tokens.weight
    old = emb.shape[0]
    if new_vocab_size < old:
        raise ValueError(f"cannot shrink vocab {old} -> {new_vocab_size}")
    if not isinstance(llm.lm_head, nn.Linear):
        raise ValueError("resize_vocab needs a dense lm_head (resize before quantizing)")
    if new_vocab_size > old:
        for owner, name in ((llm.embed_tokens, "weight"), (llm.lm_head, "weight")):
            w = getattr(owner, name)
            grown = torch.cat([w, w.mean(dim=0, keepdim=True).expand(new_vocab_size - old, -1)])
            setattr(owner, name, nn.Parameter(grown, requires_grad=w.requires_grad))
        llm.embed_tokens.num_embeddings = new_vocab_size
        llm.lm_head.out_features = new_vocab_size
        llm.config = dataclasses.replace(llm.config, vocab_size=new_vocab_size)
    return llm
