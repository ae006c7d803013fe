"""The plain reference of the SEED-X agent's serving half, and how a
configuration names it.

A configuration's ``stack`` may hold ``agent``:

* ``llm``: ``class``, the program's config class by import path, and
  ``reference``, the plain decoder ``benchmark/reference/decoders/<name>.py``;
  every other key is the class's, with ``vocab_size`` the published
  vocabulary;
* ``input_resampler``, ``output_resampler``: the Qwen resamplers' keys
  (``grid_size``, ``embed_dim``, ``num_heads``, ``kv_dim``,
  ``num_queries_override``);
* ``num_img_tokens``; ``added_tokens``, the rows appended to the published
  vocabulary, whose last ``num_img_tokens + 2`` are ``<img>``, ``<img_k>``
  and ``</img>``; ``bos_id`` and ``newline_ids`` of the tokenizer (and its
  ``eos_id`` and ``pad_id``, which serving does not use).

The reference, plain torch in fp32: the Qwen resampler (learned queries, a
2-D sin-cos table added to queries and keys, one multi-head attention), the
serving prompt ``bos caption \\n <img><img_0..n></img> \\n <img>`` with the
resampled characters written in order into the ``<img_k>`` slots, the
ladder's rules (after ``<img>`` and each ``<img_k>`` its successor is
forced; elsewhere the argmax of the logits with ``<img_k>`` and ``</img>``
set to 0.0, ties to the first index; no stop at EOS), the ``nq`` final
hidden states before the first ``</img>`` through the output resampler, and
the blend ``scale * generated + (1 - scale) * characters``.
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from benchmark.reference.nets import attention, heads, merge


def decoder(agent: Dict):
    """The plain decoder module the configuration names."""
    return importlib.import_module(f"benchmark.reference.decoders.{agent['llm']['reference']}")


def llm_config(agent: Dict) -> Dict:
    """The LLM's keys as the program and the reference take them: the
    vocabulary with the added rows."""
    cfg = {k: v for k, v in agent["llm"].items() if k not in ("class", "reference")}
    cfg["vocab_size"] = agent["llm"]["vocab_size"] + agent["added_tokens"]
    return cfg


def ladder(agent: Dict) -> List[int]:
    """``[<img>, <img_0>, ..., </img>]``: the vocabulary's last rows."""
    vocab = llm_config(agent)["vocab_size"]
    return list(range(vocab - agent["num_img_tokens"] - 2, vocab))


def num_queries(cfg: Dict) -> int:
    return cfg.get("num_queries_override") or cfg["grid_size"] ** 2


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """``[grid**2, dim]``: row r = (i, j) holds sin and cos of j over the
    first half of the channels and of i over the second, at frequencies
    10000^(-k / (dim / 4))."""
    quarter = dim // 4
    omega = 1.0 / 10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter)
    i, j = np.meshgrid(np.arange(grid, dtype=np.float64), np.arange(grid, dtype=np.float64),
                       indexing="ij")

    def one(pos):
        ang = pos.reshape(-1)[:, None] * omega[None, :]
        return np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.from_numpy(np.concatenate([one(j), one(i)], axis=1).astype(np.float32))


def position_rows(table: torch.Tensor, n: int) -> torch.Tensor:
    """The table for ``n`` tokens: itself at its own length; repeated and cut
    where ``n`` is not a square. A square of another side would be resized,
    which no configuration here needs."""
    if n == table.shape[0]:
        return table
    if math.isqrt(n) ** 2 == n and math.isqrt(table.shape[0]) ** 2 == table.shape[0]:
        raise NotImplementedError(f"resizing a {table.shape[0]}-row position table to {n}")
    return table.repeat(-(-n // table.shape[0]), 1)[:n]


class QwenResampler(nn.Module):
    """``[B, S, kv_dim] -> [B, num_queries, embed_dim]``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        dim = cfg["embed_dim"]
        self.cfg = cfg
        self.query = nn.Parameter(torch.zeros(num_queries(cfg), dim))
        kv = cfg.get("kv_dim")
        self.kv_proj = nn.Linear(kv, dim, bias=False) if kv and kv != dim else None
        self.ln_q, self.ln_kv = nn.LayerNorm(dim, eps=1e-5), nn.LayerNorm(dim, eps=1e-5)
        self.attn = nn.Module()
        self.attn.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.attn.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.attn.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        dim, n = self.cfg["embed_dim"], self.cfg["num_heads"]
        table = sincos_2d(dim, self.cfg["grid_size"]).to(x.device)
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        x = self.ln_kv(x)
        q = self.ln_q(self.query) + position_rows(table, self.query.shape[0])
        k = x + position_rows(table, x.shape[1])
        w, b = self.attn.in_proj_weight.chunk(3), self.attn.in_proj_bias.chunk(3)
        lin = lambda t, i: t @ w[i].T + b[i]
        o = attention(heads(lin(q.expand(x.shape[0], -1, -1), 0), n), heads(lin(k, 1), n),
                      heads(lin(x, 2), n))
        return self.attn.out_proj(merge(o))


def inference_prompt(agent: Dict, caption: List[int]):
    """``(ids [S], comprehension mask [S])`` of the serving prompt."""
    lad = ladder(agent)
    nl = list(agent["newline_ids"])
    ids = [agent["bos_id"], *caption, *nl, *lad, *nl, lad[0]]
    mask = [False] * len(ids)
    first = 1 + len(caption) + len(nl) + 1
    for k in range(agent["num_img_tokens"]):
        mask[first + k] = True
    return ids, mask


def ordered_scatter(x: torch.Tensor, mask: List[bool], tokens: torch.Tensor) -> torch.Tensor:
    """``x [1, S, D]`` with ``tokens[k]`` in the k-th masked position."""
    slots = [s for s, m in enumerate(mask) if m]
    if len(slots) != tokens.shape[0]:
        raise ValueError(f"{len(slots)} slots for {tokens.shape[0]} tokens")
    x = x.clone()
    for k, s in enumerate(slots):
        x[0, s] = tokens[k]
    return x


def rule_breaks(agent: Dict, last_prompt_id: int, ids: np.ndarray, logits: torch.Tensor) -> int:
    """How many of the program's tokens the ladder's rules would not have
    chosen from the program's own logits (row k chooses token k)."""
    lad = ladder(agent)
    succ = dict(zip(lad[:-1], lad[1:]))
    banned = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
    banned[lad[1:]] = True
    breaks, prev = 0, last_prompt_id
    for k, tok in enumerate(ids.tolist()):
        if prev in succ:
            want = succ[prev]
        else:
            want = int(torch.argmax(torch.where(banned, 0.0, logits[k].float())))
        breaks += int(want != tok)
        prev = tok
    return breaks


def check(agent: Dict, caption: List[int], characters: torch.Tensor, got: Dict, scale: float,
          model: nn.Module, resamplers: Dict[str, nn.Module], load: Callable) -> Dict[str, float]:
    """Relative L2 distances of the program's agent outputs (``got``: the
    logits of the prefill's last position and of every decode step, the
    generated ids, ``img_gen_feat``'s first block, the blended characters)
    from the reference's, which rebuilds the prompt's embeddings from
    ``characters`` (its own Resampler's block) and runs one teacher-forced
    pass over the prompt and the program's ids: ``logits`` (the worst row),
    ``feat`` and ``blend``; each ``inf`` where the program's tokens break
    the ladder's rules or an output is missing. ``load(block)`` holds a
    block's fp32 weights while it runs (``llm.<decoder block>``,
    ``input_resampler``, ``output_resampler``)."""
    dec = decoder(agent)
    dev = characters.device
    norm = torch.linalg.vector_norm
    rel = lambda a, b: (norm(a.float() - b) / norm(b)).item()
    ids = got.get("ids")
    prompt, mask = inference_prompt(agent, caption)
    if (ids is None or got.get("feat") is None or got.get("blend") is None
            or rule_breaks(agent, prompt[-1], ids, got["logits"])):
        return dict(logits=math.inf, feat=math.inf, blend=math.inf)
    with load("input_resampler"):
        tokens = resamplers["input_resampler"](characters[None])[0]
    seq = torch.tensor(prompt + ids.tolist(), device=dev)
    logits, hidden = dec.forward(model, seq, lambda x: ordered_scatter(x, mask, tokens),
                                 lambda block: load(f"llm.{block}"))
    p = len(prompt)
    rows = logits[p - 1:]
    gaps = (norm(got["logits"].float() - rows, dim=-1) / norm(rows, dim=-1)).max().item()
    nq = num_queries(agent["input_resampler"])
    eoi = ladder(agent)[-1]
    at = [k for k, t in enumerate(ids.tolist()) if t == eoi and k >= nq][0]
    with load("output_resampler"):
        feat = resamplers["output_resampler"](hidden[None, p + at - nq:p + at])[0]
    want = scale * feat + (1.0 - scale) * characters
    return dict(logits=gaps, feat=rel(got["feat"], feat),
                blend=rel(got["blend"].reshape(want.shape), want))
