"""CLIP's byte-level BPE tokenizer from ``vocab.json`` and ``merges.txt``
(port of the JAX CLI's ``_load_tokenizer``, ``diffsensei_tpu/train/cli.py:44``,
which wraps ``transformers.CLIPTokenizer``).

It gives the ids ``transformers.CLIPTokenizer`` gives where ``ftfy`` is not
installed, without ``transformers`` or ``regex``: the special tokens (bos,
eos, unk, pad) split out first; the rest cleaned as HF's ``BasicTokenizer``
does (control characters dropped, whitespace runs to one space, spaces
around CJK ideographs, NFC, lower case, accents kept); split by CLIP's
pattern, whose ``\\p{L}`` and ``\\p{N}`` classes are built here from
``unicodedata``; each piece byte-encoded (``bytes_to_unicode``) and merged
by rank with ``</w>`` on its last symbol; then ``[bos] + ids[:75] + [eos]``
padded to 77 with the pad token. The pad token comes from
``special_tokens_map.json`` or ``tokenizer_config.json`` where they exist:
CLIP-L pads with ``<|endoftext|>``, SDXL's second tokenizer with ``!``.

A tokenizer answers both calls the port makes: ``tok(text)`` -> int32 ids
``[77]`` (the datasets), and the HF-style ``tok(text, padding="max_length",
max_length=77, truncation=True, return_tensors="np")["input_ids"]`` ->
``[1, 77]`` (the pipeline).
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
MAX_MERGES = 49152 - 256 - 2      # the merges HF's CLIPTokenizer reads


@functools.cache
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _char_classes() -> Tuple[str, str]:
    """``re`` class bodies of every letter (category L*) and every number
    (N*) code point, as code-point ranges."""
    ranges = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(cp))[0]
        if cat in ranges:
            r = ranges[cat]
            if r and r[-1][1] == cp - 1:
                r[-1][1] = cp
            else:
                r.append([cp, cp])
    esc = lambda cp: f"\\U{cp:08x}"
    return tuple("".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges[k])
                 for k in "LN")


@functools.cache
def clip_pattern() -> "re.Pattern":
    """CLIP's split pattern (``regex``'s ``\\p{L}`` / ``\\p{N}`` spelled as
    stdlib classes)."""
    letters, numbers = _char_classes()
    return re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                      rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+", re.IGNORECASE)


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def basic_clean(text: str) -> str:
    """HF ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``,
    joined by single spaces: what ``CLIPTokenizer`` splits when ``ftfy`` is
    absent."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def _token_content(value) -> Optional[str]:
    """A special token as ``special_tokens_map.json`` or
    ``tokenizer_config.json`` spell it: a string or ``{"content": ...}``."""
    if isinstance(value, dict):
        return value.get("content")
    return value


class CLIPTokenizer:
    """CLIP BPE over a vocabulary and merge list."""

    def __init__(self, encoder: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 pad_token: str = EOS, bos_token: str = BOS, eos_token: str = EOS,
                 unk_token: str = EOS, model_max_length: int = 77):
        self.encoder = dict(encoder)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token, self.pad_token = unk_token, pad_token
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.unk_token_id = self.encoder[unk_token]
        self.pad_token_id = self.encoder[pad_token]
        specials = sorted({bos_token, eos_token, unk_token, pad_token}, key=len, reverse=True)
        self._specials = set(specials)
        self._split = re.compile("(" + "|".join(map(re.escape, specials)) + ")")
        self._cache = {BOS: BOS, EOS: EOS}

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """A tokenizer directory (``vocab.json``, ``merges.txt``, optionally
        ``special_tokens_map.json`` / ``tokenizer_config.json``)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            encoder = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        tokens = dict(bos_token=BOS, eos_token=EOS, unk_token=EOS, pad_token=EOS)
        max_len = 77
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            file = os.path.join(path, name)
            if os.path.exists(file):
                with open(file, encoding="utf-8") as f:
                    cfg = json.load(f)
                for key in tokens:
                    if _token_content(cfg.get(key)):
                        tokens[key] = _token_content(cfg[key])
                if isinstance(cfg.get("model_max_length"), int):
                    max_len = min(cfg["model_max_length"], 77)
        return cls(encoder, merges, model_max_length=max_len, **tokens)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            first, second = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if (first, second) not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _piece_ids(self, text: str) -> List[int]:
        ids = []
        for piece in clip_pattern().findall(basic_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids += [self.encoder.get(t, self.unk_token_id) for t in self.bpe(mapped).split(" ")]
        return ids

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without bos, eos or padding."""
        ids = []
        for part in self._split.split(text):
            if part in self._specials:
                ids.append(self.encoder[part])
            elif part:
                ids += self._piece_ids(part)
        return ids

    def ids(self, text: str, max_length: Optional[int] = None) -> np.ndarray:
        """``[bos] + ids + [eos]`` truncated and padded to ``max_length``
        (default 77): int32 ``[max_length]``."""
        n = max_length or self.model_max_length
        body = self.encode(text)[:n - 2]
        out = np.full((n,), self.pad_token_id, np.int32)
        out[:len(body) + 2] = [self.bos_token_id, *body, self.eos_token_id]
        return out

    def __call__(self, text: str, padding=None, max_length: Optional[int] = None,
                 truncation=None, return_tensors=None):
        """``tok(text)`` -> int32 ids ``[77]``; with HF's keywords
        (``padding="max_length"``, ``truncation=True``,
        ``return_tensors="np"``) -> ``{"input_ids": [1, max_length]}``."""
        ids = self.ids(text, max_length)
        if padding is None and truncation is None and return_tensors is None:
            return ids
        if padding not in (True, "max_length") or truncation is not True \
                or return_tensors not in (None, "np"):
            raise ValueError("only padding='max_length', truncation=True and "
                             "return_tensors='np' are supported")
        return {"input_ids": ids[None]}
