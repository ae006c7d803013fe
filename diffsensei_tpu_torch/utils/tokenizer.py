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

``LlamaTokenizer`` is the SEED-X agent's tokenizer (port of what
``diffsensei_tpu/serve/cli.py::mllm_spec_from_tokenizer`` takes from
``transformers.LlamaTokenizer``), without ``transformers``, ``protobuf`` or
``sentencepiece``: ``read_sentencepiece_model`` reads ``tokenizer.model``'s
protobuf wire format by hand, ``SentencePieceBPE`` encodes as sentencepiece's
BPE model does, and ``LlamaTokenizer`` splits out the added tokens and
applies the slow HF tokenizer's ``legacy`` rules around them.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import struct
import sys
import unicodedata
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# the SEED-X agent's LLaMA tokenizer: sentencepiece BPE
# ---------------------------------------------------------------------------
SPIECE_UNDERLINE = "▁"
# sentencepiece's SentencePiece.Type and TrainerSpec.ModelType
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
MODEL_TYPES = {1: "UNIGRAM", 2: "BPE", 3: "WORD", 4: "CHAR"}
BPE = 2


@dataclasses.dataclass(frozen=True)
class SentencePieceModel:
    """The fields of a sentencepiece ``ModelProto`` this port reads, with the
    proto's defaults."""

    pieces: Tuple[Tuple[str, float, int], ...] = ()    # (piece, score, type)
    model_type: int = 1
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    treat_whitespace_as_suffix: bool = False
    normalizer_name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated protobuf varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """``(field number, wire type, value)`` of each field of a serialized
    protobuf message: an int for a varint, the bytes of a length-delimited,
    fixed32 or fixed64 field."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire in (1, 2, 5):
            if wire == 2:
                size, pos = _varint(buf, pos)
            else:
                size = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + size], pos + size
            if pos > len(buf):
                raise ValueError(f"truncated protobuf field {field}")
        else:
            raise ValueError(f"protobuf wire type {wire} (field {field}) is not supported")
        yield field, wire, value


def _message(buf: bytes, wanted: Dict[int, int]) -> Dict[int, list]:
    """The values of the fields ``wanted`` (number -> wire type) in order of
    appearance; other fields are skipped."""
    out = {field: [] for field in wanted}
    for field, wire, value in _fields(buf):
        if field in wanted:
            if wire != wanted[field]:
                raise ValueError(f"protobuf field {field} has wire type {wire}, expected "
                                 f"{wanted[field]}")
            out[field].append(value)
    return out


def _int32(value: int) -> int:
    """A varint's int32 (negatives are sign-extended to 64 bits)."""
    return value - (1 << 64) if value >= 1 << 63 else value


def parse_sentencepiece_model(data: bytes) -> SentencePieceModel:
    """A serialized ``ModelProto``: ``pieces`` (1: ``piece`` 1, ``score`` 2,
    ``type`` 3), ``trainer_spec`` (2: ``model_type`` 3,
    ``treat_whitespace_as_suffix`` 24, ``byte_fallback`` 35, ``unk_id`` 40,
    ``bos_id`` 41, ``eos_id`` 42, ``pad_id`` 43) and ``normalizer_spec`` (3:
    ``name`` 1, ``precompiled_charsmap`` 2, ``add_dummy_prefix`` 3,
    ``remove_extra_whitespaces`` 4, ``escape_whitespaces`` 5). A scalar seen
    twice keeps its last value, and a message seen twice is merged, as
    protobuf parses them."""
    top = _message(data, {1: 2, 2: 2, 3: 2})
    pieces = []
    for raw in top[1]:
        f = _message(raw, {1: 2, 2: 5, 3: 0})
        pieces.append((f[1][-1].decode("utf-8") if f[1] else "",
                       struct.unpack("<f", f[2][-1])[0] if f[2] else 0.0,
                       f[3][-1] if f[3] else NORMAL))
    trainer = _message(b"".join(top[2]), {3: 0, 24: 0, 35: 0, 40: 0, 41: 0, 42: 0, 43: 0})
    norm = _message(b"".join(top[3]), {1: 2, 2: 2, 3: 0, 4: 0, 5: 0})
    base = SentencePieceModel()
    last = lambda values, default, cast=lambda v: v: cast(values[-1]) if values else default
    return SentencePieceModel(
        pieces=tuple(pieces),
        model_type=last(trainer[3], base.model_type),
        treat_whitespace_as_suffix=last(trainer[24], False, bool),
        byte_fallback=last(trainer[35], False, bool),
        unk_id=last(trainer[40], base.unk_id, _int32),
        bos_id=last(trainer[41], base.bos_id, _int32),
        eos_id=last(trainer[42], base.eos_id, _int32),
        pad_id=last(trainer[43], base.pad_id, _int32),
        normalizer_name=last(norm[1], "", lambda v: v.decode("utf-8")),
        precompiled_charsmap=last(norm[2], b"", bytes),
        add_dummy_prefix=last(norm[3], True, bool),
        remove_extra_whitespaces=last(norm[4], True, bool),
        escape_whitespaces=last(norm[5], True, bool))


def read_sentencepiece_model(path: str) -> SentencePieceModel:
    """``tokenizer.model`` at ``path``; raises ``ValueError`` for a model this
    port does not encode: one that is not BPE, a normalizer with a
    precompiled character map (an NFKC rule set such as ``nmt_nfkc``), or
    whitespace as a suffix. LLaMA's is BPE with the ``identity`` normalizer."""
    with open(path, "rb") as f:
        model = parse_sentencepiece_model(f.read())
    if model.model_type != BPE:
        kind = MODEL_TYPES.get(model.model_type, model.model_type)
        raise ValueError(f"{path}: a {kind} sentencepiece model; only BPE models are "
                         "supported")
    if model.precompiled_charsmap:
        raise ValueError(f"{path}: the normalizer {model.normalizer_name!r} has a precompiled "
                         "character map; only the identity normalizer is supported")
    if model.treat_whitespace_as_suffix:
        raise ValueError(f"{path}: treat_whitespace_as_suffix is not supported")
    return model


class SentencePieceBPE:
    """sentencepiece's BPE encoding of one model (identity normalizer).

    Normalization: with ``remove_extra_whitespaces``, leading spaces go and
    runs of spaces become one; the dummy prefix puts a space in front of
    non-empty text; spaces become ``▁`` (U+2581); with
    ``remove_extra_whitespaces``, trailing ``▁`` go. Segmentation: code
    points, USER_DEFINED pieces matched whole first and never merged; then
    the adjacent pair whose concatenation is a NORMAL, USER_DEFINED or
    UNUSED piece is merged, the highest score first and the leftmost on a
    tie, until none is left; an UNUSED piece is split back into the pair it
    was merged from. A symbol that is no piece is ``<unk>``, or with
    ``byte_fallback`` one ``<0xXX>`` piece per UTF-8 byte."""

    def __init__(self, model: SentencePieceModel, add_dummy_prefix: Optional[bool] = None):
        self.model = model
        self.add_dummy_prefix = (model.add_dummy_prefix if add_dummy_prefix is None
                                 else add_dummy_prefix)
        self.scores: Dict[str, float] = {}        # merge targets
        self.piece_ids: Dict[str, int] = {}
        self.reserved: Dict[str, int] = {}        # CONTROL, UNKNOWN, BYTE
        self.unused = set()
        user_defined, unk = [], []
        for i, (piece, score, kind) in enumerate(model.pieces):
            if not piece or piece in self.piece_ids or piece in self.reserved:
                raise ValueError(f"sentencepiece piece {i} ({piece!r}) is empty or repeated")
            if kind in (NORMAL, USER_DEFINED, UNUSED):
                self.piece_ids[piece], self.scores[piece] = i, score
            else:
                self.reserved[piece] = i
            user_defined += [piece] if kind == USER_DEFINED else []
            unk += [i] if kind == UNKNOWN else []
            if kind == UNUSED:
                self.unused.add(piece)
        if len(unk) != 1:
            raise ValueError(f"a sentencepiece model needs one UNKNOWN piece, this one has "
                             f"{len(unk)}")
        self.unk_id = unk[0]
        byte_pieces = {p for p, _, kind in model.pieces if kind == BYTE}
        if byte_pieces and byte_pieces != {f"<0x{b:02X}>" for b in range(256)} \
                or model.byte_fallback and not byte_pieces:
            raise ValueError(f"byte_fallback is {model.byte_fallback} with {len(byte_pieces)} "
                             "BYTE pieces; it needs all 256 <0xXX> pieces or none")
        self._user_defined = re.compile("|".join(
            map(re.escape, sorted(user_defined, key=len, reverse=True)))) if user_defined else None

    def piece_to_id(self, piece: str) -> int:
        return self.reserved.get(piece, self.piece_ids.get(piece, self.unk_id))

    def normalize(self, text: str) -> str:
        m = self.model
        if m.remove_extra_whitespaces:
            text = re.sub(" +", " ", text.lstrip(" "))
        if not text:
            return ""
        if self.add_dummy_prefix:
            text = " " + text
        space = " "
        if m.escape_whitespaces:
            text, space = text.replace(" ", SPIECE_UNDERLINE), SPIECE_UNDERLINE
        return text.rstrip(space) if m.remove_extra_whitespaces else text

    def _symbols(self, text: str) -> List[Tuple[str, bool]]:
        """Code points, and USER_DEFINED pieces whole (frozen)."""
        out, pos = [], 0
        while pos < len(text):
            hit = self._user_defined.match(text, pos) if self._user_defined else None
            end = hit.end() if hit else pos + 1
            out.append((text[pos:end], hit is not None))
            pos = end
        return out

    def encode(self, text: str) -> List[str]:
        """The pieces of ``text`` (``SentencePieceProcessor.encode(text,
        out_type=str)``)."""
        symbols = self._symbols(self.normalize(text))
        merged_from = {}
        while True:
            best, at = None, -1
            for i in range(len(symbols) - 1):
                (a, frozen_a), (b, frozen_b) = symbols[i], symbols[i + 1]
                score = None if frozen_a or frozen_b else self.scores.get(a + b)
                if score is not None and (best is None or score > best):
                    best, at = score, i
            if at < 0:
                break
            a, b = symbols[at][0], symbols[at + 1][0]
            merged_from[a + b] = (a, b)
            symbols[at:at + 2] = [(a + b, False)]

        def resegment(piece: str) -> List[str]:
            if piece in self.unused and piece in merged_from:
                return [p for part in merged_from[piece] for p in resegment(part)]
            return [piece]

        out = []
        for piece, _ in symbols:
            for p in resegment(piece):
                if self.model.byte_fallback and self.piece_to_id(p) == self.unk_id:
                    out += [f"<0x{b:02X}>" for b in p.encode("utf-8")]
                else:
                    out.append(p)
        return out


@dataclasses.dataclass(frozen=True)
class AddedToken:
    """A token split out of the text before sentencepiece sees it;
    ``lstrip`` / ``rstrip`` take the whitespace on its left / right."""

    content: str
    id: int
    lstrip: bool = False
    rstrip: bool = False


def _read_json(path: str, name: str) -> dict:
    file = os.path.join(path, name)
    if not os.path.exists(file):
        return {}
    with open(file, encoding="utf-8") as f:
        return json.load(f)


class LlamaTokenizer:
    """The slow HF ``LlamaTokenizer``'s ids (``transformers/models/llama/
    tokenization_llama.py``) over ``SentencePieceBPE``.

    ``tokenize`` splits the text on the added tokens (the special tokens
    among them) as ``PreTrainedTokenizer.tokenize`` does, leftmost and
    longest first, applying their ``lstrip`` / ``rstrip``. Under ``legacy``
    (the default, ``tokenization_llama.py:155-164``) each chunk between them
    is encoded alone with the model's dummy prefix. Otherwise
    (``:235-270``) ``▁`` in the text becomes a space, one ``▁`` goes in
    front of the text (``add_prefix_space``), sentencepiece runs without the
    dummy prefix, a chunk that starts with a space is encoded behind
    ``unk_token`` whose pieces are then dropped, and a leading lone ``▁``
    before a special token is dropped. ``encode`` puts ``bos`` in front
    when ``add_special_tokens``, as HF's defaults do."""

    def __init__(self, model: SentencePieceModel, added_tokens: Iterable[AddedToken] = (),
                 bos_token: str = "<s>", eos_token: str = "</s>", unk_token: str = "<unk>",
                 pad_token: Optional[str] = None,
                 additional_special_tokens: Sequence[str] = (), legacy: bool = True,
                 add_prefix_space: bool = True):
        self.sp = SentencePieceBPE(model, None if legacy else False)
        self.legacy, self.add_prefix_space = legacy, add_prefix_space
        self.unk_token = unk_token
        self.added = {t.content: t for t in added_tokens}
        specials = [t for t in (bos_token, eos_token, unk_token, pad_token,
                                *additional_special_tokens) if t is not None]
        for token in specials:          # HF registers the special tokens as added tokens
            if token not in self.added:
                if token not in self.sp.reserved and token not in self.sp.piece_ids:
                    raise ValueError(f"special token {token!r} is neither a piece nor an "
                                     "added token")
                self.added[token] = AddedToken(token, self.sp.piece_to_id(token))
        self.all_special_tokens = set(specials)
        self._split = re.compile("(" + "|".join(
            map(re.escape, sorted(self.added, key=len, reverse=True))) + ")")
        self.bos_token_id = self.convert_tokens_to_ids(bos_token)
        self.eos_token_id = self.convert_tokens_to_ids(eos_token)
        self.pad_token_id = None if pad_token is None else self.convert_tokens_to_ids(pad_token)
        self.unk_token_length = len(self.sp.encode(unk_token))

    @classmethod
    def from_pretrained(cls, path: str) -> "LlamaTokenizer":
        """A tokenizer directory: ``tokenizer.model``; optionally
        ``added_tokens.json`` (content -> id), ``tokenizer_config.json``
        (``added_tokens_decoder`` with ``lstrip`` / ``rstrip``, ``legacy``,
        ``add_prefix_space``, the special tokens) and
        ``special_tokens_map.json`` (the special tokens, over the config's)."""
        file = os.path.join(path, "tokenizer.model")
        if not os.path.isfile(file):
            raise FileNotFoundError(f"{path}: no tokenizer.model (a LLaMA tokenizer directory "
                                    "holds its sentencepiece model there)")
        model = read_sentencepiece_model(file)
        cfg = _read_json(path, "tokenizer_config.json")
        tokens = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>", pad_token=None)
        extra: List[str] = []
        for source in (cfg, _read_json(path, "special_tokens_map.json")):
            for key in tokens:
                if _token_content(source.get(key)):
                    tokens[key] = _token_content(source[key])
            if source.get("additional_special_tokens"):
                extra = [_token_content(t) for t in source["additional_special_tokens"]]
        added = {}
        for index, entry in cfg.get("added_tokens_decoder", {}).items():
            if entry.get("single_word"):
                raise ValueError(f"{path}: added token {entry['content']!r} is single_word, "
                                 "which is not supported")
            added[entry["content"]] = AddedToken(entry["content"], int(index),
                                                 bool(entry.get("lstrip")),
                                                 bool(entry.get("rstrip")))
        for content, index in _read_json(path, "added_tokens.json").items():
            added.setdefault(content, AddedToken(content, int(index)))
        flag = lambda key, default: default if cfg.get(key) is None else bool(cfg[key])
        return cls(model, added.values(), **tokens, additional_special_tokens=extra,
                   legacy=flag("legacy", True), add_prefix_space=flag("add_prefix_space", True))

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.added[token].id if token in self.added else self.sp.piece_to_id(token)

    def _tokenize(self, text: str) -> List[str]:
        if self.legacy or not text.startswith((SPIECE_UNDERLINE, " ")):
            return self.sp.encode(text)
        pieces = self.sp.encode(self.unk_token + text)
        return pieces[self.unk_token_length:] if len(pieces) >= self.unk_token_length else pieces

    def tokenize(self, text: str) -> List[str]:
        new_rules = not self.legacy and len(text) > 0
        if new_rules:
            text = text.replace(SPIECE_UNDERLINE, " ")
            if self.add_prefix_space:
                text = SPIECE_UNDERLINE + text
        parts = self._split.split(text)         # odd indices: added tokens
        for i in range(1, len(parts), 2):
            token = self.added[parts[i]]
            if token.rstrip and parts[i + 1]:
                parts[i + 1] = parts[i + 1].lstrip()
            if token.lstrip and parts[i - 1]:
                parts[i - 1] = parts[i - 1].rstrip()
        pieces = []
        for i, part in enumerate(parts):
            if i % 2:
                pieces.append(part)
            elif part:
                pieces += self._tokenize(part)
        if new_rules and len(pieces) > 1 and pieces[0] == SPIECE_UNDERLINE \
                and pieces[1] in self.all_special_tokens:
            pieces = pieces[1:]
        return pieces

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.convert_tokens_to_ids(p) for p in self.tokenize(text)]
        return [self.bos_token_id] + ids if add_special_tokens else ids
