"""The port's SEED-X LLaMA tokenizer (``utils/tokenizer.py``) and
``serve/cli.py::mllm_spec_from_tokenizer`` on the CPU.

Neither ``sentencepiece`` nor the slow ``transformers.LlamaTokenizer`` runs
here. Each test writes its own ``tokenizer.model`` from a numpy seed with
``transformers``' ``ModelProto``: a few hundred pieces laid out as
LLaMA-2's (``chip_smoke.llama_pieces``: ``<unk>``, ``<s>``, ``</s>``, the
256 byte pieces, whole words and their prefixes, ``▁▁``, random BPE joins,
the single characters; every score its own). The reference for ids is
``LlamaTokenizerFast`` built from the same proto by ``transformers``'
``LlamaConverter``, with only its sentencepiece-backed extractor replaced by
one that reads the proto; ids must be equal exactly.

Where the fast tokenizer's rules are its own, the port is held against
pieces written out from the slow tokenizer's source
(``transformers/models/llama/tokenization_llama.py:235-270`` and
``PreTrainedTokenizer.tokenize``): text with an added token inside it, and
under ``legacy: false`` text that starts with a space or ``▁`` (the slow
tokenizer always puts ``▁`` in front; the fast one's ``Metaspace`` skips a
text that already starts with one) and a non-special added token alone (the
slow tokenizer keeps the lone ``▁`` before it, which the JAX function's
``ids[1]`` steps over).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import tokenizers
import transformers
from hypothesis import assume, given, settings, strategies as st
from PIL import Image
from transformers.convert_slow_tokenizer import LlamaConverter, generate_merges
from transformers.utils import sentencepiece_model_pb2_new as pb

import jax
import jax.numpy as jnp

import chip_smoke
from diffsensei_tpu.core.config import AgentConfig, LlamaConfig, QwenResamplerConfig
from diffsensei_tpu.data import mllm_dataset as jdata
from diffsensei_tpu.serve import api as japi
from diffsensei_tpu.serve import cli as jcli

from diffsensei_tpu_torch.data import mllm_dataset as tdata
from diffsensei_tpu_torch.serve import api as tapi
from diffsensei_tpu_torch.serve import cli as tcli
from diffsensei_tpu_torch.utils.tokenizer import (
    BYTE, CONTROL, NORMAL, UNKNOWN, UNUSED, USER_DEFINED, LlamaTokenizer,
    SentencePieceModel, parse_sentencepiece_model, read_sentencepiece_model)

from tests.torch_port_util import agents, tiny_pipelines

torch.set_num_threads(1)

WORDS = ["the", "girl", "man", "rain", "lead", "a", "in", "two", "characters"]
ADDED = ["<img>", "</img>", "<img_00000>", "<img_00001>"]
SIZE = 400


def _proto(pieces, *, model_type=2, byte_fallback=True, name="identity", charsmap=b"",
           dummy_prefix=True, remove_extra=False, suffix=False, pad_id=-1):
    m = pb.ModelProto()
    for piece, score, kind in pieces:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    t = m.trainer_spec
    t.model_type, t.byte_fallback, t.treat_whitespace_as_suffix = model_type, byte_fallback, suffix
    t.unk_id, t.bos_id, t.eos_id, t.pad_id = 0, 1, 2, pad_id
    n = m.normalizer_spec
    n.name, n.precompiled_charsmap = name, charsmap
    n.add_dummy_prefix, n.remove_extra_whitespaces, n.escape_whitespaces = (
        dummy_prefix, remove_extra, True)
    return m


@functools.cache
def _pieces(seed=0, size=SIZE):
    return tuple(chip_smoke.llama_pieces(WORDS, size=size, seed=seed))


def _typed(pieces, **types):
    """``pieces`` with the named ones given another type."""
    return [(p, s, types.get(p, k)) for p, s, k in pieces]


class _ProtoExtractor:
    """``LlamaConverter``'s extractor without sentencepiece: the vocabulary
    from the proto, the merges from ``generate_merges``."""

    def __init__(self, path):
        m = pb.ModelProto()
        with open(path, "rb") as f:
            m.ParseFromString(f.read())
        self.vocab = {p.piece: i for i, p in enumerate(m.pieces)}

    def extract(self, vocab_scores=None):
        return self.vocab, generate_merges(self.vocab, vocab_scores)


class _SlowStandIn:
    """What ``LlamaConverter`` reads of the slow tokenizer it converts."""

    def __init__(self, path, legacy):
        m = pb.ModelProto()
        with open(path, "rb") as f:
            m.ParseFromString(f.read())
        self.vocab_file, self.legacy, self.add_prefix_space = path, legacy, True
        self.unk_token = "<unk>"
        self._pieces = [p.piece for p in m.pieces]

    def convert_ids_to_tokens(self, i):
        return self._pieces[i]

    def convert_tokens_to_ids(self, token):
        return self._pieces.index(token)


class _Converter(LlamaConverter):
    SpmExtractor = _ProtoExtractor


def _fast(model_path, legacy, added=ADDED):
    backend = _Converter(_SlowStandIn(os.fspath(model_path), legacy)).converted()
    fast = transformers.LlamaTokenizerFast(tokenizer_object=backend, legacy=legacy,
                                           bos_token="<s>", eos_token="</s>",
                                           unk_token="<unk>")
    fast.add_tokens([tokenizers.AddedToken(t, normalized=False) for t in added])
    return fast


def _write_dir(root, legacy, added=ADDED, pieces=None):
    """A SEED-X-layout tokenizer directory (``tokenizer.model``,
    ``added_tokens.json``, ``special_tokens_map.json``,
    ``tokenizer_config.json``) plus the fast tokenizer's ``tokenizer.json``,
    which ``LlamaTokenizerFast.from_pretrained`` reads."""
    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    pieces = _pieces() if pieces is None else pieces
    with open(os.path.join(root, "tokenizer.model"), "wb") as f:
        f.write(_proto(pieces).SerializeToString())
    special = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>")
    files = {"added_tokens.json": {t: len(pieces) + i for i, t in enumerate(added)},
             "special_tokens_map.json": special,
             "tokenizer_config.json": dict(special, legacy=legacy)}
    for name, content in files.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(content, f)
    _fast(os.path.join(root, "tokenizer.model"), legacy, added).backend_tokenizer.save(
        os.path.join(root, "tokenizer.json"))
    return root


@functools.cache
def _pair(tmp_root, legacy):
    """(the port's tokenizer, the fast reference) over one directory."""
    root = _write_dir(os.path.join(tmp_root, f"legacy_{legacy}"), legacy)
    return LlamaTokenizer.from_pretrained(root), _fast(os.path.join(root, "tokenizer.model"),
                                                       legacy)


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return os.fspath(tmp_path_factory.mktemp("llama_tok"))


# ---------------------------------------------------------------------------
# the reader against protobuf
# ---------------------------------------------------------------------------
def _as_read(m):
    return SentencePieceModel(
        pieces=tuple((p.piece, p.score, p.type) for p in m.pieces),
        model_type=m.trainer_spec.model_type, byte_fallback=m.trainer_spec.byte_fallback,
        unk_id=m.trainer_spec.unk_id, bos_id=m.trainer_spec.bos_id,
        eos_id=m.trainer_spec.eos_id, pad_id=m.trainer_spec.pad_id,
        treat_whitespace_as_suffix=m.trainer_spec.treat_whitespace_as_suffix,
        normalizer_name=m.normalizer_spec.name,
        precompiled_charsmap=m.normalizer_spec.precompiled_charsmap,
        add_dummy_prefix=m.normalizer_spec.add_dummy_prefix,
        remove_extra_whitespaces=m.normalizer_spec.remove_extra_whitespaces,
        escape_whitespaces=m.normalizer_spec.escape_whitespaces)


def _every_field():
    """Every field the reader takes away from its default, beside fields it
    skips (trainer strings, floats and repeated fields, the self-test data,
    the denormalizer) and pieces of every type with fractional scores."""
    rng = np.random.default_rng(3)
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("<pad>", 0.0, CONTROL),
              ("<sep>", 0.0, USER_DEFINED), ("▁old", -1.5, UNUSED), ("<0x41>", 0.0, BYTE)]
    pieces += [(f"▁w{k}日", float(rng.normal()), NORMAL) for k in range(40)]
    m = _proto(pieces, model_type=1, byte_fallback=False, name="nmt_nfkc",
               charsmap=bytes(rng.integers(0, 256, 300, np.uint8)), dummy_prefix=False,
               remove_extra=True, suffix=True, pad_id=3)
    m.pieces[7].ClearField("type")                  # NORMAL by default
    m.pieces[8].ClearField("score")
    t = m.trainer_spec
    t.input.extend(["a.txt", "b.txt"])
    t.vocab_size, t.character_coverage, t.unk_surface = 46, 0.9995, " ?? "
    t.max_sentencepiece_length, t.split_by_whitespace = 8, False
    t.user_defined_symbols.append("<sep>")
    m.normalizer_spec.escape_whitespaces = False
    m.self_test_data.samples.add(input="ab", expected="▁a b")
    m.denormalizer_spec.name = "identity"
    return m


@pytest.mark.parametrize("make", [
    lambda: pb.ModelProto(),                         # every default
    lambda: _proto(_pieces()),                        # LLaMA's layout
    _every_field,
], ids=["defaults", "llama", "every_field"])
def test_reader_matches_protobuf(make):
    m = make()
    data = m.SerializeToString()
    parsed = pb.ModelProto()
    parsed.ParseFromString(data)
    assert parse_sentencepiece_model(data) == _as_read(parsed)


def test_reader_merges_repeated_messages_as_protobuf_does():
    """A message field seen twice is merged and a scalar keeps its last
    value: two serialized protos concatenated parse as protobuf's
    ``MergeFromString``."""
    a = _proto(_pieces()[:300])
    b = pb.ModelProto()
    b.trainer_spec.pad_id = 0
    b.normalizer_spec.add_dummy_prefix = False
    data = a.SerializeToString() + b.SerializeToString()
    parsed = pb.ModelProto()
    parsed.ParseFromString(data)
    got = parse_sentencepiece_model(data)
    assert got == _as_read(parsed)
    assert (got.pad_id, got.add_dummy_prefix, got.byte_fallback) == (0, False, True)


@pytest.mark.parametrize("change,match", [
    (dict(model_type=1), "UNIGRAM"),
    (dict(name="nmt_nfkc", charsmap=b"\x01\x02\x03"), "nmt_nfkc"),
    (dict(suffix=True), "treat_whitespace_as_suffix"),
], ids=["unigram", "charsmap", "suffix"])
def test_reader_refuses_what_is_not_implemented(tmp_path, change, match):
    path = tmp_path / "tokenizer.model"
    path.write_bytes(_proto(_pieces(), **change).SerializeToString())
    with pytest.raises(ValueError, match=match):
        read_sentencepiece_model(os.fspath(path))
    with pytest.raises(ValueError, match=match):
        LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    with pytest.raises(ValueError, match=match):        # before the CLI loads anything
        tcli.main(["--device", "cpu", "--mllm-tokenizer", os.fspath(tmp_path)])


def test_from_pretrained_needs_the_model_file(tmp_path):
    (tmp_path / "added_tokens.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        tcli.mllm_spec_from_tokenizer(os.fspath(tmp_path))
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        tcli.main(["--device", "cpu", "--mllm-tokenizer", os.fspath(tmp_path)])


# ---------------------------------------------------------------------------
# encode against LlamaTokenizerFast
# ---------------------------------------------------------------------------
TEXTS = ["the girl", "a man in the rain", "characters", "The Rain, Man!", "the  girl",
         "a   man    in", "  lead", "lead  ", " the man ", "\n", "the\nrain\n", "tab\tthe",
         "日本語", "漫画の少女 the", "😀 a girl 👍", "", " ", "   ", "▁x", "a▁b", "x▁",
         "<s>", "</s>", "<unk>", *ADDED]


def _fast_differs(text, legacy):
    """Where ``LlamaTokenizerFast`` has rules of its own (module docstring)."""
    return not legacy and (text.startswith((" ", "▁")) or text in ADDED)


@pytest.mark.parametrize("legacy,text", [(legacy, t) for legacy in (True, False)
                                         for t in TEXTS if not _fast_differs(t, legacy)])
def test_encode_matches_the_fast_tokenizer(tmp_root, legacy, text):
    tok, fast = _pair(tmp_root, legacy)
    for special in (False, True):
        assert tok.encode(text, add_special_tokens=special) == fast.encode(
            text, add_special_tokens=special), (text, fast.tokenize(text), tok.tokenize(text))


def test_a_llama_vocabulary_encodes_as_llama_does(tmp_root):
    """The byte pieces and the layout give LLaMA's known ids: ``"\\n"`` is
    ``▁`` then ``<0x0A>`` (id 13), bos is 1, and no pad token is set."""
    for legacy in (True, False):
        tok, _ = _pair(tmp_root, legacy)
        assert tok.tokenize("\n") == ["▁", "<0x0A>"]
        assert tok.encode("\n", add_special_tokens=False)[1] == 13
        assert (tok.bos_token_id, tok.eos_token_id, tok.pad_token_id) == (1, 2, None)
        assert tok.encode("the", add_special_tokens=True)[0] == 1


# pieces written out from the slow tokenizer's source on this vocabulary,
# whose whole words and ``▁▁`` outscore every other join
SLOW_CASES = [
    # legacy: each chunk between added tokens is encoded alone, dummy prefix and all
    (True, "a <img> the", ["▁a", "▁", "<img>", "▁", "▁the"]),
    (True, "the<img_00001> man", ["▁the", "<img_00001>", "▁", "▁man"]),
    # legacy false: ▁ once in front of the text, none after an added token; a
    # chunk that starts with a space is encoded behind "<unk>", dropped again
    (False, "a <img> the", ["▁a", "▁", "<img>", "▁the"]),
    (False, "the<img_00001> man", ["▁the", "<img_00001>", "▁man"]),
    (False, "<img>", ["▁", "<img>"]),
    (False, "</img>", ["▁", "</img>"]),
    (False, "<img_00000>", ["▁", "<img_00000>"]),
    (False, "  lead", ["▁▁", "▁lead"]),
    (False, " ", ["▁▁"]),
    (False, "▁the", ["▁", "▁the"]),
    (False, " the man ", ["▁", "▁the", "▁man", "▁"]),
]


@pytest.mark.parametrize("legacy,text,pieces", SLOW_CASES)
def test_encode_matches_the_slow_tokenizer(tmp_root, legacy, text, pieces):
    tok, _ = _pair(tmp_root, legacy)
    assert tok.tokenize(text) == pieces
    assert tok.encode(text, add_special_tokens=False) == [
        tok.convert_tokens_to_ids(p) for p in pieces]


HYPOTHESIS_ALPHABET = "thegirlmanrd▁ \n,.!Z日😀"


@pytest.mark.parametrize("legacy", [True, False])
@settings(max_examples=150, deadline=None)
@given(text=st.text(alphabet=HYPOTHESIS_ALPHABET, max_size=40))
def test_encode_property(tmp_root, legacy, text):
    assume(not _fast_differs(text, legacy))
    tok, fast = _pair(tmp_root, legacy)
    assert tok.encode(text, add_special_tokens=False) == fast.encode(
        text, add_special_tokens=False)


# ---------------------------------------------------------------------------
# the model's corners sentencepiece has and LLaMA's model does not use
# ---------------------------------------------------------------------------
def test_user_defined_pieces_are_matched_whole(tmp_path):
    pieces = list(_pieces()) + [("<sep>", 0.0, USER_DEFINED)]
    (tmp_path / "tokenizer.model").write_bytes(_proto(pieces).SerializeToString())
    tok = LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    assert tok.tokenize("the<sep> the") == ["▁the", "<sep>", "▁the"]
    assert tok.encode("the<sep>", add_special_tokens=False)[1] == len(pieces) - 1


def test_unused_pieces_are_merged_then_split_back(tmp_path):
    """sentencepiece's BPE merges into an UNUSED piece (a vocabulary
    restriction) and splits what is left of it back into the pair it came
    from: ``▁gir`` still leads to ``▁girl``, and alone it is ``▁gi r``."""
    (tmp_path / "tokenizer.model").write_bytes(
        _proto(_typed(_pieces(), **{"▁gir": UNUSED})).SerializeToString())
    tok = LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    assert tok.tokenize("girl gir") == ["▁girl", "▁gi", "r"]


def test_without_byte_fallback_an_unknown_character_is_unk(tmp_path):
    pieces = [p for p in _pieces() if p[2] != BYTE]
    (tmp_path / "tokenizer.model").write_bytes(
        _proto(pieces, byte_fallback=False).SerializeToString())
    tok = LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    ids = tok.encode("the 日本", add_special_tokens=False)
    assert ids[0] == tok.convert_tokens_to_ids("▁the") and ids[-2:] == [0, 0]


def test_normalizer_flags(tmp_path):
    """``remove_extra_whitespaces`` drops leading and trailing spaces and
    joins runs; without the dummy prefix no ``▁`` goes in front."""
    (tmp_path / "tokenizer.model").write_bytes(
        _proto(_pieces(), remove_extra=True).SerializeToString())
    tok = LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    assert tok.tokenize("   the    girl  ") == ["▁the", "▁girl"]
    assert tok.tokenize("   ") == []
    (tmp_path / "tokenizer.model").write_bytes(
        _proto(_pieces(), dummy_prefix=False).SerializeToString())
    tok = LlamaTokenizer.from_pretrained(os.fspath(tmp_path))
    assert tok.tokenize("the girl")[:2] != ["▁the", "▁girl"]
    assert tok.tokenize(" the girl") == ["▁the", "▁girl"]


def test_config_files_set_the_special_tokens_and_strip_flags(tmp_path):
    """``tokenizer_config.json``'s ``added_tokens_decoder`` (with ``lstrip``
    and ``rstrip``: the whitespace beside the token goes, as
    ``PreTrainedTokenizer.tokenize`` strips it) and special tokens, and
    ``special_tokens_map.json`` over them."""
    root = _write_dir(tmp_path, True)
    n = len(_pieces())
    cfg = dict(legacy=True, pad_token="<unk>", bos_token="</s>",
               added_tokens_decoder={str(n): dict(content="<img>", lstrip=True, rstrip=True,
                                                  normalized=False, special=False)})
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    tok = LlamaTokenizer.from_pretrained(root)
    assert tok.tokenize("a <img> the") == ["▁a", "<img>", "▁the"]
    assert tok.tokenize("a </img> the") == ["▁a", "▁", "</img>", "▁", "▁the"]
    # special_tokens_map.json names <s>; the config's </s> gives way
    assert (tok.bos_token_id, tok.eos_token_id, tok.pad_token_id) == (1, 2, 0)
    assert tok.encode("the") == [1, tok.convert_tokens_to_ids("▁the")]
    # legacy false puts ▁ in front of the text unless add_prefix_space is false
    for prefix, pieces in ((True, ["▁", "▁the", "▁girl"]), (False, ["▁the", "▁girl"])):
        cfg = dict(legacy=False, add_prefix_space=prefix)
        (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
        assert LlamaTokenizer.from_pretrained(root).tokenize(" the girl") == pieces


# ---------------------------------------------------------------------------
# mllm_spec_from_tokenizer against the JAX function
# ---------------------------------------------------------------------------
def _fields(spec, texts):
    return dict(bos=spec.bos_id, eos=spec.eos_id, pad=spec.pad_id, boi=spec.boi_id,
                eoi=spec.eoi_id, img=[int(i) for i in spec.img_ids],
                text={t: list(spec.encode_text(t)) for t in texts})


@pytest.mark.parametrize("legacy", [True, False])
def test_spec_matches_jax(tmp_path, monkeypatch, legacy):
    """The JAX ``mllm_spec_from_tokenizer`` runs unchanged, with
    ``transformers.LlamaTokenizer`` (it needs ``sentencepiece``) bound to
    ``LlamaTokenizerFast`` over the same directory: only that dependency is
    replaced, as a Pallas kernel runs in interpret mode."""
    added = ["<img>", "</img>"] + [f"<img_{k:05d}>" for k in range(64)]
    root = _write_dir(tmp_path, legacy, added)
    monkeypatch.setattr(transformers, "LlamaTokenizer", transformers.LlamaTokenizerFast,
                        raising=False)
    texts = [t for t in TEXTS if not _fast_differs(t, legacy)]
    want = _fields(jcli.mllm_spec_from_tokenizer(root), texts)
    got = _fields(tcli.mllm_spec_from_tokenizer(root), texts)
    assert got == want
    assert (got["boi"], got["eoi"], got["img"]) == (SIZE, SIZE + 1,
                                                    list(range(SIZE + 2, SIZE + 66)))


def test_server_with_the_spec_from_files_matches_jax(tmp_path, monkeypatch):
    """``tests/test_torch_port_mllm.py::test_server_with_agent_matches_jax``
    with the token spec read from a tokenizer directory by each package's
    ``mllm_spec_from_tokenizer`` (8 image ids: the tiny agent's input
    resampler; 400 pieces and 10 added tokens within its vocabulary of
    512): the prompt ids that reach ``generate`` are the tokenizer's, and
    the panel is JAX's within 5e-4."""
    jpipe, tpipe = tiny_pipelines()
    manga = tpipe.m.manga
    iv, cross = manga.num_ip_tokens, tpipe.m.unet.config.cross_attention_dim
    llm = LlamaConfig.tiny()
    cfg = AgentConfig(
        llm=llm,
        input_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                            embed_dim=llm.hidden_size, num_heads=4,
                                            kv_dim=cross),
        output_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                             embed_dim=cross, num_heads=4,
                                             kv_dim=llm.hidden_size))
    jagent, tagent = agents(cfg, seed=6)
    added = ["<img>", "</img>"] + [f"<img_{k:05d}>" for k in range(iv)]
    assert SIZE + len(added) <= llm.vocab_size
    root = _write_dir(tmp_path, False, added)
    monkeypatch.setattr(transformers, "LlamaTokenizer", transformers.LlamaTokenizerFast,
                        raising=False)
    jspec = jcli.mllm_spec_from_tokenizer(root, num_img_tokens=iv)
    tspec = tcli.mllm_spec_from_tokenizer(root, num_img_tokens=iv)
    prompt = "two characters in the rain"

    def request(api):
        rng = np.random.default_rng(10)
        mk = lambda: rng.integers(1, 255, (1, 77)).astype(np.int32)
        chars = [Image.fromarray((rng.random((70, 50, 3)) * 255).astype(np.uint8))]
        return api.GenerationRequest(
            prompt=prompt, height=128, width=128, num_inference_steps=2,
            seed=4, character_images=chars, ip_bbox=[[0.0, 0.0, 0.5, 1.0]],
            dialog_bbox=[[0.1, 0.05, 0.6, 0.3]], mllm_scale=0.4,
            prompt_ids=dict(ids=mk(), neg_ids=mk(), ids_2=mk(), neg_ids_2=mk()))

    kw = dict(mllm_max_new_tokens=iv + 4)
    want = japi.DiffSenseiServer(jpipe, agent=jagent, mllm_spec=jspec, **kw).generate(
        request(japi))
    server = tapi.DiffSenseiServer(tpipe, agent=tagent, mllm_spec=tspec, **kw)
    lat0 = np.array(jax.random.normal(jax.random.key(4), (1, 32, 32, 4), jnp.float32))
    monkeypatch.setattr(server, "initial_latents", lambda seed, shape: torch.from_numpy(lat0))
    seen = []
    monkeypatch.setattr(tagent, "generate", lambda ids, *a, f=tagent.generate, **k:
                        seen.append(np.asarray(ids)) or f(ids, *a, **k))
    got = server.generate(request(tapi))
    tok = LlamaTokenizer.from_pretrained(root)
    ids = tdata.build_inference_prompt(tok.encode(prompt, add_special_tokens=False), tspec,
                                       tok.encode("\n", add_special_tokens=False))["input_ids"]
    jids = jdata.build_inference_prompt(jspec.encode_text(prompt), jspec,
                                        jspec.encode_text("\n"))["input_ids"]
    assert len(seen) == 1 and np.array_equal(seen[0], ids) and np.array_equal(ids, jids)
    assert got.shape == want.shape == (1, 256, 256, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


# ---------------------------------------------------------------------------
# the smoke's full-width tokenizer
# ---------------------------------------------------------------------------
def test_the_smokes_tokenizer_files(tmp_path):
    """``chip_smoke.write_llama_tokenizer`` at full width (32,000 pieces,
    SEED-X's 330 added tokens): its hand-written ``tokenizer.model`` parses
    with protobuf into the same fields; the spec puts ``<img>`` at 32000 and
    the ladder after it; the agent_cli prompt encodes to its whole words,
    as the fast tokenizer over the same files encodes it."""
    pieces = chip_smoke.llama_pieces()
    root = chip_smoke.write_llama_tokenizer(tmp_path, pieces)
    data = (root / "tokenizer.model").read_bytes()
    parsed = pb.ModelProto()
    parsed.ParseFromString(data)
    model = parse_sentencepiece_model(data)
    assert model == _as_read(parsed) == dataclasses.replace(
        SentencePieceModel(), pieces=tuple(pieces), model_type=2, byte_fallback=True,
        normalizer_name="identity", remove_extra_whitespaces=False)
    assert len(pieces) == 32000 and len(chip_smoke.SEED_X_ADDED) == 330
    spec = tcli.mllm_spec_from_tokenizer(os.fspath(root))
    assert (spec.bos_id, spec.eos_id, spec.pad_id, spec.boi_id, spec.eoi_id) == (
        1, 2, 0, 32000, 32001)
    assert list(spec.img_ids) == list(range(32002, 32066))
    ids = {p: i for i, (p, _, _) in enumerate(pieces)}
    words = chip_smoke.AGENT_CLI_PROMPT.replace(",", " ,").split()
    caption = spec.encode_text(chip_smoke.AGENT_CLI_PROMPT)
    assert caption == [ids[w if w == "," else "▁" + w] for w in words]
    fast = _fast(root / "tokenizer.model", False, chip_smoke.SEED_X_ADDED)
    assert caption == fast.encode(chip_smoke.AGENT_CLI_PROMPT, add_special_tokens=False)
    assert spec.encode_text("\n") == fast.encode("\n", add_special_tokens=False) == [
        ids["▁"], 13]
