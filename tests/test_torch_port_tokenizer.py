"""The port's CLIP tokenizer against ``transformers.CLIPTokenizer`` (CPU), and
the SDXL dual prompt against the JAX pipeline.

The test writes its own CLIP vocabulary: the 256 byte symbols, their ``</w>``
forms, a few hundred merges learned from a small corpus, and the two
special tokens, as ``vocab.json`` / ``merges.txt``. The ids must equal
``CLIPTokenizer.from_pretrained(dir)``'s exactly (this container has no
``ftfy``, so HF takes its ``BasicTokenizer`` path, as the port does), with
CLIP-L's pad token and with SDXL's second tokenizer's ``!``.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from diffsensei_tpu_torch.utils.tokenizer import CLIPTokenizer, bytes_to_unicode

torch.set_num_threads(1)

CORPUS = ("a young girl with long black hair stands in the rain holding an umbrella "
          "two boys talk in a classroom while the teacher writes on the board "
          "manga panel speech bubble dramatic lighting close up of a face "
          "the old man laughs loudly at the market street night city lights "
          "samurai warrior draws his sword under cherry blossoms falling softly "
          "detective examines mysterious footprints beside the abandoned warehouse "
          "children running across bright summer fields chasing colorful butterflies "
          "robot pilot climbs into giant mechanical armor before the final battle "
          "quiet library afternoon sunlight through tall windows dust floating "
          "grandmother cooking dumplings kitchen steam rising family dinner together "
          "skateboarder jumps over railing crowd cheering concrete plaza graffiti walls "
          "wizard apprentice studies ancient spellbook candle flickering tower midnight "
          "ocean waves crashing against rocky cliffs lighthouse beam sweeping storm")

PROMPTS = [
    "A Young GIRL, with long black hair!",
    "two boys talk... (in a classroom) -- 3 times: 1024x1024 @ 7.5",
    "Café naïve résumé — ÉLAN; Ångström",
    "漫画のパネル 日本語 東京 and 中文 text",
    "  runs \t of\n\nwhitespace   everywhere 　 ideographic  ",
    "",
    "it's what they'll say, we've seen, I'm sure you'd",
    "emoji 😀 and symbols ①②③ ½ ² and <|endoftext|> inside",
    " ".join(["the old man laughs loudly at the market street"] * 12),  # > 77 tokens
    "no!!! way!? yes!",
]


def _learn_merges(corpus: str, n: int):
    """Byte-level BPE merges from ``corpus``: the most frequent adjacent pair
    first (ties by first occurrence), ``</w>`` on each word's last symbol."""
    enc = bytes_to_unicode()
    words = collections.Counter(corpus.split())
    seqs = {w: tuple("".join(enc[b] for b in w.encode())[:-1])
            + ("".join(enc[b] for b in w.encode())[-1] + "</w>",) for w in words}
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, seq in seqs.items():
            for p in zip(seq, seq[1:]):
                pairs[p] += words[w]
        if not pairs:
            break
        best = max(pairs, key=lambda p: pairs[p])
        merges.append(best)
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i < len(seq) - 1 and (seq[i], seq[i + 1]) == best:
                    out.append(seq[i] + seq[i + 1])
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = tuple(out)
    return merges


def write_clip_vocab(path, pad_token="<|endoftext|>", n_merges=300):
    """``chip_smoke.write_clip_vocab`` with ``n_merges`` merges learned from
    ``CORPUS``."""
    return chip_smoke.write_clip_vocab(path, _learn_merges(CORPUS, n_merges), pad_token)


@pytest.fixture(scope="module", params=["<|endoftext|>", "!"], ids=["clip_l_pad", "bang_pad"])
def vocab_dir(request, tmp_path_factory):
    return write_clip_vocab(tmp_path_factory.mktemp("tok"), pad_token=request.param)


def test_ids_equal_transformers_clip_tokenizer(vocab_dir):
    transformers = pytest.importorskip("transformers")
    hf = transformers.CLIPTokenizer.from_pretrained(str(vocab_dir))
    tok = CLIPTokenizer.from_pretrained(str(vocab_dir))
    assert tok.pad_token_id == hf.pad_token_id and tok.bos_token_id == hf.bos_token_id
    assert len(tok.bpe_ranks) >= 250
    for prompt in PROMPTS:
        want = hf(prompt, padding="max_length", max_length=77, truncation=True,
                  return_tensors="np")["input_ids"]
        got = tok(prompt, padding="max_length", max_length=77, truncation=True,
                  return_tensors="np")["input_ids"]
        assert want.shape == got.shape == (1, 77)
        assert np.array_equal(got, want), (prompt, got, want)
        assert np.array_equal(tok(prompt), want[0]) and tok(prompt).dtype == np.int32
    # the long prompt was cut to 75 tokens, and the short ones were padded
    assert tok(PROMPTS[8])[-1] == tok.eos_token_id
    empty = [tok.bos_token_id, tok.eos_token_id] + [tok.pad_token_id] * 75
    assert tok(PROMPTS[5]).tolist() == empty


def test_both_call_styles(vocab_dir):
    """``tok(text)`` (the datasets' call) and the HF-style call (the
    pipeline's) give the same ids; other HF options are refused."""
    tok = CLIPTokenizer.from_pretrained(str(vocab_dir))
    hf_style = tok("a young girl", padding="max_length", max_length=77, truncation=True,
                   return_tensors="np")["input_ids"]
    assert hf_style.shape == (1, 77) and np.array_equal(hf_style[0], tok("a young girl"))
    with pytest.raises(ValueError):
        tok("x", padding="longest", return_tensors="np")
    with pytest.raises(ValueError):
        tok("x", padding="max_length", truncation=True, return_tensors="pt")


# ---------------------------------------------------------------------------
# the SDXL dual prompt, through the tokenizers, against the JAX pipeline
# ---------------------------------------------------------------------------
def test_dual_prompt_matches_jax(tmp_path):
    """``encode_prompt(prompt_2=..., negative_prompt_2=...)`` through the
    port's tokenizers against the JAX pipeline with HF's (the JAX package's
    own tokenizer), within 5e-4; ``prompt_2=None`` equals
    ``prompt_2=prompt``."""
    transformers = pytest.importorskip("transformers")
    from tests.torch_port_util import tiny_pipelines

    jpipe, tpipe = tiny_pipelines(text_vocab=1024)   # room for this vocabulary's ids
    d1 = write_clip_vocab(tmp_path / "t1")
    d2 = write_clip_vocab(tmp_path / "t2", pad_token="!")
    jpipe.m.tokenizer = transformers.CLIPTokenizer.from_pretrained(str(d1))
    jpipe.m.tokenizer_2 = transformers.CLIPTokenizer.from_pretrained(str(d2))
    tpipe.m.tokenizer = CLIPTokenizer.from_pretrained(str(d1))
    tpipe.m.tokenizer_2 = CLIPTokenizer.from_pretrained(str(d2))
    assert max(tpipe.m.tokenizer.encoder.values()) < tpipe.m.text_encoder.config.vocab_size
    kw = dict(prompt_2="a manga panel of the old man, night city lights",
              negative_prompt_2="blurry!")
    want = jpipe.encode_prompt("a young girl stands in the rain", "low quality", **kw)
    with torch.no_grad():
        got = tpipe.encode_prompt("a young girl stands in the rain", "low quality", **kw)
        same = tpipe.encode_prompt("a young girl", "bad", prompt_2=None)
        explicit = tpipe.encode_prompt("a young girl", "bad", prompt_2="a young girl",
                                       negative_prompt_2="bad")
        other = tpipe.encode_prompt("a young girl", "bad", prompt_2="two boys")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(same, explicit))
    assert not torch.equal(same[1], other[1])
