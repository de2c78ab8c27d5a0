"""Byte-level BPE tokenizer parity vs the `tokenizers` library.

Mirrors the reference's tokenizer test discipline (its trie/heap encoder
was the one component with real behavioral tests) for the second tokenizer
family: tiny byte-level BPE models are TRAINED here with the HF tokenizers
library, saved to tokenizer.json, loaded by our own implementation
(tokenizer/bytelevel.py), and must produce identical ids/text on
unicode/emoji/whitespace/code corpora — for both the plain ByteLevel
(GPT-2) and Split-regex (Llama3/Qwen2) pre-tokenizer flavors.
"""

import pytest

tokenizers = pytest.importorskip("tokenizers")

from llm_inference_engine.tokenizer import load_tokenizer
from llm_inference_engine.tokenizer.bytelevel import (
    ByteLevelBPETokenizer, is_bytelevel_tokenizer_json)

CORPUS = [
    "hello world, this is a test of the tokenizer",
    "The quick brown fox jumps over the lazy dog 1234567890 times!",
    "def f(x):\n    return x ** 2  # comment\n",
    "naïve café — résumé ünïcödé",
    "日本語のテキストと emoji 🙂🚀 mixed together",
    "tabs\tand\nnewlines\r\nand   multiple   spaces",
    "don't can't won't it's we're I'll they'd",
]

SAMPLES = CORPUS + [
    "",
    " ",
    "   leading and trailing   ",
    "a",
    "🙂",
    "x = {'k': [1, 2, 3]}  # 42%!",
    "ÿþý edge \x00 bytes",
]

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _train_gpt2_style(tmp_path):
    from tokenizers.implementations import (
        ByteLevelBPETokenizer as HFByteLevel)
    t = HFByteLevel()
    t.train_from_iterator(CORPUS, vocab_size=400, min_frequency=1,
                          special_tokens=["<|endoftext|>"])
    p = str(tmp_path / "gpt2_style.json")
    t.save(p)
    return p


def _train_llama3_style(tmp_path):
    from tokenizers import Regex, Tokenizer, decoders, models
    from tokenizers import pre_tokenizers as pt
    from tokenizers import trainers
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pt.Sequence([
        pt.Split(Regex(LLAMA3_PATTERN), behavior="isolated"),
        pt.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=400, min_frequency=1,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>"],
        initial_alphabet=pt.ByteLevel.alphabet()))
    p = str(tmp_path / "llama3_style.json")
    tok.save(p)
    return p


@pytest.fixture(scope="module", params=["gpt2", "llama3"])
def pair(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bl_tok")
    path = (_train_gpt2_style(tmp) if request.param == "gpt2"
            else _train_llama3_style(tmp))
    assert is_bytelevel_tokenizer_json(path)
    hf = tokenizers.Tokenizer.from_file(path)
    ours = ByteLevelBPETokenizer.from_tokenizer_json(path)
    return hf, ours


def test_encode_parity(pair):
    hf, ours = pair
    for s in SAMPLES:
        assert ours.encode(s) == hf.encode(
            s, add_special_tokens=False).ids, repr(s)


def test_decode_round_trip(pair):
    _, ours = pair
    for s in SAMPLES:
        assert ours.decode(ours.encode(s)) == s, repr(s)


def test_decode_parity(pair):
    hf, ours = pair
    for s in SAMPLES:
        ids = hf.encode(s, add_special_tokens=False).ids
        assert ours.decode(ids) == hf.decode(ids), repr(s)


def test_special_tokens_split_and_skip(pair):
    hf, ours = pair
    specials = [t for t in ours.added]
    if not specials:
        pytest.skip("no specials trained")
    sp = specials[0]
    text = f"hello {sp} world"
    ids = ours.encode(text)
    assert ours.added[sp] in ids
    assert ids == hf.encode(text, add_special_tokens=False).ids
    # decode drops specials (HF skip_special_tokens semantics)
    assert sp not in ours.decode(ids)


def test_incremental_stream_reassembles(pair):
    _, ours = pair
    for s in ("hello 🙂 world", "naïve café", "a\n b"):
        ids = ours.encode(s)
        text = "".join(ours.decode_incremental(ids[:i], ids[i])
                       for i in range(len(ids)))
        assert text == s, repr(s)


def test_loader_dispatches_to_our_implementation(tmp_path):
    path = _train_gpt2_style(tmp_path)
    tok = load_tokenizer(path)
    assert isinstance(tok, ByteLevelBPETokenizer)
    s = CORPUS[0]
    assert tok.decode(tok.encode(s)) == s
