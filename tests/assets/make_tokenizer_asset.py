"""Generate the pinned SentencePiece-format tokenizer test asset.

Produces (committed to tests/assets/, regenerate only deliberately):
- ``tiny_spm_bpe.model``   — a SentencePiece ModelProto binary: 3 specials,
  256 byte-fallback pieces, single-char pieces, and score-ordered BPE
  merge pieces, in the exact wire format a real ``.model`` uses (including
  a TrainerSpec submessage and unknown fields the reader must skip);
- ``tiny_spm_bpe.expected.json`` — pinned encodings of the test corpus.

Provenance: this environment ships neither the ``sentencepiece`` library
nor network access, so the binary is serialized by this script (the same
wire format the reader is tested against) rather than by Google's
trainer. Independence of the ground truth comes from HuggingFace
``tokenizers`` (a separate Rust BPE implementation): the script converts
the model to an HF BPE (vocab + all-splits merge list, the standard
spm->HF conversion) with a Metaspace(split=False) pre-tokenizer and
asserts both implementations produce IDENTICAL ids over the corpus
before writing anything. tests/test_tokenizer_assets.py re-runs that
cross-check at test time and additionally pins the C++ and flm loaders
to the committed expectations.

Reference contract: trie + score-ordered merges + byte fallback,
src/models/tokenizer.h:168-347.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE.parent.parent))

CORPUS = [
    "hello world",
    "the cat sat on the mat",
    "double  spaces  inside and trailing ",
    "héllo ☃ emoji 🎉 mix",
    "日本語のテキスト",
    "tabs\tand\nnewlines",
    "",
    "a",
    "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    "punctuation! (parens) [brackets] {braces} — dash",
    "the quick brown fox jumps over the lazy dog",
    "thinking about the weather, nothing else matters",
]
# strings where HF's Metaspace edge behavior differs from spm's
# add_dummy_prefix (empty input: spm still emits the dummy prefix, HF
# emits nothing) — excluded from the HF cross-check, still pinned via
# expected.json
HF_SKIP = {""}


def build_vocab():
    """(ordered pieces [(piece, score, type)]). Scores are all distinct so
    merge order is total (no tie-break ambiguity between implementations)."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    for b in range(256):
        pieces.append((f"<0x{b:02X}>", -1000.0, 6))
    chars = ("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
             "▁.,!?()[]{}'\"-:;/")
    for i, c in enumerate(chars):
        pieces.append((c, -500.0 - i, 1))
    # score-ordered merges (best first), shaped like a real English vocab
    merges = [
        "▁the", "the", "▁a", "▁of", "▁and", "and", "▁to", "in", "▁in",
        "er", "▁s", "on", "at", "en", "▁w", "or", "ou", "it", "is", "an",
        "th", "he", "es", "ing", "▁b", "▁c", "▁f", "▁m", "▁p", "▁h",
        "▁d", "▁l", "▁t", "ed", "ar", "al", "▁o", "ow", "▁n", "le",
        "▁e", "st", "▁g", "▁j", "▁q", "▁v", "▁k", "▁r", "▁u", "▁y",
        "ck", "ck▁"[:2], "ll", "llo", "hello", "▁hello", "wor", "world",
        "▁world", "ab", "about", "▁about", "ther", "▁wea", "weather",
        "▁weather", "cat", "▁cat", "sat", "▁sat", "mat", "▁mat",
        "▁on", "qu", "ick", "quick", "▁quick", "br", "own", "brown",
        "▁brown", "fox", "▁fox", "ju", "jum", "jump", "jumps", "▁jumps",
        "ov", "over", "▁over", "la", "lazy", "▁lazy", "do", "dog",
        "▁dog", "aa", "aaaa", "aaaaaaaa", "aaaaaaaaaaaaaaaa", "no",
        "not", "nothing", "▁nothing", "el", "else", "▁else", "ma",
        "matter", "matters", "▁matters", "thin", "think", "thinking",
        "▁thinking", "ta", "tab", "tabs", "new", "li", "line", "lines",
        "newlines", "mi", "mix", "▁mix", "em", "emo", "emoji", "▁emoji",
        "da", "dash", "▁dash", "pun", "punc", "punct", "punctu",
        "punctuation", "sp", "ace", "aces", "space", "spaces", "▁spaces",
        "dou", "double", "▁double", "ins", "insi", "inside", "▁inside",
        "tra", "trail", "trailing", "▁trailing",
    ]
    seen = {p for p, _, _ in pieces}
    score = -1.0
    for m in merges:
        if m in seen:
            continue
        seen.add(m)
        pieces.append((m, score, 1))
        score -= 0.0625
    return pieces


# --- ModelProto wire serialization (same subset a real .model uses) -------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        out += bytes([b7 | (0x80 if v else 0)])
        if not v:
            return out


def _piece_msg(piece: str, score: float, ptype: int) -> bytes:
    pb = piece.encode("utf-8")
    body = (bytes([0x0A]) + _varint(len(pb)) + pb
            + bytes([0x15]) + struct.pack("<f", score)
            + bytes([0x18]) + _varint(ptype))
    return bytes([0x0A]) + _varint(len(body)) + body


def serialize_model(pieces) -> bytes:
    blob = b"".join(_piece_msg(p, s, t) for p, s, t in pieces)
    # TrainerSpec submessage + unknown fields the reader must skip over
    sub = bytes([0x0A]) + _varint(9) + b"pinned-r4"
    blob += bytes([0x12]) + _varint(len(sub)) + sub
    blob += bytes([0x20]) + _varint(98765)
    blob += bytes([0x31]) + struct.pack("<q", -7)
    return blob


# --- HF tokenizers independent implementation -----------------------------

def build_hf(pieces):
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    scored = [(p, s) for p, s, t in pieces if t == 1 and len(p) > 1]
    scored.sort(key=lambda ps: -ps[1])      # best score = lowest merge rank
    merges = []
    for p, _ in scored:
        for cut in range(1, len(p)):        # all vocab splits of the piece:
            a, b = p[:cut], p[cut:]         # any path must yield the piece
            if a in vocab and b in vocab:
                merges.append((a, b))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges,
                               unk_token="<unk>", byte_fallback=True,
                               fuse_unk=False))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=False)
    return tok


def main():
    pieces = build_vocab()
    blob = serialize_model(pieces)
    model_path = HERE / "tiny_spm_bpe.model"
    model_path.write_bytes(blob)

    from llm_inference_engine.tokenizer.bpe import (
        _load_sentencepiece_model)
    tok = _load_sentencepiece_model(str(model_path))
    hf = build_hf(pieces)

    expected = {}
    for text in CORPUS:
        ids = tok.encode(text, add_bos=False)
        assert tok.decode(ids) == text, (text, ids)
        if text not in HF_SKIP:
            hf_ids = hf.encode(text).ids
            assert list(ids) == list(hf_ids), (
                f"HF tokenizers disagrees on {text!r}:\n"
                f"  ours: {[tok.id_to_piece[i] for i in ids]}\n"
                f"  hf:   {[hf.id_to_token(i) for i in hf_ids]}")
        expected[text] = list(map(int, ids))

    (HERE / "tiny_spm_bpe.expected.json").write_text(
        json.dumps(expected, ensure_ascii=False, indent=1))
    print(f"wrote {model_path.name} ({len(blob)} bytes), "
          f"{len(pieces)} pieces, {len(CORPUS)} pinned encodings; "
          "HF tokenizers cross-check PASSED")


if __name__ == "__main__":
    main()
