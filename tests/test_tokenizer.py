"""Unit tests: BPE tokenizer (merging, byte fallback, specials, formats).

The reference has no tokenizer tests; these assert the behaviors its
Tokenizer implements (tokenizer.h:168-347).
"""

import struct

import pytest

from llm_inference_engine.tokenizer.bpe import (
    BPETokenizer, _load_flm_binary, _load_sentencepiece_model)


def make_toy_tokenizer():
    """Small scored vocab: chars + some merges + byte pieces."""
    pieces = {}
    tid = 0
    for sp in ("<unk>", "<s>", "</s>"):
        pieces[sp] = (tid, 0.0)
        tid += 1
    for b in range(256):
        pieces[f"<0x{b:02X}>"] = (tid, -1000.0)
        tid += 1
    for c in "abcdehlor▁ ":
        pieces[c] = (tid, -100.0)
        tid += 1
    # merges with scores: higher merges first
    for piece, score in [("he", -1.0), ("ll", -2.0), ("llo", -1.5),
                         ("hello", -0.5), ("▁hello", -0.2), ("▁a", -3.0)]:
        pieces[piece] = (tid, score)
        tid += 1
    return BPETokenizer(pieces, bos_id=1, eos_id=2, unk_id=0)


def test_merge_order_produces_best_piece():
    tok = make_toy_tokenizer()
    ids = tok.encode("hello", add_bos=False)
    assert [tok.id_to_piece[i] for i in ids] == ["▁hello"]


def test_bos_eos():
    tok = make_toy_tokenizer()
    ids = tok.encode("a", add_bos=True, add_eos=True)
    assert ids[0] == 1 and ids[-1] == 2


def test_byte_fallback_roundtrip():
    tok = make_toy_tokenizer()
    text = "héllo ☃"          # é and ☃ are not in the vocab -> byte pieces
    ids = tok.encode(text, add_bos=False)
    assert tok.decode(ids) == text


def test_space_handling_roundtrip():
    tok = make_toy_tokenizer()
    for text in ("hello", "a b c", "hello hello"):
        assert tok.decode(tok.encode(text, add_bos=False)) == text


def test_decode_specials():
    pieces = {"<n>": (0, 0.0), "<|tab|>": (1, 0.0), "<|blank_4|>": (2, 0.0),
              "x": (3, 0.0)}
    tok = BPETokenizer(pieces, bos_id=None, eos_id=None,
                       add_leading_blank=False)
    assert tok.decode([3, 0, 1, 2, 3]) == "x\n\t    x"


def test_incremental_decode_matches_full():
    tok = make_toy_tokenizer()
    ids = tok.encode("hello a hello", add_bos=False)
    full = tok.decode(ids)
    acc = ""
    for i in range(len(ids)):
        acc += tok.decode_incremental(ids[:i], ids[i])
    assert acc == full


def test_flm_binary_format(tmp_path):
    """Write the reference's binary vocab layout and load it
    (tokenizer.h:138-167)."""
    entries = [("a", 5, -1.0), ("b", 6, -2.0), ("ab", 7, -0.5)]
    p = tmp_path / "tok.bin"
    with open(p, "wb") as f:
        f.write(struct.pack("<i", 1))            # version
        f.write(struct.pack("<i", 1))            # kv table: 1 entry
        for s in ("tokenizer_use_score", "1"):
            f.write(struct.pack("<i", len(s)))
            f.write(s.encode())
        f.write(struct.pack("<i", len(entries)))
        for piece, tid, score in entries:
            f.write(struct.pack("<i", len(piece)))
            for ch in piece.encode():
                f.write(struct.pack("<i", ch))
            f.write(struct.pack("<i", tid))
            f.write(struct.pack("<f", score))
    tok = _load_flm_binary(str(p))
    assert tok.piece_to_id == {"a": 5, "b": 6, "ab": 7}
    assert tok.piece_score["ab"] == -0.5


def test_sentencepiece_proto_format(tmp_path):
    """Hand-encode a minimal sentencepiece ModelProto and parse it."""

    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def piece_msg(piece, score):
        pb = piece.encode()
        body = (bytes([0x0A]) + varint(len(pb)) + pb          # field1 string
                + bytes([0x15]) + struct.pack("<f", score))   # field2 float
        return bytes([0x0A]) + varint(len(body)) + body       # outer field1

    blob = b"".join(piece_msg(p, s) for p, s in
                    [("<unk>", 0.0), ("<s>", 0.0), ("</s>", 0.0),
                     ("▁", -3.0), ("h", -5.0), ("i", -6.0), ("hi", -1.0)])
    p = tmp_path / "tokenizer.model"
    p.write_bytes(blob)
    tok = _load_sentencepiece_model(str(p))
    assert tok.piece_to_id["hi"] == 6
    ids = tok.encode("hi", add_bos=False)
    assert [tok.id_to_piece[i] for i in ids] == ["▁", "hi"]
