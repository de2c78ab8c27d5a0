"""Native C++ tier tests: tokenizer parity vs the pure-Python reference
implementation, weight-loader cast/transpose exactness vs numpy, and
safetensors round-trips through the native reader.

Mirrors the reference's per-component unit-test strategy
(tests/unit_tests/, SURVEY.md §4) for the components the reference
implemented in host C++: the tokenizer (src/models/tokenizer.h) and the
weight loader (src/utils/weight_utils.cu).
"""

import json
import random
import struct

import numpy as np
import pytest

from llm_inference_engine.native import native_available


pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable (no g++)")


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def _toy_pieces():
    pieces = {}
    tid = 0
    for sp in ("<unk>", "<s>", "</s>"):
        pieces[sp] = (tid, 0.0)
        tid += 1
    for b in range(256):
        pieces[f"<0x{b:02X}>"] = (tid, -1e9)
        tid += 1
    score = -1.0
    for c in "abcdefghijklmnopqrstuvwxyz":
        pieces[c] = (tid, score)
        tid += 1
        score -= 0.01
    pieces["▁"] = (tid, -0.5)
    tid += 1
    for m in ("▁t", "th", "he", "▁the", "ab", "abc", "cd", "abcd",
              "ell", "llo", "hello", "▁hello", "▁a", "▁ab", "<n>",
              "<|tab|>", "<|blank_3|>"):
        pieces[m] = (tid, score)
        tid += 1
        score -= 0.05
    return pieces


@pytest.fixture(scope="module")
def tok_pair():
    from llm_inference_engine.tokenizer.bpe import BPETokenizer
    from llm_inference_engine.tokenizer.native import (
        NativeBPETokenizer, wrap_native)
    py = BPETokenizer(_toy_pieces())
    nat = wrap_native(py)
    assert isinstance(nat, NativeBPETokenizer)
    return py, nat


def test_tokenizer_encode_parity(tok_pair):
    py, nat = tok_pair
    rng = random.Random(0)
    cases = ["hello the abcd", "the cat", "", " ", "  double", "abcabcabc",
             "héllo wörld 你好", "a" * 80, "the the the", "\n\ttabs",
             "▁pre", "ends with space "]
    for _ in range(300):
        n = rng.randint(0, 40)
        cases.append("".join(
            rng.choice("abcdefghij xyz▁é你\n\t") for _ in range(n)))
    for text in cases:
        assert py.encode(text) == nat.encode(text), repr(text)
        assert (py.encode(text, add_bos=False, add_eos=True)
                == nat.encode(text, add_bos=False, add_eos=True)), repr(text)


def test_tokenizer_decode_parity(tok_pair):
    py, nat = tok_pair
    rng = random.Random(1)
    all_ids = sorted(py.id_to_piece)
    for _ in range(200):
        ids = [rng.choice(all_ids) for _ in range(rng.randint(0, 30))]
        assert py.decode(ids) == nat.decode(ids), ids


def test_tokenizer_roundtrip(tok_pair):
    _, nat = tok_pair
    for text in ("hello the abcd", "héllo 你好", "a  b   c"):
        ids = nat.encode(text, add_bos=False)
        assert nat.decode(ids) == text


def test_tokenizer_byte_fallback(tok_pair):
    py, nat = tok_pair
    # characters with no vocab piece fall back to <0xAB> byte tokens
    text = "q\x01\x7f"
    e_py, e_nat = py.encode(text), nat.encode(text)
    assert e_py == e_nat
    assert any(py.id_to_piece[t].startswith("<0x") for t in e_py)


# ---------------------------------------------------------------------------
# weight loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ("float16", "float32"), ("bfloat16", "float32"),
    ("float32", "float16"), ("float32", "bfloat16"),
    ("float32", "float32"),
])
def test_cast_exact(src, dst):
    import ml_dtypes
    from llm_inference_engine.runtime.native_io import cast_array
    dt = {"bfloat16": ml_dtypes.bfloat16}.get(src, src)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000).astype(np.float32) * 100
    x = x.astype(dt)
    want_dt = {"bfloat16": ml_dtypes.bfloat16}.get(dst, dst)
    got = cast_array(x, want_dt)
    want = x.astype(want_dt)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_cast_specials():
    from llm_inference_engine.runtime.native_io import cast_array
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 6e-8,
                  -6e-8, 1e-45], np.float32)
    got = cast_array(x.astype(np.float16), np.float32)
    want = x.astype(np.float16).astype(np.float32)
    assert np.array_equal(got, want, equal_nan=True)
    got16 = cast_array(x, np.float16)
    assert np.array_equal(got16, x.astype(np.float16), equal_nan=True)


@pytest.mark.parametrize("shape", [(3, 5), (64, 64), (130, 70), (1, 257)])
def test_transpose_cast(shape):
    import ml_dtypes
    from llm_inference_engine.runtime.native_io import transpose_cast
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float16)
    got = transpose_cast(x, np.float32)
    assert got.shape == shape[::-1]
    assert np.array_equal(got, x.T.astype(np.float32))
    got_bf = transpose_cast(x.astype(ml_dtypes.bfloat16), np.float32)
    assert np.array_equal(
        got_bf, x.astype(ml_dtypes.bfloat16).T.astype(np.float32))


def _write_safetensors(path, tensors):
    header = {}
    blobs = []
    off = 0
    codes = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}
    for name, arr in tensors.items():
        b = arr.tobytes()
        header[name] = {"dtype": codes[arr.dtype.name],
                        "shape": list(arr.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for b in blobs:
            f.write(b)


def test_safetensors_native_reader(tmp_path):
    import ml_dtypes
    from llm_inference_engine.runtime.native_io import SafeTensorsFile
    rng = np.random.default_rng(2)
    tensors = {
        "a": rng.standard_normal((17, 33)).astype(np.float16),
        "b": rng.standard_normal((8,)).astype(np.float32),
        "c": rng.standard_normal((5, 6)).astype(ml_dtypes.bfloat16),
    }
    p = tmp_path / "model.safetensors"
    _write_safetensors(str(p), tensors)

    sf = SafeTensorsFile(str(p))
    assert sf.names == set(tensors)
    for name, arr in tensors.items():
        got = sf.get(name)
        assert got.dtype == arr.dtype and np.array_equal(got, arr)
    # fused transpose+cast read
    at = sf.get("a", dtype=np.float32, transpose=True)
    assert np.array_equal(at, tensors["a"].T.astype(np.float32))


def test_read_bin_tensor(tmp_path):
    from llm_inference_engine.runtime.native_io import read_bin_tensor
    rng = np.random.default_rng(3)
    x = rng.standard_normal((11, 13)).astype(np.float32)
    p = tmp_path / "t.bin"
    x.tofile(str(p))
    got = read_bin_tensor(str(p), (11, 13), "float32")
    assert np.array_equal(got, x)
    got16 = read_bin_tensor(str(p), (11, 13), "float32", np.float16)
    assert np.array_equal(got16, x.astype(np.float16))
