"""Chat template tests (runtime/chat_template.py).

The reference concatenated raw history text (llama.cpp:137-155); real chat
checkpoints need their training template. Invariants: per-family render
output (round 0 with/without system, later rounds), model-name
auto-selection, stop-token resolution across tokenizer implementations,
and ChatSession wiring (template text in, template stops honored).
"""

import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.chat_template import (
    get_chat_template, resolve_stop_ids, template_for_model)
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.session import ChatSession


def test_llama2_render():
    t = get_chat_template("llama2")
    r0 = t.render(0, "be brief", "hi")
    assert r0 == "[INST] <<SYS>>\nbe brief\n<</SYS>>\n\nhi [/INST] "
    assert t.render(0, "", "hi") == "[INST] hi [/INST] "
    assert t.render(3, "be brief", "more") == "[INST] more [/INST] "
    assert t.add_bos


def test_llama3_render():
    t = get_chat_template("llama3")
    r0 = t.render(0, "sys", "hi")
    assert r0.startswith("<|start_header_id|>system<|end_header_id|>\n\nsys"
                         "<|eot_id|>")
    assert r0.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")
    assert "<|eot_id|>" in t.stop_strings


def test_chatml_render():
    t = get_chat_template("chatml")
    assert t.render(0, "sys", "hi") == (
        "<|im_start|>system\nsys<|im_end|>\n"
        "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n")
    assert t.render(1, "sys", "again") == (
        "<|im_start|>user\nagain<|im_end|>\n<|im_start|>assistant\n")
    assert not t.add_bos and "<|im_end|>" in t.stop_strings


def test_template_for_model():
    assert template_for_model("qwen2-7b").name == "chatml"
    assert template_for_model("llama3.1-8b").name == "llama3"
    assert template_for_model("llama2-7b").name == "llama2"
    assert template_for_model("tinyllama-1.1b").name == "llama2"
    assert template_for_model("mistral-7b").name == "llama2"
    assert template_for_model("debug").name == "plain"
    with pytest.raises(KeyError):
        get_chat_template("nope")


def test_resolve_stop_ids_bytelevel_and_sp():
    class BL:                       # byte-level shaped: added-token dict
        added = {"<|im_end|>": 7, "<|endoftext|>": 9}
        vocab = {}
    assert resolve_stop_ids(BL(), ("<|im_end|>", "<|endoftext|>",
                                   "<missing>")) == [7, 9]

    class SP:                       # SentencePiece shaped: pieces dict
        pieces = {"</s>": (2, 0.0), "x": (5, -1.0)}
    assert resolve_stop_ids(SP(), ("</s>",)) == [2]


class _StubTokenizer:
    """Whitespace tokenizer over a tiny vocab; template markup words get
    ids too, and <|im_end|> is a single special id."""

    def __init__(self):
        self.added = {"<|im_end|>": 3, "<|im_start|>": 4}
        self.vocab = {}
        self._next = 10
        self._ids = {}
        self.eos_id = 2
        self.texts = []

    def encode(self, text, add_bos=False, add_eos=False):
        self.texts.append((text, add_bos))
        ids = [1] if add_bos else []
        for w in text.replace("<|im_end|>", " <|im_end|> ").split():
            if w in self.added:
                ids.append(self.added[w])
                continue
            if w not in self._ids:
                self._ids[w] = self._next
                self._next += 1
            ids.append(self._ids[w])
        return ids

    def decode_incremental(self, prev_ids, new_id):
        return f"<{int(new_id)}>"


def test_chat_session_uses_template_and_stops():
    cfg = get_config("debug")
    engine = InferenceEngine(
        cfg, EngineConfig(max_batch_size=1, max_seq_len=64),
        init_dummy_params(cfg, seed=0))
    tok = _StubTokenizer()
    s = ChatSession(engine, tok, system_prompt="sys", template="chatml")
    assert s._stop_ids == (3,)       # <|im_end|> resolved through `added`
    s.response("hello", SamplingParams(greedy=True, max_new_tokens=3))
    text, add_bos = tok.texts[0]
    assert text.startswith("<|im_start|>system\nsys<|im_end|>")
    assert not add_bos               # chatml has no BOS
    s.response("again", SamplingParams(greedy=True, max_new_tokens=3))
    text2, _ = tok.texts[1]
    assert text2.startswith("<|im_start|>user\nagain")
    # template stops merged into sampling: id 3 would end the generation
    # (dummy weights rarely emit it; the merge itself is what's pinned)
    merged = s._with_stops(SamplingParams(stop_token_ids=(99,)))
    assert merged.stop_token_ids == (3, 99)


def test_render_conversation_multi_turn():
    t = get_chat_template("chatml")
    text = t.render_conversation([
        {"role": "system", "content": "sys"},
        {"role": "user", "content": "q1"},
        {"role": "assistant", "content": "a1"},
        {"role": "user", "content": "q2"},
    ])
    assert text == ("<|im_start|>system\nsys<|im_end|>\n"
                    "<|im_start|>user\nq1<|im_end|>\n<|im_start|>assistant\n"
                    "a1<|im_end|>\n"
                    "<|im_start|>user\nq2<|im_end|>\n<|im_start|>assistant\n")
    with pytest.raises(ValueError):
        t.render_conversation([{"role": "alien", "content": "x"}])
    # llama2: assistant turns close with </s>
    t2 = get_chat_template("llama2")
    text2 = t2.render_conversation([
        {"role": "user", "content": "q1"},
        {"role": "assistant", "content": "a1"},
        {"role": "user", "content": "q2"},
    ])
    assert text2 == "[INST] q1 [/INST] a1 </s>[INST] q2 [/INST] "
