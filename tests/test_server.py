"""OpenAI-compatible HTTP server tests (server.py).

Real ThreadingHTTPServer on an ephemeral port + the engine thread over a
dummy-weight debug engine; clients speak actual HTTP (http.client).
Invariants: completion/chat/streaming response shapes, stream text ==
non-stream text (greedy), usage accounting, concurrent requests all served
through the shared continuous-batching scheduler.
"""

import http.client
import json
import time
import threading

import pytest

from llm_inference_engine.cli import _IdTokenizer
from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.chat_template import get_chat_template
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.scheduler import ContinuousBatchingScheduler
from llm_inference_engine.server import make_server

CFG = get_config("debug")


@pytest.fixture(scope="module")
def server():
    eng = InferenceEngine(
        CFG, EngineConfig(max_batch_size=2, max_seq_len=64),
        init_dummy_params(CFG, seed=0))
    sched = ContinuousBatchingScheduler(eng, eos_token_id=None)
    httpd, llm = make_server(sched, _IdTokenizer(CFG.vocab_size),
                             get_chat_template("plain"), "debug",
                             host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    llm.start()
    yield httpd.server_address
    httpd.shutdown()
    llm.shutdown()


def _post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp


def _get_json(resp):
    return json.loads(resp.read())


def test_health_and_models(server):
    conn = http.client.HTTPConnection(*server, timeout=60)
    conn.request("GET", "/health")
    assert _get_json(conn.getresponse())["status"] == "ok"
    conn.request("GET", "/v1/models")
    models = _get_json(conn.getresponse())
    assert models["data"][0]["id"] == "debug"
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404


def _completion(server, **kw):
    body = {"prompt": "5 9 2", "max_tokens": 6, "temperature": 0.0, **kw}
    status, resp = _post(server, "/v1/completions", body)
    assert status == 200
    return _get_json(resp)


def test_completion_shape_and_usage(server):
    out = _completion(server)
    assert out["object"] == "text_completion"
    choice = out["choices"][0]
    assert choice["finish_reason"] in ("stop", "length")
    assert len(choice["text"].split()) == out["usage"]["completion_tokens"]
    assert out["usage"]["prompt_tokens"] == 4          # bos + 3 ids
    assert out["usage"]["total_tokens"] == (
        out["usage"]["prompt_tokens"] + out["usage"]["completion_tokens"])


def test_stream_matches_nonstream(server):
    full = _completion(server)["choices"][0]["text"]

    status, resp = _post(server, "/v1/completions",
                         {"prompt": "5 9 2", "max_tokens": 6,
                          "temperature": 0.0, "stream": True})
    assert status == 200
    assert resp.getheader("Content-Type").startswith("text/event-stream")
    events = []
    buf = b""
    while True:
        chunk = resp.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            line, buf = buf.split(b"\n\n", 1)
            if line.startswith(b"data: "):
                payload = line[len(b"data: "):]
                if payload == b"[DONE]":
                    events.append(None)
                else:
                    events.append(json.loads(payload))
        if events and events[-1] is None:
            break
    assert events[-1] is None
    toks = [e["choices"][0]["text"] for e in events[:-1]
            if e["choices"][0]["finish_reason"] is None]
    assert "".join(toks) == full
    assert events[-2]["choices"][0]["finish_reason"] in ("stop", "length")


def test_chat_completion(server):
    status, resp = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "system", "content": "1 2"},
                     {"role": "user", "content": "7 11"}],
        "max_tokens": 5, "temperature": 0.0})
    assert status == 200
    out = _get_json(resp)
    assert out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and msg["content"]
    # plain template concatenates: "1 2" + "7 11" -> "1 27 11" -> bos + 3
    assert out["usage"]["prompt_tokens"] == 4


def test_concurrent_requests_multiplex(server):
    results = [None] * 4
    def go(i):
        results[i] = _completion(server, prompt=f"{3 + i} {5 + i}")
    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for r in results:
        assert r is not None
        assert r["usage"]["completion_tokens"] == 6


def test_bad_request(server):
    status, resp = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "alien", "content": "x"}]})
    assert status == 400
    assert "error" in _get_json(resp)


def test_stop_strings_trim_and_cancel(server):
    """OpenAI `stop` strings: generation is cut at the match (non-stream
    and stream agree) and the request is cancelled server-side."""
    base = _completion(server, max_tokens=6)
    full = base["choices"][0]["text"]
    words = full.split()
    stop_word = words[2]                      # cut at the 3rd token's text
    out = _completion(server, max_tokens=6, stop=[" " + stop_word + " "])
    got = out["choices"][0]["text"]
    assert got == full[:full.index(" " + stop_word + " ")]
    assert out["choices"][0]["finish_reason"] == "stop"

    status, resp = _post(server, "/v1/completions",
                         {"prompt": "5 9 2", "max_tokens": 6,
                          "temperature": 0.0, "stream": True,
                          "stop": " " + stop_word + " "})
    assert status == 200
    body = resp.read().decode()
    texts = [json.loads(line[len("data: "):])
             for line in body.split("\n\n")
             if line.startswith("data: ") and not line.endswith("[DONE]")]
    stream_text = "".join(t["choices"][0].get("text", "") for t in texts)
    assert stream_text == got


def test_backpressure_429():
    """A max_queue=1 server rejects the second concurrent request with
    429 while the first is still streaming."""
    from llm_inference_engine.cli import _IdTokenizer
    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    from llm_inference_engine.runtime.chat_template import (
        get_chat_template)
    from llm_inference_engine.server import make_server

    eng = InferenceEngine(
        CFG, EngineConfig(max_batch_size=1, max_seq_len=64),
        init_dummy_params(CFG, seed=0))
    sched = ContinuousBatchingScheduler(eng, eos_token_id=None)
    httpd, llm = make_server(sched, _IdTokenizer(CFG.vocab_size),
                             get_chat_template("plain"), "debug",
                             host="127.0.0.1", port=0, max_queue=1)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    llm.start()
    try:
        addr = httpd.server_address
        codes = [None, None]

        def go(i, n):
            status, resp = _post(addr, "/v1/completions",
                                 {"prompt": "5 9", "max_tokens": n,
                                  "temperature": 0.0})
            resp.read()
            codes[i] = status

        t1 = threading.Thread(target=go, args=(0, 30))
        t1.start()
        time.sleep(0.2)                      # first request is in flight
        go(1, 2)
        t1.join(timeout=300)
        assert codes[0] == 200 and codes[1] == 429
    finally:
        httpd.shutdown()
        llm.shutdown()


def _standalone_server(batch=1, max_queue=0):
    eng = InferenceEngine(
        CFG, EngineConfig(max_batch_size=batch, max_seq_len=64),
        init_dummy_params(CFG, seed=0))
    sched = ContinuousBatchingScheduler(eng, eos_token_id=None)
    httpd, llm = make_server(sched, _IdTokenizer(CFG.vocab_size),
                             get_chat_template("plain"), "debug",
                             host="127.0.0.1", port=0, max_queue=max_queue)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    llm.start()
    return httpd, llm, sched


def test_context_length_400(server):
    status, resp = _post(server, "/v1/completions", {
        "prompt": [7] * 64, "max_tokens": 2})
    assert status == 400
    assert _get_json(resp)["error"]["type"] == "context_length_exceeded"


def test_client_disconnect_cancels_generation():
    """Dropping a streaming connection mid-generation cancels the request
    server-side (review finding: slots/pages were held until
    max_new_tokens for dead sockets)."""
    httpd, llm, sched = _standalone_server()
    try:
        addr = httpd.server_address
        conn = http.client.HTTPConnection(*addr, timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "5 9", "max_tokens": 50,
                                 "temperature": 0.0, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read(200)                  # a few chunks flowed
        conn.close()                    # client disappears
        deadline = time.time() + 60
        req = None
        while time.time() < deadline:
            live = [r for r in sched.slots if r is not None]
            if not live and not sched.waiting:
                break
            if live:
                req = live[0]
            time.sleep(0.1)
        assert not sched.has_work, "request still running after disconnect"
        assert req is not None and req.finish_reason == "cancelled"
        assert len(req.output_ids) < 50
    finally:
        httpd.shutdown()
        llm.shutdown()


def test_n_completions(server):
    """OpenAI `n`: multiple choices per request, multiplexed through the
    batch; greedy choices are identical, usage sums across choices."""
    status, resp = _post(server, "/v1/completions", {
        "prompt": "5 9 2", "max_tokens": 4, "temperature": 0.0, "n": 3})
    assert status == 200
    out = _get_json(resp)
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    texts = {c["text"] for c in out["choices"]}
    assert len(texts) == 1                    # greedy: all identical
    assert out["usage"]["completion_tokens"] == 12

    status, resp = _post(server, "/v1/completions", {
        "prompt": "5 9", "max_tokens": 2, "n": 2, "stream": True})
    assert status == 400                      # n>1 streaming unsupported
    resp.read()


def test_logprobs_returned(server):
    import math
    out = _completion(server, max_tokens=4, logprobs=1)
    lp = out["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == 4 and len(lp["token_logprobs"]) == 4
    assert all(l <= 0.0 and math.isfinite(l) for l in lp["token_logprobs"])
    assert "".join(lp["tokens"]) == out["choices"][0]["text"]

    status, resp = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "7 11"}],
        "max_tokens": 3, "temperature": 0.0, "logprobs": True})
    chat = _get_json(resp)
    content = chat["choices"][0]["logprobs"]["content"]
    assert len(content) == 3
    assert all("token" in c and c["logprob"] <= 0.0 for c in content)


def test_n_backpressure_atomic():
    """n bigger than max_queue: clean 429, nothing leaks, and the server
    still serves afterwards (review finding: partial enqueue wedged the
    inflight counter forever)."""
    httpd, llm, sched = _standalone_server(batch=2, max_queue=2)
    try:
        addr = httpd.server_address
        status, resp = _post(addr, "/v1/completions", {
            "prompt": "5 9", "max_tokens": 2, "temperature": 0.0, "n": 8})
        assert status == 429
        resp.read()
        status, resp = _post(addr, "/v1/completions", {
            "prompt": "5 9", "max_tokens": 2, "temperature": 0.0})
        assert status == 200                 # not wedged
        resp.read()
    finally:
        httpd.shutdown()
        llm.shutdown()


def test_speculative_server_sampled_and_penalized_ok():
    """Sampled requests run through the stochastic speculative round
    (VERDICT r2 ask #4); penalized ones now run too, under the
    frozen-counts round semantics (VERDICT r3 #8) — both streaming and
    non-streaming — and the engine thread keeps serving after them."""
    from llm_inference_engine.runtime.speculative_scheduler import (
        SpeculativeScheduler)

    def eng():
        return InferenceEngine(
            CFG, EngineConfig(max_batch_size=2, max_seq_len=64),
            init_dummy_params(CFG, seed=0))
    sched = SpeculativeScheduler(eng(), eng(), eos_token_id=None)
    httpd, llm = make_server(sched, _IdTokenizer(CFG.vocab_size),
                             get_chat_template("plain"), "debug",
                             host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    llm.start()
    try:
        addr = httpd.server_address
        # sampled request: served via the stochastic round
        status, resp = _post(addr, "/v1/completions", {
            "prompt": "5 9", "max_tokens": 3, "temperature": 0.9})
        assert status == 200
        assert len(_get_json(resp)["choices"][0]["text"]) > 0
        # penalties: served (counts frozen per speculative round)
        status, resp = _post(addr, "/v1/completions", {
            "prompt": "5 9", "max_tokens": 3, "temperature": 0.9,
            "frequency_penalty": 0.5})
        assert status == 200
        assert len(_get_json(resp)["choices"][0]["text"]) > 0
        status, resp = _post(addr, "/v1/completions", {
            "prompt": "5 9", "max_tokens": 3, "temperature": 0.9,
            "frequency_penalty": 0.5, "stream": True})
        assert status == 200
        resp.read()
        # the engine thread survived: greedy requests still work, through
        # speculative rounds, with logprobs
        status, resp = _post(addr, "/v1/completions", {
            "prompt": "5 9 2", "max_tokens": 5, "temperature": 0.0,
            "logprobs": 1})
        assert status == 200
        out = _get_json(resp)
        lp = out["choices"][0]["logprobs"]
        assert len(lp["token_logprobs"]) == 5
        assert all(l <= 0.0 for l in lp["token_logprobs"])
        assert "".join(lp["tokens"]) == out["choices"][0]["text"]
    finally:
        httpd.shutdown()
        llm.shutdown()


def test_stop_logprobs_tokens_match_trimmed_text(server):
    """With stop strings AND logprobs, the returned token pieces join to
    exactly the trimmed text (review finding: pieces kept the stop)."""
    base = _completion(server, max_tokens=6)
    full = base["choices"][0]["text"]
    stop_word = " " + full.split()[2] + " "
    out = _completion(server, max_tokens=6, stop=[stop_word], logprobs=1)
    choice = out["choices"][0]
    assert "".join(choice["logprobs"]["tokens"]) == choice["text"]
    assert (len(choice["logprobs"]["token_logprobs"])
            == len(choice["logprobs"]["tokens"]))
    assert stop_word not in choice["text"]


def test_bad_n_is_400(server):
    status, resp = _post(server, "/v1/completions",
                         {"prompt": "5", "n": "abc"})
    assert status == 400
    resp.read()


def test_metrics_endpoint(server):
    _completion(server, max_tokens=3)
    conn = http.client.HTTPConnection(*server, timeout=60)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/plain")
    text = resp.read().decode()
    lines = dict(l.split(" ", 1) for l in text.strip().splitlines()
                 if not l.startswith("#"))
    assert int(lines["llm_requests_completed_total"]) >= 1
    assert int(lines["llm_tokens_generated_total"]) >= 3
    assert float(lines["llm_ttft_seconds_sum"]) > 0
    assert int(lines["llm_batch_slots"]) == 2
