"""REAL 2-process DP-router serving test (VERDICT r3 #7).

The production multi-host layout for paged engines is the DP router
(docs/ADR-composition-matrix.md pairing 1): independent replicas — each
its own process, paged KV pool, continuous-batching scheduler, and HTTP
server — behind a least-loaded request router. No lockstep: that is the
point of the pairing (host-side page allocation stays process-local).

This test launches TWO worker processes, each a full LLMServer over a
PAGED debug engine on an ephemeral port, routes a burst of completion
requests to the least-loaded replica (the RequestRouter policy, tracked
by in-flight count), and asserts:
- every request completes and matches an uncontended single-engine run
  (greedy; router placement must not change results);
- both replicas actually served traffic (routing spread);
- the fleet ``/metrics`` view (server.aggregate_metrics over both
  replicas' expositions) sums the counters to the known totals and
  carries the paged-pool gauges.
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)
    from llm_inference_engine.cli import _IdTokenizer
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.chat_template import (
        get_chat_template)
    from llm_inference_engine.runtime.engine import InferenceEngine
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    from llm_inference_engine.server import make_server

    cfg = get_config("debug")
    engine = InferenceEngine(
        cfg, EngineConfig(max_batch_size=2, max_seq_len=64,
                          kv_layout="paged", page_size=8,
                          max_prefill_len=8),
        init_dummy_params(cfg, seed=0))
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    httpd, llm = make_server(sched, _IdTokenizer(cfg.vocab_size),
                             get_chat_template("plain"), "debug",
                             host="127.0.0.1", port=0)
    llm.start()
    print("PORT", httpd.server_address[1], flush=True)
    httpd.serve_forever()
""")


def _post(port, path, body, timeout=600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [5, 5], [11, 12, 13],
           [2, 4, 6, 8], [3, 1, 4]]
MAX_NEW = 5


@pytest.mark.slow
def test_two_process_paged_router(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=env) for _ in range(2)]
    ports = []
    try:
        for p in procs:
            line = p.stdout.readline()
            assert line.startswith("PORT"), (line, p.stderr.read()[-2000:])
            ports.append(int(line.split()[1]))

        # least-loaded router (RequestRouter policy over HTTP replicas):
        # route each request to the replica with fewest in-flight
        inflight = {port: 0 for port in ports}
        lock = threading.Lock()
        served = {port: 0 for port in ports}
        results = [None] * len(PROMPTS)

        def drive(i, prompt):
            with lock:
                port = min(ports, key=lambda q: (inflight[q], q))
                inflight[port] += 1
                served[port] += 1
            try:
                status, data = _post(port, "/v1/completions", {
                    "model": "debug",
                    "prompt": " ".join(map(str, prompt)),
                    "max_tokens": MAX_NEW,
                    "temperature": 0.0,
                })
                assert status == 200, data
                results[i] = data["choices"][0]["text"]
            finally:
                with lock:
                    inflight[port] -= 1

        threads = [threading.Thread(target=drive, args=(i, p))
                   for i, p in enumerate(PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert all(r is not None for r in results)
        assert all(v > 0 for v in served.values()), served

        # parity: each completion equals an uncontended single engine
        from llm_inference_engine.config import (EngineConfig,
                                                     SamplingParams,
                                                     get_config)
        from llm_inference_engine.models.weights import init_dummy_params
        from llm_inference_engine.runtime.engine import InferenceEngine
        cfg = get_config("debug")
        solo = InferenceEngine(
            cfg, EngineConfig(max_batch_size=2, max_seq_len=64, kv_layout="paged", page_size=8,
                              max_prefill_len=8),
            init_dummy_params(cfg, seed=0))
        for i, prompt in enumerate(PROMPTS):
            # the server's completion path prepends BOS (server.py:217)
            want = solo.generate([[1] + prompt],
                                 SamplingParams(greedy=True,
                                                max_new_tokens=MAX_NEW),
                                 eos_token_id=None).token_ids[0]
            got = [int(t) for t in results[i].split()]
            assert got == want, (i, got, want)
            solo.reset()

        # fleet /metrics: counters sum across replicas
        from llm_inference_engine.server import aggregate_metrics
        texts = []
        for port in ports:
            status, text = _get(port, "/metrics")
            assert status == 200
            texts.append(text)
        agg = dict(line.split() for line in
                   aggregate_metrics(texts).splitlines()
                   if line and not line.startswith("#"))
        assert float(agg["llm_requests_completed_total"]) == len(PROMPTS)
        assert float(agg["llm_tokens_generated_total"]) == \
            len(PROMPTS) * MAX_NEW
        assert float(agg["llm_requests_inflight"]) == 0
        assert float(agg["llm_batch_slots"]) == 4          # 2 replicas x 2
        assert "llm_kv_pages_total" in agg                 # paged gauges ride
        assert float(agg["llm_kv_pages_free"]) > 0
    finally:
        for p in procs:
            p.kill()


def test_aggregate_metrics_unit():
    from llm_inference_engine.server import aggregate_metrics
    a = ("# TYPE llm_tokens_generated_total counter\n"
         "llm_tokens_generated_total 10\n"
         "# TYPE llm_spec_acceptance_rate gauge\n"
         "llm_spec_acceptance_rate 0.5\n")
    b = ("# TYPE llm_tokens_generated_total counter\n"
         "llm_tokens_generated_total 32\n"
         "# TYPE llm_spec_acceptance_rate gauge\n"
         "llm_spec_acceptance_rate 0.7\n")
    agg = dict(line.split() for line in
               aggregate_metrics([a, b]).splitlines()
               if line and not line.startswith("#"))
    assert float(agg["llm_tokens_generated_total"]) == 42
    assert abs(float(agg["llm_spec_acceptance_rate"]) - 0.6) < 1e-9
    # standard exposition variants must not crash the aggregator:
    # labels (with quoted spaces), timestamps, HELP lines, blanks
    c = ('# HELP llm_requests_completed_total total\n'
         'llm_requests_completed_total{model="7 b"} 3\n'
         'llm_tokens_generated_total 5 1690000000\n'
         '\n')
    agg2 = aggregate_metrics([c, c])
    assert 'llm_requests_completed_total{model="7 b"} 6' in agg2
    assert "llm_tokens_generated_total 10" in agg2
