"""REAL multi-process lockstep test: two jax.distributed processes
(Gloo collectives over localhost — the CPU stand-in for the network) each run a
MultiHostScheduler with DIFFERENT asynchronous arrival patterns.

This exercises what the single-process suite cannot: agree_step_plan's
cross-process all-gather actually reconciling divergent local queues —
hosts with no admissions running the agreed prefill program, an idle
host staying in lockstep through another host's chunked admission, and
both hosts exiting together only when NO host has work. Per-host outputs
must equal an uncontended single-host run."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)
    import jax
    host = int(sys.argv[1])
    jax.distributed.initialize(sys.argv[2], num_processes=2,
                               process_id=host)
    from llm_inference_engine.config import (EngineConfig,
                                                 SamplingParams, get_config)
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    from llm_inference_engine.runtime.multihost_scheduler import (
        MultiHostScheduler)

    cfg = get_config("debug")
    eng = InferenceEngine(
        cfg, EngineConfig(max_batch_size=2, max_seq_len=96,
                          max_prefill_len=8),
        init_dummy_params(cfg, seed=0))
    sched = MultiHostScheduler(eng, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=6)

    reqs = {}
    if host == 0:
        reqs["a"] = sched.submit([1, 2, 3], sp)
    sched.step()                       # host 1 idles IN LOCKSTEP here
    if host == 1:
        reqs["b"] = sched.submit(list(range(3, 23)), sp)   # 3 chunks of 8
    sched.step()
    if host == 0:
        reqs["c"] = sched.submit([9, 8, 7], sp)
    sched.step()
    sched.run()                        # exits only when NO host has work
    print("RESULT" + json.dumps(
        {k: r.output_ids for k, r in reqs.items()}), flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_lockstep_matches_solo(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    # pin the worker's import environment: exactly the repo (an inherited
    # PYTHONPATH can carry site hooks that pin a different jax backend)
    # and no forced virtual-device flags
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(h), coord],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env) for h in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("lockstep deadlock: worker timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)

    results = {}
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("RESULT")][0]
        results.update(json.loads(line[len("RESULT"):]))
    assert set(results) == {"a", "b", "c"}

    # each request must equal an uncontended single-host run
    from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    for name, prompt in (("a", [1, 2, 3]), ("b", list(range(3, 23))),
                         ("c", [9, 8, 7])):
        eng = InferenceEngine(
            get_config("debug"),
            EngineConfig(max_batch_size=2, max_seq_len=96,
                         max_prefill_len=8),
            init_dummy_params(get_config("debug"), seed=0))
        solo = ContinuousBatchingScheduler(eng, eos_token_id=None)
        r = solo.submit(prompt, sp)
        solo.run()
        assert results[name] == r.output_ids, name
