"""End-to-end CLI REPL test (subprocess) — the user_entry.cpp:9-43 surface.

Drives the real `python -m llm_inference_engine.cli` process on the CPU
backend with dummy weights: REPL protocol (prompt line, 's' quits), the
streaming callback print protocol (':' first chunk, newline at -1),
multi-round history, and /reset.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(stdin: str, *extra_args: str, timeout: int = 240) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "llm_inference_engine.cli",
         "--model", "debug", "--dummy-weights", "--greedy",
         "--max-new-tokens", "4", "--max-seq-len", "64",
         "--platform", "cpu", *extra_args],
        input=stdin, capture_output=True, text=True, timeout=timeout,
        env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.slow
def test_cli_repl_round_and_quit():
    out = run_cli("7 11 13\ns\n")
    assert "ready." in out
    # streaming protocol: response starts with ':' after the prompt echo
    assert ":" in out.split("ready.")[1]
    assert out.count("please input the question:") == 2  # round + quit read


@pytest.mark.slow
def test_cli_multi_round_and_reset():
    out = run_cli("5 6\n/reset\n5 6\n/quit\n")
    assert "(history cleared)" in out
    # two generation rounds happened (two ':' streams)
    assert out.split("ready.")[1].count(":") >= 2


@pytest.mark.slow
def test_cli_requires_checkpoint_or_dummy():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "llm_inference_engine.cli",
         "--model", "debug", "--platform", "cpu"],
        input="", capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO)
    assert out.returncode == 2
    assert "--dummy-weights" in out.stderr
