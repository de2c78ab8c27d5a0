"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins when set (and
nothing is set in code); otherwise one fixed, gitignored path inside the
checkout."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from llm_inference_engine.utils.compile_cache import "
          "enable_compile_cache; d = enable_compile_cache(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd="/",
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_compile_cache_follows_env(tmp_path):
    got, active = _probe(str(tmp_path))
    assert got == str(tmp_path) and active == str(tmp_path)


def test_compile_cache_default_is_fixed_gitignored_path():
    got, active = _probe(None)
    assert got == active == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored
