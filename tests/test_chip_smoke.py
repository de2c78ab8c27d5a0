"""chip_smoke.py off the card: it must refuse a CPU backend (non-zero exit,
no result line), and its phases must pass at reduced widths on the CPU —
the same code the card runs at full width."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from llm_inference_engine.config import ModelConfig, get_config  # noqa: E402

TINY = ModelConfig(name="tiny", vocab_size=512, hidden_size=256,
                   intermediate_size=512, num_layers=2, num_heads=4,
                   num_kv_heads=4, head_dim=64)
TINY_GQA = TINY.replace(name="tiny-gqa", num_heads=8, num_kv_heads=2,
                        sliding_window=64)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code == 2


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    """Run as the card would be asked to, but on the CPU — from the repo,
    and from a directory holding only the script: no result line, non-zero
    exit."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(open(script).read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_ops_reduced_widths():
    assert chip_smoke.phase_ops(TINY, TINY_GQA, max_seq=128, batch=8,
                                chunk=32, seq_gqa=256, layers=2)


@pytest.mark.parametrize("quant", ["none", "int4"])
def test_phase_logits_reduced_widths(quant):
    assert chip_smoke.run_logits("debug", quant, cfg=get_config("debug"),
                                 decode_steps=4, prompt_lens=(5, 11),
                                 max_seq=64)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_phase_logits_int8_kv_reduced_widths(layout):
    """float32 with an int8 KV cache, held to the control's tolerance: the
    reference rounds K and V as the slot cache (float32 scales) and the
    paged pool (log2-coded scales) store them."""
    assert chip_smoke.run_logits("debug", "none", cfg=get_config("debug"),
                                 decode_steps=4, prompt_lens=(5, 11),
                                 max_seq=64, control=True, kv_dtype="int8",
                                 kv_layout=layout)


def test_phase_serving_reduced_widths():
    clock = chip_smoke._CompileClock()
    assert chip_smoke.run_serving("debug", "none", "", "slot", batch=2,
                                  max_seq=1024, n_requests=3, new_tokens=4,
                                  clock=clock, cfg=get_config("debug"))


def test_phase_four_reduced_widths():
    """--four's tp=4 / dp=4 / cp=4 engines against one device, then tp=4
    with int4 weights against one device and the float32 reference, on
    four of the virtual CPU devices."""
    cfg = TINY.replace(name="tiny-13b", num_heads=8, num_kv_heads=8,
                       head_dim=32, dtype_name="float32")
    assert chip_smoke.run_four(cfg=cfg, max_seq=512, batch=8,
                               decode_steps=4)
