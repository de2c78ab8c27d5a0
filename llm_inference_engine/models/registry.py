"""Model factory.

Capability parity with the reference's API tier (src/utils/model_utils.h):
- ``createModelWithName`` (model_utils.h:18-75): config + runtime wiring;
- ``createRealLLMModel`` (model_utils.h:85-92): + tokenizer + weights;
- ``createDummyLLMModel`` (model_utils.h:77-83): dummy-weight fixture.
Unlike the reference (hardcoded absolute config path, model_utils.h:22),
everything is parameterized.
"""

from __future__ import annotations

import os
from typing import Optional

from llm_inference_engine.config import (
    EngineConfig, ModelConfig, PRESETS, get_config)
from llm_inference_engine.models import weights as W
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.tokenizer import load_tokenizer

__all__ = ["create_engine", "create_dummy_engine", "create_real_engine"]


def _resolve_config(model: str) -> ModelConfig:
    if model in PRESETS:
        return get_config(model)
    if os.path.exists(model):          # JSON config file (llama_config.json
        return ModelConfig.from_json(model)  # or HF config.json)
    raise ValueError(f"unknown model {model!r}: not a preset "
                     f"({sorted(PRESETS)}) nor a config file path")


def create_dummy_engine(model: str, engine_config: EngineConfig = EngineConfig(),
                        seed: int = 0) -> InferenceEngine:
    """Engine with random weights (reference createDummyLLMModel +
    loadWeightsFromDummy)."""
    cfg = _resolve_config(model)
    if engine_config.quant_mode in ("int8", "int4"):
        params = W.init_dummy_quantized_params(
            cfg, engine_config.quant_mode, engine_config.quant_group_size,
            seed=seed)
    else:
        params = W.init_dummy_params(cfg, seed=seed)
    return InferenceEngine(cfg, engine_config, params)


def create_real_engine(model: str, checkpoint_path: str,
                       engine_config: EngineConfig = EngineConfig()
                       ) -> InferenceEngine:
    """Engine with real weights (reference createRealLLMModel): HF
    safetensors directory or reference .bin directory, quantized on load
    when engine_config.quant_mode says so."""
    cfg = _resolve_config(model)
    if checkpoint_path.endswith(".npz"):
        # pre-quantized/pre-fused save_params checkpoint: load as-is
        # (quantize-once / serve-many; no fp16 staging, no re-quantization)
        return InferenceEngine(cfg, engine_config,
                               W.load_saved_params(checkpoint_path))
    if any(f.endswith(".safetensors") for f in os.listdir(checkpoint_path)):
        params = W.load_hf_safetensors(cfg, checkpoint_path)
    else:
        params = W.load_reference_bin(cfg, checkpoint_path)
    if engine_config.quant_mode in ("int8", "int4"):
        params = W.quantize_params(params, engine_config.quant_mode,
                                   engine_config.quant_group_size)
    return InferenceEngine(cfg, engine_config, params)


def create_engine(model: str, checkpoint_path: Optional[str] = None,
                  engine_config: EngineConfig = EngineConfig(),
                  seed: int = 0) -> InferenceEngine:
    if checkpoint_path:
        return create_real_engine(model, checkpoint_path, engine_config)
    return create_dummy_engine(model, engine_config, seed=seed)
