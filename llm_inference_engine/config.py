"""Model / engine / sampling configuration.

Mirrors the capability of the reference's config tier (reference:
src/models/llama/llama_params.h:3-21 ``LlamaAttentionStaticParams`` /
``LlamaAttentionDynamicParams``, src/models/llama/llama_config.json,
src/utils/model_utils.h:22-41 JSON loading) — redesigned as frozen dataclasses
so every field is a static, hashable jit constant. The reference's "dynamic"
params (batch size, seq lens) become *runtime array contents* here, never
shapes: XLA traces once per (ModelConfig, EngineConfig).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import jax.numpy as jnp

__all__ = [
    "ModelConfig",
    "EngineConfig",
    "SamplingParams",
    "RopeScaling",
    "NTKScaling",
    "resolve_rope_scaling",
    "PRESETS",
    "get_config",
]


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style frequency-dependent RoPE scaling (HF rope_type
    "llama3"): low-frequency bands are slowed by ``factor``, high-frequency
    bands kept, with a smooth ramp between — a per-inv-freq transform, so
    it is a static, hashable jit constant like everything else here."""
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class NTKScaling:
    """NTK-aware RoPE scaling (HF rope_types "ntk"/"dynamic"; the
    reference plumbed a ``use_dynamic_ntk`` flag config->kernel but left
    the kernel side a placeholder, model_utils.h:41,
    qkv_bias_and_rope.cu:24,132). Both flavors rescale the rope base:

        theta' = theta * s^(dim / (dim - 2))

    with s = ``factor`` for the static flavor, and for ``dynamic=True``
    s = factor * L / original - (factor - 1) evaluated at context length
    L. HF recomputes dynamic-NTK per step as the sequence grows — that
    would retune every cached K entry each step (their cache grows stale
    anyway) and is hostile to a compiled static-shape engine, so here the
    engine FIXES L at its max_seq_len once at construction
    (resolve_rope_scaling): one theta, keys cached consistently, no
    retraces. Sequences shorter than ``original`` keep theta unchanged
    only in HF's step-wise variant; the fixed-at-max form trades a little
    short-context fidelity for cache consistency — the standard serving
    compromise."""
    factor: float = 2.0
    original_max_position_embeddings: int = 4096
    dynamic: bool = False

    def effective_theta(self, theta: float, head_dim: int,
                        seq_len: int) -> float:
        if self.dynamic:
            s = (self.factor * max(seq_len, 1)
                 / self.original_max_position_embeddings
                 - (self.factor - 1.0))
            s = max(s, 1.0)
        else:
            s = self.factor
        return theta * s ** (head_dim / (head_dim - 2.0))


def resolve_rope_scaling(config: "ModelConfig",
                         max_seq_len: int) -> "ModelConfig":
    """Fold NTK scaling into a plain rope_theta for a given engine
    context length (see NTKScaling). Other scaling kinds pass through —
    they are position-independent per-frequency transforms the kernels
    handle directly."""
    rs = config.rope_scaling
    if not isinstance(rs, NTKScaling):
        return config
    theta = rs.effective_theta(config.rope_theta, config.head_dim,
                               max_seq_len)
    return config.replace(rope_theta=theta, rope_scaling=None)


def _dtype_from_str(name: str):
    return {
        "float32": jnp.float32,
        "fp32": jnp.float32,
        "bfloat16": jnp.bfloat16,
        "bf16": jnp.bfloat16,
        "float16": jnp.float16,
        "fp16": jnp.float16,
    }[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description of a Llama-class decoder-only model.

    Field parity with the reference's llama_config.json:1-16 (head_num,
    kv_head_num, head_size, inter_size, num_layers, vocab_size, rope params,
    max_seq_len) — plus fields the reference hardcoded (rms eps, tying).
    """

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # float = linear position scale; RopeScaling = llama3-style
    # frequency-dependent scaling; None = unscaled
    rope_scaling: Optional[Any] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False          # qkv projection bias (Qwen2-class;
                                          # the reference's QKV+RoPE kernel
                                          # carried an — unused — bias input,
                                          # qkv_bias_and_rope.cu:97)
    sliding_window: Optional[int] = None  # sliding-window attention width
                                          # (Mistral-class); None = full causal
    dtype_name: str = "bfloat16"  # parameter / activation dtype

    @property
    def dtype(self):
        return _dtype_from_str(self.dtype_name)

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_size(self) -> int:
        # packed QKV projection output, fused exactly like the reference's
        # single qkv weight (reference: src/weights/llama/layer_weights.cpp:28)
        return self.q_size + 2 * self.kv_size

    @property
    def group_size(self) -> int:
        """Number of query heads sharing one KV head (GQA group)."""
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_json(path: str) -> "ModelConfig":
        """Load from a JSON file.

        Accepts both this package's field names and HF ``config.json`` names
        (the reference instead read its own llama_config.json with keys like
        head_num / inter_size, src/utils/model_utils.h:24-38; we accept those
        too for parity).
        """
        with open(path) as f:
            raw = json.load(f)
        return ModelConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "ModelConfig":
        alias = {
            # HF config.json names
            "num_hidden_layers": "num_layers",
            "num_attention_heads": "num_heads",
            "num_key_value_heads": "num_kv_heads",
            "rms_norm_eps": "rms_norm_eps",
            # reference llama_config.json names (src/models/llama/llama_config.json)
            "head_num": "num_heads",
            "kv_head_num": "num_kv_heads",
            "head_size": "head_dim",
            "inter_size": "intermediate_size",
            "inter_dim": "intermediate_size",
            "num_layer": "num_layers",
            "rope_base": "rope_theta",
            "max_seq_len": "max_position_embeddings",
            "hidden_units": "hidden_size",
        }
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        kw: dict[str, Any] = {}
        for k, v in raw.items():
            k = alias.get(k, k)
            if k in fields and v is not None:   # HF configs carry explicit
                kw[k] = v                       # None for derived fields
        if "head_dim" not in kw and {"hidden_size", "num_heads"} <= set(kw):
            kw["head_dim"] = kw["hidden_size"] // kw["num_heads"]
        # HF rope_scaling dicts: {"type"/"rope_type": "linear", "factor": f}
        # -> float; "llama3" -> RopeScaling; "default"/None -> None
        rs = kw.get("rope_scaling")
        if isinstance(rs, dict):
            rtype = rs.get("rope_type", rs.get("type", "default"))
            if rtype == "linear":
                kw["rope_scaling"] = float(rs["factor"])
            elif rtype == "llama3":
                kw["rope_scaling"] = RopeScaling(
                    factor=float(rs.get("factor", 8.0)),
                    low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
                    high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
                    original_max_position_embeddings=int(
                        rs.get("original_max_position_embeddings", 8192)))
            elif rtype in ("ntk", "dynamic"):
                kw["rope_scaling"] = NTKScaling(
                    factor=float(rs.get("factor", 2.0)),
                    original_max_position_embeddings=int(
                        rs.get("original_max_position_embeddings",
                               kw.get("max_position_embeddings", 4096))),
                    dynamic=rtype == "dynamic")
            elif rtype == "default":
                kw["rope_scaling"] = None
            else:
                raise ValueError(f"unsupported rope_scaling type {rtype!r}")
        # HF quirks: Qwen2 configs carry sliding_window but gate it off by
        # default, and mark their qkv bias only via model_type
        if raw.get("use_sliding_window") is False:
            kw.pop("sliding_window", None)
        if raw.get("model_type") == "qwen2":
            kw.setdefault("attention_bias", True)
        cfg = ModelConfig(**kw)
        # The reference's own config carries hidden_units=128 (wrong) and the
        # code recomputes hidden = head_num * head_size (llama.h:106). Apply the
        # same guard: trust heads * head_dim when hidden_size is inconsistent.
        if cfg.hidden_size != cfg.num_heads * cfg.head_dim and "head_num" in raw:
            cfg = cfg.replace(hidden_size=cfg.num_heads * cfg.head_dim)
        return cfg


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static runtime/engine shape configuration.

    Replaces the reference's hardcoded runtime limits (batch size pinned to 1,
    llama.h:31; output cap 20 tokens, llama.h:26; max_seq_len 64,
    llama_config.json:8) with explicit, configurable static bounds.
    """

    max_batch_size: int = 8          # decode batch slots (continuous batching)
    max_prefill_batch: int = 1       # sequences prefilled per prefill call
    max_seq_len: int = 2048          # KV cache capacity per slot
    max_prefill_len: int = 512       # per-chunk prefill length (chunked prefill)
    kv_cache_dtype_name: str = ""    # "" = same as model dtype; "int8" = quantized
    quant_mode: str = "none"         # none | int8 | int4  (weight-only)
    quant_group_size: int = 128      # int4 grouped-scale group size
    # parallelism (mesh shape); data * seq * model must equal #devices used
    dp: int = 1
    tp: int = 1
    cp: int = 1                      # context (sequence) parallelism: the KV
                                     # cache's token capacity splits over the
                                     # mesh's "seq" axis (parallel/cp_engine)
    # layer-loop unroll factor: a lax.scan body is a scheduling barrier
    # (XLA cannot overlap across while-loop iterations), so unrolling lets
    # layer i+1's weight reads issue under layer i's compute, at the cost
    # of a proportionally larger program (effect on this card: not
    # measured)
    layer_scan_unroll: int = 1
    # paged KV cache (ops/paged_kv.py): "slot" = per-slot max_seq rows;
    # "paged" = shared page pool + block tables (serving memory bounded by
    # tokens in flight). num_pages=0 sizes the pool to the slot-cache
    # equivalent (max_batch * max_seq / page) — set it lower to trade
    # worst-case capacity for a smaller footprint, or higher for headroom.
    kv_layout: str = "slot"
    page_size: int = 64
    num_pages: int = 0

    @property
    def kv_cache_dtype(self):
        if self.kv_cache_dtype_name in ("", "none"):
            return None
        if self.kv_cache_dtype_name == "int8":
            return jnp.int8
        return _dtype_from_str(self.kv_cache_dtype_name)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    The reference samples from the softmax of the top-K logits with K
    hardcoded (5 in the launcher topk.cu:118, 4 in the model llama.h:42) and a
    per-step seeded curand draw (sampling.cu:44-63). Here K, temperature,
    top-p and greedy mode are all runtime-selectable.
    """

    temperature: float = 1.0
    top_k: int = 5
    top_p: float = 1.0
    min_p: float = 0.0               # drop candidates below min_p * p_max
    repetition_penalty: float = 1.0  # HF-style, over the full context
    presence_penalty: float = 0.0    # OpenAI-style, over generated tokens
    frequency_penalty: float = 0.0   # OpenAI-style, per occurrence
    greedy: bool = False
    max_new_tokens: int = 256
    stop_token_ids: tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

PRESETS: dict[str, ModelConfig] = {
    # the model the reference targets (llama_config.json:1-16)
    "llama2-7b": ModelConfig(
        name="llama2-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
        head_dim=128, rope_theta=10000.0, max_position_embeddings=4096,
    ),
    "llama2-13b": ModelConfig(
        name="llama2-13b", vocab_size=32000, hidden_size=5120,
        intermediate_size=13824, num_layers=40, num_heads=40, num_kv_heads=40,
        head_dim=128, rope_theta=10000.0, max_position_embeddings=4096,
    ),
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", vocab_size=32000, hidden_size=2048,
        intermediate_size=5632, num_layers=22, num_heads=32, num_kv_heads=4,
        head_dim=64, rope_theta=10000.0, max_position_embeddings=2048,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "llama3.1-8b": ModelConfig(
        name="llama3.1-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_position_embeddings=131072,
        rope_scaling=RopeScaling(factor=8.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_position_embeddings=8192),
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, max_position_embeddings=32768,
        sliding_window=4096,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, max_position_embeddings=32768,
        attention_bias=True,
    ),
    # tiny debug model for tests (CPU-friendly)
    "debug": ModelConfig(
        name="debug", vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, max_position_embeddings=128,
        dtype_name="float32",
    ),
}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
