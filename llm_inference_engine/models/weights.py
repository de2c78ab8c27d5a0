"""Parameter pytrees: definition, dummy init, checkpoint loading, quantization.

Capability parity with the reference's weight tier (src/weights/):
- fused storage layout: one packed QKV matrix per layer and one packed
  gate|up matrix (reference: src/weights/llama/layer_weights.cpp:28,43) —
  fewer, larger matmuls;
- dummy-weight fixture for tests/examples without a checkpoint
  (reference: layer_weights.cpp:83-156, llama_weights.cpp:78-128);
- checkpoint loading with dtype cast on load (reference:
  src/utils/weight_utils.cu:189-229 raw .bin reader + typeConversion cast
  kernel; here: HF safetensors -> jnp with astype, plus a reader for the
  reference's own per-tensor .bin naming scheme,
  layer_weights.cpp:64-69 / llama_weights.cpp:50-75);
- INT8/INT4 quantized storage (QuantizedTensor leaves) — the reference's
  declared-but-unbuilt WeightType::INT8_W (base_weights.h:10).

Layout conventions:
- every matmul weight is [in, out] (canonicalized at load from HF's
  [out, in]; the reference instead carried is_transposed flags);
- per-layer weights are stacked on a leading [num_layers, ...] axis so the
  decoder runs as one `lax.scan` (single compiled layer body).
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import ModelConfig
from llm_inference_engine.ops.quant import QuantizedTensor, quantize_tensor

__all__ = [
    "init_dummy_params",
    "init_dummy_quantized_params",
    "quantize_params",
    "fuse_qkv",
    "fuse_gate_up",
    "load_hf_safetensors",
    "load_reference_bin",
    "save_params",
    "load_saved_params",
    "param_count",
    "param_bytes",
]

Params = dict  # {'embed', 'layers': {...}, 'final_norm', 'lm_head'}


def fuse_qkv(wq: np.ndarray, wk: np.ndarray, wv: np.ndarray,
             num_heads: int, num_kv_heads: int, head_dim: int) -> np.ndarray:
    """Fuse separate [in, H*D]/[in, K*D] projections into the group-major
    packed layout [in, K*(G+2)*D] (see ops/rope.py layout note): for each KV
    group, its G query heads, then its k head, then its v head. Contiguously
    shardable over tensor-parallel ranks."""
    hidden = wq.shape[0]
    G = num_heads // num_kv_heads
    q = wq.reshape(hidden, num_kv_heads, G, head_dim)
    k = wk.reshape(hidden, num_kv_heads, 1, head_dim)
    v = wv.reshape(hidden, num_kv_heads, 1, head_dim)
    packed = np.concatenate([q, k, v], axis=2)       # [in, K, G+2, D]
    return packed.reshape(hidden, num_kv_heads * (G + 2) * head_dim)


def fuse_gate_up(wg: np.ndarray, wu: np.ndarray) -> np.ndarray:
    """Fuse [in, I] gate and up into [in, 2, I] (shard axis = I; a local
    reshape to [in, 2*I_local] recovers the packed gate|up convention of
    ops/activations.silu_and_mul on every shard)."""
    return np.stack([wg, wu], axis=1)


def init_dummy_params(config: ModelConfig, seed: int = 0,
                      scale: float = 0.02) -> Params:
    """Random dummy weights (the reference's loadWeightsFromDummy fixture,
    layer_weights.cpp:83-156). Deterministic per seed."""
    L = config.num_layers
    Hd = config.hidden_size
    dtype = config.dtype
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 6)

    def norm_init(shape):
        return jnp.ones(shape, dtype)

    def w_init(k, shape):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    params = {
        "embed": w_init(ks[0], (config.vocab_size, Hd)),
        "layers": {
            "attn_norm": norm_init((L, Hd)),
            "wqkv": w_init(ks[1], (L, Hd, config.qkv_size)),
            "wo": w_init(ks[2], (L, config.q_size, Hd)),
            "ffn_norm": norm_init((L, Hd)),
            "w_gate_up": w_init(ks[3], (L, Hd, 2, config.intermediate_size)),
            "w_down": w_init(ks[4], (L, config.intermediate_size, Hd)),
        },
        "final_norm": norm_init((Hd,)),
        "lm_head": w_init(ks[5], (Hd, config.vocab_size)),
    }
    if config.attention_bias:
        params["layers"]["bqkv"] = w_init(
            jax.random.split(key, 7)[6], (L, config.qkv_size))
    return params


_QUANT_KEYS = ("wqkv", "wo", "w_gate_up", "w_down")


def init_dummy_quantized_params(config: ModelConfig, mode: str = "int8",
                                group_size: int = 128, seed: int = 0,
                                scale: float = 0.02) -> Params:
    """Random dummy weights born quantized (no full-precision original is
    ever materialized, so a 7B model stages on a card that could not hold
    its FP16 original — the wall the reference hit, README.md:9)."""
    L, Hd = config.num_layers, config.hidden_size
    key = jax.random.PRNGKey(seed)

    def qdummy(k, in_dim, out_shape):
        out_dim = int(np.prod(out_shape))
        if mode == "int8":
            q = jax.random.randint(k, (in_dim, out_dim), -127, 128, jnp.int8)
            s = jnp.full((1, out_dim), scale / 127.0, jnp.float32)
        else:
            rows = jax.random.randint(k, (in_dim, out_dim), -8, 8, jnp.int8)
            from llm_inference_engine.ops.quant import _pack_int4
            q = _pack_int4(rows, group_size)
            s = jnp.full((in_dim // group_size, out_dim), scale / 7.0,
                         jnp.float32)
        if len(out_shape) > 1:  # gate|up: [2, in', I] stacked layout
            q = q.reshape(q.shape[0], *out_shape).transpose(1, 0, 2)
            s = s.reshape(s.shape[0], *out_shape).transpose(1, 0, 2)
        return q, s

    def qstack(k, in_dim, out_shape):
        ks = jax.random.split(k, L)
        qs, ss = zip(*(qdummy(ks[l], in_dim, out_shape) for l in range(L)))
        return QuantizedTensor(q=jnp.stack(qs), scale=jnp.stack(ss),
                               mode=mode, group_size=group_size)

    ks = jax.random.split(key, 7)
    dtype = config.dtype
    lm_q, lm_s = qdummy(ks[5], Hd, (config.vocab_size,))
    layers = {
        "attn_norm": jnp.ones((L, Hd), dtype),
        "wqkv": qstack(ks[1], Hd, (config.qkv_size,)),
        "wo": qstack(ks[2], config.q_size, (Hd,)),
        "ffn_norm": jnp.ones((L, Hd), dtype),
        "w_gate_up": qstack(ks[3], Hd, (2, config.intermediate_size)),
        "w_down": qstack(ks[4], config.intermediate_size, (Hd,)),
    }
    if config.attention_bias:   # bias stays unquantized (tiny)
        layers["bqkv"] = (jax.random.normal(
            ks[6], (L, config.qkv_size), jnp.float32) * scale).astype(dtype)
    return {
        "embed": (jax.random.normal(ks[0], (config.vocab_size, Hd),
                                    jnp.float32) * scale).astype(dtype),
        "layers": layers,
        "final_norm": jnp.ones((Hd,), dtype),
        "lm_head": QuantizedTensor(q=lm_q, scale=lm_s, mode=mode,
                                   group_size=group_size),
    }


def quantize_params(params: Params, mode: str = "int8",
                    group_size: int = 128,
                    quantize_lm_head: bool = True) -> Params:
    """Quantize every matmul weight (stacked per-layer: quantized layer by
    layer, scales stacked on the same leading axis)."""
    if mode in ("none", None, ""):
        return params
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    layers = dict(params["layers"])
    for name in _QUANT_KEYS:
        w = layers[name]  # [L, in, out] (or [L, in, 2, I] for gate_up)
        structured = w.ndim == 4  # keep the (2, I) out structure so TP
        if structured:            # sharding splits I, not the packed 2I axis
            w = w.reshape(w.shape[0], w.shape[1], -1)
        qs, ss = [], []
        for l in range(w.shape[0]):
            t = quantize_tensor(w[l], mode, group_size)
            q, s = t.q, t.scale
            if structured:
                # stacked-quantized layout [2, in', I] (the 2-axis leads so
                # the layer-prefetch matmul kernel's blocks stay legal —
                # ops/quant.py stacked path)
                q = q.reshape(q.shape[0], 2, -1).transpose(1, 0, 2)
                s = s.reshape(s.shape[0], 2, -1).transpose(1, 0, 2)
            qs.append(q)
            ss.append(s)
        layers[name] = QuantizedTensor(
            q=jnp.stack(qs), scale=jnp.stack(ss), mode=mode,
            group_size=group_size)
    out["layers"] = layers
    if quantize_lm_head:
        out["lm_head"] = quantize_tensor(params["lm_head"], mode, group_size)
    else:
        out["lm_head"] = params["lm_head"]
    return out


#: tap dump name -> the matmul whose INPUT it is (models/llama._layer_step)
_CAL_TAPS = {"attn_norm": "wqkv", "attn_ctx": "wo",
             "ffn_in": "w_gate_up", "ffn_act": "w_down"}


def calibrate_act_sq(config, params: Params, token_batches,
                     engine_config=None) -> dict:
    """Per-input-dim activation second moments for calibration-aware
    quantization (ops.quant.search_clip).

    Runs the REAL fp forward (models/llama.py) teacher-forced over
    ``token_batches`` (a list of [B, T] int32 arrays) with the debug tap
    capturing every matmul's input, and returns
    ``{"wqkv"|"wo"|"w_gate_up"|"w_down": [L, in] f32}`` — E[x_i^2] per
    layer per input dimension. Host-callback based, so it needs a backend
    with callback support (CPU — where the offline quantizer (-m llm_inference_engine.tools.quantize) runs anyway).
    """
    import tempfile

    import numpy as _np

    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models import llama as _llama
    from llm_inference_engine.ops import kv_cache as _kvc
    from llm_inference_engine.utils import debug as _debug

    L = config.num_layers
    token_batches = [_np.asarray(t, _np.int32) for t in token_batches]
    maxT = max(t.shape[1] for t in token_batches)
    maxB = max(t.shape[0] for t in token_batches)
    eng = engine_config or EngineConfig(
        max_batch_size=maxB, max_seq_len=max(2 * maxT, 64))

    sums = {m: _np.zeros((L, d), _np.float64) for m, d in {
        "wqkv": config.hidden_size, "wo": config.q_size,
        "w_gate_up": config.hidden_size,
        "w_down": config.intermediate_size}.items()}
    counts = {m: _np.zeros((L,), _np.float64) for m in sums}

    prev = _debug.tap
    tmp = tempfile.mkdtemp(prefix="llm_engine_cal_")
    _debug.set_dump_dir(tmp, max_layers=L)
    try:
        if not _debug.tap.enabled:
            raise RuntimeError(
                "calibration needs host-callback support (run on CPU: "
                "JAX_PLATFORMS=cpu, or the quantizer CLI with --platform cpu)")
        for tb in token_batches:
            B, T = tb.shape
            cache = _kvc.new_kv_cache(L, B, config.num_kv_heads,
                                      eng.max_seq_len, config.head_dim,
                                      dtype=config.dtype,
                                      pad_to_tiles=False)
            q0 = jnp.zeros((B,), jnp.int32)
            kv = jnp.full((B,), T, jnp.int32)
            hidden, _ = _llama.decoder_forward(
                config, eng, params, jnp.asarray(tb), cache, q0, kv)
            hidden.block_until_ready()
            # drain this batch's dumps into the running moments
            for f in sorted(os.listdir(tmp)):
                if not f.endswith(".npy"):
                    continue
                suffix = f.split("_", 1)[1]          # L{li}_{name}.npy
                if not suffix.startswith("L"):
                    os.unlink(os.path.join(tmp, f))
                    continue
                li_s, name = suffix[1:-4].split("_", 1)
                mm = _CAL_TAPS.get(name)
                li = int(li_s)
                if mm is not None and li < L:
                    x = _np.load(os.path.join(tmp, f)).astype(_np.float64)
                    x2 = x.reshape(-1, x.shape[-1])
                    sums[mm][li] += (x2 ** 2).sum(axis=0)
                    counts[mm][li] += x2.shape[0]
                os.unlink(os.path.join(tmp, f))
    finally:
        _debug.tap = prev
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    out = {}
    for mm, s in sums.items():
        c = _np.maximum(counts[mm], 1.0)[:, None]
        out[mm] = jnp.asarray((s / c).astype(_np.float32))
    return out


def quantize_params_calibrated(params: Params, act_sq: dict,
                               mode: str = "int8", group_size: int = 128,
                               quantize_lm_head: bool = True) -> Params:
    """quantize_params with calibration-aware clip search (AWQ-lite,
    ops.quant.search_clip): per-scale-block clip factors minimize the
    activation-weighted weight error using ``act_sq`` from
    :func:`calibrate_act_sq`. Output format is IDENTICAL to
    quantize_params — only q/scales differ, so every runtime kernel and
    loader works unchanged."""
    from llm_inference_engine.ops.quant import search_clip
    if mode in ("none", None, ""):
        return params
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    layers = dict(params["layers"])
    for name in _QUANT_KEYS:
        w = layers[name]
        structured = w.ndim == 4
        if structured:
            w = w.reshape(w.shape[0], w.shape[1], -1)
        d_l = act_sq.get(name)
        qs, ss = [], []
        for l in range(w.shape[0]):
            clip = search_clip(w[l], mode, group_size,
                               act_sq=None if d_l is None else d_l[l])
            t = quantize_tensor(w[l], mode, group_size, clip=clip)
            q, s = t.q, t.scale
            if structured:
                q = q.reshape(q.shape[0], 2, -1).transpose(1, 0, 2)
                s = s.reshape(s.shape[0], 2, -1).transpose(1, 0, 2)
            qs.append(q)
            ss.append(s)
        layers[name] = QuantizedTensor(
            q=jnp.stack(qs), scale=jnp.stack(ss), mode=mode,
            group_size=group_size)
    out["layers"] = layers
    if quantize_lm_head:
        # no tap point for the lm head input (final_norm output); plain
        # MSE clip search still beats RTN there
        from llm_inference_engine.ops.quant import search_clip as _sc
        clip = _sc(params["lm_head"], mode, group_size)
        out["lm_head"] = quantize_tensor(params["lm_head"], mode,
                                         group_size, clip=clip)
    else:
        out["lm_head"] = params["lm_head"]
    return out


def save_params(params: Params, path: str) -> None:
    """Write a params pytree (quantized or not) to one ``.npz`` file.

    The reference never had a save path (its tokenizer file comment points
    at an export script, torch2flm.py, that is not in its tree —
    tokenizer.h:137); here quantize-once/serve-many is first-class:
    ``save_params(quantize_params(load_hf_safetensors(...), "int4"), p)``
    then ``load_saved_params(p)`` skips both the fp16 materialization and
    the on-device quantization pass at every engine start.

    bfloat16 leaves are stored as uint16 bit patterns (npz has no bf16);
    QuantizedTensor leaves store q/scale plus their static metadata.
    """
    import json

    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {"format": 1, "leaves": {}}

    def put(prefix: str, v) -> None:
        if isinstance(v, QuantizedTensor):
            arrays[prefix + ".q"] = np.asarray(v.q)
            arrays[prefix + ".scale"] = np.asarray(v.scale)
            meta["leaves"][prefix] = {"kind": "quant", "mode": v.mode,
                                      "group_size": v.group_size}
        else:
            a = np.asarray(v)
            if a.dtype == jnp.bfloat16:
                arrays[prefix] = a.view(np.uint16)
                meta["leaves"][prefix] = {"kind": "bf16"}
            else:
                arrays[prefix] = a
                meta["leaves"][prefix] = {"kind": "raw"}

    put("embed", params["embed"])
    for name, v in params["layers"].items():
        put("layers." + name, v)
    put("final_norm", params["final_norm"])
    put("lm_head", params["lm_head"])
    np.savez(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), np.uint8), **arrays)


def load_saved_params(path: str, device: bool = True) -> Params:
    """Load a ``save_params`` checkpoint back into a params pytree
    (QuantizedTensor leaves restored with their mode/group metadata)."""
    import json

    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("format") != 1:
        raise ValueError(f"unknown checkpoint format {meta.get('format')!r}")

    def dev(a):
        return jnp.asarray(a) if device else a

    def get(prefix: str):
        info = meta["leaves"][prefix]
        if info["kind"] == "quant":
            return QuantizedTensor(
                q=dev(z[prefix + ".q"]), scale=dev(z[prefix + ".scale"]),
                mode=info["mode"], group_size=info["group_size"])
        a = z[prefix]
        if info["kind"] == "bf16":
            a = a.view(jnp.bfloat16)
        return dev(a)

    layer_names = sorted(
        {k.split(".")[1] for k in meta["leaves"] if k.startswith("layers.")})
    return {
        "embed": get("embed"),
        "layers": {n: get("layers." + n) for n in layer_names},
        "final_norm": get("final_norm"),
        "lm_head": get("lm_head"),
    }


def param_count(params: Params) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))


def param_bytes(params: Params) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(params))


# ---------------------------------------------------------------------------
# HF checkpoint loading (safetensors)
# ---------------------------------------------------------------------------

def _hf_tensor_reader(path: str) -> Callable[[str], np.ndarray]:
    """Returns name -> np.ndarray over all *.safetensors files in a dir.

    Uses the native C++ loader (csrc/weight_loader.cc: parallel pread +
    threaded cast/transpose) — the host-side equivalent of the reference's
    C++ weight loader (weight_utils.cu:132-229). ``read(name,
    transpose=True, dtype=...)`` fuses the [out, in] -> [in, out]
    canonicalization and dtype cast into the native read."""
    from llm_inference_engine.runtime.native_io import SafeTensorsFile

    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    index: dict[str, SafeTensorsFile] = {}
    for f in files:
        sf = SafeTensorsFile(f)
        for name in sf.names:
            index[name] = sf

    def read(name: str, dtype=None, transpose: bool = False) -> np.ndarray:
        return index[name].get(name, dtype=dtype, transpose=transpose)

    read.names = set(index)  # type: ignore[attr-defined]
    return read


def load_hf_safetensors(config: ModelConfig, path: str,
                        dtype: Any = None) -> Params:
    """Load a HF-format Llama checkpoint directory into the fused layout.

    Performs the fusions the reference's export script performed offline
    (q|k|v -> packed qkv, gate|up -> packed gate_up; layer_weights.cpp:28,43
    assumes pre-fused files) and the [out,in] -> [in,out] transpose.
    """
    dtype = dtype or config.dtype
    read = _hf_tensor_reader(path)
    names = read.names

    def get(name: str) -> np.ndarray:
        return read(name, dtype=np.float32)

    def linear_w(name: str) -> np.ndarray:
        # HF [out, in] -> [in, out], transposed+cast in native threads
        return read(name, dtype=np.float32, transpose=True)

    L = config.num_layers
    wqkv, wo, wgu, wdn, anorm, fnorm = [], [], [], [], [], []
    bqkv = []
    has_bias = "model.layers.0.self_attn.q_proj.bias" in names
    for l in range(L):
        p = f"model.layers.{l}."
        q = linear_w(p + "self_attn.q_proj.weight")
        k = linear_w(p + "self_attn.k_proj.weight")
        v = linear_w(p + "self_attn.v_proj.weight")
        wqkv.append(fuse_qkv(q, k, v, config.num_heads, config.num_kv_heads,
                             config.head_dim))
        if has_bias:
            # Qwen2-class qkv bias, packed with the same group-major fusion
            bqkv.append(fuse_qkv(
                get(p + "self_attn.q_proj.bias")[None],
                get(p + "self_attn.k_proj.bias")[None],
                get(p + "self_attn.v_proj.bias")[None],
                config.num_heads, config.num_kv_heads, config.head_dim)[0])
        wo.append(linear_w(p + "self_attn.o_proj.weight"))
        g = linear_w(p + "mlp.gate_proj.weight")
        u = linear_w(p + "mlp.up_proj.weight")
        wgu.append(fuse_gate_up(g, u))
        wdn.append(linear_w(p + "mlp.down_proj.weight"))
        anorm.append(get(p + "input_layernorm.weight"))
        fnorm.append(get(p + "post_attention_layernorm.weight"))

    embed = get("model.embed_tokens.weight")
    if "lm_head.weight" in names:
        lm_head = linear_w("lm_head.weight")
    else:  # tied embeddings
        lm_head = embed.T.copy()

    def dev(x):
        return jnp.asarray(np.stack(x) if isinstance(x, list) else x, dtype)

    layers = {
        "attn_norm": dev(anorm),
        "wqkv": dev(wqkv),
        "wo": dev(wo),
        "ffn_norm": dev(fnorm),
        "w_gate_up": dev(wgu),
        "w_down": dev(wdn),
    }
    if has_bias:
        layers["bqkv"] = dev(bqkv)
    return {
        "embed": dev(embed),
        "layers": layers,
        "final_norm": dev(get("model.norm.weight")),
        "lm_head": dev(lm_head),
    }


# ---------------------------------------------------------------------------
# Reference .bin checkpoint loading
# ---------------------------------------------------------------------------

def load_reference_bin(config: ModelConfig, path: str,
                       dtype: Any = None) -> Params:
    """Load the reference engine's own checkpoint format: one raw
    little-endian f32/f16 .bin per tensor with HF-style names
    (reference: llama_weights.cpp:50-75, layer_weights.cpp:64-69 —
    e.g. model.layers.0.self_attn.qkv.weight.bin). QKV and gate_up are
    already fused in that format."""
    dtype = dtype or config.dtype

    def rd(name: str, shape) -> np.ndarray:
        fn = os.path.join(path, name + ".bin")
        expected = int(np.prod(shape)) * 4
        if os.path.getsize(fn) != expected:
            raise ValueError(f"{fn}: expected {expected} bytes "
                             f"({shape} f32), got {os.path.getsize(fn)}")
        from llm_inference_engine.runtime.native_io import read_bin_tensor
        return read_bin_tensor(fn, shape, "float32")

    Hd, L = config.hidden_size, config.num_layers
    layers: dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "ffn_norm", "w_gate_up", "w_down")}
    for l in range(L):
        p = f"model.layers.{l}."
        # reference stores [out, in] row-major ([q|k|v] / [gate|up] packed)
        # and GEMMs with a transpose trick; canonicalize to [in, out] and
        # re-pack to the group-major / stacked layouts
        qkv = rd(p + "self_attn.qkv.weight", (config.qkv_size, Hd)).T
        layers["wqkv"].append(fuse_qkv(
            qkv[:, :config.q_size],
            qkv[:, config.q_size:config.q_size + config.kv_size],
            qkv[:, config.q_size + config.kv_size:],
            config.num_heads, config.num_kv_heads, config.head_dim))
        layers["wo"].append(rd(p + "self_attn.o_proj.weight",
                               (Hd, config.q_size)).T)
        gu = rd(p + "mlp.gate_up_proj.weight",
                (2 * config.intermediate_size, Hd)).T
        I = config.intermediate_size
        layers["w_gate_up"].append(fuse_gate_up(gu[:, :I], gu[:, I:]))
        layers["w_down"].append(rd(p + "mlp.down_proj.weight",
                                   (Hd, config.intermediate_size)).T)
        layers["attn_norm"].append(rd(p + "input_layernorm.weight", (Hd,)))
        layers["ffn_norm"].append(rd(p + "post_attention_layernorm.weight", (Hd,)))

    def dev(x):
        return jnp.asarray(np.stack(x) if isinstance(x, list) else x, dtype)

    return {
        "embed": dev(rd("model.embed_tokens.weight", (config.vocab_size, Hd))),
        "layers": {k: dev(v) for k, v in layers.items()},
        "final_norm": dev(rd("model.norm.weight", (Hd,))),
        "lm_head": dev(rd("lm_head.weight", (config.vocab_size, Hd)).T),
    }
