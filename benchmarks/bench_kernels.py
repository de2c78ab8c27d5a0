"""Kernel decisions on the card: each hot op's plain XLA version against its
GPU kernel candidate, alone at Llama-2-7B widths, then inside the engine's
7B int4 decode step (batch 8) and a 512-token prefill chunk.

    python benchmarks/bench_kernels.py [--out chiprun_out/bench_kernels.json]

Candidates: the repository's int4 matmul kernel (ops/quant.py, Pallas
through Triton); JAX's library kernels for RMSNorm, decode attention and
paged attention (jax/experimental/pallas/ops/gpu, Triton route);
``jax.nn.dot_product_attention(implementation="cudnn")`` for prefill; a
minimal SwiGLU kernel written here. Alone, times are host wall clock around
back-to-back dispatches ending in ``block_until_ready``, median of 5
windows; below ~20 us per call they include dispatch. In the engine, each
candidate replaces its op in the model (``swaps`` in ``in_situ``) and the
step is timed whole; the shipped routing runs first and last, to show the
drift between runs. Every line names the card and its power limit. Needs
a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from device_peaks import card_identity, require_gpu

RESULTS: list[dict] = []
_CARD = [""]


def record(op: str, variant: str, seconds, note: str = "") -> None:
    RESULTS.append({"op": op, "variant": variant, "seconds": seconds,
                    "note": note})
    t = "failed" if seconds is None else f"{seconds * 1e6:.1f} us"
    print(f"[{_CARD[0]}] {op} | {variant}: {t} {note}", flush=True)


def timeit(fn, *args, iters: int = 20, reps: int = 5) -> float:
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / iters)
    return float(np.median(ts))


def attempt(op, variant, fn, *args, note="", **kw):
    try:
        record(op, variant, timeit(fn, *args, **kw), note)
    except Exception as e:  # noqa: BLE001 — a refused candidate is a finding
        traceback.print_exc()
        record(op, variant, None, f"{type(e).__name__}: {str(e)[:300]}")


def bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


# ---------------------------------------------------------------------------
# candidate kernels
# ---------------------------------------------------------------------------

def _swiglu_kernel(g_ref, u_ref, o_ref, *, n, bn):
    from jax.experimental.pallas import triton as plgpu
    from jax.experimental import pallas as pl
    i, j = pl.program_id(0), pl.program_id(1)
    cols = j * bn + jnp.arange(bn)
    mask = cols < n
    g = plgpu.load(g_ref.at[i, pl.ds(j * bn, bn)], mask=mask,
                   other=0.0).astype(jnp.float32)
    u = plgpu.load(u_ref.at[i, pl.ds(j * bn, bn)], mask=mask,
                   other=0.0).astype(jnp.float32)
    plgpu.store(o_ref.at[i, pl.ds(j * bn, bn)],
                (g * jax.nn.sigmoid(g) * u).astype(o_ref.dtype), mask=mask)


@jax.jit
def swiglu_triton(gate_up):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    m, two_i = gate_up.shape
    n, bn = two_i // 2, 1024
    return pl.pallas_call(
        functools.partial(_swiglu_kernel, n=n, bn=bn),
        out_shape=jax.ShapeDtypeStruct((m, n), gate_up.dtype),
        grid=(m, -(-n // bn)),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        name="swiglu",
    )(gate_up[:, :n], gate_up[:, n:])


def library_attention(q, k_cache, v_cache, q_start, kv_len, *, causal=True,
                      sm_scale=None, k_scale=None, v_scale=None, layer=None,
                      kv_hi=None, embedded_kv=False, window=None, table=None):
    """Drop-in for ops.attention.attention on a bf16 stacked slot cache:
    JAX's library decode kernel (Triton) at T == 1, cuDNN fused attention
    with a mask for prefill chunks."""
    from jax.experimental.pallas.ops.gpu import decode_attention
    from llm_inference_engine.ops.attention import _valid_mask
    assert table is None and k_scale is None and not embedded_kv
    B, T, H, D = q.shape
    L, _, S, K, _ = k_cache.shape
    rows = S if kv_hi is None else min(S, kv_hi)
    k = jax.lax.dynamic_slice(k_cache, (layer, 0, 0, 0, 0),
                              (1, B, rows, K, D))[0]
    v = jax.lax.dynamic_slice(v_cache, (layer, 0, 0, 0, 0),
                              (1, B, rows, K, D))[0]
    scale = sm_scale or 1.0 / math.sqrt(D)
    if T == 1:
        # the Triton lowering takes power-of-two blocks only: the rows
        # (a multiple of the engine's 256-row watermark) split in 256s
        splits = rows // 256 if rows % 256 == 0 else 16
        out = decode_attention.gqa(q[:, 0], k, v, kv_seq_len=kv_len,
                                   sm_scale=scale, k_splits=splits)
        return out[:, None].astype(q.dtype)
    mask = _valid_mask(q_start, kv_len, T, rows, causal, window)
    return jax.nn.dot_product_attention(
        q, k, v, mask=mask[:, None], scale=scale,
        implementation="cudnn").astype(q.dtype)


def library_rmsnorm(x, weight, eps=1e-5):
    """Drop-in for ops.rmsnorm.rmsnorm on [B, T, H]: JAX's library Triton
    RMSNorm."""
    from jax.experimental.pallas.ops.gpu import rms_norm as lib_rms
    return lib_rms.rms_norm(x, weight, jnp.zeros_like(weight), eps=eps)


def library_add_rmsnorm(x, residual, weight, eps=1e-5):
    """Drop-in for ops.rmsnorm.add_residual_rmsnorm: the add in XLA, the
    norm in the library kernel."""
    h = (x.astype(jnp.float32) + residual.astype(jnp.float32)).astype(x.dtype)
    return library_rmsnorm(h, weight, eps), h


def triton_silu_and_mul(gate_up):
    """Drop-in for ops.activations.silu_and_mul on [..., 2I]."""
    lead = gate_up.shape[:-1]
    out = swiglu_triton(gate_up.reshape(-1, gate_up.shape[-1]))
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# isolated ops
# ---------------------------------------------------------------------------

def isolated(cfg, rng):
    from jax.experimental.pallas.ops.gpu import decode_attention
    from jax.experimental.pallas.ops.gpu import paged_attention
    from jax.experimental.pallas.ops.gpu import rms_norm as lib_rms
    from llm_inference_engine.ops import kv_cache as kvc
    from llm_inference_engine.ops.activations import silu_and_mul
    from llm_inference_engine.ops.attention import attention
    from llm_inference_engine.ops.quant import (
        QuantizedTensor, int4_matmul_kernel, quantize_tensor,
        quantized_linear)
    from llm_inference_engine.ops.rmsnorm import rmsnorm

    Hd, I, H, K, D = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    w = bf16(rng, (Hd,))
    for m in (8, 512):
        x = bf16(rng, (m, Hd))
        attempt(f"rmsnorm [{m},{Hd}]", "plain XLA", jax.jit(rmsnorm), x, w)
        attempt(f"rmsnorm [{m},{Hd}]", "library Triton rms_norm",
                jax.jit(lambda x, w: lib_rms.rms_norm(
                    x[None], w, jnp.zeros_like(w))), x, w)
        gu = bf16(rng, (m, 2 * I))
        attempt(f"silu_and_mul [{m},{2 * I}]", "plain XLA",
                jax.jit(silu_and_mul), gu)
        attempt(f"silu_and_mul [{m},{2 * I}]", "Triton kernel",
                swiglu_triton, gu)

    # quantized matmuls: stacked [L, ...] weights indexed by layer, as the
    # model calls them
    L = 4
    for name, k_in, n in (("wqkv", Hd, cfg.qkv_size), ("wo", cfg.q_size, Hd),
                          ("w_gate_up", Hd, 2 * I), ("w_down", I, Hd)):
        for mode in ("int8", "int4"):
            ts = [quantize_tensor(bf16(rng, (k_in, n), 0.02), mode, 128)
                  for _ in range(L)]
            st = QuantizedTensor(q=jnp.stack([t.q for t in ts]),
                                 scale=jnp.stack([t.scale for t in ts]),
                                 mode=mode, group_size=128)
            del ts
            wbytes = st.q.nbytes // L + st.scale.nbytes // L
            for m in (8, 512):
                x = bf16(rng, (m, k_in))
                op = f"{mode} matmul {name} m={m} k={k_in} n={n}"
                attempt(op, "plain XLA",
                        jax.jit(lambda x, st: quantized_linear(
                            x, st, layer=jnp.int32(2))), x, st,
                        note=f"weight bytes {wbytes}")
                if mode == "int4":
                    attempt(op, "int4 Triton kernel",
                            jax.jit(lambda x, st: int4_matmul_kernel(
                                x, st.q, st.scale, jnp.int32(2), 128)),
                            x, st)
            del st
    dense = bf16(rng, (Hd, 2 * I), 0.02)
    for m in (8, 512):
        x = bf16(rng, (m, Hd))
        attempt(f"bf16 dense matmul m={m} k={Hd} n={2 * I}", "plain XLA",
                jax.jit(lambda x, w: jnp.dot(
                    x, w, preferred_element_type=jnp.float32)), x, dense,
                note=f"weight bytes {dense.nbytes}")
    del dense

    # KV cache write into the full 7B cache (bs 8 x 2048), donated
    Lc, B, S = cfg.num_layers, 8, 2048
    cache = kvc.new_kv_cache(Lc, B, K, S, D)
    write = jax.jit(kvc.update_cache_at_layer, donate_argnums=0)
    for T, nl in ((1, 1), (512, 512)):
        nk = bf16(rng, (B, T, K, D))
        starts = jnp.full((B,), 700, jnp.int32)
        nlen = jnp.full((B,), nl, jnp.int32)
        try:
            cache = write(cache, jnp.int32(3), nk, nk, starts, nlen)
            jax.block_until_ready(cache)
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(20):
                    cache = write(cache, jnp.int32(3), nk, nk, starts, nlen)
                jax.block_until_ready(cache)
                ts.append((time.perf_counter() - t0) / 20)
            record(f"slot KV write B={B} T={T} (one layer, cache "
                   f"{cache.k.nbytes * 2} bytes)", "plain XLA scatter",
                   float(np.median(ts)))
        except Exception as e:  # noqa: BLE001
            record(f"slot KV write T={T}", "plain XLA scatter", None, str(e))

    # decode attention: bs 8, contexts up to kv_hi, stacked cache
    ly = jnp.int32(3)
    for kv_hi in (512, 2048):
        ctx = jnp.asarray(np.linspace(kv_hi // 2, kv_hi, B).astype(np.int32))
        q = bf16(rng, (B, 1, H, D))
        op = f"decode attention B={B} H={H} K={K} kv_hi={kv_hi}"
        attempt(op, "plain XLA",
                jax.jit(functools.partial(attention, kv_hi=kv_hi, layer=ly)),
                q, cache.k, cache.v, ctx - 1, ctx)
        attempt(op, "library Triton decode_attention.gqa (+layer slice)",
                jax.jit(functools.partial(library_attention, kv_hi=kv_hi,
                                          layer=ly)),
                q, cache.k, cache.v, ctx - 1, ctx)
        k1 = cache.k[3, :, :kv_hi]
        v1 = cache.v[3, :, :kv_hi]
        attempt(op, "library Triton decode_attention.gqa (kernel alone)",
                jax.jit(lambda q, k, v, kl: decode_attention.gqa(
                    q[:, 0], k, v, kv_seq_len=kl)), q, k1, v1, ctx)
        del k1, v1
    # prefill chunk: 512 queries over 1024 rows of history + chunk
    T, qs = 512, 512
    qp = bf16(rng, (1, T, H, D))
    qsa, kla = jnp.asarray([qs], jnp.int32), jnp.asarray([qs + T], jnp.int32)
    op = f"prefill attention T={T} q_start={qs} H={H} K={K}"
    c1 = dataclasses.replace(cache, k=cache.k[:, :1], v=cache.v[:, :1])
    attempt(op, "plain XLA",
            jax.jit(functools.partial(attention, kv_hi=1024, layer=ly)),
            qp, c1.k, c1.v, qsa, kla)
    attempt(op, "cuDNN dot_product_attention (mask)",
            jax.jit(functools.partial(library_attention, kv_hi=1024,
                                      layer=ly)),
            qp, c1.k, c1.v, qsa, kla)
    del cache, c1

    # paged decode: the pool in its own layout vs the library kernel on a
    # pool already in its [K, pages, page, D] layout (kernel alone)
    page, maxp = 64, 2048 // 64
    P = B * maxp + 1
    pool_k = bf16(rng, (4, P, page, K, D))
    pool_v = bf16(rng, (4, P, page, K, D))
    table = jnp.asarray(rng.permutation(np.arange(1, P)).reshape(B, maxp),
                        jnp.int32)
    ctx = jnp.asarray(np.linspace(512, 1024, B).astype(np.int32))
    q = bf16(rng, (B, 1, H, D))
    op = f"paged decode attention B={B} page={page} kv_hi=1024"
    attempt(op, "plain XLA (gather up to kv_hi)",
            jax.jit(lambda q, k, v, qs, kl, t: attention(
                q, k, v, qs, kl, kv_hi=1024, layer=jnp.int32(2), table=t)),
            q, pool_k, pool_v, ctx - 1, ctx, table)
    kp = jnp.transpose(pool_k[2], (2, 0, 1, 3))
    vp = jnp.transpose(pool_v[2], (2, 0, 1, 3))
    attempt(op, "library Triton paged_attention (kernel alone)",
            jax.jit(lambda q, k, v, t, l: paged_attention.paged_attention(
                q[:, 0], k, v, t, l)), q, kp, vp, table[:, :1024 // page], ctx)


# ---------------------------------------------------------------------------
# inside the engine
# ---------------------------------------------------------------------------

def in_situ(cfg, variants, steps: int = 64):
    """Per variant: a fresh engine (7B int4, bs 8, max_seq 2048); time one
    prefill call of 8 x 512 tokens and a device-side greedy rollout."""
    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models import llama as M
    from llm_inference_engine.models.weights import (
        init_dummy_quantized_params)
    from llm_inference_engine.ops import quant as Q
    from llm_inference_engine.runtime.engine import InferenceEngine

    params = init_dummy_quantized_params(cfg, "int4", 128, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, size=512).tolist()
               for _ in range(8)]
    from llm_inference_engine.ops import attention as A
    shipped = {n: getattr(M, n) for n in ("attention", "rmsnorm",
                                          "add_residual_rmsnorm",
                                          "silu_and_mul")}
    swaps = {"library decode attention": {"attention": library_attention},
             "library RMSNorm": {"rmsnorm": library_rmsnorm,
                                 "add_residual_rmsnorm": library_add_rmsnorm},
             "Triton SwiGLU": {"silu_and_mul": triton_silu_and_mul}}
    shipped_cudnn = A._use_cudnn
    out = {}
    for name in variants:
        # "plain XLA": every op plain; "int4 kernel at every size"; the
        # shipped routing; the shipped routing with one op swapped for its
        # GPU kernel candidate (``swaps``)
        Q.INT4_KERNEL_MAX_ROWS = {"plain XLA": 0,
                                  "int4 kernel at every size": 1 << 30
                                  }.get(name, 64)
        A._use_cudnn = (shipped_cudnn if name != "plain XLA"
                        else lambda q: False)
        for n, fn in dict(shipped, **swaps.get(name, {})).items():
            setattr(M, n, fn)
        try:
            eng = InferenceEngine(cfg, EngineConfig(
                max_batch_size=8, max_seq_len=2048, quant_mode="int4"),
                params)
            t0 = time.perf_counter()
            logits = eng.prefill(prompts)
            jax.block_until_ready(logits)
            t_compile = time.perf_counter() - t0
            ts = []
            for _ in range(3):
                eng.reset()
                t0 = time.perf_counter()
                logits = eng.prefill(prompts)
                jax.block_until_ready(logits)
                ts.append(time.perf_counter() - t0)
            record("engine prefill 8 x 512 tokens (7B int4)", name,
                   float(np.median(ts)),
                   f"first call incl. compile {t_compile:.1f}s")
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            kv_hi = eng._kv_watermark(np.full((8,), 512), steps)

            def rollout():
                eng.cache = dataclasses.replace(
                    eng.cache, lengths=jnp.full((8,), 512, jnp.int32))
                toks, eng.cache = eng._rollout_fn(eng.params, eng.cache,
                                                  tok, steps, kv_hi=kv_hi)
                return np.asarray(toks[-1])
            rollout()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                rollout()
                ts.append((time.perf_counter() - t0) / steps)
            record(f"engine decode step (7B int4, bs 8, ctx 512..{512 + steps})",
                   name, float(np.median(ts)))
            out[name] = ts
            del eng
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            record("engine", name, None, f"{type(e).__name__}: {e}")
    Q.INT4_KERNEL_MAX_ROWS = 64
    A._use_cudnn = shipped_cudnn
    for n, fn in shipped.items():
        setattr(M, n, fn)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-isolated", action="store_true")
    args = ap.parse_args()
    device = require_gpu()
    ident = card_identity(device)
    _CARD[0] = f"{ident['kind']} | {ident['nvidia_smi']}"
    from llm_inference_engine.config import get_config
    from llm_inference_engine.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    cfg = get_config("llama2-7b")
    rng = np.random.default_rng(0)
    if not args.skip_isolated:
        isolated(cfg, rng)
    in_situ(cfg, ["plain XLA", "int4 kernel at every size", "shipped",
                  "library decode attention", "library RMSNorm",
                  "Triton SwiGLU", "shipped, again"])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": ident, "results": RESULTS}, f, indent=1)


if __name__ == "__main__":
    main()
