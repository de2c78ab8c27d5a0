#!/usr/bin/env python3
"""On-card smoke test: the engine's main path on one NVIDIA GPU, at full
model width, checked against float32 references.

    python chip_smoke.py          # phases A-D on one card
    python chip_smoke.py --four   # tp=4, dp=4, cp=4 at llama2-13b widths on
                                  # four cards, each against one card
                                  # (float32, 10 of the 40 layers); then
                                  # tp=4 with int4 weights against one card
                                  # and the float32 reference

Phases (every line names the card; any failed check fails the run):

A. Device: JAX must report a GPU (never falls back to the CPU); prints the
   device kind and count and ``nvidia-smi``'s name and power limit.
B. Ops at Llama-2-7B widths (and Mistral-7B's GQA + sliding window): each
   production op as compiled for the card against its float32 reference at
   "highest" matmul precision, with max abs / max rel error beside the
   tolerance and its reason; the slot and paged KV writes bit-exact against
   a host reference write.
C. Model logits: prefill of two prompts then 16 greedy decode steps through
   the engine, against the float32 reference forward on the same seeded
   weights (models/reference.py): llama2-7b bf16, int8, int4, and int4
   with an int8 KV cache in the slot and the paged layout (the reference
   then rounds K and V as that cache stores them); mistral-7b bf16. Prints
   the relative L2 error of the logits and greedy agreement.
D. Serving: the HTTP server in-process on localhost (create_engine ->
   InferenceEngine -> ContinuousBatchingScheduler -> make_server), int4
   weights, bf16 KV, slot layout, batch 8, max_seq_len 2048: 8 concurrent
   completions of 32+ new tokens (one SSE stream, one chat request); then a
   shorter paged int8-KV run. The greedy completions' tokens are checked
   against the float32 reference forward (teacher-forced). Prints wall time
   with compile time apart and the decode step's
   ``compiled.memory_analysis()``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
It is printed only when every phase passed; otherwise the exit code is 1
(2 when no GPU is found).
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
_KIND = ["?"]


def log(msg: str) -> None:
    print(f"[{_KIND[0]}] {msg}", flush=True)


def require_gpu():
    """The JAX devices, if they are GPUs; otherwise exit with code 2 before
    any phase runs."""
    import jax
    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devs[0].platform if devs else 'none'!r}); refusing to run",
              file=sys.stderr)
        raise SystemExit(2)
    _KIND[0] = devs[0].device_kind
    return devs


def nvidia_smi() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def check(name: str, got, want, tol: float, reason: str) -> bool:
    """Print max abs error and max rel error (max |err| / max |ref|) beside
    the tolerance; a non-finite output fails."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    rel = err / max(float(np.abs(want).max()), 1e-30)
    ok = bool(np.isfinite(got).all()) and rel <= tol
    log(f"B {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"tol={tol:.1e} ({reason}) {'ok' if ok else 'FAIL'}")
    return ok


def check_exact(name: str, got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    same = got.shape == want.shape and bool(
        np.array_equal(got.view(np.uint8), want.view(np.uint8)))
    log(f"B {name}: bit-exact={'yes' if same else 'NO'} "
        f"{'ok' if same else 'FAIL'}")
    return same


# ---------------------------------------------------------------------------
# Phase B: ops at real widths
# ---------------------------------------------------------------------------

BF16_OUT = (2.0 ** -7, "output rounded once to bf16")
QMM_TOL = (2.0 ** -6, "bf16 activations, f32 accumulation; up to one bf16 "
           "ulp each from the int4 scale folded into the weight and the "
           "bf16 output")
ATTN_TOL = (2e-2, "bf16 q/k/v and bf16 softmax weights into the p.v dot, "
            "f32 accumulation")


def phase_ops(cfg7, cfg_gqa, max_seq: int = 2048, batch: int = 8,
              chunk: int = 512, seq_gqa: int = 8192,
              layers: int = 2) -> bool:
    import jax
    import jax.numpy as jnp

    from llm_inference_engine.ops import kv_cache as kvc
    from llm_inference_engine.ops import paged_kv as pkv
    from llm_inference_engine.ops.activations import silu_and_mul
    from llm_inference_engine.ops.attention import attention, attention_ref
    from llm_inference_engine.ops.quant import (
        quantize_tensor, quantized_linear, quantized_linear_ref)
    from llm_inference_engine.ops.rmsnorm import add_residual_rmsnorm, rmsnorm
    from llm_inference_engine.ops.rope import apply_rope

    rng = np.random.default_rng(SEED)
    ok = True
    Hd, I, V = cfg7.hidden_size, cfg7.intermediate_size, cfg7.vocab_size
    H, K, D = cfg7.num_heads, cfg7.num_kv_heads, cfg7.head_dim

    def bf16(shape, scale=1.0):
        return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)

    def f32(x):
        return np.asarray(x, np.float32).astype(np.float64)

    # norms and activations
    x, r, w = bf16((chunk, Hd)), bf16((chunk, Hd)), bf16((Hd,), 0.5)
    xf, rf, wf = f32(x), f32(r), f32(w)

    def np_rms(v):
        return v / np.sqrt(np.mean(v * v, -1, keepdims=True) + 1e-5) * wf
    ok &= check(f"rmsnorm [{chunk},{Hd}]", jax.jit(rmsnorm)(x, w),
                np_rms(xf), *BF16_OUT)
    y, h = jax.jit(add_residual_rmsnorm)(x, r, w)
    hs = f32(jnp.asarray(xf + rf, jnp.bfloat16))
    ok &= check(f"add_rmsnorm.h [{chunk},{Hd}]", h, xf + rf, *BF16_OUT)
    ok &= check(f"add_rmsnorm.y [{chunk},{Hd}]", y, np_rms(hs), *BF16_OUT)
    gu = bf16((chunk, 2 * I))
    g, u = f32(gu)[:, :I], f32(gu)[:, I:]
    ok &= check(f"silu_and_mul [{chunk},{2 * I}]", jax.jit(silu_and_mul)(gu),
                g / (1 + np.exp(-g)) * u, *BF16_OUT)

    # rope at the end of the context window
    q = bf16((batch, chunk, H, D))
    pos = np.broadcast_to(np.arange(max_seq - chunk, max_seq), (batch, chunk))
    inv = 1.0 / cfg7.rope_theta ** (np.arange(D // 2) * 2.0 / D)
    ang = pos[..., None, None] * inv
    qf = f32(q)
    want = np.concatenate([qf[..., :D // 2] * np.cos(ang)
                           - qf[..., D // 2:] * np.sin(ang),
                           qf[..., D // 2:] * np.cos(ang)
                           + qf[..., :D // 2] * np.sin(ang)], -1)
    ok &= check(f"rope [{batch},{chunk},{H},{D}] pos<{max_seq}",
                jax.jit(apply_rope)(q, jnp.asarray(pos, jnp.int32)), want,
                *BF16_OUT)
    del q, gu

    # quantized matmuls: the four layer weights and the lm head
    qmm = jax.jit(quantized_linear, static_argnames=("out_dtype",))
    ref = jax.jit(quantized_linear_ref, static_argnames=("out_dtype",))
    shapes = [("wqkv", Hd, cfg7.qkv_size), ("wo", cfg7.q_size, Hd),
              ("w_gate_up", Hd, 2 * I), ("w_down", I, Hd), ("lm_head", Hd, V)]
    for mode in ("int8", "int4"):
        for name, k_in, n in shapes:
            t = quantize_tensor(bf16((k_in, n), 0.02), mode, 128)
            out_dt = jnp.float32 if name == "lm_head" else jnp.bfloat16
            for m in (8, chunk):
                xm = bf16((m, k_in))
                ok &= check(f"quantized_linear {mode} {name} "
                            f"m={m} k={k_in} n={n}",
                            qmm(xm, t, out_dtype=out_dt),
                            ref(xm, t, out_dtype=out_dt), *QMM_TOL)
            del t
    gc.collect()

    # the same matmuls as the model calls them: stacked [L, ...] weights
    # indexed by a traced layer, incl. the [L, 2, in, I] gate|up stack
    from llm_inference_engine.models.weights import quantize_params
    stk = jax.jit(lambda x, t, ly: quantized_linear(x, t, layer=ly))
    from llm_inference_engine.models.reference import _f32_weight
    ref_stk = jax.jit(lambda x, t, ly: jnp.dot(
        x.astype(jnp.float32), _f32_weight(jax.tree.map(lambda a: a[ly], t)),
        precision=jax.lax.Precision.HIGHEST), static_argnums=2)
    dense = {"wqkv": bf16((layers, Hd, cfg7.qkv_size), 0.02),
             "w_gate_up": bf16((layers, Hd, 2, I), 0.02)}
    for mode in ("int8", "int4"):
        qp = quantize_params({"embed": None, "final_norm": None,
                              "lm_head": None,
                              "layers": dict(dense, wo=dense["wqkv"][..., :Hd],
                                             w_down=dense["wqkv"][..., :Hd])},
                             mode, 128, quantize_lm_head=False)["layers"]
        for name in ("wqkv", "w_gate_up"):
            for m in (8, chunk):
                xm = bf16((m, Hd))
                ok &= check(f"quantized_linear {mode} stacked {name} "
                            f"L={layers} layer={layers - 1} m={m}",
                            stk(xm, qp[name], jnp.int32(layers - 1)),
                            ref_stk(xm, qp[name], layers - 1), *QMM_TOL)
        del qp
    del dense
    gc.collect()

    # decode attention: bs 8, ragged contexts, kv_hi < max_seq, stacked
    att = jax.jit(attention, static_argnames=("kv_hi", "embedded_kv",
                                              "window"))
    att_ref = jax.jit(attention_ref, static_argnames=("embedded_kv",
                                                      "window"))
    kv_hi = max_seq // 2
    kc = bf16((layers, batch, max_seq, K, D))
    vc = bf16((layers, batch, max_seq, K, D))
    ly = jnp.int32(layers - 1)
    ctx = np.linspace(1, kv_hi, batch).astype(np.int32)
    qd = bf16((batch, 1, H, D))
    kl = jnp.asarray(ctx)
    ok &= check(f"decode attention B={batch} H={H} K={K} ctx={ctx.tolist()} "
                f"kv_hi={kv_hi} max_seq={max_seq}",
                att(qd, kc, vc, kl - 1, kl, layer=ly, kv_hi=kv_hi),
                att_ref(qd, kc, vc, kl - 1, kl, layer=ly), *ATTN_TOL)
    # prefill chunk with history (q_start > 0)
    qp = bf16((2, chunk, H, D))
    qs = jnp.asarray([max_seq // 4 - 12, 17], jnp.int32)
    klp = qs + jnp.asarray([chunk, chunk // 2], jnp.int32)
    hi = int(-(-int(klp.max()) // 256) * 256)
    ok &= check(f"prefill attention T={chunk} q_start={qs.tolist()} "
                f"kv_hi={hi}",
                att(qp, kc[:, :2], vc[:, :2], qs, klp, layer=ly, kv_hi=hi),
                att_ref(qp, kc[:, :2], vc[:, :2], qs, klp, layer=ly),
                *ATTN_TOL)
    del kc, vc, qp
    gc.collect()

    # GQA + sliding window at Mistral-7B widths
    Kg, Hg, W = cfg_gqa.num_kv_heads, cfg_gqa.num_heads, cfg_gqa.sliding_window
    kg = bf16((4, seq_gqa, Kg, D))
    vg = bf16((4, seq_gqa, Kg, D))
    ctx_g = jnp.asarray([W // 2, W - 1, W + W // 2, seq_gqa - chunk // 2],
                        jnp.int32)
    qg = bf16((4, 1, Hg, D))
    ok &= check(f"GQA decode K={Kg} G={Hg // Kg} window={W} "
                f"ctx={np.asarray(ctx_g).tolist()}",
                att(qg, kg, vg, ctx_g - 1, ctx_g, window=W, kv_hi=seq_gqa),
                att_ref(qg, kg, vg, ctx_g - 1, ctx_g, window=W), *ATTN_TOL)
    qgp = bf16((1, chunk, Hg, D))
    qsg = jnp.asarray([W + chunk // 2], jnp.int32)
    ok &= check(f"GQA prefill K={Kg} window={W} T={chunk} "
                f"q_start={int(qsg[0])}",
                att(qgp, kg[:1], vg[:1], qsg, qsg + chunk, window=W,
                    kv_hi=seq_gqa),
                att_ref(qgp, kg[:1], vg[:1], qsg, qsg + chunk, window=W),
                *ATTN_TOL)
    del kg, vg
    gc.collect()

    # slot KV write, bit-exact against a host reference write: ragged
    # rows, a 0-row sequence, and a window that ends at the cache's last
    # row with only its first half valid (the rest must keep its rows)
    write = jax.jit(kvc.update_cache_at_layer, donate_argnums=0)
    cache = kvc.KVCache(bf16((layers, batch, max_seq, K, D)),
                        bf16((layers, batch, max_seq, K, D)),
                        jnp.zeros((batch,), jnp.int32))
    host_k, host_v = np.array(cache.k), np.array(cache.v)
    starts = np.array([0, 5, max_seq // 4, max_seq // 2, max_seq // 3, 0,
                       max_seq - chunk, max_seq - 2 * chunk][:batch],
                      np.int32)
    nlen = np.array([chunk, 1, chunk // 3, chunk, 0, 3, chunk // 2,
                     chunk][:batch], np.int32)
    nk, nv = bf16((batch, chunk, K, D)), bf16((batch, chunk, K, D))
    cache = write(cache, ly, nk, nv, jnp.asarray(starts), jnp.asarray(nlen))
    hk, hv = np.asarray(nk), np.asarray(nv)
    for b in range(batch):
        s0, n = starts[b], nlen[b]
        host_k[layers - 1, b, s0:s0 + n] = hk[b, :n]
        host_v[layers - 1, b, s0:s0 + n] = hv[b, :n]
    ok &= check_exact(f"slot KV write T={chunk} starts={starts.tolist()} "
                      f"new_len={nlen.tolist()}", cache.k, host_k)
    ok &= check_exact("slot KV write (v)", cache.v, host_v)
    del cache, host_k, host_v
    gc.collect()

    # int8 KV, separate scale planes: write then attend
    qc = kvc.new_kv_cache(layers, batch, K, max_seq, D, quantized=True)
    qc = write(qc, ly, bf16((batch, chunk, K, D)), bf16((batch, chunk, K, D)),
               jnp.zeros((batch,), jnp.int32),
               jnp.full((batch,), chunk, jnp.int32))
    ctx8 = jnp.asarray(np.linspace(1, chunk, batch).astype(np.int32))
    ok &= check(f"decode attention int8 KV (separate scales) B={batch}",
                jax.jit(attention, static_argnames=("kv_hi",))(
                    qd, qc.k, qc.v, ctx8 - 1, ctx8, k_scale=qc.k_scale,
                    v_scale=qc.v_scale, layer=ly, kv_hi=chunk),
                att_ref(qd, qc.k, qc.v, ctx8 - 1, ctx8, k_scale=qc.k_scale,
                        v_scale=qc.v_scale, layer=ly), *ATTN_TOL)
    del qc
    gc.collect()

    # paged pool: bf16 write bit-exact, then int8 embedded-scale attention
    page = min(64, max_seq // 8)
    maxp = max_seq // page
    n_pages = batch * maxp + 1
    table = np.asarray(rng.permutation(np.arange(1, n_pages)),
                       np.int32).reshape(batch, maxp)
    pwrite = jax.jit(pkv.paged_update_at_layer, donate_argnums=0)
    pc = pkv.PagedKVCache(bf16((layers, n_pages, page, K, D)),
                          bf16((layers, n_pages, page, K, D)),
                          jnp.asarray(table), jnp.zeros((batch,), jnp.int32))
    host_pk = np.array(pc.k)
    pst = np.array([0, page, 2 * page, max_seq - page, 0, max_seq // 2,
                    max_seq // 2 + 3, 7][:batch], np.int32)
    pnl = np.array([page, page, 0, page, 1, page // 2 + 1, 1, 1][:batch],
                   np.int32)
    nk = bf16((batch, page, K, D))
    pc = pwrite(pc, ly, nk, bf16((batch, page, K, D)), jnp.asarray(pst),
                jnp.asarray(pnl))
    hk = np.asarray(nk)
    for b in range(batch):
        for t in range(pnl[b]):
            p_ = pst[b] + t
            host_pk[layers - 1, table[b, p_ // page], p_ % page] = hk[b, t]
    ok &= check_exact(f"paged KV write page={page} starts={pst.tolist()} "
                      f"new_len={pnl.tolist()}", pc.k, host_pk)
    del pc, host_pk
    gc.collect()
    pq = pkv.new_paged_kv_cache(layers, batch, K, n_pages, page, D, maxp,
                                quantized=True)
    pq = pkv.PagedKVCache(pq.k, pq.v, jnp.asarray(table), pq.lengths,
                          embedded_scales=True)
    for off in range(0, chunk, page):
        pq = pwrite(pq, ly, bf16((batch, page, K, D)),
                    bf16((batch, page, K, D)),
                    jnp.full((batch,), off, jnp.int32),
                    jnp.full((batch,), page, jnp.int32))
    ok &= check(f"decode attention paged int8 KV (embedded scales) "
                f"B={batch} page={page}",
                att(qd, pq.k, pq.v, ctx8 - 1, ctx8, layer=ly, kv_hi=chunk,
                    embedded_kv=True, table=pq.block_table),
                att_ref(qd, pq.k, pq.v, ctx8 - 1, ctx8, layer=ly,
                        embedded_kv=True, table=pq.block_table), *ATTN_TOL)
    del pq
    gc.collect()
    return bool(ok)


# ---------------------------------------------------------------------------
# Phase C: model logits against the f32 reference forward
# ---------------------------------------------------------------------------

def _make_engine(model: str, eng_cfg, cfg=None):
    """The engine for a preset through ``create_engine`` (seeded dummy
    weights), or, with ``cfg`` given, for that configuration directly (a
    reduced model for rehearsals)."""
    from llm_inference_engine.models.registry import create_engine
    if cfg is None:
        return create_engine(model, None, eng_cfg, seed=SEED)
    from llm_inference_engine.models import weights as Wt
    from llm_inference_engine.runtime.engine import InferenceEngine
    gs = min(128, cfg.hidden_size // 2)
    eng_cfg = eng_cfg.replace(quant_group_size=gs)
    q = eng_cfg.quant_mode
    params = (Wt.init_dummy_params(cfg, seed=SEED) if q == "none"
              else Wt.init_dummy_quantized_params(cfg, q, gs, seed=SEED))
    return InferenceEngine(cfg, eng_cfg, params)


LOGIT_TOL = (1e-1, "bf16 residual stream and KV through 32 layers of seeded "
             "random weights vs the f32 forward: rounding grows through the "
             "layers; the float32 control bounds what is not rounding")
AGREE_MIN = (0.8, "near-tied top logits flip under that rounding")
F32_TOL = (1e-3, "same path in float32 at highest matmul precision: "
           "summation order only")


def run_logits(model: str, quant: str, cfg=None, decode_steps: int = 16,
               prompt_lens=(37, 101), max_seq: int = 256,
               control: bool = False, kv_dtype: str = "",
               kv_layout: str = "slot") -> bool:
    """Prefill two prompts then ``decode_steps`` greedy steps through the
    engine; compare every step's logits with the reference forward over
    the same tokens. ``control``: the model in float32 with every matmul
    at "highest" precision, held to F32_TOL. ``kv_dtype``/``kv_layout``:
    the engine's KV cache ("int8"; "paged")."""
    import jax
    with jax.default_matmul_precision("highest" if control else None):
        return _run_logits(model, quant, cfg, decode_steps, prompt_lens,
                           max_seq, control, kv_dtype, kv_layout)


def _run_logits(model, quant, cfg, decode_steps, prompt_lens, max_seq,
                control, kv_dtype, kv_layout) -> bool:
    import jax
    import jax.numpy as jnp

    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models import llama as M
    from llm_inference_engine.models.reference import reference_logits

    eng_cfg = EngineConfig(max_batch_size=len(prompt_lens),
                           max_seq_len=max_seq, quant_mode=quant,
                           kv_cache_dtype_name=kv_dtype, kv_layout=kv_layout)
    t0 = time.perf_counter()
    engine = _make_engine(model, eng_cfg, cfg)
    cfg = engine.config
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    B = len(prompts)

    step = jax.jit(lambda p, c, ids, qs, kl, kv_hi: M.forward_hidden(
        engine.config, engine.engine_config, p, ids, c, qs, kl, kv_hi=kv_hi),
        donate_argnums=(1,), static_argnums=(5,))
    logits = [np.asarray(engine.prefill(prompts))]
    seqs = [list(p) for p in prompts]
    for _ in range(decode_steps):
        tok = np.argmax(logits[-1], -1).astype(np.int32)
        for b in range(B):
            seqs[b].append(int(tok[b]))
        lens = np.asarray(engine.cache.lengths)
        engine.ensure_capacity(lens + 1)              # paged: next page
        kv_hi = engine._kv_watermark(lens, 1)
        lg, engine.cache = step(engine.params, engine.cache,
                                jnp.asarray(tok)[:, None], jnp.asarray(lens),
                                jnp.asarray(lens + 1), kv_hi)
        logits.append(np.asarray(lg))
    got = np.stack(logits, 1)                         # [B, steps+1, V]
    t_prod = time.perf_counter() - t0

    t0 = time.perf_counter()
    want = []
    for b in range(B):
        ref = reference_logits(engine.config, engine.params,
                               np.asarray(seqs[b], np.int32)[None],
                               kv_int8=_kv_int8_format(engine))
        want.append(np.asarray(ref[0, len(prompts[b]) - 1:]))
    want = np.stack(want)
    t_ref = time.perf_counter() - t0
    del engine
    gc.collect()

    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    tol = F32_TOL if control else LOGIT_TOL
    finite = (bool(np.isfinite(got).all()), bool(np.isfinite(want).all()))
    ok = all(finite) and rel <= tol[0] and agree >= AGREE_MIN[0]
    log(f"C {model} {quant if quant != 'none' else cfg.dtype_name}"
        f"{' (control, matmul precision highest)' if control else ''}"
        f" kv={kv_dtype or cfg.dtype_name} {kv_layout}: "
        f"layers={cfg.num_layers} (reference: all {cfg.num_layers}"
        f"{', int8 KV rounding' if kv_dtype == 'int8' else ''}) "
        f"hidden={cfg.hidden_size} prompts={list(prompt_lens)} "
        f"decode_steps={decode_steps} rel_l2={rel:.3e} "
        f"(tol {tol[0]:.0e}: {tol[1]}) greedy_agreement="
        f"{agree:.3f} (min {AGREE_MIN[0]}: {AGREE_MIN[1]}) "
        f"finite engine/reference={finite[0]}/{finite[1]} "
        f"engine {t_prod:.1f}s reference {t_ref:.1f}s "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# Phase D: serving through the HTTP server
# ---------------------------------------------------------------------------

class _CompileClock:
    """Sums XLA backend compile time (jax.monitoring duration events)."""

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if "backend_compile" in event:
            self.seconds += duration


def _post(addr, path, body, timeout=1200):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if body.get("stream"):
        events = []
        for block in resp.read().decode().split("\n\n"):
            if block.startswith("data: ") and block != "data: [DONE]":
                events.append(json.loads(block[len("data: "):]))
        return resp.status, events
    return resp.status, json.loads(resp.read())


def _kv_int8_format(engine):
    """The reference's int8 KV rounding for the engine's cache: None for a
    bf16 / f32 cache; the paged pool embeds log2-coded scales."""
    if engine.cache.k.dtype != np.int8:
        return None
    return ("log2_scale" if getattr(engine.cache, "embedded_scales", False)
            else "f32_scale")


def _served_tokens_match_reference(engine, reqs, results) -> bool:
    """The greedy plain completions' tokens against the float32 reference
    forward, teacher-forced on the served tokens: wrong or non-finite
    logits still fill the token counts, so the tokens themselves are
    checked."""
    from llm_inference_engine.cli import _IdTokenizer
    from llm_inference_engine.models.reference import reference_logits

    tok = _IdTokenizer(engine.config.vocab_size)
    agree = []
    for (path, b), res in zip(reqs, results):
        if (path != "/v1/completions" or b.get("stream") or b["temperature"]
                or res is None or res[0] != 200):
            continue
        prompt = tok.encode(b["prompt"])
        gen = [int(t) for t in res[1]["choices"][0]["text"].split()]
        ref = reference_logits(engine.config, engine.params,
                               np.asarray([prompt + gen], np.int32),
                               kv_int8=_kv_int8_format(engine))
        want = np.asarray(ref[0, len(prompt) - 1:-1]).argmax(-1)
        agree.append(float(np.mean(want == np.asarray(gen))) if gen else 0.)
    ok = bool(agree) and min(agree) >= AGREE_MIN[0]
    log(f"D greedy completions vs the float32 reference (teacher-forced): "
        f"agreement={[round(a, 3) for a in agree]} (min {AGREE_MIN[0]}: "
        f"{AGREE_MIN[1]}) {'ok' if ok else 'FAIL'}")
    return ok


def run_serving(model: str, quant: str, kv_dtype: str, kv_layout: str,
                batch: int, max_seq: int, n_requests: int, new_tokens: int,
                clock: _CompileClock, cfg=None) -> bool:
    import jax
    import jax.numpy as jnp

    from llm_inference_engine.cli import _IdTokenizer
    from llm_inference_engine.config import EngineConfig, SamplingParams
    from llm_inference_engine.runtime.chat_template import get_chat_template
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    from llm_inference_engine.server import make_server

    eng_cfg = EngineConfig(max_batch_size=batch, max_seq_len=max_seq,
                           quant_mode=quant, kv_cache_dtype_name=kv_dtype,
                           kv_layout=kv_layout)
    engine = _make_engine(model, eng_cfg, cfg)
    vocab = engine.config.vocab_size
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    httpd, llm = make_server(sched, _IdTokenizer(vocab),
                             get_chat_template("plain"), model,
                             host="127.0.0.1", port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    llm.start()
    addr = httpd.server_address
    rng = np.random.default_rng(SEED + 2)
    ok = True
    try:
        def body(i, n_tok):
            words = " ".join(str(int(t)) for t in
                             rng.integers(3, vocab, size=20 + 13 * i))
            if i == 1:
                return "/v1/chat/completions", {
                    "messages": [{"role": "user", "content": words}],
                    "max_tokens": n_tok, "temperature": 0.0}
            b = {"prompt": words, "max_tokens": n_tok,
                 "temperature": 0.0 if i % 3 else 0.8}
            if i == 0:
                b["stream"] = True
            return "/v1/completions", b

        # warm-up request: compiles the prefill and decode programs
        c0, t0 = clock.seconds, time.perf_counter()
        status, _ = _post(addr, "/v1/completions",
                          {"prompt": "5 9 2 7", "max_tokens": 4,
                           "temperature": 0.0})
        warm = time.perf_counter() - t0
        ok &= status == 200
        c_warm = clock.seconds - c0

        reqs = [body(i, new_tokens) for i in range(n_requests)]
        results = [None] * n_requests

        def go(i):
            results[i] = _post(addr, *reqs[i])

        c0, t0 = clock.seconds, time.perf_counter()
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=1200)
        wall = time.perf_counter() - t0
        c_run = clock.seconds - c0
        counts = []
        for i, res in enumerate(results):
            if res is None:
                ok = False
                counts.append(None)
                continue
            status, out = res
            if reqs[i][1].get("stream"):
                toks = [e for e in out
                        if e["choices"][0]["finish_reason"] is None]
                n = len(toks)
                ok &= status == 200 and n == new_tokens
            else:
                n = out.get("usage", {}).get("completion_tokens")
                ok &= (status == 200 and n == new_tokens
                       and out["choices"][0]["finish_reason"] == "length")
            counts.append(n)
        kind = ["sse", "chat"] + ["completion"] * (n_requests - 2)
        log(f"D {model} {quant} kv={kv_dtype or 'bf16'} {kv_layout} "
            f"batch={batch} max_seq={max_seq}: {n_requests} concurrent "
            f"requests ({', '.join(kind)}) x {new_tokens} new tokens: "
            f"completion_tokens={counts} wall={wall:.2f}s "
            f"(compile within it {c_run:.2f}s; warm-up request "
            f"{warm:.2f}s of which compile {c_warm:.2f}s) "
            f"{'ok' if ok else 'FAIL'}")
        ok &= _served_tokens_match_reference(engine, reqs, results)

        # the decode step as compiled: its memory plan
        B = batch
        temp, topk, topp, extras = engine._sampling_arrays(SamplingParams())
        kv_hi = engine._kv_watermark(np.asarray(engine.cache.lengths), 1)
        compiled = engine._decode_fn.lower(
            engine.params, engine.cache, engine._counts_ctx,
            engine._counts_gen, jnp.zeros((B,), jnp.int32),
            jnp.ones((B,), bool), jax.random.PRNGKey(0), temp, topk, topp,
            extras, kv_hi=kv_hi).compile()
        ma = compiled.memory_analysis()
        cache_bytes = sum(x.nbytes for x in jax.tree.leaves(engine.cache))
        temp_b = ma.temp_size_in_bytes
        no_copy = temp_b < cache_bytes // 2
        log(f"D decode step memory_analysis: argument={ma.argument_size_in_bytes}"
            f" output={ma.output_size_in_bytes} alias={ma.alias_size_in_bytes}"
            f" temp={temp_b} generated_code={ma.generated_code_size_in_bytes}"
            f" | cache={cache_bytes}: temp < cache/2 (no cache-sized copy) "
            f"{'ok' if no_copy else 'FAIL'}")
        ok &= no_copy
    finally:
        httpd.shutdown()
        llm.shutdown()
        httpd.server_close()
        del engine, sched, llm
        gc.collect()
    return bool(ok)


# ---------------------------------------------------------------------------
# --four: dp / tp / cp on four cards against one card
# ---------------------------------------------------------------------------

#: depth of the --four model: float32 replicas (dp=4, cp=4) must fit on
#: card 0 next to the seeded original; widths stay Llama-2-13B's
FOUR_LAYERS = 10


def run_four(model: str = "llama2-13b", cfg=None, max_seq: int = 512,
             batch: int = 8, decode_steps: int = 8) -> bool:
    """tp=4, dp=4 and cp=4 engines against one device: prefill logits and
    greedy generations from the same seeded weights, in float32 at
    "highest" matmul precision so that the only difference is summation
    order (in bf16 the seeded random model amplifies that order into
    different greedy tokens)."""
    import jax

    with jax.default_matmul_precision("highest"):
        ok = _run_four(model, cfg, max_seq, batch, decode_steps)
    return _run_four_int4(model, cfg, max_seq, batch, decode_steps) and ok


def _four_setup(model, cfg, batch, decode_steps):
    """The --four model (float32), its prompts and greedy sampling."""
    from llm_inference_engine.config import SamplingParams, get_config
    cfg = cfg or get_config(model).replace(num_layers=FOUR_LAYERS,
                                           dtype_name="float32")
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(3, cfg.vocab_size, size=17 + 9 * i).tolist()
               for i in range(batch)]
    return cfg, prompts, SamplingParams(greedy=True,
                                        max_new_tokens=decode_steps)


def _four_engine(cfg, params, eng_cfg, mesh_kw, devs, prompts, sp):
    """Prefill logits and greedy generations of one engine: on the first
    device, or on a mesh over four."""
    import jax

    from llm_inference_engine.parallel import make_mesh
    from llm_inference_engine.runtime.engine import InferenceEngine

    mesh = make_mesh(devices=devs[:4], **mesh_kw) if mesh_kw else None
    with jax.default_device(devs[0]):
        engine = InferenceEngine(cfg, eng_cfg.replace(**mesh_kw), params,
                                 mesh=mesh)
        t0 = time.perf_counter()
        first = np.asarray(engine.prefill(prompts))
        engine.reset()
        toks = engine.generate(prompts, sp, eos_token_id=None).token_ids
        dt = time.perf_counter() - t0
    del engine
    gc.collect()
    return first, toks, dt


def _run_four(model, cfg, max_seq, batch, decode_steps) -> bool:
    import jax

    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models.weights import init_dummy_params

    devs = jax.devices()
    if len(devs) < 4:
        log(f"four: need 4 devices, have {len(devs)} FAIL")
        return False
    cfg, prompts, sp = _four_setup(model, cfg, batch, decode_steps)
    eng_cfg = EngineConfig(max_batch_size=batch, max_seq_len=max_seq)

    def run(mesh_kw):
        with jax.default_device(devs[0]):
            params = init_dummy_params(cfg, seed=SEED)
        return _four_engine(cfg, params, eng_cfg, mesh_kw, devs, prompts, sp)

    base_logits, base_toks, dt = run({})
    log(f"four one card: {cfg.name} {cfg.dtype_name} (matmul precision "
        f"highest) hidden={cfg.hidden_size} heads={cfg.num_heads} "
        f"layers={cfg.num_layers} batch={batch} decode_steps={decode_steps} "
        f"({dt:.1f}s incl. compile)")
    ok = True
    for mesh_kw in ({"tp": 4}, {"dp": 4}, {"cp": 4}):
        name = ",".join(f"{k}={v}" for k, v in mesh_kw.items())
        lg, toks, dt = run(mesh_kw)
        rel = float(np.linalg.norm(lg - base_logits)
                    / np.linalg.norm(base_logits))
        same = sum(a == b for a, b in zip(toks, base_toks))
        agree = float(np.mean([x == y for a, b in zip(toks, base_toks)
                               for x, y in zip(a, b)]))
        good = (np.isfinite(lg).all() and rel <= F32_TOL[0]
                and agree >= AGREE_MIN[0])
        ok &= bool(good)
        log(f"four {name}: prefill logits rel_l2 vs one card={rel:.3e} "
            f"(tol {F32_TOL[0]:.0e}: sums in another order) "
            f"greedy tokens agreement={agree:.3f} (min {AGREE_MIN[0]}) "
            f"sequences identical={same}/{batch} ({dt:.1f}s incl. compile) "
            f"{'ok' if good else 'FAIL'}")
    return bool(ok)


def _run_four_int4(model, cfg, max_seq, batch, decode_steps) -> bool:
    """tp=4 with int4 weights at the production dtype (bf16 activations;
    decode matmuls on each card's weight shard take the int4 kernel route)
    against one card and against the float32 reference forward on the same
    dequantized weights: prefill logits, and the greedy tokens
    teacher-forced."""
    import jax

    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models.reference import reference_logits
    from llm_inference_engine.models.weights import (
        init_dummy_quantized_params)

    devs = jax.devices()
    cfg, prompts, sp = _four_setup(model, cfg, batch, decode_steps)
    cfg = cfg.replace(dtype_name="bfloat16")
    gs = min(128, cfg.hidden_size // 8)   # whole groups on each of 4 shards
    eng_cfg = EngineConfig(max_batch_size=batch, max_seq_len=max_seq,
                           quant_mode="int4", quant_group_size=gs)
    with jax.default_device(devs[0]):
        params = init_dummy_quantized_params(cfg, "int4", gs, seed=SEED)
    runs = {name: _four_engine(cfg, params, eng_cfg, kw, devs, prompts, sp)
            for name, kw in (("one card", {}), ("tp=4", {"tp": 4}))}
    ok = True
    want_first, agree = [], {name: [] for name in runs}
    for b, p in enumerate(prompts):
        seqs = {name: p + list(r[1][b]) for name, r in runs.items()}
        for name, seq in seqs.items():
            with jax.default_device(devs[0]):
                ref = np.asarray(reference_logits(
                    cfg, params, np.asarray([seq], np.int32))[0])
            if name == "one card":
                want_first.append(ref[len(p) - 1])
            agree[name] += list(ref[len(p) - 1:-1].argmax(-1)
                                == np.asarray(seq[len(p):]))
    want_first = np.stack(want_first)
    base = runs["one card"][0]
    for name, (lg, toks, dt) in runs.items():
        rel = float(np.linalg.norm(lg - want_first)
                    / np.linalg.norm(want_first))
        rel1 = float(np.linalg.norm(lg - base) / np.linalg.norm(base))
        a = float(np.mean(agree[name]))
        good = (np.isfinite(lg).all() and rel <= LOGIT_TOL[0]
                and rel1 <= LOGIT_TOL[0] and a >= AGREE_MIN[0])
        ok &= bool(good)
        log(f"four {name} int4 (bf16 activations): {cfg.name} "
            f"layers={cfg.num_layers} batch={batch} decode_steps="
            f"{decode_steps}: prefill logits rel_l2 vs float32 reference="
            f"{rel:.3e}, vs one card={rel1:.3e} (tol {LOGIT_TOL[0]:.0e}: "
            f"bf16 rounding) greedy tokens vs reference (teacher-forced) "
            f"agreement={a:.3f} (min {AGREE_MIN[0]}) ({dt:.1f}s incl. "
            f"compile) {'ok' if good else 'FAIL'}")
    return bool(ok)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the dp/tp/cp paths on four cards, each "
                         "compared with one card")
    args = ap.parse_args(argv)

    devs = require_gpu()
    import jax

    from llm_inference_engine.config import get_config
    from llm_inference_engine.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    t_start = time.perf_counter()
    try:
        smi = nvidia_smi()
    except Exception as e:  # noqa: BLE001 — reported as a failed phase
        smi = f"nvidia-smi failed: {e}"
    log(f"A platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__} compile_cache={cache_dir}")
    for line in smi.splitlines():
        log(f"A nvidia-smi: {line}")
    ok = not smi.startswith("nvidia-smi failed")
    if args.four:
        ok &= run_four()
    else:
        phases = [
            ("B", lambda: phase_ops(get_config("llama2-7b"),
                                    get_config("mistral-7b"))),
            ("C", lambda: all([run_logits(
                "llama2-7b", "none", control=True,
                cfg=get_config("llama2-7b").replace(dtype_name="float32"))]
                + [run_logits("llama2-7b", q)
                   for q in ("none", "int8", "int4")]
                + [run_logits("llama2-7b", "int4", kv_dtype="int8",
                              kv_layout=lay) for lay in ("slot", "paged")]
                + [run_logits("mistral-7b", "none")])),
            ("D", lambda: _serving_phase()),
        ]
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                good = fn()
            except Exception as e:  # noqa: BLE001 — the phase fails, loudly
                import traceback
                traceback.print_exc()
                log(f"{name} raised {type(e).__name__}: {e}")
                good = False
            log(f"{name} {'passed' if good else 'FAILED'} in "
                f"{time.perf_counter() - t0:.1f}s")
            ok &= bool(good)
    log(f"total {time.perf_counter() - t_start:.1f}s; "
        f"{'all phases passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if args.four else len(devs)}}))
    return 0


def _serving_phase() -> bool:
    clock = _CompileClock()
    ok = run_serving("llama2-7b", "int4", "", "slot", batch=8, max_seq=2048,
                     n_requests=8, new_tokens=32, clock=clock)
    ok &= run_serving("llama2-7b", "int4", "int8", "paged", batch=8,
                      max_seq=2048, n_requests=4, new_tokens=16,
                      clock=clock)
    return bool(ok)


if __name__ == "__main__":
    sys.exit(main())
