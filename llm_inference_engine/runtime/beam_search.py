"""Beam-search decoding.

The reference engine shipped a dedicated two-pass top-K kernel *named for
beam search* and carried a beam-width field, but never wired beams up —
its sampling launcher draws a single token and the model runs bs=1
(reference: src/kernels/topk.cu:104-140 ``launchTopKForBeamSearch``,
src/models/llama/llama.h:42 ``beamwidth``; sampling path llama.cpp:260-318).
This module delivers the capability those hooks promised.

Design: the beam dimension IS the batch dimension of the jitted
forward. One prefill of the prompt fills beam 0's KV rows; a broadcast
copies them to all beams; each decode step is then
  forward [num_beams, 1] -> log-softmax -> joint top-K over (beam x vocab)
  -> gather KV-cache rows by parent beam (jnp.take along the batch axis —
  XLA turns the whole-cache gather into one fused copy)
all inside a single jitted step function with the cache donated. Finished
beams (EOS) are frozen: their score stops accumulating and their only
successor is themselves via a forced pad continuation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.ops import kv_cache as kvc

__all__ = ["BeamSearchResult", "beam_search"]

_NEG_INF = -1e30


@dataclasses.dataclass
class BeamSearchResult:
    sequences: list[list[int]]      # generated ids per beam, best first
    scores: list[float]             # total log-prob (length-penalized)


def _gather_cache(cache: kvc.KVCache, parents: jax.Array) -> kvc.KVCache:
    """Reorder the batch axis of every cache leaf by parent beam index."""
    take = lambda a: None if a is None else jnp.take(a, parents, axis=1)
    return kvc.KVCache(
        k=take(cache.k), v=take(cache.v),
        lengths=jnp.take(cache.lengths, parents),
        k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


def beam_search(config: ModelConfig, engine_config: EngineConfig, params,
                prompt_ids: Sequence[int], num_beams: int = 4,
                max_new_tokens: int = 64, eos_token_id: Optional[int] = 2,
                length_penalty: float = 1.0, pad_token_id: int = 0):
    """Beam-search a single prompt. Returns BeamSearchResult (beams sorted
    by length-penalized score, best first).

    Scores are sum log P(token | prefix); at the end each beam's score is
    divided by (generated_len ** length_penalty) (HF convention).
    """
    cfg = config
    eng = engine_config.replace(max_batch_size=num_beams)
    B = num_beams
    S = eng.max_seq_len
    prompt = np.asarray(prompt_ids, np.int32)
    P = len(prompt)
    if P + max_new_tokens > S:
        raise ValueError(f"prompt {P} + {max_new_tokens} new > max_seq {S}")

    cache = kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                             cfg.head_dim, dtype=cfg.dtype,
                             quantized=eng.kv_cache_dtype == jnp.int8,
                             pad_to_tiles=None)  # auto: model layer adapts

    @functools.partial(jax.jit, donate_argnums=(1,))
    def _prefill(params, cache, ids):
        # all beams prefill the same prompt (beam dim = batch dim): no
        # broadcast step needed afterwards, one compiled call total.
        q0 = jnp.zeros((B,), jnp.int32)
        kv = jnp.full((B,), P, jnp.int32)
        logits, cache = llama_model.forward_hidden(cfg, eng, params, ids,
                                                   cache, q0, kv)
        cache = dataclasses.replace(cache, lengths=kv)
        return jax.nn.log_softmax(logits.astype(jnp.float32), -1), cache

    @functools.partial(jax.jit, donate_argnums=(1,))
    def _step(params, cache, tokens, scores, finished, lengths):
        """One beam step. tokens/scores/finished/lengths: [B]."""
        q_start = cache.lengths
        logits, cache = llama_model.forward_hidden(
            cfg, eng, params, tokens[:, None], cache, q_start, q_start + 1)
        cache = dataclasses.replace(cache, lengths=q_start + 1)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)  # [B, V]
        V = logp.shape[-1]

        # finished beams: only successor is themselves continuing with pad
        # at unchanged score; alive beams: score + logp
        cand = scores[:, None] + logp                               # [B, V]
        frozen = jnp.full((B, V), _NEG_INF).at[:, pad_token_id].set(0.0)
        frozen = scores[:, None] + frozen
        cand = jnp.where(finished[:, None], frozen, cand)

        flat = cand.reshape(-1)                                     # [B*V]
        top_scores, top_idx = jax.lax.top_k(flat, B)
        parents = (top_idx // V).astype(jnp.int32)                  # [B]
        toks = (top_idx % V).astype(jnp.int32)                      # [B]

        cache = _gather_cache(cache, parents)
        new_finished = jnp.take(finished, parents)
        just_done = jnp.logical_and(
            ~new_finished,
            toks == (eos_token_id if eos_token_id is not None else -1))
        step_tok = jnp.where(new_finished, pad_token_id, toks)
        new_lengths = jnp.take(lengths, parents) + jnp.where(
            new_finished | just_done, 0, 1)
        return (cache, step_tok, top_scores, new_finished | just_done,
                new_lengths, parents)

    # ---- host loop (per-step reorder bookkeeping for output assembly) ----
    ids = jnp.broadcast_to(jnp.asarray(prompt)[None, :], (B, P))
    logp0, cache = _prefill(params, cache, ids)
    # first expansion: all beams are identical, so take top-B tokens of
    # beam 0 (joint top-k over identical rows would pick duplicates)
    s0, t0 = jax.lax.top_k(logp0[0], B)
    scores = s0
    tokens = t0.astype(jnp.int32)
    finished = (tokens == eos_token_id) if eos_token_id is not None else (
        jnp.zeros((B,), bool))
    lengths = jnp.ones((B,), jnp.int32)

    hyp = [[int(t)] for t in np.asarray(tokens)]                    # per beam
    for _ in range(max_new_tokens - 1):
        if bool(np.asarray(finished).all()):
            break
        cache, tokens, scores, finished, lengths, parents = _step(
            params, cache, tokens, scores, finished, lengths)
        parents_h = np.asarray(parents)
        toks_h = np.asarray(tokens)
        fin_h = np.asarray(finished)
        new_hyp = []
        for b in range(B):
            seq = list(hyp[parents_h[b]])
            t = int(toks_h[b])
            # append unless this beam is frozen and just padding along
            if not (fin_h[b] and t == pad_token_id):
                seq.append(t)
            new_hyp.append(seq)
        hyp = new_hyp

    scores_h = np.asarray(scores, np.float64)
    lengths_h = np.asarray(lengths, np.float64)
    final = scores_h / np.maximum(lengths_h, 1.0) ** length_penalty
    order = np.argsort(-final)
    # strip eos/pad tails
    out_seqs, out_scores = [], []
    for b in order:
        seq = hyp[b]
        if eos_token_id is not None and eos_token_id in seq:
            seq = seq[:seq.index(eos_token_id) + 1]
        out_seqs.append(seq)
        out_scores.append(float(final[b]))
    return BeamSearchResult(sequences=out_seqs, scores=out_scores)
