"""Top-K / top-p / temperature sampling.

Capability parity with:
- ``launchTopKForBeamSearch`` (reference: src/kernels/topk.cu:104-140 — a
  two-pass cub::BlockReduce top-K with per-block insertion-sort register
  queues). ``jax.lax.top_k`` lowers to XLA's tuned top-k;
  a hand-written queue would re-derive it, so the kernel boundary
  here is the *sampling tail*, not the scan.
- ``launchSampling`` (reference: src/kernels/sampling.cu:73-102 —
  max-subtracted softmax over the K winners, inverse-CDF draw with a
  per-step curand seed, then seq_len++/is_finished bookkeeping). Here the
  draw uses jax.random (counter-based, reproducible across chips), and the
  bookkeeping lives in the jitted decode step (runtime/engine.py), keeping
  this op pure.

Additions over the reference: temperature, nucleus (top-p) filtering, and
greedy mode — all per-call static config (SamplingParams).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["greedy_sample", "sample_top_k", "top_k_logits", "sample_tokens",
           "apply_penalties", "processed_probs", "speculative_accept",
           "MAX_TOP_K"]

MAX_TOP_K = 64  # static top-k width; per-slot k masks within it


def apply_penalties(logits: jax.Array, counts_ctx: jax.Array,
                    counts_gen: jax.Array, repetition: jax.Array,
                    presence: jax.Array, frequency: jax.Array) -> jax.Array:
    """Context-aware logit penalties (beyond the reference, which had no
    penalty machinery at all).

    logits:     [B, V]
    counts_ctx: [B, V] int — occurrences in the full context (prompt +
                generated); drives the HF-style repetition penalty
    counts_gen: [B, V] int — occurrences among GENERATED tokens only;
                drives the OpenAI-style frequency/presence penalties
    repetition/presence/frequency: [B] per-slot params. Neutral values
    (1, 0, 0) make this an exact identity — callers apply it
    unconditionally, no recompile per request mix.
    """
    lf = logits.astype(jnp.float32)
    rep = repetition[:, None]
    seen = (counts_ctx + counts_gen) > 0
    penalized = jnp.where(lf > 0, lf / rep, lf * rep)
    lf = jnp.where(seen, penalized, lf)
    lf = lf - counts_gen.astype(jnp.float32) * frequency[:, None]
    lf = lf - (counts_gen > 0).astype(jnp.float32) * presence[:, None]
    return lf


def top_k_logits(logits: jax.Array, k: int):
    """Top-K values and indices along the last axis (reference topk.cu)."""
    return jax.lax.top_k(logits, k)


def greedy_sample(logits: jax.Array) -> jax.Array:
    """argmax over vocab: [..., V] -> int32[...]."""
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def token_logprobs(logits: jax.Array, ids: jax.Array) -> jax.Array:
    """log softmax(logits)[ids]: [B, V], [B] -> [B] f32. The model's raw
    distribution (post-penalty, pre-temperature/filters) — what the
    OpenAI logprobs field reports."""
    lf = logits.astype(jnp.float32)
    lse = jax.scipy.special.logsumexp(lf, axis=-1)
    picked = jnp.take_along_axis(lf, ids[:, None].astype(jnp.int32),
                                 axis=-1)[:, 0]
    return picked - lse


def sample_top_k(logits: jax.Array, key: jax.Array, *, temperature: float = 1.0,
                 top_k: int = 5, top_p: float = 1.0) -> jax.Array:
    """Sample token ids from softmax(top_k(logits)/T), optionally top-p
    filtered within the K winners. logits: [B, V] -> int32 [B]."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    vals, idx = jax.lax.top_k(logits.astype(jnp.float32), top_k)  # [B, k]
    vals = vals / temperature
    # max-subtracted softmax over the K winners (reference sampling.cu:31-42)
    probs = jax.nn.softmax(vals, axis=-1)
    if top_p < 1.0:
        # nucleus: keep the smallest prefix of sorted probs with cum >= top_p.
        # top_k output is already sorted descending.
        cum = jnp.cumsum(probs, axis=-1)
        keep = (cum - probs) < top_p          # always keeps the first token
        probs = jnp.where(keep, probs, 0.0)
        probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
    # inverse-CDF draw (reference sampling.cu:44-63), via categorical on the
    # renormalized K-way distribution
    choice = jax.random.categorical(key, jnp.log(jnp.maximum(probs, 1e-30)),
                                    axis=-1)                       # [B]
    return jnp.take_along_axis(idx, choice[:, None], axis=-1)[:, 0].astype(jnp.int32)


def _candidate_probs(logits: jax.Array, temperature: jax.Array,
                     top_k: jax.Array, top_p: jax.Array,
                     min_p: jax.Array | None):
    """The full processing chain, shared by sampling and by the speculative
    acceptance rule (which must score the EXACT distribution sampling draws
    from). logits [..., V]; params [...] (same leading shape).

    Returns (probs [..., K], idx [..., K], greedy [..., 1]); greedy rows
    (temperature<=0) get a one-hot distribution on the top candidate, so
    downstream draws/acceptance reduce to argmax semantics.
    """
    K = min(MAX_TOP_K, logits.shape[-1])
    vals, idx = jax.lax.top_k(logits.astype(jnp.float32), K)     # [..., K]
    t = temperature[..., None]
    greedy = t <= 0.0
    vals_t = vals / jnp.where(greedy, 1.0, t)

    rank = jnp.arange(K)
    keep = rank < jnp.maximum(top_k[..., None], 1)
    vals_t = jnp.where(keep, vals_t, -jnp.inf)
    probs = jax.nn.softmax(vals_t, axis=-1)

    if min_p is not None:
        # min-p floor: drop candidates below min_p * p_max (the top
        # candidate always survives)
        pmax = jnp.max(probs, axis=-1, keepdims=True)
        probs = jnp.where(probs >= min_p[..., None] * pmax, probs, 0.0)

    # nucleus filter within the K candidates (sorted descending)
    probs = probs / jnp.maximum(jnp.sum(probs, axis=-1, keepdims=True), 1e-30)
    cum = jnp.cumsum(probs, axis=-1)
    keep_p = (cum - probs) < top_p[..., None]
    probs = jnp.where(keep_p, probs, 0.0)
    probs = probs / jnp.maximum(jnp.sum(probs, axis=-1, keepdims=True), 1e-30)

    # greedy rows: one-hot on the top candidate (argmax)
    probs = jnp.where(greedy, (rank == 0).astype(probs.dtype), probs)
    return probs, idx, greedy


def sample_tokens(logits: jax.Array, key: jax.Array, temperature: jax.Array,
                  top_k: jax.Array, top_p: jax.Array,
                  min_p: jax.Array | None = None) -> jax.Array:
    """Per-slot-parameterized sampling (continuous batching: every slot can
    carry its own request's sampling config, all as runtime arrays — no
    recompile per request mix).

    logits: [B, V]; temperature/top_k/top_p(/min_p): [B]
    (temperature<=0 => greedy; min_p=0 => no min-p filtering).
    Always draws from the top-MAX_TOP_K candidates, masked down to each
    slot's k, min-p floor and nucleus p.
    """
    probs, idx, greedy = _candidate_probs(logits, temperature, top_k, top_p,
                                          min_p)
    choice = jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-30)), axis=-1)          # [B]
    choice = jnp.where(greedy[..., 0], 0, choice)                  # argmax row
    return jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0].astype(
        jnp.int32)


def processed_probs(logits: jax.Array, temperature: jax.Array,
                    top_k: jax.Array, top_p: jax.Array,
                    min_p: jax.Array | None = None) -> jax.Array:
    """The full-vocab probability vector ``sample_tokens`` draws from —
    temperature, top-MAX_TOP_K truncation, per-slot top-k, min-p and
    nucleus filters all applied; greedy rows are one-hot at the argmax.

    logits [..., V], params [...] -> probs [..., V]. This is the p (and q)
    of the stochastic speculative acceptance rule: scoring the *processed*
    distributions keeps the emitted stream lossless in distribution w.r.t.
    what plain per-token sampling would have produced.
    """
    probs, idx, _ = _candidate_probs(logits, temperature, top_k, top_p,
                                     min_p)
    out = jnp.zeros(logits.shape, probs.dtype)
    return jnp.put_along_axis(out, idx, probs, axis=-1,
                              inplace=False, mode="drop")


def speculative_accept(draft_tokens: jax.Array, q_probs: jax.Array,
                       p_probs: jax.Array, key: jax.Array):
    """Stochastic speculative acceptance (the standard rejection-sampling
    rule; lossless in distribution).

    draft_tokens: [B, k] tokens drawn from q
    q_probs:      [B, k, V] the draft's processed distributions
    p_probs:      [B, k+1, V] the target's processed distributions
    key:          PRNG key

    Position j accepts with prob min(1, p_j(x_j)/q_j(x_j)); the emitted
    sequence is the accepted prefix, then one token from the residual
    distribution norm(max(p_r - q_r, 0)) at the first rejection r, or from
    p_k when all k drafts were accepted (extending q with zeros at
    position k makes the bonus draw the same residual formula). Greedy
    rows (one-hot p and q from processed_probs) reduce exactly to the
    longest-matching-prefix + argmax-bonus rule.

    Returns (emitted [B, k+1] int32 with positions > n_acc zeroed,
    n_acc [B] int32).
    """
    B, k = draft_tokens.shape
    ku, kr = jax.random.split(key)

    qx = jnp.take_along_axis(q_probs, draft_tokens[..., None],
                             axis=-1)[..., 0]                     # [B, k]
    px = jnp.take_along_axis(p_probs[:, :k], draft_tokens[..., None],
                             axis=-1)[..., 0]                     # [B, k]
    u = jax.random.uniform(ku, (B, k))
    # u*q <= p  <=>  u <= p/q (q(x) > 0 a.s. since x ~ q); the product form
    # avoids the 0/0 at padding rows
    acc = (u * qx <= px).astype(jnp.int32)
    n_acc = jnp.sum(jnp.cumprod(acc, axis=1), axis=1)             # [B]

    # residual draw at position n_acc: q extended with zeros at k makes
    # the full-acceptance bonus draw (from p_k) the same expression
    q_ext = jnp.concatenate(
        [q_probs, jnp.zeros_like(p_probs[:, :1])], axis=1)        # [B,k+1,V]
    p_r = jnp.take_along_axis(p_probs, n_acc[:, None, None],
                              axis=1)[:, 0]                       # [B, V]
    q_r = jnp.take_along_axis(q_ext, n_acc[:, None, None],
                              axis=1)[:, 0]                       # [B, V]
    res = jnp.maximum(p_r - q_r, 0.0)
    tot = jnp.sum(res, axis=-1, keepdims=True)
    # p == q => empty residual (TV distance 0): any draw from p is correct
    res = jnp.where(tot > 0, res / jnp.maximum(tot, 1e-30), p_r)
    extra = jax.random.categorical(
        kr, jnp.log(jnp.maximum(res, 1e-30)), axis=-1).astype(jnp.int32)

    j = jnp.arange(k + 1)[None, :]
    dext = jnp.concatenate(
        [draft_tokens, jnp.zeros((B, 1), jnp.int32)], axis=1)
    emitted = jnp.where(
        j < n_acc[:, None], dext,
        jnp.where(j == n_acc[:, None], extra[:, None], 0))
    return emitted, n_acc
