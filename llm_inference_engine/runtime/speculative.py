"""Speculative decoding: a small draft model proposes, the target verifies.

Far beyond the reference's capability set (bs=1 greedy-ish sampling,
llama.cpp:322-398) — speculative decoding turns the memory-bound decode of
a large target model into one verify forward per K drafted tokens,
multiplying tokens/step by the acceptance length.

The engine's cache design makes rollback free: K/V are written at absolute
positions and the attention mask only admits columns below each
sequence's ``lengths``, so rejecting draft tokens is just rewinding the
``lengths`` vector — the dead rows are overwritten by the next write and
never attended in between.

Greedy acceptance (do_sample=False) reproduces the target's greedy output
EXACTLY, token for token: a drafted token is accepted iff it equals the
target argmax at that position, and the first mismatch is replaced by the
target argmax — the classic lossless speculative rule. (Exactness assumes
the target's logits are deterministic for a given context independent of
the forward's token-batch shape; true in f32, while bf16 rounding noise between
the T=1 decode and T=k+1 verify paths can flip near-ties — the universal
caveat of speculative decoding on low-precision hardware.)

Stochastic acceptance (the sampled round) implements the standard
rejection-sampling rule over the PROCESSED per-slot distributions
(temperature/top-k/top-p/min-p applied identically on both sides,
ops/sampling.processed_probs): drafted token x_j ~ q_j accepts with
probability min(1, p_j(x_j)/q_j(x_j)); the first rejection draws from
norm(max(p_j - q_j, 0)); full acceptance draws the bonus from p_k. The
emitted stream is distributed EXACTLY as plain per-token sampling from the
target (lossless in distribution) — ops/sampling.speculative_accept, with
the statistical test in tests/test_speculative_sampled.py. Greedy slots
degenerate to one-hot p/q, so one sampled round serves a mixed
greedy/sampled batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import SamplingParams
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.runtime.engine import InferenceEngine

__all__ = ["SpeculativeDecoder", "SpecResult"]


@dataclasses.dataclass
class SpecResult:
    token_ids: list[list[int]]
    num_drafted: int = 0
    num_accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.num_accepted / max(self.num_drafted, 1)


class SpeculativeDecoder:
    """Greedy speculative decoding over two InferenceEngines sharing a
    tokenizer/vocab. ``num_draft`` tokens are proposed per round."""

    def __init__(self, target: InferenceEngine, draft: InferenceEngine,
                 num_draft: int = 4, rng_seed: int = 0):
        if target.config.vocab_size != draft.config.vocab_size:
            raise ValueError("target/draft vocab mismatch")
        self.target = target
        self.draft = draft
        self.k = num_draft
        self._key = jax.random.PRNGKey(rng_seed)

        tcfg, teng = target.config, target.engine_config
        dcfg, deng = draft.config, draft.engine_config
        k = num_draft

        from llm_inference_engine.ops.sampling import apply_penalties

        def _pen(logits, counts_ctx, counts_gen, rep, pres, freq):
            """Frozen-counts penalties: [B, V] or per-position [B, T, V]
            logits against the SAME [B, V] counts (the round-start
            snapshot). Neutral (1, 0, 0) params are an exact identity."""
            if logits.ndim == 2:
                return apply_penalties(logits, counts_ctx, counts_gen,
                                       rep, pres, freq)
            return jax.vmap(
                lambda lg: apply_penalties(lg, counts_ctx, counts_gen,
                                           rep, pres, freq),
                in_axes=1, out_axes=1)(logits)

        def _count_emitted(counts_ctx, counts_gen, emitted, n_acc, done):
            """Fold the round's accepted tokens (incl. the bonus) into the
            occurrence counts — the engine's per-token counting, batched
            per round (counts stay frozen WITHIN a round by design)."""
            B = emitted.shape[0]
            valid = ((jnp.arange(emitted.shape[1])[None, :]
                      <= n_acc[:, None]) & ~done[:, None]).astype(jnp.int32)
            rows = jnp.arange(B)[:, None]
            return (counts_ctx.at[rows, emitted].add(valid),
                    counts_gen.at[rows, emitted].add(valid))

        @functools.partial(jax.jit, donate_argnums=(1, 3, 6, 7),
                           static_argnames=("kv_hi_t", "kv_hi_d"))
        def _round(t_params, t_cache, d_params, d_cache, last, done,
                   counts_ctx, counts_gen, rep, pres, freq,
                   kv_hi_t=None, kv_hi_d=None):
            """One whole speculative round ON DEVICE — draft k greedy
            tokens (lax.scan), verify with the target, compute greedy
            acceptance, and rewind both caches to the accepted frontier.
            The host sees exactly one call (and one transfer) per round;
            the previous draft-step loop paid a host round-trip per
            drafted token.

            Logit penalties run with counts FROZEN at round start (the
            only well-defined block-verify semantics: every drafted and
            verified position sees the same counts; accepted tokens enter
            the counts between rounds — so penalties lag a sequential
            decode by at most k tokens). Draft and target are penalized
            identically, keeping acceptance meaningful."""
            B = last.shape[0]
            t_len = t_cache.lengths
            d_len = d_cache.lengths

            # --- draft k greedy steps (draft cache advances as it goes) ---
            def dbody(carry, _):
                cache, tok = carry
                qs = cache.lengths
                logits, cache = llama_model.forward_hidden(
                    dcfg, deng, d_params, tok[:, None], cache, qs, qs + 1,
                    kv_hi=kv_hi_d)
                logits = _pen(logits, counts_ctx, counts_gen, rep, pres,
                              freq)
                nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                return (cache, nxt), nxt

            (d_cache, _), dts = jax.lax.scan(dbody, (d_cache, last), None,
                                             length=k)
            draft_toks = dts.T                              # [B, k]

            # --- one target forward verifies last + k drafts ---
            block = jnp.concatenate([last[:, None], draft_toks], axis=1)
            logits, t_cache = llama_model.forward_all_logits(
                tcfg, teng, t_params, block, t_cache, t_len,
                t_len + (k + 1), kv_hi=kv_hi_t)
            logits = _pen(logits, counts_ctx, counts_gen, rep, pres, freq)
            tgt = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, k+1]

            # --- greedy acceptance: longest matching draft prefix ---
            eq = (draft_toks == tgt[:, :k]).astype(jnp.int32)
            n_acc = jnp.sum(jnp.cumprod(eq, axis=1), axis=1)     # [B]
            bonus = jnp.take_along_axis(tgt, n_acc[:, None], axis=1)[:, 0]
            j = jnp.arange(k + 1)[None, :]
            dext = jnp.concatenate(
                [draft_toks, jnp.zeros((B, 1), jnp.int32)], axis=1)
            emitted = jnp.where(
                j < n_acc[:, None], dext,
                jnp.where(j == n_acc[:, None], bonus[:, None], 0))

            # log P(emitted) under the target at each emitted position
            # (accepted drafts equal the target argmax there, so this is
            # the target's own distribution for every emitted token)
            lf = logits.astype(jnp.float32)
            lse = jax.scipy.special.logsumexp(lf, axis=-1)     # [B, k+1]
            picked = jnp.take_along_axis(lf, emitted[..., None],
                                         axis=-1)[..., 0]
            emitted_lp = picked - lse                          # [B, k+1]

            # --- rewind both caches to the accepted frontier ---
            t_cache = dataclasses.replace(
                t_cache, lengths=jnp.where(done, t_len,
                                           t_len + n_acc + 1))
            # the draft ingested [last, d1..d_{k-1}]; on full acceptance it
            # must still ingest its own d_k before the bonus arrives
            d_cache = dataclasses.replace(
                d_cache, lengths=jnp.where(done, d_len,
                                           t_len + jnp.minimum(n_acc + 1,
                                                               k)))
            full = jnp.logical_and(n_acc == k, jnp.logical_not(done))

            def ingest(cache):
                qs = cache.lengths
                _, cache = llama_model.forward_hidden(
                    dcfg, deng, d_params, draft_toks[:, -1:], cache, qs,
                    qs + full.astype(jnp.int32), kv_hi=kv_hi_d)
                return cache

            # skip the extra draft forward entirely in rounds where no
            # sequence fully accepted (the common case at low acceptance)
            d_cache = jax.lax.cond(jnp.any(full), ingest, lambda c: c,
                                   d_cache)
            counts_ctx, counts_gen = _count_emitted(
                counts_ctx, counts_gen, emitted, n_acc, done)
            return (emitted, emitted_lp, n_acc, t_cache, d_cache,
                    counts_ctx, counts_gen)

        self._round = _round

        @functools.partial(jax.jit, donate_argnums=(1, 3, 6, 7),
                           static_argnames=("kv_hi_t", "kv_hi_d"))
        def _round_sampled(t_params, t_cache, d_params, d_cache, last, done,
                           counts_ctx, counts_gen, rep, pres, freq,
                           key, temp, topk, topp, minp,
                           kv_hi_t=None, kv_hi_d=None):
            """One stochastic speculative round ON DEVICE: draft k sampled
            tokens (collecting their processed distributions q), verify
            with one target forward (processed distributions p), apply the
            rejection-sampling acceptance rule, and rewind both caches.
            Per-slot sampling params [B] — greedy slots (temp<=0) get
            one-hot p/q and reduce exactly to the greedy rule.

            Penalties use counts FROZEN at round start (see _round), and
            both q and p are penalized with the same snapshot — so the
            rejection rule stays LOSSLESS with respect to the
            frozen-penalized target distribution."""
            from llm_inference_engine.ops.sampling import (
                processed_probs, sample_tokens, speculative_accept)
            B = last.shape[0]
            t_len = t_cache.lengths
            d_len = d_cache.lengths
            key_d, key_acc = jax.random.split(key)

            # --- draft k sampled steps, stacking processed q ---
            def dbody(carry, kstep):
                cache, tok = carry
                qs = cache.lengths
                logits, cache = llama_model.forward_hidden(
                    dcfg, deng, d_params, tok[:, None], cache, qs, qs + 1,
                    kv_hi=kv_hi_d)
                logits = _pen(logits, counts_ctx, counts_gen, rep, pres,
                              freq)
                qp = processed_probs(logits, temp, topk, topp, minp)
                nxt = sample_tokens(logits, kstep, temp, topk, topp, minp)
                return (cache, nxt), (nxt, qp)

            (d_cache, _), (dts, qps) = jax.lax.scan(
                dbody, (d_cache, last), jax.random.split(key_d, k))
            draft_toks = dts.T                               # [B, k]
            q_probs = qps.transpose(1, 0, 2)                 # [B, k, V]

            # --- one target forward verifies last + k drafts ---
            block = jnp.concatenate([last[:, None], draft_toks], axis=1)
            logits, t_cache = llama_model.forward_all_logits(
                tcfg, teng, t_params, block, t_cache, t_len,
                t_len + (k + 1), kv_hi=kv_hi_t)              # [B, k+1, V]
            logits = _pen(logits, counts_ctx, counts_gen, rep, pres, freq)
            bcast = lambda a: jnp.broadcast_to(a[:, None], (B, k + 1))
            p_probs = processed_probs(logits, bcast(temp), bcast(topk),
                                      bcast(topp), bcast(minp))

            emitted, n_acc = speculative_accept(draft_toks, q_probs,
                                                p_probs, key_acc)

            # log P(emitted) under the target's post-penalty,
            # pre-temperature distribution at each position (same
            # convention as the engine's decode path: token_logprobs over
            # _penalized logits)
            lf = logits.astype(jnp.float32)
            lse = jax.scipy.special.logsumexp(lf, axis=-1)
            picked = jnp.take_along_axis(lf, emitted[..., None],
                                         axis=-1)[..., 0]
            emitted_lp = picked - lse                        # [B, k+1]

            # --- rewind both caches to the accepted frontier ---
            t_cache = dataclasses.replace(
                t_cache, lengths=jnp.where(done, t_len, t_len + n_acc + 1))
            d_cache = dataclasses.replace(
                d_cache, lengths=jnp.where(done, d_len,
                                           t_len + jnp.minimum(n_acc + 1,
                                                               k)))
            full = jnp.logical_and(n_acc == k, jnp.logical_not(done))

            def ingest(cache):
                qs = cache.lengths
                _, cache = llama_model.forward_hidden(
                    dcfg, deng, d_params, draft_toks[:, -1:], cache, qs,
                    qs + full.astype(jnp.int32), kv_hi=kv_hi_d)
                return cache

            d_cache = jax.lax.cond(jnp.any(full), ingest, lambda c: c,
                                   d_cache)
            counts_ctx, counts_gen = _count_emitted(
                counts_ctx, counts_gen, emitted, n_acc, done)
            return (emitted, emitted_lp, n_acc, t_cache, d_cache,
                    counts_ctx, counts_gen)

        self._round_sampled = _round_sampled

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = 2,
                 sampling: Optional[SamplingParams] = None) -> SpecResult:
        """Speculative generation (batch = number of prompts; all slots
        draft/verify in lockstep). ``sampling=None`` (or greedy) runs the
        exact greedy round; otherwise the stochastic rejection-sampling
        round — lossless in distribution. Logit penalties apply with
        counts frozen at each round's start (identically to draft and
        target, so sampled rounds stay lossless w.r.t. the
        frozen-penalized target); accepted tokens enter the counts
        between rounds, so penalties lag sequential decode by < k+1
        tokens."""
        B = self.target.engine_config.max_batch_size
        nseq = len(prompts)
        assert nseq <= B and nseq <= self.draft.engine_config.max_batch_size
        do_sample = sampling is not None and not sampling.greedy \
            and sampling.temperature > 0.0
        if do_sample:
            samp = (jnp.full((B,), sampling.temperature, jnp.float32),
                    jnp.full((B,), sampling.top_k, jnp.int32),
                    jnp.full((B,), sampling.top_p, jnp.float32),
                    jnp.full((B,), sampling.min_p, jnp.float32))
        # logit penalties run with counts frozen per round (_round /
        # _round_sampled); neutral values are an exact identity
        sp_pen = sampling or SamplingParams()
        pen = (jnp.full((B,), sp_pen.repetition_penalty, jnp.float32),
               jnp.full((B,), sp_pen.presence_penalty, jnp.float32),
               jnp.full((B,), sp_pen.frequency_penalty, jnp.float32))
        V = self.target.config.vocab_size
        cc_host = np.zeros((B, V), np.int32)
        for i, p in enumerate(prompts):
            np.add.at(cc_host[i], np.asarray(p, np.int64), 1)
        counts_ctx = jnp.asarray(cc_host)
        counts_gen = jnp.zeros((B, V), jnp.int32)

        self.target.reset()
        self.draft.reset()
        t_logits = self.target.prefill(prompts)
        self.draft.prefill(prompts)

        # first token comes from the target's prefill logits (penalized
        # against the prompt counts, like the engine's first sample)
        from llm_inference_engine.ops.sampling import apply_penalties
        t_logits = apply_penalties(t_logits, counts_ctx, counts_gen, *pen)
        if do_sample:
            self._key, sub = jax.random.split(self._key)
            from llm_inference_engine.ops.sampling import sample_tokens
            last = np.asarray(sample_tokens(t_logits, sub, *samp))
        else:
            last = np.asarray(jnp.argmax(t_logits, axis=-1).astype(jnp.int32))
        first_valid = np.zeros((B,), np.int32)
        first_valid[:nseq] = 1
        counts_ctx = counts_ctx.at[np.arange(B), last].add(first_valid)
        counts_gen = counts_gen.at[np.arange(B), last].add(first_valid)
        out = [[int(last[i])] for i in range(nseq)]
        done = np.zeros((B,), bool)
        done[nseq:] = True
        stop = {eos_token_id} if eos_token_id is not None else set()
        for i in range(nseq):
            if last[i] in stop:
                done[i] = True
        drafted = accepted = 0

        max_room = self.target.engine_config.max_seq_len - self.k - 2
        while not done.all():
            if all(done[i] or len(out[i]) >= max_new_tokens
                   for i in range(nseq)):
                break
            t_len = np.asarray(jax.device_get(self.target.cache.lengths))
            if (t_len >= max_room).any():
                break

            # --- the whole round (draft scan + verify + acceptance +
            # rollback) is ONE device call; only the emitted tokens and
            # accept counts come back to the host ---
            kv_hi_t = self.target._kv_watermark(t_len, self.k + 1)
            kv_hi_d = self.draft._kv_watermark(t_len, self.k + 1)
            if do_sample:
                self._key, sub = jax.random.split(self._key)
                (emitted, _, n_acc, self.target.cache, self.draft.cache,
                 counts_ctx, counts_gen) = self._round_sampled(
                        self.target.params, self.target.cache,
                        self.draft.params, self.draft.cache,
                        jnp.asarray(last), jnp.asarray(done),
                        counts_ctx, counts_gen, *pen, sub, *samp,
                        kv_hi_t=kv_hi_t, kv_hi_d=kv_hi_d)
            else:
                (emitted, _, n_acc, self.target.cache, self.draft.cache,
                 counts_ctx, counts_gen) = self._round(
                        self.target.params, self.target.cache,
                        self.draft.params, self.draft.cache,
                        jnp.asarray(last), jnp.asarray(done),
                        counts_ctx, counts_gen, *pen,
                        kv_hi_t=kv_hi_t, kv_hi_d=kv_hi_d)
            emitted = np.asarray(emitted)           # [B, k+1]
            n_acc = np.asarray(n_acc)

            # --- host bookkeeping: stops, output, next round's tokens ---
            new_last = last.copy()
            for i in range(nseq):
                if done[i]:
                    continue
                drafted += self.k
                accepted += int(n_acc[i])
                for t in emitted[i, :n_acc[i] + 1]:
                    if int(t) in stop or len(out[i]) >= max_new_tokens:
                        done[i] = True
                        if int(t) in stop:
                            out[i].append(int(t))
                        break
                    out[i].append(int(t))
                new_last[i] = out[i][-1]
            last = new_last

        return SpecResult(
            token_ids=[o[:max_new_tokens] for o in out],
            num_drafted=drafted, num_accepted=accepted)
