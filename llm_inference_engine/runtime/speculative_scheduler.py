"""Continuous batching with speculative decoding.

Combines the two throughput levers: the scheduler multiplexes an open
request stream onto batch slots (scheduler.py), and every pure-decode
step is a speculative draft/verify round (speculative.py) that can emit
up to k+1 tokens per target forward instead of one.

Cache-coherence invariant (the crux of running two engines under
continuous batching): the draft cache length equals the target cache
length at EVERY round boundary. It holds because
- admissions prefill the SAME chunks into both engines (the base
  scheduler's _mirror_reset/_mirror_prefill hooks; mixed steps include
  live slots' pending tokens as length-1 chunks for both), and
- a freshly accepted token is ingested by NEITHER cache: it travels as
  the next round's ``last`` input, which the round's draft scan ingests
  first and the target's verify block ingests alongside the drafts
  (speculative.py _round).

Sampled and greedy requests both run (one stochastic round serves a mixed
batch: each slot's processed p/q distributions carry its own
temperature/top-k/top-p/min-p, and greedy slots degenerate to one-hot —
ops/sampling.speculative_accept is lossless in distribution either way).
Logit penalties run with counts FROZEN at each round's start (the only
well-defined block-verify semantics: draft and target see the same
counts at every position, so acceptance stays lossless w.r.t. the
frozen-penalized target; accepted tokens enter the engine's counts
between rounds, lagging sequential decode by < k+1 tokens).
Near the sequence cap a slot needs k+2 rows of headroom
per round, so requests finish with reason 'capacity' slightly earlier
than the plain scheduler would. Prefix caching works through PAIRED
snapshots restored into both caches (prefix_cache.DualPrefixStore)."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import SamplingParams
from llm_inference_engine.runtime.scheduler import (
    ContinuousBatchingScheduler, Request)
from llm_inference_engine.runtime.speculative import SpeculativeDecoder

__all__ = ["SpeculativeScheduler"]


class SpeculativeScheduler(ContinuousBatchingScheduler):
    def __init__(self, target, draft, eos_token_id: Optional[int] = 2,
                 num_draft: int = 4):
        if target.engine_config.max_batch_size != \
                draft.engine_config.max_batch_size:
            raise ValueError("target/draft max_batch_size mismatch")
        if getattr(target, "paged", False) or getattr(draft, "paged", False):
            raise NotImplementedError(
                "speculative scheduling uses the slot KV layout")
        super().__init__(target, eos_token_id)
        self.draft = draft
        self.k = num_draft
        self._spec = SpeculativeDecoder(target, draft, num_draft)
        self.num_drafted = 0
        self.num_accepted = 0

    @property
    def acceptance_rate(self) -> float:
        return self.num_accepted / max(self.num_drafted, 1)

    def register_prefix(self, tokens):
        """Prefix caching under speculative scheduling: snapshots are
        PAIRED (target + draft) and restores land in both caches, so the
        round's cache-length lockstep invariant holds
        (runtime/prefix_cache.DualPrefixStore)."""
        if self.prefix_store is None:
            from llm_inference_engine.runtime.prefix_cache import (
                DualPrefixStore)
            self.prefix_store = DualPrefixStore(self.engine, self.draft)
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            raise RuntimeError("no free slot to register a prefix on")
        return self.prefix_store.register(tokens, slot=free[0])

    # -- base-scheduler hooks: keep the draft cache in lockstep ----------

    def _mirror_reset(self, slots):
        self.draft.reset(slots)

    def _mirror_prefill(self, chunks, slots):
        self.draft.prefill(chunks, slots=slots)

    # -- decode steps become draft/verify rounds -------------------------

    def _decode_phase(self) -> None:
        """One draft/verify round over every live slot; accepts up to
        k+1 tokens per slot (with their target logprobs)."""
        target, draft, k = self.engine, self.draft, self.k
        t_len = np.asarray(jax.device_get(target.cache.lengths))
        max_room = target.engine_config.max_seq_len - k - 2

        active = np.array([r is not None and not r.finished
                           for r in self.slots], bool)
        # rows without spec headroom cannot draft: finish them (slightly
        # earlier than the plain scheduler's cap — documented)
        for slot in np.nonzero(active)[0]:
            if t_len[slot] >= max_room:
                self._finish(self.slots[slot], "capacity")
                active[slot] = False
        if not active.any():
            return

        kv_hi_t = target._kv_watermark(t_len, k + 2)
        kv_hi_d = draft._kv_watermark(
            np.asarray(jax.device_get(draft.cache.lengths)), k + 2)
        # penalties: the engine's per-slot occurrence counts (maintained
        # by admissions/prefill/seed_counts) enter the round frozen and
        # come back extended with this round's accepted tokens
        pen = (jnp.asarray(self._rep), jnp.asarray(self._pres),
               jnp.asarray(self._freq))
        if (self._temp[active] <= 0.0).all():
            # all-greedy batch: the cheaper exact-argmax round (no [B,k,V]
            # distribution materialization)
            (emitted, emitted_lp, n_acc, target.cache, draft.cache,
             target._counts_ctx, target._counts_gen) = self._spec._round(
                    target.params, target.cache, draft.params, draft.cache,
                    jnp.asarray(self._last_token), jnp.asarray(~active),
                    target._counts_ctx, target._counts_gen, *pen,
                    kv_hi_t=kv_hi_t, kv_hi_d=kv_hi_d)
        else:
            self._spec._key, sub = jax.random.split(self._spec._key)
            (emitted, emitted_lp, n_acc, target.cache, draft.cache,
             target._counts_ctx, target._counts_gen) = \
                self._spec._round_sampled(
                    target.params, target.cache, draft.params, draft.cache,
                    jnp.asarray(self._last_token), jnp.asarray(~active),
                    target._counts_ctx, target._counts_gen, *pen,
                    sub, jnp.asarray(self._temp), jnp.asarray(self._topk),
                    jnp.asarray(self._topp), jnp.asarray(self._minp),
                    kv_hi_t=kv_hi_t, kv_hi_d=kv_hi_d)
        emitted = np.asarray(emitted)
        emitted_lp = np.asarray(emitted_lp)
        n_acc = np.asarray(n_acc)

        for slot in np.nonzero(active)[0]:
            req = self.slots[slot]
            if req is None:
                continue
            self.num_drafted += k
            self.num_accepted += int(n_acc[slot])
            for j in range(int(n_acc[slot]) + 1):
                self._accept_token(req, int(emitted[slot, j]),
                                   float(emitted_lp[slot, j]))
                if req.finished:
                    break
