"""Inference engine: jitted prefill / decode steps + generation loop.

Capability parity with the reference's model tier (src/models/llama/llama.cpp):
- ``generateFirstToken`` (llama.cpp:166-217) -> ``prefill`` — one jitted
  call that embeds the prompt, runs all layers, fills the KV cache and
  returns first-token logits;
- ``generateNextToken`` (llama.cpp:220-257) -> ``decode_step`` — one jitted
  call per token with the KV cache donated (updated in place);
- ``response`` generation loop with EOS/length stop and per-token streaming
  callback (llama.cpp:322-398, basemodel.h:12 CallBack);
- ``LMHeadAndTopKSample`` (llama.cpp:260-318) — fused into the jitted step:
  last-token slice -> lm_head -> top-K -> sample, so the only per-token
  host<->device traffic is the sampled token id (the reference likewise
  D2H-copied one int per token, llama.cpp:314).

Differences by design: batch slots instead of bs=1 (llama.h:31), no 20-token
output cap (llama.h:26), sampling parameters are runtime config, multi-round
history stays in the KV cache across calls.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import EngineConfig, ModelConfig, SamplingParams
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.ops.sampling import (
    apply_penalties, greedy_sample, sample_top_k, sample_tokens,
    token_logprobs)

__all__ = ["InferenceEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[list[int]]          # per sequence, generated ids only
    num_prompt_tokens: list[int]
    num_generated: list[int]
    # per generated token: log P(token) under the model's (penalized)
    # distribution — aligned with token_ids
    logprobs: Optional[list[list[float]]] = None


def _bucket_len(n: int, floor: int = 16, cap: int | None = None) -> int:
    """Round up to a power of two (bounds jit retraces across prompt lens)."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


class InferenceEngine:
    """Single-host engine over one model replica.

    Parallelism: when built through parallel.sharded_engine the same step
    functions run shard_map'd over a device mesh; this class is the
    mesh-of-one path.
    """

    def __init__(self, config: ModelConfig, engine_config: EngineConfig,
                 params, rng_seed: int = 0, mesh=None):
        from llm_inference_engine.config import resolve_rope_scaling
        # NTK rope scaling folds into rope_theta at the engine's context
        # length (config.NTKScaling: one theta, cached keys consistent)
        config = resolve_rope_scaling(config, engine_config.max_seq_len)
        self.config = config
        self.engine_config = engine_config
        self._key = jax.random.PRNGKey(rng_seed)

        cfg, eng = config, engine_config

        if mesh is None and (eng.dp > 1 or eng.tp > 1 or eng.cp > 1):
            from llm_inference_engine.parallel import make_mesh
            mesh = make_mesh(dp=eng.dp, tp=eng.tp, cp=eng.cp)
        self.mesh = mesh
        from llm_inference_engine.parallel.mesh import SEQ_AXIS
        self.cp = 1 if mesh is None else mesh.shape.get(SEQ_AXIS, 1)

        self.paged = eng.kv_layout == "paged"
        if self.cp > 1:
            # context parallelism: per-rank append-log cache + ring/split-KV
            # attention over the mesh's seq axis (parallel/cp_engine.py).
            # Composes with dp/tp AND with the int8 KV log (separate-scale
            # or embedded variant, parallel/cp_cache.py — cp=N multiplies
            # the *quantized* context capacity, VERDICT r4 #4); paged
            # stays adjudicated out (docs/ADR-composition-matrix.md).
            if self.paged:
                raise NotImplementedError(
                    "cp>1 + paged KV: the page pool is a single-chip memory "
                    "manager; CP's capacity axis replaces it "
                    "(docs/ADR-composition-matrix.md)")
            if eng.kv_cache_dtype not in (None, jnp.int8):
                raise NotImplementedError(
                    f"cp>1 supports bf16 or int8 KV logs, not "
                    f"{eng.kv_cache_dtype_name}")
            from llm_inference_engine.parallel import cp_engine, sharding
            from llm_inference_engine.parallel.mesh import MODEL_AXIS
            from llm_inference_engine.parallel.cp_cache import new_cp_cache
            cache = new_cp_cache(
                config.num_layers, eng.max_batch_size, config.num_kv_heads,
                eng.max_seq_len, config.head_dim, self.cp, dtype=config.dtype,
                quantized=eng.kv_cache_dtype == jnp.int8,
                shard_groups=mesh.shape[MODEL_AXIS])
            params = sharding.shard_params(params, mesh)
            from jax.sharding import NamedSharding
            cache = jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                cache, cp_engine.cp_cache_pspecs(cache))
            fwd = cp_engine.make_cp_forward(cfg, eng, mesh, params,
                                            cache_example=cache)

            self.params = params
            self.cache = cache
            self._finish_init(fwd)
            return
        if self.paged:
            from llm_inference_engine.ops import paged_kv as pkv
            if mesh is not None and eng.kv_cache_dtype == jnp.int8:
                raise NotImplementedError(
                    "paged + mesh excludes the int8 (embedded-scale) pool: "
                    "scale rows ride the kv-head axis and cannot shard "
                    "(parallel/sharding.paged_cache_pspecs)")
            page = eng.page_size
            # multi-token writes must stay within one page: chunk size
            # divides the page (ops/paged_kv.py write invariant)
            C = max(1, eng.max_prefill_len)
            if C > page:
                engine_config = eng = eng.replace(max_prefill_len=page)
            elif page % C:
                raise ValueError(f"page_size {page} must be a multiple of "
                                 f"max_prefill_len {C}")
            self.engine_config = eng
            B = eng.max_batch_size
            maxp = -(-eng.max_seq_len // page)
            num_pages = eng.num_pages or (B * maxp + 1)   # +1: reserved 0
            cache = pkv.new_paged_kv_cache(
                config.num_layers, B, config.num_kv_heads, num_pages, page,
                config.head_dim, maxp, dtype=config.dtype,
                quantized=eng.kv_cache_dtype == jnp.int8)
            self._allocator = pkv.PageAllocator(num_pages)
            self._slot_pages: list[list[int]] = [[] for _ in range(B)]
            self._table_host = np.zeros((B, maxp), np.int32)
        else:
            # under a mesh the head axis is allocated as one group per
            # model-axis shard (shard_groups), so every shard's local slice
            # is a self-contained layout (ops/kv_cache.new_kv_cache). The
            # slot cache keeps separate int8 scale planes and no tile
            # padding.
            from llm_inference_engine.parallel.mesh import MODEL_AXIS
            tp_groups = 1 if mesh is None else mesh.shape[MODEL_AXIS]
            cache = kvc.new_kv_cache(
                config.num_layers, engine_config.max_batch_size,
                config.num_kv_heads, engine_config.max_seq_len,
                config.head_dim,
                dtype=config.dtype,
                quantized=engine_config.kv_cache_dtype == jnp.int8,
                embedded=False, pad_to_tiles=False, shard_groups=tp_groups)

        if mesh is not None:
            from llm_inference_engine.parallel import sharding
            params = sharding.shard_params(params, mesh)
            cache = sharding.shard_cache(cache, mesh)
            _sharded = sharding.make_sharded_forward(cfg, eng, mesh, params,
                                                     cache_example=cache)

            def fwd(p, c, ids, q_start, kv_len, kv_hi=None):
                return _sharded(p, c, ids, q_start, kv_len)
        else:
            def fwd(p, c, ids, q_start, kv_len, kv_hi=None):
                return llama_model.forward_hidden(cfg, eng, p, ids, c,
                                                  q_start, kv_len,
                                                  kv_hi=kv_hi)

        self.params = params
        self.cache = cache
        self._finish_init(fwd)

    def _finish_init(self, fwd):
        """Build the jitted step functions over ``fwd`` (shared by the
        mesh-of-one, dp/tp-sharded, and cp paths — they differ only in
        ``fwd`` and the cache layout)."""
        config, engine_config = self.config, self.engine_config
        eng = engine_config
        # context / generated token-occurrence counts per slot (drive the
        # repetition / presence / frequency penalties; ops/sampling.py)
        B_, V_ = engine_config.max_batch_size, config.vocab_size
        self._counts_ctx = jnp.zeros((B_, V_), jnp.int32)
        self._counts_gen = jnp.zeros((B_, V_), jnp.int32)

        def _count_tokens(counts, token_ids, valid):
            """counts [B,V] += one-hot sums of token_ids [B,T] where valid."""
            B = counts.shape[0]
            return counts.at[jnp.arange(B)[:, None], token_ids].add(
                valid.astype(jnp.int32))

        @functools.partial(jax.jit, donate_argnums=(1, 2),
                           static_argnames=("kv_hi",))
        def _prefill(params, cache, counts_ctx, token_ids, q_start, kv_len,
                     kv_hi=None):
            T = token_ids.shape[1]
            valid = (jnp.arange(T)[None, :]
                     < (kv_len - q_start)[:, None])
            counts_ctx = _count_tokens(counts_ctx, token_ids, valid)
            logits, cache = fwd(params, cache, token_ids, q_start, kv_len,
                                kv_hi)
            return logits, cache, counts_ctx

        def _penalized(logits, counts_ctx, counts_gen, extras):
            minp, rep, pres, freq = extras
            return apply_penalties(logits, counts_ctx, counts_gen,
                                   rep, pres, freq), minp

        @functools.partial(jax.jit, donate_argnums=(1, 2, 3),
                           static_argnames=("kv_hi",))
        def _decode_step(params, cache, counts_ctx, counts_gen, tokens,
                         active, key, temperature, top_k, top_p, extras,
                         kv_hi=None):
            q_start = cache.lengths
            kv_len = q_start + active.astype(jnp.int32)
            logits, cache = fwd(params, cache, tokens[:, None], q_start,
                                kv_len, kv_hi)
            logits, minp = _penalized(logits, counts_ctx, counts_gen, extras)
            nxt = sample_tokens(logits, key, temperature, top_k, top_p, minp)
            lp = token_logprobs(logits, nxt)
            counts_ctx = _count_tokens(counts_ctx, nxt[:, None],
                                       active[:, None])
            counts_gen = _count_tokens(counts_gen, nxt[:, None],
                                       active[:, None])
            return nxt, lp, cache, counts_ctx, counts_gen

        @functools.partial(jax.jit, donate_argnums=(5, 6))
        def _sample(logits, key, temperature, top_k, top_p, counts_ctx,
                    counts_gen, extras, count_mask):
            logits, minp = _penalized(logits, counts_ctx, counts_gen, extras)
            nxt = sample_tokens(logits, key, temperature, top_k, top_p, minp)
            lp = token_logprobs(logits, nxt)
            counts_ctx = _count_tokens(counts_ctx, nxt[:, None],
                                       count_mask[:, None])
            counts_gen = _count_tokens(counts_gen, nxt[:, None],
                                       count_mask[:, None])
            return nxt, lp, counts_ctx, counts_gen

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("num_steps", "kv_hi"))
        def _decode_rollout(params, cache, tokens, num_steps: int,
                            kv_hi=None):
            """Greedy multi-step decode fully on device (no per-token host
            round-trip — the reference paid a D2H+H2D per token,
            llama.cpp:314,392; this pays one per ``num_steps``)."""
            def body(carry, _):
                cache, toks = carry
                q_start = cache.lengths
                kv_len = q_start + 1
                logits, cache = fwd(params, cache, toks[:, None], q_start,
                                    kv_len, kv_hi)
                nxt = greedy_sample(logits)
                return (cache, nxt), nxt

            (cache, _), all_toks = jax.lax.scan(
                body, (cache, tokens), None, length=num_steps)
            return all_toks, cache

        max_room = eng.max_seq_len - 1

        @functools.partial(jax.jit, donate_argnums=(1, 2, 3),
                           static_argnames=("num_steps", "kv_hi"))
        def _sampled_rollout(params, cache, counts_ctx, counts_gen, tokens,
                             key, temp, top_k, top_p, extras,
                             active0, stop_ids, limit, num_steps: int,
                             kv_hi=None):
            """Sampled multi-step decode fully on device: one host call for
            up to ``num_steps`` tokens (vs the reference's per-token
            D2H+H2D, llama.cpp:314,392). EOS/stop-id and cache-capacity
            handling run in-graph; the while_loop exits as soon as every
            row has stopped, so early EOS costs nothing. Inactive rows
            emit -1. ``num_steps`` (static) sizes the output buffer;
            ``limit`` (dynamic) caps the steps actually run, so one
            compiled variant serves any max_new_tokens below the bucket."""
            B = tokens.shape[0]
            out0 = jnp.full((num_steps, B), -1, jnp.int32)

            def cond(st):
                i = st[0]
                act = st[6]
                return (i < limit) & act.any()

            lp0 = jnp.zeros((num_steps, B), jnp.float32)

            def body(st):
                i, cache, cc, cg, toks, key, act, out, lps = st
                act = act & (cache.lengths < max_room)
                q_start = cache.lengths
                kv_len = q_start + act.astype(jnp.int32)
                logits, cache = fwd(params, cache, toks[:, None], q_start,
                                    kv_len, kv_hi)
                logits, minp = _penalized(logits, cc, cg, extras)
                key, sub = jax.random.split(key)
                nxt = sample_tokens(logits, sub, temp, top_k, top_p, minp)
                nxt = jnp.where(act, nxt, toks)
                lp = token_logprobs(logits, nxt)
                cc = _count_tokens(cc, nxt[:, None], act[:, None])
                cg = _count_tokens(cg, nxt[:, None], act[:, None])
                out = out.at[i].set(jnp.where(act, nxt, -1))
                lps = lps.at[i].set(lp)
                stopped = (nxt[:, None] == stop_ids[None, :]).any(-1)
                return (i + 1, cache, cc, cg, nxt, key, act & ~stopped, out,
                        lps)

            _, cache, counts_ctx, counts_gen, _, _, _, out, lps = \
                jax.lax.while_loop(
                    cond, body, (jnp.int32(0), cache, counts_ctx, counts_gen,
                                 tokens, key, active0, out0, lp0))
            return out, lps, cache, counts_ctx, counts_gen

        self._prefill_fn = _prefill
        self._decode_fn = _decode_step
        self._rollout_fn = _decode_rollout
        self._sampled_rollout_fn = _sampled_rollout
        self._sample_fn = _sample

    # ------------------------------------------------------------------
    # low-level API
    # ------------------------------------------------------------------

    def _kv_watermark(self, lengths_host, extra: int) -> int:
        """Static kv upper bound for attention, bucketed to multiples of
        256 rows (bounds jit retraces to max_seq_len/256 variants). Rows
        above the watermark are never read."""
        hi = int(np.max(lengths_host)) + extra
        bucket = 256
        hi = -(-hi // bucket) * bucket
        return int(min(self.engine_config.max_seq_len, hi))

    # -- paged-mode page management (host-side; ops/paged_kv.py) ---------

    @property
    def free_pages(self) -> int:
        return self._allocator.free_pages if self.paged else 1 << 30

    def max_pool_tokens(self) -> int:
        """Largest context one request can EVER hold: max_seq_len, further
        capped by the whole paged pool (page 0 is reserved). The single
        source of truth for admission/rejection thresholds."""
        cap = self.engine_config.max_seq_len
        if self.paged:
            cap = min(cap, (self._allocator.num_pages - 1)
                      * self.engine_config.page_size)
        return cap

    def pages_needed(self, n_tokens: int) -> int:
        page = self.engine_config.page_size
        return -(-max(n_tokens, 0) // page)

    def _release_pages(self, slots: Sequence[int]) -> None:
        changed = False
        for b in slots:
            if self._slot_pages[b]:
                self._allocator.free(self._slot_pages[b])
                self._slot_pages[b] = []
                self._table_host[b, :] = 0
                changed = True
        if changed:
            self.cache = dataclasses.replace(
                self.cache, block_table=jnp.asarray(self._table_host))

    def adopt_prefix_pages(self, slot: int, pages: Sequence[int],
                           length: int) -> None:
        """Point a freshly reset slot's block table at SHARED read-only
        prefix pages (zero-copy prefix caching, runtime/prefix_cache.py
        PagedPrefixStore): the allocator refcounts them, the slot's
        length starts at the shared token count, and all later writes
        land in the slot's own pages (length is a page multiple, so the
        chunk-alignment invariant holds)."""
        assert self.paged and not self._slot_pages[slot]
        assert length % self.engine_config.page_size == 0
        self._allocator.share(pages)
        self._slot_pages[slot] = list(pages)
        self._table_host[slot, :len(pages)] = pages
        self.cache = dataclasses.replace(
            self.cache, block_table=jnp.asarray(self._table_host),
            lengths=self.cache.lengths.at[slot].set(length))

    def take_slot_pages(self, slot: int, n: int) -> list[int]:
        """Transfer ownership of a slot's first ``n`` pages to the caller
        (prefix registration: the snapshot keeps them alive after the
        scratch slot resets). The slot keeps its remaining pages."""
        assert self.paged
        pages = self._slot_pages[slot][:n]
        self._slot_pages[slot] = self._slot_pages[slot][n:]
        # the table rows shift down with the remaining pages; the slot is
        # reset right after registration, which rewrites the row anyway
        return pages

    def ensure_capacity(self, targets) -> None:
        """Grow each slot's page list to cover ``targets`` [B] tokens
        (host-side allocator + block-table update). Raises MemoryError on
        pool exhaustion — callers (the scheduler) preempt on that."""
        if not self.paged:
            return
        page = self.engine_config.page_size
        changed = False
        for b, t in enumerate(np.asarray(targets)):
            need = self.pages_needed(int(t))
            have = len(self._slot_pages[b])
            if need > have:
                new = self._allocator.alloc(need - have)
                self._table_host[b, have:have + len(new)] = new
                self._slot_pages[b].extend(new)
                changed = True
        if changed:
            self.cache = dataclasses.replace(
                self.cache, block_table=jnp.asarray(self._table_host))

    def seed_counts(self, slot: int, ctx_tokens=None, gen_tokens=None):
        """Overwrite one slot's penalty-count rows from explicit token
        lists — bookkeeping for tokens that enter the context WITHOUT
        flowing through prefill/decode counting (a restored prefix
        snapshot's tokens; a preempted request's generated-so-far tokens
        on re-admission)."""
        V = self._counts_ctx.shape[1]

        def hist(tokens):
            h = np.bincount(np.asarray(tokens, np.int64), minlength=V)[:V]
            return jnp.asarray(h, jnp.int32)

        if ctx_tokens is not None:
            self._counts_ctx = self._counts_ctx.at[slot].set(hist(ctx_tokens))
        if gen_tokens is not None:
            self._counts_gen = self._counts_gen.at[slot].set(hist(gen_tokens))

    def reset(self, slots: Optional[Sequence[int]] = None):
        """Clear history (all slots, or specific ones)."""
        if self.cp > 1:
            # the CP append logs carry state beyond lengths (kv_pos, llen)
            from llm_inference_engine.parallel.cp_cache import (
                reset_cp_cache)
            self.cache = reset_cp_cache(
                self.cache, None if slots is None else list(slots))
            if slots is None:
                self._counts_ctx = jnp.zeros_like(self._counts_ctx)
                self._counts_gen = jnp.zeros_like(self._counts_gen)
            else:
                rows = jnp.asarray(list(slots), jnp.int32)
                self._counts_ctx = self._counts_ctx.at[rows].set(0)
                self._counts_gen = self._counts_gen.at[rows].set(0)
            return
        if slots is None:
            self.cache = dataclasses.replace(
                self.cache, lengths=jnp.zeros_like(self.cache.lengths))
            self._counts_ctx = jnp.zeros_like(self._counts_ctx)
            self._counts_gen = jnp.zeros_like(self._counts_gen)
            if self.paged:
                self._release_pages(range(self.engine_config.max_batch_size))
        else:
            lengths = np.array(self.cache.lengths)  # writable copy
            lengths[list(slots)] = 0
            self.cache = dataclasses.replace(
                self.cache, lengths=jnp.asarray(lengths))
            rows = jnp.asarray(list(slots), jnp.int32)
            self._counts_ctx = self._counts_ctx.at[rows].set(0)
            self._counts_gen = self._counts_gen.at[rows].set(0)
            if self.paged:
                self._release_pages(list(slots))

    def prefill(self, prompts: Sequence[Sequence[int]],
                slots: Optional[Sequence[int]] = None,
                pad_to: int | None = None,
                kv_hi: int | None = None):
        """Prefill prompt token ids into ``slots`` (default [0, len)).

        Appends to any existing history in those slots (multi-round chat:
        the reference reran its context decoder over accumulated history
        text, llama.cpp:137-155; here only the *new* tokens are prefilled
        on top of the cached rounds). Slots not listed are untouched: their
        rows run with zero new tokens, whose cache writes land beyond their
        valid lengths and are overwritten before ever being attended.

        Prompts longer than ``max_prefill_len`` run as multiple chunked
        forward passes (each chunk attends the cache filled by its
        predecessors), bounding both jit shape variants and activation
        memory regardless of prompt length.

        ``pad_to`` / ``kv_hi``: multi-host lockstep overrides
        (parallel/multihost.py) — every host must trace the SAME chunk
        shapes, chunk-round count, and attention-watermark program
        variant, so the agreed global values drive all three regardless
        of this host's local prompts (possibly none).

        Returns last-token logits [B, V] (rows for untouched slots are
        don't-care).
        """
        eng = self.engine_config
        B = eng.max_batch_size
        if slots is None:
            slots = list(range(len(prompts)))
        if len(prompts) > B or len(slots) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts > {B} slots"
                             if len(prompts) > B else
                             f"{len(slots)} slots for {len(prompts)} prompts")
        C = max(1, eng.max_prefill_len)
        max_len = max([len(p) for p in prompts] or [0])
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        lengths_host = np.asarray(jax.device_get(self.cache.lengths))
        llen_host = (np.asarray(jax.device_get(self.cache.llen))
                     if self.cp > 1 else None)

        if pad_to is None and len(prompts) > 1:
            # near-capacity appends need a SMALLER padded bucket than
            # fresh admissions can share (a window crossing max_seq_len
            # clamps its start and would shift real rows onto history —
            # the loop below shrinks the bucket, but one bucket cannot
            # serve both a long admission chunk and an append whose slot
            # lacks that much room): run them as separate calls. "Near"
            # is judged against the bucket THIS batch would use (r4
            # review: a hard-coded 16 missed slots whose remaining room
            # sat between 16 and the shared bucket).
            C0 = max(1, eng.max_prefill_len)
            T0 = _bucket_len(max((min(len(p), C0) for p in prompts
                                  if len(p)), default=1), cap=C0)
            near = [i for i, (sl, p) in enumerate(zip(slots, prompts))
                    if len(p) and lengths_host[sl] + T0 > eng.max_seq_len]
            if near and len(near) < sum(1 for p in prompts if len(p)):
                far = [i for i in range(len(prompts)) if i not in near]
                lg_far = self.prefill([prompts[i] for i in far],
                                      slots=[slots[i] for i in far])
                lg_near = self.prefill([prompts[i] for i in near],
                                       slots=[slots[i] for i in near])
                rows_near = jnp.zeros((B,), bool).at[
                    jnp.asarray([slots[i] for i in near],
                                jnp.int32)].set(True)
                return jnp.where(rows_near[:, None], lg_near, lg_far)

        final_logits = None
        offset = 0
        while offset == 0 or offset < max_len:
            chunk_lens = np.zeros((B,), np.int32)
            chunk_max = 0
            for slot, p in zip(slots, prompts):
                n = min(max(len(p) - offset, 0), C)
                chunk_lens[slot] = n
                chunk_max = max(chunk_max, n)
            if pad_to is not None:
                chunk_max = max(chunk_max, min(max_len - offset, C))
            T = _bucket_len(max(chunk_max, 1), cap=C)
            # near capacity the PADDED window must not cross the cache
            # end: the write clamps its start to S - T, which would shift
            # real rows onto older valid history (silent corruption —
            # found by r4 review). Shrink the bucket for this chunk (down
            # to an exact-fit tail bucket when no power of two serves);
            # if the real tokens themselves cannot fit, refuse loudly.
            # Single-host path only: lockstep hosts must trace identical
            # chunk shapes from the AGREED pad_to/kv_hi, and their
            # admission plan keeps capacity margins, so a host-local
            # shrink would desync the group (r4 review).
            S = eng.max_seq_len
            s_local = S // self.cp
            active_rows = chunk_lens > 0
            if pad_to is None and active_rows.any():
                qmax = int(lengths_host[active_rows].max())
                lmax = (int(np.max(llen_host[active_rows]))
                        if llen_host is not None else 0)

                def crosses(t):
                    return (qmax + t > S
                            or (self.cp > 1
                                and lmax + max(1, t // self.cp) > s_local))

                # floor: the real tokens, and under cp a >=2-row chunk
                # per rank (T // cp == 1 would look like the decode path)
                t_floor = max(chunk_max, 2 * self.cp if self.cp > 1 else 1)
                while T > 1 and T // 2 >= t_floor and crosses(T):
                    T //= 2
                if crosses(T) and chunk_max <= S - qmax:
                    # exact-fit tail: room for the real tokens, but below
                    # any power-of-two bucket (e.g. a 13-token append
                    # with 14 rows left)
                    fit = S - qmax
                    if self.cp > 1:
                        fit = min(fit, (s_local - lmax) * self.cp)
                        fit -= fit % self.cp
                    if fit >= t_floor and not crosses(fit):
                        T = fit
                if crosses(T):
                    raise ValueError(
                        f"prefill append at history {qmax} cannot fit a "
                        f"{T}-token padded chunk inside max_seq_len {S}"
                        + (f" (cp={self.cp}: a rank's local log is at "
                           f"{lmax}/{s_local})" if self.cp > 1 else "")
                        + "; the request exceeds the slot's remaining "
                        "capacity — raise max_seq_len or finish the slot")
            token_ids = np.zeros((B, T), np.int32)
            for slot, p in zip(slots, prompts):
                chunk = p[offset:offset + chunk_lens[slot]]
                token_ids[slot, :len(chunk)] = np.asarray(chunk, np.int32)

            if llen_host is not None:
                # CP append logs fill unevenly across ragged chunks (rank 0
                # takes each chunk's head); mirror the deterministic llen
                # update host-side and refuse before a local log overflows
                # (parallel/cp_cache.py placement rules)
                t_local = max(T // self.cp, 1)
                s_local = self.engine_config.max_seq_len // self.cp
                llen_host = llen_host + np.clip(
                    chunk_lens[:, None]
                    - np.arange(self.cp)[None, :] * t_local, 0, t_local)
                if (llen_host > s_local).any():
                    raise ValueError(
                        f"cp={self.cp}: a rank's local KV log would exceed "
                        f"its {s_local}-row capacity (ragged chunked "
                        "prefill skews fills toward rank 0); raise "
                        "max_seq_len or prefill in fewer, larger chunks")

            q_start = self.cache.lengths
            kv_hi_r = (kv_hi if kv_hi is not None
                       else self._kv_watermark(lengths_host + chunk_lens, 0))
            if self.paged:
                # the paged write kernel's chunk DMA must stay within one
                # page: multi-token writes start at a multiple of C
                # (guaranteed for prompts admitted from 0; multi-round
                # append at arbitrary history needs the slot layout)
                bad = (chunk_lens > 1) & (lengths_host % C != 0)
                if bad.any():
                    raise ValueError(
                        "paged KV: multi-token prefill must start at a "
                        f"multiple of max_prefill_len={C} (slots "
                        f"{np.nonzero(bad)[0].tolist()} are mid-page); "
                        "use kv_layout='slot' for arbitrary-offset appends")
                self.ensure_capacity(lengths_host + chunk_lens)
            kv_len = q_start + jnp.asarray(chunk_lens)
            logits, self.cache, self._counts_ctx = self._prefill_fn(
                self.params, self.cache, self._counts_ctx,
                jnp.asarray(token_ids), q_start, kv_len, kv_hi=kv_hi_r)
            self.cache = dataclasses.replace(self.cache, lengths=kv_len)
            lengths_host = lengths_host + chunk_lens

            if final_logits is None:
                final_logits = logits
            else:
                # a slot's logits come from the chunk holding its last token
                had_tokens = jnp.asarray(chunk_lens > 0)
                final_logits = jnp.where(had_tokens[:, None], logits,
                                         final_logits)
            offset += C
        return final_logits

    def _neutral_extras(self):
        """(min_p, repetition, presence, frequency) identity values."""
        B = self.engine_config.max_batch_size
        return (jnp.zeros((B,), jnp.float32), jnp.ones((B,), jnp.float32),
                jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.float32))

    def _sampling_arrays(self, sp: SamplingParams):
        """Per-slot arrays (temperature, top_k, top_p) + the extras tuple
        (min_p, repetition, presence, frequency)."""
        B = self.engine_config.max_batch_size
        t = 0.0 if sp.greedy else sp.temperature
        extras = (jnp.full((B,), sp.min_p, jnp.float32),
                  jnp.full((B,), sp.repetition_penalty, jnp.float32),
                  jnp.full((B,), sp.presence_penalty, jnp.float32),
                  jnp.full((B,), sp.frequency_penalty, jnp.float32))
        return (jnp.full((B,), t, jnp.float32),
                jnp.full((B,), sp.top_k, jnp.int32),
                jnp.full((B,), sp.top_p, jnp.float32), extras)

    @staticmethod
    def _unpack_arrays(arrays):
        """(temp, topk, topp[, extras]) -> 4-tuple with extras=None when
        the legacy 3-tuple arrives."""
        if len(arrays) == 3:
            return (*(jnp.asarray(a) for a in arrays), None)
        temp, topk, topp, extras = arrays
        return (jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp),
                tuple(jnp.asarray(e) for e in extras))

    def sample(self, logits, temperature, top_k, top_p, extras=None,
               count_mask=None, return_logprobs: bool = False):
        """Sample token ids from logits with per-slot params [B].

        ``extras``: (min_p, repetition, presence, frequency) per-slot
        arrays (None = neutral). ``count_mask`` [B] bool marks the rows
        whose sampled token enters this slot's penalty counts (rows whose
        sample is discarded — e.g. mid-prefill chunks — must not count).
        ``return_logprobs``: also return the sampled tokens' [B] log
        probabilities under the (penalized) model distribution."""
        self._key, sub = jax.random.split(self._key)
        if extras is None:
            extras = self._neutral_extras()
        if count_mask is None:
            count_mask = np.zeros((logits.shape[0],), bool)
        nxt, lp, self._counts_ctx, self._counts_gen = self._sample_fn(
            logits, sub, jnp.asarray(temperature), jnp.asarray(top_k),
            jnp.asarray(top_p), self._counts_ctx, self._counts_gen,
            tuple(jnp.asarray(e) for e in extras), jnp.asarray(count_mask))
        return (nxt, lp) if return_logprobs else nxt

    def decode_step(self, tokens, active, sp_or_arrays,
                    kv_hi: int | None = None,
                    return_logprobs: bool = False):
        """One decode step over all slots. tokens/active: [B] device or np.
        ``sp_or_arrays``: a SamplingParams (uniform) or a (temperature,
        top_k, top_p[, extras]) tuple of per-slot [B] arrays. ``kv_hi``:
        multi-host lockstep override of the static attention watermark
        (every host must trace the same decode-program variant)."""
        if isinstance(sp_or_arrays, SamplingParams):
            temp, topk, topp, extras = self._sampling_arrays(sp_or_arrays)
        else:
            temp, topk, topp, extras = self._unpack_arrays(sp_or_arrays)
        if extras is None:
            extras = self._neutral_extras()
        self._key, sub = jax.random.split(self._key)
        active_host = np.asarray(active).astype(np.int32)
        active = jnp.asarray(active)
        if self.paged or kv_hi is None:     # ONE host sync for both uses
            lengths_host = np.asarray(jax.device_get(self.cache.lengths))
        if self.paged:
            self.ensure_capacity(lengths_host + active_host)
        if kv_hi is None:
            kv_hi = self._kv_watermark(lengths_host, 1)
        nxt, lp, self.cache, self._counts_ctx, self._counts_gen = \
            self._decode_fn(
                self.params, self.cache, self._counts_ctx, self._counts_gen,
                jnp.asarray(tokens), active, sub, temp, topk, topp, extras,
                kv_hi=kv_hi)
        return (nxt, lp) if return_logprobs else nxt

    def decode_rollout(self, tokens, num_steps: int):
        """Greedy decode ``num_steps`` tokens for all slots in ONE device
        call (lax.scan over steps). Returns [num_steps, B] token ids.
        Used by benchmarks and batch completion; per-token streaming uses
        decode_step instead."""
        if self.paged:   # device-side loops cannot allocate: pre-reserve
            self.ensure_capacity(
                np.asarray(jax.device_get(self.cache.lengths)) + num_steps)
        kv_hi = self._kv_watermark(
            np.asarray(jax.device_get(self.cache.lengths)), num_steps)
        toks, self.cache = self._rollout_fn(
            self.params, self.cache, jnp.asarray(tokens), num_steps,
            kv_hi=kv_hi)
        return toks

    # ------------------------------------------------------------------
    # generation loop (reference: response(), llama.cpp:322-398)
    # ------------------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: SamplingParams = SamplingParams(),
                 eos_token_id: int | None = 2,
                 stream_callback: Optional[Callable[[int, int], None]] = None
                 ) -> GenerationResult:
        """Generate completions for up to max_batch_size prompts.

        stream_callback(seq_index, token_id) fires per generated token
        (reference CallBack protocol, basemodel.h:12 / user_entry.cpp:25-37).
        """
        nseq = len(prompts)
        B = self.engine_config.max_batch_size

        first_logits = self.prefill(prompts)
        temp, topk, topp, extras = self._sampling_arrays(sampling)
        count_mask = np.arange(B) < nseq
        tokens, first_lp = self.sample(first_logits, temp, topk, topp,
                                       extras, count_mask,
                                       return_logprobs=True)
        first_lp_host = np.asarray(first_lp)

        stop_ids = set(sampling.stop_token_ids)
        if eos_token_id is not None:
            stop_ids.add(eos_token_id)

        out: list[list[int]] = [[] for _ in range(nseq)]
        lp_out: list[list[float]] = [[] for _ in range(nseq)]
        done = np.zeros((B,), bool)
        done[nseq:] = True
        active = ~done

        tok_host = np.asarray(tokens)
        for i in range(nseq):
            if tok_host[i] in stop_ids:
                done[i] = True
            else:
                out[i].append(int(tok_host[i]))
                lp_out[i].append(float(first_lp_host[i]))
                if stream_callback:
                    stream_callback(i, int(tok_host[i]))

        max_room = self.engine_config.max_seq_len - 1
        steps = sampling.max_new_tokens - 1
        if stream_callback is None and steps > 0 and not done.all():
            # no streaming: whole tail in ONE device call (sampled rollout,
            # device-side eos/capacity, early exit when all rows stop)
            num_steps = _bucket_len(steps, floor=16)
            if self.paged:   # pre-reserve the rollout's worst case
                lh = np.asarray(jax.device_get(self.cache.lengths))
                self.ensure_capacity(
                    np.minimum(lh + np.where(done, 0, steps), max_room + 1))
            kv_hi = self._kv_watermark(
                np.asarray(jax.device_get(self.cache.lengths)), steps)
            stop_arr = jnp.asarray(sorted(stop_ids) or [-2], jnp.int32)
            temp, topk, topp, extras = self._sampling_arrays(sampling)
            self._key, sub = jax.random.split(self._key)
            (rolled, rolled_lp, self.cache, self._counts_ctx,
             self._counts_gen) = self._sampled_rollout_fn(
                self.params, self.cache, self._counts_ctx, self._counts_gen,
                jnp.asarray(tokens), sub, temp,
                topk, topp, extras, jnp.asarray(~done), stop_arr,
                jnp.int32(steps), num_steps=num_steps, kv_hi=kv_hi)
            host = np.asarray(rolled)
            lp_host = np.asarray(rolled_lp)
            for row, lp_row in zip(host, lp_host):
                for i in range(nseq):
                    t = int(row[i])
                    if done[i] or t < 0:
                        continue
                    if t in stop_ids:
                        done[i] = True
                    else:
                        out[i].append(t)
                        lp_out[i].append(float(lp_row[i]))
        else:
            for _ in range(steps):
                if done.all():
                    break
                active = ~done
                lengths = np.asarray(self.cache.lengths)
                room = lengths < max_room
                active &= room
                if not active.any():
                    break
                tokens, step_lp = self.decode_step(tokens, active, sampling,
                                                   return_logprobs=True)
                tok_host = np.asarray(tokens)
                lp_host = np.asarray(step_lp)
                for i in range(nseq):
                    if done[i] or not active[i]:
                        continue
                    t = int(tok_host[i])
                    if t in stop_ids:
                        done[i] = True
                        continue
                    out[i].append(t)
                    lp_out[i].append(float(lp_host[i]))
                    if stream_callback:
                        stream_callback(i, t)

        # A length-terminated row's FINAL sampled token was never fed back,
        # so its K/V is absent from the cache; top it up with a one-token
        # prefill so multi-round appends see the full conversation (pinned
        # by the flat-replay logits parity test). EOS-terminated rows are
        # complete already (the stop token is not part of the history).
        lengths_now = np.asarray(jax.device_get(self.cache.lengths))
        pending = [i for i in range(nseq)
                   if out[i] and not done[i]
                   and lengths_now[i] == len(prompts[i]) + len(out[i]) - 1]
        if pending:
            self.prefill([[out[i][-1]] for i in pending], slots=pending)
            # the token was already counted when sampled; undo the
            # prefill's context-count increment (exact bookkeeping)
            rows = jnp.asarray(pending, jnp.int32)
            toks = jnp.asarray([out[i][-1] for i in pending], jnp.int32)
            self._counts_ctx = self._counts_ctx.at[rows, toks].add(-1)

        return GenerationResult(
            token_ids=out,
            num_prompt_tokens=[len(p) for p in prompts],
            num_generated=[len(o) for o in out],
            logprobs=lp_out,
        )
