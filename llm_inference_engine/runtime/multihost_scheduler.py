"""Multi-host continuous batching: lockstep scheduling + request routing.

The reference is single-process (SURVEY.md §2f); this is the scale-out
serving tier. Two deployment shapes (parallel/multihost.py):

1. **DP across hosts** (model fits a host's slice): every host runs an
   independent engine + ContinuousBatchingScheduler over its local chips;
   nothing crosses hosts on the token path. ``RequestRouter`` is the front
   door that spreads an open request stream over those per-host
   schedulers (least-loaded placement).

2. **Model axis crosses hosts** (model larger than a host's slice): all
   hosts execute ONE sharded jitted program whose collectives span hosts —
   so every host must enter the same program with the same static
   arguments each step, even though requests arrive asynchronously per
   host. ``MultiHostScheduler`` provides that lockstep: before every
   step it all-gathers 3 scalars of metadata (parallel/multihost.py
   agree_step_plan) and derives the identical (prefill length bucket,
   kv watermark, keep-running) triple on every host. Hosts with no local
   admissions still run the agreed prefill with zero-length rows; hosts
   with no work still run decode with an all-false active mask; all
   hosts exit together only when no host has work.

In a single process the agreement is the identity, so the lockstep
scheduler behaves exactly like ContinuousBatchingScheduler — pinned by
tests/test_multihost_scheduler.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from llm_inference_engine.config import SamplingParams
from llm_inference_engine.parallel.multihost import agree_step_plan
from llm_inference_engine.runtime.engine import _bucket_len
from llm_inference_engine.runtime.scheduler import (
    ContinuousBatchingScheduler, Request)

__all__ = ["MultiHostScheduler", "RequestRouter"]


class MultiHostScheduler(ContinuousBatchingScheduler):
    """ContinuousBatchingScheduler with every step gated on the cross-host
    StepPlan. See module docstring (shape 2)."""

    def __init__(self, engine, eos_token_id=2, prefix_store=None):
        if getattr(engine, "paged", False):
            raise NotImplementedError(
                "paged KV + lockstep multihost scheduling: preemption and "
                "page allocation are host-local; use the DP router shape")
        super().__init__(engine, eos_token_id, prefix_store)

    def step(self) -> list[Request]:
        """One lockstep step. Program choice is GLOBAL: the agreed plan
        decides whether every host runs the mixed chunked-prefill program
        (any host has a chunk in flight — local chunks pad to the agreed
        bucket; hosts without admissions feed their live rows' pending
        decode tokens as length-1 chunks, idle hosts all-zero rows) or the
        pure single-token decode program. Exactly one jitted program per
        step on every host — collectives stay aligned by construction."""
        before = [r for r in self.slots if r is not None]
        done: list[Request] = []

        admitted = self._assign_slots()
        for r in admitted:
            r.prefill_pos = 0
        if admitted:
            self.engine.reset([r.slot for r in admitted])
        done += [r for r in admitted if r.finished]

        C = max(1, self.engine.engine_config.max_prefill_len)
        prefilling = [r for r in self.slots
                      if r is not None and r.prefill_pos is not None]

        # lockstep point: agree on this step's chunk-length bucket (0 on
        # hosts with nothing mid-prefill; the max drives every host) and
        # the attention watermark over the lengths the cache will have
        # AFTER this step's writes (chunk for prefilling rows, +1 for
        # decoding rows)
        local_chunk = max([min(len(r.prompt_ids) - r.prefill_pos, C)
                           for r in prefilling] or [0])
        local_len = _bucket_len(local_chunk, cap=C) if local_chunk else 0
        projected = np.asarray(self.engine.cache.lengths).copy()
        for r in self.slots:
            if r is None:
                continue
            if r.prefill_pos is not None:
                projected[r.slot] += min(len(r.prompt_ids) - r.prefill_pos, C)
            else:
                projected[r.slot] += 1
        local_kv_hi = self.engine._kv_watermark(projected, 0)
        plan = agree_step_plan(local_len, local_kv_hi, self.has_work)
        self._plan = plan
        if not plan.any_work:
            return done

        if plan.prefill_len > 0:
            chunks: list[list[int]] = []
            call_slots: list[int] = []
            decode_rows: list[Request] = []
            for r in self.slots:
                if r is None:
                    continue
                if r.prefill_pos is not None:
                    chunk = r.prompt_ids[r.prefill_pos:r.prefill_pos + C]
                    r.prefill_pos += len(chunk)
                    chunks.append(chunk)
                else:
                    chunks.append([int(self._last_token[r.slot])])
                    decode_rows.append(r)
                call_slots.append(r.slot)
            logits = self.engine.prefill(chunks, slots=call_slots,
                                         pad_to=plan.prefill_len,
                                         kv_hi=plan.kv_hi)
            count_mask = np.zeros((self.B,), bool)
            for r in decode_rows:
                count_mask[r.slot] = True
            for r in prefilling:
                count_mask[r.slot] = r.prefill_pos >= len(r.prompt_ids)
            nxt, lp = self.engine.sample(
                logits, self._temp, self._topk, self._topp,
                extras=self._samp_arrays[3], count_mask=count_mask,
                return_logprobs=True)
            nxt, lp = np.asarray(nxt), np.asarray(lp)
            for r in decode_rows:
                self._accept_token(r, int(nxt[r.slot]), float(lp[r.slot]))
            for r in prefilling:
                if r.prefill_pos >= len(r.prompt_ids):
                    r.prefill_pos = None
                    self._accept_token(r, int(nxt[r.slot]),
                                       float(lp[r.slot]))
        else:
            active_mask = np.array([r is not None and not r.finished
                                    for r in self.slots], bool)
            nxt, lp = self.engine.decode_step(
                self._last_token, active_mask, self._samp_arrays,
                kv_hi=plan.kv_hi, return_logprobs=True)
            nxt, lp = np.asarray(nxt), np.asarray(lp)
            for slot in np.nonzero(active_mask)[0]:
                req = self.slots[slot]
                if req is not None:
                    self._accept_token(req, int(nxt[slot]),
                                       float(lp[slot]))

        done += [r for r in before + admitted
                 if r.finished and r not in done]
        return done

    def run(self, max_steps: int = 1_000_000) -> list[Request]:
        """Drive until NO host has work (the agreed any_work flag — hosts
        must exit in lockstep, not when their local queue drains)."""
        finished: list[Request] = []
        self._plan = None
        for _ in range(max_steps):
            finished += self.step()
            if not self._plan.any_work:
                break
        return finished


class RequestRouter:
    """Front door for DP-across-hosts serving (shape 1): spread requests
    over independent per-host schedulers, least-loaded first."""

    def __init__(self, schedulers: Sequence[ContinuousBatchingScheduler]):
        if not schedulers:
            raise ValueError("need at least one scheduler")
        self.schedulers = list(schedulers)

    def _load(self, s: ContinuousBatchingScheduler) -> tuple[int, int]:
        return (len(s.waiting), s.num_active)

    def submit(self, prompt_ids: Sequence[int],
               sampling: SamplingParams = SamplingParams(),
               stream_callback=None) -> Request:
        target = min(self.schedulers, key=self._load)
        return target.submit(prompt_ids, sampling, stream_callback)

    @property
    def has_work(self) -> bool:
        return any(s.has_work for s in self.schedulers)

    def step(self) -> list[Request]:
        """One step on every host's scheduler (in a real deployment each
        host steps its own; this drives them all for single-process use)."""
        done: list[Request] = []
        for s in self.schedulers:
            if s.has_work:
                done += s.step()
        return done

    def run(self, max_steps: int = 1_000_000) -> list[Request]:
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            finished += self.step()
        return finished
