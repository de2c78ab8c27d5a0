"""Multi-host (pod-slice) support: jax.distributed wiring + hybrid meshes.

The reference is strictly single-process/single-device (SURVEY.md §2f).
This module is the scale-out tier of the framework: process bootstrap via
``jax.distributed`` and meshes whose tensor-parallel groups stay within one
host, so collectives ride the intra-host interconnect wherever possible.

Design:
- tensor parallelism stays INSIDE a host — its per-layer psums are
  latency-critical and must ride the intra-host interconnect;
- data parallelism (batch slots / replicas) crosses hosts over the
  network — decode steps exchange nothing across DP ranks except
  scheduler metadata, so network latency never sits on the token path;
- each host runs its own request queue and continuous-batching scheduler
  over its local batch-slot shard; the jitted step functions are identical
  on every host (GSPMD requirement: all hosts execute the same program).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from llm_inference_engine.parallel.mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["initialize_multihost", "make_multihost_mesh", "StepPlan",
           "agree_step_plan"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed (no-op if already initialized or if the
    cluster environment provides all three arguments)."""
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        # single-process environment (tests, one host): nothing to do
        pass


def make_multihost_mesh(dp: int = 1, tp: int = 1,
                        devices: Optional[Sequence[jax.Device]] = None
                        ) -> Mesh:
    """(data=dp, model=tp) mesh laid out so the model axis never crosses
    hosts: devices are ordered host-major by jax, so reshaping
    [hosts*per_host] -> [dp, tp] keeps each tp group within one host's
    devices as long as tp divides the per-host device count — asserted
    here. Collectives on ``model`` then stay within a host; only ``data``
    spans hosts.
    """
    if devices is None:
        devices = jax.devices()
    n = dp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices for dp={dp} tp={tp}, "
                         f"have {len(devices)}")
    devices = list(devices[:n])
    per_host: dict = {}
    for d in devices:
        per_host.setdefault(d.process_index, []).append(d)
    counts = {len(v) for v in per_host.values()}
    if len(counts) == 1:
        (c,) = counts
        if tp > c and tp % c != 0 and c % tp != 0:
            raise ValueError(
                f"tp={tp} does not tile the {c} devices per host; model-"
                f"axis collectives would cross hosts")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


# ---------------------------------------------------------------------------
# Lockstep step planning (the hard part of multi-host continuous batching,
# SURVEY.md §7: requests arrive asynchronously per host, but every host
# must enter the SAME jitted program with the same static arguments, or
# the program's collectives deadlock)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The per-step program choice every host agrees on.

    ``prefill_len``: padded prompt-chunk length bucket this step (0 = no
    host admits work — skip the prefill program entirely); hosts with no
    admissions still execute the prefill with zero-length rows, whose
    cache writes land beyond their valid lengths (InferenceEngine.prefill
    semantics) — same program, no-op content.
    ``kv_hi``: global static attention watermark = max over hosts, so one
    decode-program variant serves every host's longest sequence.
    ``any_work``: False only when every host is idle — the driver loop's
    termination condition (hosts must also EXIT in lockstep).
    """

    prefill_len: int
    kv_hi: int
    any_work: bool


def agree_step_plan(local_prefill_len: int, local_kv_hi: int,
                    local_has_work: bool) -> StepPlan:
    """All-gather each host's step metadata (3 int32 across hosts — never on
    the token path's critical collectives) and reduce DETERMINISTICALLY so
    all hosts compute the identical plan:

        prefill_len = max over hosts (shorter chunks pad up — one shape
                      bucket, one compiled prefill variant per step),
        kv_hi       = max over hosts,
        any_work    = or over hosts.

    Works unchanged in a single process (process_allgather returns this
    process's row alone)."""
    from jax.experimental import multihost_utils

    vec = np.asarray([int(local_prefill_len), int(local_kv_hi),
                      int(bool(local_has_work))], np.int32)
    rows = np.asarray(multihost_utils.process_allgather(vec))
    rows = rows.reshape(-1, 3)
    return StepPlan(
        prefill_len=int(rows[:, 0].max()),
        kv_hi=int(rows[:, 1].max()),
        any_work=bool(rows[:, 2].any()),
    )
