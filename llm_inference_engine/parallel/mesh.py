"""Device mesh construction.

The reference has no distributed tier at all (SURVEY.md §2f: single device,
single stream, bs=1). This module is the communication backend: a
``jax.sharding.Mesh`` over which GSPMD/shard_map place XLA collectives
(NCCL on GPUs — over NVLink within a host, the network across hosts).

Axes:
- ``data``  — batch-slot parallelism (each rank owns a slice of the decode
  batch and of the KV cache's batch axis);
- ``seq``   — context parallelism (the KV cache's token capacity splits
  over ranks; prefill runs ring attention, decode split-KV —
  parallel/context_parallel.py + parallel/cp_engine.py);
- ``model`` — tensor parallelism (column-sharded QKV/gate-up, row-sharded
  o/down with a psum after each, KV cache sharded over kv-head groups).

The mesh is a plain reshape of the device list with ``model`` innermost:
within one host every card reaches every other over NVLink at the same
rate, so the layout follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "local_config", "validate_mesh"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


def make_mesh(dp: int = 1, tp: int = 1, cp: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (data=dp, seq=cp, model=tp) mesh.

    ``devices`` defaults to ``jax.devices()``; pass
    ``jax.devices("cpu")`` for the virtual-device test/dryrun path.
    """
    if devices is None:
        devices = jax.devices()
    n = dp * cp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices for dp={dp} cp={cp} tp={tp}, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(dp, cp, tp)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS, MODEL_AXIS))


def validate_mesh(config, engine_config, mesh: Mesh) -> None:
    """Static divisibility checks for the TP/DP/CP layout."""
    tp = mesh.shape[MODEL_AXIS]
    dp = mesh.shape[DATA_AXIS]
    cp = mesh.shape.get(SEQ_AXIS, 1)
    problems = []
    if cp > 1 and engine_config.max_seq_len % cp:
        problems.append(f"max_seq_len {engine_config.max_seq_len} % cp {cp}")
    if cp > 1 and max(1, engine_config.max_prefill_len) % cp:
        problems.append(
            f"max_prefill_len {engine_config.max_prefill_len} % cp {cp}")
    if cp > 1 and engine_config.max_prefill_len < 2 * cp:
        # a prefill chunk must give every rank >= 2 query rows (a 1-row
        # chunk is indistinguishable from the decode fast path)
        problems.append(
            f"max_prefill_len {engine_config.max_prefill_len} < 2*cp")
    if cp > 1 and (cp & (cp - 1) or cp > 8):
        # prefill chunk buckets are powers of two >= 16 (engine._bucket_len)
        # and every bucket must split evenly over the seq axis with a
        # per-rank chunk of >= 2 tokens (t_local == 1 means decode)
        problems.append(f"cp {cp} must be a power of two <= 8")
    if config.num_kv_heads % tp:
        problems.append(f"num_kv_heads {config.num_kv_heads} % tp {tp}")
    if config.intermediate_size % tp:
        problems.append(
            f"intermediate_size {config.intermediate_size} % tp {tp}")
    if config.vocab_size % tp:
        problems.append(f"vocab_size {config.vocab_size} % tp {tp}")
    if engine_config.max_batch_size % dp:
        problems.append(
            f"max_batch_size {engine_config.max_batch_size} % dp {dp}")
    if problems:
        raise ValueError("mesh/config mismatch: " + "; ".join(problems))


def local_config(config, mesh: Mesh):
    """The per-rank model shape under tensor parallelism (what the local
    function inside shard_map computes with)."""
    tp = mesh.shape[MODEL_AXIS]
    return config.replace(
        num_heads=config.num_heads // tp,
        num_kv_heads=config.num_kv_heads // tp,
    )
