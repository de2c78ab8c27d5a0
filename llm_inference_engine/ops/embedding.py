"""Token-embedding gather.

Capability parity with ``launchInputEmbedding`` (reference:
src/kernels/input_embedding.cu:25-51 — a grid-stride gather of embedding rows
by token id). A gather of [T] rows from [V, H] lowers to one XLA gather;
a hand-written kernel would only re-derive XLA's own plan (this mirrors how
the GEMMs map to dot_general rather than hand-written kernels, SURVEY.md
§2a footer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["embedding_lookup"]


def embedding_lookup(table: jax.Array, token_ids: jax.Array) -> jax.Array:
    """table: [vocab, hidden]; token_ids: int[...] -> [..., hidden]."""
    return jnp.take(table, token_ids, axis=0)
