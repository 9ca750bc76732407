"""Device selection primitives shared by the join engines."""

from __future__ import annotations

import jax.numpy as jnp


def topk_mask_indices(mask, idx, K):
    """The K largest values of `idx` where `mask` is set, descending,
    padded with -1 — `idx` must be ascending (arange).

    Drop-in for ``lax.top_k(where(mask, idx, -1), K)[0]``.  A
    suffix-count rank compaction (one cumsum + one K-wide scatter) is
    deterministic, cheaper than a partial sort, and has no
    data-dependent pathologies.

    This compaction is used over top_k because it is cheaper and fully
    predictable.
    """
    cmi = mask.astype(jnp.int32)
    # rank r_i = number of set positions with index > i: 0 for the
    # largest candidate, 1 for the next, ...
    r = cmi.sum() - jnp.cumsum(cmi)
    slot = jnp.where(mask & (r < K), r, K)
    return jnp.full(K, -1, jnp.int32).at[slot].set(
        idx.astype(jnp.int32), mode="drop")
