"""First-k true-index compaction.

``jnp.nonzero(mask, size=k)`` lowers to a window-length cumsum + scatter.
``lax.top_k`` over the negated index reproduces the EXACT same result —
the first k true indices in ascending order, -1 padded — without the
scatter, which serialized on the accelerator this was first written for.
Chosen before the port to the H100; not re-measured there.

Bit-compatibility: scores are unique (one per index), so top_k's order is
deterministic and equals nonzero's ascending-index order exactly; every
parity oracle stays valid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def first_k_true_indices(mask, k: int):
    """Indices of the first ``k`` True entries of a 1-D mask, ascending,
    padded with -1 — drop-in for ``jnp.nonzero(mask, size=k,
    fill_value=-1)[0]``.

    The ``k >= n`` case ALSO rides top_k (k clamped to n, -1 padding
    appended): the nonzero fallback's cumsum+scatter lowers to a
    pathological batched scatter under vmap — measured as the dominant
    hidden cost of the fleet tick's near-node extraction (the scatter
    serialized per robot while top_k stays on the sort unit)."""
    n = mask.shape[0]
    kk = min(k, n)
    iota = jnp.arange(n, dtype=jnp.int32)
    score = jnp.where(mask, -iota, jnp.int32(-n - 1))
    v, _ = jax.lax.top_k(score, kk)
    idx = -v
    idx = jnp.where(idx > n - 1, -1, idx)
    if kk < k:
        idx = jnp.concatenate(
            [idx, jnp.full((k - kk,), -1, jnp.int32)])
    return idx
