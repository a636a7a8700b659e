"""Line-of-sight gating of long graph edges vs the aggregated lethal cloud.

Re-designs `A_Star_on_Graph::isLineOfSightClear`
(`a_star_on_pc.cpp:168-198`): the reference verifies every expansion jump
≥ 2×inscribed_radius by sampling the segment every inscribed radius and
radius-searching the aggregated lethal cloud (built by
`StackedPerception::aggregateLethal`, `stacked_perception.cpp:142-155`)
with radius 2×inscribed — **more than one** lethal hit at any sample ⇒ the
edge is forbidden. In the precomputed (G, K) neighbor table, edges that
long exist only through the kNN orphan fallback (`a_star_on_pc.cpp:241-244`),
so instead of per-pop searches we batch-verify the small long-edge set
once per lethal-cloud update:

  1. gather the ≤ E long edges (step ≥ 2×inscribed) from the table,
  2. sample S points along each (uniform; spacing ≤ inscribed for edges up
     to S×inscribed long — finer than the reference's stride, never
     coarser for in-budget edges),
  3. count lethal points within 2×inscribed of each sample (one fused
     (E·S, L) distance matrix), blocked when count > 1,
  4. scatter the verdicts back into a (G, K) edge mask.

The mask ANDs into ``nbr_valid`` for both relaxation and extraction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.ops.compaction import first_k_true_indices


def long_edge_los_mask(nbr_idx, nbr_dist, nbr_valid, positions,
                       lethal_pts, lethal_valid, *,
                       inscribed_radius: float,
                       max_long_edges: int = 4096,
                       samples: int = 32):
    """(G, K) bool mask: False = long edge blocked by the lethal cloud.

    Args:
      nbr_idx/nbr_dist/nbr_valid: (G, K) padded neighbor table.
      positions: (G, 3) ground node positions.
      lethal_pts: (L, 3) padded aggregated lethal cloud.
      lethal_valid: (L,) bool.
      inscribed_radius: lethal radius; jumps ≥ 2× this get verified.
      max_long_edges: static budget for the gathered long-edge set. Edges
        beyond the budget stay unverified (permissive, like a reference
        run whose kd-tree happened to be empty); sized ≳ 2× the orphan
        count so real maps never clip.
      samples: per-edge sample count.
    """
    g, k = nbr_idx.shape
    long_edge = nbr_valid & (nbr_dist >= 2.0 * inscribed_radius)
    flat = long_edge.reshape(-1)
    e_idx = first_k_true_indices(flat, max_long_edges)
    e_ok = e_idx >= 0
    safe_e = jnp.maximum(e_idx, 0)
    src = safe_e // k
    dst = jnp.maximum(nbr_idx.reshape(-1)[safe_e], 0)

    p0 = positions[src]                       # (E, 3)
    p1 = positions[dst]
    t = jnp.linspace(0.0, 1.0, samples, dtype=jnp.float32)  # (S,)
    pts = p0[:, None, :] + t[None, :, None] * (p1 - p0)[:, None, :]  # (E,S,3)

    lp = jnp.where(lethal_valid[:, None], lethal_pts, jnp.inf)
    # (E*S, L) squared distances; |a-b|^2 expansion keeps one big buffer
    a = pts.reshape(-1, 3)
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(lethal_pts * lethal_pts, axis=-1)
    cross = jnp.dot(a, lethal_pts.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    d2 = a2[:, None] + b2[None, :] - 2.0 * cross
    hit = (d2 <= (2.0 * inscribed_radius) ** 2) & lethal_valid[None, :]
    counts = jnp.sum(hit, axis=-1).reshape(-1, samples)     # (E, S)
    blocked = jnp.any(counts > 1, axis=-1) & e_ok           # reference: >1

    mask_flat = jnp.ones((g * k,), bool)
    mask_flat = mask_flat.at[jnp.where(e_ok, safe_e, g * k)].set(
        ~blocked, mode="drop")
    return mask_flat.reshape(g, k)


def lethal_cloud_from_dgraph(ground, ground_valid, dgraph, *,
                             inscribed_radius: float, max_lethal: int = 2048):
    """Aggregated lethal cloud: ground-node positions whose distance field
    is lethal (`MultiLayerSpinningLidar::updateLethalPointCloud`,
    `multilayer_spinning_lidar.cpp:283-306`: lethal_map entries are ground
    node ids). Returns ((L, 3) pts, (L,) valid)."""
    lethal = ground_valid & (dgraph <= inscribed_radius)
    idx = first_k_true_indices(lethal, max_lethal)
    ok = idx >= 0
    pts = ground[jnp.maximum(idx, 0)]
    pts = jnp.where(ok[:, None], pts, 1e6)   # park invalid rows far away
    return pts, ok
