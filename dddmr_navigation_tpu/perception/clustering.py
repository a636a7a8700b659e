"""Euclidean cluster extraction, data-parallel style.

The reference segments each scan with PCL's EuclideanClusterExtraction
(KD-tree flood fill, `multilayer_spinning_lidar.cpp:327-336`) and then
accepts/rejects whole clusters by centroid tests. Here we voxelize the
scan into the perception window and run **connected-component labeling by
iterative min-label propagation**: every occupied cell starts with its own
linear index as label; each sweep takes the min label over the
neighborhood cube implied by the cluster tolerance (via
``lax.reduce_window``); convergence is geometric in cluster diameter.
No KD-trees, no data-dependent shapes — ragged clusters become a padded
(MAX_CLUSTERS,) table of centroids + sizes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from dddmr_navigation_tpu.ops.compaction import first_k_true_indices


def label_components(occ, tol_cells: int = 2, num_iters: int = 24):
    """Label connected components of a 3D occupancy grid.

    Args:
      occ: (X, Y, Z) bool/int occupancy.
      tol_cells: neighborhood radius in cells ≈ cluster tolerance /
        resolution (PCL tolerance 0.1 m at 0.05 m cells → 2).
      num_iters: propagation sweeps; labels converge once num_iters ≥
        max cluster diameter / tol_cells. Fixed for jit-friendliness.
        SIZE THIS to the largest plausible cluster at the deployment grid
        (advisor r2): under-converged clusters split, and a split
        fragment can pass the centroid accept tests its merged whole
        would fail (e.g. a surrounding ring whose true centroid is
        FOV-rejected) — the failure mode is under- vs over-marking.
        tests/test_parity_reference_map.py's trap phase exercises it.

    Returns:
      (X, Y, Z) int32 labels; -1 where unoccupied. Labels are arbitrary
      (min linear cell index of the component).
    """
    occ = occ.astype(bool)
    x, y, z = occ.shape
    lin = (
        jax.lax.broadcasted_iota(jnp.int32, occ.shape, 0) * (y * z)
        + jax.lax.broadcasted_iota(jnp.int32, occ.shape, 1) * z
        + jax.lax.broadcasted_iota(jnp.int32, occ.shape, 2)
    )
    import numpy as np
    big = np.int32(x * y * z + 1)  # concrete: reduce_window init must not trace
    labels = jnp.where(occ, lin, big)

    def _axis_min(a, axis):
        # 1-D window min via shifted elementwise minima. Equivalent to
        # lax.reduce_window(min, SAME, init=big) — SAME pads with the
        # init value, and a shift beyond the edge pads with big here too
        # — but lowers to a handful of fusable slice+min ops instead of
        # a reduce_window invocation, and fuses into the sweep. At fleet
        # scale reduce_window was the single biggest op of the tick
        # before the port to the H100 (not re-measured there).
        out = a
        n = a.shape[axis]
        for d in range(1, tol_cells + 1):
            lo = lax.slice_in_dim(a, d, n, axis=axis)
            hi = lax.slice_in_dim(a, 0, n - d, axis=axis)
            pad_cfg = [(0, 0, 0)] * a.ndim
            pad_cfg[axis] = (0, d, 0)
            out = jnp.minimum(out, lax.pad(lo, big, pad_cfg))
            pad_cfg[axis] = (d, 0, 0)
            out = jnp.minimum(out, lax.pad(hi, big, pad_cfg))
        return out

    def body(carry):
        lbl, _, it = carry
        # Separable: the min over the (win,win,win) cube equals three 1-D
        # window mins run in sequence — 3·win ops/cell instead of win³.
        prop = lbl
        for axis in (0, 1, 2):
            prop = _axis_min(prop, axis)
        new = jnp.where(occ, jnp.minimum(lbl, prop), big)
        return new, jnp.any(new != lbl), it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < num_iters)

    # Early exit at the label fixpoint: typical scans converge in a few
    # sweeps (propagation covers tol_cells per sweep), while num_iters
    # stays the worst-case bound for window-spanning clusters. Labels are
    # identical (a fixpoint is a fixpoint).
    labels, _, _ = lax.while_loop(
        cond, body, (labels, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
    return jnp.where(occ, labels, -1)


def label_components_pooled(occ, pool: int, num_iters: int = 24):
    """Label via a ``pool``×-downsampled grid — the reference's own
    clustering granularity: it voxel-downsamples the scan to a 0.1 m leaf
    BEFORE EuclideanClusterExtraction with a 0.1 m tolerance
    (`multilayer_spinning_lidar.cpp:268,327-336`), so connectivity is
    decided on a 0.1 m lattice. At a 0.05 m marking grid, labeling the
    2×-pooled grid reproduces that granularity at 1/8 the cells and
    ~half the propagation sweeps (the pooled min-label CCL uses
    tol_cells=1 ≡ 0.1 m).

    Returns (labels (X,Y,Z) int32 in POOLED-linear-id space, -1 where
    unoccupied; root_mask (Xp*Yp*Zp,) bool — pooled root cells, whose
    ascending indices are the sorted unique labels).
    """
    occ = occ.astype(bool)
    x, y, z = occ.shape
    p = pool
    xp, yp, zp = -(-x // p), -(-y // p), -(-z // p)
    pad = ((0, xp * p - x), (0, yp * p - y), (0, zp * p - z))
    occ_p = jnp.pad(occ, pad).reshape(xp, p, yp, p, zp, p).any((1, 3, 5))
    lab_p = label_components(occ_p, tol_cells=1, num_iters=num_iters)
    lin_p = jnp.arange(xp * yp * zp, dtype=jnp.int32).reshape(xp, yp, zp)
    root = (occ_p & (lab_p == lin_p)).reshape(-1)
    # upsample pooled labels back onto the fine cells
    up = jnp.repeat(jnp.repeat(jnp.repeat(lab_p, p, 0), p, 1), p, 2)
    up = up[:x, :y, :z]
    return jnp.where(occ, up, -1), root


def cluster_table(labels, occ, cell_pos, max_clusters: int,
                  root_mask=None):
    """Reduce labeled cells to a padded cluster table.

    Args:
      labels: (X,Y,Z) int32 from :func:`label_components` (or the pooled
        variant — then pass its ``root_mask``).
      occ: (X,Y,Z) occupancy.
      cell_pos: (X,Y,Z,3) world position of each cell.
      max_clusters: static table size K.
      root_mask: optional flat bool mask whose ascending True indices are
        the sorted unique labels (pooled labeling); defaults to the
        fine-grid root rule ``label == own linear index``.

    Returns:
      centroids: (K, 3) f32 (garbage rows where invalid)
      sizes: (K,) int32 cell count (0 where invalid)
      cell_cluster_idx: (X,Y,Z) int32 index into the table (-1 unoccupied
        or overflowed cluster).
    """
    flat_labels = labels.reshape(-1)
    flat_occ = occ.reshape(-1).astype(bool)
    flat_pos = cell_pos.reshape(-1, 3)

    # Component roots: cells whose label is their own linear index. Their
    # indices, taken in ascending order, ARE the sorted unique labels —
    # nonzero-compaction replaces jnp.unique's full sort of the window
    # (chosen before the port to the H100; not re-measured). A label chain that failed to
    # converge within num_iters has no root and falls into the overflow
    # bucket below (dropped for a tick, like an overflowed cluster).
    if root_mask is None:
        lin = jnp.arange(flat_labels.shape[0], dtype=flat_labels.dtype)
        root_mask = flat_occ & (flat_labels == lin)
    uniq0 = first_k_true_indices(root_mask, max_clusters)
    valid_cluster = uniq0 >= 0
    uniq = jnp.where(valid_cluster, uniq0, jnp.iinfo(jnp.int32).max)

    # Direct one-hot match instead of searchsorted: the (N, K) compare is
    # three streaming passes over ~46 MB, while searchsorted's binary-
    # search while_loop serializes ~7 gather rounds over the window.
    eq = (flat_labels[:, None] == uniq[None, :]) & flat_occ[:, None]  # (N, K)
    matched = jnp.any(eq, axis=1)
    idx = jnp.argmax(eq, axis=1).astype(jnp.int32)
    idx = jnp.where(matched, idx, max_clusters)  # overflow bucket

    # Segment sum as ONE one-hot matmul instead of a window-sized
    # scatter-add, which serialized before the port to the H100 (not
    # re-measured there). The match matrix IS the one-hot (0/1
    # exact in any dtype); HIGHEST keeps the position products exact f32
    # (centroids feed the 0.05 m ground-attach gate).
    vals = jnp.concatenate([
        jnp.where(matched[:, None], flat_pos, 0.0),
        flat_occ[:, None].astype(jnp.float32)], axis=1)          # (N, 4)
    acc = jax.lax.dot_general(
        eq.astype(jnp.float32), vals, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)                      # (K, 4)
    # overflow/unmatched occupancy is excluded from eq by construction;
    # per-cluster counts come from the same contraction's last column
    sizes = acc[:, 3].astype(jnp.int32) * valid_cluster
    centroids = acc[:, :3] / jnp.maximum(sizes, 1)[:, None]

    cell_cluster_idx = jnp.where(matched, idx, -1).reshape(labels.shape)
    return centroids, sizes, cell_cluster_idx
