"""Per-scan feature-weight preprocessing for MCL — the JAX re-design of
``MCL3dlNode::cbLeGoFeatureCloud``'s reweighting stage
(`src/mcl_3dl.cpp:300-443`).

The reference, per LeGO-LOAM feature scan:
  * voxel-downsamples the flat (ground) features at 1×1×0.1 m;
  * estimates kNN(5) normals on the less-sharp cloud;
  * when the environment is **normal-dominant** (Σ|nx|/Σ|ny| ≥ 1.6 or the
    reverse — long parallel walls), features whose normal ratio crosses 0.5
    get weight ``0.05·Σ|n_other|/Σ|n_dom|`` to fight virtual slipping along
    the walls, all others 1.0;
  * otherwise it Euclidean-clusters the cloud (tolerance
    ``euc_cluster_distance``, min size ``euc_cluster_min_size``) and weights
    every point by ``cluster_size/total`` (halved for beam-like clusters of
    exactly the minimum size; smaller clusters are dropped).

Here everything is static-shape JAX: normals by masked kNN PCA, clustering
by ε-graph label propagation, the dominant/cluster branch fused with
``jnp.where`` (both paths cost microseconds at these sizes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.config import MCLConfig

_BIG = 1.0e12


def voxel_downsample_flat(pts, mask, leaf=(1.0, 1.0, 0.1)):
    """Keep the first valid point per voxel cell (PCL VoxelGrid chooses the
    centroid; first-point keeps static shapes and is within half a leaf —
    the flat features feed a 0.3 m match gate so this is inside tolerance).

    Returns (pts, new_mask)."""
    leaf = jnp.asarray(leaf, jnp.float32)
    p = pts.shape[0]
    cells = jnp.floor(pts / leaf).astype(jnp.int32)
    # invalid rows get unique sentinel cells so they never merge a voxel
    # (int32-safe: no hash, lexicographic sort on the cell triple)
    sentinel = (1 << 20) + jnp.arange(p, dtype=jnp.int32)
    cx = jnp.where(mask, cells[:, 0], sentinel)
    cy = jnp.where(mask, cells[:, 1], 0)
    cz = jnp.where(mask, cells[:, 2], 0)
    order = jnp.lexsort((cz, cy, cx))
    sx, sy, sz = cx[order], cy[order], cz[order]
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1]) | (sz[1:] != sz[:-1])])
    keep = jnp.zeros_like(mask).at[order].set(first)
    return pts, keep & mask


def knn_normals(pts, mask, k: int = 5):
    """Masked kNN PCA normals (the reference's pcl::NormalEstimation with
    setKSearch(5)). Returns (P, 3) unit normals (undefined rows where the
    mask is false).

    Normals are oriented toward the sensor origin (PCL's default
    ``flipNormalTowardsViewpoint`` with viewpoint (0,0,0)), which makes the
    *signed* normal components deterministic — the reference's dominance
    reweighting uses the signed ratio normal_y/normal_x
    (`mcl_3dl.cpp:377-398`), so orientation must match PCL's."""
    p = pts.shape[0]
    d = pts[:, None, :] - pts[None, :, :]
    d2 = jnp.sum(d * d, axis=-1)
    d2 = jnp.where(mask[None, :] & mask[:, None], d2, _BIG)
    k = min(k, p)
    _, idx = jax.lax.top_k(-d2, k)                   # (P, k) nearest
    nbrs = pts[idx]                                  # (P, k, 3)
    c = nbrs - jnp.mean(nbrs, axis=1, keepdims=True)
    # HIGHEST: f32 products may otherwise run in TF32 on the GPU
    cov = jnp.einsum("pki,pkj->pij", c, c,
                     precision=jax.lax.Precision.HIGHEST)
    # smallest-eigenvector via eigh (P tiny: ≤ a few hundred)
    _, vecs = jnp.linalg.eigh(cov)
    n = vecs[:, :, 0]
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    # flipNormalTowardsViewpoint(p, 0,0,0, n): flip when dot(vp - p, n) < 0.
    flip = jnp.sum(-pts * n, axis=-1) < 0.0
    return jnp.where(flip[:, None], -n, n)


def label_clusters(pts, mask, tol: float, iters: int = 16):
    """ε-graph connected components by min-label propagation with
    pointer doubling: each iteration takes the neighbor minimum, then
    jumps ``lbl = lbl[lbl]``, so an ε-chain of length L converges in
    O(log L) iterations rather than O(L) — 16 iterations cover chains
    far beyond any max_feature_points padding.
    Returns int32 labels (P,), invalid points labeled P."""
    p = pts.shape[0]
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    adj = (d2 <= tol * tol) & mask[None, :] & mask[:, None]
    labels = jnp.where(mask, jnp.arange(p, dtype=jnp.int32), p)

    def body(_, lbl):
        # neighbor minimum (adjacency includes self)
        nb = jnp.where(adj, lbl[None, :], p)
        lbl = jnp.minimum(lbl, jnp.min(nb, axis=1))
        # pointer doubling (guard the invalid sentinel p from the gather)
        jumped = lbl[jnp.minimum(lbl, p - 1)]
        return jnp.where(lbl < p, jnp.minimum(lbl, jumped), lbl)

    return jax.lax.fori_loop(0, iters, body, labels)


def sharp_feature_weights(cfg: MCLConfig, pts, mask):
    """Weights for the less-sharp features (`mcl_3dl.cpp:339-443`).

    Returns (weights (P,) f32, keep_mask (P,) bool)."""
    p = pts.shape[0]
    normals = knn_normals(pts, mask, k=5)
    nx_s = normals[:, 0]
    ny_s = normals[:, 1]
    sum_x = jnp.sum(jnp.where(mask, jnp.abs(nx_s), 0.0))
    sum_y = jnp.sum(jnp.where(mask, jnp.abs(ny_s), 0.0))
    eps = 1e-9
    x_dom = sum_x / jnp.maximum(sum_y, eps) >= 1.6
    y_dom = sum_y / jnp.maximum(sum_x, eps) >= 1.6

    # --- dominant branch: down-weight wall-parallel features -------------
    # SIGNED ratios, like the reference (`mcl_3dl.cpp:377-398` divides the
    # raw normal components); determinism comes from the viewpoint-oriented
    # normals in knn_normals. A tiny-|nx| denominator yields ±big, matching
    # the reference's IEEE ±inf comparisons against 0.5.
    safe = lambda d: jnp.where(jnp.abs(d) < eps, jnp.where(d < 0, -eps, eps), d)
    y2x = ny_s / safe(nx_s)
    x2y = nx_s / safe(ny_s)
    w_xdom = jnp.where(y2x >= 0.5, 0.05 * sum_y / jnp.maximum(sum_x, eps), 1.0)
    w_ydom = jnp.where(x2y >= 0.5, 0.05 * sum_x / jnp.maximum(sum_y, eps), 1.0)
    w_dom = jnp.where(x_dom, w_xdom, w_ydom)

    # --- cluster branch: per-cluster normalized weight --------------------
    labels = label_clusters(pts, mask, cfg.euc_cluster_distance)
    sizes = jnp.sum(labels[:, None] == jnp.arange(p)[None, :], axis=0)
    csize = sizes[jnp.clip(labels, 0, p - 1)].astype(jnp.float32)
    total = jnp.maximum(jnp.sum(mask), 1).astype(jnp.float32)
    w_clu = csize / total
    small = csize < (cfg.euc_cluster_min_size + 1)
    w_clu = jnp.where(small, w_clu * 0.5, w_clu)
    keep_clu = csize >= cfg.euc_cluster_min_size      # EC min-size filter

    dominant = x_dom | y_dom
    w = jnp.where(dominant, w_dom, w_clu)
    keep = mask & jnp.where(dominant, True, keep_clu)
    return jnp.where(keep, w, 1.0), keep


def preprocess_features(cfg: MCLConfig, flat_pts, flat_mask,
                        sharp_pts, sharp_mask):
    """Full per-scan preprocessing: flat voxel filter + sharp weights.

    Returns (flat_pts, flat_mask, sharp_pts, sharp_mask, sharp_weight)."""
    flat_pts, flat_mask = voxel_downsample_flat(flat_pts, flat_mask)
    w, keep = sharp_feature_weights(cfg, sharp_pts, sharp_mask)
    return flat_pts, flat_mask, sharp_pts, keep, w
