"""Gauss-Newton lidar odometry — JAX re-design of lego_loam's
scan-to-scan (`featureAssociation.cpp:1254-1460`) and scan-to-map
(`mapOptimization.cpp:1407-1780`) optimizers, plus the loop-closure ICP
(`opt_icp_gn/optimized_ICP_GN.cpp:1-137`).

The reference finds correspondences with per-point KD-tree queries and
hand-rolls the Jacobians for its camera-frame 6-param transform. Here:

  * correspondences are batched brute-force nearest neighbors — an
    (Ns, Nt) squared-distance matrix whose cross term is one matmul
    (source/target feature sets are a few hundred points, so a dense
    matrix needs no tree),
  * residuals are the classic LOAM point-to-line (sharp → 2-NN line in
    target less-sharp) and point-to-plane (flat → 3-NN plane in target
    less-flat) distances,
  * the 6-dof update is Gauss-Newton on a left-multiplied twist
    (rotvec, translation), Jacobians via ``jax.jacfwd`` at ξ=0 — XLA
    fuses the whole iteration into one program; iterations are a
    ``fori_loop`` with re-matching inside (matching IS the heavy op and
    re-runs each iteration, as the reference's `iterCount` loop does).

Pose convention: ``(pos (3,), quat (4,))`` maps source-frame points into
the target frame: ``x_t = R x_s + t``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from dddmr_navigation_tpu.config import SlamConfig
from dddmr_navigation_tpu.geometry import (
    quat_rotate, quat_multiply, quat_normalize, quat_exp)


def _sq_dists(a, b):
    """(Na, Nb) pairwise squared distances; cross term as a matmul.
    Recentred on the target mean and run at HIGHEST matmul precision: a
    reduced-precision f32 matmul (TF32 on the GPU) plus |a−b|² by
    expansion cancels catastrophically at map-scale coordinates (the
    error budget here is millimeters against 0.3 m match gates)."""
    c = jnp.mean(b, axis=0)
    a = a - c
    b = b - c
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    cross = jnp.dot(a, b.T, preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)
    return jnp.maximum(a2[:, None] + b2[None, :] - 2.0 * cross, 0.0)


def _knn(src, tgt, tgt_mask, k: int):
    """k nearest targets per source point → (idx (Ns,k), d2 (Ns,k))."""
    d2 = _sq_dists(src, tgt)
    d2 = jnp.where(tgt_mask[None, :], d2, jnp.inf)
    neg_d, idx = lax.top_k(-d2, k)
    return idx, -neg_d


def _apply(pos, quat, pts):
    return quat_rotate(quat[None, :], pts) + pos[None, :]


def _safe_norm(v, eps=1e-12):
    """norm with a well-defined derivative at 0 (jacfwd runs at ξ=0)."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1) + eps)


def _twist_apply(xi, pos, quat, pts):
    """Left-multiplied twist update: exp(ξ)·T applied to points.
    ξ = (rotvec(3), dt(3)). Small-angle exact via axis-angle quat."""
    w, dt = xi[:3], xi[3:]
    dq = quat_exp(w)
    base = _apply(pos, quat, pts)
    return quat_rotate(dq[None, :], base) + dt[None, :]


def _line_residuals(xi, pos, quat, src, la, lb):
    """Point-to-line distance of transformed src to line (la, lb)."""
    p = _twist_apply(xi, pos, quat, src)
    d = lb - la
    dn = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
    v = p - la
    perp = v - jnp.sum(v * dn, axis=-1, keepdims=True) * dn
    return _safe_norm(perp)


def _plane_residuals(xi, pos, quat, src, pa, pb, pc):
    """Signed point-to-plane distance of transformed src to (pa,pb,pc)."""
    p = _twist_apply(xi, pos, quat, src)
    n = jnp.cross(pb - pa, pc - pa)
    n = n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-9)
    return jnp.sum((p - pa) * n, axis=-1)


def _gn_step(pos, quat, residual_fn, weights, damping=1e-4,
             lm_lambda=0.05, max_rot=0.2, max_trans=0.3,
             degen_thresh=None):
    """One damped Gauss-Newton step on the 6-twist. residual_fn: ξ → (R,).

    Robustness against imperfect correspondences (LOAM's features are
    occlusion-boundary picks, not exact geometric edges): Marquardt
    diagonal scaling shrinks weakly-observed directions, and the step is
    trust-region-clipped per iteration — re-matching next iteration
    corrects course, exactly like the reference's `iterCount` loop with
    its small per-iteration updates (`featureAssociation.cpp:1254-1460`).

    ``degen_thresh``: the reference's scan-to-map degeneracy guard
    (`mapOptimization.cpp` LMOptimization isDegenerate): update components
    along JtJ eigendirections with eigenvalue below the threshold are
    projected out instead of solved through.
    """
    xi0 = jnp.zeros((6,), jnp.float32)
    r = residual_fn(xi0)
    J = jax.jacfwd(residual_fn)(xi0)          # (R, 6)
    w = weights
    # HIGHEST on every f32 product here: the GPU may otherwise run them in
    # TF32, and the normal equations square the Jacobian's error
    JtJ = jnp.matmul((J * w[:, None]).T, J, precision=lax.Precision.HIGHEST)
    Jtr = jnp.matmul((J * w[:, None]).T, r, precision=lax.Precision.HIGHEST)
    JtJ_d = JtJ + lm_lambda * jnp.diag(jnp.diag(JtJ)) + damping * jnp.eye(6)
    xi = -jnp.linalg.solve(JtJ_d, Jtr)
    if degen_thresh is not None:
        evals, evecs = jnp.linalg.eigh(JtJ)
        keep = (evals > degen_thresh).astype(jnp.float32)
        xi = jnp.matmul(evecs, keep * jnp.matmul(
            evecs.T, xi, precision=lax.Precision.HIGHEST),
            precision=lax.Precision.HIGHEST)
    rot_n = jnp.linalg.norm(xi[:3])
    trans_n = jnp.linalg.norm(xi[3:])
    scale = jnp.minimum(1.0, jnp.minimum(
        max_rot / jnp.maximum(rot_n, 1e-9),
        max_trans / jnp.maximum(trans_n, 1e-9)))
    xi = xi * scale
    wv, dt = xi[:3], xi[3:]
    dq = quat_exp(wv)
    new_quat = quat_normalize(quat_multiply(dq, quat))
    new_pos = quat_rotate(dq, pos) + dt
    return new_pos, new_quat


def _first_true(ok):
    """(N, K) bool → (first-true column index, any) per row."""
    return jnp.argmax(ok, axis=1), jnp.any(ok, axis=1)


def _take(idx, j):
    return jnp.take_along_axis(idx, j[:, None], axis=1)[:, 0]


def match_scans(cfg: SlamConfig, src_sharp, src_sharp_mask, src_flat,
                src_flat_mask, tgt_less_sharp, tgt_less_sharp_mask,
                tgt_less_flat, tgt_less_flat_mask,
                init_pos=None, init_quat=None, iters: int | None = None,
                tgt_less_sharp_ring=None, tgt_less_flat_ring=None):
    """LOAM odometry: align source features to target features.

    With target ring indices (FeatureSet.less_sharp_ring/.less_flat_ring),
    correspondences follow the reference's ring constraints
    (`featureAssociation.cpp:633-676,751-806`): a corner line pairs the
    nearest point with the nearest point on a DIFFERENT ring within ±2
    (same-ring pairs are occlusion-boundary points of the same azimuth
    step, whose skew lines wreck the Gauss-Newton geometry); a surf plane
    spans the nearest point, a same-ring neighbor and a different-ring
    neighbor. Without rings falls back to plain 2-/3-NN.

    Returns (pos, quat, mean_residual): the transform taking source-frame
    points into the target frame.
    """
    if init_pos is None:
        init_pos = jnp.zeros((3,), jnp.float32)
    if init_quat is None:
        init_quat = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    iters = iters or cfg.scan_match_iters
    max_d2 = cfg.nearest_feature_search_distance ** 2
    k_nn = 8

    def body(_, carry):
        pos, quat, _ = carry
        # --- corners → lines -------------------------------------------
        ps = _apply(pos, quat, src_sharp)
        if tgt_less_sharp_ring is None:
            idx_c, d2_c = _knn(ps, tgt_less_sharp, tgt_less_sharp_mask, 2)
            la = tgt_less_sharp[idx_c[:, 0]]
            lb = tgt_less_sharp[idx_c[:, 1]]
            w_c = (src_sharp_mask & (d2_c[:, 0] < max_d2)
                   & (d2_c[:, 1] < max_d2)).astype(jnp.float32)
        else:
            idx_c, d2_c = _knn(ps, tgt_less_sharp, tgt_less_sharp_mask,
                               k_nn)
            rings = tgt_less_sharp_ring[idx_c]            # (N, k)
            r0 = rings[:, :1]
            cand = ((rings != r0) & (jnp.abs(rings - r0) <= 2)
                    & (d2_c < max_d2))
            cand = cand.at[:, 0].set(False)
            j2, has2 = _first_true(cand)
            la = tgt_less_sharp[idx_c[:, 0]]
            lb = tgt_less_sharp[_take(idx_c, j2)]
            w_c = (src_sharp_mask & (d2_c[:, 0] < max_d2) & has2
                   ).astype(jnp.float32)
        # --- flats → planes ---------------------------------------------
        pf = _apply(pos, quat, src_flat)
        if tgt_less_flat_ring is None:
            idx_s, d2_s = _knn(pf, tgt_less_flat, tgt_less_flat_mask, 3)
            pa = tgt_less_flat[idx_s[:, 0]]
            pb = tgt_less_flat[idx_s[:, 1]]
            pc = tgt_less_flat[idx_s[:, 2]]
            w_extra = jnp.ones(pf.shape[0], bool)
        else:
            idx_s, d2_s = _knn(pf, tgt_less_flat, tgt_less_flat_mask, k_nn)
            rings = tgt_less_flat_ring[idx_s]
            r0 = rings[:, :1]
            gate = d2_s < max_d2
            same = (rings == r0) & gate
            same = same.at[:, 0].set(False)
            diff = (rings != r0) & (jnp.abs(rings - r0) <= 2) & gate
            jb, has_b = _first_true(same)
            jc, has_c = _first_true(diff)
            pa = tgt_less_flat[idx_s[:, 0]]
            pb = tgt_less_flat[_take(idx_s, jb)]
            pc = tgt_less_flat[_take(idx_s, jc)]
            w_extra = has_b & has_c
        degenerate = jnp.linalg.norm(
            jnp.cross(pb - pa, pc - pa), axis=-1) < 1e-6
        w_s = (src_flat_mask & (d2_s[:, 0] < max_d2) & ~degenerate
               & w_extra).astype(jnp.float32)

        def res(xi):
            rc = _line_residuals(xi, pos, quat, src_sharp, la, lb)
            rs = _plane_residuals(xi, pos, quat, src_flat, pa, pb, pc)
            return jnp.concatenate([rc, rs])

        w = jnp.concatenate([w_c, w_s])
        # bisquare-style down-weighting of large residuals
        r0 = res(jnp.zeros((6,), jnp.float32))
        w = w * jnp.maximum(1.0 - 0.9 * jnp.abs(r0), 0.1)
        pos, quat = _gn_step(pos, quat, res, w)
        mean_r = jnp.sum(jnp.abs(r0) * w) / jnp.maximum(jnp.sum(w), 1.0)
        return pos, quat, mean_r

    pos, quat, mean_r = lax.fori_loop(
        0, iters, body, (init_pos, init_quat, jnp.float32(0.0)))
    return pos, quat, mean_r


@partial(jax.jit, static_argnums=(4, 5))
def icp_point2point(src, src_mask, tgt, tgt_mask, iters: int = 30,
                    max_corr_dist: float = 1.0, init_pos=None,
                    init_quat=None):
    """`OptimizedICPGN` (`optimized_ICP_GN.cpp`): Gauss-Newton
    point-to-point ICP with a max-correspondence bound.

    Returns (pos, quat, fitness): fitness = mean squared distance of
    matched points (the reference's score gate
    `history_keyframe_fitness_score` consumes this).
    """
    if init_pos is None:
        init_pos = jnp.zeros((3,), jnp.float32)
    if init_quat is None:
        init_quat = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)

    def body(_, carry):
        pos, quat, _ = carry
        p = _apply(pos, quat, src)
        idx, d2 = _knn(p, tgt, tgt_mask, 1)
        q = tgt[idx[:, 0]]
        w = (src_mask & (d2[:, 0] < max_corr_dist ** 2)).astype(jnp.float32)

        def res(xi):
            pp = _twist_apply(xi, pos, quat, src)
            return (pp - q).reshape(-1)

        w3 = jnp.repeat(w, 3)
        pos, quat = _gn_step(pos, quat, res, w3)
        fitness = jnp.sum(d2[:, 0] * w) / jnp.maximum(jnp.sum(w), 1.0)
        return pos, quat, fitness

    pos, quat, fitness = lax.fori_loop(
        0, iters, body, (init_pos, init_quat, jnp.float32(jnp.inf)))
    return pos, quat, fitness


def match_to_map(cfg: SlamConfig, src_sharp, src_sharp_mask, src_flat,
                 src_flat_mask, map_sharp, map_sharp_mask, map_flat,
                 map_flat_mask, init_pos=None, init_quat=None,
                 iters: int | None = None):
    """Scan-to-map matching with the reference's 5-NN geometric fits
    (`mapOptimization.cpp:1407-1660`): corners fit a LINE through the
    5-NN mean via the principal covariance eigenvector, valid when
    λ₁ > 3·λ₂ AND the 5th neighbor is within 1 m; surfs fit a PLANE by
    least squares (A·n = −1), valid when all 5 points lie within 0.2 m of
    it. This is what makes matching against an unstructured accumulated
    submap stable — plain k-NN correspondences on a voxel-downsampled
    cloud produce degenerate lines/planes (no ring structure to lean on).

    Returns (pos, quat, mean_residual).
    """
    if init_pos is None:
        init_pos = jnp.zeros((3,), jnp.float32)
    if init_quat is None:
        init_quat = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    iters = iters or cfg.map_match_iters

    def body(_, carry):
        pos, quat, _ = carry
        # --- corners → eigen lines (`:1407-1500`) ----------------------
        ps = _apply(pos, quat, src_sharp)
        idx_c, d2_c = _knn(ps, map_sharp, map_sharp_mask, 5)
        nn_c = map_sharp[idx_c]                       # (N, 5, 3)
        mean_c = jnp.mean(nn_c, axis=1, keepdims=True)
        cen = nn_c - mean_c
        # HIGHEST: f32 products may otherwise run in TF32 on the GPU
        cov = jnp.einsum("nki,nkj->nij", cen, cen,
                         precision=lax.Precision.HIGHEST) / 5.0
        evals, evecs = jnp.linalg.eigh(cov)           # ascending
        principal = evecs[:, :, 2]
        line_ok = evals[:, 2] > 3.0 * evals[:, 1]
        la = mean_c[:, 0, :] + 0.1 * principal
        lb = mean_c[:, 0, :] - 0.1 * principal
        w_c = (src_sharp_mask & line_ok & (d2_c[:, 4] < 1.0)
               ).astype(jnp.float32)

        # --- surfs → lstsq planes (`:1519-1660`) ------------------------
        pf = _apply(pos, quat, src_flat)
        idx_s, d2_s = _knn(pf, map_flat, map_flat_mask, 5)
        nn_s = map_flat[idx_s]                        # (N, 5, 3)
        # solve A n = -1  (plane n·x + 1 = 0)
        AtA = jnp.einsum("nki,nkj->nij", nn_s, nn_s,
                         precision=lax.Precision.HIGHEST)
        Atb = -jnp.sum(nn_s, axis=1)
        n_vec = jnp.linalg.solve(
            AtA + 1e-6 * jnp.eye(3)[None], Atb[:, :, None])[:, :, 0]
        n_norm = jnp.linalg.norm(n_vec, axis=-1, keepdims=True)
        unit_n = n_vec / jnp.maximum(n_norm, 1e-9)
        d_plane = 1.0 / jnp.maximum(n_norm[:, 0], 1e-9)
        # all 5 supports within 0.2 m of the fitted plane
        support_d = jnp.abs(jnp.einsum("nki,ni->nk", nn_s, unit_n,
                                       precision=lax.Precision.HIGHEST)
                            + d_plane[:, None])
        plane_ok = jnp.all(support_d < 0.2, axis=1)
        w_s = (src_flat_mask & plane_ok & (d2_s[:, 4] < 1.0)
               ).astype(jnp.float32)

        def res(xi):
            p = _twist_apply(xi, pos, quat, src_sharp)
            d = lb - la
            dn = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
            v = p - la
            perp = v - jnp.sum(v * dn, axis=-1, keepdims=True) * dn
            rc = _safe_norm(perp)
            pfp = _twist_apply(xi, pos, quat, src_flat)
            rs = jnp.einsum("ni,ni->n", pfp, unit_n,
                            precision=lax.Precision.HIGHEST) + d_plane
            return jnp.concatenate([rc, rs])

        w = jnp.concatenate([w_c, w_s])
        r0 = res(jnp.zeros((6,), jnp.float32))
        # reference robust gate: s = 1 − 0.9·|r|, drop when s ≤ 0.1
        # (`mapOptimization.cpp:1480-1497,1643-1660`)
        s = 1.0 - 0.9 * jnp.abs(r0)
        w = w * jnp.where(s > 0.1, s, 0.0)
        pos, quat = _gn_step(pos, quat, res, w, degen_thresh=100.0)
        mean_r = jnp.sum(jnp.abs(r0) * w) / jnp.maximum(jnp.sum(w), 1.0)
        return pos, quat, mean_r

    pos, quat, mean_r = lax.fori_loop(
        0, iters, body, (init_pos, init_quat, jnp.float32(0.0)))
    return pos, quat, mean_r
