"""Pose-graph optimization — the JAX stand-in for lego_loam's GTSAM
iSAM2 back-end (`mapOptimization.cpp:1781-2028`: odometry factors +
loop-closure edges + incremental update, `addEdgeFromPose` `:1162-1177`,
`correctPoses` `:1990`).

iSAM2's incremental Bayes-tree relinearization is inherently sequential;
SURVEY.md §7 specs batch re-optimization per loop closure as the parity
substitute (parity is on output poses, not solver internals). The graph
is a padded (max_keyframes, max_edges) pytree; optimization is dense
batch Gauss-Newton:

  * residual per edge (i→j, measurement Z): se3 log of Z⁻¹·(Tᵢ⁻¹·Tⱼ) —
    6 numbers (rotvec, translation),
  * Jacobians w.r.t. all pose twists via one ``jax.jacfwd`` over the
    stacked (K, 6) tangent — the factor graph is small (≤256 keyframes),
    so the dense (6K × 6K) normal system is one small solve; gauge freedom fixed by anchoring pose 0.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from dddmr_navigation_tpu.geometry import (
    quat_rotate, quat_multiply, quat_conjugate, quat_normalize, quat_exp)


class PoseGraphArrays(NamedTuple):
    """Padded pose graph (device pytree)."""
    pos: jnp.ndarray        # (K, 3)
    quat: jnp.ndarray       # (K, 4)
    node_mask: jnp.ndarray  # (K,) bool
    edge_i: jnp.ndarray     # (E,) i32 from-node
    edge_j: jnp.ndarray     # (E,) i32 to-node
    edge_pos: jnp.ndarray   # (E, 3) measured Tᵢ⁻¹·Tⱼ translation
    edge_quat: jnp.ndarray  # (E, 4) measured rotation
    edge_weight: jnp.ndarray  # (E,) f32 information scale (0 = padding)


def empty_graph(max_keyframes: int, max_edges: int) -> PoseGraphArrays:
    idq = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    return PoseGraphArrays(
        pos=jnp.zeros((max_keyframes, 3), jnp.float32),
        quat=jnp.broadcast_to(idq, (max_keyframes, 4)),
        node_mask=jnp.zeros((max_keyframes,), bool),
        edge_i=jnp.zeros((max_edges,), jnp.int32),
        edge_j=jnp.zeros((max_edges,), jnp.int32),
        edge_pos=jnp.zeros((max_edges, 3), jnp.float32),
        edge_quat=jnp.broadcast_to(idq, (max_edges, 4)),
        edge_weight=jnp.zeros((max_edges,), jnp.float32))


def _quat_log(q):
    """quat → rotvec (3,), batched. atan2-based so the derivative is
    well-defined at identity (jacfwd evaluates at ξ=0)."""
    qn = quat_normalize(q)
    sign = jnp.where(qn[..., 3] < 0, -1.0, 1.0)
    vn = jnp.sqrt(jnp.sum(qn[..., :3] ** 2, axis=-1) + 1e-16)
    ang = 2.0 * jnp.arctan2(vn, jnp.abs(qn[..., 3]))
    return sign[..., None] * qn[..., :3] * (ang / vn)[..., None]


def _retract(pos, quat, xi):
    """Right-perturbation retraction per node: T·exp(ξ)."""
    w, dt = xi[..., :3], xi[..., 3:]
    dq = quat_exp(w)
    new_quat = quat_normalize(quat_multiply(quat, dq))
    new_pos = pos + quat_rotate(quat, dt)
    return new_pos, new_quat


def _edge_residuals(g: PoseGraphArrays, xi):
    """(E, 6) residuals of all edges at tangent offset ξ (K, 6)."""
    pos, quat = _retract(g.pos, g.quat, xi)
    pi, qi = pos[g.edge_i], quat[g.edge_i]
    pj, qj = pos[g.edge_j], quat[g.edge_j]
    # rel = Tᵢ⁻¹ Tⱼ
    qi_inv = quat_conjugate(qi)
    rel_q = quat_multiply(qi_inv, qj)
    rel_p = quat_rotate(qi_inv, pj - pi)
    # err = Z⁻¹ rel
    zq_inv = quat_conjugate(g.edge_quat)
    err_q = quat_multiply(zq_inv, rel_q)
    err_p = quat_rotate(zq_inv, rel_p - g.edge_pos)
    return jnp.concatenate([_quat_log(err_q), err_p], axis=-1)


@partial(jax.jit, static_argnums=(1,))
def optimize_pose_graph(g: PoseGraphArrays, iters: int = 8
                        ) -> PoseGraphArrays:
    """Batch Gauss-Newton over all poses; pose 0 anchored."""
    k = g.pos.shape[0]

    def gn(_, g):
        def r(xi):
            res = _edge_residuals(g, xi)
            return (res * g.edge_weight[:, None]).reshape(-1)

        xi0 = jnp.zeros((k, 6), jnp.float32)
        J = jax.jacfwd(lambda x: r(x.reshape(k, 6)))(xi0.reshape(-1))
        rv = r(xi0)
        # anchor node 0 + freeze padded nodes by zeroing their columns
        free = (g.node_mask & (jnp.arange(k) > 0)).astype(jnp.float32)
        colmask = jnp.repeat(free, 6)
        J = J * colmask[None, :]
        # HIGHEST: f32 products may otherwise run in TF32 on the GPU
        JtJ = (jnp.matmul(J.T, J, precision=lax.Precision.HIGHEST)
               + 1e-5 * jnp.eye(6 * k))
        step = -jnp.linalg.solve(
            JtJ, jnp.matmul(J.T, rv, precision=lax.Precision.HIGHEST)
        ) * colmask
        pos, quat = _retract(g.pos, g.quat, step.reshape(k, 6))
        return g._replace(pos=pos, quat=quat)

    return lax.fori_loop(0, iters, gn, g)


def add_node(g: PoseGraphArrays, idx, pos, quat) -> PoseGraphArrays:
    return g._replace(
        pos=g.pos.at[idx].set(pos),
        quat=g.quat.at[idx].set(quat),
        node_mask=g.node_mask.at[idx].set(True))


def add_edge(g: PoseGraphArrays, eidx, i, j, rel_pos, rel_quat,
             weight=1.0) -> PoseGraphArrays:
    """`addEdgeFromPose` — the reference scales noise by the ICP score;
    pass weight = 1/score for the same effect."""
    return g._replace(
        edge_i=g.edge_i.at[eidx].set(i),
        edge_j=g.edge_j.at[eidx].set(j),
        edge_pos=g.edge_pos.at[eidx].set(rel_pos),
        edge_quat=g.edge_quat.at[eidx].set(rel_quat),
        edge_weight=g.edge_weight.at[eidx].set(weight))


def detect_loop_candidate(g: PoseGraphArrays, cur_idx, search_radius: float,
                          min_index_gap: int = 20):
    """`detectLoopClosure` (`mapOptimization.cpp:886-960`): nearest
    historic keyframe within ``search_radius`` of the current one, at
    least ``min_index_gap`` keyframes old (the reference gates on ≥20 m
    accumulated path; index gap is the static-shape equivalent at ~1 m
    keyframe spacing). Returns (idx, found)."""
    cur = g.pos[cur_idx]
    d = jnp.linalg.norm(g.pos - cur[None, :], axis=-1)
    k = g.pos.shape[0]
    old = (jnp.arange(k) < cur_idx - min_index_gap) & g.node_mask
    d = jnp.where(old, d, jnp.inf)
    i = jnp.argmin(d)
    return i, d[i] <= search_radius
