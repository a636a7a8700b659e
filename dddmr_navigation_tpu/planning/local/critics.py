"""Fused MPC critics: the reference's per-trajectory scoring plugins
(`mpc_critics/models/*.cpp`) as batched closed-form kernels over all
rollouts at once. KD-trees are replaced by masked pairwise reductions.

Stacking semantics (`stacked_scoring_model.cpp:75-97`): critics run in
order; a negative score rejects the trajectory (short-circuit); otherwise
scores accumulate. Batched: ``rejected = any(critic < 0)``,
``cost = Σ max(critic, 0-contributions)``; the first negative value is
reported for diagnostics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.config import CriticsConfig, CuboidConfig
from dddmr_navigation_tpu.geometry import (
    quat_rotate, quat_conjugate, quat_multiply, yaw_from_quat)
from dddmr_navigation_tpu.planning.local.rollout import (
    Rollouts, end_indices, end_positions, end_quats)


class PrunePlan(NamedTuple):
    """Padded prune plan (see planner.prune_plan)."""
    positions: jnp.ndarray   # (P, 3)
    quats: jnp.ndarray       # (P, 4)
    intensity: jnp.ndarray   # (P,) -1 backward / +1 forward / 0 first pose
    valid: jnp.ndarray       # (P,) bool
    count: jnp.ndarray       # () int32


def _masked_sq_dists(a, a_mask, b, b_mask, big=1e12):
    """(n,m) squared distances with invalid pairs set to ``big``.

    Direct-difference form: the |a|²+|b|²-2ab matmul trick is numerically
    catastrophic here — plan/trajectory distances are near zero at global
    coordinates of O(10 m), and the cancellation error (amplified
    differently by different compiler FMA/reassociation choices) reaches
    percent-level on the NN distances the critics sum. Callers keep one of
    the two sets small so the (n,m,3) intermediate stays bounded."""
    d = a[:, None, :] - b[None, :, :]
    d = jnp.sum(d * d, axis=-1)
    ok = a_mask[:, None] & b_mask[None, :]
    return jnp.where(ok, d, big)


def collision_scores(r: Rollouts, cuboid: CuboidConfig, obstacles, obs_valid,
                     obstacle_chunk: int = 256, near_k: int = 0):
    """`CollisionModel::scoreTrajectory` (`collision_model.cpp:51-148`):
    -1 when any observed point falls inside the oriented footprint cuboid
    at any valid rollout step; 0 otherwise; 0 when fewer than 5 points.

    The oriented-box test uses the cuboid axes dx=c[3]-c[0], dy=c[1]-c[0],
    dz=c[2]-c[0] and center = mean(corners) exactly as the reference.
    The reference pre-gates with a 1 m radius search — redundant when the
    cuboid half-diagonal is under 1 m, so we run the box test directly.
    """
    enough = jnp.sum(obs_valid) >= 5

    if near_k and near_k < obstacles.shape[0]:
        # Keep only the nearest K obstacles to the robot: the rollout sweep
        # reaches at most max_vel*sim_time + footprint circumradius, so
        # distant points cannot enter the box test. Ranking by distance
        # keeps this exact whenever ≤ K points are within reach.
        d2r = jnp.sum((obstacles - r.robot_pos) ** 2, axis=-1)
        d2r = jnp.where(obs_valid, d2r, jnp.inf)
        _, sel = jax.lax.top_k(-d2r, near_k)
        obstacles = obstacles[sel]
        obs_valid = obs_valid[sel]

    corners = jnp.asarray(cuboid.corners(), jnp.float32)       # (8,3) base frame
    center_l = jnp.mean(corners, axis=0)
    dx = corners[3] - corners[0]
    dy = corners[1] - corners[0]
    dz = corners[2] - corners[0]
    half = jnp.asarray([jnp.linalg.norm(dx), jnp.linalg.norm(dy),
                        jnp.linalg.norm(dz)]) * 0.5             # (3,)
    axes_l = jnp.stack([dx, dy, dz], axis=0) / (2.0 * half[:, None])  # (3,3)

    # Global-frame axes/center per (S, N): rotate by robot_quat ∘ Rz(theta).
    cth, sth = jnp.cos(r.theta), jnp.sin(r.theta)               # (S,N)

    def rot_z(v):  # rotate base-frame vector v by theta, batched over (S,N)
        return jnp.stack([
            cth * v[0] - sth * v[1],
            sth * v[0] + cth * v[1],
            jnp.broadcast_to(v[2], cth.shape)], axis=-1)        # (S,N,3)

    axes_g = jnp.stack([
        quat_rotate(r.robot_quat, rot_z(axes_l[i])) for i in range(3)
    ], axis=-2)                                                  # (S,N,3,3)
    # Work in robot-centered coordinates: at global coords of O(10-100 m)
    # the proj_p - proj_c cancellation loses the ~0.4 m box half-extents.
    center_g = (r.positions - r.robot_pos) + quat_rotate(r.robot_quat, rot_z(center_l))

    # d = p - center; inside iff |d . axis_k| <= half_k for all k.
    # Elementwise multiply-reduce (not einsum): a 3-wide contraction is
    # too small for a matrix unit, and the elementwise form fuses into
    # the consumers instead of forcing axes_g to materialize for a dot op.
    proj_c = jnp.sum(axes_g * center_g[:, :, None, :], axis=-1)  # (S,N,3)

    k_total = obstacles.shape[0]
    obs_c = obstacles - r.robot_pos

    def axis_inside(pts, mask, step_valid_col):
        """(S,N,C) point-in-box test for one obstacle set, fused
        per-axis elementwise projections (f32 mul-adds, fused by XLA into
        the compare+reduce). Exact f32 by construction, so a reduced-
        precision matmul cannot move a point across the box boundary.
        Chosen over an einsum before the port to the H100; not
        re-measured there."""
        px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
        inside = None
        for a in range(3):
            proj = (axes_g[:, :, a, 0][..., None] * px[None, None, :]
                    + axes_g[:, :, a, 1][..., None] * py[None, None, :]
                    + axes_g[:, :, a, 2][..., None] * pz[None, None, :])
            ok = jnp.abs(proj - proj_c[:, :, a][..., None]) <= half[a]
            inside = ok if inside is None else (inside & ok)    # (S,N,C)
        return inside & mask[None, None, :] & step_valid_col

    # Chunked scan over obstacles: bounds the (S,N,C) intermediate that
    # one fusion produces. Chunking beat a single pass before the port to
    # the H100; not re-measured there.
    chunk = min(obstacle_chunk, k_total)
    n_chunks = -(-k_total // chunk)
    pad = n_chunks * chunk - k_total
    obs_p = jnp.pad(obs_c, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
    obs_m = jnp.pad(obs_valid, (0, pad)).reshape(n_chunks, chunk)

    def body(hit, chunk_in):
        pts, mask = chunk_in
        inside = axis_inside(pts, mask, r.step_valid[:, :, None])
        return hit | jnp.any(inside, axis=(1, 2)), None

    hit0 = jnp.zeros(r.valid.shape, bool)
    hit, _ = jax.lax.scan(body, hit0, (obs_p, obs_m))

    return jnp.where(enough & hit, -1.0, 0.0)


def collision_min_max_scores(r: Rollouts, cuboid: CuboidConfig, obstacles,
                             obs_valid, obstacle_chunk: int = 256):
    """`CollisionMinMaxModel::scoreTrajectory`
    (`collision_min_max_model.cpp:51-89`): the cheaper AABB variant — -1
    when any observed point within 1 m of a rollout pose falls inside the
    axis-aligned bounding box of the transformed footprint cuboid at that
    step; 0 otherwise; 0 when fewer than 5 points.

    The 1 m radius gate is part of the reference semantics (points inside
    the AABB but beyond the radius search are never tested), so it is kept.
    """
    enough = jnp.sum(obs_valid) >= 5

    corners = jnp.asarray(cuboid.corners(), jnp.float32)         # (8,3)
    cth, sth = jnp.cos(r.theta), jnp.sin(r.theta)                # (S,N)

    # corner c rotated by Rz(theta) then robot_quat, in robot-centered coords
    def corner_g(c):
        v = jnp.stack([cth * c[0] - sth * c[1],
                       sth * c[0] + cth * c[1],
                       jnp.broadcast_to(c[2], cth.shape)], axis=-1)
        return quat_rotate(r.robot_quat, v)                      # (S,N,3)

    rel = r.positions - r.robot_pos                              # (S,N,3)
    cg = jnp.stack([rel + corner_g(corners[i]) for i in range(8)],
                   axis=2)                                       # (S,N,8,3)
    aabb_min = jnp.min(cg, axis=2)                               # (S,N,3)
    aabb_max = jnp.max(cg, axis=2)

    k_total = obstacles.shape[0]
    chunk = min(obstacle_chunk, k_total)
    n_chunks = -(-k_total // chunk)
    pad = n_chunks * chunk - k_total
    obs_p = jnp.pad(obstacles - r.robot_pos, ((0, pad), (0, 0)))
    obs_m = jnp.pad(obs_valid, (0, pad))
    obs_p = obs_p.reshape(n_chunks, chunk, 3)
    obs_m = obs_m.reshape(n_chunks, chunk)

    def body(hit, chunk_in):
        pts, mask = chunk_in                                      # (C,3),(C,)
        d = pts[None, None, :, :] - rel[:, :, None, :]            # (S,N,C,3)
        near = jnp.sum(d * d, axis=-1) <= 1.0                     # (S,N,C)
        inside = jnp.all(
            (pts[None, None, :, :] >= aabb_min[:, :, None, :])
            & (pts[None, None, :, :] <= aabb_max[:, :, None, :]), axis=-1)
        bad = inside & near & mask[None, None, :] & r.step_valid[:, :, None]
        return hit | jnp.any(bad, axis=(1, 2)), None

    hit0 = jnp.zeros(r.valid.shape, bool)
    hit, _ = jax.lax.scan(body, hit0, (obs_p, obs_m))
    return jnp.where(enough & hit, -1.0, 0.0)


def stick_path_scores(r: Rollouts, plan: PrunePlan, weight: float):
    """`StickPathModel` (`stick_path_model.cpp:51-77`): Σ_steps NN-distance
    to the prune plan, divided by the *plan* size (reference quirk), +10
    when the plan has <3 poses. The result is multiplied by the critic
    weight? — no: the reference applies no weight inside the model; the
    configured `weight` scales the normalized distance. We keep the
    reference formula exactly (weight unused there ⇒ applied as configured
    multiplier for forward compatibility, default 0.1 matches deployment)."""
    # Scan over steps: keeps the pairwise matrix at (S, P) per step so the
    # critic scales to 10k+ rollouts without an (S*N, P) blow-up.
    def body(acc, step_in):
        pos_n, mask_n = step_in            # (S,3), (S,)
        d2 = _masked_sq_dists(pos_n, mask_n, plan.positions, plan.valid)
        nn = jnp.sqrt(jnp.min(d2, axis=1))
        return acc + jnp.where(mask_n, nn, 0.0), None

    acc0 = jnp.zeros(r.positions.shape[0], jnp.float32)
    total, _ = jax.lax.scan(
        body, acc0,
        (jnp.swapaxes(r.positions, 0, 1), jnp.swapaxes(r.step_valid, 0, 1)))
    total = total / jnp.maximum(plan.count, 1)
    return jnp.where(plan.count < 3, 10.0, total)


def pure_pursuit_scores(r: Rollouts, plan: PrunePlan,
                        translation_weight: float, orientation_weight: float):
    """`PurePursuitModel` (`pure_pursuit_model.cpp:60-115`): pose delta
    between rollout end pose and prune-plan end pose via affine inverse
    composition; cost = tw·‖Δt‖ + ow·fmod(Δyaw+3.1416, 3.1416); -4 when
    the plan is empty or the rollout has <2 points."""
    e_pos = end_positions(r)                          # (S,3)
    e_quat = end_quats(r)                             # (S,4)
    last_i = jnp.clip(plan.count - 1, 0, plan.positions.shape[0] - 1)
    p_pos = plan.positions[last_i]
    p_quat = plan.quats[last_i]

    q_rel = quat_multiply(quat_conjugate(e_quat), p_quat)
    t_rel = quat_rotate(quat_conjugate(e_quat), p_pos[None, :] - e_pos)
    yaw = yaw_from_quat(q_rel)
    yaw = jnp.mod(yaw + 3.1416, 3.1416)
    dist = jnp.linalg.norm(t_rel, axis=-1)
    cost = translation_weight * dist + orientation_weight * yaw
    bad = (plan.count == 0) | (r.num_steps < 2)
    return jnp.where(bad, -4.0, cost)


def toward_global_plan_scores(r: Rollouts, plan: PrunePlan, weight: float):
    """`TowardGlobalPlanModel` (`toward_global_plan_model.cpp:52-78`):
    weight × NN-distance of the rollout end pose to the prune plan; +10
    when the plan has <3 poses."""
    e_pos = end_positions(r)
    d2 = _masked_sq_dists(e_pos, jnp.ones(e_pos.shape[0], bool),
                          plan.positions, plan.valid)
    nn = jnp.sqrt(jnp.min(d2, axis=1))
    return jnp.where(plan.count < 3, 10.0, nn * weight)


def shortest_angle_scores(r: Rollouts, heading_deviation, weight: float):
    """`ShortestAngleModel` (`shortest_angle_model.cpp:51-67`): weight when
    the rotation direction matches the heading deviation sign, 2×weight
    otherwise."""
    w = r.samples[:, -1]  # ω is the last column (dd and omni layouts)
    match = jnp.where(heading_deviation >= 0, w >= 0, w < 0)
    return jnp.where(match, weight, 2.0 * weight)


def twirling_scores(r: Rollouts, weight: float):
    """`TwirlingModel` (`twirling_model.cpp:51-55`): |ω|·weight."""
    return jnp.abs(r.samples[:, -1]) * weight


def score_rollouts(critics: CriticsConfig, cuboid: CuboidConfig, r: Rollouts,
                   plan: PrunePlan, obstacles, obs_valid,
                   heading_deviation=0.0, obstacle_chunk: int = 256,
                   collision_near_k: int = 0):
    """Run the configured critic stack; returns (costs, rejected).

    ``costs`` is the summed score for accepted rollouts; rejected rollouts
    carry their first negative critic value (reference short-circuit
    return). Invalid rollouts are rejected with -1 (generator semantics:
    never generated)."""
    total = jnp.zeros(r.valid.shape, jnp.float32)
    neg_val = jnp.zeros(r.valid.shape, jnp.float32)
    rejected = jnp.zeros(r.valid.shape, bool)

    def apply(score):
        nonlocal total, neg_val, rejected
        is_neg = score < 0.0
        neg_val = jnp.where(rejected, neg_val, jnp.where(is_neg, score, neg_val))
        rejected = rejected | is_neg
        total = total + jnp.where(is_neg, 0.0, score)

    if critics.collision is not None:
        apply(collision_scores(r, cuboid, obstacles, obs_valid,
                               obstacle_chunk=obstacle_chunk,
                               near_k=collision_near_k)
              * critics.collision.weight)
    if getattr(critics, "collision_min_max", None) is not None:
        apply(collision_min_max_scores(r, cuboid, obstacles, obs_valid,
                                       obstacle_chunk=obstacle_chunk)
              * critics.collision_min_max.weight)
    if critics.stick_path is not None:
        apply(stick_path_scores(r, plan, 1.0) * critics.stick_path.weight)
    if critics.pure_pursuit is not None:
        apply(pure_pursuit_scores(
            r, plan, critics.pure_pursuit.translation_weight,
            critics.pure_pursuit.orientation_weight))
    if critics.toward_global_plan is not None:
        apply(toward_global_plan_scores(
            r, plan, critics.toward_global_plan.weight))
    if critics.shortest_angle is not None:
        apply(shortest_angle_scores(
            r, heading_deviation, critics.shortest_angle.weight))
    if critics.twirling is not None:
        apply(twirling_scores(r, critics.twirling.weight))

    rejected = rejected | (~r.valid)
    costs = jnp.where(rejected, jnp.minimum(neg_val, -1.0), total)
    return costs, rejected


def best_trajectory(costs, rejected):
    """`Local_Planner::getBestTrajectory` (`local_planner.cpp:447-480`):
    minimum cost among accepted; on ties the *last* scanned trajectory wins
    (``<=`` update). Returns (index, cost, found)."""
    s = costs.shape[0]
    masked = jnp.where(rejected, jnp.inf, costs)
    rev = masked[::-1]
    idx = s - 1 - jnp.argmin(rev)
    found = jnp.any(~rejected)
    return idx, jnp.where(found, costs[idx], -1.0), found
