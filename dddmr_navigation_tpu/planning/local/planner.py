"""The local-planner control tick: plan pruning, rollout, scoring, argmin.

Re-designs `Local_Planner::computeVelocityCommand`
(`local_planner/src/local_planner.cpp:482-621`) as a pure jitted function
over device state — no mutexes, no plugin registries; the plugin stacks
become static config. State codes mirror
`dddmr_sys_core/dddmr_enum_states.h:46-54`.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.config import LocalPlannerConfig
from dddmr_navigation_tpu.geometry import (
    quat_rotate, quat_conjugate, quat_multiply, yaw_from_quat,
    slope_aware_quat, normalize_angle)
from dddmr_navigation_tpu.planning.local.sampler import (
    dd_simple_samples, omni_simple_samples, rotate_inplace_samples)
from dddmr_navigation_tpu.planning.local.rollout import Rollouts, rollout
from dddmr_navigation_tpu.planning.local.critics import (
    PrunePlan, score_rollouts, best_trajectory)


class PlannerState(enum.IntEnum):
    """`dddmr_enum_states.h:46-54`."""
    TF_FAIL = 0
    PRUNE_PLAN_FAIL = 1
    ALL_TRAJECTORIES_FAIL = 2
    PERCEPTION_MALFUNCTION = 3
    TRAJECTORY_FOUND = 4
    PATH_BLOCKED_WAIT = 5
    PATH_BLOCKED_REPLANNING = 6


class GlobalPlan(NamedTuple):
    """Padded global plan (`setPlan`, `local_planner.cpp:322-344`)."""
    positions: jnp.ndarray   # (L, 3)
    quats: jnp.ndarray       # (L, 4)
    valid: jnp.ndarray       # (L,) bool
    count: jnp.ndarray       # () int32


def make_global_plan(positions, quats=None, max_len: int = 512) -> GlobalPlan:
    import numpy as np
    positions = jnp.asarray(positions, jnp.float32)
    n = positions.shape[0]
    if quats is None:
        seg = jnp.diff(positions, axis=0, append=positions[-1:] * 1.0)
        seg = seg.at[-1].set(seg[-2] if n > 1 else jnp.asarray([1.0, 0, 0]))
        quats = slope_aware_quat(seg)
    pad = max_len - n
    assert pad >= 0, f"plan length {n} exceeds max_len {max_len}"
    pos = jnp.pad(positions, ((0, pad), (0, 0)))
    q = jnp.pad(jnp.asarray(quats, jnp.float32), ((0, pad), (0, 0)))
    valid = jnp.arange(max_len) < n
    return GlobalPlan(pos, q, valid, jnp.asarray(n, jnp.int32))


def prune_plan(cfg: LocalPlannerConfig, plan: GlobalPlan, robot_pos,
               forward_distance=None, backward_distance=None):
    """`Local_Planner::prunePlan` (`local_planner.cpp:374-445`) without the
    KD-tree: nearest plan pose by brute-force argmin, then an arc-length
    window via the cumulative segment length (inclusive of the first pose
    crossing the distance budget, matching the loop's push-then-break).

    Returns (PrunePlan, ok). ok=False ⇒ PRUNE_PLAN_FAIL (deviation > 1 m
    or plan shorter than 3 poses).
    """
    fwd = cfg.forward_prune if forward_distance is None else forward_distance
    bwd = cfg.backward_prune if backward_distance is None else backward_distance
    L = plan.positions.shape[0]
    P = cfg.max_prune_len

    d = jnp.linalg.norm(plan.positions - robot_pos, axis=-1)
    d = jnp.where(plan.valid, d, jnp.inf)
    i0 = jnp.argmin(d)
    ok = (plan.count >= 3) & (d[i0] <= 1.0)

    seg = jnp.linalg.norm(jnp.diff(plan.positions, axis=0), axis=-1)
    seg = jnp.where(plan.valid[1:], seg, 0.0)
    cum = jnp.concatenate([jnp.zeros((1,), jnp.float32), jnp.cumsum(seg)])

    idx = jnp.arange(L)
    # The 1e-5 slack keeps exact-budget boundaries (common: round plan
    # steps vs round prune distances) inclusive under f32 cumsum noise,
    # matching the reference's f64 push-then-break arithmetic.
    eps = 1e-5
    # backward: pose i included iff arc(i0 → i+1) ≤ bwd (push-then-break).
    arc_back = cum[i0] - cum[jnp.minimum(idx + 1, i0)]
    back_ok = (idx <= i0) & (arc_back <= bwd + eps) & plan.valid
    # forward: pose j included iff arc(i0 → j-1) ≤ fwd.
    arc_fwd = cum[jnp.maximum(idx - 1, i0)] - cum[i0]
    fwd_ok = (idx >= i0) & (arc_fwd <= fwd + eps) & plan.valid

    include = back_ok | fwd_ok
    start = jnp.argmax(include)  # first included index
    count = jnp.sum(include)

    # The window is contiguous — dynamic_slice (one sequential copy)
    # instead of a (P,)-index gather (chosen before the port to the H100;
    # not re-measured there). Arrays are
    # padded by P rows so a window starting near the end never clamps
    # (clamping would misalign slot 0, which critics index by count).
    start = start.astype(jnp.int32)
    pos_p = jnp.pad(plan.positions, ((0, P), (0, 0)))
    quat_p = jnp.pad(plan.quats, ((0, P), (0, 0)))
    positions = jax.lax.dynamic_slice(pos_p, (start, 0), (P, 3))
    quats = jax.lax.dynamic_slice(quat_p, (start, 0), (P, 4))
    window_idx = start + jnp.arange(P)
    valid = jnp.arange(P) < jnp.minimum(count, P)
    # intensity: -1 backward poses; forward +1, except global index 0 → 0
    # (`local_planner.cpp:404-431`).
    intensity = jnp.where(window_idx < i0, -1.0,
                          jnp.where(window_idx == 0, 0.0, 1.0))
    pp = PrunePlan(positions=positions, quats=quats,
                   intensity=jnp.where(valid, intensity, 0.0),
                   valid=valid, count=jnp.minimum(count, P))
    # An empty plan on failure (reference leaves prune_plan_ cleared).
    empty = PrunePlan(positions=positions, quats=quats,
                      intensity=jnp.zeros((P,)), valid=jnp.zeros((P,), bool),
                      count=jnp.asarray(0, jnp.int32))
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(ok, a, b), pp, empty), ok


def shortest_angle_to_pose_heading(robot_quat, target_quat):
    """`getShortestAngleFromPose2RobotHeading` (`local_planner.cpp:197-215`):
    yaw of (robot⁻¹ ∘ target)."""
    q_rel = quat_multiply(quat_conjugate(robot_quat), target_quat)
    return normalize_angle(yaw_from_quat(q_rel))


def initial_heading_deviation(cfg: LocalPlannerConfig, plan: GlobalPlan,
                              robot_pos, robot_quat):
    """`isInitialHeadingAligned` (`local_planner.cpp:217-271`): heading of
    the pointing vector from the first to the last pose of a
    heading_tracking_distance prune window, vs robot yaw.

    Returns (yaw_deviation, aligned, ok)."""
    pp, ok = prune_plan(cfg, plan, robot_pos,
                        forward_distance=cfg.heading_tracking_distance,
                        backward_distance=0.0)
    ok = ok & (pp.count >= 3)
    last_i = jnp.clip(pp.count - 1, 0, pp.positions.shape[0] - 1)
    v = pp.positions[last_i] - pp.positions[0]
    q_point = slope_aware_quat(v)
    yaw = shortest_angle_to_pose_heading(robot_quat, q_point)
    aligned = jnp.abs(yaw) < cfg.heading_align_angle
    return yaw, aligned & ok, ok


def goal_heading_deviation(cfg: LocalPlannerConfig, plan: GlobalPlan,
                           robot_quat):
    """`isGoalHeadingAligned` (`local_planner.cpp:273-304`)."""
    last_i = jnp.clip(plan.count - 1, 0, plan.positions.shape[0] - 1)
    yaw = shortest_angle_to_pose_heading(robot_quat, plan.quats[last_i])
    aligned = (plan.count > 0) & (jnp.abs(yaw) < cfg.yaw_goal_tolerance)
    return yaw, aligned


def goal_reached(cfg: LocalPlannerConfig, plan: GlobalPlan, robot_pos):
    """`isGoalReached` (`local_planner.cpp:306-320`): 3D distance to the
    final plan pose under xy_goal_tolerance."""
    last_i = jnp.clip(plan.count - 1, 0, plan.positions.shape[0] - 1)
    d = jnp.linalg.norm(robot_pos - plan.positions[last_i])
    return (plan.count > 0) & (d < cfg.xy_goal_tolerance)


class VelocityCommand(NamedTuple):
    vx: jnp.ndarray
    wz: jnp.ndarray
    vy: jnp.ndarray           # nonzero only for the omni generator
    state: jnp.ndarray        # PlannerState code, int32
    best_index: jnp.ndarray
    best_cost: jnp.ndarray
    prune: PrunePlan
    rollouts: Rollouts
    costs: jnp.ndarray
    rejected: jnp.ndarray


def compute_velocity_command(cfg: LocalPlannerConfig, plan: GlobalPlan,
                             robot_pos, robot_quat, v_now, w_now,
                             obstacles, obs_valid,
                             allowed_max_speed=-1.0,
                             heading_deviation=0.0,
                             generator: str = "differential_drive_simple",
                             vy_now=0.0) -> VelocityCommand:
    """One control tick (`computeVelocityCommand`, `local_planner.cpp:482-621`),
    minus the host-side gates (sensor freshness, TF age) which live in the
    move-base driver.

    Args:
      obstacles/obs_valid: padded aggregated observation (the local
        vertical's raw transformed scan — `multilayer_spinning_lidar.cpp:
        264-269`).
      generator: 'differential_drive_simple' | 'omni_drive_simple'
        | 'differential_drive_rotate_inplace'
        | 'differential_drive_rotate_shortest_angle' (static switch — each
        compiles its own program, as the reference pre-registers plugins).
      vy_now: current lateral velocity (omni generator only).
    """
    pp, prune_ok = prune_plan(cfg, plan, robot_pos)

    if generator == "differential_drive_simple":
        gen = cfg.generator
        samples, valid = dd_simple_samples(
            gen, v_now, w_now, jnp.asarray(allowed_max_speed, jnp.float32))
        r = rollout(samples, valid, robot_pos, robot_quat,
                    sim_time=gen.sim_time, sim_granularity=gen.sim_granularity,
                    angular_sim_granularity=gen.angular_sim_granularity,
                    min_vel_x=gen.limits.min_vel_x,
                    min_vel_theta=gen.limits.min_vel_theta,
                    max_vel_x=gen.limits.max_vel_x,
                    max_steps=gen.max_num_steps)
        critics = cfg.critics
        cuboid = gen.cuboid
    elif generator == "omni_drive_simple":
        gen = cfg.omni_generator
        samples, valid = omni_simple_samples(
            gen, v_now, jnp.asarray(vy_now, jnp.float32), w_now)
        # speed-zone cap rejects by translational magnitude
        # (`omni_simple_...cpp:513-517`)
        cap = jnp.asarray(allowed_max_speed, jnp.float32)
        vmag = jnp.hypot(samples[:, 0], samples[:, 1])
        valid = valid & ((cap <= 0.0) | (vmag - 1e-4 <= cap))
        r = rollout(samples, valid, robot_pos, robot_quat,
                    sim_time=gen.sim_time, sim_granularity=gen.sim_granularity,
                    angular_sim_granularity=gen.angular_sim_granularity,
                    min_vel_x=gen.limits.min_vel_trans,
                    min_vel_theta=gen.limits.min_vel_theta,
                    max_vel_x=gen.limits.max_vel_trans,
                    max_steps=gen.max_num_steps)
        critics = cfg.critics
        cuboid = gen.cuboid
    elif generator in ("differential_drive_rotate_inplace",
                       "differential_drive_rotate_shortest_angle"):
        gen = cfg.rotate_generator
        samples, valid = rotate_inplace_samples(gen, cfg.generator.limits)
        sim_t = 6.28 / jnp.maximum(jnp.abs(samples[:, 1]), 1e-6)
        r = rollout(samples, valid, robot_pos, robot_quat,
                    sim_time=0.0, sim_granularity=gen.sim_granularity,
                    angular_sim_granularity=gen.angular_sim_granularity,
                    min_vel_x=-1.0, min_vel_theta=-1.0, max_vel_x=-1.0,
                    max_steps=gen.max_num_steps, sim_time_per_sample=sim_t)
        critics = cfg.rotate_critics
        cuboid = gen.cuboid
    else:
        raise ValueError(f"unknown generator {generator}")

    costs, rejected = score_rollouts(
        critics, cuboid, r, pp, obstacles, obs_valid,
        heading_deviation=jnp.asarray(heading_deviation, jnp.float32),
        obstacle_chunk=cfg.collision_obstacle_chunk,
        collision_near_k=cfg.collision_near_k)
    idx, cost, found = best_trajectory(costs, rejected)

    found_ok = found & prune_ok
    vx = jnp.where(found_ok, r.samples[idx, 0], 0.0)
    wz = jnp.where(found_ok, r.samples[idx, -1], 0.0)
    vy = (jnp.where(found_ok, r.samples[idx, 1], 0.0)
          if r.samples.shape[1] == 3 else jnp.zeros_like(vx))
    state = jnp.where(
        ~prune_ok, PlannerState.PRUNE_PLAN_FAIL,
        jnp.where(found, PlannerState.TRAJECTORY_FOUND,
                  PlannerState.ALL_TRAJECTORIES_FAIL)).astype(jnp.int32)

    return VelocityCommand(vx=vx, wz=wz, vy=vy, state=state, best_index=idx,
                           best_cost=cost, prune=pp, rollouts=r,
                           costs=costs, rejected=rejected)
