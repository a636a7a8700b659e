"""Batched trajectory rollout: the reference's per-sample Euler loop
(`DDSimpleTrajectoryGeneratorTheory::generateTrajectory`,
`dd_simple_trajectory_generator_theory.cpp:351-464`) as one `lax.scan`
vmapped over all samples.

Reference semantics preserved per sample:
  * validity gates: |v| ≥ min_vel_x or |ω| ≥ min_vel_theta; |v| ≤ max_vel_x;
  * num_steps = ceil(max(|v|·T/sim_granularity, |ω|·T/angular_granularity)),
    zero steps ⇒ invalid; per-sample dt = T/num_steps (variable dt is the
    reference's behavior — batched here as a (S,) dt vector with a step
    validity mask up to MAX_STEPS);
  * unicycle integration x += v·cosθ·dt in the *robot frame*, then the full
    3D robot pose transform to global (so rollouts ride slopes);
  * per-step 8-corner footprint cuboid in global frame (computed on demand
    by the collision critic — see critics.py — rather than stored).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from dddmr_navigation_tpu.geometry import quat_rotate, quat_multiply, quat_from_yaw


class Rollouts(NamedTuple):
    """Batched rollout results. S = samples, N = MAX_STEPS."""
    samples: jnp.ndarray      # (S, 2) [vx, ω] or (S, 3) [vx, vy, ω]
    valid: jnp.ndarray        # (S,) trajectory validity
    step_valid: jnp.ndarray   # (S, N) per-step validity
    positions: jnp.ndarray    # (S, N, 3) global positions
    theta: jnp.ndarray        # (S, N) robot-frame accumulated heading
    num_steps: jnp.ndarray    # (S,) int32
    dt: jnp.ndarray           # (S,) per-sample timestep
    robot_pos: jnp.ndarray    # (3,)
    robot_quat: jnp.ndarray   # (4,)


def rollout(samples, sample_valid, robot_pos, robot_quat, *,
            sim_time: float, sim_granularity: float,
            angular_sim_granularity: float, min_vel_x: float,
            min_vel_theta: float, max_vel_x: float, max_steps: int,
            sim_time_per_sample=None) -> Rollouts:
    """Roll out all velocity samples.

    Args:
      samples: (S, 2) [vx, ω] (diff-drive) or (S, 3) [vx, vy, ω] (omni —
        `OmniSimpleTrajectoryGeneratorTheory`, validity gates on
        vmag = hypot(vx, vy) per `omni_simple_...cpp:494-510`).
      sample_valid: (S,) bool.
      robot_pos/quat: robot pose in global frame.
      sim_time_per_sample: optional (S,) horizon override (the rotate
        generator uses 6.28/|ω|, `dd_rotate_inplace_theory.cpp:330`).
    """
    omni = samples.shape[1] == 3
    vx = samples[:, 0]
    vy = samples[:, 1] if omni else jnp.zeros_like(vx)
    w = samples[:, -1]
    vmag = jnp.hypot(vx, vy) if omni else jnp.abs(vx)
    eps = 1e-4

    T = (jnp.full_like(vx, sim_time) if sim_time_per_sample is None
         else sim_time_per_sample)

    # validity gates (generateTrajectory early returns)
    too_slow = jnp.ones_like(vx, dtype=bool)
    if min_vel_x >= 0:
        too_slow = too_slow & (vmag + eps < min_vel_x)
    else:
        too_slow = jnp.zeros_like(vx, dtype=bool)
    if min_vel_theta >= 0:
        too_slow = too_slow & (jnp.abs(w) + eps < min_vel_theta)
    else:
        too_slow = jnp.zeros_like(vx, dtype=bool)
    too_fast = (vmag - eps > max_vel_x) if max_vel_x >= 0 else jnp.zeros_like(vx, dtype=bool)

    num_steps = jnp.ceil(jnp.maximum(
        vmag * T / sim_granularity,
        jnp.abs(w) * T / angular_sim_granularity)).astype(jnp.int32)
    num_steps = jnp.minimum(num_steps, max_steps)
    valid = sample_valid & (~too_slow) & (~too_fast) & (num_steps > 0)

    dt = T / jnp.maximum(num_steps, 1).astype(jnp.float32)

    # Closed-form Euler: the reference's update uses the *previous* heading
    # (`computeNewPositions`, `dd_simple_...cpp:457-464`), so
    #   θ_k = k·ω·dt  and  x_k = v·dt·Σ_{j<k} cos(θ_j)
    # — a cumsum instead of a sequential scan (O(log N) depth; the
    # tree-reduction rounding differs from serial accumulation only at the
    # f32 ulp level).
    j = jnp.arange(max_steps, dtype=jnp.float32)            # θ before step k
    th_pre = j[None, :] * (w * dt)[:, None]                  # (S, N)
    cos_c = jnp.cumsum(jnp.cos(th_pre), axis=1)
    sin_c = jnp.cumsum(jnp.sin(th_pre), axis=1)
    # omni adds the lateral term (vy rotated +90°:
    # `computeNewPositions`, `omni_simple_...cpp:499-505`)
    xs = (vx * dt)[:, None] * cos_c - (vy * dt)[:, None] * sin_c
    ys = (vx * dt)[:, None] * sin_c + (vy * dt)[:, None] * cos_c
    ths = (j[None, :] + 1.0) * (w * dt)[:, None]             # θ after step k

    local = jnp.stack([xs, ys, jnp.zeros_like(xs)], axis=-1)  # (S, N, 3)
    positions = quat_rotate(robot_quat[None, None, :], local) + robot_pos

    step_idx = jnp.arange(max_steps)[None, :]
    step_valid = valid[:, None] & (step_idx < num_steps[:, None])

    return Rollouts(
        samples=samples, valid=valid, step_valid=step_valid,
        positions=positions, theta=ths, num_steps=num_steps, dt=dt,
        robot_pos=robot_pos, robot_quat=robot_quat)


def end_indices(r: Rollouts):
    """Index of the last valid step per sample (num_steps-1, clamped)."""
    return jnp.clip(r.num_steps - 1, 0, r.positions.shape[1] - 1)


def _end_onehot(r: Rollouts):
    # One-hot select instead of take_along_axis: per-row gathers along a
    # middle axis lowered to a slow gather path; the masked reduction is
    # one fused elementwise pass. Chosen before the port to the H100; not
    # re-measured there.
    n = r.positions.shape[1]
    idx = jnp.arange(n)
    return (idx[None, :] == end_indices(r)[:, None]).astype(jnp.float32)


def end_positions(r: Rollouts):
    oh = _end_onehot(r)
    return jnp.einsum("sn,snk->sk", oh, r.positions,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def end_quats(r: Rollouts):
    """Global orientation at the last step: robot_quat ∘ Rz(θ_end)."""
    th_end = jnp.sum(_end_onehot(r) * r.theta, axis=1)
    return quat_multiply(r.robot_quat[None, :], quat_from_yaw(th_end))


def step_quats(r: Rollouts):
    """(S, N, 4) global orientation at every step."""
    return quat_multiply(r.robot_quat[None, None, :], quat_from_yaw(r.theta))
