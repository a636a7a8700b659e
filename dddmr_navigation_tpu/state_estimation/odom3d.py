"""3D odometry fusion — JAX re-design of ``dddmr_odom_3d``
(`src/dddmr_odom_3d/src/odom_3d_example.cpp:35-110`).

Wheel-odometry linear velocity × IMU orientation → 3D odometry. The
reference integrates at 10 Hz inside a ROS timer:

    x += v·cos(pitch)·cos(yaw)·dt
    y += v·cos(pitch)·sin(yaw)·dt
    z += v·sin(−pitch)·dt

with orientation taken straight from the IMU quaternion. Here the
integrator is a pure function so a whole twist/IMU log integrates in one
``lax.scan`` (and batches over robots with ``vmap``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.geometry import rpy_from_quat


class Odom3DState(NamedTuple):
    pos: jnp.ndarray   # (3,)
    quat: jnp.ndarray  # (4,) latest IMU orientation


def init_odom3d() -> Odom3DState:
    return Odom3DState(pos=jnp.zeros((3,), jnp.float32),
                       quat=jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32))


def odom3d_step(state: Odom3DState, v_linear, imu_quat, dt) -> Odom3DState:
    """One fusion step (`odom_3d_example.cpp:93-96`)."""
    _, pitch, yaw = rpy_from_quat(imu_quat)
    dx = v_linear * jnp.cos(pitch) * jnp.cos(yaw) * dt
    dy = v_linear * jnp.cos(pitch) * jnp.sin(yaw) * dt
    dz = v_linear * jnp.sin(-pitch) * dt
    return Odom3DState(pos=state.pos + jnp.stack([dx, dy, dz]),
                       quat=jnp.asarray(imu_quat, jnp.float32))


def integrate_log(state: Odom3DState, v_linear_seq, imu_quat_seq, dt_seq):
    """Integrate a whole recorded log: returns (final_state, (T,3) path)."""
    def step(s, inp):
        v, q, dt = inp
        s2 = odom3d_step(s, v, q, dt)
        return s2, s2.pos

    return jax.lax.scan(step, state, (v_linear_seq, imu_quat_seq, dt_seq))
