"""Functional 6DOF particle filter — JAX re-design of the reference's
header-only ``mcl_3dl::ParticleFilter`` (`include/mcl_3dl/pf.h:155-450`).

The reference loops a ``std::vector<Particle>`` with per-particle lambdas;
here the particle set is a static-shape pytree of arrays and every
operation is a batched array op (the per-particle loops of
`pf.h:233-260` become plain vectorized math — no ``vmap`` even needed).

Semantics preserved:
  * ``measure`` multiplies prior weights by likelihood and normalizes,
    restoring the previous weights when everything dies (`pf.h:247-269`).
  * ``resample`` is systematic over the cumulative weights with the
    reference's duplicate-only noise rule: the *first* copy of a particle
    keeps its exact state, further copies get Gaussian noise
    (`pf.h:181-219`: noise is added only when ``it == it_prev``).
  * ``expectation_biased`` weights by ``probability * probability_bias``
    (`pf.h:283-291`).
  * odom-error integrals and per-particle noise coefficients live in the
    state exactly as ``State6DOF`` carries them
    (`include/mcl_3dl/state_6dof.h`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.geometry import (
    quat_normalize, quat_multiply, quat_conjugate, quat_rotate,
    quat_from_rpy, rpy_from_quat, quat_from_axis_angle)
from dddmr_navigation_tpu.config import MCLConfig


class PFState(NamedTuple):
    """Particle set (leading axis N = num particles; static)."""
    pos: jnp.ndarray    # (N, 3) f32
    quat: jnp.ndarray   # (N, 4) f32 (x, y, z, w)
    prob: jnp.ndarray   # (N,) f32, sums to 1
    odom_err_integ_lin: jnp.ndarray  # (N, 3)
    odom_err_integ_ang: jnp.ndarray  # (N, 3)
    # Per-particle odometry noise coefficients, refreshed each update
    # (reference `mcl_3dl.cpp:222-231`).
    noise_ll: jnp.ndarray  # (N,)
    noise_la: jnp.ndarray  # (N,)
    noise_aa: jnp.ndarray  # (N,)
    noise_al: jnp.ndarray  # (N,)


def _pose_noise(key, n, sigma6):
    """Gaussian pose noise: (N,3) translation + (N,4) quaternion built from
    rpy noise (reference DiagonalNoiseGenerator over State6DOF)."""
    kp, kr = jax.random.split(key)
    dp = jax.random.normal(kp, (n, 3)) * sigma6[:3]
    drpy = jax.random.normal(kr, (n, 3)) * sigma6[3:]
    dq = quat_from_rpy(drpy[:, 0], drpy[:, 1], drpy[:, 2])
    return dp.astype(jnp.float32), dq.astype(jnp.float32)


def init_particles(key, cfg: MCLConfig, init_pos, init_quat,
                   num_particles: int | None = None) -> PFState:
    """`ParticleFilter::init` — Gaussian cloud around the initial pose with
    the ``init_var_*`` sigmas."""
    n = num_particles or cfg.num_particles
    sigma = jnp.asarray([cfg.init_var_x, cfg.init_var_y, cfg.init_var_z,
                         cfg.init_var_roll, cfg.init_var_pitch,
                         cfg.init_var_yaw], jnp.float32)
    dp, dq = _pose_noise(key, n, sigma)
    pos = jnp.asarray(init_pos, jnp.float32)[None, :] + dp
    quat = quat_normalize(quat_multiply(dq, jnp.broadcast_to(
        jnp.asarray(init_quat, jnp.float32), (n, 4))))
    z3 = jnp.zeros((n, 3), jnp.float32)
    z1 = jnp.zeros((n,), jnp.float32)
    return PFState(pos=pos, quat=quat,
                   prob=jnp.full((n,), 1.0 / n, jnp.float32),
                   odom_err_integ_lin=z3, odom_err_integ_ang=z3,
                   noise_ll=z1, noise_la=z1, noise_aa=z1, noise_al=z1)


def predict_diff_drive(state: PFState, rel_trans, rel_quat, rel_angle, dt,
                       cfg: MCLConfig) -> PFState:
    """Differential-drive motion model over all particles
    (`motion_prediction_model_differential_drive.h:57-68`):

      diff = rel_trans*(1+noise_ll) + [noise_al*rel_angle, 0, 0]
      pos += rot*diff
      yaw_diff = noise_la*|rel_trans| + noise_aa*rel_angle
      rot = Quat(z, yaw_diff) * rot * rel_quat
      integrals accumulate and decay with time constants.
    """
    n = state.pos.shape[0]
    rel_trans = jnp.asarray(rel_trans, jnp.float32)
    rel_norm = jnp.linalg.norm(rel_trans)
    diff = (rel_trans[None, :] * (1.0 + state.noise_ll)[:, None]
            + jnp.stack([state.noise_al * rel_angle,
                         jnp.zeros(n), jnp.zeros(n)], axis=-1))
    integ_lin = state.odom_err_integ_lin + (diff - rel_trans[None, :])
    pos = state.pos + quat_rotate(state.quat, diff)
    yaw_diff = state.noise_la * rel_norm + state.noise_aa * rel_angle
    dq = quat_from_axis_angle(
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3)),
        yaw_diff)
    quat = quat_normalize(quat_multiply(
        quat_multiply(dq, state.quat),
        jnp.broadcast_to(jnp.asarray(rel_quat, jnp.float32), (n, 4))))
    integ_ang = state.odom_err_integ_ang + jnp.stack(
        [jnp.zeros(n), jnp.zeros(n), yaw_diff], axis=-1)
    integ_lin = integ_lin * (1.0 - dt / cfg.odom_err_integ_lin_tc)
    integ_ang = integ_ang * (1.0 - dt / cfg.odom_err_integ_ang_tc)
    return state._replace(pos=pos, quat=quat,
                          odom_err_integ_lin=integ_lin,
                          odom_err_integ_ang=integ_ang)


def measure(state: PFState, likelihood) -> PFState:
    """`ParticleFilter::measure` (`pf.h:247-269`): posterior ∝ prior ×
    likelihood; if the whole cloud dies, keep the prior weights."""
    raw = state.prob * likelihood
    s = jnp.sum(raw)
    prob = jnp.where(s > 0.0, raw / jnp.maximum(s, 1e-30), state.prob)
    return state._replace(prob=prob)


def bias_weights(state: PFState, prev_pos, prev_quat, cfg: MCLConfig,
                 uniform: bool = False):
    """`MCL3dlNode::measure` bias block (`mcl_3dl.cpp:508-531`):
    particles far from the previous expectation get down-weighted with
    NormalLikelihood(bias_var_dist / bias_var_ang); during global
    localization (particle overflow) the bias is uniform. Returns (N,)."""
    if uniform:
        return jnp.ones_like(state.prob)
    lin_diff = jnp.linalg.norm(state.pos - jnp.asarray(prev_pos)[None, :],
                               axis=-1)
    qrel = quat_multiply(state.quat, quat_conjugate(
        jnp.broadcast_to(jnp.asarray(prev_quat, jnp.float32), state.quat.shape)))
    ang_diff = 2.0 * jnp.arccos(jnp.clip(jnp.abs(qrel[:, 3]), 0.0, 1.0))

    def normal_likelihood(x, sigma):
        # mcl_3dl::NormalLikelihood (nd.h): a = 1/sqrt(2 pi sigma^2)
        a = 1.0 / jnp.sqrt(2.0 * jnp.pi * sigma * sigma)
        return a * jnp.exp(-x * x / (2.0 * sigma * sigma))

    return (normal_likelihood(lin_diff, cfg.bias_var_dist)
            * normal_likelihood(ang_diff, cfg.bias_var_ang) + 1e-6)


def _weighted_mean_pose(pos, quat, w):
    """ParticleWeightedMean: weighted mean of positions; quaternion mean by
    sign-aligned weighted component sum (normalized)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-30)
    mean_pos = jnp.sum(pos * w[:, None], axis=0) / wsum
    ref = quat[jnp.argmax(w)]
    sign = jnp.where(jnp.sum(quat * ref[None, :], axis=-1) < 0.0, -1.0, 1.0)
    mean_quat = quat_normalize(jnp.sum(quat * (w * sign)[:, None], axis=0))
    return mean_pos, mean_quat


def expectation(state: PFState):
    return _weighted_mean_pose(state.pos, state.quat, state.prob)


def expectation_biased(state: PFState, bias):
    """`pf.h:283-291`."""
    return _weighted_mean_pose(state.pos, state.quat, state.prob * bias)


def max_particle(state: PFState):
    i = jnp.argmax(state.prob)
    return state.pos[i], state.quat[i]


def resample(key, state: PFState, cfg: MCLConfig) -> PFState:
    """Systematic resampling with duplicate-only noise (`pf.h:177-219`).

    pscan_i = pstep*i + U(0, pstep); target index = first cumulative weight
    ≥ pscan. The first draw of a given source particle copies it exactly;
    subsequent draws of the same source add ``resample_var_*`` noise.
    """
    n = state.prob.shape[0]
    ku, kn = jax.random.split(key)
    accum = jnp.cumsum(state.prob)
    pstep = accum[-1] / n
    u0 = jax.random.uniform(ku, (), minval=0.0, maxval=pstep)
    pscan = pstep * jnp.arange(n, dtype=jnp.float32) + u0
    idx = jnp.searchsorted(accum, pscan, side="left")
    overflow = idx >= n  # it == end(): keep previous iterator's state
    idx = jnp.clip(idx, 0, n - 1)
    # duplicate mask: same source index as the previous draw → noisy copy
    dup = jnp.concatenate([jnp.zeros((1,), bool), idx[1:] == idx[:-1]])
    dup = dup & ~overflow

    sigma = jnp.asarray([cfg.resample_var_x, cfg.resample_var_y,
                         cfg.resample_var_z, cfg.resample_var_roll,
                         cfg.resample_var_pitch, cfg.resample_var_yaw],
                        jnp.float32)
    dp, dq = _pose_noise(kn, n, sigma)
    pos = state.pos[idx]
    quat = state.quat[idx]
    pos = jnp.where(dup[:, None], pos + dp, pos)
    quat = jnp.where(dup[:, None],
                     quat_normalize(quat_multiply(dq, quat)), quat)
    return state._replace(
        pos=pos, quat=quat,
        prob=jnp.full((n,), 1.0 / n, jnp.float32),
        odom_err_integ_lin=state.odom_err_integ_lin[idx],
        odom_err_integ_ang=state.odom_err_integ_ang[idx],
        noise_ll=state.noise_ll[idx], noise_la=state.noise_la[idx],
        noise_aa=state.noise_aa[idx], noise_al=state.noise_al[idx])


def add_pose_noise(key, state: PFState, sigma6) -> PFState:
    """`ParticleFilter::noise` — expansion resetting
    (`mcl_3dl.cpp:648-659`)."""
    n = state.pos.shape[0]
    dp, dq = _pose_noise(key, n, jnp.asarray(sigma6, jnp.float32))
    return state._replace(
        pos=state.pos + dp,
        quat=quat_normalize(quat_multiply(dq, state.quat)))


def refresh_odom_noise(key, state: PFState, cfg: MCLConfig) -> PFState:
    """Per-particle odometry noise coefficient refresh
    (`mcl_3dl.cpp:222-231`)."""
    ks = jax.random.split(key, 4)
    n = state.prob.shape[0]
    return state._replace(
        noise_ll=jax.random.normal(ks[0], (n,)) * cfg.odom_err_lin_lin,
        noise_la=jax.random.normal(ks[1], (n,)) * cfg.odom_err_lin_ang,
        noise_aa=jax.random.normal(ks[2], (n,)) * cfg.odom_err_ang_ang,
        noise_al=jax.random.normal(ks[3], (n,)) * cfg.odom_err_ang_lin)


def reset_err_integrals(state: PFState) -> PFState:
    """The jump-detected integral reset (`mcl_3dl.cpp:568-575`)."""
    z = jnp.zeros_like(state.odom_err_integ_lin)
    return state._replace(odom_err_integ_lin=z, odom_err_integ_ang=z)


def covariance(state: PFState):
    """6×6 pose covariance over (x, y, z, roll, pitch, yaw)
    (`pf.h:293-` / `mcl_3dl.cpp:597-618`)."""
    mean_pos, mean_quat = expectation(state)
    rpy = jnp.stack(rpy_from_quat(state.quat), axis=-1)
    mean_rpy = jnp.stack(rpy_from_quat(mean_quat), axis=-1)
    drpy = (rpy - mean_rpy[None, :] + jnp.pi) % (2.0 * jnp.pi) - jnp.pi
    d = jnp.concatenate([state.pos - mean_pos[None, :], drpy], axis=-1)
    w = state.prob / jnp.maximum(jnp.sum(state.prob), 1e-30)
    # HIGHEST: f32 products may otherwise run in TF32 on the GPU
    return jnp.matmul((d * w[:, None]).T, d,
                      precision=jax.lax.Precision.HIGHEST)


def resize_particles(state: PFState, m: int) -> PFState:
    """`ParticleFilter::resizeParticle` (`pf.h:387-430`): deterministic
    systematic resampling to ``m`` particles (pscan = pstep·i over the
    cumulative weights; no noise), used by the global-localization 0.75
    shrink schedule (`mcl_3dl.cpp:661-676`). ``m`` is a static shape."""
    n = state.prob.shape[0]
    accum = jnp.cumsum(state.prob)
    pstep = accum[-1] / m
    pscan = pstep * (jnp.arange(m, dtype=jnp.float32) + 1.0)
    idx = jnp.clip(jnp.searchsorted(accum, pscan, side="left"), 0, n - 1)
    return PFState(
        pos=state.pos[idx], quat=state.quat[idx],
        prob=jnp.full((m,), 1.0 / m, jnp.float32),
        odom_err_integ_lin=state.odom_err_integ_lin[idx],
        odom_err_integ_ang=state.odom_err_integ_ang[idx],
        noise_ll=state.noise_ll[idx], noise_la=state.noise_la[idx],
        noise_aa=state.noise_aa[idx], noise_al=state.noise_al[idx])


def seed_particles_at(positions, yaws) -> PFState:
    """Seed one particle per candidate (global-localization big-N spread:
    ground nodes × yaw grid — the JAX stand-in for the reference's
    resize+expand seeding)."""
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    n = positions.shape[0]
    quat = jax.vmap(quat_from_yaw)(jnp.asarray(yaws, jnp.float32))
    z3 = jnp.zeros((n, 3), jnp.float32)
    z1 = jnp.zeros((n,), jnp.float32)
    return PFState(
        pos=jnp.asarray(positions, jnp.float32), quat=quat,
        prob=jnp.full((n,), 1.0 / n, jnp.float32),
        odom_err_integ_lin=z3, odom_err_integ_ang=z3,
        noise_ll=z1, noise_la=z1, noise_aa=z1, noise_al=z1)
