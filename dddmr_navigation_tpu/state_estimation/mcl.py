"""MCL update tick — the JAX re-design of ``MCL3dlNode``
(`src/dddmr_mcl_3dl/src/mcl_3dl.cpp:143-680`).

The reference interleaves per-particle lambdas, mutexes, and TF plumbing
inside an odometry callback; here one jitted, static-shape function runs
the whole tick (predict → measure → bias → expectation → jump detect →
LPF map→odom → expansion reset → resample → noise refresh) and the host
shell only gates on motion (`update_min_d`/`update_min_a`) and feeds
odometry/feature arrays.

Global localization (particle-count overflow + 0.75 shrink,
`mcl_3dl.cpp:661-676`) changes array shapes, so it runs as a separate
pre-localization phase: `init_particles` with a large N, tick with
``global_mode=True`` (uniform bias, no jump gating), then re-init the
runtime filter at the converged expectation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.config import MCLConfig
from dddmr_navigation_tpu.geometry import (
    quat_multiply, quat_conjugate, quat_normalize, quat_rotate,
    quat_from_rpy, rpy_from_quat)
from dddmr_navigation_tpu.state_estimation import pf as pflib
from dddmr_navigation_tpu.state_estimation.likelihood import (
    SubmapContext, measure_all, measure_all_corr)


class Lpf3(NamedTuple):
    """Three independent time-domain LPFs (reference `filter.h:54-98`,
    FILTER_LPF with time constant ``lpf_step``). State is (x, out)."""
    x: jnp.ndarray    # (3,)
    out: jnp.ndarray  # (3,)


def _lpf_coeffs(tc: float):
    k3 = -1.0 / (1.0 + 2.0 * tc)
    k2 = -k3
    k1 = (1.0 - 2.0 * tc) * k3
    k0 = -k1 - 1.0
    return k0, k1, k2, k3


def lpf_set(tc: float, out0) -> Lpf3:
    k0, k1, k2, k3 = _lpf_coeffs(tc)
    out0 = jnp.asarray(out0, jnp.float32)
    return Lpf3(x=(1.0 - k2) * out0 / k3, out=out0)


def lpf_in(tc: float, f: Lpf3, v, angle: bool = False):
    k0, k1, k2, k3 = _lpf_coeffs(tc)
    v = jnp.asarray(v, jnp.float32)
    if angle:
        v = f.out + jnp.mod(v - f.out + jnp.pi, 2.0 * jnp.pi) - jnp.pi
    x = k0 * v + k1 * f.x
    out = k2 * v + k3 * x
    return Lpf3(x=x, out=out), out


class MCLState(NamedTuple):
    """Full localization state (device pytree)."""
    particles: pflib.PFState
    state_prev_pos: jnp.ndarray   # (3,) previous expectation
    state_prev_quat: jnp.ndarray  # (4,)
    f_pos: Lpf3                   # map→odom translation LPF
    f_ang: Lpf3                   # map→odom rpy LPF
    key: jnp.ndarray              # PRNG


class MCLOutput(NamedTuple):
    pose_pos: jnp.ndarray        # (3,) expectation (mcl_pose)
    pose_quat: jnp.ndarray       # (4,)
    map2odom_pos: jnp.ndarray    # (3,) LPF'd map→odom transform
    map2odom_quat: jnp.ndarray   # (4,)
    covariance: jnp.ndarray      # (6, 6)
    match_ratio_max: jnp.ndarray  # ()
    jumped: jnp.ndarray          # () bool
    expanded: jnp.ndarray        # () bool


def init_mcl(key, cfg: MCLConfig, init_pos, init_quat,
             num_particles: int | None = None) -> MCLState:
    key, sub = jax.random.split(jax.random.PRNGKey(key) if isinstance(key, int)
                                else key)
    particles = pflib.init_particles(sub, cfg, init_pos, init_quat,
                                     num_particles)
    init_pos = jnp.asarray(init_pos, jnp.float32)
    init_quat = jnp.asarray(init_quat, jnp.float32)
    rpy = jnp.stack(rpy_from_quat(init_quat))
    return MCLState(
        particles=particles,
        state_prev_pos=init_pos, state_prev_quat=init_quat,
        f_pos=lpf_set(cfg.lpf_step, init_pos),
        f_ang=lpf_set(cfg.lpf_step, rpy),
        key=key)


def relative_odom(odom_prev_pos, odom_prev_quat, odom_pos, odom_quat):
    """`MotionPredictionModelDifferentialDrive::setOdoms`
    (`motion_prediction_model_differential_drive.h:47-55`): relative
    translation in the previous odom frame + relative rotation/angle."""
    inv_prev = quat_conjugate(odom_prev_quat)
    rel_trans = quat_rotate(inv_prev, odom_pos - odom_prev_pos)
    rel_quat = quat_normalize(quat_multiply(inv_prev, odom_quat))
    rel_angle = 2.0 * jnp.arccos(jnp.clip(jnp.abs(rel_quat[3]), 0.0, 1.0))
    return rel_trans, rel_quat, rel_angle


def mcl_update(cfg: MCLConfig, ctx: SubmapContext, state: MCLState,
               odom_prev_pos, odom_prev_quat, odom_pos, odom_quat, dt,
               flat_pts, flat_mask, sharp_pts, sharp_mask, sharp_weight,
               global_mode: bool = False):
    """One full PF update (the body of `cbOdom` + `measure`,
    `mcl_3dl.cpp:196-231,466-680`). Pure; jit with
    ``static_argnums=(0, 15)`` or wrap in ``functools.partial``."""
    key, k_res, k_noise, k_exp = jax.random.split(state.key, 4)
    p = state.particles

    # --- predict (motion model) ------------------------------------------
    rel_trans, rel_quat, rel_angle = relative_odom(
        odom_prev_pos, odom_prev_quat, odom_pos, odom_quat)
    p = pflib.predict_diff_drive(p, rel_trans, rel_quat, rel_angle, dt, cfg)

    # --- measure ----------------------------------------------------------
    if getattr(cfg, "field_sampling", "trilinear") == "corr":
        # correspondence-cached scoring: owners looked up once at the
        # odometry-predicted pose (previous expectation ∘ relative odom),
        # particles score exact distances to the cached owners (see
        # likelihood.measure_all_corr for the error model)
        pose0_pos = state.state_prev_pos + quat_rotate(
            state.state_prev_quat, rel_trans)
        pose0_quat = quat_normalize(
            quat_multiply(state.state_prev_quat, rel_quat))
        like, ratio = measure_all_corr(
            ctx, cfg, flat_pts, flat_mask, sharp_pts, sharp_mask,
            sharp_weight, p.pos, p.quat, pose0_pos, pose0_quat)
    else:
        like, ratio = measure_all(ctx, cfg, flat_pts, flat_mask, sharp_pts,
                                  sharp_mask, sharp_weight, p.pos, p.quat)
    p = pflib.measure(p, like)
    match_ratio_max = jnp.max(ratio)

    # --- bias + biased expectation ---------------------------------------
    bias = pflib.bias_weights(p, state.state_prev_pos, state.state_prev_quat,
                              cfg, uniform=global_mode)
    e_pos, e_quat = pflib.expectation_biased(p, bias)

    # --- map→odom ----------------------------------------------------------
    # map_pos = e.pos − e.rot·odom.rot⁻¹·odom.pos ; map_rot = e.rot·odom.rot⁻¹
    # (`mcl_3dl.cpp:548-551`).
    inv_odom = quat_conjugate(odom_quat)
    map_rot = quat_normalize(quat_multiply(e_quat, inv_odom))
    map_pos = e_pos - quat_rotate(map_rot, odom_pos)

    # --- jump detection ----------------------------------------------------
    jump_dist = jnp.linalg.norm(e_pos - state.state_prev_pos)
    qrel = quat_multiply(quat_conjugate(e_quat), state.state_prev_quat)
    jump_ang = 2.0 * jnp.arccos(jnp.clip(jnp.abs(qrel[3]), 0.0, 1.0))
    jumped = (jump_dist > cfg.jump_dist) | (jump_ang > cfg.jump_ang)
    if global_mode:
        jumped = jnp.asarray(True)
    p = jax.tree_util.tree_map(
        lambda a, b: jnp.where(jumped, a, b),
        pflib.reset_err_integrals(p), p)

    # --- LPF map→odom (reset on jump, `mcl_3dl.cpp:585-590`) --------------
    rpy = jnp.stack(rpy_from_quat(map_rot))
    f_pos_set = lpf_set(cfg.lpf_step, map_pos)
    f_ang_set = lpf_set(cfg.lpf_step, rpy)
    f_pos = jax.tree_util.tree_map(
        lambda a, b: jnp.where(jumped, a, b), f_pos_set, state.f_pos)
    f_ang = jax.tree_util.tree_map(
        lambda a, b: jnp.where(jumped, a, b), f_ang_set, state.f_ang)
    f_ang, rpy_f = lpf_in(cfg.lpf_step, f_ang, rpy, angle=True)
    f_pos, pos_f = lpf_in(cfg.lpf_step, f_pos, map_pos)
    map_rot_f = quat_from_rpy(rpy_f[0], rpy_f[1], rpy_f[2])

    cov = pflib.covariance(p)

    # --- expansion resetting (`mcl_3dl.cpp:648-659`) -----------------------
    expanded = match_ratio_max < cfg.match_ratio_thresh
    sigma_exp = jnp.asarray([cfg.expansion_var_x, cfg.expansion_var_y,
                             cfg.expansion_var_z, cfg.expansion_var_roll,
                             cfg.expansion_var_pitch, cfg.expansion_var_yaw],
                            jnp.float32)
    p_exp = pflib.add_pose_noise(k_exp, p, sigma_exp)
    p = jax.tree_util.tree_map(
        lambda a, b: jnp.where(expanded, a, b), p_exp, p)

    # --- resample + odom-noise refresh (`mcl_3dl.cpp:212-231`) ------------
    p = pflib.resample(k_res, p, cfg)
    p = pflib.refresh_odom_noise(k_noise, p, cfg)

    new_state = MCLState(
        particles=p, state_prev_pos=e_pos, state_prev_quat=e_quat,
        f_pos=f_pos, f_ang=f_ang, key=key)
    out = MCLOutput(
        pose_pos=e_pos, pose_quat=e_quat,
        map2odom_pos=pos_f, map2odom_quat=map_rot_f,
        covariance=cov, match_ratio_max=match_ratio_max,
        jumped=jumped, expanded=expanded)
    return new_state, out


def motion_gate(cfg: MCLConfig, odom_prev_pos, odom_prev_quat,
                odom_pos, odom_quat):
    """Host-side update gate (`mcl_3dl.cpp:196`): update when translation
    exceeds ``update_min_d`` or rpy change exceeds ``update_min_a``."""
    d = jnp.linalg.norm(jnp.asarray(odom_pos) - jnp.asarray(odom_prev_pos))
    r0 = jnp.stack(rpy_from_quat(jnp.asarray(odom_prev_quat)))
    r1 = jnp.stack(rpy_from_quat(jnp.asarray(odom_quat)))
    a = jnp.linalg.norm(r1 - r0)
    return (d > cfg.update_min_d) | (a > cfg.update_min_a)
