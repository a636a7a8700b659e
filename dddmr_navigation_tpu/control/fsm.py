"""The p2p move-base decision FSM as a pure, jittable, vmappable step.

Re-designs `P2PMoveBase::executeCycle` + `P2P_FSM`
(`p2p_move_base.cpp:265-658`, `p2p_fsm.cpp:41-113`) from a string-keyed,
wall-clock mutating loop into integer states over a pytree, so a whole
fleet of robots steps its FSMs in one fused device op (`vmap`), and time
is an explicit input (sim or wall clock).

Decision states (names preserved):
  d_initial → d_planning → d_planning_waitdone → d_align_heading →
  d_controlling → d_align_goal_heading (+ d_waiting, d_recovery_waitdone,
  terminal d_succeed / d_abort).

Per-tick inputs are the *predicates* the reference computes in place
(plan arrival, heading alignment, PlannerState of the generator the
current state would run, recovery status); outputs are the command
selector and the host-facing requests (plan query, recovery trigger).
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.config import MoveBaseConfig
from dddmr_navigation_tpu.planning.local.planner import PlannerState
from dddmr_navigation_tpu.geometry import yaw_from_quat, normalize_angle


class Decision(enum.IntEnum):
    D_INITIAL = 0
    D_PLANNING = 1
    D_PLANNING_WAITDONE = 2
    D_ALIGN_HEADING = 3
    D_CONTROLLING = 4
    D_ALIGN_GOAL_HEADING = 5
    D_WAITING = 6
    D_RECOVERY_WAITDONE = 7
    D_SUCCEED = 8
    D_ABORT = 9


class CmdSource(enum.IntEnum):
    ZERO = 0       # publish zero velocity
    SIMPLE = 1     # differential_drive_simple command
    ROTATE = 2     # differential_drive_rotate_shortest_angle command


class FSMState(NamedTuple):
    decision: jnp.ndarray              # () int32
    last_valid_plan: jnp.ndarray       # () f32 seconds
    last_valid_control: jnp.ndarray    # () f32
    last_oscillation_reset: jnp.ndarray  # () f32
    oscillation_pos: jnp.ndarray       # (3,)
    oscillation_yaw: jnp.ndarray       # ()
    waiting_time: jnp.ndarray          # ()
    no_plan_recovery_count: jnp.ndarray  # () int32


class FSMInputs(NamedTuple):
    now: jnp.ndarray                 # () f32 seconds
    robot_pos: jnp.ndarray           # (3,)
    robot_yaw: jnp.ndarray           # ()
    has_new_plan: jnp.ndarray        # () bool — GPM delivered a plan
    plan_empty: jnp.ndarray          # () bool — delivered plan is empty
    goal_reached: jnp.ndarray        # () bool — isGoalReached
    initial_heading_aligned: jnp.ndarray  # () bool
    goal_heading_aligned: jnp.ndarray     # () bool
    ps_simple: jnp.ndarray           # () int32 PlannerState of simple gen
    ps_rotate: jnp.ndarray           # () int32 PlannerState of rotate gen
    recovery_active: jnp.ndarray     # () bool — a recovery is running
    recovery_succeed: jnp.ndarray    # () bool — last recovery result


class FSMOutputs(NamedTuple):
    cmd_source: jnp.ndarray          # () int32 CmdSource
    request_plan_query: jnp.ndarray  # () bool — trigger GPM queryThread
    request_recovery: jnp.ndarray    # () bool — start recovery behavior
    done: jnp.ndarray                # () bool terminal
    succeeded: jnp.ndarray           # () bool


def init_fsm_state(now=0.0) -> FSMState:
    t = jnp.asarray(now, jnp.float32)
    return FSMState(
        decision=jnp.asarray(Decision.D_INITIAL, jnp.int32),
        last_valid_plan=t, last_valid_control=t, last_oscillation_reset=t,
        oscillation_pos=jnp.zeros(3),
        oscillation_yaw=jnp.asarray(0.0, jnp.float32),
        waiting_time=t, no_plan_recovery_count=jnp.asarray(0, jnp.int32))


def fsm_step(cfg: MoveBaseConfig, s: FSMState, x: FSMInputs
             ) -> tuple[FSMState, FSMOutputs]:
    """One executeCycle. Pure function of (state, inputs)."""
    P = PlannerState
    D = Decision

    # --- oscillation reset (`p2p_move_base.cpp:267-273`) ---
    dist = jnp.linalg.norm(x.robot_pos - s.oscillation_pos)
    dyaw = jnp.abs(normalize_angle(x.robot_yaw - s.oscillation_yaw))
    osc_reset = (dist >= cfg.oscillation_distance) | (dyaw >= cfg.oscillation_angle)
    s = s._replace(
        oscillation_pos=jnp.where(osc_reset, x.robot_pos, s.oscillation_pos),
        oscillation_yaw=jnp.where(osc_reset, x.robot_yaw, s.oscillation_yaw),
        last_oscillation_reset=jnp.where(osc_reset, x.now,
                                         s.last_oscillation_reset))

    osc_timeout = (cfg.oscillation_patience > 0) & (
        x.now - s.last_oscillation_reset >= cfg.oscillation_patience)
    ctrl_timeout = x.now - s.last_valid_control > cfg.controller_patience
    plan_timeout = x.now - s.last_valid_plan > cfg.planner_patience

    d = s.decision

    # defaults
    nxt = d
    cmd = jnp.asarray(CmdSource.ZERO, jnp.int32)
    req_plan = jnp.asarray(False)
    req_recovery = jnp.asarray(False)
    done = jnp.asarray(False)
    succeeded = jnp.asarray(False)
    lvp = s.last_valid_plan
    lvc = s.last_valid_control
    wt = s.waiting_time
    rec_cnt = s.no_plan_recovery_count

    def sel(cond, a, b):
        return jnp.where(cond, a, b)

    # --- d_initial ---
    in_init = d == D.D_INITIAL
    nxt = sel(in_init, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)

    # --- d_planning: fire a query ---
    in_plan = d == D.D_PLANNING
    req_plan = req_plan | in_plan
    nxt = sel(in_plan, jnp.asarray(D.D_PLANNING_WAITDONE, jnp.int32), nxt)

    # --- d_planning_waitdone ---
    in_wait = d == D.D_PLANNING_WAITDONE
    got_plan = in_wait & x.has_new_plan & (~x.plan_empty)
    empty_plan = in_wait & x.has_new_plan & x.plan_empty
    nxt = sel(got_plan, jnp.asarray(D.D_ALIGN_HEADING, jnp.int32), nxt)
    lvp = sel(got_plan, x.now, lvp)
    nxt = sel(empty_plan, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    to_recovery_pt = in_wait & plan_timeout
    nxt = sel(to_recovery_pt, jnp.asarray(D.D_RECOVERY_WAITDONE, jnp.int32), nxt)
    req_recovery = req_recovery | to_recovery_pt

    # --- shared align-state machinery (`p2p_move_base.cpp:316-389,392-459`) ---
    def align_branch(in_state, aligned, next_on_aligned, stay_state,
                     nxt, cmd, req_recovery, lvp, lvc,
                     all_fail_goes_planning: bool):
        ps = x.ps_rotate
        aligned_now = in_state & aligned
        nxt = sel(aligned_now, next_on_aligned, nxt)
        active = in_state & (~aligned)
        # oscillation timeout first
        to_rec = active & osc_timeout
        nxt = sel(to_rec, jnp.asarray(D.D_RECOVERY_WAITDONE, jnp.int32), nxt)
        req_recovery = req_recovery | to_rec
        act = active & (~osc_timeout)

        found = act & (ps == P.TRAJECTORY_FOUND)
        cmd = sel(found, jnp.asarray(CmdSource.ROTATE, jnp.int32), cmd)
        lvc = sel(found, x.now, lvc)
        nxt = sel(found, stay_state, nxt)

        prune_fail = act & (ps == P.PRUNE_PLAN_FAIL)
        nxt = sel(prune_fail, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
        lvp = sel(prune_fail, x.now, lvp)

        if all_fail_goes_planning:
            fail_mask = act & (ps == P.ALL_TRAJECTORIES_FAIL)
        else:
            fail_mask = act & ((ps == P.ALL_TRAJECTORIES_FAIL)
                               | (ps == P.PATH_BLOCKED_WAIT)
                               | (ps == P.PATH_BLOCKED_REPLANNING))
        fail_to_rec = fail_mask & ctrl_timeout
        nxt = sel(fail_to_rec, jnp.asarray(D.D_RECOVERY_WAITDONE, jnp.int32), nxt)
        req_recovery = req_recovery | fail_to_rec
        fail_to_plan = fail_mask & (~ctrl_timeout)
        if all_fail_goes_planning:
            nxt = sel(fail_to_plan, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
            lvp = sel(fail_to_plan, x.now, lvp)
        else:
            nxt = sel(fail_to_plan, stay_state, nxt)

        if all_fail_goes_planning:
            blocked = act & ((ps == P.PATH_BLOCKED_WAIT)
                             | (ps == P.PATH_BLOCKED_REPLANNING))
            nxt = sel(blocked, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
            lvp = sel(blocked, x.now, lvp)
        return nxt, cmd, req_recovery, lvp, lvc

    in_align = d == D.D_ALIGN_HEADING
    nxt, cmd, req_recovery, lvp, lvc = align_branch(
        in_align, x.initial_heading_aligned,
        jnp.asarray(D.D_CONTROLLING, jnp.int32),
        jnp.asarray(D.D_ALIGN_HEADING, jnp.int32),
        nxt, cmd, req_recovery, lvp, lvc, all_fail_goes_planning=True)

    # --- d_align_goal_heading ---
    in_galign = d == D.D_ALIGN_GOAL_HEADING
    goal_done = in_galign & x.goal_heading_aligned
    done = done | goal_done
    succeeded = succeeded | goal_done
    nxt = sel(goal_done, jnp.asarray(D.D_SUCCEED, jnp.int32), nxt)
    nxt, cmd, req_recovery, lvp, lvc = align_branch(
        in_galign, x.goal_heading_aligned,
        jnp.asarray(D.D_SUCCEED, jnp.int32),
        jnp.asarray(D.D_ALIGN_GOAL_HEADING, jnp.int32),
        nxt, cmd, req_recovery, lvp, lvc, all_fail_goes_planning=False)

    # --- d_controlling (`p2p_move_base.cpp:459-549`) ---
    in_ctrl = d == D.D_CONTROLLING
    reach = in_ctrl & x.goal_reached
    nxt = sel(reach, jnp.asarray(D.D_ALIGN_GOAL_HEADING, jnp.int32), nxt)
    ctl = in_ctrl & (~reach)
    to_rec_osc = ctl & osc_timeout
    nxt = sel(to_rec_osc, jnp.asarray(D.D_RECOVERY_WAITDONE, jnp.int32), nxt)
    req_recovery = req_recovery | to_rec_osc
    act = ctl & (~osc_timeout)

    ps = x.ps_simple
    found = act & (ps == P.TRAJECTORY_FOUND)
    cmd = sel(found, jnp.asarray(CmdSource.SIMPLE, jnp.int32), cmd)
    lvc = sel(found, x.now, lvc)

    prune_fail = act & (ps == P.PRUNE_PLAN_FAIL)
    nxt = sel(prune_fail, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    lvp = sel(prune_fail, x.now, lvp)

    all_fail = act & (ps == P.ALL_TRAJECTORIES_FAIL)
    af_rec = all_fail & ctrl_timeout
    nxt = sel(af_rec, jnp.asarray(D.D_RECOVERY_WAITDONE, jnp.int32), nxt)
    req_recovery = req_recovery | af_rec
    af_plan = all_fail & (~ctrl_timeout)
    nxt = sel(af_plan, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    lvp = sel(af_plan, x.now, lvp)

    blocked_replan = act & (ps == P.PATH_BLOCKED_REPLANNING)
    nxt = sel(blocked_replan, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    lvp = sel(blocked_replan, x.now, lvp)

    blocked_wait = act & (ps == P.PATH_BLOCKED_WAIT)
    nxt = sel(blocked_wait, jnp.asarray(D.D_WAITING, jnp.int32), nxt)
    wt = sel(blocked_wait, x.now, wt)

    # --- d_recovery_waitdone (`p2p_move_base.cpp:551-583`) ---
    in_rec = (d == D.D_RECOVERY_WAITDONE) & (~x.recovery_active)
    over_retry = in_rec & (rec_cnt >= cfg.no_plan_retry_num)
    nxt = sel(over_retry, jnp.asarray(D.D_ABORT, jnp.int32), nxt)
    done = done | over_retry
    rec_ok = in_rec & (~over_retry) & x.recovery_succeed
    nxt = sel(rec_ok, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    rec_cnt = sel(rec_ok, rec_cnt + 1, rec_cnt)
    lvp = sel(rec_ok, x.now, lvp)
    rec_fail = in_rec & (~over_retry) & (~x.recovery_succeed)
    nxt = sel(rec_fail, jnp.asarray(D.D_ABORT, jnp.int32), nxt)
    done = done | rec_fail

    # --- d_waiting (`p2p_move_base.cpp:585-655`) ---
    in_waiting = d == D.D_WAITING
    wait_over = in_waiting & (x.now - wt >= cfg.waiting_patience)
    nxt = sel(wait_over, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    lvp = sel(wait_over, x.now, lvp)
    w_act = in_waiting & (~wait_over)
    ps = x.ps_simple
    w_found = w_act & (ps == P.TRAJECTORY_FOUND)
    nxt = sel(w_found, jnp.asarray(D.D_CONTROLLING, jnp.int32), nxt)
    lvc = sel(w_found, x.now, lvc)
    w_prune = w_act & (ps == P.PRUNE_PLAN_FAIL)
    nxt = sel(w_prune, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    lvp = sel(w_prune, x.now, lvp)
    w_fail = w_act & (ps == P.ALL_TRAJECTORIES_FAIL)
    wf_rec = w_fail & ctrl_timeout
    nxt = sel(wf_rec, jnp.asarray(D.D_RECOVERY_WAITDONE, jnp.int32), nxt)
    req_recovery = req_recovery | wf_rec
    wf_plan = w_fail & (~ctrl_timeout)
    nxt = sel(wf_plan, jnp.asarray(D.D_PLANNING, jnp.int32), nxt)
    lvp = sel(wf_plan, x.now, lvp)
    # PATH_BLOCKED_* in waiting: stay (default)

    # terminal states absorb
    terminal = (d == D.D_SUCCEED) | (d == D.D_ABORT)
    nxt = sel(terminal, d, nxt)
    done = done | terminal
    succeeded = succeeded | (d == D.D_SUCCEED)

    s2 = FSMState(
        decision=nxt, last_valid_plan=lvp, last_valid_control=lvc,
        last_oscillation_reset=s.last_oscillation_reset,
        oscillation_pos=s.oscillation_pos, oscillation_yaw=s.oscillation_yaw,
        waiting_time=wt, no_plan_recovery_count=rec_cnt)
    out = FSMOutputs(cmd_source=cmd, request_plan_query=req_plan,
                     request_recovery=req_recovery, done=done,
                     succeeded=succeeded)
    return s2, out
