"""Global planner: goal snapping, wavefront solve, path-to-poses.

Mirrors `GlobalPlanner::makeROSPlan` (`global_planner.cpp:512-544`) +
`getStartGoalID` (`:393-473`) + `getROSPath` (`:313-391`), and the
DWA look-ahead splicing of `dynamic_window_aware_global_planner.cpp`.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dddmr_navigation_tpu.config import GlobalPlannerConfig
from dddmr_navigation_tpu.geometry import slope_aware_quat
from dddmr_navigation_tpu.planning.global_.graph import GroundGraph
from dddmr_navigation_tpu.planning.global_.wavefront import (
    node_costs, wavefront_distances, extract_path,
    wavefront_distances_turning, extract_path_turning)


class GlobalPathResult(NamedTuple):
    node_ids: jnp.ndarray   # (max_path_len,) int32
    node_valid: jnp.ndarray # (max_path_len,) bool
    length: jnp.ndarray     # () int32
    ok: jnp.ndarray         # () bool
    dist_to_goal: jnp.ndarray  # (G,) the reusable distance field
    dist_carry: jnp.ndarray    # raw relaxation field — (G,) plain or
                               # (G, B) direction-expanded — for warm starts
    goal_idx: jnp.ndarray      # () int32 snapped goal node (warm-start key)
    iters: jnp.ndarray         # () int32 relaxation iterations run


def snap_to_ground(ground, ground_valid, pos, radius: float = 0.5):
    """Nearest ground node within ``radius`` (`getStartGoalID` semantics).
    Returns (index, ok)."""
    d = jnp.linalg.norm(ground - pos, axis=-1)
    d = jnp.where(ground_valid, d, jnp.inf)
    i = jnp.argmin(d)
    return i, d[i] <= radius


class PlanPrep(NamedTuple):
    """Per-robot pre-relaxation state: snap results, LOS-gated edge
    validity, node entry costs, and the goal-gated warm field — everything
    the relaxation consumes (`plan_prepare` → relax → `plan_finish`)."""
    start_idx: jnp.ndarray   # () int32
    goal_idx: jnp.ndarray    # () int32
    sg_ok: jnp.ndarray       # () bool — both snaps succeeded
    graph_valid: jnp.ndarray # (G, K) after the LOS gate
    enter: jnp.ndarray       # (G,) node entry costs (inf = lethal)
    warm_dist: object        # warm field or None


def plan_prepare(cfg: GlobalPlannerConfig, graph_idx, graph_dist, graph_valid,
                 ground, ground_valid, dgraph, node_weight,
                 start_pos, goal_pos, *, inscribed_radius: float,
                 inflation_descending_rate: float,
                 lethal_pts=None, lethal_valid=None,
                 warm_dist=None, warm_goal_idx=None) -> PlanPrep:
    """Snap start/goal, LOS-gate long edges, compute entry costs, and gate
    the warm field on goal identity — the per-robot work BEFORE the
    relaxation (which a fleet sharing one graph can then run jointly)."""
    from dddmr_navigation_tpu.planning.global_.los import long_edge_los_mask

    start_idx, s_ok = snap_to_ground(ground, ground_valid, start_pos)
    goal_idx, g_ok = snap_to_ground(ground, ground_valid, goal_pos)

    if warm_dist is not None:
        same_goal = (goal_idx == warm_goal_idx) if warm_goal_idx is not None \
            else jnp.asarray(True)
        warm_dist = jnp.where(same_goal, warm_dist, jnp.inf)

    if lethal_pts is not None and cfg.max_long_edges > 0:
        los = long_edge_los_mask(
            graph_idx, graph_dist, graph_valid, ground, lethal_pts,
            lethal_valid, inscribed_radius=inscribed_radius,
            max_long_edges=cfg.max_long_edges, samples=cfg.los_samples)
        graph_valid = graph_valid & los

    enter = node_costs(dgraph, node_weight,
                       inscribed_radius=inscribed_radius,
                       inflation_descending_rate=inflation_descending_rate)
    return PlanPrep(start_idx=start_idx, goal_idx=goal_idx, sg_ok=s_ok & g_ok,
                    graph_valid=graph_valid, enter=enter, warm_dist=warm_dist)


def plan_finish(cfg: GlobalPlannerConfig, graph_idx, graph_dist, ground,
                prep: PlanPrep, dist_relaxed, iters, *,
                turn_pen=None, wf_bins=None,
                stall_reset=None) -> GlobalPathResult:
    """Extraction + result assembly AFTER the relaxation. ``dist_relaxed``
    is (G, B) (turning) or (G,) (plain). ``stall_reset`` overrides the
    carry-reset condition for budgeted relaxation
    (`control.fused.budget_stall_update`)."""
    if cfg.turning_weight > 0.0:
        ids, valid, length, p_ok = extract_path_turning(
            graph_idx, graph_dist, prep.graph_valid, prep.enter,
            dist_relaxed, wf_bins, prep.start_idx, prep.goal_idx, ground,
            cfg.turning_weight, max_len=cfg.max_path_len, turn_pen=turn_pen)
        dist_to_goal = jnp.min(dist_relaxed, axis=1)
    else:
        ids, valid, length, p_ok = extract_path(
            graph_idx, graph_dist, prep.graph_valid, prep.enter,
            dist_relaxed, prep.start_idx, prep.goal_idx,
            max_len=cfg.max_path_len, turning_weight=0.0, positions=ground)
        dist_to_goal = dist_relaxed
    ok = prep.sg_ok & p_ok
    # A relaxation that hit max_iters did NOT converge — typically a
    # region became unreachable and its stale finite values can only
    # creep upward, which would pin EVERY subsequent warm tick at
    # max_iters (review finding, reproduced on a cut-off pocket). Reset
    # the carry to the inf-init in that case: the next tick pays one
    # bounded cold solve (which settles unreachable nodes at inf) and
    # warm ticks resume after.
    if stall_reset is None:
        stall_reset = iters >= cfg.max_relax_iters
    dist_carry = jnp.where(stall_reset, jnp.inf, dist_relaxed)
    return GlobalPathResult(node_ids=ids, node_valid=valid & ok,
                            length=jnp.where(ok, length, 0), ok=ok,
                            dist_to_goal=dist_to_goal, dist_carry=dist_carry,
                            goal_idx=prep.goal_idx, iters=iters)


def fleet_plan_finish(cfg: GlobalPlannerConfig, graph_idx, graph_dist,
                      ground, prep_r: PlanPrep, dist_r, iters, *,
                      turn_pen=None, wf_bins=None,
                      stall_reset=None) -> GlobalPathResult:
    """Batched `plan_finish` for a fleet sharing one graph: extraction
    runs NODE-MAJOR (`fleet_extract_path[_turning]`) so the successor
    tables ride shared-index gathers — a vmap of the per-robot extractor
    pays batched middle-axis gathers instead, which dominated the
    64-robot tick before the port to the H100 (not re-measured there).
    ``prep_r`` carries a leading robot axis;
    ``dist_r`` is (R, G, B) or (R, G). Returns a robot-batched
    GlobalPathResult."""
    from dddmr_navigation_tpu.planning.global_.wavefront import (
        fleet_extract_path, fleet_extract_path_turning)

    if cfg.turning_weight > 0.0:
        ids, valid, length, p_ok = fleet_extract_path_turning(
            graph_idx, graph_dist, prep_r.graph_valid, prep_r.enter,
            dist_r, wf_bins, prep_r.start_idx, prep_r.goal_idx, turn_pen,
            max_len=cfg.max_path_len)
        dist_to_goal = jnp.min(dist_r, axis=2)
    else:
        ids, valid, length, p_ok = fleet_extract_path(
            graph_idx, graph_dist, prep_r.graph_valid, prep_r.enter,
            dist_r, prep_r.start_idx, prep_r.goal_idx,
            max_len=cfg.max_path_len)
        dist_to_goal = dist_r
    ok = prep_r.sg_ok & p_ok
    if stall_reset is None:
        stall_reset = jnp.broadcast_to(iters >= cfg.max_relax_iters,
                                       ok.shape)
    expand = (slice(None),) + (None,) * (dist_r.ndim - 1)
    dist_carry = jnp.where(stall_reset[expand], jnp.inf, dist_r)
    return GlobalPathResult(node_ids=ids, node_valid=valid & ok[:, None],
                            length=jnp.where(ok, length, 0), ok=ok,
                            dist_to_goal=dist_to_goal, dist_carry=dist_carry,
                            goal_idx=prep_r.goal_idx,
                            iters=jnp.broadcast_to(iters, ok.shape))


def plan_on_graph(cfg: GlobalPlannerConfig, graph_idx, graph_dist, graph_valid,
                  ground, ground_valid, dgraph, node_weight, avg_intensity,
                  start_pos, goal_pos, *, inscribed_radius: float,
                  inflation_descending_rate: float,
                  lethal_pts=None, lethal_valid=None,
                  warm_dist=None, warm_goal_idx=None,
                  turn_pen=None, wf_az=None,
                  wf_bins=None) -> GlobalPathResult:
    """Full jittable plan: snap → relax → extract. Reusable distance field
    comes back for DWA look-ahead replanning.

    When a lethal cloud is given, long edges (≥ 2×inscribed — the kNN
    orphan-fallback jumps) are line-of-sight verified against it first
    (`a_star_on_pc.cpp:168-198` semantics), so sparse-graph shortcuts
    cannot tunnel through thin lethal walls. ``cfg.max_long_edges == 0``
    skips the LOS stage entirely — correct whenever the built graph has
    no long edges (dense regular grounds; check
    ``(nbr_valid & (nbr_dist >= 2*inscribed)).sum()`` at build time).

    Warm start: pass the previous tick's ``result.dist_carry`` /
    ``result.goal_idx`` as ``warm_dist`` / ``warm_goal_idx``; the
    relaxation then re-converges from the old field (O(change) iterations
    instead of O(path-diameter) — see `wavefront_distances`). The warm
    field is discarded automatically when the snapped goal node changed.

    Internally `plan_prepare` → relax → `plan_finish`; fleets sharing one
    graph call the pieces with a joint node-major relaxation instead
    (`parallel/fleet.py`)."""
    prep = plan_prepare(
        cfg, graph_idx, graph_dist, graph_valid, ground, ground_valid,
        dgraph, node_weight, start_pos, goal_pos,
        inscribed_radius=inscribed_radius,
        inflation_descending_rate=inflation_descending_rate,
        lethal_pts=lethal_pts, lethal_valid=lethal_valid,
        warm_dist=warm_dist, warm_goal_idx=warm_goal_idx)
    if cfg.turning_weight > 0.0:
        # direction-expanded relaxation carries θ·w_turn exactly
        dist_gb, edge_bins, iters = wavefront_distances_turning(
            graph_idx, graph_dist, prep.graph_valid, prep.enter,
            avg_intensity, prep.goal_idx, ground, cfg.turning_weight,
            n_dir_bins=cfg.turning_dir_bins, max_iters=cfg.max_relax_iters,
            dist0=prep.warm_dist, az=wf_az, bin_of_edge=wf_bins)
        return plan_finish(cfg, graph_idx, graph_dist, ground, prep,
                           dist_gb, iters, turn_pen=turn_pen,
                           wf_bins=edge_bins)
    wf = wavefront_distances(graph_idx, graph_dist, prep.graph_valid,
                             prep.enter, avg_intensity, prep.goal_idx,
                             max_iters=cfg.max_relax_iters,
                             dist0=prep.warm_dist)
    return plan_finish(cfg, graph_idx, graph_dist, ground, prep,
                       wf.dist, wf.iters)


def path_to_poses(cfg: GlobalPlannerConfig, ground: np.ndarray,
                  result: GlobalPathResult):
    """`getROSPath` (`global_planner.cpp:313-391`): node path → pose list
    with slope-aware orientations and per-segment interpolation at 0.05
    fractional steps emitted every ≥0.1 m. Host-side (replan-rate work).

    Returns (positions (M,3) f32, quats (M,4) f32).
    """
    ids = np.asarray(result.node_ids)[np.asarray(result.node_valid)]
    ground = np.asarray(ground, np.float32)
    if len(ids) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32)
    pts = ground[ids]
    positions, quats = [], []
    # float32 throughout (incl. the step constants) so the device version
    # (`control/fused.py:interpolate_path_device`) is emission-for-emission
    # identical; the reference's f64 loop differs only at exact-0.1
    # boundaries (a ≤1.25 cm pose shift).
    steps = np.arange(0.05, 0.99, 0.05, dtype=np.float32)
    for i in range(len(pts)):
        p = pts[i]
        nxt = pts[i + 1] if i < len(pts) - 1 else pts[i]
        v = nxt - p
        q = np.asarray(slope_aware_quat(jnp.asarray(v[None], jnp.float32)))[0]
        if i < len(pts) - 1:
            positions.append(p)
            quats.append(q)
            last = p
            for step in steps:
                cand = p + v * step
                if np.linalg.norm(cand - last) > np.float32(0.1):
                    positions.append(cand)
                    quats.append(q)
                    last = cand
        else:
            positions.append(p)
            quats.append(q)
    return (np.asarray(positions, np.float32), np.asarray(quats, np.float32))


def post_smooth_path(ground: np.ndarray, map_pts: np.ndarray, path_ids,
                     inscribed_radius: float = 0.5):
    """`GlobalPlanner::postSmoothPath` (`global_planner.cpp:233-311`):
    greedy line-of-sight shortcutting over the node path. A node is kept
    when any 5%-step interpolated sample along the anchor→node segment
    (a) has >1 map point within inscribed_radius (obstacle in the way),
    (b) has <2 ground points within 1.0 m (segment leaves the ground),
    (c) jumps vertically (planar reach >0.5 m with slope angle >0.349 rad),
    or (d) exceeds 20 m planar reach; otherwise the node is skipped.
    Host-side (plan post-processing, replan-rate work, like the reference's
    unused-but-shipped implementation).

    Returns the smoothed node-id list (first and last always kept).
    """
    ids = [int(i) for i in np.asarray(path_ids).ravel()]
    if len(ids) <= 2:
        return list(ids)
    ground = np.asarray(ground, np.float32)
    map_pts = np.asarray(map_pts, np.float32).reshape(-1, 3)
    out = [ids[0]]
    anchor = ground[ids[0]]
    steps = np.arange(0.05, 0.99, 0.05, dtype=np.float32)
    for nid in ids[1:-1]:
        nxt = ground[nid]
        v = nxt - anchor
        cand = anchor[None, :] + steps[:, None] * v[None, :]   # (T,3)
        keep = False
        # (a) obstacle: strictly more than one map point in radius
        if len(map_pts):
            d2 = np.sum((cand[:, None, :] - map_pts[None, :, :]) ** 2, -1)
            hits = np.sum(d2 <= inscribed_radius ** 2, axis=1)
            keep |= bool(np.any(hits > 1))
        # (b) off-ground: fewer than 2 ground points within 1 m
        d2g = np.sum((cand[:, None, :] - ground[None, :, :]) ** 2, -1)
        near_g = np.sum(d2g <= 1.0, axis=1)
        keep |= bool(np.any(near_g < 2))
        # (c) z jump / (d) overlong reach. Reference quirk preserved
        # (`global_planner.cpp:294`): asin(dz/dxy) is computed UNclamped,
        # so dz > dxy yields NaN and `NaN > 0.349` is false — such segments
        # do NOT trigger the keep. We reproduce that by gating on
        # dz <= dxy instead of clamping.
        dxy = steps * np.hypot(v[0], v[1])
        dz = steps * abs(v[2])
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = dz / np.maximum(dxy, 1e-9)
            ang = np.where(ratio <= 1.0, np.arcsin(np.minimum(ratio, 1.0)),
                           np.nan)
        keep |= bool(np.any((dxy > 0.5) & (ang > 0.349)))
        keep |= bool(np.any(dxy > 20.0))
        if keep:
            out.append(nid)
            anchor = nxt
    out.append(ids[-1])
    return out
