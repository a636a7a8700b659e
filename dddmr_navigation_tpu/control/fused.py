"""The fused perception→replan→rollout vertical as ONE device program.

`NavigationSession` drives the reference's full loop with host glue:
mark/clear (`perception_3d_ros.cpp:220-249`), min-composed dGraph
(`stacked_perception.cpp:114-126`), lethal aggregation (`:142-155`),
global replan (`a_star_on_pc.cpp:200-329` + `global_planner.cpp:313-391`),
prune + rollouts + critics (`local_planner.cpp:482-621`). Here the SAME
chain is one jitted function where each stage consumes the previous
stage's *output* — the plan fed to the critics comes from this tick's own
wavefront extraction over this tick's own mark/clear distance field:

    scan ─ mark/clear ─→ dGraph ─ min-compose ─→ composed field
        ├─ lethal cloud ─→ long-edge LOS gate ─┐
        └────────────────→ wavefront relax ────┴→ path extract
        → device pose interpolation (getROSPath) → prune → rollouts
        → critics (vs this scan's own observation) → argmin → cmd_vel

No host↔device transfer between stages; a closed-loop chain of ticks is
one `lax.scan` dispatch. Parity with the host-glued path is asserted by
`tests/test_fused_vertical.py`.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dddmr_navigation_tpu.config import NavigationConfig
from dddmr_navigation_tpu.geometry import quat_rotate, slope_aware_quat
from dddmr_navigation_tpu.perception.voxel import VoxelSpec
from dddmr_navigation_tpu.perception.fov import RangeImageSpec
from dddmr_navigation_tpu.perception.static_map import (
    MapContext, build_map_context)
from dddmr_navigation_tpu.perception.marking import (
    MarkingParams, MarkingState, init_marking_state, perception_update)
from dddmr_navigation_tpu.perception.layers import min_dgraph
from dddmr_navigation_tpu.planning.global_.graph import build_ground_graph
from dddmr_navigation_tpu.planning.global_.los import lethal_cloud_from_dgraph
from dddmr_navigation_tpu.planning.global_.planner import GlobalPathResult
from dddmr_navigation_tpu.planning.local.planner import (
    GlobalPlan, VelocityCommand, compute_velocity_command)


class FusedMap(NamedTuple):
    """Static per-map device data for the fused vertical (one pytree so it
    rides dispatches as arguments, not as jit closure constants)."""
    map_ctx: MapContext
    ground: jnp.ndarray         # (G, 3)
    ground_valid: jnp.ndarray   # (G,)
    nbr_idx: jnp.ndarray        # (G, K)
    nbr_dist: jnp.ndarray       # (G, K)
    nbr_valid: jnp.ndarray      # (G, K)
    avg_intensity: jnp.ndarray  # (G,)
    node_weight: jnp.ndarray    # (G,)
    static_dgraph: jnp.ndarray  # (G,) static-layer field (overhang lethals)
    los_relevant: jnp.ndarray   # (G,) nodes near a long edge (LOS gating)
    # zone layers (None when no zones configured): the precomputed
    # no-entry distance field (`no_entry_layer.cpp:225-290`) and the
    # padded speed-zone cloud (`speed_limit_layer.cpp:222-300`)
    no_entry_field: object      # (G,) f32 or None
    speed_zone_pts: object      # (Z, 3) f32 or None
    speed_zone_valid: object    # (Z,) bool or None
    speed_zone_speed: object    # (Z,) f32 or None
    # static turning-planner geometry (None when turning_weight == 0):
    # per-edge azimuths/bins for the relaxation and the (G,K,K) exact-θ
    # penalty table for extraction — map properties, computed once
    wf_az: object
    wf_bins: object
    turn_pen: object


class FusedState(NamedTuple):
    marking: MarkingState
    # Warm-start carry for the wavefront: previous tick's relaxation field
    # ((G,) plain or (G, B) direction-expanded) + the goal node it was
    # relaxed toward. plan_on_graph discards the field when the goal node
    # changes, so a fresh goal pays one cold solve and subsequent ticks
    # re-converge in O(field-change) iterations.
    wf_dist: jnp.ndarray
    wf_goal_idx: jnp.ndarray
    # Depth-camera layer (None unless the tick was built with cameras):
    # its own marking grid/dGraph + the N-deep per-camera frustum ring.
    depth_marking: object
    depth_buffer: object
    # Budgeted-relaxation stall counter (relax_iters_per_tick > 0):
    # consecutive ticks the relax exited at its per-tick budget without
    # converging; reaching the cold bound resets the carry (the
    # unreachable-pocket safety the one-shot path gets from max_relax_iters).
    wf_stall: object = 0


class FusedOut(NamedTuple):
    vx: jnp.ndarray
    wz: jnp.ndarray
    state: jnp.ndarray          # PlannerState code
    best_index: jnp.ndarray     # chosen rollout sample
    best_cost: jnp.ndarray
    plan: GlobalPlan            # this tick's interpolated global plan
    plan_ok: jnp.ndarray        # global planner succeeded
    composed_dgraph: jnp.ndarray
    obs: jnp.ndarray            # (k, 3) this tick's aggregated observation
    obs_mask: jnp.ndarray       # (k,)
    wf_iters: jnp.ndarray       # () int32 wavefront iterations this tick


def build_fused_map(cfg: NavigationConfig, ground: np.ndarray,
                    map_pts: Optional[np.ndarray] = None,
                    node_weight: Optional[np.ndarray] = None,
                    static_dgraph: Optional[np.ndarray] = None,
                    intensity: Optional[np.ndarray] = None,
                    no_entry_zones: Optional[np.ndarray] = None,
                    speed_zones: Optional[tuple] = None) -> FusedMap:
    """Precompute the kNN ground graph + map context (same parameters as
    `GlobalPlannerRuntime`, `global_planner.cpp:156-176` sync)."""
    ground = np.asarray(ground, np.float32)
    g = len(ground)
    graph = build_ground_graph(
        ground, radius=cfg.global_planner.a_star_expanding_radius,
        k_max=cfg.perception.static_layer.max_ground_neighbors,
        intensity=intensity)
    nw = (np.zeros(g, np.float32) if node_weight is None
          else np.asarray(node_weight, np.float32))
    sd = (np.full((g,), cfg.perception.max_obstacle_distance, np.float32)
          if static_dgraph is None else np.asarray(static_dgraph, np.float32))
    los_rel = _los_relevant_mask(
        ground, graph, inscribed_radius=cfg.perception.inscribed_radius)
    ne_field = szp = szv = szs = None
    if no_entry_zones is not None:
        from dddmr_navigation_tpu.perception.layers import no_entry_dgraph
        zp = jnp.asarray(np.asarray(no_entry_zones, np.float32))
        ne_field = no_entry_dgraph(
            jnp.asarray(ground), jnp.ones((g,), bool), zp,
            jnp.ones((len(no_entry_zones),), bool),
            inflation_distance=cfg.perception.inflation_radius,
            max_obstacle_distance=cfg.perception.max_obstacle_distance)
    if speed_zones is not None:
        zpts, zspeed = speed_zones
        szp = jnp.asarray(np.asarray(zpts, np.float32))
        szv = jnp.ones((len(zpts),), bool)
        szs = jnp.asarray(np.asarray(zspeed, np.float32))
    gp = cfg.global_planner
    if gp.turning_weight > 0.0:
        from dddmr_navigation_tpu.planning.global_.wavefront import (
            edge_azimuth, turning_penalty_table)
        az = edge_azimuth(jnp.asarray(ground), jnp.asarray(graph.nbr_idx))
        b = gp.turning_dir_bins
        bins = jnp.mod(jnp.floor(
            (az + jnp.pi) / (2.0 * jnp.pi) * b).astype(jnp.int32), b)
        tpen = turning_penalty_table(jnp.asarray(graph.nbr_idx),
                                     jnp.asarray(ground), gp.turning_weight)
    else:
        az = bins = tpen = None
    return FusedMap(
        map_ctx=build_map_context(ground, map_pts, node_weight=node_weight),
        ground=jnp.asarray(ground),
        ground_valid=jnp.ones((g,), bool),
        nbr_idx=jnp.asarray(graph.nbr_idx),
        nbr_dist=jnp.asarray(graph.nbr_dist),
        nbr_valid=jnp.asarray(graph.nbr_valid),
        avg_intensity=jnp.asarray(graph.avg_intensity),
        node_weight=jnp.asarray(nw),
        static_dgraph=jnp.asarray(sd),
        los_relevant=jnp.asarray(los_rel),
        no_entry_field=ne_field, speed_zone_pts=szp,
        speed_zone_valid=szv, speed_zone_speed=szs,
        wf_az=az, wf_bins=bins, turn_pen=tpen,
    )


def _los_relevant_mask(ground: np.ndarray, graph,
                       inscribed_radius: float) -> np.ndarray:
    """(G,) bool: nodes within LOS reach (2×inscribed + slack) of at least
    one LONG edge segment. The LOS stage (`a_star_on_pc.cpp:168-198`)
    radius-searches the lethal cloud with 2×inscribed around samples on
    long edges ONLY, so lethal nodes far from every long edge can never
    influence a verdict — restricting the device-side lethal extraction to
    this static mask keeps the lethal budget small on real maps where the
    *static* lethal set alone (overhangs) runs to thousands of nodes.
    Host-side, build-time (the long-edge set is a graph property)."""
    long_e = graph.nbr_valid & (graph.nbr_dist >= 2.0 * inscribed_radius)
    if not long_e.any():
        return np.zeros(len(ground), bool)
    src, kk = np.nonzero(long_e)
    dst = graph.nbr_idx[src, kk]
    p0 = ground[src]                                     # (E, 3)
    p1 = ground[dst]
    reach = 2.0 * inscribed_radius + 0.1
    rel = np.zeros(len(ground), bool)
    # chunked point-to-segment distance (E can reach thousands)
    for s in range(0, len(p0), 256):
        a = p0[s:s + 256]                                # (e, 3)
        d = p1[s:s + 256] - a
        L2 = np.maximum(np.sum(d * d, axis=1), 1e-12)
        w = ground[:, None, :] - a[None, :, :]           # (G, e, 3)
        t = np.clip(np.einsum("gej,ej->ge", w, d) / L2[None, :], 0.0, 1.0)
        closest = a[None, :, :] + t[..., None] * d[None, :, :]
        dist2 = np.sum((ground[:, None, :] - closest) ** 2, axis=-1)
        rel |= (dist2 <= reach * reach).any(axis=1)
    return rel


def init_fused_state(cfg: NavigationConfig, num_ground_nodes: int,
                     robot_xyz=None, depth_cameras: int = 0,
                     depth_buffer_depth: int = 3,
                     depth_max_points: int = 512) -> FusedState:
    p = cfg.perception
    params = MarkingParams.from_config(p)
    spec = VoxelSpec(
        nx=p.voxel_window_cells_xy, ny=p.voxel_window_cells_xy,
        nz=p.voxel_window_cells_z, xy_resolution=p.lidar.xy_resolution,
        height_resolution=p.lidar.height_resolution)
    gp = cfg.global_planner
    wf_shape = ((num_ground_nodes, gp.turning_dir_bins)
                if gp.turning_weight > 0.0 else (num_ground_nodes,))
    depth_marking = depth_buffer = None
    if depth_cameras > 0:
        from dddmr_navigation_tpu.perception.depth_camera import (
            init_depth_buffer)
        depth_marking = init_marking_state(spec, params, num_ground_nodes,
                                           robot_xyz)
        depth_buffer = init_depth_buffer(depth_cameras, depth_buffer_depth,
                                         depth_max_points)
    return FusedState(
        marking=init_marking_state(spec, params, num_ground_nodes, robot_xyz),
        wf_dist=jnp.full(wf_shape, jnp.inf, jnp.float32),
        wf_goal_idx=jnp.asarray(-1, jnp.int32),
        depth_marking=depth_marking, depth_buffer=depth_buffer,
        wf_stall=jnp.asarray(0, jnp.int32))


def device_observation(scan_pts, scan_mask, k: int, leaf: float = 0.1):
    """Aggregated observation ON DEVICE: one representative point per
    occupied ``leaf`` voxel of the valid scan, padded to ``k``.

    The reference voxel-downsamples the transformed scan in cbSensor
    (`multilayer_spinning_lidar.cpp:264-269`); the host session uses a
    centroid filter (`io/maps.py:voxel_downsample`). Here the voxel's
    representative is its first scan point (deterministic lexicographic
    dedup) — centroids would need a segmented mean; the ≤leaf/2 shift is
    below the critics' resolution.
    """
    n = scan_pts.shape[0]
    cells = jnp.floor(scan_pts / leaf).astype(jnp.int32)
    sentinel = jnp.int32(2**30)
    cells = jnp.where(scan_mask[:, None], cells, sentinel)
    order = jnp.lexsort((jnp.arange(n), cells[:, 2], cells[:, 1],
                         cells[:, 0]))
    sc = cells[order]
    first = jnp.concatenate([
        jnp.ones((1,), bool), jnp.any(sc[1:] != sc[:-1], axis=1)])
    first = first & (sc[:, 0] != sentinel)
    idx = jnp.nonzero(first, size=k, fill_value=-1)[0]
    ok = idx >= 0
    pts = scan_pts[order][jnp.maximum(idx, 0)]
    return jnp.where(ok[:, None], pts, 0.0), ok


def interpolate_path_device(ground, res: GlobalPathResult, *,
                            max_plan_len: int, interp_steps: int = 19,
                            step: float = 0.05, min_emit: float = 0.1
                            ) -> GlobalPlan:
    """`getROSPath` (`global_planner.cpp:313-391`) on device: node path →
    poses with slope-aware quats; per segment, interpolated candidates at
    ``step`` fractions are emitted whenever they moved > ``min_emit`` from
    the last emitted pose. Matches `planner.path_to_poses` (the host
    version) emission-for-emission; the sequential per-segment emission
    test is a `lax.scan` over the (static) 19 steps, vectorized over path
    slots, and the ragged result is compacted with a cumsum scatter.
    """
    L = res.node_ids.shape[0]
    valid = res.node_valid
    n = res.length
    ids = jnp.maximum(res.node_ids, 0)
    pts = ground[ids]                                      # (L, 3)
    slots = jnp.arange(L)
    has_next = valid & (slots < n - 1)
    nxt = jnp.where(has_next[:, None],
                    ground[ids[jnp.minimum(slots + 1, L - 1)]], pts)
    v = nxt - pts                                          # (L, 3)
    quats = slope_aware_quat(v)                            # (L, 4)

    # emission flags for the interpolated candidates (host loop semantics:
    # last starts at the node; emit when ||cand-last|| > min_emit). The
    # step constants are the SAME f32 values as the host loop's so the
    # emission pattern matches bit-for-bit.
    steps = jnp.asarray(np.arange(step, 0.99, step, dtype=np.float32)
                        [:interp_steps])

    def body(last, s):
        cand = pts + v * s
        emit = jnp.linalg.norm(cand - last, axis=-1) > jnp.float32(min_emit)
        new_last = jnp.where(emit[:, None], cand, last)
        return new_last, (emit, cand)

    _, (emits, cands) = jax.lax.scan(body, pts, steps)
    emits = jnp.moveaxis(emits, 0, 1)                      # (L, S)
    cands = jnp.moveaxis(cands, 0, 1)                      # (L, S, 3)

    E = interp_steps + 1
    emit_all = jnp.concatenate(
        [valid[:, None], emits & has_next[:, None]], axis=1)     # (L, E)
    pos_all = jnp.concatenate([pts[:, None, :], cands], axis=1)  # (L, E, 3)
    quat_all = jnp.broadcast_to(quats[:, None, :], (L, E, 4))

    flat_emit = emit_all.reshape(-1)
    out_idx = jnp.cumsum(flat_emit) - 1
    count = jnp.minimum(jnp.sum(flat_emit), max_plan_len).astype(jnp.int32)
    tgt = jnp.where(flat_emit & (out_idx < max_plan_len), out_idx,
                    max_plan_len)
    pos_buf = jnp.zeros((max_plan_len, 3), jnp.float32).at[tgt].set(
        pos_all.reshape(-1, 3), mode="drop")
    quat_buf = jnp.zeros((max_plan_len, 4), jnp.float32).at[tgt].set(
        quat_all.reshape(-1, 4), mode="drop")
    plan_valid = (jnp.arange(max_plan_len) < count) & res.ok
    count = jnp.where(res.ok, count, 0)
    return GlobalPlan(pos_buf, quat_buf, plan_valid, count)


class FusedPrePlan(NamedTuple):
    """Everything `fused_pre_plan` hands to the relaxation + post stage."""
    marking: MarkingState
    depth_marking: object
    depth_buffer: object
    depth_latest: object
    composed: jnp.ndarray
    allowed_max_speed: jnp.ndarray
    scan_global: jnp.ndarray
    prep: object               # planning.global_.planner.PlanPrep


def fused_pre_plan(nav_cfg: NavigationConfig, spec: VoxelSpec,
                   ri_spec: RangeImageSpec, params: MarkingParams,
                   fmap: FusedMap, state: FusedState,
                   scan_sensor, scan_mask, robot_pos, robot_quat,
                   sensor_offset, goal_pos,
                   allowed_max_speed=-1.0, depth_cam=None,
                   depth_frames=None, now=0.0,
                   depth_keep_time: float = 0.5, no_entry_enabled=True
                   ) -> FusedPrePlan:
    """Stages 1–2 of the fused vertical (mark/clear, depth layer, stacked
    composition, zone layers, lethal aggregation) plus the global
    planner's pre-relaxation work (snap/LOS/entry costs/warm gate) — the
    per-robot half of the tick BEFORE the wavefront relaxation, split out
    so a fleet can relax jointly (`parallel/fleet.py`)."""
    p = nav_cfg.perception
    sensor_pos = robot_pos + quat_rotate(robot_quat, sensor_offset)
    scan_global = quat_rotate(robot_quat[None, :], scan_sensor) \
        + sensor_pos[None, :]

    # 1. mark/clear → dynamic-layer dGraph
    marking = perception_update(
        spec, ri_spec, params, state.marking, fmap.map_ctx, scan_global,
        scan_mask, robot_pos, robot_quat, sensor_pos, robot_quat)

    # 1b. depth-camera layer (its own grid/dGraph, like every reference
    # plugin), fused into the same program. The layer tick runs EVERY
    # tick a camera is attached — new frames push first when given, but
    # a frame-less tick still clears/marks against the buffered live
    # frustums and still composes (the reference's sensorsUpdateLoop
    # ticks every plugin at 10 Hz regardless of per-sensor arrival;
    # review finding: gating composition on this-tick frames made
    # depth-only obstacles vanish from planning between frames).
    depth_marking, depth_buffer = state.depth_marking, state.depth_buffer
    depth_latest = None
    if depth_marking is not None:
        from dddmr_navigation_tpu.perception.depth_camera import (
            push_observation, depth_layer_update)
        if depth_frames is not None:
            cam_pos, cam_quat, dpts, dmask = depth_frames
            for c in range(cam_pos.shape[0]):
                depth_buffer = push_observation(
                    depth_buffer, c, cam_pos[c], cam_quat[c], dpts[c],
                    dmask[c], jnp.asarray(now, jnp.float32))
        depth_marking, depth_latest = depth_layer_update(
            spec, params, depth_cam, depth_marking, depth_buffer,
            jnp.asarray(now, jnp.float32), depth_keep_time, fmap.map_ctx,
            robot_pos, robot_quat)

    # 2. stacked composition + lethal aggregation (skipped when the LOS
    # stage is disabled — its only consumer, see plan_on_graph). The
    # zone layers join the stack here: the no-entry field min-composes
    # under its runtime toggle (`no_entry_layer.cpp` enable service →
    # the traced ``no_entry_enabled`` flag) and the speed-limit zone
    # caps the sampler below (`stacked_perception.cpp:114-126` +
    # `speed_limit_layer.cpp:222-300`).
    composed = min_dgraph(fmap.static_dgraph, marking.dgraph)
    if depth_marking is not None:
        composed = min_dgraph(composed, depth_marking.dgraph)
    if fmap.no_entry_field is not None:
        gated = jnp.where(jnp.asarray(no_entry_enabled), fmap.no_entry_field,
                          p.max_obstacle_distance)
        composed = min_dgraph(composed, gated)
    if fmap.speed_zone_pts is not None:
        from dddmr_navigation_tpu.perception.layers import speed_limit_at
        zone_cap = speed_limit_at(robot_pos, fmap.speed_zone_pts,
                                  fmap.speed_zone_valid,
                                  fmap.speed_zone_speed)
        cap = jnp.asarray(allowed_max_speed, jnp.float32)
        allowed_max_speed = jnp.where(
            zone_cap > 0.0,
            jnp.where(cap > 0.0, jnp.minimum(cap, zone_cap), zone_cap),
            cap)
    if nav_cfg.global_planner.max_long_edges > 0:
        # Only nodes near a long edge can affect an LOS verdict — the
        # static los_relevant mask keeps the extraction budget tight on
        # real maps with thousands of static overhang lethals.
        lethal_pts, lethal_valid = lethal_cloud_from_dgraph(
            fmap.ground, fmap.ground_valid & fmap.los_relevant, composed,
            inscribed_radius=p.inscribed_radius,
            max_lethal=nav_cfg.global_planner.max_lethal_points)
    else:
        lethal_pts = lethal_valid = None

    # 3a. global planner pre-relaxation: snap, LOS gate, entry costs,
    # warm-field goal gate (`plan_prepare`)
    from dddmr_navigation_tpu.planning.global_.planner import plan_prepare
    prep = plan_prepare(
        nav_cfg.global_planner, fmap.nbr_idx, fmap.nbr_dist, fmap.nbr_valid,
        fmap.ground, fmap.ground_valid, composed, fmap.node_weight,
        robot_pos, goal_pos,
        inscribed_radius=p.inscribed_radius,
        inflation_descending_rate=p.inflation_descending_rate,
        lethal_pts=lethal_pts, lethal_valid=lethal_valid,
        warm_dist=state.wf_dist, warm_goal_idx=state.wf_goal_idx)
    return FusedPrePlan(
        marking=marking, depth_marking=depth_marking,
        depth_buffer=depth_buffer, depth_latest=depth_latest,
        composed=composed,
        allowed_max_speed=jnp.asarray(allowed_max_speed, jnp.float32),
        scan_global=scan_global, prep=prep)


def fused_post_plan(nav_cfg: NavigationConfig, generator: str,
                    fmap: FusedMap, pre: FusedPrePlan, res,
                    scan_mask, robot_pos, robot_quat, v_now, w_now,
                    wf_stall=0, plan=None) -> tuple:
    """Stages 4–6 of the fused vertical AFTER the relaxation+extraction
    (``res`` is the GlobalPathResult): device path interpolation, this
    tick's aggregated observation, prune → rollouts → critics → argmin,
    and state/out assembly. Fleets pass a precomputed ``plan`` (the
    flat-scatter fleet interpolation) — the per-robot scatter is a
    pathological batched scatter under vmap."""
    # 4. node path → interpolated plan (getROSPath) on device
    if plan is None:
        plan = interpolate_path_device(
            fmap.ground, res, max_plan_len=nav_cfg.local_planner.max_plan_len)

    # 5. observation from THIS scan (+ the latest depth points — the
    # aggregated observation, `stacked_perception.cpp:128-140`);
    # 6. prune → rollouts → critics → argmin
    agg_pts, agg_mask = pre.scan_global, scan_mask
    if pre.depth_latest is not None:
        agg_pts = jnp.concatenate(
            [agg_pts, pre.depth_latest.points.reshape(-1, 3)], axis=0)
        agg_mask = jnp.concatenate(
            [agg_mask, pre.depth_latest.mask.reshape(-1)], axis=0)
    obs, obs_mask = device_observation(
        agg_pts, agg_mask, nav_cfg.local_planner.max_obstacle_points)
    cmd = compute_velocity_command(
        nav_cfg.local_planner, plan, robot_pos, robot_quat, v_now, w_now,
        obs, obs_mask, allowed_max_speed=pre.allowed_max_speed,
        generator=generator)

    out = FusedOut(vx=cmd.vx, wz=cmd.wz, state=cmd.state,
                   best_index=cmd.best_index, best_cost=cmd.best_cost, plan=plan, plan_ok=res.ok,
                   composed_dgraph=pre.composed, obs=obs, obs_mask=obs_mask,
                   wf_iters=res.iters)
    return FusedState(marking=pre.marking, wf_dist=res.dist_carry,
                      wf_goal_idx=res.goal_idx,
                      depth_marking=pre.depth_marking,
                      depth_buffer=pre.depth_buffer,
                      wf_stall=wf_stall), out


def fleet_interpolate_path_device(ground, res, *, max_plan_len: int,
                                  interp_steps: int = 19,
                                  step: float = 0.05, min_emit: float = 0.1
                                  ) -> GlobalPlan:
    """Robot-batched `interpolate_path_device` with the output compaction
    as ONE flat 1-D scatter (robot-offset target indices): under vmap the
    per-robot (L·E → max_plan_len) scatter lowers to a batched scatter,
    which was slow before the port to the H100 (not re-measured there).
    Emission logic,
    constants, and results are element-for-element identical; ``res`` is
    a robot-batched GlobalPathResult."""
    R, L = res.node_ids.shape
    valid = res.node_valid                                  # (R, L)
    n = res.length                                          # (R,)
    ids = jnp.maximum(res.node_ids, 0)
    pts = ground[ids]                                       # (R, L, 3)
    slots = jnp.arange(L)[None, :]
    has_next = valid & (slots < n[:, None] - 1)
    ids_next = jnp.take_along_axis(ids, jnp.minimum(slots + 1, L - 1),
                                   axis=1)
    nxt = jnp.where(has_next[:, :, None], ground[ids_next], pts)
    v = nxt - pts                                           # (R, L, 3)
    quats = slope_aware_quat(v.reshape(-1, 3)).reshape(R, L, 4)

    steps = jnp.asarray(np.arange(step, 0.99, step, dtype=np.float32)
                        [:interp_steps])

    def body(last, s):
        cand = pts + v * s
        emit = jnp.linalg.norm(cand - last, axis=-1) > jnp.float32(min_emit)
        new_last = jnp.where(emit[..., None], cand, last)
        return new_last, (emit, cand)

    _, (emits, cands) = jax.lax.scan(body, pts, steps)
    emits = jnp.moveaxis(emits, 0, 2)                       # (R, L, S)
    cands = jnp.moveaxis(cands, 0, 2)                       # (R, L, S, 3)

    E = interp_steps + 1
    emit_all = jnp.concatenate([valid[:, :, None],
                                emits & has_next[:, :, None]], axis=2)
    pos_all = jnp.concatenate([pts[:, :, None, :], cands], axis=2)
    quat_all = jnp.broadcast_to(quats[:, :, None, :], (R, L, E, 4))

    flat_emit = emit_all.reshape(R, -1)                     # (R, L*E)
    out_idx = jnp.cumsum(flat_emit, axis=1) - 1
    count = jnp.minimum(jnp.sum(flat_emit, axis=1),
                        max_plan_len).astype(jnp.int32)     # (R,)
    keep = flat_emit & (out_idx < max_plan_len)
    tgt = jnp.where(keep,
                    jnp.arange(R)[:, None] * max_plan_len + out_idx,
                    R * max_plan_len)                       # flat ids
    pos_buf = jnp.zeros((R * max_plan_len, 3), jnp.float32).at[
        tgt.reshape(-1)].set(pos_all.reshape(-1, 3), mode="drop")
    quat_buf = jnp.zeros((R * max_plan_len, 4), jnp.float32).at[
        tgt.reshape(-1)].set(quat_all.reshape(-1, 4), mode="drop")
    plan_valid = (jnp.arange(max_plan_len)[None, :] < count[:, None]) \
        & res.ok[:, None]
    count = jnp.where(res.ok, count, 0)
    return GlobalPlan(pos_buf.reshape(R, max_plan_len, 3),
                      quat_buf.reshape(R, max_plan_len, 4),
                      plan_valid, count)


def fused_tick(nav_cfg: NavigationConfig, spec: VoxelSpec,
               ri_spec: RangeImageSpec, params: MarkingParams,
               generator: str, fmap: FusedMap, state: FusedState,
               scan_sensor, scan_mask, robot_pos, robot_quat,
               sensor_offset, goal_pos, v_now, w_now,
               allowed_max_speed=-1.0, depth_cam=None,
               depth_frames=None, now=0.0,
               depth_keep_time: float = 0.5, no_entry_enabled=True):
    """One full vertical tick on device. ``scan_sensor`` is the live sweep
    in the SENSOR frame (rotated to global inside the program).

    Static args: nav_cfg/spec/ri_spec/params/generator (+ depth_cam /
    depth_keep_time when cameras are attached) — jit with
    ``static_argnums=(0, 1, 2, 3, 4)`` or use :func:`make_fused_tick`.

    Depth cameras: with ``depth_cam`` (a CameraModel) and a state built
    with ``depth_cameras > 0``, pass this tick's frames as a pytree of
    (cam_pos (C,3), cam_quat (C,4), points (C,P,3) world, mask (C,P));
    the DepthCameraLayer stage (buffer → frustum clear vs ALL live →
    mark latest → layer dGraph) runs inside the same program, its field
    min-composes into the stacked dGraph
    (`perception_3d_ros.cpp:220-249`), and its latest points join the
    aggregated observation the critics see.

    Composed as `fused_pre_plan` → wavefront relaxation →
    `fused_post_plan`; fleets replace the middle stage with a joint
    node-major relaxation over the shared graph (`parallel/fleet.py`).
    """
    from dddmr_navigation_tpu.planning.global_.planner import plan_finish
    from dddmr_navigation_tpu.planning.global_.wavefront import (
        wavefront_distances, wavefront_distances_turning)

    pre = fused_pre_plan(
        nav_cfg, spec, ri_spec, params, fmap, state, scan_sensor, scan_mask,
        robot_pos, robot_quat, sensor_offset, goal_pos,
        allowed_max_speed, depth_cam, depth_frames, now, depth_keep_time,
        no_entry_enabled)
    gp = nav_cfg.global_planner
    budget = gp.relax_iters_per_tick
    max_it = budget if budget > 0 else gp.max_relax_iters
    if gp.turning_weight > 0.0:
        dist_gb, edge_bins, iters = wavefront_distances_turning(
            fmap.nbr_idx, fmap.nbr_dist, pre.prep.graph_valid, pre.prep.enter,
            fmap.avg_intensity, pre.prep.goal_idx, fmap.ground,
            gp.turning_weight, n_dir_bins=gp.turning_dir_bins,
            max_iters=max_it, dist0=pre.prep.warm_dist,
            az=fmap.wf_az, bin_of_edge=fmap.wf_bins)
        dist_relaxed = dist_gb
    else:
        wf = wavefront_distances(
            fmap.nbr_idx, fmap.nbr_dist, pre.prep.graph_valid, pre.prep.enter,
            fmap.avg_intensity, pre.prep.goal_idx,
            max_iters=max_it, dist0=pre.prep.warm_dist)
        dist_relaxed, iters, edge_bins = wf.dist, wf.iters, None
    stall_reset, wf_stall = budget_stall_update(gp, state.wf_stall, iters)
    res = plan_finish(gp, fmap.nbr_idx, fmap.nbr_dist, fmap.ground,
                      pre.prep, dist_relaxed, iters,
                      turn_pen=fmap.turn_pen if gp.turning_weight > 0.0
                      else None,
                      wf_bins=edge_bins, stall_reset=stall_reset)
    return fused_post_plan(nav_cfg, generator, fmap, pre, res, scan_mask,
                           robot_pos, robot_quat, v_now, w_now,
                           wf_stall=wf_stall)


def budget_stall_update(gp, wf_stall, iters):
    """Carry-reset policy vs the relaxation budget: returns
    (stall_reset, new_counter). With no budget, classic semantics (reset
    when a single solve hits ``max_relax_iters`` — the round-4 regression
    against unreachable pockets pinning EVERY later warm tick at the
    iteration cap). With a budget the reset is OFF: the per-tick cost the
    reset existed to avoid is already bounded at ``relax_iters_per_tick``,
    and exiting AT the budget is NORMAL under fleet-scale churn (every
    moving robot repairs its own field every tick) — a consecutive-non-
    convergence counter misfires there, cyclically wiping every robot's
    field (measured: a 64-robot real-map fleet lost all plans every ~64
    ticks). An unreachable pocket under budget merely keeps its values
    rising inside the bounded budget while reachable regions still
    converge; extraction into it correctly reports failure."""
    budget = gp.relax_iters_per_tick
    if budget <= 0:
        return None, wf_stall
    return jnp.zeros_like(wf_stall, dtype=bool), wf_stall


def make_fused_tick(nav_cfg: NavigationConfig,
                    generator: str = "differential_drive_simple",
                    depth_cam=None, depth_keep_time: float = 0.5):
    """Returns (jitted_tick, spec, ri_spec, params); the callable signature
    is ``tick(fmap, state, scan_sensor, scan_mask, robot_pos, robot_quat,
    sensor_offset, goal_pos, v_now, w_now[, depth_frames=..., now=...])``.
    Pass ``depth_cam`` (CameraModel) to enable the fused depth-camera
    stage (state must be built with ``depth_cameras > 0``)."""
    p = nav_cfg.perception
    params = MarkingParams.from_config(p)
    spec = VoxelSpec(
        nx=p.voxel_window_cells_xy, ny=p.voxel_window_cells_xy,
        nz=p.voxel_window_cells_z, xy_resolution=p.lidar.xy_resolution,
        height_resolution=p.lidar.height_resolution)
    ri_spec = RangeImageSpec(
        rows=p.lidar.range_image_rows, cols=p.lidar.range_image_cols,
        elev_min_deg=p.lidar.vertical_FOV_bottom,
        elev_max_deg=p.lidar.vertical_FOV_top)
    fn = jax.jit(partial(fused_tick, nav_cfg, spec, ri_spec, params,
                         generator, depth_cam=depth_cam,
                         depth_keep_time=depth_keep_time))
    return fn, spec, ri_spec, params
