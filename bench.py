"""Benchmarks against BASELINE.md's target table, on one NVIDIA GPU.

Default run measures:
  * headline (configs 1+4 hybrid): 64-robot closed-loop sampling-MPC
    throughput — rollouts/s vs the reference's ~500 rollouts/s/process —
    with its position against the card's published peaks;
  * config 2: ramp map, 4 s horizon, ~2k rollouts, with the FULL 3D
    mark/clear perception update fused into every control tick;
  * config 3: the COMPLETE fused vertical (control/fused.py) on the
    multi-level map — mark/clear → composed dGraph → lethal → wavefront
    → path extraction → interpolation → 8k rollouts → critics — one
    program, every stage consuming the previous stage's output;
  * config 4: the 64-robot full-fidelity fleet (MCL, mark/clear, turning
    wavefront, FSM, recovery), and the same with a relaxation budget;
  * slam, mcl and semantic verticals, single-card batch scaling and the
    collision critic stage alone.

Timing: every program compiles before its timed window, and compile
seconds are reported per config. Each closed-loop chain is ONE `lax.scan`
dispatch that ends in `jax.block_until_ready`, so `tick_ms` is the
scan-amortized time per tick and `p99_tick_ms` is the p99 over per-chain
means, not a per-tick tail.

The run needs a GPU and fails without one. A phase that cannot run here
(reference assets or flax absent) is listed under ``not_run`` with its
reason; a phase that raises makes the run exit non-zero.

Prints ONE JSON line:
  {"metric": "rollouts_per_s", "value": N, "unit": "rollouts/s",
   "vs_baseline": N/500, "device": {...}, "config2": {...}, ...}
"""
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_ROLLOUTS_PER_S = 500.0   # reference: ~50 rollouts @ 10 Hz
TICK_BUDGET_MS = 50.0             # 20 Hz p99 budget (BASELINE.md)

# Published dense peaks by `device_kind` (NVIDIA H100 Tensor Core GPU data
# sheet, SXM part, at its 700 W limit). f32 is the rate outside the
# tensor cores: this workload's critics are elementwise f32.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet (SXM, dense, 700 W)",
    },
}


class PhaseNotRun(Exception):
    """A phase whose inputs are absent from this checkout or install."""


def device_peaks(kind: str) -> dict:
    """The published peaks of a device kind; an unknown kind is an error."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def _setup_jax():
    import jax
    from dddmr_navigation_tpu.jax_setup import use_compile_cache
    use_compile_cache()
    return jax


def _tick_stats(per_tick):
    """Headline = MEDIAN per-tick time; min and p99 are reported alongside.
    p99 is over per-chain means (see module note)."""
    import numpy as np
    return {
        "tick_ms": 1e3 * float(np.median(per_tick)),
        "tick_ms_min": 1e3 * float(min(per_tick)),
        "p99_tick_ms": 1e3 * float(np.percentile(per_tick, 99)),
    }


def _time_chains(run, make_args, ticks, reps):
    """Compile+warm once, then time `reps` chains; returns
    (compile_s, per-tick seconds list, last outputs)."""
    import jax
    args = make_args()
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(*args))
    compile_s = time.perf_counter() - t0
    per_tick = []
    for _rep in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(*args))
        per_tick.append((time.perf_counter() - t0) / ticks)
    return compile_s, per_tick, out


# ---------------------------------------------------------------------------
# headline: configs 1+4 hybrid (64 robots, dense dynamic-window grid)
# ---------------------------------------------------------------------------

def headline_config(obstacles_n=512, linear_samples=16, angular_samples=16,
                    obstacle_chunk=16):
    from dddmr_navigation_tpu.config import (
        LocalPlannerConfig, DDSimpleGeneratorConfig)
    return LocalPlannerConfig(
        generator=DDSimpleGeneratorConfig(
            linear_x_sample=linear_samples, angular_z_sample=angular_samples,
            max_num_steps=40),
        max_obstacle_points=obstacles_n,
        collision_obstacle_chunk=obstacle_chunk, collision_near_k=128)


def bench_headline(robots=64, ticks=50, reps=6, obstacles_n=512,
                   linear_samples=16, angular_samples=16,
                   obstacle_chunk=16, analyze=False):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.planning.local.planner import make_global_plan
    from dddmr_navigation_tpu.parallel.fleet import (
        FleetState, fleet_tick, integrate_fleet)

    cfg = headline_config(obstacles_n, linear_samples, angular_samples,
                          obstacle_chunk)
    b = robots
    s_padded = cfg.generator.n_samples_padded

    xs = np.arange(0, 8.0, 0.1, dtype=np.float32)
    plans_np = [np.stack([xs, 0.4 * np.sin(xs + i * 0.3) + 0.02 * i,
                          np.zeros_like(xs)], 1) for i in range(b)]
    plan_leaves = [make_global_plan(p, max_len=cfg.max_plan_len)
                   for p in plans_np]
    plans = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *plan_leaves)
    rng = np.random.default_rng(0)
    obstacles = jnp.asarray(rng.uniform(
        [1.0, -2, 0], [8, 2, 0.5], size=(b, obstacles_n, 3)).astype(np.float32))
    obs_valid = jnp.ones((b, obstacles_n), bool)
    dt = 1.0 / cfg.controller_frequency

    def one_tick(state, plans, obstacles, obs_valid):
        vx, wz, codes, costs = fleet_tick(cfg, plans, state, obstacles,
                                          obs_valid)
        new_state = integrate_fleet(state, vx, wz, dt)
        return new_state, jnp.sum(costs >= 0).astype(jnp.int32)

    # plans/obstacles are explicit ARGUMENTS, not jit closure constants
    @jax.jit
    def run(state, plans, obstacles, obs_valid):
        def body(s, _):
            s2, found = one_tick(s, plans, obstacles, obs_valid)
            return s2, found
        final, found = jax.lax.scan(body, state, None, length=ticks)
        return final.pos, found

    def make_args():
        state = FleetState(
            pos=jnp.asarray(np.stack([np.zeros(b), 0.02 * np.arange(b),
                                      np.zeros(b)], 1), jnp.float32),
            quat=jnp.broadcast_to(quat_from_yaw(jnp.float32(0.0)), (b, 4)),
            v=jnp.zeros((b,)), w=jnp.zeros((b,)))
        return state, plans, obstacles, obs_valid

    compile_s, per_tick, out = _time_chains(run, make_args, ticks, reps)
    rollouts_per_tick = b * s_padded
    stats = _tick_stats(per_tick)
    best = stats["tick_ms"] / 1e3          # median (see _tick_stats)
    result = {
        "rollouts_per_s": rollouts_per_tick / best,
        **stats,
        "rollouts_per_tick": rollouts_per_tick,
        "robots": b,
        "found": int(np.asarray(out[1]).sum()),
        "compile_s": round(compile_s, 1),
    }
    if analyze:
        result["roofline"] = _roofline(
            run, make_args(), best, robots=b, samples=s_padded,
            steps=cfg.generator.max_num_steps,
            near_k=min(cfg.collision_near_k, obstacles_n),
            prune_len=cfg.max_prune_len)
    return result


def analytic_flops_per_tick(robots, samples, steps, near_k, prune_len):
    """Dominant-term f32 operation count of one fleet control tick. The
    critics are elementwise f32 work, so the f32 rate outside the tensor
    cores is the compute ceiling."""
    rollout = samples * steps * 20                     # unicycle + transform
    axes = samples * steps * (90 + 18)                 # cuboid axes + proj_c
    collision = samples * steps * near_k * 21          # 3 axes x 7 flops/pt
    stick = samples * steps * prune_len * 8            # NN distance scan
    end_critics = samples * prune_len * 10             # end-pose critics
    return robots * (rollout + axes + collision + stick + end_critics)


def _roofline(jitted, args, tick_s, *, robots, samples, steps, near_k,
              prune_len):
    """Position of the timed program against the card's published peaks.
    Operations come from the analytic model; XLA's post-fusion cost
    analysis cross-checks them and gives bytes (a fused elementwise chain
    reports inputs+outputs only, and a loop body is counted once, so the
    scan body is one tick)."""
    import jax
    kind = jax.devices()[0].device_kind
    peaks = device_peaks(kind)
    f_tick = float(analytic_flops_per_tick(robots, samples, steps, near_k,
                                           prune_len))
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    xla_flops = float(ca.get("flops", 0.0))
    b_tick = float(ca.get("bytes accessed", 0.0))
    frac_f32 = (f_tick / tick_s) / peaks["f32_flops"]
    frac_hbm = (b_tick / tick_s) / peaks["hbm_bytes_per_s"]
    return {
        "device_kind": kind,
        "peaks_source": peaks["source"],
        "model_flops_per_tick": round(f_tick),
        "achieved_tflops": round(f_tick / tick_s / 1e12, 3),
        "frac_of_f32_peak": round(frac_f32, 4),
        "xla_flops_per_tick": round(xla_flops),
        "xla_bytes_per_tick": round(b_tick),
        "achieved_gbps": round(b_tick / tick_s / 1e9, 1),
        "frac_of_hbm_peak": round(frac_hbm, 4),
        "bound": "f32" if frac_f32 >= frac_hbm else "hbm",
    }


def bench_collision_stage(robots=64, obstacles_n=512, chain=50, reps=5):
    """The collision critic alone at the headline widths (B robots × S
    samples × N steps against the nearest K of M obstacle points), timed
    as a chain of dependent calls in one dispatch, beside the least time
    the card's published f32 and HBM peaks allow for the same work."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.planning.local.critics import collision_scores
    from dddmr_navigation_tpu.planning.local.rollout import rollout
    from dddmr_navigation_tpu.planning.local.sampler import dd_simple_samples

    cfg = headline_config(obstacles_n)
    gen = cfg.generator
    b = robots

    def rollouts_of(pos, quat, v):
        samples, valid = dd_simple_samples(gen, v, jnp.float32(0.0),
                                           jnp.float32(-1.0))
        return rollout(samples, valid, pos, quat, sim_time=gen.sim_time,
                       sim_granularity=gen.sim_granularity,
                       angular_sim_granularity=gen.angular_sim_granularity,
                       min_vel_x=gen.limits.min_vel_x,
                       min_vel_theta=gen.limits.min_vel_theta,
                       max_vel_x=gen.limits.max_vel_x,
                       max_steps=gen.max_num_steps)

    pos = jnp.asarray(np.stack([np.zeros(b), 0.02 * np.arange(b),
                                np.zeros(b)], 1), jnp.float32)
    quat = jnp.broadcast_to(quat_from_yaw(jnp.float32(0.0)), (b, 4))
    r = jax.jit(jax.vmap(rollouts_of))(pos, quat, jnp.full((b,), 0.3))
    rng = np.random.default_rng(0)
    obstacles = jnp.asarray(rng.uniform(
        [0.3, -1.5, 0], [3, 1.5, 0.5], size=(b, obstacles_n, 3))
        .astype(np.float32))
    obs_valid = jnp.ones((b, obstacles_n), bool)

    def stage(r, obstacles, obs_valid):
        return jax.vmap(lambda rr, o, m: collision_scores(
            rr, gen.cuboid, o, m, obstacle_chunk=cfg.collision_obstacle_chunk,
            near_k=cfg.collision_near_k))(r, obstacles, obs_valid)

    @jax.jit
    def run(r, obstacles, obs_valid):
        def body(_, acc):
            # a dependence on the previous call keeps the calls in order
            nudged = obstacles + acc * 1e-30
            return acc + jnp.sum(stage(r, nudged, obs_valid))
        return jax.lax.fori_loop(0, chain, body, jnp.float32(0.0))

    compile_s, per_call, out = _time_chains(
        run, lambda: (r, obstacles, obs_valid), chain, reps)
    call_s = float(np.median(per_call))
    s, n = r.theta.shape[1:]
    k = min(cfg.collision_near_k, obstacles_n)
    # per (sample, step, point): 3 axes × (3 mul + 2 add + sub + abs +
    # compare) + 2 ands; per (sample, step): 3 axes of the rotated cuboid
    flops = b * s * n * (k * 26 + 120)
    # the rollouts' poses in, one hit flag per rollout out
    nbytes = 4 * (b * s * n * 8 + b * obstacles_n * 4 + b * s)
    peaks = device_peaks(jax.devices()[0].device_kind)
    t_f32 = flops / peaks["f32_flops"]
    t_hbm = nbytes / peaks["hbm_bytes_per_s"]
    return {
        "widths": {"robots": b, "samples": int(s), "steps": int(n),
                   "points": obstacles_n, "nearest_k": k},
        "call_ms": 1e3 * call_s,
        "call_ms_min": 1e3 * float(min(per_call)),
        "model_flops": flops,
        "model_bytes": nbytes,
        "f32_bound_ms": 1e3 * t_f32,
        "hbm_bound_ms": 1e3 * t_hbm,
        "frac_of_bound": max(t_f32, t_hbm) / call_s,
        "any_rollout_rejected": bool(out != 0.0),
        "compile_s": round(compile_s, 1),
    }


# ---------------------------------------------------------------------------
# config 2: ramp map + FULL 3D mark/clear fused into the control tick —
# the critics consume the observation derived from THIS tick's scan and
# the path-blocked opinion reads THIS tick's prune plan vs that
# observation (the round-2 review's dataflow-honesty fix)
# ---------------------------------------------------------------------------

def bench_config2(ticks=30, reps=4):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import (
        LocalPlannerConfig, DDSimpleGeneratorConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io.maps import ramp_ground_map
    from dddmr_navigation_tpu.planning.local.planner import (
        make_global_plan, compute_velocity_command, PlannerState)
    from dddmr_navigation_tpu.perception.voxel import VoxelSpec
    from dddmr_navigation_tpu.perception.fov import RangeImageSpec
    from dddmr_navigation_tpu.perception.static_map import build_map_context
    from dddmr_navigation_tpu.perception.marking import (
        MarkingParams, init_marking_state, perception_update)
    from dddmr_navigation_tpu.perception.layers import path_blocked
    from dddmr_navigation_tpu.control.fused import device_observation
    from dddmr_navigation_tpu.utils.lidar_sim import BoxWorld, simulate_scan

    # BASELINE config 2: ramp map, 4 s horizon, ~2k rollouts, 16-line lidar
    cfg = LocalPlannerConfig(
        generator=DDSimpleGeneratorConfig(
            linear_x_sample=42, angular_z_sample=46,   # 43*47 = 2021
            sim_time=4.0, max_num_steps=80),
        max_obstacle_points=2048,
        collision_obstacle_chunk=16, collision_near_k=128)
    ground = ramp_ground_map()
    map_ctx = build_map_context(ground)
    spec = VoxelSpec(nx=128, ny=128, nz=44, xy_resolution=0.05,
                     height_resolution=0.05)
    ri = RangeImageSpec(rows=16, cols=1000, elev_min_deg=-15.0,
                        elev_max_deg=15.0)
    # full-circle effective scan (the synthetic lidar has no mast shadow)
    params = MarkingParams(scan_effective_positive_start=0.0,
                           scan_effective_negative_start=0.0)

    world = BoxWorld().add_box([2.0, -1.0, 0.0], [2.4, 1.0, 1.5])
    robot = np.array([0.0, 0.0, 0.0], np.float32)
    scan_pts, scan_mask = simulate_scan(world, robot + [0, 0, 0.5],
                                        n_rings=16, n_cols=1000)
    scan_pts = scan_pts + robot[None, :] + np.array([0, 0, 0.5], np.float32)
    scan_mask = scan_mask & (scan_pts[:, 2] >= 0.15)

    xs = np.arange(0, 8.0, 0.1, dtype=np.float32)
    plan = make_global_plan(
        np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1),
        max_len=cfg.max_plan_len)

    state0 = init_marking_state(spec, params, len(ground))
    rq = jnp.asarray(np.asarray(quat_from_yaw(jnp.float32(0.0))))
    rp = jnp.asarray(robot)
    sp = rp + jnp.asarray([0.0, 0.0, 0.5])

    @jax.jit
    def run(mstate, scan, smask, plan):
        def body(s, _):
            # 1. mark/clear from the live scan (state chains tick→tick)
            s2 = perception_update(spec, ri, params, s, map_ctx, scan,
                                   smask, rp, rq, sp, rq)
            # 2. the critics' observation comes from THIS scan
            obs, obs_mask = device_observation(scan, smask,
                                               cfg.max_obstacle_points)
            cmd = compute_velocity_command(
                cfg, plan, rp, rq, jnp.float32(0.3), jnp.float32(0.0),
                obs, obs_mask)
            # 3. path-blocked opinion from THIS prune plan vs THIS
            #    observation (`path_blocked_strategy.cpp:56-101`)
            blocked = path_blocked(cmd.prune, obs, obs_mask, 0.3)
            state = jnp.where(
                (cmd.state == int(PlannerState.TRAJECTORY_FOUND)) & blocked,
                int(PlannerState.PATH_BLOCKED_WAIT), cmd.state)
            return s2, (cmd.vx, state, jnp.sum(s2.grid))
        final, (vxs, states, marks) = jax.lax.scan(body, mstate, None,
                                                   length=ticks)
        return final.dgraph, vxs, states, marks

    def make_args():
        return (state0, jnp.asarray(scan_pts), jnp.asarray(scan_mask), plan)

    compile_s, per_tick, out = _time_chains(run, make_args, ticks, reps)
    stats = _tick_stats(per_tick)
    best = stats["tick_ms"] / 1e3
    s_padded = cfg.generator.n_samples_padded
    return {
        **stats,
        "rollouts_per_tick": s_padded,
        "marked_voxels": int(np.asarray(out[3])[-1]),
        "planner_state_last": int(np.asarray(out[2])[-1]),
        "obs_from_tick_scan": True,
        "under_budget": bool(1e3 * best < TICK_BUDGET_MS),
        "compile_s": round(compile_s, 1),
    }


# ---------------------------------------------------------------------------
# config 3: the FULL fused vertical on the multi-level map — mark/clear →
# composed dGraph → lethal → wavefront → path extraction → interpolation →
# prune → 8k rollouts → critics → argmin, every stage consuming the
# previous stage's output, in one program (control/fused.py)
# ---------------------------------------------------------------------------

def config3_scene():
    """The config-3 tick and its first inputs: one robot on the
    multi-level map with a 16x1000 lidar, 8,192 rollouts x 40 steps and
    2,048 observation points, heading for a goal one floor up. ``tick``
    is `fused_tick` with its static arguments bound; ``args`` are its
    array arguments for the first tick."""
    from functools import partial
    from types import SimpleNamespace
    import numpy as np
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import (
        NavigationConfig, LocalPlannerConfig, DDSimpleGeneratorConfig,
        PerceptionConfig, SpinningLidarConfig, GlobalPlannerConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io.maps import multi_level_map
    from dddmr_navigation_tpu.perception.static_weights import (
        compute_node_weights)
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, init_fused_state, make_fused_tick, fused_tick)
    from dddmr_navigation_tpu.utils.lidar_sim import BoxWorld, simulate_scan

    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=16000, range_image_rows=16, range_image_cols=1000)
    # 96-cell (4.8 m) marking window: the reference's default
    # perception_window_size is 2.0 m — 4.8 m is still generous and keeps
    # the window-proportional mark/clear work honest for a 10 Hz tick
    cfg = NavigationConfig(
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=96,
                                    voxel_window_cells_z=44),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=63, angular_z_sample=127,   # 64*128 = 8192
                max_num_steps=40),
            max_obstacle_points=2048,
            collision_obstacle_chunk=16, collision_near_k=128),
        # max_long_edges=0: the multi-level graph has ZERO >=2*inscribed
        # edges (measured at build; dense 0.25 m grid, no kNN orphan
        # fallbacks), so the LOS stage would verify nothing
        global_planner=GlobalPlannerConfig(max_relax_iters=320,
                                           max_long_edges=0))

    ground, map_pts = multi_level_map()      # STACKED floors + ramp + duct
    weights, static_dgraph = compute_node_weights(ground, map_pts)
    fmap = build_fused_map(cfg, ground, map_pts, node_weight=weights,
                           static_dgraph=static_dgraph)

    robot = np.array([8.5, 7.0, 0.0], np.float32)
    goal = np.array([8.5, 7.0, 2.5], np.float32)      # cross-floor goal
    offset = np.array([0.0, 0.0, 0.5], np.float32)
    world = BoxWorld().add_box([7.0, 5.8, 0.0], [7.5, 6.6, 1.2])
    scan_pts, scan_mask = simulate_scan(world, robot + offset,
                                        n_rings=16, n_cols=1000)
    scan_mask = scan_mask & (scan_pts[:, 2] + robot[2] + 0.5 >= 0.15)

    rq = jnp.asarray(np.asarray(quat_from_yaw(jnp.float32(0.0))))
    state0 = init_fused_state(cfg, len(ground), robot_xyz=robot)
    _, spec, ri_spec, params = make_fused_tick(cfg)
    tick = partial(fused_tick, cfg, spec, ri_spec, params,
                   "differential_drive_simple")
    args = (fmap, state0, jnp.asarray(scan_pts), jnp.asarray(scan_mask),
            jnp.asarray(robot), rq, jnp.asarray(offset), jnp.asarray(goal),
            jnp.float32(0.3), jnp.float32(0.0))
    return SimpleNamespace(cfg=cfg, tick=tick, args=args,
                           ground_nodes=len(ground))


def bench_config3(ticks=20, reps=4):
    import numpy as np
    import jax

    sc = config3_scene()

    @jax.jit
    def run(fmap, state, *rest):
        def body(s, _):
            s2, out = sc.tick(fmap, s, *rest)
            return s2, (out.vx, out.state, out.plan.count, out.plan_ok)
        final, (vxs, states, plan_lens, oks) = jax.lax.scan(
            body, state, None, length=ticks)
        return final.marking.dgraph, vxs, states, plan_lens, oks

    compile_s, per_tick, out = _time_chains(run, lambda: sc.args, ticks,
                                            reps)
    stats = _tick_stats(per_tick)
    best = stats["tick_ms"] / 1e3
    s_padded = sc.cfg.local_planner.generator.n_samples_padded
    return {
        **stats,
        "rollouts_per_tick": s_padded,
        "solves_per_s": 1.0 / best,      # one full replan per tick
        "ground_nodes": sc.ground_nodes,
        "map": "multi_level (stacked floors + ramp + overhang duct)",
        "cross_floor_plan_len": int(np.asarray(out[3])[-1]),
        "plan_ok": bool(np.asarray(out[4])[-1]),
        "vx_last": float(np.asarray(out[1])[-1]),
        "fused_single_program": True,
        "under_budget": bool(1e3 * best < TICK_BUDGET_MS),
        "compile_s": round(compile_s, 1),
    }


# ---------------------------------------------------------------------------
# config 3 at REAL-MAP scale: the complete fused vertical on the
# reference's own bundled 124 m slope map (27,045 ground nodes / 62,445
# map points) with the canonical YAML's planner semantics — turning_weight
# 0.1 (direction-expanded relaxation over 16 bins), LOS verification of
# the ~2k long kNN-fallback edges, real static weights + overhang lethals
# — and ≥10k rollouts/tick. The per-tick replan warm-starts from the
# previous tick's relaxation field (planning/global_/wavefront.py); the
# scene toggles a wall every 5 ticks so the warm ticks include honest
# field-repair work in both directions (appear ⇒ costs rise, vanish ⇒
# costs drop). Reported: warm-tick p50/p99, mean relaxation iterations,
# and the measured cold-solve time for a fresh goal.
# ---------------------------------------------------------------------------

def bench_config3_real(ticks=20, reps=4, toggle_period=5):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dataclasses import replace
    from tools import parity_reference as pr
    if not pr.assets_available():
        raise PhaseNotRun("reference assets not mounted")
    from dddmr_navigation_tpu.config import (
        LocalPlannerConfig, DDSimpleGeneratorConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, init_fused_state, make_fused_tick, fused_tick)
    from dddmr_navigation_tpu.utils.lidar_sim import BoxWorld, simulate_scan

    ctx = pr.load_context()
    cfg = ctx.cfg
    # canonical YAML planner semantics kept (turning_weight 0.1, 16 bins,
    # LOS on); sized for this bench: ≥10k rollouts (BASELINE row), 2048
    # max obstacle points, long-edge budget fitted to the real graph's
    # 1,998 long edges, 8 LOS samples (max long edge ~3 m ⇒ ≤0.5 m
    # spacing, the reference's stride)
    cfg = replace(
        cfg,
        local_planner=replace(
            cfg.local_planner,
            generator=replace(cfg.local_planner.generator,
                              linear_x_sample=79, angular_z_sample=129,
                              max_num_steps=40),
            max_obstacle_points=2048,
            collision_obstacle_chunk=16, collision_near_k=128),
        global_planner=replace(cfg.global_planner,
                               max_long_edges=2048, los_samples=8,
                               max_lethal_points=2048,
                               max_relax_iters=1024))
    fmap = build_fused_map(cfg, ctx.ground, ctx.map_pts,
                           node_weight=ctx.node_weight,
                           static_dgraph=ctx.static_dgraph,
                           intensity=ctx.ground_intensity)

    start_id, goal_id = pr.pick_start_goal_pairs(ctx, 3, seed=0,
                                                 min_separation=40.0)[1]
    robot = ctx.ground[start_id].copy()
    goal = ctx.ground[goal_id].copy()
    offset = np.array([0.0, 0.0, 0.5], np.float32)

    # Scene: a wall ON the strip 1.8 m toward the goal (toggles in/out
    # every toggle_period ticks ⇒ the field must rise around it, then
    # drop back — honest warm-repair work in both directions) plus a
    # permanent backdrop wall at 3.0 m that (a) keeps the no-wall sweep
    # non-empty and (b) provides the free-space rays that clear the
    # vanished wall's marks. The robot is yawed so the walls sit at
    # azimuth ≈ +90°, inside the canonical lidar's effective window
    # [30°, 180°] (the mast shadow excludes dead-ahead).
    to_goal = goal[:2] - robot[:2]
    u = to_goal / np.linalg.norm(to_goal)
    yaw = float(np.arctan2(u[1], u[0]) - np.pi / 2.0)
    side = np.array([-u[1], u[0]], np.float32)           # perpendicular

    def strip_box(world, along, thick=0.4, width=1.2, height=1.2):
        # AABB over ALL FOUR corners of the rotated rectangle (review
        # finding: two opposite corners alone collapse the extent for
        # diagonal path directions)
        c = robot[:2] + u * along
        corners = [c + su * u * thick / 2 + sv * side * width / 2
                   for su in (-1, 1) for sv in (-1, 1)]
        lo = np.minimum.reduce(corners)
        hi = np.maximum.reduce(corners)
        return world.add_box([lo[0], lo[1], robot[2] - 0.2],
                             [hi[0], hi[1], robot[2] + height])

    world_wall = strip_box(strip_box(BoxWorld(), 3.0), 1.8)
    world_clear = strip_box(BoxWorld(), 3.0)

    rq = jnp.asarray(np.asarray(quat_from_yaw(jnp.float32(yaw))))
    n_pad = cfg.perception.lidar.max_scan_points
    scans = np.zeros((2, n_pad, 3), np.float32)
    masks = np.zeros((2, n_pad), bool)
    for j, w in enumerate((world_wall, world_clear)):
        # simulate in the SENSOR frame the fused tick expects: cast from
        # the world-frame sensor position, then rotate returns into the
        # sensor frame (tick applies robot_quat before marking)
        pts_w, m = simulate_scan(w, robot + offset, n_rings=16, n_cols=1000)
        c, s = np.cos(-yaw), np.sin(-yaw)
        pts = pts_w.copy()
        pts[:, 0] = c * pts_w[:, 0] - s * pts_w[:, 1]
        pts[:, 1] = s * pts_w[:, 0] + c * pts_w[:, 1]
        m = m & (pts_w[:, 2] + 0.5 >= 0.15)              # drop floor-level
        keep = np.nonzero(m)[0][:n_pad]
        scans[j, :len(keep)] = pts[keep]
        masks[j, :len(keep)] = True
    state0 = init_fused_state(cfg, len(ctx.ground), robot_xyz=robot)
    _, spec, ri_spec, params = make_fused_tick(cfg)

    @jax.jit
    def run(fmap, state, scans, masks, rp, goal):
        def body(carry, i):
            s = carry
            which = (i // toggle_period) % 2
            s2, out = fused_tick(cfg, spec, ri_spec, params,
                                 "differential_drive_simple", fmap, s,
                                 scans[which], masks[which], rp, rq,
                                 jnp.asarray(offset), goal,
                                 jnp.float32(0.3), jnp.float32(0.0))
            return s2, (out.vx, out.state, out.plan_ok, out.wf_iters,
                        out.plan.count)
        final, (vxs, states, oks, iters, plens) = jax.lax.scan(
            body, state, jnp.arange(ticks))
        return final, vxs, states, oks, iters, plens

    args_cold = (fmap, state0, jnp.asarray(scans), jnp.asarray(masks),
                 jnp.asarray(robot), jnp.asarray(goal))

    # compile + cold chain (tick 0 relaxes from scratch)
    t0 = time.perf_counter()
    out_cold = run(*args_cold)
    final_state = out_cold[0]
    jax.block_until_ready(out_cold)
    compile_s = time.perf_counter() - t0
    cold_iters = int(np.asarray(out_cold[4])[0])
    args_warm = (fmap, final_state) + args_cold[2:]

    # warm chains: start from the converged state (field already relaxed)
    per_tick, cold_chain = [], []
    for _rep in range(reps):
        t0 = time.perf_counter()
        out = run(*args_warm)
        jax.block_until_ready(out)
        per_tick.append((time.perf_counter() - t0) / ticks)
        t0 = time.perf_counter()
        outc = run(*args_cold)
        jax.block_until_ready(outc)
        cold_chain.append(time.perf_counter() - t0)
    stats = _tick_stats(per_tick)
    best = stats["tick_ms"] / 1e3
    # cold solve cost = cold-chain time minus (ticks-1) warm ticks
    cold_ms = 1e3 * (min(cold_chain) - (ticks - 1) * best)
    it = np.asarray(out[4])
    s_padded = cfg.local_planner.generator.n_samples_padded
    return {
        "map": "reference ground.pcd/map.pcd",
        "ground_nodes": len(ctx.ground),
        "map_points": len(ctx.map_pts),
        "turning_weight": cfg.global_planner.turning_weight,
        "turning_dir_bins": cfg.global_planner.turning_dir_bins,
        "los_long_edges": int(np.asarray(
            (fmap.nbr_valid & (fmap.nbr_dist >= 1.0)).sum())),
        "rollouts_per_tick": s_padded,
        **stats,
        "cold_solve_ms": round(cold_ms, 1),
        "cold_relax_iters": cold_iters,
        "warm_relax_iters_mean": round(float(it.mean()), 1),
        "warm_relax_iters_max": int(it.max()),
        "scene": f"wall toggling every {toggle_period} ticks",
        "goal_distance_m": round(float(np.linalg.norm(goal - robot)), 1),
        "plan_ok_last": bool(np.asarray(out[3])[-1]),
        "plan_len_last": int(np.asarray(out[5])[-1]),
        "under_budget": bool(1e3 * best < TICK_BUDGET_MS),
        "fused_single_program": True,
        "compile_s": round(compile_s, 1),
    }


# ---------------------------------------------------------------------------
# config 4: 64 robots, ONE shared map, the FULL-FIDELITY per-robot stack —
# MCL localization on drifting odometry (60 particles, reference noise
# params) → mark/clear → turning-aware wavefront replan (w_turn 0.1, LOS
# stage enabled) → decision FSM → generator selection (simple vs rotate-
# shortest-angle) → rotate-in-place recovery — one vmapped program on one
# chip. No canonical feature is zeroed out (the round-3 bench dropped the
# turning term, the FSM, and localization for speed).
# ---------------------------------------------------------------------------

def config4_config(relax_budget=0):
    """The config-4 fleet's settings: (NavigationConfig, MoveBaseConfig,
    MCLConfig) — canonical planner semantics (YAML turning_weight 0.1, LOS
    stage on) and 60-particle corr-mode MCL with the reference's noise."""
    from dddmr_navigation_tpu.config import (
        NavigationConfig, LocalPlannerConfig, DDSimpleGeneratorConfig,
        PerceptionConfig, SpinningLidarConfig, GlobalPlannerConfig,
        MoveBaseConfig, MCLConfig)
    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=2048)
    cfg = NavigationConfig(
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=64,
                                    voxel_window_cells_z=24,
                                    max_marked_voxels=512,
                                    max_window_nodes=2048,
                                    cluster_pool=2),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=16, angular_z_sample=16, max_num_steps=40),
            max_obstacle_points=512, collision_obstacle_chunk=16,
            collision_near_k=128),
        global_planner=GlobalPlannerConfig(
            turning_weight=0.1, max_long_edges=256, los_samples=8,
            max_lethal_points=512, max_relax_iters=192,
            relax_iters_per_tick=relax_budget))
    mcl_cfg = MCLConfig(num_particles=60, init_var_x=0.3, init_var_y=0.3,
                        init_var_z=0.1, init_var_yaw=0.1,
                        field_sampling="corr")
    return cfg, MoveBaseConfig(), mcl_cfg


def config4_scene(cfg, mb, mcl_cfg, robots=64):
    """The config-4 warehouse: a 12 x 8 m floor inside perimeter walls
    (the structure MCL localizes against), robots in columns of up to 64
    at x = -4 (each further column 0.5 m ahead) driving to x = 4, each
    seeing one box ahead-left, on odometry that drifts 1 cm per tick.

    Returns a namespace whose ``tick_at(shared, per_robot, state, t)``
    runs `fleet_full_tick` for tick ``t`` (which may be traced);
    ``shared`` holds the map-side arrays, ``per_robot`` and ``state0`` the
    arrays with a leading robot axis."""
    from functools import partial
    from types import SimpleNamespace
    import numpy as np
    import jax.numpy as jnp
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, make_fused_tick)
    from dddmr_navigation_tpu.parallel.fleet import (
        init_fleet_full_state, fleet_full_tick, sharded_fleet_full_tick)
    from dddmr_navigation_tpu.state_estimation.likelihood import (
        build_submap_context)

    ground = flat_ground_map(12, 8, 0.25)
    walls = np.concatenate([
        box_obstacle([-5.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([5.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([0.0, -3.6, 0.0], size=(11.0, 0.3, 1.2),
                     resolution=0.15),
        box_obstacle([0.0, 3.6, 0.0], size=(11.0, 0.3, 1.2),
                     resolution=0.15),
    ]).astype(np.float32)
    fmap = build_fused_map(cfg, ground, walls)
    submap = build_submap_context(walls, ground, mcl_cfg)
    _, spec, ri_spec, params = make_fused_tick(cfg)

    b = robots
    column = min(b, 64)
    slot = np.arange(b) % column
    y = 0.1 * (slot - column / 2)
    positions = np.stack([-4.0 + 0.5 * (np.arange(b) // column), y,
                          np.zeros(b)], 1).astype(np.float32)
    goals = np.stack([np.full(b, 4.0), y, np.zeros(b)], 1).astype(np.float32)
    quats = np.broadcast_to(
        np.asarray(quat_from_yaw(jnp.float32(0.0))), (b, 4)).copy()
    n_pad = cfg.perception.lidar.max_scan_points
    scans = np.zeros((b, n_pad, 3), np.float32)
    masks = np.zeros((b, n_pad), bool)
    for i in range(b):
        box = box_obstacle([positions[i, 0] + 0.8, positions[i, 1] + 0.55,
                            0.0], size=(0.2, 0.2, 1.0), resolution=0.1)
        rel = box - (positions[i] + [0, 0, 0.3])
        scans[i, :len(rel)] = rel[:n_pad]
        masks[i, :min(len(rel), n_pad)] = True
    state0 = init_fleet_full_state(cfg, len(ground), positions, quats,
                                   localize=True, mcl_cfg=mcl_cfg)
    tick = partial(fleet_full_tick, cfg, mb, spec, ri_spec, params,
                   mcl_cfg=mcl_cfg)

    def tick_at(shared, per_robot, state, t):
        tf = jnp.asarray(t, jnp.float32)
        drift = 0.01 * tf * per_robot["drift_dir"]
        return tick(shared["fmap"], state, per_robot["scans"],
                    per_robot["masks"], shared["offset"], per_robot["goals"],
                    0.1 * tf, jnp.float32(0.1), submap_ctx=shared["submap"],
                    odom_drift_pos=drift,
                    odom_drift_yaw=jnp.zeros(drift.shape[:1]),
                    feature_map_pts=shared["walls"],
                    feature_ground_pts=shared["ground"])

    def sharded_tick_at(mesh):
        """``tick_at`` with the robots sharded over ``mesh``; also returns
        the psum'd count of robots holding TRAJECTORY_FOUND."""
        sharded = sharded_fleet_full_tick(cfg, mb, spec, ri_spec, params,
                                          mesh, mcl_cfg=mcl_cfg,
                                          localize=True)

        def run(shared, per_robot, state, t):
            tf = jnp.asarray(t, jnp.float32)
            drift = 0.01 * tf * per_robot["drift_dir"]
            return sharded(shared["fmap"], shared["submap"], shared["walls"],
                           shared["ground"], state, per_robot["scans"],
                           per_robot["masks"], shared["offset"],
                           per_robot["goals"], 0.1 * tf, jnp.float32(0.1),
                           drift, jnp.zeros(drift.shape[:1]))
        return run

    shared = {"fmap": fmap, "submap": submap,
              "offset": jnp.asarray([0.0, 0.0, 0.3]),
              "walls": jnp.asarray(walls), "ground": jnp.asarray(ground)}
    per_robot = {"scans": jnp.asarray(scans), "masks": jnp.asarray(masks),
                 "goals": jnp.asarray(goals),
                 "drift_dir": jnp.asarray(np.tile(
                     np.array([[0.7, 0.7, 0.0]], np.float32), (b, 1)))}
    return SimpleNamespace(cfg=cfg, tick_at=tick_at,
                           sharded_tick_at=sharded_tick_at, shared=shared,
                           per_robot=per_robot, state0=state0, robots=b,
                           ground_nodes=len(ground))


def bench_config4(robots=64, ticks=10, reps=4, relax_budget=0):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.planning.local.planner import PlannerState

    cfg, mb, mcl_cfg = config4_config(relax_budget)
    sc = config4_scene(cfg, mb, mcl_cfg, robots)
    b = robots

    def body_of(shared, per_robot):
        def body(c, t):
            s2, diag = sc.tick_at(shared, per_robot, c, t)
            found = jnp.sum(
                (diag["ps_simple"] == int(PlannerState.TRAJECTORY_FOUND))
                .astype(jnp.int32))
            return s2, (found, diag["decision"], jnp.max(diag["mcl_err"]),
                        jnp.max(diag["wf_iters"]), jnp.mean(diag["mcl_err"]))
        return body

    @jax.jit
    def warm_one(shared, per_robot, states):
        # tick 0: every robot's wavefront carry is inf-init, so this tick
        # pays the fleet-wide COLD solve (direction-expanded relaxation to
        # convergence). Timed separately — the steady 10 Hz loop runs warm
        # ticks, exactly as config3_real splits cold_solve_ms / tick_ms.
        s1, _ = body_of(shared, per_robot)(states, jnp.asarray(0))
        return s1

    @jax.jit
    def run(shared, per_robot, states):
        _, outs = jax.lax.scan(body_of(shared, per_robot), states,
                               1 + jnp.arange(ticks))
        return outs

    t0 = time.perf_counter()
    state1 = jax.block_until_ready(warm_one(sc.shared, sc.per_robot,
                                            sc.state0))
    warm_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state1 = jax.block_until_ready(warm_one(sc.shared, sc.per_robot,
                                            sc.state0))
    cold_tick_ms = 1e3 * (time.perf_counter() - t0)
    # the single-tick program's compile cost, reported, not excluded
    warm_compile_s -= cold_tick_ms / 1e3

    compile_s, per_tick, out = _time_chains(
        run, lambda: (sc.shared, sc.per_robot, state1), ticks, reps)
    stats = _tick_stats(per_tick)
    best = stats["tick_ms"] / 1e3
    p99_s = stats["p99_tick_ms"] / 1e3
    s_padded = cfg.local_planner.generator.n_samples_padded
    found, decisions, errs, wfs, errms = (np.asarray(o) for o in out)
    return {
        **stats,
        "cold_tick_ms": round(cold_tick_ms, 1),
        "warm_compile_s": round(warm_compile_s, 1),
        "warm_wf_iters_last_tick": int(wfs[-1]),
        "robots": b,
        "rollouts_per_tick": b * s_padded,
        "full_verticals_per_s": b / best,
        # throughput framing: the reference runs ONE robot's vertical per
        # machine at 10 Hz; this card sustains this many such robots —
        # derived from the p99 tick (the tail, not the best rep, is what a
        # 10 Hz deadline meets)
        "robots_at_10hz_per_chip": round(b / p99_s / 10.0, 1),
        "relax_budget_per_tick": relax_budget,
        "fidelity": ("mcl(60p, drifting odom) + mark/clear(0.1m cluster "
                     "lattice, the reference's own) + turning "
                     "wavefront(w=0.1"
                     + (f", budget {relax_budget} iters/tick — field "
                        "repair amortized across ticks; the reference's "
                        "own planner replans asynchronously at <=5 Hz, "
                        "p2p_global_plan_manager.cpp:108"
                        if relax_budget else "")
                     + ") + LOS + FSM + rotate recovery"),
        "found_last_tick": int(found[-1]),
        "decisions_last_tick": {
            int(k): int(v) for k, v in zip(
                *np.unique(decisions[-1], return_counts=True))},
        # max over the robots (the tail of independent filters) with the
        # mean alongside
        "mcl_err_last_tick": round(float(errs[-1]), 3),
        "mcl_err_mean_last_tick": round(float(errms[-1]), 3),
        "shared_map_nodes": sc.ground_nodes,
        "compile_s": round(compile_s, 1),
    }


# ---------------------------------------------------------------------------
# config 4b: the 64-robot FULL-fidelity fleet on the REAL reference map
# (27,045 ground nodes / 62,445 map points) — per-robot MCL on drifting
# odometry against the real map, mark/clear, wavefront replan with mixed
# goals + warm carries, LOS over the real graph's ~2k long edges, FSM,
# rotate recovery. Proves the config-4 memory/perf story survives real
# scale (round-4 review item 3).
#
# Design note (goal-field sharing / turning): with 64 DISTINCT goals the
# per-robot direction-expanded (G,B) fields would put the relaxation's
# node-major gather at (G,K,R,B) ≈ 886 MB/iteration at 27k nodes. The
# fleet therefore relaxes the plain node-table field (w_turn = 0,
# (G,R) ≈ 6.9 MB) — the trade the review offered — and the bench MEASURES
# what that costs: `turning_cost_delta_pct` re-plans sample pairs solo
# with the full direction-expanded solver and reports the reference-metric
# (θ-inclusive) path-cost delta of the w0 paths.
# ---------------------------------------------------------------------------

def bench_config4_real(robots=64, ticks=10, reps=3, localize=True,
                       relax_budget=16):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from functools import partial
    from dataclasses import replace
    from tools import parity_reference as pr
    if not pr.assets_available():
        raise PhaseNotRun("reference assets not mounted")
    from dddmr_navigation_tpu.config import (
        LocalPlannerConfig, DDSimpleGeneratorConfig, MoveBaseConfig,
        MCLConfig, SpinningLidarConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io.maps import box_obstacle
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, make_fused_tick)
    from dddmr_navigation_tpu.parallel.fleet import (
        init_fleet_full_state, fleet_full_tick)
    from dddmr_navigation_tpu.state_estimation.likelihood import (
        build_submap_context)

    ctx = pr.load_context()
    base = ctx.cfg
    lidar = replace(base.perception.lidar,
                    scan_effective_positive_start=0.0,
                    scan_effective_negative_start=0.0,
                    max_scan_points=2048)
    cfg = replace(
        base,
        perception=replace(base.perception, lidar=lidar,
                           voxel_window_cells_xy=64,
                           voxel_window_cells_z=24, max_marked_voxels=512,
                           # the 6.4 m window + inflation covers ~70 m^2;
                           # at the real map's ~10 nodes/m^2 that is ~700
                           # nodes, so 2048 is 3x headroom — the 8192
                           # default quadruples the dgraph pairwise
                           # matrices and the per-robot top_k for nothing
                           max_window_nodes=2048,
                           # decide connectivity on the reference's own
                           # 0.1 m cluster lattice (config4 already does;
                           # fine-grid CCL was ~23 ms of this tick)
                           cluster_pool=2),
        local_planner=replace(
            base.local_planner,
            generator=replace(base.local_planner.generator,
                              linear_x_sample=16, angular_z_sample=16,
                              max_num_steps=40),
            max_obstacle_points=512, collision_obstacle_chunk=16,
            collision_near_k=128),
        global_planner=replace(base.global_planner,
                               turning_weight=0.0,       # see header note
                               max_long_edges=2048, los_samples=8,
                               max_lethal_points=1024,
                               max_relax_iters=1024,
                               # 64 robots' moving marks on a 27k-node
                               # field can cascade hundreds of warm
                               # repair iterations per tick (measured
                               # 430); the per-tick budget amortizes
                               # them — still fresher than the
                               # reference's <=5 Hz async replan
                               relax_iters_per_tick=relax_budget))
    mb = MoveBaseConfig()
    mcl_cfg = MCLConfig(num_particles=60, init_var_x=0.3, init_var_y=0.3,
                        init_var_z=0.1, init_var_yaw=0.1,
                        field_sampling="corr")

    ground = ctx.ground
    fmap = build_fused_map(cfg, ground, ctx.map_pts,
                           node_weight=ctx.node_weight,
                           static_dgraph=ctx.static_dgraph,
                           intensity=ctx.ground_intensity)
    submap = build_submap_context(ctx.map_pts, ground, mcl_cfg,
                                  res=0.25) if localize else None
    _, spec, ri_spec, params = make_fused_tick(cfg)

    b = robots
    pairs = pr.pick_start_goal_pairs(ctx, b, seed=3, min_separation=20.0)
    assert len(pairs) == b, f"only {len(pairs)} valid start/goal pairs"
    positions = ctx.ground[[s for s, _ in pairs]].copy()
    goals = ctx.ground[[t for _, t in pairs]].copy()
    quats = np.broadcast_to(
        np.asarray(quat_from_yaw(jnp.float32(0.0))), (b, 4)).copy()
    n_pad = cfg.perception.lidar.max_scan_points
    scans = np.zeros((b, n_pad, 3), np.float32)
    masks = np.zeros((b, n_pad), bool)
    for i in range(b):
        box = box_obstacle([positions[i, 0] + 0.8, positions[i, 1] + 0.55,
                            positions[i, 2]], size=(0.2, 0.2, 1.0),
                           resolution=0.1)
        rel = box - (positions[i] + [0, 0, 0.3])
        scans[i, :len(rel)] = rel[:n_pad]
        masks[i, :min(len(rel), n_pad)] = True
    state0 = init_fleet_full_state(cfg, len(ground), positions, quats,
                                   localize=localize, mcl_cfg=mcl_cfg)
    offset = jnp.asarray([0.0, 0.0, 0.3])
    drift_dir = np.tile(np.array([[0.7, 0.7, 0.0]], np.float32), (b, 1))
    mapj = jnp.asarray(ctx.map_pts)
    groundj = jnp.asarray(np.asarray(ground, np.float32))

    tick = partial(fleet_full_tick, cfg, mb, spec, ri_spec, params,
                   mcl_cfg=(mcl_cfg if localize else None))

    def body_of(fmap_a, submap_a, scans_a, masks_a, goals_a):
        def body(c, t):
            now = t.astype(jnp.float32) * 0.1
            drift = (0.01 * t.astype(jnp.float32))[None, None] \
                * jnp.asarray(drift_dir)
            s2, diag = tick(fmap_a, c, scans_a, masks_a, offset, goals_a,
                            now, jnp.float32(0.1), submap_ctx=submap_a,
                            odom_drift_pos=drift,
                            odom_drift_yaw=jnp.zeros((b,)),
                            feature_map_pts=mapj,
                            feature_ground_pts=groundj)
            from dddmr_navigation_tpu.planning.local.planner import (
                PlannerState)
            found = jnp.sum(
                (diag["ps_simple"] == int(PlannerState.TRAJECTORY_FOUND))
                .astype(jnp.int32))
            ok = jnp.sum(diag["plan_ok"].astype(jnp.int32))
            err = (jnp.max(diag["mcl_err"]) if localize
                   else jnp.float32(0.0))
            errm = (jnp.mean(diag["mcl_err"]) if localize
                    else jnp.float32(0.0))
            return s2, (diag["vx"][0] + found.astype(jnp.float32), found,
                        ok, err, errm, jnp.max(diag["wf_iters"]))
        return body

    @jax.jit
    def warm_one(fmap_a, submap_a, states, scans_a, masks_a, goals_a):
        s1, _ = body_of(fmap_a, submap_a, scans_a, masks_a, goals_a)(
            states, jnp.asarray(0))
        return s1

    @jax.jit
    def warm_chain(fmap_a, submap_a, states, scans_a, masks_a, goals_a):
        # untimed convergence warm-up: with a per-tick relaxation budget
        # the 64 distinct goal fields need cumulative-budget iterations
        # to reach their robots; the steady 10 Hz loop is timed AFTER the
        # fleet is navigating (plans held), like config3_real's split
        final, outs = jax.lax.scan(
            body_of(fmap_a, submap_a, scans_a, masks_a, goals_a),
            states, 1 + jnp.arange(30))
        return final, outs[2][-1]

    @jax.jit
    def run(fmap_a, submap_a, states, scans_a, masks_a, goals_a):
        final, outs = jax.lax.scan(
            body_of(fmap_a, submap_a, scans_a, masks_a, goals_a),
            states, 1 + jnp.arange(ticks))
        return outs

    scans_j, masks_j, goals_j = (jnp.asarray(scans), jnp.asarray(masks),
                                 jnp.asarray(goals))
    cold_args = (fmap, submap, state0, scans_j, masks_j, goals_j)
    t0 = time.perf_counter()
    state1 = jax.block_until_ready(warm_one(*cold_args))
    warm_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state1 = jax.block_until_ready(warm_one(*cold_args))
    cold_tick_ms = 1e3 * (time.perf_counter() - t0)
    warm_compile_s -= cold_tick_ms / 1e3
    warm_ticks = 1
    for _ in range(4):           # up to 121 warm ticks for budgeted fields
        state1, ok_now = warm_chain(fmap, submap, state1, scans_j, masks_j,
                                    goals_j)
        warm_ticks += 30
        if int(np.asarray(ok_now)) >= b - 3:
            break

    def make_args():
        return (fmap, submap, state1, scans_j, masks_j, goals_j)

    compile_s, per_tick, out = _time_chains(run, make_args, ticks, reps)
    stats = _tick_stats(per_tick)
    p99_s = stats["p99_tick_ms"] / 1e3
    s_padded = cfg.local_planner.generator.n_samples_padded
    return {
        **stats,
        "cold_tick_ms": round(cold_tick_ms, 1),
        "warm_compile_s": round(warm_compile_s, 1),
        "compile_s": round(compile_s, 1),
        "robots": b,
        "map": "reference ground.pcd/map.pcd",
        "shared_map_nodes": len(ground),
        "map_points": len(ctx.map_pts),
        "rollouts_per_tick": b * s_padded,
        "robots_at_10hz_per_chip": round(b / p99_s / 10.0, 1),
        "relax_budget_per_tick": relax_budget,
        "warm_ticks_before_timing": warm_ticks,
        "goals": "64 distinct, >=20 m away, mixed directions",
        "fidelity": ("mcl(60p corr, drifting odom, real map) + mark/clear "
                     "+ wavefront(w_turn=0 fleet relax, see "
                     "turning_cost_delta) + LOS(real 2k long edges) + FSM "
                     "+ rotate recovery"),
        "found_last_tick": int(np.asarray(out[1])[-1]),
        "plan_ok_last_tick": int(np.asarray(out[2])[-1]),
        "warm_wf_iters_last_tick": int(np.asarray(out[5])[-1]),
        "mcl_err_last_tick": round(float(np.asarray(out[3])[-1]), 3),
        "mcl_err_mean_last_tick": round(float(np.asarray(out[4])[-1]), 3),
        "turning_cost_delta_pct": _turning_cost_delta(ctx, pairs[:3]),
    }


def _turning_cost_delta(ctx, pairs):
    """Reference-metric (θ-inclusive) path-cost delta of w_turn=0 plans vs
    the full direction-expanded solver, on sample pairs of the real map —
    the measured price of the fleet's node-table relaxation."""
    import numpy as np
    from dataclasses import replace
    from dddmr_navigation_tpu.planning.global_.runtime import (
        GlobalPlannerRuntime)

    w_turn = ctx.cfg.global_planner.turning_weight
    inscribed = ctx.cfg.perception.inscribed_radius
    rate = ctx.cfg.perception.inflation_descending_rate
    enter = np.where(
        ctx.static_dgraph < inscribed, np.inf,
        np.exp(-rate * (ctx.static_dgraph - inscribed)) + ctx.node_weight)
    avg_i = np.asarray(ctx.graph.avg_intensity)

    def ref_cost(path):
        # `a_star_on_pc.cpp:278-288`: step + enter(succ) + intensity(src)
        # + w_turn * theta(parent, cur, succ) with the capped dead zone
        from dddmr_navigation_tpu.planning.global_.wavefront import (
            theta_reference)
        import jax.numpy as jnp
        c = 0.0
        for k in range(len(path) - 1):
            u, v = path[k], path[k + 1]
            c += (np.linalg.norm(ctx.ground[u] - ctx.ground[v])
                  + enter[v] + avg_i[u])
            if k > 0:
                c += w_turn * float(theta_reference(
                    jnp.asarray(ctx.ground[path[k - 1]]),
                    jnp.asarray(ctx.ground[u]),
                    jnp.asarray(ctx.ground[v])))
        return c

    deltas = []
    for s, t in pairs:
        costs = {}
        for w in (w_turn, 0.0):
            cfg_w = replace(ctx.cfg, global_planner=replace(
                ctx.cfg.global_planner, turning_weight=w))
            rt = GlobalPlannerRuntime(cfg_w, ctx.ground,
                                      node_weight=ctx.node_weight,
                                      intensity=ctx.ground_intensity)
            res = rt.plan_result(ctx.ground[s], ctx.ground[t],
                                 ctx.static_dgraph)
            if not bool(res.ok):
                break
            ids = [int(i) for i in
                   np.asarray(res.node_ids)[np.asarray(res.node_valid)]]
            costs[w] = ref_cost(ids)
        if len(costs) == 2 and np.isfinite(list(costs.values())).all():
            deltas.append(100.0 * (costs[0.0] - costs[w_turn])
                          / max(costs[w_turn], 1e-9))
    return round(float(np.mean(deltas)), 2) if deltas else None
# GN → scan-to-map GN (the steady-state per-scan device work of
# slam/pipeline.py), vs the reference's 10 Hz real-time budget
# (`mapOptimization.cpp:2029` run loop, 16-line lidar at 10 Hz;
# `imageProjection.cpp:309`). Host-side keyframe insertion/submap rebuild
# happens every ~1 m (≈20 scans at 0.5 m/s) and is reported separately, as
# is loop-closure verification latency (ICP + batch pose-graph re-opt).
# ---------------------------------------------------------------------------

def bench_slam(ticks=20, reps=4, icp_reps=8):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from functools import partial
    from dddmr_navigation_tpu.config import SlamConfig
    from dddmr_navigation_tpu.utils import BoxWorld, simulate_scan
    from dddmr_navigation_tpu.slam import (
        project, extract_features, match_scans, match_to_map,
        icp_point2point)
    from dddmr_navigation_tpu.slam import pose_graph as pg
    from dddmr_navigation_tpu.geometry import quat_rotate

    cfg = SlamConfig()          # canonical 16 x 1000 projection
    world = BoxWorld.room(half=8.0) \
        .add_box([3.0, -1.5, 0], [3.6, 0.5, 1.8]) \
        .add_box([-2.0, 2.0, 0], [-1.2, 2.6, 1.4])
    n_pad = cfg.num_vertical_scans * cfg.num_horizontal_scans

    # trajectory of sweeps (ticks scans at ~10 Hz, 0.4 m/s => 4 cm/scan)
    scans = np.zeros((ticks, n_pad, 3), np.float32)
    masks = np.zeros((ticks, n_pad), bool)
    for t in range(ticks):
        pos = [0.04 * t, 0.01 * t, 0.8]
        pts, m = simulate_scan(world, pos, 0.005 * t, n_rings=16,
                               n_cols=1000)
        scans[t, :len(pts)] = pts
        masks[t, :len(pts)] = m

    feats_fn = jax.jit(partial(
        lambda c, p, m: extract_features(c, project(c, p, m)), cfg))
    ref = jax.block_until_ready(feats_fn(jnp.asarray(scans[0]),
                                         jnp.asarray(masks[0])))

    # fixed submap in map frame (the accumulated surrounding-keyframe
    # clouds; steady-state content stands in for the rebuilt queue)
    sub_sharp = jnp.asarray(np.asarray(ref.less_sharp))
    sub_sharp_m = jnp.asarray(np.asarray(ref.less_sharp_mask))
    sub_flat = jnp.asarray(np.asarray(ref.less_flat))
    sub_flat_m = jnp.asarray(np.asarray(ref.less_flat_mask))

    @jax.jit
    def run(scans, masks, ref_feats, pos0, quat0):
        def body(carry, scan_in):
            pos, quat = carry
            pts, m = scan_in
            f = extract_features(cfg, project(cfg, pts, m))
            p1, q1, _ = match_scans(
                cfg, f.sharp, f.sharp_mask, f.less_flat[::4],
                f.less_flat_mask[::4], ref_feats.less_sharp,
                ref_feats.less_sharp_mask, ref_feats.less_flat,
                ref_feats.less_flat_mask, init_pos=pos, init_quat=quat,
                tgt_less_sharp_ring=ref_feats.less_sharp_ring,
                tgt_less_flat_ring=ref_feats.less_flat_ring)
            p2, q2, _ = match_to_map(
                cfg, f.sharp, f.sharp_mask, f.less_flat[::4],
                f.less_flat_mask[::4], sub_sharp, sub_sharp_m, sub_flat,
                sub_flat_m, init_pos=p1, init_quat=q1,
                iters=cfg.map_match_iters)
            return (p2, q2), p2[0]
        (pos, quat), xs = jax.lax.scan(
            body, (pos0, quat0), (scans, masks))
        return xs[-1], pos, quat

    def make_args():
        return (jnp.asarray(scans), jnp.asarray(masks), ref,
                jnp.zeros(3), jnp.asarray([0.0, 0, 0, 1.0]))

    compile_s, per_tick, out = _time_chains(run, make_args, ticks, reps)
    stats = _tick_stats(per_tick)
    scans_per_s = 1.0 / (stats["tick_ms"] / 1e3)

    # loop-closure verification latency: ICP between two keyframes + a
    # batch pose-graph re-optimization, amortized over a chained dispatch
    f2 = jax.block_until_ready(feats_fn(jnp.asarray(scans[-1]),
                                        jnp.asarray(masks[-1])))
    cloud_c = jnp.concatenate([np.asarray(f2.less_flat),
                               np.asarray(f2.less_sharp)])
    mask_c = jnp.concatenate([np.asarray(f2.less_flat_mask),
                              np.asarray(f2.less_sharp_mask)])
    cloud_h = jnp.concatenate([np.asarray(ref.less_flat),
                               np.asarray(ref.less_sharp)])
    mask_h = jnp.concatenate([np.asarray(ref.less_flat_mask),
                              np.asarray(ref.less_sharp_mask)])
    graph = pg.empty_graph(64, 128)
    for i in range(16):
        graph = pg.add_node(graph, i, jnp.asarray([0.5 * i, 0.0, 0.0]),
                            jnp.asarray([0.0, 0, 0, 1.0]))
        if i:
            graph = pg.add_edge(graph, i - 1, i - 1, i,
                                jnp.asarray([0.5, 0, 0]),
                                jnp.asarray([0.0, 0, 0, 1.0]), weight=1.0)

    @jax.jit
    def loop_run(cloud_c, mask_c, cloud_h, mask_h, graph):
        def body(carry, _):
            pos, quat, fit = icp_point2point(
                cloud_c, mask_c, cloud_h, mask_h, 10, 2.0,
                jnp.zeros(3) + carry * 1e-9, jnp.asarray([0.0, 0, 0, 1.0]))
            g2 = pg.optimize_pose_graph(graph, 30)
            return fit, (pos[0], g2.pos[0, 0])
        fit, xs = jax.lax.scan(body, jnp.float32(0.0), None,
                               length=icp_reps)
        return xs[0][-1], fit
    t0 = time.perf_counter()
    jax.block_until_ready(loop_run(cloud_c, mask_c, cloud_h, mask_h, graph))
    loop_compile_s = time.perf_counter() - t0
    loop_ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop_run(cloud_c, mask_c, cloud_h, mask_h, graph))
        loop_ts.append((time.perf_counter() - t0) / icp_reps)

    import numpy as np
    return {
        **stats,
        "scans_per_s": round(scans_per_s, 1),
        "projection": f"{cfg.num_vertical_scans}x{cfg.num_horizontal_scans}",
        "stages": ("project -> features -> scan-to-keyframe GN -> "
                   "scan-to-map GN (steady-state per-scan device work)"),
        # the reference consumes a 16-line lidar at 10 Hz in real time on
        # a Jetson (`mapOptimization.cpp:2029`); realtime factor >1 means
        # faster than the sensor produces sweeps
        "realtime_factor_vs_10hz": round(scans_per_s / 10.0, 1),
        "loop_closure_ms": round(1e3 * float(np.median(loop_ts)), 1),
        "loop_closure_stages": ("ICP verify (10 iters) + 16-node batch "
                                "pose-graph re-opt (30 iters)"),
        "host_note": ("keyframe insertion + submap rebuild run host-side "
                      "every ~1 m (~20 scans); loop closures at their own "
                      "cadence (`mapOptimization.cpp` loopClosureThread)"),
        "compile_s": round(compile_s + loop_compile_s, 1),
    }


# ---------------------------------------------------------------------------
# Semantic segmentation inference: the committed 19-class DDRNet-style
# artifact at its training resolution (240x320), vs the reference's ONLY
# published perf numbers — 15 fps on Orin Nano / 19 fps on Orin AGX for
# its TensorRT DDRNet (`dddmr_semantic_segmentation/README.md:18-21`).
# ---------------------------------------------------------------------------

def bench_semantic(frames=50, reps=4):
    import numpy as np
    try:
        import flax  # noqa: F401 — semantic engine is flax-gated
    except ImportError:
        raise PhaseNotRun("flax not installed") from None
    import json as _json
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.perception.semantic import (
        init_segmenter, infer_classes, load_params)

    art = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "artifacts", "semantic_ddrnet19.npz")
    if not os.path.exists(art):
        raise PhaseNotRun("no committed artifact")
    meta = _json.load(open(art + ".json"))
    h, w = meta["image_hw"]
    model, template = init_segmenter(
        jax.random.PRNGKey(0), height=h, width=w,
        num_classes=meta["num_classes"], net_width=meta["net_width"])
    params = load_params(art, template)

    rng = np.random.default_rng(0)
    out = {"image_hw": [h, w], "num_classes": meta["num_classes"],
           "miou_heldout": meta.get("miou_heldout"),
           "reference_fps": {"orin_nano": 15, "orin_agx": 19},
           "reference_src": "dddmr_semantic_segmentation/README.md:18-21"}
    for batch in (1, 8):
        frames_np = rng.uniform(0, 1, size=(frames, batch, h, w, 3)
                                ).astype(np.float32)

        @jax.jit
        def run(params, frames_in):
            def body(acc, rgb):
                cls = infer_classes(model, params, rgb)
                return acc + cls[0, 0, 0], cls[0, 0, 0]
            acc, xs = jax.lax.scan(body, jnp.int32(0), frames_in)
            return acc, xs

        def make_args():
            return (params, jnp.asarray(frames_np))
        compile_s, per_tick, _o = _time_chains(run, make_args, frames, reps)
        stats = _tick_stats(per_tick)
        fps = batch / (stats["tick_ms"] / 1e3)
        out[f"batch{batch}"] = {
            "frame_ms": round(stats["tick_ms"] / batch, 3),
            "fps": round(fps, 1),
            "vs_orin_agx_19fps": round(fps / 19.0, 1),
            "compile_s": round(compile_s, 1),
        }
    return out


# ---------------------------------------------------------------------------
# Solo MCL: one robot's 60-particle measurement/resample update on the
# REAL reference map (ground.pcd/map.pcd), vs the reference's 10 Hz odom
# cadence (`mcl_3dl.cpp:143-234`, 60 particles per the canonical YAML).
# Both the reference-faithful per-particle sampling ('trilinear') and the
# fleet-scale correspondence-cached mode ('corr') are timed.
# ---------------------------------------------------------------------------

def bench_mcl(ticks=30, reps=4):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from functools import partial
    from dataclasses import replace
    from dddmr_navigation_tpu.config import MCLConfig
    from dddmr_navigation_tpu.state_estimation.likelihood import (
        build_submap_context)
    from dddmr_navigation_tpu.state_estimation.mcl import init_mcl, mcl_update
    from dddmr_navigation_tpu.parallel.fleet import device_features_from_map
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from tools import parity_reference as pr

    if pr.assets_available():
        ctx_src = pr.load_context()
        map_pts, ground_pts = ctx_src.map_pts, ctx_src.ground
        map_name = "reference map.pcd/ground.pcd"
        res = 0.25           # 124 m map within the 512-cell EDT cap
    else:
        from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
        ground_pts = flat_ground_map(12, 8, 0.25)
        map_pts = box_obstacle([0.0, 3.6, 0.0], size=(11.0, 0.3, 1.2),
                               resolution=0.15).astype(np.float32)
        map_name = "synthetic (reference assets not mounted)"
        res = 0.15

    base = MCLConfig(num_particles=60, init_var_x=0.3, init_var_y=0.3,
                     init_var_z=0.1, init_var_yaw=0.1)
    pose = np.asarray(ground_pts[len(ground_pts) // 2], np.float32)
    quat = np.asarray(quat_from_yaw(jnp.float32(0.3)))
    wallsj = jnp.asarray(np.asarray(map_pts, np.float32))
    groundj = jnp.asarray(np.asarray(ground_pts, np.float32))
    flat, fok, sharp, sok = device_features_from_map(
        wallsj, groundj, jnp.asarray(pose), jnp.asarray(quat))

    out = {"map": map_name, "ground_nodes": len(ground_pts),
           "map_points": len(map_pts), "particles": 60,
           "field_res_m": res}
    for mode in ("trilinear", "corr"):
        cfg = replace(base, field_sampling=mode)
        ctx = build_submap_context(np.asarray(map_pts),
                                   np.asarray(ground_pts), cfg, res=res,
                                   with_nearest=(mode == "corr"))
        st0 = init_mcl(jax.random.PRNGKey(0), cfg, jnp.asarray(pose),
                       jnp.asarray(quat))
        step = partial(mcl_update, cfg)

        @jax.jit
        def run(ctx, st, flat, fok, sharp, sok):
            def body(s, t):
                # constant small odom increment (typical gated update)
                dp = jnp.asarray([0.1, 0.0, 0.0])
                s2, o = step(ctx, s, jnp.asarray(pose),
                             jnp.asarray(quat), jnp.asarray(pose) + dp,
                             jnp.asarray(quat), jnp.asarray(0.1),
                             flat, fok, sharp, sok,
                             jnp.ones(sharp.shape[0]))
                return s2, o.pose_pos[0]
            final, xs = jax.lax.scan(body, st, jnp.arange(ticks))
            return xs[-1], final.particles.pos

        def make_args():
            return (ctx, st0, flat, fok, sharp, sok)
        compile_s, per_tick, _o = _time_chains(run, make_args, ticks, reps)
        stats = _tick_stats(per_tick)
        out[mode] = {
            "update_ms": round(stats["tick_ms"], 3),
            "p99_update_ms": round(stats["p99_tick_ms"], 3),
            "updates_per_s": round(1e3 / stats["tick_ms"], 1),
            "compile_s": round(compile_s, 1),
        }
    # vs-reference framing: the reference runs ONE 60-particle update per
    # motion-gated odom sample (<=10 Hz) per machine
    out["robots_at_10hz_equiv"] = round(
        1e3 / out["trilinear"]["update_ms"] / 10.0, 1)
    return out


# ---------------------------------------------------------------------------
# scaling
# ---------------------------------------------------------------------------

def bench_batch_scaling(sizes=(8, 16, 32, 64, 128), ticks=50, reps=4):
    """Single-card batch scaling with the latency-floor decomposition:
    tick time is fitted as t(B) = t0 + m·B, where t0 is the per-tick floor
    (sequential small-stage op latency — prune/sampler/argmin chains whose
    per-op cost doesn't shrink with batch) and m the marginal cost per
    robot. Where t0 dominates, widening the batch 8× cannot gain 8×."""
    import numpy as np
    rows = {}
    for b in sizes:
        r = bench_headline(robots=b, ticks=ticks, reps=reps)
        rows[b] = {"tick_ms": round(r["tick_ms"], 3),
                   "rollouts_per_s": round(r["rollouts_per_s"])}
    bs = np.asarray(sorted(rows), np.float64)
    ts = np.asarray([rows[int(b)]["tick_ms"] for b in bs])
    m, t0 = np.polyfit(bs, ts, 1)
    pred = t0 + m * bs
    ss_res = float(np.sum((ts - pred) ** 2))
    ss_tot = float(np.sum((ts - ts.mean()) ** 2))
    small, large = int(bs[0]), 64 if 64 in rows else int(bs[-1])
    return {
        "per_batch": rows,
        "fit_t0_ms": round(float(t0), 3),
        "fit_marginal_ms_per_robot": round(float(m), 4),
        "fit_r2": round(1.0 - ss_res / max(ss_tot, 1e-12), 4),
        "floor_fraction_at_B8": round(float(t0 / (t0 + m * 8)), 3),
        "throughput_ratio_8_to_64": round(
            rows[large]["rollouts_per_s"]
            / max(rows[small]["rollouts_per_s"], 1), 2),
        "ideal_ratio_if_floor_free": large / small,
        "note": ("t(B) = t0 + m*B; the per-tick floor t0 bounds small-"
                 "batch throughput"),
    }


PHASES = {
    "config2": bench_config2,
    "config3": bench_config3,
    "config3_real": bench_config3_real,
    "config4": bench_config4,
    "config4_real": bench_config4_real,
    "config4_budgeted": lambda: bench_config4(relax_budget=8),
    "slam": bench_slam,
    "semantic": bench_semantic,
    "mcl": bench_mcl,
    "batch_scaling": bench_batch_scaling,
    "collision": bench_collision_stage,
}


def main():
    import argparse
    from dddmr_navigation_tpu.jax_setup import (
        gpu_name_and_power_limit, require_gpu)
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", nargs="*", default=[], choices=list(PHASES))
    ap.add_argument("--only", default=None, choices=["headline"] + list(PHASES),
                    help="run a single phase")
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    if args.only is not None:
        args.skip = [k for k in PHASES if k != args.only]

    jax = _setup_jax()
    dev = require_gpu()
    card = gpu_name_and_power_limit()
    print(f"device: {dev.platform} {dev.device_kind}; nvidia-smi: {card}",
          file=sys.stderr)

    head = None
    if args.only in (None, "headline"):
        head = bench_headline(ticks=args.ticks, reps=args.reps, analyze=True)
        print(f"headline: {head['rollouts_per_s']:,.0f} rollouts/s "
              f"tick={head['tick_ms']:.2f}ms compile={head['compile_s']}s",
              file=sys.stderr)

    extras, not_run, failed = {}, {}, {}
    for name, fn in PHASES.items():
        if name in args.skip:
            continue
        try:
            extras[name] = fn()
        except PhaseNotRun as e:
            not_run[name] = str(e)
        except Exception as e:
            # record and go on to the next phase; the run still fails below
            traceback.print_exc()
            failed[name] = f"{type(e).__name__}: {e}"[:300]
        else:
            print(f"{name}: {extras[name]}", file=sys.stderr)

    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": card},
        "not_run": not_run,
        "failed": failed,
        **extras,
    }
    if head is not None:
        out = {
            "metric": "rollouts_per_s",
            "value": round(head["rollouts_per_s"]),
            "unit": "rollouts/s",
            "vs_baseline": round(head["rollouts_per_s"]
                                 / BASELINE_ROLLOUTS_PER_S, 2),
            "tick_ms": round(head["tick_ms"], 3),
            "p99_tick_ms": round(head["p99_tick_ms"], 3),
            "tick_ms_note": ("scan-amortized time per tick; p99 over "
                             "per-chain means, not per tick"),
            "rollouts_per_tick": head["rollouts_per_tick"],
            "robots": head["robots"],
            "tick_budget_ms": TICK_BUDGET_MS,
            "tick_under_budget": bool(head["tick_ms"] < TICK_BUDGET_MS),
            "compile_s": head["compile_s"],
            "roofline": head["roofline"],
            **out,
        }
    print(json.dumps(out))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
