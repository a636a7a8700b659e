"""Smoke run of the navigation stack on one NVIDIA GPU.

Drives the main path through its public entry points at the widths the
benchmark uses, and compares the first tick of the fused vertical and of
the 64-robot fleet with the same program run on the CPU in this process:

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # phase 6 only: 4x64 robots sharded
                                    # over four cards vs one card

Phases: 1 device, 2 single-robot session, 3 fused vertical at config-3
widths, 4 full-fidelity fleet at config-4 widths, 5 comparison with the
CPU, 6 (``--four``) the sharded fleet. Any failure exits non-zero. The
last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the run stops in phase 1 and prints no result.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# --- comparison tolerances, GPU against CPU (or sharded against one card)
# vx / wz of the same chosen sample: grid values from the same sampler
# arithmetic, equal up to f32 rounding.
CMD_TOL = 1e-4
# Best rollout cost: a sum of critic terms over up to 40 steps; the two
# backends reduce in other orders, so equal costs differ in the last bits.
# Two samples whose costs agree this closely are a tie, and either is a
# correct argmin.
COST_RTOL = 1e-4
# Distance fields, as (rtol, atol). The wavefront carry is a minimum over
# f32 path sums, whose additions the backends round alike up to ulps. The
# dGraph (perception/marking.py) takes sqrt(|a|^2 + |b|^2 - 2 a.b) at
# window coordinates of a few metres: near zero distance the cancellation
# leaves sqrt(eps * |a|^2), up to ~1e-3 m, which fused multiply-adds on
# the GPU round differently from the CPU.
FIELD_TOL = {"wf_dist": (1e-5, 1e-5), "dgraph": (1e-5, 1e-3)}
# MCL pose estimate (the pose the robot plans from): a weighted mean of 60
# particles whose weights come from exp() of summed likelihoods.
MCL_TOL_M = 1e-3

# outputs that must be equal: planner state, FSM decision and command
# source, plan success and plan length
DISCRETE = ("state", "decision", "cmd_source", "ps_rotate", "plan_ok",
            "plan_len")
# (chosen sample, its cost) of each generator
PICKS = (("best_index", "best_cost"), ("rot_index", "rot_cost"))


def compare_tick(label, acc, ref):
    """Compare one tick's outputs, ``acc`` (the device under test) against
    ``ref``. Both map names to arrays with a leading robot axis. Prints the
    largest difference of each continuous output and every mismatch;
    returns the list of failures (empty when the tick agrees)."""
    fails = []
    n = len(next(iter(acc.values())))
    for k in DISCRETE:
        if k not in acc:
            continue
        bad = np.nonzero(np.asarray(acc[k]) != np.asarray(ref[k]))[0]
        for r in bad:
            fails.append(f"{label} robot {r}: {k} {acc[k][r]} vs {ref[k][r]}")
    same_pick = np.ones(n, bool)
    for ik, ck in PICKS:
        if ik not in acc:
            continue
        ca, cr = np.asarray(acc[ck], np.float64), np.asarray(ref[ck],
                                                             np.float64)
        tie = np.isclose(ca, cr, rtol=COST_RTOL, atol=COST_RTOL)
        moved = np.asarray(acc[ik]) != np.asarray(ref[ik])
        for r in np.nonzero(moved | ~tie)[0]:
            msg = (f"{label} robot {r}: {ik} {acc[ik][r]} vs {ref[ik][r]}, "
                   f"{ck} {ca[r]!r} vs {cr[r]!r}")
            if tie[r]:
                print(f"  tied argmin: {msg}")
            else:
                fails.append(msg + " (costs do not tie)")
        _report(label, ck, np.abs(ca - cr))
        same_pick &= ~moved
    for k in ("vx", "wz"):
        d = np.abs(np.asarray(acc[k], np.float64) - np.asarray(ref[k]))
        _report(label, k, d)
        for r in np.nonzero(same_pick & (d > CMD_TOL))[0]:
            fails.append(f"{label} robot {r}: {k} {acc[k][r]!r} vs "
                         f"{ref[k][r]!r} for the same sample")
    for k, (rtol, atol) in FIELD_TOL.items():
        if k not in acc:
            continue
        a, b = np.asarray(acc[k], np.float64), np.asarray(ref[k], np.float64)
        close = np.isclose(a, b, rtol=rtol, atol=atol)
        finite = np.isfinite(a) & np.isfinite(b)
        _report(label, k, np.abs(np.where(finite, a, 0.0)
                                 - np.where(finite, b, 0.0)))
        if not close.all():
            i = np.unravel_index(np.argmin(close), close.shape)
            fails.append(f"{label}: {k} differs at {i}: {a[i]!r} vs {b[i]!r} "
                         f"({int(np.sum(~close))} entries)")
    if "mcl_pos" in acc:
        d = np.linalg.norm(np.asarray(acc["mcl_pos"], np.float64)
                           - np.asarray(ref["mcl_pos"]), axis=-1)
        _report(label, "mcl_pos", d)
        for r in np.nonzero(d > MCL_TOL_M)[0]:
            fails.append(f"{label} robot {r}: MCL pose off by {d[r]:.3g} m")
    return fails


def _report(label, key, diff):
    print(f"  {label} max |d {key}| = {float(np.max(diff, initial=0.0))!r}")


def _fused_record(state, out):
    rec = {"state": out.state, "plan_ok": out.plan_ok,
           "plan_len": out.plan.count, "best_index": out.best_index,
           "best_cost": out.best_cost, "vx": out.vx, "wz": out.wz,
           "dgraph": out.composed_dgraph, "wf_dist": state.wf_dist}
    return {k: np.asarray(v)[None] for k, v in rec.items()}


def _fleet_record(state, diag):
    rec = {"state": diag["ps_simple"], "mcl_pos": diag["plan_pos"],
           "dgraph": state.fused.marking.dgraph,
           "wf_dist": state.fused.wf_dist}
    for k in ("decision", "cmd_source", "ps_rotate", "plan_ok", "plan_len",
              "best_index", "best_cost", "rot_index", "rot_cost", "vx",
              "wz"):
        rec[k] = diag[k]
    return {k: np.asarray(v) for k, v in rec.items()}


def _memory(compiled):
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def _ms(t0):
    return 1e3 * (time.perf_counter() - t0)


def phase_device():
    import jax
    from dddmr_navigation_tpu.jax_setup import (
        gpu_name_and_power_limit, require_gpu)
    dev = require_gpu()
    print(f"phase 1 device: {dev.device_kind}, {len(jax.devices())} "
          f"device(s)")
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")
    return dev


def phase_session(ticks=20):
    """The toggling-wall scene of examples/run_navigation_session.py
    through `NavigationSession.tick`."""
    import dataclasses
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import (
        NavigationConfig, PerceptionConfig, SpinningLidarConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io import flat_ground_map
    from dddmr_navigation_tpu.control.session import NavigationSession
    from dddmr_navigation_tpu.utils.lidar_sim import BoxWorld, simulate_scan

    lidar = SpinningLidarConfig(
        xy_resolution=0.1, height_resolution=0.1,
        range_image_rows=32, range_image_cols=360,
        vertical_FOV_bottom=-40.0, vertical_FOV_top=40.0,
        scan_effective_positive_start=0.0,
        scan_effective_positive_end=180.0,
        scan_effective_negative_start=0.0,
        scan_effective_negative_end=-180.0)
    cfg = dataclasses.replace(
        NavigationConfig(),
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=72,
                                    voxel_window_cells_z=24))
    sess = NavigationSession(cfg, flat_ground_map(14, 8, 0.2))
    room = BoxWorld.room(half=6.0, wall_h=1.5)
    walled = BoxWorld.room(half=6.0, wall_h=1.5)
    walled.add_box([-0.1, -1.4, 0.0], [0.1, 1.4, 1.2])
    sess.set_goal(np.array([3.5, 0.0, 0.0], np.float32))
    pos = np.array([-3.0, 0.0, 0.0], np.float32)
    yaw, v, w, dt, moved = 0.0, 0.0, 0.0, 0.1, 0
    tick_ms = []
    for i in range(ticks):
        now = i * dt
        # the example's wall period compressed to 2 s, so that 20 ticks
        # see the wall both up and down
        world = walled if (i // 10) % 2 == 0 else room
        pts, mask = simulate_scan(world, pos + [0, 0, 0.5], sensor_yaw=yaw,
                                  n_rings=24, n_cols=240, v_bottom=-40.0,
                                  v_top=40.0, max_range=15.0)
        mask = mask & (pts[:, 2] + 0.5 >= 0.15)
        quat = np.asarray(quat_from_yaw(jnp.float32(yaw)))
        t0 = time.perf_counter()
        v, w, dec, done, _ok = sess.tick(pts, mask, pos, quat, v, w, now)
        tick_ms.append(_ms(t0))
        moved += abs(v) + abs(w) > 0.0
        pos = pos + np.array([v * np.cos(yaw) * dt, v * np.sin(yaw) * dt,
                              0.0], np.float32)
        yaw = float(yaw + w * dt)
        if done:
            break
    plan = sess.driver.plan
    plan_len = 0 if plan is None else int(plan.count)
    print(f"phase 2 session: {i + 1} ticks, first {tick_ms[0]:.0f} ms "
          f"(compiles), median of the rest {np.median(tick_ms[1:]):.1f} ms, "
          f"plan {plan_len} poses, {moved} ticks with non-zero cmd_vel, "
          f"pos ({pos[0]:+.2f}, {pos[1]:+.2f})")
    if plan_len == 0 or moved == 0:
        raise RuntimeError(f"session made no plan ({plan_len} poses) or no "
                           f"motion ({moved} moving ticks)")


def phase_fused(dev, ref_dev, warm_ticks=3):
    """Config-3 fused vertical: compile, cold tick, warm ticks; the cold
    tick again on ``ref_dev``, compared."""
    import jax
    import bench
    sc = bench.config3_scene()
    tick = jax.jit(sc.tick)
    args = jax.device_put(sc.args, dev)
    t0 = time.perf_counter()
    compiled = tick.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, out = jax.block_until_ready(compiled(*args))
    cold_ms = _ms(t0)
    warm_ms, state = [], s1
    for _ in range(warm_ticks):
        t0 = time.perf_counter()
        state, o = jax.block_until_ready(compiled(args[0], state, *args[2:]))
        warm_ms.append(_ms(t0))
    print(f"phase 3 fused vertical: {sc.ground_nodes} nodes, "
          f"{sc.cfg.local_planner.generator.n_samples_padded} rollouts; "
          f"compile {compile_s:.1f} s, cold tick {cold_ms:.2f} ms, warm "
          f"ticks {[round(x, 2) for x in warm_ms]} ms; plan_ok "
          f"{bool(out.plan_ok)}, plan {int(out.plan.count)} poses, "
          f"wavefront {int(out.wf_iters)} iterations cold, "
          f"{int(o.wf_iters)} warm")
    print(f"  memory_analysis: {_memory(compiled)}")
    if not bool(out.plan_ok):
        raise RuntimeError("fused vertical found no plan")
    t0 = time.perf_counter()
    ref = jax.block_until_ready(tick(*jax.device_put(sc.args, ref_dev)))
    print(f"phase 5 fused vertical on {ref_dev.platform}: "
          f"{time.perf_counter() - t0:.1f} s with compile")
    return compare_tick("fused", _fused_record(s1, out), _fused_record(*ref))


def _rows(tree, k):
    import jax
    return jax.tree_util.tree_map(lambda x: x[:k], tree)


def phase_fleet(dev, ref_dev, robots=64, ref_robots=8, warm_ticks=3):
    """Config-4 full-fidelity fleet: compile, cold tick, warm ticks; the
    first ``ref_robots`` robots' cold tick again on ``ref_dev``, compared
    robot by robot (every robot keeps its full per-robot widths)."""
    import jax
    import bench
    from dddmr_navigation_tpu.planning.local.planner import PlannerState
    cfg, mb, mcl_cfg = bench.config4_config()
    sc = bench.config4_scene(cfg, mb, mcl_cfg, robots)
    tick = jax.jit(sc.tick_at)
    shared, per_robot, state0 = jax.device_put(
        (sc.shared, sc.per_robot, sc.state0), dev)
    t0 = time.perf_counter()
    compiled = tick.lower(shared, per_robot, state0, 0).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, diag = jax.block_until_ready(compiled(shared, per_robot, state0, 0))
    cold_ms = _ms(t0)
    warm_ms, state, d = [], s1, diag
    for t in range(1, 1 + warm_ticks):
        t0 = time.perf_counter()
        state, d = jax.block_until_ready(compiled(shared, per_robot, state,
                                                  t))
        warm_ms.append(_ms(t0))
    found = int(np.sum(np.asarray(d["ps_simple"])
                       == int(PlannerState.TRAJECTORY_FOUND)))
    err = np.asarray(d["mcl_err"])
    stats = dev.memory_stats() or {}
    print(f"phase 4 fleet: {robots} robots x "
          f"{cfg.local_planner.generator.n_samples_padded} samples x "
          f"{cfg.local_planner.generator.max_num_steps} steps on "
          f"{sc.ground_nodes} nodes; compile {compile_s:.1f} s, cold tick "
          f"{cold_ms:.2f} ms, warm ticks {[round(x, 2) for x in warm_ms]} "
          f"ms; after tick {warm_ticks}: plan_ok "
          f"{int(np.sum(np.asarray(d['plan_ok'])))}/{robots}, found "
          f"{found}/{robots}, MCL error max {err.max():.4f} m mean "
          f"{err.mean():.4f} m, wavefront iterations cold "
          f"{int(np.max(np.asarray(diag['wf_iters'])))} warm "
          f"{int(np.max(np.asarray(d['wf_iters'])))}; peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use')}")
    print(f"  memory_analysis: {_memory(compiled)}")
    if int(np.sum(np.asarray(diag["plan_ok"]))) == 0:
        raise RuntimeError("fleet found no plan")
    k = min(ref_robots, robots)
    t0 = time.perf_counter()
    ref = jax.block_until_ready(tick(*jax.device_put(
        (sc.shared, _rows(sc.per_robot, k), _rows(sc.state0, k)), ref_dev),
        0))
    print(f"phase 5 fleet on {ref_dev.platform}: the first {k} of {robots} "
          f"robots at full per-robot widths, {time.perf_counter() - t0:.1f} "
          f"s with compile")
    return compare_tick("fleet", _rows(_fleet_record(s1, diag), k),
                        _fleet_record(*ref))


def phase_four(sc, n_devices=4, ticks=2):
    """`sharded_fleet_full_tick` over ``n_devices`` against
    `fleet_full_tick` on one device over the same robots, robot by robot
    and on the fleet-health psum, for ``ticks`` chained ticks."""
    import jax
    from dddmr_navigation_tpu.parallel.fleet import (
        make_fleet_mesh, shard_fleet_arrays)
    from dddmr_navigation_tpu.planning.local.planner import PlannerState
    from jax.sharding import NamedSharding, PartitionSpec
    mesh = make_fleet_mesh(n_devices)
    sharded = jax.jit(sc.sharded_tick_at(mesh))
    single = jax.jit(sc.tick_at)
    shared_m = jax.device_put(sc.shared, NamedSharding(mesh, PartitionSpec()))
    per_robot_m, state_m = shard_fleet_arrays(mesh,
                                              (sc.per_robot, sc.state0))
    one = jax.devices()[0]
    shared_1, per_robot_1, state_1 = jax.device_put(
        (sc.shared, sc.per_robot, sc.state0), one)
    fails = []
    for t in range(ticks):
        t0 = time.perf_counter()
        state_m, diag_m, health = jax.block_until_ready(
            sharded(shared_m, per_robot_m, state_m, t))
        ms_m = _ms(t0)
        t0 = time.perf_counter()
        state_1, diag_1 = jax.block_until_ready(
            single(shared_1, per_robot_1, state_1, t))
        ms_1 = _ms(t0)
        found = int(np.sum(np.asarray(diag_1["ps_simple"])
                           == int(PlannerState.TRAJECTORY_FOUND)))
        print(f"phase 6 tick {t}: {sc.robots} robots over {n_devices} "
              f"devices {ms_m:.1f} ms, on one device {ms_1:.1f} ms (first "
              f"tick includes compile); health psum {float(health)} vs "
              f"{found} found on one device; plan_ok "
              f"{int(np.sum(np.asarray(diag_m['plan_ok'])))}/{sc.robots}")
        if float(health) != found:
            fails.append(f"tick {t}: health psum {float(health)} vs {found}")
        fails += compare_tick(f"four t{t}", _fleet_record(state_m, diag_m),
                              _fleet_record(state_1, diag_1))
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4x64-robot fleet sharded over four "
                         "cards, against one card")
    args = ap.parse_args(argv)

    import jax
    from dddmr_navigation_tpu.jax_setup import use_compile_cache
    use_compile_cache()
    dev = phase_device()
    if args.four:
        import bench
        if len(jax.devices()) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found "
                             f"{len(jax.devices())}")
        cfg, mb, mcl_cfg = bench.config4_config()
        fails = phase_four(bench.config4_scene(cfg, mb, mcl_cfg, 4 * 64))
    else:
        cpu = jax.devices("cpu")[0]
        phase_session()
        fails = phase_fused(dev, cpu)
        fails += phase_fleet(dev, cpu)
    for f in fails:
        print(f"MISMATCH {f}")
    if fails:
        raise SystemExit(f"{len(fails)} comparison(s) failed")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
