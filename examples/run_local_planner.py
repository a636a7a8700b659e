"""Closed-loop local-planner demo: a diff-drive robot follows a straight
plan through a gap in an obstacle wall, 20 Hz ticks, fully jitted.

The JAX analogue of the reference's interactive playground fixture
(`local_planner_play_ground_node.cpp:42-331`): fake plan + synthetic
obstacles + rollout/critics loop, minus rviz.

Run: python examples/run_local_planner.py [--ticks N] [--platform cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=80)
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu)")
    args = ap.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform

    import numpy as np
    import jax
    import jax.numpy as jnp

    from dddmr_navigation_tpu.config import NavigationConfig
    from dddmr_navigation_tpu.geometry import quat_from_yaw, quat_multiply, yaw_from_quat
    from dddmr_navigation_tpu.planning.local.planner import (
        make_global_plan, compute_velocity_command, goal_reached, PlannerState)

    cfg = NavigationConfig().local_planner

    # plan 0 -> 6 m that routes through the wall gap at (2.2, ~0.8) — the
    # shape a global planner would produce around the obstacle
    xs = np.arange(0, 6.0, 0.1)
    ys = 0.8 * np.exp(-((xs - 2.2) ** 2) / (2 * 0.7 ** 2))
    plan_pts = np.stack([xs, ys, np.zeros_like(xs)], 1).astype(np.float32)
    plan = make_global_plan(plan_pts, max_len=cfg.max_plan_len)

    wall = []
    for y in np.arange(-2.0, 2.0, 0.1):
        if 0.4 <= y <= 1.2:
            continue  # the gap
        for z in (0.0, 0.3):
            wall.append([2.2, y, z])
    wall = np.asarray(wall, np.float32)
    obstacles = np.zeros((cfg.max_obstacle_points, 3), np.float32)
    obstacles[: len(wall)] = wall
    obs_mask = np.zeros((cfg.max_obstacle_points,), bool)
    obs_mask[: len(wall)] = True
    obstacles = jnp.asarray(obstacles)
    obs_mask = jnp.asarray(obs_mask)

    tick = jax.jit(compute_velocity_command, static_argnums=(0, 10))

    pos = jnp.asarray([0.0, 0.0, 0.0])
    quat = quat_from_yaw(jnp.float32(0.0))
    v = jnp.float32(0.0)
    w = jnp.float32(0.0)
    dt = 1.0 / cfg.controller_frequency

    print(f"{'tick':>4} {'x':>6} {'y':>6} {'yaw':>6} {'v':>6} {'w':>6}  state")
    t_total = 0.0
    reached = False
    for i in range(args.ticks):
        t0 = time.perf_counter()
        cmd = tick(cfg, plan, pos, quat, v, w, obstacles, obs_mask, -1.0, 0.0)
        cmd.vx.block_until_ready()
        t_total += time.perf_counter() - t0
        v, w = cmd.vx, cmd.wz
        # integrate robot (perfect execution)
        yaw = yaw_from_quat(quat)
        pos = pos + jnp.asarray([float(v) * np.cos(float(yaw)) * dt,
                                 float(v) * np.sin(float(yaw)) * dt, 0.0])
        quat = quat_from_yaw(yaw + w * dt)
        if i % 5 == 0 or i == args.ticks - 1:
            print(f"{i:>4} {float(pos[0]):>6.2f} {float(pos[1]):>6.2f} "
                  f"{float(yaw):>6.2f} {float(v):>6.2f} {float(w):>6.2f}  "
                  f"{PlannerState(int(cmd.state)).name}")
        if bool(goal_reached(cfg, plan, pos)):
            reached = True
            print(f"goal reached at tick {i}, pos=({float(pos[0]):.2f}, "
                  f"{float(pos[1]):.2f})")
            break

    n = i + 1
    print(f"\n{n} ticks, avg {1e3 * t_total / n:.2f} ms/tick "
          f"(budget {1e3 * dt:.0f} ms) — goal {'REACHED' if reached else 'NOT reached'}")
    return 0 if reached else 1


if __name__ == "__main__":
    raise SystemExit(main())
