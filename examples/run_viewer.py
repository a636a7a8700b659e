"""Live operator viewer over a running NavigationSession.

The JAX stand-in for the reference's rviz tooling
(`src/dddmr_rviz_tools/`): open http://127.0.0.1:8123 in a browser
(port-forward when remote) to see the map + dGraph heat, the live plan,
the best rollout, and the robot; LEFT-CLICK anywhere on the map to set a
new navigation goal (snapped to the nearest ground node, like the rviz
3D goal tool raycasts onto the map cloud).

The robot drives a simulated box world with a toggling obstacle wall
(the `dummy_pc_pub` demo cycle) and replans live as you click goals.

Run: python examples/run_viewer.py [--port 8123] [--platform cpu]
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--ticks", type=int, default=100000)
    ap.add_argument("--wall-period", type=float, default=15.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--realtime", action="store_true",
                    help="pace ticks to the 10 Hz controller frequency")
    args = ap.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)

    import numpy as np
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import (
        NavigationConfig, PerceptionConfig, SpinningLidarConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io import flat_ground_map
    from dddmr_navigation_tpu.control.session import NavigationSession
    from dddmr_navigation_tpu.runtime.viewer import NavViewer
    from dddmr_navigation_tpu.utils.lidar_sim import BoxWorld, simulate_scan

    lidar = SpinningLidarConfig(
        xy_resolution=0.1, height_resolution=0.1,
        range_image_rows=32, range_image_cols=360,
        vertical_FOV_bottom=-40.0, vertical_FOV_top=40.0,
        scan_effective_positive_start=0.0,
        scan_effective_negative_start=0.0)
    cfg = dataclasses.replace(
        NavigationConfig(),
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=72,
                                    voxel_window_cells_z=24))
    ground = flat_ground_map(14, 8, 0.2)
    sess = NavigationSession(cfg, ground)
    viewer = NavViewer(ground, port=args.port)
    print(f"viewer: http://127.0.0.1:{viewer.port}  "
          f"(click = goal, shift-click = initial pose)")

    room = BoxWorld.room(half=6.0, wall_h=1.5)
    walled = BoxWorld.room(half=6.0, wall_h=1.5)
    walled.add_box([-0.1, -1.4, 0.0], [0.1, 1.4, 1.2])

    goal = np.array([3.5, 0.0, 0.0], np.float32)
    sess.set_goal(goal)
    pos = np.array([-3.0, 0.0, 0.0], np.float32)
    yaw, v, w = 0.0, 0.0, 0.0
    dt = 0.1
    for i in range(args.ticks):
        t0 = time.perf_counter()
        now = i * dt
        clicked = viewer.pop_goal()
        if clicked is not None:
            goal = clicked
            sess.set_goal(goal, now=now)
            print(f"new goal {goal}")
        init = viewer.pop_initial_pose()
        if init is not None:
            pos = init.astype(np.float32)
            v = w = 0.0
            print(f"teleported to {pos}")

        world = walled if (now % args.wall_period) < args.wall_period / 2 \
            else room
        quat = np.asarray(quat_from_yaw(jnp.float32(yaw)))
        pts, mask = simulate_scan(world, pos + [0, 0, 0.5], sensor_yaw=yaw,
                                  n_rings=24, n_cols=240, v_bottom=-40.0,
                                  v_top=40.0, max_range=15.0)
        mask = mask & (pts[:, 2] + pos[2] + 0.5 >= 0.15)
        vx, wz, dec, done, ok = sess.tick(pts, mask, pos, quat, v, w, now=now)

        cmd = getattr(sess.driver, "last_cmd", None)
        best_rollout = None
        if cmd is not None:
            bi = int(cmd.best_index)
            n_steps = int(cmd.rollouts.num_steps[bi])
            best_rollout = np.asarray(cmd.rollouts.positions[bi][:n_steps])
        plan_np = None
        if sess.driver.plan is not None:
            p = sess.driver.plan
            plan_np = np.asarray(p.positions)[np.asarray(p.valid)]
        viewer.publish(
            robot_pos=pos, robot_yaw=yaw, v=v, w=w, decision=int(dec),
            planner_state=getattr(sess.driver, "last_planner_state", -1),
            tick=i, dgraph=np.asarray(sess.composed_dgraph),
            plan=plan_np, best_rollout=best_rollout, goal=goal)

        if done:
            print(f"goal finished (ok={ok}); click a new goal")
            # idle until a click arrives
            while viewer.pop_initial_pose() is None:
                clicked = viewer.pop_goal()
                if clicked is not None:
                    goal = clicked
                    sess.set_goal(goal, now=now)
                    print(f"new goal {goal}")
                    break
                time.sleep(0.2)
            continue
        v, w = vx, wz
        pos = pos + np.array([v * np.cos(yaw) * dt,
                              v * np.sin(yaw) * dt, 0.0], np.float32)
        yaw = float(yaw + w * dt)
        if args.realtime:
            time.sleep(max(0.0, dt - (time.perf_counter() - t0)))


if __name__ == "__main__":
    main()
