"""Fleet sharding over the virtual 8-device CPU mesh: single-axis
scenario mesh (parallel/fleet.py) and the 2-level (hosts, devices) multi-host
mesh (parallel/multihost.py) — SURVEY.md §2.12 / BASELINE.json configs
4-5, tested per §4 via forced host-platform devices."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dddmr_navigation_tpu.config import (
    LocalPlannerConfig, DDSimpleGeneratorConfig)
from dddmr_navigation_tpu.geometry import quat_from_yaw
from dddmr_navigation_tpu.planning.local.planner import make_global_plan
from dddmr_navigation_tpu.parallel import (
    FleetState, make_fleet_mesh, sharded_fleet_tick, fleet_tick,
    make_host_mesh, scenario_sharding, sharded_fleet_tick_multihost,
    host_local_batch, initialize_distributed)
from dddmr_navigation_tpu.parallel.fleet import shard_fleet_arrays


def _tiny_setup(b):
    """Same tiny shapes as __graft_entry__.dryrun_multichip so the
    compiled programs share the persistent cache with the driver."""
    cfg = LocalPlannerConfig(
        max_plan_len=64, max_prune_len=32, max_obstacle_points=64,
        generator=DDSimpleGeneratorConfig(
            linear_x_sample=3, angular_z_sample=3, max_num_steps=16,
            sim_granularity=0.2, angular_sim_granularity=0.1),
    )
    xs = np.arange(0, 3.0, 0.1, dtype=np.float32)
    plan_pts = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1)
    plan1 = make_global_plan(plan_pts, max_len=cfg.max_plan_len)
    plans = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), plan1)
    state = FleetState(
        pos=jnp.zeros((b, 3)),
        quat=jnp.broadcast_to(quat_from_yaw(jnp.float32(0.0)), (b, 4)),
        v=jnp.zeros((b,)), w=jnp.zeros((b,)))
    obstacles = jnp.full((b, cfg.max_obstacle_points, 3), 50.0)
    obs_valid = jnp.ones((b, cfg.max_obstacle_points), bool)
    return cfg, plans, state, obstacles, obs_valid


def test_sharded_fleet_tick_8_devices():
    n = len(jax.devices())
    assert n >= 8, "conftest must force 8 virtual devices"
    cfg, plans, state, obstacles, obs_valid = _tiny_setup(b=16)
    mesh = make_fleet_mesh(8)
    tick = sharded_fleet_tick(cfg, mesh)
    inputs = shard_fleet_arrays(mesh, (plans, state, obstacles, obs_valid))
    vx, wz, codes, costs, fleet_cost = tick(*inputs)
    assert vx.shape == (16,)
    assert np.isfinite(float(fleet_cost))
    # replicated scalar must equal the mean over accepted robots
    c = np.asarray(costs)
    ok = c >= 0
    assert ok.any()
    np.testing.assert_allclose(float(fleet_cost), c[ok].mean(), rtol=1e-5)


@pytest.mark.slow
def test_multihost_mesh_matches_single_axis():
    """The (2 hosts × 4 devices) hierarchical reduction must agree with the
    flat 8-device mesh and with an unsharded vmap run."""
    cfg, plans, state, obstacles, obs_valid = _tiny_setup(b=16)
    mesh = make_host_mesh(n_hosts=2, devices_per_host=4)
    assert mesh.shape == {"hosts": 2, "devices": 4}
    tick = sharded_fleet_tick_multihost(cfg, mesh)
    inputs = host_local_batch(mesh, (plans, state, obstacles, obs_valid))
    vx, wz, codes, costs, fleet_cost = tick(*inputs)

    ref_vx, ref_wz, ref_codes, ref_costs = fleet_tick(
        cfg, plans, state, obstacles, obs_valid)
    np.testing.assert_allclose(np.asarray(vx), np.asarray(ref_vx),
                               atol=1e-5)
    c = np.asarray(ref_costs)
    ok = c >= 0
    np.testing.assert_allclose(float(fleet_cost), c[ok].mean(), rtol=1e-4)


def test_scenario_sharding_spans_all_devices():
    mesh = make_host_mesh(n_hosts=2, devices_per_host=4)
    sh = scenario_sharding(mesh)
    x = jax.device_put(np.zeros((16, 3), np.float32), sh)
    assert len(x.sharding.device_set) == 8


def test_initialize_distributed_noop_single_process(monkeypatch):
    monkeypatch.delenv("DDDMR_COORDINATOR", raising=False)
    assert initialize_distributed() is False
    # explicit single-process: still a no-op
    assert initialize_distributed(coordinator_address="127.0.0.1:1234",
                                  num_processes=1) is False


@pytest.mark.slow
def test_sharded_fused_vertical_fleet_8_devices():
    """The ENTIRE vertical (mark/clear → replan → rollouts) vmapped over
    8 robots and sharded over the 8-device mesh: every robot must mark
    its own scan, extract its own plan from the shared map, and produce
    a command; the fleet-health psum rides the mesh axis."""
    import dataclasses
    from dddmr_navigation_tpu.config import (
        NavigationConfig, LocalPlannerConfig, DDSimpleGeneratorConfig,
        PerceptionConfig, SpinningLidarConfig)
    from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, init_fused_state, make_fused_tick)
    from dddmr_navigation_tpu.parallel.fleet import (
        make_fleet_mesh, sharded_fused_fleet_tick, shard_fleet_arrays)

    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=512)
    cfg = NavigationConfig(
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=32,
                                    voxel_window_cells_z=24,
                                    max_marked_voxels=128),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=3, angular_z_sample=4, max_num_steps=12),
            max_obstacle_points=128, collision_obstacle_chunk=16,
            collision_near_k=32))
    ground = flat_ground_map(8, 5, 0.25)
    fmap = build_fused_map(cfg, ground)
    _, spec, ri_spec, params = make_fused_tick(cfg)

    b = 8
    n_pad = cfg.perception.lidar.max_scan_points
    rngs = np.random.default_rng(0)
    scans = np.zeros((b, n_pad, 3), np.float32)
    masks = np.zeros((b, n_pad), bool)
    for i in range(b):
        # a small post 0.6 m ahead of THIS robot (inside its 1.6 m window)
        # tall post so the cluster centroid sits inside the ±15° vertical
        # FOV at 0.8 m range
        box = box_obstacle([-3.0 + 0.6, 0.3 * (i - 4) + 0.55, 0.0],
                           size=(0.2, 0.2, 1.0), resolution=0.1)
        rel = box - np.array([-3.0, 0.3 * (i - 4), 0.3], np.float32)
        scans[i, :len(rel)] = rel[:n_pad]
        masks[i, :min(len(rel), n_pad)] = True
    positions = np.stack([np.full(b, -3.0), 0.3 * (np.arange(b) - 4),
                          np.zeros(b)], 1).astype(np.float32)
    quats = np.broadcast_to(
        np.asarray(quat_from_yaw(jnp.float32(0.0))), (b, 4))
    goals = np.stack([np.full(b, 3.0), 0.3 * (np.arange(b) - 4),
                      np.zeros(b)], 1).astype(np.float32)

    states = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[init_fused_state(cfg, len(ground), robot_xyz=positions[i])
          for i in range(b)])
    mesh = make_fleet_mesh(8)
    tick = sharded_fused_fleet_tick(cfg, spec, ri_spec, params, mesh)
    states_s, scans_s, masks_s, pos_s, quat_s, goal_s, v_s, w_s = \
        shard_fleet_arrays(mesh, (states, jnp.asarray(scans),
                                  jnp.asarray(masks), jnp.asarray(positions),
                                  jnp.asarray(quats), jnp.asarray(goals),
                                  jnp.full((b,), 0.2), jnp.zeros((b,))))
    s2, vx, wz, codes, ok, found = tick(
        fmap, states_s, scans_s, masks_s, pos_s, quat_s,
        jnp.asarray([0.0, 0.0, 0.3]), goal_s, v_s, w_s)
    assert vx.shape == (b,)
    assert bool(np.all(np.asarray(ok))), "some robot failed to plan"
    assert float(found) == b, f"fleet health psum: {float(found)}"
    # each robot marked ITS OWN scan: dgraph minima differ per robot
    dg = np.asarray(s2.marking.dgraph)
    assert (dg.min(axis=1) < 2.0).all()
    assert np.asarray(vx).min() > 0.0, "fleet did not move"


@pytest.mark.slow
def test_sharded_full_vertical_fleet_8dev():
    """The FLAGSHIP program sharded: fleet_full_tick (MCL + mark/clear +
    turning/LOS replan + FSM + recovery) DP-sharded over the 8-device
    mesh with the map/submap replicated and the fleet-health psum on the
    mesh axis — the in-suite counterpart of `dryrun_multichip`."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import (
        NavigationConfig, LocalPlannerConfig, DDSimpleGeneratorConfig,
        PerceptionConfig, SpinningLidarConfig, GlobalPlannerConfig,
        MoveBaseConfig, MCLConfig)
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, make_fused_tick)
    from dddmr_navigation_tpu.parallel.fleet import (
        make_fleet_mesh, shard_fleet_arrays, init_fleet_full_state,
        sharded_fleet_full_tick)
    from dddmr_navigation_tpu.state_estimation.likelihood import (
        build_submap_context)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=256)
    cfg = NavigationConfig(
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=32,
                                    voxel_window_cells_z=12,
                                    max_marked_voxels=128),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=5, angular_z_sample=5, max_num_steps=16),
            max_obstacle_points=128, collision_obstacle_chunk=16,
            collision_near_k=32),
        global_planner=GlobalPlannerConfig(
            turning_weight=0.1, max_long_edges=32, los_samples=4,
            max_lethal_points=128, max_relax_iters=64, max_path_len=128))
    mb = MoveBaseConfig()
    mcl_cfg = MCLConfig(num_particles=16, init_var_x=0.3, init_var_y=0.3,
                        init_var_z=0.1, init_var_yaw=0.1,
                        field_sampling="nearest")
    ground = flat_ground_map(6, 5, 0.5)
    walls = np.concatenate([
        box_obstacle([-2.6, 0.0, 0.0], size=(0.3, 4.4, 1.0), resolution=0.2),
        box_obstacle([2.6, 0.0, 0.0], size=(0.3, 4.4, 1.0), resolution=0.2),
        box_obstacle([0.0, -2.1, 0.0], size=(5.0, 0.3, 1.0), resolution=0.2),
    ]).astype(np.float32)
    fmap = build_fused_map(cfg, ground, walls)
    submap = build_submap_context(walls, ground, mcl_cfg)
    _, spec, ri_spec, params = make_fused_tick(cfg)

    b = 16
    positions = np.stack([np.full(b, -1.8),
                          3.0 * (np.arange(b) / b - 0.5),
                          np.zeros(b)], 1).astype(np.float32)
    quats = np.broadcast_to(
        np.asarray(quat_from_yaw(jnp.float32(0.0))), (b, 4)).copy()
    goals = positions + np.array([3.4, 0.2, 0.0], np.float32)
    n_pad = cfg.perception.lidar.max_scan_points
    scans = np.zeros((b, n_pad, 3), np.float32)
    masks = np.zeros((b, n_pad), bool)
    for i in range(b):
        box = box_obstacle([positions[i, 0] + 1.0, positions[i, 1] + 0.5,
                            0.0], size=(0.2, 0.2, 0.6), resolution=0.1)
        rel = (box - (positions[i] + [0, 0, 0.3]))[:n_pad]
        scans[i, :len(rel)] = rel
        masks[i, :len(rel)] = True

    state = init_fleet_full_state(cfg, len(ground), positions, quats,
                                  localize=True, mcl_cfg=mcl_cfg)
    mesh = make_fleet_mesh(8)
    tick = sharded_fleet_full_tick(cfg, mb, spec, ri_spec, params, mesh,
                                   mcl_cfg=mcl_cfg, localize=True)
    state, scans_j, masks_j, goals_j, drift, dyaw = shard_fleet_arrays(
        mesh, (state, jnp.asarray(scans), jnp.asarray(masks),
               jnp.asarray(goals),
               jnp.full((b, 3), 0.02) * jnp.asarray([0.7, 0.7, 0.0]),
               jnp.zeros((b,))))
    offset = jnp.asarray([0.0, 0.0, 0.3])
    for t in range(2):
        state, diag, found = tick(
            fmap, submap, jnp.asarray(walls), jnp.asarray(ground), state,
            scans_j, masks_j, offset, goals_j, jnp.float32(0.1 * t),
            jnp.float32(0.1), drift, dyaw)
    assert int(np.sum(np.asarray(diag["plan_ok"]))) == b
    assert float(np.max(np.asarray(diag["mcl_err"]))) < 1.0
    assert int(np.asarray(found)) >= 0  # psum'd fleet health replicated
