"""chip_smoke.py and the measurement entry points: the GPU-vs-CPU
comparison rule, the refusal to run without a GPU, the compile-cache
helper, the peak table, and the sharded-fleet comparison of ``--four`` on
virtual CPU devices at tiny widths. One test (marked ``gpu``) runs the
fused-vertical and fleet phases on a card."""
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

import bench
import chip_smoke
from dddmr_navigation_tpu import jax_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tick(n=3):
    """One tick's outputs for ``n`` robots, as compare_tick takes them."""
    rng = np.random.default_rng(0)
    return {
        "state": np.zeros(n, np.int32), "decision": np.full(n, 3, np.int32),
        "plan_ok": np.ones(n, bool), "plan_len": np.full(n, 40, np.int32),
        "best_index": np.arange(n, dtype=np.int32),
        "best_cost": np.linspace(1.0, 2.0, n).astype(np.float32),
        "vx": np.full(n, 0.3, np.float32), "wz": np.zeros(n, np.float32),
        "dgraph": rng.uniform(0, 3, (n, 50)).astype(np.float32),
        "wf_dist": np.where(rng.uniform(size=(n, 50, 4)) < 0.1, np.inf,
                            rng.uniform(0, 20, (n, 50, 4))).astype(np.float32),
        "mcl_pos": rng.uniform(-4, 4, (n, 3)).astype(np.float32),
    }


def _copy(t):
    return {k: v.copy() for k, v in t.items()}


def test_compare_passes_on_identical_outputs():
    assert chip_smoke.compare_tick("t", _tick(), _tick()) == []


def test_compare_fails_on_perturbed_vx():
    acc = _copy(_tick())
    acc["vx"][1] += 10 * chip_smoke.CMD_TOL
    fails = chip_smoke.compare_tick("t", acc, _tick())
    assert len(fails) == 1 and "vx" in fails[0]


def test_compare_fails_on_flipped_decision():
    acc = _copy(_tick())
    acc["decision"][2] = 5
    fails = chip_smoke.compare_tick("t", acc, _tick())
    assert len(fails) == 1 and "decision" in fails[0]


def test_compare_fails_on_untied_argmin_change():
    acc = _copy(_tick())
    acc["best_index"][0] = 7
    acc["vx"][0] = 0.1
    acc["best_cost"][0] += 0.01
    fails = chip_smoke.compare_tick("t", acc, _tick())
    assert len(fails) == 1 and "do not tie" in fails[0]


def test_compare_accepts_tied_argmin_change():
    acc = _copy(_tick())
    acc["best_index"][0] = 7
    acc["vx"][0] = 0.1                      # another sample, same cost
    acc["best_cost"][0] *= 1 + 0.1 * chip_smoke.COST_RTOL
    assert chip_smoke.compare_tick("t", acc, _tick()) == []


@pytest.mark.parametrize("field,delta,fails", [
    ("wf_dist", 1e-6, False), ("wf_dist", 1e-2, True),
    ("dgraph", 5e-4, False), ("dgraph", 5e-3, True)])
def test_compare_field_tolerances(field, delta, fails):
    acc = _copy(_tick())
    flat = acc[field].reshape(-1)                 # a view of the copy
    flat[np.flatnonzero(np.isfinite(flat))[1]] += delta
    assert bool(chip_smoke.compare_tick("t", acc, _tick())) == fails


def test_compare_fails_on_mcl_pose():
    acc = _copy(_tick())
    acc["mcl_pos"][1, 0] += 2 * chip_smoke.MCL_TOL_M
    fails = chip_smoke.compare_tick("t", acc, _tick())
    assert len(fails) == 1 and "MCL" in fails[0]


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_fails_without_gpu(script):
    proc = _run([os.path.join(REPO, script)], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", "/set/by/jax")
    assert jax_setup.use_compile_cache() == "/elsewhere/cache"
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == "/set/by/jax"


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert jax_setup.use_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_peak_table_has_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops"] == 989e12
    assert peaks["f32_flops"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert "NVIDIA" in peaks["source"]


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_rejects_unknown_kind(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


def _tiny_fleet(robots):
    from dddmr_navigation_tpu.config import (
        NavigationConfig, LocalPlannerConfig, DDSimpleGeneratorConfig,
        PerceptionConfig, SpinningLidarConfig, GlobalPlannerConfig,
        MoveBaseConfig, MCLConfig)
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
    mcl_cfg = MCLConfig(num_particles=16, init_var_x=0.3, init_var_y=0.3,
                        init_var_z=0.1, init_var_yaw=0.1,
                        field_sampling="corr")
    return bench.config4_scene(cfg, MoveBaseConfig(), mcl_cfg, robots)


def test_four_device_fleet_matches_one_device():
    """`--four`'s comparison on four virtual CPU devices: the sharded
    fleet tick agrees robot by robot, and on the fleet-health psum, with
    the same robots on one device over two chained ticks."""
    assert len(jax.devices()) >= 4
    assert chip_smoke.phase_four(_tiny_fleet(8), n_devices=4) == []


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; the default device is "
                    f"{dev.platform} (run with JAX_PLATFORMS=cuda,cpu)")
    return dev


@pytest.mark.gpu
def test_fused_and_fleet_on_gpu_match_cpu(gpu):
    """Phases 3-5 of chip_smoke on the card, compared with the CPU."""
    cpu = jax.devices("cpu")[0]
    assert chip_smoke.phase_fused(gpu, cpu) == []
    assert chip_smoke.phase_fleet(gpu, cpu) == []
