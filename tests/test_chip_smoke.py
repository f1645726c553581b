"""chip_smoke.py: it refuses to run without a GPU, and its phase
functions run at a tiny grid on the CPU device (here the "card" and the
CPU reference are the same device, so the comparisons must agree)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = """\
slam_node:
  ros__parameters:
    map_size: 8
    cellsize: 0.04
    registration_mode: 3
    icp_iterations: 15
    trials: 20
    sizeControlSet: 40
    max_range: 12.0
    min_range: 0.01
"""
TINY_MULTI = """\
slam_node:
  ros__parameters:
    map_size: 8
    cellsize: 0.04
    robot_nbr: 2
    robot_0/name: robot0
    robot_1/name: robot1
    registration_mode: 0
    icp_iterations: 15
    robot0/max_range: 12.0
    robot1/max_range: 10.0
    robot1/local_offset_x: 0.5
    robot1/local_offset_yaw: 3.14159265
"""
BEAMS, STEPS = 361, 40


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Phase A at a tiny size, then the phase B/C inputs built from its
    scan log exactly as chip_smoke.main builds them."""
    from ohm_tsd_slam.config import load_yaml
    from ohm_tsd_slam.slam.localize import LocalizeParams

    d = tmp_path_factory.mktemp("smoke")
    cfg_path, multi_path = str(d / "tiny.yaml"), str(d / "multi.yaml")
    with open(cfg_path, "w") as f:
        f.write(TINY)
    with open(multi_path, "w") as f:
        f.write(TINY_MULTI)
    res_a = cs.phase_main_path(str(d / "out"), config=cfg_path,
                               beams=BEAMS, steps=STEPS, multi_steps=STEPS,
                               multi_config=multi_path, label="cpu",
                               traj_bound=0.04)
    cfg = load_yaml(cfg_path)
    log = np.load(str(d / "out" / "scans.npz"))
    geom = cs.sim_geom(log, cfg.robots[0].sensor.max_range)
    grid = cs.build_map(cfg.grid, log, geom, every=8)
    gw = cfg.grid.size_meters
    params = LocalizeParams.from_config(
        cfg.robots[0].registration, geom, bounds=(0.0, gw, 0.0, gw),
        cell_size=cfg.grid.cellsize)
    gt = log["ground_truth"]
    k = 13
    data, mask = cs.scan(geom, log["ranges"][k], jnp.float32)
    start = cs.gt_pose((gt[k][0] + 0.02, gt[k][1] - 0.01, gt[k][2] + 0.01),
                       jnp.float32)
    return dict(res_a=res_a, out=d / "out", log=log, geom=geom, grid=grid,
                params=params, data=data, mask=mask, start=start,
                cpu=jax.devices("cpu")[0])


def test_refuses_without_gpu():
    """No GPU: exit 2, last line {"ok": false, ...}, and no phase ran."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert p.returncode == 2, p.stdout + p.stderr
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["ok"] is False
    assert not any(line.startswith("[") for line in lines)


def test_phase_main_path(world):
    res = world["res_a"]
    assert res["scans"] == STEPS
    assert res["nan_scans"] == 0 and res["rays_dropped_total"] == 0
    assert res["traj_max_err_m"] < 0.04
    assert res["multi_nan_poses"][0] == 0
    for name in ("run/map.pgm", "run/trajectory.csv", "run/scan_stats.csv",
                 "multi/map.pgm", "multi/trajectory_r1.csv"):
        assert (world["out"] / name).exists(), name


def test_phase_caster(world):
    gt = world["log"]["ground_truth"]
    res = cs.phase_caster(world["grid"], world["geom"],
                          [cs.gt_pose(gt[i], jnp.float32) for i in (3, 17)])
    assert res["agree"] > cs.CASTER_MIN_AGREE


def test_phase_push(world):
    log = world["log"]
    pose = np.asarray(cs.gt_pose(log["ground_truth"][21], jnp.float32),
                      np.float64)
    res = cs.phase_push(world["grid"], world["geom"], pose,
                        log["ranges"][21], world["cpu"])
    assert res["frac"] < cs.PUSH_MAX_DIFF_FRAC


@pytest.mark.parametrize("mode", [3, 0])
def test_phase_localize(world, mode):
    res = cs.phase_localize(
        world["grid"], dataclasses.replace(world["params"], mode=mode),
        world["start"], world["data"], world["mask"],
        jax.random.PRNGKey(7), world["cpu"])
    assert res["dpos"] < cs.LOC_POS_TOL_M


def test_phase_times(world):
    res = cs.phase_times(world["grid"], world["geom"], world["params"],
                         world["start"], world["data"], world["mask"],
                         jax.random.PRNGKey(7), "cpu", reps=2)
    assert set(res["times_s"]) == {
        "extract_segments", "raycast_fast_cached", "push",
        "localize_step_mode3", "localize_step_mode0"}
    assert all(t > 0 for t in res["times_s"].values())


@pytest.mark.parametrize("shift,ok", [(0.0, True), (2e-4, False)])
def test_loop_parity_bounds(shift, ok):
    """golden_io.loop_parity, the golden-loop check chip_smoke applies:
    gates equal and |dpos|, |drot| < 1e-4."""
    from golden_io import loop_parity

    poses = np.tile(np.eye(3), (5, 1, 1))
    flags = np.array([[0, 1], [0, 0], [0, 1], [0, 0], [0, 0]])
    got = poses.copy()
    got[:, 0, 2] += shift
    assert loop_parity(got, flags, poses, flags)[0] is ok
    flipped = flags.copy()
    flipped[2, 1] = 0
    assert loop_parity(poses, flipped, poses, flags)[0] is False
