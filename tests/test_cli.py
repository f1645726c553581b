"""CLI runner (the launch-script equivalent, SURVEY.md L5 /
VERDICT r1 #10): simulate a scan log, run SLAM over it from a YAML
profile, and check the artifacts."""

import os

import numpy as np

from ohm_tsd_slam.__main__ import main


def test_cli_simulate_and_run(tmp_path):
    scans = str(tmp_path / "scans.npz")
    out = str(tmp_path / "out")
    cfgfile = str(tmp_path / "profile.yaml")
    with open(cfgfile, "w") as f:
        f.write("""
slam_node:
  ros__parameters:
    map_size: 9
    cellsize: 0.025
    registration_mode: 0
    icp_iterations: 30
    max_range: 12.0
    min_range: 0.01
""")

    assert main(["simulate", "--out", scans, "--steps", "30",
                 "--beams", "271", "--config", cfgfile]) == 0
    log = np.load(scans)
    assert log["ranges"].shape == (30, 271)

    assert main(["run", scans, "--config", cfgfile, "--out", out,
                 "--store-text"]) == 0
    for name in ("trajectory.csv", "map.pgm", "map_color.ppm",
                 "grid.npz", "grid_store.txt"):
        assert os.path.exists(os.path.join(out, name)), name

    rows = open(os.path.join(out, "trajectory.csv")).read().splitlines()
    assert rows[0] == "stamp,x,y,theta"
    assert len(rows) >= 25

    # the text checkpoint round-trips through the reference-format loader
    import jax.numpy as jnp

    from ohm_tsd_slam.grid.checkpoint import load_npz, load_text

    g1 = load_npz(os.path.join(out, "grid.npz"), dtype=jnp.float64)
    g2 = load_text(os.path.join(out, "grid_store.txt"), dtype=jnp.float64)
    assert g1.tsd.shape == g2.tsd.shape


def test_cli_ros_bridge_without_rclpy(capsys):
    """The ROS bridge degrades with a clear message when rclpy is
    missing (this image has no ROS)."""
    from ohm_tsd_slam import ros_bridge

    if ros_bridge.HAVE_ROS:  # pragma: no cover
        return
    assert ros_bridge.main() == 1
    assert "rclpy not available" in capsys.readouterr().out
