"""End-to-end online SLAM demo — the launch-script equivalent.

Plays the role of the reference's deploy layer (launch/slam.launch.py +
a live /scan topic, SURVEY.md §1/L5): drives a simulated robot on a
loop through an analytic room, feeds each scan through the full
localize → (significance-gated) map → occupancy-extract pipeline, and
writes the artifacts a ROS user would get from the node's topics:

  out/trajectory.csv   — estimated vs ground-truth poses per scan
  out/map.pgm          — occupancy grid (nav_msgs/OccupancyGrid analog)
  out/map_color.ppm    — RGB TSD visualization (map/image analog)
  out/grid.npz         — grid checkpoint (storeGrid analog)

Usage:
  python examples/run_slam.py [--config configs/single-laser.yaml]
                              [--steps 120] [--out out]

Runs on an NVIDIA GPU or the CPU; to force the CPU prepend
  env JAX_PLATFORMS=cpu
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="YAML profile (defaults to a small ICP profile)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--beams", type=int, default=541)
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    import jax.numpy as jnp

    from ohm_tsd_slam import native
    from ohm_tsd_slam.config import (GridConfig, SlamConfig,
                                         from_flat_params, load_yaml)
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import checkpoint, color
    from ohm_tsd_slam.slam.messages import LaserScan
    from ohm_tsd_slam.slam.node import SlamNode
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

    if args.config:
        cfg = load_yaml(args.config)
    else:
        cfg = from_flat_params({
            "map_size": 9, "cellsize": 0.025, "registration_mode": 0,
            "icp_iterations": 30, "max_range": 12.0, "min_range": 0.01,
        })

    node = SlamNode(cfg)
    gw = cfg.grid.size_meters
    timer = native.Timer()

    # analytic world: room + two pillars, robot loops around the center
    margin = 0.2 * gw
    walls = rect_walls(margin, margin, gw - margin, gw - margin)
    pillars = [((gw / 2 + 0.22 * gw, gw / 2), 0.04 * gw),
               ((gw / 2 - 0.18 * gw, gw / 2 + 0.15 * gw), 0.03 * gw)]
    geom = dict(size=args.beams,
                angular_res=math.radians(270.0 / args.beams),
                phi_min=math.radians(-135.0),
                max_range=cfg.robots[0].sensor.max_range)

    radius = 0.12 * gw
    rows = []
    world_from_grid = None
    for k in range(args.steps):
        a = 2.0 * math.pi * k / args.steps
        gt_x = gw / 2 + radius * math.cos(a)
        gt_y = gw / 2 + radius * math.sin(a)
        gt_th = a + math.pi / 2
        gt = np.array(se2.make(gt_x, gt_y, gt_th, dtype=jnp.float64))
        if world_from_grid is None:
            # the localizer starts at grid center with yaw 0; the true
            # start pose anchors the grid frame in the world
            grid_start = np.array(se2.make(gw / 2, gw / 2, 0.0,
                                           dtype=jnp.float64))
            world_from_grid = gt @ np.linalg.inv(grid_start)
        ranges = simulate_scan(gt, geom["size"], geom["angular_res"],
                               geom["phi_min"], geom["max_range"],
                               segments=walls, circles=pillars)
        scan = LaserScan(ranges=ranges, angle_min=geom["phi_min"],
                         angle_increment=geom["angular_res"],
                         range_max=geom["max_range"], stamp=0.05 * k)
        pose = node.process_scan(0, scan)
        if pose is None:
            continue
        # published poses are map-frame (origin at grid center,
        # ThreadLocalize.cpp:619-664 offset convention) — shift back
        # into grid coordinates before anchoring
        est_grid = np.array(se2.make(pose.x + gw / 2, pose.y + gw / 2,
                                     pose.theta, dtype=jnp.float64))
        est_world = world_from_grid @ est_grid
        err = math.hypot(est_world[0, 2] - gt_x, est_world[1, 2] - gt_y)
        rows.append((scan.stamp, pose.x, pose.y, pose.theta,
                     gt_x, gt_y, gt_th, err))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trajectory.csv"), "w") as f:
        f.write("stamp,est_x,est_y,est_theta,gt_x,gt_y,gt_theta,err_m\n")
        for r in rows:
            f.write(",".join(f"{v:.6f}" for v in r) + "\n")

    occ, _img = node.grid_pub.publish(node.grid)
    occ_img = np.asarray(occ.data, dtype=np.int16)
    gray = np.where(occ_img < 0, 127,
                    (255 - occ_img * 255 // 100)).astype(np.uint8)
    native.serialize_pgm(os.path.join(args.out, "map.pgm"),
                         gray, gray.shape[1], gray.shape[0])
    rgb = np.asarray(color.grid_to_color_image(node.grid))
    native.serialize_ppm(os.path.join(args.out, "map_color.ppm"),
                         rgb, rgb.shape[1], rgb.shape[0])
    checkpoint.save_npz(node.grid, os.path.join(args.out, "grid.npz"))

    errs = np.array([r[-1] for r in rows])
    print(f"steps={len(rows)}  elapsed={timer.elapsed():.1f}s  "
          f"pose err mean={errs.mean()*100:.2f} cm  "
          f"max={errs.max()*100:.2f} cm")
    print(f"artifacts in {args.out}/: trajectory.csv map.pgm "
          f"map_color.ppm grid.npz")


if __name__ == "__main__":
    main()
