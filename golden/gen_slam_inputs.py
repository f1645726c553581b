"""Generate the full-loop SLAM scenario (slam.txt) for
golden/slam_harness.cpp plus slam_inputs.npz for
tests/test_reference_parity_slam.py.

A simulated robot trajectory through the analytic room; the SAME scan
sequence replays through the reference loop (slam_harness) and through
SlamNode.process_scan, and the pose traces are diffed.
"""

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan  # noqa: E402

# 256 cells @ 0.04 m = 10.24 m (LAYOUT_32x32=5, LAYOUT_256x256=8)
CELLSIZE = 0.04
LAYOUT_PART = 5
LAYOUT_GRID = 8
MAX_TRUNC = 3 * CELLSIZE

SIZE = 541
ANG_RES = math.radians(270.0 / SIZE)
PHI_MIN = -math.radians(135.0)
MAX_RANGE = 9.0
MIN_RANGE = 0.01
LOW_REFLECTIVITY_RANGE = 1.0

ICP_ITERS = 30
DIST_MAX = 0.5
DIST_MIN = 0.05
TRNS_MAX = 0.25     # TRNS_THRESH (ThreadLocalize.h:60)
ROT_MAX = 0.17      # ROT_THRESH
TRNS_MIN = 0.05     # TRNS_MIN
ROT_MIN = 0.03      # ROT_MIN

# RANSAC (mode 3 = TSD_PDFMatching, the reference's shipped default
# registration mode, config/single-laser.yaml:22)
RAN_TRIALS = 50
RAN_EPS = 0.15
RAN_SIZE_CTL = 140
RAN_PHI_MAX_DEG = 30.0
ZRAND_TSD = 0.25
RAN_SEED = 12345

SEGMENTS = rect_walls(1.5, 1.5, 8.5, 8.5)
CIRCLES = [((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)]

FOOTPRINT = (0.6, 0.6)    # w, h


def trajectory(n):
    """Arc through the room, ~2 cm / 0.5 deg per step (same shape as
    tests/test_slam_e2e.py)."""
    poses = []
    x, y, th = 5.12, 5.12, 0.2
    for _ in range(n):
        poses.append((x, y, th))
        x += 0.02 * math.cos(th)
        y += 0.02 * math.sin(th)
        th += math.radians(0.5)
    return poses


def se2(x, y, th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])


def fmt(vals):
    return " ".join("%.17g" % v for v in np.asarray(vals).ravel())


def main(out_txt, out_npz, mode=0):
    gt = trajectory(25)
    scans = []
    # deterministic range noise (sigma 3 mm, Hokuyo-class): perfectly
    # straight synthetic walls make the scene-normal windows exactly
    # collinear, where the reference's pcaAnalysis reconstructs the
    # short axis from `centroid +- extent/2` endpoints and the ~1e-15
    # extent cancels against the ~5 m centroid — the C++ normal
    # direction then collapses to ULP-quantized ratios (observed
    # (-1,-2)/sqrt(5), (0,1), ...) that no clean-arithmetic
    # implementation can reproduce.  Noise keeps every PCA window
    # well-conditioned, as real lidar data does (matcher-parity
    # investigation, round 5).
    rng = np.random.default_rng(99)
    for (x, y, th) in gt:
        r = simulate_scan(se2(x, y, th), SIZE, ANG_RES, PHI_MIN,
                          MAX_RANGE, SEGMENTS, CIRCLES)
        noise = rng.normal(0.0, 0.003, r.shape)
        r = np.where(np.isinf(r), np.inf, r + noise)
        scans.append(np.where(np.isinf(r), 1e30, r))

    T0 = se2(*gt[0])
    lines = []
    lines.append("grid %.17g %d %d %.17g"
                 % (CELLSIZE, LAYOUT_PART, LAYOUT_GRID, MAX_TRUNC))
    lines.append("sensor %d %.17g %.17g %.17g %.17g %.17g"
                 % (SIZE, ANG_RES, PHI_MIN, MAX_RANGE, MIN_RANGE,
                    LOW_REFLECTIVITY_RANGE))
    lines.append("icp %d %.17g %.17g" % (ICP_ITERS, DIST_MAX, DIST_MIN))
    lines.append("gates %.17g %.17g %.17g %.17g"
                 % (TRNS_MAX, ROT_MAX, TRNS_MIN, ROT_MIN))
    lines.append("mode %d %d %.17g %d %.17g %.17g %d"
                 % (mode, RAN_TRIALS, RAN_EPS, RAN_SIZE_CTL,
                    RAN_PHI_MAX_DEG, ZRAND_TSD, RAN_SEED))
    lines.append("tinit " + fmt(T0))
    lines.append("footprint %.17g %.17g %.17g %.17g"
                 % (gt[0][0], gt[0][1], FOOTPRINT[0], FOOTPRINT[1]))
    lines.append("nscan %d" % len(scans))
    for r in scans:
        lines.append("ranges " + fmt(r))
    with open(out_txt, "w") as f:
        f.write("\n".join(lines) + "\n")

    np.savez(out_npz,
             scans=np.asarray(scans),
             gt=np.asarray(gt),
             params=np.asarray([CELLSIZE, LAYOUT_GRID, MAX_TRUNC, SIZE,
                                ANG_RES, PHI_MIN, MAX_RANGE, MIN_RANGE,
                                LOW_REFLECTIVITY_RANGE, ICP_ITERS,
                                DIST_MAX, DIST_MIN, TRNS_MAX, ROT_MAX,
                                TRNS_MIN, ROT_MIN]),
             footprint=np.asarray(FOOTPRINT),
             mode=np.asarray(mode),
             ransac=np.asarray([RAN_TRIALS, RAN_EPS, RAN_SIZE_CTL,
                                RAN_PHI_MAX_DEG, ZRAND_TSD, RAN_SEED]))
    print(f"wrote {out_txt} and {out_npz}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2],
         int(sys.argv[3]) if len(sys.argv) > 3 else 0)
