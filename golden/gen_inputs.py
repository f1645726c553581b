"""Generate the golden-scenario input file for golden/harness.cpp.

Analytic room (same generator the unit tests use:
ohm_tsd_slam/utils/testing.py) with a circular obstacle, a short
trajectory of push poses, and a few raycast query poses.  Everything is
float64, printed with %.17g so the C++ side parses bit-identical values.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan  # noqa: E402

# grid: 256 cells @ 0.025 m = 6.4 m, 32x32 partitions (LAYOUT_32x32=5,
# LAYOUT_256x256=8), truncation 3 cells
CELLSIZE = 0.025
LAYOUT_PART = 5
LAYOUT_GRID = 8
MAX_TRUNC = 3 * CELLSIZE

# Hokuyo-like scan: 1081 beams x 0.25 deg = 270 deg FOV
SIZE = 1081
ANG_RES = np.deg2rad(0.25)
PHI_MIN = -np.deg2rad(135.0)
MAX_RANGE = 30.0
MIN_RANGE = 0.01
LOW_REFLECTIVITY_RANGE = 2.0

SEGMENTS = rect_walls(0.5, 0.5, 5.9, 5.9) + [
    ((2.2, 0.5), (2.2, 2.4)),           # interior wall stub
]
CIRCLES = [((4.2, 2.0), 0.35)]

# push trajectory: a loop through the room with rotation
POSES = [
    (3.2, 3.2, 0.00),
    (3.4, 3.1, 0.35),
    (3.7, 3.3, 0.80),
    (3.6, 3.8, 1.60),
    (3.1, 4.0, 2.50),
    (2.7, 3.5, -2.60),
]

# raycast query poses over the final map (one on-trajectory, one offset,
# one near a wall)
QUERIES = [
    (3.2, 3.2, 0.00),
    (3.05, 3.55, 0.60),
    (1.2, 1.1, 0.75),
]


def se2(x, y, th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])


def fmt(vals):
    return " ".join("%.17g" % v for v in np.asarray(vals).ravel())


def main(path):
    lines = []
    lines.append("grid %.17g %d %d %.17g"
                 % (CELLSIZE, LAYOUT_PART, LAYOUT_GRID, MAX_TRUNC))
    lines.append("sensor %d %.17g %.17g %.17g %.17g %.17g"
                 % (SIZE, ANG_RES, PHI_MIN, MAX_RANGE, MIN_RANGE,
                    LOW_REFLECTIVITY_RANGE))
    lines.append("footprint %.17g %.17g %.17g %.17g"
                 % (POSES[0][0], POSES[0][1], 0.6, 0.6))
    lines.append("npush %d" % len(POSES))
    for (x, y, th) in POSES:
        T = se2(x, y, th)
        ranges = simulate_scan(T, SIZE, ANG_RES, PHI_MIN, MAX_RANGE,
                               SEGMENTS, CIRCLES)
        # istream operator>> cannot parse "inf"; 1e30 > max_range is
        # converted to +inf by maskInvalidDepth on both sides
        ranges = np.where(np.isinf(ranges), 1e30, ranges)
        lines.append("pose " + fmt(T))
        lines.append("ranges " + fmt(ranges))
    lines.append("nquery %d" % len(QUERIES))
    for (x, y, th) in QUERIES:
        lines.append("pose " + fmt(se2(x, y, th)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", path)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "data/room.txt")
