"""Inputs for the RANSAC-matcher parity harness (golden/ransac_harness).

Builds the scene the matchers see in the live loop (ThreadLocalize.cpp
:513-568): a MODEL scan in its sensor frame, a SCENE scan from a nearby
pose, validity masks, and — for TSD_PDFMatching — a TSD grid pushed
with the model scan plus the model-sensor pose, stored in the
reference text format (TsdGrid.cpp:548-607, reloaded by the harness via
TsdGrid(path, FILE_SOURCE)).

Writes <outdir>/input.bin (layout: see ransac_harness.cpp),
<outdir>/grid.txt and <outdir>/inputs.npz (the arrays + parameters for
tests/test_reference_parity_ransac.py).
"""

import math
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N = 541
TRIALS = 10
EPS_THRESH = 0.15
SIZE_CONTROL = 40
PHI_MAX = 0.30           # keeps the EXP trace's per-candidate file count sane
RESOLUTION = math.radians(270.0 / N)
SEED = 0x1234ABCD

BEAM = dict(zhit=0.45, zphi=0.0, zshort=0.25, zmax=0.05, zrand=0.25,
            percentage_points_in_c=0.9, rangemax=20.0,
            sigphi=math.pi / 180.0 * 3, sighit=0.2, lamshort=0.08,
            max_angle_diff=3.0)
ZRAND_TSD = 0.05


def main(outdir):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ohm_tsd_slam.config import GridConfig
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.sensor.polar2d import (
        SensorPolar2D,
        data_to_cartesian,
        standard_mask,
    )
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

    geom = SensorPolar2D(size=N, angular_res=RESOLUTION,
                         phi_min=math.radians(-135.0), max_range=9.0,
                         min_range=0.01, low_reflectivity_range=1.0)
    walls = rect_walls(1.2, 1.2, 5.2, 5.2)
    circles = [((4.2, 4.4), 0.4), ((2.0, 4.3), 0.3)]
    pose_m = np.array(se2.make(3.2, 3.2, 0.15, dtype=np.float64))
    pose_s = np.array(se2.make(3.27, 3.14, 0.22, dtype=np.float64))

    rng = np.random.default_rng(7)

    def scan(pose):
        r = simulate_scan(pose, N, geom.angular_res, geom.phi_min,
                          geom.max_range, segments=walls, circles=circles)
        # realistic range noise: analytically-exact collinear wall
        # points give the reference's calcNormals a zero short-axis
        # extent and a 0/0 NaN normal (RandomMatching.cpp:146-160 with
        # exact data) — real lidar never does
        r = np.where(np.isfinite(r), r + 0.002 * rng.standard_normal(N),
                     r)
        data, mask = standard_mask(geom, jnp.asarray(r, jnp.float64))
        pts, valid = data_to_cartesian(geom, data, mask)
        return (np.asarray(pts, np.float64), np.asarray(valid),
                data, mask, np.asarray(r, np.float64))

    M, maskM, data_m, mask_m, ranges_m = scan(pose_m)
    S, maskS, _, _, _ = scan(pose_s)

    # grid for the TSD matcher: the model scan fused from pose_m (the
    # harness pushes the identical scan through the reference TsdGrid —
    # push-for-push parity is asserted by test_reference_parity.py)
    gcfg = GridConfig(map_size=8, cellsize=0.025)
    grid = create(gcfg, dtype=jnp.float64)
    grid = push(grid, geom, jnp.asarray(pose_m), data_m, mask_m)

    with open(os.path.join(outdir, "input.bin"), "wb") as f:
        f.write(struct.pack("<i", N))
        f.write(M.astype("<f8").tobytes())
        f.write(maskM.astype(np.uint8).tobytes())
        f.write(S.astype("<f8").tobytes())
        f.write(maskS.astype(np.uint8).tobytes())
        f.write(struct.pack("<I", TRIALS))
        f.write(struct.pack("<d", EPS_THRESH))
        f.write(struct.pack("<I", SIZE_CONTROL))
        f.write(struct.pack("<d", PHI_MAX))
        f.write(struct.pack("<d", RESOLUTION))
        for k in ("zhit", "zphi", "zshort", "zmax", "zrand",
                  "percentage_points_in_c", "rangemax", "sigphi",
                  "sighit", "lamshort", "max_angle_diff"):
            f.write(struct.pack("<d", BEAM[k]))
        f.write(struct.pack("<d", ZRAND_TSD))
        f.write(np.asarray(pose_m, "<f8").tobytes())
        f.write(struct.pack("<I", SEED))
        f.write(struct.pack("<d", gcfg.cellsize))
        f.write(struct.pack("<i", 5))              # LAYOUT_32x32
        f.write(struct.pack("<i", gcfg.map_size))
        f.write(struct.pack("<d", grid.max_truncation))
        f.write(struct.pack("<d", geom.angular_res))
        f.write(struct.pack("<d", geom.phi_min))
        f.write(struct.pack("<d", geom.max_range))
        f.write(struct.pack("<d", geom.min_range))
        f.write(struct.pack("<d", geom.low_reflectivity_range))
        f.write(ranges_m.astype("<f8").tobytes())

    np.savez(os.path.join(outdir, "inputs.npz"),
             M=M, maskM=maskM, S=S, maskS=maskS, pose_m=pose_m,
             ranges_m=ranges_m, data_m=np.asarray(data_m),
             mask_m=np.asarray(mask_m), map_size=gcfg.map_size,
             cellsize=gcfg.cellsize,
             trials=TRIALS, eps_thresh=EPS_THRESH,
             size_control=SIZE_CONTROL, phi_max=PHI_MAX,
             resolution=RESOLUTION, seed=SEED, zrand_tsd=ZRAND_TSD,
             **{f"beam_{k}": v for k, v in BEAM.items()})
    print("wrote", outdir)


if __name__ == "__main__":
    main(sys.argv[1])
