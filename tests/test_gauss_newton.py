"""Direct Gauss-Newton scan-to-map registration (registration/gauss_newton).

The matcher must recover known pose perturbations against a fused map of
the analytic room, and plug into localize_step as RegMode.GN.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import GridConfig, RegMode
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, push
from ohm_tsd_slam.registration import GnParams, match_gauss_newton
from ohm_tsd_slam.registration.icp import IcpParams
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.slam.localize import LocalizeParams, localize_step
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

CFG = GridConfig(map_size=8, cellsize=0.04)
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
WALLS = rect_walls(1.5, 1.5, 8.5, 8.5)
CIRCLES = [((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)]


def _scan(pose_np):
    return simulate_scan(pose_np, GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=WALLS, circles=CIRCLES)


@pytest.fixture(scope="module")
def scene():
    geom = polar2d.SensorPolar2D(**GEOM)
    grid = create(CFG, dtype=jnp.float64)
    for pose_xyt in [(5.12, 5.12, 0.2), (5.3, 5.0, 0.0)]:
        pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
        data, mask = polar2d.standard_mask(geom, jnp.asarray(_scan(pose)))
        grid = push(grid, geom, jnp.asarray(pose), data, mask)
    return grid, geom


@pytest.mark.parametrize("dx,dy,dth", [
    (0.05, -0.03, 0.04),
    (-0.08, 0.06, -0.06),
    (0.12, 0.10, 0.08),
])
def test_recovers_perturbation(scene, dx, dy, dth):
    grid, geom = scene
    true_pose = np.array(se2.make(5.12, 5.12, 0.2, dtype=jnp.float64))
    data, mask = polar2d.standard_mask(geom, jnp.asarray(_scan(true_pose)))
    scene_pts, scene_mask = polar2d.data_to_cartesian(geom, data, mask)

    # start from a wrong pose estimate; GN must move it back
    start = se2.make(5.12 + dx, 5.12 + dy, 0.2 + dth, dtype=jnp.float64)
    res = match_gauss_newton(grid, start, scene_pts, scene_mask,
                             GnParams(iterations=40))
    recovered = np.array(start @ res.T)
    err_t = np.linalg.norm(recovered[:2, 2] - true_pose[:2, 2])
    err_r = abs(float(se2.angle(jnp.asarray(recovered))) - 0.2)
    assert err_t < 0.01, (err_t, recovered[:2, 2])
    assert err_r < 0.01, err_r
    assert float(res.rms) < 0.02
    assert int(res.matches) > 100


def test_identity_when_aligned(scene):
    grid, geom = scene
    pose = se2.make(5.12, 5.12, 0.2, dtype=jnp.float64)
    data, mask = polar2d.standard_mask(
        geom, jnp.asarray(_scan(np.array(pose))))
    pts, pmask = polar2d.data_to_cartesian(geom, data, mask)
    res = match_gauss_newton(grid, pose, pts, pmask, GnParams())
    T = np.array(res.T)
    assert np.linalg.norm(T[:2, 2]) < 2e-3
    assert abs(float(se2.angle(res.T))) < 2e-3


def test_too_few_points_returns_identity(scene):
    grid, geom = scene
    pose = se2.make(5.12, 5.12, 0.2, dtype=jnp.float64)
    pts = jnp.zeros((geom.size, 2), jnp.float64)
    pmask = jnp.zeros((geom.size,), bool)
    res = match_gauss_newton(grid, pose, pts, pmask, GnParams())
    np.testing.assert_allclose(np.array(res.T), np.eye(3), atol=1e-9)
    assert int(res.matches) == 0


def test_localize_step_gn_mode(scene):
    grid, geom = scene
    true_pose = np.array(se2.make(5.12, 5.12, 0.2, dtype=jnp.float64))
    data, mask = polar2d.standard_mask(geom, jnp.asarray(_scan(true_pose)))

    params = LocalizeParams(
        geom=geom,
        icp=IcpParams(iterations=25,
                      bounds=(0.0, CFG.size_meters, 0.0, CFG.size_meters)),
        mode=int(RegMode.GN),
        gn=GnParams(iterations=40),
    )
    start = se2.make(5.12 + 0.06, 5.12 - 0.05, 0.2 + 0.05,
                     dtype=jnp.float64)
    res = localize_step(grid, start, start, data, mask, params)
    assert not bool(res.reg_error)
    rec = np.array(res.pose)
    assert np.linalg.norm(rec[:2, 2] - true_pose[:2, 2]) < 0.01
    # the move back to the true pose is significant (> TRNS_MIN)
    assert bool(res.significant)
