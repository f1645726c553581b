"""Polar raycast vs the scalar-march NumPy oracle, plus the
self-consistency property the reference implicitly relies on (a raycast
of a grid built from one scan reproduces that scan)."""

import math

import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, push, raycast
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan
from oracle.oracle_grid import OracleGrid, OracleSensor

CFG = GridConfig(map_size=7, cellsize=0.05, truncation_radius=3.0)
GEOM = dict(size=271, angular_res=math.radians(1.0),
            phi_min=math.radians(-135.0), max_range=4.0,
            min_range=0.01, low_reflectivity_range=2.0)


def _build(pose_xyt=(3.2, 3.2, 0.3)):
    geom = polar2d.SensorPolar2D(**GEOM)
    pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
    walls = rect_walls(0.8, 0.8, 5.6, 5.6)
    ranges = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                           GEOM["phi_min"], GEOM["max_range"],
                           segments=walls, circles=[((4.5, 4.5), 0.4)])

    osens = OracleSensor(**GEOM)
    osens.transform(pose)
    osens.set_data(ranges)
    osens.set_standard_mask()
    ogrid = OracleGrid(CFG.cellsize, CFG.cells_per_side, CFG.tile_dim,
                       CFG.max_truncation)
    ogrid.push(osens)

    grid = create(CFG, dtype=jnp.float64)
    data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
    grid = push(grid, geom, jnp.asarray(pose), data, mask)
    return geom, pose, grid, ogrid, osens


def test_raycast_matches_oracle():
    geom, pose, grid, ogrid, osens = _build()
    oc, on, om = ogrid.raycast(osens)
    res = raycast(grid, geom, jnp.asarray(pose))

    np.testing.assert_array_equal(np.array(res.mask), om)
    m = om
    np.testing.assert_allclose(np.array(res.coords)[m], oc[m],
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.array(res.normals)[m], on[m],
                               rtol=1e-9, atol=1e-10)


def test_raycast_other_pose_matches_oracle():
    """Render from a pose different from the one that built the grid."""
    geom, pose, grid, ogrid, osens = _build()
    pose2 = np.array(se2.make(2.9, 3.4, 0.8, dtype=jnp.float64))
    osens.T = np.eye(3)
    osens.transform(pose2)
    oc, on, om = ogrid.raycast(osens)
    res = raycast(grid, geom, jnp.asarray(pose2))

    np.testing.assert_array_equal(np.array(res.mask), om)
    m = om
    np.testing.assert_allclose(np.array(res.coords)[m], oc[m],
                               rtol=1e-9, atol=1e-10)


def test_raycast_self_consistency():
    """Rendered ranges approximate the pushed scan (within a cell)."""
    geom, pose, grid, _, _ = _build()
    walls = rect_walls(0.8, 0.8, 5.6, 5.6)
    ranges = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                           GEOM["phi_min"], GEOM["max_range"],
                           segments=walls, circles=[((4.5, 4.5), 0.4)])
    res = raycast(grid, geom, jnp.asarray(pose))
    m = np.array(res.mask) & np.isfinite(ranges)
    assert m.sum() > geom.size * 0.6
    np.testing.assert_allclose(np.array(res.ranges)[m], ranges[m],
                               atol=2.5 * CFG.cellsize)


def test_raycast_sensor_outside_grid():
    geom, pose, grid, _, _ = _build()
    pose_out = np.array(se2.make(-5.0, -5.0, 0.0, dtype=jnp.float64))
    res = raycast(grid, geom, jnp.asarray(pose_out))
    assert not bool(np.array(res.mask).any())
