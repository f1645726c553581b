"""Sensor model vs the NumPy oracle (reference formulas,
SensorPolar2D.cpp / Sensor.cpp)."""

import math

import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan
from oracle.oracle_grid import OracleSensor

GEOM = dict(size=181, angular_res=math.radians(1.0),
            phi_min=math.radians(-90.0), max_range=10.0)


def _scan(pose):
    walls = rect_walls(0.5, 0.5, 7.5, 7.5)
    return simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=walls, circles=[((5.0, 5.0), 0.6)])


def test_back_project_matches_oracle():
    geom = polar2d.SensorPolar2D(**GEOM)
    pose = np.array(se2.make(3.0, 4.0, 0.5, dtype=jnp.float64))
    osens = OracleSensor(**GEOM)
    osens.transform(pose)

    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 10, size=(500, 2))
    idx = np.array(polar2d.back_project(geom, jnp.asarray(pose),
                                        jnp.asarray(pts)))
    expect = np.array([osens.back_project_point(p) for p in pts])
    np.testing.assert_array_equal(idx, expect)


def test_back_project_ray_roundtrip():
    """Property: a point on beam i at a valid range back-projects to i."""
    geom = polar2d.SensorPolar2D(**GEOM)
    pose = se2.make(1.0, 2.0, -0.3, dtype=jnp.float64)
    rays = geom.rays_local(jnp.float64)
    r = 3.7
    world = se2.transform_points(pose, rays * r)
    idx = np.array(polar2d.back_project(geom, pose, world))
    np.testing.assert_array_equal(idx, np.arange(geom.size))


def test_standard_mask_matches_oracle():
    geom = polar2d.SensorPolar2D(**GEOM)
    pose = np.array(se2.make(3.0, 4.0, 0.5, dtype=jnp.float64))
    ranges = _scan(pose)
    # inject pathologies: zero, NaN, > max_range
    ranges[5] = 0.0
    ranges[17] = np.nan
    ranges[33] = 11.5

    osens = OracleSensor(**GEOM)
    osens.set_data(ranges)
    osens.set_standard_mask()

    data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
    np.testing.assert_array_equal(np.array(mask), osens.mask)
    np.testing.assert_allclose(np.array(data), osens.data)


def test_data_to_cartesian_matches_oracle():
    geom = polar2d.SensorPolar2D(**GEOM)
    pose = np.array(se2.make(3.0, 4.0, 0.5, dtype=jnp.float64))
    ranges = _scan(pose)
    osens = OracleSensor(**GEOM)
    osens.set_data(ranges)
    osens.set_standard_mask()
    oc, om = osens.data_to_cartesian_mask()

    data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
    coords, valid = polar2d.data_to_cartesian(geom, data, mask)
    np.testing.assert_array_equal(np.array(valid), om)
    np.testing.assert_allclose(np.array(coords), oc, atol=1e-12)
