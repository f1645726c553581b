"""TSD push kernel vs the partition-based NumPy oracle.

Validates the dense vectorized push (ohm_tsd_slam/grid/push.py)
against the halo'd per-partition float64 oracle built straight from
TsdGrid.cpp:217-284 / TsdGridComponent.cpp:43-124 /
TsdGridPartition.h:170-212."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, push
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan
from oracle.oracle_grid import OracleGrid, OracleSensor

# 128-cell grid at 5 cm → 6.4 m world; 4x4 tiles of 32
CFG = GridConfig(map_size=7, cellsize=0.05, truncation_radius=3.0)
GEOM = dict(size=271, angular_res=math.radians(1.0),
            phi_min=math.radians(-135.0), max_range=4.0,
            min_range=0.01, low_reflectivity_range=2.0)


def _setup(pose_xyt=(3.2, 3.2, 0.3), with_inf=True):
    pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
    walls = rect_walls(0.8, 0.8, 5.6, 5.6)
    ranges = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                           GEOM["phi_min"], GEOM["max_range"],
                           segments=walls, circles=[((4.5, 4.5), 0.4)])
    if not with_inf:
        ranges = np.where(np.isinf(ranges), GEOM["max_range"] * 0.99, ranges)
    return pose, ranges


def _push_both(pose, ranges, n_pushes=1):
    geom = polar2d.SensorPolar2D(**GEOM)
    osens = OracleSensor(**GEOM)
    osens.transform(pose)
    osens.set_data(ranges)
    osens.set_standard_mask()

    ogrid = OracleGrid(CFG.cellsize, CFG.cells_per_side, CFG.tile_dim,
                       CFG.max_truncation)
    grid = create(CFG, dtype=jnp.float64)

    data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
    for _ in range(n_pushes):
        ogrid.push(osens)
        grid = push(grid, geom, jnp.asarray(pose), data, mask)
    return grid, ogrid


def _compare(grid, ogrid):
    got_tsd = np.array(grid.tsd)
    got_w = np.array(grid.weight)
    exp_tsd = ogrid.dense_tsd()
    exp_w = ogrid.dense_weight()

    # tile states
    exp_init = np.array([[p.initialized for p in row]
                         for row in ogrid.parts])
    exp_initw = np.array([[p.init_weight for p in row]
                          for row in ogrid.parts])
    np.testing.assert_array_equal(np.array(grid.tile_init), exp_init)
    np.testing.assert_allclose(np.array(grid.tile_initw), exp_initw)

    np.testing.assert_array_equal(np.isnan(got_tsd), np.isnan(exp_tsd))
    m = ~np.isnan(exp_tsd)
    np.testing.assert_allclose(got_tsd[m], exp_tsd[m], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got_w, exp_w, rtol=1e-10, atol=1e-12)


def test_single_push_matches_oracle():
    pose, ranges = _setup()
    grid, ogrid = _push_both(pose, ranges)
    _compare(grid, ogrid)


def test_repeated_push_matches_oracle():
    """Weighted running average + weight cap after several fusions."""
    pose, ranges = _setup()
    grid, ogrid = _push_both(pose, ranges, n_pushes=4)
    _compare(grid, ogrid)


def test_push_multi_pose_matches_oracle():
    """Pushes from different poses (tests empty-tile bookkeeping and
    re-initialization paths)."""
    geom = polar2d.SensorPolar2D(**GEOM)
    ogrid = OracleGrid(CFG.cellsize, CFG.cells_per_side, CFG.tile_dim,
                       CFG.max_truncation)
    grid = create(CFG, dtype=jnp.float64)

    for pose_xyt in [(3.2, 3.2, 0.3), (2.2, 2.5, 1.2), (4.0, 3.0, -2.0)]:
        pose, ranges = _setup(pose_xyt)
        osens = OracleSensor(**GEOM)
        osens.transform(pose)
        osens.set_data(ranges)
        osens.set_standard_mask()
        ogrid.push(osens)

        data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
        grid = push(grid, geom, jnp.asarray(pose), data, mask)
    _compare(grid, ogrid)


def test_push_no_inf_matches_oracle():
    pose, ranges = _setup(with_inf=False)
    grid, ogrid = _push_both(pose, ranges)
    _compare(grid, ogrid)


def test_push_sensor_outside_grid_is_noop():
    """A sensor far outside the map writes nothing (no cell in view)."""
    geom = polar2d.SensorPolar2D(**GEOM)
    grid = create(CFG, dtype=jnp.float64)
    pose = jnp.asarray(np.array(se2.make(50.0, 50.0, 0.0,
                                         dtype=jnp.float64)))
    data = jnp.full((geom.size,), jnp.inf)
    mask = jnp.zeros((geom.size,), bool)
    g = push(grid, geom, pose, data, mask)
    assert not np.isfinite(np.array(g.tsd)).any()
    assert not np.array(g.tile_init).any()


def test_push_all_masked_scan_matches_oracle():
    """A scan whose every beam is invalid (all ranges +inf after the
    standard mask) must update the grid exactly as the reference does."""
    pose, _ = _setup()
    ranges = np.full(GEOM["size"], np.inf)
    grid, ogrid = _push_both(pose, ranges)
    _compare(grid, ogrid)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, None),
                                       (jnp.float32, 1e-4)])
def test_multi_push_accumulation_matches_oracle(dtype, tol):
    """Three overlapping pushes from nearby poses against the float64
    oracle.  float64 must match to rounding; float32 (the on-card
    default) agrees on the written-cell pattern and to 1e-4 in tsd,
    except at most a few cells whose bearing sits on a beam-bin edge."""
    geom = polar2d.SensorPolar2D(**GEOM)
    ogrid = OracleGrid(CFG.cellsize, CFG.cells_per_side, CFG.tile_dim,
                       CFG.max_truncation)
    grid = create(CFG, dtype=dtype)
    for pose_xyt in [(3.2, 3.2, 0.4), (3.5, 3.3, 0.5), (3.0, 3.4, 0.3)]:
        pose, ranges = _setup(pose_xyt)
        osens = OracleSensor(**GEOM)
        osens.transform(pose)
        osens.set_data(ranges)
        osens.set_standard_mask()
        ogrid.push(osens)
        data, mask = polar2d.standard_mask(geom,
                                           jnp.asarray(ranges, dtype))
        grid = push(grid, geom, jnp.asarray(pose, dtype), data, mask)
    if tol is None:
        _compare(grid, ogrid)
        return
    got = np.array(grid.tsd, np.float64)
    exp = ogrid.dense_tsd()
    assert (np.isnan(got) != np.isnan(exp)).mean() < 5e-4
    both = ~np.isnan(got) & ~np.isnan(exp)
    assert np.isfinite(got).sum() > 1000
    assert (np.abs(got[both] - exp[both]) > tol).mean() < 5e-4
    np.testing.assert_allclose(np.array(grid.weight, np.float64),
                               ogrid.dense_weight(), atol=1e-5)
