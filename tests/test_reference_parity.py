"""Numerical parity against the COMPILED C++ REFERENCE.

golden/harness.cpp compiles the unmodified reference sources
(/root/reference/src/obvision/reconstruct/...) and dumps exact float64
state for the analytic-room scenario; these tests assert the JAX
framework reproduces that state.  This replaces the hand-written NumPy
oracles as the source of truth for:

  * SensorPolar2D::setStandardMask      (SensorPolar2D.cpp:59-98)
  * TsdGrid::push / addTsd / isInRange  (TsdGrid.cpp:217-284,
                                         TsdGridPartition.h:170-212,
                                         TsdGridComponent.cpp:43-124)
  * TsdGrid::freeFootprint              (TsdGrid.cpp:609-638)
  * RayCastPolar2D::calcCoordsFromCurrentViewMask
                                        (RayCastPolar2D.cpp:113-281)
  * RayCastAxisAligned2D::calcCoords    (RayCastAxisAligned2D.cpp:13-105)
  * TsdGrid::storeGrid round-trip       (TsdGrid.cpp:548-607)
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.grid import state as grid_state
from ohm_tsd_slam.grid.axis_aligned import occupancy_grid
from ohm_tsd_slam.grid.checkpoint import load_text
from ohm_tsd_slam.grid.push import push
from ohm_tsd_slam.grid.raycast import raycast
from ohm_tsd_slam.grid.raycast_fast import raycast_fast
from ohm_tsd_slam.sensor.polar2d import SensorPolar2D, standard_mask

from golden_io import ROOM_BIN, ROOM_STORE, Scenario, load_golden

pytestmark = pytest.mark.skipif(
    not os.path.exists(ROOM_BIN),
    reason="golden data not generated (make -C golden)")


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def scenario():
    return Scenario()


@pytest.fixture(scope="module")
def geom(scenario):
    s = scenario
    return SensorPolar2D(
        size=s.size, angular_res=s.angular_res, phi_min=s.phi_min,
        max_range=s.max_range, min_range=s.min_range,
        low_reflectivity_range=s.low_reflectivity_range)


@pytest.fixture(scope="module")
def pushed_grids(scenario, geom):
    """Replay the scenario through the JAX pipeline; returns the list of
    grid states after the footprint and after each push."""
    s = scenario
    cfg = GridConfig(map_size=s.layout_grid, cellsize=s.cellsize,
                     truncation_radius=s.max_trunc / s.cellsize,
                     tile_dim=2 ** s.layout_part)
    grid = grid_state.create(cfg, dtype=jnp.float64)
    states = {}
    if s.footprint is not None:
        cx, cy, w, h = s.footprint
        grid = grid_state.free_footprint(grid, np.array([cx, cy]), w, h)
        states["after_footprint"] = grid
    for p, (pose, ranges) in enumerate(zip(s.push_poses, s.push_ranges)):
        data, mask = standard_mask(geom, jnp.asarray(ranges))
        grid = push(grid, geom, jnp.asarray(pose), data, mask)
        states["after_push%02d" % p] = grid
        states["scan%02d" % p] = (data, mask)
    states["final"] = grid
    return states


def _grid_close(grid, g, tag):
    tsd = np.asarray(grid.tsd)
    ref = g[tag + ".tsd"]
    assert np.array_equal(np.isnan(tsd), np.isnan(ref)), tag + " NaN pattern"
    m = ~np.isnan(ref)
    np.testing.assert_allclose(tsd[m], ref[m], rtol=0, atol=1e-12,
                               err_msg=tag + " tsd")
    np.testing.assert_allclose(np.asarray(grid.weight), g[tag + ".weight"],
                               rtol=0, atol=1e-12, err_msg=tag + " weight")
    state = np.asarray(grid.tile_init).astype(np.int32) * 2
    empty = (~np.asarray(grid.tile_init)) & (np.asarray(grid.tile_initw) > 0)
    state = state + empty.astype(np.int32)
    np.testing.assert_array_equal(state, g[tag + ".state"],
                                  err_msg=tag + " tile state")
    # _initWeight is compared only where the reference still reads it
    # (uninitialized tiles); the reference never resets it on init.
    uninit = g[tag + ".state"] != 2
    np.testing.assert_allclose(
        np.asarray(grid.tile_initw)[uninit], g[tag + ".initw"][uninit],
        rtol=0, atol=1e-12, err_msg=tag + " initw")


def test_standard_mask_parity(golden, scenario, pushed_grids):
    for p in range(len(scenario.push_poses)):
        data, mask = pushed_grids["scan%02d" % p]
        np.testing.assert_array_equal(
            np.asarray(mask), golden["scan%02d.mask" % p].astype(bool),
            err_msg="scan %d mask" % p)
        d = np.asarray(data)
        ref = golden["scan%02d.data" % p]
        assert np.array_equal(np.isinf(d), np.isinf(ref))
        fin = ~np.isinf(ref)
        np.testing.assert_allclose(d[fin], ref[fin], rtol=0, atol=0,
                                   err_msg="scan %d data" % p)


def test_footprint_parity(golden, pushed_grids):
    _grid_close(pushed_grids["after_footprint"], golden, "after_footprint")


@pytest.mark.parametrize("p", range(6))
def test_push_parity(golden, pushed_grids, p):
    _grid_close(pushed_grids["after_push%02d" % p], golden,
                "after_push%02d" % p)


@pytest.mark.parametrize("q", range(3))
def test_raycast_parity(golden, scenario, geom, pushed_grids, q):
    """The exact dense march must agree with the reference beam-for-beam."""
    grid = pushed_grids["final"]
    res = raycast(grid, geom, jnp.asarray(scenario.query_poses[q]))
    ref_mask = golden["ray%02d.mask" % q].astype(bool)
    mask = np.asarray(res.mask)
    np.testing.assert_array_equal(mask, ref_mask, err_msg="ray %d mask" % q)
    ref_c = golden["ray%02d.coords" % q]
    ref_n = golden["ray%02d.normals" % q]
    np.testing.assert_allclose(np.asarray(res.coords)[mask], ref_c[mask],
                               rtol=0, atol=1e-9,
                               err_msg="ray %d coords" % q)
    np.testing.assert_allclose(np.asarray(res.normals)[mask], ref_n[mask],
                               rtol=0, atol=1e-9,
                               err_msg="ray %d normals" % q)
    assert int(golden["ray%02d.cnt" % q][0]) == int(mask.sum())


@pytest.mark.parametrize("q", range(3))
def test_raycast_fast_parity(golden, scenario, geom, pushed_grids, q):
    """The isocontour-intersection caster must agree with the compiled
    reference beam-for-beam too (its window replay reproduces the exact
    march's sampling semantics)."""
    grid = pushed_grids["final"]
    res = raycast_fast(grid, geom, jnp.asarray(scenario.query_poses[q]))
    ref_mask = golden["ray%02d.mask" % q].astype(bool)
    mask = np.asarray(res.mask)
    np.testing.assert_array_equal(mask, ref_mask,
                                  err_msg="ray %d fast mask" % q)
    ref_c = golden["ray%02d.coords" % q]
    ref_n = golden["ray%02d.normals" % q]
    np.testing.assert_allclose(np.asarray(res.coords)[mask], ref_c[mask],
                               rtol=0, atol=1e-9,
                               err_msg="ray %d fast coords" % q)
    np.testing.assert_allclose(np.asarray(res.normals)[mask], ref_n[mask],
                               rtol=0, atol=1e-9,
                               err_msg="ray %d fast normals" % q)


def test_axis_aligned_parity(golden, pushed_grids):
    grid = pushed_grids["final"]
    from ohm_tsd_slam.grid.axis_aligned import surface_points

    res = occupancy_grid(grid)
    # char grid: the reference writes 0 (free) / -1 (unknown); occupied
    # stamps (100) come from the coords list, which the harness did not
    # apply — compare only the free/unknown channel.
    got_occ = np.asarray(res.occupancy)
    got_chars = np.where(got_occ == 100, 0, got_occ).astype(np.int8)
    ref_occ = golden["axis.occ"].astype(np.int8)
    # cells the reference marked free but we stamped occupied are fine
    # (occupied implies a crossing next to free space); mask them out of
    # the char comparison by mapping got 100 -> ref value there
    stamped = got_occ == 100
    np.testing.assert_array_equal(
        np.where(stamped, ref_occ, got_chars), ref_occ,
        err_msg="occ char grid")

    # event count incl. the reference's tile-boundary duplicates
    assert int(golden["axis.cnt"][0]) == 2 * int(res.n_surface)

    # coordinates: compare as unique sets (the reference emits duplicates
    # in per-partition scan order)
    pts, mask = surface_points(grid)
    got = np.unique(np.asarray(pts)[np.asarray(mask)], axis=0)
    ref = np.unique(golden["axis.coords"], axis=0)
    assert got.shape == ref.shape
    def key(a):
        return np.lexsort((a[:, 1], a[:, 0]))
    np.testing.assert_allclose(got[key(got)], ref[key(ref)],
                               rtol=0, atol=1e-12, err_msg="axis coords")


def test_store_grid_roundtrip(golden, pushed_grids):
    grid = load_text(ROOM_STORE, dtype=jnp.float64)
    final = pushed_grids["final"]
    ref = golden["after_push05.tsd"]
    tsd = np.asarray(grid.tsd)
    assert np.array_equal(np.isnan(tsd), np.isnan(ref))
    m = ~np.isnan(ref)
    # storeGrid writes with default 6-digit stream precision
    np.testing.assert_allclose(tsd[m], ref[m], rtol=1e-5, atol=1e-6)
    # header values pass through 6-digit text
    assert grid.cell_size == pytest.approx(final.cell_size, rel=1e-5)
    assert grid.max_truncation == pytest.approx(final.max_truncation,
                                                rel=1e-5)
