"""Differentiable renderer: finite-difference verification of pose and
TSD-cell gradients (north-star correctness, BASELINE.md)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, push
from ohm_tsd_slam.grid.render import render_ranges
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

CFG = GridConfig(map_size=8, cellsize=0.04)
GEOM = dict(size=181, angular_res=math.radians(1.5),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)


def _make_grid():
    geom = polar2d.SensorPolar2D(**GEOM)
    grid = create(CFG, dtype=jnp.float64)
    walls = rect_walls(1.5, 1.5, 8.5, 8.5)
    for pose_xyt in [(5.12, 5.12, 0.2), (5.4, 4.9, -0.3)]:
        pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
        r = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                          GEOM["phi_min"], GEOM["max_range"],
                          segments=walls,
                          circles=[((7.0, 7.2), 0.5)])
        data, mask = polar2d.standard_mask(geom, jnp.asarray(r))
        grid = push(grid, geom, jnp.asarray(pose), data, mask)
    return grid, geom


@pytest.fixture(scope="module")
def scene():
    return _make_grid()


@pytest.mark.parametrize("use_fast", [False, True])
def test_pose_gradients_match_fd(scene, use_fast):
    grid, geom = scene
    key = jax.random.PRNGKey(0)
    w = jax.random.normal(key, (geom.size,), dtype=jnp.float64)

    def loss(xyt):
        pose = se2.make(xyt[0], xyt[1], xyt[2], dtype=jnp.float64)
        ranges, hit, _ = render_ranges(grid, geom, pose, use_fast=use_fast)
        return jnp.sum(w * ranges)

    x0 = jnp.array([5.2, 5.05, 0.15], dtype=jnp.float64)
    g = jax.grad(loss)(x0)
    assert np.all(np.isfinite(np.array(g)))

    h = 1e-6
    fd = np.zeros(3)
    for i in range(3):
        e = jnp.zeros(3, jnp.float64).at[i].set(h)
        fd[i] = (loss(x0 + e) - loss(x0 - e)) / (2 * h)
    np.testing.assert_allclose(np.array(g), fd, rtol=2e-4, atol=1e-6)


def test_cell_gradients_match_fd(scene):
    grid, geom = scene
    pose = se2.make(5.2, 5.05, 0.15, dtype=jnp.float64)

    def loss(tsd):
        import dataclasses
        g2 = dataclasses.replace(grid, tsd=tsd)
        ranges, _, _ = render_ranges(g2, geom, pose, use_fast=False)
        return jnp.sum(ranges)

    dtsd = jax.grad(loss)(grid.tsd)
    dtsd_np = np.array(dtsd)
    assert np.all(np.isfinite(dtsd_np))
    nz = np.argwhere(dtsd_np != 0.0)
    # Every hit beam contributes a 4-cell stencil; stencils overlap.
    assert len(nz) > 50

    h = 1e-6
    rng = np.random.default_rng(1)
    picks = rng.choice(len(nz), size=8, replace=False)
    for k in picks:
        iy, ix = nz[k]
        e = jnp.zeros_like(grid.tsd).at[iy, ix].set(h)
        fd = (loss(grid.tsd + e) - loss(grid.tsd - e)) / (2 * h)
        np.testing.assert_allclose(dtsd_np[iy, ix], fd, rtol=5e-4,
                                   atol=1e-8)


def test_miss_beams_zero_gradient(scene):
    grid, geom = scene

    def per_beam(xyt):
        pose = se2.make(xyt[0], xyt[1], xyt[2], dtype=jnp.float64)
        ranges, hit, _ = render_ranges(grid, geom, pose)
        return ranges, hit

    x0 = jnp.array([5.2, 5.05, 0.15], dtype=jnp.float64)
    ranges, hit = per_beam(x0)
    J = jax.jacrev(lambda x: per_beam(x)[0])(x0)
    J = np.array(J)
    hit = np.array(hit)
    assert np.all(J[~hit] == 0.0)
    assert np.all(np.isfinite(J))
    # hit beams should essentially all carry signal
    assert (np.abs(J[hit]).sum(axis=1) > 0).mean() > 0.99


def test_forward_matches_raycast(scene):
    grid, geom = scene
    pose = se2.make(5.2, 5.05, 0.15, dtype=jnp.float64)
    from ohm_tsd_slam.grid.raycast import raycast

    ranges, hit, _ = render_ranges(grid, geom, pose, use_fast=False,
                                   refine=False)
    res = raycast(grid, geom, pose)
    np.testing.assert_array_equal(np.array(hit), np.array(res.mask))
    np.testing.assert_allclose(np.array(ranges), np.array(res.ranges),
                               rtol=0, atol=0)


def test_cached_segments_match_inline_extraction(scene):
    """render_ranges(segments=...) (pose-only optimization against a
    fixed grid) must produce the same forward values and pose
    gradients as inline extraction."""
    from ohm_tsd_slam.grid.raycast_fast import extract_segments

    grid, geom = scene
    pose = se2.make(5.2, 5.05, 0.15, dtype=jnp.float64)
    seg = extract_segments(grid)

    def loss(p, s):
        return jnp.sum(render_ranges(grid, geom, p, segments=s)[0])

    r_inline, h_inline, _ = render_ranges(grid, geom, pose)
    r_cached, h_cached, _ = render_ranges(grid, geom, pose, segments=seg)
    np.testing.assert_array_equal(np.array(h_inline), np.array(h_cached))
    np.testing.assert_allclose(np.array(r_inline), np.array(r_cached),
                               rtol=0, atol=0)
    g_inline = jax.grad(loss)(pose, None)
    g_cached = jax.grad(loss)(pose, seg)
    np.testing.assert_allclose(np.array(g_inline), np.array(g_cached),
                               rtol=0, atol=0)
