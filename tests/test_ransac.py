"""Tests for the RANSAC global matchers (registration/ransac.py).

Reference behavior: ransacMatching/{RandomMatching,RandomNormalMatching,
PDFMatching,TSD_PDFMatching}.cpp.  Recovery tolerances reflect each
matcher's role as a *coarse* pre-registration seed for ICP
(ThreadLocalize.cpp:530-580): rotation is pinned by normals/angles and
is tight; translation is pinned by a single point pair (EXP) or
likelihood peak (PDF/TSD).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import BeamModelConfig, GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, push
from ohm_tsd_slam.registration.ransac import (
    RansacParams,
    match_normal,
    match_pdf,
    match_tsd,
    pca_normals,
    random_valid_subset,
    subsample_mask,
)
from ohm_tsd_slam.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
    standard_mask,
)
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

B = 541


def _geom():
    return SensorPolar2D(size=B, angular_res=math.radians(0.5),
                         phi_min=math.radians(-135.0), max_range=15.0)


def _scan_clouds(pose_model, pose_scene):
    geom = _geom()
    walls = rect_walls(1.0, 1.0, 9.0, 9.0)
    rm = simulate_scan(np.array(pose_model), B, geom.angular_res,
                       geom.phi_min, geom.max_range, segments=walls)
    rs = simulate_scan(np.array(pose_scene), B, geom.angular_res,
                       geom.phi_min, geom.max_range, segments=walls)
    dm, mm = standard_mask(geom, jnp.asarray(rm, jnp.float32))
    ds, ms = standard_mask(geom, jnp.asarray(rs, jnp.float32))
    M, Mmask = data_to_cartesian(geom, dm, mm)
    S, Smask = data_to_cartesian(geom, ds, ms)
    return geom, (dm, mm), M, Mmask, S, Smask


POSE_M = se2.make(5.0, 5.0, 0.3, dtype=jnp.float32)
POSE_S = se2.make(5.1, 4.85, 0.38, dtype=jnp.float32)


def _angle(T):
    return math.atan2(float(T[1, 0]), float(T[0, 0]))


class TestPcaNormals:
    def test_straight_wall_normals(self):
        # points along the x-axis at y=2: the minor PCA axis is ±y; the
        # orientation rule (RandomMatching.cpp:125-135) picks the one
        # with dot(point, n) < 0, i.e. -y here.
        x = jnp.linspace(-1.0, 1.0, 41)
        pts = jnp.stack([x, jnp.full_like(x, 2.0)], axis=-1)
        mask = jnp.ones(41, bool)
        n, m = pca_normals(pts, mask, 5)
        assert bool(m[20])
        np.testing.assert_allclose(np.array(n[m]),
                                   np.tile([0.0, -1.0], (int(m.sum()), 1)),
                                   atol=1e-5)

    def test_border_and_sparse_masked(self):
        pts = jnp.zeros((20, 2))
        mask = jnp.zeros(20, bool).at[jnp.array([0, 5, 19])].set(True)
        _, m = pca_normals(pts, mask, 5)
        # borders masked; interior point 5 has <4 valid neighbors
        assert not bool(m.any())

    def test_corner_rejected_as_blob(self):
        # an L-corner neighborhood has comparable extents in both axes
        # -> rejected by the axis-ratio test (RandomMatching.cpp:118-123)
        a = jnp.stack([jnp.linspace(0, 1, 11), jnp.zeros(11)], -1)
        b = jnp.stack([jnp.zeros(10), jnp.linspace(0.1, 1, 10)], -1)
        pts = jnp.concatenate([a[::-1], b], axis=0)
        mask = jnp.ones(21, bool)
        _, m = pca_normals(pts, mask, 10)
        assert not bool(m[10])


class TestSampling:
    def test_subsample_keeps_target(self):
        mask = jnp.ones(2000, bool)
        out = subsample_mask(jax.random.PRNGKey(0), mask, 180.0)
        kept = int(out.sum())
        assert 100 < kept < 280   # ~Binomial(2000, 0.09)

    def test_subsample_noop_when_few(self):
        mask = jnp.ones(150, bool)   # probability 180/150 > 0.99 -> keep all
        out = subsample_mask(jax.random.PRNGKey(0), mask, 180.0)
        assert int(out.sum()) == 150

    def test_random_valid_subset(self):
        mask = jnp.zeros(100, bool).at[10:20].set(True)
        idx, valid = random_valid_subset(jax.random.PRNGKey(1), mask, 15)
        idx = np.array(idx)
        valid = np.array(valid)
        assert valid[:10].all() and not valid[10:].any()
        assert set(idx[:10]) == set(range(10, 20))


class TestMatchers:
    def setup_method(self):
        (self.geom, self.model_scan, self.M, self.Mmask,
         self.S, self.Smask) = _scan_clouds(POSE_M, POSE_S)
        self.T_true = np.array(se2.invert(POSE_M) @ POSE_S)
        self.params = RansacParams(trials=60, size_control_set=140,
                                   resolution=self.geom.angular_res)
        self.key = jax.random.PRNGKey(42)

    def test_match_normal_recovers(self):
        T = np.array(match_normal(self.key, self.M, self.Mmask,
                                  self.S, self.Smask, self.params))
        assert abs(_angle(T) - _angle(self.T_true)) < 0.02
        assert np.hypot(T[0, 2] - self.T_true[0, 2],
                        T[1, 2] - self.T_true[1, 2]) < 0.15  # ~epsThresh

    def test_match_pdf_recovers(self):
        bm = BeamModelConfig(max_range=15.0)
        T = np.array(match_pdf(self.key, self.M, self.Mmask,
                               self.S, self.Smask, self.params, bm))
        assert abs(_angle(T) - _angle(self.T_true)) < 0.02
        assert np.hypot(T[0, 2] - self.T_true[0, 2],
                        T[1, 2] - self.T_true[1, 2]) < 0.1

    def test_match_tsd_recovers(self):
        cfg = GridConfig(map_size=8, cellsize=0.04)
        grid = create(cfg, dtype=jnp.float32)
        dm, mm = self.model_scan
        grid = push(grid, self.geom, POSE_M, dm, mm)
        T = np.array(match_tsd(self.key, grid, POSE_M, self.M, self.Mmask,
                               self.S, self.Smask, self.params))
        assert abs(_angle(T) - _angle(self.T_true)) < 0.02
        assert np.hypot(T[0, 2] - self.T_true[0, 2],
                        T[1, 2] - self.T_true[1, 2]) < 0.05

    def test_degenerate_inputs_return_identity(self):
        empty = jnp.zeros(B, bool)
        T = np.array(match_normal(self.key, self.M, empty,
                                  self.S, self.Smask, self.params))
        np.testing.assert_allclose(T, np.eye(3), atol=1e-6)
        T = np.array(match_normal(self.key, self.M, self.Mmask,
                                  self.S, empty, self.params))
        np.testing.assert_allclose(T, np.eye(3), atol=1e-6)

    def test_jit_and_determinism(self):
        f = jax.jit(match_normal, static_argnames=("params",))
        T1 = np.array(f(self.key, self.M, self.Mmask, self.S, self.Smask,
                        params=self.params))
        T2 = np.array(f(self.key, self.M, self.Mmask, self.S, self.Smask,
                        params=self.params))
        np.testing.assert_array_equal(T1, T2)


class TestLocalizeModes:
    @pytest.mark.parametrize("mode", [1, 2, 3])
    def test_localize_step_with_prereg(self, mode):
        from ohm_tsd_slam.registration.icp import IcpParams
        from ohm_tsd_slam.slam.localize import (
            LocalizeParams,
            localize_step,
        )

        geom, (dm, mm), *_ = _scan_clouds(POSE_M, POSE_S)
        cfg = GridConfig(map_size=8, cellsize=0.04)
        grid = push(create(cfg, dtype=jnp.float32), geom, POSE_M, dm, mm)

        walls = rect_walls(1.0, 1.0, 9.0, 9.0)
        rs = simulate_scan(np.array(POSE_S), B, geom.angular_res,
                           geom.phi_min, geom.max_range, segments=walls)
        ds, ms = standard_mask(geom, jnp.asarray(rs, jnp.float32))

        params = LocalizeParams(
            geom=geom,
            icp=IcpParams(iterations=25, bounds=(0.0, 10.24, 0.0, 10.24)),
            mode=mode,
            ransac=RansacParams(trials=40, size_control_set=100,
                                resolution=geom.angular_res),
            beam=BeamModelConfig(max_range=15.0),
        )
        out = localize_step(grid, POSE_M, POSE_M, ds, ms, params,
                            key=jax.random.PRNGKey(3))
        assert not bool(out.reg_error)
        est = np.array(out.pose)
        true = np.array(POSE_S)
        assert np.hypot(est[0, 2] - true[0, 2], est[1, 2] - true[1, 2]) < 0.05
        assert abs(_angle(est) - _angle(true)) < 0.02


class TestTwinPoint:
    def test_recovers_transform(self):
        from ohm_tsd_slam.registration.twinpoint import match_twinpoint

        geom, _, M, Mmask, S, Smask = _scan_clouds(POSE_M, POSE_S)
        T_true = np.array(se2.invert(POSE_M) @ POSE_S)
        p = RansacParams(trials=100, size_control_set=140,
                         resolution=geom.angular_res)
        T = np.array(match_twinpoint(jax.random.PRNGKey(7), M, Mmask,
                                     S, Smask, p))
        assert abs(_angle(T) - _angle(T_true)) < 0.02
        assert np.hypot(T[0, 2] - T_true[0, 2],
                        T[1, 2] - T_true[1, 2]) < 0.05

    def test_too_few_points_identity(self):
        from ohm_tsd_slam.registration.twinpoint import (
            MIN_VALID_POINTS,
            match_twinpoint,
        )

        geom, _, M, Mmask, S, Smask = _scan_clouds(POSE_M, POSE_S)
        few = jnp.zeros(B, bool).at[:MIN_VALID_POINTS - 1].set(True)
        p = RansacParams(trials=20, resolution=geom.angular_res)
        T = np.array(match_twinpoint(jax.random.PRNGKey(0), M, few,
                                     S, Smask, p))
        np.testing.assert_allclose(T, np.eye(3), atol=1e-6)
