"""Tests for the inventory-parity additions: push_tree (quadtree-culled
push), the AMCL particle matcher, point-cloud containers, and the
shipped YAML config profiles."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import GridConfig, RegMode, load_yaml
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.core import cloud as pc
from ohm_tsd_slam.grid import create, push, push_tree
from ohm_tsd_slam.grid.push import branch_gate, tile_cull
from ohm_tsd_slam.registration.amcl import AmclParams, match_amcl
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = GridConfig(map_size=7, cellsize=0.05, truncation_radius=3.0)
GEOM = dict(size=271, angular_res=math.radians(1.0),
            phi_min=math.radians(-135.0), max_range=4.0,
            min_range=0.01, low_reflectivity_range=2.0)


def _scene(pose_xyt=(3.2, 3.2, 0.3)):
    pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
    walls = rect_walls(0.8, 0.8, 5.6, 5.6)
    ranges = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                           GEOM["phi_min"], GEOM["max_range"],
                           segments=walls, circles=[((4.5, 4.5), 0.4)])
    return pose, ranges


class TestPushTree:
    def test_identical_to_push(self):
        """pushTree's branch culling is conservative: fused grids match
        push exactly (TsdGrid.cpp:286-350 vs :217-284)."""
        geom = polar2d.SensorPolar2D(**GEOM)
        pose_np, ranges = _scene()
        pose = jnp.asarray(pose_np)
        data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
        grid = create(CFG, dtype=jnp.float64)
        g_push = push(grid, geom, pose, data, mask)
        g_tree = push_tree(grid, geom, pose, data, mask)
        np.testing.assert_array_equal(np.asarray(g_push.tsd),
                                      np.asarray(g_tree.tsd))
        np.testing.assert_array_equal(np.asarray(g_push.weight),
                                      np.asarray(g_tree.weight))
        np.testing.assert_array_equal(np.asarray(g_push.tile_init),
                                      np.asarray(g_tree.tile_init))
        np.testing.assert_array_equal(np.asarray(g_push.tile_initw),
                                      np.asarray(g_tree.tile_initw))

    def test_gate_conservative(self):
        """Every tile the leaf-level cull touches survives the branch
        gate (a pruned branch can contain no in-range leaf)."""
        geom = polar2d.SensorPolar2D(**GEOM)
        pose_np, ranges = _scene()
        pose = jnp.asarray(pose_np)
        data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
        grid = create(CFG, dtype=jnp.float64)
        gate = branch_gate(grid, geom, pose)
        touch, empty_inc, _ = tile_cull(grid, geom, pose, data, mask)
        assert bool(jnp.all(~(touch | empty_inc) | gate))

    def test_gate_prunes_far_tiles(self):
        """With a short-range sensor the branch windows actually prune:
        corners of a 16x16-tile grid are outside the gate (branch
        circumradii double per level, so pruning needs blocks much
        smaller than the out-of-range distance)."""
        short = dict(GEOM, max_range=0.5)
        geom = polar2d.SensorPolar2D(**short)
        big = GridConfig(map_size=9, cellsize=0.05, truncation_radius=3.0)
        pose = jnp.asarray(se2.make(12.8, 12.8, 0.0, dtype=jnp.float64))
        grid = create(big, dtype=jnp.float64)
        gate = branch_gate(grid, geom, pose)
        assert not bool(gate[0, 0])
        assert not bool(gate[-1, -1])
        assert bool(jnp.any(gate))


class TestAmcl:
    def test_recovers_offset(self):
        """The particle filter recovers a pose perturbation against a
        grid built from the unperturbed scan."""
        geom = polar2d.SensorPolar2D(**GEOM)
        pose_np, ranges = _scene()
        pose = jnp.asarray(pose_np)
        data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
        grid = create(CFG, dtype=jnp.float64)
        for _ in range(3):
            grid = push(grid, geom, pose, data, mask)

        # scene scan taken from a slightly offset pose
        true_off = (0.12, -0.08, 0.06)
        pose2_np = np.array(pose_np @ se2.make(*true_off, dtype=jnp.float64))
        ranges2 = simulate_scan(pose2_np, GEOM["size"], GEOM["angular_res"],
                                GEOM["phi_min"], GEOM["max_range"],
                                segments=rect_walls(0.8, 0.8, 5.6, 5.6),
                                circles=[((4.5, 4.5), 0.4)])
        data2, mask2 = polar2d.standard_mask(geom, jnp.asarray(ranges2))
        scene, scene_mask = polar2d.data_to_cartesian(geom, data2, mask2)

        params = AmclParams(particles=768, iterations=10,
                            sigma_trans=0.2, sigma_rot=0.15)
        T = match_amcl(jax.random.PRNGKey(3), grid, pose, scene,
                       scene_mask, params)
        est = np.asarray(T)
        want = np.array(se2.make(*true_off, dtype=jnp.float64))
        # translation within 6 cm, rotation within ~3 deg
        assert np.linalg.norm(est[:2, 2] - want[:2, 2]) < 0.06
        dtheta = abs(float(se2.angle(jnp.asarray(est)))
                     - true_off[2])
        assert dtheta < math.radians(3.0)

    def test_prior_pinned_identity_scene(self):
        """With the scene already aligned, the correction stays small
        (particle 0 pins the prior)."""
        geom = polar2d.SensorPolar2D(**GEOM)
        pose_np, ranges = _scene()
        pose = jnp.asarray(pose_np)
        data, mask = polar2d.standard_mask(geom, jnp.asarray(ranges))
        grid = create(CFG, dtype=jnp.float64)
        for _ in range(3):
            grid = push(grid, geom, pose, data, mask)
        scene, scene_mask = polar2d.data_to_cartesian(geom, data, mask)
        T = match_amcl(jax.random.PRNGKey(0), grid, pose, scene,
                       scene_mask, AmclParams(particles=512, iterations=8))
        est = np.asarray(T)
        assert np.linalg.norm(est[:2, 2]) < 0.05
        assert abs(float(se2.angle(jnp.asarray(est)))) < math.radians(2.5)


class TestClouds:
    def test_cartesian_cloud_ops(self):
        pts = np.array([[0.0, 0.0, 1.0],
                        [1.0, 0.0, 2.0],
                        [np.nan, 0.0, 1.0],
                        [0.0, 2.0, 3.0]])
        normals = np.array([[0, 0, 1], [0, 0, 0], [0, 1, 0], [1, 0, 0]],
                           dtype=float)
        c = pc.create_cloud(pts, normals=normals, attrs={"device": 7})
        assert c.size == 4 and c.has_normals() and not c.has_colors()
        c = pc.remove_invalid_points(c)
        assert int(c.valid_count()) == 3
        c = pc.mask_empty_normals(c)
        assert int(c.valid_count()) == 2  # row 1 zero normal, row 2 NaN
        c2 = pc.subsample(c, 2)
        assert int(c2.valid_count()) == 1
        assert c.attrs["device"] == 7

    def test_cloud_transform_roundtrip(self):
        pts = np.random.RandomState(0).randn(16, 3)
        c = pc.create_cloud(pts, normals=pts / np.linalg.norm(
            pts, axis=1, keepdims=True))
        T = np.eye(4)
        th = 0.4
        T[:3, :3] = [[math.cos(th), -math.sin(th), 0],
                     [math.sin(th), math.cos(th), 0], [0, 0, 1]]
        T[:3, 3] = [1.0, -2.0, 0.5]
        c2 = pc.transform(pc.transform(c, jnp.asarray(T)),
                          jnp.asarray(np.linalg.inv(T)))
        np.testing.assert_allclose(np.asarray(c2.coords), pts, atol=1e-12)
        np.testing.assert_allclose(np.asarray(c2.normals),
                                   np.asarray(c.normals), atol=1e-12)

    def test_zbuffer_projection(self):
        # two points on the same pixel: nearest z wins
        pts = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 1.0],
                        [0.5, 0.0, 1.0]])
        c = pc.create_cloud(pts)
        # pinhole: f=10, center (8, 8)
        P = jnp.asarray(np.array([[10.0, 0, 8, 0],
                                  [0, 10.0, 8, 0],
                                  [0, 0, 1, 0]]))
        zbuf, hit = pc.project_to_image(c, P, 16, 16)
        assert float(zbuf[8, 8]) == 1.0
        assert float(zbuf[8, 13]) == 1.0   # u = 10*0.5/1 + 8
        assert int(hit.sum()) == 2

    def test_point_cloud_rotate(self):
        pts = np.eye(3)
        c = pc.create_point_cloud(pts, width=3, height=1)
        assert not c.is_organized
        r = pc.rotate_rpy(c, 0.0, 0.0, math.pi / 2)
        np.testing.assert_allclose(
            np.asarray(r.points),
            np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1.0]]), atol=1e-12)
        org = pc.create_point_cloud(np.zeros((6, 3)), width=3, height=2)
        assert org.is_organized


class TestConfigProfiles:
    def test_single_laser_profile(self):
        cfg = load_yaml(os.path.join(REPO, "configs", "single-laser.yaml"))
        assert cfg.grid.map_size == 10
        assert cfg.grid.cellsize == 0.025
        assert len(cfg.robots) == 1
        r = cfg.robots[0]
        assert r.registration.mode == RegMode.TSD
        assert r.registration.icp.iterations == 30
        assert r.registration.ransac.size_control_set == 180
        assert cfg.grid_pub.pub_tsd_color_map is True

    def test_double_laser_profile(self):
        cfg = load_yaml(os.path.join(REPO, "configs", "double-laser.yaml"))
        assert len(cfg.robots) == 2
        assert cfg.robots[0].name == "robot0"
        assert cfg.robots[1].name == "robot1"
        assert cfg.robots[1].sensor.max_range == 20.0
        assert cfg.robots[1].local_offset_x == 0.5
        assert cfg.robots[0].registration.mode == RegMode.ICP

    def test_flat_profile(self):
        cfg = load_yaml(os.path.join(REPO, "configs", "slamparams.yaml"))
        assert cfg.grid.map_size == 9
        assert cfg.grid.cellsize == 0.05
        assert cfg.robots[0].registration.icp.iterations == 25


def test_cartesian_cloud_factory_codecs(tmp_path):
    """CartesianCloudFactory ascii load/save round-trip
    (CartesianCloudFactory.cpp:36-92), including the z>0 validity rule."""
    import numpy as np

    from ohm_tsd_slam.core.cloud import (
        CartesianCloud,
        load_cloud_ascii,
        save_cloud_ascii,
    )

    coords = jnp.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, -1.0],
                          [0.5, 0.25, 2.0]])
    colors = jnp.asarray(np.array([[10, 20, 30], [40, 50, 60],
                                   [70, 80, 90]], np.uint8))
    cloud = CartesianCloud(coords=coords,
                           mask=jnp.ones(3, bool), colors=colors)
    path = str(tmp_path / "cloud.txt")
    save_cloud_ascii(path, cloud)
    back = load_cloud_ascii(path, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(back.coords),
                               np.asarray(coords), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(back.colors),
                                  np.asarray(colors))
    # validity: z > 0 (ePointAttrValid, CartesianCloudFactory.cpp:85)
    np.testing.assert_array_equal(np.asarray(back.mask),
                                  [True, False, True])
