"""Multi-device sharding: the sharded multi-robot SLAM step on a virtual
8-device CPU mesh must agree with the single-device computation
(SURVEY.md §4 test plan, item 4)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create
from ohm_tsd_slam.parallel import (
    make_mesh,
    make_sharded_step,
    multi_robot_slam_step,
    pose_gradient,
)
from ohm_tsd_slam.registration.icp import IcpParams
from ohm_tsd_slam.sensor.polar2d import SensorPolar2D, standard_mask
from ohm_tsd_slam.slam.localize import LocalizeParams
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

CFG = GridConfig(map_size=7, cellsize=0.05)
GW = CFG.size_meters
GEOM = SensorPolar2D(size=181, angular_res=math.radians(1.5),
                     phi_min=math.radians(-135.0), max_range=5.0,
                     min_range=0.01, low_reflectivity_range=1.0)
PARAMS = LocalizeParams(
    geom=GEOM, icp=IcpParams(iterations=15, bounds=(0.0, GW, 0.0, GW)))


def _robot_batch(R=4):
    walls = rect_walls(0.8, 0.8, GW - 0.8, GW - 0.8)
    poses, datas, masks = [], [], []
    for r in range(R):
        pose_np = np.array(se2.make(GW / 2 + 0.15 * r, GW / 2 - 0.1 * r,
                                    0.1 * r, dtype=jnp.float64))
        ranges = simulate_scan(pose_np, GEOM.size, GEOM.angular_res,
                               GEOM.phi_min, GEOM.max_range,
                               segments=walls,
                               circles=[((4.5, 4.5), 0.3)])
        d, m = standard_mask(GEOM, jnp.asarray(ranges))
        poses.append(jnp.asarray(pose_np))
        datas.append(d)
        masks.append(m)
    return jnp.stack(poses), jnp.stack(datas), jnp.stack(masks)


def _base_grid():
    grid = create(CFG, dtype=jnp.float64)
    from ohm_tsd_slam.grid import push

    poses, data, mask = _robot_batch(1)
    return push(grid, GEOM, poses[0], data[0], mask[0])


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_step_matches_single_device():
    grid = _base_grid()
    poses, data, mask = _robot_batch(4)

    ref = multi_robot_slam_step(grid, poses, data, mask, PARAMS)

    mesh = make_mesh(jax.devices()[:8])
    step, place = make_sharded_step(mesh, PARAMS)
    with mesh:
        g, p, d, m = place(grid, poses, data, mask)
        out = step(g, p, d, m)
        jax.block_until_ready(out)

    np.testing.assert_allclose(np.array(out.poses), np.array(ref.poses),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.array(out.pose_grad),
                               np.array(ref.pose_grad),
                               rtol=1e-6, atol=1e-9)
    got = np.array(out.grid.tsd)
    exp = np.array(ref.grid.tsd)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    ok = ~np.isnan(exp)
    np.testing.assert_allclose(got[ok], exp[ok], rtol=1e-9, atol=1e-12)


def test_pose_gradient_finite_and_descending():
    """The map-residual pose gradient points downhill: stepping against
    it reduces the residual."""
    from ohm_tsd_slam.parallel.sharded import map_residual_loss

    grid = _base_grid()
    poses, data, mask = _robot_batch(1)
    # perturb the pose so the residual is nonzero
    pose = poses[0] @ se2.make(0.03, -0.02, 0.01, dtype=jnp.float64)
    g = pose_gradient(grid, GEOM, pose, data[0], mask[0])
    assert np.isfinite(np.array(g)).all()
    l0 = float(map_residual_loss(grid, GEOM, pose, data[0], mask[0]))

    step = -1e-3 * np.array(g) / (np.linalg.norm(np.array(g)) + 1e-12)
    delta = se2.make(step[0], step[1], step[2], dtype=jnp.float64)
    l1 = float(map_residual_loss(grid, GEOM, pose @ delta, data[0],
                                 mask[0]))
    assert l1 < l0


def test_graft_entry_compiles():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.pose.shape == (3, 3)


def test_graft_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_raycast_matches_single_device():
    """Explicit shard_map raycast (halo exchange + pmin + owned replay)
    must reproduce raycast_fast on the gathered grid exactly."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ohm_tsd_slam.config import GridConfig
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.grid.raycast_fast import raycast_fast
    from ohm_tsd_slam.parallel.shard_raycast import sharded_raycast
    from ohm_tsd_slam.sensor import polar2d
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan
    import dataclasses
    import math

    cfg = GridConfig(map_size=8, cellsize=0.04)
    geom = polar2d.SensorPolar2D(
        size=361, angular_res=math.radians(0.75),
        phi_min=math.radians(-135.0), max_range=9.0,
        min_range=0.01, low_reflectivity_range=1.0)
    grid = create(cfg, dtype=jnp.float64)
    walls = rect_walls(1.5, 1.5, 8.5, 8.5)
    for pose_xyt in [(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)]:
        pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
        r = simulate_scan(pose, geom.size, geom.angular_res, geom.phi_min,
                          geom.max_range, segments=walls,
                          circles=[((7.0, 7.2), 0.5)])
        data, mask = polar2d.standard_mask(geom, jnp.asarray(r))
        grid = push(grid, geom, jnp.asarray(pose), data, mask)

    qpose = jnp.asarray(np.array(se2.make(5.0, 5.0, 0.9,
                                          dtype=jnp.float64)))
    ref = raycast_fast(grid, geom, qpose)

    devices = np.array(jax.devices("cpu")[:8]).reshape(8, 1)
    mesh = Mesh(devices, ("sp", "dp"))
    gshard = NamedSharding(mesh, P("sp", None))
    grid_sh = dataclasses.replace(
        grid, tsd=jax.device_put(grid.tsd, gshard))
    got = jax.jit(
        lambda g, p: sharded_raycast(mesh, g, geom, p))(grid_sh, qpose)

    np.testing.assert_array_equal(np.asarray(got.mask),
                                  np.asarray(ref.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_allclose(np.asarray(got.coords)[m],
                               np.asarray(ref.coords)[m], atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.normals)[m],
                               np.asarray(ref.normals)[m], atol=1e-9)
    assert int(got.mask.sum()) > 250


def test_sharded_step_outputs_stay_sharded():
    """The grid must remain row-sharded through the step — a silent
    all-gather/replicate of the full grid would still produce correct
    values; pin the output shardings."""
    import dataclasses
    import math

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ohm_tsd_slam.config import GridConfig
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import create
    from ohm_tsd_slam.parallel.sharded import make_sharded_step
    from ohm_tsd_slam.registration.icp import IcpParams
    from ohm_tsd_slam.sensor import polar2d
    from ohm_tsd_slam.slam.localize import LocalizeParams
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

    cfg = GridConfig(map_size=7, cellsize=0.05)
    gw = cfg.size_meters
    geom = polar2d.SensorPolar2D(
        size=181, angular_res=math.radians(1.5),
        phi_min=math.radians(-135.0), max_range=gw, min_range=0.01,
        low_reflectivity_range=1.0)
    params = LocalizeParams(
        geom=geom, icp=IcpParams(iterations=10, bounds=(0., gw, 0., gw)))

    devices = np.array(jax.devices("cpu")[:8]).reshape(4, 2)
    mesh = Mesh(devices, ("sp", "dp"))
    step, place = make_sharded_step(mesh, params)

    grid = create(cfg, dtype=jnp.float32)
    poses, datas, masks = [], [], []
    walls = rect_walls(0.6, 0.6, gw - 0.6, gw - 0.6)
    for r in range(2):
        pose_np = np.array(se2.make(gw / 2 + 0.05 * r, gw / 2, 0.02 * r,
                                    dtype=np.float64))
        rg = simulate_scan(pose_np, geom.size, geom.angular_res,
                           geom.phi_min, geom.max_range, segments=walls)
        d, m = polar2d.standard_mask(geom, jnp.asarray(rg, jnp.float32))
        poses.append(jnp.asarray(pose_np, jnp.float32))
        datas.append(d)
        masks.append(m)

    with mesh:
        g, p, d, m = place(grid, jnp.stack(poses), jnp.stack(datas),
                           jnp.stack(masks))
        res = step(g, p, d, m)
        jax.block_until_ready(res)

    gshard = NamedSharding(mesh, P("sp", None))
    assert res.grid.tsd.sharding.is_equivalent_to(gshard,
                                                  res.grid.tsd.ndim), \
        str(res.grid.tsd.sharding)
    assert res.grid.weight.sharding.is_equivalent_to(
        gshard, res.grid.weight.ndim)
    # per-device shards really are 1/sp of the rows
    shard_rows = {s.data.shape[0] for s in res.grid.tsd.addressable_shards}
    assert shard_rows == {grid.tsd.shape[0] // 4}, shard_rows


def test_sharded_step_gn_mode():
    """The sharded multi-robot step supports the direct Gauss-Newton
    mode (no raycast/NN) — VERDICT r1 weak #5."""
    import math

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ohm_tsd_slam.config import GridConfig, RegMode
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.parallel.sharded import make_sharded_step
    from ohm_tsd_slam.registration.gauss_newton import GnParams
    from ohm_tsd_slam.registration.icp import IcpParams
    from ohm_tsd_slam.sensor import polar2d
    from ohm_tsd_slam.slam.localize import LocalizeParams
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

    cfg = GridConfig(map_size=7, cellsize=0.05)
    gw = cfg.size_meters
    geom = polar2d.SensorPolar2D(
        size=181, angular_res=math.radians(1.5),
        phi_min=math.radians(-135.0), max_range=gw, min_range=0.01,
        low_reflectivity_range=1.0)
    params = LocalizeParams(
        geom=geom, icp=IcpParams(iterations=5),
        mode=int(RegMode.GN), gn=GnParams(iterations=12))

    walls = rect_walls(0.6, 0.6, gw - 0.6, gw - 0.6)
    grid = create(cfg, dtype=jnp.float32)
    pose0 = np.array(se2.make(gw / 2, gw / 2, 0.0, dtype=np.float64))
    rg = simulate_scan(pose0, geom.size, geom.angular_res, geom.phi_min,
                       geom.max_range, segments=walls)
    d0, m0 = polar2d.standard_mask(geom, jnp.asarray(rg, jnp.float32))
    grid = push(grid, geom, jnp.asarray(pose0, jnp.float32), d0, m0)

    devices = np.array(jax.devices("cpu")[:8]).reshape(4, 2)
    mesh = Mesh(devices, ("sp", "dp"))
    step, place = make_sharded_step(mesh, params)

    # two robots whose estimates are offset by 2 cm from the scan pose:
    # GN should pull the transform toward the truth
    true_np = np.array(se2.make(gw / 2 + 0.02, gw / 2 - 0.01, 0.01,
                                dtype=np.float64))
    rg2 = simulate_scan(true_np, geom.size, geom.angular_res,
                        geom.phi_min, geom.max_range, segments=walls)
    d2, m2 = polar2d.standard_mask(geom, jnp.asarray(rg2, jnp.float32))
    poses = jnp.stack([jnp.asarray(pose0, jnp.float32)] * 2)
    data = jnp.stack([d2, d2])
    mask = jnp.stack([m2, m2])

    with mesh:
        g, p, d, m = place(grid, poses, data, mask)
        res = step(g, p, d, m)
        jax.block_until_ready(res)

    assert not bool(res.reg_error.any())
    est = np.asarray(res.poses[0])
    err = np.hypot(est[0, 2] - true_np[0, 2], est[1, 2] - true_np[1, 2])
    assert err < 0.01, err


@pytest.mark.parametrize("mode_name", ["EXP", "PDF", "TSD", "AMCL"])
def test_sharded_step_matcher_modes_match_single_device(mode_name):
    """Every registration mode must produce the same result sharded as
    on a single device.  The grid-READING
    matchers (TSD — the reference's shipped default mode,
    config/single-laser.yaml registration_mode: 3 — and AMCL) route
    through the shard-local tap paths of parallel/shard_matchers.py;
    EXP/PDF run replicated.  Tolerances are loose only against the
    reordered psum partial sums (f64 on CPU)."""
    import math as _math

    from ohm_tsd_slam.config import BeamModelConfig, RegMode
    from ohm_tsd_slam.registration.ransac import RansacParams

    import dataclasses as _dc

    mode = int(getattr(RegMode, mode_name))
    params = _dc.replace(
        PARAMS, mode=mode,
        ransac=RansacParams(trials=24, size_control_set=60,
                            resolution=GEOM.angular_res,
                            phi_max=_math.radians(30.0)),
        beam=BeamModelConfig(max_range=GEOM.max_range))

    grid = _base_grid()
    poses, data, mask = _robot_batch(4)
    key = jax.random.PRNGKey(7)

    ref = multi_robot_slam_step(grid, poses, data, mask, params, key=key)

    mesh = make_mesh(jax.devices()[:8])
    step, place = make_sharded_step(mesh, params)
    with mesh:
        g, p, d, m = place(grid, poses, data, mask)
        out = step(g, p, d, m, key=key)
        jax.block_until_ready(out)

    np.testing.assert_array_equal(np.array(out.reg_error),
                                  np.array(ref.reg_error))
    np.testing.assert_allclose(np.array(out.poses), np.array(ref.poses),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.array(out.pose_grad),
                               np.array(ref.pose_grad),
                               rtol=1e-6, atol=1e-9)
    got = np.array(out.grid.tsd)
    exp = np.array(ref.grid.tsd)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    ok = ~np.isnan(exp)
    np.testing.assert_allclose(got[ok], exp[ok], rtol=1e-9, atol=1e-12)


def test_sharded_gn_matcher_matches_single_device_direct():
    """parallel/shard_matchers.py::sharded_match_gauss_newton vs the
    single-device matcher at matcher granularity (the step-level GN test
    above covers integration; this pins the psum'd normal equations)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import dataclasses

    from ohm_tsd_slam.parallel.shard_matchers import (
        sharded_match_gauss_newton,
    )
    from ohm_tsd_slam.registration.gauss_newton import (
        GnParams,
        match_gauss_newton,
    )
    from ohm_tsd_slam.sensor.polar2d import data_to_cartesian

    grid = _base_grid()
    poses, data, mask = _robot_batch(1)
    pose = poses[0] @ se2.make(0.02, -0.015, 0.01, dtype=jnp.float64)
    scene, smask = data_to_cartesian(GEOM, data[0], mask[0])
    params = GnParams(iterations=12)

    ref = match_gauss_newton(grid, pose, scene, smask, params)

    devices = np.array(jax.devices()[:8]).reshape(8, 1)
    mesh = Mesh(devices, ("sp", "dp"))
    gshard = NamedSharding(mesh, P("sp", None))
    grid_sh = dataclasses.replace(
        grid, tsd=jax.device_put(grid.tsd, gshard))
    got = jax.jit(lambda g, p, s, m: sharded_match_gauss_newton(
        mesh, g, p, s, m, params))(grid_sh, pose, scene, smask)

    np.testing.assert_allclose(np.asarray(got.T), np.asarray(ref.T),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(got.rms), float(ref.rms),
                               rtol=1e-9)
    assert int(got.matches) == int(ref.matches)
