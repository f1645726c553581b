"""Sharded multi-robot SLAM step.

The "training step" of this framework: a full multi-robot SLAM cycle —
per-robot localization (raycast + ICP) batched over a data-parallel robot
axis, followed by fusion of every robot's scan into the grid (sharded
over tile rows), plus the differentiable map-residual pose gradient (the
Gauss-Newton direction; no reference analogue) reduced with psum over the
mesh.

Distribution is expressed GSPMD-style (scaling-book recipe): arrays are
placed with NamedShardings, the step is jit-compiled over the mesh, and
XLA inserts the collectives — all-gathers where sharded grid rows feed
cross-shard raycast gathers, psum for the reductions.  The reference's
OpenMP-over-partitions (TsdGrid.cpp:228-232) maps to the "sp" axis; its
N localizer threads (SlamNode.cpp:101-122) map to "dp".
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ohm_tsd_slam.config import RegMode
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.interpolate import interpolate_bilinear_safe
from ohm_tsd_slam.grid.push import push
from ohm_tsd_slam.grid.raycast import raycast as raycast_exact
from ohm_tsd_slam.grid.raycast_fast import raycast_fast
from ohm_tsd_slam.grid.state import TsdGrid
from ohm_tsd_slam.registration.amcl import match_amcl
from ohm_tsd_slam.registration.gauss_newton import match_gauss_newton
from ohm_tsd_slam.registration.icp import IcpParams, icp
from ohm_tsd_slam.registration.ransac import (
    match_normal,
    match_pdf,
    match_tsd,
)
from ohm_tsd_slam.sensor.polar2d import SensorPolar2D, data_to_cartesian
from ohm_tsd_slam.slam.localize import (
    LocalizeParams,
    is_registration_error,
)


class SlamStepResult(NamedTuple):
    grid: TsdGrid
    poses: jnp.ndarray        # [R, 3, 3] updated poses
    reg_error: jnp.ndarray    # [R]
    pose_grad: jnp.ndarray    # [R, 3] d(residual)/d(x, y, theta)
    rms: jnp.ndarray          # [R]
    # fast-raycast overflow count summed over robots (0 = clean; when
    # nonzero the step already re-rendered every robot with the exact
    # march, so no beams were lost — see multi_robot_slam_step)
    rays_dropped: jnp.ndarray = None


def map_residual_loss(grid: TsdGrid, geom: SensorPolar2D,
                      pose: jnp.ndarray, data: jnp.ndarray,
                      mask: jnp.ndarray) -> jnp.ndarray:
    """Sum of squared TSD values at the world positions of the scan
    points: the registration objective TSD_PDFMatching evaluates
    (TSD_PDFMatching.cpp:223-251) made differentiable — zero when every
    scan point lies on the stored surface."""
    scene, valid = data_to_cartesian(geom, data, mask)
    world = se2.transform_points(pose, scene)
    tsd, interp_ok = interpolate_bilinear_safe(grid, world)
    ok = valid & interp_ok
    sq = jnp.where(ok, tsd * tsd, 0.0)
    return jnp.sum(sq) / jnp.maximum(jnp.sum(ok), 1)


def pose_gradient(grid: TsdGrid, geom: SensorPolar2D, pose: jnp.ndarray,
                  data: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """d(map residual)/d(x, y, θ) via JAX AD through the bilinear
    interpolation (the differentiable-localization direction)."""

    def loss(params):
        x, y, th = params[0], params[1], params[2]
        delta = se2.make(x, y, th, dtype=pose.dtype)
        return map_residual_loss(grid, geom, pose @ delta, data, mask)

    return jax.grad(loss)(jnp.zeros(3, dtype=pose.dtype))


def multi_robot_slam_step(grid: TsdGrid, poses: jnp.ndarray,
                          data: jnp.ndarray, mask: jnp.ndarray,
                          params: LocalizeParams,
                          key: jnp.ndarray = None,
                          mesh: Mesh = None) -> SlamStepResult:
    """One full SLAM cycle for R robots sharing one grid.

    Every registration mode of localize_step runs sharded: ICP, the
    RANSAC pre-matchers EXP/PDF/TSD (the reference's shipped default,
    config/single-laser.yaml registration_mode: 3) + ICP refinement,
    AMCL, and direct GN (doRegistration dispatch,
    ThreadLocalize.cpp:513-591).

    Args:
      grid: shared TSD grid (shard over "sp").
      poses: [R, 3, 3] sensor poses (shard over "dp").
      data/mask: [R, B] scans (shard over "dp").
      params: static localization parameters (same scan geometry per
        robot, as in config/double-laser.yaml).
      key: PRNG key for the stochastic matchers (split per robot);
        defaults to PRNGKey(0) — callers should pass a per-step key.
      mesh: when given, the model render and the pose-gradient run
        through the explicit shard_map paths (halo exchange + pmin/psum
        over "sp", parallel/shard_raycast.py) instead of letting GSPMD
        satisfy their grid reads — the collectives then stay
        O(halo + beams) per scan instead of gathering grid rows.  The
        grid-READING matchers (TSD control-point taps — the reference's
        shipped default mode, config/single-laser.yaml
        registration_mode: 3 — plus AMCL likelihoods and GN residuals)
        likewise run through parallel/shard_matchers.py: shard-local
        bilinear taps with psum'd per-candidate partial sums, so every
        registration mode is communication-bounded under the mesh.
    """
    geom = params.geom
    R = poses.shape[0]
    mode = params.mode
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, R)

    from ohm_tsd_slam.parallel.shard_matchers import (
        sharded_match_amcl,
        sharded_match_gauss_newton,
        sharded_match_tsd,
    )
    from ohm_tsd_slam.parallel.shard_raycast import (
        sharded_pose_gradient,
        sharded_raycast,
    )

    rays_dropped = jnp.asarray(0, jnp.int32)
    if mode == int(RegMode.GN):
        models = None
    elif mesh is not None:
        # explicit halo-exchange raycast per robot; per-shard segment
        # capacity (and hence temps) scale 1/n.  No exact-march
        # fallback here: it would gather the sharded grid; overflow is
        # surfaced via rays_dropped instead (per-shard capacity already
        # scales with 1/n of the rows, so overflow needs ~n x the
        # single-device segment load).
        models = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[sharded_raycast(mesh, grid, geom, poses[r])
              for r in range(R)])
        rays_dropped = jnp.sum(models.n_dropped)
    else:
        # overflow guard OUTSIDE the vmap: a lax.cond under vmap lowers
        # to a select that would always execute the expensive exact
        # march — instead raycast all robots with the fast path and
        # re-render the whole batch exactly iff ANY robot overflowed
        models = jax.vmap(lambda p: raycast_fast(grid, geom, p))(poses)
        rays_dropped = jnp.sum(models.n_dropped)
        models = jax.lax.cond(
            rays_dropped > 0,
            lambda: jax.vmap(
                lambda p: raycast_exact(grid, geom, p)._replace(
                    n_dropped=jnp.asarray(0, jnp.int32)))(poses),
            lambda: models)

    def localize_one(pose, d, m, model, k):
        scene, smask = data_to_cartesian(geom, d, m)
        if mode == int(RegMode.GN):
            # direct scan-to-map Gauss-Newton: no raycast, no NN
            if mesh is not None:
                gn = sharded_match_gauss_newton(mesh, grid, pose, scene,
                                                smask, params.gn)
            else:
                gn = match_gauss_newton(grid, pose, scene, smask,
                                        params.gn)
            T = gn.T
            err = is_registration_error(T, params.trns_max,
                                        params.rot_max)
            err = err | (gn.matches < params.gn.min_matches)
            rms = gn.rms
        else:
            # pre-registration seed by mode (ThreadLocalize.cpp:530-568)
            if mode == int(RegMode.EXP):
                T_init = match_normal(k, model.coords, model.mask,
                                      scene, smask, params.ransac)
            elif mode == int(RegMode.PDF):
                T_init = match_pdf(k, model.coords, model.mask, scene,
                                   smask, params.ransac, params.beam)
            elif mode == int(RegMode.TSD):
                if mesh is not None:
                    T_init = sharded_match_tsd(
                        mesh, k, grid, pose, model.coords, model.mask,
                        scene, smask, params.ransac)
                else:
                    T_init = match_tsd(k, grid, pose, model.coords,
                                       model.mask, scene, smask,
                                       params.ransac)
            elif mode == int(RegMode.AMCL):
                if mesh is not None:
                    T_init = sharded_match_amcl(mesh, k, grid, pose,
                                                scene, smask,
                                                params.amcl)
                else:
                    T_init = match_amcl(k, grid, pose, scene, smask,
                                        params.amcl)
            else:
                T_init = jnp.eye(3, dtype=scene.dtype)
            res = icp(model.coords, model.mask, scene, smask, params.icp,
                      T_init=T_init, sensor_pose=pose,
                      model_normals=model.normals)
            T = res.T
            err = is_registration_error(T, params.trns_max,
                                        params.rot_max)
            err = err | (jnp.sum(model.mask) == 0)
            rms = res.rms
        new_pose = jnp.where(err, pose, pose @ T)
        if mesh is None:
            grad = pose_gradient(grid, geom, new_pose, d, m)
        else:
            grad = sharded_pose_gradient(mesh, grid, geom, new_pose,
                                         d, m)
        return new_pose, err, grad, rms

    if mesh is not None:
        # per-robot Python loop: the shard_map matcher/raycast/gradient
        # paths cannot sit under a vmapped robot axis
        outs = [localize_one(poses[r], data[r], mask[r],
                             None if models is None else
                             jax.tree.map(lambda x: x[r], models),
                             keys[r]) for r in range(R)]
        new_poses, errs, grads, rms = (
            jnp.stack([o[i] for o in outs]) for i in range(4))
    elif models is None:   # GN: no model render at all
        new_poses, errs, grads, rms = jax.vmap(
            lambda p, d, m, k: localize_one(p, d, m, None, k))(
                poses, data, mask, keys)
    else:
        new_poses, errs, grads, rms = jax.vmap(localize_one)(
            poses, data, mask, models, keys)

    # fuse every robot's scan (serialized grid writes, as ThreadMapping
    # does for the shared grid; lax.scan threads the state)
    def fuse(g, inp):
        pose, d, m, err = inp
        g2 = push(g, geom, pose, d, m)
        g2 = jax.tree.map(lambda a, b: jnp.where(err, a, b), g, g2)
        return g2, 0

    grid2, _ = jax.lax.scan(fuse, grid, (new_poses, data, mask, errs))

    return SlamStepResult(grid=grid2, poses=new_poses, reg_error=errs,
                          pose_grad=grads, rms=rms,
                          rays_dropped=rays_dropped)


def make_sharded_step(mesh: Mesh, params: LocalizeParams):
    """jit the multi-robot step with explicit shardings over `mesh`.

    The step runs with the explicit shard_map raycast/pose-gradient
    paths (mesh passed through) so its per-scan collectives stay
    O(halo + beams) — verified by tools/multichip_scaling.py against
    the compiled executable."""
    gshard = NamedSharding(mesh, P("sp", None))
    tshard = NamedSharding(mesh, P("sp", None))
    rshard = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())

    def grid_shardings(grid: TsdGrid) -> TsdGrid:
        return dataclasses.replace(
            grid,
            tsd=jax.device_put(grid.tsd, gshard),
            weight=jax.device_put(grid.weight, gshard),
            tile_init=jax.device_put(grid.tile_init, tshard),
            tile_initw=jax.device_put(grid.tile_initw, tshard),
        )

    step = jax.jit(partial(multi_robot_slam_step, params=params,
                           mesh=mesh))

    def place(grid, poses, data, mask):
        return (grid_shardings(grid),
                jax.device_put(poses, rshard),
                jax.device_put(data, rshard),
                jax.device_put(mask, rshard))

    return step, place
