"""Benchmark: per-scan SLAM hot paths on the reference's default workload
— 1024^2-cell TSD grid at 0.025 m (SlamNode.cpp:53-54,77), a 1081-beam
Hokuyo-class scan (ThreadLocalize.h:297-299).

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}
with the device it ran on (platform, device_kind, count).

Baseline derivation: the reference publishes no numbers (BASELINE.md).
Its implicit budget is real-time localization of a 1081-beam scan at
lidar rate on a robot CPU; the 40 Hz upper bound of the cited scan rate
(SURVEY.md §6) gives 1081 * 40 = 43,240 rays/s.  vs_baseline is measured
rays/s divided by that.

Headline = the per-scan raycast of the live SLAM loop: segment
extraction is pose-independent and runs once per MAP UPDATE (the node
caches it; slam/node.py::_segments_for), while the localizer raycasts
every scan — exactly the reference's asymmetry (pushes are gated by
significant motion, ThreadLocalize.cpp:402; raycasts are per-scan,
:353).  The extraction cost and the cold (extract-inline) raycast are
reported alongside.

All timings are on-device chains (lax.fori_loop), see `chain`.
"""

import json
import math
import sys
import time

import numpy as np

BASELINE_RAYS_PER_S = 1081 * 40.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from ohm_tsd_slam.utils.compile_cache import (
        enable_persistent_cache,
    )

    cache = enable_persistent_cache()
    dev = jax.devices()[0]
    log("devices:", jax.devices(), "| persistent cache:", cache)
    if jax.default_backend() != "gpu":
        # a CPU timing is not a device metric; refuse rather than report
        log("no GPU: default backend is", jax.default_backend())
        sys.exit(2)

    from ohm_tsd_slam.config import GridConfig
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.grid.raycast_fast import (
        extract_segments,
        raycast_fast,
    )
    from ohm_tsd_slam.registration.icp import IcpParams
    from ohm_tsd_slam.sensor.polar2d import SensorPolar2D, standard_mask
    from ohm_tsd_slam.slam.localize import LocalizeParams, localize_step
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

    cfg = GridConfig(map_size=10, cellsize=0.025)   # 1024^2, 25.6 m
    gw = cfg.size_meters
    B = 1081
    geom = SensorPolar2D(size=B, angular_res=math.radians(270.0 / B),
                         phi_min=math.radians(-135.0), max_range=25.0,
                         min_range=0.01, low_reflectivity_range=2.0)

    pose_np = np.array(se2.make(gw / 2, gw / 2, 0.1, dtype=np.float64))
    walls = rect_walls(2.0, 2.0, gw - 2.0, gw - 2.0)
    ranges = simulate_scan(pose_np, B, geom.angular_res, geom.phi_min,
                           geom.max_range, segments=walls,
                           circles=[((gw / 2 + 4, gw / 2 + 4), 0.5)])

    pose = jnp.asarray(pose_np, jnp.float32)
    data, mask = standard_mask(geom, jnp.asarray(ranges, jnp.float32))
    grid = create(cfg, dtype=jnp.float32)
    t0 = time.time()
    grid = push(grid, geom, pose, data, mask)
    jax.block_until_ready(grid.tsd)
    log(f"push compile+run: {time.time()-t0:.2f}s")

    extras = {}
    compile_s = {}
    import dataclasses as _dc

    def chain(fn, n, *args, reps=5, compile_tag=None):
        """Time an on-device fori_loop chain of fn; returns sec/iter.

        Measured as the SLOPE between an n- and a 4n-iteration chain,
        which cancels the fixed per-call launch and fetch cost that a
        single-length timing would smear into the per-iteration number
        as +cost/n.  The final scalar is fetched to the host.
        """
        def make(m):
            @jax.jit
            def run(*a):
                def body(i, carry):
                    return fn(i, carry, *a)
                return jax.lax.fori_loop(0, m, body,
                                         jnp.asarray(0.0, jnp.float32))
            return run

        run_n, run_4n = make(n), make(4 * n)
        t0 = time.time()
        float(np.asarray(run_n(*args)))
        float(np.asarray(run_4n(*args)))
        if compile_tag:
            compile_s[compile_tag] = round(time.time() - t0, 2)
            log(f"{compile_tag} compile: {compile_s[compile_tag]:.2f}s")
        t_n, t_4n = [], []
        for _ in range(reps):
            t0 = time.time()
            float(np.asarray(run_n(*args)))
            t_n.append(time.time() - t0)
            t0 = time.time()
            float(np.asarray(run_4n(*args)))
            t_4n.append(time.time() - t0)
        # clamp to a small positive epsilon: timing noise can make the
        # 4n chain no slower than the n chain for very fast stages, and
        # callers divide by the result
        return max(min(t_4n) - min(t_n), 1e-7) / (3 * n)

    # ---- segment extraction (once per MAP UPDATE) ----------------------
    seg = jax.jit(extract_segments)(grid)
    jax.block_until_ready(seg.p0)

    def ext_body(i, acc, grid_tsd):
        t = grid_tsd.at[0, 0].add(i.astype(jnp.float32) * 1e-30)
        s = extract_segments(_dc.replace(grid, tsd=t))
        return acc + jnp.sum(s.p0[0]) + s.n_dropped.astype(jnp.float32)

    t_ext = chain(ext_body, 20, grid.tsd, compile_tag="extract")
    log(f"extract_segments (per map update): {t_ext*1e3:.3f} ms")
    extras["extract_ms"] = round(t_ext * 1e3, 3)

    # ---- per-scan raycast, cached segments (the live hot path) ---------
    def ray_body(i, acc, seg):
        d = (i.astype(jnp.float32) - 10.0) * 1e-4
        p = pose @ se2.make(d, -d, d, dtype=pose.dtype)
        r = raycast_fast(grid, geom, p, segments=seg)
        return acc + jnp.sum(r.ranges)

    t_ray = chain(ray_body, 100, seg, compile_tag="raycast")
    rays_per_s = B / t_ray
    log(f"raycast[cached]: {t_ray*1e3:.3f} ms/scan -> "
        f"{rays_per_s:,.0f} rays/s")

    # ---- cold raycast (extraction inline — grid changed every scan) ----
    def ray_cold_body(i, acc, grid_tsd):
        t = grid_tsd.at[0, 0].add(i.astype(jnp.float32) * 1e-30)
        d = (i.astype(jnp.float32) - 10.0) * 1e-4
        p = pose @ se2.make(d, -d, d, dtype=pose.dtype)
        r = raycast_fast(_dc.replace(grid, tsd=t), geom, p)
        return acc + jnp.sum(r.ranges)

    t_cold = chain(ray_cold_body, 20, grid.tsd)
    log(f"raycast[cold, extraction inline]: {t_cold*1e3:.3f} ms/scan")
    extras["raycast_cold_ms"] = round(t_cold * 1e3, 3)

    # ---- push/s -------------------------------------------------------
    def push_body(i, acc, grid_tsd):
        t = grid_tsd.at[0, 0].add(i.astype(jnp.float32) * 1e-30)
        g2 = push(_dc.replace(grid, tsd=t), geom, pose, data, mask)
        # consume every cell: reading one would let XLA slice the push
        # down to that cell
        return acc + jnp.sum(jnp.where(jnp.isnan(g2.tsd), 0.0, g2.tsd)) \
            * 1e-30 + jnp.sum(g2.weight) * 1e-30

    t_push = chain(push_body, 20, grid.tsd)
    log(f"push: {t_push*1e3:.2f} ms -> {1/t_push:,.1f} pushes/s")
    extras["push_ms"] = round(t_push * 1e3, 3)

    # ---- differentiable render fwd+bwd ---------------------------------
    from ohm_tsd_slam.grid.render import render_ranges

    def render_loss(tsd, p):
        g = _dc.replace(grid, tsd=tsd)
        r, _, _ = render_ranges(g, geom, p)
        return jnp.sum(r)

    grad_fn = jax.grad(render_loss, argnums=(0, 1))

    def render_body(i, acc, grid_tsd):
        d = (i.astype(jnp.float32) - 5.0) * 1e-4
        p = pose @ se2.make(d, -d, d, dtype=pose.dtype)
        t = grid_tsd.at[0, 0].add(i.astype(jnp.float32) * 1e-30)
        dg, dp = grad_fn(t, p)
        return acc + jnp.sum(dp) + dg[0, 0]

    t_rb = chain(render_body, 20, grid.tsd)
    log(f"render fwd+bwd: {t_rb*1e3:.2f} ms -> "
        f"{B/t_rb:,.0f} rays/s (fwd+bwd)")
    extras["render_fwd_bwd_ms"] = round(t_rb * 1e3, 3)

    # pose-gradient-only render against a FIXED grid (the scan-to-map
    # GN / pose-graph use case): cached segments skip the per-call
    # extraction
    def render_pose_body(i, acc, seg):
        d = (i.astype(jnp.float32) - 5.0) * 1e-4
        p = pose @ se2.make(d, -d, d, dtype=pose.dtype)
        dp = jax.grad(lambda pp: jnp.sum(render_ranges(
            grid, geom, pp, segments=seg)[0]))(p)
        return acc + jnp.sum(dp)

    t_rp = chain(render_pose_body, 20, seg)
    log(f"render fwd+bwd [pose-only, cached seg]: {t_rp*1e3:.2f} ms "
        f"-> {B/t_rp:,.0f} rays/s (fwd+bwd)")
    extras["render_pose_fwd_bwd_ms"] = round(t_rp * 1e3, 3)

    # ---- scan-match: full localize_step (cached segments) --------------
    params = LocalizeParams(
        geom=geom, icp=IcpParams(iterations=25, bounds=(0., gw, 0., gw)))

    def loc_body(i, acc, seg, d_, m_):
        dd = (i.astype(jnp.float32) - 10.0) * 1e-4
        p = pose @ se2.make(dd, -dd, dd, dtype=pose.dtype)
        res = localize_step(grid, p, p, d_, m_, params, segments=seg)
        return acc + res.pose[0, 2] + res.rms

    t_loc = chain(loc_body, 50, seg, data, mask, compile_tag="localize")
    log(f"localize_step[icp,cached]: {t_loc*1e3:.2f} ms -> "
        f"{1/t_loc:,.1f} scan-matches/s ({25/t_loc:,.0f} ICP iters/s)")
    extras["localize_icp_ms"] = round(t_loc * 1e3, 3)
    extras["scan_matches_per_s"] = round(1 / t_loc, 1)

    from ohm_tsd_slam.config import RegMode
    from ohm_tsd_slam.registration.gauss_newton import GnParams

    params_gn = LocalizeParams(
        geom=geom, icp=params.icp, mode=int(RegMode.GN),
        gn=GnParams(iterations=30))

    def gn_body(i, acc, d_, m_):
        dd = (i.astype(jnp.float32) - 10.0) * 1e-4
        p = pose @ se2.make(dd, -dd, dd, dtype=pose.dtype)
        res = localize_step(grid, p, p, d_, m_, params_gn)
        return acc + res.pose[0, 2] + res.rms

    t_gn = chain(gn_body, 50, data, mask)
    log(f"localize_step[gn]: {t_gn*1e3:.2f} ms -> "
        f"{1/t_gn:,.1f} scan-matches/s")
    extras["localize_gn_ms"] = round(t_gn * 1e3, 3)

    # ---- ICP stage attribution: one 25-iteration loop
    # over (a) the NN search alone (d2 + row min/argmin — the 3-pass
    # core), (b) the full fused assignment (+ gate + reciprocal +
    # payload one-hot matmul); localize-vs-(b) is estimator/apply/glue
    from ohm_tsd_slam.registration.nn import assign_pairs_fused
    from ohm_tsd_slam.sensor.polar2d import data_to_cartesian

    model_r = raycast_fast(grid, geom, pose, segments=seg)
    scene_r, smask_r = data_to_cartesian(geom, data, mask)
    payload_r = jnp.concatenate([model_r.coords, model_r.normals],
                                axis=1)

    def icp_nn_body(i, acc, seg):
        sc = scene_r + acc * 1e-30
        def it(j, c):
            s2 = jnp.sum(sc * sc, axis=1, keepdims=True) + c * 1e-30
            m2 = jnp.sum(model_r.coords * model_r.coords, axis=1,
                         keepdims=True).T
            d2 = jnp.maximum(s2 + m2 - 2.0 * (sc @ model_r.coords.T),
                             0.0)
            d2 = jnp.where(model_r.mask[None, :], d2, jnp.inf)
            best = jnp.min(d2, axis=1)
            iota_m = jnp.arange(B, dtype=jnp.int32)[None, :]
            idx = jnp.min(jnp.where(d2 == best[:, None], iota_m, B),
                          axis=1)
            return c + jnp.sum(jnp.where(jnp.isfinite(best), best, 0.0)) * 1e-30 + idx[0] * 1e-30
        return acc + jax.lax.fori_loop(0, 25, it,
                                       jnp.asarray(0.0, jnp.float32))

    def icp_assign_body(i, acc, seg):
        sc = scene_r + acc * 1e-30
        def it(j, c):
            idx, d2b, pm, paired = assign_pairs_fused(
                model_r.coords, model_r.mask, sc + c * 1e-30, smask_r,
                payload_r, thresh2=0.25)
            return c + jnp.sum(paired[:, 0]) * 1e-30 \
                + jnp.sum(pm) * 1e-30
        return acc + jax.lax.fori_loop(0, 25, it,
                                       jnp.asarray(0.0, jnp.float32))

    t_nn = chain(icp_nn_body, 20, seg)
    t_assign = chain(icp_assign_body, 20, seg)
    log(f"icp stages (25 iters): NN core {t_nn*1e3:.2f} ms; full fused "
        f"assignment {t_assign*1e3:.2f} ms; estimator/apply/glue "
        f"{(t_loc - t_assign)*1e3:.2f} ms (localize - assignment)")
    extras["icp_stage_nn_ms"] = round(t_nn * 1e3, 3)
    extras["icp_stage_assign_ms"] = round(t_assign * 1e3, 3)

    # compile-time tracking: seconds spent in the first (n, 4n)-chain
    # executions per stage; with the persistent cache on, a warm start
    # deserializes instead of compiling
    extras["localize_compile_s"] = compile_s.get("localize")
    extras["compile_s"] = compile_s
    extras["persistent_cache"] = cache
    extras["device"] = {"platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices())}
    extras["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")

    print(json.dumps({
        "metric": "raycast_rays_per_sec",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 2),
        **extras,
    }))


if __name__ == "__main__":
    main()
