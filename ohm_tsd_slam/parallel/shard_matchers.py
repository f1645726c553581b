"""Communication-bounded sharded paths for the grid-READING matchers.

The reference's shipped default registration mode is TSD
(config/single-laser.yaml registration_mode: 3): TSD_PDFMatching rates
candidate poses by bilinear taps into the TSD field
(src/obvision/registration/ransacMatching/TSD_PDFMatching.cpp:223-251).
The AMCL particle matcher uses the same likelihood, and the direct
Gauss-Newton matcher reads value + spatial gradient per scene point.
When the grid is row-sharded over the "sp" mesh axis, satisfying those
taps through GSPMD has no communication bound.

This module gives each of the three a shard_map path with provably
bounded collectives:

  * every shard evaluates the taps whose base-cell ROW it owns (one halo
    row covers the iy+1 taps of the bilinear stencil — the
    propagateBorders analogue, TsdGrid.cpp:372-427);
  * per-point results are reduced LOCALLY (over control points / scene
    points), and only the per-candidate partial sums cross chips:
      - TSD matcher:  psum of [chunk] log-likelihood partials per score
        chunk — O(candidates) floats per match;
      - AMCL:         psum of [particles] partials per filter iteration;
      - Gauss-Newton: psum of the packed 3x3 normal equations
        (~16 floats) per iteration;
  * queries whose base cell falls outside the grid (INVALIDINDEX → the
    zrand miss likelihood) are owned by shard 0 so every point is
    counted exactly once.

Everything *else* in the matchers (trial preparation, PRNG draws,
candidate generation, argmax selection) is computed replicated on every
shard from replicated inputs — bitwise identical per shard, so the
returned transform is replicated without extra communication.

Certified by tools/multichip_scaling.py (sp_step_tsd section) and
asserted equal to the single-device matchers in tests/test_parallel.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ohm_tsd_slam.grid.state import TsdGrid
from ohm_tsd_slam.parallel.shard_raycast import _halo_exchange

# bilinear stencil reach: base row iy plus one row above (iy + 1)
_TAP_HALO = 1


def _tap_block(block: jnp.ndarray, ix: jnp.ndarray, iy_local: jnp.ndarray,
               W: int) -> jnp.ndarray:
    """Read block[iy_local, ix] with out-of-bounds x reads yielding NaN
    (grid/interpolate.py::_tap semantics; the y bounds are handled by the
    NaN-filled halo rows of edge shards)."""
    oob = (ix < 0) | (ix >= W)
    ixc = jnp.clip(ix, 0, W - 1)
    iyc = jnp.clip(iy_local, 0, block.shape[0] - 1)
    v = block[iyc, ixc]
    return jnp.where(oob, jnp.nan, v)


def _local_tsd_logp_sum(block, tile_init, s, W, H, td, y0_rows, h, idx_sp,
                        axis, world, pmask, zrand):
    """Per-shard partial of the TSD log-likelihood sum, psum'd exact.

    Replicates registration/ransac.py::match_tsd's per-point likelihood
    (TSD_PDFMatching.cpp:233-251): log(1 − (1−zrand)·|tsd|) on bilinear
    hits, log(zrand) on misses (invalid index, empty tile, NaN taps).

    Args:
      block: [h + 2, W] owned rows with one halo row per side.
      world: [..., C, 2] query points (replicated).
      pmask: [C] bool control-point validity (replicated).
    Returns:
      [...] log-likelihood sums (replicated via psum).
    """
    dtype = block.dtype
    u = world[..., 0] / s - 0.5
    v = world[..., 1] / s - 0.5
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    wx = (u - ix).astype(dtype)
    wy = (v - iy).astype(dtype)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    own = valid & (iy >= y0_rows) & (iy < y0_rows + h)

    iy_l = iy - y0_rows + _TAP_HALO
    v00 = _tap_block(block, ix, iy_l, W)
    v10 = _tap_block(block, ix, iy_l + 1, W)
    v01 = _tap_block(block, ix + 1, iy_l, W)
    v11 = _tap_block(block, ix + 1, iy_l + 1, W)
    tsd = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)

    txc = jnp.clip(ix // td, 0, tile_init.shape[1] - 1)
    tyc = jnp.clip(iy // td, 0, tile_init.shape[0] - 1)
    tile_ok = tile_init[tyc, txc]

    hit = own & tile_ok & ~jnp.isnan(tsd)
    log_zrand = jnp.log(jnp.asarray(zrand, dtype))
    logp_hit = jnp.log(jnp.maximum(1.0 - (1.0 - zrand)
                                   * jnp.abs(jnp.where(hit, tsd, 0.0)),
                                   1e-30))
    # owned points: hit or (owned) miss; globally-invalid points are
    # counted once by shard 0
    miss0 = ~valid & (idx_sp == 0)
    contrib = (jnp.where(hit, logp_hit, 0.0)
               + jnp.where((own & ~hit) | miss0, log_zrand, 0.0))
    contrib = jnp.where(pmask, contrib, 0.0)
    return jax.lax.psum(jnp.sum(contrib, axis=-1), axis)


def sharded_match_tsd(mesh: Mesh, key, grid: TsdGrid, sensor_pose,
                      model, mask_model, scene, mask_scene, params,
                      axis: str = "sp"):
    """TSD_PDFMatching against a row-sharded grid.

    Identical candidate set and scoring to
    registration/ransac.py::match_tsd (same PRNG key → same draws on
    every shard); only the grid taps are satisfied shard-locally, with
    per-chunk psum of the [chunk] candidate log-likelihoods.
    """
    from ohm_tsd_slam.registration.ransac import match_tsd

    H, W = grid.tsd.shape
    td = grid.tile_dim
    s = float(grid.cell_size)
    n = int(mesh.shape[axis])
    h = H // n
    zrand = params.zrand_tsd

    def body(tsd_local, tile_init, key, sensor_pose, model, mask_model,
             scene, mask_scene):
        idx_sp = jax.lax.axis_index(axis)
        y0 = idx_sp * h
        block = _halo_exchange(tsd_local, axis, rows=_TAP_HALO)
        logp_sum_fn = partial(_local_tsd_logp_sum, block, tile_init, s,
                              W, H, td, y0, h, idx_sp, axis)
        return match_tsd(key, None, sensor_pose, model, mask_model,
                         scene, mask_scene, params,
                         logp_sum_fn=lambda world, pmask:
                         logp_sum_fn(world, pmask, zrand))

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(axis, None), P(), P(), P(), P(), P(),
                             P(), P()),
                   out_specs=P())
    return fn(grid.tsd, grid.tile_init, key, sensor_pose, model,
              mask_model, scene, mask_scene)


def sharded_match_amcl(mesh: Mesh, key, grid: TsdGrid, sensor_pose,
                       scene, mask_scene, params, axis: str = "sp"):
    """AMCL particle matching against a row-sharded grid: per-iteration
    communication = one psum of the [particles] log-likelihoods (the
    resampling/jitter runs replicated from the shared key)."""
    from ohm_tsd_slam.registration.amcl import match_amcl

    H, W = grid.tsd.shape
    td = grid.tile_dim
    s = float(grid.cell_size)
    n = int(mesh.shape[axis])
    h = H // n
    zrand = params.zrand

    def body(tsd_local, tile_init, key, sensor_pose, scene, mask_scene):
        idx_sp = jax.lax.axis_index(axis)
        y0 = idx_sp * h
        block = _halo_exchange(tsd_local, axis, rows=_TAP_HALO)
        logp_sum_fn = partial(_local_tsd_logp_sum, block, tile_init, s,
                              W, H, td, y0, h, idx_sp, axis)
        return match_amcl(key, None, sensor_pose, scene, mask_scene,
                          params,
                          logp_sum_fn=lambda world, pmask:
                          logp_sum_fn(world, pmask, zrand))

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(axis, None), P(), P(), P(), P(), P()),
                   out_specs=P())
    return fn(grid.tsd, grid.tile_init, key, sensor_pose, scene,
              mask_scene)


def _local_field_value_grad(block, s, W, H, y0_rows, h, x):
    """registration/gauss_newton.py::_field_value_grad on the local
    halo'd block, with `ok` additionally masked to owned base rows so
    non-owned points contribute nothing to the psum'd normal
    equations."""
    dtype = block.dtype
    u = x[..., 0] / s - 0.5
    v = x[..., 1] / s - 0.5
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    wx = (u - ix).astype(dtype)
    wy = (v - iy).astype(dtype)
    valid = (ix >= 0) & (ix < W - 1) & (iy >= 0) & (iy < H - 1)
    own = valid & (iy >= y0_rows) & (iy < y0_rows + h)

    iy_l = iy - y0_rows + _TAP_HALO
    v00 = _tap_block(block, ix, iy_l, W)
    v10 = _tap_block(block, ix, iy_l + 1, W)
    v01 = _tap_block(block, ix + 1, iy_l, W)
    v11 = _tap_block(block, ix + 1, iy_l + 1, W)
    finite = ~(jnp.isnan(v00) | jnp.isnan(v10) | jnp.isnan(v01)
               | jnp.isnan(v11))
    v00, v10, v01, v11 = (jnp.nan_to_num(t) for t in (v00, v10, v01, v11))
    val = (v00 * (1.0 - wy) * (1.0 - wx) + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx + v11 * wy * wx)
    gx = ((v01 - v00) * (1.0 - wy) + (v11 - v10) * wy) / s
    gy = ((v10 - v00) * (1.0 - wx) + (v11 - v01) * wx) / s
    return val, gx, gy, own & finite


def sharded_match_gauss_newton(mesh: Mesh, grid: TsdGrid, sensor_pose,
                               scene, scene_mask, params, T_init=None,
                               axis: str = "sp"):
    """Direct scan-to-map Gauss-Newton against a row-sharded grid:
    per-iteration communication = one psum of the packed normal
    equations (3x3 H, 3-vector b, and 3 scalars — ~16 floats)."""
    from ohm_tsd_slam.registration.gauss_newton import (
        match_gauss_newton,
    )

    H, W = grid.tsd.shape
    s = float(grid.cell_size)
    trunc = float(grid.max_truncation)
    n = int(mesh.shape[axis])
    h = H // n

    def body(tsd_local, sensor_pose, scene, scene_mask, T_init):
        idx_sp = jax.lax.axis_index(axis)
        y0 = idx_sp * h
        block = _halo_exchange(tsd_local, axis, rows=_TAP_HALO)

        def field_fn(x):
            return _local_field_value_grad(block, s, W, H, y0, h, x)

        def reduce_fn(stats):
            return jax.lax.psum(stats, axis)

        return match_gauss_newton(None, sensor_pose, scene, scene_mask,
                                  params, T_init=T_init,
                                  field_fn=field_fn,
                                  reduce_fn=reduce_fn,
                                  max_truncation=trunc)

    if T_init is None:
        T_init = jnp.eye(3, dtype=grid.tsd.dtype)
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(axis, None), P(), P(), P(), P()),
                   out_specs=P())
    return fn(grid.tsd, sensor_pose, scene, scene_mask, T_init)
