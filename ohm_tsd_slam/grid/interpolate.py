"""Bilinear TSD interpolation and surface normals.

Vectorized replication of TsdGrid::interpolateBilinear / coord2Cell
(src/obvision/reconstruct/grid/TsdGrid.h:284-340) and
TsdGrid::interpolateNormal (src/obvision/reconstruct/grid/TsdGrid.cpp:517-546).

All functions accept arbitrary leading batch dimensions of query
coordinates and return (value, code) pairs, with codes matching the
reference's EnumTsdGridInterpolate so callers can reproduce its control
flow (the ray caster distinguishes EMPTY/INVALID from ISNAN during its
coarse partition skip, RayCastPolar2D.cpp:224-235).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ohm_tsd_slam.grid.state import (
    INTERPOLATE_EMPTYPARTITION,
    INTERPOLATE_INVALIDINDEX,
    INTERPOLATE_ISNAN,
    INTERPOLATE_SUCCESS,
    TsdGrid,
)


def coord2cell(grid: TsdGrid, coords: jnp.ndarray):
    """TsdGrid::coord2Cell (TsdGrid.h:306-340).

    The base cell is the one whose *center* lies at or below the query in
    both axes, guaranteeing 4 neighbors for bilinear interpolation:
    base = floor(coord/s - 0.5).  Weights are the fractional offsets from
    the base cell center.

    Returns (ix, iy, wx, wy, valid).
    """
    s = grid.cell_size
    u = coords[..., 0] / s - 0.5
    v = coords[..., 1] / s - 0.5
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    wx = u - ix
    wy = v - iy
    # Reference bounds check (TsdGrid.h:332): xIdx in [0, cellsX-1]; note
    # it admits xIdx == cellsX-1 whose +1 tap reads the (never-propagated)
    # outer halo => NaN; we reproduce that via out-of-bounds NaN taps.
    valid = (ix >= 0) & (ix < grid.cells_x) & (iy >= 0) & (iy < grid.cells_y)
    return ix, iy, wx, wy, valid


def _tap(grid: TsdGrid, ix: jnp.ndarray, iy: jnp.ndarray) -> jnp.ndarray:
    """Read tsd[iy, ix] with out-of-bounds reads yielding NaN (the
    reference's outer halo cells are initialized to NaN and never
    propagated)."""
    oob = (ix < 0) | (ix >= grid.cells_x) | (iy < 0) | (iy >= grid.cells_y)
    ixc = jnp.clip(ix, 0, grid.cells_x - 1)
    iyc = jnp.clip(iy, 0, grid.cells_y - 1)
    v = grid.tsd[iyc, ixc]
    return jnp.where(oob, jnp.nan, v)


def interpolate_bilinear(grid: TsdGrid,
                         coords: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """TsdGrid::interpolateBilinear (TsdGrid.h:284-304).

    Args:
      coords: (..., 2) world coordinates.
    Returns:
      (tsd, code): interpolated TSD (NaN on failure) and the
      EnumTsdGridInterpolate code per query.
    """
    ix, iy, wx, wy, valid = coord2cell(grid, coords)

    # Owning-tile state decides EMPTYPARTITION (TsdGrid.h:293): the tile
    # of the (shifted) base cell.
    txc = jnp.clip(ix // grid.tile_dim, 0, grid.tiles_x - 1)
    tyc = jnp.clip(iy // grid.tile_dim, 0, grid.tiles_y - 1)
    tile_ok = grid.tile_init[tyc, txc]

    v00 = _tap(grid, ix, iy)
    v10 = _tap(grid, ix, iy + 1)
    v01 = _tap(grid, ix + 1, iy)
    v11 = _tap(grid, ix + 1, iy + 1)
    # Exact tap ordering/weights of TsdGridPartition::interpolateBilinear
    # (TsdGridPartition.h:214-221).
    tsd = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)

    code = jnp.where(jnp.isnan(tsd), INTERPOLATE_ISNAN, INTERPOLATE_SUCCESS)
    code = jnp.where(~tile_ok, INTERPOLATE_EMPTYPARTITION, code)
    code = jnp.where(~valid, INTERPOLATE_INVALIDINDEX, code)
    tsd = jnp.where(code == INTERPOLATE_SUCCESS, tsd, jnp.nan)
    return tsd, code


def interpolate_bilinear_safe(grid: TsdGrid, coords: jnp.ndarray
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Differentiation-safe bilinear interpolation: identical values to
    `interpolate_bilinear` where it succeeds, but NaN taps are replaced
    by zeros *inside* the arithmetic so reverse-mode AD never multiplies
    NaN into the tap-weight gradients (d/dcoords).  Returns (tsd, ok).
    """
    ix, iy, wx, wy, valid = coord2cell(grid, coords)
    txc = jnp.clip(ix // grid.tile_dim, 0, grid.tiles_x - 1)
    tyc = jnp.clip(iy // grid.tile_dim, 0, grid.tiles_y - 1)
    tile_ok = grid.tile_init[tyc, txc]

    taps = [_tap(grid, ix, iy), _tap(grid, ix, iy + 1),
            _tap(grid, ix + 1, iy), _tap(grid, ix + 1, iy + 1)]
    finite = ~(jnp.isnan(taps[0]) | jnp.isnan(taps[1])
               | jnp.isnan(taps[2]) | jnp.isnan(taps[3]))
    v00, v10, v01, v11 = [jnp.nan_to_num(t) for t in taps]
    tsd = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)
    ok = valid & tile_ok & finite
    return jnp.where(ok, tsd, 0.0), ok


def interpolate_normal(grid: TsdGrid,
                       coords: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """TsdGrid::interpolateNormal (TsdGrid.cpp:517-546): central
    differences of bilinear taps at ±cellSize, normalized.

    Returns (normals (...,2), ok mask). Normals are NaN where not ok.
    """
    s = grid.cell_size
    ex = jnp.zeros_like(coords).at[..., 0].set(s)
    ey = jnp.zeros_like(coords).at[..., 1].set(s)

    xp, cxp = interpolate_bilinear(grid, coords + ex)
    xm, cxm = interpolate_bilinear(grid, coords - ex)
    yp, cyp = interpolate_bilinear(grid, coords + ey)
    ym, cym = interpolate_bilinear(grid, coords - ey)

    ok = ((cxp == INTERPOLATE_SUCCESS) & (cxm == INTERPOLATE_SUCCESS)
          & (cyp == INTERPOLATE_SUCCESS) & (cym == INTERPOLATE_SUCCESS))

    n = jnp.stack([xp - xm, yp - ym], axis=-1)
    norm = jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True))
    n = n / jnp.where(norm > 0, norm, 1.0)
    n = jnp.where(ok[..., None], n, jnp.nan)
    return n, ok
