"""RGB visualization of the TSD field.

Vectorized TsdGrid::grid2ColorImage (src/obvision/reconstruct/grid/
TsdGrid.cpp:429-488): green channel ramp for positive TSD, red ramp for
negative, white for empty-unmaterialized tiles, black for unknown.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ohm_tsd_slam.grid.state import TsdGrid


def grid_to_color_image(grid: TsdGrid, width: int = None,
                        height: int = None) -> jnp.ndarray:
    """Returns [height, width, 3] uint8.

    The reference samples at coords (w·maxX/width, h·maxY/height) through
    coord2Cell (base-cell convention) and reads the raw cell value — no
    bilinear (TsdGrid.cpp:446-456).
    """
    if width is None:
        width = grid.cells_x
    if height is None:
        height = grid.cells_y
    s = grid.cell_size

    step_w = grid.max_x / width
    step_h = grid.max_y / height
    px = jnp.arange(width, dtype=grid.tsd.dtype) * step_w
    py = jnp.arange(height, dtype=grid.tsd.dtype) * step_h

    # coord2Cell base index (TsdGrid.h:306-340)
    ix = jnp.floor(px / s - 0.5).astype(jnp.int32)
    iy = jnp.floor(py / s - 0.5).astype(jnp.int32)
    valid = ((ix >= 0)[None, :] & (ix < grid.cells_x)[None, :]
             & (iy >= 0)[:, None] & (iy < grid.cells_y)[:, None])
    ixc = jnp.clip(ix, 0, grid.cells_x - 1)
    iyc = jnp.clip(iy, 0, grid.cells_y - 1)

    cell_init = grid.tile_init[iyc[:, None] // grid.tile_dim,
                               ixc[None, :] // grid.tile_dim]
    cell_empty = (~grid.tile_init & (grid.tile_initw > 0.0))[
        iyc[:, None] // grid.tile_dim, ixc[None, :] // grid.tile_dim]
    tsd = grid.tsd[iyc[:, None], ixc[None, :]]
    tsd = jnp.where(valid & cell_init, tsd, jnp.nan)
    is_empty = valid & cell_empty

    pos = tsd > 0.0
    neg = tsd < 0.0
    ramp_pos = (tsd * 255.0).astype(jnp.uint8)
    ramp_neg = ((1.0 + tsd) * 255.0).astype(jnp.uint8)

    r = jnp.where(pos, ramp_pos,
                  jnp.where(neg, ramp_neg,
                            jnp.where(is_empty, 255, 0)))
    g = jnp.where(pos, 255, jnp.where(neg, 0,
                                      jnp.where(is_empty, 255, 0)))
    b = jnp.where(pos, ramp_pos, jnp.where(neg, 0,
                                           jnp.where(is_empty, 255, 0)))
    return jnp.stack([r, g, b], axis=-1).astype(jnp.uint8)


grid_to_color_image_jit = jax.jit(grid_to_color_image,
                                  static_argnames=("width", "height"))
