"""Functional TSD grid state.

Redesign of the reference's TsdGrid/TsdGridPartition
(src/obvision/reconstruct/grid/TsdGrid.{h,cpp},
src/obvision/reconstruct/grid/TsdGridPartition.{h,cpp}).

Design notes (vs the reference):

* The reference stores the field as lazily allocated 33x33 partitions with
  a one-cell halo kept coherent by TsdGrid::propagateBorders
  (TsdGrid.cpp:372-427).  Here the field is a dense [H, W] pair of arrays
  (tsd, weight): dense adjacency makes the halo copies unnecessary —
  bilinear taps that cross a tile border read the neighbor cells directly,
  which is exactly what propagateBorders arranges for initialized
  neighbors.  Per-tile bookkeeping (lazy init, "empty" init weight,
  TsdGridPartition.cpp:88-134 / isEmpty TsdGridPartition.h:72) lives in
  small [TY, TX] arrays.

* Divergence (documented): taps landing in a *never-initialized* tile read
  NaN here, while the reference may read a halo value materialized by an
  empty-init or increaseEmptiness history of the adjacent tile.  Both
  outcomes mean "no surface crossing detected"; only an exactly
  tile-border-aligned surface next to a never-written empty tile could
  differ.

* Cell (ix, iy) has its center at ((ix+0.5)s, (iy+0.5)s)
  (TsdGridPartition.cpp:121-131); arrays are indexed [iy, ix].

* NaN tsd marks an unwritten cell inside an initialized tile
  (TsdGridPartition.cpp:109-119).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ohm_tsd_slam.config import GridConfig

# Interpolation return codes (EnumTsdGridInterpolate, TsdGrid.h:28-35)
INTERPOLATE_SUCCESS = 0
INTERPOLATE_INVALIDINDEX = 1
INTERPOLATE_EMPTYPARTITION = 2
INTERPOLATE_ISNAN = 3

TSDINC = 1.0  # reconstruct_defs.h:6


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TsdGrid:
    """The TSD field as a pytree.

    Attributes:
      tsd:        [H, W] truncated signed distance; NaN = unwritten cell.
                  Cells of uninitialized tiles are NaN as well.
      weight:     [H, W] fusion weight (TsdCell.weight).
      tile_init:  [TY, TX] bool — tile has been materialized
                  (TsdGridPartition::isInitialized).
      tile_initw: [TY, TX] "emptiness" weight accumulated before
                  materialization (TsdGridPartition::_initWeight;
                  isEmpty == !init && initw > 0).
      cell_size, max_truncation, max_weight, tile_dim: static geometry.
    """

    tsd: jnp.ndarray
    weight: jnp.ndarray
    tile_init: jnp.ndarray
    tile_initw: jnp.ndarray
    cell_size: float = dataclasses.field(metadata=dict(static=True))
    max_truncation: float = dataclasses.field(metadata=dict(static=True))
    max_weight: float = dataclasses.field(metadata=dict(static=True))
    tile_dim: int = dataclasses.field(metadata=dict(static=True))

    # -- geometry ----------------------------------------------------------
    @property
    def cells_y(self) -> int:
        return self.tsd.shape[0]

    @property
    def cells_x(self) -> int:
        return self.tsd.shape[1]

    @property
    def tiles_y(self) -> int:
        return self.tile_init.shape[0]

    @property
    def tiles_x(self) -> int:
        return self.tile_init.shape[1]

    @property
    def min_x(self) -> float:
        return 0.0

    @property
    def max_x(self) -> float:
        return self.cells_x * self.cell_size

    @property
    def min_y(self) -> float:
        return 0.0

    @property
    def max_y(self) -> float:
        return self.cells_y * self.cell_size

    def centroid(self):
        # TsdGrid::getCentroid (TsdGrid.cpp:200-204)
        return (0.5 * (self.min_x + self.max_x),
                0.5 * (self.min_y + self.max_y))

    def is_inside(self, position) -> jnp.ndarray:
        """TsdGrid::isInsideGrid (TsdGrid.h:342-347)."""
        x, y = position[0], position[1]
        return ((x > self.min_x) & (x < self.max_x)
                & (y > self.min_y) & (y < self.max_y))


def create(config: GridConfig, dtype=jnp.float32) -> TsdGrid:
    """Allocate an all-uninitialized grid (TsdGrid::init,
    TsdGrid.cpp:112-169)."""
    h = w = config.cells_per_side
    ty = tx = config.tiles_per_side
    return TsdGrid(
        tsd=jnp.full((h, w), jnp.nan, dtype=dtype),
        weight=jnp.zeros((h, w), dtype=dtype),
        tile_init=jnp.zeros((ty, tx), dtype=bool),
        tile_initw=jnp.zeros((ty, tx), dtype=dtype),
        cell_size=float(config.cellsize),
        max_truncation=float(config.max_truncation),
        max_weight=float(config.max_weight),
        tile_dim=int(config.tile_dim),
    )


def cell_centers(grid: TsdGrid, dtype=None):
    """World coordinates of all cell centers: x[W], y[H]."""
    if dtype is None:
        dtype = grid.tsd.dtype
    s = grid.cell_size
    xs = (jnp.arange(grid.cells_x, dtype=dtype) + 0.5) * s
    ys = (jnp.arange(grid.cells_y, dtype=dtype) + 0.5) * s
    return xs, ys


def tile_of_cell(grid: TsdGrid, ix: jnp.ndarray, iy: jnp.ndarray):
    return iy // grid.tile_dim, ix // grid.tile_dim


def free_footprint(grid: TsdGrid, center, width: float,
                   height: float) -> TsdGrid:
    """TsdGrid::freeFootprint (TsdGrid.cpp:609-638): write TSDINC into a
    rectangle of cells around `center`, materializing touched tiles.

    Index arithmetic replicates the reference's `coord/s + 0.5` rounding.
    Out-of-bounds rectangles leave the grid unchanged (the reference
    returns false).
    """
    s = grid.cell_size
    cx, cy = center[0], center[1]
    min_x = jnp.floor((cx - width * 0.5) / s + 0.5).astype(jnp.int32)
    max_x = jnp.floor((cx + width * 0.5) / s + 0.5).astype(jnp.int32)
    min_y = jnp.floor((cy - height * 0.5) / s + 0.5).astype(jnp.int32)
    max_y = jnp.floor((cy + height * 0.5) / s + 0.5).astype(jnp.int32)
    in_bounds = ((min_x >= 0) & (max_x <= grid.cells_x)
                 & (min_y >= 0) & (max_y <= grid.cells_y))

    ix = jnp.arange(grid.cells_x)
    iy = jnp.arange(grid.cells_y)
    in_rect = ((iy[:, None] >= min_y) & (iy[:, None] < max_y)
               & (ix[None, :] >= min_x) & (ix[None, :] < max_x)
               & in_bounds)

    # Tiles touched by the rectangle get materialized (reference calls
    # partition init(), which fills cells with NaN or the empty value —
    # here the dense cells already hold NaN, so only the flag flips; cells
    # of tiles that were "empty" materialize to their init value first).
    td = grid.tile_dim
    tile_touched = in_rect.reshape(grid.tiles_y, td, grid.tiles_x, td).any(axis=(1, 3))
    newly_init = tile_touched & ~grid.tile_init
    was_empty = newly_init & (grid.tile_initw > 0.0)
    cell_newly_empty = jnp.repeat(jnp.repeat(was_empty, td, 0), td, 1)
    cell_initw = jnp.repeat(jnp.repeat(grid.tile_initw, td, 0), td, 1)

    tsd = jnp.where(cell_newly_empty, TSDINC, grid.tsd)
    weight = jnp.where(cell_newly_empty, cell_initw, grid.weight)
    tsd = jnp.where(in_rect, TSDINC, tsd)

    # tile_initw is kept as-is: the reference never resets _initWeight on
    # init; it simply stops being read once the tile is initialized.
    return dataclasses.replace(
        grid,
        tsd=tsd,
        weight=weight,
        tile_init=grid.tile_init | tile_touched,
    )
