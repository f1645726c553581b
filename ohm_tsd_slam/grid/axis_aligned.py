"""Axis-aligned surface extraction → occupancy grid.

Redesign of RayCastAxisAligned2D::calcCoords
(src/obvision/reconstruct/grid/RayCastAxisAligned2D.cpp:13-105) plus the
occupancy-grid assembly of ThreadGrid::eventLoop
(src/ThreadGrid.cpp:72-133).

The reference walks initialized non-empty partitions of the interior tile
ring (skipping partition indices {0, T-1}, RayCastAxisAligned2D.cpp:25-27),
scanning rows then columns INCLUDING the one-cell halo (px,py run to
dimension+1, :39-82) for TSD sign changes, and filling a char buffer with
free(0)/unknown(-1); ThreadGrid then stamps occupied(100) at the rounded
crossing coordinates, optionally inflating.  Here the whole map is
evaluated as dense [H, W] comparisons of adjacent cells — one fused
vectorized kernel, no per-partition loops.

Halo semantics replicated exactly (validated bit-for-bit against the
compiled reference in tests/test_reference_parity.py):

  * a tile's halo holds its right/up neighbor's first row/col iff both
    tiles are initialized (TsdGrid::propagateBorders, TsdGrid.cpp:372-427),
    which dense adjacency reproduces by construction;
  * the px==P / py==P halo writes of a scanning tile spill into the first
    row/col of the next tile — visible in the final char grid only where
    the receiving tile writes nothing itself (ring or uninitialized
    tiles), since partitions are processed in ascending y,x order;
  * crossings on a tile-boundary row/col are found by BOTH adjacent
    scanning tiles (duplicate coords in the reference output) and by the
    up/left tile alone when the own tile is outside the interior ring.

The reference's half-cell-offset crossing coordinates (it omits the
+0.5·cellSize cell-center shift, RayCastAxisAligned2D.cpp:54-55) are
replicated so occupancy indices bit-match.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.grid.state import TsdGrid


class OccupancyResult(NamedTuple):
    occupancy: jnp.ndarray  # [H, W] int8: -1 unknown, 0 free, 100 occupied
    n_surface: jnp.ndarray  # number of surface crossings found (counting
    #                         the reference's boundary duplicates)


def _interior_tile_mask(grid: TsdGrid) -> jnp.ndarray:
    """Tiles outside the outer ring (RayCastAxisAligned2D.cpp:25-27)."""
    ty = jnp.arange(grid.tiles_y)
    tx = jnp.arange(grid.tiles_x)
    ok_y = (ty >= 1) & (ty <= grid.tiles_y - 2)
    ok_x = (tx >= 1) & (tx <= grid.tiles_x - 2)
    return ok_y[:, None] & ok_x[None, :]


def occupancy_grid(grid: TsdGrid, use_inflation: bool = False,
                   inflation_factor: int = 2) -> OccupancyResult:
    """Extract the occupancy grid.

    free/unknown chars: cells of initialized interior tiles are 0 where
    tsd > 0 else -1 (RayCastAxisAligned2D.cpp:42-49); cells of interior
    empty-but-unmaterialized tiles are 0 (:87-101); first-row/col cells of
    tiles adjacent (right/down/diag) to a scanning interior tile receive
    the halo spill — 0 iff their own tile is initialized with tsd > 0;
    everything else -1.

    occupied: TSD zero crossings along rows and columns, sub-cell
    interpolated, stamped at round(x/cellSize) with bounds check
    u,v in (0, W)x(0, H) (ThreadGrid.cpp:96-118).
    """
    p = grid.tile_dim
    tsd = grid.tsd
    H, W = tsd.shape
    ii = _interior_tile_mask(grid) & grid.tile_init   # scanning tiles

    def cells(tiles):
        return jnp.repeat(jnp.repeat(tiles, p, 0), p, 1)

    cell_ii = cells(ii)
    cell_init = cells(grid.tile_init)
    cell_empty = cells(~grid.tile_init & (grid.tile_initw > 0.0)
                       & _interior_tile_mask(grid))

    # halo spill: cell (gy, gx) on a tile's first row/col is also written
    # by the up/left/diag scanning tile; the spilled value is the
    # propagated halo = the cell's own value if its tile is initialized,
    # NaN (→ -1) otherwise.
    def shift_tiles(tiles, dy, dx):
        return jnp.roll(tiles, (dy, dx), (0, 1)) \
            & (jnp.arange(tiles.shape[0])[:, None] >= (dy if dy > 0 else 0)) \
            & (jnp.arange(tiles.shape[1])[None, :] >= (dx if dx > 0 else 0))

    row0 = (jnp.arange(H) % p == 0)[:, None] & (jnp.arange(H) >= p)[:, None]
    col0 = (jnp.arange(W) % p == 0)[None, :] & (jnp.arange(W) >= p)[None, :]
    spill = (row0 & cells(shift_tiles(ii, 1, 0))) \
        | (col0 & cells(shift_tiles(ii, 0, 1))) \
        | (row0 & col0 & cells(shift_tiles(ii, 1, 1)))

    # every written-but-not-free cell gets -1, same as unwritten cells,
    # so the char grid reduces to: 0 iff free
    free = ((cell_ii | spill) & cell_init & (tsd > 0.0)) | cell_empty
    occ = jnp.where(free, 0, -1).astype(jnp.int8)

    # ---- surface crossings ----------------------------------------------
    def crossings(a, b):
        return ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))

    s = grid.cell_size

    # horizontal pairs: (gy, gx-1) -> (gy, gx); scanned by the tile owning
    # the first cell (px-1 ∈ [0, P-1], RayCastAxisAligned2D.cpp:45), plus
    # a duplicate scan by the up tile when gy is a tile boundary (py == P).
    a = tsd[:, :-1]
    b = tsd[:, 1:]
    hcross = crossings(a, b)
    h_own = hcross & cell_ii[:, :-1]
    h_dup = hcross & (row0 & cells(shift_tiles(ii, 1, 0)))[:, :-1]
    hmask = h_own | h_dup
    hinterp = a / (a - b)
    # x = (gx-1 + interp)·s  (reference formula, half-cell quirk);
    # u = round(x/s), v = gy
    gx = jnp.arange(1, W)
    hu = jnp.floor(gx[None, :] - 1.0 + hinterp + 0.5).astype(jnp.int32)
    hv = jnp.broadcast_to(jnp.arange(H)[:, None], hu.shape)

    # vertical pairs: (gy-1, gx) -> (gy, gx)
    a2 = tsd[:-1, :]
    b2 = tsd[1:, :]
    vcross = crossings(a2, b2)
    v_own = vcross & cell_ii[:-1, :]
    v_dup = vcross & (col0 & cells(shift_tiles(ii, 0, 1)))[:-1, :]
    vmask = v_own | v_dup
    vinterp = a2 / (a2 - b2)
    gy = jnp.arange(1, H)
    vv = jnp.floor(gy[:, None] - 1.0 + vinterp + 0.5).astype(jnp.int32)
    vu = jnp.broadcast_to(jnp.arange(W)[None, :], vv.shape)

    occupied = jnp.zeros((H, W), bool)

    def stamp(occupied, u, v, m):
        ok = m & (u > 0) & (u < W) & (v > 0) & (v < H)
        uc = jnp.clip(u, 0, W - 1)
        vc = jnp.clip(v, 0, H - 1)
        return occupied.at[vc.ravel(), uc.ravel()].max(ok.ravel())

    occupied = stamp(occupied, hu, hv, hmask)
    occupied = stamp(occupied, vu, vv, vmask)

    if use_inflation and inflation_factor > 0:
        # ThreadGrid.cpp:105-114: window [v-f, v+f) x [u-f, u+f)
        f = inflation_factor
        base = occupied
        for dy in range(-f, f):
            for dx in range(-f, f):
                occupied = occupied | jnp.roll(base, (dy, dx), (0, 1))

    occ = jnp.where(occupied, 100, occ).astype(jnp.int8)
    # event count matching the reference's cnt/2 (duplicates included)
    n = (jnp.sum(h_own) + jnp.sum(h_dup)
         + jnp.sum(v_own) + jnp.sum(v_dup))
    return OccupancyResult(occ, n)


def surface_points(grid: TsdGrid) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The crossing coordinates themselves (reference coords list,
    deduplicated), as a fixed-size masked array [N, 2], mask [N].

    Coordinates replicate RayCastAxisAligned2D.cpp:52-55 / 75-78:
    x = (gx-1+interp)·s for row scans (y = gy·s), and the transpose for
    column scans.
    """
    p = grid.tile_dim
    tsd = grid.tsd
    H, W = tsd.shape
    s = grid.cell_size
    ii = _interior_tile_mask(grid) & grid.tile_init

    def cells(tiles):
        return jnp.repeat(jnp.repeat(tiles, p, 0), p, 1)

    def crossings(a, b):
        return ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))

    row0 = (jnp.arange(H) % p == 0)[:, None] & (jnp.arange(H) >= p)[:, None]
    col0 = (jnp.arange(W) % p == 0)[None, :] & (jnp.arange(W) >= p)[None, :]

    def shift_tiles(tiles, dy, dx):
        return jnp.roll(tiles, (dy, dx), (0, 1)) \
            & (jnp.arange(tiles.shape[0])[:, None] >= (dy if dy > 0 else 0)) \
            & (jnp.arange(tiles.shape[1])[None, :] >= (dx if dx > 0 else 0))

    a = tsd[:, :-1]
    b = tsd[:, 1:]
    h_scan = cells(ii) | (row0 & cells(shift_tiles(ii, 1, 0)))
    hmask = crossings(a, b) & h_scan[:, :-1]
    hinterp = a / (a - b)
    gxg = jnp.arange(1, W, dtype=tsd.dtype)
    hx = (gxg[None, :] - 1.0 + hinterp) * s
    hy = jnp.broadcast_to(jnp.arange(H, dtype=tsd.dtype)[:, None] * s,
                          hx.shape)

    a2 = tsd[:-1, :]
    b2 = tsd[1:, :]
    v_scan = cells(ii) | (col0 & cells(shift_tiles(ii, 0, 1)))
    vmask = crossings(a2, b2) & v_scan[:-1, :]
    vinterp = a2 / (a2 - b2)
    gyg = jnp.arange(1, H, dtype=tsd.dtype)
    vy = (gyg[:, None] - 1.0 + vinterp) * s
    vx = jnp.broadcast_to(jnp.arange(W, dtype=tsd.dtype)[None, :] * s,
                          vy.shape)

    pts = jnp.concatenate([
        jnp.stack([hx.ravel(), hy.ravel()], -1),
        jnp.stack([vx.ravel(), vy.ravel()], -1),
    ])
    mask = jnp.concatenate([hmask.ravel(), vmask.ravel()])
    return pts, mask


occupancy_grid_jit = jax.jit(occupancy_grid,
                             static_argnames=("use_inflation",
                                              "inflation_factor"))
