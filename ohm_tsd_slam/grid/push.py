"""Scan fusion: push a polar scan into the TSD grid.

Redesign of TsdGrid::push (src/obvision/reconstruct/grid/
TsdGrid.cpp:217-284) + TsdGridComponent::isInRange culling
(src/obvision/reconstruct/grid/TsdGridComponent.cpp:43-124) +
TsdGridPartition::addTsd / increaseEmptiness
(src/obvision/reconstruct/grid/TsdGridPartition.h:170-212, .cpp:136-164).

Where the reference runs an OpenMP loop over lazily-allocated partitions,
each doing a per-cell back-projection and a scalar fusion update, this
implementation evaluates the *entire* grid as dense [H, W] arrays in one
fused XLA computation:

  1. per-tile culling masks (the isInRange geometry) on [TY, TX] arrays,
  2. per-cell beam index via vectorized back-projection (atan2 over all
     cell centers),
  3. the addTsd weighted-running-average blend, gated by the tile masks,
  4. the increaseEmptiness update for fully-traversed empty tiles.

There is no halo propagation step: dense adjacency replaces
TsdGrid::propagateBorders (TsdGrid.cpp:372-427).

Everything is jit-compatible; `push` is a pure function
(grid, pose, data, mask) -> grid.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.state import TSDINC, TsdGrid, cell_centers
from ohm_tsd_slam.sensor.polar2d import SensorPolar2D, back_project


def _tile_edges(grid: TsdGrid, dtype):
    """Homogeneous corner coordinates of every tile, shape [TY, TX, 4, 2].

    Corner positions replicate TsdGridPartition's _edgeCoordsHom
    (TsdGridPartition.cpp:48-63): cell centers of the corner cells, i.e.
    ((x+0.5)s, (y+0.5)s) .. ((x+P+0.5)s, (y+P+0.5)s).
    """
    p = grid.tile_dim
    s = grid.cell_size
    tx0 = (jnp.arange(grid.tiles_x, dtype=dtype) * p + 0.5) * s
    ty0 = (jnp.arange(grid.tiles_y, dtype=dtype) * p + 0.5) * s
    txe = tx0 + p * s
    tye = ty0 + p * s
    shape = (grid.tiles_y, grid.tiles_x)
    ex = jnp.stack([jnp.broadcast_to(a[None, :], shape)
                    for a in (tx0, txe, tx0, txe)], axis=-1)
    ey = jnp.stack([jnp.broadcast_to(a[:, None], shape)
                    for a in (ty0, ty0, tye, tye)], axis=-1)
    return jnp.stack([ex, ey], axis=-1)  # [TY, TX, 4, 2]


def tile_cull(grid: TsdGrid, geom: SensorPolar2D, pose: jnp.ndarray,
              data: jnp.ndarray, mask: jnp.ndarray
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Vectorized TsdGridComponent::isInRange over all tiles.

    Returns:
      touch:     [TY, TX] tile participates in the fusion update
      empty_inc: [TY, TX] tile is fully traversed -> increaseEmptiness
      part_weight: [TY, TX] distance-based weight
                   ((maxRange - distCentroid)/maxRange)^2
                   (TsdGrid.cpp:239-243)
    """
    dtype = grid.tsd.dtype
    p = grid.tile_dim
    s = grid.cell_size
    tr = se2.translation(pose).astype(dtype)

    # Tile centroid/circumradius (TsdGridPartition.cpp:65-70)
    cx = (jnp.arange(grid.tiles_x, dtype=dtype) * p + (p + 1) * 0.5) * s
    cy = (jnp.arange(grid.tiles_y, dtype=dtype) * p + (p + 1) * 0.5) * s
    centroid = jnp.stack(
        jnp.broadcast_arrays(cx[None, :], cy[:, None]), axis=-1)
    circumradius = jnp.sqrt(jnp.asarray(2.0, dtype)) * (p * s) * 0.5

    distance = jnp.linalg.norm(centroid - tr, axis=-1)
    trunc = jnp.asarray(grid.max_truncation, dtype)
    closest = distance - circumradius - trunc
    farthest = distance + circumradius + trunc
    # Range-window tests (TsdGridComponent.cpp:49-58)
    in_window = (closest <= geom.max_range) & (farthest >= geom.min_range)

    # Corner back-projection (TsdGridComponent.cpp:66-93)
    edges = _tile_edges(grid, dtype)
    idx_edge = back_project(geom, pose, edges)          # [TY, TX, 4]
    below = idx_edge == -2
    above = idx_edge == -1
    any_visible = jnp.any(~below & ~above, axis=-1)
    all_visible = jnp.all(~below & ~above, axis=-1)
    idx_mapped = jnp.where(above, geom.size - 1, jnp.where(below, 0, idx_edge))
    min_idx = jnp.min(idx_mapped, axis=-1)
    max_idx = jnp.max(idx_mapped, axis=-1)

    # Beam-span reductions (TsdGridComponent.cpp:96-114). [TY, TX, B]
    beams = jnp.arange(geom.size)
    in_span = ((beams >= min_idx[..., None]) & (beams <= max_idx[..., None]))
    visible_beam = (data[None, None, :] > closest[..., None]) & mask[None, None, :]
    is_visible = jnp.any(in_span & visible_beam, axis=-1)

    empty_beam = jnp.where(
        jnp.isinf(data)[None, None, :],
        (distance < geom.low_reflectivity_range)[..., None],
        (data[None, None, :] > farthest[..., None]) & mask[None, None, :],
    )
    is_empty = jnp.all(~in_span | empty_beam, axis=-1)

    base = in_window & any_visible & is_visible
    empty_inc = base & all_visible & is_empty
    touch = base & ~empty_inc

    dist_clamped = jnp.minimum(distance, geom.max_range)
    part_weight = ((geom.max_range - dist_clamped) / geom.max_range) ** 2
    return touch, empty_inc, part_weight


def _expand_tiles(grid: TsdGrid, tile_arr: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a [TY, TX] per-tile array to [H, W] cells."""
    p = grid.tile_dim
    return jnp.repeat(jnp.repeat(tile_arr, p, axis=0), p, axis=1)


def push(grid: TsdGrid, geom: SensorPolar2D, pose: jnp.ndarray,
         data: jnp.ndarray, mask: jnp.ndarray,
         tile_gate: jnp.ndarray | None = None) -> TsdGrid:
    """Fuse one masked polar scan into the grid (TsdGrid::push).

    Args:
      grid: current TSD state.
      geom: scan geometry (static).
      pose: (3,3) sensor pose in world frame.
      data: (B,) ranges (inf = no return; see standard_mask).
      mask: (B,) validity mask.
      tile_gate: optional [TY, TX] bool pre-cull mask; tiles outside it
        take no part in the update (used by push_tree's quadtree gate).
    Returns:
      updated grid.
    """
    dtype = grid.tsd.dtype
    data = data.astype(dtype)
    tr = se2.translation(pose).astype(dtype)
    trunc = jnp.asarray(grid.max_truncation, dtype)

    touch, empty_inc, part_weight = tile_cull(grid, geom, pose, data, mask)
    if tile_gate is not None:
        touch = touch & tile_gate
        empty_inc = empty_inc & tile_gate

    # ---- materialize newly-initialized tiles (TsdGridPartition::init) ----
    newly_init = touch & ~grid.tile_init
    was_empty = newly_init & (grid.tile_initw > 0.0)
    cell_new_empty = _expand_tiles(grid, was_empty)
    cell_new_plain = _expand_tiles(grid, newly_init & ~was_empty)
    cell_initw = _expand_tiles(grid, grid.tile_initw)

    tsd0 = jnp.where(cell_new_empty, TSDINC,
                     jnp.where(cell_new_plain, jnp.nan, grid.tsd))
    w0 = jnp.where(cell_new_empty, cell_initw,
                   jnp.where(cell_new_plain, 0.0, grid.weight))

    # ---- per-cell fusion over touched tiles (TsdGrid.cpp:246-274) -------
    xs, ys = cell_centers(grid, dtype)
    cells = jnp.stack(jnp.broadcast_arrays(xs[None, :], ys[:, None]), axis=-1)
    idx = back_project(geom, pose, cells)               # [H, W]
    beam_ok = idx >= 0
    idx_c = jnp.clip(idx, 0, geom.size - 1)
    # Single encoded table lookup instead of separate data/mask gathers:
    # NaN encodes a masked beam.
    data_enc = jnp.where(mask, data, jnp.nan)
    d = data_enc[idx_c]
    m = ~jnp.isnan(d) & beam_ok

    dist_cell = jnp.linalg.norm(cells - tr, axis=-1)
    finite = ~jnp.isinf(d)
    sd = jnp.where(finite, d - dist_cell, trunc)
    # inf returns only push free space within the low-reflectivity range
    # (TsdGrid.cpp:266-271)
    do_add = m & jnp.where(finite, True,
                           dist_cell < geom.low_reflectivity_range)
    cell_touched = _expand_tiles(grid, touch)

    # addTsd (TsdGridPartition.h:170-212)
    accept = do_add & cell_touched & (sd >= -trunc)
    tsd_new = jnp.minimum(sd / trunc, TSDINC)
    # NOTE: the reference intends a surface-proximity weight boost
    # (w = 1.0 when |sd| < eps) but initializes eps = -cellSize/2
    # (TsdGridPartition.cpp:95), which can never exceed |sd| — so the
    # boost is dead code.  We replicate the effective behavior: w = 0.01.
    eps = jnp.asarray(-grid.cell_size / 2.0, dtype)
    w_meas = jnp.where(jnp.abs(sd) < eps, 1.0, 0.01) \
        * _expand_tiles(grid, part_weight)

    cell_nan = jnp.isnan(tsd0)
    blend_tsd = jnp.where(cell_nan, tsd_new,
                          (tsd0 * w0 + tsd_new * w_meas) / (w0 + w_meas))
    blend_w = jnp.where(cell_nan, w0 + w_meas,
                        jnp.minimum(w0 + w_meas, grid.max_weight))

    tsd1 = jnp.where(accept, blend_tsd, tsd0)
    w1 = jnp.where(accept, blend_w, w0)

    # ---- increaseEmptiness (TsdGridPartition.cpp:136-164) ---------------
    cell_empty_inc = _expand_tiles(grid, empty_inc & grid.tile_init)
    enan = jnp.isnan(tsd1)
    w_emptied = jnp.where(enan, w1 + 1.0,
                          jnp.minimum(w1 + 1.0, grid.max_weight))
    tsd_emptied = jnp.where(enan, TSDINC,
                            (tsd1 * (w_emptied - 1.0) + 1.0) / w_emptied)
    tsd2 = jnp.where(cell_empty_inc, tsd_emptied, tsd1)
    w2 = jnp.where(cell_empty_inc, w_emptied, w1)

    new_initw = jnp.where(
        empty_inc & ~grid.tile_init,
        jnp.minimum(grid.tile_initw + 1.0, grid.max_weight),
        grid.tile_initw)

    return dataclasses.replace(
        grid,
        tsd=tsd2,
        weight=w2,
        tile_init=grid.tile_init | touch,
        tile_initw=new_initw,
    )


def branch_gate(grid: TsdGrid, geom: SensorPolar2D,
                pose: jnp.ndarray) -> jnp.ndarray:
    """Quadtree branch-level range-window culling, vectorized per level.

    Replicates the pushRecursion descent (TsdGrid.cpp:357-370): a leaf is
    tested only if every ancestor branch passes the range-window part of
    TsdGridComponent::isInRange (TsdGridComponent.cpp:46-58; branches
    never run the leaf beam-span test).  Branch geometry follows
    TsdGridBranch (TsdGridBranch.cpp:42-71): centroid = mean of child
    centroids, circumradius doubles per level.

    Returns a [TY, TX] bool mask: leaves whose ancestor chain survives.
    """
    dtype = grid.tsd.dtype
    p = grid.tile_dim
    s = grid.cell_size
    tr = se2.translation(pose).astype(dtype)
    trunc = jnp.asarray(grid.max_truncation, dtype)
    r_leaf = math.sqrt(2.0) * (p * s) * 0.5

    gate = jnp.ones((grid.tiles_y, grid.tiles_x), dtype=bool)
    blk = 2  # tiles per block side at this level (2^level)
    while blk <= grid.tiles_x and blk <= grid.tiles_y \
            and grid.tiles_x % blk == 0 and grid.tiles_y % blk == 0:
        nbx = grid.tiles_x // blk
        nby = grid.tiles_y // blk
        # mean of the block's leaf centroids; leaf centroid of tile j is
        # (j*p + (p+1)/2)*s (TsdGridPartition.cpp:65-70)
        cx = (jnp.arange(nbx, dtype=dtype) * (blk * p)
              + (blk - 1) * p * 0.5 + (p + 1) * 0.5) * s
        cy = (jnp.arange(nby, dtype=dtype) * (blk * p)
              + (blk - 1) * p * 0.5 + (p + 1) * 0.5) * s
        centroid = jnp.stack(
            jnp.broadcast_arrays(cx[None, :], cy[:, None]), axis=-1)
        distance = jnp.linalg.norm(centroid - tr, axis=-1)
        r = blk * r_leaf
        ok = ((distance - r - trunc <= geom.max_range)
              & (distance + r + trunc >= geom.min_range))
        gate = gate & jnp.repeat(jnp.repeat(ok, blk, 0), blk, 1)
        blk *= 2
    return gate


def push_tree(grid: TsdGrid, geom: SensorPolar2D, pose: jnp.ndarray,
              data: jnp.ndarray, mask: jnp.ndarray) -> TsdGrid:
    """TsdGrid::pushTree (TsdGrid.cpp:286-350): quadtree-culled push.

    The recursion prunes whole branches by the range-window test before
    the leaf-level beam-span test; surviving leaves fuse exactly like
    push.  Because the branch test is conservative (a branch window
    contains every child window), the fused result is identical to
    push() — the quadtree only saves work, which here shows up as the
    per-tile cull being gated by the cheap per-level masks.

    Divergence (documented): the reference's pushTree fusion loop skips
    the per-beam measurement-mask check that push applies
    (TsdGrid.cpp:321-341 vs :249-274) — unmaintained older copy of the
    loop.  We keep the mask check, matching push.
    """
    return push(grid, geom, pose, data, mask,
                tile_gate=branch_gate(grid, geom, pose))


push_jit = jax.jit(push, static_argnames=("geom",))
push_tree_jit = jax.jit(push_tree, static_argnames=("geom",))
