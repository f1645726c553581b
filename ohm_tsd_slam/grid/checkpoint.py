"""Grid checkpoint / resume.

Equivalent of TsdGrid::storeGrid (src/obvision/reconstruct/grid/
TsdGrid.cpp:548-607) and the deserializing constructor
(TsdGrid.cpp:25-110): offline save/restore of the whole TSD field with
per-tile compression tags UNINITIALIZED(0)/EMPTY(1)/CONTENT(2)
(TsdGrid.h:33-35).

Two codecs:
  * npz  — the native fast path: the grid pytree as compressed numpy
    arrays (one round-trip of device buffers).
  * text — the reference's exact plain-text format (one value per line:
    cellSize, layoutPartition, layoutGrid, maxTruncation, then per-tile
    tag + interleaved tsd/weight cells), so checkpoints interoperate
    with grids stored by the C++ implementation.
"""

from __future__ import annotations

import io
import math
import os
from typing import Union

import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.grid.state import TsdGrid

UNINITIALIZED = 0
EMPTY = 1
CONTENT = 2


# ---------------------------------------------------------------------------
# npz codec
# ---------------------------------------------------------------------------

def save_npz(grid: TsdGrid, path: str) -> None:
    """Write the grid pytree as a compressed npz checkpoint."""
    np.savez_compressed(
        path,
        tsd=np.asarray(grid.tsd),
        weight=np.asarray(grid.weight),
        tile_init=np.asarray(grid.tile_init),
        tile_initw=np.asarray(grid.tile_initw),
        meta=np.array([grid.cell_size, grid.max_truncation,
                       grid.max_weight, float(grid.tile_dim)]),
    )


def load_npz(path: str, dtype=jnp.float32) -> TsdGrid:
    with np.load(path) as z:
        cell_size, max_trunc, max_weight, tile_dim = z["meta"]
        return TsdGrid(
            tsd=jnp.asarray(z["tsd"], dtype),
            weight=jnp.asarray(z["weight"], dtype),
            tile_init=jnp.asarray(z["tile_init"]),
            tile_initw=jnp.asarray(z["tile_initw"], dtype),
            cell_size=float(cell_size),
            max_truncation=float(max_trunc),
            max_weight=float(max_weight),
            tile_dim=int(tile_dim),
        )


# ---------------------------------------------------------------------------
# reference text codec
# ---------------------------------------------------------------------------

def save_text(grid: TsdGrid, path: str) -> None:
    """TsdGrid::storeGrid (TsdGrid.cpp:548-607): one value per line —
    cellSize, layoutPartition (log2 tile dim), layoutGrid (log2 cells
    per side), maxTruncation; then per tile (row-major y outer): tag,
    followed by initWeight (EMPTY) or interleaved tsd/weight cell values
    (CONTENT, row-major within the tile)."""
    tsd = np.asarray(grid.tsd)
    weight = np.asarray(grid.weight)
    init = np.asarray(grid.tile_init)
    initw = np.asarray(grid.tile_initw)
    p = grid.tile_dim
    out = io.StringIO()
    out.write(f"{grid.cell_size}\n{int(math.log2(p))}\n"
              f"{int(math.log2(grid.cells_x))}\n{grid.max_truncation}\n")
    for ty in range(grid.tiles_y):
        for tx in range(grid.tiles_x):
            if init[ty, tx]:
                out.write(f"{CONTENT}\n")
                block = np.stack(
                    [tsd[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p],
                     weight[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p]],
                    axis=-1).reshape(-1)
                out.write("\n".join(repr(float(v)) for v in block))
                out.write("\n")
            elif initw[ty, tx] > 0.0:
                out.write(f"{EMPTY}\n{float(initw[ty, tx])!r}\n")
            else:
                out.write(f"{UNINITIALIZED}\n")
    with open(path, "w") as f:
        f.write(out.getvalue())


def load_text(source: Union[str, io.TextIOBase], dtype=jnp.float32,
              from_string: bool = False,
              max_weight: float = 32.0) -> TsdGrid:
    """The TsdGrid(data, FILE_SOURCE|STRING_SOURCE) constructor
    (TsdGrid.cpp:25-110).  `from_string` mirrors STRING_SOURCE."""
    if isinstance(source, str) and not from_string:
        with open(source) as f:
            tokens = f.read().split()
    elif isinstance(source, str):
        tokens = source.split()
    else:
        tokens = source.read().split()
    it = iter(tokens)

    cell_size = float(next(it))
    layout_partition = int(next(it))
    layout_grid = int(next(it))
    if not (0 <= layout_partition <= 15 and 0 <= layout_grid <= 15):
        raise ValueError("Partition or grid layout invalid")  # TsdGrid.cpp:56-62
    max_trunc = float(next(it))

    p = 2 ** layout_partition
    h = w = 2 ** layout_grid
    tiles = h // p
    tsd = np.full((h, w), np.nan, np.float64)
    weight = np.zeros((h, w), np.float64)
    tile_init = np.zeros((tiles, tiles), bool)
    tile_initw = np.zeros((tiles, tiles), np.float64)

    for ty in range(tiles):
        for tx in range(tiles):
            tag = int(next(it))
            if tag == UNINITIALIZED:
                continue
            if tag == EMPTY:
                # clamped at TSDGRIDMAXWEIGHT on load (TsdGrid.cpp:84-85)
                tile_initw[ty, tx] = min(float(next(it)), max_weight)
            elif tag == CONTENT:
                tile_init[ty, tx] = True
                vals = np.fromiter(
                    (float(next(it)) for _ in range(2 * p * p)),
                    np.float64, 2 * p * p).reshape(p, p, 2)
                tsd[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p] = vals[..., 0]
                weight[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p] = vals[..., 1]
            else:
                raise ValueError(f"Unknown partition identifier {tag}")

    return TsdGrid(
        tsd=jnp.asarray(tsd, dtype),
        weight=jnp.asarray(weight, dtype),
        tile_init=jnp.asarray(tile_init),
        tile_initw=jnp.asarray(tile_initw, dtype),
        cell_size=cell_size,
        max_truncation=max_trunc,
        max_weight=max_weight,
        tile_dim=p,
    )
