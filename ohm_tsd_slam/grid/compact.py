"""Scatter-free mask compaction.

Compacts a boolean mask into the first-K true indices, like
``jnp.nonzero(mask, size=K)`` but without its full-length scatter, using
only dense vector ops and O(K) gathers:

  1. reshape the flat mask into [C, 128] chunks;
  2. per-chunk **butterfly compaction**: every true element must move
     left by ``dist = #falses strictly before it``, which is
     non-decreasing along the row, so moving each element left by the
     set bits of its own distance (7 masked lane-rolls, LSB->MSB) can
     never collide — O(log 128) dense passes instead of the O(log^2)
     bitonic stages of ``argsort``;
  3. exclusive-scan the per-chunk counts (tiny, length C);
  4. output slot j maps to chunk c via a run-length decode (scatter of
     C chunk starts + cumsum) and rank r = j - offsets[c]; its column
     is cols[c, r] — one O(K) gather.

A value channel can ride along through the butterfly
(:func:`compact_mask_values`) so callers avoid a second full-size
gather against the original array.

The result is ordered by flat index, matching jnp.nonzero.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

CHUNK = 128
_BITS = 7  # log2(CHUNK)


def _shift_left(x: jnp.ndarray, step: int) -> jnp.ndarray:
    """Shift lanes left by `step` along axis 1 (wraparound garbage kept;
    callers mask it via the shifted validity channel)."""
    return jnp.roll(x, -step, axis=1)


def _butterfly(m2: jnp.ndarray, channels):
    """Compact true lanes of each row to the front, carrying channels.

    Returns (front_valid [C, 128] bool, compacted channels).  Valid lanes
    of row c are exactly the first counts[c] columns.
    """
    c_chunks = m2.shape[0]
    col = jnp.broadcast_to(
        jnp.arange(CHUNK, dtype=jnp.int32)[None, :], (c_chunks, CHUNK))
    # falses strictly before each column
    dist = jnp.cumsum((~m2).astype(jnp.int32), axis=1) - (~m2)
    valid = m2
    chans = list(channels)
    for b in range(_BITS):
        step = 1 << b
        src = valid & ((dist & step) != 0)
        inc = _shift_left(src, step)
        # no incoming from wraparound
        inc = inc & (col < CHUNK - step)
        valid = (valid & ~src) | inc
        dist = jnp.where(inc, _shift_left(dist, step), dist)
        chans = [jnp.where(inc, _shift_left(ch, step), ch) for ch in chans]
    return valid, chans


def _assemble(counts: jnp.ndarray, size: int):
    """Map output slot j -> (owning chunk c, rank r) via run-length decode."""
    c_chunks = counts.shape[0]
    offsets = jnp.cumsum(counts) - counts                 # exclusive
    total = offsets[-1] + counts[-1]

    j = jnp.arange(size, dtype=jnp.int32)
    valid = j < total

    # Slot -> owning chunk, without a per-slot binary search (searchsorted
    # costs ~14 gather rounds = ~3 ms here): run-length decode.  Scatter a
    # 1 at each nonempty chunk's start offset (O(C) scatter, C << n),
    # cumsum to get each slot's rank among nonempty chunks, and look the
    # chunk id up in the compacted nonempty-chunk list.
    nz = counts > 0
    starts = jnp.clip(offsets, 0, size)                   # [C]
    mark = jnp.zeros((size + 1,), jnp.int32).at[starts].add(
        nz.astype(jnp.int32), mode="drop")
    rank = jnp.cumsum(mark[:size]) - 1                    # [K]
    ids = jnp.nonzero(nz, size=c_chunks, fill_value=0)[0].astype(jnp.int32)
    c = ids[jnp.clip(rank, 0, c_chunks - 1)]
    r = jnp.clip(j - offsets[c], 0, CHUNK - 1)
    return c, r, valid


def compact_mask_values(mask: jnp.ndarray, values, size: int):
    """First-`size` true entries of a flat boolean mask, with values.

    Args:
      mask: 1D bool array; length must be a multiple of 128.
      values: optional 1D array like mask — compacted alongside — or a
        tuple/list of such arrays (all compacted through one butterfly).
      size: static output length K.
    Returns:
      (idx [K] int32 flat indices, ascending; 0 in invalid slots),
      (vals [K], tuple of [K], or None — matching the input shape),
      (valid [K] bool).
    """
    n = mask.shape[0]
    assert n % CHUNK == 0, n
    m2 = mask.reshape(-1, CHUNK)                          # [C, 128]

    multi = isinstance(values, (tuple, list))
    value_list = list(values) if multi else (
        [] if values is None else [values])

    col = jnp.broadcast_to(
        jnp.arange(CHUNK, dtype=jnp.int32)[None, :], m2.shape)
    chans = [col] + [v.reshape(m2.shape) for v in value_list]
    _, chans = _butterfly(m2, chans)
    cols = chans[0]

    counts = jnp.sum(m2, axis=1, dtype=jnp.int32)         # [C]
    c, r, valid = _assemble(counts, size)

    idx = c * CHUNK + cols[c, r].astype(jnp.int32)
    out_vals = [ch[c, r] for ch in chans[1:]]
    if multi:
        vals = tuple(out_vals)
    else:
        vals = out_vals[0] if out_vals else None
    return jnp.where(valid, idx, 0), vals, valid


def compact_mask(mask: jnp.ndarray, size: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """First-`size` indices of True entries of a flat boolean mask.

    Returns (idx [K] int32, ascending; 0 in invalid slots), (valid [K]).
    """
    idx, _, valid = compact_mask_values(mask, None, size)
    return idx, valid
