"""Butterfly mask compaction vs jnp.nonzero oracle.

The compaction relies on the butterfly-shift argument (each true lane
moves left by the set bits of its own non-decreasing distance without
collisions); these tests exercise random densities, clustered runs, and
the all-true / all-false edges against jnp.nonzero.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.grid.compact import compact_mask, compact_mask_values


@pytest.mark.parametrize("seed,density", [(0, 0.001), (1, 0.02),
                                          (2, 0.3), (3, 0.9)])
def test_compact_matches_nonzero(seed, density):
    rng = np.random.default_rng(seed)
    n = 128 * 64
    m = rng.random(n) < density
    k = 512
    idx, valid = compact_mask(jnp.asarray(m), k)
    want = np.nonzero(m)[0][:k]
    got = np.asarray(idx)[np.asarray(valid)]
    assert int(np.asarray(valid).sum()) == min(len(want), k)
    np.testing.assert_array_equal(got, want)


def test_compact_clustered_runs():
    n = 128 * 32
    m = np.zeros(n, bool)
    m[100:180] = True          # run crossing a chunk boundary
    m[1000:1002] = True
    m[n - 1] = True
    idx, vals, valid = compact_mask_values(
        jnp.asarray(m), jnp.arange(n, dtype=jnp.float32) * 0.5, 4096)
    want = np.nonzero(m)[0]
    got = np.asarray(idx)[np.asarray(valid)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.asarray(vals)[np.asarray(valid)],
                               want * 0.5)


def test_compact_edges():
    n = 128 * 4
    idx, valid = compact_mask(jnp.zeros(n, bool), 64)
    assert not bool(jnp.any(valid))
    idx, valid = compact_mask(jnp.ones(n, bool), 64)
    assert bool(jnp.all(valid))
    np.testing.assert_array_equal(np.asarray(idx), np.arange(64))


def test_compact_overflow_keeps_first_k():
    n = 128 * 8
    m = np.ones(n, bool)
    m[::3] = False
    k = 100
    idx, valid = compact_mask(jnp.asarray(m), k)
    assert bool(jnp.all(valid))
    np.testing.assert_array_equal(np.asarray(idx), np.nonzero(m)[0][:k])


@pytest.mark.parametrize("density", [0.01, 0.2, 0.7])
def test_compact_values_carry_nan_channels(density):
    """NaN value channels ride through the butterfly untouched (the
    segment endpoints of NaN-adjacent quads are NaN before masking) and
    never leak into slots of other entries."""
    rng = np.random.default_rng(int(density * 100))
    n = 128 * 48
    m = rng.random(n) < density
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.3] = np.nan
    idx, vals, valid = compact_mask_values(jnp.asarray(m), jnp.asarray(v),
                                           1024)
    want = np.nonzero(m)[0][:1024]
    ok = np.asarray(valid)
    np.testing.assert_array_equal(np.asarray(idx)[ok], want)
    # assert_array_equal treats NaNs in matching positions as equal
    np.testing.assert_array_equal(np.asarray(vals)[ok], v[want])


def test_compact_multi_channel_matches_nonzero():
    """A tuple of channels (mixed dtypes) compacts through one
    butterfly, each channel equal to indexing by jnp.nonzero."""
    rng = np.random.default_rng(5)
    n = 128 * 20
    m = rng.random(n) < 0.1
    chans = (rng.standard_normal(n).astype(np.float32),
             rng.integers(0, 1000, n).astype(np.int32),
             rng.standard_normal(n))
    idx, vals, valid = compact_mask_values(
        jnp.asarray(m), tuple(jnp.asarray(c) for c in chans), 512)
    want = np.nonzero(m)[0]
    ok = np.asarray(valid)
    assert int(ok.sum()) == len(want)
    np.testing.assert_array_equal(np.asarray(idx)[ok], want)
    for got, c in zip(vals, chans):
        assert got.dtype == c.dtype
        np.testing.assert_array_equal(np.asarray(got)[ok], c[want])
