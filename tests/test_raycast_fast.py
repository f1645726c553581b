"""Fast (splat+refine) raycast vs the exact dense march."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, interpolate_normal, push, raycast
from ohm_tsd_slam.grid.raycast_fast import raycast_fast
from ohm_tsd_slam.sensor import polar2d
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

CFG = GridConfig(map_size=8, cellsize=0.04)
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)


def _grid_and_geom(poses_xyt):
    geom = polar2d.SensorPolar2D(**GEOM)
    grid = create(CFG, dtype=jnp.float64)
    walls = rect_walls(1.5, 1.5, 8.5, 8.5)
    for pose_xyt in poses_xyt:
        pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
        r = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                          GEOM["phi_min"], GEOM["max_range"],
                          segments=walls,
                          circles=[((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)])
        data, mask = polar2d.standard_mask(geom, jnp.asarray(r))
        grid = push(grid, geom, jnp.asarray(pose), data, mask)
    return grid, geom


def _compare(grid, geom, pose_xyt):
    pose = jnp.asarray(np.array(se2.make(*pose_xyt, dtype=jnp.float64)))
    exact = raycast(grid, geom, pose)
    fast = raycast_fast(grid, geom, pose)

    me = np.array(exact.mask)
    mf = np.array(fast.mask)
    agree = me == mf
    # allow a small fraction of boundary-beam disagreement
    assert agree.mean() > 0.98, (agree.mean(), np.where(~agree)[0][:20])
    both = me & mf
    np.testing.assert_allclose(np.array(fast.coords)[both],
                               np.array(exact.coords)[both],
                               atol=1e-9)
    np.testing.assert_allclose(np.array(fast.normals)[both],
                               np.array(exact.normals)[both], atol=1e-9)
    return both.sum(), (~agree).sum()


def test_fast_matches_exact_same_pose():
    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2)])
    n, bad = _compare(grid, geom, (5.12, 5.12, 0.2))
    assert n > 250


def test_fast_matches_exact_other_pose():
    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2)])
    _compare(grid, geom, (5.3, 4.9, 0.9))
    _compare(grid, geom, (4.5, 5.5, -1.3))


def test_fast_matches_exact_multi_scan_map():
    grid, geom = _grid_and_geom(
        [(5.12, 5.12, 0.2), (5.5, 5.3, 0.6), (4.8, 4.9, -0.4)])
    n, bad = _compare(grid, geom, (5.0, 5.0, 1.2))
    assert n > 250


def test_fast_empty_grid():
    geom = polar2d.SensorPolar2D(**GEOM)
    grid = create(CFG, dtype=jnp.float64)
    pose = jnp.asarray(np.array(se2.make(5.0, 5.0, 0.0,
                                         dtype=jnp.float64)))
    res = raycast_fast(grid, geom, pose)
    assert not bool(np.array(res.mask).any())


def test_overflow_guard_counts_and_falls_back(monkeypatch):
    """MAX_SEGMENTS overflow must be surfaced (n_dropped) and
    raycast_checked must fall back to the exact march (VERDICT r1 #6 —
    no silent caps)."""
    import ohm_tsd_slam.grid.raycast_fast as rf

    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)])
    pose = jnp.asarray(np.array(se2.make(5.12, 5.12, 0.2,
                                         dtype=jnp.float64)))

    full = rf.raycast_fast(grid, geom, pose)
    assert int(full.n_dropped) == 0
    # exact march reports no drops by definition
    assert int(raycast(grid, geom, pose).n_dropped) == 0

    # shrink the capacity below the real segment count
    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    starved = rf.raycast_fast(grid, geom, pose)
    assert int(starved.n_dropped) > 0

    checked = rf.raycast_checked(grid, geom, pose)
    exact = raycast(grid, geom, pose)
    assert int(checked.n_dropped) > 0
    np.testing.assert_array_equal(np.array(checked.mask),
                                  np.array(exact.mask))
    # cond-traced branch may fuse differently than the direct call:
    # allow ULP-level drift
    np.testing.assert_allclose(np.array(checked.coords),
                               np.array(exact.coords), atol=1e-12)


def test_stale_segment_cache_detected_and_falls_back():
    """A SegmentCache extracted from an older grid version must be
    detected by the fingerprint gate: raycast_fast
    surfaces it as n_dropped >= beams, and raycast_checked falls back to
    the exact march of the CURRENT grid."""
    import ohm_tsd_slam.grid.raycast_fast as rf

    grid_old, geom = _grid_and_geom([(5.12, 5.12, 0.2)])
    seg_old = rf.extract_segments(grid_old)
    assert seg_old.fingerprint is not None

    # grid changes (another scan fused) -> old cache is stale
    pose2 = np.array(se2.make(5.3, 5.2, 0.5, dtype=np.float64))
    walls = rect_walls(1.5, 1.5, 8.5, 8.5)
    r2 = simulate_scan(pose2, geom.size, geom.angular_res, geom.phi_min,
                       geom.max_range, segments=walls,
                       circles=[((7.0, 7.2), 0.5)])
    d2, m2 = polar2d.standard_mask(geom, jnp.asarray(r2))
    grid_new = push(grid_old, geom, jnp.asarray(pose2), d2, m2)

    qpose = jnp.asarray(np.array(se2.make(5.0, 5.0, 0.9,
                                          dtype=jnp.float64)))
    stale = rf.raycast_fast(grid_new, geom, qpose, segments=seg_old)
    assert int(stale.n_dropped) >= geom.size

    checked = rf.raycast_checked(grid_new, geom, qpose,
                                 segments=seg_old)
    exact = raycast(grid_new, geom, qpose)
    np.testing.assert_array_equal(np.array(checked.mask),
                                  np.array(exact.mask))
    np.testing.assert_allclose(np.array(checked.coords),
                               np.array(exact.coords), atol=1e-12)

    # a FRESH cache of the new grid stays on the fast path
    seg_new = rf.extract_segments(grid_new)
    fresh = rf.raycast_fast(grid_new, geom, qpose, segments=seg_new)
    assert int(fresh.n_dropped) == 0


def test_raycast_fast_batch_matches_singles():
    """raycast_fast_batch (pose axis folded into the flat beam axis,
    joint tail conds) must reproduce per-pose raycast_fast results."""
    import ohm_tsd_slam.grid.raycast_fast as rf

    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)])
    poses = jnp.stack([
        jnp.asarray(np.array(se2.make(5.0 + 0.02 * i, 5.0 - 0.01 * i,
                                      0.9 + 0.05 * i, dtype=jnp.float64)))
        for i in range(4)])
    batch = rf.raycast_fast_batch(grid, geom, poses)
    assert int(batch.n_dropped) == 0
    for i in range(4):
        single = rf.raycast_fast(grid, geom, poses[i])
        np.testing.assert_array_equal(np.asarray(batch.mask[i]),
                                      np.asarray(single.mask))
        m = np.asarray(single.mask)
        np.testing.assert_allclose(np.asarray(batch.coords[i])[m],
                                   np.asarray(single.coords)[m],
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(batch.normals[i])[m],
                                   np.asarray(single.normals)[m],
                                   atol=1e-9)

    # cached segments path
    seg = rf.extract_segments(grid)
    batch2 = rf.raycast_fast_batch(grid, geom, poses, segments=seg)
    np.testing.assert_array_equal(np.asarray(batch2.mask),
                                  np.asarray(batch.mask))
    np.testing.assert_allclose(np.asarray(batch2.coords),
                               np.asarray(batch.coords), atol=1e-12)


def _np_first_crossings(p0, p1, valid, tr, ray, lo, hi, after):
    """Float64 NumPy reference of _segment_candidates: smallest ray
    parameter t (in steps) with t in [lo, hi], t >= after, at which the
    ray tr + t*ray crosses a valid segment."""
    out = np.full(len(ray), np.inf)
    keep = np.asarray(valid, bool)
    p0, p1 = np.where(keep[:, None], p0, 0.0), np.where(keep[:, None], p1, 1.0)
    e = p1 - p0
    for b in range(len(ray)):
        r = ray[b]
        t_b = tr if tr.ndim == 1 else tr[b]
        denom = r[0] * e[:, 1] - r[1] * e[:, 0]
        d0 = p0 - t_b
        ok = valid & (np.abs(denom) > 1e-12 * np.maximum(
            np.linalg.norm(e, axis=1), 1e-30))
        safe = np.where(ok, denom, 1.0)
        t = (d0[:, 0] * e[:, 1] - d0[:, 1] * e[:, 0]) / safe
        u = -(r[0] * d0[:, 1] - r[1] * d0[:, 0]) / safe
        ok &= (u >= 0) & (u <= 1) & (t >= lo[b]) & (t <= hi[b]) \
            & (t >= after[b])
        if ok.any():
            out[b] = t[ok].min()
    return out


def _candidate_setup(pose_xyt):
    import ohm_tsd_slam.grid.raycast_fast as rf

    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)])
    pose = jnp.asarray(np.array(se2.make(*pose_xyt, dtype=jnp.float64)))
    ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom,
                                                           pose)
    lo = jnp.maximum(jnp.floor(idx_min) - 1.0, 0.0)
    hi = jnp.ceil(idx_max) + 1.0
    p0, p1, sv, nd = rf._isocontour_segments(grid)
    assert int(nd) == 0
    return rf, grid, geom, (p0, p1, sv), (ray, tr, lo, hi)


@pytest.mark.parametrize("pose_xyt", [(5.12, 5.12, 0.2), (4.6, 5.4, -1.1)])
def test_segment_candidate_levels_match_sequential_reference(pose_xyt):
    """The rounds' candidate chain (level k = earliest intersection at
    or beyond level k-1 + cover) against a float64 NumPy reference."""
    rf, grid, geom, (p0, p1, sv), (ray, tr, lo, hi) = \
        _candidate_setup(pose_xyt)
    cover = rf.WINDOW - rf.BACKOFF - 2.0
    bound = lo
    n_finite = []
    for _ in range(rf.ROUNDS):
        got = np.asarray(rf._segment_candidates(p0, p1, sv, tr, ray, lo,
                                                hi, bound))
        want = _np_first_crossings(*map(np.asarray, (p0, p1, sv, tr, ray,
                                                     lo, hi, bound)))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)
        n_finite.append(int(fin.sum()))
        bound = jnp.where(jnp.isfinite(got), got + cover, jnp.inf)
    assert n_finite[0] > 0.5 * geom.size


def test_segment_candidates_ignore_invalid_tail():
    """Slots past the real segment count (valid=False) contribute
    nothing: truncating the arrays gives the same candidates, and an
    all-invalid list gives none."""
    rf, grid, geom, (p0, p1, sv), (ray, tr, lo, hi) = \
        _candidate_setup((5.12, 5.12, 0.2))
    n = int(sv.sum())
    assert bool(sv[:n].all()) and not bool(sv[n:].any())
    full = rf._segment_candidates(p0, p1, sv, tr, ray, lo, hi, lo)
    # garbage coordinates in the invalid tail must not matter
    tail = rf._segment_candidates(jnp.where(sv[:, None], p0, 5.0),
                                  jnp.where(sv[:, None], p1, 5.3), sv, tr,
                                  ray, lo, hi, lo)
    cut = rf._segment_candidates(p0[:n], p1[:n], sv[:n], tr, ray, lo, hi,
                                 lo)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(cut))
    fin = np.isfinite(np.asarray(full))
    assert fin.sum() > 0.9 * geom.size
    np.testing.assert_array_equal(np.asarray(tail), np.asarray(full))
    none = rf._segment_candidates(p0, p1, jnp.zeros_like(sv), tr, ray, lo,
                                  hi, lo)
    assert not np.isfinite(np.asarray(none)).any()


@pytest.mark.parametrize("n_poses", [2, 3])
def test_segment_candidates_per_beam_rows_match_per_pose(n_poses):
    """Per-beam sensor rows [N, 2] (poses folded into the beam axis)
    give the same candidates as one call per pose with tr [2]."""
    import ohm_tsd_slam.grid.raycast_fast as rf

    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2)])
    p0, p1, sv, _ = rf._isocontour_segments(grid)
    rays, trs, los, his, singles = [], [], [], [], []
    for i in range(n_poses):
        pose = jnp.asarray(np.array(se2.make(5.0 + 0.1 * i, 5.1 - 0.05 * i,
                                             0.3 * i, dtype=jnp.float64)))
        ray, tr, idx_min, idx_max, _ = rf.beam_geometry(grid, geom, pose)
        lo = jnp.maximum(jnp.floor(idx_min) - 1.0, 0.0)
        hi = jnp.ceil(idx_max) + 1.0
        singles.append(np.asarray(rf._segment_candidates(
            p0, p1, sv, tr, ray, lo, hi, lo)))
        rays.append(ray)
        trs.append(jnp.broadcast_to(tr, ray.shape))
        los.append(lo)
        his.append(hi)
    lo_f = jnp.concatenate(los)
    folded = np.asarray(rf._segment_candidates(
        p0, p1, sv, jnp.concatenate(trs), jnp.concatenate(rays), lo_f,
        jnp.concatenate(his), lo_f)).reshape(n_poses, -1)
    for i in range(n_poses):
        np.testing.assert_array_equal(np.isfinite(folded[i]),
                                      np.isfinite(singles[i]))
        fin = np.isfinite(singles[i])
        np.testing.assert_allclose(folded[i][fin], singles[i][fin],
                                   rtol=1e-9)


def test_window_events_match_exact_march():
    """The window replay seeded at the round-1 candidates finds the same
    hits, at the same world coordinates, as the exact dense march."""
    rf, grid, geom, (p0, p1, sv), (ray, tr, lo, hi) = \
        _candidate_setup((5.12, 5.12, 0.2))
    pose = jnp.asarray(np.array(se2.make(5.12, 5.12, 0.2,
                                         dtype=jnp.float64)))
    _, _, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom, pose)
    t_1 = rf._segment_candidates(p0, p1, sv, tr, ray, lo, hi, lo)
    has = jnp.isfinite(t_1) & feasible
    hit, any_ev, pos_ev, interp = rf._window_events(
        grid, tr, ray, idx_min, idx_max, jnp.where(has, t_1, 0.0), has)
    coords_w = pos_ev + ray * (interp[:, None] - 1.0)
    _, n_ok = interpolate_normal(grid, coords_w)
    coords_w = np.asarray(coords_w)
    exact = raycast(grid, geom, pose)
    me = np.asarray(exact.mask)
    h = np.asarray(hit & n_ok & feasible)
    # beams whose first window saw no sign change are the later rounds'
    # business; every beam the window resolved agrees with the march
    resolved = np.asarray(any_ev)
    assert resolved.mean() > 0.9
    assert ((h == me) | ~resolved).mean() > 0.99
    both = h & me
    assert both.sum() > 250
    exact_w = np.asarray(se2.transform_points(pose, exact.coords))
    np.testing.assert_allclose(coords_w[both], exact_w[both], atol=1e-9)


def test_segment_layers_match_quad_segments():
    """The dense layer stack is the per-quad marching-squares geometry:
    layer 0 = two-crossing or saddle quads with segment 1's endpoints,
    layer 1 = saddle quads with segment 2's endpoints."""
    import ohm_tsd_slam.grid.raycast_fast as rf

    grid, geom = _grid_and_geom([(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)])
    mask, chans = rf._segment_layers(grid)
    tsd = grid.tsd
    H, W = tsd.shape
    qx = jnp.arange(W - 1, dtype=tsd.dtype)[None, :]
    qy = jnp.arange(H - 1, dtype=tsd.dtype)[:, None]
    q = rf._quad_segments(tsd[:-1, :-1], tsd[:-1, 1:], tsd[1:, 1:],
                          tsd[1:, :-1], qx, qy, grid.cell_size)
    m = np.asarray(mask).reshape(4, H, W)[:, :H - 1, :W - 1]
    c = [np.asarray(ch).reshape(4, H, W)[:, :H - 1, :W - 1]
         for ch in chans]
    l0 = np.asarray(q["two"] | q["four"])
    l1 = np.asarray(q["four"])
    np.testing.assert_array_equal(m[0], l0)
    np.testing.assert_array_equal(m[1], l1)
    assert l0.sum() > 100 and m[2:].sum() >= 0
    for ch, key in zip(c, ("s1_p0x", "s1_p0y", "s1_p1x", "s1_p1y")):
        np.testing.assert_array_equal(ch[0][l0], np.asarray(q[key])[l0])
    for ch, key in zip(c, ("s2_p0x", "s2_p0y", "s2_p1x", "s2_p1y")):
        np.testing.assert_array_equal(ch[1][l1], np.asarray(
            jnp.broadcast_to(q[key], l1.shape))[l1])
