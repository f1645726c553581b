"""Fast raycast: marching-squares isocontour + ray-segment intersection
+ exact window replay.

The dense [beams x steps] march of grid/raycast.py gathers bilinear taps
at every step of every beam.  This caster reformulates the search so the
heavy work runs on dense element-wise ops and two small matmuls, leaving
only O(beams x window) gathers:

  1. isocontour extraction: a vectorized marching-squares pass over the
     cell-center grid turns the TSD zero level set into line segments —
     sign patterns, edge-crossing interpolation and the saddle-point
     decider for the ambiguous (4-crossing) case are all dense
     element-wise ops over [H-1, W-1] quads.  Quads with a NaN corner
     emit nothing (bilinear interpolation there returns ISNAN, so the
     exact march can never produce an event inside them);
  2. butterfly compaction of the segments to a fixed-size list
     (grid/compact.py; endpoint coordinates ride along as value
     channels);
  3. per-beam candidates from EXACT ray-segment intersection: with
     per-segment precomputations, `t = c0[s] / denom[s,b]` and
     `u = c1[s,b] / denom[s,b]` where denom and c1 are [S,2] @ [2,B]
     matmuls.  A beam gets a candidate only where it truly
     crosses the level set — grazing surfaces that approach the beam
     without crossing produce no candidates (the failure mode of
     angular-band / corridor splats);
  4. each candidate seeds a window where the EXACT march of
     RayCastPolar2D.cpp:237-270 (bilinear taps at idx_min + integer
     steps, +to- hit, -to+ back-face reject, NaN skip) is replayed; the
     first window's event decides, a second window at the next
     intersection covers double-crossings inside one step (the march
     sees no sign change there and must continue).

Model points agree with the exact march beam-for-beam on the golden
scenario (asserted against the compiled C++ reference in
tests/test_reference_parity.py); residual disagreement is confined to
knife-edge tangencies where the linearized isocontour and the sampled
march disagree about grazing contact.

Overflow: segments beyond MAX_SEGMENTS are dropped by the compaction;
the count is exposed as RaycastResult.n_dropped and `raycast_checked`
falls back to the exact march when it is nonzero (no silent caps).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.compact import compact_mask, compact_mask_values
from ohm_tsd_slam.grid.interpolate import (
    INTERPOLATE_SUCCESS,
    interpolate_bilinear,
    interpolate_normal,
)
from ohm_tsd_slam.grid.raycast import RaycastResult
from ohm_tsd_slam.grid.state import TsdGrid
from ohm_tsd_slam.sensor.polar2d import SensorPolar2D

# max isocontour segments kept; segments beyond this are dropped AND
# counted (n_dropped; a 1024^2 map of corridors has ~10-30k segments)
MAX_SEGMENTS = 32768
WINDOW = 8           # refine samples per candidate window
BACKOFF = 2.0        # window starts this many steps before the candidate
# backward-compat alias (overflow capacity)
MAX_CROSSINGS = MAX_SEGMENTS
# candidate/replay rounds (see raycast_fast docstring)
ROUNDS = 4


def _isocontour_segments(grid: TsdGrid, max_segments: int = None):
    """Marching squares over cell-center quads -> compacted segments.

    Returns (p0 [S,2], p1 [S,2], valid [S], n_dropped) in world meters,
    S = max_segments (overflow is counted, never silent).
    """
    if max_segments is None:
        max_segments = MAX_SEGMENTS   # resolved at call time (patchable)

    mask, chans = _segment_layers(grid)
    n_total = jnp.sum(mask, dtype=jnp.int32)
    n_dropped = jnp.maximum(n_total - max_segments, 0)
    _, vals, valid = compact_mask_values(mask, chans, max_segments)
    p0 = jnp.stack([vals[0], vals[1]], axis=-1)
    p1 = jnp.stack([vals[2], vals[3]], axis=-1)
    return p0, p1, valid, n_dropped


def _ms_crossing(a, b):
    """Marching-squares edge-crossing predicate (shared helper)."""
    return ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))


def _ms_frac(a, b):
    return a / (a - b)


def _quad_segments(v00, v01, v11, v10, qx, qy, s):
    """Per-quad marching-squares endpoint formulas: crossings, edge
    interpolation, first/last crossed edge and the saddle decider.

    Corners: v00=(y,x), v01=(y,x+1), v11=(y+1,x+1), v10=(y+1,x);
    qx/qy broadcastable quad indices (float).  Returns a dict with the
    per-layer endpoints + masks.
    """
    quad_ok = ~(jnp.isnan(v00) | jnp.isnan(v01)
                | jnp.isnan(v11) | jnp.isnan(v10))

    # edges: bottom (v00-v01), right (v01-v11), top (v10-v11),
    # left (v00-v10); crossing points in world coords
    cb = _ms_crossing(v00, v01)
    cr = _ms_crossing(v01, v11)
    ct = _ms_crossing(v10, v11)
    cl = _ms_crossing(v00, v10)

    Bx = (qx + 0.5 + _ms_frac(v00, v01)) * s
    By = jnp.broadcast_to((qy + 0.5) * s, Bx.shape)
    Rx = jnp.broadcast_to((qx + 1.5) * s, Bx.shape)
    Ry = (qy + 0.5 + _ms_frac(v01, v11)) * s
    Tx = (qx + 0.5 + _ms_frac(v10, v11)) * s
    Ty = jnp.broadcast_to((qy + 1.5) * s, Bx.shape)
    Lx = jnp.broadcast_to((qx + 0.5) * s, Bx.shape)
    Ly = (qy + 0.5 + _ms_frac(v00, v10)) * s
    Px = [Bx, Rx, Tx, Lx]
    Py = [By, Ry, Ty, Ly]

    F = [cb & quad_ok, cr & quad_ok, ct & quad_ok, cl & quad_ok]
    n_crossed = sum(f.astype(jnp.int32) for f in F)

    # two-crossing quads: the segment joins the first and last crossed
    # edge in B,R,T,L order (unique for n == 2)
    first = jnp.where(F[0], 0, jnp.where(F[1], 1,
            jnp.where(F[2], 2, jnp.where(F[3], 3, 0))))
    last = jnp.where(F[3], 3, jnp.where(F[2], 2,
           jnp.where(F[1], 1, jnp.where(F[0], 0, 3))))

    def pick(P, idx):
        # dense 4-way select
        out = P[0]
        for k in (1, 2, 3):
            out = jnp.where(idx == k, P[k], out)
        return out

    two = quad_ok & (n_crossed == 2)
    four = quad_ok & (n_crossed == 4)

    # saddle decider for the ambiguous case: the bilinear saddle value
    # (v00*v11 - v01*v10)/(v00 + v11 - v01 - v10) decides connectivity —
    # exact topology of a bilinear field.  saddle sign == sign(v00):
    # the v01/v10 corners are isolated -> segments (B,R) and (T,L);
    # otherwise v00/v11 are isolated -> (B,L) and (T,R).
    den = v00 + v11 - v01 - v10
    saddle = jnp.where(jnp.abs(den) > 0, (v00 * v11 - v01 * v10)
                       / jnp.where(den == 0, 1.0, den), 0.0)
    same00 = (saddle > 0) == (v00 > 0)

    # segment 1: two-crossing join, or (B, R or L) for saddle quads
    s1_p0x = jnp.where(four, Px[0], pick(Px, first))
    s1_p0y = jnp.where(four, Py[0], pick(Py, first))
    s1_p1x = jnp.where(four, jnp.where(same00, Px[1], Px[3]),
                       pick(Px, last))
    s1_p1y = jnp.where(four, jnp.where(same00, Py[1], Py[3]),
                       pick(Py, last))

    # segment 2 only on saddle quads: (T, L or R)
    s2_p1x = jnp.where(same00, Px[3], Px[1])
    s2_p1y = jnp.where(same00, Py[3], Py[1])

    return dict(quad_ok=quad_ok, two=two, four=four, Px=Px, Py=Py,
                s1_p0x=s1_p0x, s1_p0y=s1_p0y, s1_p1x=s1_p1x,
                s1_p1y=s1_p1y, s2_p0x=Px[2], s2_p0y=Py[2],
                s2_p1x=s2_p1x, s2_p1y=s2_p1y)


def _segment_layers(grid: TsdGrid):
    """Dense marching-squares + virtual-segment layers.

    Returns (mask [4*H*W] bool, (p0x, p0y, p1x, p1y) flat channels).
    """
    s = grid.cell_size
    tsd = grid.tsd
    H, W = tsd.shape
    dtype = tsd.dtype

    v00 = tsd[:-1, :-1]          # corner (y,   x)
    v01 = tsd[:-1, 1:]           # corner (y,   x+1)
    v11 = tsd[1:, 1:]            # corner (y+1, x+1)
    v10 = tsd[1:, :-1]           # corner (y+1, x)

    qx = jnp.arange(W - 1, dtype=dtype)[None, :]
    qy = jnp.arange(H - 1, dtype=dtype)[:, None]
    q = _quad_segments(v00, v01, v11, v10, qx, qy, s)
    quad_ok = q["quad_ok"]

    def crossing(a, b):
        return _ms_crossing(a, b)

    def frac(a, b):
        return _ms_frac(a, b)

    s1_p0x, s1_p0y = q["s1_p0x"], q["s1_p0y"]
    s1_p1x, s1_p1y = q["s1_p1x"], q["s1_p1y"]
    s1_mask = q["two"] | q["four"]
    s2_p0x, s2_p0y = q["s2_p0x"], q["s2_p0y"]
    s2_p1x, s2_p1y = q["s2_p1x"], q["s2_p1y"]
    s2_mask = q["four"]

    # --- virtual segments for NaN-adjacent crossings ---------------------
    # A crossed edge both of whose adjacent quads have a NaN corner (the
    # thin unseen side of a wall) belongs to no marching-squares segment,
    # yet the exact march can still see a sign change across it (its
    # samples only need their OWN 4-tap stencils valid).  Emit a short
    # segment through the crossing point, transverse to the cell pair —
    # the level set crosses the edge, so locally it runs roughly
    # perpendicular to it; the exact window replay resolves the rest.
    clean = s1_mask                                       # [Hq, Wq]
    VIRT = 0.9 * s

    # h-edge (y, x): bottom edge of quad (y, x), top edge of quad (y-1, x)
    ev_h_full = crossing(tsd[:, :-1], tsd[:, 1:])          # [H, W-1]
    clean_h = jnp.pad(clean, ((0, 1), (0, 0)))             # quad (y, x)
    clean_h_up = jnp.pad(clean, ((1, 0), (0, 0)))          # quad (y-1, x)
    virt_h = ev_h_full & ~(clean_h | clean_h_up)
    fh = frac(tsd[:, :-1], tsd[:, 1:])
    hx = (jnp.arange(W - 1, dtype=dtype)[None, :] + 0.5 + fh) * s
    hy = jnp.broadcast_to(
        (jnp.arange(H, dtype=dtype)[:, None] + 0.5) * s, hx.shape)
    vh_p0x, vh_p0y = hx, hy - VIRT
    vh_p1x, vh_p1y = hx, hy + VIRT

    # v-edge (y, x): left edge of quad (y, x), right edge of quad (y, x-1)
    ev_v_full = crossing(tsd[:-1, :], tsd[1:, :])          # [H-1, W]
    clean_v = jnp.pad(clean, ((0, 0), (0, 1)))
    clean_v_left = jnp.pad(clean, ((0, 0), (1, 0)))
    virt_v = ev_v_full & ~(clean_v | clean_v_left)
    fv = frac(tsd[:-1, :], tsd[1:, :])
    vy = (jnp.arange(H - 1, dtype=dtype)[:, None] + 0.5 + fv) * s
    vx = jnp.broadcast_to(
        (jnp.arange(W, dtype=dtype)[None, :] + 0.5) * s, vy.shape)
    vv_p0x, vv_p0y = vx - VIRT, vy
    vv_p1x, vv_p1y = vx + VIRT, vy

    # pad all layers back to [H, W] so one compaction covers them
    def pad(a):
        return jnp.pad(a, ((0, H - a.shape[0]), (0, W - a.shape[1])))

    mask = jnp.stack([pad(s1_mask), pad(s2_mask),
                      pad(virt_h), pad(virt_v)]).reshape(-1)
    chans = tuple(
        jnp.stack([pad(a), pad(b), pad(c), pad(d)]).reshape(-1)
        for a, b, c, d in ((s1_p0x, s2_p0x, vh_p0x, vv_p0x),
                           (s1_p0y, s2_p0y, vh_p0y, vv_p0y),
                           (s1_p1x, s2_p1x, vh_p1x, vv_p1x),
                           (s1_p1y, s2_p1y, vh_p1y, vv_p1y)))
    return mask, chans


class SegmentCache(NamedTuple):
    """Pose-independent isocontour extraction of one grid version.

    The marching-squares pass + compaction depend
    only on the TSD field, not the sensor pose — in the live SLAM loop
    the grid changes only when the mapper fuses a significantly-moved
    scan (ThreadLocalize.cpp:402,728-736), while the localizer raycasts
    EVERY scan (ThreadLocalize.cpp:353).  Extracting once per grid
    version and reusing the cache across scans moves ~2/3 of the
    raycast's per-scan cost into the (much rarer) map-update stage.

    Build with extract_segments(grid); pass to raycast_fast/
    raycast_checked/localize_step via their `segments` argument.  The
    cache is only valid for the exact grid it was extracted from —
    callers own the invalidation (slam.node rebuilds it after each
    mapper drain).
    """

    p0: jnp.ndarray          # [S, 2] world endpoints
    p1: jnp.ndarray          # [S, 2]
    valid: jnp.ndarray       # [S] bool
    n_dropped: jnp.ndarray   # i32 — segments lost to capacity limits
    # integer checksum of the source grid's tsd bits:
    # raycast_fast compares it against the grid it is given and treats a
    # MISMATCH (stale cache — the grid changed since extraction) as a
    # full overflow, so raycast_checked falls back to the exact march
    # instead of silently marching against outdated segments.  Wraparound
    # integer summation is reduction-order-independent, so the compare is
    # exact across differently-compiled programs.
    fingerprint: Optional[jnp.ndarray] = None


def grid_fingerprint(tsd: jnp.ndarray) -> jnp.ndarray:
    """Order-independent integer checksum of the TSD bit pattern.

    Always reinterprets at 32-bit granularity (f64 bitcasts to an extra
    trailing [2] axis); wraparound i32 summation is
    reduction-order-independent."""
    bits = jax.lax.bitcast_convert_type(tsd, jnp.int32)
    return jnp.sum(bits, dtype=jnp.int32)


def extract_segments(grid: TsdGrid,
                     max_segments: int = None) -> SegmentCache:
    """Run the pose-independent extraction stage once for this grid
    version (see SegmentCache)."""
    p0, p1, svalid, n_dropped = _isocontour_segments(grid, max_segments)
    return SegmentCache(p0, p1, svalid, n_dropped,
                        grid_fingerprint(grid.tsd))


extract_segments_jit = jax.jit(extract_segments,
                               static_argnames=("max_segments",))


def _segment_candidates(p0, p1, svalid, tr, ray, lo, hi, t_after):
    """Earliest ray-segment intersection per beam with t >= t_after.

    p0/p1: [S,2] segment endpoints (world m); ray: [B,2] step vector
    (unit direction * cell size); lo/hi/t_after: [B] clip range in steps.
    `tr` is the sensor translation — [2] (one pose; original numerics)
    or per-beam rows [B,2] (pose-batched flat core: the cross products
    with tr decompose per beam).
    Returns t1 [B] in steps (inf = none).

    Intersection of tr + t*ray with p0 + u*(p1-p0):
      denom[s,b] = cross(ray[b], e[s])   (one [S,2] @ [2,B] matmul)
      c1[s,b]    = cross(ray[b], d0[s])  (one [S,2] @ [2,B] matmul)
      c0[s]      = cross(d0[s], e[s])    (per-segment scalar)
      t = c0 / denom,  u = -c1 / denom;  hit iff u in [0,1], t in [lo,hi].
    """
    dtype = p0.dtype
    e = p1 - p0                                           # [S, 2]
    # cross(a, b) = ax*by - ay*bx, as outer products over (s, b)
    rot = jnp.stack([-ray[:, 1], ray[:, 0]], axis=0)      # [2, B]
    denom = e @ rot                                       # cross(ray, e)
    if tr.ndim == 1:
        d0 = p0 - tr                                      # [S, 2]
        c1 = d0 @ rot                                     # cross(ray, d0)
        c0 = (d0[:, 0] * e[:, 1] - d0[:, 1] * e[:, 0])[:, None]
    else:
        # per-beam tr: cross(ray, p0 - tr) = cross(ray, p0)
        # - cross(ray, tr); cross(p0 - tr, e) = cross(p0, e)
        # - cross(tr, e)
        c1tr = ray[:, 0] * tr[:, 1] - ray[:, 1] * tr[:, 0]   # [B]
        c1 = p0 @ rot - c1tr[None, :]
        c0p = p0[:, 0] * e[:, 1] - p0[:, 1] * e[:, 0]        # [S]
        c0 = (c0p[:, None]
              - (tr[:, 0][None, :] * e[:, 1][:, None]
                 - tr[:, 1][None, :] * e[:, 0][:, None]))

    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
    ok_denom = jnp.abs(denom) > eps * jnp.maximum(
        jnp.linalg.norm(e, axis=1), 1e-30)[:, None]
    safe = jnp.where(ok_denom, denom, 1.0)
    t = c0 / safe
    # u = (d0 x ray)/(ray x e) = -c1/denom
    u = -c1 / safe
    ok = (svalid[:, None] & ok_denom & (u >= 0.0) & (u <= 1.0)
          & (t >= lo[None, :]) & (t <= hi[None, :])
          & (t >= t_after[None, :]))
    big = jnp.asarray(jnp.inf, dtype)
    return jnp.min(jnp.where(ok, t, big), axis=0)


def _window_events(grid, tr, ray, idx_min, idx_max, k_cand, has_cand):
    """Replay the exact march (RayCastPolar2D.cpp:237-270) over a
    WINDOW-step window starting BACKOFF steps before the candidate.

    `tr` is [2] (one pose) or per-beam rows [B,2] (flat pose batch).
    Returns (hit, any_ev, pos_ev [B,2], interp [B]).
    """
    dtype = ray.dtype
    m_start = jnp.maximum(jnp.floor(k_cand - idx_min) - BACKOFF, 0.0)
    j = jnp.arange(WINDOW, dtype=dtype)
    t_w = idx_min[:, None] + m_start[:, None] + j[None, :]   # [B, W]
    tr_b = tr if tr.ndim == 1 else tr[:, None, :]
    pos = tr_b + t_w[..., None] * ray[:, None, :]
    tsd_w, code_w = interpolate_bilinear(grid, pos)
    v = jnp.where(code_w == INTERPOLATE_SUCCESS, tsd_w, jnp.nan)

    # loop condition i <= idx_max with i = t - 1 (see raycast.py)
    sample_ok = (t_w[:, 1:] - 1.0) <= idx_max[:, None]
    v_prev = v[:, :-1]
    v_cur = v[:, 1:]
    ev_pos = (v_prev > 0) & (v_cur < 0) & sample_ok
    ev_neg = (v_prev < 0) & (v_cur > 0) & sample_ok
    ev = ev_pos | ev_neg
    any_ev = jnp.any(ev, axis=1) & has_cand
    k_ev = jnp.argmax(ev, axis=1)
    hit = any_ev & jnp.take_along_axis(ev_pos, k_ev[:, None], 1)[:, 0]

    vp = jnp.take_along_axis(v_prev, k_ev[:, None], 1)[:, 0]
    vc = jnp.take_along_axis(v_cur, k_ev[:, None], 1)[:, 0]
    interp = vp / (vp - vc)
    pos_ev = jnp.take_along_axis(pos[:, 1:, :], k_ev[:, None, None], 1)[:, 0]
    return hit, any_ev, pos_ev, interp


def beam_geometry(grid: TsdGrid, geom: SensorPolar2D, pose: jnp.ndarray):
    """World-frame beam step vectors + per-beam march clip range.

    Returns (ray [B,2], tr [2], idx_min [B], idx_max [B], feasible [B]);
    the clipping is identical to grid/raycast.py (slab clip to the grid
    AABB + min/max range, RayCastPolar2D.cpp:205-219)."""
    dtype = grid.tsd.dtype
    s = grid.cell_size
    rays_local = geom.rays_local(dtype)
    rays_world = se2.rotate_vectors(pose.astype(dtype), rays_local)
    ray = rays_world * s
    tr = se2.translation(pose).astype(dtype)

    inside = grid.is_inside(tr)
    big = jnp.asarray(10e9, dtype)
    def_min = jnp.where(inside, -big, big)
    def_max = jnp.where(inside, big, -big)
    xdim = (grid.cells_x - 1) * s
    ydim = (grid.cells_y - 1) * s
    rx, ry = ray[:, 0], ray[:, 1]
    use_x = jnp.abs(rx) > 10e-6
    use_y = jnp.abs(ry) > 10e-6
    xmin = jnp.where(use_x, (jnp.where(rx > 0.0, 0.0, xdim) - tr[0]) / rx, def_min)
    ymin = jnp.where(use_y, (jnp.where(ry > 0.0, 0.0, ydim) - tr[1]) / ry, def_min)
    xmax = jnp.where(use_x, (jnp.where(rx > 0.0, xdim, 0.0) - tr[0]) / rx, def_max)
    ymax = jnp.where(use_y, (jnp.where(ry > 0.0, ydim, 0.0) - tr[1]) / ry, def_max)
    idx_min = jnp.maximum(jnp.maximum(xmin, ymin), 0.0)
    idx_min = jnp.maximum(idx_min, geom.min_range / s)
    idx_max = jnp.minimum(jnp.minimum(xmax, ymax), geom.max_range / s)
    feasible = idx_min < idx_max
    return ray, tr, idx_min, idx_max, feasible


def raycast_fast(grid: TsdGrid, geom: SensorPolar2D,
                 pose: jnp.ndarray,
                 segments: Optional[SegmentCache] = None,
                 max_segments: int = None) -> RaycastResult:
    """Splat+refine raycast.  `segments` — an extract_segments() cache
    for THIS grid version — skips the per-scan isocontour extraction
    (the pose-independent 2/3 of the cost); without it the extraction
    runs inline (identical results either way, asserted in tests)."""
    ray, tr, idx_min, idx_max, feasible = beam_geometry(grid, geom, pose)
    coords_w, normals_w, hit, n_ok, n_dropped = _raycast_core(
        grid, segments, max_segments, ray, tr, idx_min, idx_max,
        feasible)
    mask = feasible & hit & n_ok
    dtype = grid.tsd.dtype
    Tinv = se2.invert(pose.astype(dtype))
    coords_s = se2.transform_points(Tinv, coords_w)
    normals_s = se2.rotate_vectors(Tinv, normals_w)
    zero = jnp.zeros_like(coords_s)
    coords_s = jnp.where(mask[:, None], coords_s, zero)
    normals_s = jnp.where(mask[:, None], normals_s, zero)
    ranges = jnp.linalg.norm(coords_s, axis=-1)
    return RaycastResult(coords_s, normals_s, mask, ranges, n_dropped)


def raycast_fast_batch(grid: TsdGrid, geom: SensorPolar2D,
                       poses: jnp.ndarray,
                       segments: Optional[SegmentCache] = None,
                       max_segments: int = None) -> RaycastResult:
    """Pose-batched splat raycast: P poses against ONE grid in a single
    pass, with the pose axis FOLDED into the flat beam axis of every
    stage (P*B beams through the candidate sweep, window replay and
    rounds).

    Compared with `jax.vmap(raycast_fast)`, the rounds tail skip here
    is a JOINT `lax.cond` over the whole batch (a vmapped cond lowers
    to a select whose both branches execute per pose), and the per-scan
    fixed costs (fingerprint gate, segment reuse, glue ops) are paid
    once.

    Returns a RaycastResult whose fields carry a leading [P] axis
    (n_dropped is a scalar total).
    """
    dtype = grid.tsd.dtype
    P = poses.shape[0]
    B = geom.size
    ray, tr, idx_min, idx_max, feasible = jax.vmap(
        lambda p: beam_geometry(grid, geom, p))(poses)
    N = P * B
    ray_f = ray.reshape(N, 2)
    tr_f = jnp.repeat(tr, B, axis=0)               # pose-major [N, 2]
    coords_w, normals_w, hit, n_ok, n_dropped = _raycast_core(
        grid, segments, max_segments, ray_f, tr_f,
        idx_min.reshape(N), idx_max.reshape(N), feasible.reshape(N))
    coords_w = coords_w.reshape(P, B, 2)
    normals_w = normals_w.reshape(P, B, 2)
    mask = feasible & hit.reshape(P, B) & n_ok.reshape(P, B)
    Tinv = jax.vmap(se2.invert)(poses.astype(dtype))
    coords_s = jax.vmap(se2.transform_points)(Tinv, coords_w)
    normals_s = jax.vmap(se2.rotate_vectors)(Tinv, normals_w)
    zero = jnp.zeros_like(coords_s)
    coords_s = jnp.where(mask[..., None], coords_s, zero)
    normals_s = jnp.where(mask[..., None], normals_s, zero)
    ranges = jnp.linalg.norm(coords_s, axis=-1)
    return RaycastResult(coords_s, normals_s, mask, ranges, n_dropped)


def _raycast_core(grid: TsdGrid, segments: Optional[SegmentCache],
                  max_segments: Optional[int], ray: jnp.ndarray,
                  tr: jnp.ndarray, idx_min: jnp.ndarray,
                  idx_max: jnp.ndarray, feasible: jnp.ndarray):
    """Flat raycast core over N beams (single pose, or P poses folded
    into N = P*B).  `tr` is [2] for one pose or per-beam rows [N, 2]
    for a folded batch.  Returns world-frame (coords_w [N,2], normals_w [N,2],
    hit [N], n_ok [N], n_dropped scalar)."""
    N = ray.shape[0]

    # ---- isocontour segments + intersection candidates ------------------
    # ROUNDS candidate/replay rounds: a double-crossing inside one march
    # step (thin sliver between two sample phases) is a genuine
    # intersection the sampled march steps over without a sign change —
    # the search continues at the next intersection beyond the window's
    # coverage.  Round 1 replays a window for every beam; later rounds
    # replay only the (rare) still-unresolved beams, compacted to
    # UNRESOLVED_CAP slots.  Beams needing more than ROUNDS slivers, or
    # overflowing the compaction, count into n_dropped (raycast_checked
    # then falls back to the exact march).
    # folded pose batches scale the per-round replay capacity with the
    # batch (~17 slots per 1081-beam scan — beams unresolved after
    # round 1 are ~2/scan); overflow counts into n_dropped, never silent
    UNRESOLVED_CAP = 256 if N <= 2048 else (-(-N // 64) // 128 + 1) * 128
    segments_given = segments is not None
    if segments is None:
        segments = extract_segments(grid, max_segments)
    p0, p1, svalid = segments.p0, segments.p1, segments.valid
    n_dropped = segments.n_dropped
    if segments_given and segments.fingerprint is not None:
        # stale-cache gate: a cache extracted from a
        # DIFFERENT grid version would silently produce wrong model
        # points; count it as a full overflow so raycast_checked falls
        # back to the exact march.  One integer reduction over the grid
        # per scan — order-independent, so fresh caches never
        # false-positive.
        stale = segments.fingerprint != grid_fingerprint(grid.tsd)
        n_dropped = n_dropped + jnp.where(stale, N, 0)

    lo = jnp.maximum(jnp.floor(idx_min) - 1.0, 0.0)
    hi = jnp.ceil(idx_max) + 1.0
    cover = WINDOW - BACKOFF - 2.0

    # round-1 candidates: earliest intersection per beam
    t_1 = _segment_candidates(p0, p1, svalid, tr, ray, lo, hi, lo)

    has = jnp.isfinite(t_1) & feasible
    k_1 = jnp.where(has, t_1, 0.0)

    # round 1: all beams
    hit, any_1, pos_ev, interp = _window_events(
        grid, tr, ray, idx_min, idx_max, k_1, has)

    def _rounds(carry):
        """Rounds 2..ROUNDS over the compacted unresolved beams.  Runs
        under lax.cond only when some beam is still unresolved after
        round 1; when the predicate is true but individual beams are
        fine, every update below is the identity, so outputs are the
        same with or without the skip."""
        hit, any_1, pos_ev, interp, n_dropped = carry
        resolved = any_1 | ~has
        t_search = jnp.maximum(lo, k_1 + cover)

        # fused per-beam state for the round scatters: one [N, 5] array
        # so each round does ONE gather + ONE scatter instead of five
        S = jnp.stack([hit.astype(jnp.float32), pos_ev[:, 0], pos_ev[:, 1],
                       interp, resolved.astype(jnp.float32)], axis=-1)

        for _ in range(1, ROUNDS):
            res_now = S[:, 4] > 0.0
            t_r = _segment_candidates(p0, p1, svalid, tr, ray, lo, hi,
                                      jnp.where(res_now, jnp.inf, t_search))
            need = jnp.isfinite(t_r) & ~res_now
            n_need = jnp.sum(need, dtype=jnp.int32)
            n_dropped = n_dropped + jnp.maximum(n_need - UNRESOLVED_CAP, 0)
            need_pad = jnp.pad(need, (0, (-N) % 128))
            idx_u, uvalid = compact_mask(need_pad, UNRESOLVED_CAP)
            idx_u = jnp.minimum(idx_u, N - 1)
            k_u = jnp.where(uvalid, t_r[idx_u], 0.0)
            tr_u = tr if tr.ndim == 1 else tr[idx_u]
            hit_u, any_u, pos_u, int_u = _window_events(
                grid, tr_u, ray[idx_u], idx_min[idx_u],
                idx_max[idx_u], k_u, uvalid)
            take_u = any_u & uvalid
            S_u = S[idx_u]                           # one gather
            res_u = (S_u[:, 4] > 0.0) | take_u
            rows = jnp.stack(
                [jnp.where(take_u, hit_u.astype(jnp.float32), S_u[:, 0]),
                 jnp.where(take_u, pos_u[:, 0], S_u[:, 1]),
                 jnp.where(take_u, pos_u[:, 1], S_u[:, 2]),
                 jnp.where(take_u, int_u, S_u[:, 3]),
                 res_u.astype(jnp.float32)], axis=-1)
            # scatter back; pad slots target out-of-range N and are
            # dropped (their idx 0 placeholder could collide with a
            # real beam-0 slot)
            idx_w = jnp.where(uvalid, idx_u, N)
            S = S.at[idx_w].set(rows, mode="drop")   # one scatter
            # `resolved |= ~need`: beams with no candidate this round
            # exit future rounds permanently (t_r only grows)
            S = S.at[:, 4].set(jnp.maximum(S[:, 4],
                                           (~need).astype(jnp.float32)))
            t_search = jnp.maximum(t_search, jnp.where(jnp.isfinite(t_r),
                                                       t_r + cover, t_search))

        return S[:, 0] > 0.0, any_1, S[:, 1:3], S[:, 3], n_dropped

    # under vmap (pose batches) the cond lowers to a select and both
    # branches run
    carry = (hit, any_1, pos_ev, interp, n_dropped)
    all_res = jnp.all(any_1 | ~has)
    hit, any_1, pos_ev, interp, n_dropped = jax.lax.cond(
        all_res, lambda c: c, _rounds, carry)

    coords_w = pos_ev + ray * (interp[:, None] - 1.0)
    normals_w, n_ok = interpolate_normal(grid, coords_w)
    return coords_w, normals_w, hit, n_ok, n_dropped


def raycast_checked(grid: TsdGrid, geom: SensorPolar2D,
                    pose: jnp.ndarray,
                    segments: Optional[SegmentCache] = None
                    ) -> RaycastResult:
    """Guarded splat raycast: when the segment compaction overflows
    MAX_SEGMENTS (beams would silently lose hits), fall back to the
    exact dense march of grid/raycast.py.  Both branches are compiled;
    only one executes per call."""
    from ohm_tsd_slam.grid.raycast import raycast as raycast_exact

    fast = raycast_fast(grid, geom, pose, segments=segments)

    def exact(_):
        r = raycast_exact(grid, geom, pose)
        return r._replace(n_dropped=fast.n_dropped)

    def keep(_):
        return fast

    return jax.lax.cond(fast.n_dropped > 0, exact, keep, None)


raycast_fast_jit = jax.jit(raycast_fast, static_argnames=("geom",))
raycast_checked_jit = jax.jit(raycast_checked, static_argnames=("geom",))
