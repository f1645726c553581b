"""Differentiable range rendering from the TSD grid.

The reference raycaster (src/obvision/reconstruct/grid/RayCastPolar2D.cpp)
is forward-only: it marches each beam to the first +/- zero crossing of
the TSD field and returns the surface point.  This module adds the piece
the reference has no analogue for — **gradients of the rendered range
image with respect to the sensor pose and the TSD cells** — which turns
the renderer into a trainable/optimizable measurement model (direct
scan-to-map Gauss-Newton, pose-graph refinement, grid learning).

Math: the hit range r of a beam with world origin ``o(pose)`` and unit
direction ``d(pose)`` satisfies the implicit equation

    F(r; pose, tsd) = Phi(o + r d; tsd) = 0

where ``Phi`` is the bilinearly interpolated TSD field
(TsdGrid.h:284-304).  By the implicit function theorem,

    dr/dp = - (dF/dp) / (dF/dr),      dF/dr = grad(Phi) . d

for any parameter p (pose entries or TSD cell values).  The backward
pass therefore needs **no march**: it evaluates one JVP (for dF/dr) and
one VJP (for dF/dp) of the bilinear interpolation at the B hit points —
O(beams) work, independent of grid size and march length.

The nondifferentiable hit/miss decision is handled straight-through:
gradients flow only through beams that hit (miss beams get exact zero
gradient), matching SURVEY.md section 7 step 4.

Forward values come from the ordinary raycaster, optionally polished by a
few guarded Newton steps on the bilinear field along the ray
(``refine=True``, the default): the march's sub-cell interpolation
(RayCastPolar2D.cpp:257-262) linearizes the field between two adjacent
samples, which is O(cell^2)-accurate; Newton converges to the exact root
of the piecewise-bilinear field, so the refined forward agrees with the
IFT gradient to machine precision under finite differences (verified in
tests/test_render.py).  With ``refine=False`` the forward bit-matches the
reference's interpolation formula and the gradient is still that of the
true root (within ~|cell|^2 of the forward's own FD).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.raycast import RaycastResult, raycast
from ohm_tsd_slam.grid.raycast_fast import raycast_checked
from ohm_tsd_slam.grid.state import TsdGrid
from ohm_tsd_slam.sensor.polar2d import SensorPolar2D


def _bilinear_raw(tsd: jnp.ndarray, coords: jnp.ndarray, cell_size: float
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinear interpolation on the raw TSD array with NaN-safe taps.

    Same cell convention as TsdGrid::coord2Cell (TsdGrid.h:306-340):
    base = floor(coord/s - 0.5), weights are fractional offsets from the
    base cell center.  NaN taps are zeroed *inside* the arithmetic so AD
    never propagates NaN; validity is returned separately.
    """
    H, W = tsd.shape
    s = cell_size
    u = coords[..., 0] / s - 0.5
    v = coords[..., 1] / s - 0.5
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    wx = u - ix
    wy = v - iy
    valid = (ix >= 0) & (ix < W - 1) & (iy >= 0) & (iy < H - 1)
    ixc = jnp.clip(ix, 0, W - 2)
    iyc = jnp.clip(iy, 0, H - 2)

    v00 = tsd[iyc, ixc]
    v10 = tsd[iyc + 1, ixc]
    v01 = tsd[iyc, ixc + 1]
    v11 = tsd[iyc + 1, ixc + 1]
    finite = ~(jnp.isnan(v00) | jnp.isnan(v10) | jnp.isnan(v01)
               | jnp.isnan(v11))
    v00, v10, v01, v11 = (jnp.nan_to_num(t) for t in (v00, v10, v01, v11))
    # Tap ordering/weights of TsdGridPartition::interpolateBilinear
    # (TsdGridPartition.h:214-221).
    val = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)
    ok = valid & finite
    return jnp.where(ok, val, 0.0), ok


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _ift_ranges(geom: SensorPolar2D, cell_size: float, tsd: jnp.ndarray,
                pose: jnp.ndarray, r0: jnp.ndarray,
                hit_f: jnp.ndarray) -> jnp.ndarray:
    """Identity on the marched ranges r0, with an IFT backward pass.

    r0 and hit_f are treated as constants of the surrounding march (the
    caller stop-gradients them); tsd and pose carry the gradients.
    """
    del geom, cell_size, tsd, pose, hit_f
    return r0


def _phi_at(geom: SensorPolar2D, cell_size: float, tsd: jnp.ndarray,
            pose: jnp.ndarray, r: jnp.ndarray):
    """Phi(o(pose) + r * d(pose); tsd) per beam, with validity."""
    dirs = se2.rotate_vectors(pose.astype(tsd.dtype),
                              geom.rays_local(tsd.dtype))
    x = pose[:2, 2].astype(tsd.dtype) + r[:, None] * dirs
    return _bilinear_raw(tsd, x, cell_size)


def _newton_refine(geom: SensorPolar2D, cell_size: float, tsd: jnp.ndarray,
                   pose: jnp.ndarray, r0: jnp.ndarray, hit: jnp.ndarray,
                   iters: int = 4) -> jnp.ndarray:
    """Polish the marched crossing to the exact root of the bilinear field.

    Guarded Newton on r -> Phi(o + r d): steps are clamped to half a cell
    (the crossing lies within one cell of the march's estimate), and beams
    with a vanishing directional derivative keep their estimate.  Four
    iterations suffice: the start is already inside the crossing cell
    (sub-cell linear interpolation) and Newton converges quadratically
    on the cellwise-quadratic field (error squares each step from a
    sub-cell bracket); each iteration costs a serial 4-tap gather
    pass, so fewer is measurably faster.
    """
    max_step = 0.5 * cell_size

    def body(_, r):
        val, d_dr = jax.jvp(
            lambda rr: _phi_at(geom, cell_size, tsd, pose, rr)[0],
            (r,), (jnp.ones_like(r),))
        safe = jnp.abs(d_dr) > 1e-9
        step = jnp.where(safe, -val / jnp.where(safe, d_dr, 1.0), 0.0)
        step = jnp.clip(step, -max_step, max_step)
        return jnp.where(hit, r + step, r)

    return jax.lax.fori_loop(0, iters, body, r0)


def _ift_fwd(geom, cell_size, tsd, pose, r0, hit_f):
    return r0, (tsd, pose, r0, hit_f)


def _ift_bwd(geom, cell_size, residuals, g):
    tsd, pose, r0, hit_f = residuals

    # dF/dr per beam + validity in ONE tap pass (the taps dominate:
    # XLA lowers them to serial gathers, so every extra Phi evaluation
    # costs ~0.1 ms/scan)
    (_, ok), (f_r, _) = jax.jvp(
        lambda r: _phi_at(geom, cell_size, tsd, pose, r),
        (r0,), (jnp.ones_like(r0),))

    # At a +/- crossing the field decreases along the ray, so dF/dr < 0;
    # guard against grazing hits where the directional derivative
    # vanishes (gradient would blow up -> mask those beams).
    active = (hit_f > 0.5) & ok & (jnp.abs(f_r) > 1e-6)
    denom = jnp.where(active, f_r, 1.0)
    u = jnp.where(active, -g / denom, 0.0)

    # dF/d(tsd, pose) at fixed r: one VJP of Phi; the tsd cotangent is a
    # scatter-add into the 4-cell bilinear stencils of the hit points.
    _, vjp_fn = jax.vjp(
        lambda tsd_, pose_: _phi_at(geom, cell_size, tsd_, pose_, r0)[0],
        tsd, pose)
    dtsd, dpose = vjp_fn(u)
    return dtsd, dpose, jnp.zeros_like(r0), jnp.zeros_like(hit_f)


_ift_ranges.defvjp(_ift_fwd, _ift_bwd)


def render_ranges(grid: TsdGrid, geom: SensorPolar2D, pose: jnp.ndarray,
                  use_fast: bool = True, refine: bool = True,
                  segments=None
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, RaycastResult]:
    """Render the range image from `pose`, differentiably.

    Args:
      grid: TSD state; gradients flow into grid.tsd.
      geom: static scan geometry.
      pose: (3,3) sensor pose; gradients flow into all pose entries
        (compose with se2.make for (x, y, theta) parameter gradients).
      use_fast: march with the splat+refine caster (raycast_fast) instead
        of the exact dense march.
      refine: polish crossings with guarded Newton to the exact bilinear
        root (see module docstring); turn off to bit-match the raycaster.
      segments: optional SegmentCache of `grid` (use_fast only).  For
        pose-only optimization against a FIXED grid (scan-to-map GN,
        pose-graph refinement) this skips the per-call isocontour
        extraction — the forward march then costs the cached-raycast
        price.  A STALE cache (grid changed since extraction) is caught
        by the cache's integer fingerprint and the forward march falls
        back to the exact dense march (raycast_checked), so results
        stay correct either way; re-extract to get the
        fast path back.

    Returns:
      (ranges, hit, result): ranges [B] in meters (0 where no hit, zero
      gradient there); hit [B] bool; the full RaycastResult of the
      underlying march (non-differentiable).
    """
    sg = jax.lax.stop_gradient
    grid_sg = jax.tree_util.tree_map(sg, grid)
    if use_fast:
        # guarded: capacity overflow or a stale `segments` cache falls
        # back to the exact dense march — never wrong model points
        res = raycast_checked(grid_sg, geom, sg(pose), segments=segments)
    else:
        res = raycast(grid_sg, geom, sg(pose))
    r0 = sg(res.ranges.astype(grid.tsd.dtype))
    if refine:
        r0 = sg(_newton_refine(geom, float(grid.cell_size), sg(grid.tsd),
                               sg(pose), r0, res.mask))
    hit_f = sg(res.mask.astype(grid.tsd.dtype))
    ranges = _ift_ranges(geom, float(grid.cell_size), grid.tsd, pose,
                         r0, hit_f)
    return ranges, res.mask, res


render_ranges_jit = jax.jit(render_ranges,
                            static_argnames=("geom", "use_fast", "refine"))
