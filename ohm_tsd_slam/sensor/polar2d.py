"""Polar 2D laser sensor model.

Redesign of the reference's SensorPolar2D
(src/obvision/reconstruct/grid/SensorPolar2D.{h,cpp}) and its Sensor base
(src/obvision/reconstruct/Sensor.cpp).  Instead of a stateful C++ object
holding mutable pose/ray matrices, the geometry is a small frozen dataclass
of static scan parameters, and every operation is a pure function of
(geometry, pose, ranges) that vectorizes over beams and jit-compiles.

Semantics replicated exactly (with file:line citations inline):
  * beam directions phi_i = phi_min + i * res  (SensorPolar2D.cpp:39-44)
  * angular bounds  (SensorPolar2D.cpp:26-30)
  * batch backProject: world point -> beam index with -1/-2 out-of-bounds
    codes  (SensorPolar2D.cpp:117-135)
  * standard masking: zero depth, invalid depth, 3-degree depth
    discontinuity via law of cosines/sines  (SensorPolar2D.cpp:59-98,
    Sensor.cpp:252-272)
  * polar->Cartesian scan conversion  (Sensor.cpp:168-190)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp

from ohm_tsd_slam.core import se2

# backProject out-of-bounds codes (SensorPolar2D.cpp:131-133)
IDX_BELOW_FOV = -2   # angle below lower bound
IDX_ABOVE_FOV = -1   # angle above upper bound


@dataclass(frozen=True)
class SensorPolar2D:
    """Static polar-scan geometry (immutable; safe as a jit static arg)."""

    size: int
    angular_res: float
    phi_min: float
    max_range: float
    min_range: float = 0.001
    low_reflectivity_range: float = 2.0

    @property
    def phi_lower_bound(self) -> float:
        # smallest in-bounds angle (SensorPolar2D.cpp:26)
        return -0.5 * self.angular_res + self.phi_min

    @property
    def phi_upper_bound(self) -> float:
        # upper bound phi_min + (size-0.5)*res (SensorPolar2D.cpp:30)
        return self.phi_min + (self.size - 0.5) * self.angular_res

    def angles(self, dtype=jnp.float32) -> jnp.ndarray:
        i = jnp.arange(self.size, dtype=dtype)
        return self.phi_min + i * self.angular_res

    def rays_local(self, dtype=jnp.float32) -> jnp.ndarray:
        """Unit beam directions in the sensor frame, shape (size, 2)."""
        phi = self.angles(dtype)
        return jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)


def _round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """C round(): half away from zero.  The back-projection argument is
    > -0.5 by construction, so floor(x + 0.5) is exact here."""
    return jnp.floor(x + 0.5)


def back_project(geom: SensorPolar2D, pose: jnp.ndarray,
                 points: jnp.ndarray) -> jnp.ndarray:
    """Map world points to beam indices.

    Replicates SensorPolar2D::backProject(Matrix*, int*)
    (SensorPolar2D.cpp:117-135): transform points into the sensor frame
    with pose⁻¹, take atan2, and bin by angular resolution; returns -2
    below the FOV and -1 above it.

    Args:
      geom: scan geometry.
      pose: (3,3) sensor pose in world frame.
      points: (..., 2) world coordinates.
    Returns:
      (...,) int32 beam indices (or IDX_BELOW_FOV / IDX_ABOVE_FOV).
    """
    local = se2.transform_points(se2.invert(pose), points)
    phi = jnp.arctan2(local[..., 1], local[..., 0])
    idx = _round_half_away((phi - geom.phi_min) / geom.angular_res)
    idx = idx.astype(jnp.int32)
    idx = jnp.where(phi <= geom.phi_lower_bound, IDX_BELOW_FOV, idx)
    idx = jnp.where(phi >= geom.phi_upper_bound, IDX_ABOVE_FOV, idx)
    return idx


def mask_invalid_depth(geom: SensorPolar2D, data: jnp.ndarray,
                       mask: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sensor::maskInvalidDepth (Sensor.cpp:258-272): ranges beyond
    max_range become +inf; NaNs become +inf and are masked out."""
    data = jnp.where(data > geom.max_range, jnp.inf, data)
    isnan = jnp.isnan(data)
    mask = mask & ~isnan
    data = jnp.where(isnan, jnp.inf, data)
    return data, mask


def mask_depth_discontinuity(geom: SensorPolar2D, data: jnp.ndarray,
                             mask: jnp.ndarray,
                             thresh: float) -> jnp.ndarray:
    """Sensor masking of depth discontinuities with radius 1
    (SensorPolar2D.cpp:67-98).

    For each interior beam i with finite range a and each finite neighbor
    b at ±1 beam: c = sqrt(a²+b²-2ab·cos(res)) (law of cosines); when
    a > b, beta = asin(b/c·sin(res)) (law of sines); the beam is masked
    when the minimum such beta is below `thresh`.
    """
    res = geom.angular_res
    cosphi = jnp.cos(jnp.asarray(res, data.dtype))
    sinphi = jnp.sin(jnp.asarray(res, data.dtype))

    a = data
    betamin = jnp.full_like(data, jnp.pi)
    for shift in (-1, 1):
        b = jnp.roll(data, -shift)
        # neighbors beyond the array edge never participate (loop runs
        # i in [1, size-2] in the reference); handled below by masking
        # the first/last beams out of the update entirely.
        c = jnp.sqrt(a * a + b * b - 2.0 * a * b * cosphi)
        beta = jnp.arcsin(jnp.clip(b / c * sinphi, -1.0, 1.0))
        consider = (a > b) & ~jnp.isinf(b)
        betamin = jnp.where(consider, jnp.minimum(betamin, beta), betamin)

    interior = jnp.zeros_like(mask).at[1:-1].set(True)
    cut = interior & ~jnp.isinf(a) & (betamin < thresh)
    return mask & ~cut


def standard_mask(geom: SensorPolar2D,
                  data: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SensorPolar2D::setStandardMask (SensorPolar2D.cpp:59-65):
    reset mask, mask zero depth, mask invalid depth (mutating data!),
    mask 3-degree depth discontinuities.

    Returns (possibly modified data, mask).
    """
    mask = jnp.ones(data.shape, dtype=bool)
    mask = mask & (data != 0.0)                     # maskZeroDepth (Sensor.cpp:252-256)
    data, mask = mask_invalid_depth(geom, data, mask)
    mask = mask_depth_discontinuity(geom, data, mask, jnp.deg2rad(3.0))
    return data, mask


def data_to_cartesian(geom: SensorPolar2D, data: jnp.ndarray,
                      mask: jnp.ndarray,
                      dtype=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sensor::dataToCartesianVectorMask (Sensor.cpp:168-190): beam-aligned
    scene points rays_local * range with a validity mask (finite & masked).

    Invalid slots are zeroed (the reference leaves stale buffer contents
    there; they are never read downstream).
    """
    if dtype is None:
        dtype = data.dtype
    rays = geom.rays_local(dtype)
    valid = mask & ~jnp.isinf(data)
    coords = jnp.where(valid[:, None], rays * data[:, None].astype(dtype), 0.0)
    return coords, valid


def clamp_min_range(data: jnp.ndarray, laser_min_range: float) -> jnp.ndarray:
    """ThreadLocalize::laserCallBack clamps ranges below laser_min_range
    to 0 so the standard mask drops them (ThreadLocalize.cpp:252-256)."""
    if laser_min_range <= 0.0:
        return data
    return jnp.where(data < laser_min_range, 0.0, data)
