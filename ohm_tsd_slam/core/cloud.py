"""Point-cloud containers (obcore/base layer parity).

JAX equivalents of the reference's point containers, which sit in
the core layer but are unused by the 2D SLAM path (SURVEY.md §2.4):

* ``CartesianCloud`` ~ CartesianCloud3D
  (src/obcore/base/CartesianCloud.{h,cpp}): coords + optional normals /
  colors / per-point attribute side-channels, masking, transform,
  sub-sampling, pinhole projection / z-buffer rendering.
* ``PointCloud`` ~ PointCloud<T> (src/obcore/base/PointCloud.h:33-76):
  an optionally organized (width x height) cloud with an intrinsic
  rotation helper.

Design: immutable pytree dataclasses over dense ``[N, d]`` arrays with a
validity mask instead of erase-compaction — ``mask_points`` /
``remove_invalid_points`` flip mask bits rather than shrinking arrays,
keeping every operation jit-compatible with static shapes.  The
variable-size source-info map of the reference
(CartesianCloud.h:104-130) is a plain dict on the host side (it never
reaches device code).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CartesianCloud:
    """CartesianCloud3D as a functional pytree.

    Attributes:
      coords:  [N, 3] point coordinates.
      mask:    [N] validity (reference: maskPoints/removeInvalidPoints
               erase; here invalid points stay allocated, masked off).
      normals: [N, 3] or None (hasNormals, CartesianCloud.h:98).
      colors:  [N, 3] uint8 or None (hasColors, CartesianCloud.h:104).
      attrs:   host-side metadata dict (addSourceInfo/getSourceInfo,
               CartesianCloud.h:111-130) — static, not traced.
    """

    coords: jnp.ndarray
    mask: jnp.ndarray
    normals: Optional[jnp.ndarray] = None
    colors: Optional[jnp.ndarray] = None
    attrs: Dict[str, float] = field(
        default_factory=dict, metadata=dict(static=True))

    @property
    def size(self) -> int:
        """Allocated size (reference size() tracks erases; use
        valid_count() for the post-mask count)."""
        return self.coords.shape[0]

    def valid_count(self) -> jnp.ndarray:
        return jnp.sum(self.mask)

    def has_normals(self) -> bool:
        return self.normals is not None

    def has_colors(self) -> bool:
        return self.colors is not None


def create_cloud(coords, normals=None, colors=None,
                 attrs: Optional[Dict[str, float]] = None) -> CartesianCloud:
    """CartesianCloud3D(size, coords, rgb, normals)
    (CartesianCloud.cpp ctor): all points start valid."""
    coords = jnp.asarray(coords)
    return CartesianCloud(
        coords=coords,
        mask=jnp.ones(coords.shape[0], dtype=bool),
        normals=None if normals is None else jnp.asarray(normals),
        colors=None if colors is None else jnp.asarray(colors),
        attrs=dict(attrs or {}),
    )


def mask_points(cloud: CartesianCloud, keep: jnp.ndarray) -> CartesianCloud:
    """maskPoints (CartesianCloud.h:132): intersect validity."""
    return dataclasses.replace(cloud, mask=cloud.mask & keep)


def mask_empty_normals(cloud: CartesianCloud) -> CartesianCloud:
    """maskEmptyNormals (CartesianCloud.h:133): drop points whose normal
    is the zero vector."""
    if cloud.normals is None:
        return cloud
    nonzero = jnp.any(cloud.normals != 0.0, axis=1)
    return mask_points(cloud, nonzero)


def remove_invalid_points(cloud: CartesianCloud) -> CartesianCloud:
    """removeInvalidPoints (CartesianCloud.h:138): drop non-finite
    coordinates (the erase becomes a mask update)."""
    finite = jnp.all(jnp.isfinite(cloud.coords), axis=1)
    return mask_points(cloud, finite)


def subsample(cloud: CartesianCloud, step: int) -> CartesianCloud:
    """subsample(step) (CartesianCloud.h:144): keep every step-th point."""
    keep = (jnp.arange(cloud.size) % step) == 0
    return mask_points(cloud, keep)


def transform(cloud: CartesianCloud, T: jnp.ndarray) -> CartesianCloud:
    """transform(Matrix* T) (CartesianCloud.h:156): apply a 4x4
    homogeneous transform to coords; normals rotate only."""
    R = T[:3, :3]
    t = T[:3, 3]
    coords = cloud.coords @ R.T + t
    normals = None if cloud.normals is None else cloud.normals @ R.T
    return dataclasses.replace(cloud, coords=coords, normals=normals)


def project_to_image(cloud: CartesianCloud, P: jnp.ndarray,
                     width: int, height: int
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """createProjection / createZBuffer (CartesianCloud.h:167-177):
    project through the 3x4 pinhole matrix P; nearest-z point wins each
    pixel (sequential insert-compare becomes a min-scatter).

    Returns:
      zbuffer: [height, width] nearest depth per pixel (inf = empty).
      hit:     [height, width] bool occupancy.
    """
    x, y, z = cloud.coords[:, 0], cloud.coords[:, 1], cloud.coords[:, 2]
    w = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + P[2, 3]
    ok = cloud.mask & (jnp.abs(w) > 1e-12) & (z > 0.0)
    u = (P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]) / w
    v = (P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]) / w
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    ok = ok & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    flat = jnp.where(ok, vi * width + ui, 0)
    depth = jnp.where(ok, z, jnp.inf)
    zbuf = jnp.full((height * width,), jnp.inf, cloud.coords.dtype)
    zbuf = zbuf.at[flat].min(depth, mode="drop")
    zbuf = zbuf.reshape(height, width)
    return zbuf, jnp.isfinite(zbuf)


# ---------------------------------------------------------------------------
# PointCloud<T>: organized cloud (PointCloud.h:33-76)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PointCloud:
    """Organized point cloud: points [H*W, d] with width/height metadata.

    ``is_organized`` mirrors PointCloud.h:54 (height != 1).
    """

    points: jnp.ndarray
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))

    @property
    def size(self) -> int:
        return self.points.shape[0]

    @property
    def is_organized(self) -> bool:
        return self.height != 1


def create_point_cloud(points, width: Optional[int] = None,
                       height: int = 1) -> PointCloud:
    points = jnp.asarray(points)
    if width is None:
        width = points.shape[0]
    assert width * height == points.shape[0]
    return PointCloud(points=points, width=width, height=height)


def rotate_rpy(cloud: PointCloud, roll, pitch, yaw) -> PointCloud:
    """PointCloud::rotate(roll, pitch, yaw) (PointCloud.h:68): intrinsic
    XYZ rotation of all points."""
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    Rx = jnp.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]],
                   cloud.points.dtype)
    Ry = jnp.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]],
                   cloud.points.dtype)
    Rz = jnp.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]],
                   cloud.points.dtype)
    R = Rz @ Ry @ Rx
    return dataclasses.replace(cloud, points=cloud.points @ R.T)


# ---------------------------------------------------------------------------
# CartesianCloudFactory codecs (src/obcore/base/CartesianCloudFactory.cpp)
# ---------------------------------------------------------------------------

def save_cloud_ascii(path: str, cloud: CartesianCloud) -> None:
    """CartesianCloudFactory::serialize(eFormatAscii)
    (CartesianCloudFactory.cpp:36-52): one "x y z [r g b]" line per
    point; colors only when present.  (Replicated quirk: the reference
    writes colors[0..2] — the FIRST point's color — for every row; here
    each point's own color is written, which is the evident intent.)"""
    import numpy as np

    coords = np.asarray(cloud.coords, np.float64)
    colors = (np.asarray(cloud.colors) if cloud.colors is not None
              else None)
    with open(path, "w") as f:
        for i in range(coords.shape[0]):
            f.write(f"{coords[i, 0]:g} {coords[i, 1]:g} "
                    f"{coords[i, 2]:g}")
            if colors is not None:
                f.write(f" {int(colors[i, 0])} {int(colors[i, 1])}"
                        f" {int(colors[i, 2])}")
            f.write("\n")


def load_cloud_ascii(path: str, dtype=None) -> CartesianCloud:
    """CartesianCloudFactory::load(eFormatAscii)
    (CartesianCloudFactory.cpp:55-92): "x y z r g b" rows; a point is
    valid (ePointAttrValid) iff z > 0."""
    import numpy as np

    if dtype is None:
        dtype = jnp.float32
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                rows.append([float(v) for v in parts[:6]])
    if rows:
        arr = np.asarray(rows, np.float64)
    else:
        arr = np.zeros((0, 6), np.float64)
    coords = jnp.asarray(arr[:, :3], dtype)
    colors = jnp.asarray(arr[:, 3:6].astype(np.uint8))
    mask = jnp.asarray(arr[:, 2] > 0.0)
    return CartesianCloud(coords=coords, mask=mask, colors=colors)
