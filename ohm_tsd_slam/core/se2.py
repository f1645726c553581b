"""SE(2) rigid-transform utilities.

JAX replacement for the reference's GSL matrix plumbing
(reference: src/obcore/math/linalg/MatrixFactory.cpp:7-135 and
src/obvision/reconstruct/Sensor.cpp:50-60).  Poses are plain (3, 3)
homogeneous jnp arrays; there is no wrapper class — everything is a pure
function usable inside jit/vmap/grad.
"""

from __future__ import annotations

import jax.numpy as jnp


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(3, dtype=dtype)


def make(x, y, theta, dtype=jnp.float32) -> jnp.ndarray:
    """Build an SE(2) transform [[R(theta), t], [0, 1]].

    Mirrors the 3x3 transform assembly of the reference
    (src/ThreadLocalize.cpp:296-308, src/ThreadLocalize.cpp:466-482).
    """
    x = jnp.asarray(x, dtype)
    y = jnp.asarray(y, dtype)
    theta = jnp.asarray(theta, dtype)
    c, s = jnp.cos(theta), jnp.sin(theta)
    row0 = jnp.stack([c, -s, x])
    row1 = jnp.stack([s, c, y])
    row2 = jnp.array([0.0, 0.0, 1.0], dtype)
    return jnp.stack([row0, row1, row2]).astype(dtype)


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[:2, :2]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[:2, 2]


def angle(T: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle of a transform.

    The reference computes this from the first matrix column with a
    quadrant fix-up (src/ThreadLocalize.cpp:715-726); atan2 over the
    column entries is the closed form of the same value.
    """
    return jnp.arctan2(T[1, 0], T[0, 0])


def invert(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(2) inverse: [Rᵀ, -Rᵀ t] (elementwise; exact f32)."""
    tix = -(T[0, 0] * T[0, 2] + T[1, 0] * T[1, 2])
    tiy = -(T[0, 1] * T[0, 2] + T[1, 1] * T[1, 2])
    row0 = jnp.stack([T[0, 0], T[1, 0], tix])
    row1 = jnp.stack([T[0, 1], T[1, 1], tiy])
    row2 = jnp.array([0.0, 0.0, 1.0], T.dtype)
    return jnp.stack([row0, row1, row2]).astype(T.dtype)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return A @ B


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply T to an (..., 2) point array (rotate + translate).

    Written elementwise rather than as ``pts @ R.T`` so the result is
    plain f32 arithmetic whatever matmul precision the backend would
    pick (TF32 keeps ~3 decimal digits on world coordinates — enough to
    shift back-projected beam indices and raycast sample positions).
    The VPU elementwise form is exact f32 and faster for K=2.
    """
    x = pts[..., 0]
    y = pts[..., 1]
    out_x = T[0, 0] * x + T[0, 1] * y + T[0, 2]
    out_y = T[1, 0] * x + T[1, 1] * y + T[1, 2]
    return jnp.stack([out_x, out_y], axis=-1)


def rotate_vectors(T: jnp.ndarray, vecs: jnp.ndarray) -> jnp.ndarray:
    """Apply only the rotation of T to an (..., 2) vector array (normals).
    Elementwise for exact f32 (see transform_points)."""
    x = vecs[..., 0]
    y = vecs[..., 1]
    out_x = T[0, 0] * x + T[0, 1] * y
    out_y = T[1, 0] * x + T[1, 1] * y
    return jnp.stack([out_x, out_y], axis=-1)


def embed44(T3: jnp.ndarray) -> jnp.ndarray:
    """Embed a 3x3 SE(2) transform into a 4x4 (reference keeps ICP state
    as 4x4; src/obvision/registration/icp/Icp.cpp:528-546)."""
    T4 = jnp.eye(4, dtype=T3.dtype)
    T4 = T4.at[:2, :2].set(T3[:2, :2])
    T4 = T4.at[:2, 3].set(T3[:2, 2])
    return T4


def extract33(T4: jnp.ndarray) -> jnp.ndarray:
    T3 = jnp.eye(3, dtype=T4.dtype)
    T3 = T3.at[:2, :2].set(T4[:2, :2])
    T3 = T3.at[:2, 2].set(T4[:2, 3])
    return T3
