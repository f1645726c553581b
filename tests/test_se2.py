import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.core import se2


def test_make_invert_compose():
    T = se2.make(1.0, -2.0, 0.7, dtype=jnp.float64)
    Ti = se2.invert(T)
    np.testing.assert_allclose(np.array(T @ Ti), np.eye(3), atol=1e-12)
    np.testing.assert_allclose(float(se2.angle(T)), 0.7, atol=1e-12)
    np.testing.assert_allclose(np.array(se2.translation(T)), [1.0, -2.0])


def test_transform_points_matches_matmul():
    T = se2.make(0.3, 0.4, -1.2, dtype=jnp.float64)
    pts = np.random.default_rng(0).normal(size=(17, 2))
    out = se2.transform_points(T, jnp.asarray(pts))
    hom = np.concatenate([pts, np.ones((17, 1))], axis=1)
    expect = (np.array(T) @ hom.T).T[:, :2]
    np.testing.assert_allclose(np.array(out), expect, atol=1e-12)


def test_embed_extract_roundtrip():
    T = se2.make(0.1, 0.2, 0.3, dtype=jnp.float64)
    np.testing.assert_allclose(
        np.array(se2.extract33(se2.embed44(T))), np.array(T), atol=1e-15)
