"""ICP engine vs the NumPy oracle and recovery-of-known-transform
properties."""

import math

import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.registration import IcpParams, IcpState, icp
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan
from oracle.oracle_icp import OracleIcp

SIZE = 271
RES = math.radians(1.0)
PHI0 = math.radians(-135.0)
RMAX = 8.0


def _cloud(pose_xyt):
    pose = np.array(se2.make(*pose_xyt, dtype=jnp.float64))
    walls = rect_walls(0.5, 0.5, 7.5, 7.5)
    r = simulate_scan(pose, SIZE, RES, PHI0, RMAX, segments=walls,
                      circles=[((5.0, 5.0), 0.6), ((2.0, 6.0), 0.4)])
    phi = PHI0 + np.arange(SIZE) * RES
    pts = np.stack([np.cos(phi), np.sin(phi)], 1) * r[:, None]
    valid = np.isfinite(r)
    return pts[valid]


def test_icp_matches_oracle():
    model = _cloud((4.0, 4.0, 0.0))
    scene = _cloud((4.08, 3.95, 0.05))

    params = IcpParams(iterations=25, dist_max=1.0, dist_min=0.2)
    res = icp(jnp.asarray(model), jnp.ones(len(model), bool),
              jnp.asarray(scene), jnp.ones(len(scene), bool), params)

    oracle = OracleIcp(iterations=25, dist_max=1.0, dist_min=0.2)
    To, rms_o, pairs_o, iters_o, trace = oracle.register(model, scene)

    np.testing.assert_allclose(np.array(res.T), To, atol=1e-9)
    assert int(res.iterations) == iters_o
    assert int(res.pairs) == pairs_o
    np.testing.assert_allclose(float(res.rms), rms_o, rtol=1e-9)
    # per-iteration pair counts agree
    got_pairs = np.array(res.pair_history)[:iters_o]
    exp_pairs = np.array([t[1] for t in trace])
    np.testing.assert_array_equal(got_pairs, exp_pairs)


def test_icp_recovers_known_transform():
    """Scene displaced by a known rigid transform: ICP must invert it."""
    model = _cloud((4.0, 4.0, 0.3))
    # displacement small vs beam spacing so point-to-point ICP has exact
    # correspondences in its basin (larger offsets alias to neighboring
    # beams — a property shared with the reference engine)
    T_true = np.array(se2.make(0.02, -0.015, 0.01, dtype=jnp.float64))
    # scene = T_true^-1 model  =>  ICP should estimate ~T_true
    Ti = np.linalg.inv(T_true)
    scene = model @ Ti[:2, :2].T + Ti[:2, 2]

    params = IcpParams(iterations=30, dist_max=1.0, dist_min=0.1)
    res = icp(jnp.asarray(model), jnp.ones(len(model), bool),
              jnp.asarray(scene), jnp.ones(len(scene), bool), params)
    np.testing.assert_allclose(np.array(res.T), T_true, atol=1e-5)
    assert int(res.state) == IcpState.SUCCESS


def test_icp_with_masks_equals_compacted():
    """Masked beam-aligned inputs give the same result as compacted
    arrays (the reference compacts via maskMatrix,
    ThreadLocalize.cpp:738-755)."""
    model = _cloud((4.0, 4.0, 0.0))
    scene = _cloud((4.05, 4.02, -0.03))

    rng = np.random.default_rng(3)
    # pad with garbage points that are masked out
    pad_m = rng.uniform(0, 8, (40, 2))
    pad_s = rng.uniform(0, 8, (25, 2))
    model_p = np.concatenate([model, pad_m])
    scene_p = np.concatenate([scene, pad_s])
    mmask = np.concatenate([np.ones(len(model), bool), np.zeros(40, bool)])
    smask = np.concatenate([np.ones(len(scene), bool), np.zeros(25, bool)])

    params = IcpParams(iterations=20)
    r1 = icp(jnp.asarray(model), jnp.ones(len(model), bool),
             jnp.asarray(scene), jnp.ones(len(scene), bool), params)
    r2 = icp(jnp.asarray(model_p), jnp.asarray(mmask),
             jnp.asarray(scene_p), jnp.asarray(smask), params)
    np.testing.assert_allclose(np.array(r1.T), np.array(r2.T), atol=1e-12)
    assert int(r1.pairs) == int(r2.pairs)


def test_icp_not_matchable():
    """Fewer than 3 pairs -> NOTMATCHABLE, identity transform
    (Icp.cpp:421,458)."""
    model = np.array([[0.0, 0.0], [1.0, 0.0]])
    scene = np.array([[0.0, 0.1], [1.0, 0.1]])
    params = IcpParams(iterations=5)
    res = icp(jnp.asarray(model), jnp.ones(2, bool),
              jnp.asarray(scene), jnp.ones(2, bool), params)
    assert int(res.state) == IcpState.NOTMATCHABLE
    np.testing.assert_allclose(np.array(res.T), np.eye(3))


def test_icp_with_tinit_seed():
    """A T_init seed is pre-applied and included in the result
    (Icp.cpp:482-487)."""
    model = _cloud((4.0, 4.0, 0.0))
    T_true = np.array(se2.make(0.2, -0.15, 0.12, dtype=jnp.float64))
    Ti = np.linalg.inv(T_true)
    scene = model @ Ti[:2, :2].T + Ti[:2, 2]

    # seed close to the answer
    T_seed = np.array(se2.make(0.19, -0.14, 0.11, dtype=jnp.float64))
    params = IcpParams(iterations=30, dist_max=1.0, dist_min=0.1)
    res = icp(jnp.asarray(model), jnp.ones(len(model), bool),
              jnp.asarray(scene), jnp.ones(len(scene), bool), params,
              T_init=jnp.asarray(T_seed))
    np.testing.assert_allclose(np.array(res.T), T_true, atol=1e-6)


def test_icp_point_to_line_estimator():
    """Pluggable estimator (Icp::setRigidEstimator strategy, Icp.h:39-314):
    point-to-line (PointToLineEstimator2D.cpp:86-157) must invert a known
    transform using model normals, and match a NumPy oracle of the
    reference's normal-equation formulas for one step."""
    # model: two perpendicular walls (rich normals), dense sampling
    n_pts = 200
    xs = np.linspace(0.0, 4.0, n_pts)
    wall_a = np.stack([xs, np.zeros_like(xs)], 1)          # y = 0
    wall_b = np.stack([np.zeros_like(xs), xs], 1)          # x = 0
    model = np.concatenate([wall_a, wall_b])
    normals = np.concatenate([
        np.tile([0.0, 1.0], (n_pts, 1)),
        np.tile([1.0, 0.0], (n_pts, 1)),
    ])

    T_true = np.array(se2.make(0.03, -0.02, 0.015, dtype=jnp.float64))
    Ti = np.linalg.inv(T_true)
    scene = model @ Ti[:2, :2].T + Ti[:2, 2]

    params = IcpParams(iterations=30, dist_max=1.0, dist_min=0.1,
                       estimator="point_to_line")
    res = icp(jnp.asarray(model), jnp.ones(len(model), bool),
              jnp.asarray(scene), jnp.ones(len(scene), bool), params,
              model_normals=jnp.asarray(normals))
    np.testing.assert_allclose(np.array(res.T), T_true, atol=1e-5)

    # one-step oracle: exact correspondences (identity pairing), solve
    # the reference's 3x3 normal system A [psi tx ty]^T = b
    # (PointToLineEstimator2D.cpp:111-156)
    from ohm_tsd_slam.registration.estimators import point_to_line_2d
    r = np.sum(normals * (scene - model), axis=1)
    a = scene[:, 0] * normals[:, 1] - scene[:, 1] * normals[:, 0]
    J = np.stack([a, normals[:, 0], normals[:, 1]], 1)
    sol = np.linalg.solve(J.T @ J, J.T @ (-r))
    T1, rms1 = point_to_line_2d(
        jnp.asarray(model), jnp.asarray(normals), jnp.asarray(scene),
        jnp.arange(len(model)), jnp.ones(len(model), bool))
    T1 = np.array(T1)
    np.testing.assert_allclose(
        [math.atan2(T1[1, 0], T1[0, 0]), T1[0, 2], T1[1, 2]],
        sol, atol=1e-8)
    np.testing.assert_allclose(float(rms1), np.abs(r).mean(), rtol=1e-9)


def test_icp_point_to_line_requires_normals():
    params = IcpParams(estimator="point_to_line")
    model = jnp.zeros((8, 2))
    try:
        icp(model, jnp.ones(8, bool), model, jnp.ones(8, bool), params)
        assert False, "expected ValueError"
    except ValueError:
        pass


def test_icp_fused_equals_modular_with_masks():
    """The fused dense iteration body (nn.assign_pairs_fused) must be
    numerically identical to the modular NN + DistanceFilter +
    ReciprocalFilter + gathered-estimator chain, including masked model/
    scene points and both estimators (f64 CPU: exact one-hot matmul)."""
    import dataclasses
    import jax

    rng = np.random.default_rng(11)
    M, S = 157, 149
    model = jnp.asarray(rng.normal(size=(M, 2)) * 2.0)
    th = 0.06
    scene_np = (np.asarray(model)[:S] @ np.array(
        [[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
        + np.array([0.04, -0.07]) + rng.normal(size=(S, 2)) * 0.01)
    scene = jnp.asarray(scene_np)
    mm = jnp.asarray(rng.random(M) > 0.15)
    sm = jnp.asarray(rng.random(S) > 0.15)
    normals = rng.normal(size=(M, 2))
    normals = jnp.asarray(normals / np.linalg.norm(normals, axis=1,
                                                   keepdims=True))

    for est in ("closed_form", "point_to_line"):
        for use_df, use_rf in ((True, True), (True, False), (False, True)):
            pa = IcpParams(iterations=12, estimator=est, fused=False,
                           use_distance_filter=use_df,
                           use_reciprocal_filter=use_rf,
                           bounds=(-10.0, 10.0, -10.0, 10.0),
                           record_T=True)
            pb = dataclasses.replace(pa, fused=True)
            run = jax.jit(icp, static_argnames=("params",))
            ra = run(model, mm, scene, sm, pa, model_normals=normals)
            rb = run(model, mm, scene, sm, pb, model_normals=normals)
            np.testing.assert_array_equal(
                np.asarray(ra.pair_history), np.asarray(rb.pair_history),
                err_msg=f"{est} df={use_df} rf={use_rf}")
            np.testing.assert_allclose(
                np.asarray(ra.T_history), np.asarray(rb.T_history),
                rtol=0, atol=1e-12, err_msg=f"{est} df={use_df} rf={use_rf}")
            assert int(ra.iterations) == int(rb.iterations)
