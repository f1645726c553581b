"""Registration-layer parity against the COMPILED C++ REFERENCE.

golden/reg_harness.cpp compiles the unmodified reference registration
sources (Icp engine + ClosedFormEstimator2D + PointToLine2DEstimator +
DistanceFilter + ReciprocalFilter + OutOfBoundsFilter2D, with an exact
brute-force 1-NN standing in for FLANN — identical pair semantics,
golden/BruteForcePairAssignment.h) and dumps PER-ITERATION accumulated
transforms, RMS, and pair counts for six scripted model/scene cases.
These tests assert the JAX ICP reproduces every iteration:

  * Icp::step / iterate loop            (Icp.cpp:409-512)
  * FLANN-equivalent exact 1-NN         (FlannPairAssignment.cpp:94-144)
  * DistanceFilter shrinking gate       (DistanceFilter.cpp:11-64)
  * ReciprocalFilter                    (ReciprocalFilter.cpp:31-83)
  * OutOfBoundsFilter2D                 (OutOfBoundsFilter2D.cpp:27-37)
  * ClosedFormEstimator2D               (ClosedFormEstimator2D.cpp:36-109)
  * PointToLine2DEstimator              (PointToLineEstimator2D.cpp:52-157)

Run on CPU float64 (conftest).  Both the fused dense iteration body and
the modular chain are checked.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ohm_tsd_slam.registration.icp import IcpParams, icp

from golden_io import GOLDEN_DIR, load_golden

REG_BIN = os.path.join(GOLDEN_DIR, "data", "reg.bin")
REG_NPZ = os.path.join(GOLDEN_DIR, "data", "reg_inputs.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REG_BIN),
    reason="golden registration data not generated (make -C golden)")

CASES = ["cf_full", "cf_seeded", "cf_distonly", "cf_nofilter",
         "p2l_full", "p2l_partial"]


@pytest.fixture(scope="module")
def golden():
    return load_golden(REG_BIN)


@pytest.fixture(scope="module")
def inputs():
    return np.load(REG_NPZ)


def _run_case(inputs, name, fused):
    spec = inputs[f"{name}.spec"]
    (iters, maxrms, conv, use_dist, dist_max, dist_min, dist_iters,
     use_rec, use_oob) = spec
    bounds = tuple(inputs["bounds"]) if int(use_oob) else None
    params = IcpParams(
        iterations=int(iters), max_rms=float(maxrms),
        convergence_count=int(conv),
        dist_min=float(dist_min), dist_max=float(dist_max),
        dist_iterations=int(dist_iters),
        use_distance_filter=bool(int(use_dist)),
        use_reciprocal_filter=bool(int(use_rec)),
        bounds=bounds,
        estimator=("point_to_line" if name.startswith("p2l")
                   else "closed_form"),
        record_T=True,
        fused=fused,
    )
    model = jnp.asarray(inputs[f"{name}.model"], jnp.float64)
    normals = jnp.asarray(inputs[f"{name}.normals"], jnp.float64)
    scene = jnp.asarray(inputs[f"{name}.scene"], jnp.float64)
    tinit = jnp.asarray(inputs[f"{name}.tinit"], jnp.float64)
    pose = jnp.asarray(inputs[f"{name}.pose"], jnp.float64)
    ones_m = jnp.ones(model.shape[0], bool)
    ones_s = jnp.ones(scene.shape[0], bool)
    return icp(model, ones_m, scene, ones_s, params, T_init=tinit,
               sensor_pose=pose, model_normals=normals)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "modular"])
@pytest.mark.parametrize("name", CASES)
def test_icp_iteration_parity(golden, inputs, name, fused):
    """Per-iteration T / RMS / pair-count match vs the compiled
    reference Icp loop at 1e-9."""
    res = _run_case(inputs, name, fused)
    ref_T = np.asarray(golden[f"{name}.T_hist"])        # [it, 9]
    ref_rms = np.asarray(golden[f"{name}.rms_hist"])
    ref_pairs = np.asarray(golden[f"{name}.pair_hist"])
    n_ref = int(golden[f"{name}.meta"][0])

    n = int(res.iterations)
    assert n == n_ref, (name, n, n_ref)

    got_pairs = np.asarray(res.pair_history)[:n]
    np.testing.assert_array_equal(got_pairs, ref_pairs,
                                  err_msg=f"{name}: pair counts")

    got_rms = np.asarray(res.rms_history)[:n]
    np.testing.assert_allclose(got_rms, ref_rms, rtol=0, atol=1e-9,
                               err_msg=f"{name}: rms trajectory")

    got_T = np.asarray(res.T_history)[:n].reshape(n, 9)
    np.testing.assert_allclose(got_T, ref_T.reshape(n, 9), rtol=0,
                               atol=1e-9,
                               err_msg=f"{name}: per-iteration T")

    ref_fin = np.asarray(golden[f"{name}.T_final"])
    np.testing.assert_allclose(np.asarray(res.T), ref_fin, rtol=0,
                               atol=1e-9, err_msg=f"{name}: final T")
