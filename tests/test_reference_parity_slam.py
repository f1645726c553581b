"""FULL-LOOP behavioral parity against the COMPILED C++ REFERENCE
(SURVEY §4 plan item 5).

golden/slam_harness.cpp replays a 25-scan simulated trajectory through
the reference's complete localization+mapping cycle (raycast → ICP →
error gate → pose update → significance-gated push,
ThreadLocalize.cpp:310-409) built from the unmodified reference sources.
These tests replay the SAME scan sequences through this framework
(golden_io.replay_slam_loop_*) and diff the pose trace and the gate
decisions.
"""

import os

import numpy as np
import pytest

from golden_io import (
    SLAM_BIN,
    SLAM_TSD_BIN,
    replay_slam_loop_icp,
    replay_slam_loop_tsd,
)


def _assert_parity(got_poses, got_flags, ref_poses, ref_flags):
    # gate decisions must match scan for scan (the discrete behavior)
    np.testing.assert_array_equal(got_flags[:, 0], ref_flags[:, 0],
                                  err_msg="registration-error gates")
    np.testing.assert_array_equal(got_flags[:, 1], ref_flags[:, 1],
                                  err_msg="significance gates")
    # pose traces must agree to well below a cell (exact-arithmetic
    # differences only: compacted vs masked pairing order, fast-raycast
    # knife-edge beams)
    dpos = np.abs(got_poses[:, :2, 2] - ref_poses[:, :2, 2])
    drot = np.abs(got_poses[:, 0, 0] - ref_poses[:, 0, 0])
    assert dpos.max() < 1e-4, dpos.max()
    assert drot.max() < 1e-4, drot.max()


@pytest.mark.skipif(not os.path.exists(SLAM_BIN),
                    reason="golden slam-loop data not generated "
                           "(make -C golden)")
def test_full_loop_trajectory_parity():
    """SlamNode.process_scan in mode ICP against the harness."""
    got_poses, got_flags, ref_poses, ref_flags = replay_slam_loop_icp()
    assert ref_flags[:, 0].sum() == 0      # no reg errors either side
    _assert_parity(got_poses, got_flags, ref_poses, ref_flags)


@pytest.mark.skipif(not os.path.exists(SLAM_TSD_BIN),
                    reason="golden slam_tsd data not generated")
def test_full_loop_trajectory_parity_tsd():
    """Full-loop parity in the reference's SHIPPED DEFAULT registration
    mode (TSD_PDFMatching seed + ICP refinement, registration_mode: 3,
    config/single-laser.yaml:22; dispatch ThreadLocalize.cpp:558-580).
    The harness resets the deterministic rand stream to seed+k per scan;
    the same draws are replayed (golden_io.DetRand) and injected into
    match_tsd, so both sides score the SAME candidate set against the
    SAME evolving grid."""
    _assert_parity(*replay_slam_loop_tsd())
