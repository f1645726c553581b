"""Tests for auxiliary subsystems: multi-init ICP, trace recorder,
grid checkpoint codecs, odometry rescue, occlusion/projective assignment.
"""

import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.config import GridConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import create, push
from ohm_tsd_slam.grid.checkpoint import (
    load_npz,
    load_text,
    save_npz,
    save_text,
)
from ohm_tsd_slam.registration.icp import IcpParams
from ohm_tsd_slam.registration.multi_init import icp_multi_init
from ohm_tsd_slam.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
    standard_mask,
)
from ohm_tsd_slam.slam import odometry
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan
from ohm_tsd_slam.utils.trace import Trace

B = 361


def _clouds():
    geom = SensorPolar2D(size=B, angular_res=math.radians(0.75),
                         phi_min=math.radians(-135.0), max_range=15.0)
    walls = rect_walls(1.0, 1.0, 9.0, 9.0)
    pm = se2.make(5.0, 5.0, 0.2, dtype=jnp.float32)
    ps = se2.make(5.08, 4.93, 0.26, dtype=jnp.float32)
    rm = simulate_scan(np.array(pm), B, geom.angular_res, geom.phi_min,
                       geom.max_range, segments=walls)
    rs = simulate_scan(np.array(ps), B, geom.angular_res, geom.phi_min,
                       geom.max_range, segments=walls)
    dm, mm = standard_mask(geom, jnp.asarray(rm, jnp.float32))
    ds, ms = standard_mask(geom, jnp.asarray(rs, jnp.float32))
    M, Mmask = data_to_cartesian(geom, dm, mm)
    S, Smask = data_to_cartesian(geom, ds, ms)
    T_true = np.array(se2.invert(pm) @ ps)
    return geom, (pm, dm, mm), M, Mmask, S, Smask, T_true


class TestMultiInit:
    def test_picks_best_seed(self):
        _, _, M, Mmask, S, Smask, T_true = _clouds()
        params = IcpParams(iterations=20)
        # one good seed (near truth), two bad ones
        good = jnp.asarray(T_true, jnp.float32)
        bad1 = se2.make(2.0, -2.0, 1.2, dtype=jnp.float32)
        bad2 = se2.make(-1.5, 1.0, -1.0, dtype=jnp.float32)
        seeds = jnp.stack([bad1, good, bad2])
        res = icp_multi_init(M, Mmask, S, Smask, seeds, params)
        T = np.array(res.T)
        assert np.hypot(T[0, 2] - T_true[0, 2], T[1, 2] - T_true[1, 2]) < 0.05
        # T_last carry participates as an extra seed
        res2 = icp_multi_init(M, Mmask, S, Smask, jnp.stack([bad1, bad2]),
                              params, T_last=res.T_last)
        assert int(res2.best_seed) == 2   # the appended T_last wins
        T2 = np.array(res2.T)
        assert np.hypot(T2[0, 2] - T_true[0, 2],
                        T2[1, 2] - T_true[1, 2]) < 0.05


class TestTrace:
    def test_serialize_layout(self, tmp_path):
        tr = Trace(dim=2)
        model = np.random.rand(10, 2)
        scene = np.random.rand(8, 2)
        tr.set_model(model)
        tr.set_scene(scene)
        tr.add_assignment(scene, pairs=np.array([[0, 1], [2, 3]]),
                          score=0.5)
        tr.add_assignment(scene + 0.1, None, 0.25)
        folder = str(tmp_path / "trace")
        tr.serialize(folder)
        for f in ("model.dat", "scene.dat", "scene_000.dat", "pairs_000.dat",
                  "scene_001.dat", "score.dat", "trace.gpi"):
            assert os.path.exists(os.path.join(folder, f)), f
        scores = np.loadtxt(os.path.join(folder, "score.dat"))
        np.testing.assert_allclose(scores, [0.5, 0.25])
        pairs = np.loadtxt(os.path.join(folder, "pairs_000.dat"))
        assert pairs.shape == (4, 2)     # 2 pairs x (model pt, scene pt)
        tr.reset()
        assert tr._model is None and not tr._scenes


def _pushed_grid():
    geom, (pm, dm, mm), *_ = _clouds()
    cfg = GridConfig(map_size=7, cellsize=0.08, tile_dim=16)
    grid = create(cfg, dtype=jnp.float32)
    return push(grid, geom, pm, dm, mm)


class TestCheckpoint:
    def test_npz_roundtrip(self, tmp_path):
        g = _pushed_grid()
        p = str(tmp_path / "grid.npz")
        save_npz(g, p)
        g2 = load_npz(p)
        np.testing.assert_array_equal(np.array(g.tsd), np.array(g2.tsd))
        np.testing.assert_array_equal(np.array(g.weight), np.array(g2.weight))
        np.testing.assert_array_equal(np.array(g.tile_init),
                                      np.array(g2.tile_init))
        assert g2.cell_size == g.cell_size
        assert g2.tile_dim == g.tile_dim

    def test_text_roundtrip(self, tmp_path):
        g = _pushed_grid()
        p = str(tmp_path / "grid.txt")
        save_text(g, p)
        g2 = load_text(p)
        np.testing.assert_allclose(np.array(g.tsd), np.array(g2.tsd),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.array(g.weight), np.array(g2.weight),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.array(g.tile_init),
                                      np.array(g2.tile_init))
        assert g2.cell_size == g.cell_size

    def test_text_header_format(self, tmp_path):
        # header: cellSize, log2 tile, log2 grid, maxTruncation
        g = _pushed_grid()
        p = str(tmp_path / "grid.txt")
        save_text(g, p)
        with open(p) as f:
            lines = [f.readline().strip() for _ in range(4)]
        assert float(lines[0]) == g.cell_size
        assert int(lines[1]) == 4      # log2(16)
        assert int(lines[2]) == 7      # log2(128)
        assert float(lines[3]) == g.max_truncation

    def test_text_string_source(self):
        g = _pushed_grid()
        buf = io.StringIO()
        import tempfile
        with tempfile.NamedTemporaryFile("w+", suffix=".txt") as f:
            save_text(g, f.name)
            f.seek(0)
            content = f.read()
        g2 = load_text(content, from_string=True)   # STRING_SOURCE
        np.testing.assert_allclose(np.array(g.tsd), np.array(g2.tsd),
                                   rtol=1e-6, atol=1e-7)

    def test_text_rejects_bad_layout(self):
        try:
            load_text("0.025\n99\n10\n0.075\n", from_string=True)
            raised = False
        except ValueError:
            raised = True
        assert raised


class TestOdomRescue:
    def test_plausible_motion_passes(self):
        params = odometry.OdomRescueParams(cell_size=0.025)
        odom0 = se2.make(0.0, 0.0, 0.0, dtype=jnp.float32)
        st = odometry.init(params, odom0, 0.0)
        odom1 = se2.make(0.05, 0.0, 0.01, dtype=jnp.float32)
        st = odometry.update(st, odom1, 0.1)
        T_slam = se2.make(0.049, 0.001, 0.012, dtype=jnp.float32)
        T_out, rescued = odometry.check(st, params, T_slam)
        assert not bool(rescued)
        np.testing.assert_allclose(np.array(T_out), np.array(T_slam))

    def test_implausible_motion_rescued(self):
        params = odometry.OdomRescueParams(cell_size=0.025,
                                           trns_vel_max=1.5)
        odom0 = se2.make(0.0, 0.0, 0.0, dtype=jnp.float32)
        st = odometry.init(params, odom0, 0.0)
        odom1 = se2.make(0.05, 0.0, 0.0, dtype=jnp.float32)
        st = odometry.update(st, odom1, 0.1)
        # scan match claims a 1 m jump in 0.1 s -> 10 m/s >> 1.5 m/s
        T_slam = se2.make(1.0, 0.0, 0.0, dtype=jnp.float32)
        T_out, rescued = odometry.check(st, params, T_slam)
        assert bool(rescued)
        # replaced by the odometry delta (identity laser offset)
        np.testing.assert_allclose(np.array(T_out)[0, 2], 0.05, atol=1e-6)

    def test_invalid_odometry_disables_rescue(self):
        params = odometry.OdomRescueParams(cell_size=0.025)
        odom0 = se2.make(0.0, 0.0, 0.0, dtype=jnp.float32)
        st = odometry.init(params, odom0, 0.0)
        st = odometry.update(st, odom0, 0.1, odom_ok=False)
        T_slam = se2.make(5.0, 0.0, 0.0, dtype=jnp.float32)
        T_out, rescued = odometry.check(st, params, T_slam)
        assert not bool(rescued)

    def test_laser_offset_conjugation(self):
        # with a rotated laser mount, the odom delta must be conjugated
        # into the laser frame (OdometryAnalyzer.cpp:216-219)
        params = odometry.OdomRescueParams(
            cell_size=0.025, tf_laser=(0.2, 0.0, math.pi / 2))
        odom0 = se2.make(0.0, 0.0, 0.0, dtype=jnp.float32)
        st = odometry.init(params, odom0, 0.0)
        odom1 = se2.make(0.1, 0.0, 0.0, dtype=jnp.float32)
        st = odometry.update(st, odom1, 0.1)
        T_slam = se2.make(3.0, 0.0, 0.0, dtype=jnp.float32)  # implausible
        T_out, rescued = odometry.check(st, params, T_slam)
        assert bool(rescued)
        tl = se2.make(0.2, 0.0, math.pi / 2, dtype=jnp.float32)
        expect = np.array(se2.invert(tl) @ st.rel_odom @ tl)
        np.testing.assert_allclose(np.array(T_out), expect, atol=1e-6)


class TestProjective3D:
    def test_occlusion_filter_masks_far_point(self):
        from ohm_tsd_slam.registration.filters import occlusion_filter

        # pinhole P = [I|0] with 100x100 image, f=50, c=50
        P = jnp.array([[50.0, 0.0, 50.0, 0.0],
                       [0.0, 50.0, 50.0, 0.0],
                       [0.0, 0.0, 1.0, 0.0]])
        near = jnp.array([0.0, 0.0, 1.0])
        far = jnp.array([0.0, 0.0, 2.0])     # same pixel, behind
        side = jnp.array([0.5, 0.0, 1.0])    # different pixel
        scene = jnp.stack([far, near, side])
        mask = jnp.ones(3, bool)
        out = np.array(occlusion_filter(scene, mask, P, 100, 100))
        assert not out[0] and out[1] and out[2]

    def test_projective_pairs(self):
        from ohm_tsd_slam.registration.nn import projective_pairs_3d

        P = jnp.array([[50.0, 0.0, 50.0, 0.0],
                       [0.0, 50.0, 50.0, 0.0],
                       [0.0, 0.0, 1.0, 0.0]])
        model = jnp.array([[9.0, 9.0, 1.0],    # index 0 — unmatchable quirk
                           [0.0, 0.0, 1.0],
                           [0.5, 0.0, 1.0]])
        scene = jnp.array([[0.001, 0.0, 1.0],
                           [0.501, 0.0, 1.0]])
        mask = jnp.ones(2, bool)
        idx, d2, pm = projective_pairs_3d(model, scene, mask, P, 100, 100)
        idx, d2, pm = np.array(idx), np.array(d2), np.array(pm)
        assert pm.all()
        assert idx[0] == 1 and idx[1] == 2
        assert d2[0] < 1e-3 and d2[1] < 1e-3


def test_logger_timestamped_path():
    """Reference log-file naming (Logger.cpp:76-89):
    <base>_<d>_<m>_<Y>_<H>-<M>-<S>.log."""
    import re

    from ohm_tsd_slam.native import timestamped_log_path

    p = timestamped_log_path("/tmp/slamlog")
    assert re.fullmatch(
        r"/tmp/slamlog_\d{1,2}_\d{1,2}_\d{4}_\d{1,2}-\d{1,2}-\d{1,2}\.log",
        p), p


def test_trace_records_pair_assignments(tmp_path):
    """IcpParams.record_pairs -> Trace captures per-iteration pair
    assignments."""
    import numpy as np
    import jax.numpy as jnp

    from ohm_tsd_slam.registration import IcpParams, icp
    from ohm_tsd_slam.utils.trace import Trace

    rng = np.random.RandomState(0)
    model = rng.uniform(0, 4, (120, 2))
    scene = model + np.array([0.01, -0.015])

    params = IcpParams(iterations=8, dist_max=1.0, dist_min=0.2,
                       record_pairs=True)
    res = icp(jnp.asarray(model), jnp.ones(len(model), bool),
              jnp.asarray(scene), jnp.ones(len(scene), bool), params)
    assert res.pair_idx_history is not None
    assert res.pair_idx_history.shape == (8, 120)

    tr = Trace()
    tr.set_model(model)
    tr.set_scene(scene)
    tr.add_icp_history(scene, res)
    out = str(tmp_path / "trace")
    tr.serialize(out)
    import os

    pair_files = [f for f in os.listdir(out) if f.startswith("pairs_")]
    assert pair_files
    first = np.loadtxt(os.path.join(out, sorted(pair_files)[0]),
                       ndmin=2)
    assert first.shape[1] == 2 and first.shape[0] > 50


def test_ransac_trace_layout_matches_reference():
    """utils/trace.py's RANSAC layout vs the compiled reference's Trace
    serialization (golden/data/ransac/exp, Trace.cpp:144-390): same
    file-name set for the traced candidates, same score3D.dat rows."""
    import math
    import os

    import jax
    import numpy as np

    from tests.golden_io import (
        RANSAC_DIR,
        load_score3d,
        replay_picks,
        replay_subsample,
    )

    if not os.path.exists(os.path.join(RANSAC_DIR, "tbest.bin")):
        import pytest

        pytest.skip("golden ransac data missing")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ohm_tsd_slam.registration.ransac import (
        RansacInject,
        RansacParams,
        match_normal,
        pca_normals,
    )
    from ohm_tsd_slam.utils.trace import Trace, record_ransac_trace

    z = np.load(os.path.join(RANSAC_DIR, "inputs.npz"))
    M = jnp.asarray(z["M"])
    S = jnp.asarray(z["S"])
    maskM = jnp.asarray(z["maskM"])
    maskS = jnp.asarray(z["maskS"])
    N = M.shape[0]
    params = RansacParams(
        trials=int(z["trials"]), eps_thresh=float(z["eps_thresh"]),
        size_control_set=int(z["size_control"]),
        phi_max=float(z["phi_max"]), resolution=float(z["resolution"]))
    r = params.pca_search_range // 2
    _, mask_mp = pca_normals(M, maskM, r)
    sub, dr = replay_subsample(int(z["seed"]), np.asarray(maskS))
    _, mask_sp_full = pca_normals(S, maskS, r)
    mask_sp = np.asarray(mask_sp_full) & sub
    idx_s = [i for i in range(r, N - r) if mask_sp[i]]
    idx_m = [i for i in range(r, N - r) if np.asarray(mask_mp)[i]]
    ctrl, tidx = replay_picks(dr, idx_s, idx_m, params.trials,
                              params.size_control_set)
    C, T = params.size_control_set, params.trials
    inject = RansacInject(
        sub_mask=jnp.asarray(sub),
        ctrl_idx=jnp.asarray(np.pad(ctrl, (0, C - len(ctrl)))).astype(jnp.int32),
        ctrl_valid=jnp.asarray(np.arange(C) < len(ctrl)),
        trial_idx=jnp.asarray(np.pad(tidx, (0, T - len(tidx)))).astype(jnp.int32),
        trial_valid=jnp.asarray(np.arange(T) < len(tidx)))

    _, aux = match_normal(jax.random.PRNGKey(0), M, maskM, S, maskS,
                          params, inject=inject, return_scores=True)
    keep = (np.asarray(aux["prep"].cand_valid)
            & (np.asarray(aux["cnt"]) > int(aux["cnt_thresh"])))
    tr = Trace()
    record_ransac_trace(tr, M, maskM, S, maskS, aux, params, keep,
                        np.asarray(aux["err_sum"]))
    out = os.path.join("/tmp", "jax_ransac_trace")
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    tr.serialize(out)

    ref_dir = os.path.join(RANSAC_DIR, "exp")
    ref_files = {f for f in os.listdir(ref_dir)
                 if f.startswith(("scene_", "pairs_", "score_"))}
    got_files = {f for f in os.listdir(out)
                 if f.startswith(("scene_", "pairs_", "score_"))}
    assert got_files == ref_files
    for base in ("model.dat", "scene.dat", "score3D.dat",
                 "score3D.gpi", "trace.gpi"):
        assert os.path.exists(os.path.join(out, base)), base

    ref_rows = load_score3d(os.path.join(ref_dir, "score3D.dat"))
    got_rows = load_score3d(os.path.join(out, "score3D.dat"))
    ref_sorted = ref_rows[np.lexsort(ref_rows[:, 2::-1].T)]
    got_sorted = got_rows[np.lexsort(got_rows[:, 2::-1].T)]
    np.testing.assert_array_equal(ref_sorted[:, :3], got_sorted[:, :3])
    np.testing.assert_allclose(got_sorted[:, 3], ref_sorted[:, 3],
                               rtol=1e-6, atol=1e-9)
