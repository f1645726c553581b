"""RANSAC-matcher golden parity vs the compiled, unmodified reference
(golden/ransac_harness: RandomNormalMatching / PDFMatching /
TSD_PDFMatching from /root/reference/src with a deterministic rand shim
and an exact-1-NN flann stand-in).

The reference's rand() stream is replayed in Python (golden_io.DetRand)
to recover the identical subsample mask, control set and trial draws;
those are injected into the JAX matchers (RansacInject) which then
score the SAME candidate set.  Asserted:

  * the candidate SET (every (trial, scene-index) pair the reference's
    Trace recorded) equals the JAX cand_valid set — this also pins the
    PCA validity masks bit-for-bit, since candidates are gated on them;
  * EXP: per-candidate errSum at 1e-8 relative
    (RandomNormalMatching.cpp:298-327);
  * PDF/TSD: the best-so-far improvement positions and their
    probabilities (log-domain; PDFMatching.cpp:435-487,
    TSD_PDFMatching.cpp:233-251) — the trace records candidates only on
    improvement;
  * the winning transform of each matcher vs tbest.bin, replicating the
    reference's streaming acceptance rule over the JAX score grids
    (the EXP rule is not a total order, so the lexicographic winner the
    production matcher returns is asserted separately only against the
    replicated streaming result).

Regenerate goldens with `make -C golden ransac`.
"""

import math
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from tests.golden_io import (
    RANSAC_DIR,
    load_score3d,
    replay_picks,
    replay_subsample,
)

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(RANSAC_DIR, "tbest.bin")),
    reason="golden ransac data missing (make -C golden ransac)")


@pytest.fixture(scope="module")
def setup():
    from ohm_tsd_slam.config import BeamModelConfig, GridConfig
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.registration.ransac import (
        RansacInject,
        RansacParams,
        pca_normals,
    )

    z = np.load(os.path.join(RANSAC_DIR, "inputs.npz"))
    M = jnp.asarray(z["M"])
    S = jnp.asarray(z["S"])
    maskM = jnp.asarray(z["maskM"])
    maskS = jnp.asarray(z["maskS"])
    N = M.shape[0]
    params = RansacParams(
        trials=int(z["trials"]), eps_thresh=float(z["eps_thresh"]),
        size_control_set=int(z["size_control"]),
        phi_max=float(z["phi_max"]), resolution=float(z["resolution"]),
        zrand_tsd=float(z["zrand_tsd"]))
    r = params.pca_search_range // 2

    _, mask_mp = pca_normals(M, maskM, r)
    sub, dr = replay_subsample(int(z["seed"]), np.asarray(maskS))
    _, mask_sp_full = pca_normals(S, maskS, r)
    mask_sp = np.asarray(mask_sp_full) & sub
    mask_mp_np = np.asarray(mask_mp)

    idx_s_valid = [i for i in range(r, N - r) if mask_sp[i]]
    idx_m_valid = [i for i in range(r, N - r) if mask_mp_np[i]]
    ctrl, tidx = replay_picks(dr, idx_s_valid, idx_m_valid,
                              params.trials, params.size_control_set)

    C = params.size_control_set
    T = params.trials
    ctrl_idx = np.zeros(C, np.int32)
    ctrl_idx[:len(ctrl)] = ctrl
    ctrl_valid = np.arange(C) < len(ctrl)
    trial_idx = np.zeros(T, np.int32)
    trial_idx[:len(tidx)] = tidx
    trial_valid = np.arange(T) < len(tidx)
    inject = RansacInject(
        sub_mask=jnp.asarray(sub),
        ctrl_idx=jnp.asarray(ctrl_idx),
        ctrl_valid=jnp.asarray(ctrl_valid),
        trial_idx=jnp.asarray(trial_idx),
        trial_valid=jnp.asarray(trial_valid))

    tbest = np.fromfile(os.path.join(RANSAC_DIR, "tbest.bin")
                        ).reshape(3, 3, 3)
    return dict(z=z, M=M, S=S, maskM=maskM, maskS=maskS, params=params,
                inject=inject, tidx=tidx, tbest=tbest, ctrl=ctrl)


def _cand_index(params, trial, idxm, i):
    span = params.span
    off = i - idxm + span
    assert 0 <= off < 2 * span, (trial, idxm, i)
    return trial * 2 * span + off


def _visit_order(params, tidx, K):
    """C++ candidate visit order: trials ascending, i ascending
    (iMin..iMax); returns the flat JAX candidate indices in that order."""
    span = params.span
    order = []
    for t in range(len(tidx)):
        for off in range(2 * span):
            order.append(t * 2 * span + off)
    return order


def test_exp_candidate_scores_match(setup):
    from ohm_tsd_slam.registration.ransac import match_normal

    s = setup
    T, aux = match_normal(jax.random.PRNGKey(0), s["M"], s["maskM"],
                          s["S"], s["maskS"], s["params"],
                          inject=s["inject"], return_scores=True)
    rows = load_score3d(os.path.join(RANSAC_DIR, "exp", "score3D.dat"))
    assert len(rows) > 50
    err_sum = np.asarray(aux["err_sum"])
    cnt = np.asarray(aux["cnt"])
    thresh = int(aux["cnt_thresh"])
    cand_valid = np.asarray(aux["prep"].cand_valid)

    # the reference traced exactly the candidates passing its gates
    # (|phi| < phiMax, maskSpca, AND cntMatch > cntMatchThresh — the
    # trace hook sits after that continue, RandomNormalMatching.cpp:
    # 338-379); the sets must agree, which pins the PCA masks, the phi
    # gate and the per-candidate match counts simultaneously
    ref_set = set()
    for trial, idxm, i, score in rows:
        trial = int(trial)
        assert s["tidx"][trial] == int(idxm)       # trial draw replay
        k = _cand_index(s["params"], trial, int(idxm), int(i))
        ref_set.add(k)
        np.testing.assert_allclose(err_sum[k], score, rtol=1e-8,
                                   atol=1e-9)
    got = {int(k) for k in np.nonzero(cand_valid & (cnt > thresh))[0]
           if k // (2 * s["params"].span) < len(s["tidx"])}
    assert got == ref_set


def test_exp_winner_matches(setup):
    """Replicate the reference's streaming acceptance
    (RandomNormalMatching.cpp:344-360: rateCondition/similarityCondition
    over the visit order) on the JAX score grids and compare the final
    transform with the compiled reference's TBest."""
    from ohm_tsd_slam.registration.ransac import match_normal

    s = setup
    _, aux = match_normal(jax.random.PRNGKey(0), s["M"], s["maskM"],
                          s["S"], s["maskS"], s["params"],
                          inject=s["inject"], return_scores=True)
    ratio = np.asarray(aux["ratio"])
    cnt = np.asarray(aux["cnt"])
    err_sum = np.asarray(aux["err_sum"])
    max_cnt = np.asarray(aux["max_cnt"])
    valid = np.asarray(aux["prep"].cand_valid)
    phi = np.asarray(aux["prep"].phi_cand)
    t = np.asarray(aux["prep"].t_cand)
    thresh = int(aux["cnt_thresh"])

    best = (0.0, 0, 1e12, None)
    for k in _visit_order(s["params"], s["tidx"], len(ratio)):
        if not valid[k] or cnt[k] <= thresh or max_cnt[k] <= 0:
            continue
        rat = cnt[k] / max_cnt[k]
        b_ratio, b_cnt, b_err, b_k = best
        rate = ((rat - b_ratio) > 1e-5) and (cnt[k] > b_cnt)
        # replicated quirk (RandomNormalMatching.cpp:349):
        # fabs((ratio-best) < eps) is fabs(bool) — the condition is the
        # SIGNED comparison, not an absolute-difference band
        similar = ((rat - b_ratio) < 1e-5) and (cnt[k] == b_cnt) \
            and err_sum[k] < b_err
        if rate or similar:
            best = (rat, cnt[k], err_sum[k], k)

    assert best[3] is not None
    k = best[3]
    c, sn = math.cos(phi[k]), math.sin(phi[k])
    T_stream = np.array([[c, -sn, t[k, 0]], [sn, c, t[k, 1]],
                         [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(T_stream, s["tbest"][0], atol=1e-9)


def _check_improvements(setup, matcher_rows, logp_raw, gated, scale,
                        tol):
    """Emulate the streaming prob>best walk and compare improvement
    positions + values with the trace rows."""
    s = setup
    valid = gated > -1e8    # gate sentinel is -_BIG = -1e9
    best = -np.inf
    improvements = []
    for k in _visit_order(s["params"], s["tidx"], len(logp_raw)):
        if not valid[k]:
            continue
        # the reference's bestProb starts at 0.0, so a candidate whose
        # double-precision probability underflowed to 0 can never win
        if logp_raw[k] <= -708.0:
            continue
        if logp_raw[k] > best:
            best = logp_raw[k]
            improvements.append(k)
    ref = []
    for trial, idxm, i, score in matcher_rows:
        k = _cand_index(s["params"], int(trial), int(idxm), int(i))
        ref.append((k, score))
    assert [k for k, _ in ref] == improvements, (ref, improvements)
    for k, score in ref:
        # compare in the PROB domain against the trace's fixed(9)
        # print: absolute half-ulp 5e-10 plus a relative term
        got = math.exp(logp_raw[k]) * scale
        assert abs(got - score) <= 5e-10 + tol * abs(score), \
            (k, got, score)
    return improvements


def test_pdf_improvements_match(setup):
    from ohm_tsd_slam.config import BeamModelConfig
    from ohm_tsd_slam.registration.ransac import match_pdf

    s = setup
    z = s["z"]
    bm = BeamModelConfig(
        zhit=float(z["beam_zhit"]), zphi=float(z["beam_zphi"]),
        zshort=float(z["beam_zshort"]), zmax=float(z["beam_zmax"]),
        zrand=float(z["beam_zrand"]),
        percentage_points_in_c=float(z["beam_percentage_points_in_c"]),
        max_range=float(z["beam_rangemax"]),
        sig_phi=float(z["beam_sigphi"]), sig_hit=float(z["beam_sighit"]),
        lam_short=float(z["beam_lamshort"]),
        max_angle_diff_deg=float(z["beam_max_angle_diff"]))
    T, aux = match_pdf(jax.random.PRNGKey(0), s["M"], s["maskM"],
                       s["S"], s["maskS"], s["params"], bm,
                       inject=s["inject"], return_scores=True)
    rows = load_score3d(os.path.join(RANSAC_DIR, "pdf", "score3D.dat"))
    imp = _check_improvements(setup=s, matcher_rows=rows,
                              logp_raw=np.asarray(aux["logp_raw"]),
                              gated=np.asarray(aux["logp"]),
                              scale=10e100, tol=1e-6)
    # the final improvement is the winner; PDF's acceptance is a pure
    # prob max, so the production (lexicographic) transform agrees
    np.testing.assert_allclose(np.asarray(T), s["tbest"][1], atol=1e-9)


def test_tsd_improvements_match(setup):
    from ohm_tsd_slam.config import GridConfig
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.registration.ransac import match_tsd

    s = setup
    z = s["z"]
    # the harness PUSHES the model scan through the reference TsdGrid
    # (matching the live loop; a text-reloaded grid has unpropagated
    # partition halos) — push the identical scan here
    from ohm_tsd_slam.sensor.polar2d import SensorPolar2D

    geom = SensorPolar2D(size=int(z["M"].shape[0]),
                         angular_res=float(z["resolution"]),
                         phi_min=math.radians(-135.0), max_range=9.0,
                         min_range=0.01, low_reflectivity_range=1.0)
    grid = create(GridConfig(map_size=int(z["map_size"]),
                             cellsize=float(z["cellsize"])),
                  dtype=jnp.float64)
    grid = push(grid, geom, jnp.asarray(z["pose_m"]),
                jnp.asarray(z["data_m"]), jnp.asarray(z["mask_m"]))
    pose_m = jnp.asarray(s["z"]["pose_m"])
    T, aux = match_tsd(jax.random.PRNGKey(0), grid, pose_m, s["M"],
                       s["maskM"], s["S"], s["maskS"], s["params"],
                       inject=s["inject"], return_scores=True)
    rows = load_score3d(os.path.join(RANSAC_DIR, "tsd", "score3D.dat"))
    _check_improvements(setup=s, matcher_rows=rows,
                        logp_raw=np.asarray(aux["logp_raw"]),
                        gated=np.asarray(aux["logp"]),
                        scale=10.0, tol=1e-5)
    np.testing.assert_allclose(np.asarray(T), s["tbest"][2], atol=1e-9)


def test_twinpoint_candidates_scores_and_winner(setup):
    """TwinPointMatching golden parity: the
    candidate set (every (trial, window-beam) the reference's Trace
    recorded after the eps/phi/trans gates + cnt>0,
    TwinPointMatching.cpp:216-372), the per-candidate consensus error,
    and the winner under the reference's streaming acceptance rule
    (:349-361, OMP_NUM_THREADS=1 visit order)."""
    from ohm_tsd_slam.registration.ransac import RansacParams
    from ohm_tsd_slam.registration.twinpoint import (
        TwinInject,
        match_twinpoint,
    )

    from golden_io import replay_twin

    s = setup
    z = s["z"]
    N = s["M"].shape[0]
    res = float(z["resolution"])
    params = RansacParams(
        trials=int(z["trials"]), eps_thresh=float(z["eps_thresh"]),
        size_control_set=int(z["size_control"]),
        phi_max=float(z["phi_max"]), resolution=res,
        trans_max=1.5)
    res_deg = math.degrees(res)
    min_d = max(1, int(3.0 / res_deg))
    max_d = max(2, int(10.0 / res_deg))

    maskM = np.asarray(s["maskM"])
    maskS = np.asarray(s["maskS"])
    idx_s_valid = [i for i in range(N) if maskS[i]]
    n_m_valid = int(maskM.sum())
    ctrl, r1s, r2s = replay_twin(int(z["seed"]), idx_s_valid, n_m_valid,
                                 params.trials, params.size_control_set,
                                 min_d, max_d)
    C = params.size_control_set
    ctrl_idx = np.zeros(C, np.int32)
    ctrl_idx[:len(ctrl)] = ctrl
    inject = TwinInject(
        ctrl_idx=jnp.asarray(ctrl_idx),
        ctrl_valid=jnp.asarray(np.arange(C) < len(ctrl)),
        rank1=jnp.asarray(np.asarray(r1s, np.int32)),
        rank2=jnp.asarray(np.asarray(r2s, np.int32)),
        trial_valid=jnp.asarray(np.ones(params.trials, bool)))

    import jax as _jax

    T, aux = match_twinpoint(_jax.random.PRNGKey(0), s["M"], s["maskM"],
                             s["S"], s["maskS"], params, inject=inject,
                             return_scores=True)

    span = aux["span"]
    idx1 = np.asarray(aux["idx1"])
    good = ((np.asarray(aux["pair_ok"]).reshape(-1))
            & (np.asarray(aux["cnt"]) > 0))
    err = np.asarray(aux["err"])
    cnt = np.asarray(aux["cnt"])
    max_cnt = np.asarray(aux["max_cnt"])

    rows = load_score3d(os.path.join(RANSAC_DIR, "twin", "score3D.dat"))
    assert len(rows) > 50, len(rows)

    ref_set = set()
    for trial, im, isc, score in rows:
        trial, im, isc = int(trial), int(im), int(isc)
        assert im == idx1[trial], (trial, im, idx1[trial])
        off = isc - im + span
        assert 0 <= off < 2 * span
        flat = trial * 2 * span + off
        ref_set.add(flat)
        np.testing.assert_allclose(err[flat], score, rtol=1e-6,
                                   atol=1e-8, err_msg=str((trial, isc)))
    got_set = set(np.nonzero(good)[0].tolist())
    assert got_set == ref_set, (sorted(got_set - ref_set)[:5],
                                sorted(ref_set - got_set)[:5])

    # streaming winner (the reference's acceptance is not a total
    # order; replicate it in C++ visit order: trials asc, i asc)
    cnt_best, err_best, rate_best = 0, 1e12, 0.0
    best_flat = None
    for flat in sorted(got_set):
        c = cnt[flat]
        r = c / max(max_cnt[flat], 1)
        e = err[flat]
        rate_cond = (r - rate_best) > 1e-5 and c > cnt_best
        err_cond = abs(r - rate_best) < 1e-5 and c == cnt_best \
            and e < err_best
        if rate_cond or err_cond:
            cnt_best, err_best, rate_best = c, e, r
            best_flat = flat
    tref = np.fromfile(os.path.join(RANSAC_DIR, "tbest_twin.bin")
                       ).reshape(3, 3)
    phi_b = float(np.asarray(aux["phi"])[best_flat])
    t_b = np.asarray(aux["t"])[best_flat]
    got_T = np.array([[np.cos(phi_b), -np.sin(phi_b), t_b[0]],
                      [np.sin(phi_b), np.cos(phi_b), t_b[1]],
                      [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(got_T, tref, atol=1e-9)
